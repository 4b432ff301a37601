"""The port of the JAX package's ``datasets/sentiment.py`` (a copy: the port imports
nothing of the JAX package). NLTK movie-reviews sentiment dataset.

Parity: the reference's v2/dataset/sentiment.py (word-id
sequences + binary polarity from nltk movie_reviews).

Real data: ``movie_reviews.tar.gz`` under DATA_HOME/sentiment holding
``movie_reviews/{pos,neg}/*.txt`` (the nltk corpus layout the reference
downloaded through nltk); labels follow the reference's sorted-category
order (neg=0, pos=1). Synthetic surrogate otherwise, mirroring
paddle_tpu_torch.datasets.imdb at the smaller movie-reviews vocab scale.
"""
from __future__ import annotations

import collections
import os
import re as _re

import numpy as np

from paddle_tpu_torch.datasets import common

VOCAB_SIZE = 2048


def _archive():
    return common.dataset_path("sentiment", "movie_reviews.tar.gz")


_DICT_CACHE = {}


def get_word_dict():
    """(ref sentiment.py get_word_dict: frequency-sorted corpus words).
    Cached per (archive path, mtime) — train()+test() each default to it,
    and building it is a full decompress-and-tokenize corpus scan."""
    path = _archive()
    if not os.path.exists(path):
        return {f"w{i}": i for i in range(VOCAB_SIZE)}
    key = (os.path.realpath(path), os.path.getmtime(path))
    if key in _DICT_CACHE:
        return _DICT_CACHE[key]
    import tarfile
    freq = collections.Counter()
    with tarfile.open(path, "r:gz") as tar:
        for m in tar.getmembers():
            if m.name.endswith(".txt"):
                freq.update(_re.findall(
                    r"[a-z]+", tar.extractfile(m).read().decode().lower()))
    kept = sorted(freq.items(), key=lambda wc: (-wc[1], wc[0]))
    idx = {w: i for i, (w, _) in enumerate(kept)}
    _DICT_CACHE.clear()   # one archive's dict kept resident
    _DICT_CACHE[key] = idx
    return idx


def _real(is_train, word_idx):
    """Deterministically shuffled 80/20 corpus split, the reference's
    proportions (ref sentiment.py NUM_TRAINING_INSTANCES = 1600 of 2000
    shuffled docs; here the shuffle is seeded instead of global-random
    so the split is reproducible); neg=0, pos=1 by sorted category
    order."""
    import random
    import tarfile

    def reader():
        with tarfile.open(_archive(), "r:gz") as tar:
            docs = []
            for label, sub in ((0, "neg"), (1, "pos")):
                docs.extend(
                    (m, label) for m in sorted(
                        (m for m in tar.getmembers()
                         if f"/{sub}/" in m.name
                         and m.name.endswith(".txt")),
                        key=lambda m: m.name))
            random.Random(0).shuffle(docs)
            cut = int(len(docs) * 0.8)
            picked = docs[:cut] if is_train else docs[cut:]
            for m, label in picked:
                toks = _re.findall(
                    r"[a-z]+",
                    tar.extractfile(m).read().decode().lower())
                yield [word_idx[w] for w in toks if w in word_idx], label

    return reader


def _synthetic(n, seed, min_len=10, max_len=60):
    rng = np.random.RandomState(seed)

    def reader():
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(min_len, max_len + 1))
            pool = (np.arange(0, VOCAB_SIZE // 2) if label
                    else np.arange(VOCAB_SIZE // 2, VOCAB_SIZE))
            words = np.concatenate([
                rng.choice(pool, length // 2),
                rng.randint(0, VOCAB_SIZE, length - length // 2)])
            rng.shuffle(words)
            yield words.astype(np.int64).tolist(), label

    return reader


def train(n: int = 800):
    if os.path.exists(_archive()):
        return _real(True, get_word_dict())
    return _synthetic(n, seed=11)


def test(n: int = 200):
    if os.path.exists(_archive()):
        return _real(False, get_word_dict())
    return _synthetic(n, seed=12)
