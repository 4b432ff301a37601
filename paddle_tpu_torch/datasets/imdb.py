"""The port of the JAX package's ``datasets/imdb.py`` (a copy: the port imports
nothing of the JAX package). IMDB sentiment dataset
(parity: the reference's v2/dataset/imdb.py — word-id
sequences + binary label; used by the LSTM benchmark
the reference's benchmark/paddle/rnn/rnn.py).

Real data: the standard ``aclImdb_v1.tar.gz`` under DATA_HOME/imdb —
the reference tokenised train/{pos,neg} texts, built a frequency-sorted
dict, and yielded (word_ids, 0=positive/1=negative); parsed the same
way here. Synthetic surrogate otherwise: two word-distribution classes
over a vocab, with class-indicative tokens, variable lengths.
"""
from __future__ import annotations

import collections
import os
import re as _re

import numpy as np

from paddle_tpu_torch.datasets import common

VOCAB_SIZE = 5147  # mirror of the benchmark's IMDB vocab scale (imdb.py dict)


def _archive():
    return common.dataset_path("imdb", "aclImdb_v1.tar.gz")


def _tokenize(text):
    # the reference's tok pattern: lowercase word chunks, punct dropped
    return _re.findall(r"[a-z]+", text.lower())


def _iter_docs(tar, pattern):
    members = sorted((m for m in tar.getmembers()
                      if pattern.match(m.name)), key=lambda m: m.name)
    for m in members:
        yield _tokenize(tar.extractfile(m).read().decode("utf-8"))


_DICT_CACHE = {}


def word_dict(cutoff: int = 150):
    """(ref imdb.py word_dict: frequency cut 150 over the train AND
    test splits, frequency-sorted, trailing <unk> —
    the reference's v2/dataset/imdb.py:164).

    Cached per (archive path, mtime, cutoff): train()+test() each default
    to word_dict(), and rebuilding means a full decompress-and-tokenize
    pass over aclImdb — one scan per archive is enough."""
    path = _archive()
    if not os.path.exists(path):
        return {f"w{i}": i for i in range(VOCAB_SIZE)}
    key = (os.path.realpath(path), os.path.getmtime(path), cutoff)
    if key in _DICT_CACHE:
        return _DICT_CACHE[key]
    import tarfile
    freq = collections.Counter()
    with tarfile.open(path, "r:gz") as tar:
        for toks in _iter_docs(
                tar,
                _re.compile(r"aclImdb/(train|test)/(pos|neg)/.*\.txt$")):
            freq.update(toks)
    kept = sorted(((w, c) for w, c in freq.items() if c >= cutoff),
                  key=lambda wc: (-wc[1], wc[0]))
    idx = {w: i for i, (w, _) in enumerate(kept)}
    idx["<unk>"] = len(idx)
    # evict other archives' dicts only: same-archive entries at other
    # cutoffs stay (train()+test() default to cutoff 150 while tests use
    # cutoff 1 — alternating must not rescan the tar each call)
    for k in [k for k in _DICT_CACHE if k[:2] != key[:2]]:
        del _DICT_CACHE[k]
    _DICT_CACHE[key] = idx
    return idx


def _real(split, word_idx):
    """(ref imdb.py reader_creator: pos label 0, neg label 1)."""
    import tarfile
    unk = word_idx["<unk>"]

    def reader():
        with tarfile.open(_archive(), "r:gz") as tar:
            for label, sub in ((0, "pos"), (1, "neg")):
                pat = _re.compile(
                    rf"aclImdb/{split}/{sub}/.*\.txt$")
                for toks in _iter_docs(tar, pat):
                    yield [word_idx.get(w, unk) for w in toks], label

    return reader


def _synthetic(n, seed, min_len=20, max_len=100):
    rng = np.random.RandomState(seed)
    pos_words = np.arange(0, VOCAB_SIZE // 2)
    neg_words = np.arange(VOCAB_SIZE // 2, VOCAB_SIZE)

    def reader():
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(min_len, max_len + 1))
            bias_pool = pos_words if label else neg_words
            n_bias = length // 2
            words = np.concatenate([
                rng.choice(bias_pool, n_bias),
                rng.randint(0, VOCAB_SIZE, length - n_bias),
            ])
            rng.shuffle(words)
            yield words.astype(np.int64).tolist(), label

    return reader


def train(word_idx=None, n_synthetic: int = 2048):
    if os.path.exists(_archive()):
        return _real("train", word_idx or word_dict())
    return _synthetic(n_synthetic, seed=31)


def test(word_idx=None, n_synthetic: int = 256):
    if os.path.exists(_archive()):
        return _real("test", word_idx or word_dict())
    return _synthetic(n_synthetic, seed=32)
