"""The port of the JAX package's ``datasets/imikolov.py`` (a copy: the port imports
nothing of the JAX package). PTB-style language-model n-gram dataset
(parity: the reference's v2/dataset/imikolov.py — used by
the word2vec book test).

Samples: n-gram word-id tuples. Real data: PTB token files
``ptb.train.txt`` / ``ptb.valid.txt`` under DATA_HOME/imikolov (the
files the reference extracted from simple-examples.tgz), with the
reference's <s>/<e>/<unk> sentence framing and frequency-cut dict.
Synthetic surrogate otherwise: Markov-ish chains with a learnable
transition structure.
"""
from __future__ import annotations

import collections
import os

import numpy as np

from paddle_tpu_torch.datasets import common

VOCAB_SIZE = 2073  # mirrors the scale of the reference's PTB dict


def _train_path():
    return common.dataset_path("imikolov", "ptb.train.txt")


def build_dict(min_word_freq: int = 50):
    """(ref imikolov.py build_dict: frequency-sorted words above the
    cut, '<s>' end-marked sentences, trailing '<unk>')."""
    path = _train_path()
    if not os.path.exists(path):
        return {f"w{i}": i for i in range(VOCAB_SIZE)}
    freq = collections.Counter()
    with open(path) as f:
        for line in f:
            freq.update(line.split())
    freq.pop("<unk>", None)
    kept = sorted(((w, c) for w, c in freq.items() if c >= min_word_freq),
                  key=lambda wc: (-wc[1], wc[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def _real(path, word_idx, n):
    """(ref imikolov.py reader_creator: '<s>' + words + '<e>', sliding
    n-grams of word ids, unknown words to <unk>)."""
    unk = word_idx["<unk>"]

    def reader():
        with open(path) as f:
            for line in f:
                toks = ["<s>"] + line.split() + ["<e>"]
                if len(toks) < n:
                    continue
                ids = [word_idx.get(w, unk) for w in toks]
                for i in range(n, len(ids) + 1):
                    yield tuple(np.int64(w) for w in ids[i - n:i])

    return reader


def _synthetic(n, seed, ngram=5):
    rng = np.random.RandomState(seed)
    # deterministic transition: next ≈ (3*prev + noise) mod V
    def reader():
        for _ in range(n):
            w0 = int(rng.randint(0, VOCAB_SIZE))
            seq = [w0]
            for _ in range(ngram - 1):
                nxt = (3 * seq[-1] + int(rng.randint(0, 7))) % VOCAB_SIZE
                seq.append(nxt)
            yield tuple(np.int64(w) for w in seq)

    return reader


def train(word_idx=None, n: int = 5, n_synthetic: int = 4096):
    path = _train_path()
    if os.path.exists(path):
        return _real(path, word_idx or build_dict(), n)
    return _synthetic(n_synthetic, seed=41, ngram=n)


def test(word_idx=None, n: int = 5, n_synthetic: int = 512):
    path = common.dataset_path("imikolov", "ptb.valid.txt")
    # the dict comes from the TRAIN file — both must be present for the
    # real branch (a valid-only DATA_HOME must not crash build_dict)
    if os.path.exists(path) and os.path.exists(_train_path()):
        return _real(path, word_idx or build_dict(), n)
    return _synthetic(n_synthetic, seed=42, ngram=n)
