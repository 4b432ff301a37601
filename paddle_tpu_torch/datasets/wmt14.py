"""The port of the JAX package's ``datasets/wmt14.py`` (a copy: the port imports
nothing of the JAX package). WMT14 fr→en translation dataset
(parity: the reference's v2/dataset/wmt14.py — source/target
word-id sequences with <s>/<e>/<unk>; used by seq2seq NMT).

Real data: tokenised parallel text ``{train,test}.src`` /
``{train,test}.tgt`` plus ``src.dict`` / ``tgt.dict`` (one token per
line, ids = line numbers after the reserved <s>/<e>/<unk>) under
DATA_HOME/wmt14 — the flattened form of the token files inside the
reference's wmt14 tar. Synthetic surrogate otherwise: target =
deterministic token-wise transform of source (+ length change), so an
attention seq2seq can genuinely learn the mapping and generation tests
have a meaningful signal.
"""
from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.datasets import common

DICT_SIZE = 30000
START_ID = 0   # <s>
END_ID = 1     # <e>
UNK_ID = 2     # <unk>
_RESERVED = 3


def _synthetic(n, seed, dict_size, min_len=3, max_len=12):
    rng = np.random.RandomState(seed)
    usable = dict_size - _RESERVED

    def transform(tok):
        return _RESERVED + ((tok - _RESERVED) * 7 + 13) % usable

    def reader():
        for _ in range(n):
            length = int(rng.randint(min_len, max_len + 1))
            src = (_RESERVED + rng.randint(0, usable, length)).astype(np.int64)
            tgt = np.array([transform(t) for t in src], np.int64)
            # (src_ids, trg_ids_with_<s>, trg_next_ids_with_<e>)
            trg_in = np.concatenate([[START_ID], tgt])
            trg_out = np.concatenate([tgt, [END_ID]])
            yield src.tolist(), trg_in.tolist(), trg_out.tolist()

    return reader


def _load_dict(path, dict_size):
    """(ref wmt14.py __read_to_dict__: top dict_size tokens, reserved
    <s>/<e>/<unk> in front)."""
    idx = {"<s>": START_ID, "<e>": END_ID, "<unk>": UNK_ID}
    with open(path) as f:
        for line in f:
            tok = line.strip()
            if not tok or tok in idx:
                continue
            if len(idx) >= dict_size:
                break
            idx[tok] = len(idx)
    return idx


def _real(split, dict_size):
    src_dict = _load_dict(common.dataset_path("wmt14", "src.dict"),
                          dict_size)
    tgt_dict = _load_dict(common.dataset_path("wmt14", "tgt.dict"),
                          dict_size)

    def to_ids(line, d):
        return [d.get(w, UNK_ID) for w in line.split()]

    def reader():
        with open(common.dataset_path("wmt14", f"{split}.src")) as sf, \
                open(common.dataset_path("wmt14", f"{split}.tgt")) as tf:
            for sline, tline in zip(sf, tf):
                src = to_ids(sline, src_dict)
                tgt = to_ids(tline, tgt_dict)
                if not src or not tgt:
                    continue
                yield src, [START_ID] + tgt, tgt + [END_ID]

    return reader


def _has_real():
    return all(os.path.exists(common.dataset_path("wmt14", f)) for f in
               ("train.src", "train.tgt", "test.src", "test.tgt",
                "src.dict", "tgt.dict"))


def train(dict_size: int = DICT_SIZE, n_synthetic: int = 4096):
    if _has_real():
        return _real("train", dict_size)
    return _synthetic(n_synthetic, seed=61, dict_size=dict_size)


def test(dict_size: int = DICT_SIZE, n_synthetic: int = 512):
    if _has_real():
        return _real("test", dict_size)
    return _synthetic(n_synthetic, seed=62, dict_size=dict_size)
