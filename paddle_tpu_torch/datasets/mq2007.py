"""The port of the JAX package's ``datasets/mq2007.py`` (a copy: the port imports
nothing of the JAX package). MQ2007 learning-to-rank dataset.

Parity: the reference's v2/dataset/mq2007.py — LETOR
query-grouped feature vectors with relevance labels, consumable
pointwise, pairwise, or listwise (the rank_loss / margin_rank_loss /
lambda_rank workloads).

Real data: LETOR-format ``train.txt`` / ``test.txt`` under
DATA_HOME/mq2007 ("rel qid:N 1:v ... 46:v #docid"), grouped by query
like the reference's QueryList parsing. Synthetic surrogate otherwise:
46-dim feature vectors whose projection onto a hidden weight vector
determines graded relevance.
"""
from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.datasets import common

FEATURE_DIM = 46


def _parse_letor(path):
    """Yield (qid, feats [n,46], labels [n]) query groups (ref
    mq2007.py Query.init_from_data / QueryList)."""
    cur_qid, feats, labels = None, [], []
    with open(path) as f:
        for line in f:
            body = line.split("#")[0].strip()
            if not body:
                continue
            parts = body.split()
            rel = int(parts[0])
            qid = parts[1].split(":")[1]
            vec = np.zeros(FEATURE_DIM, np.float32)
            for kv in parts[2:]:
                k, v = kv.split(":")
                vec[int(k) - 1] = float(v)
            if qid != cur_qid and cur_qid is not None:
                yield cur_qid, np.stack(feats), np.asarray(labels, np.int64)
                feats, labels = [], []
            cur_qid = qid
            feats.append(vec)
            labels.append(rel)
    if feats:
        yield cur_qid, np.stack(feats), np.asarray(labels, np.int64)


def _real(path, fmt):
    def pointwise():
        for _, feats, labels in _parse_letor(path):
            for f, l in zip(feats, labels):
                yield f, int(l)

    def pairwise():
        for _, feats, labels in _parse_letor(path):
            for i in range(len(feats)):
                for j in range(len(feats)):
                    if labels[i] > labels[j]:
                        yield feats[i], feats[j]

    def listwise():
        for _, feats, labels in _parse_letor(path):
            yield feats, labels

    return {"pointwise": pointwise, "pairwise": pairwise,
            "listwise": listwise}[fmt]


def _make_query(rng, w, qid, n_docs):
    feats = rng.randn(n_docs, FEATURE_DIM).astype(np.float32)
    scores = feats @ w
    # graded relevance 0..2 by score tercile
    cut = np.percentile(scores, [33, 66])
    labels = np.digitize(scores, cut).astype(np.int64)
    return qid, feats, labels


def _synthetic(n_queries, seed, fmt):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(0x2007).randn(FEATURE_DIM).astype(np.float32)

    def pointwise():
        for q in range(n_queries):
            qid, feats, labels = _make_query(rng, w, q,
                                             int(rng.randint(8, 20)))
            for f, l in zip(feats, labels):
                yield f, int(l)

    def pairwise():
        for q in range(n_queries):
            qid, feats, labels = _make_query(rng, w, q,
                                             int(rng.randint(8, 20)))
            for i in range(len(feats)):
                for j in range(len(feats)):
                    if labels[i] > labels[j]:
                        yield feats[i], feats[j]

    def listwise():
        for q in range(n_queries):
            qid, feats, labels = _make_query(rng, w, q,
                                             int(rng.randint(8, 20)))
            yield feats, labels

    return {"pointwise": pointwise, "pairwise": pairwise,
            "listwise": listwise}[fmt]


def train(n_queries: int = 120, format: str = "pairwise"):
    path = common.dataset_path("mq2007", "train.txt")
    if os.path.exists(path):
        return _real(path, format)
    return _synthetic(n_queries, seed=41, fmt=format)


def test(n_queries: int = 30, format: str = "pairwise"):
    path = common.dataset_path("mq2007", "test.txt")
    if os.path.exists(path):
        return _real(path, format)
    return _synthetic(n_queries, seed=42, fmt=format)
