"""The port of the JAX package's ``datasets/conll05.py`` (a copy: the port imports
nothing of the JAX package). CoNLL-2005 semantic role labeling dataset.

Parity: the reference's v2/dataset/conll05.py — samples of
(word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb_ids, mark, iob
label ids) used by the label_semantic_roles book chapter
(the reference's v2/fluid/tests/book/test_label_semantic_roles.py).

Real data: the public ``conll05st-tests.tar.gz`` under DATA_HOME/conll05
(the reference's DATA_URL — training data is LDC-licensed, so like the
reference we parse the free WSJ test section) holding per-token ``words``
and bracketed ``props`` files, plus the line-indexed ``wordDict.txt`` /
``verbDict.txt`` / ``targetDict.txt`` vocabularies. Props columns are
converted to per-predicate IOB rows and joined with the 5-token predicate
context window exactly as the reference's reader_creator does.

Synthetic surrogate otherwise: sentences over a word vocab with one
predicate position; IOB label structure (B-*/I-*/O) correlated with
distance to the predicate + indicative tokens, so SRL models can overfit.
"""
from __future__ import annotations

import gzip
import os
import tarfile

import numpy as np

from paddle_tpu_torch.datasets import common

WORD_VOCAB = 2000
PRED_VOCAB = 100
LABEL_KINDS = 10          # B/I pairs per role + O
NUM_LABELS = 2 * LABEL_KINDS + 1  # B-x, I-x per kind + 'O'
MARK_DICT_LEN = 2
UNK_IDX = 0

_WORDS_MEMBER = "conll05st-release/test.wsj/words/test.wsj.words.gz"
_PROPS_MEMBER = "conll05st-release/test.wsj/props/test.wsj.props.gz"


def _archive():
    return common.dataset_path("conll05", "conll05st-tests.tar.gz")


def _dict_file(name):
    return common.dataset_path("conll05", name)


def _has_real():
    return os.path.exists(_archive()) and all(
        os.path.exists(_dict_file(n))
        for n in ("wordDict.txt", "verbDict.txt", "targetDict.txt"))


def _load_dict(path):
    """Line-indexed vocabulary (ref conll05.py load_dict)."""
    with open(path) as f:
        return {line.strip(): i for i, line in enumerate(f)}


def word_dict():
    if _has_real():
        return _load_dict(_dict_file("wordDict.txt"))
    return {f"w{i}": i for i in range(WORD_VOCAB)}


def verb_dict():
    if _has_real():
        return _load_dict(_dict_file("verbDict.txt"))
    return {f"v{i}": i for i in range(PRED_VOCAB)}


def label_dict():
    if _has_real():
        return _load_dict(_dict_file("targetDict.txt"))
    labels = {"O": 0}
    for k in range(LABEL_KINDS):
        labels[f"B-A{k}"] = 1 + 2 * k
        labels[f"I-A{k}"] = 2 + 2 * k
    return labels


def get_dict():
    """(ref conll05.py get_dict) -> (word, verb, label) dictionaries.

    Size embeddings/CRF from ``len()`` of these (the movielens
    max_user_id() idiom) — WORD_VOCAB / PRED_VOCAB / NUM_LABELS above are
    the synthetic surrogate's parameters and do NOT track the real
    vocabularies when data is staged."""
    return word_dict(), verb_dict(), label_dict()


EMB_DIM = 32     # word_dim of the staged wordvec file (ref book: 32)


def get_embedding():
    """(ref conll05.py get_embedding): path of the pretrained wordvec
    file when staged under DATA_HOME/conll05, else None."""
    path = _dict_file("emb")
    return path if os.path.exists(path) else None


def load_embedding(h: int, w: int = EMB_DIM, path=None):
    """Parse the staged wordvec file into a float32 [h, w] array — the
    reference book test's load_parameter (test_label_semantic_roles.py:25:
    16-byte header then raw float32)."""
    path = path or get_embedding()
    if path is None:
        raise FileNotFoundError(
            "no pretrained embedding staged under DATA_HOME/conll05/emb")
    with open(path, "rb") as f:
        f.read(16)   # header
        return np.fromfile(f, dtype=np.float32).reshape(h, w)


def _bracket_col_to_iob(col):
    """One predicate's bracketed props column -> IOB tags.

    ``(A0*`` opens span A0 (B-A0, then I-A0 on following rows), ``*)``
    closes the open span, ``(V*)`` is a single-token span, bare ``*``
    outside any span is O (ref conll05.py corpus_reader's tag loop)."""
    iob, open_tag = [], None
    for cell in col:
        if "(" in cell:
            tag = cell[1:cell.index("*")]
            iob.append("B-" + tag)
            open_tag = None if ")" in cell else tag
        elif open_tag is not None:
            iob.append("I-" + open_tag)
            if ")" in cell:
                open_tag = None
        else:
            iob.append("O")
    return iob


def _iter_corpus():
    """Yield (sentence_words, predicate_lemma, iob_labels) per predicate
    from the words/props pair in the archive (ref conll05.py
    corpus_reader — one sample per predicate column)."""
    with tarfile.open(_archive(), "r:gz") as tf:
        words_raw = gzip.decompress(
            tf.extractfile(_WORDS_MEMBER).read()).decode()
        props_raw = gzip.decompress(
            tf.extractfile(_PROPS_MEMBER).read()).decode()
    def flush(sent_words, sent_rows):
        if not sent_rows:
            return
        n_preds = len(sent_rows[0]) - 1
        for j in range(n_preds):
            col = [r[1 + j] for r in sent_rows]
            # the column's lemma sits in the first field of ITS (V*)
            # row — positional pairing against the non-'-' lemma list
            # breaks on columns without a V span (e.g. real C-V
            # continuation columns), which yield no sample at all
            lemma = next((r[0] for r, c in zip(sent_rows, col)
                          if "(V" in c and r[0] != "-"), None)
            if lemma is None:
                continue
            yield sent_words, lemma, _bracket_col_to_iob(col)

    sent_words, sent_rows = [], []
    for wline, pline in zip(words_raw.splitlines(), props_raw.splitlines()):
        word = wline.strip()
        row = pline.split()
        if not row:   # blank line = sentence boundary in both files
            yield from flush(sent_words, sent_rows)
            sent_words, sent_rows = [], []
        else:
            sent_words.append(word)
            sent_rows.append(row)
    # files without a trailing blank line still carry a final sentence
    yield from flush(sent_words, sent_rows)


def _real(word_idx, pred_idx, lab_idx):
    """9-slot samples from the parsed corpus: the predicate's 5-token
    context window is broadcast over the sentence and the window is
    marked, exactly the reference's reader_creator joins
    (ref conll05.py:126-176)."""

    def reader():
        for words, lemma, labels in _iter_corpus():
            n = len(words)
            if "B-V" not in labels:
                # e.g. a C-V continuation column with no (V*) span in
                # real CoNLL-05 data: no predicate anchor, no sample
                continue
            v = labels.index("B-V")
            mark = [0] * n
            ctx = []
            for off in (-2, -1, 0, 1, 2):
                p = v + off
                if 0 <= p < n:
                    mark[p] = 1
                    ctx.append(words[p])
                else:
                    ctx.append("bos" if off < 0 else "eos")
            wid = [word_idx.get(w, UNK_IDX) for w in words]
            ctx_ids = [[word_idx.get(c, UNK_IDX)] * n for c in ctx]
            yield (wid, *ctx_ids, [pred_idx[lemma]] * n, mark,
                   [lab_idx[t] for t in labels])

    return reader


def _synthetic(n, seed, min_len=5, max_len=25):
    rng = np.random.RandomState(seed)

    def reader():
        for _ in range(n):
            length = int(rng.randint(min_len, max_len + 1))
            words = rng.randint(0, WORD_VOCAB, length).astype(np.int64)
            pred_pos = int(rng.randint(0, length))
            verb = int(rng.randint(0, PRED_VOCAB))
            mark = np.zeros(length, np.int64)
            mark[pred_pos] = 1
            # role spans near the predicate, correlated with word ids
            labels = np.zeros(length, np.int64)
            kind = int(words[pred_pos] % LABEL_KINDS)
            span_start = max(0, pred_pos - 2)
            labels[span_start] = 1 + 2 * kind
            for i in range(span_start + 1, min(length, pred_pos + 1)):
                labels[i] = 2 + 2 * kind
            ctx = [np.roll(words, s) for s in (2, 1, 0, -1, -2)]
            yield (words.tolist(), *[c.tolist() for c in ctx],
                   [verb] * length, mark.tolist(), labels.tolist())

    return reader


def _truncated(reader, n):
    """Cap a reader at n samples so train(n)/test(n) mean the same
    stream length whether the real corpus or the synthetic surrogate
    backs them."""
    def capped():
        for i, sample in enumerate(reader()):
            if i >= n:
                return
            yield sample

    return capped


def train(n: int = 1000):
    """The CoNLL-2005 training section is LDC-licensed; like the
    reference (conll05.py:204 'the test dataset is used for training')
    the real branch reads the free WSJ test section."""
    if _has_real():
        return _truncated(_real(*get_dict()), n)
    return _synthetic(n, seed=1)


def test(n: int = 200):
    if _has_real():
        return _truncated(_real(*get_dict()), n)
    return _synthetic(n, seed=2)
