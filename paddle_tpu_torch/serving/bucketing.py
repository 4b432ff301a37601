"""Shape bucketing for the serving path: the port of the JAX package's
``serving/bucketing.py``.

A ``BucketLadder`` fixes a small closed set of feed shapes up front:
request batches are padded **up** to the next batch-size rung (default
powers of two up to ``max_batch``), and ragged (LoD) feeds are padded to
a per-feed sequence-length rung with a **uniform** LoD: every sequence
occupies exactly ``seq_bucket`` rows, and the true lengths ride a
runtime ``SeqLens`` feed (ops/rnn.py, ops/sequence.py) so the math over
real rows is exact. The JAX package compiles one XLA program per feed
signature and the ladder bounds that count; the port's eager Executor
compiles nothing, but the same closed set bounds its entry bookkeeping
(``InferSession.compiles``), and the hand-written kernels see a fixed set
of shapes. ``ServingEngine.warmup()`` runs every rung before the first
request.

Padding is host work, in numpy: the pad worker assembles a flush here,
and the feed reaches the card in the dispatch worker.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from paddle_tpu_torch.core.lod import LoD, LoDTensor

__all__ = ["BucketLadder", "PaddedBatch", "assemble_batch", "request_rows"]


def _host(value) -> np.ndarray:
    """A feed value (numpy, a tensor, or a ``LoDTensor``'s array) as a
    host numpy array."""
    if isinstance(value, LoDTensor):
        value = value.array
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _powers_of_two(max_value: int) -> Tuple[int, ...]:
    rungs = []
    b = 1
    while b < max_value:
        rungs.append(b)
        b *= 2
    rungs.append(max_value)
    return tuple(rungs)


def _check_rungs(rungs: Sequence[int], what: str) -> Tuple[int, ...]:
    rungs = tuple(int(r) for r in rungs)
    if not rungs:
        raise ValueError(f"{what}: empty bucket list")
    if any(r <= 0 for r in rungs) or list(rungs) != sorted(set(rungs)):
        raise ValueError(
            f"{what}: buckets must be strictly increasing positive ints, "
            f"got {rungs}")
    return rungs


class BucketLadder:
    """The closed shape set a serving program is allowed to compile.

    ``batch_buckets``: allowed padded batch sizes (default: powers of
    two up to ``max_batch``). ``seq_buckets``: per-feed sequence-length
    rungs for LoD feeds — every LoD feed the program declares must have
    an entry, or its token axis would churn signatures unboundedly.
    """

    def __init__(self, max_batch: int = 8,
                 batch_buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Optional[Dict[str, Sequence[int]]] = None):
        if batch_buckets is None:
            if max_batch <= 0:
                raise ValueError(f"max_batch must be >= 1, got {max_batch}")
            batch_buckets = _powers_of_two(int(max_batch))
        self.batch_buckets = _check_rungs(batch_buckets, "batch_buckets")
        self.max_batch = self.batch_buckets[-1]
        self.seq_buckets = {
            name: _check_rungs(rungs, f"seq_buckets[{name!r}]")
            for name, rungs in (seq_buckets or {}).items()
        }

    # ------------------------------------------------------------- query
    def bucket_batch(self, n: int) -> int:
        """Smallest batch rung >= n."""
        if n <= 0:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for b in self.batch_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch of {n} rows exceeds the ladder's max_batch "
            f"{self.max_batch}")

    def bucket_len(self, feed: str, length: int) -> int:
        """Smallest sequence rung >= length for a LoD feed."""
        rungs = self.seq_buckets.get(feed)
        if rungs is None:
            raise KeyError(
                f"feed {feed!r} has no sequence-length buckets declared; "
                f"ladder knows {sorted(self.seq_buckets)}")
        for r in rungs:
            if length <= r:
                return r
        raise ValueError(
            f"sequence of length {length} in feed {feed!r} exceeds the "
            f"ladder's max {rungs[-1]}")

    @property
    def size(self) -> int:
        """Number of distinct padded shape signatures = compile bound."""
        n = len(self.batch_buckets)
        for rungs in self.seq_buckets.values():
            n *= len(rungs)
        return n

    def signatures(self):
        """Iterate every (batch_bucket, {lod_feed: seq_bucket}) rung —
        the warmup set."""
        lod_feeds = sorted(self.seq_buckets)
        seq_axes = [self.seq_buckets[f] for f in lod_feeds]
        for b in self.batch_buckets:
            for combo in itertools.product(*seq_axes):
                yield b, dict(zip(lod_feeds, combo))

    def describe(self) -> dict:
        """Plain-dict form — what ``Program.bucket_ladder`` carries (the
        JAX package's feed-churn lint reads it) and what ``stats()``
        reports."""
        return {
            "batch_buckets": list(self.batch_buckets),
            "max_batch": self.max_batch,
            "seq_buckets": {n: list(r)
                            for n, r in sorted(self.seq_buckets.items())},
            "size": self.size,
        }

    def __repr__(self):
        return (f"BucketLadder(batch={list(self.batch_buckets)}, "
                f"seq={ {n: list(r) for n, r in self.seq_buckets.items()} }, "
                f"size={self.size})")


class PaddedBatch:
    """One flush, padded up the ladder and ready to dispatch.

    ``feed``: dict of np arrays / LoDTensors with padded batch axis;
    ``row_slices``: per-request (start, stop) into the padded batch axis;
    ``rows``: real rows; ``bucket``: padded batch size;
    ``seq_rungs``: {lod_feed: padded per-sequence length}.
    """

    __slots__ = ("feed", "row_slices", "rows", "bucket", "seq_rungs")

    def __init__(self, feed, row_slices, rows, bucket, seq_rungs):
        self.feed = feed
        self.row_slices = row_slices
        self.rows = rows
        self.bucket = bucket
        self.seq_rungs = seq_rungs

    @property
    def occupancy(self) -> float:
        return self.rows / self.bucket if self.bucket else 0.0


def request_rows(feed: dict, lod_feeds: Sequence[str]) -> int:
    """Rows (top-level sequences for LoD feeds, batch rows for dense
    feeds) one request carries; every feed must agree."""
    counts = set()
    for name, v in feed.items():
        if name in lod_feeds:
            if not isinstance(v, LoDTensor) or not v.lod:
                raise TypeError(
                    f"feed {name!r} is declared lod_level>0; pass a "
                    "LoDTensor with its LoD")
            counts.add(v.lod.levels[0].size - 1)
        else:
            arr = _host(v)
            if arr.ndim == 0:
                raise ValueError(
                    f"feed {name!r} must carry a leading batch axis")
            counts.add(int(arr.shape[0]))
    if len(counts) != 1:
        raise ValueError(
            f"request feeds disagree on the row count: {sorted(counts)}")
    return counts.pop()


def _pad_dense(arrays: List[np.ndarray], bucket: int) -> np.ndarray:
    cat = np.concatenate(arrays, axis=0)
    pad = bucket - cat.shape[0]
    if pad < 0:
        raise ValueError(f"{cat.shape[0]} rows exceed bucket {bucket}")
    if pad == 0:
        return cat
    # pad by repeating the last real row: always in-domain (embedding
    # indices stay valid, no synthetic zeros hitting log/deinv paths);
    # pad rows are sliced away before results reach any caller
    return np.concatenate([cat, np.repeat(cat[-1:], pad, axis=0)], axis=0)


def _pad_lod(tensors: List[LoDTensor], bucket: int, seq_rung: int,
             name: str):
    """Uniform-LoD padding: every sequence padded to ``seq_rung`` rows,
    sequence count padded to ``bucket`` — ONE shape/LoD signature per
    (bucket, rung) pair. Returns (LoDTensor, lens[bucket] int32) where
    lens carries the true per-sequence lengths (0 for pad sequences)
    for the program's runtime SeqLens masking."""
    seqs: List[np.ndarray] = []
    lens: List[int] = []
    for t in tensors:
        offs = t.lod.levels[0]
        arr = _host(t)
        for i in range(offs.size - 1):
            lo, hi = int(offs[i]), int(offs[i + 1])
            seq = arr[lo:hi]
            if seq.shape[0] > seq_rung:
                raise ValueError(
                    f"feed {name!r}: sequence of length {seq.shape[0]} "
                    f"exceeds the {seq_rung} rung")
            lens.append(seq.shape[0])
            if seq.shape[0] < seq_rung:
                pad_rows = seq_rung - seq.shape[0]
                pad_src = seq[-1:] if seq.shape[0] else np.zeros(
                    (1,) + arr.shape[1:], arr.dtype)
                seq = np.concatenate(
                    [seq, np.repeat(pad_src, pad_rows, axis=0)], axis=0)
            seqs.append(seq)
    if len(seqs) > bucket:
        raise ValueError(f"{len(seqs)} sequences exceed bucket {bucket}")
    first = _host(tensors[0])
    feat = seqs[0].shape[1:] if seqs else first.shape[1:]
    while len(seqs) < bucket:          # pad sequences: masked out via len 0
        seqs.append(np.zeros((seq_rung,) + feat, first.dtype))
        lens.append(0)
    packed = np.concatenate(seqs, axis=0)
    lod = LoD.from_lengths([[seq_rung] * bucket])
    return LoDTensor(packed, lod), np.asarray(lens, np.int32)


def assemble_batch(requests: Sequence, ladder: BucketLadder,
                   lod_feeds: Sequence[str],
                   lens_feeds: Optional[Dict[str, str]] = None
                   ) -> PaddedBatch:
    """Pad/stack a flush of requests up the ladder.

    ``requests``: objects with ``.feed`` (dict) and ``.rows``;
    ``lod_feeds``: feed names with lod_level > 0;
    ``lens_feeds``: {lens_feed_name: lod_feed_name} — true sequence
    lengths derived from each request's LoD are emitted on the lens
    feed, so programs built with runtime SeqLens masking stay exact
    under the uniform padding.
    """
    lens_feeds = lens_feeds or {}
    rows = sum(r.rows for r in requests)
    bucket = ladder.bucket_batch(rows)
    row_slices = []
    at = 0
    for r in requests:
        row_slices.append((at, at + r.rows))
        at += r.rows
    feed_names = list(requests[0].feed)
    feed: Dict[str, object] = {}
    seq_rungs: Dict[str, int] = {}
    derived_lens: Dict[str, np.ndarray] = {}
    for name in feed_names:
        vals = [r.feed[name] for r in requests]
        if name in lod_feeds:
            tensors = [v if isinstance(v, LoDTensor) else LoDTensor(v)
                       for v in vals]
            max_len = max(
                (int(np.max(np.diff(t.lod.levels[0]))) if
                 t.lod.levels[0].size > 1 else 0)
                for t in tensors)
            rung = ladder.bucket_len(name, max(1, max_len))
            seq_rungs[name] = rung
            feed[name], derived_lens[name] = _pad_lod(
                tensors, bucket, rung, name)
        else:
            arrays = [_host(v) for v in vals]
            feed[name] = _pad_dense(arrays, bucket)
    for lens_name, lod_name in lens_feeds.items():
        if lod_name not in derived_lens:
            raise KeyError(
                f"lens feed {lens_name!r} derives from {lod_name!r}, "
                f"which is not a LoD feed of this batch "
                f"({sorted(derived_lens)})")
        feed[lens_name] = derived_lens[lod_name]
    return PaddedBatch(feed, row_slices, rows, bucket, seq_rungs)
