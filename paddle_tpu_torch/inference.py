"""Inference convenience API: the port of the JAX package's
``inference.py`` (the reference's v2 ``Inference`` class and
``paddle.infer`` one-shot, and the fluid load-and-run idiom). The
high-throughput path is ``paddle_tpu_torch.serving.ServingEngine``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.lod import LoD, LoDTensor
from paddle_tpu_torch.core.place import Place
from paddle_tpu_torch.framework.executor import (Executor, InferSession,
                                                 _lod_signature, _to_numpy)

__all__ = ["Inferencer", "infer"]


def _host(value) -> np.ndarray:
    """A feed or fetch value (a ``LoDTensor``'s array) as a host numpy
    array (bfloat16 as float32)."""
    if isinstance(value, LoDTensor):
        value = value.array
    if torch.is_tensor(value):
        return _to_numpy(value)
    return np.asarray(value)


def _rows(value) -> int:
    """A feed's batch: its top-level sequences if it carries LoD, else its
    leading axis."""
    if isinstance(value, LoDTensor) and value.lod:
        return value.lod.num_sequences(0)
    return int(_host(value).shape[0])


def _resize_sequences(value: LoDTensor, batch: int) -> LoDTensor:
    """A LoD feed cut or padded to ``batch`` top-level sequences, the
    last one repeated (a one-level LoD)."""
    offs = value.lod.offsets(0)
    arr = _host(value)
    seqs = [arr[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
    seqs = (seqs + [seqs[-1]] * batch)[:batch]
    return LoDTensor(np.concatenate(seqs, axis=0),
                     LoD.from_lengths([[len(q) for q in seqs]]))


class Inferencer:
    """Load a saved inference model once, run it many times.

    The parameters load once; ``infer`` runs the program through the
    eager Executor. ``warmup(sample_feed)`` runs BOTH entries an
    Inferencer exercises, as the JAX one compiles them: the
    ``Executor.run`` entry (keyed with the fetch-name tuple, so distinct
    per ``fetch_list`` variant) and the frozen-fetch ``InferSession``
    entry behind ``session()``. ``place`` None is the card.
    """

    def __init__(self, model_dir: str, place: Optional[Place] = None,
                 telemetry=None):
        from paddle_tpu_torch import io

        self.executor = Executor(place, telemetry=telemetry)
        self.program, self.feed_names, self.fetch_names = \
            io.load_inference_model(model_dir, self.executor)
        self._session: Optional[InferSession] = None
        # the Executor.run entries this Inferencer has dispatched (the
        # JAX Executor's compiled entries for its program and fetch list)
        self._run_sigs: "OrderedDict[tuple, None]" = OrderedDict()

    def _note_run(self, feed) -> bool:
        """Record the ``Executor.run`` entry ``feed`` lands on (each slot's
        shape, the dtype it is cast to and its LoD), LRU over the
        Executor's ``cache_size``. True if it is new."""
        block = self.program.global_block().vars
        sig = []
        for n, v in sorted(feed.items()):
            lod = v.lod if isinstance(v, LoDTensor) else None
            arr = v.array if isinstance(v, LoDTensor) else v
            var = block.get(n)
            dtype = (var.dtype if var is not None and var.dtype is not None
                     else str(getattr(arr, "dtype", type(arr))))
            sig.append((n, tuple(np.shape(arr)), dtype,
                        _lod_signature(lod)))
        sig = tuple(sig)
        new = sig not in self._run_sigs
        self._run_sigs[sig] = None
        self._run_sigs.move_to_end(sig)
        while len(self._run_sigs) > self.executor._cache_size:
            self._run_sigs.popitem(last=False)
        return new

    def session(self) -> InferSession:
        """The pinned-weights, frozen-fetch session (what
        ``ServingEngine`` runs on); created lazily, reused after."""
        if self._session is None:
            self._session = self.executor.prepare_infer(
                self.program, fetch_list=self.fetch_names)
        return self._session

    def warmup(self, feed: Dict[str, np.ndarray],
               batch_sizes: Optional[Sequence[int]] = None) -> int:
        """Run every entry this Inferencer will hit for ``feed``'s
        shape signature once, before real traffic arrives: the
        ``Executor.run`` entry keyed on ``fetch_list=self.fetch_names``
        (what ``infer()`` dispatches) and the frozen-fetch ``session()`` entry (what
        ``ServingEngine`` and ``session().run`` callers dispatch).
        ``batch_sizes``: more batch sizes to run (each a distinct
        signature); the sample feed's own batch size is always included.
        A dense feed is resized along its leading axis, a LoD feed by
        whole sequences (the last repeated), where the JAX Inferencer
        takes dense feeds only.
        Returns the number of new entries; a second identical call
        returns 0.
        """
        self._check_feed(feed)
        sizes = {_rows(next(iter(feed.values())))}
        sizes.update(int(b) for b in (batch_sizes or ()))
        compiled = 0
        sess = self.session()
        for b in sorted(sizes):
            sized = {n: self._resize(v, b) for n, v in feed.items()}
            compiled += int(self._note_run(sized))
            self.executor.run(self.program, feed=sized,
                              fetch_list=self.fetch_names)
            compiled += int(sess.warm(sized))
        return compiled

    @staticmethod
    def _resize(value, batch: int):
        if isinstance(value, LoDTensor) and value.lod:
            return _resize_sequences(value, batch)
        arr = _host(value)
        if arr.shape[0] == batch:
            return arr
        if arr.shape[0] > batch:
            return arr[:batch]
        reps = [arr[-1:]] * (batch - arr.shape[0])
        return np.concatenate([arr] + reps, axis=0)

    def _check_feed(self, feed):
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise KeyError(f"missing feed slot(s) {missing}; "
                           f"model expects {self.feed_names}")

    def infer(self, feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        self._check_feed(feed)
        self._note_run(feed)
        outs = self.executor.run(self.program, feed=feed,
                                 fetch_list=self.fetch_names)
        return [_host(o) for o in outs]

    def __call__(self, feed):
        return self.infer(feed)


def infer(model_dir: str, feed: Dict[str, np.ndarray],
          place: Optional[Place] = None) -> List[np.ndarray]:
    """One-shot inference (ref v2 ``paddle.infer``): load + run."""
    return Inferencer(model_dir, place).infer(feed)
