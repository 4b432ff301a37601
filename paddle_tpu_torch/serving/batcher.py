"""Micro-batching queue: requests accumulate until a flush condition.

The serving analog of the reference trainer's batch assembly, inverted
for an online workload: instead of a reader pulling examples, concurrent
clients push requests and a dispatch worker pulls *flushes* — either
``max_batch`` rows have accumulated (full flush, best throughput) or the
oldest waiting request has aged ``max_wait_ms`` (timeout flush, bounded
latency). The queue depth is hard-bounded: past ``max_queue`` pending
requests, ``submit`` raises ``ServingOverloadError`` immediately —
explicit backpressure the client can retry against, never a silent
stall (the robustness guardrail Clipper-style systems make first-class).

The port of the JAX package's ``serving/batcher.py``, unchanged: it holds
host objects only (the feeds stay numpy until the dispatch worker).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from concurrent.futures import Future

__all__ = ["MicroBatcher", "Request", "ServingOverloadError"]


class ServingOverloadError(RuntimeError):
    """Raised by ``submit`` when the pending queue is at ``max_queue``
    — the explicit reject-with-error backpressure signal."""


_request_ids = itertools.count(1)


class Request:
    """One in-flight inference request: its feed rows, a Future carrying
    the per-request result rows, and its enqueue timestamps (the start
    of the request-latency measurement). ``request_id`` is the
    process-unique id per-request trace spans carry; ``span_sid`` holds
    the root ``serving_request`` span handle once the engine opens one
    (the queue/execute child spans parent to it across threads).
    ``t_ns`` is the monotonic_ns twin of ``t_enqueue`` so those spans
    share the tracer's clock."""

    __slots__ = ("feed", "rows", "future", "t_enqueue", "t_ns",
                 "request_id", "span_sid")

    def __init__(self, feed: Dict[str, object], rows: int):
        self.feed = feed
        self.rows = int(rows)
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()
        self.t_ns = time.monotonic_ns()
        self.request_id = next(_request_ids)
        self.span_sid: Optional[int] = None


class MicroBatcher:
    """Thread-safe pending queue with the two-condition flush policy.

    ``next_batch()`` (called by the dispatch worker) blocks until a
    flush is due and returns a non-empty list of requests whose total
    rows fit ``max_batch``; returns None once closed and drained.
    """

    def __init__(self, max_batch: int, max_wait_ms: float = 2.0,
                 max_queue: int = 256):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        self._pending: deque = deque()
        self._pending_rows = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closed = False

    # ----------------------------------------------------------- client
    def submit(self, request: Request) -> Request:
        if request.rows > self.max_batch:
            raise ValueError(
                f"request of {request.rows} rows exceeds max_batch "
                f"{self.max_batch}; split it client-side")
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if len(self._pending) >= self.max_queue:
                raise ServingOverloadError(
                    f"queue full ({self.max_queue} pending requests); "
                    "retry with backoff")
            self._pending.append(request)
            self._pending_rows += request.rows
            self._cv.notify_all()
        return request

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def pending_rows_snapshot(self) -> List[int]:
        """Row counts of the pending requests, queue order — the raw
        material for per-rung queue-depth stats (the engine maps each
        through its ladder; the decode engine reports the same shape
        from its own queue, so both ``stats()`` share one schema)."""
        with self._lock:
            return [r.rows for r in self._pending]

    # ----------------------------------------------------------- worker
    def next_batch(self, poll_s: float = 0.05) -> Optional[List[Request]]:
        """Block until a flush is due; pop and return it.

        Flush when (a) >= max_batch rows are pending, or (b) the oldest
        pending request has waited max_wait_ms, or (c) the batcher was
        closed (drain: remaining requests flush immediately).
        """
        with self._cv:
            while True:
                if self._pending:
                    if (self._pending_rows >= self.max_batch
                            or self._closed):
                        return self._pop_locked()
                    deadline = self._pending[0].t_enqueue + self.max_wait_s
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        return self._pop_locked()
                    self._cv.wait(timeout=min(remaining, poll_s))
                else:
                    if self._closed:
                        return None
                    self._cv.wait(timeout=poll_s)

    def _pop_locked(self) -> List[Request]:
        batch: List[Request] = []
        rows = 0
        while self._pending and \
                rows + self._pending[0].rows <= self.max_batch:
            r = self._pending.popleft()
            rows += r.rows
            batch.append(r)
        self._pending_rows -= rows
        return batch

    def close(self):
        """Stop accepting; pending requests still drain via
        ``next_batch`` until it returns None."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
