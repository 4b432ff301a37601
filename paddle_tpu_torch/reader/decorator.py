"""Composable reader decorators: the port of the JAX package's
``reader/decorator.py`` (the reference's v2/reader/decorator.py:29-236:
map_readers, shuffle, chain, compose, buffered, firstn, xmap_readers;
and the DoubleBuffer prefetch thread of the legacy C++ data providers,
dataproviders/DataProvider.h:249). ``buffered`` and ``xmap_readers``
prepare batches on host threads; ``device_buffered`` also moves them
onto the card ahead of the step. The same inputs give the JAX
decorators' outputs, ``shuffle``'s seeded order included. A
telemetry session's reader sink (``obs/goodput.py``'s
``attach_reader_sink``) sees the queue waits, as in the JAX module.

A *reader creator* is a zero-arg callable returning an iterable of
samples.
"""
from __future__ import annotations

import itertools
import queue
import random as _random
import threading
import time as _time
from typing import Callable, List, Optional

__all__ = [
    "map_readers", "shuffle", "chain", "compose", "buffered", "firstn",
    "xmap_readers", "cache", "batch", "bucket_by_sequence_length",
    "device_buffered", "ComposeNotAligned", "set_obs_sink",
]

# Observability sink — installed by obs/goodput.py (attach_reader_sink)
# for the duration of a telemetry session; this module keeps ZERO obs
# imports and the off-path cost is one module-global read per item.
# Signature: sink(queue_kind: str, wait_ms: float, qsize: int).
_OBS_SINK: Optional[Callable] = None


def set_obs_sink(sink: Optional[Callable]) -> bool:
    """Install (or, with None, clear) the module's metrics sink. The
    first installer wins so concurrent telemetry sessions don't fight
    over the global; returns False when an install was refused."""
    global _OBS_SINK
    if sink is not None and _OBS_SINK is not None:
        return False
    _OBS_SINK = sink
    return True


def _timed_get(q, queue_kind: str):
    """``q.get()`` that reports its blocking time + the post-get queue
    occupancy to the installed sink (no-op without one)."""
    sink = _OBS_SINK
    if sink is None:
        return q.get()
    t0 = _time.perf_counter()
    e = q.get()
    try:
        sink(queue_kind, (_time.perf_counter() - t0) * 1e3, q.qsize())
    except Exception:
        pass
    return e


def map_readers(func: Callable, *readers):
    """Apply func to the elements drawn in parallel from readers."""

    def reader():
        its = [r() for r in readers]
        for items in zip(*its):
            yield func(*items)

    return reader


def shuffle(reader, buf_size: int, seed=None):
    """Buffered shuffle (ref decorator.py:51)."""

    def shuffled():
        rng = _random.Random(seed)
        buf: List = []
        t_fill = _time.perf_counter()
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                sink = _OBS_SINK
                if sink is not None:
                    # one refill interval = the time this stage spent
                    # pulling buf_size samples from the wrapped reader
                    try:
                        sink("shuffle",
                             (_time.perf_counter() - t_fill) * 1e3,
                             len(buf))
                    except Exception:
                        pass
                rng.shuffle(buf)
                yield from buf
                buf = []
                t_fill = _time.perf_counter()
        if buf:
            rng.shuffle(buf)
            yield from buf

    return shuffled


def chain(*readers):
    def chained():
        return itertools.chain(*[r() for r in readers])

    return chained


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, check_alignment: bool = True):
    """Draw one sample from each reader, yield the flattened tuple
    (ref decorator.py:86)."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def composed():
        its = [r() for r in readers]
        if check_alignment:
            for items in zip(*its):
                yield sum((make_tuple(i) for i in items), ())
            # detect ragged tails
            for it in its:
                try:
                    next(it)
                    raise ComposeNotAligned(
                        "readers have different lengths")
                except StopIteration:
                    pass
        else:
            for items in itertools.zip_longest(*its):
                yield sum((make_tuple(i) for i in items if i is not None), ())

    return composed


def _put_until_stopped(q, item, stop, poll_s: float = 0.1) -> bool:
    """``q.put(item)`` that gives up once ``stop`` is set, so producer
    threads exit when the consumer abandons the iterator early (exception
    mid-pass, ``firstn``-style truncation) instead of blocking forever and
    leaking the thread plus its buffered items. Returns False if stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=poll_s)
            return True
        except queue.Full:
            continue
    return False


def buffered(reader, size: int):
    """Background-thread prefetch queue (ref decorator.py:118; the
    DoubleBuffer analog)."""
    end = object()

    def buffered_reader():
        q: queue.Queue = queue.Queue(maxsize=size)
        failure = []
        stop = threading.Event()

        def fill():
            try:
                for d in reader():
                    if not _put_until_stopped(q, d, stop):
                        return   # consumer abandoned the iterator
            except BaseException as exc:  # re-raised on the consumer side
                failure.append(exc)
            finally:
                _put_until_stopped(q, end, stop)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        try:
            while True:
                e = _timed_get(q, "buffered")
                if e is end:
                    if failure:   # a reader error must not look like a
                        raise failure[0]   # clean end-of-stream
                    break
                yield e
        finally:
            stop.set()   # unblock the fill thread if we exit early

    return buffered_reader


def device_buffered(reader, size: int = 2, device=None):
    """Device-side double buffering: a background thread copies upcoming
    items onto the device so the host-to-device transfer of batch N+1
    overlaps batch N's compute (the reference's DoubleBuffer thread,
    dataproviders/DataProvider.h:249; the JAX package's
    ``jax.device_put`` on a thread).

    ``device``: the card (``None``: ``cuda``; raises without one) or an
    explicit ``"cpu"``. On the card, the thread stages each array leaf
    in pinned host memory and queues its copy on a side stream, then
    records an event; the consumer's stream waits on that event before
    the item is handed over, and each tensor is marked used on the
    consumer's stream (``record_stream``), so the copy is ordered before
    the step that reads it and its memory outlives that step. Nothing
    here waits on the card.

    Items may be numpy arrays, tensors, dicts, lists / tuples or
    ``LoDTensor``s (nested); other leaves pass through untouched. Feed
    the results straight to ``Executor.run``: a tensor already on the
    Executor's device is not copied again.
    """
    import numpy as np
    import torch

    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    end = object()

    def _put(x):
        t = x if torch.is_tensor(x) else torch.as_tensor(x)
        if on_card and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    def _to_device(item, moved):
        if isinstance(item, LoDTensor):
            t = _put(item.array)
            moved.append(t)
            return LoDTensor(t, item.lod)
        if isinstance(item, dict):
            return {k: _to_device(v, moved) for k, v in item.items()}
        if isinstance(item, (list, tuple)):
            return type(item)(_to_device(v, moved) for v in item)
        if isinstance(item, np.ndarray) or torch.is_tensor(item):
            t = _put(item)
            moved.append(t)
            return t
        return item

    def device_buffered_reader():
        q: queue.Queue = queue.Queue(maxsize=size)
        failure = []
        stop = threading.Event()

        def fill():
            try:
                if on_card:
                    side = torch.cuda.Stream(dev)
                for d in reader():
                    moved = []
                    if on_card:
                        with torch.cuda.device(dev), torch.cuda.stream(side):
                            item = _to_device(d, moved)
                            ready = torch.cuda.Event()
                            ready.record(side)
                    else:
                        item, ready = _to_device(d, moved), None
                    if not _put_until_stopped(q, (item, moved, ready), stop):
                        return   # consumer abandoned the iterator
            except BaseException as exc:  # re-raised on the consumer side
                failure.append(exc)
            finally:
                _put_until_stopped(q, end, stop)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        try:
            while True:
                e = _timed_get(q, "device_buffered")
                if e is end:
                    if failure:   # a reader/convert error must not look like
                        raise failure[0]   # a clean end-of-stream
                    break
                item, moved, ready = e
                if ready is not None:
                    consumer = torch.cuda.current_stream(dev)
                    consumer.wait_event(ready)
                    for tensor in moved:
                        tensor.record_stream(consumer)
                yield item
        finally:
            stop.set()   # unblock the fill thread if we exit early

    return device_buffered_reader


def firstn(reader, n: int):
    def firstn_reader():
        return itertools.islice(reader(), n)

    return firstn_reader


def xmap_readers(mapper: Callable, reader, process_num: int, buffer_size: int,
                 order: bool = False):
    """Multi-thread mapper over a reader (ref decorator.py:236)."""
    end = object()

    def xreader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)
        stop = threading.Event()
        failure = []

        def feed():
            try:
                for i, d in enumerate(reader()):
                    if failure:
                        break   # error raced ahead; stop feeding work
                    if not _put_until_stopped(in_q, (i, d), stop):
                        return   # consumer abandoned the iterator
            except BaseException as exc:
                failure.append(exc)
            for _ in range(process_num):
                if not _put_until_stopped(in_q, end, stop):
                    return

        def work():
            while not (stop.is_set() or failure):
                try:
                    item = in_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is end:
                    break
                i, d = item
                try:
                    mapped = mapper(d)
                except BaseException as exc:  # a dead worker must not hang
                    failure.append(exc)       # the consumer's out_q.get()
                    break
                if not _put_until_stopped(out_q, (i, mapped), stop):
                    return
            _put_until_stopped(out_q, end, stop)

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()

        try:
            # on failure: raise promptly (not after draining the rest of
            # the stream), and never flush the post-gap tail of an
            # ordered stream — a gapped ordered stream must not be
            # delivered as if valid
            finished = 0
            if order:
                pending = {}
                want = 0
                while finished < process_num:
                    if failure:
                        raise failure[0]
                    item = out_q.get()
                    if item is end:
                        finished += 1
                        continue
                    i, d = item
                    pending[i] = d
                    while want in pending:
                        yield pending.pop(want)
                        want += 1
                if failure:
                    raise failure[0]
                for i in sorted(pending):
                    yield pending[i]
            else:
                while finished < process_num:
                    if failure:
                        raise failure[0]
                    item = out_q.get()
                    if item is end:
                        finished += 1
                        continue
                    yield item[1]
                if failure:
                    raise failure[0]
        finally:
            stop.set()   # release feed + worker threads on early exit

    return xreader


def cache(reader):
    all_data: List = []
    filled = [False]

    def cached():
        if filled[0]:
            yield from all_data
            return
        for d in reader():
            all_data.append(d)
            yield d
        filled[0] = True

    return cached


def batch(reader, batch_size: int, drop_last: bool = False):
    """Group samples into lists (ref v2/minibatch.py)."""

    def batched():
        b = []
        for d in reader():
            b.append(d)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batched


def bucket_by_sequence_length(reader, boundaries, batch_size,
                              key=None, pad_value=0, drop_oversize=False):
    """Group variable-length samples into length buckets and pad each
    batch to its bucket boundary, so an Executor compiles at most
    ``len(boundaries)`` programs instead of one per distinct length.

    The XLA answer to the reference's padding-free variable-length
    machinery (SURVEY §7(a)): the reference reorganises the batch every
    step (RecurrentGradientMachine.h:298); under static shapes the
    shapes themselves must be bounded, which bucketing does.

    ``reader`` yields samples; ``key(sample)`` gives the length
    (default: ``len(sample[0])``). Samples longer than the last
    boundary raise, or are dropped when ``drop_oversize``. Yields lists
    of samples whose first element is padded to the boundary with
    ``pad_value`` (numpy arrays padded along axis 0, lists extended).
    """
    import numpy as np  # heavier deps stay lazy in this module

    bounds = sorted(int(b) for b in boundaries)
    if not bounds:
        raise ValueError("need at least one boundary")
    get_len = key or (lambda sample: len(sample[0]))

    def pad_to(sample, target):
        seq = sample[0]
        n = len(seq)
        if n == target:
            return sample
        if isinstance(seq, np.ndarray):
            widths = [(0, target - n)] + [(0, 0)] * (seq.ndim - 1)
            seq = np.pad(seq, widths, constant_values=pad_value)
        else:
            seq = list(seq) + [pad_value] * (target - n)
        return (seq,) + tuple(sample[1:])

    def bucketed():
        buckets = {b: [] for b in bounds}
        for sample in reader():
            n = get_len(sample)
            target = next((b for b in bounds if n <= b), None)
            if target is None:
                if drop_oversize:
                    continue
                raise ValueError(
                    f"sample length {n} exceeds the last bucket "
                    f"boundary {bounds[-1]}")
            bucket = buckets[target]
            bucket.append(pad_to(sample, target))
            if len(bucket) == batch_size:
                yield list(bucket)
                bucket.clear()
        for b in bounds:   # flush partials, longest-first is irrelevant
            if buckets[b]:
                yield list(buckets[b])

    return bucketed
