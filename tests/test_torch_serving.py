"""The port's fixed-shape serving front end (``serving/bucketing.py``,
``serving/batcher.py``, ``serving/engine.py``), ``InferSession``'s
counters and ``kv_pool_hbm_bytes``, held against the JAX package on the
CPU.

- ``BucketLadder`` (``describe``, ``bucket_batch``, ``bucket_len``,
  ``size``, ``signatures`` and its errors), ``request_rows`` and
  ``assemble_batch`` (padded arrays, LoD, lens, row slices) equal JAX's;
  ``MicroBatcher`` keeps JAX's flush and backpressure contract (the
  cases of ``tests/test_serving.py``).
- Both ``ServingEngine``s serve the dense MLP and the LoD
  ``sequence_pool(seq_lens=)`` programs of ``tests/test_serving.py`` and
  the LSTM flagship (``lstm_benchmark_net(fused_proj=True)`` at vocab
  100, emb 16, hidden 128, 2 layers: the fused route's plain version at
  rungs of 8) from the same parameters (``scope_from_jax``) on the same
  requests: every request's rows allclose (rtol 1e-5, atol 1e-6) to the
  JAX engine's and to the port's own unpadded ``Executor.run`` of that
  request (padding changes a batch's shapes, so its sums' order: rows
  are held allclose, not bitwise, as on the JAX side).
- The compile count after warmup under random request sizes (bounded by
  the ladder, and equal to JAX's), the ``stats()`` keys and the registry
  metric names, ``queue_depth_by_rung``, ``requestz``, ``numerics=``
  (stats folded every ``sample_every``-th flush, as JAX's),
  ``profile=``, ``serve_port=`` raising with A10's name.
- ``InferSession.compiles`` / ``fresh_compiles`` / ``cache_loads`` /
  ``warm`` and the telemetry counters equal JAX's over one feed
  sequence.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core.lod import LoD as JLoD, LoDTensor as JLoDTensor
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.framework import program as jprog
from paddle_tpu.models import text as jtext
from paddle_tpu import serving as jsrv
from paddle_tpu.serving import bucketing as jbk
from paddle_tpu.serving import kvcache as jkv

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.core.lod import LoD, LoDTensor
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch import serving as tsrv
from paddle_tpu_torch.serving import bucketing as tbk
from paddle_tpu_torch.serving import kvcache as tkv

RTOL, ATOL = 1e-5, 1e-6
VOCAB = {"lod": 50, "flagship": 100}

# every engine a test builds: both packages' engines autostart worker
# threads, and a JAX engine built with profile= holds a profiler capture
# (with its Python tracer) open until close()
_ENGINES = []


@pytest.fixture(autouse=True)
def _close_engines():
    yield
    while _ENGINES:
        _ENGINES.pop().close()


def _fresh_build(side, net):
    """``net(pkg)`` in fresh main/startup programs of one package, its
    name counters cleared for the build and restored after."""
    pkg, mod = (jpt, jprog) if side == "jax" else (pt, tprog)
    saved = dict(mod._name_counters)
    mod._name_counters.clear()
    main, start = pkg.Program(), pkg.Program()
    try:
        with pkg.program_guard(main, start):
            out = net(pkg)
    finally:
        mod._name_counters.clear()
        mod._name_counters.update(saved)
    return main, start, out


def _mlp(pkg):
    x = pkg.layers.data("x", [16])
    h = pkg.layers.fc(x, 8, act="relu")
    return ["x"], pkg.layers.softmax(pkg.layers.fc(h, 4))


def _lod(pkg):
    words = pkg.layers.data("words", [1], dtype="int64", lod_level=1)
    lens = pkg.layers.data("lens", [], dtype="int32")
    emb = pkg.layers.embedding(words, size=[50, 8])
    pooled = pkg.layers.sequence_pool(emb, "average", seq_lens=lens)
    return ["words", "lens"], pkg.layers.softmax(pkg.layers.fc(pooled, 3))


def _flagship(pkg):
    words = pkg.layers.data("words", [1], dtype="int64", lod_level=1)
    label = pkg.layers.data("label", [1], dtype="int64")
    lens = pkg.layers.data("lens", [], dtype="int32")
    text = jtext if pkg is jpt else ttext
    pred, _, _ = text.lstm_benchmark_net(
        words, label, 100, emb_dim=16, hid_dim=128, num_layers=2,
        seq_lens=lens, fused_proj=True)
    return ["words", "lens"], pred


NETS = {
    "mlp": (_mlp, dict(ladder=dict(max_batch=8)), {}),
    "lod": (_lod, dict(ladder=dict(max_batch=4,
                                   seq_buckets={"words": [4, 8]})),
            {"lens": "words"}),
    "flagship": (_flagship, dict(ladder=dict(
        batch_buckets=[8, 16], seq_buckets={"words": [4, 8]})),
        {"lens": "words"}),
}


class _Sides:
    """One net built by both packages from the JAX startup's state: the
    JAX (program, executor, scope) and the port's, the feeds and the
    fetch name."""

    def __init__(self, kind):
        net = NETS[kind][0]
        jmain, jstart, (feeds, jy) = _fresh_build("jax", net)
        tmain, _, (_, ty) = _fresh_build("torch", net)
        assert jy.name == ty.name
        self.kind, self.feeds, self.fetch = kind, feeds, ty.name
        self.jscope = JScope()
        self.jexe = jpt.Executor()
        self.jexe.run(jstart, scope=self.jscope)
        state = {n: np.asarray(self.jscope.find_var(n))
                 for n in self.jscope.local_var_names()}
        self.tscope = scope_from_jax(state, Scope(), device="cpu")
        self.texe = pt.Executor(pt.CPUPlace())
        # the JAX Executor traces every op of the block, so its serving
        # program is pruned to the fetch (the loss needs a label); the
        # port runs only the ops the fetch needs
        self.jprog = jmain.clone(for_test=True)
        jpt.io._prune_for_inference(self.jprog, [self.fetch])
        self.tprog = tmain.clone(for_test=True)

    def engines(self, **kw):
        ladder_kw = NETS[self.kind][1]["ladder"]
        lens = NETS[self.kind][2]
        common = dict(feed_names=self.feeds, fetch_names=[self.fetch],
                      lens_feeds=lens, max_wait_ms=1.0)
        common.update(kw)
        jtel, ttel = common.pop("jtel", None), common.pop("ttel", None)
        jeng = jsrv.ServingEngine(
            program=self.jprog, executor=self.jexe, scope=self.jscope,
            ladder=jsrv.BucketLadder(**ladder_kw), telemetry=jtel,
            **common)
        teng = tsrv.ServingEngine(
            program=self.tprog, executor=self.texe, scope=self.tscope,
            ladder=tsrv.BucketLadder(**ladder_kw), telemetry=ttel,
            **common)
        _ENGINES.extend((jeng, teng))
        return jeng, teng


def _requests(kind, n, seed, vocab=None):
    """``n`` seeded requests of 1-4 rows (dense) or 1-4 sequences of
    length 1-8 (LoD): (port feed, JAX feed, lengths or None)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        rows = int(rng.randint(1, 5))
        if kind == "mlp":
            x = rng.rand(rows, 16).astype(np.float32)
            out.append(({"x": x}, {"x": x}, None))
            continue
        lens = rng.randint(1, 9, rows)
        toks = rng.randint(0, vocab or 50, (int(lens.sum()), 1)).astype(
            np.int64)
        lengths = [[int(v) for v in lens]]
        out.append(({"words": LoDTensor(toks, LoD.from_lengths(lengths))},
                    {"words": JLoDTensor(toks, JLoD.from_lengths(lengths))},
                    lens.astype(np.int32)))
    return out


# =====================================================================
# BucketLadder, request_rows, assemble_batch: equal to JAX's
# =====================================================================

LADDERS = [dict(max_batch=8), dict(max_batch=12),
           dict(batch_buckets=[8, 16, 32, 64, 128],
                seq_buckets={"words": [25, 50, 75, 100]}),
           dict(max_batch=4, seq_buckets={"w": [8, 16, 32], "v": [2]})]


@pytest.mark.parametrize("kw", LADDERS, ids=range(len(LADDERS)))
def test_bucket_ladder_matches_jax(kw):
    j, t = jbk.BucketLadder(**kw), tbk.BucketLadder(**kw)
    assert t.describe() == j.describe() and repr(t) == repr(j)
    assert t.size == j.size and t.max_batch == j.max_batch
    assert list(t.signatures()) == list(j.signatures())
    for n in range(1, t.max_batch + 1):
        assert t.bucket_batch(n) == j.bucket_batch(n)
    for feed, rungs in t.seq_buckets.items():
        for n in range(1, rungs[-1] + 1):
            assert t.bucket_len(feed, n) == j.bucket_len(feed, n)


def _raised(fn):
    try:
        fn()
    except Exception as exc:    # the type and message are compared
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("case", [
    lambda m: m.BucketLadder(batch_buckets=[4, 2]),
    lambda m: m.BucketLadder(batch_buckets=[]),
    lambda m: m.BucketLadder(batch_buckets=[0, 2]),
    lambda m: m.BucketLadder(max_batch=0),
    lambda m: m.BucketLadder(max_batch=4, seq_buckets={"w": [8, 8]}),
    lambda m: m.BucketLadder(max_batch=4).bucket_batch(5),
    lambda m: m.BucketLadder(max_batch=4).bucket_batch(0),
    lambda m: m.BucketLadder(max_batch=4).bucket_len("w", 3),
    lambda m: m.BucketLadder(max_batch=4, seq_buckets={"w": [8]})
    .bucket_len("w", 9),
], ids=range(9))
def test_bucket_ladder_errors_match_jax(case):
    want = _raised(lambda: case(jbk))
    assert want is not None and _raised(lambda: case(tbk)) == want


def _as_np(v):
    if isinstance(v, (LoDTensor, JLoDTensor)):
        return np.asarray(v.numpy() if isinstance(v, LoDTensor)
                          else v.array), [list(lv) for lv in v.lod.levels]
    return np.asarray(v), None


@pytest.mark.parametrize("kind", ["mlp", "lod"])
def test_assemble_batch_matches_jax(kind):
    """Flushes of 1-5 requests, padded to every rung they reach: the
    padded arrays (pad rows repeat the last real row; pad sequences are
    zeros of length 0), LoD, lens, row slices, rows, bucket, rungs and
    occupancy equal JAX's; so does each request's ``request_rows``."""
    kw = dict(max_batch=16, seq_buckets={"words": [4, 8]})
    jl, tl = jbk.BucketLadder(**kw), tbk.BucketLadder(**kw)
    lod_feeds = ("words",) if kind == "lod" else ()
    lens = {"lens": "words"} if kind == "lod" else None
    reqs = _requests(kind, 15, seed=11)
    at = 0
    for size in (1, 2, 3, 4, 5):
        chunk = reqs[at:at + size]
        at += size
        treqs = [tsrv.Request(t, tbk.request_rows(t, lod_feeds))
                 for t, _, _ in chunk]
        jreqs = [jsrv.Request(j, jbk.request_rows(j, lod_feeds))
                 for _, j, _ in chunk]
        assert [r.rows for r in treqs] == [r.rows for r in jreqs]
        tp = tbk.assemble_batch(treqs, tl, lod_feeds, lens)
        jp = jbk.assemble_batch(jreqs, jl, lod_feeds, lens)
        assert (tp.rows, tp.bucket, tp.seq_rungs, tp.row_slices) == (
            jp.rows, jp.bucket, jp.seq_rungs, jp.row_slices)
        assert tp.occupancy == jp.occupancy
        assert sorted(tp.feed) == sorted(jp.feed)
        for name in tp.feed:
            (ta, tlod), (ja, jlod) = _as_np(tp.feed[name]), _as_np(
                jp.feed[name])
            np.testing.assert_array_equal(ta, ja, err_msg=name)
            # a JAX LoDTensor holds a jnp array, and x64 is off there:
            # its int64 ids read back as int32
            assert tlod == jlod and (ta.dtype == ja.dtype or (
                ta.dtype == np.int64 and ja.dtype == np.int32)), name


def test_request_rows_errors_match_jax():
    x = np.zeros((2, 3), np.float32)
    for feeds, lod_feeds in (
            (({"a": x, "b": np.zeros((3, 1))},) * 2, ()),
            (({"a": np.float32(1)},) * 2, ()),
            (({"w": x}, {"w": x}), ("w",))):
        want = _raised(lambda: jbk.request_rows(feeds[1], lod_feeds))
        assert want is not None
        assert _raised(lambda: tbk.request_rows(feeds[0], lod_feeds)) == want


def test_assemble_batch_errors_match_jax():
    t = LoDTensor(np.zeros((9, 1), np.int64), LoD.from_lengths([[9]]))
    j = JLoDTensor(np.zeros((9, 1), np.int64), JLoD.from_lengths([[9]]))
    for m, v in ((jbk, j), (tbk, t)):
        ladder = m.BucketLadder(max_batch=4, seq_buckets={"w": [8]})
        with pytest.raises(ValueError, match="exceeds the ladder's max 8"):
            m.assemble_batch([jsrv.Request({"w": v}, 1)], ladder, ("w",))
        with pytest.raises(KeyError, match="not a LoD feed"):
            m.assemble_batch([jsrv.Request({"x": np.zeros((1, 2))}, 1)],
                             ladder, (), {"lens": "x"})


# =====================================================================
# MicroBatcher: JAX's contract (tests/test_serving.py's cases)
# =====================================================================

class TestMicroBatcher:
    def test_flush_at_max_batch(self):
        mb = tsrv.MicroBatcher(max_batch=4, max_wait_ms=10_000)
        for _ in range(4):
            mb.submit(tsrv.Request({"x": np.zeros((1, 2))}, rows=1))
        batch = mb.next_batch()
        assert len(batch) == 4 and mb.depth == 0

    def test_flush_at_timeout(self):
        mb = tsrv.MicroBatcher(max_batch=64, max_wait_ms=10.0)
        mb.submit(tsrv.Request({"x": np.zeros((1, 2))}, rows=1))
        t0 = time.perf_counter()
        assert len(mb.next_batch()) == 1
        assert time.perf_counter() - t0 < 5.0

    def test_flush_respects_row_budget(self):
        mb = tsrv.MicroBatcher(max_batch=4, max_wait_ms=0.0)
        for rows in (3, 3):
            mb.submit(tsrv.Request({"x": np.zeros((rows, 2))}, rows=rows))
        assert len(mb.next_batch()) == 1        # 3+3 > 4: second waits
        assert len(mb.next_batch()) == 1

    def test_backpressure_and_oversize(self):
        mb = tsrv.MicroBatcher(max_batch=2, max_wait_ms=10_000,
                               max_queue=3)
        with pytest.raises(ValueError, match="split it client-side"):
            mb.submit(tsrv.Request({"x": np.zeros((5, 2))}, rows=5))
        for _ in range(3):
            mb.submit(tsrv.Request({"x": np.zeros((1, 2))}, rows=1))
        with pytest.raises(tsrv.ServingOverloadError, match="queue full"):
            mb.submit(tsrv.Request({"x": np.zeros((1, 2))}, rows=1))
        assert mb.pending_rows_snapshot() == [1, 1, 1]

    def test_close_drains_then_none(self):
        mb = tsrv.MicroBatcher(max_batch=8, max_wait_ms=10_000)
        mb.submit(tsrv.Request({"x": np.zeros((1, 2))}, rows=1))
        mb.close()
        assert len(mb.next_batch()) == 1
        assert mb.next_batch() is None
        with pytest.raises(RuntimeError, match="closed"):
            mb.submit(tsrv.Request({"x": np.zeros((1, 2))}, rows=1))

    def test_bad_sizes_raise_as_jax(self):
        for kw in (dict(max_batch=0), dict(max_batch=2, max_queue=0)):
            want = _raised(lambda: jsrv.MicroBatcher(**kw))
            assert want and _raised(lambda: tsrv.MicroBatcher(**kw)) == want


# =====================================================================
# the engines, port vs JAX
# =====================================================================

def _serve(eng, feeds):
    futs = [eng.submit(f) for f in feeds]
    return [f.result(timeout=60) for f in futs]


@pytest.mark.parametrize("kind", ["mlp", "lod", "flagship"])
def test_engine_rows_match_jax_and_solo_runs(kind):
    """The same requests through both engines after warmup: each
    request's rows allclose to the JAX engine's and to the port's
    unpadded ``Executor.run`` of that request alone; the compile count
    equals JAX's and stays within the ladder."""
    s = _Sides(kind)
    jeng, teng = s.engines()
    try:
        assert teng.warmup() == jeng.warmup() == teng.ladder.size
        reqs = _requests(kind, 12, seed=3, vocab=VOCAB.get(kind))
        tout = _serve(teng, [t for t, _, _ in reqs])
        jout = _serve(jeng, [j for _, j, _ in reqs])
        for (t, _, lens), got, want in zip(reqs, tout, jout):
            assert len(got) == 1
            np.testing.assert_allclose(got[0], np.asarray(want[0]),
                                       rtol=RTOL, atol=ATOL)
            feed = dict(t)
            if lens is not None:
                feed["lens"] = lens
            solo = s.texe.run(s.tprog, feed=feed, fetch_list=[s.fetch],
                              scope=s.tscope)[0]
            np.testing.assert_allclose(got[0], solo, rtol=RTOL, atol=ATOL)
        assert teng.compile_count == jeng.compile_count <= teng.ladder.size
        ts, js = teng.stats(), jeng.stats()
        for k in ("requests_total", "rows_total", "compile_count",
                  "fresh_compiles", "compile_cache_loads",
                  "bucket_ladder", "warmed", "rejected_total"):
            assert ts[k] == js[k], k
    finally:
        teng.close()
        jeng.close()


def test_flagship_flush_with_zero_length_pad_sequences():
    """A partial flush of the flagship (3 sequences padded to rung 8, so
    5 pad sequences of length 0 reach the fused LSTM's length mask):
    every probability finite, the rows the same request's alone."""
    s = _Sides("flagship")
    _, teng = s.engines(autostart=False)
    t, _, lens = _requests("flagship", 1, seed=5, vocab=100)[0]
    rows = tbk.request_rows(t, teng.lod_feeds)
    pb = tbk.assemble_batch([tsrv.Request(t, rows)], teng.ladder,
                            teng.lod_feeds, teng.lens_feeds)
    assert pb.bucket == 8 and (pb.feed["lens"][rows:] == 0).all()
    out = teng.session.run(pb.feed)[0].numpy()
    assert np.isfinite(out).all()
    solo = s.texe.run(s.tprog, feed=dict(t, lens=lens),
                      fetch_list=[s.fetch], scope=s.tscope)[0]
    np.testing.assert_allclose(out[:rows], solo, rtol=RTOL, atol=ATOL)
    teng.close()


def test_compile_count_bounded_after_warmup_under_random_sizes():
    """Random request mixes after warmup never add a signature."""
    s = _Sides("lod")
    _, teng = s.engines()
    n = teng.warmup()
    assert n == teng.ladder.size
    _serve(teng, [t for t, _, _ in _requests("lod", 40, seed=4)])
    assert teng.compile_count == n
    teng.close()


def test_concurrent_clients_get_their_own_rows():
    s = _Sides("mlp")
    _, teng = s.engines()
    teng.warmup()
    errors = []

    def client(cid):
        rng = np.random.RandomState(cid)
        try:
            for i in range(10):
                f = {"x": rng.rand(1 + (cid + i) % 3, 16).astype(
                    np.float32)}
                got = teng.infer(f, timeout=30)[0]
                ref = s.texe.run(s.tprog, feed=f, fetch_list=[s.fetch],
                                 scope=s.tscope)[0]
                np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        except Exception as exc:   # surfaced in the main thread
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    teng.close()
    assert not errors, errors


def _telemetries():
    from paddle_tpu.obs import Telemetry as JTelemetry
    from paddle_tpu_torch.obs import Telemetry as TTelemetry
    return (JTelemetry(trace_path=None, collect_hlo=False),
            TTelemetry(trace_path=None))


def test_stats_keys_metric_names_and_spans_match_jax():
    """With telemetry on both sides and the same traffic: the same
    ``stats()`` keys, the same serving metric names in the registry (the
    ``docs/serving.md`` contract) with the same counts, and the same
    span names per request."""
    s = _Sides("mlp")
    jtel, ttel = _telemetries()
    jeng, teng = s.engines(jtel=jtel, ttel=ttel)
    try:
        teng.warmup()
        jeng.warmup()
        reqs = _requests("mlp", 6, seed=8)
        _serve(teng, [t for t, _, _ in reqs])
        _serve(jeng, [j for _, j, _ in reqs])
    finally:
        teng.close()
        jeng.close()
    assert sorted(teng.stats()) == sorted(jeng.stats())
    tsnap, jsnap = ttel.registry.snapshot(), jtel.registry.snapshot()
    serving = sorted(n for n in jsnap if n.startswith("serving_"))
    assert serving == sorted(n for n in tsnap if n.startswith("serving_"))
    assert len(serving) == 10
    for name in ("serving_requests_total", "serving_rows_total",
                 "serving_rejected_total"):
        assert tsnap[name] == jsnap[name], name
    assert teng._request_ms.count == jeng._request_ms.count == 6
    assert teng._queue_age_ms.count == 6
    assert ttel._compiles.value == jtel._compiles.value

    def names(tel):
        spans = {}
        for r in tel.tracer.records:
            if str(r.get("name", "")).startswith("serving_"):
                spans[r["name"]] = spans.get(r["name"], 0) + 1
        return spans

    tn, jn = names(ttel), names(jtel)
    assert set(tn) == set(jn) == {"serving_request", "serving_queue",
                                  "serving_flush", "serving_execute"}
    for n in ("serving_request", "serving_queue", "serving_execute"):
        assert tn[n] == jn[n] == 6, n
    flush = [r for r in ttel.tracer.records if r.get("name")
             == "serving_flush"]
    assert {"bucket", "rows", "requests", "occupancy"} <= set(
        flush[0]["args"])
    ttel.close()
    jtel.close()


def test_queue_depth_by_rung_matches_jax():
    """Parked workers: the pending requests by the rung they pad to."""
    s = _Sides("mlp")
    jeng, teng = s.engines(autostart=False)
    got = {}
    for side, eng in (("jax", jeng), ("torch", teng)):
        eng._started = True
        futs = [eng.submit({"x": np.zeros((r, 16), np.float32)})
                for r in (1, 1, 3, 5)]
        st = eng.stats()
        got[side] = (st["queue_depth"], st["queue_depth_by_rung"])
        eng._started = False
        eng.start()
        for f in futs:
            f.result(timeout=30)
        eng.close()
    assert got["torch"] == got["jax"] == (4, {"1": 2, "4": 1, "8": 1})


def test_requestz_matches_jax():
    """The retired ring after the same flushes: the same fields, counts
    and event kinds (times normalised away)."""
    s = _Sides("mlp")
    jeng, teng = s.engines(max_wait_ms=10_000.0)
    reqs = _requests("mlp", 5, seed=6)
    outs = {}
    for side, eng, i in (("jax", jeng, 1), ("torch", teng, 0)):
        eng.warmup()
        futs = [eng.submit(r[i]) for r in reqs[:2]]
        eng.close()         # the drain flushes both at once
        for f in futs:
            f.result(timeout=30)
        z = eng.requestz(n=10, order="recent")
        outs[side] = (sorted(z), z["retired_total"], z["ring"],
                      z["ring_capacity"],
                      [(r["kind"], r["rows"], r["bucket"],
                        [e[0] for e in r["events"]], len(r["timeline"]))
                       for r in z["requests"]],
                      eng.requestz(preempts=True)["requests"])
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][1] == 2


def test_numerics_folds_every_sample_every_th_flush_as_jax():
    """``numerics=NumericsSpec(sample_every=2)``: the stats fetch rides
    every flush and is popped before the rows; the host folds flushes 1,
    3, 5, ... on both sides (the same sample count), the per-rung
    snapshot keyed by the bucket, and the rows unchanged."""
    from paddle_tpu.obs.numerics import NumericsSpec as JSpec
    from paddle_tpu_torch.obs.numerics import NumericsSpec as TSpec
    s = _Sides("mlp")
    jeng = jsrv.ServingEngine(
        program=s.jprog, executor=s.jexe, scope=s.jscope,
        feed_names=s.feeds, fetch_names=[s.fetch], max_wait_ms=1.0,
        ladder=jsrv.BucketLadder(max_batch=8),
        numerics=JSpec(sample_every=2))
    teng = tsrv.ServingEngine(
        program=s.tprog, executor=s.texe, scope=s.tscope,
        feed_names=s.feeds, fetch_names=[s.fetch], max_wait_ms=1.0,
        ladder=tsrv.BucketLadder(max_batch=8),
        numerics=TSpec(sample_every=2))
    _ENGINES.extend((jeng, teng))
    reqs = _requests("mlp", 5, seed=9)
    rows = {}
    for side, eng, i in (("jax", jeng, 1), ("torch", teng, 0)):
        got = [eng.infer(r[i], timeout=60) for r in reqs]
        rows[side] = [g[0] for g in got]
        assert all(len(g) == 1 for g in got)
        eng.close()
    for a, b in zip(rows["torch"], rows["jax"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    tst, jst = teng.stats()["numerics"], jeng.stats()["numerics"]
    assert teng.numerics.samples == jeng.numerics.samples == 3
    assert sorted(tst["rungs"]) == sorted(jst["rungs"])
    assert sorted(teng.numerics.last) == sorted(jeng.numerics.last)


def test_profile_captures_over_the_engine_lifetime(tmp_path):
    """``profile=<dir>``: a capture starts with the workers and stops at
    ``close()``; ``stats()["profiler"]`` reports it."""
    s = _Sides("mlp")
    # the port's engine alone: a JAX capture would only cost its trace
    teng = tsrv.ServingEngine(
        program=s.tprog, executor=s.texe, scope=s.tscope,
        feed_names=s.feeds, fetch_names=[s.fetch], max_wait_ms=1.0,
        ladder=tsrv.BucketLadder(**NETS["mlp"][1]["ladder"]),
        profile=str(tmp_path / "prof"))
    _ENGINES.append(teng)
    assert teng.stats()["profiler"]["capturing"]
    teng.infer({"x": np.zeros((2, 16), np.float32)}, timeout=30)
    teng.close()
    st = teng.stats()["profiler"]
    assert not st["capturing"] and st["artifact"]


def test_engine_options_and_refusals():
    """``serve_port=`` raises naming A10 before any thread starts; the
    feed checks, the LoD rung check, backpressure and the drain on close
    behave as JAX's; ``program.bucket_ladder`` is set."""
    s = _Sides("mlp")
    n_threads = threading.active_count()
    with pytest.raises(NotImplementedError, match="A10"):
        tsrv.ServingEngine(program=s.tprog, feed_names=s.feeds,
                           fetch_names=[s.fetch], executor=s.texe,
                           scope=s.tscope, serve_port=0)
    assert threading.active_count() == n_threads
    with pytest.raises(ValueError, match="exactly one"):
        tsrv.ServingEngine(feed_names=s.feeds, fetch_names=[s.fetch])
    _, teng = s.engines(max_queue=4, autostart=False)
    assert s.tprog.bucket_ladder == teng.ladder.describe()
    with pytest.raises(KeyError, match="missing feed"):
        teng.submit({})
    with pytest.raises(ValueError, match="exceeds max_batch"):
        teng.submit({"x": np.zeros((9, 16), np.float32)})
    for _ in range(4):
        teng.submit({"x": np.zeros((1, 16), np.float32)})
    with pytest.raises(tsrv.ServingOverloadError):
        teng.submit({"x": np.zeros((1, 16), np.float32)})
    assert teng.stats()["rejected_total"] == 1
    teng.close()            # drains the four through the workers
    with pytest.raises(RuntimeError, match="closed"):
        teng.submit({"x": np.zeros((1, 16), np.float32)})
    sl = _Sides("lod")
    with pytest.raises(ValueError, match="seq_buckets"):
        tsrv.ServingEngine(program=sl.tprog, feed_names=["words"],
                           fetch_names=[sl.fetch], executor=sl.texe,
                           scope=sl.tscope,
                           ladder=tsrv.BucketLadder(max_batch=4))


def test_a_failing_flush_resolves_its_futures_with_the_error():
    """A request the program cannot run (16 features declared, 5 fed)
    fails its flush's futures with the error; the engine serves on."""
    s = _Sides("mlp")
    _, teng = s.engines(max_wait_ms=10_000.0)
    bad = teng.submit({"x": np.zeros((1, 5), np.float32)})
    teng.close()
    with pytest.raises(RuntimeError):
        bad.result(timeout=30)
    _, teng = s.engines()
    assert teng.infer({"x": np.zeros((1, 16), np.float32)},
                      timeout=30)[0].shape == (1, 4)
    teng.close()


# =====================================================================
# InferSession's counters, kv_pool_hbm_bytes
# =====================================================================

def test_infer_session_counters_match_jax():
    """One feed sequence (new signatures, repeats, a new batch size, a
    ``warm`` of a known and of a new signature) through both sessions
    with telemetry: ``compiles``, ``fresh_compiles``, ``cache_loads``,
    each ``warm``'s answer, ``signature`` and the session's
    ``jit_compiles_total`` and cache hits equal JAX's."""
    s = _Sides("mlp")
    jtel, ttel = _telemetries()
    s.jexe.telemetry, s.texe.telemetry = jtel, ttel
    js = s.jexe.prepare_infer(s.jprog, fetch_list=[s.fetch],
                              scope=s.jscope)
    ts = s.texe.prepare_infer(s.tprog, fetch_list=[s.fetch],
                              scope=s.tscope)
    rng = np.random.RandomState(0)
    trace = {"jax": [], "torch": []}
    for op, b in (("run", 4), ("run", 4), ("run", 2), ("warm", 2),
                  ("warm", 8), ("run", 8), ("run", 1), ("warm", 1)):
        x = {"x": rng.rand(b, 16).astype(np.float32)}
        for side, sess, tel in (("jax", js, jtel), ("torch", ts, ttel)):
            res = sess.warm(x) if op == "warm" else None
            if op == "run":
                sess.run(x)
            trace[side].append((res, sess.compiles, sess.fresh_compiles,
                                sess.cache_loads, tel._compiles.value,
                                tel._cache_hits.value))
    assert trace["torch"] == trace["jax"]
    assert trace["torch"][-1][1] == 4
    vals, lods = s.texe._normalise_feed(
        s.tprog, {"x": np.zeros((3, 16), np.float32)})
    assert ts.signature(vals, lods) == (
        ("x", (3, 16), torch.float32, None),)
    ttel.close()
    jtel.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8",
                                   "fp8-e4m3"])
def test_kv_pool_hbm_bytes_matches_jax(dtype):
    for layers in (1, 12):
        for heads, dim in ((12, 64), (8, 128), (3, 33)):
            for bs, nb in ((16, 256), (8, 1000)):
                args = (layers, heads, dim, bs, nb)
                assert tkv.kv_pool_hbm_bytes(*args, dtype=dtype) == \
                    jkv.kv_pool_hbm_bytes(*args, dtype=dtype)
