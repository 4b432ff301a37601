"""The port's ``inference.py`` (``Inferencer``, ``infer``) held against
the JAX package's on the CPU.

A small softmax classifier and the LSTM flagship at vocab 100, emb 16,
hidden 128 are saved by each package's ``save_inference_model`` from the
same parameters (the port's copied from the JAX startup's state with
``scope_from_jax``) and loaded by each ``Inferencer``:

- ``warmup(sample, batch_sizes=[1])``: the JAX
  ``tests/test_serving.py::TestInferencerWarmup`` case on both packages
  (entries counted, a second call 0, ``jit_compiles_total`` unchanged
  by traffic over both entry kinds and both sizes), and the two counts
  equal;
- ``infer`` and ``session().run`` rows allclose (rtol 1e-5, atol 1e-6)
  to JAX's ``infer``, and the one-shot ``infer(model_dir, feed)``;
- ``warmup`` of a LoD feed resizes it by whole sequences (the port's
  addition: the JAX one takes dense feeds only).
"""
import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu.core.lod import LoD as JLoD, LoDTensor as JLoDTensor
from paddle_tpu.core.scope import reset_global_scope as jreset
from paddle_tpu.framework import program as jprog
from paddle_tpu.models import text as jtext

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.core.lod import LoD, LoDTensor
from paddle_tpu_torch.core.scope import global_scope as tglobal
from paddle_tpu_torch.core.scope import reset_global_scope as treset
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.models import text as ttext

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def clean_scopes():
    jreset()
    treset()
    yield
    jreset()
    treset()


def _softmax_net(pkg):
    x = pkg.layers.data("x", [8])
    return ["x"], [pkg.layers.softmax(pkg.layers.fc(x, 3))]


def _flagship_net(pkg):
    words = pkg.layers.data("words", [1], dtype="int64", lod_level=1)
    label = pkg.layers.data("label", [1], dtype="int64")
    text = jtext if pkg is jpt else ttext
    pred, _, _ = text.lstm_benchmark_net(words, label, 100, emb_dim=16,
                                         hid_dim=128, fused_proj=True)
    return ["words"], [pred]


def _save_both(net, tmp_path):
    """``net`` built by both packages in fresh programs, the JAX startup
    run into JAX's global scope and copied into the port's, each saved
    by its own ``save_inference_model``: (JAX dir, port dir)."""
    dirs = {}
    for side, pkg, mod in (("jax", jpt, jprog), ("torch", pt, tprog)):
        saved = dict(mod._name_counters)
        mod._name_counters.clear()
        main, start = pkg.Program(), pkg.Program()
        try:
            with pkg.program_guard(main, start):
                feeds, outs = net(pkg)
        finally:
            mod._name_counters.clear()
            mod._name_counters.update(saved)
        d = str(tmp_path / side)
        if side == "jax":
            exe = jpt.Executor()
            exe.run(start)
            from paddle_tpu.core.scope import global_scope as jglobal
            state = {n: np.asarray(jglobal().find_var(n))
                     for n in jglobal().local_var_names()}
        else:
            exe = pt.Executor(pt.CPUPlace())
            scope_from_jax(state, tglobal(), device="cpu")
        pkg.io.save_inference_model(d, feeds, outs, exe, main_program=main)
        dirs[side] = d
    jreset()
    treset()
    return dirs["jax"], dirs["torch"]


def test_inferencer_warmup_as_jax(tmp_path):
    """The JAX warmup case on both packages: entries counted, idempotent,
    no compile under traffic over both entry kinds and sizes."""
    from paddle_tpu.obs import Telemetry as JTelemetry
    from paddle_tpu_torch.obs import Telemetry as TTelemetry
    jdir, tdir = _save_both(_softmax_net, tmp_path)
    sides = {"jax": (jpt.Inferencer, jdir, JTelemetry(
                 trace_path=None, collect_hlo=False), {}),
             "torch": (pt.Inferencer, tdir, TTelemetry(trace_path=None),
                       {"place": pt.CPUPlace()})}
    counts = {}
    for side, (cls, d, tel, kw) in sides.items():
        inf = cls(d, telemetry=tel, **kw)
        sample = {"x": np.zeros((4, 8), np.float32)}
        compiled = inf.warmup(sample, batch_sizes=[1])
        assert compiled > 0
        assert inf.warmup(sample, batch_sizes=[1]) == 0
        misses = tel.registry.snapshot()["jit_compiles_total"][
            "series"][""]["value"]
        rng = np.random.RandomState(5)
        for b in (1, 4, 4, 1):
            feed = {"x": rng.rand(b, 8).astype(np.float32)}
            inf.infer(feed)
            inf.session().run(feed)
        assert tel.registry.snapshot()["jit_compiles_total"]["series"][
            ""]["value"] == misses, side
        counts[side] = (compiled, misses)
        tel.close()
    assert counts["torch"] == counts["jax"] == (4, 4)


def test_inferencer_warmup_without_telemetry(tmp_path):
    """No telemetry session: the Executor's entries still count, so a
    warmup returns its entries, then 0; a new size counts again."""
    _, tdir = _save_both(_softmax_net, tmp_path)
    inf = pt.Inferencer(tdir, place=pt.CPUPlace())
    sample = {"x": np.zeros((8, 8), np.float32)}
    assert inf.warmup(sample) == 2
    assert inf.warmup(sample) == 0
    assert inf.warmup(sample, batch_sizes=[3]) == 2
    assert inf.session().compiles == 2


def test_inferencer_warmup_resizes_lod_feeds_by_sequences(tmp_path):
    """A LoD sample (the flagship's words) is resized by whole sequences
    (the JAX Inferencer takes dense feeds only): 1 and 8 sequences warm
    two entries each, then nothing; rows of the 8-sequence feed equal
    8 copies of the one sequence's."""
    _, tdir = _save_both(_flagship_net, tmp_path)
    inf = pt.Inferencer(tdir, place=pt.CPUPlace())
    toks = np.random.RandomState(4).randint(0, 100, (7, 1)).astype(np.int64)
    sample = {"words": LoDTensor(toks, LoD.from_lengths([[7]]))}
    assert inf.warmup(sample, batch_sizes=[8]) == 4
    assert inf.warmup(sample, batch_sizes=[8]) == 0
    eight = inf._resize(sample["words"], 8)
    assert eight.lod.levels[0].tolist() == list(range(0, 57, 7))
    one = inf.infer(sample)[0]
    many = inf.infer({"words": eight})[0]
    np.testing.assert_allclose(many, np.repeat(one, 8, axis=0), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kind", ["softmax", "flagship"])
def test_infer_rows_match_jax(kind, tmp_path):
    """``infer``, ``session().run`` and the one-shot ``infer`` give JAX's
    rows on the same feeds."""
    net = _softmax_net if kind == "softmax" else _flagship_net
    jdir, tdir = _save_both(net, tmp_path)
    jinf = jpt.Inferencer(jdir)
    tinf = pt.Inferencer(tdir, place=pt.CPUPlace())
    assert (tinf.feed_names, tinf.fetch_names) == (jinf.feed_names,
                                                   jinf.fetch_names)
    rng = np.random.RandomState(2)
    for b in (1, 8, 16):
        if kind == "softmax":
            x = rng.rand(b, 8).astype(np.float32)
            tfeed, jfeed = {"x": x}, {"x": x}
        else:
            lens = [[7] * b]      # uniform: the fused route on both sides
            toks = rng.randint(0, 100, (7 * b, 1)).astype(np.int64)
            tfeed = {"words": LoDTensor(toks, LoD.from_lengths(lens))}
            jfeed = {"words": JLoDTensor(toks, JLoD.from_lengths(lens))}
        want = np.asarray(jinf.infer(jfeed)[0])
        got = tinf.infer(tfeed)
        assert isinstance(got[0], np.ndarray) and got[0].shape == want.shape
        np.testing.assert_allclose(got[0], want, rtol=RTOL, atol=ATOL)
        sess = tinf.session().run(tfeed)[0].numpy()
        np.testing.assert_allclose(sess, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            pt.infer(tdir, tfeed, place=pt.CPUPlace())[0], want,
            rtol=RTOL, atol=ATOL)


def test_inferencer_checks_its_feed(tmp_path):
    _, tdir = _save_both(_softmax_net, tmp_path)
    inf = pt.Inferencer(tdir, place=pt.CPUPlace())
    with pytest.raises(KeyError, match="missing feed"):
        inf.infer({})
    with pytest.raises(KeyError, match="missing feed"):
        inf.warmup({"y": np.zeros((1, 8), np.float32)})
    assert inf({"x": np.zeros((2, 8), np.float32)})[0].shape == (2, 3)
