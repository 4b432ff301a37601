"""The port's numerics observatory (``ops/math.py`` ``tensor_stats``,
``analysis/instrument.py``, ``obs/numerics.py``) held against the JAX
package's on the CPU, on the same numpy inputs.

- ``tensor_stats`` against the JAX op on finite, NaN/Inf, all-zero,
  empty, bf16, integer and near-the-edges inputs: the count and fraction
  lanes exact, the rest rtol 1e-6.
- ``select_tensors`` picks the JAX pass's targets on the same program
  (the MNIST MLP at 784-32-16-10 built through both layers DSLs), by
  default, by op kind, by name and under the cap; ``install_numerics``
  appends the same ops, so the instrumented programs' fingerprints are
  equal.
- The sampling cadence (``should_sample``, ``should_sample_group``)
  equals the JAX monitor's; ``update`` folds the same fetches into the
  same EMA, ``last`` and report.
- ``CalibrationStore``: the same ``entry_key`` as JAX's, and a store
  written by either package loads in the other.
- ``bisect_nan_origin`` on a planted NaN batch gives the JAX verdict,
  from a clean state and after a "warn" trip in the Trainer (with the
  alert's annotation and the flight bundle's files); after the trip the
  port's repaired parameters are a superset of JAX's (ROADMAP C7).
- A Trainer with ``numerics=`` samples the JAX Trainer's steps, with
  stats allclose to JAX's (rtol 1e-5); a step that does not sample runs
  no ``tensor_stats`` op, and its costs and parameters are bit-equal to
  those of a run that samples every step.
"""
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core import scope as jscope
from paddle_tpu.framework import program as jprog
from paddle_tpu.framework import registry as jreg
from paddle_tpu.analysis import instrument as jinst
from paddle_tpu.obs import numerics as jnum
from paddle_tpu.trainer import Trainer as JTrainer

import paddle_tpu_torch as pt
from paddle_tpu_torch.analysis import instrument as tinst
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.obs import numerics as tnum
from paddle_tpu_torch.ops.math import N_STATS, STAT_NAMES
from paddle_tpu_torch.trainer import Trainer

SIDES = {"jax": (jpt, jprog, jscope, JTrainer, jnum),
         "torch": (pt, tprog, tscope, Trainer, tnum)}
EXACT = ("nonfinite_count", "zero_frac", "exp_hi_frac", "exp_lo_frac",
         "count")


@pytest.fixture(autouse=True)
def clean_state():
    for side in SIDES.values():
        side[1].fresh_programs()
        side[2].reset_global_scope()
    yield
    for side in SIDES.values():
        side[1].fresh_programs()
        side[2].reset_global_scope()


def _stats_inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(6, 7).astype(np.float32)
    bad = x.copy()
    bad[0, 1], bad[2, 3], bad[4, 4] = np.nan, np.inf, -np.inf
    edges = np.array([3e38, 1e-38, 0.0, 2e-45, -1e36, 1.0], np.float32)
    return {
        "finite": x,
        "nonfinite": bad,
        "zeros": np.zeros((3, 5), np.float32),
        "empty": np.zeros((0, 4), np.float32),
        "bf16": x * 1e4,
        "int": rng.randint(-5, 5, (4, 6)).astype(np.int64),
        "edges": edges,
        "all_nan": np.full((2, 2), np.nan, np.float32),
    }


@pytest.mark.parametrize("case", list(_stats_inputs()))
@pytest.mark.parametrize("bits", [8.0, 2.0])
def test_tensor_stats_matches_jax(case, bits):
    import jax.numpy as jnp
    x = _stats_inputs()[case]
    attrs = {"headroom_bits": bits}
    jx = jnp.asarray(x, jnp.bfloat16) if case == "bf16" else jnp.asarray(x)
    want = np.asarray(jreg.get_op_info("tensor_stats").compute(
        {"X": [jx]}, attrs, jreg.OpContext(attrs=attrs))["Out"])
    tx = torch.from_numpy(x)
    if case == "bf16":
        tx = tx.to(torch.bfloat16)
    got = treg.get_op_info("tensor_stats").compute(
        {"X": [tx]}, attrs, treg.OpContext(attrs=attrs))["Out"]
    assert got.dtype == torch.float32 and tuple(got.shape) == (N_STATS,)
    got = got.numpy()
    for i, name in enumerate(STAT_NAMES):
        if name in EXACT:
            assert got[i] == want[i], (name, got[i], want[i])
        else:
            np.testing.assert_allclose(got[i], want[i], rtol=1e-6,
                                       atol=0, err_msg=name)


@pytest.mark.parametrize("op", ["cast", "isfinite", "stack"])
def test_health_and_numerics_helper_ops_match_jax(op):
    import jax.numpy as jnp
    x = np.array([[1.5, -2.0], [np.inf, 0.25]], np.float32)
    cases = {"cast": ({"X": [x]}, {"dtype": "float16"}),
             "isfinite": ({"X": [x]}, {}),
             "stack": ({"X": [x[0], x[1] * 2]}, {"axis": 0})}
    ins, attrs = cases[op]
    ji, ti = jreg.get_op_info(op), treg.get_op_info(op)
    full = dict(ji.attrs, **attrs)
    want = np.asarray(ji.compute(
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}, full,
        jreg.OpContext(attrs=full))["Out"])
    got = ti.compute({k: [torch.from_numpy(a) for a in v]
                      for k, v in ins.items()}, dict(ti.attrs, **attrs),
                     treg.OpContext(attrs=full))["Out"]
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def _mlp(side, optimize=True):
    pkg = SIDES[side][0]
    img = pkg.layers.data("img", [784])
    label = pkg.layers.data("label", [1], dtype="int64")
    h = pkg.layers.fc(pkg.layers.fc(img, 32, act="relu"), 16, act="relu")
    logits = pkg.layers.fc(h, 10)
    loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits,
                                                                 label))
    opt = pkg.optimizer.Adam(0.01)
    if optimize:
        opt.minimize(loss)
    return loss, opt, [img, label]


@pytest.mark.parametrize("sel", [
    {}, {"op_types": ["relu", "mean"]}, {"name_regex": r"fc_1\."},
    {"op_types": ["mul"], "name_regex": "softmax"}, {"max_tensors": 3},
    {"include_backward": True, "max_tensors": 64}])
def test_select_and_install_match_jax(sel):
    got = {}
    for side, inst in (("jax", jinst), ("torch", tinst)):
        SIDES[side][1].fresh_programs()
        _mlp(side)
        main = SIDES[side][0].default_main_program()
        logs = []
        targets = inst.select_tensors(main, log=logs.append, **sel)
        var = inst.install_numerics(main.global_block(),
                                    [t.var for t in targets])
        got[side] = ([tuple(t) for t in targets], logs, var.name,
                     tuple(var.shape), main.fingerprint())
    assert got["torch"] == got["jax"]
    assert got["torch"][0]


def test_sampling_cadence_matches_jax():
    for every in (1, 3, 8):
        mons = {s: SIDES[s][4].NumericsMonitor(
            SIDES[s][4].NumericsSpec(sample_every=every))
            for s in SIDES}
        for m in mons.values():
            m.var = object()    # installed
        for step in range(1, 25):
            assert (mons["torch"].should_sample(step)
                    == mons["jax"].should_sample(step))
            for k in (2, 4, 8):
                assert (mons["torch"].should_sample_group(step, k)
                        == mons["jax"].should_sample_group(step, k))


def test_update_ema_and_report_match_jax():
    rng = np.random.RandomState(1)
    mons = {}
    for side in SIDES:
        SIDES[side][1].fresh_programs()
        _mlp(side)
        m = SIDES[side][4].NumericsMonitor(
            SIDES[side][4].NumericsSpec(max_tensors=4, decay=0.9))
        m.install(SIDES[side][0].default_main_program())
        mons[side] = m
    fetches = [rng.rand(4, N_STATS), rng.rand(3, 4, N_STATS),
               rng.rand(4, N_STATS)]
    for i, f in enumerate(fetches):
        for m in mons.values():
            m.update(f, step=i + 1)
    rj, rt = mons["jax"].report(), mons["torch"].report()
    assert rt.keys() == rj.keys()
    assert rt["ema"] == rj["ema"] and rt["last"] == rj["last"]
    assert rt["targets"] == rj["targets"]
    assert mons["torch"].status() == mons["jax"].status()


def test_calibration_store_keys_and_cross_loads(tmp_path):
    for fp, bits in (("abc", 8.0), ("f" * 64, 2.5)):
        assert (tnum.CalibrationStore.entry_key(fingerprint=fp,
                                                headroom_bits=bits)
                == jnum.CalibrationStore.entry_key(fingerprint=fp,
                                                   headroom_bits=bits))
    ranges = {"fc_0.tmp_0": {"absmax": 3.5, "rms": 1.25, "samples": 4.0}}
    for writer, reader in ((tnum, jnum), (jnum, tnum)):
        root = tmp_path / writer.__name__.split(".")[0]
        key = writer.CalibrationStore.entry_key(fingerprint="fp",
                                                headroom_bits=8.0)
        writer.CalibrationStore(str(root)).put(key, ranges,
                                               meta={"fingerprint": "fp"})
        doc = reader.CalibrationStore(str(root)).load(key)
        assert doc["ranges"] == ranges and doc["fingerprint"] == "fp"
        assert reader.CalibrationStore(str(root)).entries() == [key]
    assert tnum.CalibrationStore.resolve(False) is None
    with pytest.raises(TypeError):
        tnum.CalibrationStore.resolve(3)


def _pair(build, trainer_kw):
    """The JAX Trainer after its startup program, and the port's from the
    same state (both built by ``build`` with ``trainer_kw``)."""
    out = {}
    for side in ("jax", "torch"):
        pkg, _, scope, trainer_cls, _ = SIDES[side]
        loss, opt, feeds = build(side, optimize=False)
        out[side] = trainer_cls(cost=loss, optimizer=opt, feed_list=feeds,
                                place=pkg.CPUPlace(), **trainer_kw(side))
        if side == "jax":
            out[side]._init_params()
            main = out[side].main_program
            state = {n: np.array(jscope.global_scope().find_var(n).array)
                     for n, v in main.global_block().vars.items()
                     if v.persistable
                     and jscope.global_scope().find_var(n) is not None}
    scope_from_jax(state, device="cpu")
    out["torch"]._initialized = True
    # the JAX Executor's step counter counts its startup run
    out["torch"].exe._step_ctr = out["jax"].exe._step_ctr
    return out["jax"], out["torch"]


def _batches(n, nan_at=None, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for b in range(n):
        batch = [(rng.rand(784).astype(np.float32), int(rng.randint(10)))
                 for _ in range(8)]
        if b == nan_at:
            img = batch[3][0].copy()
            img[100] = np.nan
            batch[3] = (img, batch[3][1])
        out.append(batch)
    return out


def test_trainer_numerics_match_jax():
    stats = {"jax": [], "torch": []}
    jtr, ttr = _pair(_mlp, lambda side: {"numerics": SIDES[side][4]
                                         .NumericsSpec(sample_every=3,
                                                       max_tensors=6)})
    for side, tr in (("jax", jtr), ("torch", ttr)):
        orig = tr.numerics.update

        def rec(values, telemetry=None, step=None, _o=orig, _s=side):
            stats[_s].append((step, np.asarray(values, np.float64)
                              .reshape(-1, 6, N_STATS)))
            return _o(values, telemetry=telemetry, step=step)
        tr.numerics.update = rec
    data = [s for batch in _batches(7) for s in batch]
    reader = lambda: iter(data)      # noqa: E731
    jtr.train(jpt.reader.batch(reader, 8), log_period=0)
    ttr.train(pt.reader.batch(reader, 8), log_period=0)
    assert [s for s, _ in stats["torch"]] == [s for s, _ in stats["jax"]]
    assert len(stats["torch"]) >= 2
    for (_, g), (_, w) in zip(stats["torch"], stats["jax"]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert ttr.numerics.samples == jtr.numerics.samples
    assert ttr.numerics.last_step == jtr.numerics.last_step


def test_unsampled_steps_run_no_stats_and_match_sampled_ones(monkeypatch):
    """sample_every=3 against 1 (every step sampled) and against no
    numerics: the same costs and parameters bit for bit, and the
    ``tensor_stats`` op runs only on sampled steps."""
    calls = []
    info = treg.get_op_info("tensor_stats")
    orig = info.compute

    def counted(ins, attrs, ctx):
        calls.append(1)
        return orig(ins, attrs, ctx)
    monkeypatch.setattr(info, "compute", counted)
    runs = {}
    for every in (None, 1, 3):
        tprog.fresh_programs()
        tscope.reset_global_scope()
        torch.manual_seed(0)
        loss, opt, feeds = _mlp("torch", optimize=False)
        spec = (None if every is None
                else tnum.NumericsSpec(sample_every=every, max_tensors=5))
        tr = Trainer(cost=loss, optimizer=opt, feed_list=feeds,
                     place=pt.CPUPlace(), numerics=spec)
        tr.startup_program.random_seed = 0
        costs, per_step = [], []

        def handler(e):
            if isinstance(e, pt.event.EndIteration):
                costs.append(e.cost)
                per_step.append(len(calls))
        calls.clear()
        data = [s for batch in _batches(6, seed=2) for s in batch]
        tr.train(pt.reader.batch(lambda: iter(data), 8),
                 event_handler=handler, log_period=0)
        params = {p.name: tscope.global_scope().find_var(p.name)
                  .array.clone()
                  for p in tr.main_program.global_block().all_parameters()}
        runs[every] = (costs, params, np.diff([0] + per_step).tolist())
    for every in (1, 3):
        assert runs[every][0] == runs[None][0]
        for n, v in runs[None][1].items():
            assert torch.equal(runs[every][1][n], v), n
    assert runs[None][2] == [0] * 6
    assert runs[1][2] == [5] * 6
    # steps 2..7 (the startup run is step 1): 4 and 7 sample
    assert runs[3][2] == [0, 0, 5, 0, 0, 5]


def test_bisect_nan_origin_matches_jax():
    jtr, ttr = _pair(_mlp, lambda side: {})
    batch = _batches(1, nan_at=0)[0]
    verdicts = {}
    for side, tr in (("jax", jtr), ("torch", ttr)):
        feed = tr.feeder.feed(batch)
        verdicts[side] = SIDES[side][4].bisect_nan_origin(
            tr.exe, tr.main_program, feed)
    assert verdicts["torch"] == verdicts["jax"]
    assert verdicts["torch"]["found"] and verdicts["torch"]["op_index"] == 0
    assert verdicts["torch"]["var"] == "fc_0.tmp_0"


def test_monitor_ensure_contract():
    for mod in (tnum, jnum):
        assert mod.NumericsMonitor.ensure(None) is None
        assert mod.NumericsMonitor.ensure(False) is None
        assert isinstance(mod.NumericsMonitor.ensure(True),
                          mod.NumericsMonitor)
        spec = mod.NumericsSpec(sample_every=2)
        assert mod.NumericsMonitor.ensure(spec).spec is spec
        mon = mod.NumericsMonitor()
        assert mod.NumericsMonitor.ensure(mon) is mon
        with pytest.raises(TypeError):
            mod.NumericsMonitor.ensure("yes")
        with pytest.raises(ValueError):
            mod.NumericsMonitor(spec, sample_every=2)


def test_trainer_planted_nan_forensics_match_jax(tmp_path):
    """A health trip in "warn" mode with numerics on: the bisector's
    verdict, the alert's annotation and the flight bundle's files, in
    both packages."""
    from paddle_tpu.obs import FlightRecorder as JFlight
    from paddle_tpu.obs import Telemetry as JTelemetry
    from paddle_tpu_torch.obs import FlightRecorder, Telemetry
    jtr, ttr = _pair(_mlp, lambda side: {
        "health": "warn",
        "numerics": SIDES[side][4].NumericsSpec(sample_every=1)})
    data = [b for batch in _batches(3, nan_at=2) for b in batch]
    out = {}
    for side, tr, tel_cls, flight_cls in (
            ("jax", jtr, JTelemetry, JFlight),
            ("torch", ttr, Telemetry, FlightRecorder)):
        tel = tel_cls(trace_path=None, flight=flight_cls(
            out_dir=str(tmp_path / side), install_signal=False))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tr.train(SIDES[side][0].reader.batch(lambda: iter(data), 8),
                     telemetry=tel, log_period=0)
        trips = [r for r in tel.tracer.records
                 if r.get("name") == "health_trip"]
        ann = tel.alerts._annotations.get("nonfinite_grads", {})
        files = sorted(os.listdir(tel.flight.dumps[0]))
        warned = [str(x.message) for x in w
                  if issubclass(x.category, RuntimeWarning)
                  and "non-finite" in str(x.message)]
        out[side] = (len(trips), warned, tr.numerics.origin, ann,
                     "failing_feed.npz" in files, "numerics.json" in files)
        tel.close()
    # the NaN step poisons the same parameters on both sides (relu's
    # gradient at a NaN input is 0, as jax.nn.relu's custom JVP gives)
    t_rep = set(out["torch"][2].pop("state_repaired"))
    j_rep = set(out["jax"][2].pop("state_repaired"))
    assert t_rep == j_rep and "fc_0.w_0" in j_rep
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 1 and out["torch"][2]["found"]
    assert out["torch"][4] and out["torch"][5]
