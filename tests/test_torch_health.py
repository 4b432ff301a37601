"""The port's health monitor (``obs/health.py``) held against the JAX
package's on the CPU.

- ``install`` appends the JAX monitor's ops after ``minimize``: the same
  op list, names and fingerprint on fit_a_line and the MNIST MLP at
  784-32-16-10, with and without a learning-rate variable.
- The per-step health vectors of the two Trainers (the port's from the
  JAX startup's state) over 6 steps at K = 1 and in ``[K, 3]`` groups
  of 3: rtol 1e-5, atol 1e-7; the costs at 1e-5.
- ``check``'s policy (warn, raise, none) on the same vectors gives the
  JAX monitor's ``last``, trips, messages and telemetry records;
  ``ensure``'s contract is JAX's.
"""
import warnings

import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu.core import scope as jscope
from paddle_tpu.framework import program as jprog
from paddle_tpu.obs import health as jhealth
from paddle_tpu.trainer import Trainer as JTrainer

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.obs import health as thealth
from paddle_tpu_torch.trainer import Trainer

SIDES = {"jax": (jpt, jprog, jscope, JTrainer, jhealth),
         "torch": (pt, tprog, tscope, Trainer, thealth)}


@pytest.fixture(autouse=True)
def clean_state():
    for side in SIDES.values():
        side[1].fresh_programs()
        side[2].reset_global_scope()
    yield
    for side in SIDES.values():
        side[1].fresh_programs()
        side[2].reset_global_scope()


def _fit_a_line(side):
    pkg = SIDES[side][0]
    x = pkg.layers.data("x", [13])
    y = pkg.layers.data("y", [1])
    loss = pkg.layers.mean(pkg.layers.square_error_cost(
        pkg.layers.fc(x, 1), y))
    return loss, pkg.optimizer.SGD(0.01), [x, y]


def _mlp(side):
    pkg = SIDES[side][0]
    img = pkg.layers.data("img", [784])
    label = pkg.layers.data("label", [1], dtype="int64")
    h = pkg.layers.fc(pkg.layers.fc(img, 32, act="relu"), 16, act="relu")
    loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
        pkg.layers.fc(h, 10), label))
    return loss, pkg.optimizer.Adam(0.01), [img, label]


def _fit_data():
    rng = np.random.RandomState(0)
    return [(rng.randn(13).astype(np.float32),
             rng.randn(1).astype(np.float32)) for _ in range(6 * 8)]


def _mlp_data():
    rng = np.random.RandomState(1)
    return [(rng.rand(784).astype(np.float32), int(rng.randint(10)))
            for _ in range(6 * 8)]


MODELS = {"fit_a_line": (_fit_a_line, _fit_data),
          "mlp": (_mlp, _mlp_data)}


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("with_lr", [True, False])
def test_install_appends_the_jax_ops(name, with_lr):
    got = {}
    for side in SIDES:
        build = MODELS[name][0]
        loss, opt, _ = build(side)
        _, pg = opt.minimize(loss)
        mon = SIDES[side][4].HealthMonitor("none")
        var = mon.install(loss.block, pg,
                          opt._lr_var if with_lr else None)
        main = SIDES[side][0].default_main_program()
        got[side] = ([(o.type, o.inputs, o.outputs, o.attrs)
                      for o in main.global_block().ops], var.name,
                     tuple(var.shape), main.fingerprint())
    assert got["torch"] == got["jax"]
    with pytest.raises(ValueError, match="non-empty"):
        thealth.HealthMonitor().install(None, [])


def _trainers(name):
    """Both Trainers with ``health="none"`` and a recording ``check``,
    the port's from the JAX startup's state."""
    vectors = {"jax": [], "torch": []}
    out = {}
    for side in ("jax", "torch"):
        pkg, _, _, trainer_cls, _ = SIDES[side]
        loss, opt, feeds = MODELS[name][0](side)
        tr = trainer_cls(cost=loss, optimizer=opt, feed_list=feeds,
                         place=pkg.CPUPlace(), health="none")
        orig = tr.health.check

        def rec(values, telemetry=None, step=None, _o=orig, _s=side):
            vectors[_s].append(np.asarray(values, np.float64)
                               .reshape(-1, 3))
            return _o(values, telemetry=telemetry, step=step)
        tr.health.check = rec
        if side == "jax":
            tr._init_params()
            state = {n: np.array(jscope.global_scope().find_var(n).array)
                     for n, v in tr.main_program.global_block().vars.items()
                     if v.persistable
                     and jscope.global_scope().find_var(n) is not None}
        else:
            scope_from_jax(state, device="cpu")
            tr._initialized = True
        out[side] = tr
    return out, vectors


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("k", [1, 3])
def test_health_vectors_match_jax(name, k):
    trainers, vectors = _trainers(name)
    data = MODELS[name][1]()
    costs = {}
    for side, tr in trainers.items():
        costs[side] = []
        tr.train(SIDES[side][0].reader.batch(lambda: iter(data), 8),
                 steps_per_call=k, log_period=0,
                 event_handler=lambda e, _c=costs[side]: _c.append(e.cost)
                 if hasattr(e, "cost") else None)
    got, want = np.concatenate(vectors["torch"]), np.concatenate(
        vectors["jax"])
    assert [v.shape for v in vectors["torch"]] == [
        v.shape for v in vectors["jax"]] == [(k, 3)] * (6 // k)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert np.all(got[:, 2] == 1.0) and np.all(got[:, 0] > 0)
    np.testing.assert_allclose(costs["torch"], costs["jax"], rtol=1e-5,
                               atol=1e-5)
    assert (trainers["torch"].health.last.keys()
            == trainers["jax"].health.last.keys())


def _policy_vectors():
    return [np.array([1.5, 0.01, 1.0], np.float32),
            np.array([[2.0, 0.02, 1.0], [np.nan, np.nan, 0.0],
                      [np.inf, 0.5, 0.0]], np.float32),
            np.array([3.0, 0.03, 1.0], np.float32)]


class _Tel:
    """The two hooks ``check`` calls on a session, recorded."""

    def __init__(self):
        self.records = []
        self.tracer = self

    def record_health(self, gn, ratio, n_bad=0):
        self.records.append(("health", gn, ratio, n_bad))

    def event(self, name, **kw):
        self.records.append((name, kw))


@pytest.mark.parametrize("action", ["warn", "raise", "none"])
def test_check_policy_matches_jax(action):
    out = {}
    for side in SIDES:
        mon = SIDES[side][4].HealthMonitor(action)
        tel = _Tel()
        rows = []
        for i, v in enumerate(_policy_vectors()):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                try:
                    last = mon.check(v, telemetry=tel, step=i + 10)
                    err = None
                except FloatingPointError as e:
                    last, err = None, str(e)
            rows.append((last, err, [str(x.message) for x in w
                                     if x.category is RuntimeWarning]))
        out[side] = (rows, mon.trips, repr(mon.last), repr(tel.records))
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == 2


def test_ensure_contract_matches_jax():
    for mod in (thealth, jhealth):
        cls = mod.HealthMonitor
        assert cls.ensure(None) is None and cls.ensure(False) is None
        assert cls.ensure(True).action == "warn"
        assert cls.ensure("raise").action == "raise"
        mon = cls("none")
        assert cls.ensure(mon) is mon
        with pytest.raises(TypeError, match="health="):
            cls.ensure(3)
        with pytest.raises(ValueError, match="health action"):
            cls("loud")
