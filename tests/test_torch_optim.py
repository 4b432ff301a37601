"""The port's training plane (the rest of the optimizers, the learning-rate
schedules, global-norm clipping, weight decay and ``ModelAverage``) held
against the JAX package's on the CPU.

- Op parity: every op of the JAX package's ``ops/optimizer_ops.py`` the
  port did not have (adamax, adagrad, decayed_adagrad, adadelta, rmsprop,
  ftrl, proximal_gd, proximal_adagrad, lr_schedule, ema_update,
  magnitude_prune_mask, apply_mask) and the helpers the clip, the decay
  and the schedules append (sign, assign, increment, sqrt,
  elementwise_max, squared_l2_norm): one op of each package on the same
  numpy-seeded inputs, every output within 1e-6 of the JAX output's
  largest magnitude (1e-5 where a sqrt or a power sits: the two
  libraries' sqrt / pow may round an ulp apart, and an update divides
  by them); ``lr_schedule`` within 1 ulp of the JAX op inside
  ``jax.jit``, as the JAX Executor runs it (XLA folds its constants
  and fuses its products and sums; the eager op rounds otherwise, by
  up to 44 ulps over 300 steps of an exponential decay). Edge cases:
  Ftrl with l1 > 0 zeroing weights, ``proximal_adagrad`` on a zero gradient over a zero
  moment (the JAX op's 1e-12 guard), ``polynomial_decay`` with
  ``cycle``, ``piecewise_decay`` exactly on a boundary, the pruning
  mask's ratios 0 / 1 and its ties. Each registration (slots,
  attribute defaults, flags) equals the JAX package's.
- Schedules through ``minimize``: a small regression net with
  ``SGD(schedule)`` for every strategy, from the JAX startup's state
  (``convert.scope_from_jax``), 12 steps: the fetched learning rate
  within 1 ulp of JAX's at every step, the losses at 1e-5;
  ``run_multi`` at K = 4 bit-equal to 4 runs (the lr, the global step,
  the parameters).
- Clip and decay: ``global_clip_norm=`` with the global norm above and
  below ``clip_norm`` (the clipped gradients, the norm, the losses and
  the parameters after 3 steps against JAX's at 1e-5), L1 and L2 decay
  through ``ParamAttr`` (the op list and 3 steps), and
  ``regularization=`` accepted and ignored as in the JAX package
  (ROADMAP C5: the op list is JAX's, with no decay op).
- ``ModelAverage``: the shadows after 4 Adam steps, the weights inside
  ``apply()`` and a loss evaluated there against JAX's; the restore
  puts back the very tensors that were live.
- Update hooks raise naming ROADMAP A8 before any decay, clip or
  update op is appended.
- Every public name of the JAX package's ``optimizer``,
  ``lr_scheduler``, ``clip``, ``regularizer``, ``reader.provider`` and
  thirteen datasets exists in the port's module of the same name.
"""
import contextlib
import importlib
import inspect
import re

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core import scope as jscope
from paddle_tpu.framework import program as jprog
from paddle_tpu.framework import registry as jreg

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.framework import registry as treg

TOL = 1e-5
OP_TOL = 1e-6
ROOT_TOL = 1e-5       # a sqrt or a power on the path
SIDES = {"jax": (jpt, jprog, jscope), "torch": (pt, tprog, tscope)}


@pytest.fixture(autouse=True)
def clean_state():
    for pkg, mod, scope in SIDES.values():
        mod.fresh_programs()
        scope.reset_global_scope()
    yield
    for pkg, mod, scope in SIDES.values():
        mod.fresh_programs()
        scope.reset_global_scope()


# ------------------------------------------------------------ op parity

def _compute(reg, op, ins, attrs, to):
    info = reg.get_op_info(op)
    full = dict(info.attrs, **attrs)
    args = {s: [to(a) for a in (v if isinstance(v, list) else [v])]
            for s, v in ins.items()}
    outs = info.compute(args, full, reg.OpContext(attrs=full))
    return {k: [np.asarray(x.numpy() if torch.is_tensor(x) else x)
                for x in (v if isinstance(v, (list, tuple)) else [v])]
            for k, v in outs.items()}


def _both(op, ins, attrs=None):
    import jax.numpy as jnp
    want = _compute(jreg, op, ins, attrs or {}, jnp.asarray)
    got = _compute(treg, op, ins, attrs or {},
                   lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    return got, want


def _rand(r, *shape, scale=1.0):
    return (r.randn(*shape) * scale).astype(np.float32)


def _pos(r, *shape):
    return (r.rand(*shape) + 0.1).astype(np.float32)


def _lr(v=0.05):
    return np.array([v], np.float32)


def _op_cases():
    r = np.random.RandomState(0)
    p, g = _rand(r, 6, 5), _rand(r, 6, 5)
    signed = p.copy()
    signed[0, :2] = 0.0
    g_zero = g.copy()
    g_zero[1] = 0.0
    m_zero = _pos(r, 6, 5)
    m_zero[1] = 0.0
    # Ftrl with l1 = 0.5: rows whose linear accumulator ends within l1
    # of 0 are zeroed
    lin = _rand(r, 6, 5, scale=0.5)
    return {
        "sign": ("sign", {"X": signed}, {}, OP_TOL),
        "assign": ("assign", {"X": p}, {}, OP_TOL),
        "increment": ("increment", {"X": np.array([3.0], np.float32)},
                      {"step": 2.0}, OP_TOL),
        "increment_int": ("increment", {"X": np.array([7], np.int32)},
                          {"step": 1.0}, OP_TOL),
        "elementwise_max": ("elementwise_max", {"X": p, "Y": g}, {},
                            OP_TOL),
        "elementwise_max_bcast": ("elementwise_max",
                                  {"X": np.array([0.3], np.float32),
                                   "Y": np.array([5.0], np.float32)}, {},
                                  OP_TOL),
        "sqrt": ("sqrt", {"X": _pos(r, 6, 5)}, {}, ROOT_TOL),
        "squared_l2_norm": ("squared_l2_norm", {"X": p}, {}, OP_TOL),
        "adamax": ("adamax", {
            "Param": p, "Grad": g, "LearningRate": _lr(),
            "Moment": _rand(r, 6, 5, scale=0.1), "InfNorm": _pos(r, 6, 5),
            "Beta1Pow": np.array([0.9 ** 3], np.float32)},
            {"beta1": 0.9, "beta2": 0.99, "epsilon": 1e-8}, OP_TOL),
        "adagrad": ("adagrad", {"Param": p, "Grad": g, "Moment": _pos(
            r, 6, 5), "LearningRate": _lr()}, {"epsilon": 1e-6}, ROOT_TOL),
        "decayed_adagrad": ("decayed_adagrad", {
            "Param": p, "Grad": g, "Moment": _pos(r, 6, 5),
            "LearningRate": _lr()}, {"decay": 0.9, "epsilon": 1e-6},
            ROOT_TOL),
        "adadelta": ("adadelta", {
            "Param": p, "Grad": g, "AvgSquaredGrad": _pos(r, 6, 5),
            "AvgSquaredUpdate": _pos(r, 6, 5)},
            {"rho": 0.9, "epsilon": 1e-6}, ROOT_TOL),
        "rmsprop": ("rmsprop", {
            "Param": p, "Grad": g, "MeanSquare": _pos(r, 6, 5),
            "Moment": _rand(r, 6, 5, scale=0.1), "LearningRate": _lr()},
            {"decay": 0.9, "momentum": 0.5, "epsilon": 1e-10}, ROOT_TOL),
        "ftrl": ("ftrl", {
            "Param": p, "Grad": g, "SquaredAccumulator": _pos(r, 6, 5),
            "LinearAccumulator": lin, "LearningRate": _lr()},
            {"l1": 0.0, "l2": 0.1, "lr_power": -0.5}, ROOT_TOL),
        "ftrl_l1_zeroes": ("ftrl", {
            "Param": p, "Grad": g, "SquaredAccumulator": _pos(r, 6, 5),
            "LinearAccumulator": lin, "LearningRate": _lr()},
            {"l1": 0.5, "l2": 0.1, "lr_power": -0.5}, ROOT_TOL),
        "ftrl_first_step": ("ftrl", {
            "Param": p, "Grad": g,
            "SquaredAccumulator": np.zeros((6, 5), np.float32),
            "LinearAccumulator": np.zeros((6, 5), np.float32),
            "LearningRate": _lr()},
            {"l1": 0.01, "l2": 0.0, "lr_power": -0.5}, ROOT_TOL),
        "proximal_gd": ("proximal_gd", {"Param": p, "Grad": g,
                                        "LearningRate": _lr(0.5)},
                        {"l1": 0.3, "l2": 0.05}, OP_TOL),
        "proximal_adagrad": ("proximal_adagrad", {
            "Param": p, "Grad": g, "Moment": _pos(r, 6, 5),
            "LearningRate": _lr(0.5)}, {"l1": 0.1, "l2": 0.05}, ROOT_TOL),
        "proximal_adagrad_zero": ("proximal_adagrad", {
            "Param": p, "Grad": g_zero, "Moment": m_zero,
            "LearningRate": _lr(0.5)}, {"l1": 0.1, "l2": 0.05}, ROOT_TOL),
        "ema_update": ("ema_update", {"Param": p, "Avg": g},
                       {"decay": 0.99}, OP_TOL),
        "magnitude_prune_mask": ("magnitude_prune_mask", {"Param": p},
                                 {"sparsity_ratio": 0.6}, OP_TOL),
        "magnitude_prune_mask_none": ("magnitude_prune_mask", {"Param": p},
                                      {"sparsity_ratio": 0.0}, OP_TOL),
        "magnitude_prune_mask_all": ("magnitude_prune_mask", {"Param": p},
                                     {"sparsity_ratio": 1.0}, OP_TOL),
        "magnitude_prune_mask_ties": ("magnitude_prune_mask", {
            "Param": np.where(r.rand(6, 5) > 0.5, 0.5, -0.5).astype(
                np.float32)}, {"sparsity_ratio": 0.5}, OP_TOL),
        "apply_mask": ("apply_mask", {"Param": p, "Mask": (
            r.rand(6, 5) > 0.4).astype(np.float32)}, {}, OP_TOL),
    }


OP_CASES = _op_cases()


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(scale, 1e-30), err_msg=what)


@pytest.mark.parametrize("case", list(OP_CASES))
def test_op_matches_jax(case):
    op, ins, attrs, tol = OP_CASES[case]
    got, want = _both(op, ins, attrs)
    assert set(got) == set(want)
    for slot in want:
        for a, b in zip(got[slot], want[slot]):
            _close(a, b, tol, f"{case} {slot}")
    if case == "ftrl_l1_zeroes":
        zeroed = got["ParamOut"][0] == 0
        assert 0 < zeroed.sum() < zeroed.size
        assert (want["ParamOut"][0][zeroed] == 0).all()
    if case == "proximal_adagrad_zero":
        assert np.isfinite(got["ParamOut"][0]).all()
    if case == "magnitude_prune_mask_ties":
        assert got["Mask"][0].all()          # ties with the threshold stay


def _ulps(a, b):
    """ulps between two arrays of positive float32 values."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


# strategy name -> the schedule's op attributes (the scheduler classes'
# op_attrs) and the schedule through both packages' lr_scheduler
SCHEDULES = {
    "exponential": lambda m: m.ExponentialDecay(0.1, 3, 0.5),
    "exponential_staircase": lambda m: m.ExponentialDecay(
        0.1, 3, 0.5, staircase=True),
    "natural_exp": lambda m: m.NaturalExpDecay(0.1, 4, 0.3),
    "natural_exp_staircase": lambda m: m.NaturalExpDecay(
        0.1, 4, 0.3, staircase=True),
    "inverse_time": lambda m: m.InverseTimeDecay(0.1, 2, 0.7),
    "inverse_time_staircase": lambda m: m.InverseTimeDecay(
        0.1, 2, 0.7, staircase=True),
    "polynomial": lambda m: m.PolynomialDecay(0.1, 8, end_lr=0.001,
                                              power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(
        0.1, 5, end_lr=0.001, power=1.5, cycle=True),
    "piecewise": lambda m: m.PiecewiseDecay([3, 7], [0.1, 0.05, 0.01]),
    "manual": lambda m: m.ManualLR([2, 4], [0.1, 0.03, 0.01]),
    "linear": lambda m: m.LinearDecay(0.1, 0.008, end_lr=0.02),
}
STEPS = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 7.0, 10.0, 11.0, 15.0, 37.0]


def _jitted_lr(attrs):
    """The JAX op as the JAX Executor runs it: inside a jitted step."""
    import jax
    info = jreg.get_op_info("lr_schedule")
    full = dict(info.attrs, **attrs)
    return jax.jit(lambda s: info.compute({"Step": [s]}, full, None)["Out"])


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedule_op_within_one_ulp_of_jax(name):
    attrs = SCHEDULES[name](pt.lr_scheduler).op_attrs()
    assert attrs == SCHEDULES[name](jpt.lr_scheduler).op_attrs()
    jitted = _jitted_lr(attrs)
    for step in STEPS:   # 3.0 and 7.0 lie on the piecewise boundaries
        x = np.array([step], np.float32)
        g = _compute(treg, "lr_schedule", {"Step": x}, attrs,
                     torch.from_numpy)["Out"][0]
        w = np.asarray(jitted(x))
        assert g.dtype == w.dtype == np.float32 and g.shape == (1,)
        assert _ulps(g, w).max() <= 1, (name, step, g, w)
    if name == "piecewise":
        for step, want in ((2.0, 0.1), (3.0, 0.05), (6.0, 0.05),
                           (7.0, 0.01)):
            got, _ = _both("lr_schedule",
                           {"Step": np.array([step], np.float32)}, attrs)
            assert got["Out"][0][0] == np.float32(want), step


PARITY_OPS = ["sign", "assign", "increment", "sqrt", "elementwise_max",
              "squared_l2_norm"]


def test_registrations_match_jax():
    """Every op of the JAX package's ``ops/optimizer_ops.py`` and the six
    helpers are registered in the port with JAX's slots, attributes and
    flags."""
    opt_ops = sorted(n for n in jreg.registered_ops()
                     if jreg.get_op_info(n).compute.__module__
                     == "paddle_tpu.ops.optimizer_ops")
    assert len(opt_ops) == 15, opt_ops
    for op in opt_ops + PARITY_OPS:
        j, t = jreg.get_op_info(op), treg.get_op_info(op)
        assert (tuple(t.inputs), tuple(t.outputs), t.attrs,
                tuple(t.optional_inputs), t.amp_compute, t.needs_rng) == (
            tuple(j.inputs), tuple(j.outputs), j.attrs,
            tuple(j.optional_inputs), j.amp_compute, j.needs_rng), op
    tested = {c[0] for c in OP_CASES.values()} | {"lr_schedule"}
    assert set(opt_ops + PARITY_OPS) - {"sgd", "momentum", "adam"} == tested


# ------------------------------------------------- programs: both sides

@contextlib.contextmanager
def fresh(side):
    pkg, mod, _ = SIDES[side]
    saved = dict(mod._name_counters)
    mod._name_counters.clear()
    main, start = mod.Program(), mod.Program()
    try:
        with pkg.program_guard(main, start):
            yield main, start
    finally:
        mod._name_counters.clear()
        mod._name_counters.update(saved)


def _regression(pkg, opt):
    x = pkg.layers.data("x", [4])
    y = pkg.layers.data("y", [1])
    loss = pkg.layers.mean(pkg.layers.square_error_cost(
        pkg.layers.fc(x, 1), y))
    opt.minimize(loss)
    return loss


def _reg_feeds(n, seed=0):
    r = np.random.RandomState(seed)
    w = r.randn(4, 1).astype(np.float32)
    out = []
    for _ in range(n):
        x = r.randn(8, 4).astype(np.float32)
        out.append({"x": x, "y": (x @ w + 0.1 * r.randn(8, 1)).astype(
            np.float32)})
    return out


def _classifier(pkg, opt, param_attrs=(None, None)):
    x = pkg.layers.data("x", [8])
    label = pkg.layers.data("label", [1], dtype="int64")
    h = pkg.layers.fc(x, 16, act="relu", param_attr=param_attrs[0])
    logits = pkg.layers.fc(h, 3, param_attr=param_attrs[1])
    loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
        logits, label))
    if opt is not None:
        opt.minimize(loss)
    return loss


def _cls_feeds(n, seed=0, scale=1.0):
    r = np.random.RandomState(seed)
    return [{"x": (r.randn(8, 8) * scale).astype(np.float32),
             "label": r.randint(0, 3, (8, 1)).astype(np.int64)}
            for _ in range(n)]


def _persistables(main, scope, to_np):
    return {n: to_np(scope.find_var(n).array)
            for n, v in main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _run_both(build, feeds, fetch):
    """``build(pkg)`` in fresh programs of each package; JAX's startup in
    a JAX scope, carried to the port's; then ``feeds`` through both
    Executors on the CPU. Returns, for each side, (the fetches of every
    step as numpy, the persistables after, main, scope), the fetch names
    from ``fetch(main, built)``."""
    out = {}
    init = None
    for side in ("jax", "torch"):
        pkg, mod, scope_mod = SIDES[side]
        with fresh(side) as (main, start):
            built = build(pkg)
        names = fetch(main, built)
        if side == "jax":
            scope = scope_mod.Scope()
            exe = pkg.Executor(pkg.CPUPlace())
            exe.run(start, scope=scope)
            init = _persistables(main, scope, np.array)
        else:
            scope = scope_from_jax(init, scope_mod.Scope(), device="cpu")
            exe = pkg.Executor(pkg.CPUPlace())
        got = [[np.asarray(v) for v in exe.run(main, feed=f,
                                              fetch_list=names,
                                              scope=scope)]
               for f in feeds]
        to_np = np.array if side == "jax" else (lambda t: t.numpy())
        out[side] = (got, _persistables(main, scope, to_np), main, scope)
    return out


def _lr_name(main):
    return next(n for n in main.global_block().vars
                if n.startswith("learning_rate"))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_through_minimize_matches_jax(name):
    def build(pkg):
        return _regression(pkg, pkg.optimizer.SGD(
            SCHEDULES[name](pkg.lr_scheduler)))

    def fetch(main, loss):
        return [loss.name, _lr_name(main)]

    res = _run_both(build, _reg_feeds(12), fetch)
    (j_steps, j_after, j_main, _), (t_steps, t_after, t_main, _) = (
        res["jax"], res["torch"])
    assert [(o.type, o.attrs) for o in t_main.global_block().ops] == [
        (o.type, o.attrs) for o in j_main.global_block().ops]
    for i, (got, want) in enumerate(zip(t_steps, j_steps)):
        assert _ulps(got[1], want[1]).max() <= 1, (name, i, got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=TOL)
    assert sorted(t_after) == sorted(j_after)
    step = next(n for n in t_after if n.startswith("global_step"))
    assert t_after[step].tolist() == j_after[step].tolist() == [12.0]
    for n, v in t_after.items():
        np.testing.assert_allclose(v, j_after[n], atol=TOL, rtol=TOL,
                                   err_msg=n)


def test_schedule_run_multi_equals_k_runs():
    with fresh("torch") as (main, start):
        loss = _regression(pt, pt.optimizer.Adagrad(
            pt.lr_scheduler.PolynomialDecay(0.1, 5, end_lr=0.01, power=1.5,
                                            cycle=True)))
    lr = _lr_name(main)
    a, b = tscope.Scope(), tscope.Scope()
    start.random_seed = 1
    pt.Executor(pt.CPUPlace()).run(start, scope=a)
    for n in a.local_var_names():
        b.set_tensor(n, a.find_var(n).array.clone())
    feeds = _reg_feeds(8, seed=2)
    ea, eb = pt.Executor(pt.CPUPlace()), pt.Executor(pt.CPUPlace())
    one = [ea.run(main, feed=f, fetch_list=[loss, lr], scope=a)
           for f in feeds]
    multi = [eb.run_multi(main, feeds[i:i + 4], fetch_list=[loss, lr],
                          scope=b) for i in (0, 4)]
    for k, m in enumerate(multi):
        for j in range(2):
            np.testing.assert_array_equal(
                m[j], np.stack([o[j] for o in one[4 * k:4 * k + 4]]))
    for n in a.local_var_names():
        assert torch.equal(a.find_var(n).array, b.find_var(n).array), n
    step = next(n for n in a.local_var_names() if n.startswith("global_step"))
    assert b.find_var(step).array.tolist() == [8.0]


def _grad_names(main):
    return [p.name + "@GRAD" for p in main.global_block().all_parameters()]


@pytest.mark.parametrize("where", ["above", "below"])
def test_global_norm_clip_matches_jax(where):
    clip = 0.05 if where == "above" else 1e3

    def build(pkg):
        return _classifier(pkg, pkg.optimizer.SGD(0.1,
                                                  global_clip_norm=clip))

    def fetch(main, loss):
        norm = next(n for n in main.global_block().vars
                    if re.fullmatch(r"global_norm_\d+", n))
        return [loss.name, norm] + _grad_names(main)

    res = _run_both(build, _cls_feeds(3), fetch)
    (j_steps, j_after, j_main, _), (t_steps, t_after, t_main, _) = (
        res["jax"], res["torch"])
    types = [o.type for o in t_main.global_block().ops]
    assert types == [o.type for o in j_main.global_block().ops]
    assert types.count("squared_l2_norm") == 4
    for got, want in zip(t_steps, j_steps):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
        norm = float(got[1][0])
        clipped = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                              for g in got[2:]))
        if where == "above":
            assert norm > clip
            np.testing.assert_allclose(clipped, clip, rtol=1e-5)
        else:
            assert norm < clip
            np.testing.assert_allclose(clipped, norm, rtol=1e-5)
    for n, v in t_after.items():
        np.testing.assert_allclose(v, j_after[n], atol=TOL, rtol=TOL,
                                   err_msg=n)


def test_l1_l2_decay_through_param_attr_matches_jax():
    def build(pkg):
        attrs = (pkg.ParamAttr(regularizer=pkg.regularizer.L2Decay(0.05)),
                 pkg.ParamAttr(regularizer=pkg.regularizer.L1Decay(0.02)))
        return _classifier(pkg, pkg.optimizer.Momentum(0.1, 0.9), attrs)

    def fetch(main, loss):
        return [loss.name] + _grad_names(main)

    res = _run_both(build, _cls_feeds(3, seed=1), fetch)
    (j_steps, j_after, j_main, _), (t_steps, t_after, t_main, _) = (
        res["jax"], res["torch"])
    ops = [(o.type, o.inputs, o.outputs, o.attrs)
           for o in t_main.global_block().ops]
    assert ops == [(o.type, o.inputs, o.outputs, o.attrs)
                   for o in j_main.global_block().ops]
    types = [o[0] for o in ops]
    assert types.count("scale") == 2 and types.count("sign") == 1
    assert types.count("sum") == 2
    for got, want in zip(t_steps, j_steps):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    for n, v in t_after.items():
        np.testing.assert_allclose(v, j_after[n], atol=TOL, rtol=TOL,
                                   err_msg=n)


def test_regularization_argument_is_ignored_as_in_jax():
    """ROADMAP C5: the JAX ``Optimizer`` keeps ``regularization=`` and
    never uses it; the port does the same."""
    lists = {}
    for side in ("jax", "torch"):
        pkg = SIDES[side][0]
        with fresh(side) as (main, _):
            x = pkg.layers.data("x", [4])
            label = pkg.layers.data("label", [1], dtype="int64")
            loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
                pkg.layers.fc(x, 3), label))
            opt = pkg.optimizer.SGD(0.1, regularization=(
                pkg.regularizer.L2Decay(0.5)))
            opt.minimize(loss)
        assert isinstance(opt.regularization, pkg.regularizer.L2Decay)
        lists[side] = [(o.type, o.inputs, o.outputs, o.attrs)
                       for o in main.global_block().ops]
    assert lists["torch"] == lists["jax"]
    assert [o[0] for o in lists["torch"]] == [
        "mul", "elementwise_add", "softmax_with_cross_entropy", "mean",
        "backward", "sgd", "sgd"]


def test_update_hooks_raise_naming_a8_before_any_update_op():
    """Per-parameter update hooks are ``param_hooks.py``'s (ROADMAP A8):
    ``minimize`` raises before it appends a decay, clip or update op."""
    with fresh("torch") as (main, _):
        x = pt.layers.data("x", [4])
        attr = pt.ParamAttr(update_hooks=[object()],
                            regularizer=pt.regularizer.L2Decay(0.1))
        loss = pt.layers.mean(pt.layers.fc(x, 2, param_attr=attr))
        with pytest.raises(NotImplementedError, match="A8"):
            pt.optimizer.SGD(0.1, global_clip_norm=1.0).minimize(loss)
    assert [op.type for op in main.global_block().ops][-1] == "backward"


def test_model_average_matches_jax():
    feeds = _cls_feeds(5, seed=2)
    res = {}
    for side in ("jax", "torch"):
        pkg, mod, scope_mod = SIDES[side]
        mod.fresh_programs()
        scope_mod.reset_global_scope()
        loss = _classifier(pkg, None)
        test = mod.default_main_program().clone(for_test=True)
        pkg.optimizer.Adam(0.05).minimize(loss)
        ma = pkg.optimizer.ModelAverage(0.7)
        main = mod.default_main_program()
        exe = pkg.Executor(pkg.CPUPlace())
        scope = scope_mod.global_scope()
        if side == "jax":
            exe.run(mod.default_startup_program())
            init = _persistables(main, scope, np.array)
        else:
            scope_from_jax(init, device="cpu")
        losses = [float(np.asarray(exe.run(main, feed=f,
                                           fetch_list=[loss])[0]))
                  for f in feeds[:4]]
        to_np = np.array if side == "jax" else (lambda t: t.numpy())
        shadows = {a: to_np(scope.find_var(a).array) for _, a in ma._pairs}
        live = {p: scope.find_var(p).array for p, _ in ma._pairs}
        with ma.apply():
            inside = {p: to_np(scope.find_var(p).array)
                      for p, _ in ma._pairs}
            avg_loss = float(np.asarray(exe.run(test, feed=feeds[4],
                                                fetch_list=[loss])[0]))
        after = {p: scope.find_var(p).array for p, _ in ma._pairs}
        res[side] = (ma, losses, shadows, inside, avg_loss, live, after)
    jma, j_losses, j_shadows, j_inside, j_avg, _, _ = res["jax"]
    tma, losses, shadows, inside, avg_loss, live, after = res["torch"]
    assert tma._pairs == jma._pairs and len(tma._pairs) == 4
    np.testing.assert_allclose(losses, j_losses, atol=TOL, rtol=TOL)
    for a, v in shadows.items():
        np.testing.assert_allclose(v, j_shadows[a], atol=TOL, rtol=TOL,
                                   err_msg=a)
    for (p, a) in tma._pairs:
        np.testing.assert_array_equal(inside[p], shadows[a])
        np.testing.assert_allclose(inside[p], j_inside[p], atol=TOL,
                                   rtol=TOL)
        assert after[p] is live[p]         # the live tensors, restored
    np.testing.assert_allclose(avg_loss, j_avg, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="decay"):
        pt.optimizer.ModelAverage(1.0)


A3_MODULES = ["optimizer", "lr_scheduler", "clip", "regularizer",
              "reader.provider"] + [
    f"datasets.{n}" for n in (
        "common", "mnist", "cifar", "uci_housing", "imdb", "imikolov",
        "movielens", "wmt14", "ctr", "conll05", "sentiment", "flowers",
        "voc2012", "mq2007")]


def _public_names(mod):
    """``__all__`` and every public function, class and constant the
    module itself defines."""
    names = set(getattr(mod, "__all__", ()))
    for name, value in vars(mod).items():
        if name.startswith("_") or name == "annotations" or \
                inspect.ismodule(value):
            continue
        if (inspect.isfunction(value) or inspect.isclass(value)) and \
                value.__module__ != mod.__name__:
            continue
        names.add(name)
    return names


@pytest.mark.parametrize("name", A3_MODULES)
def test_every_jax_name_exists_in_the_port(name):
    jmod = importlib.import_module(f"paddle_tpu.{name}")
    tmod = importlib.import_module(f"paddle_tpu_torch.{name}")
    assert _public_names(jmod) <= _public_names(tmod)
