"""The port's eager ``Executor`` held against the JAX package's on the
CPU.

The MNIST MLP (``models.mnist.mlp`` at bench.py's widths 784-128-64-10,
batch 16, seeded features with a class signal) is built through both
packages in fresh programs, with ``Adam(0.01)`` and with ``SGD(0.1)``.
The JAX startup program runs in a JAX scope and its persistables are
carried over with ``convert.scope_from_jax`` (a JAX PRNG stream is not a
torch one). Then the same 5 steps go through ``Executor(CPUPlace())``
on both sides:

- fp32: the first step's fetches (loss, prediction, accuracy and every
  ``@GRAD`` variable), each later step's loss, and every persistable
  after the fifth step (parameters, learning rate, Adam's moments and
  powers), atol/rtol 1e-5 (the tolerance ``tests/test_torch_text.py``
  holds fp32 training to: the same fp32 math, sums in another order),
  except Adam's parameter elements whose first nonzero gradient lies in
  its eps regime (ADAM_EPS_REGIME below), held to 1e-4;
- AMP (``amp=True``: the ``mul`` ops in bf16 over fp32 masters): every
  step's loss within ``tests/test_torch_text.py``'s AMP_LOSS_TOL 2e-3.

Port-internal: ``run_multi(K=4)`` against 4 ``run``s (losses, parameters
and moments bit-equal, the step counter continued, the stacked form),
``clone(for_test=True)``, ``prepare_infer``, the op-aware error note, the
startup program's random ops against their initializers' bounds, mean
and std from an explicit seed, the card as the default place, and each
deferred option raising with its ROADMAP item. Last, the text
classifier as a Program (``models.text.build_program``: vocab 50, emb
16, hidden 32, 2 layers) trained 3 Adam steps through the Executor
against ``text.make_train_step(cfg, "adam", 0.002)`` from the same
parameters, fused at uniform lengths, on ragged LoD and with runtime
``seq_lens`` over a uniform LoD: losses,
accuracies and parameters atol/rtol 1e-5 (the same ops on the same
tensors; the updates' arithmetic in another order).
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.datasets import mnist as jmnist_data
from paddle_tpu.framework import program as jprog
from paddle_tpu.models import mnist as jmnist

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.core.lod import LoD, LoDTensor
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.framework import executor as texe
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import text as tx

TOL = 1e-5
AMP_LOSS_TOL = 2e-3
# Adam's first update of an element (its moments still 0) is lr * g /
# (|g| + eps / sqrt(1 - beta2^t)), eps / sqrt(1 - beta2) = 3.2e-7: where
# that first nonzero gradient is a near-cancelled sum, |g| < 1e-6, the
# ~2e-9 its rounding differs by between two fp32 summation orders moves
# the update by up to lr * 2e-9 / 3.2e-7 = 6e-5 at lr 0.01. Such elements
# (under 1 % of a matrix) are held to 1e-4; every other element of every
# persistable to TOL.
ADAM_EPS_REGIME = 1e-6
ADAM_EPS_REGIME_TOL = 1e-4
B, STEPS = 16, 5
OPTS = {"adam": lambda m: m.optimizer.Adam(0.01),
        "sgd": lambda m: m.optimizer.SGD(0.1)}


@contextlib.contextmanager
def fresh(mod):
    """New main and startup programs of ``mod``'s package under
    ``program_guard``, its name counters cleared for the build and
    restored after."""
    saved = dict(mod._name_counters)
    mod._name_counters.clear()
    main, start = mod.Program(), mod.Program()
    guard = (jpt if mod is jprog else pt).program_guard
    try:
        with guard(main, start):
            yield main, start
    finally:
        mod._name_counters.clear()
        mod._name_counters.update(saved)


def build(side, opt, dim=784):
    """The MLP through one package: (main, startup, [prediction, loss,
    accuracy], names of the @GRAD variables)."""
    pkg, mod, models = ((jpt, jprog, jmnist) if side == "jax"
                        else (pt, tprog, tmnist))
    with fresh(mod) as (main, start):
        img = pkg.layers.data("img", [dim])
        label = pkg.layers.data("label", [1], dtype="int64")
        outs = list(models.mlp(img, label))
        if opt is not None:
            OPTS[opt](pkg).minimize(outs[1])
    grads = [p.name + "@GRAD" for p in main.global_block().all_parameters()]
    return main, start, outs, grads


def feeds(n=STEPS, dim=784):
    """Batches of ``datasets/mnist.py``'s synthetic surrogate (the
    reader nothing is downloaded for: class prototypes plus noise,
    clipped to [-1, 1]), its first ``dim`` pixels."""
    reader = jmnist_data.train()()
    out = []
    for _ in range(n):
        batch = [next(reader) for _ in range(B)]
        out.append({"img": np.stack([b[0][:dim] for b in batch]),
                    "label": np.array([[b[1]] for b in batch], np.int64)})
    return out


def _persistables(main, scope, value):
    return {n: value(scope.find_var(n)) for n, v in
            main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


_ORACLES = {}


def jax_run(opt, amp=False):
    """The JAX side, once per module: (persistables after startup, the
    first step's fetches, every step's loss, persistables after)."""
    if (opt, amp) in _ORACLES:
        return _ORACLES[(opt, amp)]
    main, start, outs, grads = build("jax", opt)
    scope = JScope()
    exe = jpt.Executor(jpt.CPUPlace(), amp=amp)
    exe.run(start, scope=scope)
    init = _persistables(main, scope, lambda v: np.array(v.array))
    first, losses, opening = None, [], {}
    for feed in feeds():
        got = exe.run(main, feed=feed, fetch_list=[outs[1]] + outs[::2]
                      + grads, scope=scope)
        first = first or [np.asarray(g) for g in got]
        losses.append(float(np.asarray(got[0])))
        for name, g in zip(grads, got[3:]):
            # each element's first nonzero gradient
            g, seen = np.asarray(g), opening.get(name)
            opening[name] = g if seen is None else np.where(seen != 0,
                                                            seen, g)
    after = _persistables(main, scope, lambda v: np.array(v.array))
    _ORACLES[(opt, amp)] = init, first, losses, after, opening
    return _ORACLES[(opt, amp)]


def port_run(init, opt, amp=False):
    main, start, outs, grads = build("torch", opt)
    scope = scope_from_jax(init, Scope(), device="cpu")
    exe = pt.Executor(pt.CPUPlace(), amp=amp)
    first, losses = None, []
    for i, feed in enumerate(feeds()):
        fetch = [outs[1]] + (outs[::2] + grads if i == 0 else [])
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        first = first or got
        losses.append(float(got[0]))
    after = _persistables(main, scope, lambda v: v.array.numpy())
    return first, losses, after


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_mlp_training_matches_jax(opt):
    init, j_first, j_losses, j_after, opening = jax_run(opt)
    first, losses, after = port_run(init, opt)
    assert len(first) == len(j_first) == 3 + 6
    for got, want in zip(first, j_first):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(losses, j_losses, atol=TOL, rtol=TOL)
    assert sorted(after) == sorted(j_after)
    for name, value in after.items():
        want = j_after[name]
        if opt == "adam" and name + "@GRAD" in opening:
            g = np.abs(opening[name + "@GRAD"])
            tiny = (g > 0) & (g < ADAM_EPS_REGIME)   # 0: never a gradient
            assert tiny.mean() < 1e-2, (name, int(tiny.sum()))
            np.testing.assert_allclose(value[tiny], want[tiny],
                                       atol=ADAM_EPS_REGIME_TOL, rtol=0,
                                       err_msg=name)
            value, want = value[~tiny], want[~tiny]
        np.testing.assert_allclose(value, want, atol=TOL, rtol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_mlp_amp_losses_match_jax(opt):
    init, _, j_losses, j_after, _ = jax_run(opt, amp=True)
    _, losses, after = port_run(init, opt, amp=True)
    np.testing.assert_allclose(losses, j_losses, atol=AMP_LOSS_TOL)
    assert all(v.dtype == j_after[k].dtype for k, v in after.items())


def _trained_pair(opt="adam", dim=32):
    """Two scopes holding the same state after the port's startup
    program, and the program to train in them."""
    main, start, outs, _ = build("torch", opt, dim)
    a, b = Scope(), Scope()
    start.random_seed = 3
    pt.Executor(pt.CPUPlace()).run(start, scope=a)
    for n in a.local_var_names():
        b.set_tensor(n, a.find_var(n).array.clone())
    return main, outs, a, b


@pytest.mark.parametrize("form", ["list", "stacked"])
def test_run_multi_equals_k_runs(form):
    main, outs, a, b = _trained_pair()
    fs = feeds(4, dim=32)
    ea, eb = pt.Executor(pt.CPUPlace()), pt.Executor(pt.CPUPlace())
    one = [ea.run(main, feed=f, fetch_list=[outs[1], outs[2]], scope=a)
           for f in fs]
    if form == "stacked":
        fs = {k: np.stack([f[k] for f in fs]) for k in fs[0]}
    multi = eb.run_multi(main, fs, fetch_list=[outs[1], outs[2]], scope=b)
    assert multi[0].shape == (4,) and multi[1].shape == (4, 1)
    np.testing.assert_array_equal(multi[0], [o[0] for o in one])
    np.testing.assert_array_equal(multi[1], np.stack([o[1] for o in one]))
    assert ea._step_ctr == eb._step_ctr == 4
    for n in a.local_var_names():
        assert torch.equal(a.find_var(n).array, b.find_var(n).array), n
    # and the next step continues from the same state
    nxt = feeds(5, dim=32)[4]
    assert ea.run(main, feed=nxt, fetch_list=[outs[1]], scope=a)[0] == \
        eb.run(main, feed=nxt, fetch_list=[outs[1]], scope=b)[0]


def test_run_multi_refusals_leave_the_scope_alone():
    main, outs, a, _ = _trained_pair()
    exe = pt.Executor(pt.CPUPlace())
    before = {n: a.find_var(n).array for n in a.local_var_names()}
    f = feeds(2, dim=32)
    lod = [{**x, "img": LoDTensor(torch.from_numpy(x["img"]),
                                  LoD.from_lengths([[B]]))} for x in f]
    with pytest.raises(NotImplementedError, match="carry LoD"):
        exe.run_multi(main, lod, fetch_list=["img"], scope=a)
    with pytest.raises(ValueError, match="LoD differs"):
        exe.run_multi(main, [lod[0], f[1]], fetch_list=[outs[1]], scope=a)
    with pytest.raises(ValueError, match="leading K axis"):
        exe.run_multi(main, {"img": np.zeros((2, B, 32), np.float32),
                             "label": np.zeros((3, B, 1), np.int64)},
                      scope=a)
    with pytest.raises(KeyError, match="no value in the scope"):
        exe.run_multi(main, f, fetch_list=[outs[1]], scope=Scope())
    for n, t in before.items():
        assert a.find_var(n).array is t
    assert exe._step_ctr == 0


def test_lod_feed_fetches_a_lod_tensor():
    main, outs, a, _ = _trained_pair()
    f = feeds(1, dim=32)[0]
    lod = LoD.from_lengths([[3, 13]])
    f["img"] = LoDTensor(torch.from_numpy(f["img"]), lod)
    img, label = pt.Executor(pt.CPUPlace()).run(
        main, feed=f, fetch_list=["img", "label"], scope=a)
    assert isinstance(img, LoDTensor) and img.lod == lod
    assert torch.equal(img.array, f["img"].array)
    assert isinstance(label, np.ndarray) and label.shape == (B, 1)


def test_feeds_are_cast_to_the_variables_dtype():
    main, outs, a, _ = _trained_pair()
    f = feeds(1, dim=32)[0]
    f = {"img": f["img"].astype(np.float64),
         "label": torch.from_numpy(f["label"].astype(np.int32))}
    exe = pt.Executor(pt.CPUPlace())
    env, _ = exe._run_step(main, exe._gather_state(main, a), f, 1)
    assert env["img"].dtype == torch.float32
    assert env["label"].dtype == torch.int64


def test_clone_for_test_evaluates_without_training():
    with fresh(tprog) as (main, start):
        img = pt.layers.data("img", [32])
        label = pt.layers.data("label", [1], dtype="int64")
        _, loss, acc = tmnist.mlp(img, label)
        test = main.clone(for_test=True)
        pt.optimizer.Adam(0.01).minimize(loss)
    scope = Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(start, scope=scope)
    f = feeds(1, dim=32)[0]
    w = scope.find_var("fc_0.w_0").array
    (t_loss,) = exe.run(test, feed=f, fetch_list=[loss], scope=scope)
    assert scope.find_var("fc_0.w_0").array is w      # nothing written
    (m_loss,) = exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    assert t_loss == m_loss                            # the same forward
    assert not torch.equal(scope.find_var("fc_0.w_0").array, w)


def test_prepare_infer_pins_the_state():
    main, outs, a, _ = _trained_pair()
    test = main.clone(for_test=True)
    test.global_block().ops = [op for op in test.global_block().ops
                               if op.type not in ("backward", "adam")]
    test._version += 1
    exe = pt.Executor(pt.CPUPlace())
    sess = exe.prepare_infer(test, fetch_list=[outs[0]], scope=a)
    f = feeds(2, dim=32)
    (pred,) = sess.run(f[0])
    assert torch.is_tensor(pred) and tuple(pred.shape) == (B, 10)
    (want,) = exe.run(test, feed=f[0], fetch_list=[outs[0]], scope=a)
    np.testing.assert_array_equal(pred.numpy(), want)
    exe.run(main, feed=f[1], scope=a)                  # train the scope
    (again,) = sess.run(f[0])
    assert torch.equal(again, pred)                    # the pinned copy
    with pytest.raises(NotImplementedError, match="A10"):
        exe.prepare_infer(test, fetch_list=[outs[0]], scope=a,
                          quant_plan="int8")


def test_failing_op_gets_the_op_aware_note():
    main, outs, a, _ = _trained_pair()
    bad = feeds(1, dim=32)[0]
    bad["img"] = bad["img"][:, :31]                    # wrong width
    with pytest.raises(RuntimeError) as info:
        pt.Executor(pt.CPUPlace()).run(main, feed=bad, scope=a)
    notes = getattr(info.value, "__notes__", [])
    assert any("while executing op #0 'mul'" in n and "fc_0.w_0" in n
               for n in notes), notes
    with pytest.raises(KeyError, match="input var 'img' not found"):
        pt.Executor(pt.CPUPlace()).run(main, feed={}, scope=a)
    with pytest.raises(KeyError, match="not produced"):
        pt.Executor(pt.CPUPlace()).run(main, feed=feeds(1, dim=32)[0],
                                       fetch_list=["nope"], scope=a)


def test_startup_random_ops_follow_their_initializers():
    with fresh(tprog) as (main, start):
        w = main.global_block().create_parameter(
            shape=[200, 300], dtype="float32", name="w")
        pt.initializer.Xavier()(w)
        g = main.global_block().create_parameter(
            shape=[400, 500], dtype="float32", name="g")
        pt.initializer.Normal(0.5, 2.0)(g)
        c = main.global_block().create_parameter(
            shape=[3], dtype="float32", name="c")
        pt.initializer.Constant(1.5)(c)
    limit = float(np.sqrt(6.0 / 500))
    vals = []
    for seed in (7, 7, 8):
        scope = Scope()
        start.random_seed = seed
        pt.Executor(pt.CPUPlace()).run(start, scope=scope)
        vals.append({n: scope.find_var(n).array for n in ("w", "g", "c")})
    w, g = vals[0]["w"], vals[0]["g"]
    assert float(w.min()) >= -limit and float(w.max()) <= limit
    assert float(w.max()) > 0.99 * limit and float(w.min()) < -0.99 * limit
    assert abs(float(w.mean())) < 0.01 * limit
    assert abs(float(w.std()) - limit / np.sqrt(3)) < 0.01 * limit
    assert abs(float(g.mean()) - 0.5) < 0.02
    assert abs(float(g.std()) - 2.0) < 0.02
    assert torch.equal(vals[0]["c"], torch.full((3,), 1.5))
    for n in ("w", "g"):
        assert torch.equal(vals[0][n], vals[1][n])      # same seed
        assert not torch.equal(vals[0][n], vals[2][n])  # another seed


def test_the_card_is_the_default_place(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Executor(pt.CUDAPlace(0))
    exe = pt.Executor(pt.CPUPlace())
    assert exe.place == pt.CPUPlace() and exe.amp is False


@pytest.mark.parametrize("kw,item", [
    ({"telemetry": True}, "A5"), ({"validate": True}, "A10"),
    ({"compile_cache": "cache_dir"}, "A11")])
def test_deferred_executor_options_name_their_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        pt.Executor(pt.CPUPlace(), **kw)


def test_eager_options_are_accepted():
    main, outs, a, b = _trained_pair()
    f = feeds(1, dim=32)[0]
    exe = pt.Executor(pt.CPUPlace(), interpret=True, donate=True,
                      compile_cache=False, cache_size=1)
    got = exe.run(main, feed=f, fetch_list=[outs[1]], scope=a)
    want = pt.Executor(pt.CPUPlace()).run(main, feed=f,
                                          fetch_list=[outs[1]], scope=b)
    assert got == want


def test_control_flow_ops_name_a8():
    with fresh(tprog) as (main, _):
        main.global_block().append_op("while", inputs={}, outputs={})
    with pytest.raises(NotImplementedError, match="A8"):
        pt.Executor(pt.CPUPlace()).run(main, scope=Scope())


def test_rng_seed_mixes_seed_step_and_op():
    seeds = {texe._rng_seed(s, t, i) for s in range(3) for t in range(3)
             for i in range(3)}
    assert len(seeds) == 27 and all(0 <= x < 2 ** 63 for x in seeds)


V, E, H = 50, 16, 32
TEXT_B, TEXT_T = 6, 5
TEXT_LENS = {"uniform": [TEXT_T] * TEXT_B, "ragged": [1, 5, 3, 4, 2, 5]}


@pytest.mark.parametrize("lens_key", ["uniform", "ragged", "seq_lens"])
def test_text_program_equals_make_train_step(lens_key):
    cfg = tx.TextConfig(vocab_size=V, emb_dim=E, hid_dim=H, num_layers=2)
    sl = lens_key == "seq_lens"
    main, start = tx.build_program(cfg, seq_lens=sl)
    assert [op.type for op in main.global_block().ops][:len(
        tx.program(cfg))] == [o[0] for o in tx.program(cfg)]
    scope = Scope()
    exe = pt.Executor(pt.CPUPlace(), amp=cfg.amp)
    start.random_seed = 5
    exe.run(start, scope=scope)
    names = [n for n, _, _ in tx.param_specs(cfg)]
    params = {n: scope.find_var(n).array.clone() for n in names}
    opt, step = tx.make_train_step(cfg, "adam", 0.002)
    state = opt.init(params)
    lens = TEXT_LENS["uniform" if sl else lens_key]
    rng = np.random.RandomState(1)
    for _ in range(3):
        words = rng.randint(0, V, (sum(lens), 1)).astype(np.int64)
        label = rng.randint(0, 2, (TEXT_B, 1)).astype(np.int64)
        feed = {"words": LoDTensor(torch.from_numpy(words),
                                   LoD.from_lengths([lens])),
                "label": torch.from_numpy(label)}
        if sl:   # runtime lengths over a uniform LoD
            feed["seq_lens"] = torch.tensor(TEXT_LENS["ragged"],
                                            dtype=torch.int32)
        loss, acc = exe.run(main, feed=feed,
                            fetch_list=[tx.LOSS, tx.ACCURACY], scope=scope)
        params, state, w_loss, w_acc = step(params, state, feed)
        np.testing.assert_allclose(loss, w_loss.numpy(), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(acc, w_acc.numpy(), atol=TOL, rtol=TOL)
    for n in names:
        np.testing.assert_allclose(scope.find_var(n).array.numpy(),
                                   params[n].numpy(), atol=TOL, rtol=TOL,
                                   err_msg=n)
