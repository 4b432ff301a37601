"""The port's image-classification path (``models/image.py``, the MNIST
``conv`` net, the two conv book builders, ``nets.simple_img_conv_pool`` /
``img_conv_group``, ``Momentum``, ``datasets/cifar.py``) held against the
JAX package's on the CPU.

- Programs: each builder (AlexNet, VGG-16, ResNet-50 / 101 / 152 with
  the 7x7 stem and ResNet-50 with the space-to-depth stem, the CIFAR
  ResNet, GoogLeNet, SmallNet, ``mnist.conv``) built by both packages
  from cleared name counters with ``Momentum(0.01, 0.9).minimize``, and
  the book's ``recognize_digits_conv`` / ``smallnet_cifar``, give the
  same main and startup op lists, variables and ``fingerprint``.
- Training: from the JAX startup program's state carried over with
  ``convert.scope_from_jax``, 3 ``Momentum(0.01, 0.9)`` steps of
  SmallNet and the depth-8 CIFAR ResNet at 32x32, batch 2, through both
  Executors: every loss and every persistable after (parameters,
  velocities, batch norm's running mean and variance) at atol/rtol 1e-5
  (fp32: the same math, sums in another order).
- ``is_test`` forwards (the programs cloned for test: dropout passes,
  batch norm over the running statistics) of AlexNet, VGG-16, GoogLeNet
  and ResNet-50 at 64x64 (32x32 for VGG-16 and ResNet-50), 1000 classes,
  batch 2, from one numpy-seeded state (He-scaled weights, running
  statistics off their fills): the predictions and the loss at 1e-5.
- ResNet-50 (depth 50): one Momentum step at 64x64, batch 8, from
  ``scope_from_jax``, the port and the JAX package each against the step
  in float64: the port within ``chip_smoke.py``'s parity gates and no
  farther from float64 than JAX (its fp32 gradients lie a few percent
  from float64 on either side; a second step lies about 100 % from it on
  either side, so it is not held).
- The space-to-depth stem, as ``tests/test_s2d_stem.py`` checks it on the
  JAX side: the refolded 7x7 weight respects the mask; odd spatial sizes
  raise; the stem equals the 7x7 stride-2 conv with the refolded weight
  (2e-5); after 3 SGD steps no masked element of the weight moved; and
  ``resnet_imagenet(s2d_stem=True)`` trains (8 Adam steps at 64x64,
  losses finite and falling).
- ``convert.scope_from_jax`` carries the non-trainable persistables:
  batch norm's running mean and variance and the s2d stem's mask, bit
  for bit.
- The Executor threads batch norm's running statistics (written by the
  forward, carrying no gradient) and dropout's per-step generator
  through ``run_multi``: K = 3 steps bit-equal to 3 ``run`` calls.
- ``datasets.cifar``: the surrogates' samples equal the JAX module's.
- ``chip_smoke.py``'s gates for ResNet-50's batch-2 fp32 step (the card
  and the CPU each against the step in float64) stand 2-30x above the
  CPU's own distance from float64, at 1 and at 6 threads.
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import datasets as jdatasets
from paddle_tpu.core import scope as jscope_mod
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.framework import program as jprog
from paddle_tpu.models import book as jbook
from paddle_tpu.models import image as jimage
from paddle_tpu.models import mnist as jmnist

import paddle_tpu_torch as pt
from paddle_tpu_torch import datasets as tdatasets
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.core import dtype as tdtype
from paddle_tpu_torch.core import scope as tscope_mod
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.initializer import NumpyArrayInitializer
from paddle_tpu_torch.models import book as tbook
from paddle_tpu_torch.models import image as timage
from paddle_tpu_torch.models import mnist as tmnist

TOL = 1e-5
LR, MU = 0.01, 0.9             # bench.py's Momentum(0.01, momentum=0.9)

SIDES = {"jax": (jpt, jprog, jimage, jmnist, jscope_mod),
         "torch": (pt, tprog, timage, tmnist, tscope_mod)}


@pytest.fixture(autouse=True)
def clean_scopes():
    for side in SIDES.values():
        side[4].reset_global_scope()
    yield
    for side in SIDES.values():
        side[4].reset_global_scope()


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=what)


@contextlib.contextmanager
def fresh(side):
    """New main and startup programs of one package under
    ``program_guard``, its name counters cleared for the build and
    restored after."""
    pkg, mod = SIDES[side][:2]
    saved = dict(mod._name_counters)
    mod._name_counters.clear()
    main, start = pkg.Program(), pkg.Program()
    try:
        with pkg.program_guard(main, start):
            yield main, start
    finally:
        mod._name_counters.clear()
        mod._name_counters.update(saved)


# name -> (builder over (image, mnist) modules, image size, classes)
MODELS = {
    "alexnet": (lambda im, mn, i, l: im.alexnet(i, l, class_dim=1000), 64,
                1000),
    "vgg16": (lambda im, mn, i, l: im.vgg16(i, l, class_dim=1000), 32, 1000),
    "resnet50": (lambda im, mn, i, l: im.resnet_imagenet(
        i, l, class_dim=1000, depth=50), 32, 1000),
    "resnet101": (lambda im, mn, i, l: im.resnet_imagenet(
        i, l, class_dim=1000, depth=101), 32, 1000),
    "resnet152": (lambda im, mn, i, l: im.resnet_imagenet(
        i, l, class_dim=1000, depth=152), 32, 1000),
    "resnet50_s2d": (lambda im, mn, i, l: im.resnet_imagenet(
        i, l, class_dim=1000, depth=50, s2d_stem=True), 32, 1000),
    "resnet_cifar10_8": (lambda im, mn, i, l: im.resnet_cifar10(
        i, l, depth=8), 32, 10),
    "googlenet": (lambda im, mn, i, l: im.googlenet(i, l, class_dim=1000),
                  64, 1000),
    "smallnet": (lambda im, mn, i, l: im.smallnet_mnist_cifar(i, l), 32, 10),
    "mnist_conv": (lambda im, mn, i, l: mn.conv(i, l), 28, 10),
}


def _build(side, name, optimize=True, hw=None):
    """(main, startup, loss, prediction) of MODELS[name] in fresh
    programs, at its image size or ``hw``; with ``optimize``,
    Momentum(LR, MU).minimize(loss)."""
    pkg, _, im, mn, _ = SIDES[side]
    fn, model_hw, _ = MODELS[name]
    hw = hw or model_hw
    with fresh(side) as (main, start):
        ch = 1 if name == "mnist_conv" else 3
        img = pkg.layers.data("img", [ch, hw, hw])
        label = pkg.layers.data("label", [1], dtype="int64")
        pred, loss, _ = fn(im, mn, img, label)
        if optimize:
            pkg.optimizer.Momentum(LR, momentum=MU).minimize(loss)
    return main, start, loss, pred


def _dtype(dt):
    return (tdtype.dtype_name(dt) if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)


def _describe(program):
    block = program.global_block()
    ops = [(op.type, op.inputs, op.outputs, op.attrs) for op in block.ops]
    var_sigs = {n: (v.shape, _dtype(v.dtype), v.lod_level, v.persistable)
                for n, v in block.vars.items()}
    params = [(p.name, p.trainable) for p in block.all_parameters()]
    return ops, var_sigs, params


def _same_programs(t_pair, j_pair):
    for t, j in zip(t_pair, j_pair):
        t_ops, t_vars, t_params = _describe(t)
        j_ops, j_vars, j_params = _describe(j)
        assert [o[0] for o in t_ops] == [o[0] for o in j_ops]
        for a, b in zip(t_ops, j_ops):
            assert a == b, (a, b)
        assert t_vars == j_vars
        assert t_params == j_params
        assert t.fingerprint() == j.fingerprint()


@pytest.mark.parametrize("name", list(MODELS))
def test_image_programs_match_jax(name):
    jm, js, jl, jp = _build("jax", name)
    tm, ts, tl, tp = _build("torch", name)
    assert (tl.name, tp.name) == (jl.name, jp.name)
    _same_programs((tm, ts), (jm, js))


@pytest.mark.parametrize("name", ["recognize_digits_conv", "smallnet_cifar"])
def test_conv_book_programs_match_jax(name):
    jl, jm, js = jbook.build_book_model(name)
    tl, tm, ts = tbook.build_book_model(name)
    assert tl.name == jl.name
    _same_programs((tm, ts), (jm, js))


def test_resnet50_op_counts():
    """ResNet-50's step: 53 convolutions, 53 batch norms, 49 relus
    (one after each BN but the blocks' third and shortcut ones, one
    after each of the 16 residual adds), 161 momentum updates (53 conv
    filters, 53 x 2 BN scale and bias, fc's weight and bias)."""
    tm, _, _, _ = _build("torch", "resnet50")
    types = [op.type for op in tm.global_block().ops]
    counts = {t: types.count(t) for t in ("conv2d", "batch_norm", "relu",
                                          "elementwise_add", "momentum")}
    assert counts == {"conv2d": 53, "batch_norm": 53, "relu": 49,
                      "elementwise_add": 17, "momentum": 161}, counts


# ------------------------------------------------- training vs the JAX side

def _persistables(main, scope, value):
    return {n: value(scope.find_var(n)) for n, v in
            main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _image_feeds(name, n, batch=2, seed=0, hw=None):
    _, model_hw, classes = MODELS[name]
    hw = hw or model_hw
    ch = 1 if name == "mnist_conv" else 3
    rng = np.random.RandomState(seed)
    return [{"img": rng.rand(batch, ch, hw, hw).astype(np.float32),
             "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def _jax_startup(jm, js):
    """The JAX startup program's persistables (numpy), run in the JAX
    global scope (the s2d mask's NumpyArrayInitializer writes there)."""
    jscope = jscope_mod.global_scope()
    jexe = jpt.Executor(jpt.CPUPlace())
    jexe.run(js, scope=jscope)
    return jexe, jscope, _persistables(jm, jscope,
                                       lambda v: np.array(v.array))


@pytest.mark.parametrize("name", ["smallnet", "resnet_cifar10_8"])
def test_momentum_steps_match_jax(name):
    jm, js, jl, _ = _build("jax", name)
    tm, ts, tl, _ = _build("torch", name)
    jexe, jscope, init = _jax_startup(jm, js)
    tscope = scope_from_jax(init, scope=Scope(), device="cpu")
    texe = pt.Executor(pt.CPUPlace())
    for f in _image_feeds(name, 3):
        (want,) = jexe.run(jm, feed=f, fetch_list=[jl], scope=jscope)
        (got,) = texe.run(tm, feed=f, fetch_list=[tl], scope=tscope)
        assert np.isfinite(got).all()
        _close(got, want, TOL, what="loss")
    after = _persistables(jm, jscope, lambda v: np.array(v.array))
    bns = [op for op in tm.global_block().ops if op.type == "batch_norm"]
    assert bool(bns) == (name != "smallnet")
    for op in bns:      # MeanOut / VarianceOut are the running stats
        assert op.outputs["MeanOut"] == op.inputs["Mean"]
        assert op.outputs["VarianceOut"] == op.inputs["Variance"]
        assert op.inputs["Mean"][0] in after
    for n, want in after.items():
        have = tscope.find_var(n).array.numpy()
        _close(have, want, TOL, what=n)
    for op in bns:      # 3 updates moved them off their fills
        assert not np.allclose(after[op.inputs["Mean"][0]], 0.0)
        assert not np.allclose(after[op.inputs["Variance"][0]], 1.0)


def _resnet50_steps_vs_float64(hw, batch, steps):
    """``steps`` Momentum steps of ResNet-50 at ``hw`` x ``hw``, batch
    ``batch``, from the JAX startup state carried over with
    ``scope_from_jax``, through both Executors and through the same steps
    in float64 (``chip_smoke._plain_step64``): for each step, each side's
    ``chip_smoke._step_distances`` from float64 (port, jax), and the two
    losses."""
    import chip_smoke as cs
    jm, js, jl, _ = _build("jax", "resnet50", hw=hw)
    tm, ts, tl, _ = _build("torch", "resnet50", hw=hw)
    jexe, jscope, init = _jax_startup(jm, js)
    tscope = scope_from_jax(init, scope=Scope(), device="cpu")
    texe = pt.Executor(pt.CPUPlace())
    ref = {n: torch.from_numpy(v) for n, v in init.items()}
    out = []
    for f in _image_feeds("resnet50", steps, batch=batch, hw=hw):
        before = {n: v.double() for n, v in ref.items()}
        (want,) = jexe.run(jm, feed=f, fetch_list=[jl], scope=jscope)
        (got,) = texe.run(tm, feed=f, fetch_list=[tl], scope=tscope)
        ref_loss, ref = cs._plain_step64(tm, before, f)
        port = {n: tscope.find_var(n).array for n in init}
        jax_side = {n: torch.from_numpy(np.array(jscope.find_var(n).array))
                    for n in init}
        out.append((cs._step_distances(tm, before, port, ref, float(got),
                                       ref_loss),
                    cs._step_distances(tm, before, jax_side, ref,
                                       float(want), ref_loss),
                    float(got), float(want)))
    return out


def test_resnet50_momentum_step_matches_jax():
    """ResNet-50's bottleneck blocks under Momentum: one step at 64 x 64,
    batch 8 (its last stage normalizes 32 values a channel) from the JAX
    startup state, through both Executors and in float64
    (``_resnet50_steps_vs_float64``). Its fp32 gradients lie a few percent
    from float64 on either side (batch norm's backward cancels), so the
    port is held against float64 with ``chip_smoke.py``'s parity gates and
    must lie no farther from it than the JAX package does (measured at 1
    to 8 threads: the gradients 0.026-0.032 all together, 0.031-0.039 the
    worst, against JAX's 0.058 and 0.080; the running statistics' batch
    parts 5.2e-5 against 3.4e-4; the loss 8.3e-6). A second step is not
    held: from the first update on, both packages' steps lie about 100 %
    from float64's in their gradients, at 64 x 64 batch 8 or 16 and at 96
    and 128 x 128 batch 8 alike (``python tests/test_torch_image.py HW
    BATCH STEPS`` with the repo on PYTHONPATH prints them)."""
    import chip_smoke as cs
    [(d_port, d_jax, got, want)] = _resnet50_steps_vs_float64(64, 8, 1)
    print("port:", d_port, "jax:", d_jax)
    assert d_port["n_stats"] == 106 and d_port["n_params"] == 161
    assert cs._within_parity_gates(d_port), d_port
    for key in ("grad_max_rel_l2", "all_grads_rel_l2", "update_max_rel_l2",
                "stat_max_rel_l2"):
        assert d_port[key] <= d_jax[key], (key, d_port[key], d_jax[key])
    _close(got, want, 1e-4, what="loss")


def _seeded_state(main, seed=0):
    """Every persistable of ``main`` from numpy at ``seed``: convolution
    and fc weights He-scaled normals, batch norm's scale 1 + N(0, 0.1),
    its running mean N(0, 0.1) and variance U(0.5, 1.5), biases
    N(0, 0.1)."""
    r = np.random.RandomState(seed)
    block = main.global_block()
    roles = {}
    for op in block.ops:
        if op.type == "batch_norm":
            roles[op.inputs["Scale"][0]] = "scale"
            roles[op.inputs["Mean"][0]] = "mean"
            roles[op.inputs["Variance"][0]] = "var"
    out = {}
    for n, v in block.vars.items():
        if not v.persistable or v.shape is None:
            continue
        shape = tuple(v.shape)
        role = roles.get(n)
        if role == "scale":
            a = 1.0 + 0.1 * r.randn(*shape)
        elif role == "var":
            a = 0.5 + r.rand(*shape)
        elif len(shape) >= 2:
            fan_in = int(np.prod(shape[1:])) if len(shape) == 4 else shape[0]
            a = r.randn(*shape) * np.sqrt(2.0 / fan_in)
        else:
            a = 0.1 * r.randn(*shape)
        out[n] = a.astype(np.float32)
    return out


@pytest.mark.parametrize("name", ["alexnet", "vgg16", "googlenet",
                                  "resnet50"])
def test_is_test_forward_matches_jax(name):
    """The forward cloned for test from one numpy-seeded state on both
    sides: dropout passes its input, batch norm reads the running
    statistics; the predictions and the loss at 1e-5."""
    jm, js, jl, jp = _build("jax", name, optimize=False)
    tm, ts, tl, tp = _build("torch", name, optimize=False)
    state = _seeded_state(jm)
    jscope = JScope()
    for n, v in state.items():
        jscope.set_tensor(n, v)
    tscope = scope_from_jax(state, scope=Scope(), device="cpu")
    jtest, ttest = jm.clone(for_test=True), tm.clone(for_test=True)
    jexe, texe = jpt.Executor(jpt.CPUPlace()), pt.Executor(pt.CPUPlace())
    f = _image_feeds(name, 1, seed=1)[0]
    want = jexe.run(jtest, feed=f, fetch_list=[jp, jl], scope=jscope)
    got = texe.run(ttest, feed=f, fetch_list=[tp, tl], scope=tscope)
    _close(got[0], want[0], TOL, what="prediction")
    _close(got[1], want[1], TOL, what="loss")
    # the training program draws dropout masks and normalizes over the
    # batch: its forward differs
    train = texe.run(tm, feed=f, fetch_list=[tp], scope=tscope)[0]
    assert not np.allclose(train, got[0], atol=1e-6)


# ------------------------------------------------------- the s2d stem

rng = np.random.RandomState(7)


def _find_param(program, substr, exclude=".mask"):
    names = [p.name for p in program.global_block().all_parameters()
             if substr in p.name and exclude not in p.name]
    assert len(names) == 1, names
    return names[0]


def test_refold_respects_mask():
    w7 = rng.randn(16, 3, 7, 7).astype(np.float32)
    folded = timage.refold_stem_weight(w7)
    mask = timage.s2d_weight_mask(16, 3)
    np.testing.assert_array_equal(folded * mask, folded)
    assert np.isclose(np.abs(folded).sum(), np.abs(w7).sum())
    np.testing.assert_array_equal(folded, jimage.refold_stem_weight(w7))
    np.testing.assert_array_equal(mask, jimage.s2d_weight_mask(16, 3))


def test_s2d_stem_rejects_odd_spatial():
    with fresh("torch"):
        img = pt.layers.data("img", [3, 33, 33])
        with pytest.raises(ValueError, match="even spatial"):
            timage._s2d_stem(img, 8)


def test_s2d_stem_forward_equivalence():
    x = rng.randn(2, 3, 32, 32).astype(np.float32)
    w7 = (rng.randn(16, 3, 7, 7) * 0.1).astype(np.float32)
    with fresh("torch") as (main, start):
        img = pt.layers.data("img", [3, 32, 32])
        plain = pt.layers.conv2d(
            img, 16, 7, stride=2, padding=3, bias_attr=False,
            param_attr=pt.ParamAttr(initializer=NumpyArrayInitializer(w7)))
        s2d = timage._s2d_stem(img, 16)
        wname = _find_param(main, "s2d_stem")
    exe = pt.Executor(pt.CPUPlace())
    scope = tscope_mod.global_scope()
    exe.run(start, scope=scope)
    scope.set_tensor(wname, torch.from_numpy(timage.refold_stem_weight(w7)))
    a, b = exe.run(main, feed={"img": x}, fetch_list=[plain, s2d],
                   scope=scope)
    assert a.shape == b.shape == (2, 16, 16, 16)
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def test_s2d_stem_grads_stay_masked():
    """After SGD steps no masked element of the stem's weight moved."""
    x = rng.randn(4, 3, 16, 16).astype(np.float32)
    with fresh("torch") as (main, start):
        img = pt.layers.data("img", [3, 16, 16])
        out = timage._s2d_stem(img, 8)
        loss = pt.layers.mean(pt.layers.elementwise_mul(out, out))
        pt.optimizer.SGD(0.5).minimize(loss)
        wname = _find_param(main, "s2d_stem")
    exe = pt.Executor(pt.CPUPlace())
    scope = tscope_mod.global_scope()
    exe.run(start, scope=scope)
    w0 = scope.find_var(wname).array.numpy().copy()
    for _ in range(3):
        exe.run(main, feed={"img": x}, fetch_list=[loss], scope=scope)
    w3 = scope.find_var(wname).array.numpy()
    mask = timage.s2d_weight_mask(8, 3)
    assert not np.allclose(w0, w3)
    changed = ~np.isclose(w0, w3)
    np.testing.assert_array_equal(changed * (1 - mask), 0)
    assert not main.global_block().var(wname + ".mask").trainable


def test_resnet_s2d_builds_and_steps():
    x = rng.randn(4, 3, 64, 64).astype(np.float32)
    y = (np.arange(4) % 10).astype(np.int64).reshape(4, 1)
    with fresh("torch") as (main, start):
        img = pt.layers.data("img", [3, 64, 64])
        label = pt.layers.data("label", [1], dtype="int64")
        _, loss, _ = timage.resnet_imagenet(img, label, class_dim=10,
                                            depth=50, s2d_stem=True)
        pt.optimizer.Adam(1e-3).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    scope = tscope_mod.global_scope()
    start.random_seed = 0
    exe.run(start, scope=scope)
    losses = [float(exe.run(main, feed={"img": x, "label": y},
                            fetch_list=[loss], scope=scope)[0])
              for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def _stem_bn_net(pkg, image):
    img = pkg.layers.data("img", [3, 8, 8])
    t = pkg.layers.batch_norm(image._s2d_stem(img, 4), act="relu")
    t = pkg.layers.dropout(pkg.layers.pool2d(t, 2, pool_type="avg"), 0.3)
    return pkg.layers.mean(pkg.layers.elementwise_mul(t, t))


def test_scope_from_jax_carries_stats_and_mask():
    with fresh("jax") as (jm, js):
        _stem_bn_net(jpt, jimage)
    _, _, init = _jax_startup(jm, js)
    bn = next(op for op in jm.global_block().ops if op.type == "batch_norm")
    mask = next(n for n in init if n.endswith(".mask"))
    for n in (bn.inputs["Mean"][0], bn.inputs["Variance"][0], mask):
        assert not isinstance(jm.global_block().var(n), jprog.Parameter) \
            or not jm.global_block().var(n).trainable
    scope = scope_from_jax(init, scope=Scope(), device="cpu")
    for n, v in init.items():
        got = scope.find_var(n).array
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), v)
    np.testing.assert_array_equal(scope.find_var(mask).array.numpy(),
                                  timage.s2d_weight_mask(4, 3))


def test_run_multi_threads_running_stats_and_dropout():
    with fresh("torch") as (main, start):
        loss = _stem_bn_net(pt, timage)
        pt.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    scope = tscope_mod.global_scope()
    start.random_seed = 0
    exe.run(start, scope=scope)
    names = sorted(scope.local_var_names())
    feeds = [{"img": rng.rand(4, 3, 8, 8).astype(np.float32)}
             for _ in range(3)]
    runs, multi = Scope(), Scope()
    for n in names:
        runs.set_tensor(n, scope.find_var(n).array.clone())
        multi.set_tensor(n, scope.find_var(n).array.clone())
    ea, eb = pt.Executor(pt.CPUPlace()), pt.Executor(pt.CPUPlace())
    one = [ea.run(main, feed=f, fetch_list=[loss], scope=runs)[0]
           for f in feeds]
    (k3,) = eb.run_multi(main, feeds, fetch_list=[loss], scope=multi)
    np.testing.assert_array_equal(np.stack(one), k3)
    bn = next(op for op in main.global_block().ops
              if op.type == "batch_norm")
    for n in names:
        assert torch.equal(runs.find_var(n).array, multi.find_var(n).array)
    moved = multi.find_var(bn.inputs["Variance"][0]).array
    assert not torch.allclose(moved, torch.ones_like(moved))


def test_resnet50_step_sum_order_spread_within_smoke_gates():
    """One fp32 ResNet-50 step (batch 2, 224 x 224, bench.py's first feed)
    on the CPU at 1 and at 6 threads, the same startup state, each held
    against the step in float64 (``chip_smoke._plain_step64``), as
    ``chip_smoke.py`` holds the card: each of ``chip_smoke.py``'s
    IMAGE_PARITY_* gates stands 2-30x above the larger of the two
    distances (measured: the loss 3.2e-6, each gradient and update 0.030
    at most, all the gradients 0.024, the running statistics 4.0e-5), and
    the 1-against-6 spread lies within the gates too."""
    import chip_smoke as cs
    main, start, loss, _, _ = cs._image_program("resnet50")
    exe = pt.Executor(pt.CPUPlace())
    s0 = Scope()
    start.random_seed = 0
    exe.run(start, scope=s0)
    names = sorted(s0.local_var_names())
    init = {n: s0.find_var(n).array.clone() for n in names}
    feed = cs._image_feeds("resnet50", 2)[0]
    ref_loss, ref = cs._plain_step64(main, init, feed)
    threads = torch.get_num_threads()
    runs = []
    try:
        for n_threads in (1, 6):
            torch.set_num_threads(n_threads)
            s = cs._scope_copy(s0, names, "cpu")
            (got,) = exe.run(main, feed=feed, fetch_list=[loss], scope=s)
            runs.append((float(got), {n: s.find_var(n).array
                                      for n in names}))
    finally:
        torch.set_num_threads(threads)
    dists = [cs._step_distances(main, init, after, ref, got, ref_loss)
             for got, after in runs]
    (la, a), (lb, b) = runs
    spread = cs._step_distances(main, init, a, b, la, lb)
    print("float64 distances:", dists, "spread:", spread)
    assert dists[0]["n_stats"] == 106 and dists[0]["n_params"] == 161
    for key, gate in (("loss_rel", cs.IMAGE_PARITY_LOSS_REL),
                      ("grad_max_rel_l2", cs.IMAGE_PARITY_GRAD_REL_L2),
                      ("update_max_rel_l2", cs.IMAGE_PARITY_GRAD_REL_L2),
                      ("all_grads_rel_l2", cs.IMAGE_PARITY_ALL_GRADS_REL_L2),
                      ("stat_max_rel_l2", cs.IMAGE_PARITY_STAT_REL_L2)):
        worst = max(d[key] for d in dists)
        assert 2 * worst <= gate <= 30 * worst, (key, worst, gate)
        assert spread[key] <= gate, (key, spread[key], gate)
    assert all(cs._within_parity_gates(d) for d in dists + [spread])


# ------------------------------------------------------------- cifar

@pytest.mark.parametrize("split", ["train10", "test10", "train100",
                                   "test100"])
def test_cifar_samples_match_jax(split):
    want = list(getattr(jdatasets.cifar, split)(24)())
    got = list(getattr(tdatasets.cifar, split)(24)())
    assert len(got) == len(want) == 24
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == np.float32 and gi.shape == (3072,)
        np.testing.assert_array_equal(gi, wi)
        assert gl == wl


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_image.py HW BATCH STEPS: each side's distance
    # from float64 after each of STEPS Momentum steps of ResNet-50
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    hw_, batch_, steps_ = (int(a) for a in sys.argv[1:4])
    for i, (dp, dj, lp, lj) in enumerate(
            _resnet50_steps_vs_float64(hw_, batch_, steps_)):
        print(f"step {i}: loss port {lp:.7f} jax {lj:.7f}")
        for key in ("loss_rel", "grad_max_rel_l2", "all_grads_rel_l2",
                    "update_max_rel_l2", "stat_max_rel_l2"):
            print(f"  {key:18s} port {dp[key]:.3e}  jax {dj[key]:.3e}")
