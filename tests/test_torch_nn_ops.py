"""The port's ``ops/nn.py`` (every op the JAX package's ``ops/nn.py``
registers), ``reshape`` / ``transpose`` (``ops/math.py``) and
``momentum`` (``ops/optimizer_ops.py``) held against the JAX registry's
compute on the CPU.

Each case runs one op of each package on the same numpy-seeded inputs,
with the attribute cases of ``tests/test_ops_nn.py`` and more: conv2d
with padding, strides, groups and dilation, depthwise; the transposed
convs with strides, padding and dilation; max, average (exclusive or
not, with and without pads) and global pooling, pads past half the
window; batch_norm in training (its running statistics, the biased
variance, the large-mean case), on a 2-D input and in inference;
layer_norm; lrn; pad; the bilinear resize up and down; the argmax pool
and unpool; spp; the 3-D family; selective_fc. Every output is compared
at atol/rtol 1e-5 (fp32: the same math, sums in another order), then
the gradients of sum(sin(out)) for every float input at 1e-5. bf16
inputs (batch_norm's fp32 Scale and Bias meeting a bf16 X; conv2d as
AMP runs it) are held at 2e-2.

The random ops are held by their statistics: dropout's keep share, its
1 / (1 - p) scaling and Mask, ``is_test`` and p = 0 passing the input,
a nonzero ``seed`` fixing the draw; ``sampling_id``'s frequencies. Each
op's registration (slots, attribute defaults, optional inputs,
``amp_compute``, ``needs_rng``) equals the JAX package's.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.framework import registry as jreg
from paddle_tpu.ops import nn as jnn  # noqa: F401  (registers the JAX ops)

from paddle_tpu_torch.framework import registry as treg

TOL = 1e-5
BF16_TOL = 2e-2


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=what)


def _listed(ins):
    return {s: v if isinstance(v, list) else [v] for s, v in ins.items()}


def _full(info, attrs, is_test):
    full = dict(info.attrs, **attrs)
    if is_test and "is_test" in info.attrs:
        full["is_test"] = True
    return full


def _jax(op, ins, attrs, grad_of=(), grad_slots=(), is_test=False):
    """The JAX op's outputs (numpy) and the gradients of the sum of
    sum(sin(out)) over ``grad_slots`` for the inputs in ``grad_of``; the
    context's ``is_test`` as both Executors set it (the attribute, else
    the program's)."""
    import jax
    import jax.numpy as jnp
    info = jreg.get_op_info(op)
    full = _full(info, attrs, is_test)
    ins = _listed(ins)
    base = {s: [jnp.asarray(a) for a in ins[s]] for s in grad_of}

    def run(diff):
        args = {s: [diff[s][i] if s in diff else jnp.asarray(a)
                    for i, a in enumerate(v)] for s, v in ins.items()}
        ctx = jreg.OpContext(attrs=full, rng=jax.random.PRNGKey(0),
                             is_test=bool(full.get("is_test", is_test)))
        return info.compute(args, full, ctx)

    outs = {k: (v if isinstance(v, list) else [v])
            for k, v in run(base).items()}
    grads = {}
    if grad_of:
        g = jax.grad(lambda d: sum(
            jnp.sum(jnp.sin(run(d)[s].astype(jnp.float32)))
            for s in grad_slots))(base)
        grads = {s: [np.asarray(x, np.float32) for x in g[s]]
                 for s in grad_of}
    return outs, grads


def _port(op, ins, attrs, grad_of=(), grad_slots=(), dtype=None,
          is_test=False, rng=None):
    info = treg.get_op_info(op)
    full = _full(info, attrs, is_test)
    live = {s: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
            for s, v in _listed(ins).items()}
    if dtype is not None:
        live = {s: [t.to(dtype) if t.is_floating_point() else t
                    for t in v] for s, v in live.items()}
    for s in grad_of:
        for t in live[s]:
            t.requires_grad_(True)
    ctx = treg.OpContext(attrs=full, rng=rng,
                         is_test=bool(full.get("is_test", is_test)))
    outs = info.compute(live, full, ctx)
    outs = {k: (list(v) if isinstance(v, (list, tuple)) else [v])
            for k, v in outs.items()}
    grads = {}
    if grad_of:
        flat = [t for s in grad_of for t in live[s]]
        g = torch.autograd.grad(sum(torch.sum(torch.sin(outs[s][0].float()))
                                    for s in grad_slots), flat)
        it = iter(g)
        grads = {s: [next(it) for _ in live[s]] for s in grad_of}
    return outs, grads, live


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _cases():
    r = np.random.RandomState(0)
    x4 = _rand(r, 2, 3, 7, 7)
    bn = {"X": _rand(r, 4, 3, 5, 5), "Scale": r.rand(3).astype(np.float32)
          + 0.5, "Bias": _rand(r, 3), "Mean": _rand(r, 3, scale=0.1),
          "Variance": r.rand(3).astype(np.float32) + 0.5}
    conv = lambda x, w, **a: ("conv2d", {"Input": x, "Filter": w}, a,
                              ("Input", "Filter"), ("Output",))
    convt = lambda op, x, w, **a: (op, {"Input": x, "Filter": w}, a,
                                   ("Input", "Filter"), ("Output",))
    pool = lambda x, **a: ("pool2d", {"X": x}, a, ("X",), ("Out",))
    pool3 = lambda x, **a: ("pool3d", {"X": x}, a, ("X",), ("Out",))
    c = {
        "conv2d_pad": conv(_rand(r, 2, 3, 5, 5), _rand(r, 4, 3, 3, 3),
                           strides=[1, 1], paddings=[1, 1]),
        "conv2d_stride_groups": conv(_rand(r, 1, 4, 6, 6),
                                     _rand(r, 4, 2, 3, 3), strides=[2, 2],
                                     paddings=[0, 0], groups=2),
        "conv2d_dilation": conv(_rand(r, 2, 3, 9, 9), _rand(r, 4, 3, 3, 3),
                                strides=[1, 2], paddings=[2, 1],
                                dilations=[2, 2]),
        "conv2d_stem_7x7_s2": conv(_rand(r, 2, 3, 16, 16),
                                   _rand(r, 8, 3, 7, 7, scale=0.1),
                                   strides=[2, 2], paddings=[3, 3]),
        "depthwise_conv2d": ("depthwise_conv2d",
                             {"Input": _rand(r, 2, 4, 6, 6),
                              "Filter": _rand(r, 4, 1, 3, 3)},
                             {"paddings": [1, 1], "groups": 4},
                             ("Input", "Filter"), ("Output",)),
        "conv2d_transpose": convt("conv2d_transpose", _rand(r, 1, 2, 3, 3),
                                  _rand(r, 2, 3, 2, 2), strides=[2, 2],
                                  paddings=[0, 0]),
        "conv2d_transpose_pad_dil": convt(
            "conv2d_transpose", _rand(r, 2, 3, 4, 5), _rand(r, 3, 2, 3, 3),
            strides=[2, 1], paddings=[1, 2], dilations=[2, 1]),
        "pool2d_max": pool(_rand(r, 2, 3, 4, 4), pooling_type="max",
                           ksize=[2, 2], strides=[2, 2]),
        "pool2d_max_3x3_s2_p1": pool(x4, pooling_type="max", ksize=[3, 3],
                                     strides=[2, 2], paddings=[1, 1]),
        "pool2d_max_pad_past_half": pool(x4, pooling_type="max",
                                         ksize=[3, 3], strides=[2, 2],
                                         paddings=[2, 2]),
        "pool2d_avg": pool(_rand(r, 2, 3, 4, 4), pooling_type="avg",
                           ksize=[2, 2], strides=[2, 2]),
        "pool2d_avg_3x3_s2": pool(x4, pooling_type="avg", ksize=[3, 3],
                                  strides=[2, 2]),
        "pool2d_avg_exclusive_pad": pool(x4, pooling_type="avg",
                                         ksize=[3, 3], strides=[1, 1],
                                         paddings=[1, 1]),
        "pool2d_avg_inclusive_pad": pool(x4, pooling_type="avg",
                                         ksize=[3, 3], strides=[2, 2],
                                         paddings=[1, 1], exclusive=False),
        "pool2d_avg_exclusive_pad_past_half": pool(
            x4, pooling_type="avg", ksize=[3, 2], strides=[2, 1],
            paddings=[2, 1]),
        "pool2d_avg_inclusive_pad_past_half": pool(
            x4, pooling_type="avg", ksize=[3, 3], strides=[2, 2],
            paddings=[2, 2], exclusive=False),
        "pool2d_global_avg": pool(_rand(r, 2, 3, 5, 5), pooling_type="avg",
                                  global_pooling=True),
        "pool2d_global_max": pool(_rand(r, 2, 3, 5, 5), pooling_type="max",
                                  global_pooling=True),
        "batch_norm_train": ("batch_norm", bn, {"momentum": 0.9,
                                                "epsilon": 1e-5},
                             ("X", "Scale", "Bias"), ("Y",)),
        "batch_norm_saved_stats_grads": (
            "batch_norm", bn, {}, ("X", "Scale", "Bias"),
            ("Y", "SavedMean", "SavedVariance")),
        "batch_norm_2d_input": ("batch_norm", dict(
            bn, X=_rand(r, 8, 3)), {"momentum": 0.8},
            ("X", "Scale", "Bias"), ("Y",)),
        "batch_norm_is_test": ("batch_norm", bn, {"is_test": True},
                               ("X", "Scale", "Bias"), ("Y",)),
        "layer_norm": ("layer_norm", {"X": _rand(r, 3, 8),
                                      "Scale": r.rand(8).astype(np.float32)
                                      + 0.5, "Bias": _rand(r, 8)},
                       {"begin_norm_axis": 1}, ("X", "Scale", "Bias"),
                       ("Y",)),
        "layer_norm_no_affine_axis2": ("layer_norm",
                                       {"X": _rand(r, 2, 3, 4, 5)},
                                       {"begin_norm_axis": 2}, ("X",),
                                       ("Y",)),
        "lrn_n3": ("lrn", {"X": _rand(r, 2, 5, 3, 3)},
                   {"n": 3, "alpha": 1e-4, "beta": 0.75, "k": 1.0},
                   ("X",), ("Out",)),
        "lrn_n5_alexnet": ("lrn", {"X": _rand(r, 2, 7, 4, 4, scale=3.0)},
                           {"n": 5, "alpha": 1e-2, "beta": 0.75, "k": 2.0},
                           ("X",), ("Out",)),
        "pad": ("pad", {"X": _rand(r, 2, 3, 4)},
                {"paddings": [0, 1, 2, 0, 1, 3], "pad_value": 0.5},
                ("X",), ("Out",)),
        "bilinear_interp_up": ("bilinear_interp", {"X": _rand(r, 2, 3, 5, 7)},
                               {"out_h": 10, "out_w": 9}, ("X",), ("Out",)),
        "bilinear_interp_down": ("bilinear_interp",
                                 {"X": _rand(r, 2, 3, 9, 8)},
                                 {"out_h": 4, "out_w": 3}, ("X",),
                                 ("Out",)),
        "max_pool2d_with_index": ("max_pool2d_with_index",
                                  {"X": _rand(r, 2, 3, 6, 6)},
                                  {"ksize": [2, 2], "strides": [2, 2]},
                                  ("X",), ("Out",)),
        "max_pool2d_with_index_pad": ("max_pool2d_with_index", {"X": x4},
                                      {"ksize": [3, 3], "strides": [2, 2],
                                       "paddings": [1, 1]}, ("X",),
                                      ("Out",)),
        "spp_max": ("spp", {"X": x4}, {"pyramid_height": 3,
                                       "pooling_type": "max"}, ("X",),
                    ("Out",)),
        "spp_avg": ("spp", {"X": x4}, {"pyramid_height": 3,
                                       "pooling_type": "avg"}, ("X",),
                    ("Out",)),
        "conv3d": ("conv3d", {"Input": _rand(r, 2, 2, 5, 6, 5),
                              "Filter": _rand(r, 4, 1, 3, 3, 2)},
                   {"strides": [1, 2, 1], "paddings": [1, 1, 0],
                    "dilations": [1, 1, 2], "groups": 2},
                   ("Input", "Filter"), ("Output",)),
        "conv3d_transpose": convt("conv3d_transpose",
                                  _rand(r, 1, 2, 3, 3, 2),
                                  _rand(r, 2, 3, 2, 3, 2),
                                  strides=[2, 1, 2], paddings=[0, 1, 0]),
        "pool3d_max": pool3(_rand(r, 2, 2, 4, 5, 4), pooling_type="max",
                            ksize=[2, 3, 2], strides=[2, 1, 2],
                            paddings=[0, 1, 1]),
        "pool3d_avg_exclusive_pad": pool3(_rand(r, 2, 2, 4, 5, 4),
                                          pooling_type="avg",
                                          ksize=[3, 3, 3],
                                          strides=[1, 2, 1],
                                          paddings=[1, 1, 1]),
        "pool3d_avg_global": pool3(_rand(r, 2, 2, 3, 4, 5),
                                   pooling_type="avg", global_pooling=True),
        "selective_fc": ("selective_fc",
                         {"X": _rand(r, 4, 6), "W": _rand(r, 6, 9),
                          "Selection": r.randint(0, 9, (4, 3))},
                         {}, ("X", "W"), ("Out",)),
        "reshape": ("reshape", {"X": _rand(r, 2, 3, 4, 2)},
                    {"shape": [0, -1, 2]}, ("X",), ("Out",)),
        "transpose": ("transpose", {"X": _rand(r, 2, 3, 4, 2)},
                      {"axis": [0, 2, 3, 1]}, ("X",), ("Out",)),
    }
    return c


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_op_matches_jax(name):
    op, ins, attrs, grad_of, grad_slots = CASES[name]
    want, wgrads = _jax(op, ins, attrs, grad_of, grad_slots)
    got, ggrads, _ = _port(op, ins, attrs, grad_of, grad_slots)
    assert set(got) == set(want), name
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            assert tuple(g.shape) == tuple(np.shape(w)), (slot, g.shape)
            if not g.is_floating_point():
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=slot)
                assert g.dtype == torch.int32, slot
            else:
                _close(g, w, TOL, what=f"{name} {slot}")
    for s in grad_of:
        for g, w in zip(ggrads[s], wgrads[s]):
            _close(g, w, TOL, what=f"{name} d{s}")


def test_batch_norm_running_stats_biased_and_large_mean():
    """MeanOut / VarianceOut are ``mom * old + (1 - mom) * batch`` with
    the biased variance; with |mean| ~ 1e4 >> std ~ 1 the shifted single
    pass keeps the statistics at two-pass accuracy (the JAX test's case)
    and equal to the JAX op's."""
    r = np.random.RandomState(1)
    x = (r.randn(8, 3, 4, 4) + 1e4).astype(np.float32)
    ins = {"X": x, "Scale": np.ones(3, np.float32),
           "Bias": np.zeros(3, np.float32),
           "Mean": np.full(3, 1e4, np.float32),
           "Variance": np.ones(3, np.float32)}
    want, _ = _jax("batch_norm", ins, {})
    got, _, _ = _port("batch_norm", ins, {})
    xd = x.astype(np.float64)
    mu, var = xd.mean(axis=(0, 2, 3)), xd.var(axis=(0, 2, 3))
    _close(got["SavedMean"][0], mu, 1e-3)
    _close(got["SavedVariance"][0], var, 1e-3)
    _close(got["MeanOut"][0], 0.9 * 1e4 + 0.1 * mu, 1e-3)
    _close(got["VarianceOut"][0], 0.9 + 0.1 * var, 1e-3)
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        _close(got[slot][0], want[slot][0], TOL, what=slot)
    # Y = x k + b in fp32 with x ~ 1e4: each side rounds x k and b to
    # ulp(1e4) = 2**-10 (one FMA or two roundings), so Y agrees to 2**-9
    _close(got["Y"][0], want["Y"][0], 2.0 ** -9, what="Y")
    # the unbiased variance (F.batch_norm's running update) is another
    # number at this size: 256 elements a channel
    n = x.size // 3
    assert np.abs(var * n / (n - 1) - var).min() > 1e-3
    assert not any(t.requires_grad for t in got["MeanOut"]
                   + got["VarianceOut"])


def test_batch_norm_float64_distance():
    """At a ResNet stem's batch-norm input (2 x 64 x 32 x 32, mean 0.7,
    std 1.5) the port's Y lies closer to a float64 evaluation than the
    JAX op's on the CPU (measured: 9.3e-7 against 4.4e-6): the two differ
    by the JAX side's own summation error, which ResNet-50's 53 batch
    norms amplify in ``tests/test_torch_image.py``'s notes."""
    r = np.random.RandomState(0)
    x = (r.randn(2, 64, 32, 32) * 1.5 + 0.7).astype(np.float32)
    ins = {"X": x, "Scale": (r.rand(64) + 0.5).astype(np.float32),
           "Bias": r.randn(64).astype(np.float32),
           "Mean": np.zeros(64, np.float32),
           "Variance": np.ones(64, np.float32)}
    want, _ = _jax("batch_norm", ins, {})
    got, _, _ = _port("batch_norm", ins, {})
    xd = x.astype(np.float64)
    m, v = xd.mean((0, 2, 3), keepdims=True), xd.var((0, 2, 3), keepdims=True)
    exact = ((xd - m) / np.sqrt(v + 1e-5) * ins["Scale"].reshape(1, -1, 1, 1)
             + ins["Bias"].reshape(1, -1, 1, 1))
    port_err = np.abs(_np(got["Y"][0]) - exact).max()
    jax_err = np.abs(_np(want["Y"][0]) - exact).max()
    print(f"batch_norm Y from float64: port {port_err:.3e}, JAX {jax_err:.3e}")
    assert port_err <= jax_err and port_err < 2e-6


def test_batch_norm_bf16_x_fp32_scale_matches_jax():
    """A bf16 X meets the fp32 Scale / Bias: Y and dX come back bf16, the
    statistics fp32; held to the JAX op on the same bf16 values."""
    import jax.numpy as jnp
    op, ins, attrs, grad_of, slots = CASES["batch_norm_train"]
    xb = torch.from_numpy(ins["X"]).to(torch.bfloat16)
    info = treg.get_op_info(op)
    tx = xb.clone().requires_grad_(True)
    tins = {"X": [tx], **{s: [torch.from_numpy(ins[s])]
                           for s in ("Scale", "Bias", "Mean", "Variance")}}
    outs = info.compute(tins, dict(info.attrs, **attrs),
                        treg.OpContext(attrs={}))
    assert outs["Y"].dtype == torch.bfloat16
    assert outs["SavedMean"].dtype == torch.float32
    (dx,) = torch.autograd.grad(torch.sum(torch.sin(outs["Y"].float())), tx)
    assert dx.dtype == torch.bfloat16
    jins = dict(ins)
    jins["X"] = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    want, wgrads = _jax(op, jins, attrs, ("X",), ("Y",))
    _close(outs["Y"], want["Y"][0], BF16_TOL)
    _close(outs["SavedVariance"], want["SavedVariance"][0], BF16_TOL)
    _close(dx, wgrads["X"][0], BF16_TOL)


def test_conv2d_amp_bf16_matches_jax():
    """conv2d as AMP runs it (``run_op(amp=True)``: bf16 operands, the
    output cast back to fp32) against the JAX op on the same bf16
    values."""
    import jax.numpy as jnp
    _, ins, attrs, _, _ = CASES["conv2d_pad"]
    outs, _ = treg.run_op("conv2d", {k: [torch.from_numpy(v)]
                                     for k, v in ins.items()}, attrs,
                          amp=True)
    assert outs["Output"][0].dtype == torch.float32
    want, _ = _jax("conv2d", {k: jnp.asarray(v).astype(jnp.bfloat16)
                              for k, v in ins.items()}, attrs)
    _close(outs["Output"][0], np.asarray(want["Output"][0], np.float32),
           BF16_TOL)


def test_unpool_matches_jax():
    """unpool scatters into max_pool2d_with_index's positions: outputs
    and the gradient for X."""
    import jax.numpy as jnp
    r = np.random.RandomState(3)
    x = _rand(r, 2, 3, 6, 6)
    pooled, _ = _jax("max_pool2d_with_index", {"X": x},
                     {"ksize": [2, 2], "strides": [2, 2]})
    ins = {"X": np.asarray(pooled["Out"][0]),
           "Indices": np.asarray(pooled["Mask"][0])}
    attrs = {"ksize": [2, 2], "strides": [2, 2]}
    want, wg = _jax("unpool", {k: jnp.asarray(v) for k, v in ins.items()},
                    attrs, ("X",), ("Out",))
    got, gg, _ = _port("unpool", ins, attrs, ("X",), ("Out",))
    _close(got["Out"][0], want["Out"][0], TOL)
    _close(gg["X"][0], wg["X"][0], TOL)


@pytest.mark.parametrize("nesterov", [False, True],
                         ids=["momentum", "nesterov"])
def test_momentum_matches_jax(nesterov):
    r = np.random.RandomState(4)
    ins = {"Param": _rand(r, 5, 4), "Grad": _rand(r, 5, 4),
           "Velocity": _rand(r, 5, 4), "LearningRate":
           np.array([0.05], np.float32)}
    attrs = {"mu": 0.8, "use_nesterov": nesterov}
    want, _ = _jax("momentum", ins, attrs)
    got, _, _ = _port("momentum", ins, attrs)
    for slot in ("ParamOut", "VelocityOut"):
        _close(got[slot][0], want[slot][0], TOL, what=slot)
    v = 0.8 * ins["Velocity"] + ins["Grad"]
    step = (ins["Grad"] + 0.8 * v) if nesterov else v
    _close(got["ParamOut"][0], ins["Param"] - 0.05 * step, TOL)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("p", [0.3, 0.5])
def test_dropout_statistics(p):
    """Upscale-in-train: kept entries are x / (1 - p), Mask is 1 exactly
    where kept, the keep share is 1 - p within 4 sd, gradients are
    Mask / (1 - p); the same generator seed gives the same draw, another
    seed another; a nonzero ``seed`` attribute fixes the draw whatever
    the Executor's generator."""
    x = np.ones((200, 100), np.float32)
    got, grads, _ = _port("dropout", {"X": x}, {"dropout_prob": p},
                          ("X",), ("Out",), rng=_gen(1))
    out, mask = got["Out"][0].detach().numpy(), got["Mask"][0].numpy()
    assert set(np.unique(mask)) <= {0.0, 1.0}
    np.testing.assert_allclose(out[mask == 1], 1.0 / (1.0 - p), rtol=1e-6)
    assert (out[mask == 0] == 0).all()
    sd = np.sqrt(p * (1 - p) / x.size)
    assert abs(mask.mean() - (1 - p)) < 4 * sd
    np.testing.assert_allclose(grads["X"][0].numpy(),
                               mask * np.cos(out) / (1 - p), rtol=1e-5)
    again, _, _ = _port("dropout", {"X": x}, {"dropout_prob": p},
                        rng=_gen(1))
    other, _, _ = _port("dropout", {"X": x}, {"dropout_prob": p},
                        rng=_gen(2))
    assert torch.equal(again["Mask"][0], got["Mask"][0])
    assert not torch.equal(other["Mask"][0], got["Mask"][0])
    fixed = [_port("dropout", {"X": x}, {"dropout_prob": p, "seed": 7},
                   rng=_gen(s))[0]["Mask"][0] for s in (1, 2)]
    assert torch.equal(fixed[0], fixed[1])


@pytest.mark.parametrize("how", ["is_test_attr", "ctx_is_test", "p0"])
def test_dropout_passes_input(how):
    r = np.random.RandomState(5)
    x = _rand(r, 4, 5)
    attrs = {"dropout_prob": 0.0 if how == "p0" else 0.5}
    if how == "is_test_attr":
        attrs["is_test"] = True
    got, _, _ = _port("dropout", {"X": x}, attrs, rng=_gen(0),
                      is_test=(how == "ctx_is_test"))
    want, _ = _jax("dropout", {"X": x}, attrs,
                   is_test=(how == "ctx_is_test"))
    np.testing.assert_array_equal(got["Out"][0].numpy(), x)
    np.testing.assert_array_equal(got["Mask"][0].numpy(),
                                  np.asarray(want["Mask"][0]))


def test_sampling_id_frequencies():
    """One int32 index a row, drawn in proportion to the row: 4000 rows
    of one distribution give its frequencies within 4 sd; a ``seed``
    attribute fixes the draw."""
    probs = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    x = np.tile(probs, (4000, 1))
    got, _, _ = _port("sampling_id", {"X": x}, {}, rng=_gen(3))
    ids = got["Out"][0]
    assert ids.dtype == torch.int32 and ids.shape == (4000,)
    freq = np.bincount(ids.numpy(), minlength=4) / 4000
    sd = np.sqrt(probs * (1 - probs) / 4000)
    assert (np.abs(freq - probs) <= 4 * sd + 1e-9).all(), freq
    a = _port("sampling_id", {"X": x}, {"seed": 5}, rng=_gen(1))[0]
    b = _port("sampling_id", {"X": x}, {"seed": 5}, rng=_gen(2))[0]
    assert torch.equal(a["Out"][0], b["Out"][0])


def test_op_registrations_match_jax():
    """Every op the JAX package's ``ops/nn.py`` registers is registered
    in the port with the same slots, attributes and flags; so are
    reshape, transpose and momentum."""
    nn_ops = sorted(n for n in jreg.registered_ops()
                    if jreg.get_op_info(n).compute.__module__
                    == "paddle_tpu.ops.nn")
    assert len(nn_ops) == 18, nn_ops
    for op in nn_ops + ["reshape", "transpose", "momentum"]:
        j, t = jreg.get_op_info(op), treg.get_op_info(op)
        assert (tuple(t.inputs), tuple(t.outputs), t.attrs,
                tuple(t.optional_inputs), t.amp_compute, t.needs_rng) == (
            tuple(j.inputs), tuple(j.outputs), j.attrs,
            tuple(j.optional_inputs), j.amp_compute, j.needs_rng), op
        assert t.compute.__module__.startswith("paddle_tpu_torch.ops."), op
    assert {n for n in treg._REGISTRY
            if treg.get_op_info(n).compute.__module__
            == "paddle_tpu_torch.ops.nn"} == set(nn_ops)
