"""The port's ``ops/activation.py`` (all 36 ops of the JAX package's
``ops/activation.py``), the layers DSL's unary wrappers, the registry's
op list, and the three nonfinite cases that once spread differently on
the port (``relu``'s gradient at NaN, ``top_k`` among NaN logits,
``softmax_with_cross_entropy`` on rows holding ±inf and NaN), held
against the JAX package on the CPU.

Each elementwise op runs on a grid of finite values (0, -0, tiny, the
clips' and thresholds' bounds, large) and NaN, +inf and -inf, plus 256
seeded normal values: the forward allclose 1e-6 (the same ``jnp``
expression, so the same special values; the transcendental functions
differ in the last bits), and the vector-Jacobian product with a seeded
cotangent against ``jax.vjp`` allclose 1e-5, NaN where JAX gives NaN.
The row ops (``softmax``, ``log_softmax``, ``maxout``, ``prelu``) are
held the same way on rows holding those values, ties included.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
from paddle_tpu.framework import program as jprog
from paddle_tpu.framework import registry as jreg
import paddle_tpu.ops  # noqa: F401  (registers the JAX ops)

import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.ops import activation as tact

FWD_TOL = 1e-6
GRAD_TOL = 1e-5

GRID = np.array(
    [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-30, -1e-30, 0.5, -0.5, 1.0,
     -1.0, 2.5, -2.5, 3.0, -3.0, 6.0, 24.0, 30.0, -30.0, 40.0, -40.0,
     45.0, -45.0, 100.0, -100.0, 1e30, -1e30], np.float32)

# the ops' non-default attributes each is also held at
ATTR_CASES = {
    "pow": [{"factor": 2.5}, {"factor": 3.0}, {"factor": 0.0},
            {"factor": -1.0}],
    "brelu": [{"t_min": -1.0, "t_max": 2.5}],
    "leaky_relu": [{"alpha": 0.3}],
    "soft_relu": [{"threshold": 3.0}],
    "elu": [{"alpha": 0.5}],
    "relu6": [{"threshold": 2.5}],
    "stanh": [{"scale_a": 1.5, "scale_b": 0.5}],
    "hard_shrink": [{"threshold": 1.0}],
    "thresholded_relu": [{"threshold": 0.5}],
    "hard_sigmoid": [{"slope": 0.5, "offset": 0.25}],
    "swish": [{"beta": 2.0}],
}
ELEMENTWISE = [(n, a) for n in tact.ACTIVATION_OPS
               for a in [{}] + ATTR_CASES.get(n, [])]


class _JCtx:
    def lod(self, *a):
        return None

    def set_lod(self, *a):
        pass


def _jax_vjp(op, arrays, attrs, ct):
    """JAX's outputs and the vjp of ``Out`` with cotangent ``ct`` for each
    float input slot."""
    info = jreg.get_op_info(op)
    full = dict(info.attrs, **attrs)
    slots = list(arrays)

    def f(*xs):
        return info.compute({s: [x] for s, x in zip(slots, xs)}, full,
                            _JCtx())["Out"]

    out, vjp = jax.vjp(f, *[jnp.asarray(arrays[s]) for s in slots])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _torch_vjp(op, arrays, attrs, ct, device="cpu"):
    ins = {s: torch.tensor(a, device=device, requires_grad=True)
           for s, a in arrays.items()}
    outs, _ = treg.run_op(op, {s: [t] for s, t in ins.items()}, attrs)
    out = outs["Out"][0]
    grads = torch.autograd.grad(out, list(ins.values()),
                                torch.tensor(ct, device=device))
    return out.detach().cpu().numpy(), [g.cpu().numpy() for g in grads]


def _check(op, arrays, attrs, seed=0):
    rng = np.random.RandomState(seed)
    jout, jgrads = _jax_vjp(op, arrays, attrs,
                            ct := rng.randn(*_out_shape(op, arrays, attrs))
                            .astype(np.float32))
    tout, tgrads = _torch_vjp(op, arrays, attrs, ct)
    np.testing.assert_allclose(tout, jout, rtol=FWD_TOL, atol=FWD_TOL,
                               err_msg=f"{op} {attrs} forward")
    for s, tg, jg in zip(arrays, tgrads, jgrads):
        np.testing.assert_allclose(tg, jg, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"{op} {attrs} d{s}")


def _out_shape(op, arrays, attrs):
    x = arrays["X"]
    if op == "maxout":
        g = attrs.get("groups", 2)
        return (x.shape[0], x.shape[1] // g) + x.shape[2:]
    return x.shape


@pytest.mark.parametrize("op,attrs", ELEMENTWISE, ids=[
    "-".join([n] + [f"{k}{v}" for k, v in a.items()])
    for n, a in ELEMENTWISE])
def test_elementwise_op_matches_jax(op, attrs):
    """Forward and vjp on the special grid and seeded normal values."""
    rng = np.random.RandomState(7)
    x = np.concatenate([GRID, 3 * rng.randn(256).astype(np.float32)])
    _check(op, {"X": x}, attrs)


def test_registrations_match_jax():
    """Every activation op's slots and attribute defaults equal JAX's."""
    for op in list(tact.ACTIVATION_OPS) + ["softmax", "log_softmax",
                                           "maxout", "prelu"]:
        j, t = jreg.get_op_info(op), treg.get_op_info(op)
        assert tuple(t.inputs) == tuple(j.inputs), op
        assert tuple(t.outputs) == tuple(j.outputs), op
        assert t.attrs == j.attrs, op


ROWS = np.array([[1.0, 2.0, 3.0, 0.5],
                 [1.0, np.inf, 2.0, 0.0],
                 [1.0, -np.inf, 2.0, 0.0],
                 [np.inf, np.inf, 0.0, 1.0],
                 [np.inf, -np.inf, np.nan, 1.0],
                 [1.0, np.nan, 2.0, 3.0],
                 [-np.inf, -np.inf, -np.inf, -np.inf],
                 [5.0, 5.0, -1.0, 5.0],
                 [-100.0, 100.0, 0.0, 30.0]], np.float32)


@pytest.mark.parametrize("op", ["softmax", "log_softmax"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_softmax_family_matches_jax(op, axis):
    """Rows with ±inf, NaN, all -inf and ties; both axes."""
    _check(op, {"X": ROWS}, {"axis": axis})
    rng = np.random.RandomState(3)
    _check(op, {"X": rng.randn(6, 11).astype(np.float32) * 4},
           {"axis": axis})


@pytest.mark.parametrize("groups", [2, 3])
def test_maxout_matches_jax(groups):
    """NCHW groups, with ties (the gradient shared) and NaN / ±inf."""
    rng = np.random.RandomState(groups)
    x = rng.randn(2, 6, 3, 4).astype(np.float32)
    x[0, 1, 0, 0] = x[0, 0, 0, 0]          # a tie inside a group
    x[1, 2, 1, 1] = np.nan
    x[1, 3, 2, 2] = np.inf
    x[0, 4, 1, 3] = -np.inf
    _check("maxout", {"X": x}, {"groups": groups})


@pytest.mark.parametrize("per_channel", [False, True])
def test_prelu_matches_jax(per_channel):
    """A scalar Alpha and one per channel; gradients of X and Alpha."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 4, 2, 5).astype(np.float32)
    x[0, 0, 0, :4] = [np.nan, np.inf, -np.inf, -0.0]
    alpha = (rng.rand(4) if per_channel else rng.rand(1)).astype(np.float32)
    _check("prelu", {"X": x, "Alpha": alpha}, {})


# ------------------------------------------------------------------- C7


def test_relu_gradient_at_nan_is_jaxs():
    """``relu``'s gradient at a NaN input is 0 (JAX's custom JVP); NaN
    still passes forward."""
    x = np.array([np.nan, -1.0, 0.0, 2.0, np.inf, -np.inf], np.float32)
    out, (g,) = _torch_vjp("relu", {"X": x}, {}, np.ones_like(x))
    jout, (jg,) = _jax_vjp("relu", {"X": x}, {}, np.ones_like(x))
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(g, jg)
    assert g[0] == 0.0 and np.isnan(out[0])


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_top_k_nan_and_inf_rows_match_jax(k):
    """Values and indices equal to ``jax.lax.top_k``'s on rows with NaN
    of both signs, ±inf, ±0 and ties; finite rows too."""
    x = np.array([[1.0, np.nan, 3.0, -np.inf, np.inf, np.nan, 2.0],
                  [np.nan, np.nan, 0.0, 0.0, -1.0, np.nan, 5.0],
                  [-0.0, 0.0, 1.0, 1.0, np.nan, np.nan, 2.0],
                  [np.nan] * 7,
                  [4.0, 4.0, 4.0, -4.0, 0.5, -0.0, 0.0]], np.float32)
    x[2, 5] = -np.nan
    x[3, 2] = -np.nan
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    outs, _ = treg.run_op("top_k", {"X": [torch.tensor(x)]}, {"k": k})
    np.testing.assert_array_equal(outs["Out"][0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(outs["Indices"][0].numpy(),
                                  np.asarray(ji))
    assert outs["Indices"][0].dtype == torch.int32
    # the signs of the chosen values too (-0 below +0, -NaN lowest)
    np.testing.assert_array_equal(np.signbit(outs["Out"][0].numpy()),
                                  np.signbit(np.asarray(jv)))


def test_softmax_with_cross_entropy_nonfinite_rows_match_jax():
    """4000 seeded rows mixing finite values, ±inf and NaN: Loss,
    Softmax and the gradient of the summed loss equal JAX's (eager and
    jitted) within 1e-5, NaN where JAX's is NaN."""
    rng = np.random.RandomState(0)
    n, c = 4000, 5
    x = rng.randn(n, c).astype(np.float32)
    sel = rng.randint(0, 6, (n, c))
    x[sel == 0], x[sel == 1], x[sel == 2] = np.inf, -np.inf, np.nan
    lab = rng.randint(0, c, (n, 1)).astype(np.int64)
    info = jreg.get_op_info("softmax_with_cross_entropy")

    def jop(lg):
        o = info.compute({"Logits": [lg],
                          "Label": [jnp.asarray(lab.astype(np.int32))]},
                         {"soft_label": False}, _JCtx())
        return o["Loss"], o["Softmax"]

    t = torch.tensor(x, requires_grad=True)
    outs, _ = treg.run_op("softmax_with_cross_entropy",
                          {"Logits": [t], "Label": [torch.tensor(lab)]})
    (tg,) = torch.autograd.grad(outs["Loss"][0].sum(), [t])
    for fn in (jop, jax.jit(jop)):
        loss, sm = fn(jnp.asarray(x))
        jg = jax.grad(lambda lg: jnp.sum(fn(lg)[0]))(jnp.asarray(x))
        for got, want in ((outs["Loss"][0], loss),
                          (outs["Softmax"][0], sm), (tg, jg)):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=1e-5,
                                       atol=1e-6)


# ---------------------------------------------------------------- layers


def _fresh(mod):
    saved = dict(mod._name_counters)
    mod._name_counters.clear()
    return saved


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_unary_wrappers_are_jaxs_list(side):
    """The DSL exports one wrapper per name of JAX's ``_UNARY_OPS``, and
    ``maxout``."""
    from paddle_tpu import layers as jl
    from paddle_tpu_torch import layers as tl
    for name in jl._UNARY_OPS + ["maxout"]:
        assert name in tl.__all__ and callable(getattr(tl, name)), name
    assert tl._UNARY_OPS == jl._UNARY_OPS


def _build_unary_net(pkg, mod):
    """Each wrapper on ``x``, ``leaky_relu`` with an attribute, ``scalar /
    Variable``, ``fc(act="gelu")`` and ``maxout``: (main, startup, the
    outputs)."""
    saved = _fresh(mod)
    main, start = pkg.Program(), pkg.Program()
    try:
        with pkg.program_guard(main, start):
            x = pkg.layers.data("x", [6, 2, 2])
            outs = [getattr(pkg.layers, name)(x)
                    for name in pkg.layers._UNARY_OPS]
            outs.append(pkg.layers.leaky_relu(x, alpha=0.1))
            outs.append(2.0 / x)
            outs.append(pkg.layers.fc(x, 4, act="gelu"))
            outs.append(pkg.layers.maxout(x, groups=3))
    finally:
        mod._name_counters.clear()
        mod._name_counters.update(saved)
    return main, start, [o.name for o in outs]


def test_wrappers_build_jaxs_op_lists():
    """Every unary wrapper, ``maxout``, ``scalar / Variable`` (through
    ``reciprocal``) and ``fc(act="gelu")`` append the same ops, slots,
    attributes and variables as the JAX DSL."""
    jmain, _, jouts = _build_unary_net(jpt, jprog)
    tmain, _, touts = _build_unary_net(pt, tprog)
    jops = [(o.type, o.inputs, o.outputs, o.attrs)
            for o in jmain.global_block().ops]
    tops = [(o.type, o.inputs, o.outputs, o.attrs)
            for o in tmain.global_block().ops]
    assert tops == jops and touts == jouts
    types = [o[0] for o in tops]
    n = len(pt.layers._UNARY_OPS)
    assert types[:n] == pt.layers._UNARY_OPS
    assert types[n:] == ["leaky_relu", "reciprocal", "scale", "mul",
                         "elementwise_add", "gelu", "maxout"]
    assert sorted(tmain.global_block().vars) == sorted(
        jmain.global_block().vars)


def test_unary_net_runs_like_jax():
    """The wrappers' program through both Executors from one state, on
    values with NaN, ±inf and zeros among them: every output allclose
    1e-5 (NaN where JAX's is)."""
    from paddle_tpu.core.scope import Scope as JScope
    from paddle_tpu_torch.convert import scope_from_jax
    from paddle_tpu_torch.core.scope import Scope
    jmain, jstart, outs = _build_unary_net(jpt, jprog)
    tmain, _, _ = _build_unary_net(pt, tprog)
    js = JScope()
    jexe = jpt.Executor(jpt.CPUPlace())
    jexe.run(jstart, scope=js)
    state = {n: np.asarray(js.find_var(n)) for n in js.local_var_names()}
    ts = scope_from_jax(state, Scope(), device="cpu")
    x = 3 * np.random.RandomState(0).randn(3, 6, 2, 2).astype(np.float32)
    x[0, 0, 0] = [np.nan, np.inf]
    x[0, 1, 0] = [-np.inf, 0.0]
    want = jexe.run(jmain, feed={"x": x}, fetch_list=outs, scope=js)
    got = pt.Executor(pt.CPUPlace()).run(tmain, feed={"x": x},
                                         fetch_list=outs, scope=ts)
    for n, g, w in zip(outs, got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=n)


# -------------------------------------------------------------- registry

# the ops the JAX registry holds that the port has not yet (ROADMAP A
# item 4): this list may only shrink
NOT_PORTED = sorted("""
argmax argsort array_read array_write auc beam_search beam_search_decode
bilinear_tensor_product box_coder chunk_eval clip clip_by_norm conv_shift
cos_sim crf_decoding crop cross_entropy cumsum edit_distance
elementwise_min elementwise_pow equal expand fill_constant_batch_size_like
fill_zeros_like gather greater_equal greater_than gru_unit
hierarchical_sigmoid hinge_loss huber_loss im2sequence iou_similarity
is_empty kmax_seq_score l1_norm l2_normalize less_equal less_than
linear_chain_crf lod_reset log_loss logical_and logical_not logical_or
lstm_unit margin_rank_loss mdlstm modified_huber_loss multiclass_nms
multiplex nce not_equal one_hot positive_negative_pair precision_recall
print prior_box rank_loss reduce_max reduce_mean reduce_min reduce_prod
reduce_sum resize roi_pool rotate row_conv scatter sequence_concat
sequence_erase sequence_expand sequence_reshape sequence_slice
sequence_softmax sigmoid_cross_entropy_with_logits slice smooth_l1_loss
squared_l2_distance squeeze ssd_loss sub_nested_seq sub_seq unsqueeze
warpctc""".split())


def test_registry_is_jaxs_less_the_allowlist():
    """The port's ``registered_ops()`` is the JAX registry's list less
    ``NOT_PORTED`` (86 names), no more and no less."""
    assert len(NOT_PORTED) == 86
    jops = jreg.registered_ops()
    tops = treg.registered_ops()
    assert tops == sorted(tops)
    assert set(NOT_PORTED) <= set(jops)
    assert tops == sorted(set(jops) - set(NOT_PORTED))
    assert len(tops) == 104
