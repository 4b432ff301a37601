"""The port's fused LSTM (B10/B11 ``lstm_scan``, B14/B15
``lstm_scan_proj``) and its ops (``dynamic_lstm``, ``fused_lstm``), held
against the JAX package.

The same numpy inputs (``tests/test_fused_rnn.py``'s shapes: B 8, T 7,
D 128, E 128; ragged lengths including 0 and T) go through the JAX
Pallas kernels in interpret mode (``_lstm_fwd_call``, ``_lstm_bwd_call``,
``_lstm_proj_fwd_call``, ``_lstm_proj_bwd_call``, the scans' custom
VJPs) and through the port on the CPU, where the wrappers run their
plain versions:

- fp32 kernels: atol 1e-5 (the same fp32 math, sums in another order);
  the backward from the same saved tensors, and the gradients of
  ``sum(sin(hs)) + sum(cos(cs))/2`` through the ``autograd.Function``s
  for every input: atol 1e-5 + rtol 1e-5 (dW sums 56 rows of O(1)
  products);
- bf16 (as the GRU's): hs, cs and gates atol 2e-2 (one bf16 ulp at
  |v| <= 2: both round the same fp32 carry once); dx, dxe, dh0, dc0 atol
  5e-2; dW, dWx and db rtol 2e-2 + atol 0.1 (a bf16 ulp of |dW| <= 16:
  JAX sums bf16 partials per batch tile, the port over all rows at
  once);
- a two-tile batch (B 256: the Pallas kernel runs two 128-row tiles and
  sums their dW, dWx and db partials) in fp32, T 3.

The ops go through ``paddle_tpu.framework.registry.get_op_info(...)
.compute`` on the JAX side (its kernel route forced on the CPU with
``FORCE_FOR_TESTS``, as ``tests/test_fused_rnn.py`` does) and the
port's registry on the other, from the same packed inputs and LoD:
outputs atol 1e-5 (fp32) / 2e-2 (bf16), gradients atol 1e-4.

B14/B15's resident route (bf16: xg = xe @ Wx + b for every step in
fp32, the recurrence, then dxe = dx @ Wx^T) as plain PyTorch
(``lstm_proj_xg`` / ``lstm_cluster_fwd`` / ``lstm_cluster_bwd`` /
``lstm_proj_dxe`` on the CPU) against the same JAX calls, both lanes at
the same tolerances; in the bf16 lane, xg rounded to bf16 would move
12-30 % of the gates off JAX's bits, against under 0.1 % in fp32; and
``lstm_cluster_plan``'s route and tile at B 1 / 17 / 128 / 130, D 64 /
96 / 512 / 1024 (bf16 D 1024: the grid route), both dtypes.

B10/B11 on the same resident recurrences (bf16; T 8, B 16, D 64, ragged
lengths with 0, and uniform): B10's plain version on bf16 x equals the
resident forward's (``lstm_cluster_fwd_reference``) on float(x) bit for
bit, B11's recurrence the resident reverse's dx, dh0 and dc0, and both
equal JAX ``_lstm_fwd_call`` / ``_lstm_bwd_call`` at the bf16
tolerances; their route as ``lstm_cluster_plan``'s for the call's one
dtype, a mixed-dtype call raising before any route is chosen.

The kernel-vs-plain cases need a card and skip without one.
"""
import contextlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.core.lod import LoD
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.kernels import fused_rnn as tfr

B, T, D, E = 8, 7, 128, 128
TOL = 1e-5
BF16_FWD_TOL = 2e-2
BF16_GRAD_TOL = 5e-2
OP_GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def jfr():
    pytest.importorskip("jax")
    from paddle_tpu.kernels import fused_rnn
    return fused_rnn


def _inputs(seed=1, B=B, T=T, D=D, E=E):
    """The LSTM inputs as in tests/test_fused_rnn.py, lens ragged with 0
    and T; dhs, dcs upstream gradients; xe, wx, b the projection's."""
    rng = np.random.RandomState(seed)
    f = np.float32
    x = rng.randn(T, B, 4 * D).astype(f) * 0.5
    w = rng.randn(D, 4 * D).astype(f) * 0.1
    h0 = rng.randn(B, D).astype(f) * 0.3
    c0 = rng.randn(B, D).astype(f) * 0.3
    lens = rng.randint(1, T + 1, (B, 1)).astype(f)
    lens[0], lens[-1] = 0, T
    dhs = rng.randn(T, B, D).astype(f)
    dcs = rng.randn(T, B, D).astype(f)
    xe = rng.randn(T, B, E).astype(f) * 0.5
    wx = rng.randn(E, 4 * D).astype(f) * 0.1
    b = rng.randn(4 * D).astype(f) * 0.1
    return dict(x=x, w=w, lens=lens, h0=h0, c0=c0, dhs=dhs, dcs=dcs, xe=xe,
                wx=wx, b=b)


def _j(a, bf16=False):
    import jax.numpy as jnp
    lp = bf16 and a.dtype == np.float32 and a.shape[-1] != 1
    return jnp.asarray(a, jnp.bfloat16 if lp else a.dtype)


def _t(a, bf16=False):
    lp = bf16 and a.shape[-1] != 1
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16 if lp else torch.float32)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _from_jax(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close_grads(got, want, names, bf16):
    for g, w_, name in zip(got, want, names):
        if not bf16:
            _close(g, w_, TOL, TOL, what=name)
        elif name in ("dw", "dwx", "db"):
            _close(g, w_, 0.1, rtol=2e-2, what=name)
        else:
            _close(g, w_, BF16_GRAD_TOL, what=name)


# ------------------------------------------------------ kernels vs JAX

@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_forward_matches_jax_fwd_call(jfr, bf16):
    a = _inputs()
    args = ("x", "w", "lens", "h0", "c0")
    want = jfr._lstm_fwd_call(*(_j(a[k], bf16) for k in args),
                              interpret=True)
    got = tfr.lstm_fwd(*(_t(a[k], bf16) for k in args))
    dt = torch.bfloat16 if bf16 else torch.float32
    for g, w_, name in zip(got, want, ("hs", "cs", "gates")):
        assert g.dtype == dt, name
        _close(g, w_, BF16_FWD_TOL if bf16 else TOL, what=name)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_backward_matches_jax_bwd_call(jfr, bf16):
    """Each side's backward from the same (JAX) saved gates, hs and cs;
    the bf16 lane recomputes c~ from the bf16 cs, as JAX does."""
    a = _inputs()
    j = {k: _j(v, bf16) for k, v in a.items()}
    jhs, jcs, jg = jfr._lstm_fwd_call(j["x"], j["w"], j["lens"], j["h0"],
                                      j["c0"], interpret=True)
    want = jfr._lstm_bwd_call(jg, jhs, jcs, j["w"], j["lens"], j["h0"],
                              j["c0"], j["dhs"], j["dcs"], interpret=True)
    dt = torch.bfloat16 if bf16 else torch.float32
    g, hs, cs = (_from_jax(v, dt) for v in (jg, jhs, jcs))
    t = {k: _t(v, bf16) for k, v in a.items()}
    got = tfr.lstm_bwd(g, hs, cs, t["w"], t["lens"], t["h0"], t["c0"],
                       t["dhs"], t["dcs"])
    assert all(v.dtype == dt for v in got)
    _close_grads(got, want, ("dx", "dw", "dh0", "dc0"), bf16)
    # the halves the wrapper is made of
    dx, dh0, dc0 = tfr.lstm_bwd_data(g, cs, t["w"], t["lens"], t["h0"],
                                     t["c0"], t["dhs"], t["dcs"])
    assert torch.equal(dx, got[0]) and torch.equal(dh0, got[2])
    assert torch.equal(tfr.lstm_dw(hs, t["h0"], dx), got[1])


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_proj_forward_matches_jax(jfr, bf16):
    a = _inputs()
    args = ("xe", "wx", "b", "w", "lens", "h0", "c0")
    want = jfr._lstm_proj_fwd_call(*(_j(a[k], bf16) for k in args),
                                   interpret=True)
    got = tfr.lstm_proj_fwd(*(_t(a[k], bf16) for k in args))
    for g, w_, name in zip(got, want, ("hs", "cs", "gates")):
        _close(g, w_, BF16_FWD_TOL if bf16 else TOL, what=name)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_proj_backward_matches_jax(jfr, bf16):
    """B15 from the same saved tensors: dxe, dWx, db (fp32: the sum of
    the unrounded dgates), dW, dh0, dc0."""
    a = _inputs()
    j = {k: _j(v, bf16) for k, v in a.items()}
    jhs, jcs, jg = jfr._lstm_proj_fwd_call(
        j["xe"], j["wx"], j["b"], j["w"], j["lens"], j["h0"], j["c0"],
        interpret=True)
    want = jfr._lstm_proj_bwd_call(
        j["xe"], jg, jhs, jcs, j["wx"], j["w"], j["lens"], j["h0"], j["c0"],
        j["dhs"], j["dcs"], interpret=True)
    dt = torch.bfloat16 if bf16 else torch.float32
    g, hs, cs = (_from_jax(v, dt) for v in (jg, jhs, jcs))
    t = {k: _t(v, bf16) for k, v in a.items()}
    got = tfr.lstm_proj_bwd(t["xe"], g, hs, cs, t["wx"], t["w"], t["lens"],
                            t["h0"], t["c0"], t["dhs"], t["dcs"])
    assert got[2].dtype == torch.float32                 # db
    _close_grads(got, want, ("dxe", "dwx", "db", "dw", "dh0", "dc0"), bf16)


def _hoisted_fwd(t, xg_dtype=torch.float32):
    """The resident route's forward as its plain parts: xg for every step
    (kept in ``xg_dtype``), then the recurrence."""
    xg = tfr.lstm_proj_xg(t["xe"], t["wx"], t["b"])
    return tfr.lstm_cluster_fwd(xg.to(xg_dtype).float(), t["w"], t["lens"],
                                t["h0"], t["c0"])


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_hoisted_forward_matches_jax(jfr, bf16):
    """xe @ Wx + b out of the loop (fp32), then the recurrence, equals
    ``_lstm_proj_fwd_call``, which adds it inside each step."""
    a = _inputs()
    args = ("xe", "wx", "b", "w", "lens", "h0", "c0")
    want = jfr._lstm_proj_fwd_call(*(_j(a[k], bf16) for k in args),
                                   interpret=True)
    got = _hoisted_fwd({k: _t(a[k], bf16) for k in args})
    for g, w_, name in zip(got, want, ("hs", "cs", "gates")):
        _close(g, w_, BF16_FWD_TOL if bf16 else TOL, what=name)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_hoisted_backward_matches_jax(jfr, bf16):
    """The reverse recurrence without dxe (dx, db, dh0, dc0), then dxe =
    dx @ Wx^T for every step from the rounded dgates, then the dW
    reductions, equal ``_lstm_proj_bwd_call`` from the same saved
    tensors."""
    a = _inputs()
    j = {k: _j(v, bf16) for k, v in a.items()}
    jhs, jcs, jg = jfr._lstm_proj_fwd_call(
        j["xe"], j["wx"], j["b"], j["w"], j["lens"], j["h0"], j["c0"],
        interpret=True)
    want = jfr._lstm_proj_bwd_call(
        j["xe"], jg, jhs, jcs, j["wx"], j["w"], j["lens"], j["h0"], j["c0"],
        j["dhs"], j["dcs"], interpret=True)
    dt = torch.bfloat16 if bf16 else torch.float32
    g, hs, cs = (_from_jax(v, dt) for v in (jg, jhs, jcs))
    t = {k: _t(v, bf16) for k, v in a.items()}
    dx, db, dh0, dc0 = tfr.lstm_cluster_bwd(g, cs, t["w"], t["lens"],
                                            t["h0"], t["c0"], t["dhs"],
                                            t["dcs"])
    dxe = tfr.lstm_proj_dxe(dx, t["wx"])
    dwx, dw = tfr.lstm_proj_dw(t["xe"], hs, t["h0"], dx)
    assert db.dtype == torch.float32 and dxe.dtype == dt
    _close_grads((dxe, dwx, db, dw, dh0, dc0), want,
                 ("dxe", "dwx", "db", "dw", "dh0", "dc0"), bf16)


def test_xg_kept_in_fp32_keeps_the_gates_on_jax_bits(jfr):
    """Why the pre-pass stores xg in fp32: rounded to bf16 it would move
    12-30 % of the bf16 gates (hs, cs) off JAX's values by an ulp, where
    the fp32 xg leaves under 0.1 % of them off."""
    args = ("xe", "wx", "b", "w", "lens", "h0", "c0")
    for seed in (1, 2):
        a = _inputs(seed=seed)
        want = jfr._lstm_proj_fwd_call(*(_j(a[k], True) for k in args),
                                       interpret=True)
        t = {k: _t(a[k], True) for k in args}
        for xg_dtype, lo, hi in ((torch.float32, 0.0, 1e-3),
                                 (torch.bfloat16, 0.05, 1.0)):
            got = _hoisted_fwd(t, xg_dtype)
            for g, w_, name in zip(got, want, ("hs", "cs", "gates")):
                off = float((_np(g) != np.asarray(w_, np.float32)).mean())
                assert lo <= off <= hi, (seed, xg_dtype, name, off)


def _small(seed, ragged):
    """B10/B11's resident-route cases cut down: T 8, B 16, D 64, lengths
    0..T with 0 and T present, or all T."""
    a = _inputs(seed=seed, B=16, T=8, D=64, E=64)
    if not ragged:
        a["lens"][:] = 8
    return a


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "uniform"])
def test_b10_is_the_resident_forward_on_float_x(jfr, ragged):
    """B10 on bf16 x is B14's resident recurrence on xg = float(x) bit for
    bit (widening bf16 to fp32 is exact; the step adds h_lp W to it in
    fp32 either way), so the cluster kernel serves both; and both equal
    ``_lstm_fwd_call``."""
    a = _small(21, ragged)
    names = ("x", "w", "lens", "h0", "c0")
    t = {k: _t(a[k], True) for k in names}
    args = (t["w"], t["lens"], t["h0"], t["c0"])
    b10 = tfr.lstm_fwd_reference(t["x"], *args)
    resident = tfr.lstm_cluster_fwd_reference(t["x"].float(), *args)
    assert all(torch.equal(p, q) for p, q in zip(b10, resident))
    assert all(torch.equal(p, q)
               for p, q in zip(tfr.lstm_fwd(t["x"], *args), b10))
    want = jfr._lstm_fwd_call(*(_j(a[k], True) for k in names),
                              interpret=True)
    for g, w_, name in zip(b10, want, ("hs", "cs", "gates")):
        assert g.dtype == torch.bfloat16, name
        _close(g, w_, BF16_FWD_TOL, what=name)


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "uniform"])
def test_b11_is_the_resident_reverse_without_db(jfr, ragged):
    """B11's recurrence is B15's resident reverse without db: dx (the
    dgates in the gates' dtype), dh0 and dc0 bit for bit, from the same
    (JAX) saved tensors; and both, with B11's dW, equal
    ``_lstm_bwd_call``."""
    a = _small(22, ragged)
    j = {k: _j(v, True) for k, v in a.items()}
    jhs, jcs, jg = jfr._lstm_fwd_call(j["x"], j["w"], j["lens"], j["h0"],
                                      j["c0"], interpret=True)
    want = jfr._lstm_bwd_call(jg, jhs, jcs, j["w"], j["lens"], j["h0"],
                              j["c0"], j["dhs"], j["dcs"], interpret=True)
    g, hs, cs = (_from_jax(v, torch.bfloat16) for v in (jg, jhs, jcs))
    t = {k: _t(v, True) for k, v in a.items()}
    bargs = (g, cs, t["w"], t["lens"], t["h0"], t["c0"], t["dhs"], t["dcs"])
    b11 = tfr.lstm_bwd_data_reference(*bargs)
    dx, db, dh0, dc0 = tfr.lstm_cluster_bwd_reference(*bargs)
    assert db.dtype == torch.float32
    assert all(torch.equal(p, q) for p, q in zip(b11, (dx, dh0, dc0)))
    assert all(torch.equal(p, q)
               for p, q in zip(tfr.lstm_bwd_data(*bargs), b11))
    _close_grads((b11[0], tfr.lstm_dw_reference(hs, t["h0"], b11[0]),
                  b11[1], b11[2]), want, ("dx", "dw", "dh0", "dc0"), True)


_BF, _F32 = torch.bfloat16, torch.float32
# (the call's dtype, B, D, co-resident clusters) -> B10/B11's route
_ROUTES = {
    "bf16-b128-d512": (_BF, 128, 512, 7, "resident"),
    "bf16-b130-d512": (_BF, 130, 512, 7, "resident"),
    "bf16-b16-d64": (_BF, 16, 64, None, "resident"),
    "bf16-d1024": (_BF, 128, 1024, None, "grid"),
    "bf16-d80": (_BF, 8, 80, None, "streaming"),
    "bf16-no-cluster": (_BF, 128, 512, 0, "streaming"),
    "fp32-d512": (_F32, 128, 512, 7, "grid"),
}


@pytest.mark.parametrize("case", list(_ROUTES))
def test_lstm_route_is_the_plan_of_the_calls_dtype(case):
    """``lstm_fwd`` / ``lstm_bwd_data`` take the route of
    ``lstm_cluster_plan`` (the plan B14/B15 use) for the call's one
    dtype: resident in bf16 where the shape fits a cluster, grid where W
    needs a group of clusters (bf16 D 1024, fp32 D 512), else
    streaming."""
    dtype, B_, D_, mc, route = _ROUTES[case]
    assert tfr.lstm_cluster_plan(dtype, B_, D_, 132, mc).route == route


@pytest.mark.parametrize("which", ["fwd-w", "fwd-h0", "fwd-c0",
                                   "bwd-w", "bwd-h0", "bwd-c0"])
def test_lstm_wrappers_take_one_dtype_before_routing(which):
    """A call with one fp32 tensor among bf16 ones raises before any
    route is chosen, so the plan of the first tensor's dtype is the
    call's (the card path also holds cs, dhs and dcs to the gates'
    dtype: the card test of mixed inputs)."""
    t = {k: _t(v, bf16=True) for k, v in _inputs(B=4, T=3, D=64).items()}
    kind, name = which.split("-")
    t[name] = t[name].float()
    with pytest.raises((TypeError, ValueError), match="dtype|must match"):
        if kind == "fwd":
            tfr.lstm_fwd(t["x"], t["w"], t["lens"], t["h0"], t["c0"])
        else:
            tfr.lstm_bwd_data(t["x"], t["h0"].new_zeros((3, 4, 64)), t["w"],
                              t["lens"], t["h0"], t["c0"], t["dhs"],
                              t["dcs"])


# (dtype, B, D) -> (route, bb, clusters) with the H100's 7 co-resident
# 16-CTA clusters at D 512 and n_sm // (D / 32) elsewhere; bf16 D 1024
# and fp32 D 512 take the grid route (n_sm // 16 clusters of 16 CTAs by
# default)
_PLAN_B = (1, 17, 128, 130)
_PLAN_D = (64, 96, 512, 1024)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D_", _PLAN_D)
@pytest.mark.parametrize("B_", _PLAN_B)
def test_cluster_plan_route_and_tile(dtype, D_, B_):
    mc = 7 if D_ == 512 else None
    plan = tfr.lstm_cluster_plan(dtype, B_, D_, 132, mc)
    if dtype == torch.float32 and D_ == 512:
        # W over a group of 4 clusters of 8-unit CTAs, 128-row tiles
        assert plan == tfr.ClusterPlan("grid", 128, 16, -(-B_ // 128), 7,
                                       170496, 8, 4)
        return
    if dtype == torch.float32:
        assert plan == tfr.ClusterPlan("streaming", 0, 0, 0, 0, 0)
        return
    if D_ > 512:     # W over a group of 4 clusters, 128-row tiles
        assert plan == tfr.ClusterPlan("grid", 128, 16, -(-B_ // 128),
                                       132 // 16, 187392, 16, 4)
        return
    nc = D_ // 32
    assert plan.route == "resident" and plan.cluster == nc
    assert plan.max_clusters == (7 if D_ == 512 else 132 // nc)
    # 16-row tiles while ceil(B / 16) clusters fit at once, else 32
    bb = 16 if -(-B_ // 16) <= plan.max_clusters else 32
    assert (plan.bb, plan.tiles) == (bb, -(-B_ // bb))
    assert plan.smem <= tfr.SMEM_LIMIT


def test_cluster_plan_limits():
    """The CTAs' shared memory as csrc/fused_rnn.cu's rc::fwd_smem /
    bwd_smem count it; no cluster on the card, or a D that is no
    multiple of 32, streams."""
    assert tfr._rec_smem("fwd", 16, 512) == 175616
    assert tfr._rec_smem("fwd", 32, 512) == 218112
    assert tfr._rec_smem("bwd", 16, 512) == 170240
    assert tfr._rec_smem("bwd", 32, 512) == 207360
    bf = torch.bfloat16
    assert tfr.lstm_cluster_plan(bf, 128, 512, 132, 0).route == \
        "streaming"
    assert tfr.lstm_cluster_plan(bf, 128, 80).route == "streaming"
    assert tfr.lstm_cluster_plan(bf, 128, 32).cluster == 1
    assert tfr.lstm_cluster_plan(bf, 2000, 512, 132, 7) == \
        tfr.ClusterPlan("resident", 32, 16, 63, 7, 218112)


def _jax_scan_grads(jfr, proj, a, bf16=False):
    import jax
    import jax.numpy as jnp
    j = {k: _j(v, bf16) for k, v in a.items()}

    def loss(*diff):
        if proj:
            xe, wx, b, w, h0, c0 = diff
            hs, cs = jfr.lstm_scan_proj(xe, wx, b, w, j["lens"], h0, c0,
                                        interpret=True)
        else:
            x, w, h0, c0 = diff
            hs, cs = jfr.lstm_scan(x, w, j["lens"], h0, c0, interpret=True)
        return (jnp.sum(jnp.sin(hs.astype(jnp.float32)))
                + 0.5 * jnp.sum(jnp.cos(cs.astype(jnp.float32))))

    names = _diff_names(proj)
    val, grads = jax.value_and_grad(loss, argnums=tuple(range(len(names))))(
        *(j[k] for k in names))
    return float(val), grads


def _diff_names(proj):
    return (("xe", "wx", "b", "w", "h0", "c0") if proj
            else ("x", "w", "h0", "c0"))


def _port_scan_grads(proj, a, bf16=False):
    names = _diff_names(proj)
    live = {k: _t(a[k], bf16).requires_grad_() for k in names}
    lens = _t(a["lens"])
    if proj:
        hs, cs = tfr.lstm_scan_proj(live["xe"], live["wx"], live["b"],
                                    live["w"], lens, live["h0"], live["c0"])
    else:
        hs, cs = tfr.lstm_scan(live["x"], live["w"], lens, live["h0"],
                               live["c0"])
    loss = (torch.sum(torch.sin(hs.float()))
            + 0.5 * torch.sum(torch.cos(cs.float())))
    return float(loss.detach()), torch.autograd.grad(loss, list(
        live.values()))


@pytest.mark.parametrize("proj", [False, True], ids=["scan", "scan_proj"])
@pytest.mark.parametrize("shape", [(B, T), (256, 3)], ids=["b8", "b256"])
def test_autograd_grads_match_jax(jfr, proj, shape):
    """Every input's gradient through the custom VJPs; B 256 runs the
    Pallas kernels as two batch tiles whose weight partials are
    summed."""
    Bn, Tn = shape
    a = _inputs(seed=9, B=Bn, T=Tn)
    j_val, j_grads = _jax_scan_grads(jfr, proj, a)
    val, grads = _port_scan_grads(proj, a)
    assert abs(val - j_val) <= 1e-5 * max(1.0, abs(j_val))
    for g, w_, name in zip(grads, j_grads, _diff_names(proj)):
        _close(g, w_, TOL, TOL, what=name)


@pytest.mark.parametrize("proj", [False, True], ids=["scan", "scan_proj"])
def test_bf16_autograd_grads_match_jax(jfr, proj):
    a = _inputs(seed=4)
    j_val, j_grads = _jax_scan_grads(jfr, proj, a, bf16=True)
    val, grads = _port_scan_grads(proj, a, bf16=True)
    assert abs(val - j_val) <= 2e-2 * max(1.0, abs(j_val))
    for g, w_, name in zip(grads, j_grads, _diff_names(proj)):
        assert g.dtype == torch.bfloat16, name
        if name in ("w", "wx", "b"):
            _close(g, w_, 0.1, rtol=2e-2, what=name)
        else:
            _close(g, w_, BF16_GRAD_TOL, what=name)


def test_zero_length_rows_keep_state_and_get_no_gradient():
    t = {k: _t(v) for k, v in _inputs().items()}
    for proj in (False, True):
        if proj:
            hs, cs, g = tfr.lstm_proj_fwd(t["xe"], t["wx"], t["b"], t["w"],
                                          t["lens"], t["h0"], t["c0"])
            dx = tfr.lstm_proj_bwd_data(g, cs, t["wx"], t["w"], t["lens"],
                                        t["h0"], t["c0"], t["dhs"],
                                        t["dcs"])[1]
        else:
            hs, cs, g = tfr.lstm_fwd(t["x"], t["w"], t["lens"], t["h0"],
                                     t["c0"])
            dx = tfr.lstm_bwd_data(g, cs, t["w"], t["lens"], t["h0"],
                                   t["c0"], t["dhs"], t["dcs"])[0]
        for s in range(T):                       # lens[0] == 0
            assert torch.equal(hs[s, 0], t["h0"][0])
            assert torch.equal(cs[s, 0], t["c0"][0])
        assert not dx[:, 0].any()


def test_plain_versions_switch_and_cpu_path_count_no_launches():
    a = _inputs()
    before = dict(tk.LAUNCHES)
    for proj in (False, True):
        va, ga = _port_scan_grads(proj, a)
        with tfr.plain_versions():
            vb, gb = _port_scan_grads(proj, a)
        assert va == vb
        assert all(torch.equal(p, q) for p, q in zip(ga, gb))
    assert tk.LAUNCHES == before
    assert not tfr._plain[0]


def test_bad_inputs_raise():
    t = {k: _t(v) for k, v in _inputs().items()}
    with pytest.raises(ValueError, match="do not agree"):
        tfr.lstm_fwd(t["x"], t["w"], t["lens"][:4], t["h0"], t["c0"])
    with pytest.raises(ValueError, match=r"\[D, 4D\]"):
        tfr.lstm_fwd(t["x"], t["w"][:, :100], t["lens"], t["h0"], t["c0"])
    with pytest.raises(ValueError, match="c0"):
        tfr.lstm_fwd(t["x"], t["w"], t["lens"], t["h0"], t["c0"][:4])
    with pytest.raises(TypeError, match="one dtype"):
        tfr.lstm_proj_fwd(t["xe"], t["wx"].to(torch.bfloat16), t["b"],
                          t["w"], t["lens"], t["h0"], t["c0"])
    with pytest.raises(ValueError, match="do not agree"):
        tfr.lstm_proj_fwd(t["xe"], t["wx"], t["b"][:8], t["w"], t["lens"],
                          t["h0"], t["c0"])
    with pytest.raises(NotImplementedError, match="B10/B11"):
        tfr.lstm_scan(t["x"], t["w"], t["lens"], t["h0"], t["c0"],
                      layout="bt")
    with pytest.raises(NotImplementedError, match="A9"):
        tfr.lstm_scan_dp(t["x"], t["w"], t["lens"], t["h0"], t["c0"],
                         mesh=None, data_axis="data")


# ---------------------------------------------------------- ops vs JAX

@pytest.fixture
def jax_kernel_route(jfr, monkeypatch):
    """The JAX ops' fused route on the CPU (Pallas interpret), as
    tests/test_fused_rnn.py forces it."""
    monkeypatch.setattr(jfr, "FORCE_FOR_TESTS", True)


def _op_case(seed, lens, D=D, E=None, bf16=False):
    """Packed op inputs for ``lens``: Input [total, 4D] (dynamic_lstm)
    or [total, E] (fused_lstm), Weight, WeightX, Bias, H0, C0."""
    rng = np.random.RandomState(seed)
    f = np.float32
    total, nb = int(sum(lens)), len(lens)
    width = 4 * D if E is None else E
    case = {"Input": rng.randn(total, width).astype(f) * 0.5,
            "Weight": rng.randn(D, 4 * D).astype(f) * 0.1,
            "Bias": rng.randn(1, 4 * D).astype(f) * 0.1,
            "H0": rng.randn(nb, D).astype(f) * 0.3,
            "C0": rng.randn(nb, D).astype(f) * 0.3}
    if E is not None:
        case["WeightX"] = rng.randn(E, 4 * D).astype(f) * 0.1
    return case


def _run_jax_op(op, case, lens, attrs, slots, grad_of=()):
    """The JAX op's outputs (and, for the slots in ``grad_of``, the
    gradients of sum(sin(Hidden)) + sum(cos(Cell))/2) as numpy."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core.lod import LoD as JLoD
    from paddle_tpu.framework import registry as jreg
    info = jreg.get_op_info(op)
    full = dict(info.attrs, **attrs)
    lod = JLoD.from_lengths([list(lens)])

    def run(diff):
        ins = {s: [diff[s] if s in diff else jnp.asarray(case[s])]
               for s in slots}
        ctx = jreg.OpContext(attrs=full, in_lods={"Input": [lod]})
        out = info.compute(ins, full, ctx)
        return out["Hidden"], out["Cell"]

    base = {s: jnp.asarray(case[s]) for s in grad_of}
    hs, cs = run(base)
    grads = ()
    if grad_of:
        def loss(d):
            h, c = run(d)
            return (jnp.sum(jnp.sin(h.astype(jnp.float32)))
                    + 0.5 * jnp.sum(jnp.cos(c.astype(jnp.float32))))
        g = jax.grad(loss)(base)
        grads = tuple(np.asarray(g[s], np.float32) for s in grad_of)
    return np.asarray(hs, np.float32), np.asarray(cs, np.float32), grads


def _run_port_op(op, case, lens, attrs, slots, grad_of=()):
    info = treg.get_op_info(op)
    full = dict(info.attrs, **attrs)
    live = {s: torch.from_numpy(case[s]).requires_grad_(s in grad_of)
            for s in slots}
    ctx = treg.OpContext(attrs=full,
                         in_lods={"Input": [LoD.from_lengths([list(lens)])]})
    out = info.compute({s: [live[s]] for s in slots}, full, ctx)
    hs, cs = out["Hidden"], out["Cell"]
    assert ctx.out_lods["Hidden"][0] == LoD.from_lengths([list(lens)])
    grads = ()
    if grad_of:
        loss = (torch.sum(torch.sin(hs.float()))
                + 0.5 * torch.sum(torch.cos(cs.float())))
        grads = torch.autograd.grad(loss, [live[s] for s in grad_of])
    return hs, cs, grads


UNIFORM = [T] * B
RAGGED = [1, 7, 3, 5, 7, 2, 6, 4]          # a length-1 sequence included


def _case_slots(case, seq_lens=None, h0=False):
    slots = [s for s in ("Input", "WeightX", "Weight", "Bias") if s in case]
    if h0:
        slots += ["H0", "C0"]
    if seq_lens is not None:
        case["SeqLens"] = np.asarray(seq_lens, np.int32)
        slots.append("SeqLens")
    return slots


# (op, lens, is_reverse, SeqLens, H0/C0, the port's route)
OP_CASES = {
    "dyn-uniform": ("dynamic_lstm", UNIFORM, False, None, False, "kernel"),
    "dyn-ragged-reverse-h0": ("dynamic_lstm", RAGGED, True, None, True,
                              "kernel"),
    "dyn-seqlens": ("dynamic_lstm", UNIFORM, False, [7, 1, 3, 5, 7, 2, 6, 4],
                    False, "kernel"),
    "fused-proj-h0": ("fused_lstm", UNIFORM, False, None, True, "proj"),
    "fused-proj-seqlens": ("fused_lstm", UNIFORM, False,
                           [7, 1, 3, 5, 7, 2, 6, 4], False, "proj"),
    "fused-ragged": ("fused_lstm", RAGGED, False, None, False, "kernel"),
    "fused-reverse": ("fused_lstm", UNIFORM, True, None, True, "kernel"),
}


@pytest.mark.parametrize("name", list(OP_CASES))
def test_op_matches_jax(jax_kernel_route, monkeypatch, name):
    """Each op and route against the JAX op's compute, the JAX side's
    fused kernels forced: Hidden and Cell, and the gradients of Input,
    the weights and H0/C0."""
    op, lens, rev, seq_lens, h0, route = OP_CASES[name]
    case = _op_case(3, lens, E=E if op == "fused_lstm" else None)
    slots = _case_slots(case, seq_lens, h0)
    grad_of = tuple(s for s in slots if s != "SeqLens")
    attrs = {"is_reverse": rev}
    j_hs, j_cs, j_g = _run_jax_op(op, case, lens, attrs, slots, grad_of)
    before = dict(tk.LAUNCHES)
    scan = {"kernel": tfr._LstmScan, "proj": tfr._LstmScanProj}[route]
    calls = []
    orig = scan.apply
    monkeypatch.setattr(scan, "apply",
                        lambda *a: (calls.append(route), orig(*a))[1])
    hs, cs, grads = _run_port_op(op, case, lens, attrs, slots, grad_of)
    assert calls == [route]                 # the route the JAX op takes
    assert tk.LAUNCHES == before            # CPU: the plain versions
    _close(hs, j_hs, TOL, what="Hidden")
    _close(cs, j_cs, TOL, what="Cell")
    for g, w_, s in zip(grads, j_g, grad_of):
        _close(g, w_, OP_GRAD_TOL, what=s)


@pytest.mark.parametrize("op", ["dynamic_lstm", "fused_lstm"])
def test_op_bf16_matches_jax(jax_kernel_route, op):
    """bf16 inputs (the AMP lane): both sides round the same fp32 carry
    once into bf16 outputs."""
    case = _op_case(5, RAGGED if op == "dynamic_lstm" else UNIFORM,
                    E=E if op == "fused_lstm" else None)
    lens = RAGGED if op == "dynamic_lstm" else UNIFORM
    slots = _case_slots(case, h0=True)
    j_case = {s: np.asarray(_j(v, bf16=True)) for s, v in case.items()}
    j_hs, j_cs, _ = _run_jax_op(op, j_case, lens, {}, slots)
    t_case = {s: v.astype(np.float32) for s, v in j_case.items()}
    info = treg.get_op_info(op)
    ins = {s: [torch.from_numpy(t_case[s]).to(torch.bfloat16)]
           for s in slots}
    ctx = treg.OpContext(attrs=dict(info.attrs),
                         in_lods={"Input": [LoD.from_lengths([lens])]})
    out = info.compute(ins, dict(info.attrs), ctx)
    assert out["Hidden"].dtype == torch.bfloat16
    _close(out["Hidden"], j_hs, BF16_FWD_TOL, what="Hidden")
    _close(out["Cell"], j_cs, BF16_FWD_TOL, what="Cell")


@pytest.mark.parametrize("variant", ["peepholes", "d24", "flag-off"])
def test_dynamic_lstm_step_route_matches_jax(variant, monkeypatch):
    """The step-by-step route (peepholes with a 7D bias; D % 128 != 0;
    FLAGS.fused_rnn off on both sides) against the JAX lax.scan route,
    outputs and gradients."""
    pytest.importorskip("jax")
    from paddle_tpu.flags import FLAGS as JFLAGS
    Dn = 24 if variant == "d24" else D
    case = _op_case(7, RAGGED, D=Dn)
    attrs = {"is_reverse": True}
    if variant == "peepholes":
        rng = np.random.RandomState(8)
        case["Bias"] = rng.randn(1, 7 * Dn).astype(np.float32) * 0.1
        attrs["use_peepholes"] = True
    if variant == "flag-off":
        monkeypatch.setattr(FLAGS, "fused_rnn", False)
        monkeypatch.setattr(JFLAGS, "fused_rnn", False)
    slots = _case_slots(case, h0=True)
    j_hs, j_cs, j_g = _run_jax_op("dynamic_lstm", case, RAGGED, attrs,
                                  slots, tuple(slots))
    calls = []
    orig = tfr._LstmScan.apply
    monkeypatch.setattr(tfr._LstmScan, "apply",
                        lambda *a: (calls.append(1), orig(*a))[1])
    hs, cs, grads = _run_port_op("dynamic_lstm", case, RAGGED, attrs,
                                 slots, tuple(slots))
    assert calls == []                     # not the kernel route
    _close(hs, j_hs, TOL, what="Hidden")
    _close(cs, j_cs, TOL, what="Cell")
    for g, w_, s in zip(grads, j_g, slots):
        _close(g, w_, OP_GRAD_TOL, what=s)


def test_fused_lstm_rejects_a_peephole_bias():
    case = _op_case(2, UNIFORM, E=E)
    case["Bias"] = np.zeros((1, 7 * D), np.float32)
    info = treg.get_op_info("fused_lstm")
    ctx = treg.OpContext(attrs=dict(info.attrs),
                         in_lods={"Input": [LoD.from_lengths([UNIFORM])]})
    ins = {s: [torch.from_numpy(case[s])]
           for s in ("Input", "WeightX", "Weight", "Bias")}
    with pytest.raises(ValueError, match="4\\*D"):
        info.compute(ins, dict(info.attrs), ctx)


def test_ops_need_a_lod():
    case = _op_case(2, UNIFORM)
    info = treg.get_op_info("dynamic_lstm")
    with pytest.raises(ValueError, match="LoD"):
        info.compute({s: [torch.from_numpy(case[s])]
                      for s in ("Input", "Weight")}, dict(info.attrs),
                     treg.OpContext(attrs=dict(info.attrs)))


# -------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the LSTM kernels have no CPU mode")
    return torch.device("cuda")


def _rel_l2(a, b):
    return float(torch.linalg.vector_norm((a.float() - b.float()))
                 / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 8, 128, 128), (5, 130, 192, 64),
                                   (3, 270, 64, 256)],
                         ids=["b8-d128", "b130-d192", "b270-d64"])
def test_kernels_match_plain_on_card(cuda_device, dtype, shape):
    """Each of the six LSTM kernels against its plain version on the same
    card tensors (the backward from the kernel's own forward): fp32
    forwards to 1e-5, backwards to 1e-4, weight sums by relative L2 1e-4;
    bf16 within 2e-2 (an ulp) of the bf16 plain version, weight sums
    relative L2 2e-2."""
    Tn, Bn, Dn, En = shape
    t = {k: _t(v).to(cuda_device)
         for k, v in _inputs(seed=5, B=Bn, T=Tn, D=Dn, E=En).items()}
    t = {k: (v if k == "lens" else v.to(dtype)) for k, v in t.items()}
    before = dict(tk.LAUNCHES)
    hs, cs, g = tfr.lstm_fwd(t["x"], t["w"], t["lens"], t["h0"], t["c0"])
    dx, dh0, dc0 = tfr.lstm_bwd_data(g, cs, t["w"], t["lens"], t["h0"],
                                     t["c0"], t["dhs"], t["dcs"])
    dw = tfr.lstm_dw(hs, t["h0"], dx)
    phs, pcs, pg = tfr.lstm_proj_fwd(t["xe"], t["wx"], t["b"], t["w"],
                                     t["lens"], t["h0"], t["c0"])
    pout = tfr.lstm_proj_bwd_data(pg, pcs, t["wx"], t["w"], t["lens"],
                                  t["h0"], t["c0"], t["dhs"], t["dcs"])
    dwx, pdw = tfr.lstm_proj_dw(t["xe"], phs, t["h0"], pout[1])
    torch.cuda.synchronize()
    for name in tfr._ENTRIES:
        if name.startswith("lstm"):
            assert tk.LAUNCHES[name] == before[name] + 1, name
    assert tk.LAUNCHES["lstm_proj_dw"] == before["lstm_proj_dw"] + 1
    r = {"fwd": tfr.lstm_fwd_reference(t["x"], t["w"], t["lens"], t["h0"],
                                       t["c0"]),
         "bwd": tfr.lstm_bwd_data_reference(g, cs, t["w"], t["lens"],
                                            t["h0"], t["c0"], t["dhs"],
                                            t["dcs"]),
         "pfwd": tfr.lstm_proj_fwd_reference(t["xe"], t["wx"], t["b"],
                                             t["w"], t["lens"], t["h0"],
                                             t["c0"]),
         "pbwd": tfr.lstm_proj_bwd_data_reference(
             pg, pcs, t["wx"], t["w"], t["lens"], t["h0"], t["c0"],
             t["dhs"], t["dcs"])}
    fp32 = dtype == torch.float32
    pairs = [((hs, cs, g), r["fwd"], 1e-5 if fp32 else 2e-2),
             ((dx, dh0, dc0), r["bwd"], 1e-4 if fp32 else 2e-2),
             ((phs, pcs, pg), r["pfwd"], 1e-5 if fp32 else 2e-2),
             (pout, r["pbwd"], 1e-4 if fp32 else 2e-2)]
    for got, want, tol in pairs:
        for a, b_ in zip(got, want):
            scale = max(1.0, float(b_.float().abs().max()))
            assert float((a.float() - b_.float()).abs().max()) <= tol * scale
    l2 = 1e-4 if fp32 else 2e-2
    assert _rel_l2(dw, tfr.lstm_dw_reference(hs, t["h0"], dx)) <= l2
    r_dwx, r_dw = tfr.lstm_proj_dw_reference(t["xe"], phs, t["h0"], pout[1])
    assert _rel_l2(dwx, r_dwx) <= l2 and _rel_l2(pdw, r_dw) <= l2


@pytest.mark.cuda
@pytest.mark.parametrize("proj", [False, True], ids=["scan", "scan_proj"])
def test_autograd_through_kernels_on_card(cuda_device, proj):
    a = _inputs(seed=6)
    names = _diff_names(proj)
    lens = _t(a["lens"]).to(cuda_device)

    def run(plain):
        live = {k: _t(a[k]).to(cuda_device).requires_grad_() for k in names}
        with tfr.plain_versions() if plain else contextlib.nullcontext():
            if proj:
                hs, cs = tfr.lstm_scan_proj(
                    live["xe"], live["wx"], live["b"], live["w"], lens,
                    live["h0"], live["c0"])
            else:
                hs, cs = tfr.lstm_scan(live["x"], live["w"], lens,
                                       live["h0"], live["c0"])
            loss = hs.sin().sum() + 0.5 * cs.cos().sum()
            return loss, torch.autograd.grad(loss, list(live.values()))

    la, ga = run(False)
    lb, gb = run(True)
    assert abs(float(la) - float(lb)) <= 1e-4 * max(1.0, abs(float(lb)))
    for p, q in zip(ga, gb):
        assert float((p - q).abs().max()) <= 1e-4 * max(
            1.0, float(q.abs().max()))


@pytest.mark.cuda
def test_lstm_wrappers_raise_on_what_they_do_not_take(cuda_device):
    t = {k: _t(v).to(cuda_device) for k, v in _inputs().items()}
    with pytest.raises(ValueError, match="contiguous"):
        tfr.lstm_fwd(t["x"].transpose(0, 1).contiguous().transpose(0, 1),
                     t["w"], t["lens"], t["h0"], t["c0"])
    with pytest.raises(TypeError, match="lane"):
        tfr.lstm_fwd(t["x"].half(), t["w"].half(), t["lens"],
                     t["h0"].half(), t["c0"].half())
    with pytest.raises(ValueError, match="multiple of 64"):
        tfr.lstm_proj_fwd(t["xe"][..., :96].contiguous(),
                          t["wx"][:96].contiguous(), t["b"], t["w"],
                          t["lens"], t["h0"], t["c0"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("E_", [0, 128, 512], ids=["b11", "b15-l1",
                                                   "b15-l2"])
def test_dw_at_flagship_shapes_on_card(cuda_device, dtype, E_):
    """lstm_dw (E 0) and lstm_proj_dw (E 128, 512: the flagship's two
    layers) at T 100, B 128, D 512 against their plain versions, relative
    L2 1e-4 (fp32) / 2e-2 (bf16); two launches on the same inputs give
    the same bits."""
    Tn, Bn, Dn = 100, 128, 512
    rng = np.random.RandomState(8)
    f = np.float32
    hs, h0, dx, xe = (_t(a).to(cuda_device, dtype) for a in (
        rng.randn(Tn, Bn, Dn).astype(f) * 0.5,
        rng.randn(Bn, Dn).astype(f) * 0.5,
        rng.randn(Tn, Bn, 4 * Dn).astype(f),
        rng.randn(Tn, Bn, max(E_, 64)).astype(f) * 0.5))
    l2 = 1e-4 if dtype == torch.float32 else 2e-2
    if E_ == 0:
        dw = tfr.lstm_dw(hs, h0, dx)
        assert torch.equal(dw, tfr.lstm_dw(hs, h0, dx))
        assert _rel_l2(dw, tfr.lstm_dw_reference(hs, h0, dx)) <= l2
        return
    dwx, dw = tfr.lstm_proj_dw(xe, hs, h0, dx)
    again = tfr.lstm_proj_dw(xe, hs, h0, dx)
    assert torch.equal(dwx, again[0]) and torch.equal(dw, again[1])
    r_dwx, r_dw = tfr.lstm_proj_dw_reference(xe, hs, h0, dx)
    assert _rel_l2(dwx, r_dwx) <= l2 and _rel_l2(dw, r_dw) <= l2


def _flagship(dev, T, B, E, ragged, seed=11):
    """Seeded fp32 inputs at the flagship's widths (D 512), lens ragged
    (0..T with 0 and T present) or all T."""
    a = _inputs(seed=seed, B=B, T=T, D=512, E=E)
    if not ragged:
        a["lens"][:] = T
    return {k: _t(v).to(dev) for k, v in a.items()}


def _bf16_gate(got, plain, exact):
    """The bf16 kernels' gate (chip_smoke.py's): no further from the fp32
    plain result than 1.5x the bf16 plain version + 1e-3."""
    for a, p, e in zip(got, plain, exact):
        err = float((a.float() - e.float()).abs().max())
        plain_err = float((p.float() - e.float()).abs().max())
        assert err <= 1.5 * plain_err + 1e-3, (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32-stream", "bf16-resident"])
@pytest.mark.parametrize("shape", [(100, 128, 128, False),
                                   (100, 128, 512, False),
                                   (100, 130, 128, True)],
                         ids=["layer1", "layer2", "b130-ragged"])
def test_proj_routes_match_plain_at_flagship_on_card(cuda_device, dtype,
                                                     shape):
    """B14 and B15's recurrence at the flagship's layers (T 100, D 512, E
    128 / 512) and at B 130 (no multiple of the tile) with ragged
    lengths: bf16 takes the resident route, fp32 the grid route (the
    streaming one until its fp32 lane; the case ids keep the old name),
    each counted under its own name with its passes; fp32 within 1e-5 /
    1e-4 of the plain versions, bf16 within chip_smoke.py's gate of the
    fp32 plain result."""
    Tn, Bn, En, ragged = shape
    t = _flagship(cuda_device, Tn, Bn, En, ragged)
    lp = {k: (v if k == "lens" else v.to(dtype)) for k, v in t.items()}
    route = "cluster" if dtype == torch.bfloat16 else "grid"
    before = dict(tk.LAUNCHES)
    fwd = tfr.lstm_proj_fwd(lp["xe"], lp["wx"], lp["b"], lp["w"], lp["lens"],
                            lp["h0"], lp["c0"])
    bargs = (fwd[2], fwd[1], lp["wx"], lp["w"], lp["lens"], lp["h0"],
             lp["c0"], lp["dhs"], lp["dcs"])
    bwd = tfr.lstm_proj_bwd_data(*bargs)
    torch.cuda.synchronize()
    for d in ("fwd", "bwd"):
        assert tk.LAUNCHES[f"lstm_proj_{d}"] == before[f"lstm_proj_{d}"] + 1
        assert tk.LAUNCHES[f"lstm_proj_{d}_{route}"] == \
            before[f"lstm_proj_{d}_{route}"] + 1
    for n in ("lstm_proj_xg", "lstm_proj_dxe"):
        assert tk.LAUNCHES[n] == before[n] + 1
    pf = tfr.lstm_proj_fwd_reference(lp["xe"], lp["wx"], lp["b"], lp["w"],
                                     lp["lens"], lp["h0"], lp["c0"])
    pb = tfr.lstm_proj_bwd_data_reference(*bargs)
    if dtype == torch.float32:
        for a, b_ in zip(fwd, pf):
            assert float((a - b_).abs().max()) <= 1e-5
        for a, b_ in zip(bwd, pb):
            assert float((a - b_).abs().max()) <= 1e-4 * max(
                1.0, float(b_.abs().max()))
        return
    f32 = {k: v.float() for k, v in lp.items()}
    ef = tfr.lstm_proj_fwd_reference(f32["xe"], f32["wx"], f32["b"],
                                     f32["w"], f32["lens"], f32["h0"],
                                     f32["c0"])
    eb = tfr.lstm_proj_bwd_data_reference(
        *(a.float() for a in bargs[:5]), f32["h0"], f32["c0"], f32["dhs"],
        f32["dcs"])
    _bf16_gate(fwd, pf, ef)
    _bf16_gate(bwd, pb, eb)
    if ragged:
        zero = t["lens"][:, 0] == 0
        assert bool((fwd[0][:, zero] == lp["h0"][zero]).all())
        assert not bwd[1][:, zero].any()


@pytest.mark.cuda
def test_resident_kernels_two_launches_bit_equal_on_card(cuda_device):
    """Each kernel of the resident route (pre-pass, both recurrences,
    post-pass) gives the same bits on the same inputs: fixed sum orders,
    no atomics."""
    t = {k: (v if k == "lens" else v.to(torch.bfloat16))
         for k, v in _flagship(cuda_device, 100, 130, 128, True).items()}
    runs = []
    for _ in range(2):
        xg = tfr.lstm_proj_xg(t["xe"], t["wx"], t["b"])
        hs, cs, g = tfr.lstm_cluster_fwd(xg, t["w"], t["lens"], t["h0"],
                                         t["c0"])
        dx, db, dh0, dc0 = tfr.lstm_cluster_bwd(g, cs, t["w"], t["lens"],
                                                t["h0"], t["c0"], t["dhs"],
                                                t["dcs"])
        runs.append((xg, hs, cs, g, dx, db, dh0, dc0,
                     tfr.lstm_proj_dxe(dx, t["wx"])))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_wide_d_takes_the_streaming_route_on_card(cuda_device):
    """D 640 in bf16: W's slice would not fit a 16-CTA cluster, and D is
    no multiple of 256 for the grid route, so B14 and B15's recurrence
    stream W from L2 every step (each counted under its ``_stream`` name,
    no pass launched): the forward within 2e-2 of its plain version, the
    backward (from the kernel's own gates) within chip_smoke.py's bf16
    gate of the fp32 plain result."""
    t = {k: (v if k == "lens" else v.to(cuda_device, torch.bfloat16))
         for k, v in ((k, _t(v).to(cuda_device)) for k, v in _inputs(
             seed=12, B=8, T=5, D=640, E=128).items())}
    assert tfr._cluster_plan(torch.bfloat16, 8, 640,
                             cuda_device).route == "streaming"
    before = dict(tk.LAUNCHES)
    got = tfr.lstm_proj_fwd(t["xe"], t["wx"], t["b"], t["w"], t["lens"],
                            t["h0"], t["c0"])
    assert tk.LAUNCHES["lstm_proj_fwd_stream"] == \
        before["lstm_proj_fwd_stream"] + 1
    want = tfr.lstm_proj_fwd_reference(t["xe"], t["wx"], t["b"], t["w"],
                                       t["lens"], t["h0"], t["c0"])
    for a, b_ in zip(got, want):
        assert float((a.float() - b_.float()).abs().max()) <= 2e-2
    bargs = (got[2], got[1], t["wx"], t["w"], t["lens"], t["h0"], t["c0"],
             t["dhs"], t["dcs"])
    bwd = tfr.lstm_proj_bwd_data(*bargs)
    torch.cuda.synchronize()
    for d in ("fwd", "bwd"):
        assert tk.LAUNCHES[f"lstm_proj_{d}_stream"] == \
            before[f"lstm_proj_{d}_stream"] + 1
        assert tk.LAUNCHES[f"lstm_proj_{d}_cluster"] == \
            before[f"lstm_proj_{d}_cluster"]
    for n in ("lstm_proj_xg", "lstm_proj_dxe"):
        assert tk.LAUNCHES[n] == before[n]
    exact = tfr.lstm_proj_bwd_data_reference(*(
        a if k == "lens" else a.float() for k, a in zip(
            ("gates", "cs", "wx", "w", "lens", "h0", "c0", "dhs", "dcs"),
            bargs)))
    _bf16_gate(bwd, tfr.lstm_proj_bwd_data_reference(*bargs), exact)


@pytest.mark.cuda
def test_resident_wrappers_raise_on_what_they_do_not_take(cuda_device):
    t = {k: (v if k == "lens" else v.to(torch.bfloat16))
         for k, v in _flagship(cuda_device, 3, 16, 128, False).items()}
    xg = tfr.lstm_proj_xg(t["xe"], t["wx"], t["b"])
    args = (t["w"], t["lens"], t["h0"], t["c0"])
    with pytest.raises(TypeError, match="one dtype"):
        tfr.lstm_proj_xg(t["xe"].float(), t["wx"], t["b"])
    with pytest.raises(TypeError, match="float32"):
        tfr.lstm_cluster_fwd(xg.to(torch.bfloat16), *args)
    with pytest.raises(TypeError, match="one dtype"):
        tfr.lstm_cluster_fwd(xg, t["w"].float(), *args[1:])
    with pytest.raises(ValueError, match="streaming route"):
        w2 = torch.zeros((640, 2560), dtype=torch.bfloat16,
                         device=cuda_device)
        h2 = torch.zeros((16, 640), dtype=torch.bfloat16,
                         device=cuda_device)
        tfr.lstm_cluster_fwd(torch.zeros((3, 16, 2560), device=cuda_device),
                             w2, t["lens"], h2, h2)
    with pytest.raises(ValueError, match="contiguous"):
        tfr.lstm_proj_dxe(torch.zeros((3, 16, 2048), dtype=torch.bfloat16,
                                      device=cuda_device)[:, ::2].repeat(
                                          1, 2, 1).transpose(0, 1),
                          t["wx"])
    with pytest.raises(ValueError, match="multiple of 64"):
        tfr.lstm_proj_xg(t["xe"][..., :96].contiguous(),
                         t["wx"][:96].contiguous(), t["b"])


# chip_smoke.py's gates of the two passes against their plain versions:
# fp32 sums of exact bf16 products (xg); one bf16 rounding of them (dxe)
XG_REL_TOL = 1e-5
DXE_REL_TOL = 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(100, 128, 512, 128), (100, 128, 512, 512),
                                   (3, 16, 64, 64), (3, 16, 512, 192),
                                   (100, 130, 64, 512), (100, 130, 512, 192)],
                         ids=["layer1", "layer2", "m48-d64-e64",
                              "m48-d512-e192", "m13000-d64-e512",
                              "m13000-d512-e192"])
def test_passes_match_plain_and_repeat_on_card(cuda_device, shape):
    """The resident route's pre-pass (xg = xe @ Wx + b, fp32 out, a
    nonzero bias) and post-pass (dxe = dx @ Wx^T, bf16 out), one
    persistent wgmma GEMM: at the flagship's two layers, at T*B = 48 and
    13,000 (no multiple of a 128-row tile or of a pair of them), E 64 /
    192 / 512 (mode 1's N: one column tile, a partial one, two) and D 64 /
    512: each within chip_smoke.py's gate of its plain version, two
    launches bit-equal, one launch counted each."""
    Tn, Bn, Dn, En = shape
    t = {k: _t(v, bf16=True).to(cuda_device) for k, v in _inputs(
        seed=13, B=Bn, T=Tn, D=Dn, E=En).items()
        if k in ("xe", "wx", "b", "x")}
    dx = t["x"]     # [T, B, 4D] bf16: stands in for the rounded dgates
    before = dict(tk.LAUNCHES)
    xg, xg2 = (tfr.lstm_proj_xg(t["xe"], t["wx"], t["b"]) for _ in range(2))
    dxe, dxe2 = (tfr.lstm_proj_dxe(dx, t["wx"]) for _ in range(2))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["lstm_proj_xg"] == before["lstm_proj_xg"] + 2
    assert tk.LAUNCHES["lstm_proj_dxe"] == before["lstm_proj_dxe"] + 2
    assert torch.equal(xg, xg2) and torch.equal(dxe, dxe2)
    assert xg.dtype == torch.float32 and dxe.dtype == torch.bfloat16
    for got, want, tol in (
            (xg, tfr.lstm_proj_xg_reference(t["xe"], t["wx"], t["b"]),
             XG_REL_TOL),
            (dxe, tfr.lstm_proj_dxe_reference(dx, t["wx"]), DXE_REL_TOL)):
        assert got.shape == want.shape
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= \
            tol * scale, (tol, scale)


def _route_moved(before, names):
    return {n: tk.LAUNCHES[n] - before[n] for n in names}


_B10_B11_NAMES = ("lstm_fwd", "lstm_bwd", "lstm_fwd_cluster",
                  "lstm_bwd_cluster", "lstm_fwd_stream", "lstm_bwd_stream")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, False), (130, True)],
                         ids=["b128-uniform", "b130-ragged"])
def test_b10_b11_resident_route_at_flagship_on_card(cuda_device, shape):
    """B10 and B11's recurrence in bf16 at T 100, D 512 (B 130: a padded
    last tile, lengths 0..100) take the resident route, each counted
    under its wrapper's and its ``_cluster`` name; within chip_smoke.py's
    bf16 gate of the fp32 plain result; B10 bit-equal to B14's
    recurrence (``lstm_cluster_fwd``) on float(x), B11's dx, dh0, dc0 to
    ``lstm_cluster_bwd``'s; two launches of each bit-equal; a zero-length
    row keeps h0 and gets no dgates."""
    Bn, ragged = shape
    t = _flagship(cuda_device, 100, Bn, 128, ragged)
    lp = {k: (v if k == "lens" else v.to(torch.bfloat16))
          for k, v in t.items()}
    args = (lp["w"], lp["lens"], lp["h0"], lp["c0"])
    before = dict(tk.LAUNCHES)
    fwd = tfr.lstm_fwd(lp["x"], *args)
    bargs = (fwd[2], fwd[1], *args, lp["dhs"], lp["dcs"])
    bwd = tfr.lstm_bwd_data(*bargs)
    torch.cuda.synchronize()
    assert _route_moved(before, _B10_B11_NAMES) == {
        "lstm_fwd": 1, "lstm_bwd": 1, "lstm_fwd_cluster": 1,
        "lstm_bwd_cluster": 1, "lstm_fwd_stream": 0, "lstm_bwd_stream": 0}
    f32 = {k: v.float() for k, v in lp.items()}
    _bf16_gate(fwd, tfr.lstm_fwd_reference(lp["x"], *args),
               tfr.lstm_fwd_reference(f32["x"], f32["w"], f32["lens"],
                                      f32["h0"], f32["c0"]))
    _bf16_gate(bwd, tfr.lstm_bwd_data_reference(*bargs),
               tfr.lstm_bwd_data_reference(*(a.float() for a in bargs)))
    resident = tfr.lstm_cluster_fwd(lp["x"].float(), *args)
    assert all(torch.equal(a, b_) for a, b_ in zip(fwd, resident))
    dx, _db, dh0, dc0 = tfr.lstm_cluster_bwd(*bargs)
    assert all(torch.equal(a, b_) for a, b_ in zip(bwd, (dx, dh0, dc0)))
    assert all(torch.equal(a, b_)
               for a, b_ in zip(fwd, tfr.lstm_fwd(lp["x"], *args)))
    assert all(torch.equal(a, b_)
               for a, b_ in zip(bwd, tfr.lstm_bwd_data(*bargs)))
    if ragged:
        zero = t["lens"][:, 0] == 0
        assert bool(zero.any())
        assert bool((fwd[0][:, zero] == lp["h0"][zero]).all())
        assert bool((fwd[1][:, zero] == lp["c0"][zero]).all())
        assert not bwd[0][:, zero].any()


@pytest.mark.cuda
def test_dynamic_lstm_reverse_through_the_resident_route_on_card(
        cuda_device):
    """``dynamic_lstm`` with ``is_reverse`` on ragged bf16 input (the op
    reverses x outside the kernel, so the kernels see a forward scan):
    Hidden, Cell and the gradients of Input, Weight, H0 and C0 through
    B10/B11 on the resident route against the same op through their plain
    versions, within a bf16 ulp (outputs) and BF16_GRAD_TOL (inputs'
    gradients; the weight's relatively)."""
    case = _op_case(13, RAGGED)
    slots = _case_slots(case, h0=True)
    info = treg.get_op_info("dynamic_lstm")
    attrs = dict(info.attrs, is_reverse=True)

    def run(plain):
        live = {s: torch.from_numpy(case[s]).to(cuda_device, torch.bfloat16)
                .requires_grad_() for s in slots}
        ctx = treg.OpContext(attrs=attrs, in_lods={
            "Input": [LoD.from_lengths([RAGGED])]})
        with tfr.plain_versions() if plain else contextlib.nullcontext():
            out = info.compute({s: [live[s]] for s in slots}, attrs, ctx)
            loss = (out["Hidden"].float().sin().sum()
                    + 0.5 * out["Cell"].float().cos().sum())
            grads = torch.autograd.grad(loss, [live[s] for s in slots])
        return out["Hidden"], out["Cell"], grads

    before = dict(tk.LAUNCHES)
    hs, cs, grads = run(False)
    torch.cuda.synchronize()
    moved = _route_moved(before, _B10_B11_NAMES)
    assert moved["lstm_fwd_cluster"] == moved["lstm_bwd_cluster"] == 1
    assert moved["lstm_fwd_stream"] == moved["lstm_bwd_stream"] == 0
    p_hs, p_cs, p_grads = run(True)
    _close(hs, p_hs, BF16_FWD_TOL, what="Hidden")
    _close(cs, p_cs, BF16_FWD_TOL, what="Cell")
    for g, p, s in zip(grads, p_grads, slots):
        if s in ("Weight", "Bias"):
            _close(g, p, 0.1, rtol=2e-2, what=s)
        else:
            _close(g, p, BF16_GRAD_TOL, what=s)


@pytest.mark.cuda
def test_b10_b11_wide_d_streams_on_card(cuda_device):
    """D 640 in bf16 is past the resident route and no multiple of 256
    for the grid route: B10 and B11's recurrence stream W from L2 (each
    counted under its ``_stream`` name), the forward within 2e-2 of its
    plain version, the backward (from the kernel's own gates) within
    chip_smoke.py's bf16 gate of the fp32 plain result."""
    t = {k: (v if k == "lens" else v.to(cuda_device, torch.bfloat16))
         for k, v in ((k, _t(v).to(cuda_device)) for k, v in _inputs(
             seed=14, B=8, T=5, D=640, E=128).items())}
    args = (t["w"], t["lens"], t["h0"], t["c0"])
    before = dict(tk.LAUNCHES)
    got = tfr.lstm_fwd(t["x"], *args)
    bargs = (got[2], got[1], *args, t["dhs"], t["dcs"])
    bwd = tfr.lstm_bwd_data(*bargs)
    torch.cuda.synchronize()
    assert _route_moved(before, _B10_B11_NAMES) == {
        "lstm_fwd": 1, "lstm_bwd": 1, "lstm_fwd_cluster": 0,
        "lstm_bwd_cluster": 0, "lstm_fwd_stream": 1, "lstm_bwd_stream": 1}
    for a, b_ in zip(got, tfr.lstm_fwd_reference(t["x"], *args)):
        assert float((a.float() - b_.float()).abs().max()) <= 2e-2
    _bf16_gate(bwd, tfr.lstm_bwd_data_reference(*bargs),
               tfr.lstm_bwd_data_reference(*(
                   a if a is t["lens"] else a.float() for a in bargs)))


@pytest.mark.cuda
def test_b10_b11_wrappers_raise_on_mixed_or_misaligned_inputs_on_card(
        cuda_device):
    """The routes are chosen from checked inputs: one dtype for every
    tensor of a call, each 16-byte aligned (the resident forward loads x
    four bytes at a time)."""
    t = {k: (v if k == "lens" else v.to(torch.bfloat16))
         for k, v in _flagship(cuda_device, 3, 16, 128, False).items()}
    args = (t["w"], t["lens"], t["h0"], t["c0"])
    with pytest.raises(TypeError, match="one dtype"):
        tfr.lstm_fwd(t["x"], t["w"].float(), *args[1:])
    g, cs = tfr.lstm_fwd(t["x"], *args)[2:0:-1]
    with pytest.raises(TypeError, match="gates' dtype"):
        tfr.lstm_bwd_data(g, cs, *args, t["dhs"].float(), t["dcs"])
    flat = torch.empty(t["x"].numel() + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:].view(t["x"].shape)
    shifted.copy_(t["x"])
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfr.lstm_fwd(shifted, *args)
