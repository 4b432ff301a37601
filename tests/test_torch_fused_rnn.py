"""The port's fused GRU (B12/B13), held against the JAX package.

The same numpy inputs (``tests/test_fused_rnn.py``'s shapes: B 8, T 7,
D 128; ragged lengths including 0 and T) go through the JAX Pallas
kernels in interpret mode (``gru_scan``, ``_gru_fwd_call``,
``_gru_bwd_call``) and through the port on the CPU, where the wrappers
run their plain versions:

- fp32 forward (hs and the saved gates): atol 2e-5 (the same fp32 math,
  sums in another order);
- fp32 backward from the same saved gates and hs (dx, dW, dh0), and the
  gradients of ``sum(sin(hs))`` through the ``autograd.Function``: atol
  2e-4 (dW sums 56 rows of O(1) products);
- bf16: hs and gates atol 2e-2 (one bf16 ulp at |v| <= 2: both round the
  same fp32 carry once, from sums in another order); dx and dh0 atol
  5e-2, dW rtol 2e-2 + atol 0.1 (a bf16 ulp of |dW| <= 16: JAX sums
  bf16 partials per batch tile, the port over all rows at once);
- a two-tile batch (B 256: the Pallas kernel runs two 128-row tiles and
  sums their dW partials) in fp32, T 3.

The kernel-vs-plain cases need a card and skip without one.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.kernels import fused_rnn as tfr

B, T, D = 8, 7, 128
FWD_TOL = 2e-5
GRAD_TOL = 2e-4
BF16_FWD_TOL = 2e-2
BF16_GRAD_TOL = 5e-2


@pytest.fixture(scope="module")
def jfr():
    pytest.importorskip("jax")
    from paddle_tpu.kernels import fused_rnn
    return fused_rnn


def _inputs(seed=1, B=B, T=T, D=D):
    """x, w, h0 as in tests/test_fused_rnn.py; lens ragged with 0 and T;
    dhs an upstream gradient."""
    rng = np.random.RandomState(seed)
    x = rng.randn(T, B, 3 * D).astype(np.float32) * 0.5
    w = rng.randn(D, 3 * D).astype(np.float32) * 0.1
    h0 = rng.randn(B, D).astype(np.float32) * 0.3
    lens = rng.randint(1, T + 1, (B, 1)).astype(np.float32)
    lens[0], lens[-1] = 0, T
    dhs = rng.randn(T, B, D).astype(np.float32)
    return x, w, lens, h0, dhs


def _j(*arrays, bf16=False):
    import jax.numpy as jnp
    return [jnp.asarray(a, jnp.bfloat16 if bf16 and a.dtype == np.float32
                        and a.shape[-1] != 1 else a.dtype) for a in arrays]


def _t(*arrays, bf16=False):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16 if bf16 and a.shape[-1] != 1 else torch.float32)
        for a in arrays]


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=what)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_forward_matches_jax_fwd_call(jfr, bf16):
    x, w, lens, h0, _dhs = _inputs()
    j_hs, j_gates = jfr._gru_fwd_call(*_j(x, w, lens, h0, bf16=bf16),
                                      interpret=True)
    hs, gates = tfr.gru_fwd(*_t(x, w, lens, h0, bf16=bf16))
    dt = torch.bfloat16 if bf16 else torch.float32
    assert hs.dtype == gates.dtype == dt
    tol = BF16_FWD_TOL if bf16 else FWD_TOL
    _close(hs, j_hs, tol, what="hs")
    _close(gates, j_gates, tol, what="gates")


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_backward_matches_jax_bwd_call(jfr, bf16):
    """Each side's backward from the same (JAX) saved gates and hs."""
    x, w, lens, h0, dhs = _inputs()
    jx, jw, jl, jh0, jd = _j(x, w, lens, h0, dhs, bf16=bf16)
    j_hs, j_gates = jfr._gru_fwd_call(jx, jw, jl, jh0, interpret=True)
    j_dx, j_dw, j_dh0 = jfr._gru_bwd_call(j_gates, j_hs, jw, jl, jh0, jd,
                                          interpret=True)
    gates, hs = (torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16 if bf16 else torch.float32) for a in (j_gates, j_hs))
    _x, tw, tl, th0, td = _t(x, w, lens, h0, dhs, bf16=bf16)
    dx, dw, dh0 = tfr.gru_bwd(gates, hs, tw, tl, th0, td.to(hs.dtype))
    assert dx.dtype == dw.dtype == dh0.dtype == tw.dtype
    if bf16:
        _close(dx, j_dx, BF16_GRAD_TOL, what="dx")
        _close(dh0, j_dh0, BF16_GRAD_TOL, what="dh0")
        _close(dw, j_dw, 0.1, rtol=2e-2, what="dw")
    else:
        for got, want, name in ((dx, j_dx, "dx"), (dw, j_dw, "dw"),
                                (dh0, j_dh0, "dh0")):
            _close(got, want, GRAD_TOL, what=name)
    # the halves the wrappers are made of
    dx2, dh02 = tfr.gru_bwd_data(gates, hs, tw, tl, th0, td.to(hs.dtype))
    assert torch.equal(dx2, dx) and torch.equal(dh02, dh0)
    assert torch.equal(tfr.gru_dw(gates, hs, th0, dx), dw)


def _jax_loss_grads(jfr, x, w, lens, h0):
    import jax
    import jax.numpy as jnp

    def loss(x, w, h0):
        return jnp.sum(jnp.sin(jfr.gru_scan(x, w, lens, h0, interpret=True)))

    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(x, w, h0)
    return float(val), grads


def _port_loss_grads(x, w, lens, h0):
    live = [t.clone().requires_grad_() for t in (x, w, h0)]
    hs = tfr.gru_scan(live[0], live[1], lens, live[2])
    loss = torch.sum(torch.sin(hs.float()))
    return float(loss.detach()), torch.autograd.grad(loss, live)


@pytest.mark.parametrize("shape", [(B, T), (256, 3)], ids=["b8", "b256"])
def test_autograd_grads_match_jax(jfr, shape):
    """dx, dW, dh0 of sum(sin(hs)) through the custom VJP; B 256 runs the
    Pallas kernel as two batch tiles whose dW partials are summed."""
    Bn, Tn = shape
    x, w, lens, h0, _dhs = _inputs(seed=9, B=Bn, T=Tn)
    j_val, j_grads = _jax_loss_grads(jfr, *_j(x, w, lens, h0))
    val, grads = _port_loss_grads(*_t(x, w, lens, h0))
    assert abs(val - j_val) <= 1e-4 * max(1.0, abs(j_val))
    for got, want, name in zip(grads, j_grads, ("dx", "dw", "dh0")):
        _close(got, want, GRAD_TOL, what=name)


def test_bf16_autograd_grads_match_jax(jfr):
    x, w, lens, h0, _dhs = _inputs(seed=4)
    j_val, j_grads = _jax_loss_grads(jfr, *_j(x, w, lens, h0, bf16=True))
    val, grads = _port_loss_grads(*_t(x, w, lens, h0, bf16=True))
    assert abs(val - j_val) <= 2e-2 * max(1.0, abs(j_val))
    for got, want, name in zip(grads, j_grads, ("dx", "dw", "dh0")):
        assert got.dtype == torch.bfloat16, name
        if name == "dw":
            _close(got, want, 0.1, rtol=2e-2, what=name)
        else:
            _close(got, want, BF16_GRAD_TOL, what=name)


def test_zero_length_rows_keep_h0_and_get_no_gradient():
    x, w, lens, h0, dhs = _t(*_inputs())
    hs, gates = tfr.gru_fwd(x, w, lens, h0)
    for t in range(T):
        assert torch.equal(hs[t, 0], h0[0])           # lens[0] == 0
    dx, dw, dh0 = tfr.gru_bwd(gates, hs, w, lens, h0, dhs)
    assert not dx[:, 0].any()
    assert torch.allclose(dh0[0], dhs[:, 0].sum(0), atol=1e-5)
    # dW: the zero-length row contributes nothing
    keep = torch.ones(B, dtype=torch.bool)
    keep[0] = False
    dw_rest = tfr.gru_dw(gates[:, keep].contiguous(), hs[:, keep].contiguous(),
                         h0[keep], dx[:, keep].contiguous())
    assert torch.allclose(dw, dw_rest, atol=1e-5)


def test_plain_versions_switch_and_cpu_path_count_no_launches():
    x, w, lens, h0, _dhs = _t(*_inputs())
    before = dict(tk.LAUNCHES)
    a = [t.clone().requires_grad_() for t in (x, w, h0)]
    b = [t.clone().requires_grad_() for t in (x, w, h0)]
    ha = tfr.gru_scan(a[0], a[1], lens, a[2])
    with tfr.plain_versions():
        hb = tfr.gru_scan(b[0], b[1], lens, b[2])
    ga = torch.autograd.grad(ha.sum(), a)
    gb = torch.autograd.grad(hb.sum(), b)
    assert torch.equal(ha, hb)
    for p, q in zip(ga, gb):
        assert torch.equal(p, q)
    assert tk.LAUNCHES == before
    assert not tfr._plain[0]


def test_bad_inputs_raise():
    x, w, lens, h0, _dhs = _t(*_inputs())
    with pytest.raises(ValueError, match="do not agree"):
        tfr.gru_fwd(x, w, lens[:4], h0)
    with pytest.raises(ValueError, match=r"\[D, 3D\]"):
        tfr.gru_fwd(x, w[:, :100], lens, h0)
    with pytest.raises(TypeError, match="one dtype"):
        tfr.gru_fwd(x, w.to(torch.bfloat16), lens, h0)
    with pytest.raises(NotImplementedError, match="A9"):
        tfr.gru_scan_dp(x, w, lens, h0, mesh=None, data_axis="data")


# -------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GRU kernels have no CPU mode")
    return torch.device("cuda")


def _rel_l2(a, b):
    return float(torch.linalg.vector_norm((a.float() - b.float()))
                 / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 8, 128), (5, 130, 192), (3, 270, 64)],
                         ids=["b8-d128", "b130-d192", "b270-d64"])
def test_kernels_match_plain_on_card(cuda_device, dtype, shape):
    """gru_fwd, gru_bwd_data and gru_dw against their plain versions on
    the same card tensors: fp32 hs/gates to 1e-5, dx/dh0 to 1e-4, dW
    relative L2 1e-4; bf16 against the fp32 plain result, no worse than
    1.5x the bf16 plain version's error + 1e-3 (hs, gates, dx, dh0) or
    2e-3 relative L2 (dW)."""
    Tn, Bn, Dn = shape
    x, w, lens, h0, dhs = (t.to(cuda_device) for t in _t(*_inputs(
        seed=5, B=Bn, T=Tn, D=Dn)))
    xs, ws, h0s, dhss = (t.to(dtype) for t in (x, w, h0, dhs))
    before = dict(tk.LAUNCHES)
    hs, gates = tfr.gru_fwd(xs, ws, lens, h0s)
    dx, dh0 = tfr.gru_bwd_data(gates, hs, ws, lens, h0s, dhss)
    dw = tfr.gru_dw(gates, hs, h0s, dx)
    torch.cuda.synchronize()
    for name in ("gru_fwd", "gru_bwd", "gru_dw"):
        assert tk.LAUNCHES[name] == before[name] + 1, name
    r_hs, r_gates = tfr.gru_fwd_reference(xs, ws, lens, h0s)
    r_dx, r_dh0 = tfr.gru_bwd_data_reference(gates, hs, ws, lens, h0s, dhss)
    r_dw = tfr.gru_dw_reference(gates, hs, h0s, dx)
    if dtype == torch.float32:
        for got, want, tol in ((hs, r_hs, 1e-5), (gates, r_gates, 1e-5),
                               (dx, r_dx, 1e-4), (dh0, r_dh0, 1e-4)):
            assert got.dtype == dtype
            assert float((got - want).abs().max()) <= tol
        assert _rel_l2(dw, r_dw) <= 1e-4
        return
    f_hs, f_gates = tfr.gru_fwd_reference(x, w, lens, h0)
    f_dx, f_dh0 = tfr.gru_bwd_data_reference(gates.float(), hs.float(), w,
                                             lens, h0, dhss.float())
    f_dw = tfr.gru_dw_reference(gates.float(), hs.float(), h0s.float(),
                                dx.float())
    for got, plain, exact in ((hs, r_hs, f_hs), (gates, r_gates, f_gates),
                              (dx, r_dx, f_dx), (dh0, r_dh0, f_dh0)):
        assert got.dtype == torch.bfloat16
        err = float((got.float() - exact).abs().max())
        plain_err = float((plain.float() - exact).abs().max())
        assert err <= 1.5 * plain_err + 1e-3, (err, plain_err)
    assert _rel_l2(dw, f_dw) <= 1.5 * _rel_l2(r_dw, f_dw) + 2e-3


@pytest.mark.cuda
def test_autograd_through_kernels_on_card(cuda_device):
    x, w, lens, h0, dhs = (t.to(cuda_device) for t in _t(*_inputs(seed=6)))
    a = [t.clone().requires_grad_() for t in (x, w, h0)]
    b = [t.clone().requires_grad_() for t in (x, w, h0)]
    ha = tfr.gru_scan(a[0], a[1], lens, a[2])
    with tfr.plain_versions():
        hb = tfr.gru_scan(b[0], b[1], lens, b[2])
    # a transposed upstream gradient: backward makes it contiguous
    g_up = dhs.transpose(0, 1).contiguous().transpose(0, 1)
    ga = torch.autograd.grad(ha, a, g_up)
    gb = torch.autograd.grad(hb, b, g_up)
    assert float((ha - hb).detach().abs().max()) <= 1e-5
    for p, q in zip(ga, gb):
        assert float((p - q).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda_device):
    x, w, lens, h0, dhs = (t.to(cuda_device) for t in _t(*_inputs()))
    with pytest.raises(ValueError, match="contiguous"):
        tfr.gru_fwd(x.transpose(0, 1).contiguous().transpose(0, 1), w,
                    lens, h0)
    with pytest.raises(TypeError, match="lane"):
        tfr.gru_fwd(x.half(), w.half(), lens, h0.half())
    with pytest.raises(TypeError, match="lens"):
        tfr.gru_fwd(x, w, lens.double(), h0)
    x96, w96, _l, h96, _d = (t.to(cuda_device) for t in _t(*_inputs(D=96)))
    with pytest.raises(ValueError, match="multiple of 64"):
        tfr.gru_fwd(x96, w96, lens, h96)
    with pytest.raises(ValueError, match="is on"):
        tfr.gru_fwd(x, w, lens.cpu(), h0)
    hs, gates = tfr.gru_fwd(x, w, lens, h0)
    with pytest.raises(TypeError, match="gates' dtype"):
        tfr.gru_bwd(gates, hs, w, lens, h0, dhs.to(torch.bfloat16))
    with pytest.raises(ValueError, match="too large"):
        tfr._pick_bb("gru_bwd", 8, 6400, cuda_device)
