"""The port's flash attention, held against the JAX package.

The same numpy inputs go through the JAX Pallas kernels (interpret mode
on the CPU: ``flash_attention``, ``_fwd_call``, ``_bwd_call``) and
through the port on the CPU, where the wrappers run their plain
versions:

- the forward (out and lse): atol 1e-5 (fp32; the two differ only in
  the order of the fp32 sums: JAX folds 8-16-key tiles online, the
  plain version one tile);
- the gradients through the ``autograd.Function``, and the plain dq and
  dk/dv from the same lse and delta: atol 1e-4 (the backward's sums run
  over up to 64 positions of products of O(1) values);
- bf16 inputs: both round ``out`` to bf16 from fp32, so they differ by
  at most one bf16 ulp of |out| <= 4: atol 2e-2.

Shapes follow ``tests/test_flash_ring_attention.py``: ragged T,
rectangular blocks, Tq != Tk, causal and not; and head_dim 128, the
kernels' widest capacity, in fp32 and bf16. The kernel-vs-plain cases
need a card and skip without one.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.kernels import flash_attention as tfa

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
# (B, H, Tq, Tk, d, causal, block_q, block_k) for the JAX call
SHAPES = [
    (2, 2, 64, 64, 32, True, 16, 16),
    (1, 2, 50, 50, 16, False, 16, 8),   # ragged T, rectangular blocks
    (2, 1, 33, 33, 8, True, 8, 16),     # T not a block multiple
    (1, 2, 20, 55, 16, False, 8, 16),   # Tq != Tk (cross attention)
    (1, 2, 20, 55, 16, True, 8, 16),    # causal, Tq < Tk, top-left
    (1, 1, 40, 24, 8, True, 8, 8),      # causal, Tq > Tk
    (1, 2, 40, 40, 128, True, 16, 16),  # head_dim 128
    (1, 2, 24, 40, 128, False, 8, 16),  # head_dim 128, Tq != Tk
]
IDS = [f"{s[2]}x{s[3]}-d{s[4]}-{'causal' if s[5] else 'full'}"
       for s in SHAPES]


@pytest.fixture(scope="module")
def jfa():
    """The JAX package's flash_attention module (``paddle_tpu.kernels``
    re-exports the function under the module's name)."""
    import importlib
    pytest.importorskip("jax")
    return importlib.import_module("paddle_tpu.kernels.flash_attention")


def _inputs(seed, B, H, Tq, Tk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq, d)).astype(np.float32)
    k = rng.standard_normal((B, H, Tk, d)).astype(np.float32)
    v = rng.standard_normal((B, H, Tk, d)).astype(np.float32)
    do = rng.standard_normal((B, H, Tq, d)).astype(np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_matches_jax(jfa, shape):
    import jax.numpy as jnp
    B, H, Tq, Tk, d, causal, bq, bk = shape
    q, k, v, _do = _inputs(0, B, H, Tq, Tk, d)
    jout = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=bq,
                               block_k=bk)
    out = tfa.flash_attention(*_t(q, k, v), causal=causal)
    assert out.dtype == torch.float32 and out.shape == (B, H, Tq, d)
    _close(out.numpy(), jout, FWD_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_kernels_match_jax_calls(jfa, shape):
    """The three plain versions against ``_fwd_call`` / ``_bwd_call``
    (the Pallas kernels in interpret mode), the backward from JAX's own
    out and lse."""
    import jax.numpy as jnp
    B, H, Tq, Tk, d, causal, bq, bk = shape
    q, k, v, do = _inputs(1, B, H, Tq, Tk, d)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jout, jlse = jfa._fwd_call(jq, jk, jv, causal, scale, bq, bk, True)
    jdq, jdk, jdv = jfa._bwd_call(jq, jk, jv, jout, jlse, jdo, causal,
                                  scale, bq, bk, True)
    tq, tk_, tv, tdo = _t(q, k, v, do)
    out, lse = tfa.flash_attention_fwd_reference(tq, tk_, tv, causal, scale)
    _close(out.numpy(), jout, FWD_TOL)
    _close(lse.numpy(), jlse, FWD_TOL)
    tout, tlse = _t(np.array(jout), np.array(jlse))
    delta = torch.sum(tdo * tout, dim=-1)
    dq = tfa.flash_attention_dq_reference(tq, tk_, tv, tdo, tlse, delta,
                                          causal, scale)
    dk, dv = tfa.flash_attention_dkv_reference(tq, tk_, tv, tdo, tlse,
                                               delta, causal, scale)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == torch.float32
        _close(got.numpy(), want, GRAD_TOL)
    # the wrappers take the plain versions on CPU tensors
    w_out, w_lse = tfa.flash_attention_fwd(tq, tk_, tv, causal, scale)
    assert torch.equal(w_out, out) and torch.equal(w_lse, lse)
    assert torch.equal(tfa.flash_attention_dq(tq, tk_, tv, tdo, tlse, delta,
                                              causal, scale), dq)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2], SHAPES[3],
                                   SHAPES[5], SHAPES[6], SHAPES[7]],
                         ids=[IDS[0], IDS[2], IDS[3], IDS[5], IDS[6],
                              IDS[7]])
def test_grads_match_jax(jfa, shape):
    """Gradients of sum(sin(out)) through the port's autograd.Function
    and through JAX's custom_vjp."""
    import jax
    import jax.numpy as jnp
    B, H, Tq, Tk, d, causal, bq, bk = shape
    q, k, v, _do = _inputs(2, B, H, Tq, Tk, d)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                block_k=bk)
        return jnp.sum(jnp.sin(o))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    tq, tk_, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = tfa.flash_attention(tq, tk_, tv, causal=causal)
    tg = torch.autograd.grad(torch.sum(torch.sin(out)), (tq, tk_, tv))
    for got, want in zip(tg, jg):
        _close(got.numpy(), want, GRAD_TOL)


def _bf16_forward_and_grads_match_jax(jfa, d):
    import jax
    import jax.numpy as jnp
    q, k, v, do = _inputs(3, 1, 2, 40, 40, d)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))

    def jf(q, k, v):
        return jfa.flash_attention(q, k, v, causal=True, block_q=16,
                                   block_k=16)

    jout, vjp = jax.vjp(jf, jq, jk, jv)
    jg = vjp(jdo)
    tq, tk_, tv, tdo = (t.to(torch.bfloat16) for t in _t(q, k, v, do))
    tq, tk_, tv = (t.requires_grad_() for t in (tq, tk_, tv))
    out = tfa.flash_attention(tq, tk_, tv, causal=True)
    tg = torch.autograd.grad(out, (tq, tk_, tv), tdo)
    assert out.dtype == torch.bfloat16
    _close(out.float().detach().numpy(), np.asarray(jout, np.float32),
           BF16_TOL)
    for got, want in zip(tg, jg):
        assert got.dtype == torch.bfloat16
        _close(got.float().numpy(), np.asarray(want, np.float32), BF16_TOL)


def test_bf16_forward_and_grads_match_jax(jfa):
    """bf16 inputs: outputs in bf16 from fp32 math on both sides."""
    _bf16_forward_and_grads_match_jax(jfa, 16)


def test_bf16_forward_and_grads_match_jax_at_head_dim_128(jfa):
    """The same at head_dim 128, the bf16 kernels' widest capacity."""
    _bf16_forward_and_grads_match_jax(jfa, 128)


def test_no_keys_gives_zero_rows_and_neg_inf_lse():
    """The l == 0 rule: a row that sees no key outputs 0, lse NEG_INF."""
    q, k, v, do = _t(*_inputs(4, 1, 2, 5, 0, 8))
    out, lse = tfa.flash_attention_fwd(q, k, v, True, 0.5)
    assert torch.equal(out, torch.zeros_like(q))
    assert torch.equal(lse, torch.full((1, 2, 5), tfa.NEG_INF))
    delta = torch.sum(do * out, dim=-1)
    dq = tfa.flash_attention_dq(q, k, v, do, lse, delta, True, 0.5)
    assert torch.equal(dq, torch.zeros_like(q))


def test_reference_path_equals_the_cpu_wrapper_path():
    q, k, v, _do = _inputs(5, 1, 2, 24, 24, 8)
    a = [t.requires_grad_() for t in _t(q, k, v)]
    b = [t.requires_grad_() for t in _t(q, k, v)]
    oa = tfa.flash_attention(*a, causal=True, sm_scale=0.3)
    ob = tfa.flash_attention_reference(*b, causal=True, sm_scale=0.3)
    assert torch.equal(oa, ob)
    ga = torch.autograd.grad(oa.sum(), a)
    gb = torch.autograd.grad(ob.sum(), b)
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)


def test_cpu_path_counts_no_launches_and_takes_strided_inputs():
    before = dict(tk.LAUNCHES)
    q, k, v, _do = _inputs(6, 1, 2, 16, 16, 8)
    tq, tk_, tv = (t.transpose(2, 3).contiguous().transpose(2, 3)
                   .requires_grad_() for t in _t(q, k, v))
    assert not tq.is_contiguous()
    out = tfa.flash_attention(tq, tk_, tv, causal=True)
    torch.autograd.grad(out.sum(), (tq, tk_, tv))
    assert tk.LAUNCHES == before


def test_bad_shapes_raise():
    q, k, v, _do = _t(*_inputs(7, 1, 2, 8, 8, 8))
    with pytest.raises(ValueError, match="differ"):
        tfa.flash_attention(q, k[:, :1], v[:, :1])
    with pytest.raises(ValueError, match=r"\[B, H, Tq, d\]"):
        tfa.flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="differ"):
        tfa.flash_attention(q, k[..., :4], v[..., :4])


def test_probe_plain_tf32_variant_keeps_only_the_hi_product():
    from paddle_tpu_torch.kernels import _build, flash_probe
    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    plain = flash_probe.plain_tf32_source(src)
    assert "mma(acc[nt], ahi, b[nt][0], b[nt][1]);" in plain
    assert "alo, b[nt]" not in plain and "b[nt][2], b[nt][3]" not in plain
    assert len(src.splitlines()) == len(plain.splitlines())
    with pytest.raises(ValueError, match="expected one"):
        flash_probe.plain_tf32_source(plain)


def test_probe_fwd_unroll2_variant_changes_only_the_forward_s_product():
    from paddle_tpu_torch.kernels import _build, flash_probe
    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    var = flash_probe.fwd_unroll2_source(src)
    changed = [(a, b) for a, b in zip(src.splitlines(), var.splitlines())
               if a != b]
    assert len(changed) == 1 and len(src.splitlines()) == len(
        var.splitlines())
    assert "prod_rows<kD, kD / 8>(sQ, sK" in changed[0][0]
    assert "prod_rows<kD>(sQ, sK" in changed[0][1]
    with pytest.raises(ValueError, match="expected one"):
        flash_probe.fwd_unroll2_source(var)


# -------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(dev, dtype, B, H, Tq, Tk, d, seed=8):
    q, k, v, do = _inputs(seed, B, H, Tq, Tk, d)
    return [torch.from_numpy(a).to(dev, dtype) for a in (q, k, v, do)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 128, 128, 64, True),
                                   (1, 2, 100, 100, 64, True),
                                   (1, 2, 70, 130, 32, False),
                                   (1, 2, 40, 130, 32, True),
                                   (1, 1, 90, 33, 16, True),
                                   (2, 3, 128, 128, 128, True),
                                   (1, 2, 100, 100, 128, True),
                                   (1, 2, 70, 130, 128, False),
                                   (1, 2, 512, 200, 128, True),
                                   (1, 2, 130, 130, 96, True),
                                   (1, 2, 70, 130, 96, False)])
def test_kernels_match_plain_on_card(cuda_device, dtype, shape):
    """Forward, dq and dk/dv kernels against their plain versions on the
    same card tensors: fp32 to 1e-5 (out) / 1e-4 (grads); bf16 against
    the fp32 plain result, no worse than 1.5x the bf16 plain version's
    error + 1e-3."""
    B, H, Tq, Tk, d, causal = shape
    q, k, v, do = _card_case(cuda_device, dtype, B, H, Tq, Tk, d)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    before = dict(tk.LAUNCHES)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, scale)
    delta = torch.sum(do.float() * out.float(), dim=-1)
    dq = tfa.flash_attention_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        assert tk.LAUNCHES[name] == before[name] + 1
    ref = tfa.flash_attention_fwd_reference
    r_out, r_lse = ref(q, k, v, causal, scale)
    r_dq = tfa.flash_attention_dq_reference(q, k, v, do, r_lse, delta,
                                            causal, scale)
    r_dk, r_dv = tfa.flash_attention_dkv_reference(q, k, v, do, r_lse, delta,
                                                   causal, scale)
    assert torch.allclose(lse, r_lse, atol=1e-5, rtol=0)
    if dtype == torch.float32:
        for got, want, tol in ((out, r_out, 1e-5), (dq, r_dq, 1e-4),
                               (dk, r_dk, 1e-4), (dv, r_dv, 1e-4)):
            assert got.dtype == dtype
            assert float((got - want).abs().max()) <= tol
        return
    f_out, f_lse = ref(q32, k32, v32, causal, scale)
    f_delta = torch.sum(do32 * f_out, dim=-1)
    f_dq = tfa.flash_attention_dq_reference(q32, k32, v32, do32, f_lse,
                                            f_delta, causal, scale)
    f_dk, f_dv = tfa.flash_attention_dkv_reference(q32, k32, v32, do32,
                                                   f_lse, f_delta, causal,
                                                   scale)
    for got, plain, exact in ((out, r_out, f_out), (dq, r_dq, f_dq),
                              (dk, r_dk, f_dk), (dv, r_dv, f_dv)):
        assert got.dtype == torch.bfloat16
        err = float((got.float() - exact).abs().max())
        plain_err = float((plain.float() - exact).abs().max())
        assert err <= 1.5 * plain_err + 1e-3, (err, plain_err)


@pytest.mark.cuda
def test_no_keys_on_card(cuda_device):
    q, k, v, _do = _card_case(cuda_device, torch.float32, 1, 2, 70, 0, 64)
    out, lse = tfa.flash_attention_fwd(q, k, v, True, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(q))
    assert bool((lse == tfa.NEG_INF).all())


@pytest.mark.cuda
def test_autograd_through_kernels_on_card(cuda_device):
    q, k, v, do = _card_case(cuda_device, torch.float32, 2, 2, 96, 96, 64)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    oa = tfa.flash_attention(*a, causal=True)
    ob = tfa.flash_attention_reference(*b, causal=True)
    # a transposed upstream gradient: backward makes it contiguous
    g_up = do.transpose(2, 3).contiguous().transpose(2, 3)
    ga = torch.autograd.grad(oa, a, g_up)
    gb = torch.autograd.grad(ob, b, g_up)
    assert float((oa - ob).detach().abs().max()) <= 1e-5
    for x, y in zip(ga, gb):
        assert float((x - y).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda_device):
    q, k, v, do = _card_case(cuda_device, torch.float32, 1, 2, 16, 16, 64)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(q.transpose(2, 3).contiguous()
                                .transpose(2, 3), k, v, True, 0.1)
    with pytest.raises(TypeError, match="lane"):
        tfa.flash_attention_fwd(q, k.to(torch.bfloat16), v, True, 0.1)
    with pytest.raises(TypeError, match="lane"):
        tfa.flash_attention_fwd(q.half(), k.half(), v.half(), True, 0.1)
    # head_dim 128, the widest capacity, runs; 129 raises naming C4
    wide = [torch.zeros(1, 1, 8, 128, device=cuda_device, dtype=dt)
            for dt in (torch.float32, torch.bfloat16) for _ in range(3)]
    for x in (wide[:3], wide[3:]):
        out, lse = tfa.flash_attention_fwd(*x, True, 0.1)
        torch.cuda.synchronize()
        assert out.shape == x[0].shape and not out.any()
        want = torch.log(torch.arange(1, 9.0, device=cuda_device))
        assert torch.allclose(lse[0, 0], want, atol=1e-6, rtol=0)
    wider = [torch.zeros(1, 1, 8, 129, device=cuda_device)
             for _ in range(3)]
    with pytest.raises(ValueError, match="head_dim.*ROADMAP C4"):
        tfa.flash_attention_fwd(*wider, True, 0.1)
    odd = [torch.zeros(1, 1, 8, 12, device=cuda_device,
                       dtype=torch.bfloat16) for _ in range(3)]
    with pytest.raises(ValueError, match="multiple of 8.*ROADMAP C4"):
        tfa.flash_attention_fwd(*odd, True, 0.1)
    tfa.flash_attention_fwd(*[x.float() for x in odd], True, 0.1)  # fp32: ok
    shifted = torch.zeros(8 * 64 + 4, device=cuda_device,
                          dtype=torch.bfloat16)[4:].view(1, 1, 8, 64)
    ok = torch.zeros(1, 1, 8, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention_fwd(shifted, ok, ok, True, 0.1)
    lse = torch.zeros(1, 2, 16, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="lse"):
        tfa.flash_attention_dq(q, k, v, do, lse, lse.float(), True, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 500, 500, 64, True),
                                   (1, 2, 200, 512, 64, False),
                                   (1, 2, 200, 512, 64, True),
                                   (2, 2, 300, 300, 32, True),
                                   (1, 2, 70, 0, 64, True),
                                   (1, 2, 500, 500, 128, True),
                                   (1, 2, 200, 512, 128, False),
                                   (2, 2, 300, 300, 96, True),
                                   (1, 2, 70, 0, 128, True)])
def test_bf16_forward_ragged_and_bit_equal_on_card(cuda_device, shape):
    """B8's bf16 kernel (wgmma, a cp.async ring, masks on the diagonal and
    tail tiles only) at a ragged T, Tq != Tk, d 32 and Tk = 0: lse within
    1e-5 of the plain version, out no further from the fp32 plain result
    than 1.5x the bf16 plain version + 1e-3, and two launches
    bit-equal."""
    B, H, Tq, Tk, d, causal = shape
    q, k, v, _do = _card_case(cuda_device, torch.bfloat16, B, H, Tq, Tk, d)
    scale = 1.0 / math.sqrt(d)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, scale)
    out2, lse2 = tfa.flash_attention_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    if Tk == 0:
        assert not out.any() and bool((lse == tfa.NEG_INF).all())
        return
    r_out, r_lse = tfa.flash_attention_fwd_reference(q, k, v, causal, scale)
    f_out, _ = tfa.flash_attention_fwd_reference(q.float(), k.float(),
                                                 v.float(), causal, scale)
    assert float((lse - r_lse).abs().max()) <= 1e-5
    err = float((out.float() - f_out).abs().max())
    plain_err = float((r_out.float() - f_out).abs().max())
    assert err <= 1.5 * plain_err + 1e-3, (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_forward_negative_scale_on_card(cuda_device, causal):
    """A scale <= 0 takes the bf16 forward's other instantiation (the row
    max of the scaled scores, not the raw ones): the same gates."""
    q, k, v, _do = _card_case(cuda_device, torch.bfloat16, 2, 3, 200, 200,
                              64)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, -0.125)
    torch.cuda.synchronize()
    r_out, r_lse = tfa.flash_attention_fwd_reference(q, k, v, causal,
                                                     -0.125)
    f_out, _ = tfa.flash_attention_fwd_reference(q.float(), k.float(),
                                                 v.float(), causal, -0.125)
    assert float((lse - r_lse).abs().max()) <= 1e-5
    err = float((out.float() - f_out).abs().max())
    plain_err = float((r_out.float() - f_out).abs().max())
    assert err <= 1.5 * plain_err + 1e-3, (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_fp32_forward_negative_scale_on_card(cuda_device, causal, d):
    """The fp32 forward takes each row's max on the scaled scores, so a
    scale <= 0 needs no other path: out and lse within 1e-5 of the plain
    version, at both head_dim capacities, and two launches bit-equal."""
    q, k, v, _do = _card_case(cuda_device, torch.float32, 2, 3, 200, 200, d)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, -0.125)
    out2, lse2 = tfa.flash_attention_fwd(q, k, v, causal, -0.125)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    r_out, r_lse = tfa.flash_attention_fwd_reference(q, k, v, causal,
                                                     -0.125)
    assert float((out - r_out).abs().max()) <= 1e-5
    assert float((lse - r_lse).abs().max()) <= 1e-5


# B9 on the card: (B, H, Tq, Tk, d, causal). d 32 / 40 / 64; a ragged T;
# Tq != Tk both ways, causal and not; 8 x 12 heads at T 512 (768 q tiles,
# more blocks than the card holds at once); one tile (the causal diagonal
# alone); Tk = 0 (dq = 0)
B9_CARD_SHAPES = [
    (2, 3, 256, 256, 32, True),
    (2, 3, 256, 256, 40, True),
    (2, 3, 256, 256, 64, False),
    (1, 2, 500, 500, 64, True),
    (1, 2, 200, 512, 64, True),
    (1, 2, 200, 512, 64, False),
    (1, 2, 512, 200, 64, True),
    (1, 2, 512, 200, 64, False),
    (8, 12, 512, 512, 64, True),
    (1, 2, 64, 64, 64, True),
    (1, 2, 70, 0, 64, True),
    (2, 3, 256, 256, 128, True),
    (2, 3, 256, 256, 96, False),
    (1, 2, 500, 500, 128, True),
    (1, 2, 200, 512, 128, True),
    (1, 2, 512, 200, 128, False),
    (4, 8, 512, 512, 128, True),
    (1, 2, 70, 0, 128, True),
]
B9_CARD_IDS = [f"{s[0]}x{s[1]}-{s[2]}x{s[3]}-d{s[4]}-"
               f"{'causal' if s[5] else 'full'}" for s in B9_CARD_SHAPES]


def _b9_on_card(q, k, v, do, causal, scale):
    """dq and dk/dv launched twice from the plain forward's lse and
    delta; asserts the two launches bit-equal and returns the first."""
    out, lse = tfa.flash_attention_fwd_reference(q, k, v, causal, scale)
    delta = torch.sum(do.float() * out.float(), dim=-1)
    args = (q, k, v, do, lse, delta, causal, scale)
    first = (tfa.flash_attention_dq(*args), *tfa.flash_attention_dkv(*args))
    again = (tfa.flash_attention_dq(*args), *tfa.flash_attention_dkv(*args))
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    return first, lse, delta


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", B9_CARD_SHAPES, ids=B9_CARD_IDS)
def test_backward_kernels_match_plain_and_repeat_on_card(cuda_device, dtype,
                                                         shape):
    """B9's dq and dk/dv (fp32 as 3xTF32 on mma.sync, bf16 on wgmma fed
    by the cp.async ring) against their plain versions on the same lse
    and delta: fp32 to 1e-4; bf16 against the fp32 plain result,
    no worse than 1.5x the bf16 plain version's error + 1e-3. Two launches
    are bit-equal."""
    B, H, Tq, Tk, d, causal = shape
    q, k, v, do = _card_case(cuda_device, dtype, B, H, Tq, Tk, d)
    scale = 1.0 / math.sqrt(d)
    got, lse, delta = _b9_on_card(q, k, v, do, causal, scale)
    args = (q, k, v, do, lse, delta, causal, scale)
    plain = (tfa.flash_attention_dq_reference(*args),
             *tfa.flash_attention_dkv_reference(*args))
    if Tk == 0:
        assert not got[0].any()
    f32 = [t.float() for t in (q, k, v, do)]
    exact = (tfa.flash_attention_dq_reference(*f32, *args[4:]),
             *tfa.flash_attention_dkv_reference(*f32, *args[4:]))
    for g, p, e in zip(got, plain, exact):
        assert g.dtype == dtype and g.shape == p.shape
        if not g.numel():
            continue
        if dtype == torch.float32:
            assert float((g - p).abs().max()) <= 1e-4
        else:
            err = float((g.float() - e).abs().max())
            plain_err = float((p.float() - e).abs().max())
            assert err <= 1.5 * plain_err + 1e-3, (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("d, offset", [(33, 0), (64, 1), (36, 1), (100, 0),
                                       (128, 1)],
                         ids=["d33", "unaligned", "d36-unaligned", "d100",
                              "d128-unaligned"])
def test_fp32_backward_scalar_staging_on_card(cuda_device, d, offset):
    """The fp32 lane stages by scalar loads when a row is no whole
    number of 16-byte pieces (d 33) or a tensor starts off a 16-byte
    boundary, at both head_dim capacities: the backward to the same 1e-4
    against the plain versions, the forward to 1e-5, and bit-equal
    launches."""
    q, k, v, do = _card_case(cuda_device, torch.float32, 1, 2, 130, 130, d)
    if offset:
        q, k, v, do = (torch.cat([torch.zeros(offset, device=cuda_device),
                                  t.flatten()])[offset:].view(t.shape)
                       for t in (q, k, v, do))
        assert q.data_ptr() % 16
    scale = 1.0 / math.sqrt(d)
    got, lse, delta = _b9_on_card(q, k, v, do, True, scale)
    args = (q, k, v, do, lse, delta, True, scale)
    plain = (tfa.flash_attention_dq_reference(*args),
             *tfa.flash_attention_dkv_reference(*args))
    for g, p in zip(got, plain):
        assert float((g - p).abs().max()) <= 1e-4
    out, f_lse = tfa.flash_attention_fwd(q, k, v, True, scale)
    out2, f_lse2 = tfa.flash_attention_fwd(q, k, v, True, scale)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(f_lse, f_lse2)
    r_out, r_lse = tfa.flash_attention_fwd_reference(q, k, v, True, scale)
    assert float((out - r_out).abs().max()) <= 1e-5
    assert float((f_lse - r_lse).abs().max()) <= 1e-5
