"""The port's paged_attention_mixed, held against the JAX package.

On the CPU the wrapper runs its plain version, which must agree with
the JAX Pallas kernel run in interpret mode and with the JAX dense
reference: atol/rtol 1e-5 in float32, because the two sum in another
order. Cases cover ragged contexts (0, 1, block boundaries), rows
sharing a slot, and stale table entries past a row's page count. The
same holds for bfloat16 pools and for int8 / fp8-e4m3 pools with random
nonzero per-block scales, whose blocks both sides dequantize with the
stored scale before the same fp32 fold.

The kernel-vs-plain case needs a card and skips without one. JAX is
imported inside the cases that use it, so that case also runs where
JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_paged_attention.py``.
"""
import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.kernels import paged_attention as tpa

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, T=11, H=2, d=16, B=4, P=6, N=20, S=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, H, d)).astype(np.float32)
    k = rng.standard_normal((N, H, B, d)).astype(np.float32)
    v = rng.standard_normal((N, H, B, d)).astype(np.float32)
    # every entry is a valid block id; entries past a row's page count
    # are stale ids the kernel must never need
    tables = rng.integers(0, N, (S, P)).astype(np.int32)
    slots = rng.integers(0, S, (T,)).astype(np.int32)
    slots[:3] = 1                                   # rows sharing a slot
    edge = [0, 1, B - 1, B, B + 1, 2 * B, P * B, P * B - 1]
    ctx = np.concatenate([edge, rng.integers(0, P * B + 1, T)])[:T]
    return q, k, v, tables, slots, ctx.astype(np.int32)


@pytest.fixture(scope="module")
def jx():
    """The JAX side: ``jnp`` and the JAX package's kernel module."""
    jax_numpy = pytest.importorskip("jax.numpy")
    from paddle_tpu.kernels import paged_attention
    return types.SimpleNamespace(jnp=jax_numpy, pa=paged_attention)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed,shape", [
    (0, {}), (1, dict(B=8, P=3)), (2, dict(H=3, d=8, B=2, P=9)),
    (3, dict(T=5, B=16, P=2, d=64))])
def test_plain_matches_jax_kernel_and_reference(jx, seed, shape):
    jnp, jpa = jx.jnp, jx.pa
    q, k, v, tables, slots, ctx = _case(seed, **shape)
    got = tpa.paged_attention_mixed(*_torch(q, k, v, tables, slots,
                                            ctx)).numpy()
    jk = np.asarray(jpa.paged_attention_mixed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), tables, slots,
        ctx, interpret=True))
    jr = np.asarray(jpa.paged_attention_mixed_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), tables, slots,
        ctx))
    np.testing.assert_allclose(got, jk, **TOL)
    np.testing.assert_allclose(got, jr, **TOL)
    assert not got[ctx == 0].any()                  # exact zero rows


def test_stale_entries_past_page_count_are_ignored():
    q, k, v, tables, slots, ctx = _case(4)
    base = tpa.paged_attention_mixed(*_torch(q, k, v, tables, slots, ctx))
    B = k.shape[2]
    stale = tables.copy()
    for t in range(len(ctx)):          # rewrite every unread entry
        stale[slots[t], -(-int(ctx[t]) // B):] = (
            stale[slots[t], -(-int(ctx[t]) // B):] + 7) % k.shape[0]
    # a page another row of the same slot reads must stay put
    for s in set(slots.tolist()):
        need = max(-(-int(c) // B) for c in ctx[slots == s])
        stale[s, :need] = tables[s, :need]
    again = tpa.paged_attention_mixed(*_torch(q, k, v, stale, slots, ctx))
    torch.testing.assert_close(again, base, rtol=0, atol=0)


def test_reference_forms_agree(jx):
    jnp, jpa = jx.jnp, jx.pa
    q, k, v, tables, slots, ctx = _case(5)
    tq, tkp, tvp, tt, ts, tc = _torch(q, k, v, tables, slots, ctx)
    mixed = tpa.paged_attention_mixed_reference(tq, tkp, tvp, tt, ts, tc)
    dense = tpa.paged_attention_reference(tq, tkp, tvp, tt[ts.long()], tc)
    torch.testing.assert_close(mixed, dense, rtol=0, atol=0)
    j = np.asarray(jpa.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), tables[slots],
        ctx))
    np.testing.assert_allclose(dense.numpy(), j, **TOL)


@pytest.mark.parametrize("bad", ["q_rank", "pool_heads", "pool_mismatch",
                                 "slots_len", "ctx_len"])
def test_shape_validation(bad):
    q, k, v, tables, slots, ctx = _torch(*_case(6))
    if bad == "q_rank":
        q = q[None]
    elif bad == "pool_heads":
        k = v = k[:, :1]
    elif bad == "pool_mismatch":
        v = v[:-1]
    elif bad == "slots_len":
        slots = slots[:-1]
    else:
        ctx = ctx[:-2]
    with pytest.raises(ValueError):
        tpa.paged_attention_mixed(q, k, v, tables, slots, ctx)


def test_unknown_device_raises_instead_of_falling_back():
    q, k, v, tables, slots, ctx = (x.to("meta")
                                   for x in _torch(*_case(7)))
    with pytest.raises(ValueError, match="meta"):
        tpa.paged_attention_mixed(q, k, v, tables, slots, ctx)


def test_cpu_path_launches_no_kernel():
    tk.reset_launches()
    tpa.paged_attention_mixed(*_torch(*_case(8)))
    k, v, ks, vs = _quant_pools(8, "int8", 20, 2, 4, 16)
    q, _k, _v, tables, slots, ctx = _torch(*_case(8))
    tpa.paged_attention_mixed(q, k, v, tables, slots, ctx, k_scale=ks,
                              v_scale=vs)
    assert set(tk.LAUNCHES) == {"paged_attention_mixed",
                                "paged_attention_mixed_quant",
                                "paged_attention", "paged_attention_quant",
                                "paged_attention_chunk",
                                "paged_attention_chunk_quant",
                                "quant_matmul", "flash_attention_fwd",
                                "flash_attention_dq", "flash_attention_dkv"}
    assert not any(tk.LAUNCHES.values())


def _quant_pools(seed, dtype, N, H, B, d):
    """Random pools of a 1-byte or bfloat16 payload as torch tensors,
    with random nonzero per-block scales [N, H] (None for bfloat16) that
    dequantize to magnitudes of at most about 2, as calibrated K/V."""
    rng = np.random.default_rng(100 + seed)
    if dtype == "bfloat16":
        k, v = (torch.from_numpy(rng.standard_normal((N, H, B, d)).astype(
            np.float32)).to(torch.bfloat16) for _ in range(2))
        return k, v, None, None
    if dtype == "int8":
        k, v = (torch.from_numpy(rng.integers(-127, 128, (N, H, B, d),
                                              dtype=np.int8))
                for _ in range(2))
    else:
        k, v = (torch.from_numpy(rng.uniform(-448, 448, (N, H, B, d))
                                 .astype(np.float32)).to(
                                     torch.float8_e4m3fn)
                for _ in range(2))
    qmax = 127.0 if dtype == "int8" else 448.0
    ks, vs = (torch.from_numpy((rng.uniform(0.5, 2.0, (N, H)) / qmax)
                               .astype(np.float32)) for _ in range(2))
    return k, v, ks, vs


def _to_jax(jnp, t):
    """A torch payload as the JAX dtype of the same bytes."""
    import ml_dtypes
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(
            ml_dtypes.float8_e4m3fn))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("dtype", ["int8", "fp8-e4m3", "bfloat16"])
@pytest.mark.parametrize("seed,shape", [
    (0, {}), (1, dict(B=8, P=3)), (3, dict(T=5, B=16, P=2, d=64))])
def test_quantized_plain_matches_jax_kernel_and_reference(jx, dtype, seed,
                                                          shape):
    jnp, jpa = jx.jnp, jx.pa
    q, k32, _v, tables, slots, ctx = _case(seed, **shape)
    N, H, B, d = k32.shape
    k, v, ks, vs = _quant_pools(seed, dtype, N, H, B, d)
    tq, tt, ts, tc = _torch(q, tables, slots, ctx)
    got = tpa.paged_attention_mixed(tq, k, v, tt, ts, tc, k_scale=ks,
                                    v_scale=vs).numpy()
    jsc = {} if ks is None else dict(k_scale=jnp.asarray(ks.numpy()),
                                     v_scale=jnp.asarray(vs.numpy()))
    jargs = (jnp.asarray(q), _to_jax(jnp, k), _to_jax(jnp, v), tables,
             slots, ctx)
    jk = np.asarray(jpa.paged_attention_mixed(*jargs, interpret=True,
                                              **jsc))
    jr = np.asarray(jpa.paged_attention_mixed_reference(*jargs, **jsc))
    np.testing.assert_allclose(got, jk, **TOL)
    np.testing.assert_allclose(got, jr, **TOL)
    assert not got[ctx == 0].any()
    if ks is not None:
        # the scales are applied: doubling block 0's K scale moves only
        # the rows whose context reads block 0
        ks2 = ks.clone()
        ks2[tables[slots[ctx > 0][0], 0]] *= 2.0
        moved = tpa.paged_attention_mixed(tq, k, v, tt, ts, tc,
                                          k_scale=ks2, v_scale=vs).numpy()
        assert not np.array_equal(moved, got)


@pytest.mark.parametrize("bad", ["one_scale", "scale_shape"])
def test_scale_validation(bad):
    q, k, v, tables, slots, ctx = _torch(*_case(6))
    k, v, ks, vs = _quant_pools(6, "int8", *k.shape)
    if bad == "one_scale":
        vs = None
    else:
        ks = vs = ks[:-1]
    with pytest.raises(ValueError):
        tpa.paged_attention_mixed(q, k, v, tables, slots, ctx, k_scale=ks,
                                  v_scale=vs)


def test_build_is_keyed_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    from paddle_tpu_torch.kernels import _build
    src = tmp_path / "k.cu"
    src.write_text("extern \"C\" int f() { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build._lib_path("k")
    assert first.parent == tmp_path / "build" and first.suffix == ".so"
    src.write_text("extern \"C\" int f() { return 1; }\n")
    assert _build._lib_path("k") != first        # an edit rebuilds
    with pytest.raises(FileNotFoundError):
        _build._lib_path("missing")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["k"])
    assert not (tmp_path / "build").exists() or \
        not list((tmp_path / "build").iterdir())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    q, k, v, tables, slots, ctx = _case(9, T=80, H=12, d=64, B=16, P=32,
                                        N=600, S=16)
    args = [x.to(cuda_device) for x in _torch(q, k, v, tables, slots,
                                              ctx)]
    tk.reset_launches()
    got = tpa.paged_attention_mixed(*args)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["paged_attention_mixed"] == 1
    want = tpa.paged_attention_mixed_reference(*args)
    torch.testing.assert_close(got, want, **TOL)
    with pytest.raises(TypeError):
        tpa.paged_attention_mixed(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        tpa.paged_attention_mixed(args[0], args[1].cpu(), *args[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8-e4m3", "bfloat16"])
def test_quantized_kernel_matches_plain_on_card(cuda_device, dtype):
    q, k, v, tables, slots, ctx = _case(9, T=80, H=12, d=64, B=16, P=32,
                                        N=600, S=16)
    k, v, ks, vs = _quant_pools(9, dtype, *k.shape)
    args = [x.to(cuda_device) for x in _torch(q, tables, slots, ctx)]
    pools = [x if x is None else x.to(cuda_device)
             for x in (k, v, ks, vs)]
    tk.reset_launches()
    got = tpa.paged_attention_mixed(args[0], pools[0], pools[1], *args[1:],
                                    k_scale=pools[2], v_scale=pools[3])
    torch.cuda.synchronize()
    counter = ("paged_attention_mixed" if dtype == "bfloat16"
               else "paged_attention_mixed_quant")
    assert tk.LAUNCHES[counter] == 1 and sum(tk.LAUNCHES.values()) == 1
    want = tpa.paged_attention_mixed_reference(
        args[0], pools[0], pools[1], *args[1:], k_scale=pools[2],
        v_scale=pools[3])
    torch.testing.assert_close(got, want, **TOL)
    assert not got[args[3] == 0].any()
    # a 1-byte lane needs its scales; a float lane takes none
    ones = torch.ones(tuple(pools[0].shape[:2]), device=cuda_device)
    scales = {} if ks is not None else dict(k_scale=ones, v_scale=ones)
    with pytest.raises(TypeError):
        tpa.paged_attention_mixed(args[0], pools[0], pools[1], *args[1:],
                                  **scales)
