"""The port's paged_attention (decode step) and paged_attention_chunk
(prefill chunk), held against the JAX package.

On the CPU each wrapper runs its plain version, which must agree with
the JAX Pallas kernel run in interpret mode and with the JAX dense
reference: atol/rtol 1e-5 in float32, because the two sum in another
order. Lanes: float32, bfloat16, and int8 / fp8-e4m3 pools with random
nonzero per-block scales, whose blocks both sides dequantize with the
stored scale before the same fp32 fold. Cases cover ragged contexts (0,
1, block edges, the full table), rung padding rows (context 0),
prefix-hit offsets, and stale table entries past a slot's page count.

The kernel-vs-plain cases need a card and skip without one:
``python -m pytest --noconftest -m cuda
tests/test_torch_paged_attention_decode.py``.
"""
import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.kernels import paged_attention as tpa

TOL = dict(atol=1e-5, rtol=1e-5)


def _pools(seed, dtype, N, H, B, d):
    """Random pools of ``dtype`` as torch tensors, with random nonzero
    per-block scales [N, H] for the 1-byte payloads (None otherwise)
    that dequantize to magnitudes of at most about 2."""
    rng = np.random.default_rng(100 + seed)
    shape = (N, H, B, d)
    if dtype in ("float32", "bfloat16"):
        k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) for _ in range(2))
        if dtype == "bfloat16":
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        return k, v, None, None
    if dtype == "int8":
        k, v = (torch.from_numpy(rng.integers(-127, 128, shape,
                                              dtype=np.int8))
                for _ in range(2))
    else:
        k, v = (torch.from_numpy(rng.uniform(-448, 448, shape).astype(
            np.float32)).to(torch.float8_e4m3fn) for _ in range(2))
    qmax = 127.0 if dtype == "int8" else 448.0
    ks, vs = (torch.from_numpy((rng.uniform(0.5, 2.0, (N, H)) / qmax)
                               .astype(np.float32)) for _ in range(2))
    return k, v, ks, vs


def _decode_case(seed, S=9, H=2, d=16, B=4, P=6, N=20):
    """q [S, H, d], tables [S, P] (every entry a valid block id: entries
    past a slot's page count are stale), seq_lens with the edges."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, d)).astype(np.float32)
    tables = rng.integers(0, N, (S, P)).astype(np.int32)
    edge = [0, 1, B - 1, B, B + 1, P * B, P * B - 1]
    lens = np.concatenate([edge, rng.integers(0, P * B + 1, S)])[:S]
    return q, tables, lens.astype(np.int32)


def _chunk_case(seed, S=2, G=7, H=2, d=16, B=4, P=6, N=20, pad=2):
    """q [S, G, H, d] and ctx [S, G] as a padded prefill writes them:
    slot s's chunk starts at a random offset (a prefix hit), the last
    ``pad`` rows are rung padding (ctx 0), and slot 0's chunk starts at
    0; contexts never pass the table."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, G, H, d)).astype(np.float32)
    tables = rng.integers(0, N, (S, P)).astype(np.int32)
    ctx = np.zeros((S, G), np.int32)
    for s in range(S):
        start = 0 if s == 0 else int(rng.integers(0, P * B - G + pad + 1))
        n = G - pad
        ctx[s, :n] = start + np.arange(n) + 1
    return q, tables, ctx


@pytest.fixture(scope="module")
def jx():
    """The JAX side: ``jnp`` and the JAX package's kernel module."""
    jax_numpy = pytest.importorskip("jax.numpy")
    from paddle_tpu.kernels import paged_attention
    return types.SimpleNamespace(jnp=jax_numpy, pa=paged_attention)


def _to_jax(jnp, t):
    """A torch tensor as the JAX array of the same bytes."""
    import ml_dtypes
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(
            ml_dtypes.float8_e4m3fn))
    return jnp.asarray(t.numpy())


def _jax_scales(jnp, ks, vs):
    return {} if ks is None else dict(k_scale=jnp.asarray(ks.numpy()),
                                      v_scale=jnp.asarray(vs.numpy()))


LANES = ["float32", "bfloat16", "int8", "fp8-e4m3"]


@pytest.mark.parametrize("dtype", LANES)
@pytest.mark.parametrize("seed,shape", [
    (0, {}), (1, dict(B=8, P=3)), (2, dict(S=5, H=3, d=8, B=2, P=9)),
    (3, dict(S=4, B=16, P=2, d=64))])
def test_decode_plain_matches_jax_kernel_and_reference(jx, dtype, seed,
                                                       shape):
    jnp, jpa = jx.jnp, jx.pa
    q, tables, lens = _decode_case(seed, **shape)
    B = shape.get("B", 4)
    k, v, ks, vs = _pools(seed, dtype, 20, q.shape[1], B, q.shape[2])
    kw = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    got = tpa.paged_attention(torch.from_numpy(q), k, v,
                              torch.from_numpy(tables),
                              torch.from_numpy(lens), **kw).numpy()
    jargs = (jnp.asarray(q), _to_jax(jnp, k), _to_jax(jnp, v), tables,
             lens)
    jsc = _jax_scales(jnp, ks, vs)
    jk = np.asarray(jpa.paged_attention(*jargs, interpret=True, **jsc))
    jr = np.asarray(jpa.paged_attention_reference(*jargs, **jsc))
    np.testing.assert_allclose(got, jk, **TOL)
    np.testing.assert_allclose(got, jr, **TOL)
    assert not got[lens == 0].any()                 # exact zero rows
    assert got[lens > 0].any(axis=(1, 2)).all()


@pytest.mark.parametrize("dtype", LANES)
@pytest.mark.parametrize("seed,shape", [
    (0, {}), (1, dict(S=1, G=9, B=8, P=3, pad=3)),
    (2, dict(S=3, G=5, H=3, d=8, B=2, P=9, pad=1)),
    (3, dict(S=1, G=12, B=16, P=2, d=64, pad=4))])
def test_chunk_plain_matches_jax_kernel_and_reference(jx, dtype, seed,
                                                      shape):
    jnp, jpa = jx.jnp, jx.pa
    q, tables, ctx = _chunk_case(seed, **shape)
    B = shape.get("B", 4)
    k, v, ks, vs = _pools(seed, dtype, 20, q.shape[2], B, q.shape[3])
    kw = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    got = tpa.paged_attention_chunk(torch.from_numpy(q), k, v,
                                    torch.from_numpy(tables),
                                    torch.from_numpy(ctx), **kw).numpy()
    jargs = (jnp.asarray(q), _to_jax(jnp, k), _to_jax(jnp, v), tables,
             ctx)
    jsc = _jax_scales(jnp, ks, vs)
    jk = np.asarray(jpa.paged_attention_chunk(*jargs, interpret=True,
                                              **jsc))
    jr = np.asarray(jpa.paged_attention_chunk_reference(*jargs, **jsc))
    np.testing.assert_allclose(got, jk, **TOL)
    np.testing.assert_allclose(got, jr, **TOL)
    assert got.shape == q.shape
    assert not got[ctx == 0].any()                  # padding rows: zeros
    assert got[ctx > 0].any(axis=(1, 2)).all()


def test_chunk_rows_are_decode_rows():
    """Each chunk row equals the decode form at the same context, and a
    chunk of one row equals it bit for bit (the plain chunk form is a
    loop of the decode reference)."""
    q, tables, ctx = _chunk_case(4, S=2, G=6)
    k, v, _ks, _vs = _pools(4, "float32", 20, 2, 4, 16)
    tq, tt, tc = (torch.from_numpy(a) for a in (q, tables, ctx))
    chunk = tpa.paged_attention_chunk(tq, k, v, tt, tc)
    for g in range(q.shape[1]):
        one = tpa.paged_attention_chunk(tq[:, g:g + 1].contiguous(), k, v,
                                        tt, tc[:, g:g + 1].contiguous())
        dec = tpa.paged_attention(tq[:, g].contiguous(), k, v, tt,
                                  tc[:, g].contiguous())
        torch.testing.assert_close(one[:, 0], dec, rtol=0, atol=0)
        torch.testing.assert_close(chunk[:, g], dec, rtol=0, atol=0)


@pytest.mark.parametrize("form", ["decode", "chunk"])
def test_stale_entries_past_page_count_are_ignored(form):
    B, N = 4, 20
    k, v, _ks, _vs = _pools(5, "float32", N, 2, B, 16)
    if form == "decode":
        q, tables, lens = _decode_case(5)
        need = -(-lens // B)                       # pages read per slot
        call = tpa.paged_attention
    else:
        q, tables, lens = _chunk_case(5, S=3)
        need = -(-lens.max(axis=1) // B)
        call = tpa.paged_attention_chunk
    base = call(torch.from_numpy(q), k, v, torch.from_numpy(tables),
                torch.from_numpy(lens))
    stale = tables.copy()
    for s in range(tables.shape[0]):               # every unread entry
        stale[s, need[s]:] = (stale[s, need[s]:] + 7) % N
    assert not np.array_equal(stale, tables)
    again = call(torch.from_numpy(q), k, v, torch.from_numpy(stale),
                 torch.from_numpy(lens))
    torch.testing.assert_close(again, base, rtol=0, atol=0)


@pytest.mark.parametrize("form,bad", [
    ("decode", "q_rank"), ("decode", "pool_heads"),
    ("decode", "pool_mismatch"), ("decode", "lens_len"),
    ("decode", "tables_rows"), ("decode", "one_scale"),
    ("decode", "scale_shape"), ("chunk", "q_rank"),
    ("chunk", "pool_heads"), ("chunk", "ctx_shape"),
    ("chunk", "tables_rows"), ("chunk", "one_scale"),
    ("chunk", "scale_shape")])
def test_shape_and_scale_validation(form, bad):
    k, v, ks, vs = _pools(6, "int8", 20, 2, 4, 16)
    if form == "decode":
        q, tables, lens = (torch.from_numpy(a) for a in _decode_case(6))
        call = tpa.paged_attention
    else:
        q, tables, lens = (torch.from_numpy(a) for a in _chunk_case(6))
        call = tpa.paged_attention_chunk
    if bad == "q_rank":
        q = q[None]
    elif bad == "pool_heads":
        k = v = k[:, :1]
    elif bad == "pool_mismatch":
        v = v[:-1]
    elif bad in ("lens_len", "ctx_shape"):
        lens = lens[..., :-1]
    elif bad == "tables_rows":
        tables = tables[:-1]
    elif bad == "one_scale":
        vs = None
    else:
        ks = vs = ks[:-1]
    with pytest.raises(ValueError):
        call(q, k, v, tables, lens, k_scale=ks, v_scale=vs)


def test_unknown_device_raises_instead_of_falling_back():
    k, v, _ks, _vs = (None if x is None else x.to("meta")
                      for x in _pools(7, "float32", 20, 2, 4, 16))
    q, tables, lens = (torch.from_numpy(a).to("meta")
                       for a in _decode_case(7))
    with pytest.raises(ValueError, match="meta"):
        tpa.paged_attention(q, k, v, tables, lens)
    q, tables, ctx = (torch.from_numpy(a).to("meta")
                      for a in _chunk_case(7))
    with pytest.raises(ValueError, match="meta"):
        tpa.paged_attention_chunk(q, k, v, tables, ctx)


def test_cpu_path_launches_no_kernel():
    tk.reset_launches()
    for dtype in LANES:
        k, v, ks, vs = _pools(8, dtype, 20, 2, 4, 16)
        q, tables, lens = (torch.from_numpy(a) for a in _decode_case(8))
        tpa.paged_attention(q, k, v, tables, lens, k_scale=ks, v_scale=vs)
        q, tables, ctx = (torch.from_numpy(a) for a in _chunk_case(8))
        tpa.paged_attention_chunk(q, k, v, tables, ctx, k_scale=ks,
                                  v_scale=vs)
    assert {"paged_attention", "paged_attention_quant",
            "paged_attention_chunk",
            "paged_attention_chunk_quant"} <= set(tk.LAUNCHES)
    assert not any(tk.LAUNCHES.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


def _on(dev, *xs):
    return [None if x is None else x.to(dev) for x in xs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LANES)
def test_decode_kernel_matches_plain_on_card(cuda_device, dtype):
    q, tables, lens = _decode_case(9, S=16, H=12, d=64, B=16, P=32, N=600)
    lens[-1] = 0
    k, v, ks, vs = _on(cuda_device, *_pools(9, dtype, 600, 12, 16, 64))
    q, tables, lens = _on(cuda_device, *(torch.from_numpy(a)
                                         for a in (q, tables, lens)))
    tk.reset_launches()
    got = tpa.paged_attention(q, k, v, tables, lens, k_scale=ks,
                              v_scale=vs)
    torch.cuda.synchronize()
    counter = "paged_attention_quant" if ks is not None \
        else "paged_attention"
    assert tk.LAUNCHES[counter] == 1 and sum(tk.LAUNCHES.values()) == 1
    want = tpa.paged_attention_reference(q, k, v, tables, lens,
                                         k_scale=ks, v_scale=vs)
    torch.testing.assert_close(got, want, **TOL)
    assert not got[lens == 0].any()
    with pytest.raises(TypeError):
        tpa.paged_attention(q.double(), k, v, tables, lens, k_scale=ks,
                            v_scale=vs)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, k.cpu(), v, tables, lens, k_scale=ks,
                            v_scale=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LANES)
@pytest.mark.parametrize("G,start,pad", [(1, 37, 0), (48, 0, 5),
                                         (40, 128, 7), (509, 0, 0)])
def test_chunk_kernel_matches_plain_on_card(cuda_device, dtype, G, start,
                                            pad):
    rng = np.random.default_rng(10)
    q = torch.from_numpy(rng.standard_normal((2, G, 12, 64)).astype(
        np.float32))
    tables = torch.from_numpy(rng.integers(0, 600, (2, 32)).astype(
        np.int32))
    ctx = np.zeros((2, G), np.int32)
    ctx[:, :G - pad] = start + np.arange(G - pad) + 1
    ctx[1] = np.where(ctx[1] > 0, ctx[1] + 3, 0)   # <= 512 = P * B
    k, v, ks, vs = _on(cuda_device, *_pools(10, dtype, 600, 12, 16, 64))
    q, tables, ctx = _on(cuda_device, q, tables, torch.from_numpy(ctx))
    tk.reset_launches()
    got = tpa.paged_attention_chunk(q, k, v, tables, ctx, k_scale=ks,
                                    v_scale=vs)
    torch.cuda.synchronize()
    counter = "paged_attention_chunk_quant" if ks is not None \
        else "paged_attention_chunk"
    assert tk.LAUNCHES[counter] == 1 and sum(tk.LAUNCHES.values()) == 1
    want = tpa.paged_attention_chunk_reference(q, k, v, tables, ctx,
                                               k_scale=ks, v_scale=vs)
    torch.testing.assert_close(got, want, **TOL)
    assert not got[ctx == 0].any()
    if G == 1:      # a one-row chunk against the decode kernel
        dec = tpa.paged_attention(q[:, 0].contiguous(), k, v, tables,
                                  ctx[:, 0].contiguous(), k_scale=ks,
                                  v_scale=vs)
        torch.testing.assert_close(got[:, 0], dec, **TOL)
