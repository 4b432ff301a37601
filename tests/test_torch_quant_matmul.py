"""The port's quant_matmul, held against the JAX package.

``quantize_weight`` must give the same payload bytes (fp8 compared as
uint8) and the same scales. The plain ``quant_matmul_reference`` (what
the wrapper runs on the CPU) must agree with the JAX Pallas kernel in
interpret mode and with the JAX reference:

- int8: the integer dot is exact on both sides (float64 here, int32
  there), so only the fp32 epilogue can round differently: atol
  ``1e-6 * max|out|``;
- fp8-e4m3: the e4m3 products are exact in fp32 but summed in another
  order over K <= 3072: atol ``1e-5 * max|out|``.

Both stay within ``quant_matmul_error_bound`` of the fp32 product. An
all-max row at K=3072 (127 * 127 * 3072 = 4.95e7, past the 2^24 where an
fp32 sum stops being exact) must give the exact value.

``qmm_plan``, the CUDA kernel's split of K (pure Python), is held on the
CPU at the decoder's and the card tests' shapes. The kernel-vs-plain
cases need a card and skip without one."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.kernels import quant_matmul as tq

LANES = ["int8", "fp8-e4m3"]
SHAPES = [(5, 32, 48), (16, 768, 256), (4, 3072, 64)]   # M, K, N


@pytest.fixture(scope="module")
def jq():
    """The JAX package's quant_matmul module."""
    pytest.importorskip("jax")
    from paddle_tpu.kernels import quant_matmul
    return quant_matmul


def _case(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0] *= 8.0                              # rows of different ranges
    w = (0.02 * rng.standard_normal((K, N))).astype(np.float32)
    w[:, 0] *= 10.0                          # channels of different ranges
    return x, w


def _bytes(t):
    return t.view(torch.uint8).numpy()


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_weight_matches_jax(jq, lane, shape):
    import jax.numpy as jnp
    _x, w = _case(0, *shape)
    jw, js = jq.quantize_weight(jnp.asarray(w), lane)
    tw, ts = tq.quantize_weight(torch.from_numpy(w), lane)
    assert tw.dtype == tq.QUANT_DTYPES[lane]
    assert np.array_equal(_bytes(tw), np.asarray(jw).view(np.uint8))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7,
                               atol=0)


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernel_and_reference(jq, lane, shape):
    import jax.numpy as jnp
    x, w = _case(1, *shape)
    jw, js = jq.quantize_weight(jnp.asarray(w), lane)
    tw, ts = tq.quantize_weight(torch.from_numpy(w), lane)
    got = tq.quant_matmul(torch.from_numpy(x), tw, ts).numpy()
    jk = np.asarray(jq.quant_matmul(jnp.asarray(x), jw, js,
                                    interpret=True))
    jr = np.asarray(jq.quant_matmul_reference(jnp.asarray(x), jw, js))
    atol = (1e-6 if lane == "int8" else 1e-5) * float(np.abs(jr).max())
    np.testing.assert_allclose(got, jk, rtol=0, atol=atol)
    np.testing.assert_allclose(got, jr, rtol=0, atol=atol)
    # both within the a-priori bound of the exact fp32 product
    exact = x.astype(np.float64) @ w.astype(np.float64)
    bound = tq.quant_matmul_error_bound(torch.from_numpy(x),
                                        torch.from_numpy(w), lane).numpy()
    np.testing.assert_allclose(
        bound, np.asarray(jq.quant_matmul_error_bound(x, w, lane)),
        rtol=1e-6)
    assert (np.abs(got - exact) <= bound).all()
    assert (np.abs(jr - exact) <= bound).all()


def test_leading_dims_flatten_into_rows():
    x, w = _case(2, 6, 32, 8)
    tw, ts = tq.quantize_weight(torch.from_numpy(w))
    flat = tq.quant_matmul(torch.from_numpy(x), tw, ts)
    lead = tq.quant_matmul(torch.from_numpy(x).reshape(2, 3, 32), tw, ts)
    assert lead.shape == (2, 3, 8)
    assert torch.equal(lead.reshape(6, 8), flat)


def test_int8_accumulation_is_exact_past_2_pow_24(jq):
    import jax.numpy as jnp
    K = 3072
    rng = np.random.default_rng(3)
    x = np.full((2, K), 3.0, np.float32)         # row 0: all at its max
    x[1] = rng.choice([-2.0, 2.0], K)            # row 1: +-max
    w = np.full((K, 2), 0.5, np.float32)
    w[:, 1] = rng.choice([-0.25, 0.25], K)
    tw, ts = tq.quantize_weight(torch.from_numpy(w))
    assert (tw.abs() == 127).all()
    got = tq.quant_matmul(torch.from_numpy(x), tw, ts).numpy()
    xq = np.where(x > 0, 127, -127).astype(np.int64)
    acc = (xq @ tw.numpy().astype(np.int64)).astype(np.float32)
    sx = (np.abs(x).max(1, keepdims=True) / np.float32(127.0))
    want = acc * sx.astype(np.float32) * ts.numpy()[None, :]
    assert acc[0, 0] == 127 * 127 * K
    np.testing.assert_array_equal(got, want)
    jw, js = jq.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(
        np.asarray(jq.quant_matmul_reference(jnp.asarray(x), jw, js)),
        want)


@pytest.mark.parametrize("bad", ["rank", "scale_len", "contraction",
                                 "float_weight"])
def test_argument_validation(bad):
    x, w = _case(4, 3, 16, 8)
    x = torch.from_numpy(x)
    wq, ws = tq.quantize_weight(torch.from_numpy(w))
    err = ValueError
    if bad == "rank":
        wq = wq[None]
    elif bad == "scale_len":
        ws = ws[:-1]
    elif bad == "contraction":
        x = x[:, :-1]
    else:
        wq, err = wq.float(), TypeError
    with pytest.raises(err):
        tq.quant_matmul(x, wq, ws)
    with pytest.raises(ValueError):
        tq.quantize_weight(torch.from_numpy(w), "int4")


def test_unknown_device_raises_and_cpu_launches_nothing():
    x, w = _case(5, 3, 16, 8)
    wq, ws = tq.quantize_weight(torch.from_numpy(w))
    with pytest.raises(ValueError, match="meta"):
        tq.quant_matmul(torch.from_numpy(x).to("meta"), wq.to("meta"),
                        ws.to("meta"))
    tk.reset_launches()
    tq.quant_matmul(torch.from_numpy(x), wq, ws)
    assert tk.LAUNCHES["quant_matmul"] == 0


# (M, K, N): the decoder's four projections at M = 80, and the card tests'
# ragged shapes (M 1 / 17 / 80 / 130, K = 3072, N no multiple of 64)
PLAN_SHAPES = [(80, 768, 2304), (80, 768, 768), (80, 768, 3072),
               (80, 3072, 768), (1, 3072, 20), (17, 3072, 20),
               (80, 3072, 20), (130, 3072, 20), (130, 3072, 776),
               (80, 36, 20), (300, 8192, 1000)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_qmm_plan_splits_every_k_step_once(shape):
    """Every 32-deep k step of K (rounded up to 32) in exactly one split,
    in order, none empty, each at most QMM_CHUNK_MAX deep; at most 8
    splits (one cluster that sums in shared memory) where M <= 128 and K
    allows, else the device-memory partials; the scratch regions in
    order, 16-byte aligned and large enough; the same plan every call."""
    M, K, N = shape
    plan = tq.qmm_plan(M, K, N, n_sm=132)
    assert plan == tq.qmm_plan(M, K, N, n_sm=132)
    assert plan.k_pad == -(-K // 32) * 32 and plan.k_pad >= K
    assert plan.chunk % 32 == 0 and 32 <= plan.chunk <= tq.QMM_CHUNK_MAX
    ranges = [(z * plan.chunk, min(plan.k_pad, (z + 1) * plan.chunk))
              for z in range(plan.splits)]
    assert all(lo < hi for lo, hi in ranges)
    assert ranges[-1][1] == plan.k_pad
    assert plan.col_tiles == -(-N // tq.QMM_BN)
    fits = M <= tq.QMM_BM and -(-plan.k_pad // tq.QMM_CHUNK_MAX) <= 8
    if fits:
        assert plan.splits <= tq.QMM_MAX_CLUSTER
    assert plan.cluster == (plan.splits if 1 < plan.splits and fits else 1)
    xq, sx, counters, part, end = plan.scratch
    assert xq >= 4 * M * N                      # the output comes first
    assert all(off % 16 == 0 for off in (xq, sx, counters, part))
    assert xq + M * plan.k_pad <= sx and sx + 4 * M <= counters
    glob = plan.splits > 1 and plan.cluster == 1
    assert part - counters >= (4 * plan.col_tiles if glob else 0)
    assert end - part == (4 * plan.splits * M * N if glob else 0)


@pytest.mark.parametrize("shape,blocks", [((80, 768, 2304), 144),
                                          ((80, 768, 768), 96),
                                          ((80, 768, 3072), 144),
                                          ((80, 3072, 768), 96)])
def test_qmm_plan_fills_the_card_at_the_decoder_shapes(shape, blocks):
    """At M = 80 each projection's grid is about one block an SM of 132
    (a cluster caps the splits at 8: wo and w2 give 96)."""
    plan = tq.qmm_plan(*shape, n_sm=132)
    assert plan.col_tiles * plan.splits == blocks
    assert plan.cluster == plan.splits > 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("K,N", [(768, 2304), (768, 768), (768, 3072),
                                 (3072, 768), (36, 20)])
def test_kernel_matches_plain_on_card(cuda_device, lane, K, N):
    x, w = _case(6, 80, K, N)
    x = torch.from_numpy(x).to(cuda_device)
    wq, ws = tq.quantize_weight(torch.from_numpy(w).to(cuda_device), lane)
    tk.reset_launches()
    got = tq.quant_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["quant_matmul"] == 1
    want = tq.quant_matmul_reference(x, wq, ws)
    tol = (1e-6 if lane == "int8" else 1e-5) * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    with pytest.raises(TypeError):
        tq.quant_matmul(x.double(), wq, ws)
    with pytest.raises(ValueError):
        tq.quant_matmul(x, wq.cpu(), ws)


@pytest.mark.cuda
@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("M", [1, 17, 80, 130])
@pytest.mark.parametrize("N", [20, 776])
def test_kernel_ragged_shapes_on_card(cuda_device, lane, M, N):
    """The tensor-core kernel at K = 3072 (split over K) with M on both
    sides of the 128-row tile and N no multiple of the 64-column tile:
    within QMM's tolerance of the plain version, inside the a-priori
    bound, and two launches bit-equal (the splits are summed in order)."""
    x, w = _case(7, M, 3072, N)
    x = torch.from_numpy(x).to(cuda_device)
    w = torch.from_numpy(w).to(cuda_device)
    wq, ws = tq.quantize_weight(w, lane)
    assert tq.qmm_plan(M, 3072, N).splits > 1
    got = tq.quant_matmul(x, wq, ws)
    again = tq.quant_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = tq.quant_matmul_reference(x, wq, ws)
    tol = (1e-6 if lane == "int8" else 1e-5) * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    exact = x.double() @ w.double()
    bound = tq.quant_matmul_error_bound(x, w, lane).double()
    assert bool(((got.double() - exact).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(768, 768), (3072, 768)])
def test_fp8_split_launches_bit_equal_on_card(cuda_device, K, N):
    """fp8 at the decoder's split projections (8 splits in a cluster):
    the fp32 partials are summed in split order, so repeated launches on
    the same inputs give the same bits."""
    x, w = _case(8, 80, K, N)
    x = torch.from_numpy(x).to(cuda_device)
    wq, ws = tq.quantize_weight(torch.from_numpy(w).to(cuda_device),
                                "fp8-e4m3")
    assert tq.qmm_plan(80, K, N).cluster == 8
    outs = [tq.quant_matmul(x, wq, ws) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
