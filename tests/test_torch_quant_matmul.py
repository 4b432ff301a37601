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

The kernel-vs-plain case needs a card and skips without one."""
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
