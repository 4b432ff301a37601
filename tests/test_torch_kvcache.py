"""The port's KV-cache bookkeeping and metrics, held against the JAX
package's: identical chained block hashes, identical BlockPool state
through one scripted alloc/share/register/acquire/release sequence,
identical KVCacheConfig byte counts, quantized pools of the same
structure with the same calibration scales, and the same metric
semantics. CPU only; no card is needed."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu.serving import kvcache as jkv
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.serving import kvcache as tkv


@pytest.mark.parametrize("n_tokens,block_size", [(0, 4), (3, 4), (16, 4),
                                                 (37, 8), (129, 16)])
def test_chain_block_hashes_identical(n_tokens, block_size):
    toks = np.random.RandomState(n_tokens).randint(1, 32000, n_tokens)
    want = jkv.chain_block_hashes(toks, block_size)
    got = tkv.chain_block_hashes(toks, block_size)
    assert got == want
    assert len(got) == n_tokens // block_size


def _script(mod):
    """One scripted pool history; returns stats() after every step."""
    cfg = mod.KVCacheConfig(num_layers=2, num_heads=2, head_dim=4,
                            block_size=4, num_blocks=10)
    pool = mod.BlockPool(cfg)
    h = mod.chain_block_hashes(np.arange(1, 13), 4)
    out = []

    def snap():
        pool.assert_consistent()
        out.append(pool.stats())

    a = pool.alloc(3, "a")
    snap()
    for i, blk in enumerate(a):
        pool.register(blk, h[i])
    snap()
    pool.share(a[:2], "b")
    pool.alloc(2, "b")
    snap()
    assert pool.acquire_cached(h[0], "c") == a[0]
    assert pool.acquire_cached("missing", "c") is None
    snap()
    pool.release_tail("b", 1)
    snap()
    pool.free("a")
    pool.free("c")
    snap()                               # a[2] now cached (refcount 0)
    pool.alloc(8, "d")                   # forces an LRU eviction
    snap()
    with pytest.raises(mod.OutOfBlocksError):
        pool.alloc(2, "e")
    pool.release_blocks("d", pool.owner_blocks("d")[:2])
    pool.free("b")
    pool.free("d")
    snap()
    assert pool.check_leaks() == []
    return out


def test_block_pool_script_matches_jax():
    want = _script(jkv)
    got = _script(tkv)
    assert got == want
    assert want[-1]["blocks_in_use"] == 0
    assert any(s["prefix_evictions"] for s in want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8",
                                   "fp8-e4m3"])
def test_kv_config_bytes_match_jax(dtype):
    kw = dict(num_layers=12, num_heads=12, head_dim=64, block_size=16,
              num_blocks=2048, dtype=dtype)
    j, t = jkv.KVCacheConfig(**kw), tkv.KVCacheConfig(**kw)
    assert t.describe() == j.describe()
    assert (t.blocks_for(1), t.blocks_for(17), t.max_tokens) == \
        (j.blocks_for(1), j.blocks_for(17), j.max_tokens)


def test_make_pools_cpu_layout():
    cfg = tkv.KVCacheConfig(num_layers=2, num_heads=3, head_dim=8,
                            block_size=4, num_blocks=5)
    k, v = tkv.make_pools(cfg, "cpu")
    assert k.shape == v.shape == (2, 5, 3, 4, 8)
    assert k.dtype == torch.float32 and k.device.type == "cpu"
    assert k[1].is_contiguous() and not k.any()
    assert k.numel() * 4 * 2 == cfg.hbm_bytes


@pytest.mark.parametrize("dtype", ["float16"])
def test_make_pools_unported_dtypes_raise(dtype):
    """A dtype the paged-attention kernel has no lane for is sized but
    not built."""
    cfg = tkv.KVCacheConfig(num_layers=1, num_heads=1, head_dim=4,
                            num_blocks=2, dtype=dtype)
    assert cfg.hbm_bytes == 2 * 2 * 16 * 4 * 2     # K+V, 2 blocks, 2 B
    with pytest.raises(NotImplementedError, match="lanes"):
        tkv.make_pools(cfg, "cpu")
    with pytest.raises(ValueError, match="unknown KV dtype"):
        tkv.KVCacheConfig(num_layers=1, num_heads=1, head_dim=4,
                          dtype="int4")


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "fp8-e4m3"])
def test_make_pools_match_jax(dtype):
    kw = dict(num_layers=2, num_heads=3, head_dim=8, block_size=4,
              num_blocks=5, dtype=dtype)
    rng = np.random.default_rng(0)
    ka = rng.uniform(0.0, 3.0, (2, 3)).astype(np.float32)
    ka[0, 0] = 0.0                                  # clamps to 1e-8
    va = np.float32(2.5)                            # broadcasts
    j = jkv.make_pools(jkv.KVCacheConfig(**kw), ka, va)
    t = tkv.make_pools(tkv.KVCacheConfig(**kw), "cpu", ka, va)
    cfg = tkv.KVCacheConfig(**kw)
    assert tkv.kv_storage_dtype(cfg) == (t[0][0] if cfg.quantized
                                         else t[0]).dtype
    if not cfg.quantized:
        assert t[0].dtype == torch.bfloat16 and not t[0].any()
        assert tuple(t[0].shape) == tuple(j[0].shape)
        return
    for jp, tp in zip(j, t):
        payload, scales, cal = tp
        assert [tuple(x.shape) for x in tp] == [x.shape for x in jp]
        assert str(jp[0].dtype) == {"int8": "int8",
                                    "fp8-e4m3": "float8_e4m3fn"}[dtype]
        assert payload.element_size() == 1 and payload[1].is_contiguous()
        assert not payload.view(torch.uint8).any() and not scales.any()
        assert scales.dtype == cal.dtype == torch.float32
        np.testing.assert_array_equal(cal.numpy(), np.asarray(jp[2]))
    nbytes = sum(x.numel() * x.element_size() for p in t for x in p[:2])
    assert nbytes == cfg.hbm_bytes


@pytest.mark.parametrize("dtype", ["int8", "fp8-e4m3"])
def test_kv_quant_cal_matches_jax(dtype):
    kw = dict(num_layers=3, num_heads=2, head_dim=4, dtype=dtype)
    absmax = np.random.default_rng(1).uniform(0.1, 9.0, (3, 2))
    for a in (None, absmax, 0.0, [[1.0], [2.0], [3.0]]):
        want = np.asarray(jkv.kv_quant_cal(jkv.KVCacheConfig(**kw), a))
        got = tkv.kv_quant_cal(tkv.KVCacheConfig(**kw), a, "cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_bfloat16_config_without_jax_loaded():
    """``KVCacheConfig(dtype="bfloat16")`` in a process that imports
    only the port (numpy knows "bfloat16" only after ml_dtypes, which
    JAX imports and the port does not)."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "from paddle_tpu_torch.serving import KVCacheConfig, make_pools\n"
        "c = KVCacheConfig(num_layers=2, num_heads=2, head_dim=4,"
        " block_size=16, num_blocks=256, dtype='bfloat16')\n"
        "k, v = make_pools(c, 'cpu')\n"
        "assert 'jax' not in sys.modules, 'jax'\n"
        "assert 'ml_dtypes' not in sys.modules, 'ml_dtypes'\n"
        "print(c.hbm_bytes, c.dtype_bytes, k.dtype)\n")
    env = dict(os.environ, PYTHONPATH=str(repo))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["262144", "2", "torch.bfloat16"]
    assert jkv.KVCacheConfig(num_layers=2, num_heads=2, head_dim=4,
                             block_size=16, num_blocks=256,
                             dtype="bfloat16").hbm_bytes == 262144


def test_make_pools_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tkv.KVCacheConfig(num_layers=1, num_heads=1, head_dim=4,
                            num_blocks=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkv.make_pools(cfg)


def test_metrics_copy_matches_jax():
    vals = np.random.RandomState(3).exponential(20.0, 500)
    regs = [jmetrics.MetricsRegistry("x"), tmetrics.MetricsRegistry("x")]
    for reg, mod in zip(regs, (jmetrics, tmetrics)):
        h = reg.histogram("decode_ttft_ms", "ttft",
                          buckets=mod.LATENCY_BUCKETS_MS)
        for x in vals:
            h.observe(x)
        reg.counter("decode_tokens_total").inc(7)
        reg.gauge("decode_queue_depth").set(3)
    assert tmetrics.LATENCY_BUCKETS_MS == jmetrics.LATENCY_BUCKETS_MS
    j, t = (r.snapshot() for r in regs)
    assert t == j
    assert regs[1].prometheus_text() == regs[0].prometheus_text()
    with pytest.raises(ValueError):
        regs[1].counter("decode_tokens_total").inc(-1)
