"""The port's decoder (``mixed_step``) held against the JAX package's.

A scripted run of mixed steps — prefill chunks starting mid-block,
decode rows, invalid rows and a ``write_limit`` cut — goes through the
JAX ``mixed_step`` (dense reference and the Pallas kernel in interpret
mode) and through the port's, from the same params (``params_from_jax``)
and the same numpy inputs. Logits and both pools must agree within
atol 1e-5 in float32 after every step.

The quantized configurations run the same script from the same
calibration: int8 KV + int8 weights, fp8-e4m3 KV + fp8 weights, and
bfloat16 KV with fp32 weights. There the logits must agree within atol
1e-5 and the 1-byte payloads and the per-block scales must be equal
(the int8 matmul is exact on both sides, so its outputs differ only by
fp32 epilogue rounding, which moves no quantized K/V value here)."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import decode_model as jdm
from paddle_tpu.serving import kvcache as jkv
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.serving import decode_model as tdm
from paddle_tpu_torch.serving.kvcache import make_pools

JCFG = jdm.DecoderConfig(vocab_size=64, d_model=32, n_heads=2,
                         head_dim=16, n_layers=2, d_ff=64, max_seq_len=64)
TCFG = tdm.DecoderConfig(**JCFG.__dict__)
BS, NB, S, P, T = 4, 16, 3, 8, 10


@pytest.fixture(scope="module")
def params():
    jp = jdm.init_params(JCFG, seed=3)
    return jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                               "cpu")


def _script():
    """(tokens, row_slots, positions, valid) per step. Slot 0 prefills
    in chunks of 3 (the second starts mid-block), slot 1 decodes, slot
    2 starts late; invalid rows point anywhere; step 3 crosses the
    write limit of 11."""
    rng = np.random.default_rng(0)
    steps = []
    plans = [
        [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (1, 3)],
        [(0, 3), (0, 4), (0, 5), (1, 4), (2, 0), (2, 1)],
        [(0, 6), (1, 5), (2, 2), (2, 3), (2, 4), (2, 5), (2, 6)],
        [(0, 7), (1, 6), (2, 7), (2, 8), (2, 9), (2, 10), (2, 11),
         (2, 12)],
    ]
    for plan in plans:
        toks = rng.integers(1, JCFG.vocab_size, T).astype(np.int32)
        slots = np.zeros(T, np.int32)
        pos = np.zeros(T, np.int32)
        valid = np.zeros(T, bool)
        for i, (s, p) in enumerate(plan):
            slots[i], pos[i], valid[i] = s, p, True
        slots[len(plan):] = rng.integers(0, S, T - len(plan))
        pos[len(plan):] = rng.integers(0, 12, T - len(plan))
        steps.append((toks, slots, pos, valid))
    return steps


def _tables():
    tables = np.zeros((S, P), np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :2] = [1, 14]
    tables[2, :4] = [7, 3, 11, 6]
    tables[1, 2:] = 8          # stale entries past slot 1's pages
    return tables


@pytest.mark.parametrize("jax_impl", ["reference", "kernel_interpret"])
def test_mixed_step_matches_jax(params, jax_impl):
    jp, tp = params
    tables = _tables()
    shape = (JCFG.n_layers, NB, JCFG.n_heads, BS, JCFG.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = make_pools(TCFG.kv_config(BS, NB), "cpu")
    for toks, slots, pos, valid in _script():
        jl, jk, jv = jdm.mixed_step(JCFG, jp, jk, jv, toks, slots, pos,
                                    valid, tables, attn_impl=jax_impl,
                                    write_limit=11)
        tl, tk2, tv2 = tdm.mixed_step(TCFG, tp, tk, tv, toks, slots, pos,
                                      valid, tables, write_limit=11)
        assert tk2 is tk and tv2 is tv            # updated in place
        mask = valid & (pos < 11)
        np.testing.assert_allclose(tl.numpy()[mask],
                                   np.asarray(jl)[mask],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                   atol=1e-5, rtol=1e-5)
    # positions >= write_limit wrote nothing: block 6 (slot 2, page 3)
    # holds only position 12's slot, which was cut
    assert not tk[:, 6].any() and not np.asarray(jk)[:, 6].any()


def test_all_invalid_step_leaves_pools_untouched(params):
    _jp, tp = params
    tk, tv = make_pools(TCFG.kv_config(BS, NB), "cpu")
    g = torch.Generator().manual_seed(0)
    tk.copy_(torch.randn(tk.shape, generator=g))
    tv.copy_(torch.randn(tv.shape, generator=g))
    k0, v0 = tk.clone(), tv.clone()
    z = np.zeros(T, np.int32)
    tdm.mixed_step(TCFG, tp, tk, tv, z + 5, z, z + 2, np.zeros(T, bool),
                   _tables())
    assert torch.equal(tk, k0) and torch.equal(tv, v0)
    # one valid row among invalid ones pointing at the same place: the
    # valid write lands, everything else stays bit-exact
    valid = np.zeros(T, bool)
    valid[4] = True
    tdm.mixed_step(TCFG, tp, tk, tv, z + 5, z, z + 2, valid, _tables())
    changed = (tk != k0).nonzero()
    assert set(changed[:, 1].tolist()) == {5}       # tables[0, 0]
    assert set(changed[:, 3].tolist()) == {2}       # offset 2


def test_reference_impl_equals_default_on_cpu(params):
    _jp, tp = params
    outs = []
    for impl in (None, "reference"):
        tk, tv = make_pools(TCFG.kv_config(BS, NB), "cpu")
        for toks, slots, pos, valid in _script():
            logits, _, _ = tdm.mixed_step(TCFG, tp, tk, tv, toks, slots,
                                          pos, valid, _tables(),
                                          attn_impl=impl)
        outs.append((logits, tk))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    with pytest.raises(ValueError):
        tdm.mixed_step(TCFG, tp, tk, tv, *_script()[0], _tables(),
                       attn_impl="kernel")


def test_init_params_layout_matches_jax():
    jp = jdm.init_params(JCFG, seed=0)
    tp = tdm.init_params(TCFG, seed=0, device="cpu")
    assert sorted(tp) == sorted(jp)
    for name in jp:
        assert tuple(tp[name].shape) == tuple(jp[name].shape), name
        assert tp[name].dtype == torch.float32
    assert tdm.param_bytes(TCFG) == jdm.param_bytes(JCFG)
    again = tdm.init_params(TCFG, seed=0, device="cpu")
    assert all(torch.equal(tp[k], again[k]) for k in tp)
    std = float(tp["l0_w1"].std())
    assert 0.015 < std < 0.025


def test_params_from_jax_copies_exactly(params):
    jp, tp = params
    for name, arr in jp.items():
        assert np.array_equal(tp[name].numpy(), np.asarray(arr)), name
    with pytest.raises(TypeError):
        params_from_jax({"tokens": np.arange(3)}, "cpu")


def test_init_params_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdm.init_params(TCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"embed": np.zeros((2, 2), np.float32)})


QUANT_CASES = [("int8", "int8"), ("fp8-e4m3", "fp8-e4m3"),
               ("bfloat16", None)]


def _np(x):
    return {k: np.asarray(v) for k, v in x.items()}


def _payload_bytes(pool):
    """A pool's payload as comparable numpy bytes (JAX or torch)."""
    payload = pool[0] if isinstance(pool, tuple) else pool
    if isinstance(payload, torch.Tensor):
        return payload.view(torch.uint8 if payload.element_size() == 1
                            else torch.int16).numpy()
    a = np.asarray(payload)
    return a.view(np.uint8 if a.itemsize == 1 else np.int16)


@pytest.mark.parametrize("plan", ["int8", "fp8-e4m3", "object"])
def test_quantize_decoder_params_matches_jax(params, plan):
    jp, _tp = params
    np_p = _np(jp)
    # spiky channels: the ratio rule sends them to fp8
    np_p["l0_w1"] = np_p["l0_w1"].copy()
    np_p["l0_w1"][0, 0] = 2.0
    if plan == "object":          # duck-typed QuantPlan: .decisions
        plan = types.SimpleNamespace(decisions=[
            types.SimpleNamespace(name="l1_wqkv", dtype="fp8-e4m3"),
            types.SimpleNamespace(name="w2", dtype="bfloat16")])
    jq = jdm.quantize_decoder_params(
        JCFG, {k: jnp.asarray(v) for k, v in np_p.items()}, plan)
    tq = tdm.quantize_decoder_params(TCFG, params_from_jax(np_p, "cpu"),
                                     plan)
    assert sorted(tq) == sorted(jq)
    for name, arr in jq.items():
        arr = np.asarray(arr)
        if name.endswith("__q"):
            assert tq[name].element_size() == 1
            assert np.array_equal(tq[name].view(torch.uint8).numpy(),
                                  arr.view(np.uint8)), name
        else:
            np.testing.assert_allclose(tq[name].numpy(), arr, rtol=1e-7,
                                       atol=0, err_msg=name)
    if not isinstance(plan, str):
        assert "l0_w2" in tq and "l0_wqkv__q" in tq      # kept / planned
        assert tq["l1_wqkv__q"].dtype == torch.float8_e4m3fn
        assert tq["l0_w1__q"].dtype == torch.float8_e4m3fn   # ratio rule
        assert tq["l1_w1__q"].dtype == torch.int8
    # params_from_jax carries the quantized dict byte for byte
    carried = params_from_jax(_np(jq), "cpu")
    for name in jq:
        assert carried[name].dtype == tq[name].dtype, name
        assert carried[name].view(torch.uint8).numpy().tobytes() == \
            tq[name].view(torch.uint8).numpy().tobytes(), name


@pytest.mark.parametrize("jax_impl", ["reference", "kernel_interpret"])
@pytest.mark.parametrize("kv_dtype,w_dtype", QUANT_CASES)
def test_quantized_mixed_step_matches_jax(params, kv_dtype, w_dtype,
                                          jax_impl):
    jp, tp = params
    if w_dtype is not None:
        jp = jdm.quantize_decoder_params(JCFG, jp, w_dtype)
        tp = tdm.quantize_decoder_params(TCFG, tp, w_dtype)
    kw = dict(num_layers=JCFG.n_layers, num_heads=JCFG.n_heads,
              head_dim=JCFG.head_dim, block_size=BS, num_blocks=NB,
              dtype=kv_dtype)
    rng = np.random.default_rng(7)
    ka = rng.uniform(0.5, 2.0, (JCFG.n_layers, JCFG.n_heads))
    va = rng.uniform(0.5, 2.0, (JCFG.n_layers, JCFG.n_heads))
    jk, jv = jkv.make_pools(jkv.KVCacheConfig(**kw), ka, va)
    tk, tv = make_pools(TCFG.kv_config(BS, NB, kv_dtype), "cpu", ka, va)
    tables = _tables()
    for toks, slots, pos, valid in _script():
        jl, jk, jv = jdm.mixed_step(JCFG, jp, jk, jv, toks, slots, pos,
                                    valid, tables, attn_impl=jax_impl,
                                    write_limit=11)
        tl, tk2, tv2 = tdm.mixed_step(TCFG, tp, tk, tv, toks, slots, pos,
                                      valid, tables, write_limit=11)
        assert tk2 is tk and tv2 is tv
        mask = valid & (pos < 11)
        assert np.isfinite(tl.numpy()[mask]).all()
        np.testing.assert_allclose(tl.numpy()[mask],
                                   np.asarray(jl)[mask],
                                   atol=1e-5, rtol=1e-5)
        for jpool, tpool in ((jk, tk), (jv, tv)):
            assert np.array_equal(_payload_bytes(tpool),
                                  _payload_bytes(jpool))
            if isinstance(tpool, tuple):
                assert np.array_equal(tpool[1].numpy(),
                                      np.asarray(jpool[1]))
    if isinstance(tk, tuple):       # every written block has its scale
        written = tk[0].view(torch.uint8).reshape(
            JCFG.n_layers, NB, -1).any(-1)
        assert torch.equal(written, (tk[1] != 0).all(-1) & written)
        assert not tk[1][:, 6].any()          # the cut write left none


@pytest.mark.parametrize("w_dtype", [None, "int8", "fp8-e4m3"])
def test_dense_prefill_matches_jax(params, w_dtype):
    jp, tp = params
    if w_dtype is not None:
        jp = jdm.quantize_decoder_params(JCFG, jp, w_dtype)
        tp = tdm.quantize_decoder_params(TCFG, tp, w_dtype)
    toks = np.random.default_rng(5).integers(0, JCFG.vocab_size, 23)
    jk, jv = jdm.dense_prefill(JCFG, jp, jnp.asarray(toks, jnp.int32),
                               np.int32(20))
    tk, tv = tdm.dense_prefill(TCFG, tp, toks, 20)
    assert tuple(tk.shape) == jk.shape
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.numpy()[:, :, :20],
                                   np.asarray(j)[:, :, :20], atol=1e-5,
                                   rtol=1e-5)


def test_fp8_kv_overflow_writes_nan_like_jax():
    """The fp8 K/V write does not clip: JAX's e4m3 cast gives 448 up to
    464 and NaN past it, where torch's saturates. The port writes what
    the reference writes (ROADMAP C2)."""
    vals = np.array([0.0, 1.0, 440.0, 448.0, 456.0, 464.0, 464.5, 480.0,
                     1e4, -464.0, -465.0, -1e4], np.float32)
    rows = vals.reshape(1, 1, -1)
    shape = (1, 2, 1, 1, vals.size)
    jpool = (jnp.zeros(shape, jnp.float8_e4m3fn),
             jnp.zeros(shape[:3], jnp.float32),
             jnp.ones((1, 1), jnp.float32))
    jpool = jdm._scatter_kv(jpool, 0, jnp.array([1]), jnp.array([0]),
                            jnp.asarray(rows))
    tpool = (torch.zeros(shape, dtype=torch.float8_e4m3fn),
             torch.zeros(shape[:3]), torch.ones((1, 1)))
    plan = tdm._write_plan(torch.tensor([1]), torch.tensor([0]),
                           torch.tensor([True]))
    tdm._scatter_kv(tpool, 0, plan, torch.from_numpy(rows))
    want = np.asarray(jpool[0]).astype(np.float32)[0, 1, 0, 0]
    got = tpool[0].float().numpy()[0, 1, 0, 0]
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).tolist() == [False] * 6 + [True] * 3 + \
        [False, True, True]
    fin = ~np.isnan(want)
    np.testing.assert_array_equal(got[fin], want[fin])
    assert got[5] == 448.0 and got[9] == -448.0
    np.testing.assert_array_equal(tpool[1].numpy(), np.asarray(jpool[1]))


# ---- the whole-prompt path: decode_step, decode_chunk, prefill

def _whole_script():
    """Whole-mode calls over slots 0..2 with ``_tables()``: two padded
    prefills (slot 0 from 0; slot 2 after a one-block prefix hit), a
    decode step with slot 1 inactive, and a decode chunk whose rows cross
    ``write_limit`` 12 and whose slot 1 is inactive."""
    rng = np.random.default_rng(3)
    toks = rng.integers(1, JCFG.vocab_size, 64).astype(np.int32)
    return [
        ("prefill", dict(tokens=toks[:8], true_len=6, start_len=0,
                         slot=0)),
        ("prefill", dict(tokens=toks[8:16], true_len=5, start_len=4,
                         slot=2)),
        ("decode", dict(tokens=toks[16:19], seq_lens=np.array(
            [6, 0, 9], np.int32), active=np.array([True, False, True]))),
        ("chunk", dict(tokens=toks[19:28].reshape(3, 3),
                       start_lens=np.array([7, 0, 10], np.int32),
                       q_lens=np.array([3, 3, 2], np.int32),
                       active=np.array([True, False, True]))),
    ]


def _whole_call(mod, cfg, p, k, v, kind, a, tables, impl):
    """One script call on either side; returns ``(logits of the valid
    rows [n, vocab], k, v)``."""
    if kind == "prefill":
        lg, k, v = mod.prefill(cfg, p, k, v, a["tokens"], a["true_len"],
                               a["start_len"], tables[a["slot"]],
                               attn_impl=impl, write_limit=12)
        return np.asarray(lg)[None], k, v
    if kind == "decode":
        lg, k, v = mod.decode_step(cfg, p, k, v, a["tokens"], tables,
                                   a["seq_lens"], a["active"],
                                   attn_impl=impl)
        return np.asarray(lg)[a["active"]], k, v
    lg, k, v = mod.decode_chunk(cfg, p, k, v, a["tokens"], tables,
                                a["start_lens"], a["q_lens"], a["active"],
                                attn_impl=impl, write_limit=12)
    G = a["tokens"].shape[1]
    pos = a["start_lens"][:, None] + np.arange(G)[None]
    valid = (a["active"][:, None] & (np.arange(G)[None] < a["q_lens"][:,
                                                                    None])
             & (pos < 12))
    return np.asarray(lg)[valid], k, v


@pytest.mark.parametrize("jax_impl", ["reference", "kernel_interpret"])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_whole_path_matches_jax(params, quant, jax_impl):
    """decode_step, decode_chunk and prefill against JAX: logits within
    1e-5 after every call and the pools equal (float: within 1e-5;
    int8: payload bytes and scales equal). Padding rows, rows past the
    write limit and inactive slots write nothing."""
    jp, tp = params
    kv_dtype = "float32"
    if quant is not None:
        kv_dtype = quant
        jp = jdm.quantize_decoder_params(JCFG, jp, quant)
        tp = tdm.quantize_decoder_params(TCFG, tp, quant)
    kw = dict(num_layers=JCFG.n_layers, num_heads=JCFG.n_heads,
              head_dim=JCFG.head_dim, block_size=BS, num_blocks=NB,
              dtype=kv_dtype)
    rng = np.random.default_rng(7)
    ka = rng.uniform(0.5, 2.0, (JCFG.n_layers, JCFG.n_heads))
    va = rng.uniform(0.5, 2.0, (JCFG.n_layers, JCFG.n_heads))
    jk, jv = jkv.make_pools(jkv.KVCacheConfig(**kw), ka, va)
    tk, tv = make_pools(TCFG.kv_config(BS, NB, kv_dtype), "cpu", ka, va)
    tables = _tables()
    for kind, a in _whole_script():
        jl, jk, jv = _whole_call(jdm, JCFG, jp, jk, jv, kind, a, tables,
                                 jax_impl)
        tl, tk2, tv2 = _whole_call(tdm, TCFG, tp, tk, tv, kind, a, tables,
                                   None)
        assert tk2 is tk and tv2 is tv            # updated in place
        assert np.isfinite(tl).all() and tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5,
                                   err_msg=kind)
        for jpool, tpool in ((jk, tk), (jv, tv)):
            if quant is None:
                np.testing.assert_allclose(tpool.numpy(),
                                           np.asarray(jpool), atol=1e-5,
                                           rtol=1e-5, err_msg=kind)
            else:
                assert np.array_equal(_payload_bytes(tpool),
                                      _payload_bytes(jpool)), kind
                assert np.array_equal(tpool[1].numpy(),
                                      np.asarray(jpool[1])), kind
        if kind == "prefill" and a["slot"] == 0:
            # rung padding rows 6 and 7 (block 2, offsets 2-3) wrote
            # nothing
            pay = _payload_bytes(tk)
            assert not pay[:, 2, :, 2:].any()
    pay = _payload_bytes(tk)
    # inactive slot 1 (blocks 1, 14) and the cut chunk row at position 12
    # (slot 2, page 3 = block 6) wrote nothing, on both sides
    for blk in (1, 14, 6):
        assert not pay[:, blk].any()
        assert not _payload_bytes(jk)[:, blk].any()


def test_prefill_after_prefix_hit_equals_prefill_from_zero(params):
    """A prompt prefilled whole from position 0 and the same prompt
    prefilled as its first two blocks, then the tail at start 8 over the
    same blocks, give the same last-row logits and the same K/V."""
    _jp, tp = params
    toks = np.random.default_rng(9).integers(1, 64, 13).astype(np.int32)
    row = np.array([3, 8, 12, 5, 0, 0, 0, 0], np.int32)
    k0, v0 = make_pools(TCFG.kv_config(BS, NB), "cpu")
    padded = np.zeros(16, np.int32)
    padded[:13] = toks
    whole, _, _ = tdm.prefill(TCFG, tp, k0, v0, padded, 13, 0, row)
    k1, v1 = make_pools(TCFG.kv_config(BS, NB), "cpu")
    head = np.zeros(8, np.int32)
    head[:8] = toks[:8]
    tdm.prefill(TCFG, tp, k1, v1, head, 8, 0, row)
    tail = np.zeros(8, np.int32)
    tail[:5] = toks[8:]
    hit, _, _ = tdm.prefill(TCFG, tp, k1, v1, tail, 5, 8, row)
    torch.testing.assert_close(hit, whole, atol=1e-5, rtol=1e-5)
    assert int(hit.argmax()) == int(whole.argmax())
    torch.testing.assert_close(k1, k0, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(v1, v0, atol=1e-5, rtol=1e-5)


def test_whole_path_reference_impl_equals_default_on_cpu(params):
    _jp, tp = params
    outs = []
    for impl in (None, "reference"):
        tk, tv = make_pools(TCFG.kv_config(BS, NB), "cpu")
        logits = [_whole_call(tdm, TCFG, tp, tk, tv, kind, a, _tables(),
                              impl)[0] for kind, a in _whole_script()]
        outs.append((logits, tk))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert np.array_equal(a, b)
    assert torch.equal(outs[0][1], outs[1][1])
    for kind, a in _whole_script()[1:]:
        with pytest.raises(ValueError):
            _whole_call(tdm, TCFG, tp, tk, tv, kind, a, _tables(),
                        "kernel")
