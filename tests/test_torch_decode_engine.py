"""The port's DecodeEngine held against the JAX package's.

Both engines (chunked prefill, continuous admission, prefix cache on)
serve the same prompts from the same params — including a shared
prefix (prefix-cache hits) and a pool small enough to force preemption
— and must return identical greedy tokens. The params scale up
``embed`` and the projections so that generations depend on context,
and the test checks that every greedy step's top-2 logit gap exceeds
1e-3, so no near-tie (fp32 differs across frameworks by ~1e-6) decides
the result. The quantized configurations (int8 KV + int8 weights,
fp8-e4m3 KV + fp8 weights, bfloat16 KV) are held to the same, with the
same default calibration probe on both sides. Also: solo == batched
inside the port, the options not ported yet (telemetry, the compile
cache) raise, entry points raise without a card unless asked for the
CPU, and no module of the port imports JAX or the JAX package.
Speculation and beams: ``test_torch_decode_spec.py``,
``test_torch_decode_beam.py``."""
import ast
import os
import pathlib
import sys
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import DecodeEngine as JaxEngine
from paddle_tpu.serving import decode_engine as jde
from paddle_tpu.serving import decode_model as jdm
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.serving import (DecodeEngine, DecodeResult,
                                      ServingOverloadError, make_pools)
from paddle_tpu_torch.serving import decode_engine as tde
from paddle_tpu_torch.serving import decode_model as tdm

REPO = pathlib.Path(__file__).resolve().parents[1]
JCFG = jdm.DecoderConfig(vocab_size=64, d_model=32, n_heads=2,
                         head_dim=16, n_layers=2, d_ff=64, max_seq_len=64)
TCFG = tdm.DecoderConfig(**JCFG.__dict__)
MAX_NEW = 12
MIN_GAP = 1e-3


@pytest.fixture(scope="module")
def np_params():
    p = {k: np.asarray(v) for k, v in jdm.init_params(JCFG, 11).items()}
    for k in p:
        if k == "embed" or k.endswith(("wqkv", "wo", "w1", "w2")):
            p[k] = p[k] * 15.0
    return p


def _prompts():
    rng = np.random.default_rng(1)
    prefix = rng.integers(1, 64, 9).tolist()
    out = [rng.integers(1, 64, rng.integers(1, 20)).tolist()
           for _ in range(6)]
    out += [prefix + rng.integers(1, 64, rng.integers(1, 8)).tolist()
            for _ in range(4)]
    return out


def _serve(engine, prompts):
    futs = [engine.submit(p, MAX_NEW) for p in prompts]
    res = [f.result(timeout=120) for f in futs]
    engine.close()
    return [r.tokens.tolist() for r in res]


def _greedy_gap(tp, prompt, gen, kv_dtype="float32", cal=(None, None)):
    """Teacher-forced replay of prompt+generation in one port
    mixed_step (pools of ``kv_dtype`` under calibration ``cal``):
    argmax must reproduce ``gen``; returns the smallest top-2 logit gap
    over the generated positions."""
    seq = list(prompt) + list(gen[:-1])
    n = len(seq)
    k, v = make_pools(TCFG.kv_config(4, 17, kv_dtype), "cpu", *cal)
    tables = np.arange(16, dtype=np.int32)[None]
    logits, _, _ = tdm.mixed_step(TCFG, tp, k, v, np.asarray(seq),
                                  np.zeros(n, np.int32), np.arange(n),
                                  np.ones(n, bool), tables)
    lg = logits[len(prompt) - 1:].numpy()
    assert lg.argmax(-1).tolist() == list(gen)
    top = np.sort(lg, axis=-1)
    return float((top[:, -1] - top[:, -2]).min())


@pytest.mark.parametrize("pool", ["roomy", "tight"])
def test_greedy_tokens_match_jax_engine(np_params, pool):
    kw = dict(block_size=4, num_blocks=96 if pool == "roomy" else 14,
              max_slots=4 if pool == "roomy" else 3, eos_id=0)
    prompts = _prompts()
    jeng = JaxEngine(JCFG, {k: jnp.asarray(v) for k, v in
                            np_params.items()}, **kw)
    want = _serve(jeng, prompts)
    tp = params_from_jax(np_params, "cpu")
    teng = DecodeEngine(TCFG, tp, device="cpu", **kw)
    got = _serve(teng, prompts)
    assert got == want
    gaps = [_greedy_gap(tp, p, g) for p, g in zip(prompts, got)]
    assert min(gaps) > MIN_GAP, "a near-tie decided a greedy token"
    st = teng.stats()
    assert st["prefix"]["hit_tokens"] > 0
    if pool == "tight":
        assert st["preempted_total"] > 0, "pool sized to force preemption"
        assert jeng.stats()["preempted_total"] > 0
    teng.pool.assert_consistent()
    assert teng.pool.check_leaks() == []
    assert all(1 <= len(g) <= MAX_NEW for g in got)


@pytest.mark.parametrize("pool", ["roomy", "tight"])
@pytest.mark.parametrize("kv_dtype,w_dtype", [
    ("int8", "int8"), ("fp8-e4m3", "fp8-e4m3"), ("bfloat16", None)])
def test_quantized_greedy_tokens_match_jax_engine(np_params, kv_dtype,
                                                  w_dtype, pool):
    nb = 96 if pool == "roomy" else 14
    kw = dict(max_slots=4 if pool == "roomy" else 3, eos_id=0,
              quant_plan=w_dtype)
    prompts = _prompts()
    jeng = JaxEngine(JCFG, {k: jnp.asarray(v) for k, v in
                            np_params.items()},
                     kv_config=JCFG.kv_config(4, nb, kv_dtype), **kw)
    want = _serve(jeng, prompts)
    tp = params_from_jax(np_params, "cpu")
    teng = DecodeEngine(TCFG, tp, device="cpu",
                        kv_config=TCFG.kv_config(4, nb, kv_dtype), **kw)
    got = _serve(teng, prompts)
    assert got == want
    cal = (None, None)
    if teng.kv.quantized:
        cal = tde._probe_kv_absmax(TCFG, teng.params)
        np.testing.assert_array_equal(
            teng._k_pool[2].numpy(),
            (np.maximum(cal[0], 1e-8) / teng.kv.quant_qmax))
    gaps = [_greedy_gap(teng.params, p, g, kv_dtype, cal)
            for p, g in zip(prompts, got)]
    assert min(gaps) > MIN_GAP, "a near-tie decided a greedy token"
    st = teng.stats()
    assert st["prefix"]["hit_tokens"] > 0
    if pool == "tight":
        assert st["preempted_total"] > 0, "pool sized to force preemption"
    assert st["quant"] == jeng.stats()["quant"]
    assert st["quant"] == {"kv_dtype": kv_dtype,
                           "kv_quantized": kv_dtype != "bfloat16",
                           "weights_quantized": w_dtype is not None}
    teng.pool.assert_consistent()
    assert teng.pool.check_leaks() == []


@pytest.mark.parametrize("w_dtype", [None, "int8"])
def test_probe_calibration_matches_jax(np_params, w_dtype):
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    tp = params_from_jax(np_params, "cpu")
    if w_dtype is not None:
        jp = jdm.quantize_decoder_params(JCFG, jp, w_dtype)
        tp = tdm.quantize_decoder_params(TCFG, tp, w_dtype)
    want = jde._probe_kv_absmax(JCFG, jp)
    got = tde._probe_kv_absmax(TCFG, tp)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (2, 2)
        np.testing.assert_allclose(g, w, rtol=1e-5)


def test_params_from_jax_takes_a_quantized_dict(np_params):
    """A param dict quantized on the JAX side (int8 and fp8 payloads)
    crosses with ``params_from_jax`` and serves the JAX engine's
    tokens with no ``quant_plan`` on either side."""
    jq = jdm.quantize_decoder_params(
        JCFG, {k: jnp.asarray(v) for k, v in np_params.items()},
        types.SimpleNamespace(decisions=[
            types.SimpleNamespace(name="wqkv", dtype="fp8-e4m3"),
            types.SimpleNamespace(name="wo", dtype="bfloat16"),
            types.SimpleNamespace(name="w2", dtype="int8")]))
    tp = params_from_jax({k: np.asarray(v) for k, v in jq.items()}, "cpu")
    assert tp["l0_wqkv__q"].dtype == torch.float8_e4m3fn
    assert tp["l1_w2__q"].dtype == torch.int8 and "l0_wo" in tp
    assert tp["l0_w1__q"].dtype == torch.int8        # the ratio rule
    prompts = _prompts()[:4]
    kw = dict(block_size=4, num_blocks=64, max_slots=2, eos_id=0)
    want = _serve(JaxEngine(JCFG, jq, **kw), prompts)
    teng = DecodeEngine(TCFG, tp, device="cpu", **kw)
    assert _serve(teng, prompts) == want
    assert teng.stats()["quant"]["weights_quantized"] is False


def test_explicit_kv_calibration(np_params):
    ka = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    va = np.float32(5.0)
    kw = dict(kv_config=TCFG.kv_config(4, 16, "int8"),
              kv_calibration=(ka, va), autostart=False)
    eng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                       device="cpu", **kw)
    jeng = JaxEngine(JCFG, {k: jnp.asarray(v) for k, v in
                            np_params.items()},
                     kv_config=JCFG.kv_config(4, 16, "int8"),
                     kv_calibration=(ka, va), autostart=False)
    for t, j in ((eng._k_pool, jeng._k_pool), (eng._v_pool, jeng._v_pool)):
        np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    assert eng.warmup() == 1
    assert not eng._k_pool[0].view(torch.uint8).any()
    assert not eng._k_pool[1].any()              # no scale was written
    eng.close()
    jeng.close()


def test_solo_equals_churning_batch(np_params):
    tp = params_from_jax(np_params, "cpu")
    prompts = _prompts()
    batch = _serve(DecodeEngine(TCFG, tp, device="cpu", block_size=4,
                                num_blocks=40, max_slots=3,
                                chunk_size=3), prompts)
    solo_eng = DecodeEngine(TCFG, tp, device="cpu", block_size=4,
                            num_blocks=40, max_slots=1, chunk_size=5)
    solo = [solo_eng.generate(p, MAX_NEW, timeout=60).tokens.tolist()
            for p in prompts]
    solo_eng.close()
    assert solo == batch


def test_concurrent_clients_stress(np_params):
    """More client threads than cores submit at once, with a short
    switch interval; every request completes with its solo tokens and
    the pool ends consistent and empty."""
    tp = params_from_jax(np_params, "cpu")
    prompts = _prompts()
    want = _serve(DecodeEngine(TCFG, tp, device="cpu", block_size=4,
                               num_blocks=24, max_slots=3), prompts)
    eng = DecodeEngine(TCFG, tp, device="cpu", block_size=4,
                       num_blocks=24, max_slots=3)
    n_threads = 2 * len(os.sched_getaffinity(0)) + 1
    got, errors = {}, []

    def client(i):
        try:
            j = i % len(prompts)
            got[i] = (j, eng.generate(prompts[j], MAX_NEW,
                                      timeout=120).tokens.tolist())
        except Exception as exc:       # surfaced by the assert below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        eng.close()
    assert errors == [] and len(got) == n_threads
    assert all(toks == want[j] for j, toks in got.values())
    eng.pool.assert_consistent()
    assert eng.pool.check_leaks() == [] and eng.stats()[
        "requests_total"] == n_threads


def test_stats_keys_are_the_jax_engines(np_params):
    eng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                       device="cpu", block_size=4, num_blocks=32)
    assert eng.warmup() == 1
    assert not eng._k_pool.any()            # the warmup wrote nothing
    res = eng.generate([3, 4, 5], 4, timeout=60)
    assert isinstance(res, DecodeResult) and res.ttft_ms >= 0.0
    st = eng.stats()
    eng.close()
    jeng = JaxEngine(JCFG, jdm.init_params(JCFG, 0), block_size=4,
                     num_blocks=32, autostart=False)
    jkeys = set(jeng.stats())
    jeng.close()
    assert set(st) - {"device"} <= jkeys
    for key in ("tokens_total", "steps_total", "preempted_total",
                "ttft_ms_p99", "prefix", "chunked_prefill", "kv"):
        assert key in st
    assert st["warmed"] and st["tokens_total"] == len(res.tokens)
    names = {m.name for m in eng.registry.metrics()}
    assert {"decode_ttft_ms", "decode_tokens_total",
            "decode_mixed_step_fill_frac"} <= names


def test_queue_backpressure(np_params):
    eng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                       device="cpu", block_size=4, num_blocks=32,
                       max_queue=1, autostart=False)
    eng._started = True                     # hold the loop: queue only
    eng.submit([1, 2])
    with pytest.raises(ServingOverloadError):
        eng.submit([1, 2])
    with pytest.raises(ValueError):
        eng.submit([])
    eng.close()


@pytest.mark.parametrize("kw,item", [
    (dict(compile_cache="/nonexistent"), "A6.7"),
    (dict(telemetry=object()), "A6.6"),
])
def test_unported_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        DecodeEngine(TCFG, device="cpu", autostart=False, **kw)


def test_entry_points_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(TCFG, autostart=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdm.init_params(TCFG)
    meta = {k: v.to("meta") for k, v in
            tdm.init_params(TCFG, device="cpu").items()}
    with pytest.raises(ValueError, match="meta"):
        DecodeEngine(TCFG, meta, device="cpu", autostart=False)


# ---- whole-prompt prefill and static admission

def _whole_pair(np_params, prompts, **kw):
    """The JAX engine's and the port's greedy tokens for ``prompts``
    under the same options, and the port engine (closed)."""
    jkw, tkw = dict(kw), dict(kw)
    if "kv_config" in kw:               # (block_size, num_blocks, dtype)
        jkw["kv_config"] = JCFG.kv_config(*kw["kv_config"])
        tkw["kv_config"] = TCFG.kv_config(*kw["kv_config"])
    want = _serve(JaxEngine(JCFG, {k: jnp.asarray(v) for k, v in
                                   np_params.items()}, **jkw), prompts)
    teng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                        device="cpu", **tkw)
    return want, _serve(teng, prompts), teng


@pytest.mark.parametrize("pool", ["roomy", "tight"])
@pytest.mark.parametrize("admission", ["continuous", "static"])
def test_whole_greedy_tokens_match_jax_engine(np_params, admission, pool):
    kw = dict(block_size=4, num_blocks=96 if pool == "roomy" else 14,
              max_slots=4 if pool == "roomy" else 3, eos_id=0,
              prefill_mode="whole", admission=admission)
    prompts = _prompts()
    want, got, teng = _whole_pair(np_params, prompts, **kw)
    assert got == want
    tp = teng.params
    gaps = [_greedy_gap(tp, p, g) for p, g in zip(prompts, got)]
    assert min(gaps) > MIN_GAP, "a near-tie decided a greedy token"
    st = teng.stats()
    assert st["prefix"]["hit_tokens"] > 0 and st["prefix"]["enabled"]
    assert st["prefills_total"] >= len(prompts)
    if pool == "tight":
        assert st["preempted_total"] > 0, "pool sized to force preemption"
    teng.pool.assert_consistent()
    assert teng.pool.check_leaks() == []
    # the port's chunked engine gives the same tokens
    chunked = _serve(DecodeEngine(TCFG, tp, device="cpu",
                                  **dict(kw, prefill_mode="chunked")),
                     prompts)
    assert chunked == got


@pytest.mark.parametrize("kv_dtype,w_dtype", [
    ("int8", "int8"), ("fp8-e4m3", "fp8-e4m3"), ("bfloat16", None)])
def test_whole_quantized_greedy_tokens_match_jax_engine(np_params,
                                                        kv_dtype, w_dtype):
    prompts = _prompts()
    want, got, teng = _whole_pair(
        np_params, prompts, kv_config=(4, 40, kv_dtype), max_slots=3,
        eos_id=0, quant_plan=w_dtype, prefill_mode="whole")
    assert got == want
    cal = (None, None)
    if teng.kv.quantized:
        cal = tde._probe_kv_absmax(TCFG, teng.params)
    gaps = [_greedy_gap(teng.params, p, g, kv_dtype, cal)
            for p, g in zip(prompts, got)]
    assert min(gaps) > MIN_GAP, "a near-tie decided a greedy token"
    st = teng.stats()
    assert st["prefix"]["hit_tokens"] > 0
    assert st["quant"]["kv_dtype"] == kv_dtype
    teng.pool.assert_consistent()
    assert teng.pool.check_leaks() == []


@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_prefix_cache_off_matches_jax_engine(np_params, mode):
    """``prefix_cache=False``: no block is acquired or published, and the
    tokens are the JAX engine's (and the cache-on run's)."""
    kw = dict(block_size=4, num_blocks=40, max_slots=2, eos_id=0,
              prefill_mode=mode)
    prompts = _prompts()
    want, got, teng = _whole_pair(np_params, prompts, prefix_cache=False,
                                  **kw)
    assert got == want
    st = teng.stats()
    assert st["prefix"] == {"enabled": False, "hit_tokens": 0,
                            "miss_tokens": float(sum(map(len, prompts))),
                            "hit_rate": 0.0}
    assert teng.pool.stats()["cached_blocks"] == 0
    on = _serve(DecodeEngine(TCFG, teng.params, device="cpu", **kw),
                prompts)
    assert on == got


def test_whole_max_context_matches_jax_engine(np_params):
    """A ``max_context`` under the model's caps every generation where
    the JAX engine caps it; one past ``max_seq_len`` raises."""
    kw = dict(block_size=4, num_blocks=64, max_slots=3, eos_id=0,
              prefill_mode="whole", max_context=22)
    prompts = _prompts()
    want, got, teng = _whole_pair(np_params, prompts, **kw)
    assert got == want
    assert all(len(p) + len(g) <= 22 for p, g in zip(prompts, got))
    with pytest.raises(ValueError, match="max_context"):
        DecodeEngine(TCFG, device="cpu", autostart=False,
                     max_context=TCFG.max_seq_len + 1)


def test_whole_mode_options_validate_like_jax(np_params):
    tp = params_from_jax(np_params, "cpu")
    eng = DecodeEngine(TCFG, tp, device="cpu", block_size=4,
                       num_blocks=32, prefill_mode="whole",
                       prompt_rungs=(16, 4, 8), autostart=False)
    jeng = JaxEngine(JCFG, {k: jnp.asarray(v) for k, v in
                            np_params.items()}, block_size=4,
                     num_blocks=32, prefill_mode="whole",
                     prompt_rungs=(16, 4, 8), autostart=False)
    assert eng.prompt_rungs == jeng.prompt_rungs == (4, 8, 16)
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="largest prompt rung 16"):
            e.submit(list(range(1, 18)))
    eng._started = True                     # hold the loop: queue only
    for n in (3, 7, 9, 12):
        eng.submit(list(range(1, n + 1)))
    assert eng.stats()["queue_depth_by_rung"] == {"4": 1, "8": 1,
                                                  "16": 2}
    eng.close()
    jeng.close()
    for bad in (dict(prompt_rungs=()), dict(admission="batch"),
                dict(prefill_mode="eager")):
        with pytest.raises(ValueError):
            DecodeEngine(TCFG, device="cpu", autostart=False, **bad)


def test_whole_warmup_and_stats_keys(np_params):
    """Whole-mode ``warmup()`` dispatches the decode step and one
    prefill per rung on inert inputs (the pool stays clean) and returns
    ``1 + len(prompt_rungs)``, as the JAX engine counts its entries; the
    stats keys are the JAX engine's."""
    eng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                       device="cpu", block_size=4, num_blocks=32,
                       prefill_mode="whole", admission="static",
                       prompt_rungs=(4, 8, 16, 32))
    assert eng.warmup() == 5
    assert not eng._k_pool.any() and not eng._v_pool.any()
    res = eng.generate([3, 4, 5], 4, timeout=60)
    assert isinstance(res, DecodeResult) and res.ttft_ms >= 0.0
    st = eng.stats()
    eng.close()
    jeng = JaxEngine(JCFG, jdm.init_params(JCFG, 0), block_size=4,
                     num_blocks=32, prefill_mode="whole",
                     admission="static", autostart=False)
    jkeys = set(jeng.stats())
    jeng.close()
    assert set(st) - {"device"} <= jkeys
    assert st["prompt_rungs"] == [4, 8, 16, 32]
    assert st["queue_depth_by_rung"] == {}
    assert st["prefix"]["enabled"] is True
    assert (st["prefill_mode"], st["admission"]) == ("whole", "static")
    assert st["warmed"] and st["prefills_total"] == 1
    assert st["steps_total"] == len(res.tokens) - 1


def test_whole_prefill_failure_fails_the_request_leak_free(np_params,
                                                          monkeypatch):
    """A prefill dispatch that raises fails its request's future and
    every queued one, and leaves no block allocated."""
    eng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                       device="cpu", block_size=4, num_blocks=32,
                       prefill_mode="whole", autostart=False)

    def broken(*args, **kwargs):
        raise RuntimeError("prefill kernel launch failed")

    monkeypatch.setattr(tdm, "prefill", broken)
    futs = [eng.submit([1, 2, 3], 4), eng.submit([4, 5], 4)]
    eng.start()
    for f in futs:
        with pytest.raises(RuntimeError, match="launch failed"):
            f.result(timeout=60)
    eng.close()
    assert eng.pool.blocks_in_use == 0 and eng.pool.check_leaks() == []


def _port_files():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    files = _port_files()
    assert len(files) > 10 and files[-1].is_file()
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", getattr(
                      node.func, "attr", "")) in ("__import__",
                                                  "import_module")):
                mods = [a.value for a in node.args
                        if isinstance(a, ast.Constant)]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "paddle_tpu"):
                    bad.append(f"{path.relative_to(REPO)}: {m}")
    assert bad == []
