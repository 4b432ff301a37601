"""The port's speculative decoding held against plain greedy and the JAX
engine.

A draft model proposes γ tokens a round; one target verify chunk scores
them; greedy accept keeps the longest agreeing prefix. The port's
speculative tokens must equal its plain greedy tokens bit for bit in
chunked and whole mode, for γ 1 and 3, with a small random draft (few
proposals accepted) and with the target as its own draft (nearly all
accepted: the γ cap and the rollback run every round), with EOS inside
an accepted run, at the ``max_context`` cut, under preemption in a
tight pool, with the prefix cache off, with int8 / fp8 / bf16 pools and
quantized weights. At γ 3, with int8 KV + int8 weights and under
preemption (whole mode) they must also equal the JAX engine's
speculative tokens from the same params (``params_from_jax``, target
and draft), with ``stats()["speculation"]`` (rounds, mean accept
length) equal to its; ``warmup()``'s count is the JAX engine's; the
draft guards raise as the JAX ones do; pools end leak-free and
consistent. The target's
params are scaled so that every greedy step's top-2 logit gap exceeds
``MIN_GAP`` (checked by a teacher-forced replay), so no near-tie decides
a token across frameworks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import DecodeEngine as JaxEngine
from paddle_tpu.serving import decode_model as jdm
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.serving import DecodeEngine, make_pools
from paddle_tpu_torch.serving import decode_engine as tde
from paddle_tpu_torch.serving import decode_model as tdm

JCFG = jdm.DecoderConfig(vocab_size=64, d_model=32, n_heads=2,
                         head_dim=16, n_layers=2, d_ff=64, max_seq_len=64)
TCFG = tdm.DecoderConfig(**JCFG.__dict__)
# 1-layer draft, the JAX engine tests' DRAFT_CFG: same vocab, another
# width, so the accept rate does not come from shared weights
JDRAFT = jdm.DecoderConfig(vocab_size=64, d_model=16, n_heads=2,
                           head_dim=8, n_layers=1, d_ff=32, max_seq_len=64)
TDRAFT = tdm.DecoderConfig(**JDRAFT.__dict__)
MAX_NEW = 12
MIN_GAP = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread a worker runs them
    faster than several contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    p = {k: np.asarray(v) for k, v in jdm.init_params(JCFG, 11).items()}
    for k in p:
        if k == "embed" or k.endswith(("wqkv", "wo", "w1", "w2")):
            p[k] = p[k] * 15.0
    return p


@pytest.fixture(scope="module")
def np_draft():
    return {k: np.asarray(v) for k, v in jdm.init_params(JDRAFT, 7).items()}


def _prompts():
    """``test_torch_decode_engine.py``'s prompts: six of 1-19 tokens and
    four behind a shared 9-token prefix."""
    rng = np.random.default_rng(1)
    prefix = rng.integers(1, 64, 9).tolist()
    out = [rng.integers(1, 64, rng.integers(1, 20)).tolist()
           for _ in range(6)]
    out += [prefix + rng.integers(1, 64, rng.integers(1, 8)).tolist()
            for _ in range(4)]
    return out


def _serve(engine, prompts, max_new=MAX_NEW):
    futs = [engine.submit(p, max_new) for p in prompts]
    res = [f.result(timeout=120) for f in futs]
    engine.close()
    return [r.tokens.tolist() for r in res]


def _kv(kw, cfg):
    """``kw`` with a ``(block_size, num_blocks, dtype)`` kv_config built
    for ``cfg``."""
    kw = dict(kw)
    if "kv_config" in kw:
        kw["kv_config"] = cfg.kv_config(*kw["kv_config"])
    return kw


def _spec_run(np_params, np_draft, prompts, draft, max_new=MAX_NEW,
              jax=True, **kw):
    """The port's plain tokens, its speculative tokens, the JAX engine's
    speculative tokens, and the two speculative engines (closed); with
    ``jax=False`` no JAX engine runs (its tokens and engine are None).
    ``draft``: "small" (the 1-layer draft) or "self" (the target)."""
    tp = params_from_jax(np_params, "cpu")
    if draft == "self":
        jd, td = (JCFG, None), (TCFG, tp)
        jdp = {k: jnp.asarray(v) for k, v in np_params.items()}
    else:
        jd, td = (JDRAFT, None), (TDRAFT, params_from_jax(np_draft, "cpu"))
        jdp = {k: jnp.asarray(v) for k, v in np_draft.items()}
    gamma = kw.pop("speculate_k", 3)
    plain = _serve(DecodeEngine(TCFG, tp, device="cpu", **_kv(kw, TCFG)),
                   prompts, max_new)
    teng = DecodeEngine(TCFG, tp, device="cpu", draft_cfg=td[0],
                        draft_params=td[1], speculate_k=gamma,
                        **_kv(kw, TCFG))
    got = _serve(teng, prompts, max_new)
    if not jax:
        return plain, got, None, teng, None
    jeng = JaxEngine(JCFG, {k: jnp.asarray(v) for k, v in
                            np_params.items()}, draft_cfg=jd[0],
                     draft_params=jdp, speculate_k=gamma, **_kv(kw, JCFG))
    want = _serve(jeng, prompts, max_new)
    return plain, got, want, teng, jeng


def _greedy_gap(tp, prompt, gen, kv_dtype="float32", cal=(None, None)):
    """Teacher-forced replay of prompt+generation in one port mixed_step:
    argmax must reproduce ``gen``; returns the smallest top-2 logit gap
    over the generated positions."""
    seq = list(prompt) + list(gen[:-1])
    n = len(seq)
    k, v = make_pools(TCFG.kv_config(4, 17, kv_dtype), "cpu", *cal)
    logits, _, _ = tdm.mixed_step(TCFG, tp, k, v, np.asarray(seq),
                                  np.zeros(n, np.int32), np.arange(n),
                                  np.ones(n, bool),
                                  np.arange(16, dtype=np.int32)[None])
    lg = logits[len(prompt) - 1:].numpy()
    assert lg.argmax(-1).tolist() == list(gen)
    top = np.sort(lg, axis=-1)
    return float((top[:, -1] - top[:, -2]).min())


def _check_engines(teng, jeng, got, want, plain):
    """Speculative == plain greedy in the port, pools clean; with a JAX
    engine, its tokens and speculation stats too. (The port's plain
    tokens are the JAX engine's by ``test_torch_decode_engine.py`` on
    the same params and prompts, and the JAX engine's speculative
    tokens its plain ones by its own tests.)"""
    assert got == plain, "speculative greedy diverged from plain greedy"
    ts = teng.stats()["speculation"]
    assert ts["rounds"] > 0 and ts["verify_steps"] > 0
    if jeng is not None:
        assert got == want, "the port's speculative tokens are not JAX's"
        js = jeng.stats()["speculation"]
        assert {k: ts[k] for k in js} == js
    teng.pool.assert_consistent()
    assert teng.pool.check_leaks() == [] and teng.pool.blocks_in_use == 0
    assert teng._accept_len.count == ts["rounds"]


@pytest.mark.parametrize("draft", ["small", "self"])
@pytest.mark.parametrize("gamma", [1, 3])
@pytest.mark.parametrize("mode", ["chunked", "whole"])
def test_spec_tokens_match_plain_and_jax(np_params, np_draft, mode, gamma,
                                         draft):
    """Against JAX at γ 3 (a JAX engine compiles for seconds: γ 1 is held
    to the port's plain greedy only)."""
    prompts = _prompts()
    plain, got, want, teng, jeng = _spec_run(
        np_params, np_draft, prompts, draft, block_size=4, num_blocks=96,
        max_slots=4, eos_id=0, prefill_mode=mode, speculate_k=gamma,
        jax=gamma == 3)
    _check_engines(teng, jeng, got, want, plain)
    gaps = [_greedy_gap(teng.params, p, g) for p, g in zip(prompts, got)]
    assert min(gaps) > MIN_GAP, "a near-tie decided a greedy token"
    st = teng.stats()
    assert st["prefix"]["hit_tokens"] > 0
    acc = st["speculation"]["mean_accept_len"]
    if draft == "self":       # the target proposes its own tokens
        assert acc > 0.9 * gamma
    assert 0.0 <= acc <= gamma


@pytest.mark.parametrize("mode", ["chunked", "whole"])
def test_spec_under_preemption(np_params, np_draft, mode):
    """A pool too small for the load: the newest request is preempted
    while a speculative horizon grows, restarts, and every token is
    still plain greedy's."""
    prompts = _prompts()
    plain, got, want, teng, jeng = _spec_run(
        np_params, np_draft, prompts, "self", block_size=4, num_blocks=14,
        max_slots=3, eos_id=0, prefill_mode=mode, jax=mode == "whole")
    _check_engines(teng, jeng, got, want, plain)
    assert teng.stats()["preempted_total"] > 0
    assert jeng is None or jeng.stats()["preempted_total"] > 0


@pytest.mark.parametrize("mode", ["chunked", "whole"])
def test_spec_eos_inside_an_accepted_run(np_params, mode):
    """EOS is a token plain greedy emits mid-generation; with the target
    as its own draft it lands inside an accepted run, and the emission
    is cut exactly where plain greedy cuts it."""
    tp = params_from_jax(np_params, "cpu")
    prompts = _prompts()
    free = _serve(DecodeEngine(TCFG, tp, device="cpu", block_size=4,
                               num_blocks=96, eos_id=-1), prompts)
    # the first token that first appears 3+ tokens into a generation
    j, eos = next((j, g[i]) for j, g in enumerate(free)
                  for i in range(3, len(g)) if g[i] not in g[:i])
    plain, got, want, teng, jeng = _spec_run(
        np_params, None, prompts, "self", block_size=4, num_blocks=96,
        max_slots=4, eos_id=eos, prefill_mode=mode, jax=False)
    _check_engines(teng, jeng, got, want, plain)
    cut = [g for g in got if g[-1] == eos]
    assert cut and any(len(g) < MAX_NEW for g in cut)
    assert got[j] == free[j][:free[j].index(eos) + 1]


@pytest.mark.parametrize("mode", ["chunked", "whole"])
def test_spec_max_context_cut(np_params, np_draft, mode):
    """``max_context`` under the model's: the draft stops writing there,
    the verify chunk's rows past it are masked, and every generation is
    cut where plain greedy cuts it."""
    prompts = _prompts()
    plain, got, want, teng, jeng = _spec_run(
        np_params, np_draft, prompts, "self", max_new=20, block_size=4,
        num_blocks=64, max_slots=3, eos_id=0, prefill_mode=mode,
        max_context=22, jax=False)
    _check_engines(teng, jeng, got, want, plain)
    assert all(len(p) + len(g) <= 22 for p, g in zip(prompts, got))
    assert any(len(p) + len(g) == 22 and len(g) < 20
               for p, g in zip(prompts, got))


@pytest.mark.parametrize("mode", ["chunked", "whole"])
def test_spec_prefix_cache_off(np_params, np_draft, mode):
    prompts = _prompts()
    plain, got, want, teng, jeng = _spec_run(
        np_params, np_draft, prompts, "small", block_size=4, num_blocks=40,
        max_slots=2, eos_id=0, prefill_mode=mode, prefix_cache=False,
        jax=False)
    _check_engines(teng, jeng, got, want, plain)
    assert teng.stats()["prefix"]["hit_tokens"] == 0
    assert teng.pool.stats()["cached_blocks"] == 0


@pytest.mark.parametrize("mode", ["chunked", "whole"])
@pytest.mark.parametrize("kv_dtype,w_dtype", [
    ("int8", "int8"), ("fp8-e4m3", "fp8-e4m3"), ("bfloat16", None),
    ("int8", None)])
def test_spec_quantized(np_params, np_draft, kv_dtype, w_dtype, mode):
    """A quantized pool gives the draft a pool of the same dtype with its
    own calibration probe (the JAX engine's); ``quant_plan`` quantizes
    the target only. Against JAX with int8 KV and weights."""
    prompts = _prompts()
    plain, got, want, teng, jeng = _spec_run(
        np_params, np_draft, prompts, "small",
        kv_config=(4, 40, kv_dtype), max_slots=3, eos_id=0,
        quant_plan=w_dtype, prefill_mode=mode,
        jax=(kv_dtype, w_dtype) == ("int8", "int8"))
    _check_engines(teng, jeng, got, want, plain)
    assert teng.draft_kv.dtype == kv_dtype
    assert not any(k.endswith("__q") for k in teng.draft_params)
    cal = (None, None)
    if teng.kv.quantized:
        cal = tde._probe_kv_absmax(TCFG, teng.params)
        dcal = tde._probe_kv_absmax(TDRAFT, teng.draft_params)
        np.testing.assert_array_equal(
            teng._dk_pool[2].numpy(),
            np.maximum(dcal[0], 1e-8) / teng.draft_kv.quant_qmax)
        for t, j in (() if jeng is None else
                     ((teng._dk_pool, jeng._dk_pool),
                      (teng._dv_pool, jeng._dv_pool))):
            np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]),
                                       rtol=1e-5)
    gaps = [_greedy_gap(teng.params, p, g, kv_dtype, cal)
            for p, g in zip(prompts, got)]
    assert min(gaps) > MIN_GAP, "a near-tie decided a greedy token"


@pytest.mark.parametrize("mode,n", [("chunked", 3), ("whole", 3 + 4)])
def test_spec_warmup_count_and_clean_pools(np_params, np_draft, mode, n):
    kw = dict(block_size=4, num_blocks=32, prefill_mode=mode,
              prompt_rungs=(4, 8, 16, 32), speculate_k=2)
    eng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                       device="cpu", draft_cfg=TDRAFT,
                       draft_params=params_from_jax(np_draft, "cpu"), **kw)
    jeng = JaxEngine(JCFG, jdm.init_params(JCFG, 0), draft_cfg=JDRAFT,
                     autostart=False, **kw)
    assert eng.warmup() == jeng.warmup() == n
    jeng.close()
    for pool in (eng._k_pool, eng._v_pool, eng._dk_pool, eng._dv_pool):
        assert not pool.any()               # the warmup wrote nothing
    res = eng.generate([3, 4, 5], 6, timeout=60)
    st = eng.stats()
    eng.close()
    assert len(res.tokens) >= 1 and st["warmed"]
    assert st["speculation"]["gamma"] == 2
    assert st["steps_total"] >= st["speculation"]["verify_steps"] >= 1


def test_spec_draft_defaults_to_seeded_init(np_params):
    eng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                       device="cpu", draft_cfg=TDRAFT, speculate_k=2,
                       seed=5, autostart=False)
    want = tdm.init_params(TDRAFT, 5, "cpu")
    assert all(torch.equal(eng.draft_params[k], want[k]) for k in want)
    eng.close()
    off = DecodeEngine(TCFG, device="cpu", draft_cfg=TDRAFT,
                       autostart=False)       # speculate_k 0: no draft
    assert off.draft_cfg is None and off._dk_pool is None
    off.close()


@pytest.mark.parametrize("kw,match", [
    (dict(speculate_k=-1), "speculate_k"),
    (dict(speculate_k=2), "draft_cfg"),
    (dict(speculate_k=2, draft=dict(max_seq_len=16)), "max_seq_len"),
    (dict(speculate_k=2, draft=dict(vocab_size=65)), "vocab"),
])
def test_spec_guards_raise_as_jax(kw, match):
    kw = dict(kw)
    draft = kw.pop("draft", None)
    for cfg_cls, eng_cls, dcfg, extra in (
            (tdm.DecoderConfig, DecodeEngine, TDRAFT, dict(device="cpu")),
            (jdm.DecoderConfig, JaxEngine, JDRAFT, {})):
        if draft is not None:
            extra = dict(extra, draft_cfg=cfg_cls(**dict(dcfg.__dict__,
                                                         **draft)))
        cfg = TCFG if eng_cls is DecodeEngine else JCFG
        with pytest.raises(ValueError, match=match):
            eng_cls(cfg, block_size=4, num_blocks=16, max_context=32,
                    autostart=False, **kw, **extra)


def test_spec_draft_params_on_another_device_raise(np_params):
    meta = {k: v.to("meta") for k, v in
            tdm.init_params(TDRAFT, device="cpu").items()}
    with pytest.raises(ValueError, match="draft param"):
        DecodeEngine(TCFG, params_from_jax(np_params, "cpu"), device="cpu",
                     draft_cfg=TDRAFT, draft_params=meta, speculate_k=2,
                     autostart=False)


def test_spec_round_reads_back_once(np_params, np_draft, monkeypatch):
    """A round's proposals and verify tokens come back in ONE host copy:
    the draft's argmax stays on the device between steps."""
    eng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                       device="cpu", block_size=4, num_blocks=32,
                       draft_cfg=TDRAFT, speculate_k=3,
                       draft_params=params_from_jax(np_draft, "cpu"),
                       prefill_mode="whole", autostart=False)
    reads = []
    real = torch.Tensor.cpu

    def counting_cpu(t, *a, **k):
        reads.append(tuple(t.shape))
        return real(t, *a, **k)

    eng._tokens[:2] = [5, 6]
    eng._seq_lens[:2] = [0, 3]
    eng._tables[:2, 0] = [1, 2]
    dec = np.zeros((eng.max_slots,), bool)
    dec[:2] = True
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    props, verify = eng._dispatch_spec(dec)
    monkeypatch.undo()
    eng.close()
    assert reads == [(eng.max_slots, 2 * 3 + 1)]
    assert props.shape == (eng.max_slots, 3)
    assert verify.shape == (eng.max_slots, 4)
