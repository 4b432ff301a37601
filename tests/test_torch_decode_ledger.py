"""The port's DecodeEngine telemetry, lifecycle ledger and serving
goodput held against the JAX engine's, and the options that used to
fail with ``TypeError`` (ROADMAP C6).

Both engines are built with ``autostart=False``, get every request
submitted, then start: they admit and step the same way, so each
request's ledger events are the JAX engine's once their time field
(and a chunk's share ms, a prefill's ms) is dropped. Covered: chunked
and whole prefill, continuous and static admission, a pool tight
enough to preempt (``requestz(preempts=True)``), ``ledger=False``,
speculation (``spec`` events) in both modes, and beams on an int8 pool
(``cow`` events); ``stats()["ledger"]``, the key sets of
``stats()["goodput"]`` and the registry's metric names are equal. Then
the JAX engine's own ``TestLifecycleLedger`` reproduced on the port
(exact TTFT sums, the ring bound, the 10% reconciliation), the spans
with ``submit(trace_context=)``, and the C6 repairs: ``attn_impl=``,
``compile_count``, ``Executor.warm``, the kernel wrappers'
``interpret=`` and ``flash_attention``'s tile sizes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.obs.telemetry import Telemetry as JTelemetry
from paddle_tpu.serving import DecodeEngine as JaxEngine
from paddle_tpu.serving import decode_engine as jde
from paddle_tpu.serving import decode_model as jdm
from paddle_tpu_torch import kernels
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.obs import Telemetry
from paddle_tpu_torch.obs.trace import read_trace
from paddle_tpu_torch.serving import DecodeEngine
from paddle_tpu_torch.serving import decode_engine as tde
from paddle_tpu_torch.serving import decode_model as tdm

JCFG = jdm.DecoderConfig(vocab_size=64, d_model=32, n_heads=2,
                         head_dim=16, n_layers=2, d_ff=64, max_seq_len=64)
TCFG = tdm.DecoderConfig(**JCFG.__dict__)
JDRAFT = jdm.DecoderConfig(vocab_size=64, d_model=16, n_heads=2,
                           head_dim=8, n_layers=1, d_ff=32, max_seq_len=64)
TDRAFT = tdm.DecoderConfig(**JDRAFT.__dict__)
MAX_NEW = 12
BASE = dict(block_size=4, num_blocks=96, max_slots=4, eos_id=0,
            prompt_rungs=(8, 16, 32))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny models: one intra-op thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def np_params():
    """Params scaled so that generations depend on context (as in
    ``test_torch_decode_engine.py``, whose prompts and scale give no
    near-tie across frameworks)."""
    p = {k: np.asarray(v) for k, v in jdm.init_params(JCFG, 11).items()}
    for k in p:
        if k == "embed" or k.endswith(("wqkv", "wo", "w1", "w2")):
            p[k] = p[k] * 15.0
    return p


@pytest.fixture(scope="module")
def np_draft():
    return {k: np.asarray(v) for k, v in jdm.init_params(JDRAFT, 7).items()}


def _prompts():
    """Six prompts of 1-19 tokens and four behind a shared 9-token
    prefix (prefix-cache hits)."""
    rng = np.random.default_rng(1)
    prefix = rng.integers(1, 64, 9).tolist()
    out = [rng.integers(1, 64, rng.integers(1, 20)).tolist()
           for _ in range(6)]
    out += [prefix + rng.integers(1, 64, rng.integers(1, 8)).tolist()
            for _ in range(4)]
    return out


def _strip(event):
    """A ledger event without its time field (and a chunk's share ms, a
    prefill's ms, which are measured)."""
    kind = event[0]
    if kind in ("submit", "first_token", "finish", "preempt"):
        return (kind,)
    if kind == "prefill":
        return (kind, event[3])
    if kind == "chunk":
        return (kind, event[2])
    return (kind,) + tuple(event[2:])


def _keys(d):
    """The nested key structure of a dict."""
    return {k: (_keys(v) if isinstance(v, dict) else None)
            for k, v in d.items()}


def _kv(kw, cfg):
    kw = dict(kw)
    if "kv_config" in kw:
        kw["kv_config"] = cfg.kv_config(*kw["kv_config"])
    return kw


def _serve(engine, prompts):
    """Submit every prompt before the loop starts, then serve them."""
    futs = [engine.submit(p, MAX_NEW) for p in prompts]
    engine.start()
    res = [f.result(timeout=120) for f in futs]
    engine.close()       # the loop's last turn closed: a snapshot taken
    st = engine.stats()  # mid-turn holds that turn's parts, not its wall
    by_id = {led["request_id"]: led for led in engine.retired_ledgers()}
    events = [[_strip(e) for e in by_id[r.request_id]["events"]]
              if r.request_id in by_id else None for r in res]
    return [r.tokens.tolist() for r in res], events, st, res


def _pair(np_params, np_draft, spec=False, **kw):
    """The JAX engine's and the port's runs of ``_prompts()`` with the
    same options (and a 1-layer draft at γ 3 with ``spec``)."""
    kw = dict(BASE, **kw)
    jkw, tkw = _kv(kw, JCFG), _kv(kw, TCFG)
    if spec:
        jkw.update(draft_cfg=JDRAFT, speculate_k=3, draft_params={
            k: jnp.asarray(v) for k, v in np_draft.items()})
        tkw.update(draft_cfg=TDRAFT, speculate_k=3,
                   draft_params=params_from_jax(np_draft, "cpu"))
    jeng = JaxEngine(JCFG, {k: jnp.asarray(v) for k, v in
                            np_params.items()}, autostart=False, **jkw)
    teng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                        device="cpu", autostart=False, **tkw)
    return _serve(jeng, _prompts()), _serve(teng, _prompts()), jeng, teng


CASES = {
    "chunked": {},
    "chunked_tight": dict(num_blocks=14, max_slots=3),
    "whole": dict(prefill_mode="whole"),
    "whole_tight_static": dict(prefill_mode="whole", admission="static",
                               num_blocks=14, max_slots=3),
    "chunked_small_chunks": dict(chunk_size=3, prefill_token_budget=5),
    "ledger_off": dict(ledger=False),
    "spec_chunked": dict(spec=True),
    "spec_whole_tight": dict(spec=True, prefill_mode="whole",
                             num_blocks=14, max_slots=3),
    "int8": dict(kv_config=(4, 96, "int8")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ledger_events_and_stats_match_jax(np_params, np_draft, case):
    (jt, jev, jst, _), (tt, tev, tst, tres), jeng, teng = _pair(
        np_params, np_draft, **CASES[case])
    assert tt == jt
    assert tev == jev
    assert tst["ledger"] == jst["ledger"]
    assert _keys(tst["goodput"]) == _keys(jst["goodput"])
    assert {m.name for m in teng.registry.metrics()} == \
        {m.name for m in jeng.registry.metrics()}
    for k in ("turns", "steps"):
        assert tst["goodput"][k] == jst["goodput"][k]
    # every retired request's TTFT decomposes exactly, and the loop's
    # components reconcile its measured wall within 10%
    for led in teng.retired_ledgers():
        assert sum(led["ttft_parts"].values()) == pytest.approx(
            led["ttft_ms"], abs=1e-3)
    snap = teng.goodput_snapshot()
    assert abs(sum(snap["components"].values()) / snap["loop_wall_ms"]
               - 1.0) <= 0.10
    assert 0.0 < tst["goodput"]["decode_goodput"] <= 1.0
    if case == "ledger_off":
        assert teng.retired_ledgers() == [] and tev == [None] * len(tt)
        assert not tst["ledger"]["enabled"]
    if "tight" in case:
        assert tst["preempted_total"] > 0
        pre = teng.requestz(n=50, preempts=True)["requests"]
        jpre = jeng.requestz(n=50, preempts=True)["requests"]
        assert pre and len(pre) == len(jpre)
        idx = {r.request_id: i for i, r in enumerate(tres)}
        for led in pre:
            assert led["preempts"] > 0 and led["timeline"]
            assert any(e[0] == "preempt" for e in led["events"])
            assert led["ttft_parts"]["preempt_redo"] > 0.0
            assert tev[idx[led["request_id"]]] == \
                jev[idx[led["request_id"]]]
        h = teng.registry.find("decode_preempted_redo_ms")
        assert h.count == len(pre)
    if case.startswith("spec"):
        acc = sum(e[2] for ev in tev for e in ev if e[0] == "spec")
        assert acc == teng._spec_accepted == jeng._spec_accepted
        assert snap["components"]["spec_overhead"] > 0.0
    if case == "whole_tight_static":
        assert tst["admission"] == "static"


@pytest.mark.parametrize("mode", ["chunked", "whole"])
def test_beam_mini_ledger_cow_events_match_jax(np_params, mode):
    kw = dict(BASE, prefill_mode=mode, kv_config=(4, 96, "int8"),
              eos_id=-1)
    jeng = JaxEngine(JCFG, {k: jnp.asarray(v) for k, v in
                            np_params.items()}, autostart=False,
                     **_kv(kw, JCFG))
    teng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                        device="cpu", autostart=False, **_kv(kw, TCFG))
    rng = np.random.default_rng(4)
    for _ in range(2):
        p = rng.integers(1, 64, 11).tolist()
        a = jeng.generate_beam(p, beam_size=4, max_new_tokens=9)
        b = teng.generate_beam(p, beam_size=4, max_new_tokens=9)
        np.testing.assert_array_equal(b.sequences, a.sequences)
    jleds, tleds = jeng.retired_ledgers(), teng.retired_ledgers()
    assert [[_strip(e) for e in led["events"]] for led in tleds] == \
        [[_strip(e) for e in led["events"]] for led in jleds]
    assert [led["kind"] for led in tleds] == ["beam", "beam"]
    assert {k: v for k, v in tleds[0].items()
            if k not in ("request_id", "total_ms", "events")} == \
        {k: v for k, v in jleds[0].items()
         if k not in ("request_id", "total_ms", "events")}
    cows = sum(e[2] for led in tleds for e in led["events"]
               if e[0] == "cow")
    assert cows == teng.cow_copies > 0
    assert teng.goodput_snapshot()["components"]["cow_copy"] > 0.0
    # beam mini-ledgers rank by total wall in requestz
    rz = teng.requestz(n=5)
    assert rz["retired_total"] == 2 and rz["requests"][0]["timeline"]
    st = teng.stats()
    assert st["goodput"]["ttft"]["requests"] == 0   # no TTFT parts
    jeng.close()
    teng.close()


# ---- the JAX engine's TestLifecycleLedger, on the port

def _engine(np_params, **kw):
    return DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                        device="cpu", **dict(BASE, **kw))


def _rs_prompts(n, seed=0, lo=1, hi=13):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 64, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def test_ring_bound_and_exact_ttft_decomposition(np_params):
    eng = _engine(np_params, ledger_ring=4)
    futs = [eng.submit(p, max_new_tokens=4)
            for p in _rs_prompts(8, seed=40)]
    for f in futs:
        f.result(timeout=120)
    eng.close()          # after the loop's last turn (see _serve)
    ledgers = eng.retired_ledgers()
    rz = eng.requestz(n=10)
    snap = eng.goodput_snapshot()
    st = eng.stats()
    assert rz["retired_total"] == 8
    assert rz["ring"] == 4 and len(ledgers) == 4
    assert eng.retired_ledgers(2) == ledgers[-2:]
    for led in ledgers:
        assert sum(led["ttft_parts"].values()) == pytest.approx(
            led["ttft_ms"], abs=1e-3)
        ts = {e[0]: float(e[1]) for e in led["events"]}
        seq = [ts["submit"], ts["admit"], ts["first_token"],
               ts["finish"]]
        assert seq == sorted(seq)
    ttfts = [r["ttft_ms"] for r in rz["requests"]]
    assert ttfts == sorted(ttfts, reverse=True)
    assert all(r["timeline"] for r in rz["requests"])
    recent = eng.requestz(n=10, order="recent")["requests"]
    assert [r["request_id"] for r in recent] == \
        [led["request_id"] for led in ledgers[::-1]]
    total = sum(snap["components"].values())
    assert snap["loop_wall_ms"] > 0
    assert abs(total / snap["loop_wall_ms"] - 1.0) <= 0.10
    g = st["goodput"]
    assert g["verdict"] in ("prefill-bound", "chunked-prefill-bound",
                            "compute-bound", "host-bound",
                            "speculation-bound", "cow-bound", "idle")
    assert 0.0 <= g["decode_goodput"] <= 1.0
    assert g["ttft"]["requests"] == 4
    assert 0.0 < st["slot_occupancy_frac"] <= 1.0
    assert st["ledger"]["ring_capacity"] == 4


def test_ledger_off_disables_ring_not_goodput(np_params):
    eng = _engine(np_params, ledger=False)
    eng.generate(_rs_prompts(1, seed=41)[0], max_new_tokens=4,
                 timeout=120)
    eng.close()
    snap = eng.goodput_snapshot()
    st = eng.stats()
    assert eng.retired_ledgers() == []
    assert st["ledger"]["enabled"] is False
    assert snap["loop_wall_ms"] > 0
    assert snap["components"]["decode_compute"] > 0
    # the gauges read the decomposition too
    assert 0.0 < eng.registry.find("decode_goodput").get() <= 1.0
    assert eng.registry.find("decode_component_ms").get(
        component="decode_compute") > 0.0


def test_ledger_bounds_are_the_jax_engines():
    for name in ("_MAX_LEDGER_EVENTS", "_LEDGER_SAMPLE_EVERY",
                 "_SLOW_TTFT_MS", "_ALERT_TICK_TURNS"):
        assert getattr(tde, name) == getattr(jde, name)
    assert set(tde.DecodeRequest.__slots__) == \
        set(jde.DecodeRequest.__slots__)


def test_event_cap_bounds_a_long_generation(np_params, monkeypatch):
    monkeypatch.setattr(tde, "_MAX_LEDGER_EVENTS", 6)
    eng = _engine(np_params, eos_id=-1)
    eng.generate([5, 6, 7], max_new_tokens=12, timeout=120)
    eng.close()
    (led,) = eng.retired_ledgers()
    assert len(led["events"]) == 6 and led["tokens"] == 12


# ---- telemetry: spans, trace context, status, alert ticks

@pytest.mark.parametrize("mode", ["chunked", "whole"])
def test_request_spans_carry_trace_context(np_params, mode, tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tel = Telemetry(trace_path=path)
    eng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                       device="cpu", telemetry=tel, autostart=False,
                       **dict(BASE, prefill_mode=mode, num_blocks=14,
                              max_slots=3))
    assert eng.registry is tel.registry
    ctx = {"trace_id": "ab" * 16, "span_id": "fe:9"}
    prompts = _prompts()
    futs = [eng.submit(p, MAX_NEW, trace_context=ctx if i % 2 else None)
            for i, p in enumerate(prompts)]
    eng.start()
    res = [f.result(timeout=120) for f in futs]
    st = tel.status()
    eng.close()
    assert st["decode"]["requests_total"] == len(prompts)
    assert tel._slowest_ledgers(3)[0]["source"] == "decode"
    tel.close()
    spans = [r for r in read_trace(path) if r.get("type") == "span"]
    roots = [r for r in spans if r["name"] == "serving_request"]
    assert sorted(r["args"]["request_id"] for r in roots) == \
        sorted(r.request_id for r in res)
    for r in roots:
        with_ctx = r["args"]["request_id"] in {
            res[i].request_id for i in range(1, len(res), 2)}
        assert (r.get("trace_id") == ctx["trace_id"]) == with_ctx
        assert (r.get("remote_parent") == ctx["span_id"]) == with_ctx
        assert r["args"]["tokens"] >= 1 and "ttft_ms" in r["args"]
    sids = {r["sid"] for r in roots}
    pre = [r for r in spans if r["name"] == "decode_prefill"]
    assert len(pre) >= len(prompts) and all(r["parent"] in sids
                                            for r in pre)
    # preempted requests export their ledger as child spans
    preempted = {led["request_id"] for led in eng.retired_ledgers()
                 if led["preempts"]}
    assert preempted
    exported = {r["args"]["request_id"] for r in spans
                if r["name"].startswith("ttft_")
                or r["name"] == "decode_stream"}
    assert preempted <= exported


def test_span_names_match_the_jax_engines(np_params):
    """The request and prefill spans, one each per request and
    admission, as the JAX engine emits them; the ledger's child spans
    (exported for sampled, slow or preempted requests, so their count
    depends on timing) carry the same names."""
    ledger_spans = {"ttft_queue", "ttft_prefill_stall_behind",
                    "ttft_preempt_redo", "ttft_own_prefill",
                    "decode_stream"}

    def names(eng_cls, cfg, params, tel, **kw):
        eng = eng_cls(cfg, params, telemetry=tel, autostart=False,
                      **dict(BASE, num_blocks=14, max_slots=3), **kw)
        futs = [eng.submit(p, MAX_NEW) for p in _prompts()]
        eng.start()
        for f in futs:
            f.result(timeout=120)
        eng.close()
        out = [r["name"] for r in tel.tracer.records
               if r.get("type") == "span"]
        tel.close()
        assert set(out) - {"serving_request", "decode_prefill"} \
            <= ledger_spans
        return sorted(n for n in out if n not in ledger_spans)
    want = names(JaxEngine, JCFG, {k: jnp.asarray(v) for k, v in
                                   np_params.items()},
                 JTelemetry(trace_path=None, collect_hlo=False))
    got = names(DecodeEngine, TCFG, params_from_jax(np_params, "cpu"),
                Telemetry(trace_path=None), device="cpu")
    assert got == want and len(got) > 2 * len(_prompts())


def test_alert_tick_every_32_turns(np_params):
    tel = Telemetry(trace_path=None)
    eng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                       device="cpu", telemetry=tel,
                       **dict(BASE, eos_id=-1))
    eng.generate([3, 4, 5], max_new_tokens=40, timeout=120)
    eng.close()
    turns = eng.goodput_snapshot()["turns"]
    assert turns >= 32
    evals = tel.registry.find("alert_evaluations_total")
    assert evals is not None and evals.value == turns // 32
    tel.close()


def test_telemetry_argument_forms(np_params, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)             # True writes ./trace.jsonl
    eng = DecodeEngine(TCFG, device="cpu", telemetry=True,
                       autostart=False, **BASE)
    assert isinstance(eng.telemetry, Telemetry)
    eng.telemetry.close()
    eng.close()
    assert DecodeEngine(TCFG, device="cpu", telemetry=False,
                        autostart=False, **BASE).telemetry is None
    with pytest.raises(TypeError):
        DecodeEngine(TCFG, device="cpu", telemetry=object(),
                     autostart=False, **BASE)


def test_queue_full_closes_the_request_span(np_params):
    tel = Telemetry(trace_path=None)
    eng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                       device="cpu", telemetry=tel, max_queue=1,
                       autostart=False, **BASE)
    eng._started = True                     # hold the loop: queue only
    eng.submit([1, 2])
    with pytest.raises(tde.ServingOverloadError):
        eng.submit([1, 2])
    eng.close()
    (rej,) = [r for r in tel.tracer.records
              if r.get("args", {}).get("rejected")]
    assert rej["name"] == "serving_request"
    tel.close()


# ---- C6: options the JAX engine and wrappers take

@pytest.mark.parametrize("impl,device,ok", [
    ("auto", "cpu", True), ("reference", "cpu", True),
    ("kernel", "cpu", False), ("flash", "cpu", False),
    ("auto", "cuda", True), ("kernel", "cuda", True),
    ("reference", "cuda", False), ("xla", "cuda", False)])
def test_attn_impl_pairs_with_the_device(monkeypatch, impl, device, ok):
    """The device picks the attention: "auto" anywhere, "kernel" on the
    card, "reference" on the CPU; any other pairing is a ValueError.
    (The card is faked: params on the CPU then stop the constructor
    right after the check, with its own device error.)"""
    monkeypatch.setattr(tde, "resolve_device",
                        lambda d=None: torch.device(device))
    params = tdm.init_params(TCFG, 0, "cpu")
    if not ok:
        with pytest.raises(ValueError, match="attn_impl"):
            DecodeEngine(TCFG, params, attn_impl=impl, autostart=False)
    elif device == "cpu":
        eng = DecodeEngine(TCFG, params, attn_impl=impl, autostart=False)
        assert eng.attn_impl == eng.stats()["attn_impl"] == "reference"
        eng.close()
    else:
        with pytest.raises(ValueError, match="the engine on cuda"):
            DecodeEngine(TCFG, params, attn_impl=impl, autostart=False)


@pytest.mark.parametrize("what,item", [
    ("compile_count", "A6.7"), ("warm", "A11")])
def test_absent_members_name_their_item(what, item):
    if what == "compile_count":
        eng = DecodeEngine(TCFG, device="cpu", autostart=False)
        with pytest.raises(NotImplementedError, match=item):
            eng.compile_count
        eng.close()
    else:
        from paddle_tpu_torch import CPUPlace, Executor
        with pytest.raises(NotImplementedError, match=item):
            Executor(CPUPlace()).warm()


def _wrapper_calls():
    """Each kernel wrapper of the JAX package that takes ``interpret=``,
    on small CPU tensors."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import quant_matmul as qm
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g)
    kp, vp = r(6, 2, 4, 8), r(6, 2, 4, 8)
    tab = torch.arange(6, dtype=torch.int32).view(2, 3)
    wq, ws = qm.quantize_weight(r(16, 5))
    return {
        "paged_attention": lambda **k: pa.paged_attention(
            r(2, 2, 8), kp, vp, tab, torch.tensor([5, 9]), **k),
        "paged_attention_mixed": lambda **k: pa.paged_attention_mixed(
            r(3, 2, 8), kp, vp, tab, torch.tensor([0, 1, 1]),
            torch.tensor([3, 7, 8]), **k),
        "paged_attention_chunk": lambda **k: pa.paged_attention_chunk(
            r(2, 3, 2, 8), kp, vp, tab,
            torch.tensor([[1, 2, 3], [5, 6, 7]]), **k),
        "quant_matmul": lambda **k: qm.quant_matmul(r(4, 16), wq, ws, **k),
        "flash_attention": lambda **k: fa.flash_attention(
            r(1, 2, 5, 8), r(1, 2, 7, 8), r(1, 2, 7, 8), causal=True, **k),
    }


@pytest.mark.parametrize("name", ["paged_attention",
                                  "paged_attention_mixed",
                                  "paged_attention_chunk", "quant_matmul",
                                  "flash_attention"])
def test_wrappers_take_interpret(monkeypatch, name):
    """``interpret=True`` on CPU tensors is the plain version (the same
    numbers as without it); each wrapper asks ``check_interpret``,
    which refuses a CUDA tensor."""
    torch.manual_seed(0)
    plain = _wrapper_calls()[name]()
    torch.manual_seed(0)
    assert torch.equal(_wrapper_calls()[name](interpret=True), plain)
    seen = []
    monkeypatch.setattr(kernels, "check_interpret",
                        lambda i, t, w: seen.append((i, w)))
    _wrapper_calls()[name](interpret=True)
    assert seen == [(True, name)]


def test_check_interpret_refuses_a_cuda_tensor():
    cuda_like = type("T", (), {"device": torch.device("cuda", 0)})()
    for interpret in (None, False):
        kernels.check_interpret(interpret, cuda_like, "w")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.check_interpret(True, cuda_like, "w")
    kernels.check_interpret(True, torch.ones(1), "w")


@pytest.mark.parametrize("tiles,ok", [
    ((128, 128), True), ((16, 64), True), ((np.int64(32), 1), True),
    ((0, 128), False), ((128, -8), False), ((1.5, 128), False),
    ((True, 128), False)])
def test_flash_attention_tile_sizes_change_nothing(tiles, ok):
    from paddle_tpu_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 6, 8, generator=g) for _ in range(3))
    want = fa.flash_attention(q, k, v, causal=True)
    if not ok:
        with pytest.raises(ValueError, match="positive int"):
            fa.flash_attention(q, k, v, causal=True, block_q=tiles[0],
                               block_k=tiles[1])
        return
    got = fa.flash_attention(q, k, v, causal=True, block_q=tiles[0],
                             block_k=tiles[1])
    assert torch.equal(got, want)
