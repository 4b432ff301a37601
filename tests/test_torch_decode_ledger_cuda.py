"""The port's DecodeEngine with telemetry and the lifecycle ledger on the
card (no JAX in this file: the card's machine has none;
``test_torch_decode_ledger.py`` holds these paths against the JAX
engine on the CPU).

The same engine, at the CPU tests' small widths, with a ``Telemetry``
session and the ledger on, serves the same prompts twice from the same
numpy-seeded params (the projections scaled so that greedy steps are no
near-ties): once with the kernels on the card, once with their plain
versions on the CPU, every request submitted before the loop starts.
The tokens and each request's ledger events without their time fields
are equal, in chunked and whole mode, fp32 and int8 KV + int8 weights,
with speculation (γ 3) and in a pool tight enough to preempt; the
card's run launches its kernels (``kernels.LAUNCHES``), its TTFTs
decompose exactly and its components reconcile the loop wall within
10%. Then an int8 beam call: the same sequences and ``cow`` events.

Every case needs a card and skips without one (``cuda`` marker).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.obs import Telemetry
from paddle_tpu_torch.serving import DecodeEngine
from paddle_tpu_torch.serving import decode_model as tdm

CFG = tdm.DecoderConfig(vocab_size=64, d_model=32, n_heads=2, head_dim=16,
                        n_layers=2, d_ff=64, max_seq_len=64)
DRAFT = tdm.DecoderConfig(vocab_size=64, d_model=32, n_heads=2,
                          head_dim=16, n_layers=1, d_ff=32, max_seq_len=64)
BASE = dict(block_size=4, max_slots=4, eos_id=0, prompt_rungs=(8, 16, 32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paged-attention and quantized "
                    "matmul kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _params(cfg, seed, scale):
    p = tdm.init_params(cfg, seed, "cpu")
    return {k: (v * scale if k == "embed" or k.endswith(
        ("wqkv", "wo", "w1", "w2")) else v) for k, v in p.items()}


def _prompts():
    rng = np.random.default_rng(1)
    prefix = rng.integers(1, 64, 9).tolist()
    out = [rng.integers(1, 64, rng.integers(1, 20)).tolist()
           for _ in range(6)]
    return out + [prefix + rng.integers(1, 64, rng.integers(1, 8)).tolist()
                  for _ in range(4)]


def _strip(event):
    kind = event[0]
    if kind in ("submit", "first_token", "finish", "preempt"):
        return (kind,)
    if kind == "prefill":
        return (kind, event[3])
    if kind in ("chunk", "cow"):
        return (kind, event[2])
    return (kind,) + tuple(event[2:])


def _kw(kw):
    kw = dict(BASE, **kw)
    if "kv_dtype" in kw:
        kw["kv_config"] = CFG.kv_config(4, kw.pop("num_blocks", 96),
                                        kw.pop("kv_dtype"))
    else:
        kw.setdefault("num_blocks", 96)
    return kw


def _serve(dev, kw, spec):
    tel = Telemetry(trace_path=None)
    extra = {}
    if spec:
        dp = _params(DRAFT, 7, 1.0)
        extra = dict(draft_cfg=DRAFT, speculate_k=3,
                     draft_params={k: v.to(dev) for k, v in dp.items()})
    eng = DecodeEngine(CFG, {k: v.to(dev) for k, v in
                             _params(CFG, 11, 15.0).items()},
                       device=dev, telemetry=tel, autostart=False,
                       **extra, **_kw(kw))
    tk.reset_launches()
    futs = [eng.submit(p, 12) for p in _prompts()]
    eng.start()
    res = [f.result(timeout=300) for f in futs]
    launches = dict(tk.LAUNCHES)
    eng.close()
    eng.pool.assert_consistent()
    assert eng.pool.check_leaks() == [] and eng.pool.blocks_in_use == 0
    by_id = {led["request_id"]: led for led in eng.retired_ledgers()}
    events = [[_strip(e) for e in by_id[r.request_id]["events"]]
              for r in res]
    for led in by_id.values():
        assert sum(led["ttft_parts"].values()) == pytest.approx(
            led["ttft_ms"], abs=1e-3)
    snap = eng.goodput_snapshot()
    assert abs(sum(snap["components"].values()) / snap["loop_wall_ms"]
               - 1.0) <= 0.10
    spans = [r for r in tel.tracer.records
             if r.get("name") == "serving_request"]
    assert len(spans) == len(res)
    tel.close()
    return [r.tokens.tolist() for r in res], events, launches, eng


@pytest.mark.cuda
@pytest.mark.parametrize("kw,spec", [
    ({}, False),
    (dict(prefill_mode="whole"), False),
    (dict(kv_dtype="int8", quant_plan="int8"), False),
    (dict(num_blocks=14, max_slots=3), False),
    (dict(prefill_mode="whole", num_blocks=14, max_slots=3), True),
    ({}, True)])
def test_ledger_on_the_card_equals_the_cpu(cuda_device, kw, spec):
    got, gev, launches, eng = _serve(cuda_device, kw, spec)
    want, wev, cpu_launches, _ = _serve(torch.device("cpu"), kw, spec)
    assert got == want
    assert gev == wev
    assert sum(launches.values()) > 0 and sum(cpu_launches.values()) == 0
    if "num_blocks" in kw:
        assert eng.stats()["preempted_total"] > 0
    if spec:
        assert sum(e[2] for ev in gev for e in ev if e[0] == "spec") \
            == eng._spec_accepted


@pytest.mark.cuda
def test_int8_beam_mini_ledger_on_the_card(cuda_device):
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        eng = DecodeEngine(CFG, {k: v.to(dev) for k, v in
                                 _params(CFG, 11, 15.0).items()},
                           device=dev, autostart=False,
                           **_kw(dict(kv_dtype="int8", eos_id=-1)))
        res = eng.generate_beam(list(range(3, 14)), beam_size=4,
                                max_new_tokens=9)
        (led,) = eng.retired_ledgers()
        assert sum(e[2] for e in led["events"] if e[0] == "cow") \
            == eng.cow_copies > 0
        assert eng.goodput_snapshot()["components"]["cow_copy"] > 0.0
        eng.close()
        out.append((res.sequences.tolist(), res.lengths.tolist(),
                    [_strip(e) for e in led["events"]]))
    assert out[0] == out[1]
