"""The port's speculative decoding and CoW beams on the card (no JAX in
this file: the card's machine has none; ``test_torch_decode_spec.py``
and ``test_torch_decode_beam.py`` hold these paths against the JAX
engine on the CPU).

The same engine, at the CPU tests' small widths (vocab 64, d_model 32, 2
layers; a 1-layer draft), runs once with the kernels on the card and
once with their plain versions on the CPU, from the same numpy-seeded
params (the projections scaled so that greedy steps are no near-ties):

- speculative greedy, chunked and whole mode, γ 3, fp32 and int8 KV +
  int8 weights: the card's tokens equal the CPU's, and the card's
  launch counts are exact (the draft's γ decode steps on B3/B4, one
  verify chunk a round on B5/B6, the mixed step writing both models'
  pools in chunked mode, B7 four times a layer a target call);
- paged beams, whole mode fp32 and chunked mode on an int8 pool (the
  copy-on-write with its scale rows): sequences and lengths equal to the
  CPU's, scores within 1e-4; B3/B4 launched layers x max_new times a
  call; the dense lane on the card equal to the paged one.

Every case needs a card and skips without one (``cuda`` marker).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.serving import DecodeEngine
from paddle_tpu_torch.serving import decode_model as tdm

CFG = tdm.DecoderConfig(vocab_size=64, d_model=32, n_heads=2, head_dim=16,
                        n_layers=2, d_ff=64, max_seq_len=64)
DRAFT = tdm.DecoderConfig(vocab_size=64, d_model=32, n_heads=2,
                          head_dim=16, n_layers=1, d_ff=32, max_seq_len=64)
SCORE_TOL = 1e-4


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


def _serve(dev, kw, prompts):
    tp, dp = _params(CFG, 11, 15.0), _params(DRAFT, 7, 1.0)
    eng = DecodeEngine(CFG, {k: v.to(dev) for k, v in tp.items()},
                       draft_params={k: v.to(dev) for k, v in dp.items()},
                       device=dev, draft_cfg=DRAFT, **kw)
    eng.warmup()
    tk.reset_launches()
    futs = [eng.submit(p, 12) for p in prompts]
    toks = [f.result(timeout=300).tokens.tolist() for f in futs]
    launches = dict(tk.LAUNCHES)
    st = eng.stats()
    eng.close()
    eng.pool.assert_consistent()
    assert eng.pool.check_leaks() == [] and eng.pool.blocks_in_use == 0
    return toks, launches, st


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,w_dtype", [("float32", None),
                                              ("int8", "int8")])
@pytest.mark.parametrize("mode", ["chunked", "whole"])
def test_spec_on_card_equals_cpu(cuda_device, mode, kv_dtype, w_dtype):
    kw = dict(kv_config=CFG.kv_config(4, 96, kv_dtype), max_slots=4,
              eos_id=0, prefill_mode=mode, speculate_k=3,
              quant_plan=w_dtype)
    prompts = _prompts()
    want, _, cst = _serve("cpu", kw, prompts)
    got, launches, st = _serve(cuda_device, kw, prompts)
    assert got == want
    assert st["speculation"] == cst["speculation"]
    L, Ld, gamma = CFG.n_layers, DRAFT.n_layers, 3
    rounds = st["speculation"]["verify_steps"]
    other = st["steps_total"] - rounds      # chunked: mixed steps
    q = "_quant" if kv_dtype == "int8" else ""
    want_l = dict.fromkeys(tk.LAUNCHES, 0)
    want_l["paged_attention" + q] = Ld * gamma * rounds
    if mode == "chunked":
        want_l["paged_attention_mixed" + q] = (L + Ld) * other
        want_l["paged_attention_chunk" + q] = L * rounds
        dense = other + rounds
    else:
        prefills = st["prefills_total"]
        want_l["paged_attention_chunk" + q] = L * rounds + \
            (L + Ld) * prefills
        dense = rounds + prefills
    if w_dtype:
        want_l["quant_matmul"] = 4 * L * dense
    assert launches == want_l


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kv_dtype", [("whole", "float32"),
                                           ("chunked", "int8")])
def test_beams_on_card_equal_cpu(cuda_device, mode, kv_dtype):
    prompts = [p for p in _prompts() if len(p) >= 4][:2]
    out = {}
    for dev in ("cpu", cuda_device):
        tp = _params(CFG, 11, 15.0)
        eng = DecodeEngine(CFG, {k: v.to(dev) for k, v in tp.items()},
                           device=dev, kv_config=CFG.kv_config(4, 96,
                                                               kv_dtype),
                           eos_id=-1, prefill_mode=mode,
                           prompt_rungs=(8, 16, 32), autostart=False)
        res = []
        for p in prompts:
            tk.reset_launches()
            res.append(eng.generate_beam(p, beam_size=4, max_new_tokens=8))
            if dev != "cpu":
                q = "_quant" if kv_dtype == "int8" else ""
                assert tk.LAUNCHES["paged_attention" + q] == \
                    CFG.n_layers * 8
            dense = eng.generate_beam(p, beam_size=4, max_new_tokens=8,
                                      impl="dense")
            if kv_dtype == "float32":
                np.testing.assert_array_equal(res[-1].sequences,
                                              dense.sequences)
                np.testing.assert_allclose(res[-1].scores, dense.scores,
                                           atol=SCORE_TOL)
        assert eng.cow_copies > 0
        eng.close()
        eng.pool.assert_consistent()
        assert eng.pool.check_leaks() == [] and eng.pool.blocks_in_use == 0
        out[str(dev)] = res
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        np.testing.assert_array_equal(a.sequences, b.sequences)
        np.testing.assert_array_equal(a.lengths, b.lengths)
        np.testing.assert_allclose(a.scores, b.scores, atol=SCORE_TOL)
