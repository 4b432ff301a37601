"""The port's copy-on-write beams held against its dense oracle and the
JAX engine.

``generate_beam`` on the paged pool (the K beams share the prompt's
blocks by refcount and copy a block on first write) must give the
sequences and lengths of the port's ``impl="dense"`` lane (dense caches
regathered by value) and of the JAX engine's paged lane, with scores
within 1e-5: for K 1 (= greedy), 2 and 4, with and without a length
penalty, with EOS firing, in whole mode (prefix by the rung prefill)
and chunked mode (prefix through the mixed step), with a prefix-cache
hit, on int8, fp8 and bf16 pools (whose copies carry the stored
per-block scale rows; against the dense lane within the pool's
quantization noise), and while the decode loop serves greedy requests. Pools
end leak-free and consistent after every call. The params are scaled
as in ``test_torch_decode_engine.py`` so that no near-tie decides a
beam across frameworks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import DecodeEngine as JaxEngine
from paddle_tpu.serving import decode_model as jdm
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.serving import DecodeEngine
from paddle_tpu_torch.serving import decode_model as tdm

JCFG = jdm.DecoderConfig(vocab_size=64, d_model=32, n_heads=2,
                         head_dim=16, n_layers=2, d_ff=64, max_seq_len=64)
TCFG = tdm.DecoderConfig(**JCFG.__dict__)
SCORE_TOL = 1e-5
KW = dict(block_size=4, num_blocks=96, max_slots=4, prompt_rungs=(8, 16))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny models: one intra-op thread a test worker."""
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


def _prompts(n, seed, lo=2, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, rng.integers(lo, hi)).tolist()
            for _ in range(n)]


def _engines(np_params, **kw):
    """A port engine and a JAX engine over the same params, neither
    serving (the beam lane is synchronous)."""
    jkw, tkw = dict(KW, **kw), dict(KW, **kw)
    if "kv_config" in kw:                # (block_size, num_blocks, dtype)
        jkw["kv_config"] = JCFG.kv_config(*kw["kv_config"])
        tkw["kv_config"] = TCFG.kv_config(*kw["kv_config"])
    teng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                        device="cpu", autostart=False, **tkw)
    jeng = JaxEngine(JCFG, {k: jnp.asarray(v) for k, v in
                            np_params.items()}, autostart=False, **jkw)
    return teng, jeng


def _same(a, b, tol=SCORE_TOL):
    np.testing.assert_array_equal(a.sequences, b.sequences)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_allclose(a.scores, b.scores, rtol=0, atol=tol)


def _leak_free(eng):
    eng.pool.assert_consistent()
    assert eng.pool.check_leaks() == [] and eng.pool.blocks_in_use == 0


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_paged_equals_dense_and_jax(np_params, mode, K):
    """No length penalty and the GNMT one (0.6), on one pair of engines
    (the penalty is host work: no JAX entry compiles twice)."""
    teng, jeng = _engines(np_params, eos_id=-1, prefill_mode=mode,
                          chunk_size=3)
    for p, penalty in [(p, a) for p in _prompts(2, seed=31)
                       for a in (0.0, 0.6)]:
        kw = dict(beam_size=K, max_new_tokens=7, length_penalty=penalty)
        paged = teng.generate_beam(p, **kw)
        assert paged.sequences.shape == (1, K, 7)
        assert all(isinstance(x, np.ndarray) for x in paged)
        _same(paged, teng.generate_beam(p, impl="dense", **kw))
        _same(paged, jeng.generate_beam(p, **kw))
        _leak_free(teng)
        scores = paged.scores[0]
        assert all(scores[i] >= scores[i + 1] for i in range(K - 1))
    # the beams forked and wrote into shared blocks: copies happened
    assert (teng.cow_copies > 0) == (K > 1)
    teng.close()
    jeng.close()


@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_beam_k1_equals_greedy(np_params, mode):
    """K = 1 walks the greedy path: the engine's own greedy tokens."""
    teng, jeng = _engines(np_params, eos_id=-1, prefill_mode=mode)
    jeng.close()
    for p in _prompts(3, seed=8, lo=2, hi=9):
        beam = teng.generate_beam(p, beam_size=1, max_new_tokens=6)
        greedy = teng.generate(p, 6, timeout=60).tokens.tolist()
        assert beam.sequences[0, 0].tolist() == greedy
    assert teng.cow_copies == 0
    teng.close()
    _leak_free(teng)


@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_beam_with_eos(np_params, mode):
    """An EOS that fires inside the beams: finished beams freeze, the
    sequences pad with EOS past their lengths, as in the dense lane and
    the JAX engine."""
    p = _prompts(1, seed=33, lo=5, hi=9)[0]
    free, _ = _engines(np_params, eos_id=-1, prefill_mode=mode)
    first = free.generate_beam(p, beam_size=3, max_new_tokens=8)
    free.close()
    eos = int(first.sequences[0, 1, 2])        # beam 1's third token
    teng, jeng = _engines(np_params, eos_id=eos, prefill_mode=mode)
    paged = teng.generate_beam(p, beam_size=3, max_new_tokens=8)
    _same(paged, teng.generate_beam(p, beam_size=3, max_new_tokens=8,
                                    impl="dense"))
    _same(paged, jeng.generate_beam(p, beam_size=3, max_new_tokens=8))
    assert (paged.lengths < 8).any()
    for seq, n in zip(paged.sequences[0], paged.lengths[0]):
        assert (seq[n:] == eos).all()
    teng.close()
    jeng.close()
    _leak_free(teng)


@pytest.mark.parametrize("mode", ["whole", "chunked"])
def test_beam_prefix_cache_hit(np_params, mode):
    """Two beam calls over prompts behind a shared 12-token prefix: the
    second reacquires the first's published blocks, and both equal the
    dense lane; a greedy request served afterwards hits them too."""
    rng = np.random.default_rng(40)
    prefix = rng.integers(1, 64, 12).tolist()
    prompts = [prefix + rng.integers(1, 64, 3).tolist() for _ in range(2)]
    teng, jeng = _engines(np_params, eos_id=0, prefill_mode=mode,
                          chunk_size=5)
    for i, p in enumerate(prompts):
        paged = teng.generate_beam(p, beam_size=4, max_new_tokens=6)
        _same(paged, teng.generate_beam(p, beam_size=4, max_new_tokens=6,
                                        impl="dense"))
        _same(paged, jeng.generate_beam(p, beam_size=4, max_new_tokens=6))
        hits = teng.stats()["prefix"]["hit_tokens"]
        assert hits == (0 if i == 0 else 12)
        assert jeng.stats()["prefix"]["hit_tokens"] == hits
    teng.generate(prefix + [5, 6], 3, timeout=60)
    assert teng.stats()["prefix"]["hit_tokens"] == 24
    teng.close()
    jeng.close()
    _leak_free(teng)


# A 1-byte or bf16 pool moves the beam scores off the fp32 dense
# oracle's by its quantization noise (at these scaled weights up to 0.21
# summed over 7 int8 steps, 0.16 fp8, 0.01 bf16), enough to reorder the
# lower beams of an int8 / fp8 pool; the best beam stays the oracle's.
# The JAX engine on the same pool dtype is held exactly.
QUANT_DENSE = {"int8": (0.3, 1), "fp8-e4m3": (0.3, 1), "bfloat16": (0.02, 4)}


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8-e4m3", "bfloat16"])
def test_cow_on_a_quantized_pool(np_params, kv_dtype, monkeypatch):
    """CoW on a 1-byte pool copies the payload AND the block's stored
    scale row (a bf16 pool has none); the beams equal the JAX engine's
    on the same pool dtype and calibration probe, and lie within the
    pool's quantization noise of the dense lane (``QUANT_DENSE``: the
    leading beams equal, a beam both lanes found within the score
    tolerance)."""
    teng, jeng = _engines(np_params, eos_id=-1, prefill_mode="chunked",
                          kv_config=(4, 96, kv_dtype))
    quant = teng.kv.quantized
    copies = []
    real = teng._cow_copy

    def checked_copy(src, dst):
        real(src, dst)
        for pool in (teng._k_pool, teng._v_pool):
            payload = pool[0].view(torch.uint8) if quant else pool
            for s, d in zip(src, dst):
                assert torch.equal(payload[:, d], payload[:, s])
                if quant:
                    assert torch.equal(pool[1][:, d], pool[1][:, s])
                    assert pool[1][:, d].any()   # a written block's row
        copies.append(int(np.sum(np.asarray(src) != np.asarray(dst))))

    monkeypatch.setattr(teng, "_cow_copy", checked_copy)
    tol, lead = QUANT_DENSE[kv_dtype]
    for p in _prompts(2, seed=35, lo=6, hi=11):
        paged = teng.generate_beam(p, beam_size=4, max_new_tokens=7)
        _same(paged, jeng.generate_beam(p, beam_size=4, max_new_tokens=7))
        dense = teng.generate_beam(p, beam_size=4, max_new_tokens=7,
                                   impl="dense")
        np.testing.assert_array_equal(paged.sequences[:, :lead],
                                      dense.sequences[:, :lead])
        same = (paged.sequences == dense.sequences).all(axis=-1)
        np.testing.assert_allclose(paged.scores[same], dense.scores[same],
                                   atol=tol)
        _leak_free(teng)
    assert sum(copies) == teng.cow_copies > 0
    teng.close()
    jeng.close()


def test_cow_copy_moves_only_the_named_blocks(np_params):
    """The copy writes ``dst`` blocks of every layer with ``src``'s
    payload (and scales) and leaves every other block as it was;
    identity rows rewrite a block with itself."""
    eng = DecodeEngine(TCFG, params_from_jax(np_params, "cpu"),
                       device="cpu", block_size=4, num_blocks=8,
                       kv_config=TCFG.kv_config(4, 8, "int8"),
                       autostart=False)
    g = torch.Generator().manual_seed(0)
    for pool in (eng._k_pool, eng._v_pool):
        pool[0].copy_(torch.randint(-127, 128, pool[0].shape, generator=g,
                                    dtype=torch.int8))
        pool[1].copy_(torch.rand(pool[1].shape, generator=g))
    before = [(p[0].clone(), p[1].clone()) for p in (eng._k_pool,
                                                     eng._v_pool)]
    eng._cow_copy(np.array([1, 4, 6]), np.array([3, 4, 0]))
    eng.close()
    for (pay, sc), pool in zip(before, (eng._k_pool, eng._v_pool)):
        want_pay, want_sc = pay.clone(), sc.clone()
        want_pay[:, [3, 0]] = pay[:, [1, 6]]
        want_sc[:, [3, 0]] = sc[:, [1, 6]]
        assert torch.equal(pool[0], want_pay)
        assert torch.equal(pool[1], want_sc)


def test_beam_while_serving(np_params):
    """A beam call while the loop serves greedy requests: both are
    serialised on the device lock, and each gets its own answer."""
    kw = dict(KW, eos_id=-1)
    tp = params_from_jax(np_params, "cpu")
    prompts = _prompts(6, seed=41)
    alone = DecodeEngine(TCFG, tp, device="cpu", **kw)
    want = [alone.generate(p, 8, timeout=60).tokens.tolist()
            for p in prompts]
    want_beam = alone.generate_beam(prompts[0], beam_size=3,
                                    max_new_tokens=6)
    alone.close()
    eng = DecodeEngine(TCFG, tp, device="cpu", **kw)
    futs = [eng.submit(p, 8) for p in prompts]
    got_beam = eng.generate_beam(prompts[0], beam_size=3, max_new_tokens=6)
    got = [f.result(timeout=60).tokens.tolist() for f in futs]
    eng.close()
    assert got == want
    _same(got_beam, want_beam)
    _leak_free(eng)


def test_dense_step_fn_matches_jax(np_params):
    """``make_dense_beam_step_fn`` against the JAX one on the same state:
    log-probs and both caches within 1e-5, lengths advanced."""
    rng = np.random.default_rng(2)
    R, L, H, T, d = 3, JCFG.n_layers, JCFG.n_heads, JCFG.max_seq_len, \
        JCFG.head_dim
    kc = rng.standard_normal((R, L, H, T, d)).astype(np.float32)
    vc = rng.standard_normal((R, L, H, T, d)).astype(np.float32)
    lens = np.array([0, 5, 63], np.int32)
    toks = np.array([3, 17, 60], np.int32)
    jfn = jdm.make_dense_beam_step_fn(
        JCFG, {k: jnp.asarray(v) for k, v in np_params.items()})
    jlp, (jk, jv, jl) = jfn((jnp.asarray(kc), jnp.asarray(vc),
                             jnp.asarray(lens)), jnp.asarray(toks))
    tfn = tdm.make_dense_beam_step_fn(TCFG, params_from_jax(np_params,
                                                            "cpu"))
    state = (torch.from_numpy(kc), torch.from_numpy(vc),
             torch.from_numpy(lens))
    tlp, (tk, tv, tl) = tfn(state, torch.from_numpy(toks))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    assert tl.tolist() == np.asarray(jl).tolist() == [1, 6, 64]
    assert torch.equal(state[0], torch.from_numpy(kc))   # by value


@pytest.mark.parametrize("call,match", [
    (dict(prompt=[1, 2], impl="nope"), "impl"),
    (dict(prompt=[]), "empty prompt"),
    (dict(prompt=[1, 2], beam_size=65), "vocab_size"),
    (dict(prompt=list(range(1, 30)), max_new_tokens=40), "max_context"),
])
def test_beam_guards_raise_as_jax(np_params, call, match):
    teng, jeng = _engines(np_params, max_context=64)
    call = dict(call)
    prompt = call.pop("prompt")
    for eng in (teng, jeng):
        with pytest.raises(ValueError, match=match):
            eng.generate_beam(prompt, **call)
        eng.close()
    _leak_free(teng)
