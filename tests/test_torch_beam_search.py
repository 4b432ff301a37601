"""The port's beam search and greedy search, held against the JAX package.

Most cases score with the seeded Markov chain of ``tests/test_decode.py``
(log-probs depend only on the previous token). Both sides then add the
same fp32 numbers in the same order, so the searches are compared
exactly: equal sequences and lengths, scores atol 1e-6. The committed
golden file ``tests/fixtures/beam_golden.json`` is read, not written:
exact sequences and lengths, scores atol 1e-4. Ties break toward the
lower index (``jax.lax.top_k``); a chain with exact ties pins it. The
``score_hook`` cases of ``tests/test_decode.py`` run on the port's
seq2seq ``generate`` with the JAX toy config's params. The no-sync
search on the card needs a card and skips without one.
"""
import itertools
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch import decode as td
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import seq2seq as ts

EXACT = 1e-6
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def jd():
    pytest.importorskip("jax")
    from paddle_tpu import decode
    return decode


def _trans(seed, V):
    """A Markov chain's log-probs, [V, V] fp32 (tests/test_decode.py)."""
    rng = np.random.RandomState(seed)
    t = rng.randn(V, V).astype(np.float32)
    return (t - np.log(np.exp(t).sum(1, keepdims=True))).astype(np.float32)


def _torch_step(trans):
    tt = torch.from_numpy(trans)

    def step_fn(state, tokens):
        return tt[tokens.long()], state
    return step_fn


def _jax_step(trans):
    import jax.numpy as jnp
    jt = jnp.asarray(trans)

    def step_fn(state, tokens):
        return jt[tokens], state
    return step_fn


def _port_beam(trans, **kw):
    return td.beam_search(_torch_step(trans), {}, device="cpu", **kw)


def _assert_same(res, jres, atol=EXACT):
    np.testing.assert_array_equal(res.sequences.numpy(),
                                  np.asarray(jres.sequences))
    np.testing.assert_array_equal(res.lengths.numpy(),
                                  np.asarray(jres.lengths))
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(jres.scores),
                               atol=atol, rtol=0)


CASES = [  # (seed, V, T, B, K, length_penalty)
    (0, 5, 4, 1, 5, 0.0),
    (1, 6, 5, 3, 4, 0.0),
    (7, 12, 9, 2, 3, 0.0),
    (42, 12, 10, 3, 4, 0.0),
    (3, 10, 8, 2, 4, 0.6),
    (5, 8, 6, 4, 2, 1.0),
]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"s{c[0]}-V{c[1]}-K{c[4]}-lp{c[5]}"
                              for c in CASES])
def test_beam_search_matches_jax_on_a_markov_chain(jd, case):
    seed, V, T, B, K, lp = case
    trans = _trans(seed, V)
    kw = dict(batch_size=B, beam_size=K, max_len=T, bos_id=0, eos_id=1,
              vocab_size=V, length_penalty=lp)
    res = _port_beam(trans, **kw)
    _assert_same(res, jd.beam_search(_jax_step(trans), {}, **kw))
    assert res.sequences.dtype == res.lengths.dtype == torch.int32
    assert res.scores.dtype == torch.float32


def test_beam_search_finds_the_brute_force_optimum():
    """tests/test_decode.py's exactness case: beam == V on a Markov
    scorer; every beam's score re-scores its tokens; admissible."""
    V, bos, eos, T = 5, 0, 1, 4
    trans = _trans(0, V)
    res = _port_beam(trans, batch_size=1, beam_size=V, max_len=T,
                     bos_id=bos, eos_id=eos, vocab_size=V)
    best, best_score = None, -np.inf
    for L in range(1, T + 1):
        for seq in itertools.product(range(V), repeat=L):
            if eos in seq[:-1] or (L < T and seq[-1] != eos):
                continue
            prev, score = bos, 0.0
            for t in seq:
                score += trans[prev, t]
                prev = t
            if score > best_score:
                best, best_score = seq, score
    for k in range(V):
        got = res.sequences[0, k, :int(res.lengths[0, k])].tolist()
        prev, score = bos, 0.0
        for t in got:
            score += trans[prev, t]
            prev = t
        np.testing.assert_allclose(float(res.scores[0, k]), score, rtol=1e-5)
        assert float(res.scores[0, k]) <= best_score + 1e-5
    assert res.sequences[0, 0, :int(res.lengths[0, 0])].tolist() == list(best)


def test_golden_file():
    with open(os.path.join(HERE, "fixtures", "beam_golden.json")) as f:
        golden = json.load(f)
    trans = _trans(golden["transition_seed"], golden["vocab"])
    res = _port_beam(trans, batch_size=golden["batch"],
                     beam_size=golden["beam"], max_len=golden["max_len"],
                     bos_id=golden["bos"], eos_id=golden["eos"],
                     vocab_size=golden["vocab"])
    np.testing.assert_array_equal(res.sequences.numpy(),
                                  np.asarray(golden["sequences"]))
    np.testing.assert_array_equal(res.lengths.numpy(),
                                  np.asarray(golden["lengths"]))
    np.testing.assert_allclose(res.scores.numpy(),
                               np.asarray(golden["scores"]), atol=1e-4)


def test_scores_sorted_and_finished_beams_frozen():
    V, T, B, K = 6, 5, 3, 4
    res = _port_beam(_trans(1, V), batch_size=B, beam_size=K, max_len=T,
                     bos_id=0, eos_id=1, vocab_size=V)
    s = res.scores.numpy()
    assert (np.diff(s, axis=1) <= 1e-6).all()
    seqs, lens = res.sequences.numpy(), res.lengths.numpy()
    for b in range(B):
        for k in range(K):
            L = lens[b, k]
            assert (seqs[b, k, L:] == 1).all()
            assert 1 not in seqs[b, k, :L - 1]


def test_greedy_equals_beam1_and_jax_greedy(jd):
    V, T, B = 5, 6, 2
    trans = _trans(2, V)
    seq, lens = td.greedy_search(_torch_step(trans), {}, batch_size=B,
                                 max_len=T, bos_id=0, eos_id=1,
                                 device="cpu")
    res = _port_beam(trans, batch_size=B, beam_size=1, max_len=T, bos_id=0,
                     eos_id=1, vocab_size=V)
    assert torch.equal(seq, res.sequences[:, 0])
    j_seq, j_len = jd.greedy_search(_jax_step(trans), {}, batch_size=B,
                                    max_len=T, bos_id=0, eos_id=1)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(j_seq))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(j_len))


def test_ties_go_to_the_lower_index(jd):
    """Every row uniform: all continuations tie exactly, at every step.
    The lower beam, then the lower token, wins: every step keeps beam 0's
    tokens 0, 1, 2, so the beams are (0, 0, k); the same in JAX."""
    V, K, T = 6, 3, 3
    trans = np.full((V, V), -np.log(V), np.float32)
    kw = dict(batch_size=2, beam_size=K, max_len=T, bos_id=0, eos_id=5,
              vocab_size=V)
    res = _port_beam(trans, **kw)
    assert res.sequences[0].tolist() == [[0, 0, 0], [0, 0, 1], [0, 0, 2]]
    _assert_same(res, jd.beam_search(_jax_step(trans), {}, **kw))
    # with a penalty the equal-length beams keep their order (stable)
    res = _port_beam(trans, length_penalty=0.7, **kw)
    _assert_same(res, jd.beam_search(_jax_step(trans), {},
                                     length_penalty=0.7, **kw))


def test_state_is_regathered_by_parent(jd):
    """The scores depend on a state leaf (how often token 3 was fed in),
    so the search agrees with JAX only if each step re-gathers the state
    by parent beam."""
    V, T, B, K = 7, 6, 2, 3
    trans = _trans(11, V)
    tt = torch.from_numpy(trans)

    def t_step(state, tokens):
        n3 = state["n3"] + (tokens == 3).float()[:, None]
        return tt[tokens.long()] - 0.7 * n3, {"n3": n3}

    def j_step(state, tokens):
        import jax.numpy as jnp
        n3 = state["n3"] + (tokens == 3).astype(jnp.float32)[:, None]
        return jnp.asarray(trans)[tokens] - 0.7 * n3, {"n3": n3}

    kw = dict(batch_size=B, beam_size=K, max_len=T, bos_id=0, eos_id=1,
              vocab_size=V)
    res = td.beam_search(t_step, {"n3": torch.zeros((B * K, 1))}, **kw)
    import jax.numpy as jnp
    _assert_same(res, jd.beam_search(
        j_step, {"n3": jnp.zeros((B * K, 1), jnp.float32)}, **kw))


def test_beam_larger_than_vocab_raises():
    with pytest.raises(ValueError, match="beam_size"):
        _port_beam(_trans(0, 3), batch_size=1, beam_size=4, max_len=2,
                   bos_id=0, eos_id=1, vocab_size=3)


def test_markov_hook_matches_jax(jd):
    """A hook that bans a token and adds a step-dependent bonus, written
    once per framework: the same search."""
    V, T, B, K = 9, 7, 2, 3
    trans = _trans(13, V)

    def t_hook(t, lp, state):
        lp = lp.clone()
        lp[..., 4] = -1e9
        return lp + 0.25 * t * (torch.arange(V) == 6)

    def j_hook(t, lp, state):
        import jax.numpy as jnp
        return lp.at[..., 4].set(-1e9) + 0.25 * t * (jnp.arange(V) == 6)

    kw = dict(batch_size=B, beam_size=K, max_len=T, bos_id=0, eos_id=1,
              vocab_size=V)
    res = td.beam_search(_torch_step(trans), {}, device="cpu",
                         score_hook=t_hook, **kw)
    _assert_same(res, jd.beam_search(_jax_step(trans), {},
                                     score_hook=j_hook, **kw))
    assert (res.sequences != 4).all()


# -------------------------------------------- score hooks (test_decode.py)

@pytest.fixture(scope="module")
def toy():
    """tests/test_decode.py TestScoreHook's toy seq2seq, params from JAX."""
    pytest.importorskip("jax")
    import jax
    from paddle_tpu.models import seq2seq as js
    kw = dict(src_vocab=16, tgt_vocab=16, emb_dim=8, hidden_dim=12,
              beam_size=3, max_gen_len=6)
    params = js.init_params(jax.random.PRNGKey(7), js.Seq2SeqConfig(**kw))
    params = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                             "cpu")
    rng = np.random.RandomState(2)
    B, Ts = 4, 5
    lens = rng.randint(2, Ts + 1, B)
    src = np.zeros((B, Ts), np.int32)
    mask = np.zeros((B, Ts), np.float32)
    for b in range(B):
        src[b, :lens[b]] = rng.randint(2, 16, lens[b])
        mask[b, :lens[b]] = 1.0
    return (ts.Seq2SeqConfig(**kw), params, torch.from_numpy(src),
            torch.from_numpy(mask))


def test_identity_hook_is_a_no_op(toy):
    cfg, params, src, mask = toy
    base = ts.generate(params, src, mask, cfg)
    hooked = ts.generate(params, src, mask, cfg,
                         score_hook=lambda t, lp, s: lp)
    assert torch.equal(base.sequences, hooked.sequences)
    np.testing.assert_allclose(base.scores.numpy(), hooked.scores.numpy(),
                               rtol=1e-6)


def test_ban_token_hook(toy):
    cfg, params, src, mask = toy
    banned = 5

    def hook(t, log_probs, state):
        log_probs = log_probs.clone()
        log_probs[..., banned] = -1e9
        return log_probs

    res = ts.generate(params, src, mask, cfg, score_hook=hook)
    assert (res.sequences != banned).all()


def test_min_length_hook_blocks_early_eos(toy):
    cfg, params, src, mask = toy
    min_len = 4

    def hook(t, log_probs, state):
        if t < min_len - 1:
            log_probs = log_probs.clone()
            log_probs[..., cfg.eos_id] = -1e9
        return log_probs

    res = ts.generate(params, src, mask, cfg, score_hook=hook)
    assert (res.lengths >= min_len).all()


# -------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_beam_search_on_card_does_not_sync_and_matches_cpu(cuda_device):
    V, T, B, K = 50, 12, 8, 5
    trans = _trans(42, V)
    tt = torch.from_numpy(trans).to(cuda_device)

    def step_fn(state, tokens):
        return tt[tokens.long()], state

    kw = dict(batch_size=B, beam_size=K, max_len=T, bos_id=0, eos_id=1,
              vocab_size=V, length_penalty=0.6)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = td.beam_search(step_fn, {}, device=cuda_device, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cpu = _port_beam(trans, **kw)
    assert torch.equal(res.sequences.cpu(), cpu.sequences)
    assert torch.equal(res.lengths.cpu(), cpu.lengths)
    assert torch.allclose(res.scores.cpu(), cpu.scores, atol=EXACT)
