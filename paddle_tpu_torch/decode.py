"""On-device decoding: beam search, greedy search and the per-step greedy
head.

The port of the JAX package's ``decode.py``. ``beam_search`` runs a
Python loop of ``max_len`` steps over device tensors with static
``[batch, beam]`` state: each step scores beam x vocab continuations,
takes a two-stage top-k (per beam over the vocab, then over the K*K
survivors) and records (token, parent) frames; finished beams are
frozen by masking their continuations to ``NEG`` except a zero-score
self-loop on EOS. Sentences are recovered by walking the recorded
parents backwards. Like the JAX scan it always runs ``max_len`` steps,
and nothing inside the loop reads a value back to the host.

Ties break toward the lower index, as ``jax.lax.top_k`` and the stable
``jnp.argsort`` do (``-1e9 + logp`` rounds to ``-1e9`` in fp32, so the
disabled beams at t=0 and a finished beam's row tie exactly): every
top-k here is a stable descending sort, then a slice.

``greedy_step`` (argmax with finished rows frozen on EOS) is the head of
the whole-mode serving engine's decode step and prefill, and of
``greedy_search``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from paddle_tpu_torch.device import resolve_device

__all__ = ["BeamResult", "beam_search", "greedy_search", "greedy_step"]

NEG = -1e9


def greedy_step(log_probs, finished, eos_id: int):
    """One greedy sampling step: argmax over the vocab axis, with
    finished rows frozen on EOS. ``log_probs``: [batch, vocab] (any
    monotone transform of probabilities — logits work, argmax is
    invariant); ``finished``: [batch] bool. Returns ``(next_token
    int32 [batch], finished' [batch])``, both on the device of
    ``log_probs`` (nothing is read back)."""
    nxt = torch.argmax(log_probs, dim=-1).to(torch.int32)
    nxt = torch.where(finished, torch.full_like(nxt, int(eos_id)), nxt)
    return nxt, finished | (nxt == int(eos_id))


class BeamResult(NamedTuple):
    """sequences: [batch, beam, max_len] int32 (padded with eos);
    lengths: [batch, beam] int32 — tokens up to and incl. first eos;
    scores: [batch, beam] f32 — accumulated log-prob (length-normalised
    if a penalty was given), best beam first."""
    sequences: torch.Tensor
    lengths: torch.Tensor
    scores: torch.Tensor


def _top_k(x, k):
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lower index."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_tensor(tree):
    if torch.is_tensor(tree):
        return tree
    items = (tree.values() if isinstance(tree, dict)
             else tree if isinstance(tree, (list, tuple)) else ())
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def _state_device(init_state, device):
    if device is not None:
        return resolve_device(device)
    t = _first_tensor(init_state)
    return t.device if t is not None else resolve_device(None)


def _lengths(seq, eos_id, max_len):
    """Tokens up to and including the first eos, else ``max_len``."""
    is_eos = seq == eos_id
    first = torch.argmax(is_eos.to(torch.int32), dim=-1)
    return torch.where(is_eos.any(dim=-1), first + 1,
                       torch.full_like(first, max_len)).to(torch.int32)


def beam_search(step_fn: Callable, init_state, batch_size: int,
                beam_size: int, max_len: int, bos_id: int, eos_id: int,
                vocab_size: int, length_penalty: float = 0.0,
                score_hook: Callable = None, device=None):
    """Run beam search with a per-token decoder.

    ``step_fn(state, tokens) -> (log_probs, new_state)`` where tokens is
    [batch*beam] int32 and log_probs is [batch*beam, vocab]. ``state`` is
    a tree (dicts, lists) whose tensors have leading dim batch*beam
    (replicate encoder state over beams before calling; they are
    re-gathered by parent beam each step).

    ``score_hook(t, log_probs, state) -> log_probs`` (optional): the DIY
    beam-search hook. Called every step with the step index t (a Python
    int here; a traced int32 in JAX), the per-beam continuation
    log-probs [batch, beam, vocab] (already eos-locked for finished
    beams) and the decoder state; whatever it returns is what top-k
    sees.

    ``device``: where the search's own tensors live; by default the
    device of the first tensor in ``init_state``, else the card.
    """
    B, K, V = batch_size, beam_size, vocab_size
    if K > V:
        raise ValueError(
            f"beam_size ({K}) > vocab_size ({V}): the first top-k could "
            "only fill the beam with duplicate/disabled hypotheses")
    dev = _state_device(init_state, device)
    eos = int(eos_id)

    # beam 0 active at t=0, rest disabled so duplicates don't fill the beam
    # (filled in place: a copy from the host, as `x[i] = v` makes, syncs)
    scores = torch.full((B, K), NEG, dtype=torch.float32, device=dev)
    scores[:, 0].fill_(0.0)
    tokens = torch.full((B * K,), int(bos_id), dtype=torch.int32, device=dev)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    # finished beams: only eos continuation, at zero added score
    fin_row = torch.full((V,), NEG, dtype=torch.float32, device=dev)
    fin_row[eos].fill_(0.0)
    base = (torch.arange(B, device=dev) * K)[:, None]
    state = init_state
    toks, parents = [], []
    for t in range(max_len):
        log_probs, new_state = step_fn(state, tokens)
        log_probs = log_probs.reshape(B, K, V)
        log_probs = torch.where(finished[..., None], fin_row, log_probs)
        if score_hook is not None:
            log_probs = score_hook(t, log_probs, state)
            # re-freeze finished beams in case the hook disturbed them
            log_probs = torch.where(finished[..., None], fin_row, log_probs)
        cand = scores[..., None] + log_probs          # [B, K, V]
        # two-stage top-k: per beam over V, then over the K*K survivors
        # (exact: each beam contributes at most K winners to the top K)
        s1, i1 = _top_k(cand.reshape(B * K, V), K)   # [B*K, K]
        scores, idx2 = _top_k(s1.reshape(B, K * K), K)
        parent = torch.div(idx2, K, rounding_mode="floor")
        token = torch.gather(i1.reshape(B, K * K), 1, idx2).to(torch.int32)
        finished = torch.gather(finished, 1, parent) | (token == eos)
        # re-gather decoder state by parent beam
        gather = (base + parent).reshape(-1)
        state = _tree_map(lambda x: x[gather], new_state)
        tokens = token.reshape(-1)
        toks.append(token)
        parents.append(parent)

    # backtrack: walk parents from the last frame to the first
    beam = torch.arange(K, device=dev).repeat(B, 1)
    seq = [None] * max_len
    for t in range(max_len - 1, -1, -1):
        seq[t] = torch.gather(toks[t], 1, beam)
        beam = torch.gather(parents[t], 1, beam)
    sequences = torch.stack(seq, dim=-1)              # [B, K, T]
    lengths = _lengths(sequences, eos, max_len)

    if length_penalty > 0.0:
        # GNMT-style normalisation ((5+len)/6)^alpha
        norm = ((5.0 + lengths.float()) / 6.0) ** length_penalty
        scores = scores / norm
        order = torch.sort(-scores, dim=1, stable=True).indices
        sequences = torch.gather(
            sequences, 1, order[..., None].expand(-1, -1, max_len))
        lengths = torch.gather(lengths, 1, order)
        scores = torch.gather(scores, 1, order)

    # pad beyond eos with eos
    t_idx = torch.arange(max_len, device=dev)
    sequences = torch.where(t_idx[None, None, :] < lengths[..., None],
                            sequences, torch.full_like(sequences, eos))
    return BeamResult(sequences=sequences.to(torch.int32), lengths=lengths,
                      scores=scores)


def greedy_search(step_fn: Callable, init_state, batch_size: int,
                  max_len: int, bos_id: int, eos_id: int, device=None):
    """Greedy decode (the reference's oneWaySearch): the beam-1 fast path
    without the top-k/regather machinery. Returns ``(seq [B, T] int32,
    lengths [B] int32)``. ``device`` as for ``beam_search``."""
    dev = _state_device(init_state, device)
    state = init_state
    tokens = torch.full((batch_size,), int(bos_id), dtype=torch.int32,
                        device=dev)
    finished = torch.zeros((batch_size,), dtype=torch.bool, device=dev)
    out = []
    for _ in range(max_len):
        log_probs, state = step_fn(state, tokens)
        tokens, finished = greedy_step(log_probs, finished, eos_id)
        out.append(tokens)
    seq = torch.stack(out, dim=1)                     # [B, T]
    return seq, _lengths(seq, int(eos_id), max_len)
