"""The port's seq2seq NMT model, held against the JAX package.

Two configs, with the JAX ``init_params`` copied across
(``params_from_jax``) and the same numpy batches (ragged sources with
lengths 1..Ts, ragged targets):

- "kernel": hidden 128, batch 8. The engagement predicate holds, so the
  encoder runs ``gru_scan`` on both sides (JAX: the Pallas kernels in
  interpret mode, forced on the CPU with ``FORCE_FOR_TESTS``; the port:
  the kernels' plain versions on the CPU);
- "lax": hidden 24, batch 6. The predicate fails (24 % 128), so both
  sides run the step-by-step recurrence in the compute dtype.

Tolerances (fp32): ``encode`` outputs and ``decode_train_loss`` atol
1e-5; every gradient atol 1e-4 (sums in another order through the
encoder, the 7-step decoder and the readout); three Adam steps (lr 1e-3)
atol 1e-5 on each loss and every param (an update is lr * m/sqrt(v), so
1e-6 relative gradient noise moves a param by ~1e-9). bf16 (compute
dtype, fp32 masters): the loss rtol 2e-2; every gradient no further
from the JAX fp32 gradient (relative L2) than 1.5x the JAX bf16
gradient is, + 1e-2 (each eager op rounds to bf16, in another order on
the two sides; a gradient as small as ``att_dec_w``'s, ~1e-5, is mostly
bf16 noise on both).
``generate``: equal sequences and lengths, scores atol 1e-4, at seeds
where every beam decision has a live-candidate gap > 1e-4 (checked by
replaying the search on the port's log-probs), so no near-tie decides.

The JAX oracles are computed once per module. The kernel-vs-plain
cases need a card and skip without one.
"""
import contextlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.kernels import fused_rnn as tfr
from paddle_tpu_torch.models import seq2seq as ts
from paddle_tpu_torch.ops import rnn as trnn

ROUTES = {"kernel": (dict(src_vocab=20, tgt_vocab=20, emb_dim=16,
                          hidden_dim=128, beam_size=3, max_gen_len=6), 8),
          "lax": (dict(src_vocab=20, tgt_vocab=20, emb_dim=16,
                       hidden_dim=24, beam_size=3, max_gen_len=6), 6)}
TS, TT = 7, 7
TOL = 1e-5
GRAD_TOL = 1e-4
BF16_LOSS_RTOL = 2e-2
BF16_GRAD_RATIO = 1.5
LR = 1e-3
GAP = 1e-4
GEN_SEED = 38   # a batch whose searches have no near-tie on either route


@pytest.fixture(scope="module")
def js():
    pytest.importorskip("jax")
    from paddle_tpu.models import seq2seq
    return seq2seq


def _batch(route, seed=0):
    """Ragged sources (row 0 full length, row 1 length 1) and targets."""
    cfg, B = ROUTES[route]
    rng = np.random.RandomState(seed)
    slen = rng.randint(1, TS + 1, B)
    slen[0], slen[1] = TS, 1
    tlen = rng.randint(1, TT + 1, B)
    tlen[0] = TT
    t_idx = np.arange(TS)
    return {
        "src": rng.randint(2, cfg["src_vocab"], (B, TS)).astype(np.int32),
        "src_mask": (t_idx[None] < slen[:, None]).astype(np.float32),
        "tgt_in": rng.randint(2, cfg["tgt_vocab"], (B, TT)).astype(np.int32),
        "tgt_out": rng.randint(2, cfg["tgt_vocab"], (B, TT)).astype(np.int32),
        "tgt_mask": (np.arange(TT)[None] < tlen[:, None]).astype(np.float32),
    }


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jcfg(js, route, bf16=False, **kw):
    import jax.numpy as jnp
    return js.Seq2SeqConfig(**ROUTES[route][0],
                            dtype=jnp.bfloat16 if bf16 else jnp.float32,
                            **kw)


def _tcfg(route, bf16=False, **kw):
    return ts.Seq2SeqConfig(**ROUTES[route][0],
                            dtype=torch.bfloat16 if bf16 else torch.float32,
                            **kw)


@contextlib.contextmanager
def _jax_route(route):
    """The JAX predicate engages the Pallas kernels on the CPU only when
    forced; the kernel route forces it, the lax route leaves it off."""
    from paddle_tpu.kernels import fused_rnn
    prev = fused_rnn.FORCE_FOR_TESTS
    fused_rnn.FORCE_FOR_TESTS = route == "kernel"
    try:
        yield
    finally:
        fused_rnn.FORCE_FOR_TESTS = prev


def _np_dict(d):
    return {k: np.array(v, np.float32) for k, v in d.items()}


class _Oracle:
    """JAX results, computed on first use and kept for the module."""

    def __init__(self, js):
        self.js, self.cache = js, {}

    def get(self, key, make):
        if key not in self.cache:
            self.cache[key] = make()
        return self.cache[key]

    def params(self, route):
        import jax

        def make():
            return _np_dict(self.js.init_params(jax.random.PRNGKey(0),
                                                _jcfg(self.js, route)))
        return self.get(("params", route), make)

    def _jparams(self, route):
        import jax.numpy as jnp
        return {k: jnp.asarray(v) for k, v in self.params(route).items()}

    def encode(self, route):
        import jax.numpy as jnp

        def make():
            b = _batch(route)
            with _jax_route(route):
                out = self.js.encode(self._jparams(route),
                                     jnp.asarray(b["src"]),
                                     jnp.asarray(b["src_mask"]),
                                     _jcfg(self.js, route))
            return [np.array(o, np.float32) for o in out]
        return self.get(("encode", route), make)

    def loss_and_grads(self, route, bf16=False):
        import jax
        import jax.numpy as jnp

        def make():
            b = {k: jnp.asarray(v) for k, v in _batch(route).items()}
            cfg = _jcfg(self.js, route, bf16)
            with _jax_route(route):
                loss, grads = jax.value_and_grad(
                    lambda p: self.js.decode_train_loss(
                        p, b["src"], b["src_mask"], b["tgt_in"],
                        b["tgt_out"], b["tgt_mask"], cfg))(
                            self._jparams(route))
            return float(loss), _np_dict(grads)
        return self.get(("grads", route, bf16), make)

    def steps(self, route):
        import jax.numpy as jnp

        def make():
            cfg = _jcfg(self.js, route)
            with _jax_route(route):
                opt, step = self.js.make_train_step(cfg, lr=LR)
                p = self._jparams(route)
                st = opt.init(p)
                losses = []
                for i in range(3):
                    b = {k: jnp.asarray(v)
                         for k, v in _batch(route, seed=10 + i).items()}
                    p, st, loss = step(p, st, b)
                    losses.append(float(loss))
            return losses, _np_dict(p)
        return self.get(("steps", route), make)

    def generate(self, route, seed):
        import jax.numpy as jnp

        def make():
            b = _batch(route, seed)
            with _jax_route(route):
                res = self.js.generate(self._jparams(route),
                                       jnp.asarray(b["src"]),
                                       jnp.asarray(b["src_mask"]),
                                       _jcfg(self.js, route))
            return [np.array(a) for a in res]
        return self.get(("generate", route, seed), make)


@pytest.fixture(scope="module")
def oracle(js):
    return _Oracle(js)


def _port(oracle, route):
    return params_from_jax(oracle.params(route), "cpu")


def _port_grads(params, batch, cfg):
    live = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    loss = ts.decode_train_loss(live, batch["src"], batch["src_mask"],
                                batch["tgt_in"], batch["tgt_out"],
                                batch["tgt_mask"], cfg)
    grads = torch.autograd.grad(loss, list(live.values()))
    return loss.detach(), dict(zip(live, grads))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=what)


def _rel_l2(a, b):
    a = a.detach().float().numpy()
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("route", ROUTES)
def test_routes_follow_the_jax_predicate(js, route):
    from paddle_tpu.kernels import fused_rnn
    cfg, B = ROUTES[route]
    H = cfg["hidden_dim"]
    with _jax_route(route):
        want = js._use_fused_gru(B, H, np.float32)
    assert (want == "direct") == (route == "kernel")
    assert ts._use_fused_gru(B, H, torch.float32) == want
    assert ts._use_fused_gru(B, H, torch.bfloat16) == want
    assert ts._use_fused_gru(B, H, torch.float16) is False
    assert ts._use_fused_gru(B + 1, H, torch.float32) is False
    assert fused_rnn.FORCE_FOR_TESTS is False


def test_reverse_valid_matches_jax():
    from paddle_tpu.ops import rnn as jrnn
    b = _batch("kernel", seed=3)
    x = np.random.RandomState(3).randn(8, TS, 5).astype(np.float32)
    want = np.asarray(jrnn._reverse_valid(x, b["src_mask"], TS))
    got = trnn._reverse_valid(torch.from_numpy(x),
                              torch.from_numpy(b["src_mask"]), TS)
    assert np.array_equal(got.numpy(), want)
    lens = trnn._lens_from_mask(torch.from_numpy(b["src_mask"]))
    assert lens.dtype == torch.float32 and tuple(lens.shape) == (8, 1)
    assert np.array_equal(lens.numpy(), np.asarray(
        jrnn._lens_from_mask(b["src_mask"])))


@pytest.mark.parametrize("route", ROUTES)
def test_encode_matches_jax(oracle, route):
    b = _tb(_batch(route))
    got = ts.encode(_port(oracle, route), b["src"], b["src_mask"],
                    _tcfg(route))
    for g, w, name in zip(got, oracle.encode(route),
                          ("enc", "dec_h0", "att_keys")):
        _close(g, w, TOL, name)


@pytest.mark.parametrize("route", ROUTES)
def test_loss_and_every_grad_match_jax(oracle, route):
    j_loss, j_grads = oracle.loss_and_grads(route)
    loss, grads = _port_grads(_port(oracle, route), _tb(_batch(route)),
                              _tcfg(route))
    assert abs(float(loss) - j_loss) <= TOL
    assert sorted(grads) == sorted(j_grads)
    for k, g in grads.items():
        assert g.dtype == torch.float32
        _close(g, j_grads[k], GRAD_TOL, k)


@pytest.mark.parametrize("route", ROUTES)
def test_three_adam_steps_match_jax(oracle, route):
    j_losses, j_params = oracle.steps(route)
    opt, step = ts.make_train_step(_tcfg(route), lr=LR)
    p = _port(oracle, route)
    st = opt.init(p)
    losses = []
    for i in range(3):
        p, st, loss = step(p, st, _tb(_batch(route, seed=10 + i)))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, j_losses, atol=TOL, rtol=0)
    assert int(st["t"]) == 3 and st["t"].dtype == torch.int32
    for k, v in p.items():
        _close(v, j_params[k], TOL, k)


@pytest.mark.parametrize("route", ROUTES)
def test_bf16_loss_and_grads_match_jax(oracle, route):
    j_loss, j_grads = oracle.loss_and_grads(route, bf16=True)
    _l32, exact = oracle.loss_and_grads(route)
    loss, grads = _port_grads(_port(oracle, route), _tb(_batch(route)),
                              _tcfg(route, bf16=True))
    assert abs(float(loss) - j_loss) <= BF16_LOSS_RTOL * abs(j_loss)
    for k, g in grads.items():
        assert g.dtype == torch.float32, k      # the fp32 masters' grads
        err = _rel_l2(g, exact[k])
        j_err = _rel_l2(torch.from_numpy(j_grads[k]), exact[k])
        assert err <= BF16_GRAD_RATIO * j_err + 1e-2, (k, err, j_err)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_remat_on_and_off_give_the_same_values(oracle, bf16):
    p = _port(oracle, "kernel")
    b = _tb(_batch("kernel"))
    l_on, g_on = _port_grads(p, b, _tcfg("kernel", bf16, remat=True))
    l_off, g_off = _port_grads(p, b, _tcfg("kernel", bf16, remat=False))
    assert torch.equal(l_on, l_off)
    for k in g_on:
        assert torch.equal(g_on[k], g_off[k]), k


def _replay_gaps(step_logps, B, K, V):
    """The smallest gap between consecutive live candidates (score >
    -1e8) among the top K+1 of each search step, replaying the flat
    top-K on the recorded (already eos-locked) log-probs."""
    scores = np.full((B, K), -1e9, np.float32)
    scores[:, 0] = 0.0
    worst = np.inf
    for lp in step_logps:
        cand = (scores[..., None] + lp).reshape(B, K * V)
        order = np.argsort(-cand, axis=1, kind="stable")[:, :K + 1]
        top = np.take_along_axis(cand, order, axis=1)
        live = top > -1e8
        gaps = np.where(live[:, 1:] & live[:, :-1],
                        top[:, :-1] - top[:, 1:], np.inf)
        worst = min(worst, float(gaps.min()))
        scores = top[:, :K]
    return worst


@pytest.mark.parametrize("route", ROUTES)
def test_generate_matches_jax(oracle, route):
    cfg = _tcfg(route)
    B = ROUTES[route][1]
    b = _tb(_batch(route, seed=GEN_SEED))
    seen = []

    def record(t, lp, state):
        seen.append(lp.numpy().copy())
        return lp

    p = _port(oracle, route)
    res = ts.generate(p, b["src"], b["src_mask"], cfg, score_hook=record)
    gap = _replay_gaps(seen, B, cfg.beam_size, cfg.tgt_vocab)
    assert gap > GAP, f"a near-tie decides this search (gap {gap})"
    j_seq, j_len, j_scores = oracle.generate(route, GEN_SEED)
    assert np.array_equal(res.sequences.numpy(), j_seq)
    assert np.array_equal(res.lengths.numpy(), j_len)
    np.testing.assert_allclose(res.scores.numpy(), j_scores, atol=1e-4,
                               rtol=0)
    assert res.sequences.dtype == res.lengths.dtype == torch.int32
    again = ts.generate(p, b["src"], b["src_mask"], cfg)
    assert torch.equal(again.sequences, res.sequences)


def test_train_and_generate_count_no_launches_on_cpu(oracle):
    before = dict(tk.LAUNCHES)
    opt, step = ts.make_train_step(_tcfg("kernel", bf16=True), lr=LR)
    p = _port(oracle, "kernel")
    b = _tb(_batch("kernel"))
    p, _st, loss = step(p, opt.init(p), b)
    assert bool(torch.isfinite(loss))
    assert all(v.dtype == torch.float32 for v in p.values())
    ts.generate(p, b["src"], b["src_mask"], _tcfg("kernel"))
    assert tk.LAUNCHES == before


def test_spmd_trace_and_gru_scan_dp_raise_naming_a9(oracle):
    b = _tb(_batch("kernel"))
    with tk.spmd_trace_guard(mesh=None, data_axis="data"):
        with pytest.raises(NotImplementedError, match="A9"):
            ts.encode(_port(oracle, "kernel"), b["src"], b["src_mask"],
                      _tcfg("kernel"))
    assert not tk.in_spmd_trace()
    with pytest.raises(NotImplementedError, match="A9"):
        tfr.gru_scan_dp(None, None, None, None, mesh=None, data_axis="data")


def test_params_from_jax_carries_the_flat_dict(oracle):
    jp = oracle.params("kernel")
    port = params_from_jax(jp, "cpu")
    assert list(port) == list(jp)
    for k, v in port.items():
        assert v.dtype == torch.float32, k
        assert np.array_equal(v.numpy(), jp[k]), k


def test_init_params_has_the_jax_layout(oracle):
    jp = oracle.params("kernel")
    params = ts.init_params(_tcfg("kernel"), seed=3, device="cpu")
    assert list(params) == list(jp)
    for k, v in params.items():
        assert tuple(v.shape) == jp[k].shape and v.dtype == torch.float32, k
    again = ts.init_params(_tcfg("kernel"), seed=3, device="cpu")
    for k in params:
        assert torch.equal(params[k], again[k]), k
    # Glorot scale: std sqrt(2 / (fan_in + fan_out))
    std = float(params["enc_fwd_w"].std())
    assert abs(std / np.sqrt(2.0 / (16 + 128 + 384)) - 1.0) < 0.05
    assert not params["enc_fwd_b"].any()


def test_init_params_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.init_params(_tcfg("kernel"))


# -------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GRU kernels have no CPU mode")
    return torch.device("cuda")


def _card_batch(dev, B=16, S=12, V=64, seed=2):
    rng = np.random.RandomState(seed)
    slen = rng.randint(1, S + 1, B)
    slen[0] = S
    mask = (np.arange(S)[None] < slen[:, None]).astype(np.float32)
    b = {"src": rng.randint(2, V, (B, S)).astype(np.int32),
         "src_mask": mask,
         "tgt_in": rng.randint(2, V, (B, S)).astype(np.int32),
         "tgt_out": rng.randint(2, V, (B, S)).astype(np.int32),
         "tgt_mask": np.ones((B, S), np.float32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_train_step_kernels_match_plain_on_card(cuda_device, bf16):
    """One step's loss and gradients through the GRU kernels (under CUDA
    sync-debug "error") against the same step through their plain
    versions: relative L2 1e-4 (fp32) / 2e-2 (bf16)."""
    cfg = ts.Seq2SeqConfig(src_vocab=64, tgt_vocab=64, emb_dim=32,
                           hidden_dim=128,
                           dtype=torch.bfloat16 if bf16 else torch.float32)
    params = ts.init_params(cfg, seed=1, device=cuda_device)
    b = _card_batch(cuda_device)
    tk.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, grads = _port_grads(params, b, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for name in ("gru_fwd", "gru_bwd", "gru_dw"):
        assert tk.LAUNCHES[name] == 2, name
    with tfr.plain_versions():
        r_loss, r_grads = _port_grads(params, b, cfg)
    tol = 2e-2 if bf16 else 1e-4
    assert abs(float(loss) - float(r_loss)) <= tol * abs(float(r_loss))
    for k in grads:
        a, r = grads[k], r_grads[k]
        rel = float(torch.linalg.vector_norm(a - r)
                    / torch.linalg.vector_norm(r).clamp_min(1e-30))
        assert rel <= tol, (k, rel)


@pytest.mark.cuda
def test_generate_on_card_does_not_sync_and_is_deterministic(cuda_device):
    cfg = ts.Seq2SeqConfig(src_vocab=64, tgt_vocab=64, emb_dim=32,
                           hidden_dim=128, beam_size=4, max_gen_len=8)
    params = ts.init_params(cfg, seed=1, device=cuda_device)
    b = _card_batch(cuda_device)
    tk.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = ts.generate(params, b["src"], b["src_mask"], cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tk.LAUNCHES["gru_fwd"] == 2
    again = ts.generate(params, b["src"], b["src_mask"], cfg)
    assert torch.equal(res.sequences, again.sequences)
    assert torch.equal(res.lengths, again.lengths)
    assert tuple(res.sequences.shape) == (16, 4, 8)
