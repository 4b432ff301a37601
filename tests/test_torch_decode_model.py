"""The port's decoder (``mixed_step``) held against the JAX package's.

A scripted run of mixed steps — prefill chunks starting mid-block,
decode rows, invalid rows and a ``write_limit`` cut — goes through the
JAX ``mixed_step`` (dense reference and the Pallas kernel in interpret
mode) and through the port's, from the same params (``params_from_jax``)
and the same numpy inputs. Logits and both pools must agree within
atol 1e-5 in float32 after every step."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import decode_model as jdm
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
