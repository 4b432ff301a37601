"""The port's IMDB LSTM text classifier (``models.text``) held against
the JAX package's ``lstm_benchmark_net`` Program run by ``pt.Executor``.

At vocab 40, emb 128, hidden 128, B 8, T 7, 2 layers, with
``fused_proj`` on (``fused_lstm``: the projection inside the
recurrence on uniform lengths, the composed fallback on ragged ones) and
off (``fc`` + ``dynamic_lstm``), uniform and ragged LoD (a length-1
sequence included), and once with runtime ``seq_lens``: the JAX
Program's parameters after its startup program are carried over with
``convert.params_from_jax`` (the port's names are the Program's), and
the same seeded feeds go through 3 SGD steps and 3 Adam steps on both
sides:

- fp32: each step's loss and accuracy, and every parameter after the
  third step, atol/rtol 1e-5 (the same fp32 math, sums in another
  order);
- AMP (``Executor(amp=True)``; the port's ``TextConfig(amp=True)``):
  each step's loss within 2e-3 (both round the amp_compute ops' inputs
  and outputs through bf16, and the bf16 products sum in another
  order).

The JAX side runs its default route on the CPU (the ``lax.scan``
recurrence; ``tests/test_torch_lstm.py`` holds the ops' kernel routes
against the forced Pallas ones); each JAX run is made once per module.
"""
import contextlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.core.lod import LoD, LoDTensor
from paddle_tpu_torch.models import text as tx

V, E, H, B, T = 40, 128, 128, 8, 7
STEPS = 3
TOL = 1e-5
AMP_LOSS_TOL = 2e-3
LENS = {"uniform": [T] * B, "ragged": [1, 7, 3, 5, 7, 2, 6, 4]}
SEQ_LENS = [7, 1, 3, 5, 7, 2, 6, 4]
LR = {"sgd": 0.05, "adam": 0.002}


def _feeds(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, V, (int(sum(lens)), 1)).astype(np.int64),
             rng.randint(0, 2, (B, 1)).astype(np.int64))
            for _ in range(STEPS)]


_ORACLES = {}


@contextlib.contextmanager
def _fresh_jax_program():
    """A new main and startup program under ``program_guard``, with the
    JAX package's name counters cleared for the build (so parameters get
    the names a fresh process gives them) and restored after, so that
    nothing of this build leaks into other tests of the process."""
    import paddle_tpu as pt
    from paddle_tpu.framework import program as jprog
    saved = dict(jprog._name_counters)
    jprog._name_counters.clear()
    main, start = pt.Program(), pt.Program()
    try:
        with pt.program_guard(main, start):
            yield main, start
    finally:
        jprog._name_counters.clear()
        jprog._name_counters.update(saved)


def _jax_run(fused_proj, lens_key, opt, amp=False, seq_lens=False):
    """Build lstm_benchmark_net in fresh programs, run its startup
    program in a scope of its own, then STEPS training steps: (initial
    params, per-step [loss, accuracy], params after) as numpy, made once
    per module."""
    key = (fused_proj, lens_key, opt, amp, seq_lens)
    if key in _ORACLES:
        return _ORACLES[key]
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import paddle_tpu as pt
    from paddle_tpu.core.lod import LoD as JLoD, LoDTensor as JLoDTensor
    from paddle_tpu.core.scope import Scope
    from paddle_tpu.models import text as jtext

    scope = Scope()
    with _fresh_jax_program() as (main, start):
        data = pt.layers.data("words", [1], dtype="int64", lod_level=1)
        label = pt.layers.data("label", [1], dtype="int64")
        sl = (pt.layers.data("seq_lens", [B], dtype="int32",
                             append_batch_size=False) if seq_lens else None)
        _, loss, acc = jtext.lstm_benchmark_net(
            data, label, input_dim=V, emb_dim=E, hid_dim=H, num_layers=2,
            seq_lens=sl, fused_proj=fused_proj)
        optimizer = (pt.optimizer.Adam(LR[opt]) if opt == "adam"
                     else pt.optimizer.SGD(LR[opt]))
        optimizer.minimize(loss)
        exe = pt.Executor(amp=amp)
        exe.run(start, scope=scope)
        names = [p.name for p in main.global_block().all_parameters()]

        def params():
            return {n: np.array(scope.find_var(n).array) for n in names}

        init = params()
        lens = LENS[lens_key]
        lod = JLoD.from_lengths([lens])
        fetched = []
        for words, lab in _feeds(lens):
            feed = {"words": JLoDTensor(jnp.asarray(words), lod),
                    "label": jnp.asarray(lab)}
            if seq_lens:
                feed["seq_lens"] = jnp.asarray(SEQ_LENS, jnp.int32)
            out = exe.run(main, feed=feed, fetch_list=[loss, acc],
                          scope=scope)
            fetched.append([float(np.asarray(v).reshape(-1)[0])
                            for v in out])
        _ORACLES[key] = (init, fetched, params())
    return _ORACLES[key]


def _port_run(init, fused_proj, lens_key, opt, amp=False, seq_lens=False):
    cfg = tx.TextConfig(vocab_size=V, emb_dim=E, hid_dim=H, num_layers=2,
                        fused_proj=fused_proj, amp=amp)
    params = params_from_jax(init, "cpu")
    o, step = tx.make_train_step(cfg, opt, LR[opt])
    state = o.init(params)
    lens = LENS[lens_key]
    fetched = []
    for words, lab in _feeds(lens):
        feed = {"words": LoDTensor(torch.from_numpy(words),
                                   LoD.from_lengths([lens])),
                "label": torch.from_numpy(lab)}
        if seq_lens:
            feed["seq_lens"] = torch.tensor(SEQ_LENS, dtype=torch.int32)
        params, state, loss, acc = step(params, state, feed)
        fetched.append([float(loss), float(acc.reshape(-1)[0])])
    return fetched, params


ROUTES = {"proj-uniform": (True, "uniform"),
          "proj-ragged": (True, "ragged"),
          "composed-uniform": (False, "uniform"),
          "composed-ragged": (False, "ragged")}


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_training_steps_match_jax(route, opt):
    fused_proj, lens_key = ROUTES[route]
    init, j_fetched, j_after = _jax_run(fused_proj, lens_key, opt)
    fetched, after = _port_run(init, fused_proj, lens_key, opt)
    np.testing.assert_allclose(fetched, j_fetched, atol=TOL, rtol=TOL)
    assert sorted(after) == sorted(j_after)
    for name, value in after.items():
        np.testing.assert_allclose(value.numpy(), j_after[name], atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_seq_lens_steps_match_jax():
    """Runtime lengths over a uniform LoD (the bucketed-batch path):
    fused_lstm's projection route with the SeqLens mask and the LAST pool
    at each sequence's runtime end."""
    init, j_fetched, j_after = _jax_run(True, "uniform", "sgd",
                                        seq_lens=True)
    fetched, after = _port_run(init, True, "uniform", "sgd", seq_lens=True)
    np.testing.assert_allclose(fetched, j_fetched, atol=TOL, rtol=TOL)
    for name, value in after.items():
        np.testing.assert_allclose(value.numpy(), j_after[name], atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize("route", ["proj-uniform", "composed-ragged"])
def test_amp_losses_match_jax(route):
    fused_proj, lens_key = ROUTES[route]
    init, j_fetched, _ = _jax_run(fused_proj, lens_key, "adam", amp=True)
    fetched, after = _port_run(init, fused_proj, lens_key, "adam", amp=True)
    np.testing.assert_allclose([f[0] for f in fetched],
                               [f[0] for f in j_fetched], atol=AMP_LOSS_TOL)
    assert all(v.dtype == torch.float32 for v in after.values())


@pytest.mark.parametrize("fused_proj", [True, False],
                         ids=["fused_proj", "composed"])
def test_params_are_the_jax_programs(fused_proj):
    """init_params: the JAX Program's names, shapes, fp32, zero biases
    and Glorot-uniform bounds."""
    init, _, _ = _jax_run(fused_proj, "uniform", "sgd")
    cfg = tx.TextConfig(vocab_size=V, emb_dim=E, hid_dim=H,
                        fused_proj=fused_proj)
    mine = tx.init_params(cfg, seed=3, device="cpu")
    assert list(mine) == list(init)
    for name, shape, how in tx.param_specs(cfg):
        assert tuple(mine[name].shape) == tuple(init[name].shape) == shape
        assert mine[name].dtype == torch.float32
        if how == "zeros":
            assert not mine[name].any() and not init[name].any()
        else:
            limit = float(np.sqrt(6.0 / (shape[0] + shape[1])))
            assert float(mine[name].abs().max()) <= limit
            assert float(np.abs(init[name]).max()) <= limit


def test_program_is_the_layers_op_order():
    """The ops the port runs are the Program's, in its order, with its
    parameter inputs."""
    pytest.importorskip("jax")
    import paddle_tpu as pt
    from paddle_tpu.models import text as jtext
    for fused_proj in (True, False):
        with _fresh_jax_program() as (main, _start):
            data = pt.layers.data("words", [1], dtype="int64", lod_level=1)
            label = pt.layers.data("label", [1], dtype="int64")
            jtext.lstm_benchmark_net(data, label, input_dim=V, emb_dim=E,
                                     hid_dim=H, fused_proj=fused_proj)
        jops = main.global_block().ops
        cfg = tx.TextConfig(vocab_size=V, emb_dim=E, hid_dim=H,
                            fused_proj=fused_proj)
        mine = tx.program(cfg)
        assert [o.type for o in jops] == [o[0] for o in mine]
        params = {n for n, _, _ in tx.param_specs(cfg)}
        for jop, (_, ins, _, attrs) in zip(jops, mine):
            for slot, names in ins.items():
                want = [n for n in jop.inputs[slot] if n in params]
                assert [n for n in names if n in params] == want
            for k, v in attrs.items():
                assert jop.attrs.get(k, v) == v, (jop.type, k)


def test_cpu_run_counts_no_launches_and_reads_nothing_back():
    from paddle_tpu_torch import kernels as tk
    cfg = tx.TextConfig(vocab_size=V, emb_dim=E, hid_dim=H)
    params = tx.init_params(cfg, seed=0, device="cpu")
    words, lab = _feeds(LENS["uniform"])[0]
    feed = {"words": LoDTensor(torch.from_numpy(words),
                               LoD.from_lengths([LENS["uniform"]])),
            "label": torch.from_numpy(lab)}
    before = dict(tk.LAUNCHES)
    out = tx.forward(params, feed, cfg)
    assert tk.LAUNCHES == before
    assert out["loss"].shape == () and out["loss"].dtype == torch.float32
    assert tuple(out["prediction"].shape) == (B, 2)
    assert torch.allclose(out["prediction"].sum(-1), torch.ones(B))
    assert 0.0 <= float(out["accuracy"]) <= 1.0


def test_train_flops_is_benchs_count():
    """bench.py's _lstm_flops_per_batch at its widths."""
    cfg = tx.TextConfig()
    per_step = 8 * 512 * (128 + 512) + 8 * 512 * (512 + 512)
    assert tx.train_flops(cfg, 128, 100) == 3 * per_step * 100 * 128


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tx.init_params(tx.TextConfig(vocab_size=V, emb_dim=E, hid_dim=H))
