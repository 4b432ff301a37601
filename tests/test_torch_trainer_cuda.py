"""The port's training entry point on the card (no JAX in this file: the
card's machine has none; ``tests/test_torch_trainer.py`` holds the
Trainer against the JAX package on the CPU).

- ``reader.device_buffered`` to ``cuda``: every array leaf on the card,
  equal to its source, LoD kept, made under CUDA sync-debug "error" (the
  reader makes no host sync).
- The MNIST MLP through ``Trainer(place=CUDAPlace(0))``: 4 batches'
  costs equal ``Trainer(place=CPUPlace())``'s from the same startup
  state within 1e-5 (fp32 with TF32 off: sums in another order), and
  with ``double_buffer`` and ``steps_per_call=2`` bit-equal to the plain
  loop on the card.
- ``lstm_benchmark_net(fused_proj=True)`` built by the DSL (vocab 50,
  emb and hidden 128, B 8, T 5) through ``Trainer(executor=
  Executor(CUDAPlace(0), amp=True))``: B14/B15 launched twice a step on
  uniform batches and B10/B11 on ragged ones, and the costs bit-equal to
  ``Executor.run`` over ``text.build_program`` on the same feeds.
- A ``dynamic_gru`` program (D 128, B 8) launches B12/B13 (``gru_fwd``,
  ``gru_bwd``, ``gru_dw``) once a step, each step's loss within the
  smoke's seq2seq gates of the plain versions' (``fused_rnn.plain_versions()``):
  relative 1e-4 in fp32, 1e-2 in AMP.

Every case needs a card and skips without one (``cuda`` marker).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.core.lod import LoD, LoDTensor
from paddle_tpu_torch.core.scope import Scope, global_scope, \
    reset_global_scope
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.kernels import fused_rnn as tfr
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import text as tx

TOL = 1e-5
GRU_RTOL = {False: 1e-4, True: 1e-2}    # chip_smoke.py's S2S gates


@pytest.fixture
def cuda_place():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDAPlace, the pinned copies and "
                    "the recurrence kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tprog.fresh_programs()
    reset_global_scope()
    yield pt.CUDAPlace(0)
    tprog.fresh_programs()
    reset_global_scope()


@pytest.mark.cuda
def test_device_buffered_copies_without_a_host_sync(cuda_place):
    rng = np.random.RandomState(0)
    items = [{"words": LoDTensor(rng.randint(0, 9, (7, 1)),
                                 LoD.from_lengths([[3, 4]])),
              "label": rng.randint(0, 2, (2, 1))} for _ in range(5)]
    reader = pt.reader.device_buffered(lambda: iter(items), size=2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = list(reader())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g, w in zip(got, items):
        assert g["words"].array.is_cuda and g["label"].is_cuda
        assert g["words"].lod == w["words"].lod
        assert torch.equal(g["words"].array.cpu(), w["words"].array)
        assert np.array_equal(g["label"].cpu().numpy(), w["label"])


def _mlp_trainer(place, state):
    """The MLP's Trainer on ``place`` with ``state`` (name -> CPU tensor)
    as its startup state."""
    tprog.fresh_programs()
    reset_global_scope()
    img = pt.layers.data("img", [784])
    label = pt.layers.data("label", [1], dtype="int64")
    _, loss, acc = tmnist.mlp(img, label)
    tr = pt.Trainer(cost=loss, optimizer=pt.optimizer.SGD(0.1),
                    feed_list=[img, label], metrics=[acc], place=place)
    if state is None:
        tr.startup_program.random_seed = 0
        tr._init_params()
    else:
        for n, v in state.items():
            global_scope().set_tensor(n, v.to(place.device, copy=True))
        tr._initialized = True
    return tr


def _mlp_reader():
    rng = np.random.RandomState(1)
    protos = rng.randn(10, 784) * 0.1
    samples = []
    for _ in range(128):
        y = int(rng.randint(10))
        x = np.clip(protos[y] + rng.randn(784), -1, 1).astype(np.float32)
        samples.append((x, y))
    return pt.reader.batch(lambda: iter(samples), 32)


def _costs(tr, reader, **kw):
    out = []
    tr.train(reader, log_period=0, event_handler=lambda e: out.append(
        (e.cost, dict(e.metrics)))
        if isinstance(e, pt.event.EndIteration) else None, **kw)
    return out


@pytest.mark.cuda
def test_trainer_on_card_equals_cpu_and_its_options(cuda_place):
    cpu_tr = _mlp_trainer(pt.CPUPlace(), None)
    state = {n: global_scope().find_var(n).array.clone()
             for n in global_scope().local_var_names()}
    cpu = _costs(cpu_tr, _mlp_reader())
    runs = {}
    for key, kw in (("plain", {}), ("double_buffer", {"double_buffer": True}),
                    ("k2", {"steps_per_call": 2})):
        runs[key] = _costs(_mlp_trainer(cuda_place, state), _mlp_reader(),
                           **kw)
        names = list(global_scope().local_var_names())
        assert all(global_scope().find_var(n).array.is_cuda for n in names)
    np.testing.assert_allclose([c for c, _ in runs["plain"]],
                               [c for c, _ in cpu], atol=TOL, rtol=TOL)
    assert runs["double_buffer"] == runs["plain"]
    assert runs["k2"] == runs["plain"]


def _text_feeds(lens, n=2, seed=2):
    rng = np.random.RandomState(seed)
    return [[(rng.randint(0, 50, ln).tolist(), int(rng.randint(0, 2)))
             for ln in lens] for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("lens,names", [
    ([5] * 8, ("lstm_proj_fwd", "lstm_proj_bwd")),
    ([1, 5, 3, 4, 2, 5, 5, 1], ("lstm_fwd", "lstm_bwd"))],
    ids=["uniform-B14-B15", "ragged-B10-B11"])
def test_trainer_runs_the_flagship_on_its_kernels(cuda_place, lens, names):
    cfg = tx.TextConfig(vocab_size=50, emb_dim=128, hid_dim=128)
    words = pt.layers.data("words", [1], dtype="int64", lod_level=1)
    label = pt.layers.data("label", [1], dtype="int64")
    _, loss, acc = tx.lstm_benchmark_net(words, label, input_dim=50,
                                         emb_dim=128, hid_dim=128,
                                         fused_proj=True)
    tr = pt.Trainer(cost=loss, optimizer=pt.optimizer.Adam(0.002),
                    feed_list=[words, label], metrics=[acc],
                    executor=pt.Executor(cuda_place, amp=True))
    tr.startup_program.random_seed = 4
    batches = _text_feeds(lens)
    tr._init_params()
    start_state = {n: global_scope().find_var(n).array.clone()
                   for n in global_scope().local_var_names()}
    tk.reset_launches()
    got = _costs(tr, lambda: iter(batches))
    launches = dict(tk.LAUNCHES)
    for n in names:
        assert launches[n] == 2 * len(batches), (n, launches)
    # the same feeds through build_program from the same state
    tprog.fresh_programs()
    main, _ = tx.build_program(cfg)
    scope = Scope()
    for n, v in start_state.items():
        scope.set_tensor(n, v)
    exe = pt.Executor(cuda_place, amp=True)
    for (cost, metrics), b in zip(got, batches):
        want, w_acc = exe.run(main, feed=tr.feeder.feed(b),
                              fetch_list=[tx.LOSS, tx.ACCURACY],
                              scope=scope)
        assert cost == float(want.reshape(-1)[0])
        assert metrics[acc.name] == float(w_acc.reshape(-1)[0])
    tk.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_dynamic_gru_program_runs_b12_b13(cuda_place, amp):
    words = pt.layers.data("words", [1], dtype="int64", lod_level=1)
    label = pt.layers.data("label", [1], dtype="int64")
    emb = pt.layers.embedding(words, size=[50, 128])
    hidden = pt.layers.dynamic_gru(pt.layers.fc(emb, 3 * 128), 128)
    logits = pt.layers.fc(pt.layers.sequence_pool(hidden, "last"), 2)
    loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits,
                                                               label))
    pt.optimizer.Adam(0.002).minimize(loss)
    main, start = pt.default_main_program(), pt.default_startup_program()
    scope = Scope()
    start.random_seed = 5
    exe = pt.Executor(cuda_place, amp=amp)
    exe.run(start, scope=scope)
    plain_scope = Scope()
    for n in scope.local_var_names():
        plain_scope.set_tensor(n, scope.find_var(n).array.clone())
    feeder = pt.DataFeeder([words, label])
    feeds = [feeder.feed(b) for b in _text_feeds([5, 3, 5, 1, 4, 5, 2, 5])]
    tk.reset_launches()
    got = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
           for f in feeds]
    launches = dict(tk.LAUNCHES)
    for n in ("gru_fwd", "gru_bwd", "gru_dw"):
        assert launches[n] == len(feeds), (n, launches)
    with tfr.plain_versions():
        want = [exe.run(main, feed=f, fetch_list=[loss],
                        scope=plain_scope)[0] for f in feeds]
    tk.reset_launches()
    np.testing.assert_allclose(got, want, rtol=GRU_RTOL[amp], atol=0)
