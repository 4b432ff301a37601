"""The port's Executor on the card (no JAX in this file: the card's
machine has none; ``tests/test_torch_executor.py`` holds the Executor
against the JAX package on the CPU).

- The MNIST MLP (784-128-64-10, batch 32, ``SGD(0.1)``) on
  ``CUDAPlace(0)``: 3 steps from a state carried from the card's startup
  program equal the same 3 on ``CPUPlace`` (every loss and persistable
  within 1e-5, fp32 with TF32 off: sums in another order); a step under
  CUDA sync-debug "error" (no host sync); ``run_multi(K=4)`` bit-equal
  to 4 ``run``s.
- The classifier as a Program (``text.build_program``: vocab 50, emb and
  hidden 128, 2 layers, AMP, B 8, T 5) through the Executor launches
  B14/B15 at uniform lengths and B10/B11 on ragged LoD, twice a step
  each, and its per-step loss equals ``text.make_train_step``'s from the
  same parameters within 1e-4 (the same kernels; the updates' arithmetic
  in another order).

Every case needs a card and skips without one (``cuda`` marker).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.core.lod import LoD, LoDTensor
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import text as tx

TOL = 1e-5
B = 32


@pytest.fixture
def cuda_place():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Executor's CUDAPlace and the "
                    "LSTM kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return pt.CUDAPlace(0)


def _mlp():
    tprog._name_counters.clear()
    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start):
        img = pt.layers.data("img", [784])
        label = pt.layers.data("label", [1], dtype="int64")
        _, loss, _ = tmnist.mlp(img, label)
        pt.optimizer.SGD(0.1).minimize(loss)
    return main, start, loss


def _feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    protos = rng.randn(10, 784) * 0.1
    out = []
    for _ in range(n):
        label = rng.randint(0, 10, (B, 1)).astype(np.int64)
        img = np.clip(protos[label[:, 0]] + rng.randn(B, 784), -1, 1)
        out.append({"img": img.astype(np.float32), "label": label})
    return out


def _started(place):
    main, start, loss = _mlp()
    scope = Scope()
    start.random_seed = 0
    pt.Executor(place).run(start, scope=scope)
    return main, loss, scope


def _copy(scope, device):
    out = Scope()
    for n in scope.local_var_names():
        out.set_tensor(n, scope.find_var(n).array.to(device, copy=True))
    return out


@pytest.mark.cuda
def test_mlp_steps_on_card_equal_cpu(cuda_place):
    main, loss, scope = _started(cuda_place)
    cpu = _copy(scope, "cpu")
    exe, cexe = pt.Executor(cuda_place), pt.Executor(pt.CPUPlace())
    for f in _feeds(3):
        (got,) = exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        (want,) = cexe.run(main, feed=f, fetch_list=[loss], scope=cpu)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    for n in cpu.local_var_names():
        np.testing.assert_allclose(scope.find_var(n).array.cpu().numpy(),
                                   cpu.find_var(n).array.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=n)


@pytest.mark.cuda
def test_mlp_step_does_not_sync_the_host(cuda_place):
    main, loss, scope = _started(cuda_place)
    exe = pt.Executor(cuda_place)
    f = _feeds(2)
    exe.run(main, feed=f[0], fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (out,) = exe.run(main, feed=f[1], fetch_list=[loss], scope=scope,
                         return_numpy=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.array.is_cuda and bool(torch.isfinite(out.array))


@pytest.mark.cuda
def test_run_multi_equals_runs_on_card(cuda_place):
    main, loss, scope = _started(cuda_place)
    other = _copy(scope, cuda_place.device)
    ea, eb = pt.Executor(cuda_place), pt.Executor(cuda_place)
    fs = _feeds(4)
    one = [ea.run(main, feed=f, fetch_list=[loss], scope=scope,
                  return_numpy=False)[0].array for f in fs]
    multi = eb.run_multi(main, fs, fetch_list=[loss], scope=other,
                         return_numpy=False)[0]
    assert torch.equal(multi, torch.stack(one))
    for n in scope.local_var_names():
        assert torch.equal(scope.find_var(n).array,
                           other.find_var(n).array), n


@pytest.mark.cuda
@pytest.mark.parametrize("lens,names", [
    ([5] * 8, ("lstm_proj_fwd", "lstm_proj_bwd")),
    ([1, 5, 3, 4, 2, 5, 5, 1], ("lstm_fwd", "lstm_bwd"))],
    ids=["uniform-B14-B15", "ragged-B10-B11"])
def test_text_program_runs_the_lstm_kernels(cuda_place, lens, names):
    dev = cuda_place.device
    cfg = tx.TextConfig(vocab_size=50, emb_dim=128, hid_dim=128)
    main, start = tx.build_program(cfg)
    exe = pt.Executor(cuda_place, amp=True)
    scope = Scope()
    start.random_seed = 1
    exe.run(start, scope=scope)
    params = {n: scope.find_var(n).array.clone()
              for n, _, _ in tx.param_specs(cfg)}
    rng = np.random.RandomState(2)
    feeds = [{"words": LoDTensor(torch.from_numpy(
        rng.randint(0, 50, (sum(lens), 1))).to(dev), LoD.from_lengths(
            [lens])), "label": torch.from_numpy(
                rng.randint(0, 2, (8, 1))).to(dev)} for _ in range(2)]
    tk.reset_launches()
    got = [exe.run(main, feed=f, fetch_list=["loss"], scope=scope)[0]
           for f in feeds]
    launches = dict(tk.LAUNCHES)
    for n in names:
        assert launches[n] == 2 * len(feeds), (n, launches)
    opt, step = tx.make_train_step(cfg, "adam", 0.002)
    state = opt.init(params)
    for f, loss in zip(feeds, got):
        params, state, want, _ = step(params, state, f)
        np.testing.assert_allclose(loss, want.cpu().numpy(), rtol=1e-4)
    tk.reset_launches()
