"""The training plane on the card (no JAX in this file: the card's machine
has none; ``tests/test_torch_optim.py`` holds it against the JAX package
on the CPU).

- Every op the training plane adds (``chip_smoke.optim_op_cases``: the
  six optimizers' updates, proximal_gd / proximal_adagrad, ema_update,
  the pruning pair, lr_schedule in every strategy, and the clip's and
  the decay's ops) on CUDA tensors against the same op on the CPU,
  relative L2 <= 1e-6 (``chip_smoke.OPTIM_OP_REL_L2``).
- A small classifier with the full recipe (``Adam(ExponentialDecay)``,
  ``global_clip_norm=``, ``L2Decay`` on every parameter, a
  ``ModelAverage``) through ``Executor(CUDAPlace(0))`` from one startup
  state equals the same 4 steps on ``CPUPlace`` (losses, learning rates
  and every persistable within 1e-5); ``ModelAverage.apply()`` and its
  restore under sync-debug "error".

Every case needs a card and skips without one (``cuda`` marker).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.framework import program as tprog

TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDAPlace has no CPU mode")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = saved
    tprog.fresh_programs()
    tscope.reset_global_scope()


@pytest.mark.cuda
def test_new_ops_on_the_card_match_the_cpu(card):
    import chip_smoke as cs
    worst = cs.optim_ops_card_vs_cpu(card, [(40, 16), (16, 64), (64,)])
    assert max(worst.values()) <= cs.OPTIM_OP_REL_L2
    assert {"adagrad", "adamax", "decayed_adagrad", "adadelta", "rmsprop",
            "ftrl", "proximal_gd", "proximal_adagrad", "lr_schedule",
            "ema_update", "magnitude_prune_mask", "apply_mask", "sign",
            "assign", "increment", "sqrt", "elementwise_max",
            "squared_l2_norm"} <= set(worst)


def _recipe_program():
    main, start = tprog.fresh_programs()
    x = pt.layers.data("x", [8])
    label = pt.layers.data("label", [1], dtype="int64")
    h = pt.layers.fc(x, 16, act="relu")
    loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
        pt.layers.fc(h, 3), label))
    for p in main.global_block().all_parameters():
        p.regularizer = pt.regularizer.L2Decay(1e-3)
    opt = pt.optimizer.Adam(pt.lr_scheduler.ExponentialDecay(
        0.05, decay_steps=3, decay_rate=0.5), global_clip_norm=0.5)
    opt.minimize(loss)
    ma = pt.optimizer.ModelAverage(0.9)
    return main, start, loss, opt, ma


@pytest.mark.cuda
def test_recipe_on_the_card_matches_the_cpu(card):
    main, start, loss, opt, ma = _recipe_program()
    cpu = tscope.Scope()
    start.random_seed = 2
    pt.Executor(pt.CPUPlace()).run(start, scope=cpu)
    dev = tscope.global_scope()
    for n in cpu.local_var_names():
        dev.set_tensor(n, cpu.find_var(n).array.to(card))
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(8, 8).astype(np.float32) * 3,
              "label": rng.randint(0, 3, (8, 1)).astype(np.int64)}
             for _ in range(4)]
    fetch = [loss, opt._lr_var]
    e_cpu, e_dev = pt.Executor(pt.CPUPlace()), pt.Executor(pt.CUDAPlace(0))
    for f in feeds:
        want = e_cpu.run(main, feed=f, fetch_list=fetch, scope=cpu)
        got = e_dev.run(main, feed=f, fetch_list=fetch)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    for n in cpu.local_var_names():
        np.testing.assert_allclose(dev.find_var(n).array.cpu().numpy(),
                                   cpu.find_var(n).array.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=n)
    live = {p: dev.find_var(p).array for p, _ in ma._pairs}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with ma.apply():
            inside = {p: dev.find_var(p).array for p, _ in ma._pairs}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for p, a in ma._pairs:
        assert torch.equal(inside[p], dev.find_var(a).array)
        assert dev.find_var(p).array is live[p]
