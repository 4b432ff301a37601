"""The port's image ops and the image path on the card (no JAX in this
file: the card's machine has none; ``tests/test_torch_nn_ops.py`` and
``tests/test_torch_image.py`` hold them against the JAX package on the
CPU).

- ``conv2d`` (padding, strides, groups, dilation, the 7x7 stride-2
  stem), ``conv2d_transpose``, ``pool2d`` (max 3x3/2 pad 1, average
  3x3/2, exclusive average with pads, global average) and ``batch_norm``
  (training, its running statistics, and ``is_test``) on CUDA tensors
  against the same ops on the CPU: outputs and the gradients of
  sum(sin(out)) at 1e-4 (fp32, TF32 off and cuDNN deterministic: sums in
  another order); conv2d in bf16 (AMP) at 2e-2.
- SmallNet (32x32, batch 8, ``Momentum(0.01, 0.9)``) through
  ``Executor(CUDAPlace(0))`` from one startup state equals the same 3
  steps on ``CPUPlace``: every loss and persistable within 1e-4.

Every case needs a card and skips without one (``cuda`` marker).
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.models import image as timage

TOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDAPlace and cuDNN have no CPU "
                    "mode")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _run(op, ins, attrs, grad_of, device, dtype=torch.float32):
    info = treg.get_op_info(op)
    full = dict(info.attrs, **attrs)
    live = {s: [torch.from_numpy(a).to(device, dtype)] for s, a in
            ins.items()}
    for s in grad_of:
        live[s][0].requires_grad_(True)
    out = info.compute(live, full, treg.OpContext(attrs=full))
    main = out.get("Output", out.get("Out", out.get("Y")))
    grads = torch.autograd.grad(torch.sum(torch.sin(main.float())),
                                [live[s][0] for s in grad_of])
    return ({k: v.detach().float().cpu() for k, v in out.items()},
            [g.float().cpu() for g in grads])


def _cases():
    r = np.random.RandomState(0)
    x = _rand(r, 4, 8, 15, 15)
    bn = {"X": _rand(r, 8, 16, 7, 7), "Scale": r.rand(16).astype(np.float32)
          + 0.5, "Bias": _rand(r, 16), "Mean": _rand(r, 16) * 0.1,
          "Variance": r.rand(16).astype(np.float32) + 0.5}
    return {
        "conv2d_pad": ("conv2d", {"Input": x, "Filter": _rand(r, 16, 8, 3, 3)},
                       {"paddings": [1, 1]}, ("Input", "Filter")),
        "conv2d_stride_groups_dilation": (
            "conv2d", {"Input": x, "Filter": _rand(r, 16, 4, 3, 3)},
            {"strides": [2, 1], "paddings": [2, 1], "dilations": [2, 1],
             "groups": 2}, ("Input", "Filter")),
        "conv2d_stem_7x7_s2": ("conv2d", {"Input": _rand(r, 2, 3, 32, 32),
                                          "Filter": _rand(r, 16, 3, 7, 7)},
                               {"strides": [2, 2], "paddings": [3, 3]},
                               ("Input", "Filter")),
        "conv2d_transpose": ("conv2d_transpose",
                             {"Input": x, "Filter": _rand(r, 8, 4, 3, 3)},
                             {"strides": [2, 2], "paddings": [1, 1]},
                             ("Input", "Filter")),
        "pool2d_max_3x3_s2_p1": ("pool2d", {"X": x},
                                 {"pooling_type": "max", "ksize": [3, 3],
                                  "strides": [2, 2], "paddings": [1, 1]},
                                 ("X",)),
        "pool2d_avg_3x3_s2": ("pool2d", {"X": x},
                              {"pooling_type": "avg", "ksize": [3, 3],
                               "strides": [2, 2]}, ("X",)),
        "pool2d_avg_exclusive_pad": ("pool2d", {"X": x},
                                     {"pooling_type": "avg",
                                      "ksize": [3, 3], "strides": [1, 1],
                                      "paddings": [1, 1]}, ("X",)),
        "pool2d_global_avg": ("pool2d", {"X": x},
                              {"pooling_type": "avg",
                               "global_pooling": True}, ("X",)),
        "batch_norm_train": ("batch_norm", bn, {}, ("X", "Scale", "Bias")),
        "batch_norm_is_test": ("batch_norm", bn, {"is_test": True},
                               ("X", "Scale", "Bias")),
    }


CASES = _cases()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_op_on_card_matches_cpu(card, name):
    op, ins, attrs, grad_of = CASES[name]
    got, ggrads = _run(op, ins, attrs, grad_of, card)
    want, wgrads = _run(op, ins, attrs, grad_of, torch.device("cpu"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=TOL, rtol=TOL, err_msg=k)
    for s, g, w in zip(grad_of, ggrads, wgrads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL,
                                   rtol=TOL, err_msg="d" + s)


@pytest.mark.cuda
def test_conv2d_bf16_on_card_matches_cpu(card):
    op, ins, attrs, grad_of = CASES["conv2d_pad"]
    got, ggrads = _run(op, ins, attrs, grad_of, card, torch.bfloat16)
    want, wgrads = _run(op, ins, attrs, grad_of, torch.device("cpu"))
    scale = float(want["Output"].abs().max())
    assert float((got["Output"] - want["Output"]).abs().max()) <= \
        BF16_TOL * scale


@contextlib.contextmanager
def _fresh():
    saved = dict(tprog._name_counters)
    tprog._name_counters.clear()
    main, start = pt.Program(), pt.Program()
    try:
        with pt.program_guard(main, start):
            yield main, start
    finally:
        tprog._name_counters.clear()
        tprog._name_counters.update(saved)


@pytest.mark.cuda
def test_smallnet_momentum_steps_on_card_match_cpu(card):
    with _fresh() as (main, start):
        img = pt.layers.data("img", [3, 32, 32])
        label = pt.layers.data("label", [1], dtype="int64")
        _, loss, _ = timage.smallnet_mnist_cifar(img, label)
        pt.optimizer.Momentum(0.01, momentum=0.9).minimize(loss)
    gpu = pt.Executor(pt.CUDAPlace(0))
    a = Scope()
    start.random_seed = 0
    gpu.run(start, scope=a)
    names = sorted(a.local_var_names())
    b = Scope()
    for n in names:
        b.set_tensor(n, a.find_var(n).array.detach().cpu().clone())
    cpu = pt.Executor(pt.CPUPlace())
    rng = np.random.RandomState(0)
    for _ in range(3):
        f = {"img": rng.rand(8, 3, 32, 32).astype(np.float32),
             "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
        (lg,) = gpu.run(main, feed=f, fetch_list=[loss], scope=a)
        (lc,) = cpu.run(main, feed=f, fetch_list=[loss], scope=b)
        np.testing.assert_allclose(lg, lc, atol=TOL, rtol=TOL)
    for n in names:
        np.testing.assert_allclose(a.find_var(n).array.cpu().numpy(),
                                   b.find_var(n).array.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=n)
