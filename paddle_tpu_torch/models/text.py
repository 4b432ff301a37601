"""The IMDB LSTM text classifier: the port of the JAX package's
``models/text.py`` ``lstm_benchmark_net`` (the reference's RNN benchmark:
embedding -> N stacked LSTMs -> last-step pool -> fc -> softmax
cross-entropy) on one card, with its training step.

The JAX model is a Program built by the layers DSL and run by the
Executor; the port's layers DSL has no LSTM layers yet (ROADMAP A4.3),
so ``program(cfg)`` writes down the ops those layers emit, in their
order, with their slot names, variable names and attributes, and
``forward`` runs them one at a time through
``framework.registry.run_op``, as the Executor's op loop does: LoD
travels with each variable, and under AMP (``Executor(amp=True)``)
every ``amp_compute`` op (``mul``, ``dynamic_lstm``, ``fused_lstm``)
gets bf16 inputs over the fp32 masters and casts its outputs back to
fp32. ``build_program(cfg)`` turns the same op list into a port
``Program`` (startup program, feeds, Adam through
``optimizer.minimize``) for ``framework.executor.Executor``.

With ``fused_proj`` each layer is one ``fused_lstm`` op, which on
uniform lengths runs the input projection inside the recurrence
(``lstm_scan_proj``: B14 / B15 on the card); otherwise, and on ragged
LoD, each layer is ``fc`` (``mul`` + ``elementwise_add``) and
``dynamic_lstm`` (``lstm_scan``: B10 / B11).

Parameters are a flat dict keyed by the JAX Program's parameter names
(``embedding_0.w_0``, ``fused_lstm_0.w_0`` ...), as a fresh process
names them, so ``convert.params_from_jax`` carries a JAX scope over
unchanged. Training is SGD or Adam as the JAX optimizer ops define them
(``ops/optimizer_ops.py``); nothing in a step reads a value back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from paddle_tpu_torch.core.lod import LoDTensor
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.registry import run_op

__all__ = ["TextConfig", "param_specs", "program", "build_program",
           "init_params", "forward", "loss_fn", "SGD", "Adam",
           "make_train_step", "train_flops"]


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """``lstm_benchmark_net``'s arguments; the defaults are bench.py's
    flagship (IMDB dict scale, hidden 512, two layers, the projection in
    the kernel, AMP)."""
    vocab_size: int = 5147
    class_dim: int = 2
    emb_dim: int = 128
    hid_dim: int = 512
    num_layers: int = 2
    fused_proj: bool = True
    # Executor(amp=True): amp_compute ops in bf16 over fp32 masters
    amp: bool = True


def param_specs(cfg: TextConfig) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, initializer) of every parameter, in the order the
    layers create them: ``"xavier"`` (uniform, the LayerHelper default)
    or ``"zeros"`` (biases)."""
    H = cfg.hid_dim
    specs = [("embedding_0.w_0", (cfg.vocab_size, cfg.emb_dim), "xavier")]
    width = cfg.emb_dim
    for i in range(cfg.num_layers):
        if cfg.fused_proj:
            specs += [(f"fused_lstm_{i}.w_0", (width, 4 * H), "xavier"),
                      (f"fused_lstm_{i}.w_1", (H, 4 * H), "xavier"),
                      (f"fused_lstm_{i}.b_0", (1, 4 * H), "zeros")]
        else:
            specs += [(f"fc_{i}.w_0", (width, 4 * H), "xavier"),
                      (f"fc_{i}.b_0", (4 * H,), "zeros"),
                      (f"dynamic_lstm_{i}.w_0", (H, 4 * H), "xavier"),
                      (f"dynamic_lstm_{i}.b_0", (1, 4 * H), "zeros")]
        width = H
    fc = f"fc_{0 if cfg.fused_proj else cfg.num_layers}"
    specs += [(f"{fc}.w_0", (H, cfg.class_dim), "xavier"),
              (f"{fc}.b_0", (cfg.class_dim,), "zeros")]
    return specs


def _fc(name, x, out):
    """``layers.fc`` without activation: mul, then the bias add."""
    mul_out = f"{name}.tmp_0"
    return [("mul", {"X": [x], "Y": [f"{name}.w_0"]}, {"Out": [mul_out]},
             {"x_num_col_dims": 1, "y_num_col_dims": 1}),
            ("elementwise_add", {"X": [mul_out], "Y": [f"{name}.b_0"]},
             {"Out": [out]}, {"axis": 1})]


def program(cfg: TextConfig, seq_lens: bool = False):
    """The ops ``lstm_benchmark_net`` emits, in order: ``(type, inputs,
    outputs, attrs)`` with inputs and outputs mapping slot -> variable
    names. The feed variables are ``words`` (LoD), ``label`` and, with
    ``seq_lens``, ``seq_lens``; the fetches ``loss``, ``prediction`` and
    ``accuracy``."""
    sl = {"SeqLens": ["seq_lens"]} if seq_lens else {}
    ops = [("lookup_table",
            {"W": ["embedding_0.w_0"], "Ids": ["words"]},
            {"Out": ["embedding_0.tmp_0"]},
            {"padding_idx": None, "is_sparse": False})]
    cur = "embedding_0.tmp_0"
    for i in range(cfg.num_layers):
        if cfg.fused_proj:
            n = f"fused_lstm_{i}"
            ops.append(("fused_lstm",
                        {"Input": [cur], "WeightX": [f"{n}.w_0"],
                         "Weight": [f"{n}.w_1"], "Bias": [f"{n}.b_0"], **sl},
                        {"Hidden": [f"{n}.tmp_0"], "Cell": [f"{n}.tmp_1"]},
                        {"is_reverse": False}))
        else:
            n = f"dynamic_lstm_{i}"
            ops += _fc(f"fc_{i}", cur, f"fc_{i}.tmp_1")
            ops.append(("dynamic_lstm",
                        {"Input": [f"fc_{i}.tmp_1"], "Weight": [f"{n}.w_0"],
                         "Bias": [f"{n}.b_0"], **sl},
                        {"Hidden": [f"{n}.tmp_0"], "Cell": [f"{n}.tmp_1"]},
                        {"use_peepholes": False, "is_reverse": False,
                         "gate_activation": "sigmoid",
                         "cell_activation": "tanh",
                         "candidate_activation": "tanh"}))
        cur = f"{n}.tmp_0"
    ops.append(("sequence_pool", {"X": [cur], **sl},
                {"Out": ["last"], "MaxIndex": ["last_index"]},
                {"pooltype": "LAST"}))
    fc = f"fc_{0 if cfg.fused_proj else cfg.num_layers}"
    ops += _fc(fc, "last", "logits")
    ops += [("softmax", {"X": ["logits"]}, {"Out": ["prediction"]},
             {"axis": -1}),
            ("softmax_with_cross_entropy",
             {"Logits": ["logits"], "Label": ["label"]},
             {"Softmax": ["ce_softmax"], "Loss": ["ce_loss"]},
             {"soft_label": False}),
            ("mean", {"X": ["ce_loss"]}, {"Out": ["loss"]}, {}),
            ("top_k", {"X": ["prediction"]},
             {"Out": ["top_out"], "Indices": ["top_idx"]}, {"k": 1}),
            ("accuracy", {"Out": ["top_out"], "Indices": ["top_idx"],
                          "Label": ["label"]},
             {"Accuracy": ["accuracy"], "Correct": ["correct"],
              "Total": ["total"]}, {})]
    return ops


# the op list's integer outputs (everything else is float32)
_INT_OUTPUTS = ("top_idx", "correct", "total", "last_index")


def build_program(cfg: TextConfig, seq_lens: bool = False):
    """``program(cfg, seq_lens)`` as a port ``Program`` pair ``(main,
    startup)``, trained by bench.py's ``Adam(0.002)`` through
    ``optimizer.minimize``: the parameters of ``param_specs`` by
    name, initialized by the startup program (Xavier-uniform, zero
    biases), the feed variables ``words`` (int64, LoD level 1),
    ``label`` (int64) and, with ``seq_lens``, ``seq_lens`` (int32), and
    every op of the list with its slots and attributes. Run it with
    ``Executor(place, amp=cfg.amp)``, fetching ``loss``, ``prediction``
    or ``accuracy``."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework.program import Program, program_guard
    from paddle_tpu_torch.initializer import (ConstantInitializer,
                                              XavierInitializer)
    main, startup = Program(), Program()
    with program_guard(main, startup):
        gb = main.global_block()
        gb.create_var(name="words", shape=[-1, 1], dtype="int64",
                      lod_level=1, is_data=True, stop_gradient=True)
        gb.create_var(name="label", shape=[-1, 1], dtype="int64",
                      is_data=True, stop_gradient=True)
        if seq_lens:
            gb.create_var(name="seq_lens", shape=[-1], dtype="int32",
                          is_data=True, stop_gradient=True)
        for name, shape, init in param_specs(cfg):
            p = gb.create_parameter(shape=shape, dtype="float32", name=name)
            (ConstantInitializer(0.0) if init == "zeros"
             else XavierInitializer())(p)
        for op_type, ins, outs, attrs in program(cfg, seq_lens):
            for names in outs.values():
                for n in names:
                    if n not in gb.vars:
                        gb.create_var(name=n, dtype="int32"
                                      if n in _INT_OUTPUTS else "float32")
            gb.append_op(op_type, ins, outs, attrs)
        optimizer.Adam(0.002).minimize(gb.var("loss"))
    return main, startup


def init_params(cfg: TextConfig, seed: int = 0,
                device=None) -> Dict[str, torch.Tensor]:
    """Random fp32 params from a ``torch.Generator`` on ``device`` (the
    card by default; ``"cpu"`` when asked for): the JAX Program's names,
    shapes and initializers (Glorot uniform over (fan_in, fan_out) =
    the first two dims, zero biases); the numbers differ (another
    generator), so tests copy weights across with
    ``convert.params_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    out = {}
    for name, shape, init in param_specs(cfg):
        if init == "zeros":
            out[name] = torch.zeros(shape, dtype=torch.float32, device=dev)
            continue
        limit = math.sqrt(6.0 / (shape[0] + shape[1]))
        out[name] = (torch.rand(shape, generator=gen, device=dev,
                                dtype=torch.float32) * 2.0 - 1.0) * limit
    return out


def forward(params: Dict[str, Any], feed: Dict[str, Any], cfg: TextConfig,
            fetch=("loss", "prediction", "accuracy")):
    """Run the program over ``feed`` (``words``: a ``LoDTensor`` of int
    ids [total, 1]; ``label`` [B, 1] int; optionally ``seq_lens`` [B]
    int) with ``params``; returns the fetched variables (a dict)."""
    env = dict(params)
    lods = {}
    for k, v in feed.items():
        if isinstance(v, LoDTensor):
            env[k] = v.array
            lods[k] = v.lod
        else:
            env[k] = v
    for op_type, ins, outs, attrs in program(cfg, "seq_lens" in feed):
        got, out_lods = run_op(
            op_type, {s: [env[n] for n in names] for s, names in ins.items()},
            attrs, {s: [lods.get(n) for n in names]
                    for s, names in ins.items()}, amp=cfg.amp)
        for slot, names in outs.items():
            for i, n in enumerate(names):
                if slot in got and i < len(got[slot]):
                    env[n] = got[slot][i]
                    lod = out_lods[slot][i]
                    if lod:
                        lods[n] = lod
                    else:
                        lods.pop(n, None)
    return {k: env[k] for k in fetch}


def loss_fn(params, feed, cfg: TextConfig):
    """The mean softmax cross-entropy: a 0-d fp32 tensor."""
    return forward(params, feed, cfg, fetch=("loss",))["loss"]


class SGD:
    """``sgd``: ``p - lr * g`` with lr the fp32 learning-rate variable."""

    def __init__(self, lr=0.01):
        self.lr = lr

    def init(self, params):
        p0 = next(iter(params.values()))
        return {"lr": torch.full((), self.lr, dtype=torch.float32,
                                 device=p0.device)}

    def update(self, grads, state, params):
        lr = state["lr"]
        return {k: params[k] - lr.to(params[k].dtype) * grads[k]
                for k in params}, state


class Adam:
    """``adam`` as the JAX op defines it (``ops/optimizer_ops.py``):
    ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)`` with the powers kept as
    fp32 accumulators multiplied once per step, and ``eps`` outside the
    square root: ``p - lr_t * m / (sqrt(v) + eps)``. (The seq2seq
    ``_Adam`` is another formula: its eps sits inside the bias
    correction.)"""

    def __init__(self, lr=0.001, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params):
        p0 = next(iter(params.values()))

        def scalar(v):
            return torch.full((), v, dtype=torch.float32, device=p0.device)

        return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
                "v": {k: torch.zeros_like(v) for k, v in params.items()},
                "b1p": scalar(1.0), "b2p": scalar(1.0),
                "lr": scalar(self.lr)}

    def update(self, grads, state, params):
        b1, b2 = self.b1, self.b2
        b1p, b2p = state["b1p"] * b1, state["b2p"] * b2
        lr_t = state["lr"] * torch.sqrt(1 - b2p) / (1 - b1p)
        m = {k: b1 * state["m"][k] + (1 - b1) * grads[k] for k in params}
        v = {k: b2 * state["v"][k] + (1 - b2) * grads[k] * grads[k]
             for k in params}
        new = {k: params[k] - lr_t * m[k] / (torch.sqrt(v[k]) + self.eps)
               for k in params}
        return new, {"m": m, "v": v, "b1p": b1p, "b2p": b2p,
                     "lr": state["lr"]}


def make_train_step(cfg: TextConfig, optimizer="adam", lr=0.002):
    """A train step over one feed: returns ``(opt, step)`` with
    ``step(params, opt_state, feed) -> (params, opt_state, loss,
    accuracy)`` (new dicts; loss and accuracy stay on the device).
    ``optimizer``: ``"adam"`` (bench.py's ``Adam(0.002)``) or
    ``"sgd"``."""
    opt = {"adam": Adam, "sgd": SGD}[optimizer](lr)

    def step(params, opt_state, feed):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            out = forward(live, feed, cfg, fetch=("loss", "accuracy"))
            grads = dict(zip(live, torch.autograd.grad(
                out["loss"], list(live.values()))))
        with torch.no_grad():
            params, opt_state = opt.update(grads, opt_state, params)
        return (params, opt_state, out["loss"].detach(),
                out["accuracy"].detach())

    return opt, step


def train_flops(cfg: TextConfig, batch: int, seq_len: int) -> float:
    """bench.py's ``_lstm_flops_per_batch``: 4 gates x (in + hid) x hid
    multiply-adds per step per layer per sample, 2 FLOPs each, backward
    twice the forward."""
    H = cfg.hid_dim
    per_step = sum(8 * H * ((cfg.emb_dim if i == 0 else H) + H)
                   for i in range(cfg.num_layers))
    return 3.0 * per_step * seq_len * batch
