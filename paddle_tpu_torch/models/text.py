"""Text models: the port of the JAX package's ``models/text.py``, the
nets built by the layers DSL (``lstm_benchmark_net``,
``stacked_lstm_net``, ``convolution_net``, ``word2vec_net``), and the
IMDB LSTM classifier written down op by op with its training step.

The DSL nets append their ops to the default main program exactly as
the JAX package's do (the same op list, variable and parameter names,
shapes and ``fingerprint`` from cleared name counters), for a Program
run by ``Executor`` or trained by ``Trainer``.

``lstm_benchmark_net`` is also written down by hand: ``program(cfg)``
lists the ops it emits (the reference's RNN benchmark: embedding -> N
stacked LSTMs -> last-step pool -> fc -> softmax cross-entropy), in
their order, with their slot names, variable names and attributes, and
``build_program(cfg)`` makes a ``Program`` of that list (variables
declared with the DSL's shapes, startup program, Adam through
``optimizer.minimize``) that the DSL-built net is held to. ``forward``
runs the list one op at a time through ``framework.registry.run_op``,
as the Executor's op loop does: LoD travels with each variable, and
under AMP (``Executor(amp=True)``) every ``amp_compute`` op (``mul``,
``dynamic_lstm``, ``fused_lstm``) gets bf16 inputs over the fp32
masters and casts its outputs back to fp32.

With ``fused_proj`` each layer is one ``fused_lstm`` op, which on
uniform lengths runs the input projection inside the recurrence
(``lstm_scan_proj``: B14 / B15 on the card); otherwise, and on ragged
LoD, each layer is ``fc`` (``mul`` + ``elementwise_add``) and
``dynamic_lstm`` (``lstm_scan``: B10 / B11).

Parameters are a flat dict keyed by the JAX Program's parameter names
(``embedding_0.w_0``, ``fused_lstm_0.w_0`` ...), as a fresh process
names them, so ``convert.params_from_jax`` carries a JAX scope over
unchanged. The fetches keep the DSL's names (``LOSS``, ``PREDICTION``,
``ACCURACY``); ``forward`` also takes them as ``"loss"``,
``"prediction"`` and ``"accuracy"``. Training is SGD or Adam as the JAX
optimizer ops define them (``ops/optimizer_ops.py``); nothing in a step
reads a value back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from paddle_tpu_torch import layers, nets
from paddle_tpu_torch.core.lod import LoDTensor
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.framework.registry import run_op

__all__ = ["TextConfig", "param_specs", "program", "variables",
           "build_program", "init_params", "forward", "loss_fn", "SGD",
           "Adam", "make_train_step", "train_flops", "LOSS", "PREDICTION",
           "ACCURACY", "convolution_net", "stacked_lstm_net",
           "lstm_benchmark_net", "word2vec_net"]

# the DSL's names of the classifier's fetches
LOSS = "mean_0.tmp_0"
PREDICTION = "softmax_0.tmp_0"
ACCURACY = "accuracy_0.tmp_2"
_FETCH = {"loss": LOSS, "prediction": PREDICTION, "accuracy": ACCURACY}
_POOL, _POOL_INDEX = "sequence_pool_0.tmp_0", "sequence_pool_0.tmp_1"
_SCE = "softmax_with_cross_entropy_0"


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


def _fc(name, x):
    """``layers.fc`` without activation: mul, then the bias add; its
    output is ``{name}.tmp_1``."""
    return [("mul", {"X": [x], "Y": [f"{name}.w_0"]},
             {"Out": [f"{name}.tmp_0"]},
             {"x_num_col_dims": 1, "y_num_col_dims": 1}),
            ("elementwise_add", {"X": [f"{name}.tmp_0"],
                                 "Y": [f"{name}.b_0"]},
             {"Out": [f"{name}.tmp_1"]}, {"axis": 1})]


def _head_fc(cfg):
    return f"fc_{0 if cfg.fused_proj else cfg.num_layers}"


def program(cfg: TextConfig, seq_lens: bool = False):
    """The ops ``lstm_benchmark_net`` emits, in order: ``(type, inputs,
    outputs, attrs)`` with inputs and outputs mapping slot -> variable
    names (the DSL's). The feed variables are ``words`` (LoD),
    ``label`` and, with ``seq_lens``, ``seq_lens``; the fetches
    ``LOSS``, ``PREDICTION`` and ``ACCURACY``."""
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
            ops += _fc(f"fc_{i}", cur)
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
                {"Out": [_POOL], "MaxIndex": [_POOL_INDEX]},
                {"pooltype": "LAST"}))
    fc = _head_fc(cfg)
    logits = f"{fc}.tmp_1"
    ops += _fc(fc, _POOL)
    ops += [("softmax", {"X": [logits]}, {"Out": [PREDICTION]}, {}),
            ("softmax_with_cross_entropy",
             {"Logits": [logits], "Label": ["label"]},
             {"Softmax": [f"{_SCE}.tmp_0"], "Loss": [f"{_SCE}.tmp_1"]},
             {"soft_label": False}),
            ("mean", {"X": [f"{_SCE}.tmp_1"]}, {"Out": [LOSS]}, {}),
            ("top_k", {"X": [PREDICTION]},
             {"Out": ["accuracy_0.tmp_0"], "Indices": ["accuracy_0.tmp_1"]},
             {"k": 1}),
            ("accuracy", {"Out": ["accuracy_0.tmp_0"],
                          "Indices": ["accuracy_0.tmp_1"],
                          "Label": ["label"]},
             {"Accuracy": [ACCURACY], "Correct": ["accuracy_0.tmp_3"],
              "Total": ["accuracy_0.tmp_4"]}, {})]
    return ops


def variables(cfg: TextConfig) -> Dict[str, Tuple[Any, str, int]]:
    """``(shape, dtype, lod_level)`` of each variable ``program(cfg)``'s
    ops write, as the DSL's layers declare them."""
    H, C = cfg.hid_dim, cfg.class_dim
    out = {"embedding_0.tmp_0": ((-1, cfg.emb_dim), "float32", 1)}
    for i in range(cfg.num_layers):
        if cfg.fused_proj:
            n = f"fused_lstm_{i}"
        else:
            n = f"dynamic_lstm_{i}"
            out[f"fc_{i}.tmp_0"] = out[f"fc_{i}.tmp_1"] = (
                (-1, 4 * H), "float32", 1)
        out[f"{n}.tmp_0"] = out[f"{n}.tmp_1"] = ((-1, H), "float32", 1)
    fc = _head_fc(cfg)
    out.update({
        _POOL: ((-1, H), "float32", 0), _POOL_INDEX: (None, "int64", 0),
        f"{fc}.tmp_0": ((-1, C), "float32", 0),
        f"{fc}.tmp_1": ((-1, C), "float32", 0),
        PREDICTION: ((-1, C), "float32", 0),
        f"{_SCE}.tmp_0": ((-1, C), "float32", 0),
        f"{_SCE}.tmp_1": ((-1, 1), "float32", 0),
        LOSS: ((), "float32", 0),
        "accuracy_0.tmp_0": (None, "float32", 0),
        "accuracy_0.tmp_1": (None, "int32", 0),
        ACCURACY: (None, "float32", 0),
        "accuracy_0.tmp_3": (None, "int32", 0),
        "accuracy_0.tmp_4": (None, "int32", 0)})
    return out


def build_program(cfg: TextConfig, seq_lens: bool = False):
    """``program(cfg, seq_lens)`` as a port ``Program`` pair ``(main,
    startup)``, trained by bench.py's ``Adam(0.002)`` through
    ``optimizer.minimize``: the parameters of ``param_specs`` by
    name, initialized by the startup program (Xavier-uniform, zero
    biases), the feed variables ``words`` (int64, LoD level 1),
    ``label`` (int64) and, with ``seq_lens``, ``seq_lens`` (int32), the
    variables of ``variables(cfg)`` and every op of the list with its
    slots and attributes: the Program ``lstm_benchmark_net`` builds
    through the layers DSL, op for op and name for name. Run it with
    ``Executor(place, amp=cfg.amp)``, fetching ``LOSS``, ``PREDICTION``
    or ``ACCURACY``."""
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
        specs = variables(cfg)
        for op_type, ins, outs, attrs in program(cfg, seq_lens):
            for names in outs.values():
                for n in names:
                    shape, dtype, lod_level = specs[n]
                    gb.create_var(name=n, shape=shape, dtype=dtype,
                                  lod_level=lod_level)
            gb.append_op(op_type, ins, outs, attrs)
        optimizer.Adam(0.002).minimize(gb.var(LOSS))
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
    int) with ``params``; returns the fetched variables (a dict keyed as
    ``fetch`` names them: ``"loss"``, ``"prediction"``, ``"accuracy"``
    or a variable's name)."""
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
    return {k: env[_FETCH.get(k, k)] for k in fetch}


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


# ------------------------------------------------------ the DSL-built nets

def convolution_net(data, label, input_dim, class_dim=2, emb_dim=32,
                    hid_dim=32):
    """Sentiment conv net (ref book understand_sentiment conv)."""
    emb = layers.embedding(data, size=[input_dim, emb_dim])
    conv3 = nets.sequence_conv_pool(emb, hid_dim, 3, act="tanh")
    conv4 = nets.sequence_conv_pool(emb, hid_dim, 4, act="tanh")
    logits = layers.fc([conv3, conv4], class_dim)
    prediction = layers.softmax(logits)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(prediction, label)
    return prediction, loss, acc


def stacked_lstm_net(data, label, input_dim, class_dim=2, emb_dim=128,
                     hid_dim=128, stacked_num=3):
    """Stacked LSTM sentiment net (ref book understand_sentiment stacked
    lstm): every even layer runs reversed."""
    emb = layers.embedding(data, size=[input_dim, emb_dim])
    fc1 = layers.fc(emb, hid_dim * 4)
    lstm1, _ = layers.dynamic_lstm(fc1, hid_dim * 4)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(inputs, hid_dim * 4)
        lstm, _ = layers.dynamic_lstm(fc, hid_dim * 4,
                                      is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(inputs[0], "max")
    lstm_last = layers.sequence_pool(inputs[1], "max")
    logits = layers.fc([fc_last, lstm_last], class_dim)
    prediction = layers.softmax(logits)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(prediction, label)
    return prediction, loss, acc


def lstm_benchmark_net(data, label, input_dim, class_dim=2, emb_dim=128,
                       hid_dim=512, num_layers=2, seq_lens=None,
                       fused_proj=False):
    """The reference's RNN benchmark topology: embedding -> N stacked
    LSTMs -> last-step pool -> fc softmax. ``seq_lens``: optional [B]
    int variable of runtime valid lengths for bucketed ragged batches.
    ``fused_proj``: each layer one ``fused_lstm`` (the projection inside
    the recurrence kernels, B14 / B15, on uniform batches), else ``fc``
    + ``dynamic_lstm`` (B10 / B11). ``program(TextConfig(...))`` lists
    the ops this builds."""
    emb = layers.embedding(data, size=[input_dim, emb_dim])
    cur = emb
    for _ in range(num_layers):
        if fused_proj:
            cur, _ = layers.fused_lstm(cur, hid_dim, seq_lens=seq_lens)
        else:
            proj = layers.fc(cur, hid_dim * 4)
            cur, _ = layers.dynamic_lstm(proj, hid_dim * 4,
                                         seq_lens=seq_lens)
    last = layers.sequence_pool(cur, "last", seq_lens=seq_lens)
    logits = layers.fc(last, class_dim)
    prediction = layers.softmax(logits)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(prediction, label)
    return prediction, loss, acc


def word2vec_net(words, next_word, dict_size, emb_dim=32, hid_dim=256,
                 n_gram=4):
    """N-gram language model (ref book test_word2vec): the n words'
    embeddings share one table."""
    embs = [layers.embedding(w, size=[dict_size, emb_dim],
                             param_attr="shared_w") for w in words]
    concat = layers.concat(embs, axis=1)
    hidden = layers.fc(concat, hid_dim, act="sigmoid")
    logits = layers.fc(hidden, dict_size)
    prediction = layers.softmax(logits)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, next_word))
    return prediction, loss
