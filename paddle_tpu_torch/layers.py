"""The layers DSL — user-facing graph-building functions: the port of the
part of the JAX package's ``layers.py`` that ``models/mnist.py``'s
``mlp`` uses (fluid/layers.py: fc :17 and the op wrappers :308).

Each function appends ops to the default main program and returns the
output Variable, with the JAX package's slots, variable names and
attributes: ``data``, ``fc`` (``mul``, ``sum`` over several inputs, the
bias ``elementwise_add``, the activation), ``softmax`` and ``relu``,
``mean``, ``softmax_with_cross_entropy``, ``accuracy`` (``top_k`` then
``accuracy``) and ``elementwise_add``. The rest of the DSL follows its
ops: embedding and the recurrent layers in ROADMAP A4.3, the rest in A8.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from paddle_tpu_torch.framework.program import Variable, default_main_program
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "data", "fc", "softmax_with_cross_entropy", "accuracy", "mean",
    "elementwise_add", "softmax", "relu", "elementwise_binary_sugar",
]


def data(name: str, shape: Sequence[int], dtype="float32", lod_level: int = 0,
         append_batch_size: bool = True) -> Variable:
    """Declare an input (ref fluid/layers.py data): leading batch dim is
    implicit (-1) unless append_batch_size=False."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().global_block()
    if name in block.vars:
        return block.vars[name]
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            lod_level=lod_level, is_data=True,
                            stop_gradient=True)


def fc(input, size: int, num_flatten_dims: int = 1, param_attr=None,
       bias_attr=None, act: Optional[str] = None, name=None) -> Variable:
    """Fully-connected (ref fluid/layers.py:17; legacy FullMatrixProjection).
    Multiple inputs are projected and summed, as in the reference."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_outs = []
    out_shape = None
    for x in inputs:
        if x.shape is None:
            raise ValueError(
                f"fc input {x.name!r} has no static shape; create it via "
                "layers.data or a shape-propagating layer")
        in_dim = int(np.prod(x.shape[num_flatten_dims:]))
        out_shape = tuple(x.shape[:num_flatten_dims]) + (size,)
        w = helper.create_parameter(param_attr, shape=[in_dim, size],
                                    dtype=x.dtype)
        out = helper.create_tmp_variable(dtype=x.dtype, shape=out_shape,
                                         lod_level=x.lod_level)
        helper.append_op("mul", inputs={"X": x, "Y": w},
                         outputs={"Out": out},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_outs.append(out)
    if len(mul_outs) == 1:
        pre_bias = mul_outs[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype=mul_outs[0].dtype,
                                              shape=out_shape,
                                              lod_level=mul_outs[0].lod_level)
        helper.append_op("sum", inputs={"X": mul_outs},
                         outputs={"Out": pre_bias})
    pre_act = helper.append_bias_op(pre_bias, bias_attr, size)
    return helper.append_activation(pre_act, act)


def softmax_with_cross_entropy(logits, label, soft_label=False, name=None):
    helper = LayerHelper("softmax_with_cross_entropy", name=name)
    softmax_out = helper.create_tmp_variable(dtype=logits.dtype,
                                             shape=logits.shape)
    loss = helper.create_tmp_variable(
        dtype=logits.dtype,
        shape=(logits.shape[0], 1) if logits.shape else None)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": logits, "Label": label},
                     outputs={"Softmax": softmax_out, "Loss": loss},
                     attrs={"soft_label": soft_label})
    return loss


def accuracy(input, label, k=1, name=None):
    """top-k accuracy of prediction `input` (ref fluid accuracy layer)."""
    helper = LayerHelper("accuracy", name=name)
    topk_out = helper.create_tmp_variable(dtype=input.dtype)
    topk_idx = helper.create_tmp_variable(dtype="int32")
    helper.append_op("top_k", inputs={"X": input},
                     outputs={"Out": topk_out, "Indices": topk_idx},
                     attrs={"k": k})
    acc = helper.create_tmp_variable(dtype="float32")
    correct = helper.create_tmp_variable(dtype="int32")
    total = helper.create_tmp_variable(dtype="int32")
    helper.append_op("accuracy",
                     inputs={"Out": topk_out, "Indices": topk_idx,
                             "Label": label},
                     outputs={"Accuracy": acc, "Correct": correct,
                              "Total": total})
    return acc


_SAME = object()  # sentinel: output shape == first input's shape


def _single_out(op_type, inputs, attrs=None, dtype=None, name=None,
                out_slot="Out", lod_level=0, shape=_SAME):
    helper = LayerHelper(op_type, name=name)
    first = next(iter(inputs.values()))
    first = first[0] if isinstance(first, (list, tuple)) else first
    if shape is _SAME:
        shape = first.shape
    out = helper.create_tmp_variable(dtype=dtype or first.dtype,
                                     lod_level=lod_level, shape=shape)
    helper.append_op(op_type, inputs=inputs, outputs={out_slot: out},
                     attrs=attrs or {})
    return out


def mean(x, name=None):
    return _single_out("mean", {"X": x}, name=name, shape=())


def elementwise_add(x, y, axis=-1, act=None, name=None):
    out = _single_out("elementwise_add", {"X": x, "Y": y}, {"axis": axis},
                      name=name)
    if act:
        out = LayerHelper("elementwise_add").append_activation(out, act)
    return out


def _make_unary(op_type):
    def f(x, name=None, **attrs):
        return _single_out(op_type, {"X": x}, attrs, name=name,
                           lod_level=getattr(x, "lod_level", 0))
    f.__name__ = op_type
    f.__doc__ = f"Autogenerated wrapper for the `{op_type}` op."
    return f


softmax = _make_unary("softmax")
relu = _make_unary("relu")


def elementwise_binary_sugar(x, other, op_type, reverse=False):
    """``a + b`` on two Variables appends ``elementwise_add``. The other
    operators and scalar operands need ops the port has not yet: the
    ``scale`` op (ROADMAP A3) and ``elementwise_sub`` / ``_mul`` /
    ``_div`` (A8)."""
    if not isinstance(other, Variable):
        raise NotImplementedError(
            f"{op_type} with a scalar operand appends a scale op, which the "
            "port has not yet (ROADMAP A3)")
    if op_type != "elementwise_add":
        raise NotImplementedError(
            f"the {op_type} op is not ported yet (ROADMAP A8)")
    a, b = (other, x) if reverse else (x, other)
    return elementwise_add(a, b)
