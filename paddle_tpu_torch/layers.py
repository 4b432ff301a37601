"""The layers DSL — user-facing graph-building functions: the port of the
part of the JAX package's ``layers.py`` that the MNIST MLP, the text
nets (``models/text.py``), ``nets.py`` and the book models
(``models/book.py``) use (fluid/layers.py: fc :17, embedding :91 and
the op wrappers :308).

Each function appends ops to the default main program and returns the
output Variable, with the JAX package's slots, variable names,
parameter names, initializers and attributes: ``data``, ``fc``
(``mul``, ``sum`` over several inputs, the bias ``elementwise_add``, the
activation), ``embedding``, ``softmax`` / ``relu`` / ``sigmoid`` /
``tanh``, ``mean``, ``concat``, ``split``, ``matmul``, ``scale``, the
elementwise ops, ``softmax_with_cross_entropy``, ``square_error_cost``,
``accuracy`` (``top_k`` then ``accuracy``), the sequence layers
``sequence_pool`` (with runtime ``seq_lens``) and ``sequence_conv``, the
recurrent layers ``dynamic_lstm``, ``fused_lstm`` and ``dynamic_gru``,
and the image layers of the JAX package's ``ops/nn.py`` (``conv2d``,
``conv2d_transpose``, ``pool2d``, ``batch_norm``, ``layer_norm``,
``dropout``, ``lrn``, ``pad``, ``max_pool2d_with_index``, ``unpool``,
``spp``, ``conv3d``, ``conv3d_transpose``, ``pool3d``, ``selective_fc``,
``sampling_id``) with ``reshape`` and ``transpose``. The rest of the DSL
(the other losses and sequence ops, control flow) is ROADMAP A8's.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from paddle_tpu_torch.framework.program import Variable, default_main_program
from paddle_tpu_torch.initializer import (ConstantInitializer,
                                          NormalInitializer)
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "data", "fc", "embedding", "softmax_with_cross_entropy",
    "square_error_cost", "accuracy", "mean", "concat", "split", "matmul",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "scale", "sequence_pool", "sequence_first_step",
    "sequence_last_step", "sequence_conv", "dynamic_lstm", "fused_lstm",
    "dynamic_gru", "maxout",
    "elementwise_binary_sugar", "conv2d", "conv2d_transpose", "pool2d",
    "batch_norm", "layer_norm", "dropout", "reshape", "transpose", "lrn",
    "pad", "max_pool2d_with_index", "unpool", "spp", "conv3d",
    "conv3d_transpose", "pool3d", "selective_fc", "sampling_id",
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


def embedding(input, size: Sequence[int], param_attr=None, dtype="float32",
              is_sparse: bool = False, padding_idx=None, name=None) -> Variable:
    """(ref fluid/layers.py:91 embedding; lookup_table_op.cc)."""
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    ishape = tuple(input.shape) if input.shape else (-1, 1)
    eshape = (ishape[:-1] if ishape[-1] == 1 else ishape) + (size[1],)
    out = helper.create_tmp_variable(dtype=dtype, lod_level=input.lod_level,
                                     shape=eshape)
    helper.append_op("lookup_table", inputs={"W": w, "Ids": input},
                     outputs={"Out": out},
                     attrs={"padding_idx": padding_idx, "is_sparse": is_sparse})
    return out


# ---------------------------------------------------------------------------
# image layers


def _conv_out_dim(in_dim, k, s, p, d=1):
    if in_dim is None or in_dim < 0:
        return -1
    return (in_dim + 2 * p - (d * (k - 1) + 1)) // s + 1


def conv2d(input, num_filters: int, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           act: Optional[str] = None, name=None) -> Variable:
    """(ref fluid/layers.py:660 conv2d; conv_op.cc). NCHW; the filter
    [num_filters, C / groups, kh, kw] from N(0, sqrt(2 / (kh kw C)))."""
    helper = LayerHelper("conv2d", name=name)
    fsize = filter_size if isinstance(filter_size, (list, tuple)) else (
        filter_size, filter_size)
    num_channels = input.shape[1]
    w_shape = [num_filters, num_channels // groups, fsize[0], fsize[1]]
    std = math.sqrt(2.0 / (fsize[0] * fsize[1] * num_channels))
    w = helper.create_parameter(param_attr, shape=w_shape, dtype=input.dtype,
                                default_initializer=NormalInitializer(0.0, std))
    strides = list(stride) if isinstance(stride, (list, tuple)) else [stride, stride]
    paddings = list(padding) if isinstance(padding, (list, tuple)) else [padding, padding]
    dilations = list(dilation) if isinstance(dilation, (list, tuple)) else [dilation, dilation]
    out_shape = None
    if input.shape is not None and len(input.shape) == 4:
        n, _, h, w_in = input.shape
        oh = _conv_out_dim(h, fsize[0], strides[0], paddings[0], dilations[0])
        ow = _conv_out_dim(w_in, fsize[1], strides[1], paddings[1], dilations[1])
        out_shape = (n, num_filters, oh, ow)
    out = helper.create_tmp_variable(dtype=input.dtype, shape=out_shape)
    helper.append_op(
        "conv2d", inputs={"Input": input, "Filter": w},
        outputs={"Output": out},
        attrs={"strides": strides, "paddings": paddings,
               "dilations": dilations, "groups": groups})
    pre_act = helper.append_bias_op(out, bias_attr, num_filters, dim_start=1)
    return helper.append_activation(pre_act, act)


def conv2d_transpose(input, num_filters: int, filter_size, stride=1, padding=0,
                     param_attr=None, bias_attr=False, act=None, name=None):
    helper = LayerHelper("conv2d_transpose", name=name)
    fsize = filter_size if isinstance(filter_size, (list, tuple)) else (
        filter_size, filter_size)
    w = helper.create_parameter(
        param_attr, shape=[input.shape[1], num_filters, fsize[0], fsize[1]],
        dtype=input.dtype)
    st = [stride, stride] if isinstance(stride, int) else list(stride)
    pd = [padding, padding] if isinstance(padding, int) else list(padding)
    out_shape = None
    if input.shape is not None and len(input.shape) == 4:
        n, _, h, w_in = input.shape
        oh = -1 if h < 0 else (h - 1) * st[0] + fsize[0] - 2 * pd[0]
        ow = -1 if w_in < 0 else (w_in - 1) * st[1] + fsize[1] - 2 * pd[1]
        out_shape = (n, num_filters, oh, ow)
    out = helper.create_tmp_variable(dtype=input.dtype, shape=out_shape)
    helper.append_op(
        "conv2d_transpose", inputs={"Input": input, "Filter": w},
        outputs={"Output": out},
        attrs={"strides": st, "paddings": pd})
    pre_act = helper.append_bias_op(out, bias_attr, num_filters, dim_start=1)
    return helper.append_activation(pre_act, act)


def pool2d(input, pool_size=2, pool_type="max", pool_stride=None,
           pool_padding=0, global_pooling=False, name=None) -> Variable:
    helper = LayerHelper("pool2d", name=name)
    if pool_stride is None:
        pool_stride = pool_size
    out_shape = None
    if input.shape is not None and len(input.shape) == 4:
        n, c, h, w = input.shape
        if global_pooling:
            out_shape = (n, c, 1, 1)
        else:
            ks = pool_size if isinstance(pool_size, (list, tuple)) else (pool_size, pool_size)
            st = pool_stride if isinstance(pool_stride, (list, tuple)) else (pool_stride, pool_stride)
            pd = pool_padding if isinstance(pool_padding, (list, tuple)) else (pool_padding, pool_padding)
            out_shape = (n, c, _conv_out_dim(h, ks[0], st[0], pd[0]),
                         _conv_out_dim(w, ks[1], st[1], pd[1]))
    out = helper.create_tmp_variable(dtype=input.dtype, shape=out_shape)
    helper.append_op(
        "pool2d", inputs={"X": input}, outputs={"Out": out},
        attrs={"pooling_type": pool_type,
               "ksize": [pool_size, pool_size] if isinstance(pool_size, int) else list(pool_size),
               "strides": [pool_stride, pool_stride] if isinstance(pool_stride, int) else list(pool_stride),
               "paddings": [pool_padding, pool_padding] if isinstance(pool_padding, int) else list(pool_padding),
               "global_pooling": global_pooling})
    return out


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5, param_attr=None,
               bias_attr=None, is_test=False, name=None) -> Variable:
    """(ref fluid/layers.py:792 batch_norm): fp32 Scale (1) and Bias (0)
    parameters; the running mean (0) and variance (1) are persistable
    global variables, not parameters, which the op writes back
    (MeanOut / VarianceOut name them)."""
    helper = LayerHelper("batch_norm", name=name)
    c = input.shape[1] if len(input.shape) > 1 else input.shape[-1]
    scale = helper.create_parameter(param_attr, shape=[c], dtype="float32",
                                    default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype="float32",
                                   is_bias=True)
    mean = helper.create_global_variable(shape=[c], dtype="float32")
    var = helper.create_global_variable(shape=[c], dtype="float32")
    ConstantInitializer(0.0)(mean)
    ConstantInitializer(1.0)(var)
    saved_mean = helper.create_tmp_variable(dtype="float32", shape=(c,))
    saved_var = helper.create_tmp_variable(dtype="float32", shape=(c,))
    out = helper.create_tmp_variable(dtype=input.dtype, shape=input.shape)
    helper.append_op(
        "batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
                "Variance": var},
        outputs={"Y": out, "MeanOut": mean, "VarianceOut": var,
                 "SavedMean": saved_mean, "SavedVariance": saved_var},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test})
    return helper.append_activation(out, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, name=None):
    helper = LayerHelper("layer_norm", name=name)
    d = int(np.prod(input.shape[begin_norm_axis:]))
    inputs = {"X": input}
    if scale:
        inputs["Scale"] = helper.create_parameter(
            param_attr, shape=[d], dtype="float32",
            default_initializer=ConstantInitializer(1.0))
    if shift:
        inputs["Bias"] = helper.create_parameter(
            bias_attr, shape=[d], dtype="float32", is_bias=True)
    out = helper.create_tmp_variable(dtype=input.dtype, shape=input.shape)
    mean = helper.create_tmp_variable(dtype="float32")
    var = helper.create_tmp_variable(dtype="float32")
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": out, "Mean": mean, "Variance": var},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return out


def dropout(x, dropout_prob=0.5, is_test=False, seed=0, name=None):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape,
                                     lod_level=x.lod_level)
    mask = helper.create_tmp_variable(dtype=x.dtype, shape=x.shape)
    helper.append_op("dropout", inputs={"X": x},
                     outputs={"Out": out, "Mask": mask},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": seed})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_tmp_variable(dtype=input.dtype, shape=input.shape)
    mid = helper.create_tmp_variable(dtype=input.dtype, shape=input.shape)
    helper.append_op("lrn", inputs={"X": input},
                     outputs={"Out": out, "MidOut": mid},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def max_pool2d_with_index(input, ksize, strides=None, paddings=(0, 0),
                          name=None):
    helper = LayerHelper("max_pool2d_with_index", name=name)
    out = helper.create_tmp_variable(dtype=input.dtype, shape=None)
    mask = helper.create_tmp_variable(dtype="int32", shape=None)
    helper.append_op(
        "max_pool2d_with_index", inputs={"X": input},
        outputs={"Out": out, "Mask": mask},
        attrs={"ksize": list(ksize), "strides": list(strides or ksize),
               "paddings": list(paddings), "global_pooling": False})
    return out, mask


def _conv3d_common(op_type, input, num_filters, filter_size, stride, padding,
                   dilation, groups, param_attr, bias_attr, act, name,
                   transpose=False):
    helper = LayerHelper(op_type, name=name)
    fs = (list(filter_size) if isinstance(filter_size, (list, tuple))
          else [filter_size] * 3)
    num_channels = input.shape[1]
    if transpose:
        w_shape = [num_channels, num_filters] + fs
    else:
        w_shape = [num_filters, num_channels // groups] + fs
    std = math.sqrt(2.0 / (fs[0] * fs[1] * fs[2] * num_channels))
    w = helper.create_parameter(param_attr, shape=w_shape, dtype=input.dtype,
                                default_initializer=NormalInitializer(0.0, std))
    st = list(stride) if isinstance(stride, (list, tuple)) else [stride] * 3
    pd = list(padding) if isinstance(padding, (list, tuple)) else [padding] * 3
    dl = list(dilation) if isinstance(dilation, (list, tuple)) else [dilation] * 3
    out_shape = None
    if input.shape is not None and len(input.shape) == 5:
        n = input.shape[0]
        dims = []
        for i in range(3):
            d_in = input.shape[2 + i]
            if transpose:
                dims.append((d_in - 1) * st[i] - 2 * pd[i]
                            + dl[i] * (fs[i] - 1) + 1)
            else:
                dims.append(_conv_out_dim(d_in, fs[i], st[i], pd[i], dl[i]))
        out_shape = (n, num_filters) + tuple(dims)
    out = helper.create_tmp_variable(dtype=input.dtype, shape=out_shape)
    attrs = {"strides": st, "paddings": pd, "dilations": dl}
    if not transpose:
        attrs["groups"] = groups
    helper.append_op(op_type, inputs={"Input": input, "Filter": w},
                     outputs={"Output": out}, attrs=attrs)
    pre = helper.append_bias_op(out, bias_attr, num_filters, dim_start=1)
    return helper.append_activation(pre, act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None):
    """NCDHW 3D convolution (ref Conv3DLayer.cpp; conv_op.cc 3D)."""
    return _conv3d_common("conv3d", input, num_filters, filter_size, stride,
                          padding, dilation, groups, param_attr, bias_attr,
                          act, name)


def conv3d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     dilation=1, param_attr=None, bias_attr=False, act=None,
                     name=None):
    """(ref DeConv3DLayer.cpp; conv_transpose_op.cc 3D)."""
    return _conv3d_common("conv3d_transpose", input, num_filters, filter_size,
                          stride, padding, dilation, 1, param_attr, bias_attr,
                          act, name, transpose=True)


def selective_fc(input, size: int, selection, param_attr=None, act=None,
                 name=None):
    """Compute only the selected columns of a big fc output
    (ref SelectiveFullyConnectedLayer.cpp). ``selection`` [B, K] int."""
    helper = LayerHelper("selective_fc", name=name)
    w = helper.create_parameter(param_attr, shape=[input.shape[-1], size],
                                dtype=input.dtype)
    shape = None
    if input.shape is not None and selection.shape is not None:
        shape = (input.shape[0], selection.shape[-1])
    out = helper.create_tmp_variable(dtype=input.dtype, shape=shape)
    helper.append_op("selective_fc",
                     inputs={"X": input, "W": w, "Selection": selection},
                     outputs={"Out": out})
    return helper.append_activation(out, act)


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


def square_error_cost(input, label, name=None):
    helper = LayerHelper("square_error_cost", name=name)
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op("square_error_cost", inputs={"X": input, "Y": label},
                     outputs={"Out": out})
    return out


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


def concat(input: List[Variable], axis=0, name=None):
    shape = None
    shapes = [v.shape for v in input]
    if all(sh is not None for sh in shapes):
        shape = list(shapes[0])
        ax = axis if axis >= 0 else len(shape) + axis
        dims = [sh[ax] for sh in shapes]
        shape[ax] = -1 if any(d < 0 for d in dims) else sum(dims)
        shape = tuple(shape)
    return _single_out("concat", {"X": list(input)}, {"axis": axis}, name=name,
                       shape=shape)


def split(input, num_or_sections, dim=0, name=None):
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "sections": None, "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    shapes = [None] * n
    if input.shape is not None:
        ax = dim if dim >= 0 else len(input.shape) + dim
        if isinstance(num_or_sections, int):
            secs = [input.shape[ax] // n if input.shape[ax] >= 0 else -1] * n
        else:
            secs = list(num_or_sections)
        shapes = [tuple(sec if i == ax else d
                        for i, d in enumerate(input.shape))
                  for sec in secs]
    outs = [helper.create_tmp_variable(dtype=input.dtype, shape=sh)
            for sh in shapes]
    helper.append_op("split", inputs={"X": input}, outputs={"Out": outs},
                     attrs=attrs)
    return outs


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    shape = None
    if (x.shape is not None and y.shape is not None and len(x.shape) >= 2
            and len(y.shape) >= 2):
        m = x.shape[-1] if transpose_x else x.shape[-2]
        n = y.shape[-2] if transpose_y else y.shape[-1]
        shape = tuple(x.shape[:-2]) + (m, n)
    return _single_out("matmul", {"X": x, "Y": y},
                       {"transpose_X": transpose_x, "transpose_Y": transpose_y,
                        "alpha": alpha}, name=name, shape=shape)


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    out = _single_out(op_type, {"X": x, "Y": y}, {"axis": axis}, name=name)
    if act:
        out = LayerHelper(op_type).append_activation(out, act)
    return out


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, name=None):
    return _single_out("scale", {"X": x},
                       {"scale": float(scale), "bias": float(bias),
                        "bias_after_scale": bias_after_scale}, name=name)


def reshape(x, shape, name=None):
    out_shape = [x.shape[i] if (s == 0 and x.shape is not None) else s
                 for i, s in enumerate(shape)]
    return _single_out("reshape", {"X": x}, {"shape": list(shape)}, name=name,
                       shape=tuple(out_shape))


def transpose(x, perm, name=None):
    shape = tuple(x.shape[i] for i in perm) if x.shape is not None else None
    return _single_out("transpose", {"X": x}, {"axis": list(perm)}, name=name,
                       shape=shape)


def pad(x, paddings, pad_value=0.0, name=None):
    return _single_out("pad", {"X": x},
                       {"paddings": list(paddings), "pad_value": pad_value},
                       name=name)


def unpool(input, indices, ksize, strides=None, paddings=(0, 0), name=None):
    return _single_out(
        "unpool", {"X": input, "Indices": indices},
        {"ksize": list(ksize), "strides": list(strides or ksize),
         "paddings": list(paddings)}, name=name, shape=None)


def spp(input, pyramid_height=2, pooling_type="max", name=None):
    shape = None
    if input.shape is not None:
        bins = sum(4 ** lv for lv in range(pyramid_height))
        shape = (input.shape[0], input.shape[1] * bins)
    return _single_out("spp", {"X": input},
                       {"pyramid_height": pyramid_height,
                        "pooling_type": pooling_type}, name=name, shape=shape)


def pool3d(input, pool_size=2, pool_type="max", pool_stride=2, pool_padding=0,
           global_pooling=False, name=None):
    """(ref Pool3DLayer.cpp; pool_op.cc 3D)."""
    ks = (list(pool_size) if isinstance(pool_size, (list, tuple))
          else [pool_size] * 3)
    st = (list(pool_stride) if isinstance(pool_stride, (list, tuple))
          else [pool_stride] * 3)
    pd = (list(pool_padding) if isinstance(pool_padding, (list, tuple))
          else [pool_padding] * 3)
    shape = None
    if input.shape is not None and len(input.shape) == 5:
        if global_pooling:
            shape = tuple(input.shape[:2]) + (1, 1, 1)
        else:
            dims = [(input.shape[2 + i] + 2 * pd[i] - ks[i]) // st[i] + 1
                    for i in range(3)]
            shape = tuple(input.shape[:2]) + tuple(dims)
    return _single_out("pool3d", {"X": input},
                       {"pooling_type": pool_type, "ksize": ks,
                        "strides": st, "paddings": pd,
                        "global_pooling": global_pooling},
                       name=name, shape=shape)


def sampling_id(x, seed=0, name=None):
    """(ref sampling_id_op.cc; SamplingIdLayer.cpp)."""
    shape = (x.shape[0],) if x.shape is not None else None
    return _single_out("sampling_id", {"X": x}, {"seed": seed}, name=name,
                       dtype="int32", shape=shape)

# ---------------------------------------------------------------------------
# sequence layers


def sequence_pool(input, pool_type="average", seq_lens=None, name=None):
    """``seq_lens``: optional [B] int variable of runtime valid lengths
    for bucketed batches (see dynamic_lstm)."""
    helper = LayerHelper("sequence_pool", name=name)
    pshape = ((-1,) + tuple(input.shape[1:])) if input.shape else None
    out = helper.create_tmp_variable(dtype=input.dtype, shape=pshape)
    idx = helper.create_tmp_variable(dtype="int64")
    pool_inputs = {"X": input}
    if seq_lens is not None:
        pool_inputs["SeqLens"] = seq_lens
    helper.append_op("sequence_pool", inputs=pool_inputs,
                     outputs={"Out": out, "MaxIndex": idx},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input, seq_lens=None, name=None):
    return sequence_pool(input, "first", seq_lens=seq_lens, name=name)


def sequence_last_step(input, seq_lens=None, name=None):
    return sequence_pool(input, "last", seq_lens=seq_lens, name=name)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, param_attr=None, bias_attr=None, act=None,
                  name=None):
    helper = LayerHelper("sequence_conv", name=name)
    in_dim = input.shape[-1]
    w = helper.create_parameter(param_attr,
                                shape=[filter_size * in_dim, num_filters],
                                dtype=input.dtype)
    out = helper.create_tmp_variable(dtype=input.dtype,
                                     lod_level=input.lod_level,
                                     shape=(-1, num_filters))
    helper.append_op("sequence_conv", inputs={"X": input, "Filter": w},
                     outputs={"Out": out},
                     attrs={"contextStart": None,
                            "contextLength": filter_size,
                            "contextStride": filter_stride})
    pre_act = helper.append_bias_op(out, bias_attr, num_filters)
    return helper.append_activation(pre_act, act)


# ---------------------------------------------------------------------------
# recurrent layers


def dynamic_lstm(input, size, use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", param_attr=None,
                 bias_attr=None, seq_lens=None, name=None):
    """Dynamic LSTM over a ragged batch (ref fluid/layers.py:134
    dynamic_lstm; lstm_op.cc). ``size`` is 4*hidden, matching the
    reference; ``input`` must already be the 4*hidden gate projection
    (apply fc first). ``seq_lens``: optional [B] int variable of
    runtime valid lengths (bucketed batches). Returns (hidden, cell),
    both LoD tensors."""
    helper = LayerHelper("dynamic_lstm", name=name)
    hidden_dim = size // 4
    w = helper.create_parameter(param_attr, shape=[hidden_dim, 4 * hidden_dim],
                                dtype=input.dtype)
    bias_size = 7 * hidden_dim if use_peepholes else 4 * hidden_dim
    b = helper.create_parameter(bias_attr, shape=[1, bias_size],
                                dtype=input.dtype, is_bias=True)
    hidden = helper.create_tmp_variable(dtype=input.dtype, lod_level=1,
                                        shape=(-1, hidden_dim))
    cell = helper.create_tmp_variable(dtype=input.dtype, lod_level=1,
                                      shape=(-1, hidden_dim))
    lstm_inputs = {"Input": input, "Weight": w, "Bias": b}
    if seq_lens is not None:
        lstm_inputs["SeqLens"] = seq_lens
    helper.append_op(
        "dynamic_lstm",
        inputs=lstm_inputs,
        outputs={"Hidden": hidden, "Cell": cell},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden, cell


def fused_lstm(input, size, is_reverse=False, param_attr=None,
               param_x_attr=None, bias_attr=None, seq_lens=None,
               name=None):
    """LSTM layer that takes the raw input and owns its gate projection
    (WeightX [in_dim, 4*size]); on uniform lengths the projection runs
    inside the recurrence kernels (B14 / B15), elsewhere the op composes
    one matmul with ``dynamic_lstm``'s recurrence (B10 / B11). Same math
    as ``fc(input, 4*size)`` + ``dynamic_lstm``. ``size`` is the hidden
    dim. Returns (hidden, cell)."""
    helper = LayerHelper("fused_lstm", name=name)
    in_dim = int(input.shape[-1])
    # two distinct weights need two distinct attrs: a single named
    # param_attr would make them collide in the global block
    wx = helper.create_parameter(param_x_attr, shape=[in_dim, 4 * size],
                                 dtype=input.dtype)
    w = helper.create_parameter(param_attr, shape=[size, 4 * size],
                                dtype=input.dtype)
    b = helper.create_parameter(bias_attr, shape=[1, 4 * size],
                                dtype=input.dtype, is_bias=True)
    hidden = helper.create_tmp_variable(dtype=input.dtype, lod_level=1,
                                        shape=(-1, size))
    cell = helper.create_tmp_variable(dtype=input.dtype, lod_level=1,
                                      shape=(-1, size))
    lstm_inputs = {"Input": input, "WeightX": wx, "Weight": w, "Bias": b}
    if seq_lens is not None:
        lstm_inputs["SeqLens"] = seq_lens
    helper.append_op(
        "fused_lstm",
        inputs=lstm_inputs,
        outputs={"Hidden": hidden, "Cell": cell},
        attrs={"is_reverse": is_reverse})
    return hidden, cell


def dynamic_gru(input, size, is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", param_attr=None, bias_attr=None,
                seq_lens=None, name=None):
    """Dynamic GRU (ref fluid dynamic_gru; gru_op.cc). ``size`` is the
    hidden dim; ``input`` must be the 3*size projection."""
    helper = LayerHelper("dynamic_gru", name=name)
    w = helper.create_parameter(param_attr, shape=[size, 3 * size],
                                dtype=input.dtype)
    b = helper.create_parameter(bias_attr, shape=[1, 3 * size],
                                dtype=input.dtype, is_bias=True)
    hidden = helper.create_tmp_variable(dtype=input.dtype, lod_level=1,
                                        shape=(-1, size))
    gru_inputs = {"Input": input, "Weight": w, "Bias": b}
    if seq_lens is not None:
        gru_inputs["SeqLens"] = seq_lens
    helper.append_op(
        "dynamic_gru",
        inputs=gru_inputs,
        outputs={"Hidden": hidden},
        attrs={"is_reverse": is_reverse, "gate_activation": gate_activation,
               "activation": candidate_activation})
    return hidden


# ---------------------------------------------------------------------------
# unary wrappers and operator sugar


def _make_unary(op_type):
    def f(x, name=None, **attrs):
        return _single_out(op_type, {"X": x}, attrs, name=name,
                           lod_level=getattr(x, "lod_level", 0))
    f.__name__ = op_type
    f.__doc__ = f"Autogenerated wrapper for the `{op_type}` op."
    return f


# the JAX DSL's generated wrappers (its ``_UNARY_OPS``, the reference's
# fluid/layers.py ``_create_op_func_``), in its order
_UNARY_OPS = [
    "sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink", "sqrt",
    "rsqrt", "abs", "ceil", "floor", "round", "reciprocal", "log", "square",
    "softplus", "softsign", "gelu", "silu", "brelu", "leaky_relu",
    "soft_relu", "elu", "relu6", "stanh", "hard_shrink", "thresholded_relu",
    "hard_sigmoid", "swish", "softmax", "log_softmax", "sign", "sin", "cos",
]

for _op in _UNARY_OPS:
    globals()[_op] = _make_unary(_op)
    if _op not in __all__:
        __all__.append(_op)


def maxout(x, groups, name=None):
    """NCHW channels split into ``groups``-wide groups, the max of each."""
    return _single_out("maxout", {"X": x}, {"groups": groups}, name=name)


def elementwise_binary_sugar(x, other, op_type, reverse=False):
    """``a + b``, ``a - b``, ``a * b`` and ``a / b`` on Variables append
    the elementwise op; a scalar operand appends ``scale``, as in the
    JAX package (``scalar / a``: ``reciprocal``, then ``scale``)."""
    if isinstance(other, Variable):
        a, b = (other, x) if reverse else (x, other)
        return _elementwise(op_type, a, b)
    val = float(other)
    if op_type == "elementwise_add":
        return scale(x, 1.0, val)
    if op_type == "elementwise_sub":
        return (scale(x, -1.0, val, bias_after_scale=True) if reverse
                else scale(x, 1.0, -val))
    if op_type == "elementwise_mul":
        return scale(x, val, 0.0)
    if op_type == "elementwise_div":
        if reverse:
            return scale(_single_out("reciprocal", {"X": x}), val, 0.0)
        return scale(x, 1.0 / val, 0.0)
    raise TypeError(f"unsupported operand for {op_type}: {type(other)}")
