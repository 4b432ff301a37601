"""Prebuilt network pieces: the port of the JAX package's ``nets.py``
(fluid/nets.py: sequence_conv_pool, glu, dot-product attention).

``sequence_conv_pool``, ``glu`` and ``scaled_dot_product_attention``
build through the port's layers DSL with the JAX package's op lists and
names. ``simple_img_conv_pool`` and ``img_conv_group`` need conv2d,
pool2d and batch_norm, and attention with dropout needs the dropout op:
ROADMAP A8's, each raising ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import math

from paddle_tpu_torch import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act=None, pool_type="max",
                         param_attr=None):
    raise NotImplementedError(
        "nets.simple_img_conv_pool needs conv2d / pool2d, not ported yet "
        "(ROADMAP A8)")


def img_conv_group(input, conv_num_filter, conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_size=2, pool_stride=2, pool_type="max"):
    raise NotImplementedError(
        "nets.img_conv_group needs conv2d / pool2d / batch_norm, not ported "
        "yet (ROADMAP A8)")


def sequence_conv_pool(input, num_filters, filter_size, act="sigmoid",
                       pool_type="max"):
    conv = layers.sequence_conv(input, num_filters, filter_size, act=act)
    return layers.sequence_pool(conv, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit: the input's halves a, b along ``dim`` give
    ``a * sigmoid(b)``."""
    a, b = layers.split(input, 2, dim=dim if dim >= 0
                        else len(input.shape) - 1)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Single-block attention on dense [batch, len, d] tensors:
    ``softmax(q / sqrt(d) @ k^T) @ v``."""
    if dropout_rate > 0:
        raise NotImplementedError(
            "scaled_dot_product_attention(dropout_rate > 0) needs the "
            "dropout op, not ported yet (ROADMAP A8)")
    d = queries.shape[-1]
    scaled_q = layers.scale(queries, 1.0 / math.sqrt(d))
    logits = layers.matmul(scaled_q, keys, transpose_y=True)
    weights = layers.softmax(logits)
    return layers.matmul(weights, values)
