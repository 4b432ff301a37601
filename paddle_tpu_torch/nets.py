"""Prebuilt network pieces: the port of the JAX package's ``nets.py``
(fluid/nets.py: simple_img_conv_pool, img_conv_group,
sequence_conv_pool, glu, dot-product attention), each built through the
port's layers DSL with the JAX package's op lists and names.
"""
from __future__ import annotations

import math

from paddle_tpu_torch import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act=None, pool_type="max",
                         param_attr=None):
    conv = layers.conv2d(input, num_filters, filter_size,
                         param_attr=param_attr, act=act)
    return layers.pool2d(conv, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_size=2, pool_stride=2, pool_type="max"):
    """VGG-style conv stack + pool (ref fluid/nets.py img_conv_group)."""
    tmp = input
    if isinstance(conv_with_batchnorm, bool):
        conv_with_batchnorm = [conv_with_batchnorm] * len(conv_num_filter)
    if isinstance(conv_batchnorm_drop_rate, (int, float)):
        conv_batchnorm_drop_rate = ([conv_batchnorm_drop_rate]
                                    * len(conv_num_filter))
    for i, nf in enumerate(conv_num_filter):
        local_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(tmp, nf, conv_filter_size,
                            padding=(conv_filter_size - 1) // 2,
                            act=local_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(
                    tmp, dropout_prob=conv_batchnorm_drop_rate[i])
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


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
    ``softmax(q / sqrt(d) @ k^T) @ v``, the weights through dropout
    where ``dropout_rate`` > 0."""
    d = queries.shape[-1]
    scaled_q = layers.scale(queries, 1.0 / math.sqrt(d))
    logits = layers.matmul(scaled_q, keys, transpose_y=True)
    weights = layers.softmax(logits)
    if dropout_rate > 0:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    return layers.matmul(weights, values)
