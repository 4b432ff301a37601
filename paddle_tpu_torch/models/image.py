"""Image-classification model zoo: the port of the JAX package's
``models/image.py``, the reference's benchmark/paddle/image/{alexnet,
googlenet,resnet,vgg,smallnet_mnist_cifar}.py configs in the layers DSL
(``bench.py``'s image workloads). Shapes are NCHW; under AMP the
convolutions and the fc layers compute in bf16 over fp32 masters.

Each builder gives the JAX package's Program: the same ops, variables
and names, so a JAX startup state carries over by name
(``convert.scope_from_jax``).
"""
from __future__ import annotations

import math

import numpy as np

from paddle_tpu_torch import layers, nets

__all__ = ["alexnet", "vgg16", "resnet_cifar10", "resnet_imagenet",
           "googlenet", "smallnet_mnist_cifar"]


def _classifier(feat, label, class_dim):
    logits = layers.fc(feat, class_dim)
    prediction = layers.softmax(logits)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(prediction, label)
    return prediction, loss, acc


def alexnet(img, label, class_dim: int = 1000, use_lrn: bool = True):
    """(ref benchmark/paddle/image/alexnet.py)."""
    t = layers.conv2d(img, 64, 11, stride=4, padding=2, act="relu")
    if use_lrn:
        t = layers.lrn(t, n=5)
    t = layers.pool2d(t, 3, pool_stride=2, pool_type="max")
    t = layers.conv2d(t, 192, 5, padding=2, act="relu")
    if use_lrn:
        t = layers.lrn(t, n=5)
    t = layers.pool2d(t, 3, pool_stride=2, pool_type="max")
    t = layers.conv2d(t, 384, 3, padding=1, act="relu")
    t = layers.conv2d(t, 256, 3, padding=1, act="relu")
    t = layers.conv2d(t, 256, 3, padding=1, act="relu")
    t = layers.pool2d(t, 3, pool_stride=2, pool_type="max")
    t = layers.fc(t, 4096, act="relu")
    t = layers.dropout(t, 0.5)
    t = layers.fc(t, 4096, act="relu")
    t = layers.dropout(t, 0.5)
    return _classifier(t, label, class_dim)


def vgg16(img, label, class_dim: int = 1000, with_bn: bool = True):
    """(ref benchmark/paddle/image/vgg.py — VGG-16 with conv-group BN)."""
    t = img
    for nconv, nf in ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)):
        t = nets.img_conv_group(
            t, conv_num_filter=[nf] * nconv, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=with_bn,
            pool_size=2, pool_stride=2)
    t = layers.dropout(t, 0.5)
    t = layers.fc(t, 4096, act=None)
    if with_bn:
        t = layers.batch_norm(t, act="relu")
    else:
        t = layers.relu(t)
    t = layers.dropout(t, 0.5)
    t = layers.fc(t, 4096, act="relu")
    return _classifier(t, label, class_dim)


def _conv_bn(input, ch_out, filter_size, stride, padding, act="relu"):
    conv = layers.conv2d(input, ch_out, filter_size, stride=stride,
                         padding=padding, bias_attr=False)
    return layers.batch_norm(conv, act=act)


def _shortcut(input, ch_out, stride):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return _conv_bn(input, ch_out, 1, stride, 0, act=None)
    return input


def _basic_block(input, ch_out, stride):
    s = _shortcut(input, ch_out, stride)
    c1 = _conv_bn(input, ch_out, 3, stride, 1)
    c2 = _conv_bn(c1, ch_out, 3, 1, 1, act=None)
    return layers.relu(layers.elementwise_add(c2, s))


def _bottleneck(input, ch_out, stride):
    s = _shortcut(input, ch_out * 4, stride)
    c1 = _conv_bn(input, ch_out, 1, stride, 0)
    c2 = _conv_bn(c1, ch_out, 3, 1, 1)
    c3 = _conv_bn(c2, ch_out * 4, 1, 1, 0, act=None)
    return layers.relu(layers.elementwise_add(c3, s))


def _layer_warp(block_fn, input, ch_out, count, stride):
    t = block_fn(input, ch_out, stride)
    for _ in range(count - 1):
        t = block_fn(t, ch_out, 1)
    return t


def s2d_weight_mask(ch_out: int, ch_in: int) -> np.ndarray:
    """Zero-mask for the space-to-depth stem weight: the 7x7 kernel lives
    in an 8x8 grid front-padded with one zero row/col, so the refolded
    [K, 4*C, 4, 4] weight positions mapping to 8x8 row/col 0 must stay
    zero for the reparametrization to remain exactly the 7x7 conv."""
    # dims (k, c, sh, sw, a, b): original 8x8 offsets are (2a+sh, 2b+sw)
    m = np.ones((ch_out, ch_in, 2, 2, 4, 4), np.float32)
    m[:, :, 0, :, 0, :] = 0.0   # 2a+sh == 0
    m[:, :, :, 0, :, 0] = 0.0   # 2b+sw == 0
    return m.reshape(ch_out, 4 * ch_in, 4, 4)


def refold_stem_weight(w7: np.ndarray) -> np.ndarray:
    """Refold a [K, C, 7, 7] stride-2 stem kernel into the equivalent
    [K, 4*C, 4, 4] space-to-depth kernel (channel order (c, sh, sw),
    matching _s2d_stem's block fold)."""
    k, c = w7.shape[:2]
    w8 = np.zeros((k, c, 8, 8), w7.dtype)
    w8[:, :, 1:, 1:] = w7                     # front-pad: offset -4 row/col
    # (k, c, a, sh, b, sw) <- w8[k, c, 2a+sh, 2b+sw]
    w6 = w8.reshape(k, c, 4, 2, 4, 2)
    return w6.transpose(0, 1, 3, 5, 2, 4).reshape(k, 4 * c, 4, 4)


def _s2d_stem(img, ch_out: int = 64):
    """The ResNet/GoogLeNet 7x7 stride-2 C=3 stem re-expressed as a 4x4
    stride-1 conv over 2x2 pixel blocks folded into channels (C=12), a
    mathematically exact reparametrization (the JAX package's option for
    the TPU's tiles; here it keeps that Program). The weight is masked by a
    non-trainable parameter so its reachable function class is exactly
    the 7x7 conv's, and gradients cannot leak into the folded zero
    row/col.

    conv7x7_s2(x) == conv4x4_s1(pad_{2,1}(S2D_2x2(x))) with the kernel
    refolded per refold_stem_weight.
    """
    from paddle_tpu_torch.initializer import (NormalInitializer,
                                              NumpyArrayInitializer)
    from paddle_tpu_torch.layer_helper import LayerHelper
    from paddle_tpu_torch.param_attr import ParamAttr

    n, c, h, w = img.shape
    if h % 2 or w % 2:
        raise ValueError(
            f"s2d stem needs even spatial dims, got {h}x{w}: the 2x2 "
            "block fold (and the 7x7/s2 equivalence) requires them")
    hb, wb = h // 2, w // 2
    t = layers.reshape(img, [-1, c, hb, 2, wb, 2])
    t = layers.transpose(t, [0, 1, 3, 5, 2, 4])      # [N, c, sh, sw, hb, wb]
    t = layers.reshape(t, [-1, 4 * c, hb, wb])
    # block offsets a-2 for a in 0..3: pad 2 front / 1 back each spatial dim
    t = layers.pad(t, [0, 0, 0, 0, 2, 1, 2, 1])

    helper = LayerHelper("s2d_stem")
    std = math.sqrt(2.0 / (7 * 7 * c))               # the 7x7 conv's fan-in
    w_p = helper.create_parameter(
        None, shape=[ch_out, 4 * c, 4, 4], dtype=img.dtype,
        default_initializer=NormalInitializer(0.0, std))
    mask = helper.create_parameter(
        ParamAttr(name=w_p.name + ".mask", trainable=False,
                  initializer=NumpyArrayInitializer(s2d_weight_mask(
                      ch_out, c))),
        shape=[ch_out, 4 * c, 4, 4], dtype=img.dtype)
    w_used = layers.elementwise_mul(w_p, mask)
    out = helper.create_tmp_variable(
        dtype=img.dtype, shape=(n, ch_out, hb, wb))
    helper.append_op(
        "conv2d", inputs={"Input": t, "Filter": w_used},
        outputs={"Output": out},
        attrs={"strides": [1, 1], "paddings": [0, 0],
               "dilations": [1, 1], "groups": 1})
    return out


def resnet_imagenet(img, label, class_dim: int = 1000, depth: int = 50,
                    s2d_stem: bool = False):
    """ResNet-50/101/152 (ref benchmark/paddle/image/resnet.py).

    ``s2d_stem``: opt-in space-to-depth stem: the same function class and
    initialization statistics as the 7x7 stride-2 stem."""
    cfg = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
    if s2d_stem:
        t = layers.batch_norm(_s2d_stem(img, 64), act="relu")
    else:
        t = _conv_bn(img, 64, 7, 2, 3)
    t = layers.pool2d(t, 3, pool_stride=2, pool_padding=1, pool_type="max")
    for i, (ch, cnt) in enumerate(zip((64, 128, 256, 512), cfg)):
        t = _layer_warp(_bottleneck, t, ch, cnt, 1 if i == 0 else 2)
    t = layers.pool2d(t, pool_type="avg", global_pooling=True)
    return _classifier(t, label, class_dim)


def resnet_cifar10(img, label, depth: int = 32, class_dim: int = 10):
    n = (depth - 2) // 6
    t = _conv_bn(img, 16, 3, 1, 1)
    t = _layer_warp(_basic_block, t, 16, n, 1)
    t = _layer_warp(_basic_block, t, 32, n, 2)
    t = _layer_warp(_basic_block, t, 64, n, 2)
    t = layers.pool2d(t, pool_type="avg", global_pooling=True)
    return _classifier(t, label, class_dim)


def _inception(input, filters):
    """Inception-v1 block (ref benchmark/paddle/image/googlenet.py)."""
    f1, f3r, f3, f5r, f5, proj = filters
    b1 = layers.conv2d(input, f1, 1, act="relu")
    b3 = layers.conv2d(input, f3r, 1, act="relu")
    b3 = layers.conv2d(b3, f3, 3, padding=1, act="relu")
    b5 = layers.conv2d(input, f5r, 1, act="relu")
    b5 = layers.conv2d(b5, f5, 5, padding=2, act="relu")
    bp = layers.pool2d(input, 3, pool_stride=1, pool_padding=1,
                       pool_type="max")
    bp = layers.conv2d(bp, proj, 1, act="relu")
    return layers.concat([b1, b3, b5, bp], axis=1)


def googlenet(img, label, class_dim: int = 1000):
    t = layers.conv2d(img, 64, 7, stride=2, padding=3, act="relu")
    t = layers.pool2d(t, 3, pool_stride=2, pool_type="max")
    t = layers.conv2d(t, 64, 1, act="relu")
    t = layers.conv2d(t, 192, 3, padding=1, act="relu")
    t = layers.pool2d(t, 3, pool_stride=2, pool_type="max")
    t = _inception(t, (64, 96, 128, 16, 32, 32))
    t = _inception(t, (128, 128, 192, 32, 96, 64))
    t = layers.pool2d(t, 3, pool_stride=2, pool_type="max")
    t = _inception(t, (192, 96, 208, 16, 48, 64))
    t = _inception(t, (160, 112, 224, 24, 64, 64))
    t = _inception(t, (128, 128, 256, 24, 64, 64))
    t = _inception(t, (112, 144, 288, 32, 64, 64))
    t = _inception(t, (256, 160, 320, 32, 128, 128))
    t = layers.pool2d(t, 3, pool_stride=2, pool_type="max")
    t = _inception(t, (256, 160, 320, 32, 128, 128))
    t = _inception(t, (384, 192, 384, 48, 128, 128))
    t = layers.pool2d(t, pool_type="avg", global_pooling=True)
    t = layers.dropout(t, 0.4)
    return _classifier(t, label, class_dim)


def smallnet_mnist_cifar(img, label, class_dim: int = 10):
    """(ref benchmark/paddle/image/smallnet_mnist_cifar.py)."""
    t = layers.conv2d(img, 32, 5, padding=2, act="relu")
    t = layers.pool2d(t, 3, pool_stride=2, pool_type="max")
    t = layers.conv2d(t, 32, 5, padding=2, act="relu")
    t = layers.pool2d(t, 3, pool_stride=2, pool_type="avg")
    t = layers.conv2d(t, 64, 5, padding=2, act="relu")
    t = layers.pool2d(t, 3, pool_stride=2, pool_type="avg")
    t = layers.fc(t, 64, act="relu")
    return _classifier(t, label, class_dim)
