"""MNIST models: the port of the JAX package's ``models/mnist.py``
(the fluid book's recognize_digits_mlp and recognize_digits_conv).

``mlp`` (the 3-layer MLP) and ``conv`` (the LeNet-style net over
``nets.simple_img_conv_pool``) build through the port's layers DSL, with
the JAX package's op lists and names.
"""
from __future__ import annotations

from paddle_tpu_torch import layers, nets

__all__ = ["mlp", "conv"]


def mlp(img, label, hidden_sizes=(128, 64), num_classes: int = 10):
    """3-layer MLP; returns (prediction, avg_loss, accuracy)."""
    h = img
    for size in hidden_sizes:
        h = layers.fc(h, size, act="relu")
    logits = layers.fc(h, num_classes)
    prediction = layers.softmax(logits)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(prediction, label)
    return prediction, loss, acc


def conv(img, label, num_classes: int = 10):
    """LeNet-style conv net (ref book recognize_digits_conv)."""
    c1 = nets.simple_img_conv_pool(img, num_filters=20, filter_size=5,
                                   pool_size=2, pool_stride=2, act="relu")
    c2 = nets.simple_img_conv_pool(c1, num_filters=50, filter_size=5,
                                   pool_size=2, pool_stride=2, act="relu")
    logits = layers.fc(c2, num_classes)
    prediction = layers.softmax(logits)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(prediction, label)
    return prediction, loss, acc
