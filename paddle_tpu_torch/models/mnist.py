"""MNIST models: the port of the JAX package's ``models/mnist.py``
(the fluid book's recognize_digits_mlp).

``mlp`` builds the 3-layer MLP through the port's layers DSL, with the
JAX package's op list and names. The LeNet-style ``conv`` net needs
conv2d and pool2d (``nets.simple_img_conv_pool``), ROADMAP A8's.
"""
from __future__ import annotations

from paddle_tpu_torch import layers

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
    """LeNet-style conv net (ref book recognize_digits_conv): not ported
    yet."""
    raise NotImplementedError(
        "mnist.conv needs conv2d / pool2d (ops/nn.py, nets.py), not ported "
        "yet (ROADMAP A8)")
