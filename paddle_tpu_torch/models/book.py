"""The "book" model zoo: the port of the JAX package's ``models/book.py``,
one graph builder per classic tutorial model.

Each builder constructs its model into the current default main and
startup programs (construction only, no training) and returns the loss
Variable, with the JAX package's op lists and names. Builders take the
``paddle_tpu_torch`` top-level module as their only argument, so the
caller controls which default programs the graph lands in::

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.book import build_book_model
    loss, main, startup = build_book_model("fit_a_line")
"""
from __future__ import annotations

__all__ = ["BOOK_MODELS", "build_book_model", "fit_a_line",
           "recognize_digits_mlp", "recognize_digits_conv", "smallnet_cifar",
           "word2vec", "understand_sentiment_conv"]


def fit_a_line(pt):
    x = pt.layers.data("x", [13])
    y = pt.layers.data("y", [1])
    loss = pt.layers.mean(
        pt.layers.square_error_cost(pt.layers.fc(x, 1), y))
    pt.optimizer.SGD(0.01).minimize(loss)
    return loss


def recognize_digits_mlp(pt):
    from paddle_tpu_torch.models import mnist as mnist_models
    img = pt.layers.data("img", [784])
    label = pt.layers.data("label", [1], dtype="int64")
    _, loss, _acc = mnist_models.mlp(img, label)
    pt.optimizer.Adam(0.01).minimize(loss)
    return loss


def recognize_digits_conv(pt):
    from paddle_tpu_torch.models import mnist as mnist_models
    img = pt.layers.data("img", [1, 28, 28])
    label = pt.layers.data("label", [1], dtype="int64")
    _, loss, _acc = mnist_models.conv(img, label)
    pt.optimizer.Adam(0.01).minimize(loss)
    return loss


def smallnet_cifar(pt):
    from paddle_tpu_torch.models import image as image_models
    img = pt.layers.data("img", [3, 32, 32])
    label = pt.layers.data("label", [1], dtype="int64")
    _, loss, _acc = image_models.smallnet_mnist_cifar(img, label)
    pt.optimizer.Momentum(0.01).minimize(loss)
    return loss


def word2vec(pt):
    from paddle_tpu_torch.models import text as text_models
    words = [pt.layers.data(f"w{i}", [1], dtype="int64")
             for i in range(4)]
    nxt = pt.layers.data("next", [1], dtype="int64")
    _, loss = text_models.word2vec_net(words, nxt, dict_size=128,
                                       emb_dim=8, hid_dim=32)
    pt.optimizer.SGD(0.1).minimize(loss)
    return loss


def understand_sentiment_conv(pt):
    from paddle_tpu_torch.models import text as text_models
    data = pt.layers.data("words", [1], dtype="int64", lod_level=1)
    label = pt.layers.data("label", [1], dtype="int64")
    _, loss, _acc = text_models.convolution_net(
        data, label, input_dim=64, emb_dim=16, hid_dim=16)
    pt.optimizer.Adam(0.01).minimize(loss)
    return loss


BOOK_MODELS = {
    "fit_a_line": fit_a_line,
    "recognize_digits_mlp": recognize_digits_mlp,
    "recognize_digits_conv": recognize_digits_conv,
    "smallnet_cifar": smallnet_cifar,
    "word2vec": word2vec,
    "understand_sentiment_conv": understand_sentiment_conv,
}


def build_book_model(name: str, pt=None):
    """Build ``name`` into fresh default programs (name counters
    cleared) and a fresh global scope; return ``(loss, main_program,
    startup_program)``."""
    if pt is None:
        import paddle_tpu_torch as pt  # noqa: PLW0127
    from paddle_tpu_torch.core.scope import reset_global_scope
    from paddle_tpu_torch.framework.program import (default_main_program,
                                                    default_startup_program,
                                                    fresh_programs)
    try:
        build = BOOK_MODELS[name]
    except KeyError:
        raise KeyError(
            f"unknown book model {name!r}; "
            f"choose from {sorted(BOOK_MODELS)}") from None
    fresh_programs()
    reset_global_scope()
    loss = build(pt)
    return loss, default_main_program(), default_startup_program()
