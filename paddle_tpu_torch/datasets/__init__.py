"""Dataset loaders: the port of the JAX package's ``datasets`` for the
book models, the image classifiers and the text flagship (``common``,
``mnist``, ``cifar``, ``uci_housing``, ``imdb``). Each reads the real
files under ``common.DATA_HOME`` when they are there, else yields the
JAX module's deterministic synthetic surrogate, made by the same numpy
RNG calls, so both packages give the same samples. The other datasets
(imikolov, movielens, wmt14, ctr, conll05, sentiment, flowers, voc2012,
mq2007) are ROADMAP A3's.
"""

from paddle_tpu_torch.datasets import cifar  # noqa: F401
from paddle_tpu_torch.datasets import common  # noqa: F401
from paddle_tpu_torch.datasets import imdb  # noqa: F401
from paddle_tpu_torch.datasets import mnist  # noqa: F401
from paddle_tpu_torch.datasets import uci_housing  # noqa: F401

__all__ = ["cifar", "common", "imdb", "mnist", "uci_housing"]
