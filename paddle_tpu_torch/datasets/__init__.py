"""Dataset loaders: the port of the JAX package's ``datasets``, all
thirteen (``common``, ``mnist``, ``cifar``, ``uci_housing``, ``imdb``,
``imikolov``, ``movielens``, ``wmt14``, ``ctr``, ``conll05``,
``sentiment``, ``flowers``, ``voc2012``, ``mq2007``). Each reads the
real files under ``common.DATA_HOME`` when they are there, else yields
the JAX module's deterministic synthetic surrogate, made by the same
numpy RNG calls, so both packages give the same samples. ``flowers``
and ``voc2012`` import PIL (and scipy) only inside their real-file
readers.
"""

from paddle_tpu_torch.datasets import common  # noqa: F401
from paddle_tpu_torch.datasets import mnist  # noqa: F401
from paddle_tpu_torch.datasets import cifar  # noqa: F401
from paddle_tpu_torch.datasets import uci_housing  # noqa: F401
from paddle_tpu_torch.datasets import imdb  # noqa: F401
from paddle_tpu_torch.datasets import imikolov  # noqa: F401
from paddle_tpu_torch.datasets import movielens  # noqa: F401
from paddle_tpu_torch.datasets import wmt14  # noqa: F401
from paddle_tpu_torch.datasets import ctr  # noqa: F401
from paddle_tpu_torch.datasets import conll05  # noqa: F401
from paddle_tpu_torch.datasets import sentiment  # noqa: F401
from paddle_tpu_torch.datasets import flowers  # noqa: F401
from paddle_tpu_torch.datasets import voc2012  # noqa: F401
from paddle_tpu_torch.datasets import mq2007  # noqa: F401

__all__ = ["cifar", "common", "conll05", "ctr", "flowers", "imdb",
           "imikolov", "mnist", "movielens", "mq2007", "sentiment",
           "uci_housing", "voc2012", "wmt14"]
