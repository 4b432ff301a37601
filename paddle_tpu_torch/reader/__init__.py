"""Data readers: the port of the JAX package's ``reader`` namespace, the
composable decorators (``reader.decorator``), the creators
(``reader.creator``) and the PyDataProvider2-style ``@provider``
(``reader.provider``, also ``reader.data_provider``). A *reader
creator* is a zero-arg callable returning an iterable of samples. The
record files (``reader/recordio.py``) are ROADMAP A11's."""

from paddle_tpu_torch.reader.decorator import (  # noqa: F401
    batch,
    bucket_by_sequence_length,
    buffered,
    cache,
    chain,
    compose,
    device_buffered,
    firstn,
    map_readers,
    shuffle,
    xmap_readers,
)
from paddle_tpu_torch.reader import creator  # noqa: F401
from paddle_tpu_torch.reader import provider  # noqa: F401
from paddle_tpu_torch.reader.provider import (  # noqa: F401
    provider as data_provider,
)

__all__ = ["batch", "bucket_by_sequence_length", "buffered", "cache",
           "chain", "compose", "creator", "data_provider", "device_buffered",
           "firstn", "map_readers", "provider", "shuffle", "xmap_readers"]
