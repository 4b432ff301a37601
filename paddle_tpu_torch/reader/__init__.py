"""Data readers: the port of the JAX package's ``reader`` namespace, the
composable decorators (``reader.decorator``) and the creators
(``reader.creator``). A *reader creator* is a zero-arg callable
returning an iterable of samples. The record files
(``reader/recordio.py``) are ROADMAP A11's and the PyDataProvider2-style
``reader/provider.py`` is A3's."""

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

__all__ = ["batch", "bucket_by_sequence_length", "buffered", "cache",
           "chain", "compose", "creator", "device_buffered", "firstn",
           "map_readers", "shuffle", "xmap_readers"]
