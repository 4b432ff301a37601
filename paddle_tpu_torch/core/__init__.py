"""Core data structures of the port: dtypes (``core.dtype``), places
(``core.place``: ``CPUPlace``, ``CUDAPlace``), ragged tensors
(``core.lod``: ``LoD``, ``LoDTensor``, ``pack_indices``), scopes
(``core.scope``) and sparse row gradients (``core.selected_rows``)."""
from paddle_tpu_torch.core.dtype import (convert_dtype, dtype_name,
                                         is_float, is_integer)
from paddle_tpu_torch.core.lod import LoD, LoDTensor, to_lod_tensor
from paddle_tpu_torch.core.place import (CPUPlace, CUDAPlace, Place,
                                         default_place, get_places)
from paddle_tpu_torch.core.scope import (Scope, global_scope,
                                         reset_global_scope)

__all__ = ["convert_dtype", "dtype_name", "is_float", "is_integer", "LoD",
           "LoDTensor", "to_lod_tensor", "CPUPlace", "CUDAPlace", "Place",
           "default_place", "get_places", "Scope", "global_scope",
           "reset_global_scope"]
