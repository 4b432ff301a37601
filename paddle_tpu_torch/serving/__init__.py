"""Generative serving on the card.

``DecodeEngine`` is the chunked-prefill, continuous-batching engine
over a block-paged KV cache (``KVCacheConfig``/``BlockPool``): every
turn is one ``mixed_step`` that carries every decoding slot's next
token and a budget of prompt-chunk tokens, through the hand-written
paged-attention kernel. See the JAX package's ``docs/serving.md`` for
the behaviour and metric names it keeps.
"""
from paddle_tpu_torch.serving.batcher import ServingOverloadError
from paddle_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                    DecodeRequest,
                                                    DecodeResult)
from paddle_tpu_torch.serving.decode_model import (DecoderConfig,
                                                   init_params,
                                                   mixed_step,
                                                   param_bytes)
from paddle_tpu_torch.serving.kvcache import (BlockPool, KVCacheConfig,
                                              OutOfBlocksError,
                                              chain_block_hashes,
                                              make_pools)

__all__ = [
    "BlockPool",
    "DecodeEngine",
    "DecodeRequest",
    "DecodeResult",
    "DecoderConfig",
    "KVCacheConfig",
    "OutOfBlocksError",
    "ServingOverloadError",
    "chain_block_hashes",
    "init_params",
    "make_pools",
    "mixed_step",
    "param_bytes",
]
