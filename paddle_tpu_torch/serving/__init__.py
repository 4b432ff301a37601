"""Generative serving on the card.

``DecodeEngine`` is the chunked-prefill, continuous-batching engine
over a block-paged KV cache (``KVCacheConfig``/``BlockPool``): every
turn is one ``mixed_step`` that carries every decoding slot's next
token and a budget of prompt-chunk tokens, through the hand-written
paged-attention kernel. Quantized serving (int8/fp8-e4m3 KV pools and
projection weights, bfloat16 pools) rides the same step, through the
hand-written quantized matmul and the paged-attention kernel's
quantized lane. See the JAX package's ``docs/serving.md`` for the
behaviour and metric names it keeps.
"""
from paddle_tpu_torch.serving.batcher import ServingOverloadError
from paddle_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                    DecodeRequest,
                                                    DecodeResult)
from paddle_tpu_torch.serving.decode_model import (
    DecoderConfig, dense_prefill, init_params, mixed_step, param_bytes,
    quantize_decoder_params)
from paddle_tpu_torch.serving.kvcache import (BlockPool, KVCacheConfig,
                                              OutOfBlocksError,
                                              chain_block_hashes,
                                              kv_quant_cal,
                                              kv_storage_dtype,
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
    "dense_prefill",
    "init_params",
    "kv_quant_cal",
    "kv_storage_dtype",
    "make_pools",
    "mixed_step",
    "param_bytes",
    "quantize_decoder_params",
]
