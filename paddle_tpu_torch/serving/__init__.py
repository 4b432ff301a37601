"""Serving on the card.

``ServingEngine`` wraps a loaded inference program with shape-bucketed
micro-batching (``BucketLadder`` / ``MicroBatcher``), pinned weights
and a frozen fetch set (``Executor.prepare_infer``), host-side padding
overlapped with the card's execution, and bounded-queue backpressure
(``ServingOverloadError``).

``DecodeEngine`` is the generative tier: continuous batching over a
block-paged KV cache (``KVCacheConfig``/``BlockPool``). In chunked-prefill mode
(the default) every turn is one ``mixed_step`` that carries every
decoding slot's next token and a budget of prompt-chunk tokens; in
whole-prompt mode admission runs one ``prefill`` per prompt and every
turn is one ``decode_step``; ``admission="static"`` is the synchronous
baseline. Attention runs through the hand-written paged-attention
kernels (mixed, decode and chunk forms). Quantized serving (int8/fp8-e4m3 KV pools and
projection weights, bfloat16 pools) rides the same step, through the
hand-written quantized matmul and the paged-attention kernel's
quantized lane. See the JAX package's ``docs/serving.md`` for the
behaviour and metric names both engines keep.
"""
from paddle_tpu_torch.serving.batcher import (MicroBatcher, Request,
                                              ServingOverloadError)
from paddle_tpu_torch.serving.bucketing import (BucketLadder, PaddedBatch,
                                                assemble_batch)
from paddle_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                    DecodeRequest,
                                                    DecodeResult)
from paddle_tpu_torch.serving.decode_model import (
    DecoderConfig, decode_chunk, decode_step, dense_prefill, init_params,
    mixed_step, param_bytes, prefill, quantize_decoder_params)
from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.kvcache import (BlockPool, KVCacheConfig,
                                              OutOfBlocksError,
                                              chain_block_hashes,
                                              kv_pool_hbm_bytes,
                                              kv_quant_cal,
                                              kv_storage_dtype,
                                              make_pools)

__all__ = [
    "BlockPool",
    "BucketLadder",
    "DecodeEngine",
    "DecodeRequest",
    "DecodeResult",
    "DecoderConfig",
    "KVCacheConfig",
    "MicroBatcher",
    "OutOfBlocksError",
    "PaddedBatch",
    "Request",
    "ServingEngine",
    "ServingOverloadError",
    "assemble_batch",
    "chain_block_hashes",
    "decode_chunk",
    "decode_step",
    "dense_prefill",
    "init_params",
    "kv_pool_hbm_bytes",
    "kv_quant_cal",
    "kv_storage_dtype",
    "make_pools",
    "mixed_step",
    "param_bytes",
    "prefill",
    "quantize_decoder_params",
]
