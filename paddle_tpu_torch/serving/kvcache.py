"""Block-paged KV cache for the generative decode engine.

A fixed device pool of ``num_blocks`` blocks of ``block_size`` token
positions per layer; every in-flight request owns a *block table* — the
ordered list of physical block ids backing its logical context.
Contexts of different lengths share the pool at block granularity, and
the mixed step's shapes never depend on which requests are resident:
block tables are data.

Blocks are *refcounted and content-addressed*:

- A block may back several contexts at once (prefix-cache hits).
  ``alloc`` hands out exclusive blocks; ``share`` bumps refcounts on
  existing ones. A block returns to circulation only at refcount 0.
- Full *prompt* blocks are published under a chained content hash
  (``register``); later admissions with the same token prefix reacquire
  them (``acquire_cached``) instead of re-prefilling. Refcount-0 hashed
  blocks are retained in an LRU — their K/V rows stay valid because
  freed blocks are never zeroed — and are evicted only when ``alloc``
  runs short of truly free blocks.

Split of responsibilities:

- **Host side**: ``BlockPool``'s pure-Python refcount + free-list + LRU
  accounting (a copy of the JAX package's, so the two agree step for
  step). Nothing here touches the device.
- **Device side**: ``make_pools`` returns the pool tensors, per layer
  ``[num_blocks, heads, block_size, head_dim]`` (the layout
  ``kernels/paged_attention.py`` reads), stacked over layers on axis 0.
  The mixed step writes new K/V rows into them in place.

Quantized pools (``dtype="int8"``/``"fp8-e4m3"``) store K/V at one
byte per element with per-block fp32 scales beside them; ``make_pools``
returns each as the JAX package's ``(payload, scales, cal)`` tuple.
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device

__all__ = ["KVCacheConfig", "BlockPool", "OutOfBlocksError",
           "chain_block_hashes", "QUANT_KV_DTYPES", "QUANT_QMAX",
           "FP8_E4M3_MAX", "kv_storage_dtype", "kv_quant_cal",
           "kv_pool_hbm_bytes", "make_pools"]

QUANT_KV_DTYPES = ("int8", "fp8-e4m3")
FP8_E4M3_MAX = 448.0      # largest finite float8_e4m3fn magnitude
QUANT_QMAX = {"int8": 127.0, "fp8-e4m3": FP8_E4M3_MAX}
# Bytes per element by name. A table, not ``np.dtype(name)``: numpy
# knows "bfloat16" only once ``ml_dtypes`` is imported, and the port
# does not import it.
_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
                "fp8-e4m3": 1}
_STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.float16, "int8": torch.int8,
                   "fp8-e4m3": torch.float8_e4m3fn}
# pool dtypes the paged-attention kernel has a lane for
_POOL_DTYPES = ("float32", "bfloat16") + QUANT_KV_DTYPES


class OutOfBlocksError(RuntimeError):
    """Raised by ``alloc`` when the pool cannot satisfy a request —
    the decode engine's cue to defer admission or preempt."""


@dataclass(frozen=True)
class KVCacheConfig:
    """Static shape of the paged KV cache.

    ``hbm_bytes = payload_bytes + scale_bytes`` where ``payload_bytes
    = 2 * num_layers * num_blocks * block_size * num_heads * head_dim
    * dtype_bytes`` (the 2 is K and V) and ``scale_bytes`` is the
    per-block fp32 scale overhead of quantized dtypes (0 otherwise)."""

    num_layers: int
    num_heads: int
    head_dim: int
    block_size: int = 16
    num_blocks: int = 256
    dtype: str = "float32"

    def __post_init__(self):
        for field in ("num_layers", "num_heads", "head_dim",
                      "block_size", "num_blocks"):
            v = getattr(self, field)
            if int(v) < 1:
                raise ValueError(f"{field} must be >= 1, got {v}")
        if self.dtype not in _DTYPE_BYTES:
            raise ValueError(f"unknown KV dtype {self.dtype!r}; known: "
                             f"{sorted(_DTYPE_BYTES)}")

    @property
    def quantized(self) -> bool:
        return self.dtype in QUANT_KV_DTYPES

    @property
    def quant_qmax(self) -> float:
        """Largest representable magnitude of the quantized payload
        dtype (scale = absmax / qmax)."""
        return QUANT_QMAX[self.dtype]

    @property
    def dtype_bytes(self) -> int:
        return _DTYPE_BYTES[self.dtype]

    @property
    def block_bytes(self) -> int:
        """Payload bytes one block occupies across K and V in ONE
        layer (scales excluded — see ``scale_bytes``)."""
        return (2 * self.block_size * self.num_heads * self.head_dim
                * self.dtype_bytes)

    @property
    def payload_bytes(self) -> int:
        """K/V payload footprint across all layers, scales excluded."""
        return self.num_layers * self.num_blocks * self.block_bytes

    @property
    def scale_bytes(self) -> int:
        """Per-block fp32 scale arrays ([L, N, H] for K and for V);
        0 in unquantized mode."""
        if not self.quantized:
            return 0
        return 2 * self.num_layers * self.num_blocks * self.num_heads * 4

    @property
    def hbm_bytes(self) -> int:
        """Total pool footprint across all layers.  Always
        ``payload_bytes + scale_bytes``."""
        return self.payload_bytes + self.scale_bytes

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks a context of ``n_tokens`` positions occupies."""
        return max(1, math.ceil(int(n_tokens) / self.block_size))

    @property
    def max_tokens(self) -> int:
        """Pool capacity in token positions (per layer)."""
        return self.num_blocks * self.block_size

    def describe(self) -> dict:
        return {
            "num_layers": self.num_layers,
            "num_heads": self.num_heads,
            "head_dim": self.head_dim,
            "block_size": self.block_size,
            "num_blocks": self.num_blocks,
            "dtype": self.dtype,
            "quantized": self.quantized,
            "payload_bytes": self.payload_bytes,
            "scale_bytes": self.scale_bytes,
            "hbm_bytes": self.hbm_bytes,
        }


def chain_block_hashes(tokens, block_size: int) -> List[str]:
    """Chained content hashes of the FULL blocks of a token sequence.

    ``h[i] = H(h[i-1] || tokens[i*bs:(i+1)*bs])`` — each hash commits
    to the entire prefix through block ``i``, so two sequences share
    ``h[i]`` iff their first ``(i+1)*bs`` tokens are identical. Partial
    tail blocks are never hashed. The bytes hashed are the int32 token
    ids, so the strings equal the JAX package's for the same tokens.
    """
    toks = np.asarray(tokens, np.int32)
    out: List[str] = []
    prev = b""
    for i in range(toks.size // int(block_size)):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(toks[i * block_size:(i + 1) * block_size].tobytes())
        prev = h.digest()
        out.append(prev.hex())
    return out


class BlockPool:
    """Host-side refcounted allocator over the physical block ids of
    one pool.

    Every reference is attributed to an ``owner`` (the request id), so
    a retire that fails to drop exactly the refs it holds is a
    detectable leak, not silent pool shrinkage. Not thread-safe by
    design: the decode loop is its only caller.
    """

    def __init__(self, config: KVCacheConfig):
        self.config = config
        self._free: List[int] = list(range(config.num_blocks - 1, -1, -1))
        self._refs: List[int] = [0] * config.num_blocks
        self._owner_blocks: Dict[object, List[int]] = {}
        # content-addressed index over full prompt blocks
        self._hash_to_block: Dict[str, int] = {}
        self._block_hash: Dict[int, str] = {}
        # refcount-0 hashed blocks, insertion order = LRU -> MRU
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.alloc_total = 0
        self.free_total = 0
        self.high_water = 0
        self.prefix_hits = 0
        self.prefix_evictions = 0

    # ------------------------------------------------------------ query
    @property
    def num_blocks(self) -> int:
        return self.config.num_blocks

    @property
    def free_blocks(self) -> int:
        """Blocks immediately free (refcount 0, not cached)."""
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks retained for their hashed content."""
        return len(self._lru)

    @property
    def available_blocks(self) -> int:
        """Blocks ``alloc`` can satisfy: free + evictable cached."""
        return len(self._free) + len(self._lru)

    @property
    def blocks_in_use(self) -> int:
        """Distinct physical blocks with refcount >= 1."""
        return self.config.num_blocks - len(self._free) - len(self._lru)

    @property
    def shared_blocks(self) -> int:
        """Distinct blocks referenced by more than one owner."""
        return sum(1 for r in self._refs if r > 1)

    @property
    def total_refs(self) -> int:
        """Sum of refcounts."""
        return sum(self._refs)

    @property
    def utilization(self) -> float:
        """Fraction of the pool currently backing live contexts."""
        return self.blocks_in_use / self.config.num_blocks

    def can_alloc(self, n: int) -> bool:
        return n <= self.available_blocks

    def owner_blocks(self, owner) -> List[int]:
        """Distinct blocks ``owner`` references, in table order."""
        return list(self._owner_blocks.get(owner, ()))

    def refcount(self, block: int) -> int:
        return self._refs[int(block)]

    def block_hash(self, block: int) -> Optional[str]:
        return self._block_hash.get(int(block))

    # ------------------------------------------------------- alloc/free
    def _evict_one(self) -> int:
        """Drop the least-recently-used cached block from the hash
        index and recycle it."""
        block, _ = self._lru.popitem(last=False)
        h = self._block_hash.pop(block)
        del self._hash_to_block[h]
        self.prefix_evictions += 1
        return block

    def alloc(self, n: int, owner) -> List[int]:
        """Hand ``n`` exclusive (refcount-1) block ids to ``owner``,
        evicting LRU cached blocks as needed. Raises
        ``OutOfBlocksError`` (allocating nothing) when free + cached
        cannot satisfy the request in full."""
        n = int(n)
        if n < 0:
            raise ValueError(f"alloc of {n} blocks")
        if n > self.available_blocks:
            raise OutOfBlocksError(
                f"need {n} blocks, pool has {len(self._free)} free + "
                f"{len(self._lru)} cached (total {self.config.num_blocks})")
        while len(self._free) < n:
            self._free.append(self._evict_one())
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._refs[b] = 1
        self._owner_blocks.setdefault(owner, []).extend(got)
        self.alloc_total += n
        self.high_water = max(self.high_water, self.blocks_in_use)
        return got

    def share(self, blocks: Iterable[int], owner) -> List[int]:
        """Add ``owner`` as a referent of existing live blocks: bumps
        each refcount by one. The blocks must have refcount >= 1."""
        got = [int(b) for b in blocks]
        for b in got:
            if self._refs[b] < 1:
                raise ValueError(f"share of non-live block {b} "
                                 f"(refcount {self._refs[b]})")
            self._refs[b] += 1
        self._owner_blocks.setdefault(owner, []).extend(got)
        return got

    def _drop_ref(self, block: int) -> None:
        self._refs[block] -= 1
        if self._refs[block] < 0:      # pragma: no cover - invariant
            raise AssertionError(f"refcount underflow on block {block}")
        if self._refs[block] == 0:
            if block in self._block_hash:
                self._lru[block] = None     # retained, content intact
                self._lru.move_to_end(block)
            else:
                self._free.append(block)
            self.free_total += 1

    def free(self, owner) -> int:
        """Drop ALL of ``owner``'s references (retire / preempt).
        Returns the number of refs dropped; freeing an unknown owner is
        0, not an error (idempotent retire)."""
        got = self._owner_blocks.pop(owner, None)
        if not got:
            return 0
        for b in got:
            self._drop_ref(b)
        return len(got)

    def release_blocks(self, owner, blocks: Sequence[int]) -> int:
        """Drop ``owner``'s reference on specific blocks. Each block
        must be in the owner's set."""
        held = self._owner_blocks.get(owner)
        dropped = 0
        for b in blocks:
            b = int(b)
            if held is None or b not in held:
                raise ValueError(f"owner {owner!r} holds no ref on "
                                 f"block {b}")
            held.remove(b)
            self._drop_ref(b)
            dropped += 1
        if held is not None and not held:
            del self._owner_blocks[owner]
        return dropped

    def release_tail(self, owner, keep_n: int) -> List[int]:
        """Drop the owner's references past the first ``keep_n`` table
        entries. Returns the released block ids."""
        held = self._owner_blocks.get(owner)
        if held is None or len(held) <= keep_n:
            return []
        tail = held[keep_n:]
        del held[keep_n:]
        for b in tail:
            self._drop_ref(b)
        if not held:
            del self._owner_blocks[owner]
        return tail

    # --------------------------------------------------- prefix cache
    def lookup(self, block_hash: str) -> Optional[int]:
        """Block currently published under ``block_hash`` (live or
        cached), else None. Does not touch refcounts."""
        return self._hash_to_block.get(block_hash)

    def acquire_cached(self, block_hash: str, owner) -> Optional[int]:
        """Prefix-cache hit: take a reference on the block published
        under ``block_hash``. Returns the block id, or None on miss."""
        block = self._hash_to_block.get(block_hash)
        if block is None:
            return None
        if self._refs[block] == 0:
            del self._lru[block]
        self._refs[block] += 1
        self._owner_blocks.setdefault(owner, []).append(block)
        self.prefix_hits += 1
        self.high_water = max(self.high_water, self.blocks_in_use)
        return block

    def register(self, block: int, block_hash: str) -> bool:
        """Publish a fully written block under its chained content
        hash. First registration wins; a block carries at most one
        hash. Returns True if the index changed."""
        block = int(block)
        if block_hash in self._hash_to_block or block in self._block_hash:
            return False
        if self._refs[block] < 1:
            raise ValueError(f"register of non-live block {block}")
        self._hash_to_block[block_hash] = block
        self._block_hash[block] = block_hash
        return True

    # ------------------------------------------------------ invariants
    def check_leaks(self) -> List[object]:
        """Owners still holding refs — MUST be the live requests and
        nothing else."""
        return [o for o, blocks in self._owner_blocks.items() if blocks]

    def assert_consistent(self) -> None:
        """Cross-check refcounts against owner attribution, the free
        list, and the LRU; raises AssertionError on any mismatch."""
        per_block = [0] * self.config.num_blocks
        for blocks in self._owner_blocks.values():
            for b in blocks:
                per_block[b] += 1
        assert per_block == self._refs, "owner refs != refcounts"
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "duplicate free blocks"
        for b in free_set:
            assert self._refs[b] == 0, f"free block {b} has refs"
            assert b not in self._block_hash, f"free block {b} hashed"
        for b in self._lru:
            assert self._refs[b] == 0, f"cached block {b} has refs"
            assert b in self._block_hash, f"cached block {b} unhashed"
        assert not (free_set & set(self._lru)), "block both free+cached"
        assert (len(self._free) + len(self._lru)
                + sum(1 for r in self._refs if r > 0)
                == self.config.num_blocks), "block census mismatch"
        assert (sorted(self._hash_to_block.values())
                == sorted(self._block_hash)), "hash index asymmetric"

    def stats(self) -> dict:
        return {
            "num_blocks": self.config.num_blocks,
            "block_size": self.config.block_size,
            "free_blocks": self.free_blocks,
            "cached_blocks": self.cached_blocks,
            "blocks_in_use": self.blocks_in_use,
            "shared_blocks": self.shared_blocks,
            "total_refs": self.total_refs,
            "utilization": round(self.utilization, 4),
            "high_water": self.high_water,
            "alloc_total": self.alloc_total,
            "free_total": self.free_total,
            "prefix_hits": self.prefix_hits,
            "prefix_evictions": self.prefix_evictions,
            "owners": len(self.check_leaks()),
            "hbm_bytes": self.config.hbm_bytes,
        }


def kv_storage_dtype(config: KVCacheConfig) -> torch.dtype:
    """The torch dtype K/V payloads are stored as."""
    return _STORAGE_DTYPES[config.dtype]


def kv_quant_cal(config: KVCacheConfig, absmax=None, device=None):
    """Calibration write-scale tensor ``[num_layers, num_heads]`` fp32:
    ``max(absmax, 1e-8) / qmax``, computed in numpy float32 exactly as
    the JAX package does. ``absmax`` is a per-layer/head estimate
    (broadcast to the shape); None means 1.0 everywhere."""
    shape = (config.num_layers, config.num_heads)
    if absmax is None:
        a = np.ones(shape, np.float32)
    else:
        a = np.broadcast_to(
            np.asarray(absmax, np.float32), shape).astype(np.float32)
    a = np.maximum(a, 1e-8)
    return torch.from_numpy(a / config.quant_qmax).to(
        resolve_device(device))


def make_pools(config: KVCacheConfig, device=None, k_absmax=None,
               v_absmax=None):
    """Fresh zeroed K and V pools on ``device`` (the card by default;
    ``"cpu"`` only when asked for). Each payload is shaped
    ``[num_layers, num_blocks, num_heads, block_size, head_dim]`` — per
    layer, the paged kernel's ``[N, H, B, d]`` layout, contiguous.

    float32 and bfloat16 configs return bare tensors. Quantized configs
    return each pool as the JAX package's ``(payload, scales, cal)``
    tuple: the 1-byte payload, per-block scales ``[L, N, H]`` fp32
    (zero, so an unwritten block dequantizes to 0.0 as a float pool
    would), and the write scale ``[L, H]`` from ``k_absmax`` /
    ``v_absmax`` (``kv_quant_cal``)."""
    if config.dtype not in _POOL_DTYPES:
        raise NotImplementedError(
            f"KV pools of dtype {config.dtype!r} are not ported: the "
            f"paged-attention kernel has lanes for {list(_POOL_DTYPES)} "
            "(ROADMAP C4)")
    dev = resolve_device(device)
    shape = (config.num_layers, config.num_blocks, config.num_heads,
             config.block_size, config.head_dim)
    dt = kv_storage_dtype(config)
    if not config.quantized:
        return (torch.zeros(shape, dtype=dt, device=dev),
                torch.zeros(shape, dtype=dt, device=dev))

    def pool(absmax):
        return (torch.zeros(shape, dtype=dt, device=dev),
                torch.zeros(shape[:3], dtype=torch.float32, device=dev),
                kv_quant_cal(config, absmax, dev))

    return pool(k_absmax), pool(v_absmax)


def kv_pool_hbm_bytes(num_layers: int, num_heads: int, head_dim: int,
                      block_size: int, num_blocks: int,
                      dtype: str = "float32") -> int:
    """``KVCacheConfig.hbm_bytes`` for callers that never build a config
    (a sizing tool's KV and draft-model flags)."""
    return KVCacheConfig(num_layers=num_layers, num_heads=num_heads,
                         head_dim=head_dim, block_size=block_size,
                         num_blocks=num_blocks, dtype=dtype).hbm_bytes
