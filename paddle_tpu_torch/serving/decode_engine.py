"""DecodeEngine — continuous-batching autoregressive serving on the card.

The port of the JAX package's ``serving/decode_engine.py``: chunked or
whole-prompt prefill, continuous or static admission, prefix cache on
or off, with a float32, bfloat16, int8 or fp8 KV pool and fp32 or
quantized projection weights, speculative decoding and copy-on-write
beams. An **iteration-level** loop (the vLLM/Orca policy) runs on its
own thread: every turn retires slots that finished, admits waiting
requests into free slots, then advances every resident request.

- **Chunked prefill** (``prefill_mode="chunked"``, the default): each
  turn is ONE ``mixed_step`` whose rows are every decoding slot's next
  token plus up to ``prefill_token_budget`` tokens of prompt chunks for
  slots still mid-prefill.
- **Whole-prompt prefill** (``prefill_mode="whole"``): admission runs
  one synchronous ``prefill`` of the prompt's cold tail, padded up the
  ``prompt_rungs`` ladder, which emits the first token; each turn is
  then ONE ``decode_step`` over every slot.
- **Static admission** (``admission="static"``): admit only into an
  idle engine and drain fully (the synchronous baseline).

Slot ids, positions and validity are data, so a step's shapes never
change with batch composition, and a request's greedy tokens are the
same solo or inside a churning batch.

- **Prefix cache**: admission content-hashes the prompt's full blocks
  and reacquires published blocks by refcount; only the cold tail is
  prefilled (a hit is capped at ``(len-1)//block_size`` blocks, so at
  least one token always runs and emits the first generated token).
  Chunked mode publishes a prompt's block hashes only when its prefill
  completes, so a half-written block is never acquirable; whole mode
  publishes them right after the prompt's one prefill dispatch.
  ``prefix_cache=False`` neither acquires nor publishes.
- **Preemption**: when the pool runs dry while a context grows, the
  most recently admitted request is freed and requeued at the FRONT of
  the queue; greedy decoding restarts deterministically.
- **Quantized execution**: an int8/fp8-e4m3 ``kv_config`` stores K/V
  at one byte per element with per-block scales, written under
  per-layer/head scales from ``kv_calibration`` or a one-time dense
  prefill probe; ``quant_plan`` sends the projections through the
  quantized matmul kernel.
- **Speculative decoding** (``speculate_k=γ`` with a draft model): a
  round runs γ chained draft ``decode_step`` calls (the argmax stays on
  the card between them), then ONE target ``decode_chunk`` over
  ``[pending, draft_1..γ]``; the proposals and the verify tokens come
  back in one host copy. Greedy accept keeps the longest agreeing
  prefix, emitting at most γ tokens a round, so the draft pool's
  written horizon equals ``seq_lens`` afterwards; rollback is a length
  rollback plus a refcount release of trailing blocks. The draft pool
  lies on the target pool's block grid (same block size, count and
  dtype), so one BlockPool and one table array serve both, and every
  prefill writes both. Each verify row is the same per-row fold as a
  plain step, so speculative greedy tokens are plain greedy's.
- **CoW beams**: ``generate_beam`` rides the same pool: the K beams
  share the prompt's blocks by refcount and copy a block (its payload
  and, in a quantized pool, its stored scale row) only when a beam
  first writes into a block another owner still holds. Host scoring is
  ``decode.beam_search``'s, operation for operation; ``impl="dense"``
  runs the dense-cache oracle instead.

The argmax stays on the device; the one host fence per dispatch is
reading the tokens back (with the EOS flags in whole mode, as one small
buffer). The pools are updated in place.

- **Serving goodput** (``obs/servegoodput.py``), always on: the loop
  books its wall time into components (``prefill_stall``,
  ``chunked_prefill``, ``decode_compute``, ``host_batching``,
  ``spec_overhead``, ``cow_copy``, ``idle``), each measured directly,
  and reconciles them against the loop's own wall clock
  (``goodput_snapshot``, ``stats()["goodput"]``).
- **Lifecycle ledger** (``ledger=True``, a ring of ``ledger_ring``
  retired requests): each request keeps its events (submit, admit,
  prefill or chunks, steps, speculation rounds, preemptions, first
  token, finish) and an exact four-part TTFT decomposition
  (``retired_ledgers``, ``requestz``); a beam call keeps a mini-ledger
  with its copy-on-write events.
- **Telemetry** (``telemetry=``, an ``obs.Telemetry``): the metrics go
  to its registry, each request opens a ``serving_request`` span
  (carrying a caller's ``submit(trace_context=)``) with its prefill
  spans under it, sampled / slow / preempted requests export their
  ledger as child spans, the loop runs under the flight recorder's
  guard and ticks the alert rules every 32 turns.

Not ported yet: the compile cache (``compile_cache=``,
``compile_count``) raises ``NotImplementedError`` naming ROADMAP item
A6.7.

Metric names are the decode contract of the JAX package's
``docs/serving.md``.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.decode import NEG, BeamResult, beam_search, greedy_step
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.obs.metrics import (LATENCY_BUCKETS_MS,
                                          MetricsRegistry)
from paddle_tpu_torch.obs.servegoodput import (COMPONENTS,
                                               decompose_serving,
                                               render_timeline)
from paddle_tpu_torch.obs.telemetry import Telemetry
from paddle_tpu_torch.serving import decode_model as dm
from paddle_tpu_torch.serving.batcher import ServingOverloadError
from paddle_tpu_torch.serving.kvcache import (BlockPool, KVCacheConfig,
                                              OutOfBlocksError,
                                              chain_block_hashes,
                                              make_pools)

__all__ = ["DecodeEngine", "DecodeResult", "DecodeRequest"]

_request_ids = itertools.count(1)

# lifecycle-ledger bounds: per-request event cap (a runaway generation
# must not grow an unbounded host list), span-export sampling (every
# Nth retired request exports its ledger as child spans), and the TTFT
# past which a request always exports (slow requests are the ones the
# spans exist to explain)
_MAX_LEDGER_EVENTS = 2048
_LEDGER_SAMPLE_EVERY = 16
_SLOW_TTFT_MS = 250.0
# decode-loop turns between alert-engine ticks (the burn-rate SLO
# rules need evaluations even when no trainer loop is stepping)
_ALERT_TICK_TURNS = 32


def _probe_kv_absmax(cfg, params, probe_len: int = 64,
                     margin: float = 1.5, seed: int = 0):
    """Default quantized-KV calibration, as the JAX engine's: one dense
    prefill over ``probe_len`` seeded tokens measures the model's
    per-layer/head K/V absmax, widened by ``margin`` so decode-time
    values a bit past the probe's range still land inside the
    quantizer's clip. Returns ``(k_absmax, v_absmax)`` float32 numpy
    arrays [L, H]."""
    probe_len = int(min(cfg.max_seq_len, probe_len))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, probe_len, dtype=np.int64)
    kc, vc = dm.dense_prefill(cfg, params, toks, probe_len)
    # caches are [L, H, T, d] with garbage past probe_len: slice first
    k_absmax = kc[:, :, :probe_len].abs().amax(dim=(2, 3)).cpu().numpy()
    v_absmax = vc[:, :, :probe_len].abs().amax(dim=(2, 3)).cpu().numpy()
    return k_absmax * margin, v_absmax * margin


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch engine yet: ROADMAP item "
        f"{item}")


class DecodeResult(NamedTuple):
    """One finished generation. ``tokens`` includes the terminating EOS
    when the model emitted one (cap/truncation retires don't)."""
    tokens: np.ndarray          # [n] int32 generated tokens
    ttft_ms: float              # submit -> first token
    tpot_ms: Optional[float]    # mean per-token after the first
    preempts: int               # times this request was restarted
    request_id: int


class DecodeRequest:
    """One queued/in-flight generation."""

    __slots__ = ("prompt", "max_new", "rung", "future", "request_id",
                 "t_submit", "t_ns", "span_sid", "generated", "t_first",
                 "preempts", "admit_seq", "events", "stall_mark",
                 "stall_behind_ms", "redo_ms", "own_prefill_ms",
                 "stint_t0")

    def __init__(self, prompt: np.ndarray, max_new: int, rung: int):
        self.prompt = prompt
        self.max_new = int(max_new)
        self.rung = int(rung)          # prompt rung (0 in chunked mode)
        self.future: Future = Future()
        self.request_id = next(_request_ids)
        self.t_submit = time.perf_counter()
        self.t_ns = time.monotonic_ns()
        self.span_sid = None           # the serving_request span's id
        self.generated: List[int] = []
        self.t_first: Optional[float] = None
        self.preempts = 0
        self.admit_seq = -1
        # ---- lifecycle ledger (cheap host tuples, no tracer spans):
        # the event timeline plus the TTFT-decomposition accumulators.
        # ``stall_mark`` marks the engine's cumulative-prefill clock at
        # each queue-stint start; the delta at admission is the prefill
        # time OTHER requests ran while this one waited.
        self.events: List[tuple] = []
        self.stall_mark = 0.0
        self.stall_behind_ms = 0.0
        self.redo_ms = 0.0           # work discarded by preemptions
        self.own_prefill_ms = 0.0    # final stint's prefill dispatch
        self.stint_t0: Optional[float] = None   # current stint start

    def reset(self):
        """Preemption: back to the prompt; the Future survives (and so
        do the ledger accumulators — redo/stall keep integrating)."""
        self.generated = []
        self.t_first = None
        self.admit_seq = -1
        self.own_prefill_ms = 0.0
        self.stint_t0 = None


class DecodeEngine:
    """Serve autoregressive generations to many concurrent clients.

    ``cfg``: the DecoderConfig; ``params``: its weights as a dict of
    tensors on ``device`` (default: fresh ``init_params(cfg, seed,
    device)``). ``device``: the card by default; ``"cpu"`` runs every
    kernel's plain version and must be asked for. ``kv_config`` (or
    ``block_size`` / ``num_blocks``) sizes the paged pool;
    ``max_slots``: resident requests; ``chunk_size`` (default 4 blocks)
    and ``prefill_token_budget`` (default one chunk) shape the mixed
    step, which has ``max_slots + prefill_token_budget`` rows.
    ``prefill_mode="whole"`` instead prefills each prompt's cold tail
    in one dispatch padded to the smallest of ``prompt_rungs`` that
    holds it (a longer prompt is refused at ``submit``) and decodes
    with one ``decode_step`` over all slots; ``admission="static"``
    admits only into an idle engine. ``prefix_cache``: content-hash
    and share full prompt blocks (default on). A context may grow to
    ``max_context`` (default ``min(cfg.max_seq_len, pool capacity)``).

    Quantized execution: a ``kv_config`` of dtype int8 or fp8-e4m3
    makes the pools ``(payload, scales, cal)`` tuples, with write
    scales from ``kv_calibration`` (``(k_absmax, v_absmax)`` [L, H]) or
    a dense-prefill probe; bfloat16 stores bare bf16 pools.
    ``quant_plan`` ("int8", "fp8-e4m3", or a plan object with
    ``.decisions``) replaces the projection weights with 1-byte
    payloads served by the quantized matmul kernel; the probe runs on
    the quantized weights, as in the JAX engine.

    ``speculate_k`` / ``draft_cfg`` / ``draft_params``: the speculative
    lane, γ draft proposals a round verified by one target chunk (the
    draft's weights default to ``init_params(draft_cfg, seed)``; they
    stay unquantized, and a quantized pool gives the draft a pool of
    the same dtype with its own calibration probe). Greedy tokens stay
    plain greedy's; only the dispatch count changes.

    ``attn_impl``: the JAX engine's switch between its Pallas kernel and
    its reference. Here the device decides: ``"auto"`` (the default)
    takes the kernels on the card and their plain versions on the CPU;
    ``"kernel"`` is accepted on the card and ``"reference"`` on the CPU,
    and any other pairing raises ``ValueError``.

    ``telemetry``: an ``obs.Telemetry`` (True for a default session,
    None or False for none) whose registry takes the engine's metrics;
    ``ledger`` / ``ledger_ring``: keep each retired request's lifecycle
    ledger in a ring of that many (the serving-goodput decomposition
    runs either way).
    """

    def __init__(self, cfg: dm.DecoderConfig, params=None, *,
                 kv_config: Optional[KVCacheConfig] = None,
                 block_size: int = 16, num_blocks: int = 256,
                 max_slots: int = 8,
                 prompt_rungs: Sequence[int] = (8, 16, 32),
                 max_new_tokens: int = 32,
                 max_context: Optional[int] = None,
                 eos_id: int = 0,
                 attn_impl: str = "auto",
                 admission: str = "continuous",
                 prefill_mode: str = "chunked",
                 chunk_size: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None,
                 max_queue: int = 256,
                 compile_cache=None,
                 telemetry=None,
                 seed: int = 0,
                 prefix_cache: bool = True,
                 draft_cfg: Optional[dm.DecoderConfig] = None,
                 draft_params=None,
                 speculate_k: int = 0,
                 quant_plan=None,
                 kv_calibration=None,
                 ledger: bool = True,
                 ledger_ring: int = 256,
                 device=None,
                 autostart: bool = True):
        if admission not in ("continuous", "static"):
            raise ValueError(f"admission must be continuous|static, "
                             f"got {admission!r}")
        if prefill_mode not in ("chunked", "whole"):
            raise ValueError(f"prefill_mode must be chunked|whole, "
                             f"got {prefill_mode!r}")
        if speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got "
                             f"{speculate_k}")
        if speculate_k > 0 and draft_cfg is None:
            raise ValueError("speculate_k > 0 requires a draft_cfg")
        if compile_cache is not None:
            raise _not_ported("compile_cache", "A6.7")
        self.cfg = cfg
        self.kv = kv_config or cfg.kv_config(block_size, num_blocks)
        if (self.kv.num_layers, self.kv.num_heads, self.kv.head_dim) != \
                (cfg.n_layers, cfg.n_heads, cfg.head_dim):
            raise ValueError(
                f"kv_config {self.kv.describe()} does not match the "
                f"model (layers/heads/head_dim = {cfg.n_layers}/"
                f"{cfg.n_heads}/{cfg.head_dim})")
        self.device = resolve_device(device)
        want = {"cuda": "kernel", "cpu": "reference"}.get(self.device.type)
        if attn_impl not in ("auto", want):
            raise ValueError(
                f"attn_impl={attn_impl!r} on {self.device}: the device "
                f"picks the attention here (a CUDA tensor goes to the "
                f"kernel, a CPU tensor to the plain version), so only "
                f"'auto' or {want!r} is accepted")
        self.attn_impl = want
        if params is None:
            params = dm.init_params(cfg, seed, self.device)
        for name, p in params.items():
            if p.device != self.device:
                raise ValueError(f"param {name!r} is on {p.device}, the "
                                 f"engine on {self.device}")
        # quantized projections: the plan rewrites the param dict once,
        # BEFORE the KV probe, so the probe sees the served weights
        self.quant_plan = quant_plan
        if quant_plan is not None:
            params = dm.quantize_decoder_params(cfg, params, quant_plan)
        self.params = params
        self.max_slots = int(max_slots)
        self.prompt_rungs = tuple(sorted(int(r) for r in prompt_rungs))
        if not self.prompt_rungs:
            raise ValueError("prompt_rungs must be non-empty")
        self.default_max_new = int(max_new_tokens)
        self.max_context = int(max_context if max_context is not None
                               else min(cfg.max_seq_len,
                                        self.kv.max_tokens))
        if self.max_context > cfg.max_seq_len:
            raise ValueError(
                f"max_context {self.max_context} exceeds the model's "
                f"max_seq_len {cfg.max_seq_len}")
        self.eos_id = int(eos_id)
        self.admission = admission
        self.prefill_mode = prefill_mode
        self.max_queue = int(max_queue)
        # every slot may grow to max_context: the block-table width
        self.max_pages = self.kv.blocks_for(self.max_context)
        self.prefix_cache = bool(prefix_cache)

        # ---- speculative lane: the draft pool lies on the target pool's
        # block grid (same block_size / num_blocks / dtype), so ONE
        # BlockPool and one table array account for both, and a prefix
        # hit carries both pools' content (both models' K/V at a
        # position are functions of the same token prefix)
        self.speculate_k = int(speculate_k)
        self.draft_cfg = draft_cfg if self.speculate_k > 0 else None
        self.draft_kv = None
        self.draft_params = None
        if self.draft_cfg is not None:
            if self.draft_cfg.max_seq_len < self.max_context:
                raise ValueError(
                    f"draft max_seq_len {self.draft_cfg.max_seq_len} "
                    f"< max_context {self.max_context}")
            if self.draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft vocab differs from target")
            self.draft_kv = self.draft_cfg.kv_config(
                self.kv.block_size, self.kv.num_blocks, self.kv.dtype)
            if draft_params is None:
                draft_params = dm.init_params(self.draft_cfg, seed,
                                              self.device)
            for name, p in draft_params.items():
                if p.device != self.device:
                    raise ValueError(
                        f"draft param {name!r} is on {p.device}, the "
                        f"engine on {self.device}")
            self.draft_params = draft_params

        # ---- chunked prefill: prompts stream into the mixed step as
        # fixed-size token chunks under a per-step budget. The default
        # chunk is block-aligned (4 blocks); any size is correct — the
        # mixed step's per-row positions handle a chunk starting
        # mid-block.
        self.chunk_size = int(chunk_size if chunk_size is not None
                              else 4 * self.kv.block_size)
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got "
                             f"{chunk_size}")
        self.prefill_budget = int(
            prefill_token_budget if prefill_token_budget is not None
            else self.chunk_size)
        if self.prefill_budget < 1:
            raise ValueError(f"prefill_token_budget must be >= 1, got "
                             f"{prefill_token_budget}")
        # mixed-step width: one decode row per slot + the chunk budget
        self._mixed_rows = self.max_slots + self.prefill_budget

        self.pool = BlockPool(self.kv)
        k_cal = v_cal = None
        if self.kv.quantized:
            if kv_calibration is not None:
                k_cal, v_cal = kv_calibration
            else:
                k_cal, v_cal = _probe_kv_absmax(cfg, self.params)
        self._k_pool, self._v_pool = make_pools(
            self.kv, self.device, k_absmax=k_cal, v_absmax=v_cal)
        self._dk_pool = self._dv_pool = None
        if self.draft_kv is not None:
            dk_cal = dv_cal = None
            if self.draft_kv.quantized:   # the draft's own probe
                dk_cal, dv_cal = _probe_kv_absmax(self.draft_cfg,
                                                  self.draft_params)
            self._dk_pool, self._dv_pool = make_pools(
                self.draft_kv, self.device, k_absmax=dk_cal,
                v_absmax=dv_cal)
        self._tokens = np.zeros((self.max_slots,), np.int32)
        self._seq_lens = np.zeros((self.max_slots,), np.int32)
        self._active = np.zeros((self.max_slots,), bool)
        self._tables = np.zeros((self.max_slots, self.max_pages),
                                np.int32)
        # per-slot prefill progress: > 0 = the slot is mid-prefill
        # toward that prompt length (its decode row is masked); content
        # hashes publish only at completion
        self._prefill_target = np.zeros((self.max_slots,), np.int32)
        self._slot_hashes: List[List[str]] = \
            [[] for _ in range(self.max_slots)]
        self._slots: List[Optional[DecodeRequest]] = \
            [None] * self.max_slots
        self._admit_seq = itertools.count()
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # serializes device dispatch + pool mutation between the loop
        # thread and a caller's warmup()
        self._device_lock = threading.Lock()
        self._occ_steps = 0
        self._tot_steps = 0
        self._spec_rounds = 0       # slot-rounds (per slot per verify)
        self._spec_accepted = 0
        self._verify_steps = 0      # verify dispatches
        self.cow_copies = 0         # blocks copied by the beam lane
        # ---- serving-goodput observatory (obs/servegoodput.py): the
        # loop-wall component accumulators, the cumulative-prefill
        # clock queued requests measure their stall against, and the
        # bounded ring of retired-request ledgers
        self._ledger_on = bool(ledger)
        self._retired: deque = deque(maxlen=max(1, int(ledger_ring)))
        self._retire_seq = 0
        self._comp_ms: Dict[str, float] = {k: 0.0 for k in COMPONENTS}
        self._loop_wall_ms = 0.0
        self._loop_turns = 0
        self._cum_prefill_ms = 0.0
        self._step_seq = 0
        self._closed = False
        self._started = False
        self._warmed = False
        self._thread: Optional[threading.Thread] = None

        # (the compile-cache hooks, Telemetry.record_compile_cache, go
        # with the compile cache itself: ROADMAP A6.7)
        self.telemetry = Telemetry.ensure(telemetry)
        # ---- metrics (names are the docs/serving.md decode contract)
        reg = (self.telemetry.registry if self.telemetry is not None
               else MetricsRegistry("decode"))
        self.registry = reg
        self._requests = reg.counter(
            "decode_requests_total", "generations accepted by submit()")
        self._rejected = reg.counter(
            "decode_rejected_total",
            "generations rejected with ServingOverloadError")
        self._tokens_total = reg.counter(
            "decode_tokens_total", "tokens generated (all requests)")
        self._steps_total = reg.counter(
            "decode_steps_total", "decode iterations dispatched")
        self._prefills = reg.counter(
            "decode_prefills_total", "prefill dispatches (admissions)")
        self._preempted = reg.counter(
            "decode_preempted_total",
            "requests preempted for KV blocks and requeued")
        self._ttft_ms = reg.histogram(
            "decode_ttft_ms", "submit() to first generated token",
            buckets=LATENCY_BUCKETS_MS)
        self._tpot_ms = reg.histogram(
            "decode_tpot_ms",
            "mean per-token latency after the first, per request",
            buckets=LATENCY_BUCKETS_MS)
        self._step_ms = reg.histogram(
            "decode_step_ms", "one decode iteration, dispatch+fence",
            buckets=LATENCY_BUCKETS_MS)
        self._queue_age_ms = reg.histogram(
            "serving_queue_age_ms",
            "queue wait per request at flush/admission",
            buckets=LATENCY_BUCKETS_MS)
        self._occupancy = reg.gauge(
            "decode_slot_occupancy", "active slots / max_slots")
        self._kv_in_use = reg.gauge(
            "decode_kv_blocks_in_use", "KV pool blocks backing live "
            "contexts")
        self._kv_util = reg.gauge(
            "decode_kv_block_utilization", "KV blocks in use / pool")
        self._queue_depth = reg.gauge(
            "decode_queue_depth", "pending generations")
        self._prefix_hit_tokens = reg.counter(
            "decode_prefix_hit_tokens_total",
            "prompt tokens satisfied from the prefix cache (not "
            "prefilled)")
        self._prefix_miss_tokens = reg.counter(
            "decode_prefix_miss_tokens_total",
            "prompt tokens prefilled cold (the tail after the hit)")
        self._kv_shared = reg.gauge(
            "kv_blocks_shared",
            "KV blocks referenced by more than one owner")
        self._kv_refs = reg.gauge(
            "kv_block_refs",
            "total block references across owners (>= blocks in use)")
        self._occ_frac = reg.gauge(
            "decode_slot_occupancy_frac",
            "occupied slot-steps / total slot-steps since boot")
        self._goodput_g = reg.gauge(
            "decode_goodput",
            "fenced decode-step compute ms / non-idle loop wall ms")
        self._comp_g = reg.gauge(
            "decode_component_ms",
            "cumulative decode-loop wall ms attributed to each "
            "component (obs/servegoodput.py decomposition)",
            ("component",))
        self._redo_ms_h = reg.histogram(
            "decode_preempted_redo_ms",
            "per retired request: wall ms of admissions + decode work "
            "discarded by preemptions (the redo cost TTFT silently "
            "absorbs; requires the lifecycle ledger)",
            buckets=LATENCY_BUCKETS_MS)
        self._chunk_tokens_h = reg.histogram(
            "decode_prefill_chunk_tokens",
            "prefill tokens scheduled per slot per mixed step "
            "(chunked prefill mode)",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                     256.0, 512.0))
        self._accept_len = reg.histogram(
            "decode_speculation_accept_len",
            "draft tokens accepted per verify round (0..gamma)",
            buckets=tuple(float(i) for i in
                          range(max(self.speculate_k, 4) + 1)))
        self._fill_frac_g = reg.gauge(
            "decode_mixed_step_fill_frac",
            "prefill-token share of the last mixed step's valid rows "
            "(0 = pure decode, 1 = pure prefill)")
        self._fill_frac_g.set(0.0)
        if self.telemetry is not None:
            self.telemetry.register_status("decode", self.stats)
            self.telemetry.register_requests("decode", self.requestz)
        if autostart:
            self.start()

    # ------------------------------------------------------- dispatch
    @property
    def _spec_on(self) -> bool:
        return self.speculate_k > 0

    def _upload(self, *arrays):
        """Host int arrays -> ONE int32 buffer on the device."""
        return torch.from_numpy(np.concatenate(
            [np.asarray(a).reshape(-1) for a in arrays]).astype(
                np.int32)).to(self.device)

    def _dispatch_mixed_rows(self, tokens, row_slots, positions, valid,
                             tables):
        """Run one mixed step on host-built row arrays and return the
        fenced per-row argmax tokens. The rows and tables go to the
        device as ONE int32 buffer; the argmax runs there, and reading
        its [T] result back is the step's only host fence. With the
        speculative lane on, the same rows also write the DRAFT pool."""
        T = self._mixed_rows
        buf = self._upload(tokens, row_slots, positions,
                           valid.astype(np.int32), tables)
        rows = buf[:4 * T].view(4, T)
        args = (rows[0], rows[1], rows[2], rows[3].bool(),
                buf[4 * T:].view(self.max_slots, self.max_pages))
        logits, _, _ = dm.mixed_step(
            self.cfg, self.params, self._k_pool, self._v_pool, *args,
            write_limit=self.max_context)
        if self._spec_on:
            dm.mixed_step(self.draft_cfg, self.draft_params,
                          self._dk_pool, self._dv_pool, *args,
                          write_limit=self.max_context)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        return toks.cpu().numpy()

    def _mixed_prefill_tail(self, tail, start_len: int, table_row):
        """Write one table row's cold prompt tail through the mixed step
        (the beam lane's prefix admission in chunked mode): chunks of up
        to the step's full row count stream through slot 0 of a scratch
        table whose row 0 is ``table_row``; resident slots' state is not
        touched."""
        T = self._mixed_rows
        tables = np.zeros((self.max_slots, self.max_pages), np.int32)
        tables[0] = table_row
        tail = np.asarray(tail, np.int32)
        zeros = np.zeros((T,), np.int32)
        for done in range(0, int(tail.size), T):
            take = min(T, int(tail.size) - done)
            tokens = zeros.copy()
            positions = zeros.copy()
            valid = np.zeros((T,), bool)
            tokens[:take] = tail[done:done + take]
            positions[:take] = np.arange(start_len + done,
                                         start_len + done + take)
            valid[:take] = True
            self._dispatch_mixed_rows(tokens, zeros, positions, valid,
                                      tables)

    def _dispatch_spec(self, dec):
        """One speculative round's dispatches over the slots in ``dec``:
        γ chained draft ``decode_step`` calls proposing a token each (a
        slot stops writing at ``max_context``; the argmax stays on the
        device between steps), then ONE target ``decode_chunk`` over
        ``[pending, draft_1..γ]`` at positions ``seq_lens ..
        seq_lens+γ``. Returns the fenced ``(proposals [S, γ], verify
        tokens [S, γ+1])``, read back together in one copy."""
        S, P, gamma = self.max_slots, self.max_pages, self.speculate_k
        mc = self.max_context
        buf = self._upload(self._tokens, self._seq_lens,
                           dec.astype(np.int32), self._tables)
        pending, seq_lens = buf[:S], buf[S:2 * S]
        active = buf[2 * S:3 * S].bool()
        tables = buf[3 * S:].view(S, P)
        tok, lens, props = pending, seq_lens, []
        for _ in range(gamma):
            eff = active & (lens < mc)    # never write past the context
            logits, _, _ = dm.decode_step(
                self.draft_cfg, self.draft_params, self._dk_pool,
                self._dv_pool, tok, tables, lens, eff)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            props.append(tok)
            lens = lens + 1
        props = torch.stack(props, dim=1)                    # [S, γ]
        chunk = torch.cat([pending[:, None], props], dim=1)  # [S, γ+1]
        q_lens = torch.full_like(seq_lens, gamma + 1)
        logits, _, _ = dm.decode_chunk(
            self.cfg, self.params, self._k_pool, self._v_pool, chunk,
            tables, seq_lens, q_lens, active, write_limit=mc)
        verify = torch.argmax(logits, dim=-1).to(torch.int32)
        out = torch.cat([props, verify], dim=1).cpu().numpy()
        return out[:, :gamma], out[:, gamma:]

    def _dispatch_decode(self):
        """Run one whole-mode ``decode_step`` over every slot (tokens,
        lengths, activity and tables go to the device as ONE int32
        buffer) and return the fenced ``(next_token [S], done [S])``:
        the greedy head runs on the device, inactive slots frozen on EOS,
        and ``done = active & (next == eos)``; the two come back as one
        [2, S] read, the dispatch's only host fence."""
        S = self.max_slots
        buf = self._upload(self._tokens, self._seq_lens,
                           self._active.astype(np.int32), self._tables)
        active = buf[2 * S:3 * S].bool()
        logits, _, _ = dm.decode_step(
            self.cfg, self.params, self._k_pool, self._v_pool, buf[:S],
            buf[3 * S:].view(S, self.max_pages), buf[S:2 * S], active)
        nxt, _fin = greedy_step(logits, ~active, self.eos_id)
        done = active & (nxt == self.eos_id)
        out = torch.stack([nxt, done.to(torch.int32)]).cpu().numpy()
        return out[0], out[1].astype(bool)

    def _dispatch_prefill(self, padded, tail_len: int, start_len: int,
                          row):
        """Run one whole-mode ``prefill`` of a padded prompt tail at
        absolute position ``start_len`` (the prefix-hit length); the
        tokens and the table row go to the device as ONE int32 buffer,
        the lengths stay host ints. Returns the fenced ``(first_token,
        done)``, read back together (never the [vocab] logits)."""
        R = padded.shape[0]
        buf = self._upload(padded, row)
        logits_last, _, _ = dm.prefill(
            self.cfg, self.params, self._k_pool, self._v_pool, buf[:R],
            tail_len, start_len, buf[R:], write_limit=self.max_context)
        if self._spec_on:       # the draft pool too, in the same turn
            dm.prefill(self.draft_cfg, self.draft_params, self._dk_pool,
                       self._dv_pool, buf[:R], tail_len, start_len,
                       buf[R:], write_limit=self.max_context)
        nxt, _fin = greedy_step(
            logits_last[None, :],
            torch.zeros((1,), dtype=torch.bool, device=self.device),
            self.eos_id)
        out = torch.stack([nxt[0], (nxt[0] == self.eos_id).to(
            torch.int32)]).cpu().numpy()
        return int(out[0]), bool(out[1])

    # ------------------------------------------------------------ warmup
    def warmup(self) -> int:
        """Dispatch every step shape once on inert inputs before traffic
        (all rows invalid / slots inactive / true_len 0: every K/V write
        is a no-op, so the pool stays clean). On the card this builds
        and launches the steps' kernels once. Returns the number of
        step shapes the engine serves, counted as the JAX engine counts
        its entries: 1 in chunked mode (the mixed step), ``1 +
        len(prompt_rungs)`` in whole mode (the decode step and one
        prefill per rung), and 2 more with the speculative lane (the
        draft scan and the verify chunk)."""
        with self._device_lock:
            if self.prefill_mode == "chunked":
                T = self._mixed_rows
                zeros = np.zeros((T,), np.int32)
                self._dispatch_mixed_rows(zeros, zeros, zeros,
                                          np.zeros((T,), bool),
                                          self._tables)
                n = 1
            else:
                self._dispatch_decode()
                zero_row = np.zeros((self.max_pages,), np.int32)
                for rung in self.prompt_rungs:
                    self._dispatch_prefill(np.zeros((rung,), np.int32),
                                           0, 0, zero_row)
                n = 1 + len(self.prompt_rungs)
            if self._spec_on:
                self._dispatch_spec(np.zeros((self.max_slots,), bool))
                n += 2
        self._warmed = True
        return n

    @property
    def compile_count(self) -> int:
        """The JAX engine's count of compiled entries (its compile
        cache's bookkeeping): raises, naming ROADMAP A6.7."""
        raise _not_ported("compile_count (the compile cache's entry "
                          "count)", "A6.7")

    # ------------------------------------------------------------- client
    def _rung_for(self, n: int) -> int:
        for r in self.prompt_rungs:
            if n <= r:
                return r
        raise ValueError(
            f"prompt of {n} tokens exceeds the largest prompt rung "
            f"{self.prompt_rungs[-1]}")

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               trace_context: Optional[dict] = None) -> Future:
        """Queue one generation; returns a Future resolving to a
        ``DecodeResult``. Raises ``ServingOverloadError`` past
        ``max_queue`` pending requests (explicit backpressure), and
        ``ValueError`` for prompts that can never fit.

        ``trace_context`` is an inherited cross-process wire context
        (``Tracer.wire_context``): with telemetry on, the
        ``serving_request`` span this engine opens then carries
        ``trace_id``/``remote_parent`` back to the root span the caller
        opened in its own process."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if not self._started:
            self.start()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        # chunked mode has no prompt ladder: any prompt that leaves room
        # to generate within max_context is admissible; rung is 0 there
        rung = (self._rung_for(prompt.size)
                if self.prefill_mode == "whole" else 0)
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.default_max_new)
        max_new = min(max_new, self.max_context - int(prompt.size))
        if max_new < 1:
            raise ValueError(
                f"prompt of {prompt.size} tokens leaves no room to "
                f"generate within max_context {self.max_context}")
        if self.kv.blocks_for(int(prompt.size) + max_new) \
                > self.kv.num_blocks:
            raise ValueError(
                f"prompt+max_new needs more KV blocks than the pool "
                f"holds ({self.kv.num_blocks}); shrink the request or "
                "grow num_blocks")
        req = DecodeRequest(prompt, max_new, rung)
        if self._ledger_on:
            req.events.append(("submit", 0.0))
            req.stall_mark = self._cum_prefill_ms
        tel = self.telemetry
        if tel is not None:
            req.span_sid = tel.tracer.start_span(
                "serving_request", request_id=req.request_id,
                kind="decode", prompt_tokens=int(prompt.size),
                ctx=trace_context)
        with self._cv:
            if len(self._pending) >= self.max_queue:
                self._rejected.inc()
                if tel is not None:
                    tel.tracer.end_span(req.span_sid, rejected=True)
                raise ServingOverloadError(
                    f"queue full ({self.max_queue} pending "
                    "generations); retry with backoff")
            self._pending.append(req)
            self._cv.notify_all()
        self._requests.inc()
        self._queue_depth.set(self.queue_depth)
        return req.future

    def generate(self, prompt: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None) -> DecodeResult:
        """Synchronous convenience wrapper: submit + wait."""
        return self.submit(prompt, max_new_tokens).result(timeout=timeout)

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    # ----------------------------------------------------------- the loop
    def start(self):
        if self._started:
            return
        self._started = True
        self._thread = threading.Thread(target=self._run,
                                        name="decode-loop", daemon=True)
        self._thread.start()

    def _run(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)   # this thread's card
        fl = self.telemetry.flight if self.telemetry is not None else None
        if fl is not None:
            with fl.guard("decode_loop"):
                self._loop()
        else:
            self._loop()

    def _loop(self):
        # loop wall accumulates turn-to-turn deltas (not per-phase
        # sums), so everything the thread did — including inter-turn
        # overhead — is inside the clock the component decomposition
        # must reconcile against; only measured cv-waits count as idle,
        # the rest of any gap is honest residual
        prev_end = time.perf_counter()
        while True:
            with self._cv:
                while (not self._pending
                       and not any(self._active)
                       and not self._closed):
                    t_wait = time.perf_counter()
                    self._cv.wait(timeout=0.05)
                    now = time.perf_counter()
                    self._comp_ms["idle"] += (now - t_wait) * 1e3
                    # advance the wall clock through the idle stretch
                    # too, so a snapshot taken while the engine sits
                    # empty still reconciles
                    self._loop_wall_ms += (now - prev_end) * 1e3
                    prev_end = now
                if (self._closed and not self._pending
                        and not any(self._active)):
                    return
            try:
                with self._device_lock:
                    self._admit()
                    if any(self._active):
                        if self.prefill_mode == "chunked":
                            self._iterate_chunked()
                        elif self._spec_on:
                            self._iterate_spec()
                        else:
                            self._iterate_whole()
            except Exception as exc:   # fail loudly into the futures
                self._fail_all(exc)
            now = time.perf_counter()
            self._loop_wall_ms += (now - prev_end) * 1e3
            prev_end = now
            self._loop_turns += 1
            if (self.telemetry is not None
                    and self._loop_turns % _ALERT_TICK_TURNS == 0):
                try:   # a host-side rule must not stop the loop
                    self.telemetry.alerts.evaluate()
                except Exception:
                    pass

    def _fail_all(self, exc):
        tel = self.telemetry
        for s in range(self.max_slots):
            r = self._slots[s]
            if r is None:
                continue
            self.pool.free(r.request_id)
            self._slots[s] = None
            self._active[s] = False
            self._prefill_target[s] = 0
            self._slot_hashes[s] = []
            if tel is not None:
                tel.tracer.end_span(r.span_sid, error=repr(exc))
            if not r.future.done():
                r.future.set_exception(exc)
        with self._cv:
            pending, self._pending = list(self._pending), deque()
        for r in pending:
            if tel is not None:
                tel.tracer.end_span(r.span_sid, error=repr(exc))
            if not r.future.done():
                r.future.set_exception(exc)

    # -------------------------------------------------------- admission
    def _free_slot(self) -> Optional[int]:
        for s in range(self.max_slots):
            if self._slots[s] is None:
                return s
        return None

    def _admit(self):
        """FIFO admission. Continuous: admit while a slot AND the
        prompt's blocks are available — never skipping ahead past the
        queue head. Static: only into an idle engine (the synchronous
        baseline)."""
        if self.admission == "static" and any(self._active):
            return
        t_adm0 = time.perf_counter()
        prefill_ms = 0.0
        while True:
            with self._cv:
                if not self._pending:
                    break
                head = self._pending[0]
                slot = self._free_slot()
                need = self.kv.blocks_for(int(head.prompt.size) + 1)
                if slot is None or not self.pool.can_alloc(need):
                    break
                self._pending.popleft()
            prefill_ms += self._admit_into(head, slot)
        self._queue_depth.set(self.queue_depth)
        # admission host work is measured directly (total admit phase
        # minus the fenced prefill dispatches inside it), NOT derived
        # as a residual — the 10% reconciliation stays falsifiable
        self._comp_ms["host_batching"] += max(
            (time.perf_counter() - t_adm0) * 1e3 - prefill_ms, 0.0)

    def _admit_into(self, r: DecodeRequest, slot: int) -> float:
        """Admit ``r`` into ``slot``: prefix-cache acquire, allocate the
        rest of the prompt's blocks, then either hand the slot to
        chunked prefill (``_finish_admit_chunked``) or run its whole
        prefill now (``_finish_admit_whole``). Returns the fenced
        prefill dispatch ms so ``_admit`` can subtract it from its
        host-batching time."""
        now_ns = time.monotonic_ns()
        self._queue_age_ms.observe((now_ns - r.t_ns) / 1e6)
        if self._ledger_on:
            # close the queue stint: the engine's cumulative-prefill
            # clock advanced only by OTHER requests' prefills while
            # this one waited (a queued request cannot prefill itself)
            r.stall_behind_ms += max(
                self._cum_prefill_ms - r.stall_mark, 0.0)
        toks = r.prompt
        bs = self.kv.block_size
        # ---- prefix cache: reacquire published FULL blocks by chained
        # content hash; the LAST hashable block is never a hit target
        # (cap below) so at least one tail token always prefills and
        # the step always emits the first generated token.
        hashes: List[str] = []
        hit_blocks: List[int] = []
        if self.prefix_cache:
            hashes = chain_block_hashes(toks, bs)
            cap = (int(toks.size) - 1) // bs
            for i in range(min(cap, len(hashes))):
                blk = self.pool.acquire_cached(hashes[i], r.request_id)
                if blk is None:
                    break
                hit_blocks.append(blk)
        hit_len = len(hit_blocks) * bs
        need = self.kv.blocks_for(int(toks.size) + 1) - len(hit_blocks)
        try:
            fresh = self.pool.alloc(need, r.request_id)
        except OutOfBlocksError:
            # _admit's can_alloc guard ignores hits, so this is
            # unreachable; stay leak-free if it ever fires
            self.pool.free(r.request_id)
            raise
        row = np.zeros((self.max_pages,), np.int32)
        row[:len(hit_blocks)] = hit_blocks
        row[len(hit_blocks):len(hit_blocks) + len(fresh)] = fresh
        if self.prefill_mode == "chunked":
            return self._finish_admit_chunked(r, slot, row, hashes,
                                              hit_len)
        return self._finish_admit_whole(r, slot, row, hashes, hit_len)

    def _finish_admit_whole(self, r: DecodeRequest, slot: int, row,
                            hashes: List[str], hit_len: int) -> float:
        """Whole-prompt admission: ONE synchronous prefill dispatch of
        the cold tail (padded to its own rung) at position ``hit_len``,
        which emits the first generated token; every full block of the
        prompt is published right away (a hit re-registers as a no-op:
        registration is first-wins). Returns the dispatch's ms."""
        tail = r.prompt[hit_len:]
        tail_rung = self._rung_for(int(tail.size))
        padded = np.zeros((tail_rung,), np.int32)
        padded[:tail.size] = tail
        t0 = time.perf_counter()
        t0_ns = time.monotonic_ns()
        try:
            tok, done = self._dispatch_prefill(padded, int(tail.size),
                                               hit_len, row)
        except Exception as exc:
            # not in a slot yet, so _fail_all would miss it: release its
            # blocks, close its span and fail its future here
            self.pool.free(r.request_id)
            if self.telemetry is not None:
                self.telemetry.tracer.end_span(r.span_sid,
                                               error=repr(exc))
            if not r.future.done():
                r.future.set_exception(exc)
            raise
        prefill_ms = (time.perf_counter() - t0) * 1e3
        self._comp_ms["prefill_stall"] += prefill_ms
        self._cum_prefill_ms += prefill_ms
        self._prefills.inc()
        self._prefix_hit_tokens.inc(hit_len)
        self._prefix_miss_tokens.inc(int(tail.size))
        for i, h in enumerate(hashes):
            self.pool.register(int(row[i]), h)
        r.admit_seq = next(self._admit_seq)
        r.t_first = time.perf_counter()
        r.generated.append(tok)
        self._tokens_total.inc()
        ttft_ms = (r.t_first - r.t_submit) * 1e3
        self._ttft_ms.observe(ttft_ms)
        if self._ledger_on:
            r.own_prefill_ms = prefill_ms
            r.stint_t0 = t0
            if len(r.events) < _MAX_LEDGER_EVENTS:
                rel = (t0 - r.t_submit) * 1e3
                r.events.append(("admit", round(rel, 3), hit_len,
                                 int(tail.size)))
                r.events.append(("prefill", round(rel, 3),
                                 round(prefill_ms, 3), tail_rung))
                r.events.append(("first_token", round(ttft_ms, 3)))
        if self.telemetry is not None:
            self.telemetry.tracer.emit_spans([(
                "decode_prefill", t0_ns, int(prefill_ms * 1e6),
                r.span_sid,
                {"request_id": r.request_id, "rung": tail_rung,
                 "prompt_tokens": int(r.prompt.size),
                 "prefix_hit_tokens": hit_len})])
        self._slots[slot] = r
        self._tokens[slot] = tok
        self._seq_lens[slot] = r.prompt.size
        self._active[slot] = True
        self._tables[slot] = row
        if done or len(r.generated) >= r.max_new:
            self._retire(slot)
        return prefill_ms

    def _finish_admit_chunked(self, r: DecodeRequest, slot: int,
                              row, hashes: List[str],
                              hit_len: int) -> float:
        """The slot becomes resident with all its prompt blocks
        allocated and ``_prefill_target`` set — NO dispatch, so
        admission never stalls the decode batch; the prompt streams
        through the mixed step in budgeted chunks starting next turn.
        Prefix-hit blocks short-circuit (``_seq_lens`` starts at the
        hit length). Content hashes are deferred to ``_slot_hashes``
        and publish only when the prefill completes. Returns 0.0 (no
        dispatch ran)."""
        toks = r.prompt
        tail = int(toks.size) - hit_len
        self._prefills.inc()
        self._prefix_hit_tokens.inc(hit_len)
        self._prefix_miss_tokens.inc(tail)
        r.admit_seq = next(self._admit_seq)
        if self._ledger_on:
            now = time.perf_counter()
            r.own_prefill_ms = 0.0
            r.stint_t0 = now
            if len(r.events) < _MAX_LEDGER_EVENTS:
                r.events.append(("admit",
                                 round((now - r.t_submit) * 1e3, 3),
                                 hit_len, tail))
        self._slots[slot] = r
        self._tokens[slot] = 0
        self._seq_lens[slot] = hit_len
        self._active[slot] = True
        self._tables[slot] = row
        self._prefill_target[slot] = int(toks.size)
        self._slot_hashes[slot] = list(hashes)
        return 0.0

    # ------------------------------------------------------ block growth
    def _preempt_latest(self) -> bool:
        """Free the most recently admitted active request and requeue
        it at the queue front (deterministic restart). False if fewer
        than two requests are active — then preemption cannot help."""
        victim_slot, victim = None, None
        for s in range(self.max_slots):
            r = self._slots[s]
            if r is not None and (victim is None
                                  or r.admit_seq > victim.admit_seq):
                victim_slot, victim = s, r
        if victim is None or sum(1 for r in self._slots
                                 if r is not None) < 2:
            return False
        self.pool.free(victim.request_id)
        self._slots[victim_slot] = None
        self._active[victim_slot] = False
        self._seq_lens[victim_slot] = 0
        self._tokens[victim_slot] = 0
        self._tables[victim_slot] = 0
        # a mid-prefill victim restarts its prompt from scratch; its
        # unpublished hashes die with the blocks
        self._prefill_target[victim_slot] = 0
        self._slot_hashes[victim_slot] = []
        if self._ledger_on:
            now = time.perf_counter()
            if victim.stint_t0 is not None:
                # everything since this stint's prefill started is
                # redone after the restart — the preemption redo cost
                victim.redo_ms += (now - victim.stint_t0) * 1e3
            if len(victim.events) < _MAX_LEDGER_EVENTS:
                victim.events.append(
                    ("preempt", round((now - victim.t_submit) * 1e3, 3)))
            victim.stall_mark = self._cum_prefill_ms   # reopen stint
        victim.reset()
        victim.preempts += 1
        self._preempted.inc()
        with self._cv:
            self._pending.appendleft(victim)
        self._queue_depth.set(self.queue_depth)
        return True

    def _ensure_blocks(self, horizon: int = 0):
        """Before a step writing at position ``seq_lens[s]`` (and, for a
        speculative round, up to ``seq_lens[s] + horizon``), every
        active slot must own the blocks covering its last write; grow
        where a slot crosses a boundary, preempting the newest request
        when the pool is dry. Writes never land past ``max_context -
        1`` (the steps mask them), so the horizon is clamped there."""
        for s in range(self.max_slots):
            r = self._slots[s]
            if r is None:
                continue
            # a mid-prefill slot allocated its whole prompt at admission;
            # a speculative horizon never applies to it
            last_write = min(
                int(self._seq_lens[s])
                + (0 if self._prefill_target[s] else horizon),
                self.max_context - 1)
            need_pages = last_write // self.kv.block_size + 1
            have = len(self.pool.owner_blocks(r.request_id))
            while have < need_pages and self._slots[s] is r:
                try:
                    blk = self.pool.alloc(1, r.request_id)[0]
                except OutOfBlocksError:
                    if not self._preempt_latest():
                        raise   # solo request outgrew the pool:
                        # submit() guards make this unreachable
                    continue   # victim may have been r itself
                self._tables[s, have] = blk
                have += 1

    # ------------------------------------------------------- the big step
    def _iterate_whole(self):
        """One whole-mode turn: ONE decode step over every slot, then
        retire on EOS, ``max_new`` or ``max_context``."""
        t_it0 = time.perf_counter()
        self._ensure_blocks()
        if not any(self._active):   # growth may have preempted everyone
            return
        occ = int(np.sum(self._active))
        t0 = time.perf_counter()
        nxt, done = self._dispatch_decode()
        step_ms = (time.perf_counter() - t0) * 1e3
        self._step_ms.observe(step_ms)
        self._steps_total.inc()
        self._comp_ms["decode_compute"] += step_ms
        self._step_seq += 1
        self._occ_steps += occ
        self._tot_steps += self.max_slots
        for s in range(self.max_slots):
            if self._slots[s] is not None:
                self._advance(s, int(nxt[s]), bool(done[s]), t0, occ)
        self._update_gauges()
        self._comp_ms["host_batching"] += max(
            (time.perf_counter() - t_it0) * 1e3 - step_ms, 0.0)

    def _advance(self, s: int, tok: int, done: bool, t0: float,
                 occ: int):
        """Slot ``s`` decoded ``tok`` at its write frontier in the step
        dispatched at ``t0`` over ``occ`` occupied slots: record it (and
        the ledger's ``step`` event), move the frontier, and retire on
        EOS (``done``), ``max_new`` or ``max_context``."""
        r = self._slots[s]
        r.generated.append(tok)
        self._tokens_total.inc()
        self._tokens[s] = tok
        self._seq_lens[s] += 1
        if self._ledger_on and len(r.events) < _MAX_LEDGER_EVENTS:
            r.events.append(("step", round((t0 - r.t_submit) * 1e3, 3),
                             self._step_seq, occ))
        if (done or len(r.generated) >= r.max_new
                or int(self._seq_lens[s]) + 1 >= self.max_context):
            self._retire(s)

    def _iterate_chunked(self):
        """One turn: pack this step's decode rows and a bounded budget
        of prefill-chunk rows into ONE mixed dispatch. With speculation
        on, the mixed step carries only prefill chunks (writing both
        pools) and the slots past their prefill decode by a speculative
        round in the same turn."""
        t_it0 = time.perf_counter()
        if self._spec_on:
            if np.any(self._active & (self._prefill_target > 0)):
                self._ensure_blocks()
                plan = self._plan_chunks(decode_rows=False)
                if plan is not None:
                    self._dispatch_mixed_step(plan, t_it0)
            if np.any(self._active & (self._prefill_target == 0)):
                self._iterate_spec()
            return
        self._ensure_blocks()
        if not any(self._active):   # growth may have preempted everyone
            return
        plan = self._plan_chunks(decode_rows=True)
        if plan is not None:
            self._dispatch_mixed_step(plan, t_it0)

    def _plan_chunks(self, decode_rows: bool):
        """Build the mixed step's row plan: rows ``0..S-1`` are the
        decode rows (slot s at row s, masked where inactive or still
        prefilling, or all masked without ``decode_rows``), rows
        ``S..`` pack prefill chunks oldest admission first until
        ``prefill_token_budget`` tokens are scheduled. Returns None
        when no row is valid."""
        S = self.max_slots
        tokens = np.zeros((self._mixed_rows,), np.int32)
        row_slots = np.zeros((self._mixed_rows,), np.int32)
        positions = np.zeros((self._mixed_rows,), np.int32)
        valid = np.zeros((self._mixed_rows,), bool)
        n_dec = 0
        for s in range(S if decode_rows else 0):
            if self._active[s] and not self._prefill_target[s]:
                tokens[s] = self._tokens[s]
                row_slots[s] = s
                positions[s] = self._seq_lens[s]
                valid[s] = True
                n_dec += 1
        budget = self.prefill_budget
        takes = []        # (slot, take, finishes, last_row)
        row = S
        order = sorted(
            (s for s in range(S)
             if self._active[s] and self._prefill_target[s]),
            key=lambda s: self._slots[s].admit_seq)
        for s in order:
            if budget <= 0:
                break
            start = int(self._seq_lens[s])
            target = int(self._prefill_target[s])
            take = min(self.chunk_size, target - start, budget)
            if take <= 0:
                continue
            prompt = self._slots[s].prompt
            tokens[row:row + take] = prompt[start:start + take]
            row_slots[row:row + take] = s
            positions[row:row + take] = np.arange(
                start, start + take, dtype=np.int32)
            valid[row:row + take] = True
            takes.append((s, take, start + take == target,
                          row + take - 1))
            row += take
            budget -= take
        n_pre = row - S
        if n_dec == 0 and n_pre == 0:
            return None
        return tokens, row_slots, positions, valid, takes, n_dec, n_pre

    def _dispatch_mixed_step(self, plan, t_it0: float):
        """Dispatch one mixed step and advance host state: prefill
        slots move their write frontier ``take`` tokens (emitting the
        first generated token and publishing deferred prefix hashes
        when the prompt completes); decode rows advance by one. The
        fenced step is split between ``chunked_prefill`` and
        ``decode_compute`` by prefill-row share; the turn's host work
        since ``t_it0`` outside the dispatch is ``host_batching``."""
        tokens, row_slots, positions, valid, takes, n_dec, n_pre = plan
        occ = int(np.sum(self._active))
        ledger = self._ledger_on
        t0 = time.perf_counter()
        toks = self._dispatch_mixed_rows(
            tokens, row_slots, positions, valid, self._tables)
        step_ms = (time.perf_counter() - t0) * 1e3
        self._step_ms.observe(step_ms)
        self._steps_total.inc()
        self._step_seq += 1
        self._occ_steps += occ
        self._tot_steps += self.max_slots
        total = max(n_dec + n_pre, 1)
        fill = n_pre / total
        self._fill_frac_g.set(round(fill, 4))
        pre_ms = step_ms * fill
        self._comp_ms["chunked_prefill"] += pre_ms
        self._comp_ms["decode_compute"] += step_ms - pre_ms
        self._cum_prefill_ms += pre_ms
        now = time.perf_counter()
        for s, take, finishes, last_row in takes:
            r = self._slots[s]
            self._seq_lens[s] += take
            self._chunk_tokens_h.observe(float(take))
            share = step_ms * (take / total)
            if ledger:
                r.own_prefill_ms += share
                if len(r.events) < _MAX_LEDGER_EVENTS:
                    r.events.append(
                        ("chunk", round((t0 - r.t_submit) * 1e3, 3),
                         take, round(share, 3)))
            if not finishes:
                continue
            # last prompt token written: its row's argmax IS the first
            # generated token
            tok = int(toks[last_row])
            self._prefill_target[s] = 0
            self._tokens[s] = tok
            r.t_first = now
            r.generated.append(tok)
            self._tokens_total.inc()
            ttft_ms = (r.t_first - r.t_submit) * 1e3
            self._ttft_ms.observe(ttft_ms)
            # publish full-block hashes only now — a half-written
            # block must never have been acquirable mid-prefill
            for i, h in enumerate(self._slot_hashes[s]):
                self.pool.register(int(self._tables[s, i]), h)
            self._slot_hashes[s] = []
            if ledger and len(r.events) < _MAX_LEDGER_EVENTS:
                r.events.append(("first_token", round(ttft_ms, 3)))
            if self.telemetry is not None:
                dur_ns = max(int(r.own_prefill_ms * 1e6), 1)
                self.telemetry.tracer.emit_spans([(
                    "decode_prefill", time.monotonic_ns() - dur_ns,
                    dur_ns, r.span_sid,
                    {"request_id": r.request_id, "chunked": True,
                     "prompt_tokens": int(r.prompt.size)})])
            if (tok == self.eos_id or len(r.generated) >= r.max_new
                    or int(self._seq_lens[s]) + 1 >= self.max_context):
                self._retire(s)
        if n_dec:
            for s in range(self.max_slots):
                if self._slots[s] is not None and valid[s]:
                    tok = int(toks[s])
                    self._advance(s, tok, tok == self.eos_id, t0, occ)
        self._update_gauges()
        self._comp_ms["host_batching"] += max(
            (time.perf_counter() - t_it0) * 1e3 - step_ms, 0.0)

    def _iterate_spec(self):
        """One speculative round: the draft scan, one verify chunk, then
        greedy accept on the host. Verify row i holds the target's
        greedy token after ``[pending, draft_1..i]``, valid while every
        earlier proposal matched it, so the emitted tokens are plain
        greedy's. Emission is capped at γ tokens a round, so the draft
        pool's written horizon (positions ``n..n+γ-1``) equals
        ``seq_lens`` afterwards; target writes past the new length are
        dead (the next round overwrites them) and trailing blocks
        allocated for the horizon are released."""
        gamma = self.speculate_k
        t_it0 = time.perf_counter()
        self._ensure_blocks(horizon=gamma)
        # chunked mode: a mid-prefill slot is not in the round
        dec = self._active & (self._prefill_target == 0)
        if not np.any(dec):
            return
        occ = int(np.sum(dec))
        t0 = time.perf_counter()
        props, verify = self._dispatch_spec(dec)
        round_ms = (time.perf_counter() - t0) * 1e3
        self._step_ms.observe(round_ms)
        self._steps_total.inc()
        self._verify_steps += 1
        self._step_seq += 1
        self._occ_steps += occ
        self._tot_steps += self.max_slots
        emitted = 0
        for s in range(self.max_slots):
            r = self._slots[s]
            if r is None or self._prefill_target[s]:
                continue
            k = 0
            while k < gamma and int(props[s, k]) == int(verify[s, k]):
                k += 1
            self._accept_len.observe(float(k))
            self._spec_rounds += 1
            self._spec_accepted += k
            m = min(k + 1, gamma)
            emitted += m
            if self._ledger_on and len(r.events) < _MAX_LEDGER_EVENTS:
                rel = round((t0 - r.t_submit) * 1e3, 3)
                r.events.append(("step", rel, self._step_seq, occ))
                r.events.append(("spec", rel, gamma, k))
            retired = False
            for i in range(m):
                tok = int(verify[s, i])
                r.generated.append(tok)
                self._tokens_total.inc()
                self._seq_lens[s] += 1
                if (tok == self.eos_id or len(r.generated) >= r.max_new
                        or int(self._seq_lens[s]) + 1
                        >= self.max_context):
                    self._retire(s)
                    retired = True
                    break
            if not retired:
                self._tokens[s] = tok
                keep = int(self._seq_lens[s]) // self.kv.block_size + 1
                self.pool.release_tail(r.request_id, keep)
        # split the fenced round between productive decode and
        # speculation overhead by the emitted-token yield: a round that
        # lands its full γ-token cap is all decode compute, everything
        # short of that is draft+verify time beyond the tokens it won
        yield_frac = emitted / max(1, occ * gamma)
        self._comp_ms["decode_compute"] += round_ms * yield_frac
        self._comp_ms["spec_overhead"] += round_ms * (1.0 - yield_frac)
        self._update_gauges()
        self._comp_ms["host_batching"] += max(
            (time.perf_counter() - t_it0) * 1e3 - round_ms, 0.0)

    def _retire(self, slot: int):
        r = self._slots[slot]
        self.pool.free(r.request_id)
        self._slots[slot] = None
        self._active[slot] = False
        self._seq_lens[slot] = 0
        self._tokens[slot] = 0
        self._tables[slot] = 0
        self._prefill_target[slot] = 0
        self._slot_hashes[slot] = []
        now = time.perf_counter()
        n = len(r.generated)
        tpot = ((now - r.t_first) * 1e3 / (n - 1)) if n > 1 else None
        if tpot is not None:
            self._tpot_ms.observe(tpot)
        ttft_ms = (r.t_first - r.t_submit) * 1e3
        if self._ledger_on:
            self._ledger_retire(r, now, n, ttft_ms, tpot)
        if self.telemetry is not None:
            self.telemetry.tracer.end_span(
                r.span_sid, tokens=n, ttft_ms=round(ttft_ms, 3),
                tpot_ms=(round(tpot, 3) if tpot is not None else None),
                preempts=r.preempts)
        if not r.future.done():
            r.future.set_result(DecodeResult(
                tokens=np.asarray(r.generated, np.int32),
                ttft_ms=ttft_ms, tpot_ms=tpot,
                preempts=r.preempts, request_id=r.request_id))

    def _update_gauges(self):
        n_active = int(np.sum(self._active))
        self._occupancy.set(round(n_active / self.max_slots, 4))
        self._kv_in_use.set(self.pool.blocks_in_use)
        self._kv_util.set(round(self.pool.utilization, 4))
        self._kv_shared.set(self.pool.shared_blocks)
        self._kv_refs.set(self.pool.total_refs)
        self._queue_depth.set(self.queue_depth)
        if self._tot_steps:
            self._occ_frac.set(
                round(self._occ_steps / self._tot_steps, 4))
        wall = self._loop_wall_ms
        if wall > 0.0:
            busy = max(wall - self._comp_ms["idle"], 1e-9)
            self._goodput_g.set(round(
                min(self._comp_ms["decode_compute"] / busy, 1.0), 4))
            for k, v in self._comp_ms.items():
                self._comp_g.set(round(v, 3), component=k)

    # ------------------------------------------------ lifecycle ledger
    def _ledger_retire(self, r: DecodeRequest, now: float, n: int,
                       ttft_ms: float, tpot):
        """Finalize one request's ledger: decompose its TTFT, push the
        retired dict onto the bounded ring, observe the preemption-redo
        histogram, and export the timeline as child spans for sampled
        / slow / preempted requests (every request pays only the host
        tuples; spans are the exception, not the rule)."""
        total_ms = (now - r.t_submit) * 1e3
        if len(r.events) < _MAX_LEDGER_EVENTS:
            r.events.append(("finish", round(total_ms, 3)))
        # exact-sum TTFT decomposition: own prefill and preemption redo
        # are measured stints, the queue remainder is exact by
        # construction, and the stall-behind share of it is the
        # cumulative-prefill delta integrated over the queue stints
        own = r.own_prefill_ms
        redo = r.redo_ms
        queue_total = max(ttft_ms - own - redo, 0.0)
        stall_behind = min(r.stall_behind_ms, queue_total)
        led = {
            "request_id": r.request_id,
            "prompt_tokens": int(r.prompt.size),
            "tokens": n,
            "preempts": r.preempts,
            "ttft_ms": round(ttft_ms, 4),
            "tpot_ms": (round(tpot, 4) if tpot is not None else None),
            "total_ms": round(total_ms, 4),
            "ttft_parts": {
                "queue": round(queue_total - stall_behind, 4),
                "prefill_stall_behind": round(stall_behind, 4),
                "own_prefill": round(own, 4),
                "preempt_redo": round(redo, 4),
            },
            "events": list(r.events),
        }
        if r.preempts:
            self._redo_ms_h.observe(redo)
        self._retired.append(led)
        self._retire_seq += 1
        if self.telemetry is not None and (
                r.preempts > 0 or ttft_ms >= _SLOW_TTFT_MS
                or self._retire_seq % _LEDGER_SAMPLE_EVERY == 0):
            self._export_ledger_spans(r, led)

    def _export_ledger_spans(self, r: DecodeRequest, led: dict):
        """Child spans of the request's ``serving_request`` root, laid
        out as consecutive TTFT-attribution intervals plus the decode
        stream — the trace-view rendering of the ledger, emitted in one
        tracer round-trip and only for sampled/slow/preempted
        requests."""
        spans = []
        off = 0.0
        for k in ("queue", "prefill_stall_behind", "preempt_redo",
                  "own_prefill"):
            d = led["ttft_parts"][k]
            if d <= 0.0:
                continue
            spans.append((f"ttft_{k}", r.t_ns + int(off * 1e6),
                          int(d * 1e6), r.span_sid,
                          {"request_id": r.request_id}))
            off += d
        stream_ms = led["total_ms"] - led["ttft_ms"]
        if stream_ms > 0.0:
            spans.append(("decode_stream",
                          r.t_ns + int(led["ttft_ms"] * 1e6),
                          int(stream_ms * 1e6), r.span_sid,
                          {"request_id": r.request_id,
                           "tokens": led["tokens"],
                           "preempts": led["preempts"]}))
        if spans:
            try:   # span export is host-side; it must not stop a retire
                self.telemetry.tracer.emit_spans(spans)
            except Exception:
                pass

    def goodput_snapshot(self) -> dict:
        """Raw observatory accumulators (obs/servegoodput.py's input):
        the measured loop wall, turn/step counts, per-component ms and
        the slot-step occupancy integrals. ``cow_copy`` accrues in the
        synchronous beam lane OUTSIDE the decode loop's wall clock, so
        with beam traffic the component sum can exceed the loop wall —
        the decode closed loop reconciles within tolerance."""
        return {
            "loop_wall_ms": self._loop_wall_ms,
            "turns": self._loop_turns,
            "steps": self._step_seq,
            "components": dict(self._comp_ms),
            "occ_steps": self._occ_steps,
            "tot_steps": self._tot_steps,
        }

    def retired_ledgers(self, n: Optional[int] = None) -> List[dict]:
        """The last-N retired request ledgers (oldest first)."""
        leds = list(self._retired)
        return leds if n is None else leds[-int(n):]

    def requestz(self, n: int = 20, order: str = "slowest",
                 preempts: bool = False) -> dict:
        """The ``/requestz`` payload: retired-request ledgers with
        rendered timelines. ``order`` is ``slowest`` (by TTFT; beam
        mini-ledgers fall back to total wall) or ``recent``;
        ``preempts=True`` keeps only requests that were preempted at
        least once (the redo-cost lens)."""
        leds = list(self._retired)
        if preempts:
            leds = [led for led in leds if led.get("preempts")]
        if order == "slowest":
            leds.sort(key=lambda led: (led.get("ttft_ms")
                                       or led.get("total_ms") or 0.0),
                      reverse=True)
        else:
            leds = leds[::-1]
        leds = leds[:max(0, int(n))]
        return {
            "retired_total": self._retire_seq,
            "ring": len(self._retired),
            "ring_capacity": self._retired.maxlen,
            "order": order,
            "preempts_only": bool(preempts),
            "requests": [dict(led, timeline=render_timeline(led))
                         for led in leds],
        }

    # ------------------------------------------------- offline beam lane
    def generate_beam(self, prompt: Sequence[int], beam_size: int = 4,
                      max_new_tokens: Optional[int] = None,
                      length_penalty: float = 0.0,
                      impl: str = "paged") -> BeamResult:
        """Offline beam search riding the same paged pool as greedy
        serving: the prompt's prefix is prefilled once (or reacquired
        from the prefix cache) and all K beams share it by refcount;
        when a beam writes into a block another owner still references,
        the block is copied first (copy-on-write). Host scoring is
        ``decode.beam_search``'s, operation for operation (the same
        two-stage top-k and tie-breaking, finished beams frozen,
        backtrack, GNMT length penalty), so the result matches the
        dense-cache lane, kept as the oracle (``impl="dense"``). The
        prompt's last token is the BOS the search scores.

        Runs synchronously, serialised against the decode loop (both
        write the pools and the block refcounts). Returns a
        ``BeamResult`` of numpy arrays shaped ``[1, K, ...]``."""
        if impl == "dense":
            return self._generate_beam_dense(
                prompt, beam_size, max_new_tokens, length_penalty)
        if impl != "paged":
            raise ValueError(f"impl must be paged|dense, got {impl!r}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        K = int(beam_size)
        if K > self.cfg.vocab_size:
            raise ValueError(
                f"beam_size ({K}) > vocab_size ({self.cfg.vocab_size})")
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.default_max_new)
        prefix = prompt[:-1]
        if int(prefix.size) + max_new > self.max_context:
            raise ValueError(
                f"prefix {prefix.size} + max_new {max_new} exceeds "
                f"max_context {self.max_context}")
        with self._device_lock:
            return self._beam_paged(prefix, int(prompt[-1]), K, max_new,
                                    float(length_penalty))

    def _dispatch_beam_step(self, tokens, tables, lens):
        """One ``decode_step`` over K beam rows (all active); returns the
        fenced log-softmax scores [K, vocab] as float32 numpy."""
        K = tokens.shape[0]
        buf = self._upload(tokens, lens, tables)
        logits, _, _ = dm.decode_step(
            self.cfg, self.params, self._k_pool, self._v_pool, buf[:K],
            buf[2 * K:].view(K, self.max_pages), buf[K:2 * K],
            torch.ones((K,), dtype=torch.bool, device=self.device))
        return torch.log_softmax(logits, dim=-1).cpu().numpy()

    def _cow_copy(self, src, dst):
        """Copy pool block ``src[i]`` into ``dst[i]`` in both pools, in
        place (plain indexing: no kernel). A quantized block carries its
        stored per-block scale row along, so the copy dequantizes to
        the original's values; 1-byte payloads move as uint8."""
        src = torch.from_numpy(np.asarray(src, np.int64)).to(self.device)
        dst = torch.from_numpy(np.asarray(dst, np.int64)).to(self.device)
        for pool in (self._k_pool, self._v_pool):
            if isinstance(pool, tuple):
                payload, scales, _cal = pool
                pl = payload.view(torch.uint8)
                pl[:, dst] = pl[:, src]
                scales[:, dst] = scales[:, src]
            else:
                pool[:, dst] = pool[:, src]

    def _beam_paged(self, prefix, bos: int, K: int, max_new: int,
                    length_penalty: float) -> BeamResult:
        bs = self.kv.block_size
        prefix_len = int(prefix.size)
        V = self.cfg.vocab_size
        bid = next(_request_ids)
        owners = [("beam", bid, 0, i) for i in range(K)]
        tables = np.zeros((K, self.max_pages), np.int32)
        all_gens = list(owners)           # every owner ever created
        t_beam0 = time.perf_counter()
        beam_events: List[tuple] = [("submit", 0.0)] \
            if self._ledger_on else []
        try:
            # ---- admit the shared prefix once; all K beams refcount it
            if prefix_len:
                hashes: List[str] = []
                hits: List[int] = []
                if self.prefix_cache:
                    hashes = chain_block_hashes(prefix, bs)
                    for i in range((prefix_len - 1) // bs):
                        blk = self.pool.acquire_cached(hashes[i],
                                                       owners[0])
                        if blk is None:
                            break
                        hits.append(blk)
                hit_len = len(hits) * bs
                fresh = self.pool.alloc(
                    self.kv.blocks_for(prefix_len) - len(hits), owners[0])
                prefix_blocks = hits + fresh
                row = np.zeros((self.max_pages,), np.int32)
                row[:len(prefix_blocks)] = prefix_blocks
                tail = prefix[hit_len:]
                if self.prefill_mode == "chunked":
                    self._mixed_prefill_tail(tail, hit_len, row)
                else:
                    padded = np.zeros((self._rung_for(int(tail.size)),),
                                      np.int32)
                    padded[:tail.size] = tail
                    self._dispatch_prefill(padded, int(tail.size),
                                           hit_len, row)
                self._prefix_hit_tokens.inc(hit_len)
                self._prefix_miss_tokens.inc(int(tail.size))
                for i, h in enumerate(hashes):
                    self.pool.register(int(row[i]), h)
                for i in range(1, K):
                    self.pool.share(prefix_blocks, owners[i])
                tables[:, :len(prefix_blocks)] = prefix_blocks
            # ---- host beam state, exactly decode.beam_search's
            scores = np.array([0.0] + [NEG] * (K - 1), np.float32)
            tokens = np.full((K,), bos, np.int32)
            finished = np.zeros((K,), bool)
            fin_row = np.full((V,), NEG, np.float32)
            fin_row[self.eos_id] = 0.0
            frames: List[tuple] = []
            for t in range(max_new):
                pos = prefix_len + t
                page = pos // bs
                src = np.zeros((K,), np.int32)
                dst = np.zeros((K,), np.int32)
                for i in range(K):
                    if pos % bs == 0:       # a fresh page for every beam
                        blk = self.pool.alloc(1, owners[i])[0]
                        tables[i, page] = blk
                        src[i] = dst[i] = blk
                    else:
                        blk = int(tables[i, page])
                        if self.pool.refcount(blk) > 1:   # CoW
                            new = self.pool.alloc(1, owners[i])[0]
                            self.pool.release_blocks(owners[i], [blk])
                            tables[i, page] = new
                            src[i], dst[i] = blk, new
                        else:
                            src[i] = dst[i] = blk
                if np.any(src != dst):
                    t_cow = time.perf_counter()
                    self._cow_copy(src, dst)
                    # fence so the cow component is the copy's real
                    # cost, not its enqueue; the beam lane is offline,
                    # so the sync is off the serving hot path
                    if self.device.type == "cuda":
                        torch.cuda.current_stream(self.device).synchronize()
                    self._comp_ms["cow_copy"] += \
                        (time.perf_counter() - t_cow) * 1e3
                    n_copy = int(np.sum(src != dst))
                    self.cow_copies += n_copy
                    if (self._ledger_on
                            and len(beam_events) < _MAX_LEDGER_EVENTS):
                        beam_events.append(
                            ("cow", round((t_cow - t_beam0) * 1e3, 3),
                             n_copy))
                lp = self._dispatch_beam_step(
                    tokens, tables, np.full((K,), pos, np.int32))
                lp = np.where(finished[:, None], fin_row[None], lp)
                cand = scores[:, None] + lp              # [K, V]
                # two-stage top-k; a stable descending argsort breaks
                # ties at the lowest index, like lax.top_k
                i1 = np.argsort(-cand, axis=1, kind="stable")[:, :K]
                s1f = np.take_along_axis(cand, i1, axis=1).reshape(-1)
                i1f = i1.reshape(-1)
                idx2 = np.argsort(-s1f, kind="stable")[:K]
                new_scores = s1f[idx2].astype(np.float32)
                parent = (idx2 // K).astype(np.int32)
                token = i1f[idx2].astype(np.int32)
                new_finished = finished[parent] | (token == self.eos_id)
                frames.append((token, parent))
                # fork: each surviving beam refcounts its parent's table
                # (this step's write included); the old generation goes
                new_owners = [("beam", bid, t + 1, i) for i in range(K)]
                all_gens.extend(new_owners)
                for i in range(K):
                    self.pool.share(
                        list(self.pool.owner_blocks(owners[parent[i]])),
                        new_owners[i])
                for o in owners:
                    self.pool.free(o)
                owners = new_owners
                tables = tables[parent].copy()
                tokens, scores, finished = token, new_scores, \
                    new_finished
            # ---- backtrack (decode.beam_search's reverse walk)
            beam = np.arange(K, dtype=np.int32)
            rev: List[np.ndarray] = []
            for tok_t, par_t in reversed(frames):
                rev.append(tok_t[beam])
                beam = par_t[beam]
            sequences = np.stack(rev[::-1], axis=-1)       # [K, T]
            eq = sequences == self.eos_id
            lengths = np.where(np.any(eq, axis=-1),
                               np.argmax(eq, axis=-1) + 1,
                               max_new).astype(np.int32)
            if length_penalty > 0.0:
                norm = ((5.0 + lengths.astype(np.float32)) / 6.0) \
                    ** length_penalty
                scores = (scores / norm).astype(np.float32)
                order = np.argsort(-scores, kind="stable")
                sequences, lengths, scores = (sequences[order],
                                              lengths[order],
                                              scores[order])
            t_idx = np.arange(max_new)
            sequences = np.where(t_idx[None, :] < lengths[:, None],
                                 sequences, self.eos_id).astype(np.int32)
            if self._ledger_on:
                total_ms = (time.perf_counter() - t_beam0) * 1e3
                beam_events.append(("finish", round(total_ms, 3)))
                # beam mini-ledger: no TTFT decomposition (ttft_parts
                # absent keeps it out of the tail attribution), but its
                # CoW copies are on the requestz record
                self._retired.append({
                    "request_id": bid, "kind": "beam",
                    "prompt_tokens": prefix_len + 1,
                    "tokens": int(max_new), "preempts": 0,
                    "ttft_ms": None, "tpot_ms": None,
                    "total_ms": round(total_ms, 4),
                    "events": beam_events,
                })
                self._retire_seq += 1
            return BeamResult(sequences=sequences[None],
                              lengths=lengths[None], scores=scores[None])
        finally:
            for o in all_gens:
                self.pool.free(o)
            self._update_gauges()

    def _generate_beam_dense(self, prompt: Sequence[int],
                             beam_size: int = 4,
                             max_new_tokens: Optional[int] = None,
                             length_penalty: float = 0.0) -> BeamResult:
        """The dense-cache beam lane, the paged lane's oracle:
        ``decode.beam_search`` over ``decode_model.
        make_dense_beam_step_fn``, whose per-beam caches are regathered
        by value, so it shares nothing with the pool. The prompt minus
        its last token is prefilled densely (padded to its rung)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        padded = np.zeros((self._rung_for(int(prompt.size)),), np.int32)
        padded[:prompt.size - 1] = prompt[:-1]
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.default_max_new)
        K = int(beam_size)
        with self._device_lock:
            kc, vc = dm.dense_prefill(self.cfg, self.params, padded,
                                      int(prompt.size) - 1)
            state = (kc[None].repeat(K, 1, 1, 1, 1),
                     vc[None].repeat(K, 1, 1, 1, 1),
                     torch.full((K,), int(prompt.size) - 1,
                                dtype=torch.int32, device=self.device))
            res = beam_search(
                dm.make_dense_beam_step_fn(self.cfg, self.params), state,
                batch_size=1, beam_size=K, max_len=max_new,
                bos_id=int(prompt[-1]), eos_id=self.eos_id,
                vocab_size=self.cfg.vocab_size,
                length_penalty=length_penalty)
        return BeamResult(*[x.cpu().numpy() for x in res])

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Point-in-time decode summary, with the JAX engine's keys for
        the parts ported (all but the compile cache's), the serving
        goodput decomposition and the ledger ring's state."""
        by_rung: Dict[str, int] = {}
        with self._lock:
            for r in self._pending:
                by_rung[str(r.rung)] = by_rung.get(str(r.rung), 0) + 1
        return {
            "requests_total": self._requests.value,
            "rejected_total": self._rejected.value,
            "tokens_total": self._tokens_total.value,
            "steps_total": self._steps_total.value,
            "prefills_total": self._prefills.value,
            "preempted_total": self._preempted.value,
            "ttft_ms_p50": self._ttft_ms.percentile(50),
            "ttft_ms_p99": self._ttft_ms.percentile(99),
            "tpot_ms_p50": self._tpot_ms.percentile(50),
            "step_ms_p50": self._step_ms.percentile(50),
            "queue_depth": self.queue_depth,
            "queue_depth_by_rung": by_rung,
            "slot_occupancy": float(np.sum(self._active))
            / self.max_slots,
            "slot_occupancy_frac": (
                round(self._occ_steps / self._tot_steps, 4)
                if self._tot_steps else 0.0),
            "active_slots": int(np.sum(self._active)),
            "max_slots": self.max_slots,
            "goodput": decompose_serving(
                self.goodput_snapshot(), ledgers=list(self._retired)),
            "ledger": {
                "enabled": self._ledger_on,
                "retired_total": self._retire_seq,
                "ring": len(self._retired),
                "ring_capacity": self._retired.maxlen,
            },
            "kv": self.pool.stats(),
            "kv_config": self.kv.describe(),
            "quant": {
                "kv_dtype": self.kv.dtype,
                "kv_quantized": self.kv.quantized,
                "weights_quantized": self.quant_plan is not None,
            },
            "prefix": {
                "enabled": self.prefix_cache,
                "hit_tokens": self._prefix_hit_tokens.value,
                "miss_tokens": self._prefix_miss_tokens.value,
                "hit_rate": round(
                    self._prefix_hit_tokens.value
                    / max(1, self._prefix_hit_tokens.value
                          + self._prefix_miss_tokens.value), 4),
            },
            "speculation": {
                "gamma": self.speculate_k,
                "rounds": self._spec_rounds,
                "mean_accept_len": round(
                    self._spec_accepted / max(1, self._spec_rounds), 4),
                "verify_steps": self._verify_steps,
            },
            "prompt_rungs": list(self.prompt_rungs),
            "prefill_mode": self.prefill_mode,
            "chunked_prefill": {
                "chunk_size": self.chunk_size,
                "token_budget": self.prefill_budget,
                "mixed_rows": self._mixed_rows,
                "fill_frac": self._fill_frac_g.value,
                "chunk_tokens_p50":
                    self._chunk_tokens_h.percentile(50),
            },
            "admission": self.admission,
            "attn_impl": self.attn_impl,
            "device": str(self.device),
            "warmed": self._warmed,
        }

    # ------------------------------------------------------------- close
    def close(self, timeout: float = 30.0):
        """Drain pending and in-flight generations, stop the loop.
        Idempotent."""
        if self._closed:
            return
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
