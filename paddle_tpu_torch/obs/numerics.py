"""Numerics observatory: sampled in-graph tensor statistics, a
persistent calibration store, and NaN-origin bisection.

The port of the JAX package's ``obs/numerics.py``; a calibration entry
is keyed by ``Program.fingerprint()``, which the port's programs share
with the JAX package's, so a store written by either package loads in
the other.

Three cooperating pieces over the ``tensor_stats`` op (ops/math.py) and
the instrumentation pass (analysis/instrument.py):

``NumericsMonitor``
    Owns the instrumented ``[n_tensors, N_STATS]`` fetch riding the
    train step's dispatch group (the health monitor's trick, scaled to
    per-tensor lanes). Applies every-Nth-step sampling — the executor's
    liveness prune keys on the fetch set, so a plain step runs none of
    the stat ops (the JAX Executor's two compiled entries, the stat ops
    dead-code-eliminated from the plain one) — then fans the host-side
    results out to gauges (``tensor_absmax{var}`` ...), Perfetto counter
    tracks, the ``/numericsz`` endpoint, and the EMA calibration state.

``CalibrationStore``
    Content-addressed persistence of the EMA ranges, keyed by program
    fingerprint exactly like the AOT compile cache
    (framework/compile_cache.py): atomic JSON writes, fail-open reads.
    This is the measured-range input a post-training int8/fp8 path
    needs (EQuARX, arXiv:2506.17615) — quantization is only safe
    against calibrated absmax/occupancy, never against dtype limits.

``bisect_nan_origin``
    When a health trip fires, replay the captured failing batch through
    ``Executor.scan_ops`` — the op-by-op replay of the step's forward
    with an observer after each op — and name the FIRST op whose output
    goes nonfinite. The step's fetch can only say "the gradients blew
    up"; the bisector says
    "``exp`` op #12 writing ``softmax_3.tmp`` overflowed first".

The surface follows TensorFlow's production debugging story of
first-class in-graph numeric summaries (Abadi et al., 2016,
arXiv:1605.08695); the reference framework printed host-side parameter
stats with a device sync per read.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch.ops.math import N_STATS, STAT_NAMES

__all__ = ["NumericsSpec", "NumericsMonitor", "CalibrationStore",
           "bisect_nan_origin"]

_DEFAULT_DIR = os.path.join("~", ".cache", "paddle_tpu", "calibration")

# the EMA lanes the calibration store persists (count stays in-memory)
_CAL_LANES = ("absmax", "rms", "mean", "zero_frac", "exp_hi_frac",
              "exp_lo_frac")


@dataclass
class NumericsSpec:
    """Selection + sampling policy for one instrumented program.

    ``op_types`` / ``name_regex``: which op outputs to watch (either
    matches; both unset = every float op output up to ``max_tensors`` —
    see analysis/instrument.py). ``sample_every``: fetch the stats
    every Nth step (1 = always); non-sampled steps run none of the stat
    ops. ``calibration``: CalibrationStore
    spec (None = flag plane / off, True = default dir, path, or an
    instance); ``decay``: EMA decay per sample. ``bisect``: replay +
    forward-scan on a nonfinite health trip."""
    op_types: Optional[Sequence[str]] = None
    name_regex: Optional[str] = None
    sample_every: int = 8
    max_tensors: int = 32
    headroom_bits: float = 8.0
    calibration: Any = None
    decay: float = 0.99
    bisect: bool = True


class CalibrationStore:
    """Content-addressed on-disk store of per-tensor EMA ranges."""

    SCHEMA = 1

    def __init__(self, root: str):
        self.root = os.path.abspath(os.path.expanduser(root))
        os.makedirs(self.root, exist_ok=True)

    # ------------------------------------------------------------ factory
    @staticmethod
    def resolve(spec) -> Optional["CalibrationStore"]:
        """Normalise a user-facing ``calibration=`` argument — the
        CompileCache.resolve contract: None → flag plane
        (``calibration_dir`` / env PADDLE_TPU_CALIBRATION_DIR) or off,
        False → off, True → flag dir or the per-user default, a path →
        that dir, an instance passes through."""
        if spec is False:
            return None
        if isinstance(spec, CalibrationStore):
            return spec
        if isinstance(spec, (str, os.PathLike)):
            return CalibrationStore(os.fspath(spec))
        from paddle_tpu_torch.flags import FLAGS
        flag_dir = str(FLAGS.calibration_dir or "").strip()
        if spec is True:
            return CalibrationStore(flag_dir or _DEFAULT_DIR)
        if spec is None:
            return CalibrationStore(flag_dir) if flag_dir else None
        raise TypeError(
            "calibration= expects None/bool/path/CalibrationStore, got "
            f"{type(spec)!r}")

    # --------------------------------------------------------------- keys
    @staticmethod
    def entry_key(*, fingerprint: str, headroom_bits: float) -> str:
        """One calibration entry per (program structure, bucket edges);
        no object ids, so another process reloads the same entry —
        CompileCache.entry_key's contract."""
        payload = repr((
            ("schema", CalibrationStore.SCHEMA),
            ("fingerprint", str(fingerprint)),
            ("headroom_bits", float(headroom_bits)),
        ))
        return hashlib.sha256(payload.encode()).hexdigest()[:32]

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".json")

    # ------------------------------------------------------------ get/put
    def put(self, key: str, ranges: Dict[str, Dict[str, float]],
            meta: Optional[Dict[str, Any]] = None) -> None:
        """Atomically persist one entry (tmp + os.replace; last writer
        wins — both writers held valid ranges)."""
        doc = {"schema": self.SCHEMA, "created": time.time(),
               "ranges": ranges}
        doc.update(meta or {})
        path = self._path(key)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)

    def load(self, key: str) -> Optional[Dict[str, Any]]:
        """The stored doc for ``key``, or None. Fail-open: a corrupt or
        schema-mismatched entry is evicted and reads as a miss."""
        path = self._path(key)
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            if doc.get("schema") != self.SCHEMA:
                raise ValueError("schema mismatch")
            return doc
        except FileNotFoundError:
            return None
        except Exception:
            try:
                os.remove(path)
            except OSError:
                pass
            return None

    def entries(self) -> List[str]:
        try:
            return sorted(k[:-5] for k in os.listdir(self.root)
                          if k.endswith(".json") and ".tmp" not in k)
        except OSError:
            return []


class NumericsMonitor:
    """Policy + host-side plane for the instrumented stats fetch.

    Lifecycle: ``install(program)`` once (after optimizer + health
    installation — appending ops bumps the program version), then per
    sampled step hand the fetched ``[n, N_STATS]`` (or megastep
    ``[K, n, N_STATS]``) array to ``update``."""

    def __init__(self, spec: Optional[NumericsSpec] = None, **kw):
        self.spec = spec or NumericsSpec(**kw)
        if spec is not None and kw:
            raise ValueError("pass a NumericsSpec or kwargs, not both")
        self.var = None                 # the fused [n, N_STATS] variable
        self.targets = []               # List[SelectedTensor]
        self.fingerprint = None         # instrumented program identity
        self.store = CalibrationStore.resolve(self.spec.calibration)
        self.store_key = None
        self.ema: Dict[str, Dict[str, float]] = {}
        self.last: Dict[str, Dict[str, float]] = {}
        self.samples = 0
        self.last_step = None
        self.origin = None              # last bisection verdict
        self._gauges = None

    # ----------------------------------------------------- graph build
    def install(self, program, log=None):
        """Select targets and append the fused stats ops to the
        program's global block; returns the ``[n, N_STATS]`` variable
        (None when nothing matched). Loads prior EMA state from the
        calibration store so ranges accumulate across runs."""
        from paddle_tpu_torch.analysis.instrument import (install_numerics,
                                                          select_tensors)
        s = self.spec
        self.targets = select_tensors(
            program, op_types=s.op_types, name_regex=s.name_regex,
            max_tensors=s.max_tensors, log=log)
        if not self.targets:
            return None
        self.var = install_numerics(
            program.global_block(), [t.var for t in self.targets],
            headroom_bits=s.headroom_bits)
        try:
            self.fingerprint = program.fingerprint()
        except Exception:
            self.fingerprint = None
        if self.store is not None and self.fingerprint is not None:
            self.store_key = CalibrationStore.entry_key(
                fingerprint=self.fingerprint,
                headroom_bits=s.headroom_bits)
            doc = self.store.load(self.store_key)
            if doc:
                for name, r in doc.get("ranges", {}).items():
                    self.ema[name] = {k: float(v) for k, v in r.items()}
        return self.var

    # --------------------------------------------------------- sampling
    def should_sample(self, step: int) -> bool:
        """True on the steps that fetch the instrumented entry. Step 1
        (the first real step) always samples, so a short run still
        produces calibration data."""
        n = max(1, int(self.spec.sample_every))
        return self.var is not None and (step % n == 1 or n == 1)

    def should_sample_group(self, step0: int, k: int) -> bool:
        """Megastep variant: one ``run_multi`` call of K steps has one
        fetch set, so the stat ops run on every step of the group or on
        none, and the whole group samples iff the cadence lands on any
        in-group step. (With ``sample_every <= K`` that is every group —
        the cadence can't be finer than the dispatch granularity.)"""
        if self.var is None:
            return False
        return any(self.should_sample(step0 + i) for i in range(k))

    # ------------------------------------------------------- host plane
    def _ensure_gauges(self, registry):
        if self._gauges is not None:
            return
        # literal metric names: the docs contract gate
        # (tools/check_metric_contract.py) reads first string args
        g = {
            "absmax": registry.gauge(
                "tensor_absmax", "numerics observatory: max |x| over "
                "finite elements, last sample", labelnames=("var",)),
            "rms": registry.gauge(
                "tensor_rms", "numerics observatory: rms over finite "
                "elements, last sample", labelnames=("var",)),
            "mean": registry.gauge(
                "tensor_mean", "numerics observatory: mean over finite "
                "elements, last sample", labelnames=("var",)),
            "nonfinite_count": registry.gauge(
                "tensor_nonfinite_count", "numerics observatory: "
                "NaN/Inf elements, last sample", labelnames=("var",)),
            "zero_frac": registry.gauge(
                "tensor_zero_frac", "numerics observatory: fraction of "
                "exact zeros, last sample", labelnames=("var",)),
            "exp_hi_frac": registry.gauge(
                "tensor_exp_hi_frac", "numerics observatory: finite "
                "fraction near dtype max (overflow headroom), last "
                "sample", labelnames=("var",)),
            "exp_lo_frac": registry.gauge(
                "tensor_exp_lo_frac", "numerics observatory: finite "
                "nonzero fraction near dtype tiny (underflow), last "
                "sample", labelnames=("var",)),
        }
        self._samples_ctr = registry.counter(
            "numerics_samples_total",
            "instrumented steps whose tensor stats were fetched")
        self._gauges = g

    def update(self, values, telemetry=None, step: Optional[int] = None):
        """Fold one sampled fetch into the observatory: EMA calibration
        state, per-var gauges + Perfetto counter tracks (last row of a
        megastep group), and the ``last`` report. ``values``:
        ``[n, N_STATS]`` or ``[K, n, N_STATS]``."""
        n = len(self.targets)
        arr = np.asarray(values, np.float64).reshape(-1, n, N_STATS)
        decay = float(self.spec.decay)
        for row in arr:
            self.samples += 1
            for t, lanes in zip(self.targets, row):
                stats = dict(zip(STAT_NAMES, (float(v) for v in lanes)))
                e = self.ema.get(t.var)
                if e is None:
                    e = self.ema[t.var] = {k: stats[k]
                                           for k in _CAL_LANES}
                    e["samples"] = 0.0
                else:
                    for k in _CAL_LANES:
                        e[k] = decay * e[k] + (1.0 - decay) * stats[k]
                e["samples"] = e.get("samples", 0.0) + 1.0
        last_row = arr[-1]
        self.last = {t.var: dict(zip(STAT_NAMES,
                                     (float(v) for v in row)))
                     for t, row in zip(self.targets, last_row)}
        self.last_step = step
        if telemetry is not None:
            self._ensure_gauges(telemetry.registry)
            for name, stats in self.last.items():
                for lane, gauge in self._gauges.items():
                    gauge.set(stats[lane], var=name)
                telemetry.tracer.counter(
                    f"numerics/{name}",
                    {k: stats[k] for k in ("absmax", "rms",
                                           "nonfinite_count")})
            self._samples_ctr.inc(arr.shape[0])
        return self.last

    # ---------------------------------------------------- persistence
    def save_calibration(self) -> Optional[str]:
        """Persist the EMA ranges; returns the entry key (None when the
        store is off or nothing was sampled)."""
        if self.store is None or self.store_key is None or not self.ema:
            return None
        self.store.put(self.store_key, self.ema,
                       meta={"fingerprint": self.fingerprint,
                             "headroom_bits": float(
                                 self.spec.headroom_bits),
                             "stat_names": list(STAT_NAMES)})
        return self.store_key

    # -------------------------------------------------------- reporting
    def report(self) -> dict:
        """The ``/numericsz`` document: targets, last sampled stats,
        EMA calibration state, and the last NaN-origin verdict."""
        return {
            "targets": [{"var": t.var, "op_index": t.op_index,
                         "op_type": t.op_type} for t in self.targets],
            "sample_every": int(self.spec.sample_every),
            "samples": self.samples,
            "last_step": self.last_step,
            "stat_names": list(STAT_NAMES),
            "last": self.last,
            "ema": {k: dict(v) for k, v in self.ema.items()},
            "nan_origin": self.origin,
            "calibration": {
                "dir": self.store.root if self.store else None,
                "key": self.store_key,
            },
        }

    def status(self) -> dict:
        """Compact ``/statusz`` row (the full document stays on
        ``/numericsz``)."""
        out = {"tensors": len(self.targets),
               "sample_every": int(self.spec.sample_every),
               "samples": self.samples}
        if self.origin is not None:
            out["nan_origin"] = self.origin
        return out

    # ---------------------------------------------------------- factory
    @staticmethod
    def ensure(value) -> Optional["NumericsMonitor"]:
        """Normalise a user-facing ``numerics=`` argument: None/False →
        off, True → defaults, a NumericsSpec → configured monitor, an
        instance passes through."""
        if value is None or value is False:
            return None
        if value is True:
            return NumericsMonitor()
        if isinstance(value, NumericsSpec):
            return NumericsMonitor(spec=value)
        if isinstance(value, NumericsMonitor):
            return value
        raise TypeError("numerics= expects None/bool/NumericsSpec/"
                        f"NumericsMonitor, got {type(value)!r}")


def bisect_nan_origin(executor, program, feed, scope=None,
                      max_report: int = 4) -> dict:
    """Replay ``feed`` through the program's forward ops eagerly
    (``Executor.scan_ops``) and name the first op whose output goes
    nonfinite.

    Returns ``{"found": True, "op_index", "op_type", "var",
    "nonfinite_count", "count", "ops_scanned", ...}`` for the first
    offender (plus up to ``max_report`` downstream casualties under
    ``"also"`` — useful when the first hit is an ``exp``/``log`` chain),
    or ``{"found": False, "ops_scanned": N}`` when the forward pass is
    clean — an honest verdict that the blowup originated in the
    backward pass (gradient overflow), which the eager scan cannot
    decompose op-by-op.

    The replay runs with ``sanitize_state`` (executor.scan_ops): by the
    time a health trip is handled the optimizer has already written the
    bad step's poisoned updates back to the scope, so parameters are
    repaired (NaN→0, Inf→finite max) before scanning; the repaired
    names land under ``"state_repaired"`` so a verdict over heavily
    poisoned state is legible as such."""
    import torch

    from paddle_tpu_torch.core.scope import global_scope
    scope = scope or global_scope()
    repaired: List[str] = []
    try:
        for name, v in sorted(
                executor._gather_state(program, scope).items()):
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                repaired.append(name)
    except Exception:
        pass

    hits: List[dict] = []

    def on_op(i, op, env):
        if len(hits) > max_report:
            return
        for name in op.output_names():
            v = env.get(name)
            if not torch.is_tensor(v) or not (v.is_floating_point()
                                              or v.is_complex()):
                continue
            bad = int((~torch.isfinite(v)).sum())
            if bad:
                hits.append({"op_index": i, "op_type": op.type,
                             "var": name, "nonfinite_count": bad,
                             "count": int(v.numel())})
                break   # one verdict per op; keep scanning downstream

    ops_scanned = 0

    def counting_on_op(i, op, env):
        nonlocal ops_scanned
        ops_scanned = max(ops_scanned, i + 1)
        on_op(i, op, env)

    try:
        executor.scan_ops(program, feed=feed, scope=scope,
                          on_op=counting_on_op, sanitize_state=True)
    except Exception as e:
        # an op that RAISES on the bad batch is itself the origin
        if not hits:
            return {"found": False, "ops_scanned": ops_scanned,
                    "state_repaired": repaired, "error": repr(e)}
    if not hits:
        return {"found": False, "ops_scanned": ops_scanned,
                "state_repaired": repaired,
                "note": "forward pass finite — origin is in the "
                        "backward pass (gradient overflow)"}
    first, rest = hits[0], hits[1:max_report + 1]
    out = dict(first)
    out["found"] = True
    out["ops_scanned"] = ops_scanned
    if repaired:
        out["state_repaired"] = repaired
    if rest:
        out["also"] = rest
    return out
