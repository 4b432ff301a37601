"""Process-level flag plane: a copy of the JAX package's ``flags.py``
(which imports only ``os``), so that the port reads the same flags from
the same ``PADDLE_TPU_<NAME>`` environment variables. Of them the port
reads ``fused_rnn`` (the engagement predicate of the fused recurrence
kernels, ``ops/rnn.py:_fused_ok``).

Parity: the reference's central gflags registry
(the reference's paddle/utils/Flags.cpp:18-81 — ~40 process flags like
``use_gpu``, ``trainer_count``, ``port``, ``trainer_id``,
``num_gradient_servers``, ``log_period``, ``seed``, ``beam_size``,
mirrored into SWIG init args). The reference scattered its knobs per
binary; this registry gives the same single source of truth for
trainer/cluster/runtime knobs, resolvable from three planes (later
wins): declared default < ``PADDLE_TPU_<NAME>`` environment variable <
``parse_flags(argv)`` command line.

Usage::

    from paddle_tpu_torch.flags import FLAGS, parse_flags
    parse_flags(["--log_period=50", "--seed=7"])   # e.g. leftover argv
    FLAGS.log_period                                # -> 50
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

__all__ = ["FLAGS", "DEFINE_flag", "parse_flags", "flag_defaults"]


class _FlagSpec:
    __slots__ = ("name", "default", "type", "help")

    def __init__(self, name, default, type_, help_):
        self.name = name
        self.default = default
        self.type = type_
        self.help = help_


class _Flags:
    """Attribute access over the registry; unknown names raise."""

    def __init__(self):
        object.__setattr__(self, "_specs", {})
        object.__setattr__(self, "_values", {})

    def __getattr__(self, name: str):
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(f"unknown flag {name!r}; defined: "
                             f"{sorted(values)}")

    def __setattr__(self, name: str, value):
        specs = object.__getattribute__(self, "_specs")
        if name not in specs:
            raise AttributeError(f"unknown flag {name!r}")
        object.__getattribute__(self, "_values")[name] = _coerce(
            specs[name], value)

    def as_dict(self) -> Dict[str, Any]:
        return dict(object.__getattribute__(self, "_values"))


FLAGS = _Flags()


def _coerce(spec: _FlagSpec, value):
    if spec.type is bool and isinstance(value, str):
        low = value.strip().lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"flag {spec.name}: not a boolean: {value!r}")
    return spec.type(value)


def DEFINE_flag(name: str, default, help: str = ""):  # noqa: A002
    """Register a flag; its type is the default's type. Environment
    override (PADDLE_TPU_<NAME>) is applied immediately."""
    spec = _FlagSpec(name, default, type(default), help)
    specs = object.__getattribute__(FLAGS, "_specs")
    values = object.__getattribute__(FLAGS, "_values")
    if name in specs:
        raise ValueError(f"flag {name!r} already defined")
    specs[name] = spec
    env = os.environ.get(f"PADDLE_TPU_{name.upper()}")
    values[name] = _coerce(spec, env) if env is not None else default
    return spec


def parse_flags(argv: Optional[List[str]] = None) -> List[str]:
    """Consume ``--name=value`` / ``--name value`` / ``--[no]boolflag``
    tokens for DEFINED flags from argv; returns the leftover tokens
    (unknown args pass through untouched, so this composes with any
    argparse CLI — the reference likewise forwarded unparsed args)."""
    if argv is None:
        import sys
        argv = sys.argv[1:]
    specs = object.__getattribute__(FLAGS, "_specs")
    rest: List[str] = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        consumed = False
        if tok.startswith("--"):
            body = tok[2:]
            name, eq, val = body.partition("=")
            if name in specs:
                if eq:
                    setattr(FLAGS, name, val)
                elif specs[name].type is bool:
                    setattr(FLAGS, name, True)
                else:
                    if i + 1 >= len(argv):
                        raise ValueError(f"flag --{name} needs a value")
                    setattr(FLAGS, name, argv[i + 1])
                    i += 1
                consumed = True
            elif (name.startswith("no") and name[2:] in specs
                  and specs[name[2:]].type is bool and not eq):
                setattr(FLAGS, name[2:], False)
                consumed = True
        if not consumed:
            rest.append(tok)
        i += 1
    return rest


def split_flag_plane(argv: List[str]) -> (List[str], List[str]):
    """Split argv into ``(flag_plane, rest)``: the leading run of tokens
    belonging to the process-flag plane, including the value token of a
    space-separated ``--name value`` form for a defined non-bool flag.
    The first token that is neither a flag nor such a value ends the
    plane (it is the subcommand; everything after belongs to it)."""
    specs = object.__getattribute__(FLAGS, "_specs")
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("-"):
            break
        if tok.startswith("--"):
            name, eq, _ = tok[2:].partition("=")
            if (name in specs and not eq and specs[name].type is not bool
                    and i + 1 < len(argv)):
                i += 1  # next token is this flag's value, keep it in-plane
        i += 1
    return list(argv[:i]), list(argv[i:])


def flag_defaults() -> Dict[str, Any]:
    return {n: s.default
            for n, s in object.__getattribute__(FLAGS, "_specs").items()}


# --------------------------------------------------------------------------
# The knob set, mapped from Flags.cpp to this framework's world.
# Device/thread-count knobs collapse into the mesh (SURVEY §1 L0 note);
# pserver port fan-out collapses into the single master/coord plane.

DEFINE_flag("seed", 0, "global RNG seed for Executors (deterministic "
            "by default; ref Flags.cpp seed)")
DEFINE_flag("log_period", 100, "batches between trainer log lines "
            "(ref log_period)")
DEFINE_flag("test_period", 0, "batches between mid-pass test runs "
            "(0 = end of pass only; ref test_period)")
DEFINE_flag("saving_period", 1, "passes between checkpoint saves "
            "(ref saving_period)")
DEFINE_flag("executor_cache_size", 64,
            "max compiled programs kept per Executor (LRU)")
DEFINE_flag("amp", False, "default automatic-mixed-precision mode for "
            "new Executors (bf16 matmul/conv; ref use_gpu's precision "
            "role)")
DEFINE_flag("port", 0, "master TCP port (0 = pick free; ref port)")
DEFINE_flag("master_bind", "127.0.0.1",
            "master bind address (ref nics/port plane)")
DEFINE_flag("task_timeout_ms", 60_000,
            "master task re-dispatch timeout (ref the Go master timeout)")
DEFINE_flag("failure_max", 3,
            "master per-task failure cap (ref go/master service.go)")
DEFINE_flag("chunks_per_task", 1, "recordio chunks per master task")
DEFINE_flag("trainer_id", 0, "this trainer's index (ref trainer_id)")
DEFINE_flag("num_trainers", 1,
            "world size for slot claims (ref num_gradient_servers)")
DEFINE_flag("beam_size", 4, "default decode beam width (ref beam_size)")
DEFINE_flag("coord_dir", "",
            "coordination-store root shared by HA masters and trainers "
            "(lease election / discovery / slot claims; the etcd-prefix "
            "analog). Env plane: PADDLE_TPU_COORD_DIR — what the k8s "
            "templates under deploy/ mount and export")
DEFINE_flag("compile_cache_dir", "",
            "directory of the persistent AOT compile cache "
            "(framework/compile_cache.py). Empty = disabled; set it (or "
            "env PADDLE_TPU_COMPILE_CACHE_DIR) and every Executor in "
            "the process consults/populates the store, making warm "
            "boots compile-free")
DEFINE_flag("calibration_dir", "",
            "directory of the persistent per-tensor calibration store "
            "(obs/numerics.py CalibrationStore). Empty = disabled; set "
            "it (or env PADDLE_TPU_CALIBRATION_DIR) and numerics-"
            "instrumented trainers persist EMA tensor ranges keyed by "
            "program fingerprint — the calibration input for "
            "quantized execution")
DEFINE_flag("fused_rnn", True,
            "use the fused LSTM/GRU time-step kernels when shapes "
            "allow (the hl_cuda_lstm.cu analog); turn off to force the "
            "step-by-step path")
DEFINE_flag("log_clipping", False,
            "log when gradient clipping activates (ref log_clipping)")
