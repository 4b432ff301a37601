"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. ``LAUNCHES`` counts kernel
launches by wrapper name (incremented where the kernel is launched and
nowhere else), so a run can show that its main path went through the
kernels; ``reset_launches`` zeroes it.

The wrappers take the JAX wrappers' ``interpret=`` (the Pallas
interpreter): ``interpret=True`` on a CPU tensor is the plain version,
which the CPU path already is, and on a CUDA tensor raises
``ValueError`` (``check_interpret``): a CUDA tensor goes to the kernel
or raises.

Each wrapper's CUDA branch also notes the analytic FLOPs of the JAX
function it replaces into the cost plane's ledger (``note_flops``,
``obs/costreport.py``), once per JAX function, with the formula the
JAX wrapper notes (a ``*_flops`` function beside each wrapper); the CPU
branch notes nothing (the counter sees the plain version's products).
The ledger is armed per thread; a kernel's autograd Function saves the
box its forward saw (``saved_ledger``) and its backward, which the
autograd engine may run on its device thread, re-arms it
(``ledger_scope``).

``spmd_trace_guard`` marks an SPMD-partitioned trace (the JAX package's
``kernels.spmd_trace_guard``); the port has no SPMD path yet, so a
kernel dispatch inside one raises, naming ROADMAP A9.
"""
import contextlib
import threading
from typing import Dict

LAUNCHES: Dict[str, int] = {"paged_attention_mixed": 0,
                            "paged_attention_mixed_quant": 0,
                            "paged_attention": 0,
                            "paged_attention_quant": 0,
                            "paged_attention_chunk": 0,
                            "paged_attention_chunk_quant": 0,
                            "quant_matmul": 0,
                            "flash_attention_fwd": 0,
                            "flash_attention_dq": 0,
                            "flash_attention_dkv": 0,
                            "gru_fwd": 0,
                            "gru_bwd": 0,
                            "gru_dw": 0,
                            "lstm_fwd": 0,
                            "lstm_bwd": 0,
                            "lstm_dw": 0,
                            "lstm_proj_fwd": 0,
                            "lstm_proj_bwd": 0,
                            "lstm_proj_dw": 0,
                            # the LSTM recurrences' three routes (each
                            # launch also counts under its wrapper's name)
                            # and B14/B15's pre- and post-pass GEMMs on the
                            # W-resident ones (cluster, grid)
                            "lstm_fwd_cluster": 0,
                            "lstm_bwd_cluster": 0,
                            "lstm_fwd_stream": 0,
                            "lstm_bwd_stream": 0,
                            "lstm_proj_fwd_cluster": 0,
                            "lstm_proj_bwd_cluster": 0,
                            "lstm_proj_fwd_stream": 0,
                            "lstm_proj_bwd_stream": 0,
                            "lstm_fwd_grid": 0,
                            "lstm_bwd_grid": 0,
                            "lstm_proj_fwd_grid": 0,
                            "lstm_proj_bwd_grid": 0,
                            "lstm_proj_xg": 0,
                            "lstm_proj_dxe": 0,
                            # the GRU recurrences' three routes (each
                            # launch also counts under its wrapper's name)
                            "gru_fwd_cluster": 0,
                            "gru_bwd_cluster": 0,
                            "gru_fwd_stream": 0,
                            "gru_bwd_stream": 0,
                            "gru_fwd_grid": 0,
                            "gru_bwd_grid": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_interpret(interpret, t, wrapper: str) -> None:
    """Refuse ``interpret=True`` for a CUDA tensor ``t`` (no interpreter
    runs on the card, and the plain version is not a silent fallback);
    any ``interpret`` is accepted for a CPU tensor."""
    if interpret and t.device.type == "cuda":
        raise ValueError(
            f"{wrapper}(interpret=True) on a CUDA tensor: the card runs "
            f"the kernel or raises (the Pallas interpreter's plain "
            f"counterpart is the CPU path; call with CPU tensors)")


def note_flops(flops: float) -> None:
    """Note a launch's analytic FLOPs into the cost plane's ledger
    (imported here at call time, as the JAX wrappers import theirs); a
    no-op unless a ledger is armed on this thread."""
    from paddle_tpu_torch.obs.costreport import note_flops as _note
    _note(flops)


def saved_ledger():
    """The ledger box armed on this thread (None when none is): what a
    kernel's autograd forward saves for its backward."""
    from paddle_tpu_torch.obs.costreport import current_ledger
    return current_ledger()


@contextlib.contextmanager
def ledger_scope(box):
    """Re-arm ``box`` (a ``saved_ledger``) on this thread for the block;
    nothing for None."""
    if box is None:
        yield
        return
    from paddle_tpu_torch.obs.costreport import flops_ledger
    with flops_ledger(box):
        yield


_tls = threading.local()


def in_spmd_trace() -> bool:
    """True inside ``spmd_trace_guard`` on this thread."""
    return getattr(_tls, "depth", 0) > 0


class spmd_trace_guard:
    """Context manager marking an SPMD (GSPMD-partitioned) trace;
    thread-local and re-entrant. ``mesh``/``data_axis`` are kept for
    the JAX signature."""

    def __init__(self, mesh=None, data_axis=None):
        self.mesh, self.data_axis = mesh, data_axis

    def __enter__(self):
        _tls.depth = getattr(_tls, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.depth -= 1
        return False


from paddle_tpu_torch.kernels.paged_attention import (  # noqa: E402
    NEG_INF, paged_attention_chunk, paged_attention_chunk_reference,
    paged_attention_mixed, paged_attention_mixed_reference,
    paged_attention_reference)
# ``kernels.paged_attention``, ``kernels.quant_matmul`` and
# ``kernels.flash_attention`` are the modules (each has a function of the
# same name, so those functions are not re-exported here)
from paddle_tpu_torch.kernels import flash_attention  # noqa: E402
from paddle_tpu_torch.kernels import fused_rnn  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention  # noqa: E402
from paddle_tpu_torch.kernels import quant_matmul  # noqa: E402

__all__ = ["LAUNCHES", "NEG_INF", "flash_attention", "fused_rnn",
           "check_interpret", "in_spmd_trace", "ledger_scope",
           "note_flops", "paged_attention", "saved_ledger",
           "paged_attention_chunk", "paged_attention_chunk_reference",
           "paged_attention_mixed", "paged_attention_mixed_reference",
           "paged_attention_reference", "quant_matmul", "reset_launches",
           "spmd_trace_guard"]
