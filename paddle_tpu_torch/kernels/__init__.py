"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. ``LAUNCHES`` counts kernel
launches by wrapper name (incremented where the kernel is launched and
nowhere else), so a run can show that its main path went through the
kernels; ``reset_launches`` zeroes it.

``spmd_trace_guard`` marks an SPMD-partitioned trace (the JAX package's
``kernels.spmd_trace_guard``); the port has no SPMD path yet, so a
kernel dispatch inside one raises, naming ROADMAP A9.
"""
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
           "in_spmd_trace", "paged_attention",
           "paged_attention_chunk", "paged_attention_chunk_reference",
           "paged_attention_mixed", "paged_attention_mixed_reference",
           "paged_attention_reference", "quant_matmul", "reset_launches",
           "spmd_trace_guard"]
