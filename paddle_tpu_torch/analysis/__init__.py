"""Program analysis for the port: only ``instrument`` (the numerics
observatory's instrumentation pass) so far. The JAX package's other
passes (shape inference, the execution plan, ranges, quantization,
sharding, diagnostics, the cost model) are ROADMAP A10."""
from paddle_tpu_torch.analysis.instrument import (  # noqa: F401
    SelectedTensor,
    install_numerics,
    select_tensors,
)

__all__ = ["SelectedTensor", "install_numerics", "select_tensors"]
