"""Static autodiff entry point: the port of the JAX package's
``framework/backward.py`` (the reference's ``AppendBackward``,
backward.cc:112,351, and fluid/backward.py:6).

Rather than one grad op per forward op, a single ``backward`` pseudo-op
is appended; the Executor runs the ops before it with the parameters
requiring grad and fills each ``param@GRAD`` variable with
``torch.autograd.grad`` of the loss (the JAX package uses
``jax.value_and_grad``). The gradient variables still exist in the
Program, so optimizers and fetches address them as in the reference.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from paddle_tpu_torch.framework.program import Parameter, Variable

__all__ = ["append_backward"]


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence] = None,
    no_grad_set: Optional[set] = None,
) -> List[Tuple[Parameter, Variable]]:
    """Append the backward region for ``loss``; returns (param, grad) pairs."""
    program = loss.block.program
    block = program.global_block()
    no_grad = {n if isinstance(n, str) else n.name for n in (no_grad_set or ())}

    if parameter_list is None:
        params = [p for p in block.all_parameters() if p.trainable]
    else:
        params = [block.var(p) if isinstance(p, str) else p for p in parameter_list]
    params = [p for p in params if p.name not in no_grad and not p.stop_gradient]

    grads = []
    for p in params:
        gname = p.grad_name
        if gname in block.vars:
            g = block.vars[gname]
        else:
            g = block.create_var(name=gname, shape=p.shape, dtype=p.dtype)
        grads.append(g)

    block.append_op(
        "backward",
        inputs={"Loss": loss},
        outputs={"Grads": grads},
        attrs={
            "loss_name": loss.name,
            "parameter_names": [p.name for p in params],
        },
    )
    return list(zip(params, grads))
