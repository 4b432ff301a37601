"""The framework core of the port: the Program IR (``framework.program``:
``Program``, ``Block``, ``Operator``, ``Variable``, ``Parameter``, the
default programs and ``program_guard``), the operator registry
(``framework.registry``: ``register_op``, ``get_op_info``, ``run_op``),
static autodiff (``framework.backward.append_backward``: the
``backward`` pseudo-op) and the eager ``Executor``
(``framework.executor``)."""
from paddle_tpu_torch.framework.backward import append_backward
from paddle_tpu_torch.framework.program import (
    Block, Operator, Parameter, Program, Variable, default_main_program,
    default_startup_program, fresh_programs, program_guard,
    switch_main_program, switch_startup_program, unique_name)
from paddle_tpu_torch.framework.registry import (
    OpContext, OpInfo, get_op_info, has_op, register_op, run_op)

__all__ = ["Block", "Operator", "Parameter", "Program", "Variable",
           "default_main_program", "default_startup_program",
           "fresh_programs", "program_guard", "switch_main_program",
           "switch_startup_program", "unique_name", "OpContext", "OpInfo",
           "get_op_info", "has_op", "register_op", "run_op",
           "append_backward"]
