"""Program IR: Program / Block / Operator / Variable — the port of the
JAX package's ``framework/program.py`` (the reference's ``ProgramDesc ->
BlockDesc -> {VarDesc, OpDesc}``, framework.proto:145,135,117,33, and
its Python mirror, fluid/framework.py:59,220,366,510).

The IR is lean: named variables, parameter management, program cloning
for test mode, and the op list the Executor runs, one op at a time
(``framework/executor.py``). It has no interpreter or kernels of its
own and no shape inference; dtypes are torch dtypes
(``core.dtype.convert_dtype``). The same network built through this
package's layers and the JAX package's gives the same op list, the same
variable names (``unique_name`` counters start from 0 in fresh
programs) and the same ``fingerprint``.
"""
from __future__ import annotations

import contextlib
import copy
import difflib
import hashlib
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

from paddle_tpu_torch.core.dtype import convert_dtype, dtype_name
from paddle_tpu_torch.framework import registry

__all__ = [
    "Variable",
    "Parameter",
    "Operator",
    "Block",
    "Program",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "unique_name",
    "switch_main_program",
    "switch_startup_program",
    "fresh_programs",
]


_name_counters: Dict[str, int] = defaultdict(int)


def unique_name(prefix: str) -> str:
    _name_counters[prefix] += 1
    return f"{prefix}_{_name_counters[prefix] - 1}"


class Variable:
    """A named tensor slot in a Block (ref framework.py:59)."""

    def __init__(
        self,
        block: "Block",
        name: Optional[str] = None,
        shape: Optional[Sequence[int]] = None,
        dtype="float32",
        lod_level: int = 0,
        persistable: bool = False,
        stop_gradient: bool = False,
        is_data: bool = False,
    ):
        self.block = block
        self.name = name or unique_name("tmp")
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data

    @property
    def grad_name(self) -> str:
        return self.name + "@GRAD"

    def __repr__(self):
        return (
            f"Variable(name={self.name!r}, shape={self.shape}, "
            f"dtype={dtype_name(self.dtype)}, lod_level={self.lod_level})"
        )

    # Operator sugar so users can write `a + b` on program variables.
    def _binary(self, other, op_type, reverse=False):
        from paddle_tpu_torch import layers

        return layers.elementwise_binary_sugar(self, other, op_type, reverse)

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    def __radd__(self, o):
        return self._binary(o, "elementwise_add", True)

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    def __rmul__(self, o):
        return self._binary(o, "elementwise_mul", True)

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._binary(o, "elementwise_div", True)


class Parameter(Variable):
    """A trainable persistable Variable (ref framework.py:637)."""

    def __init__(self, block, shape, dtype, **kwargs):
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.initializer = kwargs.pop("initializer", None)
        self.update_hooks = list(kwargs.pop("update_hooks", None) or ())
        super().__init__(block, shape=shape, dtype=dtype, persistable=True, **kwargs)


class Operator:
    """One op invocation: type + named I/O slots + attrs (ref framework.py:366)."""

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, Any]] = None,
        outputs: Optional[Dict[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = {}
        self.outputs: Dict[str, List[str]] = {}
        self.attrs = dict(attrs or {})

        def norm(slot_map, store):
            for slot, vars_ in (slot_map or {}).items():
                if vars_ is None:
                    continue
                if not isinstance(vars_, (list, tuple)):
                    vars_ = [vars_]
                store[slot] = [v.name if isinstance(v, Variable) else str(v) for v in vars_]

        norm(inputs, self.inputs)
        norm(outputs, self.outputs)

    def input_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def __repr__(self):
        bidx = self.block.idx if self.block is not None else "?"
        return (f"Operator({self.type}, block={bidx}, in={self.inputs}, "
                f"out={self.outputs})")


class Block:
    """A straight-line list of ops + its variables (ref framework.py:510)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        return self.program.blocks[self.parent_idx] if self.parent_idx >= 0 else None

    def create_var(self, name=None, **kwargs) -> Variable:
        v = Variable(self, name=name, **kwargs)
        if v.name in self.vars:
            raise ValueError(f"variable {v.name!r} already exists in block {self.idx}")
        self.vars[v.name] = v
        return v

    def create_parameter(self, shape, dtype, name=None, **kwargs) -> Parameter:
        p = Parameter(self, shape, dtype, **kwargs)
        if name is not None:
            p.name = name
        # parameters always live in the global block (ref framework.py)
        gb = self.program.global_block()
        gb.vars[p.name] = p
        p.block = gb
        return p

    def _path(self) -> str:
        """Parent chain as ``"0/2"`` (global block down to this one)."""
        parts: List[str] = []
        b: Optional[Block] = self
        while b is not None:
            parts.append(str(b.idx))
            b = b.parent_block
        return "/".join(reversed(parts))

    def var(self, name: str) -> Variable:
        """Look up through the parent-block chain."""
        b: Optional[Block] = self
        visible: List[str] = []
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            visible.extend(b.vars)
            b = b.parent_block
        close = difflib.get_close_matches(name, visible, n=3, cutoff=0.6)
        hint = f"; did you mean {', '.join(repr(c) for c in close)}?" \
            if close else ""
        raise KeyError(
            f"variable {name!r} not found in block {self._path()} or its "
            f"ancestors ({len(visible)} variables visible){hint}")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    # op types handled specially by the Executor, not the registry
    PSEUDO_OPS = ("backward", "feed", "fetch", "static_rnn", "while",
                  "conditional_block")

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        if type not in Block.PSEUDO_OPS:
            registry.get_op_info(type)  # raises on unknown op type
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._version += 1
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._version += 1
        return op

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]


class Program:
    """A list of Blocks; block 0 is global (ref framework.proto:145)."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self._version = 0  # bumped on mutation; the Executor's plan key
        self.random_seed: Optional[int] = None
        self.for_test = False

    # -- block management --------------------------------------------
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def create_block(self) -> Block:
        b = Block(self, len(self.blocks), parent_idx=self._current_block_idx)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        self._version += 1
        return b

    def rollback(self):
        self._current_block_idx = self.current_block().parent_idx

    # -- queries ------------------------------------------------------
    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self) -> List[Parameter]:
        return self.global_block().all_parameters()

    def clone(self, for_test: bool = False) -> "Program":
        """Deep-ish copy. ``for_test`` marks test-mode so ops like dropout
        and batch_norm run in inference form (ref framework.py clone)."""
        p = Program.__new__(Program)
        p.blocks = []
        p._current_block_idx = 0
        p._version = self._version
        p.random_seed = self.random_seed
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            # shallow-copy each Variable (not just the dict): a later
            # mutation of a var (shape, persistable, stop_gradient) must
            # not leak between the train and test programs — including
            # Parameters' mutable containers
            nb.vars = {}
            for name, v in b.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                if isinstance(v, Parameter):
                    nv.optimize_attr = dict(v.optimize_attr)
                    nv.update_hooks = list(v.update_hooks)
                nb.vars[name] = nv
            nb.ops = []
            for op in b.ops:
                nop = copy.copy(op)
                # ops resolve sub-blocks inside the CLONE, and their
                # io/attr dicts are not shared with the source op
                nop.block = nb
                nop.attrs = dict(op.attrs)
                nop.inputs = {k: list(v) for k, v in op.inputs.items()}
                nop.outputs = {k: list(v) for k, v in op.outputs.items()}
                nb.ops.append(nop)
            if for_test:
                for nop in nb.ops:
                    has_flag = registry.has_op(nop.type) and (
                        "is_test" in registry.get_op_info(nop.type).attrs
                    )
                    if has_flag:
                        nop.attrs["is_test"] = True
            p.blocks.append(nb)
        p.for_test = for_test
        return p

    def validate(self, fetch_names=(), assume_defined=(), passes=None,
                 raise_on_error: bool = True):
        """The static verifier (the JAX package's ``analysis``) is not
        ported yet."""
        raise NotImplementedError(
            "Program.validate needs the static verifier (analysis/), "
            "which the port has not yet (ROADMAP A10)")

    def fingerprint(self) -> str:
        """Short stable identity hash of the graph — op types, i/o
        wiring, attrs, and var shapes/dtypes (dtypes by numpy name, so a
        program built through both packages' layers hashes the same);
        two processes building the same program get the same
        fingerprint (no object ids)."""
        h = hashlib.sha256()
        for b in self.blocks:
            h.update(f"block {b.idx} {b.parent_idx}\n".encode())
            for name in sorted(b.vars):
                v = b.vars[name]
                h.update(f"var {name} {v.shape} {dtype_name(v.dtype)} "
                         f"{v.lod_level}\n".encode())
            for op in b.ops:
                h.update(
                    f"op {op.type} {sorted(op.inputs.items())} "
                    f"{sorted(op.outputs.items())} "
                    f"{sorted((k, str(v)) for k, v in op.attrs.items())}"
                    "\n".encode())
        return h.hexdigest()[:16]

    def __repr__(self):
        lines = []
        for b in self.blocks:
            lines.append(f"block {b.idx} (parent {b.parent_idx}):")
            for op in b.ops:
                lines.append(f"  {op}")
        return "\n".join(lines)


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(program: Program) -> Program:
    global _main_program
    prev, _main_program = _main_program, program
    return prev


def switch_startup_program(program: Program) -> Program:
    global _startup_program
    prev, _startup_program = _startup_program, program
    return prev


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    """Scoped redirection of the default programs (ref framework.py)."""
    prev_main = switch_main_program(main_program)
    prev_start = None
    if startup_program is not None:
        prev_start = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_start is not None:
            switch_startup_program(prev_start)


def fresh_programs():
    """Reset the default programs and the name counters (test helper)."""
    _name_counters.clear()
    m, s = Program(), Program()
    switch_main_program(m)
    switch_startup_program(s)
    return m, s
