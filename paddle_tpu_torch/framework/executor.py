"""Executor — runs a Program's ops one at a time on a Place: the port of
the JAX package's ``framework/executor.py`` (the reference's
``Executor::Run`` loop, executor.cc:87,125-129, with the feed/fetch
protocol of feed_fetch_method.h).

The JAX Executor traces a whole block into one jitted XLA computation.
This one is eager, the reference's own form: each op of the block goes
through ``framework.registry.run_op`` on the Place's device, with LoD
carried per variable, ``is_test`` for programs cloned for test, and AMP
(``amp_compute`` ops in bf16 over fp32 masters). The ``backward``
pseudo-op (``append_backward``) splits the block: the ops before it run
with the parameters it names requiring grad, ``torch.autograd.grad`` of
the summed loss fills each ``name@GRAD``, and the ops after it (the
optimizer's updates) run under ``no_grad``. Every persistable an op of
the block writes goes back to the Scope after the step; nothing is
written in place, so the forward segment never sees the values the
update makes. A step reads nothing back to the host except the fetches
``return_numpy`` asks for at the end of ``run``.

A random op gets a ``torch.Generator`` on the Place's device seeded
from (seed, step, op index): the ``seed`` flag, or a program's
``random_seed``, consumed by the next run as in the JAX package.

Options of the JAX Executor:
- ``interpret``, ``donate`` and ``cache_size`` mean nothing here (every
  run is eager, no buffer is aliased between a step's input and output,
  and nothing is compiled to cache); they are accepted and ignored.
- ``telemetry=`` needs the Executor's hooks into ``obs.Telemetry``
  (ROADMAP A5's training-side planes, A item 2), ``validate=True`` A10's
  static verifier and ``compile_cache=`` (or the ``compile_cache_dir``
  flag) A11's store: each raises ``NotImplementedError`` naming it, as
  do ``static_rnn``, ``while`` and ``conditional_block`` (A8) and
  ``prepare_infer(quant_plan=...)`` (A10).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.lod import LoD, LoDTensor, to_lod_tensor
from paddle_tpu_torch.core.place import Place, default_place
from paddle_tpu_torch.core.scope import Scope, global_scope
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.framework import registry
from paddle_tpu_torch.framework.program import (Block, Program, Variable,
                                                default_main_program)

__all__ = ["Executor", "InferSession"]

_CONTROL_FLOW = ("static_rnn", "while", "conditional_block")
_MASK64 = (1 << 64) - 1


def _lod_signature(lod: Optional[LoD]):
    if not lod:
        return None
    return tuple(tuple(int(x) for x in lv) for lv in lod.levels)


def _rng_seed(seed: int, step: int, index: int) -> int:
    """A 63-bit generator seed from (seed, step, op index): splitmix64's
    finalizer over a mix of the three, so neighbouring steps and ops
    draw unrelated streams."""
    x = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9
         + index * 0x94D049BB133111EB) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def _names(fetch_list) -> List[str]:
    return [f.name if isinstance(f, Variable) else str(f)
            for f in fetch_list or ()]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:   # numpy has no bfloat16
        t = t.float()
    return t.cpu().numpy()


def _written(program: Program) -> List[str]:
    """The persistables the program's ops write (they may have no value
    in the scope yet, e.g. the startup program's)."""
    block = program.global_block()
    persist = {n for n, v in block.vars.items() if v.persistable}
    return sorted({n for op in block.ops for n in op.output_names()
                   if n in persist})


class InferSession:
    """Frozen-fetch, pinned-weights inference (``Executor.prepare_infer``):
    the program's persistables are gathered once onto the Place's device
    and the fetch set is frozen, so a request pays no scope walk. Later
    writes to the scope (training) do not reach the session; a program
    that writes state writes the session's copy."""

    def __init__(self, executor: "Executor", program: Program,
                 fetch_list: Sequence, scope: Optional[Scope] = None):
        scope = scope or global_scope()
        self.executor = executor
        self.program = program
        self.fetch_names = tuple(_names(fetch_list))
        self._state = executor._gather_state(program, scope)

    def run(self, feed: Dict[str, Any]) -> List[torch.Tensor]:
        """One inference run against the pinned state. Returns the
        fetches as tensors on the device (nothing is read back). Fetches
        that carry LoD are not taken: serving outputs are batch-major."""
        exe = self.executor
        exe._step_ctr += 1
        env, lod_env = exe._run_step(self.program, self._state, feed,
                                     exe._step_ctr)
        lod_fetches = [n for n in self.fetch_names if lod_env.get(n)]
        if lod_fetches:
            raise NotImplementedError(
                f"InferSession: fetch(es) {lod_fetches} carry LoD — "
                "variable-length fetches need per-request Executor.run")
        for n in _written(self.program):
            if n in env:
                self._state[n] = env[n].detach()
        return [t.detach() for t in exe._fetch(env, self.fetch_names)]


class Executor:
    """Runs Programs against a Scope on a Place."""

    def __init__(self, place: Optional[Place] = None,
                 amp: Optional[bool] = None,
                 cache_size: Optional[int] = None,
                 interpret: bool = False,
                 telemetry=None,
                 validate: bool = False,
                 donate: Optional[bool] = None,
                 compile_cache=None):
        """``place``: ``CUDAPlace(i)`` or the explicit ``CPUPlace()``;
        None is ``default_place()``, the card, which raises without one.
        ``amp``: bf16 compute on ``amp_compute`` ops (matmuls and the
        LSTM recurrences) over fp32 masters (None: the ``amp`` flag).
        ``cache_size``, ``interpret`` and ``donate``: accepted and
        ignored (every run is eager; nothing is cached or aliased).
        ``telemetry``, ``validate`` and ``compile_cache`` raise, naming
        the ROADMAP item that ports what they need."""
        if telemetry:
            raise NotImplementedError(
                "Executor(telemetry=...): the Executor's telemetry hooks "
                "(dispatch spans, the cost and goodput planes) are not "
                "wired yet (ROADMAP A5, A item 2)")
        if validate:
            raise NotImplementedError(
                "Executor(validate=True) needs the static verifier "
                "(analysis/), not ported yet (ROADMAP A10)")
        if compile_cache is None:
            compile_cache = FLAGS.compile_cache_dir or None
        if compile_cache not in (None, False):
            raise NotImplementedError(
                "Executor(compile_cache=...) and the compile_cache_dir flag "
                "need framework/compile_cache.py, not ported yet "
                "(ROADMAP A11)")
        self.place = place or default_place()
        self._device = self.place.device
        self.amp = bool(FLAGS.amp if amp is None else amp)
        self._seed = int(FLAGS.seed)
        self._step_ctr = 0

    # ------------------------------------------------------------------
    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ):
        """One step: the feeds (numpy arrays, tensors or ``LoDTensor``s,
        each cast to its variable's dtype and put on the Place's device)
        and the scope's persistables through the program's ops; the
        persistables its ops write go back to the scope. Returns the
        fetches: numpy arrays with ``return_numpy`` (a fetch with LoD
        stays a ``LoDTensor``), else ``LoDTensor``s on the device."""
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = _names(fetch_list)
        self._consume_seed(program)
        state = self._gather_state(program, scope)
        self._step_ctr += 1
        env, lod_env = self._run_step(program, state, feed or {},
                                      self._step_ctr)
        fetches = self._fetch(env, fetch_names)
        for n in _written(program):
            if n in env:
                scope.set_tensor(n, env[n].detach())
        out = []
        for name, val in zip(fetch_names, fetches):
            lod = lod_env.get(name)
            if return_numpy and not lod:
                out.append(_to_numpy(val))
            else:
                out.append(LoDTensor(val.detach(), lod))
        return out

    def run_multi(
        self,
        program: Optional[Program] = None,
        feeds: Optional[Any] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        feed_lods: Optional[Dict[str, LoD]] = None,
    ):
        """K training steps with no host read between them: the same
        steps, random draws included, as K ``run`` calls.

        ``feeds``: K feed dicts with one shape/LoD signature, or one dict
        of pre-stacked arrays with a leading K axis (per-step LoD in
        ``feed_lods``). Returns one array per fetch with a leading K axis
        (step-major); fetches that carry LoD are not taken. The written
        persistables thread from step to step and reach the scope once,
        after the K-th step, so a step that raises leaves the scope as
        it was."""
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = _names(fetch_list)
        if not feeds:
            raise ValueError("run_multi needs a non-empty list of feeds")
        self._consume_seed(program)
        steps = self._split_feeds(program, feeds, feed_lods)
        state = self._gather_state(program, scope)
        written = _written(program)
        missing = [n for n in written if n not in state]
        if missing:
            raise KeyError(
                f"run_multi: program writes persistable var(s) {missing} "
                "that have no value in the scope yet — run the startup "
                "program (or one single-step run()) first")
        fetched = []
        for i, feed in enumerate(steps):
            env, lod_env = self._run_step(program, state, feed,
                                          self._step_ctr + 1 + i)
            if i == 0:
                lod_fetches = [n for n in fetch_names if lod_env.get(n)]
                if lod_fetches:
                    raise NotImplementedError(
                        f"run_multi: fetch(es) {lod_fetches} carry LoD — "
                        "variable-length fetches need per-step run() calls")
            fetched.append([t.detach() for t in self._fetch(env,
                                                            fetch_names)])
            state.update({n: env[n].detach() for n in written if n in env})
        self._step_ctr += len(steps)
        for n in written:
            scope.set_tensor(n, state[n])
        stacked = [torch.stack([f[j] for f in fetched])
                   for j in range(len(fetch_names))]
        if return_numpy:
            return [_to_numpy(t) for t in stacked]
        return stacked

    def warm(self, program: Optional[Program] = None,
             feed: Optional[Dict[str, Any]] = None,
             fetch_list: Optional[Sequence] = None,
             scope: Optional[Scope] = None,
             fetch_sets: Optional[Sequence[Sequence]] = None,
             steps_per_call: int = 1) -> int:
        """The JAX Executor's pre-compile of every fetch-set variant
        (its compile cache's warm boot): raises, naming ROADMAP A11,
        which ports the compile cache."""
        raise NotImplementedError(
            "Executor.warm (pre-compiling the compile cache's entries) "
            "is not ported yet (ROADMAP A11)")

    def prepare_infer(self, program: Optional[Program] = None,
                      fetch_list: Optional[Sequence] = None,
                      scope: Optional[Scope] = None,
                      quant_plan=None) -> InferSession:
        """Freeze the fetch set and pin this program's persistables on
        the device: an ``InferSession``. ``quant_plan`` (weight-only
        quantization of the pinned state) needs ROADMAP A10's QuantPlan
        and raises."""
        if quant_plan is not None:
            raise NotImplementedError(
                "prepare_infer(quant_plan=...) needs analysis/quant.py, not "
                "ported yet (ROADMAP A10)")
        return InferSession(self, program or default_main_program(),
                            list(fetch_list or []), scope)

    # ------------------------------------------------------------------
    def _consume_seed(self, program: Program):
        if program.random_seed is not None:
            self._seed = int(program.random_seed)
            self._step_ctr = 0
            program.random_seed = None  # consume once

    def _to_device(self, value, dtype=None) -> torch.Tensor:
        """A feed or scope value as a tensor on the device: host data is
        staged in pinned memory, so the copy is queued without waiting
        for the card."""
        t = value if torch.is_tensor(value) else torch.as_tensor(
            np.asarray(value))
        if t.device != self._device and self._device.type == "cuda" \
                and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(self._device, dtype=dtype, non_blocking=True)

    def _gather_state(self, program: Program, scope: Scope):
        """Persistable vars with a live scope value, as tensors on the
        device; a value found elsewhere is moved once and written back."""
        state = {}
        for n, var in program.global_block().vars.items():
            if not var.persistable:
                continue
            val = scope.find_var(n)
            if val is None:
                continue
            t = to_lod_tensor(val).array
            if t.device != self._device:
                t = self._to_device(t)
                scope.set_tensor(n, t)
            state[n] = t
        return state

    def _normalise_feed(self, program: Program, feed: Dict[str, Any]):
        block_vars = program.global_block().vars
        vals, lods = {}, {}
        for name, v in feed.items():
            lod = None
            if isinstance(v, LoDTensor):
                v, lod = v.array, (v.lod or None)
            var = block_vars.get(name)
            vals[name] = self._to_device(
                v, var.dtype if var is not None else None)
            if lod:
                lods[name] = lod
        return vals, lods

    def _split_feeds(self, program: Program, feeds, feed_lods):
        """``run_multi``'s feeds as K (values, lods) pairs on the device,
        checked to share one signature."""
        if isinstance(feeds, dict):
            feed_lods = dict(feed_lods or {})
            stacked, lens = {}, set()
            for name, v in feeds.items():
                if isinstance(v, LoDTensor) and name not in feed_lods:
                    raise ValueError(
                        f"run_multi: pre-stacked feed {name!r} is a "
                        "LoDTensor; pass its per-step LoD explicitly via "
                        "feed_lods (or feed plain arrays)")
                v = v.array if isinstance(v, LoDTensor) else v
                if not hasattr(v, "shape"):
                    v = np.asarray(v)
                stacked[name] = v
                lens.add(int(v.shape[0]))
            if len(lens) != 1:
                raise ValueError(
                    f"run_multi: pre-stacked feeds disagree on the leading "
                    f"K axis: {sorted(lens)}")
            vals, _ = self._normalise_feed(program, stacked)
            lods = {n: l for n, l in feed_lods.items() if l}
            return [({n: a[i] for n, a in vals.items()}, lods)
                    for i in range(lens.pop())]
        steps = [self._normalise_feed(program, f) for f in feeds]
        keys, sig = set(steps[0][0]), {n: _lod_signature(l)
                                       for n, l in steps[0][1].items()}
        for si, (vals, lods) in enumerate(steps[1:], 1):
            if set(vals) != keys:
                raise ValueError("run_multi: feeds must share one key set")
            if {n: _lod_signature(l) for n, l in lods.items()} != sig:
                raise ValueError(
                    f"run_multi: feed LoD differs between steps 0 and {si} "
                    "— all K batches must share one shape/LoD signature "
                    "(bucket the reader)")
        return steps

    def _run_step(self, program: Program, state, feed, step: int):
        """One pass of the program's block over ``state`` (name ->
        device tensor) and ``feed`` (a dict as ``run`` takes it, or the
        (values, lods) pair ``_split_feeds`` makes): returns the final
        environment and the LoD of each variable that has one."""
        if isinstance(feed, tuple):
            feed_vals, feed_lods = feed
        else:
            feed_vals, feed_lods = self._normalise_feed(program, feed)
        env = dict(state)
        env.update(feed_vals)
        lod_env = dict(feed_lods)
        is_test = program.for_test
        ops = program.global_block().ops
        at = next((i for i, op in enumerate(ops) if op.type == "backward"),
                  None)
        if at is None:
            self._run_ops(ops, 0, env, lod_env, step, is_test)
            return env, lod_env
        bwd = ops[at]
        loss_name = bwd.attrs["loss_name"]
        param_names = list(bwd.attrs["parameter_names"])
        with torch.enable_grad():
            leaves = []
            for n in param_names:
                leaves.append(env[n].detach().requires_grad_(True))
                env[n] = leaves[-1]
            self._run_ops(ops[:at], 0, env, lod_env, step, is_test)
            loss = env[loss_name]
            grads = (torch.autograd.grad(loss.sum(), leaves,
                                         allow_unused=True)
                     if loss.requires_grad else [None] * len(leaves))
        for n, leaf, g in zip(param_names, leaves, grads):
            env[n] = leaf.detach()
            env[n + "@GRAD"] = torch.zeros_like(env[n]) if g is None else g
        with torch.no_grad():
            self._run_ops(ops[at + 1:], at + 1, env, lod_env, step,
                          is_test)
        return env, lod_env

    def _run_ops(self, ops, first: int, env, lod_env, step: int,
                 is_test: bool):
        """Run ``ops`` (block indices ``first``...) in order, each through
        ``registry.run_op``; outputs land in ``env``, their LoD in
        ``lod_env``."""
        for i, op in enumerate(ops, first):
            if op.type in _CONTROL_FLOW:
                raise NotImplementedError(
                    f"op #{i} {op.type!r}: control flow (control_flow.py) is "
                    "not ported yet (ROADMAP A8)")
            if op.type in Block.PSEUDO_OPS:
                continue
            try:
                ins = {slot: [env[n] for n in names]
                       for slot, names in op.inputs.items()}
            except KeyError as e:
                raise KeyError(
                    f"op {op.type}: input var {e.args[0]!r} not found "
                    f"(feed it, run the startup program, or check op order)"
                ) from None
            in_lods = {slot: [lod_env.get(n) for n in names]
                       for slot, names in op.inputs.items()}
            rng = None
            if registry.get_op_info(op.type).needs_rng:
                rng = torch.Generator(device=self._device)
                rng.manual_seed(_rng_seed(self._seed, step, i))
            try:
                outs, out_lods = registry.run_op(
                    op.type, ins, op.attrs, in_lods, amp=self.amp, rng=rng,
                    is_test=is_test, device=self._device)
            except Exception as e:
                # op-aware crash context (ref utils/CustomStackTrace.h:51)
                e.add_note(
                    f"  while executing op #{i} {op.type!r} "
                    f"(inputs {op.inputs}, outputs {op.outputs})")
                raise
            for slot, names in op.outputs.items():
                vals = outs.get(slot)
                if vals is None:
                    continue
                for n, v, lod in zip(names, vals, out_lods[slot]):
                    env[n] = v
                    if lod:
                        lod_env[n] = lod
                    else:
                        lod_env.pop(n, None)

    @staticmethod
    def _fetch(env, fetch_names):
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(
                f"fetch variable(s) {missing} not produced by the program "
                f"(check the fetch_list names)")
        return [env[n] for n in fetch_names]
