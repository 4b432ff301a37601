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

A step runs only the ops its fetch set needs: a liveness prune keyed on
(program, version, fetch set), computed once per key, keeps every op
whose outputs a fetch or a kept op reads, every op that writes a
persistable and every pseudo-op. It is the eager counterpart of XLA's
dead-code elimination of the JAX Executor's jitted block, which the
numerics observatory relies on (a step that does not fetch the stats
runs no ``tensor_stats`` op); the kept ops give the values they would
give in a full pass, and each random op keeps its (seed, step, op
index) stream.

``telemetry=`` (an ``obs.Telemetry``, or True for a default session)
wires the JAX Executor's hooks: a dispatch counted per ``run`` /
``run_multi`` (``record_dispatch``; ``record_megastep(K)``), the entry
cache's hit or miss on the JAX key (program and version, for_test, the
feed signature with LoD, the state signature, the fetch set, K) with
the program's fingerprint on a miss, the first dispatch of a key billed
as ``compile_span`` and counted into a ``CostReport``
(``obs/costreport.py``) when the session's ``collect_hlo`` is on, during
that same real step, and every later one under ``step_span`` (fenced on
the card's stream) inside a ``step_annotation``. ``cost_report`` counts
one step (or K) on a clone of the scope's state, writing nothing back;
``scan_ops`` replays the forward op by op for ``bisect_nan_origin``.

Options of the JAX Executor:
- ``interpret`` and ``donate`` mean nothing here (every run is eager,
  and no buffer is aliased between a step's input and output);
  ``cache_size`` bounds the entry bookkeeping the telemetry hooks
  count against, as it bounds the JAX Executor's compiled entries.
- ``validate=True`` needs A10's static verifier and ``compile_cache=``
  (or the ``compile_cache_dir`` flag) A11's store: each raises
  ``NotImplementedError`` naming it, as do ``static_rnn``, ``while`` and
  ``conditional_block`` (A8) and ``prepare_infer(quant_plan=...)``
  (A10).
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
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


def _nbytes(tensors) -> int:
    return sum(int(t.numel()) * t.element_size() for t in tensors
               if torch.is_tensor(t))


def _fence(device) -> None:
    """Wait for the card's current stream (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


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
    that writes state writes the session's copy.

    ``compiles`` counts the distinct feed signatures the session has run
    (LRU over the Executor's ``cache_size``, as the JAX session's
    compiled entries): under a ``BucketLadder`` it is bounded by the
    ladder's size. Nothing is compiled here, so ``fresh_compiles``
    equals ``compiles`` and ``cache_loads`` stays 0 (a persistent store
    of compiled entries is ROADMAP A11's)."""

    def __init__(self, executor: "Executor", program: Program,
                 fetch_list: Sequence, scope: Optional[Scope] = None):
        scope = scope or global_scope()
        self.executor = executor
        self.program = program
        self.fetch_names = tuple(_names(fetch_list))
        self._state = executor._gather_state(program, scope)
        self._entries: "OrderedDict[tuple, list]" = OrderedDict()
        self.compiles = 0
        self.fresh_compiles = 0
        self.cache_loads = 0

    def signature(self, feed_vals: Dict[str, Any],
                  feed_lods: Dict[str, Optional[LoD]]) -> tuple:
        """The entry key of a normalised feed: (name, shape, dtype, LoD)
        per feed, sorted by name."""
        return self.executor._feed_signature((feed_vals, feed_lods))

    def warm(self, feed: Dict[str, Any]) -> bool:
        """Run the feed once; True if its signature was new (the JAX
        session's first dispatch of an entry, which compiles it)."""
        before = self.compiles
        self.run(feed)
        return self.compiles > before

    def run(self, feed: Dict[str, Any]) -> List[torch.Tensor]:
        """One inference run against the pinned state. Returns the
        fetches as tensors on the device (nothing is read back). Fetches
        that carry LoD are not taken: serving outputs are batch-major.
        With the Executor's telemetry on, a dispatch of kind ``infer``
        against the session's own entries (keyed on the feed
        signature), as the JAX session's."""
        exe = self.executor
        feed = exe._normalise_feed(self.program, feed)
        sig = self.signature(*feed)
        if sig not in self._entries:    # the JAX session compiles here
            self.compiles += 1
            self.fresh_compiles += 1
        entry = exe._entry(self.program, sig, self._entries)
        exe._step_ctr += 1
        step = exe._step_ctr
        env, lod_env = exe._dispatch(
            self.program, "infer", 1, None,
            lambda: exe._run_step(self.program, self._state, feed, step,
                                  self.fetch_names),
            self._state, feed, self.fetch_names, entry=entry)
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
        ``telemetry``: an ``obs.Telemetry`` session, or True for a
        default one (the module docstring lists its hooks); None is the
        off switch, one attribute read a dispatch. ``cache_size``: the
        entries the telemetry hooks' cache bookkeeping keeps (None: the
        ``executor_cache_size`` flag). ``interpret`` and ``donate``:
        accepted and ignored (every run is eager; nothing is aliased).
        ``validate`` and ``compile_cache`` raise, naming the ROADMAP
        item that ports what they need."""
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
        self.telemetry = None
        if telemetry:
            from paddle_tpu_torch.obs.telemetry import Telemetry
            self.telemetry = Telemetry.ensure(telemetry)
        self._cache_size = int(FLAGS.executor_cache_size
                               if cache_size is None else cache_size)
        # entry key -> [program, not dispatched yet]: the JAX Executor's
        # compiled-entry cache, as the telemetry hooks count it (the
        # program is held, as a JAX entry's closure holds it)
        self._entries: "OrderedDict[tuple, list]" = OrderedDict()
        # program -> {(version, fetch set): live op flags}
        self._live_cache = weakref.WeakKeyDictionary()

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
        feed = self._normalise_feed(program, feed or {})
        self._step_ctr += 1
        step = self._step_ctr
        env, lod_env = self._dispatch(
            program, "run", 1, self._feed_signature(feed),
            lambda: self._run_step(program, state, feed, step, fetch_names),
            state, feed, fetch_names)
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
        K, step0 = len(steps), self._step_ctr + 1
        if self.telemetry is not None:
            self.telemetry.record_megastep(K)
        stacked = self._dispatch(
            program, "run_multi", K,
            self._feed_signature(steps[0]) + (("multi", K),),
            lambda: self._multi_steps(program, state, steps, fetch_names,
                                      step0, written),
            state, steps[0], fetch_names)
        self._step_ctr += K
        for n in written:
            scope.set_tensor(n, state[n])
        if return_numpy:
            return [_to_numpy(t) for t in stacked]
        return stacked

    def _multi_steps(self, program, state, steps, fetch_names, step0,
                     written):
        """``run_multi``'s K steps over ``state`` (updated in place with
        each step's written persistables): the fetches stacked
        step-major."""
        fetched = []
        for i, feed in enumerate(steps):
            env, lod_env = self._run_step(program, state, feed, step0 + i,
                                          fetch_names)
            if i == 0:
                lod_fetches = [n for n in fetch_names if lod_env.get(n)]
                if lod_fetches:
                    raise NotImplementedError(
                        f"run_multi: fetch(es) {lod_fetches} carry LoD — "
                        "variable-length fetches need per-step run() calls")
            fetched.append([t.detach() for t in self._fetch(env,
                                                            fetch_names)])
            state.update({n: env[n].detach() for n in written if n in env})
        return [torch.stack([f[j] for f in fetched])
                for j in range(len(fetch_names))]

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

    def cost_report(self, program: Optional[Program] = None,
                    feed: Optional[Dict[str, Any]] = None,
                    fetch_list: Optional[Sequence] = None,
                    scope: Optional[Scope] = None,
                    feeds: Optional[Any] = None,
                    feed_lods: Optional[Dict[str, LoD]] = None):
        """The ``CostReport`` of one dispatch (``obs/costreport.py``):
        ``feed`` counts one ``run`` step (kind "run"), ``feeds`` (as
        ``run_multi`` takes them, per-step LoD in ``feed_lods``) its K
        steps (kind "run_multi"). The JAX Executor compiles without
        executing; the port counts a real step, on a clone of the
        scope's state, and writes nothing back (the scope, the step
        counter and the seed stay as they were). With a telemetry
        session the report is recorded there too, and the call counts
        against the entry cache as the JAX one does (a first call is a
        miss, and the key's first dispatch is still billed as its
        compile)."""
        if (feed is None) == (feeds is None):
            raise ValueError("cost_report: pass exactly one of feed= "
                             "(single step) or feeds= (stacked K-step)")
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = _names(fetch_list)
        state = {n: t.clone() for n, t in
                 self._gather_state(program, scope).items()}
        if feeds is not None:
            kind = "run_multi"
            steps = self._split_feeds(program, feeds, feed_lods)
            sig = self._feed_signature(steps[0]) + (("multi", len(steps)),)
        else:
            kind = "run"
            steps = [self._normalise_feed(program, feed)]
            sig = self._feed_signature(steps[0])
        if self.telemetry is not None:
            self._entry(program, self._run_key(program, sig, state,
                                               fetch_names))
        step0, written = self._step_ctr + 1, _written(program)
        _, report = self._counted(
            program, kind, len(steps),
            lambda: self._multi_steps(program, state, steps, fetch_names,
                                      step0, written),
            state, steps[0], fetch_names)
        if self.telemetry is not None:
            self.telemetry.record_cost_report(report)
        return report

    def scan_ops(self, program: Optional[Program] = None,
                 feed: Optional[Dict[str, Any]] = None,
                 scope: Optional[Scope] = None,
                 on_op=None,
                 stop_at: str = "backward",
                 is_test: bool = False,
                 sanitize_state: bool = False):
        """Replay the program's global-block ops one at a time, calling
        ``on_op(i, op, env)`` after each — the forward-scan primitive
        behind NaN-origin bisection (obs/numerics.py): each op's output
        is a tensor the observer can inspect for nonfinites.

        Stops BEFORE the first op of type ``stop_at`` (default the
        ``backward`` pseudo-op: everything later operates on gradients).
        Reads feed + live scope state under ``no_grad``, writes nothing
        back — a pure diagnostic replay, with the random ops' streams of
        the current step. Returns the final env dict.

        ``sanitize_state``: repair nonfinite STATE values before the
        replay (NaN → 0, ±Inf clamped to the dtype's finite max). A
        nonfinite training step has already written poisoned parameters
        back to the scope by the time its health trip is handled, and
        replaying against NaN weights would blame the first matmul;
        repaired state lets a data-dependent blowup (log(0), overflow)
        reproduce at its true origin."""
        program = program or default_main_program()
        scope = scope or global_scope()
        env, lod_env = self._normalise_feed(program, feed or {})
        for n, t in self._gather_state(program, scope).items():
            if sanitize_state and t.is_floating_point():
                t = torch.nan_to_num(t)
            env[n] = t
        ops = program.global_block().ops
        for i, op in enumerate(ops):
            if op.type == stop_at:
                ops = ops[:i]
                break
        with torch.no_grad():
            self._run_ops(ops, 0, env, lod_env, self._step_ctr, is_test,
                          on_op=on_op)
        return env

    # ------------------------------------------------------------------
    def _feed_signature(self, feed) -> tuple:
        """A normalised feed's (name, shape, dtype, LoD) signature."""
        vals, lods = feed
        return tuple((n, tuple(t.shape), t.dtype,
                      _lod_signature(lods.get(n)))
                     for n, t in sorted(vals.items()))

    def _run_key(self, program: Program, sig: tuple, state,
                 fetch_names) -> tuple:
        """An ``Executor.run`` / ``run_multi`` entry's key: (program,
        version, for_test, ``sig``, the state signature, the fetch
        set)."""
        return (id(program), program._version, program.for_test, sig,
                tuple((n, tuple(t.shape), t.dtype)
                      for n, t in sorted(state.items())),
                tuple(fetch_names))

    def _entry(self, program: Program, key: tuple, entries=None) -> list:
        """The entry of ``key`` in ``entries`` (the Executor's), LRU over
        ``cache_size``; with telemetry on, a hit or a miss counted into
        the session and the program's fingerprint recorded on a miss."""
        tel = self.telemetry
        entries = self._entries if entries is None else entries
        entry = entries.get(key)
        if entry is not None and entry[0] is program:
            entries.move_to_end(key)
            if tel is not None:
                tel.record_cache(hit=True)
            return entry
        entry = entries[key] = [program, True]
        while len(entries) > self._cache_size:
            entries.popitem(last=False)
        if tel is None:
            return entry
        tel.record_cache(hit=False)
        mode = "test" if program.for_test else "main"
        tel.record_program_fingerprint(
            f"{mode}:{id(program):#x}:v{program._version}",
            program.fingerprint())
        return entry

    def _dispatch(self, program: Program, kind: str, steps: int,
                  sig: tuple, run, state, feed, fetch_names, entry=None):
        """``run()``, one dispatch of ``steps`` steps on the entry of
        ``sig`` (or ``entry``, already looked up), with the telemetry
        hooks when a session is on: the first dispatch of an entry
        billed as its compile (and counted into a ``CostReport`` when
        the session's ``collect_hlo`` is on), every later one fenced
        under ``step_span``. Off, one branch around the call."""
        tel = self.telemetry
        if tel is None:
            return run()
        if entry is None:
            entry = self._entry(program, self._run_key(program, sig, state,
                                                       fetch_names))
        tel.record_dispatch(kind, steps)
        if entry[1]:
            entry[1] = False
            with tel.compile_span(kind):
                if tel.collect_hlo:
                    out, report = self._counted(program, kind, steps, run,
                                                state, feed, fetch_names)
                    tel.record_cost_report(report)
                else:
                    out = run()
                _fence(self._device)
            return out
        from paddle_tpu_torch.obs.profiler import step_annotation
        with tel.step_span(kind, steps) as holder:
            with step_annotation(kind, tel._steps.value):
                out = run()
            holder["block_on"] = out
        return out

    def _counted(self, program: Program, kind: str, steps: int, run,
                 state, feed, fetch_names):
        """``run()`` (one dispatch: one step's ``(env, lods)``, or K steps'
        stacked fetches with ``state`` threaded) under the cost plane's
        counter: ``(its result, the dispatch's CostReport)``, arguments
        the state and ``feed``'s values, outputs the fetches and the
        written persistables."""
        from paddle_tpu_torch.obs import costreport as _costreport
        args = _nbytes(state.values()) + _nbytes(feed[0].values())
        with _costreport.count_step(self._device) as counted:
            out = run()
        written = _written(program)
        if isinstance(out, tuple):
            env = out[0]
            outs = _nbytes(env[n] for n in {*fetch_names, *written}
                           if n in env)
        else:
            outs = _nbytes(out) + _nbytes(state[n] for n in written
                                          if n in state)
        temp = max(0, counted["peak_alloc"] - counted["alloc_before"]
                   - outs) if counted["peak_alloc"] else 0
        return out, _costreport.harvest_cost_report(
            counted["op_flops"], program=kind, steps=steps,
            kernel_flops=counted["kernel_flops"],
            kernel_notes=counted["kernel_notes"], argument_bytes=args,
            output_bytes=outs, temp_bytes=temp)

    def _live(self, program: Program, fetch_names) -> List[bool]:
        """Which ops of the global block a step fetching
        ``fetch_names`` runs (the module docstring's liveness prune),
        once per (program, version, fetch set)."""
        per = self._live_cache.setdefault(program, {})
        key = (program._version, tuple(fetch_names))
        live = per.get(key)
        if live is not None:
            return live
        block = program.global_block()
        persist = {n for n, v in block.vars.items() if v.persistable}
        need = set(fetch_names)
        live = [False] * len(block.ops)
        for i in range(len(block.ops) - 1, -1, -1):
            op = block.ops[i]
            if (op.type in Block.PSEUDO_OPS or op.type in _CONTROL_FLOW
                    or any(n in need or n in persist
                           for n in op.output_names())):
                live[i] = True
                need.update(op.input_names())
        per[key] = live
        return live

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

    def _run_step(self, program: Program, state, feed, step: int,
                  fetch_names=None):
        """One pass of the program's block over ``state`` (name ->
        device tensor) and ``feed`` (a dict as ``run`` takes it, or the
        (values, lods) pair ``_normalise_feed`` makes), running the ops a
        step fetching ``fetch_names`` needs (``_live``; None: every op):
        returns the final environment and the LoD of each variable that
        has one."""
        if isinstance(feed, tuple):
            feed_vals, feed_lods = feed
        else:
            feed_vals, feed_lods = self._normalise_feed(program, feed)
        env = dict(state)
        env.update(feed_vals)
        lod_env = dict(feed_lods)
        is_test = program.for_test
        ops = program.global_block().ops
        live = (None if fetch_names is None
                else self._live(program, fetch_names))
        at = next((i for i, op in enumerate(ops) if op.type == "backward"),
                  None)
        if at is None:
            self._run_ops(ops, 0, env, lod_env, step, is_test, live)
            return env, lod_env
        bwd = ops[at]
        loss_name = bwd.attrs["loss_name"]
        param_names = list(bwd.attrs["parameter_names"])
        with torch.enable_grad():
            leaves = []
            for n in param_names:
                leaves.append(env[n].detach().requires_grad_(True))
                env[n] = leaves[-1]
            self._run_ops(ops[:at], 0, env, lod_env, step, is_test, live)
            loss = env[loss_name]
            grads = (torch.autograd.grad(loss.sum(), leaves,
                                         allow_unused=True)
                     if loss.requires_grad else [None] * len(leaves))
        for n, leaf, g in zip(param_names, leaves, grads):
            env[n] = leaf.detach()
            env[n + "@GRAD"] = torch.zeros_like(env[n]) if g is None else g
        with torch.no_grad():
            self._run_ops(ops[at + 1:], at + 1, env, lod_env, step,
                          is_test, live)
        return env, lod_env

    def _run_ops(self, ops, first: int, env, lod_env, step: int,
                 is_test: bool, live=None, on_op=None):
        """Run ``ops`` (block indices ``first``...) in order, each through
        ``registry.run_op``, skipping those ``live`` (indexed by block
        index) marks dead; outputs land in ``env``, their LoD in
        ``lod_env``. ``on_op(i, op, env)`` observes each op that ran
        (``scan_ops``)."""
        for i, op in enumerate(ops, first):
            if live is not None and not live[i]:
                continue
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
            if on_op is not None:
                on_op(i, op, env)

    @staticmethod
    def _fetch(env, fetch_names):
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(
                f"fetch variable(s) {missing} not produced by the program "
                f"(check the fetch_list names)")
        return [env[n] for n in fetch_names]
