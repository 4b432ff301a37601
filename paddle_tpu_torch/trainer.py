"""Event-driven training loop: the port of the JAX package's
``trainer.py`` ``Trainer`` (the reference's v2 ``SGD`` trainer,
v2/trainer.py:24,124: reader + event callbacks + per-pass testing +
checkpoint hook; and the C++ trainer's in-loop batching,
TrainerInternal.cpp:66).

``train_one_batch`` is one ``Executor.run`` of the main program
(forward, backward and the optimizer's updates); the reader and the
``DataFeeder`` run on the host, and ``double_buffer`` moves the next
batch onto the card on a background thread while the current one
trains (``reader.device_buffered``). Each result's cost and metrics, the
health vector (``health=``, obs/health.py) and, on sampled steps, the
numerics block (``numerics=``, obs/numerics.py) are read back to the
host together, one device-to-host copy a step (one a group with
``steps_per_call``), as the JAX Trainer turns each into a Python float.

``train(telemetry=)`` joins (or opens) an ``obs.Telemetry`` session and
installs it on the Executor for the call: ``trainer_step`` and ``pass``
spans, the feed wait, the pass rollup on ``EndPass``, the trainer's
``/statusz`` row (``status``); ``profile_steps=(a, b)`` captures the
card's trace over global batches a <= n < b. A nonfinite health trip
bisects the failing batch's NaN origin (``bisect_nan_origin``), annotates
the ``nonfinite_grads`` alert and adds the batch and the numerics report
to the flight bundle the trip dumped, as the JAX Trainer does.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: ``serve_port=`` (A10: the live introspection server) and
``MasterTrainer`` (A11: the master service).
"""
from __future__ import annotations

import contextlib
import time
from itertools import islice
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import event as events
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.framework.executor import Executor
from paddle_tpu_torch.framework.program import (
    Program,
    Variable,
    default_main_program,
    default_startup_program,
)

__all__ = ["Trainer", "MasterTrainer"]


def _feed_examples(feed: Dict) -> int:
    """Examples in one feed dict: LoD slots count sequences (level-0
    entries), dense slots count the leading dim; the max over slots."""
    n = 0
    for v in feed.values():
        lod = getattr(v, "lod", None)
        if lod:
            n = max(n, lod.num_sequences(0))
        else:
            shape = tuple(getattr(getattr(v, "array", v), "shape", ()))
            if shape:
                n = max(n, int(shape[0]))
    return n


def _signature(feed: Dict):
    """A feed's shape / dtype / LoD signature (no value is read)."""
    sig = []
    for n in sorted(feed):
        v = feed[n]
        arr = getattr(v, "array", v)
        lod = getattr(v, "lod", None)
        sig.append((n, tuple(arr.shape), str(arr.dtype),
                    tuple(tuple(int(x) for x in lv) for lv in lod.levels)
                    if lod else None))
    return tuple(sig)


class Trainer:
    """Build-once / iterate trainer.

    trainer = Trainer(cost=loss, optimizer=pt.optimizer.SGD(0.01),
                      feed_list=[x, y], metrics=[acc],
                      place=pt.CUDAPlace(0))
    trainer.train(reader=batched_reader, num_passes=2, event_handler=fn)

    The place comes from ``executor=`` (for AMP:
    ``executor=Executor(CUDAPlace(0), amp=True)``) or ``place=``; with
    neither, the Executor's default, the card, which raises without one.
    """

    def __init__(
        self,
        cost: Variable,
        optimizer,
        feed_list: Sequence[Variable],
        metrics: Optional[Sequence[Variable]] = None,
        place=None,
        executor: Optional[Executor] = None,
        main_program: Optional[Program] = None,
        startup_program: Optional[Program] = None,
        health=None,
        numerics=None,
    ):
        self.cost = cost
        self.metrics = list(metrics or [])
        self.main_program = main_program or default_main_program()
        self.startup_program = startup_program or default_startup_program()
        # the test program is cloned before the backward and optimizer ops
        # (and before any health op: test() never fetches health)
        self.test_program = self.main_program.clone(for_test=True)
        self.optimizer = optimizer
        _, self._params_grads = optimizer.minimize(cost)
        # ``health=``: "warn" | "raise" | "none" | HealthMonitor — grad
        # norm, update ratio and finiteness as ONE [3] fetch riding the
        # step's read-back (obs/health.py), checked on the host after
        # each step (each K-step group)
        from paddle_tpu_torch.obs.health import HealthMonitor
        self.health = HealthMonitor.ensure(health)
        self._health_var = None
        if self.health is not None:
            self._health_var = self.health.install(
                cost.block, self._params_grads,
                getattr(optimizer, "_lr_var", None))
        # ``numerics=``: True | NumericsSpec | NumericsMonitor — per-tensor
        # stats as ONE [n, N_STATS] fetch on every Nth step (the Executor's
        # liveness prune runs no stat op on the others), NaN-origin
        # bisection on a health trip, an EMA calibration store
        from paddle_tpu_torch.obs.numerics import NumericsMonitor
        self.numerics = NumericsMonitor.ensure(numerics)
        self._numerics_var = None
        if self.numerics is not None:
            self._numerics_var = self.numerics.install(self.main_program)
        self.exe = executor or Executor(place)
        self.feeder = DataFeeder(feed_list)
        self._initialized = False
        self._tel = None   # the Telemetry session during train()

    def _init_params(self):
        if not self._initialized:
            self.exe.run(self.startup_program)
            self._initialized = True

    def _fetch_list(self, with_numerics: bool = False):
        fetch = [self.cost] + self.metrics
        if self._health_var is not None:
            fetch.append(self._health_var)
        # the numerics vec rides LAST so health stays at a fixed offset
        # from the end in both variants' result lists
        if with_numerics and self._numerics_var is not None:
            fetch.append(self._numerics_var)
        return fetch

    def _results(self, fetches, k: Optional[int] = None):
        """The cost and metrics of one step (``k`` None: fetches as
        ``run`` returns them) or of ``k`` steps (leading K axis, as
        ``run_multi`` returns them) as Python floats (each value's first
        element), and the blocks after them in ``fetches`` (the health
        rows ``[k, 3]``, the numerics block ``[k, n * N_STATS]``) as
        float64 arrays: all read back in one copy."""
        lead = 1 if k is None else k
        n_plain = 1 + len(self.metrics)
        cols = [f.reshape(lead, -1)[:, :1] for f in fetches[:n_plain]]
        cols += [f.reshape(lead, -1) for f in fetches[n_plain:]]
        host = torch.cat([c.to(torch.float64) for c in cols],
                         dim=1).cpu().numpy()
        keys = ["cost"] + [v.name for v in self.metrics]
        results = [dict(zip(keys, row.tolist()))
                   for row in host[:, :n_plain]]
        blocks, at = [], n_plain
        for c in cols[n_plain:]:
            blocks.append(host[:, at:at + c.shape[1]])
            at += c.shape[1]
        return results, blocks

    def train_one_batch(self, batch) -> Dict[str, float]:
        self._init_params()
        return self._train_one_feed(self.feeder.feed(batch))

    def _train_one_feed(self, feed) -> Dict[str, float]:
        tel = self._tel
        if tel is not None:
            with tel.trainer_step(_feed_examples(feed)) as args:
                out = self._train_one_feed_impl(feed)
                args["cost"] = out.get("cost")
            return out
        return self._train_one_feed_impl(feed)

    def _train_one_feed_impl(self, feed) -> Dict[str, float]:
        step = self.exe._step_ctr + 1
        sample = (self._numerics_var is not None
                  and self.numerics.should_sample(step))
        fetches = self.exe.run(self.main_program, feed=feed,
                               fetch_list=self._fetch_list(sample),
                               return_numpy=False)
        results, blocks = self._results([f.array for f in fetches])
        if sample:
            self.numerics.update(blocks.pop(), telemetry=self._tel,
                                 step=step)
        if self._health_var is not None:
            self._check_health(blocks[0], [feed])
        return results[0]

    def status(self) -> dict:
        """The ``/statusz`` row of this trainer: loop state, the health
        and numerics planes, the goodput decomposition of the active
        session. ``execution_plan`` (the JAX Trainer's static plan,
        ``analysis/plan.py``) is ROADMAP A10's: the row holds the error
        the JAX Trainer reports when its plan fails."""
        out = {
            "initialized": self._initialized,
            "training": self._tel is not None,
            "metrics": [m.name for m in self.metrics],
            "health": "on" if self.health is not None else "off",
        }
        if self.numerics is not None:
            out["numerics"] = self.numerics.status()
        tel = self._tel or self.exe.telemetry
        if tel is not None:
            from paddle_tpu_torch.obs import goodput as _goodput
            d = _goodput.decompose(tel)
            if d["steps"]:
                out["goodput"] = {
                    "verdict": d["verdict"],
                    "train_goodput": d["train_goodput"],
                    "wall_ms_per_step": d["wall_ms_per_step"],
                    "components": d["components"],
                }
        out["execution_plan"] = {"error": repr(NotImplementedError(
            "Trainer.execution_plan needs analysis/plan.py, not ported "
            "yet (ROADMAP A10)"))}
        return out

    def _check_health(self, values, feeds, step=None):
        """Run the health policy, then — on a nonfinite trip in EITHER
        warn or raise mode — the numerics forensics: NaN-origin
        bisection of the failing feed, alert annotation, and enrichment
        of the flight bundle the trip just dumped (failing batch +
        numerics report + in-group index). Forensics never mask or
        replace the trip's own outcome."""
        tel = self._tel
        flight = tel.flight if tel is not None else None
        dumps_before = len(flight.dumps) if flight is not None else 0
        err = None
        try:
            self.health.check(values, telemetry=tel, step=step)
        except FloatingPointError as e:
            err = e
        last = self.health.last
        if last is not None and not last["finite"]:
            self._on_health_trip(values, feeds, flight, dumps_before)
        if err is not None:
            raise err

    def _on_health_trip(self, values, feeds, flight, dumps_before):
        """Forensics after a nonfinite health verdict: name the first
        bad in-group step, replay its batch to bisect the NaN's op-level
        origin (obs/numerics.py), and attach everything to the freshly
        dumped flight bundle and the ``nonfinite_grads`` alert."""
        import json
        import os
        arr = np.asarray(values, dtype=np.float64).reshape(-1, 3)
        bad = [i for i in range(arr.shape[0])
               if not (arr[i, 2] >= 0.5 and np.isfinite(arr[i, 0]))]
        k0 = bad[0] if bad else 0
        feed = feeds[min(k0, len(feeds) - 1)]
        origin = None
        if self.numerics is not None and self.numerics.spec.bisect:
            from paddle_tpu_torch.obs.numerics import bisect_nan_origin
            origin = bisect_nan_origin(self.exe, self.main_program, feed)
            self.numerics.origin = origin
        tel = self._tel
        if origin is not None and tel is not None:
            if origin.get("found"):
                tel.alerts.annotate(
                    "nonfinite_grads",
                    nan_origin_op=(f"#{origin['op_index']} "
                                   f"{origin['op_type']}"),
                    nan_origin_var=origin["var"])
            else:
                tel.alerts.annotate(
                    "nonfinite_grads",
                    nan_origin=origin.get("note", "not found"))
        # enrich the bundle only when THIS trip dumped one (the
        # recorder's per-reason cooldown may have suppressed it)
        if flight is None or len(flight.dumps) <= dumps_before:
            return
        bundle = flight.dumps[-1]
        extra = {"megastep_k": arr.shape[0], "bad_index": k0,
                 "bad_indices": bad}
        if origin is not None:
            extra["nan_origin"] = origin
        payload = {}
        for n, v in feed.items():
            arr_v = getattr(v, "array", v)
            if torch.is_tensor(arr_v):
                arr_v = arr_v.detach().cpu()
                if arr_v.dtype == torch.bfloat16:
                    arr_v = arr_v.float()
                arr_v = arr_v.numpy()
            payload[n] = np.asarray(arr_v)
            lod = getattr(v, "lod", None)
            if lod:   # LoD levels ride as sibling arrays
                for li, lv in enumerate(lod.levels):
                    payload[f"{n}__lod{li}"] = np.asarray(lv,
                                                          dtype=np.int64)
        np.savez(os.path.join(bundle, "failing_feed.npz"), **payload)
        extra["failing_feed"] = "failing_feed.npz"
        if self.numerics is not None:
            with open(os.path.join(bundle, "numerics.json"), "w") as f:
                json.dump(self.numerics.report(), f, indent=1, default=str)
            extra["numerics"] = "numerics.json"
        flight.annotate_last(extra)

    def _train_feed_group(self, group, expected_k: int
                          ) -> List[Dict[str, float]]:
        """K feeds of one signature (shapes, dtypes, LoD) in one
        ``Executor.run_multi`` call: the same steps as K runs, and the
        K results read back in one copy. A short group (the tail of a
        pass) or one whose signatures differ runs step by step. (The JAX
        Trainer also asks its static planner, ``analysis/plan.py``,
        whether the program can ride one fused K-step dispatch; the
        port's ``run_multi`` is K eager steps, so the signature decides
        alone.)"""
        sig = _signature(group[0])
        if (len(group) != expected_k or len(group) == 1
                or any(_signature(f) != sig for f in group[1:])):
            return [self._train_one_feed(f) for f in group]
        tel = self._tel
        step0 = self.exe._step_ctr + 1
        # sampling is per group: one run_multi call has one fetch set
        sample = (self._numerics_var is not None
                  and self.numerics.should_sample_group(step0, len(group)))
        with (tel.trainer_step(sum(_feed_examples(f) for f in group),
                               steps=len(group)) if tel is not None
              else contextlib.nullcontext()):
            fetches = self.exe.run_multi(
                self.main_program, feeds=group,
                fetch_list=self._fetch_list(sample), return_numpy=False)
            results, blocks = self._results(fetches, len(group))
        if sample:
            # [K, n, N_STATS]: every in-group step contributed a row
            self.numerics.update(blocks.pop(), telemetry=tel,
                                 step=step0 + len(group) - 1)
        if self._health_var is not None:
            # one [K, 3] check covers the group; a "raise" trip aborts
            # before its results are reported (the K updates are applied)
            self._check_health(blocks[0], group, step=step0)
        return results

    def train(self, reader: Callable, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              test_reader: Optional[Callable] = None,
              log_period: Optional[int] = None,
              test_period: Optional[int] = None,
              save_period: Optional[int] = None,
              save_dir: Optional[str] = None,
              double_buffer: bool = False,
              steps_per_call: int = 1,
              telemetry=None,
              serve_port: Optional[int] = None,
              profile_steps=None,
              profile_dir: Optional[str] = None):
        """reader yields batches (lists of samples).

        Periods default from the flags (``log_period``, ``test_period``,
        ``saving_period``): every ``log_period`` batches a progress line
        is printed; every ``test_period`` batches (if a ``test_reader``
        is given) a mid-pass test runs; every ``save_period`` passes the
        parameters are saved to ``save_dir``. 0 disables each.

        ``double_buffer``: convert the next batch and copy it onto the
        Executor's device on a background thread while the current one
        trains (``reader.device_buffered``).

        ``steps_per_call``: K batches of one signature in one
        ``Executor.run_multi`` call (``_train_feed_group``), the same
        steps as K single ones; per-batch events still fire, but a
        grouped call's BeginIteration fires after the group has
        computed (the K results arrive together), and mid-pass
        ``test_period`` boundaries round up to the group's edge.

        ``telemetry``: ``True`` opens a fresh ``obs.Telemetry`` session
        (trace.jsonl in cwd, closed when train returns), or pass a
        ``Telemetry`` to keep ownership; with neither, a session the
        Executor holds is joined. The session is installed on the
        Executor for the call, so its dispatch, compile and fenced step
        records land in the same trace; each ``EndPass`` carries the
        pass rollup as ``event.telemetry``. Off, the loop pays one
        attribute read a step.

        ``profile_steps=(a, b)``: capture the card's trace
        (``torch.profiler``) over global batches ``a <= n < b`` (counted
        across passes; with ``steps_per_call`` K > 1 the window snaps to
        result boundaries), on the session's ``profiler`` or a fresh
        ``Profiler``; ``profile_dir`` overrides the capture dir.

        ``serve_port`` (the live HTTP introspection server,
        obs/server.py) raises, naming ROADMAP A10."""
        if serve_port is not None:
            raise NotImplementedError(
                "Trainer.train(serve_port=...) needs obs/server.py, not "
                "ported yet (ROADMAP A10)")
        from paddle_tpu_torch.flags import FLAGS
        log_period = FLAGS.log_period if log_period is None else log_period
        test_period = (FLAGS.test_period if test_period is None
                       else test_period)
        save_period = (FLAGS.saving_period if save_period is None
                       else save_period)
        handler = event_handler or (lambda e: None)
        tel = None
        owns_tel = False
        if telemetry:
            from paddle_tpu_torch.obs.telemetry import Telemetry
            tel = Telemetry.ensure(telemetry)
            owns_tel = telemetry is True
        elif self.exe.telemetry is not None:
            tel = self.exe.telemetry   # the Executor's session: join it
        if tel is not None:
            tel.register_status("trainer", self.status)
            if self.numerics is not None:
                tel.numerics = self.numerics
        prev_exe_tel = self.exe.telemetry
        if tel is not None:
            self.exe.telemetry = tel
        self._tel = tel
        prof = None
        prof_window = None
        if profile_steps is not None:
            a, b = int(profile_steps[0]), int(profile_steps[1])
            if not 0 <= a < b:
                raise ValueError(
                    "profile_steps=(start, stop) needs 0 <= start < "
                    f"stop, got {profile_steps!r}")
            prof_window = (a, b)
            if tel is not None:
                prof = tel.profiler
            else:
                from paddle_tpu_torch.obs.profiler import Profiler
                prof = Profiler()
        self._init_params()

        def _feeds():
            for b in reader():
                yield self.feeder.feed(b)

        feed_iter = _feeds
        if double_buffer:
            from paddle_tpu_torch.reader.decorator import device_buffered
            feed_iter = device_buffered(_feeds, size=2,
                                        device=self.exe.place.device)
        K = max(1, int(steps_per_call))

        def _result_stream(feed_stream):
            if K == 1:
                if tel is None:
                    for feed in feed_stream:
                        yield None, feed      # computed in the loop below
                    return
                done = object()
                while True:
                    # the blocking pull is the step's input wait: the
                    # goodput decomposition's feed_wait_ms
                    t0 = time.perf_counter()
                    feed = next(feed_stream, done)
                    if feed is done:
                        return
                    tel.observe_feed_wait((time.perf_counter() - t0) * 1e3)
                    yield None, feed
            while True:
                group = list(islice(feed_stream, K))
                if not group:
                    return
                for r in self._train_feed_group(group, expected_k=K):
                    yield r, None

        try:
            global_batch = 0
            for pass_id in range(num_passes):
                with contextlib.ExitStack() as pass_stack:
                    if tel is not None:
                        pass_stack.enter_context(
                            tel.tracer.span("pass", pass_id=pass_id))
                        pass_t0 = time.perf_counter()
                        pass_ex0 = tel._examples.value
                    handler(events.BeginPass(pass_id))
                    last_mid_test = None   # reused if the pass ends on one
                    n_steps = 0
                    # the per-iteration wall clock the goodput
                    # decomposition's components reconcile against
                    iter_t0 = time.perf_counter()
                    for batch_id, (result, feed) in enumerate(
                            _result_stream(iter(feed_iter()))):
                        handler(events.BeginIteration(pass_id, batch_id))
                        if prof_window is not None:
                            if (global_batch >= prof_window[1]
                                    and prof.capturing):
                                prof.stop()
                                prof_window = None  # one window a call
                            elif (global_batch >= prof_window[0]
                                    and not prof.capturing):
                                prof.start(profile_dir, window=prof_window)
                        global_batch += 1
                        if result is None:
                            result = self._train_one_feed(feed)
                        n_steps = batch_id + 1
                        last_mid_test = None
                        if log_period and (batch_id + 1) % log_period == 0:
                            extras = " ".join(f"{k}={v:.4f}" for k, v in
                                              result.items() if k != "cost")
                            print(f"pass {pass_id} batch {batch_id + 1} "
                                  f"cost={result['cost']:.6f} "
                                  f"{extras}".rstrip(), flush=True)
                        if (test_period and test_reader is not None
                                and (batch_id + 1) % test_period == 0):
                            last_mid_test = self.test(test_reader)
                            print(f"pass {pass_id} batch {batch_id + 1} "
                                  "[test] " + " ".join(
                                      f"{k}={v:.6f}"
                                      for k, v in last_mid_test.items()),
                                  flush=True)
                        handler(events.EndIteration(
                            pass_id, batch_id, result["cost"],
                            {k: v for k, v in result.items()
                             if k != "cost"}))
                        if tel is not None:
                            now = time.perf_counter()
                            tel.observe_step_wall((now - iter_t0) * 1e3)
                            iter_t0 = now
                    eval_results = {}
                    if test_reader is not None:
                        # parameters unchanged since a final-batch
                        # mid-pass test
                        eval_results = (last_mid_test
                                        if last_mid_test is not None
                                        else self.test(test_reader))
                    if (save_dir and save_period
                            and (pass_id + 1) % save_period == 0):
                        self.save_params(save_dir)
                    rollup = None
                    if tel is not None:
                        tel.sample_memory()
                        rollup = tel.pass_rollup(
                            pass_id, n_steps,
                            int(tel._examples.value - pass_ex0),
                            time.perf_counter() - pass_t0)
                    handler(events.EndPass(pass_id, eval_results,
                                           telemetry=rollup))
        except Exception as exc:
            # an exception escaping the loop writes a flight-recorder
            # bundle before propagating (a health "raise" trip already
            # dumped under its own reason)
            if tel is not None and tel.flight is not None:
                tel.flight.dump("exception_trainer",
                                extra={"exception": repr(exc)})
            raise
        finally:
            if prof is not None and prof.capturing:
                prof.stop()   # the reader ended inside the window
            if self.numerics is not None:
                # the EMA ranges, so the next run of this program
                # fingerprint starts calibrated
                self.numerics.save_calibration()
            self._tel = None
            self.exe.telemetry = prev_exe_tel
            if owns_tel and tel is not None:
                tel.close()

    def test(self, reader: Callable) -> Dict[str, float]:
        """Run the test-mode program over a reader; the cost and metrics
        averaged over its samples (ref v2/trainer.py test)."""
        self._init_params()
        totals: Dict[str, float] = {}
        weights = 0
        for batch in reader():
            fetches = self.exe.run(self.test_program,
                                   feed=self.feeder.feed(batch),
                                   fetch_list=self._fetch_list(),
                                   return_numpy=False)
            n = len(batch)
            weights += n
            results, _blocks = self._results([f.array for f in fetches])
            for k, v in results[0].items():
                totals[k] = totals.get(k, 0.0) + v * n
        return {k: v / max(weights, 1) for k, v in totals.items()}

    def save_params(self, dirname: str):
        from paddle_tpu_torch import io

        io.save_params(self.exe, dirname, self.main_program)

    def load_params(self, dirname: str):
        from paddle_tpu_torch import io

        io.load_params(self.exe, dirname, self.main_program)
        self._initialized = True


class MasterTrainer(Trainer):
    """The JAX package's trainer over the master service's task-sharded
    readers: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "MasterTrainer needs the master service (cloud/) and "
            "reader.creator.cloud_reader, not ported yet (ROADMAP A11)")
