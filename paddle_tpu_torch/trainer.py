"""Event-driven training loop: the port of the JAX package's
``trainer.py`` ``Trainer`` (the reference's v2 ``SGD`` trainer,
v2/trainer.py:24,124: reader + event callbacks + per-pass testing +
checkpoint hook; and the C++ trainer's in-loop batching,
TrainerInternal.cpp:66).

``train_one_batch`` is one ``Executor.run`` of the main program
(forward, backward and the optimizer's updates); the reader and the
``DataFeeder`` run on the host, and ``double_buffer`` moves the next
batch onto the card on a background thread while the current one
trains (``reader.device_buffered``). Each result's cost and metrics are
read back to the host together, one device-to-host copy a step (one a
group with ``steps_per_call``), as the JAX Trainer turns each into a
Python float.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: ``health=`` and ``numerics=`` (A5: obs/health.py, obs/numerics.py),
``telemetry=``, ``serve_port=`` and ``profile_steps=`` (A5 / A10: the
Trainer's hooks into ``obs.Telemetry``, the live introspection server
and the loop's device-trace capture), and ``MasterTrainer`` (A11: the
master service).
"""
from __future__ import annotations

from itertools import islice
from typing import Callable, Dict, List, Optional, Sequence

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
        if health not in (None, "none"):
            raise NotImplementedError(
                "Trainer(health=...) needs obs/health.py, not ported yet "
                "(ROADMAP A5)")
        if numerics:
            raise NotImplementedError(
                "Trainer(numerics=...) needs obs/numerics.py, not ported "
                "yet (ROADMAP A5)")
        self.cost = cost
        self.metrics = list(metrics or [])
        self.main_program = main_program or default_main_program()
        self.startup_program = startup_program or default_startup_program()
        # the test program is cloned before the backward and optimizer ops
        self.test_program = self.main_program.clone(for_test=True)
        self.optimizer = optimizer
        _, self._params_grads = optimizer.minimize(cost)
        self.exe = executor or Executor(place)
        self.feeder = DataFeeder(feed_list)
        self._initialized = False

    def _init_params(self):
        if not self._initialized:
            self.exe.run(self.startup_program)
            self._initialized = True

    def _fetch_list(self):
        return [self.cost] + self.metrics

    def _results(self, fetches, k: Optional[int] = None
                 ) -> List[Dict[str, float]]:
        """The cost and metrics of one step (``k`` None: fetches as
        ``run`` returns them) or of ``k`` steps (leading K axis, as
        ``run_multi`` returns them) as Python floats: each value's first
        element, all read back in one copy."""
        lead = 1 if k is None else k
        host = torch.cat([f.reshape(lead, -1)[:, :1].to(torch.float64)
                          for f in fetches], dim=1).cpu().tolist()
        keys = ["cost"] + [v.name for v in self.metrics]
        return [dict(zip(keys, row)) for row in host]

    def train_one_batch(self, batch) -> Dict[str, float]:
        self._init_params()
        return self._train_one_feed(self.feeder.feed(batch))

    def _train_one_feed(self, feed) -> Dict[str, float]:
        fetches = self.exe.run(self.main_program, feed=feed,
                               fetch_list=self._fetch_list(),
                               return_numpy=False)
        return self._results([f.array for f in fetches])[0]

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
        fetches = self.exe.run_multi(self.main_program, feeds=group,
                                     fetch_list=self._fetch_list(),
                                     return_numpy=False)
        return self._results(fetches, len(group))

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

        ``telemetry``, ``serve_port`` and ``profile_steps`` raise,
        naming ROADMAP A5 / A10."""
        if telemetry:
            raise NotImplementedError(
                "Trainer.train(telemetry=...): the Trainer's telemetry "
                "hooks (steps, goodput, health) are not wired yet "
                "(ROADMAP A5, A item 2)")
        if serve_port is not None:
            raise NotImplementedError(
                "Trainer.train(serve_port=...) needs obs/server.py and the "
                "telemetry session, not ported yet (ROADMAP A5)")
        if profile_steps is not None:
            raise NotImplementedError(
                "Trainer.train(profile_steps=...) needs the Trainer's "
                "telemetry hooks around obs/profiler.py, not wired yet "
                "(ROADMAP A5 / A10)")
        from paddle_tpu_torch.flags import FLAGS
        log_period = FLAGS.log_period if log_period is None else log_period
        test_period = (FLAGS.test_period if test_period is None
                       else test_period)
        save_period = (FLAGS.saving_period if save_period is None
                       else save_period)
        handler = event_handler or (lambda e: None)
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
                for feed in feed_stream:
                    yield None, feed      # computed in the loop below
                return
            while True:
                group = list(islice(feed_stream, K))
                if not group:
                    return
                for r in self._train_feed_group(group, expected_k=K):
                    yield r, None

        for pass_id in range(num_passes):
            handler(events.BeginPass(pass_id))
            last_mid_test = None   # reused if the pass ends on one
            for batch_id, (result, feed) in enumerate(
                    _result_stream(iter(feed_iter()))):
                handler(events.BeginIteration(pass_id, batch_id))
                if result is None:
                    result = self._train_one_feed(feed)
                last_mid_test = None
                if log_period and (batch_id + 1) % log_period == 0:
                    extras = " ".join(f"{k}={v:.4f}" for k, v in
                                      result.items() if k != "cost")
                    print(f"pass {pass_id} batch {batch_id + 1} "
                          f"cost={result['cost']:.6f} {extras}".rstrip(),
                          flush=True)
                if (test_period and test_reader is not None
                        and (batch_id + 1) % test_period == 0):
                    last_mid_test = self.test(test_reader)
                    print(f"pass {pass_id} batch {batch_id + 1} [test] "
                          + " ".join(f"{k}={v:.6f}"
                                     for k, v in last_mid_test.items()),
                          flush=True)
                handler(events.EndIteration(
                    pass_id, batch_id, result["cost"],
                    {k: v for k, v in result.items() if k != "cost"}))
            eval_results = {}
            if test_reader is not None:
                # parameters unchanged since a final-batch mid-pass test
                eval_results = (last_mid_test if last_mid_test is not None
                                else self.test(test_reader))
            if save_dir and save_period and (pass_id + 1) % save_period == 0:
                self.save_params(save_dir)
            handler(events.EndPass(pass_id, eval_results))

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
            for k, v in self._results([f.array for f in fetches])[0].items():
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
