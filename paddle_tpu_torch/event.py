"""Training events: the port of the JAX package's ``event.py`` (the
reference's v2/event.py: BeginPass / EndPass / BeginIteration /
EndIteration / EndForwardBackward delivered to the user's
``event_handler`` by the ``Trainer``)."""
from __future__ import annotations

__all__ = ["Event", "BeginPass", "EndPass", "BeginIteration",
           "EndIteration", "EndForwardBackward"]


class Event:
    pass


class BeginPass(Event):
    def __init__(self, pass_id: int):
        self.pass_id = pass_id


class EndPass(Event):
    def __init__(self, pass_id: int, evaluator_results=None,
                 telemetry=None):
        self.pass_id = pass_id
        self.evaluator_results = evaluator_results or {}
        # the per-pass rollup of the Trainer's telemetry session
        # (``Telemetry.pass_rollup``), None without one
        self.telemetry = telemetry


class BeginIteration(Event):
    def __init__(self, pass_id: int, batch_id: int):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(Event):
    def __init__(self, pass_id: int, batch_id: int, cost: float, metrics=None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        self.metrics = metrics or {}


class EndForwardBackward(Event):
    def __init__(self, pass_id: int, batch_id: int):
        self.pass_id = pass_id
        self.batch_id = batch_id
