"""Goodput attribution — per-step wall-clock decomposition + verdict.

Answers "where did the step's wall time go?" from the live registry
alone, the attribution layer the measurement planes below it feed
(monitoring design after the large-scale-runtime practice of
TensorFlow, Abadi et al. 2016, arXiv:1605.08695):

  input wait     ``feed_wait_ms`` — the trainer loop blocking on the
                 next feed (K=1 path; ~0 when prefetch keeps up)
  staging wait   ``staging_wait_ms`` — the megastep consumer blocking
                 on the staging queue (K>1 path)
  dispatch       host overhead inside the step: ``trainer_step_ms``
                 minus the fenced ``device_step_ms``
  collective     modeled per-step collective time — the ring cost
                 model (parallel/scaling.py) over the program's parsed
                 HLO collectives; GSPMD collectives run inside the
                 fused program so they are not host-measurable
  compute        the fenced device time net of the collective model

``decompose`` reconciles the components against an independently
measured wall clock (``step_wall_ms``, observed once per trainer-loop
iteration); the unattributed remainder is reported as ``residual_ms``
so the accounting is falsifiable — tests assert coverage within 10%.
``train_goodput`` = productive device compute ms / wall ms. The
largest component names the bottleneck verdict (``input-bound`` /
``staging-bound`` / ``dispatch-bound`` / ``compute-bound`` /
``collective-bound``), surfaced in ``/statusz`` and
``Telemetry.status``.

The reader-pipeline detail metrics (``reader_wait_ms``,
``reader_queue_depth{queue}``) ride a module-level sink installed into
``reader/decorator.py`` (see ``attach_reader_sink``) so the reader
module itself keeps zero obs imports and pays one global read per item
when telemetry is off. They deliberately do NOT enter the wall
reconciliation: a buffered reader's consumer-side queue wait is the
same blocking interval the trainer's ``feed_wait_ms`` already covers
(nested, not additive) — they refine the verdict (a staging-bound
megastep whose staging thread mostly waits on the reader is really
input-bound) and diagnose which queue starved.
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["COMPONENTS", "VERDICTS", "decompose", "format_goodput_table",
           "attach_reader_sink", "detach_reader_sink"]

# decomposition components, in reporting order; each maps to a verdict
COMPONENTS = ("input_wait", "staging_wait", "dispatch", "collective",
              "compute")
VERDICTS = {
    "input_wait": "input-bound",
    "staging_wait": "staging-bound",
    "dispatch": "dispatch-bound",
    "collective": "collective-bound",
    "compute": "compute-bound",
}


def _hist_totals(reg, name: str) -> Tuple[float, int]:
    """(sum, count) across every series of a histogram, (0, 0) when the
    metric was never observed."""
    m = reg.find(name)
    if m is None:
        return 0.0, 0
    s, c = 0.0, 0
    for _key, child in m._items():
        s += getattr(child, "sum", 0.0)
        c += getattr(child, "count", 0)
    return float(s), int(c)


def _gauge_max(reg, name: str) -> float:
    """Max across a (possibly labeled) gauge's series; 0 when absent.
    Max, not sum: per-program series describe alternative programs of
    the same step (run vs run_multi), not additive costs."""
    m = reg.find(name)
    if m is None:
        return 0.0
    vals = [child.value for _key, child in m._items()]
    return float(max(vals)) if vals else 0.0


def decompose(telemetry_or_registry) -> dict:
    """Per-step decomposition from the live registry.

    Accepts a ``Telemetry`` session or a bare ``MetricsRegistry`` (so
    restored snapshots decompose too). Returns a dict with ``steps``,
    ``wall_ms_per_step``, ``wall_basis`` (``measured`` when the
    independent ``step_wall_ms`` clock exists, ``derived`` otherwise),
    per-component ms, ``residual_ms``, ``coverage``, ``train_goodput``
    and the ``verdict``; all-zero with ``steps=0`` before any step ran.
    """
    reg = getattr(telemetry_or_registry, "registry", telemetry_or_registry)
    wall_sum, wall_n = _hist_totals(reg, "step_wall_ms")
    trainer_sum, trainer_n = _hist_totals(reg, "trainer_step_ms")
    device_sum, device_n = _hist_totals(reg, "device_step_ms")
    feed_sum, _ = _hist_totals(reg, "feed_wait_ms")
    staging_sum, _ = _hist_totals(reg, "staging_wait_ms")
    reader_sum, _ = _hist_totals(reg, "reader_wait_ms")

    # step count basis: the independent wall clock when the trainer
    # loop observed one (one observation per step), else the per-step
    # trainer_step_ms observations (per dispatch group ≈ per step)
    n = wall_n or trainer_n
    if not n:
        return {"steps": 0, "wall_ms_per_step": 0.0, "wall_basis": "none",
                "components": {k: 0.0 for k in COMPONENTS},
                "residual_ms": 0.0, "coverage": 0.0, "train_goodput": 0.0,
                "verdict": "unknown", "detail": {}}

    trainer_ms = trainer_sum / trainer_n if trainer_n else 0.0
    device_ms = device_sum / device_n if device_n else 0.0
    input_wait = feed_sum / n
    staging_wait = staging_sum / n
    reader_wait = reader_sum / n
    # collective time is modeled per step (ring cost model over the
    # program's HLO), capped by the fenced device time it runs inside
    collective = min(_gauge_max(reg, "collective_ms"), device_ms)
    compute = max(0.0, device_ms - collective)
    dispatch = max(0.0, trainer_ms - device_ms)

    if wall_n:
        wall = wall_sum / wall_n
        basis = "measured"
    else:
        # no loop-side clock (bare executor sessions): the derived wall
        # is the components' own sum — coverage 1.0 by construction
        wall = input_wait + staging_wait + trainer_ms
        basis = "derived"

    components = {
        "input_wait": input_wait,
        "staging_wait": staging_wait,
        "dispatch": dispatch,
        "collective": collective,
        "compute": compute,
    }
    total = sum(components.values())
    goodput = compute / wall if wall > 0 else 0.0

    verdict_key = max(COMPONENTS, key=lambda k: components[k])
    if (verdict_key == "staging_wait"
            and reader_wait >= 0.5 * staging_wait > 0.0):
        # the staging thread itself was starved by the reader pipeline:
        # the queue wait is input time wearing a staging costume
        verdict_key = "input_wait"
    verdict = VERDICTS[verdict_key] if total > 0 else "unknown"

    return {
        "steps": n,
        "wall_ms_per_step": round(wall, 4),
        "wall_basis": basis,
        "components": {k: round(v, 4) for k, v in components.items()},
        "residual_ms": round(wall - total, 4),
        "coverage": round(total / wall, 4) if wall > 0 else 0.0,
        "train_goodput": round(goodput, 4),
        "verdict": verdict,
        "detail": {
            "trainer_step_ms": round(trainer_ms, 4),
            "device_step_ms": round(device_ms, 4),
            "reader_wait_ms_per_step": round(reader_wait, 4),
            "dispatch_gap_ms": round(_gauge_max(reg, "dispatch_gap_ms"), 4),
            # wire vs raw collective bytes (parallel/scaling.py
            # collective_bytes over the program's HLO): ratio < 1 is
            # the compressed-allreduce win, measured not asserted
            "collective_bytes_wire": int(
                _gauge_max(reg, "collective_bytes_wire")),
            "collective_bytes_raw": int(
                _gauge_max(reg, "collective_bytes_raw")),
        },
    }


def format_goodput_table(d: dict) -> str:
    """Render one decomposition as a text table."""
    if not d.get("steps"):
        return "goodput: no steps recorded"
    lines = [
        f"steps {d['steps']}  wall/step {d['wall_ms_per_step']:.3f} ms "
        f"({d['wall_basis']})  goodput {d['train_goodput']:.3f}  "
        f"verdict {d['verdict']}",
        f"{'component':<14}{'ms/step':>10}{'share':>9}",
    ]
    wall = d["wall_ms_per_step"] or 1.0
    for k in COMPONENTS:
        v = d["components"][k]
        lines.append(f"{k.replace('_', ' '):<14}{v:>10.3f}"
                     f"{100.0 * v / wall:>8.1f}%")
    lines.append(f"{'residual':<14}{d['residual_ms']:>10.3f}"
                 f"{100.0 * d['residual_ms'] / wall:>8.1f}%")
    det = d.get("detail") or {}
    if det.get("reader_wait_ms_per_step"):
        lines.append(f"  (reader queue wait "
                     f"{det['reader_wait_ms_per_step']:.3f} ms/step, "
                     "overlaps input/staging wait)")
    raw = det.get("collective_bytes_raw") or 0
    if raw:
        wire = det.get("collective_bytes_wire") or 0
        lines.append(
            f"  collective bytes/step: wire {wire} raw {raw} "
            f"(x{wire / raw:.2f} of fp32 width)")
    return "\n".join(lines)


# ------------------------------------------------- reader-pipeline sink
def attach_reader_sink(telemetry) -> bool:
    """Install this session's reader sink into ``reader/decorator.py``
    (module-global, one read per item when off). First session wins —
    returns False when another session already instruments the module."""
    from paddle_tpu_torch.reader import decorator as rdec

    reader_wait = telemetry.registry.histogram(
        "reader_wait_ms", "consumer blocking on a reader pipeline queue")
    depth = telemetry.registry.gauge(
        "reader_queue_depth",
        "reader queue occupancy sampled at each get", ("queue",))

    def sink(queue_kind: str, wait_ms: float, qsize: int):
        reader_wait.observe(wait_ms)
        depth.set(float(qsize), queue=queue_kind)

    return rdec.set_obs_sink(sink)


def detach_reader_sink(telemetry) -> None:  # noqa: ARG001 (symmetry)
    from paddle_tpu_torch.reader import decorator as rdec
    rdec.set_obs_sink(None)
