"""Training-health monitoring: in-graph numerics, host-side policy.

The port of the JAX package's ``obs/health.py``. The reference
framework surfaced training health as per-parameter host stats
(printAllStatus / PrintStatusMachine) — every read was a device sync.
Here the three health scalars are computed INSIDE the train step
(program ops after the optimizer's, the clip.py global-norm pattern)
and fused into ONE ``[3]`` float32 vector:

  [0] global gradient norm   sqrt(sum_g ||g||^2)
  [1] update ratio           lr * grad_norm / max(param_norm, eps)
                             (param_norm is post-update — the ops are
                             appended after the optimizer's, which is
                             where the program pointer sits)
  [2] finite flag            1.0 iff sum_g ||g||^2 is finite (NaN/Inf
                             anywhere in any gradient propagates into
                             the sum, so one isfinite covers them all)

The vector rides the step's existing fetch (the Trainer reads the cost,
the metrics and this vector back in one device-to-host copy a step), so
health-on adds a few reductions on the card but NO extra host round
trip.

Host side, ``HealthMonitor.check`` applies policy per step: update the
``grad_global_norm`` / ``update_ratio`` gauges, and on a non-finite
trip bump ``nonfinite_grads_total``, drop a trace event, and warn or
raise per the configured action.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from paddle_tpu_torch.framework.program import unique_name

__all__ = ["HealthMonitor"]

_ACTIONS = ("warn", "raise", "none")


class HealthMonitor:
    """Policy + op-graph builder for training-health scalars.

    ``action``: what to do when a step's gradients are non-finite —
    ``"warn"`` (warnings.warn, training continues), ``"raise"``
    (FloatingPointError, the step's updates are already applied), or
    ``"none"`` (record metrics only).  ``Trainer(health=...)`` accepts
    an action string or a configured instance.
    """

    def __init__(self, action: str = "warn", ratio_eps: float = 1e-12):
        if action not in _ACTIONS:
            raise ValueError(
                f"health action must be one of {_ACTIONS}, got {action!r}")
        self.action = action
        self.ratio_eps = float(ratio_eps)
        self.var = None               # the [3] f32 program variable
        self.trips = 0                # non-finite steps seen
        self.last = None              # last {"grad_norm", ...} dict

    # ----------------------------------------------------- graph build
    def install(self, block, params_grads, lr_var=None):
        """Append the health ops to ``block`` (call AFTER
        optimizer.minimize so the program pointer is past the update
        ops) and return the fused ``[3]`` float32 health variable."""
        params_grads = [(p, g) for p, g in params_grads if g is not None]
        if not params_grads:
            raise ValueError("health monitor needs a non-empty "
                             "params_grads (did minimize run?)")

        def scalar(tag):
            return block.create_var(name=unique_name(tag), shape=[1],
                                    dtype="float32")

        def global_norm(pairs, pick, tag):
            sqs = []
            for p, g in pairs:
                v = pick(p, g)
                sq = scalar(f"health_{tag}_sq")
                block.append_op("squared_l2_norm", inputs={"X": v},
                                outputs={"Out": sq})
                sqs.append(sq)
            total_sq = scalar(f"health_{tag}_gsq")
            block.append_op("sum", inputs={"X": sqs},
                            outputs={"Out": total_sq})
            f32_sq = scalar(f"health_{tag}_gsq32")
            block.append_op("cast", inputs={"X": total_sq},
                            outputs={"Out": f32_sq},
                            attrs={"dtype": "float32"})
            norm = scalar(f"health_{tag}_norm")
            block.append_op("sqrt", inputs={"X": f32_sq},
                            outputs={"Out": norm})
            return f32_sq, norm

        grad_sq, grad_norm = global_norm(
            params_grads, lambda p, g: g, "grad")
        _, param_norm = global_norm(
            params_grads, lambda p, g: p, "param")

        finite = scalar("health_finite")
        block.append_op("isfinite", inputs={"X": grad_sq},
                        outputs={"Out": finite})

        eps = scalar("health_eps")
        block.append_op("fill_constant", outputs={"Out": eps},
                        attrs={"shape": [1], "dtype": "float32",
                               "value": self.ratio_eps})
        denom = scalar("health_denom")
        block.append_op("elementwise_max",
                        inputs={"X": param_norm, "Y": eps},
                        outputs={"Out": denom})
        if lr_var is not None:
            num = scalar("health_lr_gnorm")
            block.append_op("elementwise_mul",
                            inputs={"X": grad_norm, "Y": lr_var},
                            outputs={"Out": num})
        else:
            num = grad_norm
        ratio = scalar("health_update_ratio")
        block.append_op("elementwise_div", inputs={"X": num, "Y": denom},
                        outputs={"Out": ratio})

        health = block.create_var(name=unique_name("health_vec"),
                                  shape=[3], dtype="float32")
        block.append_op("concat", inputs={"X": [grad_norm, ratio, finite]},
                        outputs={"Out": health}, attrs={"axis": 0})
        self.var = health
        return health

    # ---------------------------------------------------------- policy
    def check(self, values, telemetry=None, step: Optional[int] = None):
        """Apply policy to one step's fetched health vector (shape
        ``[3]``) or a K-step group's (``[K, 3]``).  Returns the last
        step's ``{"grad_norm", "update_ratio", "finite"}``."""
        arr = np.asarray(values, dtype=np.float64).reshape(-1, 3)
        bad = [i for i in range(arr.shape[0])
               if not (arr[i, 2] >= 0.5 and np.isfinite(arr[i, 0]))]
        gn, ratio = float(arr[-1, 0]), float(arr[-1, 1])
        self.last = {"grad_norm": gn, "update_ratio": ratio,
                     "finite": not bad}
        if telemetry is not None:
            telemetry.record_health(gn, ratio, n_bad=len(bad))
        if bad:
            self.trips += len(bad)
            where = f" at step {step}" if step is not None else ""
            sub = (f" (step {bad[0]}/{arr.shape[0]} of the grouped "
                   f"dispatch)" if arr.shape[0] > 1 else "")
            msg = (f"non-finite gradients detected{where}{sub}: "
                   f"grad_global_norm={float(arr[bad[0], 0])}")
            if telemetry is not None:
                telemetry.tracer.event("health_trip", step=step,
                                       grad_norm=float(arr[bad[0], 0]),
                                       bad_steps=len(bad))
            if self.action == "raise":
                raise FloatingPointError(msg)
            if self.action == "warn":
                warnings.warn(msg, RuntimeWarning, stacklevel=3)
        return self.last

    @staticmethod
    def ensure(value) -> Optional["HealthMonitor"]:
        """Normalise a user-facing ``health=`` argument: None/False →
        off, an action string → a fresh monitor, an instance passes
        through."""
        if value is None or value is False:
            return None
        if value is True:
            return HealthMonitor()
        if isinstance(value, str):
            return HealthMonitor(action=value)
        if isinstance(value, HealthMonitor):
            return value
        raise TypeError("health= expects None/bool/str/HealthMonitor, "
                        f"got {type(value)!r}")
