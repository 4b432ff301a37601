"""Gradient clipping by the global norm: the port of the JAX package's
``clip.py`` (the reference's clip_op.cc / clip_by_norm_op.cc and the
global-norm pattern), built from program ops so that it runs in the step
with the update: one ``squared_l2_norm`` a gradient, ``sum``, ``sqrt``,
``fill_constant``, ``elementwise_max``, ``elementwise_div``, then one
``elementwise_mul`` a gradient by ``clip_norm / max(norm, clip_norm)``.
"""
from __future__ import annotations

from paddle_tpu_torch.framework.program import unique_name

__all__ = ["append_gradient_clip_by_global_norm", "GradientClipByGlobalNorm"]


def append_gradient_clip_by_global_norm(params_grads, block, clip_norm: float):
    norm_sqs = []
    for _, g in params_grads:
        ns = block.create_var(name=unique_name("grad_norm_sq"), shape=[1],
                              dtype="float32")
        block.append_op("squared_l2_norm", inputs={"X": g},
                        outputs={"Out": ns})
        norm_sqs.append(ns)
    gn_sq = block.create_var(name=unique_name("global_norm_sq"), shape=[1],
                             dtype="float32")
    block.append_op("sum", inputs={"X": norm_sqs}, outputs={"Out": gn_sq})
    gn = block.create_var(name=unique_name("global_norm"), shape=[1],
                          dtype="float32")
    block.append_op("sqrt", inputs={"X": gn_sq}, outputs={"Out": gn})
    clip_c = block.create_var(name=unique_name("clip_norm_const"), shape=[1],
                              dtype="float32")
    block.append_op("fill_constant", outputs={"Out": clip_c},
                    attrs={"shape": [1], "dtype": "float32",
                           "value": float(clip_norm)})
    denom = block.create_var(name=unique_name("clip_denom"), shape=[1],
                             dtype="float32")
    block.append_op("elementwise_max", inputs={"X": gn, "Y": clip_c},
                    outputs={"Out": denom})
    factor = block.create_var(name=unique_name("clip_factor"), shape=[1],
                              dtype="float32")
    block.append_op("elementwise_div", inputs={"X": clip_c, "Y": denom},
                    outputs={"Out": factor})
    out = []
    for p, g in params_grads:
        block.append_op("elementwise_mul", inputs={"X": g, "Y": factor},
                        outputs={"Out": g})
        out.append((p, g))
    return out


class GradientClipByGlobalNorm:
    def __init__(self, clip_norm: float):
        self.clip_norm = clip_norm
