"""LayerHelper — shared plumbing for the layers DSL: the port of the JAX
package's ``layer_helper.py`` (fluid/layer_helper.py: parameter
creation with default initializers, bias and activation appending)."""
from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.framework.program import (
    Parameter,
    default_main_program,
    unique_name,
)
from paddle_tpu_torch.initializer import (ConstantInitializer,
                                          XavierInitializer)
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs
        self.name = kwargs.get("name") or unique_name(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_parameter(self, attr, shape, dtype="float32",
                         is_bias: bool = False,
                         default_initializer=None) -> Parameter:
        attr = ParamAttr.to_attr(attr)
        if attr.initializer is None:
            if default_initializer is not None:
                attr.initializer = default_initializer
            elif is_bias:
                attr.initializer = ConstantInitializer(0.0)
            else:
                attr.initializer = XavierInitializer()
        suffix = "b" if is_bias else "w"
        name = attr.name or unique_name(f"{self.name}.{suffix}")
        p = self.block.create_parameter(
            shape=shape, dtype=dtype, name=name,
            trainable=attr.trainable,
            regularizer=attr.regularizer,
            initializer=attr.initializer,
            optimize_attr={"learning_rate": attr.learning_rate},
            update_hooks=attr.update_hooks,
        )
        attr.initializer(p)
        return p

    def create_tmp_variable(self, dtype="float32", shape=None, lod_level=0):
        return self.block.create_var(
            name=unique_name(f"{self.name}.tmp"), dtype=dtype, shape=shape,
            lod_level=lod_level)

    def create_global_variable(self, name=None, shape=None, dtype="float32",
                               persistable=True):
        gb = self.main_program.global_block()
        return gb.create_var(name=name or unique_name(f"{self.name}.global"),
                             shape=shape, dtype=dtype, persistable=persistable)

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.block.append_op(type, inputs, outputs, attrs)

    def append_bias_op(self, input_var, bias_attr, size, dim_start=1):
        if bias_attr is False:
            return input_var
        b = self.create_parameter(
            None if bias_attr in (None, True) else bias_attr,
            shape=[size], dtype=input_var.dtype, is_bias=True)
        out = self.create_tmp_variable(dtype=input_var.dtype,
                                       shape=input_var.shape,
                                       lod_level=input_var.lod_level)
        self.append_op("elementwise_add", inputs={"X": input_var, "Y": b},
                       outputs={"Out": out}, attrs={"axis": dim_start})
        return out

    def append_activation(self, input_var, act: Optional[str]):
        if act is None:
            return input_var
        out = self.create_tmp_variable(dtype=input_var.dtype,
                                       shape=input_var.shape,
                                       lod_level=input_var.lod_level)
        self.append_op(act, inputs={"X": input_var}, outputs={"Out": out})
        return out
