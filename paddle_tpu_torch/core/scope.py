"""Hierarchical variable scope: the port of the JAX package's
``core/scope.py`` (the reference's scope.h / variable.h).

A name -> value mapping with parent-chain lookup; the Executor keeps
persistable variables here between runs. Values are ``LoDTensor``s over
torch tensors; the Executor replaces a written variable's tensor rather
than writing into it, so a tensor read from the scope is a snapshot.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

from paddle_tpu_torch.core.lod import LoDTensor, to_lod_tensor

__all__ = ["Scope", "global_scope", "reset_global_scope"]


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self.parent = parent
        self._kids = []

    def new_scope(self) -> "Scope":
        kid = Scope(parent=self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids.clear()

    def var(self, name: str) -> Any:
        """Find-or-create in *this* scope (ref scope.h Var())."""
        if name not in self._vars:
            self._vars[name] = None
        return self._vars[name]

    def set_var(self, name: str, value):
        self._vars[name] = value

    def find_var(self, name: str):
        """Look up through the parent chain (ref scope.h FindVar())."""
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return True
            s = s.parent
        return False

    def erase(self, name: str):
        self._vars.pop(name, None)

    def local_var_names(self) -> Iterator[str]:
        return iter(self._vars.keys())

    def set_tensor(self, name: str, value, lod=None):
        self.set_var(name, to_lod_tensor(value, lod))

    def get_tensor(self, name: str) -> LoDTensor:
        v = self.find_var(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in scope")
        return v


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def reset_global_scope():
    global _global_scope
    _global_scope = Scope()
    return _global_scope
