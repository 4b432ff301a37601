"""Device placement: the port of the JAX package's ``core/place.py``
(the reference's ``Place`` variant, platform/place.h:24,34,55).

A Place names a ``torch.device``. ``CUDAPlace`` takes the role of the
JAX package's ``TPUPlace`` (the reference's GPUPlace): the card. There
is no quiet fallback: ``CUDAPlace(...).device`` and ``default_place()``
raise without a card (``device.resolve_device``), and ``CPUPlace()`` is
the explicit opt-in the CPU tests use.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.device import resolve_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "get_places",
           "default_place"]


class Place:
    """Base class for device places."""

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    @property
    def device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    """Host CPU place (ref place.h:24 CPUPlace)."""

    @property
    def device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    """A CUDA card (ref place.h:34 GPUPlace); raises without one."""

    @property
    def device(self) -> torch.device:
        return resolve_device(f"cuda:{self.device_id}")


def get_places(device_count: int | None = None):
    """All CUDA places (ref ``GetPlaces``/``get_places`` op)."""
    n = torch.cuda.device_count()
    if device_count is not None:
        n = min(n, device_count)
    return [CUDAPlace(i) for i in range(n)]


def default_place() -> Place:
    """``CUDAPlace(0)``; raises when no card is present."""
    place = CUDAPlace(0)
    place.device  # noqa: B018 -- resolving it raises without a card
    return place
