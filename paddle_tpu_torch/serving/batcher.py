"""Serving backpressure signal shared by the engines."""
from __future__ import annotations

__all__ = ["ServingOverloadError"]


class ServingOverloadError(RuntimeError):
    """Raised by ``submit`` when the pending queue is at ``max_queue``
    — the explicit reject-with-error backpressure signal."""
