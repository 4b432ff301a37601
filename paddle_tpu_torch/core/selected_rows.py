"""SelectedRows — sparse row-slice gradients: the port of the JAX
package's ``core/selected_rows.py`` (the reference's selected_rows.h:19,
the gradient of ``lookup_table`` with ``is_sparse``).

A SelectedRows is ``(rows int[k], values [k, ...], height)`` with a
static k: padding rows carry ``row == height`` (one past the table) and
are dropped on apply, so nothing depends on the data's shape and
nothing is read back to the host. ``merge()`` is MergeAdd of
selected_rows_functor.h: duplicate row ids summed into sorted, unique
rows.
"""
from __future__ import annotations

import torch

__all__ = ["SelectedRows"]


class SelectedRows:
    """Sparse slice of a ``[height, ...]`` tensor: ``values[i]`` belongs to
    row ``rows[i]``. ``rows == height`` marks padding (dropped on apply)."""

    def __init__(self, rows: torch.Tensor, values: torch.Tensor,
                 height: int):
        self.rows = rows
        self.values = values
        self.height = int(height)

    def _scatter_add(self, index, n):
        """``values`` summed into ``n`` rows by ``index``; entries whose
        index is outside [0, n) are dropped."""
        ok = (index >= 0) & (index < n)
        idx = torch.where(ok, index, torch.full_like(index, n)).long()
        out = self.values.new_zeros((n + 1,) + tuple(self.values.shape[1:]))
        return out.index_add_(0, idx, self.values)[:n]

    def to_dense(self) -> torch.Tensor:
        """Densify with duplicate-row accumulation (scatter-add)."""
        return self._scatter_add(self.rows, self.height)

    def merge(self) -> "SelectedRows":
        """Sum duplicate rows -> sorted unique rows, padded with
        ``height``; the same k, as the JAX package's ``jnp.unique(...,
        size=k, fill_value=height)`` form."""
        k = self.rows.shape[0]
        srt, order = torch.sort(self.rows)
        first = torch.ones_like(srt, dtype=torch.bool)
        first[1:] = srt[1:] != srt[:-1]
        slot = torch.cumsum(first.long(), 0) - 1
        uniq = torch.full_like(self.rows, self.height)
        uniq.scatter_(0, slot, srt)
        pos = torch.empty_like(slot)
        pos[order] = slot
        # rows at or past height land on whatever slot they sorted to;
        # send them out of range so they drop
        pos = torch.where(self.rows >= self.height,
                          torch.full_like(pos, k), pos)
        return SelectedRows(uniq, self._scatter_add(pos, k), self.height)

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, k={self.rows.shape[0]}, "
                f"value_shape={tuple(self.values.shape)})")
