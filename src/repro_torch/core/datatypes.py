"""``MPI_Type_indexed`` over a flat buffer, as the paged KV cache needs it.

A counterpart of the ``Indexed`` / ``indexed`` / ``block_table`` piece of
the JAX package's ``core/datatypes.py``; the rest of that module (vector,
subarray, slots, pytree, the payload pipeline) comes with the jmpi
runtime slice of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Indexed:
    """``MPI_Type_indexed``: ragged blocks at arbitrary displacements over
    a flat (raveled) buffer."""

    blocklengths: tuple = ()
    displacements: tuple = ()

    def __post_init__(self):
        if len(self.blocklengths) != len(self.displacements):
            raise ValueError(
                f"indexed needs matching blocklengths/displacements, got "
                f"{len(self.blocklengths)} vs {len(self.displacements)}")

    @property
    def extent(self) -> int:
        """Minimum flat-buffer length the layout spans."""
        ends = [d + l for d, l in zip(self.displacements, self.blocklengths)]
        return max(ends, default=0)

    def _indices(self) -> np.ndarray:
        if not self.blocklengths:
            return np.zeros((0,), dtype=np.int64)
        return np.concatenate([np.arange(l) + d for l, d in
                               zip(self.blocklengths, self.displacements)])

    def pack(self, buf) -> torch.Tensor:
        """Gather the ragged blocks from the raveled buffer.

        Args:
            buf: tensor (or array) with at least :attr:`extent` elements.
        Returns:
            The concatenated ``(sum(blocklengths),)`` message, on
            ``buf``'s device.
        Raises:
            ValueError: the buffer is too short for the layout.
        """
        flat = torch.as_tensor(buf).reshape(-1)
        if flat.shape[0] < self.extent:
            raise ValueError(f"indexed extent {self.extent} exceeds buffer "
                             f"size {flat.shape[0]}")
        return flat[torch.as_tensor(self._indices(), device=flat.device)]


def indexed(blocklengths, displacements) -> Indexed:
    """``MPI_Type_indexed``: ragged blocks at static displacements.

    Raises:
        ValueError: mismatched arities or overlapping blocks.
    """
    ls = tuple(int(l) for l in blocklengths)
    ds = tuple(int(d) for d in displacements)
    spans = sorted(zip(ds, ls))
    for (d0, l0), (d1, _) in zip(spans, spans[1:]):
        if d0 + l0 > d1:
            raise ValueError(f"indexed blocks overlap: [{d0}, {d0 + l0}) "
                             f"and [{d1}, ...)")
    return Indexed(blocklengths=ls, displacements=ds)


def block_table(block_ids, block_size, n_tokens, row_elems=1) -> Indexed:
    """Per-sequence :func:`indexed` view of a paged KV pool.

    The returned datatype selects a sequence's first ``n_tokens`` token
    rows (``row_elems`` elements each) from the raveled pool, following
    the block table ``block_ids`` in position order.

    Raises:
        ValueError: ``n_tokens`` exceeds the table's capacity, a count is
            negative, or two table entries name the same block (overlap).
    """
    ids = [int(b) for b in block_ids]
    bs, n, re_ = int(block_size), int(n_tokens), int(row_elems)
    if bs <= 0 or re_ <= 0 or n < 0:
        raise ValueError(
            f"block_table needs block_size/row_elems > 0 and n_tokens >= 0, "
            f"got {bs}/{re_}/{n}")
    if n > len(ids) * bs:
        raise ValueError(f"block_table covers {len(ids) * bs} tokens "
                         f"({len(ids)} blocks x {bs}), asked for {n}")
    lengths, displs = [], []
    for p, bid in enumerate(ids):
        rows = min(bs, n - p * bs)
        if rows <= 0:
            break
        lengths.append(rows * re_)
        displs.append(bid * bs * re_)
    return indexed(lengths, displs)
