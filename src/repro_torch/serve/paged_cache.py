"""Paged KV cache: fixed-size blocks, per-sequence block tables.

The device side is one flat pool of ``n_blocks * block_size`` token rows
per layer (``models.cache.init_paged_kv_cache``), torch tensors on the
engine's device, shared by every in-flight sequence.  This module is the
host side: a free-list allocator over the blocks and per-slot block
tables.  A slot's table is an ``MPI_Type_indexed`` view of the pool
(``core.datatypes.block_table``): ``seq_datatype`` returns that view,
``extract`` packs it into the dense per-sequence K/V, and the engine's
gather rows are derived from the same table.

Block 0 is the scratch block: idle decode slots and prefill pad rows write
there (never attended), so every device step keeps a static shape.
Admission is conservative — a request is admitted only when the blocks
for its whole lifetime (prompt + max_new - 1 written positions) are free
and reserved up front — so a running sequence never runs out mid-flight.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import datatypes as dt
from repro_torch.models import lm as lm_lib


class PagedKVCache:
    """Device pool + host allocator + per-slot block tables."""

    def __init__(self, cfg, n_blocks, block_size, max_slots, max_pages,
                 device):
        """Build the pool on ``device`` and an empty allocator.

        Args:
            cfg: model config (GQA families only).
            n_blocks: total pool blocks including the reserved scratch
                block 0 (so ``n_blocks - 1`` are allocatable).
            block_size: token rows per block.
            max_slots: concurrent sequence slots (the decode batch width).
            max_pages: table length per slot; ``max_pages * block_size``
                is the gathered KV length every step attends over.
            device: the pool's device.
        Raises:
            ValueError: fewer than 2 blocks (nothing left after scratch).
            NotImplementedError: the family's cache cannot be paged.
        """
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (block 0 is scratch), "
                             f"got {n_blocks}")
        self.cfg = cfg
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.max_slots = int(max_slots)
        self.max_pages = int(max_pages)
        self.pool = lm_lib.init_paged_cache(cfg, n_blocks, block_size,
                                            device=device)
        # LIFO free list over blocks 1..n_blocks-1; 0 in a table = scratch
        self._free = list(range(self.n_blocks - 1, 0, -1))
        self.tables = np.zeros((self.max_slots, self.max_pages), np.int32)
        self.n_tokens = np.zeros((self.max_slots,), np.int32)
        self.version = 0      # bumped on every table change (gather caching)

    # ------------------------------------------------------------------ #
    # allocator
    # ------------------------------------------------------------------ #

    @property
    def free_blocks(self) -> int:
        """Blocks currently available for allocation."""
        return len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` token rows."""
        return -(-int(n_tokens) // self.block_size)

    def can_alloc(self, n_tokens: int) -> bool:
        """Whether ``n_tokens`` rows fit in the free list and one table."""
        need = self.blocks_for(n_tokens)
        return need <= self.free_blocks and need <= self.max_pages

    def alloc_slot(self, slot: int, n_tokens: int) -> None:
        """Reserve the blocks for a sequence of ``n_tokens`` total rows.

        Raises:
            ValueError: the slot is already occupied or space is short
                (the scheduler must check :meth:`can_alloc` first).
        """
        if self.n_tokens[slot]:
            raise ValueError(f"slot {slot} already holds "
                             f"{self.n_tokens[slot]} tokens")
        if not self.can_alloc(n_tokens):
            raise ValueError(
                f"cannot allocate {n_tokens} tokens "
                f"({self.blocks_for(n_tokens)} blocks; "
                f"{self.free_blocks} free, {self.max_pages} pages/slot)")
        for p in range(self.blocks_for(n_tokens)):
            self.tables[slot, p] = self._free.pop()
        self.n_tokens[slot] = int(n_tokens)
        self.version += 1

    def free_slot(self, slot: int) -> None:
        """Recycle a finished sequence's blocks and zero its table."""
        for p in range(self.blocks_for(int(self.n_tokens[slot]))):
            self._free.append(int(self.tables[slot, p]))
        self.tables[slot] = 0
        self.n_tokens[slot] = 0
        self.version += 1

    def reset(self) -> None:
        """Recycle every block and clear all tables (pool tensors kept —
        validity is positional, so stale contents are never attended)."""
        self._free = list(range(self.n_blocks - 1, 0, -1))
        self.tables[:] = 0
        self.n_tokens[:] = 0
        self.version += 1

    # ------------------------------------------------------------------ #
    # step-array helpers
    # ------------------------------------------------------------------ #

    def gather_rows(self) -> np.ndarray:
        """(max_slots, max_pages * block_size) pool rows in position order.

        Row ``j`` of a slot holds position ``j``; unallocated table entries
        point at scratch and are masked by position.
        """
        bs = self.block_size
        return (self.tables[:, :, None] * bs
                + np.arange(bs, dtype=np.int32)).reshape(self.max_slots, -1)

    def gather_row(self, slot: int) -> np.ndarray:
        """(max_pages * block_size,) pool rows of one slot."""
        return self.gather_rows()[slot]

    # ------------------------------------------------------------------ #
    # datatype view + dense-extraction oracle
    # ------------------------------------------------------------------ #

    def seq_datatype(self, slot: int, n_tokens: int,
                     row_elems: int = 1) -> dt.Indexed:
        """The slot's block table as an ``indexed`` datatype over the
        pool."""
        pages = self.blocks_for(n_tokens)
        return dt.block_table(self.tables[slot, :pages], self.block_size,
                              n_tokens, row_elems=row_elems)

    def extract(self, slot: int, n_tokens: int) -> dict:
        """Dense per-sequence K/V, packed through the datatype view.

        Returns {"k": (L, n_tokens, KH, D), "v": ...} CPU tensors — what a
        dense linear cache would hold for this sequence.
        """
        out = {}
        for name in ("k", "v"):
            arr = self.pool["main"][name].cpu()           # (L, P, KH, D)
            row = int(np.prod(arr.shape[2:]))
            view = self.seq_datatype(slot, n_tokens, row_elems=row)
            out[name] = torch.stack([
                view.pack(arr[li]).reshape((n_tokens,) + arr.shape[2:])
                for li in range(arr.shape[0])])
        return out
