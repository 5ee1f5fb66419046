"""Request queue + admission control for the continuous-batching engine.

FIFO with head-of-line admission: a request is admitted the first step at
or after its ``arrival`` when (a) a sequence slot is free and (b) the paged
cache can reserve its whole lifetime's blocks up front.  Head-of-line
blocking is deliberate — skipping ahead would starve long requests under
pressure; the queue drains in submission order.

The scheduler owns request *state* transitions (queued → prefill → decode
→ done) and slot assignment; the engine owns the clock, the device steps,
and when to call :meth:`Scheduler.admissible`.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

QUEUED, PREFILL, DECODE, DONE = "queued", "prefill", "decode", "done"


@dataclasses.dataclass
class Request:
    """One generation request and its serving state.

    ``prompt`` is a 1-D int32 token array; ``arrival`` is the engine-step
    clock tick at which the request becomes visible to admission (0 =
    immediately).  The remaining fields are engine-owned bookkeeping.
    """

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival: int = 0
    state: str = QUEUED
    slot: int = -1
    cursor: int = 0                     # prompt tokens already prefilled
    tokens: list = dataclasses.field(default_factory=list)
    arrived_wall: float = 0.0
    finished_wall: float = 0.0

    @property
    def prompt_len(self) -> int:
        """Prompt length in tokens."""
        return int(len(self.prompt))

    @property
    def total_kv_tokens(self) -> int:
        """KV rows written over the request's lifetime.

        Prompt positions 0..S-1 plus one row per decode *input* token —
        the last generated token is emitted but never written back.
        """
        return self.prompt_len + max(self.max_new_tokens - 1, 0)


class Scheduler:
    """FIFO queue + slot assignment over ``max_slots`` sequence slots."""

    def __init__(self, max_slots: int):
        """Create an empty scheduler with ``max_slots`` sequence slots."""
        self.max_slots = int(max_slots)
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}
        self._free_slots = list(range(self.max_slots - 1, -1, -1))

    @property
    def idle(self) -> bool:
        """True when nothing is queued or in flight."""
        return not self.queue and not self.active

    @property
    def free_slots(self) -> int:
        """Currently unoccupied sequence slots."""
        return len(self._free_slots)

    def submit(self, req: Request) -> None:
        """Append a request to the FIFO queue."""
        self.queue.append(req)

    def admissible(self, now: int, try_reserve) -> list[Request]:
        """Admit head-of-line requests that have arrived and fit.

        Args:
            now: the engine-step clock.
            try_reserve: callable ``(slot, n_tokens) -> bool`` that must
                atomically check *and* reserve the whole request lifetime's
                blocks (the engine passes the paged cache's reservation).
                Reserving inside the loop — rather than checking first and
                allocating after — is what keeps multiple same-step
                admissions from racing a stale free count.
        Returns:
            Admitted requests (state set to ``prefill``, slot assigned,
            blocks reserved); stops at the first request that has not
            arrived or does not fit (FIFO — no skipping ahead).
        """
        admitted = []
        while self.queue and self._free_slots:
            req = self.queue[0]
            if req.arrival > now:
                break
            slot = self._free_slots[-1]
            if not try_reserve(slot, req.total_kv_tokens):
                break
            self.queue.popleft()
            req.slot = self._free_slots.pop()
            req.state = PREFILL
            self.active[req.slot] = req
            admitted.append(req)
        return admitted

    def release(self, req: Request) -> None:
        """Return a finished request's slot to the free pool."""
        req.state = DONE
        del self.active[req.slot]
        self._free_slots.append(req.slot)

    def next_prefill(self) -> Request | None:
        """Oldest admitted request still consuming its prompt, if any."""
        pres = self.prefills(1)
        return pres[0] if pres else None

    def prefills(self, limit: int) -> list[Request]:
        """Up to ``limit`` oldest admitted requests still in prefill.

        These share one batched chunked-prefill dispatch (rid order, so a
        long prompt keeps its chunks in submission order across steps).
        """
        cands = sorted((r for r in self.active.values()
                        if r.state == PREFILL), key=lambda r: r.rid)
        return cands[:int(limit)]

    def decoding(self) -> list[Request]:
        """Active requests in the decode phase, slot-ordered."""
        return sorted((r for r in self.active.values() if r.state == DECODE),
                      key=lambda r: r.slot)
