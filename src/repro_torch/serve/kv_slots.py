"""Slot-based KV-cache management for continuous batching (twin of
``repro/serve/kv_slots.py``).

The scheduler preallocates ONE decode cache with batch dim ``n_slots`` and
seq dim ``max_len`` and never reallocates it.  A :class:`SlotPool` tracks
which batch rows ("slots") are bound to which in-flight request and how many
positions each slot has written (its ``pos``).  Admission = bind a free slot;
completion/EOS = free it; the freed row's stale K/V is never re-read because
every attention mask only looks at rows < the *current* occupant's pos, and
each row is overwritten before the position pointer moves past it.

Invariants (checked on every transition, cheap enough to leave on):
  * a slot is never double-assigned (alloc of an active slot raises),
  * free() of an inactive slot raises (no double-free),
  * |free| + |active| == n_slots at all times (no leaks).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import metrics as _om

# process-global occupancy gauges (no-ops while obs is off): last write
# wins, so a metrics snapshot shows the most recently active pool
_G_POOL_ACTIVE = _om.gauge("serve.pool_active")
_G_POOL_FREE = _om.gauge("serve.pool_free")


class SlotError(RuntimeError):
    """A slot-pool invariant was violated (double-assign, double-free, leak)."""


@dataclasses.dataclass
class Slot:
    """One KV-cache batch row bound to an in-flight request."""

    index: int
    request_id: Optional[int] = None
    pos: int = 0  # positions written so far == next write row


class SlotPool:
    """Fixed pool of ``n_slots`` KV-cache rows with per-slot position tracking."""

    def __init__(self, n_slots: int, max_len: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.max_len = max_len
        # popped from the end: slot 0 is handed out first (stable ordering
        # makes scheduler runs reproducible)
        self._free: List[int] = list(range(n_slots - 1, -1, -1))
        self._active: Dict[int, Slot] = {}

    # ------------------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return len(self._active)

    def active_slots(self) -> List[Slot]:
        return [self._active[i] for i in sorted(self._active)]

    def get(self, index: int) -> Slot:
        try:
            return self._active[index]
        except KeyError:
            raise SlotError(f"slot {index} is not active") from None

    # ------------------------------------------------------------------

    def alloc(self, request_id: int) -> Slot:
        """Bind a free slot to ``request_id``; raises SlotError when full or
        on a double-assign."""
        if not self._free:
            raise SlotError("no free slots")
        index = self._free.pop()
        if index in self._active:
            raise SlotError(f"slot {index} double-assigned "
                            f"(already bound to request "
                            f"{self._active[index].request_id})")
        slot = Slot(index=index, request_id=request_id, pos=0)
        self._active[index] = slot
        self.check_invariants()
        _G_POOL_ACTIVE.set(len(self._active))
        _G_POOL_FREE.set(len(self._free))
        return slot

    def free(self, index: int) -> None:
        """Return a slot to the pool; raises SlotError on double-free."""
        if index not in self._active:
            raise SlotError(f"free of inactive slot {index}")
        del self._active[index]
        if index in self._free:
            raise SlotError(f"slot {index} double-freed")
        self._free.append(index)
        self.check_invariants()
        _G_POOL_ACTIVE.set(len(self._active))
        _G_POOL_FREE.set(len(self._free))

    def advance(self, index: int, by: int = 1) -> int:
        """Advance a slot's written-position counter; bounds-checked against
        the pool's max_len."""
        slot = self.get(index)
        if slot.pos + by > self.max_len:
            raise SlotError(
                f"slot {index} position {slot.pos}+{by} exceeds "
                f"max_len={self.max_len}")
        slot.pos += by
        return slot.pos

    def positions(self, fill: int = 0) -> np.ndarray:
        """[n_slots] int32 of per-slot positions; inactive slots get
        ``fill`` (their decode-step writes land on a row the next occupant
        overwrites before reading)."""
        out = np.full((self.n_slots,), fill, np.int32)
        for i, slot in self._active.items():
            out[i] = slot.pos
        return out

    def check_invariants(self) -> None:
        free, active = set(self._free), set(self._active)
        if free & active:
            raise SlotError(f"slots both free and active: {free & active}")
        if len(self._free) != len(free):
            raise SlotError("duplicate entries on the free list")
        if free | active != set(range(self.n_slots)):
            missing = set(range(self.n_slots)) - (free | active)
            raise SlotError(f"leaked slots: {sorted(missing)}")
