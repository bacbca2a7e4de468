"""Paged KV-cache memory tier: fixed-size pages + packed prefill streams
(twin of ``repro/serve/kv_pages.py``; pure numpy, same behaviour).

The contiguous :class:`~repro_torch.serve.kv_slots.SlotPool` binds one
``max_len``-row KV strip per slot, so every request costs worst-case memory
regardless of its actual length. This module pages the KV *sequence*
dimension instead: physical cache storage is ``[n_pages, page_size]`` rows,
a free-list allocator hands pages to sequences on admission, and a per-slot
page table maps logical rows ``[0, len)`` onto physical pages. Short
requests now cost ``ceil(len / page_size)`` pages instead of
``max_len`` rows — the admission-capacity lever the ROADMAP calls the
single biggest one for serving memory.

Layout convention (mirrors the TRT-LLM / vLLM block-table split):

- the physical cache is allocated with ``n_pages + 1`` pages; the extra
  page at index ``n_pages`` is the **trash page**. Page-table rows are
  padded with the trash-page id, so decode writes for inactive slots land
  on rows nothing ever reads (reads are masked by the per-sequence length).
- page tables are dense ``[n_slots, max_pages]`` int32 arrays rebuilt from
  the pool on demand (:meth:`PagePool.table_array`) — cheap at serving slot
  counts and always consistent with the allocator state.

Invariants (checked after every transition, mirroring ``SlotPool``):
no page is simultaneously free and mapped, no page is mapped by two
sequences, free ∪ mapped covers every page exactly once, and a sequence's
write position never passes its mapped capacity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import fault as _fault
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot

_G_PAGES_ACTIVE = _om.gauge("serve.pages_active")
_G_PAGES_FREE = _om.gauge("serve.pages_free")
_G_PAGE_FRAG = _om.gauge("serve.page_fragmentation")


class PageError(RuntimeError):
    """Raised on paged-KV bookkeeping violations (double-map, leak, ...)."""


@dataclasses.dataclass
class PageTable:
    """Per-sequence mapping from logical KV rows to physical pages."""

    seq_id: int
    pages: List[int]
    pos: int = 0
    request_id: Optional[int] = None

    @property
    def capacity(self) -> int:
        """Mapped rows (``len(pages) * page_size`` — set by the pool)."""
        return self._capacity

    _capacity: int = 0


class PagePool:
    """Free-list page allocator with per-sequence page tables.

    ``n_pages`` usable pages of ``page_size`` KV rows each. Sequences
    reserve their full row budget up front (``alloc``), so a request that
    was admitted can never fail mid-decode for lack of pages. The physical
    cache backing this pool must be allocated with ``n_pages + 1`` pages;
    index :attr:`trash_page` is the write target for table padding.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages <= 0:
            raise PageError(f"n_pages must be positive, got {n_pages}")
        if page_size <= 0:
            raise PageError(f"page_size must be positive, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # Popped from the end so page 0 is handed out first (deterministic,
        # matches SlotPool's slot-0-first convention).
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._tables: Dict[int, PageTable] = {}
        self.peak_pages = 0
        self.peak_seqs = 0
        self._set_gauges()

    # -- properties ---------------------------------------------------------

    @property
    def trash_page(self) -> int:
        """Physical page id used to pad tables; never read, may be written."""
        return self.n_pages

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_mapped(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def n_seqs(self) -> int:
        return len(self._tables)

    @property
    def mapped_rows(self) -> int:
        return self.n_mapped * self.page_size

    @property
    def used_rows(self) -> int:
        return sum(t.pos for t in self._tables.values())

    def fragmentation(self) -> float:
        """Fraction of mapped rows not (yet) holding live KV entries."""
        mapped = self.mapped_rows
        if mapped == 0:
            return 0.0
        return 1.0 - self.used_rows / mapped

    # -- sizing helpers -----------------------------------------------------

    def pages_for(self, n_rows: int) -> int:
        """Pages needed to hold ``n_rows`` KV rows."""
        return -(-max(int(n_rows), 0) // self.page_size)

    def can_admit(self, n_rows: int) -> bool:
        return self.pages_for(n_rows) <= len(self._free)

    # -- transitions --------------------------------------------------------

    def alloc(self, seq_id: int, n_rows: int,
              request_id: Optional[int] = None) -> PageTable:
        """Reserve pages for ``n_rows`` logical rows under ``seq_id``."""
        if seq_id in self._tables:
            raise PageError(f"seq {seq_id} already holds a page table")
        # the fault site fires BEFORE any mutation, so an injected failure
        # looks like real exhaustion and never leaves a half-mapped table
        _fault.maybe_fail("page_pool.alloc", seq=seq_id, rows=int(n_rows),
                          kind="alloc")
        need = self.pages_for(n_rows)
        if need > len(self._free):
            raise PageError(
                f"cannot map {need} pages for seq {seq_id}: "
                f"only {len(self._free)} free")
        table = PageTable(seq_id=seq_id,
                          pages=[self._free.pop() for _ in range(need)],
                          request_id=request_id)
        table._capacity = need * self.page_size
        self._tables[seq_id] = table
        self.peak_pages = max(self.peak_pages, self.n_mapped)
        self.peak_seqs = max(self.peak_seqs, len(self._tables))
        self.check_invariants()
        self._set_gauges()
        _ot.instant("serve.page_alloc", seq=seq_id, pages=need,
                    rows=int(n_rows), free=len(self._free),
                    request=request_id)
        return table

    def grow(self, seq_id: int, n_rows: int) -> PageTable:
        """Extend ``seq_id``'s mapping to cover ``n_rows`` total rows."""
        table = self._get(seq_id)
        need = self.pages_for(n_rows) - len(table.pages)
        if need <= 0:
            return table
        # probes only when the grow claims a page, so growth inside an
        # already-mapped page never consults the plan
        _fault.maybe_fail("page_pool.alloc", seq=seq_id, rows=int(n_rows),
                          kind="grow")
        if need > len(self._free):
            raise PageError(
                f"cannot grow seq {seq_id} by {need} pages: "
                f"only {len(self._free)} free")
        table.pages.extend(self._free.pop() for _ in range(need))
        table._capacity = len(table.pages) * self.page_size
        self.peak_pages = max(self.peak_pages, self.n_mapped)
        self.check_invariants()
        self._set_gauges()
        _ot.instant("serve.page_alloc", seq=seq_id, pages=need,
                    rows=int(n_rows), free=len(self._free), grow=True)
        return table

    def advance(self, seq_id: int, by: int = 1) -> int:
        """Move ``seq_id``'s write position forward ``by`` rows."""
        table = self._get(seq_id)
        new_pos = table.pos + by
        if new_pos > table.capacity:
            raise PageError(
                f"seq {seq_id} position {new_pos} exceeds mapped capacity "
                f"{table.capacity}")
        table.pos = new_pos
        return new_pos

    def release_unused(self, seq_id: int) -> int:
        """Return ``seq_id``'s reserved-but-unwritten tail pages to the free
        list, keeping only the pages its write position actually covers.

        Under the scheduler's ``alloc="reserve"`` policy an EOS-early request
        holds its full prompt+budget reservation until retire; calling this
        at retire time measures (and reclaims) that stranded tail. Returns
        the number of pages released (0 when the mapping is exactly sized).
        """
        table = self._get(seq_id)
        keep = self.pages_for(table.pos)
        n_rel = len(table.pages) - keep
        if n_rel <= 0:
            return 0
        released = table.pages[keep:]
        del table.pages[keep:]
        table._capacity = keep * self.page_size
        self._free.extend(reversed(released))
        self.check_invariants()
        self._set_gauges()
        _ot.instant("serve.page_release", seq=seq_id, pages=n_rel,
                    free=len(self._free))
        return n_rel

    def free(self, seq_id: int) -> None:
        """Return all of ``seq_id``'s pages to the free list."""
        table = self._tables.pop(seq_id, None)
        if table is None:
            raise PageError(f"seq {seq_id} holds no page table")
        # Reverse so re-allocation hands the same pages back in order.
        self._free.extend(reversed(table.pages))
        self.check_invariants()
        self._set_gauges()
        _ot.instant("serve.page_free", seq=seq_id, pages=len(table.pages),
                    free=len(self._free))

    # -- views --------------------------------------------------------------

    def table(self, seq_id: int) -> PageTable:
        return self._get(seq_id)

    def table_array(self, n_slots: int, width: int) -> np.ndarray:
        """Dense ``[n_slots, width]`` int32 page table, trash-page padded.

        Row ``s`` holds seq ``s``'s physical pages in logical order; unused
        entries (inactive slots, rows past a sequence's mapping) point at
        the trash page so writes routed through them are harmless.
        """
        arr = np.full((n_slots, width), self.trash_page, dtype=np.int32)
        for seq_id, table in self._tables.items():
            if seq_id < 0 or seq_id >= n_slots:
                raise PageError(
                    f"seq {seq_id} outside slot range [0, {n_slots})")
            if len(table.pages) > width:
                raise PageError(
                    f"seq {seq_id} maps {len(table.pages)} pages; table "
                    f"width is {width}")
            arr[seq_id, :len(table.pages)] = table.pages
        return arr

    def positions(self, n_slots: int, fill: int = 0) -> np.ndarray:
        arr = np.full((n_slots,), fill, dtype=np.int32)
        for seq_id, table in self._tables.items():
            arr[seq_id] = table.pos
        return arr

    # -- invariants ---------------------------------------------------------

    def check_invariants(self) -> None:
        free = set(self._free)
        if len(free) != len(self._free):
            raise PageError("duplicate pages on the free list")
        mapped: Dict[int, int] = {}
        for seq_id, table in self._tables.items():
            seen = set()
            for p in table.pages:
                if p < 0 or p >= self.n_pages:
                    raise PageError(f"seq {seq_id} maps out-of-range page {p}")
                if p in seen:
                    raise PageError(f"seq {seq_id} maps page {p} twice")
                seen.add(p)
                if p in mapped:
                    raise PageError(
                        f"page {p} mapped by both seq {mapped[p]} and "
                        f"seq {seq_id}")
                mapped[p] = seq_id
            if table.pos > table.capacity:
                raise PageError(
                    f"seq {seq_id} pos {table.pos} exceeds capacity "
                    f"{table.capacity}")
        overlap = free & set(mapped)
        if overlap:
            raise PageError(f"pages both free and mapped: {sorted(overlap)}")
        if len(free) + len(mapped) != self.n_pages:
            raise PageError(
                f"page leak: {len(free)} free + {len(mapped)} mapped != "
                f"{self.n_pages}")

    def _get(self, seq_id: int) -> PageTable:
        table = self._tables.get(seq_id)
        if table is None:
            raise PageError(f"seq {seq_id} holds no page table")
        return table

    def _set_gauges(self) -> None:
        if not _ot.enabled():
            return  # fragmentation() walks every table: skip it while off
        _G_PAGES_ACTIVE.set(self.n_mapped)
        _G_PAGES_FREE.set(len(self._free))
        _G_PAGE_FRAG.set(self.fragmentation())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PagePool(n_pages={self.n_pages}, page_size={self.page_size},"
                f" free={self.n_free}, seqs={self.n_seqs})")


# ---------------------------------------------------------------------------
# Packed (padding-free) prefill streams
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedPrefill:
    """One exact-shape token stream for several concatenated prompts.

    ``tokens[t]`` belongs to slot ``slot_ids[t]`` at in-sequence position
    ``positions[t]``; ``last_idx[i]`` is the stream index of prompt ``i``'s
    final token (where its first-token logits are read); ``seq_lens[i]`` its
    length. No padding anywhere — attention over this stream does zero
    wasted FLOPs, at the cost of one retrace per distinct total length.
    """

    tokens: np.ndarray
    slot_ids: np.ndarray
    positions: np.ndarray
    last_idx: np.ndarray
    seq_lens: np.ndarray

    @property
    def total_tokens(self) -> int:
        return int(self.tokens.shape[0])


def pack_prompts(prompts: Sequence[Sequence[int]],
                 slots: Sequence[int]) -> PackedPrefill:
    """Concatenate ``prompts`` (assigned to ``slots``) into one stream."""
    if len(prompts) != len(slots):
        raise PageError("pack_prompts: prompts and slots length mismatch")
    if not prompts:
        raise PageError("pack_prompts: empty batch")
    tokens, slot_ids, positions, last_idx, seq_lens = [], [], [], [], []
    cursor = 0
    for prompt, slot in zip(prompts, slots):
        n = len(prompt)
        if n == 0:
            raise PageError(f"pack_prompts: empty prompt for slot {slot}")
        tokens.extend(int(t) for t in prompt)
        slot_ids.extend([int(slot)] * n)
        positions.extend(range(n))
        cursor += n
        last_idx.append(cursor - 1)
        seq_lens.append(n)
    return PackedPrefill(
        tokens=np.asarray(tokens, dtype=np.int32),
        slot_ids=np.asarray(slot_ids, dtype=np.int32),
        positions=np.asarray(positions, dtype=np.int32),
        last_idx=np.asarray(last_idx, dtype=np.int32),
        seq_lens=np.asarray(seq_lens, dtype=np.int32),
    )
