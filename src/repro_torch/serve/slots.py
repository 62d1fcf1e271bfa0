"""Host-side slot bookkeeping for the continuous-batching engine.

The device sees a fixed [S]-shaped batch every decode step (jit-stable);
the *meaning* of each row — which request it serves, how long its sequence
is, whether it is live — lives here, in plain numpy, mirrored into the
device inputs once per step by ``decode_inputs``.

Slot lifecycle:

    FREE ──assign──▶ PREFILL ──(last chunk, first token)──▶ ACTIVE
      ▲                │                                       │
      │                └───────────── preempt ─────────────────┤
      └──────────────── release (EOS / budget) ◀───────────────┘

Inactive rows still flow through the batched decode step (masked): their
token input is 0 and their write offset is the cache sentinel position —
one the causal mask hides until the moment a live request writes its own
token there, so garbage never leaks into any slot's attention.

Paged mode (``block_size`` set): each slot additionally carries its block
table — the list of physical blocks its virtual positions [0, max_len)
map onto — mirrored into a fixed-width [S, n_max] device array by
``block_tables()`` (unallocated entries padded with the sentinel block 0).
The block ids themselves are owned by ``blocks.BlockAllocator``; the table
only transports them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .blocks import SENTINEL
from .queue import Request

FREE, PREFILL, ACTIVE = 0, 1, 2


@dataclass
class Slot:
    index: int
    state: int = FREE
    request: Optional[Request] = None
    length: int = 0          # tokens currently in this slot's cache row
    prefill_pos: int = 0     # prompt tokens already written (or shared)
    generated: int = 0       # tokens sampled for this request so far
    pending_token: int = 0   # next token to feed the decode step
    output: List[int] = field(default_factory=list)
    # paged mode only:
    blocks: List[int] = field(default_factory=list)   # physical block table
    # recurrent backend only: pooled state row (0 = none — row 0 is the
    # sentinel row and is never allocated to a request)
    rec_row: int = 0
    admit_seq: int = -1      # admission order (preemption picks the max)

    @property
    def req_id(self) -> int:
        return self.request.req_id if self.request is not None else -1


class SlotTable:
    """Fixed pool of S slots + the [S]-shaped device-input builders."""

    def __init__(self, max_slots: int, max_len: int,
                 block_size: Optional[int] = None):
        if max_slots < 1:
            raise ValueError("need at least one slot")
        self.max_slots = max_slots
        self.max_len = max_len
        self.block_size = block_size
        self.n_max = (-(-max_len // block_size)
                      if block_size is not None else 0)
        self._admits = 0
        self.slots = [Slot(i) for i in range(max_slots)]

    @property
    def paged(self) -> bool:
        return self.block_size is not None

    # -- queries ----------------------------------------------------------
    def free(self) -> List[Slot]:
        return [s for s in self.slots if s.state == FREE]

    def prefilling(self) -> List[Slot]:
        return [s for s in self.slots if s.state == PREFILL]

    def active(self) -> List[Slot]:
        return [s for s in self.slots if s.state == ACTIVE]

    def busy(self) -> List[Slot]:
        return [s for s in self.slots if s.state != FREE]

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s.state == ACTIVE)

    def youngest_busy(self) -> Optional[Slot]:
        """The most recently admitted busy slot — the preemption victim."""
        busy = self.busy()
        return max(busy, key=lambda s: s.admit_seq) if busy else None

    # -- lifecycle --------------------------------------------------------
    def assign(self, slot: Slot, request: Request) -> None:
        if slot.state != FREE:
            raise RuntimeError(f"slot {slot.index} not free")
        need = len(request.prompt) + request.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"request {request.req_id} needs {need} cache positions, "
                f"slot holds {self.max_len}")
        self._admits += 1
        slot.state = PREFILL
        slot.request = request
        slot.length = 0
        slot.prefill_pos = 0
        slot.generated = 0
        slot.pending_token = 0
        slot.output = []
        slot.blocks = []
        slot.rec_row = 0
        slot.admit_seq = self._admits

    def activate(self, slot: Slot, first_token: int) -> None:
        """Prefill finished: cache holds the prompt, first token sampled."""
        if slot.state != PREFILL:
            raise RuntimeError(f"slot {slot.index} not prefilling")
        slot.state = ACTIVE
        slot.length = len(slot.request.prompt)
        slot.pending_token = int(first_token)
        slot.generated = 1
        slot.output = [int(first_token)]

    def release(self, slot: Slot) -> Request:
        """Free the slot.  Paged callers must hand the slot's blocks back
        to the allocator FIRST — release only drops the host references."""
        if slot.state == FREE:
            raise RuntimeError(f"slot {slot.index} already free")
        if slot.blocks:
            raise RuntimeError(
                f"slot {slot.index} released with {len(slot.blocks)} live "
                "blocks — free them through the allocator first")
        if slot.rec_row:
            raise RuntimeError(
                f"slot {slot.index} released with live recurrent row "
                f"{slot.rec_row} — free it through the row pool first")
        request = slot.request
        slot.state = FREE
        slot.request = None
        slot.length = 0
        slot.prefill_pos = 0
        slot.generated = 0
        slot.pending_token = 0
        slot.admit_seq = -1
        return request

    # -- device-input builders --------------------------------------------
    @property
    def _sentinel_pos(self) -> int:
        """Masked rows write here: the last virtual position.  Contiguous:
        ``max_len - 1``.  Paged: ``n_max * block_size - 1`` — which equals
        ``max_len - 1`` when block_size divides max_len (the paged engine
        enforces that, so the two backends mask identically)."""
        if self.paged:
            return self.n_max * self.block_size - 1
        return self.max_len - 1

    def decode_inputs(self):
        """(tokens [S,1], offsets [S], active [S], req_ids [S], tok_idx [S]).

        ``offsets`` is each ACTIVE slot's current length (the position its
        pending token is written to and attends from); masked rows write to
        the sentinel position.  ``tok_idx`` is the per-request token index
        of the token being sampled THIS step (generated count), the second
        fold-in of the RNG discipline.
        """
        S = self.max_slots
        tokens = np.zeros((S, 1), np.int32)
        offsets = np.full((S,), self._sentinel_pos, np.int32)
        active = np.zeros((S,), bool)
        req_ids = np.zeros((S,), np.int32)
        tok_idx = np.zeros((S,), np.int32)
        for s in self.slots:
            if s.state != ACTIVE:
                continue
            tokens[s.index, 0] = s.pending_token
            offsets[s.index] = s.length
            active[s.index] = True
            req_ids[s.index] = s.req_id
            tok_idx[s.index] = s.generated
        return tokens, offsets, active, req_ids, tok_idx

    def rec_rows(self) -> np.ndarray:
        """[S] pooled recurrent-state rows for the batched decode step:
        ACTIVE slots address their own row, every other row the sentinel
        row 0 (whose gated write is a bit-exact no-op).  PREFILL slots'
        rows are deliberately NOT mapped — their state advances through
        the admission-prefill path only."""
        rows = np.zeros((self.max_slots,), np.int32)
        for s in self.slots:
            if s.state == ACTIVE:
                rows[s.index] = s.rec_row
        return rows

    def block_tables(self) -> np.ndarray:
        """[S, n_max] int32 physical-block tables, sentinel-padded.  Masked
        rows are all-sentinel, so their writes land in the garbage block."""
        if not self.paged:
            raise RuntimeError("block_tables() needs a paged SlotTable")
        tables = np.full((self.max_slots, self.n_max), SENTINEL, np.int32)
        for s in self.slots:
            if s.blocks:
                tables[s.index, :len(s.blocks)] = s.blocks
        return tables

    def block_table_row(self, slot: Slot) -> np.ndarray:
        """[1, n_max] table for one slot (the admission-prefill input)."""
        if not self.paged:
            raise RuntimeError("block_table_row() needs a paged SlotTable")
        row = np.full((1, self.n_max), SENTINEL, np.int32)
        row[0, :len(slot.blocks)] = slot.blocks
        return row
