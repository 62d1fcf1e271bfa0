"""SlotState protocol: per-layer decode-state backends for the engine.

One serving engine, one state protocol, three backends — the per-layer
analogue of the paper's one-sync-protocol-across-heterogeneous-units
lesson.  Each layer of an architecture carries decode state with one of
three shapes, and the engine composes whichever subset the config needs:

  * ``contiguous`` KV — one ``max_len`` cache row per slot (the slot index
    IS the cache batch row).  Resource: the slot itself; admission is
    free-slot driven, nothing can run out mid-decode.
  * ``paged`` KV — pooled ``num_blocks`` × ``block_size`` leaves addressed
    through per-slot block tables.  Resource: free blocks (admission gated
    on the prompt's block count, growth per decode step, preemption when
    the pool runs dry).  Host bookkeeping lives in ``blocks.BlockAllocator``.
  * ``recurrent`` rows — O(1) per-request state (mamba / xLSTM) in a
    pooled ``[rows + 1, ...]`` leaf; row 0 is the sentinel row masked
    decode slots address (and gate off), rows 1..R serve live requests.
    Resource: free rows, fixed at admission — recurrent state NEVER grows,
    so it can gate admission but never triggers mid-decode preemption.

``StatePlan.resolve`` maps an ArchConfig onto backends per layer: attention
and MLA layers follow the engine's KV mode, recurrent layers always take
the recurrent backend.  Hybrid stacks (Jamba) therefore mix paged-KV and
recurrent backends inside one model, and admission becomes a TWO-resource
budget: a request needs a free recurrent row AND enough free KV blocks
before either is committed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

from repro_torch.models.transformer import ATTN_KINDS, MLA_KINDS, REC_KINDS

# Recurrent-state row 0 is never allocated: masked decode rows gather and
# rewrite it (gated, so the write is a no-op bit-for-bit) the same way
# masked KV rows write to the causally-hidden sentinel position.
REC_SENTINEL = 0


class NoFreeRows(RuntimeError):
    """The recurrent-row pool is exhausted (admission must defer)."""


@dataclass(frozen=True)
class StatePlan:
    """Resolved per-layer backend selection for one engine instance.

    ``backends`` lists one entry per layer in segment order:
    "contiguous" | "paged" | "recurrent".
    """

    backends: Tuple[str, ...]
    kv_mode: Optional[str]        # backend of the KV layers (None if none)
    has_recurrent: bool
    has_kv: bool

    @staticmethod
    def resolve(cfg, kv_mode: str) -> "StatePlan":
        if kv_mode not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_mode {kv_mode!r}")
        backends: List[str] = []
        for unit, reps in cfg.segments():
            for kind in unit * reps:
                if kind in REC_KINDS:
                    backends.append("recurrent")
                elif kind in ATTN_KINDS or kind in MLA_KINDS:
                    backends.append(kv_mode)
                else:
                    raise ValueError(
                        f"{cfg.name}: no SlotState backend for layer kind "
                        f"{kind!r}")
        has_rec = "recurrent" in backends
        has_kv = any(b != "recurrent" for b in backends)
        return StatePlan(backends=tuple(backends),
                         kv_mode=kv_mode if has_kv else None,
                         has_recurrent=has_rec, has_kv=has_kv)

    def describe(self) -> str:
        """Human-readable layer census, e.g. ``24×paged + 8×recurrent``."""
        counts = {}
        for b in self.backends:
            counts[b] = counts.get(b, 0) + 1
        return " + ".join(f"{n}×{b}" for b, n in sorted(counts.items()))


class RecurrentRows:
    """Host-side allocator for pooled recurrent-state rows.

    Mirrors ``BlockAllocator``'s contract at its natural size: no refcounts
    (recurrent state is position-free, so there is nothing to share — a
    prefix-cache hit would SKIP the state computation and serve from a
    stale recurrence), no growth, no copy-on-write.  One row per live
    request, allocated at admission, freed at completion or preemption.
    """

    def __init__(self, rows: int):
        if rows < 1:
            raise ValueError("need at least one recurrent row")
        self.capacity = rows
        # pop() from the end → row 1 first: allocation order is
        # deterministic, and row 0 (the sentinel) is never handed out
        self._free: List[int] = list(range(rows, 0, -1))
        self._live: Set[int] = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return len(self._live)

    def alloc(self) -> int:
        if not self._free:
            raise NoFreeRows(
                f"all {self.capacity} recurrent rows are live")
        row = self._free.pop()
        self._live.add(row)
        return row

    def free(self, row: int) -> None:
        if row not in self._live:
            raise ValueError(f"row {row} is not live")
        self._live.remove(row)
        self._free.append(row)

    def assert_consistent(self) -> None:
        assert len(self._free) + len(self._live) == self.capacity
        assert not (set(self._free) & self._live)
        assert REC_SENTINEL not in self._live
        assert REC_SENTINEL not in self._free
