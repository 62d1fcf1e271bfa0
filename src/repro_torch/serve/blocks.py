"""Host-side block allocator for the paged KV cache.

The contiguous backend reserves one ``max_len`` cache row per slot, so HBM
caps concurrency at ``pool_positions / max_len`` even when most requests
use a fraction of that.  Paged serving decouples the two: the device holds
one pooled tensor of ``num_blocks`` fixed-size blocks per cache leaf, and
each request maps its *virtual* positions onto physical blocks through a
block table.  This module is the host half of that design — pure Python
bookkeeping, no torch:

  * **free list** — physical blocks are allocated/freed in O(1); block 0 is
    reserved as the SENTINEL: masked decode rows and padded prefill writes
    land there, and block-table padding points at it, so garbage never
    touches a live block.
  * **refcounts + prefix sharing** — fully-written *prompt* blocks are
    published to a content index keyed by the token prefix they encode
    (the exact token tuple, so no hash-collision risk).  A new request
    whose prompt starts with the same tokens maps those positions onto the
    published blocks and only prefills the tail.  Published blocks whose
    last reference drops are RETAINED (moved to an evictable cached pool,
    FIFO-evicted only when the free list runs dry), so a later identical
    prompt still hits even after the original request finished.
  * **copy-on-write** — writes must only touch refcount-1 blocks.  When an
    engine needs to write into a shared block (e.g. the right-aligned tail
    chunk of a prefix-hit prompt re-writes the overlap), it forks the block
    first: ``cow`` hands back a private block id and the caller copies the
    device payload (``transformer.copy_block``) before writing.

The allocator never touches device memory — the engine owns the pooled
tensors and mirrors every decision here onto them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

# the reserved garbage block: the device-side scatter redirect
# (``models.layers.PAGED_SENTINEL``) and the host-side table padding MUST
# agree on the same id (the tests pin the two equal)
SENTINEL = 0


class NoFreeBlocks(RuntimeError):
    """The pool is exhausted — the engine preempts or defers admission."""


class BlockAllocator:
    """Refcounted fixed-size block pool with a prompt-prefix content index.

    Invariants (``assert_consistent`` checks them; the property suite in
    ``tests/test_serve_blocks.py`` hammers them under random op sequences):

      * every non-sentinel block is in exactly ONE of three states — on
        the free list, CACHED (published, refcount 0, evictable), or LIVE
        (refcount >= 1);
      * the prefix index only points at live or cached blocks, and each
        indexed block knows its own key (so eviction unpublishes exactly
        its entry); every cached block is indexed;
      * ``num_free + num_used == num_blocks - 1`` (the sentinel is
        pinned), where ``num_free`` counts allocatable blocks — truly
        free PLUS evictable cached.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the sentinel)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # pop() takes from the end: low ids first keeps tests readable
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._key_of: Dict[int, Tuple[int, ...]] = {}   # published blocks
        self._index: Dict[Tuple[int, ...], int] = {}    # key -> block
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # FIFO evict

    # -- capacity ---------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Usable blocks (sentinel excluded)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        """Allocatable blocks: truly free + evictable cached."""
        return len(self._free) + len(self._cached)

    @property
    def num_used(self) -> int:
        """Live (referenced) blocks."""
        return len(self._ref)

    @property
    def num_cached(self) -> int:
        """Published blocks kept alive for future prefix hits."""
        return len(self._cached)

    def blocks_for(self, n_positions: int) -> int:
        """Blocks needed to hold ``n_positions`` cache positions."""
        return -(-n_positions // self.block_size)

    # -- alloc / refcount -------------------------------------------------
    def _unpublish(self, block: int) -> None:
        key = self._key_of.pop(block, None)
        if key is not None and self._index.get(key) == block:
            del self._index[key]

    def alloc(self) -> int:
        """Hand out a fresh block: the free list first, then FIFO-evict
        from the cached pool (evicted content is unpublished before the
        block is reused)."""
        if self._free:
            blk = self._free.pop()
        elif self._cached:
            blk, _ = self._cached.popitem(last=False)   # oldest first
            self._unpublish(blk)
        else:
            raise NoFreeBlocks(f"all {self.capacity} KV blocks in use")
        self._ref[blk] = 1
        return blk

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def incref(self, block: int) -> None:
        if block not in self._ref:
            raise RuntimeError(f"incref on unallocated block {block}")
        self._ref[block] += 1

    def decref(self, block: int) -> bool:
        """Drop one reference; returns True when the block left the live
        set.  Published blocks are RETAINED in the evictable cached pool
        (still indexed — a later identical prompt revives them); private
        blocks go straight back to the free list."""
        if block not in self._ref:
            raise RuntimeError(f"double free of block {block}")
        self._ref[block] -= 1
        if self._ref[block] > 0:
            return False
        del self._ref[block]
        if block in self._key_of:
            self._cached[block] = None
        else:
            self._free.append(block)
        return True

    def free_blocks(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            self.decref(b)

    def fork(self, blocks: Sequence[int]) -> List[int]:
        """Share an existing table: one new reference per block."""
        for b in blocks:
            self.incref(b)
        return list(blocks)

    def cow(self, block: int) -> Tuple[int, bool]:
        """Make ``block`` writable.  refcount 1 → (block, False); shared →
        allocate a private block, drop one reference on the original, and
        return (new_block, True) — the CALLER must copy the device payload
        before writing (``transformer.copy_block``)."""
        if self.refcount(block) < 1:
            raise RuntimeError(f"cow of unallocated block {block}")
        if self._ref[block] == 1:
            return block, False
        new = self.alloc()              # may raise NoFreeBlocks: state intact
        self.decref(block)
        return new, True

    # -- prompt-prefix content index --------------------------------------
    def prefix_keys(self, prompt: Sequence[int]):
        """Content key per FULL prompt block: the exact token prefix the
        block completes.  Exact tuples, not hashes — a collision would
        silently serve the wrong prefix."""
        bs = self.block_size
        return [tuple(prompt[:(i + 1) * bs])
                for i in range(len(prompt) // bs)]

    def publish(self, block: int, key: Tuple[int, ...]) -> bool:
        """Register a fully-written prompt block under its content key.
        First writer wins: a key that is already indexed (a concurrent
        identical prompt) is left alone.  Returns True when published."""
        if block not in self._ref:
            raise RuntimeError(f"publish of unallocated block {block}")
        if key in self._index or block in self._key_of:
            return False
        self._index[key] = block
        self._key_of[block] = key
        return True

    def match_prefix(self, prompt: Sequence[int]) -> List[int]:
        """Longest run of published blocks matching the prompt's full
        blocks.  Matched blocks come back INCREF'D — the caller owns the
        references (free_blocks to abandon them).  Cached (refcount-0)
        blocks are revived out of the evictable pool."""
        out: List[int] = []
        for key in self.prefix_keys(prompt):
            blk = self._index.get(key)
            if blk is None:
                break
            if blk in self._cached:     # revive: content is still intact
                del self._cached[blk]
                self._ref[blk] = 1
            else:
                self.incref(blk)
            out.append(blk)
        return out

    # -- invariants -------------------------------------------------------
    def assert_consistent(self) -> None:
        free = set(self._free)
        live = set(self._ref)
        cached = set(self._cached)
        assert SENTINEL not in free | live | cached
        assert not (free & live) and not (free & cached) \
            and not (live & cached), "block in two states"
        assert len(free) + len(live) + len(cached) == self.capacity
        assert all(c >= 1 for c in self._ref.values())
        for key, blk in self._index.items():
            assert blk in live or blk in cached, \
                f"index points at freed block {blk}"
            assert self._key_of.get(blk) == key
        for blk in self._key_of:
            assert blk in live or blk in cached
        for blk in cached:
            assert blk in self._key_of, f"cached block {blk} unpublished"

    def __repr__(self) -> str:
        return (f"BlockAllocator(blocks={self.num_blocks}, "
                f"bs={self.block_size}, free={len(self._free)}, "
                f"cached={self.num_cached}, used={self.num_used}, "
                f"published={len(self._index)})")
