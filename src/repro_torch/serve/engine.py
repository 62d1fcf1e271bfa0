"""Continuous-batching serve engine over the paged KV cache (port of
``repro/serve/engine.py``, paged path).

A fixed pool of ``max_slots`` decode slots runs over one pooled KV cache;
a queued request is admitted the moment EOS or its budget frees a slot and
the block pool can hold its prompt:

  * **fixed-shape decode**: every decode step is one call over the full
    [S] slot batch with per-slot offsets; inactive rows carry an
    all-sentinel block table and the sentinel offset, so their writes land
    in the garbage block 0 and their outputs are dropped;
  * **chunked admission prefill**: prompts stream through
    [1, prefill_chunk] calls (``transformer.prefill_chunk``) interleaved
    between decode steps;
  * **paged KV**: admission is free-BLOCK driven, identical prompt
    prefixes share refcounted blocks (copy-on-write before a shared block
    is rewritten), and when the pool runs dry mid-decode the YOUNGEST
    request is preempted and requeued;
  * **sampling**: greedy is ``argmax``; with ``temperature > 0`` token t of
    request r is a Gumbel-max draw from a generator seeded by
    ``(seed, r, t)`` alone, so outputs do not depend on slot, admission
    order, pool size or preemption (the reference's ``fold_in`` discipline;
    the bits differ from JAX's).

Where the attention of a decode step runs follows ``paged_kernel``:
"auto" routes it through ``kernels.paged_attention`` (the CUDA kernels when
the cache lives on CUDA: GQA for attention layers, absorbed MLA for MLA
layers; their plain versions on the CPU); "ref" forces the reference's
gather-then-attend lowering.  The engine's device is its
params' device.

The engine serves from the paged KV cache only.  Not ported yet: the
contiguous KV backend (no config field selects it; the CLI's
``--slot-state contiguous`` raises), recurrent/hybrid state rows, mesh
sharding and ``serve_waves`` (``NotImplementedError``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T

from .blocks import BlockAllocator, NoFreeBlocks
from .metrics import ServeMetrics
from .queue import Request, RequestQueue
from .slot_state import StatePlan
from .slots import ACTIVE, PREFILL, SlotTable


@dataclass(frozen=True)
class EngineConfig:
    """Engine knobs (everything the serve CLI exposes lands here)."""

    max_slots: int = 8
    max_len: int = 256           # cache positions per request (prompt + gen)
    prefill_chunk: int = 16      # admission prefill chunk length
    chunks_per_step: int = 1     # prefill chunks interleaved per decode step
    temperature: float = 0.0
    eos_id: Optional[int] = None
    seed: int = 0
    block_size: int = 16         # paged: positions per physical block
    kv_blocks: int = 0           # paged: pool size (0 = match contiguous
                                 # capacity: 1 + max_slots * max_len / bs)
    paged_kernel: str = "auto"   # "auto" (kernels.paged_attention: CUDA
                                 # kernel on a CUDA cache, plain version on
                                 # the CPU) | "ref" (gather-then-attend)
    clock: str = "step"          # "step" (virtual, deterministic) | "wall"
    step_s: float = 0.01         # virtual seconds per engine step


def _check_arch(cfg: ArchConfig) -> None:
    if cfg.frontend:
        raise ValueError(
            f"{cfg.name}: frontend architectures are not servable "
            "(requests are token-only)")


def _draw_seed(seed: int, req_id: int, tok_idx: int) -> int:
    """A 63-bit generator seed that depends on (seed, req_id, tok_idx)
    only — the counter the sampler is keyed on."""
    words = np.random.SeedSequence([seed, req_id, tok_idx]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def _make_sampler(seed: int, temperature: float):
    """logits [N,V], req_ids [N], tok_idx [N] → N host ints."""

    def sample(logits, req_ids, tok_idx) -> List[int]:
        if temperature <= 0:
            return torch.argmax(logits, dim=-1).tolist()
        out = []
        for row, r, t in zip(logits, req_ids, tok_idx):
            gen = torch.Generator(device=row.device)
            gen.manual_seed(_draw_seed(seed, int(r), int(t)))
            u = torch.rand(row.shape, generator=gen, device=row.device,
                           dtype=torch.float32)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            out.append(int(torch.argmax(row.float() / temperature + gumbel)))
        return out

    return sample


class ServeEngine:
    """Fixed slot pool + paged KV backend + arrival queue."""

    def __init__(self, cfg: ArchConfig, params, ecfg: EngineConfig,
                 mesh=None):
        _check_arch(cfg)
        self.cfg = cfg
        self.ecfg = ecfg
        if mesh is not None:
            raise NotImplementedError(
                "mesh sharding is not ported: one card is one device "
                "(torch.distributed comes in a later slice)")
        if ecfg.chunks_per_step < 1:
            raise ValueError("chunks_per_step must be >= 1")
        if ecfg.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if ecfg.paged_kernel not in ("auto", "ref"):
            raise ValueError(f"unknown paged_kernel {ecfg.paged_kernel!r}")
        if ecfg.clock not in ("step", "wall"):
            raise ValueError(f"unknown clock {ecfg.clock!r}")
        self.plan = StatePlan.resolve(cfg, "paged")
        if self.plan.has_recurrent:
            raise NotImplementedError(
                "recurrent / hybrid state rows are not ported yet "
                "(a later slice of the port)")
        self.paged_kernel = ecfg.paged_kernel
        self._chunk = min(ecfg.prefill_chunk, ecfg.max_len)

        bs = ecfg.block_size
        if ecfg.max_len % bs:
            raise ValueError(
                f"paged mode needs max_len ({ecfg.max_len}) divisible "
                f"by block_size ({bs}): the gathered virtual KV view "
                "must match the contiguous row shape bit-for-bit")
        nblocks = ecfg.kv_blocks or (1 + ecfg.max_slots * (ecfg.max_len // bs))
        self.allocator = BlockAllocator(nblocks, bs)
        self.table = SlotTable(ecfg.max_slots, ecfg.max_len, block_size=bs)

        self.queue = RequestQueue()
        self.metrics = ServeMetrics(max_slots=ecfg.max_slots,
                                    clock=ecfg.clock, step_s=ecfg.step_s)
        self.results: Dict[int, List[int]] = {}

        self.params = params
        self.device = params["embed"].device
        self.cache = T.init_paged_cache(cfg, self.allocator.num_blocks, bs,
                                        device=self.device)
        self._sample = _make_sampler(ecfg.seed, ecfg.temperature)

    def _put(self, x: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # -- request intake ---------------------------------------------------
    def submit(self, requests) -> None:
        if isinstance(requests, Request):
            requests = [requests]
        # validate the WHOLE batch before recording anything
        for r in requests:
            need = len(r.prompt) + r.max_new_tokens
            if need > self.ecfg.max_len:
                raise ValueError(
                    f"request {r.req_id}: prompt+gen {need} exceeds "
                    f"max_len {self.ecfg.max_len}")
            # the last decode write lands at position prompt+gen-2, so a
            # lone request must fit the pool or it would preempt itself
            worst = (len(r.prompt) + r.max_new_tokens - 2) \
                // self.allocator.block_size + 1
            if worst > self.allocator.capacity:
                raise ValueError(
                    f"request {r.req_id}: worst case {worst} blocks "
                    f"exceeds the pool ({self.allocator.capacity} "
                    "usable blocks)")
        for r in requests:
            self.metrics.on_submit(r.req_id, r.arrival_s, len(r.prompt))
        self.queue.submit(requests)

    # -- block plumbing ---------------------------------------------------
    def _record_blocks(self) -> None:
        self.metrics.on_blocks(self.allocator.num_used,
                               self.allocator.capacity)

    def _free_resources(self, slot) -> None:
        if slot.blocks:
            self.allocator.free_blocks(slot.blocks)
            slot.blocks = []
            self._record_blocks()

    def _preempt(self, victim) -> None:
        """Free the victim's blocks and send its request back to the
        queue; its tokens regenerate exactly on re-serve."""
        req = victim.request
        self._free_resources(victim)
        self.table.release(victim)
        self.metrics.on_preempt(req.req_id)
        self.queue.submit(req)

    def _make_room(self, slot) -> bool:
        """The pool is dry: preempt the youngest busy request.  Returns
        False when the victim was ``slot`` itself."""
        victim = self.table.youngest_busy()
        if victim is slot and len(self.table.busy()) == 1:
            raise RuntimeError("KV pool too small for the only live request")
        self._preempt(victim)
        return victim is not slot

    def _alloc_block(self, slot) -> Optional[int]:
        while True:
            try:
                return self.allocator.alloc()
            except NoFreeBlocks:
                if not self._make_room(slot):
                    return None

    def _ensure_writable(self, slot, block_idx: int,
                         need_copy: bool = True) -> bool:
        """Copy-on-write ``slot.blocks[block_idx]`` before a write; False if
        ``slot`` was preempted while making room for the copy."""
        while True:
            blk = slot.blocks[block_idx]
            try:
                new, copied = self.allocator.cow(blk)
            except NoFreeBlocks:
                if not self._make_room(slot):
                    return False
                continue
            if copied:
                if need_copy:
                    self.cache = T.copy_block(self.cache, blk, new)
                slot.blocks[block_idx] = new
            return True

    def _ensure_writable_range(self, slot, lo: int, hi: int) -> bool:
        bs = self.allocator.block_size
        for bi in range(lo // bs, min(-(-hi // bs), len(slot.blocks))):
            full = lo <= bi * bs and (bi + 1) * bs <= hi
            if not self._ensure_writable(slot, bi, need_copy=not full):
                return False
        return True

    def _try_admit_paged(self, slot, req) -> bool:
        """Map the request's prompt onto blocks (prefix hits shared, tail
        fresh); False when the free list cannot cover the tail."""
        alloc = self.allocator
        bs = alloc.block_size
        plen = len(req.prompt)
        matched = alloc.match_prefix(req.prompt)
        fresh_needed = alloc.blocks_for(plen) - len(matched)
        if fresh_needed > alloc.num_free:
            alloc.free_blocks(matched)
            return False
        # restart on the chunk grid so every chunk writes the same bits as
        # a from-scratch prefill; capped so the final chunk still yields
        # the first token's logits
        C = self._chunk
        pos0 = min((len(matched) * bs // C) * C, ((plen - 1) // C) * C)
        self.table.assign(slot, req)
        slot.blocks = matched + [alloc.alloc() for _ in range(fresh_needed)]
        slot.prefill_pos = pos0
        self.metrics.on_admit(req.req_id)
        self.metrics.on_prefix_lookup(pos0, plen)
        self._record_blocks()
        return True

    # -- engine phases (one call each per step) ---------------------------
    def _admit_ready(self, now_s: float) -> None:
        for slot in self.table.free():
            req = self.queue.pop_ready(now_s)
            if req is None:
                return
            if not self._try_admit_paged(slot, req):
                # requeue and keep FIFO order: admit nobody behind it
                self.queue.submit(req)
                return

    def _finish(self, slot) -> None:
        req = slot.request
        self.results[req.req_id] = list(slot.output)
        self._free_resources(slot)
        self.table.release(slot)
        self.metrics.on_finish(req.req_id)

    def _complete_if_done(self, slot, token: int) -> bool:
        eos = self.ecfg.eos_id
        if (eos is not None and token == eos) \
                or slot.generated >= slot.request.max_new_tokens:
            self._finish(slot)
            return True
        return False

    def _prefill_tick(self) -> None:
        """Advance up to ``chunks_per_step`` admission prefills one chunk:
        short prompts pad at the END, interior chunks are full, a ragged
        tail chunk is RIGHT-ALIGNED at ``plen - chunk`` (rewriting the
        overlap with identical k/v); a tail that dips into shared blocks
        copy-on-writes them first."""
        C = self._chunk
        budget = self.ecfg.chunks_per_step
        for slot in self.table.prefilling():
            if budget <= 0:
                return
            if slot.state != PREFILL:   # preempted earlier this tick
                continue
            prompt = np.asarray(slot.request.prompt, np.int64)
            plen = len(prompt)
            remaining = plen - slot.prefill_pos
            chunk = np.zeros((1, C), np.int64)
            if plen <= C:                       # whole prompt, end-padded
                start, last_row = 0, plen - 1
                chunk[0, :plen] = prompt
            elif remaining > C:                 # full interior chunk
                start, last_row = slot.prefill_pos, C - 1
                chunk[0] = prompt[start:start + C]
            else:                               # right-aligned tail chunk
                start, last_row = plen - C, C - 1
                chunk[0] = prompt[start:plen]
            final = remaining <= C
            if not self._ensure_writable_range(slot, start, start + C):
                continue                        # preempted mid-COW
            table = self._put(self.table.block_table_row(slot))
            logits, self.cache = T.prefill_chunk(
                self.params, self.cfg, self._put(chunk), self.cache, start,
                with_logits=final, block_tables=table)
            slot.prefill_pos += min(remaining, C)
            slot.length = slot.prefill_pos
            self.metrics.on_prefill_chunk(min(remaining, C))
            budget -= 1
            if slot.prefill_pos >= plen:
                # prompt cached: token 0 from the REAL last prompt position
                tok = self._sample(logits[:, last_row], [slot.req_id], [0])[0]
                self.table.activate(slot, tok)
                # publish the full prompt blocks (first writer wins)
                keys = self.allocator.prefix_keys(slot.request.prompt)
                for i, key in enumerate(keys):
                    self.allocator.publish(slot.blocks[i], key)
                self.metrics.on_first_token(slot.req_id)
                self._complete_if_done(slot, tok)

    def _grow_decode_blocks(self) -> None:
        """Every ACTIVE slot writes its pending token at position
        ``length`` this step: allocate the covering block when the write
        crosses into a new one, preempting the youngest request while the
        pool is dry (oldest slots grow first)."""
        bs = self.allocator.block_size
        for slot in sorted(self.table.active(), key=lambda s: s.admit_seq):
            if slot.state != ACTIVE:    # preempted by an earlier growth
                continue
            while slot.state == ACTIVE and slot.length // bs == \
                    len(slot.blocks):
                blk = self._alloc_block(slot)
                if blk is None:         # slot itself was the victim
                    break
                slot.blocks.append(blk)
        self._record_blocks()

    def _decode_tick(self) -> None:
        self._grow_decode_blocks()
        if self.table.n_active == 0:
            return
        tokens, offsets, active, req_ids, tok_idx = self.table.decode_inputs()
        logits, self.cache = T.decode_step(
            self.params, self.cfg, self._put(tokens, torch.int64), self.cache,
            self._put(offsets), block_tables=self._put(
                self.table.block_tables()),
            paged_kernel=self.paged_kernel)
        rows = np.flatnonzero(active)
        toks = dict(zip(rows.tolist(), self._sample(
            logits[self._put(rows), 0], req_ids[rows], tok_idx[rows])))
        self.metrics.on_decode_step(int(active.sum()))
        for slot in self.table.active():
            tok = toks[slot.index]
            slot.length += 1          # pending token was cached this step
            slot.pending_token = tok
            slot.generated += 1
            slot.output.append(tok)
            self.metrics.on_token(slot.req_id)
            self._complete_if_done(slot, tok)

    def step(self) -> None:
        """One engine iteration: admissions, a prefill tick, a decode step,
        and a clock tick."""
        self._admit_ready(self.metrics.now())
        self._prefill_tick()
        self._decode_tick()
        self.metrics.on_queue_depth(len(self.queue))
        self.metrics.tick()

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> Dict[int, List[int]]:
        """Serve until the queue and every slot drain; returns outputs."""
        if requests:
            self.submit(list(requests))
        self.metrics.start()
        with torch.inference_mode():
            while len(self.queue) or self.table.busy():
                if not self.table.busy():
                    nxt = self.queue.next_arrival()
                    if nxt is not None:
                        self.metrics.wait_until(nxt)
                self.step()
        self.metrics.stop()
        return self.results


def serve_waves(*args, **kwargs):
    raise NotImplementedError(
        "serve_waves (the wave-at-a-time oracle) is not ported yet; the "
        "port's engine is held to the reference's paged engine instead")
