"""Continuous-batching serve engine over the SlotState protocol (port of
``repro/serve/engine.py``): per-layer decode-state backends (contiguous
KV, paged KV, recurrent rows) composed from the architecture config.

A fixed pool of ``max_slots`` decode slots runs over one shared cache and
a queued request is admitted the moment EOS or its budget frees a slot
and every backend it needs has room:

  * **fixed-shape decode**: every decode step is one call over the full
    [S] slot batch with per-slot offsets; inactive rows write to the
    cache's sentinel position (contiguous: the row's last position, paged:
    the garbage block 0), gate their recurrent advance off on the
    sentinel row 0, and their outputs are dropped;
  * **chunked admission prefill**: prompts stream through
    [1, prefill_chunk] calls (``transformer.prefill_chunk``) interleaved
    between decode steps;
  * **sampling**: greedy is ``argmax``; with ``temperature > 0`` token t of
    request r is a Gumbel-max draw from a generator seeded by
    ``(seed, r, t)`` alone, so outputs do not depend on slot, admission
    order, pool size, state backend or preemption (the reference's
    ``fold_in`` discipline; the bits differ from JAX's).

Per-layer state backends (``serve.slot_state.StatePlan``): attention / MLA
layers follow the engine's KV mode, recurrent layers (mamba / xLSTM)
always take the recurrent-row backend, so hybrid stacks (Jamba) mix both
in one run:

  * ``contiguous`` KV (the default, as the reference's): one ``max_len``
    cache row per slot; admission is free-slot driven.  Decode attends
    over the whole row with the model's own torch code (the reference runs
    it outside any Pallas kernel), so no paged-attention kernel launches.
  * ``paged`` KV: one pooled tensor of ``kv_blocks`` x ``block_size``
    positions per leaf, addressed by block tables; admission is free-BLOCK
    driven, identical prompt prefixes share refcounted blocks
    (copy-on-write before a shared block is rewritten), and when the pool
    runs dry mid-decode the YOUNGEST request is preempted and requeued.
  * ``recurrent`` rows: O(1) per-request state in a pooled
    ``[rec_slots + 1, ...]`` leaf (row 0 = sentinel).  Admission takes one
    row, a SECOND resource beside KV blocks: both must be free before
    either commits.  Prefill chunks stay on the aligned ``[k·C, (k+1)·C)``
    grid with the padded tail gated off by a validity mask, so the state
    advances over every prompt token exactly once.  Prefix sharing is off
    for recurrent-bearing archs: a hit would skip the recurrence.

Where the attention of a paged decode step runs follows ``paged_kernel``:
"auto" routes it through ``kernels.paged_attention`` (the CUDA kernels when
the cache lives on CUDA: GQA for attention layers, absorbed MLA for MLA
layers; their plain versions on the CPU); "ref" forces the reference's
gather-then-attend lowering.  The engine's device is its params' device.

``serve_waves`` is the wave-at-a-time loop kept as the TEST ORACLE: it
batch-prefills whole prompts over the contiguous cache with no chunking,
no masking and no slot reuse, so any engine output can be checked against
it token for token.  Not ported: mesh sharding (one card is one device).
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
from .slot_state import RecurrentRows, StatePlan
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
    kv_mode: str = "contiguous"  # "contiguous" | "paged"
    slot_state: str = "auto"     # "auto" (follow kv_mode) | "contiguous" |
                                 # "paged" — KV-layer backend override;
                                 # recurrent layers always take the
                                 # recurrent-row backend
    rec_slots: int = 0           # recurrent rows (0 = match max_slots);
                                 # < max_slots makes rows the scarce
                                 # admission resource
    block_size: int = 16         # paged: positions per physical block
    kv_blocks: int = 0           # paged: pool size (0 = match contiguous
                                 # capacity: 1 + max_slots * max_len / bs)
    paged_kernel: str = "auto"   # paged decode: "auto"
                                 # (kernels.paged_attention: CUDA kernel on
                                 # a CUDA cache, plain version on the CPU)
                                 # | "ref" (gather-then-attend)
    clock: str = "step"          # "step" (virtual, deterministic) | "wall"
    step_s: float = 0.01         # virtual seconds per engine step


def _check_arch(cfg: ArchConfig) -> None:
    """Every token-only architecture serves: attention/MLA layers through a
    KV backend, recurrent layers through pooled state rows, hybrids
    through both.  Frontend archs are refused (requests are token-only)."""
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
    """Fixed slot pool + per-layer SlotState backends + arrival queue."""

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
        if ecfg.kv_mode not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_mode {ecfg.kv_mode!r}")
        if ecfg.slot_state not in ("auto", "contiguous", "paged"):
            raise ValueError(f"unknown slot_state {ecfg.slot_state!r}")
        if ecfg.paged_kernel not in ("auto", "ref"):
            raise ValueError(f"unknown paged_kernel {ecfg.paged_kernel!r}")
        if ecfg.clock not in ("step", "wall"):
            raise ValueError(f"unknown clock {ecfg.clock!r}")
        if ecfg.rec_slots < 0:
            raise ValueError("rec_slots must be >= 0")
        kv_mode = (ecfg.kv_mode if ecfg.slot_state == "auto"
                   else ecfg.slot_state)
        self.plan = StatePlan.resolve(cfg, kv_mode)
        self.has_rec = self.plan.has_recurrent
        self.has_kv = self.plan.has_kv
        # "paged" only means something when there are positional leaves to
        # page: a pure-recurrent arch ignores the KV mode
        self.paged = self.has_kv and kv_mode == "paged"
        self.paged_kernel = ecfg.paged_kernel
        # a padded chunk must fit the cache row
        self._chunk = min(ecfg.prefill_chunk, ecfg.max_len)

        if self.paged:
            bs = ecfg.block_size
            if ecfg.max_len % bs:
                raise ValueError(
                    f"paged mode needs max_len ({ecfg.max_len}) divisible "
                    f"by block_size ({bs}): the gathered virtual KV view "
                    "must match the contiguous row shape bit-for-bit")
            nblocks = ecfg.kv_blocks or (
                1 + ecfg.max_slots * (ecfg.max_len // bs))
            self.allocator: Optional[BlockAllocator] = \
                BlockAllocator(nblocks, bs)
            self.table = SlotTable(ecfg.max_slots, ecfg.max_len,
                                   block_size=bs)
        else:
            self.allocator = None
            self.table = SlotTable(ecfg.max_slots, ecfg.max_len)

        # the second admission resource: one pooled state row per live
        # request on recurrent-bearing archs
        self.rec: Optional[RecurrentRows] = None
        if self.has_rec:
            self.rec = RecurrentRows(ecfg.rec_slots or ecfg.max_slots)

        self.queue = RequestQueue()
        self.metrics = ServeMetrics(max_slots=ecfg.max_slots,
                                    clock=ecfg.clock, step_s=ecfg.step_s)
        self.results: Dict[int, List[int]] = {}
        self._admission_hold = 0     # steps left with admission stalled

        self.params = params
        self.device = params["embed"].device
        if self.has_rec:
            # KV leaves sized by the KV backend's geometry, recurrent leaves
            # by the row pool (+ sentinel row 0)
            if self.paged:
                kv_batch, kv_len = self.allocator.num_blocks, ecfg.block_size
            else:
                kv_batch, kv_len = ecfg.max_slots, ecfg.max_len
            self.cache = T.init_hybrid_cache(
                cfg, kv_batch=kv_batch, kv_len=kv_len,
                rec_batch=self.rec.capacity + 1, device=self.device)
        elif self.paged:
            self.cache = T.init_paged_cache(cfg, self.allocator.num_blocks,
                                            ecfg.block_size,
                                            device=self.device)
        else:
            self.cache = T.init_cache(cfg, ecfg.max_slots, ecfg.max_len,
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
            if self.paged:
                # the last decode write lands at position prompt+gen-2, so
                # a lone request must fit the pool or it would preempt
                # itself
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
        """Hand every backend resource the slot holds back to its pool."""
        if self.allocator is not None and slot.blocks:
            self.allocator.free_blocks(slot.blocks)
            slot.blocks = []
            self._record_blocks()
        if self.rec is not None and slot.rec_row:
            self.rec.free(slot.rec_row)
            slot.rec_row = 0

    def _preempt(self, victim) -> None:
        """Free the victim's resources (blocks AND recurrent row) and send
        its request back to the queue; its tokens regenerate exactly on
        re-serve (the wasted decode tokens are booked by the metrics)."""
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
        fresh); False when the free list cannot cover the tail.
        Recurrent-bearing archs skip prefix matching: a hit would skip the
        prompt positions the recurrent state must advance over."""
        alloc = self.allocator
        bs = alloc.block_size
        plen = len(req.prompt)
        matched = [] if self.has_rec else alloc.match_prefix(req.prompt)
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
        if not self.has_rec:
            self.metrics.on_prefix_lookup(pos0, plen)
        self._record_blocks()
        return True

    # -- engine phases (one call each per step) ---------------------------
    def _admit_ready(self, now_s: float) -> None:
        for slot in self.table.free():
            req = self.queue.pop_ready(now_s)
            if req is None:
                return
            # TWO-RESOURCE admission: every backend must have room before
            # either commits (nothing to unwind on failure); FIFO order is
            # kept by requeueing and admitting nobody behind the request
            if self.rec is not None and self.rec.num_free == 0:
                self.queue.submit(req)
                return
            if self.paged:
                if not self._try_admit_paged(slot, req):
                    self.queue.submit(req)
                    return
            else:
                self.table.assign(slot, req)
                self.metrics.on_admit(req.req_id)
            if self.rec is not None:
                slot.rec_row = self.rec.alloc()
            # a reused contiguous slot row and/or recurrent row starts
            # zeroed (fresh paged blocks are written before they are read)
            if self.rec is not None or not self.paged:
                self.cache = T.reset_slot_state(
                    self.cfg, self.cache,
                    slot=slot.index if self.has_kv and not self.paged
                    else None,
                    rec_row=slot.rec_row if self.rec is not None else None)

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
        """Advance up to ``chunks_per_step`` admission prefills one chunk.

        KV-only archs: short prompts pad at the END, interior chunks are
        full, a ragged tail chunk is RIGHT-ALIGNED at ``plen - chunk``
        (rewriting the overlap with identical k/v).  Recurrent-bearing
        archs keep every chunk on the ALIGNED ``[k·C, (k+1)·C)`` grid with
        the final chunk end-padded and gated off by ``valid``: re-running
        an overlap would advance the recurrence twice.  Contiguous KV
        prefills a view of the slot's row; paged KV starts at the
        prefix-cache hit and copy-on-writes shared blocks the tail dips
        into."""
        C = self._chunk
        budget = self.ecfg.chunks_per_step
        contig_kv = self.has_kv and not self.paged
        for slot in self.table.prefilling():
            if budget <= 0:
                return
            if slot.state != PREFILL:   # preempted earlier this tick
                continue
            prompt = np.asarray(slot.request.prompt, np.int64)
            plen = len(prompt)
            remaining = plen - slot.prefill_pos
            chunk = np.zeros((1, C), np.int64)
            valid = None
            if self.has_rec:                    # aligned grid, masked tail
                start = slot.prefill_pos
                n = min(C, remaining)
                last_row = n - 1
                chunk[0, :n] = prompt[start:start + n]
                valid = n
            elif plen <= C:                     # whole prompt, end-padded
                start, last_row = 0, plen - 1
                chunk[0, :plen] = prompt
            elif remaining > C:                 # full interior chunk
                start, last_row = slot.prefill_pos, C - 1
                chunk[0] = prompt[start:start + C]
            else:                               # right-aligned tail chunk
                start, last_row = plen - C, C - 1
                chunk[0] = prompt[start:plen]
            final = remaining <= C
            table = None
            if self.paged:
                if not self._ensure_writable_range(slot, start, start + C):
                    continue                    # preempted mid-COW
                table = self._put(self.table.block_table_row(slot))
            rec_row = (None if self.rec is None else
                       self._put(np.asarray([slot.rec_row]), torch.int64))
            sub = (T.take_state(self.cfg, self.cache, slot.index)
                   if contig_kv else self.cache)
            logits, sub = T.prefill_chunk(
                self.params, self.cfg, self._put(chunk), sub, start,
                with_logits=final, block_tables=table, rec_rows=rec_row,
                valid=valid)
            self.cache = (T.write_state(self.cfg, self.cache, sub,
                                        slot.index) if contig_kv else sub)
            slot.prefill_pos += min(remaining, C)
            slot.length = slot.prefill_pos
            self.metrics.on_prefill_chunk(min(remaining, C))
            budget -= 1
            if slot.prefill_pos >= plen:
                # prompt cached: token 0 from the REAL last prompt position
                tok = self._sample(logits[:, last_row], [slot.req_id], [0])[0]
                self.table.activate(slot, tok)
                if self.paged and not self.has_rec:
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
        if self.paged:
            self._grow_decode_blocks()
        if self.table.n_active == 0:
            return
        tokens, offsets, active, req_ids, tok_idx = self.table.decode_inputs()
        bt = rows = act = None
        if self.paged:
            bt = self._put(self.table.block_tables())
        if self.rec is not None:
            rows = self._put(self.table.rec_rows(), torch.int64)
            act = self._put(active)
        logits, self.cache = T.decode_step(
            self.params, self.cfg, self._put(tokens, torch.int64), self.cache,
            self._put(offsets), block_tables=bt,
            paged_kernel=self.paged_kernel, rec_rows=rows, active=act)
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

    def hold_admission(self, steps: int) -> None:
        """Stall admission for the next ``steps`` engine steps (fault
        injection: a hung scheduler).  Live slots keep prefilling and
        decoding; only NEW admissions wait.  Overlapping holds extend, not
        stack."""
        if steps < 0:
            raise ValueError(f"hold steps must be >= 0, got {steps}")
        self._admission_hold = max(self._admission_hold, steps)

    @torch.inference_mode()
    def step(self) -> None:
        """One engine iteration: admissions, a prefill tick, a decode step,
        and a clock tick."""
        if self._admission_hold > 0:
            self._admission_hold -= 1
        else:
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


def serve_waves(cfg: ArchConfig, params, ecfg: EngineConfig,
                requests: Sequence[Request]):
    """Admit <= max_slots requests per wave; decode until the wave drains.

    The engine's TEST ORACLE: it batch-prefills whole prompts in one call
    over the contiguous cache (no chunking, no padding masks, no slot
    reuse, no paging), so its per-request outputs are what the continuous
    engine, every backend mix included, must match token for token (same
    sampling discipline).  Prompts within a wave must share one length.
    Returns (results, metrics)."""
    _check_arch(cfg)
    S, max_len = ecfg.max_slots, ecfg.max_len
    metrics = ServeMetrics(max_slots=S, clock=ecfg.clock, step_s=ecfg.step_s)
    results: Dict[int, List[int]] = {}
    sample = _make_sampler(ecfg.seed, ecfg.temperature)
    dev = params["embed"].device
    put = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int64,
                                    device=dev)

    reqs = sorted(requests, key=lambda r: (r.arrival_s, r.req_id))
    for r in reqs:
        metrics.on_submit(r.req_id, r.arrival_s, len(r.prompt))
    metrics.start()
    with torch.inference_mode():
        for w0 in range(0, len(reqs), S):
            wave = reqs[w0:w0 + S]
            plens = {len(r.prompt) for r in wave}
            if len(plens) != 1:
                raise ValueError("wave baseline needs uniform prompt "
                                 f"lengths within a wave, got {sorted(plens)}")
            P = plens.pop()
            # a wave starts only once its LAST member arrived
            metrics.wait_until(max(r.arrival_s for r in wave))
            B = len(wave)
            cache = T.init_cache(cfg, B, max_len, device=dev)
            req_ids = np.asarray([r.req_id for r in wave])
            for r in wave:
                metrics.on_admit(r.req_id)
            logits, cache, _ = T.prefill(
                params, cfg, put([list(r.prompt) for r in wave]), cache)
            metrics.on_prefill_chunk(B * P)
            metrics.tick()
            toks = sample(logits[:, -1], req_ids, np.zeros(B, np.int64))
            outs = [[t] for t in toks]
            done = np.zeros((B,), bool)
            for i, r in enumerate(wave):
                metrics.on_first_token(r.req_id)
                if (ecfg.eos_id is not None and outs[i][0] == ecfg.eos_id) \
                        or r.max_new_tokens == 1:
                    done[i] = True
                    metrics.on_finish(r.req_id)
            gen = 1
            max_gen = max(r.max_new_tokens for r in wave)
            while not done.all() and gen < max_gen:
                logits, cache = T.decode_step(
                    params, cfg, put(toks)[:, None], cache, P + gen - 1)
                toks = sample(logits[:, 0], req_ids, np.full(B, gen))
                metrics.on_decode_step(int((~done).sum()))
                metrics.tick()
                for i, r in enumerate(wave):
                    if done[i]:
                        continue       # slot idles until the wave drains
                    outs[i].append(toks[i])
                    metrics.on_token(r.req_id)
                    if (ecfg.eos_id is not None
                            and outs[i][-1] == ecfg.eos_id) \
                            or len(outs[i]) >= r.max_new_tokens:
                        done[i] = True
                        metrics.on_finish(r.req_id)
                gen += 1
            for i, r in enumerate(wave):
                results[r.req_id] = outs[i]
                if not done[i]:
                    metrics.on_finish(r.req_id)
    metrics.stop()
    return results, metrics
