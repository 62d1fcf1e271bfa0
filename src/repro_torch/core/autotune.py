"""Runtime schedule autotuner: pick the best schedule per workload (the
port's copy of ``repro/core/autotune.py``; equal rankings and picks).

The ROADMAP north-star is "add schedules and pick the fastest one per
workload"; with every schedule now a Schedule IR program, selection is a
query, not a code path:

  1. **Cost-model ranking** — price every registered IR builder for the
     concrete ``(mesh shape, payload bytes, link parameters)`` with
     ``cost_model.program_cost`` (mesh-contention mode by default: that is
     what separates the latency-optimal butterfly from the
     bandwidth-optimal ring);
  2. **Optional measured refinement** — time the top-k candidates with a
     caller-supplied ``measure(schedule) → seconds`` (e.g. the lowering
     timed on the card) and let measurement override the model where they
     disagree.

Wired through ``BSPConfig(schedule="auto")`` → ``bsp.sync_gradients`` /
``runtime.trainer.make_bsp_train_step``: the trainer resolves "auto" once
at build time from the flat gradient size and logs the choice.

The default link is the reference's analytic ``TPU_V5E_ICI`` (a TPU's
parameter set, not the H100's; see ``core/cost_model.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, List, Optional, Sequence, Tuple

from . import cost_model, schedule_ir
from .cost_model import LinkParams, TPU_V5E_ICI


@dataclass(frozen=True)
class TuneResult:
    """Outcome of one autotuning query."""

    schedule: str                              # the winner
    shape: Tuple[int, ...]
    payload_bytes: float
    ranking: Tuple[Tuple[str, float], ...]     # (schedule, predicted s) asc
    measured: Tuple[Tuple[str, float], ...] = ()   # (schedule, measured s)

    @property
    def predicted_s(self) -> float:
        return dict(self.ranking)[self.schedule]


@dataclass(frozen=True)
class BucketPolicy:
    """One bucket's tuned (schedule, codec) pick and its predicted price."""

    schedule: str
    codec: str = "none"
    predicted_s: float = 0.0


# How a codec changes a bucket's wire price: wire-bytes ratio vs f32, and
# encode/decode overhead charged as extra launch latencies per program step
# (quant/dequant kernels bracket every exchange).  The ratio shrinks the β
# term only, so small latency-bound buckets never win from compression — the
# per-bucket policy the ROADMAP asks for falls out of the pricing.
CODEC_WIRE_RATIO = {"none": 1.0, "bf16": 0.5, "int8": (1.0 + 4.0 / 128) / 4.0}
CODEC_STEP_ALPHAS = {"none": 0.0, "bf16": 1.0, "int8": 2.0}
# With the codec-fused tree_reduce/decode_add kernels (dequant folded into
# the receive-side accumulate, one launch instead of dequant-then-add) each
# exchange pays one launch fewer: bf16's encode is a cast XLA fuses into the
# send slice (decode side free → 0.5 total), int8 still pays its quant
# kernel but the dequant launch disappears (2.0 → 1.0).
CODEC_STEP_ALPHAS_FUSED = {"none": 0.0, "bf16": 0.5, "int8": 1.0}
CODECS = tuple(CODEC_WIRE_RATIO)


def codec_step_alphas() -> dict:
    """Per-step codec launch-overhead table.  The port always fuses the
    decode into the receive-side add (``kernels.tree_reduce.ops.decode_add``:
    the B1/B2 kernels on the card, one plain op on the CPU), so it always
    prices with the fused table.  Every codec-pricing consumer
    (``rank_policies``, ``SuperstepEngine.timeline``) reads this resolver.
    """
    return CODEC_STEP_ALPHAS_FUSED


@lru_cache(maxsize=512)
def _candidates(shape: Tuple[int, ...],
                schedules: Optional[Tuple[str, ...]]) -> Tuple[str, ...]:
    names = list(schedules) if schedules else list(schedule_ir.SCHEDULES)
    world = math.prod(shape)
    pow2 = world >= 1 and (world & (world - 1)) == 0
    if not pow2:
        # tree-structured schedules need a power-of-two world
        names = [n for n in names if n in ("ring", "xy", "naive")]
    if not names:
        raise ValueError(
            f"no schedule among {schedules} can run on shape {tuple(shape)}")
    return tuple(names)


@lru_cache(maxsize=8192)
def _rank_banded(shape: Tuple[int, ...], band: int, link: LinkParams,
                 outer_link: Optional[LinkParams],
                 schedules: Optional[Tuple[str, ...]],
                 mesh_contention: bool) -> Tuple[Tuple[str, float], ...]:
    """Ranking memoized per (shape, payload-band, links, candidates): engine
    builds and the DP bucket search stop re-pricing identical candidates."""
    names = _candidates(shape, schedules)
    if math.prod(shape) == 1:
        # nothing to communicate: every schedule is a no-op, don't build IR
        return ((names[0], 0.0),)
    payload = cost_model.band_payload(band)
    out = []
    for name in names:
        prog = schedule_ir.build_program(name, shape)
        cost = cost_model.program_cost(prog, payload, link,
                                       outer_link=outer_link,
                                       mesh_contention=mesh_contention)
        out.append((name, cost))
    out.sort(key=lambda kv: kv[1])
    return tuple(out)


def rank_schedules(shape: Sequence[int], payload_bytes: float,
                   link: LinkParams = TPU_V5E_ICI,
                   outer_link: Optional[LinkParams] = None,
                   schedules: Optional[Sequence[str]] = None,
                   mesh_contention: bool = True
                   ) -> List[Tuple[str, float]]:
    """All candidate schedules priced for this workload, cheapest first.

    Prices are evaluated at the payload's quarter-octave band center
    (``cost_model.payload_band``) so repeated queries for near-identical
    payloads — every engine build, every DP segment — hit one cache line.
    Pass a fitted ``link`` (``core.calibrate.fit_link_params``) to rank with
    measured platform parameters instead of the analytic defaults.
    """
    sched_key = tuple(schedules) if schedules is not None else None
    return list(_rank_banded(tuple(shape),
                             cost_model.payload_band(payload_bytes),
                             link, outer_link, sched_key, mesh_contention))


def pick_schedule(shape: Sequence[int], payload_bytes: float,
                  link: LinkParams = TPU_V5E_ICI,
                  outer_link: Optional[LinkParams] = None,
                  schedules: Optional[Sequence[str]] = None,
                  mesh_contention: bool = True) -> str:
    """Cost-model-optimal schedule name for ``(shape, payload, link)``."""
    return rank_schedules(shape, payload_bytes, link, outer_link, schedules,
                          mesh_contention)[0][0]


def _zero1_adjust(ranking: Sequence[Tuple[str, float]]
                  ) -> List[Tuple[str, float]]:
    """Re-price a ranking for the ZeRO-1 trainer lowering: the fractal
    schedule reduce-scatters natively and its all-gather half doubles as the
    parameter publish, while every other schedule pays its full all-reduce
    PLUS the butterfly publish all-gather (half a fractal all-reduce) on
    top — without this, "auto" would pick ring for large buckets the
    trainer then runs ~50% slower than fractal."""
    costs = dict(ranking)
    if "fractal" not in costs:
        return list(ranking)
    publish = 0.5 * costs["fractal"]
    return sorted(((n, c if n == "fractal" else c + publish)
                   for n, c in costs.items()), key=lambda kv: kv[1])


def pick_bucket_schedules(shape: Sequence[int],
                          bucket_bytes: Sequence[float],
                          link: LinkParams = TPU_V5E_ICI,
                          outer_link: Optional[LinkParams] = None,
                          schedules: Optional[Sequence[str]] = None,
                          mesh_contention: bool = True,
                          zero1_publish: bool = False,
                          measure: Optional[
                              Callable[[str, float], float]] = None,
                          measure_budget: int = 0,
                          measure_top_k: int = 2,
                          baseline: Optional[Sequence[str]] = None
                          ) -> Tuple[str, ...]:
    """Cost-model-optimal schedule *per bucket* of a bucketed superstep.

    Bucket payloads straddle the butterfly↔ring crossover by construction:
    the reverse-layer partition makes late (embedding/head) buckets big and
    the last buckets small, so one global pick is wrong for somebody.  Since
    buckets serialize on the shared fabric in ready order, the fabric-
    occupancy-minimizing joint choice decomposes into independent per-bucket
    minima — each bucket just takes the cheapest program for its own bytes.

    ``zero1_publish=True`` prices the ZeRO-1 trainer lowering (see
    ``_zero1_adjust``).

    ``measure(schedule, payload_bytes) → seconds`` plus a positive
    ``measure_budget`` spends up to that many real timings refining the
    picks, priciest buckets first (they have the most to gain): for each
    refined bucket the top ``measure_top_k`` analytic candidates are timed
    and the measured winner overrides the model.  Measurements that raise
    or return non-finite values are skipped.

    ``baseline`` seeds the picks with a prior choice per bucket (e.g. the
    engine's codec-aware policy winners): unmeasured buckets keep their
    baseline pick untouched, and each measured bucket's baseline is always
    in its timed candidate set — refinement can only override a pick that
    something actually out-measured.
    """
    rankings = []
    for payload in bucket_bytes:
        ranking = rank_schedules(shape, payload, link, outer_link,
                                 schedules, mesh_contention)
        if zero1_publish:
            ranking = _zero1_adjust(ranking)
        rankings.append(ranking)
    if baseline is not None:
        if len(baseline) != len(bucket_bytes):
            raise ValueError("baseline must match bucket_bytes in length")
        names = list(baseline)
    else:
        names = [r[0][0] for r in rankings]

    if measure is not None and measure_budget > 0:
        budget = int(measure_budget)
        # priciest buckets first: a wrong pick there costs the most
        order = sorted(range(len(names)),
                       key=lambda i: -rankings[i][0][1])
        for i in order:
            if budget <= 0:
                break
            cands = [n for n, _cost in rankings[i][:measure_top_k]]
            # the incumbent is timed FIRST: if the budget dies mid-bucket,
            # a challenger can never evict a pick it was not measured
            # against
            if names[i] in cands:
                cands.remove(names[i])
            cands.insert(0, names[i])
            timed: List[Tuple[str, float]] = []
            for name in cands:
                if budget <= 0:
                    break
                budget -= 1
                try:
                    t = float(measure(name, bucket_bytes[i]))
                except Exception:
                    continue
                if math.isfinite(t):
                    timed.append((name, t))
            if timed:
                names[i] = min(timed, key=lambda kv: kv[1])[0]
    return tuple(names)


def rank_policies(shape: Sequence[int], payload_bytes: float,
                  link: LinkParams = TPU_V5E_ICI,
                  outer_link: Optional[LinkParams] = None,
                  schedules: Optional[Sequence[str]] = None,
                  codecs: Sequence[str] = CODECS,
                  mesh_contention: bool = True,
                  zero1_publish: bool = False) -> List[BucketPolicy]:
    """All (schedule, codec) policies priced for one payload, cheapest first.

    Codecs ride the fractal schedule's point-to-point exchanges (that is the
    only lowering with wire compression), shrinking the bandwidth term by
    ``CODEC_WIRE_RATIO`` while paying ``codec_step_alphas()`` extra launch
    latencies per step for the quant/dequant kernels (the fused table when
    the codec-fused tree_reduce kernels dispatch).  Under
    ``zero1_publish`` only the reduce-scatter half compresses — the
    all-gather half publishes full-precision parameters.
    """
    shape = tuple(shape)
    ranking = rank_schedules(shape, payload_bytes, link, outer_link,
                             schedules, mesh_contention)
    if zero1_publish:
        ranking = _zero1_adjust(ranking)
    out = [BucketPolicy(n, "none", c) for n, c in ranking]
    if "fractal" in dict(ranking) and math.prod(shape) > 1:
        prog = schedule_ir.build_program("fractal", shape)
        base = dict(ranking)["fractal"]
        alphas = codec_step_alphas()
        for codec in codecs:
            if codec == "none":
                continue
            wire = cost_model.program_cost_banded(
                prog, payload_bytes * CODEC_WIRE_RATIO[codec], link,
                outer_link, mesh_contention)
            overhead = alphas[codec] * link.alpha_s * prog.num_steps
            if zero1_publish:
                # only the reduce-scatter half carries the codec — both
                # the wire saving AND the quant launches halve
                cost = 0.5 * base + 0.5 * wire + 0.5 * overhead
            else:
                cost = wire + overhead
            out.append(BucketPolicy("fractal", codec, cost))
    out.sort(key=lambda p: p.predicted_s)
    return out


def pick_bucket_policies(shape: Sequence[int],
                         bucket_bytes: Sequence[float],
                         link: LinkParams = TPU_V5E_ICI,
                         outer_link: Optional[LinkParams] = None,
                         schedules: Optional[Sequence[str]] = None,
                         codecs: Sequence[str] = CODECS,
                         mesh_contention: bool = True,
                         zero1_publish: bool = False
                         ) -> Tuple[BucketPolicy, ...]:
    """Joint (schedule, codec) pick per bucket: large early buckets compress
    harder (the β saving dwarfs the quant overhead), small latency-bound
    tail buckets skip compression — the per-bucket policy priced through
    the same (optionally calibrated) cost model as the schedule picks."""
    return tuple(rank_policies(shape, b, link, outer_link, schedules,
                               codecs, mesh_contention, zero1_publish)[0]
                 for b in bucket_bytes)


def autotune(shape: Sequence[int], payload_bytes: float,
             link: LinkParams = TPU_V5E_ICI,
             outer_link: Optional[LinkParams] = None,
             schedules: Optional[Sequence[str]] = None,
             measure: Optional[Callable[[str], float]] = None,
             measure_top_k: int = 3,
             mesh_contention: bool = True) -> TuneResult:
    """Rank by cost model; optionally refine the top-k with measurements.

    ``measure(schedule)`` returns observed seconds (or raises / returns
    ``inf`` for schedules that fail to run — they are skipped).
    """
    shape = tuple(shape)
    ranking = tuple(rank_schedules(shape, payload_bytes, link, outer_link,
                                   schedules, mesh_contention))
    winner = ranking[0][0]
    measured: List[Tuple[str, float]] = []
    if measure is not None:
        for name, _cost in ranking[:measure_top_k]:
            try:
                t = float(measure(name))
            except Exception:
                continue
            if math.isfinite(t):
                measured.append((name, t))
        if measured:
            measured.sort(key=lambda kv: kv[1])
            winner = measured[0][0]
    return TuneResult(schedule=winner, shape=shape,
                      payload_bytes=payload_bytes, ranking=ranking,
                      measured=tuple(measured))
