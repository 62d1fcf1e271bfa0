"""α-β (latency-bandwidth) cost model for synchronization/collective schedules
(the port's copy of ``repro/core/cost_model.py``; equal prices).

Carries the reference's two analytic parameter sets:

  * ``MAGIA``: the paper's system — 1 GHz tiles, 1-cycle NoC hops, pure-control
    barriers (payload ≈ 0) → latency-dominated, which is why the H-tree's
    O(log N) beats XY's O(k) and Naïve's O(N) (Table 1).
  * ``TPU_V5E``: the reference's target, a TPU v5e — 197 bf16 TFLOP/s/chip,
    819 GB/s HBM, ~50 GB/s/link ICI, ~1 µs software-visible collective
    launch latency.  Barriers ride on gradient collectives, so both α
    (latency) and β (bytes/bandwidth) terms matter.

``TPU_V5E_ICI`` stays the autotuner's default link so the port's picks
equal the reference's.  It is a TPU's analytic parameter set, NOT a model
of the H100 or of its NVLink: no number here was measured on the card, and
calibrating a link on it (``core.calibrate.fit_link_params``) is ROADMAP
A13.

The model prices the schedules implemented in ``core/collectives.py``; the
autotuner (``core/autotune.py``) ranks schedules and codecs with it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence, Tuple

from . import schedule_ir


@dataclass(frozen=True)
class LinkParams:
    alpha_s: float          # per-step latency (s): hop/launch overhead
    bw_Bps: float           # per-link bandwidth, bytes/s
    name: str = "link"
    # per-hop latency of multi-hop mesh routes (s); None → alpha_s, which
    # reproduces the historical ``hops × alpha`` pricing.  ``fit_link_params``
    # (core.calibrate) fits it separately from alpha: on real fabrics the
    # launch overhead dwarfs the per-hop forwarding cost.
    hop_s: Optional[float] = None

    @property
    def hop(self) -> float:
        return self.alpha_s if self.hop_s is None else self.hop_s


MAGIA = LinkParams(alpha_s=1e-9, bw_Bps=4e9, name="magia-noc")      # 1 cycle @1GHz, 32bit@1GHz
TPU_V5E_ICI = LinkParams(alpha_s=1e-6, bw_Bps=50e9, name="v5e-ici")
TPU_DCN = LinkParams(alpha_s=10e-6, bw_Bps=25e9, name="dcn")        # inter-pod


@dataclass(frozen=True)
class ChipParams:
    peak_flops: float = 197e12     # bf16
    hbm_Bps: float = 819e9
    hbm_GiB: float = 16.0
    name: str = "tpu-v5e"


TPU_V5E = ChipParams()


# ---------------------------------------------------------------------------
# All-reduce schedule costs for N devices, V bytes per device
# ---------------------------------------------------------------------------


def ring_all_reduce(n: int, vol_B: float, link: LinkParams) -> float:
    """Dimension-flat ring: 2(n−1) steps, bandwidth-optimal: 2·V·(n−1)/n."""
    if n <= 1:
        return 0.0
    return 2 * (n - 1) * link.alpha_s + 2 * vol_B * (n - 1) / n / link.bw_Bps


def fractal_all_reduce(n: int, vol_B: float, link: LinkParams) -> float:
    """Recursive halving-doubling (the H-tree/butterfly schedule):
    reduce-scatter by halves (log n steps, V(n−1)/n bytes) then all-gather by
    doubles.  Latency-optimal (2·log n steps) AND bandwidth-optimal."""
    if n <= 1:
        return 0.0
    steps = 2 * math.log2(n)
    return steps * link.alpha_s + 2 * vol_B * (n - 1) / n / link.bw_Bps


def xy_all_reduce(kx: int, ky: int, vol_B: float, link: LinkParams) -> float:
    """Dimension-ordered (paper's XY baseline): ring along x then along y.
    Latency O(kx+ky); bandwidth 2·V·[(kx−1)/kx + (ky−1)/ky]."""
    return ring_all_reduce(kx, vol_B, link) + ring_all_reduce(ky, vol_B, link)


def naive_all_reduce(n: int, vol_B: float, link: LinkParams) -> float:
    """Gather-to-root + broadcast (paper's Naïve): root port serializes n−1
    ingress and n−1 egress transfers of V bytes."""
    if n <= 1:
        return 0.0
    return 2 * (n - 1) * (link.alpha_s + vol_B / link.bw_Bps)


def hierarchical_all_reduce(n_inner: int, n_outer: int, vol_B: float,
                            inner: LinkParams, outer: LinkParams) -> float:
    """The fractal idea at pod granularity: intra-pod reduce-scatter,
    inter-pod all-reduce over V/n_inner shards, intra-pod all-gather."""
    if n_inner <= 1:
        return fractal_all_reduce(n_outer, vol_B, outer)
    rs = math.log2(n_inner) * inner.alpha_s + vol_B * (n_inner - 1) / n_inner / inner.bw_Bps
    mid = fractal_all_reduce(n_outer, vol_B / n_inner, outer)
    ag = math.log2(n_inner) * inner.alpha_s + vol_B * (n_inner - 1) / n_inner / inner.bw_Bps
    return rs + mid + ag


def tree_all_reduce(n: int, vol_B: float, link: LinkParams) -> float:
    """Two-phase tree reduce-broadcast: 2·log n steps each moving the full
    payload — latency-optimal like the butterfly, but O(V·log n) bytes."""
    if n <= 1:
        return 0.0
    return 2 * math.log2(n) * (link.alpha_s + vol_B / link.bw_Bps)


def barrier_cost(n: int, link: LinkParams, schedule: str = "fractal") -> float:
    """Pure-control barrier (payload→0): only the α terms survive. This is the
    regime of the paper, where the H-tree's 2·log2(N) steps win."""
    if schedule == "fractal":
        return 2 * math.log2(n) * link.alpha_s
    if schedule == "xy":
        k = int(round(math.sqrt(n)))
        return 2 * (k - 1) * 2 * link.alpha_s
    if schedule == "naive":
        return 2 * (n - 1) * link.alpha_s
    if schedule == "ring":
        return 2 * (n - 1) * link.alpha_s
    raise ValueError(schedule)


def schedule_cost(schedule: str, n: int, vol_B: float, link: LinkParams,
                  mesh_xy: tuple[int, int] | None = None) -> float:
    if schedule == "fractal":
        return fractal_all_reduce(n, vol_B, link)
    if schedule == "ring":
        return ring_all_reduce(n, vol_B, link)
    if schedule == "naive":
        return naive_all_reduce(n, vol_B, link)
    if schedule == "tree":
        return tree_all_reduce(n, vol_B, link)
    if schedule == "xy":
        kx, ky = mesh_xy or _square(n)
        return xy_all_reduce(kx, ky, vol_B, link)
    raise ValueError(schedule)


def _square(n: int) -> tuple[int, int]:
    k = int(round(math.sqrt(n)))
    if k * k != n:
        raise ValueError(f"{n} is not square; pass mesh_xy explicitly")
    return k, k


# ---------------------------------------------------------------------------
# Schedule IR backend: price any program directly from its step structure
# ---------------------------------------------------------------------------
#
# Plain α-β mode (mesh_contention=False):
#
#     cost = Σ_steps [ α + max_edge_fraction(step) · V / bw ]
#
# which reproduces the closed forms above *exactly* for every IR builder
# (the tests cross-check this).  Mesh mode (mesh_contention=True)
# additionally routes every transfer XY on the 2D mesh and charges
#
#     cost_step = hops_max · α + max_link_load · V / bw
#
# where max_link_load is the largest payload fraction any single directed
# link carries.  This is what separates the butterfly from the ring: ring
# neighbors are 1 hop with load V/N per link, while butterfly partners at
# sub-step b sit 2^⌊b/2⌋ hops apart and 2^⌊b/2⌋ exchanges share the middle
# links — the latency-vs-bandwidth crossover the autotuner exploits.


def _route_links(rows: int, cols: int, src: int, dst: int):
    """Directed links of the XY route between flat ranks (mirrors NoC)."""
    r, c = divmod(src, cols)
    dr, dc = divmod(dst, cols)
    links = []
    while c != dc:
        nc = c + (1 if dc > c else -1)
        links.append(((r, c), (r, nc)))
        c = nc
    while r != dr:
        nr = r + (1 if dr > r else -1)
        links.append(((r, c), (nr, c)))
        r = nr
    return links


@lru_cache(maxsize=512)
def _step_geometry(prog: schedule_ir.Program) -> Tuple[Tuple[int, float], ...]:
    """Per step: (max hop distance, max per-directed-link payload load in V
    units), from XY-routing every transfer on the program's 2D projection."""
    rows, cols = schedule_ir.as_2d(prog.shape)
    out = []
    for step in prog.steps:
        hops_max = 1
        load: dict = {}
        for t in step.transfers:
            frac = prog.frac(t)
            links = _route_links(rows, cols, t.src, t.dst)
            hops_max = max(hops_max, len(links))
            for l in links:
                load[l] = load.get(l, 0.0) + frac
        out.append((hops_max, max(load.values(), default=0.0)))
    return tuple(out)


def program_cost(prog: schedule_ir.Program, vol_B: float,
                 link: LinkParams, outer_link: Optional[LinkParams] = None,
                 mesh_contention: bool = False) -> float:
    """Predicted wall time of an IR program moving ``vol_B`` bytes/rank.

    Steps tagged ``tier="outer"`` (the hierarchical schedule's inter-pod
    middle) are priced on ``outer_link`` with hop distance 1 — pod-level
    links are point-to-point, not mesh-routed.  Without a distinct
    ``outer_link`` there IS no separate pod fabric: outer steps then ride
    the same mesh as everything else and pay hops/contention like any
    other step (otherwise the hierarchical schedule would beat the
    butterfly on single-tier meshes by modeling fiat).
    """
    geometry = _step_geometry(prog) if mesh_contention else None
    total = 0.0
    for i, step in enumerate(prog.steps):
        if not step.transfers:
            continue
        outer = step.tier == schedule_ir.TIER_OUTER and outer_link is not None
        lp = outer_link if outer else link
        frac = step.max_chunks_moved / prog.n_chunks
        if geometry is not None and not outer:
            hops, link_load = geometry[i]
            total += (lp.alpha_s + (hops - 1) * lp.hop
                      + max(frac, link_load) * vol_B / lp.bw_Bps)
        else:
            total += lp.alpha_s + frac * vol_B / lp.bw_Bps
    return total


def step_features(prog: schedule_ir.Program,
                  mesh_contention: bool = True
                  ) -> Tuple[int, int, float]:
    """(n_steps, extra_hops, load_frac) such that, single-tier,

        program_cost ≡ n_steps·α + extra_hops·hop + load_frac·V·(1/bw)

    — the program's cost is LINEAR in the link parameters, which is what
    lets ``core.calibrate.fit_link_params`` least-squares-fit (α, hop, β)
    from measured (program, payload) → seconds samples.
    """
    geometry = _step_geometry(prog) if mesh_contention else None
    n_steps, extra_hops, load_frac = 0, 0, 0.0
    for i, step in enumerate(prog.steps):
        if not step.transfers:
            continue
        frac = step.max_chunks_moved / prog.n_chunks
        n_steps += 1
        if geometry is not None:
            hops, link_load = geometry[i]
            extra_hops += hops - 1
            load_frac += max(frac, link_load)
        else:
            load_frac += frac
    return n_steps, extra_hops, load_frac


# -- payload-band memoization ------------------------------------------------
#
# Engine builds price O(buckets × candidates) programs, and the DP bucket
# search prices O(leaves²) segment payloads.  Exact payloads rarely repeat,
# but prices within a quarter-octave of payload are indistinguishable for
# schedule choice — so cacheable pricing quantizes the payload to a
# geometric band and memoizes per (program, band, links, mode).

BANDS_PER_OCTAVE = 4


def payload_band(vol_B: float) -> int:
    """Quarter-octave band index of a payload size (0-byte payloads → -1)."""
    if vol_B <= 0:
        return -1
    return int(round(BANDS_PER_OCTAVE * math.log2(vol_B)))


def band_payload(band: int) -> float:
    """Representative payload (band center) of a band index."""
    if band < 0:
        return 0.0
    return 2.0 ** (band / BANDS_PER_OCTAVE)


@lru_cache(maxsize=16384)
def _program_cost_banded(prog: schedule_ir.Program, band: int,
                         link: LinkParams, outer_link: Optional[LinkParams],
                         mesh_contention: bool) -> float:
    return program_cost(prog, band_payload(band), link, outer_link,
                        mesh_contention)


def program_cost_banded(prog: schedule_ir.Program, vol_B: float,
                        link: LinkParams,
                        outer_link: Optional[LinkParams] = None,
                        mesh_contention: bool = False) -> float:
    """``program_cost`` with the payload quantized to its quarter-octave
    band — repeated pricings of near-identical payloads hit one cache
    line."""
    return _program_cost_banded(prog, payload_band(vol_B), link, outer_link,
                                mesh_contention)


def program_barrier_cost(prog: schedule_ir.Program, link: LinkParams,
                         outer_link: Optional[LinkParams] = None,
                         mesh_contention: bool = False) -> float:
    """Pure-control regime (payload → 0): only the α structure survives."""
    return program_cost(prog, 0.0, link, outer_link, mesh_contention)


# ---------------------------------------------------------------------------
# Overlap-aware mode: price a bucketed superstep on a shared-fabric timeline
# ---------------------------------------------------------------------------
#
# The monolithic superstep is compute, THEN one big collective:
#
#     serial_s = backward_s + Σ_i cost(bucket_i)
#
# The bucketed superstep overlaps: bucket i's grads are ready at
# ``ready_s[i]`` (reverse-layer order — the last layers' grads drop out of
# backward first), and its collective occupies the shared fabric as soon as
# both the fabric is free and the bucket is ready.  Buckets serialize on the
# fabric (one shared NoC / ICI domain) but run concurrently with the rest of
# backward — which is exactly the DDP/ZeRO bucketing overlap argument, made
# quantitative per IR program.


@dataclass(frozen=True)
class OverlapTimeline:
    """Shared-fabric timeline of a bucketed superstep (seconds)."""

    ready_s: Tuple[float, ...]       # per bucket: grads available
    comm_start_s: Tuple[float, ...]  # per bucket: collective enters fabric
    comm_end_s: Tuple[float, ...]
    comm_cost_s: Tuple[float, ...]   # per bucket: isolated collective cost
    overlapped_s: float              # pipelined step time (last comm end)
    serial_s: float                  # no-overlap baseline: max ready + Σ cost

    @property
    def overlap_gain(self) -> float:
        """Fraction of the serial step time hidden by overlap."""
        if self.serial_s <= 0:
            return 0.0
        return 1.0 - self.overlapped_s / self.serial_s


def overlap_step_cost(progs: Sequence[schedule_ir.Program],
                      vols_B: Sequence[float],
                      ready_s: Sequence[float],
                      link: LinkParams,
                      outer_link: Optional[LinkParams] = None,
                      mesh_contention: bool = True,
                      extra_s: Optional[Sequence[float]] = None
                      ) -> OverlapTimeline:
    """Price a sequence of bucket programs on one shared-fabric timeline.

    ``progs[i]`` moves ``vols_B[i]`` bytes/rank and may start no earlier
    than ``ready_s[i]``; programs occupy the fabric in order (bucket i+1
    waits for bucket i — in-order issue, matching the runtime lowering).
    ``extra_s[i]`` adds a fixed per-bucket cost on top of the program price
    (e.g. codec quant/dequant launches).  ``serial_s`` is the monolithic
    baseline where no communication starts until every bucket is ready
    (the sum a bucketed superstep is compared against).
    """
    if not (len(progs) == len(vols_B) == len(ready_s)):
        raise ValueError("progs, vols_B, ready_s must have equal length")
    if extra_s is None:
        extra_s = (0.0,) * len(progs)
    elif len(extra_s) != len(progs):
        raise ValueError("extra_s must match progs in length")
    costs = tuple(program_cost(p, v, link, outer_link, mesh_contention) + e
                  for p, v, e in zip(progs, vols_B, extra_s))
    starts, ends = [], []
    fabric_free = 0.0
    for c, r in zip(costs, ready_s):
        start = max(fabric_free, r)
        fabric_free = start + c
        starts.append(start)
        ends.append(fabric_free)
    overlapped = ends[-1] if ends else max(ready_s, default=0.0)
    serial = (max(ready_s) if ready_s else 0.0) + sum(costs)
    return OverlapTimeline(ready_s=tuple(ready_s),
                           comm_start_s=tuple(starts),
                           comm_end_s=tuple(ends),
                           comm_cost_s=costs,
                           overlapped_s=overlapped,
                           serial_s=serial)
