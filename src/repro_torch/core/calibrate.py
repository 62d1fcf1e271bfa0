"""Calibration: fit cost-model/simulator parameters from measurements (port
of ``repro/core/calibrate.py``).

Two calibration paths live here:

1. **Link-parameter fitting** (``fit_link_params``): time a small grid of
   the port's collectives — (schedule × payload) all-reduces of a
   rank-stacked ``[world, per_rank]`` f32 tensor through the Schedule-IR
   lowering, on the card (or the CPU) — and least-squares-fit
   ``cost_model.LinkParams`` (α launch latency, per-hop latency, β
   inverse-bandwidth) with ``fit_from_samples``.
   ``cost_model.step_features`` makes every IR program's predicted cost
   LINEAR in those three parameters, so the fit is one ``lstsq``.  The
   fitted params plug into the autotuner through ``BSPConfig(link=…)``
   (the train CLI's ``--calibrate``).  The world is the caller's: the
   ranks are stacked on one device, so there is no device count to read.
   On one card the "link" is the card's memory, not a network.

2. **AMO-baseline simulator fitting** (``search``): the FractalSync columns
   of Table 1 are parameter-free (exact from topology), but the Naïve/XY
   software-AMO baselines depend on micro-architectural constants the paper
   does not publish (AMO service time, NoC per-hop latency, software loop
   overheads).  We fit those by randomized search + coordinate descent
   against the nine distinct published numbers:

       Naïve: 79 (Neighbor), 119 (2×2), 512 (4×4), 2488 (8×8), 13961 (16×16)
       XY:                    219 (2×2), 347 (4×4),  614 (8×8),  1462 (16×16)

   Loss = mean squared log-ratio (scale-aware, symmetric).  The fitted
   parameters are frozen into ``simulator.DEFAULT_PARAMS``.

Run:  PYTHONPATH=src python -m repro_torch.core.calibrate [--iters N]
      PYTHONPATH=src python -m repro_torch.core.calibrate --links \
          --devices 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import random
import time
from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

from . import cost_model, schedule_ir
from .cost_model import LinkParams
from .simulator import (DEFAULT_PARAMS, NaiveBarrier, PAPER_TABLE1,
                        SimBudgetExceeded, SimParams, XYBarrier, _mesh_of)

# ---------------------------------------------------------------------------
# Path 1: measured link-parameter fitting (α, hop, β) for the cost model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinkSample:
    """One measured collective: (schedule, mesh, per-rank payload) → s."""

    schedule: str
    shape: Tuple[int, ...]
    payload_bytes: float
    seconds: float


@dataclass(frozen=True)
class LinkFit:
    """Fitted link parameters plus the grid and residual behind them."""

    link: LinkParams
    samples: Tuple[LinkSample, ...]
    residual: float       # rms relative residual of the fit

    def describe(self) -> str:
        lk = self.link
        head = (f"fitted {lk.name}: alpha={lk.alpha_s:.3e}s "
                f"hop={lk.hop:.3e}s bw={lk.bw_Bps / 1e9:.2f}GB/s "
                f"rms-rel-residual={self.residual:.2f} "
                f"({len(self.samples)} samples)")
        rows = [f"  {s.schedule:<12s} {s.payload_bytes / 1e3:>9.1f}KB "
                f"{s.seconds * 1e6:>9.1f}us" for s in self.samples]
        return "\n".join([head] + rows)


# The measurement grid: schedules with distinct (steps, hops, bytes)
# signatures so the three-parameter fit is well-conditioned — the butterfly
# contributes multi-hop steps, the ring pure 1-hop bandwidth, the tree
# full-payload log-depth.
FIT_SCHEDULES = ("fractal", "ring", "tree")
FIT_PAYLOAD_ELEMS = (1 << 10, 1 << 14, 1 << 17, 1 << 20)   # per rank, f32


def fit_from_samples(samples: Sequence[LinkSample],
                     mesh_contention: bool = True,
                     name: str = "fitted") -> LinkFit:
    """Least-squares (α, hop, β) from measured (program, payload) → seconds.

    ``cost_model.step_features`` decomposes every program's predicted cost
    as ``n_steps·α + extra_hops·hop + load_frac·V·β`` — linear in the
    parameters — so the fit is one weighted ``lstsq``.  Rows are weighted by
    1/seconds: relative (not absolute) error, or the multi-MB samples would
    drown the latency-regime ones that decide α.
    """
    import numpy as np

    if not samples:
        raise ValueError("need at least one LinkSample to fit")
    rows, ts = [], []
    for s in samples:
        prog = schedule_ir.build_program(s.schedule, s.shape)
        n_steps, extra_hops, load_frac = cost_model.step_features(
            prog, mesh_contention)
        rows.append((n_steps, extra_hops, load_frac * s.payload_bytes))
        ts.append(s.seconds)
    A = np.asarray(rows, dtype=np.float64)
    t = np.asarray(ts, dtype=np.float64)
    w = 1.0 / np.maximum(t, 1e-12)
    sol, *_ = np.linalg.lstsq(A * w[:, None], t * w, rcond=None)
    alpha, hop, beta = (max(float(v), 1e-12) for v in sol)
    pred = A @ np.asarray([alpha, hop, beta])
    resid = float(np.sqrt(np.mean(
        ((pred - t) / np.maximum(t, 1e-12)) ** 2)))
    link = LinkParams(alpha_s=alpha, bw_Bps=1.0 / beta, hop_s=hop, name=name)
    return LinkFit(link=link, samples=tuple(samples), residual=resid)


def _mesh(shape: Union[int, Sequence[int]]) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _measure_collective(shape: Union[int, Sequence[int]], schedule: str,
                        per_rank_elems: int, repeats: int = 3,
                        inner: int = 5, device="cuda") -> float:
    """Best-of-``repeats`` mean seconds of ``inner`` all-reduces through the
    IR lowering (``collectives.all_reduce``) of a rank-stacked ``[world,
    per_rank_elems]`` f32 payload on ``device``, seeded as the reference
    seeds its global array.  One untimed call first; the device is
    synchronised before each clock reading."""
    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    from . import collectives as C

    dev = resolve_device(device)
    shape = _mesh(shape)
    world = math.prod(shape)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(per_rank_elems * world,)).astype(np.float32)).reshape(
        world, per_rank_elems).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    C.all_reduce(x, schedule, shape)       # first call outside the timing
    best = float("inf")
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        for _ in range(inner):
            C.all_reduce(x, schedule, shape)
        sync()
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


def fit_link_params(shape: Union[int, Sequence[int]],
                    schedules: Sequence[str] = FIT_SCHEDULES,
                    payload_elems: Sequence[int] = FIT_PAYLOAD_ELEMS,
                    repeats: int = 3,
                    mesh_contention: bool = True,
                    min_devices: int = 8, device="cuda") -> LinkFit:
    """Time a (schedule × payload) grid of the port's all-reduces over a
    world of ``shape`` ranks (an int, or a mesh tuple) stacked on
    ``device``, schedule-major, each payload rounded up to a multiple of
    the world, and fit ``LinkParams`` to the measurements (named
    ``fitted-<device type><world>``).  The world must hold at least
    ``min_devices`` ranks."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    shape = _mesh(shape)
    world = math.prod(shape)
    if world < min_devices:
        raise ValueError(
            f"link calibration needs ≥{min_devices} ranks, have {world} "
            f"(mesh {shape}); pass --devices")
    samples: List[LinkSample] = []
    for schedule in schedules:
        for elems in payload_elems:
            per_rank = ((elems + world - 1) // world) * world
            secs = _measure_collective(shape, schedule, per_rank,
                                       repeats=repeats, device=dev)
            samples.append(LinkSample(schedule=schedule, shape=shape,
                                      payload_bytes=per_rank * 4.0,
                                      seconds=secs))
    return fit_from_samples(samples, mesh_contention,
                            name=f"fitted-{dev.type}{world}")


# ---------------------------------------------------------------------------
# Path 2: AMO-baseline simulator fitting against paper Table 1
# ---------------------------------------------------------------------------

PENALTY = 1e6  # loss for configs that blow the simulation budget

TARGETS = []
for name, (_, _, naive, xy, _) in PAPER_TABLE1.items():
    TARGETS.append((name, "naive", naive))
    if name != "Neighbor":  # XY degenerates to Naive for 2 tiles
        TARGETS.append((name, "xy", xy))

SEARCH_SPACE = {
    "hop_latency": (1, 6),
    "link_occupancy": (1, 3),
    "inj_latency": (0, 5),
    "amo_service": (1, 24),
    "sw_pre": (0, 40),
    "sw_between": (0, 24),
    "sw_poll": (4, 40),   # ≥4: bounds poll-storm event counts
    "sw_post": (0, 16),
}


def evaluate(params: SimParams) -> tuple[float, dict]:
    sims = {}
    try:
        # cheap meshes first so pathological configs fail fast
        for name in sorted(PAPER_TABLE1, key=lambda n: _mesh_of(n)[0] *
                           _mesh_of(n)[1]):
            rows, cols = _mesh_of(name)
            sims[(name, "naive")] = NaiveBarrier(rows, cols, params).run()
            if name != "Neighbor":
                sims[(name, "xy")] = XYBarrier(rows, cols, params).run()
    except SimBudgetExceeded:
        return PENALTY, sims
    loss = 0.0
    for name, scheme, target in TARGETS:
        got = sims[(name, scheme)]
        loss += math.log(got / target) ** 2
    return loss / len(TARGETS), sims


def random_params(rng: random.Random) -> SimParams:
    return SimParams(**{k: rng.randint(lo, hi) for k, (lo, hi) in SEARCH_SPACE.items()})


def neighbors(p: SimParams, rng: random.Random, step: int = 1):
    for k, (lo, hi) in SEARCH_SPACE.items():
        v = getattr(p, k)
        for dv in (-step, step):
            nv = min(hi, max(lo, v + dv))
            if nv != v:
                yield dataclasses.replace(p, **{k: nv})


def search(iters: int = 200, seed: int = 0, start: SimParams | None = None):
    rng = random.Random(seed)
    best_p = start or DEFAULT_PARAMS
    best_loss, _ = evaluate(best_p)
    # Phase 1: random restarts
    for i in range(iters):
        p = random_params(rng)
        loss, _ = evaluate(p)
        if loss < best_loss:
            best_loss, best_p = loss, p
            print(f"[random {i}] loss={loss:.4f} {p}", flush=True)
    # Phase 2: coordinate descent from the best point
    improved = True
    while improved:
        improved = False
        for cand in neighbors(best_p, rng):
            loss, _ = evaluate(cand)
            if loss < best_loss - 1e-9:
                best_loss, best_p = loss, cand
                improved = True
                print(f"[descend] loss={loss:.4f} {cand}", flush=True)
    return best_p, best_loss


def report(params: SimParams) -> str:
    loss, sims = evaluate(params)
    lines = [f"params = {params}", f"mean sq log-ratio loss = {loss:.4f}", ""]
    lines.append(f"{'mesh':<9s} {'scheme':<6s} {'paper':>7s} {'sim':>7s} {'ratio':>6s}")
    for name, scheme, target in TARGETS:
        got = sims[(name, scheme)]
        lines.append(f"{name:<9s} {scheme:<6s} {target:>7d} {got:>7d} {got/target:>6.2f}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None,
                    help="output JSON (default: results/calibration.json, "
                         "or results/link_calibration.json with --links — "
                         "the two modes write different schemas)")
    ap.add_argument("--links", action="store_true",
                    help="fit LinkParams from timed collectives instead of "
                         "the Table-1 simulator parameters")
    ap.add_argument("--devices", type=int, default=8,
                    help="the world for --links: ranks stacked on the one "
                         "device")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --links times the collectives (default "
                         "cuda; raises if CUDA is missing)")
    args = ap.parse_args(argv)
    if args.links:
        fit = fit_link_params(args.devices, device=args.device)
        print(fit.describe())
        out = args.out or "results/link_calibration.json"
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"link": dataclasses.asdict(fit.link),
                       "residual": fit.residual,
                       "samples": [dataclasses.asdict(s)
                                   for s in fit.samples]}, f, indent=2)
        return
    best_p, best_loss = search(args.iters, args.seed)
    print(report(best_p))
    out = args.out or "results/calibration.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump({"params": dataclasses.asdict(best_p), "loss": best_loss}, f,
                  indent=2)


if __name__ == "__main__":
    main()
