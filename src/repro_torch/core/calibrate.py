"""Calibration: fit cost-model/simulator parameters from measurements (the
port's copy of the half of ``repro/core/calibrate.py`` that needs no
collective timing).

Two calibration paths live here:

1. **Link-parameter fitting**: ``fit_from_samples`` least-squares-fits
   ``cost_model.LinkParams`` (α launch latency, per-hop latency, β
   inverse-bandwidth) to measured (schedule, payload) → seconds samples.
   ``cost_model.step_features`` makes every IR program's predicted cost
   LINEAR in those three parameters, so the fit is one ``lstsq``.  Timing
   the collectives themselves on the card (``_measure_collective``,
   ``fit_link_params``, the train CLI's ``--calibrate``) is ROADMAP A13 and
   raises here.

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
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import random
from dataclasses import dataclass
from typing import Sequence, Tuple

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


def _a13_missing(name: str):
    return NotImplementedError(
        f"{name} times collectives on the card to fit a link, which is "
        "ROADMAP A13 (link calibration on the H100), not ported yet")


def _measure_collective(*args, **kwargs) -> float:
    """Seconds of one timed collective (ROADMAP A13: raises)."""
    raise _a13_missing("_measure_collective")


def fit_link_params(*args, **kwargs) -> LinkFit:
    """Time a (schedule × payload) grid of collectives and fit
    ``LinkParams`` to it (ROADMAP A13: raises)."""
    raise _a13_missing("fit_link_params")


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
    ap.add_argument("--out", type=str, default="results/calibration.json",
                    help="output JSON (default: results/calibration.json)")
    ap.add_argument("--links", action="store_true",
                    help="fit LinkParams from timed collectives (ROADMAP "
                         "A13: raises)")
    args = ap.parse_args(argv)
    if args.links:
        raise _a13_missing("--links")
    best_p, best_loss = search(args.iters, args.seed)
    print(report(best_p))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"params": dataclasses.asdict(best_p), "loss": best_loss}, f,
                  indent=2)


if __name__ == "__main__":
    main()
