"""What every cell shares: finding a cell's files by name, the metrics
``BENCHMARK.json`` asks of it, the per-layer readers, the check that no
JAX module was loaded, and the result line.

A cell ``<config>.<traffic>`` is ``workloads/<cell>.json`` (its
configuration, traffic and correctness limits); the configuration is
``configs/<config>.json``, the traffic ``traffic/<traffic>.json``, whose
``kind`` names the driver ``drivers/<kind>.py``; a per-layer metric
``<metric>`` is read by ``layer_metrics/<metric>.py``.  Nothing here
names a cell, a model or a metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that may not be loaded in a run: JAX, and the
# JAX package the program was ported from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    with open(path) as f:
        out = json.load(f)
    out.setdefault("name", name)
    return out


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    chips: int

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def load_cell(name: str) -> Cell:
    w = load_json("workloads", name)
    return Cell(name, load_json("configs", w["config"]),
                load_json("traffic", w["traffic"]), dict(w["limits"]),
                int(w.get("chips", 1)))


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def metrics_of(cell: str, section: str, bench: Optional[dict] = None
               ) -> List[dict]:
    """The entries of ``BENCHMARK.json``'s ``section`` that this cell
    reports: those without a ``workloads`` list, and those that name it."""
    bench = bench or benchmark()
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def reader(metric: str):
    """The ``read(ctx)`` of ``layer_metrics/<metric>.py``."""
    path = HERE / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden
    (``repro_torch`` passes: only ``repro`` itself is the JAX package)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names}
                  & set(FORBIDDEN_MODULES))


def checks_text(checks: Dict[str, dict]) -> str:
    return "\n".join(f"{k} {v['value']!r} limit {v['limit']!r}"
                     + (f" (worst at {v['at']})" if v.get("at") else "")
                     for k, v in checks.items())


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                checks: Dict[str, dict], breakdown: Optional[dict] = None
                ) -> str:
    """The result's JSON line; the compared numbers come last."""
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                     for k, v in checks.items()}
    return json.dumps(out, allow_nan=True)


def within(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
               for v in checks.values())
