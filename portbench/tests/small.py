"""The benchmark's cells cut to a size a CPU test holds: the same
family, traffic kinds, codecs and limits; the family's small widths,
float32."""

import time
from types import SimpleNamespace

import torch

from portbench import harness
from portbench.drivers import bsp_train
from portbench.reference import bsp as ref

CELLS = [w["name"] for w in harness.benchmark()["workloads"]
         if harness.load_cell(w["name"]).kind == "bsp_train"]


def small_cell(name: str, dtype: str = "float32"):
    cell = harness.load_cell(name)
    cfg = ref.Model.of(cell.config).family.small(cell.config)
    cfg["param_dtype"] = dtype
    cell.config = cfg
    cell.traffic = dict(cell.traffic, seq_len=16, bucket_mb=0.05)
    return cell


def run_small(cell, seed: int = 2 ** 33 + 7):
    """One run of the cell on the CPU past the harness's look for a card:
    a window of one step, then the comparison."""
    args = SimpleNamespace(seed=seed, seconds=0.0, trace=0)
    return bsp_train.run(cell, args, torch.device("cpu"), time.monotonic())
