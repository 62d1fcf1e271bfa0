"""The benchmark's cells cut to a size a CPU test holds: the same
family, traffic kinds, codecs and limits, tiny widths, float32."""

import copy
import time
from types import SimpleNamespace

import torch

from portbench import harness
from portbench.drivers import bsp_train

CELLS = ["qwen2.5-3b-10l.bsp-int8", "qwen2.5-3b-10l.bsp-bf16"]


def small_cell(name: str, dtype: str = "float32"):
    cell = harness.load_cell(name)
    cfg, t = copy.deepcopy(cell.config), dict(cell.traffic)
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=128, vocab_size=256, num_hidden_layers=2)
    cfg["param_dtype"] = dtype
    t.update(seq_len=16, bucket_mb=0.05)
    cell.config, cell.traffic = cfg, t
    return cell


def run_small(cell, seed: int = 2 ** 33 + 7):
    """One run of the cell on the CPU past the harness's look for a card:
    a window of one step, then the comparison."""
    args = SimpleNamespace(seed=seed, seconds=0.0, trace=0)
    return bsp_train.run(cell, args, torch.device("cpu"), time.monotonic())
