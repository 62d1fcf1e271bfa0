"""The check that no module of JAX or of the JAX package was loaded, and
that a benchmark run passes it."""

import os
import subprocess
import sys

import pytest
import torch

from portbench import harness

ROOT = str(harness.ROOT)


def test_top_level_names_compared_whole():
    assert harness.forbidden_loaded(["repro_torch", "repro_torch.models",
                                     "numpy", "reprox"]) == []
    assert harness.forbidden_loaded(["repro.core", "repro_torch"]) == \
        ["repro"]
    assert harness.forbidden_loaded(["jax.numpy", "jaxlib.xla_client",
                                     "flax.linen"]) == ["flax", "jax",
                                                        "jaxlib"]


def _python(code):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_small_run_loads_no_jax():
    """A whole small run of each cell's driver, the port's step and the
    reference included, in a fresh process, leaves no forbidden module."""
    out = _python(
        "from portbench.tests.small import CELLS, run_small, small_cell\n"
        "for c in CELLS: run_small(small_cell(c))\n"
        "from portbench import harness\n"
        "print(harness.forbidden_loaded())\n")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    """Without enough CUDA devices the command exits non-zero and prints
    no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "qwen2.5-3b-10l.bsp-int8", "--seed", str(2 ** 33), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""
