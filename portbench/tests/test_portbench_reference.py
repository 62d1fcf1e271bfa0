"""The plain reference against the port's step, on the CPU at a small
size: equal to float32 rounding where the program is sound, and a run
with each fault a training cell can have comes out not correct."""

import json

import pytest
import torch

from portbench.reference import bsp as ref
from portbench.tests.small import CELLS, run_small, small_cell


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_port(name):
    res = run_small(small_cell(name))
    line = json.loads(res["line"])
    assert line["correct"] is True
    for k, v in res["checks"].items():
        assert v["value"] < 1e-4, (k, v)
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"train_tokens_per_s", "peak_mem_gib",
                                    "setup_s"}


def _state_unchanged(monkeypatch):
    from repro_torch.runtime import trainer
    make = trainer.make_bsp_train_step

    def broken(*a, **kw):
        step_fn, init_state = make(*a, **kw)

        def step(state, batch):
            import copy
            _, m = step_fn(copy.deepcopy(state), batch)
            return state, m
        return step, init_state
    monkeypatch.setattr(trainer, "make_bsp_train_step", broken)


def _half_batch(monkeypatch):
    from repro_torch.runtime import trainer
    make = trainer.make_bsp_train_step

    def broken(*a, **kw):
        step_fn, init_state = make(*a, **kw)

        def step(state, batch):
            rows = batch["tokens"].shape[0] // 2
            return step_fn(state, {k: v[:rows] for k, v in batch.items()})
        return step, init_state
    monkeypatch.setattr(trainer, "make_bsp_train_step", broken)


def _no_exchange(monkeypatch):
    from repro_torch.core import collectives as C

    def own_chunk(x, schedule, codec=None, shape=None):
        W = x.shape[0]
        rev = C.bit_reversed_index(W)
        return x.reshape(W, W, -1)[torch.arange(W), rev].clone()
    monkeypatch.setattr(C, "reduce_scatter", own_chunk)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run_small(small_cell(name))
    assert json.loads(res["line"])["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_fp8_control_fails_a_limit(name):
    """The control (the reference with fp8 matmul inputs in the program's
    place) reads past at least one of the cell's limits."""
    cell = small_cell(name)
    model = ref.Model.of(cell.config)
    seed = 12345
    batches = ref.make_batches(model, cell.traffic, seed, 3, "cpu")
    expect = ref.run(model, cell.traffic, seed, batches, "cpu")
    got = ref.run(model, cell.traffic, seed, batches, "cpu", variant="fp8")
    checks = ref.compare(got, expect)
    assert any(checks[k]["value"] > lim for k, lim in cell.limits.items()), \
        checks


def test_column_blocks_change_no_value(monkeypatch):
    """The reference exchanges and updates a bucket in blocks of columns;
    blocks of 128 give the readings of whole chunks."""
    cell = small_cell(CELLS[0])
    model = ref.Model.of(cell.config)
    batches = ref.make_batches(model, cell.traffic, 3, 3, "cpu")
    whole = ref.run(model, cell.traffic, 3, batches, "cpu")
    monkeypatch.setattr(ref, "COLUMN_BLOCK", 128)
    blocks = ref.run(model, cell.traffic, 3, batches, "cpu")
    assert whole.losses == blocks.losses
    assert whole.grad_norm == blocks.grad_norm
    assert whole.change_norm == blocks.change_norm


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_small_cells_on_the_card(name, cuda_device):
    """The small cells through the card's kernels (B1, B2) are correct."""
    import time
    from types import SimpleNamespace
    from portbench.drivers import bsp_train
    res = bsp_train.run(small_cell(name), SimpleNamespace(
        seed=99, seconds=0.0, trace=1), cuda_device, time.monotonic())
    assert res["correct"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
