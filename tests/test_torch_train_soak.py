"""The port's fault-injected train soak (ROADMAP A6) on the CPU.

``runtime.soak.run_train_soak`` at the reference's default
``TrainSoakConfig`` (qwen2.5-3b-smoke, tree (2, 4), 16 micro-batches of 1
row, rank 3 slow x3 at steps 4-10, rank 5 killed at step 12, a
checkpoint every 4 steps, 22 steps): the straggler rebalance actuates
uneven shares with rank 3 at the minimum, the kill re-meshes 8 -> 4 onto
a complete level-2 fsync domain, the parameters come back from the
checkpoint of step 12 and the replay starts at that step's recorded loss
(bit for bit here; ``check_train_soak`` allows 1e-5), and the loss
descends.  The port's ``check_train_soak`` reports no failure, and it
reports what the reference's reports, on this result and on broken copies
of it.
"""

import copy
import dataclasses

import pytest
import torch

from repro.runtime import soak as JS
from repro_torch.runtime.soak import (TrainSoakConfig, check_train_soak,
                                      run_train_soak)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops, which a thread pool per worker only slows when the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    scfg = TrainSoakConfig()
    assert dataclasses.asdict(scfg) == dataclasses.asdict(
        JS.TrainSoakConfig())
    result = run_train_soak(scfg, str(tmp_path_factory.mktemp("ckpt")),
                            device="cpu")
    return scfg, result


def test_soak_passes_its_checks(soak):
    scfg, result = soak
    checked = check_train_soak(copy.deepcopy(result), scfg)
    assert checked.ok, checked.failures
    rec = result.recovery
    assert (rec["old_world"], rec["new_world"], rec["level"]) == (8, 4, 2)
    assert rec["tiles"] == [(0, 0), (0, 1), (0, 2), (0, 3)]
    assert rec["ranks"] == [0, 1, 2, 3] and rec["restore_step"] == 12
    sh = result.actuated_shares
    assert sh[3] == min(sh.values()) < max(sh.values())
    assert sum(sh.values()) == scfg.microbatches
    recorded, replayed = result.replay_pairs[0]
    assert recorded == replayed
    assert [s["step"] for s in result.saves] == [4, 8, 12, 16, 20, 22]
    assert result.restore["step"] == 12 and result.restore["bytes"] > 0


def _broken(result, how):
    r = copy.deepcopy(result)
    r.failures = []
    if how == "even":
        r.actuated_shares = {k: 2 for k in r.actuated_shares}
    elif how == "slow_not_min":
        r.actuated_shares = {**r.actuated_shares, 3: 4}
    elif how == "no_recovery":
        r.recovery = None
    elif how == "not_a_domain":
        r.recovery = dict(r.recovery, tiles=[(0, 0), (0, 1), (1, 2), (0, 3)])
    elif how == "batch":
        r.recovery = dict(r.recovery, grad_accum_scale=1)
    elif how == "replay":
        a, b = r.replay_pairs[0]
        r.replay_pairs[0] = (a, b + 1e-3)
    elif how == "no_overlap":
        r.replay_pairs = []
    elif how == "ascent":
        r.history = [dict(h, loss=float(i)) for i, h in
                     enumerate(r.history)]
    return r


@pytest.mark.parametrize("how", [None, "even", "slow_not_min",
                                 "no_recovery", "not_a_domain", "batch",
                                 "replay", "no_overlap", "ascent"])
def test_check_reports_what_the_reference_reports(soak, how):
    scfg, result = soak
    ours = check_train_soak(_broken(result, how), scfg).failures
    ref = JS.check_train_soak(_broken(result, how),
                              JS.TrainSoakConfig()).failures
    assert ours == ref
    assert bool(ours) == (how is not None)
