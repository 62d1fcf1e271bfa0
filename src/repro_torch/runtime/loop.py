"""The BSP training loop: data → superstep → checkpoint → monitor (port of
``repro/runtime/loop.py``).

Responsibilities per step:
  1. pull a prefetched host batch (through ``batch_transform``, e.g. the
     uneven-shares layout of ``data.pipeline.reshard_for_shares``),
  2. run the superstep and wait for the device,
  3. record per-rank durations → straggler tracker, and rebalance,
  4. periodic async checkpoint (exact-resume metadata: the data step),
  5. on monitor-reported failure: raise ``WorkerFailure`` for elastic
     recovery (``runtime/soak.py`` runs it).

The step function is the port's ``(state, batch) -> (state, metrics)``;
the reference's takes and returns the state's parts as a tuple.  Each
history row holds the step's ``loss`` and seconds, as the reference's,
and the model's metrics the step reports (``MODEL_METRICS``: the
cross-entropy, the MoE balance loss, the MTP loss), which the log line
prints too.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointing import CheckpointManager
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.runtime.fault_tolerance import HostMonitor, StragglerTracker


# the model's metrics (``loss_fn``'s), carried into each history row
MODEL_METRICS = ("xent", "aux", "mtp")


class WorkerFailure(RuntimeError):
    def __init__(self, failed_hosts):
        super().__init__(f"failed hosts: {sorted(failed_hosts)}")
        self.failed_hosts = failed_hosts


@dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    # when > 0 and stragglers are detected, compute a proportional
    # micro-batch rebalance over this many micro-batches per superstep and
    # surface it (printed + appended to TrainLoop.rebalance_history)
    rebalance_microbatches: int = 0


def _wait(state) -> None:
    """Block until the device has finished the step (the reference's
    ``block_until_ready``)."""
    dev = getattr(state, "device", None) \
        or getattr(getattr(state, "flat_mu", None), "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class TrainLoop:
    step_fn: Callable                 # (state, batch) -> (state, metrics)
    state: Any                        # trainer.BSPTrainState or
                                      # trainer.GSPMDTrainState
    data: SyntheticLM
    cfg: LoopConfig
    monitor: Optional[HostMonitor] = None
    stragglers: StragglerTracker = field(default_factory=StragglerTracker)
    start_step: int = 0
    history: list = field(default_factory=list)
    rebalance_history: list = field(default_factory=list)
    # this host's BSP rank for the wall-clock fallback
    host_rank: int = 0
    # extra metadata stamped into every checkpoint (e.g. the trainer's
    # superstep_layout fingerprint, validated on resume)
    ckpt_meta: Dict[str, Any] = field(default_factory=dict)
    # host-side transform applied to every prefetched batch (e.g.
    # data.pipeline.reshard_for_shares under an actuated rebalance)
    batch_transform: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] \
        = None
    # closes the straggler loop: called with the rebalanced shares dict
    # the first time it CHANGES; returns (step_fn, batch_transform) —
    # typically a trainer rebuilt with shares= plus the matching
    # reshard_for_shares — or None to keep the current pair
    rebalance_actuator: Optional[Callable[[Dict[int, int]],
                                          Optional[tuple]]] = None
    _active_shares: Optional[Dict[int, int]] = None
    # the run's CheckpointManager (None without a checkpoint_dir)
    checkpoints: Optional[CheckpointManager] = None

    def _record_durations(self, metrics, dt: float) -> None:
        """Per-rank superstep durations → straggler tracker.

        Preferred source: a ``per_rank_step_s`` entry in the step metrics
        (a length-world vector of measured rank durations).  Fallback: this
        host's wall-clock under its own rank."""
        per_rank = metrics.get("per_rank_step_s") \
            if isinstance(metrics, dict) else None
        if per_rank is not None:
            for r, v in enumerate(np.asarray(per_rank).reshape(-1)):
                self.stragglers.record(int(r), float(v))
        else:
            self.stragglers.record(self.host_rank, dt)

    def _maybe_rebalance(self, step: int) -> None:
        if not self.cfg.rebalance_microbatches:
            return
        slow = self.stragglers.stragglers()
        if not slow:
            return
        ranks = sorted(self.stragglers.durations)
        shares = self.stragglers.rebalanced_shares(
            ranks, self.cfg.rebalance_microbatches)
        self.rebalance_history.append(
            {"step": step, "stragglers": sorted(slow), "shares": shares})
        print(f"step {step:5d} stragglers {sorted(slow)} "
              f"-> micro-batch shares {shares}", flush=True)
        if self.rebalance_actuator is not None \
                and shares != self._active_shares:
            # actuate only on CHANGE: a stable straggler pattern rebuilds
            # the step once
            out = self.rebalance_actuator(shares)
            if out is not None:
                self.step_fn, self.batch_transform = out
                self._active_shares = shares

    def run(self) -> Dict[str, Any]:
        ckpt = self.checkpoints = (
            CheckpointManager(self.cfg.checkpoint_dir,
                              keep=self.cfg.keep_checkpoints)
            if self.cfg.checkpoint_dir else None)
        prefetch = Prefetcher(self.data, start_step=self.start_step)
        state = self.state
        step = self.start_step
        try:
            while step < self.cfg.total_steps:
                data_step, host_batch = prefetch.next()
                if data_step != step:
                    raise RuntimeError(f"prefetcher at step {data_step}, "
                                       f"loop at {step}")
                if self.batch_transform is not None:
                    host_batch = self.batch_transform(host_batch)
                t0 = time.monotonic()
                state, metrics = self.step_fn(state, host_batch)
                _wait(state)
                dt = time.monotonic() - t0
                self._record_durations(metrics, dt)
                self._maybe_rebalance(step)

                if self.monitor is not None:
                    failed = self.monitor.failed_hosts()
                    if failed:
                        raise WorkerFailure(failed)

                loss = float(metrics.get("loss", np.nan))
                model = {k: float(metrics[k]) for k in MODEL_METRICS
                         if k in metrics}
                self.history.append({"step": step, "loss": loss, "sec": dt,
                                     **model})
                if self.cfg.log_every and step % self.cfg.log_every == 0:
                    extra = "".join(f" {k} {v:.4f}" for k, v in model.items())
                    print(f"step {step:5d} loss {loss:8.4f}{extra} "
                          f"{dt*1e3:7.1f} ms", flush=True)
                step += 1
                if ckpt and step % self.cfg.checkpoint_every == 0:
                    ckpt.save(step, state,
                              meta={**self.ckpt_meta, "data_step": step})
        finally:
            prefetch.close()
            if ckpt:
                ckpt.wait()
        if ckpt and step % self.cfg.checkpoint_every != 0:
            ckpt.save(step, state,
                      meta={**self.ckpt_meta, "data_step": step},
                      blocking=True)
        self.state = state
        return {"final_step": step, "history": self.history,
                "rebalance": self.rebalance_history}


def resume_or_init(ckpt_dir: Optional[str], like_state, expect_meta=None):
    """(state, start_step) — restored from the latest checkpoint if any.

    ``expect_meta`` entries are validated against the stored metadata and
    a mismatch OR absence raises: the flat moment vectors restore
    shape-compatibly under a different superstep bucket layout but bind
    every moment to the wrong parameter slice — silent corruption, so the
    resume must fail loudly instead.
    """
    if not ckpt_dir:
        return like_state, 0
    mgr = CheckpointManager(ckpt_dir)
    out = mgr.restore(like_state)
    if out is None:
        return like_state, 0
    state, meta = out
    for key, want in (expect_meta or {}).items():
        got = meta.get(key)
        if got != want:
            raise RuntimeError(
                f"checkpoint {key!r} mismatch: stored {got!r} vs expected "
                f"{want!r} — the flat state layout differs (different "
                f"--bucket-mb, or a checkpoint from before the bucketed "
                f"engine); restart from scratch or re-mesh explicitly")
    return state, int(meta.get("data_step", meta.get("step", 0)))
