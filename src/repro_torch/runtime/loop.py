"""The BSP training loop: data → superstep → monitor (port of
``repro/runtime/loop.py``).

Per step: pull a prefetched host batch, run the superstep, wait for the
device, record the loss and the step's wall time.  Checkpointing, the
straggler rebalance and ``resume_or_init`` from a checkpoint come with the
checkpoint and fault-tolerance modules in a later slice and raise when
asked for.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.data.pipeline import Prefetcher, SyntheticLM


@dataclass
class LoopConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    rebalance_microbatches: int = 0

    def __post_init__(self):
        if self.checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpointing comes with the checkpoint module (ROADMAP "
                "A9), not ported yet")
        if self.rebalance_microbatches:
            raise NotImplementedError(
                "the straggler rebalance needs trainer shares= and the "
                "fault-tolerance module, not ported yet")


def _wait(state) -> None:
    """Block until the device has finished the step (the reference's
    ``block_until_ready``)."""
    dev = state.flat_mu.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class TrainLoop:
    step_fn: Callable                 # (state, batch) -> (state, metrics)
    state: Any                        # trainer.BSPTrainState
    data: SyntheticLM
    cfg: LoopConfig
    start_step: int = 0
    history: list = field(default_factory=list)

    def run(self) -> Dict[str, Any]:
        prefetch = Prefetcher(self.data, start_step=self.start_step)
        state = self.state
        step = self.start_step
        try:
            while step < self.cfg.total_steps:
                data_step, host_batch = prefetch.next()
                if data_step != step:
                    raise RuntimeError(f"prefetcher at step {data_step}, "
                                       f"loop at {step}")
                t0 = time.monotonic()
                state, metrics = self.step_fn(state, host_batch)
                _wait(state)
                dt = time.monotonic() - t0
                loss = float(metrics["loss"])
                self.history.append({"step": step, "loss": loss, "sec": dt})
                if self.cfg.log_every and step % self.cfg.log_every == 0:
                    print(f"step {step:5d} loss {loss:8.4f} {dt*1e3:7.1f} ms",
                          flush=True)
                step += 1
        finally:
            prefetch.close()
        self.state = state
        return {"final_step": step, "history": self.history}


def resume_or_init(ckpt_dir: Optional[str], like_state):
    """(state, start_step): a fresh start.  Restoring from a checkpoint
    directory comes with the checkpoint module and raises."""
    if ckpt_dir:
        raise NotImplementedError(
            "resuming from a checkpoint comes with the checkpoint module "
            "(ROADMAP A9), not ported yet")
    return like_state, 0
