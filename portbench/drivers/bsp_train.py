"""Traffic kind ``bsp_train``: BSP training of the port, as its train CLI
builds it for the traffic's flags.

Set-up builds one training step (``trainer.make_bsp_train_step`` with the
``BSPConfig`` that ``launch.train.bsp_config`` makes of the flags) and its
state from weights the benchmark draws from the seed, then drives it
through its first steps on distinct batches, reading each
step's loss, the first mean gradient (from the ZeRO-1 first moments after
one step) and each parameter's change.  The same object then runs the
timed window: step after step on a pool of batches drawn from the seed,
each step ending as the train loop's does (synchronised, the loss read
back).  ``--trace 1`` profiles a few more steps after the window.  Once
the program is freed, the plain reference (``reference/bsp.py``) runs the
first steps again and the readings are compared.

Nothing here knows the model: the configuration's ``family`` names
``reference/<family>.py`` (weights, layout, loss, FLOPs) and
``families/<family>.py`` (the port's config).
"""

from __future__ import annotations

import gc
import importlib
import math
import sys
import time
from types import SimpleNamespace
from typing import Dict

import torch

from portbench import counts, harness, trace
from portbench.peaks import H100_SXM
from portbench.reference import bsp as ref

# steps of set-up the comparison reads, distinct batches the window cycles,
# and steps the traced run profiles
FIRST_STEPS = 3
BATCH_POOL = 8
PROFILE_STEPS = 3


def program_config(config: dict, model: ref.Model):
    """The port's config of the cell, from the family's mapping
    (``families/<family>.py``)."""
    fam = importlib.import_module(f"portbench.families.{config['family']}")
    return fam.program_config(config, model.spec)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def program_params(cfg, weights: Dict[str, torch.Tensor]):
    """The port's parameter tree holding the benchmark's weights (the
    tensors themselves, no copy).  Raises unless the two name the same
    tensors with the same shapes and dtypes."""
    from repro_torch.models import transformer as T
    tree = T.init_params(cfg, device="meta")
    found = dict(_paths(tree))
    if set(found) != set(weights):
        raise ValueError(f"parameters differ: program only "
                         f"{sorted(set(found) - set(weights))}, benchmark "
                         f"only {sorted(set(weights) - set(found))}")
    for name, meta in found.items():
        w = weights[name]
        if tuple(w.shape) != tuple(meta.shape) or w.dtype != meta.dtype:
            raise ValueError(f"{name}: program {tuple(meta.shape)} "
                             f"{meta.dtype}, benchmark {tuple(w.shape)} "
                             f"{w.dtype}")

    def fill(t, prefix=""):
        if isinstance(t, dict):
            return {k: fill(v, f"{prefix}{k}/") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [fill(v, f"{prefix}{i}/") for i, v in enumerate(t)]
        return weights[prefix[:-1]]
    return fill(tree)


def build_step(cell, model: ref.Model, seed: int, device):
    """``(step_fn, state)`` as the train CLI builds them for the traffic's
    flags, on the benchmark's weights."""
    from repro_torch.launch.train import bsp_config, parse_args
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import trainer
    t = cell.traffic
    cfg = program_config(cell.config, model)
    args = parse_args(["--arch", cell.config["port_arch"], "--device",
                       device.type, "--devices", str(t["world"]),
                       "--schedule", t["schedule"], "--bucket-mb",
                       str(t["bucket_mb"]), "--bucket-codec",
                       t["bucket_codec"], "--lr", str(t["lr"]),
                       "--seed", str(seed)])
    acfg = AdamWConfig(lr=args.lr, beta1=t["beta1"], beta2=t["beta2"],
                       eps=t["eps"], weight_decay=t["weight_decay"],
                       warmup_steps=t["warmup_steps"],
                       total_steps=t["total_steps"],
                       min_lr_ratio=t["min_lr_ratio"])
    step_fn, init_state = trainer.make_bsp_train_step(
        cfg, acfg, bsp_config(args), t["world"], device=device)
    params = program_params(cfg, ref.make_weights(model, seed, device))
    return step_fn, init_state(params)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_steps(step_fn, state, model: ref.Model, cell, seed, batches,
                device) -> ref.Readings:
    """Drive the step through the first batches, reading what the
    comparison needs from the program's own state."""
    layout = ref.Layout(model, cell.traffic["world"],
                        cell.traffic["bucket_mb"])
    out = ref.Readings()
    for i, batch in enumerate(batches):
        state, m = step_fn(state, batch)
        _sync(device)
        out.losses.append(float(m["loss"]))
        if i == 0:
            out.grad_norm, out.grad_rms = ref.program_grad_norms(
                state.flat_mu, layout, cell.traffic["beta1"])
    out.change_norm = ref.change_norms(
        dict(_paths(state.params)), model, seed)
    return out


def run(cell, args, device, t0: float) -> dict:
    """One run of the cell; returns ``{"line": the result's JSON line,
    "checks": the compared numbers with their limits, "correct": ...}``."""
    t = cell.traffic
    marks = [("start", t0), ("imports", time.monotonic())]
    model = ref.Model.of(cell.config)
    step_fn, state = build_step(cell, model, args.seed, device)
    batches = ref.make_batches(model, t, args.seed, FIRST_STEPS + BATCH_POOL,
                               device)
    first, pool = batches[:FIRST_STEPS], batches[FIRST_STEPS:]
    _sync(device)
    marks.append(("weights, step and state", time.monotonic()))
    readings = first_steps(step_fn, state, model, cell, args.seed, first,
                           device)
    marks.append(("first steps and readings", time.monotonic()))
    setup_s = time.monotonic() - t0
    print("set-up (s): " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])),
        file=sys.stderr)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tokens_per_step = t["global_batch"] * t["seq_len"]
    n = failed = 0
    start = time.monotonic()
    ends = []
    while True:
        state, m = step_fn(state, pool[n % len(pool)])
        _sync(device)
        if not math.isfinite(float(m["loss"])):
            failed += 1
        n += 1
        window_s = time.monotonic() - start
        ends.append(window_s)
        if window_s >= args.seconds:
            break
    print("window steps (s): "
          + " ".join(f"{b - a:.4f}" for a, b in zip([0.0] + ends, ends)),
          file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}

    bench = harness.benchmark()
    breakdown = None
    if args.trace:
        def one():
            nonlocal state
            state, m = step_fn(state, pool[0])
            float(m["loss"])
        tr = trace.profile(one, PROFILE_STEPS)
        layout = ref.Layout(model, t["world"], t["bucket_mb"])
        codec = t["bucket_codec"]
        ctx = SimpleNamespace(
            trace=tr, flops=model.family.train_flops(model.spec, t),
            window_steps=n, window_s=window_s,
            profiled_steps=len(tr.step_seconds), peaks=H100_SXM,
            decode_add_bytes={codec: counts.decode_add_bytes(layout, codec)}
            if codec in counts.DECODE_ADD_BYTES else {},
            error_feedback_bytes=counts.error_feedback_bytes(layout))
        metrics = {}
        for m_ in harness.metrics_of(cell.name, "per_layer", bench):
            v = harness.reader(m_["name"])(ctx)
            if v is not None:
                metrics[m_["name"]] = {"value": v, "unit": m_["unit"]}
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s()
        breakdown = tr.breakdown()
    else:
        values = {"train_tokens_per_s": n * tokens_per_step / window_s,
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        metrics = {m_["name"]: {"value": values[m_["name"]],
                                "unit": m_["unit"]}
                   for m_ in harness.metrics_of(cell.name, "end_to_end",
                                                bench)}

    # the program's state is freed before the reference runs
    del step_fn, state, m, pool, batches
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    expect = ref.run(model, t, args.seed, first, device)
    found = ref.compare(readings, expect)
    checks = {k: dict(found[k], limit=lim) for k, lim in cell.limits.items()}
    correct = harness.within(checks) and failed == 0
    line = harness.result_line(correct, n, failed, metrics, dev, checks,
                               breakdown)
    return {"line": line, "checks": checks, "correct": correct}
