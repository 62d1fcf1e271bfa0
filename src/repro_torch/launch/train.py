"""Training entry point: the FractalSync BSP superstep, or the GSPMD
baseline, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b-smoke \
      --device cpu --steps 8 --batch 4 --seq 64 --schedule auto --devices 4

Every architecture of the zoo trains here (the MTP, MoE and recurrent
ones since slice 11, whose ``xent``, ``aux`` and ``mtp`` the log line
prints; the frontend ones, paligemma-3b and musicgen-medium, since slice
12, with stub frontend embeddings in each batch).  Port of
``repro.launch.train`` with the same flags, plus ``--device`` (default
``cuda``; a CUDA request without CUDA raises).  ``--devices N`` is the
BSP world, held as N ranks stacked on the one device (default 1).
Gradients are bucketed (``--bucket-mb``, or ``auto`` for the DP boundary
search), reduce-scattered with the bucket's schedule (``--schedule``:
fractal, ring, xy, naive, hierarchical, tree, or ``auto`` for the
cost-model autotuner's pick per bucket), the fractal one with the wire
codec on every hop (``--bucket-codec``, or ``auto`` per bucket; on the card
the hops run the hand-written decode-add kernels), updated by ZeRO-1 AdamW
and all-gathered; one fsync barrier closes each step.  The engine's plan
(per-bucket size, schedule and codec) is printed.  Random-init params come
from ``--seed``.  ``--checkpoint-dir`` saves the state every
``--checkpoint-every`` steps and at the end, in the reference's format, and
a run pointed at a directory that holds a checkpoint resumes from its
latest one (it must have the same superstep layout).

``--calibrate`` first times a grid of the port's collectives at the world
``--devices`` gives, on the device, and fits the cost model's link
parameters to them, so every "auto" pick is priced with the device's
numbers instead of the reference's TPU link; the fit is written to
``<checkpoint-dir>/link_calibration.json`` and reloaded on resume, so the
bucket plan and the moment layout cannot move.

``--schedule xla`` runs the GSPMD tier instead, as the reference's: the
mesh ``(devices, 1)`` over ``("data", "model")`` (virtual devices on the
one torch device, ``launch/mesh.py``), the params placed on its FSDP×TP
specs, and ``trainer.make_gspmd_train_step``: ``loss_fn`` on the whole
global batch, the pytree AdamW with the global-norm clip.  As in the
reference, ``--bucket-*``, ``--compression``, ``--fsync-level``,
``--calibrate`` and ``--grad-accum`` do nothing there, and the checkpoint
carries no superstep layout.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b-smoke \
      --device cpu --devices 4 --steps 3 --schedule xla

``run(cfg, args)`` runs a parsed command line on a given config (e.g. one
cut in depth); ``main`` parses, looks the config up and calls it.
"""

import argparse


def _bucket_mb_arg(v):
    return "auto" if v == "auto" else float(v)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="BSP training with the FractalSync superstep, the "
                    "world's ranks stacked on one device.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where params, state and kernels live (default "
                         "cuda; raises if CUDA is missing)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--schedule", default="fractal",
                    help="gradient schedule: fractal|ring|xy|naive|"
                         "hierarchical|tree, or auto (the autotuner's pick "
                         "per bucket); xla runs the GSPMD step")
    ap.add_argument("--compression", default="none")
    ap.add_argument("--fsync-level", type=int, default=None)
    ap.add_argument("--bucket-mb", type=_bucket_mb_arg, default=None,
                    help="pipeline gradient sync over ~N MB buckets "
                         "(reverse-layer order; default: monolithic), or "
                         "'auto' for the DP bucket-boundary search")
    ap.add_argument("--bucket-codec", default=None,
                    choices=["auto", "none", "bf16", "int8"],
                    help="per-bucket wire codec: 'auto' lets the tuner "
                         "pick per bucket (default: uniform --compression, "
                         "EF only)")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit cost-model link params from collectives "
                         "timed on the device before tuning")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="--no-overlap collapses bucketing back to one "
                         "bucket")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="micro-batches accumulated per rank per superstep")
    ap.add_argument("--devices", type=int, default=0,
                    help="BSP world: ranks stacked on the one device; "
                         "with --schedule xla the mesh's data axis (0 → 1)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save checkpoints here, and resume from the latest "
                         "one it holds")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


CALIBRATION_FILE = "link_calibration.json"


def calibrated_link(args, dev, world: int):
    """The link ``--calibrate`` asks for (None without it): reloaded from
    ``<checkpoint-dir>/link_calibration.json`` when that exists — refitting
    from fresh timings could move the bucket boundaries and invalidate the
    checkpointed moment layout — else fitted on the largest power-of-two
    world up to ``world`` on ``dev`` and written there, in the reference's
    format ``{"link": asdict(link)}``."""
    if not args.calibrate:
        return None
    import dataclasses
    import json
    import os
    from repro_torch.core.cost_model import LinkParams
    path = (os.path.join(args.checkpoint_dir, CALIBRATION_FILE)
            if args.checkpoint_dir else None)
    if path and os.path.exists(path):
        with open(path) as f:
            link = LinkParams(**json.load(f)["link"])
        print(f"calibrate: reloaded {link.name} from {path}")
        return link
    if world < 2:
        print("calibrate: skipped (needs ≥2 devices; pass --devices 8)")
        return None
    from repro_torch.core.calibrate import fit_link_params
    fit = fit_link_params(1 << (world.bit_length() - 1), min_devices=2,
                          device=dev)
    print(fit.describe())
    if path:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"link": dataclasses.asdict(fit.link)}, f, indent=2)
    return fit.link


def bsp_config(args, link=None):
    """The ``BSPConfig`` a parsed command line asks for, pricing the
    autotuner's picks with ``link`` (None: the default link)."""
    from repro_torch.core.bsp import BSPConfig
    return BSPConfig(sync_axes=("data",), schedule=args.schedule,
                     compression=args.compression,
                     fsync_level=args.fsync_level, bucket_mb=args.bucket_mb,
                     overlap=args.overlap, bucket_codec=args.bucket_codec,
                     link=link)


def gspmd_state(cfg, args, params, dev, acfg):
    """The GSPMD tier of ``--schedule xla``: ``(step_fn, state)``, the
    params placed on the mesh's specs (the reference's
    ``device_put(params, named(mesh, pspec))``)."""
    from repro_torch.launch.mesh import describe, make_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.optim.adamw import init
    from repro_torch.runtime import trainer
    from repro_torch.runtime.elastic import reshard_state
    mesh = make_mesh((args.devices or 1, 1), ("data", "model"), device=dev)
    step_fn, (pspec, _ospec, bspec) = trainer.make_gspmd_train_step(
        cfg, mesh, acfg)
    params = reshard_state(params, mesh,
                           SH.port_param_specs(cfg, params, pspec))
    print(f"gspmd: mesh {describe(mesh)} (virtual devices on {dev}); batch "
          f"{dict(bspec)}; the global batch in one step")
    return step_fn, trainer.GSPMDTrainState(params, init(params, acfg), cfg)


def run(cfg, args):
    """Train ``cfg`` as the parsed command line ``args`` asks.  Returns the
    loop's result: ``final_step``, ``history`` (per-step loss and wall
    seconds) and the ``engine`` (bucket plan) of the run (None for
    ``--schedule xla``)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import count_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import trainer
    from repro_torch.runtime.loop import LoopConfig, TrainLoop, resume_or_init

    dev = resolve_device(args.device)
    world = args.devices or 1
    acfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10))
    params = T.init_params(cfg, args.seed, device=dev)
    print(f"arch={cfg.name} layers={cfg.num_layers} device={dev} "
          f"world={world} params={count_params(cfg):,}")
    engine = None
    if args.schedule == "xla":
        step_fn, state = gspmd_state(cfg, args, params, dev, acfg)
        ckpt_meta = {}
    else:
        link = calibrated_link(args, dev, world)
        step_fn, init_state = trainer.make_bsp_train_step(
            cfg, acfg, bsp_config(args, link), world,
            grad_accum=args.grad_accum, device=dev)
        ckpt_meta = {"superstep_layout": init_state.superstep_layout}
        state, engine = init_state(params), init_state.engine
    state, start = resume_or_init(args.checkpoint_dir, state,
                                  expect_meta=ckpt_meta)
    if start:
        print(f"resumed from {args.checkpoint_dir} at step {start}")
    del params
    data = SyntheticLM(cfg, DataConfig(global_batch=args.batch,
                                       seq_len=args.seq, seed=args.seed))
    loop = TrainLoop(step_fn=step_fn, state=state, data=data,
                     cfg=LoopConfig(total_steps=args.steps,
                                    checkpoint_every=args.checkpoint_every,
                                    checkpoint_dir=args.checkpoint_dir),
                     start_step=start, ckpt_meta=ckpt_meta)
    out = loop.run()
    losses = [h["loss"] for h in out["history"]]
    if losses:
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
    return dict(out, engine=engine)


def main(argv=None):
    from repro_torch.models.registry import get_config
    args = parse_args(argv)
    return run(get_config(args.arch), args)


if __name__ == "__main__":
    main()
