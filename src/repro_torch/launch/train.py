"""Training entry point: the FractalSync BSP superstep on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b-smoke \
      --device cpu --devices 4 --steps 3 --schedule auto --bucket-mb auto \
      --bucket-codec auto

Port of ``repro.launch.train`` with the same flags, plus ``--device``
(default ``cuda``; a CUDA request without CUDA raises).  ``--devices N`` is
the BSP world, held as N ranks stacked on the one device (default 1).
Gradients are bucketed (``--bucket-mb``, or ``auto`` for the DP boundary
search), reduce-scattered with the bucket's schedule (``--schedule``:
fractal, ring, xy, naive, hierarchical, tree, or ``auto`` for the
cost-model autotuner's pick per bucket), the fractal one with the wire
codec on every hop (``--bucket-codec``, or ``auto`` per bucket; on the card
the hops run the hand-written decode-add kernels), updated by ZeRO-1 AdamW
and all-gathered; one fsync barrier closes each step.  The engine's plan
(per-bucket size, schedule and codec) is printed.  Random-init params come
from ``--seed``.

Not ported yet, and refused: ``--schedule xla`` (the GSPMD step, ROADMAP
A12), ``--calibrate`` (link calibration on the card, A13),
``--checkpoint-dir`` (checkpointing, A5).

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
                         "per bucket)")
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
                    help="fit cost-model link params on the card (not "
                         "ported: ROADMAP A13)")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="--no-overlap collapses bucketing back to one "
                         "bucket")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="micro-batches accumulated per rank per superstep")
    ap.add_argument("--devices", type=int, default=0,
                    help="BSP world: ranks stacked on the one device "
                         "(0 → 1)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50,
                    help="(checkpointing is not ported)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.schedule == "xla":
        raise NotImplementedError(
            "--schedule xla is the GSPMD train step, not ported yet "
            "(ROADMAP A12)")
    if args.calibrate:
        raise NotImplementedError(
            "--calibrate times collectives on the card to fit the link, "
            "not ported yet (ROADMAP A13)")
    if args.checkpoint_dir is not None:
        raise NotImplementedError(
            "--checkpoint-dir: checkpointing is not ported yet (ROADMAP "
            "A5)")


def bsp_config(args):
    """The ``BSPConfig`` a parsed command line asks for."""
    from repro_torch.core.bsp import BSPConfig
    return BSPConfig(sync_axes=("data",), schedule=args.schedule,
                     compression=args.compression,
                     fsync_level=args.fsync_level, bucket_mb=args.bucket_mb,
                     overlap=args.overlap, bucket_codec=args.bucket_codec)


def run(cfg, args):
    """Train ``cfg`` as the parsed command line ``args`` asks.  Returns the
    loop's result: ``final_step``, ``history`` (per-step loss and wall
    seconds) and the ``engine`` (bucket plan) of the run."""
    _refuse_unported(args)
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import count_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import trainer
    from repro_torch.runtime.loop import LoopConfig, TrainLoop

    dev = resolve_device(args.device)
    world = args.devices or 1
    acfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10))
    params = T.init_params(cfg, args.seed, device=dev)
    print(f"arch={cfg.name} layers={cfg.num_layers} device={dev} "
          f"world={world} params={count_params(cfg):,}")
    step_fn, init_state = trainer.make_bsp_train_step(
        cfg, acfg, bsp_config(args), world, grad_accum=args.grad_accum,
        device=dev)
    data = SyntheticLM(cfg, DataConfig(global_batch=args.batch,
                                       seq_len=args.seq, seed=args.seed))
    loop = TrainLoop(step_fn=step_fn, state=init_state(params), data=data,
                     cfg=LoopConfig(total_steps=args.steps))
    out = loop.run()
    losses = [h["loss"] for h in out["history"]]
    if losses:
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
    return dict(out, engine=init_state.engine)


def main(argv=None):
    from repro_torch.models.registry import get_config
    args = parse_args(argv)
    return run(get_config(args.arch), args)


if __name__ == "__main__":
    main()
