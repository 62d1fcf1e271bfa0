"""Serving entry point: continuous-batching engine over the paged KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --requests 16 --prompt-len 256 --gen 64 --gen-spread 32 \
      --max-slots 8 --block-size 16 --prefill-chunk 64 --clock wall

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch gemma2-2b-smoke --device cpu --requests 6 --prompt-len 8 \
      --gen 6 --max-slots 2

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v3-671b-smoke --device cpu --requests 6 \
      --prompt-len 8 --gen 6 --max-slots 2

Port of ``repro.launch.serve`` with the same flags, plus ``--device``
(default ``cuda``; a CUDA request without CUDA raises).  This slice serves
from the paged KV cache only, so ``--kv-mode`` accepts ``paged`` (the
default); ``--mode wave``, ``--slot-state contiguous``, ``--rec-slots`` and
``--devices N > 1`` raise until the slices that port them.  Random-init
params come from ``--seed``.  Prints the metrics report and the launch
counts of the paged-attention kernels (GQA for attention layers, absorbed
MLA for MLA layers).

  --paged-kernel K  auto (the CUDA kernels on --device cuda, their plain
                    versions on the CPU) | ref (force gather-then-attend)

``run(cfg, args)`` serves a parsed command line on a given config (e.g. one
cut in depth); ``main`` parses, looks the config up and calls it.
"""

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Continuous-batching serving over the paged KV cache "
                    "(the port: --kv-mode paged only).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where params, cache and kernels live (default "
                         "cuda; raises if CUDA is missing)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16,
                    help="per-request generation budget (first token incl.)")
    ap.add_argument("--gen-spread", type=int, default=0,
                    help="ragged budgets: draw from [gen-K, gen] per request")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="token id that completes a request and frees its "
                         "slot for the next admission")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--kv-mode", choices=("paged",), default="paged",
                    help="KV backend; this slice of the port serves from "
                         "the paged cache only (contiguous: not ported)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV: cache positions per physical block")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="paged KV: physical blocks in the pool "
                         "(0 = match contiguous capacity)")
    ap.add_argument("--paged-kernel", choices=("auto", "ref"),
                    default="auto",
                    help="decode attention: auto (CUDA kernel on a CUDA "
                         "cache, plain version on the CPU) | ref "
                         "(gather-then-attend)")
    ap.add_argument("--slot-state", choices=("auto", "contiguous", "paged"),
                    default="auto",
                    help="KV-layer backend override (contiguous: not "
                         "ported)")
    ap.add_argument("--rec-slots", type=int, default=0,
                    help="recurrent-state rows (not ported: must be 0)")
    ap.add_argument("--clock", choices=("step", "wall"), default="step",
                    help="serve clock: step (virtual, deterministic) or "
                         "wall (measured seconds, idle gaps sleep)")
    ap.add_argument("--arrival", default="immediate",
                    help="immediate | poisson:RATE | burst:RATE,DUTY[,PERIOD]"
                         " | trace:SPEC")
    ap.add_argument("--mode", choices=("continuous", "wave"),
                    default="continuous")
    ap.add_argument("--devices", type=int, default=0,
                    help="0 or 1: one card is one device (multi-device "
                         "serving is not ported)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def run(cfg, args: argparse.Namespace):
    """Serve ``args.requests`` random prompts with ``cfg``; returns
    (results {req_id: tokens}, metrics)."""
    if args.mode == "wave":
        raise NotImplementedError(
            "--mode wave (serve_waves) is not ported yet")
    if args.slot_state == "contiguous":
        raise NotImplementedError(
            "--slot-state contiguous: the contiguous KV backend is not "
            "ported yet; this slice serves from the paged cache")
    if args.rec_slots:
        raise NotImplementedError(
            f"--rec-slots {args.rec_slots}: recurrent state rows are not "
            "ported yet (a later slice of the port)")
    if args.devices > 1:
        raise NotImplementedError(
            f"--devices {args.devices}: one card is one device; "
            "multi-device serving (torch.distributed) is not ported yet")

    import numpy as np

    from repro_torch.device import resolve_device
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import (EngineConfig, Request, ServeEngine,
                                   parse_arrival_spec)

    device = resolve_device(args.device)
    params = T.init_params(cfg, args.seed, device=device)

    rng = np.random.default_rng(args.seed)
    arrivals = parse_arrival_spec(args.arrival, args.requests, args.seed)
    requests = []
    for i in range(args.requests):
        gen = args.gen if args.gen_spread <= 0 else int(
            rng.integers(max(1, args.gen - args.gen_spread), args.gen + 1))
        prompt = rng.integers(0, cfg.vocab_size,
                              size=(args.prompt_len,)).tolist()
        requests.append(Request(req_id=i, prompt=prompt, max_new_tokens=gen,
                                arrival_s=arrivals[i]))

    # the paged backend needs block_size | max_len
    max_len = args.prompt_len + args.gen + 1
    max_len = -(-max_len // args.block_size) * args.block_size
    ecfg = EngineConfig(
        max_slots=args.max_slots,
        max_len=max_len,
        prefill_chunk=args.prefill_chunk,
        temperature=args.temperature,
        eos_id=args.eos_id,
        seed=args.seed,
        block_size=args.block_size,
        kv_blocks=args.kv_blocks,
        paged_kernel=args.paged_kernel,
        clock=args.clock)

    print(f"arch={cfg.name} device={device} kv={args.kv_mode} "
          f"requests={args.requests} "
          f"prompt={args.prompt_len} gen={args.gen}"
          f"{f'±{args.gen_spread}' if args.gen_spread else ''} "
          f"slots={args.max_slots} arrival={args.arrival} "
          f"block_size={args.block_size}")

    engine = ServeEngine(cfg, params, ecfg)
    print(f"slot-state plan: {engine.plan.describe()}")
    counts = ("LAUNCHES", "MERGE_LAUNCHES", "MLA_LAUNCHES",
              "MLA_MERGE_LAUNCHES")
    before = {c: getattr(pa_ops, c) for c in counts}
    results = engine.run(requests)
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
    metrics = engine.metrics

    print(metrics.report())
    n = {c: getattr(pa_ops, c) - before[c] for c in counts}
    print(f"paged_attention kernel launches: {n['LAUNCHES']} (merges "
          f"{n['MERGE_LAUNCHES']}), paged_mla_attention kernel launches: "
          f"{n['MLA_LAUNCHES']} (merges {n['MLA_MERGE_LAUNCHES']}) "
          f"(paged_kernel={engine.paged_kernel}, {metrics.decode_steps} "
          f"decode steps x {cfg.num_layers} layers)")
    shown = sorted(results)[:2]
    print("sample outputs:", [results[i][:8] for i in shown])
    return results, metrics


def main(argv=None):
    from repro_torch.models.registry import get_config
    args = parse_args(argv)
    return run(get_config(args.arch), args)


if __name__ == "__main__":
    main()
