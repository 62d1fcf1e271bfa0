"""Serving entry point: continuous-batching engine over a slot pool.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --requests 16 --prompt-len 256 --gen 64 --gen-spread 32 \
      --max-slots 8 --kv-mode paged --block-size 16 --prefill-chunk 64 \
      --clock wall

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch gemma2-2b-smoke --device cpu --requests 6 --prompt-len 8 \
      --gen 6 --max-slots 2 [--mode wave]

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch jamba-v0.1-52b-smoke --device cpu --kv-mode paged \
      --rec-slots 1 --requests 6 --prompt-len 8 --gen 6 --max-slots 2

Port of ``repro.launch.serve`` with the same flags, plus ``--device``
(default ``cuda``; a CUDA request without CUDA raises).  Every token-only
architecture serves: attention, MLA, recurrent (xlstm-1.3b) and hybrid
(jamba-v0.1-52b) stacks, over the contiguous KV cache (``--kv-mode
contiguous``, the default) or the paged one, with recurrent layers on
pooled state rows (``--rec-slots``).  ``--mode wave`` runs the
wave-at-a-time oracle (``serve_waves``) over the contiguous cache.
``--devices N`` shards the slot batch over a ("data",) mesh of N virtual
devices on the one device, as the reference's (``max_slots`` must divide
among them; in wave mode it is ignored, with a note); the outputs are the
ones without it.
Random-init params come from ``--seed``.  Prints the metrics report and
the launch counts of the paged-attention kernels (GQA for attention
layers, absorbed MLA for MLA layers; only the paged cache runs them).

  --paged-kernel K  auto (the CUDA kernels on --device cuda, their plain
                    versions on the CPU) | ref (force gather-then-attend)

``run(cfg, args)`` serves a parsed command line on a given config (e.g. one
cut in depth); ``main`` parses, looks the config up and calls it.
"""

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Continuous-batching serving over a slot pool (the "
                    "port).")
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
    ap.add_argument("--kv-mode", choices=("contiguous", "paged"),
                    default="contiguous",
                    help="KV backend: contiguous (one max_len row per "
                         "slot) or paged (pooled blocks + block tables)")
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
                    help="KV-layer backend override (auto: follow "
                         "--kv-mode); recurrent layers always use the "
                         "recurrent-row backend")
    ap.add_argument("--rec-slots", type=int, default=0,
                    help="recurrent-state rows (0 = match --max-slots)")
    ap.add_argument("--clock", choices=("step", "wall"), default="step",
                    help="serve clock: step (virtual, deterministic) or "
                         "wall (measured seconds, idle gaps sleep)")
    ap.add_argument("--arrival", default="immediate",
                    help="immediate | poisson:RATE | burst:RATE,DUTY[,PERIOD]"
                         " | trace:SPEC")
    ap.add_argument("--mode", choices=("continuous", "wave"),
                    default="continuous")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard the slot batch over a mesh of N virtual "
                         "devices on the one device (0: no mesh)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def run(cfg, args: argparse.Namespace):
    """Serve ``args.requests`` random prompts with ``cfg``; returns
    (results {req_id: tokens}, metrics)."""
    if args.mode == "wave" and args.kv_mode == "paged":
        raise ValueError("--mode wave serves from the contiguous cache only")
    import numpy as np

    from repro_torch.device import resolve_device
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serve import (EngineConfig, Request, ServeEngine,
                                   parse_arrival_spec, serve_waves)

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

    max_len = args.prompt_len + args.gen + 1
    if args.kv_mode == "paged":
        # the paged backend needs block_size | max_len
        max_len = -(-max_len // args.block_size) * args.block_size
    ecfg = EngineConfig(
        max_slots=args.max_slots,
        max_len=max_len,
        prefill_chunk=args.prefill_chunk,
        temperature=args.temperature,
        eos_id=args.eos_id,
        seed=args.seed,
        kv_mode=args.kv_mode,
        slot_state=args.slot_state,
        rec_slots=args.rec_slots,
        block_size=args.block_size,
        kv_blocks=args.kv_blocks,
        paged_kernel=args.paged_kernel,
        clock=args.clock)

    mesh = None
    if args.devices:
        if args.mode == "wave":
            print(f"note: --devices {args.devices} ignored in wave mode "
                  "(the baseline runs unsharded)")
        else:
            mesh = make_mesh((args.devices,), ("data",), device=device)

    print(f"arch={cfg.name} device={device} mode={args.mode} "
          f"kv={args.kv_mode} requests={args.requests} "
          f"prompt={args.prompt_len} gen={args.gen}"
          f"{f'±{args.gen_spread}' if args.gen_spread else ''} "
          f"slots={args.max_slots} arrival={args.arrival}"
          + (f" block_size={args.block_size}" if args.kv_mode == "paged"
             else "")
          + (f" devices={args.devices}" if args.devices else ""))

    counts = ("LAUNCHES", "MERGE_LAUNCHES", "MLA_LAUNCHES",
              "MLA_MERGE_LAUNCHES")
    before = {c: getattr(pa_ops, c) for c in counts}
    if args.mode == "wave":
        results, metrics = serve_waves(cfg, params, ecfg, requests)
        lowering = "wave: contiguous cache"
    else:
        engine = ServeEngine(cfg, params, ecfg, mesh=mesh)
        print(f"slot-state plan: {engine.plan.describe()}"
              + (f" ({engine.rec.capacity} recurrent rows)"
                 if engine.rec is not None else ""))
        results = engine.run(requests)
        metrics = engine.metrics
        lowering = (f"paged_kernel={engine.paged_kernel}" if engine.paged
                    else "contiguous cache")
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)

    print(metrics.report())
    n = {c: getattr(pa_ops, c) - before[c] for c in counts}
    print(f"paged_attention kernel launches: {n['LAUNCHES']} (merges "
          f"{n['MERGE_LAUNCHES']}), paged_mla_attention kernel launches: "
          f"{n['MLA_LAUNCHES']} (merges {n['MLA_MERGE_LAUNCHES']}) "
          f"({lowering}, {metrics.decode_steps} decode steps x "
          f"{cfg.num_layers} layers)")
    shown = sorted(results)[:2]
    print("sample outputs:", [results[i][:8] for i in shown])
    return results, metrics


def main(argv=None):
    from repro_torch.models.registry import get_config
    args = parse_args(argv)
    return run(get_config(args.arch), args)


if __name__ == "__main__":
    main()
