#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port starts on the card.  Phases, in order
(any failure raises and exits non-zero):

  1. build    — compile every CUDA kernel from ``src/repro_torch`` with
                nvcc (sm_90a), print the build seconds, the compiler's
                register/spill report and the card's name and power limit;
  2. kernels  — hold each kernel against its plain PyTorch version on the
                card: paged attention (B7) in f32 and bf16 (bf16 per output
                row, relative to the row's RMS), at gemma2-2b's shape
                (Hkv 4, G 2, d 256, bs 16) and three more shapes, ragged
                lengths up to 8192 over sentinel-padded tables, window
                None / 4096 / small, softcap None / 50; then time kernel,
                plain version and the gather + SDPA yardstick at the serve
                shape;
  3. serve    — ``repro_torch.launch.serve.main`` on gemma2-2b at full
                width (bf16, random init, paged KV, 16 requests): all
                requests complete and the kernel's launch count equals
                26 x the engine's decode steps;
  4. decode   — one full-width decode step on one cache, through the kernel
                and through the gather-then-attend lowering: logits agree;
  5. an earlier line lists the kernels (JSON), and the last line is
     ``{"ok": true, "device": {...}}``.

Without CUDA, or without the repo's ``src/`` beside it, it exits 1 and
prints no result.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM: HBM rate and the f32 rate outside the tensor cores (NVIDIA's
# data sheet), for the kernel's least time
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# kernel vs plain version (same inputs, same card):
#   f32 : the two sum the same products in another order and the kernel
#         normalises after the PV product (ref before): ~1e-7 relative on
#         outputs of magnitude <= 4, so 1e-5 absolute;
#   bf16: within 2e-2 absolute (one bf16 step is 2^-8 relative, on
#         outputs of magnitude <= 4).  A long row averages thousands of V
#         rows, so its outputs are ~0.02 in size and that bound cannot see
#         a fault confined to the long rows; the error of each output row
#         (b, h, g) is also taken relative to the RMS of that row of the
#         reference:
#         - against ref.py in f32 on the same values (bf16 inputs widen
#           exactly): the kernel rounds each p and its output to bf16
#           (2^-9 relative; the largest element of a row is ~4x its RMS),
#           so 2.5e-2;
#         - against ref.py in bf16: that version also rounds q.k to bf16
#           before the softmax, which moves its own output up to ~2.6e-2
#           of the row RMS from the f32 one, so 5e-2.
#         An H100 80GB HBM3 at 700 W read 3.5e-2 and 1.4e-2, with bf16
#         ref.py itself 2.9e-2 from f32.  tests/test_torch_smoke_checks.py
#         runs this phase on the CPU against an emulation of the kernel's
#         rounding, and against one that drops a V block of the long rows:
#         the latter reads 0.23 there, though its absolute error, 7.8e-3,
#         passes the absolute bound alone.
F32_ATOL = 1e-5
BF16_ATOL = 2e-2
BF16_ROW_RTOL_F32 = 2.5e-2
BF16_ROW_RTOL = 5e-2
# the kernel phase's cases: ragged rows past the 4096 window, over
# sentinel-padded tables; gemma2-2b's shape; the served query-head group
# (G 2) at one 16-byte chunk per lane in f32 too (d 128); wider groups;
# G above 8
KERNEL_LENGTHS = [8192, 6001, 4097, 300, 17, 1]
KERNEL_SHAPES = [dict(Hkv=4, G=2, d=256, bs=16),
                 dict(Hkv=4, G=2, d=128, bs=16),
                 dict(Hkv=2, G=4, d=128, bs=16),
                 dict(Hkv=1, G=12, d=64, bs=8)]
# full-width logits, kernel vs gather-then-attend lowering: both bf16
# models; their attention outputs differ by bf16 rounding (2^-8
# relative) and 26 residual layers compound it, on logits of magnitude
# ~3 (softcap 30)
LOGIT_ATOL = 0.25

SERVE_ARGS = ["--arch", "gemma2-2b", "--device", "cuda", "--kv-mode",
              "paged", "--requests", "16", "--prompt-len", "256", "--gen",
              "64", "--gen-spread", "32", "--max-slots", "8",
              "--block-size", "16", "--prefill-chunk", "64", "--clock",
              "wall"]


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: paged attention against its plain version
# ---------------------------------------------------------------------------


def _paged_inputs(torch, rng, *, lengths, Hkv, G, d, bs, dtype, dev,
                  spare_blocks=3):
    """Pools with each row's blocks scattered through them, tables padded
    with the sentinel block 0, q; all random normal."""
    import numpy as np
    B = len(lengths)
    n = max(-(-L // bs) for L in lengths)
    need = sum(-(-L // bs) for L in lengths)
    N = 1 + need + spare_blocks
    perm = rng.permutation(np.arange(1, N))
    tables = np.zeros((B, n), np.int32)
    used = 0
    for b, L in enumerate(lengths):
        nb = -(-L // bs)
        tables[b, :nb] = perm[used:used + nb]
        used += nb
    g = torch.Generator(device=dev)
    g.manual_seed(int(rng.integers(1 << 31)))
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    q = mk(B, Hkv, G, d)
    kp, vp = mk(N, bs, Hkv, d), mk(N, bs, Hkv, d)
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def _poison_unused(torch, pool, tables, lengths, bs):
    """A copy of ``pool`` with NaN at every position no row may read."""
    valid = torch.zeros(pool.shape[:2], dtype=torch.bool, device=pool.device)
    for b, L in enumerate(lengths.tolist()):
        p = torch.arange(L, device=pool.device)
        valid[tables[b, p // bs].long(), p % bs] = True
    out = pool.clone()
    out[~valid] = float("nan")
    return out


def _row_rel_err(got, want):
    """max over output rows (b, h, g) of max|got - want| / RMS(want row)."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return ((got - want).abs().amax(-1) / rms).max().item()


def phase_kernels(torch, ops, ref, dev):
    """Returns the largest absolute and the largest row-relative error of
    the kernel against its plain version, over every case."""
    import numpy as np
    rng = np.random.default_rng(0)
    worst_abs = worst_rel = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shp in KERNEL_SHAPES:
            q, kp, vp, tables, lens = _paged_inputs(
                torch, rng, lengths=KERNEL_LENGTHS, dtype=dtype, dev=dev,
                **shp)
            scale = 1.0 / math.sqrt(shp["d"])
            for window in (None, 4096, 100):
                for cap in (None, 50.0):
                    kw = dict(scale=scale, window=window, softcap=cap)
                    out = ops.paged_attention_kernel(q, kp, vp, tables, lens,
                                                     **kw)
                    want = ref.paged_attention_ref(q, kp, vp, tables, lens,
                                                   **kw)
                    err = (out.float() - want.float()).abs().max().item()
                    rel = _row_rel_err(out, want)
                    line = (f"  B7 {str(dtype)[6:]:8s} Hkv={shp['Hkv']} "
                            f"G={shp['G']} d={shp['d']} window={window} "
                            f"softcap={cap}: max|kernel-ref| = {err:.3e}, "
                            f"per row / RMS(ref row) = {rel:.3e}")
                    if dtype == torch.float32:
                        ok = err <= F32_ATOL
                        line += f" (atol {F32_ATOL:g})"
                    else:
                        want32 = ref.paged_attention_ref(
                            q.float(), kp.float(), vp.float(), tables, lens,
                            **kw)
                        rel32 = _row_rel_err(out, want32)
                        ref_rel32 = _row_rel_err(want, want32)
                        ok = err <= BF16_ATOL and rel <= BF16_ROW_RTOL \
                            and rel32 <= BF16_ROW_RTOL_F32
                        line += (f" (atol {BF16_ATOL:g}, rtol "
                                 f"{BF16_ROW_RTOL:g}); vs ref.py in "
                                 f"f32 {rel32:.3e} (rtol "
                                 f"{BF16_ROW_RTOL_F32:g}; bf16 ref.py "
                                 f"{ref_rel32:.3e})")
                    print(line)
                    if not ok:
                        raise AssertionError(
                            "paged_attention kernel disagrees with ref.py: "
                            + line.strip())
                    worst_abs = max(worst_abs, err)
                    worst_rel = max(worst_rel, rel)
            # masked slots hold NaN: the kernel must not read them
            clean = ops.paged_attention_kernel(q, kp, vp, tables, lens,
                                               scale=scale, softcap=50.0)
            dirty = ops.paged_attention_kernel(
                q, _poison_unused(torch, kp, tables, lens, shp["bs"]),
                _poison_unused(torch, vp, tables, lens, shp["bs"]), tables,
                lens, scale=scale, softcap=50.0)
            if not torch.equal(clean, dirty):
                raise AssertionError("NaN in masked pool slots reached the "
                                     "kernel's output")
    print(f"  B7 poisoned masked slots: output unchanged, bit for bit")
    return worst_abs, worst_rel


def _time_ms(torch, fn, calls, reps):
    """Per-call ms of ``fn(0..calls-1)``, two ways, CUDA events around
    ``reps`` rounds after a warm-up round: ``eager`` launches from Python
    each round (host overhead included); ``graph`` replays one CUDA graph
    holding the round (device time)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(calls):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    out = {}
    for mode in ("eager", "graph"):
        run = graph.replay if mode == "graph" else (
            lambda: [fn(i) for i in range(calls)])
        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        stop.record()
        torch.cuda.synchronize()
        out[mode] = start.elapsed_time(stop) / (reps * calls)
    return out


def phase_timing(torch, ops, ref, cfg):
    """Kernel, plain version and gather + SDPA at the serve shape: 8 rows,
    gemma2-2b's heads, lengths of a mid-serve step; one pool pair per layer
    (26, like the decode step), cycled so each call finds its pool cold in
    the 50 MB L2."""
    import numpy as np
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    B, bs = 8, 16
    Hkv, G, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim
    max_len = -(-(256 + 64 + 1) // bs) * bs
    n = max_len // bs
    N = 1 + B * n
    lengths = rng.integers(257, 321, size=B).astype(np.int32)
    tables = np.zeros((B, n), np.int32)
    for b in range(B):
        nb = -(-int(lengths[b]) // bs)
        tables[b, :nb] = 1 + b * n + np.arange(nb)
    tables_t = torch.from_numpy(tables).to(dev)
    lens_t = torch.from_numpy(lengths).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    layers = cfg.num_layers
    pools = [(torch.randn(N, bs, Hkv, d, generator=g, device=dev
                          ).to(torch.bfloat16),
              torch.randn(N, bs, Hkv, d, generator=g, device=dev
                          ).to(torch.bfloat16)) for _ in range(layers)]
    q = torch.randn(B, Hkv, G, d, generator=g, device=dev).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    cap = cfg.attn_softcap
    win = lambda i: cfg.sliding_window if i % 2 == 0 else None
    S = n * bs
    pos = torch.arange(S, device=dev)[None, None, None, :]
    L4 = lens_t.long()[:, None, None, None]
    masks = {w: ((pos < L4) if w is None else
                 ((pos < L4) & ((L4 - 1 - pos) < w))) for w in
             (None, cfg.sliding_window)}

    def kernel(i):
        kp, vp = pools[i % layers]
        ops.paged_attention_kernel(q, kp, vp, tables_t, lens_t, scale=scale,
                                   window=win(i), softcap=cap)

    def plain(i):
        kp, vp = pools[i % layers]
        ref.paged_attention_ref(q, kp, vp, tables_t, lens_t, scale=scale,
                                window=win(i), softcap=cap)

    def library(i):
        kp, vp = pools[i % layers]
        k = ref._gather(kp, tables_t).transpose(1, 2)
        v = ref._gather(vp, tables_t).transpose(1, 2)
        F.scaled_dot_product_attention(q, k, v, attn_mask=masks[win(i)],
                                       scale=scale)

    t = {}
    for name, fn in (("plain", plain), ("kernel", kernel),
                     ("kernel2", kernel), ("plain2", plain),
                     ("library", library)):
        t[name] = _time_ms(torch, fn, layers, reps=20)
    kv_bytes = int(lengths.sum()) * Hkv * 2 * d * 2
    io_bytes = 2 * q.numel() * 2 + tables.nbytes + lengths.nbytes
    flops = 2 * 2 * d * G * Hkv * int(lengths.sum())
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    g = {k: v["graph"] for k, v in t.items()}
    res = dict(ms=min(g["kernel"], g["kernel2"]),
               plain_ms=min(g["plain"], g["plain2"]),
               library_ms=g["library"], bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"  serve shape: B={B} Hkv={Hkv} G={G} d={d} bs={bs} n={n} "
          f"bf16, lengths {lengths.tolist()}, softcap {cap}, window "
          f"{cfg.sliding_window} on even layers; {layers} pool pairs "
          f"cycled")
    for name, v in t.items():
        print(f"  {name:8s}: {v['graph']:.5f} ms/call device (CUDA graph), "
              f"{v['eager']:.5f} ms/call eager (host included)")
    print(f"  bound {res['bound_ms']:.5f} ms ({res['bound_by']}: "
          f"{kv_bytes + io_bytes} B at {HBM_BYTES_PER_S:.3g} B/s, {flops} "
          f"flop at {F32_FLOPS_PER_S:.3g} flop/s); library = gather + "
          f"SDPA without the softcap")
    return res


# ---------------------------------------------------------------------------
# phases 3-4: full-width serving
# ---------------------------------------------------------------------------


def phase_serve(torch, ops):
    from repro_torch.launch import serve as serve_cli
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    results, metrics = serve_cli.main(SERVE_ARGS)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES
    s = metrics.summary()
    if s["completed"] != 16 or len(results) != 16:
        raise AssertionError(f"{s['completed']}/16 requests completed")
    for rid, out in results.items():
        if not 1 <= len(out) <= 64 or not all(0 <= t < 256_000 for t in out):
            raise AssertionError(f"request {rid}: bad output {out[:8]}...")
    want = 26 * metrics.decode_steps
    if launches != want:
        raise AssertionError(f"paged_attention launches {launches} != 26 x "
                             f"{metrics.decode_steps} decode steps")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  serve: 16/16 completed, {s['tokens_out']} tokens, "
          f"{metrics.decode_steps} decode steps, {launches} kernel launches "
          f"(= 26 x decode steps), engine {s['tokens_per_s']:.1f} tok/s "
          f"over {s['wall_s']:.2f} s (main() incl. init {wall:.2f} s), peak "
          f"memory {peak / 2**30:.2f} GiB")
    return launches


def phase_decode_step(torch, cfg, dev):
    """One decode step on one cache: kernel vs gather lowering."""
    import numpy as np
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, 1, device=dev)
    B, bs, C, plen = 8, 16, 64, 256
    n = -(-(plen + 65) // bs)
    cache = T.init_paged_cache(cfg, 1 + B * n, bs, device=dev)
    tables = np.zeros((B, n), np.int32)
    rng = np.random.default_rng(2)
    with torch.inference_mode():
        for b in range(B - 1):              # row B-1 stays masked
            tables[b] = 1 + b * n + np.arange(n)
            prompt = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, size=(1, plen))).to(dev)
            row = torch.from_numpy(tables[b:b + 1]).to(dev)
            for s in range(0, plen, C):
                _, cache = T.prefill_chunk(params, cfg, prompt[:, s:s + C],
                                           cache, s, with_logits=False,
                                           block_tables=row)
        offs = np.full(B, plen, np.int32)
        offs[-1] = n * bs - 1
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            size=(B, 1))).to(dev)
        args = (tok, cache, torch.from_numpy(offs).to(dev))
        bt = torch.from_numpy(tables).to(dev)
        lk, _ = T.decode_step(params, cfg, *args, block_tables=bt,
                              paged_kernel="auto")
        lr, _ = T.decode_step(params, cfg, *args, block_tables=bt,
                              paged_kernel="ref")
    if tuple(lk.shape) != (B, 1, cfg.vocab_size) or \
            not torch.isfinite(lk).all():
        raise AssertionError("decode logits not finite / wrong shape")
    err = (lk[:B - 1] - lr[:B - 1]).abs().max().item()
    agree = (lk[:B - 1].argmax(-1) == lr[:B - 1].argmax(-1)).float().mean()
    print(f"  decode step: max|logits(kernel) - logits(ref)| = {err:.4e} "
          f"(atol {LOGIT_ATOL}), |logits| <= "
          f"{lr[:B - 1].abs().max().item():.3f}, argmax agreement "
          f"{agree.item() * 100:.0f}%")
    if not err <= LOGIT_ATOL:
        raise AssertionError(f"decode logits differ by {err}")
    _profile_steps(torch, T, params, cfg, dev, prompt, row, args, bt)


def _profile_steps(torch, T, params, cfg, dev, prompt, row, args, bt):
    """Where a full-width step's time goes: host-clock time of one prefill
    chunk and one decode step (synchronised), and the profiler's device
    time per op for the decode step."""
    from torch.profiler import ProfilerActivity, profile

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / reps * 1e3

    with torch.inference_mode():
        step = lambda: T.decode_step(params, cfg, *args, block_tables=bt,
                                     paged_kernel="auto")
        chunk = lambda: T.prefill_chunk(params, cfg, prompt[:, :64],
                                        args[1], 0, with_logits=False,
                                        block_tables=row)
        step_ms, chunk_ms = timed(step), timed(chunk)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize(dev)
    from torch.autograd import DeviceType
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 3e3
    print(f"  decode step {step_ms:.2f} ms, prefill chunk (64 tokens) "
          f"{chunk_ms:.2f} ms (host clock, synchronised); device kernels "
          f"{busy:.2f} ms per decode step (profiler), so the card idles "
          f"{max(0.0, 1 - busy / step_ms) * 100:.0f}% of a decode step")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12, max_name_column_width=40))


def _ptxas_summary(log: str):
    """One line per compiled kernel instantiation from ``-Xptxas -v``
    output: template arguments, registers, stack and spills."""
    import re
    out, label = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"I(13__nv_bfloat16|f)((?:Li\d+E)*)E", m.group(1))
            label = "<?>" if t is None else "<{}>".format(",".join(
                ["bf16" if t.group(1) != "f" else "f32"]
                + re.findall(r"Li(\d+)E", t.group(2))))
            spill = ""
        elif label and "spill" in line:
            spill = line.strip()
        elif label and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{label}: {regs.group(1) if regs else '?'} "
                       f"registers; {spill}")
            label = None
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found (run from the "
              "repo root checkout)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.models.registry import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    print(f"[1] build  (card: {smi})", flush=True)
    t0 = time.perf_counter()
    libs = build.build()
    print(f"  built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for name in libs:
        for line in _ptxas_summary(build.build_log(name)):
            print(f"  ptxas {name}{line}")

    print("[2] kernels vs plain versions", flush=True)
    max_err, max_rel = phase_kernels(torch, ops, ref,
                                     torch.device("cuda", 0))
    timing = phase_timing(torch, ops, ref, get_config("gemma2-2b"))

    print("[3] serve gemma2-2b at full width", flush=True)
    launches = phase_serve(torch, ops)

    print("[4] one decode step: kernel vs gather lowering", flush=True)
    phase_decode_step(torch, get_config("gemma2-2b"), torch.device("cuda", 0))

    kernels = [dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/paged_attention/csrc/"
               "paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:90",
        launches=launches, max_abs_err=max_err, max_err=max_err,
        max_row_rel_err=max_rel, **timing)]
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
