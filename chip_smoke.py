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
                shape.  The codec decode-add kernels (B1 bf16, B2 int8) are
                held to their plain versions BIT FOR BIT (ragged M, ±0,
                subnormal and ±Inf keep values, aligned and unaligned
                pointers), then timed with their plain versions and the
                one-call library yardsticks at the train phase's largest
                reduce hop.  The absorbed-MLA decode kernel (B8) against
                its plain version: r/dr 32/16 in f32 (block 16 and 4) and
                512/64 in bf16 at H 4, 16 and 128, ragged lengths (1, 16,
                17, 336, ...) over sentinel-padded tables, bf16 per output
                row relative to the row's RMS, NaN-poisoned unused and
                past-length slots; then kernel, plain version and gather +
                SDPA timed at DeepSeek's serve shape (B 8, H 128, lengths
                to 336);
  3. serve    — ``repro_torch.launch.serve.main`` on gemma2-2b at full
                width (bf16, random init, paged KV, 16 requests): all
                requests complete and the kernel's launch count equals
                26 x the engine's decode steps;
  4. decode   — one full-width decode step on one cache, through the kernel
                and through the gather-then-attend lowering: logits agree;
  5. train    — ``repro_torch.launch.train.run`` on gemma2-2b at its
                published widths with ONE cut, 26 -> 8 layers (memory: see
                ``TRAIN_CUT``): a BSP world of 4 ranks on the card, fractal
                schedule, 256 MB buckets, global batch 8 x 1024 tokens,
                3 steps with the bf16 wire codec, then 3 with int8.  Losses
                are finite and each codec's kernel launched exactly
                steps x buckets x log2(4) times; per-step time, tokens/s,
                peak memory, and the device idle share of one profiled
                step; one real bucket of gradients reduce-scattered through
                the kernels equals the same call through the plain
                versions, bit for bit;
  6. serve    — ``repro_torch.launch.serve.run`` on DeepSeek-V3 at its
                published widths with ONE cut, 61 -> 5 layers (3 dense MLA
                + 2 MLA+MoE, plus the MTP module; memory: see ``DS_CUT``),
                bf16, random init from seed 0, the same traffic as phase
                3: all requests complete, every token is below the vocab,
                and B8 launched 5 x the engine's decode steps;
  7. decode   — one DeepSeek decode step on one cache, through B8 and
                through the gather lowering: logits agree within
                ``DS_LOGIT_ATOL``; then a profiled step (host ms, device
                ms, idle share, B8's share, the expert GEMMs' share);
  8. an earlier line lists the kernels (JSON), and the last line is
     ``{"ok": true, "device": {...}}``.

Without CUDA, or without the repo's ``src/`` beside it, it exits 1 and
prints no result.
"""

import gc
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

# B1/B2 vs their plain versions: the same single rounding per element
# (bf16 widens exactly, int8 is one FMA), so equal bit for bit
CODEC_BF16_MS = [1, 127, 128, 513, (1 << 20) + 17]
CODEC_INT8_NBS = [1, 3, 8192]
# bytes each element of a decode-add moves: keep read + wire read + out
# written (int8: one f32 scale per 128 elements)
B1_BYTES_PER_ELEM = 4 + 2 + 4
B2_BYTES_PER_ELEM = 4 + 1 + 4 / 128 + 4

# The train phase's one cut.  Per parameter the step holds 2 B of bf16
# params, the [4, N] f32 gradients (16 B) and EF residual (16 B), and the
# ZeRO-1 moments (8 B): 42 B.  At 26 layers N = 2.614 B → 110 GB, more
# than the card's 80 GB; at 8 layers N = 589.8 M embedding + 8 x 77.87 M
# = 1.213 B → 50.9 GB, plus per-bucket temporaries and one rank's
# activations.  Widths, vocab, softcaps and window are the published ones.
TRAIN_CUT = dict(num_layers=8, layer_pattern=("local", "global") * 4)
TRAIN_WORLD, TRAIN_STEPS = 4, 3
TRAIN_ARGS = ["--arch", "gemma2-2b", "--device", "cuda", "--devices",
              str(TRAIN_WORLD), "--steps", str(TRAIN_STEPS), "--batch", "8",
              "--seq", "1024", "--schedule", "fractal", "--bucket-mb",
              "256", "--lr", "3e-4", "--seed", "0"]

# B8 (absorbed MLA) vs its plain version, per output row (b, h) relative
# to the row's RMS as for B7.  f32: F32_ATOL.  bf16: the kernel rounds
# each p and its output to bf16, so against ref.py in f32 on the same
# values (bf16 widens exactly) it is held to BF16_ROW_RTOL_F32 and to
# BF16_ATOL absolute.  The bf16 plain version also rounds each score
# product, a sum of r + dr = 576 terms of magnitude up to ~60 before the
# scale, to bf16, which moves its own output up to ~5.4e-2 of the row RMS
# from the f32 one (CPU rehearsal, tests/test_torch_smoke_mla_checks.py);
# against it the kernel is held to the sum of the two, MLA_BF16_ROW_RTOL.
# The rehearsal's block-dropping variant reads ~0.7 against f32 ref.py.
MLA_BF16_ROW_RTOL = 1e-1
# Cases: the smoke widths in f32, with the served block 16 and with 4 (a
# tile of 16 positions spans blocks); the full widths in bf16 at H 4, 16
# and 128 (H 128 is served; 4 and 16 leave heads of a block idle).
MLA_LENGTHS = [336, 17, 16, 1, 200, 77]
MLA_CASES = [dict(r=32, dr=16, H=4, bs=16, dtype="float32"),
             dict(r=32, dr=16, H=4, bs=4, dtype="float32"),
             dict(r=512, dr=64, H=4, bs=16, dtype="bfloat16"),
             dict(r=512, dr=64, H=16, bs=16, dtype="bfloat16"),
             dict(r=512, dr=64, H=128, bs=16, dtype="bfloat16")]
# bf16 tensor-core peak (H100 SXM data sheet), for B8's operation bound
BF16_FLOPS_PER_S = 989e12

# DeepSeek-V3's one cut: 61 -> 5 layers, all 3 dense MLA layers and 2 of
# the 58 MLA+MoE layers; every width as published.  One MoE layer holds
# 3 x 256 x 7168 x 2048 = 11.27 B expert parameters (22.5 GB in bf16), so
# 5 layers and the MTP module are 27,304,638,464 parameters, 54.6 GB; 6
# layers would be 77.6 GB of the card's 80 GB.
DS_CUT = dict(num_layers=5, layer_pattern=("mla",) * 3 + ("mla_moe",) * 2)
# full-width DeepSeek logits, B8 vs the gather lowering: the gather
# lowering rounds each score product to bf16, so the two attention
# outputs differ by up to ~5.2e-2 of the row RMS in each layer (phase 2,
# H 128); the residual stream is mostly attention output (the embedding
# is N(0, 0.02)), so 5 layers of independent errors move the final
# hidden state by about sqrt(5) x 5.2e-2 = 12 % and logits of magnitude
# <= ~4.85 (RMS-normed h against a head of scale 1/sqrt(7168)) by about
# 0.55.  A perturbed hidden state can also flip a router's top-8 pick
# near a tie, and the combine's bf16 index_add_ is atomic (the gather
# lowering against itself: 0.031).  An H100 80GB HBM3 at 700 W read
# 0.366 and 0.394.
DS_LOGIT_ATOL = 0.75

SERVE_ARGS = ["--arch", "gemma2-2b", "--device", "cuda", "--kv-mode",
              "paged", "--requests", "16", "--prompt-len", "256", "--gen",
              "64", "--gen-spread", "32", "--max-slots", "8",
              "--block-size", "16", "--prefill-chunk", "64", "--clock",
              "wall"]
DS_SERVE_ARGS = ["--arch", "deepseek-v3-671b"] + SERVE_ARGS[2:]


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
# phase 2: the absorbed-MLA decode kernel (B8) against its plain version
# ---------------------------------------------------------------------------


def _mla_inputs(torch, rng, *, lengths, H, r, dr, bs, dtype, dev,
                spare_blocks=3):
    """Latent pools with each row's blocks scattered through them, tables
    padded with the sentinel block 0, q_eff and q_rope; all random
    normal."""
    import numpy as np
    B = len(lengths)
    n = max(-(-L // bs) for L in lengths) + 1
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
    return (mk(B, H, r), mk(B, H, dr), mk(N, bs, r), mk(N, bs, dr),
            torch.from_numpy(tables).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def phase_mla_kernels(torch, ops, ref, dev):
    """B8 against ref.py in every ``MLA_CASES`` case, then with NaN in
    every slot no row may read.  Returns the largest absolute error
    against ref.py in the kernel's dtype and the largest bf16
    row-relative error against ref.py in f32."""
    import numpy as np
    rng = np.random.default_rng(4)
    worst_abs = worst_rel = 0.0
    for case in MLA_CASES:
        dtype = getattr(torch, case["dtype"])
        shp = {k: case[k] for k in ("H", "r", "dr", "bs")}
        qe, qr, ckv, kr, tables, lens = _mla_inputs(
            torch, rng, lengths=MLA_LENGTHS, dtype=dtype, dev=dev, **shp)
        scale = 1.0 / math.sqrt(128 + case["dr"])
        out = ops.paged_mla_attention_kernel(qe, qr, ckv, kr, tables, lens,
                                             scale=scale)
        want = ref.paged_mla_attention_ref(qe, qr, ckv, kr, tables, lens,
                                           scale=scale)
        err = (out.float() - want.float()).abs().max().item()
        rel = _row_rel_err(out, want)
        line = (f"  B8 {case['dtype']:8s} H={shp['H']} r={shp['r']} "
                f"dr={shp['dr']} bs={shp['bs']}: max|kernel-ref| = "
                f"{err:.3e}, per row / RMS(ref row) = {rel:.3e}")
        if dtype == torch.float32:
            ok = err <= F32_ATOL
            line += f" (atol {F32_ATOL:g})"
        else:
            want32 = ref.paged_mla_attention_ref(
                qe.float(), qr.float(), ckv.float(), kr.float(), tables,
                lens, scale=scale)
            err32 = (out.float() - want32).abs().max().item()
            rel32 = _row_rel_err(out, want32)
            ref_rel32 = _row_rel_err(want, want32)
            ok = rel <= MLA_BF16_ROW_RTOL and err32 <= BF16_ATOL \
                and rel32 <= BF16_ROW_RTOL_F32
            line += (f" (rtol {MLA_BF16_ROW_RTOL:g}); vs ref.py in f32: "
                     f"max|diff| {err32:.3e} (atol {BF16_ATOL:g}), per row "
                     f"{rel32:.3e} (rtol {BF16_ROW_RTOL_F32:g}); bf16 "
                     f"ref.py vs f32 {ref_rel32:.3e}")
            rel = rel32
        print(line)
        if not ok:
            raise AssertionError("paged_mla_attention kernel disagrees "
                                 "with ref.py: " + line.strip())
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, rel)
        # unused blocks and past-length slots hold NaN: never read
        dirty = ops.paged_mla_attention_kernel(
            qe, qr, _poison_unused(torch, ckv, tables, lens, shp["bs"]),
            _poison_unused(torch, kr, tables, lens, shp["bs"]), tables,
            lens, scale=scale)
        if not torch.equal(out, dirty):
            raise AssertionError("NaN in unread latent slots reached the "
                                 "B8 kernel's output: " + line.strip())
    print("  B8 poisoned unused and past-length slots: output unchanged, "
          "bit for bit")
    return worst_abs, worst_rel


def phase_mla_timing(torch, ops, ref, cfg, pools=24):
    """B8, its plain version and gather + SDPA at DeepSeek's serve shape:
    8 rows, 128 heads, r 512, dr 64, block 16, lengths of a late serve
    step (up to 336 = 21 blocks).  ``pools`` latent pool pairs (75 MB in
    all, more than the 50 MB L2) are cycled, as the decode step's expert
    weights flush the L2 between two layers' calls."""
    import numpy as np
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    m = cfg.mla
    B, bs, H = 8, 16, cfg.num_heads
    r, dr = m.kv_lora_rank, m.qk_rope_head_dim
    n = -(-(256 + 64 + 1) // bs)
    N = 1 + B * n
    lengths = rng.integers(257, n * bs + 1, size=B).astype(np.int32)
    tables = np.zeros((B, n), np.int32)
    for b in range(B):
        tables[b, :-(-int(lengths[b]) // bs)] = 1 + b * n + np.arange(
            -(-int(lengths[b]) // bs))
    tables_t = torch.from_numpy(tables).to(dev)
    lens_t = torch.from_numpy(lengths).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(
        torch.bfloat16)
    latents = [(mk(N, bs, r), mk(N, bs, dr)) for _ in range(pools)]
    qe, qr = mk(B, H, r), mk(B, H, dr)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + dr)
    S = n * bs
    mask = (torch.arange(S, device=dev)[None, :] <
            lens_t.long()[:, None])[:, None, None, :]      # [B,1,1,S]
    q_cat = torch.cat([qe, qr], dim=-1)[:, :, None, :]     # [B,H,1,r+dr]

    def kernel(i):
        ckv, kr = latents[i % pools]
        ops.paged_mla_attention_kernel(qe, qr, ckv, kr, tables_t, lens_t,
                                       scale=scale)

    def plain(i):
        ckv, kr = latents[i % pools]
        ref.paged_mla_attention_ref(qe, qr, ckv, kr, tables_t, lens_t,
                                    scale=scale)

    def library(i):
        ckv, kr = latents[i % pools]
        c = ref._gather(ckv, tables_t)                     # [B,S,r]
        k = torch.cat([c, ref._gather(kr, tables_t)], -1)  # [B,S,r+dr]
        F.scaled_dot_product_attention(
            q_cat, k[:, None].expand(B, H, S, r + dr),
            c[:, None].expand(B, H, S, r), attn_mask=mask, scale=scale)

    t = {}
    for name, fn in (("plain", plain), ("kernel", kernel),
                     ("kernel2", kernel), ("plain2", plain),
                     ("library", library)):
        t[name] = _time_ms(torch, fn, pools, reps=10)
    tot = int(lengths.sum())
    io_bytes = (qe.numel() + qr.numel() + B * H * r) * 2 + tables.nbytes \
        + lengths.nbytes
    lat_bytes = tot * (r + dr) * 2
    flops = tot * H * (2 * (r + dr) + 2 * r)
    t_bytes = (lat_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    gt = {k: v["graph"] for k, v in t.items()}
    res = dict(ms=min(gt["kernel"], gt["kernel2"]),
               plain_ms=min(gt["plain"], gt["plain2"]),
               library_ms=gt["library"], bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"  B8 serve shape: B={B} H={H} r={r} dr={dr} bs={bs} n={n} "
          f"bf16, lengths {lengths.tolist()}; {pools} latent pool pairs "
          f"cycled")
    for name, v in t.items():
        print(f"  B8 {name:8s}: {v['graph']:.5f} ms/call device (CUDA "
              f"graph), {v['eager']:.5f} ms/call eager (host included)")
    print(f"  B8 bound {res['bound_ms']:.5f} ms ({res['bound_by']}: "
          f"{lat_bytes + io_bytes} B at {HBM_BYTES_PER_S:.3g} B/s; {flops} "
          f"flop at {BF16_FLOPS_PER_S:.3g} flop/s, {t_ops:.5f} ms); "
          f"library = gather + SDPA over [c_kv | k_rope] keys, c_kv values")
    # how the kernel's time grows: every row at one length, then 1 row
    sweep = []
    for rows, L in ((B, 32), (B, 128), (B, S), (1, S)):
        lens_l = torch.full((rows,), L, dtype=torch.int32, device=dev)
        tab = tables_t[:rows].clone()
        tab[:, -(-L // bs):] = 0
        tab[:, :-(-L // bs)] = 1 + torch.arange(
            rows * -(-L // bs), dtype=torch.int32, device=dev).reshape(
                rows, -1)
        q_l, r_l = qe[:rows], qr[:rows]
        ms = _time_ms(torch, lambda i: ops.paged_mla_attention_kernel(
            q_l, r_l, *latents[i % pools], tab, lens_l, scale=scale),
            pools, reps=10)["graph"]
        sweep.append(f"B={rows} L={L}: {ms:.5f} ms")
    print("  B8 kernel, every row at length L: " + ", ".join(sweep))
    return res


# ---------------------------------------------------------------------------
# phase 2: the codec decode-add kernels (B1, B2) against their plain versions
# ---------------------------------------------------------------------------


def _codec_keep(torch, M, dev, seed):
    """Random normal keep values led by ±0, subnormals and ±Inf."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    keep = torch.randn(M + 1, generator=g, device=dev)
    special = torch.tensor([0.0, -0.0, 1e-42, -3e-39, float("inf"),
                            -float("inf")], device=dev)
    n = min(M + 1, len(special))
    keep[:n] = special[:n]
    return keep, g


def _same_bits(torch, a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _finite_err(torch, a, b):
    fin = torch.isfinite(b)
    return (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0


def phase_codec_kernels(torch, tops, tref, codecs, dev):
    """B1 and B2 against ref.py, bit for bit, on the vectorised path
    (aligned) and the scalar one (pointers 4 bytes off); returns the
    largest |kernel - ref| over finite outputs of each (0 when equal)."""
    worst = {"bf16": 0.0, "int8": 0.0}
    cases = [("bf16", M) for M in CODEC_BF16_MS] + \
        [("int8", nb * 128) for nb in CODEC_INT8_NBS]
    for name, M in cases:
        keep_all, g = _codec_keep(torch, M, dev, M)
        x_all = torch.randn(M + 1, generator=g, device=dev) * torch.exp(
            2 * torch.randn(M + 1, generator=g, device=dev))
        for off in (0, 1):
            keep, x = keep_all[off:off + M], x_all[off:off + M]
            wire = codecs[name].encode(x)
            if name == "bf16":
                got = tops.decode_add_bf16_kernel(keep, wire["x"])
                want = tref.decode_add_bf16(keep, wire["x"])
            else:
                got = tops.decode_add_int8_kernel(keep, wire["q"],
                                                  wire["scale"])
                want = tref.decode_add_int8(keep, wire["q"], wire["scale"])
            torch.cuda.synchronize()
            err = _finite_err(torch, got, want)
            same = _same_bits(torch, got, want)
            print(f"  {'B1' if name == 'bf16' else 'B2'} {name} M={M} "
                  f"{'aligned' if off == 0 else 'unaligned'}: "
                  f"{'bit-identical' if same else 'DIFFERS'} to ref.py "
                  f"(max finite |diff| {err:.3e})")
            if not same:
                raise AssertionError(f"decode_add {name} M={M} off={off} "
                                     "differs from ref.py")
            worst[name] = max(worst[name], err)
    return worst


def phase_codec_timing(torch, tops, tref, codecs, M):
    """B1, B2, their plain versions and the one-call library yardsticks
    (``torch.add`` with type promotion; ``torch.addcmul``) on one launch of
    ``M`` elements: the train phase's largest reduce hop (every rank's
    kept half of the largest bucket).  A CUDA graph of 3 calls, so
    launch overhead is out of the device time."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    keep = torch.randn(M, generator=g, device=dev)
    res = {}
    for name in ("bf16", "int8"):
        wire = codecs[name].encode(
            torch.randn(M, generator=g, device=dev))
        if name == "bf16":
            w = wire["x"]
            fns = dict(kernel=lambda i: tops.decode_add_bf16_kernel(keep, w),
                       plain=lambda i: tref.decode_add_bf16(keep, w),
                       library=lambda i: torch.add(keep, w))
            per = B1_BYTES_PER_ELEM
        else:
            q, sc = wire["q"], wire["scale"]
            k2, q2, s2 = keep.view(-1, 128), q.view(-1, 128), sc.view(-1, 1)
            fns = dict(kernel=lambda i: tops.decode_add_int8_kernel(keep, q,
                                                                    sc),
                       plain=lambda i: tref.decode_add_int8(keep, q, sc),
                       library=lambda i: torch.addcmul(k2, q2, s2))
            per = B2_BYTES_PER_ELEM
        t = {}
        for label in ("plain", "kernel", "kernel2", "plain2", "library"):
            t[label] = _time_ms(torch, fns[label.rstrip("2")], 3,
                                reps=3)["graph"]
        del wire
        bound = M * per / HBM_BYTES_PER_S * 1e3
        res[name] = dict(ms=min(t["kernel"], t["kernel2"]),
                         plain_ms=min(t["plain"], t["plain2"]),
                         library_ms=t["library"], bound_ms=bound,
                         bound_by="bytes")
        print(f"  {'B1' if name == 'bf16' else 'B2'} {name} M={M}: kernel "
              f"{res[name]['ms']:.4f} ms, plain {res[name]['plain_ms']:.4f}"
              f" ms, library {t['library']:.4f} ms, bound {bound:.4f} ms "
              f"({per:g} B/elem at {HBM_BYTES_PER_S:.3g} B/s); device time "
              f"per call from a CUDA graph of 3 calls")
    return res


# ---------------------------------------------------------------------------
# phases 3-4 and 6-7: full-width serving
# ---------------------------------------------------------------------------


def ds_config():
    """DeepSeek-V3 at its published widths, cut to ``DS_CUT``."""
    import dataclasses
    from repro_torch.models.registry import get_config
    return dataclasses.replace(get_config("deepseek-v3-671b"), **DS_CUT)


def phase_serve(torch, ops, cfg, argv):
    """The main serve path, ``launch.serve.run(cfg, args)``; the kernels'
    counts are set to 0 just before and read just after.  Returns the
    launches of the decode kernel of ``cfg``'s attention (B8 for MLA, B7
    otherwise), which must be one per layer per decode step."""
    from repro_torch.launch import serve as serve_cli
    dev = torch.device("cuda", 0)
    args = serve_cli.parse_args(argv)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.LAUNCHES = ops.MLA_LAUNCHES = 0
    t0 = time.perf_counter()
    results, metrics = serve_cli.run(cfg, args)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    gqa, mla = ops.LAUNCHES, ops.MLA_LAUNCHES
    name, launches, other = (("paged_mla_attention", mla, gqa) if cfg.mla
                             else ("paged_attention", gqa, mla))
    s = metrics.summary()
    if s["completed"] != args.requests or len(results) != args.requests:
        raise AssertionError(f"{s['completed']}/{args.requests} requests "
                             "completed")
    for rid, out in results.items():
        if not 1 <= len(out) <= args.gen or \
                not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"request {rid}: bad output {out[:8]}... "
                                 f"(vocab {cfg.vocab_size})")
    want = cfg.num_layers * metrics.decode_steps
    if launches != want or other != 0:
        raise AssertionError(
            f"{name} launches {launches} != {cfg.num_layers} layers x "
            f"{metrics.decode_steps} decode steps (other kernel: {other})")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  serve {cfg.name}: {s['completed']}/{args.requests} completed, "
          f"{s['tokens_out']} tokens (all < vocab {cfg.vocab_size}), "
          f"{metrics.decode_steps} decode steps, {launches} {name} "
          f"launches (= {cfg.num_layers} x decode steps), engine "
          f"{s['tokens_per_s']:.1f} tok/s over {s['wall_s']:.2f} s (run() "
          f"incl. init {wall:.2f} s), TTFT p50 {s['ttft_p50_s']:.3f} s / "
          f"p95 {s['ttft_p95_s']:.3f} s, peak memory {peak / 2**30:.2f} GiB "
          f"({peak / 1e9:.1f} GB)")
    return launches


def phase_decode_step(torch, cfg, dev, atol):
    """One decode step on one cache: kernel vs gather lowering (both twice
    for MoE models, whose bf16 combine is atomic: the ref-vs-ref spread is
    the run-to-run floor)."""
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
        lr2 = T.decode_step(params, cfg, *args, block_tables=bt,
                            paged_kernel="ref")[0] if cfg.moe else lr
    if tuple(lk.shape) != (B, 1, cfg.vocab_size) or \
            not torch.isfinite(lk).all():
        raise AssertionError("decode logits not finite / wrong shape")
    live = slice(0, B - 1)
    err = (lk[live] - lr[live]).abs().max().item()
    floor = (lr2[live] - lr[live]).abs().max().item()
    agree = (lk[live].argmax(-1) == lr[live].argmax(-1)).float().mean()
    print(f"  decode step {cfg.name}: max|logits(kernel) - logits(ref)| = "
          f"{err:.4e} (atol {atol}), ref vs ref again {floor:.4e}, "
          f"|logits| <= {lr[live].abs().max().item():.3f}, argmax agreement "
          f"{agree.item() * 100:.0f}%")
    if not err <= atol:
        raise AssertionError(f"decode logits differ by {err}")
    _profile_steps(torch, T, params, cfg, dev, prompt, row, args, bt)


def _self_device_us(evt):
    """An op's own device time (us) in a ``key_averages`` entry."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _profile_steps(torch, T, params, cfg, dev, prompt, row, args, bt):
    """Where a full-width step's time goes: host-clock time of one prefill
    chunk and one decode step (synchronised), and the profiler's device
    time per op for the decode step: B8's share for MLA models and the
    expert GEMMs' share (``aten::bmm`` over the [E, ...] expert stacks)
    for MoE models."""
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
                                 ProfilerActivity.CUDA],
                     record_shapes=cfg.moe is not None) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize(dev)
    from torch.autograd import DeviceType
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 3e3
    print(f"  decode step {step_ms:.2f} ms, prefill chunk (64 tokens) "
          f"{chunk_ms:.2f} ms (host clock, synchronised); device kernels "
          f"{busy:.2f} ms per decode step (profiler), so the card idles "
          f"{max(0.0, 1 - busy / step_ms) * 100:.1f}% of a decode step")
    if cfg.mla is not None:
        b8 = sum(_self_device_us(e) for e in prof.key_averages()
                 if "paged_mla" in e.key) / 3e3
        print(f"  B8: {b8:.4f} ms per decode step ({cfg.num_layers} "
              f"launches), {b8 / max(busy, 1e-9) * 100:.2f}% of its device "
              f"time")
    if cfg.moe is not None:
        E = cfg.moe.num_experts
        experts = sum(
            _self_device_us(e)
            for e in prof.key_averages(group_by_input_shape=True)
            if e.key == "aten::bmm" and any(
                len(sh) == 3 and sh[0] == E for sh in e.input_shapes)) / 3e3
        print(f"  expert GEMMs (aten::bmm over [{E}, ...] stacks): "
              f"{experts:.3f} ms per decode step, "
              f"{experts / max(busy, 1e-9) * 100:.1f}% of its device time")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12, max_name_column_width=40))


# ---------------------------------------------------------------------------
# phase 5: BSP training of gemma2-2b (8 layers) at world 4
# ---------------------------------------------------------------------------


def train_config():
    import dataclasses
    from repro_torch.models.registry import get_config
    return dataclasses.replace(get_config("gemma2-2b"), **TRAIN_CUT)


def train_args(codec):
    from repro_torch.launch import train as train_cli
    return train_cli.parse_args(TRAIN_ARGS + ["--bucket-codec", codec])


def train_engine(cfg, codec):
    """The bucket plan the train phase's runs use."""
    import torch
    from repro_torch.core.bsp import BSPConfig
    from repro_torch.core.superstep import engine_for
    from repro_torch.models import transformer as T
    from repro_torch.weights import reference_leaves
    args = train_args(codec)
    return engine_for(reference_leaves(T.init_params(cfg, device="meta"),
                                       cfg),
                      BSPConfig(bucket_mb=args.bucket_mb,
                                bucket_codec=codec),
                      args.devices, force_dtype=torch.float32)


def phase_train(torch, tops, cfg):
    """The main path: ``launch.train.run`` with each codec; the counts are
    set to 0 just before each run and read just after.  Returns each
    codec's launch count."""
    import numpy as np
    from repro_torch.launch import train as train_cli
    launches = {}
    for codec in ("bf16", "int8"):
        args = train_args(codec)
        print(f"  {codec}: {cfg.name} at published widths, cut to "
              f"{cfg.num_layers} layers (memory: 42 B per parameter); "
              f"world {args.devices} on one device")
        dev = torch.device(args.device)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        tops.BF16_LAUNCHES = tops.INT8_LAUNCHES = 0
        out = train_cli.run(cfg, args)
        counts = {"bf16": tops.BF16_LAUNCHES, "int8": tops.INT8_LAUNCHES}
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        n_b = out["engine"].n_buckets
        hist = out["history"]
        losses = [h["loss"] for h in hist]
        if len(losses) != args.steps or not np.all(np.isfinite(losses)):
            raise AssertionError(f"{codec}: losses {losses}")
        hops = args.devices.bit_length() - 1
        want = args.steps * n_b * hops
        other = "int8" if codec == "bf16" else "bf16"
        if counts[codec] != want or counts[other] != 0:
            raise AssertionError(
                f"{codec}: launches {counts}, want {want} of decode_add_"
                f"{codec} (= {args.steps} steps x {n_b} buckets x "
                f"log2({args.devices})) and none of the other")
        tokens = args.batch * args.seq
        for h in hist:
            print(f"  {codec} step {h['step']}: loss {h['loss']:.4f}, "
                  f"{h['sec']:.3f} s, {tokens / h['sec']:.0f} tokens/s")
        print(f"  {codec}: {counts[codec]} decode_add_{codec} launches = "
              f"{args.steps} steps x {n_b} buckets x {hops} hops; peak "
              f"memory {peak / 2**30:.2f} GiB ({peak / 1e9:.1f} GB)")
        launches[codec] = counts[codec]
        del out
    return launches


def _plain_decode_add(tref):
    def decode_add(keep, wire, codec):
        if codec.name == "bf16":
            return tref.decode_add_bf16(keep, wire["x"])
        return tref.decode_add_int8(keep, wire["q"], wire["scale"])
    return decode_add


def phase_train_profile(torch, cfg, tref, codecs):
    """One more int8 step outside the counted runs, profiled: host-clock
    time against the device's kernel time.  Then the largest bucket of
    real gradients (4 ranks' rows) reduce-scattered through the kernels
    and through the plain versions: equal bit for bit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import collectives as C
    from repro_torch.core.bsp import BSPConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import make_bsp_train_step
    from repro_torch.weights import reference_leaves
    args = train_args("int8")
    dev = torch.device(args.device)
    step, init_state = make_bsp_train_step(
        cfg, AdamWConfig(lr=args.lr, total_steps=args.steps,
                         warmup_steps=1),
        BSPConfig(bucket_mb=args.bucket_mb, bucket_codec="int8"),
        args.devices, device=dev)
    state = init_state(T.init_params(cfg, args.seed, device=dev))
    data = SyntheticLM(cfg, DataConfig(global_batch=args.batch,
                                       seq_len=args.seq, seed=args.seed))
    state, _ = step(state, data.batch(0))                 # warm
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, _ = step(state, data.batch(1))
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, data.batch(2))
        torch.cuda.synchronize(dev)
        wall_prof = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    b2 = [e.time_range.elapsed_us() for e in kernels
          if "decode_add_int8" in e.name]
    print(f"  int8 step: {wall:.3f} s on the host clock ({wall_prof:.3f} s "
          f"under the profiler); device kernels {busy:.3f} s (profiler), so "
          f"the card idles {max(0.0, 1 - busy / wall) * 100:.1f}% of the "
          f"step; loss {m['loss'].item():.4f}")
    share = sum(b2) / 1e4 / max(busy, 1e-9)
    print(f"  B2 in that step: {len(b2)} launches, {sum(b2) / 1e3:.3f} ms "
          f"of device time ({share:.2f}% of the step's kernels)")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12, max_name_column_width=40))
    state.flat_mu = state.flat_nu = state.ef_residual = None
    del prof

    engine = init_state.engine
    bkt = max(engine.buckets, key=lambda b: b.length)
    leaves = reference_leaves(state.params, cfg)
    flat = [t for leaf in leaves for t in leaf.parts]
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in data.batch(3).items()}
    world = args.devices
    rows = torch.zeros(world, bkt.length, device=dev)
    per = batch["tokens"].shape[0] // world
    for r in range(world):
        mb = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
        loss, _ = T.loss_fn(state.params, cfg, mb)
        it = iter(torch.autograd.grad(loss, flat))
        grads = [[next(it) for _ in leaf.parts] for leaf in leaves]
        engine.pack_bucket(bkt, grads, out=rows[r])
        del grads, it, loss
    with torch.no_grad():
        for name in ("bf16", "int8"):
            got = C.fractal_reduce_scatter(rows, codecs[name])
            kernel_op = C.decode_add
            C.decode_add = _plain_decode_add(tref)
            try:
                want = C.fractal_reduce_scatter(rows, codecs[name])
            finally:
                C.decode_add = kernel_op
            torch.cuda.synchronize(dev)
            same = _same_bits(torch, got, want)
            print(f"  real bucket b{bkt.index} ({world} x {bkt.length}"
                  f" f32 gradients): fractal_reduce_scatter with {name} "
                  f"through the kernels is "
                  f"{'bit-identical' if same else 'DIFFERENT'} to the plain"
                  f" versions")
            if not same:
                raise AssertionError(f"real-bucket reduce-scatter ({name}) "
                                     "differs between kernel and plain")
            del got, want


def _ptxas_summary(log: str):
    """One line per compiled kernel instantiation from ``-Xptxas -v``
    output: template arguments, registers, stack and spills."""
    import re
    out, label = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"I(13__nv_bfloat16|f)((?:Li\d+E)*)E", m.group(1))
            k = re.search(r"(decode_add_\w+?_kernel)ILb([01])E",
                          m.group(1))
            mla = re.search(r"(paged_mla_[a-z]+_kernel)", m.group(1))
            if mla is not None:        # B8: f32 (simt) and bf16 (mma)
                label = f" {mla.group(1)}"
            elif t is not None:
                label = "<{}>".format(",".join(
                    ["bf16" if t.group(1) != "f" else "f32"]
                    + re.findall(r"Li(\d+)E", t.group(2))))
            elif k is not None:        # decode-add kernels: <vectorised?>
                body = "vec" if k.group(2) == "1" else "scalar"
                label = f" {k.group(1)}<{body}>"
            else:
                label = f" {m.group(1)}"
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
    from repro_torch.kernels.tree_reduce import ops as tops, ref as tref
    from repro_torch.models.registry import get_config
    from repro_torch.optim.compression import Bf16Codec, Int8Codec

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

    dev = torch.device("cuda", 0)
    codecs = {"bf16": Bf16Codec(), "int8": Int8Codec()}
    print("[2] kernels vs plain versions", flush=True)
    max_err, max_rel = phase_kernels(torch, ops, ref, dev)
    timing = phase_timing(torch, ops, ref, get_config("gemma2-2b"))
    codec_err = phase_codec_kernels(torch, tops, tref, codecs, dev)
    cfg8 = train_config()
    plan = train_engine(cfg8, "int8")
    hop = plan.world * max(b.length for b in plan.buckets) // 2
    codec_timing = phase_codec_timing(torch, tops, tref, codecs, hop)
    ds = ds_config()
    mla_err, mla_rel = phase_mla_kernels(torch, ops, ref, dev)
    mla_timing = phase_mla_timing(torch, ops, ref, ds)

    gemma = get_config("gemma2-2b")
    print("[3] serve gemma2-2b at full width", flush=True)
    launches = phase_serve(torch, ops, gemma, SERVE_ARGS)

    print("[4] one decode step: kernel vs gather lowering", flush=True)
    phase_decode_step(torch, gemma, dev, LOGIT_ATOL)

    print(f"[5] train gemma2-2b ({cfg8.num_layers} of 26 layers) at world "
          f"{plan.world}", flush=True)
    train_launches = phase_train(torch, tops, cfg8)
    phase_train_profile(torch, cfg8, tref, codecs)

    # the gemma phases' params, caches and train state are gone; hand their
    # cached blocks back before DeepSeek's 54.6 GB of weights
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[6] serve DeepSeek-V3 at full width ({ds.num_layers} of 61 "
          f"layers)", flush=True)
    mla_launches = phase_serve(torch, ops, ds, DS_SERVE_ARGS)
    gc.collect()
    torch.cuda.empty_cache()

    print("[7] one DeepSeek decode step: B8 vs gather lowering", flush=True)
    phase_decode_step(torch, ds, dev, DS_LOGIT_ATOL)

    tr = "src/repro/kernels/tree_reduce/kernel.py"
    kernels = [dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/paged_attention/csrc/"
               "paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:90",
        launches=launches, max_abs_err=max_err, max_err=max_err,
        max_row_rel_err=max_rel, **timing)]
    for name, codec, line in (("decode_add_bf16", "bf16", 119),
                              ("decode_add_int8", "int8", 140)):
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/tree_reduce/csrc/tree_reduce.cu",
            replaces=f"{tr}:{line}", launches=train_launches[codec],
            max_abs_err=codec_err[codec], elements=hop,
            **codec_timing[codec]))
    kernels.append(dict(
        name="paged_mla_attention", route="cuda",
        source="src/repro_torch/kernels/paged_attention/csrc/"
               "paged_mla_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:174",
        launches=mla_launches, max_abs_err=mla_err,
        max_row_rel_err=mla_rel, **mla_timing))
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
