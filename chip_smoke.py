#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port starts on the card.  Phases, in order
(any failure raises and exits non-zero):

  1. build    — compile every CUDA kernel from ``src/repro_torch`` with
                nvcc (sm_90a), print the build seconds, the compiler's
                register/spill report and the card's name and power limit;
  2. kernels  — hold each kernel against its plain PyTorch version on the
                card.  First the public kernel ops' kernels (slice 4):
                the tree sums (B3, B4) bit for bit at N 1 to 100 and
                ragged widths, f32/bf16 in and out, with ±0, ±Inf and
                subnormal columns, each case on the kernel it must take
                (the bulk-copy ring for rows and pointers on 16 bytes,
                else the ragged kernel), at the ring's tile edges, at a
                width that wraps every ring block's stages more than
                twice and on views off 16 bytes; then both at N 8-100
                in guard bytes (no stray write, every output and scratch
                element written, bit for bit twice); the GEMM (B6) at gemma2-2b's MLP
                up-projection, a DeepSeek-V3 decode projection, a
                ragged shape in f32 and bf16 and the wgmma kernel's tile
                edges (each case on its kernel: wgmma, mma or f32);
                flash attention (B5) at gemma2-2b's global layer (with
                the autograd backward) and local 8192-token layer,
                DeepSeek-V3's MLA prefill, the two padding cases, a
                window whose last rows see no key and the wgmma
                kernel's tile edges, NaN past Tk; each call must add one
                to its launch count and to its kernel's count by path;
                then the public op on what the strict kernel wrapper
                refuses (D 72 / Dv 40, inputs off 16 bytes; D past 256
                must raise).
                Then B3-B6 timed beside their plain versions, library
                yardsticks (``torch.sum``, ``torch.matmul``, SDPA with
                and without the softcap on B5's side) and bounds, B6
                also at the decode projection on its wgmma and its mma
                path, and the ops path: the public ops driven once at those
                shapes, their four counts (and B5's and B6's counts by
                path, and B3's and B4's: the ring) set to 0 just
                before and read just after.  Then paged attention (B7) in f32 and bf16
                (bf16 per output row, relative to the row's RMS), at
                gemma2-2b's shape
                (Hkv 4, G 2, d 256, bs 16), three more shapes and the
                decode shapes of qwen2.5-3b (G 8), phi4-mini-3.8b (G 3),
                qwen3-moe (G 16), granite-34b (G 48) and
                jamba-v0.1-52b (Hkv 8, G 4), all d 128, ragged
                lengths up to 8192 over sentinel-padded tables, window
                None / 4096 / small, softcap None / 50; then time kernel
                (split kernel + merge), plain version and the gather +
                SDPA yardstick at the serve shape, at its lengths over
                tables of the full context (n 512) and at gemma2-2b's
                full context (8 rows of 8192), and the kernel over
                lengths 1 to 8192 (intercept and slope).  The codec decode-add kernels
                (B1 bf16, B2 int8) are held to their plain versions BIT
                FOR BIT (ragged M, ±0,
                subnormal and ±Inf keep values, aligned and unaligned
                pointers), then timed with their plain versions and the
                one-call library yardsticks at the train phase's largest
                reduce hop.  EF's kernel (the port's own, for the BSP
                sync's ``bsp.ef``) against the eager sequence it replaced,
                bit for bit with NaN equal to NaN (zero, -0, NaN, inf,
                subnormal, tie and code-edge runs; strided residuals; each
                case on its vector or scalar path), after a line on how
                ``torch.addcmul`` rounds on the card; then, at the int8
                benchmark cell's largest bucket laid out as the step lays
                it (residual offsets past 2^31), kernel and eager sequence
                compared bit for bit and timed beside the 16 B-an-element
                bound.  The
                absorbed-MLA decode kernel (B8) against
                its plain version: r/dr 32/16 in f32 (block 16 and 4) and
                512/64 in bf16 at H 4, 16 and 128, ragged lengths (1, 16,
                17, 336, ...) over sentinel-padded tables, bf16 per output
                row relative to the row's RMS, NaN-poisoned unused and
                past-length slots; then kernel, plain version and gather +
                SDPA timed at DeepSeek's serve shape (B 8, H 128, lengths
                to 336), at its lengths over tables of n 256 and at 8 rows
                of 4096.  Then B7 and B8 at each of their check cases once
                more, on copies of their inputs, partial states and
                outputs inside guard bytes (NaN, bad block ids) and over
                tables wider than any row: no write outside a buffer, no
                read past an input, every partial state written, the
                output bit for bit the same twice and as unguarded;
  2b. table1 — the paper's Table 1 from the port's event simulator, on
                the host: every mesh equal to the cycles
                ``tests/test_table1_regression.py`` pins, the FractalSync
                ratios 1.00, and the host seconds it took;
  2c. schedules — ``all_reduce`` and ``reduce_scatter`` of every
                schedule (world 4 and 8; xy and hierarchical at 2 x 4;
                ring, xy and naive at world 6, all-reduce only) ``==``
                the sum over ranks on 256 MB a rank of small integers,
                and bit for bit the CPU lowering on random f32; each
                lowering once with no synchronising call; each
                all-reduce timed at world 4 (row permutations in the
                card's memory, not a network);
  3. serve    — ``repro_torch.launch.serve.main`` on gemma2-2b at full
                width (bf16, random init, paged KV, 16 requests): all
                requests complete and the kernel's and its merge's launch
                counts each equal 26 x the engine's decode steps;
  4. decode   — one full-width decode step on one cache, through the kernel
                and through the gather-then-attend lowering: logits agree;
                one more under torch.cuda.set_sync_debug_mode("error"):
                the decode forward makes no synchronising call;
  3q. serve   — phases 3 and 4 for qwen2.5-3b at full published width,
                all 36 layers (QKV bias, tied embeddings, GQA kv 2): B7
                and its merge 36 x decode steps each, logits within
                ``QWEN_LOGIT_ATOL``, tok/s, TTFT, decode step, idle share,
                peak memory;
  5. train    — ``repro_torch.launch.train.run`` on gemma2-2b at its
                published widths with ONE cut, 26 -> 8 layers (memory: see
                ``TRAIN_CUT``): a BSP world of 4 ranks on the card, fractal
                schedule, 256 MB buckets, global batch 8 x 1024 tokens,
                3 steps with the bf16 wire codec, then 3 with int8.  Losses
                are finite and each codec's kernel launched exactly
                steps x buckets x log2(4) times, EF's kernel steps x
                buckets times; per-step time, tokens/s,
                peak memory, and the device idle share of one profiled
                step; one real bucket of gradients reduce-scattered through
                the kernels equals the same call through the plain
                versions, bit for bit;
  5b. auto    — the slice-8 main path: the same run (3 steps) with
                ``--schedule auto --bucket-mb auto --bucket-codec auto``:
                the plan (buckets, sizes, schedule + codec each) is
                printed, B1/B2 launched exactly steps x (buckets with
                that codec) x log2(4) times, finite losses, step 0's loss
                equal to phase 5's; step time, tokens/s, peak memory and
                a profiled step's idle share;
  5c. forced  — one step each of ``--schedule ring`` and ``tree`` with
                ``--bucket-codec int8`` (normalised away) at 2 layers: no
                decode-add launch, a finite loss;
  5d. README  — the README's training command at full width: qwen2.5-3b
                cut to 10 layers (``QWEN_TRAIN_CUT``), world 4, all auto,
                8 x 1024 tokens, 3 steps: the plan, B1/B2 launches = steps
                x buckets with the codec x 2, every bucket's real
                gradients through B2 and its plain version bit for bit,
                step time, tokens/s, peak memory, idle share;
  5e. soak    — ``runtime.soak.run_train_soak`` at the reference's
                ``TrainSoakConfig`` on qwen2.5-3b cut to 2 layers with
                1024-token rows: uneven shares actuated for the slow rank,
                the killed rank's world re-meshed 8 -> 4 onto a level-2
                fsync domain, the params restored from a checkpoint and
                the replay checked by ``check_train_soak``; one step each
                of even and uneven shares first, bit for bit; every save's
                and the restore's bytes and seconds;
  6. serve    — ``repro_torch.launch.serve.run`` on DeepSeek-V3 at its
                published widths with ONE cut, 61 -> 5 layers (3 dense MLA
                + 2 MLA+MoE, plus the MTP module; memory: see ``DS_CUT``),
                bf16, random init from seed 0, the same traffic as phase
                3: all requests complete, every token is below the vocab,
                and B8 and its merge each launched 5 x the engine's
                decode steps;
  7. decode   — one DeepSeek decode step on one cache, through B8 and
                through the gather lowering: logits agree within
                ``DS_LOGIT_ATOL``; one step with no synchronising call, as
                in 4; then a profiled step (host ms, device ms, idle share,
                B8's share, the expert GEMMs' share);
  slice 10 (the contiguous KV cache, the wave oracle, recurrent and
  hybrid serving, the serve soak):
  3c. contig  — phase 3's traffic with ``--kv-mode contiguous`` (the
                CLI's default): all requests complete, no paged-attention
                launch, tok/s, TTFT, peak memory; phase 4 also runs the
                decode step over a contiguous cache beside the paged one
                (logits within ``LOGIT_ATOL``, no synchronising call, a
                profiled step's idle share);
  3w. wave    — ``--mode wave`` (``serve_waves``, the token-identity
                oracle) on the same requests: first-token logits of every
                request within ``WAVE_LOGIT_ATOL`` of the continuous
                engine's, the fraction of token-identical outputs printed
                (bf16 GEMMs may round differently at wave batch 8 than at
                chunk batch 1; the CPU tests assert identity in f32);
  3s. soak    — ``serve.soak.run_soak`` at the reference's smoke soak
                (2000 virtual steps, bursty arrivals, one admission stall
                and one window with half the block pool confiscated) on
                gemma2-2b's widths cut to ``SERVE_SOAK_CUT``: no failure,
                the baseline p99, the recovery step, B7 launched once per
                layer per decode step;
  3x. xlstm   — xlstm-1.3b at published widths with ONE cut, 48 -> 24
                layers (``XLSTM_SERVE_CUT``, 1.11 B params, 336 MiB of f32
                state a request): phase 3's
                traffic, continuous and wave, with 3c's and 3w's checks
                (no paged-attention launch; the wave within
                ``XLSTM_WAVE_LOGIT_ATOL``); the decode step's host and
                device ms, idle share and the prefill's seconds (the eager
                per-token scan);
  6c.         — phase 7 also runs DeepSeek's decode step over the
                contiguous latent cache beside the paged one (logits
                within ``DS_LOGIT_ATOL``);
  8. jamba    — jamba-v0.1-52b at published widths with ONE cut, 32 ->
                16 layers (``JAMBA_CUT``): phase 3's traffic (a) paged
                with 4 recurrent rows for 8 slots (B7 and its merge 2 x
                decode steps; every row and block back in its pool), (b)
                contiguous (no paged-attention launch), (c) one decode
                step paged vs contiguous within ``JAMBA_LOGIT_ATOL``, and
                the profiled step's idle share and expert share;
  slice 11 (training the MTP, MoE and recurrent models; every train
  phase, 5-5e too, now checkpoints each scanned unit, as the reference):
  5f. xlstm   — ``launch.train.run`` on xlstm-1.3b at published widths
                with ONE cut, 48 -> 8 layers (``XLSTM_TRAIN_CUT``), world
                4, all auto, 4 x 512 tokens (two 256-step time chunks a
                scan), 2 steps: finite losses, B1/B2 launches = steps x
                buckets with the codec x 2, the plan, step time,
                tokens/s, peak memory, the last step's idle share (NVML
                utilization), every codec'd bucket's real gradients
                through B2 and its plain version bit for bit;
  5g. jamba   — one bf16 and one f32 ``loss_fn`` + ``autograd.grad`` of
                Jamba's first two layers (``JAMBA_GRAD_CUT``) on 2 x 512
                tokens: loss, metrics and each leaf's cosine and relative
                difference within ``JAMBA_GRAD_BOUNDS``, experts no token
                picked with zero gradients, the loss the sum of its terms;
  5h. mtp     — the same for DeepSeek-V3 with one MLA layer and its MTP
                module (``DS_GRAD_CUT``, ``DS_GRAD_BOUNDS``): ``loss ==
                xent + 0.3 mtp + 0.01 aux`` to f32 rounding;
  slice 12 (the frontend models, trained and decoded; the fitted link):
  5i. pali    — ``launch.train.run`` on paligemma-3b at published widths
                with ONE cut, 18 -> 6 layers (``PALI_TRAIN_CUT``), world
                4, all auto, 8 rows of 256 image-stub embeddings + 1792
                text tokens (2048 positions: the prefix-LM on the blocked
                attention path), 3 steps: phase 5b's checks and prints
                (tokens/s over the text tokens);
  5j. musicgen — the same on musicgen-medium at full depth, 48 layers
                (``MUSICGEN_TRAIN_CUT``), 8 x (64 + 1024);
  3p. decode  — paligemma-3b at full width, no cut: 8 rows of 256 + 64
                through model-level ``prefill``, 32 greedy
                ``decode_step``s over the contiguous cache; the logits
                within ``FRONTEND_LOGIT_RTOL`` of ``forward`` per row,
                the bidirectional prefix and causal text, no
                synchronising call; prefill ms, decode step (host clock,
                device kernels, idle share), peak memory;
  3m. decode  — the same for musicgen-medium, 48 layers, 64 + 64 (its
                sinusoid at decode offsets; a causal prefix);
  5k. link    — ``calibrate.fit_link_params`` at world 4 on the card over
                the reference's grid; the all-auto plans of gemma2-2b at 2
                layers and of musicgen-medium at 2 layers priced with
                ``TPU_V5E_ICI`` and with the fitted link; ``launch.train
                --calibrate --checkpoint-dir D`` on the latter, 1 step,
                then its resume (``calibrate: reloaded``, the same plan);
                B1/B2 launches = steps x buckets with the codec x 2;
                every codec bucket of the calibrated plan reduce-scattered
                bit for bit through the kernels and the plain versions;
  slice 13 (the sharding surface: meshes of virtual devices on the card):
  4m. mesh    — after phase 4: phase 3's and 3c's traffic with
                ``--devices 4`` (the slot batch sharded over a ("data",)
                mesh): every request token-identical to phases 3 and 3c,
                B7's launches and merges equal to phase 3's; ``--max-slots
                6 --devices 4`` raises the reference's ``ValueError``; one
                paged decode step profiled without and with the serving
                policy ``make_decode_step`` sets (host ms, device ms, idle
                share; the hooks a step calls and each one's host cost);
  5l. gspmd   — after phase 5c: ``launch.train.run --schedule xla
                --devices 4`` on gemma2-2b at full width and depth, no cut
                (``GSPMD_ARGS``; memory reckoned before the run), 3 steps:
                finite losses, step time, tokens/s, peak memory, a
                profiled step's idle share; then one step at phase 5's 8
                layers, whose step-0 loss must be within
                ``GSPMD_LOSS_ATOL`` of phase 5's fractal step-0 loss;
  5m. tiers   — the reference's ``bsp_equivalence_check`` on the card:
                gemma2-2b at 2 layers (``EQUIV_CUT``), world 4,
                ``grad_clip=0``, 2 steps each of the GSPMD step and the
                fractal superstep with no codec: losses within
                ``EQUIV_LOSS_ATOL``, every param element within 2·lr + one
                bf16 ulp a step of the other tier's; the largest gaps;
  9. dryrun  — slice 14, after phase 5m, on no kernel: (a)
                ``python -m repro_torch.launch.dryrun`` on three
                production cells (``DRYRUN_CELLS``, both meshes, each cell
                a process of its own, all at once): every record ``ok``,
                its trace seconds and roofline terms; (b) phase 5l's step
                (gemma2-2b, 26 layers, 8 x 1024, mesh (4, 1)) under
                ``remat=block`` and ``remat=dots``: traced on ``meta``
                through ``hlo_analysis.analyze_program``, then one step
                on the card inside the same counter: the FLOP and dot
                counts equal, the traced argument bytes equal the state's
                and batch's on the card, the traced peak of live storage
                within ``DRYRUN_PEAK_RTOL`` of the allocator's; the step
                time against the H100 floor (the traced FLOPs and the
                minimal bytes at peak rates) and, no bound, the eager
                op-by-op traffic at peak bandwidth; dots'
                step-0 loss equal to block's bit for bit and its params
                within phase 5m's bound of block's;
  last: a line lists the kernels (JSON), and the last line is
     ``{"ok": true, "device": {...}}``.

Without CUDA, or without the repo's ``src/`` beside it, it exits 1 and
prints no result.

    python3 chip_smoke.py --decode-timings OTHER/src

times only B7 and B8 (phase 2's serve, wide-table and long-context
shapes, B7's length sweep) with the kernels of another checkout: a
change to the paged decode kernels is compared with its parent in one
run on one card (parent, change, change, parent).

    python3 chip_smoke.py --tree-timings OTHER/src

does the same for the tree sums: B3 (f32 rows, bf16 rows into f32) and
B4 at 8 rows of a 256 MB bucket beside ``torch.sum`` and the bound.

    python3 chip_smoke.py --remat-timings src

runs the train runs of phases 5b and 5d with the training remat off and
on (none, block, block, none) and prints each run's step time and peak.

    python3 chip_smoke.py --calibrate-runs src

runs phase 5k ``CALIBRATE_RUNS`` times (a fresh fit each, so the plans
and the codec buckets held to the plain versions vary) and prints each
run's fitted link, plan and decode-add launches.
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
# G above 8; then the decode shapes of the attention archs of slice 9, all
# at d 128: qwen2.5-3b (Hkv 2, G 8: one full pass of kMaxG = 8 query
# heads), phi4-mini-3.8b (Hkv 8, G 3, padded to 4), qwen3-moe-235b-a22b
# (Hkv 4, G 16: two passes over the KV rows) and granite-34b (MQA, G 48:
# six passes)
KERNEL_LENGTHS = [8192, 6001, 4097, 300, 17, 1]
KERNEL_SHAPES = [dict(Hkv=4, G=2, d=256, bs=16),
                 dict(Hkv=4, G=2, d=128, bs=16),
                 dict(Hkv=2, G=4, d=128, bs=16),
                 dict(Hkv=1, G=12, d=64, bs=8),
                 dict(Hkv=2, G=8, d=128, bs=16),
                 dict(Hkv=8, G=3, d=128, bs=16),
                 dict(Hkv=4, G=16, d=128, bs=16),
                 dict(Hkv=1, G=48, d=128, bs=16),
                 # slice 10: jamba-v0.1-52b's attention layers (Hkv 8,
                 # G 4, no window, no softcap when served)
                 dict(Hkv=8, G=4, d=128, bs=16)]
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

# EF in one pass (kernels/codec) vs the eager sequence it replaced on the
# card: the same roundings, so equal bit for bit (NaN where it has NaN).
# (codec, W, L, the residual's row stride (the state's width), its column
# offset, g's offset in its storage, the path the case must take); the
# second case of each codec has more chunks of 128 than the persistent grid
# has warps (132 x 8 x 8), so warps take several; bf16's L 1000 and
# 384,132 end in a short chunk.
EF_CASES = [("int8", 4, 128 * 40, 128 * 42, 128, 0, "vector"),
            ("int8", 4, 128 * 3001, 128 * 3004, 256, 0, "vector"),
            ("int8", 2, 128 * 12, 128 * 12 + 3, 0, 0, "scalar"),
            ("int8", 3, 128 * 12, 128 * 13, 128, 1, "scalar"),
            ("bf16", 4, 1000, 1152, 128, 0, "vector"),
            ("bf16", 4, 128 * 3001 + 4, 128 * 3004, 4, 0, "vector"),
            ("bf16", 2, 1001, 1003, 1, 0, "scalar"),
            ("bf16", 3, 130, 131, 0, 2, "scalar")]
# timed at the int8 cell's largest bucket (qwen2.5-3b at 10 layers,
# --bucket-mb 256, world 4: its last bucket), the residual that bucket's
# columns of the [4, total] state; EF reads g and r and writes both
EF_TIME_W, EF_TIME_L = 4, 311_164_928
EF_TIME_TOTAL, EF_TIME_OFF = 1_081_936_896, 770_771_968
EF_BYTES_PER_ELEM = 16

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
# The slice-8 main path: the same run with every choice left to the
# autotuner (schedule and codec per bucket, the DP bucket boundaries).
# Its plan (8 buckets of 226-2586 MB, fractal + int8 each at world 4)
# holds about what the fixed int8 run holds.
TRAIN_AUTO = ["--schedule", "auto", "--bucket-mb", "auto",
              "--bucket-codec", "auto"]
# A forced non-fractal schedule through the CLI, one step each, at 2 layers
# (an earlier path's depth, cut to save time): the int8 codec is asked for
# and normalised away, so no decode-add kernel may launch.
TRAIN_FORCED = ("ring", "tree")
TRAIN_FORCED_CUT = dict(num_layers=2, layer_pattern=("local", "global"))

# Table 1 as ``tests/test_table1_regression.py`` pins it:
#   {mesh: (fsync, fsync_p, naive, xy)} simulated cycles
TABLE1_PINNED = {"Neighbor": (4, 4, 75, 75), "2x2": (6, 6, 135, 192),
                 "4x4": (10, 10, 573, 359), "8x8": (14, 18, 2350, 734),
                 "16x16": (18, 34, 9381, 1683)}
# Every schedule on the card: (mesh shape, schedules).  Payloads per rank:
# one real bucket, 64 Mi f32 elements (256 MB; at world 6 the largest
# multiple of 6 x 128 below it), of small integers so that every order of
# the adds is exact; and a small random one, held bit for bit to the same
# lowering on the CPU.  Reduce-scatter needs a power-of-two world.
SCHEDULE_SHAPES = [((4,), ("fractal", "ring", "xy", "naive", "hierarchical",
                           "tree", "xla")),
                   ((8,), ("fractal", "ring", "xy", "naive", "hierarchical",
                           "tree", "xla")),
                   ((2, 4), ("xy", "hierarchical")),
                   ((6,), ("ring", "xy", "naive"))]
SCHEDULE_M = 64 << 20
SCHEDULE_SMALL_M = 3 * 1024
SCHEDULE_TIMED_SHAPE = (4,)

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

# Slice 9.  [3q] serves qwen2.5-3b at full published width, all 36 layers
# (3,085,938,688 params, 6.2 GB in bf16; 36 x 2 x 2 heads x 128 x 2 B =
# 36,864 B of paged KV a token), with the gemma phase's traffic.
QWEN_SERVE_ARGS = ["--arch", "qwen2.5-3b"] + SERVE_ARGS[2:]
# full-width logits, B7 vs the gather lowering, both bf16: as for gemma
# (LOGIT_ATOL), the attention outputs differ by bf16 rounding in each of
# 36 layers; the tied head of N(0, 0.02) rows against an RMS-normed state
# of width 2048 gives logits of magnitude ~4-5 (gemma's: 8.2, with 26
# layers an H100 80GB HBM3 at 700 W read 0.098 against 0.25)
QWEN_LOGIT_ATOL = 0.25
# [5d] the README's training command at full width: qwen2.5-3b's widths,
# vocab and tied embeddings with ONE cut, 36 -> 10 layers: 1,081,936,896
# params, 45.4 GB at the train phase's 42 B per parameter (12 layers would
# be 51.9 GB before activations; gemma's 8-layer phase peaked 17 GB above
# its count).  World 4, every choice left to the autotuner, 8 x 1024
# tokens, 3 steps.  No checkpoint: each f32 moment vector (4.33 GB) and
# the int8 codec's EF vector (4 x 4.33 GB) is one leaf past msgpack's
# 4 GiB bin (ROADMAP C7).
QWEN_TRAIN_CUT = dict(num_layers=10, layer_pattern=("attn",) * 10)
QWEN_TRAIN_ARGS = ["--arch", "qwen2.5-3b", "--device", "cuda", "--devices",
                   "4", "--steps", "3", "--batch", "8", "--seq", "1024",
                   "--lr", "3e-4", "--seed", "0"] + TRAIN_AUTO
# [5e] the reference's fault-injected train soak (``TrainSoakConfig``'s
# defaults: tree (2, 4), 16 micro-batches of 1 row, rank 3 slow x3 at
# steps 4-10, rank 5 killed at step 12, a checkpoint every 4 steps, 22
# steps, no codec) at qwen2.5-3b's widths with TWO cuts: 36 -> 2 layers
# (465,320,960 params: the packed pairs make world 8 cost 2 + 64 + 8 = 74
# B per parameter, 34 GB, and a checkpoint of bf16 params and two f32
# moment vectors is 4.65 GB) and seq_len 16 -> 1024 (the other train
# phases' length).  Then one step each of even and uneven shares at this
# width: the params must be bit for bit the same.
SOAK_CUT = dict(num_layers=2, layer_pattern=("attn",) * 2)
SOAK_SEQ = 1024
SOAK_SHARES = ((2,) * 8, (3, 1, 2, 2, 2, 2, 2, 2))

# Slice 10.  [3c] phase 3's traffic over the contiguous cache (the CLI's
# default kv mode); [3w] the same requests through the wave oracle.
CONTIG_SERVE_ARGS = [a if a != "paged" else "contiguous" for a in SERVE_ARGS]
# first-token logits, wave (one prefill of the 8 prompts, T 256) vs the
# continuous engine (four chunks of 64 at batch 1), both bf16: the same
# values through GEMMs of other shapes (cuBLAS may split or tile them
# differently, one bf16 rounding of 2^-8 relative on each output) and
# attention over 64 queries against 256: the LOGIT_ATOL argument with
# every layer's rounding free to differ, so twice it
WAVE_LOGIT_ATOL = 0.5
# The same for xlstm-1.3b, whose 48 recurrent layers amplify the GEMMs'
# rounding through 256 steps of exponential gating: the batch floor (one
# prompt prefilled by the same whole-prompt call alone and in the wave of
# 8, nothing but GEMM shapes differing) read 0.55 on logits of magnitude
# <= 4.97 on an H100 80GB HBM3 at 700 W, and the wave and the engine
# differ in batch and in chunking, two draws of that noise (an f32 run on
# the CPU is token-identical, tests/test_torch_serve_recurrent.py): four
# times the floor
XLSTM_WAVE_LOGIT_ATOL = 2.0
# [3s] the reference's smoke serve soak (benchmarks/soak.py --smoke): 2000
# virtual-clock steps, bursty arrivals (40/s, on half of each second), an
# admission stall at steps 700-760 and half the block pool confiscated at
# 1000-1200; 8 slots, 8-token prompts, 4-12 new tokens, paged KV of
# 33 blocks of 8; recovery within 1.5 x the pre-fault p99 (+ 10 ms) in
# 500 steps.  On gemma2-2b's widths with ONE cut, 26 -> 4 layers, to keep
# the 2000 eager steps in time (the virtual clock makes TTFT a count of
# steps, so depth does not move the verdict).
SERVE_SOAK_CUT = dict(num_layers=4, layer_pattern=("local", "global") * 2)
SERVE_SOAK_STEPS = 2000
SERVE_SOAK_ARRIVAL = "burst:40,0.5"
SERVE_SOAK_PLAN = "stall:steps=700..760;blocks:frac=0.5,steps=1000..1200"
SERVE_SOAK_ENGINE = dict(max_slots=8, max_len=32, prefill_chunk=8,
                         chunks_per_step=2, kv_mode="paged", block_size=8,
                         kv_blocks=33, clock="step")
# [3x] xlstm-1.3b at published widths with ONE cut, 48 -> 24 layers: three
# whole units of 7 mLSTM + 1 sLSTM (21 mLSTM, 3 sLSTM), 1,113,405,608
# params, 2.23 GB in bf16; 21 x 4 heads x 1024 x 1024 x 4 B = 336 MiB of
# f32 mLSTM state a request (plus the small sLSTM and conv state), so 8
# rows + the sentinel hold 3.0 GiB.  Phase 3's traffic; no KV cache, so
# no paged-attention launch.  The eager scan's time grows with the layers
# (all 48 took 147-196 s of the run); the cut pays for phase 5f's second
# step.
XLSTM_SERVE_CUT = dict(num_layers=24, layer_pattern=(("mlstm",) * 7
                                                     + ("slstm",)) * 3)
XLSTM_SERVE_ARGS = ["--arch", "xlstm-1.3b"] + CONTIG_SERVE_ARGS[2:]
# [8] jamba-v0.1-52b at published widths with ONE cut, 32 -> 16 layers
# (two of its 8-layer units, each 3 mamba, 4 mamba+MoE and 1 attention
# layer): 26,053,595,136 params, 52.1 GB in bf16; 24
# layers would be about 77.6 GB before caches.  (a) paged with 4
# recurrent rows for 8 slots, so rows are the scarce resource; (b)
# contiguous.
JAMBA_CUT_LAYERS = 16
JAMBA_PAGED_ARGS = ["--arch", "jamba-v0.1-52b"] + SERVE_ARGS[2:] + [
    "--rec-slots", "4"]
JAMBA_CONTIG_ARGS = ["--arch", "jamba-v0.1-52b"] + CONTIG_SERVE_ARGS[2:]
# Jamba's logits, B7 vs the gather lowering and paged vs contiguous: the
# two attention layers' outputs differ by bf16 rounding (phase 2 at G 4:
# within 5e-2 of the row RMS) and the 14 mamba layers carry it on; the
# MoE combine's bf16 index_add_ is atomic and a perturbed state can flip
# a top-2 pick near a tie, as for DeepSeek (DS_LOGIT_ATOL); logits of
# magnitude ~4 (an untied head of scale 1/sqrt(4096) against an RMS-normed
# state)
JAMBA_LOGIT_ATOL = 0.75

# Slice 11: training the MTP, MoE and recurrent models.  [5f] xlstm-1.3b
# BSP training at published widths with ONE cut, 48 -> 8 layers: one
# whole unit of 7 mLSTM + 1 sLSTM, 508,500,024 params, 21.4 GB at the
# train phase's 42 B per parameter (all 48 layers would be 84.9 GB).
# World 4, every choice left to the autotuner, 4 x 512 tokens: one row a
# rank, so every 512-step scan takes the reference's two-chunk path
# (``ssm.TIME_CHUNK`` 256); 2 steps, so that the second carries the
# first's error-feedback state.  The eager scan is launch-bound
# (phase 3x), so the rows are short and the steps few.
XLSTM_TRAIN_CUT = dict(num_layers=8, layer_pattern=("mlstm",) * 7
                       + ("slstm",))
XLSTM_TRAIN_ARGS = ["--arch", "xlstm-1.3b", "--device", "cuda", "--devices",
                    "4", "--steps", "2", "--batch", "4", "--seq", "512",
                    "--lr", "3e-4", "--seed", "0"] + TRAIN_AUTO
# the real-bucket check's gradients come from 64-token rows: the bucket
# layout is the run's, and a 512-token gradient pass of the eager scan
# takes a step's minute (an H100 80GB HBM3 at 700 W read 67-73 s a step)
XLSTM_CHECK_SEQ = 64
# [5g] Jamba's first two layers (mamba, mamba_moe) at published widths,
# 3,742,306,304 params, and [5h] DeepSeek-V3 with one dense MLA layer and
# its MTP module, 3,123,099,648 params: a MoE or MTP backward cannot train
# at world 4 on one card (one Jamba mamba_moe layer with its mamba partner
# is 157 GB at 42 B a parameter), so each is held by one gradient: a
# ``loss_fn`` + ``autograd.grad`` in bf16, then on the same params cast to
# f32, on the same 2 x 512 tokens.
JAMBA_GRAD_CUT = dict(num_layers=2, layer_pattern=("mamba", "mamba_moe"))
DS_GRAD_CUT = dict(num_layers=1, layer_pattern=("mla",))
GRAD_BATCH, GRAD_SEQ = 2, 512
# bf16 vs f32 (``compare_grads``): loss and metrics within "loss"; per
# gradient leaf a cosine similarity of at least "cos" and a difference of
# at most "rel" of the f32 gradient's norm (with equal norms, cos = 1 -
# rel^2 / 2).  Set from a first run on an H100 80GB HBM3 at 700 W.  Jamba:
# every bf16 activation rounds to 2^-9 and the mamba layers carry it
# through 512 steps of the scan; the router's top-2 picks near a tie and
# the bf16 index_add_ atomics of the combine (layers.apply_moe) move the
# expert and router gradients further.  The first run read the loss
# 6.8e-4 apart, the mamba leaves 0.087-0.140, the experts 0.10-0.145 and
# the router 0.200 (cos 0.980): rel 0.35 (cos 0.93) leaves 1.75x.
# DeepSeek's cut has no MoE layer: MLA, a dense MLP and the MTP block
# read 0.0057-0.0169 (cos >= 0.99986) and the loss 1.0e-3 apart: rel 0.05
# (cos 0.998), 3x.
JAMBA_GRAD_BOUNDS = dict(loss=5e-3, cos=0.93, rel=0.35)
DS_GRAD_BOUNDS = dict(loss=5e-3, cos=0.998, rel=0.05)


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


def _timed(torch, fns, calls, reps):
    """Device ms per call (CUDA graph) of each of ``fns`` (kernel, plain,
    library), in turns plain, kernel, kernel, plain, library."""
    t = {}
    for label in ("plain", "kernel", "kernel2", "plain2", "library"):
        fn = fns.get(label.rstrip("2"))
        if fn is not None:
            t[label] = _time_ms(torch, fn, calls, reps)["graph"]
    return dict(ms=min(t["kernel"], t["kernel2"]),
                plain_ms=min(t["plain"], t["plain2"]),
                library_ms=t.get("library"))


def _b7_timing(torch, ops, ref, cfg, *, lengths, n, pairs, calls, reps,
               seed, label):
    """Kernel, plain version and gather + SDPA over B = len(lengths) rows of
    gemma2-2b's heads, block 16, tables of n blocks (each row's blocks
    contiguous in the pool), softcap 50 and the 4096 window on even calls
    (the local layers); ``pairs`` pool pairs cycled so each call finds its
    pool cold in the 50 MB L2.  The bound counts the K/V rows each call
    must read (the window's on even calls), q, out, tables and lengths."""
    import numpy as np
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    B, bs = len(lengths), 16
    Hkv, G, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim
    N = 1 + B * n
    lengths = np.asarray(lengths, np.int32)
    tables = np.zeros((B, n), np.int32)
    for b in range(B):
        nb = -(-int(lengths[b]) // bs)
        tables[b, :nb] = 1 + b * n + np.arange(nb)
    tables_t = torch.from_numpy(tables).to(dev)
    lens_t = torch.from_numpy(lengths).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    pools = [(mk(N, bs, Hkv, d), mk(N, bs, Hkv, d)) for _ in range(pairs)]
    q = mk(B, Hkv, G, d)
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
        kp, vp = pools[i % pairs]
        ops.paged_attention_kernel(q, kp, vp, tables_t, lens_t, scale=scale,
                                   window=win(i), softcap=cap)

    def plain(i):
        kp, vp = pools[i % pairs]
        ref.paged_attention_ref(q, kp, vp, tables_t, lens_t, scale=scale,
                                window=win(i), softcap=cap)

    def library(i):
        kp, vp = pools[i % pairs]
        k = ref._gather(kp, tables_t).transpose(1, 2)
        v = ref._gather(vp, tables_t).transpose(1, 2)
        F.scaled_dot_product_attention(q, k, v, attn_mask=masks[win(i)],
                                       scale=scale)

    t = {}
    for name, fn in (("plain", plain), ("kernel", kernel),
                     ("kernel2", kernel), ("plain2", plain),
                     ("library", library)):
        t[name] = _time_ms(torch, fn, calls, reps=reps)
    read = [int(np.minimum(lengths, win(i) or S).sum()) for i in range(calls)]
    kv_bytes = sum(read) / calls * Hkv * 2 * d * 2
    io_bytes = 2 * q.numel() * 2 + tables.nbytes + lengths.nbytes
    flops = 2 * 2 * d * G * Hkv * sum(read) / calls
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    gt = {k: v["graph"] for k, v in t.items()}
    res = dict(ms=min(gt["kernel"], gt["kernel2"]),
               plain_ms=min(gt["plain"], gt["plain2"]),
               library_ms=gt["library"], bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    shown = lengths.tolist() if len(set(lengths.tolist())) > 1 else \
        f"all {lengths[0]}"
    print(f"  B7 {label}: B={B} Hkv={Hkv} G={G} d={d} bs={bs} n={n} bf16, "
          f"lengths {shown}, softcap {cap}, window {cfg.sliding_window} on "
          f"even calls; {pairs} pool pairs cycled over {calls} calls")
    for name, v in t.items():
        print(f"  B7 {name:8s}: {v['graph']:.5f} ms/call device (CUDA "
              f"graph), {v['eager']:.5f} ms/call eager (host included)")
    print(f"  B7 bound {res['bound_ms']:.5f} ms ({res['bound_by']}: "
          f"{kv_bytes + io_bytes:.0f} B a call at {HBM_BYTES_PER_S:.3g} "
          f"B/s, {flops:.0f} flop at {F32_FLOPS_PER_S:.3g} flop/s); library "
          f"= gather + SDPA without the softcap")
    return res


def phase_timing(torch, ops, ref, cfg):
    """B7 at the serve shape: 8 rows, gemma2-2b's heads, lengths of a
    mid-serve step (257-320, n 21); one pool pair per layer (26, like the
    decode step)."""
    import numpy as np
    lengths = np.random.default_rng(1).integers(257, 321, size=8)
    return _b7_timing(torch, ops, ref, cfg, lengths=lengths,
                      n=-(-(256 + 64 + 1) // 16), pairs=cfg.num_layers,
                      calls=cfg.num_layers, reps=20, seed=1,
                      label="serve shape")


def phase_wide_timing(torch, ops, ref, cfg):
    """B7 at the serve shape's lengths (257-320) over tables of gemma2-2b's
    whole context (n 512), as a server whose slots may grow to 8192
    positions holds them; one pool pair per layer."""
    import numpy as np
    lengths = np.random.default_rng(1).integers(257, 321, size=8)
    return _b7_timing(torch, ops, ref, cfg, lengths=lengths, n=512,
                      pairs=cfg.num_layers, calls=cfg.num_layers, reps=20,
                      seed=1, label="serve lengths, tables of n 512")


def phase_long_timing(torch, ops, ref, cfg):
    """B7 at gemma2-2b's full context: 8 rows at length 8192 (n 512),
    window 4096 on even calls; 2 pool pairs (268 MB each) cycled."""
    return _b7_timing(torch, ops, ref, cfg, lengths=[8192] * 8, n=512,
                      pairs=2, calls=4, reps=10, seed=15,
                      label="long context")


# where B7's time goes: every row at one length, gemma2-2b's heads,
# softcap 50, no window; the intercept is the fixed cost of a call, the
# slope the cost per position of a row
SWEEP_LENGTHS = [1, 64, 320, 2048, 8192]


def b7_length_sweep(torch, ops, cfg):
    """Device ms per call of B7 with every one of 8 rows at each length of
    ``SWEEP_LENGTHS`` (tables of ceil(L / 16) blocks; enough pool pairs
    cycled to exceed the L2), and the least-squares line through them."""
    import numpy as np
    dev = torch.device("cuda", 0)
    B, bs = 8, 16
    Hkv, G, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    q = mk(B, Hkv, G, d)
    out = {}
    for L in SWEEP_LENGTHS:
        n = -(-L // bs)
        N = 1 + B * n
        pairs = min(256, max(2, -(-100_000_000 // (N * bs * Hkv * d * 4))))
        pools = [(mk(N, bs, Hkv, d), mk(N, bs, Hkv, d)) for _ in range(pairs)]
        tables = (1 + torch.arange(B * n, dtype=torch.int32, device=dev)
                  ).reshape(B, n)
        lens = torch.full((B,), L, dtype=torch.int32, device=dev)
        out[L] = _time_ms(torch, lambda i: ops.paged_attention_kernel(
            q, *pools[i % pairs], tables, lens, scale=d ** -0.5,
            softcap=cfg.attn_softcap), pairs, reps=10)["graph"]
        del pools
    slope, icept = np.polyfit(SWEEP_LENGTHS, [out[L] for L in SWEEP_LENGTHS],
                              1)
    print("  B7 kernel, every row at length L: " + ", ".join(
        f"L={L}: {ms:.5f} ms" for L, ms in out.items())
        + f"; least squares: {icept:.5f} ms + {slope * 1e3:.5f} ms per "
        f"1000 positions")
    return dict(ms=out, intercept_ms=float(icept),
                slope_ms_per_1000=float(slope * 1e3))


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


def _b8_timing(torch, ops, ref, cfg, *, lengths, n, pools, reps, seed,
               label):
    """B8, its plain version and gather + SDPA over B = len(lengths) rows
    of DeepSeek-V3's 128 heads, r 512, dr 64, block 16, tables of n blocks
    (each row's contiguous in the pool); ``pools`` latent pool pairs
    cycled, as the decode step's expert weights flush the L2 between two
    layers' calls.  Returns the kernel table's row and the inputs, for the
    length sweep."""
    import numpy as np
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    m = cfg.mla
    B, bs, H = len(lengths), 16, cfg.num_heads
    r, dr = m.kv_lora_rank, m.qk_rope_head_dim
    N = 1 + B * n
    lengths = np.asarray(lengths, np.int32)
    tables = np.zeros((B, n), np.int32)
    for b in range(B):
        tables[b, :-(-int(lengths[b]) // bs)] = 1 + b * n + np.arange(
            -(-int(lengths[b]) // bs))
    tables_t = torch.from_numpy(tables).to(dev)
    lens_t = torch.from_numpy(lengths).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
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
        t[name] = _time_ms(torch, fn, pools, reps=reps)
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
    shown = lengths.tolist() if len(set(lengths.tolist())) > 1 else \
        f"all {lengths[0]}"
    print(f"  B8 {label}: B={B} H={H} r={r} dr={dr} bs={bs} n={n} bf16, "
          f"lengths {shown}; {pools} latent pool pairs cycled")
    for name, v in t.items():
        print(f"  B8 {name:8s}: {v['graph']:.5f} ms/call device (CUDA "
              f"graph), {v['eager']:.5f} ms/call eager (host included)")
    print(f"  B8 bound {res['bound_ms']:.5f} ms ({res['bound_by']}: "
          f"{lat_bytes + io_bytes} B at {HBM_BYTES_PER_S:.3g} B/s; {flops} "
          f"flop at {BF16_FLOPS_PER_S:.3g} flop/s, {t_ops:.5f} ms); "
          f"library = gather + SDPA over [c_kv | k_rope] keys, c_kv values")
    return res, (qe, qr, latents, tables_t, scale)


def phase_mla_timing(torch, ops, ref, cfg, pools=24):
    """B8 at DeepSeek's serve shape: 8 rows, lengths of a late serve step
    (257 up to 336 = 21 blocks); ``pools`` latent pool pairs (75 MB in
    all, more than the 50 MB L2).  Then how the kernel's time grows:
    every row at one length, then 1 row."""
    import numpy as np
    dev = torch.device("cuda", 0)
    bs = 16
    n = -(-(256 + 64 + 1) // bs)
    lengths = np.random.default_rng(5).integers(257, n * bs + 1, size=8)
    res, (qe, qr, latents, tables_t, scale) = _b8_timing(
        torch, ops, ref, cfg, lengths=lengths, n=n, pools=pools, reps=10,
        seed=5, label="serve shape")
    B, S = len(lengths), n * bs
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


def phase_mla_wide_timing(torch, ops, ref, cfg):
    """B8 at the serve shape's lengths (257-336) over tables of the long
    context's width (n 256); 24 latent pool pairs."""
    import numpy as np
    lengths = np.random.default_rng(5).integers(257, 337, size=8)
    return _b8_timing(torch, ops, ref, cfg, lengths=lengths, n=256,
                      pools=24, reps=10, seed=5,
                      label="serve lengths, tables of n 256")[0]


def phase_mla_long_timing(torch, ops, ref, cfg):
    """B8 at a long decode context: 8 rows at length 4096 (n 256); 4 latent
    pool pairs (37.7 MB each) cycled."""
    return _b8_timing(torch, ops, ref, cfg, lengths=[4096] * 8, n=256,
                      pools=4, reps=10, seed=17, label="long context")[0]


# ---------------------------------------------------------------------------
# phase 2: B7's and B8's memory accesses, checked by guard bytes
# ---------------------------------------------------------------------------

# elements of a fill pattern on either side of every buffer a guarded call
# of B7, B8, B3 or B4 touches, and the patterns: a NaN for the floats (read
# into a product or a sum, it would reach the output), an out-of-range
# block id for the int32 tables and lengths (dereferenced, it would
# fault), a code of 90 for B4's int8 codes
GUARD = 4096
GUARD_BITS = {"float32": 0x7FC0BEEF, "bfloat16": 0x7FC1, "int32": 0x3FFFFFFF,
              "int8": 0x5A}
# block-table columns past every row's length, holding GUARD_BITS's block
# id (never dereferenced), so the plan also has splits past every row
GUARD_EXTRA_PAGES = 64


def _bits(torch, t):
    """``t``'s elements as integers of its width (bitwise comparisons)."""
    return t.view({4: torch.int32, 2: torch.int16,
                   1: torch.int8}[t.element_size()])


def _guarded(torch, t, copy=True):
    """A copy of ``t`` (or, without ``copy``, a tensor like it holding the
    fill) inside a buffer of GUARD fill elements on either side; returns
    (buffer, copy)."""
    flat = torch.empty(t.numel() + 2 * GUARD, dtype=t.dtype, device=t.device)
    _bits(torch, flat).fill_(GUARD_BITS[str(t.dtype)[6:]])
    view = flat[GUARD:GUARD + t.numel()].view(t.shape)
    if copy:
        view.copy_(t)
    return flat, view


def _guards_hold(torch, flat, n):
    """Whether the fill on either side of an ``n``-element copy is
    intact."""
    b = _bits(torch, flat)
    fill = GUARD_BITS[str(flat.dtype)[6:]]
    return bool((b[:GUARD] == fill).all() and (b[GUARD + n:] == fill).all())


def _guarded_run(torch, ops, kernel, inputs, label):
    """``kernel(*inputs)`` twice on guarded copies of the inputs, with its
    partial states and output in guarded buffers (``ops._buffers``
    patched), and once as it is.  Fails unless every guard and every input
    is unchanged, every partial m and l and every acc of a live split was
    written, and the three outputs are equal bit for bit (twice the same:
    no race showed; as unguarded: nothing was read past an input)."""
    made, real = [], ops._buffers

    def buffers(rows, splits, width, out_shape, dtype, device):
        (m, l, acc), out = real(rows, splits, width, out_shape, dtype, device)
        got = [_guarded(torch, x, copy=False) for x in (m, l, acc, out)]
        made.append((rows * splits, width, got))
        return tuple(v for _, v in got[:3]), got[3][1]

    want = kernel(*inputs)
    guarded = [_guarded(torch, x) for x in inputs]
    ops._buffers = buffers
    try:
        runs = [kernel(*(v for _, v in guarded)) for _ in range(2)]
    finally:
        ops._buffers = real
    torch.cuda.synchronize()
    unset = lambda t: (_bits(torch, t) == GUARD_BITS[str(t.dtype)[6:]]).any()
    bad = [f"input {i}" for i, ((flat, v), x) in enumerate(zip(guarded,
                                                                inputs))
           if not _guards_hold(torch, flat, x.numel())
           or not torch.equal(_bits(torch, v), _bits(torch, x))]
    for k, (states, width, got) in enumerate(made):
        for name, (flat, t) in zip(("m", "l", "acc", "out"), got):
            if not _guards_hold(torch, flat, t.numel()):
                bad.append(f"run {k}: a write past {name}")
        m, l, acc, out = (v for _, v in got)
        m, l = m[:states], l[:states]
        if unset(m) or unset(l):
            bad.append(f"run {k}: a partial m or l not written")
        if unset(acc.view(states, width)[~torch.isinf(m)]):
            bad.append(f"run {k}: a live split's acc not written")
        if unset(out):
            bad.append(f"run {k}: an output element not written")
    if not all(torch.equal(_bits(torch, r), _bits(torch, want))
               for r in runs):
        bad.append("outputs differ between the guarded runs and the "
                   "unguarded call")
    if len(made) != 2:
        bad.append(f"{len(made)} guarded buffer sets, want 2")
    if bad:
        raise AssertionError(f"{label}: {'; '.join(bad)}")


def phase_guards(torch, ops, dev):
    """B7 at every ``phase_kernels`` case and B8 at every ``MLA_CASES``
    case, with tables GUARD_EXTRA_PAGES wider than any row needs (so the
    plan has splits past every row, and empty ones), through
    ``_guarded_run``.  Returns the number of guarded calls."""
    import numpy as np
    rng, calls = np.random.default_rng(6), 0

    def widen(tables):
        extra = torch.full((tables.shape[0], GUARD_EXTRA_PAGES),
                           GUARD_BITS["int32"], dtype=torch.int32,
                           device=tables.device)
        return torch.cat([tables, extra], 1).contiguous()

    for dtype in (torch.float32, torch.bfloat16):
        for shp in KERNEL_SHAPES:
            q, kp, vp, tables, lens = _paged_inputs(
                torch, rng, lengths=KERNEL_LENGTHS, dtype=dtype, dev=dev,
                **shp)
            tables = widen(tables)
            for window in (None, 4096, 100):
                for cap in (None, 50.0):
                    kw = dict(scale=shp["d"] ** -0.5, window=window,
                              softcap=cap)
                    _guarded_run(
                        torch, ops,
                        lambda *a: ops.paged_attention_kernel(*a, **kw),
                        (q, kp, vp, tables, lens),
                        f"B7 {str(dtype)[6:]} {shp} window={window} "
                        f"softcap={cap}")
                    calls += 3
    for case in MLA_CASES:
        shp = {k: case[k] for k in ("H", "r", "dr", "bs")}
        qe, qr, ckv, kr, tables, lens = _mla_inputs(
            torch, rng, lengths=MLA_LENGTHS,
            dtype=getattr(torch, case["dtype"]), dev=dev, **shp)
        scale = (128 + case["dr"]) ** -0.5
        _guarded_run(
            torch, ops,
            lambda *a: ops.paged_mla_attention_kernel(*a, scale=scale),
            (qe, qr, ckv, kr, widen(tables), lens), f"B8 {case}")
        calls += 3
    print(f"  B7/B8 guard bytes: {calls} calls (every B7 case of "
          f"phase_kernels, every B8 case, tables {GUARD_EXTRA_PAGES} pages "
          f"wider holding block id {GUARD_BITS['int32']:#x}; inputs, "
          f"partial states and outputs inside {GUARD} elements of NaN or "
          "bad ids): no write outside its buffer, inputs unchanged, every "
          "partial state written, outputs equal bit for bit twice and to "
          "the unguarded call")
    return calls


def _tree_guarded_run(torch, tops, kernel, inputs, label):
    """``kernel(*inputs)`` (B3 or B4) twice on guarded copies of the inputs,
    with its output and f32 scratch in guarded buffers (``tops._buffers``
    patched), and once as it is.  Fails unless every guard and every input
    is unchanged, every output element and every scratch element was
    written, and the three outputs are equal bit for bit (twice the same:
    no race showed; as unguarded: nothing was read past an input).
    Returns 1 when the call took an f32 scratch, else 0."""
    made, real = [], tops._buffers

    def buffers(n, cols, out_dtype, device):
        out, scratch = real(n, cols, out_dtype, device)
        got = [_guarded(torch, t, copy=False) for t in (out, scratch)
               if t is not None]
        made.append(got)
        return got[0][1], (got[1][1] if len(got) > 1 else None)

    want = kernel(*inputs)
    guarded = [_guarded(torch, x) for x in inputs]
    tops._buffers = buffers
    try:
        runs = [kernel(*(v for _, v in guarded)) for _ in range(2)]
    finally:
        tops._buffers = real
    torch.cuda.synchronize()
    fill = lambda t: GUARD_BITS[str(t.dtype)[6:]]
    bad = [f"input {i}" for i, ((flat, v), x) in enumerate(zip(guarded,
                                                                inputs))
           if not _guards_hold(torch, flat, x.numel())
           or not torch.equal(_bits(torch, v), _bits(torch, x))]
    for k, got in enumerate(made):
        for name, (flat, t) in zip(("output", "scratch"), got):
            if not _guards_hold(torch, flat, t.numel()):
                bad.append(f"run {k}: a write past the {name}")
            if (_bits(torch, t) == fill(t)).any():
                bad.append(f"run {k}: an element of the {name} not written")
    if not all(torch.equal(_bits(torch, r), _bits(torch, want))
               for r in runs):
        bad.append("outputs differ between the guarded runs and the "
                   "unguarded call")
    if len(made) != 2:
        bad.append(f"{len(made)} guarded buffer sets, want 2")
    if bad:
        raise AssertionError(f"{label}: {'; '.join(bad)}")
    return len(made[0]) - 1


def phase_tree_guards(torch, tops, dev):
    """B3 and B4 through ``_tree_guarded_run`` on both paths (ring widths
    and ragged ones) at 8 rows (one pass), 13 (a pass into scratch, one
    out of it), 40 and 100 (scratch passes; at 100 one in place).  Returns
    the number of guarded calls."""
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    calls = 0
    for N in (8, 13, 40, 100):
        for D in (4104, 700, 4097):
            x32 = _tree_rows(torch, N, D, g, dev)
            for dt in (torch.float32, torch.bfloat16):
                x = x32.to(dt)
                _tree_guarded_run(torch, tops,
                                  lambda x: tops.tree_reduce_kernel(x), (x,),
                                  f"B3 N={N} D={D} {str(dt)[6:]} "
                                  f"({_tree_path(x)})")
                calls += 3
        for nb in (68, 37):
            q, sc = _int8_wire(torch, tops, N, nb, g, dev)
            _tree_guarded_run(torch, tops, tops.int8_tree_reduce_kernel,
                              (q, sc), f"B4 N={N} nb={nb} "
                              f"({_tree_path(q, sc)})")
            calls += 3
    print(f"  B3/B4 guard bytes: {calls} calls (ring and ragged paths, N 8, "
          f"13, 40, 100; inputs, output and f32 scratch inside {GUARD} "
          "elements of NaN, or code 90): no write outside its buffer, inputs "
          "unchanged, every output and scratch element written, outputs "
          "equal bit for bit twice and to the unguarded call")
    return calls


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
    """Equal dtype, shape and bits (f32 or a 2-byte dtype)."""
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(bits), b.view(bits))


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
        res[name] = r = _timed(torch, fns, 3, reps=3)
        del wire
        bound = M * per / HBM_BYTES_PER_S * 1e3
        r.update(bound_ms=bound, bound_by="bytes")
        print(f"  {'B1' if name == 'bf16' else 'B2'} {name} M={M}: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
              f" ms, library {r['library_ms']:.4f} ms, bound {bound:.4f} ms "
              f"({per:g} B/elem at {HBM_BYTES_PER_S:.3g} B/s); device time "
              f"per call from a CUDA graph of 3 calls")
    return res


def _ef_runs(torch, codec, lead, dev):
    """The runs of x = g + res that ``_ef_bucket`` plants (a block each
    for int8, 8 elements each for bf16): 0, -0, NaN-led, inf-led (the rest
    from ``lead``), subnormals, subnormals under a normal, ties and the
    codes' edges, as one flat tensor."""
    n = 128 if codec == "int8" else 8
    k = torch.arange(n, dtype=torch.float32, device=dev)
    lead = lead[:n].clone()
    runs = [torch.zeros(n, device=dev), torch.full((n,), -0.0, device=dev),
            torch.cat([lead[:1] * float("nan"), lead[1:]]),
            torch.cat([lead[:1] * 0 + float("inf"), lead[1:]]),
            3e-39 * torch.linspace(-1, 1, n, device=dev),
            torch.where(k == 0, 1e-30, 1e-42),
            torch.where(k == 0, 15.875, (k % 253 - 126 + 0.5) * 0.125),
            torch.where(k == 0, -15.875, torch.tensor(
                [15.875, -15.875, 15.8125, -15.8125], device=dev)[
                    k.long() % 4])]
    return torch.cat(runs)


def _ef_bucket(torch, codec, W, L, rstride, res_off, g_off, seed, dev):
    """g [W, L] (``g_off`` elements into its storage) and res, columns
    ``res_off`` to ``res_off + L`` of a [W, rstride] state, on ``dev``:
    gradient-like values and a 1e-3 residual, and in row 0 a run each
    (int8: a block, bf16: 8) of x = g + res at 0, -0, NaN-led, inf-led,
    subnormals, subnormals under a normal, ties (15.875 = 127 / 8 makes
    the scale 1/8) and the codes' edges.  Returns (g, res, state)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn(W, L, generator=gen, device=dev) * torch.exp(
        2 * torch.randn(W, L, generator=gen, device=dev))
    r = torch.randn(W, L, generator=gen, device=dev) * 1e-3
    flat = _ef_runs(torch, codec, x[0], dev)[:L]
    store = torch.zeros(W * L + g_off, device=dev)
    g = store[g_off:].view(W, L)
    g.copy_(x - r)
    g[0, :flat.numel()] = flat
    r[0, :flat.numel()] = -0.0
    state = torch.zeros(W, rstride, device=dev)
    res = state[:, res_off:res_off + L]
    res.copy_(r)
    return g, res, state


def _nan_same(torch, a, b):
    """Equal bits, except that any NaN equals any NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and _same_bits(
        torch, torch.where(na, 0.0, a), torch.where(nb, 0.0, b))


def _addcmul_rounding(torch, dev, n=1 << 20):
    """How ``torch.addcmul(x, q, scale, value=-1)`` rounds on ``dev``:
    the share of n elements equal to one fused multiply-add (from f64,
    where the product is exact) and to a rounded product then a rounded
    difference."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn(n, generator=gen, device=dev)
    q = torch.randint(-127, 128, (n,), generator=gen, device=dev).float()
    s = torch.rand(n, generator=gen, device=dev) * 0.05
    got = torch.addcmul(x, q, s, value=-1)
    fused = (x.double() - q.double() * s.double()).float()
    two = x - q * s
    return ((got == fused).float().mean().item(),
            (got == two).float().mean().item())


def phase_ef_kernels(torch, cops, cref, codecs, dev, cases=EF_CASES):
    """EF's kernel (``cops.error_feedback_kernel``) against the eager
    sequence (``cref.error_feedback_ref_``) on the same inputs: g' and the
    whole residual state (the slice's neighbours too) bit for bit, NaN
    where it has NaN; each case on its path, one launch on it.  Prints how
    ``torch.addcmul`` rounds on the device.  Returns the launches by path
    the cases made."""
    fused, two = _addcmul_rounding(torch, dev)
    print(f"  torch.addcmul(x, q, scale, value=-1) on {dev.type}: one fused "
          f"multiply-add in {fused:.6f} of 2^20 elements, product rounded "
          f"first in {two:.6f}")
    made = {"vector": 0, "scalar": 0}
    for codec, W, L, rstride, res_off, g_off, path in cases:
        outs = []
        for run in ("kernel", "eager"):
            g, res, state = _ef_bucket(torch, codec, W, L, rstride, res_off,
                                       g_off, L, dev)
            if run == "kernel":
                if cops.ef_path(g, res) != path:
                    raise AssertionError(f"EF {codec} [{W}, {L}] takes the "
                                         f"{cops.ef_path(g, res)} path, not "
                                         f"{path}")
                before = cops.EF_LAUNCHES_BY_PATH[path]
                cops.error_feedback_kernel(g, res, codecs[codec])
                if cops.EF_LAUNCHES_BY_PATH[path] != before + 1:
                    raise AssertionError(f"EF {codec} [{W}, {L}]: not one "
                                         f"launch on the {path} path")
                made[path] += 1
            else:
                cref.error_feedback_ref_(g, res, codecs[codec])
            _sync(torch, dev)
            outs.append((g, state))
        same = (_nan_same(torch, outs[0][0], outs[1][0])
                and _nan_same(torch, outs[0][1], outs[1][1]))
        nans = int(torch.isnan(outs[1][0]).sum())
        print(f"  EF {codec} [{W}, {L}], residual row stride {rstride} "
              f"({path}): g' and residual "
              f"{'bit-identical' if same else 'DIFFER'} to the eager "
              f"sequence ({nans} NaN in its g')")
        if not same:
            raise AssertionError(f"EF {codec} [{W}, {L}] ({path}) differs "
                                 "from the eager sequence")
    return made


def phase_ef_bucket(torch, cops, cref, codecs, dev, W=EF_TIME_W,
                    L=EF_TIME_L, total=EF_TIME_TOTAL, off=EF_TIME_OFF,
                    seed=29):
    """EF's kernel against the eager sequence at the int8 cell's largest
    bucket, as the train step lays it out: g [W, L] and the residual
    columns ``off`` to ``off + L`` of a zeroed [W, total] state, so that
    the residual's offsets pass 2^31 (64-bit indexing).  Gradient-like
    values with ``_ef_runs`` planted at the end of the last row (the
    farthest addresses); the eager sequence runs on contiguous copies of
    the same inputs.  For each codec: g' and the residual compared row by
    row bit for bit, NaN where it has NaN, the state's other columns still
    zero, one launch on the vector path; raises on any difference.
    Returns the elements compared and the largest residual offset."""
    out = dict(shape=[W, L], state=[W, total], offset=off, elements=0,
               max_res_offset=(W - 1) * total + off + L - 1)
    for codec in ("int8", "bf16"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        state = torch.zeros(W, total, device=dev)
        res = state[:, off:off + L]
        g = torch.empty(W, L, device=dev)
        for i in range(W):
            res[i].copy_(torch.randn(L, generator=gen, device=dev) * 1e-3)
            g[i].normal_(generator=gen)
        flat = _ef_runs(torch, codec, g[W - 1], dev)[:L]
        g[W - 1, L - flat.numel():] = flat
        res[W - 1, L - flat.numel():] = -0.0
        g_e, r_e = g.clone(), res.clone()
        _sync(torch, dev)
        before = dict(cops.EF_LAUNCHES_BY_PATH)
        cops.error_feedback_kernel(g, res, codecs[codec])
        cref.error_feedback_ref_(g_e, r_e, codecs[codec])
        _sync(torch, dev)
        made = {p: cops.EF_LAUNCHES_BY_PATH[p] - before[p] for p in before}
        if made != dict(vector=1, scalar=0):
            raise AssertionError(f"EF {codec} [{W}, {L}]: launches by path "
                                 f"{made}, want one on the vector path")
        bad = [i for i in range(W)
               if not (_nan_same(torch, g[i], g_e[i])
                       and _nan_same(torch, res[i], r_e[i]))]
        outside = [int(torch.count_nonzero(state[i, :off].view(torch.int32)))
                   + int(torch.count_nonzero(
                       state[i, off + L:].view(torch.int32)))
                   for i in range(W)]
        nans = int(torch.isnan(g_e).sum())
        print(f"  EF {codec} [{W}, {L}] on columns {off}.. of a [{W}, "
              f"{total}] state (residual offsets to "
              f"{out['max_res_offset']:,}): g' and residual "
              f"{'bit-identical' if not bad else 'DIFFER'} to the eager "
              f"sequence ({nans} NaN in its g'), other columns "
              f"{'untouched' if not any(outside) else 'WRITTEN'}")
        if bad or any(outside):
            raise AssertionError(f"EF {codec} [{W}, {L}] at offset {off} of "
                                 f"[{W}, {total}]: rows {bad} differ from "
                                 f"the eager sequence, {outside} elements "
                                 f"written outside the bucket's columns")
        out["elements"] += W * L
        del g, res, state, g_e, r_e, flat
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _event_ms(torch, fn, reps):
    """ms per call of ``fn()`` by CUDA events around ``reps`` calls after
    one warm-up call (each call is milliseconds long: launch overhead is
    out of it)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_ef_timing(torch, cops, cref, codecs, reps=3):
    """EF's kernel and the eager sequence it replaced, in turns eager,
    kernel, kernel, eager, at the int8 cell's largest bucket (g [4,
    311,164,928], the residual its columns of the [4, total] state), for
    each codec, beside the bound of 16 bytes an element at HBM's rate."""
    dev = torch.device("cuda", 0)
    W, L = EF_TIME_W, EF_TIME_L
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    state = torch.zeros(W, EF_TIME_TOTAL, device=dev)
    res = state[:, EF_TIME_OFF:EF_TIME_OFF + L]
    res.copy_(torch.randn(W, L, generator=gen, device=dev) * 1e-3)
    g = torch.randn(W, L, generator=gen, device=dev)
    bound = W * L * EF_BYTES_PER_ELEM / HBM_BYTES_PER_S * 1e3
    out = {}
    for codec in ("int8", "bf16"):
        c = codecs[codec]
        fns = {"kernel": lambda: cops.error_feedback_kernel(g, res, c),
               "plain": lambda: cref.error_feedback_ref_(g, res, c)}
        t = {label: _event_ms(torch, fns[label.rstrip("2")], reps)
             for label in ("plain", "kernel", "kernel2", "plain2")}
        gc.collect()
        torch.cuda.empty_cache()
        ms = min(t["kernel"], t["kernel2"])
        out[codec] = r = dict(ms=ms, plain_ms=min(t["plain"], t["plain2"]),
                              bound_ms=bound, bound_by="bytes",
                              roofline_pct=100 * bound / ms,
                              path=cops.ef_path(g, res), shape=[W, L])
        print(f"  EF {codec} [{W}, {L}] ({r['path']}): kernel "
              f"{ms:.4f} ms ({r['roofline_pct']:.2f} % of the bound), eager "
              f"sequence {r['plain_ms']:.4f} ms, bound {bound:.4f} ms "
              f"({EF_BYTES_PER_ELEM} B/elem at {HBM_BYTES_PER_S:.3g} B/s); "
              f"CUDA events over {reps} calls, in turns")
    del g, res, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 2: the public kernel ops (B3, B4, B6, B5) against their plain versions
# ---------------------------------------------------------------------------

# B3/B4 vs their plain versions: the same f32 adds in the same pairing (B4's
# first level the same fused multiply-add), so equal bit for bit.  N runs
# every pass plan of the kernel: 1 and 2 pad to 2 (one level), 3 one pass
# of 2 levels, 8 one pass of 3 (the timed count), 13 and 16 a pass of 3
# then 1, 20 then 2, 40 then 3, 100 then 3 in place and 1.  Each case must
# take its path (``_tree_path``): f32 D = 700 and 300,004 take the ring
# (bf16 the ragged kernel's vector loads), 1, 4097 and 300,001 the ragged
# kernel's scalar loads; the 300,00x columns outnumber the ragged kernel's
# threads, so its grid-stride loop goes round more than once.  B4's nb =
# 1100 takes the ring, 1, 3 and 37 the ragged kernel.  The ring's tile is
# 8 KB of a row (2048 f32, 4096 bf16, 8192 int8 columns): TREE_TILE_DS sit
# one 16-byte step either side of both float tiles (multiples of 8, so
# both dtypes take the ring), INT8_TILE_NBS 4 codec blocks either side of
# B4's 64; at TREE_WRAP_NS phase 2 adds a width at which every block takes
# more than twice its ring's stages in items (from the card's occupancy),
# and views off 16 bytes, which must take the ragged kernel.
TREE_NS = [1, 2, 3, 8, 13, 16, 20, 40, 100]
TREE_DS = [1, 700, 4097, 300_001, 300_004]
TREE_TILE_DS = [2040, 2048, 2056, 4088, 4096, 4104]
INT8_TREE_NBS = [1, 3, 37, 1100]
INT8_TILE_NBS = [60, 64, 68]
TREE_WRAP_NS = [8, 100]
# the timed shape: 8 micro-batches' rows of one 256 MB f32 gradient bucket
# (the micro-batch accumulation the tree sum was written for)
TREE_TIME_N, TREE_TIME_D = 8, 67_108_864

# B6 cases: gemma2-2b's MLP up-projection at a train rank's micro-batch
# (2 x 1024 tokens), a DeepSeek-V3 expert up-projection at a decode step (8
# rows), a ragged shape in both dtypes (K and N not multiples of 8: the
# mma kernel's element-wise load path), and the shapes the wgmma kernel's
# 256 x 192 x 64 tiles make risky: M, N and K one past a tile multiple (N
# and K by the 8 that path needs), K = 8 (one box, mostly zeros past K)
# and K = 64 (one whole box), and the same M, K, N one past in steps of 1
# and with x off 16 bytes, which go to the mma kernel.  ``path`` is the
# kernel each case must launch (``ops.gemm_path``).  The first is timed.
GEMM_CASES = [
    dict(name="gemma2-2b MLP up, train micro-batch", M=2048, K=2304,
         N=9216, dtype="bfloat16", path="wgmma"),
    dict(name="DeepSeek-V3 expert up, decode", M=8, K=7168, N=2048,
         dtype="bfloat16", path="wgmma"),
    dict(name="ragged", M=1000, K=2300, N=770, dtype="float32", path="f32"),
    dict(name="ragged", M=1000, K=2300, N=770, dtype="bfloat16",
         path="mma"),
    dict(name="tile edges + 1 (8 in N, K)", M=257, K=72, N=200,
         dtype="bfloat16", path="wgmma"),
    dict(name="K = 8", M=256, K=8, N=192, dtype="bfloat16", path="wgmma"),
    dict(name="K = 64", M=256, K=64, N=384, dtype="bfloat16",
         path="wgmma"),
    dict(name="tile edges + 1", M=257, K=65, N=193, dtype="bfloat16",
         path="mma"),
    dict(name="x off 16 bytes", M=257, K=72, N=200, dtype="bfloat16",
         path="mma", offset=1)]
# f32: the kernel's fmaf chain and the plain version's f32 matmul sum the
# same K products in another order (~1e-6 relative): the tests' 2e-4, as
# rtol and atol.  bf16: both round an f32 sum of the same products to bf16,
# so they differ by at most one bf16 step, 2^-7 of an element; a row's
# largest elements reach ~4.5x its RMS (9216 near-normal outputs), so one
# step there is 3.5e-2 of the row RMS; 4e-2.  A dropped K tile (32 of
# 2304) would move every element by ~0.12 of the RMS.
GEMM_F32_TOL = 2e-4
GEMM_BF16_ROW_RTOL = 4e-2

# B5 cases.  (a) gemma2-2b's global layer at a train rank's batch, forward
# and the autograd backward; (b) its local layer at the full 8192 context;
# (c) DeepSeek-V3's MLA prefill (D 192 = nope 128 + rope 64, Dv 128); (d)
# the two padding cases in f32 and bf16: non-causal with Tk not a multiple
# of any tile, and causal with Tq > Tk (rows past Tk see every key); (e) a
# window that leaves rows with no key at all (i >= Tk + window - 1), which
# every comparison leaves out and the kernel sets to 0; (f) the shapes the
# wgmma kernel's tiles make risky: Tq and Tk one past 128 (the q-block) and
# one past the key tile kBK (128 at Dv <= 128 with D <= 192, else 64), with
# Hq / Hkv = 1, 2 and 8.  (a) and (b) are timed, (a) also without the
# softcap.
FLASH_CASES = [
    dict(name="(a) gemma2-2b global, train batch", B=2, Tq=1024, Tk=1024,
         Hq=8, Hkv=4, D=256, Dv=256, causal=True, window=None, softcap=50.0,
         dtype="bfloat16", grad=True),
    dict(name="(b) gemma2-2b local, 8192 context", B=1, Tq=8192, Tk=8192,
         Hq=8, Hkv=4, D=256, Dv=256, causal=True, window=4096, softcap=50.0,
         dtype="bfloat16"),
    dict(name="(c) DeepSeek-V3 MLA prefill", B=1, Tq=1024, Tk=1024, Hq=128,
         Hkv=128, D=192, Dv=128, causal=True, window=None, softcap=None,
         dtype="bfloat16"),
    dict(name="(d) non-causal, ragged Tk", B=1, Tq=200, Tk=333, Hq=4, Hkv=2,
         D=64, Dv=64, causal=False, window=None, softcap=None,
         dtype="float32"),
    dict(name="(d) causal, Tq > Tk", B=1, Tq=256, Tk=130, Hq=2, Hkv=1,
         D=256, Dv=256, causal=True, window=None, softcap=None,
         dtype="float32"),
    dict(name="(d) non-causal, ragged Tk", B=1, Tq=200, Tk=333, Hq=4, Hkv=2,
         D=64, Dv=64, causal=False, window=None, softcap=None,
         dtype="bfloat16"),
    dict(name="(d) causal, Tq > Tk", B=1, Tq=256, Tk=130, Hq=2, Hkv=1,
         D=256, Dv=256, causal=True, window=None, softcap=None,
         dtype="bfloat16"),
    dict(name="(e) window, rows without keys", B=1, Tq=256, Tk=130, Hq=2,
         Hkv=1, D=128, Dv=128, causal=True, window=64, softcap=30.0,
         dtype="bfloat16"),
    dict(name="(f) T one past 128 = kBK, G 1", B=1, Tq=129, Tk=129, Hq=1,
         Hkv=1, D=128, Dv=128, causal=True, window=None, softcap=None,
         dtype="bfloat16"),
    dict(name="(f) Tk one past kBK = 64, G 8", B=1, Tq=129, Tk=65, Hq=8,
         Hkv=1, D=256, Dv=256, causal=True, window=None, softcap=50.0,
         dtype="bfloat16"),
    dict(name="(f) T one past 128 = kBK, G 2", B=2, Tq=129, Tk=129, Hq=4,
         Hkv=2, D=64, Dv=64, causal=False, window=None, softcap=None,
         dtype="bfloat16"),
    dict(name="(f) T one past 64 = kBK, G 2, window", B=1, Tq=65, Tk=65,
         Hq=2, Hkv=1, D=256, Dv=256, causal=True, window=32, softcap=None,
         dtype="bfloat16")]
# f32: the tests' tolerance, rtol and atol 2e-4 (the kernel sums the same
# products in another order and normalises after the PV product).  bf16,
# per output row (b, t, h) relative to its RMS as for B7: against ref.py in
# f32 on the same values the kernel's only roundings are p and the output
# (BF16_ROW_RTOL_F32); against ref.py in bf16, which also rounds each score
# to bf16 (a score of ~50 moves by up to 0.125, 0.008 after the scale at
# D 256), the sum of the two, as for B8.  Grads: the backward recomputes
# through ref.py on both sides and the loss is linear in the output, so
# they agree to the run-to-run order of the recompute's sums.
FLASH_TOL = 2e-4
FLASH_BF16_ROW_RTOL = 1e-1
FLASH_GRAD_RTOL = 1e-2
# The public op on shapes the strict kernel wrapper refuses (ROADMAP C5),
# at B5's bounds above: (g) D 72 and Dv 40, zero-padded to 80 and 48 in
# bf16 with the scale of D 72 (f32 takes them as they are); (h) q, k and v
# that start 2 bytes off 16 (copied before the launch).
FLASH_PAD_CASES = [
    dict(name="(g) D 72, Dv 40", B=2, Tq=200, Tk=200, Hq=4, Hkv=2, D=72,
         Dv=40, causal=True, window=None, softcap=50.0, dtype="bfloat16"),
    dict(name="(g) D 72, Dv 40", B=2, Tq=200, Tk=200, Hq=4, Hkv=2, D=72,
         Dv=40, causal=True, window=None, softcap=50.0, dtype="float32"),
    dict(name="(h) q, k, v off 16 bytes", B=1, Tq=128, Tk=128, Hq=4, Hkv=2,
         D=64, Dv=64, causal=True, window=None, softcap=None,
         dtype="bfloat16", offset=1)]


def _launch_once(torch, mod, count, fn, path=None, by_path="PATH_LAUNCHES"):
    """``fn()``, which must add one to ``mod.<count>``: the wrapper
    launched its kernel once; with ``path``, also one to
    ``mod.<by_path>[path]`` and nothing to the other paths."""
    before = getattr(mod, count)
    paths = dict(getattr(mod, by_path)) if path else None
    out = fn()
    torch.cuda.synchronize()
    if getattr(mod, count) != before + 1:
        raise AssertionError(f"{count} rose by {getattr(mod, count) - before}"
                             ", not 1")
    if path:
        rose = {k: v - paths[k] for k, v in getattr(mod, by_path).items()
                if v != paths[k]}
        if rose != {path: 1}:
            raise AssertionError(f"launches by path rose by {rose}, not by "
                                 f"one on the {path} path")
    return out


def _tree_rows(torch, N, D, g, dev):
    """[N, D] f32 rows over many magnitudes, with special columns: all +0,
    all -0, +Inf in the first row, -Inf in the last, all subnormal (also
    in bf16)."""
    x = torch.randn(N, D, generator=g, device=dev) * torch.exp(
        2 * torch.randn(N, D, generator=g, device=dev))
    specials = [(slice(None), 0.0), (slice(None), -0.0),
                (0, float("inf")), (-1, -float("inf"))]
    for c, (rows, value) in enumerate(specials[:D]):
        x[rows, c] = value
    if D > len(specials):
        x[:, len(specials)] = torch.tensor(
            [(-1) ** r * (r + 1) * 3e-39 for r in range(N)], device=dev)
    return x


def _tree_path(x, scale=None):
    """The kernel a B3 (x [N, D] f32/bf16) or B4 (x = q [N, nb, 128] int8,
    ``scale``) call must launch: the ring when every row starts on 16 bytes
    (B4: whole groups of 4 codec blocks, so that the rows of scales do too)
    and x (and scale) do, else the ragged kernel."""
    if x.element_size() == 1:
        rows = x.shape[1] % 4 == 0 and scale.data_ptr() % 16 == 0
    else:
        rows = x.shape[1] * x.element_size() % 16 == 0
    return "ring" if rows and x.data_ptr() % 16 == 0 else "ragged"


def _wrap_cols(torch, tops, dtype):
    """A width of ``dtype`` rows at which every ring block takes 2 x stages
    + 1 items of the first pass at 8 rows (3 levels): it goes round its
    ring more than twice."""
    sms, per_sm = tops.ring_occupancy(dtype, torch.float32, 3)
    tile = tops.RING_SLICE_BYTES // torch.empty(0, dtype=dtype).element_size()
    return tile * (2 * tops.ring_stages(3) + 1) * sms * per_sm


def _b3_case(torch, tops, tref, x, label):
    """B3 on x, f32 and bf16 out, each on the path it must take and equal
    to ref.py bit for bit; returns the largest finite |diff|."""
    worst = 0.0
    for od in (torch.float32, torch.bfloat16):
        got = _launch_once(torch, tops, "TREE_SUM_LAUNCHES",
                           lambda: tops.tree_reduce_kernel(x, od),
                           _tree_path(x), "TREE_SUM_LAUNCHES_BY_PATH")
        want = tref.tree_reduce_ref(tref.pad_rows(x), od)
        err = _finite_err(torch, got.float(), want.float())
        worst = max(worst, err)
        if not _same_bits(torch, got, want):
            raise AssertionError(f"B3 {label} {str(x.dtype)[6:]} -> "
                                 f"{str(od)[6:]} differs from ref.py (max "
                                 f"finite |diff| {err:.3e})")
    return worst


def _b4_case(torch, tops, tref, q, sc, label):
    """B4 on (q, sc) on the path it must take, equal to ref.py bit for bit;
    returns the largest finite |diff|."""
    got = _launch_once(torch, tops, "INT8_TREE_SUM_LAUNCHES",
                       lambda: tops.int8_tree_reduce_kernel(q, sc),
                       _tree_path(q, sc), "INT8_TREE_SUM_LAUNCHES_BY_PATH")
    want = tref.int8_tree_reduce_ref(tref.pad_rows(q), tref.pad_rows(sc))
    err = _finite_err(torch, got, want)
    if not _same_bits(torch, got, want):
        raise AssertionError(f"B4 {label} differs from ref.py (max |diff| "
                             f"{err:.3e})")
    return err


def _int8_wire(torch, tops, N, nb, g, dev):
    x = torch.randn(N, nb * 128, generator=g, device=dev) * torch.exp(
        2 * torch.randn(N, nb * 128, generator=g, device=dev))
    wire = tops.encode_rows(x, "int8")
    return wire["q"], wire["scale"]


def phase_tree_kernels(torch, tops, tref, dev):
    """B3 and B4 against ref.py, bit for bit: B3 at every N in ``TREE_NS``
    and D in ``TREE_DS`` and ``TREE_TILE_DS``, f32 and bf16 rows into f32
    and bf16; B4 at every N and nb in ``INT8_TREE_NBS`` and
    ``INT8_TILE_NBS``; at ``TREE_WRAP_NS`` both at a width that wraps every
    ring block more than twice, and on views off 16 bytes.  Each call must
    add one to its launch count and to its path's (``_tree_path``).
    Returns the largest |kernel - ref| over finite outputs of each (0 when
    they are equal)."""
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    worst = {"tree_reduce": 0.0, "int8_tree_reduce": 0.0}
    sms, per_sm = tops.ring_occupancy()
    print(f"  ring grid: {sms} SMs x {per_sm} block(s) an SM, "
          f"{tops.ring_stages(3)} stages of {tops.RING_SLICE_BYTES} B row "
          "slices at 8 rows")
    for N in TREE_NS:
        for D in TREE_DS + TREE_TILE_DS:
            x32 = _tree_rows(torch, N, D, g, dev)
            for dt in (torch.float32, torch.bfloat16):
                x = x32.to(dt)
                worst["tree_reduce"] = max(worst["tree_reduce"], _b3_case(
                    torch, tops, tref, x, f"N={N} D={D}"))
            print(f"  B3 N={N} D={D} (f32 {_tree_path(x32)}, bf16 "
                  f"{_tree_path(x)}): f32/bf16 -> f32/bf16 bit-identical to "
                  f"ref.py (±0, ±Inf, subnormal columns)")
        for nb in INT8_TREE_NBS + INT8_TILE_NBS:
            q, sc = _int8_wire(torch, tops, N, nb, g, dev)
            worst["int8_tree_reduce"] = max(
                worst["int8_tree_reduce"],
                _b4_case(torch, tops, tref, q, sc, f"N={N} nb={nb}"))
        print(f"  B4 N={N} nb={INT8_TREE_NBS + INT8_TILE_NBS}: bit-identical "
              f"to ref.py")
    for N in TREE_WRAP_NS:
        D = _wrap_cols(torch, tops, torch.bfloat16)
        x32 = _tree_rows(torch, N, D, g, dev)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            worst["tree_reduce"] = max(worst["tree_reduce"], _b3_case(
                torch, tops, tref, x, f"N={N} D={D} (ring wrap)"))
            off = _off16(x[:, :2048].contiguous(), 1)
            worst["tree_reduce"] = max(worst["tree_reduce"], _b3_case(
                torch, tops, tref, off, f"N={N} D=2048 off 16 bytes"))
        del x32, x
        nb = _wrap_cols(torch, tops, torch.int8) // 128
        q, sc = _int8_wire(torch, tops, N, nb, g, dev)
        worst["int8_tree_reduce"] = max(
            worst["int8_tree_reduce"],
            _b4_case(torch, tops, tref, q, sc, f"N={N} nb={nb} (ring wrap)"))
        q64, sc64 = q[:, :64].contiguous(), sc[:, :64].contiguous()
        for qq, ss, what in ((_off16(q64, 8), sc64, "q"),
                             (q64, _off16(sc64, 1), "scale")):
            worst["int8_tree_reduce"] = max(
                worst["int8_tree_reduce"],
                _b4_case(torch, tops, tref, qq, ss,
                         f"N={N} nb=64 {what} off 16 bytes"))
        del q, sc
        print(f"  B3 N={N} D={D} and B4 nb={nb} (every ring block past twice "
              f"its stages), and views off 16 bytes (ragged): bit-identical "
              f"to ref.py")
    print(f"  launches by path so far: B3 {tops.TREE_SUM_LAUNCHES_BY_PATH}, "
          f"B4 {tops.INT8_TREE_SUM_LAUNCHES_BY_PATH}")
    return worst


def phase_tree_timing(torch, tops, tref):
    """B3 (f32 rows, and the bf16 wire of ``coded_tree_reduce`` into f32)
    and B4 with their plain versions and library yardsticks at
    ``TREE_TIME_N`` x ``TREE_TIME_D``: device ms per call from a CUDA graph
    of 3 calls.  Returns the rows of the kernel table."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    N, D = TREE_TIME_N, TREE_TIME_D
    x = torch.randn(N, D, generator=g, device=dev)
    res = {}
    xb = tops.encode_rows(x, "bf16")["x"]
    wire = tops.encode_rows(x, "int8")
    q, sc = wire["q"], wire["scale"]
    del wire
    runs = {
        "f32": (dict(kernel=lambda i: tops.tree_reduce_kernel(x),
                     plain=lambda i: tref.tree_reduce_ref(x),
                     library=lambda i: torch.sum(x, 0)),
                N * D * 4 + D * 4, "torch.sum(x, 0)"),
        "bf16": (dict(kernel=lambda i: tops.tree_reduce_kernel(
                          xb, torch.float32),
                      plain=lambda i: tref.tree_reduce_ref(xb,
                                                           torch.float32),
                      library=lambda i: torch.sum(xb, 0,
                                                  dtype=torch.float32)),
                 N * D * 2 + D * 4, "torch.sum(x, 0, dtype=f32)"),
        "int8": (dict(kernel=lambda i: tops.int8_tree_reduce_kernel(q, sc),
                      plain=lambda i: tref.int8_tree_reduce_ref(q, sc)),
                 N * D + N * (D // 128) * 4 + D * 4, None)}
    for name, (fns, nbytes, lib) in runs.items():
        r = _timed(torch, fns, 3, reps=3)
        r.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        res[name] = r
        label = "B4" if name == "int8" else "B3"
        print(f"  {label} {name} rows N={N} D={D}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library "
              + (f"{r['library_ms']:.4f} ms ({lib})" if lib else
                 "none (no one call dequantises and sums)")
              + f", bound {r['bound_ms']:.4f} ms ({nbytes} B at "
              f"{HBM_BYTES_PER_S:.3g} B/s); device time per call from a "
              f"CUDA graph of 3 calls")
    # no one PyTorch call takes int8 codes and f32 scales; the nearest
    # yardstick is two: dequantise, then sum
    two = _time_ms(torch, lambda i: (q * sc).sum(0), 3, reps=3)["graph"]
    res["int8"]["two_call_ms"] = two
    print(f"  B4 two-call yardstick (q * scale).sum(0): {two:.4f} ms")
    # what this card reads the f32 rows at with nothing to write: the
    # whole stack summed to one number
    read = _time_ms(torch, lambda i: torch.sum(x), 3, reps=3)["graph"]
    res["f32"]["read_only_ms"] = read
    print(f"  B3 read-only yardstick torch.sum(x) over the {N * D * 4} B of "
          f"f32 rows: {read:.4f} ms ({N * D * 4 / read / 1e9:.4g} TB/s)")
    return res


def phase_gemm_kernels(torch, gops, gref, dev, cases=None):
    """B6 against ref.py in every ``GEMM_CASES`` case: f32 within
    ``GEMM_F32_TOL``, bf16 per output row within ``GEMM_BF16_ROW_RTOL`` of
    the row's RMS; each call must launch one kernel, on the case's
    ``path``.  Returns the largest absolute and row-relative error."""
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    worst_abs = worst_rel = 0.0
    for case in cases or GEMM_CASES:
        dtype = getattr(torch, case["dtype"])
        M, K, N = case["M"], case["K"], case["N"]
        off = case.get("offset", 0)       # x starts `off` elements in
        x = torch.randn(M * K + off, generator=g, device=dev).to(dtype)
        x = x[off:].view(M, K)
        y = torch.randn(K, N, generator=g, device=dev).to(dtype)
        got = _launch_once(torch, gops, "LAUNCHES",
                           lambda: gops.gemm_kernel(x, y), case["path"])
        want = gref.gemm_ref(x, y)
        err = (got.float() - want.float()).abs().max().item()
        rel = _row_rel_err(got, want)
        line = (f"  B6 {case['dtype']:8s} {case['name']} [{M},{K}] @ "
                f"[{K},{N}] ({case['path']}): max|kernel-ref| = {err:.3e}, "
                f"per row / RMS(ref row) = {rel:.3e}")
        if dtype == torch.float32:
            ok = bool(((got - want).abs() <= GEMM_F32_TOL
                       + GEMM_F32_TOL * want.abs()).all())
            line += f" (rtol = atol = {GEMM_F32_TOL:g})"
        else:
            ok = rel <= GEMM_BF16_ROW_RTOL
            line += f" (row rtol {GEMM_BF16_ROW_RTOL:g})"
        print(line)
        if not ok or got.dtype != dtype or got.shape != (M, N):
            raise AssertionError("gemm kernel disagrees with ref.py: "
                                 + line.strip())
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    return worst_abs, worst_rel


def _gemm_bound(M, K, N):
    """(bound ms, "operations" or "bytes", flop, bytes) of a bf16
    [M, K] @ [K, N]."""
    flops, nbytes = 2 * M * N * K, (M * K + K * N + M * N) * 2
    t_ops, t_bytes = (flops / BF16_FLOPS_PER_S * 1e3,
                      nbytes / HBM_BYTES_PER_S * 1e3)
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def gemm_decode_timing(torch, gops):
    """B6 in bf16 at the decode case of ``GEMM_CASES`` (the second), as
    ``gops.gemm_kernel`` takes it (aligned), and again with x one element
    off 16 bytes, which sends it to the kernel for misaligned inputs (the
    mma path), beside ``torch.matmul`` and the bound.  Only
    ``gemm_kernel`` is called, so this times any B6 that has it."""
    dev = torch.device("cuda", 0)
    case = GEMM_CASES[1]
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    M, K, N = case["M"], case["K"], case["N"]
    x = torch.randn(M * K + 1, generator=g, device=dev).bfloat16()
    xa, xo = x[:-1].view(M, K), x[1:].view(M, K)
    y = torch.randn(K, N, generator=g, device=dev).bfloat16()
    r = _timed(torch, dict(kernel=lambda i: gops.gemm_kernel(xa, y),
                           plain=lambda i: gops.gemm_kernel(xo, y),
                           library=lambda i: torch.matmul(xa, y)), 3, reps=5)
    bound, by, flops, nbytes = _gemm_bound(M, K, N)
    r = dict(ms=r["ms"], misaligned_ms=r["plain_ms"],
             library_ms=r["library_ms"], bound_ms=bound, bound_by=by)
    print(f"  B6 bf16 [{M},{K}] @ [{K},{N}] ({case['name']}): kernel "
          f"{r['ms']:.4f} ms, with x off 16 bytes {r['misaligned_ms']:.4f} "
          f"ms, torch.matmul {r['library_ms']:.4f} ms, bound "
          f"{bound:.4f} ms ({by}: {nbytes} B at {HBM_BYTES_PER_S:.3g} B/s; "
          f"{flops} flop)")
    return r


def phase_gemm_timing(torch, gops, gref):
    """B6, its plain version (f32 matmul, TF32 off) and ``torch.matmul`` in
    bf16 at the first ``GEMM_CASES`` shape; then ``gemm_decode_timing``
    with the wgmma and the mma path at the decode shape, kept under
    ``decode``."""
    dev = torch.device("cuda", 0)
    case = GEMM_CASES[0]
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    M, K, N = case["M"], case["K"], case["N"]
    x = torch.randn(M, K, generator=g, device=dev).bfloat16()
    y = torch.randn(K, N, generator=g, device=dev).bfloat16()
    r = _timed(torch, dict(kernel=lambda i: gops.gemm_kernel(x, y),
                           plain=lambda i: gref.gemm_ref(x, y),
                           library=lambda i: torch.matmul(x, y)), 3, reps=5)
    bound, by, flops, nbytes = _gemm_bound(M, K, N)
    r.update(bound_ms=bound, bound_by=by)
    print(f"  B6 bf16 [{M},{K}] @ [{K},{N}] ({case['name']}): kernel "
          f"{r['ms']:.4f} ms ({flops / r['ms'] / 1e9:.1f} TFLOP/s), plain "
          f"{r['plain_ms']:.4f} ms, torch.matmul {r['library_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {flops} flop at "
          f"{BF16_FLOPS_PER_S:.3g} flop/s; {nbytes} B at "
          f"{HBM_BYTES_PER_S:.3g} B/s)")
    del x, y
    paths = dict(gops.PATH_LAUNCHES)
    r["decode"] = gemm_decode_timing(torch, gops)
    rose = {k for k, v in gops.PATH_LAUNCHES.items() if v != paths[k]}
    if rose != {"wgmma", "mma"}:
        raise AssertionError(f"the decode timing ran on {sorted(rose)}, not "
                             "on the wgmma and the mma path")
    return r


def _flash_inputs(torch, case, g, dev, spare=0):
    """q, k, v of ``case``; with ``spare`` > 0 (B == 1), k and v are the
    first Tk rows of buffers whose ``spare`` rows past Tk hold NaN."""
    dtype = getattr(torch, case["dtype"])
    B, Tq, Tk = case["B"], case["Tq"], case["Tk"]
    Hq, Hkv, D, Dv = case["Hq"], case["Hkv"], case["D"], case["Dv"]
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    q = mk(B, Tq, Hq, D)
    k, v = mk(B, Tk + spare, Hkv, D), mk(B, Tk + spare, Hkv, Dv)
    k[:, Tk:] = float("nan")
    v[:, Tk:] = float("nan")
    return q, k[:, :Tk], v[:, :Tk]


def _flash_kw(case):
    return dict(causal=case["causal"], window=case["window"],
                softcap=case["softcap"])


def phase_flash_kernels(torch, fops, fref, dev, cases=None):
    """B5 against ref.py in every ``FLASH_CASES`` case, on the rows that
    see at least one key (rows that see none must come out 0): f32 within
    ``FLASH_TOL``; bf16 per output row against ref.py in f32 and in bf16.
    Keys past Tk hold NaN (B == 1), which must not move the output.  A case
    with ``grad`` also runs the op's backward against the plain version's
    autograd.  Returns the largest absolute and bf16 row-relative error
    (against ref.py in f32)."""
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    worst_abs = worst_rel = 0.0
    for case in cases or FLASH_CASES:
        dtype = getattr(torch, case["dtype"])
        kw = _flash_kw(case)
        q, k, v = _flash_inputs(torch, case, g, dev,
                                spare=37 if case["B"] == 1 else 0)
        seen = fref.attention_mask(case["Tq"], case["Tk"], causal=kw[
            "causal"], window=kw["window"], device=dev).any(-1)
        path = "f32" if dtype == torch.float32 else "wgmma"
        out = _launch_once(torch, fops, "LAUNCHES",
                           lambda: fops.flash_attention_kernel(q, k, v, **kw),
                           path)
        err, rel = _flash_compare(torch, fops, case, q, k, v, out, seen,
                                  path)
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        if case["B"] == 1:
            clean = _launch_once(torch, fops, "LAUNCHES",
                                 lambda: fops.flash_attention_kernel(
                                     q, k.clone(), v.clone(), **kw), path)
            if not _same_bits(torch, clean, out):
                raise AssertionError("NaN past Tk reached the B5 kernel's "
                                     f"output: {case['name']}")
        if case.get("grad"):
            _flash_grad_check(torch, fops, case, q, k, v, g)
        del out
    print("  B5 NaN in K/V rows past Tk: output unchanged, bit for bit")
    return worst_abs, worst_rel


def _flash_compare(torch, fops, case, q, k, v, out, seen, path):
    """Hold ``out`` to ref.py on the rows that see a key (rows that see
    none must be 0): f32 within ``FLASH_TOL``; bf16 per output row against
    ref.py in f32 and in bf16.  Prints the case's line, raises on a
    disagreement; returns the absolute and the bf16 row-relative error
    (against ref.py in f32; 0 in f32)."""
    kw = _flash_kw(case)
    want = fops.flash_attention_heads_ref(q, k, v, **kw)
    err = (out.float() - want.float())[:, seen].abs().max().item()
    shape = (f"B={case['B']} Tq={case['Tq']} Tk={case['Tk']} "
             f"Hq={case['Hq']} Hkv={case['Hkv']} D={case['D']} "
             f"Dv={case['Dv']} causal={kw['causal']} "
             f"window={kw['window']} softcap={kw['softcap']}")
    line = (f"  B5 {case['dtype']:8s} {case['name']}: {shape} "
            f"({path}): max|kernel-ref| = {err:.3e}")
    if out.dtype == torch.float32:
        ok = bool(((out - want)[:, seen].abs() <= FLASH_TOL
                   + FLASH_TOL * want[:, seen].abs()).all())
        line += f" (rtol = atol = {FLASH_TOL:g})"
        rel = 0.0
    else:
        want32 = fops.flash_attention_heads_ref(q.float(), k.float(),
                                                v.float(), **kw)
        rel = _row_rel_err(out[:, seen], want32[:, seen])
        rel16 = _row_rel_err(out[:, seen], want[:, seen])
        ref16 = _row_rel_err(want[:, seen], want32[:, seen])
        ok = rel <= BF16_ROW_RTOL_F32 and rel16 <= FLASH_BF16_ROW_RTOL
        line += (f"; per row / RMS(ref row): vs ref.py in f32 {rel:.3e} "
                 f"(rtol {BF16_ROW_RTOL_F32:g}), vs bf16 ref.py "
                 f"{rel16:.3e} (rtol {FLASH_BF16_ROW_RTOL:g}; bf16 "
                 f"ref.py vs f32 {ref16:.3e})")
    blind = (~seen).sum().item()
    if blind:
        line += f"; {blind} rows see no key"
        ok = ok and bool((out[:, ~seen] == 0).all())
    print(line)
    if not ok or tuple(out.shape) != tuple(want.shape):
        raise AssertionError("flash_attention kernel disagrees with "
                             "ref.py: " + line.strip())
    return err, rel


def _off16(t, off):
    """A copy of ``t`` that starts ``off`` elements into a fresh buffer:
    contiguous, and off 16 bytes for an odd ``off`` in bf16."""
    v = t.new_empty(t.numel() + off)[off:].view(t.shape)
    v.copy_(t)
    return v


def phase_flash_padding(torch, fops, fref, dev, cases=None):
    """The public ``flash_attention`` op on what the strict kernel wrapper
    refuses (ROADMAP C5): each ``FLASH_PAD_CASES`` case through
    ``fops.flash_attention``, one launch of the case's kernel, held to
    ref.py as ``phase_flash_kernels`` holds the kernel; then D past the
    card's limit must raise, launching nothing.  Returns the largest
    absolute and bf16 row-relative error."""
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    worst_abs = worst_rel = 0.0
    for case in cases or FLASH_PAD_CASES:
        kw = _flash_kw(case)
        q, k, v = (_off16(t, case.get("offset", 0))
                   for t in _flash_inputs(torch, case, g, dev))
        if case.get("offset") and not all(t.data_ptr() % 16 for t in
                                          (q, k, v)):
            raise AssertionError("the off-16-byte case is aligned")
        seen = fref.attention_mask(case["Tq"], case["Tk"], causal=kw[
            "causal"], window=kw["window"], device=dev).any(-1)
        path = "f32" if q.dtype == torch.float32 else "wgmma"
        out = _launch_once(torch, fops, "LAUNCHES",
                           lambda: fops.flash_attention(q, k, v, **kw), path)
        err, rel = _flash_compare(torch, fops, case, q, k, v, out, seen,
                                  f"public op, {path}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    big = torch.zeros(1, 16, 2, fops.MAX_HEAD_DIM + 8, dtype=torch.bfloat16,
                      device=dev)
    before = fops.LAUNCHES
    try:
        fops.flash_attention(big, big, big)
    except ValueError as exc:
        if str(fops.MAX_HEAD_DIM) not in str(exc):
            raise AssertionError(f"D past the limit: unclear error {exc}")
        print(f"  B5 public op, D = Dv = {big.shape[-1]}: raises "
              f"ValueError({exc}), no launch")
    else:
        raise AssertionError(f"D = {big.shape[-1]} did not raise")
    if fops.LAUNCHES != before:
        raise AssertionError("a refused shape launched a kernel")
    return worst_abs, worst_rel


def _flash_grad_check(torch, fops, case, q, k, v, g):
    """The op's backward (kernel forward, recompute through ref.py) against
    autograd through the plain version, for a loss linear in the output."""
    kw = _flash_kw(case)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = _launch_once(torch, fops, "LAUNCHES",
                       lambda: fops.flash_attention(*leaves, **kw))
    w = torch.randn(out.shape, generator=g, device=out.device)
    got = torch.autograd.grad((out.float() * w).sum(), leaves)
    plain = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref_out = fops.flash_attention_heads_ref(*plain, **kw)
    want = torch.autograd.grad((ref_out.float() * w).sum(), plain)
    errs = []
    for name, a, b in zip("qkv", got, want):
        rms = b.float().pow(2).mean().sqrt().item()
        e = (a.float() - b.float()).abs().max().item() / max(rms, 1e-30)
        errs.append(f"d{name} {e:.3e}")
        if a.shape != b.shape or a.dtype != b.dtype or \
                not e <= FLASH_GRAD_RTOL:
            raise AssertionError(f"B5 backward {case['name']}: d{name} "
                                 f"max|diff| / RMS = {e:.3e}")
    print(f"  B5 {case['name']} backward vs the plain version's autograd: "
          f"max|diff| / RMS(grad): {', '.join(errs)} (rtol "
          f"{FLASH_GRAD_RTOL:g})")


def phase_flash_timing(torch, fops, fref):
    """B5, its plain version and ``F.scaled_dot_product_attention`` (GQA,
    no softcap: SDPA has none; the window as a boolean mask) at cases (a),
    (a) without the softcap (the same work as SDPA's) and (b).  Returns the
    rows of the kernel table in that order."""
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    res = []
    a, b = FLASH_CASES[:2]
    for case in (a, dict(a, name=a["name"] + ", no softcap", softcap=None),
                 b):
        kw = _flash_kw(case)
        q, k, v = _flash_inputs(torch, case, g, dev)
        Tq, Tk = case["Tq"], case["Tk"]
        mask = fref.attention_mask(Tq, Tk, **{
            n: kw[n] for n in ("causal", "window")}, device=dev)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_mask = None if kw["window"] is None and Tq == Tk else mask
        heavy = Tq * Tk * case["B"] * case["Hq"] > 1 << 28
        r = _timed(torch, dict(
            kernel=lambda i: fops.flash_attention_kernel(q, k, v, **kw),
            plain=lambda i: fops.flash_attention_heads_ref(q, k, v, **kw),
            library=lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask,
                is_causal=sdpa_mask is None and kw["causal"],
                enable_gqa=True)), 1 if heavy else 3, reps=3)
        pairs = int(mask.sum().item()) * case["B"] * case["Hq"]
        flops = 2 * (case["D"] + case["Dv"]) * pairs
        nbytes = (q.numel() + k.numel() + v.numel()
                  + q.numel() // case["D"] * case["Dv"]) * q.element_size()
        t_ops, t_bytes = (flops / BF16_FLOPS_PER_S * 1e3,
                          nbytes / HBM_BYTES_PER_S * 1e3)
        r.update(bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 case=case["name"])
        print(f"  B5 {case['name']}: kernel {r['ms']:.4f} ms "
              f"({flops / r['ms'] / 1e9:.1f} TFLOP/s), plain "
              f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
              f"(enable_gqa, "
              + ("NO softcap" if kw["softcap"] else "like for like")
              + (", window as a boolean mask" if sdpa_mask is not None
                 else ", is_causal") + f"), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {flops} flop over {pairs} visible "
              f"(query, key, head) triples at {BF16_FLOPS_PER_S:.3g} "
              f"flop/s; {nbytes} B at {HBM_BYTES_PER_S:.3g} B/s)")
        res.append(r)
        del q, k, v, qt, kt, vt
    return res


def phase_kernel_ops(torch, tops, tref, gops, fops, dev):
    """This slice's main path, the public ops a user calls, at the timed
    shapes: ``tree_reduce`` and ``coded_tree_reduce`` (bf16, int8) over 8
    rows of a 256 MB bucket, ``gemm`` at gemma2-2b's MLP up-projection,
    ``flash_attention`` forward and backward at gemma2-2b's global layer.
    The four launch counts are set to 0 just before and read just after;
    each kernel must have run.  The three sums are held to their plain
    versions on the same rows and wires bit for bit (and ``tree_reduce``
    also to an f64 sum: f32 rounding, 8 adds of at most |x| each), the
    rest to finite values of the right shape; the GEMM and the attention
    must each have launched their wgmma kernel once, the three sums the
    ring kernels.  Returns the counts and the ops' counts by path."""
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    N, D = TREE_TIME_N, TREE_TIME_D
    x = torch.randn(N, D, generator=g, device=dev)
    wires = {c: tops.encode_rows(x, c) for c in ("bf16", "int8")}
    gc_ = GEMM_CASES[0]
    a = torch.randn(gc_["M"], gc_["K"], generator=g, device=dev).bfloat16()
    b = torch.randn(gc_["K"], gc_["N"], generator=g, device=dev).bfloat16()
    fc = FLASH_CASES[0]
    qkv = [t.requires_grad_() for t in _flash_inputs(torch, fc, g, dev)]
    tops.TREE_SUM_LAUNCHES = tops.INT8_TREE_SUM_LAUNCHES = 0
    gops.LAUNCHES = fops.LAUNCHES = 0
    by_path = [gops.PATH_LAUNCHES, fops.PATH_LAUNCHES,
               tops.TREE_SUM_LAUNCHES_BY_PATH,
               tops.INT8_TREE_SUM_LAUNCHES_BY_PATH]
    for launches in by_path:
        launches.update(dict.fromkeys(launches, 0))
    s = tops.tree_reduce(x)
    coded = {c: tops.coded_tree_reduce(w, c) for c, w in wires.items()}
    mm = gops.gemm(a, b)
    o = fops.flash_attention(*qkv, **_flash_kw(fc))
    grads = torch.autograd.grad(o.float().pow(2).mean(), qkv)
    torch.cuda.synchronize()
    counts = {"tree_reduce": tops.TREE_SUM_LAUNCHES,
              "int8_tree_reduce": tops.INT8_TREE_SUM_LAUNCHES,
              "gemm": gops.LAUNCHES, "flash_attention": fops.LAUNCHES}
    want = {"tree_reduce": 2, "int8_tree_reduce": 1, "gemm": 1,
            "flash_attention": 1}
    if counts != want:
        raise AssertionError(f"kernel launches on the ops path {counts}, "
                             f"want {want}")
    paths = {"gemm": dict(gops.PATH_LAUNCHES),
             "flash_attention": dict(fops.PATH_LAUNCHES),
             "tree_reduce": dict(tops.TREE_SUM_LAUNCHES_BY_PATH),
             "int8_tree_reduce": dict(tops.INT8_TREE_SUM_LAUNCHES_BY_PATH)}
    want_paths = {"gemm": {"wgmma": 1}, "flash_attention": {"wgmma": 1},
                  "tree_reduce": {"ring": 2}, "int8_tree_reduce": {"ring": 1}}
    for name, launched in paths.items():
        if {k: v for k, v in launched.items() if v} != want_paths[name]:
            raise AssertionError(f"{name} on the ops path launched "
                                 f"{launched}, not {want_paths[name]}")
    plain = {"tree_reduce": (s, tref.tree_reduce_ref(tref.pad_rows(x))),
             "coded_tree_reduce bf16": (coded["bf16"], tref.tree_reduce_ref(
                 tref.pad_rows(wires["bf16"]["x"]), torch.float32)),
             "coded_tree_reduce int8": (coded["int8"],
                                        tref.int8_tree_reduce_ref(
                 tref.pad_rows(wires["int8"]["q"]),
                 tref.pad_rows(wires["int8"]["scale"])))}
    for name, (got, want) in plain.items():
        if not _same_bits(torch, got, want):
            raise AssertionError(f"{name} over {N} x {D} differs from "
                                 f"ref.py (max |diff| "
                                 f"{_finite_err(torch, got, want):.3e})")
    del plain, wires
    exact = x.double().sum(0)
    slack = 8 * 2.0 ** -23 * x.double().abs().sum(0)
    if not bool(((s.double() - exact).abs() <= slack).all()):
        raise AssertionError("tree_reduce is off its f64 sum by more than "
                             "f32 rounding")
    for c, r in coded.items():
        if r.dtype != torch.float32 or r.shape != (D,) or \
                not torch.isfinite(r).all():
            raise AssertionError(f"coded_tree_reduce {c}: bad output")
    outs = [("gemm", mm, (gc_["M"], gc_["N"])),
            ("flash_attention", o, (fc["B"], fc["Tq"], fc["Hq"], fc["Dv"]))]
    outs += [(f"d{n}", t, tuple(w.shape)) for n, t, w in
             zip("qkv", grads, qkv)]
    for name, t, shape in outs:
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise AssertionError(f"{name}: shape {tuple(t.shape)} (want "
                                 f"{shape}) or non-finite values")
    err = {c: (r.double() - exact).abs().max().item()
           for c, r in coded.items()}
    print(f"  ops path: tree_reduce, coded_tree_reduce (bf16, int8) over "
          f"{N} x {D} f32, gemm [{gc_['M']},{gc_['K']}] @ "
          f"[{gc_['K']},{gc_['N']}], flash_attention {fc['name']} forward "
          f"+ backward: launches {counts}, by path {paths}; tree_reduce "
          f"and coded bf16 / int8 bit-identical to ref.py; tree_reduce "
          f"within f32 rounding "
          f"of the f64 sum; coded bf16 / int8 off it by {err['bf16']:.3e} "
          f"/ {err['int8']:.3e} (the wire codecs); all finite")
    return counts, paths


# ---------------------------------------------------------------------------
# phases 3-4 and 6-7: full-width serving
# ---------------------------------------------------------------------------


def ds_config():
    """DeepSeek-V3 at its published widths, cut to ``DS_CUT``."""
    import dataclasses
    from repro_torch.models.registry import get_config
    return dataclasses.replace(get_config("deepseek-v3-671b"), **DS_CUT)


def jamba_config():
    """jamba-v0.1-52b at its published widths, cut to its first
    ``JAMBA_CUT_LAYERS`` layers (whole 8-layer units)."""
    import dataclasses
    from repro_torch.models.registry import get_config
    cfg = get_config("jamba-v0.1-52b")
    return dataclasses.replace(
        cfg, num_layers=JAMBA_CUT_LAYERS,
        layer_pattern=cfg.layer_pattern[:JAMBA_CUT_LAYERS])


def _kernel_layers(cfg):
    """Layers whose paged decode runs a kernel: (B7 layers, B8 layers)."""
    from repro_torch.models import transformer as T
    return (sum(k in T.ATTN_KINDS for k in cfg.layer_pattern),
            sum(k in T.MLA_KINDS for k in cfg.layer_pattern))


class _Recorder:
    """Wraps ``transformer.prefill_chunk`` and ``transformer.prefill`` while
    a serve run calls them, keeping each request's first-token logits (the
    last real prompt position of its final chunk, or of the wave's batch
    prefill) on the card, keyed after the run by the prompt's last
    ``tail`` tokens."""

    def __init__(self, T, tail):
        self.T, self.tail, self.kept = T, tail, []

    def __enter__(self):
        T, kept = self.T, self.kept
        self.chunk, self.whole = T.prefill_chunk, T.prefill

        def chunk(params, cfg, tokens, cache, offset, with_logits=True,
                  **kw):
            lg, cache = self.chunk(params, cfg, tokens, cache, offset,
                                   with_logits=with_logits, **kw)
            if with_logits:
                last = (kw.get("valid") or tokens.shape[1]) - 1
                kept.append((tokens[:, :last + 1].clone(),
                             lg[:, last].clone()))
            return lg, cache

        def whole(params, cfg, tokens, cache):
            lg, cache, n = self.whole(params, cfg, tokens, cache)
            kept.append((tokens.clone(), lg[:, -1].clone()))
            return lg, cache, n

        T.prefill_chunk, T.prefill = chunk, whole
        return self

    def __exit__(self, *exc):
        self.T.prefill_chunk, self.T.prefill = self.chunk, self.whole

    def logits(self):
        """{prompt tail: f32 logits [V]}."""
        out = {}
        for toks, lg in self.kept:
            for t, row in zip(toks.tolist(), lg.float()):
                out[tuple(t[-self.tail:])] = row
        return out


def phase_serve(torch, ops, cfg, argv, out=None):
    """The main serve path, ``launch.serve.run(cfg, args)``; the kernels'
    counts are set to 0 just before and read just after.  Returns the
    launches of the paged decode kernel of ``cfg``'s attention (B8 for
    MLA, B7 otherwise) and of its merge: one per attention layer per
    decode step over the paged cache, none over the contiguous one or in
    a wave.  With ``out`` (a dict) the run also keeps its outputs
    (``results``), its first-token logits (``first``) and its engine's
    resources at the end (``pools``: rows and blocks in use)."""
    import repro_torch.serve as serve_pkg
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer as T
    dev = torch.device("cuda", 0)
    args = serve_cli.parse_args(argv)
    engines = []

    class Kept(serve_pkg.ServeEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    torch.cuda.reset_peak_memory_stats(dev)
    plain = serve_pkg.ServeEngine
    serve_pkg.ServeEngine = Kept
    rec = _Recorder(T, args.prefill_chunk)
    try:
        with rec:
            ops.LAUNCHES = ops.MLA_LAUNCHES = 0
            ops.MERGE_LAUNCHES = ops.MLA_MERGE_LAUNCHES = 0
            t0 = time.perf_counter()
            results, metrics = serve_cli.run(cfg, args)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            gqa = (ops.LAUNCHES, ops.MERGE_LAUNCHES)
            mla = (ops.MLA_LAUNCHES, ops.MLA_MERGE_LAUNCHES)
    finally:
        serve_pkg.ServeEngine = plain
    name, (launches, merges), other = (
        ("paged_mla_attention", mla, gqa) if cfg.mla
        else ("paged_attention", gqa, mla))
    s = metrics.summary()
    if s["completed"] != args.requests or len(results) != args.requests:
        raise AssertionError(f"{s['completed']}/{args.requests} requests "
                             "completed")
    for rid, toks in results.items():
        if not 1 <= len(toks) <= args.gen or \
                not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid}: bad output {toks[:8]}... "
                                 f"(vocab {cfg.vocab_size})")
    paged = args.kv_mode == "paged" and args.mode == "continuous"
    layers = sum(_kernel_layers(cfg)) if paged else 0
    want = layers * metrics.decode_steps
    if launches != want or merges != want or any(other):
        raise AssertionError(
            f"{name} launches {launches}, merges {merges}, want "
            f"{layers} paged attention layers x {metrics.decode_steps} "
            f"decode steps of each (other kernel and merge: {other})")
    pools = [(e.rec.num_used if e.rec is not None else 0,
              e.allocator.num_used if e.allocator is not None else 0)
             for e in engines if e.rec is not None or e.allocator is not None]
    engines.clear()
    if any(r or b for r, b in pools):
        raise AssertionError(f"rows and blocks still in use after the run: "
                             f"{pools}")
    peak = torch.cuda.max_memory_allocated(dev)
    where = (f"{args.mode}, {args.kv_mode} cache"
             + (f", {args.rec_slots} recurrent rows" if args.rec_slots
                else ""))
    print(f"  serve {cfg.name} ({where}): {s['completed']}/{args.requests} "
          f"completed, {s['tokens_out']} tokens (all < vocab "
          f"{cfg.vocab_size}), {metrics.decode_steps} decode steps, "
          f"{launches} {name} launches and {merges} merges (each = "
          f"{layers} x decode steps), engine "
          f"{s['tokens_per_s']:.1f} tok/s over {s['wall_s']:.2f} s (run() "
          f"incl. init {wall:.2f} s), TTFT p50 {s['ttft_p50_s']:.3f} s / "
          f"p95 {s['ttft_p95_s']:.3f} s, peak memory {peak / 2**30:.2f} GiB "
          f"({peak / 1e9:.1f} GB)" + ("; every recurrent row and block "
                                      "back in its pool" if pools else ""))
    if out is not None:
        out.update(results=results, first=rec.logits(), summary=s,
                   kept=rec.kept, args=args)
    return launches, merges


def phase_wave(torch, ops, cfg, argv, cont, atol):
    """``--mode wave`` (``serve_waves``, the oracle) on the requests of the
    continuous run ``cont`` (``phase_serve``'s ``out``): every request's
    first-token logits within ``atol`` of the continuous engine's, and the
    fraction of token-identical outputs, printed, not asserted.  Beside
    them the batch floor: the wave's first prompt prefilled again alone
    (batch 1, the same whole-prompt call), whose logits differ from the
    wave's row only by the GEMM shapes."""
    from repro_torch.models import transformer as T
    wave = {}
    t0 = time.perf_counter()
    phase_serve(torch, ops, cfg, argv + ["--mode", "wave"], out=wave)
    if sorted(wave["first"]) != sorted(cont["first"]):
        raise AssertionError("the wave and the continuous run prefilled "
                             "different prompts")
    keys = sorted(cont["first"])
    errs = [(wave["first"][k] - cont["first"][k]).abs().max().item()
            for k in keys]
    same = sum(wave["results"][r] == cont["results"][r]
               for r in cont["results"])
    agree = sum(wave["first"][k].argmax().item()
                == cont["first"][k].argmax().item() for k in keys)
    big = max(cont["first"][k].abs().max().item() for k in keys)
    args = wave["args"]
    dev = cont["first"][keys[0]].device
    toks, wave_lg = wave["kept"][0]
    params = T.init_params(cfg, args.seed, device=dev)
    max_len = args.prompt_len + args.gen + 1
    with torch.inference_mode():
        alone = T.prefill(params, cfg, toks[:1],
                          T.init_cache(cfg, 1, max_len, device=dev))[0]
    del params
    key = tuple(toks[0, -args.prefill_chunk:].tolist())
    floor = (alone[0, -1].float() - wave_lg[0].float()).abs().max().item()
    chunked = (alone[0, -1].float() - cont["first"][key]).abs().max().item()
    print(f"  wave vs continuous ({cfg.name}): first-token logits max|diff| "
          f"{max(errs):.4e} (atol {atol}; median "
          f"{sorted(errs)[len(errs) // 2]:.4e}; |logits| <= {big:.3f}), "
          f"first tokens equal for {agree}/{len(errs)}, outputs "
          f"token-identical for {same}/{len(cont['results'])} requests "
          f"({same / len(cont['results']) * 100:.0f}%); batch floor "
          f"(prompt 0 prefilled alone vs in the wave of "
          f"{toks.shape[0]}) {floor:.4e}, alone vs the engine's chunks at "
          f"batch 1 {chunked:.4e}; wave phase "
          f"{time.perf_counter() - t0:.1f} s")
    if not max(errs) <= atol:
        raise AssertionError(f"wave first-token logits differ by "
                             f"{max(errs)}")
    return same / len(cont["results"])


def _decode_setup(torch, T, params, cfg, dev, contiguous):
    """B rows, the last one masked (the sentinel offset; the sentinel
    recurrent row), the others prefilled with the same 256-token prompts in
    64-token chunks, over a paged cache (block 16) or a contiguous one;
    recurrent layers on pooled rows 1..B-1 either way (a model without KV
    prefills every row in one call a chunk).  Returns
    (cache, args, kwargs) of a decode step, a prefill-chunk call for the
    profile and the prefill's seconds (host clock, synchronised)."""
    import numpy as np
    B, bs, C, plen = 8, 16, 64, 256
    n = -(-(plen + 65) // bs)
    S = n * bs
    rec = T.has_recurrent(cfg)
    if contiguous:
        cache = (T.init_hybrid_cache(cfg, kv_batch=B, kv_len=S,
                                     rec_batch=B + 1, device=dev) if rec
                 else T.init_cache(cfg, B, S, device=dev))
    else:
        cache = (T.init_hybrid_cache(cfg, kv_batch=1 + B * n, kv_len=bs,
                                     rec_batch=B + 1, device=dev) if rec
                 else T.init_paged_cache(cfg, 1 + B * n, bs, device=dev))
    tables = np.zeros((B, n), np.int32)
    rng = np.random.default_rng(2)

    def prefill_into(b, toks, s, cache):
        kw = dict(with_logits=False)
        if rec:
            kw.update(rec_rows=torch.tensor([b + 1], device=dev), valid=C)
        if contiguous:
            sub = T.take_state(cfg, cache, b)
            _, sub = T.prefill_chunk(params, cfg, toks, sub, s, **kw)
            return T.write_state(cfg, cache, sub, b)
        row = torch.from_numpy(tables[b:b + 1]).to(dev)
        return T.prefill_chunk(params, cfg, toks, cache, s,
                               block_tables=row, **kw)[1]

    _sync(torch, dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        prompts = [torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(1, plen))).to(dev) for _ in range(B - 1)]
        prompt = prompts[-1]
        if not T.has_attention(cfg):
            # no KV to place per slot: every row's chunk in one call
            rows = torch.arange(1, B, device=dev)
            for s in range(0, plen, C):
                cache = T.prefill_chunk(
                    params, cfg, torch.cat(prompts)[:, s:s + C], cache, s,
                    with_logits=False, rec_rows=rows, valid=C)[1]
        else:
            for b in range(B - 1):
                tables[b] = 1 + b * n + np.arange(n)
                for s in range(0, plen, C):
                    cache = prefill_into(b, prompts[b][:, s:s + C], s,
                                         cache)
    _sync(torch, dev)
    prefill_s = time.perf_counter() - t0
    offs = np.full(B, plen, np.int32)
    offs[-1] = S - 1
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        size=(B, 1))).to(dev)
    args = (tok, cache, torch.from_numpy(offs).to(dev))
    kw = {}
    if not contiguous:
        kw["block_tables"] = torch.from_numpy(tables).to(dev)
    if rec:
        kw["rec_rows"] = torch.tensor(list(range(1, B)) + [0], device=dev)
        kw["active"] = torch.tensor([True] * (B - 1) + [False], device=dev)
    chunk = lambda: prefill_into(B - 2, prompt[:, :C], 0, cache)
    return cache, args, kw, chunk, prefill_s


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rec_snapshot(T, cfg, cache):
    """Copies of the recurrent leaves, which a decode step advances (KV
    writes repeat the same values, so the KV leaves need none)."""
    return {i: {k: x.clone() for k, x in cache[i].items()}
            for i, kind in enumerate(cfg.layer_pattern)
            if kind in T.REC_KINDS}


def _rec_restore(cache, snap):
    for i, leaves in snap.items():
        for k, x in leaves.items():
            cache[i][k].copy_(x)


def phase_decode_step(torch, cfg, dev, atol, contiguous=None):
    """One decode step on one cache: kernel vs gather lowering (both twice
    for MoE models, whose bf16 combine is atomic: the ref-vs-ref spread is
    the run-to-run floor).  With ``contiguous`` (a tolerance), the same
    step over a contiguous cache holding the same prompts too: its logits
    within that of the kernel's, no synchronising call, and its profile.
    Every call starts from the same recurrent state."""
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, 1, device=dev)
    cache, args, kw, chunk, prefill_s = _decode_setup(
        torch, T, params, cfg, dev, contiguous=False)
    snap = _rec_snapshot(T, cfg, cache)

    def step(kernel, args=args, kw=kw, snap=snap):
        _rec_restore(args[1], snap)
        return T.decode_step(params, cfg, *args, paged_kernel=kernel,
                             **kw)[0]

    B = args[0].shape[0]
    with torch.inference_mode():
        lk, lr = step("auto"), step("ref")
        lr2 = step("ref") if cfg.moe else lr
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
    if contiguous is not None:
        ccache, cargs, ckw, cchunk, cpre = _decode_setup(
            torch, T, params, cfg, dev, contiguous=True)
        csnap = _rec_snapshot(T, cfg, ccache)
        cstep = lambda: (_rec_restore(ccache, csnap), T.decode_step(
            params, cfg, *cargs, **ckw))[1]
        with torch.inference_mode():
            lc = cstep()[0]
        cerr = (lc[live] - lk[live]).abs().max().item()
        rerr = (lc[live] - lr[live]).abs().max().item()
        print(f"  decode step {cfg.name} over the contiguous cache: "
              f"max|logits(contiguous) - logits(paged kernel)| = "
              f"{cerr:.4e} (atol {contiguous}), vs the paged gather "
              f"lowering {rerr:.4e}; prefill of 7 x 256 tokens "
              f"{cpre:.2f} s contiguous, {prefill_s:.2f} s paged")
        if not (torch.isfinite(lc).all() and cerr <= contiguous):
            raise AssertionError(f"contiguous decode logits differ by "
                                 f"{cerr}")
        with torch.inference_mode():
            _sync_free(torch, cstep, call="one decode_step over the "
                       "contiguous cache")
        _profile_steps(torch, cfg, dev, cstep, cchunk, kernel=False)
        del ccache, cargs, csnap
    with torch.inference_mode():
        _sync_free(torch, lambda: step("auto"))
    _profile_steps(torch, cfg, dev, lambda: step("auto"), chunk)


def phase_recurrent_step(torch, cfg, dev):
    """A pure-recurrent model's decode step (no KV cache: nothing to page,
    no paged-attention kernel): 7 rows prefilled through pooled state rows,
    the prefill's seconds (the eager per-token scan), then a profiled
    decode step (host ms, device ms, idle share)."""
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, 1, device=dev)
    cache, args, kw, chunk, prefill_s = _decode_setup(
        torch, T, params, cfg, dev, contiguous=True)
    snap = _rec_snapshot(T, cfg, cache)
    step = lambda: (_rec_restore(cache, snap),
                    T.decode_step(params, cfg, *args, **kw))[1]
    with torch.inference_mode():
        lg = step()[0]
    if not torch.isfinite(lg[:-1]).all():
        raise AssertionError("recurrent decode logits not finite")
    print(f"  {cfg.name}: prefill of 7 x 256 tokens, 4 chunks of 7 x 64, "
          f"through pooled rows {prefill_s:.2f} s ({prefill_s / 4 * 1e3:.1f} "
          f"ms a chunk, {prefill_s / 256 * 1e3:.2f} ms a step of the scan)")
    _profile_steps(torch, cfg, dev, step, chunk, kernel=False)


def _sync_free(torch, step, what="the decode forward",
               call="one decode_step"):
    """One ``step()`` (e.g. a decode forward, every input already on the
    card) under ``torch.cuda.set_sync_debug_mode("error")``: a synchronising
    call raises.  If one does, the step runs again under "warn" to list
    every call site, and the phase fails."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
        first = None
    except RuntimeError as exc:
        first = exc
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if first is None:
        print(f"  0 synchronising calls in {what} ({call} under "
              "torch.cuda.set_sync_debug_mode('error'))")
        return
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = [f"{w.filename}:{w.lineno}" for w in seen
             if "synchroniz" in str(w.message)]
    raise AssertionError(f"{len(sites)} synchronising calls in {what} "
                         f"({first}): {sites}")


def _self_device_us(evt):
    """An op's own device time (us) in a ``key_averages`` entry."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _span_us(events):
    """The time (us) the card spent on any of ``events``: the union of
    their intervals, so that a kernel launched early as a programmatic
    dependent (the paged decode kernels' merges), whose interval includes
    its wait on the kernel before it, is not counted twice."""
    total, end = 0.0, -math.inf
    for e in sorted(events, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


def _profile_steps(torch, cfg, dev, step, chunk, kernel=True):
    """Where a full-width step's time goes: host-clock time of one prefill
    chunk and one decode step (``chunk()``, ``step()``; synchronised), and
    the profiler's device time per op for the decode step (returns the
    decode step's host ms and device ms): with
    ``kernel``, the paged decode kernels' share (B8 for MLA models, B7
    otherwise; split kernel and merge, whose names both carry the op's);
    for MoE models the expert GEMMs' share (``aten::bmm`` over the
    [E, ...] expert stacks)."""
    from torch.profiler import ProfilerActivity, profile

    def timed(fn, reps=5):
        fn()
        _sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(torch, dev)
        return (time.perf_counter() - t0) / reps * 1e3

    with torch.inference_mode():
        step_ms, chunk_ms = timed(step), timed(chunk)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=cfg.moe is not None) as prof:
            for _ in range(3):
                step()
            _sync(torch, dev)
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _span_us(kernels) / 3e3
    print(f"  decode step {step_ms:.2f} ms, prefill chunk (64 tokens) "
          f"{chunk_ms:.2f} ms (host clock, synchronised); device kernels "
          f"{busy:.2f} ms per decode step (profiler), so the card idles "
          f"{max(0.0, 1 - busy / step_ms) * 100:.1f}% of a decode step")
    # B8's kernels: paged_mla_{mma,simt}_kernel and its merge instance
    # (paged_mla_attention_merge); B7's: paged_attention_split_kernel and
    # its merge instance (paged_attention_merge)
    op, label = ("paged_mla", "B8") if cfg.mla is not None \
        else ("paged_attention", "B7")
    mine = [e for e in kernels if op in e.name]
    if kernel:
        split = sum(e.time_range.elapsed_us() for e in mine
                    if "merge" not in e.name) / 3e3
        merge = sum(e.time_range.elapsed_us() for e in mine
                    if "merge" in e.name) / 3e3
        if dev.type == "cuda" and not (split and merge):
            raise AssertionError(f"the profiled decode step shows no {op} "
                                 f"split kernel ({split} ms) or merge "
                                 f"({merge} ms)")
        span = _span_us(mine) / 3e3
        print(f"  {label}: {span:.4f} ms per decode step on the card (split "
              f"kernel and merge, {sum(_kernel_layers(cfg))} launches of "
              f"each; their intervals {split:.4f} + {merge:.4f} ms, the "
              f"merge's from its early launch), "
              f"{span / max(busy, 1e-9) * 100:.2f}% of its device time")
    elif mine:
        raise AssertionError(f"{len(mine)} {op} kernels in a step that "
                             "should run none")
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
    return step_ms, busy


def phase_serve_soak(torch, ops, cfg, dev):
    """The reference's smoke serve soak (``SERVE_SOAK_*``) through
    ``serve.soak.run_soak`` on ``cfg``: no failure (p99 TTFT back within
    1.5 x the pre-fault baseline + 10 ms within 500 steps of the last
    fault), B7 and its merge once per attention layer per decode step.
    Returns B7's launches."""
    import numpy as np
    from repro_torch.models import transformer as T
    from repro_torch.runtime.chaos import FaultPlan
    from repro_torch.serve import (EngineConfig, Request, ServeEngine,
                                   SoakConfig, parse_arrival_spec, run_soak)
    params = T.init_params(cfg, 0, device=dev)
    ecfg = EngineConfig(**SERVE_SOAK_ENGINE)
    engine = ServeEngine(cfg, params, ecfg)
    steps = SERVE_SOAK_STEPS
    rate = float(SERVE_SOAK_ARRIVAL.split(":", 1)[1].split(",")[0])
    n = int(rate * steps * ecfg.step_s)
    arrivals = parse_arrival_spec(SERVE_SOAK_ARRIVAL, n, seed=0)
    rng = np.random.default_rng(0)
    reqs = [Request(req_id=i,
                    prompt=rng.integers(0, cfg.vocab_size, size=(8,)).tolist(),
                    max_new_tokens=int(rng.integers(4, 13)),
                    arrival_s=arrivals[i]) for i in range(n)]
    plan = FaultPlan.parse(SERVE_SOAK_PLAN)
    scfg = SoakConfig(steps=steps, window=max(10, steps // 40),
                      warmup_steps=max(50, steps // 10), recovery_band=1.5,
                      recovery_slack_s=0.01,
                      recovery_steps=max(200, steps // 4))
    ops.LAUNCHES = ops.MERGE_LAUNCHES = 0
    t0 = time.perf_counter()
    res = run_soak(engine, reqs, plan, scfg)
    _sync(torch, dev)
    secs = time.perf_counter() - t0
    launches, merges = ops.LAUNCHES, ops.MERGE_LAUNCHES
    s = res.summary
    layers = _kernel_layers(cfg)[0]
    worst = max((r["ttft_p99_s"] for r in res.trend
                 if r["first_tokens"] and r["step"] > plan.first_fault_start()),
                default=float("nan"))
    print(f"  serve soak {cfg.name}: {steps} steps in {secs:.1f} s "
          f"({secs / steps * 1e3:.2f} ms a step), {n} requests "
          f"({SERVE_SOAK_ARRIVAL}), faults {plan.spec()!r}: failures "
          f"{res.failures}, baseline p99 TTFT "
          f"{res.baseline_p99_s * 1e3:.1f} ms, worst window p99 "
          f"{worst * 1e3:.1f} ms, fault end step {res.fault_end_step}, "
          f"recovered at step {res.recovered_step} "
          f"({res.recovery_steps_taken} steps), {s['completed']:.0f} "
          f"completed, queue peak {s['queue_peak']:.0f}, preemptions "
          f"{s['preemptions']:.0f}, {s['decode_steps']:.0f} decode steps, "
          f"{launches} paged_attention launches and {merges} merges")
    want = layers * int(s["decode_steps"])
    if res.failures or launches != want or merges != want:
        raise AssertionError(f"serve soak: failures {res.failures}, "
                             f"launches {launches}/{merges}, want {want}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: BSP training of gemma2-2b (8 layers) at world 4
# ---------------------------------------------------------------------------


def train_config(cut=None):
    import dataclasses
    from repro_torch.models.registry import get_config
    return dataclasses.replace(get_config("gemma2-2b"), **(cut or TRAIN_CUT))


def train_args(codec):
    return _train_parse(["--bucket-codec", codec])


def _train_parse(extra):
    from repro_torch.launch import train as train_cli
    return train_cli.parse_args(TRAIN_ARGS + extra)


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


def phase_train(torch, tops, cfg, first_losses=None, ef_launches=None):
    """The main path: ``launch.train.run`` with each codec; the counts are
    set to 0 just before each run and read just after.  Returns each
    codec's launch count; ``first_losses`` (a dict), when given, gets each
    run's step-0 loss, and ``ef_launches`` (a dict) each run's launches of
    EF's kernel (steps x buckets on the card, all on the vector path)."""
    import numpy as np
    from repro_torch.kernels.codec import ops as cops
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
        cops.EF_LAUNCHES.update(int8=0, bf16=0)
        cops.EF_LAUNCHES_BY_PATH.update(vector=0, scalar=0)
        out = train_cli.run(cfg, args)
        ef = cops.EF_LAUNCHES[codec]
        ef_by_path = dict(cops.EF_LAUNCHES_BY_PATH)
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
        # EF: one kernel launch a bucket a step on the card, each on the
        # vector path, none on the CPU
        want_ef = args.steps * n_b if dev.type == "cuda" else 0
        if (ef != want_ef or sum(cops.EF_LAUNCHES.values()) != ef
                or ef_by_path != dict(vector=want_ef, scalar=0)):
            raise AssertionError(f"{codec}: EF launches {cops.EF_LAUNCHES} "
                                 f"by path {ef_by_path}, want {want_ef} of "
                                 f"{codec}, all vector")
        tokens = args.batch * args.seq
        for h in hist:
            print(f"  {codec} step {h['step']}: loss {h['loss']:.4f}, "
                  f"{h['sec']:.3f} s, {tokens / h['sec']:.0f} tokens/s")
        print(f"  {codec}: {counts[codec]} decode_add_{codec} launches = "
              f"{args.steps} steps x {n_b} buckets x {hops} hops; {ef} EF "
              f"launches; peak memory {peak / 2**30:.2f} GiB "
              f"({peak / 1e9:.1f} GB)")
        launches[codec] = counts[codec]
        if first_losses is not None:
            first_losses[codec] = losses[0]
        if ef_launches is not None:
            ef_launches[codec] = ef
        del out
    return launches


def _profiled_steps(torch, step, state, data, dev, label):
    """Three steps of ``step`` from data steps 0-2: one to warm, one timed
    on the host clock, one under ``torch.profiler``.  Prints the host time
    against the device's kernel time (the idle share); returns ``(state,
    metrics, wall s, busy s, prof)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    print(f"  {label} step: {wall:.3f} s on the host clock ({wall_prof:.3f} "
          f"s under the profiler); device kernels {busy:.3f} s (profiler), "
          f"so the card idles {max(0.0, 1 - busy / wall) * 100:.1f}% of the "
          f"step; loss {m['loss'].item():.4f}")
    return state, m, wall, busy, prof


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
    from repro_torch.core.bsp import BSPConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import make_bsp_train_step
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
    state, _, _, busy, prof = _profiled_steps(torch, step, state, data,
                                              dev, "int8")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    b2 = [e.time_range.elapsed_us() for e in kernels
          if "decode_add_int8" in e.name]
    share = sum(b2) / 1e4 / max(busy, 1e-9)
    print(f"  B2 in that step: {len(b2)} launches, {sum(b2) / 1e3:.3f} ms "
          f"of device time ({share:.2f}% of the step's kernels)")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12, max_name_column_width=40))
    state.flat_mu = state.flat_nu = state.ef_residual = None
    del prof
    engine = init_state.engine
    bkt = max(engine.buckets, key=lambda b: b.length)
    real_bucket_check(torch, cfg, tref, codecs, engine, state.params,
                      data.batch(3), dev,
                      [(bkt, "bf16"), (bkt, "int8")])


def real_bucket_check(torch, cfg, tref, codecs, engine, params, batch, dev,
                      pairs):
    """Each rank's gradients of ``batch`` (its quarter of the rows) packed
    into the buckets of ``pairs`` (``(bucket, codec name)``), each bucket
    reduce-scattered by ``fractal_reduce_scatter`` with that codec through
    the kernels and through the plain versions: equal bit for bit."""
    from repro_torch.core import collectives as C
    from repro_torch.models import transformer as T
    from repro_torch.weights import reference_leaves
    leaves = reference_leaves(params, cfg)
    flat = [t.requires_grad_(True) for leaf in leaves for t in leaf.parts]
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    world = engine.world
    buckets = {b.index: b for b, _ in pairs}
    rows = {i: torch.zeros(world, b.length, device=dev)
            for i, b in buckets.items()}
    per = batch["tokens"].shape[0] // world
    for r in range(world):
        mb = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
        loss, _ = T.loss_fn(params, cfg, mb)
        it = iter(torch.autograd.grad(loss, flat))
        grads = [[next(it) for _ in leaf.parts] for leaf in leaves]
        for i, b in buckets.items():
            engine.pack_bucket(b, grads, out=rows[i][r])
        del grads, it, loss
    with torch.no_grad():
        for b, name in pairs:
            got = C.fractal_reduce_scatter(rows[b.index], codecs[name])
            kernel_op = C.decode_add
            C.decode_add = _plain_decode_add(tref)
            try:
                want = C.fractal_reduce_scatter(rows[b.index], codecs[name])
            finally:
                C.decode_add = kernel_op
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            same = _same_bits(torch, got, want)
            print(f"  real bucket b{b.index} ({world} x {b.length} f32 "
                  f"gradients): fractal_reduce_scatter with {name} through "
                  f"the kernels is "
                  f"{'bit-identical' if same else 'DIFFERENT'} to the plain"
                  f" versions")
            if not same:
                raise AssertionError(f"real-bucket reduce-scatter ({name}, "
                                     f"b{b.index}) differs between kernel "
                                     "and plain")
            del got, want


# ---------------------------------------------------------------------------
# slice 8: Table 1, every schedule, the auto superstep, forced schedules
# ---------------------------------------------------------------------------


def phase_table1():
    """The paper's Table 1 from the port's event simulator, on the host:
    every mesh's cycles must equal ``TABLE1_PINNED`` and the FractalSync
    ratios must print 1.00.  Returns the host seconds the phase took."""
    from repro_torch.core.simulator import simulate_config
    from repro_torch.launch.table1 import rows
    t0 = time.perf_counter()
    results = {name: simulate_config(name) for name in TABLE1_PINNED}
    secs = time.perf_counter() - t0
    lines = list(rows(results))
    for line in lines:
        print(f"  {line}")
    bad = [(name, pins, tuple(results[name][k] for k in
                              ("fsync", "fsync_p", "naive", "xy")))
           for name, pins in TABLE1_PINNED.items()
           if tuple(results[name][k] for k in
                    ("fsync", "fsync_p", "naive", "xy")) != pins]
    if bad:
        raise AssertionError(f"Table 1 cycles (mesh, pinned, simulated): "
                             f"{bad}")
    fs = [ln for ln in lines if "/fsync," in ln or "/fsync_p," in ln]
    if len(fs) != 2 * len(TABLE1_PINNED) or \
            not all(ln.endswith("ratio=1.00") for ln in fs):
        raise AssertionError(f"fsync ratios: {fs}")
    print(f"  Table 1 equals the pinned cycles ({len(results)} meshes); "
          f"simulated in {secs:.2f} s of host time")
    return secs


def _schedule_payload(torch, W, M, dev, seed, exact):
    g = torch.Generator().manual_seed(seed)
    if exact:
        x = torch.randint(-7, 8, (W, M), generator=g).float()
    else:
        x = torch.randn(W, M, generator=g) * torch.randn(
            W, M, generator=g).exp()
    return x.to(dev)


def _schedule_m(W, M):
    """The largest multiple of W x 128 at most ``M`` (every IR program
    cuts a row into at most W chunks, the scatter into W shards)."""
    return M // (W * 128) * (W * 128)


def phase_schedules(torch, dev):
    """``all_reduce`` and ``reduce_scatter`` of every schedule at every
    shape of ``SCHEDULE_SHAPES``: (a) on 256 MB a rank of small integers,
    ``==`` the sum over the rank axis (sliced at ``bit_reversed_index``
    for the scatter); (b) on random f32, bit for bit the same lowering run
    on the CPU (every schedule but ``xla``, whose ``torch.sum`` adds in the
    library's own order on each device).  On the card each lowering also runs once under
    ``set_sync_debug_mode("error")``, and at world 4 each schedule's
    all-reduce is timed (device ms, CUDA graph).  Returns the timings."""
    from repro_torch.core import collectives as C
    from repro_torch.core import schedule_ir as IR
    cpu = torch.device("cpu")
    on_card = dev.type == "cuda"
    checked = 0
    for shape, names in SCHEDULE_SHAPES:
        W = math.prod(shape)
        pow2 = W & (W - 1) == 0
        for exact, M in ((True, _schedule_m(W, SCHEDULE_M)),
                         (False, _schedule_m(W, SCHEDULE_SMALL_M))):
            x = _schedule_payload(torch, W, M, dev, W, exact)
            want = x.sum(0) if exact else None
            xc = None if exact else x.to(cpu)
            rev = C.bit_reversed_index(W, dev) if pow2 else None
            for name in names:
                if not exact and name == "xla":
                    continue      # torch.sum's order is the library's
                outs = {"all_reduce": lambda: C.all_reduce(x, name, shape)}
                if pow2:
                    outs["reduce_scatter"] = lambda: C.reduce_scatter(
                        x, name, shape=shape)
                for op, fn in outs.items():
                    got = fn()
                    if exact:
                        ok = torch.equal(got, want.expand_as(x)) \
                            if op == "all_reduce" else \
                            torch.equal(got, want.view(W, -1)[rev])
                    else:
                        ref = C.all_reduce(xc, name, shape) \
                            if op == "all_reduce" else \
                            C.reduce_scatter(xc, name, shape=shape)
                        ok = _same_bits(torch, got.to(cpu), ref)
                    if not ok:
                        what = "the sum over ranks" if exact else \
                            "the CPU lowering"
                        raise AssertionError(
                            f"{op} {name} at {shape}, M {M}: differs from "
                            f"{what}")
                    checked += 1
                    del got
            del x, want, xc
    print(f"  {checked} checks: every schedule's all_reduce (and, at "
          f"power-of-two worlds, reduce_scatter) == the sum over ranks on "
          f"{SCHEDULE_M} small-integer f32 a rank, and (xla, a library sum, "
          f"aside) bit for bit the CPU lowering on {SCHEDULE_SMALL_M} random "
          f"f32 a rank")
    if not on_card:
        return {}
    timings = {}
    shape = SCHEDULE_TIMED_SHAPE
    W = math.prod(shape)
    M = _schedule_m(W, SCHEDULE_M)
    x = _schedule_payload(torch, W, M, dev, 0, True)
    for name in SCHEDULE_SHAPES[0][1]:
        if name != "xla":
            _sync_free(torch, lambda: C.all_reduce(x, name, shape),
                       f"the {name} all-reduce", "one call")
    smi = _smi()
    print(f"  all-reduce at world {W}, {M * 4 / 1e6:.0f} MB a rank, device "
          f"time (CUDA graph) on {smi}.  These time row permutations of one "
          f"[{W}, {M}] tensor in the card's memory, NOT a network:")
    for name in SCHEDULE_SHAPES[0][1]:
        ms = _time_ms(torch, lambda i: C.all_reduce(x, name, shape), 1,
                      3)["graph"]
        if name == "xla":
            what = "a plain sum over the rank axis (no IR program)"
        else:
            st = IR.validate(IR.build_program(name, shape))
            what = (f"{st['steps']:.0f} steps, {st['messages']:.0f} "
                    f"messages, at most {st['max_frac_sent'] * M * 4 / 1e6:.1f}"
                    f" MB sent by one rank")
        timings[name] = ms
        print(f"    {name:12s} {ms:9.3f} ms  ({what}; {smi})")
    del x
    return timings


def _counted_run(torch, tops, cfg, args, label, steps=None):
    """``launch.train.run(cfg, args)`` with the decode-add counts set to 0
    just before and read just after; it must take ``steps`` steps (default
    ``args.steps``; fewer when it resumes) with finite losses.  Prints the
    plan.  Returns ``(out, counts, want, peak)``: ``want`` is each codec's
    steps x (buckets with the codec) x log2(world)."""
    import numpy as np
    from repro_torch.launch import train as train_cli
    steps = args.steps if steps is None else steps
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tops.BF16_LAUNCHES = tops.INT8_LAUNCHES = 0
    out = train_cli.run(cfg, args)
    counts = {"bf16": tops.BF16_LAUNCHES, "int8": tops.INT8_LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    eng = out["engine"]
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses {losses}")
    hops = args.devices.bit_length() - 1
    want = {c: steps * eng.codec_names.count(c) * hops
            for c in ("bf16", "int8")}
    print(f"  plan: {eng.n_buckets} buckets, "
          f"{[b.length for b in eng.buckets]} f32 elements; "
          + ", ".join(f"b{b.index} {s}+{c}" for b, s, c in
                      zip(eng.buckets, eng.schedules, eng.codec_names)))
    return out, counts, want, peak


def phase_train_auto(torch, tops, tref, codecs, cfg, first_loss,
                     argv=None):
    """The slice's main path: ``launch.train.run`` with ``TRAIN_AUTO``
    (schedule, codec and bucket boundaries all left to the autotuner), its
    counts set to 0 just before and read just after.  Each codec's count
    must equal steps x (buckets with that codec) x log2(world), the losses
    must be finite and step 0's must equal ``first_loss`` (phase 5's, the
    same params and batch before any sync; not checked when None).  Then
    three more steps of the same configuration for the idle share, and
    every bucket of the plan that carries a codec held to the plain
    versions on real gradients (``real_bucket_check``), so each hop length
    the auto path gives B1/B2 is checked.  ``argv`` is the whole command
    line (default: ``TRAIN_ARGS`` + ``TRAIN_AUTO``; phase 5d gives
    ``QWEN_TRAIN_ARGS``).  Returns the launch counts."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import make_bsp_train_step
    args = train_cli.parse_args(argv) if argv else _train_parse(TRAIN_AUTO)
    dev = torch.device(args.device)
    print(f"  {cfg.name} at published widths, cut to {cfg.num_layers} "
          f"layers; world {args.devices}; batch {args.batch} x {args.seq}; "
          f"{' '.join(TRAIN_AUTO)}")
    out, counts, want, peak = _counted_run(torch, tops, cfg, args, "auto")
    eng = out["engine"]
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if first_loss is not None and losses[0] != first_loss:
        raise AssertionError(f"auto: step-0 loss {losses[0]!r}, the fixed "
                             f"run's {first_loss!r}")
    hops = args.devices.bit_length() - 1
    if counts != want or not any(want.values()):
        raise AssertionError(
            f"auto: launches {counts}, want {want} (= {args.steps} steps x "
            f"buckets with the codec x log2({args.devices}))")
    tokens = args.batch * args.seq
    for h in hist:
        print(f"  auto step {h['step']}: loss {h['loss']:.4f}, "
              f"{h['sec']:.3f} s, {tokens / h['sec']:.0f} tokens/s")
    same = "" if first_loss is None else " == the fixed run's"
    print(f"  auto: launches {counts} = {args.steps} steps x buckets with "
          f"each codec x {hops} hops; step-0 loss {losses[0]!r}{same}; "
          f"peak memory {peak / 2**30:.2f} GiB ({peak / 1e9:.1f} GB)")
    del out
    step, init_state = make_bsp_train_step(
        cfg, AdamWConfig(lr=args.lr, total_steps=args.steps,
                         warmup_steps=1), train_cli.bsp_config(args),
        args.devices, device=dev)
    if init_state.engine.describe() != eng.describe():
        raise AssertionError(f"auto: plan {init_state.engine.describe()}, "
                             f"the run's {eng.describe()}")
    state = init_state(T.init_params(cfg, args.seed, device=dev))
    data = SyntheticLM(cfg, DataConfig(global_batch=args.batch,
                                       seq_len=args.seq, seed=args.seed))
    if dev.type == "cuda":
        state = _profiled_steps(torch, step, state, data, dev, "auto")[0]
    state.flat_mu = state.flat_nu = state.ef_residual = None
    real_bucket_check(torch, cfg, tref, codecs, eng, state.params,
                      data.batch(3), dev,
                      [(b, c) for b, c in zip(eng.buckets, eng.codec_names)
                       if c != "none"])
    return counts


def phase_train_forced(torch, tops, cfg):
    """``launch.train.run`` once for each of ``TRAIN_FORCED`` with
    ``--bucket-codec int8``, one step: the codec is normalised away on a
    non-fractal schedule, so no decode-add kernel launches, and the loss
    is finite.  Returns the schedules' counts."""
    import numpy as np
    from repro_torch.launch import train as train_cli
    seen = {}
    for name in TRAIN_FORCED:
        args = _train_parse(["--steps", "1", "--schedule", name,
                             "--bucket-codec", "int8"])
        tops.BF16_LAUNCHES = tops.INT8_LAUNCHES = 0
        out = train_cli.run(cfg, args)
        counts = {"bf16": tops.BF16_LAUNCHES, "int8": tops.INT8_LAUNCHES}
        eng = out["engine"]
        loss = out["history"][0]["loss"]
        if set(eng.schedules) != {name} or set(eng.codec_names) != {"none"}:
            raise AssertionError(f"{name}: plan {eng.describe()}")
        if any(counts.values()) or not np.isfinite(loss):
            raise AssertionError(f"{name}: launches {counts}, loss {loss}")
        print(f"  --schedule {name} --bucket-codec int8 ({cfg.num_layers} "
              f"layers, {eng.n_buckets} buckets, codec normalised to none): "
              f"loss {loss:.4f} in {out['history'][0]['sec']:.3f} s, "
              f"decode-add launches {counts}")
        seen[name] = counts
        del out
    return seen


# ---------------------------------------------------------------------------
# slice 9: qwen2.5-3b served and trained, the fault-injected train soak
# ---------------------------------------------------------------------------


def qwen_config(cut=None):
    """qwen2.5-3b at its published widths, cut in depth to ``cut``."""
    import dataclasses
    from repro_torch.models.registry import get_config
    return dataclasses.replace(get_config("qwen2.5-3b"), **(cut or {}))


def _soak_dir(need: int, prefix="soak-"):
    """A new directory for a phase's checkpoints on whichever of the
    temporary directory and the checkout's ``build/`` has more room; it
    must have ``need`` bytes free."""
    import shutil
    import tempfile
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    free = {Path(tempfile.gettempdir()): 0, build: 0}
    for d in free:
        free[d] = shutil.disk_usage(d).free
    where = max(free, key=free.get)
    print("  checkpoint room: " + ", ".join(
        f"{d} {f / 1e9:.1f} GB free" for d, f in free.items())
        + f"; {need / 1e9:.1f} GB needed (keep 3 + one being written)")
    if free[where] < need:
        raise AssertionError(f"no room for the checkpoints: "
                             f"{free[where] / 1e9:.1f} GB free, "
                             f"{need / 1e9:.1f} GB needed")
    return tempfile.mkdtemp(prefix=prefix, dir=where)


def _differing_bits(torch, a, b):
    """(elements, bits) in which two same-dtype tensors differ."""
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    x = a.view(ints) ^ b.view(ints)
    elems = int((x != 0).sum())
    bits = sum(int(((x >> k) & 1).sum()) for k in range(8 * a.element_size())
               ) if elems else 0
    return elems, bits


def shares_bit_check(torch, cfg, scfg, dev):
    """One step each of ``SOAK_SHARES`` (even, then uneven) at world 8 from
    the same params and micro-batches: prints whether the params after the
    step (and the losses) are the same bit for bit, and how many elements
    and bits differ if not.  Returns the differing elements."""
    from repro_torch.core.bsp import BSPConfig
    from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                           reshard_for_shares)
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import make_bsp_train_step
    from repro_torch.weights import reference_leaves
    world = math.prod(scfg.tree_shape)
    params = T.init_params(cfg, 0, device=dev)
    raw = SyntheticLM(cfg, DataConfig(
        global_batch=scfg.microbatches * scfg.micro_rows,
        seq_len=scfg.seq_len, seed=scfg.seed)).batch(0)
    acfg = AdamWConfig(lr=scfg.lr, warmup_steps=1,
                       total_steps=scfg.total_steps, grad_clip=0.0)
    outs = []
    for shares in SOAK_SHARES:
        step, init_state = make_bsp_train_step(
            cfg, acfg, BSPConfig(schedule="fractal"), world, device=dev,
            shares=shares)
        state = init_state(_clone_tree(params))
        t0 = time.perf_counter()
        state, m = step(state, reshard_for_shares(raw, shares))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sec = time.perf_counter() - t0
        flat = torch.cat([t.detach().reshape(-1)
                          for leaf in reference_leaves(state.params, cfg)
                          for t in leaf.parts])
        outs.append((flat, m["loss"].item()))
        print(f"  shares {shares}: loss {m['loss'].item()!r}, one step "
              f"{sec:.3f} s")
        del state, step, init_state
    (a, la), (b, lb) = outs
    elems, bits = _differing_bits(torch, a, b)
    verdict = "BIT-IDENTICAL" if not elems and la == lb else \
        f"DIFFER in {elems} of {a.numel()} params ({bits} bits)"
    print(f"  uneven shares vs even shares at width ({a.numel()} params, "
          f"{a.dtype}): {verdict}; losses {la!r} / {lb!r}")
    return elems


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.detach().clone()


def exact_resume_check(torch, cfg, dev, where, seq):
    """Exact resume on this device: the BSP step at world 4 (fractal, no
    codec, 4 rows of ``seq`` tokens a step) for 4 steps straight, against
    2 steps, a checkpoint, a restore into a fresh state and 2 more steps.
    Prints whether the params (and losses) are the same bit for bit; on
    the card that needs the same GEMM algorithms before and after the
    restore.  Returns the differing elements."""
    from repro_torch.core.bsp import BSPConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.loop import LoopConfig, TrainLoop, resume_or_init
    from repro_torch.runtime.trainer import make_bsp_train_step
    step, init_state = make_bsp_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        BSPConfig(schedule="fractal"), 4, device=dev)
    data = SyntheticLM(cfg, DataConfig(global_batch=4, seq_len=seq, seed=1))
    meta = {"superstep_layout": init_state.superstep_layout}

    def run(state, start, stop, ckpt=None):
        loop = TrainLoop(step_fn=step, state=state, data=data,
                         cfg=LoopConfig(total_steps=stop, log_every=0,
                                        checkpoint_every=2,
                                        checkpoint_dir=ckpt),
                         start_step=start, ckpt_meta=meta)
        loop.run()
        return loop

    first = run(init_state(T.init_params(cfg, 1, device=dev)), 0, 2, where)
    straight = run(first.state, 2, 4)
    # every leaf but the step, widened to f32 (exactly)
    flat_a = torch.cat([t.reshape(-1).float() for t in
                        straight.state.checkpoint_leaves()[:-1]])
    losses_a = [h["loss"] for h in first.history + straight.history]
    del first, straight
    t0 = time.perf_counter()
    state, start = resume_or_init(
        where, init_state(T.init_params(cfg, 2, device=dev)),
        expect_meta=meta)
    restore_s = time.perf_counter() - t0
    resumed = run(state, start, 4)
    flat_b = torch.cat([t.reshape(-1).float() for t in
                        resumed.state.checkpoint_leaves()[:-1]])
    losses_b = [h["loss"] for h in resumed.history]
    del resumed, state
    elems, bits = _differing_bits(torch, flat_a, flat_b)
    same = not elems and losses_a[2:] == losses_b
    print(f"  exact resume ({cfg.name}, world 4, 4 x {seq} tokens a step): "
          f"4 steps straight against 2, a checkpoint, a restore "
          f"({restore_s:.2f} s) and 2 more: params and moments "
          + ("BIT-IDENTICAL" if same else
             f"DIFFER in {elems} elements ({bits} bits)")
          + f"; losses {losses_a[2:]} / {losses_b}")
    return elems


def phase_train_soak(torch, cfg, dev, scfg=None):
    """The reference's fault-injected train soak through
    ``runtime.soak.run_train_soak`` and ``check_train_soak`` on ``cfg``
    (qwen2.5-3b cut to ``SOAK_CUT``), with ``TrainSoakConfig``'s defaults
    but ``seq_len`` ``SOAK_SEQ``: a slow rank actuates uneven shares, a
    killed rank re-meshes 8 -> 4 onto a level-2 fsync domain, the
    parameters come back from a checkpoint and the run replays.  Prints
    the timeline, every save's and the restore's bytes and seconds and the
    peak memory; raises on any failure ``check_train_soak`` reports.
    Returns the result."""
    import dataclasses
    import shutil
    from repro_torch.models.registry import count_params
    from repro_torch.runtime.soak import (TrainSoakConfig, check_train_soak,
                                          run_train_soak)
    scfg = scfg or dataclasses.replace(
        TrainSoakConfig(), arch=cfg.name, seq_len=SOAK_SEQ)
    base = TrainSoakConfig()
    n = count_params(cfg)
    print(f"  {cfg.name}: {n:,} params at published widths; cuts: "
          f"{qwen_config().num_layers} -> {cfg.num_layers} layers (chip "
          f"time, checkpoint size); seq_len {base.seq_len} -> "
          f"{scfg.seq_len} (the other train phases' length); tree "
          f"{scfg.tree_shape}, {scfg.microbatches} micro-batches of "
          f"{scfg.micro_rows} row, faults {scfg.fault_spec!r}, a "
          f"checkpoint every {scfg.checkpoint_every} steps, "
          f"{scfg.total_steps} steps")
    shares_bit_check(torch, cfg, scfg, dev)
    ckpt_bytes = 10 * n      # bf16 params + two f32 moment vectors
    where = Path(_soak_dir(4 * ckpt_bytes))
    try:
        exact_resume_check(torch, cfg, dev, str(where / "resume"),
                           scfg.seq_len)
        shutil.rmtree(where / "resume", ignore_errors=True)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = check_train_soak(run_train_soak(scfg, str(where / "soak"),
                                              device=dev, cfg=cfg), scfg)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(where, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec = res.recovery or {}
    tokens = scfg.microbatches * scfg.micro_rows * scfg.seq_len
    restarted = False
    for i, h in enumerate(res.history):
        if i and h["step"] <= res.history[i - 1]["step"]:
            restarted = True
        world = rec.get("new_world") if restarted else \
            math.prod(scfg.tree_shape)
        print(f"  soak step {h['step']:2d} (world {world}): loss "
              f"{h['loss']:.6f}, {h['sec']:.3f} s, "
              f"{tokens / h['sec']:.0f} tokens/s")
    for ev in res.rebalance[:1] + res.rebalance[-1:]:
        print(f"  rebalance at step {ev['step']}: stragglers "
              f"{ev['stragglers']} -> shares {ev['shares']}")
    print(f"  actuated shares {res.actuated_shares}; recovery {rec}")
    for s in res.saves:
        print(f"  save at step {s['step']}: {s['bytes']:,} bytes, host copy "
              f"{s['copy_s']:.3f} s, encode + write + fsync "
              f"{s['write_s']:.3f} s ({s['bytes'] / s['write_s'] / 1e9:.2f} "
              "GB/s)")
    if res.restore:
        r = res.restore
        print(f"  restore of step {r['step']}: {r['bytes']:,} bytes in "
              f"{r['seconds']:.3f} s (read, checksum, decode, to the "
              "device)")
    if res.replay_pairs:
        a, b = res.replay_pairs[0]
        print(f"  first replayed loss {b!r} against the recorded {a!r}: "
              + ("bit for bit" if a == b else f"differs by {abs(a - b):.3e}")
              + f"; replay pairs {res.replay_pairs}")
    print(f"  soak: {len(res.history)} steps in {wall:.1f} s, peak memory "
          f"{peak / 2**30:.2f} GiB ({peak / 1e9:.1f} GB); check_train_soak: "
          + ("no failure" if res.ok else f"FAILURES {res.failures}"))
    if not res.ok:
        raise AssertionError(f"train soak failed: {res.failures}")
    if rec.get("old_world") != 8 or rec.get("new_world") != 4 or \
            rec.get("level") != 2:
        raise AssertionError(f"re-mesh {rec}: want 8 -> 4 ranks on a "
                             "level-2 domain")
    return res


# ---------------------------------------------------------------------------
# slice 11: training the MTP, MoE and recurrent models
# ---------------------------------------------------------------------------


def cut_config(name, cut):
    """``name`` at its published widths, cut in depth to ``cut``."""
    import dataclasses
    from repro_torch.models.registry import get_config
    return dataclasses.replace(get_config(name), **cut)


class _Utilization:
    """NVML's ``utilization.gpu`` (the share of each sample period in which
    a kernel ran on the card) read by ``nvidia-smi -lms`` every
    ``period_ms``, each reading stamped on the host clock as it arrives.
    A step of the eager scan launches millions of kernels, too many for
    ``torch.profiler``; this reads the idle share without tracing them."""

    def __init__(self, period_ms=100):
        self.period_ms = period_ms
        self.samples = []

    def __enter__(self):
        import threading
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-i", "0",
             "-lms", str(self.period_ms)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

        def read():
            for line in self.proc.stdout:
                try:
                    self.samples.append((time.perf_counter(),
                                         float(line.strip())))
                except ValueError:
                    pass

        self.thread = threading.Thread(target=read, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.thread.join(timeout=10)

    def busy(self, t0, t1):
        """(mean utilization in [t0, t1] as a fraction, readings)."""
        vals = [v for t, v in self.samples if t0 <= t <= t1]
        return (sum(vals) / len(vals) / 100 if vals else None), len(vals)


def phase_train_xlstm(torch, tops, tref, codecs, cfg, argv=None):
    """[5f] the slice's main path: ``launch.train.run`` on ``cfg``
    (xlstm-1.3b cut to ``XLSTM_TRAIN_CUT``) with ``argv`` (default
    ``XLSTM_TRAIN_ARGS``: world 4, all auto), its counts set to 0 just
    before and read just after.  Losses finite; each codec's count equal
    to steps x (buckets with that codec) x log2(world); if the plan puts
    no bucket on int8, one more step with ``--bucket-codec int8`` so that
    B2 runs on this path.  Prints the plan, step time, tokens/s, peak
    memory and the last step's idle share (NVML utilization, read during
    the run); then every codec'd bucket's real gradients (of
    ``XLSTM_CHECK_SEQ``-token rows) through B2 and through its plain
    version, bit for bit.  Returns the launch counts."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_cli
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import count_params
    argv = list(argv or XLSTM_TRAIN_ARGS)
    args = train_cli.parse_args(argv)
    dev = torch.device(args.device)
    n = count_params(cfg)
    chunks = args.seq // S.TIME_CHUNK if args.seq > S.TIME_CHUNK and \
        args.seq % S.TIME_CHUNK == 0 else 1
    card = f"({_smi()}) " if dev.type == "cuda" else ""
    print(f"  {card}{cfg.name} at published widths, cut to "
          f"{cfg.num_layers} layers ({n:,} params, {42 * n / 1e9:.1f} GB at "
          f"42 B a parameter); world {args.devices}; batch {args.batch} x "
          f"{args.seq} ({chunks} time chunk(s) a scan, remat "
          f"{T._REMAT!r}); {' '.join(TRAIN_AUTO)}")
    util = _Utilization() if dev.type == "cuda" else None
    if util:
        with util:
            out, counts, want, peak = _counted_run(torch, tops, cfg, args,
                                                   "xlstm train")
            t_end = time.perf_counter()
    else:
        out, counts, want, peak = _counted_run(torch, tops, cfg, args,
                                               "xlstm train")
    eng, hist = out["engine"], out["history"]
    hops = args.devices.bit_length() - 1
    if counts != want:
        raise AssertionError(
            f"xlstm train: launches {counts}, want {want} (= {args.steps} "
            f"steps x buckets with the codec x log2({args.devices}))")
    tokens = args.batch * args.seq
    for h in hist:
        print(f"  xlstm step {h['step']}: loss {h['loss']:.4f} (xent "
              f"{h['xent']:.4f}, aux {h['aux']:.1f}), {h['sec']:.3f} s, "
              f"{tokens / h['sec']:.1f} tokens/s")
    idle = ""
    if util:
        busy, k = util.busy(t_end - hist[-1]["sec"], t_end)
        idle = ("; last step's idle share not measured (no NVML reading)"
                if busy is None else
                f"; the card idles {(1 - busy) * 100:.1f}% of the last step "
                f"(NVML utilization.gpu, {k} readings every "
                f"{util.period_ms} ms)")
    print(f"  xlstm: launches {counts} = {args.steps} steps x buckets with "
          f"each codec x {hops} hops; peak memory {peak / 2**30:.2f} GiB "
          f"({peak / 1e9:.1f} GB){idle}")
    del out
    if not want["int8"]:
        fixed = train_cli.parse_args(argv + ["--steps", "1", "--bucket-codec",
                                             "int8"])
        tops.BF16_LAUNCHES = tops.INT8_LAUNCHES = 0
        eng1 = train_cli.run(cfg, fixed)["engine"]
        n1 = eng1.codec_names.count("int8") * hops
        print(f"  fixed --bucket-codec int8 step: {tops.INT8_LAUNCHES} "
              f"decode_add_int8 launches (want {n1})")
        if tops.INT8_LAUNCHES != n1 or n1 == 0:
            raise AssertionError(f"xlstm int8 step: {tops.INT8_LAUNCHES} "
                                 f"launches, want {n1}")
        counts["int8"] += tops.INT8_LAUNCHES
        eng = eng1
    data = SyntheticLM(cfg, DataConfig(global_batch=args.batch,
                                       seq_len=min(args.seq, XLSTM_CHECK_SEQ),
                                       seed=args.seed))
    print(f"  real buckets: gradients of {args.batch} x "
          f"{data.dcfg.seq_len} tokens")
    real_bucket_check(torch, cfg, tref, codecs, eng,
                      T.init_params(cfg, args.seed, device=dev),
                      data.batch(args.steps), dev,
                      [(b, c) for b, c in zip(eng.buckets, eng.codec_names)
                       if c != "none"])
    return counts


def _chunked_dots(torch, a, b, chunk=1 << 26):
    """(a.b, a.a, b.b, (a-b).(a-b)) of two flat tensors in f64, a chunk at
    a time (an expert leaf holds 940 M elements)."""
    a, b = a.reshape(-1), b.reshape(-1)
    acc = torch.zeros(4, dtype=torch.float64, device=a.device)
    for i in range(0, a.numel(), chunk):
        x = a[i:i + chunk].double()
        y = b[i:i + chunk].double()
        acc += torch.stack([(x * y).sum(), (x * x).sum(), (y * y).sum(),
                            ((x - y) ** 2).sum()])
    return acc.tolist()


def _grad_pass(torch, cfg, params, batch):
    """One ``loss_fn`` + ``autograd.grad`` of ``cfg`` on ``params``.
    Returns (loss, metrics, [(name, grad)], empty): ``empty`` counts the
    experts no token picked in the forward that made the loss (the first
    router call of each MoE layer), each of whose expert weights must
    have an all-zero gradient (checked here)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.weights import reference_leaves
    leaves = reference_leaves(params, cfg)
    flat = [t.requires_grad_(True) for leaf in leaves for t in leaf.parts]
    picks = []
    real = L._router_gates

    def recording(p, mo, x2d):
        out = real(p, mo, x2d)
        picks.append(torch.bincount(out[1].reshape(-1),
                                    minlength=mo.num_experts))
        return out

    L._router_gates = recording
    try:
        loss, metrics = T.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, flat)
    finally:
        L._router_gates = real
    by_id = {id(t): g for t, g in zip(flat, grads)}
    moe = [i for i, k in enumerate(cfg.layer_pattern) if k in T.MOE_KINDS]
    empty = 0
    for li, count in zip(moe, picks):
        ffn = params["layers"][li]["ffn"]
        for e in torch.nonzero(count == 0).reshape(-1).tolist():
            empty += 1
            for w in ("w_gate", "w_up", "w_down"):
                if by_id[id(ffn[w])][e].any():
                    raise AssertionError(f"layer {li} expert {e}: no token, "
                                         f"but a nonzero {w} gradient")
    names = []
    for leaf in leaves:
        names += [leaf.path if len(leaf.parts) == 1 else f"{leaf.path}[{r}]"
                  for r in range(len(leaf.parts))]
    out = (loss.item(), {k: v.item() for k, v in metrics.items()},
           list(zip(names, [g.detach() for g in grads])), empty)
    for t in flat:
        t.requires_grad_(False)
    return out


def check_loss_terms(cfg, loss, m, label):
    """loss == xent + mtp_loss_weight * mtp / mtp_depth + 0.01 * aux, to
    f32 rounding (five roundings at most, each half an ulp of a partial
    sum no larger than the terms' sum; four times that)."""
    terms = [m["xent"]]
    if cfg.mtp_depth:
        terms.append(cfg.mtp_loss_weight * m["mtp"] / cfg.mtp_depth)
    if cfg.moe:
        terms.append(0.01 * m["aux"])
    want = sum(terms)
    tol = 4 * 5 * 2.0 ** -24 * sum(abs(t) for t in terms)
    if not all(math.isfinite(v) for v in m.values()) or \
            abs(loss - want) > tol:
        raise AssertionError(f"{label}: loss {loss!r} != the sum of its "
                             f"terms {want!r} (tol {tol:.2e}; {m})")
    return abs(loss - want)


def compare_grads(torch, lo, hi, bounds, label):
    """Hold the low-precision pass ``lo`` to the f32 pass ``hi`` (each a
    ``_grad_pass`` result): loss and every metric within
    ``bounds["loss"]``, and per gradient leaf the cosine similarity at
    least ``bounds["cos"]`` and the norm of the difference at most
    ``bounds["rel"]`` of the f32 gradient's.  Prints each leaf and raises
    past a bound.  Returns (worst cos, worst rel)."""
    (l0, m0, g0, _), (l1, m1, g1, _) = lo, hi
    bad = []
    for k, a, b in [("loss", l0, l1)] + [(k, m0[k], m1[k]) for k in m1]:
        print(f"  {label} {k}: {a:.6f} (bf16) vs {b:.6f} (f32), |diff| "
              f"{abs(a - b):.3e}")
        if not abs(a - b) <= bounds["loss"]:
            bad.append(f"{k} {a} vs {b}")
    worst_cos, worst_rel = 1.0, 0.0
    for (name, a), (_, b) in zip(g0, g1):
        dot, na, nb, nd = _chunked_dots(torch, a, b)
        if nb == 0:
            cos, rel = (1.0, 0.0) if na == 0 else (0.0, math.inf)
        else:
            cos = dot / math.sqrt(na * nb) if na else 0.0
            rel = math.sqrt(nd / nb)
        worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
        print(f"  {label} grad {name} {list(a.shape)}: cos {cos:.6f}, "
              f"|bf16 - f32| / |f32| {rel:.3e}, |f32| {math.sqrt(nb):.3e}")
        if not (cos >= bounds["cos"] and rel <= bounds["rel"]):
            bad.append(f"{name}: cos {cos}, rel {rel}")
    print(f"  {label}: worst cos {worst_cos:.6f} (bound {bounds['cos']}), "
          f"worst relative difference {worst_rel:.3e} (bound "
          f"{bounds['rel']})")
    if bad:
        raise AssertionError(f"{label}: bf16 vs f32 past the bounds: "
                             + "; ".join(bad[:8]))
    return worst_cos, worst_rel


def phase_grads(torch, cfg, dev, bounds, label):
    """[5g]/[5h]: one ``loss_fn`` + ``autograd.grad`` of ``cfg`` (its
    model dtype, bf16 at published widths) on random params from seed 0
    and ``GRAD_BATCH`` x ``GRAD_SEQ`` tokens, then the same params cast
    to f32 (``param_dtype="float32"``; the low-precision params freed
    first) on the same batch; ``compare_grads`` holds one to the other
    and ``check_loss_terms`` each pass's loss to its terms.  Experts no
    token picked must have zero gradients in both passes."""
    import dataclasses
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import count_params
    from repro_torch.runtime.trainer import _map_tensors
    n = count_params(cfg)
    card = f"({_smi()}) " if dev.type == "cuda" else ""
    print(f"  {card}{cfg.name} at published widths, cut to "
          f"{cfg.num_layers} layer(s) {list(cfg.layer_pattern)}"
          + (f" + {cfg.mtp_depth} MTP module" if cfg.mtp_depth else "")
          + f": {n:,} params; {GRAD_BATCH} x {GRAD_SEQ} tokens")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
        cfg, DataConfig(global_batch=GRAD_BATCH, seq_len=GRAD_SEQ,
                        seed=0)).batch(0).items()}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = T.init_params(cfg, 0, device=dev)
    t0 = time.perf_counter()
    lo = _grad_pass(torch, cfg, params, batch)
    _sync(torch, dev)
    t_lo = time.perf_counter() - t0
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params = _map_tensors(params, lambda t: t.float())
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hi = _grad_pass(torch, cfg32, params, batch)
    _sync(torch, dev)
    t_hi = time.perf_counter() - t0
    del params
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    for name, (loss, m, _, empty) in (("bf16", lo), ("f32", hi)):
        err = check_loss_terms(cfg, loss, m, f"{label} {name}")
        print(f"  {label} {name} pass: loss {loss:.6f} = "
              + " + ".join(f"{k} {v:.6f}" for k, v in m.items())
              + f" terms (|loss - their sum| {err:.2e}); experts with no "
              f"token: {empty}, each with zero gradients")
    worst = compare_grads(torch, lo, hi, bounds, label)
    print(f"  {label}: bf16 pass {t_lo:.2f} s, f32 pass {t_hi:.2f} s; peak "
          f"memory {peak / 2**30:.2f} GiB ({peak / 1e9:.1f} GB)")
    return worst


# ---------------------------------------------------------------------------
# slice 12: the frontend models trained and decoded, the fitted link
# ---------------------------------------------------------------------------

# [5i] paligemma-3b at published widths with ONE cut, 18 -> 6 layers
# (1,189,767,168 params: 50.0 GB at 42 B a parameter at world 4; 8 layers
# would be 59.2 GB plus the sync's buffers, past the card).  8 rows of
# 1792 text tokens after the 256 image-stub embeddings: 2048 positions,
# so the prefix-LM attention takes the blocked path (query blocks of 512,
# the first reaching ``pre_hi``).  World 4, all auto, 3 steps.
PALI_TRAIN_CUT = dict(num_layers=6, layer_pattern=("attn",) * 6)
PALI_TRAIN_ARGS = ["--arch", "paligemma-3b", "--device", "cuda",
                   "--devices", "4", "--steps", "3", "--batch", "8",
                   "--seq", "1792", "--lr", "3e-4", "--seed",
                   "0"] + TRAIN_AUTO
# [5j] musicgen-medium at full depth, no cut (48 layers, 1,366,574,592
# params: 57.4 GB at 42 B a parameter); 8 rows of 1024 tokens after the
# 64 conditioning embeddings, sinusoidal positions; world 4, all auto, 3
# steps.
MUSICGEN_TRAIN_CUT = {}
MUSICGEN_TRAIN_ARGS = ["--arch", "musicgen-medium", "--device", "cuda",
                       "--devices", "4", "--steps", "3", "--batch", "8",
                       "--seq", "1024", "--lr", "3e-4", "--seed",
                       "0"] + TRAIN_AUTO
# [3p] / [3m] model-level decode at full width, no cut (paligemma-3b 18
# layers, 5.0 GB of bf16; musicgen-medium 48 layers, 2.7 GB): 8 rows of
# the frontend stub and 64 prompt tokens through ``prefill``, then 32
# greedy ``decode_step``s over the contiguous cache.
FRONTEND_DECODE = dict(rows=8, prompt=64, steps=32)
# The decode's logits (prefill's last, then each step's) against
# ``forward`` on the same tokens, per (row, position) as max |diff| over
# the vocab relative to the forward row's RMS.  Fixed before the first
# run on the card: the two paths round every bf16 activation (2^-9) at
# other GEMM shapes (a 320-token prefill and one-token steps against one
# 352-token pass), and 18 or 48 random-init layers carry it to the
# logits; phase 4's decode paths of one shape read 0.25 over logits of
# RMS ~3-5, about 5-8 %.
FRONTEND_LOGIT_RTOL = 0.1
# [5k] the fitted link: ``fit_link_params`` at world 4 over the
# reference's grid, then ``launch.train --calibrate`` twice into one
# checkpoint directory on musicgen-medium's widths at 2 layers
# (64,101,888 params), 1 step and its resume.  Not gemma2-2b at 2 layers
# (5c's model): its int8 EF vector, 4 x 745.6 M f32, is a checkpoint leaf
# past msgpack's 4 GiB bin (ROADMAP C7), and an auto plan on int8 would
# fail the save; gemma's two plans are priced and printed instead.
CAL_TRAIN_CUT = dict(num_layers=2, layer_pattern=("attn",) * 2)
CAL_TRAIN_ARGS = ["--arch", "musicgen-medium", "--device", "cuda",
                  "--devices", "4", "--batch", "8", "--seq", "1024",
                  "--lr", "3e-4", "--seed", "0", "--calibrate"] + TRAIN_AUTO


def phase_train_frontend(torch, tops, tref, codecs, cfg, argv):
    """[5i] / [5j]: ``phase_train_auto`` on a frontend model with ``argv``
    (its plan, B1/B2 launches = steps x buckets with the codec x
    log2(world), finite losses, step time and tokens/s over the TEXT
    tokens, peak memory, a profiled step's idle share, every codec'd
    bucket's real gradients through the kernels and the plain versions bit
    for bit).  Returns the launch counts."""
    from repro_torch.launch import train as train_cli
    from repro_torch.models import layers as L
    from repro_torch.models.registry import count_params, get_config
    args = train_cli.parse_args(argv)
    n = count_params(cfg)
    pos = cfg.frontend_tokens + args.seq
    blocked = (f", the blocked attention path (query blocks of "
               f"{L.QUERY_CHUNK})" if pos >= L.QUERY_CHUNK_THRESHOLD else "")
    prefix = "a bidirectional prefix" if cfg.prefix_lm else \
        f"a causal prefix, {cfg.pos_embed} positions"
    card = f"({_smi()}) " if args.device == "cuda" else ""
    print(f"  {card}{cfg.name}: {cfg.num_layers} of "
          f"{get_config(cfg.name).num_layers} layers, {n:,} params "
          f"({42 * n / 1e9:.1f} GB at 42 B a parameter); {args.batch} rows "
          f"of {cfg.frontend_tokens} frontend-stub embeddings + {args.seq} "
          f"text tokens = {pos} positions ({prefix}{blocked}); tokens/s "
          f"counts the text tokens")
    return phase_train_auto(torch, tops, tref, codecs, cfg, None, argv=argv)


def _row_rel(torch, got, want):
    """max |got - want| over the last axis relative to the RMS of want's
    row, for every leading index."""
    err = (got.float() - want.float()).abs().amax(-1)
    rms = want.float().square().mean(-1).sqrt()
    return err / torch.clamp(rms, min=1e-6)


def phase_frontend_decode(torch, cfg, dev, rtol=FRONTEND_LOGIT_RTOL):
    """[3p] / [3m]: ``cfg`` at full width, random init from seed 1: 8 rows
    of ``SyntheticLM``'s frontend stub and 64 prompt tokens through
    ``prefill`` (its offset must be Tf + 64), then 32 greedy
    ``decode_step``s over the contiguous cache, each row at its own
    offset.  Checks: every logit finite; the prefill's and every step's
    logits within ``rtol`` of ``forward`` on the same tokens per row
    relative to the row's RMS; changing the last frontend embedding moves
    position 0 (a prefix-LM) or no position before it (a causal prefix);
    changing a text token moves no earlier position; one decode step under
    ``set_sync_debug_mode("error")``.  Prints the prefill's ms, the decode
    step's ms on the host clock (the greedy loop, and one step
    synchronised) and its device kernels and idle share (profiler), and
    the peak memory.  Returns the worst relative error."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import count_params
    B, P, G = (FRONTEND_DECODE[k] for k in ("rows", "prompt", "steps"))
    Tf, V = cfg.frontend_tokens, cfg.vocab_size
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = T.init_params(cfg, 1, device=dev)
    batch = SyntheticLM(cfg, DataConfig(global_batch=B, seq_len=P,
                                        seed=0)).batch(0)
    prompt = torch.as_tensor(batch["tokens"], device=dev)
    fe = torch.as_tensor(batch["frontend"], device=dev)
    print(f"  {cfg.name}: {cfg.num_layers} layers, {count_params(cfg):,} "
          f"params ({cfg.param_dtype}); {B} rows of {Tf} frontend-stub "
          f"embeddings ({cfg.frontend_dim} wide) + {P} prompt tokens, {G} "
          f"greedy decode steps over the contiguous cache")
    cache = T.init_cache(cfg, B, Tf + P + G, device=dev)
    with torch.inference_mode():
        _sync(torch, dev)
        t0 = time.perf_counter()
        logits, cache, off = T.prefill(params, cfg, prompt, cache, fe)
        _sync(torch, dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if off != Tf + P:
            raise AssertionError(f"prefill offset {off}, want {Tf + P}")
        base = torch.full((B,), off, dtype=torch.int32, device=dev)
        out, fed = [logits[:, 0]], []
        tok = logits.argmax(-1)
        _sync(torch, dev)
        t0 = time.perf_counter()
        for i in range(G):
            fed.append(tok)
            logits, cache = T.decode_step(params, cfg, tok, cache, base + i)
            out.append(logits[:, 0])
            tok = logits.argmax(-1)
        _sync(torch, dev)
        loop_ms = (time.perf_counter() - t0) / G * 1e3
        got = torch.stack(out, 1)                        # [B, G+1, V]
        if tuple(got.shape) != (B, G + 1, V) or \
                not torch.isfinite(got).all():
            raise AssertionError(f"{cfg.name}: decode logits not finite or "
                                 f"of shape {tuple(got.shape)}")
        full = torch.cat([prompt] + fed, dim=1)           # [B, P+G]
        want = T.forward(params, cfg, full, fe)[:, Tf + P - 1:]
        rel = _row_rel(torch, got, want)
        worst = rel.max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        print(f"  prefill ({B} x {Tf + P} positions) {prefill_ms:.2f} ms; "
              f"offset {off} = {Tf} + {P}; greedy decode {loop_ms:.2f} ms a "
              f"step (host clock over {G} steps)")
        print(f"  prefill + decode vs forward on the same tokens ({B} rows "
              f"x {G + 1} positions): max|diff| / RMS(forward row) <= "
              f"{worst:.4f} (bound {rtol}), argmax agreement "
              f"{agree * 100:.1f}%, |logits| <= "
              f"{want.abs().max().item():.3f}")
        if not worst <= rtol:
            raise AssertionError(f"{cfg.name}: decode logits {worst} of the "
                                 f"row RMS from forward's")
        del want, got, out
        # the prefix: bidirectional for a prefix-LM, causal otherwise; the
        # text: causal.  Two rows, against a forward of the same two rows.
        two, fe2 = full[:2], fe[:2]
        base_l = T.forward(params, cfg, two, fe2)
        moved = fe2.clone()
        moved[:, -1] += 0.5
        l_fe = T.forward(params, cfg, two, moved)
        d0 = (l_fe[:, 0] - base_l[:, 0]).abs().max().item()
        d_pre = (l_fe[:, :Tf - 1] - base_l[:, :Tf - 1]).abs().max().item()
        c = P // 2
        tok2 = two.clone()
        tok2[:, c] = (tok2[:, c] + 7) % V
        l_tok = T.forward(params, cfg, tok2, fe2)
        d_before = (l_tok[:, :Tf + c] - base_l[:, :Tf + c]).abs().max().item()
        d_at = (l_tok[:, Tf + c] - base_l[:, Tf + c]).abs().max().item()
        kind = "bidirectional" if cfg.prefix_lm else "causal"
        print(f"  {kind} prefix: the last frontend embedding + 0.5 moves "
              f"position 0 by {d0:.4e} and positions 0..{Tf - 2} by at most "
              f"{d_pre:.4e}; text token {c} changed: positions 0..{Tf + c - 1}"
              f" move {d_before:.4e}, position {Tf + c} {d_at:.4e}")
        if cfg.prefix_lm and not d0 > 0:
            raise AssertionError("prefix-LM: position 0 does not see the "
                                 "last prefix embedding")
        if not cfg.prefix_lm and d_pre != 0:
            raise AssertionError("causal prefix: an earlier prefix position "
                                 "saw a later embedding")
        if d_before != 0 or not d_at > 0:
            raise AssertionError(f"text causality: earlier positions moved "
                                 f"{d_before}, the changed one {d_at}")
        del base_l, l_fe, l_tok
        last = base + (G - 1)
        step = lambda: T.decode_step(params, cfg, fed[-1], cache, last)
        if dev.type == "cuda":
            _sync_free(torch, step)
        step()
        _sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        _sync(torch, dev)
        step_ms = (time.perf_counter() - t0) / 5 * 1e3
        if dev.type == "cuda":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    step()
                _sync(torch, dev)
            kernels = [e for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
            busy = _span_us(kernels) / 3e3
            print(f"  decode step {step_ms:.2f} ms (host clock, "
                  f"synchronised); device kernels {busy:.2f} ms per step "
                  f"(profiler), so the card idles "
                  f"{max(0.0, 1 - busy / step_ms) * 100:.1f}% of a step")
            print(prof.key_averages().table(sort_by="self_device_time_total",
                                            row_limit=8,
                                            max_name_column_width=40))
        else:
            print(f"  decode step {step_ms:.2f} ms (host clock)")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    print(f"  {cfg.name}: peak memory {peak / 2**30:.2f} GiB "
          f"({peak / 1e9:.1f} GB)")
    return worst


class _Tee:
    """A stream that writes to each of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _plan(torch, cfg, world, link):
    """The all-auto bucket plan of ``cfg`` at ``world`` priced with
    ``link`` (host only)."""
    from repro_torch.core.bsp import BSPConfig
    from repro_torch.core.superstep import engine_for
    from repro_torch.models import transformer as T
    from repro_torch.weights import reference_leaves
    return engine_for(reference_leaves(T.init_params(cfg, device="meta"),
                                       cfg),
                      BSPConfig(schedule="auto", bucket_mb="auto",
                                bucket_codec="auto", link=link),
                      world, force_dtype=torch.float32, zero1=True)


def phase_calibrate(torch, tops, tref, codecs, cfg, dev, argv=None):
    """[5k]: ``calibrate.fit_link_params`` at the world of ``argv``
    (default ``CAL_TRAIN_ARGS``) on ``dev`` over the reference's grid
    (``describe()``: alpha, bandwidth, hop, residual and every sample; a
    hop or bandwidth at the fit's clamp is said to be so); the all-auto
    plans of gemma2-2b at 2 layers and of ``cfg`` priced with
    ``TPU_V5E_ICI`` and with the fitted link; then ``launch.train.run`` on
    ``cfg`` with ``--calibrate --checkpoint-dir D`` for 1 step (a fresh
    fit, written to ``D/link_calibration.json`` as ``{"link": ...}``, the
    plan priced with it) and again with ``--steps 2`` (it must print
    ``calibrate: reloaded``, resume and keep the plan).  Each run through
    ``_counted_run``: B1/B2 launches = its steps x buckets with the codec x
    log2(world), whatever codecs the fitted link picks (none is a valid
    outcome, and is said).  Between the runs, a train state built with the
    persisted link must give the first run's plan, and every bucket of it
    that carries a codec is held to the plain versions on real gradients
    (``real_bucket_check``).  Returns the launch counts of both runs."""
    import contextlib
    import io
    import json
    import shutil
    from repro_torch.core import calibrate as CAL
    from repro_torch.core.cost_model import TPU_V5E_ICI, LinkParams
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import count_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import make_bsp_train_step
    argv = list(argv or CAL_TRAIN_ARGS)
    world = train_cli.parse_args(argv).devices
    hops = world.bit_length() - 1
    t0 = time.perf_counter()
    fit = CAL.fit_link_params(world, min_devices=2, device=dev)
    print(f"  fit_link_params at world {world} on {dev} "
          f"({time.perf_counter() - t0:.2f} s):")
    for line in fit.describe().splitlines():
        print(f"  {line}")
    lk = fit.link
    grid = len(CAL.FIT_SCHEDULES) * len(CAL.FIT_PAYLOAD_ELEMS)
    if len(fit.samples) != grid or not all(
            0 < s.seconds < math.inf for s in fit.samples) or not all(
            0 < v < math.inf for v in (lk.alpha_s, lk.bw_Bps, lk.hop)) \
            or lk.name != f"fitted-{dev.type}{world}":
        raise AssertionError(f"link fit: {fit}")
    # fit_from_samples clamps a least-squares value <= 0 to 1e-12
    clamped = [what for what, v in (("hop", lk.hop),
                                    ("1/bandwidth", 1 / lk.bw_Bps))
               if v <= 1e-12]
    print("  at the fit's clamp of 1e-12 (a least-squares value <= 0, "
          f"not identified): {', '.join(clamped) or 'nothing'}")
    for c in (train_config(TRAIN_FORCED_CUT), cfg):
        for link in (TPU_V5E_ICI, lk):
            print(f"  plan of {c.name} at {c.num_layers} layers, world "
                  f"{world}, priced with {link.name}: "
                  f"{_plan(torch, c, world, link).describe()}")
    # a checkpoint holds 26 B a parameter (bf16 params, two f32 moments,
    # the f32 EF of 4 ranks); keep 3 + one being written
    root = _soak_dir(4 * 26 * count_params(cfg), prefix="calibrate-")
    path = Path(root) / train_cli.CALIBRATION_FILE

    def counted(steps, label):
        args = train_cli.parse_args(argv + ["--steps", str(steps),
                                            "--checkpoint-dir", root])
        buf = io.StringIO()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            out, counts, want, _ = _counted_run(torch, tops, cfg, args,
                                                label, steps=1)
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, want {want} "
                                 f"(= 1 step x buckets with the codec x "
                                 f"log2({world}))")
        return args, out["engine"], buf.getvalue(), counts, \
            out["history"][0]

    args1, eng1, text1, c1, h1 = counted(1, "calibrate run 1")
    data = json.loads(path.read_text())
    link1 = LinkParams(**data["link"])
    if list(data) != ["link"] or eng1.link != link1 or \
            "calibrate: reloaded" in text1 or \
            f"fitted {link1.name}: alpha=" not in text1:
        raise AssertionError(f"calibrate run 1: {data}, plan link "
                             f"{eng1.link}")
    _, init_state = make_bsp_train_step(
        cfg, AdamWConfig(lr=args1.lr, total_steps=args1.steps,
                         warmup_steps=1), train_cli.bsp_config(args1, link1),
        world, device=dev)
    if init_state.engine.describe() != eng1.describe():
        raise AssertionError(f"calibrate: plan {init_state.engine.describe()}"
                             f" from the persisted link, the run's "
                             f"{eng1.describe()}")
    state = init_state(T.init_params(cfg, args1.seed, device=dev))
    batches = SyntheticLM(cfg, DataConfig(global_batch=args1.batch,
                                          seq_len=args1.seq,
                                          seed=args1.seed))
    pairs = [(b, c) for b, c in zip(eng1.buckets, eng1.codec_names)
             if c != "none"]
    real_bucket_check(torch, cfg, tref, codecs, eng1, state.params,
                      batches.batch(0), dev, pairs)
    del state, init_state
    _, eng2, text2, c2, h2 = counted(2, "calibrate run 2")
    reload = f"calibrate: reloaded {link1.name} from {path}"
    if reload not in text2 or f"resumed from {root} at step 1" not in text2 \
            or eng2.describe() != eng1.describe() or eng2.link != link1:
        raise AssertionError(f"calibrate run 2: plan {eng2.describe()}, "
                             f"the first run's {eng1.describe()}")
    print(f"  --calibrate run 1: fitted {link1.name} and wrote {path}; "
          f"step 0 loss {h1['loss']:.4f} in {h1['sec']:.3f} s; run 2: "
          f"'{reload}', resumed, the same plan, step 1 loss "
          f"{h2['loss']:.4f}; launches {c1} and {c2} = 1 step x buckets "
          f"with the codec x {hops} hops each; "
          + (f"{len(pairs)} codec bucket(s) of the plan held bit for bit"
             if pairs else "the calibrated plan puts no bucket on a "
             "codec, so no decode-add launches and no bucket to hold (a "
             "valid outcome)"))
    shutil.rmtree(root, ignore_errors=True)
    return {c: c1[c] + c2[c] for c in c1}


# Slice 13: the sharding surface.  [5l] the GSPMD step (--schedule xla) at
# gemma2-2b's full published width and depth, no cut (26 layers,
# 2,614,341,888 params).  Reckoned before the run: bf16 params and grads
# 2 x 5.23 GB and f32 AdamW moments 20.91 GB (12 B a parameter,
# ``adamw.optimizer_bytes_per_param``), 31.4 GB, plus the global batch's
# activations under block remat (13 unit boundaries of [8, 1024, 2304]
# bf16, one unit's recompute, the loss's 512-token logit chunks of
# [8, 512, 256000] f32, 4.2 GB each) and the update's chunked temporaries
# (``adamw.UPDATE_CHUNK``): about 45-55 GB, so the card holds it without a
# cut.  The batch, seed and lr of phase 5 (8 x 1024, world 4 as the mesh's
# data axis), 3 steps.
GSPMD_ARGS = ["--arch", "gemma2-2b", "--device", "cuda", "--devices", "4",
              "--steps", "3", "--batch", "8", "--seq", "1024", "--schedule",
              "xla", "--lr", "3e-4", "--seed", "0"]
# The GSPMD step's step-0 loss against phase 5's fractal step-0 loss on the
# same params (8 layers, seed 0) and batch, both bf16.  Fixed before the
# first run on the card: the GSPMD step runs the 8 rows as one batch, the
# fractal step 4 ranks of 2 rows, so every bf16 GEMM and attention
# rounds at other shapes; the loss is the f32 mean of 8,192 per-token
# cross-entropies of ~12.5 (ln 256000 = 12.45), which averages that noise
# down to ~1e-3 (phase 5b's step 0 equals phase 5's bit for bit because
# the shapes are the same).
GSPMD_LOSS_ATOL = 2e-2
# [5m] Tier A against Tier B on the card (the reference's
# ``tests/bsp_equivalence_check.py``): gemma2-2b cut to 2 layers (745.6 M
# params), world 4, ``grad_clip=0`` (Tier B clips per shard in the
# reference), 2 steps of each on the same params and batches.  Losses:
# step 0 as ``GSPMD_LOSS_ATOL``, step 1 follows the params, twice that.
# Params: AdamW's m̂/√v̂ turns a near-zero gradient's sign (float noise
# between the tiers) into a whole step of lr (C10), so 2·lr a step taken,
# plus the bf16 rounding of each tier's update: one bf16 ulp of the
# element a step (at |p| ~ 1 that is 2^-8 = 3.9e-3, 6.5 x 2·lr).  At step
# 0 that bound is exact (|m̂/√v̂| <= 1, each rounding <= ulp/2); at step 1
# |m̂/√v̂| may reach 1.0004 for betas (0.9, 0.95) (Cauchy-Schwarz) and the
# decoupled decay adds lr·wd (3e-5) of the gap, so the bound carries a
# factor EQUIV_SLACK.
EQUIV_CUT = dict(num_layers=2, layer_pattern=("local", "global"))
EQUIV_STEPS = 2
EQUIV_LOSS_ATOL = (GSPMD_LOSS_ATOL, 2 * GSPMD_LOSS_ATOL)
EQUIV_SLACK = 1.001
# [4m] phase 3's and 3c's gemma2-2b traffic at full width with the slot
# batch sharded over a ("data",) mesh of 4 virtual devices: token-identical
# to phases 3 and 3c, with phase 3's B7 launches; then one paged decode
# step with and without the serving policy ``make_decode_step`` sets (the
# hooks' host cost), and a slot pool the mesh does not divide.
MESH_DEVICES = 4


def _bf16_ulp(torch, x):
    """One bf16 ulp of each element of ``x`` (f32): 2^(e - 8) for |x| in
    [2^(e-1), 2^e)."""
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def phase_gspmd_train(torch, cfg, cut, first_loss, argv=None):
    """[5l] The slice's main path: ``launch.train.run`` with ``--schedule
    xla`` on ``cfg`` (the full model): finite losses for every step, the
    step time, tokens/s and peak memory; then three more steps for the idle
    share (``_profiled_steps``); then one step on ``cut`` (phase 5's 8
    layers), whose step-0 loss must be within ``GSPMD_LOSS_ATOL`` of
    ``first_loss`` (phase 5's fractal step 0; not checked when None).
    Returns ``(step seconds, step-0 loss of the cut)``."""
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_cli
    from repro_torch.models import act_sharding as ACT
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import count_params
    from repro_torch.optim.adamw import AdamWConfig, optimizer_bytes_per_param
    args = train_cli.parse_args(argv or GSPMD_ARGS)
    dev = torch.device(args.device)
    n = count_params(cfg)
    acfg = AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=1)
    print(f"  {cfg.name}: {cfg.num_layers} layers, {n:,} params; reckoned "
          f"{optimizer_bytes_per_param(acfg) * n / 1e9:.2f} GB of params, "
          f"grads and f32 moments ({optimizer_bytes_per_param(acfg)} B a "
          f"parameter) before activations; mesh ({args.devices}, 1), the "
          f"global batch {args.batch} x {args.seq} in one step")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = train_cli.run(cfg, args)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if out["engine"] is not None or len(losses) != args.steps or \
            not np.all(np.isfinite(losses)):
        raise AssertionError(f"gspmd: losses {losses}, engine "
                             f"{out['engine']}")
    tokens = args.batch * args.seq
    for h in hist:
        print(f"  gspmd step {h['step']}: loss {h['loss']:.4f}, "
              f"{h['sec']:.3f} s, {tokens / h['sec']:.0f} tokens/s")
    print(f"  gspmd: peak memory {peak / 2**30:.2f} GiB ({peak / 1e9:.1f} "
          f"GB)")
    del out
    gc.collect()
    secs = [h["sec"] for h in hist[1:]]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        params = T.init_params(cfg, args.seed, device=dev)
        step, state = train_cli.gspmd_state(cfg, args, params, dev, acfg)
        del params
        data = SyntheticLM(cfg, DataConfig(global_batch=args.batch,
                                           seq_len=args.seq, seed=args.seed))
        _, _, wall, busy, prof = _profiled_steps(torch, step, state, data,
                                                 dev, "gspmd")
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=10,
                                        max_name_column_width=40))
        del state, prof
        gc.collect()
        torch.cuda.empty_cache()
    one = type(args)(**{**vars(args), "steps": 1})
    loss0 = train_cli.run(cut, one)["history"][0]["loss"]
    ACT.clear_policy()
    if first_loss is not None:
        gap = abs(loss0 - first_loss)
        print(f"  gspmd step-0 loss at {cut.num_layers} layers {loss0!r}, "
              f"phase 5's fractal step-0 loss {first_loss!r} (the same "
              f"params and batch): |diff| {gap:.4e} (bf16 bound "
              f"{GSPMD_LOSS_ATOL})")
        if not gap <= GSPMD_LOSS_ATOL:
            raise AssertionError(f"gspmd step-0 loss {loss0} is {gap} from "
                                 f"the fractal step's {first_loss}")
    return secs, loss0


def _param_snapshot(torch, params, cfg):
    from repro_torch.weights import reference_leaves
    return [(leaf.path, [t.detach().clone() for t in leaf.parts])
            for leaf in reference_leaves(params, cfg)]


def phase_tier_equivalence(torch, cfg, dev, argv=None):
    """[5m] ``make_gspmd_train_step`` (Tier A) and ``make_bsp_train_step``
    with the fractal schedule and no codec (Tier B) on the same params and
    batches, ``EQUIV_STEPS`` steps each, ``grad_clip=0``: each step's
    losses within ``EQUIV_LOSS_ATOL`` and every param element within
    (steps taken) x (2·lr + one bf16 ulp of it) x ``EQUIV_SLACK`` of the
    other tier's.
    Prints the largest gaps; returns the largest param gap over its
    bound."""
    from repro_torch.core.bsp import BSPConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import act_sharding as ACT
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, init
    from repro_torch.runtime import trainer
    from repro_torch.runtime.elastic import reshard_state
    args = train_cli.parse_args(argv or TRAIN_ARGS)
    world = args.devices
    acfg = AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=1,
                       grad_clip=0.0)
    data = SyntheticLM(cfg, DataConfig(global_batch=args.batch,
                                       seq_len=args.seq, seed=args.seed))
    mesh = make_mesh((world, 1), ("data", "model"), device=dev)
    step_a, (pspec, _, _) = trainer.make_gspmd_train_step(cfg, mesh, acfg)
    params = T.init_params(cfg, args.seed, device=dev)
    params = reshard_state(params, mesh,
                           SH.port_param_specs(cfg, params, pspec))
    state_a = trainer.GSPMDTrainState(params, init(params, acfg), cfg)
    del params
    step_b, init_b = trainer.make_bsp_train_step(
        cfg, acfg, BSPConfig(schedule="fractal"), world, device=dev)
    state_b = init_b(T.init_params(cfg, args.seed, device=dev))
    worst = 0.0
    for s in range(EQUIV_STEPS):
        state_a, m_a = step_a(state_a, data.batch(s))
        state_b, m_b = step_b(state_b, data.batch(s))
        la, lb = m_a["loss"].item(), m_b["loss"].item()
        gap_l = abs(la - lb)
        bound = (s + 1) * 2 * args.lr
        big, where, ratio = 0.0, "", 0.0
        for (path, pa), (_, pb) in zip(_param_snapshot(torch, state_a.params,
                                                       cfg),
                                       _param_snapshot(torch, state_b.params,
                                                       cfg)):
            for a, b in zip(pa, pb):
                a, b = a.float(), b.float()
                d = (a - b).abs()
                lim = (bound + (s + 1) * _bf16_ulp(
                    torch, torch.maximum(a.abs(), b.abs()))) * EQUIV_SLACK
                r = (d / lim).max().item()
                if d.max().item() > big:
                    big, where = d.max().item(), path
                ratio = max(ratio, r)
        worst = max(worst, ratio)
        print(f"  step {s}: loss xla {la!r}, fractal {lb!r}, |diff| "
              f"{gap_l:.4e} (bound {EQUIV_LOSS_ATOL[s]}); params: largest "
              f"|xla - fractal| {big:.4e} at {where}, largest gap / its "
              f"bound ({s + 1} x (2·lr {2 * args.lr:g} + one bf16 ulp) x "
              f"{EQUIV_SLACK}) {ratio:.3f}")
        if not gap_l <= EQUIV_LOSS_ATOL[s]:
            raise AssertionError(f"step {s}: losses {la} and {lb}")
        if not ratio <= 1.0:
            raise AssertionError(f"step {s}: a param {ratio:.3f} x its "
                                 "bound from the other tier's")
    ACT.clear_policy()
    return worst


# Slice 14: the dry run.  [9a] the CLI on three production cells, on both
# of the reference's v5e meshes (16 x 16 and 2 x 16 x 16), traced on
# ``meta``; each record must say ``ok``.
DRYRUN_CELLS = ("gemma2-2b:train_4k", "deepseek-v3-671b:decode_32k",
                "xlstm-1.3b:long_500k")
DRYRUN_TAG = "chip_smoke"
# [9b] phase 5l's step (``GSPMD_ARGS``: gemma2-2b at all 26 layers, 8 x
# 1024 tokens, mesh (4, 1)) under each remat, traced on ``meta`` and then
# run once on the card inside the same counter.
DRYRUN_REMATS = ("block", "dots")
# The traced peak of live storage against the allocator's peak for the
# same step (``torch.cuda.max_memory_allocated`` less what was allocated
# before the step outside its arguments).  Fixed before the first run on
# the card: both see the same tensors freed at the same points (the
# autograd engine frees saved tensors in one order on every device), so
# they differ only by what the dispatcher does not see: cuBLAS's
# workspace, kernels' internal scratch (sorts, reductions) and the
# allocator's rounding of each block to 512 bytes.  Those are tens of MiB
# against a peak of ~50 GiB (phase 5l: 50.39 GiB under block remat), so
# 5 % holds them with room.
DRYRUN_PEAK_RTOL = 0.05


def phase_dryrun_cli(torch, src=None, cells=DRYRUN_CELLS, tag=DRYRUN_TAG):
    """[9a] ``python -m repro_torch.launch.dryrun --cell C --mesh both`` for
    each of ``cells``, each a process of its own, all started at once:
    every process exits 0 and each of its two records says ``ok``.
    Prints each record's trace seconds and roofline terms; returns the
    records."""
    import os
    from repro_torch.launch import dryrun as DR
    env = dict(os.environ, PYTHONPATH=str(src or SRC))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell", c,
         "--mesh", "both", "--force", "--tag", tag], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cells]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    recs = []
    for cell, p, out in zip(cells, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"dryrun --cell {cell}: exit "
                                 f"{p.returncode}\n{out[-3000:]}")
        arch, _, shape = cell.partition(":")
        for mesh in ("single", "multi"):
            rec = json.loads(DR.cell_path(arch, shape, mesh, tag)
                             .read_text())
            if rec.get("status") != "ok":
                raise AssertionError(f"dryrun {cell} {mesh}: {rec}")
            rf, mem = rec["roofline"], rec["memory"]
            print(f"  9a {arch} {shape} {mesh} ({rec['devices']} devices): "
                  f"trace {rec['trace_s']} s"
                  f"{' (reused)' if rec['trace_reused'] else ''}; per "
                  f"device: arguments {mem['argument_size_in_bytes']:,} B, "
                  f"{rec['hlo_stats']['flops']:.4e} FLOPs (even split); "
                  f"roofline on {rec['peaks']}: compute "
                  f"{rf['compute_s']:.4e} s, memory (eager op-by-op "
                  f"traffic) {rf['memory_s']:.4e} "
                  f"s, collective {rf['collective_s']} s, dominant "
                  f"{rf['dominant']}; useful_flops_ratio "
                  f"{rec.get('useful_flops_ratio')}, roofline_fraction "
                  f"{rec.get('roofline_fraction')}")
            recs.append(rec)
    return recs


def _meta_like(torch, batch):
    """A numpy batch's ``meta`` stand-in: shapes and dtypes only."""
    return {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                           device="meta") for k, v in batch.items()}


def phase_dryrun_card(torch, cfg, dev, argv=None):
    """[9b] Phase 5l's GSPMD step on ``cfg`` under each of
    ``DRYRUN_REMATS``: traced on ``meta`` through ``analyze_program``,
    then one real step (data step 0) on ``dev`` inside a
    ``ProgramCounter``, then two plain steps timed.  The traced and run
    FLOP and dot counts must be equal, the traced argument bytes the
    bytes of the state and batch on ``dev``, the traced peak of live
    storage within ``DRYRUN_PEAK_RTOL`` of the allocator's (on the card);
    the second remat's step-0 loss equal to the first's bit for bit and
    its params within phase 5m's bound (2·lr + one bf16 ulp, x
    ``EQUIV_SLACK``) of the first's.  Returns ``{remat: readings}``."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import Mesh, make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, init
    from repro_torch.runtime import trainer
    args = train_cli.parse_args(argv or GSPMD_ARGS)
    cuda = dev.type == "cuda"
    acfg = AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=1)
    data = SyntheticLM(cfg, DataConfig(global_batch=args.batch,
                                       seq_len=args.seq, seed=args.seed))
    on_dev = lambda b: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    shape = ((args.devices or 1), 1)
    out, first = {}, None
    for remat in DRYRUN_REMATS:
        with DR.levers({"remat": remat}):
            meta = Mesh(shape, ("data", "model"), device=torch.device("meta"))
            step, _ = trainer.make_gspmd_train_step(cfg, meta, acfg)
            params = T.init_params(cfg, device="meta")
            t0 = time.perf_counter()
            traced = H.analyze_program(
                step, trainer.GSPMDTrainState(params, init(params, acfg),
                                              cfg),
                _meta_like(torch, data.batch(0)))
            trace_s = time.perf_counter() - t0
            del params
            mesh = make_mesh(shape, ("data", "model"), device=dev)
            step, _ = trainer.make_gspmd_train_step(cfg, mesh, acfg)
            params = T.init_params(cfg, args.seed, device=dev)
            state = trainer.GSPMDTrainState(params, init(params, acfg), cfg)
            del params
            batch = on_dev(data.batch(0))
            held = H.tensor_bytes((state, batch))
            gc.collect()
            if cuda:
                torch.cuda.synchronize(dev)
                others = torch.cuda.memory_allocated(dev) - held
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            with H.ProgramCounter((state, batch)) as pc:
                state, m = step(state, batch)
            if cuda:
                torch.cuda.synchronize(dev)
            counted_s = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated(dev) - others if cuda
                    else pc.stats.peak_live_bytes)
            loss0 = m["loss"].item()
            run = pc.stats
            # the least the step must move: every argument read once and
            # every output (the state, updated in place, and the metrics)
            # written once
            min_bytes = held + H.tensor_bytes((state, m))
            secs = []
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            for s in (1, 2):
                b = on_dev(data.batch(s))
                if cuda:
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                state, _ = step(state, b)
                if cuda:
                    torch.cuda.synchronize(dev)
                secs.append(time.perf_counter() - t0)
            plain_peak = (torch.cuda.max_memory_allocated(dev) - others
                          if cuda else 0)
        eager = H.roofline_terms(traced)
        step_s = min(secs)
        t_bytes = min_bytes / H.H100_SXM.hbm
        floor_s = max(eager["compute_s"], t_bytes)
        by = "operations" if eager["compute_s"] >= t_bytes else "bytes"
        print(f"  9b remat={remat}: traced on meta in {trace_s:.1f} s, the "
              f"counted step on {dev} in {counted_s:.1f} s; FLOPs traced "
              f"{traced.flops:,} / run {run.flops:,}; dots "
              f"{traced.dot_count} / {run.dot_count}; aten ops "
              f"{traced.instr_count} / {run.instr_count}; argument bytes "
              f"traced {traced.input_bytes:,} / on {dev.type} {held:,}")
        print(f"  9b remat={remat}: peak of live storage traced "
              f"{traced.peak_live_bytes / 2**30:.2f} GiB, counted on "
              f"{dev.type} {run.peak_live_bytes / 2**30:.2f} GiB, allocator "
              f"{peak / 2**30:.2f} GiB (gap "
              f"{(traced.peak_live_bytes - peak) / max(peak, 1) * 100:+.2f}"
              f" %, bound {DRYRUN_PEAK_RTOL * 100:.0f} %); plain steps "
              f"{', '.join(f'{t:.3f}' for t in secs)} s (peak "
              f"{plain_peak / 2**30:.2f} GiB)")
        print(f"  9b remat={remat}: the H100 SXM floor {floor_s:.4f} s "
              f"({by}: the traced FLOPs at peak {eager['compute_s']:.4f} s, "
              f"{eager['compute_s'] / step_s * 100:.1f} % of the step; the "
              f"minimal bytes (arguments read once, outputs written once) "
              f"{min_bytes:,} B at peak bandwidth {t_bytes:.4f} s, "
              f"{t_bytes / step_s * 100:.1f} % of the step), "
              f"{floor_s / step_s * 100:.1f} % of it reached; eager op-by-op "
              f"traffic at peak bandwidth {eager['memory_s']:.4f} s "
              f"({traced.hbm_bytes:.4e} B: every dispatched op's operands "
              f"and results, no bound), "
              f"{eager['memory_s'] / step_s * 100:.1f} % of the step; "
              f"step-0 loss {loss0!r}; card {_smi()}")
        if traced.flops != run.flops or traced.dot_count != run.dot_count:
            raise AssertionError(f"remat={remat}: traced FLOPs/dots "
                                 f"{traced.flops}/{traced.dot_count}, run "
                                 f"{run.flops}/{run.dot_count}")
        if not traced.input_bytes == held == run.input_bytes:
            raise AssertionError(f"remat={remat}: argument bytes traced "
                                 f"{traced.input_bytes}, held {held}, run "
                                 f"{run.input_bytes}")
        if abs(traced.peak_live_bytes - peak) > DRYRUN_PEAK_RTOL * peak:
            raise AssertionError(f"remat={remat}: traced peak "
                                 f"{traced.peak_live_bytes} vs {peak}")
        out[remat] = dict(flops=traced.flops, dots=traced.dot_count,
                          peak=peak, traced_peak=traced.peak_live_bytes,
                          step_s=step_s, loss0=loss0, floor_s=floor_s,
                          eager_traffic_s=eager["memory_s"])
        if first is None:
            first = (remat, loss0, _param_snapshot(torch, state.params, cfg))
        else:
            name, want, snap = first
            if loss0 != want:
                raise AssertionError(f"step-0 loss {remat} {loss0!r} != "
                                     f"{name} {want!r}")
            ratio, big = 0.0, 0.0
            for (path, pa), (_, pb) in zip(
                    _param_snapshot(torch, state.params, cfg), snap):
                for a, b in zip(pa, pb):
                    a, b = a.float(), b.float()
                    d = (a - b).abs()
                    lim = (2 * args.lr + _bf16_ulp(
                        torch, torch.maximum(a.abs(), b.abs()))) * EQUIV_SLACK
                    ratio = max(ratio, (d / lim).max().item())
                    big = max(big, d.max().item())
            print(f"  9b {remat} vs {name}: step-0 loss bit for bit; params "
                  f"after step 0: largest |diff| {big:.4e}, largest gap / "
                  f"its bound {ratio:.3f}; step {out[remat]['step_s']:.3f} "
                  f"s vs {out[name]['step_s']:.3f} s, peak "
                  f"{out[remat]['peak'] / 2**30:.2f} vs "
                  f"{out[name]['peak'] / 2**30:.2f} GiB, FLOPs "
                  f"{out[remat]['flops']:.4e} vs {out[name]['flops']:.4e}")
            if not ratio <= 1.0:
                raise AssertionError(f"{remat}: a param {ratio:.3f} x its "
                                     f"bound from {name}'s")
            del snap
            first = None
        del state, m, batch
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def phase_mesh_serve(torch, ops, cfg, runs, max_slots_cfg=None):
    """[4m] ``launch.serve.run`` with ``--devices MESH_DEVICES`` for each
    ``(argv, earlier out, (launches, merges))`` of ``runs`` (phase 3's and
    3c's): every request token-identical to the earlier run's, and B7's
    launches and merges equal to its.  Then a slot pool of 6 on the mesh
    (on ``max_slots_cfg``, a cut of ``cfg``) must raise the reference's
    ``ValueError``.  Returns each run's (launches, merges)."""
    from repro_torch.launch import serve as serve_cli
    got = []
    for argv, earlier, want in runs:
        out = {}
        counts = phase_serve(torch, ops, cfg, argv + [
            "--devices", str(MESH_DEVICES)], out=out)
        same = sum(out["results"][r] == earlier["results"][r]
                   for r in earlier["results"])
        n = len(earlier["results"])
        print(f"  --devices {MESH_DEVICES} ({out['args'].kv_mode} cache): "
              f"outputs token-identical to the unsharded run's for "
              f"{same}/{n} requests; launches {counts}, the unsharded "
              f"run's {want}")
        if same != n or sorted(out["results"]) != sorted(earlier["results"]):
            raise AssertionError(f"mesh serving: {same}/{n} requests "
                                 "token-identical")
        if counts != want:
            raise AssertionError(f"mesh serving launches {counts}, the "
                                 f"unsharded run's {want}")
        got.append(counts)
    bad = serve_cli.parse_args(runs[0][0] + ["--max-slots", "6", "--devices",
                                             str(MESH_DEVICES)])
    try:
        serve_cli.run(max_slots_cfg or cfg, bad)
    except ValueError as exc:
        want = f"--max-slots 6 must divide across {MESH_DEVICES} devices"
        if str(exc) != want:
            raise AssertionError(f"max_slots error {exc!r}, want {want!r}")
        print(f"  --max-slots 6 --devices {MESH_DEVICES}: ValueError "
              f"{str(exc)!r}, as the reference's")
    else:
        raise AssertionError("--max-slots 6 --devices 4 did not raise")
    return got


def phase_mesh_decode(torch, cfg, dev, calls=100_000):
    """[4m] One paged decode step of ``cfg`` profiled without an activation
    policy (as phase 4) and with the one ``make_decode_step`` sets on a
    (``MESH_DEVICES``, 1) ("data", "model") mesh (the reference's builders
    read both axes): host ms, device ms, idle share of
    each; the hooks a step calls, and each hook's host cost with and
    without a policy.  Returns ((step ms, device ms) without, with)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import act_sharding as ACT
    from repro_torch.models import transformer as T
    from repro_torch.runtime import trainer
    params = T.init_params(cfg, 1, device=dev)
    cache, args, kw, chunk, _ = _decode_setup(torch, T, params, cfg, dev,
                                              contiguous=False)
    step = lambda: T.decode_step(params, cfg, *args, **kw)[0]
    mesh = make_mesh((MESH_DEVICES, 1), ("data", "model"), device=dev)
    x = torch.zeros(args[0].shape[0], 1, cfg.d_model, device=dev)
    res, cost = [], []
    for policy in (False, True):
        ACT.clear_policy()
        if policy:
            trainer.make_decode_step(
                cfg, mesh, args[0].shape[0],
                kw["block_tables"].shape[1] * cache[0]["k"].shape[1])
        print(f"  decode step with {'the' if policy else 'no'} activation "
              f"policy{' of make_decode_step' if policy else ''}:")
        res.append(_profile_steps(torch, cfg, dev, step, chunk))
        t0 = time.perf_counter()
        for _ in range(calls):
            ACT.hidden(x)
        cost.append((time.perf_counter() - t0) / calls * 1e6)
    seen = [0]
    plain = ACT._constrain

    def counting(x, *spec):
        seen[0] += 1
        return plain(x, *spec)

    ACT._constrain = counting
    try:
        with torch.inference_mode():
            step()
    finally:
        ACT._constrain = plain
        ACT.clear_policy()
    (ms0, busy0), (ms1, busy1) = res
    print(f"  act hooks: {seen[0]} calls a decode step; "
          f"{cost[0]:.3f} us a call without a policy (one global check), "
          f"{cost[1]:.3f} us with one (the reference's fixed spec); decode "
          f"step {ms0:.2f} ms (idle {max(0.0, 1 - busy0 / ms0) * 100:.1f}%) "
          f"without, {ms1:.2f} ms (idle "
          f"{max(0.0, 1 - busy1 / ms1) * 100:.1f}%) with the policy")
    return res


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
            merge = re.search(r"merge_kernelI(13__nv_bfloat16|f)",
                              m.group(1))
            ops_k = re.search(r"((?:int8_)?tree_pass_kernel|gemm_[a-z0-9]+"
                              r"_kernel|flash_[a-z]+_kernel)(?:I(f|t)(f|t))?",
                              m.group(1))
            ring = re.search(r"ring_pass_kernelI([fta])([ft])Li(\d)ELb([01])",
                             m.group(1))
            ef = re.search(r"error_feedback_kernelILi([01])ELb([01])E",
                           m.group(1))
            if ef is not None:         # EF: <codec, vector?>
                label = (f" error_feedback_kernel<"
                         f"{('bf16', 'int8')[int(ef.group(1))]},"
                         f"{('scalar', 'vec')[int(ef.group(2))]}>")
            elif ring is not None:     # B3/B4's ring: <in->out,levels>
                io = {"f": "f32", "t": "bf16", "a": "int8"}
                label = (f" ring_pass_kernel<{io[ring.group(1)]}->"
                         f"{io[ring.group(2)]},{ring.group(3)}>")
            elif merge is not None:    # B7's and B8's merge: <dtype>
                io = "f32" if merge.group(1) == "f" else "bf16"
                label = f" merge_kernel<{io}>"
            elif mla is not None:      # B8: f32 (simt) and bf16 (mma)
                label = f" {mla.group(1)}"
            elif ops_k is not None:    # B3-B6: <in->out,> template numbers
                io = {"f": "f32", "t": "bf16"}
                types = [f"{io[ops_k.group(2)]}->{io[ops_k.group(3)]}"] \
                    if ops_k.group(2) else []
                label = " {}<{}>".format(ops_k.group(1), ",".join(
                    types + re.findall(r"L[ib](\d+)E", m.group(1))))
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


def decode_timings(torch) -> int:
    """``--decode-timings SRC``: B7 and B8 at the serve, wide-table and
    long-context shapes and B7's length sweep, with the kernels of the checkout whose
    ``src/`` is first on the path.  Only the kernel wrappers and ref.py
    are called, so an older checkout's kernels are timed alike."""
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.models.registry import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    gemma, ds = get_config("gemma2-2b"), ds_config()
    res = {"b7": phase_timing(torch, ops, ref, gemma),
           "b7_long": phase_long_timing(torch, ops, ref, gemma),
           "b7_wide": phase_wide_timing(torch, ops, ref, gemma),
           "b7_sweep": b7_length_sweep(torch, ops, gemma),
           "b8": phase_mla_timing(torch, ops, ref, ds),
           "b8_long": phase_mla_long_timing(torch, ops, ref, ds),
           "b8_wide": phase_mla_wide_timing(torch, ops, ref, ds)}
    print(json.dumps({"decode_timings": ops.__file__, **res}))
    print(_smi())
    return 0


def tree_timings(torch) -> int:
    """``--tree-timings SRC``: B3 (f32 rows, and bf16 rows into f32) and
    B4 at the timed shape beside ``torch.sum`` and the bound
    (``phase_tree_timing``), with the kernels of the checkout whose
    ``src/`` is first on the path.  Only the kernel wrappers, ``encode_rows``
    and ref.py are called, so an older checkout's kernels are timed
    alike."""
    from repro_torch.kernels.tree_reduce import ops as tops, ref as tref
    res = phase_tree_timing(torch, tops, tref)
    print(json.dumps({"tree_timings": tops.__file__, **res}))
    print(_smi())
    return 0


def remat_timings(torch) -> int:
    """``--remat-timings SRC``: the train runs of phases 5b and 5d
    (gemma2-2b at 8 layers and qwen2.5-3b at 10, world 4, all auto, 3
    steps) with the training remat off (``set_remat("none")``: every
    activation kept, the port before slice 11) and on (``"block"``, the
    reference's default), in the order none, block, block, none; prints
    steps 1-2's host time and each run's peak memory."""
    import statistics
    from repro_torch.kernels import build
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as T
    build.build(["tree_reduce"])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.empty(0, device=dev)    # the allocator's stats need a live device
    res = []
    runs = (("gemma2-2b", train_config(), TRAIN_ARGS + TRAIN_AUTO),
            ("qwen2.5-3b", qwen_config(QWEN_TRAIN_CUT), QWEN_TRAIN_ARGS))
    try:
        for name, cfg, argv in runs:
            for mode in ("none", "block", "block", "none"):
                T.set_remat(mode)
                torch.cuda.reset_peak_memory_stats(dev)
                out = train_cli.run(cfg, train_cli.parse_args(argv))
                secs = [h["sec"] for h in out["history"][1:]]
                peak = torch.cuda.max_memory_allocated(dev)
                row = dict(arch=name, layers=cfg.num_layers, remat=mode,
                           step_s=secs, mean_s=statistics.mean(secs),
                           peak_gib=peak / 2**30)
                print(f"  {name} ({cfg.num_layers} layers), remat {mode!r}: "
                      f"steps 1-2 {secs} s, peak {peak / 2**30:.2f} GiB")
                res.append(row)
                del out
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        T.set_remat("block")
    print(json.dumps({"remat_timings": res}))
    print(_smi())
    return 0


CALIBRATE_RUNS = 4


def calibrate_runs(torch) -> int:
    """``--calibrate-runs SRC``: phase 5k ``CALIBRATE_RUNS`` times on
    musicgen-medium at 2 layers, each with its own fit; every codec bucket
    of each run's plan is held to the plain versions as in the main run.
    Prints one JSON line of the fits, plans and launches."""
    import contextlib
    import io
    import re
    from repro_torch.kernels import build
    from repro_torch.kernels.tree_reduce import ops as tops, ref as tref
    from repro_torch.optim.compression import Bf16Codec, Int8Codec
    build.build(["tree_reduce"])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.empty(0, device=dev)
    codecs = {"bf16": Bf16Codec(), "int8": Int8Codec()}
    cfg = cut_config("musicgen-medium", CAL_TRAIN_CUT)
    res = []
    for i in range(CALIBRATE_RUNS):
        print(f"[5k] run {i}", flush=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            launches = phase_calibrate(torch, tops, tref, codecs, cfg, dev)
        text = buf.getvalue()
        res.append(dict(
            fits=re.findall(r"fitted fitted-\S+: (.*) \(12 samples\)",
                            text),
            plan=re.findall(r"^superstep: (.*)$", text, re.M)[:1],
            launches=launches,
            held=text.count("through the kernels is bit-identical")))
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"calibrate_runs": res}))
    print(_smi())
    return 0


def ef_timings(torch) -> int:
    """``--ef-timings SRC``: EF's kernel held to the eager sequence
    (``phase_ef_kernels``), then both timed at the int8 cell's largest
    bucket (``phase_ef_timing``), with the kernel of the checkout whose
    ``src/`` is first on the path."""
    from repro_torch.kernels import build
    from repro_torch.kernels.codec import ops as cops, ref as cref
    from repro_torch.optim.compression import Bf16Codec, Int8Codec
    codecs = {"bf16": Bf16Codec(), "int8": Int8Codec()}
    build.build(["error_feedback"])
    for line in _ptxas_summary(build.build_log("error_feedback")):
        print(f"  ptxas error_feedback{line}")
    made = phase_ef_kernels(torch, cops, cref, codecs,
                            torch.device("cuda", 0))
    full = phase_ef_bucket(torch, cops, cref, codecs, torch.device("cuda", 0))
    res = phase_ef_timing(torch, cops, cref, codecs)
    print(json.dumps({"ef_timings": cops.__file__, "launches": made,
                      "bucket_check": full, **res}))
    print(_smi())
    return 0


TIMINGS = {"--decode-timings": decode_timings,
           "--ef-timings": ef_timings,
           "--tree-timings": tree_timings,
           "--remat-timings": remat_timings,
           "--calibrate-runs": calibrate_runs}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    timings = TIMINGS.get(argv[0]) if argv else None
    src = Path(argv[1]).resolve() if timings else SRC
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found (run from the "
              "repo root checkout)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    if timings:
        return timings(torch)
    from repro_torch.kernels import build
    from repro_torch.kernels.codec import ops as cops, ref as cref
    from repro_torch.kernels.flash_attention import ops as fops, ref as fref
    from repro_torch.kernels.gemm import ops as gops, ref as gref
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.kernels.tree_reduce import ops as tops, ref as tref
    from repro_torch.models.registry import get_config
    from repro_torch.optim.compression import Bf16Codec, Int8Codec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    print(f"[1] build  (card: {smi})", flush=True)
    t_start = t0 = time.perf_counter()
    libs = build.build()
    print(f"  built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for name in libs:
        for line in _ptxas_summary(build.build_log(name)):
            print(f"  ptxas {name}{line}")

    dev = torch.device("cuda", 0)
    codecs = {"bf16": Bf16Codec(), "int8": Int8Codec()}
    print("[2] kernels vs plain versions", flush=True)
    t0 = time.perf_counter()
    tree_err = phase_tree_kernels(torch, tops, tref, dev)
    phase_tree_guards(torch, tops, dev)
    tree_timing = phase_tree_timing(torch, tops, tref)
    gemm_err, gemm_rel = phase_gemm_kernels(torch, gops, gref, dev)
    gemm_timing = phase_gemm_timing(torch, gops, gref)
    flash_err, flash_rel = phase_flash_kernels(torch, fops, fref, dev)
    pad_err, pad_rel = phase_flash_padding(torch, fops, fref, dev)
    flash_err, flash_rel = max(flash_err, pad_err), max(flash_rel, pad_rel)
    flash_timing = phase_flash_timing(torch, fops, fref)
    print(f"  launches by path so far: B6 {gops.PATH_LAUNCHES}, B5 "
          f"{fops.PATH_LAUNCHES}")
    ops_launches, ops_paths = phase_kernel_ops(torch, tops, tref, gops, fops,
                                               dev)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  B3-B6 checks, timings and ops path: "
          f"{time.perf_counter() - t0:.1f} s")
    max_err, max_rel = phase_kernels(torch, ops, ref, dev)
    gemma = get_config("gemma2-2b")
    timing = phase_timing(torch, ops, ref, gemma)
    timing["long_context"] = phase_long_timing(torch, ops, ref, gemma)
    timing["wide_table"] = phase_wide_timing(torch, ops, ref, gemma)
    timing["sweep"] = b7_length_sweep(torch, ops, gemma)
    codec_err = phase_codec_kernels(torch, tops, tref, codecs, dev)
    cfg8 = train_config()
    plan = train_engine(cfg8, "int8")
    hop = plan.world * max(b.length for b in plan.buckets) // 2
    codec_timing = phase_codec_timing(torch, tops, tref, codecs, hop)
    gc.collect()
    torch.cuda.empty_cache()
    ef_made = phase_ef_kernels(torch, cops, cref, codecs, dev)
    ef_full = phase_ef_bucket(torch, cops, cref, codecs, dev)
    ef_timing = phase_ef_timing(torch, cops, cref, codecs)
    ds = ds_config()
    mla_err, mla_rel = phase_mla_kernels(torch, ops, ref, dev)
    mla_timing = phase_mla_timing(torch, ops, ref, ds)
    mla_timing["long_context"] = phase_mla_long_timing(torch, ops, ref, ds)
    mla_timing["wide_table"] = phase_mla_wide_timing(torch, ops, ref, ds)
    phase_guards(torch, ops, dev)

    print("[2b] the paper's Table 1 from the port's simulator (host)",
          flush=True)
    phase_table1()
    print("[2c] every schedule's lowering on the card", flush=True)
    t0 = time.perf_counter()
    phase_schedules(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  schedules phase: {time.perf_counter() - t0:.1f} s")

    print("[3] serve gemma2-2b at full width", flush=True)
    paged3 = {}
    launches, merges = phase_serve(torch, ops, gemma, SERVE_ARGS, out=paged3)
    gc.collect()
    torch.cuda.empty_cache()
    print("[3c] serve gemma2-2b at full width over the contiguous cache",
          flush=True)
    t0 = time.perf_counter()
    cont = {}
    contig_launches, _ = phase_serve(torch, ops, gemma, CONTIG_SERVE_ARGS,
                                     out=cont)
    print(f"  phase 3c: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    print("[3w] the wave oracle (--mode wave) on the same requests",
          flush=True)
    wave_same = phase_wave(torch, ops, gemma, CONTIG_SERVE_ARGS, cont,
                           WAVE_LOGIT_ATOL)
    gc.collect()
    torch.cuda.empty_cache()

    print("[4] one decode step: kernel vs gather lowering, and over the "
          "contiguous cache", flush=True)
    t0 = time.perf_counter()
    phase_decode_step(torch, gemma, dev, LOGIT_ATOL, contiguous=LOGIT_ATOL)
    print(f"  phase 4: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    print(f"[4m] serve gemma2-2b at full width with the slot batch sharded "
          f"over a mesh of {MESH_DEVICES} (--devices {MESH_DEVICES}): paged "
          "and contiguous; one decode step with the serving policy",
          flush=True)
    t0 = time.perf_counter()
    mesh_launches = phase_mesh_serve(
        torch, ops, gemma,
        [(SERVE_ARGS, paged3, (launches, merges)),
         (CONTIG_SERVE_ARGS, cont, (contig_launches, 0))],
        max_slots_cfg=train_config(TRAIN_FORCED_CUT))
    del paged3
    gc.collect()
    torch.cuda.empty_cache()
    phase_mesh_decode(torch, gemma, dev)
    print(f"  phase 4m: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    soak_cfg = train_config(SERVE_SOAK_CUT)
    print(f"[3s] the serve soak on gemma2-2b ({soak_cfg.num_layers} of 26 "
          "layers)", flush=True)
    soak_launches = phase_serve_soak(torch, ops, soak_cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()

    qwen = qwen_config()
    print(f"[3q] serve qwen2.5-3b at full width ({qwen.num_layers} layers); "
          "one decode step: kernel vs gather lowering", flush=True)
    q_launches, q_merges = phase_serve(torch, ops, qwen, QWEN_SERVE_ARGS)
    phase_decode_step(torch, qwen, dev, QWEN_LOGIT_ATOL)
    gc.collect()
    torch.cuda.empty_cache()

    xl = cut_config("xlstm-1.3b", XLSTM_SERVE_CUT)
    print(f"[3x] serve xlstm-1.3b at published widths ({xl.num_layers} of 48 "
          "layers, recurrent rows): continuous, wave, one decode step",
          flush=True)
    t0 = time.perf_counter()
    xcont = {}
    phase_serve(torch, ops, xl, XLSTM_SERVE_ARGS, out=xcont)
    gc.collect()
    torch.cuda.empty_cache()
    xl_same = phase_wave(torch, ops, xl, XLSTM_SERVE_ARGS, xcont,
                         XLSTM_WAVE_LOGIT_ATOL)
    gc.collect()
    torch.cuda.empty_cache()
    phase_recurrent_step(torch, xl, dev)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 3x: {time.perf_counter() - t0:.1f} s")

    print(f"[5] train gemma2-2b ({cfg8.num_layers} of 26 layers) at world "
          f"{plan.world}", flush=True)
    first_losses, ef_launches = {}, {}
    train_launches = phase_train(torch, tops, cfg8, first_losses,
                                 ef_launches)
    phase_train_profile(torch, cfg8, tref, codecs)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[5b] train gemma2-2b ({cfg8.num_layers} of 26 layers) at world "
          f"{plan.world}, every choice left to the autotuner", flush=True)
    auto_launches = phase_train_auto(torch, tops, tref, codecs, cfg8,
                                     first_losses["int8"])
    gc.collect()
    torch.cuda.empty_cache()
    cfg2 = train_config(TRAIN_FORCED_CUT)
    print(f"[5c] train gemma2-2b ({cfg2.num_layers} of 26 layers) with a "
          f"forced non-fractal schedule", flush=True)
    phase_train_forced(torch, tops, cfg2)
    gc.collect()
    torch.cuda.empty_cache()

    print(f"[5l] train gemma2-2b at full width ({gemma.num_layers} layers, "
          "no cut) with the GSPMD step (--schedule xla --devices 4)",
          flush=True)
    t0 = time.perf_counter()
    phase_gspmd_train(torch, gemma, cfg8, first_losses["int8"])
    print(f"  phase 5l: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    eq_cfg = train_config(EQUIV_CUT)
    print(f"[5m] Tier A (GSPMD) against Tier B (fractal) on the card: "
          f"gemma2-2b ({eq_cfg.num_layers} layers), world 4, "
          f"{EQUIV_STEPS} steps each", flush=True)
    t0 = time.perf_counter()
    phase_tier_equivalence(torch, eq_cfg, dev)
    print(f"  phase 5m: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[9] the dry run: the CLI on {len(DRYRUN_CELLS)} production cells "
          f"(meta), then gemma2-2b ({gemma.num_layers} layers) traced on "
          f"meta against one step on the card, remat "
          f"{' and '.join(DRYRUN_REMATS)}", flush=True)
    t0 = time.perf_counter()
    phase_dryrun_cli(torch)
    phase_dryrun_card(torch, gemma, dev)
    print(f"  phase 9: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    qwen10 = qwen_config(QWEN_TRAIN_CUT)
    print(f"[5d] the README's command at full width: train qwen2.5-3b "
          f"({qwen10.num_layers} of 36 layers) at world 4, every choice "
          "left to the autotuner", flush=True)
    qwen_launches = phase_train_auto(torch, tops, tref, codecs, qwen10, None,
                                     argv=QWEN_TRAIN_ARGS)
    gc.collect()
    torch.cuda.empty_cache()
    soak_cfg = qwen_config(SOAK_CUT)
    print(f"[5e] the fault-injected train soak on qwen2.5-3b "
          f"({soak_cfg.num_layers} of 36 layers)", flush=True)
    phase_train_soak(torch, soak_cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()

    xl8 = cut_config("xlstm-1.3b", XLSTM_TRAIN_CUT)
    print(f"[5f] train xlstm-1.3b ({xl8.num_layers} of 48 layers) at world "
          "4, every choice left to the autotuner", flush=True)
    t0 = time.perf_counter()
    xlstm_launches = phase_train_xlstm(torch, tops, tref, codecs, xl8)
    print(f"  phase 5f: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    for tag, name, cut, bounds in (
            ("5g", "jamba-v0.1-52b", JAMBA_GRAD_CUT, JAMBA_GRAD_BOUNDS),
            ("5h", "deepseek-v3-671b", DS_GRAD_CUT, DS_GRAD_BOUNDS)):
        gcfg = cut_config(name, cut)
        print(f"[{tag}] {name} gradients at published widths "
              f"({gcfg.num_layers} layer(s)): bf16 vs f32", flush=True)
        t0 = time.perf_counter()
        phase_grads(torch, gcfg, dev, bounds, tag)
        print(f"  phase {tag}: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

    # the gemma phases' params, caches and train state are gone; hand their
    # cached blocks back before DeepSeek's 54.6 GB of weights
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[6] serve DeepSeek-V3 at full width ({ds.num_layers} of 61 "
          f"layers)", flush=True)
    mla_launches, mla_merges = phase_serve(torch, ops, ds, DS_SERVE_ARGS)
    gc.collect()
    torch.cuda.empty_cache()

    print("[7] one DeepSeek decode step: B8 vs gather lowering, and over "
          "the contiguous latent cache", flush=True)
    phase_decode_step(torch, ds, dev, DS_LOGIT_ATOL, contiguous=DS_LOGIT_ATOL)
    # DeepSeek's 54.6 GB are gone before Jamba's 52.1 GB
    gc.collect()
    torch.cuda.empty_cache()

    jamba = jamba_config()
    print(f"[8] serve jamba-v0.1-52b at published widths ({jamba.num_layers} "
          "of 32 layers): paged with scarce recurrent rows, contiguous, one "
          "decode step", flush=True)
    t0 = time.perf_counter()
    j_launches, j_merges = phase_serve(torch, ops, jamba, JAMBA_PAGED_ARGS)
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve(torch, ops, jamba, JAMBA_CONTIG_ARGS)
    gc.collect()
    torch.cuda.empty_cache()
    phase_decode_step(torch, jamba, dev, JAMBA_LOGIT_ATOL,
                      contiguous=JAMBA_LOGIT_ATOL)
    print(f"  phase 8: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    frontend_launches = {}
    for tag, name, cut, argv in (
            ("5i", "paligemma-3b", PALI_TRAIN_CUT, PALI_TRAIN_ARGS),
            ("5j", "musicgen-medium", MUSICGEN_TRAIN_CUT,
             MUSICGEN_TRAIN_ARGS)):
        fcfg = cut_config(name, cut)
        print(f"[{tag}] train {name} ({fcfg.num_layers} layers) at world 4 "
              "with its frontend stub, every choice left to the autotuner",
              flush=True)
        t0 = time.perf_counter()
        frontend_launches[tag] = phase_train_frontend(
            torch, tops, tref, codecs, fcfg, argv)
        print(f"  phase {tag}: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    for tag, name in (("3p", "paligemma-3b"), ("3m", "musicgen-medium")):
        print(f"[{tag}] decode {name} at full width (model-level prefill + "
              "greedy decode steps over the contiguous cache)", flush=True)
        t0 = time.perf_counter()
        phase_frontend_decode(torch, get_config(name), dev)
        print(f"  phase {tag}: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    cal_cfg = cut_config("musicgen-medium", CAL_TRAIN_CUT)
    print("[5k] fit the link on the card, then --calibrate training and "
          "its resume", flush=True)
    t0 = time.perf_counter()
    cal_launches = phase_calibrate(torch, tops, tref, codecs, cal_cfg,
                                   dev)
    print(f"  phase 5k: {time.perf_counter() - t0:.1f} s")

    tr = "src/repro/kernels/tree_reduce/kernel.py"
    kernels = [dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/paged_attention/csrc/"
               "paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:90",
        launches=launches, merge_launches=merges,
        qwen_launches=q_launches, qwen_merge_launches=q_merges,
        contiguous_launches=contig_launches, soak_launches=soak_launches,
        mesh_launches=mesh_launches[0][0],
        mesh_merge_launches=mesh_launches[0][1],
        mesh_contiguous_launches=mesh_launches[1][0],
        jamba_launches=j_launches, jamba_merge_launches=j_merges,
        wave_identical=wave_same, xlstm_wave_identical=xl_same,
        shapes=KERNEL_SHAPES, max_abs_err=max_err, max_err=max_err,
        max_row_rel_err=max_rel, **timing)]
    for name, codec, line in (("decode_add_bf16", "bf16", 119),
                              ("decode_add_int8", "int8", 140)):
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/tree_reduce/csrc/tree_reduce.cu",
            replaces=f"{tr}:{line}", launches=train_launches[codec],
            auto_launches=auto_launches[codec],
            qwen_auto_launches=qwen_launches[codec],
            xlstm_launches=xlstm_launches[codec],
            paligemma_launches=frontend_launches["5i"][codec],
            musicgen_launches=frontend_launches["5j"][codec],
            calibrate_launches=cal_launches[codec],
            max_abs_err=codec_err[codec], elements=hop,
            **codec_timing[codec]))
    kernels.append(dict(
        name="error_feedback", route="cuda",
        source="src/repro_torch/kernels/codec/csrc/error_feedback.cu",
        replaces=None, launches=ef_launches, check_launches=ef_made,
        bucket_check=ef_full, bf16=ef_timing["bf16"],
        int8=ef_timing["int8"]))
    kernels.append(dict(
        name="paged_mla_attention", route="cuda",
        source="src/repro_torch/kernels/paged_attention/csrc/"
               "paged_mla_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:174",
        launches=mla_launches, merge_launches=mla_merges,
        max_abs_err=mla_err,
        max_row_rel_err=mla_rel, **mla_timing))
    kernels.append(dict(
        name="tree_reduce", route="cuda",
        source="src/repro_torch/kernels/tree_reduce/csrc/tree_sum.cu",
        replaces=f"{tr}:38", launches=ops_launches["tree_reduce"],
        paths=ops_paths["tree_reduce"], max_abs_err=tree_err["tree_reduce"],
        shape=[TREE_TIME_N, TREE_TIME_D], **tree_timing["f32"],
        bf16_rows={k: tree_timing["bf16"][k] for k in
                   ("ms", "plain_ms", "library_ms", "bound_ms")}))
    kernels.append(dict(
        name="int8_tree_reduce", route="cuda",
        source="src/repro_torch/kernels/tree_reduce/csrc/tree_sum.cu",
        replaces=f"{tr}:85", launches=ops_launches["int8_tree_reduce"],
        paths=ops_paths["int8_tree_reduce"],
        max_abs_err=tree_err["int8_tree_reduce"],
        shape=[TREE_TIME_N, TREE_TIME_D // 128, 128], **tree_timing["int8"]))
    kernels.append(dict(
        name="gemm", route="cuda",
        source="src/repro_torch/kernels/gemm/csrc/gemm.cu",
        replaces="src/repro/kernels/gemm/kernel.py:37",
        launches=ops_launches["gemm"], paths=ops_paths["gemm"],
        max_abs_err=gemm_err, max_row_rel_err=gemm_rel, **gemm_timing))
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:85",
        launches=ops_launches["flash_attention"],
        paths=ops_paths["flash_attention"], max_abs_err=flash_err,
        max_row_rel_err=flash_rel, **flash_timing[0],
        no_softcap={k: flash_timing[1][k] for k in
                    ("ms", "plain_ms", "library_ms", "bound_ms")},
        local_8192=flash_timing[2]))
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
