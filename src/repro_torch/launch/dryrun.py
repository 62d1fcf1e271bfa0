"""Multi-pod dry run: trace every (arch × shape × mesh) cell (port of
``repro/launch/dryrun.py``).

For each cell this driver builds the real step, as the reference does
(``make_gspmd_train_step`` for train shapes, ``make_prefill_step`` /
``make_decode_step`` for inference shapes), on the reference's v5e
production mesh ((16, 16), or (2, 16, 16) across two pods) placed on the
``meta`` device, and traces one call of it over ``meta`` inputs at the
production shapes (``launch/specs.py``) through
``hlo_analysis.analyze_program``: every aten op the step dispatches, with
no storage.  The record goes to
``build/dryrun/<mesh>/<arch>__<shape>.json``.

What the record holds, against the reference's (which lowers and
compiles for the mesh with XLA):

  * ``memory.argument_size_in_bytes`` / ``output_size_in_bytes``: per
    device, exactly, from the specs: each input (output) leaf's block
    under its ``PartitionSpec`` on the mesh, as ``memory_analysis()``
    reports them (``cell_bytes``: arguments the program never reads left
    out, as jax's ``jit`` drops them; XLA adds an 8-byte pointer per
    leaf of its output tuple, ``output_leaves``, to its output size);
  * ``hlo_stats``: the traced program's counts.  The traced program is
    the GLOBAL one (on one card the GSPMD program is the unsharded one),
    so its FLOPs, HBM bytes and transcendentals are split evenly over
    the mesh's devices (``"split": "even"``); ``global`` keeps the
    totals and the peak of live storage.  A sharded program does more
    than its even share where a spec drops an axis and XLA replicates
    the work (gemma2's 8 heads on the 16-way "model" axis: attention
    runs whole on each of the 16 devices of a data row).  One card
    cannot see that compute, and the record does not estimate it;
  * ``roofline``: those per-device counts priced on the H100 SXM's
    data-sheet peaks (``hlo_analysis.H100_SXM``), with no collective
    term: the unsharded program runs none;
  * ``params_*``, ``model_flops_*``, ``useful_flops_ratio`` and
    ``roofline_fraction`` as the reference computes them; the
    reference's ``lower_s`` and ``compile_s`` are one ``trace_s``.

The program does not depend on the mesh, so one trace prices a cell on
both meshes: ``main`` hands the first mesh's ``Trace`` to the second
(``trace_reused`` in its record).

Usage (no device needed: the trace runs on ``meta``):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --cell gemma2-2b:train_4k --mesh single [--opt remat=dots ...]
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.configs.base import SHAPES, SHAPE_BY_NAME, cell_applicable
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import act_sharding as ACT
from repro_torch.models import layers as LYR
from repro_torch.models import registry
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime import trainer
from repro_torch.weights import reference_leaves

RESULTS = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# bf16 optimizer moments above this size, else f32 (the reference's)
BF16_MOMENT_THRESHOLD = 30e9


def _mesh(kind: str):
    return make_production_mesh(multi_pod=(kind == "multi"), device="meta")


def _adamw_cfg(cfg):
    n = registry.count_params(cfg)
    state = torch.bfloat16 if n > BF16_MOMENT_THRESHOLD else torch.float32
    return adamw.AdamWConfig(state_dtype=state)


@contextlib.contextmanager
def levers(opts: dict):
    """The hillclimb levers of ``opts`` (``remat``, ``loss_chunk``,
    ``query_chunk``, ``seq_shard``) set as the reference sets them, and
    every module global they touch (and the activation policy the step
    builders set) restored on exit."""
    saved = (T._REMAT, T.LOSS_CHUNK, LYR.QUERY_CHUNK, ACT.SEQ_SHARD,
             ACT._POLICY, ACT.SERVE_EP, ACT.LAST_SPEC)
    try:
        T.set_remat(opts.get("remat", "block"))
        T.LOSS_CHUNK = int(opts.get("loss_chunk", 512))
        LYR.QUERY_CHUNK = int(opts.get("query_chunk", 512))
        ACT.SEQ_SHARD = opts.get("seq_shard", "0") in ("1", "true")
        yield
    finally:
        (T._REMAT, T.LOSS_CHUNK, LYR.QUERY_CHUNK, ACT.SEQ_SHARD,
         ACT._POLICY, ACT.SERVE_EP, ACT.LAST_SPEC) = saved


# ---------------------------------------------------------------------------
# per-device bytes of a tree under its specs
# ---------------------------------------------------------------------------


def block_bytes(shape, dtype, spec, mesh) -> int:
    """Bytes of the block of a ``shape`` array one device holds under
    ``spec`` on ``mesh``."""
    SH.check_spec(tuple(shape), mesh, spec)
    n = 1
    for dim, axes in zip(shape, SH._dim_axes(SH.P(*spec), len(shape))):
        n *= dim // SH.axis_size(mesh, axes)
    return n * torch.empty((), dtype=dtype).element_size()


def _leaves_bytes(leaves, specs, mesh, keep=lambda leaf: True) -> int:
    return sum(block_bytes(leaf.shape, leaf.dtype, specs[leaf.path], mesh)
               for leaf in leaves if keep(leaf))


def _whole_bytes(tree) -> int:
    """Bytes of every tensor of ``tree``, whole (a replicated output); a
    Python int counts as the int32 scalar the reference's jit returns."""
    if isinstance(tree, int):
        return 4
    return sum(t.numel() * t.element_size()
               for t in H._walk_tensors(tree, []))


def _dp_rows(mesh, batch: int):
    """The batch rows' axes of the serving steps' token input (the
    reference's guard: none when the FSDP axes do not divide the batch)."""
    dp = SH.fsdp_axes(mesh)
    return dp if batch % SH.axis_size(mesh, dp) == 0 else ()


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def build_step(cfg, shape, mesh):
    """``(step, specs)``: the cell's step on ``mesh`` and the specs of its
    inputs (``params``, and ``batch`` or ``cache``)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        step, (pspec, _, bspec) = trainer.make_gspmd_train_step(
            cfg, mesh, _adamw_cfg(cfg))
        return step, {"params": pspec, "batch": bspec}
    if shape.kind == "prefill":
        step, (pspec, cspec) = trainer.make_prefill_step(
            cfg, mesh, B, S + cfg.frontend_tokens)
    else:
        step, (pspec, cspec) = trainer.make_decode_step(cfg, mesh, B, S)
    return step, {"params": pspec, "cache": cspec}


def build_args(cfg, shape) -> tuple:
    """The cell's step arguments on ``meta``."""
    params = SP.params_specs(cfg)
    if shape.kind == "train":
        state = trainer.GSPMDTrainState(
            params, adamw.init(params, _adamw_cfg(cfg)), cfg)
        return state, SP.batch_specs(cfg, shape)
    sp = SP.input_specs(cfg, shape)
    if shape.kind == "prefill":
        return (params, sp["tokens"], sp["cache"]) + (
            (sp["frontend"],) if cfg.frontend else ())
    return params, sp["token"], sp["cache"], sp["offset"]


def cell_bytes(cfg, shape, mesh, specs, args, out, read):
    """``(argument bytes, output bytes, output leaves)`` per device on
    ``mesh``: each leaf's block under its spec.  Arguments the traced
    program never read (``read``: ``ProgramCounter.read``) are left out,
    as jax's ``jit`` drops unused arguments (DeepSeek's MTP modules when
    serving, a prefill's caches, which it overwrites whole, xLSTM's decode
    offset).  Outputs the reference leaves to the compiler take the
    layout it gives them: the logits their ``act_sharding.logits``
    constraint's, the train metrics whole."""
    used = lambda t: H.storage_key(t) in read
    used_leaf = lambda leaf: any(map(used, leaf.parts))
    pspec = specs["params"]
    if shape.kind == "train":
        state, batch = args
        params = lambda tree: reference_leaves(tree, cfg)
        state_leaves = (params(state.params) + params(state.opt.mu)
                        + params(state.opt.nu))
        step_b = block_bytes((), torch.int32, SH.P(), mesh)
        arg = (_leaves_bytes(state_leaves, pspec, mesh, used_leaf)
               + (step_b if used(state.opt.step) else 0)
               + sum(block_bytes(v.shape, v.dtype, specs["batch"][k], mesh)
                     for k, v in batch.items() if used(v)))
        metrics = out[1]
        return (arg, _leaves_bytes(state_leaves, pspec, mesh) + step_b
                + _whole_bytes(metrics),
                len(state_leaves) + 1 + len(metrics))
    params, tokens, cache, *rest = args
    rows = _dp_rows(mesh, shape.global_batch)
    cache_leaves = SH.cache_leaves(cache, cfg)
    arg = (_leaves_bytes(reference_leaves(params, cfg), pspec, mesh,
                         used_leaf)
           + _leaves_bytes(cache_leaves, specs["cache"], mesh, used_leaf))
    if used(tokens):
        arg += block_bytes(tokens.shape, tokens.dtype,
                           SH.P(rows or None, None), mesh)
    for extra in rest:                  # frontend (prefill) / offset (decode)
        if used(extra):
            spec = SH.P(rows, None, None) if extra.ndim == 3 else SH.P()
            arg += block_bytes(extra.shape, extra.dtype, spec, mesh)
    logits = out[0]
    out_b = (block_bytes(logits.shape, logits.dtype,
                         ACT.fixed_spec(logits.shape,
                                        (SH.fsdp_axes(mesh), None, "model"),
                                        mesh), mesh)
             + _leaves_bytes(cache_leaves, specs["cache"], mesh)
             + sum(_whole_bytes(o) for o in out[2:]))
    return arg, out_b, 1 + len(cache_leaves) + len(out[2:])


class Trace(NamedTuple):
    """One call of a cell's program traced on ``meta``: its counts, the
    seconds the trace took, the inputs, the outputs, and the storage keys
    of the inputs it read (``ProgramCounter.read``)."""

    stats: H.ProgramStats
    trace_s: float
    args: tuple
    out: object
    read: set


def _trace(cfg, shape, mesh):
    """``(Trace, specs)``: the cell's step built on ``mesh`` and traced
    once, and the specs of its inputs there."""
    step, specs = build_step(cfg, shape, mesh)
    args = build_args(cfg, shape)
    # the train step swaps its state's AdamW tuple; keep the inputs' own
    inputs = tuple(copy.copy(a) if dataclasses.is_dataclass(a) else a
                   for a in args)
    t0 = time.perf_counter()
    with H.ProgramCounter(args) as pc:
        out = step(*args)
    trace_s = time.perf_counter() - t0
    return Trace(pc.stats, trace_s, inputs, out, pc.read), specs


def lower_cell(arch: str, shape_name: str, mesh_kind: str,
               opts: dict | None = None, trace: Trace | None = None):
    """Build and trace one cell; returns ``(record, trace)`` (the trace
    None for a skipped cell).  ``trace``, the same cell's under the same
    ``opts`` on another mesh, is priced instead of tracing again."""
    opts = opts or {}
    cfg = registry.get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}, None
    reused = trace is not None
    with levers(opts):
        mesh = _mesh(mesh_kind)
        if reused:
            _, specs = build_step(cfg, shape, mesh)
        else:
            trace, specs = _trace(cfg, shape, mesh)
        arg_b, out_b, out_leaves = cell_bytes(cfg, shape, mesh, specs,
                                              trace.args, trace.out,
                                              trace.read)
    st, trace_s = trace.stats, trace.trace_s
    devices = int(math.prod(mesh.devices.shape))
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "status": "ok", "trace_s": round(trace_s, 1),
              "trace_reused": reused, "devices": devices, "opts": opts,
              "split": "even", "peaks": H.H100_SXM.name}
    record["memory"] = {"argument_size_in_bytes": arg_b,
                        "output_size_in_bytes": out_b,
                        "output_leaves": out_leaves}

    per = H.ProgramStats(
        flops=st.flops / devices, hbm_bytes=st.hbm_bytes / devices,
        dot_count=st.dot_count, instr_count=st.instr_count,
        transcendentals=st.transcendentals / devices)
    record["hlo_stats"] = per.as_dict()
    for k in ("peak_live_bytes", "input_bytes"):
        del record["hlo_stats"][k]
    record["global"] = {"flops": st.flops, "hbm_bytes": st.hbm_bytes,
                        "transcendentals": st.transcendentals,
                        "peak_live_bytes": st.peak_live_bytes,
                        "input_bytes": st.input_bytes}
    record["roofline"] = H.roofline_terms(per)

    # ---- model flops (useful-compute ratio) ----
    n_total = registry.count_params(cfg)
    n_active = registry.count_params(cfg, active_only=True)
    record["params_total"] = n_total
    record["params_active"] = n_active
    toks = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                 else 1)
    mult = 6 if shape.kind == "train" else 2
    record["model_flops_global"] = float(mult * n_active * toks)
    record["model_flops_per_device"] = (record["model_flops_global"]
                                        / devices)
    if per.flops:
        record["useful_flops_ratio"] = round(
            record["model_flops_per_device"] / per.flops, 4)
        rf = record["roofline"]
        if rf.get("bound_s"):
            record["roofline_fraction"] = round(
                (record["model_flops_per_device"] / H.H100_SXM.flops)
                / rf["bound_s"], 4)
    return record, trace


def cell_path(arch, shape_name, mesh_kind, tag="") -> Path:
    d = RESULTS / mesh_kind
    d.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return d / f"{arch}__{shape_name}{suffix}.json"


def run_cell(arch, shape_name, mesh_kind, opts=None, tag="", force=False,
             trace=None):
    """``(record, trace)`` of one cell, its record written to
    ``cell_path`` (read back, with no trace, if it is there and not
    ``force``); ``trace`` as for ``lower_cell``."""
    out = cell_path(arch, shape_name, mesh_kind, tag)
    if out.exists() and not force:
        rec = json.loads(out.read_text())
        print(f"cached  {arch:24s} {shape_name:12s} {mesh_kind:6s} "
              f"{rec.get('status')}")
        return rec, None
    try:
        rec, trace = lower_cell(arch, shape_name, mesh_kind, opts, trace)
    except Exception as e:
        trace = None
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "error", "error": f"{type(e).__name__}: {e}"[:1500],
               "trace": traceback.format_exc()[-2000:], "opts": opts or {}}
    out.write_text(json.dumps(rec, indent=2))
    status = rec.get("status")
    extra = ""
    if status == "ok":
        extra = (f"trace={rec['trace_s']:.1f}s"
                 f"{' (reused)' if rec['trace_reused'] else ''} "
                 f"dom={rec['roofline']['dominant']}")
    print(f"{status:7s} {arch:24s} {shape_name:12s} {mesh_kind:6s} {extra}",
          flush=True)
    return rec, trace


def parse_opts(pairs):
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--cell", type=str, default=None,
                    help="arch:shape")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--opt", action="append", default=[],
                    help="k=v hillclimb option (e.g. remat=dots)")
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = registry.ARCH_IDS
    shapes = [s.name for s in SHAPES]
    if args.cell:
        a, _, s = args.cell.partition(":")
        archs, shapes = [a], [s]
    if args.arch:
        archs = [args.arch]
    if args.shape:
        shapes = [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    opts = parse_opts(args.opt)
    results = []
    for arch in archs:
        for shape in shapes:
            trace = None        # the first mesh's, priced on the others
            for mk in meshes:
                rec, trace = run_cell(arch, shape, mk, opts, tag=args.tag,
                                      force=args.force, trace=trace)
                results.append(rec)
    n_ok = sum(r.get("status") == "ok" for r in results)
    n_skip = sum(r.get("status") == "skipped" for r in results)
    n_err = sum(r.get("status") == "error" for r in results)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"of {len(results)} cells")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
