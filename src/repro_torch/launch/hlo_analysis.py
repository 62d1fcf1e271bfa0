"""Roofline terms of a step (port of ``repro/launch/hlo_analysis.py``).

Two readers feed one record, ``HloStats``:

  * ``analyze_hlo(text)`` reads the optimized (post-SPMD) HLO text of a
    compiled XLA executable, as the reference does, and gives the same
    results on any HLO text: ``compiled.cost_analysis()`` counts a While
    body ONCE, ignoring its trip count, so the roofline terms are
    re-derived from the text:

      1. split the module into computations; map instruction → result
         type;
      2. build the call-graph multiplier: ENTRY ×1, While bodies × their
         ``known_trip_count`` backend config, fusion/conditional/call
         edges ×1;
      3. FLOPs     = Σ dot ops: 2 · |result| · |contracted dims| ·
         multiplier;
      4. HBM bytes = Σ top-level (non-fusion-body) instructions:
         (operand + result bytes) · multiplier;
      5. collective wire bytes per network tier (ici intra-pod / dcn
         cross-pod, pod = device id // 256), × multiplier, with
         ring-equivalent factors: all-reduce 2·V·(n−1)/n |
         all-gather/reduce-scatter/all-to-all V·(n−1)/n | permute V.

  * ``analyze_program(fn, *args, **kw)`` reads the port's own program.
    The port compiles no HLO: a step is the aten ops that one call
    dispatches, and ``ProgramCounter`` (a ``TorchDispatchMode``) sees each
    of them, on ``meta`` tensors (a trace at any size, no storage) or on
    the card (a real run).  It counts FLOPs and dots with
    ``torch.utils.flop_counter``'s formulas, HBM bytes as operand plus
    result bytes of every op that is not a view (in eager every op is
    memory-visible: there is no fusion), the ops, the transcendental
    elements, and the most bytes of live storages during the call
    (``peak_live_bytes``).  Its record has no wire bytes: on one card the
    GSPMD program is the unsharded one and runs no collective (ROADMAP
    A12).  It has no ``f32_upcast_copy_bytes`` either: that corrects
    XLA:CPU's f32 copies of bf16 dot operands, which eager torch does not
    make.

``roofline_terms(st, peaks)`` prices a record on a device's peaks
(``Peaks``), by default the NVIDIA H100 SXM's data-sheet figures.
"""

from __future__ import annotations

import re
import weakref
from collections import defaultdict
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

_TYPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->", re.M)
# type may be a tuple "(f32[..], /*index=5*/ bf16[..], ...)" — comments
# contain '=' but never ')', so "anything but ')'" is the right class
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?(?P<name>[\w.\-]+)\s*=\s*(?P<type>\([^)]*\)|[\w\[\],{}\s/]+?)\s+"
    r"(?P<op>[\w\-]+)\((?P<operands>[^)]*)\)(?P<attrs>.*)$", re.M)
_GROUPS_RE = re.compile(r"replica_groups=\{(\{[\d,{}\s]*\})\}")
_IOTA_GROUPS_RE = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?")
_SRC_TGT_RE = re.compile(r"source_target_pairs=\{((?:\{\d+,\d+\},?)*)\}")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')

COLLECTIVE_OPS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute", "all-reduce-start", "all-gather-start",
                  "collective-permute-start", "ragged-all-to-all"}
SKIP_BYTES_OPS = {"tuple", "get-tuple-element", "parameter", "bitcast",
                  "constant", "after-all", "copy-start", "copy-done",
                  "while", "conditional", "call"}


def _shape_elems_bytes(type_str: str) -> Tuple[int, int]:
    total_b = 0
    total_e = 0
    for dtype, dims in _TYPE_RE.findall(type_str):
        if dtype not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
        total_e += n
        total_b += n * DTYPE_BYTES[dtype]
    return total_e, total_b


def _type_bytes(type_str: str) -> int:
    return _shape_elems_bytes(type_str)[1]


def _dims_of(type_str: str) -> Optional[List[int]]:
    m = _TYPE_RE.search(type_str)
    if not m:
        return None
    return [int(d) for d in m.group(2).split(",") if d.strip()]


@dataclass
class Computation:
    name: str
    text: str
    is_entry: bool = False
    fusion_body: bool = False
    instrs: list = field(default_factory=list)   # _INSTR_RE matches
    defs: Dict[str, str] = field(default_factory=dict)  # name -> type str


def _split_computations(hlo: str) -> Dict[str, Computation]:
    """Split module text into computation blocks (headers at column 0)."""
    comps: Dict[str, Computation] = {}
    headers = []
    for m in re.finditer(r"^(ENTRY\s+)?%?([\w.\-]+)\s+\(.*?\)\s*->.*\{",
                         hlo, re.M):
        headers.append((m.start(), m.group(2), bool(m.group(1))))
    headers.sort()
    for i, (start, name, is_entry) in enumerate(headers):
        end = headers[i + 1][0] if i + 1 < len(headers) else len(hlo)
        text = hlo[start:end]
        comp = Computation(name=name, text=text, is_entry=is_entry)
        for im in _INSTR_RE.finditer(text):
            comp.instrs.append(im)
            comp.defs[im.group("name")] = im.group("type")
        comps[name] = comp
    return comps


def _multipliers(comps: Dict[str, Computation]) -> Dict[str, float]:
    """Execution-count multiplier per computation via the call graph."""
    edges: Dict[str, List[Tuple[str, float]]] = defaultdict(list)
    for c in comps.values():
        for im in c.instrs:
            op = im.group("op")
            attrs = im.group("attrs")
            if op == "while":
                trip = 1.0
                tm = _TRIP_RE.search(attrs)
                if tm:
                    trip = float(tm.group(1))
                bm = re.search(r"body=%?([\w.\-]+)", attrs)
                cm = re.search(r"condition=%?([\w.\-]+)", attrs)
                if bm:
                    edges[c.name].append((bm.group(1), trip))
                if cm:
                    edges[c.name].append((cm.group(1), trip + 1))
            elif op == "fusion":
                fm = re.search(r"calls=%?([\w.\-]+)", attrs)
                if fm:
                    edges[c.name].append((fm.group(1), 1.0))
                    if fm.group(1) in comps:
                        comps[fm.group(1)].fusion_body = True
            elif op == "conditional":
                bm = re.search(r"branch_computations=\{([^}]*)\}", attrs)
                if bm:
                    for bn in re.findall(r"%?([\w.\-]+)", bm.group(1)):
                        edges[c.name].append((bn, 1.0))
                for key in ("true_computation", "false_computation"):
                    km = re.search(key + r"=%?([\w.\-]+)", attrs)
                    if km:
                        edges[c.name].append((km.group(1), 1.0))
            elif op in ("call", "custom-call", "reduce", "sort", "scatter",
                        "map", "reduce-window", "select-and-scatter",
                        "all-reduce", "reduce-scatter"):
                am = re.search(r"to_apply=%?([\w.\-]+)", attrs)
                if am:
                    edges[c.name].append((am.group(1), 1.0))

    mult = {name: (1.0 if c.is_entry else 0.0) for name, c in comps.items()}
    for _ in range(len(comps) + 2):     # call graph is a DAG; fixed point
        changed = False
        new = {name: (1.0 if comps[name].is_entry else 0.0)
               for name in comps}
        for caller, outs in edges.items():
            for callee, w in outs:
                if callee in new:
                    new[callee] += mult.get(caller, 0.0) * w
        for name in comps:
            if not comps[name].is_entry and abs(new[name] - mult[name]) > 1e-9:
                changed = True
        if comps and not changed:
            break
        for name in comps:
            if not comps[name].is_entry:
                mult[name] = new[name]
    return mult


# ---------------------------------------------------------------------------
# analysis passes
# ---------------------------------------------------------------------------


@dataclass
class HloStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    dot_count: int = 0
    instr_count: int = 0
    unknown_trip_whiles: int = 0
    # XLA CPU has no native bf16 GEMM: it materializes f32 copies of every
    # bf16 dot operand (hoisted out of loops → f32 copies of all weights
    # live at entry).  Pure CPU-backend artifact — the TPU MXU consumes
    # bf16 natively — so we measure it and report TPU-adjusted memory.
    f32_upcast_copy_bytes: float = 0.0
    ops: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    wire_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    by_kind: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def as_dict(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "dot_count": self.dot_count, "instr_count": self.instr_count,
                "unknown_trip_whiles": self.unknown_trip_whiles,
                "f32_upcast_copy_bytes": self.f32_upcast_copy_bytes,
                "collective_ops": dict(self.ops),
                "wire_bytes": dict(self.wire_bytes),
                "by_kind": dict(self.by_kind),
                "total_collective_bytes": self.total_collective_bytes}


def _parse_groups(attrs: str) -> Optional[List[List[int]]]:
    m = _IOTA_GROUPS_RE.search(attrs)
    if m:
        n_groups, group_size = int(m.group(1)), int(m.group(2))
        dims = [int(x) for x in m.group(3).split(",")]
        perm = ([int(x) for x in m.group(4).split(",")]
                if m.group(4) else list(range(len(dims))))
        arr = np.arange(int(np.prod(dims))).reshape(dims).transpose(perm)
        return arr.reshape(n_groups, group_size).tolist()
    m = _GROUPS_RE.search(attrs)
    if m:
        groups = []
        for grp in re.findall(r"\{([\d,\s]*)\}", m.group(1)):
            if grp.strip():
                groups.append([int(x) for x in grp.split(",")])
        return groups or None
    return None


def analyze_hlo(hlo: str, chips_per_pod: int = 256) -> HloStats:
    comps = _split_computations(hlo)
    mult = _multipliers(comps)
    st = HloStats()
    st.unknown_trip_whiles = len(
        [1 for c in comps.values() for im in c.instrs
         if im.group("op") == "while" and not _TRIP_RE.search(im.group("attrs"))])

    for c in comps.values():
        w = mult.get(c.name, 0.0)
        if w == 0.0:
            continue
        for im in c.instrs:
            op = im.group("op")
            st.instr_count += 1
            # ---- FLOPs: dots everywhere (fusion bodies included) ----------
            if op in ("dot", "dot_general") or op == "dot":
                res_dims = _dims_of(im.group("type")) or []
                lhs_name = re.findall(r"%([\w.\-]+)", im.group("operands"))
                kdims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}",
                                  im.group("attrs"))
                k = 1
                if kdims and lhs_name:
                    lhs_type = c.defs.get(lhs_name[0])
                    ldims = _dims_of(lhs_type) if lhs_type else None
                    if ldims:
                        for ci in kdims.group(1).split(","):
                            if ci.strip():
                                k *= ldims[int(ci)]
                flops = 2.0 * float(np.prod(res_dims or [0])) * k
                st.flops += flops * w
                st.dot_count += 1
            elif op == "convolution":
                # rare here; approximate 2·|result|·(window·in_ch)
                res = _dims_of(im.group("type")) or [0]
                st.flops += 2.0 * float(np.prod(res)) * w

            # ---- collectives ----------------------------------------------
            if op in COLLECTIVE_OPS:
                base = op.replace("-start", "")
                result_b = _type_bytes(im.group("type"))
                if op.endswith("-start"):
                    result_b /= 2          # start results carry (in, out)
                operand_b = sum(
                    _type_bytes(c.defs.get(nm, ""))
                    for nm in re.findall(r"%([\w.\-]+)", im.group("operands")))
                attrs = im.group("attrs")
                if base == "collective-permute":
                    tier = "ici"
                    pairs = _SRC_TGT_RE.search(attrs)
                    if pairs:
                        ids = [int(x) for x in
                               re.findall(r"\d+", pairs.group(1))]
                        if any(a // chips_per_pod != b // chips_per_pod
                               for a, b in zip(ids[::2], ids[1::2])):
                            tier = "dcn"
                    wire = operand_b or result_b
                else:
                    groups = _parse_groups(attrs)
                    if groups:
                        n = len(groups[0])
                        tier = "dcn" if any(
                            len({d // chips_per_pod for d in g}) > 1
                            for g in groups) else "ici"
                    else:
                        n, tier = 2, "ici"
                    frac = (n - 1) / n if n > 1 else 0.0
                    if base == "all-reduce":
                        wire = 2 * (operand_b or result_b) * frac
                    elif base == "all-gather":
                        wire = result_b * frac
                    elif base == "reduce-scatter":
                        wire = (operand_b * frac) if operand_b \
                            else result_b * max(n - 1, 0)
                    else:   # all-to-all / ragged
                        wire = (operand_b or result_b) * frac
                st.ops[base] += int(w) if w >= 1 else 1
                st.wire_bytes[tier] += wire * w
                st.by_kind[base] += wire * w

            # ---- HBM bytes: memory-visible (non-fusion-body) ops ----------
            if not c.fusion_body and op not in SKIP_BYTES_OPS:
                b = _type_bytes(im.group("type"))
                for nm in re.findall(r"%([\w.\-]+)", im.group("operands")):
                    b += _type_bytes(c.defs.get(nm, ""))
                st.hbm_bytes += b * w

            # ---- CPU bf16→f32 dot-operand upcast artifact ------------------
            if (not c.fusion_body and op == "fusion"
                    and im.group("type").lstrip().startswith("f32")):
                fm = re.search(r"calls=%?([\w.\-]+)", im.group("attrs"))
                if fm and fm.group(1) in comps:
                    body_ops = {i.group("op")
                                for i in comps[fm.group(1)].instrs}
                    if body_ops <= {"parameter", "copy", "convert",
                                    "bitcast", "transpose", "reshape"}:
                        st.f32_upcast_copy_bytes += \
                            _type_bytes(im.group("type")) * w
    return st


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Peaks:
    """A device's peak rates: ``flops`` FLOP/s (dense, the step's dtype),
    ``hbm`` B/s of device memory, ``ici`` and ``dcn`` B/s of the link
    inside a pod and across pods."""

    name: str
    flops: float
    hbm: float
    ici: float
    dcn: float


# NVIDIA H100 SXM5, the data sheet's figures (published, not measured):
# 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3; the
# "pod" link is NVLink 4 at its published 450 GB/s a direction and the
# cross-pod link one 400 Gb/s NDR InfiniBand port, 50 GB/s.
H100_SXM = Peaks("h100-sxm", flops=989e12, hbm=3.35e12, ici=450e9, dcn=50e9)


def roofline_terms(st: HloStats, peaks: Peaks = H100_SXM) -> dict:
    t_compute = st.flops / peaks.flops
    t_memory = st.hbm_bytes / peaks.hbm
    t_ici = st.wire_bytes.get("ici", 0.0) / peaks.ici
    t_dcn = st.wire_bytes.get("dcn", 0.0) / peaks.dcn
    t_coll = t_ici + t_dcn
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll, "collective_ici_s": t_ici,
             "collective_dcn_s": t_dcn}
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["dominant"] = dom
    terms["bound_s"] = max(t_compute, t_memory, t_coll)
    return terms


# ---------------------------------------------------------------------------
# the port's own program: the aten ops one call dispatches
# ---------------------------------------------------------------------------


@dataclass
class ProgramStats(HloStats):
    """``HloStats`` of a traced call: no wire bytes (one card runs no
    collective) and no CPU upcast correction (see the module docstring),
    plus the transcendental elements and the peak of live storage."""

    transcendentals: int = 0
    peak_live_bytes: int = 0
    input_bytes: int = 0

    def as_dict(self) -> dict:
        d = super().as_dict()
        del d["f32_upcast_copy_bytes"]
        d.update(transcendentals=self.transcendentals,
                 peak_live_bytes=self.peak_live_bytes,
                 input_bytes=self.input_bytes)
        return d


def _packets(names):
    return {getattr(torch.ops.aten, n) for n in names
            if hasattr(torch.ops.aten, n)}


# ops whose result nobody writes (an allocation) or that only re-describe
# their operand's storage: neither moves a byte
_NO_TRAFFIC = _packets(("empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "_unsafe_view", "lift_fresh",
                        "detach", "alias"))
# one transcendental a result element (XLA's ``transcendentals``: exp, log,
# tanh, logistic, rsqrt, ... per element)
_TRANSCENDENTAL = _packets((
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2", "log10",
    "tanh", "tanh_", "sigmoid", "sigmoid_", "rsqrt", "rsqrt_", "sqrt",
    "sqrt_", "sin", "cos", "erf", "erfinv", "_softmax", "_log_softmax",
    "logsumexp", "silu", "silu_", "silu_backward", "gelu", "gelu_backward",
    "softplus", "atan", "pow"))
# ops that write their first operand without reading it
_WRITE_ONLY_SELF = _packets(("copy_", "fill_", "zero_"))
# queries that ``torch.utils.flop_counter`` leaves alone
_QUERIES = {p.default for p in _packets((
    "is_contiguous", "is_strides_like_format", "is_non_overlapping_and_dense",
    "size", "sym_size", "stride", "sym_stride", "storage_offset",
    "sym_storage_offset", "numel", "sym_numel", "dim"))
    if hasattr(p, "default")}


def _walk_tensors(obj, out):
    """Every tensor inside ``obj`` (dicts, lists, tuples, NamedTuples,
    dataclasses), appended to ``out``."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _walk_tensors(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _walk_tensors(v, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _walk_tensors(getattr(obj, f.name), out)
    return out


def tensor_bytes(obj) -> int:
    """The bytes of the storages of every tensor inside ``obj``, each
    storage once."""
    seen = {}
    for t in _walk_tensors(obj, []):
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def storage_key(t) -> int:
    """The identity of ``t``'s storage (shared by its views)."""
    return t.untyped_storage()._cdata


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class ProgramCounter(TorchDispatchMode):
    """Counts the aten ops run inside it into ``.stats`` (a
    ``ProgramStats``), in the ops ``torch.utils.flop_counter`` counts
    (composite ops decomposed as it decomposes them).  ``inputs`` (any
    tree of tensors) are the call's arguments: their storages are live
    from the start, and ``read`` collects the storage keys
    (``storage_key``) of those an op reads before any op overwrites them
    whole; an argument no op reads is one jax's ``jit`` would drop.
    Storage is counted on the first input tensor's device type only (the
    CPU's without inputs)."""

    def __init__(self, inputs=()):
        super().__init__()
        args = _walk_tensors(inputs, [])
        self._dev_type = args[0].device.type if args else "cpu"
        self.stats = ProgramStats()
        self._flops = 0
        self._live = {}
        self._now = 0
        for t in args:
            self._track(t)
        self.stats.input_bytes = self._now
        self._args = {storage_key(t) for t in args}
        self.read = set()

    def _freed(self, key):
        self._now -= self._live.pop(key, 0)

    def _track(self, t):
        if t.device.type != self._dev_type:
            return
        s = t.untyped_storage()
        key = s._cdata
        if key in self._live:
            return
        self._live[key] = s.nbytes()
        self._now += self._live[key]
        weakref.finalize(s, self._freed, key)
        self.stats.peak_live_bytes = max(self.stats.peak_live_bytes,
                                         self._now)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        packet = func._overloadpacket
        if packet not in flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        for t in ins:
            self._track(t)
        if not func.is_view:
            skip = 1 if packet in _WRITE_ONLY_SELF else 0
            read = [a for a in args[skip:] if isinstance(a, torch.Tensor)]
            read += [t for a in args[skip:] if isinstance(a, (list, tuple))
                     for t in a if isinstance(t, torch.Tensor)]
            read += [v for k, v in kwargs.items()
                     if k != "out" and isinstance(v, torch.Tensor)]
            self.read.update(k for k in map(storage_key, read)
                             if k in self._args)
            if skip and _nbytes(args[0]) == args[0].untyped_storage().nbytes():
                # overwritten whole: a later read sees the program's value
                self._args.discard(storage_key(args[0]))
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        st = self.stats
        st.instr_count += 1
        if packet in flop_registry:
            self._flops += int(flop_registry[packet](*args, **kwargs,
                                                     out_val=out))
            st.flops = self._flops
            st.dot_count += 1
        if packet in _TRANSCENDENTAL:
            st.transcendentals += sum(t.numel() for t in outs)
        if not func.is_view and packet not in _NO_TRAFFIC:
            st.hbm_bytes += (sum(_nbytes(t) for t in ins)
                             + sum(_nbytes(t) for t in outs))
        return out


def analyze_program(fn, *args, **kwargs) -> ProgramStats:
    """``ProgramStats`` of one call ``fn(*args, **kwargs)``: on ``meta``
    arguments a trace (shapes only), on the card a real run."""
    with ProgramCounter((args, kwargs)) as pc:
        fn(*args, **kwargs)
    return pc.stats
