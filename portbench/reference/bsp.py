"""The plain reference of one BSP training superstep, and the readings the
benchmark compares.

The model is a ``Model``: the configuration's family module
(``reference/<family>.py``) and its spec.  This module calls the family
for everything model-specific and reads only ``name``, ``vocab`` and
``param_dtype`` of the spec.  A family module provides

* ``spec(config)``: its spec of a configuration file;
* ``param_leaves(spec)``: every parameter as ``(name, shape, init)``,
  named as the program's parameter tree (``layers/<i>/...`` for layer i,
  in layer order);
* ``segments(spec)``: ``((unit length, repeats), ...)``, the homogeneous
  units the program stacks the layers in, in layer order;
* ``loss(params, spec, batch, quant)``: the mean loss of a batch;
* ``train_flops(spec, traffic)``: ``{"matmul", "attention", "total"}``
  FLOPs of one step;
* ``small(config)``: the configuration cut to a CPU test size.

Worked out again from the configuration and the cell's own parameters,
independent of the program under test:

* ``Layout``: the flat f32 gradient layout.  Top-level parameter leaves
  and one leaf per tensor of each unit entry ``segments/<s>/l<j>/...``,
  stacked over the unit's repeats (a leaf is its layers' tensors end to
  end), in sorted path order; buckets filled greedily in REVERSE leaf
  order up to ``bucket_mb`` MB of f32 (a larger leaf alone), each padded to
  a multiple of ``world * 128`` elements.  After the reduce-scatter rank
  ``r`` holds the bucket's chunk ``rev(r)`` (the bit-reversal of r).
* the wire codecs (a frozen copy of the arithmetic: int8 in blocks of 128
  elements with an ``amax / 127`` scale, bf16 by rounding), error
  feedback (``corrected = g + res``; the new residual is what the codec
  loses of it; the wire carries ``corrected - residual``), and the
  recursive-halving reduce-scatter: at hop b rank r keeps the half that
  bit b of r names, sends the other through the codec to ``r ^ 2^b`` and
  adds what it receives;
* AdamW on the reduced mean gradient (a frozen copy: linear warm-up then a
  cosine to ``min_lr_ratio``, bias correction, decoupled weight decay, no
  clip), elementwise, so the ZeRO-1 sharding changes nothing of it; the
  parameters are kept in the configuration's ``param_dtype`` between steps
  (bf16: each update is rounded to bf16, as the configuration stores them)
  and computed in f32.

``run`` trains the reference for the first steps of a cell and returns
its ``Readings``; ``program_*`` take the same readings from the program's
state; ``compare`` turns two readings into the numbers ``correct`` holds
to their limits.
"""

from __future__ import annotations

import hashlib
import importlib
import math
import statistics
from dataclasses import dataclass, field
from types import ModuleType
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

F32 = torch.float32
INT8_BLOCK = 128
PAD_ALIGN = 128


# ---------------------------------------------------------------------------
# the model and its flat layout
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Model:
    """A configuration's family module and the family's spec of it."""

    family: ModuleType
    spec: Any

    @classmethod
    def of(cls, config: dict) -> "Model":
        fam = importlib.import_module(
            f"portbench.reference.{config['family']}")
        return cls(fam, fam.spec(config))


@dataclass(frozen=True)
class Segment:
    name: str       # the parameter (one layer's tensor)
    start: int      # offset in its bucket
    numel: int


@dataclass(frozen=True)
class BucketPlan:
    index: int
    segments: Tuple[Segment, ...]
    raw: int
    length: int     # padded


def _path_key(name: str):
    return tuple(name.split("/"))


def stacked_leaves(model: Model) -> List[Tuple[str, List[str]]]:
    """``(leaf path, [parameter names])`` in the flat order: each top-level
    leaf alone, and one leaf per tensor of each unit entry j of segment s,
    ``segments/<s>/l<j>/...``, its parts the layers that repeat the entry;
    sorted by path (segments by number, ``segments`` after ``embed``,
    ``final_norm`` and ``head``)."""
    entry = []      # layer i -> (segment, unit entry)
    for s, (unit, reps) in enumerate(model.family.segments(model.spec)):
        entry += [(s, j) for _ in range(reps) for j in range(unit)]
    top, stacked = [], {}
    for name, _shape, _init in model.family.param_leaves(model.spec):
        parts = name.split("/")
        if parts[0] == "layers":
            s, j = entry[int(parts[1])]
            key = ("segments", s, f"l{j}") + tuple(parts[2:])
            stacked.setdefault(key, []).append(name)
        else:
            top.append((_path_key(name), [name]))
    items = top + list(stacked.items())
    items.sort(key=lambda t: t[0])
    return [("/".join(map(str, k)), parts) for k, parts in items]


class Layout:
    """Buckets, shards and every parameter's place in them."""

    def __init__(self, model: Model, world: int, bucket_mb: float):
        self.world = world
        shapes = {n: s for n, s, _ in model.family.param_leaves(model.spec)}
        leaves = stacked_leaves(model)
        sizes = [sum(math.prod(shapes[p]) for p in parts)
                 for _, parts in leaves]
        bound = max(1, int(bucket_mb * 1e6 / 4))
        pad = world * PAD_ALIGN
        groups, cur, cur_n = [], [], 0
        for i in reversed(range(len(leaves))):
            if cur and cur_n + sizes[i] > bound:
                groups.append(cur)
                cur, cur_n = [], 0
            cur.append(i)
            cur_n += sizes[i]
        if cur:
            groups.append(cur)
        self.buckets: List[BucketPlan] = []
        self.where: Dict[str, Tuple[int, Segment]] = {}
        for bi, ids in enumerate(groups):
            segs, off = [], 0
            for i in ids:
                for p in leaves[i][1]:
                    n = math.prod(shapes[p])
                    seg = Segment(p, off, n)
                    segs.append(seg)
                    self.where[p] = (bi, seg)
                    off += n
            length = -(-off // pad) * pad
            self.buckets.append(BucketPlan(bi, tuple(segs), off, length))
        self.rev = [int(format(r, f"0{max(1, world.bit_length() - 1)}b")[::-1],
                        2) if world > 1 else 0 for r in range(world)]

    def shard_len(self, b: BucketPlan) -> int:
        return b.length // self.world

    def shard_offsets(self) -> List[int]:
        out, acc = [], 0
        for b in self.buckets:
            out.append(acc)
            acc += self.shard_len(b)
        return out


# ---------------------------------------------------------------------------
# weights and batches, made from the seed on the device
# ---------------------------------------------------------------------------


def _subseed(seed: int, tag: str) -> int:
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def init_groups(model: Model):
    """``(leaf path, [names], shape of one, init)`` of every stacked leaf:
    the unit the weights are drawn in, one ``randn`` call each."""
    info = {n: (s, init)
            for n, s, init in model.family.param_leaves(model.spec)}
    return [(path, names) + info[names[0]]
            for path, names in stacked_leaves(model)]


def init_group(group, seed: int, device, dtype) -> torch.Tensor:
    """One stacked leaf's initial values ``[layers, *shape]`` in ``dtype``
    (drawn in f32 from its own generator, scaled, then cast)."""
    path, names, shape, init = group
    full = (len(names),) + tuple(shape)
    if init == "ones":
        return torch.ones(full, dtype=dtype, device=device)
    if init == "zeros":
        return torch.zeros(full, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_subseed(seed, path))
    w = torch.randn(full, generator=gen, dtype=F32, device=device)
    return w.mul_(init).to(dtype)


def make_weights(model: Model, seed: int, device,
                 dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Every parameter, one tensor of its own each, in ``dtype`` (default:
    the configuration's ``param_dtype``)."""
    dtype = dtype or getattr(torch, model.spec.param_dtype)
    out = {}
    for group in init_groups(model):
        w = init_group(group, seed, device, dtype)
        for i, name in enumerate(group[1]):
            out[name] = w[i].clone()
        del w
    return out


def make_batches(model: Model, traffic: dict, seed: int, n: int,
                 device) -> List[Dict[str, torch.Tensor]]:
    """``n`` global batches, drawn in order from one generator: token ids
    uniform over the vocabulary (``tokens`` and the next-token ``labels``,
    [batch, seq])."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_subseed(seed, "batches"))
    B, T = traffic["global_batch"], traffic["seq_len"]
    out = []
    for _ in range(n):
        ids = torch.randint(0, model.spec.vocab, (B, T + 1), generator=gen,
                            device=device)
        out.append({"tokens": ids[:, :-1].contiguous(),
                    "labels": ids[:, 1:].contiguous()})
    return out


# ---------------------------------------------------------------------------
# the codecs, the exchange, AdamW (frozen copies of the arithmetic)
# ---------------------------------------------------------------------------


def _int8_encode(x):
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // INT8_BLOCK, INT8_BLOCK)
    scale = xb.abs().amax(dim=-1, keepdim=True) * torch.tensor(
        1.0 / 127.0, dtype=F32)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = (xb / safe).round().clamp(-127, 127)
    return q, scale


def wire(x: torch.Tensor, codec: Optional[str]) -> torch.Tensor:
    """What arrives of ``x`` (rows of f32) after the codec: decoded f32."""
    if codec is None:
        return x
    if codec == "bf16":
        return x.to(torch.bfloat16).to(F32)
    if codec == "int8":
        q, scale = _int8_encode(x)
        return (q * scale).reshape(x.shape)
    raise ValueError(codec)


def owner_sum(x: torch.Tensor, col: int, length: int,
              codec: Optional[str]) -> torch.Tensor:
    """Recursive halving, the codec on every hop, of one block of columns
    ``x`` [W, k] (every rank's values) starting at column ``col`` of a
    bucket of ``length``; the block lies inside one final chunk and starts
    on a multiple of 128.  At hop b the half of width ``length / 2^(b+1)``
    holding the block is kept by the ranks whose bit b names it, each
    adding what its partner ``r ^ 2^b`` sends through the codec.  Returns
    the sum that the one rank left holding the block ends with."""
    W = x.shape[0]
    vals = {r: x[r] for r in range(W)}
    width = length
    for b in range(W.bit_length() - 1):
        width //= 2
        half = (col // width) % 2
        vals = {r: v + wire(vals[r ^ (1 << b)][None], codec)[0]
                for r, v in vals.items() if (r >> b) & 1 == half}
    (v,) = vals.values()
    return v


# columns of a bucket exchanged and updated at a time (a multiple of 128)
COLUMN_BLOCK = 1 << 24


def lr_at(step: int, t: dict) -> float:
    """The learning rate of 0-based ``step`` (f32 as the schedule runs)."""
    s = torch.tensor(float(step), dtype=F32)
    warm = torch.clamp((s + 1) / max(t["warmup_steps"], 1), max=1.0)
    frac = torch.clamp((s - t["warmup_steps"])
                       / max(t["total_steps"] - t["warmup_steps"], 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    decay = t["min_lr_ratio"] + (1 - t["min_lr_ratio"]) * cos
    return t["lr"] * warm * decay


def adamw(p, g, mu, nu, step: int, t: dict):
    """One AdamW update of flat f32 tensors; returns the new (p, mu, nu)."""
    b1, b2 = t["beta1"], t["beta2"]
    n = torch.tensor(step + 1, dtype=F32, device=p.device)
    lr = lr_at(step, t).to(p.device)
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    mhat = mu / (1 - b1 ** n)
    nhat = nu / (1 - b2 ** n)
    upd = mhat / (torch.sqrt(nhat) + t["eps"]) + t["weight_decay"] * p
    return p - lr * upd, mu, nu


# ---------------------------------------------------------------------------
# readings
# ---------------------------------------------------------------------------


@dataclass
class Readings:
    """What a run of the first steps leaves to compare: each step's loss,
    each parameter's first mean gradient (norm and RMS) as the optimizer
    got it, and each parameter's change over the steps (norm)."""

    losses: List[float] = field(default_factory=list)
    grad_norm: Dict[str, float] = field(default_factory=dict)
    grad_rms: Dict[str, float] = field(default_factory=dict)
    change_norm: Dict[str, float] = field(default_factory=dict)


def _square_sums(vec: torch.Tensor, b: BucketPlan) -> Dict[str, torch.Tensor]:
    return {s.name: vec[s.start:s.start + s.numel].double().square().sum()
            for s in b.segments}


def _norms_of(sq: Dict[str, torch.Tensor], layout: Layout
              ) -> Tuple[Dict, Dict]:
    names = list(sq)
    vals = torch.stack([sq[n] for n in names]).cpu().tolist()
    norm = {n: math.sqrt(v) for n, v in zip(names, vals)}
    rms = {n: math.sqrt(v / layout.where[n][1].numel)
           for n, v in zip(names, vals)}
    return norm, rms


def change_norms(params: Dict[str, torch.Tensor], model: Model,
                 seed: int) -> Dict[str, float]:
    """||p - p0|| of every parameter, p0 drawn again from the seed (in the
    configuration's dtype, as both sides started from it)."""
    dtype = getattr(torch, model.spec.param_dtype)
    out = {}
    for group in init_groups(model):
        dev = params[group[1][0]].device
        w0 = init_group(group, seed, dev, dtype)
        sq = torch.stack([(params[n].detach().double() - w0[i].double())
                          .square().sum() for i, n in enumerate(group[1])])
        out.update(zip(group[1], sq.sqrt().cpu().tolist()))
        del w0
    return out


def program_grad_norms(flat_mu: torch.Tensor, layout: Layout, beta1: float
                       ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """The program's first mean gradient, per parameter, from its ZeRO-1
    first moments after one step (``mu = (1 - beta1) g``): rank r's row
    holds chunk ``rev(r)`` of each bucket, buckets end to end."""
    sq = {}
    for b, s_off in zip(layout.buckets, layout.shard_offsets()):
        n = layout.shard_len(b)
        chunks = {layout.rev[r]: flat_mu[r, s_off:s_off + n]
                  for r in range(layout.world)}
        for s in b.segments:
            acc = []
            for c in range(s.start // n, (s.start + s.numel - 1) // n + 1):
                lo = max(s.start, c * n) - c * n
                hi = min(s.start + s.numel, (c + 1) * n) - c * n
                acc.append(chunks[c][lo:hi].double().square().sum())
            sq[s.name] = torch.stack(acc).sum()
    names = list(sq)
    vals = torch.stack([sq[n] for n in names]).cpu().tolist()
    scale = 1.0 / (1.0 - beta1)
    norm = {n: math.sqrt(v) * scale for n, v in zip(names, vals)}
    rms = {n: norm[n] / math.sqrt(layout.where[n][1].numel) for n in names}
    return norm, rms


# ---------------------------------------------------------------------------
# the reference run
# ---------------------------------------------------------------------------


def run(model: Model, traffic: dict, seed: int,
        batches: Sequence[Dict[str, torch.Tensor]], device,
        variant: Optional[str] = None) -> Readings:
    """The reference's first ``len(batches)`` steps from the seed's
    weights.  ``variant`` puts a deliberately wrong reference in the
    program's place: ``"fp8"`` (the control: matmul inputs through fp8),
    ``"half_batch"`` (half of each batch left out, the mean over the
    rest), ``"no_exchange"`` (each rank updates its shard with its own
    gradient alone)."""
    W = traffic["world"]
    codec = traffic["bucket_codec"]
    layout = Layout(model, W, traffic["bucket_mb"])
    dtype = getattr(torch, model.spec.param_dtype)
    quant = "fp8" if variant == "fp8" else None
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = {n: t.to(F32).requires_grad_(True) for n, t in
                  make_weights(model, seed, device, dtype).items()}
        names = list(params)
        mu = [torch.zeros(b.length, dtype=F32, device=device)
              for b in layout.buckets]
        nu = [torch.zeros_like(m) for m in mu]
        ef = ([torch.zeros(W, b.length, dtype=F32, device=device)
               for b in layout.buckets] if codec else None)
        out = Readings()
        for step, batch in enumerate(batches):
            rows = batch["tokens"].shape[0]
            if variant == "half_batch":
                rows //= 2
            per = rows // W
            g = [torch.zeros(W, b.length, dtype=F32, device=device)
                 for b in layout.buckets]
            losses = []
            for r in range(W):
                mb = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
                loss = model.family.loss(params, model.spec, mb, quant)
                grads = torch.autograd.grad(loss, [params[n] for n in names])
                for n, gr in zip(names, grads):
                    bi, s = layout.where[n]
                    g[bi][r, s.start:s.start + s.numel] = gr.reshape(-1)
                del grads
                losses.append(loss.detach())
            out.losses.append(float(torch.stack(losses).mean()))
            sq = {}
            with torch.no_grad():
                for b in layout.buckets:
                    x, g[b.index] = g[b.index], None
                    n = layout.shard_len(b)
                    p = torch.zeros(b.length, dtype=F32, device=device)
                    for s in b.segments:
                        p[s.start:s.start + s.numel] = \
                            params[s.name].reshape(-1)
                    mean = torch.empty_like(p)
                    for c in range(W):
                        for a in range(c * n, (c + 1) * n, COLUMN_BLOCK):
                            e = min(a + COLUMN_BLOCK, (c + 1) * n)
                            blk = x[:, a:e]
                            if codec:
                                corrected = blk + ef[b.index][:, a:e]
                                res = corrected - wire(corrected, codec)
                                ef[b.index][:, a:e] = res
                                blk = corrected - res
                            if variant == "no_exchange":
                                got = blk[layout.rev.index(c)]
                            else:
                                got = owner_sum(blk, a, b.length, codec)
                            mean[a:e] = got / W
                            p[a:e], mu[b.index][a:e], nu[b.index][a:e] = \
                                adamw(p[a:e], mean[a:e], mu[b.index][a:e],
                                      nu[b.index][a:e], step, traffic)
                    del x
                    for s in b.segments:
                        new = p[s.start:s.start + s.numel].to(dtype).to(F32)
                        params[s.name].copy_(new.view_as(params[s.name]))
                    if step == 0:
                        sq.update(_square_sums(mean, b))
                    del p, mean
            if step == 0:
                out.grad_norm, out.grad_rms = _norms_of(sq, layout)
            del g
        out.change_norm = change_norms(params, model, seed)
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------


# a parameter whose first reference gradient has an RMS under this share of
# the median parameter's moves by round-off alone (a key's bias under the
# softmax): its change is left out of ``change_gap``
MOVED_FLOOR = 1e-3


def compare(prog: Readings, ref: Readings) -> Dict[str, dict]:
    """The numbers ``correct`` can hold to limits, each with where it is
    worst: ``loss_gap``, the largest |loss - ref| / |ref| over the steps;
    ``grad_gap``, over every parameter, |norm - ref norm| of the first mean
    gradient over the larger of the parameter's reference norm and the
    median parameter's; ``change_gap``, the same of the change over the
    steps, over the parameters the reference's gradient moves."""
    if len(prog.losses) != len(ref.losses):
        raise ValueError("readings of different step counts")
    out = {}
    gaps = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
            for p, r in zip(prog.losses, ref.losses)]
    worst = max(range(len(gaps)), key=lambda i: gaps[i])
    out["loss_gap"] = {"value": gaps[worst], "at": f"step {worst}"}

    def gap(progs, refs, names):
        floor = statistics.median(refs[n] for n in names)
        best, at = -1.0, None
        for n in names:
            p = progs.get(n, math.nan)
            g = (abs(p - refs[n]) / max(refs[n], floor)
                 if math.isfinite(p) else math.inf)
            if g > best:
                best, at = g, n
        return {"value": best, "at": at}

    names = sorted(ref.grad_norm)
    out["grad_gap"] = gap(prog.grad_norm, ref.grad_norm, names)
    floor = statistics.median(ref.grad_rms[n] for n in names)
    moved = [n for n in names if ref.grad_rms[n] >= MOVED_FLOOR * floor]
    out["change_gap"] = gap(prog.change_norm, ref.change_norm, moved)
    out["change_gap"]["left_out"] = len(names) - len(moved)
    return out
