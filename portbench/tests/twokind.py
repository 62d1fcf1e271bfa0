"""A model family for tests only: a leading layer of one kind, then layers
of another kind with one more tensor, so the program would stack them in
two segments.

Layer 0: ``h += relu(rms(h) @ w_in) @ w_out``; each later layer gates it,
``h += (silu(x @ w_gate) * (x @ w_in)) @ w_out``.  The embedding is tied
to the head; the loss is the mean next-token cross-entropy, float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Spec:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    param_dtype: str = "float32"


def spec(cfg: dict) -> Spec:
    return Spec(cfg["name"], cfg["layers"], cfg["width"], cfg["ffn"],
                cfg["vocab"], cfg["param_dtype"])


def param_leaves(spec: Spec):
    D, Fd = spec.d_model, spec.d_ff
    out = [("embed", (spec.vocab, D), 0.02), ("final_norm/scale", (D,), "ones")]
    for i in range(spec.n_layers):
        layer = [("norm/scale", (D,), "ones"),
                 ("ffn/w_in/w", (D, Fd), 1 / math.sqrt(D)),
                 ("ffn/w_out/w", (Fd, D), 1 / math.sqrt(Fd))]
        if i > 0:
            layer.append(("ffn/w_gate/w", (D, Fd), 1 / math.sqrt(D)))
        out += [(f"layers/{i}/{n}", s, init) for n, s, init in layer]
    return out


def segments(spec: Spec):
    return ((1, 1), (1, spec.n_layers - 1))


def _rms(x, scale):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * scale


def loss(params, spec: Spec, batch, quant=None):
    if quant is not None:
        raise ValueError(f"no {quant} path in the test family")
    h = params["embed"][batch["tokens"].long()]
    for i in range(spec.n_layers):
        p = lambda n: params[f"layers/{i}/{n}"]  # noqa: E731
        x = _rms(h, p("norm/scale"))
        a = x @ p("ffn/w_in/w")
        a = F.silu(x @ p("ffn/w_gate/w")) * a if i > 0 else F.relu(a)
        h = h + a @ p("ffn/w_out/w")
    logits = _rms(h, params["final_norm/scale"]) @ params["embed"].t()
    return F.cross_entropy(logits.reshape(-1, spec.vocab),
                           batch["labels"].long().reshape(-1))


def train_flops(spec: Spec, traffic: dict):
    D, Fd = spec.d_model, spec.d_ff
    params = 2 * D * Fd + (spec.n_layers - 1) * 3 * D * Fd + D * spec.vocab
    matmul = 6 * traffic["global_batch"] * traffic["seq_len"] * params
    return {"matmul": float(matmul), "attention": 0.0,
            "total": float(matmul)}


def small(cfg: dict) -> dict:
    return dict(cfg, layers=3, width=16, ffn=32, vocab=64)
