"""The plain reference of a dense decoder LM, in float32 with TF32 off.

Plain PyTorch on purpose: no kernel, no cache, no chunking, nothing of the
program under test.  Each model family's module (``qwen2``) reads its
configuration file into a ``ModelSpec``.

The model, layer by layer (pre-norm residual blocks):
  h = embed[tokens]
  per layer: x = rms(h) * norm1
             q, k, v = x @ wq (+ bq), x @ wk (+ bk), x @ wv (+ bv)
             rope on q, k (half-split)
             causal GQA softmax(q k^T / sqrt(dh)) v, then @ wo; h += it
             x = rms(h) * norm2
             (silu(x @ w_gate) * (x @ w_up)) @ w_down;        h += it
  h = rms(h) * final_norm; logits = h @ head (``embed^T`` when tied); the
  mean cross-entropy over the tokens.

Parameters are a flat dict ``{name: tensor}``, named as the program's
parameter tree is laid out (``layers/<i>/attn/wq/w``); ``param_leaves``
lists every name with its shape and initial scale, and ``segments`` how
the program stacks the layers (one unit of one layer, repeated).
``train_flops`` counts a training step's FLOPs from the shapes.

``quant="fp8"`` is the control of the benchmark's comparison: every dense
matmul's two inputs are rounded through float8 e4m3 with a per-tensor
scale (the forward only; the backward passes the rounding straight
through), as an fp8 training recipe rounds them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@dataclass(frozen=True)
class ModelSpec:
    """What the reference needs to know of a model, in the configuration
    file's own numbers."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qkv_bias: bool
    tied: bool
    rope_theta: float
    norm_eps: float
    param_dtype: str = "bfloat16"


def param_leaves(spec: ModelSpec) -> List[Tuple[str, Tuple[int, ...], object]]:
    """Every parameter as ``(name, shape, init)``: ``init`` is the normal's
    standard deviation, or ``"ones"`` / ``"zeros"``.  Dense weights are
    ``[d_in, d_out]`` with std ``1 / sqrt(d_in)``; the embedding 0.02."""
    D, H, Hkv, Dh = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    dense = lambda din, dout: ((din, dout), 1.0 / math.sqrt(din))
    out = [("embed", (spec.vocab, D), 0.02),
           ("final_norm/scale", (D,), "ones")]
    if not spec.tied:
        out.append(("head/w",) + dense(D, spec.vocab))
    for i in range(spec.n_layers):
        pre = f"layers/{i}/"
        layer = [("norm1/scale", (D,), "ones"), ("norm2/scale", (D,), "ones"),
                 ("attn/wq/w",) + dense(D, H * Dh),
                 ("attn/wk/w",) + dense(D, Hkv * Dh),
                 ("attn/wv/w",) + dense(D, Hkv * Dh),
                 ("attn/wo/w",) + dense(H * Dh, D),
                 ("ffn/w_up/w",) + dense(D, spec.d_ff),
                 ("ffn/w_down/w",) + dense(spec.d_ff, D)]
        if spec.qkv_bias:
            layer += [("attn/wq/b", (H * Dh,), "zeros"),
                      ("attn/wk/b", (Hkv * Dh,), "zeros"),
                      ("attn/wv/b", (Hkv * Dh,), "zeros")]
        layer.append(("ffn/w_gate/w",) + dense(D, spec.d_ff))
        out += [(pre + n, s, init) for n, s, init in layer]
    return out


def segments(spec: ModelSpec) -> Tuple[Tuple[int, int], ...]:
    """Every layer is of one kind: one unit of one layer, ``n_layers``
    times."""
    return ((1, spec.n_layers),)


def layer_matmul_params(spec: ModelSpec) -> int:
    D, H, Hkv, Dh = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    attn = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
    return attn + 3 * D * spec.d_ff


def train_flops(spec: ModelSpec, traffic: dict) -> Dict[str, float]:
    """FLOPs of one training step of the global batch, without the forward
    that rematerialisation runs again.

    ``matmul``: 6 per matmul parameter per position it is applied at (2
    forward, 4 backward), for the layers and the head.  ``attention``: the score
    and value products over the causal positions (key j <= query i),
    forward 4 * heads * head_dim per pair, backward twice that.
    ``total`` is their sum."""
    B, T = traffic["global_batch"], traffic["seq_len"]
    head = spec.d_model * spec.vocab
    matmul = B * 6 * T * (spec.n_layers * layer_matmul_params(spec) + head)
    pairs = T * (T + 1) // 2
    attention = B * spec.n_layers * 3 * 4 * spec.n_heads * spec.head_dim * pairs
    return {"matmul": float(matmul), "attention": float(attention),
            "total": float(matmul + attention)}


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 under a per-tensor amax scale; the
    gradient passes straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    q = (x.detach() * s).to(torch.float8_e4m3fn).to(x.dtype) / s
    return x + (q - x).detach()


def _mm(x, w, quant):
    if quant == "fp8":
        x, w = _fp8(x), _fp8(w)
    return x @ w


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x [B, T, H, Dh], positions 0..T-1, half-split rotation."""
    T, Dh = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, Dh, 2, dtype=torch.float64,
                                        device=x.device) / Dh))
    ang = (torch.arange(T, dtype=torch.float64, device=x.device)[:, None]
           * inv).to(x.dtype)
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _block(h, p, spec: ModelSpec, quant):
    B, T, D = h.shape
    H, Hkv, Dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    x = _rms(h, p["norm1/scale"], spec.norm_eps)
    q, k, v = (_mm(x, p[f"attn/{n}/w"], quant) for n in ("wq", "wk", "wv"))
    if spec.qkv_bias:
        q, k, v = q + p["attn/wq/b"], k + p["attn/wk/b"], v + p["attn/wv/b"]
    q, k, v = (q.view(B, T, H, Dh), k.view(B, T, Hkv, Dh),
               v.view(B, T, Hkv, Dh))
    q, k = _rope(q, spec.rope_theta), _rope(k, spec.rope_theta)
    G = H // Hkv
    qg = q.view(B, T, Hkv, G, Dh).permute(0, 2, 3, 1, 4)   # [B,Hkv,G,T,Dh]
    kt = k.permute(0, 2, 3, 1)[:, :, None]                 # [B,Hkv,1,Dh,T]
    s = (qg @ kt) / math.sqrt(Dh)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.softmax(s, dim=-1) @ v.permute(0, 2, 1, 3)[:, :, None]
    o = o.permute(0, 3, 1, 2, 4).reshape(B, T, H * Dh)
    h = h + _mm(o, p["attn/wo/w"], quant)
    x = _rms(h, p["norm2/scale"], spec.norm_eps)
    act = F.silu(_mm(x, p["ffn/w_gate/w"], quant)) * _mm(x, p["ffn/w_up/w"],
                                                         quant)
    return h + _mm(act, p["ffn/w_down/w"], quant)


def loss(params: Dict[str, torch.Tensor], spec: ModelSpec,
         batch: Dict[str, torch.Tensor], quant: Optional[str] = None
         ) -> torch.Tensor:
    """The mean next-token cross-entropy of ``batch`` (``tokens``,
    ``labels`` [B, T]).  Each layer runs under ``torch.utils.checkpoint``
    so that a rank's backward fits beside the optimizer state; that changes
    no value."""
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    h = params["embed"][tokens]
    for i in range(spec.n_layers):
        pre = f"layers/{i}/"
        p = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
        h = checkpoint(_block, h, p, spec, quant, use_reentrant=False)
    h = _rms(h, params["final_norm/scale"], spec.norm_eps)
    w = params["embed"].t() if spec.tied else params["head/w"]
    logits = _mm(h, w, quant)
    return F.cross_entropy(logits.reshape(-1, spec.vocab), labels.reshape(-1))
