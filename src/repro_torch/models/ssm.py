"""State-space / recurrent blocks (port of ``repro/models/ssm.py``): Mamba
(Jamba's recurrent layer) and xLSTM's mLSTM and sLSTM.

All three expose (init, forward, step):

  * ``forward`` — full-sequence processing; the recurrence over time is a
    plain Python loop of torch ops (the reference's ``lax.scan``).
    Returns the final recurrent state as the decode cache.
  * ``step``    — single-token decode: an O(1) state update, no KV cache.

``update_mask`` [B,T] (a PREFIX mask) gates the state advance per row:
row b advances over its first ``mask[b].sum()`` tokens only, and a row
gated off keeps its incoming state bit for bit (``_gate_carry``).  That is
what the serve engine's masked chunked prefill and its decode rows of
inactive slots rest on.

Numerics follow the reference: ``A_log``, ``D`` and every recurrent state
(``h``, ``C``, ``n``, ``m``, ``c``) are f32, the conv state stays in the
model dtype; softplus is ``jax.nn.softplus`` (``log1p(exp(-|x|)) +
max(x, 0)``, not torch's thresholded one); the sLSTM's FFN uses the tanh
GELU.  The reference's ``chunked_scan`` (time chunks under
``jax.checkpoint``) only bounds the memory of a backward pass, which
serving never runs: here the loop runs over every step.

Shapes follow the papers: Mamba [arXiv:2312.00752] selective SSM with
d_inner = expand·d_model, depthwise causal conv (d_conv), Δ/B/C
data-dependent; xLSTM [arXiv:2405.04517] exponential gating with the
max-stabiliser state m, matrix memory (mLSTM) and scalar memory with
recurrent gates (sLSTM).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, SSMConfig
from .layers import _dtype, _init_dense, _normal, dense, init_rmsnorm, \
    rms_norm


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _causal_conv(x, w, state=None, update_mask=None):
    """Depthwise causal 1-D conv.  x: [B,T,C], w: [K,C].

    state: [B,K-1,C] previous inputs (decode); returns (y, new_state).

    update_mask: optional [B,T] bool PREFIX mask: row b consumed only its
    first ``valid_b = mask.sum()`` tokens; the returned state is the last
    K-1 stream inputs as of token ``valid_b - 1`` (rows with valid_b == 0
    keep their incoming state).  Outputs at masked positions are garbage
    and must not be read."""
    K = w.shape[0]
    B, T, C = x.shape
    if state is None:
        pad = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)                 # [B, T+K-1, C]
    y = sum(xp[:, i:i + T, :] * w[i][None, None, :] for i in range(K))
    if K == 1:
        new_state = pad
    elif update_mask is None:
        new_state = xp[:, -(K - 1):, :]
    else:
        # token t of row b sits at xp[b, K-1+t]; after valid_b tokens the
        # last K-1 stream inputs occupy xp[b, valid_b : valid_b+K-1]
        valid = update_mask.to(torch.int64).sum(dim=1)          # [B]
        idx = valid[:, None] + torch.arange(K - 1, device=x.device)[None, :]
        new_state = torch.gather(xp, 1, idx[:, :, None].expand(B, K - 1, C))
    return y, new_state


def _gate_carry(mask_t, new, old):
    """Per-row carry gate: keep ``new`` where ``mask_t`` [B] is True.  Rows
    gated off keep their incoming recurrent state bit for bit."""
    return tuple(
        torch.where(mask_t.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
        for a, b in zip(new, old))


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, without torch's linear
    threshold."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _conv_weight(d_conv, d, *, dtype, device, generator):
    return _normal((d_conv, d), 1.0 / math.sqrt(d_conv), dtype=dtype,
                   device=device, generator=generator)


# ===========================================================================
# Mamba (selective SSM) — Jamba's recurrent layer
# ===========================================================================


def init_mamba(cfg: ArchConfig, *, device, generator):
    s: SSMConfig = cfg.ssm
    dt = _dtype(cfg)
    D = cfg.d_model
    d_in = s.expand * D
    dt_rank = s.dt_rank or -(-D // 16)
    kw = dict(dtype=dt, device=device, generator=generator)
    A = torch.arange(1, s.d_state + 1, dtype=torch.float32,
                     device=device)[None, :].expand(d_in, s.d_state)
    return {
        "in_proj": _init_dense(D, 2 * d_in, **kw),
        "conv_w": _conv_weight(s.d_conv, d_in, **kw),
        "conv_b": torch.zeros((d_in,), dtype=dt, device=device),
        "x_proj": _init_dense(d_in, dt_rank + 2 * s.d_state, **kw),
        "dt_proj": _init_dense(dt_rank, d_in, bias=True, **kw),
        "A_log": torch.log(A).contiguous(),     # f32: dynamics stay f32
        "D": torch.ones((d_in,), dtype=torch.float32, device=device),
        "out_proj": _init_dense(d_in, D, **kw),
    }


def _mamba_scan_step(dA_t, dBx_t, C_t, h):
    """One selective-SSM step from the step's precomputed ``dA = exp(dt·A)``
    and ``dBx = dt·B·x`` (elementwise, so computing them for every step at
    once gives the same bits).  h: [B,d_in,N]; returns (h', y_t [B,d_in])."""
    h = dA_t * h + dBx_t
    y = torch.einsum("bdn,bn->bd", h, C_t)
    return h, y


def mamba_forward(p, cfg: ArchConfig, u, state=None, update_mask=None):
    """u: [B,T,D] → (y [B,T,D], cache {"conv", "h"}).

    update_mask: optional [B,T] bool prefix mask: the state advances only
    over masked-True steps per row (masked-off outputs are garbage, never
    read)."""
    s: SSMConfig = cfg.ssm
    B, T, D = u.shape
    d_in = s.expand * D
    dt_rank = s.dt_rank or -(-D // 16)
    x, z = torch.chunk(dense(p["in_proj"], u), 2, dim=-1)
    conv_state = None if state is None else state["conv"]
    x, new_conv = _causal_conv(x, p["conv_w"], conv_state, update_mask)
    x = F.silu(x + p["conv_b"])

    proj = dense(p["x_proj"], x)
    dt_in = proj[..., :dt_rank]
    Bc = proj[..., dt_rank:dt_rank + s.d_state].float()
    Cc = proj[..., dt_rank + s.d_state:].float()
    dt_full = _softplus(dense(p["dt_proj"], dt_in).float())
    A = -torch.exp(p["A_log"])
    x32 = x.float()

    h = (torch.zeros((B, d_in, s.d_state), dtype=torch.float32,
                     device=u.device) if state is None else state["h"])
    dA = torch.exp(dt_full[..., None] * A[None, None])       # [B,T,d_in,N]
    dBx = dt_full[..., None] * Bc[:, :, None, :] * x32[..., None]
    ys = []
    for t in range(T):
        h_new, y = _mamba_scan_step(dA[:, t], dBx[:, t], Cc[:, t], h)
        h = h_new if update_mask is None else \
            _gate_carry(update_mask[:, t], (h_new,), (h,))[0]
        ys.append(y)
    y = torch.stack(ys, dim=1) + x32 * p["D"][None, None, :]
    y = y.to(u.dtype) * F.silu(z)
    out = dense(p["out_proj"], y)
    return out, {"conv": new_conv, "h": h}


def mamba_step(p, cfg: ArchConfig, u_t, state):
    """u_t: [B,1,D] single token; state from forward/step."""
    return mamba_forward(p, cfg, u_t, state)


# ===========================================================================
# mLSTM block (xLSTM) — matrix memory
# ===========================================================================


def init_mlstm(cfg: ArchConfig, *, device, generator):
    s: SSMConfig = cfg.ssm
    dt = _dtype(cfg)
    D = cfg.d_model
    d_in = s.expand * D                    # up-projection factor 2 (paper)
    NH = s.num_heads
    dh = d_in // NH
    kw = dict(dtype=dt, device=device, generator=generator)
    head = lambda: _normal((NH, dh, dh), 1.0 / math.sqrt(dh), **kw)
    return {
        "norm": init_rmsnorm(D, dtype=dt, device=device),
        "up_proj": _init_dense(D, 2 * d_in, **kw),
        "conv_w": _conv_weight(s.d_conv, d_in, **kw),
        "conv_b": torch.zeros((d_in,), dtype=dt, device=device),
        # headwise (block-diagonal) q/k/v, as in the official NX-AI blocks
        "wq": head(),
        "wk": head(),
        "wv": head(),
        "w_if": _init_dense(d_in, 2 * NH, bias=True, **kw),
        "out_norm": init_rmsnorm(d_in, dtype=dt, device=device),
        "down_proj": _init_dense(d_in, D, **kw),
        "skip": torch.ones((d_in,), dtype=dt, device=device),
    }


def _mlstm_cell_step(q_t, k_t, v_t, i_t, log_f_t, state):
    """Stabilised mLSTM recurrence (paper eq. 19-27).

    q,k,v: [B,NH,dh] f32; i: [B,NH] pre-activation, log_f: [B,NH]
    log sigmoid of the forget pre-activation.
    state: C [B,NH,dh,dh], n [B,NH,dh], m [B,NH]."""
    C, n, m = state
    m_new = torch.maximum(log_f_t + m, i_t)
    i_act = torch.exp(i_t - m_new)
    f_act = torch.exp(log_f_t + m - m_new)
    C = f_act[..., None, None] * C + i_act[..., None, None] \
        * (k_t[..., :, None] * v_t[..., None, :])
    n = f_act[..., None] * n + i_act[..., None] * k_t
    h_num = torch.einsum("bhij,bhi->bhj", C, q_t)
    h_den = torch.clamp_min(
        torch.einsum("bhi,bhi->bh", n, q_t).abs(), 1.0)
    return (C, n, m_new), h_num / h_den[..., None]


def mlstm_forward(p, cfg: ArchConfig, u, state=None, update_mask=None):
    s: SSMConfig = cfg.ssm
    B, T, D = u.shape
    d_in = s.expand * D
    NH = s.num_heads
    dh = d_in // NH
    x = rms_norm(p["norm"], u, cfg.norm_eps)
    xm, z = torch.chunk(dense(p["up_proj"], x), 2, dim=-1)
    conv_state = None if state is None else state["conv"]
    xc, new_conv = _causal_conv(xm, p["conv_w"], conv_state, update_mask)
    xc = F.silu(xc + p["conv_b"])
    xch = xc.reshape(B, T, NH, dh)
    xmh = xm.reshape(B, T, NH, dh)
    hw = lambda w, a: torch.einsum("bthd,hdk->bthk", a, w)
    q = (hw(p["wq"], xch) / math.sqrt(dh)).float()
    k = (hw(p["wk"], xch) / math.sqrt(dh)).float()
    v = hw(p["wv"], xmh).float()
    gif = dense(p["w_if"], xm).float()                 # [B,T,2NH]
    i_pre, f_pre = gif[..., :NH], gif[..., NH:]
    log_f = -_softplus(-f_pre)                         # log sigmoid(f)

    if state is None:
        f32 = dict(dtype=torch.float32, device=u.device)
        carry = (torch.zeros((B, NH, dh, dh), **f32),
                 torch.zeros((B, NH, dh), **f32),
                 torch.zeros((B, NH), **f32))
    else:
        carry = (state["C"], state["n"], state["m"])
    hs = []
    for t in range(T):
        new, h = _mlstm_cell_step(q[:, t], k[:, t], v[:, t], i_pre[:, t],
                                  log_f[:, t], carry)
        carry = new if update_mask is None else \
            _gate_carry(update_mask[:, t], new, carry)
        hs.append(h)
    C, n, m = carry
    h = torch.stack(hs, dim=1).reshape(B, T, d_in).to(u.dtype)
    h = rms_norm(p["out_norm"], h, cfg.norm_eps) + p["skip"] * xc
    h = h * F.silu(z)
    out = u + dense(p["down_proj"], h)
    return out, {"conv": new_conv, "C": C, "n": n, "m": m}


def mlstm_step(p, cfg: ArchConfig, u_t, state):
    return mlstm_forward(p, cfg, u_t, state)


# ===========================================================================
# sLSTM block (xLSTM) — scalar memory, recurrent gates
# ===========================================================================


def init_slstm(cfg: ArchConfig, *, device, generator):
    s: SSMConfig = cfg.ssm
    dt = _dtype(cfg)
    D = cfg.d_model
    NH = s.num_heads
    dh = D // NH
    ffn = max(1, int(D * 4 / 3))
    kw = dict(dtype=dt, device=device, generator=generator)
    return {
        "norm": init_rmsnorm(D, dtype=dt, device=device),
        "conv_w": _conv_weight(s.d_conv, D, **kw),
        "conv_b": torch.zeros((D,), dtype=dt, device=device),
        "w_gates": _init_dense(D, 4 * D, bias=True, **kw),
        # per-head recurrent gate matrices (block-diagonal R, paper eq. 30)
        "r_gates": _normal((NH, dh, 4 * dh), 1.0 / math.sqrt(dh), **kw),
        "group_norm": init_rmsnorm(D, dtype=dt, device=device),
        "ffn_up": _init_dense(D, 2 * ffn, **kw),
        "ffn_down": _init_dense(ffn, D, **kw),
    }


def _slstm_cell_step(r32, NH, wx_t, carry):
    """wx_t: [B,4D] input contribution; r32: the recurrent gate matrices
    [NH, dh, 4dh] in f32; carry: (c, n, h, m), each [B,D]."""
    c, n, h, m = carry
    B, D = h.shape
    rec = torch.einsum("bhd,hdk->bhk", h.reshape(B, NH, D // NH),
                       r32).reshape(B, 4 * D)
    i_pre, f_pre, z_pre, o_pre = torch.chunk(wx_t + rec, 4, dim=-1)
    log_f = -_softplus(-f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_act = torch.exp(i_pre - m_new)
    f_act = torch.exp(log_f + m - m_new)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    c = f_act * c + i_act * z
    n = f_act * n + i_act
    h_new = o * c / torch.clamp_min(n, 1.0)
    return (c, n, h_new, m_new), h_new


def slstm_forward(p, cfg: ArchConfig, u, state=None, update_mask=None):
    B, T, D = u.shape
    x = rms_norm(p["norm"], u, cfg.norm_eps)
    conv_state = None if state is None else state["conv"]
    xc, new_conv = _causal_conv(x, p["conv_w"], conv_state, update_mask)
    xc = F.silu(xc + p["conv_b"])
    wx = dense(p["w_gates"], xc).float()               # [B,T,4D]
    r32 = p["r_gates"].float()

    if state is None:
        zeros = torch.zeros((B, D), dtype=torch.float32, device=u.device)
        carry = (zeros, zeros, zeros, zeros)
    else:
        carry = (state["c"], state["n"], state["h"], state["m"])
    hs = []
    for t in range(T):
        new, h = _slstm_cell_step(r32, cfg.ssm.num_heads, wx[:, t], carry)
        carry = new if update_mask is None else \
            _gate_carry(update_mask[:, t], new, carry)
        hs.append(h)
    c, n, h, m = carry
    y = torch.stack(hs, dim=1).to(u.dtype)
    y = rms_norm(p["group_norm"], y, cfg.norm_eps)
    u = u + y
    # gated FFN (projection factor 4/3, paper App. figure)
    gate, up = torch.chunk(dense(p["ffn_up"], u), 2, dim=-1)
    u = u + dense(p["ffn_down"], F.gelu(gate, approximate="tanh") * up)
    return u, {"conv": new_conv, "c": c, "n": n, "h": h, "m": m}


def slstm_step(p, cfg: ArchConfig, u_t, state):
    return slstm_forward(p, cfg, u_t, state)
