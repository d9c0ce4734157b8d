"""Layers of every decoder: norms, RoPE, the sinusoidal table, the MLPs
and MoE.

Plain functions on tensors, mirroring ``repro.models.layers`` one for
one.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.tp import all_reduce, tp_axis, tp_rank


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def norm_fwd(p, x, kind: str, eps: float = 1e-6):
    """RMSNorm (or LayerNorm) computed in f32 and cast back to x's dtype."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def rms_head_norm(p, x, eps: float = 1e-6):
    """Per-head q/k rmsnorm (qwen3). x: (..., hd)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p.float()).to(x.dtype)


# --------------------------------------------------------------------------
# position embeddings
# --------------------------------------------------------------------------
def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                fraction: float = 1.0):
    """positions: (..., T) int -> (sin, cos) of shape (..., T, rot/2)."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    ar = torch.arange(0, rot, 2, dtype=torch.float32,
                      device=positions.device)
    freqs = 1.0 / (theta ** (ar / rot))
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """x: (B, T, H, hd); sin/cos: (B, T, r/2) or (T, r/2).

    Rotates *interleaved* even/odd pairs (x[..., 0::2], x[..., 1::2]) as
    the reference does, not the rotate-half split."""
    rot2 = sin.shape[-1]
    xr, xp = x[..., : 2 * rot2], x[..., 2 * rot2:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    if sin.dim() == 2:
        s, c = sin[None, :, None, :], cos[None, :, None, :]
    else:
        s, c = sin[:, :, None, :], cos[:, :, None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp.to(out.dtype)], dim=-1).to(x.dtype)


def sinusoidal_table(length: int, dim: int, device=None):
    """(length, dim) f32 sin|cos table, computed in float64 numpy as the
    reference does and only then rounded to f32."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / dim)
    tab = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.tensor(tab.astype(np.float32), device=device)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _mlp_out(h, p, cfg: ModelConfig):
    """Down-projection; in a sharded step a *sharded* ffn dim yields
    partial sums that are summed over the shards so the residual add
    sees the replicated value.  A dim the width did not divide is
    replicated (``p["wo"]`` is full-width) and must not be summed."""
    y = h @ p["wo"]
    if tp_axis() is not None and p["wo"].shape[0] != cfg.d_ff:
        y = all_reduce(y)
    return y


def mlp_fwd(p, x, cfg: ModelConfig):
    """Returns (y, aux_loss).  aux_loss is the MoE load-balance term (0
    for dense MLPs)."""
    if cfg.moe_experts:
        return moe_fwd(p, x, cfg)
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif cfg.mlp == "geglu":
        h = _gelu(x @ p["wg"]) * (x @ p["wi"])
    elif cfg.mlp == "squared_relu":
        h = torch.square(F.relu(x @ p["wi"]))
    elif cfg.mlp == "gelu":
        h = _gelu(x @ p["wi"])
    else:
        raise ValueError(cfg.mlp)
    return _mlp_out(h, p, cfg), 0.0


# --------------------------------------------------------------------------
# MoE (GShard-style top-k dispatch with per-expert capacity buffers)
# --------------------------------------------------------------------------
def moe_route(p, xf, cfg: ModelConfig, capacity_factor: float):
    """The routing decisions of ``repro.models.layers.moe_fwd`` for the
    flat tokens ``xf`` (S, dm): router probabilities, the top-k experts
    and weights of each token, each (token, k) slot's rank within its
    expert, and whether that rank fits the capacity.

    Ties in the top k go to the lower expert index, as ``jax.lax.top_k``
    orders them (``torch.topk`` leaves tie order unspecified), and ranks
    follow the stable sort of the flat expert ids, so every token of a
    batch, pads and inactive slots included, competes for capacity in
    the same order as in the reference.  Returns a dict with ``probs``
    (S, E) f32, ``gate_w`` (S, K) f32 (0 where dropped), ``gate_idx``
    and ``pos_in_e`` (S, K) int64, ``keep`` (S, K) bool and ``cap``."""
    S = xf.shape[0]
    E, K = cfg.moe_experts, cfg.moe_top_k
    logits = (xf @ p["router"]).float()                      # (S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    gate_w, gate_idx = gate_w[:, :K], gate_idx[:, :K]        # (S, K)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp(min=1e-9)

    cap = max(int(math.ceil(S * K / E * capacity_factor)), 4)
    # rank of each (token, k) slot within its expert: position in the
    # stable sort by expert id, minus the start of the expert's segment
    n = S * K
    flat_e = gate_idx.reshape(n)
    order = torch.argsort(flat_e, stable=True)
    idx = torch.arange(n, device=xf.device)
    sorted_e = flat_e[order]
    first = torch.ones(n, dtype=torch.bool, device=xf.device)
    first[1:] = sorted_e[1:] != sorted_e[:-1]
    seg_start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    pos_flat = torch.empty_like(idx)
    pos_flat[order] = idx - seg_start
    pos_in_e = pos_flat.reshape(S, K)
    keep = pos_in_e < cap
    return {"probs": probs, "gate_w": gate_w * keep.to(gate_w.dtype),
            "gate_idx": gate_idx, "pos_in_e": pos_in_e, "keep": keep,
            "cap": cap}


def moe_fwd(p, x, cfg: ModelConfig, capacity_factor: Optional[float] = None):
    """x: (B, T, dm) -> (y, aux_loss), as ``repro.models.layers.moe_fwd``
    computes it: every expert runs its whole capacity buffer (E, cap, dm),
    so a step reads every expert's weights.

    Expert parallelism: in a sharded step each shard owns the contiguous
    expert slice ``[rank * E_local, (rank + 1) * E_local)``.  The router,
    top-k and capacity ranking are computed from replicated activations,
    so every shard agrees on the global dispatch; the shard keeps only its
    own experts' slots (dropped and foreign slots add zero at
    ``E_local - 1``) and the combine is summed over the shards, so each
    token's K contributions count exactly once."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    B, T, dm = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    E_local = p["wi"].shape[0]
    group = tp_axis() if E_local != E else None
    if E_local != E and group is None:
        raise ValueError(f"an expert slice ({E_local} of {E} experts) runs "
                         f"only as a shard of a sharded step "
                         f"(models.tp.tp_context)")
    S = B * T
    xf = x.reshape(S, dm)
    r = moe_route(p, xf, cfg, capacity_factor)
    keep, cap, gate_w = r["keep"], r["cap"], r["gate_w"]
    e_off = 0
    if group is not None:
        e_off = tp_rank() * E_local
        local = (r["gate_idx"] >= e_off) & (r["gate_idx"] < e_off + E_local)
        keep = keep & local
        gate_w = gate_w * local.to(gate_w.dtype)

    # dispatch: kept slots land at (expert, rank); dropped slots add zero
    # at (E_local - 1, clipped rank), as the reference's scatter-add does.
    # A kept slot has exactly one writer, so the accumulation order of the
    # atomics cannot change a bit.
    e_idx = torch.where(keep, r["gate_idx"] - e_off, E_local - 1)
    c_idx = r["pos_in_e"].clamp(0, cap - 1)
    buf = torch.zeros((E_local, cap, dm), dtype=x.dtype, device=x.device)
    buf.index_put_((e_idx, c_idx),
                   xf[:, None, :] * keep[..., None].to(x.dtype),
                   accumulate=True)

    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wi"])
    out_e = torch.bmm(h, p["wo"])                        # (E_local, cap, dm)

    # combine: each token's K expert outputs, weighted, summed over K
    gathered = out_e[e_idx, c_idx]                           # (S, K, dm)
    yf = (gathered * gate_w[..., None].to(x.dtype)).sum(dim=1)
    if group is not None:
        yf = all_reduce(yf)
    aux = moe_load_balance_loss(r["probs"], r["gate_idx"], E, K)
    return yf.reshape(B, T, dm), aux


def moe_load_balance_loss(probs, gate_idx, E, K):
    """Switch-style load-balance aux loss."""
    me = probs.mean(dim=0)                                   # (E,)
    ce = F.one_hot(gate_idx[:, 0], E).float().mean(dim=0)
    return E * (me * ce).sum()
