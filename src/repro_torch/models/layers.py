"""Layers of the dense paged-KV path: norms, RoPE, the SwiGLU MLP.

Plain functions on tensors, mirroring ``repro.models.layers`` one for
one.  MoE (``moe_fwd``) is not ported yet (ROADMAP.md queue A item 8).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


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


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def mlp_fwd(p, x, cfg: ModelConfig):
    """SwiGLU ``silu(x @ wg) * (x @ wi) @ wo``.  Returns (y, aux_loss);
    aux_loss is the MoE load-balance term, 0 for a dense MLP."""
    if cfg.moe_experts:
        raise NotImplementedError("MoE is not ported yet "
                                  "(ROADMAP.md queue A item 8)")
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
        return h @ p["wo"], 0.0
    raise NotImplementedError(f"mlp={cfg.mlp!r} is not ported yet; the "
                              f"dense paged path serves SwiGLU models")
