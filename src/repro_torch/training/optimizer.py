"""AdamW with decoupled weight decay + cosine schedule.

The port of ``repro.training.optimizer``: the same config, schedule,
state and update rule.  The learning rate, the clip scale and the bias
corrections are f32 tensors on the params' device, as the reference's
``jnp`` computes them.  ``adamw_update`` writes the params and moments
in place under ``torch.no_grad()`` and returns the same objects: a
functional copy of a multi-billion-parameter model's params and f32
moments would not fit beside them on one card.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils.tree import tree_leaves, tree_map
from repro_torch.utils.device import torch_dtype


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # "bfloat16" halves optimizer memory
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up then cosine decay, as an f32 tensor on ``step``'s
    device (``step``: an int, or an int tensor)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def adamw_init(params, cfg: AdamWConfig = AdamWConfig(),
               abstract: bool = False):
    """Zero moments shaped like ``params`` at ``cfg.moment_dtype`` on each
    leaf's device, and an int32 step counter on the first leaf's.
    ``abstract=True`` (or ``meta`` params) builds the same state as
    ``meta`` tensors: shapes and dtypes for the dryrun, no storage."""
    mdt = torch_dtype(cfg.moment_dtype)
    meta = torch.device("meta")

    def zeros_like(x):
        return torch.zeros(x.shape, dtype=mdt,
                           device=meta if abstract else x.device)

    dev = meta if abstract else tree_leaves(params)[0].device
    return {"m": tree_map(zeros_like, params),
            "v": tree_map(zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, taken in f32, one f32
    temporary of a leaf at a time.  (``torch.linalg.vector_norm`` is not
    used: on the CPU it sums in f32 without cascading, about 1e-5
    relative off on a million elements.)"""
    return torch.sqrt(sum(x.to(torch.float32, copy=True).square_().sum()
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step: clip ``grads`` to ``cfg.grad_clip`` global norm,
    update the moments and params in place, and return
    ``(params, opt_state, {"lr", "grad_norm"})`` (the same objects).
    Every leaf's arithmetic is the reference's, in f32, with at most two
    f32 temporaries of the leaf's size (four with bf16 moments)."""
    step = opt_state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    f32 = torch.float32
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"]), tree_leaves(params)):
        u = g.to(f32, copy=True).mul_(scale)
        m32 = m if m.dtype == f32 else m.float()
        v32 = v if v.dtype == f32 else v.float()
        m32.mul_(cfg.b1).add_(u, alpha=1 - cfg.b1)
        v32.mul_(cfg.b2).addcmul_(u, u, value=1 - cfg.b2)
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)
        # u <- sqrt(v / bc2) + eps;  d <- (m / bc1) / u + wd * p
        torch.div(v32, bc2, out=u).sqrt_().add_(cfg.eps)
        d = torch.div(m32, bc1).div_(u)
        del u, m32, v32
        d.add_(p, alpha=cfg.weight_decay)
        # p <- p - lr * d, rounded once to p's dtype
        p.copy_(d.mul_(lr).neg_().add_(p))
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
