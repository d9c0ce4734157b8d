"""Training step factory + loop.

The port of ``repro.training.train``.  ``make_train_step`` builds the
(params, opt_state, batch) -> (params, opt_state, metrics) function with
optional gradient-accumulation microbatching and rematerialized layer
groups (see ``models.model.forward(remat=...)``).  Params and optimizer
state are updated in place (``training.optimizer.adamw_update``) and
returned.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.utils.tree import tree_leaves, tree_unflatten


def batch_to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    num_microbatches: int = 1, remat: bool = True,
                    params_view: Optional[Callable] = None,
                    on_microbatch: Optional[Callable[[int], None]] = None):
    """With one microbatch the gradients come out in the params' dtype,
    as ``jax.value_and_grad`` gives them; with several they accumulate in
    f32 over equal slices of the batch's axis 0 and, like the loss, are
    divided by the count.  ``params_view`` maps the params tree (its
    leaves requiring grad) to what ``loss_fn`` reads (the dryrun gathers
    sharded weights there); ``on_microbatch(i)`` is called once
    microbatch ``i``'s gradients are taken in."""

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tree = tree_unflatten(params, leaves)
        loss, _ = loss_fn(params_view(tree) if params_view else tree, cfg,
                          batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    def compute_grads(params, batch):
        if num_microbatches <= 1:
            loss, grads = grads_of(params, batch)
            if on_microbatch is not None:
                on_microbatch(0)
            return loss, tree_unflatten(params, grads)
        n = num_microbatches
        acc_loss = torch.zeros((), dtype=torch.float32,
                               device=batch["labels"].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        for i in range(n):
            mb = {k: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]
                  for k, x in batch.items()}
            loss, grads = grads_of(params, mb)
            acc_loss += loss
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
            if on_microbatch is not None:
                on_microbatch(i)
        inv = 1.0 / n
        for a in acc:
            a.mul_(inv)
        return acc_loss * inv, tree_unflatten(params, acc)

    def train_step(params, opt_state, batch):
        dev = tree_leaves(params)[0].device
        batch = batch_to_device(batch, dev)
        loss, grads = compute_grads(params, batch)
        params, opt_state, om = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def train_loop(cfg: ModelConfig, params, batches, opt_cfg=AdamWConfig(),
               steps: int = 100, log_every: int = 10,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 0) -> Dict:
    """Train on the params' device (remat on, one microbatch), logging
    ``{"step", "loss", "lr", "elapsed"}`` every ``log_every`` steps and at
    the last; ``batches`` yields numpy (or tensor) batches."""
    from repro_torch.training.checkpoint import save_checkpoint
    step_fn = make_train_step(cfg, opt_cfg)
    opt_state = adamw_init(params, opt_cfg)
    history = []
    t0 = time.time()
    for i in range(steps):
        batch = next(batches)
        params, opt_state, m = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            history.append({"step": i, "loss": float(m["loss"]),
                            "lr": float(m["lr"]),
                            "elapsed": time.time() - t0})
        if checkpoint_dir and checkpoint_every and (i + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, params, opt_state, i + 1)
    return {"params": params, "opt_state": opt_state, "history": history}
