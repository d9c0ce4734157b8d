"""The run's weights, drawn from ``--seed`` on the device in the type they
are served in, one draw per stacked leaf of the kind's ``layout`` (its
``reference/<kind>.py``).

The kind's ``tree`` lays the stacks out as the port's parameter tree
(``repro_torch.models.model.init_params``), so that ``EngineBackend``
takes it as it is; each layer's leaves are views of the stacked draws.
The reference reads the same tensors: they are the benchmark's inputs,
not something the program made.  ``fill`` draws a seed into stacks that
already exist (the same numbers ``make`` gives), so a tool that serves
several seeds keeps its captured graphs.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def allocate(layout: dict, device, dtype) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(shape, device=device, dtype=dtype)
            for k, (shape, _) in layout.items()}


def fill(stacks: Dict[str, torch.Tensor], layout: dict, seed: int) -> None:
    """Draw ``seed``'s weights into ``stacks``, one call a stack: N(0,
    std^2), or 1 + N(0, 0.1^2) for a norm's "scale"."""
    g = torch.Generator(device=next(iter(stacks.values())).device)
    g.manual_seed(seed)
    for k, (shape, std) in layout.items():
        t = torch.randn(shape, generator=g, out=stacks[k])
        if std == "scale":
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(std)


def make(layout: dict, tree: Callable, seed: int, device,
         dtype=torch.bfloat16):
    """(the parameter tree, its stacks) for ``seed``."""
    stacks = allocate(layout, device, dtype)
    fill(stacks, layout, seed)
    return tree(stacks), stacks


def nbytes(stacks: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in stacks.values())
