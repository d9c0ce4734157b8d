"""Weights and arrays from the JAX package, as torch tensors.

``params_from_jax`` maps the pytree ``repro.models.model.init_params``
builds, passed in as numpy arrays, onto the port's parameter dict, so
the two packages can be run on the same weights.  Nothing here imports
JAX or ``ml_dtypes``: JAX's bfloat16 / float8 numpy arrays are
reinterpreted by their raw bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.utils.device import resolve_device

# numpy dtype name -> (same-width integer view, torch dtype of the bits)
_BITCAST = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}


def to_torch(a, device=None) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor on
    ``device``, keeping its dtype: bfloat16 goes through ``.view(int16)``
    and float8-e4m3 through ``.view(uint8)``, so no extension dtype
    package is needed on either side."""
    if isinstance(a, torch.Tensor):
        return a.to(resolve_device(device))
    a = np.ascontiguousarray(np.asarray(a))
    dev = resolve_device(device)
    cast = _BITCAST.get(a.dtype.name)
    if cast is not None:
        np_int, t_dtype = cast
        return torch.from_numpy(a.view(np_int).copy()).view(t_dtype).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def params_from_jax(np_params, cfg: ModelConfig, device=None):
    """Map the JAX ``init_params`` pytree (leaves as numpy arrays) to the
    port's parameters.  Layer ``g * len(pattern) + i`` takes group ``g``
    of ``np_params["blocks"][i]``; every weight keeps its (in, out)
    orientation."""
    dev = resolve_device(device)

    def conv(tree, g=None):
        if isinstance(tree, dict):
            return {k: conv(v, g) for k, v in tree.items()}
        return to_torch(tree if g is None else np.asarray(tree)[g], dev)

    pattern = cfg.layer_pattern
    layers = []
    for layer in range(cfg.n_layers):
        g, i = divmod(layer, len(pattern))
        layers.append(conv(np_params["blocks"][i], g))
    out = {"embed": conv(np_params["embed"]), "layers": layers,
           "final_norm": conv(np_params["final_norm"])}
    if "lm_head" in np_params:
        out["lm_head"] = conv(np_params["lm_head"])
    return out
