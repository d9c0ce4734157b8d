"""Weights and arrays from the JAX package, as torch tensors.

``params_from_jax`` maps the pytree ``repro.models.model.init_params``
builds, passed in as numpy arrays, onto the port's parameter dict, so
the two packages can be run on the same weights (and
``opt_state_from_jax`` the AdamW state the same way), and
``checkpoint_from_jax`` reads a checkpoint file the reference's
``save_checkpoint`` wrote.  Nothing here imports JAX or ``ml_dtypes``:
JAX's bfloat16 / float8 numpy arrays are reinterpreted by their raw bits.
"""
from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_items, tree_unflatten

# numpy dtype name -> (same-width integer view, torch dtype of the bits)
_BITCAST = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}


#: raw-bits integer type of a numpy void (``|V<n>``) element, by its size
_VOID_BITS = {1: np.uint8, 2: np.int16, 4: np.int32}


def to_torch(a, device=None, bits_as: Optional[torch.dtype] = None) \
        -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor on
    ``device``, keeping its dtype: bfloat16 goes through ``.view(int16)``
    and float8-e4m3 through ``.view(uint8)``, so no extension dtype
    package is needed on either side.  An array numpy reads without
    ``ml_dtypes`` holds such elements as raw bytes (``|V2``, ``|V1``):
    those are the bits of ``bits_as``, which must be given and of the
    same width."""
    if isinstance(a, torch.Tensor):
        return a.to(resolve_device(device))
    a = np.ascontiguousarray(np.asarray(a))
    dev = resolve_device(device)
    cast = _BITCAST.get(a.dtype.name)
    if cast is not None:
        np_int, t_dtype = cast
        return torch.from_numpy(a.view(np_int).copy()).view(t_dtype).to(dev)
    if a.dtype.kind == "V":
        width = a.dtype.itemsize
        if bits_as is None or bits_as.itemsize != width \
                or width not in _VOID_BITS:
            raise ValueError(f"{width}-byte raw elements cannot be read "
                             f"as {bits_as}")
        return torch.from_numpy(a.view(_VOID_BITS[width]).copy()) \
            .view(bits_as).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def params_from_jax(np_params, cfg: ModelConfig, device=None,
                    template=None):
    """Map the JAX ``init_params`` pytree (leaves as numpy arrays) to the
    port's parameters.  Layer ``g * len(pattern) + i`` takes group ``g``
    of ``np_params["blocks"][i]``, and layer ``n_groups * len(pattern) +
    j`` the tail block ``np_params["tail"][j]``; encoder layer ``l`` takes
    entry ``l`` of every ``np_params["encoder"]`` stack.  Every weight
    keeps its (in, out) orientation.  ``template`` (a port params tree,
    e.g. ``init_params(cfg, abstract=True)``) gives each leaf's dtype
    where numpy holds raw bytes (see ``to_torch``)."""
    dev = resolve_device(device)

    def conv(tree, tmpl, g=None):
        if isinstance(tree, dict):
            return {k: conv(v, None if tmpl is None else tmpl[k], g)
                    for k, v in tree.items()}
        return to_torch(tree if g is None else np.asarray(tree)[g], dev,
                        bits_as=None if tmpl is None else tmpl.dtype)

    def at(*keys):
        t = template
        for k in keys:
            if t is None:
                return None
            t = t[k]
        return t

    pattern = cfg.layer_pattern
    layers = []
    for layer in range(cfg.n_groups * len(pattern)):
        g, i = divmod(layer, len(pattern))
        layers.append(conv(np_params["blocks"][i], at("layers", layer), g))
    base = len(layers)
    layers.extend(conv(tb, at("layers", base + j))
                  for j, tb in enumerate(np_params.get("tail", ())))
    out = {"embed": conv(np_params["embed"], at("embed")), "layers": layers,
           "final_norm": conv(np_params["final_norm"], at("final_norm"))}
    for key in ("lm_head", "enc_norm", "pos_embed"):
        if key in np_params:
            out[key] = conv(np_params[key], at(key))
    if "encoder" in np_params:
        out["encoder"] = [conv(np_params["encoder"], at("encoder", l), l)
                          for l in range(cfg.encoder_layers)]
    return out


def opt_state_from_jax(np_opt_state, cfg: ModelConfig, device=None,
                       template=None):
    """The reference's AdamW state ``{"m", "v", "step"}`` (leaves as numpy
    arrays) as the port's: ``m`` and ``v`` map like the params, ``step``
    becomes an int32 tensor.  ``template``: a port AdamW state, as for
    ``params_from_jax``."""
    dev = resolve_device(device)
    tm = None if template is None else template["m"]
    tv = None if template is None else template["v"]
    return {"m": params_from_jax(np_opt_state["m"], cfg, dev, tm),
            "v": params_from_jax(np_opt_state["v"], cfg, dev, tv),
            "step": torch.tensor(np.asarray(np_opt_state["step"]),
                                 dtype=torch.int32, device=dev)}


_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _insert(tree: dict, keystr: str, leaf) -> None:
    """Place ``leaf`` in nested dicts at a ``jax.tree_util.keystr`` path
    (``['blocks'][0]['mixer']['wq']``); sequence indices become int keys."""
    parts = [m.group(1) if m.group(1) is not None else int(m.group(2))
             for m in _KEY.finditer(keystr)]
    if "".join(f"[{p!r}]" for p in parts) != keystr:
        raise ValueError(f"not a keystr path: {keystr!r}")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = leaf


def _tuples(tree):
    """Nested dicts whose keys are 0..n-1 become tuples, as the
    reference's pytrees hold pattern positions and tail blocks."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _tuples(v) for k, v in tree.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"sequence indices {sorted(out)} have gaps")
        return tuple(out[i] for i in range(len(out)))
    return out


def _like(tree, template, what: str):
    """``tree``'s leaves in ``template``'s structure and order, each of
    the template's shape and dtype, or ``ValueError``."""
    got, want = dict(tree_items(tree)), list(tree_items(template))
    if set(got) != {k for k, _ in want}:
        raise ValueError(f"{what}: the file's leaves do not map onto the "
                         f"port's tree")
    for key, b in want:
        a = got[key]
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise ValueError(f"{what}{key}: {a.dtype} {tuple(a.shape)} in "
                             f"the file, {b.dtype} {tuple(b.shape)} in the "
                             f"port's template")
    return tree_unflatten(template, [got[k] for k, _ in want])


def checkpoint_from_jax(path: str, cfg: ModelConfig, device=None,
                        opt_cfg=None):
    """Read a checkpoint written by the reference's
    ``repro.training.checkpoint.save_checkpoint`` and return the port's
    ``(params, opt_state, step)``.

    The file holds ``p``- and ``o``-prefixed ``keystr`` paths of the
    stacked pytrees and ``__step__``; the stacks are unstacked per layer
    by ``params_from_jax`` / ``opt_state_from_jax``.  bfloat16 leaves,
    which numpy reads without ``ml_dtypes`` as 2-byte raw elements, are
    read as the bits of the dtype the port's template gives the leaf
    (``init_params(cfg, abstract=True)``, and ``adamw_init`` at
    ``opt_cfg.moment_dtype`` for the moments); every leaf must then have
    the template's shape and dtype, or ``ValueError`` is raised."""
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import AdamWConfig, adamw_init

    opt_cfg = AdamWConfig() if opt_cfg is None else opt_cfg
    dev = resolve_device(device)
    trees = {"p": {}, "o": {}}
    with np.load(path, allow_pickle=False) as blob:
        step = int(blob["__step__"])
        for key in blob.files:
            if key == "__step__":
                continue
            if key[:1] not in trees:
                raise ValueError(f"{path}: unexpected entry {key!r}")
            _insert(trees[key[0]], key[1:], blob[key])
    p_tmpl = init_params(cfg, abstract=True)
    o_tmpl = adamw_init(p_tmpl, opt_cfg, abstract=True)
    params = params_from_jax(_tuples(trees["p"]), cfg, dev, p_tmpl)
    opt = opt_state_from_jax(_tuples(trees["o"]), cfg, dev, o_tmpl)
    return (_like(params, p_tmpl, "params"), _like(opt, o_tmpl, "opt_state"),
            step)
