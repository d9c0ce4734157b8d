"""One device's share of every input of a dryrun step.

The port of ``repro.launch.specs``.  ``input_specs(cfg, shape)`` builds
the abstract inputs of the step an input shape selects, as ``meta``
tensors; the ``*_shardings`` walkers give each leaf of the port's trees a
``NamedSharding`` on a device-free layout from the arch's
``ShardingRules``, dropping mesh axes that do not divide a dimension
(see ``utils.sharding``).

``cache_spec``, ``batch_spec``, ``effective_window`` and
``LONG_CONTEXT_WINDOW`` are verbatim copies of the reference, and so is
``param_spec`` but for the line that sets ``lead``: the port's layers are
a list of per-layer trees (``params["layers"][l]``, and
``params["encoder"][l]``), not stacks with a leading group dim, so no
leaf has a stack dim to skip.  A per-layer leaf's spec is the stacked
leaf's without its leading ``None``, so per-device bytes agree.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.launch.mesh import data_axes
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_cache, init_params
from repro_torch.utils.sharding import Mesh, NamedSharding, P, spec_for

# sliding-window fallback that makes long_500k decodable on full-attention
# archs (see DESIGN.md §long_500k applicability)
LONG_CONTEXT_WINDOW = 8192


def _names_of(tree, names=()):
    """(names, leaf) of every leaf in leaf order: the dict keys (str) and
    sequence positions (int) on its path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _names_of(v, names + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _names_of(v, names + (i,))
    else:
        yield list(names), tree


_REPLICATED = {
    "scale", "bias", "conv_b", "A_log", "D", "dt_bias", "lam",
    "b_a", "b_x", "q_norm", "k_norm", "bq", "bk", "bv", "norm", "step",
}


def param_spec(names, shape, cfg: ModelConfig, mesh: Mesh,
               train: bool = False) -> P:
    """PartitionSpec for one parameter leaf, identified by its tree path."""
    rules = cfg.sharding
    str_names = [n for n in names if isinstance(n, str)]
    name = str_names[-1]
    parent = str_names[-2] if len(str_names) > 1 else ""
    d_axes = data_axes(mesh)
    model = ("model",)
    fsdp: Tuple[str, ...] = tuple(
        a for ax in (rules.fsdp if train else ())
        for a in (d_axes if ax == "data" else (ax,)))
    expert_sharded = bool(rules.experts)

    # leading stack dims (group scan / encoder layer stack)
    lead = 0                            # the port's layers are not stacked
    core = shape[lead:]

    def mk(*dims):
        assert len(dims) == len(core), (names, shape, dims)
        return spec_for(mesh, [(d, a) for d, a in zip(core, dims)])

    if name in _REPLICATED:
        spec = P()
    elif name == "conv_w":
        spec = mk(None, model)
    elif name == "embed":
        spec = mk(model, fsdp or None)
    elif name == "lm_head":
        spec = mk(fsdp or None, model)
    elif name == "pos_embed":
        spec = mk(None, fsdp or None)
    elif name in ("wq", "wk", "wv", "in_proj", "w_gate", "w_in"):
        spec = mk(fsdp or None, model)
    elif name in ("w_a", "w_x"):
        spec = mk(None, model)
    elif name in ("out_proj", "w_out"):
        spec = mk(model, fsdp or None)
    elif name == "router":
        spec = mk(fsdp or None, None)
    elif name in ("wi", "wg") and len(core) == 3:       # MoE (E, dm, ff)
        spec = (mk(model, fsdp or None, None) if expert_sharded
                else mk(None, fsdp or None, model))
    elif name == "wo" and len(core) == 3:               # MoE (E, ff, dm)
        spec = (mk(model, None, fsdp or None) if expert_sharded
                else mk(None, model, fsdp or None))
    elif name in ("wi", "wg"):                          # dense (dm, ff)
        spec = mk(fsdp or None, model)
    elif name == "wo":                                  # (X, dm)
        spec = mk(model, fsdp or None)
    else:
        raise ValueError(f"no sharding rule for param {names} {shape}")
    # prepend None for the stack dim
    if lead:
        spec = P(*((None,) * lead + tuple(spec)))
    return spec


def cache_spec(names, shape, cfg: ModelConfig, mesh: Mesh) -> P:
    """KV/state cache sharding: batch over data; kv-heads over model when
    divisible, otherwise the *sequence* dim shards over model (flash-
    decoding style) so large caches always fit."""
    str_names = [n for n in names if isinstance(n, str)]
    name = str_names[-1]
    d_axes = data_axes(mesh)
    in_tail = "tail" in str_names
    in_cross = "cross" in str_names
    lead = 0 if in_tail else 1          # (G, B, ...) / cross (L, B, ...)
    core = shape[lead:]

    def mk(*dims):
        assert len(dims) == len(core), (names, shape, dims)
        return spec_for(mesh, [(d, a) for d, a in zip(core, dims)])

    if name in ("k", "v", "xk", "xv"):
        B, S, KV, HD = core
        n_model = mesh.shape["model"]
        if KV % n_model == 0:
            spec = mk(d_axes, None, ("model",), None)
        else:
            spec = mk(d_axes, ("model",), None, None)
    elif name == "pos":
        B, S = core
        n_model = mesh.shape["model"]
        kv_shardable = cfg.n_kv_heads % n_model == 0
        spec = mk(d_axes, None if kv_shardable else ("model",))
    elif name == "state":       # (B, H, P, N)
        spec = mk(d_axes, ("model",), None, None)
    elif name == "conv":        # (B, K-1, C)
        spec = mk(d_axes, None, ("model",))
    elif name == "h":           # (B, W)
        spec = mk(d_axes, ("model",))
    else:
        raise ValueError(f"no cache sharding rule for {names} {shape}")
    if lead:
        spec = P(*((None,) * lead + tuple(spec)))
    return spec


def batch_spec(name: str, shape, mesh: Mesh) -> P:
    d_axes = data_axes(mesh)
    if name in ("tokens", "labels"):
        return spec_for(mesh, [(shape[0], d_axes), (shape[1], None)])
    if name in ("extra_embeds", "frames"):
        return spec_for(mesh, [(shape[0], d_axes)] + [(s, None) for s in shape[1:]])
    if name in ("pos_offset", "active"):
        return spec_for(mesh, [(shape[0], d_axes)])
    raise ValueError(name)


# --------------------------------------------------------------------------
def tree_shardings(tree, mesh: Mesh, fn, names=()):
    """``tree``'s structure with ``NamedSharding(mesh, fn(names, shape))``
    at every leaf."""
    if isinstance(tree, dict):
        return {k: tree_shardings(v, mesh, fn, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_shardings(v, mesh, fn, names + (i,))
                          for i, v in enumerate(tree))
    return NamedSharding(mesh, fn(list(names), tuple(tree.shape)))


def param_shardings(params, cfg, mesh, train=False):
    return tree_shardings(params, mesh,
                          lambda n, s: param_spec(n, s, cfg, mesh, train))


def cache_shardings(cache, cfg, mesh):
    return tree_shardings(cache, mesh, lambda n, s: cache_spec(n, s, cfg, mesh))


def opt_shardings(opt_state, params, cfg, mesh):
    """Moments mirror the parameter shardings; step is replicated."""
    pshard = param_shardings(params, cfg, mesh, train=True)
    return {"m": pshard, "v": pshard, "step": NamedSharding(mesh, P())}


def batch_shardings(batch, mesh):
    return {k: NamedSharding(mesh, batch_spec(k, v.shape, mesh))
            for k, v in batch.items()}


def shard_bytes(tree, shardings) -> int:
    """One device's bytes of ``tree`` under ``shardings`` (same structure)."""
    total = 0
    for (_, leaf), (_, sh) in zip(_names_of(tree), _names_of(shardings)):
        n = 1
        for d in sh.shard_shape(tuple(leaf.shape)):
            n *= d
        total += n * leaf.dtype.itemsize
    return total


# --------------------------------------------------------------------------
# abstract inputs per (arch, input-shape)
# --------------------------------------------------------------------------
def effective_window(cfg: ModelConfig, shape: InputShape) -> Optional[int]:
    """long_500k on a full-attention arch runs the sliding-window variant."""
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return LONG_CONTEXT_WINDOW
    return None


def input_specs(cfg: ModelConfig, shape: InputShape):
    """Abstract (``meta``) inputs for the selected step, at global shapes.

    Returns (kind, dict-of-abstract-args).
    """
    B, S = shape.global_batch, shape.seq_len
    i32, bf16, meta = torch.int32, torch.bfloat16, torch.device("meta")

    def tok(b, s):
        return torch.empty((b, s), dtype=i32, device=meta)

    params = init_params(cfg, abstract=True)
    n_extra = cfg.num_patches if cfg.arch_type == "vlm" else 0
    out = {"params": params}

    if shape.step == "train":
        batch = {"tokens": tok(B, S - n_extra), "labels": tok(B, S)}
        if cfg.arch_type == "vlm":
            batch["extra_embeds"] = torch.empty(
                (B, n_extra, cfg.d_model), dtype=bf16, device=meta)
        if cfg.arch_type == "audio":
            batch["frames"] = torch.empty(
                (B, cfg.encoder_len, cfg.d_model), dtype=bf16, device=meta)
        out["batch"] = batch
        return "train", out

    wo = effective_window(cfg, shape)
    out["cache"] = init_cache(cfg, B, S, abstract=True, window_override=wo)
    if shape.step == "prefill":
        out["tokens"] = tok(B, S - n_extra)
        if cfg.arch_type == "vlm":
            out["extra_embeds"] = torch.empty(
                (B, n_extra, cfg.d_model), dtype=bf16, device=meta)
        if cfg.arch_type == "audio":
            out["frames"] = torch.empty(
                (B, cfg.encoder_len, cfg.d_model), dtype=bf16, device=meta)
        return "prefill", out

    # decode: ONE new token against a cache of S tokens
    out["tokens"] = tok(B, 1)
    out["pos_offset"] = torch.empty((B,), dtype=i32, device=meta)
    return "decode", out
