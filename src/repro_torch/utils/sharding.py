"""Parallelism bookkeeping the cost model reads, and the tensor-parallel
layout of a sharded instance.

``_warn_once``, ``AchievedParallelism`` and ``achieved_parallelism`` are
verbatim copies of ``repro.utils.sharding``.  ``tp_param_specs`` and
``tp_cache_specs`` follow the reference's Megatron rules, but where it
builds ``PartitionSpec`` trees for a device mesh they give each leaf the
dim its shards split, counted from the end, or ``None`` (replicated);
``shard_params`` cuts one shard out of a tree by such specs.

The mesh helpers the dryrun reads (``_axis_size``, ``best_divisible_axes``,
``spec_for``, ``named_sharding``, ``replicated``) are verbatim copies too.
They run on three small types of the port's own, with the names the
copied bodies use: ``PartitionSpec`` (``P``), a tuple of per-dim axis
entries; ``Layout`` (``Mesh``), a device-free mesh with ``.shape`` (axis
name -> size, in order), ``.axis_names`` and ``.size``; and
``NamedSharding``, a layout and a spec, whose ``shard_shape`` gives one
device's shape of a global one."""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional, Sequence, Set, Tuple, Union

from repro_torch.utils.device import as_device

AxisNames = Union[None, str, Tuple[str, ...]]

_warned: Set[tuple] = set()


def _warn_once(key: tuple, msg: str) -> None:
    if key in _warned:
        return
    _warned.add(key)
    warnings.warn(msg, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class AchievedParallelism:
    """Per-model-dimension parallel degree actually reached at a
    requested TP width (a dim that the width does not divide is
    replicated, degree 1 — it gets *no* speedup)."""
    requested: int
    heads: int         # attention q/o projections
    kv_heads: int      # k/v projections + the KV cache itself
    ffn: int           # dense MLP hidden dim
    experts: int       # MoE expert dim (1 on dense archs)


def achieved_parallelism(cfg, n: int) -> "AchievedParallelism":
    """Degrees each shardable dimension of ``cfg`` reaches at TP width
    ``n`` under the divisibility rule above (no mesh needed).  Emits the
    same one-time replication warning as ``best_divisible_axes``."""
    def ach(dim: int, what: str) -> int:
        if n <= 1 or dim <= 0:
            return 1
        if dim % n == 0:
            return n
        _warn_once(
            ("tp", what, n, dim),
            f"{cfg.name}: {what}={dim} is not divisible by "
            f"devices_per_instance={n}; the {what} dimension is "
            f"replicated (achieved degree 1) and gets no TP speedup")
        return 1

    moe = bool(getattr(cfg, "moe_experts", 0))
    return AchievedParallelism(
        requested=max(1, n),
        heads=ach(cfg.n_heads, "n_heads"),
        kv_heads=ach(cfg.n_kv_heads, "n_kv_heads"),
        ffn=ach(getattr(cfg, "d_ff", 0) or 0, "d_ff") if not moe else 1,
        experts=ach(cfg.moe_experts, "moe_experts") if moe else 1,
    )


class PartitionSpec(tuple):
    """Per-dim mesh axes of a tensor: ``None`` (replicated), an axis name,
    or a tuple of axis names; dims past the end are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Layout:
    """A device-free mesh: axis names and sizes, in order.  ``shape`` maps
    each axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{tuple(shape)} does not match axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return "Layout(" + ", ".join(f"{a}={n}" for a, n in
                                     self.shape.items()) + ")"


Mesh = Layout


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a layout: ``shard_shape`` is one device's share of a
    global shape (each dim divided by the product of its axes' sizes)."""
    mesh: Layout
    spec: PartitionSpec

    def shard_shape(self, shape) -> Tuple[int, ...]:
        out = []
        for i, dim in enumerate(shape):
            ax = self.spec[i] if i < len(self.spec) else None
            axes = () if ax is None else (ax,) if isinstance(ax, str) else ax
            n = math.prod(self.mesh.shape[a] for a in axes)
            if dim % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not "
                                 f"divide over {axes} ({n})")
            out.append(dim // n)
        return tuple(out)


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name]


def best_divisible_axes(mesh: Mesh, axes: AxisNames, dim: int) -> AxisNames:
    """Return the longest prefix of ``axes`` whose product divides ``dim``."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    picked = []
    prod = 1
    for a in axes:
        nxt = prod * _axis_size(mesh, a)
        if dim % nxt == 0:
            picked.append(a)
            prod = nxt
        else:
            _warn_once(
                (a, _axis_size(mesh, a), dim),
                f"dimension {dim} is not divisible by mesh axis "
                f"{a!r} (size {_axis_size(mesh, a)}); replicating "
                f"instead of sharding — the achieved parallel degree "
                f"is {prod}, not {nxt} (common with GQA kv_heads; the "
                f"cost model prices this via achieved_parallelism)")
            break
    if not picked:
        return None
    return picked[0] if len(picked) == 1 else tuple(picked)


def spec_for(mesh: Mesh, dims: Sequence[Tuple[int, AxisNames]]) -> P:
    """Build a PartitionSpec for a tensor given (dim_size, desired_axes)
    per dimension, dropping non-divisible axes."""
    entries = []
    used: set = set()
    for dim, axes in dims:
        ax = best_divisible_axes(mesh, axes, dim)
        # an axis may appear at most once in a spec
        if ax is not None:
            flat = (ax,) if isinstance(ax, str) else ax
            if any(a in used for a in flat):
                ax = None
            else:
                used.update(flat)
        entries.append(ax)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def named_sharding(mesh: Mesh, dims: Sequence[Tuple[int, AxisNames]]) -> NamedSharding:
    return NamedSharding(mesh, spec_for(mesh, dims))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _spec_tree(tree, leaf_dim, names=()):
    """``tree``'s structure with ``leaf_dim(names)`` at every leaf, where
    ``names`` are the dict keys on the leaf's path."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v, leaf_dim, names + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_spec_tree(v, leaf_dim, names) for v in tree)
    return leaf_dim(names)


def tp_param_specs(cfg, params):
    """Megatron-style split dims for ``init_params`` output: attention q/o
    sharded over heads, k/v over kv_heads, dense MLP over the ffn dim, MoE
    weights over the expert dim; router, norms, embed and lm_head
    replicated (``None``).  Dims count from the end of each leaf's shape,
    as the reference's spec positions do."""
    moe = bool(getattr(cfg, "moe_experts", 0))

    def dim(names) -> Optional[int]:
        leaf = names[-1] if names else ""
        if "mixer" in names or "cross" in names:
            if leaf in ("wq", "wk", "wv", "bq", "bk", "bv"):
                return -1
            if leaf == "wo":
                return -2
            return None                     # q_norm / k_norm / inner norms
        if "mlp" in names:
            if moe:
                return -3 if leaf in ("wi", "wg", "wo") else None
            if leaf in ("wi", "wg"):
                return -1
            if leaf == "wo":
                return -2
        return None                         # embed, norms, lm_head, ...

    return _spec_tree(params, dim)


def tp_cache_specs(cache):
    """Split dims for a KV cache (dense or paged): the KV-head dim (-2 of
    ``(..., KV, hd)``) of ``k``, ``v``, ``k_pages`` and ``v_pages``;
    position planes and anything else are replicated (``None``)."""
    return _spec_tree(cache, lambda names: -2 if names and names[-1] in
                      ("k", "v", "k_pages", "v_pages") else None)


def shard_params(params, specs, n: int, rank: int, device):
    """Shard ``rank`` of ``n`` of a tree: each leaf with a split dim that
    ``n`` divides narrowed to its ``rank``-th contiguous slice, every
    other leaf whole.  On the leaf's own device the result is a view (a
    column slice is strided, which ``matmul`` takes without a copy); only
    another device gets a copy."""
    device = as_device(device)

    def cut(t, dim):
        if dim is not None and t.shape[dim] % n == 0:
            size = t.shape[dim] // n
            t = t.narrow(dim, rank * size, size)
        return t if t.device == device else t.to(device)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, s) for v, s in zip(tree, spec))
        return cut(tree, spec)

    return walk(params, specs)
