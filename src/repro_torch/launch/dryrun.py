"""Dry run of every (architecture x input shape) step on H100 layouts.

The port of ``repro.launch.dryrun``.  Where the reference lowers and
compiles each step onto a TPU production mesh with abstract inputs, the
port traces ONE device's share of the step on the ``meta`` device: shard
0 of the model axis (``models.tp.RecordingGroup``) at the data-local
batch, with every argument at its per-device shape from the specs
(``launch.specs``).  Nothing is allocated.  It reports, per device:

  * memory: argument bytes (the specs' shards, byte for byte the
    reference's), output bytes, and the peak of the live bytes the trace
    allocates (temp); ``fits`` holds their sum against ``BUDGET_BYTES``;
  * FLOPs, counted by ``torch.utils.flop_counter.FlopCounterMode``;
  * bytes: every op's input and output bytes (views excluded), the
    traffic of an unfused execution: an upper bound on what a fused one
    moves, though not on what the port's eager ops move (an op can copy
    inside, as a product of permuted operands does);
  * collectives: the tensor-parallel sums, the expert-parallel combine
    and the sequence-shard merge as the traced shard calls them (with
    their backward conjugates in a train step), the gathers of sharded
    weights where the step reads them (a layer's when the forward
    reaches it, and again when the remat backward recomputes it) and the
    reduce-scatter of their gradients in each microbatch's backward, and
    a train step's data-parallel gradient sums, once a step;
  * a roofline with H100 SXM data-sheet constants.

The traced body keeps whole heads: a leaf whose spec splits a head, or
that the port's mixers take whole (the SSD and RG-LRU projections, the
embedding), is gathered to the shape the body needs inside the step, and
the record lists those leaves (``traced_other_than_spec``); the bytes
gathered count as temp.  Where the model axis does not divide the KV
heads, a serve step's dense cache is split over its sequence (a group
made with ``seq_shard``): decode then attends with every query head on
each shard over its slice of the cache and merges the shards' flash
statistics, as the reference keeps q replicated there.  Layers run in
a Python loop, so the count is at full depth: the reference's
``unroll`` and G-extrapolation have no counterpart, and the port traces
bf16 as bf16 (``dtype_scale`` 1.0).

``check_on_device`` runs the same step body for real on a card, at one
device's shapes, and measures what the trace predicts.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch chatglm3-6b \\
      --shape decode_32k [--multi-pod] [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Env overrides, as in the reference: REPRO_DRYRUN_MESH=2x4 and
REPRO_DRYRUN_MESH_MULTI=2x2x2 (REPRO_DRYRUN_DEVICES, XLA's host device
count there, is accepted and ignored).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
import torch.nn.functional as F
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, canonical, get_config
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.launch.specs import (
    _names_of, batch_shardings, cache_shardings, cache_spec,
    effective_window, input_specs, param_shardings,
)
from repro_torch.models.model import ROW_DIMS, forward
from repro_torch.models.model import cache_leaf as make_cache_leaf
from repro_torch.models.tp import RecordingGroup, tp_axis
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train import make_train_step
from repro_torch.utils.sharding import Layout, NamedSharding, P
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

# ---------------------------------------------------------------------------
# hardware constants: NVIDIA H100 SXM data sheet
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # bytes/s of HBM3
NVLINK_BW = 450e9            # bytes/s a direction, NVLink 4 (the model axis)
NET_BW = 50e9                # bytes/s, 400 Gb/s a GPU (the data and pod axes)
BUDGET_BYTES = 80 * 2 ** 30  # one card's memory, taken as 80 GiB
# The reference halves bytes because XLA-CPU has no bf16 matmul and costs
# an f32 build; the port traces bf16 as bf16.
DTYPE_SCALE = 1.0

BYTES_NOTE = ("bytes_per_device sums every op's input and output bytes "
              "(views excluded): unfused traffic, an upper bound on a "
              "fused execution's, not on the eager ops' own copies")
TEMP_NOTE = ("temp is the trace's peak of live allocated bytes beyond "
             "the arguments and outputs; a sharded weight is gathered "
             "where the body reads it and a gathered copy counts as temp")


# ---------------------------------------------------------------------------
def _mesh_from_env(multi_pod: bool) -> Layout:
    key = "REPRO_DRYRUN_MESH_MULTI" if multi_pod else "REPRO_DRYRUN_MESH"
    spec = os.environ.get(key)
    if spec:
        dims = tuple(int(x) for x in spec.split("x"))
        axes = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
        return Layout(dims, axes)
    return make_production_mesh(multi_pod=multi_pod)


def _microbatches(cfg, shape) -> int:
    if shape.step != "train":
        return 1
    n = cfg.param_count()
    if n > 100e9:
        return 16
    if n > 20e9:
        return 8
    return 4


def _with_groups(cfg, g: int, dtype=None):
    """Same family, g pattern-groups (plus the original tail blocks)."""
    kw = {"n_layers": g * cfg.pattern_len + len(cfg.tail_kinds)}
    if cfg.encoder_layers:
        assert cfg.encoder_layers % cfg.n_groups == 0
        kw["encoder_layers"] = cfg.encoder_layers // cfg.n_groups * g
    if dtype is not None:
        kw["dtype"] = dtype
    return cfg.with_(**kw)


# ---------------------------------------------------------------------------
# the shapes the traced body needs
# ---------------------------------------------------------------------------
def _split(n_dims: int, dim: int) -> P:
    entries = [None] * n_dims
    entries[dim] = "model"
    return P(*entries)


def traced_param_spec(names, shape, cfg, mesh, seq_decode=False) -> P:
    """The model-axis split a leaf has in the traced body: the port's
    Megatron rules (``utils.sharding.tp_param_specs``) with whole heads.
    q/o split over heads where the axis divides them and a shard's query
    heads lie within one KV head's group or hold whole groups; k/v over
    KV heads where the axis divides those too (else every shard keeps
    them all, and attends with its own: ``mixers._shard_kv``); a dense MLP
    over its hidden dim; MoE over experts; everything else whole.  In the
    sequence-sharded decode (``seq_decode``) every shard attends with
    every query head over its slice of the cache, as the reference keeps
    q replicated over the model axis there, so the self-attention's
    q/k/v stay whole and ``wo`` keeps the spec's split of its rows."""
    n = mesh.shape["model"]
    nd = len(shape)
    leaf = names[-1]
    if n == 1:
        return P()
    if seq_decode and "mixer" in names and "encoder" not in names:
        if leaf == "wo" and shape[nd - 2] % n == 0:
            return _split(nd, nd - 2)
        return P()
    if "mixer" in names or "cross" in names:
        H = cfg.n_heads
        KV = cfg.n_heads if "encoder" in names else cfg.n_kv_heads
        qpk = H // KV
        heads = H % n == 0 and (KV % n == 0 or qpk % (H // n) == 0)
        if leaf in ("wq", "bq", "wo") and heads:
            return _split(nd, nd - 2 if leaf == "wo" else nd - 1)
        if leaf in ("wk", "wv", "bk", "bv") and heads and KV % n == 0:
            return _split(nd, nd - 1)
        return P()
    if "mlp" in names and leaf in ("wi", "wg", "wo"):
        if cfg.moe_experts and "encoder" not in names:
            return _split(nd, 0) if cfg.moe_experts % n == 0 else P()
        if cfg.d_ff % n == 0:
            return _split(nd, nd - 2 if leaf == "wo" else nd - 1)
    return P()


def traced_shard(params, cfg, mesh, rank: int, seq_decode=False):
    """Shard ``rank`` of the model axis of whole ``params``, at the traced
    body's layout (``traced_param_spec``): each split leaf narrowed to
    its slice (a view), the rest as they are."""
    n = mesh.shape["model"]

    def cut(names, x):
        spec = traced_param_spec(names, tuple(x.shape), cfg, mesh,
                                 seq_decode)
        if "model" not in spec:
            return x
        d = list(spec).index("model")
        w = x.shape[d] // n
        return x.narrow(d, rank * w, w)
    return tree_unflatten(params, [cut(nm, x) for nm, x in _names_of(params)])


def traced_cache_spec(names, shape, cfg, mesh) -> P:
    """A cache leaf in the traced body: the spec's shard, but whole over
    the model axis where the body takes it whole (recurrent state and
    conv tails, and cross K/V whose sequence the spec splits)."""
    spec = cache_spec(names, shape, cfg, mesh)
    leaf = [x for x in names if isinstance(x, str)][-1]
    lead = 0 if "tail" in names else 1
    seq_split = len(spec) > lead + 1 and spec[lead + 1] is not None
    if leaf in ("state", "conv", "h") or (leaf in ("xk", "xv") and seq_split):
        spec = P(*(None if a == "model" else a for a in spec))
    return spec


def _shard_shape(mesh, spec, shape):
    return NamedSharding(mesh, spec).shard_shape(tuple(shape))


def _axes(spec) -> set:
    out = set()
    for a in spec:
        if a is not None:
            out.update((a,) if isinstance(a, str) else a)
    return out


# ---------------------------------------------------------------------------
# gathering a shard to the traced shape
# ---------------------------------------------------------------------------
def _resize(x, shape):
    """``x`` narrowed where ``shape`` is smaller and tiled where it is a
    multiple larger: a shard standing in for the gathered tensor (same
    shape and bytes; its values repeat)."""
    for d, (have, want) in enumerate(zip(x.shape, shape)):
        if want < have:
            x = x.narrow(d, 0, want)
    reps = [w // h for h, w in zip(x.shape, shape)]
    return x.repeat(reps) if any(r > 1 for r in reps) else x


def _unresize(g, shape):
    """The gradient of ``_resize``: tiles summed, narrowed dims padded."""
    for d, (have, want) in enumerate(zip(g.shape, shape)):
        if have > want:
            g = g.unflatten(d, (have // want, want)).sum(d)
    pad = []
    for have, want in zip(reversed(g.shape), reversed(shape)):
        pad += [0, want - have]
    return F.pad(g, pad) if any(pad) else g


class _Gather(torch.autograd.Function):
    """All-gather of a sharded weight to the traced shape (forward) and
    the reduce-scatter of its gradient back to the shard (backward), both
    recorded on the active group."""

    @staticmethod
    def forward(ctx, x, shape, axes):
        # the backward may run on autograd's device thread: keep the group
        ctx.shape, ctx.axes, ctx.group = tuple(x.shape), axes, tp_axis()
        y = _resize(x, shape)
        ctx.group.record("all-gather", y, axes)
        return y

    @staticmethod
    def backward(ctx, g):
        gx = _unresize(g, ctx.shape)
        ctx.group.record("reduce-scatter", gx, ctx.axes)
        return gx, None, None


def _gather(x, shape, axes):
    shape = tuple(shape)
    if tuple(x.shape) == shape:
        return x
    if not axes:                 # the trace keeps less than the shard
        return _resize(x, shape)
    return _Gather.apply(x, shape, axes)


class _Gathered:
    """A params tree as the step body reads it: a leaf, or a layer's
    leaves, are gathered to their traced shapes each time ``forward``
    reaches them (so a layer's gathered weights live while it runs, and
    the remat recompute gathers again)."""

    def __init__(self, tree, shapes, axes):
        self.tree, self.shapes, self.axes = tree, shapes, axes

    def _get(self, tree, shapes, axes):
        if isinstance(tree, list):
            return _Gathered(tree, shapes, axes)
        return tree_map(_gather, tree, shapes, axes)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return _Gathered(self.tree[key], self.shapes[key],
                             self.axes[key])
        return self._get(self.tree[key], self.shapes[key], self.axes[key])

    def __iter__(self):
        return (self[i] for i in range(len(self.tree)))


# ---------------------------------------------------------------------------
# building a step
# ---------------------------------------------------------------------------
class Step:
    """One device's share of a step: ``body(*args)`` run as a shard of a
    ``RecordingGroup`` of the model axis's size, with ``args`` at the
    specs' per-device shapes (``meta`` tensors from ``build``)."""

    def __init__(self, kind, body, args, spec_bytes, n_model, seq_shard,
                 other, nmb):
        self.kind, self.body, self.args = kind, body, args
        self.spec_bytes = spec_bytes        # the arguments under the specs
        self.n_model, self.seq_shard = n_model, seq_shard
        self.other_than_spec, self.microbatches = other, nmb

    def group(self) -> RecordingGroup:
        return RecordingGroup(self.n_model, seq_shard=self.seq_shard)

    def run(self, args=None, group=None, **kw):
        """``body(*args, **kw)`` as shard 0 of ``group`` (a new recording
        group by default); a train body takes ``n_run`` (microbatches to
        run) and ``on_microbatch``."""
        group = group or self.group()
        args = self.args if args is None else args
        with torch.no_grad() if self.kind != "train" \
                else contextlib.nullcontext():
            return group.run(lambda rank: self.body(*args, **kw))[0]


def _local(tree, shardings):
    """``tree`` (global ``meta`` leaves) at one device's shard shapes."""
    return tree_map(lambda x, sh: torch.empty(
        sh.shard_shape(tuple(x.shape)), dtype=x.dtype, device="meta"),
        tree, shardings)


def _other(name, s_shape, t_shape, dtype, argument):
    """An entry of ``traced_other_than_spec``: ``argument`` when the step
    takes the leaf at the traced shape, else it is gathered inside."""
    return {"leaf": name, "spec": list(s_shape), "traced": list(t_shape),
            "argument": argument,
            "excess_bytes": (math.prod(t_shape) - math.prod(s_shape))
            * dtype.itemsize}


def _param_plan(params, cfg, mesh, train, seq_decode):
    """(shard tree, traced shapes, gather axes, leaves traced otherwise)."""
    spec_sh = param_shardings(params, cfg, mesh, train=train)
    shapes, axes, other = [], [], []
    for (names, leaf), (_, sh) in zip(_names_of(params), _names_of(spec_sh)):
        tspec = traced_param_spec(names, tuple(leaf.shape), cfg, mesh,
                                  seq_decode)
        t_shape = _shard_shape(mesh, tspec, leaf.shape)
        s_shape = sh.shard_shape(tuple(leaf.shape))
        shapes.append(t_shape)
        axes.append(tuple(sorted(_axes(sh.spec) - _axes(tspec))))
        if t_shape != s_shape:
            other.append(_other("/".join(map(str, names)), s_shape, t_shape,
                                leaf.dtype, False))
    return (_local(params, spec_sh), tree_unflatten(params, shapes),
            tree_unflatten(params, axes), other)


def _cache_plan(cache, cfg, mesh):
    """(the cache at the traced shapes, its bytes under the specs, leaves
    traced otherwise)."""
    spec_sh = cache_shardings(cache, cfg, mesh)
    leaves, nbytes, other = [], 0, []
    for (names, leaf), (_, sh) in zip(_names_of(cache), _names_of(spec_sh)):
        tspec = traced_cache_spec(names, tuple(leaf.shape), cfg, mesh)
        t_shape = _shard_shape(mesh, tspec, leaf.shape)
        s_shape = sh.shard_shape(tuple(leaf.shape))
        leaves.append(torch.empty(t_shape, dtype=leaf.dtype, device="meta"))
        nbytes += math.prod(s_shape) * leaf.dtype.itemsize
        if t_shape != s_shape:
            other.append(_other("cache/" + "/".join(map(str, names)),
                                s_shape, t_shape, leaf.dtype, True))
    return tree_unflatten(cache, leaves), nbytes, other


def _data_replicated(params, cfg, mesh):
    """Per leaf: whether its train spec leaves the data axes out (plain
    data parallelism, whose gradient is all-reduced over them)."""
    d_axes = set(data_axes(mesh))
    sh = param_shardings(params, cfg, mesh, train=True)
    return [not (_axes(s.spec) & d_axes) for _, s in _names_of(sh)]


def build(cfg, shape, mesh) -> Step:
    """The step ``shape`` selects, as one device's share on ``mesh``."""
    kind, specs = input_specs(cfg, shape)
    n_model = mesh.shape["model"]
    seq_shard = (shape.step != "train"
                 and cfg.n_kv_heads % n_model != 0
                 and not cfg.is_attention_free)
    train = kind == "train"
    use_fsdp = bool(cfg.sharding.fsdp)
    p_local, p_shapes, p_axes, other = _param_plan(
        specs["params"], cfg, mesh, train=train or use_fsdp,
        seq_decode=seq_shard and shape.step == "decode")

    if train:
        opt_cfg = AdamWConfig(
            moment_dtype="bfloat16" if cfg.param_count() > 100e9 else "float32")
        opt = adamw_init(p_local, opt_cfg, abstract=True)
        batch = _local(specs["batch"], batch_shardings(specs["batch"], mesh))
        # the reference splits the global batch; a device splits its share,
        # so a device with fewer sequences than microbatches runs fewer
        nmb = math.gcd(_microbatches(cfg, shape), batch["labels"].shape[0])
        d_axes = data_axes(mesh)
        replicas = math.prod(mesh.shape[a] for a in d_axes)
        dp = _data_replicated(specs["params"], cfg, mesh)
        # the step's data-parallel gradient sums (f32 when accumulated)
        dp_bytes = [p.numel() * (4 if nmb > 1 else p.element_size())
                    for p, rep in zip(tree_leaves(p_local), dp) if rep]

        def train_step(params, opt_state, batch, n_run=nmb,
                       on_microbatch=None):
            """The trainer's own step (``training.train.make_train_step``)
            on the weights gathered where the body reads them; ``n_run``
            of the ``nmb`` microbatches run."""
            rows = batch["labels"].shape[0] // nmb * n_run
            step = make_train_step(
                cfg, opt_cfg, n_run, remat=True,
                params_view=lambda t: _Gathered(t, p_shapes, p_axes),
                on_microbatch=on_microbatch)
            _, _, om = step(params, opt_state,
                            {k: x[:rows] for k, x in batch.items()})
            if replicas > 1:
                for nbytes in dp_bytes:
                    tp_axis().record("all-reduce", nbytes, d_axes, "sum")
            tp_axis().record("all-reduce", 4, d_axes, "sum")   # grad norm
            return om["loss"], om["grad_norm"]

        args = (p_local, opt, batch)
        return Step(kind, train_step, args, _bytes(args), n_model, False,
                    other, nmb)

    cache, cache_bytes, c_other = _cache_plan(specs["cache"], cfg, mesh)
    wo = effective_window(cfg, shape)
    names = [k for k in ("tokens", "extra_embeds", "frames", "pos_offset")
             if k in specs]
    bsh = batch_shardings({k: specs[k] for k in names}, mesh)
    batch = [_local(specs[k], bsh[k]) for k in names]

    def serve_step(params, cache, *rest):
        kw = dict(zip(names, rest))
        logits, _, _ = forward(
            _Gathered(params, p_shapes, p_axes), cfg, kw.pop("tokens"),
            cache=cache, pos_offset=kw.pop("pos_offset", 0),
            last_only=True, window_override=wo, **kw)
        return torch.argmax(logits[:, 0], -1).to(torch.int32)

    return Step(kind, serve_step, (p_local, cache, *batch),
                _bytes((p_local, batch)) + cache_bytes, n_model, seq_shard,
                other + c_other, 1)


# ---------------------------------------------------------------------------
# tracing: FLOPs, bytes, live memory
# ---------------------------------------------------------------------------
def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _bytes(tree) -> int:
    return sum(_nbytes(t) for t in _tensors(tree))


def _sig(a):
    """A hashable signature of an op argument: a tensor by its metadata."""
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.storage_offset(), a.dtype)
    if isinstance(a, (list, tuple)):
        return tuple([_sig(x) for x in a])
    if isinstance(a, dict):
        return tuple([(k, _sig(v)) for k, v in a.items()])
    return a


class Traffic(TorchDispatchMode):
    """Counts every op's FLOPs, with ``FlopCounterMode``'s own formulas
    (``torch.utils.flop_counter.flop_registry``, called as it calls
    them), and its input and output bytes (views excluded), and tracks
    the live bytes of the storages the ops allocate: a storage is live
    while a tensor the ops returned still refers to it (or, past that,
    while it has not been freed).  ``peak`` is the largest sum of live new
    storages seen at an allocation; storages of ``inputs`` are not
    counted.

    On ``meta`` tensors an op's result depends only on its arguments'
    metadata, and most of torch's meta kernels are Python references,
    far slower than a dictionary lookup, so results are memoised by
    signature, within one trace: a repeated op returns fresh tensors of
    the recorded shapes and strides, its input itself where it wrote in
    place, or a view of the input it aliased, and adds the FLOPs and
    bytes recorded with it.  An op whose output changed an input's
    metadata in place, or aliased it at another dtype, is never
    memoised.  ``memo=False`` runs every op (the dryrun's ``--no-memo``:
    tests hold the two traces equal, and it times what the memo saves)."""

    def __init__(self, inputs=(), memo: bool = True):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._known = {t.untyped_storage()._cdata for t in _tensors(inputs)}
        self._store = {}            # key -> [nbytes, refs, weak storage]
        self._pending = []          # unreferenced keys whose storage lives
        # op signature -> (output recipe or None, (FLOPs, bytes))
        self._memo = {} if memo else None

    @staticmethod
    def _recipe(flat_in, outs, before):
        """How to rebuild ``outs`` from the inputs, or None."""
        recipe = []
        for o in outs:
            if not isinstance(o, torch.Tensor):
                return None
            st = o.untyped_storage()._cdata
            src = next((i for i, x in enumerate(flat_in) if x is o), None)
            if src is not None:
                if _sig(o) != before[src]:       # metadata changed in place
                    return None
                recipe.append(("self", src))
                continue
            src = next((i for i, x in enumerate(flat_in)
                        if x.untyped_storage()._cdata == st), None)
            if src is None:
                recipe.append(("new", tuple(o.shape), o.stride(), o.dtype))
            elif o.dtype == flat_in[src].dtype:
                recipe.append(("view", src, tuple(o.shape), o.stride(),
                               o.storage_offset()))
            else:
                return None
        return recipe

    @staticmethod
    def _cost(func, args, kwargs, flat_in, out):
        """(FLOPs, bytes) of one call."""
        fn = flop_registry.get(func._overloadpacket)
        flops = fn(*args, **kwargs, out_val=out) if fn is not None else 0
        if func.is_view:
            return flops, 0
        return flops, (sum(_nbytes(t) for t in flat_in)
                       + sum(_nbytes(t) for t in _tensors(out)))

    def _call_meta(self, func, args, kwargs, flat_in):
        key = (func, _sig(args), _sig(kwargs))
        recipe = self._memo.get(key, False)
        if recipe is False or recipe[0] is None:
            before = [_sig(t) for t in flat_in] if recipe is False else None
            out = func(*args, **kwargs)
            cost = self._cost(func, args, kwargs, flat_in, out)
            if recipe is False:
                single = isinstance(out, torch.Tensor)
                rec = (self._recipe(flat_in, [out] if single else out, before)
                       if single or isinstance(out, (tuple, list)) else None)
                self._memo[key] = (None if rec is None else (single, rec),
                                   cost)
            return out, cost
        (single, rec), cost = recipe
        outs = []
        for r in rec:
            if r[0] == "self":
                outs.append(flat_in[r[1]])
            elif r[0] == "new":
                outs.append(torch.empty_strided(r[1], r[2], dtype=r[3],
                                                device="meta"))
            else:
                outs.append(torch.as_strided(flat_in[r[1]], r[2], r[3],
                                             r[4]))
        return (outs[0] if single else tuple(outs)), cost

    def _free(self, key):
        ent = self._store.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] > 0:
            return
        if ent[2].expired():
            self.live -= self._store.pop(key)[0]
        else:
            self._pending.append(key)

    def _sweep(self):
        keep = []
        for key in self._pending:
            ent = self._store.get(key)
            if ent is None or ent[1] > 0:
                continue
            if ent[2].expired():
                self.live -= self._store.pop(key)[0]
            else:
                keep.append(key)
        self._pending = keep

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        ent = self._store.get(key)
        if ent is not None and ent[2].expired():   # an address reused
            self.live -= self._store.pop(key)[0]
            ent = None
        if ent is None:
            self._sweep()
            ent = self._store[key] = [st.nbytes(), 0, StorageWeakRef(st)]
            self.live += ent[0]
            self.peak = max(self.peak, self.live)
        ent[1] += 1
        weakref.finalize(t, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = list(_tensors(args))
        if kwargs:
            flat += _tensors(kwargs)
        if (self._memo is not None and flat
                and all(t.device.type == "meta" for t in flat)):
            out, (flops, nbytes) = self._call_meta(func, args, kwargs, flat)
        else:
            out = func(*args, **kwargs)
            flops, nbytes = self._cost(func, args, kwargs, flat, out)
        self.flops += flops
        self.bytes += nbytes
        if isinstance(out, torch.Tensor):
            self._track(out)
        else:
            for t in _tensors(out):
                self._track(t)
        return out


def measure(step: Step, memo: bool = True):
    """Run ``step`` on its ``meta`` arguments under ``Traffic``.  Returns
    (flops, bytes, peak new live bytes, collective records).

    A train step's microbatches are alike from the second on, so only two
    run: the counts of the rest are the second's, added ``n - 2`` times
    (exact), and the peak is the second's (the accumulators live from the
    first)."""
    group = step.group()
    snaps = []
    with Traffic(step.args, memo) as tr:
        def hook(i):
            snaps.append((tr.flops, tr.bytes, len(group.records)))
        kw = ({"n_run": min(2, step.microbatches), "on_microbatch": hook}
              if step.kind == "train" else {})
        step.run(group=group, **kw)
    flops, nbytes, records = tr.flops, tr.bytes, list(group.records)
    extra = step.microbatches - len(snaps) if len(snaps) >= 2 else 0
    if extra > 0:
        (f1, b1, r1), (f2, b2, r2) = snaps[-2], snaps[-1]
        flops += extra * (f2 - f1)
        nbytes += extra * (b2 - b1)
        records += extra * group.records[r1:r2]
    return flops, nbytes, tr.peak, records


def collective_stats(records, mesh) -> dict:
    """Per-kind counts and bytes, and the link time: bytes over NVLink on
    the model axis alone, over the network where a data or pod axis
    takes part."""
    per_kind, total, seconds = {}, 0, 0.0
    for r in records:
        d = per_kind.setdefault(r["kind"], {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += r["bytes"]
        total += r["bytes"]
        axes = (r["axis"],) if isinstance(r["axis"], str) else r["axis"]
        if math.prod(mesh.shape[a] for a in axes) > 1:
            seconds += r["bytes"] / (NVLINK_BW if set(axes) == {"model"}
                                     else NET_BW)
    return {"per_kind": per_kind, "bytes_per_device": total,
            "link_s": seconds}


def roofline_terms(flops_per_dev, bytes_per_dev, coll) -> dict:
    return {
        "compute_s": flops_per_dev / PEAK_FLOPS,
        "memory_s": bytes_per_dev / HBM_BW,
        "collective_s": coll["link_s"],
    }


def trace(cfg, shape, mesh, memo: bool = True) -> dict:
    """The meta trace of one device's share: every figure of a record."""
    step = build(cfg, shape, mesh)
    traced_args = _bytes(step.args)
    out_bytes = 4 * step.args[-1].shape[0] if step.kind != "train" else 8
    flops, nbytes, peak, records = measure(step, memo)
    args = step.spec_bytes
    coll = collective_stats(records, mesh)
    # the traced cache exceeds the spec's shard where the body keeps a
    # leaf whole (recurrent state, cross K/V): that excess is temp too
    temp = max(0, peak - out_bytes) + max(0, traced_args - args)
    return {
        "memory_analysis": {"argument_size_bytes": args,
                            "output_size_bytes": out_bytes,
                            "temp_size_bytes": temp},
        "traced_argument_bytes": traced_args,
        "traced_peak_bytes": traced_args + peak,
        "flops_per_device": float(flops),
        "bytes_per_device": float(nbytes),
        "collectives": {k: coll[k] for k in ("per_kind", "bytes_per_device")},
        "roofline": roofline_terms(flops, nbytes, coll),
        "microbatches": step.microbatches,
        "seq_shard": step.seq_shard,
        "traced_other_than_spec": step.other_than_spec,
    }


def run_one(arch: str, shape_name: str, multi_pod: bool,
            memo: bool = True) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = _mesh_from_env(multi_pod)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "n_chips": mesh.size, "step": shape.step,
        "window_override": effective_window(cfg, shape),
        "status": "ok", "device": "meta",
        "dtype_scale": DTYPE_SCALE, "budget_bytes": BUDGET_BYTES,
        "notes": [BYTES_NOTE, TEMP_NOTE],
    }
    t0 = time.time()
    try:
        rec.update(trace(cfg, shape, mesh, memo))
        m = rec["memory_analysis"]
        rec["fits"] = (m["argument_size_bytes"] + m["output_size_bytes"]
                       + m["temp_size_bytes"]) <= BUDGET_BYTES
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def summary_line(rec) -> str:
    status = rec["status"]
    if status != "ok":
        return (f"[{status:5s}] {rec['arch']:22s} {rec['shape']:12s} "
                f"mesh={rec['mesh']:9s} {rec.get('error', '')[:160]}")
    m, r = rec["memory_analysis"], rec["roofline"]
    big = max(r, key=r.get)
    return (f"[{status:5s}] {rec['arch']:22s} {rec['shape']:12s} "
            f"mesh={rec['mesh']:9s} arg={m['argument_size_bytes'] / 1e9:8.3f}GB "
            f"temp={m['temp_size_bytes'] / 1e9:8.3f}GB fits={rec['fits']!s:5s} "
            f"flops={rec['flops_per_device']:.4e} "
            f"comp={r['compute_s'] * 1e3:9.3f}ms mem={r['memory_s'] * 1e3:9.3f}ms "
            f"coll={r['collective_s'] * 1e3:9.3f}ms max={big[:-2]} "
            f"({rec['total_s']:.1f}s)")


def _run_combo(combo, memo=True):
    return (*combo, run_one(*combo, memo=memo))


def _records(combos, jobs: int, memo: bool = True):
    """(arch, shape, multi_pod, record) of each combo, in order; with
    ``jobs`` > 1 traced in that many spawned processes."""
    run = functools.partial(_run_combo, memo=memo)
    if jobs <= 1 or len(combos) <= 1:
        yield from map(run, combos)
        return
    import concurrent.futures
    import multiprocessing
    with concurrent.futures.ProcessPoolExecutor(
            jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
        yield from ex.map(run, combos)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep all assigned archs x shapes")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combos traced at once, each in its own process")
    ap.add_argument("--no-memo", action="store_true",
                    help="run every op of a trace (times what the memo "
                         "saves)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    combos = []
    if args.all:
        for a in ASSIGNED_ARCHS:
            for s in INPUT_SHAPES:
                combos.append((a, s, args.multi_pod))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        combos.append((args.arch, args.shape, args.multi_pod))

    ok = 0
    for arch, shape, mp, rec in _records(combos, args.jobs,
                                         not args.no_memo):
        tag = "multi" if mp else "single"
        path = os.path.join(args.out, f"{canonical(arch)}__{shape}__{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        ok += rec["status"] == "ok"
        print(summary_line(rec), flush=True)
    print(f"{ok}/{len(combos)} combos traced")
    return 0 if ok == len(combos) else 1


# ---------------------------------------------------------------------------
# the card check
# ---------------------------------------------------------------------------
def _realize(tree, device, gen):
    """Real tensors of ``tree``'s (meta) shapes on ``device``: floats
    N(0, 0.02^2) from ``gen``, integers 0."""
    def real(x):
        if x.dtype.is_floating_point:
            return (torch.randn(x.shape, generator=gen, device=device,
                                dtype=torch.float32) * 0.02).to(x.dtype)
        return torch.zeros(x.shape, dtype=x.dtype, device=device)
    return tree_map(real, tree)


def _device_inputs(step: Step, cfg, shape, device, seed: int):
    """The step's arguments on ``device``: random weights from ``seed``,
    an empty optimizer state, tokens below the vocab, and a decode cache
    whose slots hold this shard's first positions with the new token at
    the context's last one."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if step.kind == "train":
        params, opt, batch = step.args
        params = _realize(params, device, gen)
        opt = tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype,
                                             device=device), opt)
        batch = {k: (torch.randint(0, cfg.vocab_size, x.shape, generator=gen,
                                   device=device, dtype=x.dtype)
                     if not x.dtype.is_floating_point
                     else _realize(x, device, gen))
                 for k, x in batch.items()}
        return params, opt, batch
    params, cache, *rest = step.args
    params = _realize(params, device, gen)

    def cache_leaf(names, x):
        if names[-1] == "pos":
            ar = torch.arange(x.shape[-1], device=device, dtype=x.dtype)
            real = ar.expand(x.shape)
        else:
            real = _realize(x, device, gen)
        if names[-1] not in ROW_DIMS:
            return real
        # a written leaf keeps the write plan's scratch row, as the
        # engine's caches do
        if names[0] == "tail":             # no group axis
            leaf = make_cache_leaf((1, *x.shape), x.dtype, device,
                                   row_dims=ROW_DIMS[names[-1]])[0]
        else:
            leaf = make_cache_leaf(tuple(x.shape), x.dtype, device,
                                   row_dims=ROW_DIMS[names[-1]])
        return leaf.copy_(real)
    cache = tree_unflatten(cache, [cache_leaf(n, x)
                                   for n, x in _names_of(cache)])
    real_rest = []
    for x in rest:
        if x.dtype.is_floating_point:
            real_rest.append(_realize(x, device, gen))
        elif x.dim() == 1:           # pos_offset: the context's last slot
            real_rest.append(torch.full(x.shape, shape.seq_len - 1,
                                        dtype=x.dtype, device=device))
        else:
            real_rest.append(torch.randint(0, cfg.vocab_size, x.shape,
                                           generator=gen, device=device,
                                           dtype=x.dtype))
    return (params, cache, *real_rest)


def _measured_run(fn, device):
    """Run ``fn()`` once under FlopCounterMode and torch.profiler, with
    CUDA events around it.  Returns (FLOPs, device ms, how): the summed
    duration of the kernels the run launched, or, where the profiler
    recorded no device activity, the events' time."""
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with FlopCounterMode(display=False) as fc, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    if us > 0:
        return fc.get_total_flops(), us / 1e3, "profiler"
    return fc.get_total_flops(), start.elapsed_time(end), "events"


def allocator_slack(tensors) -> int:
    """The most CUDA's caching allocator may hold for ``tensors`` beyond
    their bytes: it rounds a block up to 512 B and leaves a free block
    unsplit when the rest would be under 512 B (blocks of 1 MiB or less)
    or at most 1 MiB (larger ones)."""
    return sum(1024 if _nbytes(t) <= 2 ** 20 else 2 ** 20 + 512
               for t in tensors)


def check_on_device(arch: str, shape_name: str, layout: Layout, device,
                    seed: int = 0) -> dict:
    """One device's share of ``arch`` x ``shape_name`` on ``layout``, run
    for real on the CUDA ``device``, beside the meta trace's prediction.

    Builds shard 0's arguments at the trace's shapes on the card (random
    bf16 weights from ``seed``), runs the step body once to warm up and
    once measured, as shard 0 of a ``RecordingGroup``: the values are one
    shard's unsummed partials, but the bytes and operations are the
    device's true share.  Returns the prediction (``predicted``: the
    arguments' bytes from the specs, ``argument_size_bytes`` plus the
    excess of the leaves the step takes at another shape than their
    spec shard; the trace's peak live bytes with the arguments; its
    FLOPs and roofline) and the measurement (``measured``: what the
    allocator holds for the real arguments, and the most it may hold
    beyond their bytes (``allocator_slack``); ``max_memory_allocated``
    above the baseline taken before them; the measured run's
    FlopCounterMode count, the same ops counted by the same formulas as
    the trace's, so equal counts show that the meta trace ran the ops
    the card ran; its device time in ms and how it was taken, from the
    same run)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"check_on_device measures a CUDA device, not "
                         f"{device}")
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    step = build(cfg, shape, layout)
    pred = trace(cfg, shape, layout)
    spec_args = pred["memory_analysis"]["argument_size_bytes"] + sum(
        o["excess_bytes"] for o in pred["traced_other_than_spec"]
        if o["argument"])
    gc.collect()
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    args = _device_inputs(step, cfg, shape, device, seed)
    torch.cuda.synchronize(device)
    allocated = torch.cuda.memory_allocated(device) - base
    slack = allocator_slack(_tensors(args))
    step.run(args)                                    # warm-up
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    flops, ms, how = _measured_run(lambda: step.run(args), device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del args
    torch.cuda.empty_cache()
    r = pred["roofline"]
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(layout.shape[a]) for a in layout.axis_names),
        "predicted": {"argument_bytes": spec_args,
                      "peak_bytes": pred["traced_peak_bytes"],
                      "flops": pred["flops_per_device"],
                      "roofline": r, "roofline_max_s": max(r.values()),
                      "roofline_max": max(r, key=r.get)[:-2]},
        "measured": {"allocated_argument_bytes": allocated,
                     "allocator_slack_bytes": slack,
                     "peak_bytes": peak,
                     "flops": float(flops),
                     "device_ms": ms, "timed_by": how},
        "microbatches": step.microbatches,
    }


if __name__ == "__main__":
    sys.exit(main())
