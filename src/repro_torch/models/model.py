"""Unified model: one forward for every architecture family.

Mirrors ``repro.models.model``: ``init_params``, ``init_cache`` (the
dense slot cache), ``supports_paged_kv``, ``init_paged_cache``,
``forward`` over a paged pool, a dense cache or no cache at all (with
``remat`` for training), and the training ``loss_fn``.

Parameters are a plain dict: ``embed`` (vocab, d_model), ``layers`` (a
list with one dict per layer, ``n_layers`` long: the reference's
per-group stacks unrolled, so layer ``g * len(pattern) + i`` is
``params["blocks"][i][g]`` there, followed by the tail blocks, so layer
``n_groups * len(pattern) + j`` is ``params["tail"][j]``),
``final_norm``, ``lm_head`` (d_model, vocab) unless tied, and where the
config has them ``encoder`` (a list of ``encoder_layers`` layer dicts),
``enc_norm`` and ``pos_embed``.  Weights keep the reference's ``x @ W``
(in, out) orientation.

Caches keep the reference's layout, so exported pieces compare byte for
byte: one dict per pattern position with leaves stacked over the G
groups (``blocks``), one per tail block without that axis (``tail``),
and the cross-attention K/V of every decoder layer (``cross``).  They
are updated in place.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    mlp_fwd, norm_fwd, rope_tables, sinusoidal_table,
)
from repro_torch.models.mixers import (
    PackedRows, _batch_positions, cross_attention_fwd, mixer_fwd,
)
from repro_torch.models.tp import tp_axis, tp_context, tp_rank
from repro_torch.utils.device import resolve_device, torch_dtype
from repro_torch.utils.tree import tree_leaves


def _sinusoidal_of(pos, dim: int):
    """Sinusoidal embedding of integer positions (any device; the base is
    filled on the device, so nothing is copied from the host)."""
    i = torch.arange(dim // 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[:, None] / torch.pow(
        torch.full((), 10000.0, device=pos.device), 2 * i / dim)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's block config (MHA, gelu MLP, no cross)."""
    return cfg.with_(n_kv_heads=cfg.n_heads, moe_experts=0, mlp="gelu",
                     layer_pattern=("attn",), cross_attention=False)


def _layer_kinds(cfg: ModelConfig):
    """The mixer kind of every layer: the pattern repeated, then the
    tail blocks (the pattern's first ``n_layers % len(pattern)``)."""
    return [cfg.layer_pattern[i % cfg.pattern_len]
            for i in range(cfg.n_layers)]


# ==========================================================================
# parameter construction
# ==========================================================================

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, abstract: bool = False):
    """Random weights with the structure the reference's ``init_params``
    builds, at ``cfg.dtype``, generated directly on ``device`` (CUDA
    unless the caller asks for the CPU).  Scales follow the reference's
    ``ParamFactory``: ``dense`` draws N(0, 1) times ``1/sqrt(shape[0])``
    (for an expert stack (E, in, out) that is ``1/sqrt(E)``) or the
    stated scale (0.02 for ``embed``, ``lm_head``, ``pos_embed`` and the
    MoE ``router``, 0.5 for conv kernels, 0.02 for the RG-LRU gates);
    ``uniform`` draws ``A_log``, ``dt_bias`` and ``lam`` from their
    ranges; biases start at 0 and norm scales and ``D`` at 1.  The
    numbers differ from JAX's for the same seed (another generator);
    tests that compare the two convert the JAX weights with
    ``convert``.

    ``abstract=True`` builds the same tree as ``meta`` tensors, leaf for
    leaf (shape and dtype), with no storage and no generator: the
    counterpart of the reference's ``_abstract_stack``, which the dryrun
    reads."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    if generator is None and not abstract:
        generator = torch.Generator(device=dev).manual_seed(0)
    dt = torch_dtype(cfg.dtype)
    scratch = None
    if not abstract:
        # every leaf is drawn in f32 into one buffer of the largest
        # leaf's size, then rounded into its own tensor: a draw per leaf
        # would leave the rounded weights scattered through the freed
        # draws' blocks, and a near-full card with holes no CUDA graph
        # pool can use
        scratch = torch.empty(max(
            t.numel() for t in tree_leaves(init_params(cfg, abstract=True))),
            dtype=torch.float32, device=dev)

    def draw(fn, *shape):
        w = scratch[:math.prod(shape)].view(shape)
        return fn(shape, generator=generator, out=w)

    def dense(*shape, scale=None):
        if abstract:
            return torch.empty(shape, dtype=dt, device=dev)
        if scale is None:
            scale = 1.0 / math.sqrt(shape[0])
        return draw(torch.randn, *shape).mul_(scale).to(dt, copy=True)

    def uniform(n, lo, hi):
        if abstract:
            return torch.empty(n, dtype=dt, device=dev)
        return draw(torch.rand, n).mul_(hi - lo).add_(lo).to(dt, copy=True)

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=dev)

    def ones(n):
        return torch.ones(n, dtype=dt, device=dev)

    def norm(c):
        if c.norm == "layernorm":
            return {"scale": ones(c.d_model), "bias": zeros(c.d_model)}
        return {"scale": ones(c.d_model)}

    def attention(c, cross=False):
        dm, hd, H, KV = c.d_model, c.hd, c.n_heads, c.n_kv_heads
        p = {"wq": dense(dm, H * hd), "wk": dense(dm, KV * hd),
             "wv": dense(dm, KV * hd), "wo": dense(H * hd, dm)}
        if c.qkv_bias:
            p.update(bq=zeros(H * hd), bk=zeros(KV * hd), bv=zeros(KV * hd))
        if c.qk_norm and not cross:
            p.update(q_norm=ones(hd), k_norm=ones(hd))
        return p

    def ssd(c):
        dm, di = c.d_model, c.d_inner
        G, N, H = c.ssm_groups, c.ssm_state, c.ssm_heads
        conv_dim = di + 2 * G * N
        return {"in_proj": dense(dm, 2 * di + 2 * G * N + H),
                "conv_w": dense(c.ssm_conv, conv_dim, scale=0.5),
                "conv_b": zeros(conv_dim),
                "A_log": uniform(H, 0.0, 1.3),     # A = -exp(A_log)
                "D": ones(H),
                "dt_bias": uniform(H, -4.0, -1.0),
                "norm": ones(di),
                "out_proj": dense(di, dm)}

    def rglru(c):
        dm, W = c.d_model, c.lru_dim
        return {"w_gate": dense(dm, W), "w_in": dense(dm, W),
                "conv_w": dense(c.lru_conv, W, scale=0.5),
                "conv_b": zeros(W),
                "w_a": dense(W, W, scale=0.02), "b_a": zeros(W),
                "w_x": dense(W, W, scale=0.02), "b_x": zeros(W),
                "lam": uniform(W, 2.0, 6.0),
                "w_out": dense(W, dm)}

    def mlp(c):
        dm, ff = c.d_model, c.d_ff
        if c.moe_experts:
            E, mff = c.moe_experts, c.moe_d_ff
            return {"router": dense(dm, E, scale=0.02),
                    "wi": dense(E, dm, mff), "wg": dense(E, dm, mff),
                    "wo": dense(E, mff, dm)}
        if c.mlp in ("swiglu", "geglu"):
            return {"wi": dense(dm, ff), "wg": dense(dm, ff),
                    "wo": dense(ff, dm)}
        if c.mlp in ("squared_relu", "gelu"):
            return {"wi": dense(dm, ff), "wo": dense(ff, dm)}
        raise ValueError(c.mlp)

    def block(c, kind):
        """pre-norm + mixer + (cross-attn) + pre-norm + mlp"""
        mixer = {"attn": attention, "local_attn": attention, "ssd": ssd,
                 "rglru": rglru}[kind](c)
        p = {"norm1": norm(c), "mixer": mixer}
        if c.cross_attention:
            p.update(norm_x=norm(c), cross=attention(c, cross=True))
        if c.mlp != "none" or c.moe_experts:
            p.update(norm2=norm(c), mlp=mlp(c))
        return p

    params = {"embed": dense(cfg.vocab_size, cfg.d_model, scale=0.02),
              "layers": [block(cfg, kind) for kind in _layer_kinds(cfg)]}
    params["final_norm"] = norm(cfg)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(cfg.d_model, cfg.vocab_size, scale=0.02)
    if cfg.encoder_layers:
        enc_cfg = _encoder_cfg(cfg)
        params["encoder"] = [block(enc_cfg, "attn")
                             for _ in range(cfg.encoder_layers)]
        params["enc_norm"] = norm(cfg)
    if cfg.pos_embedding == "learned":
        params["pos_embed"] = dense(
            32_768 if cfg.arch_type != "audio" else 65_536, cfg.d_model,
            scale=0.02)
    if scratch is not None and dev.type == "cuda":
        # hand the draw buffer back to the device: left cached, the next
        # large tensors (a KV pool) would be carved from it, and the rest
        # of it would stay a hole that no other stream or graph pool can use
        del scratch
        torch.cuda.empty_cache()
    return params


# ==========================================================================
# dense cache construction
# ==========================================================================
#: The cache leaves a write plan writes row by row, by the number of their
#: dims after the group axis that index a row: a page of the pool, or a
#: (slot, position) pair of the dense cache.
ROW_DIMS = {"k_pages": 1, "v_pages": 1, "k_scales": 1, "v_scales": 1,
            "k": 2, "v": 2, "pos": 2}


def cache_leaf(shape, dtype, device, fill=0, row_dims: int = 1):
    """A cache leaf of ``shape`` (G, rows..., rest...) full of ``fill``,
    followed in its storage by one scratch row: the first G * n_rows rows
    of a contiguous (G * n_rows + 1, rest...) tensor.  The write plans
    (``mixers.paged_write_plan`` / ``dense_write_plan``) aim the rows that
    write nothing there, as the reference aims them past the end with
    ``mode="drop"``, so their length never depends on the data.  The
    leaf is contiguous, with a plain tensor's shape, dtype and values;
    nothing that reads it sees the scratch row."""
    n = math.prod(shape[:1 + row_dims])
    backing = (torch.zeros if fill == 0 else
               lambda s, **kw: torch.full(s, fill, **kw))(
        (n + 1, *shape[1 + row_dims:]), dtype=dtype, device=device)
    return backing[:n].view(shape)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window_override: Optional[int] = None, device=None,
               n_kv_heads: Optional[int] = None, abstract: bool = False):
    """Per-pattern-position caches stacked over the G groups, as the
    reference builds them: attention slots (G, batch, S_buf, KV, hd) with
    ``pos`` -1 (empty), where a local-attention layer (or every layer,
    under ``window_override``) keeps a ring of ``min(max_len, window)``
    slots; SSD state (f32) and conv tail; RG-LRU state (f32) and conv
    tail; tail-block caches without the group axis; cross K/V for every
    decoder layer.  ``n_kv_heads`` (default ``cfg.n_kv_heads``) is the KV
    heads a cache holds: a shard of a sharded instance holds its slice.
    ``abstract=True`` builds the same tree as ``meta`` tensors.  The
    attention leaves keep one scratch row after their rows
    (``cache_leaf``) for the write plan's dropped rows."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    G = cfg.n_groups
    KV = cfg.n_kv_heads if n_kv_heads is None else n_kv_heads
    dt = torch_dtype(cfg.dtype)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    caches = []
    for kind in cfg.layer_pattern:
        eff_window = window_override if window_override is not None \
            else cfg.window
        kind_eff = "local_attn" if (kind == "attn" and window_override) \
            else kind
        if kind_eff in ("attn", "local_attn"):
            S_buf = min(max_len, eff_window) \
                if (kind_eff == "local_attn" and eff_window) else max_len
            shape = (G, batch, S_buf, KV, cfg.hd)
            c = {"k": cache_leaf(shape, dt, dev, row_dims=2),
                 "v": cache_leaf(shape, dt, dev, row_dims=2),
                 "pos": cache_leaf(shape[:3], torch.int32, dev, -1, 2)}
        elif kind == "ssd":
            c = {"state": zeros((G, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state), torch.float32),
                 "conv": zeros((G, batch, cfg.ssm_conv - 1,
                                cfg.d_inner + 2 * cfg.ssm_groups
                                * cfg.ssm_state))}
        elif kind == "rglru":
            c = {"h": zeros((G, batch, cfg.lru_dim), torch.float32),
                 "conv": zeros((G, batch, cfg.lru_conv - 1, cfg.lru_dim))}
        else:
            raise ValueError(kind)
        caches.append(c)
    cache = {"blocks": tuple(caches)}
    if cfg.tail_kinds:
        tail = init_cache(cfg.with_(n_layers=len(cfg.tail_kinds),
                                    layer_pattern=cfg.tail_kinds,
                                    cross_attention=False),
                          batch, max_len, window_override=window_override,
                          device=dev, n_kv_heads=KV, abstract=abstract)
        # strip the G=1 leading dim for tail caches
        cache["tail"] = tuple({k: v[0] for k, v in c.items()}
                              for c in tail["blocks"])
    if cfg.cross_attention:
        shape = (cfg.n_layers, batch, cfg.encoder_len, KV, cfg.hd)
        cache["cross"] = {"xk": zeros(shape), "xv": zeros(shape)}
    return cache


# ==========================================================================
# paged cache construction (block-table KV pool)
# ==========================================================================
def supports_paged_kv(cfg: ModelConfig) -> bool:
    """Paged KV applies to pure full-attention decoders: every layer's
    cache grows per token and positions are append-only.  Sliding-window
    ring buffers and recurrent (SSD / RG-LRU) state are O(1)-bounded and
    keep the dense slot cache; encoder-decoder and stub-frontend archs
    prefill below the token embedding and stay dense too."""
    return (all(k == "attn" for k in cfg.layer_pattern)
            and not cfg.tail_kinds
            and not cfg.cross_attention
            and not cfg.window
            and cfg.arch_type not in ("vlm", "audio"))


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     kv_precision=None, device=None,
                     n_kv_heads: Optional[int] = None):
    """Physical page pools, one dict per pattern position with leaves
    stacked over the G groups: ``k_pages``/``v_pages`` of shape
    (G, n_pages, page_size, KV, hd), plus (G, n_pages, page_size) f32
    ``k_scales``/``v_scales`` for a quantized (fp8/int8) pool.  Slots map
    logical positions to (page, offset) through the engine's block
    tables.  ``n_kv_heads`` (default ``cfg.n_kv_heads``) is the KV heads
    the pool holds: each shard of a sharded instance allocates its own
    pool at its slice of the heads, never a view of a whole pool (the
    kernel wrappers would copy a strided view on every call).  Each leaf
    keeps a scratch page after its pages (``cache_leaf``), where the
    write plan's dropped rows land."""
    from repro_torch.core.precision import get_precision
    from repro_torch.kernels.ops import kv_storage_dtype

    if not supports_paged_kv(cfg):
        raise ValueError(f"{cfg.name}: layer pattern "
                         f"{cfg.layer_pattern} cannot use a paged KV cache")
    dev = resolve_device(device)
    G = cfg.n_groups
    prec = get_precision(kv_precision)
    dt = kv_storage_dtype(prec, default=torch_dtype(cfg.dtype))
    caches = []
    for _ in cfg.layer_pattern:
        shape = (G, n_pages, page_size,
                 cfg.n_kv_heads if n_kv_heads is None else n_kv_heads,
                 cfg.hd)
        c = {"k_pages": cache_leaf(shape, dt, dev),
             "v_pages": cache_leaf(shape, dt, dev)}
        if prec.quantized:
            c["k_scales"] = cache_leaf(shape[:3], torch.float32, dev)
            c["v_scales"] = cache_leaf(shape[:3], torch.float32, dev)
        caches.append(c)
    return {"blocks": tuple(caches)}


# ==========================================================================
# forward
# ==========================================================================
def _block_fwd(kind: str, bp, x, cfg: ModelConfig, *, cache, pos_offset,
               window_override, cross_cache=None, enc_out=None, active=None,
               token_mask=None, valid_len=None, block_tables=None,
               page_size=0, rope=None, plans=None, append_external=False,
               rows=None):
    h, new_cache = mixer_fwd(
        kind, bp["mixer"], norm_fwd(bp["norm1"], x, cfg.norm), cfg,
        cache=cache, pos_offset=pos_offset, window_override=window_override,
        active=active, token_mask=token_mask, valid_len=valid_len,
        append_external=append_external, block_tables=block_tables,
        page_size=page_size, rope=rope, plans=plans, rows=rows)
    x = x + h
    new_cross = None
    if cfg.cross_attention and "cross" in bp:
        h, new_cross = cross_attention_fwd(
            bp["cross"], norm_fwd(bp["norm_x"], x, cfg.norm), cfg,
            enc_out=enc_out, cache=cross_cache)
        x = x + h
    aux = 0.0            # a dense MLP adds Python zeros: no launches
    if "mlp" in bp:
        h, aux = mlp_fwd(bp["mlp"], norm_fwd(bp["norm2"], x, cfg.norm), cfg)
        x = x + h
    return x, new_cache, new_cross, aux


def _encoder_fwd(params, cfg: ModelConfig, frames):
    """frames: (B, enc_len, d_model) stub conv-frontend embeddings."""
    x = frames.to(torch_dtype(cfg.dtype))
    x = x + sinusoidal_table(x.shape[1], cfg.d_model,
                             device=x.device).to(x.dtype)[None]
    enc_cfg = _encoder_cfg(cfg)
    for lp in params["encoder"]:
        x, _, _, _ = _block_fwd("attn", lp, x, enc_cfg, cache=None,
                                pos_offset=0, window_override=None)
    return norm_fwd(params["enc_norm"], x, cfg.norm)


def _group_fwd(kinds, layers, x, cfg: ModelConfig, **kw):
    """One group of layers without a cache: the unit ``remat`` recomputes."""
    aux_total = 0.0
    for kind, bp in zip(kinds, layers):
        x, _, _, aux = _block_fwd(kind, bp, x, cfg, cache=None, **kw)
        aux_total = aux_total + aux
    return x, aux_total


def forward(params, cfg: ModelConfig, tokens, *, cache=None, pos_offset=0,
            extra_embeds=None, frames=None, window_override=None,
            active=None, n_valid=None, last_only: bool = False,
            block_tables=None, page_size: int = 0, remat: bool = False,
            append_external: bool = False,
            logits_slice: Optional[int] = None,
            rows: Optional[PackedRows] = None):
    """Run the decoder stack.

    tokens: (B, T) int token ids, or None when ``extra_embeds`` carry
        the whole chunk.
    cache: None (full-sequence prefill), from ``init_cache`` (the dense
        slot cache), or from ``init_paged_cache`` when ``block_tables``
        is given; written in place.
    pos_offset: absolute position of the chunk's first row (int or (B,)
        tensor).
    extra_embeds: (B, Tp, d_model) patch embeddings prepended to the token
        embeddings (VLM stub frontend).
    frames: (B, enc_len, d_model) audio frames (enc-dec only); runs the
        encoder and replaces the cross K/V of every row of a dense cache.
    window_override: a sliding window for every attention layer.
    active: optional (B,) bool — inactive slots write no state.
    n_valid: optional (B,) valid-token counts; pad tokens write no state.
    last_only: project only each row's last valid position to vocab.
    logits_slice: if set (and not ``last_only``), project only the last
        ``logits_slice`` positions to vocab.
    block_tables: (B, pages_per_slot) int physical-page table for a paged
        cache; with ``page_size`` it routes attention through the paged
        kernels.
    remat: recompute each group of ``pattern_len`` layers in the backward
        pass instead of keeping its activations, as the reference's
        ``jax.checkpoint(group_step)``; the tail blocks are kept.  Only
        without a cache.
    append_external: a dense cache's attention layers are read, not
        written: each chunk's K/V joins the attention as an in-flight tile
        and comes back as a delta.  The returned cache is then the
        reference's: ``blocks`` holds one dict per pattern position of
        ``k_delta``/``v_delta`` (G, B, T, KV, hd) and ``pos_delta``
        (G, B, T), ``tail`` one per tail block without the G axis, and
        ``cross`` the cross K/V.  A recurrent layer's state is still
        updated in place, and its entry is that state.
    rows: a paged engine's packed step (``mixers.packed_rows``), with
        ``block_tables`` and ``page_size``: ``tokens`` is then the (N,)
        row stream, every token-wise op runs on its N rows,
        ``pos_offset``, ``active`` and ``n_valid`` are not read, and
        ``last_only`` takes each slot's last row, so the logits are
        (B, 1, vocab) as in the (B, T) layout.
    Returns (logits f32, cache, aux_loss): the MoE load-balance terms
    summed over layers, 0 for a dense model.
    """
    if remat and cache is not None:
        raise ValueError("remat recomputes the layers in the backward pass "
                         "and takes no cache: a recompute would write the "
                         "cache twice")
    if rows is not None and block_tables is None:
        raise ValueError("packed rows run only over a paged cache")
    dt = torch_dtype(cfg.dtype)
    if rows is not None:
        tokens = tokens[None]             # the rows as a (1, N) batch
    x = params["embed"][tokens.long()].to(dt) if tokens is not None else None
    if extra_embeds is not None:
        ee = extra_embeds.to(dt)
        x = ee if x is None else torch.cat([ee, x], dim=1)
    B, T, _ = x.shape
    dev = x.device
    token_mask = None
    if n_valid is not None:
        token_mask = torch.arange(T, device=dev)[None] < n_valid[:, None]

    if cfg.pos_embedding in ("learned", "sinusoidal"):
        if rows is not None:
            pos = rows.pos[None]
        else:
            po = torch.as_tensor(pos_offset, device=dev).long()
            ar = torch.arange(T, device=dev)
            pos = (po[:, None] + ar[None]) if po.dim() else (po + ar)
        if cfg.pos_embedding == "learned":
            pe = params["pos_embed"][pos]
        else:
            pe = _sinusoidal_of(pos.reshape(-1), cfg.d_model).reshape(
                pos.shape + (cfg.d_model,))
        x = x + (pe if pos.dim() == 2 else pe[None]).to(dt)

    enc_out = None
    if cfg.cross_attention and frames is not None:
        enc_out = _encoder_fwd(params, cfg, frames)
    cross = cache.get("cross") if (cache and cfg.cross_attention) else None

    rope = None
    if cache is not None and cfg.pos_embedding == "rope":
        rope = rope_tables(
            rows.pos[None] if rows is not None
            else _batch_positions(pos_offset, B, T, dev),
            cfg.hd, cfg.rope_theta, cfg.rope_fraction)
    plans = {}                    # cache-write plans, shared by the layers
    aux_total = 0.0
    G, PL = cfg.n_groups, cfg.pattern_len
    kinds = _layer_kinds(cfg)
    deltas = []                   # append_external: each layer's new cache
    first = 0                     # the first layer run outside a remat group
    if remat:
        first = G * PL
        # the backward's recompute may run on autograd's device thread,
        # where this thread's shard context is unset: carry it there
        group, rank = tp_axis(), tp_rank()

        def shard_context():
            return (contextlib.nullcontext(),
                    contextlib.nullcontext() if group is None
                    else tp_context(group, rank))

        for g in range(G):
            x, aux = checkpoint(
                _group_fwd, kinds[g * PL:(g + 1) * PL],
                params["layers"][g * PL:(g + 1) * PL], x, cfg,
                pos_offset=pos_offset, window_override=window_override,
                enc_out=enc_out, active=active, token_mask=token_mask,
                valid_len=n_valid, use_reentrant=False,
                context_fn=shard_context)
            aux_total = aux_total + aux
    for layer in range(first, cfg.n_layers):
        kind, bp = kinds[layer], params["layers"][layer]
        g, i = divmod(layer, PL)
        bc = None
        if cache is not None:
            bc = ({key: t[g] for key, t in cache["blocks"][i].items()}
                  if g < G else cache["tail"][i])
        cc = None
        if cross is not None:
            cc = {"xk": cross["xk"][layer], "xv": cross["xv"][layer]}
        x, nc, nx, aux = _block_fwd(
            kind, bp, x, cfg, cache=bc, pos_offset=pos_offset,
            window_override=window_override, cross_cache=cc,
            enc_out=enc_out, active=active, token_mask=token_mask,
            valid_len=n_valid, block_tables=block_tables,
            page_size=page_size, rope=rope, plans=plans,
            append_external=append_external, rows=rows)
        aux_total = aux_total + aux
        if append_external and cache is not None:
            deltas.append(nc)
        if enc_out is not None and cc is not None:
            # fresh cross K/V for every row, as the reference stores them
            cc["xk"].copy_(nx["xk"])
            cc["xv"].copy_(nx["xv"])

    new_cache = cache
    if deltas:
        new_cache = {"blocks": tuple(
            {k: torch.stack([deltas[g * PL + i][k] for g in range(G)])
             for k in deltas[i]} for i in range(PL))}
        if cfg.tail_kinds:
            new_cache["tail"] = tuple(deltas[G * PL:])
        if cfg.cross_attention:
            new_cache["cross"] = cache["cross"]

    x = norm_fwd(params["final_norm"], x, cfg.norm)
    if last_only and rows is not None:
        x = x[0, rows.last][:, None]
    elif last_only:
        idx = ((n_valid.long() - 1).clamp(min=0) if n_valid is not None
               else torch.full((B,), T - 1, device=dev, dtype=torch.long))
        x = x[torch.arange(B, device=dev), idx][:, None]
    elif logits_slice is not None:
        x = x[:, -logits_slice:]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(x.dtype)).float()
    if not torch.is_tensor(aux_total):   # filled on the device: no copy
        aux_total = torch.full((), aux_total, device=dev)
    return logits, new_cache, aux_total.to(torch.float32)


# ==========================================================================
# training loss
# ==========================================================================
def loss_fn(params, cfg: ModelConfig, batch, aux_weight: float = 0.01,
            remat: bool = False):
    """batch: {tokens, labels[, extra_embeds, frames]} as tensors on the
    params' device; labels use -100 to mask (e.g. patch positions).  The
    logits are cut to the labels' length; the mean NLL over valid labels
    plus ``aux_weight * aux / n_layers``.  Returns (loss, {"nll", "aux"})."""
    logits, _, aux = forward(
        params, cfg, batch.get("tokens"),
        extra_embeds=batch.get("extra_embeds"),
        frames=batch.get("frames"), remat=remat)
    labels = batch["labels"]
    Tl = labels.shape[1]
    logits = logits[:, -Tl:]
    valid = labels >= 0
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    loss = nll.sum() / valid.sum().clamp(min=1)
    return loss + aux_weight * aux / cfg.n_layers, {"nll": loss, "aux": aux}
