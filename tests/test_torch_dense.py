"""The port's dense slot cache, its full-sequence and cached attention
branches (the ring buffer included), cross-attention, the audio encoder
and the stub frontends, against the JAX package.

Both packages get the same numpy inputs, made from a seed, and the same
weights: the JAX ``init_params`` tree with random biases and norm scales
(``init_params`` leaves them at 0 / 1, which would hide a bias or norm
bug), converted with ``repro_torch.convert.params_from_jax``.  Smoke
configs in f32.  Tolerances: mixers ``rtol=1e-4, atol=1e-5``; whole-model
logits ``rtol=atol=3e-4``, the JAX package's own bound in
``tests/test_model_consistency.py``; cache positions exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.mixers as jmx  # noqa: E402
import repro_torch.models.mixers as tmx  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

MIX = dict(rtol=1e-4, atol=1e-5)
MODEL = dict(rtol=3e-4, atol=3e-4)
BIASES = ("bq", "bk", "bv", "bias", "conv_b", "b_a", "b_x")
SCALES = ("scale", "q_norm", "k_norm", "norm", "D")


def randomize(tree, rng):
    """Random biases (std 0.5) and norm scales (1 +- 0.3), in place on a
    numpy tree, wherever the tree has them."""
    if isinstance(tree, (list, tuple)):
        for t in tree:
            randomize(t, rng)
        return tree
    for key, val in tree.items():
        if isinstance(val, (dict, list, tuple)):
            randomize(val, rng)
        elif key in BIASES:
            tree[key] = (0.5 * rng.standard_normal(val.shape)).astype(
                val.dtype)
        elif key in SCALES:
            tree[key] = (1 + 0.3 * rng.standard_normal(val.shape)).astype(
                val.dtype)
    return tree


def weights(arch, seed=0, **overrides):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    jcfg = jconfigs.get_smoke_config(arch).with_(**overrides)
    cfg = get_smoke_config(arch).with_(**overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np_params = randomize(jax.tree.map(
        np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(seed))),
        np.random.default_rng(seed))
    return (jcfg, jax.tree.map(jnp.asarray, np_params), cfg,
            params_from_jax(np_params, cfg, device="cpu"))


def close(got, exp, tol=MIX):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), **tol)


def same_cache(got, exp, tol=MIX):
    """Every leaf equal within ``tol``; positions (int) exactly."""
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    el = jax.tree_util.tree_flatten_with_path(exp)[0]
    assert [p for p, _ in gl] == [p for p, _ in el]
    for (path, g), (_, e) in zip(gl, el):
        e = np.asarray(e)
        assert tuple(g.shape) == e.shape, path
        if e.dtype == np.int32:
            assert np.array_equal(g.numpy(), e), path
        else:
            np.testing.assert_allclose(g.numpy(), e, err_msg=str(path),
                                       **tol)


@pytest.fixture()
def flash_min_kv():
    """Set ``FLASH_MIN_KV`` in both packages; restore afterwards."""
    old = jmx.FLASH_MIN_KV, tmx.FLASH_MIN_KV

    def set_(n):
        jmx.FLASH_MIN_KV = tmx.FLASH_MIN_KV = n

    yield set_
    jmx.FLASH_MIN_KV, tmx.FLASH_MIN_KV = old


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------
def test_sinusoidal_tables_match_jax():
    np.testing.assert_array_equal(
        tlayers.sinusoidal_table(40, 64).numpy(),
        np.asarray(jlayers.sinusoidal_table(40, 64)))
    pos = np.array([0, 3, 17, 1499, 40000], np.int32)
    close(tmodel._sinusoidal_of(torch.from_numpy(pos), 64),
          jmodel._sinusoidal_of(jnp.asarray(pos), 64))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def _qkv(rng, B=2, Tq=4, S=40, H=8, KV=2, hd=32):
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, Tq, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    kpos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kpos[1, 30:] = -1                              # empty slots
    qpos = np.stack([30 + np.arange(Tq), 26 + np.arange(Tq)]).astype(
        np.int32)
    return q, k, v, qpos, kpos


@pytest.mark.parametrize("window", [0, 12])
@pytest.mark.parametrize("extra", [False, True])
def test_flash_gqa_matches_scores_to_out_and_jax(extra, window):
    """Tiles of 16 keys (a padded last tile) with and without the in-flight
    ``extra`` tile: equal to the materialized softmax over the same keys
    and to the reference's ``_flash_gqa``, statistics included."""
    rng = np.random.default_rng(0)
    q, k, v, qpos, kpos = _qkv(rng)
    cfg = get_smoke_config("chatglm3-6b")
    ex_np = None
    if extra:
        ek, ev = (rng.standard_normal((2, 4, 2, 32)).astype(np.float32)
                  for _ in range(2))
        ex_np = (ek, ev, qpos)
    T = [torch.from_numpy(a) for a in (q, k, v, qpos, kpos)]
    J = [jnp.asarray(a) for a in (q, k, v, qpos, kpos)]
    tx = None if ex_np is None else tuple(torch.from_numpy(a) for a in ex_np)
    jx = None if ex_np is None else tuple(jnp.asarray(a) for a in ex_np)
    got = tmx._flash_gqa(cfg, *T, window=window, block=16, extra=tx)
    close(got, jmx._flash_gqa(cfg, *J, window=window, block=16, extra=jx))
    for g, e in zip(tmx._flash_gqa(cfg, *T, window=window, block=16,
                                   extra=tx, return_stats=True),
                    jmx._flash_gqa(cfg, *J, window=window, block=16,
                                   extra=jx, return_stats=True)):
        close(g, e)
    kk, vv, kp = T[1], T[2], T[4]
    if extra:
        kk, vv = torch.cat([kk, tx[0]], 1), torch.cat([vv, tx[1]], 1)
        kp = torch.cat([kp, tx[2]], 1)
    qp = T[3]
    mask = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None])
    if window:
        mask &= (qp[:, :, None] - kp[:, None, :]) < window
    close(got, tmx._gqa_scores_to_out(cfg, T[0], kk, vv, mask).numpy())


# ---------------------------------------------------------------------------
# attention_fwd, branch by branch
# ---------------------------------------------------------------------------
def _attn_setup(seed, **overrides):
    jcfg, jp, cfg, tp = weights("chatglm3-6b", seed, **overrides)
    return (jcfg, jax.tree.map(lambda a: a[0], jp["blocks"][0]["mixer"]),
            cfg, tp["layers"][0]["mixer"])


def _empty_cache(B, S, KV, hd):
    return {"k": np.zeros((B, S, KV, hd), np.float32),
            "v": np.zeros((B, S, KV, hd), np.float32),
            "pos": np.full((B, S), -1, np.int32)}


def _both(c):
    """One layer's cache for each package; the port's written leaves
    with the scratch row its write plans aim dropped rows at."""
    def leaf(k, v):
        if k not in tmodel.ROW_DIMS:
            return torch.from_numpy(v.copy())
        t = tmodel.cache_leaf((1, *v.shape), torch.from_numpy(v).dtype,
                              "cpu", row_dims=tmodel.ROW_DIMS[k])[0]
        return t.copy_(torch.from_numpy(v))
    return ({k: jnp.asarray(v) for k, v in c.items()},
            {k: leaf(k, v) for k, v in c.items()})


def _run_both(jcfg, jp, cfg, tp, x, jcache, tcache, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jy, jc = jmx.attention_fwd(jp, jnp.asarray(x), jcfg, cache=jcache, **jkw)
    ty, tc = tmx.attention_fwd(tp, torch.from_numpy(x), cfg, cache=tcache,
                               **tkw)
    close(ty, jy)
    return jc, tc


@pytest.mark.parametrize("T,min_kv", [(12, None), (40, 16)])
@pytest.mark.parametrize("window", [None, 8])
def test_attention_full_sequence(flash_min_kv, T, min_kv, window):
    """No cache: the materialized causal softmax below ``FLASH_MIN_KV``
    and the flash path above it, with and without a window."""
    if min_kv is not None:
        flash_min_kv(min_kv)
    jcfg, jp, cfg, tp = _attn_setup(1)
    x = np.random.default_rng(2).standard_normal((2, T, 256)).astype(
        np.float32)
    jc, tc = _run_both(jcfg, jp, cfg, tp, x, None, None,
                       window_override=window)
    assert jc is None and tc is None


@pytest.mark.parametrize("min_kv", [None, 16])
def test_attention_full_prompt_prefill_is_the_cache(flash_min_kv, min_kv):
    """A chunk at position 0 that covers the whole buffer becomes the
    cache (no scatter), through either attention."""
    if min_kv is not None:
        flash_min_kv(min_kv)
    jcfg, jp, cfg, tp = _attn_setup(3)
    x = np.random.default_rng(4).standard_normal((2, 24, 256)).astype(
        np.float32)
    jc, tc = _both(_empty_cache(2, 24, 2, 32))
    jc, tc = _run_both(jcfg, jp, cfg, tp, x, jc, tc, pos_offset=0)
    same_cache(tc, jc)


@pytest.mark.parametrize("min_kv", [None, 16])
def test_attention_scatter_with_active_and_token_mask(flash_min_kv, min_kv):
    """Rows at their own offsets; an inactive row and pad tokens write
    nothing; a second chunk attends over the first."""
    if min_kv is not None:
        flash_min_kv(min_kv)
    jcfg, jp, cfg, tp = _attn_setup(5)
    rng = np.random.default_rng(6)
    jc, tc = _both(_empty_cache(3, 40, 2, 32))
    for T, off, act, n in ((10, [0, 0, 0], [True, False, True], [10, 10, 7]),
                           (6, [10, 4, 7], [True, True, True], [6, 6, 2])):
        x = rng.standard_normal((3, T, 256)).astype(np.float32)
        token_mask = np.arange(T)[None] < np.array(n)[:, None]
        jc, tc = _run_both(jcfg, jp, cfg, tp, x, jc, tc,
                           pos_offset=np.array(off, np.int32),
                           active=np.array(act), token_mask=token_mask)
        same_cache(tc, jc)


def test_attention_append_external_leaves_the_cache():
    jcfg, jp, cfg, tp = _attn_setup(7)
    rng = np.random.default_rng(8)
    jc, tc = _both(_empty_cache(2, 32, 2, 32))
    x = rng.standard_normal((2, 12, 256)).astype(np.float32)
    jc, tc = _run_both(jcfg, jp, cfg, tp, x, jc, tc,
                       pos_offset=np.zeros(2, np.int32))
    before = {k: v.clone() for k, v in tc.items()}
    x = rng.standard_normal((2, 1, 256)).astype(np.float32)
    jd, td = _run_both(jcfg, jp, cfg, tp, x, jc, tc,
                       pos_offset=np.array([12, 12], np.int32),
                       append_external=True)
    assert set(td) == set(jd) == {"k_delta", "v_delta", "pos_delta"}
    same_cache(td, {k: np.asarray(v).astype(
        np.int32 if k == "pos_delta" else np.float32) for k, v in jd.items()})
    assert all(torch.equal(before[k], tc[k]) for k in tc)


@pytest.mark.parametrize("masked", [False, True])
def test_ring_buffer_chunk_longer_than_the_window(masked):
    """A 20-token chunk into an 8-slot ring maps positions p and p + 8
    (and p + 16) to one slot: the last valid writer wins in both packages,
    and a query that lost its early keys to the wrap sees what the
    reference's query sees (the write precedes the attention).  With pads
    (``masked``) the pads' slots keep the valid writers."""
    jcfg, jp, cfg, tp = _attn_setup(9, window=8)
    rng = np.random.default_rng(10)
    jc, tc = _both(_empty_cache(2, 8, 2, 32))
    kw = {}
    if masked:
        kw["token_mask"] = np.arange(20)[None] < np.array([[20], [13]])
    for T, off in ((20, [3, 0]), (1, [23, 20])):
        x = rng.standard_normal((2, T, 256)).astype(np.float32)
        if T == 1:
            kw = {}
        jc, tc = _run_both(jcfg, jp, cfg, tp, x, jc, tc, kind="local_attn",
                           pos_offset=np.array(off, np.int32), **kw)
        same_cache(tc, jc)
    if masked:
        # row 1 had 13 valid tokens (positions 0..12): the ring kept
        # 5..12, and the decode token at 20 took the slot of 12
        assert sorted(tc["pos"][1].tolist()) == [5, 6, 7, 8, 9, 10, 11, 20]


def test_cross_attention_matches_jax():
    jcfg, jp, cfg, tp = weights("whisper-large-v3", 11)
    jx = jax.tree.map(lambda a: a[0], jp["blocks"][0]["cross"])
    tx = tp["layers"][0]["cross"]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    enc = rng.standard_normal((2, 32, 256)).astype(np.float32)
    cache = {k: np.zeros((2, 32, 8, 32), np.float32) for k in ("xk", "xv")}
    jy, jc = jmx.cross_attention_fwd(jx, jnp.asarray(x), jcfg,
                                     enc_out=jnp.asarray(enc),
                                     cache=_both(cache)[0])
    ty, tc = tmx.cross_attention_fwd(tx, torch.from_numpy(x), cfg,
                                     enc_out=torch.from_numpy(enc),
                                     cache=_both(cache)[1])
    close(ty, jy)
    same_cache(tc, jc)
    jy2, _ = jmx.cross_attention_fwd(jx, jnp.asarray(x[:, :1]), jcfg,
                                     cache=jc)
    ty2, _ = tmx.cross_attention_fwd(tx, torch.from_numpy(x[:, :1]), cfg,
                                     cache=tc)
    close(ty2, jy2)
    jy3, none = jmx.cross_attention_fwd(jx, jnp.asarray(x), jcfg,
                                        enc_out=jnp.asarray(enc))
    ty3, tnone = tmx.cross_attention_fwd(tx, torch.from_numpy(x), cfg,
                                         enc_out=torch.from_numpy(enc))
    close(ty3, jy3)
    assert none is None and tnone is None


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
def _frontend_inputs(cfg, B, seed):
    rng = np.random.default_rng(seed)
    extra = {}
    if cfg.arch_type == "vlm":
        extra["extra_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model))).astype(np.float32)
    if cfg.arch_type == "audio":
        extra["frames"] = (0.02 * rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model))).astype(np.float32)
    return extra


def chunked_against_jax(arch, B=2, T=16, max_len=64, seed=0, **overrides):
    """The reference's consistency check (full sequence, then a 10-token
    chunk and decode steps through a dense cache), with the port held
    against JAX at every step and on the final cache.  Returns the port's
    full-sequence and chunked logits."""
    jcfg, jp, cfg, tp = weights(arch, seed, **overrides)
    toks = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    extra = _frontend_inputs(cfg, B, seed + 2)
    jx = {k: jnp.asarray(v) for k, v in extra.items()}
    tx = {k: torch.from_numpy(v) for k, v in extra.items()}
    jl, _, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks), **jx)
    full, _, _ = tmodel.forward(tp, cfg, torch.from_numpy(toks), **tx)
    close(full, jl, MODEL)
    jc = jmodel.init_cache(jcfg, B, max_len)
    tc = tmodel.init_cache(cfg, B, max_len, device="cpu")
    jl, jc, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks[:, :10]),
                               cache=jc, pos_offset=0, **jx)
    tl, tc, _ = tmodel.forward(tp, cfg, torch.from_numpy(toks[:, :10]),
                               cache=tc, pos_offset=0, **tx)
    close(tl, jl, MODEL)
    outs = [tl[:, -10:]]
    off = 10 + (cfg.num_patches if cfg.arch_type == "vlm" else 0)
    for t in range(10, T):
        jl, jc, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks[:, t:t + 1]),
                                   cache=jc, pos_offset=off)
        tl, tc, _ = tmodel.forward(tp, cfg, torch.from_numpy(
            toks[:, t:t + 1]), cache=tc, pos_offset=off)
        close(tl, jl, MODEL)
        outs.append(tl)
        off += 1
    same_cache(tc, jc, MODEL)
    return full, torch.cat(outs, dim=1)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-76b"])
def test_frontend_models_chunked_match_jax_and_full(arch):
    """Whisper (encoder on frames, cross K/V in the cache, learned
    positions) and InternVL2 (patch embeddings before the tokens)."""
    full, chunked = chunked_against_jax(arch)
    close(chunked, full[:, -16:].numpy(), MODEL)


@pytest.mark.parametrize("pos_embedding", ["learned", "sinusoidal"])
def test_added_position_embeddings_match_jax(pos_embedding):
    chunked_against_jax("chatglm3-6b", pos_embedding=pos_embedding)


def test_window_override_ring_matches_jax_and_windowed_full():
    """chatglm3 with ``window_override=16``: 40 single-token steps through
    a 16-slot ring equal the windowed full-sequence forward, in both
    packages (the reference's
    ``test_sliding_window_ring_buffer_matches_windowed_full``)."""
    jcfg, jp, cfg, tp = weights("chatglm3-6b", 13)
    W, B, T = 16, 2, 40
    toks = np.random.default_rng(14).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    jfull, _, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks),
                                 window_override=W)
    full, _, _ = tmodel.forward(tp, cfg, torch.from_numpy(toks),
                                window_override=W)
    close(full, jfull, MODEL)
    jc = jmodel.init_cache(jcfg, B, max_len=T, window_override=W)
    tc = tmodel.init_cache(cfg, B, max_len=T, window_override=W,
                           device="cpu")
    assert tc["blocks"][0]["k"].shape[2] == W
    outs = []
    for t in range(T):
        jl, jc, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks[:, t:t + 1]),
                                   cache=jc, pos_offset=t, window_override=W)
        tl, tc, _ = tmodel.forward(tp, cfg, torch.from_numpy(
            toks[:, t:t + 1]), cache=tc, pos_offset=t, window_override=W)
        close(tl, jl, MODEL)
        outs.append(tl)
    same_cache(tc, jc, MODEL)
    close(torch.cat(outs, 1), full.numpy(), MODEL)


# ---------------------------------------------------------------------------
# init_cache and init_params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_init_cache_equals_jax_layout(arch):
    """Shapes, dtypes and fill (-1 positions, zero state) of the dense
    cache equal the reference's for every config, windowed too."""
    for wo in (None, 8):
        jc = jmodel.init_cache(jconfigs.get_smoke_config(arch), 3, 24,
                               window_override=wo)
        tc = tmodel.init_cache(get_smoke_config(arch), 3, 24,
                               window_override=wo, device="cpu")
        gl = jax.tree_util.tree_flatten_with_path(tc)[0]
        el = jax.tree_util.tree_flatten_with_path(jc)[0]
        assert [p for p, _ in gl] == [p for p, _ in el]
        for (path, g), (_, e) in zip(gl, el):
            assert tuple(g.shape) == e.shape, path
            assert str(g.dtype).replace("torch.", "") == str(e.dtype), path
            assert np.array_equal(g.numpy(), np.asarray(e)), path


def test_decode_state_is_bounded():
    """The reference's ``test_long_context_decode_state_is_bounded``."""
    for name in ["mamba2-780m", "recurrentgemma-9b"]:
        cfg = get_smoke_config(name)
        s1, s2 = (sum(t.numel() for t in jax.tree.leaves(
            tmodel.init_cache(cfg, 1, n, device="cpu"))) for n in (128, 4096))
        if cfg.is_attention_free:
            assert s1 == s2, name
        else:
            assert s2 <= s1 * (4096 / 128), name


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b",
                                  "whisper-large-v3", "internvl2-76b"])
def test_init_params_matches_reference_structure_and_scales(arch):
    """Every leaf of the reference's tree, converted, has a counterpart of
    the same shape and dtype and about the same spread in the port's own
    ``init_params`` (tail blocks, encoder, cross-attention, SSD and RG-LRU
    parameters, learned positions)."""
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = get_smoke_config(arch)
    ref = params_from_jax(jax.tree.map(np.asarray, jmodel.init_params(
        jcfg, jax.random.PRNGKey(0))), cfg, device="cpu")
    got = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_got]
    for (path, a), (_, b) in zip(flat_ref, flat_got):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        sa, sb = float(a.float().std()), float(b.float().std())
        ma, mb = float(a.float().mean()), float(b.float().mean())
        assert abs(sa - sb) <= 0.25 * sa + 1e-6, (path, sa, sb)
        # means within four standard errors (uniform leaves are short)
        assert abs(ma - mb) <= 4 * sa / a.numel() ** 0.5 + 1e-6, \
            (path, ma, mb)
