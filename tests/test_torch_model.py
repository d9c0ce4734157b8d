"""The port's paged-KV forward against the JAX package's, on the same
weights.

The JAX ``init_params`` builds the Qwen2.5-14B smoke config (f32, 2
layers, d_model 256); the qkv biases and norm scales are then set to
random values in the numpy tree both packages receive (``init_params``
leaves them at 0 / 1, which would hide a bias or norm bug), and
``repro_torch.convert.params_from_jax`` maps the tree onto the port.
Logits agree to 1e-4 (f32, different summation order).  The JAX paged
forward runs its Pallas kernels in interpret mode on the CPU; the port
takes its plain attention because the tensors lie on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax, to_torch  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

TOL = 1e-4
PAGE = 8


def randomize_biases_and_norms(np_params, seed=0):
    """Random qkv biases and norm scales, in place on a numpy tree."""
    rng = np.random.default_rng(seed)

    def noise(a, base, scale):
        return (base + scale * rng.standard_normal(a.shape)).astype(a.dtype)

    for blk in np_params["blocks"]:
        mixer = blk["mixer"]
        for key in ("bq", "bk", "bv"):
            mixer[key] = noise(mixer[key], 0.0, 0.5)
        for norm in ("norm1", "norm2"):
            blk[norm]["scale"] = noise(blk[norm]["scale"], 1.0, 0.3)
    np_params["final_norm"]["scale"] = noise(
        np_params["final_norm"]["scale"], 1.0, 0.3)
    return np_params


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config("qwen2.5-14b")
    cfg = get_smoke_config("qwen2.5-14b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np_params = jax.tree.map(np.asarray,
                             jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    np_params = randomize_biases_and_norms(np_params)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = params_from_jax(np_params, cfg, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    full, _, _ = jmodel.forward(jparams, jcfg, jnp.asarray(toks))
    return cfg, jcfg, jparams, tparams, toks, np.asarray(full)


def _tables(B, n_pp, offset=1):
    """Disjoint per-row page tables that leave page 0 to nobody."""
    t = offset + np.arange(B * n_pp, dtype=np.int32).reshape(B, n_pp)
    return t, torch.from_numpy(t)


def _port_fwd(tparams, cfg, cache, toks, pos, tbl, **kw):
    pos = torch.as_tensor(np.asarray(pos)) if not isinstance(pos, int) \
        else pos
    with torch.no_grad():
        lg, cache, _ = tmodel.forward(
            tparams, cfg, torch.from_numpy(np.asarray(toks)), cache=cache,
            pos_offset=pos, block_tables=tbl, page_size=PAGE, **kw)
    return lg.numpy()


def test_paged_forward_matches_jax_paged_and_full(setup):
    cfg, jcfg, jparams, tparams, toks, full = setup
    B, T = toks.shape
    jt, tt = _tables(B, 4)
    n_pages = 1 + B * 4
    jcache = jmodel.init_paged_cache(jcfg, n_pages, PAGE)
    jl, _, _ = jmodel.forward(jparams, jcfg, jnp.asarray(toks), cache=jcache,
                              pos_offset=0, block_tables=jnp.asarray(jt),
                              page_size=PAGE)
    tcache = tmodel.init_paged_cache(cfg, n_pages, PAGE, device="cpu")
    tl = _port_fwd(tparams, cfg, tcache, toks, 0, tt)
    assert tl.dtype == np.float32 and tl.shape == (B, T, cfg.vocab_size)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl, full, rtol=TOL, atol=TOL)


def test_chunked_prefill_then_decode_matches_full(setup):
    """A 10-token chunk, then one decode step at a time, through the
    paged pool (mirrors test_model_consistency's chunked-vs-full)."""
    cfg, _, _, tparams, toks, full = setup
    B, T = toks.shape
    _, tt = _tables(B, 3)
    cache = tmodel.init_paged_cache(cfg, 1 + B * 3, PAGE, device="cpu")
    outs = [_port_fwd(tparams, cfg, cache, toks[:, :10], 0, tt)]
    for t in range(10, T):
        outs.append(_port_fwd(tparams, cfg, cache, toks[:, t:t + 1],
                              np.full(B, t), tt))
    np.testing.assert_allclose(np.concatenate(outs, axis=1), full,
                               rtol=TOL, atol=TOL)


def test_padded_mixed_batch_matches_exact(setup):
    """A chunk padded past ``n_valid`` writes no K/V for its pad tokens,
    and the next chunk's last-token logits equal the unpadded run's."""
    cfg, _, _, tparams, toks, full = setup
    B = toks.shape[0]
    _, tt = _tables(B, 3)
    cache = tmodel.init_paged_cache(cfg, 1 + B * 3, PAGE, device="cpu")
    padded = np.concatenate([toks[:, :12], np.zeros((B, 4), np.int32)], 1)
    _port_fwd(tparams, cfg, cache, padded, np.zeros(B, np.int32), tt,
              active=torch.ones(B, dtype=torch.bool),
              n_valid=torch.full((B,), 12))
    # positions 12..15 of each row were never written
    k0 = cache["blocks"][0]["k_pages"]
    for b in range(B):
        assert not k0[:, 1 + b * 3 + 1, 4:].any()
    last = _port_fwd(tparams, cfg, cache, toks[:, 12:], np.full(B, 12), tt,
                     active=torch.ones(B, dtype=torch.bool),
                     n_valid=torch.full((B,), 8), last_only=True)
    assert last.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(last[:, 0], full[:, -1], rtol=TOL, atol=TOL)


def test_inactive_slots_and_pads_never_touch_page_zero(setup):
    """Inactive slots write nothing; their zero-padded table rows point
    at page 0, which a live sequence owns here and must keep intact."""
    cfg, _, _, tparams, toks, _ = setup
    B = 3
    tt = torch.tensor([[0, 1], [2, 3], [0, 0]], dtype=torch.int32)
    cache = tmodel.init_paged_cache(cfg, 4, PAGE, device="cpu")
    tk = np.concatenate([toks, toks[:1]])[:, :8]
    _port_fwd(tparams, cfg, cache, tk, 0, tt,
              active=torch.tensor([True, True, False]),
              n_valid=torch.tensor([8, 5, 8]))
    before = [{k: v.clone() for k, v in blk.items()}
              for blk in cache["blocks"]]
    # row 1 decodes; rows 0 and 2 are inactive (row 2's table is all
    # page 0, row 0 would write page 1)
    _port_fwd(tparams, cfg, cache, tk[:, :1], np.array([8, 5, 0]), tt,
              active=torch.tensor([False, True, False]))
    for blk, old in zip(cache["blocks"], before):
        for key in blk:
            assert torch.equal(blk[key][:, 0], old[key][:, 0]), key
            assert torch.equal(blk[key][:, 1], old[key][:, 1]), key
            assert not torch.equal(blk[key][:, 2], old[key][:, 2]), key


@pytest.mark.parametrize("what", ["norm", "rope", "mlp", "head_norm"])
def test_layers_match_jax(setup, what):
    cfg = setup[0]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    if what == "norm":
        p = {"scale": 1 + 0.3 * rng.standard_normal(cfg.d_model)
             .astype(np.float32)}
        exp = jlayers.norm_fwd(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               "rmsnorm")
        got = tlayers.norm_fwd(jax.tree.map(torch.from_numpy, p),
                               torch.from_numpy(x), "rmsnorm")
    elif what == "head_norm":
        h = rng.standard_normal((2, 5, 4, cfg.hd)).astype(np.float32)
        s = (1 + 0.3 * rng.standard_normal(cfg.hd)).astype(np.float32)
        exp = jlayers.rms_head_norm(jnp.asarray(s), jnp.asarray(h))
        got = tlayers.rms_head_norm(torch.from_numpy(s), torch.from_numpy(h))
    elif what == "rope":
        # interleaved even/odd pairs, per-row positions, far-out offsets
        h = rng.standard_normal((2, 5, 4, cfg.hd)).astype(np.float32)
        pos = np.array([[0, 1, 2, 3, 4], [4093, 4094, 4095, 4096, 4097]],
                       np.int32)
        sin, cos = jlayers.rope_tables(jnp.asarray(pos), cfg.hd,
                                       cfg.rope_theta)
        exp = jlayers.apply_rope(jnp.asarray(h), sin, cos)
        got = tlayers.apply_rope(torch.from_numpy(h), *tlayers.rope_tables(
            torch.from_numpy(pos), cfg.hd, cfg.rope_theta))
    else:
        p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
             for k, s in (("wi", (cfg.d_model, cfg.d_ff)),
                          ("wg", (cfg.d_model, cfg.d_ff)),
                          ("wo", (cfg.d_ff, cfg.d_model)))}
        exp, _ = jlayers.mlp_fwd(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), cfg)
        got, _ = tlayers.mlp_fwd(jax.tree.map(torch.from_numpy, p),
                                 torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                               rtol=1e-5, atol=1e-5)


def test_params_from_jax_keeps_bf16_bits():
    """bf16 weights cross by their raw bits: no ml_dtypes on the torch
    side, and no rounding on the way."""
    jcfg = jax_smoke_config("qwen2.5-14b").with_(dtype="bfloat16")
    cfg = get_smoke_config("qwen2.5-14b").with_(dtype="bfloat16")
    np_params = jax.tree.map(np.asarray,
                             jmodel.init_params(jcfg, jax.random.PRNGKey(3)))
    tp = params_from_jax(np_params, cfg, device="cpu")
    assert len(tp["layers"]) == cfg.n_layers
    for layer in range(cfg.n_layers):
        g, i = divmod(layer, len(cfg.layer_pattern))
        src = np_params["blocks"][i]["mixer"]["wq"][g]
        dst = tp["layers"][layer]["mixer"]["wq"]
        assert dst.dtype == torch.bfloat16 and dst.shape == src.shape
        assert np.array_equal(dst.view(torch.int16).numpy(),
                              src.view(np.int16))
    assert torch.equal(to_torch(np_params["embed"], "cpu").view(torch.int16),
                       torch.from_numpy(np_params["embed"].view(np.int16).copy()))


def test_init_params_matches_reference_structure_and_scales():
    jcfg = jax_smoke_config("qwen2.5-14b").with_(dtype="bfloat16")
    cfg = get_smoke_config("qwen2.5-14b").with_(dtype="bfloat16")
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
        assert abs(sa - sb) <= 0.1 * max(sa, 1e-3), (path, sa, sb)


def test_entry_points_need_a_card_unless_asked_for_cpu():
    cfg = get_smoke_config("qwen2.5-14b")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init_paged_cache(cfg, 4, PAGE)
