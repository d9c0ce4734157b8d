"""The port's recurrent mixers (Mamba2 SSD and the Griffin RG-LRU), the
causal convolution and the two recurrent models, against the JAX package.

Same numpy inputs and converted weights in both packages (f32 smoke
configs).  Tolerances: mixers ``rtol=1e-4, atol=1e-5``; whole-model
logits ``rtol=atol=3e-4``.  The RG-LRU recurrence is a log-depth
Hillis–Steele scan in the port and ``jax.lax.associative_scan`` in the
reference: two tree orders of the same sums, held to the mixer
tolerance.
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
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

MIX = dict(rtol=1e-4, atol=1e-5)
MODEL = dict(rtol=3e-4, atol=3e-4)


def weights(arch, seed=0):
    """(jax cfg, jax params, port cfg, port params) on the same weights,
    with random conv and gate biases and norm scales."""
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = get_smoke_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(seed)
    np_params = jax.tree.map(np.asarray, jmodel.init_params(
        jcfg, jax.random.PRNGKey(seed)))

    def walk(tree):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for key, val in list(items):
            if isinstance(val, (dict, list, tuple)):
                walk(val)
            elif key in ("conv_b", "b_a", "b_x"):
                tree[key] = (0.5 * rng.standard_normal(val.shape)).astype(
                    val.dtype)
            elif key in ("scale", "norm", "D"):
                tree[key] = (1 + 0.3 * rng.standard_normal(val.shape)) \
                    .astype(val.dtype)

    walk(np_params)
    return (jcfg, jax.tree.map(jnp.asarray, np_params), cfg,
            params_from_jax(np_params, cfg, device="cpu"))


def mixer(arch, seed=0):
    """One mixer's parameters (group 0 of pattern position 0)."""
    jcfg, jp, cfg, tp = weights(arch, seed)
    return (jcfg, jax.tree.map(lambda a: a[0], jp["blocks"][0]["mixer"]),
            cfg, tp["layers"][0]["mixer"])


def close(got, exp, tol=MIX):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), **tol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------
def test_segsum_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 2, 8)).astype(
        np.float32)
    got, exp = tmx._segsum(_t(x)).numpy(), np.asarray(jmx._segsum(
        jnp.asarray(x)))
    assert np.array_equal(np.isinf(got), np.isinf(exp))
    fin = np.isfinite(exp)
    np.testing.assert_allclose(got[fin], exp[fin], **MIX)


@pytest.mark.parametrize("with_tail", [False, True])
@pytest.mark.parametrize("valid", [None, [7, 3, 0]])
def test_causal_conv_with_valid_len(with_tail, valid):
    """The new tail comes from the last K-1 *valid* inputs; a row with no
    valid token keeps its old tail."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    tail = rng.standard_normal((3, 3, 16)).astype(np.float32) \
        if with_tail else None
    vl = None if valid is None else np.array(valid, np.int32)
    jo, jt = jmx._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              None if tail is None else jnp.asarray(tail),
                              None if vl is None else jnp.asarray(vl))
    to, tt = tmx._causal_conv(_t(x), _t(w), _t(b),
                              None if tail is None else _t(tail),
                              None if vl is None else _t(vl))
    close(to, jo)
    close(tt, jt)
    if valid is not None and with_tail:
        assert torch.equal(tt[2], _t(tail[2]))


@pytest.mark.parametrize("l,chunk", [(32, 8), (24, 24), (1, 1)])
def test_ssd_scan_matches_jax(l, chunk):
    rng = np.random.default_rng(2)
    b, h, p, n = 2, 4, 8, 16
    Xd = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dtA = -np.abs(rng.standard_normal((b, l, h))).astype(np.float32) * 0.3
    Bm = rng.standard_normal((b, l, h, n)).astype(np.float32)
    Cm = rng.standard_normal((b, l, h, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    jy, js = jmx.ssd_scan(*(jnp.asarray(a) for a in (Xd, dtA, Bm, Cm)),
                          chunk, jnp.asarray(s0))
    ty, ts = tmx.ssd_scan(*(_t(a) for a in (Xd, dtA, Bm, Cm)), chunk, _t(s0))
    close(ty, jy)
    close(ts, js)


def test_linear_scan_equals_the_sequential_recurrence():
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32)
    v = rng.standard_normal((2, 37, 5)).astype(np.float32)
    h, ref = np.zeros((2, 5), np.float32), []
    for t in range(37):
        h = a[:, t] * h + v[:, t]
        ref.append(h)
    close(tmx._linear_scan(_t(a), _t(v)), np.stack(ref, 1))


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------
def _mixer_case(arch, fwd_j, fwd_t, T, cached, seed):
    """One call of a recurrent mixer in both packages: a 3-row batch whose
    row 1 is inactive and row 2 carries pads; with ``cached`` a dense
    state from an earlier random call.  Inactive rows must keep their
    state, bit for bit."""
    jcfg, jp, cfg, tp = mixer(arch, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((3, T, cfg.d_model)).astype(np.float32)
    kw_j, kw_t = {}, {}
    jc = tc = None
    if cached:
        c0 = jax.tree.map(lambda a: a[0], jmodel.init_cache(jcfg, 3, 8)[
            "blocks"][0])
        c0 = {k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
              for k, v in c0.items()}
        jc = {k: jnp.asarray(v) for k, v in c0.items()}
        tc = {k: _t(v.copy()) for k, v in c0.items()}
        active = np.array([True, False, True])
        n_valid = np.array([T, T, max(1, T - 3)], np.int32)
        mask = np.arange(T)[None] < n_valid[:, None]
        kw_j = dict(active=jnp.asarray(active), token_mask=jnp.asarray(mask),
                    valid_len=jnp.asarray(n_valid))
        kw_t = dict(active=_t(active), token_mask=_t(mask),
                    valid_len=_t(n_valid))
    jy, jn = fwd_j(jp, jnp.asarray(x), jcfg, cache=jc, **kw_j)
    ty, tn = fwd_t(tp, _t(x), cfg, cache=tc, **kw_t)
    rows = [0, 2] if cached else [0, 1, 2]
    close(ty[rows], np.asarray(jy)[rows])
    if not cached:
        assert jn is None and tn is None
        return
    assert set(tn) == set(jn)
    for k in tn:
        close(tn[k], jn[k])
        assert torch.equal(tn[k][1], _t(c0[k][1])), k    # inactive row


@pytest.mark.parametrize("T", [1, 20, 64, 130])
@pytest.mark.parametrize("cached", [False, True])
def test_ssd_fwd_matches_jax(T, cached):
    """T = 1 (decode), 20 (below the 64-token SSD chunk: chunk 1), 64 (one
    chunk) and 130 (the reference's chunk rule picks 65)."""
    _mixer_case("mamba2-780m", jmx.ssd_fwd, tmx.ssd_fwd, T, cached, 4)


@pytest.mark.parametrize("T", [1, 7, 33])
@pytest.mark.parametrize("cached", [False, True])
def test_rglru_fwd_matches_jax(T, cached):
    """T = 1 takes the reference's closed form; longer chunks the scan."""
    _mixer_case("recurrentgemma-9b", jmx.rglru_fwd, tmx.rglru_fwd, T, cached,
                5)


@pytest.mark.parametrize("kind", ["ssd", "rglru"])
def test_mixer_fwd_dispatches_like_the_reference(kind):
    arch = "mamba2-780m" if kind == "ssd" else "recurrentgemma-9b"
    jcfg, jp, cfg, tp = mixer(arch, 6)
    x = np.random.default_rng(7).standard_normal((2, 5, cfg.d_model)) \
        .astype(np.float32)
    jy, _ = jmx.mixer_fwd(kind, jp, jnp.asarray(x), jcfg)
    ty, _ = tmx.mixer_fwd(kind, tp, _t(x), cfg)
    close(ty, jy)
    with pytest.raises(ValueError):
        tmx.mixer_fwd("conv", tp, _t(x), cfg)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _same_cache(got, exp, tol):
    gl, el = _leaves(got), _leaves(exp)
    assert [p for p, _ in gl] == [p for p, _ in el]
    for (path, g), (_, e) in zip(gl, el):
        if np.asarray(e).dtype == np.int32:
            assert np.array_equal(g.numpy(), np.asarray(e)), path
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(e),
                                       err_msg=str(path), **tol)


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_chunked_prefill_then_decode_matches_jax_and_full(arch):
    """The reference's ``test_chunked_prefill_then_decode_matches_full``
    (recurrentgemma runs a pattern group and a tail block), with the port
    held against JAX at every step and on the final state."""
    jcfg, jp, cfg, tp = weights(arch, 8)
    B, T = 2, 16
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, T)) \
        .astype(np.int32)
    jfull, _, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks))
    full, _, _ = tmodel.forward(tp, cfg, _t(toks))
    close(full, jfull, MODEL)
    jc = jmodel.init_cache(jcfg, B, 64)
    tc = tmodel.init_cache(cfg, B, 64, device="cpu")
    jl, jc, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks[:, :10]), cache=jc,
                               pos_offset=0)
    tl, tc, _ = tmodel.forward(tp, cfg, _t(toks[:, :10]), cache=tc,
                               pos_offset=0)
    close(tl, jl, MODEL)
    outs = [tl]
    for t in range(10, T):
        jl, jc, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks[:, t:t + 1]),
                                   cache=jc, pos_offset=t)
        tl, tc, _ = tmodel.forward(tp, cfg, _t(toks[:, t:t + 1]), cache=tc,
                                   pos_offset=t)
        close(tl, jl, MODEL)
        outs.append(tl)
    _same_cache(tc, jc, MODEL)
    close(torch.cat(outs, 1), full.numpy(), MODEL)


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_padded_mixed_batch_matches_jax(arch):
    """The reference's ``test_padded_mixed_batch_matches_exact``: a
    12-token prompt padded to 16 (pads are identity steps), then an
    8-token chunk with ``last_only``, equal to the unpadded run and to
    JAX's padded run."""
    jcfg, jp, cfg, tp = weights(arch, 10)
    B = 2
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, 20)) \
        .astype(np.int32)
    tc = tmodel.init_cache(cfg, B, 64, device="cpu")
    _, tc, _ = tmodel.forward(tp, cfg, _t(toks[:, :12]), cache=tc,
                              pos_offset=0)
    ref, _, _ = tmodel.forward(tp, cfg, _t(toks[:, 12:]), cache=tc,
                               pos_offset=12)
    padded = np.concatenate([toks[:, :12], np.zeros((B, 4), np.int32)], 1)
    got = []
    for mod, c, t, pos, kw in (
            (jmodel, jmodel.init_cache(jcfg, B, 64), jnp.asarray,
             jnp.asarray, dict(active=jnp.ones(B, bool))),
            (tmodel, tmodel.init_cache(cfg, B, 64, device="cpu"), _t, _t,
             dict(active=torch.ones(B, dtype=torch.bool)))):
        p = jp if mod is jmodel else tp
        mcfg = jcfg if mod is jmodel else cfg
        _, c, _ = mod.forward(p, mcfg, t(padded), cache=c,
                              pos_offset=pos(np.zeros(B, np.int32)),
                              n_valid=pos(np.full(B, 12, np.int32)), **kw)
        l2, _, _ = mod.forward(p, mcfg, t(toks[:, 12:]), cache=c,
                               pos_offset=pos(np.full(B, 12, np.int32)),
                               n_valid=pos(np.full(B, 8, np.int32)),
                               last_only=True, **kw)
        got.append(np.asarray(l2[:, 0]))
    np.testing.assert_allclose(got[1], got[0], **MODEL)
    close(ref[:, -1], got[0], MODEL)


def test_inactive_slots_preserve_cache():
    """The reference's ``test_inactive_slots_preserve_cache`` on
    recurrentgemma: an inactive slot's group and tail caches are left bit
    for bit; active slots change."""
    _, _, cfg, tp = weights("recurrentgemma-9b", 12)
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (3, 12)) \
        .astype(np.int32)
    cache = tmodel.init_cache(cfg, 3, 64, device="cpu")
    _, cache, _ = tmodel.forward(tp, cfg, _t(toks[:, :8]), cache=cache,
                                 pos_offset=0)
    before = jax.tree.map(torch.clone, cache)
    _, cache, _ = tmodel.forward(tp, cfg, _t(toks[:, 8:9]), cache=cache,
                                 pos_offset=torch.full((3,), 8),
                                 active=torch.tensor([True, False, True]))
    for i, blk in enumerate(before["blocks"]):
        for k in blk:
            assert torch.equal(blk[k][:, 1], cache["blocks"][i][k][:, 1])
            assert not torch.equal(blk[k][:, 0], cache["blocks"][i][k][:, 0])
    for j, tcache in enumerate(before["tail"]):
        for k in tcache:
            assert torch.equal(tcache[k][1], cache["tail"][j][k][1])
