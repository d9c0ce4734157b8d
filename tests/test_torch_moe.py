"""Every paged-KV configuration of the JAX package, MoE included, on the
port, against the JAX package on the same weights.

The JAX ``init_params`` builds each smoke config (f32, 2 layers); biases
and norm scales are set to random values in the numpy tree both packages
receive (``init_params`` leaves them at 0 / 1, which would hide a bias or
norm bug), and ``repro_torch.convert.params_from_jax`` maps the tree onto
the port.  Logits agree to 1e-4 (f32, different summation order).

``moe_fwd`` must make the reference's routing decisions, not merely give
similar outputs: the top-k experts (ties to the lower index, as
``jax.lax.top_k`` orders them), each slot's rank within its expert, and
which slots fit the capacity.  The reference's own intermediates are read
out of its jaxpr, so the comparison is with what ``repro.models.layers.
moe_fwd`` computes, not with a rewrite of it."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.engine import BatchItem as JItem  # noqa: E402
from repro.engine import InstanceEngine as JEngine  # noqa: E402
from repro.engine.cluster import ServingCluster as JCluster  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.costmodel import A100  # noqa: E402
from repro_torch.engine import BatchItem, InstanceEngine  # noqa: E402
from repro_torch.engine.cluster import ServingCluster  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

TOL = 1e-4
PAGE = 8
MOE = "qwen3-moe-30b-a3b"
PAGED_ARCHS = [a for a in jconfigs.ARCH_IDS
               if jmodel.supports_paged_kv(jconfigs.get_smoke_config(a))]


def randomize(np_params, seed=0):
    """Random biases (std 0.5) and norm scales (1 +- 0.3), in place on a
    numpy tree, wherever the tree has them."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key in ("bq", "bk", "bv", "bias"):
                tree[key] = (0.5 * rng.standard_normal(val.shape)) \
                    .astype(val.dtype)
            elif key in ("scale", "q_norm", "k_norm"):
                tree[key] = (1 + 0.3 * rng.standard_normal(val.shape)) \
                    .astype(val.dtype)

    for blk in np_params["blocks"]:
        walk(blk)
    walk(np_params["final_norm"])
    return np_params


def _weights(arch, seed=0, **overrides):
    jcfg = jconfigs.get_smoke_config(arch).with_(**overrides)
    cfg = get_smoke_config(arch).with_(**overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np_params = randomize(jax.tree.map(
        np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(seed))), seed)
    return (jcfg, jax.tree.map(jnp.asarray, np_params), cfg,
            params_from_jax(np_params, cfg, device="cpu"))


def test_paged_capable_configs_are_the_nine():
    assert sorted(PAGED_ARCHS) == sorted([
        "qwen2_5_14b", "qwen2_5_32b", "qwen2_5_72b", "qwen1_5_32b",
        "chatglm3_6b", "phi4_mini_3_8b", "nemotron_4_340b", "grok_1_314b",
        "qwen3_moe_30b_a3b"])
    for arch in jconfigs.ARCH_IDS:
        assert tmodel.supports_paged_kv(get_smoke_config(arch)) == \
            (arch in PAGED_ARCHS)


@pytest.mark.parametrize("arch", [a for a in jconfigs.ARCH_IDS
                                  if a not in PAGED_ARCHS])
def test_unpaged_configs_raise_naming_the_roadmap(arch):
    """The four configs that cannot use a page pool (mamba2,
    recurrentgemma, whisper, internvl2) no longer raise: the port's
    ``init_params`` builds each, ``InstanceEngine`` settles on the dense
    slot cache for it, refuses a page pool for it, and one engine step
    (a 12-token prompt on a 2-slot engine, through the stub frontend for
    whisper and internvl2) gives the JAX engine's logits."""
    cfg = get_smoke_config(arch)
    tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jcfg, jp, cfg, tp = _weights(arch)
    with pytest.raises(ValueError, match="paged"):
        InstanceEngine(cfg, tp, kv_mode="paged")
    eng = InstanceEngine(cfg, tp, n_slots=2, max_len=64)
    jeng = JEngine(jcfg, jp, n_slots=2, max_len=64)
    assert not eng.paged and not jeng.paged
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
    kw = {}
    if cfg.arch_type == "vlm":
        kw["extra_embeds"] = (0.02 * rng.standard_normal(
            (cfg.num_patches, cfg.d_model))).astype(np.float32)
    if cfg.arch_type == "audio":
        kw["frames"] = (0.02 * rng.standard_normal(
            (cfg.encoder_len, cfg.d_model))).astype(np.float32)
    if kw:
        got = eng.run_frontend(eng.alloc("r"), tokens=prompt, **kw)
        exp = jeng.run_frontend(jeng.alloc("r"), tokens=prompt, **kw)
    else:
        got = eng.run_batch([BatchItem(eng.alloc("r"), prompt, 0, True)])[0]
        exp = jeng.run_batch([JItem(jeng.alloc("r"), prompt, 0, True)])[0]
    np.testing.assert_allclose(got, np.asarray(exp), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_paged_forward_matches_jax(arch):
    """A 12-token chunk on two rows at ragged offsets (row 1 padded past
    ``n_valid``), then a decode step, through the paged pool of both
    packages; logits and the summed aux loss agree."""
    jcfg, jp, cfg, tp = _weights(arch)
    B, n_pp = 2, 4
    tbl = (1 + np.arange(B * n_pp, dtype=np.int32)).reshape(B, n_pp)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, 13)).astype(np.int32)
    jcache = jmodel.init_paged_cache(jcfg, 1 + B * n_pp, PAGE)
    tcache = tmodel.init_paged_cache(cfg, 1 + B * n_pp, PAGE, device="cpu")
    steps = [(toks[:, :12], np.array([0, 3], np.int32),
              np.array([12, 9], np.int32)),
             (toks[:, 12:], np.array([12, 12], np.int32), None)]
    for chunk, pos, n_valid in steps:
        jl, jcache, jaux = jmodel.forward(
            jp, jcfg, jnp.asarray(chunk), cache=jcache,
            pos_offset=jnp.asarray(pos),
            n_valid=None if n_valid is None else jnp.asarray(n_valid),
            block_tables=jnp.asarray(tbl), page_size=PAGE)
        with torch.no_grad():
            tl, tcache, taux = tmodel.forward(
                tp, cfg, torch.from_numpy(chunk), cache=tcache,
                pos_offset=torch.from_numpy(pos),
                n_valid=None if n_valid is None else torch.from_numpy(n_valid),
                block_tables=torch.from_numpy(tbl), page_size=PAGE)
        assert tl.shape == (B, chunk.shape[1], cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(taux), float(jaux),
                                   rtol=1e-5, atol=1e-6)
        if cfg.moe_experts:
            assert float(taux) > 0


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_init_params_matches_reference_structure_and_scales(arch):
    """The port's own weights have the reference's tree (LayerNorm bias,
    each MLP variant, the MoE router and (E, in, out) expert stacks),
    shapes, dtype and per-leaf scale (an expert stack's 1/sqrt(E))."""
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
        assert abs(sa - sb) <= 0.1 * max(sa, 1e-3), (path, sa, sb)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_mlp_variants_match_jax(mlp):
    """Every dense MLP of the reference, gelu in its tanh form as
    ``jax.nn.gelu`` computes it by default."""
    cfg = get_smoke_config("nemotron-4-340b").with_(mlp=mlp)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    shapes = {"wi": (cfg.d_model, cfg.d_ff), "wo": (cfg.d_ff, cfg.d_model)}
    if mlp in ("swiglu", "geglu"):
        shapes["wg"] = (cfg.d_model, cfg.d_ff)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    exp, _ = jlayers.mlp_fwd({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), cfg)
    got, aux = tlayers.mlp_fwd({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                               rtol=1e-5, atol=1e-5)
    assert aux == 0.0


# ---------------------------------------------------------------------------
# moe_fwd: routing decisions and outputs
# ---------------------------------------------------------------------------
def jax_moe(p, x, cfg, cf):
    """The reference's output, aux loss and routing intermediates
    (``gate_idx`` from its ``top_k``, ``pos_in_e`` from the reshape of its
    rank scatter, ``keep`` from the comparison that follows), evaluated
    from the jaxpr of ``repro.models.layers.moe_fwd`` itself."""
    closed = jax.make_jaxpr(
        lambda p, x: jlayers.moe_fwd(p, x, cfg, capacity_factor=cf))(p, x)
    eqns = closed.jaxpr.eqns
    names = [e.primitive.name for e in eqns]
    top_k = eqns[names.index("top_k")]
    i = names.index("scatter")
    assert names[i + 1: i + 3] == ["reshape", "lt"]
    wanted = [top_k.outvars[1], eqns[i + 1].outvars[0], eqns[i + 2].outvars[0]]
    sub = closed.jaxpr.replace(outvars=list(closed.jaxpr.outvars) + wanted)
    y, aux, gate_idx, pos_in_e, keep = jax.core.eval_jaxpr(
        sub, closed.consts, *jax.tree.leaves((p, x)))
    return [np.asarray(a) for a in (y, aux, gate_idx, pos_in_e, keep)]


def _moe_inputs(cfg, seed, S=24, tie=False):
    rng = np.random.default_rng(seed)
    E, dm, ff = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": (0.3 * rng.standard_normal((dm, E))).astype(np.float32),
         "wi": (rng.standard_normal((E, dm, ff)) / np.sqrt(dm)).astype(np.float32),
         "wg": (rng.standard_normal((E, dm, ff)) / np.sqrt(dm)).astype(np.float32),
         "wo": (rng.standard_normal((E, ff, dm)) / np.sqrt(ff)).astype(np.float32)}
    if tie:
        # experts 1 and 2 (and 4 and 5) share a router column: every
        # token scores them exactly equal, so each tie is ordered by index
        p["router"][:, 2] = p["router"][:, 1]
        p["router"][:, 5] = p["router"][:, 4]
    x = rng.standard_normal((2, S // 2, dm)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("case", ["random", "forced_tie", "drops",
                                  "drops_with_ties"])
def test_moe_fwd_routes_like_jax(case):
    cfg = get_smoke_config(MOE).with_(moe_experts=8, moe_top_k=3)
    tie = "tie" in case
    cf = 0.5 if "drops" in case else cfg.moe_capacity_factor
    p, x = _moe_inputs(cfg, seed=len(case), tie=tie)
    y, aux, gate_idx, pos_in_e, keep = jax_moe(p, x, cfg, cf)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    routing = tlayers.moe_route(tp, tx.reshape(-1, cfg.d_model), cfg, cf)
    ty, taux = tlayers.moe_fwd(tp, tx, cfg, capacity_factor=cf)
    np.testing.assert_array_equal(routing["gate_idx"].numpy(), gate_idx)
    np.testing.assert_array_equal(routing["pos_in_e"].numpy(), pos_in_e)
    np.testing.assert_array_equal(routing["keep"].numpy(), keep)
    np.testing.assert_allclose(ty.numpy(), y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5, atol=1e-5)
    if tie:
        # tied experts were both chosen somewhere, lower index first
        both = (gate_idx == 1).any(-1) & (gate_idx == 2).any(-1)
        assert both.any()
        rows = np.nonzero(both)[0]
        k1 = np.argmax(gate_idx[rows] == 1, -1)
        k2 = np.argmax(gate_idx[rows] == 2, -1)
        assert (k1 < k2).all()
    if "drops" in case:
        assert not keep.all()
    else:
        assert keep.all()


def test_moe_refuses_an_expert_slice():
    cfg = get_smoke_config(MOE)
    p, x = _moe_inputs(cfg, seed=0)
    half = {k: torch.from_numpy(v[: cfg.moe_experts // 2] if k != "router"
                                else v) for k, v in p.items()}
    with pytest.raises(ValueError, match="expert slice .* sharded step"):
        tlayers.moe_fwd(half, torch.from_numpy(x), cfg)


# ---------------------------------------------------------------------------
# the engine and the serving session on the MoE smoke config
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def moe_f32():
    return _weights(MOE)


@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_padded_mixed_batch_engine_logits_match_jax(moe_f32, cf):
    """A mixed step (a 13-token chunk beside two decode rows, padded to
    the engine's bucket and slot count) gives the JAX engine's logits.
    The pad tokens and inactive slots are routed and compete for
    capacity as in the reference; at capacity factor 1.0 slots drop."""
    jcfg, jp, cfg, tp = moe_f32
    jcfg, cfg = jcfg.with_(moe_capacity_factor=cf), \
        cfg.with_(moe_capacity_factor=cf)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 6, 13)]
    outs = []
    for eng, item in ((JEngine(jcfg, jp, n_slots=4, max_len=64), JItem),
                      (InstanceEngine(cfg, tp, n_slots=4, max_len=64),
                       BatchItem)):
        slots = [eng.alloc(f"r{i}") for i in range(3)]
        first = eng.run_batch([item(slots[0], prompts[0], 0, True),
                               item(slots[1], prompts[1], 0, True)])
        nxt = {s: np.array([int(first[s].argmax())], np.int32)
               for s in slots[:2]}
        mixed = eng.run_batch([item(slots[0], nxt[slots[0]], 9, True),
                               item(slots[1], nxt[slots[1]], 6, True),
                               item(slots[2], prompts[2], 0, True)])
        outs.append([np.asarray(first[s]) for s in slots[:2]]
                    + [np.asarray(mixed[s]) for s in slots])
    for got, exp in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got, exp, rtol=TOL, atol=TOL)


def test_dynaserve_session_matches_jax_engine(moe_f32):
    """Greedy tokens and KV bytes of a two-instance DynaServe session on
    the MoE smoke config equal the JAX EngineBackend's."""
    jcfg, jp, cfg, tp = moe_f32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 23, 31)]

    def run(cluster):
        outs = [cluster.submit(p, 8) for p in prompts]
        cluster.run_until_done(outs)
        return [list(h.generated) for h in outs], cluster.kv_bytes_moved

    jax_toks, jax_moved = run(JCluster(jcfg, jp, n_instances=2, split=True,
                                       max_len=128))
    toks, moved = run(ServingCluster(cfg, tp, n_instances=2, split=True,
                                     max_len=128, hw=A100))
    assert all(len(t) == 8 for t in toks)
    assert toks == jax_toks
    assert moved == jax_moved and moved > 0
