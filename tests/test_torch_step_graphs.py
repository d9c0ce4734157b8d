"""The port's static-shape write plans and the engine's compiled step, on
the CPU.

The cache writes no longer read a count back from the device: every
token of a (B, T) chunk has a destination, and the rows that write
nothing (pads, inactive slots, positions outside a dense buffer, a ring
chunk's earlier writers of one slot) land in a scratch row that
``model.cache_leaf`` allocates after each written leaf.  These tests hold
the caches that result to the JAX package's (which drops such rows with
``mode="drop"``), on the same weights and numpy inputs made from a seed:
paged pools in f32, fp8 and int8, and the dense slot cache with a ring
buffer and a sequence-sharded shard.  Tolerances: f32 K/V ``rtol=1e-4,
atol=1e-5`` (the mixers' bound in ``test_torch_dense.py``); positions,
and which rows hold anything, exactly; quantized codes within one code
step of their row's scale (the projections differ in their last bits).
CUDA graphs are captured only on a card (``test_torch_gpu.py``); a CPU
engine runs the eager step.
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
from repro.engine import BatchItem as JItem  # noqa: E402
from repro.engine import InstanceEngine as JEngine  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.engine import BatchItem, InstanceEngine  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.tp import RecordingGroup  # noqa: E402

MIX = dict(rtol=1e-4, atol=1e-5)
PAGE = 4


def _weights(arch="chatglm3-6b", seed=0, **overrides):
    jcfg = jconfigs.get_smoke_config(arch).with_(**overrides)
    cfg = get_smoke_config(arch).with_(**overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np_params = jax.tree.map(
        np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(seed)))
    return (jcfg, jax.tree.map(jnp.asarray, np_params), cfg,
            params_from_jax(np_params, cfg, device="cpu"))


def _mixers(seed=0, **overrides):
    jcfg, jp, cfg, tp = _weights(seed=seed, **overrides)
    return (jcfg, jax.tree.map(lambda a: a[0], jp["blocks"][0]["mixer"]),
            cfg, tp["layers"][0]["mixer"])


def _x(rng, B, T, cfg):
    return rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the plans' shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masks", ["none", "active", "tokens", "both"])
@pytest.mark.parametrize("B,T", [(1, 1), (3, 5), (4, 16)])
def test_static_plans_have_length_B_T(masks, B, T):
    """Both plans give every one of the B*T tokens a destination, whatever
    the masks hide: the shape of a step never depends on its data."""
    rng = np.random.default_rng(B * 100 + T)
    pos = torch.from_numpy(rng.integers(0, 40, (B, 1)) + np.arange(T))
    active = torch.from_numpy(rng.random(B) < 0.5) \
        if masks in ("active", "both") else None
    tokens = torch.from_numpy(rng.random((B, T)) < 0.5) \
        if masks in ("tokens", "both") else None
    tables = torch.from_numpy(
        rng.permutation(B * 16).reshape(B, 16).astype(np.int32))
    phys, within = tmx.paged_write_plan(pos, tables, PAGE, B * 16, active,
                                        tokens)
    assert phys.shape == within.shape == (B * T,)
    for S_buf, ring, base in ((64, 0, 0), (8, 8, 0), (16, 0, 16)):
        dst = tmx.dense_write_plan(pos, S_buf, ring, active, tokens, base)
        assert dst.shape == (B * T,)
        kept = dst[dst < B * S_buf]
        assert len(torch.unique(kept)) == len(kept)    # one writer a slot
        assert bool((dst <= B * S_buf).all())


def test_paged_plan_sends_dropped_rows_to_page_n_pages():
    """Pads and inactive slots aim at page ``n_pages``, the reference's
    dropped page, whatever their table row says; the rest at their own
    (page, offset)."""
    pos = torch.tensor([[5, 6, 7], [0, 1, 2]])
    tables = torch.tensor([[3, 7, 0], [0, 0, 0]], dtype=torch.int32)
    phys, within = tmx.paged_write_plan(
        pos, tables, PAGE, 9, torch.tensor([True, False]),
        torch.tensor([[True, True, False], [True, True, True]]))
    assert phys.tolist() == [7, 7, 9, 9, 9, 9]
    assert within.tolist() == [1, 2, 3, 0, 1, 2]


# ---------------------------------------------------------------------------
# paged pools against the reference
# ---------------------------------------------------------------------------
def _pools(jcfg, cfg, n_pages, prec):
    jc = jax.tree.map(lambda a: a[0], jmodel.init_paged_cache(
        jcfg, n_pages, PAGE, kv_precision=prec)["blocks"][0])
    tc = {k: v[0] for k, v in tmodel.init_paged_cache(
        cfg, n_pages, PAGE, kv_precision=prec, device="cpu")["blocks"][0]
        .items()}
    return jc, tc


def _same_pool(tc, jc, prec):
    if prec is None:
        for key in ("k_pages", "v_pages"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       err_msg=key, **MIX)
        return
    for name in ("k", "v"):
        ts = tc[f"{name}_scales"].numpy()
        js = np.asarray(jc[f"{name}_scales"])
        # the same rows written, and nothing else
        assert np.array_equal(ts != 0, js != 0), name
        np.testing.assert_allclose(ts, js, rtol=1e-4, atol=0)
        tq = tc[f"{name}_pages"].float().numpy() * ts[..., None, None]
        jq = np.asarray(jc[f"{name}_pages"]).astype(np.float32) \
            * js[..., None, None]
        step = np.maximum(ts, js)[..., None, None]
        assert (np.abs(tq - jq) <= 1.01 * step).all(), name


@pytest.mark.parametrize("prec", [None, "fp8", "int8"])
def test_paged_pool_after_pads_and_inactive_slots_equals_jax(prec):
    """A padded prefill chunk with an inactive slot whose zero table row
    names page 0 (a live row's page), then a decode step: the pools equal
    the reference's, pads and the inactive row writing nothing."""
    jcfg, jp, cfg, tp = _mixers(1)
    rng = np.random.default_rng(2)
    n_pages = 12
    tables = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [0, 0, 0, 0]], np.int32)
    jc, tc = _pools(jcfg, cfg, n_pages, prec)
    steps = ((6, [0, 2, 0], [True, True, False], [6, 4, 6]),
             (1, [6, 6, 0], [True, True, False], [1, 1, 1]))
    for T, off, act, n in steps:
        x = _x(rng, 3, T, cfg)
        mask = np.arange(T)[None] < np.asarray(n)[:, None]
        kw = dict(pos_offset=np.asarray(off, np.int32),
                  active=np.asarray(act), token_mask=mask,
                  block_tables=tables, page_size=PAGE)
        _, jc = jmx.attention_fwd(
            jp, jnp.asarray(x), jcfg, cache=jc,
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})
        with torch.no_grad():
            tmx.attention_fwd(
                tp, torch.from_numpy(x), cfg, cache=tc,
                **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                   else v for k, v in kw.items()})
        _same_pool(tc, jc, prec)
    # row 1 wrote positions 2..6 only; its page 4's first two rows hold 0
    assert not tc["k_pages"][4, :2].float().any()


@pytest.mark.parametrize("prec", [None, "fp8", "int8"])
def test_public_pool_leaves_keep_the_reference_layout(prec):
    """The page pools the port allocates keep the reference's shapes and
    dtypes, are contiguous, and hold zeros: the scratch page lies outside
    every leaf, in its storage only."""
    jcfg, _, cfg, _ = _weights("qwen2.5-14b")
    jc = jmodel.init_paged_cache(jcfg, 10, PAGE, kv_precision=prec)
    tc = tmodel.init_paged_cache(cfg, 10, PAGE, kv_precision=prec,
                                 device="cpu")
    for jb, tb in zip(jc["blocks"], tc["blocks"]):
        assert set(jb) == set(tb)
        for key, t in tb.items():
            j = np.asarray(jb[key])
            assert tuple(t.shape) == j.shape, key
            assert t.element_size() == j.dtype.itemsize, key
            assert t.is_contiguous() and not t.float().any(), key
            per_page = t[0, 0].numel() * t.element_size()
            assert t.untyped_storage().nbytes() == \
                (t.numel() * t.element_size() + per_page), key


# ---------------------------------------------------------------------------
# the dense slot cache against the reference
# ---------------------------------------------------------------------------
def _dense(B, S, KV, hd):
    c = {"k": np.zeros((B, S, KV, hd), np.float32),
         "v": np.zeros((B, S, KV, hd), np.float32),
         "pos": np.full((B, S), -1, np.int32)}
    tc = {}
    for k, v in c.items():
        leaf = tmodel.cache_leaf((1, *v.shape), torch.from_numpy(v).dtype,
                                 "cpu", row_dims=tmodel.ROW_DIMS[k])[0]
        tc[k] = leaf.copy_(torch.from_numpy(v))
    return {k: jnp.asarray(v) for k, v in c.items()}, tc


def _same_dense(tc, jc):
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   err_msg=key, **MIX)


@pytest.mark.parametrize("window", [None, 8])
def test_dense_cache_after_pads_and_inactive_slots_equals_jax(window):
    """Padded chunks at per-row offsets with an inactive row, into the
    full buffer and into a ring of 8 (``window_override``; a pad at
    ``p + 8`` aliases a real token's slot there): the cache equals the
    reference's after every chunk."""
    jcfg, jp, cfg, tp = _mixers(3)
    rng = np.random.default_rng(4)
    S = window or 32
    jc, tc = _dense(3, S, cfg.n_kv_heads, cfg.hd)
    for T, off, act, n in ((6, [0, 3, 0], [True, True, False], [6, 2, 6]),
                           (4, [6, 5, 0], [True, False, True], [4, 4, 3]),
                           (1, [10, 9, 3], [True, True, True], [1, 1, 1])):
        x = _x(rng, 3, T, cfg)
        kw = dict(pos_offset=np.asarray(off, np.int32),
                  active=np.asarray(act),
                  token_mask=np.arange(T)[None] < np.asarray(n)[:, None],
                  window_override=window)
        _, jc = jmx.attention_fwd(
            jp, jnp.asarray(x), jcfg, cache=jc,
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})
        with torch.no_grad():
            tmx.attention_fwd(
                tp, torch.from_numpy(x), cfg, cache=tc,
                **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                   else v for k, v in kw.items()})
        _same_dense(tc, jc)


def test_ring_chunk_longer_than_its_window_keeps_the_last_writer():
    """A 21-token chunk into a ring of 8, one row padded: positions ``p``,
    ``p + 8`` and ``p + 16`` share a slot, and the last valid writer
    holds it, as XLA's in-order scatter leaves it."""
    jcfg, jp, cfg, tp = _mixers(5)
    x = _x(np.random.default_rng(6), 2, 21, cfg)
    mask = np.arange(21)[None] < np.array([[21], [13]])
    jc, tc = _dense(2, 8, cfg.n_kv_heads, cfg.hd)
    _, jc = jmx.attention_fwd(jp, jnp.asarray(x), jcfg, cache=jc,
                              pos_offset=jnp.asarray([0, 3]),
                              token_mask=jnp.asarray(mask),
                              window_override=8)
    with torch.no_grad():
        tmx.attention_fwd(tp, torch.from_numpy(x), cfg, cache=tc,
                          pos_offset=torch.tensor([0, 3]),
                          token_mask=torch.from_numpy(mask),
                          window_override=8)
    _same_dense(tc, jc)
    assert sorted(tc["pos"][1].tolist()) == list(range(8, 16))


def test_sequence_sharded_base_drops_positions_outside_the_shard():
    """Two shards of a sequence-sharded dense cache (16 slots each, the
    second from base 16), written by chunks that straddle the boundary,
    one row inactive and one padded: each shard keeps exactly its slice
    of the reference's whole 32-slot cache, the positions outside it
    written nowhere."""
    jcfg, jp, cfg, tp = _mixers(7)
    rng = np.random.default_rng(8)
    n, S_local = 2, 16
    jc, _ = _dense(3, n * S_local, cfg.n_kv_heads, cfg.hd)
    shards = [_dense(3, S_local, cfg.n_kv_heads, cfg.hd)[1]
              for _ in range(n)]
    for T, off, act, valid in ((4, [13, 2, 17], [True, True, False],
                                [4, 3, 4]),
                               (1, [17, 5, 20], [True, True, True],
                                [1, 1, 1])):
        x = _x(rng, 3, T, cfg)
        mask = np.arange(T)[None] < np.asarray(valid)[:, None]
        _, jc = jmx.attention_fwd(
            jp, jnp.asarray(x), jcfg, cache=jc,
            pos_offset=jnp.asarray(off), active=jnp.asarray(act),
            token_mask=jnp.asarray(mask))
        for r in range(n):
            group = RecordingGroup(n, rank=r, seq_shard=True)
            with torch.no_grad():
                group.run(lambda rank: tmx.attention_fwd(
                    tp, torch.from_numpy(x), cfg, cache=shards[r],
                    pos_offset=torch.tensor(off),
                    active=torch.tensor(act),
                    token_mask=torch.from_numpy(mask)))
    for r in range(n):
        _same_dense(shards[r], {k: v[:, r * S_local:(r + 1) * S_local]
                                for k, v in jc.items()})


def test_a_leaf_without_a_scratch_row_is_refused():
    """A plain tensor's next row may be another layer's data, so the
    write refuses it rather than aim dropped rows there."""
    _, _, cfg, tp = _mixers(9)
    plain = {"k": torch.zeros(2, 8, cfg.n_kv_heads, cfg.hd),
             "v": torch.zeros(2, 8, cfg.n_kv_heads, cfg.hd),
             "pos": torch.full((2, 8), -1, dtype=torch.int32)}
    with pytest.raises(ValueError, match="scratch row"), torch.no_grad():
        tmx.attention_fwd(tp, torch.zeros(2, 1, cfg.d_model), cfg,
                          cache=plain, pos_offset=torch.tensor([0, 1]))


# ---------------------------------------------------------------------------
# the engine: handoffs and the CPU's eager step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bf16():
    return _weights("qwen2.5-14b", dtype="bfloat16")


@pytest.mark.parametrize("prec", ["bf16", "fp8", "int8"])
def test_handoff_piece_after_padded_mixed_batch_stays_byte_equal(bf16,
                                                                 prec):
    """The reference runs a padded mixed batch (a 13-token chunk beside a
    5-token one, a third slot idle) and exports a slot; the port imports
    the pieces and exports them again byte for byte, after its own
    padded batch wrote its pool around them."""
    jcfg, jp, cfg, tp = bf16
    rng = np.random.default_rng(10)
    a, b = (rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in (13, 5))
    A = JEngine(jcfg, jp, n_slots=3, max_len=64, page_size=PAGE,
                kv_precision=prec)
    sa, sb = A.alloc("a"), A.alloc("b")
    A.run_batch([JItem(sa, a, 0), JItem(sb, b, 0)])
    exp = A.export_state(sa, upto=13, chunk=8)
    B = InstanceEngine(cfg, tp, n_slots=3, max_len=64, page_size=PAGE,
                       kv_precision=prec)
    s0, s1 = B.alloc("x"), B.alloc("a")
    B.run_batch([BatchItem(s0, b, 0)])
    B.import_state(s1, exp)
    got = B.export_state(s1, upto=13, chunk=8)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert tuple(g["span"]) == tuple(e["span"])
        for gb, eb in zip(g["pages"], e["pages"]):
            assert set(gb) == set(eb)
            for key in gb:
                t = gb[key].contiguous()
                raw = t.view(torch.uint8) if t.element_size() == 1 else \
                    t.view(torch.int16) if t.element_size() == 2 else t
                e_np = np.asarray(eb[key])
                e_raw = e_np.view(np.uint8) if e_np.itemsize == 1 else \
                    e_np.view(np.int16) if e_np.itemsize == 2 else e_np
                assert np.array_equal(raw.numpy(), e_raw), key


@pytest.mark.parametrize("graphs", [True, False])
def test_an_engine_on_the_cpu_captures_nothing(graphs):
    """Graphs are for a card: a CPU engine runs the eager step whatever
    ``graphs`` says, and its steps give the same logits either way."""
    _, _, cfg, tp = _weights("qwen2.5-14b")
    eng = InstanceEngine(cfg, tp, n_slots=2, max_len=32, page_size=PAGE,
                         graphs=graphs)
    ref = InstanceEngine(cfg, tp, n_slots=2, max_len=32, page_size=PAGE,
                         graphs=False)
    prompt = np.random.default_rng(11).integers(
        0, cfg.vocab_size, 9).astype(np.int32)
    logits = []
    for e in (eng, ref):
        s = e.alloc("r")
        logits.append([e.run_batch([BatchItem(s, prompt, 0, True)])[s],
                       e.run_batch([BatchItem(s, prompt[:1], 9, True)])[s]])
    assert eng.graphs is False and eng.captures == 0 and not eng._graphs
    for g, r in zip(*logits):
        assert np.array_equal(g, r)
