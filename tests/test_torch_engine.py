"""The port's engine and serving session against the JAX package's.

Handoff pieces keep the reference's wire format: the same dict shape,
spans and page layout, and the same bytes (bf16 compared as 16-bit
integers, fp8 as bytes).  A two-instance DynaServe session on the port
produces the same greedy tokens as the JAX ``EngineBackend`` and as
colocation, on the same converted weights (f32 smoke config)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores
import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.engine import BatchItem as JItem  # noqa: E402
from repro.engine import InstanceEngine as JEngine  # noqa: E402
from repro.engine.cluster import ServingCluster as JCluster  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.costmodel import A100  # noqa: E402
from repro_torch.engine import BatchItem, InstanceEngine  # noqa: E402
from repro_torch.engine.cluster import ServingCluster  # noqa: E402


def _params(dtype):
    jcfg = jax_smoke_config("qwen2.5-14b").with_(dtype=dtype)
    cfg = get_smoke_config("qwen2.5-14b").with_(dtype=dtype)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          device="cpu")


@pytest.fixture(scope="module")
def f32():
    return _params("float32")


@pytest.fixture(scope="module")
def bf16():
    return _params("bfloat16")


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _gen(eng, slot, prompt, n, pos0=0, item=BatchItem):
    out = eng.run_batch([item(slot, prompt, pos0, want_logits=True)])
    toks = [int(out[slot].argmax())]
    pos = pos0 + len(prompt)
    for _ in range(n - 1):
        out = eng.run_batch([item(slot, np.array([toks[-1]], np.int32), pos,
                                  want_logits=True)])
        toks.append(int(out[slot].argmax()))
        pos += 1
    return toks


def _bits(a):
    """The raw bits of an exported array (tensor or numpy), as numpy."""
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        if a.dtype.itemsize == 2 and a.dtype != torch.int16:
            return a.view(torch.int16).numpy()
        if a.dtype == torch.float8_e4m3fn:
            return a.view(torch.uint8).numpy()
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "float16"):
        return a.view(np.int16)
    if a.dtype.name.startswith("float8"):
        return a.view(np.uint8)
    return a


def _assert_same_pieces(got, exp):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert set(g) == set(e)
        assert tuple(g["span"]) == tuple(e["span"])
        assert g["page_size"] == e["page_size"]
        assert g["precision"] == e["precision"]
        assert len(g["pages"]) == len(e["pages"])
        for gb, eb in zip(g["pages"], e["pages"]):
            assert set(gb) == set(eb)
            for key in gb:
                gbits, ebits = _bits(gb[key]), _bits(eb[key])
                assert gbits.shape == ebits.shape, key
                assert gbits.dtype == ebits.dtype, key
                assert np.array_equal(gbits, ebits), key


@pytest.mark.parametrize("prec", ["bf16", "fp8"])
def test_exported_pieces_byte_equal_to_jax(bf16, prec):
    """JAX's pieces imported into the port and exported again come out
    byte for byte the same, in the same dict shape: the page pools keep
    the reference layout (G, n_pages, page, KV, hd) and the fp8 codes
    and scale planes cross unchanged."""
    jcfg, jp, cfg, tp = bf16
    prompt = _prompt(4, 20, cfg.vocab_size)
    A = JEngine(jcfg, jp, n_slots=2, max_len=64, kv_precision=prec)
    sa = A.alloc("r")
    A.run_batch([JItem(sa, prompt, 0)])
    exp = A.export_state(sa, upto=20, chunk=8)
    B = InstanceEngine(cfg, tp, n_slots=2, max_len=64, kv_precision=prec)
    sb = B.alloc("r")
    B.alloc("other")                       # so the port's pages differ
    B.import_state(sb, exp)
    got = B.export_state(sb, upto=20, chunk=8)
    _assert_same_pieces(got, exp)
    assert B.state_bytes(20) == A.state_bytes(20)
    assert B.state_bytes(20, as_precision="bf16") == \
        A.state_bytes(20, as_precision="bf16")


def test_port_prefill_exports_what_jax_exports(f32):
    """The port's own prefill writes the same K/V as JAX's (f32, up to
    summation order) into pieces of the same shape."""
    jcfg, jp, cfg, tp = f32
    prompt = _prompt(5, 20, cfg.vocab_size)
    A = JEngine(jcfg, jp, n_slots=2, max_len=64)
    sa = A.alloc("r")
    A.run_batch([JItem(sa, prompt, 0)])
    exp = A.export_state(sa, upto=20, chunk=8)
    B = InstanceEngine(cfg, tp, n_slots=2, max_len=64)
    sb = B.alloc("r")
    B.run_batch([BatchItem(sb, prompt, 0)])
    got = B.export_state(sb, upto=20, chunk=8)
    assert [tuple(p["span"]) for p in got] == [tuple(p["span"]) for p in exp]
    for g, e in zip(got, exp):
        for gb, eb in zip(g["pages"], e["pages"]):
            for key in ("k", "v"):
                np.testing.assert_allclose(gb[key].numpy(),
                                           np.asarray(eb[key]),
                                           rtol=1e-4, atol=1e-4)


def test_port_pieces_resume_in_the_jax_engine(f32):
    """Alpha on the port, beta on JAX: the JAX engine continues the
    stream exactly as one JAX engine running the whole request."""
    jcfg, jp, cfg, tp = f32
    prompt = _prompt(6, 24, cfg.vocab_size)
    one = JEngine(jcfg, jp, n_slots=2, max_len=96)
    ref = _gen(one, one.alloc("r"), prompt, 5, item=JItem)
    A = InstanceEngine(cfg, tp, n_slots=2, max_len=96)
    sa = A.alloc("r")
    A.run_batch([BatchItem(sa, prompt[:16], 0)])
    pieces = [dict(p, pages=[{k: v.numpy() for k, v in blk.items()}
                             for blk in p["pages"]])
              for p in A.export_state(sa, upto=16, chunk=8)]
    B = JEngine(jcfg, jp, n_slots=2, max_len=96)
    sb = B.alloc("r")
    B.import_state(sb, pieces)
    assert _gen(B, sb, prompt[16:], 5, pos0=16, item=JItem) == ref


@pytest.mark.parametrize("prec", ["bf16", "fp8"])
def test_handoff_between_port_engines_is_exact(f32, prec):
    """Alpha exports whole pages in chunks, beta imports them and
    continues the token stream bit-identically (fp8: codes and scale
    planes shipped verbatim)."""
    _, _, cfg, tp = f32
    prompt = _prompt(1, 24, cfg.vocab_size)
    one = InstanceEngine(cfg, tp, n_slots=4, max_len=96, kv_precision=prec)
    ref = _gen(one, one.alloc("r"), prompt, 6)
    A = InstanceEngine(cfg, tp, n_slots=4, max_len=96, kv_precision=prec)
    B = InstanceEngine(cfg, tp, n_slots=4, max_len=96, kv_precision=prec)
    sa = A.alloc("r")
    A.run_batch([BatchItem(sa, prompt[:16], 0)])
    pieces = A.export_state(sa, upto=16, chunk=8)
    assert len(pieces) == 2 and all(p["precision"] == prec for p in pieces)
    assert all(p["span"][0] % A.page_size == 0 for p in pieces)
    sb = B.alloc("r")
    B.import_state(sb, pieces)
    assert _gen(B, sb, prompt[16:], 6, pos0=16) == ref


@pytest.mark.parametrize("src,dst", [("bf16", "fp8"), ("fp8", "bf16"),
                                     ("int8", "fp8")])
def test_cross_precision_import_converts(f32, src, dst):
    _, _, cfg, tp = f32
    prompt = _prompt(2, 24, cfg.vocab_size)
    A = InstanceEngine(cfg, tp, n_slots=2, max_len=96, kv_precision=src)
    B = InstanceEngine(cfg, tp, n_slots=2, max_len=96, kv_precision=dst)
    sa = A.alloc("r")
    A.run_batch([BatchItem(sa, prompt[:16], 0)])
    sb = B.alloc("r")
    B.import_state(sb, A.export_state(sa, upto=16, chunk=8))
    toks = _gen(B, sb, prompt[16:], 4, pos0=16)
    assert len(toks) == 4 and all(0 <= t < cfg.vocab_size for t in toks)


def test_mixed_batch_prefill_plus_decode(f32):
    """One unified iteration carrying a prefill chunk and another
    request's decode step matches each request run alone."""
    _, _, cfg, tp = f32
    pa, pb = _prompt(7, 20, cfg.vocab_size), _prompt(8, 12, cfg.vocab_size)
    e1 = InstanceEngine(cfg, tp, n_slots=4, max_len=96)
    ra = _gen(e1, e1.alloc("a"), pa, 2)
    e2 = InstanceEngine(cfg, tp, n_slots=4, max_len=96)
    rb = _gen(e2, e2.alloc("b"), pb, 3)
    e = InstanceEngine(cfg, tp, n_slots=4, max_len=96)
    sa, sb = e.alloc("a"), e.alloc("b")
    out = e.run_batch([BatchItem(sb, pb, 0, want_logits=True)])
    tb = [int(out[sb].argmax())]
    out = e.run_batch([BatchItem(sa, pa[:10], 0),
                       BatchItem(sb, np.array([tb[-1]], np.int32), len(pb),
                                 want_logits=True)])
    tb.append(int(out[sb].argmax()))
    out = e.run_batch([BatchItem(sa, pa[10:], 10, want_logits=True),
                       BatchItem(sb, np.array([tb[-1]], np.int32),
                                 len(pb) + 1, want_logits=True)])
    ta = [int(out[sa].argmax())]
    tb.append(int(out[sb].argmax()))
    out = e.run_batch([BatchItem(sa, np.array([ta[-1]], np.int32), len(pa),
                                 want_logits=True)])
    ta.append(int(out[sa].argmax()))
    assert ta == ra and tb == rb
    handle = e.dispatch_batch([BatchItem(sa, np.array([ta[-1]], np.int32),
                                         len(pa) + 1, want_logits=True)])
    assert handle.ready()                  # a CPU step is always ready
    assert set(e.collect_batch(handle)) == {sa}


def test_dynaserve_session_matches_jax_engine_and_colocation(f32):
    """Greedy tokens of a two-instance DynaServe session on the port
    equal the JAX EngineBackend's and colocation's; both packages split
    the same requests and move the same KV bytes (same cost model)."""
    jcfg, jp, cfg, tp = f32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 23, 31)]

    def run(cluster):
        outs = [cluster.submit(p, 10) for p in prompts]
        cluster.run_until_done(outs)
        return [list(h.generated) for h in outs], cluster.kv_bytes_moved

    jax_toks, jax_moved = run(JCluster(jcfg, jp, n_instances=2, split=True,
                                       max_len=128))
    dyn_toks, moved = run(ServingCluster(cfg, tp, n_instances=2, split=True,
                                         max_len=128, hw=A100))
    col_toks, _ = run(ServingCluster(cfg, tp, n_instances=1, split=False,
                                     max_len=128))
    assert all(len(t) == 10 for t in dyn_toks)
    assert dyn_toks == jax_toks == col_toks
    assert moved == jax_moved and moved > 0


def test_pipelined_session_streams_kv_and_matches_sync(f32):
    """Dispatch-ahead execution with background KV streams (``_KVStream``:
    dispatch / poll / collect, chunked export and import) gives the same
    tokens as the synchronous session."""
    _, _, cfg, tp = f32
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (44, 29, 35, 18)]
    runs = []
    for overlap in (False, True):
        cluster = ServingCluster(cfg, tp, n_instances=2, split=True,
                                 max_len=128, overlap=overlap)
        outs = [cluster.submit(p, 8) for p in prompts]
        cluster.run_until_done(outs)
        runs.append(([list(h.generated) for h in outs],
                     cluster.kv_bytes_moved))
    (sync_toks, sync_moved), (pipe_toks, pipe_moved) = runs
    assert all(len(t) == 8 for t in pipe_toks)
    assert pipe_toks == sync_toks
    assert pipe_moved > 0 and sync_moved > 0


def test_prefix_cache_splices_shared_pages_without_changing_tokens(f32):
    """Requests that share a long prompt prefix claim the cached pages
    (``register`` / ``lookup_prefix`` / ``remember`` on the torch engine)
    and still produce the tokens of an uncached session."""
    _, _, cfg, tp = f32
    rng = np.random.default_rng(9)
    shared = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, n).astype(np.int32)]) for n in (5, 9, 12)]
    runs = []
    for cached in (False, True):
        cluster = ServingCluster(cfg, tp, n_instances=2, split=True,
                                 max_len=128, prefix_cache=cached)
        toks = []
        for p in prompts:                  # one after another: later ones hit
            h = cluster.submit(p, 6)
            cluster.run_until_done([h])
            toks.append(list(h.generated))
        runs.append((toks, cluster.session.metrics()))
    (plain, _), (cached, m) = runs
    assert cached == plain
    assert m.prefix_hits >= 2 and m.prefix_saved_tokens >= 2 * 24


def test_admission_sheds_what_the_jax_engine_sheds(f32):
    """Page-pool admission is commitment-based session state: on the same
    8-page pool and the same arrivals, the torch backend rejects the same
    requests as the JAX backend, and the survivors finish every token."""
    from repro.core.request import INTERACTIVE as J_INTERACTIVE
    from repro.core.session import ServeSession as JSession
    from repro.core.session import SessionConfig as JConfig
    from repro.engine.backend import EngineBackend as JBackend
    from repro.sim.policies import ColocationPolicy as JColocation
    from repro_torch.core.request import INTERACTIVE, RequestState
    from repro_torch.core.session import ServeSession, SessionConfig
    from repro_torch.engine.backend import EngineBackend
    from repro_torch.sim.policies import ColocationPolicy
    jcfg, jp, cfg, tp = f32
    sessions = {
        "jax": (JSession(JBackend(jcfg, jp, n_slots=4, max_len=128,
                                  page_size=16, n_pages=8),
                         JColocation(chunk=64, slo_aware=False),
                         JConfig(n_instances=1, admission=True)),
                J_INTERACTIVE),
        "port": (ServeSession(EngineBackend(cfg, tp, n_slots=4, max_len=128,
                                            page_size=16, n_pages=8),
                              ColocationPolicy(chunk=64, slo_aware=False),
                              SessionConfig(n_instances=1, admission=True)),
                 INTERACTIVE),
    }
    outcomes, tokens = {}, {}
    for name, (sess, slo) in sessions.items():
        rng = np.random.default_rng(0)
        hs = [sess.generate(rng.integers(0, cfg.vocab_size, 40), 8, slo=slo,
                            rid=f"r{i}") for i in range(4)]
        outcomes[name] = [h.state == RequestState.REJECTED for h in hs]
        tokens[name] = [list(h) for h in hs[:2]]
    assert outcomes["port"] == outcomes["jax"] == [False, False, True, True]
    assert tokens["port"] == tokens["jax"]
    assert all(len(t) == 8 for t in tokens["port"])
    port_sess = sessions["port"][0]
    assert all(port_sess.handles[r].state == RequestState.DONE
               for r in ("r0", "r1"))


def test_preemption_recompute_keeps_tokens_exact(f32):
    """A pool too small for both requests at full length: the session
    preempts one (its pages are freed and rebuilt by recompute from
    prompt plus generated tokens) and both streams come out as in a
    roomy pool."""
    from repro_torch.core.session import ServeSession, SessionConfig
    from repro_torch.engine.backend import EngineBackend
    from repro_torch.sim.policies import ColocationPolicy
    _, _, cfg, tp = f32
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 24).astype(np.int32)
               for _ in range(2)]
    outs, preempted = [], []
    for n_pages in (None, 7):             # roomy, then 7 pages of 8 tokens
        sess = ServeSession(
            EngineBackend(cfg, tp, n_slots=4, max_len=128, page_size=8,
                          n_pages=n_pages),
            ColocationPolicy(chunk=64, slo_aware=False),
            SessionConfig(n_instances=1))
        hs = [sess.generate(p, 20, rid=f"b{i}") for i, p in enumerate(prompts)]
        outs.append([list(h) for h in hs])
        preempted.append(sess.preemptions)
    assert preempted[0] == 0 and preempted[1] >= 1
    assert outs[1] == outs[0]


def test_attach_and_drain_instances_mid_flight(f32):
    """The pool is elastic on torch engines too: an instance attached
    mid-flight takes work, a drained one finishes its queue (pending
    handoffs included) and is detached, and the last one never is."""
    _, _, cfg, tp = f32
    cluster = ServingCluster(cfg, tp, n_instances=2, max_len=96)
    rng = np.random.default_rng(0)
    reqs = [cluster.submit(rng.integers(0, cfg.vocab_size, n), 4)
            for n in (24, 16)]
    new_eid = cluster.attach_instance()
    assert new_eid in cluster.engines
    assert cluster.engines[new_eid].params is tp      # shared weights
    reqs.append(cluster.submit(rng.integers(0, cfg.vocab_size, 12), 4))
    cluster.drain_instance(0)
    cluster.run_until_done(reqs)
    assert all(len(r.generated) >= 4 for r in reqs)
    assert 0 not in cluster.engines and cluster.draining == set()
    last = ServingCluster(cfg, tp, n_instances=1, max_len=96)
    last.drain_instance(0)
    r = last.submit(np.arange(16) % cfg.vocab_size, 4)
    last.run_until_done([r])
    assert len(r.generated) >= 4
    assert 0 in last.engines and last.draining == set()


def test_unported_modes_raise_naming_the_roadmap(f32):
    """No mode raises NotImplementedError any more.  Sharded
    (multi-device) instances, refused before, now run: two shards on the
    CPU greedy-decode the JAX engine's tokens (``tests/test_torch_sharded.py``
    holds them in full), and devices of two kinds in one instance raise
    ``ValueError``.  The dense slot cache and the stub frontend, refused
    before, now run: ``kv_mode="dense"`` and ``window_override`` (a ring
    of 8 slots) on the paper's model greedy-decode the JAX dense engine's
    tokens, and the reference's ``ValueError``s stand (``run_frontend`` on
    a paged engine, a quantized pool or a prefix cache on a dense one)."""
    jcfg, jp, cfg, tp = f32
    prompt = _prompt(9, 20, cfg.vocab_size)
    eng = InstanceEngine(cfg, tp, n_slots=2, max_len=64,
                         devices=["cpu", "cpu"])
    ref = JEngine(jcfg, jp, n_slots=2, max_len=64)
    assert eng.tp == 2 and eng.paged
    assert _gen(eng, eng.alloc("r"), prompt, 5) == \
        _gen(ref, ref.alloc("r"), prompt, 5, item=JItem)
    with pytest.raises(ValueError, match="mix kinds"):
        InstanceEngine(cfg, tp, devices=["cpu", "cuda:0"])
    for kw in ({"kv_mode": "dense"}, {"window_override": 8}):
        eng = InstanceEngine(cfg, tp, n_slots=2, max_len=64, **kw)
        ref = JEngine(jcfg, jp, n_slots=2, max_len=64, **kw)
        assert not eng.paged and not ref.paged
        assert eng.free_pages is None and eng.mem_pressure == 0.0
        assert _gen(eng, eng.alloc("r"), prompt, 5) == \
            _gen(ref, ref.alloc("r"), prompt, 5, item=JItem)
    with pytest.raises(ValueError, match="dense cache"):
        InstanceEngine(cfg, tp, n_slots=1, max_len=16).run_frontend(0)
    with pytest.raises(ValueError, match="paged KV mode"):
        InstanceEngine(cfg, tp, kv_mode="dense", kv_precision="fp8")
    with pytest.raises(ValueError, match="paged KV mode"):
        InstanceEngine(cfg, tp, kv_mode="dense", prefix_cache=True)
    with pytest.raises(ValueError, match="window_override"):
        InstanceEngine(cfg, tp, kv_mode="paged", window_override=8)


def test_elastic_policy_resizes_the_torch_pool_on_its_own(f32):
    """``ElasticDynaServePolicy`` grows the torch backend's pool under a
    burst (attach) and shrinks it again on a quiet tail (drain, retire),
    with no caller attaching or draining anything; every token equals a
    fixed colocated pool's."""
    from repro_torch.core.elastic import ElasticConfig
    from repro_torch.core.session import ServeSession, SessionConfig
    from repro_torch.engine.backend import EngineBackend
    from repro_torch.sim.policies import ElasticDynaServePolicy
    _, _, cfg, tp = f32
    rng = np.random.default_rng(11)
    burst = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in (40, 23, 31, 36, 27, 33)]
    tail = burst[0][:12]
    backend = EngineBackend(cfg, tp, n_slots=8, max_len=128, hw=A100)
    # any backlog beyond one queued micro a member grows the pool; a
    # predicted drain under 50 ms shrinks it (the smoke model's drains
    # are milliseconds once the burst is served)
    policy = ElasticDynaServePolicy(backend.cost, elastic=ElasticConfig(
        min_instances=1, max_instances=2, check_interval=0.01,
        scale_up_drain=0.0, scale_down_drain=0.05, scale_up_cooldown=0.0,
        scale_down_cooldown=0.0, queue_low_watermark=1))
    sess = ServeSession(backend, policy, SessionConfig(n_instances=1))
    toks = [list(h) for h in [sess.generate(p, 6) for p in burst]]
    grown = [e for _, e in sess.pool_events]
    assert any(e.startswith("attach") for e in grown), grown
    toks.append(list(sess.generate(tail, 30)))
    events = [e for _, e in sess.pool_events]
    assert any(e.startswith("retire") for e in events[len(grown):]), events
    col = ServingCluster(cfg, tp, n_instances=1, split=False, max_len=128)
    outs = [col.submit(p, 6) for p in burst] + [col.submit(tail, 30)]
    col.run_until_done(outs)
    assert toks == [list(h.generated) for h in outs]


# ---------------------------------------------------------------------------
# the dense slot cache: recurrent models, ring buffers and stub frontends
# ---------------------------------------------------------------------------
DENSE_FAMS = ["mamba2-780m", "recurrentgemma-9b"]
FRONTENDS = ["internvl2-76b", "whisper-large-v3"]
_DENSE = {}


def _dense(arch):
    """(jax cfg, jax params, port cfg, port params) of a smoke config in
    f32, built once per module."""
    if arch not in _DENSE:
        jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        _DENSE[arch] = (jcfg, jp, cfg, params_from_jax(
            jax.tree.map(np.asarray, jp), cfg, device="cpu"))
    return _DENSE[arch]


def _continue(eng, slot, chunks, n, item=BatchItem):
    """Feed ``chunks`` of (tokens, pos) then decode greedily: ``n``
    tokens."""
    for toks, pos in chunks[:-1]:
        eng.run_batch([item(slot, toks, pos)])
    toks, pos = chunks[-1]
    return _gen(eng, slot, toks, n, pos0=pos, item=item)


@pytest.mark.parametrize("arch", DENSE_FAMS)
def test_dense_cross_instance_handoff_is_exact(arch):
    """The reference's ``test_cross_instance_handoff_is_exact`` on the
    port: alpha prefills 16 tokens, ships its state in two 8-token pieces
    (recurrent state with the last), and beta continues with the JAX
    engine's unsplit tokens."""
    jcfg, jp, cfg, tp = _dense(arch)
    prompt = _prompt(0, 24, cfg.vocab_size)
    one = JEngine(jcfg, jp, n_slots=4, max_len=96)
    ref = _gen(one, one.alloc("r"), prompt, 6, item=JItem)
    A = InstanceEngine(cfg, tp, n_slots=4, max_len=96)
    B = InstanceEngine(cfg, tp, n_slots=4, max_len=96)
    sa = A.alloc("r")
    A.run_batch([BatchItem(sa, prompt[:16], 0)])
    pieces = A.export_state(sa, upto=16, chunk=8)
    assert len(pieces) == 2 and "recurrent" in pieces[-1]
    sb = B.alloc("r")
    B.import_state(sb, pieces)
    assert _gen(B, sb, prompt[16:], 6, pos0=16) == ref


@pytest.mark.parametrize("arch", DENSE_FAMS)
def test_dense_serving_cluster_split_equals_unsplit(arch):
    """The reference's ``test_serving_cluster_split_equals_unsplit``: a
    two-instance split cluster on the port gives the unsplit cluster's
    tokens and the JAX split cluster's, moving the same state bytes."""
    jcfg, jp, cfg, tp = _dense(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 23, 31)]

    def run(cluster):
        outs = [cluster.submit(p, 10) for p in prompts]
        cluster.run_until_done(outs)
        return [list(h.generated) for h in outs], cluster.kv_bytes_moved

    ref, _ = run(ServingCluster(cfg, tp, n_instances=1, split=False,
                                max_len=128))
    got, moved = run(ServingCluster(cfg, tp, n_instances=2, split=True,
                                    max_len=128, hw=A100))
    exp, jmoved = run(JCluster(jcfg, jp, n_instances=2, split=True,
                               max_len=128))
    assert got == ref == exp and all(len(t) == 10 for t in got)
    assert moved == jmoved > 0


@pytest.mark.parametrize("arch", DENSE_FAMS)
def test_dense_engine_backend_session_matches_jax(arch):
    """``ServeSession(EngineBackend(kv_mode="auto"), DynaServePolicy)``:
    the backend settles on the dense cache, and the port's session emits
    the JAX backend's tokens and moves its bytes (pipelined, so state
    pieces stream through ``export_state_iter``)."""
    from repro.core.session import ServeSession as JSession
    from repro.core.session import SessionConfig as JSessionConfig
    from repro.engine.backend import EngineBackend as JBackend
    from repro.sim.policies import DynaServePolicy as JPolicy
    from repro_torch.core.session import ServeSession, SessionConfig
    from repro_torch.engine.backend import EngineBackend
    from repro_torch.sim.policies import DynaServePolicy
    jcfg, jp, cfg, tp = _dense(arch)
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), d)
            for n, d in ((44, 6), (29, 8), (35, 6), (18, 8))]
    runs = []
    for backend, policy, session, config in (
            (EngineBackend(cfg, tp, n_slots=4, max_len=128, hw=A100),
             DynaServePolicy, ServeSession, SessionConfig),
            (JBackend(jcfg, jp, n_slots=4, max_len=128, hw=A100),
             JPolicy, JSession, JSessionConfig)):
        assert not backend.paged
        sess = session(backend, policy(backend.cost, 0.1),
                       config(n_instances=2, slo=0.1, overlap=True))
        handles = [sess.generate(p, d, rid=f"r{i}")
                   for i, (p, d) in enumerate(reqs)]
        runs.append(([list(h) for h in handles], backend.kv_bytes_moved))
    (got, moved), (exp, jmoved) = runs
    assert got == exp and [len(t) for t in got] == [d for _, d in reqs]
    assert moved == jmoved > 0


def _structure(a):
    """A piece list as nested keys, spans, shapes, dtypes and None."""
    if isinstance(a, dict):
        return {k: (tuple(v) if k == "span" else _structure(v))
                for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return [_structure(v) for v in a]
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), str(a.dtype).replace("torch.", "")
    return tuple(a.shape), str(np.asarray(a).dtype)


def _values(a):
    if isinstance(a, dict):
        return {k: _values(v) for k, v in a.items() if k != "span"}
    if isinstance(a, (list, tuple)):
        return [_values(v) for v in a]
    return None if a is None else np.asarray(
        a.numpy() if isinstance(a, torch.Tensor) else a)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("arch", DENSE_FAMS)
def test_dense_pieces_cross_packages(arch, direction):
    """Alpha prefills a 40-token chunk (past recurrentgemma's 32-token
    window, so the ring ships whole in the final piece and the chunk
    overwrites its own first 8 keys: the reference's trait) and exports
    in 8-token pieces; the pieces have the JAX engine's structure (keys,
    spans, shapes, dtypes, ``None`` entries) and values (state to 1e-4,
    positions exactly); beta, in the other package, continues with the
    tokens of one engine that ran the same chunks unsplit."""
    jcfg, jp, cfg, tp = _dense(arch)
    prompt = _prompt(3, 48, cfg.vocab_size)
    chunks = [(prompt[:40], 0), (prompt[40:], 40)]
    one = JEngine(jcfg, jp, n_slots=2, max_len=96)
    ref = _continue(one, one.alloc("r"), chunks, 5, item=JItem)
    JA, TA = (JEngine(jcfg, jp, n_slots=2, max_len=96),
              InstanceEngine(cfg, tp, n_slots=2, max_len=96))
    ja, ta = JA.alloc("r"), TA.alloc("r")
    JA.run_batch([JItem(ja, prompt[:40], 0)])
    TA.run_batch([BatchItem(ta, prompt[:40], 0)])
    exp = JA.export_state(ja, upto=40, chunk=8)
    got = TA.export_state(ta, upto=40, chunk=8)
    assert _structure(got) == _structure(exp)
    if arch == "recurrentgemma-9b":
        assert exp[-1]["rings"][2] is not None and \
            all(p["blocks"][2] is None for p in exp)
    for g, e in zip(jax.tree.leaves(_values(got)),
                    jax.tree.leaves(_values(exp))):
        if e.dtype == np.int32:
            assert np.array_equal(g, e)
        else:
            np.testing.assert_allclose(g, e, rtol=1e-4, atol=1e-4)
    if direction == "jax_to_port":
        B = InstanceEngine(cfg, tp, n_slots=2, max_len=96)
        sb = B.alloc("x")
        sb = B.alloc("r")                  # another slot than alpha's
        B.import_state(sb, exp)
        toks = _continue(B, sb, chunks[1:], 5)
    else:
        B = JEngine(jcfg, jp, n_slots=2, max_len=96)
        sb = B.alloc("x")
        sb = B.alloc("r")
        B.import_state(sb, jax.tree.map(
            lambda a: a.numpy() if isinstance(a, torch.Tensor) else a, got))
        toks = _continue(B, sb, chunks[1:], 5, item=JItem)
    assert toks == ref


def _frontend_kw(cfg, rng):
    if cfg.arch_type == "vlm":
        return {"extra_embeds": (0.02 * rng.standard_normal(
            (cfg.num_patches, cfg.d_model))).astype(np.float32)}
    return {"frames": (0.02 * rng.standard_normal(
        (cfg.encoder_len, cfg.d_model))).astype(np.float32)}


@pytest.mark.parametrize("arch", FRONTENDS)
def test_run_frontend_matches_jax_engine(arch):
    """The reference's ``test_vlm_and_audio_frontend_prefill``, held
    against the JAX engine: the frontend's logits, then four decode
    steps' greedy tokens."""
    jcfg, jp, cfg, tp = _dense(arch)
    rng = np.random.default_rng(0)
    kw = _frontend_kw(cfg, rng)
    prompt = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
    n_extra = cfg.num_patches if cfg.arch_type == "vlm" else 0
    streams = []
    for eng, item in ((InstanceEngine(cfg, tp, n_slots=2, max_len=96),
                       BatchItem),
                      (JEngine(jcfg, jp, n_slots=2, max_len=96), JItem)):
        slot = eng.alloc("r")
        logits = np.asarray(eng.run_frontend(slot, tokens=prompt,
                                             pos_offset=0, **kw))
        assert logits.shape == (cfg.vocab_size,)
        toks = [int(logits.argmax())]
        pos = n_extra + len(prompt)
        for _ in range(4):
            out = eng.run_batch([item(slot, np.array([toks[-1]], np.int32),
                                      pos, want_logits=True)])
            toks.append(int(out[slot].argmax()))
            pos += 1
        streams.append((logits, toks))
    np.testing.assert_allclose(streams[0][0], streams[1][0], rtol=3e-4,
                               atol=3e-4)
    assert streams[0][1] == streams[1][1]


def test_second_frontend_rewrites_every_slots_cross_kv():
    """The reference's trait, kept: ``run_frontend`` with frames
    re-encodes every row (inactive rows on zero frames) and replaces the
    cross K/V of every slot, so slot 0's cross K/V become the projections
    of the encoder run on zero frames once slot 1's request arrives.  Both
    engines agree on the caches and on slot 0's next tokens."""
    jcfg, jp, cfg, tp = _dense("whisper-large-v3")
    from repro_torch.models.mixers import _project_qkv
    from repro_torch.models.model import _encoder_fwd
    rng = np.random.default_rng(1)
    fr0, fr1 = (_frontend_kw(cfg, rng)["frames"] for _ in range(2))
    prompts = [rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
               for _ in range(2)]
    E, J = (InstanceEngine(cfg, tp, n_slots=2, max_len=64),
            JEngine(jcfg, jp, n_slots=2, max_len=64))
    toks = []
    for eng, item in ((E, BatchItem), (J, JItem)):
        s0, s1 = eng.alloc("a"), eng.alloc("b")
        t0 = int(np.asarray(eng.run_frontend(s0, frames=fr0,
                                             tokens=prompts[0])).argmax())
        eng.run_frontend(s1, frames=fr1, tokens=prompts[1])
        toks.append(_gen(eng, s0, np.array([t0], np.int32), 3, pos0=6,
                         item=item))
    assert toks[0] == toks[1]
    for k in ("xk", "xv"):
        np.testing.assert_allclose(E.cache["cross"][k].numpy(),
                                   np.asarray(J.cache["cross"][k]),
                                   rtol=3e-4, atol=3e-4)
    with torch.no_grad():
        enc0 = _encoder_fwd(tp, cfg, torch.zeros(1, cfg.encoder_len,
                                                 cfg.d_model))
        for layer, lp in enumerate(tp["layers"]):
            _, xk, xv = _project_qkv(lp["cross"], cfg, enc0[:, :1], enc0)
            np.testing.assert_allclose(E.cache["cross"]["xk"][layer, 0],
                                       xk[0], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(E.cache["cross"]["xv"][layer, 0],
                                       xv[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", DENSE_FAMS + FRONTENDS)
def test_dense_state_bytes_equal_jax(arch):
    jcfg, jp, cfg, tp = _dense(arch)
    eng = InstanceEngine(cfg, tp, n_slots=1, max_len=96)
    ref = JEngine(jcfg, jp, n_slots=1, max_len=96)
    for upto in (1, 16, 40, 96):
        assert eng.state_bytes(upto) == ref.state_bytes(upto)
        assert eng.state_bytes(upto, as_precision="bf16") == \
            ref.state_bytes(upto, as_precision="bf16")


@pytest.mark.parametrize("arch", DENSE_FAMS)
def test_reused_dense_slot_starts_clean(arch):
    """A request on a freed and reused dense slot gets the logits of a
    fresh engine in the port, which empties the slot when it hands it
    out.  The reference leaves the previous request's recurrent state and
    ring entries there (a fault of the reference, ``ROADMAP.md`` queue
    C), so its reused slot's logits differ; that is checked too, so that
    a change on either side shows."""
    jcfg, jp, cfg, tp = _dense(arch)
    first, second = _prompt(20, 30, cfg.vocab_size), \
        _prompt(21, 12, cfg.vocab_size)
    logits = {}
    for name, make, item in (
            ("port", lambda: InstanceEngine(cfg, tp, n_slots=1, max_len=64),
             BatchItem),
            ("jax", lambda: JEngine(jcfg, jp, n_slots=1, max_len=64),
             JItem)):
        fresh = make()
        ref = fresh.run_batch([item(fresh.alloc("b"), second, 0, True)])[0]
        eng = make()
        slot = eng.alloc("a")
        _gen(eng, slot, first, 4, item=item)
        eng.free(slot)
        got = eng.run_batch([item(eng.alloc("b"), second, 0, True)])[0]
        logits[name] = np.asarray(ref), np.asarray(got)
    np.testing.assert_array_equal(logits["port"][1], logits["port"][0])
    np.testing.assert_allclose(logits["port"][0], logits["jax"][0],
                               rtol=1e-4, atol=1e-4)
    assert np.abs(logits["jax"][1] - logits["jax"][0]).max() > 1e-2
