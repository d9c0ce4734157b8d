"""The port's engine and serving session against the JAX package's.

Handoff pieces keep the reference's wire format: the same dict shape,
spans and page layout, and the same bytes (bf16 compared as 16-bit
integers, fp8 as bytes).  A two-instance DynaServe session on the port
produces the same greedy tokens as the JAX ``EngineBackend`` and as
colocation, on the same converted weights (f32 smoke config)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
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
    _, _, cfg, tp = f32
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InstanceEngine(cfg, tp, kv_mode="dense")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InstanceEngine(cfg, tp, devices=["cuda:0", "cuda:1"])
    eng = InstanceEngine(cfg, tp, n_slots=1, max_len=16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.run_frontend(0)
