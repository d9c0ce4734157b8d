"""Sharded (tensor- and expert-parallel) instances of the port against the
JAX package.

A port instance of width n runs n shard threads, each with its own params
view, cache shard and device; on ``["cpu", "cpu"]`` both shards share the
CPU, as the reference's virtual host devices do.  The port's TP=2 (dense
``qwen2.5-14b``) and EP=2 (``qwen3-moe-30b-a3b``) engines are held against
the JAX single-device engine and the JAX sharded engine (run in a
subprocess with two forced host devices) on the same converted f32 smoke
weights, with random biases and norm scales: logits within 2e-4 (the
tolerance of ``tests/test_sharded.py``) and greedy tokens equal.  Then
the expert-parallel ``moe_fwd`` alone, handoffs across widths, a sharded
``EngineBackend`` session, the reference's rejections, mixed-width
placement, the elastic width trade, a failing shard, and the shard
group's all-reduce under thread contention."""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.engine import BatchItem as JItem  # noqa: E402
from repro.engine import InstanceEngine as JEngine  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.utils import sharding as jsharding  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.costmodel import A100  # noqa: E402
from repro_torch.engine import BatchItem, InstanceEngine  # noqa: E402
from repro_torch.engine.backend import EngineBackend  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import tp as ttp  # noqa: E402
from repro_torch.utils import sharding as tsharding  # noqa: E402
from repro_torch.utils.device import (  # noqa: E402
    DEVICE_COUNT_ENV, visible_devices,
)

ROOT = Path(__file__).resolve().parents[1]
MOE = "qwen3-moe-30b-a3b"
DENSE = "qwen2.5-14b"
TOL = 2e-4
CPU2 = ["cpu", "cpu"]
_W = {}


def _randomize(np_params, seed):
    """Random biases (std 0.5) and norm scales (1 +- 0.3), in place, so a
    bias or norm the shards split wrongly shows."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        for key, val in (list(tree.items()) if isinstance(tree, dict)
                         else enumerate(tree)):
            if isinstance(val, (dict, list, tuple)):
                walk(val)
            elif key in ("bq", "bk", "bv", "bias"):
                tree[key] = (0.5 * rng.standard_normal(val.shape)) \
                    .astype(val.dtype)
            elif key in ("scale", "q_norm", "k_norm"):
                tree[key] = (1 + 0.3 * rng.standard_normal(val.shape)) \
                    .astype(val.dtype)
    walk(np_params)
    return np_params


def _weights(arch):
    """(jax cfg, jax params, port cfg, port params, numpy leaves) of a
    smoke config in f32, built once per module."""
    if arch not in _W:
        jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
        tree = _randomize(jax.tree.map(
            np.array, jmodel.init_params(jcfg, jax.random.PRNGKey(0))), 1)
        leaves = jax.tree_util.tree_leaves(tree)
        _W[arch] = (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
                    params_from_jax(tree, cfg, device="cpu"), leaves)
    return _W[arch]


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _greedy(eng, slot, prompt, n, item=BatchItem):
    out = eng.run_batch([item(slot, prompt, 0, want_logits=True)])
    first = np.asarray(out[slot])
    toks = [int(first.argmax())]
    pos = len(prompt)
    for _ in range(n - 1):
        out = eng.run_batch([item(slot, np.array([toks[-1]], np.int32),
                                  pos, want_logits=True)])
        toks.append(int(np.asarray(out[slot]).argmax()))
        pos += 1
    return toks, first


@pytest.fixture
def devices4(monkeypatch):
    """Four visible CPU devices: the CPU repeated, as XLA's forced host
    platform device count gives the reference."""
    monkeypatch.setenv(DEVICE_COUNT_ENV, "4")
    return visible_devices("cpu")


# ---------------------------------------------------------------------------
# sharded execution against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [MOE, DENSE])
def test_tp_logits_match_jax_single_device(name):
    """TP=2 (EP=2 on the MoE arch) on two CPU shards gives the JAX
    single-device engine's logits and greedy tokens."""
    jcfg, jp, cfg, tp, _ = _weights(name)
    prompt = _prompt(0, 24, cfg.vocab_size)
    ref = JEngine(jcfg, jp, n_slots=2, max_len=96)
    ref_toks, ref_logits = _greedy(ref, ref.alloc("r"), prompt, 6, JItem)
    eng = InstanceEngine(cfg, tp, n_slots=2, max_len=96, devices=CPU2)
    assert eng.tp == 2
    toks, logits = _greedy(eng, eng.alloc("r"), prompt, 6)
    np.testing.assert_allclose(logits, ref_logits, atol=TOL, rtol=TOL)
    assert toks == ref_toks


_JAX_SHARDED = r"""
import sys, json
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.engine import BatchItem, InstanceEngine
from repro.models.model import init_params
out_dir = sys.argv[1]
res = {}
for name in sys.argv[2:]:
    cfg = get_smoke_config(name)
    treedef = jax.tree_util.tree_structure(
        init_params(cfg, jax.random.PRNGKey(0)))
    z = np.load(f"{out_dir}/{name}.npz")
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(z[f"a{i}"]) for i in range(len(z.files) - 1)])
    prompt = z["prompt"]
    eng = InstanceEngine(cfg, params, n_slots=2, max_len=96,
                         devices=jax.devices()[:2])
    assert eng.tp == 2
    s = eng.alloc("r")
    out = eng.run_batch([BatchItem(s, prompt, 0, want_logits=True)])
    first = np.asarray(out[s])
    toks = [int(first.argmax())]
    pos = len(prompt)
    for _ in range(5):
        out = eng.run_batch([BatchItem(s, np.array([toks[-1]], np.int32),
                                       pos, want_logits=True)])
        toks.append(int(np.asarray(out[s]).argmax()))
        pos += 1
    np.save(f"{out_dir}/{name}-logits.npy", first)
    res[name] = toks
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The JAX *sharded* engine (TP=2 over two forced host devices) on the
    same weights and prompt, run once in a subprocess: {name: (tokens,
    first logits)}."""
    out = tmp_path_factory.mktemp("jax_sharded")
    for name in (MOE, DENSE):
        leaves = _weights(name)[4]
        np.savez(out / f"{name}.npz",
                 prompt=_prompt(0, 24, _weights(name)[2].vocab_size),
                 **{f"a{i}": a for i, a in enumerate(leaves)})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _JAX_SHARDED, str(out),
                           MOE, DENSE], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    toks = json.loads(proc.stdout.strip().splitlines()[-1])
    return {n: (toks[n], np.load(out / f"{n}-logits.npy"))
            for n in (MOE, DENSE)}


@pytest.mark.parametrize("name", [MOE, DENSE])
def test_tp_logits_match_jax_sharded_engine(name, jax_sharded):
    """The same port instance against the reference's own TP=2 engine
    (``shard_map`` over two host devices), on the same prompt."""
    _, _, cfg, tp, _ = _weights(name)
    prompt = _prompt(0, 24, cfg.vocab_size)
    eng = InstanceEngine(cfg, tp, n_slots=2, max_len=96, devices=CPU2)
    toks, logits = _greedy(eng, eng.alloc("r"), prompt, 6)
    ref_toks, ref_logits = jax_sharded[name]
    np.testing.assert_allclose(logits, ref_logits, atol=TOL, rtol=TOL)
    assert toks == ref_toks


def test_tp_dense_kv_mode_matches_jax():
    """A sharded instance over the dense slot cache (and a ring of 8
    slots under ``window_override``) decodes the JAX dense engine's
    tokens; each shard's K/V holds its KV heads, ``pos`` is replicated."""
    jcfg, jp, cfg, tp, _ = _weights(DENSE)
    prompt = _prompt(3, 20, cfg.vocab_size)
    for kw in ({"kv_mode": "dense"}, {"window_override": 8}):
        ref = JEngine(jcfg, jp, n_slots=2, max_len=64, **kw)
        eng = InstanceEngine(cfg, tp, n_slots=2, max_len=64, devices=CPU2,
                             **kw)
        assert not eng.paged
        assert eng.caches[1]["blocks"][0]["k"].shape[-2] == \
            cfg.n_kv_heads // 2
        want, want_logits = _greedy(ref, ref.alloc("r"), prompt, 5, JItem)
        got, logits = _greedy(eng, eng.alloc("r"), prompt, 5)
        np.testing.assert_allclose(logits, want_logits, atol=TOL, rtol=TOL)
        assert got == want


def test_shard_weights_are_views_and_pools_are_per_shard():
    """On the weights' device every shard's weights are views into the
    shared tensors (no weight memory added); each shard's page pool is
    its own contiguous allocation at KV / n heads."""
    _, _, cfg, tp, _ = _weights(DENSE)
    eng = InstanceEngine(cfg, tp, n_slots=2, max_len=64, devices=CPU2)
    for r, sp in enumerate(eng.shard_params):
        for path, leaf in _flat(sp):
            full = _get(tp, path)
            assert leaf.untyped_storage().data_ptr() == \
                full.untyped_storage().data_ptr(), path
        wq = sp["layers"][0]["mixer"]["wq"]
        assert wq.shape[-1] == cfg.n_heads * cfg.hd // 2
        assert torch.equal(wq, tp["layers"][0]["mixer"]["wq"]
                           .chunk(2, dim=-1)[r])
    pools = [c["blocks"][0]["k_pages"] for c in eng.caches]
    assert all(p.is_contiguous() and p.shape[-2] == cfg.n_kv_heads // 2
               for p in pools)
    assert pools[0].data_ptr() != pools[1].data_ptr()


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", [MOE, DENSE])
def test_param_and_cache_specs_follow_the_reference(name):
    """Every leaf's split dim is where the reference's PartitionSpec puts
    the mesh axis (counted from the end), layer for layer."""
    jcfg, jp, cfg, tp, _ = _weights(name)
    jspecs = jsharding.tp_param_specs(jcfg, jp)
    tspecs = tsharding.tp_param_specs(cfg, tp)

    def pos(spec, ndim):
        axes = [i - ndim for i, a in enumerate(spec) if a is not None]
        return axes[0] if axes else None

    PL, G = cfg.pattern_len, cfg.n_groups
    n = 0
    for g in range(G):
        for i in range(PL):
            for path, spec in jax.tree_util.tree_flatten_with_path(
                    jspecs["blocks"][i], is_leaf=lambda s: isinstance(
                        s, jax.sharding.PartitionSpec))[0]:
                keys = tuple(p.key for p in path)
                ndim = _get(jp["blocks"][i], keys).ndim
                assert _get(tspecs["layers"][g * PL + i], keys) == \
                    pos(spec, ndim), keys
                n += 1
    assert n > 10
    for key in ("embed", "final_norm", "lm_head"):
        if key in tp:
            assert all(s is None for _, s in _flat(tspecs[key]))
    eng = InstanceEngine(cfg, tp, n_slots=2, max_len=32)
    cspecs = tsharding.tp_cache_specs(eng.cache)
    assert cspecs["blocks"][0] == {"k_pages": -2, "v_pages": -2}
    dense = tsharding.tp_cache_specs(
        InstanceEngine(cfg, tp, n_slots=2, max_len=32,
                       kv_mode="dense").cache)
    assert dense["blocks"][0] == {"k": -2, "v": -2, "pos": None}


def test_moe_ep_matches_jax_moe_fwd():
    """The expert-parallel ``moe_fwd`` on two shards, each holding half
    the experts, against the reference's ``moe_fwd`` on all of them, on
    the same numpy arrays; outside a sharded step a slice is refused."""
    cfg = get_smoke_config(MOE)
    E, dm, ff = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    rng = np.random.default_rng(3)
    p = {"router": (0.3 * rng.standard_normal((dm, E))).astype(np.float32),
         "wi": (rng.standard_normal((E, dm, ff)) / np.sqrt(dm))
         .astype(np.float32),
         "wg": (rng.standard_normal((E, dm, ff)) / np.sqrt(dm))
         .astype(np.float32),
         "wo": (rng.standard_normal((E, ff, dm)) / np.sqrt(ff))
         .astype(np.float32)}
    x = rng.standard_normal((2, 8, dm)).astype(np.float32)
    y_ref, aux_ref = jlayers.moe_fwd(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), cfg)
    tparams = {k: torch.from_numpy(v) for k, v in p.items()}
    specs = {"router": None, "wi": -3, "wg": -3, "wo": -3}
    group = ttp.ShardGroup(2)
    try:
        outs = group.run(lambda r: tlayers.moe_fwd(
            tsharding.shard_params(tparams, specs, 2, r, "cpu"),
            torch.from_numpy(x), cfg))
    finally:
        group.close()
    for y, aux in outs:
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref),
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-5)
    half = tsharding.shard_params(tparams, specs, 2, 0, "cpu")
    with pytest.raises(ValueError, match="expert slice"):
        tlayers.moe_fwd(half, torch.from_numpy(x), cfg)


# ---------------------------------------------------------------------------
# handoffs across widths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("src_tp,dst_tp", [(2, 1), (1, 2)])
def test_handoff_across_shard_widths(src_tp, dst_tp):
    """export_state gathers the shards into the portable piece format, so
    a handoff crosses widths (TP=2 -> TP=1 and back) and the destination
    decodes the JAX single-device engine's tokens."""
    jcfg, jp, cfg, tp, _ = _weights(MOE)
    prompt = _prompt(1, 24, cfg.vocab_size)
    ref = JEngine(jcfg, jp, n_slots=2, max_len=96)
    ref_toks, _ = _greedy(ref, ref.alloc("r"), prompt, 7, JItem)

    def make(n):
        return InstanceEngine(cfg, tp, n_slots=2, max_len=96,
                              devices=CPU2 if n > 1 else None)

    A, B = make(src_tp), make(dst_tp)
    sa = A.alloc("r")
    A.run_batch([BatchItem(sa, prompt[:16], 0)])
    pieces = A.export_state(sa, upto=16, chunk=8)
    assert len(pieces) == 2
    for pc in pieces[0]["pages"]:
        assert pc["k"].shape[-2] == cfg.n_kv_heads
    sb = B.alloc("r")
    B.import_state(sb, pieces)
    out = B.run_batch([BatchItem(sb, prompt[16:], 16, want_logits=True)])
    toks = [int(out[sb].argmax())]
    pos = len(prompt)
    for _ in range(6):
        out = B.run_batch([BatchItem(sb, np.array([toks[-1]], np.int32),
                                     pos, want_logits=True)])
        toks.append(int(out[sb].argmax()))
        pos += 1
    assert toks == ref_toks


def _pieces_equal(a, b):
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        assert pa["span"] == pb["span"]
        for la, lb in zip(pa.get("pages") or pa["blocks"],
                          pb.get("pages") or pb["blocks"]):
            assert la.keys() == lb.keys()
            for k in la:
                assert la[k].dtype == lb[k].dtype
                assert torch.equal(la[k].view(torch.uint8)
                                   if la[k].dtype.itemsize == 1
                                   else la[k], lb[k]), k


@pytest.mark.parametrize("kv_mode", ["paged", "dense"])
def test_tp2_export_roundtrip_is_byte_equal(kv_mode):
    """Pieces a TP=2 instance exports, imported into another TP=2 instance
    (scattered over its shards), re-export equal byte for byte, and the
    gathered K/V equal the two shards' slices side by side."""
    _, _, cfg, tp, _ = _weights(DENSE)
    prompt = _prompt(5, 30, cfg.vocab_size)
    A = InstanceEngine(cfg, tp, n_slots=2, max_len=64, kv_mode=kv_mode,
                       devices=CPU2)
    B = InstanceEngine(cfg, tp, n_slots=3, max_len=64, kv_mode=kv_mode,
                       devices=CPU2)
    sa = A.alloc("r")
    A.run_batch([BatchItem(sa, prompt, 0)])
    first = A.export_state(sa, upto=30, chunk=8)
    B.alloc("x")
    sb = B.alloc("r")
    B.import_state(sb, first)
    _pieces_equal(B.export_state(sb, upto=30, chunk=8), first)
    if kv_mode == "dense":
        k = first[0]["blocks"][0]["k"]
        parts = [c["blocks"][0]["k"][:, sa, 0:8] for c in A.caches]
        assert torch.equal(k, torch.cat(parts, dim=-2))
        assert torch.equal(first[0]["blocks"][0]["pos"],
                           A.caches[1]["blocks"][0]["pos"][:, sa, 0:8])


# ---------------------------------------------------------------------------
# the serving session on sharded instances
# ---------------------------------------------------------------------------
def test_engine_backend_sharded_session_end_to_end(devices4):
    """A qwen3-MoE pool of TP=2/EP=2 instances serves a small trace
    through the full session stack, and the backend reports the shard
    width via describe()/gauges(); a mixed [1, 2] pool reports its
    widths per instance."""
    from repro_torch.core.request import Request
    from repro_torch.core.session import ServeSession, SessionConfig
    from repro_torch.sim.policies import DynaServePolicy
    _, _, cfg, tp, _ = _weights(MOE)
    for dpi in (2, [1, 2]):
        backend = EngineBackend(cfg, tp, n_slots=8, max_len=96,
                                devices_per_instance=dpi)
        rng = np.random.default_rng(0)
        reqs, t = [], 0.0
        for i in range(4):
            t += rng.exponential(0.05)
            reqs.append(Request(f"r{i}", t, int(rng.integers(8, 24)), 6,
                                predicted_decode=6))
        policy = DynaServePolicy(backend.cost, 0.1)
        session = ServeSession(backend, policy,
                               SessionConfig(n_instances=2, slo=0.1))
        m = session.run(reqs)
        assert m.completed == m.offered == 4
        widths = {iid: eng.tp for iid, eng in backend.engines.items()}
        if dpi == 2:
            assert backend.describe()["devices_per_instance"] == 2
            assert widths == {0: 2, 1: 2}
        else:
            assert backend.describe()["devices_per_instance"] == "mixed"
            assert widths == {0: 1, 1: 2}
        for iid, eng in backend.engines.items():
            assert backend.gauges(iid)["devices"] == float(eng.tp)


def test_sharded_session_tokens_equal_one_device_session(devices4):
    """The same trace through DynaServe on a [1, 2] pool (handoffs cross
    widths inside the session) and on a one-device pool gives the same
    tokens, with the shared-prefix cache on."""
    from repro_torch.core.session import ServeSession, SessionConfig
    from repro_torch.sim.policies import DynaServePolicy
    _, _, cfg, tp, _ = _weights(DENSE)
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab_size, 16)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)])
               .astype(np.int32) for n in (9, 20, 14, 5)]
    outs, moved = [], []
    for dpi in (1, [1, 2]):
        backend = EngineBackend(cfg, tp, n_slots=8, max_len=96, hw=A100,
                                prefix_cache=True, devices_per_instance=dpi)
        sess = ServeSession(backend, DynaServePolicy(backend.cost, 0.1),
                            SessionConfig(n_instances=2, slo=0.1))
        outs.append([list(h) for h in [sess.generate(p, 6)
                                       for p in prompts]])
        moved.append(backend.kv_bytes_moved)
    assert outs[0] == outs[1]
    assert moved[1] > 0


def test_validate_tp_rejections():
    """Every width the reference rejects is rejected with its message;
    devices of two kinds in one instance too."""
    _, _, cfg, tp, _ = _weights(DENSE)
    with pytest.raises(ValueError, match="% 3 != 0"):
        InstanceEngine(cfg, tp, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="quantized|fp8"):
        InstanceEngine(cfg, tp, devices=CPU2, kv_precision="fp8")
    with pytest.raises(ValueError, match="n_kv_heads"):
        InstanceEngine(cfg, tp, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="mix kinds"):
        InstanceEngine(cfg, tp, devices=["cpu", "meta"])
    for arch, what in (("mamba2-780m", "attention-only"),
                       ("whisper-large-v3", "tail/cross/frontend"),
                       ("internvl2-76b", "tail/cross/frontend")):
        acfg = get_smoke_config(arch)
        with pytest.raises(ValueError, match=what):
            InstanceEngine(acfg, tp, devices=CPU2)
    with pytest.raises(ValueError, match="moe_experts=4 % 3"):
        InstanceEngine(get_smoke_config(MOE), _weights(MOE)[3],
                       devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="d_ff="):
        InstanceEngine(cfg.with_(d_ff=cfg.d_ff + 1), tp, devices=CPU2)


def test_engine_device_shortage_names_the_setting(monkeypatch):
    """Asking for a wider instance than the host has devices raises at
    assignment, naming the setting that repeats them; with it set, the
    instance spawns."""
    monkeypatch.delenv(DEVICE_COUNT_ENV, raising=False)
    assert visible_devices("cpu") == [torch.device("cpu")]
    _, _, cfg, tp, _ = _weights(DENSE)
    backend = EngineBackend(cfg, tp, devices_per_instance=2)
    with pytest.raises(ValueError, match=DEVICE_COUNT_ENV):
        backend.spawn(0)
    monkeypatch.setenv(DEVICE_COUNT_ENV, "3")
    assert visible_devices("cpu") == [torch.device("cpu")] * 3
    backend.spawn(1)
    assert backend.engines[1].tp == 2
    backend.retire(1)


def test_placement_identity_mixed_widths():
    """The port's EngineBackend and the JAX SimBackend build the same
    per-width cost models, so Algorithm 1 makes identical placement
    decisions over a mixed devices_per_instance pool."""
    from repro.core.costmodel import A100 as JA100
    from repro.core.costmodel import BatchCostModel as JCost
    from repro.core.global_scheduler import GlobalScheduler as JGS
    from repro.core.global_scheduler import InstanceView as JView
    from repro.core.predictor import QueuedWork as JWork
    from repro.core.request import Request as JRequest
    from repro.sim.simulator import SimBackend
    from repro_torch.core.global_scheduler import (
        GlobalScheduler, InstanceView,
    )
    from repro_torch.core.predictor import QueuedWork
    from repro_torch.core.request import Request
    jcfg, _, cfg, tp, _ = _weights(DENSE)
    eng = EngineBackend(cfg, tp, hw=A100, devices_per_instance=[1, 2])
    sim = SimBackend(JCost(jcfg, JA100), devices_per_instance=[1, 2])
    probes = [(256, 0, 0, 0), (128, 64, 4, 96), (0, 0, 8, 128)]
    for iid in (0, 1):
        ce, cs = eng.cost_for(iid), sim.cost_for(iid)
        assert ce.tp == cs.tp == iid + 1
        for M, ctx, dnum, dctx in probes:
            assert ce.mixed_batch_latency(M, ctx, dnum, dctx) == \
                cs.mixed_batch_latency(M, ctx, dnum, dctx)
    queues = [[("a", 300, 40, 0), ("b", 100, 20, 0)],
              [("c", 500, 10, 0)]]
    gs_e, gs_s = GlobalScheduler(eng.cost, 0.1), JGS(sim.cost, 0.1)
    for i, (P_, D) in enumerate([(400, 60), (900, 30), (64, 128)]):
        pe = gs_e.schedule(
            Request(f"r{i}", 0.0, P_, D, predicted_decode=D),
            [InstanceView(j, [QueuedWork(*w) for w in q],
                          cost=eng.cost_for(j))
             for j, q in enumerate(queues)])
        ps = gs_s.schedule(
            JRequest(f"r{i}", 0.0, P_, D, predicted_decode=D),
            [JView(j, [JWork(*w) for w in q], cost=sim.cost_for(j))
             for j, q in enumerate(queues)])
        assert (pe.phi, pe.alpha_instance, pe.beta_instance, pe.probes) \
            == (ps.phi, ps.alpha_instance, ps.beta_instance, ps.probes)
        assert pe.predicted_t1 == ps.predicted_t1
        assert pe.predicted_t2 == ps.predicted_t2


def test_elastic_width_trade_runs_on_the_engine_backend(devices4):
    """``ElasticDynaServePolicy`` with ``max_devices_per_instance=2``
    merges the two loaded one-device members into one TP=2 instance on
    the port's EngineBackend (the session revives a retired member at
    the new width), completes every request, and every token equals a
    colocated one-device pool's."""
    from repro_torch.core.elastic import ElasticConfig
    from repro_torch.core.session import ServeSession, SessionConfig
    from repro_torch.engine.cluster import ServingCluster
    from repro_torch.sim.policies import ElasticDynaServePolicy
    _, _, cfg, tp, _ = _weights(DENSE)
    rng = np.random.default_rng(11)
    burst = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in (40, 23, 31, 36, 27, 33, 29, 38)]
    backend = EngineBackend(cfg, tp, n_slots=8, max_len=128, hw=A100)
    policy = ElasticDynaServePolicy(backend.cost, elastic=ElasticConfig(
        min_instances=2, max_instances=2, max_devices_per_instance=2,
        check_interval=0.01, scale_up_drain=0.0, widen_drain=0.0,
        widen_cooldown=0.0, scale_up_cooldown=0.0, queue_low_watermark=1,
        load_ewma_alpha=1.0))
    sess = ServeSession(backend, policy, SessionConfig(n_instances=2))
    handles = [sess.generate(p, 6) for p in burst]
    toks = [list(h) for h in handles]
    assert all(h.req.terminal for h in handles)
    assert all(len(t) == 6 for t in toks)
    widths = {i.iid: backend.devices_for(i.iid) for i in sess.instances}
    assert max(widths.values()) == 2, (widths, sess.pool_events)
    col = ServingCluster(cfg, tp, n_instances=1, split=False, max_len=128)
    outs = [col.submit(p, 6) for p in burst]
    col.run_until_done(outs)
    assert toks == [list(h.generated) for h in outs]


# ---------------------------------------------------------------------------
# the shard group
# ---------------------------------------------------------------------------
def test_a_shard_that_raises_mid_step_reaches_the_caller(monkeypatch):
    """Shard 1 raises inside its second MLP sum while shard 0 waits for
    its turn: the error reaches the caller within a timeout, shard 0 is
    released, and the engine's next step runs and matches one device."""
    _, _, cfg, tp, _ = _weights(DENSE)
    prompt = _prompt(2, 12, cfg.vocab_size)
    eng = InstanceEngine(cfg, tp, n_slots=2, max_len=64, devices=CPU2)
    one = InstanceEngine(cfg, tp, n_slots=2, max_len=64)
    calls = {"n": 0}
    real = tlayers.all_reduce

    def failing(t):
        if ttp.tp_rank() == 1:
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("shard 1 failed")
        return real(t)

    monkeypatch.setattr(tlayers, "all_reduce", failing)
    slot = eng.alloc("r")
    result = {}

    def step():
        try:
            eng.run_batch([BatchItem(slot, prompt, 0, want_logits=True)])
        except RuntimeError as e:
            result["err"] = e

    t = threading.Thread(target=step)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert "shard 1 failed" in str(result.get("err"))
    monkeypatch.setattr(tlayers, "all_reduce", real)
    s1 = one.alloc("r")
    got = eng.run_batch([BatchItem(slot, prompt, 0, want_logits=True)])
    want = one.run_batch([BatchItem(s1, prompt, 0, want_logits=True)])
    np.testing.assert_allclose(got[slot], want[s1], atol=TOL, rtol=TOL)


def test_shard_group_all_reduce_under_contention():
    """Eight shards (more than the cores this test may use) sum 200
    rounds with the interpreter switching threads every 10 us: every
    shard gets every round's exact sum, in time, and a closed group
    refuses work."""
    n, rounds = 8, 200
    group = ttp.ShardGroup(n)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t0 = time.monotonic()
    try:
        def body(rank):
            got = []
            for i in range(rounds):
                got.append(int(ttp.all_reduce(
                    torch.tensor([rank * 1000 + i]))[0]))
            return got

        outs = group.run(body)
    finally:
        sys.setswitchinterval(old)
        group.close()
    want = [sum(r * 1000 + i for r in range(n)) for i in range(rounds)]
    assert outs == [want] * n
    assert time.monotonic() - t0 < 120
    assert not any(t.is_alive() for t in group._threads)
    with pytest.raises(RuntimeError, match="closed"):
        group.run(lambda r: r)


def test_tp_context_is_per_thread():
    """A one-device forward on the caller's thread sees no shard group
    while another thread is inside a sharded step."""
    inside, outside = threading.Event(), []
    group = ttp.ShardGroup(1)
    release = threading.Event()

    def body(rank):
        inside.set()
        release.wait(30)
        return ttp.tp_axis() is group

    res = {}
    t = threading.Thread(target=lambda: res.setdefault("r", group.run(body)))
    t.start()
    assert inside.wait(30)
    outside.append(ttp.tp_axis())
    release.set()
    t.join(30)
    group.close()
    assert outside == [None] and res["r"] == [True]
