"""The port's dryrun against the JAX package's: tree sizes, abstract
builds, per-device argument bytes of every assigned arch under the specs,
the records of ``tests/test_dryrun.py``'s five combos, the recorded
collectives and FLOPs, the data-free write plan, the sequence-sharded
decode, and ``forward``'s ``logits_slice`` and ``append_external``.

The JAX side of the byte comparison runs in one subprocess with 8 forced
host devices and compiles nothing: it sums ``NamedSharding.shard_shape``
over the reference's abstract trees.  Everything on the port's side runs
in this process, on the ``meta`` device or on the CPU.  Tolerances: f32
attention outputs 1e-5; whole-model logits and deltas 1e-4, as in
``tests/test_torch_model.py``; positions, bytes and FLOPs exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import repro.models.mixers as jmx  # noqa: E402
import repro_torch.models.mixers as tmx  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.utils import trees as jtrees  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ASSIGNED_ARCHS, ARCH_IDS, INPUT_SHAPES, canonical, get_config,
    get_smoke_config)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import tp as ttp  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.utils import trees as ttrees  # noqa: E402
from repro_torch.utils.sharding import Layout  # noqa: E402
from repro_torch.utils.tree import tree_items  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
LAYOUTS = {"2x4": ((2, 4), ("data", "model")),
           "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CACHE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


def weights(arch, seed=0, **overrides):
    """(jax cfg, jax params, port cfg, port params) on the same weights,
    with random biases and norm scales where the tree has them."""
    jcfg = jconfigs.get_smoke_config(arch).with_(**overrides)
    cfg = get_smoke_config(arch).with_(**overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(seed)
    np_params = jax.tree.map(np.asarray,
                             jmodel.init_params(jcfg, jax.random.PRNGKey(seed)))

    def randomize(tree):
        if isinstance(tree, (list, tuple)):
            for t in tree:
                randomize(t)
            return
        for key, val in tree.items():
            if isinstance(val, (dict, list, tuple)):
                randomize(val)
            elif key in ("bq", "bk", "bv", "bias", "conv_b", "b_a", "b_x"):
                tree[key] = (0.5 * rng.standard_normal(val.shape)).astype(
                    val.dtype)
            elif key in ("scale", "q_norm", "k_norm", "norm", "D"):
                tree[key] = (1 + 0.3 * rng.standard_normal(val.shape)) \
                    .astype(val.dtype)

    randomize(np_params)
    return (jcfg, jax.tree.map(jnp.asarray, np_params), cfg,
            params_from_jax(np_params, cfg, device="cpu"))


def close(got, exp, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# trees and abstract builds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "recurrentgemma-9b",
                                  "whisper-large-v3"])
def test_tree_bytes_and_param_count_match_reference(arch):
    jcfg, jp, cfg, tp = weights(arch)
    for tree in (tp, tmodel.init_params(cfg, abstract=True)):
        assert ttrees.tree_bytes(tree) == jtrees.tree_bytes(jp)
        assert ttrees.tree_param_count(tree) == jtrees.tree_param_count(jp)


def _leaves(tree):
    return [(k, tuple(v.shape), v.dtype) for k, v in tree_items(tree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_builds_equal_the_concrete_ones(arch):
    """Params, a dense cache (window override too) and AdamW state (f32
    and bf16 moments), leaf for leaf: path, shape, dtype; meta, no data."""
    cfg = get_smoke_config(arch)
    real = tmodel.init_params(cfg, device="cpu")
    meta = tmodel.init_params(cfg, abstract=True)
    assert _leaves(meta) == _leaves(real)
    assert all(v.device.type == "meta" for _, v in tree_items(meta))
    for wo in (None, 8):
        assert _leaves(tmodel.init_cache(cfg, 2, 32, window_override=wo,
                                         abstract=True)) == \
            _leaves(tmodel.init_cache(cfg, 2, 32, window_override=wo,
                                      device="cpu"))
    for md in ("float32", "bfloat16"):
        oc = AdamWConfig(moment_dtype=md)
        a = adamw_init(meta, oc, abstract=True)
        assert _leaves(a) == _leaves(adamw_init(real, oc))
        assert all(v.device.type == "meta" for _, v in tree_items(a))


# ---------------------------------------------------------------------------
# per-device argument bytes against the reference's specs
# ---------------------------------------------------------------------------
_JAX_BYTES = r"""
import json
import jax
import numpy as np
from repro.compat import make_mesh_compat
from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro.launch.specs import cache_shardings, input_specs, param_shardings
from repro.models.model import init_params

LAYOUTS = %s

def nbytes(tree, sh):
    return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
               for x, s in zip(jax.tree.leaves(tree), jax.tree.leaves(sh)))

out = {}
for name, (dims, axes) in LAYOUTS.items():
    mesh = make_mesh_compat(tuple(dims), tuple(axes))
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        params = init_params(cfg, abstract=True)
        r = {"params_train": nbytes(params, param_shardings(
                 params, cfg, mesh, train=True)),
             "params_serve": nbytes(params, param_shardings(
                 params, cfg, mesh, train=False))}
        for s in %s:
            cache = input_specs(cfg, INPUT_SHAPES[s])[1]["cache"]
            r["cache_" + s] = nbytes(cache, cache_shardings(cache, cfg, mesh))
        out[arch + "@" + name] = r
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_spec_bytes():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    src = _JAX_BYTES % (json.dumps(LAYOUTS), repr(CACHE_SHAPES))
    res = subprocess.run([sys.executable, "-c", src], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_argument_bytes_equal_reference_specs(arch, jax_spec_bytes):
    cfg = get_config(arch)
    for name, (dims, axes) in LAYOUTS.items():
        mesh = Layout(dims, axes)
        params = tmodel.init_params(cfg, abstract=True)
        got = {"params_train": specs.shard_bytes(
                   params, specs.param_shardings(params, cfg, mesh, True)),
               "params_serve": specs.shard_bytes(
                   params, specs.param_shardings(params, cfg, mesh, False))}
        for s in CACHE_SHAPES:
            cache = specs.input_specs(cfg, INPUT_SHAPES[s])[1]["cache"]
            got["cache_" + s] = specs.shard_bytes(
                cache, specs.cache_shardings(cache, cfg, mesh))
        assert got == jax_spec_bytes[f"{arch}@{name}"], name


def test_production_layouts_keep_the_reference_device_counts():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.size, one.shape) == (256, {"data": 32, "model": 8})
    assert (two.size, two.shape) == (512, {"pod": 2, "data": 32,
                                           "model": 8})


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------
@pytest.fixture()
def test_layouts(monkeypatch):
    monkeypatch.setenv("REPRO_DRYRUN_MESH", "2x4")
    monkeypatch.setenv("REPRO_DRYRUN_MESH_MULTI", "2x2x2")


@pytest.mark.parametrize("arch,shape,multi", [
    ("chatglm3-6b", "decode_32k", False),
    ("qwen3-moe-30b-a3b", "train_4k", False),
    ("mamba2-780m", "long_500k", False),
    ("recurrentgemma-9b", "decode_32k", True),    # proves the pod axis
    ("whisper-large-v3", "prefill_32k", True),
])
def test_dryrun_records_of_the_reference_combos(arch, shape, multi,
                                                tmp_path, test_layouts,
                                                capsys):
    """``main`` in this process writes the reference's file name and keys."""
    argv = ["--arch", arch, "--shape", shape, "--out", str(tmp_path)]
    assert dryrun.main(argv + (["--multi-pod"] if multi else [])) == 0
    tag = "multi" if multi else "single"
    rec = json.loads((tmp_path / f"{canonical(arch)}__{shape}__{tag}.json")
                     .read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == ("2x2x2" if multi else "2x4")
    assert rec["flops_per_device"] > 0
    m = rec["memory_analysis"]
    assert m["argument_size_bytes"] > 0
    assert set(m) == {"argument_size_bytes", "output_size_bytes",
                      "temp_size_bytes"}
    assert set(rec["collectives"]) == {"per_kind", "bytes_per_device"}
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert all(v >= 0 for v in rec["roofline"].values())
    assert rec["fits"] == (sum(m.values()) <= rec["budget_bytes"])
    assert rec["budget_bytes"] == 80 * 2 ** 30
    assert rec["seq_shard"] == (arch in ("chatglm3-6b", "recurrentgemma-9b"))
    assert "[ok   ]" in capsys.readouterr().out


def test_decode_tp_all_reduce_bytes(test_layouts):
    """Phi-4-mini (4 of its layers) decode on 2x4: every layer sums its
    attention and MLP outputs once over the model axis: 2 x layers x B x
    d_model x 2 bytes (B = 128 / 2 data shards, bf16), and nothing else is
    summed there."""
    cfg = get_config("phi4-mini-3.8b").with_(n_layers=4)
    step = dryrun.build(cfg, INPUT_SHAPES["decode_32k"], Layout(*LAYOUTS["2x4"]))
    _, _, _, records = dryrun.measure(step)
    sums = [r for r in records if r["kind"] == "all-reduce"]
    assert all(r["axis"] == "model" and r["op"] == "sum" for r in sums)
    assert len(sums) == 2 * cfg.n_layers
    assert sum(r["bytes"] for r in sums) == 2 * cfg.n_layers * 64 * \
        cfg.d_model * 2


@pytest.mark.parametrize("arch", ["chatglm3-6b", "recurrentgemma-9b"])
def test_full_depth_flops_equal_group_extrapolation(arch):
    """The port counts at full depth; the reference extrapolates from 1
    and 2 pattern groups: m1 + (G-1)(m2-m1) must be the same count."""
    cfg = get_config(arch)
    mesh, shape = Layout(*LAYOUTS["2x4"]), INPUT_SHAPES["decode_32k"]

    def flops(c):
        return dryrun.measure(dryrun.build(c, shape, mesh))[0]

    m1, m2 = flops(dryrun._with_groups(cfg, 1)), flops(dryrun._with_groups(cfg, 2))
    assert flops(cfg) == m1 + (cfg.n_groups - 1) * (m2 - m1)


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
def test_memoised_trace_counts_what_flop_counter_mode_counts(shape):
    """The trace's memoised FLOPs (FlopCounterMode's own formulas) equal
    FlopCounterMode's count of the same step, and a second trace, and one
    that runs every op (no memo), repeat every figure."""
    cfg = get_config("qwen3-moe-30b-a3b").with_(n_layers=2)
    step = dryrun.build(cfg, INPUT_SHAPES[shape], Layout(*LAYOUTS["2x4"]))
    kw = {"n_run": 2} if shape == "train_4k" else {}
    with FlopCounterMode(display=False) as fc:
        step.run(**kw)
    with dryrun.Traffic(step.args) as tr:
        step.run(**kw)
    assert tr.flops == fc.get_total_flops() > 0
    first = dryrun.measure(step)
    assert dryrun.measure(step)[:3] == first[:3]
    plain = dryrun.measure(step, memo=False)
    assert plain[:3] == first[:3] and plain[3] == first[3]


def test_training_microbatches_extrapolate_exactly():
    """Two traced microbatches and the rest added: the same FLOPs and
    bytes as tracing all of them."""
    cfg = get_config("phi4-mini-3.8b").with_(n_layers=2)
    step = dryrun.build(cfg, INPUT_SHAPES["train_4k"], Layout(*LAYOUTS["2x4"]))
    assert step.microbatches == 4
    with dryrun.Traffic(step.args) as tr:
        step.run()
    flops, nbytes, _, _ = dryrun.measure(step)
    assert (flops, nbytes) == (tr.flops, tr.bytes)


# ---------------------------------------------------------------------------
# the write plan without data, and the sequence-sharded decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,ring,base,S_buf", [
    (1, 0, 0, 32), (7, 0, 0, 32), (1, 8, 0, 8), (5, 8, 0, 8), (20, 8, 0, 8),
    (1, 0, 16, 16), (6, 0, 16, 16), (3, 16, 8, 8)])
def test_whole_chunk_plan_equals_dense_write_plan(T, ring, base, S_buf):
    """On chunks whose every token is written and lands in the buffer, the
    data-free plan the dryrun's meta tensors take equals the plan read
    from the positions."""
    rng = np.random.default_rng(T + ring + base)
    for _ in range(4):
        if ring and not base:        # a ring of its own: any position
            p0 = rng.integers(0, 4 * ring, 3)
        elif ring:                   # a shard of a ring: its slots only
            p0 = ring * rng.integers(0, 4, 3) + base \
                + rng.integers(0, S_buf - T + 1, 3)
        else:
            p0 = rng.integers(base, base + S_buf - T + 1, 3)
        pos = tmx._batch_positions(torch.from_numpy(p0), 3, T, "cpu")
        b, t, slot = tmx._whole_chunk_plan(pos, ring, base)
        # the same writes as a static plan: every token's destination,
        # the scratch row (3 * S_buf) for the tokens not written
        got = torch.full((3 * T,), 3 * S_buf, dtype=torch.long)
        got[b * T + t] = b * S_buf + slot
        exp = tmx.dense_write_plan(pos, S_buf, ring, base=base)
        assert torch.equal(got, exp)


def test_dense_write_plan_on_meta_takes_the_data_free_branch():
    pos = torch.empty((4, 1), dtype=torch.long, device="meta")
    b, t, slot = tmx.dense_write_plan(pos, 64)
    assert b.shape == t.shape == slot.shape == (4,)


def _two_shards(fn, n=2, seq_shard=False):
    group = ttp.ShardGroup(n, seq_shard=seq_shard)
    try:
        return group.run(fn)
    finally:
        group.close()


@pytest.mark.parametrize("extra", [False, True])
def test_flash_decode_seqsharded_matches_reference_flash(extra):
    """Two CPU shards of a ShardGroup, each with half the cache's
    sequence, against the reference's ``_flash_gqa`` over the whole
    cache, with and without the in-flight tile, in f32."""
    rng = np.random.default_rng(3)
    B, Tq, H, KV, hd, S = 2, 1, 8, 2, 32, 96
    q = rng.standard_normal((B, Tq, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    kpos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kpos[1, 70:] = -1                             # a row with empty slots
    qpos = np.array([[S], [69]], np.int32)
    cfg = get_smoke_config("chatglm3-6b")
    ex = None
    if extra:
        ex = (rng.standard_normal((B, Tq, KV, hd)).astype(np.float32),
              rng.standard_normal((B, Tq, KV, hd)).astype(np.float32), qpos)
    exp = jmx._flash_gqa(cfg, *(jnp.asarray(a) for a in (q, k, v, qpos, kpos)),
                         block=16, extra=None if ex is None else
                         tuple(jnp.asarray(a) for a in ex))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731

    def shard(rank):
        sl = slice(rank * S // 2, (rank + 1) * S // 2)
        return tmx._flash_decode_seqsharded(
            cfg, T(q), T(k[:, sl]), T(v[:, sl]), T(qpos), T(kpos[:, sl]), 0,
            None if ex is None else tuple(T(a) for a in ex))

    old = tmx.FLASH_BLOCK
    for got in _two_shards(shard):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5,
                                   atol=1e-5)
    assert tmx.FLASH_BLOCK == old


def test_max_all_reduce_over_a_shard_group():
    parts = [torch.tensor([1.0, 5.0, -2.0]), torch.tensor([3.0, 2.0, -1.0])]
    got = _two_shards(lambda r: ttp.all_reduce(parts[r], op="max"))
    for g in got:
        assert torch.equal(g, torch.tensor([3.0, 5.0, -1.0]))
    with pytest.raises(ValueError):
        ttp.all_reduce(parts[0], op="min")


def _seq_cache(cache, rank, n):
    """Shard ``rank`` of ``n`` of a dense cache's sequence dim, in leaves
    with their scratch rows (``model.cache_leaf``)."""
    def cut(k, t):
        if t.dim() >= 3:                          # (G, B, S, ...)
            S = t.shape[2] // n
            t = t[:, :, rank * S:(rank + 1) * S]
        out = tmodel.cache_leaf(t.shape, t.dtype, t.device,
                                row_dims=tmodel.ROW_DIMS.get(k, 1))
        return out.copy_(t)
    return {"blocks": tuple({k: cut(k, v) for k, v in c.items()}
                            for c in cache["blocks"])}


@pytest.mark.parametrize("prompt", [48, 64])
def test_sequence_sharded_decode_matches_unsharded(prompt):
    """chatglm3-6b smoke (KV 2), f32: a prefill of ``prompt`` tokens (64
    fills the buffer: the full-prompt branch keeps each shard's slice)
    and decode steps through a cache whose sequence is split over four
    shards of a real ShardGroup (KV 2 is not divisible by 4), each with
    its shard of the weights at the dryrun's traced decode layout (every
    query head, ``wo`` split by rows), against the one-device forward."""
    _, _, cfg, tp = weights("chatglm3-6b")
    rng = np.random.default_rng(5)
    n, B, S, steps = 4, 2, 64, 3 if prompt < 64 else 0
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, prompt + steps)))
    whole = tmodel.init_cache(cfg, B, S, device="cpu")

    def decode(params, cache):
        out = []
        with torch.no_grad():
            lg, _, _ = tmodel.forward(params, cfg, toks[:, :prompt],
                                      cache=cache, pos_offset=0)
            out.append(lg[:, -1])
            for i in range(steps):
                lg, _, _ = tmodel.forward(
                    params, cfg, toks[:, prompt + i:prompt + i + 1],
                    cache=cache, pos_offset=torch.full((B,), prompt + i))
                out.append(lg[:, -1])
        return out

    exp = decode(tp, whole)
    empty = tmodel.init_cache(cfg, B, S, device="cpu")
    caches = [_seq_cache(empty, r, n) for r in range(n)]
    layout = Layout((1, n), ("data", "model"))
    shards = [dryrun.traced_shard(tp, cfg, layout, r, seq_decode=True)
              for r in range(n)]
    assert shards[1]["layers"][0]["mixer"]["wq"].shape == \
        tp["layers"][0]["mixer"]["wq"].shape
    assert shards[1]["layers"][0]["mixer"]["wo"].shape[0] * n == \
        cfg.n_heads * cfg.hd
    for got in _two_shards(lambda r: decode(shards[r], caches[r]), n,
                           seq_shard=True):
        for g, e in zip(got, exp):
            np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=TOL,
                                       atol=TOL)
    for r in range(n):
        want = _seq_cache(whole, r, n)
        for c, w in zip(caches[r]["blocks"], want["blocks"]):
            for key in c:
                assert torch.allclose(c[key].float(), w[key].float(),
                                      atol=TOL), key


@pytest.mark.parametrize("step", ["prefill", "ring", "train"])
def test_traced_head_split_layout_matches_unsharded(step):
    """chatglm3-6b smoke (H 8, KV 2) at model 4: the traced layout splits
    the query heads (2 a shard, within one KV head's group of 4) and keeps
    both KV heads, so each shard must attend with its own KV head.  On
    four shards of a real ShardGroup: a full-prompt prefill into a
    sequence-sharded cache; a 48-token prompt through a 32-slot ring
    (window 32) split over the shards, which writes each shard's slots
    and attends over the ring gathered from the group; and the cacheless
    forward a train step runs.  Each matches the one-device forward."""
    _, _, cfg, tp = weights("chatglm3-6b")
    rng = np.random.default_rng(6)
    n, B = 4, 2
    S, T, window = (32, 48, 32) if step == "ring" else (64, 64, None)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    layout = Layout((1, n), ("data", "model"))
    shards = [dryrun.traced_shard(tp, cfg, layout, r) for r in range(n)]
    assert shards[1]["layers"][0]["mixer"]["wq"].shape[-1] * n == \
        cfg.n_heads * cfg.hd
    assert shards[1]["layers"][0]["mixer"]["wk"].shape == \
        tp["layers"][0]["mixer"]["wk"].shape
    cached = step != "train"

    def run(params, cache):
        with torch.no_grad():
            return tmodel.forward(params, cfg, toks, cache=cache,
                                  pos_offset=0, window_override=window)[0]

    whole = tmodel.init_cache(cfg, B, S, device="cpu") if cached else None
    exp = run(tp, whole)
    caches = [_seq_cache(tmodel.init_cache(cfg, B, S, device="cpu"), r, n)
              if cached else None for r in range(n)]
    for got in _two_shards(lambda r: run(shards[r], caches[r]), n,
                           seq_shard=cached):
        np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=TOL,
                                   atol=TOL)
    for r in range(n if cached else 0):
        want = _seq_cache(whole, r, n)
        for c, w in zip(caches[r]["blocks"], want["blocks"]):
            for key in c:
                assert torch.allclose(c[key].float(), w[key].float(),
                                      atol=TOL), key


def test_sequence_sharded_decode_counts_the_replicated_q():
    """chatglm3-6b ``decode_32k`` (one layer) at data 32 x model 8, as the
    reference's design runs it: every shard attends with all 32 query
    heads over its 4096 of the 32768 positions, so the attention's FLOPs
    are 4 x B x H x S_local x hd (B = 4 a data shard), and the merge
    takes a max over B x H f32 and sums of B x H and B x H x hd f32."""
    from repro_torch.configs.shapes import InputShape
    cfg = dryrun._with_groups(get_config("chatglm3-6b"), 1)
    mesh = Layout((32, 8), ("data", "model"))
    B, H, hd = 4, cfg.n_heads, cfg.hd

    def measure(seq):
        step = dryrun.build(cfg, InputShape("d", seq, 128, "decode"), mesh)
        assert step.seq_shard
        return dryrun.measure(step)

    f_full, _, _, records = measure(32_768)
    f_half = measure(16_384)[0]
    assert f_full - f_half == 4 * B * H * (4096 - 2048) * hd * cfg.n_layers
    maxes = [r["bytes"] for r in records if r["op"] == "max"]
    sums = [r["bytes"] for r in records if r["op"] == "sum"]
    assert maxes == [B * H * 4] * cfg.n_layers
    assert sums.count(B * H * hd * 4) == cfg.n_layers
    assert sums.count(B * H * 4) == cfg.n_layers


# ---------------------------------------------------------------------------
# forward's logits_slice and append_external against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2.5-14b"])
def test_forward_logits_slice_matches_jax(arch):
    jcfg, jp, cfg, tp = weights(arch)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    kw = {}
    if cfg.arch_type == "audio":
        kw["frames"] = rng.standard_normal(
            (2, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    jl, _, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks), logits_slice=3,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        tl, _, _ = tmodel.forward(tp, cfg, torch.from_numpy(toks),
                                  logits_slice=3,
                                  **{k: torch.from_numpy(v)
                                     for k, v in kw.items()})
    assert tuple(tl.shape) == (2, 3, cfg.vocab_size)
    close(tl, jl)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen2.5-14b"])
def test_forward_append_external_matches_jax(arch):
    """A prefill through a dense cache, then one decode token with
    ``append_external``: the logits and every layer's K/V deltas and
    positions match the reference, and the port's caches are left as
    they were."""
    jcfg, jp, cfg, tp = weights(arch)
    rng = np.random.default_rng(9)
    B, P, S = 2, 10, 32
    toks = rng.integers(0, cfg.vocab_size, (B, P + 1)).astype(np.int32)
    jc = jmodel.init_cache(jcfg, B, S)
    _, jc, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks[:, :P]), cache=jc,
                              pos_offset=0)
    tc = tmodel.init_cache(cfg, B, S, device="cpu")
    with torch.no_grad():
        tmodel.forward(tp, cfg, torch.from_numpy(toks[:, :P]), cache=tc,
                       pos_offset=0)
    before = {k: v.clone() for k, v in tree_items(tc)
              if k.endswith(("['k']", "['v']", "['pos']"))}
    pos = np.full((B,), P, np.int32)
    jl, jd, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks[:, P:]), cache=jc,
                               pos_offset=jnp.asarray(pos),
                               append_external=True)
    with torch.no_grad():
        tl, td, _ = tmodel.forward(tp, cfg, torch.from_numpy(toks[:, P:]),
                                   cache=tc, pos_offset=torch.from_numpy(pos),
                                   append_external=True)
    close(tl, jl)
    got = dict(tree_items(td))
    exp = {jax.tree_util.keystr(p): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(jd)[0]}
    assert set(got) == set(exp)
    assert any("k_delta" in k for k in got)
    for key, e in exp.items():
        g = got[key]
        assert tuple(g.shape) == e.shape, key
        if e.dtype == np.int32:
            assert np.array_equal(g.numpy(), e), key
        else:
            np.testing.assert_allclose(g.numpy(), e, rtol=TOL, atol=TOL,
                                       err_msg=key)
    for k, v in tree_items(tc):
        if k in before:
            assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen3-moe-30b-a3b"])
def test_remat_recompute_keeps_the_shard_context(arch):
    """On a card, autograd recomputes a remat group on its device thread,
    where the caller's shard context is unset.  The recompute must run as
    the same shard: here the gradient is taken outside the context, and
    the recompute records tensor-parallel (or expert-parallel) sums again
    (up to the last one whose result the backward needs: the
    checkpoint's early stop), beside each sum's conjugate."""
    from repro_torch.models.model import loss_fn
    from repro_torch.utils.sharding import shard_params, tp_param_specs
    from repro_torch.utils.tree import tree_unflatten
    cfg = get_smoke_config(arch)
    full = tmodel.init_params(cfg, device="cpu")
    params = shard_params(full, tp_param_specs(cfg, full), 2, 0, "cpu")
    leaves = [p.detach().requires_grad_() for _, p in tree_items(params)]
    params = tree_unflatten(params, leaves)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
             for k in ("tokens", "labels")}
    group = ttp.RecordingGroup(2)
    with ttp.tp_context(group, 0):
        loss, _ = loss_fn(params, cfg, batch, remat=True)
    n = len(group.records)
    assert n == 2 * cfg.n_layers
    grads = torch.autograd.grad(loss, leaves)
    assert 2 * n < len(group.records) <= 3 * n
    assert all(g is not None for g in grads)


@pytest.mark.parametrize("arch,shape", [
    ("chatglm3-6b", ("decode_32k", 4096, 128, "decode")),
    ("qwen3-moe-30b-a3b", ("prefill_32k", 2048, 32, "prefill"))])
def test_meta_peak_equals_real_tensors_peak(arch, shape):
    """The meta trace's peak of live bytes (memoised results included)
    equals the same tracking of the step run on real CPU tensors, on the
    smoke config at cut lengths: only the data-dependent write plan's few
    index bytes may differ."""
    from repro_torch.configs.shapes import InputShape
    cfg = get_smoke_config(arch)
    sh = InputShape(*shape)
    step = dryrun.build(cfg, sh, Layout((32, 8), ("data", "model")))
    _, _, peak, _ = dryrun.measure(step)
    args = dryrun._device_inputs(step, cfg, sh, torch.device("cpu"), 0)
    step.run(args)
    with dryrun.Traffic(args) as tr:
        step.run(args)
    assert abs(tr.peak - peak) <= 1024
