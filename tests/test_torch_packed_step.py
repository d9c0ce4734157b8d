"""A paged engine's packed step, on the CPU.

A paged ``InstanceEngine`` packs a step's tokens into one stream of rows,
rounded up to a rung of its row ladder (``runner.row_ladder``), and runs
every token-wise op on those rows; its attention scatters the query rows
into a (slots, chunk) layout for the chunked-prefill kernel, or runs the
paged-decode kernel on the decode-only rung.  These tests hold its steps
against ``forward`` in the (n_slots, T) layout, on a pool of its own
written through the same block tables, and against the JAX engine on
the converted weights: a chunk beside decode rows, two chunks, a tail
chunk under 16 tokens, decode-only steps, inactive slots, bf16, fp8 and
int8 pools, a prefix-cache fork, a TP=2 instance on a repeated CPU
device and the MoE smoke configuration.  On one device the padded
forward writes the same pool bytes and gives the same logits (every op
computes a row the same way in either layout); the TP=2 instance sums
its shards' partial products in another order than one device does, so
its logits and pool lie within f32 1e-4 of the padded forward's.  The
JAX engine's logits lie within the parity tests' tolerance (f32 1e-4;
bf16 2e-2 + 2**-7 of the expected value, as the kernels' bf16 bound).
Then the row ladder's contract.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores
import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.engine import BatchItem as JItem  # noqa: E402
from repro.engine import InstanceEngine as JEngine  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.engine import BatchItem, InstanceEngine  # noqa: E402
from repro_torch.engine.runner import (  # noqa: E402
    bucket_ladder, bucket_of, row_ladder, rung_chunk,
)
from repro_torch.kernels.ref import as_indexable  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

PAGE = 4
N_SLOTS = 4
MAX_CHUNK = 32                 # row ladder (1, 20, 36, 68, 128)
#: rung 20 takes chunks up to 16, 36 up to 32, 68 and 128 up to 32
CPU2 = ["cpu", "cpu"]

#: steps of (slot, first position, tokens); every item wants logits
MIXED = [[(0, 0, 20), (1, 0, 9), (2, 0, 5)],
         [(0, 20, 1), (1, 9, 1), (2, 5, 1), (3, 0, 32)]]
CASES = {
    "chunk_and_decodes": dict(steps=MIXED),
    "two_chunks": dict(steps=[[(0, 0, 12)],
                              [(0, 12, 1), (1, 0, 32), (2, 0, 30)]]),
    "tail_chunk": dict(steps=[[(0, 0, 20), (1, 0, 10)],
                              [(0, 20, 1), (1, 10, 1), (2, 0, 7)]]),
    "decode_only": dict(steps=[[(0, 0, 20), (2, 0, 9)],
                               [(0, 20, 1), (2, 9, 1)],
                               [(2, 10, 1), (0, 21, 1)]]),
    "inactive_slots": dict(steps=[[(3, 0, 13)], [(3, 13, 1), (1, 0, 6)]]),
    "bf16_pool": dict(dtype="bfloat16", prec="bf16", steps=MIXED),
    "fp8_pool": dict(dtype="bfloat16", prec="fp8", steps=MIXED),
    "int8_pool": dict(dtype="bfloat16", prec="int8", steps=MIXED),
    # slot 1 shares slot 0's first 14 tokens: its first write lands in
    # the shared fourth page, which the engine forks (copy-on-write)
    "prefix_fork": dict(prefix=True, steps=[
        [(0, 0, 16)], ("fork", 0, 1, 14),
        [(0, 16, 1), (1, 14, 6), (2, 0, 9)]]),
    "tp2": dict(devices=CPU2, steps=MIXED),
    "moe": dict(arch="qwen3-moe-30b-a3b", steps=MIXED),
}
_W = {}


def _weights(arch, dtype):
    if (arch, dtype) not in _W:
        jcfg = jax_smoke_config(arch).with_(dtype=dtype)
        cfg = get_smoke_config(arch).with_(dtype=dtype)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        _W[arch, dtype] = (jcfg, jp, cfg, params_from_jax(
            jax.tree.map(np.asarray, jp), cfg, device="cpu"))
    return _W[arch, dtype]


def _raw(t):
    t = t.contiguous()
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _padded_step(eng, cache, step, seq):
    """``step`` through ``forward`` in the (n_slots, T) layout on
    ``cache``, over the block tables the packed step grew: (B, vocab)."""
    T = bucket_of(max(n for _, _, n in step), eng.chunk_buckets)
    B = eng.n_slots
    tokens = torch.zeros((B, T), dtype=torch.int32)
    pos, n_valid = torch.zeros(B, dtype=torch.long), torch.zeros(
        B, dtype=torch.long)
    for s, p, n in step:
        tokens[s, :n] = torch.from_numpy(seq[s, p:p + n])
        pos[s], n_valid[s] = p, n
    n_pp = bucket_of(max(1, eng.allocator.max_table_len), eng.page_buckets)
    with torch.no_grad():
        logits, _, _ = tmodel.forward(
            eng.params, eng.cfg, tokens, cache=cache, pos_offset=pos,
            active=n_valid > 0, n_valid=n_valid, last_only=True,
            block_tables=torch.from_numpy(eng.allocator.table_array(n_pp)),
            page_size=PAGE)
    return logits[:, 0].float().numpy()


def _rung(n_slots, max_chunk, rows, longest):
    """The rung a step of ``rows`` tokens whose longest item has
    ``longest`` lands on: 1 for a decode-only step, else the least rung
    that holds the rows and whose chunk holds the item."""
    if longest == 1:
        return 1
    return min(r for r in row_ladder(n_slots, max_chunk)[1:]
               if r >= rows and rung_chunk(r, n_slots, max_chunk) >= longest)


def _close(got, exp, dtype):
    exp = np.asarray(exp, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-4)
    else:
        assert float((np.abs(got - exp) - 2 ** -7 * np.abs(exp)).max()) \
            <= 2e-2


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_step_equals_the_padded_forward_and_jax(case):
    spec = CASES[case]
    arch = spec.get("arch", "qwen2.5-14b")
    dtype = spec.get("dtype", "float32")
    jcfg, jp, cfg, params = _weights(arch, dtype)
    kw = dict(n_slots=N_SLOTS, max_len=96, page_size=PAGE,
              max_chunk=MAX_CHUNK, kv_precision=spec.get("prec", "bf16"),
              prefix_cache=spec.get("prefix", False))
    eng = InstanceEngine(cfg, params, devices=spec.get("devices"), **kw)
    ref = JEngine(jcfg, jp, **kw)
    pool = tmodel.init_paged_cache(cfg, eng.n_pages, PAGE,
                                   kv_precision=eng.kv_precision,
                                   device="cpu")
    forks = []
    apply_forks = eng._apply_forks

    def mirrored(pairs):               # the same copies in the padded pool
        forks.extend(pairs)
        apply_forks(pairs)
        for blk in pool["blocks"]:
            for t in blk.values():
                raw = as_indexable(t)
                for old, new in pairs:
                    raw[:, new] = raw[:, old]

    eng._apply_forks = mirrored
    seq = np.random.default_rng(len(case)).integers(
        0, cfg.vocab_size, (N_SLOTS, 96)).astype(np.int32)
    if spec.get("prefix"):
        seq[1, :16] = seq[0, :16]
    for e in (eng, ref):
        for i in range(N_SLOTS):
            e.alloc(f"r{i}")
    try:
        for step in spec["steps"]:
            if step[0] == "fork":
                _, src, dst, n = step
                for e in (eng, ref):
                    e.remember(src, seq[src, :16])
                    e.allocator.splice(dst, e.allocator.pages_of(src)[
                        :-(-n // PAGE)], n)
                continue
            rows = sum(n for _, _, n in step)
            before = eng.rows_computed
            got = eng.run_batch([BatchItem(s, seq[s, p:p + n], p, True)
                                 for s, p, n in step])
            exp = ref.run_batch([JItem(s, seq[s, p:p + n], p, True)
                                 for s, p, n in step])
            padded = _padded_step(eng, pool, step, seq)
            rung = _rung(N_SLOTS, MAX_CHUNK, rows,
                         max(n for _, _, n in step))
            assert eng.rows_computed - before == (
                N_SLOTS if rung == 1 else rung)
            assert sorted(got) == sorted(s for s, _, _ in step)
            for s in got:
                if eng.tp == 1:
                    assert np.array_equal(got[s], padded[s]), (step, s)
                else:
                    _close(got[s], padded[s], dtype)
                _close(got[s], exp[s], dtype)
            for i, blk in enumerate(pool["blocks"]):
                for key, t in blk.items():
                    parts = [c["blocks"][i][key] for c in eng.caches]
                    mine = (torch.cat(parts, dim=-2) if key.endswith("pages")
                            else parts[0])
                    if eng.tp == 1:
                        assert torch.equal(_raw(mine), _raw(t)), (step, key)
                    else:
                        _close(mine.numpy(), t.numpy(), dtype)
    finally:
        eng.close()
    assert bool(forks) == bool(spec.get("prefix"))
    eng.check_invariants()


# ---------------------------------------------------------------------------
# the row ladder
# ---------------------------------------------------------------------------
LADDERS = [(8, 512), (8, 64), (4, 32), (2, 16), (1, 128), (8, 8), (16, 256)]


@pytest.mark.parametrize("n_slots,max_chunk", LADDERS)
def test_every_batch_finds_a_rung_and_a_chunk_lands_on_its_own(n_slots,
                                                               max_chunk):
    """Every step up to ``n_slots`` x the chunk ladder's top C finds a
    rung (the top one takes every step: its chunk is C); a rung's chunk
    lies in the chunk ladder and its rows hold a whole chunk beside a
    decode row of every other slot; a power-of-two chunk c >= 16 with up
    to ``n_slots - 1`` decode rows lands on rung c + ``n_slots`` (where
    that lies below the top); the decode-only rung comes first; no ladder
    has more rungs than the chunk ladder the dense engine keys on."""
    rungs = row_ladder(n_slots, max_chunk)
    chunks = bucket_ladder(max_chunk)
    C = chunks[-1]
    top = n_slots * C
    assert rungs[0] == 1 and rungs[-1] == top
    assert list(rungs) == sorted(set(rungs))
    assert len(rungs) <= len(chunks)
    assert rung_chunk(1, n_slots, max_chunk) == 1
    for r in rungs[1:]:
        c = rung_chunk(r, n_slots, max_chunk)
        assert c in chunks and (c + n_slots - 1 <= r or r == top)
    for rows in range(2, top + 1):
        for longest in {2, min(rows, C)}:
            assert _rung(n_slots, max_chunk, rows, longest) >= rows
    for c in chunks:
        if c >= 16 and c + n_slots < top:
            for d in range(n_slots):
                assert _rung(n_slots, max_chunk, c + d, c) == c + n_slots


def test_the_cells_ladder_and_decode_steps_stay_on_rung_one():
    """At 8 slots and 512-token chunks: nine rungs against the chunk
    ladder's ten, a chunk of 512 beside seven decodes on rung 520, and
    ``bucket_of(longest item, eng.buckets)`` (what the card benchmark
    splits steps by) 1 exactly for a decode-only step."""
    assert row_ladder(8, 512) == (1, 24, 40, 72, 136, 264, 520, 1032,
                                  4096)
    _, _, cfg, params = _weights("qwen2.5-14b", "float32")
    eng = InstanceEngine(cfg, params, n_slots=8, max_len=64, page_size=8,
                         max_chunk=512)
    assert eng.buckets == row_ladder(8, 512)
    assert _rung(8, 512, 512 + 7, 512) == 520
    assert eng.rung_chunks[520] == eng.rung_chunks[4096] == 512
    assert bucket_of(1, eng.buckets) == 1
    assert all(bucket_of(n, eng.buckets) > 1 for n in range(2, 513))
    dense = InstanceEngine(cfg, params, n_slots=8, max_len=64,
                           kv_mode="dense", max_chunk=512)
    assert dense.buckets == bucket_ladder(512) == dense.chunk_buckets
    assert eng.packed and not dense.packed


@pytest.mark.parametrize("cf,packed", [(4.0, True), (1.0, False)])
def test_a_mixture_that_can_drop_a_token_keeps_the_padded_step(cf, packed):
    """The MoE smoke configuration (4 experts, top 2) packs its steps at
    capacity factor E / K or more, where no token drops in either
    layout; under it, the pads of a padded step compete for capacity as
    in the reference (``test_torch_moe.py``), so the engine keeps the
    (n_slots, T) step and its T ladder, and computes n_slots x T rows."""
    _, _, cfg, params = _weights("qwen3-moe-30b-a3b", "float32")
    eng = InstanceEngine(cfg.with_(moe_capacity_factor=cf), params,
                         n_slots=N_SLOTS, max_len=64, page_size=PAGE,
                         max_chunk=MAX_CHUNK)
    assert eng.paged and eng.packed == packed
    assert eng.buckets == (row_ladder(N_SLOTS, MAX_CHUNK) if packed
                           else bucket_ladder(MAX_CHUNK))
    slot = eng.alloc("r")
    eng.run_batch([BatchItem(slot, np.arange(5, dtype=np.int32), 0, True)])
    assert eng.rows_computed == (20 if packed else N_SLOTS * 8)
