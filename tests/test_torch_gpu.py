"""Tests that need a CUDA card: the hand-written kernels against their
plain versions, and the engine on the card against the engine on the CPU.

Every test here carries the ``gpu`` marker and skips without a card; the
check happens inside a fixture, so every pytest worker collects the same
tests.  The file imports nothing of JAX, so it also runs on a machine
that has only PyTorch:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built by nvcc and "
                    "run only on the GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("H,KV,hd,dtype", [
    (40, 8, 128, "bfloat16"),     # Qwen2.5-14B (qpk 5)
    (12, 2, 40, "bfloat16"),      # phi4-mini's smoke config
    (96, 8, 192, "bfloat16"),     # Nemotron-4-340B (qpk 12)
    (8, 2, 256, "bfloat16"),      # the widest row the kernels take
    (40, 8, 128, "float32"),      # the 14B's f32 card-vs-CPU layout
    (12, 2, 40, "float32"),       # phi4-mini's smoke config as it runs
])
@pytest.mark.parametrize("prec", [None, "fp8", "int8"])
def test_cuda_kernels_match_plain_versions(cuda_device, prec, H, KV, hd,
                                           dtype):
    """Both CUDA kernels against their plain versions on the card, bf16
    and f32 queries (unquantized pools in the queries' dtype), at six
    head layouts; tolerance 2e-2 for the bf16 rounding of the output on
    unit-scale inputs, 1e-4 for f32 decode and 3e-5 for f32 prefill (the
    3xTF32 body keeps about 21 bits a product; one TF32 pass errs by 5e-4
    or more here).  Prefill takes the body that
    ``shapes.prefill_body`` names: bf16 queries on bf16, fp8 and int8
    pools take wgmma at every width but fp8 and int8 at hd 40 (3xTF32:
    no 16-byte head stride for a tensor map), f32 queries take 3xTF32."""
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import shapes
    g = torch.Generator(device=cuda_device).manual_seed(0)
    B, page, n_pp = 4, 8, 16
    dt = getattr(torch, dtype)
    tol, prefill_tol = (2e-2, 2e-2) if dtype == "bfloat16" else (1e-4, 3e-5)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    def kv(x):
        return (x.to(dt), None) if prec is None else \
            ops.quantize_kv(x, prec)

    q = randn(B, H, hd).to(dt)
    kp, ks = kv(randn(B * n_pp, page, KV, hd))
    vp, vs = kv(randn(B * n_pp, page, KV, hd))
    tbl = torch.randperm(B * n_pp, device=cuda_device).reshape(B, n_pp).int()
    lens = torch.tensor([1, 9, 64, 128], dtype=torch.int32,
                        device=cuda_device)
    got = pda.paged_decode_attention(q, kp, vp, tbl, lens, ks, vs)
    exp = ref.paged_decode_attention_ref(q, kp, vp, tbl, lens, ks, vs)
    torch.cuda.synchronize()
    assert float((got.float() - exp.float()).abs().max()) < tol
    Tq, S = 40, 128
    qc = randn(B, Tq, H, hd).to(dt)
    k, kcs = kv(randn(B, S, KV, hd))
    v, vcs = kv(randn(B, S, KV, hd))
    off = torch.tensor([0, 7, 50, 88], dtype=torch.int32, device=cuda_device)
    before = dict(cpa.body_launches)
    got = cpa.chunked_prefill_attention(qc, k, v, off, kcs, vcs)
    exp = ref.chunked_prefill_attention_ref(qc, k, v, off, kcs, vcs)
    torch.cuda.synchronize()
    assert float((got.float() - exp.float()).abs().max()) < prefill_tol
    body = shapes.prefill_body(qc.dtype, k.dtype, hd, kcs is not None)
    assert body == ("tf32" if dtype == "float32" or (prec and hd % 16)
                    else "wgmma")
    assert cpa.body_launches[body] == before[body] + 1


@pytest.mark.parametrize("prec", [None, "fp8", "int8"])
@pytest.mark.parametrize("hd", [40, 96, 200])
def test_chunked_prefill_padded_width_reads_its_own_head(cuda_device, hd,
                                                         prec):
    """At a head dim below its instance width (40 -> 64, 96 -> 128, 200 ->
    256) a row must be read at its true extent and head stride.  q, k and
    v are row views of buffers laid out (B, rows, 2, heads, hd) whose
    second half of every row (the head after each valid one, with one KV
    head) and whose rows past Tq and S hold NaN (int8: the extreme code):
    the output is finite and equals the plain version's on the views."""
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels.ref import as_indexable
    g = torch.Generator(device=cuda_device).manual_seed(3)
    B, Tq, S, H, KV, pad = 2, 130, 300, 2, 1, 24
    bf16 = torch.bfloat16
    qb = torch.randn(B, Tq + pad, 2, H, hd, generator=g,
                     device=cuda_device).to(bf16)
    kb, ks = _pool(torch.randn(B, S + pad, 2, KV, hd, generator=g,
                               device=cuda_device), prec)
    vb, vs = _pool(torch.randn(B, S + pad, 2, KV, hd, generator=g,
                               device=cuda_device), prec)
    if ks is not None:
        ks, vs = ks[:, :S, 0].contiguous(), vs[:, :S, 0].contiguous()
    qb[:, :, 1] = float("nan")
    qb[:, Tq:] = float("nan")
    bad = 127.0 if prec == "int8" else float("nan")
    for t in (kb, vb):
        for rows in ((slice(None), slice(None), 1), (slice(None),
                                                      slice(S, None))):
            as_indexable(t)[rows] = as_indexable(torch.full_like(
                t[rows], bad, dtype=torch.float32).to(t.dtype))
    q, k, v = qb[:, :Tq, 0], kb[:, :S, 0], vb[:, :S, 0]
    off = torch.tensor([170, 0], dtype=torch.int32, device=cuda_device)
    before = dict(cpa.body_launches)
    got = cpa.chunked_prefill_attention(q, k, v, off, ks, vs)
    exp = ref.chunked_prefill_attention_ref(q, k, v, off, ks, vs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    diff = (got.float() - exp.float()).abs()
    assert float((diff - 2 ** -7 * exp.float().abs()).max()) <= 2e-2
    body = "wgmma" if prec is None or hd % 16 == 0 else "tf32"
    assert cpa.body_launches[body] == before[body] + 1


def _pool(x, prec):
    return (x.to(torch.bfloat16), None) if prec is None else \
        ops.quantize_kv(x, prec)


#: The packed-row body against the plain version, per slot, elementwise:
#: |got - expected| <= PACKED_ULP * (max |expected| of the slot + |expected|).
#: Both round their f32 result to bf16, so where the two straddle a
#: rounding boundary they land one bf16 ulp apart, and one ulp of x is at
#: most 2**-7 |x|: the |expected| term.  The f32 results differ by far
#: less (P rounded to bf16 before P V errs by about 2**-9 of a term, and
#: the terms' errors average out over the keys), so the slot's own scale
#: bounds them with room: the max term, one ulp of the slot's largest
#: output.  A slot's outputs are about sqrt(e / keys) here (0.02 to 0.05
#: for 1,000 to 8,000 keys), so the bound is about 1e-3 to 4e-3, where a
#: unit-scale absolute term would pass a lost page or a misweighted span.
PACKED_ULP = 2 ** -7


def mixed_items(n_pp, n_dec, page=8):
    """A mixed step at the card benchmark's shape: a 512-token chunk at
    offset 1000 in slot 1, then ``n_dec`` decode rows of other slots at
    long contexts spread up to the table's end: (slot, first position,
    tokens) a slot."""
    S = n_pp * page
    return [(1, 1000, 512)] + [
        (b, S // 2 + (S // 2 - 1) * i // max(1, n_dec - 1), 1)
        for i, b in enumerate([0] + list(range(2, 2 + n_dec - 1)))]


def packed_problem(device, H, KV, hd, n_pp, items, N=520, page=8, B=8,
                   seed=0):
    """A packed step's rows: ``items`` (slot, first position, tokens)
    packed in slot order from row 0 into ``N`` rows (pads at the end; the
    other slots inactive), over bf16 pools of random pages named by
    permuted block tables.  Returns q, the pools, the tables, the (4, B)
    per-slot arrays, the items in row order and the rows they fill."""
    g = torch.Generator(device=device).manual_seed(seed)
    n_pages = B * n_pp + 1
    kp = torch.randn(n_pages, page, KV, hd, generator=g,
                     device=device).to(torch.bfloat16)
    vp = torch.randn(n_pages, page, KV, hd, generator=g,
                     device=device).to(torch.bfloat16)
    tbl = torch.randperm(B * n_pp, generator=torch.Generator().manual_seed(
        seed)).reshape(B, n_pp).to(torch.int32).to(device)
    q = torch.randn(N, H, hd, generator=g, device=device).to(torch.bfloat16)
    slots = torch.zeros(4, B, dtype=torch.int32)
    r = 0
    for b, off, n in sorted(items):
        slots[:, b] = torch.tensor([off, n, 1, r + n - 1])
        r += n
    return q, kp, vp, tbl, slots.to(device), sorted(items), r


def packed_errors(got, q, kp, vp, tbl, items):
    """Each slot's (largest |got - expected|, largest share of its
    ``PACKED_ULP`` bound) against the plain version of its attention: its
    rows as a chunk over its gathered pages; ``items`` in row order."""
    out, r = [], 0
    for b, off, n in items:
        k, v = (ops.gather_pages(t, tbl[b:b + 1]) for t in (kp, vp))
        exp = ref.chunked_prefill_attention_ref(
            q[None, r:r + n], k, v,
            torch.tensor([off], device=q.device)).float()
        diff = (got[None, r:r + n].float() - exp).abs()
        lim = PACKED_ULP * (exp.abs().max() + exp.abs())
        out.append((float(diff.max()), float((diff / lim).max())))
        r += n
    return out


@pytest.mark.parametrize("H,KV,hd,n_pp,n_dec", [
    (40, 8, 128, 512, 1),      # the cell: Qwen2.5-14B, 4096-token tables
    (40, 8, 128, 512, 7),
    (40, 8, 128, 1024, 3),     # 8192-token tables
    (40, 8, 128, 1024, 7),
    (32, 4, 128, 512, 3),      # Qwen3-30B-A3B
    (20, 4, 128, 512, 3),      # a TP=2 shard of the 14B
    (96, 8, 192, 256, 2),      # Nemotron-4-340B: width 192, 64-key tiles
    (8, 2, 32, 256, 2),        # the smoke configs in bf16: width 64
])
def test_packed_prefill_body_matches_plain_version(cuda_device, H, KV, hd,
                                                   n_pp, n_dec):
    """The packed-row body against the plain version of each slot's
    attention (its rows as a chunk over its gathered pages) on the card,
    one 512-token chunk beside ``n_dec`` long-context decode rows (split
    into key spans and merged), within ``PACKED_ULP`` of the slot's
    largest output plus one bf16 ulp of each.  Pad rows are zeros; one
    launch counted under the ``packed`` body and none under the
    others."""
    from repro_torch.kernels import chunked_prefill_attention as cpa
    q, kp, vp, tbl, slots, items, rows = packed_problem(
        cuda_device, H, KV, hd, n_pp, mixed_items(n_pp, n_dec))
    before = dict(cpa.body_launches)
    got = cpa.packed_prefill_attention(q, kp, vp, tbl, slots)
    torch.cuda.synchronize()
    assert {b: n - before[b] for b, n in cpa.body_launches.items()} == {
        **dict.fromkeys(cpa.BODIES, 0), "packed": 1}
    assert bool(torch.isfinite(got).all())
    assert not bool(got[rows:].any())
    errs = packed_errors(got, q, kp, vp, tbl, items)
    assert all(share <= 1.0 for _, share in errs), errs


def test_packed_mixed_steps_launch_the_packed_body_and_gather_nothing(
        cuda_device, monkeypatch):
    """A bf16 engine on a bf16 pool: a prefill and a mixed step (a chunk
    beside decode rows) each launch the packed-row body once a layer, the
    (slots, chunk) path never (no ``gather_pages``, no other prefill
    body), and the decode-only step the paged-decode kernel alone.  The
    steps' logits lie within 4 bf16 steps of the largest logit of an
    engine that takes the scatter path on the same weights: the two
    attentions' outputs differ by single bf16 roundings, which the
    layers' bf16 products carry to the logits, as the full-width model
    check in ``chip_smoke.py`` counts them (``MODEL_TOL``, 3.2 steps)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.engine import InstanceEngine
    from repro_torch.kernels import shapes
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.models.model import init_params
    cfg = get_smoke_config("qwen2.5-14b").with_(dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), device=cuda_device)
    kw = dict(n_slots=4, max_len=256, max_chunk=64, kv_mode="paged",
              page_size=8, graphs=False)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 256)).astype(np.int32)
    steps = [[(0, 0, 64)], [(0, 64, 1), (1, 0, 50), (2, 0, 9)],
             [(0, 65, 1), (1, 50, 1), (2, 9, 1)]]
    gathers = []
    real_gather = ops.gather_pages

    def counted(*a, **k):
        gathers.append(1)
        return real_gather(*a, **k)

    monkeypatch.setattr(ops, "gather_pages", counted)
    eng = InstanceEngine(cfg, params, **kw)
    for i in range(3):
        eng.alloc(f"r{i}")
    got, deltas = [], []
    for spans in steps:
        before = launch_counts()
        got.append(eng.run_batch(_items(toks, spans)))
        deltas.append({k: n - before[k] for k, n in launch_counts().items()
                       if n != before[k]})
    L = cfg.n_layers
    assert deltas[:2] == [{"chunked_prefill_attention": L,
                           "chunked_prefill_attention/packed": L}] * 2
    assert deltas[2] == {"paged_decode_attention": L}
    assert not gathers
    monkeypatch.setattr(shapes, "packed_body", lambda *a: False)
    eng = InstanceEngine(cfg, params, **kw)
    for i in range(3):
        eng.alloc(f"r{i}")
    for spans, out in zip(steps, got):
        exp = eng.run_batch(_items(toks, spans))
        for s in exp:
            step = 2.0 ** (np.floor(np.log2(np.abs(exp[s]).max())) - 7)
            err = float(np.abs(out[s] - exp[s]).max())
            assert err <= 4 * step, (s, err / step)
    assert gathers


@pytest.mark.parametrize("prec", [None, "fp8", "int8"])
def test_split_kv_decode_edges(cuda_device, prec):
    """Split-KV decode at the serve phase's table width (512 pages of 8;
    spans of 256 tokens): lengths 1, page-1, SPLIT-1, SPLIT, SPLIT+1 and
    the whole table beside two padded inactive slots (length 1, table
    entry 0), within 2e-2 of the plain version; then garbage in the pages
    past each length, inside the last live span, changes no bit."""
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels.ref import as_indexable
    g = torch.Generator(device=cuda_device).manual_seed(1)
    B, H, KV, hd, page, n_pp, split = 8, 40, 8, 128, 8, 512, 256
    q = torch.randn(B, H, hd, generator=g, device=cuda_device).to(
        torch.bfloat16)
    kp, ks = _pool(torch.randn(B * n_pp, page, KV, hd, generator=g,
                               device=cuda_device), prec)
    vp, vs = _pool(torch.randn(B * n_pp, page, KV, hd, generator=g,
                               device=cuda_device), prec)
    tbl = torch.randperm(B * n_pp, device=cuda_device).reshape(B, n_pp).int()
    tbl[6:] = 0
    lens = torch.tensor([1, page - 1, split - 1, split, split + 1,
                         page * n_pp, 1, 1], dtype=torch.int32,
                        device=cuda_device)
    got = pda.paged_decode_attention(q, kp, vp, tbl, lens, ks, vs)
    exp = ref.paged_decode_attention_ref(q, kp, vp, tbl, lens, ks, vs)
    torch.cuda.synchronize()
    assert float((got.float() - exp.float()).abs().max()) < 2e-2
    # poison every page row past each length of rows 0-5; page 0, whose
    # first row the padded slots read, is left alone
    pos = torch.arange(n_pp * page, device=cuda_device).reshape(n_pp, page)
    dead = torch.zeros(B * n_pp, page, dtype=torch.bool, device=cuda_device)
    for b in range(6):
        dead[tbl[b].long()] |= pos >= lens[b]
    dead[0] = False
    poisoned = []
    for t, val in ((kp, 100.0), (vp, -100.0)):
        bad = torch.full_like(t, val, dtype=torch.float32).to(t.dtype)
        poisoned.append(torch.where(dead[..., None, None], as_indexable(bad),
                                    as_indexable(t)).view(t.dtype))
    kp2, vp2 = poisoned
    ks2 = None if ks is None else torch.where(dead, 1e6, ks)
    vs2 = None if vs is None else torch.where(dead, 1e6, vs)
    dirty = pda.paged_decode_attention(q, kp2, vp2, tbl, lens, ks2, vs2)
    torch.cuda.synchronize()
    assert torch.equal(dirty, got)


@pytest.mark.parametrize("prec", [None, "fp8", "int8"])
@pytest.mark.parametrize("Tq,S,offs", [
    (1, 300, [0, 299]),          # one query row
    (130, 300, [170, 250]),      # two q tiles; S < offset + Tq in row 1
    (512, 4000, [0, 3700]),      # S no tile multiple; 16 trips of the ring
])
def test_chunked_prefill_edges(cuda_device, prec, Tq, S, offs):
    """Chunked prefill at the serve head layout within 2e-2 of the plain
    version, through the wgmma body for bf16, fp8 and int8 pools; then q,
    k, v as row views of buffers that hold NaN (int8: the extreme code)
    past Tq and S give the same bits."""
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels.ref import as_indexable
    g = torch.Generator(device=cuda_device).manual_seed(2)
    B, H, KV, hd, pad = 2, 40, 8, 128, 24
    qb = torch.randn(B, Tq + pad, H, hd, generator=g,
                     device=cuda_device).to(torch.bfloat16)
    kb, ks = _pool(torch.randn(B, S + pad, KV, hd, generator=g,
                               device=cuda_device), prec)
    vb, vs = _pool(torch.randn(B, S + pad, KV, hd, generator=g,
                               device=cuda_device), prec)
    if ks is not None:
        ks, vs = ks[:, :S].contiguous(), vs[:, :S].contiguous()
    off = torch.tensor(offs, dtype=torch.int32, device=cuda_device)
    q, k, v = qb[:, :Tq].clone(), kb[:, :S].clone(), vb[:, :S].clone()
    before = dict(cpa.body_launches)
    got = cpa.chunked_prefill_attention(q, k, v, off, ks, vs)
    exp = ref.chunked_prefill_attention_ref(q, k, v, off, ks, vs)
    torch.cuda.synchronize()
    assert float((got.float() - exp.float()).abs().max()) < 2e-2
    assert cpa.body_launches["wgmma"] == before["wgmma"] + 1
    qb[:, Tq:] = float("nan")
    bad = 127.0 if prec == "int8" else float("nan")
    for t in (kb, vb):
        as_indexable(t)[:, S:] = as_indexable(torch.full_like(
            t[:, S:], bad, dtype=torch.float32).to(t.dtype))
    dirty = cpa.chunked_prefill_attention(qb[:, :Tq], kb[:, :S], vb[:, :S],
                                          off, ks, vs)
    torch.cuda.synchronize()
    assert torch.equal(dirty, got)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen3-moe-30b-a3b",
                                  "grok-1-314b", "nemotron-4-340b",
                                  "chatglm3-6b", "phi4-mini-3.8b"])
def test_engine_on_card_matches_cpu(cuda_device, arch):
    """A smoke config (f32; dense, MoE, LayerNorm with squared ReLU, half
    rotary, phi4-mini's head dim of 40) greedy-decodes the same tokens on
    the card, through both kernels, as on the CPU through their plain
    versions, from the same weights."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.engine import BatchItem, InstanceEngine
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.models.model import init_params
    cfg = get_smoke_config(arch)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 40).astype(np.int32)
    start = (pda.launches, cpa.launches)
    streams = []
    for params in (cpu, to(cpu, cuda_device)):
        eng = InstanceEngine(cfg, params, n_slots=4, max_len=96)
        slot = eng.alloc("r")
        out = eng.run_batch([BatchItem(slot, prompt, 0, want_logits=True)])
        toks, pos = [int(out[slot].argmax())], len(prompt)
        for _ in range(7):
            out = eng.run_batch([BatchItem(
                slot, np.array([toks[-1]], np.int32), pos, want_logits=True)])
            toks.append(int(out[slot].argmax()))
            pos += 1
        streams.append(toks)
    assert streams[0] == streams[1]
    # one prefill step and seven decode steps, one launch per layer each
    assert (pda.launches - start[0], cpa.launches - start[1]) == \
        (7 * cfg.n_layers, cfg.n_layers)


def test_moe_route_on_card_matches_cpu_with_ties(cuda_device):
    """The MoE routing on the card (CUDA sort, argsort and cummax) makes
    the CPU's decisions, with every token's top-k holding exact ties
    (two pairs of experts share a router column) and slots dropping at a
    small capacity factor."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.layers import moe_fwd, moe_route
    cfg = get_smoke_config("qwen3-moe-30b-a3b").with_(moe_experts=16,
                                                      moe_top_k=4)
    g = torch.Generator().manual_seed(0)
    E, dm, ff = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": 0.3 * torch.randn(dm, E, generator=g),
         "wi": torch.randn(E, dm, ff, generator=g) / dm ** 0.5,
         "wg": torch.randn(E, dm, ff, generator=g) / dm ** 0.5,
         "wo": torch.randn(E, ff, dm, generator=g) / ff ** 0.5}
    p["router"][:, 3] = p["router"][:, 1]
    p["router"][:, 9] = p["router"][:, 8]
    x = torch.randn(4, 64, dm, generator=g)
    pc = {k: v.to(cuda_device) for k, v in p.items()}
    xc = x.to(cuda_device)
    for cf in (cfg.moe_capacity_factor, 0.5):
        exp = moe_route(p, x.reshape(-1, dm), cfg, cf)
        got = moe_route(pc, xc.reshape(-1, dm), cfg, cf)
        for key in ("gate_idx", "pos_in_e", "keep"):
            assert torch.equal(got[key].cpu(), exp[key]), (cf, key)
        y, _ = moe_fwd(p, x, cfg, capacity_factor=cf)
        yc, _ = moe_fwd(pc, xc, cfg, capacity_factor=cf)
        torch.testing.assert_close(yc.cpu(), y, rtol=1e-4, atol=1e-4)
    assert not exp["keep"].all()


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b",
                                  "whisper-large-v3", "internvl2-76b"])
def test_dense_engine_on_card_matches_cpu(cuda_device, arch):
    """A smoke config on the dense slot cache (f32, TF32 off) greedy-decodes
    the same tokens on the card as on the CPU from the same weights,
    through the stub frontend where the model has one, and launches
    neither paged kernel."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.engine import BatchItem, InstanceEngine
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.models.model import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
    kw = {}
    if cfg.arch_type == "vlm":
        kw["extra_embeds"] = (0.02 * rng.standard_normal(
            (cfg.num_patches, cfg.d_model))).astype(np.float32)
    if cfg.arch_type == "audio":
        kw["frames"] = (0.02 * rng.standard_normal(
            (cfg.encoder_len, cfg.d_model))).astype(np.float32)
    start = (pda.launches, cpa.launches)
    streams = []
    for params in (cpu, _to(cpu, cuda_device)):
        eng = InstanceEngine(cfg, params, n_slots=4, max_len=128)
        assert not eng.paged
        slot = eng.alloc("r")
        if kw:
            first = eng.run_frontend(slot, tokens=prompt, **kw)
        else:
            first = eng.run_batch([BatchItem(slot, prompt, 0, True)])[slot]
        toks = [int(first.argmax())]
        pos = len(prompt) + (cfg.num_patches if "extra_embeds" in kw else 0)
        for _ in range(7):
            out = eng.run_batch([BatchItem(
                slot, np.array([toks[-1]], np.int32), pos, want_logits=True)])
            toks.append(int(out[slot].argmax()))
            pos += 1
        streams.append(toks)
    assert streams[0] == streams[1]
    assert (pda.launches, cpa.launches) == start


def test_ring_write_past_the_window_on_card_matches_cpu(cuda_device):
    """A 64-token chunk into recurrentgemma's 32-slot ring writes two
    positions to every slot; the card keeps the last valid writer, as the
    CPU does, on every row (one of them padded to 45 tokens): positions
    equal exactly, K/V and states to f32 tolerance, 20 times over (a
    nondeterministic duplicate write would differ on some run)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import forward, init_cache, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("recurrentgemma-9b")
    cpu = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    gpu = _to(cpu, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 64)))
    n_valid = torch.tensor([64, 45, 64, 33])

    def run(params, dev):
        cache = init_cache(cfg, 4, 96, device=dev)
        with torch.no_grad():
            logits, cache, _ = forward(
                params, cfg, toks.to(dev), cache=cache,
                pos_offset=torch.zeros(4, dtype=torch.long, device=dev),
                n_valid=n_valid.to(dev), last_only=True)
        return logits.cpu(), _to(cache, "cpu")

    exp_logits, exp = run(cpu, "cpu")
    ring = exp["blocks"][2]
    assert ring["k"].shape[2] == cfg.window == 32
    assert sorted(ring["pos"][0, 1].tolist()) == list(range(13, 45))
    for _ in range(20):
        logits, got = run(gpu, cuda_device)
        torch.testing.assert_close(logits, exp_logits, rtol=1e-4, atol=1e-4)
        assert torch.equal(got["blocks"][2]["pos"], ring["pos"])
        for a, b in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(exp)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen3-moe-30b-a3b",
                                  "mamba2-780m"])
def test_train_step_on_card_matches_cpu(cuda_device, arch):
    """One smoke-size train step (remat on) on the card against the CPU in
    f32 with TF32 off, from the same weights and batch: loss, lr and grad
    norm to 1e-4 relative, the moments to 1e-4 of each leaf's largest
    magnitude, the params to 3e-3 absolute (the reference's microbatch
    bound: Adam's first step turns gradient differences near eps into
    updates of up to lr)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import token_batches
    from repro_torch.models.model import init_params
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.utils.tree import tree_items, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = tree_map(lambda t: t.to(cuda_device, copy=True), cpu)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    batch = next(token_batches(cfg, 4, 32, seed=2))
    step = make_train_step(cfg, opt_cfg)
    got = step(gpu, adamw_init(gpu, opt_cfg), batch)
    exp = step(cpu, adamw_init(cpu, opt_cfg), batch)
    for k in ("loss", "lr", "grad_norm"):
        assert abs(float(got[2][k]) - float(exp[2][k])) <= \
            1e-4 * abs(float(exp[2][k])), k
    for which, rtol, atol in ((0, 0.0, 3e-3), (1, 1e-4, 0.0)):
        e = dict(tree_items(exp[which]))
        for key, a in tree_items(got[which]):
            b = e[key].float()
            bound = atol + rtol * float(b.abs().max())
            assert float((a.cpu().float() - b).abs().max()) <= bound, key


def test_moe_remat_recompute_routes_as_first_forward(cuda_device):
    """A bf16 MoE train step on the card with remat: the recompute in the
    backward pass routes every token as the first forward did (top-k
    experts and capacity ranks equal), and its gradients equal the
    no-remat step's to 1e-2 of each leaf's largest magnitude (bf16 grads;
    a token routed elsewhere moves its grads by O(1))."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import token_batches
    from repro_torch.models import layers
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.training.train import batch_to_device
    from repro_torch.utils.tree import tree_items, tree_leaves, tree_unflatten
    cfg = get_smoke_config("qwen3-moe-30b-a3b").with_(dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), device=cuda_device)
    batch = batch_to_device(next(token_batches(cfg, 4, 64, seed=3)),
                            cuda_device)
    route = layers.moe_route
    seen = []

    def recording(*args, **kwargs):
        r = route(*args, **kwargs)
        seen.append((r["gate_idx"].clone(), r["pos_in_e"].clone()))
        return r

    grads = {}
    layers.moe_route = recording
    try:
        for remat in (False, True):
            seen.clear()
            leaves = [p.detach().requires_grad_() for p in
                      tree_leaves(params)]
            loss, _ = loss_fn(tree_unflatten(params, leaves), cfg, batch,
                              remat=remat)
            grads[remat] = torch.autograd.grad(loss, leaves)
            calls = list(seen)
    finally:
        layers.moe_route = route
    # with remat each layer routes twice: in the forward, then in its
    # recompute, which the backward pass reaches last layer first
    n = cfg.n_layers
    assert len(calls) == 2 * n
    for (gi, pe), (gi2, pe2) in zip(calls[:n], calls[n:][::-1]):
        assert torch.equal(gi, gi2) and torch.equal(pe, pe2)
    for (key, _), a, b in zip(tree_items(params), grads[True], grads[False]):
        assert a.dtype == b.dtype == torch.bfloat16
        bound = 1e-2 * float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= bound, key


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen3-moe-30b-a3b"])
def test_tp2_engine_on_card_matches_cpu(cuda_device, arch):
    """A TP=2 instance (EP=2 on the MoE config) whose two shards
    time-share the card greedy-decodes, in f32 through both kernels at
    the shards' head counts, the tokens of the one-device engine on the
    CPU from the same weights, with first logits within 1e-4 of their
    scale; each shard launches the kernels once a layer a step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.engine import BatchItem, InstanceEngine
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.models.model import init_params
    cfg = get_smoke_config(arch)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 40).astype(np.int32)
    start = (pda.launches, cpa.launches)
    runs = []
    for params, devices in ((cpu, None),
                            (_to(cpu, cuda_device), [cuda_device] * 2)):
        eng = InstanceEngine(cfg, params, n_slots=4, max_len=96,
                             devices=devices)
        slot = eng.alloc("r")
        out = eng.run_batch([BatchItem(slot, prompt, 0, want_logits=True)])
        first = out[slot]
        toks, pos = [int(first.argmax())], len(prompt)
        for _ in range(7):
            out = eng.run_batch([BatchItem(
                slot, np.array([toks[-1]], np.int32), pos, want_logits=True)])
            toks.append(int(out[slot].argmax()))
            pos += 1
        runs.append((toks, first))
    (want, ref_logits), (got, logits) = runs
    assert got == want
    assert np.abs(logits - ref_logits).max() <= \
        1e-4 * np.abs(ref_logits).max()
    assert (pda.launches - start[0], cpa.launches - start[1]) == \
        (2 * 7 * cfg.n_layers, 2 * cfg.n_layers)


def test_ep2_moe_routing_on_card_equals_ep1(cuda_device):
    """The expert-parallel ``moe_fwd`` on two shards of the card makes,
    on every shard, the routing decisions of the unsharded one on the
    card (ties and drops included), and sums to its output."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers
    from repro_torch.models.tp import ShardGroup
    from repro_torch.utils.sharding import shard_params
    cfg = get_smoke_config("qwen3-moe-30b-a3b").with_(moe_experts=16,
                                                      moe_top_k=4)
    g = torch.Generator().manual_seed(1)
    E, dm, ff = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": 0.3 * torch.randn(dm, E, generator=g),
         "wi": torch.randn(E, dm, ff, generator=g) / dm ** 0.5,
         "wg": torch.randn(E, dm, ff, generator=g) / dm ** 0.5,
         "wo": torch.randn(E, ff, dm, generator=g) / ff ** 0.5}
    p["router"][:, 3] = p["router"][:, 1]
    p = {k: v.to(cuda_device) for k, v in p.items()}
    x = torch.randn(4, 64, dm, generator=g).to(cuda_device)
    specs = {"router": None, "wi": -3, "wg": -3, "wo": -3}
    route = layers.moe_route
    for cf in (cfg.moe_capacity_factor, 0.5):
        seen = []

        def watched(*a, **kw):
            r = route(*a, **kw)
            seen.append(r)
            return r

        y, _ = layers.moe_fwd(p, x, cfg, capacity_factor=cf)
        group = ShardGroup(2)
        layers.moe_route = watched
        try:
            outs = group.run(lambda r: layers.moe_fwd(
                shard_params(p, specs, 2, r, cuda_device), x, cfg,
                capacity_factor=cf))
        finally:
            layers.moe_route = route
            group.close()
        exp = route(p, x.reshape(-1, dm), cfg, cf)
        assert len(seen) == 2
        for r in seen:
            for key in ("gate_idx", "pos_in_e", "keep"):
                assert torch.equal(r[key], exp[key]), (cf, key)
        for yc, _ in outs:
            torch.testing.assert_close(yc, y, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the compiled step: one CUDA graph per (T, n_pp) key
# ---------------------------------------------------------------------------
GRAPH_CASES = [("qwen2.5-14b", "bf16"), ("qwen2.5-14b", "fp8"),
               ("qwen2.5-14b", "int8"), ("recurrentgemma-9b", None),
               ("mamba2-780m", None)]
#: sharded engines whose two shards share the card: TP=2 on a bf16 pool
#: and on the dense cache, EP=2 on a bf16 pool (sharded pools are bf16)
SHARD_CASES = [("qwen2.5-14b", "bf16"), ("qwen2.5-14b", None),
               ("qwen3-moe-30b-a3b", "bf16")]


def _cases(cases, width=1):
    """``cases`` as (arch, prec, width) params; one-device ids as before."""
    return [pytest.param(a, p, width, id=f"{a}-{p}" + (
        f"-x{width}" if width > 1 else "")) for a, p in cases]


def _graph_pair(arch, prec, device, width=1):
    """An eager and a graphed engine of ``arch``'s smoke config in bf16 on
    one set of weights (``width`` shards sharing the card), four slots
    allocated on each."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.engine import InstanceEngine
    from repro_torch.models.model import init_params
    cfg = get_smoke_config(arch).with_(dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    kw = dict(n_slots=4, max_len=128, max_chunk=64, devices=[device] * width)
    kw.update(dict(kv_mode="paged", page_size=8, kv_precision=prec)
              if prec else dict(kv_mode="dense"))
    engines = (InstanceEngine(cfg, params, graphs=False, **kw),
               InstanceEngine(cfg, params, **kw))
    assert engines[1].graphs and engines[1].tp == width
    for eng in engines:
        for i in range(4):
            eng.alloc(f"r{i}")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 128)).astype(np.int32)
    return cfg, engines, toks


def _items(toks, spans):
    from repro_torch.engine import BatchItem
    return [BatchItem(s, toks[s, p:p + n], p, True) for s, p, n in spans]


#: a prefill in two T buckets, a mixed batch, then decode steps
GRAPH_SPANS = ([[(0, 0, 40)], [(1, 0, 9), (2, 0, 3)],
                [(0, 40, 1), (1, 9, 20), (3, 0, 5)]]
               + [[(0, 41 + i, 1), (1, 29 + i, 1), (2, 3 + i, 1),
                   (3, 5 + i, 1)] for i in range(4)])


def _cache_bytes(eng):
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, path + (i,))
        else:
            out[path] = tree.contiguous().view(torch.uint8).clone()

    walk(eng.caches, ())
    return out


@pytest.mark.parametrize("arch,prec,width",
                         _cases(GRAPH_CASES) + _cases(SHARD_CASES, 2))
def test_graphed_steps_equal_eager_steps(cuda_device, arch, prec, width):
    """The same items through an eager and a graphed engine: bit-equal
    logits and byte-equal caches (every shard's) after every step, the
    same kernel launches counted, one capture per (T, n_pp) key."""
    from repro_torch.kernels.ops import launch_counts
    _, (eager, graphed), toks = _graph_pair(arch, prec, cuda_device, width)
    counts = {}
    for spans in GRAPH_SPANS:
        items = _items(toks, spans)
        outs = []
        for label, eng in (("eager", eager), ("graphed", graphed)):
            before = launch_counts()
            outs.append(eng.run_batch(items))
            for k, n in launch_counts().items():
                counts.setdefault(label, {}).setdefault(k, 0)
                counts[label][k] += n - before[k]
        for s in outs[0]:
            assert np.array_equal(outs[0][s].view(np.uint32),
                                  outs[1][s].view(np.uint32)), (spans, s)
        ce, cg = _cache_bytes(eager), _cache_bytes(graphed)
        for key in ce:
            assert torch.equal(ce[key], cg[key]), (spans, key)
    assert counts["eager"] == counts["graphed"]
    assert graphed.captures == len(graphed._graphs) >= 3
    assert eager.captures == 0


@pytest.mark.parametrize(
    "arch,prec,width",
    _cases([GRAPH_CASES[0], GRAPH_CASES[4]]) + _cases(SHARD_CASES, 2))
def test_two_inflight_handles_of_one_key_keep_their_logits(cuda_device,
                                                           arch, prec,
                                                           width):
    """Two steps of one key dispatched before either is collected (the
    session's dispatch-ahead) each keep their own logits: those the eager
    engine gives the same steps one at a time."""
    from repro_torch.engine.runner import bucket_of
    _, (eager, graphed), toks = _graph_pair(arch, prec, cuda_device, width)
    for spans in GRAPH_SPANS[:3]:
        for eng in (eager, graphed):
            eng.run_batch(_items(toks, spans))
    steps = GRAPH_SPANS[3:5]
    exp = [eager.run_batch(_items(toks, spans)) for spans in steps]
    # capture the decode key first (its warm-up changes no cache byte),
    # so the two dispatches below only replay
    n_pp = (bucket_of(max(1, graphed.allocator.max_table_len),
                      graphed.page_buckets) if graphed.paged else 0)
    graphed._capture(1, n_pp)
    handles = [graphed.dispatch_batch(_items(toks, spans))
               for spans in steps]
    assert graphed.captures == len(graphed._graphs)
    got = [graphed.collect_batch(h) for h in handles]
    for g, e in zip(got, exp):
        for s in e:
            assert np.array_equal(g[s], e[s])
    assert not np.array_equal(got[0][0], got[1][0])


@pytest.mark.parametrize(
    "arch,prec,width",
    _cases([GRAPH_CASES[0], GRAPH_CASES[3]]) + _cases(SHARD_CASES, 2))
def test_dispatch_makes_no_synchronizing_call(cuda_device, arch, prec,
                                              width):
    """With every key captured, ``dispatch_batch`` of a prefill, a mixed
    and a decode step raises nothing under the sync debug mode's
    ``error``, graphed and eager (on any thread: the mode is global)."""
    _, engines, toks = _graph_pair(arch, prec, cuda_device, width)
    pairs = [([[(0, 0, 40)], [(1, 0, 40)]]),
             ([[(0, 40, 1), (2, 0, 20)], [(1, 40, 1), (3, 0, 20)]]),
             ([[(s, 60 + i, 1) for s in range(4)] for i in range(2)])]
    for first, second in pairs:
        for eng in engines:
            eng.run_batch(_items(toks, first))
            torch.cuda.set_sync_debug_mode("error")
            try:
                handle = eng.dispatch_batch(_items(toks, second))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            eng.collect_batch(handle)


@pytest.mark.parametrize("arch,prec,width",
                         _cases(GRAPH_CASES[:1]) + _cases(SHARD_CASES, 2))
def test_a_failed_capture_raises_and_runs_nothing_eager(cuda_device,
                                                        monkeypatch, arch,
                                                        prec, width):
    """A step that cannot be captured raises out of ``dispatch_batch``;
    the engine keeps no graph for the key, runs no eager step in its
    place and counts no launch, and leaves the caller's stream current
    and a sharded engine's group ready: the same step then captures and
    equals the eager engine's."""
    from repro_torch.engine import runner
    from repro_torch.kernels.ops import launch_counts
    _, (eager, graphed), toks = _graph_pair(arch, prec, cuda_device, width)
    stream = torch.cuda.current_stream()
    counts = launch_counts()
    real = runner.forward

    def unsafe(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            # illegal on a capturing stream, from any thread
            torch.cuda.current_stream().synchronize()
        return real(*a, **kw)

    monkeypatch.setattr(runner, "forward", unsafe)
    with pytest.raises(RuntimeError):
        graphed.run_batch(_items(toks, GRAPH_SPANS[0]))
    assert not graphed._graphs and graphed.iterations == 0
    assert launch_counts() == counts
    assert torch.cuda.current_stream() == stream
    if width > 1:
        assert graphed._group.run(lambda rank: rank) == list(range(width))
    monkeypatch.undo()
    items = _items(toks, GRAPH_SPANS[0])
    got, exp = graphed.run_batch(items), eager.run_batch(items)
    assert graphed.captures == 1
    for s in exp:
        assert np.array_equal(got[s].view(np.uint32), exp[s].view(np.uint32))


@pytest.mark.parametrize("arch,prec,width", _cases(SHARD_CASES, 2))
def test_a_replayed_sharded_step_takes_no_turn(cuda_device, arch, prec,
                                               width):
    """A graphed sharded engine submits work to its shard threads only to
    capture (an eager warm-up and the capture, each on the capture
    stream): a replayed step runs on the caller's thread alone."""
    _, (_, graphed), toks = _graph_pair(arch, prec, cuda_device, width)
    runs = []
    real = graphed._group.run

    def counted(fn, context=None):
        runs.append(context is not None)
        return real(fn, context)

    graphed._group.run = counted
    for spans in GRAPH_SPANS:
        graphed.run_batch(_items(toks, spans))
    assert len(GRAPH_SPANS) > graphed.captures == len(graphed._graphs) >= 3
    assert runs == [True] * (2 * graphed.captures)
    assert graphed.iterations == len(GRAPH_SPANS)


#: packed steps at 4 slots and 64-token chunks (row ladder 1, 20, 36, 68,
#: 132, 256): a whole chunk (rung 68), two chunks (68), a chunk beside
#: three decode rows (68), a chunk a slot (256), a tail chunk beside two
#: decode rows (20), a decode-only step (rung 1), two chunks of 16 and a
#: decode row (36)
PACKED_SPANS = [[(0, 0, 64)], [(1, 0, 30), (2, 0, 9)],
                [(0, 64, 1), (1, 30, 1), (2, 9, 1), (3, 0, 64)],
                [(0, 65, 40), (1, 31, 40), (2, 10, 40), (3, 64, 40)],
                [(0, 105, 1), (1, 71, 9), (2, 50, 1)],
                [(0, 106, 1), (1, 80, 1), (2, 51, 1), (3, 104, 1)],
                [(0, 107, 16), (1, 81, 16), (3, 105, 1)]]


@pytest.mark.parametrize(
    "arch,prec,width",
    _cases(GRAPH_CASES[:1]) + _cases([SHARD_CASES[0], SHARD_CASES[2]], 2))
def test_setup_keys_cover_every_rung_and_packed_steps_replay_as_eager(
        cuda_device, arch, prec, width):
    """A paged engine's keys are (rung, n_pp): capturing every rung of
    the row ladder at each pages bucket up to 16, as the card benchmark's
    set-up does, takes ``len(buckets)`` x those buckets of keys and
    changes no cache byte; then packed steps of every rung replay those
    graphs, with no capture, bit-equal to the eager engine's steps (every
    shard's cache byte-equal, the same launches)."""
    from repro_torch.kernels.ops import launch_counts
    _, (eager, graphed), toks = _graph_pair(arch, prec, cuda_device, width)
    assert graphed.buckets == (1, 20, 36, 68, 132, 256)
    pages = [n for n in graphed.page_buckets if n <= 16]
    before = _cache_bytes(graphed)
    for n_pp in pages:
        for rung in reversed(graphed.buckets):
            graphed._capture(rung, n_pp)
    torch.cuda.synchronize()
    after = _cache_bytes(graphed)
    assert all(torch.equal(before[k], after[k]) for k in before)
    keys = len(graphed.buckets) * len(pages)
    assert graphed.captures == len(graphed._graphs) == keys
    counts = {}
    for spans in PACKED_SPANS:
        items = _items(toks, spans)
        outs = []
        for label, eng in (("eager", eager), ("graphed", graphed)):
            start = launch_counts()
            outs.append(eng.run_batch(items))
            for k, n in launch_counts().items():
                counts.setdefault(label, {}).setdefault(k, 0)
                counts[label][k] += n - start[k]
        assert sorted(outs[0]) == sorted(s for s, _, _ in spans)
        for s in outs[0]:
            assert np.array_equal(outs[0][s].view(np.uint32),
                                  outs[1][s].view(np.uint32)), (spans, s)
        ce, cg = _cache_bytes(eager), _cache_bytes(graphed)
        for key in ce:
            assert torch.equal(ce[key], cg[key]), (spans, key)
    assert counts["eager"] == counts["graphed"]
    assert graphed.captures == keys and graphed.replays == len(PACKED_SPANS)
    assert graphed.rows_computed == eager.rows_computed == (
        68 * 3 + 256 + 20 + 4 + 36)


def test_handoff_across_widths_into_a_graphed_engine_steps_as_eager(
        cuda_device):
    """TP=2 -> TP=1 -> TP=2: a request exported by a graphed TP=2 engine,
    imported by a one-device engine and exported again, then
    imported by the graphed TP=2 engine and its eager twin: the next step
    of both slots is bit-equal on the two and captures nothing new (the
    import writes the caches in place)."""
    from repro_torch.engine import BatchItem, InstanceEngine
    cfg, (eager, graphed), toks = _graph_pair("qwen2.5-14b", "bf16",
                                              cuda_device, 2)
    one = InstanceEngine(cfg, graphed.params, n_slots=2, max_len=128,
                         max_chunk=64, kv_mode="paged", page_size=8)
    for eng in (eager, graphed):
        eng.run_batch(_items(toks, [(0, 0, 40)]))
        eng.run_batch(_items(toks, [(0, 40, 1)]))
    pieces = graphed.export_state(0, upto=41, chunk=16)
    slot = one.alloc("h")
    one.import_state(slot, pieces)
    back = one.export_state(slot, upto=41, chunk=16)
    captures = graphed.captures
    outs = []
    for eng in (eager, graphed):
        eng.import_state(1, back)
        outs.append(eng.run_batch([BatchItem(s, toks[0, 41:42], 41, True)
                                   for s in (0, 1)]))
    assert graphed.captures == captures
    for s in (0, 1):
        assert np.array_equal(outs[0][s].view(np.uint32),
                              outs[1][s].view(np.uint32)), s
    ce, cg = _cache_bytes(eager), _cache_bytes(graphed)
    for key in ce:
        assert torch.equal(ce[key], cg[key]), key


# ---------------------------------------------------------------------------
# the engine's trace: a step's device time against the profiler's
# ---------------------------------------------------------------------------
def test_traced_device_time_spans_the_steps_work_on_the_card(cuda_device):
    """Qwen2.5-14B at every width and 16 of its 48 layers on a bf16 pool,
    graphed: the same 50 decode steps of 8 rows run traced
    (``repro_torch.utils.trace``), once alone and once under the profiler.
    The steps' ``device_s`` (CUDA events just before the inputs' copy and
    after the logits' clone) time the stream's occupancy, so without the
    profiler they read at least the device's busy time under it (the
    operations' union) and at most a fifth over it: the graph's gaps
    between kernels, and no host launch stall, which the profiler makes
    several times longer and which would read beyond that.  Under the
    profiler, ``device_s`` sums to within 5% of the steps' extents there
    (first device operation's start to last one's end, of the operations
    that start between the step's ``engine.dispatch`` span and the next
    step's: spans and profiler on one clock; the logits' copy to the host,
    after the end event, left out)."""
    from torch.autograd import DeviceType
    from repro_torch.configs import get_config
    from repro_torch.engine import InstanceEngine
    from repro_torch.models.model import init_params
    from repro_torch.utils import trace
    cfg = get_config("qwen2.5-14b").with_(n_layers=16)
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), device=cuda_device)
    eng = InstanceEngine(cfg, params, n_slots=8, kv_mode="paged",
                         page_size=8, n_pages=8 * 64, max_chunk=64)
    assert eng.graphs
    for s in range(8):
        eng.alloc(f"r{s}")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 400)).astype(np.int32)
    for p in range(0, 256, 64):
        eng.run_batch(_items(toks, [(s, p, 64) for s in range(8)]))
    decode = [_items(toks, [(s, 256 + i, 1) for s in range(8)])
              for i in range(53)]
    for items in decode[:3]:          # capture and warm the decode key
        eng.run_batch(items)
    torch.cuda.synchronize()

    def steps():
        records = []
        for items in decode[3:]:
            handle = eng.dispatch_batch(items)
            eng.collect_batch(handle)
            records.append(handle.record)
        torch.cuda.synchronize()
        return records

    trace.enable()
    try:
        alone = steps()
        trace.reset()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            records = steps()
        spans = trace.take()["spans"]
    finally:
        trace.disable()
        trace.reset()
    for rs in (alone, records):
        assert len(rs) == 50 and not any(r["captured"] for r in rs)
    ops = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                 for ev in prof.profiler.kineto_results.events()
                 if ev.device_type() == DeviceType.CUDA
                 and "DtoH" not in ev.name())
    starts = sorted(sp[2] for sp in spans if sp[1] == "engine.dispatch")
    assert len(starts) == 50
    bounds = starts[1:] + [ops[-1][0] + 1]
    extent = 0
    for a, b in zip(starts, bounds):
        mine = [op for op in ops if a <= op[0] < b]
        assert mine, "a step with no device operation"
        extent += max(e for _, e in mine) - mine[0][0]
    busy, end = 0, None
    for a, b in ops:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    device = sum(r["device_s"] for r in records)
    assert device == pytest.approx(extent * 1e-9, rel=0.05), (device, extent)
    ratio = sum(r["device_s"] for r in alone) / (busy * 1e-9)
    print(f"device_s alone / busy under the profiler {ratio:.4f}; under "
          f"the profiler / its extents {device / (extent * 1e-9):.4f}")
    assert 1.0 <= ratio <= 1.2, ratio
