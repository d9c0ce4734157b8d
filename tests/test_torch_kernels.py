"""The port's attention ops against the JAX package's Pallas kernels.

Inputs are drawn with numpy from a seed and handed to both packages; the
Pallas kernels run in interpret mode on the CPU (as tests/test_kernels.py
runs them) and the port's ops take their plain PyTorch path, because the
tensors lie on the CPU.  The CUDA kernels themselves are held against the
same plain versions on the card (``tests/test_torch_gpu.py`` and
``chip_smoke.py``).

Tolerances: f32 2e-5 (summation order only); bf16 2e-2 (both sides round
the output to bf16, and JAX also runs its einsums in bf16)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
QTOL = {"fp8": 0.15, "int8": 0.04}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype="float32"):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _ints(a):
    a = np.asarray(a, np.int32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got, exp, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


def _quant_pair(jx, tx, prec):
    jc, js = jops.quantize_kv(jx, prec)
    tc, ts = tops.quantize_kv(tx, prec)
    return (jc, js), (tc, ts)


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Tq,S,H,KV,hd", [
    (1, 8, 32, 4, 4, 32),        # MHA
    (2, 24, 64, 8, 2, 64),       # GQA, ragged chunk
    (2, 16, 48, 6, 1, 128),      # MQA, wide head
    (1, 33, 70, 4, 2, 64),       # sizes that are no tile multiple
    (2, 12, 40, 10, 2, 32),      # qpk 5, as Qwen2.5-14B
])
def test_chunked_prefill_matches_pallas(dtype, B, Tq, S, H, KV, hd):
    rng = np.random.default_rng(B * 1000 + Tq + S + H)
    jq, tq = _pair(rng, (B, Tq, H, hd), dtype)
    jk, tk = _pair(rng, (B, S, KV, hd), dtype)
    jv, tv = _pair(rng, (B, S, KV, hd), dtype)
    joff, toff = _ints(rng.integers(0, S - Tq, B))
    exp = jops.chunked_prefill_attention_op(jq, jk, jv, joff, bq=8, bk=16,
                                            interpret=True)
    got = tops.chunked_prefill_attention_op(tq, tk, tv, toff)
    assert got.dtype == TDT[dtype] and got.shape == (B, Tq, H, hd)
    _close(got, exp, TOL[dtype])


def test_chunked_prefill_per_row_ragged_offsets():
    rng = np.random.default_rng(1)
    B, Tq, S, H, hd = 3, 8, 40, 4, 32
    jq, tq = _pair(rng, (B, Tq, H, hd))
    jk, tk = _pair(rng, (B, S, H, hd))
    jv, tv = _pair(rng, (B, S, H, hd))
    joff, toff = _ints([0, 13, 32 - Tq])
    exp = jops.chunked_prefill_attention_op(jq, jk, jv, joff, bq=8, bk=8,
                                            interpret=True)
    _close(tops.chunked_prefill_attention_op(tq, tk, tv, toff), exp, 2e-5)
    _close(tref.chunked_prefill_attention_ref(tq, tk, tv, toff),
           jops.chunked_prefill_attention_ref(jq, jk, jv, joff), 2e-5)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,page,n_pp", [
    (2, 8, 2, 64, 8, 4),
    (3, 4, 4, 32, 16, 2),        # MHA
    (1, 16, 2, 128, 8, 8),       # deep GQA
])
def test_paged_decode_matches_pallas(dtype, B, H, KV, hd, page, n_pp):
    rng = np.random.default_rng(B * 100 + H + page)
    n_pages = B * n_pp + 2
    jq, tq = _pair(rng, (B, H, hd), dtype)
    jk, tk = _pair(rng, (n_pages, page, KV, hd), dtype)
    jv, tv = _pair(rng, (n_pages, page, KV, hd), dtype)
    jt, tt = _ints(rng.permutation(n_pages)[:B * n_pp].reshape(B, n_pp))
    jl, tl = _ints(rng.integers(1, page * n_pp + 1, B))
    exp = jops.paged_decode_attention_op(jq, jk, jv, jt, jl, interpret=True)
    got = tops.paged_decode_attention_op(tq, tk, tv, tt, tl)
    assert got.dtype == TDT[dtype] and got.shape == (B, H, hd)
    _close(got, exp, TOL[dtype])


@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("qpk", [1, 2, 4, 5, 8])
def test_paged_decode_gqa_and_page_size_sweep(qpk, page):
    """Every GQA group size (5 is Qwen2.5-14B's) x page sizes, with one
    sequence of 1 token, one mid-page and one page-aligned."""
    rng = np.random.default_rng(qpk * 100 + page)
    B, KV, hd, n_pp = 3, 2, 64, 3
    H, n_pages = KV * qpk, B * n_pp + 1
    jq, tq = _pair(rng, (B, H, hd))
    jk, tk = _pair(rng, (n_pages, page, KV, hd))
    jv, tv = _pair(rng, (n_pages, page, KV, hd))
    jt, tt = _ints(rng.permutation(n_pages)[:B * n_pp].reshape(B, n_pp))
    jl, tl = _ints([1, page * 2 - 3, page * n_pp])
    exp = jops.paged_decode_attention_op(jq, jk, jv, jt, jl, interpret=True)
    _close(tops.paged_decode_attention_op(tq, tk, tv, tt, tl), exp, 2e-5)


def test_paged_decode_ignores_pages_beyond_length():
    """Garbage in pages past ``length`` must not reach the output."""
    rng = np.random.default_rng(3)
    B, H, KV, hd, page, n_pp = 1, 4, 2, 32, 8, 4
    _, tq = _pair(rng, (B, H, hd))
    _, tk = _pair(rng, (8, page, KV, hd))
    _, tv = _pair(rng, (8, page, KV, hd))
    tbl = torch.arange(n_pp, dtype=torch.int32)[None]
    lens = torch.tensor([11], dtype=torch.int32)
    out1 = tops.paged_decode_attention_op(tq, tk, tv, tbl, lens)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[2:], tv2[2:] = 1e6, -1e6
    tk2[1, 3:], tv2[1, 3:] = 1e6, -1e6       # rows past 11 in page 1
    out2 = tops.paged_decode_attention_op(tq, tk2, tv2, tbl, lens)
    assert torch.equal(out1, out2)


def _split_kv_decode(q, k_pages, v_pages, block_tables, lengths, split):
    """Split-KV decode written out in f32: every span of ``split`` tokens
    gives a partial (m, l, acc) over its live tokens, or the empty
    partial (m = -1e30, l = 0, acc = 0) when it starts at or past the
    length; the merge is M = max m_i, out = sum e^(m_i-M) acc_i /
    max(sum e^(m_i-M) l_i, 1e-30).  The CUDA kernel's split and merge
    passes implement this rule (at 256-token spans)."""
    B, H, hd = q.shape
    _, page, KV, _ = k_pages.shape
    S = block_tables.shape[1] * page
    qpk, n_splits = H // KV, -(-S // split)
    k = k_pages[block_tables.long()].reshape(B, S, KV, hd).float()
    v = v_pages[block_tables.long()].reshape(B, S, KV, hd).float()
    qg = q.float().reshape(B, KV, qpk, hd)
    m = torch.full((B, KV, qpk, n_splits), tref.NEG_INF)
    l = torch.zeros(B, KV, qpk, n_splits)
    acc = torch.zeros(B, KV, qpk, n_splits, hd)
    for b in range(B):
        for i in range(n_splits):
            lo, hi = i * split, min(S, (i + 1) * split, int(lengths[b]))
            if hi <= lo:
                continue
            s = torch.einsum("kgh,skh->kgs", qg[b], k[b, lo:hi]) / hd ** 0.5
            m[b, ..., i] = s.max(-1).values
            p = torch.exp(s - m[b, ..., i, None])
            l[b, ..., i] = p.sum(-1)
            acc[b, ..., i, :] = torch.einsum("kgs,skh->kgh", p, v[b, lo:hi])
    w = torch.exp(m - m.max(-1, keepdim=True).values)
    out = (w[..., None] * acc).sum(-2) / \
        (w * l).sum(-1).clamp_min(1e-30)[..., None]
    return out.reshape(B, H, hd)


@pytest.mark.parametrize("split,page,n_pp,lens", [
    # length 0 (fully masked), 1, page-1, a span ending mid-page,
    # split-1, split, split+1 and the whole table; short rows leave
    # trailing spans empty
    (16, 8, 5, [0, 1, 7, 13, 15, 16, 17, 40]),
    (8, 8, 3, [3, 24, 9]),                 # one page per span
    (12, 4, 10, [0, 5, 11, 12, 13, 40]),   # spans of 3 pages
])
def test_split_kv_decode_merge_rule(split, page, n_pp, lens):
    rng = np.random.default_rng(split * 100 + page + n_pp)
    B, KV, qpk, hd = len(lens), 2, 5, 32
    H, n_pages = KV * qpk, B * n_pp + 1
    jq, tq = _pair(rng, (B, H, hd))
    jk, tk = _pair(rng, (n_pages, page, KV, hd))
    jv, tv = _pair(rng, (n_pages, page, KV, hd))
    jt, tt = _ints(rng.permutation(n_pages)[:B * n_pp].reshape(B, n_pp))
    jl, tl = _ints(lens)
    got = _split_kv_decode(tq, tk, tv, tt, tl, split)
    live = np.asarray(lens) > 0
    # a fully masked row gives 0; the plain versions softmax over all
    # -1e30 scores there (uniform weights), so they are held only to
    # the rows that have tokens
    assert torch.equal(got[~torch.from_numpy(live)],
                       torch.zeros_like(got[~torch.from_numpy(live)]))
    exp_j = np.asarray(jref.paged_decode_attention_ref(jq, jk, jv, jt, jl))
    exp_t = tref.paged_decode_attention_ref(tq, tk, tv, tt, tl)
    np.testing.assert_allclose(got[live].numpy(), exp_j[live],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[live].numpy(), exp_t[live].numpy(),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# paged prefill (gather pages -> chunked prefill)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("page,Tq,ctx", [
    (8, 5, 11),       # ragged chunk, ragged prefix
    (16, 16, 16),     # page-aligned resume
    (32, 9, 0),       # fresh prefill, oversized page
])
def test_paged_prefill_matches_pallas(page, Tq, ctx):
    rng = np.random.default_rng(page + Tq + ctx)
    B, H, KV, hd = 2, 4, 2, 32
    n_pp = -(-(ctx + Tq) // page) + 1
    n_pages = B * n_pp + 1
    jq, tq = _pair(rng, (B, Tq, H, hd))
    jk, tk = _pair(rng, (n_pages, page, KV, hd))
    jv, tv = _pair(rng, (n_pages, page, KV, hd))
    jt, tt = _ints(rng.permutation(n_pages)[:B * n_pp].reshape(B, n_pp))
    joff, toff = _ints([ctx] * B)
    exp = jops.paged_prefill_attention_op(jq, jk, jv, jt, joff,
                                          interpret=True)
    _close(tops.paged_prefill_attention_op(tq, tk, tv, tt, toff), exp, 2e-5)
    # the gather itself is exact
    np.testing.assert_array_equal(tops.gather_pages(tk, tt).numpy(),
                                  np.asarray(jops.gather_pages(jk, jt)))


def test_paged_prefill_unwritten_page_slack_is_masked():
    """Garbage in the unwritten tail of the last page and in sentinel
    table entries (page 0) past the sequence must not leak in."""
    rng = np.random.default_rng(4)
    B, Tq, H, KV, hd, page = 1, 6, 4, 2, 32, 8
    _, tq = _pair(rng, (B, Tq, H, hd))
    _, tk = _pair(rng, (6, page, KV, hd))
    _, tv = _pair(rng, (6, page, KV, hd))
    tbl = torch.tensor([[1, 2, 0]], dtype=torch.int32)
    off = torch.tensor([4], dtype=torch.int32)       # chunk covers [4, 10)
    out1 = tops.paged_prefill_attention_op(tq, tk, tv, tbl, off)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[2, 2:], tv2[2, 2:] = 1e6, -1e6
    tk2[0], tv2[0] = -1e6, 1e6
    out2 = tops.paged_prefill_attention_op(tq, tk2, tv2, tbl, off)
    assert torch.equal(out1, out2)


# ---------------------------------------------------------------------------
# quantized pages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prec", ["fp8", "int8"])
def test_quantize_kv_codes_and_scales_byte_equal(prec):
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng, (5, 16, 2, 64))
    (jc, js), (tc, ts) = _quant_pair(jx * 3.0, tx * 3.0, prec)
    assert tc.dtype == tops.kv_storage_dtype(prec)
    assert ts.dtype == torch.float32 and ts.shape == (5, 16)
    np.testing.assert_array_equal(tc.view(torch.uint8).numpy(),
                                  np.asarray(jc).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tops.dequantize_kv(tc, ts).numpy(),
        np.asarray(jops.dequantize_kv(jc, js)))
    assert float((tops.dequantize_kv(tc, ts) - tx * 3.0).abs().max()) \
        < 3 * QTOL[prec]


@pytest.mark.parametrize("prec", ["fp8", "int8"])
@pytest.mark.parametrize("page,qpk", [(8, 1), (16, 2), (32, 4), (8, 5)])
def test_paged_decode_quantized_matches_pallas(prec, page, qpk):
    rng = np.random.default_rng(page * 10 + qpk)
    B, KV, hd, n_pp = 3, 2, 64, 3
    H, n_pages = KV * qpk, B * n_pp + 1
    jq, tq = _pair(rng, (B, H, hd))
    jk, tk = _pair(rng, (n_pages, page, KV, hd))
    jv, tv = _pair(rng, (n_pages, page, KV, hd))
    jt, tt = _ints(rng.permutation(n_pages)[:B * n_pp].reshape(B, n_pp))
    jl, tl = _ints([1, page * 2 - 3, page * n_pp])
    (jkc, jks), (tkc, tks) = _quant_pair(jk, tk, prec)
    (jvc, jvs), (tvc, tvs) = _quant_pair(jv, tv, prec)
    exp = jops.paged_decode_attention_op(jq, jkc, jvc, jt, jl, jks, jvs,
                                         interpret=True)
    got = tops.paged_decode_attention_op(tq, tkc, tvc, tt, tl, tks, tvs)
    _close(got, exp, 2e-5)
    full = tops.paged_decode_attention_op(tq, tk, tv, tt, tl)
    assert float((got - full).abs().max()) < QTOL[prec]


@pytest.mark.parametrize("prec", ["fp8", "int8"])
@pytest.mark.parametrize("B,Tq,S,KV,qpk", [
    (2, 24, 64, 2, 4),            # GQA, ragged chunk
    (1, 33, 70, 2, 2),            # sizes that are no tile multiple
    (3, 8, 40, 4, 1),             # MHA, per-row ragged offsets
])
def test_chunked_prefill_quantized_matches_pallas(prec, B, Tq, S, KV, qpk):
    rng = np.random.default_rng(B + Tq + S + qpk)
    hd = 64
    jq, tq = _pair(rng, (B, Tq, KV * qpk, hd))
    jk, tk = _pair(rng, (B, S, KV, hd))
    jv, tv = _pair(rng, (B, S, KV, hd))
    joff, toff = _ints(rng.integers(0, S - Tq, B))
    (jkc, jks), (tkc, tks) = _quant_pair(jk, tk, prec)
    (jvc, jvs), (tvc, tvs) = _quant_pair(jv, tv, prec)
    exp = jops.chunked_prefill_attention_op(jq, jkc, jvc, joff, jks, jvs,
                                            bq=8, bk=16, interpret=True)
    got = tops.chunked_prefill_attention_op(tq, tkc, tvc, toff, tks, tvs)
    _close(got, exp, 2e-5)
    full = tops.chunked_prefill_attention_op(tq, tk, tv, toff)
    assert float((got - full).abs().max()) < QTOL[prec]


@pytest.mark.parametrize("prec", ["fp8", "int8"])
def test_paged_prefill_quantized_gathers_scales(prec):
    rng = np.random.default_rng(6)
    B, Tq, ctx, H, KV, hd, page = 2, 5, 11, 4, 2, 32, 8
    n_pp = -(-(ctx + Tq) // page) + 1
    n_pages = B * n_pp + 1
    jq, tq = _pair(rng, (B, Tq, H, hd))
    jk, tk = _pair(rng, (n_pages, page, KV, hd))
    jv, tv = _pair(rng, (n_pages, page, KV, hd))
    jt, tt = _ints(rng.permutation(n_pages)[:B * n_pp].reshape(B, n_pp))
    joff, toff = _ints([ctx] * B)
    (jkc, jks), (tkc, tks) = _quant_pair(jk, tk, prec)
    (jvc, jvs), (tvc, tvs) = _quant_pair(jv, tv, prec)
    exp = jops.paged_prefill_attention_op(jq, jkc, jvc, jt, joff, jks, jvs,
                                          interpret=True)
    got = tops.paged_prefill_attention_op(tq, tkc, tvc, tt, toff, tks, tvs)
    _close(got, exp, 2e-5)
    np.testing.assert_array_equal(tops.gather_scales(tks, tt).numpy(),
                                  np.asarray(jops.gather_scales(jks, jt)))


@pytest.mark.parametrize("prec", ["fp8", "int8"])
def test_paged_decode_quantized_ignores_poison_pages(prec):
    """Garbage codes and garbage scales past ``length`` stay out."""
    rng = np.random.default_rng(7)
    B, H, KV, hd, page, n_pp = 1, 4, 2, 32, 8, 4
    _, tq = _pair(rng, (B, H, hd))
    _, tk = _pair(rng, (8, page, KV, hd))
    _, tv = _pair(rng, (8, page, KV, hd))
    tbl = torch.arange(n_pp, dtype=torch.int32)[None]
    lens = torch.tensor([11], dtype=torch.int32)
    tkc, tks = tops.quantize_kv(tk, prec)
    tvc, tvs = tops.quantize_kv(tv, prec)
    out1 = tops.paged_decode_attention_op(tq, tkc, tvc, tbl, lens, tks, tvs)
    qmax = 127.0 if prec == "int8" else 448.0
    tkc2, tvc2 = tkc.clone(), tvc.clone()
    tkc2[2:] = torch.full_like(tkc2[2:], qmax, dtype=torch.float32).to(
        tkc2.dtype)
    tvc2[2:] = torch.full_like(tvc2[2:], -qmax, dtype=torch.float32).to(
        tvc2.dtype)
    tks2, tvs2 = tks.clone(), tvs.clone()
    tks2[2:], tvs2[2:] = 1e6, 1e6
    out2 = tops.paged_decode_attention_op(tq, tkc2, tvc2, tbl, lens,
                                          tks2, tvs2)
    assert torch.equal(out1, out2)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain path, CUDA tensors the kernel
# ---------------------------------------------------------------------------
def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    """The CUDA wrappers never run the plain version: handed a CPU
    tensor they raise, and their launch counters stay put."""
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels import paged_decode_attention as pda
    before = (pda.launches, cpa.launches)
    q = torch.zeros(1, 4, 32)
    pages = torch.zeros(2, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        pda.paged_decode_attention(q, pages, pages,
                                   torch.zeros(1, 2, dtype=torch.int32),
                                   torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        cpa.chunked_prefill_attention(torch.zeros(1, 3, 4, 32),
                                      torch.zeros(1, 8, 2, 32),
                                      torch.zeros(1, 8, 2, 32),
                                      torch.zeros(1, dtype=torch.int32))
    assert (pda.launches, cpa.launches) == before
    # the op layer sends the same CPU tensors to the plain versions
    out = tops.paged_decode_attention_op(
        q, pages, pages, torch.zeros(1, 2, dtype=torch.int32),
        torch.ones(1, dtype=torch.int32))
    assert out.shape == (1, 4, 32)
    assert (pda.launches, cpa.launches) == before
