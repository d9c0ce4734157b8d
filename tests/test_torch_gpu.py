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


@pytest.mark.parametrize("prec", [None, "fp8", "int8"])
def test_cuda_kernels_match_plain_versions(cuda_device, prec):
    """Both CUDA kernels against their plain versions on the card, at
    Qwen2.5-14B's head layout (qpk 5), bf16 queries; tolerance 2e-2 for
    the bf16 rounding of the output on unit-scale inputs."""
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels import paged_decode_attention as pda
    g = torch.Generator(device=cuda_device).manual_seed(0)
    B, H, KV, hd, page, n_pp = 4, 40, 8, 128, 8, 16
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    def kv(x):
        return (x.to(bf16), None) if prec is None else \
            ops.quantize_kv(x, prec)

    q = randn(B, H, hd).to(bf16)
    kp, ks = kv(randn(B * n_pp, page, KV, hd))
    vp, vs = kv(randn(B * n_pp, page, KV, hd))
    tbl = torch.randperm(B * n_pp, device=cuda_device).reshape(B, n_pp).int()
    lens = torch.tensor([1, 9, 64, 128], dtype=torch.int32,
                        device=cuda_device)
    got = pda.paged_decode_attention(q, kp, vp, tbl, lens, ks, vs)
    exp = ref.paged_decode_attention_ref(q, kp, vp, tbl, lens, ks, vs)
    torch.cuda.synchronize()
    assert float((got.float() - exp.float()).abs().max()) < 2e-2
    Tq, S = 40, 128
    qc = randn(B, Tq, H, hd).to(bf16)
    k, kcs = kv(randn(B, S, KV, hd))
    v, vcs = kv(randn(B, S, KV, hd))
    off = torch.tensor([0, 7, 50, 88], dtype=torch.int32, device=cuda_device)
    got = cpa.chunked_prefill_attention(qc, k, v, off, kcs, vcs)
    exp = ref.chunked_prefill_attention_ref(qc, k, v, off, kcs, vcs)
    torch.cuda.synchronize()
    assert float((got.float() - exp.float()).abs().max()) < 2e-2


def _pool(x, prec):
    return (x.to(torch.bfloat16), None) if prec is None else \
        ops.quantize_kv(x, prec)


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


def test_engine_on_card_matches_cpu(cuda_device):
    """The Qwen2.5-14B smoke config (f32) greedy-decodes the same tokens
    on the card, through both kernels, as on the CPU through their plain
    versions, from the same weights."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.engine import BatchItem, InstanceEngine
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.models.model import init_params
    cfg = get_smoke_config("qwen2.5-14b")
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
