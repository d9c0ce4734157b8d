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
