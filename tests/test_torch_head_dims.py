"""Head dims beyond 128 and off the powers of two, on the port and on the
JAX package.

The Pallas kernels take the head dim whole, so the JAX package runs any
``hd``; the port's CUDA kernels take every ``hd % 8 == 0`` from 8 to 256
(``repro_torch.kernels.shapes``).  Here, on the CPU:

- the shape rule itself, and both wrappers refusing what it refuses;
- a paged forward (a ragged chunk, then a decode step) and 8 greedy
  engine steps of two configs off the beaten path, against the JAX
  package on converted weights (f32): Nemotron-4-340B's smoke config at
  its real head dim of 192 (4 heads over 2 KV heads; half of each head
  rotary, squared ReLU, LayerNorm) and phi4-mini's smoke config (hd 40).
  Logits agree to 2e-4 of their scale, greedy tokens exactly.

The CUDA kernels at these head dims are held against their plain
versions on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores
import jax.numpy as jnp  # noqa: E402

from repro.engine import BatchItem as JItem  # noqa: E402
from repro.engine import InstanceEngine as JEngine  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.engine import BatchItem, InstanceEngine  # noqa: E402
from repro_torch.kernels import chunked_prefill_attention as cpa  # noqa: E402
from repro_torch.kernels import paged_decode_attention as pda  # noqa: E402
from repro_torch.kernels import shapes  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from test_torch_moe import _weights  # noqa: E402

#: logits agree to this fraction of their largest magnitude (f32, other
#: summation order, through two layers and the head)
SCALE_TOL = 2e-4
PAGE = 8
CASES = {
    # Nemotron-4-340B's head dim at the smoke config's width
    "nemotron-hd192": ("nemotron_4_340b",
                       dict(n_heads=4, n_kv_heads=2, head_dim=192)),
    # phi4-mini's smoke config as it is: d_model 240 over 6 heads
    "phi4-hd40": ("phi4_mini_3_8b", {}),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    arch, overrides = CASES[request.param]
    jcfg, jp, cfg, tp = _weights(arch, **overrides)
    assert cfg.hd == {"nemotron-hd192": 192, "phi4-hd40": 40}[request.param]
    return jcfg, jp, cfg, tp


# ---------------------------------------------------------------------------
# the shape rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd", [8, 16, 32, 40, 64, 96, 128, 136, 192, 200,
                                256])
def test_shape_rule_accepts_every_multiple_of_8_up_to_256(hd):
    assert shapes.supported(hd, 12, 2)
    assert shapes.supported(hd, 96, 8)       # Nemotron-4-340B's heads
    shapes.check(hd, 12, 2, "test")


@pytest.mark.parametrize("hd,H,KV", [
    (0, 4, 2), (4, 4, 2), (12, 4, 2), (100, 4, 2),   # not a multiple of 8
    (264, 4, 2), (512, 4, 2),                         # wider than a warp
    (64, 6, 4), (64, 4, 0), (64, 0, 2),               # no whole GQA groups
])
def test_shape_rule_refuses_the_rest(hd, H, KV):
    assert not shapes.supported(hd, H, KV)
    with pytest.raises(ValueError, match="hd % 8 == 0, 8 <= hd <= 256"):
        shapes.check(hd, H, KV, "test")


@pytest.mark.parametrize("hd", [12, 264])
def test_wrappers_refuse_what_the_rule_refuses(hd):
    """Both CUDA wrappers apply the rule before anything else, so a
    refused head layout raises the rule's ValueError (and counts no
    launch) even where there is no card."""
    before = (pda.launches, cpa.launches)
    q = torch.zeros(1, 4, hd)
    pages = torch.zeros(2, 8, 2, hd)
    with pytest.raises(ValueError, match="8 <= hd <= 256"):
        pda.paged_decode_attention(q, pages, pages,
                                   torch.zeros(1, 2, dtype=torch.int32),
                                   torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="8 <= hd <= 256"):
        cpa.chunked_prefill_attention(torch.zeros(1, 3, 4, hd),
                                      torch.zeros(1, 8, 2, hd),
                                      torch.zeros(1, 8, 2, hd),
                                      torch.zeros(1, dtype=torch.int32))
    assert (pda.launches, cpa.launches) == before


# ---------------------------------------------------------------------------
# the model and the engine at hd 192 and hd 40
# ---------------------------------------------------------------------------
def _close_to_scale(got, exp):
    exp = np.asarray(exp, np.float32)
    got = np.asarray(got, np.float32)
    scale = float(np.abs(exp).max())
    assert float(np.abs(got - exp).max()) <= SCALE_TOL * scale


def test_paged_forward_matches_jax(case):
    """A 12-token chunk on two rows at ragged offsets (row 1 padded past
    ``n_valid``), then a decode step, through the paged pool of both
    packages."""
    jcfg, jp, cfg, tp = case
    B, n_pp = 2, 4
    tbl = (1 + np.arange(B * n_pp, dtype=np.int32)).reshape(B, n_pp)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, 13)).astype(np.int32)
    jcache = jmodel.init_paged_cache(jcfg, 1 + B * n_pp, PAGE)
    tcache = tmodel.init_paged_cache(cfg, 1 + B * n_pp, PAGE, device="cpu")
    steps = [(toks[:, :12], np.array([0, 3], np.int32),
              np.array([12, 9], np.int32)),
             (toks[:, 12:], np.array([12, 12], np.int32), None)]
    for chunk, pos, n_valid in steps:
        jl, jcache, _ = jmodel.forward(
            jp, jcfg, jnp.asarray(chunk), cache=jcache,
            pos_offset=jnp.asarray(pos),
            n_valid=None if n_valid is None else jnp.asarray(n_valid),
            block_tables=jnp.asarray(tbl), page_size=PAGE)
        with torch.no_grad():
            tl, tcache, _ = tmodel.forward(
                tp, cfg, torch.from_numpy(chunk), cache=tcache,
                pos_offset=torch.from_numpy(pos),
                n_valid=None if n_valid is None else torch.from_numpy(n_valid),
                block_tables=torch.from_numpy(tbl), page_size=PAGE)
        assert tl.shape == (B, chunk.shape[1], cfg.vocab_size)
        _close_to_scale(tl.numpy(), jl)


def test_engine_greedy_steps_match_jax(case):
    """Two requests on a paged engine of each package: a prefill of both
    (27 and 40 tokens), then 7 decode steps of both, each step's logits
    within 2e-4 of their scale and every greedy token equal."""
    jcfg, jp, cfg, tp = case
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (27, 40)]
    runs = []
    for eng, item in ((JEngine(jcfg, jp, n_slots=2, max_len=64), JItem),
                      (InstanceEngine(cfg, tp, n_slots=2, max_len=64),
                       BatchItem)):
        assert eng.paged
        slots = [eng.alloc(f"r{i}") for i in range(2)]
        out = eng.run_batch([item(s, p, 0, True)
                             for s, p in zip(slots, prompts)])
        logits = [[np.asarray(out[s]) for s in slots]]
        toks = [[int(np.argmax(out[s]))] for s in slots]
        pos = [len(p) for p in prompts]
        for _ in range(7):
            out = eng.run_batch([
                item(s, np.array([t[-1]], np.int32), n, True)
                for s, t, n in zip(slots, toks, pos)])
            logits.append([np.asarray(out[s]) for s in slots])
            for t, s in zip(toks, slots):
                t.append(int(np.argmax(out[s])))
            pos = [n + 1 for n in pos]
        runs.append((logits, toks))
    (jlog, jtoks), (tlog, ttoks) = runs
    for got, exp in zip(tlog, jlog):
        for g, e in zip(got, exp):
            _close_to_scale(g, e)
    assert ttoks == jtoks
    assert all(len(t) == 8 for t in ttoks)
