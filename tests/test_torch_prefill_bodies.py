"""The prefill kernel's bodies without a card: the numerics of the
3xTF32 body, emulated in torch, and the rule that picks a body
(``kernels.shapes.prefill_body``), whose choice the wrapper passes to the
CUDA entry point."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref, shapes  # noqa: E402

#: the kernels phase's f32 bound (chip_smoke.py TOL["float32"])
F32_TOL = 1e-4
#: what three TF32 passes keep and one pass does not
TF32X3_TOL = 1e-5


def tf32(x):
    """``x`` rounded to the nearest tf32, ties away from zero (the
    kernel's cvt.rna.tf32.f32): add half a tf32 ulp to the bits, clear
    the low 13."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_mm(a, b, passes):
    """a @ b on TF32 operands in f32 accumulation: ``passes`` 1 is hi.hi,
    3 adds the cross terms hi.lo + lo.hi, as the kernel's mma3 does."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def tf32_attention(q, k, v, offsets, passes):
    """Causal GQA prefill as the 3xTF32 body computes it, in f32: S = Q.K^T
    and O = P.V through ``tf32_mm``, scores scaled by 1/sqrt(hd), keys
    past each query's position at -1e30, softmax in f32."""
    B, Tq, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Tq, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]          # (B, KV, 1, hd, S)
    vv = v.permute(0, 2, 1, 3)[:, :, None]          # (B, KV, 1, S, hd)
    scores = tf32_mm(qg, kt, passes) / math.sqrt(hd)
    qpos = offsets.long()[:, None] + torch.arange(Tq)[None]
    mask = torch.arange(S)[None, None] <= qpos[..., None]      # (B, Tq, S)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, ref.NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = tf32_mm(p, vv, passes)                    # (B, KV, qpk, Tq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, hd)


@pytest.mark.parametrize("hd", [8, 40, 128, 256])
def test_tf32x3_attention_keeps_f32_accuracy(hd):
    """Three TF32 products per f32 product (hi.hi + hi.lo + lo.hi, each
    operand split by round-to-nearest through the int32 view) hold causal
    prefill with ragged offsets to the plain f32 version within the
    kernels phase's f32 bound (1e-4), and within 1e-5; one pass (hi.hi)
    exceeds 1e-5."""
    rng = np.random.default_rng(hd)
    B, Tq, S, H, KV = 3, 48, 160, 4, 2
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((B, Tq, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    offsets = torch.tensor([0, 57, S - Tq], dtype=torch.int32)
    exp = ref.chunked_prefill_attention_ref(q, k, v, offsets)
    err3 = float((tf32_attention(q, k, v, offsets, 3) - exp).abs().max())
    err1 = float((tf32_attention(q, k, v, offsets, 1) - exp).abs().max())
    assert err3 <= F32_TOL
    assert err3 <= TF32X3_TOL, err3
    assert err1 > TF32X3_TOL, err1


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """The bit rounding gives tf32 values (low 13 bits clear), the nearest
    one, ties away from zero, and splits every value exactly in two."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3.0e38, 1e-40], dtype=torch.float32)
    r = tf32(x)
    assert r.tolist()[:4] == [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000).astype(np.float32))
    hi = tf32(y)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool(((y - hi).abs() <= hi.abs() * 2.0 ** -11).all())
    lo = tf32(y - hi)
    assert float(((hi + lo) - y).abs().max()) <= float(
        y.abs().max()) * 2.0 ** -22


QUANT = ("float8_e4m3fn", "int8")

#: (q dtype, pool dtype, scaled, hd) -> body, at representative points
BODY_TABLE = (
    ("bfloat16", "bfloat16", False, 128, "wgmma"),      # the serving path
    ("bfloat16", "bfloat16", False, 192, "wgmma"),      # Nemotron-4-340B
    ("bfloat16", "bfloat16", False, 32, "wgmma"),       # padded to 64
    ("bfloat16", "bfloat16", False, 40, "wgmma"),       # phi4-mini smoke
    ("bfloat16", "bfloat16", False, 200, "wgmma"),      # padded to 256
    ("bfloat16", "float8_e4m3fn", True, 64, "wgmma"),
    ("bfloat16", "int8", True, 256, "wgmma"),
    ("bfloat16", "int8", True, 40, "tf32"),             # 40-byte code rows
    ("bfloat16", "float8_e4m3fn", True, 8, "tf32"),
    ("bfloat16", "float32", False, 128, "mma_sync"),
    ("bfloat16", "bfloat16", True, 32, "mma_sync"),
    ("bfloat16", "bfloat16", True, 96, "tf32"),
    ("bfloat16", "float32", False, 256, "tf32"),
    ("float32", "float32", False, 40, "tf32"),          # phi4-mini smoke
    ("float32", "float32", False, 128, "tf32"),         # 14B card vs CPU
    ("float32", "int8", True, 128, "tf32"),
)


@pytest.mark.parametrize("q_dtype,kv_dtype,scaled,hd,body", BODY_TABLE)
def test_prefill_body_table(q_dtype, kv_dtype, scaled, hd, body):
    """The body named at representative points, by dtype name and by
    torch dtype."""
    assert shapes.prefill_body(q_dtype, kv_dtype, hd, scaled) == body
    assert shapes.prefill_body(getattr(torch, q_dtype),
                               getattr(torch, kv_dtype), hd, scaled) == body


@pytest.mark.parametrize("hd", range(8, 257, 8))
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", *QUANT])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_prefill_body_rule(q_dtype, kv_dtype, scaled, hd):
    """Every call of the prefill kernel takes a tensor-core body with an
    instance for it: f32 queries take 3xTF32; bf16 queries on an unscaled
    bf16 pool take wgmma at every head dim, and on fp8 or int8 codes at
    every hd % 16 == 0; codes at other head dims never take wgmma (a
    tensor map needs 16-byte head strides), nor do f32 pools or scaled
    bf16 pools; mma.sync only over f32 and bf16 pools at its widths."""
    body = shapes.prefill_body(q_dtype, kv_dtype, hd, scaled)
    assert body in shapes.PREFILL_BODIES
    if q_dtype == "float32":
        assert body == "tf32"
    elif kv_dtype == "bfloat16" and not scaled:
        assert body == "wgmma"
    elif kv_dtype in QUANT:
        assert (body == "wgmma") == (hd % 16 == 0)
    else:
        assert body != "wgmma"
    if body == "mma_sync":
        assert kv_dtype in ("float32", "bfloat16")
        assert hd in shapes.MMA_SYNC_HEAD_DIMS


#: (q dtype, pool dtype, scaled, hd, H, KV, page) -> whether the packed
#: step's attention takes the packed-row body
PACKED_TABLE = (
    ("bfloat16", "bfloat16", False, 128, 40, 8, 8, True),     # the cell
    ("bfloat16", "bfloat16", False, 128, 32, 4, 8, True),     # the MoE
    ("bfloat16", "bfloat16", False, 128, 20, 4, 8, True),     # a TP=2 shard
    ("bfloat16", "bfloat16", False, 192, 96, 8, 8, True),     # Nemotron
    ("bfloat16", "bfloat16", False, 32, 8, 2, 8, True),       # smoke, width 64
    ("bfloat16", "bfloat16", False, 40, 24, 8, 16, True),
    ("bfloat16", "bfloat16", False, 192, 96, 8, 128, False),  # page > 64 keys
    ("bfloat16", "bfloat16", False, 128, 40, 8, 4, False),    # page of 4
    ("bfloat16", "bfloat16", False, 256, 16, 1, 8, False),    # width 256
    ("bfloat16", "bfloat16", False, 128, 256, 1, 8, False),   # qpk 256
    ("bfloat16", "float8_e4m3fn", True, 128, 40, 8, 8, False),
    ("bfloat16", "int8", True, 128, 40, 8, 8, False),
    ("bfloat16", "bfloat16", True, 128, 40, 8, 8, False),
    ("float32", "float32", False, 128, 40, 8, 8, False),
    ("float32", "bfloat16", False, 128, 40, 8, 8, False),
)


@pytest.mark.parametrize("q_dtype,kv_dtype,scaled,hd,H,KV,page,packed",
                         PACKED_TABLE)
def test_packed_body_table(q_dtype, kv_dtype, scaled, hd, H, KV, page,
                           packed):
    """The packed-row body takes bf16 queries on an unscaled bf16 pool up
    to hd 192, at pages of 8 to its key tile and up to 128 query heads a
    KV head; quantized pools and f32 queries keep the gather path."""
    assert shapes.packed_body(q_dtype, kv_dtype, hd, H, KV, page,
                              scaled) is packed
    assert shapes.packed_body(getattr(torch, q_dtype),
                              getattr(torch, kv_dtype), hd, H, KV, page,
                              scaled) is packed
    if packed:
        assert shapes.prefill_body(q_dtype, kv_dtype, hd, scaled) == "wgmma"
