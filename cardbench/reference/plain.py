"""The plain reference: Qwen2-style dense and Qwen3-MoE decoders in float32
PyTorch, one layer at a time, over whole sequences.

It imports nothing of the program.  It reads the benchmark's weights (the
bf16 tensors every run draws from its seed) and converts one layer at a
time to float32, so a float32 copy of the whole model is never held.
Each sequence runs from its first token with full causal attention, no
cache, no padding, no batching across sequences.

The mathematics, per layer (x the residual stream):
    h = RMSNorm(x) * scale1
    q, k, v = h Wq + bq, h Wk + bk, h Wv + bv      (biases: Qwen2 only)
    q, k = RMSNorm_head(q) * qn, RMSNorm_head(k) * kn   (Qwen3 only)
    q, k = RoPE(q), RoPE(k)          (theta from the configuration)
    x = x + softmax(q k^T / sqrt(hd), causal) v Wo   (GQA: a KV head
                                                    serves H/KV queries)
    h = RMSNorm(x) * scale2
    dense: x = x + (silu(h Wg) * (h Wi)) Wo
    MoE:   p = softmax(h Wr); the 8 largest p (ties to the lower expert),
           renormalised to sum 1; x = x + sum_e p_e (silu(h Wg_e) *
           (h Wi_e)) Wo_e over the chosen experts, every one of them
           (dropless)
    logits = (RMSNorm(x) * scale_f) W_head
RMSNorm's eps is 1e-6 (both published configurations).

Departures from the published models, each shared with the program:
RoPE rotates interleaved pairs (x[0::2], x[1::2]), where the published
code rotates halves; with random weights the two differ only by a fixed
permutation of each head's q and k columns, so agreement is unaffected.

``kv_at`` gives the first layer's keys and values, which the check holds
a served request's cache against.

``precision="fp8"`` is the control: every matrix product's operands are
rounded to float8 e4m3 (activations with a scale a row, weights with a
scale an output column) before a float32 product, the step below the
configuration's bfloat16 that a later change might be tempted to take.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

EPS = 1e-6
FP8_MAX = 448.0


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32 (``"f32"``) or on float8-rounded operands."""
    if precision == "fp8":
        return _fp8(a, -1) @ _fp8(b, -2)
    return a @ b


def rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (N, heads, hd) at positions 0..N-1, interleaved pairs."""
    N, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                         dtype=torch.float64) / hd)
    ang = torch.arange(N, device=x.device, dtype=torch.float64)[:, None] * freqs
    s = torch.sin(ang).float()[:, None, :]
    c = torch.cos(ang).float()[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], -1).reshape(x.shape)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              block: int = 1024) -> torch.Tensor:
    """Causal GQA over one sequence, in blocks of ``block`` queries.
    q: (N, H, hd); k, v: (N, KV, hd) -> (N, H * hd)."""
    N, H, hd = q.shape
    KV = k.shape[1]
    g = H // KV
    kh = k.permute(1, 2, 0)                      # (KV, hd, N)
    vh = v.permute(1, 0, 2)                      # (KV, N, hd)
    out = torch.empty(N, H, hd, device=q.device, dtype=torch.float32)
    for lo in range(0, N, block):
        hi = min(N, lo + block)
        qb = q[lo:hi].reshape(hi - lo, KV, g, hd).permute(1, 2, 0, 3)
        s = (qb.reshape(KV, g * (hi - lo), hd) @ kh[:, :, :hi]) / hd ** 0.5
        s = s.reshape(KV, g, hi - lo, hi)
        mask = torch.arange(hi, device=q.device)[None] > \
            torch.arange(lo, hi, device=q.device)[:, None]
        s.masked_fill_(mask, float("-inf"))
        p = torch.softmax(s, dim=-1).reshape(KV, g * (hi - lo), hi)
        o = (p @ vh[:, :hi]).reshape(KV, g, hi - lo, hd)
        out[lo:hi] = o.permute(2, 0, 1, 3).reshape(hi - lo, H, hd)
    return out.reshape(N, H * hd)


def moe(h: torch.Tensor, p: Dict[str, torch.Tensor], w: dict,
        precision: str, stats: Optional[dict] = None) -> torch.Tensor:
    """The dropless top-k mixture over the rows of h: (S, d).  ``stats``
    counts the routing decisions and the near-ties among them: a last
    chosen and first unchosen router logit less than a bfloat16 step
    (2**-7 of their size) apart, which a bfloat16 product can swap."""
    logits = matmul(h, p["router"], precision)
    K = w["moe_top_k"]
    if stats is not None:
        top = torch.topk(logits, K + 1, dim=-1).values
        edge = top[:, K - 1].abs().clamp(min=1e-30)
        near = (top[:, K - 1] - top[:, K]) < edge * 2.0 ** -7
        stats["decisions"] = stats.get("decisions", 0) + near.numel()
        stats["near_ties"] = stats.get("near_ties", 0) + int(near.sum())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :K], top_e[:, :K]
    top_w = top_w / top_w.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in torch.unique(top_e).tolist():
        rows, slot = torch.nonzero(top_e == e, as_tuple=True)
        x = h[rows]
        wi, wg, wo = (p[k][e].float() for k in ("wi", "wg", "wo"))
        a = torch.nn.functional.silu(matmul(x, wg, precision)) \
            * matmul(x, wi, precision)
        y.index_add_(0, rows, matmul(a, wo, precision)
                     * top_w[rows, slot, None])
    return y


def _f32(tree):
    """A layer's leaves in float32, but for expert stacks (3-D), which
    ``moe`` converts one expert at a time."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree if tree.dim() == 3 else tree.float()


def qkv(x: torch.Tensor, lp: dict, w: dict, precision: str):
    """A layer's queries, keys and values over one sequence x: (N, d),
    float32, after the norms and RoPE: (N, H, hd), (N, KV, hd) twice."""
    N = x.shape[0]
    H, KV, hd = w["n_heads"], w["n_kv_heads"], w["head_dim"]
    m = lp["mixer"]
    h = rms(x, lp["norm1"]["scale"])
    q, k, v = (matmul(h, m[n], precision) for n in ("wq", "wk", "wv"))
    if w["qkv_bias"]:
        q, k, v = q + m["bq"], k + m["bk"], v + m["bv"]
    q, k, v = q.reshape(N, H, hd), k.reshape(N, KV, hd), v.reshape(N, KV, hd)
    if w["qk_norm"]:
        q, k = rms(q, m["q_norm"]), rms(k, m["k_norm"])
    return rope(q, w["rope_theta"]), rope(k, w["rope_theta"]), v


def layer(x: torch.Tensor, lp: dict, w: dict, precision: str,
          stats: Optional[dict] = None) -> torch.Tensor:
    """One decoder layer over one sequence x: (N, d), float32."""
    q, k, v = qkv(x, lp, w, precision)
    m = lp["mixer"]
    x = x + matmul(attention(q, k, v), m["wo"], precision)
    h = rms(x, lp["norm2"]["scale"])
    if w["moe_experts"]:
        return x + moe(h, lp["mlp"], w, precision, stats)
    p = lp["mlp"]
    a = torch.nn.functional.silu(matmul(h, p["wg"], precision)) \
        * matmul(h, p["wi"], precision)
    return x + matmul(a, p["wo"], precision)


@torch.no_grad()
def logits_at(params: dict, w: dict, seqs: Sequence[torch.Tensor],
              rows: Sequence[torch.Tensor], precision: str = "f32",
              vocab_block: int = 32768,
              stats: Optional[dict] = None) -> List[torch.Tensor]:
    """The float32 logits of each sequence (int64 token ids) at the given
    positions: ``rows[i]`` indexes ``seqs[i]``.  Layer by layer over all
    sequences, each layer's weights converted to float32 only while it
    runs."""
    _no_tf32()
    xs = [params["embed"][s].float() for s in seqs]
    for lp in params["layers"]:
        lp32 = _f32(lp)
        xs = [layer(x, lp32, w, precision, stats) for x in xs]
        del lp32
    scale = params["final_norm"]["scale"].float()
    head = params["lm_head"]
    out = []
    for x, r in zip(xs, rows):
        h = rms(x[r], scale)
        parts = [matmul(h, head[:, lo:lo + vocab_block].float(), precision)
                 for lo in range(0, head.shape[1], vocab_block)]
        out.append(torch.cat(parts, dim=1))
    return out


@torch.no_grad()
def kv_at(params: dict, w: dict,
          seqs: Sequence[torch.Tensor]) -> List[tuple]:
    """The first layer's float32 keys (after RoPE) and values of each
    sequence (int64 token ids) at every position: (N, KV, hd) each.  What
    a cache holds for that layer, before any rounding to its storage."""
    _no_tf32()
    lp = _f32(params["layers"][0])
    return [qkv(params["embed"][s].float(), lp, w, "f32")[1:] for s in seqs]
