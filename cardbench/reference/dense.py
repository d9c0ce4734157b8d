"""The dense decoder (``port.arch_type`` "dense"), as Qwen2.5 is: GQA
attention with whole RoPE, a qkv bias or a q/k norm where the file says
so, a SwiGLU MLP, RMSNorm at eps 1e-6, an untied output head.  The
mathematics is ``plain.py``'s."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cardbench.reference import plain
from cardbench.yardstick import model_flops  # noqa: F401  (the kind's)

logits_at = plain.logits_at
kv_at = plain.kv_at

#: stacked leaf -> (shape after the layer axis, or None for a leaf
#: without one; what its std is; 1 + N(0, 0.1^2) when "scale")
Layout = Dict[str, Tuple[tuple, object]]


def widths(conf: dict) -> dict:
    """The sizes under the names the weights, the yardstick and the
    reference use, from the published keys of a configuration file."""
    port = conf["port"]
    H = conf["num_attention_heads"]
    if conf["rms_norm_eps"] != plain.EPS:
        raise ValueError(f"RMSNorm eps {conf['rms_norm_eps']}: the port and "
                         f"this reference use {plain.EPS}")
    return {
        "n_layers": conf["num_hidden_layers"],
        "d_model": conf["hidden_size"],
        "n_heads": H,
        "n_kv_heads": conf["num_key_value_heads"],
        "head_dim": conf.get("head_dim", conf["hidden_size"] // H),
        "d_ff": conf["intermediate_size"],
        "vocab_size": conf["vocab_size"],
        "rope_theta": conf["rope_theta"],
        "rms_norm_eps": conf["rms_norm_eps"],
        "qkv_bias": port["qkv_bias"],
        "qk_norm": port["qk_norm"],
        "moe_experts": 0,
        "dtype": conf["torch_dtype"],
    }


def port_fields(w: dict) -> dict:
    return dict(n_layers=w["n_layers"], d_model=w["d_model"],
                n_heads=w["n_heads"], n_kv_heads=w["n_kv_heads"],
                head_dim=w["head_dim"], d_ff=w["d_ff"],
                vocab_size=w["vocab_size"], rope_theta=w["rope_theta"],
                qkv_bias=w["qkv_bias"], qk_norm=w["qk_norm"],
                dtype=w["dtype"])


def covers(cfg) -> None:
    if (cfg.mlp != "swiglu" or cfg.norm != "rmsnorm" or cfg.tie_embeddings
            or cfg.layer_pattern != ("attn",) or cfg.rope_fraction != 1.0
            or cfg.pos_embedding != "rope"):
        raise ValueError(f"{cfg.name}: this reference covers full-attention "
                         f"decoders with SwiGLU, RMSNorm, whole RoPE and an "
                         f"untied head only")


def layout(w: dict, mlp: Optional[Layout] = None) -> Layout:
    """Every stack, in draw order; ``mlp`` in place of the SwiGLU leaves.
    Dense leaves are N(0, 1/fan_in); embed, lm_head and a router N(0,
    0.02^2); biases N(0, 0.1^2); norm scales 1 + N(0, 0.1^2)."""
    L, d, hd = w["n_layers"], w["d_model"], w["head_dim"]
    H, KV, V = w["n_heads"], w["n_kv_heads"], w["vocab_size"]
    out: Layout = {
        "wq": ((L, d, H * hd), d ** -0.5),
        "wk": ((L, d, KV * hd), d ** -0.5),
        "wv": ((L, d, KV * hd), d ** -0.5),
        "wo": ((L, H * hd, d), (H * hd) ** -0.5),
        "norm1": ((L, d), "scale"),
        "norm2": ((L, d), "scale"),
    }
    if w["qkv_bias"]:
        out.update(bq=((L, H * hd), 0.1), bk=((L, KV * hd), 0.1),
                   bv=((L, KV * hd), 0.1))
    if w["qk_norm"]:
        out.update(q_norm=((L, hd), "scale"), k_norm=((L, hd), "scale"))
    f = w.get("d_ff")
    out.update(mlp or {"mlp_wi": ((L, d, f), d ** -0.5),
                       "mlp_wg": ((L, d, f), d ** -0.5),
                       "mlp_wo": ((L, f, d), f ** -0.5)})
    out.update(embed=((V, d), 0.02), final_norm=((d,), "scale"),
               lm_head=((d, V), 0.02))
    return out


def tree(stacks: Dict[str, torch.Tensor]) -> dict:
    """The port's parameter tree over the stacks (views, no copies)."""
    layers = []
    for i in range(stacks["wq"].shape[0]):
        mixer = {k: stacks[k][i] for k in ("wq", "wk", "wv", "wo", "bq", "bk",
                                           "bv", "q_norm", "k_norm")
                 if k in stacks}
        mlp = {k[4:]: stacks[k][i] for k in ("mlp_wi", "mlp_wg", "mlp_wo")}
        if "router" in stacks:
            mlp["router"] = stacks["router"][i]
        layers.append({"norm1": {"scale": stacks["norm1"][i]},
                       "mixer": mixer,
                       "norm2": {"scale": stacks["norm2"][i]}, "mlp": mlp})
    return {"embed": stacks["embed"], "layers": layers,
            "final_norm": {"scale": stacks["final_norm"]},
            "lm_head": stacks["lm_head"]}


def page_bytes(w: dict, page_size: int) -> int:
    """One page of a bf16 pool: K and V of every layer."""
    return 2 * w["n_layers"] * page_size * w["n_kv_heads"] * w["head_dim"] * 2
