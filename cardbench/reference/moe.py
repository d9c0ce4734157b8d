"""The mixture-of-experts decoder (``port.arch_type`` "moe"), as
Qwen3-30B-A3B is: the dense kind's attention and norms with a q/k norm,
and a dropless top-k mixture of SwiGLU experts in place of the MLP (the
router's softmax, its k largest renormalised to sum 1).  The mathematics
is ``plain.py``'s."""
from __future__ import annotations

from cardbench.reference import dense

logits_at, kv_at, tree = dense.logits_at, dense.kv_at, dense.tree
page_bytes, model_flops = dense.page_bytes, dense.model_flops


def widths(conf: dict) -> dict:
    w = dense.widths(conf)
    w.update(moe_experts=conf["num_experts"],
             moe_top_k=conf["num_experts_per_tok"],
             moe_d_ff=conf["moe_intermediate_size"],
             moe_capacity_factor=conf["port"]["moe_capacity_factor"])
    return w


def port_fields(w: dict) -> dict:
    return dict(dense.port_fields(w), moe_experts=w["moe_experts"],
                moe_top_k=w["moe_top_k"], moe_d_ff=w["moe_d_ff"],
                moe_capacity_factor=w["moe_capacity_factor"])


def covers(cfg) -> None:
    dense.covers(cfg)
    if cfg.moe_capacity_factor < cfg.moe_experts / cfg.moe_top_k:
        raise ValueError(f"{cfg.name}: capacity factor "
                         f"{cfg.moe_capacity_factor} drops (token, expert) "
                         f"slots, which the dropless reference never does")


def layout(w: dict) -> dense.Layout:
    L, d = w["n_layers"], w["d_model"]
    E, f = w["moe_experts"], w["moe_d_ff"]
    return dense.layout(w, mlp={"router": ((L, d, E), 0.02),
                                "mlp_wi": ((L, E, d, f), d ** -0.5),
                                "mlp_wg": ((L, E, d, f), d ** -0.5),
                                "mlp_wo": ((L, E, f, d), f ** -0.5)})
