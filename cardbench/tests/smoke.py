"""A cell at smoke size for the CPU tests: the published configuration's
keys with its widths cut, the BurstGPT mix at short lengths."""
import copy
import json

from cardbench import spec
from cardbench.traffic import generate

SMALL = dict(num_hidden_layers=2, hidden_size=256, num_attention_heads=8,
             num_key_value_heads=2, intermediate_size=512, vocab_size=512,
             torch_dtype="float32")
MOE = dict(head_dim=32, num_experts=8, num_experts_per_tok=2,
           moe_intermediate_size=128)


def conf(name: str, dtype: str = "float32") -> dict:
    with open(spec.HERE / "configs" / f"{name}.json") as f:
        c = json.load(f)
    c.update(SMALL, torch_dtype=dtype)
    if c["port"]["arch_type"] == "moe":
        c.update(MOE)
        c["port"]["moe_capacity_factor"] = MOE["num_experts"] / \
            MOE["num_experts_per_tok"]
    return c


def mix() -> dict:
    m = copy.deepcopy(generate.load_mix("burstgpt"))
    m.update(prompt={"median": 96, "sigma": 0.45, "min": 8, "max": 512},
             output={"median": 96, "sigma": 0.5, "min": 32, "max": 256},
             max_context=1024)
    return m


RATE = {"rate_per_s": 2.0, "preroll_s": 2.0, "preroll_rate_per_s": 2.0,
        "warm_requests": 4, "warm_graph_pages": [1, 64]}
