"""The plain reference against the port's forward pass at smoke sizes, in
float32 on the CPU, on the benchmark's own weights."""
import pytest
import torch

from cardbench import reference, spec, weights
from cardbench.reference import plain
from cardbench.tests import smoke


def make(conf, seed):
    kind = reference.of(conf)
    w = kind.widths(conf)
    params, stacks = weights.make(kind.layout(w), kind.tree, seed, "cpu",
                                  dtype=torch.float32)
    return kind, w, params, stacks


def logits_both(name, T=40, seed=3, **port_kw):
    from repro_torch.models.model import forward
    conf = smoke.conf(name)
    kind, w, params, _ = make(conf, seed)
    cfg = spec.model_config(conf).with_(**port_kw)
    toks = torch.randint(0, w["vocab_size"], (T,),
                         generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        port, _, _ = forward(params, cfg, toks[None])
    ref = kind.logits_at(params, w, [toks], [torch.arange(T)])[0]
    return port[0], ref


@pytest.mark.parametrize("name", ["qwen2.5-14b", "qwen3-30b-a3b"])
def test_reference_agrees_with_the_port(name):
    port, ref = logits_both(name)
    assert (port - ref).abs().max() < 1e-4 * max(1.0, ref.abs().max())


def test_the_ports_default_capacity_drops_what_the_reference_keeps():
    """At the port's default capacity factor (1.25) a token's expert
    output depends on what else is in its step: slots over an expert's
    capacity are dropped, which the published, dropless model never
    does.  At num_experts / top_k the two agree (above)."""
    port, ref = logits_both("qwen3-30b-a3b", T=64, moe_capacity_factor=1.25)
    assert (port - ref).abs().max() > 1e-2


def test_the_reference_needs_every_layer():
    kind, w, params, stacks = make(smoke.conf("qwen2.5-14b"), 4)
    toks = torch.arange(12)
    a = plain.logits_at(params, w, [toks], [torch.arange(12)])[0]
    stacks["mlp_wo"][1].zero_()
    b = plain.logits_at(params, w, [toks], [torch.arange(12)])[0]
    assert (a - b).abs().max() > 1e-3


def test_fp8_rounds_the_products():
    a = torch.randn(16, 64, generator=torch.Generator().manual_seed(0))
    b = torch.randn(64, 8, generator=torch.Generator().manual_seed(1))
    exact = plain.matmul(a, b, "f32")
    err = (plain.matmul(a, b, "fp8") - exact).abs().max()
    assert 1e-3 < err < 0.5 * exact.abs().max()


@pytest.mark.parametrize("name", ["qwen2.5-14b", "qwen3-30b-a3b"])
def test_the_first_layers_keys_and_values_are_the_ports(name):
    """``kv_at`` against what the port's forward pass writes into a dense
    cache for the first layer."""
    from repro_torch.models.model import forward, init_cache
    conf = smoke.conf(name)
    kind, w, params, _ = make(conf, 5)
    cfg = spec.model_config(conf)
    T = 24
    toks = torch.randint(0, w["vocab_size"], (T,),
                         generator=torch.Generator().manual_seed(5))
    cache = init_cache(cfg, 1, T, device="cpu")
    with torch.no_grad():
        _, cache, _ = forward(params, cfg, toks[None], cache=cache)
    k, v = kind.kv_at(params, w, [toks])[0]
    blk = cache["blocks"][0]
    for got, want in ((blk["k"][0, 0, :T], k), (blk["v"][0, 0, :T], v)):
        assert (got - want).abs().max() < 1e-4 * want.abs().max()


def test_a_kind_is_found_by_its_name():
    conf = smoke.conf("qwen2.5-14b")
    assert reference.of(conf).__name__ == "cardbench.reference.dense"
    conf["port"]["arch_type"] = "no_such_kind"
    with pytest.raises(SystemExit, match="no_such_kind"):
        reference.of(conf)


def test_a_kind_refuses_what_its_reference_does_not_follow():
    conf = smoke.conf("qwen2.5-14b")
    cfg = spec.model_config(conf)
    with pytest.raises(ValueError, match="SwiGLU"):
        reference.of(conf).covers(cfg.with_(mlp="gelu"))
