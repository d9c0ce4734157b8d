"""The yardstick's counts against hand counts."""
import pytest

from cardbench import yardstick as y


def test_bound_takes_the_larger_term():
    assert y.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert y.bound_s(0, 989e12) == pytest.approx(1.0)
    assert y.bound_s(3.35e9, 989e9) == pytest.approx(1e-3)


def test_decode_call_hand_count():
    # two rows fed at positions 9 and 15: contexts 10 and 16 keys;
    # H 4, KV 2, hd 8, page 8 -> pages 2 + 2
    b, f = y.decode_attention_call([(1, 9), (1, 15)], 4, 2, 8, 8)
    assert b == 2 * 2 * 4 * 8 * 2 + 2 * 26 * 2 * 8 * 2 + 4 * 4 + 2 * 4
    assert f == 4 * 26 * 4 * 8


def test_prefill_call_hand_count():
    # a chunk of 3 at offset 5 sees 6 + 7 + 8 keys, a decode row at 9 sees
    # 10: 31 visible; keys read 8 + 10
    b, f = y.prefill_attention_call([(3, 5), (1, 9)], 4, 2, 8)
    assert f == 4 * 31 * 4 * 8
    assert b == 2 * 4 * 4 * 8 * 2 + 2 * 18 * 2 * 8 * 2 + 2 * 4


def test_model_flops_hand_count():
    w = {"d_model": 16, "head_dim": 4, "n_heads": 4, "n_kv_heads": 2,
         "n_layers": 3, "d_ff": 32, "vocab_size": 50}
    proj = 16 * 16 * 2 + 16 * 8 * 2        # q, o; k, v
    mlp = 3 * 16 * 32
    # 2 tokens at offset 1 (visible 2 + 3) with logits, 1 at 7 without
    want = 3 * (2 * 2 * (proj + mlp) + 4 * 5 * 16) + 2 * 16 * 50 \
        + 3 * (2 * 1 * (proj + mlp) + 4 * 8 * 16)
    assert y.model_flops(w, [(2, 1, True), (1, 7, False)]) == want
    moe = dict(w, moe_experts=8, moe_top_k=2, moe_d_ff=8)
    per = 2 * 3 * 16 * 8 + 16 * 8          # two experts and the router
    assert y.model_flops(moe, [(1, 0, False)]) == \
        3 * (2 * (proj + per) + 4 * 16)
