"""The generator: one seed, one trace; every seed the same work."""
import numpy as np
import pytest

from cardbench.traffic import generate

MIX = generate.load_mix("burstgpt")
RATE = {"rate_per_s": 0.2, "preroll_s": 10.0, "preroll_rate_per_s": 0.2,
        "warm_requests": 4}


def trace(seed, seconds=51.0, vocab=1000):
    return generate.generate(MIX, RATE, seed, seconds, vocab)


def test_the_same_seed_gives_the_same_trace():
    a, b = trace(2 ** 31 + 11), trace(2 ** 31 + 11)
    assert [(p.rid, p.due, p.decode_len, p.predicted, p.slo) for p in a] == \
        [(p.rid, p.due, p.decode_len, p.predicted, p.slo) for p in b]
    assert any(p.predicted != p.decode_len for p in a)
    assert all(np.array_equal(p.prompt, q.prompt) for p, q in zip(a, b))


@pytest.mark.parametrize("phase,n", [("warm", 4), ("pre", 2), ("window", 10)])
def test_every_seed_gets_the_same_work_in_the_same_order(phase, n):
    a, b = ([p for p in trace(seed) if p.phase == phase]
            for seed in (7, 2 ** 31 + 99))
    assert len(a) == len(b) == n
    assert [(len(p.prompt), p.decode_len, p.due, p.slo, p.predicted)
            for p in a] == \
        [(len(p.prompt), p.decode_len, p.due, p.slo, p.predicted)
         for p in b]
    # the seed draws what the requests say, not how much they ask
    assert not all(np.array_equal(p.prompt, q.prompt) for p, q in zip(a, b))
    if phase != "warm":
        ga = np.diff([p.due for p in a])
        span = generate.exponential_gaps(n, 51.0 if phase == "window"
                                         else 10.0)
        assert set(np.round(ga, 6)) <= set(np.round(span, 6))


def test_phases_fall_in_their_spans():
    ps = trace(3)
    assert all(p.due == 0.0 for p in ps if p.phase == "warm")
    assert all(0.0 <= p.due < 10.0 for p in ps if p.phase == "pre")
    assert all(10.0 <= p.due < 61.0 for p in ps if p.phase == "window")
    assert all(len(p.prompt) + p.decode_len <= MIX["max_context"]
               for p in ps)
    assert all(0 <= p.prompt.min() and p.prompt.max() < 1000 for p in ps)


def test_lengths_are_the_lognormal_quantiles():
    q = generate.lognormal_quantiles(2048, 0.45, 3, 8, 16384)
    assert q[1] == 2048                                  # the median
    assert q[0] < 2048 < q[2] and q[0] * q[2] == pytest.approx(2048 ** 2,
                                                               rel=1e-3)


def test_gaps_sum_to_the_span_and_class_counts_follow_the_mix():
    g = generate.exponential_gaps(10, 51.0)
    assert len(g) == 11 and g.sum() == pytest.approx(51.0)
    assert np.all(np.diff(g) > 0)                        # quantiles rise
    assert sorted(generate.class_counts({"interactive": 0.5,
                                         "standard": 0.5}, 5)).count(
        "interactive") in (2, 3)


def test_warm_requests_carry_the_tokens_they_would_have_made():
    ps = [p for p in trace(5) if p.phase == "warm"]
    # the shares made are the uniform's quantiles (i + 0.5) / n: each
    # request decodes what is left, its prompt holds the rest
    assert all(p.decode_len >= 1 for p in ps)
    assert len({len(p.prompt) for p in ps}) == len(ps)
