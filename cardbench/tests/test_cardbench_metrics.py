"""The window's arithmetic on synthetic token timelines."""
import pytest

from cardbench.record import (ReqLog, Window, failed, gaps, percentile,
                              queue_waits, tokens_in, ttfts)
from cardbench import spec


def log(rid, due, tokens, decode_len=None, ttft=0.5, tbt=0.1, **kw):
    g = ReqLog(rid, "window", due, ttft, tbt,
               decode_len if decode_len is not None else len(tokens), **kw)
    g.tokens = list(tokens)
    return g


W0, W1 = 10.0, 20.0


def test_ttft_counts_a_request_with_no_first_token_by_its_wait():
    logs = {"a": log("a", 11.0, [11.4, 11.5]),
            "b": log("b", 18.0, [], decode_len=5),          # waiting at close
            "c": log("c", 19.0, [21.0], decode_len=3),      # first after close
            "d": log("d", 15.0, [], decode_len=2, rejected=True),
            "e": log("e", 9.0, [9.5]),                      # due before
            "f": log("f", 20.0, [20.1])}                    # due at the close
    assert sorted(ttfts(logs, W0, W1)) == pytest.approx([0.4, 1.0, 2.0, 5.0])


def test_gaps_take_the_later_token_in_the_window_and_open_gaps():
    logs = {"a": log("a", 0.0, [9.0, 9.5, 10.2, 10.4], decode_len=4),
            # still streaming: its open gap from 19.0 to the close
            "b": log("b", 0.0, [18.0, 19.0, 20.5], decode_len=10),
            # done before the close: no open gap
            "c": log("c", 0.0, [12.0, 12.3], decode_len=2)}
    assert sorted(gaps(logs, W0, W1)) == pytest.approx(
        sorted([0.7, 0.2, 1.0, 1.0, 0.3]))


def test_tokens_meet_their_class_limits():
    logs = {
        # first token 0.4 after due (ttft 0.5: met), gaps 0.05 (met), 0.2
        "a": log("a", 11.0, [11.4, 11.45, 11.65], ttft=0.5, tbt=0.1),
        # standard class: first token 1.9 s late (met), gap 0.3 (missed)
        "b": log("b", 12.0, [13.9, 14.2], ttft=2.0, tbt=0.25),
        # tokens outside the window count for neither
        "c": log("c", 5.0, [9.9, 20.0, 20.05])}
    n, good = tokens_in(logs, W0, W1)
    assert (n, good) == (5, 3)


def test_queue_wait_and_failed():
    logs = {"a": log("a", 11.0, [12.0], running=11.25),
            "b": log("b", 12.0, [], decode_len=3),
            "c": log("c", 13.0, [14.0, 14.1], decode_len=3, done=14.1,
                     running=13.5),
            "d": log("d", 14.0, [], decode_len=2, rejected=True)}
    assert sorted(queue_waits(logs, W0, W1)) == pytest.approx(
        [0.25, 0.5, 6.0, 8.0])
    assert sorted(failed(logs, W0, W1, {"c": 2, "a": 1})) == ["c", "d"]


def test_percentile_is_numpy_linear():
    assert percentile([1.0, 2.0, 3.0, 4.0], 90) == pytest.approx(3.7)
    assert percentile([], 90) is None


def window(logs, **kw):
    return Window(W0, W1, logs, {"n_layers": 2, "n_heads": 4,
                                 "n_kv_heads": 2, "head_dim": 8,
                                 "d_model": 32, "d_ff": 64,
                                 "vocab_size": 100}, 8, 1.5, 0.25,
                  [{"transfer_exposed": 1.0, "t": W0},
                   {"transfer_exposed": 1.5, "t": W1}], **kw)


def test_end_to_end_readers():
    logs = {"a": log("a", 11.0, [11.4, 11.45, 11.65]),
            "b": log("b", 12.0, [13.9, 14.2], ttft=2.0, tbt=0.25)}
    run = window(logs)
    read = {n: r for n, (r, _) in spec.readers(
        spec.load_benchmark()["end_to_end"]).items()}
    assert read["output_tokens_per_s"](run) == pytest.approx(0.5)
    assert read["goodput_tokens_per_s"](run) == pytest.approx(0.3)
    assert read["setup_s"](run) == 1.5
    assert read["ttft_p90_ms"](run) == pytest.approx(
        percentile([0.4, 1.9], 90) * 1e3)
    assert read["tbt_p99_ms"](run) == pytest.approx(
        percentile([0.05, 0.2, 0.3], 99) * 1e3)


def test_counter_readers():
    from cardbench.probes import Step
    logs = {"a": log("a", 11.0, [11.4], place_s=0.002),
            "b": log("b", 12.0, [12.4], place_s=0.004)}
    logs["a"].handoffs = [11.5, 9.0]
    logs["b"].handoffs = [12.5]
    steps = [Step(12.0, 4, 16, 2, [(3, 0, True), (1, 7, True)], False),
             Step(13.0, 1, 16, 2, [(1, 8, True)], False),
             Step(21.0, 1, 16, 2, [(1, 9, True)], False)]   # after close
    run = window(logs, steps=steps)
    read = {n: r for n, (r, _) in spec.readers(
        spec.load_benchmark()["per_layer"]).items()}
    assert read["sched.place_ms_mean"](run) == pytest.approx(3.0)
    # 0.5 s of exposed transfer over the 2 handoffs begun in the window
    assert read["handoff.exposed_ms_mean"](run) == pytest.approx(250.0)
    # rows 2 x 4 + 2 x 1 = 10, real 3 + 1 + 1 = 5
    assert read["engine.pad_share"](run) == pytest.approx(50.0)
    assert read["engine.capture_s"](run) == 0.25
    for name in ("model.mfu", "kernel.decode_attn_roofline",
                 "kernel.prefill_attn_roofline", "device.idle_share"):
        assert read[name](run) is None     # nothing traced: nothing read
