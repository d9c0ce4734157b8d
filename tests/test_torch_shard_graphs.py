"""The compiled step of a sharded instance, on the CPU.

An engine captures its step into a CUDA graph only where every shard lies
on one CUDA device (``runner.can_graph``); the capture runs the shard
threads' turns once, each thread on the capture stream, which
``ShardGroup.run`` makes current through a per-shard context.  The rule
is checked on device lists (no card is needed to read them), the
per-shard context on CPU shard groups (sums and gathers in shard order,
errors reaching the caller, the group ready for the next step), and a
sharded CPU engine, which captures nothing, against the JAX
single-device engine on the same converted f32 smoke weights (2e-4, the
tolerance of ``tests/test_sharded.py``; greedy tokens equal).  Graphs
themselves are captured only on a card (``tests/test_torch_gpu.py``).
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores

from repro_torch.engine.runner import can_graph  # noqa: E402
from repro_torch.models import tp  # noqa: E402


# ---------------------------------------------------------------------------
# which engines graph
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("devices,graphs", [
    (["cuda:0", "cuda:0"], True),
    (["cuda:1", "cuda:1", "cuda:1", "cuda:1"], True),
    (["cuda:0"], True),
    (["cuda:0", "cuda:1"], False),
    (["cuda:0", "cuda:0", "cuda:1", "cuda:1"], False),
    (["cpu", "cpu"], False),
    (["cpu"], False),
])
def test_graphs_only_where_every_shard_is_one_card(devices, graphs):
    """One distinct device, and a CUDA one: shards on a repeated card
    graph; distinct cards and the CPU do not."""
    assert can_graph(devices) is graphs
    assert can_graph([torch.device(d) for d in devices]) is graphs


# ---------------------------------------------------------------------------
# the per-shard context of ShardGroup.run
# ---------------------------------------------------------------------------
_mark = threading.local()


class _Marked:
    """A context that sets a thread-local mark on enter, clears it on
    exit, and logs both with the thread it ran on."""

    def __init__(self, rank, log, fail=None):
        self.rank, self.log, self.fail = rank, log, fail

    def __enter__(self):
        self.log.append(("enter", self.rank, threading.current_thread()))
        if self.fail == "enter":
            raise RuntimeError(f"enter {self.rank}")
        _mark.rank = self.rank
        return self

    def __exit__(self, *exc):
        self.log.append(("exit", self.rank, threading.current_thread()))
        _mark.rank = None
        if self.fail == "exit":
            raise RuntimeError(f"exit {self.rank}")
        return False


@pytest.mark.parametrize("n", [2, 3, 4])
def test_per_shard_context_wraps_each_body(n):
    """Each worker enters its own context around its body, on its own
    thread and in its turn; the body sees it; sums, maxima and gathers
    come out as without a context, in shard order; the caller's thread
    enters none."""
    rng = np.random.default_rng(n)
    parts = [torch.from_numpy(rng.standard_normal((3, 5))) for _ in range(n)]
    group = tp.ShardGroup(n)
    log = []

    def body(rank):
        seen = getattr(_mark, "rank", None)
        x = parts[rank]
        return (seen, threading.current_thread(), tp.all_reduce(x),
                tp.all_reduce(x, op="max"), tp.all_gather(x, 0))

    try:
        plain = group.run(body)
        marked = group.run(body, lambda r: _Marked(r, log))
    finally:
        group.close()
    exp_sum = parts[0]
    for p in parts[1:]:
        exp_sum = exp_sum + p
    exp_max = torch.stack(parts).amax(0)
    for rank, (got, ref) in enumerate(zip(marked, plain)):
        assert got[0] == rank and ref[0] is None
        assert got[1] is ref[1] is not threading.current_thread()
        for a, b, e in zip(got[2:], ref[2:],
                           (exp_sum, exp_max, torch.cat(parts, 0))):
            assert torch.equal(a, b) and torch.equal(a, e)
    assert getattr(_mark, "rank", None) is None
    # every shard's enter and exit, on the thread that ran its body, in
    # shard order: a shard's exit precedes the next shard's turn only
    # past its last sum, so the enters come in order
    enters = [(r, t) for kind, r, t in log if kind == "enter"]
    assert [r for r, _ in enters] == list(range(n))
    assert sorted((r, t) for kind, r, t in log if kind == "exit") == \
        sorted(enters)
    assert all(t is marked[r][1] for r, t in enters)


@pytest.mark.parametrize("where", ["enter", "body", "exit"])
@pytest.mark.parametrize("bad", [0, 1, 2])
def test_a_failing_context_or_body_reaches_the_caller(where, bad):
    """A shard's context that raises on enter or exit, or its body, gives
    the caller that shard's own error (not the other shards' aborts); the
    group then runs the next step, context and all."""
    n = 3
    group = tp.ShardGroup(n)
    x = torch.ones(2)
    failing = [True]

    def body(rank):
        y = tp.all_reduce(x * (rank + 1))
        if where == "body" and rank == bad and failing[0]:
            raise ValueError(f"body {rank}")
        return tp.all_reduce(y)

    def context(rank):
        return _Marked(rank, [], where if rank == bad else None)

    try:
        err = ValueError if where == "body" else RuntimeError
        with pytest.raises(err, match=f"{where} {bad}"):
            group.run(body, context)
        failing[0] = False
        out = group.run(body, lambda r: _Marked(r, []))
    finally:
        group.close()
    assert all(torch.equal(o, torch.full((2,), 18.0)) for o in out)


# ---------------------------------------------------------------------------
# a sharded CPU engine captures nothing and equals the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kv_mode", [
    ("qwen2.5-14b", "paged"), ("qwen2.5-14b", "dense"),
    ("qwen3-moe-30b-a3b", "paged")])
def test_sharded_cpu_engine_captures_nothing_and_matches_jax(name, kv_mode):
    """TP=2 (EP=2 on the MoE arch) on two CPU shards keeps ``graphs``
    False whatever it is asked, runs every step through its shard
    threads, and gives the JAX single-device engine's logits and greedy
    tokens."""
    from test_torch_sharded import CPU2, TOL, _greedy, _prompt, _weights
    from repro.engine import BatchItem as JItem
    from repro.engine import InstanceEngine as JEngine
    from repro_torch.engine import InstanceEngine
    jcfg, jp, cfg, params, _ = _weights(name)
    prompt = _prompt(2, 20, cfg.vocab_size)
    ref = JEngine(jcfg, jp, n_slots=2, max_len=64, kv_mode=kv_mode)
    ref_toks, ref_logits = _greedy(ref, ref.alloc("r"), prompt, 5, JItem)
    eng = InstanceEngine(cfg, params, n_slots=2, max_len=64,
                         kv_mode=kv_mode, devices=CPU2, graphs=True)
    runs = []
    real = eng._group.run

    def counted(fn, context=None):
        runs.append(context)
        return real(fn, context)

    eng._group.run = counted
    try:
        toks, logits = _greedy(eng, eng.alloc("r"), prompt, 5)
    finally:
        eng.close()
    assert eng.tp == 2 and eng.graphs is False
    assert eng.captures == 0 and not eng._graphs
    assert runs == [None] * 5
    np.testing.assert_allclose(logits, ref_logits, atol=TOL, rtol=TOL)
    assert toks == ref_toks
