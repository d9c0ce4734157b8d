"""The engine-level trace (``repro_torch.utils.trace``): off, a served run
records nothing and costs a flag test a call site; on, spans nest at the
layer boundaries, every engine step gets one record closed with its plan,
the counters agree with the records, ``ExecResult.device_time`` is the
step's device time while the local scheduler still learns from the host
latency, and the same batches give the same logits and tokens either
way.  On the CPU, where the work runs in the call, a step's device time
is its ``engine.launch`` span."""
import ast
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.request import MicroRequest, Request  # noqa: E402
from repro_torch.core.session import (  # noqa: E402
    InstanceState, MicroState, ServeSession, SessionConfig,
)
from repro_torch.engine import EngineBackend, InstanceEngine  # noqa: E402
from repro_torch.engine.runner import bucket_of  # noqa: E402
from repro_torch.launch.serve import mini_trace  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.sim.policies import DynaServePolicy  # noqa: E402
from repro_torch.utils import trace  # noqa: E402

TRACE_FILE = Path(trace.__file__)
CHILDREN = {"engine.dispatch": {"engine.pack", "engine.stage",
                                "engine.launch"},
            "engine.collect": {"engine.d2h", "engine.sample"}}


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("qwen2.5-14b")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _backend(model, **kw):
    cfg, params = model
    return EngineBackend(cfg, params, n_slots=8, max_len=160, max_chunk=64,
                         transfer_chunk=16, **kw)


def _serve(model, traced, n=6, observe=None):
    """A two-instance DynaServe session over a short open-loop trace;
    the backend, the session and what the trace kept."""
    backend = _backend(model)
    policy = DynaServePolicy(backend.cost, 0.1)
    session = ServeSession(backend, policy, SessionConfig(
        n_instances=2, slo=0.1, open_loop=True, overlap=True))
    if observe is not None:
        observe(session)
    if traced:
        trace.enable()
    session.run(mini_trace(n, 40.0, 3, None, p_max=96, d_max=12))
    trace.disable()
    return backend, session, trace.take()


@pytest.fixture(scope="module")
def traced_run(model):
    hosts = []

    def observe(session):
        # what the local schedulers learn from: each step's host latency
        for inst in session.instances:
            record = inst.scheduler.record

            def rec(plan, latency, record=record):
                hosts.append(latency)
                return record(plan, latency)
            inst.scheduler.record = rec

    trace.disable()
    backend, session, got = _serve(model, True, observe=observe)
    trace.reset()
    return backend, session, got, hosts


def test_the_trace_module_imports_only_the_standard_library():
    tree = ast.parse(TRACE_FILE.read_text())
    roots = {(a.name if isinstance(node, ast.Import) else node.module)
             .split(".")[0]
             for node in ast.walk(tree)
             if isinstance(node, (ast.Import, ast.ImportFrom))
             for a in (node.names if isinstance(node, ast.Import)
                       else [node])}
    roots.discard("__future__")
    assert roots and roots <= set(sys.stdlib_module_names), roots


def test_a_served_run_with_tracing_off_records_nothing(model):
    backend, session, got = _serve(model, False)
    assert got["spans"] == [] and got["steps"] == []
    assert got["zero_ns"] is None
    assert sum(e.rows_real for e in backend.engines.values()) > 0


@pytest.mark.parametrize("parent", sorted(CHILDREN))
def test_spans_nest_inside_their_parent(traced_run, parent):
    _, _, got, _ = traced_run
    by_id = {s[0]: s for s in got["spans"]}
    tops = [s for s in got["spans"] if s[1] == parent]
    assert tops
    for top in tops:
        kids = [s for s in got["spans"] if s[4] == top[0]]
        assert {k[1] for k in kids} == CHILDREN[parent], top
        for k in kids:
            assert top[2] <= k[2] <= k[3] <= top[3]
            assert k[5] == top[5] and k[6] == top[6]   # step, instance
        assert top[4] == -1 or by_id[top[4]][1] not in CHILDREN


def test_the_session_and_handoff_spans_are_there(traced_run):
    _, _, got, _ = traced_run
    names = {s[1] for s in got["spans"]}
    assert {"session.compose", "policy.place"} <= names
    assert names & {"handoff.pump", "handoff.sync"}
    moved = [s[7]["bytes"] for s in got["spans"]
             if s[1].startswith("handoff.")]
    assert min(moved) >= 0 and sum(moved) > 0   # a stream's last pump: 0
    assert got["dropped"] == {"spans": 0, "steps": 0}


def test_every_step_has_one_record_and_the_counters_agree(traced_run):
    backend, session, got, _ = traced_run
    steps = got["steps"]
    dispatched = [s for s in got["spans"] if s[1] == "engine.dispatch"]
    assert len(steps) == len(dispatched) == sum(
        e.iterations for e in backend.engines.values())
    assert sorted(r["step"] for r in steps) == sorted(
        s[5] for s in dispatched)
    engines = backend.engines.values()
    assert sum(e.rows_computed for e in engines) == sum(
        r["N"] for r in steps)
    assert sum(e.rows_real for e in engines) == sum(r["rows"] for r in steps)
    for r in steps:
        eng = backend.engines[r["iid"]]
        # a paged step computes its rung's rows: n_slots on the decode
        # rung (T == 1), else a rung of the row ladder that holds them
        if r["T"] == 1:
            assert r["N"] == r["n_slots"] >= r["rows"]
        else:
            assert r["N"] in eng.buckets[1:] and r["N"] >= r["rows"]
        assert r["rows"] == r["prefill"] + r["decode"] > 0
        assert r["T"] >= 1 and r["n_slots"] == 8 and r["n_pp"] >= 1
        assert r["predicted_s"] > 0 and 0 < r["device_s"] <= r["host_s"]
        assert 0 <= r["t"] <= session.now
        assert r["captured"] is False            # the CPU captures nothing
    assert got["zero_ns"] is not None


def test_device_time_is_the_steps_and_the_scheduler_keeps_host_latency(
        traced_run):
    _, session, got, hosts = traced_run
    steps = got["steps"]
    launch = {s[5]: (s[3] - s[2]) * 1e-9 for s in got["spans"]
              if s[1] == "engine.launch"}
    for r in steps:
        assert r["device_s"] == pytest.approx(launch[r["step"]], abs=1e-9)
    busy = sum(inst.busy_time for inst in session.instances)
    assert busy == pytest.approx(sum(r["device_s"] for r in steps))
    assert sorted(hosts) == sorted(r["host_s"] for r in steps)
    assert busy < sum(hosts)


def test_the_gauges_carry_the_engine_counters(traced_run):
    backend, _, _, _ = traced_run
    for iid, eng in backend.engines.items():
        g = backend.gauges(iid)
        assert g["rows_computed"] == eng.rows_computed > 0
        assert g["rows_real"] == eng.rows_real > 0
        assert g["replays"] == eng.replays == 0
        assert g["captures"] == eng.captures == 0
        assert g["capture_seconds"] == eng.capture_seconds


def test_perfetto_draws_a_host_lane_an_instance(traced_run):
    from repro_torch.serving.flightrecorder import to_chrome_trace
    _, _, got, _ = traced_run
    out = to_chrome_trace([{"seq": 1, "t": 0.0, "kind": "token",
                            "data": {"rid": "x"}}], spans=got)
    lanes = {e["tid"] for e in out["traceEvents"]
             if str(e.get("tid", "")).startswith("host")}
    assert {"host-0", "host-1", "host"} <= lanes
    ev = [e for e in out["traceEvents"] if e.get("name") == "engine.launch"]
    assert len(ev) == len(got["steps"])
    assert all(e["dur"] > 0 and e["ts"] >= 0 for e in ev)


def _fixed_batches(model, traced):
    """Four batches straight through ``dispatch``/``collect`` of a fresh
    backend: two prefills, a mixed batch, then decodes; the logits the
    engine returned and the tokens sampled, step by step."""
    backend = _backend(model)
    backend.spawn(0)
    eng = backend.engines[0]
    inst = InstanceState(0, None)
    rng = np.random.default_rng(5)
    micros = []
    for i, (P, D) in enumerate([(40, 6), (17, 6)]):
        req = Request(f"r{i}", 0.0, P, D)
        backend.register(req, prompt=rng.integers(0, 500, P))
        m = MicroState(MicroRequest(req, "alpha", 0, P + D), P, D, 0)
        assert backend.on_place(0, m)
        micros.append(m)
    a, b = micros
    logits, tokens = [], []
    collect = eng.collect_batch

    def keep(handle):
        out = collect(handle)
        logits.append({s: v.copy() for s, v in out.items()})
        return out
    eng.collect_batch = keep
    if traced:
        trace.enable()
    for grants, decs in [([(a, 30)], []), ([(a, 10), (b, 17)], []),
                         ([], [a, b]), ([], [a, b])]:
        res = backend.collect(backend.dispatch(inst, grants, decs))
        tokens.append(res.tokens)
        assert (res.step is not None) == traced
        assert (res.device_time is not None) == traced
        for m, g in grants:
            m.pos += g
        for m in decs:
            m.pos += 1
    trace.disable()
    return logits, tokens


def test_the_same_batches_give_the_same_logits_and_tokens_traced(model):
    off = _fixed_batches(model, False)
    on = _fixed_batches(model, True)
    assert on[1] == off[1]
    for got, want in zip(on[0], off[0]):
        assert got.keys() == want.keys()
        for s in want:
            assert np.array_equal(got[s], want[s])


@pytest.mark.parametrize("depth", [1, 3])
def test_begin_and_end_nest_and_name_their_parent(depth):
    trace.enable()
    opened = [trace.begin(f"s{i}", key=i, iid=7) for i in range(depth)]
    for sp in reversed(opened):
        assert trace.end(sp, n=1) >= 0
    got = trace.take()["spans"]
    assert [s[1] for s in got] == [f"s{i}" for i in reversed(range(depth))]
    ids = {s[1]: s[0] for s in got}
    for s in got:
        i = int(s[1][1:])
        assert s[4] == (ids[f"s{i - 1}"] if i else -1)
        assert s[5] == i and s[6] == 7 and s[7] == {"n": 1}
        assert s[2] <= s[3]


def test_a_span_left_open_by_an_exception_is_closed_by_its_parent():
    trace.enable()
    outer = trace.begin("outer")
    trace.begin("inner")                   # never ended
    trace.end(outer)
    after = trace.begin("after")
    trace.end(after)
    got = {s[1]: s for s in trace.take()["spans"]}
    assert set(got) == {"outer", "after"}
    assert got["after"][4] == -1


def test_the_buffers_are_bounded_and_count_what_fell_out(monkeypatch):
    import collections
    monkeypatch.setattr(trace, "_spans", collections.deque(maxlen=3))
    monkeypatch.setattr(trace, "_steps", collections.deque(maxlen=2))
    trace.enable()
    for i in range(5):
        trace.end(trace.begin(f"s{i}"))
        trace.add_step({"step": i})
    got = trace.take()
    assert [s[1] for s in got["spans"]] == ["s2", "s3", "s4"]
    assert [r["step"] for r in got["steps"]] == [3, 4]
    assert got["dropped"] == {"spans": 2, "steps": 3}


def test_an_engine_with_tracing_off_keeps_no_record(model):
    cfg, params = model
    eng = InstanceEngine(cfg, params, n_slots=2, max_len=64, iid=3)
    eng.alloc("a")
    from repro_torch.engine import BatchItem
    handle = eng.dispatch_batch([BatchItem(0, np.arange(5, dtype=np.int32),
                                           0, True)])
    assert handle.record is None and handle.start is None
    eng.collect_batch(handle)
    # a 5-token chunk: the least rung of the row ladder past the
    # decode-only one, 16 + 2 rows at 2 slots
    assert eng.buckets[1] == bucket_of(5, eng.buckets[1:]) == 18
    assert (eng.rows_computed, eng.rows_real, eng.iterations) == (18, 5, 1)
    assert trace.take()["spans"] == []
