"""Online serving driver: open-loop arrivals against the ``ServeSession``
API, on either backend, reporting per-SLO-class TTFT / TBT / goodput.

The port of ``repro.launch.serve``: the same flags and report, with the
engine backend on the port's torch engines and one more flag,
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
Requests arrive on their trace timestamps whether or not the system kept
up, SLO classes attach admission + latency targets, and goodput is
per-class SLO-attaining tokens per second measured at the API.

  # torch engines on the card, wall clock, open-loop arrivals
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --open-loop

  # the same on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

  # simulator, paper workloads, elastic pool, admission control
  PYTHONPATH=src python -m repro_torch.launch.serve --backend sim \\
      --workload burstgpt --qps 3 --duration 30 --policy elastic --admission
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Union

import numpy as np

# torch, the engine and the simulator are imported inside the serve_*
# functions, so a sim run never loads the engine
from repro_torch.core.costmodel import A100, BatchCostModel
from repro_torch.core.request import Request, SLO_CLASSES
from repro_torch.core.session import ServeSession, SessionConfig, SessionMetrics
from repro_torch.data.workloads import generate_trace, pick_slo


def parse_slo_mix(text: Optional[str]) -> Optional[Dict[str, float]]:
    """``interactive=0.5,standard=0.3,batch=0.2`` -> weight dict."""
    if not text:
        return None
    mix = {}
    for part in text.split(","):
        name, _, w = part.partition("=")
        if name not in SLO_CLASSES:
            raise SystemExit(f"unknown SLO class {name!r}; "
                             f"one of {sorted(SLO_CLASSES)}")
        mix[name] = float(w or 1.0)
    return mix


def parse_devices(text) -> Union[int, List[int]]:
    """``2`` -> uniform shard width; ``1,2,2`` -> per-instance widths
    (instance iid takes ``widths[iid % len(widths)]``)."""
    if text is None:
        return 1
    s = str(text).strip()
    if "," in s:
        widths = [max(1, int(p)) for p in s.split(",") if p.strip()]
        return widths if widths else 1
    return max(1, int(s or 1))


def _max_width(dpi: Union[int, List[int]]) -> int:
    return max(dpi) if isinstance(dpi, list) else dpi


def _ensure_host_devices(n: int, device: Optional[str]) -> None:
    """Sharded engine instances need >= n devices; the CPU is one, so on
    ``--device cpu`` the launcher repeats it n times (the
    ``REPRO_TORCH_DEVICE_COUNT`` setting), as the reference forces the
    host platform's device count on a CPU host.  A card's devices are
    repeated only when the caller sets it."""
    from repro_torch.utils.device import DEVICE_COUNT_ENV
    if n <= 1 or device != "cpu":
        return
    if int(os.environ.get(DEVICE_COUNT_ENV) or 0) < n:
        os.environ[DEVICE_COUNT_ENV] = str(n)


def mini_trace(n: int, qps: float, seed: int,
               slo_mix: Optional[Dict[str, float]],
               p_max: int = 48, d_max: int = 16) -> List[Request]:
    """Engine-scale trace: tiny prompts/outputs that fit a reduced
    model's cache, Poisson arrivals, SLO classes by mix."""
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for i in range(n):
        t += rng.exponential(1.0 / qps)
        p = int(rng.integers(8, p_max))
        d = int(rng.integers(4, d_max))
        reqs.append(Request(f"online-{i}", t, p, d, predicted_decode=d,
                            slo=pick_slo(rng, slo_mix)))
    return reqs


def report(m: SessionMetrics, label: str) -> None:
    print(f"== {label} ==")
    print(f"offered={m.offered} completed={m.completed} "
          f"rejected={m.rejected} cancelled={m.cancelled} "
          f"duration={m.duration:.2f}s goodput={m.goodput:.1f} tok/s "
          f"p99_tbt={m.p99_tbt()*1e3:.1f}ms")
    if m.transfer_bytes_total:
        # exposed = transfer time the destination actually waited (not
        # hidden behind compute); with --overlap this should be a small
        # fraction of the bytes' wire time
        print(f"kv-transfer: {m.transfer_bytes_total/1e6:.2f} MB moved, "
              f"exposed={m.transfer_exposed_total*1e3:.1f}ms")
    if m.prefix_lookups:
        print(f"prefix-cache: hit_rate={m.prefix_hit_rate:.2f} "
              f"({m.prefix_hits}/{m.prefix_lookups}) "
              f"saved_prefill={m.prefix_saved_tokens} tok "
              f"saved_handoff={m.prefix_handoff_saved_tokens} tok "
              f"evictions={m.prefix_evictions} "
              f"computed_prefill={m.prefill_tokens_computed} tok")
    if m.per_class:
        print(f"{'class':<12} {'offered':>7} {'done':>5} {'rej':>4} "
              f"{'ttft_p50':>9} {'ttft_p99':>9} {'tbt_p99':>8} "
              f"{'goodput':>8} {'attain':>6}")
        for name in sorted(m.per_class):
            c = m.per_class[name]
            print(f"{name:<12} {c.offered:>7} {c.completed:>5} "
                  f"{c.rejected:>4} {c.ttft_p50:>8.3f}s {c.ttft_p99:>8.3f}s "
                  f"{c.tbt_p99*1e3:>6.1f}ms {c.goodput:>8.1f} "
                  f"{c.attainment:>6.2f}")


def _attach_recorder(session: ServeSession, args):
    """Flight recorder for batch runs: on when any of --decision-log /
    --perfetto / --attribution asks for its output; --perfetto also
    switches the engine's tracing on, for its host lanes."""
    if not (args.decision_log or args.perfetto or args.attribution):
        return None
    from repro_torch.serving.flightrecorder import FlightRecorder
    if args.perfetto:
        from repro_torch.utils import trace
        trace.enable()
    rec = FlightRecorder(capacity=args.recorder_capacity,
                         sink=args.decision_log)
    rec.attach(session)
    return rec


def _finish_recorder(rec, args) -> None:
    if rec is None:
        return
    rec.close()
    events = rec.events()
    if args.decision_log:
        print(f"decision log -> {args.decision_log} "
              f"({len(events)} events kept, {rec.dropped} aged out of "
              f"the ring)")
    if args.perfetto:
        from repro_torch.serving.flightrecorder import export_chrome_trace
        from repro_torch.utils import trace
        trace.disable()
        n = export_chrome_trace(events, args.perfetto, spans=trace.take())
        print(f"perfetto trace -> {args.perfetto} ({n} trace events)")
    if args.attribution:
        from repro_torch.serving.attribution import analyze
        report = analyze(events)
        print("== SLO-miss attribution ==")
        print(f"{'class':<12} {'n':>4} {'ttft_miss':>9} {'tbt_miss':>8} "
              f"{'top_cause':>20}")
        for name in sorted(report.per_class):
            c = report.per_class[name]
            print(f"{name:<12} {c.n:>4} {c.ttft_misses:>9} "
                  f"{c.tbt_misses:>8} {c.top_cause or '-':>20}")


def serve_engine(args) -> SessionMetrics:
    dpi = parse_devices(args.devices_per_instance)
    _ensure_host_devices(args.instances * _max_width(dpi), args.device)
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.engine.backend import EngineBackend
    from repro_torch.models.model import init_params
    from repro_torch.sim.policies import DynaServePolicy
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    mix = parse_slo_mix(args.slo_mix)
    reqs = mini_trace(args.requests, args.qps, args.seed, mix,
                      p_max=args.prompt_len, d_max=args.max_new)
    kvp = None
    if args.kv_precision and args.kv_precision != "bf16":
        from repro_torch.core.precision import PrecisionPolicy
        pol = PrecisionPolicy.parse(args.kv_precision)
        uni = pol.uniform
        if uni is None:
            raise SystemExit(
                "engine pools store ONE format each; use a uniform "
                "--kv-precision (bf16/fp8/int8) on the engine backend, "
                "or the sim backend for SLO-mixed policies")
        kvp = uni.name
    backend = EngineBackend(cfg, params, n_slots=max(8, 2 * args.requests),
                            max_len=args.prompt_len + args.max_new + 32,
                            prefix_cache=args.prefix_cache,
                            kv_precision=kvp or "bf16",
                            devices_per_instance=dpi)
    policy = DynaServePolicy(backend.cost, args.slo)
    session = ServeSession(backend, policy, SessionConfig(
        n_instances=args.instances, slo=args.slo,
        admission=args.admission, open_loop=args.open_loop,
        overlap=True if args.overlap else None))
    rec = _attach_recorder(session, args)
    m = session.run(reqs)
    _finish_recorder(rec, args)
    report(m, f"engine backend ({cfg.name}), "
              f"{'open' if args.open_loop else 'closed'}-loop, "
              f"admission={'on' if args.admission else 'off'}, "
              f"overlap={'on' if args.overlap else 'off'}")
    if not args.admission and m.completed != m.offered:
        raise SystemExit(f"smoke failure: {m.offered - m.completed} "
                         f"request(s) did not complete")
    return m


def serve_sim(args) -> SessionMetrics:
    from repro_torch.configs import get_config
    from repro_torch.core.elastic import ElasticConfig
    from repro_torch.sim.policies import DynaServePolicy, ElasticDynaServePolicy
    from repro_torch.sim.simulator import SimBackend

    from repro_torch.data.workloads import SHARED_PREFIX_TRACES, shared_prefix_trace

    cost = BatchCostModel(get_config(args.arch), A100)
    dpi = parse_devices(args.devices_per_instance)
    mix = parse_slo_mix(args.slo_mix)
    if args.workload in SHARED_PREFIX_TRACES:
        reqs = shared_prefix_trace(args.workload, args.qps, args.duration,
                                   seed=args.seed, slo_mix=mix)
    else:
        reqs = generate_trace(args.workload, args.qps, args.duration,
                              seed=args.seed, slo_mix=mix)
    if args.policy == "elastic":
        policy = ElasticDynaServePolicy(
            cost, args.slo,
            elastic=ElasticConfig(min_instances=max(1, args.instances // 2),
                                  max_instances=2 * args.instances,
                                  max_devices_per_instance=_max_width(dpi)))
    else:
        policy = DynaServePolicy(cost, args.slo)
    from repro_torch.core.precision import PrecisionPolicy
    pol = PrecisionPolicy.parse(args.kv_precision)
    uni = pol.uniform
    prec_kw = dict(kv_precision=uni.name if uni is not None else "bf16",
                   precision_policy=None if uni is not None else pol)
    if args.prefix_cache:
        backend = SimBackend(cost, page_size=args.page_size,
                             pages_per_instance=args.pages_per_instance,
                             prefix_cache=True,
                             devices_per_instance=dpi, **prec_kw)
    else:
        backend = SimBackend(cost, devices_per_instance=dpi, **prec_kw)
    session = ServeSession(backend, policy, SessionConfig(
        n_instances=args.instances, slo=args.slo,
        admission=args.admission,
        overlap=True if args.overlap else None))
    rec = _attach_recorder(session, args)
    m = session.run(reqs)
    _finish_recorder(rec, args)
    report(m, f"sim backend, {args.workload} @ {args.qps} qps, "
              f"policy={args.policy}, "
              f"admission={'on' if args.admission else 'off'}, "
              f"overlap={'on' if args.overlap else 'off'}")
    return m


def serve_http(args) -> None:
    """Long-lived front door: OpenAI-compatible HTTP + /metrics."""
    if (args.backend or "sim") == "engine":
        _ensure_host_devices(
            args.instances * _max_width(parse_devices(
                args.devices_per_instance)), args.device)
    from repro_torch.serving.http import ServerConfig, ServingServer

    cfg = ServerConfig(
        host=args.host, port=args.port,
        backend=args.backend or "sim", arch=args.arch,
        n_instances=args.instances, slo=args.slo,
        admission=args.admission, overlap=args.overlap or None,
        prefix_cache=args.prefix_cache, page_size=args.page_size,
        pages_per_instance=args.pages_per_instance,
        devices_per_instance=parse_devices(args.devices_per_instance),
        trace_path=args.trace_log,
        decision_log=args.decision_log, device=args.device)
    server = ServingServer(cfg)
    server.start()
    print(f"serving {cfg.backend} backend on http://{cfg.host}:{server.port}")
    print(f"  POST /v1/completions | /v1/chat/completions   (SSE: "
          f'"stream": true; classes: "slo": interactive|standard|batch)')
    print(f"  GET  /metrics /healthz /v1/models "
          f"/debug/attribution /debug/trace")
    if args.trace_log:
        print(f"  trace spans -> {args.trace_log}")
    if args.decision_log:
        print(f"  decision log -> {args.decision_log}")
    server.serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", choices=["sim", "engine"], default=None,
                    help="default: engine with --smoke, sim otherwise")
    ap.add_argument("--http", action="store_true",
                    help="run the OpenAI-compatible HTTP front door "
                         "instead of a batch trace (Ctrl-C to stop)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--trace-log", default=None,
                    help="append per-request span JSONL here (--http)")
    ap.add_argument("--decision-log", default=None,
                    help="write every scheduler decision as JSONL here "
                         "(the flight-recorder event stream; replayable "
                         "with repro_torch.sim.replay)")
    ap.add_argument("--perfetto", default=None,
                    help="export a Chrome/Perfetto trace JSON of the run "
                         "here, the engine's spans as one host lane an "
                         "instance (batch runs; for --http use "
                         "/debug/trace)")
    ap.add_argument("--attribution", action="store_true",
                    help="print the per-class SLO-miss attribution "
                         "summary after a batch run")
    ap.add_argument("--recorder-capacity", type=int, default=1 << 20,
                    help="flight-recorder ring size (events kept in "
                         "memory for --perfetto/--attribution)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced model + tiny trace (CI-sized)")
    ap.add_argument("--open-loop", action="store_true",
                    help="honor arrival timestamps on the wall clock "
                         "(engine backend; the simulator is always "
                         "arrival-driven)")
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--slo", type=float, default=0.100,
                    help="default TBT SLO for unclassed requests (s)")
    ap.add_argument("--slo-mix",
                    default="interactive=0.4,standard=0.4,batch=0.2",
                    help="class=weight list; empty string = unclassed")
    ap.add_argument("--admission", action="store_true",
                    help="enable TTFT-predicting admission control")
    ap.add_argument("--overlap", action="store_true",
                    help="pipelined dispatch-ahead execution with "
                         "background KV streams (token streams are "
                         "identical; wall-clock and exposed-transfer "
                         "improve)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the shared-prefix KV cache (use a "
                         "shared-prefix --workload to see hits)")
    ap.add_argument("--page-size", type=int, default=32,
                    help="KV page size for the sim page pool "
                         "(--prefix-cache on the sim backend)")
    ap.add_argument("--pages-per-instance", type=int, default=4096,
                    help="sim page-pool capacity per instance")
    ap.add_argument("--kv-precision", default="bf16",
                    help="KV page storage format: bf16 | fp8 | int8 | "
                         "mixed (BATCH-class quantized, rest bf16) | "
                         "an explicit 'class=fmt,...' map.  Engine "
                         "pools take a uniform format; the sim models "
                         "SLO-mixed pools")
    ap.add_argument("--devices-per-instance", default="1",
                    help="shard width of each instance: a uniform int "
                         "(2 = every instance is a TP=2 instance over "
                         "2 devices, one shard thread each) or a comma "
                         "list like 1,2,2 (instance iid takes "
                         "widths[iid %% len]).  The engine needs that "
                         "many devices of --device's kind; "
                         "REPRO_TORCH_DEVICE_COUNT=n repeats them so "
                         "shards time-share one")
    ap.add_argument("--device", default="cuda",
                    help="engine-backend device: cuda (the card) or cpu "
                         "(the plain PyTorch path)")
    ap.add_argument("--seed", type=int, default=0)
    # engine-backend knobs
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=16)
    # sim-backend knobs
    ap.add_argument("--workload", default="burstgpt")
    ap.add_argument("--qps", type=float, default=2.0)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--policy", choices=["dyna", "elastic"], default="dyna")
    args = ap.parse_args(argv)

    if args.http:
        serve_http(args)
        return 0
    backend = args.backend or ("engine" if args.smoke else "sim")
    if backend == "engine":
        serve_engine(args)
    else:
        serve_sim(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
