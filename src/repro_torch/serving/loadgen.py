"""Closed-loop HTTP load generator for the serving front door.

Stdlib asyncio, measuring at the *client*: N concurrent clients each
loop issuing streamed ``/v1/completions`` until the deadline, recording
wall-clock TTFT (request sent -> first SSE data event) and TBT
(gaps between SSE events) per SLO class — the numbers a user of the
HTTP API actually experiences, including HTTP/queueing overhead the
session-side histograms don't see.

Usable three ways:

* library — ``run_load(host, port, clients=8, duration=10)`` returns the
  report dict (the ``benchmarks/http_serving.py`` capacity driver);
* CLI against a running server —
  ``python -m repro_torch.serving.loadgen --host H --port P --clients 8``;
* self-contained — ``--self-serve`` boots an in-process sim-backend
  ``ServingServer`` first; ``--smoke`` additionally asserts /healthz,
  a non-empty /metrics carrying the expected series, and a clean
  shutdown (the CI job).
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.metrics_util import pctl

__all__ = ["run_load", "LoadStats", "main"]


@dataclasses.dataclass
class LoadStats:
    """Client-side accumulator, per SLO class."""
    completed: int = 0
    rejected: int = 0
    errors: int = 0
    tokens: int = 0
    ttfts: List[float] = dataclasses.field(default_factory=list)
    tbts: List[float] = dataclasses.field(default_factory=list)
    latencies: List[float] = dataclasses.field(default_factory=list)


async def _read_headers(reader) -> Tuple[int, Dict[str, str]]:
    raw = await reader.readuntil(b"\r\n\r\n")
    lines = raw.decode("latin-1").split("\r\n")
    status = int(lines[0].split(" ")[1])
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if line:
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
    return status, headers


async def _sse_events(reader):
    """Yield (event_text, wall_time) for each SSE data event in a
    chunked response body."""
    buf = b""
    while True:
        size_line = await reader.readuntil(b"\r\n")
        size = int(size_line.strip() or b"0", 16)
        if size == 0:
            break
        chunk = await reader.readexactly(size)
        await reader.readexactly(2)            # trailing CRLF
        now = time.monotonic()
        buf += chunk
        while b"\n\n" in buf:
            event, buf = buf.split(b"\n\n", 1)
            for line in event.decode("utf-8", "replace").splitlines():
                if line.startswith("data: "):
                    yield line[len("data: "):], now


async def _one_request(host: str, port: int, prompt: List[int],
                       max_new: int, slo: Optional[str], stream: bool,
                       api_key: Optional[str], stats: LoadStats) -> None:
    t0 = time.monotonic()
    reader = writer = None
    try:
        reader, writer = await asyncio.open_connection(host, port)
        body = {"prompt": prompt, "max_tokens": max_new, "stream": stream}
        if slo:
            body["slo"] = slo
        payload = json.dumps(body).encode()
        head = (f"POST /v1/completions HTTP/1.1\r\nHost: {host}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(payload)}\r\n")
        if api_key:
            head += f"Authorization: Bearer {api_key}\r\n"
        writer.write(head.encode() + b"\r\n" + payload)
        await writer.drain()
        status, headers = await _read_headers(reader)
        if status == 503:
            stats.rejected += 1
            return
        if status != 200:
            stats.errors += 1
            return
        if stream and "chunked" in headers.get("transfer-encoding", ""):
            last: Optional[float] = None
            n_tok = 0
            async for data, now in _sse_events(reader):
                if data == "[DONE]":
                    break
                obj = json.loads(data)
                if not obj["choices"][0].get("text") and \
                        obj["choices"][0].get("finish_reason"):
                    continue                   # final finish-reason chunk
                n_tok += 1
                if last is None:
                    stats.ttfts.append(now - t0)
                else:
                    stats.tbts.append(now - last)
                last = now
            stats.tokens += n_tok
            stats.completed += 1
        else:
            n = int(headers.get("content-length", "0"))
            raw = await reader.readexactly(n) if n else b""
            obj = json.loads(raw.decode())
            stats.tokens += obj.get("usage", {}).get("completion_tokens", 0)
            stats.ttfts.append(time.monotonic() - t0)
            stats.completed += 1
        stats.latencies.append(time.monotonic() - t0)
    except (OSError, asyncio.IncompleteReadError, ValueError, KeyError):
        stats.errors += 1
    finally:
        if writer is not None:
            try:
                writer.close()
            except Exception:
                pass


async def _client_loop(host: str, port: int, deadline: float,
                       per_class: Dict[str, LoadStats], mix, rng,
                       prompt_len: int, max_new: int, stream: bool,
                       api_key: Optional[str]) -> None:
    names, weights = mix
    while time.monotonic() < deadline:
        slo = str(rng.choice(names, p=weights)) if names else None
        prompt = [int(t) for t in rng.integers(0, 256, size=prompt_len)]
        stats = per_class.setdefault(slo or "default", LoadStats())
        await _one_request(host, port, prompt, max_new, slo, stream,
                           api_key, stats)


def _parse_mix(text: Optional[str]):
    if not text:
        return (), ()
    names, weights = [], []
    for part in text.split(","):
        name, _, w = part.partition("=")
        names.append(name.strip())
        weights.append(float(w or 1.0))
    total = sum(weights)
    return tuple(names), tuple(w / total for w in weights)


def run_load(host: str, port: int, *, clients: int = 4,
             duration: float = 5.0, prompt_len: int = 32, max_new: int = 16,
             slo_mix: Optional[str] = "interactive=0.4,standard=0.4,batch=0.2",
             stream: bool = True, api_key: Optional[str] = None,
             seed: int = 0) -> dict:
    """Closed-loop load; returns the client-side report dict."""
    per_class: Dict[str, LoadStats] = {}
    mix = _parse_mix(slo_mix)
    t0 = time.monotonic()

    async def _run():
        deadline = time.monotonic() + duration
        await asyncio.gather(*(
            _client_loop(host, port, deadline, per_class, mix,
                         np.random.default_rng(seed + i), prompt_len,
                         max_new, stream, api_key)
            for i in range(clients)))

    asyncio.run(_run())
    wall = time.monotonic() - t0
    classes = {}
    for name, s in sorted(per_class.items()):
        classes[name] = {
            "completed": s.completed, "rejected": s.rejected,
            "errors": s.errors, "tokens": s.tokens,
            "ttft_p50": pctl(s.ttfts, 50), "ttft_p99": pctl(s.ttfts, 99),
            "tbt_p99": pctl(s.tbts, 99),
            "latency_p50": pctl(s.latencies, 50),
            "tok_per_s": s.tokens / wall if wall > 0 else 0.0,
        }
    total = LoadStats()
    for s in per_class.values():
        total.completed += s.completed
        total.rejected += s.rejected
        total.errors += s.errors
        total.tokens += s.tokens
        total.latencies.extend(s.latencies)
    lat = np.asarray(total.latencies, dtype=float)
    return {
        "clients": clients, "duration_s": round(wall, 3),
        "completed": total.completed, "rejected": total.rejected,
        "errors": total.errors, "tokens": total.tokens,
        "rps": total.completed / wall if wall > 0 else 0.0,
        "tok_per_s": total.tokens / wall if wall > 0 else 0.0,
        "latency_mean": float(lat.mean()) if lat.size else 0.0,
        "latency_p50": pctl(lat, 50),
        "per_class": classes,
    }


def _print_report(rep: dict) -> None:
    print(f"clients={rep['clients']} wall={rep['duration_s']:.2f}s "
          f"completed={rep['completed']} rejected={rep['rejected']} "
          f"errors={rep['errors']} rps={rep['rps']:.1f} "
          f"tok/s={rep['tok_per_s']:.1f}")
    if rep["per_class"]:
        print(f"{'class':<12} {'done':>5} {'rej':>4} {'err':>4} "
              f"{'ttft_p50':>9} {'ttft_p99':>9} {'tbt_p99':>8} {'tok/s':>8}")
        for name, c in rep["per_class"].items():
            print(f"{name:<12} {c['completed']:>5} {c['rejected']:>4} "
                  f"{c['errors']:>4} {c['ttft_p50']:>8.3f}s "
                  f"{c['ttft_p99']:>8.3f}s {c['tbt_p99']*1e3:>6.1f}ms "
                  f"{c['tok_per_s']:>8.1f}")


def _fetch(host: str, port: int, path: str) -> Tuple[int, bytes]:
    async def _go():
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(f"GET {path} HTTP/1.1\r\nHost: {host}\r\n\r\n".encode())
        await writer.drain()
        status, headers = await _read_headers(reader)
        n = int(headers.get("content-length", "0"))
        body = await reader.readexactly(n) if n else await reader.read(-1)
        writer.close()
        return status, body
    return asyncio.run(_go())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slo-mix",
                    default="interactive=0.4,standard=0.4,batch=0.2")
    ap.add_argument("--no-stream", action="store_true",
                    help="unary completions instead of SSE")
    ap.add_argument("--api-key", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--self-serve", action="store_true",
                    help="boot an in-process sim-backend server first")
    ap.add_argument("--smoke", action="store_true",
                    help="short self-validating run (implies --self-serve "
                         "unless --host/--port point at a live server)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.duration = min(args.duration, 2.0)
        args.clients = min(args.clients, 2)

    server = None
    host, port = args.host, args.port
    if args.self_serve or args.smoke:
        from repro_torch.serving.http import ServerConfig, ServingServer
        server = ServingServer(ServerConfig(
            host="127.0.0.1", port=0, backend="sim", admission=True)).start()
        host, port = "127.0.0.1", server.port
        print(f"self-serve: sim backend on {host}:{port}")

    try:
        rep = run_load(host, port, clients=args.clients,
                       duration=args.duration, prompt_len=args.prompt_len,
                       max_new=args.max_new, slo_mix=args.slo_mix,
                       stream=not args.no_stream, api_key=args.api_key,
                       seed=args.seed)
        _print_report(rep)
        if args.smoke:
            status, body = _fetch(host, port, "/healthz")
            assert status == 200, f"/healthz -> {status}"
            status, body = _fetch(host, port, "/metrics")
            assert status == 200, f"/metrics -> {status}"
            text = body.decode()
            for needle in ("dynaserve_requests_total",
                           "dynaserve_ttft_seconds_bucket",
                           "dynaserve_http_requests_total",
                           "dynaserve_queue_depth"):
                assert needle in text, f"/metrics missing {needle}"
            assert rep["completed"] > 0, "no completions finished"
            assert rep["errors"] == 0, f"{rep['errors']} client errors"
            print(f"smoke OK: {rep['completed']} completions, "
                  f"{len(text.splitlines())} metric lines, clean shutdown")
    finally:
        if server is not None:
            server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
