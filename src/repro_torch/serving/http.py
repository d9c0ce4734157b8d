"""OpenAI-compatible streaming HTTP front door over ``ServeSession``.

Stdlib only: the project depends on numpy + torch, so this is HTTP/1.1
written directly on ``asyncio`` streams — request parsing, chunked
transfer encoding for SSE, and JSON bodies shaped like the OpenAI API:

    POST /v1/completions        {"prompt", "max_tokens", "stream", "slo"}
    POST /v1/chat/completions   {"messages", "max_tokens", "stream", "slo"}
    GET  /v1/models             served model listing
    GET  /metrics               Prometheus text exposition
    GET  /healthz               liveness (503 once the driver is down)
    GET  /debug/attribution     SLO-miss attribution over recorded events
    GET  /debug/trace           Perfetto/Chrome trace of recorded events

``"slo"`` is the DynaServe extension field: ``interactive`` /
``standard`` / ``batch`` attaches the paper's per-class TTFT/TBT
targets; the session's admission control can then reject (HTTP 503)
a request whose predicted queue wait already bursts its TTFT bound.

Streaming responses use SSE over chunked encoding (``data: {...}`` per
token, ``data: [DONE]`` terminator) and carry ``x-request-id`` /
``x-trace-id`` headers — the trace id keys the JSONL span log.  A client
that disconnects mid-stream gets its request cancelled in the session
(slots, queued micros and in-flight KV handoff streams all freed).

Admission is layered: the ``ApiKeyGate`` (per-key token bucket +
in-flight cap, ``Authorization: Bearer``) answers 401/429 before the
session's own prefill-drain admission control ever sees the request.

There is no connection reuse — every response is ``Connection: close``.
That keeps parsing honest (no pipelining corner cases) and costs only a
localhost TCP handshake per request.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.request import SLO_CLASSES, SLOClass
from repro_torch.serving.driver import SessionDriver
from repro_torch.serving.metrics import MetricsRegistry, ServingMetrics
from repro_torch.serving.tracing import Tracer

__all__ = ["KeyQuota", "ApiKeyGate", "ServerConfig", "ServingServer",
           "make_session"]

_MAX_BODY = 1 << 20          # 1 MiB request bodies
_MAX_HEADER = 64 << 10


# ---------------------------------------------------------------------------
# Per-API-key admission
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class KeyQuota:
    """Token-bucket rate + concurrency cap for one API key."""
    rate: float = 10.0          # sustained requests/second refill
    burst: int = 20             # bucket depth
    max_inflight: int = 64      # concurrent streams


class _KeyState:
    __slots__ = ("quota", "tokens", "last", "inflight")

    def __init__(self, quota: KeyQuota):
        self.quota = quota
        self.tokens = float(quota.burst)
        self.last = time.monotonic()
        self.inflight = 0


class ApiKeyGate:
    """401 unknown key / 429 over-rate, before the session sees anything.

    With no keys configured every request passes under one shared
    anonymous quota (effectively unlimited by default) — auth is opt-in.
    """

    def __init__(self, keys: Optional[Dict[str, KeyQuota]] = None,
                 anonymous: Optional[KeyQuota] = None):
        self._lock = threading.Lock()
        self.required = bool(keys)
        self._states: Dict[str, _KeyState] = {
            k: _KeyState(q) for k, q in (keys or {}).items()}
        if not self.required:
            self._states[""] = _KeyState(
                anonymous or KeyQuota(rate=1e9, burst=1 << 30,
                                      max_inflight=1 << 30))

    @staticmethod
    def _bearer(auth: Optional[str]) -> str:
        if not auth:
            return ""
        scheme, _, cred = auth.partition(" ")
        return cred.strip() if scheme.lower() == "bearer" else ""

    def acquire(self, auth_header: Optional[str]
                ) -> Tuple[int, Optional[str], str]:
        """Returns ``(status, error_message, key)``; status 200 means the
        caller holds one in-flight slot and must ``release(key)``."""
        key = self._bearer(auth_header)
        with self._lock:
            st = self._states.get(key if self.required else "")
            if st is None:
                return 401, "invalid or missing API key", key
            now = time.monotonic()
            st.tokens = min(float(st.quota.burst),
                            st.tokens + (now - st.last) * st.quota.rate)
            st.last = now
            if st.inflight >= st.quota.max_inflight:
                return 429, "too many concurrent requests", key
            if st.tokens < 1.0:
                return 429, "rate limit exceeded", key
            st.tokens -= 1.0
            st.inflight += 1
            return 200, None, key

    def release(self, key: str) -> None:
        with self._lock:
            st = self._states.get(key if self.required else "")
            if st is not None and st.inflight > 0:
                st.inflight -= 1


# ---------------------------------------------------------------------------
# Session construction
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 8000                 # 0 = ephemeral (tests)
    backend: str = "sim"             # "sim" | "engine"
    model: str = "dynaserve"         # name reported by /v1/models
    arch: str = "qwen2.5-14b"        # sim cost model / engine smoke arch
    n_instances: int = 2
    slo: float = 0.100
    admission: bool = False
    overlap: Optional[bool] = None
    prefix_cache: bool = False
    page_size: int = 32
    pages_per_instance: int = 4096
    # shard width per instance: uniform int, or a per-instance list
    # (iid takes widths[iid % len]); the sim prices the widths in its
    # cost model, and the engine backend runs sharded instances over
    # that many devices.  The per-instance "devices" gauge lands on
    # /metrics either way.
    devices_per_instance: Union[int, List[int]] = 1
    default_slo: str = "standard"    # class for requests without "slo"
    max_tokens_cap: int = 512        # hard per-request output cap
    retain_finished: bool = False    # True: keep state for session.metrics()
    tick_events: int = 256           # driver pump granularity
    trace_path: Optional[str] = None  # JSONL span log (None: in-memory ring)
    api_keys: Optional[Dict[str, KeyQuota]] = None
    # scheduler flight recorder (decision log + /debug endpoints)
    flight_recorder: bool = True
    recorder_capacity: int = 65536   # in-memory event ring size
    decision_log: Optional[str] = None  # JSONL sink for every event
    # engine-backend sizing
    engine_slots: int = 8
    engine_max_len: int = 192
    # engine-backend device: None = the CUDA card ("cpu" runs the plain
    # PyTorch path; without a card and without "cpu" the engine raises)
    device: Optional[str] = None


def make_session(cfg: ServerConfig):
    """Build a serving ``ServeSession`` on the configured backend.

    Serving sessions run with no time horizon (``max_sim_time=inf``) and
    by default drop terminal per-request state (bounded memory for a
    long-lived process)."""
    from repro_torch.core.session import ServeSession, SessionConfig

    scfg = SessionConfig(
        n_instances=cfg.n_instances, slo=cfg.slo,
        admission=cfg.admission, open_loop=False,
        overlap=cfg.overlap, max_sim_time=float("inf"),
        default_slo=SLO_CLASSES.get(cfg.default_slo),
        retain_finished=cfg.retain_finished)
    if cfg.backend == "engine":
        import torch
        from repro_torch.configs import get_smoke_config
        from repro_torch.engine.backend import EngineBackend
        from repro_torch.models.model import init_params
        from repro_torch.sim.policies import DynaServePolicy
        from repro_torch.utils.device import resolve_device

        dev = resolve_device(cfg.device)
        mcfg = get_smoke_config(cfg.arch)
        params = init_params(mcfg, torch.Generator(dev).manual_seed(0), dev)
        backend = EngineBackend(mcfg, params, n_slots=cfg.engine_slots,
                                max_len=cfg.engine_max_len,
                                prefix_cache=cfg.prefix_cache,
                                devices_per_instance=cfg.devices_per_instance)
        policy = DynaServePolicy(backend.cost, cfg.slo)
    else:
        from repro_torch.configs import get_config
        from repro_torch.core.costmodel import A100, BatchCostModel
        from repro_torch.sim.policies import DynaServePolicy
        from repro_torch.sim.simulator import SimBackend

        cost = BatchCostModel(get_config(cfg.arch), A100)
        if cfg.prefix_cache:
            backend = SimBackend(cost, page_size=cfg.page_size,
                                 pages_per_instance=cfg.pages_per_instance,
                                 prefix_cache=True,
                                 devices_per_instance=cfg.devices_per_instance)
        else:
            backend = SimBackend(
                cost, devices_per_instance=cfg.devices_per_instance)
        policy = DynaServePolicy(cost, cfg.slo)
    return ServeSession(backend, policy, scfg)


# ---------------------------------------------------------------------------
# HTTP plumbing
# ---------------------------------------------------------------------------
_REASONS = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
            404: "Not Found", 405: "Method Not Allowed",
            413: "Payload Too Large", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable"}


def _head(status: int, ctype: str,
          extra: Tuple[Tuple[str, str], ...] = (),
          chunked: bool = False, length: Optional[int] = None) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
             f"Content-Type: {ctype}", "Connection: close"]
    if chunked:
        lines.append("Transfer-Encoding: chunked")
        lines.append("Cache-Control: no-cache")
    elif length is not None:
        lines.append(f"Content-Length: {length}")
    for k, v in extra:
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


def _json_response(status: int, obj,
                   extra: Tuple[Tuple[str, str], ...] = ()) -> bytes:
    body = json.dumps(obj).encode()
    return _head(status, "application/json", extra, length=len(body)) + body


def _error(status: int, message: str, err_type: str = "invalid_request_error",
           extra: Tuple[Tuple[str, str], ...] = ()) -> bytes:
    return _json_response(status, {"error": {
        "message": message, "type": err_type, "code": status}}, extra)


def _chunk(data: bytes) -> bytes:
    return f"{len(data):x}\r\n".encode() + data + b"\r\n"


async def _read_request(reader: asyncio.StreamReader):
    """Parse one HTTP/1.1 request; returns (method, path, headers, body)
    or None on EOF / malformed input."""
    try:
        raw = await reader.readuntil(b"\r\n\r\n")
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
            ConnectionError):
        return None
    if len(raw) > _MAX_HEADER:
        return None
    head = raw.decode("latin-1").split("\r\n")
    parts = head[0].split(" ")
    if len(parts) != 3:
        return None
    method, path = parts[0].upper(), parts[1]
    headers: Dict[str, str] = {}
    for line in head[1:]:
        if not line:
            continue
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    body = b""
    n = int(headers.get("content-length", "0") or "0")
    if n > _MAX_BODY:
        return method, path, headers, None    # caller answers 413
    if n:
        try:
            body = await reader.readexactly(n)
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
    return method, path, headers, body


def encode_prompt(prompt) -> Optional[np.ndarray]:
    """Byte-level 'tokenizer': strings become UTF-8 byte ids (matching
    the repo's engine examples); token-id lists pass through."""
    if isinstance(prompt, str):
        if not prompt:
            return None
        return np.frombuffer(prompt.encode("utf-8"),
                             dtype=np.uint8).astype(np.int32)
    if isinstance(prompt, (list, tuple)):
        if not prompt or not all(isinstance(t, int) for t in prompt):
            return None
        return np.asarray(prompt, dtype=np.int32)
    return None


def _detok(tok: int) -> str:
    return f"{tok} "


def _flatten_chat(messages) -> Optional[str]:
    if not isinstance(messages, list) or not messages:
        return None
    lines = []
    for m in messages:
        if not isinstance(m, dict) or "content" not in m:
            return None
        lines.append(f"{m.get('role', 'user')}: {m['content']}")
    lines.append("assistant:")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------
class ServingServer:
    """Front door process: driver thread + asyncio loop thread.

    ``start()`` returns once the socket is bound (``.port`` then holds
    the real port, also for ``port=0``); ``stop()`` tears down in
    reverse order.  Pass a prebuilt ``session`` to serve a custom
    backend/policy; otherwise ``make_session(cfg)`` builds one.
    """

    def __init__(self, cfg: Optional[ServerConfig] = None, session=None):
        self.cfg = cfg or ServerConfig()
        self.registry = MetricsRegistry()
        self.hub = ServingMetrics(self.registry)
        self.tracer = Tracer(sink=self.cfg.trace_path)
        self.session = session if session is not None \
            else make_session(self.cfg)
        self.recorder = None
        if self.cfg.flight_recorder:
            from repro_torch.serving.flightrecorder import FlightRecorder
            self.recorder = FlightRecorder(
                capacity=self.cfg.recorder_capacity,
                sink=self.cfg.decision_log)
            self.recorder.attach(self.session)
        self.driver = SessionDriver(self.session, hub=self.hub,
                                    tracer=self.tracer,
                                    tick_events=self.cfg.tick_events)
        self.gate = ApiKeyGate(self.cfg.api_keys)
        self.http_requests = self.registry.counter(
            "dynaserve_http_requests_total",
            "HTTP requests by path and status",
            labels=("path", "status"))
        self.http_inflight = self.registry.gauge(
            "dynaserve_http_inflight", "HTTP requests currently being served")
        self.port: Optional[int] = None
        self._t0 = time.monotonic()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None

    # ---------------- lifecycle ----------------
    def start(self) -> "ServingServer":
        self.driver.start()
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="http-loop", daemon=True)
        self._thread.start()
        fut = asyncio.run_coroutine_threadsafe(self._bind(), self._loop)
        self.port = fut.result(timeout=30)
        return self

    async def _bind(self) -> int:
        self._server = await asyncio.start_server(
            self._handle_conn, host=self.cfg.host, port=self.cfg.port)
        return self._server.sockets[0].getsockname()[1]

    def stop(self) -> None:
        if self._loop is not None:
            async def _close():
                if self._server is not None:
                    self._server.close()
                    await self._server.wait_closed()
            asyncio.run_coroutine_threadsafe(_close(), self._loop).result(
                timeout=10)
            self._loop.call_soon_threadsafe(self._loop.stop)
            if self._thread is not None:
                self._thread.join(timeout=10)
            self._loop.close()
            self._loop = self._thread = self._server = None
        self.driver.stop()
        if self.recorder is not None:
            self.recorder.close()

    def serve_forever(self) -> None:
        """Blocking run (the ``--http`` launcher); Ctrl-C to stop."""
        if self._loop is None:
            self.start()
        try:
            while True:
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    # ---------------- connection handling ----------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        path = "?"
        status = 500
        self.http_inflight.inc()
        try:
            parsed = await _read_request(reader)
            if parsed is None:
                return
            method, target, headers, body = parsed
            path = target.split("?", 1)[0]
            status = await self._route(method, path, headers, body,
                                       reader, writer)
            try:
                await writer.drain()
            except (ConnectionError, OSError):
                pass
        except (ConnectionError, OSError):
            pass
        except Exception as e:                       # defensive: 500, not drop
            try:
                writer.write(_error(500, f"{type(e).__name__}: {e}",
                                    "server_error"))
            except Exception:
                pass
        finally:
            self.http_inflight.dec()
            self.http_requests.inc(path=path, status=str(status))
            try:
                writer.close()
            except Exception:
                pass

    async def _route(self, method: str, path: str, headers, body,
                     reader, writer) -> int:
        if body is None:
            writer.write(_error(413, "request body too large"))
            return 413
        if path == "/healthz":
            if method != "GET":
                writer.write(_error(405, "GET only"))
                return 405
            if self.driver.fatal is not None:
                writer.write(_json_response(503, {
                    "status": "down", "error": self.driver.fatal}))
                return 503
            writer.write(_json_response(200, {
                "status": "ok", "backend": self.cfg.backend,
                "model": self.cfg.model,
                "uptime_s": round(time.monotonic() - self._t0, 3)}))
            return 200
        if path == "/metrics":
            text = self.registry.render().encode()
            writer.write(_head(
                200, "text/plain; version=0.0.4; charset=utf-8",
                length=len(text)) + text)
            return 200
        if path in ("/debug/attribution", "/debug/trace"):
            if method != "GET":
                writer.write(_error(405, "GET only"))
                return 405
            if self.recorder is None:
                writer.write(_error(404, "flight recorder disabled "
                                         "(cfg.flight_recorder=False)"))
                return 404
            events = self.recorder.events()
            if path == "/debug/attribution":
                from repro_torch.serving.attribution import analyze, publish
                report = analyze(events)
                publish(report, self.registry)
                writer.write(_json_response(
                    200, report.to_json(include_requests=False)))
            else:
                from repro_torch.serving.flightrecorder import to_chrome_trace
                writer.write(_json_response(200, to_chrome_trace(events)))
            return 200
        if path == "/v1/models":
            writer.write(_json_response(200, {
                "object": "list",
                "data": [{"id": self.cfg.model, "object": "model",
                          "owned_by": "dynaserve"}]}))
            return 200
        if path in ("/v1/completions", "/v1/chat/completions"):
            if method != "POST":
                writer.write(_error(405, "POST only"))
                return 405
            return await self._completion(path, headers, body,
                                          reader, writer)
        writer.write(_error(404, f"no route for {path}"))
        return 404

    # ---------------- the completion endpoints ----------------
    async def _completion(self, path: str, headers, body,
                          reader, writer) -> int:
        chat = path.endswith("/chat/completions")
        status, err, key = self.gate.acquire(headers.get("authorization"))
        if status != 200:
            writer.write(_error(
                status, err,
                "authentication_error" if status == 401 else "rate_limit_error"))
            return status
        try:
            return await self._completion_inner(chat, body, reader, writer)
        finally:
            self.gate.release(key)

    async def _completion_inner(self, chat: bool, body, reader,
                                writer) -> int:
        try:
            req = json.loads(body.decode("utf-8")) if body else {}
        except (ValueError, UnicodeDecodeError):
            writer.write(_error(400, "body is not valid JSON"))
            return 400
        if not isinstance(req, dict):
            writer.write(_error(400, "body must be a JSON object"))
            return 400
        if chat:
            prompt = _flatten_chat(req.get("messages"))
            if prompt is None:
                writer.write(_error(400, "messages must be a non-empty list "
                                         "of {role, content} objects"))
                return 400
        else:
            prompt = req.get("prompt")
        tokens = encode_prompt(prompt)
        if tokens is None:
            writer.write(_error(400, "prompt must be a non-empty string or "
                                     "list of token ids"))
            return 400
        try:
            max_new = int(req.get("max_tokens", 16))
        except (TypeError, ValueError):
            writer.write(_error(400, "max_tokens must be an integer"))
            return 400
        if max_new < 1:
            writer.write(_error(400, "max_tokens must be >= 1"))
            return 400
        max_new = min(max_new, self.cfg.max_tokens_cap)
        if (self.cfg.backend == "engine"
                and len(tokens) + max_new + 8 > self.cfg.engine_max_len):
            writer.write(_error(400, f"prompt + max_tokens exceeds engine "
                                     f"context ({self.cfg.engine_max_len})"))
            return 400
        slo: Optional[SLOClass] = None
        if "slo" in req:
            slo = SLO_CLASSES.get(str(req["slo"]).lower())
            if slo is None:
                writer.write(_error(400, f"unknown slo class {req['slo']!r}; "
                                         f"one of {sorted(SLO_CLASSES)}"))
                return 400
        stream = bool(req.get("stream", False))

        loop = asyncio.get_running_loop()
        events: asyncio.Queue = asyncio.Queue()

        def on_event(*ev):
            try:
                loop.call_soon_threadsafe(events.put_nowait, ev)
            except RuntimeError:
                pass                       # loop already closed (shutdown)

        try:
            rid, _sub = self.driver.submit(
                prompt=tokens, max_new_tokens=max_new, slo=slo,
                on_event=on_event)
        except RuntimeError as e:          # driver down
            writer.write(_error(503, str(e), "server_error"))
            return 503
        trace_id = f"trace-{uuid.uuid4().hex[:16]}"
        self.tracer.register(rid, trace_id)
        hdrs = (("x-request-id", rid), ("x-trace-id", trace_id))
        if stream:
            return await self._stream_response(chat, rid, trace_id, max_new,
                                               events, reader, writer, hdrs)
        return await self._unary_response(chat, rid, max_new, len(tokens),
                                          events, reader, writer, hdrs)

    async def _next_event(self, events: asyncio.Queue, monitor: dict,
                          reader: asyncio.StreamReader):
        """Wait for the next driver event, racing the connection monitor;
        returns the event tuple or ``("disconnect",)``."""
        get = asyncio.ensure_future(events.get())
        while True:
            mon = monitor.get("task")
            if mon is None:
                mon = monitor["task"] = asyncio.ensure_future(
                    reader.read(4096))
            done, _ = await asyncio.wait(
                {get, mon}, return_when=asyncio.FIRST_COMPLETED)
            if get in done:
                return get.result()
            monitor["task"] = None
            try:
                data = mon.result()
            except (ConnectionError, OSError):
                data = b""
            if not data:                   # EOF: client went away
                get.cancel()
                return ("disconnect",)
            # stray bytes after the request body: ignore and re-arm

    @staticmethod
    def _finish_reason(n_tokens: int, max_new: int) -> str:
        return "length" if n_tokens >= max_new else "stop"

    def _unary_payload(self, chat: bool, rid: str, text: str,
                       n_prompt: int, n_out: int, reason: str) -> dict:
        created = int(time.time())
        usage = {"prompt_tokens": n_prompt, "completion_tokens": n_out,
                 "total_tokens": n_prompt + n_out}
        if chat:
            return {"id": f"chatcmpl-{rid}", "object": "chat.completion",
                    "created": created, "model": self.cfg.model,
                    "choices": [{"index": 0, "finish_reason": reason,
                                 "message": {"role": "assistant",
                                             "content": text}}],
                    "usage": usage}
        return {"id": f"cmpl-{rid}", "object": "text_completion",
                "created": created, "model": self.cfg.model,
                "choices": [{"index": 0, "text": text,
                             "finish_reason": reason}],
                "usage": usage}

    def _sse_payload(self, chat: bool, rid: str, piece: Optional[str],
                     reason: Optional[str]) -> bytes:
        created = int(time.time())
        if chat:
            delta = {} if piece is None else {"content": piece}
            obj = {"id": f"chatcmpl-{rid}", "object": "chat.completion.chunk",
                   "created": created, "model": self.cfg.model,
                   "choices": [{"index": 0, "delta": delta,
                                "finish_reason": reason}]}
        else:
            obj = {"id": f"cmpl-{rid}", "object": "text_completion",
                   "created": created, "model": self.cfg.model,
                   "choices": [{"index": 0, "text": piece or "",
                                "finish_reason": reason}]}
        return f"data: {json.dumps(obj)}\n\n".encode()

    async def _unary_response(self, chat: bool, rid: str, max_new: int,
                              n_prompt: int, events, reader, writer,
                              hdrs) -> int:
        monitor: dict = {}
        pieces: List[str] = []
        try:
            while True:
                ev = await self._next_event(events, monitor, reader)
                kind = ev[0]
                if kind == "token":
                    pieces.append(_detok(ev[1]))
                elif kind == "disconnect":
                    self.driver.cancel(rid)
                    return 499             # nginx's client-closed-request
                elif kind == "error":
                    writer.write(_error(500, ev[1], "server_error", hdrs))
                    return 500
                elif kind == "done":
                    outcome, tokens = ev[1], ev[2]
                    if outcome == "rejected":
                        writer.write(_error(
                            503, "rejected by admission control (predicted "
                                 "TTFT exceeds the class SLO)",
                            "overloaded_error", hdrs))
                        return 503
                    if outcome == "cancelled":
                        writer.write(_error(500, "request cancelled",
                                            "server_error", hdrs))
                        return 500
                    text = "".join(pieces)
                    reason = self._finish_reason(len(tokens), max_new)
                    writer.write(_json_response(
                        200, self._unary_payload(
                            chat, rid, text, n_prompt, len(tokens), reason),
                        hdrs))
                    return 200
        finally:
            mon = monitor.get("task")
            if mon is not None:
                mon.cancel()

    async def _stream_response(self, chat: bool, rid: str, trace_id: str,
                               max_new: int, events, reader, writer,
                               hdrs) -> int:
        monitor: dict = {}
        sent_head = False
        n_sent = 0
        try:
            while True:
                ev = await self._next_event(events, monitor, reader)
                kind = ev[0]
                if kind == "disconnect":
                    self.driver.cancel(rid)
                    return 499
                if kind == "error":
                    if not sent_head:
                        writer.write(_error(500, ev[1], "server_error", hdrs))
                        return 500
                    writer.write(_chunk(b"data: [DONE]\n\n") + b"0\r\n\r\n")
                    return 200
                if kind == "done" and ev[1] == "rejected" and not sent_head:
                    writer.write(_error(
                        503, "rejected by admission control (predicted "
                             "TTFT exceeds the class SLO)",
                        "overloaded_error", hdrs))
                    return 503
                if not sent_head:
                    writer.write(_head(200, "text/event-stream", hdrs,
                                       chunked=True))
                    sent_head = True
                if kind == "token":
                    writer.write(_chunk(self._sse_payload(
                        chat, rid, _detok(ev[1]), None)))
                    n_sent += 1
                    if events.empty():
                        try:
                            await writer.drain()
                        except (ConnectionError, OSError):
                            self.driver.cancel(rid)
                            return 499
                elif kind == "done":
                    reason = ("stop" if ev[1] == "cancelled"
                              else self._finish_reason(len(ev[2]), max_new))
                    writer.write(_chunk(self._sse_payload(
                        chat, rid, None, reason)))
                    writer.write(_chunk(b"data: [DONE]\n\n") + b"0\r\n\r\n")
                    return 200
        except (ConnectionError, OSError):
            self.driver.cancel(rid)
            return 499
        finally:
            mon = monitor.get("task")
            if mon is not None:
                mon.cancel()
