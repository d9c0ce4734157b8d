"""Production front door: OpenAI-compatible streaming HTTP serving over
``ServeSession``, with a Prometheus metrics surface and per-request
tracing.  Dependency-free by design — the project depends only on
numpy + jax, so the HTTP layer is stdlib ``asyncio`` and the metrics
registry renders the Prometheus text format itself.

Layers (each usable on its own):

* ``repro_torch.serving.metrics`` — counters/gauges/histograms + the
  ``ServingMetrics`` hub that observes a session and samples backend
  gauges (exposed at ``GET /metrics``).
* ``repro_torch.serving.tracing`` — per-request span timelines
  (queued→admitted→placed→prefill→handoff→decode→finish) emitted as
  JSON lines; the ``trace_id`` rides on every HTTP response.
* ``repro_torch.serving.driver`` — the ``SessionDriver`` thread that owns the
  (single-threaded) ``ServeSession`` and fans tokens out to subscribers.
* ``repro_torch.serving.http`` — the asyncio front door: ``/v1/completions``
  and ``/v1/chat/completions`` with SSE streaming, ``/healthz``,
  ``/metrics``, per-API-key admission, cancel-on-disconnect.
* ``repro_torch.serving.loadgen`` — closed-loop HTTP load generator (the
  capacity benchmark's client; ``--smoke --self-serve`` is the CI job).
"""
from repro_torch.serving.driver import SessionDriver
from repro_torch.serving.http import ApiKeyGate, KeyQuota, ServingServer
from repro_torch.serving.metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, ServingMetrics,
)
from repro_torch.serving.tracing import Tracer

__all__ = [
    "ApiKeyGate", "Counter", "Gauge", "Histogram", "KeyQuota",
    "MetricsRegistry", "ServingMetrics", "SessionDriver", "ServingServer",
    "Tracer",
]
