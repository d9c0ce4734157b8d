"""The thread that owns a ``ServeSession``.

``ServeSession`` is deliberately single-threaded — one event loop, no
locks — so a concurrent front door cannot call it directly.  The
``SessionDriver`` puts the session on its own thread and exposes a
thread-safe command surface:

* ``submit(...)`` enqueues a request and returns ``(rid, Subscription)``
  immediately; the subscription's ``on_event`` callback fires **on the
  driver thread** with ``("token", tok)`` per streamed token, then one
  terminal ``("done", outcome, tokens)`` or ``("error", message)``.
  The HTTP layer bridges these into its asyncio loop with
  ``call_soon_threadsafe``.
* ``cancel(rid)`` aborts an in-flight request (client disconnects).
* ``call(fn)`` runs ``fn(session)`` on the driver thread and returns
  its result — the only safe way to inspect session state from outside
  (tests, the capacity benchmark's ``session.metrics()`` pull).

The loop interleaves three duties: drain commands, pump up to
``tick_events`` session events, flush newly arrived tokens to
subscribers.  A small ``tick_events`` bounds how far the simulator (which
would otherwise race to completion in zero wall time) runs between
command drains — that is what makes mid-stream cancellation
deterministic in tests.  When idle it blocks on the command queue, so an
idle server burns no CPU.
"""
from __future__ import annotations

import queue
import threading
import traceback
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.request import SLOClass

__all__ = ["Subscription", "SessionDriver"]


class Subscription:
    """One submitted request, as seen from outside the driver thread."""

    __slots__ = ("rid", "on_event", "handle", "sent", "closed")

    def __init__(self, rid: str, on_event: Callable[..., None]):
        self.rid = rid
        self.on_event = on_event
        self.handle = None          # ServeHandle, set on the driver thread
        self.sent = 0               # tokens already delivered
        self.closed = False

    def _emit(self, *event) -> None:
        if self.closed:
            return
        if event[0] in ("done", "error"):
            self.closed = True
        try:
            self.on_event(*event)
        except Exception:
            # a broken subscriber must not take the session down
            self.closed = True


class SessionDriver:
    """Owns a ``ServeSession`` on a dedicated thread (see module doc)."""

    def __init__(self, session, hub=None, tracer=None,
                 tick_events: int = 256, sample_every: int = 4,
                 idle_wait: float = 0.05):
        self.session = session
        self.hub = hub
        self.tracer = tracer
        if hub is not None:
            session.observers.append(hub)
        if tracer is not None:
            session.observers.append(tracer)
        self.tick_events = max(1, int(tick_events))
        self.sample_every = max(1, int(sample_every))
        self.idle_wait = float(idle_wait)
        self._cmds: "queue.Queue[Tuple[str, tuple]]" = queue.Queue()
        self._subs: Dict[str, Subscription] = {}
        self._rid_seq = 0
        self._rid_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ticks = 0
        self.fatal: Optional[str] = None

    # ---------------- public, thread-safe surface ----------------
    def start(self) -> "SessionDriver":
        if self._thread is not None:
            raise RuntimeError("driver already started")
        self._thread = threading.Thread(target=self._run,
                                        name="session-driver", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._cmds.put(("noop", ()))
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def submit(self, *, prompt=None, prompt_len: Optional[int] = None,
               max_new_tokens: Optional[int] = None,
               decode_len: Optional[int] = None,
               slo: Optional[SLOClass] = None,
               on_event: Callable[..., None] = lambda *e: None,
               ) -> Tuple[str, Subscription]:
        """Enqueue one request; returns its pre-allocated rid at once."""
        if self.fatal is not None:
            raise RuntimeError(f"session driver is down: {self.fatal}")
        with self._rid_lock:
            self._rid_seq += 1
            rid = f"http-{self._rid_seq}"
        sub = Subscription(rid, on_event)
        self._cmds.put(("submit", (rid, sub, prompt, prompt_len,
                                   max_new_tokens, decode_len, slo)))
        return rid, sub

    def cancel(self, rid: str) -> None:
        self._cmds.put(("cancel", (rid,)))

    def call(self, fn: Callable[[object], object], timeout: float = 30.0):
        """Run ``fn(session)`` on the driver thread; return its result."""
        box: "queue.Queue[tuple]" = queue.Queue(maxsize=1)
        self._cmds.put(("call", (fn, box)))
        kind, val = box.get(timeout=timeout)
        if kind == "err":
            raise val
        return val

    # ---------------- driver thread ----------------
    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                worked = self._drain_commands()
                worked |= self._tick()
                self._flush()
                self._ticks += 1
                if self.hub is not None and \
                        self._ticks % self.sample_every == 0:
                    self.hub.sample(self.session)
                if not worked:
                    try:
                        cmd = self._cmds.get(timeout=self.idle_wait)
                        self._do(cmd)
                    except queue.Empty:
                        pass
        except BaseException as e:          # fail loudly, not silently
            self.fatal = f"{type(e).__name__}: {e}"
            traceback.print_exc()
            for sub in list(self._subs.values()):
                sub._emit("error", self.fatal)
            self._subs.clear()
        finally:
            if self.hub is not None:
                try:
                    self.hub.sample(self.session)
                except Exception:
                    pass

    def _drain_commands(self) -> bool:
        worked = False
        while True:
            try:
                cmd = self._cmds.get_nowait()
            except queue.Empty:
                return worked
            worked = True
            self._do(cmd)

    def _do(self, cmd: Tuple[str, tuple]) -> None:
        kind, args = cmd
        if kind == "submit":
            rid, sub, prompt, prompt_len, max_new, decode_len, slo = args
            try:
                sub.handle = self.session.generate(
                    prompt=prompt, prompt_len=prompt_len,
                    max_new_tokens=max_new, decode_len=decode_len,
                    slo=slo, rid=rid)
            except Exception as e:
                sub._emit("error", f"{type(e).__name__}: {e}")
                return
            self._subs[rid] = sub
        elif kind == "cancel":
            (rid,) = args
            self.session.cancel(rid)    # False for unknown/terminal: fine
        elif kind == "call":
            fn, box = args
            try:
                box.put(("ok", fn(self.session)))
            except Exception as e:
                box.put(("err", e))
        # "noop": wakeup only

    def _tick(self) -> bool:
        pumped = 0
        while pumped < self.tick_events and self.session._pump():
            pumped += 1
        return pumped > 0

    def _flush(self) -> None:
        done: List[str] = []
        for rid, sub in self._subs.items():
            h = sub.handle
            toks = h.tokens
            while sub.sent < len(toks):
                sub._emit("token", toks[sub.sent])
                sub.sent += 1
            if h.req.terminal:
                sub._emit("done", h.req.state, list(toks))
                done.append(rid)
        for rid in done:
            self._subs.pop(rid, None)
