"""Engine-backed serving cluster: DynaServe's two-level scheduler driving
torch engines, through the ``ServeSession`` event loop
(``repro_torch.core.session``).  Mirrors ``repro.engine.cluster``.

``ServingCluster`` is a thin convenience wrapper that wires an
``EngineBackend`` + a policy into a session and keeps the seed-era
surface alive for existing callers:

* ``submit(prompt, max_new_tokens)`` -> streaming ``ServeHandle``
  (the old blocking pattern still works: ``run_until_done(handles)``)
* ``attach_instance`` / ``drain_instance`` — elastic pool lifecycle
* ``cancel(rid)`` — frees slots and aborts pending beta handoffs

New code should use ``session.generate(...)`` and iterate the handle.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.costmodel import HardwareSpec
from repro_torch.core.request import SLOClass
from repro_torch.core.session import (
    ServeHandle, ServeSession, SessionConfig, SessionStallError,
)
from repro_torch.engine.backend import H100, EngineBackend
from repro_torch.models.config import ModelConfig

# compat alias: the old engine returned LiveRequest objects; handles
# expose the same ``.req`` / ``.generated`` surface
LiveRequest = ServeHandle


class ServingCluster:
    """N unified instances + DynaServe APS, on real engines.

    The pool is elastic: ``attach_instance`` adds a member between
    batches and ``drain_instance`` retires one without dropping work —
    the drained engine finishes its queue (it still receives beta
    handoffs already committed to it), stops receiving placements, and
    is detached once idle.

    ``prefill_budget`` is the per-batch chunk of the non-SLO-aware
    colocation arm (``split=False``); the split path sizes batches with
    the SLO-aware local scheduler instead.
    """

    def __init__(self, cfg: ModelConfig, params, n_instances: int = 2,
                 n_slots: int = 8, max_len: int = 512,
                 prefill_budget: int = 64, transfer_chunk: int = 32,
                 split: bool = True, hw: HardwareSpec = H100,
                 slo: float = 0.100, admission: bool = False,
                 default_slo: Optional[SLOClass] = None,
                 prefix_cache: bool = False,
                 overlap: Optional[bool] = None):
        from repro_torch.sim.policies import ColocationPolicy, DynaServePolicy
        self.backend = EngineBackend(cfg, params, n_slots, max_len, hw,
                                     transfer_chunk,
                                     prefix_cache=prefix_cache)
        if split:
            self.policy = DynaServePolicy(self.backend.cost, slo,
                                          transfer_chunk=transfer_chunk)
            self.gs = self.policy.gs
        else:
            self.policy = ColocationPolicy(chunk=prefill_budget,
                                           slo_aware=False)
            self.gs = None
        self.session = ServeSession(self.backend, self.policy, SessionConfig(
            n_instances=n_instances, slo=slo, admission=admission,
            default_slo=default_slo, overlap=overlap))

    # ---------------- elastic pool lifecycle ----------------
    @property
    def engines(self):
        return self.backend.engines

    @property
    def draining(self) -> set:
        return {i.iid for i in self.session.instances
                if i.draining and not i.retired}

    def active_ids(self) -> List[int]:
        return sorted(i.iid for i in self.session.active_instances())

    def attach_instance(self) -> int:
        """Scale up: add a fresh engine; it joins placement immediately."""
        return self.session.add_instance().iid

    def drain_instance(self, eid: int) -> None:
        """Scale down: exclude ``eid`` from new placements; the engine is
        detached once its queue and pending handoffs empty (the last
        live engine's drain is cancelled instead)."""
        self.session.drain_instance(eid)

    # ---------------- serving ----------------
    @property
    def kv_bytes_moved(self) -> int:
        return self.backend.kv_bytes_moved

    def submit(self, prompt, max_new_tokens: int,
               rid: Optional[str] = None,
               slo: Optional[SLOClass] = None) -> ServeHandle:
        return self.session.generate(prompt, max_new_tokens, rid=rid,
                                     slo=slo)

    def cancel(self, rid: str) -> bool:
        return self.session.cancel(rid)

    def run_until_done(self, reqs: Sequence[ServeHandle],
                       max_iters: int = 100_000) -> None:
        """Blocking drain of the given handles (legacy surface; iterate
        the handles for streaming delivery instead)."""
        for _ in range(max_iters):
            if all(h.done for h in reqs):
                return
            if not self.session._pump():
                if all(h.done for h in reqs):
                    return
                raise SessionStallError("cluster stalled with pending work")
        raise SessionStallError(f"not done after {max_iters} events")
