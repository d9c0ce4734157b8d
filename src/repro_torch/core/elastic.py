"""Elastic instance-pool controller (the paper's *elastic execution*).

DynaServe's unified instances are supposed to absorb workload shifts that
break both colocated and disaggregated deployments.  This module supplies
the control loop that makes the pool elastic:

  * **Load monitoring** — per-instance predicted drain times (the same
    ``ExecutionPredictor`` quantity Algorithm 1 probes) are EWMA-smoothed
    into a pool-level load signal.
  * **Workload-shift detection** — an EWMA of the arriving prefill/decode
    token mix tracks drift between prefill-heavy (AzureCode-like) and
    decode-heavy (reasoning-like) regimes; queue-depth imbalance between
    instances flags skewed placement.
  * **Actuation** — the controller emits declarative ``PoolAction``s:
    scale the pool up/down within ``[min_instances, max_instances]``,
    drift per-instance *role bias* (unified <-> prefill-heavy <->
    decode-heavy, consumed by the local scheduler's batch composition and
    the global scheduler's pair picking), and migrate queued
    micro-requests off hot instances (the KV move is costed with
    ``plan_chunked_transfer``).

The controller is substrate-agnostic: it consumes ``InstanceStat``
snapshots and returns actions.  ``repro_torch.sim.policies.ElasticDynaServePolicy``
applies them to the discrete-event simulator; ``repro_torch.engine.cluster``
applies the attach/drain subset to real JAX engines.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Knobs of the elastic control loop (all times in seconds)."""
    min_instances: int = 1
    max_instances: int = 8
    check_interval: float = 1.0        # period of the pool-control loop
    # --- load signal ---
    load_ewma_alpha: float = 0.5       # smoothing of the avg-drain signal
    mix_ewma_alpha: float = 0.2        # smoothing of the prefill-fraction signal
    # --- scaling thresholds ---
    scale_up_drain: float = 1.5        # avg predicted drain (s) triggering scale-up
    scale_down_drain: float = 0.45     # avg predicted drain (s) triggering drain
    # KV memory pressure (fraction of the page pool in use) triggering
    # scale-up regardless of drain time — a pool can be latency-healthy
    # yet about to run out of pages for its resident decodes.  Scale-down
    # and migration *into* a member are vetoed above this level.
    scale_up_pressure: float = 0.85
    # a pool whose total queued micro-requests fit comfortably on one
    # fewer instance also consolidates (predicted drain alone cannot see
    # sparseness: one long decode tail pins it at seconds)
    queue_low_watermark: int = 2       # queued micros per remaining instance
    scale_up_cooldown: float = 1.0
    scale_down_cooldown: float = 3.0
    # --- rebalancing ---
    rebalance_ratio: float = 4.0       # hot/cold drain ratio triggering migration
    rebalance_slack: float = 0.5       # absolute drain gap (s) required as well
    migrate_max: int = 4               # micro-requests moved per check
    # --- role drift ---
    bias_drift: float = 0.3            # per-check drift rate toward the target bias
    bias_span: float = 1.0             # |role bias| cap; 2**bias scales prefill budget
    # --- width elasticity (devices per instance) ---
    # >1 lets the controller trade pool width against shard width: when
    # the pool is loaded but already at max_instances, two narrow
    # members merge into one sharded (TP=2x) instance; when load
    # subsides, a wide member splits back into narrow ones.  The
    # default of 1 disables width trades entirely.
    max_devices_per_instance: int = 1
    widen_drain: Optional[float] = None  # load (s) triggering a merge; None = scale_up_drain
    widen_cooldown: float = 3.0          # min seconds between width trades


@dataclasses.dataclass
class InstanceStat:
    """Snapshot of one pool member, as the controller sees it."""
    iid: int
    drain_time: float                  # predicted seconds to empty the queue
    queued_prefill_tokens: int
    queued_decode_tokens: int
    n_queued: int                      # queued micro-requests (movable work)
    draining: bool
    role_bias: float
    mem_pressure: float = 0.0          # KV page-pool occupancy in [0, 1]
    devices: int = 1                   # shard width (devices per instance)


# ---------------------------------------------------------------------------
# Declarative pool actions
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ScaleUp:
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class DrainInstance:
    iid: int
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class MigrateWork:
    src: int
    dst: int
    max_micros: int
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class SetRoleBias:
    iid: int
    bias: float


@dataclasses.dataclass(frozen=True)
class MergeInstances:
    """Drain ``donors`` and attach one ``devices``-wide sharded instance
    in their place (a pool-width -> shard-width trade)."""
    donors: Tuple[int, ...]
    devices: int
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class SplitInstance:
    """Drain the wide member ``iid`` and attach two ``devices``-wide
    (usually 1-device) instances in its place."""
    iid: int
    devices: int
    reason: str = ""


PoolAction = Union[ScaleUp, DrainInstance, MigrateWork, SetRoleBias,
                   MergeInstances, SplitInstance]


class PoolController:
    """Turns pool snapshots into scale/drain/migrate/bias actions."""

    def __init__(self, cfg: Optional[ElasticConfig] = None):
        self.cfg = cfg or ElasticConfig()
        self._load: Optional[float] = None      # EWMA avg drain (s)
        self._mix: Optional[float] = None       # EWMA prefill token fraction
        self._last_up = -math.inf
        self._last_down = -math.inf
        self._last_width = -math.inf
        # the signal snapshot behind the most recent decide() call —
        # recorded alongside each pool action by the flight recorder so
        # scale events carry the evidence they were based on
        self.last_signals: dict = {}

    # ------------------------------------------------------------------
    # signals
    # ------------------------------------------------------------------
    def observe_arrival(self, prefill_tokens: int, decode_tokens: int) -> None:
        """Feed the arriving request's token mix into the shift detector."""
        total = prefill_tokens + decode_tokens
        if total <= 0:
            return
        f = prefill_tokens / total
        a = self.cfg.mix_ewma_alpha
        self._mix = f if self._mix is None else (1 - a) * self._mix + a * f

    @property
    def load(self) -> float:
        return self._load if self._load is not None else 0.0

    @property
    def prefill_fraction(self) -> Optional[float]:
        return self._mix

    @property
    def target_bias(self) -> float:
        """Pool-wide role-bias target in [-bias_span, +bias_span].

        The neutral point is the balanced mix (prefill fraction 0.5);
        AzureCode-like traffic (fraction -> 1) drifts instances
        prefill-heavy, reasoning-like traffic (fraction -> 0) drifts them
        decode-heavy.
        """
        if self._mix is None:
            return 0.0
        g = (2.0 * self._mix - 1.0) * self.cfg.bias_span
        return max(-self.cfg.bias_span, min(self.cfg.bias_span, g))

    # ------------------------------------------------------------------
    # decision
    # ------------------------------------------------------------------
    def decide(self, stats: Sequence[InstanceStat],
               now: float) -> List[PoolAction]:
        cfg = self.cfg
        actions: List[PoolAction] = []
        active = [s for s in stats if not s.draining]
        n_active = len(active)

        if not active:
            self.last_signals = {"load": self.load, "mix": self._mix,
                                 "n_active": 0, "total_queued": 0,
                                 "max_pressure": 0.0}
            if len(stats) < cfg.max_instances:
                self._last_up = now
                return [ScaleUp("pool empty")]
            return []

        avg_drain = sum(s.drain_time for s in active) / n_active
        a = cfg.load_ewma_alpha
        self._load = avg_drain if self._load is None \
            else (1 - a) * self._load + a * avg_drain

        # ---- scale up / down (with hysteresis via distinct thresholds
        # and cooldowns so a single burst can't thrash the pool) ----
        total_queued = sum(s.n_queued for s in active)
        low_load = self._load < cfg.scale_down_drain
        sparse = total_queued <= (n_active - 1) * cfg.queue_low_watermark
        # growth needs enough queued work to occupy another instance;
        # otherwise a long decode tail (which pins the drain EWMA high)
        # would flap against the sparse-consolidation rule
        has_backlog = total_queued > n_active * cfg.queue_low_watermark
        # still-draining members count toward the cap (they hold resources
        # until retired); the applier un-drains one instead of attaching,
        # so the pool never runs more than max_instances concurrently
        draining_iids = {s.iid for s in stats if s.draining}
        max_pressure = max((s.mem_pressure for s in active), default=0.0)
        self.last_signals = {"load": self._load, "mix": self._mix,
                             "n_active": n_active,
                             "total_queued": total_queued,
                             "max_pressure": max_pressure}
        pressured = max_pressure > cfg.scale_up_pressure
        scaled_up = False
        scaled_down = False
        if (((self._load > cfg.scale_up_drain and has_backlog) or pressured)
                and n_active < cfg.max_instances
                and now - self._last_up >= cfg.scale_up_cooldown):
            self._last_up = now
            scaled_up = True
            why = (f"KV pressure {max_pressure:.0%} > "
                   f"{cfg.scale_up_pressure:.0%}" if pressured and not
                   (self._load > cfg.scale_up_drain and has_backlog)
                   else f"load {self._load:.2f}s > "
                        f"{cfg.scale_up_drain:.2f}s")
            actions.append(ScaleUp(why))
        elif ((low_load or (sparse and self._load <= cfg.scale_up_drain))
                and not pressured
                and n_active > cfg.min_instances
                and now - self._last_down >= cfg.scale_down_cooldown):
            # sparse alone may not drain an overloaded pool: a few heavy
            # requests read as "sparse" by count while drains are long
            victim = min(active, key=lambda s: (s.drain_time, s.n_queued))
            self._last_down = now
            scaled_down = True
            why = (f"load {self._load:.2f}s < {cfg.scale_down_drain:.2f}s"
                   if low_load else
                   f"{total_queued} queued fit on {n_active - 1} instances")
            actions.append(DrainInstance(victim.iid, why))
            draining_iids.add(victim.iid)
            active = [s for s in active if s.iid != victim.iid]
            n_active -= 1

        # ---- width <-> count trades.  A pool pinned at max_instances
        # with sustained backlog cannot ScaleUp; if width elasticity is
        # enabled, merge the two least-loaded equal-width members into
        # one sharded instance twice as wide (per-pass latency drops by
        # roughly the TP speedup, so the *pool* regains headroom without
        # new devices).  When load subsides and member slots are free
        # again, split the least-loaded wide member back into narrow
        # ones to recover placement parallelism. ----
        if cfg.max_devices_per_instance > 1:
            widen_at = (cfg.widen_drain if cfg.widen_drain is not None
                        else cfg.scale_up_drain)
            if (not scaled_up and not scaled_down
                    and self._load > widen_at and has_backlog
                    and n_active >= cfg.max_instances
                    and now - self._last_width >= cfg.widen_cooldown):
                by_width: dict = {}
                for s in active:
                    by_width.setdefault(s.devices, []).append(s)
                for w in sorted(by_width):
                    group = by_width[w]
                    if len(group) < 2 or 2 * w > cfg.max_devices_per_instance:
                        continue
                    donors = sorted(group, key=lambda s:
                                    (s.drain_time, s.n_queued))[:2]
                    self._last_width = now
                    actions.append(MergeInstances(
                        (donors[0].iid, donors[1].iid), 2 * w,
                        f"pool at {n_active}/{cfg.max_instances} members, "
                        f"load {self._load:.2f}s > {widen_at:.2f}s: "
                        f"merging two {w}-device members into one "
                        f"{2 * w}-device instance"))
                    # donors drain now; the evacuation loop below moves
                    # their queued work onto surviving members
                    for d in donors:
                        draining_iids.add(d.iid)
                    active = [s for s in active
                              if s.iid not in (donors[0].iid, donors[1].iid)]
                    n_active -= 2
                    break
            elif (not scaled_up and not scaled_down
                    and low_load and not pressured
                    and n_active < cfg.max_instances
                    and now - self._last_width >= cfg.widen_cooldown):
                wide = [s for s in active if s.devices > 1]
                if wide:
                    victim = min(wide, key=lambda s:
                                 (s.drain_time, s.n_queued))
                    self._last_width = now
                    actions.append(SplitInstance(
                        victim.iid, max(1, victim.devices // 2),
                        f"load {self._load:.2f}s < "
                        f"{cfg.scale_down_drain:.2f}s: splitting the "
                        f"{victim.devices}-device member into two"))
                    draining_iids.add(victim.iid)
                    active = [s for s in active if s.iid != victim.iid]
                    n_active -= 1

        # ---- migrate work off draining members (including the one just
        # picked above) so they can retire.  Skipped on a scale-up round:
        # the applier un-drains a draining member first, and evacuating
        # the instance we just decided to keep would be self-defeating.
        # Members over the KV-pressure threshold are never migration
        # targets (their page pool cannot hold the incoming state) ----
        def _coldness(s: InstanceStat):
            return (s.mem_pressure > cfg.scale_up_pressure, s.drain_time)

        cold = min(active, key=_coldness) if active else None
        if cold is not None and cold.mem_pressure > cfg.scale_up_pressure:
            cold = None               # every live member is pressured
        if not scaled_up:
            for s in stats:
                if (s.iid in draining_iids and s.n_queued > 0
                        and cold is not None):
                    actions.append(MigrateWork(
                        s.iid, cold.iid, min(s.n_queued, cfg.migrate_max),
                        "evacuating draining instance"))

        # ---- rebalance queue-depth imbalance between live members ----
        if n_active >= 2:
            hot = max(active, key=lambda s: s.drain_time)
            cold = min(active, key=_coldness)
            if (hot.iid != cold.iid and hot.n_queued > 1
                    and cold.mem_pressure <= cfg.scale_up_pressure
                    and hot.drain_time > cfg.rebalance_ratio * cold.drain_time
                    and hot.drain_time - cold.drain_time > cfg.rebalance_slack):
                actions.append(MigrateWork(
                    hot.iid, cold.iid, cfg.migrate_max,
                    f"imbalance {hot.drain_time:.2f}s vs "
                    f"{cold.drain_time:.2f}s"))

        # ---- drift role bias toward the observed workload mix ----
        g = self.target_bias
        for s in active:
            nb = s.role_bias + cfg.bias_drift * (g - s.role_bias)
            if abs(nb - s.role_bias) > 1e-4:
                actions.append(SetRoleBias(s.iid, nb))
        return actions
