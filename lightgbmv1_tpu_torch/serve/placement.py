"""SLO-driven tenant placement over a replicated fleet; the port's copy of
lightgbmv1_tpu/serve/placement.py.

With hundreds of tenants on one fleet, "every tenant routes to every
replica" stops being a policy — a hot tenant's queue pressure lands on
every replica at once and the fair-share shed is the ONLY isolation
left.  The placement controller adds the second lever: it pins each
tenant's traffic to a replica SUBSET (the router's placement map,
router.py) and migrates tenants between subsets from three signals it
reads off surfaces that already exist:

* **SLO burn rate** — the tenant's fast-window availability/latency
  burn from its own per-replica SLO trackers (server.py
  ``tenants_snapshot``): a tenant burning error budget on its current
  subset is a candidate to move.
* **queue occupancy** — the tenant's backlog as a fraction of its
  fair-share rows on each pinned replica: sustained occupancy near 1.0
  means the subset is undersized or overloaded.
* **warm cost** — ``warm_compile_ms`` when a publish stamped it into
  the active :class:`~lightgbmv1_tpu_torch.serve.registry.ModelVersion`
  meta (0 otherwise).  The fleet publish already warmed every replica
  off-path, so a move never warms on the serving path — the cost is
  recorded as a decision input rather than gating correctness.

The controller's ONLY actuator is the router's placement map
(set_placement).  It never
touches a queue or a dispatcher.  Every migration is a first-class
``placement.move`` event carrying the full decision input — burn,
occupancy, loads, warm cost — so a fleet operator can replay WHY a
tenant moved from the event log alone.

Deliberately poll-driven (``step()``): the caller owns the cadence
(CLI loop, a test, a cron), the controller owns the decision.  A
``cooldown_s`` per tenant bounds churn — a tenant that just moved is
not reconsidered until its new subset's windows carry signal.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..utils.log import log_info


@dataclass
class PlacementConfig:
    """Mirrored by the ``placement_*`` knobs in config.py."""

    replicas_per_tenant: int = 1     # subset size each tenant is pinned to
    burn_threshold: float = 2.0      # fast-window burn rate marking "hot"
    occupancy_frac: float = 0.75     # queue occupancy marking "hot"
    cooldown_s: float = 30.0         # per-tenant re-move quiet period
    max_moves_per_step: int = 1      # churn bound per step() call

    def __post_init__(self):
        self.replicas_per_tenant = max(int(self.replicas_per_tenant), 1)
        if self.burn_threshold <= 0:
            raise ValueError("burn_threshold must be > 0")
        if not 0 < self.occupancy_frac <= 1:
            raise ValueError("occupancy_frac must be in (0, 1]")
        self.cooldown_s = max(float(self.cooldown_s), 0.0)
        self.max_moves_per_step = max(int(self.max_moves_per_step), 1)


class PlacementController:
    """Assigns tenants to replica subsets and migrates the hot ones.

    ``fleet`` supplies the signal reads (per-replica
    ``tenants_snapshot``) and ``router`` the actuator (its placement
    map filters ``_pick``)."""

    def __init__(self, fleet, router,
                 config: Optional[PlacementConfig] = None):
        self.fleet = fleet
        self.router = router
        self.config = config or PlacementConfig()
        n = len(fleet.replicas)
        if self.config.replicas_per_tenant > n:
            raise ValueError(
                f"replicas_per_tenant={self.config.replicas_per_tenant} "
                f"exceeds the fleet size {n}")
        self._last_move: Dict[str, float] = {}
        self.moves = 0

    # -- initial assignment ----------------------------------------------
    def assign(self) -> Dict[str, List[str]]:
        """Round-robin every NAMED tenant onto a subset of
        ``replicas_per_tenant`` replicas (the default tenant keeps
        routing everywhere).  Idempotent: tenants already pinned are
        left where they are — assign() heals the unpinned, it does not
        reshuffle."""
        names = [r.name for r in self.fleet.replicas]
        k = self.config.replicas_per_tenant
        placed = self.router.placement()
        offset = len(placed)
        out: Dict[str, List[str]] = {
            t: list(v) for t, v in placed.items()}
        for t in sorted(self.fleet.tenant_names()):
            if not t or t in placed:
                continue
            subset = [names[(offset + i) % len(names)] for i in range(k)]
            self.router.set_placement(t, subset)
            out[t] = subset
            offset += 1
        log_info(f"placement: assigned {len(out)} tenant(s) over "
                 f"{len(names)} replica(s), k={k}")
        return out

    # -- signal read -----------------------------------------------------
    def signals(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant decision inputs, worst-case across the replicas
        the tenant is currently pinned to (or all replicas when
        unpinned): fast-window burn rate, fair-share queue occupancy,
        SLO page state, the active version's warm-compile cost, and
        per-replica total backlog (the load the mover balances)."""
        per_replica = {r.name: r.tenants_snapshot()["tenants"]
                       for r in self.fleet.replicas}
        placement = self.router.placement()
        loads = {name: sum(t["queue_rows"] for t in tenants.values())
                 for name, tenants in per_replica.items()}
        out: Dict[str, Dict[str, Any]] = {}
        for t in self.fleet.tenant_names():
            if not t:
                continue
            pinned = list(placement.get(t, per_replica.keys()))
            views = [per_replica[n][t] for n in pinned
                     if t in per_replica[n]]
            if not views:
                continue
            warm = 0.0
            try:
                mv = self.fleet.replicas[0].tenant_registry(t).current()
                warm = float(mv.meta.get("warm_compile_ms") or 0.0)
            except Exception:   # noqa: BLE001 — nothing published yet
                pass
            out[t] = {
                "pinned": pinned,
                "burn_rate": max(v["burn_rate"] for v in views),
                "occupancy": max(v["occupancy"] for v in views),
                "slo_page": any(v["slo_page"] for v in views),
                "warm_compile_ms": warm,
                "replica_loads": loads,
            }
        return out

    # -- migration -------------------------------------------------------
    def _hot(self, sig: Dict[str, Any]) -> bool:
        cfg = self.config
        return (sig["burn_rate"] >= cfg.burn_threshold
                or sig["occupancy"] >= cfg.occupancy_frac)

    def step(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One control round: move up to ``max_moves_per_step`` hot
        tenants off their most-loaded pinned replica onto the
        least-loaded replica outside their subset.  Returns the move
        records (also published as ``placement.move`` events).  ``now``
        is injectable so tests drive the cooldown clock."""
        from ..obs import events as obs_events

        cfg = self.config
        t_now = time.monotonic() if now is None else float(now)
        sigs = self.signals()
        # hottest first: page > burn > occupancy
        hot = sorted(
            (t for t, s in sigs.items()
             if self._hot(s) and len(s["pinned"])
             < len(self.fleet.replicas)),
            key=lambda t: (not sigs[t]["slo_page"],
                           -sigs[t]["burn_rate"],
                           -sigs[t]["occupancy"], t))
        moves: List[Dict[str, Any]] = []
        for t in hot:
            if len(moves) >= cfg.max_moves_per_step:
                break
            last = self._last_move.get(t)
            if last is not None and t_now - last < cfg.cooldown_s:
                continue
            s = sigs[t]
            loads = s["replica_loads"]
            pinned = list(s["pinned"])
            src = max(pinned, key=lambda n: (loads.get(n, 0), n))
            candidates = [n for n in loads if n not in pinned]
            if not candidates:
                continue
            dst = min(candidates, key=lambda n: (loads[n], n))
            new_subset = [dst if n == src else n for n in pinned]
            self.router.set_placement(t, new_subset)
            self._last_move[t] = t_now
            self.moves += 1
            record = {
                "tenant": t, "from": src, "to": dst,
                "subset": new_subset,
                "burn_rate": round(s["burn_rate"], 4),
                "occupancy": round(s["occupancy"], 4),
                "slo_page": s["slo_page"],
                "warm_compile_ms": round(s["warm_compile_ms"], 3),
                "src_load_rows": loads.get(src, 0),
                "dst_load_rows": loads.get(dst, 0),
            }
            obs_events.publish(
                "placement.move",
                f"tenant {t}: {src} -> {dst} (burn "
                f"{record['burn_rate']}, occupancy "
                f"{record['occupancy']}, warm "
                f"{record['warm_compile_ms']} ms)",
                severity="warning" if s["slo_page"] else "info",
                **record)
            log_info(f"placement: moved {t} {src} -> {dst}")
            moves.append(record)
        return moves
