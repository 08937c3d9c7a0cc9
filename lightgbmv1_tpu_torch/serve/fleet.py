"""Replicated serving fleet with coordinated two-phase publish; the port's
copy of lightgbmv1_tpu/serve/fleet.py.

One :class:`~lightgbmv1_tpu_torch.serve.server.Server` is one failure domain:
a wedged dispatcher or a killed replica is 100% unavailability.  A
fleet is N replicas — each with its OWN registry, dispatcher, metrics
and SLO tracker (no shared mutable state between replicas, so one
replica's death cannot corrupt another) — fronted by
:class:`~lightgbmv1_tpu_torch.serve.router.Router`, which owns health-check
ejection and per-request retry/hedging.  The replicas of one fleet share
one ``device`` (the card by default; raises when there is none), and each
keeps its own predictors, so each of its batches is one launch of the
serving kernel there.

The piece that must be COORDINATED is publish.  Publishing replica-by-
replica with the single-server ``publish()`` would leave the fleet
mixed-version whenever a middle replica rejects the candidate — some
replicas answering with the new model, some with the old, and no tag a
client can trust.  The fleet publish is therefore two-phase over the
registry's prepare/commit split (registry.py):

* **phase 1 — warm all**: every replica builds + warms + validates the
  candidate (``registry.prepare``), warm work OFF every serving
  path.  ANY replica's validation failure aborts the whole publish:
  prepared versions are discarded, NO replica has swapped, and every
  replica keeps serving the prior version bit-exactly
  (:class:`FleetPublishError` carries the per-replica causes).
* **phase 2 — swap all**: only after every replica holds a warmed,
  probe-validated version does each commit run (one reference swap per
  replica).  A commit-phase failure (defensive: commits are reference
  swaps and should not fail) rolls the already-committed replicas back
  so the fleet never stays split.

Replica version tags stay aligned across the fleet because every
replica's registry sees the same publish/abort sequence (a failed
prepare burns the same seq number on every replica).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..device import DeviceLike
from ..utils.log import log_info, log_warning
from .registry import ModelVersion
from .server import DEFAULT_TENANT, ServeConfig, Server


class FleetPublishError(RuntimeError):
    """The two-phase fleet publish aborted: at least one replica failed
    warm/validation.  No replica swapped; the prior version keeps
    serving everywhere.  ``causes`` maps replica name -> error."""

    def __init__(self, msg: str, causes: Optional[Dict[str, str]] = None):
        super().__init__(msg)
        self.causes = dict(causes or {})


class Fleet:
    """N replica Servers sharing a ServeConfig, with two-phase publish.

    The fleet OWNS its replicas (``close()`` closes them); the router
    only references them.  ``model`` (optional) is published fleet-wide
    at construction.  Every replica's predictors run on ``device``."""

    def __init__(self, model=None, *, n_replicas: int = 2,
                 config: Optional[ServeConfig] = None,
                 names: Optional[List[str]] = None,
                 device: DeviceLike = None):
        n = max(int(n_replicas), 1)
        self.config = config or ServeConfig()
        names = list(names) if names else [f"r{i}" for i in range(n)]
        if len(names) != n:
            raise ValueError(f"{len(names)} names for {n} replicas")
        self.replicas: List[Server] = [
            Server(None, config=self.config, name=nm, device=device)
            for nm in names]
        if model is not None:
            self.publish(model)

    # -- lookups ---------------------------------------------------------
    def replica(self, name: str) -> Server:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"no replica {name!r}")

    def names(self) -> List[str]:
        return [r.name for r in self.replicas]

    def version(self, tenant: str = DEFAULT_TENANT) -> Optional[str]:
        """The fleet's consensus version tag for one tenant lineage
        (None when replicas disagree or nothing is published — a mixed
        fleet must be VISIBLE, not averaged away)."""
        tags = {r.tenant_registry(tenant).current_tag()
                for r in self.replicas}
        return tags.pop() if len(tags) == 1 else None

    def healths(self) -> Dict[str, Dict[str, Any]]:
        return {r.name: r.health() for r in self.replicas}

    # -- tenants ---------------------------------------------------------
    def add_tenant(self, name: str, *, weight: float = 1.0,
                   slo=None, predictor_kwargs=None) -> None:
        """Stand a named tenant lineage up on EVERY replica (idempotent
        per replica, so a partially-added tenant heals on retry)."""
        for r in self.replicas:
            r.add_tenant(name, weight=weight, slo=slo,
                         predictor_kwargs=predictor_kwargs)

    def remove_tenant(self, name: str) -> None:
        for r in self.replicas:
            r.remove_tenant(name)

    def tenant_names(self) -> List[str]:
        return self.replicas[0].tenant_names()

    def tenants_snapshot(self) -> Dict[str, Any]:
        """Per-replica tenant snapshots keyed by replica name, plus the
        fleet-consensus version per tenant."""
        per_replica = {r.name: r.tenants_snapshot()["tenants"]
                       for r in self.replicas}
        versions = {t: self.version(t) for t in self.tenant_names()}
        return {"replicas": per_replica, "versions": versions}

    # -- coordinated publish ---------------------------------------------
    def publish(self, model, tenant: str = DEFAULT_TENANT,
                **meta) -> str:
        """Two-phase fleet publish into one tenant's lineage; returns
        the fleet-wide version tag.  Raises :class:`FleetPublishError`
        (no replica swapped, no OTHER tenant touched) when any
        replica's prepare fails."""
        from ..obs import events as obs_events

        cfg = self.config
        prepared: Dict[str, ModelVersion] = {}
        causes: Dict[str, str] = {}
        # phase 1: warm + validate on EVERY replica (even after a
        # failure — every replica's seq must advance identically so
        # tags stay aligned fleet-wide)
        for r in self.replicas:
            try:
                prepared[r.name] = r.tenant_registry(tenant).prepare(
                    model, degrade_trees=cfg.degrade_trees,
                    max_batch_rows=cfg.max_batch_rows,
                    meta=meta or None, probe_rows=cfg.probe_rows)
            except Exception as e:  # noqa: BLE001 — collected, aborts
                causes[r.name] = f"{type(e).__name__}: {e}"
        if causes:
            obs_events.publish(
                "fleet.publish_abort",
                f"{len(causes)}/{len(self.replicas)} replicas failed "
                "warm/validation — fleet publish aborted, prior version "
                "keeps serving everywhere",
                severity="error", causes=causes,
                tenant=tenant or "default")
            log_warning(f"fleet: publish aborted in phase 1 ({causes}); "
                        "no replica swapped")
            raise FleetPublishError(
                f"fleet publish aborted: {causes}", causes)
        # phase 2: commit everywhere; defensively roll back on the
        # (should-be-impossible) mid-commit failure
        committed: List[Server] = []
        try:
            for r in self.replicas:
                r.tenant_registry(tenant).commit(prepared[r.name])
                committed.append(r)
        except Exception as e:  # noqa: BLE001
            for r in committed:
                try:
                    r.tenant_registry(tenant).rollback()
                except Exception:   # noqa: BLE001
                    pass
            obs_events.publish(
                "fleet.publish_abort",
                f"commit-phase failure on replica "
                f"{self.replicas[len(committed)].name}: rolled "
                f"{len(committed)} committed replica(s) back",
                severity="error")
            raise FleetPublishError(
                f"fleet commit failed after {len(committed)} swaps "
                f"({type(e).__name__}: {e}); rolled back") from e
        tag = prepared[self.replicas[0].name].tag
        log_info(f"fleet: published {tag} on "
                 f"{len(self.replicas)} replicas (two-phase)")
        return tag

    def rollback(self, tenant: str = DEFAULT_TENANT) -> str:
        """Fleet-wide rollback of one tenant's lineage (each replica's
        retained previous version; instant)."""
        tags = {r.tenant_registry(tenant).rollback()
                for r in self.replicas}
        if len(tags) != 1:
            log_warning(f"fleet: rollback left mixed versions {tags}")
        return sorted(tags)[0]

    def close(self) -> None:
        for r in self.replicas:
            r.close()

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
