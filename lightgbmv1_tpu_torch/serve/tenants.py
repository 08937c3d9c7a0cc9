"""Multi-tenant model multiplexing over one server; the port's copy of
lightgbmv1_tpu/serve/tenants.py.

:class:`TenantRegistry` is the control plane over the server's tenant
table: each tenant is a named model lineage with its own
:class:`~lightgbmv1_tpu_torch.serve.registry.ModelRegistry` (versions,
rollback), its own SLO tracker and a fair-share ``weight`` that the
server's admission reads (server.py ``_recompute_shares``: an overloaded
tenant sheds its OWN traffic first).  A publish into one tenant cannot
touch another tenant's active version: their registries are separate
objects.

Tenants are registered with ``shared_cache=True`` predictors
(models/predict.py): the per-shape serving plan (K4's tile plan) is
looked up in a cache keyed by the ensemble's shape, not the tenant, so
same-shape tenants share it; ``compile_share_stats()`` reports the hit
rate (``share_frac``).  The port builds no compiled executables: that
plan is what it builds per shape.

The backend is duck-typed: a :class:`~lightgbmv1_tpu_torch.serve.Server`
or anything exposing ``add_tenant / remove_tenant / tenant_names /
publish / rollback / version / tenants_snapshot``.

Tenant manifests (CLI ``task=serve tenant_manifest=...``) use the
``name[:weight][,name[:weight]...]`` grammar: ``"acme:3,globex"`` is
tenant ``acme`` at weight 3 and ``globex`` at the default weight 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..utils.log import log_info
from .slo import SLOConfig


@dataclass
class TenantSpec:
    """One tenant's declaration: identity, fair-share weight, optional
    per-tenant SLO targets and predictor overrides."""

    name: str
    weight: float = 1.0
    slo: Optional[SLOConfig] = None
    predictor_kwargs: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError("tenant name must be a non-empty string")
        if "," in self.name or ":" in self.name:
            raise ValueError(
                f"tenant name {self.name!r} may not contain ',' or ':' "
                "(manifest grammar delimiters)")
        self.weight = float(self.weight)
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got "
                f"{self.weight}")


def parse_manifest(spec: str) -> List[TenantSpec]:
    """``"acme:3,globex"`` -> ``[TenantSpec("acme", 3.0),
    TenantSpec("globex", 1.0)]``.  Duplicate names are rejected — a
    manifest that silently last-writer-wins a weight is a config bug."""
    out: List[TenantSpec] = []
    seen = set()
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, w = entry.partition(":")
        name = name.strip()
        try:
            weight = float(w) if w.strip() else 1.0
        except ValueError:
            raise ValueError(
                f"tenant manifest entry {entry!r}: weight {w!r} is not "
                "a number") from None
        if name in seen:
            raise ValueError(f"tenant {name!r} appears twice in the "
                             "manifest")
        seen.add(name)
        out.append(TenantSpec(name, weight))
    return out


def compile_share_stats() -> Dict[str, Any]:
    """The cross-tenant sharing scoreboard: hit / miss / entry counts of
    the shape-keyed serving-plan cache (models/predict.py) plus
    ``share_frac`` = hits / lookups.  Same-shape tenants converge toward
    1.0; 0.0 means every tenant built its own."""
    from ..models.predict import shared_cache_stats

    stats = dict(shared_cache_stats())
    lookups = stats["hits"] + stats["misses"]
    stats["share_frac"] = (round(stats["hits"] / lookups, 4)
                           if lookups else 0.0)
    return stats


class TenantRegistry:
    """Control plane for named model lineages over one backend.

    ``shared_compile=True`` (default) registers every tenant's
    predictors with the shape-keyed shared plan cache; a caller's
    ``predictor_kwargs`` in the spec still wins (a tenant can opt out
    of sharing)."""

    def __init__(self, backend, *, shared_compile: bool = True):
        self.backend = backend
        self.shared_compile = bool(shared_compile)
        self._specs: Dict[str, TenantSpec] = {}

    # -- lifecycle -------------------------------------------------------
    def add(self, spec, *, weight: Optional[float] = None,
            slo: Optional[SLOConfig] = None,
            predictor_kwargs: Optional[Dict[str, Any]] = None
            ) -> TenantSpec:
        """Register a tenant (idempotent; re-add updates the weight).
        ``spec`` is a :class:`TenantSpec` or a bare name."""
        if not isinstance(spec, TenantSpec):
            spec = TenantSpec(str(spec),
                              weight=1.0 if weight is None else weight,
                              slo=slo,
                              predictor_kwargs=dict(
                                  predictor_kwargs or {}))
        pk = dict(spec.predictor_kwargs)
        if self.shared_compile:
            pk.setdefault("shared_cache", True)
        self.backend.add_tenant(spec.name, weight=spec.weight,
                                slo=spec.slo, predictor_kwargs=pk)
        self._specs[spec.name] = spec
        return spec

    def add_manifest(self, manifest: str) -> List[TenantSpec]:
        specs = parse_manifest(manifest)
        for s in specs:
            self.add(s)
        if specs:
            log_info(f"tenants: manifest registered "
                     f"{[s.name for s in specs]}")
        return specs

    def remove(self, name: str) -> None:
        self.backend.remove_tenant(name)
        self._specs.pop(name, None)

    def names(self) -> List[str]:
        return [n for n in self.backend.tenant_names() if n]

    # -- model lifecycle -------------------------------------------------
    def publish(self, name: str, model, **meta) -> str:
        """Publish into ONE tenant's lineage; every tenant's registry is
        a separate object, so a failed publish for tenant A cannot touch
        tenant B's active version."""
        return self.backend.publish(model, tenant=name, **meta)

    def rollback(self, name: str) -> str:
        return self.backend.rollback(tenant=name)

    def version(self, name: str) -> Optional[str]:
        return self.backend.version(tenant=name)

    # -- observability ---------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The backend's ``GET /tenants`` payload plus the
        compile-sharing scoreboard."""
        out = self.backend.tenants_snapshot()
        out["compile_share"] = compile_share_stats()
        return out

    compile_share_stats = staticmethod(compile_share_stats)
