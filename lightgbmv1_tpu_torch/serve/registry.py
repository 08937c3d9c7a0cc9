"""Versioned model registry with atomic hot-swap.

Port of lightgbmv1_tpu/serve/registry.py.  The expensive part of bringing
a new ensemble online — building the serving binner, stacking the node
tables on the device and running every live bucket once — happens in
``prepare()`` OFF the serving path, together with the validation: the
structural and finite checks of every tree and the golden probe, where
the candidate must reproduce the host-tree oracle bit-exactly in float64
and to f32 round-off on its fast lane.  ``commit()`` then swaps a single
reference under a lock; the dispatcher reads it once per batch, so
in-flight batches finish on the version they started with.
``rollback()`` is the same swap back (the old predictor is retained).

A version may carry a second predictor over its first ``degrade_trees``
trees (cut on an iteration boundary): the server answers from it under
overload (server.py), on the same kernels.  Every version's meta holds
its gain / split feature importance (``commit`` diffs it against the
outgoing version's) and, when the publish passes a
``model_reference`` (obs/model.py), that reference's digest.  The
``publish_warm`` fault seam (utils/faults.py) fires before each warm
batch, named ``<registry name>:<tag>`` (or the tag).

Every response carries the version tag of the predictor that computed it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from ..models.predict import BatchPredictor
from ..models.tree import validate_host_tree
from ..obs import events as obs_events
from ..utils import faults
from ..utils.log import log_info, log_warning


class PublishValidationError(RuntimeError):
    """The candidate version failed pre-swap validation (structurally
    invalid trees, non-finite outputs, or a golden-probe mismatch
    between the device predictor and the host-tree oracle).  The active
    version is untouched."""


@dataclass
class ModelVersion:
    """One published ensemble: its serving predictor and the optional
    truncated-tree degrade predictor (overload answers)."""

    tag: str
    predictor: BatchPredictor
    degraded: Optional[BatchPredictor] = None
    num_features: int = 0
    num_class: int = 1
    n_trees: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)


def _booster_parts(model):
    """Accept a Booster or an explicit (trees, K, num_features) triple."""
    if isinstance(model, tuple):
        trees, k, f = model
        return list(trees), int(k), int(f)
    return (model._all_trees(), model.num_model_per_iteration(),
            model.num_feature())


class ModelRegistry:
    """Publish / current / rollback over :class:`ModelVersion` entries."""

    def __init__(self, *, history: int = 4, metrics=None,
                 predictor_kwargs: Optional[Dict[str, Any]] = None,
                 name: str = "", device: DeviceLike = None):
        self._lock = threading.Lock()
        self._active: Optional[ModelVersion] = None
        self._history: List[ModelVersion] = []
        self._seq = 0
        self._keep = max(int(history), 1)
        self._metrics = metrics
        # the registry's name prefixes the publish_warm fault site, so a
        # plan can fail one tenant's warm phase
        self.name = str(name)
        self.device = resolve_device(device)
        self._predictor_kwargs = dict(predictor_kwargs or {})
        if self.device.type == "cuda":
            # on the card every batch, warm and probe is one launch of K4,
            # the serving megakernel, unless the caller names another walk
            self._predictor_kwargs.setdefault("method", "fused")

    # -- build + warm (off the serving path) -----------------------------
    def _build(self, trees, K, F, degrade_trees: int) -> ModelVersion:
        self._seq += 1
        bp = BatchPredictor(trees, K, F, device=self.device,
                            **self._predictor_kwargs)
        degraded = None
        if degrade_trees and 0 < degrade_trees < len(trees):
            # truncate on an iteration boundary so multiclass ensembles
            # keep whole per-class tree groups
            n = max(degrade_trees - degrade_trees % max(K, 1), K)
            degraded = BatchPredictor(trees[:n], K, F, device=self.device,
                                      **self._predictor_kwargs)
        return ModelVersion(tag=f"v{self._seq}", predictor=bp,
                            degraded=degraded, num_features=F, num_class=K,
                            n_trees=len(trees))

    def _warm(self, mv: ModelVersion, max_batch_rows: int) -> int:
        """Run one batch of every bucket a live batch can land in, on the
        predictor and the degrade predictor, BEFORE the version becomes
        visible (the first request never pays the kernel library's
        load), finite-checking every output."""
        n_warm = 0
        for bp in filter(None, (mv.predictor, mv.degraded)):
            buckets, b = [], bp.bucket_for(1)
            top = bp.bucket_for(max(int(max_batch_rows), 1))
            while b <= top:
                buckets.append(b)
                b *= 2
            for bucket in buckets:
                # fault seam: a publish that dies mid-warm must leave the
                # active version serving
                faults.fire("publish_warm",
                            site=(f"{self.name}:{mv.tag}" if self.name
                                  else mv.tag))
                x = np.zeros((min(bucket, max_batch_rows), mv.num_features),
                             np.float64)
                out = np.asarray(bp.predict_raw(x))
                if not np.isfinite(out).all():
                    raise PublishValidationError(
                        f"{mv.tag}: non-finite scores from the "
                        f"{bucket}-row warm batch")
                n_warm += 1
        obs_events.publish("serve.publish_warm",
                           f"{mv.tag}: warmed {n_warm} batches",
                           tag=mv.tag, replica=self.name or "")
        return n_warm

    # -- pre-swap validation ---------------------------------------------
    @staticmethod
    def _validate_trees(trees) -> None:
        """Structural + finite validation of every candidate tree."""
        for i, t in enumerate(trees):
            validate_host_tree(t, i)
            nl = t.num_leaves
            if not np.isfinite(np.asarray(t.leaf_value[:nl],
                                          np.float64)).all():
                raise PublishValidationError(
                    f"tree {i}: non-finite leaf values")
            if nl > 1 and not np.isfinite(
                    np.asarray(t.threshold[: nl - 1], np.float64)).all():
                raise PublishValidationError(
                    f"tree {i}: non-finite split thresholds")

    @staticmethod
    def _probe_check(mv: ModelVersion, trees, K: int, F: int,
                     probe_rows: int) -> None:
        """Golden probe: the candidate's device predictor must reproduce
        the host-tree oracle BIT-EXACTLY on the f64 reconstruction lane,
        and to f32 round-off on the fast lane (K4 on the card), on a
        seeded batch."""
        rng = np.random.RandomState(0xC0FFEE ^ (len(trees) * 2654435761
                                                & 0x7FFFFFFF))
        Xp = rng.randn(int(probe_rows), F)
        want = np.zeros((int(probe_rows), K), np.float64)
        for i, t in enumerate(trees):
            want[:, i % K] += t.predict(Xp)
        got = np.asarray(mv.predictor.predict_raw(Xp, f64_exact=True))
        if got.shape != want.shape or not np.array_equal(got, want):
            raise PublishValidationError(
                f"{mv.tag}: golden-probe mismatch — device predictor "
                "diverges from the host-tree oracle on "
                f"{int(probe_rows)} probe rows")
        got32 = np.asarray(mv.predictor.predict_raw(Xp), np.float64)
        if got32.shape != want.shape or not np.allclose(
                got32, want, rtol=1e-4, atol=1e-5):
            raise PublishValidationError(
                f"{mv.tag}: golden-probe mismatch — fast f32 serving "
                "lane diverges from the host-tree oracle beyond f32 "
                f"round-off on {int(probe_rows)} probe rows")

    @staticmethod
    def _importance(trees, F: int) -> Dict[str, list]:
        """Gain and split importance of the candidate (its meta, which
        ``commit`` diffs against the outgoing version's)."""
        gain = np.zeros(F, np.float64)
        split = np.zeros(F, np.int64)
        for t in trees:
            for i in range(t.num_leaves - 1):
                f = int(t.split_feature[i])
                if f < F:
                    gain[f] += float(t.split_gain[i])
                    split[f] += 1
        return {"importance_gain": [round(float(v), 6) for v in gain],
                "importance_split": [int(v) for v in split]}

    # -- public API ------------------------------------------------------
    def prepare(self, model, *, degrade_trees: int = 0,
                max_batch_rows: int = 1024,
                meta: Optional[Dict[str, Any]] = None,
                probe_rows: int = 64) -> ModelVersion:
        """Phase 1 of a publish: build, warm and VALIDATE a candidate
        WITHOUT making it visible.  Raises with the active version
        untouched."""
        trees, K, F = _booster_parts(model)
        if not trees:
            raise ValueError("publish() needs a trained model "
                             "(zero trees)")
        try:
            self._validate_trees(trees)
            mv = self._build(trees, K, F, degrade_trees)
            if meta:
                mv.meta.update(meta)
            mv.meta.update(self._importance(trees, F))
            ref = mv.meta.get("model_reference")
            if ref is not None:
                mv.meta["model_reference_digest"] = ref.digest
            mv.meta["n_warm"] = self._warm(mv, max_batch_rows)
            if probe_rows > 0:
                self._probe_check(mv, trees, K, F, probe_rows)
        except Exception as e:
            if self._metrics is not None:
                self._metrics.on_publish_reject()
            obs_events.publish(
                "serve.publish_reject", f"{type(e).__name__}: {e}",
                severity="error", n_trees=len(trees), replica=self.name)
            log_warning(f"serve: publish rejected pre-swap "
                        f"({type(e).__name__}: {e}); active version "
                        "keeps serving")
            raise
        return mv

    def commit(self, mv: ModelVersion) -> str:
        """Phase 2: atomically make a prepared version current; the
        incoming version's importance is diffed against the outgoing
        one's (obs/model.importance_shift)."""
        with self._lock:
            prev = self._active
            if self._active is not None:
                self._history.append(self._active)
                del self._history[:-self._keep]
            self._active = mv
        if prev is not None and prev.meta.get("importance_gain") \
                and mv.meta.get("importance_gain"):
            from ..obs.model import importance_shift

            shift = importance_shift(prev.meta["importance_gain"],
                                     mv.meta["importance_gain"])
            mv.meta["importance_shift"] = shift
            mv.meta["importance_shift_vs"] = prev.tag
            obs_events.publish(
                "serve.importance_shift",
                f"{prev.tag} -> {mv.tag}: importance L1 shift "
                f"{shift['l1']}", tag=mv.tag, prev_tag=prev.tag,
                l1=shift["l1"], top_mover=shift["top_mover"],
                replica=self.name or "")
        if self._metrics is not None:
            self._metrics.on_swap()
        log_info(f"serve: published {mv.tag} ({mv.n_trees} trees, "
                 f"{mv.meta.get('n_warm', 0)} warmed buckets)")
        return mv.tag

    def publish(self, model, *, degrade_trees: int = 0,
                max_batch_rows: int = 1024,
                meta: Optional[Dict[str, Any]] = None,
                probe_rows: int = 64) -> str:
        """Build, warm and VALIDATE a new version, then atomically make it
        current (``prepare`` + ``commit``).  ``model`` is a Booster or a
        ``(trees, K, num_features)`` triple.  Returns the version tag."""
        return self.commit(self.prepare(
            model, degrade_trees=degrade_trees,
            max_batch_rows=max_batch_rows, meta=meta,
            probe_rows=probe_rows))

    def rollback(self) -> str:
        """Swap back to the previous version.  Returns the now-current
        tag."""
        with self._lock:
            if not self._history:
                raise RuntimeError("rollback(): no previous version")
            self._active = self._history.pop()
            tag = self._active.tag
        if self._metrics is not None:
            self._metrics.on_swap(rollback=True)
        log_info(f"serve: rolled back to {tag}")
        return tag

    def current(self) -> ModelVersion:
        """Atomic read of the active version (once per batch)."""
        with self._lock:
            if self._active is None:
                raise RuntimeError("no model published yet")
            return self._active

    def current_tag(self) -> Optional[str]:
        with self._lock:
            return self._active.tag if self._active is not None else None

    def versions(self) -> List[str]:
        with self._lock:
            out = [m.tag for m in self._history]
            if self._active is not None:
                out.append(self._active.tag)
            return out
