"""Train/serve skew detection: PSI math and serving-side sampling; the
port's copy of lightgbmv1_tpu/obs/drift.py.

Every feature was binned through a ``BinMapper`` at training time, so
the trained ensemble's own bin edges are a reference distribution, and
skew detection is a re-bin of sampled request rows against the mappers
the model carries (obs/model.py ``ModelReference``).

* **PSI** — :func:`psi` (population stability index) of two occupancy
  histograms, with epsilon smoothing for empty bins, over equal-mass
  groups of the training bins (:func:`group_bins`).
* **:class:`SamplingRing`** — a bounded cyclic row buffer the dispatcher
  writes into (at most ``per_batch_rows`` rows of a sampled batch).  Off
  by default (``drift_sample_rows`` = 0): the disarmed serving path
  never touches this module.  The rows copied are the request's host
  rows: sampling reads nothing back from the device.
* **:class:`DriftDetector`** — re-bins the sampled rows through the
  version's own mappers and judges per-feature PSI, unseen-bin /
  out-of-range / NaN counters and prediction-score drift against the
  training reference.  Read surfaces: ``GET /drift`` (serve/http.py),
  Prometheus gauges for the top-K drifting features only, and
  ``drift.alert`` events when a feature (or the score distribution)
  crosses the PSI threshold.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

# conventional PSI bands: < 0.1 stable, 0.1-0.25 moderate shift,
# >= 0.25 major shift (the default alert threshold)
PSI_ALERT_DEFAULT = 0.25
# epsilon smoothing for empty bins: PSI's log ratio is undefined at 0;
# clipping both distributions here bounds a single empty bin's
# contribution instead of making it infinite
PSI_EPS = 1e-4


def group_bins(ref_counts, max_groups: int = 16) -> np.ndarray:
    """Contiguous equal-mass grouping of fine histogram bins.

    PSI over the raw training bins (up to ``max_bin`` = 255 of them) is
    statistically noisy: its sampling floor is ~B/n, so a 2000-row
    clean window over 255 bins reads ~0.13 "drift" from noise alone.
    Grouping adjacent bins so each group holds ~1/max_groups of the
    REFERENCE mass (the standard 10-20-bucket PSI practice) drops the
    floor to ~max_groups/n while keeping the comparison anchored to the
    training distribution.  Returns a per-bin group id (monotone,
    contiguous — numeric bins stay ordered; categorical bins are
    frequency-ordered by construction, so adjacent grouping merges the
    rare tail)."""
    c = np.asarray(ref_counts, np.float64).ravel()
    B = len(c)
    gid = np.zeros(B, np.int64)
    if B <= max_groups:
        return np.arange(B, dtype=np.int64)
    total = c.sum()
    if total <= 0:
        return np.minimum(np.arange(B, dtype=np.int64), max_groups - 1)
    # adaptive target (the same recomputation the binning search uses):
    # a heavy head bin must not starve the tail of groups
    remaining = float(total)
    g, acc = 0, 0.0
    target = remaining / max_groups
    for i in range(B):
        gid[i] = g
        acc += c[i]
        remaining -= c[i]
        if acc >= target and g < max_groups - 1:
            g += 1
            acc = 0.0
            target = remaining / (max_groups - g)
    return gid


def grouped_counts(counts, gid: np.ndarray) -> np.ndarray:
    """Fold fine-bin counts into their groups (int64-exact)."""
    return np.bincount(gid, weights=np.asarray(counts, np.float64),
                       minlength=int(gid.max()) + 1 if len(gid) else 1)


def psi(expected, actual, eps: float = PSI_EPS) -> float:
    """Population stability index between two occupancy histograms.

    ``sum((q_i - p_i) * ln(q_i / p_i))`` over bins, where ``p`` is the
    expected (training reference) distribution and ``q`` the actual
    (serving) one.  Inputs are raw counts (any nonneg dtype); each is
    normalized independently, then clipped at ``eps`` so empty bins
    contribute a bounded term.  Returns 0.0 when either side is empty
    (no evidence is not drift)."""
    p = np.asarray(expected, np.float64).ravel()
    q = np.asarray(actual, np.float64).ravel()
    if p.shape != q.shape:
        raise ValueError(f"psi: shape mismatch {p.shape} vs {q.shape}")
    ps, qs = p.sum(), q.sum()
    if ps <= 0 or qs <= 0:
        return 0.0
    p = np.clip(p / ps, eps, None)
    q = np.clip(q / qs, eps, None)
    return float(np.sum((q - p) * np.log(q / p)))


@dataclass
class DriftConfig:
    """Serving-side skew-detection knobs (``drift_*`` in config.py).

    ``sample_rows`` = 0 is the hard-off default: the serving path does
    not allocate, copy, or check anything beyond one integer compare."""

    sample_rows: int = 0            # ring capacity in rows; 0 = off
    per_batch_rows: int = 64        # rows copied from one device batch
    min_rows: int = 256             # rows required before PSI is judged
    psi_threshold: float = PSI_ALERT_DEFAULT
    top_k: int = 8                  # per-feature gauges exposed (cap)
    psi_groups: int = 16            # equal-mass PSI buckets per feature
    # sample every Nth device batch (1 = every batch).  The row copy is
    # ~tens of us; against small fast batches that is a measurable
    # fraction, and drift is a minutes-scale phenomenon — striding
    # amortizes the armed cost 1/N with no loss of statistical power
    # (the ring still converges to the recent-traffic distribution)
    sample_stride: int = 4

    def __post_init__(self):
        self.sample_rows = max(int(self.sample_rows), 0)
        self.per_batch_rows = max(int(self.per_batch_rows), 1)
        self.min_rows = max(int(self.min_rows), 1)
        self.psi_threshold = max(float(self.psi_threshold), 0.0)
        self.top_k = max(int(self.top_k), 1)
        self.psi_groups = max(int(self.psi_groups), 2)
        self.sample_stride = max(int(self.sample_stride), 1)


class SamplingRing:
    """Bounded cyclic buffer of sampled (row, score) pairs.

    The dispatcher thread writes (``offer``); HTTP threads read
    (``sample``) under the lock.  Memory is fixed at construction —
    ``capacity x F`` float64 rows plus ``capacity x K`` float32 scores —
    and never grows; sustained traffic overwrites the oldest samples, so
    the ring always holds the most recent window (the distribution drift
    cares about)."""

    def __init__(self, capacity: int, num_features: int, score_dim: int):
        if capacity < 1:
            raise ValueError("SamplingRing needs capacity >= 1")
        self.capacity = int(capacity)
        self._rows = np.empty((self.capacity, int(num_features)),
                              np.float64)
        self._scores = np.empty((self.capacity, max(int(score_dim), 1)),
                                np.float32)
        self._pos = 0
        self._filled = 0
        self.rows_seen = 0            # offered rows incl. not-sampled
        self.rows_sampled = 0
        self._lock = threading.Lock()

    def offer(self, X: np.ndarray, scores: np.ndarray,
              per_batch: int = 64) -> int:
        """Copy up to ``per_batch`` evenly-strided rows of this batch
        into the ring; returns rows taken.  Vectorized — at most two
        slice assignments (cyclic wrap), never a per-row Python loop:
        this is the armed serving path's cost."""
        n = X.shape[0]
        take = min(n, max(int(per_batch), 1), self.capacity)
        if take <= 0:
            return 0
        if take < n:
            idx = np.arange(take) * (n // take)
            Xs, Ss = X[idx], scores[idx]
        else:
            Xs, Ss = X, scores
        with self._lock:
            self.rows_seen += n
            pos = self._pos
            end = pos + take
            if end <= self.capacity:
                self._rows[pos:end] = Xs
                self._scores[pos:end] = Ss
            else:
                k = self.capacity - pos
                self._rows[pos:] = Xs[:k]
                self._scores[pos:] = Ss[:k]
                self._rows[: end - self.capacity] = Xs[k:]
                self._scores[: end - self.capacity] = Ss[k:]
            self._pos = end % self.capacity
            self._filled = min(self._filled + take, self.capacity)
            self.rows_sampled += take
        return take

    def sample(self):
        """Snapshot copy ``(rows, scores)`` of the filled window."""
        with self._lock:
            k = self._filled
            return self._rows[:k].copy(), self._scores[:k].copy()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"capacity": self.capacity, "filled": self._filled,
                    "rows_seen": self.rows_seen,
                    "rows_sampled": self.rows_sampled}


class DriftDetector:
    """Serving-side skew detector for ONE published model version.

    Holds the version's :class:`~lightgbmv1_tpu_torch.obs.model.ModelReference`
    and a :class:`SamplingRing`; ``offer()`` is the only hot-path call
    (one strided row copy).  ``evaluate()`` re-bins the sampled window
    through the reference's own mappers and judges per-feature PSI,
    unseen-bin / out-of-range / NaN counters and score-distribution PSI
    — O(window x features) on the READ path (GET /drift), never
    on the serving path.

    Metrics land in the server's registry with capped cardinality: only
    the current top-K drifting features get a ``drift_feature_psi``
    gauge (features that leave the top-K are zeroed, not deleted —
    registry children are append-only); everything per-feature beyond
    the top-K lives in the JSON snapshot only."""

    def __init__(self, reference, config: Optional[DriftConfig] = None,
                 registry=None, version_tag: str = "",
                 events: bool = True):
        self.reference = reference
        self.config = config or DriftConfig()
        self.version_tag = str(version_tag)
        self.ring = SamplingRing(
            max(self.config.sample_rows, 1), reference.num_features,
            reference.num_class)
        self._events = bool(events)
        self._batch_i = 0
        self._alerting: set = set()   # feature names + "__score__"
        self._registry = registry
        self._eval_lock = threading.Lock()
        # per-feature equal-mass PSI grouping, derived ONCE from the
        # reference occupancy (deterministic — the serving side groups
        # with the same ids every evaluation)
        self._gids = [group_bins(reference.bin_counts(f),
                                 self.config.psi_groups)
                      for f in range(reference.num_features)]
        self._ref_grouped = [grouped_counts(reference.bin_counts(f),
                                            self._gids[f])
                             for f in range(reference.num_features)]
        if registry is not None:
            self._g_psi = registry.gauge(
                "drift_feature_psi",
                "Per-feature PSI vs the training reference "
                "(top-K drifting features only)", label_names=("feature",))
            self._g_max = registry.gauge(
                "drift_psi_max", "Max per-feature PSI at last evaluation")
            self._g_score = registry.gauge(
                "drift_score_psi",
                "Prediction-score PSI vs the training distribution")
            self._g_alerting = registry.gauge(
                "drift_features_alerting",
                "Features over the PSI alert threshold")
            self._c_rows = registry.counter(
                "drift_rows_sampled_total", "Rows copied into the ring")
            self._c_unseen = registry.counter(
                "drift_unseen_bin_total",
                "Sampled categorical values unseen at training time")
            self._c_clip = registry.counter(
                "drift_out_of_range_total",
                "Sampled numeric values outside the training range")
            self._c_nan = registry.counter(
                "drift_nan_values_total", "Sampled NaN feature values")
            self._c_evals = registry.counter(
                "drift_evaluations_total", "Drift evaluations computed")
            self._c_alerts = registry.counter(
                "drift_alerts_total", "drift.alert events published")

    # -- hot path --------------------------------------------------------
    def offer(self, X: np.ndarray, scores: np.ndarray) -> None:
        # stride gate first: the common armed case is one increment +
        # one modulo, the row copy only every Nth batch
        self._batch_i += 1
        if (self._batch_i - 1) % self.config.sample_stride:
            return
        taken = self.ring.offer(X, scores,
                                per_batch=self.config.per_batch_rows)
        if taken and self._registry is not None:
            self._c_rows.inc(taken)

    # -- read path -------------------------------------------------------
    def evaluate(self) -> Dict[str, Any]:
        """Re-bin the sampled window and judge drift.  Returns the full
        per-feature result; publishes the capped metric view and any
        ``drift.alert`` transitions as side effects."""
        with self._eval_lock:
            return self._evaluate_locked()

    def _evaluate_locked(self) -> Dict[str, Any]:
        cfg = self.config
        ref = self.reference
        rows, scores = self.ring.sample()
        n = rows.shape[0]
        out: Dict[str, Any] = {
            "version": self.version_tag,
            "rows_in_window": int(n),
            "min_rows": cfg.min_rows,
            "psi_threshold": cfg.psi_threshold,
            "ring": self.ring.stats(),
            "evaluated": bool(n >= cfg.min_rows),
        }
        if self._registry is not None:
            self._c_evals.inc()
        if n < cfg.min_rows:
            out.update({"features": [], "top": [], "alerting": [],
                        "psi_max": None, "score_psi": None})
            return out
        codes, stats = ref.rebin(rows)
        feats: List[Dict[str, Any]] = []
        for f in range(ref.num_features):
            counts = np.bincount(codes[:, f].astype(np.int64),
                                 minlength=ref.num_bin[f])[:ref.num_bin[f]]
            feats.append({
                "feature": ref.feature_names[f],
                "index": f,
                "psi": round(psi(self._ref_grouped[f],
                                 grouped_counts(counts, self._gids[f])),
                             6),
                "nan_frac": round(float(stats["nan"][f]) / n, 6),
                "ref_nan_frac": round(float(ref.nan_rate[f]), 6),
                "unseen": int(stats["unseen"][f]),
                "out_of_range": int(stats["clip"][f]),
            })
        score_psi = ref.score_psi(scores)
        by_psi = sorted(feats, key=lambda d: -d["psi"])
        alerting = [d["feature"] for d in feats
                    if d["psi"] >= cfg.psi_threshold]
        psi_max = by_psi[0]["psi"] if by_psi else 0.0
        out.update({
            "features": feats,
            "top": by_psi[: cfg.top_k],
            "alerting": alerting,
            "psi_max": psi_max,
            "score_psi": round(score_psi, 6),
            "score_alerting": bool(score_psi >= cfg.psi_threshold),
            "unseen_total": int(stats["unseen"].sum()),
            "out_of_range_total": int(stats["clip"].sum()),
            "nan_total": int(stats["nan"].sum()),
        })
        self._publish(out, by_psi, stats)
        return out

    def _publish(self, out: Dict[str, Any], by_psi, stats) -> None:
        if self._registry is not None:
            # top-K only: the per-feature gauge cardinality is capped by
            # construction; a feature that leaves the top-K reads 0
            top_names = set()
            for d in by_psi[: self.config.top_k]:
                self._g_psi.labels(feature=d["feature"]).set(d["psi"])
                top_names.add(d["feature"])
            for key, child in self._g_psi.children():
                if key and key[0] not in top_names:
                    child.set(0.0)
            self._g_max.set(out["psi_max"] or 0.0)
            self._g_score.set(out["score_psi"] or 0.0)
            self._g_alerting.set(len(out["alerting"]))
            self._c_unseen.inc(int(stats["unseen"].sum()))
            self._c_clip.inc(int(stats["clip"].sum()))
            self._c_nan.inc(int(stats["nan"].sum()))
        # alert transitions -> the event log (enter-only: an alert that
        # persists across evaluations publishes once per entry)
        now_alerting = set(out["alerting"])
        if out.get("score_alerting"):
            now_alerting.add("__score__")
        entered = now_alerting - self._alerting
        self._alerting = now_alerting
        if entered and self._events:
            from . import events

            for name in sorted(entered):
                if self._registry is not None:
                    self._c_alerts.inc()
                if name == "__score__":
                    events.publish(
                        "drift.alert",
                        f"prediction-score PSI {out['score_psi']} >= "
                        f"{self.config.psi_threshold}", severity="warning",
                        version=self.version_tag, kind_of_drift="score",
                        psi=out["score_psi"])
                else:
                    d = next(d for d in out["features"]
                             if d["feature"] == name)
                    events.publish(
                        "drift.alert",
                        f"feature {name} PSI {d['psi']} >= "
                        f"{self.config.psi_threshold}", severity="warning",
                        version=self.version_tag, kind_of_drift="feature",
                        feature=name, psi=d["psi"],
                        unseen=d["unseen"], nan_frac=d["nan_frac"])

    def snapshot(self) -> Dict[str, Any]:
        """The GET /drift payload: one evaluation, trimmed to the top-K
        per-feature rows plus the aggregate judgement."""
        ev = self.evaluate()
        ev = dict(ev)
        ev.pop("features", None)      # full list stays internal; the
        return ev                     # endpoint serves the capped view


__all__ = ["psi", "group_bins", "grouped_counts", "DriftConfig",
           "SamplingRing", "DriftDetector",
           "PSI_ALERT_DEFAULT", "PSI_EPS"]
