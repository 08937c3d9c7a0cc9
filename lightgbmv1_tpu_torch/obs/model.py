"""Model-quality observability: the training reference and the trainer's
quality telemetry; the port's copy of lightgbmv1_tpu/obs/model.py.

* **:class:`ModelReference`** — what a served model carries about the
  data it was trained on: per-feature bin occupancy over the ensemble's
  OWN ``BinMapper`` bins (a ``bincount`` a feature over the binned
  training matrix), per-feature NaN rates, and the raw training-score
  distribution.  ``to_bytes`` / ``from_bytes`` give a deterministic
  binary layout with a SHA-256 digest, the JAX package's format byte for
  byte: the same dataset and scores give the same digest in either
  package.  Checkpoints carry it (io/checkpoint.py member
  ``reference.bin``) and so does a published ``ModelVersion``'s meta.
* **Trainer quality telemetry** — :func:`quality_snapshot` reads a
  trained booster after the fact (host trees and the metric curves the
  training loop records): per-iteration split gains, leaf and depth
  statistics, the metric curves and gain / split importance.

The serving side's use of the reference is obs/drift.py.
"""

from __future__ import annotations

import hashlib
import json
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..io.binning import BIN_CATEGORICAL, MISSING_NAN, BinMapper

REF_FORMAT = "lightgbmv1-model-reference"
REF_VERSION = 1
_MAGIC = b"LGBMV1REF\n"
DEFAULT_SCORE_BINS = 16

# serialization order is part of the format: (name, dtype) pairs, raw
# little-endian bytes concatenated after the JSON header
_ARRAY_SPEC: Tuple[Tuple[str, str], ...] = (
    ("mapper_scalars", "<i8"),     # (F, 4) num_bin/missing_type/bin_type/
    ("mapper_floats", "<f8"),      # (F, 3) sparse_rate/min/max  # trivial
    ("ubound_offsets", "<i8"),     # (F+1,) into ubound_flat
    ("ubound_flat", "<f8"),        # concatenated bin_upper_bound
    ("cat_offsets", "<i8"),        # (F+1,) into cat_flat
    ("cat_flat", "<i8"),           # concatenated bin_2_categorical
    ("count_offsets", "<i8"),      # (F+1,) into count_flat
    ("count_flat", "<i8"),         # concatenated per-bin occupancy
    ("nan_rate", "<f8"),           # (F,) NaN-bin occupancy fraction
    ("score_edges", "<f8"),        # (S+1,) training-score bin edges
    ("score_counts", "<i8"),       # (K, S) per-class score occupancy
)


class ModelReferenceError(RuntimeError):
    """Unreadable, torn, or digest-mismatched reference payload."""


@dataclass
class ModelReference:
    """Training-time distribution evidence for one trained ensemble."""

    n_rows: int
    num_class: int
    feature_names: List[str]
    arrays: Dict[str, np.ndarray]
    _mappers: Optional[List[BinMapper]] = field(default=None, repr=False)

    # -- shape accessors -------------------------------------------------
    @property
    def num_features(self) -> int:
        return len(self.feature_names)

    @property
    def num_bin(self) -> np.ndarray:
        return self.arrays["mapper_scalars"][:, 0]

    @property
    def nan_rate(self) -> np.ndarray:
        return self.arrays["nan_rate"]

    def bin_counts(self, f: int) -> np.ndarray:
        off = self.arrays["count_offsets"]
        return self.arrays["count_flat"][off[f]:off[f + 1]]

    @property
    def score_edges(self) -> np.ndarray:
        return self.arrays["score_edges"]

    @property
    def score_counts(self) -> np.ndarray:
        return self.arrays["score_counts"]

    # -- the version's own mappers ---------------------------------------
    def mappers(self) -> List[BinMapper]:
        """Reconstruct the per-feature BinMapper objects — re-binning a
        serving row goes through EXACTLY the mapper semantics training
        used (``BinMapper.value_to_bin``)."""
        if self._mappers is None:
            a = self.arrays
            sc, fl = a["mapper_scalars"], a["mapper_floats"]
            uoff, coff = a["ubound_offsets"], a["cat_offsets"]
            self._mappers = []
            for j in range(sc.shape[0]):
                cats = [int(c) for c in a["cat_flat"][coff[j]:coff[j + 1]]]
                self._mappers.append(BinMapper(
                    bin_upper_bound=np.asarray(
                        a["ubound_flat"][uoff[j]:uoff[j + 1]], np.float64),
                    num_bin=int(sc[j, 0]), missing_type=int(sc[j, 1]),
                    bin_type=int(sc[j, 2]), is_trivial=bool(sc[j, 3]),
                    sparse_rate=float(fl[j, 0]),
                    min_value=float(fl[j, 1]), max_value=float(fl[j, 2]),
                    categorical_2_bin={c: i for i, c in enumerate(cats)},
                    bin_2_categorical=cats))
        return self._mappers

    # -- serving-side re-bin ---------------------------------------------
    def rebin(self, X: np.ndarray):
        """(N, F) raw serving rows -> (codes, stats): training-bin codes
        through the version's own mappers plus the skew counters PSI
        alone cannot see — per-feature NaN counts, categorical values
        UNSEEN at training time, and numeric values outside the training
        range (both land in a boundary bin, where only the counter
        distinguishes 'drifted' from 'extreme but familiar')."""
        X = np.asarray(X, np.float64)
        if X.ndim != 2 or X.shape[1] != self.num_features:
            raise ValueError(
                f"rebin: rows have {X.shape[-1] if X.ndim else 0} "
                f"features, reference has {self.num_features}")
        N, F = X.shape
        codes = np.zeros((N, F), np.int32)
        nan_c = np.zeros(F, np.int64)
        unseen_c = np.zeros(F, np.int64)
        clip_c = np.zeros(F, np.int64)
        for f, m in enumerate(self.mappers()):
            col = X[:, f]
            isnan = np.isnan(col)
            codes[:, f] = m.value_to_bin(col)
            nan_c[f] = int(isnan.sum())
            if m.bin_type == BIN_CATEGORICAL:
                seen = np.isin(np.trunc(np.where(isnan, -1.0, col)),
                               np.asarray(m.bin_2_categorical, np.float64))
                unseen_c[f] = int((~isnan & ~seen).sum())
            elif not m.is_trivial:
                clip_c[f] = int((~isnan & ((col < m.min_value)
                                           | (col > m.max_value))).sum())
        return codes, {"nan": nan_c, "unseen": unseen_c, "clip": clip_c}

    def score_psi(self, scores: np.ndarray) -> float:
        """Prediction-score drift: PSI of the serving scores vs the
        training distribution, judged per class (out-of-edge values
        clamp into the boundary bins); returns the worst class."""
        from .drift import psi

        s = np.asarray(scores, np.float64)
        if s.ndim == 1:
            s = s.reshape(-1, 1)
        edges = self.score_edges
        nbins = len(edges) - 1
        worst = 0.0
        for k in range(min(s.shape[1], self.score_counts.shape[0])):
            b = np.clip(np.searchsorted(edges, s[:, k], side="right") - 1,
                        0, nbins - 1)
            cur = np.bincount(b, minlength=nbins)
            worst = max(worst, psi(self.score_counts[k], cur))
        return worst

    # -- serialization ---------------------------------------------------
    def to_bytes(self) -> bytes:
        """Deterministic binary payload + trailing SHA-256: identical
        state serializes to identical bytes."""
        header = {
            "format": REF_FORMAT, "version": REF_VERSION,
            "n_rows": int(self.n_rows), "num_class": int(self.num_class),
            "feature_names": [str(s) for s in self.feature_names],
            "arrays": [[name, dt, list(self.arrays[name].shape)]
                       for name, dt in _ARRAY_SPEC],
        }
        hb = json.dumps(header, sort_keys=True,
                        separators=(",", ":")).encode()
        parts = [_MAGIC, struct.pack("<I", len(hb)), hb]
        for name, dt in _ARRAY_SPEC:
            parts.append(np.ascontiguousarray(
                self.arrays[name].astype(dt, copy=False)).tobytes())
        payload = b"".join(parts)
        return payload + hashlib.sha256(payload).digest()

    @property
    def digest(self) -> str:
        return hashlib.sha256(self.to_bytes()).hexdigest()

    @classmethod
    def from_bytes(cls, data: bytes) -> "ModelReference":
        """Parse + verify; raises :class:`ModelReferenceError` on any
        integrity failure (torn payload, digest mismatch, bad header)."""
        try:
            if not data.startswith(_MAGIC):
                raise ModelReferenceError("not a model-reference payload")
            payload, want = data[:-32], data[-32:]
            if hashlib.sha256(payload).digest() != want:
                raise ModelReferenceError(
                    "digest mismatch (torn or corrupted reference)")
            off = len(_MAGIC)
            (hlen,) = struct.unpack_from("<I", payload, off)
            off += 4
            header = json.loads(payload[off: off + hlen])
            off += hlen
            if header.get("format") != REF_FORMAT:
                raise ModelReferenceError(
                    f"unknown format {header.get('format')!r}")
            arrays: Dict[str, np.ndarray] = {}
            for name, dt, shape in header["arrays"]:
                n = int(np.prod(shape)) if shape else 1
                nbytes = n * np.dtype(dt).itemsize
                arrays[name] = np.frombuffer(
                    payload, dtype=np.dtype(dt), count=n,
                    offset=off).reshape(shape).copy()
                off += nbytes
        except ModelReferenceError:
            raise
        except Exception as e:  # noqa: BLE001 — struct/json/shape errors
            raise ModelReferenceError(
                f"unreadable reference ({type(e).__name__}: {e})")
        return cls(n_rows=int(header["n_rows"]),
                   num_class=int(header["num_class"]),
                   feature_names=list(header["feature_names"]),
                   arrays=arrays)


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------


def _occupancy_counts(dataset) -> List[np.ndarray]:
    """Per-feature bin occupancy over the (already binned) (F, N)
    matrix: one int64 bincount a feature, or a streaming dataset's
    blocks folded one by one (a packed block decoded first): exact
    integer sums, so both give the same reference bytes."""
    nb = [int(m.num_bin) for m in dataset.bin_mappers]
    F = dataset.num_features
    counts = [np.zeros(n, np.int64) for n in nb]
    if getattr(dataset, "is_streaming", False):
        from ..data.block_cache import unpack4bit

        packed = dataset.source.bin_layout == "packed4"
        for _, _, blk in dataset.iter_blocks():
            blk = unpack4bit(blk, F) if packed else blk
            for f in range(F):
                counts[f] += np.bincount(
                    blk[f].astype(np.int64), minlength=nb[f])[: nb[f]]
        return counts
    binned = dataset.binned
    if binned is None:
        raise ModelReferenceError(
            "reference capture needs dense bins (EFB bundle-only sparse "
            "datasets keep no per-feature matrix)")
    binned = np.asarray(binned)
    for f in range(F):
        counts[f] += np.bincount(
            binned[f].astype(np.int64), minlength=nb[f])[: nb[f]]
    return counts


def capture_reference(dataset, raw_scores: np.ndarray,
                      score_bins: int = DEFAULT_SCORE_BINS
                      ) -> ModelReference:
    """One pass over the binned training matrix + the trained score
    cache -> a :class:`ModelReference`.

    ``dataset`` is the trainer's BinnedDataset; ``raw_scores`` the
    (N, K) raw training scores at capture time (the trainer's f32 score
    cache)."""
    mappers = dataset.bin_mappers
    F = dataset.num_features
    N = int(dataset.num_data)
    counts = _occupancy_counts(dataset)

    sc = np.zeros((F, 4), np.int64)
    fl = np.zeros((F, 3), np.float64)
    ub_parts, cat_parts = [], []
    uoff = np.zeros(F + 1, np.int64)
    coff = np.zeros(F + 1, np.int64)
    nan_rate = np.zeros(F, np.float64)
    for j, m in enumerate(mappers):
        sc[j] = (m.num_bin, m.missing_type, m.bin_type, int(m.is_trivial))
        fl[j] = (m.sparse_rate, m.min_value, m.max_value)
        ub = np.asarray(m.bin_upper_bound, np.float64)
        ub_parts.append(ub)
        uoff[j + 1] = uoff[j] + len(ub)
        cats = np.asarray(m.bin_2_categorical, np.int64)
        cat_parts.append(cats)
        coff[j + 1] = coff[j] + len(cats)
        if N and (m.bin_type == BIN_CATEGORICAL
                  or m.missing_type == MISSING_NAN):
            nan_rate[j] = float(counts[j][m.nan_bin]) / N

    count_off = np.zeros(F + 1, np.int64)
    for j in range(F):
        count_off[j + 1] = count_off[j] + len(counts[j])

    s = np.asarray(raw_scores, np.float64)
    if s.ndim == 1:
        s = s.reshape(-1, 1)
    K = s.shape[1]
    S = max(int(score_bins), 2)
    lo = float(s.min()) if s.size else 0.0
    hi = float(s.max()) if s.size else 1.0
    if not hi > lo:
        hi = lo + 1.0
    edges = np.linspace(lo, hi, S + 1)
    score_counts = np.zeros((K, S), np.int64)
    for k in range(K):
        b = np.clip(np.searchsorted(edges, s[:, k], side="right") - 1,
                    0, S - 1)
        score_counts[k] = np.bincount(b, minlength=S)

    arrays = {
        "mapper_scalars": sc,
        "mapper_floats": fl,
        "ubound_offsets": uoff,
        "ubound_flat": (np.concatenate(ub_parts) if ub_parts
                        else np.zeros(0, np.float64)),
        "cat_offsets": coff,
        "cat_flat": (np.concatenate(cat_parts) if cat_parts
                     else np.zeros(0, np.int64)),
        "count_offsets": count_off,
        "count_flat": (np.concatenate(counts) if counts
                       else np.zeros(0, np.int64)),
        "nan_rate": nan_rate,
        "score_edges": edges,
        "score_counts": score_counts,
    }
    return ModelReference(
        n_rows=N, num_class=K,
        feature_names=[str(n) for n in dataset.feature_names],
        arrays=arrays)


# ---------------------------------------------------------------------------
# trainer quality telemetry
# ---------------------------------------------------------------------------


def _stats(vals: np.ndarray, nd: int = 6) -> Dict[str, float]:
    if vals.size == 0:
        return {"count": 0}
    v = np.asarray(vals, np.float64)
    return {
        "count": int(v.size),
        "mean": round(float(v.mean()), nd),
        "p50": round(float(np.percentile(v, 50)), nd),
        "p90": round(float(np.percentile(v, 90)), nd),
        "max": round(float(v.max()), nd),
        "total": round(float(v.sum()), nd),
    }


def quality_snapshot(booster, top_k: int = 8) -> Dict[str, Any]:
    """Model-quality telemetry of a trained booster, computed AFTER the
    fact from host trees + the engine-recorded metric history — the
    training loop is never perturbed.

    Returns per-iteration split-gain / leaf / depth aggregates, the
    whole-run gain distribution, gain/split feature importance (top-K
    named), and the train/valid metric curves."""
    from ..models.tree import host_tree_depth

    trees = booster._all_trees()
    K = max(booster.num_model_per_iteration(), 1)
    names = booster.feature_name()
    F = booster.num_feature()
    gains_all: List[float] = []
    per_tree = []
    for t in trees:
        g = np.asarray(t.split_gain[: max(t.num_leaves - 1, 0)],
                       np.float64)
        gains_all.extend(g.tolist())
        per_tree.append({"leaves": int(t.num_leaves),
                         "depth": int(host_tree_depth(t)),
                         "gain_total": float(g.sum()),
                         "gain_max": float(g.max()) if g.size else 0.0})
    per_iteration = []
    for i in range(0, len(per_tree), K):
        grp = per_tree[i: i + K]
        per_iteration.append({
            "iteration": i // K,
            "leaves": sum(d["leaves"] for d in grp),
            "depth_max": max(d["depth"] for d in grp),
            "gain_total": round(sum(d["gain_total"] for d in grp), 6),
            "gain_max": round(max(d["gain_max"] for d in grp), 6),
        })
    imp_gain = booster.feature_importance("gain")
    imp_split = booster.feature_importance("split")
    order = np.argsort(-imp_gain, kind="stable")
    top = [{"feature": names[int(f)] if int(f) < len(names) else str(f),
            "index": int(f), "gain": round(float(imp_gain[f]), 6),
            "splits": int(imp_split[f])}
           for f in order[:top_k] if imp_gain[f] > 0]
    leaves = np.asarray([d["leaves"] for d in per_tree], np.float64)
    depths = np.asarray([d["depth"] for d in per_tree], np.float64)
    return {
        "n_trees": len(trees),
        "n_iterations": len(per_iteration),
        "num_class": K,
        "num_features": F,
        "split_gain": _stats(np.asarray(gains_all)),
        "tree_leaves": _stats(leaves, nd=2),
        "tree_depth": _stats(depths, nd=2),
        "per_iteration": per_iteration,
        "importance_top": top,
        "importance_gain": [round(float(v), 6) for v in imp_gain],
        "importance_split": [int(v) for v in imp_split],
        "metric_history": {
            k: list(v)
            for k, v in getattr(booster, "_metric_history", {}).items()},
    }


def importance_shift(prev_gain, cur_gain) -> Dict[str, Any]:
    """Importance drift between two published versions: L1 distance of
    the normalized gain-importance vectors (0 = identical ranking mass,
    2 = disjoint) + the feature that moved most.  ``publish`` diffs this
    between the outgoing and incoming ModelVersion metas."""
    p = np.asarray(prev_gain, np.float64)
    q = np.asarray(cur_gain, np.float64)
    n = max(len(p), len(q))
    p = np.pad(p, (0, n - len(p)))
    q = np.pad(q, (0, n - len(q)))
    ps, qs = p.sum(), q.sum()
    p = p / ps if ps > 0 else p
    q = q / qs if qs > 0 else q
    delta = q - p
    top = int(np.argmax(np.abs(delta))) if n else 0
    return {"l1": round(float(np.abs(delta).sum()), 6),
            "top_mover": top,
            "top_mover_delta": round(float(delta[top]), 6) if n else 0.0}


__all__ = ["ModelReference", "ModelReferenceError", "capture_reference",
           "quality_snapshot", "importance_shift",
           "DEFAULT_SCORE_BINS", "REF_FORMAT", "REF_VERSION"]
