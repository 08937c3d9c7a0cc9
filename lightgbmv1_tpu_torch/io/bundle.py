"""Exclusive Feature Bundling — detection only.

The port's copy of lightgbmv1_tpu/io/bundle.py ``find_bundles`` (:72) and
``conflict_masks_from_dense`` (:152), behind ``bundle_would_form``, the
test ``maybe_bundle`` (:286) makes before it bundles a dense binned
matrix.  Training on bundled columns is not ported yet (ROADMAP queue 1,
breadth of objectives and boosting): the dataset raises where the JAX
package would bundle.  Dense data forms no bundle.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

MAX_BUNDLE_BINS = 256      # uint8 bundles only
_CONFLICT_SAMPLE = 32768   # rows sampled for conflict counting


def find_bundles(nonzero_masks: np.ndarray, num_bins: Sequence[int],
                 max_conflict_rate: float = 0.0,
                 max_bundle_bins: int = MAX_BUNDLE_BINS) -> int:
    """Greedy conflict-bounded grouping (reference ``FindGroups``,
    src/io/dataset.cpp:97-235) of (F, S) sampled non-zero masks; returns
    the number of bundle columns it forms."""
    F, S = nonzero_masks.shape
    num_bins = np.asarray(num_bins, dtype=np.int64)
    budget = int(max_conflict_rate * S)
    order = np.argsort(-nonzero_masks.sum(axis=1, dtype=np.int64),
                       kind="stable")
    group_masks: List[np.ndarray] = []
    group_conflicts: List[int] = []
    group_bins: List[int] = []
    max_search = 256
    rng = np.random.RandomState(3)
    for f in order:
        fm = nonzero_masks[f]
        nb = int(num_bins[f])
        placed = False
        n_groups = len(group_masks)
        if n_groups <= max_search:
            candidates = range(n_groups)
        else:
            candidates = rng.choice(n_groups, size=max_search, replace=False)
        for g in candidates:
            if group_bins[g] + nb > max_bundle_bins:
                continue
            cnt = int(np.count_nonzero(group_masks[g] & fm))
            if group_conflicts[g] + cnt <= budget:
                group_masks[g] |= fm
                group_conflicts[g] += cnt
                group_bins[g] += nb
                placed = True
                break
        if not placed:
            group_masks.append(fm.copy())
            group_conflicts.append(0)
            group_bins.append(1 + nb)    # + the shared all-zero bin
    return len(group_masks)


def conflict_masks_from_dense(binned: np.ndarray, zero_bins: Sequence[int],
                              sample_cnt: int = _CONFLICT_SAMPLE,
                              seed: int = 1) -> np.ndarray:
    """(F, S) bool sampled non-zero masks of a dense (F, N) binned matrix."""
    F, N = binned.shape
    rng = np.random.RandomState(seed)
    if N > sample_cnt:
        sub = binned[:, rng.choice(N, size=sample_cnt, replace=False)]
    else:
        sub = binned
    zb = np.asarray(zero_bins, dtype=binned.dtype)[:, None]
    return sub != zb


def bundle_would_form(binned: np.ndarray, zero_bins, num_bins,
                      max_conflict_rate: float = 0.0,
                      min_saving: float = 0.2) -> bool:
    """True where the JAX package's ``maybe_bundle`` would bundle: at
    least 3 features and a grouping that saves ``min_saving`` of the
    columns."""
    F = binned.shape[0]
    if F < 3:
        return False
    n = find_bundles(conflict_masks_from_dense(binned, zero_bins), num_bins,
                     max_conflict_rate=max_conflict_rate)
    return n < F and n <= F * (1.0 - min_saving)
