"""Feature binning (host numpy) — the port's copy of the numeric half of
lightgbmv1_tpu/io/binning.py.

``BinMapper.find_bin`` (:396) with ``_greedy_find_bin`` (:78),
``_find_bin_with_zero_as_one_bin`` (:152) and ``_distinct_with_zero``
(:200), and ``value_to_bin`` (:535): the greedy equal-count boundary
search on a sample, the zero-straddling bin, missing handling
(None / Zero / NaN with a trailing NaN bin) and trivial-feature
detection, computed in float64 exactly as the JAX package computes them,
so the boundaries and bins are bit-identical
(tests/test_torch_train.py); the forced upper bounds of
``forcedbins_filename`` (``get_forced_bins`` :309,
``_find_bin_with_predefined`` :240); and categorical features
(``_find_bin_categorical`` :505): values truncated toward zero (not
rounded), the categories kept by descending count (``max_bin - 1`` of
them) and one trailing bin for the rest (NaN, negative values, unseen
categories), ``value_to_bin`` / ``default_bin`` / ``feature_info_str``
(``c1:c2:...``) for them, and their pre-filter (2-bin features only).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

# |v| <= K_ZERO_THRESHOLD counts as zero (reference kZeroThreshold)
K_ZERO_THRESHOLD = 1e-35

# per-feature missing-value handling (reference MissingType)
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_NUMERICAL = 0
BIN_CATEGORICAL = 1


def _need_filter(cnt_in_bin: np.ndarray, total_cnt: int,
                 filter_cnt: int, bin_type: int = BIN_NUMERICAL) -> bool:
    """feature_pre_filter (reference NeedFilter, bin.cpp:54-76): True when
    no split point puts >= filter_cnt samples on both sides; a categorical
    feature is filtered only at 2 bins (its one-vs-rest splits are not
    prefix sums)."""
    cnt = np.asarray(cnt_in_bin, dtype=np.int64)
    if len(cnt) < 2:
        return True
    if bin_type != BIN_NUMERICAL and len(cnt) > 2:
        return False
    left = np.cumsum(cnt[:-1])
    return not bool(np.any((left >= filter_cnt)
                           & (total_cnt - left >= filter_cnt)))


def _upper_bound_1ulp(a: float) -> float:
    """Common::GetDoubleUpperBound (reference utils/common.h:931)."""
    return float(np.nextafter(a, np.inf))


def _eq_ordered(a: float, b: float) -> bool:
    """Common::CheckDoubleEqualOrdered for sorted a <= b: b within one ulp
    above a."""
    return b <= np.nextafter(a, np.inf)


def _greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                     max_bin: int, total_cnt: int,
                     min_data_in_bin: int) -> List[float]:
    """Greedy equal-count boundary search (reference GreedyFindBin,
    bin.cpp:78-156): the adaptive mean-bin-size recomputation, the
    big-count-value lookahead and the one-ulp boundary dedupe."""
    bounds: List[float] = []
    nd = len(distinct_values)
    if nd == 0:
        return [math.inf]
    if nd <= max_bin:
        cur = 0
        for i in range(nd - 1):
            cur += int(counts[i])
            if cur >= min_data_in_bin:
                val = _upper_bound_1ulp(
                    (distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not bounds or not _eq_ordered(bounds[-1], val):
                    bounds.append(val)
                    cur = 0
        bounds.append(math.inf)
        return bounds

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, int(total_cnt) // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin

    rest_bin_cnt = max_bin
    rest_sample_cnt = int(total_cnt)
    is_big = np.asarray(counts, np.int64) >= mean_bin_size
    rest_bin_cnt -= int(is_big.sum())
    rest_sample_cnt -= int(counts[is_big].sum())

    def _mean(cnt, bins):
        if bins != 0:
            return cnt / bins
        return math.inf if cnt > 0 else math.nan

    mean_bin_size = _mean(rest_sample_cnt, rest_bin_cnt)
    upper = [math.inf] * max_bin
    lower = [math.inf] * max_bin
    bin_cnt = 0
    lower[0] = float(distinct_values[0])
    cur = 0
    for i in range(nd - 1):
        if not is_big[i]:
            rest_sample_cnt -= int(counts[i])
        cur += int(counts[i])
        if (is_big[i] or cur >= mean_bin_size
                or (is_big[i + 1] and cur >= max(1.0, mean_bin_size * 0.5))):
            upper[bin_cnt] = float(distinct_values[i])
            bin_cnt += 1
            lower[bin_cnt] = float(distinct_values[i + 1])
            if bin_cnt >= max_bin - 1:
                break
            cur = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = _mean(rest_sample_cnt, rest_bin_cnt)
    bin_cnt += 1
    for i in range(bin_cnt - 1):
        val = _upper_bound_1ulp((upper[i] + lower[i + 1]) / 2.0)
        if not bounds or not _eq_ordered(bounds[-1], val):
            bounds.append(val)
    bounds.append(math.inf)
    return bounds


def _find_bin_with_zero_as_one_bin(distinct_values: np.ndarray,
                                   counts: np.ndarray, max_bin: int,
                                   total_sample_cnt: int,
                                   min_data_in_bin: int) -> List[float]:
    """One bin straddles zero (reference FindBinWithZeroAsOneBin,
    bin.cpp:256-312): the negative range takes a count-proportional share
    of ``max_bin - 1`` bins, the zero bin closes at kZeroThreshold, the
    positive range takes the rest."""
    dv = np.asarray(distinct_values, np.float64)
    left_cnt_data = int(counts[dv <= -K_ZERO_THRESHOLD].sum())
    right_cnt_data = int(counts[dv > K_ZERO_THRESHOLD].sum())
    cnt_zero = int(total_sample_cnt) - left_cnt_data - right_cnt_data

    left_cnt = int(np.argmax(dv > -K_ZERO_THRESHOLD)) \
        if bool((dv > -K_ZERO_THRESHOLD).any()) else len(dv)

    bounds: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        denom = total_sample_cnt - cnt_zero
        left_max_bin = int(left_cnt_data / max(denom, 1) * (max_bin - 1))
        left_max_bin = max(1, left_max_bin)
        bounds = _greedy_find_bin(dv[:left_cnt], counts[:left_cnt],
                                  left_max_bin, left_cnt_data,
                                  min_data_in_bin)
        if bounds:
            bounds[-1] = -K_ZERO_THRESHOLD

    right_pos = np.nonzero(dv[left_cnt:] > K_ZERO_THRESHOLD)[0]
    right_start = left_cnt + int(right_pos[0]) if len(right_pos) else -1

    right_max_bin = max_bin - 1 - len(bounds)
    # positives with no bins left: the reference appends +inf, not
    # kZeroThreshold (bin.cpp:302-309)
    if right_start >= 0 and right_max_bin > 0:
        rb = _greedy_find_bin(dv[right_start:], counts[right_start:],
                              right_max_bin, right_cnt_data, min_data_in_bin)
        bounds.append(K_ZERO_THRESHOLD)
        bounds.extend(rb)
    else:
        bounds.append(math.inf)
    return bounds


def _distinct_with_zero(values_sorted: np.ndarray, zero_cnt: int):
    """Distinct values + counts of a sorted non-NaN sample (reference
    bin.cpp:352-390): neighbours within one ulp merge (keeping the larger
    value) and the implicit-zero count is spliced in where zero sorts."""
    n = len(values_sorted)
    if n == 0:
        return np.array([0.0]), np.array([zero_cnt], np.int64)
    v = values_sorted
    new_grp = np.empty(n, bool)
    new_grp[0] = True
    new_grp[1:] = v[1:] > np.nextafter(v[:-1], np.inf)
    gid = np.cumsum(new_grp) - 1
    counts = np.bincount(gid).astype(np.int64)
    ends = np.cumsum(counts) - 1
    distinct = v[ends]                 # the reference keeps the LARGE value
    starts = ends - counts + 1

    out_v: List[float] = []
    out_c: List[int] = []
    if v[0] > 0.0 and zero_cnt > 0:
        out_v.append(0.0)
        out_c.append(zero_cnt)
    for g in range(len(distinct)):
        if g > 0 and v[starts[g] - 1] < 0.0 and v[starts[g]] > 0.0:
            # sign change: splice zero (even with a zero count, as the
            # reference does)
            out_v.append(0.0)
            out_c.append(zero_cnt)
        out_v.append(float(distinct[g]))
        out_c.append(int(counts[g]))
    if v[-1] < 0.0 and zero_cnt > 0:
        out_v.append(0.0)
        out_c.append(zero_cnt)
    return np.asarray(out_v, np.float64), np.asarray(out_c, np.int64)


def _find_bin_with_predefined(distinct_values: np.ndarray,
                              counts: np.ndarray, max_bin: int,
                              total_sample_cnt: int, min_data_in_bin: int,
                              forced_upper_bounds: Sequence[float]
                              ) -> List[float]:
    """Bin boundaries honouring forced upper bounds (JAX :240; reference
    FindBinWithPredefinedBin, bin.cpp:157-255): the zero-straddle bounds
    and the forced ones seed the list, then each seeded range is split
    greedily with a bin budget in proportion to its sample count."""
    bounds: List[float] = []
    left_cnt = int(np.searchsorted(distinct_values, -K_ZERO_THRESHOLD,
                                   side="right"))
    right_start = int(np.searchsorted(distinct_values, K_ZERO_THRESHOLD,
                                      side="right"))
    if max_bin == 2:
        bounds.append(K_ZERO_THRESHOLD if left_cnt == 0
                      else -K_ZERO_THRESHOLD)
    elif max_bin >= 3:
        if left_cnt > 0:
            bounds.append(-K_ZERO_THRESHOLD)
        if right_start < len(distinct_values):
            bounds.append(K_ZERO_THRESHOLD)
    bounds.append(math.inf)
    # the forced bounds away from zero, up to the budget
    room = max_bin - len(bounds)
    for b in [b for b in forced_upper_bounds
              if abs(b) > K_ZERO_THRESHOLD][:max(room, 0)]:
        bounds.append(float(b))
    bounds.sort()
    free_bins = max_bin - len(bounds)
    to_add: List[float] = []
    value_ind = 0
    for i, ub in enumerate(bounds):
        bin_start = value_ind
        cnt_in_bin = 0
        while (value_ind < len(distinct_values)
               and distinct_values[value_ind] < ub):
            cnt_in_bin += int(counts[value_ind])
            value_ind += 1
        remaining = max_bin - len(bounds) - len(to_add)
        # std::lround: half away from zero
        num_sub = int(math.floor(
            cnt_in_bin * free_bins / max(total_sample_cnt, 1) + 0.5))
        num_sub = min(num_sub, remaining) + 1
        if i == len(bounds) - 1:
            num_sub = remaining + 1
        if num_sub > 1 and value_ind > bin_start:
            sub = _greedy_find_bin(distinct_values[bin_start:value_ind],
                                   counts[bin_start:value_ind], num_sub,
                                   cnt_in_bin, min_data_in_bin)
            to_add.extend(sub[:-1])          # the last bound is +inf
    bounds.extend(to_add)
    return sorted(set(bounds))


def get_forced_bins(path: str, num_total_features: int,
                    categorical_features=None) -> List[List[float]]:
    """``forcedbins_filename``'s JSON -> each feature's forced upper
    bounds (JAX :309; reference DatasetLoader::GetForcedBins,
    dataset_loader.cpp:1200-1235), ``[{"feature": i, "bin_upper_bound":
    [...]}, ...]``; a file that cannot be opened is ignored with a
    warning, consecutive duplicates dropped."""
    import json

    from ..utils.fileio import open_file
    from ..utils.log import log_fatal, log_warning

    forced: List[List[float]] = [[] for _ in range(num_total_features)]
    if not path:
        return forced
    categorical = set(categorical_features or [])
    try:
        with open_file(path) as fh:
            spec = json.load(fh)
    except OSError:
        log_warning(f"Could not open {path}. Will ignore.")
        return forced
    except json.JSONDecodeError as e:
        log_fatal(f"Forced bins file {path} is not valid JSON: {e}")
    for entry in spec:
        f = int(entry["feature"])
        if f >= num_total_features or f < 0:
            log_fatal(f"Forced bins feature index {f} is out of range "
                      f"(num features = {num_total_features})")
        if f in categorical:
            log_warning(f"Feature {f} is categorical. Will ignore forced "
                        "bins for this feature.")
            continue
        forced[f] = [float(b) for b in entry["bin_upper_bound"]]
    for f in range(num_total_features):
        out: List[float] = []
        for b in forced[f]:
            if not out or b != out[-1]:
                out.append(b)
        forced[f] = out
    return forced


@dataclass
class BinMapper:
    """Maps one feature's raw values to small integer bins."""

    bin_upper_bound: np.ndarray = field(
        default_factory=lambda: np.array([np.inf]))
    num_bin: int = 1
    missing_type: int = MISSING_NONE
    bin_type: int = BIN_NUMERICAL
    is_trivial: bool = True
    sparse_rate: float = 0.0
    min_value: float = 0.0
    max_value: float = 0.0
    # categorical: category -> bin, and each bin's category
    categorical_2_bin: Dict[int, int] = field(default_factory=dict)
    bin_2_categorical: List[int] = field(default_factory=list)

    @property
    def nan_bin(self) -> int:
        """Bin holding NaN values; -1 if none (a categorical feature's
        trailing other / unseen bin takes NaN)."""
        if self.bin_type == BIN_CATEGORICAL:
            return self.num_bin - 1
        return self.num_bin - 1 if self.missing_type == MISSING_NAN else -1

    @property
    def zero_bin(self) -> int:
        if self.bin_type == BIN_CATEGORICAL:
            return int(self.categorical_2_bin.get(0, self.num_bin - 1))
        return int(np.searchsorted(self.bin_upper_bound, 0.0, side="left"))

    @property
    def default_bin(self) -> int:
        """Bin that missing values fall into during training."""
        if self.missing_type == MISSING_NAN:
            return self.nan_bin
        return self.zero_bin

    @classmethod
    def find_bin(cls, sample_values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int = 3,
                 bin_type: int = BIN_NUMERICAL, use_missing: bool = True,
                 zero_as_missing: bool = False, pre_filter: bool = False,
                 filter_cnt: int = 0,
                 forced_bounds: Optional[Sequence[float]] = None
                 ) -> "BinMapper":
        """BinMapper::FindBin (reference bin.cpp:325-...).  Rows missing
        from ``sample_values`` count as ``total_sample_cnt -
        len(sample_values)`` implicit zeros; ``forced_bounds`` switch the
        boundary search to ``_find_bin_with_predefined``."""
        m = cls()
        m.bin_type = bin_type
        vals = np.asarray(sample_values, dtype=np.float64)
        na_cnt = int(np.isnan(vals).sum())
        vals = vals[~np.isnan(vals)]
        implicit_zero_cnt = total_sample_cnt - len(vals) - na_cnt
        if bin_type == BIN_CATEGORICAL:
            m, cnt_in_bin = cls._find_bin_categorical(
                m, vals, implicit_zero_cnt, max_bin, use_missing, na_cnt)
            if not m.is_trivial and pre_filter and _need_filter(
                    cnt_in_bin, total_sample_cnt, filter_cnt,
                    BIN_CATEGORICAL):
                m.is_trivial = True
            return m

        # missing type (reference bin.cpp:351-380)
        if not use_missing:
            m.missing_type = MISSING_NONE
        elif zero_as_missing:
            m.missing_type = MISSING_ZERO
        elif na_cnt > 0:
            m.missing_type = MISSING_NAN
        else:
            m.missing_type = MISSING_NONE
        if m.missing_type != MISSING_NAN:
            # NaN samples fold into the implicit zeros outside the NaN type
            implicit_zero_cnt += na_cnt
            na_cnt = 0

        if len(vals) == 0 and implicit_zero_cnt == 0:
            m.bin_upper_bound = np.array([np.inf])
            m.num_bin = 2 if m.missing_type == MISSING_NAN else 1
            m.is_trivial = m.num_bin <= 1
            return m

        vals_sorted = np.sort(vals, kind="stable")
        distinct, counts = _distinct_with_zero(vals_sorted, implicit_zero_cnt)
        m.min_value = float(distinct[0])
        m.max_value = float(distinct[-1])

        # the NaN type reserves one bin and leaves NaNs out of the total
        if m.missing_type == MISSING_NAN:
            budget, total_eff = max_bin - 1, total_sample_cnt - na_cnt
        else:
            budget, total_eff = max_bin, total_sample_cnt
        budget = max(budget, 2)
        if forced_bounds:
            bounds = _find_bin_with_predefined(
                distinct, counts, budget, total_eff, min_data_in_bin,
                forced_bounds)
        else:
            bounds = _find_bin_with_zero_as_one_bin(
                distinct, counts, budget, total_eff, min_data_in_bin)
        if m.missing_type == MISSING_ZERO and len(bounds) == 2:
            # a 2-bin zero-as-missing feature has no missing handling
            m.missing_type = MISSING_NONE
        m.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
        m.num_bin = len(bounds)
        if m.missing_type == MISSING_NAN:
            m.num_bin += 1  # trailing NaN bin
        zero_total = int(counts[np.abs(distinct) <= K_ZERO_THRESHOLD].sum())
        m.sparse_rate = zero_total / max(len(vals) + implicit_zero_cnt, 1)
        m.is_trivial = m.num_bin <= 1
        if not m.is_trivial and pre_filter:
            bin_of = np.searchsorted(m.bin_upper_bound, distinct, side="left")
            np.clip(bin_of, 0, len(m.bin_upper_bound) - 1, out=bin_of)
            cnt_in_bin = np.bincount(bin_of, weights=counts,
                                     minlength=m.num_bin).astype(np.int64)
            if m.missing_type == MISSING_NAN:
                cnt_in_bin[m.num_bin - 1] = na_cnt
            if _need_filter(cnt_in_bin, total_sample_cnt, filter_cnt):
                m.is_trivial = True
        return m

    @staticmethod
    def _find_bin_categorical(m, vals, implicit_zero_cnt, max_bin,
                              use_missing, na_cnt):
        """The categorical mapper (JAX :505): categories are the values
        truncated toward zero (the reference's C cast), negative ones
        dropped; the implicit zeros count as category 0; the ``max_bin -
        1`` most frequent kept in descending count (ties in category
        order), the rest, NaN and unseen categories sharing the trailing
        bin.  Returns the mapper and its per-bin sample counts."""
        cats = np.trunc(vals).astype(np.int64)
        cats = cats[cats >= 0]
        if implicit_zero_cnt > 0:
            cats = np.concatenate([cats, np.zeros(implicit_zero_cnt,
                                                  dtype=np.int64)])
        distinct, counts = np.unique(cats, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        distinct, counts = distinct[order], counts[order]
        keep = min(len(distinct), max_bin - 1)
        m.bin_2_categorical = [int(c) for c in distinct[:keep]]
        m.categorical_2_bin = {c: i for i, c in
                               enumerate(m.bin_2_categorical)}
        m.num_bin = keep + 1
        cnt_in_bin = [int(c) for c in counts[:keep]] + [
            int(counts[keep:].sum()) + na_cnt]
        m.missing_type = (MISSING_NAN if (use_missing and na_cnt > 0)
                          else MISSING_NONE)
        m.is_trivial = keep <= 1
        m.min_value = float(distinct.min()) if len(distinct) else 0.0
        m.max_value = float(distinct.max()) if len(distinct) else 0.0
        m.bin_upper_bound = np.array([np.inf])
        return m, cnt_in_bin

    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized ValueToBin (reference bin.h:457-495); a categorical
        value's truncated category's bin, the trailing bin for NaN,
        negative and unseen values."""
        v = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_CATEGORICAL:
            out = np.full(v.shape, self.num_bin - 1, dtype=np.int32)
            nan_mask = np.isnan(v)
            cats = np.trunc(np.where(nan_mask, -1, v)).astype(np.int64)
            if self.bin_2_categorical:
                # each kept category's bin, by one sorted lookup
                keys = np.asarray(self.bin_2_categorical, np.int64)
                order = np.argsort(keys)
                pos = np.clip(np.searchsorted(keys[order], cats), 0,
                              len(keys) - 1)
                hit = keys[order][pos] == cats
                out[hit] = order[pos[hit]]
            return out
        nan_mask = np.isnan(v)
        # NaN goes to the zero bin, then to the trailing NaN bin for the
        # NaN missing type
        v = np.where(nan_mask, 0.0, v)
        out = np.searchsorted(self.bin_upper_bound, v,
                              side="left").astype(np.int32)
        np.clip(out, 0, len(self.bin_upper_bound) - 1, out=out)
        if self.missing_type == MISSING_NAN:
            out[nan_mask] = self.num_bin - 1
        return out

    def bin_to_threshold(self, bin_idx: int) -> float:
        """The real threshold a model stores for a bin split: the bin's
        upper bound, +-inf written as +-1e300 (reference AvoidInf)."""
        b = min(int(bin_idx), len(self.bin_upper_bound) - 1)
        ub = self.bin_upper_bound[b]
        if math.isinf(ub):
            ub = 1e300
        return float(ub)

    def feature_info_str(self) -> str:
        """feature_infos entry of the model text: ``[min:max]``, a
        categorical feature's categories ``c1:c2:...``."""
        if self.is_trivial:
            return "none"
        if self.bin_type == BIN_CATEGORICAL:
            return ":".join(str(c) for c in self.bin_2_categorical)
        return f"[{self.min_value:g}:{self.max_value:g}]"
