"""Feature binning (host numpy) — the port's copy of the numeric half of
lightgbmv1_tpu/io/binning.py.

``BinMapper.find_bin`` (:396) with ``_greedy_find_bin`` (:78),
``_find_bin_with_zero_as_one_bin`` (:152) and ``_distinct_with_zero``
(:200), and ``value_to_bin`` (:535): the greedy equal-count boundary
search on a sample, the zero-straddling bin, missing handling
(None / Zero / NaN with a trailing NaN bin) and trivial-feature
detection, computed in float64 exactly as the JAX package computes them,
so the boundaries and bins are bit-identical
(tests/test_torch_train.py).  Categorical features and forced bin bounds
are not ported yet (ROADMAP queue 1, breadth of objectives and boosting):
``find_bin`` raises for them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

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
                 filter_cnt: int) -> bool:
    """feature_pre_filter (reference NeedFilter, bin.cpp:54-76), numerical:
    True when no split point puts >= filter_cnt samples on both sides."""
    cnt = np.asarray(cnt_in_bin, dtype=np.int64)
    if len(cnt) < 2:
        return True
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


@dataclass
class BinMapper:
    """Maps one numerical feature's raw values to small integer bins."""

    bin_upper_bound: np.ndarray = field(
        default_factory=lambda: np.array([np.inf]))
    num_bin: int = 1
    missing_type: int = MISSING_NONE
    bin_type: int = BIN_NUMERICAL
    is_trivial: bool = True
    sparse_rate: float = 0.0
    min_value: float = 0.0
    max_value: float = 0.0

    @property
    def nan_bin(self) -> int:
        """Bin holding NaN values; -1 if none."""
        return self.num_bin - 1 if self.missing_type == MISSING_NAN else -1

    @property
    def zero_bin(self) -> int:
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
                 filter_cnt: int = 0) -> "BinMapper":
        """BinMapper::FindBin (reference bin.cpp:325-...).  Rows missing
        from ``sample_values`` count as ``total_sample_cnt -
        len(sample_values)`` implicit zeros."""
        if bin_type != BIN_NUMERICAL:
            from ..config import BREADTH, not_ported

            raise not_ported("categorical binning", BREADTH)
        m = cls()
        vals = np.asarray(sample_values, dtype=np.float64)
        na_cnt = int(np.isnan(vals).sum())
        vals = vals[~np.isnan(vals)]
        implicit_zero_cnt = total_sample_cnt - len(vals) - na_cnt

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

    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized ValueToBin (reference bin.h:457-495)."""
        v = np.asarray(values, dtype=np.float64)
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
        """feature_infos entry of the model text."""
        if self.is_trivial:
            return "none"
        return f"[{self.min_value:g}:{self.max_value:g}]"
