"""Serving SLOs with multi-window burn-rate evaluation; the port's copy of
lightgbmv1_tpu/serve/slo.py.

Two objectives: **availability** (the fraction of admitted-or-shed
requests answered: sheds, queue timeouts, batch errors and watchdog
failures all spend budget) and **latency** (the fraction of answered
requests under the objective's threshold; failed requests are
availability's, never billed twice).

**Burn rate** is the error fraction over the budget fraction
``(1 - target)``: burn 1.0 spends the budget exactly over the period.
Each objective is judged over a slow window (the trend) and a fast one
(it is still happening); an alert needs BOTH over its threshold:
``page`` at ``fast_burn`` (default 14.4), ``warn`` at ``slow_burn``
(default 6).

**Exemplars**: the tracker keeps the worst ``worst_k`` ``(latency,
trace_id)`` pairs, and the serving latency histogram keeps a worst-tail
trace id a bucket, so ``GET /slo`` names the requests to look up in a
trace.

State is a ring of time buckets (``bucket_s``) sized to the slow
window: O(1) a record.  Every entry point takes an optional ``now`` so
tests replay traffic under their own clock.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class SLOConfig:
    """SLO policy knobs (mirrored by the ``serve_slo_*`` config names)."""

    availability_target: float = 0.999   # fraction answered successfully
    latency_ms: float = 50.0             # latency objective threshold
    latency_target: float = 0.99         # fraction of good reqs under it
    fast_window_s: float = 60.0          # short confirmation window
    slow_window_s: float = 600.0         # long trend window
    fast_burn: float = 14.4              # page threshold (both windows)
    slow_burn: float = 6.0               # warn threshold (both windows)
    bucket_s: float = 1.0                # ring resolution
    worst_k: int = 8                     # exemplar trace ids retained

    def __post_init__(self):
        for name in ("availability_target", "latency_target"):
            v = float(getattr(self, name))
            if not 0.0 < v < 1.0:
                raise ValueError(f"{name} must be in (0, 1), got {v}")
            setattr(self, name, v)
        self.latency_ms = max(float(self.latency_ms), 0.0)
        self.bucket_s = max(float(self.bucket_s), 1e-3)
        self.fast_window_s = max(float(self.fast_window_s), self.bucket_s)
        self.slow_window_s = max(float(self.slow_window_s),
                                 self.fast_window_s)
        self.fast_burn = max(float(self.fast_burn), 0.0)
        self.slow_burn = max(float(self.slow_burn), 0.0)
        self.worst_k = max(int(self.worst_k), 0)


class _Bucket:
    __slots__ = ("idx", "total", "errors", "slow")

    def __init__(self):
        self.idx = -1
        self.total = 0
        self.errors = 0
        self.slow = 0

    def reset(self, idx: int) -> None:
        self.idx = idx
        self.total = 0
        self.errors = 0
        self.slow = 0


class SLOTracker:
    """Thread-safe request-outcome accumulator + burn-rate evaluator."""

    def __init__(self, config: Optional[SLOConfig] = None):
        self.config = config or SLOConfig()
        n = int(math.ceil(self.config.slow_window_s
                          / self.config.bucket_s)) + 1
        self._buckets = [_Bucket() for _ in range(n)]
        self._worst: List[Dict[str, object]] = []
        self._lock = threading.Lock()
        self._total = 0
        self._errors = 0

    # -- write path ------------------------------------------------------
    def record(self, ok: bool, latency_ms: Optional[float] = None,
               trace_id: str = "", now: Optional[float] = None) -> None:
        """One finished request: ``ok=False`` for shed / timeout / batch
        error / watchdog failure (availability budget), ``ok=True`` with
        its latency for an answered one (latency budget)."""
        cfg = self.config
        t = time.monotonic() if now is None else float(now)
        idx = int(t // cfg.bucket_s)
        with self._lock:
            b = self._buckets[idx % len(self._buckets)]
            if b.idx != idx:
                b.reset(idx)
            b.total += 1
            self._total += 1
            if not ok:
                b.errors += 1
                self._errors += 1
                return
            if latency_ms is None:
                return
            lat = float(latency_ms)
            if lat > cfg.latency_ms:
                b.slow += 1
            if cfg.worst_k and trace_id:
                w = self._worst
                if len(w) < cfg.worst_k or lat > w[-1]["latency_ms"]:
                    w.append({"latency_ms": round(lat, 3),
                              "trace_id": trace_id})
                    w.sort(key=lambda e: -e["latency_ms"])
                    del w[cfg.worst_k:]

    # -- read path -------------------------------------------------------
    def _window(self, window_s: float, now: float) -> Dict[str, int]:
        cfg = self.config
        lo = int((now - window_s) // cfg.bucket_s) + 1
        hi = int(now // cfg.bucket_s)
        total = errors = slow = 0
        for b in self._buckets:
            if lo <= b.idx <= hi:
                total += b.total
                errors += b.errors
                slow += b.slow
        return {"total": total, "errors": errors, "slow": slow}

    @staticmethod
    def _burn(frac: float, target: float) -> float:
        budget = 1.0 - target
        return frac / budget if budget > 0 else 0.0

    def evaluate(self, now: Optional[float] = None) -> Dict[str, object]:
        """Multi-window burn-rate evaluation; alert booleans require
        BOTH windows over threshold (see module docstring)."""
        cfg = self.config
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            wins = {"fast": {"window_s": cfg.fast_window_s,
                             **self._window(cfg.fast_window_s, t)},
                    "slow": {"window_s": cfg.slow_window_s,
                             **self._window(cfg.slow_window_s, t)}}
            worst = [dict(e) for e in self._worst]
            lifetime = {"total": self._total, "errors": self._errors}
        avail = {}
        lat = {}
        for name, w in wins.items():
            total, errors, slow = w["total"], w["errors"], w["slow"]
            err_frac = errors / total if total else 0.0
            good = total - errors
            slow_frac = slow / good if good else 0.0
            avail[name] = {
                "window_s": w["window_s"], "total": total,
                "errors": errors, "sli": round(1.0 - err_frac, 6),
                "burn_rate": round(
                    self._burn(err_frac, cfg.availability_target), 4),
            }
            lat[name] = {
                "window_s": w["window_s"], "good": good, "slow": slow,
                "sli": round(1.0 - slow_frac, 6),
                "burn_rate": round(
                    self._burn(slow_frac, cfg.latency_target), 4),
            }

        def both_over(d, bar):
            return bool(d["fast"]["burn_rate"] >= bar
                        and d["slow"]["burn_rate"] >= bar)

        return {
            "availability": {"target": cfg.availability_target,
                             "windows": avail},
            "latency": {"target": cfg.latency_target,
                        "objective_ms": cfg.latency_ms,
                        "windows": lat},
            "alerts": {
                "availability_page": both_over(avail, cfg.fast_burn),
                "availability_warn": both_over(avail, cfg.slow_burn),
                "latency_page": both_over(lat, cfg.fast_burn),
                "latency_warn": both_over(lat, cfg.slow_burn),
            },
            "worst": worst,
            "lifetime": lifetime,
        }

    def snapshot(self, now: Optional[float] = None) -> Dict[str, object]:
        """The ``GET /slo`` payload: the evaluation plus the config echo
        (an operator reading the endpoint must not need the deploy repo
        to know what the targets ARE)."""
        out = self.evaluate(now=now)
        cfg = self.config
        out["config"] = {
            "availability_target": cfg.availability_target,
            "latency_ms": cfg.latency_ms,
            "latency_target": cfg.latency_target,
            "fast_window_s": cfg.fast_window_s,
            "slow_window_s": cfg.slow_window_s,
            "fast_burn": cfg.fast_burn,
            "slow_burn": cfg.slow_burn,
        }
        return out
