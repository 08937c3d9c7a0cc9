"""One metrics registry: counters, gauges and histograms with labels; the
port's copy of lightgbmv1_tpu/obs/metrics.py.

Two read surfaces over one store:

* ``snapshot()`` — a flat JSON-able dict;
* ``prometheus_text()`` — Prometheus text exposition (format 0.0.4:
  ``# HELP`` / ``# TYPE`` headers, escaped label values, cumulative
  ``_bucket{le=...}`` histogram series ending at ``+Inf``), served by
  ``GET /metrics`` content negotiation in serve/http.py.

Writes are thread-safe and cheap: one registry lock guards metric
creation and each metric carries its own lock for value updates, so
metrics stay on always.  ``registry.counter(name, ...)`` returns the
existing metric when the name is registered already.  A histogram may
keep a bounded window of raw observations (``sample_window``) from which
``quantile(q)`` answers exactly; the serving p50 / p99 / p999 come from
it while the bucket counts feed Prometheus.  A labeled metric holds at
most ``label_cardinality`` children: a new label combination past the
cap collapses into one ``_overflow`` child, and each such write counts
in ``obs_label_overflow_total{metric=...}``.

The parallel learners' analytic comm accounting lives here too
(``split_pack_floats``, ``collective_bytes``, ``comm_table_per_round``,
``publish_comm_metrics``: the port's copy of lightgbmv1_tpu/parallel/
cluster.py :247-345).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Default latency buckets (ms): roughly logarithmic from sub-ms to 10 s.
DEFAULT_MS_BUCKETS = (0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500,
                      1000, 2000, 5000, 10000)

# Per-metric label-cardinality cap (the multi-tenant / per-feature
# stress): once a labeled metric
# holds this many distinct children, NEW label combinations collapse
# into one shared overflow child instead of growing the exposition
# without bound.  Every collapsed write is counted in
# ``obs_label_overflow_total{metric=...}`` — the overflow is explicit,
# never silent.  Override per metric with ``label_cardinality=``.
DEFAULT_LABEL_CARDINALITY = 256
OVERFLOW_LABEL = "_overflow"


def escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping: backslash, quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{escape_label_value(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class _Child:
    """One labeled time series of a metric."""

    __slots__ = ("_metric", "_key", "value", "sum", "count", "buckets",
                 "_window", "_wpos", "_exemplars")

    def __init__(self, metric: "_Metric", key: Tuple[str, ...]):
        self._metric = metric
        self._key = key
        self.value = 0.0
        self.sum = 0.0
        self.count = 0
        self.buckets = ([0] * len(metric.bucket_bounds)
                        if metric.kind == "histogram" else None)
        self._window: List[float] = []
        self._wpos = 0
        # per-bucket worst-tail exemplar (one extra slot for +Inf):
        # {"value", "ts", labels...} — the SLO layer attaches trace ids
        # here so the slowest request in every latency bucket is
        # greppable from the exposition and GET /slo
        self._exemplars: List[Optional[dict]] = (
            [None] * (len(metric.bucket_bounds) + 1)
            if metric.kind == "histogram" else [])

    # -- counter / gauge -------------------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        if self._metric.kind == "counter" and amount < 0:
            raise ValueError("counters only go up (use a gauge)")
        with self._metric.lock:
            self.value += amount

    def set(self, value: float) -> None:
        if self._metric.kind != "gauge":
            raise ValueError(f"set() on a {self._metric.kind}")
        with self._metric.lock:
            self.value = float(value)

    def set_max(self, value: float) -> None:
        """Gauge high-water-mark helper (queue_depth_max and friends)."""
        if self._metric.kind != "gauge":
            raise ValueError(f"set_max() on a {self._metric.kind}")
        with self._metric.lock:
            if value > self.value:
                self.value = float(value)

    def get(self) -> float:
        with self._metric.lock:
            return self.value

    # -- histogram -------------------------------------------------------
    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        """Record one observation.  NaN/±Inf are REJECTED (counted into
        ``obs_bad_observations_total{metric=...}`` on the same registry
        and published as a warning event): before this guard a single
        ``observe(nan)`` landed silently in the +Inf bucket and poisoned
        ``sum`` — and through it every mean — forever.  ``exemplar``
        (e.g. ``{"trace_id": ...}``) is retained per bucket for the
        WORST value seen there."""
        if self._metric.kind != "histogram":
            raise ValueError(f"observe() on a {self._metric.kind}")
        v = float(value)
        m = self._metric
        if not math.isfinite(v):
            m._on_bad_observation(v)
            return
        with m.lock:
            self.sum += v
            self.count += 1
            idx = len(m.bucket_bounds)        # +Inf slot
            for i, ub in enumerate(m.bucket_bounds):
                if v <= ub:
                    self.buckets[i] += 1
                    idx = i
                    break
            if exemplar is not None:
                cur = self._exemplars[idx]
                if cur is None or v >= cur["value"]:
                    self._exemplars[idx] = {
                        "value": v, "ts": time.time(), **exemplar}
            w = m.sample_window
            if w:
                if len(self._window) < w:
                    self._window.append(v)
                else:
                    self._window[self._wpos] = v
                    self._wpos = (self._wpos + 1) % w

    def quantile(self, q: float) -> Optional[float]:
        """Exact quantile over the retained sample window (None when the
        histogram keeps no window or saw no observations)."""
        with self._metric.lock:
            vals = sorted(self._window)
        if not vals:
            return None
        i = min(int(q * len(vals)), len(vals) - 1)
        return vals[i]

    def window_len(self) -> int:
        with self._metric.lock:
            return len(self._window)

    def exemplars(self) -> List[Tuple[str, dict]]:
        """``[(le, exemplar_dict)]`` for buckets holding one (worst-tail
        value + attached labels; ``le`` is the bucket bound or +Inf)."""
        m = self._metric
        with m.lock:
            bounds = [_fmt_value(b) for b in m.bucket_bounds] + ["+Inf"]
            return [(bounds[i], dict(ex))
                    for i, ex in enumerate(self._exemplars)
                    if ex is not None]

    def _reset(self) -> None:
        self.value = 0.0
        self.sum = 0.0
        self.count = 0
        if self.buckets is not None:
            self.buckets = [0] * len(self.buckets)
        self._window = []
        self._wpos = 0
        self._exemplars = [None] * len(self._exemplars)


class _Metric:
    def __init__(self, name: str, help_text: str, kind: str,
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = (),
                 sample_window: int = 0,
                 label_cardinality: int = DEFAULT_LABEL_CARDINALITY):
        self.name = name
        self.help = help_text
        self.kind = kind
        self.label_names = tuple(label_names)
        self.bucket_bounds = tuple(sorted(float(b) for b in buckets))
        self.sample_window = int(sample_window)
        self.label_cardinality = max(int(label_cardinality), 1)
        self.lock = threading.Lock()
        self._registry: Optional["Registry"] = None
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.label_names:
            self._children[()] = _Child(self, ())

    def _on_bad_observation(self, v: float) -> None:
        """A rejected NaN/±Inf observation: count it on the owning
        registry (outside this metric's lock — the bad-observation
        counter is its own metric) and publish a warning event."""
        reg = self._registry
        if reg is not None:
            reg.counter(
                "obs_bad_observations_total",
                "Non-finite histogram observations rejected",
                label_names=("metric",)).labels(metric=self.name).inc()
        try:
            from . import events

            events.publish("metrics.bad_observation",
                           f"{self.name}: non-finite observation {v!r} "
                           "rejected", severity="warning",
                           metric=self.name)
        except Exception:   # noqa: BLE001 — metrics must never throw
            pass

    def labels(self, **kv: str) -> _Child:
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels() got {sorted(kv)}, declared "
                f"{sorted(self.label_names)}")
        key = tuple(str(kv[n]) for n in self.label_names)
        overflowed = False
        with self.lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.label_cardinality:
                    # cardinality cap: a NEW label combination beyond
                    # the cap collapses into one shared overflow child
                    # — the exposition stays bounded no matter how many
                    # tenants/features/versions write here
                    overflowed = True
                    key = (OVERFLOW_LABEL,) * len(self.label_names)
                    child = self._children.get(key)
                if child is None:
                    child = self._children[key] = _Child(self, key)
        if overflowed:
            self._on_label_overflow()
        return child

    def _on_label_overflow(self) -> None:
        """Count one collapsed write (outside this metric's lock — the
        overflow counter is its own metric on the owning registry)."""
        reg = self._registry
        if reg is not None and self.name != "obs_label_overflow_total":
            reg.counter(
                "obs_label_overflow_total",
                "Writes collapsed into the overflow child by the "
                "label-cardinality cap",
                label_names=("metric",)).labels(metric=self.name).inc()

    # bare-metric convenience (unlabeled): forward to the () child
    def _solo(self) -> _Child:
        if self.label_names:
            raise ValueError(f"{self.name} has labels "
                             f"{self.label_names}; use .labels()")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def set_max(self, value: float) -> None:
        self._solo().set_max(value)

    def get(self) -> float:
        return self._solo().get()

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        self._solo().observe(value, exemplar=exemplar)

    def quantile(self, q: float) -> Optional[float]:
        return self._solo().quantile(q)

    def window_len(self) -> int:
        return self._solo().window_len()

    def exemplars(self) -> List[Tuple[str, dict]]:
        return self._solo().exemplars()

    def children(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self.lock:
            return sorted(self._children.items())


class Registry:
    """A set of named metrics; see the module docstring for the read
    surfaces.  ``default_registry()`` is the process-wide instance the
    trainer-side instrumentation publishes into; the serving subsystem
    gives each ``Server`` its own (test isolation + one registry per
    replica is the Prometheus model anyway)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, name: str, help_text: str, kind: str,
                  label_names: Sequence[str], buckets: Sequence[float] = (),
                  sample_window: int = 0,
                  label_cardinality: int = DEFAULT_LABEL_CARDINALITY
                  ) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} re-registered as {kind}"
                        f"{tuple(label_names)}; existing is {m.kind}"
                        f"{m.label_names}")
                return m
            m = _Metric(name, help_text, kind, label_names, buckets,
                        sample_window, label_cardinality)
            m._registry = self
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_text: str = "",
                label_names: Sequence[str] = (),
                label_cardinality: int = DEFAULT_LABEL_CARDINALITY
                ) -> _Metric:
        return self._register(name, help_text, "counter", label_names,
                              label_cardinality=label_cardinality)

    def gauge(self, name: str, help_text: str = "",
              label_names: Sequence[str] = (),
              label_cardinality: int = DEFAULT_LABEL_CARDINALITY
              ) -> _Metric:
        return self._register(name, help_text, "gauge", label_names,
                              label_cardinality=label_cardinality)

    def histogram(self, name: str, help_text: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_MS_BUCKETS,
                  sample_window: int = 0,
                  label_cardinality: int = DEFAULT_LABEL_CARDINALITY
                  ) -> _Metric:
        return self._register(name, help_text, "histogram", label_names,
                              buckets, sample_window, label_cardinality)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def _sorted_metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self, names: Optional[Iterable[str]] = None) -> None:
        """Zero the named metrics (all when ``names`` is None).  Serving
        uses this for a measurement window's reset; Prometheus counters are
        conceptually monotonic, so production exporters should not."""
        wanted = set(names) if names is not None else None
        for m in self._sorted_metrics():
            if wanted is not None and m.name not in wanted:
                continue
            with m.lock:
                for child in m._children.values():
                    child._reset()

    # -- read surfaces ---------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Flat JSON-able dict: scalar metrics map name -> value; labeled
        metrics map ``name{a=x,b=y}`` -> value; histograms report
        ``_count`` / ``_sum``."""
        out: Dict[str, object] = {}
        for m in self._sorted_metrics():
            for key, child in m.children():
                suffix = _label_str(m.label_names, key)
                with m.lock:
                    if m.kind == "histogram":
                        out[f"{m.name}_count{suffix}"] = child.count
                        out[f"{m.name}_sum{suffix}"] = round(child.sum, 6)
                    else:
                        v = child.value
                        out[f"{m.name}{suffix}"] = (
                            int(v) if float(v) == int(v) else round(v, 6))
        return out

    def prometheus_text(self, exemplars: bool = False) -> str:
        """Prometheus text exposition (content type
        ``text/plain; version=0.0.4``).  ``exemplars=True`` appends
        OpenMetrics-style exemplar suffixes to buckets that hold one —
        only for consumers that negotiated OpenMetrics: the suffix is
        NOT part of the 0.0.4 grammar and would break classic
        scrapers."""
        lines: List[str] = []
        for m in self._sorted_metrics():
            if m.help:
                lines.append(f"# HELP {m.name} "
                             + m.help.replace("\\", "\\\\")
                             .replace("\n", "\\n"))
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, child in m.children():
                with m.lock:
                    if m.kind == "histogram":
                        def _ex(i):
                            ex = (child._exemplars[i] if exemplars
                                  else None)
                            if ex is None:
                                return ""
                            lbl = ",".join(
                                f'{k}="{escape_label_value(v)}"'
                                for k, v in ex.items()
                                if k not in ("value", "ts"))
                            return (f" # {{{lbl}}} "
                                    f"{_fmt_value(ex['value'])} "
                                    f"{ex['ts']:.3f}")

                        cum = 0
                        for i, (ub, c) in enumerate(
                                zip(m.bucket_bounds, child.buckets)):
                            cum += c
                            ls = _label_str(m.label_names + ("le",),
                                            key + (_fmt_value(ub),))
                            lines.append(
                                f"{m.name}_bucket{ls} {cum}{_ex(i)}")
                        ls = _label_str(m.label_names + ("le",),
                                        key + ("+Inf",))
                        lines.append(f"{m.name}_bucket{ls} {child.count}"
                                     f"{_ex(len(m.bucket_bounds))}")
                        base = _label_str(m.label_names, key)
                        lines.append(f"{m.name}_sum{base} "
                                     f"{_fmt_value(child.sum)}")
                        lines.append(f"{m.name}_count{base} {child.count}")
                    else:
                        ls = _label_str(m.label_names, key)
                        lines.append(f"{m.name}{ls} "
                                     f"{_fmt_value(child.value)}")
        return "\n".join(lines) + "\n"


_default: Optional[Registry] = None
_default_lock = threading.Lock()


def default_registry() -> Registry:
    """The process-wide registry (trainer / streaming / checkpoint /
    predictor-cache instrumentation publishes here)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Registry()
        return _default


# ---------------------------------------------------------------------------
# The parallel learners' analytic comm accounting (JAX parallel/cluster.py
# :247-345).  Every figure is the output payload one collective
# materializes on each rank — an all-reduced histogram lands F B 3 values
# on every rank, a reduce-scattered one F / D of them — computed from the
# shapes and element sizes: the convention ``parallel/collectives.py``
# counts its calls in, so a run's bytes can be held to these tables.
# ---------------------------------------------------------------------------

HIST_CH = 3             # [sum_grad, sum_hess, count] channels a bin
F32 = 4                 # bytes of an f32 (and of the int32 integer domain)


def split_pack_floats(num_bins: int) -> int:
    """f32 words of one packed SplitInfo (``parallel/trainer.pack_split``):
    [gain, feature, threshold, default_left, is_cat], the left and right
    (3,) sums and the categorical bitset's ceil(B / 32) words."""
    return 11 + (-(-num_bins // 32))


def collective_bytes(n_elems: int, ndev: int, kind: str,
                     itemsize: int = F32) -> int:
    """Payload bytes on each rank of one collective over ``ndev`` ranks:
    ``psum`` (all-reduce) the whole array, ``psum_scatter`` its 1/D
    slice, ``all_gather`` D arrays; 0 on one rank."""
    if ndev <= 1:
        return 0
    if kind == "psum":
        return n_elems * itemsize
    if kind == "psum_scatter":
        return (n_elems // ndev) * itemsize
    if kind == "all_gather":
        return n_elems * ndev * itemsize
    raise ValueError(f"unknown collective kind: {kind}")


def comm_table_per_round(learner: str, collective: str, *, k: float,
                         F: int, B: int, ndev: int,
                         sel_k: Optional[int] = None,
                         int8sr: bool = False) -> dict:
    """Per-round payloads of one wave round with ``k`` histogram slots and
    2k children searched (JAX :265): ``hist_bytes`` the histogram
    reduction (an all-reduce of (k, F, B, 3) under ``allreduce``, a
    reduce-scatter of the F-padded array under ``reduce_scatter``; the
    voting learner's over its 2k children's ``sel_k`` elected features),
    ``split_sync_bytes`` the SplitInfo all-gather of the 2k children
    (none under ``allreduce``, where every rank scans the whole
    histogram), ``vote_bytes`` the voting learner's (2k, F) vote
    all-reduce, ``g3_bytes_per_tree`` the root sums' all-reduce, once a
    tree; ``hist_dtype`` int32 where quantized rounds cross as
    integers."""
    F_pad = -(-F // ndev) * ndev
    spf = split_pack_floats(B)
    sync = collective_bytes(int(round(2 * k)) * spf, ndev, "all_gather")
    out = {"g3_bytes_per_tree": collective_bytes(HIST_CH, ndev, "psum"),
           "hist_dtype": "int32" if int8sr else "float32"}
    if learner == "feature":
        out.update(hist_bytes=0, split_sync_bytes=sync)
    elif learner == "voting":
        nsel = sel_k if sel_k is not None else F
        vote = collective_bytes(int(round(2 * k)) * F, ndev, "psum")
        if collective == "reduce_scatter":
            nsel_pad = -(-nsel // ndev) * ndev
            hist = collective_bytes(
                int(round(2 * k)) * nsel_pad * B * HIST_CH, ndev,
                "psum_scatter")
            out.update(hist_bytes=hist, split_sync_bytes=sync,
                       vote_bytes=vote)
        else:
            hist = collective_bytes(
                int(round(2 * k)) * nsel * B * HIST_CH, ndev, "psum")
            out.update(hist_bytes=hist, split_sync_bytes=0,
                       vote_bytes=vote)
    elif collective == "reduce_scatter":
        hist = collective_bytes(
            int(round(k)) * F_pad * B * HIST_CH, ndev, "psum_scatter")
        out.update(hist_bytes=hist, split_sync_bytes=sync)
    else:
        hist = collective_bytes(
            int(round(k)) * F * B * HIST_CH, ndev, "psum")
        out.update(hist_bytes=hist, split_sync_bytes=0)
    out["total_bytes"] = (out["hist_bytes"] + out["split_sync_bytes"]
                          + out.get("vote_bytes", 0))
    return out


def publish_comm_metrics(learner: str, table: dict) -> None:
    """One learner's per-round table as ``comm_bytes_per_round`` gauges
    labelled ``{learner, part}`` in the default registry (JAX :330)."""
    g = default_registry().gauge(
        "comm_bytes_per_round",
        "Analytic per-device collective payload per wave round",
        label_names=("learner", "part"))
    for part in ("hist_bytes", "split_sync_bytes", "vote_bytes",
                 "total_bytes"):
        if table.get(part) is not None:
            g.labels(learner=learner,
                     part=part[:-6]).set(float(table[part]))
