"""Deterministic metrics: counters, gauges, log-bucketed histograms.

Counterpart of ``repro.telemetry.metrics``, plain Python, kept word for
word so a registry snapshot of either package restores in the other.

The paper's headline claim (>= 92% of practical speed-of-light across
configurations) is only sustainable in production if the running system
continuously reports where it sits — which makes the metrics surface part
of the serving contract, not an afterthought. Two properties drive the
design here:

* **Determinism.** A metric flagged ``deterministic`` is a pure function
  of the request stream and the *service clock* — no wall time, no
  iteration-order dependence. Under the virtual clock (the recovery
  driver) two replays of the same stream produce **bit-identical**
  snapshots, so the service's kill/restore drill can assert telemetry
  continuity exactly the way it asserts filter-word continuity
  (DESIGN.md §17). Wall-clock measurements (the perfmodel drift gauges,
  real-latency runs) are registered ``deterministic=False`` and excluded
  from that comparison — they ride along in checkpoints for dashboard
  continuity only.
* **Reproducible histograms.** Bucket edges are a *fixed* log-spaced grid
  (:func:`log_edges` — a pure function of (lo, hi, per_decade), never
  derived from observed data), so the same stream always lands in the
  same buckets and snapshots survive checkpoint/restore bit-exactly:
  counts are ints, and float accumulators round-trip exactly through
  JSON (Python serializes floats shortest-round-trip).

Namespacing: dotted metric names (``service.flushes``,
``filter.fill_fraction``, ``admission.shed``) plus optional string labels
(``admission.shed{reason=quota,tenant=3}``), so filter health and
service counters merge into one dict without key collisions.
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "log_edges", "nearest_rank", "DEFAULT_LATENCY_EDGES"]


def log_edges(lo: float = 1e-7, hi: float = 10.0,
              per_decade: int = 5) -> Tuple[float, ...]:
    """Fixed log-spaced bucket edges: ``10**(i/per_decade)`` for every
    integer ``i`` with ``lo <= 10**(i/per_decade) <= hi`` (inclusive,
    snapped to the exponent grid). A pure function of its arguments —
    never data-derived — so histograms over the same stream are
    reproducible across runs and checkpoints."""
    if not (lo > 0 and hi > lo and per_decade > 0):
        raise ValueError(f"bad edge grid lo={lo} hi={hi}/{per_decade}")
    i_lo = round(math.log10(lo) * per_decade)
    i_hi = round(math.log10(hi) * per_decade)
    return tuple(10.0 ** (i / per_decade) for i in range(i_lo, i_hi + 1))


# Latency edges in SECONDS: 100ns .. 10s, 5 buckets/decade (41 edges).
DEFAULT_LATENCY_EDGES = log_edges(1e-7, 10.0, per_decade=5)


def nearest_rank(samples, q: float) -> float:
    """Tail percentile with the nearest-rank (inverted-CDF) definition:
    the smallest observed sample s.t. at least q% of samples are <= it.
    Interpolating estimators invent values between the two largest
    samples — exactly where p999 lives — so tails are reported as rank
    statistics on actual observations (the JAX package's definition;
    :meth:`Histogram.percentile` uses it)."""
    a = sorted(float(s) for s in _flatten(samples))
    if not a:
        raise ValueError("percentile of an empty sample set")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100]; got {q}")
    rank = int(math.ceil(q / 100.0 * len(a))) - 1
    return a[max(rank, 0)]


def _flatten(samples) -> Iterable[float]:
    try:                            # numpy arrays (any shape) and scalars
        import numpy as np
        return np.asarray(samples, np.float64).reshape(-1).tolist()
    except Exception:
        return list(samples)


def _labels_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Metric:
    """Base: a namespaced name + sorted string labels + determinism flag."""

    kind = "metric"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 deterministic: bool = True):
        self.name = name
        self.labels = labels
        self.deterministic = bool(deterministic)

    @property
    def key(self) -> str:
        """Flat display key: ``name`` or ``name{k=v,...}`` (labels sorted)."""
        if not self.labels:
            return self.name
        inner = ",".join(f"{k}={v}" for k, v in self.labels)
        return f"{self.name}{{{inner}}}"


class Counter(Metric):
    """Monotone integer counter."""

    kind = "counter"

    def __init__(self, name, labels, deterministic=True):
        super().__init__(name, labels, deterministic)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        n = int(n)
        if n < 0:
            raise ValueError(f"counter {self.key} cannot decrease ({n})")
        self.value += n

    def set_total(self, v: int) -> None:
        """Restore/sync path: jump to an absolute total (monotone)."""
        v = int(v)
        if v < self.value:
            raise ValueError(f"counter {self.key} cannot move backwards "
                             f"({self.value} -> {v})")
        self.value = v

    def snapshot_value(self):
        return self.value


class Gauge(Metric):
    """Last-written float value."""

    kind = "gauge"

    def __init__(self, name, labels, deterministic=True):
        super().__init__(name, labels, deterministic)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot_value(self):
        return self.value


class Histogram(Metric):
    """Fixed-edge log-bucketed histogram with optional exact samples.

    ``counts[i]`` counts observations ``<= edges[i]`` exclusive of lower
    buckets; ``counts[-1]`` is the overflow (> edges[-1]) bucket — so
    ``len(counts) == len(edges) + 1`` and the cumulative view is the
    Prometheus ``le`` series. With ``keep_samples`` (the default) the raw
    observations are retained so :meth:`percentile` is exact nearest-rank
    (the replay harness's p999 is an observed sample, never a bucket
    upper bound); without them percentiles degrade to the bucket edge.
    """

    kind = "histogram"

    def __init__(self, name, labels, edges: Tuple[float, ...] = None,
                 keep_samples: bool = True, deterministic=True):
        super().__init__(name, labels, deterministic)
        self.edges: Tuple[float, ...] = tuple(
            float(e) for e in (edges or DEFAULT_LATENCY_EDGES))
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError(f"histogram {name}: edges must be strictly "
                             f"increasing")
        self.keep_samples = bool(keep_samples)
        self.reset()

    def reset(self) -> None:
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.n = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.samples: List[float] = []

    def observe(self, x: float) -> None:
        x = float(x)
        self.counts[bisect.bisect_left(self.edges, x)] += 1
        self.n += 1
        self.sum += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)
        if self.keep_samples:
            self.samples.append(x)

    def observe_many(self, xs) -> None:
        for x in _flatten(xs):
            self.observe(x)

    def percentile(self, q: float) -> float:
        """Exact nearest-rank over retained samples; bucket-edge upper
        bound when samples were dropped."""
        if self.keep_samples:
            return nearest_rank(self.samples, q)
        if self.n == 0:
            raise ValueError(f"percentile of empty histogram {self.key}")
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"q must be in [0, 100]; got {q}")
        rank = max(int(math.ceil(q / 100.0 * self.n)) - 1, 0)
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc > rank:
                return (self.edges[i] if i < len(self.edges)
                        else float(self.max))
        return float(self.max)

    def summary(self, unit: float = 1.0) -> dict:
        """{n, p50, p99, p999, mean, max} scaled by ``unit`` — the replay
        harness's report row (empty histograms report n=0 only)."""
        if self.n == 0:
            return {"n": 0}
        return {"n": int(self.n),
                "p50": round(self.percentile(50.0) * unit, 3),
                "p99": round(self.percentile(99.0) * unit, 3),
                "p999": round(self.percentile(99.9) * unit, 3),
                "mean": round(self.sum / self.n * unit, 3),
                "max": round(float(self.max) * unit, 3)}

    def snapshot_value(self):
        return self.summary()


class MetricsRegistry:
    """One namespace of metrics; the service owns exactly one.

    Metric accessors are get-or-create: ``registry.counter("service.flushes")``
    returns the same object every call, so hot paths pay one dict lookup.
    ``snapshot_state``/``restore_state`` round-trip the full registry
    bit-exactly (ints, shortest-round-trip floats, explicit label lists),
    which is what lets telemetry ride in the service's flush-barrier
    checkpoints alongside the filter words.
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, tuple], Metric] = {}

    # -- get-or-create accessors ----------------------------------------------
    def _get(self, cls, name: str, deterministic: bool,
             labels: Dict[str, str], **kw) -> Metric:
        key = (name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[1], deterministic=deterministic, **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {m.key} is a {m.kind}, not a "
                            f"{cls.kind}")
        return m

    def counter(self, name: str, deterministic: bool = True,
                **labels) -> Counter:
        return self._get(Counter, name, deterministic, labels)

    def gauge(self, name: str, deterministic: bool = True,
              **labels) -> Gauge:
        return self._get(Gauge, name, deterministic, labels)

    def histogram(self, name: str, edges: Tuple[float, ...] = None,
                  keep_samples: bool = True, deterministic: bool = True,
                  **labels) -> Histogram:
        return self._get(Histogram, name, deterministic, labels,
                         edges=edges, keep_samples=keep_samples)

    # -- views -----------------------------------------------------------------
    def metrics(self) -> List[Metric]:
        return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self, prefix: str = "",
                 deterministic_only: bool = False) -> dict:
        """Flat dashboard dict: display key -> value (histograms
        summarize). Deterministic ordering (sorted keys)."""
        out = {}
        for m in self.metrics():
            if deterministic_only and not m.deterministic:
                continue
            if prefix and not m.name.startswith(prefix):
                continue
            out[m.key] = m.snapshot_value()
        return out

    # -- checkpoint round-trip -------------------------------------------------
    def snapshot_state(self, deterministic_only: bool = False) -> dict:
        """JSON-able, bit-exact registry state. The ``deterministic_only``
        view is the recovery drill's equality surface: two replays of the
        same stream under the virtual clock must compare ``==``."""
        mets = []
        for m in self.metrics():
            if deterministic_only and not m.deterministic:
                continue
            d = {"kind": m.kind, "name": m.name,
                 "labels": [list(kv) for kv in m.labels],
                 "deterministic": m.deterministic}
            if m.kind in ("counter", "gauge"):
                d["value"] = m.value
            else:
                d.update({"edges": list(m.edges), "counts": list(m.counts),
                          "n": m.n, "sum": m.sum, "min": m.min,
                          "max": m.max, "keep_samples": m.keep_samples,
                          "samples": (list(m.samples) if m.keep_samples
                                      else None)})
            mets.append(d)
        return {"metrics": mets}

    def restore_state(self, state: dict) -> None:
        """Replace the registry contents with a snapshot (checkpoint
        restore). Unknown kinds are rejected loudly."""
        self._metrics = {}
        for d in state.get("metrics", []):
            labels = {k: v for k, v in d.get("labels", [])}
            det = bool(d.get("deterministic", True))
            if d["kind"] == "counter":
                self.counter(d["name"], deterministic=det,
                             **labels).set_total(d["value"])
            elif d["kind"] == "gauge":
                self.gauge(d["name"], deterministic=det,
                           **labels).set(d["value"])
            elif d["kind"] == "histogram":
                h = self.histogram(d["name"], edges=tuple(d["edges"]),
                                   keep_samples=bool(d["keep_samples"]),
                                   deterministic=det, **labels)
                h.counts = [int(c) for c in d["counts"]]
                h.n = int(d["n"])
                h.sum = float(d["sum"])
                h.min = None if d["min"] is None else float(d["min"])
                h.max = None if d["max"] is None else float(d["max"])
                h.samples = ([float(s) for s in d["samples"]]
                             if d.get("samples") is not None else [])
            else:
                raise ValueError(f"unknown metric kind {d['kind']!r}")
