"""Prometheus text exposition of a :class:`MetricsRegistry`.

The service's dashboard half of the operational contract: a point-in-time
text snapshot in the Prometheus exposition format (v0.0.4) — counters,
gauges, and cumulative-``le`` histogram series. Output is fully
deterministic (metrics sorted by (name, labels), floats via shortest
round-trip ``repr``), so golden tests pin whole snapshots and two bit
-identical registries export byte-identical text.

Dotted metric names are sanitized to Prometheus identifiers
(``service.flushes`` -> ``service_flushes``); the dotted form survives in
the JSON/health surfaces, which keep richer typing anyway.
"""
from __future__ import annotations

import re
from typing import List

from repro_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                           MetricsRegistry)

__all__ = ["prometheus_text", "write_prometheus"]

_IDENT = re.compile(r"[^a-zA-Z0-9_:]")


def _name(raw: str) -> str:
    n = _IDENT.sub("_", raw)
    return ("_" + n) if n[:1].isdigit() else n


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def _labels(pairs, extra: str = "") -> str:
    inner = ",".join(f'{_name(k)}="{v}"' for k, v in pairs)
    if extra:
        inner = (inner + "," + extra) if inner else extra
    return "{" + inner + "}" if inner else ""


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry as a Prometheus text snapshot (one trailing
    newline; ``# TYPE`` emitted once per metric name)."""
    lines: List[str] = []
    typed = set()

    def _type(name: str, kind: str):
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for m in registry.metrics():
        name = _name(m.name)
        if isinstance(m, Counter):
            _type(name, "counter")
            lines.append(f"{name}{_labels(m.labels)} {_fmt(m.value)}")
        elif isinstance(m, Gauge):
            _type(name, "gauge")
            lines.append(f"{name}{_labels(m.labels)} {_fmt(m.value)}")
        elif isinstance(m, Histogram):
            _type(name, "histogram")
            cum = 0
            for edge, c in zip(m.edges, m.counts):
                cum += c
                le = 'le="' + repr(edge) + '"'
                lines.append(f"{name}_bucket{_labels(m.labels, le)} {cum}")
            inf = 'le="+Inf"'
            lines.append(f"{name}_bucket{_labels(m.labels, inf)} {m.n}")
            lines.append(f"{name}_sum{_labels(m.labels)} {_fmt(m.sum)}")
            lines.append(f"{name}_count{_labels(m.labels)} {m.n}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(registry: MetricsRegistry, path: str) -> str:
    text = prometheus_text(registry)
    with open(path, "w") as f:
        f.write(text)
    return path
