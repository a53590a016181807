"""Span tracing for the service hot path, clock-parameterized.

A span is one timed, attributed, nested region of the serving loop
(``service.flush`` wrapping ``pad -> launch -> sync -> results``). The
tracer mirrors the service's clock contract (DESIGN.md §14): the replay
harness drives it with the real clock for honest latency traces, while
the recovery driver drives it with the virtual step clock — span
timestamps are then pure step arithmetic and a replayed stream emits an
identical trace. The clock is read through a callable indirection so the
driver's post-construction ``service.clock`` rebind is picked up.

Events are appended on span *exit* (children complete before parents —
the standard trace-log ordering) into a bounded ring; ``export_jsonl``
writes one sorted-key JSON object per line, the artifact the bench-smoke
CI job uploads. Span/parent ids are a deterministic sequence, so golden
tests can pin whole trace files.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import deque
from typing import Callable, List, Optional

__all__ = ["Span", "Tracer", "NULL_SPAN"]


class Span:
    """One in-flight span; ``set(**attrs)`` attaches attributes any time
    before exit (the flush span's OpCost annotation lands this way)."""

    __slots__ = ("name", "span_id", "parent_id", "t0", "t1", "attrs")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 t0: float):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1 = None
        self.attrs = {}

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self


class _NullSpan:
    """No-op stand-in when tracing is disabled: ``set`` swallows attrs."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Tracer:
    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 enabled: bool = True, max_spans: int = 4096):
        self.clock = clock
        self.enabled = bool(enabled)
        self.events = deque(maxlen=int(max_spans))
        self.n_started = 0          # total spans ever opened (ring may drop)
        self._stack: List[Span] = []
        self._next_id = 0

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Context manager for one nested span. Disabled tracers yield a
        shared null span and record nothing (the overhead-gate path)."""
        if not self.enabled:
            yield NULL_SPAN
            return
        sp = Span(name, self._next_id,
                  self._stack[-1].span_id if self._stack else None,
                  self.clock())
        self._next_id += 1
        self.n_started += 1
        if attrs:
            sp.attrs.update(attrs)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            self._stack.pop()
            sp.t1 = self.clock()
            ev = {"name": sp.name, "span": sp.span_id,
                  "parent": sp.parent_id, "t0": sp.t0, "t1": sp.t1,
                  "dur": sp.t1 - sp.t0}
            ev.update(sp.attrs)
            self.events.append(ev)

    # -- views / export --------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[dict]:
        return [e for e in self.events if name is None or e["name"] == name]

    def export_jsonl(self, path_or_file) -> int:
        """Write one JSON object per completed span (sorted keys, append
        order = completion order); returns the number of lines written."""
        own = isinstance(path_or_file, str)
        f = open(path_or_file, "w") if own else path_or_file
        try:
            for ev in self.events:
                f.write(json.dumps(ev, sort_keys=True,
                                   default=_jsonable) + "\n")
        finally:
            if own:
                f.close()
        return len(self.events)


def _jsonable(x):
    """Last-resort JSON coercion for numpy scalars riding in span attrs."""
    for attr in ("item",):
        fn = getattr(x, attr, None)
        if callable(fn):
            return fn()
    return str(x)
