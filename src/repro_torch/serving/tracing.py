"""Wall-time spans for the engine.

The span half of the JAX package's ``serving/tracing.py``: the engine
owns one ``Tracer``, and its span accumulators are the single source of
wall-time truth — ``Engine.stats()`` reads ``span_total("step")``.  The
JAX tracer's recording half (per-step and per-request JSONL records,
the trace schema and its replay) comes with the serving-breadth slice
(ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

import time


class _Span:
    """Timed scope: accumulates into ``tracer.span_totals[name]``."""

    __slots__ = ("tracer", "name", "t0")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.tracer.add_time(self.name, time.perf_counter() - self.t0)
        return False


class Tracer:
    """Named wall-time accumulators (seconds) and their counts."""

    __slots__ = ("span_totals", "span_counts")

    def __init__(self):
        self.span_totals: dict[str, float] = {}
        self.span_counts: dict[str, int] = {}

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def add_time(self, name: str, dur_s: float):
        self.span_totals[name] = self.span_totals.get(name, 0.0) + dur_s
        self.span_counts[name] = self.span_counts.get(name, 0) + 1

    def span_total(self, name: str) -> float:
        return self.span_totals.get(name, 0.0)
