"""Structured engine tracing: per-step events, per-request lifecycle
timelines, and wall-time spans with near-zero cost when disabled.

One ``Tracer`` is owned by the engine and threaded through the
scheduler and every mixer-state cache.  Three record types stream to a
bounded in-memory ring and (optionally) a JSONL file:

  * ``step``    — one per ``Engine.step()``: which kinds ran (prefill /
                  decode / spec_verify), bucket shape, per-row fed and
                  committed token counts, speculative drafted/accepted,
                  prefix/snapshot hits and preempt/swap/swap_lost
                  actions that landed during the step, and the host
                  wall time of the step;
  * ``request`` — lifecycle timeline per request (submit -> admit ->
                  first_token -> finish, plus defer/evict/swap_out/
                  swap_in/swap_lost/cancelled with their reasons),
                  forwarded from the scheduler's event stream;
  * ``span``    — a timed host-side operation (the swap and snapshot
                  copies, each after a device synchronize so the span
                  covers the copies alone).  The span API is ALSO the
                  single source of truth for the engine's wall-time
                  accounting: ``span_total`` backs ``stats()`` whether
                  or not tracing is enabled, so the stats totals always
                  equal the sum of the emitted span records.

The first line of every trace is a ``meta`` record carrying the schema
version, the full arch config (a flat dataclass — ``replay.load_config``
rebuilds it), and the engine/accelerator settings, so a trace file is
self-describing: the replay driver and the Perfetto exporter need
nothing but the JSONL.  The schema is the JAX package's (version 4), so
a trace written by either package reads, replays and exports in the
other.

Disabled-path contract (the default): ``tracer.enabled`` is False, the
engine's hot path skips building event dicts entirely (guarded by
``if tracer.enabled``), ``emit`` returns before touching the ring, and
spans only do the two ``perf_counter`` calls plus one float add.
tests/test_torch_tracing.py pins this with an allocation guard.
"""
from __future__ import annotations

import json
import time
from collections import deque

# v2: meta carries ``shard``/``n_shards``; single-engine traces emit
# shard=None.
# v3: meta carries ``role``/``link_gbps``/``t0`` (the tracer's
# perf_counter anchor, so a merged multi-shard timeline can align
# clocks), every step record carries ``role``.
# v4: ``submit`` request records carry ``tenant``/``slo_class``,
# cancellation emits a terminal ``cancelled`` request event, the
# ``tenant_budget`` defer reason joins the stall vocabulary, and scoring
# prefills mark their step-record prefill info ``score=True``.
TRACE_SCHEMA_VERSION = 4

# record types a valid trace may contain (schema checks + exporter)
RECORD_TYPES = ("meta", "step", "request", "span")


class _Span:
    """Timed scope: accumulates into ``tracer.span_totals[name]`` and
    (when tracing is on) emits one ``span`` record on exit."""

    __slots__ = ("tracer", "name", "rid", "extra", "t0")

    def __init__(self, tracer: "Tracer", name: str, rid, extra):
        self.tracer = tracer
        self.name = name
        self.rid = rid
        self.extra = extra

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        tr = self.tracer
        tr.add_time(self.name, dur)
        if tr.enabled:
            rec = {"type": "span", "name": self.name, "ts": self.t0 - tr.t0,
                   "dur_s": dur}
            if self.rid is not None:
                rec["rid"] = self.rid
            if self.extra:
                rec.update(self.extra)
            tr.emit(rec)
        return False


class Tracer:
    """Bounded-ring + JSONL structured trace recorder.

    Starts disabled: ``open()`` turns recording on (engine API:
    ``Engine.start_trace``).  The span/add_time accounting runs either
    way — it is the one source of wall-time truth for ``stats()``.
    """

    __slots__ = ("enabled", "capture_logits", "ring", "t0", "span_totals",
                 "span_counts", "_fh", "_path")

    def __init__(self):
        self.enabled = False
        self.capture_logits = False
        self.ring: deque | None = None
        self.t0 = time.perf_counter()
        self.span_totals: dict[str, float] = {}
        self.span_counts: dict[str, int] = {}
        self._fh = None
        self._path = None

    def __bool__(self) -> bool:
        return self.enabled

    # ------------------------------------------------------------ control

    def open(self, path: str | None = None, *, ring: int = 4096,
             capture_logits: bool = False):
        """Enable recording: keep the last ``ring`` records in memory
        and stream every record to ``path`` (JSONL) when given."""
        self.close()
        self.enabled = True
        self.capture_logits = capture_logits
        self.ring = deque(maxlen=ring) if ring else None
        if path:
            self._path = str(path)
            self._fh = open(path, "w")
        return self

    def close(self):
        """Flush + disable.  The ring (and span totals) survive so a
        finished run can still be inspected/replayed in process."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self.enabled = False
        self.capture_logits = False

    @property
    def path(self) -> str | None:
        return self._path

    def events(self, type: str | None = None) -> list[dict]:
        """Records currently in the ring (oldest first)."""
        evs = list(self.ring) if self.ring is not None else []
        return [e for e in evs if type is None or e["type"] == type]

    # ------------------------------------------------------------- record

    def emit(self, record: dict):
        """Append one record (caller guards with ``tracer.enabled`` so
        the disabled hot path never builds the dict at all)."""
        if not self.enabled:
            return
        if "ts" not in record:
            record["ts"] = time.perf_counter() - self.t0
        if self.ring is not None:
            self.ring.append(record)
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")

    def meta(self, **fields):
        self.emit({"type": "meta", "schema": TRACE_SCHEMA_VERSION, **fields})

    def request(self, step: int, event: str, rid, **extra):
        self.emit({"type": "request", "step": step, "event": event,
                   "rid": rid, **extra})

    # -------------------------------------------------------------- spans

    def span(self, name: str, rid=None, **extra) -> _Span:
        """Timed scope; accumulates into ``span_totals`` always, emits a
        ``span`` record only while tracing is enabled."""
        return _Span(self, name, rid, extra)

    def add_time(self, name: str, dur_s: float):
        self.span_totals[name] = self.span_totals.get(name, 0.0) + dur_s
        self.span_counts[name] = self.span_counts.get(name, 0) + 1

    def span_total(self, name: str) -> float:
        return self.span_totals.get(name, 0.0)

    def reset_spans(self, *names: str):
        """Zero span accumulators (all of them when no names given) —
        the tracer-side half of ``reset_stats``."""
        if not names:
            self.span_totals.clear()
            self.span_counts.clear()
            return
        for n in names:
            self.span_totals.pop(n, None)
            self.span_counts.pop(n, None)


def read_trace(path) -> list[dict]:
    """Load a JSONL trace; validates the leading meta record."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    validate_trace(records)
    return records


def validate_trace(records: list[dict]):
    """Schema check: meta header first, known record types, required
    per-type fields.  Raises ValueError on violation."""
    if not records:
        raise ValueError("empty trace")
    head = records[0]
    if head.get("type") != "meta":
        raise ValueError("trace must start with a meta record")
    if head.get("schema") != TRACE_SCHEMA_VERSION:
        raise ValueError(f"trace schema {head.get('schema')!r} != "
                         f"supported {TRACE_SCHEMA_VERSION}")
    required = {"step": ("step", "dur_s"),
                "request": ("event", "rid"),
                "span": ("name", "dur_s"),
                "meta": ("schema",)}
    for i, rec in enumerate(records):
        t = rec.get("type")
        if t not in RECORD_TYPES:
            raise ValueError(f"record {i}: unknown type {t!r}")
        for k in required[t]:
            if k not in rec:
                raise ValueError(f"record {i} ({t}): missing field {k!r}")
