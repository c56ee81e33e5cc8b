"""Trace viewer: export engine JSONL traces to the Chrome/Perfetto
``trace_event`` format, and run the hardware-in-the-loop replay report.

Tracks (load the output at https://ui.perfetto.dev or chrome://tracing):

  * ``engine / steps``    — one slice per engine step, named by its
                            kind (prefill / decode / spec_verify /
                            combinations / idle), args carrying the
                            step record (rows, bucket, fed/committed
                            tokens, drafted/accepted, actions);
  * ``engine / copies``   — host-side swap/snapshot copy spans
                            (swap_out / swap_in / snapshot_out /
                            snapshot_in / handoff_out / handoff_in)
                            with block/byte counts;
  * ``requests / rid N``  — per-request lifecycle: a ``queued`` slice
                            from submit to admit, ``running`` from
                            admit to finish (or swap_out), ``swapped``
                            while parked on the host, plus instants for
                            defer (with reason), swap_lost, evict, and
                            first_token.

Merged multi-shard mode: a sharded server writes one trace per shard
(``{prefix}.shard{i}.jsonl``; the ``ShardedEngine`` of either package
does, as ``launch.serve --shards N --trace PREFIX``).  Pointing this tool at
the prefix (or any one shard file with ``--merge-shards``) merges them
into ONE timeline with a process per worker ROLE (prefill / decode /
mixed — a thread pair per shard inside it), clocks aligned via each tracer's
``t0`` meta anchor, and every prefill->decode handoff rendered as a
flow arrow from the source's ``handoff_out`` span to the destination's
``handoff_in`` span (paired by ``handoff_id``).

It reads and writes JSON only (no device), and reads the traces of
either package.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.trace_view trace.jsonl \
      --out trace.perfetto.json --replay-photonic
  PYTHONPATH=src python -m repro_torch.launch.trace_view traces/trace_gqa \
      --merge-shards --out topology.perfetto.json
"""
from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import re

from repro_torch.serving.replay import format_report, replay_trace
from repro_torch.serving.tracing import read_trace

ENGINE_PID = 1
REQUEST_PID = 2
STEP_TID = 1
COPY_TID = 2

_US = 1e6  # trace_event timestamps are microseconds

_SHARD_RE = re.compile(r"^(?P<prefix>.*)\.shard(?P<idx>\d+)\.jsonl$")


def _meta_event(pid, tid, name, value):
    return {"ph": "M", "pid": pid, "tid": tid, "name": name,
            "args": {"name": value}}


def _slice(pid, tid, name, ts_s, dur_s, args=None):
    ev = {"ph": "X", "pid": pid, "tid": tid, "name": name,
          "ts": ts_s * _US, "dur": max(dur_s, 0.0) * _US}
    if args:
        ev["args"] = args
    return ev


def _instant(pid, tid, name, ts_s, args=None):
    ev = {"ph": "i", "s": "t", "pid": pid, "tid": tid, "name": name,
          "ts": ts_s * _US}
    if args:
        ev["args"] = args
    return ev


def _engine_tracks(events, records, *, pid, step_tid, copy_tid,
                   ts_off=0.0) -> float:
    """Step + copy-span slices for one engine's records onto (pid,
    tids); returns the last timestamp seen (trace-end watermark)."""
    last_ts = 0.0
    for rec in records:
        t = rec["type"]
        if t == "step":
            # a step's ts is stamped at emit (step end): start = ts - dur
            args = {k: v for k, v in rec.items()
                    if k not in ("type", "ts", "dur_s", "kind")}
            events.append(_slice(pid, step_tid, rec["kind"],
                                 rec["ts"] + ts_off - rec["dur_s"],
                                 rec["dur_s"], args))
            last_ts = max(last_ts, rec["ts"] + ts_off)
        elif t == "span":
            # span ts is the scope's START
            args = {k: v for k, v in rec.items()
                    if k not in ("type", "ts", "dur_s", "name")}
            events.append(_slice(pid, copy_tid, rec["name"],
                                 rec["ts"] + ts_off, rec["dur_s"], args))
            last_ts = max(last_ts, rec["ts"] + ts_off + rec["dur_s"])
    return last_ts


def _request_tracks(events, by_rid, last_ts, *, pid, ts_off=None):
    """Per-request lifecycle slices.  ``by_rid`` maps rid -> ordered
    request records; ``ts_off`` (when given) maps rid -> per-record
    offsets is not needed — records carry pre-offset ts in merged mode."""
    for rid in sorted(by_rid):
        tid = rid + 1  # tid 0 is reserved for process metadata
        events.append(_meta_event(pid, tid, "thread_name", f"rid {rid}"))
        open_since: dict[str, float] = {}  # phase name -> start ts

        def _close(phase, end_ts, args=None):
            t0 = open_since.pop(phase, None)
            if t0 is not None:
                events.append(_slice(pid, tid, phase, t0,
                                     end_ts - t0, args))

        for rec in by_rid[rid]:
            ev, ts = rec["event"], rec.get("ts", 0.0)
            args = {k: v for k, v in rec.items()
                    if k not in ("type", "ts", "event", "rid")}
            if ev == "submit":
                open_since["queued"] = ts
            elif ev in ("admit", "swap_in"):
                _close("queued", ts, args)
                _close("swapped", ts, args)
                open_since["running"] = ts
            elif ev == "swap_out":
                _close("running", ts, args)
                open_since["swapped"] = ts
            elif ev == "migrate_out":
                # handoff/migration: the request leaves this shard
                # parked; the destination's swap_in/admit reopens it
                _close("running", ts, args)
                open_since["swapped"] = ts
            elif ev == "evict":
                _close("running", ts, args)
                open_since["queued"] = ts
            elif ev == "swap_lost":
                _close("swapped", ts, args)
                open_since["queued"] = ts
                events.append(_instant(pid, tid, "swap_lost", ts, args))
            elif ev == "finish":
                _close("running", ts, args)
            else:  # defer / first_token / prefill / custom
                events.append(_instant(pid, tid, ev, ts, args))
        # phases still open when the trace ends (interrupted run)
        for phase in list(open_since):
            _close(phase, last_ts, {"truncated": True})


def to_trace_events(records: list[dict]) -> dict:
    """Convert a validated trace record list to a Chrome trace_event
    JSON object (``{"traceEvents": [...]}``)."""
    meta = records[0]
    events = [
        _meta_event(ENGINE_PID, 0, "process_name", "engine"),
        _meta_event(ENGINE_PID, STEP_TID, "thread_name", "steps"),
        _meta_event(ENGINE_PID, COPY_TID, "thread_name", "copies"),
        _meta_event(REQUEST_PID, 0, "process_name", "requests"),
    ]
    last_ts = _engine_tracks(events, records, pid=ENGINE_PID,
                             step_tid=STEP_TID, copy_tid=COPY_TID)
    by_rid: dict[int, list[dict]] = {}
    for rec in records:
        if rec["type"] == "request":
            by_rid.setdefault(rec["rid"], []).append(rec)
            last_ts = max(last_ts, rec.get("ts", 0.0))
    _request_tracks(events, by_rid, last_ts, pid=REQUEST_PID)
    return {
        "traceEvents": events,
        "otherData": {k: v for k, v in meta.items()
                      if k in ("schema", "arch", "accelerator", "spec_k",
                               "role", "link_gbps")},
    }


# ------------------------------------------------------ merged shards

def discover_shard_traces(path: str) -> list[tuple[int, str]]:
    """Find the per-shard trace files of one ShardedEngine run.

    ``path`` may be the prefix passed to ``start_trace`` or any one
    ``{prefix}.shard{i}.jsonl`` file; returns (shard index, path)
    sorted by index.  Empty when nothing matches."""
    m = _SHARD_RE.match(path)
    prefix = m.group("prefix") if m else path
    out = []
    for p in _glob.glob(_glob.escape(prefix) + ".shard*.jsonl"):
        pm = _SHARD_RE.match(p)
        if pm:
            out.append((int(pm.group("idx")), p))
    return sorted(out)


def to_merged_trace_events(shard_records: list[tuple[int, list[dict]]]) \
        -> dict:
    """Merge per-shard traces into ONE timeline: a process per worker
    role (a steps/copies thread pair per shard inside it), one shared
    requests process (the rid space is global), clocks aligned via the
    ``t0`` meta anchors, and handoff flow arrows between the prefill
    and decode tracks (``handoff_out`` -> ``handoff_in`` span pairs
    matched by ``handoff_id``)."""
    metas = {i: recs[0] for i, recs in shard_records}
    # clock alignment: every tracer stamps ts relative to its OWN t0
    # (perf_counter — one clock domain per process), and meta carries
    # the anchor; older traces without it fall back to offset 0
    t0s = {i: m.get("t0") for i, m in metas.items()}
    base = min((t for t in t0s.values() if t is not None), default=None)
    offs = {i: (t0s[i] - base if base is not None and t0s[i] is not None
                else 0.0)
            for i, _ in shard_records}
    # a process per ROLE, ordered prefill -> decode -> mixed
    role_order = [r for r in ("prefill", "decode", "mixed")
                  if any(m.get("role", "mixed") == r for m in metas.values())]
    role_pid = {r: pid for pid, r in enumerate(role_order, start=1)}
    req_pid = len(role_order) + 1
    events = [_meta_event(pid, 0, "process_name", f"{role} shards")
              for role, pid in role_pid.items()]
    events.append(_meta_event(req_pid, 0, "process_name", "requests"))
    last_ts = 0.0
    tids: dict[int, tuple[int, int, int]] = {}   # shard -> pid, step, copy
    for i, records in shard_records:
        role = metas[i].get("role", "mixed")
        pid = role_pid[role]
        step_tid, copy_tid = 2 * i + 1, 2 * i + 2
        tids[i] = (pid, step_tid, copy_tid)
        events.append(_meta_event(pid, step_tid, "thread_name",
                                  f"shard{i} steps"))
        events.append(_meta_event(pid, copy_tid, "thread_name",
                                  f"shard{i} copies"))
        last_ts = max(last_ts, _engine_tracks(
            events, records, pid=pid, step_tid=step_tid,
            copy_tid=copy_tid, ts_off=offs[i]))
    # one merged request timeline: shift each record onto the common
    # clock, then interleave by ts (a request's lifecycle crosses
    # shards on handoff/migration)
    by_rid: dict[int, list[dict]] = {}
    for i, records in shard_records:
        for rec in records:
            if rec["type"] == "request":
                shifted = dict(rec, ts=rec.get("ts", 0.0) + offs[i],
                               shard=i)
                by_rid.setdefault(rec["rid"], []).append(shifted)
                last_ts = max(last_ts, shifted["ts"])
    for recs in by_rid.values():
        recs.sort(key=lambda r: r["ts"])
    _request_tracks(events, by_rid, last_ts, pid=req_pid)
    # handoff flow arrows: bind at the midpoint of each span slice so
    # the arrow attaches to the enclosing handoff_out/handoff_in slice
    flows: dict[int, dict[str, tuple[int, dict]]] = {}
    for i, records in shard_records:
        for rec in records:
            if rec.get("type") == "span" and "handoff_id" in rec:
                side = ("out" if rec["name"] == "handoff_out" else "in")
                flows.setdefault(rec["handoff_id"], {})[side] = (i, rec)
    for hid, pair in sorted(flows.items()):
        if "out" not in pair or "in" not in pair:
            continue
        for side, ph, extra in (("out", "s", {}), ("in", "f", {"bp": "e"})):
            i, rec = pair[side]
            pid, _, copy_tid = tids[i]
            mid = rec["ts"] + offs[i] + rec["dur_s"] / 2
            events.append({"ph": ph, "cat": "handoff",
                           "id": hid, "name": "handoff",
                           "pid": pid, "tid": copy_tid,
                           "ts": mid * _US, **extra})
    any_meta = metas[min(metas)]
    return {
        "traceEvents": events,
        "otherData": {
            **{k: v for k, v in any_meta.items()
               if k in ("schema", "arch", "accelerator", "link_gbps")},
            "roles": {i: m.get("role", "mixed")
                      for i, m in sorted(metas.items())},
        },
    }


def export_perfetto(source, out_path: str) -> int:
    """Write a Chrome/Perfetto trace JSON; returns the event count."""
    records = read_trace(source) if isinstance(source, str) else list(source)
    doc = to_trace_events(records)
    with open(out_path, "w") as fh:
        json.dump(doc, fh)
    return len(doc["traceEvents"])


def export_perfetto_merged(source: str, out_path: str) -> int:
    """Discover ``{prefix}.shard{i}.jsonl`` traces and write one merged
    role-labeled timeline; returns the event count."""
    shards = discover_shard_traces(source)
    if not shards:
        raise FileNotFoundError(
            f"no per-shard traces matching {source}.shard*.jsonl")
    doc = to_merged_trace_events([(i, read_trace(p)) for i, p in shards])
    with open(out_path, "w") as fh:
        json.dump(doc, fh)
    return len(doc["traceEvents"])


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="export engine traces to Perfetto; replay them "
                    "through the photonic simulator")
    ap.add_argument("trace", help="JSONL trace from Engine.start_trace / "
                                  "launch.serve --trace, or a "
                                  "{prefix}.shard{i}.jsonl prefix")
    ap.add_argument("--out", default=None,
                    help="Perfetto trace_event JSON output path "
                         "(default: <trace>.perfetto.json)")
    ap.add_argument("--merge-shards", action="store_true",
                    help="merge {trace}.shard{i}.jsonl per-shard traces "
                         "into one role-labeled timeline with handoff "
                         "flow arrows (auto-detected when the positional "
                         "arg is a prefix rather than a file)")
    ap.add_argument("--replay-photonic", action="store_true",
                    help="re-price the recorded steps on the photonic "
                         "simulator and print analytic-vs-simulated")
    ap.add_argument("--accelerator", default=None,
                    help="override the accelerator recorded in the trace")
    ap.add_argument("--json", action="store_true",
                    help="print the replay report as JSON")
    args = ap.parse_args(argv)

    merged = args.merge_shards or (
        not os.path.exists(args.trace) and discover_shard_traces(args.trace))
    out = args.out or (args.trace.rsplit(".jsonl", 1)[0]
                       + (".merged" if merged else "")
                       + ".perfetto.json")
    if merged:
        n = export_perfetto_merged(args.trace, out)
        shards = discover_shard_traces(args.trace)
        print(f"[trace_view] merged {len(shards)} shard traces, "
              f"wrote {n} events -> {out}")
        if args.replay_photonic:
            for i, p in shards:
                rep = replay_trace(p, accelerator=args.accelerator)
                print(json.dumps(rep, indent=2) if args.json
                      else format_report(rep))
    else:
        n = export_perfetto(args.trace, out)
        print(f"[trace_view] wrote {n} events -> {out}")
        if args.replay_photonic:
            rep = replay_trace(args.trace, accelerator=args.accelerator)
            print(json.dumps(rep, indent=2) if args.json
                  else format_report(rep))


if __name__ == "__main__":
    main()
