"""Trace export: Chrome trace-event / Perfetto JSON (DESIGN.md §17).

``to_trace_events`` maps recorded ``Span``s onto the trace-event format
(``ph: "X"`` complete events, microsecond ``ts``/``dur``, integer
pid/tid plus ``"M"`` ``thread_name`` metadata events naming the logical
threads), loadable in ``chrome://tracing`` / https://ui.perfetto.dev.
``write_trace`` bundles the events with a full metrics snapshot in
``otherData`` so one artifact carries both views; ``spans_from_trace``
round-trips events back into ``Span``s (the exporter test's identity
check) and ``validate_trace`` is the bench-smoke schema gate.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.spans import Span

__all__ = ["to_trace_events", "write_trace", "load_trace",
           "spans_from_trace", "validate_trace"]

_PID = 1                     # one serving process per trace artifact


def to_trace_events(spans: List[Span]) -> List[dict]:
    """Spans -> trace events.  Logical thread names map to stable small
    integer tids (first appearance order) and each gets a ``thread_name``
    metadata event, so Perfetto lanes read ``apipe-verify-0`` instead of
    bare numbers."""
    tids: Dict[str, int] = {}
    events: List[dict] = []
    for s in spans:
        if s.tid not in tids:
            tids[s.tid] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                           "tid": tids[s.tid],
                           "args": {"name": s.tid}})
        args = dict(s.args)
        if s.qid is not None:
            args["qid"] = s.qid
        events.append({"name": s.name, "cat": "serve", "ph": "X",
                       "ts": s.t0 * 1e6, "dur": (s.t1 - s.t0) * 1e6,
                       "pid": _PID, "tid": tids[s.tid], "args": args})
    return events


def write_trace(path: str, obs) -> str:
    """Write one trace artifact: events + metrics snapshot + ring stats."""
    obj = {"traceEvents": to_trace_events(obs.spans.spans()),
           "displayTimeUnit": "ms",
           "otherData": {"metrics": obs.metrics.snapshot(),
                         "dropped_spans": obs.spans.dropped}}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f)
    return path


def load_trace(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def spans_from_trace(obj: dict) -> List[Span]:
    """Rebuild ``Span``s from a trace object (thread names resolved from
    the metadata events; µs back to seconds)."""
    names: Dict[int, str] = {}
    for ev in obj["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev["tid"]] = ev["args"]["name"]
    out: List[Span] = []
    for ev in obj["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        qid: Optional[int] = args.pop("qid", None)
        t0 = ev["ts"] / 1e6
        out.append(Span(ev["name"], t0, t0 + ev["dur"] / 1e6,
                        names.get(ev["tid"], str(ev["tid"])), qid, args))
    return out


def validate_trace(obj: dict) -> None:
    """Schema gate for bench-smoke: raises AssertionError on violation."""
    assert isinstance(obj.get("traceEvents"), list), "traceEvents missing"
    complete = 0
    for ev in obj["traceEvents"]:
        for fld in ("name", "ph", "pid", "tid"):
            assert fld in ev, f"event missing {fld!r}: {ev}"
        if ev["ph"] == "X":
            complete += 1
            assert "ts" in ev and "dur" in ev, f"X event lacks ts/dur: {ev}"
            assert ev["dur"] >= 0, f"negative duration: {ev}"
    assert complete > 0, "trace has no complete (ph='X') span events"
    metrics = obj.get("otherData", {}).get("metrics")
    assert isinstance(metrics, dict) and "counters" in metrics, \
        "otherData.metrics snapshot missing"
    assert isinstance(metrics["counters"], dict)
