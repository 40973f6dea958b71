"""Trace-file loading, schema validation, and the per-stage rollup table.

``repro_torch.launch.oms trace-report`` lands here. A trace produced by
``serve --trace out.trace.json`` (Chrome ``trace_event`` JSON) or
``--trace out.trace.jsonl`` (JSON-lines) is loaded back into
:class:`~repro_torch.obs.trace.TraceEvent` rows, validated against the export
schema (``trace-report`` exits nonzero on any malformed event), and rolled up
per span name: count, total wall time, share of the traced wall clock,
deterministic p50/p95/p99 from a fixed-bucket histogram over the span
durations, plus summed ``rows``/``bytes`` attributes where the
instrumentation recorded them. That table IS the paper's per-stage
encode/scan/merge split, reproduced from a real serve session.

Counterpart of ``repro.obs.report``; it reads the traces of either package.
"""
from __future__ import annotations

import json
from typing import Iterable

from repro_torch.obs.metrics import Histogram
from repro_torch.obs.trace import TraceEvent

# Span-duration buckets for the rollup percentiles (us): ~exponential
# 10us .. 60s, finer than the serve-side latency buckets because traces
# also carry sub-ms host stages (plan, merge).
_DUR_BUCKETS_US = (
    10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1e3, 2.5e3, 5e3, 1e4, 2.5e4,
    5e4, 1e5, 2.5e5, 5e5, 1e6, 2.5e6, 5e6, 1e7, 3e7, 6e7,
)

# Numeric attrs summed into the rollup when present on an event.
SUMMED_ATTRS = ("rows", "bytes")


class TraceFormatError(ValueError):
    """A trace file that does not match the exporter schema."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise TraceFormatError(msg)


def _event_from_jsonl(obj: dict, lineno: int) -> TraceEvent:
    _require(isinstance(obj, dict), f"line {lineno}: not a JSON object")
    for key in ("name", "ts_us", "dur_us", "tid"):
        _require(key in obj, f"line {lineno}: missing {key!r}")
    _require(isinstance(obj["name"], str) and obj["name"],
             f"line {lineno}: name must be a non-empty string")
    _require(isinstance(obj["ts_us"], (int, float)),
             f"line {lineno}: ts_us must be a number")
    _require(isinstance(obj["dur_us"], (int, float)) and obj["dur_us"] >= 0,
             f"line {lineno}: dur_us must be a non-negative number")
    attrs = {k: v for k, v in obj.items()
             if k not in ("name", "ts_us", "dur_us", "tid")}
    t0 = int(obj["ts_us"] * 1e3)
    return TraceEvent(obj["name"], t0, t0 + int(obj["dur_us"] * 1e3),
                      int(obj["tid"]), attrs)


def _event_from_chrome(obj: dict, i: int) -> TraceEvent:
    _require(isinstance(obj, dict), f"traceEvents[{i}]: not an object")
    for key in ("name", "ph", "ts", "dur", "pid", "tid"):
        _require(key in obj, f"traceEvents[{i}]: missing {key!r}")
    _require(obj["ph"] == "X",
             f"traceEvents[{i}]: expected complete event ph='X', "
             f"got {obj['ph']!r}")
    _require(isinstance(obj["name"], str) and obj["name"],
             f"traceEvents[{i}]: name must be a non-empty string")
    _require(isinstance(obj["dur"], (int, float)) and obj["dur"] >= 0,
             f"traceEvents[{i}]: dur must be a non-negative number")
    args = obj.get("args") or {}
    _require(isinstance(args, dict), f"traceEvents[{i}]: args must be an "
                                     f"object")
    t0 = int(obj["ts"] * 1e3)
    return TraceEvent(obj["name"], t0, t0 + int(obj["dur"] * 1e3),
                      int(obj["tid"]), args)


def load_trace(path: str) -> list[TraceEvent]:
    """Load either export format, validating every event against the
    schema. Raises :class:`TraceFormatError` on any malformed event."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    _require(bool(stripped), f"{path}: empty trace file")
    # Format detection: BOTH exports start with "{", so "first char" is no
    # discriminator. A Chrome trace is ONE document for the whole file with
    # a "traceEvents" key; anything else goes down the JSON-lines path.
    if stripped.startswith("{"):
        try:
            doc = json.loads(text)
        except json.JSONDecodeError:
            doc = None                    # multiple documents: JSON-lines
        if isinstance(doc, dict) and "traceEvents" in doc:
            _require(isinstance(doc["traceEvents"], list),
                     f"{path}: traceEvents must be a list")
            return [_event_from_chrome(o, i)
                    for i, o in enumerate(doc["traceEvents"])]
    events = []
    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise TraceFormatError(
                f"{path} line {lineno}: invalid JSON: {e}") from e
        events.append(_event_from_jsonl(obj, lineno))
    return events


# ---------------------------------------------------------------------------
# Rollup
# ---------------------------------------------------------------------------


def rollup(events: Iterable[TraceEvent]) -> dict[str, dict]:
    """Per span name: {count, total_us, p50_us, p95_us, p99_us, rows,
    bytes}. Percentiles come from a fixed-bucket histogram over span
    durations — deterministic for identical traces."""
    out: dict[str, dict] = {}
    for ev in events:
        agg = out.get(ev.name)
        if agg is None:
            agg = out[ev.name] = {
                "count": 0, "total_us": 0.0,
                "_hist": Histogram(_DUR_BUCKETS_US),
                **{k: 0 for k in SUMMED_ATTRS},
            }
        agg["count"] += 1
        agg["total_us"] += ev.dur_ns / 1e3
        agg["_hist"].observe(ev.dur_ns / 1e3)
        for k in SUMMED_ATTRS:
            v = ev.attrs.get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                agg[k] += v
    for agg in out.values():
        h = agg.pop("_hist")
        agg["p50_us"] = h.p50
        agg["p95_us"] = h.p95
        agg["p99_us"] = h.p99
    return out


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.2f}ms"
    return f"{us:.0f}us"


def format_table(roll: dict[str, dict]) -> str:
    """The trace-report table, widest stage first."""
    total_us = sum(a["total_us"] for a in roll.values()) or 1.0
    header = (f"{'span':<28} {'count':>7} {'total':>10} {'share':>6} "
              f"{'p50':>9} {'p95':>9} {'p99':>9} {'rows':>12} {'bytes':>14}")
    lines = [header, "-" * len(header)]
    for name in sorted(roll, key=lambda n: -roll[n]["total_us"]):
        a = roll[name]
        lines.append(
            f"{name:<28} {a['count']:>7} {_fmt_us(a['total_us']):>10} "
            f"{100 * a['total_us'] / total_us:>5.1f}% "
            f"{_fmt_us(a['p50_us']):>9} {_fmt_us(a['p95_us']):>9} "
            f"{_fmt_us(a['p99_us']):>9} "
            f"{a['rows'] or '-':>12} {a['bytes'] or '-':>14}")
    return "\n".join(lines)
