"""Chrome trace-event schema validation (twin of ``repro/obs/validate.py``).

Checks the properties the rest of the tooling relies on, not the full Chrome
spec: the file parses, ``traceEvents`` is a non-empty list, every event has
the required fields, timestamps are monotonically non-decreasing per
``(pid, tid)`` lane, and duration events form balanced, properly nested
B/E pairs per lane (what Perfetto needs to draw the span tree).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Union

REQUIRED_FIELDS = ("name", "ph", "ts", "pid", "tid")
KNOWN_PHASES = {"B", "E", "i", "I", "X", "C", "M"}


class TraceValidationError(ValueError):
    """The trace file violates the Chrome trace-event contract."""


def validate_chrome_trace(source: Union[str, os.PathLike, Dict]) -> Dict:
    """Validate a trace file (path) or already-parsed payload (dict).

    Returns a summary ``{"events", "spans", "instants", "lanes"}`` on
    success; raises :class:`TraceValidationError` naming the first violation
    otherwise.
    """
    if isinstance(source, dict):
        payload = source
    else:
        try:
            payload = json.loads(open(os.fspath(source)).read())
        except (OSError, json.JSONDecodeError) as e:
            raise TraceValidationError(f"unreadable trace file: {e}") from e
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        raise TraceValidationError("payload has no 'traceEvents' key")
    events = payload["traceEvents"]
    if not isinstance(events, list) or not events:
        raise TraceValidationError("'traceEvents' is empty: nothing was "
                                   "recorded (was obs.set_enabled(True) called?)")

    last_ts: Dict[tuple, float] = {}
    stacks: Dict[tuple, List[str]] = {}
    spans = instants = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise TraceValidationError(f"event #{i} is not an object: {ev!r}")
        missing = [f for f in REQUIRED_FIELDS if f not in ev]
        if missing:
            raise TraceValidationError(
                f"event #{i} ({ev.get('name')!r}) missing fields {missing}")
        ph = ev["ph"]
        if ph not in KNOWN_PHASES:
            raise TraceValidationError(
                f"event #{i} ({ev['name']!r}) has unknown phase {ph!r}")
        lane = (ev["pid"], ev["tid"])
        ts = float(ev["ts"])
        if lane in last_ts and ts < last_ts[lane]:
            raise TraceValidationError(
                f"event #{i} ({ev['name']!r}): timestamp {ts} goes backwards "
                f"on lane {lane} (prev {last_ts[lane]})")
        last_ts[lane] = ts
        if ph == "B":
            stacks.setdefault(lane, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.get(lane, [])
            if not stack:
                raise TraceValidationError(
                    f"event #{i}: E for {ev['name']!r} on lane {lane} with "
                    f"no open span")
            opened = stack.pop()
            if opened != ev["name"]:
                raise TraceValidationError(
                    f"event #{i}: E for {ev['name']!r} closes span "
                    f"{opened!r} (improper nesting) on lane {lane}")
            spans += 1
        elif ph in ("i", "I"):
            instants += 1
    open_spans = {lane: stack for lane, stack in stacks.items() if stack}
    if open_spans:
        raise TraceValidationError(
            f"unbalanced B/E pairs — spans left open: {open_spans}")
    return {"events": len(events), "spans": spans, "instants": instants,
            "lanes": len(last_ts)}


def main(argv=None) -> None:
    """CLI: ``python -m repro_torch.obs.validate trace.json``."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="Chrome trace-event JSON file")
    args = ap.parse_args(argv)
    summary = validate_chrome_trace(args.path)
    print(f"trace OK: {summary['events']} events, {summary['spans']} spans, "
          f"{summary['instants']} instants, {summary['lanes']} lane(s)")


if __name__ == "__main__":
    main()
