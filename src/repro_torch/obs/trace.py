"""Structured span/instant-event tracer with Chrome-trace-event export (twin
of ``repro/obs/trace.py``).

  * **Off until asked.**  Every instrumentation point first reads one
    module-global bool; while recording is off (the default) ``span()``
    returns a shared no-op context manager and ``instant()`` returns without
    allocating.  :func:`set_enabled` turns recording on.  The port reads no
    environment variable: the JAX package's ``REPRO_OBS``,
    ``REPRO_OBS_RING`` and ``REPRO_OBS_TRACE`` are :func:`set_enabled`,
    :func:`configure` and a :func:`dump_chrome_trace` call by the launcher
    (or the watchdog) with the path it was given.
  * **Bounded memory.**  Events land in a thread-safe ring buffer
    (:data:`DEFAULT_RING` entries unless :func:`configure` sizes it).
    Overflow drops the oldest events and counts the drops.
  * **Ambient nesting.**  A contextvar stack tracks the open-span path, so
    events carry their nesting depth without a span object threaded through
    call signatures; spans close under exceptions too.
  * **Host time.**  A span brackets host time, asynchronous kernel launches
    included; nothing here synchronizes the device.
  * **Standard export.**  :func:`dump_chrome_trace` writes the Chrome
    trace-event JSON object (``{"traceEvents": [...]}``) that Perfetto and
    ``chrome://tracing`` load: spans are B/E pairs, instants ``ph="i"``.
"""
from __future__ import annotations

import contextvars
import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "enabled", "set_enabled", "configure", "span", "instant", "events",
    "reset", "dropped_events", "dump_chrome_trace", "current_stack", "now_us",
]

DEFAULT_RING = 65536

# process-relative clock origin: Chrome trace ts are microseconds from an
# arbitrary epoch, and perf_counter is monotonic and fine-grained
_T0 = time.perf_counter()


def now_us() -> float:
    """Microseconds since module import (monotonic)."""
    return (time.perf_counter() - _T0) * 1e6


# module-global fast path: instrumentation points read one bool
_ENABLED: bool = False


def enabled() -> bool:
    """Is event recording on?  The single gate every probe checks first."""
    return _ENABLED


def set_enabled(value: bool) -> None:
    """Turn recording on or off."""
    global _ENABLED
    _ENABLED = bool(value)


class _RingBuffer:
    """Thread-safe bounded event store; overflow drops oldest, counts drops."""

    def __init__(self, capacity: int):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self.dropped = 0

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def append(self, event: Dict) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(event)

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0


_RING = _RingBuffer(DEFAULT_RING)

# open-span name path of the current (logical) thread of execution; a tuple
# so each set() is an immutable snapshot
_STACK: contextvars.ContextVar = contextvars.ContextVar("obs_span_stack",
                                                        default=())


def configure(capacity: Optional[int] = None) -> None:
    """Replace the ring buffer with an empty one of ``capacity`` events
    (``None``: :data:`DEFAULT_RING`)."""
    global _RING
    _RING = _RingBuffer(DEFAULT_RING if capacity is None else max(capacity, 1))


def current_stack() -> tuple:
    """Names of the spans currently open in this execution context."""
    return _STACK.get()


def _event(ph: str, name: str, cat: str, args: Optional[Dict] = None,
           ts: Optional[float] = None) -> Dict:
    ev = {
        "name": name,
        "cat": cat,
        "ph": ph,
        "ts": now_us() if ts is None else ts,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
    }
    if args:
        ev["args"] = args
    return ev


class _Span:
    """Recording span: a B event on enter, an E event on exit (also on
    exceptions), and the ambient nesting stack."""

    __slots__ = ("name", "cat", "args", "_token", "_extra")

    def __init__(self, name: str, cat: str, args: Dict):
        self.name = name
        self.cat = cat
        self.args = args
        self._token = None
        self._extra: Dict = {}

    def set(self, **kwargs) -> "_Span":
        """Attach result args known only at span end (merged into E)."""
        self._extra.update(kwargs)
        return self

    def __enter__(self) -> "_Span":
        stack = _STACK.get()
        args = dict(self.args)
        args["depth"] = len(stack)
        self._token = _STACK.set(stack + (self.name,))
        _RING.append(_event("B", self.name, self.cat, args))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _STACK.reset(self._token)
        args = dict(self._extra)
        if exc is not None:
            args["error"] = f"{exc_type.__name__}: {exc}"
        _RING.append(_event("E", self.name, self.cat, args or None))
        return False  # never swallow


class _NullSpan:
    """No-op span handed out while recording is off (one shared instance)."""

    __slots__ = ()

    def set(self, **kwargs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, cat: str = "repro", **args):
    """Context manager recording a B/E duration pair around its body.

    Free while recording is off: it returns a shared no-op object.
    ``with span("dispatch.resolve", token=...) as s: ...; s.set(impl=...)``
    attaches end-of-span result args.
    """
    if not _ENABLED:
        return _NULL_SPAN
    return _Span(name, cat, args)


def instant(name: str, cat: str = "repro", **args) -> None:
    """Record a point-in-time event (Chrome ``ph="i"``, thread scope)."""
    if not _ENABLED:
        return
    ev = _event("i", name, cat, args or None)
    ev["s"] = "t"
    _RING.append(ev)


def events() -> List[Dict]:
    """Snapshot of the ring buffer (oldest first)."""
    return _RING.snapshot()


def dropped_events() -> int:
    """Events lost to ring overflow since the last :func:`reset`."""
    return _RING.dropped


def reset() -> None:
    """Clear the ring buffer and the drop counter."""
    _RING.clear()


def dump_chrome_trace(path, metadata: Optional[Dict] = None) -> int:
    """Write the buffered events as a Chrome trace-event JSON file.

    ``metadata`` (e.g. a metrics snapshot) lands under ``otherData``, beside
    the drop count.  The write is atomic (temp file + rename), so a crash
    mid-dump never leaves a torn file.  Returns the event count.
    """
    evs = _RING.snapshot()
    payload = {
        "traceEvents": evs,
        "displayTimeUnit": "ms",
        "otherData": dict(metadata or {}, dropped_events=_RING.dropped),
    }
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path),
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return len(evs)
