"""Fault-tolerance machinery: preemption handling, step watchdog, straggler
log (twin of ``repro/train/fault.py``).

The trainers wire these as:
  - PreemptionGuard: SIGTERM/SIGINT -> request a final checkpoint + clean exit
  - StepWatchdog: a daemon thread that aborts the process (so the cluster
    scheduler restarts it from the last checkpoint) if no step completes
    within ``timeout_s``: the restart from the checkpoint IS the recovery
    for a hung step
  - StragglerMonitor: per-step durations; steps slower than ``factor`` x the
    rolling median are logged
"""
from __future__ import annotations

import os
import signal
import threading
import time
from collections import deque
from typing import Callable, Deque, List, Optional

WATCHDOG_EXIT_CODE = 42


class PreemptionGuard:
    def __init__(self):
        self.requested = False
        self._orig = {}

    def install(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass  # not the main thread (tests)
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def uninstall(self):
        for sig, h in self._orig.items():
            signal.signal(sig, h)


class StepWatchdog:
    """Aborts the process if no heartbeat arrives within ``timeout_s``.

    The default abort is ``os._exit(42)``, which skips atexit handlers and
    the ``finally`` blocks of every thread: a hung step cannot block it.
    First it emits a ``fault.watchdog`` obs instant and, given a
    ``trace_path``, dumps the trace ring there, the one record of where the
    run hung (the JAX package takes the path from ``REPRO_OBS_TRACE``).
    """

    def __init__(self, timeout_s: float = 1800.0, abort: Optional[Callable] = None,
                 trace_path: Optional[str] = None):
        self.timeout_s = timeout_s
        self.trace_path = trace_path
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._abort = abort or self._default_abort
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    def _default_abort(self):
        from repro_torch.obs import trace as _ot

        _ot.instant("fault.watchdog", timeout_s=self.timeout_s)
        if self.trace_path:
            try:
                _ot.dump_chrome_trace(self.trace_path)
            except OSError:
                pass  # aborting anyway; never mask the exit
        os._exit(WATCHDOG_EXIT_CODE)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(min(self.timeout_s / 4, 5.0)):
            if time.monotonic() - self._last > self.timeout_s:
                self.fired = True
                self._abort()
                return


class StragglerMonitor:
    def __init__(self, window: int = 50, factor: float = 2.0):
        self.durations: Deque[float] = deque(maxlen=window)
        self.factor = factor
        self.events: List[dict] = []

    def record(self, step: int, duration_s: float) -> bool:
        """Returns True if this step was a straggler."""
        is_straggler = False
        if len(self.durations) >= 8:
            med = sorted(self.durations)[len(self.durations) // 2]
            if duration_s > self.factor * med:
                is_straggler = True
                self.events.append(
                    {"step": step, "duration_s": duration_s, "median_s": med}
                )
        self.durations.append(duration_s)
        return is_straggler

    @property
    def median(self) -> float:
        if not self.durations:
            return 0.0
        return sorted(self.durations)[len(self.durations) // 2]
