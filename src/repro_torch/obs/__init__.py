"""Runtime observability (twin of ``repro/obs``): structured tracing with
Chrome-trace-event export (Perfetto loads it) and named metrics (counters,
gauges, histograms).  Off by default: every probe is a no-op until
``obs.set_enabled(True)``.  The event and metric names are the JAX
package's, listed in ``docs/observability.md``."""
from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    exp_buckets,
    gauge,
    histogram,
    snapshot,
)
from repro_torch.obs.trace import (  # noqa: F401
    configure,
    current_stack,
    dropped_events,
    dump_chrome_trace,
    enabled,
    events,
    instant,
    now_us,
    set_enabled,
    span,
)
from repro_torch.obs.validate import (  # noqa: F401
    TraceValidationError,
    validate_chrome_trace,
)

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


def reset() -> None:
    """Clear the trace ring buffer AND zero the global metrics registry."""
    _trace.reset()
    _metrics.reset()
