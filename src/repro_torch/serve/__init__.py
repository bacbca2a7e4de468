"""Serving (twin of ``repro/serve``): the engine's step primitives and
static ``generate``, the page and slot pools, and the continuous-batching
scheduler over a contiguous or a paged KV cache."""
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: F401
from repro_torch.serve.kv_pages import (  # noqa: F401
    PackedPrefill,
    PageError,
    PagePool,
    PageTable,
    pack_prompts,
)
from repro_torch.serve.kv_slots import Slot, SlotError, SlotPool  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    STATUSES,
    Completion,
    Request,
    RequestQueue,
    Scheduler,
    latency_percentiles,
    synthetic_trace,
)
