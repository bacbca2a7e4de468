"""Paged serving (twin of ``repro/serve``): the engine's step primitives,
the page and slot pools, and the continuous-batching scheduler."""
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
    Completion,
    Request,
    RequestQueue,
    Scheduler,
    latency_percentiles,
    synthetic_trace,
)
