"""Operator dispatch and profiling (paper §3.3; twin of ``repro/dispatch``):
a registry of candidate implementations per logical op, a profiler that
races the feasible ones on the card, a fingerprinted persistent profile DB,
and the ``best_impl`` selection every sparse call site consults."""
from repro_torch.dispatch.registry import (  # noqa: F401
    BANDED_CONV_GEOMETRY,
    DEFAULT_PAGE_SIZE,
    FUSED_CONV_GEOMETRY,
    LINEAR_GEOMETRY,
    REGISTRY,
    ImplSpec,
    OperatorRegistry,
    OpKey,
    PAGED_ATTN_GEOMETRY,
    bucket_batch,
    bucket_dim,
    conv_key,
    geometry_name,
    linear_key,
    linear_key_from,
    paged_attn_key,
)
from repro_torch.dispatch.profiler import (  # noqa: F401
    DEFAULT_DB_PATH,
    SCHEMA_VERSION,
    ProfileDB,
    TuningError,
    device_time_us,
    env_fingerprint,
    profile_op,
)
from repro_torch.dispatch.dispatch import (  # noqa: F401
    best_impl,
    choose_page_size,
    current_phase,
    ensure_profiled,
    force_scope,
    forced_impl,
    get_db,
    iter_compressed_layers,
    iter_op_layers,
    linear_impl,
    phase_scope,
    plan_params,
    resolve,
    set_db,
    site_impl,
)
