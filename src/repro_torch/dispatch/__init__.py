"""Operator dispatch and profiling (paper §3.3; twin of ``repro/dispatch``):
a registry of candidate implementations per logical op, a profiler that
races the feasible ones on the card, a fingerprinted persistent profile DB,
and the ``best_impl`` selection every sparse call site consults."""
from repro_torch.dispatch.registry import (  # noqa: F401
    BANDED_CONV_GEOMETRY,
    FUSED_CONV_GEOMETRY,
    LINEAR_GEOMETRY,
    REGISTRY,
    ImplSpec,
    OperatorRegistry,
    OpKey,
    bucket_batch,
    bucket_dim,
    conv_key,
    geometry_name,
    linear_key,
    linear_key_from,
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
    ensure_profiled,
    get_db,
    iter_compressed_layers,
    iter_op_layers,
    linear_impl,
    plan_params,
    resolve,
    set_db,
    site_impl,
)
