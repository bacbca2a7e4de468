"""Logical-axis sharding (twin of ``repro/sharding``)."""
from repro_torch.sharding.api import (  # noqa: F401
    RULES,
    NamedSharding,
    ShardingCtx,
    full,
    get_ctx,
    lay_out,
    local,
    logical_constraint,
    placements,
    resolve_spec,
    set_ctx,
    shd,
    specs_to_shardings,
    use_ctx,
)
from repro_torch.sharding.collective_matmul import (  # noqa: F401
    ring_allgather_matmul,
    ring_allgather_matmul_local,
)
