"""Backwards-compatible shim (twin of ``repro/core/tuning.py``): the tuner
now lives in ``repro_torch.dispatch``, whose candidate space selects the
implementation and its (tile, block_b, block_k) geometry in one profiling
pass.  ``Tuner`` is the deprecated shim over the same registry geometry;
``SMEM_BYTES``, a Hopper block's shared memory, stands where the JAX
package has ``VMEM_BYTES``.  Import from ``repro_torch.dispatch`` in new
code."""
from repro_torch.dispatch.profiler import (  # noqa: F401
    Candidate,
    Tuner,
    TuningError,
    enumerate_candidates,
)
from repro_torch.kernels._build import SMEM_BYTES  # noqa: F401
