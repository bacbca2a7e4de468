"""The roofline tier (twin of ``repro/roofline/``): the card's peaks and a
step's roofline terms (``analysis``), one count of each kernel family's work
(``kernels``) and the op counter that counts a whole step (``count``)."""
from repro_torch.roofline import kernels  # noqa: F401
from repro_torch.roofline.analysis import (  # noqa: F401
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS,
    CollectiveStats,
    Roofline,
    model_flops_for,
)
from repro_torch.roofline.counter import count  # noqa: F401
