"""resnet-tiny (twin of ``repro/configs/resnet_tiny.py``): stem + two stages
of ResNet basic blocks + linear head, every conv at 50% column-wise
sparsity; the 3-channel stem, the 8->16 projection and the head stay dense
by ``min_dim``."""
from repro_torch.configs.base import VisionConfig
from repro_torch.core.pruning import SparsityConfig

CONFIG = VisionConfig(
    name="resnet-tiny",
    c_in=3,
    stem_channels=8,
    stage_channels=(16, 16),
    stage_blocks=(1, 1),
    stage_strides=(1, 2),
    image_hw=(16, 16),
    num_classes=10,
    strip_v=128,
    sparsity=SparsityConfig(sparsity=0.5, m=None, tile=8, min_dim=16,
                            format="compressed_pallas"),
    source="ResNet-18 basic-block family, reduced for CPU smoke",
)
