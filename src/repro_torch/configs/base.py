"""Architecture configs (twin of ``repro/configs/base.py``): ``ModelConfig``
with the fields the LM families read, and ``VisionConfig``."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.pruning import DENSE, SparsityConfig


def pad_to_multiple(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """An LM: the JAX ``ModelConfig``'s fields that its dense, MoE, VLM
    (M-RoPE and vision embeddings), recurrent (xLSTM, Zamba2) and
    encoder-decoder (Whisper) families read, with the same defaults.  The
    JAX-only ``remat`` knobs are left out."""

    name: str = "model"
    family: str = "dense"                  # dense | moe | ssm | vlm | audio | hybrid
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    d_ff: int = 256
    vocab_size: int = 256
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    attn_impl: str = "naive"               # naive | chunked | pallas (flash kernel)
    attn_chunk: int = 512
    use_rope: bool = True                  # whisper uses absolute sinusoidal positions
    rope_theta: float = 1e4
    mrope: bool = False                    # Qwen2-VL M-RoPE
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    mlp_act: str = "swiglu"                # swiglu | sq_relu | gelu
    norm: str = "rmsnorm"                  # rmsnorm | layernorm
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "auto"                 # auto | shard_map (manual EP)
    # --- SSM / recurrent ---
    block_pattern: str = "attn"            # attn | xlstm | mamba_shared_attn
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    slstm_every: int = 8                   # xlstm: every k-th block is sLSTM
    shared_attn_every: int = 6             # zamba2: shared attn after every k mamba blocks
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500                # frames after the (stubbed) conv frontend
    # --- VLM stub ---
    vision_patches: int = 256              # patch embeddings the caller supplies
    sparsity: SparsityConfig = DENSE       # the paper's technique
    dtype: str = "float32"                 # activation/compute dtype
    param_dtype: str = "float32"
    max_seq_len: int = 8192
    tp: int = 1                            # tensor-parallel degree (head padding)
    dp: int = 1                            # MoE dispatch groups (data-parallel)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_heads(self) -> int:
        """q heads padded up to a multiple of tp (zero o rows; exact)."""
        return pad_to_multiple(self.n_heads, self.tp)

    @property
    def padded_vocab(self) -> int:
        """vocab padded to a multiple of 128; sampling masks the padded ids."""
        return pad_to_multiple(self.vocab_size, 128)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """A small ResNet-style stack of basic blocks built on
    ``conv_init``/``conv_apply``, so a config drives the pruned-conv path end
    to end."""

    name: str = "vision"
    c_in: int = 3
    stem_channels: int = 16
    stage_channels: Tuple[int, ...] = (16, 32)
    stage_blocks: Tuple[int, ...] = (1, 1)
    stage_strides: Tuple[int, ...] = (1, 2)
    image_hw: Tuple[int, int] = (32, 32)
    num_classes: int = 10
    strip_v: int = 128                     # packed-strip width of the convs
    sparsity: SparsityConfig = DENSE
    dtype: str = "float32"
    source: str = ""

    def with_(self, **kw) -> "VisionConfig":
        return dataclasses.replace(self, **kw)
