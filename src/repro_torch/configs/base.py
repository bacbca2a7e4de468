"""Architecture configs (twin of ``repro/configs/base.py``): ``ModelConfig``
with the fields the attention family reads, and ``VisionConfig``."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.pruning import DENSE, SparsityConfig


def pad_to_multiple(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A decoder-only attention LM: the JAX ``ModelConfig``'s fields that
    its dense and MoE attention families read, with the same defaults.  The
    recurrent, encoder-decoder and the other sharding fields wait for the
    slices that port those families; ``block_pattern`` and ``mrope`` are
    carried so the model can refuse them by name."""

    name: str = "model"
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    d_ff: int = 256
    vocab_size: int = 256
    block_pattern: str = "attn"            # the port runs "attn" only
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    attn_impl: str = "naive"               # naive | chunked | pallas (flash kernel)
    attn_chunk: int = 512
    use_rope: bool = True
    rope_theta: float = 1e4
    mrope: bool = False                    # Qwen2-VL M-RoPE: not ported yet
    mlp_act: str = "swiglu"                # swiglu | sq_relu | gelu
    norm: str = "rmsnorm"                  # rmsnorm | layernorm
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
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
