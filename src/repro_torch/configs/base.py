"""Architecture configs (twin of ``repro/configs/base.py``): ``ModelConfig``
with the fields the LM families read and its parameter counts,
``VisionConfig``, and the shape cells of the dry-run grid (``ShapeCell``,
``SHAPES``, ``LONG_CONTEXT_ARCHS``)."""
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
    encoder-decoder (Whisper) families read, with the same defaults.
    ``remat`` recomputes each block's activations in the backward
    (``models/lm.py::_maybe_remat``); ``remat_policy`` says what it keeps:
    ``"nothing"`` or ``"dots"`` (the outputs of the matrix products)."""

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
    remat: bool = False
    remat_policy: str = "nothing"          # nothing | dots (save matmul outputs)
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

    def param_count(self) -> int:
        """Approximate parameter count N (total, incl. all experts): the
        JAX package's formula, integer for integer."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        h, kv = self.padded_heads, self.n_kv_heads
        attn = d * hd * (h + 2 * kv) + h * hd * d
        mlp = (3 if self.mlp_act == "swiglu" else 2) * d * f
        if self.is_moe:
            mlp = mlp * self.n_experts + d * self.n_experts  # + router
        if self.block_pattern == "xlstm":
            di = self.expand * d
            blk = d * 2 * di + 3 * di * di // 4 + di * d  # rough xlstm cell
            core = self.n_layers * blk
        elif self.block_pattern == "mamba_shared_attn":
            di = self.expand * d
            nh = di // self.ssm_head_dim
            mamba = d * (2 * di + 2 * self.ssm_state + nh) + di * d
            core = self.n_layers * mamba + (attn + mlp)  # shared params once
        else:
            core = self.n_layers * (attn + mlp)
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.is_encoder_decoder:
            core += self.encoder_layers * (attn + mlp) + self.n_layers * attn  # cross attn
        return core + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.is_moe:
            return self.param_count()
        per_expert = (3 if self.mlp_act == "swiglu" else 2) * self.d_model * self.d_ff
        return (self.param_count()
                - (self.n_experts - self.top_k) * per_expert * self.n_layers)


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


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the dry-run grid."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# Pure full-attention archs skip long_500k (sub-quadratic attention
# required); the recurrent and hybrid archs run it.
LONG_CONTEXT_ARCHS = {"xlstm-350m", "zamba2-7b"}
