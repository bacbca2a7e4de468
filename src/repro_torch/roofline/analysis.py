"""Roofline terms of one step on the card (twin of
``repro/roofline/analysis.py``).

Three terms per (arch x shape x mesh), hardware = one H100 SXM:
  compute    = FLOPs_per_card / peak_FLOP/s for the step's dtype
  memory     = bytes_per_card / HBM_bw
  collective = collective_bytes_per_card / link_bw

The FLOPs, bytes and collective bytes come from the op counter
(``roofline/counter.py``), which counts an eager step as it runs on one
rank.  The JAX package reads them from compiled HLO text instead, through
``shape_bytes``, ``parse_collectives`` and ``count_while_trip``; the port
has no HLO, so those three have no twin here: the counter takes their
place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

# H100 SXM (NVIDIA H100 80GB HBM3, 700.00 W): NVIDIA's data sheet, dense
# rates.  f32 is the CUDA cores' rate (the port's kernels run f32 there),
# bf16 the tensor cores' dense rate; the link is NVLink 4, one way.
HBM_BW = 3.35e12                                        # bytes/s per card
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # FLOP/s per card
LINK_BW = 450e9                                         # bytes/s per card


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class Roofline:
    flops: float                 # per card
    hlo_bytes: float             # per card (the counter's eager bytes)
    collective_bytes: float      # per card
    model_flops: float           # 6*N*D global
    chips: int
    dtype: str = "bfloat16"      # the step's compute dtype: picks the peak

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[getattr(torch, self.dtype)]

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step's bound time spent at the compute roofline if
        only MODEL_FLOPS were executed."""
        ideal = self.model_flops / self.chips / self.peak_flops
        return ideal / self.t_bound if self.t_bound else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_chip": self.flops,
            "hlo_bytes_per_chip": self.hlo_bytes,
            "collective_bytes_per_chip": self.collective_bytes,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, cell, sparsity: float = 0.0) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = tokens processed.

    For decode cells D = global_batch (one token each); the attention
    KV-read work is memory-side and not part of the 6ND convention.
    Sparsity scales the prunable fraction of N (embeddings excluded).
    """
    n_active = cfg.active_param_count()
    emb = cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    body = max(n_active - emb, 0)
    n_eff = emb + body * (1.0 - sparsity)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_eff * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_eff * tokens
    return 2.0 * n_eff * cell.global_batch  # decode: one token per sequence
