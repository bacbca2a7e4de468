"""Serving engine: the paged step primitives the continuous-batching
scheduler drives (twin of ``repro/serve/engine.py``'s paged half).

``packed_prefill_step`` and ``paged_decode_step`` run under a
:func:`repro_torch.dispatch.phase_scope`, so every sparse-operator lookup
inside resolves a phase-tagged key: prefill ([T]-row operands) and decode
([B]-row operands) get separately planned implementations.  The static
``Engine.generate``, the contiguous-cache steps and temperature sampling
wait for a later slice (ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import dispatch
from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as reg

NEG = -1e30


@dataclasses.dataclass
class ServeConfig:
    temperature: float = 0.0  # 0 => greedy, the only sampling the port has
    eos_id: Optional[int] = None
    # profile the sparse-operator candidates at engine build (else the plan
    # comes from the profile DB or the heuristic)
    profile_dispatch: bool = False
    dispatch_batch_hint: int = 8
    # expected prompt length for the prefill-phase row bucket
    # (prefill rows ~= batch * seq; decode rows ~= batch)
    dispatch_seq_hint: int = 128


class Engine:
    """The model's serving steps on the device its params lie on."""

    def __init__(self, cfg: ModelConfig, params,
                 serve_cfg: Optional[ServeConfig] = None):
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg if serve_cfg is not None else ServeConfig()
        if self.scfg.temperature > 0:
            raise NotImplementedError(
                "temperature sampling waits for a later slice (ROADMAP queue "
                "1 item 11): the JAX package's jax.random draws cannot be "
                "matched; use temperature=0 (greedy)")
        self.device = params["embed"].device
        # Build-time dispatch: resolve (and optionally profile) every
        # compressed layer's implementation per phase before the first step.
        scfg = self.scfg
        self.dispatch_plan = dispatch.plan_params(
            params, batch_hint=scfg.dispatch_batch_hint,
            phase_hints={
                "prefill": scfg.dispatch_batch_hint * scfg.dispatch_seq_hint,
                "decode": scfg.dispatch_batch_hint,
            },
            profile=scfg.profile_dispatch)

    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32)).to(self.device)

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy next tokens [N] int32 from [N, S, V] logits (last position);
        the padded vocab ids are masked first.  Stays on the device."""
        logits = logits[:, -1].float()
        v = self.cfg.vocab_size
        if self.cfg.padded_vocab != v:
            logits = logits.clone()
            logits[:, v:] = NEG
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def paged_decode_step(self, cache, tokens, pos, tables, *, page_size: int):
        """One decode step against a paged cache. tokens [B, 1]; pos [B];
        tables [B, n_max] (numpy or tensors).  Returns (logits [B, 1, V],
        cache); the cache is written in place."""
        with dispatch.phase_scope("decode"):
            return reg.paged_decode_fn(self.cfg, page_size)(
                self.params, cache, self._ints(tokens), self._ints(pos),
                self._ints(tables))

    def packed_prefill_step(self, cache, packed, tables, *, page_size: int):
        """Prefill a packed multi-prompt stream (``kv_pages.PackedPrefill``)
        into a paged cache in one exact-shape call.  Returns (logits
        [n_new, 1, V], one row per prompt, and the cache with every prompt's
        K/V written through the page tables)."""
        with dispatch.phase_scope("prefill"):
            return reg.prefill_packed_fn(self.cfg, page_size)(
                self.params, cache, self._ints(packed.tokens),
                self._ints(packed.slot_ids), self._ints(packed.positions),
                self._ints(tables), self._ints(packed.last_idx))
