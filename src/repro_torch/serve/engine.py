"""Serving engine: batched prefill and decode with per-sequence completion,
greedy or temperature sampling, and padded-vocab masking (twin of
``repro/serve/engine.py``).

The engine owns the step primitives (``prefill_step``,
``prefill_chunk_step``, ``decode_step`` on a contiguous cache,
``packed_prefill_step`` and ``paged_decode_step`` on a paged one, and
``sample``), which two consumers share: the static-batch
:meth:`Engine.generate` and the continuous-batching
:class:`repro_torch.serve.scheduler.Scheduler`.

Every step runs under a :func:`repro_torch.dispatch.phase_scope`, so each
sparse-operator lookup inside resolves a phase-tagged key: prefill
([B*S]-row operands) and decode ([B]-row operands) get separately planned
implementations.

Temperature sampling draws on the logits' device from the engine's
``torch.Generator``, seeded from ``ServeConfig.seed`` at each run; the JAX
package's ``jax.random`` draws cannot be matched, only their distribution.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import dispatch
from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as reg
from repro_torch.obs import trace as _ot

NEG = -1e30


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 => greedy
    eos_id: Optional[int] = None
    seed: int = 0
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
        # None => a fresh config per engine (a shared default instance would
        # be mutable state common to every Engine)
        self.scfg = serve_cfg if serve_cfg is not None else ServeConfig()
        self.device = params["embed"].device
        self.generator = torch.Generator(device=self.device)
        self.reseed()
        # Build-time dispatch: resolve (and optionally profile) every
        # compressed layer's implementation per phase before the first step.
        scfg = self.scfg
        with _ot.span("engine.build", arch=cfg.name):
            self.dispatch_plan = dispatch.plan_params(
                params, batch_hint=scfg.dispatch_batch_hint,
                phase_hints={
                    "prefill": scfg.dispatch_batch_hint * scfg.dispatch_seq_hint,
                    "decode": scfg.dispatch_batch_hint,
                },
                profile=scfg.profile_dispatch)

    def reseed(self) -> None:
        """Restart the sampling generator from ``ServeConfig.seed`` (each
        ``generate`` and each scheduler run starts here, as the JAX engine
        starts each from ``PRNGKey(seed)``)."""
        self.generator.manual_seed(self.scfg.seed)

    def _ints(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.int32)
        return torch.from_numpy(np.array(a, np.int32)).to(self.device)

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Next tokens [N] int32 from [N, S, V] logits (last position), on
        the logits' device.  The padded vocab ids are set to -1e30 first.
        Greedy is ``argmax`` (the first maximum wins); temperature T > 0
        draws from softmax(logits / T) by the Gumbel-max trick with the
        engine's generator."""
        logits = logits[:, -1].float()
        v = self.cfg.vocab_size
        if self.cfg.padded_vocab != v:
            logits = logits.clone()
            logits[:, v:] = NEG
        t = self.scfg.temperature
        if t <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        u = torch.rand(logits.shape, generator=self.generator,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits / t + gumbel, dim=-1).to(torch.int32)

    # ------------------------------------------------------------------
    # Contiguous-cache steps (generate() and the contiguous Scheduler)
    # ------------------------------------------------------------------

    def prefill_step(self, prompts, max_len: int):
        """Run prompts [B, S] through the model.  Returns (last-token
        logits [B, 1, V], decode-ready cache of ``max_len`` rows).  The
        recurrent families' prefill (a recurrence over the prompt) raises
        in ``lm.prefill``, naming ROADMAP queue 1 item 10."""
        tokens = self._ints(prompts)
        b, s = tokens.shape
        with dispatch.phase_scope("prefill"):
            logits, cache = reg.prefill_fn(self.cfg)(self.params,
                                                     {"tokens": tokens})
        return logits, self._grow_cache(cache, b, max_len, s)

    def prefill_chunk_step(self, cache, tokens, start: int,
                           with_logits: bool = True):
        """Prefill one fixed-width chunk of a prompt into a preallocated
        contiguous cache (the scheduler's admission path), writing through
        the given cache, which may be a view of one slot's rows.
        ``with_logits=False`` skips the unembedding: only the chunk holding
        the last prompt token needs logits."""
        with dispatch.phase_scope("prefill"):
            return reg.prefill_chunk_fn(self.cfg)(
                self.params, cache, self._ints(tokens), int(start),
                bool(with_logits))

    def decode_step(self, cache, tokens, pos):
        """One decode step.  tokens [B, 1]; pos a scalar or a per-sequence
        [B] vector.  Returns (logits [B, 1, V], cache); the cache is
        written in place."""
        with dispatch.phase_scope("decode"):
            return reg.decode_fn(self.cfg)(self.params, cache,
                                           self._ints(tokens), self._ints(pos))

    def _grow_cache(self, cache, b: int, max_len: int, cur_len: int):
        """The prompt's cache of ``cur_len`` rows in a cache of ``max_len``."""
        if cache["k"].shape[2] >= max_len:
            return cache
        full = reg.cache_init_fn(self.cfg, b, max_len, self.device)()
        for key in ("k", "v"):
            full[key][:, :, :cur_len] = cache[key]
        return full

    # ------------------------------------------------------------------
    # Paged-cache steps (the paged Scheduler)
    # ------------------------------------------------------------------

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

    # ------------------------------------------------------------------
    # Static-batch generation
    # ------------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts: np.ndarray) -> Dict:
        """prompts [B, S_prompt] int32.  Returns the generated tokens
        [B, n] and the timings.

        With ``eos_id`` set, the positions after a sequence's EOS are set to
        ``eos_id`` (never the live tokens the batch keeps sampling for the
        sequences still running), and ``gen_lens[b]`` counts the tokens
        sequence b generated, its EOS included.  The card is synchronised
        before each clock read.
        """
        scfg = self.scfg
        b, s = np.shape(prompts)
        max_len = s + scfg.max_new_tokens
        self.reseed()

        self._sync()
        t0 = time.perf_counter()
        with _ot.span("engine.prefill", batch=b, seq=s):
            logits, cache = self.prefill_step(prompts, max_len)
        self._sync()
        t_prefill = time.perf_counter() - t0

        out = []
        done = np.zeros((b,), bool)
        gen_len = np.zeros((b,), np.int32)

        def record(tok: torch.Tensor) -> np.ndarray:
            """Mask post-EOS samples, track done and lengths; returns the
            token that is both emitted and fed to the next decode step."""
            t = tok.cpu().numpy()
            if scfg.eos_id is not None:
                t = np.where(done, scfg.eos_id, t).astype(np.int32)
            gen_len[:] += ~done
            out.append(t)
            if scfg.eos_id is not None:
                done[:] |= t == scfg.eos_id
            return t

        tok = record(self.sample(logits))
        t1 = time.perf_counter()
        with _ot.span("engine.decode_loop", batch=b,
                      budget=scfg.max_new_tokens) as dsp:
            steps = 0
            for i in range(scfg.max_new_tokens - 1):
                if done.all():
                    break
                logits, cache = self.decode_step(cache, tok[:, None], s + i)
                tok = record(self.sample(logits))
                steps += 1
            dsp.set(steps=steps)
        self._sync()
        t_decode = time.perf_counter() - t1
        gen = np.stack(out, axis=1)
        return {
            "tokens": gen,
            "gen_lens": gen_len.copy(),
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "decode_tok_s": gen.shape[1] * b / max(t_decode, 1e-9),
        }
