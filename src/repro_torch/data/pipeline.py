"""Deterministic, resumable synthetic token stream (twin of
``repro/data/pipeline.py``, of which the port keeps its own copy).

The batch for global step k is a pure function of (seed, k), with no
iterator state beyond the step counter; the batches are numpy and
bit-identical to the JAX package's.  The "bigram" stream is drawn from a
fixed random Markov table, so a model has structure to learn; "uniform"
draws every token independently.  The table is [vocab, vocab] (9.6 GB of
f32 at vocab 49152), so only the bigram kind builds it: its draws come
from the table's own generator, so the uniform stream is the same either
way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int = 503
    batch: int = 8
    seq_len: int = 64
    seed: int = 1234
    kind: str = "bigram"  # bigram | uniform


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.table: Optional[np.ndarray] = None
        if cfg.kind != "uniform":
            rng = np.random.default_rng(cfg.seed)
            v = cfg.vocab_size
            # sparse-ish bigram table: each token has ~8 likely successors
            logits = rng.normal(size=(v, v)).astype(np.float32)
            top = np.argsort(-logits, axis=1)[:, :8]
            boost = np.zeros_like(logits)
            np.put_along_axis(boost, top, 4.0, axis=1)
            p = np.exp(logits * 0.1 + boost)
            self.table = p / p.sum(axis=1, keepdims=True)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        from repro_torch import fault as _fault

        _fault.maybe_fail("data.batch", step=step)
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        if cfg.kind == "uniform":
            toks = rng.integers(0, cfg.vocab_size, (cfg.batch, cfg.seq_len))
            return {"tokens": toks.astype(np.int32)}
        toks = np.empty((cfg.batch, cfg.seq_len), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, cfg.batch)
        # vectorized Markov sampling via inverse-CDF per column
        u = rng.random((cfg.batch, cfg.seq_len))
        cdf = np.cumsum(self.table, axis=1)
        for t in range(1, cfg.seq_len):
            rows = cdf[toks[:, t - 1]]
            toks[:, t] = (rows < u[:, t : t + 1]).sum(axis=1)
        return {"tokens": toks.astype(np.int32)}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

    # -- checkpointable state ------------------------------------------------
    def state_dict(self, step: int) -> Dict:
        return {"seed": self.cfg.seed, "step": step}

    @staticmethod
    def resume_step(state: Dict) -> int:
        return int(state["step"])
