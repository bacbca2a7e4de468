"""Quickstart (twin of ``examples/quickstart.py``): train a small
column-wise N:M pruned LM end to end with the LM ``Trainer``, on the card
(the sparse linear kernels forward, their autograd twins backward) or on
the CPU.

    python -m repro_torch.examples.quickstart [--device cpu]

Checkpoints go to ``ckpt_dir`` (by default the repository's gitignored
``build/repro_torch/examples/quickstart``); run it again to resume.
"""
from __future__ import annotations

import sys

from repro_torch.configs import smoke_config
from repro_torch.core.pruning import SparsityConfig
from repro_torch.data import DataConfig
from repro_torch.examples._cli import parse_device
from repro_torch.kernels._build import BUILD_ROOT
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer


def main(device=None, steps: int = 120, batch: int = 16, seq_len: int = 64,
         ckpt_dir=None, ckpt_every: int = 50, log_every: int = 20):
    """Train on ``device`` (``None``: the CUDA card); returns the
    ``Trainer.run`` result with ``"cfg"`` and ``"ckpt_dir"`` added."""
    # qwen2-family reduced config with the paper's technique on: 50%
    # sparsity, adaptive M (the full reduction dim), compressed execution
    scfg = SparsityConfig(sparsity=0.5, m=None, tile=64,
                          format="compressed_xla", min_dim=64)
    cfg = smoke_config("qwen2-0.5b").with_(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=256, sparsity=scfg)
    ckpt_dir = str(ckpt_dir or BUILD_ROOT / "examples" / "quickstart")
    data = DataConfig(vocab_size=256, batch=batch, seq_len=seq_len, seed=0)
    tr = Trainer(cfg, data, AdamWConfig(lr=3e-3, weight_decay=0.01),
                 TrainConfig(steps=steps, log_every=log_every,
                             ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
                 device=device)
    out = tr.run()
    print(f"\narch={cfg.name} (sparse 50% column-wise, compressed)")
    for h in out["history"]:
        print(f"  step {h['step']:>4}  loss {h['loss']:.4f}  "
              f"({h['sec_per_step'] * 1e3:.0f} ms/step)")
    print(f"final step: {out['final_step']}  stragglers: "
          f"{len(out['stragglers'])}")
    print(f"checkpoints in {ckpt_dir} (run again to resume)")
    return dict(out, cfg=cfg, ckpt_dir=ckpt_dir)


if __name__ == "__main__":
    main(parse_device(sys.argv[1:], __doc__.splitlines()[0]))
