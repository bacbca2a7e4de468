"""Training launcher (twin of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 100 --sparsity 0.5 --ckpt-dir /tmp/ckpt [--smoke] [--device cpu]

Trains on the CUDA card unless ``--device cpu`` asks for the plain
versions on the CPU.  ``--smoke`` trains the reduced same-family config.
The JAX launcher's ``--mesh`` comes with the port's sharding.
"""
from __future__ import annotations

import argparse

from repro_torch._compat import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.pruning import SparsityConfig
from repro_torch.data import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--format", default="compressed_xla")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-friendly)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    scfg = SparsityConfig(sparsity=args.sparsity, m=None, tile=None,
                          format=args.format if args.sparsity > 0 else "dense",
                          min_dim=64 if args.smoke else 512)
    cfg = (smoke_config(args.arch) if args.smoke else get_config(args.arch))
    cfg = cfg.with_(sparsity=scfg)

    data = DataConfig(vocab_size=cfg.vocab_size, batch=args.batch,
                      seq_len=args.seq, seed=0)
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, log_every=10,
                       microbatches=args.microbatches)
    tr = Trainer(cfg, data, AdamWConfig(lr=args.lr), tcfg, device=device)
    out = tr.run()
    for h in out["history"]:
        print(f"step {h['step']:>6}  loss {h['loss']:.4f}  "
              f"gnorm {h.get('grad_norm', 0):.2f}  {h['sec_per_step']*1e3:.0f} ms")
    if out["preempted"]:
        print("preempted — final checkpoint written; restart to resume")


if __name__ == "__main__":
    main()
