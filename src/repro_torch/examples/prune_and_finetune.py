"""The paper's full workflow on a small LM (twin of
``examples/prune_and_finetune.py``):

  1. train dense
  2. one-shot column-wise N:M prune (L1 importance, adaptive M)  [paper §3.1]
  3. finetune with the mask fixed                                 [paper §4.1.2]
  4. compress to the packed format and check that the compressed
     forward matches the masked model                             [paper Fig. 1]
  5. compare against the conventional row-wise N:M baseline

    python -m repro_torch.examples.prune_and_finetune [--device cpu]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch._compat import resolve_device
from repro_torch._tree import keystr, leaves_with_path, tree_map
from repro_torch.configs import smoke_config
from repro_torch.core import SparsityConfig, compress_layer, prune_tree
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.examples._cli import parse_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import registry as reg
from repro_torch.optim import AdamWConfig, adamw_init

SPARSITY = 0.5
LOSS_RTOL = 1e-4  # compressed against masked loss: the same sums reordered


def train(cfg, params, data, steps, lr, masks=None, start=0):
    step = make_train_step(cfg, AdamWConfig(lr=lr, weight_decay=0.01))
    opt = adamw_init(params)
    loss = None
    for k in range(steps):
        params, opt, metrics = step(params, opt, data.batch_at(start + k))
        if masks is not None:
            params = tree_map(
                lambda w, m: w * m.to(w.dtype) if m is not None else w,
                params, masks)
        loss = metrics["loss"]
    return params, float(loss)


def evaluate(cfg, params, data, n=6):
    lfn = reg.loss_fn(cfg)
    with torch.no_grad():
        return float(np.mean([float(lfn(params, data.batch_at(50000 + i))[0])
                              for i in range(n)]))


def compress_inplace(tree, masks, scfg):
    """Every masked ``{"w"}`` layer into ``{"values", "idx"[, "b"]}``."""
    if (isinstance(tree, dict) and "w" in tree and isinstance(masks, dict)
            and masks.get("w") is not None):
        return compress_layer({"w": tree["w"], "mask": masks["w"],
                               **({"b": tree["b"]} if "b" in tree else {})},
                              scfg)
    if isinstance(tree, dict):
        return {k: compress_inplace(
            v, masks.get(k) if isinstance(masks, dict) else None, scfg)
            for k, v in tree.items()}
    return tree


def main(device=None, dense_steps: int = 120, finetune_steps: int = 60,
         batch: int = 16, seq_len: int = 48, eval_batches: int = 6):
    """Run the workflow on ``device`` (``None``: the CUDA card); returns
    ``{"dense_nll", "results": {name: (one_shot, finetuned)},
    "masked_loss", "compressed_loss", "kept", "total"}``.  Raises where the
    compressed loss departs from the masked one by more than
    ``LOSS_RTOL``."""
    dev = resolve_device(device)
    cfg = smoke_config("smollm-360m").with_(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=128, tie_embeddings=False)
    data = SyntheticLM(DataConfig(vocab_size=128, batch=batch,
                                  seq_len=seq_len, seed=5))
    params = reg.init_params(cfg, 0, device=dev)

    print("1) dense training ...")
    params, _ = train(cfg, params, data, dense_steps, 3e-3)
    dense_nll = evaluate(cfg, params, data, eval_batches)
    print(f"   dense eval nll = {dense_nll:.4f}")

    def not_embed(path, leaf):
        return "embed" not in keystr(path)

    results, tuned_by = {}, {}
    for name, kw in {
        "colwise adaptive-M (paper)": dict(m=None, tile=8, scheme="colwise"),
        "rowwise 2:4 baseline": dict(m=4, tile=1, scheme="rowwise"),
    }.items():
        scfg = SparsityConfig(sparsity=SPARSITY, format="masked", min_dim=64,
                              **kw)
        pruned, masks = prune_tree(params, scfg, is_weight=not_embed)
        one_shot = evaluate(cfg, pruned, data, eval_batches)
        tuned, _ = train(cfg, pruned, data, finetune_steps, 1e-3,
                         masks=masks, start=200)
        ft = evaluate(cfg, tuned, data, eval_batches)
        results[name] = (one_shot, ft)
        tuned_by[name] = (tuned, masks)
        print(f"2-3) {name}: one-shot {one_shot:.4f} -> finetuned {ft:.4f}")

    # 4) compress the column-wise model and hold its forward to the masked
    tuned, masks = tuned_by["colwise adaptive-M (paper)"]
    scfg = SparsityConfig(sparsity=SPARSITY, m=None, tile=8,
                          format="compressed_xla", min_dim=64)
    lfn = reg.loss_fn(cfg)
    batch0 = data.batch_at(0)
    comp_params = compress_inplace(tuned, masks, scfg)
    with torch.no_grad():
        masked_loss = float(lfn(tuned, batch0)[0])
        comp_loss = float(lfn(comp_params, batch0)[0])
    print(f"4) compressed forward loss {comp_loss:.6f} vs masked "
          f"{masked_loss:.6f} (delta {abs(comp_loss - masked_loss):.2e})")
    if not abs(comp_loss - masked_loss) <= LOSS_RTOL * abs(masked_loss):
        raise AssertionError(f"compressed loss {comp_loss} vs masked "
                             f"{masked_loss}")
    kept = sum(leaf.numel() for p, leaf in leaves_with_path(comp_params)
               if "values" in keystr(p))
    total = sum(leaf.numel() for p, leaf in leaves_with_path(tuned)
                if keystr(p).endswith("['w']"))
    print(f"   stored body weights: {kept} vs dense {total} "
          f"({100 * kept / max(total, 1):.0f}%)")
    return {"dense_nll": dense_nll, "results": results,
            "masked_loss": masked_loss, "compressed_loss": comp_loss,
            "kept": kept, "total": total}


if __name__ == "__main__":
    main(parse_device(sys.argv[1:], __doc__.splitlines()[0]))
