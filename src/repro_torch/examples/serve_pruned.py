"""Serve a column-wise pruned model with batched requests (twin of
``examples/serve_pruned.py``): ``Engine.generate`` at sparsity 0, 0.5 and
0.75 on the same reduced qwen2-7b config (untied embeddings), with prefill
time and decode tokens/s of each.

    python -m repro_torch.examples.serve_pruned [--device cpu]
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.core.pruning import SparsityConfig
from repro_torch.examples._cli import parse_device
from repro_torch.models import registry as reg
from repro_torch.serve import Engine, ServeConfig

SPARSITIES = (0.0, 0.5, 0.75)


def build(sparsity: float, device=None, n_layers: int = 4,
          d_model: int = 512, d_ff: int = 4096):
    scfg = SparsityConfig(
        sparsity=sparsity, m=None, tile=None,  # tile = d_out
        format="compressed_xla" if sparsity else "dense", min_dim=64)
    cfg = smoke_config("qwen2-7b").with_(
        n_layers=n_layers, d_model=d_model, n_heads=4, n_kv_heads=2,
        head_dim=128, d_ff=d_ff, vocab_size=512, sparsity=scfg)
    return cfg, reg.init_params(cfg, 0, device=device)


def main(device=None, n_prompts: int = 32, prompt_len: int = 16,
         new_tokens: int = 24, n_layers: int = 4, d_model: int = 512,
         d_ff: int = 4096, sparsities=SPARSITIES):
    """Generate at each sparsity on ``device`` (``None``: the CUDA card);
    returns ``{sparsity: generate's result}`` of the second (warm) run."""
    prompts = np.random.default_rng(0).integers(
        0, 500, (n_prompts, prompt_len)).astype(np.int32)
    base, out = None, {}
    for s in sparsities:
        cfg, params = build(s, device, n_layers, d_model, d_ff)
        eng = Engine(cfg, params, ServeConfig(max_new_tokens=new_tokens))
        eng.generate(prompts)  # warm-up: the library and the dispatch memos
        res = eng.generate(prompts)
        if base is None:
            base = res["decode_tok_s"]
        print(f"sparsity {int(s * 100):>2}%  prefill "
              f"{res['prefill_s'] * 1e3:7.1f} ms  decode "
              f"{res['decode_tok_s']:8.1f} tok/s  speedup "
              f"x{res['decode_tok_s'] / base:.2f}")
        print(f"   sample: {res['tokens'][0][:12].tolist()}")
        out[s] = res
    return out


if __name__ == "__main__":
    main(parse_device(sys.argv[1:], __doc__.splitlines()[0]))
