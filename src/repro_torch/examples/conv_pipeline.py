"""The paper's own domain, end to end (twin of ``examples/conv_pipeline.py``):
sparse convolution through the dispatched conv plan (on the card the fused
im2col + pack + column-wise N:M GEMM kernel the shape rule picks), checked
layer by layer against a dense float64 convolution of the masked weights,
with each layer's FLOP share.

    python -m repro_torch.examples.conv_pipeline [--device cpu]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch._compat import resolve_device
from repro_torch.core.pruning import SparsityConfig, colwise_nm_mask
from repro_torch.examples._cli import parse_device
from repro_torch.kernels.conv_gemm import (compress_conv_weights,
                                           conv2d_cnhw_ref,
                                           conv2d_colwise_sparse)

LAYERS = [
    # (C_in, C_out, k, stride): a ResNet-style block
    (8, 16, 3, 1),
    (16, 16, 3, 1),
    (16, 32, 1, 1),
]
SPARSITY = 0.5
RTOL = 1e-4  # max|err| of a layer, of its oracle's max|y|


def main(device=None, batch: int = 2, hw: int = 16, layers=LAYERS,
         v: int = 32, seed: int = 0):
    """Run the block on ``device`` (``None``: the CUDA card); returns
    ``{"layers": [{"max_err", "max_ref", "flops", "dense_flops"}], ...}``.
    Raises where a layer's max|err| passes ``RTOL`` of its oracle's
    max|y|."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (layers[0][0], batch, hw, hw), dtype=np.float32)).to(dev)  # CNHW
    out, total_dense, total_sparse = [], 0, 0
    with torch.no_grad():
        for i, (cin, cout, k, stride) in enumerate(layers):
            w = torch.from_numpy((rng.standard_normal(
                (cout, k, k, cin)) / np.sqrt(k * k * cin)).astype(
                    np.float32)).to(dev)
            cfg = SparsityConfig(sparsity=SPARSITY, m=None, tile=8,
                                 format="compressed_pallas")
            values, idx, meta = compress_conv_weights(w, cfg)
            pad = k // 2
            y = conv2d_colwise_sparse(x, values, idx, kh=k, kw=k,
                                      stride=stride, pad=pad, v=v)
            # oracle: a dense float64 conv of the masked weights on the host
            wmat = w.reshape(cout, -1).T
            mask = colwise_nm_mask(wmat, SPARSITY, m=None, tile=meta.tile)
            w_masked = (wmat * mask.to(wmat.dtype)).T.reshape(w.shape)
            y_ref = conv2d_cnhw_ref(x.double().cpu(), w_masked.double().cpu(),
                                    stride=stride, pad=pad)
            err = float((y.double().cpu() - y_ref).abs().max())
            ref = float(y_ref.abs().max())
            if not err <= RTOL * ref:
                raise AssertionError(f"layer {i}: max|err| {err} > {RTOL} of "
                                     f"max|y| {ref}")
            dense_flops = 2 * int(np.prod(y.shape)) * k * k * cin
            sparse_flops = int(dense_flops * meta.density)
            total_dense += dense_flops
            total_sparse += sparse_flops
            out.append({"max_err": err, "max_ref": ref, "flops": sparse_flops,
                        "dense_flops": dense_flops})
            print(f"layer {i}: {cin:>3}->{cout:<3} {k}x{k}  out "
                  f"{tuple(y.shape)}  max|err| {err:.2e}  flops "
                  f"{sparse_flops / 1e6:.1f}M ({100 * meta.density:.0f}% of "
                  "dense)")
            x = torch.relu(y)
    print(f"\nblock total: {total_sparse / 1e6:.1f}M vs dense "
          f"{total_dense / 1e6:.1f}M flops "
          f"({100 * total_sparse / total_dense:.0f}%)")
    return {"layers": out, "flops": total_sparse, "dense_flops": total_dense}


if __name__ == "__main__":
    main(parse_device(sys.argv[1:], __doc__.splitlines()[0]))
