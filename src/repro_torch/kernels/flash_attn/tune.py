"""Time the tiled flash kernel under each of its instances, the measurement
behind :func:`~repro_torch.kernels.flash_attn.kernel.flash_tiled_config`.

For each head width D (16, 32, 64, 128) at smollm-360m's scoring shape
(B 4, S 2048, H 15, KV 5, causal), in f32 and bf16, every instance of
``csrc/flash_attention_tiled.cu`` (query rows of a block x rows a thread)
that fits a block's shared memory is checked to give the bits of
``csrc/flash_attention.cu`` (``torch.equal``) and timed by CUDA-graph replay
(the dispatch profiler's timer), beside the other kernel and
``F.scaled_dot_product_attention`` on K/V pre-expanded to 15 heads (TF32
off).  Prints one line per D and dtype, then ``TUNE <json>``; with ``--out
PATH`` also writes the JSON there; ``--seq`` shortens the sequence for a
quick check.  On a machine with the card, from the repository root:

    PYTHONPATH=src python -m repro_torch.kernels.flash_attn.tune
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels._build import SMEM_BYTES
from repro_torch.kernels.flash_attn.kernel import (FLASH_TILED_RPT8_MAX_D,
                                                   FLASH_TILED_SHAPES,
                                                   flash_attention_scalar_cuda,
                                                   flash_attention_tiled_cuda,
                                                   flash_tiled_config,
                                                   flash_tiled_smem_bytes)

B, S, H, KV = 4, 2048, 15, 5
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def instances(d: int, dtype: torch.dtype) -> list:
    """The tiled kernel's instances for a head of ``d`` in ``dtype``."""
    return [(r, t) for r, t in FLASH_TILED_SHAPES
            if (t != 8 or d <= FLASH_TILED_RPT8_MAX_D)
            and flash_tiled_smem_bytes(d, dtype, r) <= SMEM_BYTES]


def sweep(seq: int = S, head_dims=HEAD_DIMS, dtypes=DTYPES,
          seed: int = 0) -> list:
    from repro_torch.dispatch import device_time_us

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    recs = []
    for d in head_dims:
        for dtype in dtypes:
            q, k, v = (torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to(dev, dtype)
                for shape in ((B, seq, H, d), (B, seq, KV, d), (B, seq, KV, d)))
            want = flash_attention_scalar_cuda(q, k, v)
            mapping = (torch.arange(H, device=dev) * KV) // H
            qh, kh, vh = (t.transpose(1, 2).contiguous()
                          for t in (q, k[:, :, mapping], v[:, :, mapping]))
            us = {}
            for shape in instances(d, dtype):
                got = flash_attention_tiled_cuda(q, k, v, shape=shape)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"D {d} {dtype} shape {shape}: not the "
                                       "bits of flash_attention.cu")
                us[shape] = device_time_us(
                    lambda: flash_attention_tiled_cuda(q, k, v, shape=shape),
                    iters=5, device=dev)
            scalar_us = device_time_us(
                lambda: flash_attention_scalar_cuda(q, k, v), iters=5,
                device=dev)
            sdpa_us = device_time_us(
                lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                       is_causal=True),
                iters=5, device=dev)
            pick = flash_tiled_config(d, dtype)
            best = min(us, key=us.get)
            tflop = 4 * B * H * d * seq * (seq + 1) / 2 / 1e12
            recs.append({"d": d, "dtype": str(dtype).replace("torch.", ""),
                         "seq": seq, "us": {f"{r}x{t}": x
                                            for (r, t), x in us.items()},
                         "scalar_us": scalar_us, "sdpa_us": sdpa_us,
                         "rule": f"{pick[0]}x{pick[1]}",
                         "best": f"{best[0]}x{best[1]}"})
            print(f"D={d} {recs[-1]['dtype']} S={seq}: " + " ".join(
                f"{r}x{t}={x:.1f}us" for (r, t), x in us.items())
                + f"; flash_attention.cu {scalar_us:.1f}us, SDPA "
                f"{sdpa_us:.1f}us; rule {pick[0]}x{pick[1]} "
                f"({us[pick] / us[best]:.3f}x the best, {best[0]}x{best[1]}, "
                f"{tflop / us[best] * 1e6:.2f} TFLOP/s); bit-identical",
                flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--seq", type=int, default=S)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune: no CUDA device; this runs only on the card")
    print(torch.cuda.get_device_name(0), flush=True)
    recs = sweep(seq=args.seq)
    print("TUNE " + json.dumps(recs), flush=True)
    if args.out is not None:
        args.out.write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
