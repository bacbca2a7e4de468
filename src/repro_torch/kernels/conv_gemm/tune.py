"""Time the tiled banded conv kernel under each of its instances, the
measurement behind :func:`~repro_torch.kernels.conv_gemm.kernel.banded_tiled_config`.

For each of resnet-tiny's five pruned convs (batch 256, O 16, tile 8, 50%
kept) and two ResNet-18 convs (3x3 at batch 8, tile 8, 50%: layer1, 64 ->
64 at 56x56, and layer2, 128 -> 128 at 28x28, whose weights a block stages
a group of tiles at a time), in f32 and bf16, under each band geometry the
dispatch registry races (``BANDED_CONV_GEOMETRY``: strip width v, block_k,
strips a band hb), every instance of ``csrc/conv2d_fused_banded_tiled.cu``
(positions a thread) that the shape takes is checked to
give the bits of ``csrc/conv2d_fused_banded.cu`` (or, where that kernel
does not take the shape, of ``csrc/conv2d_fused.cu``, which gives the same
bits) with ``torch.equal``, and timed by CUDA-graph replay (the
dispatch profiler's timer), beside ``conv2d_fused_banded.cu`` and
``F.conv2d`` on the dense masked weight (cuDNN, TF32 off).  Prints the
registers and spills of each instance (``-Xptxas -v``), one line per conv,
dtype and geometry, then the five resnet-tiny convs summed per instance,
then ``TUNE <json>``; with ``--out PATH`` also writes the JSON there.  On a
machine with the card, from the repository root:

    PYTHONPATH=src python -m repro_torch.kernels.conv_gemm.tune
"""
from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.conv_gemm.kernel import (BANDED_TILED_POSITIONS,
                                                  banded_tiled_config,
                                                  banded_tiled_geometry,
                                                  conv2d_fused_banded_scalar_cuda,
                                                  conv2d_fused_banded_tiled_cuda,
                                                  conv2d_fused_cuda)
from repro_torch.kernels.im2col_pack.ref import out_size

# (name, C, B, H, W, O, k, stride, pad): resnet-tiny's pruned convs at batch
# 256 (configs/resnet_tiny.py), then ResNet-18's layer1 and layer2 3x3 convs
# at batch 8
CONVS = (("blocks[0]/conv1", 8, 256, 16, 16, 16, 3, 1, 1),
         ("blocks[0]/conv2", 16, 256, 16, 16, 16, 3, 1, 1),
         ("blocks[1]/conv1", 16, 256, 16, 16, 16, 3, 2, 1),
         ("blocks[1]/conv2", 16, 256, 8, 8, 16, 3, 1, 1),
         ("blocks[1]/proj", 16, 256, 16, 16, 16, 1, 2, 0),
         ("resnet18/layer1", 64, 8, 56, 56, 64, 3, 1, 1),
         ("resnet18/layer2", 128, 8, 28, 28, 128, 3, 1, 1))
TILE = 8
# dispatch/registry.py BANDED_CONV_GEOMETRY, as (v, block_k, hb)
GEOMETRIES = ((128, 128, 2), (256, 128, 2), (128, 128, 4), (128, 64, 1))
DTYPES = (torch.float32, torch.bfloat16)


def banded_tiled_registers(log: Path) -> list:
    """(instance, registers, spills) of each conv2d_fused_banded_tiled.cu
    instance, from the ``-Xptxas -v`` output the build keeps: instance as
    "f32|bf16 P=p" (positions a thread)."""
    out, inst, spill = [], None, ""
    for line in log.read_text().splitlines():
        m = re.search(r"banded_tiled_kernelI(f|13__nv_bfloat16)Li(\d+)EE", line)
        if "Compiling entry function" in line:
            inst = (f"{'f32' if m.group(1) == 'f' else 'bf16'} "
                    f"P={m.group(2)}") if m else None
        elif inst and "spill" in line:
            spill = line.strip()
        elif inst and "registers" in line:
            out.append((inst, int(re.search(r"Used (\d+) registers", line)
                                  .group(1)), spill))
            inst = None
    return out


def _problem(c, b, h, w, o, k, dtype, dev, rng):
    k_rows = k * k * c
    k_kept = k_rows // 2
    x = torch.from_numpy(rng.standard_normal((c, b, h, w), dtype=np.float32))
    values = rng.standard_normal((o // TILE, k_kept, TILE), dtype=np.float32)
    idx = np.stack([np.sort(rng.choice(k_rows, k_kept, replace=False))
                    for _ in range(o // TILE)]).astype(np.int32)
    values = torch.from_numpy(values)
    w_dense = torch.zeros(o // TILE, k_rows, TILE)
    w_dense.scatter_(1, torch.from_numpy(idx).long()[..., None].expand(
        -1, -1, TILE), values)
    w_oihw = (w_dense.permute(0, 2, 1).reshape(o, k, k, c)
              .permute(0, 3, 1, 2).contiguous())
    return (x.to(dev, dtype), values.to(dev, dtype), torch.from_numpy(idx).to(dev),
            w_oihw.to(dev, dtype))


def sweep(convs=CONVS, geometries=GEOMETRIES, dtypes=DTYPES, seed: int = 0,
          iters: int = 20) -> list:
    from repro_torch.dispatch import device_time_us

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    recs = []
    for name, c, b, h, w, o, k, stride, pad in convs:
        for dtype in dtypes:
            x, values, idx, w_oihw = _problem(c, b, h, w, o, k, dtype, dev, rng)
            isz = x.element_size()
            n_tiles, k_kept, _ = values.shape
            x_nchw = x.permute(1, 0, 2, 3).contiguous()
            cudnn_us = device_time_us(
                lambda: F.conv2d(x_nchw, w_oihw, stride=stride, padding=pad),
                iters=iters, device=dev)
            geo_args = dict(kh=k, kw=k, stride=stride, pad=pad)
            for v, bk, hb in geometries:
                want = conv2d_fused_cuda(x, values, idx, v=v, **geo_args)
                scalar_us = None
                try:  # the wrapper refuses a shape by ValueError, unlaunched
                    got = conv2d_fused_banded_scalar_cuda(
                        x, values, idx, v=v, block_k=bk, hb=hb, **geo_args)
                except ValueError:
                    got = None
                if got is not None:
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise RuntimeError(f"{name} {dtype} v{v} hb{hb}: "
                                           "conv2d_fused_banded.cu is not the "
                                           "bits of conv2d_fused.cu")
                    want = got
                    scalar_us = device_time_us(
                        lambda: conv2d_fused_banded_scalar_cuda(
                            x, values, idx, v=v, block_k=bk, hb=hb,
                            **geo_args), iters=iters, device=dev)
                geo = banded_tiled_geometry(c, b, h, w, k, k, stride, pad, v,
                                            hb, n_tiles, k_kept, TILE, isz)
                us = {}
                if geo is not None:
                    for p in BANDED_TILED_POSITIONS:
                        got = conv2d_fused_banded_tiled_cuda(
                            x, values, idx, v=v, hb=hb, positions=p,
                            **geo_args)
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            raise RuntimeError(
                                f"{name} {dtype} v{v} hb{hb} P={p}: not the "
                                "bits of the other banded kernel")
                        us[f"P={p}"] = device_time_us(
                            lambda: conv2d_fused_banded_tiled_cuda(
                                x, values, idx, v=v, hb=hb, positions=p,
                                **geo_args),
                            iters=iters, device=dev)
                pick = None
                if geo is not None:
                    pick = "P=%d" % banded_tiled_config(geo["group"], TILE,
                                                        geo["hb"], v)
                best = min(us, key=us.get) if us else None
                ho, wo = out_size(h, k, stride, pad), out_size(w, k, stride, pad)
                gflop = 2 * o * k_kept * b * ho * wo / 1e9
                rec = {"conv": name, "dtype": str(dtype).replace("torch.", ""),
                       "v": v, "bk": bk, "hb": hb, "tiled_us": us,
                       "scalar_us": scalar_us, "cudnn_us": cudnn_us,
                       "rule": pick, "best": best, "gflop": gflop,
                       "group": None if geo is None else geo["group"],
                       "smem": None if geo is None else geo["smem"]}
                recs.append(rec)
                tiled = " ".join(f"{kk}={t:.2f}" for kk, t in us.items()) or "refused"
                old = "refused" if scalar_us is None else f"{scalar_us:.2f}us"
                rule = ("" if best is None else
                        f"; group {geo['group']} of {n_tiles} tiles"
                        f"; rule {pick} ({us[pick] / us[best]:.3f}x the best, "
                        f"{best}, {gflop / us[best] * 1e3:.2f} TFLOP/s)")
                print(f"{name} {rec['dtype']} v{v} bk{bk} hb{hb}: tiled (us) "
                      f"{tiled}; conv2d_fused_banded.cu {old}; cuDNN "
                      f"{cudnn_us:.2f}us{rule}; bit-identical", flush=True)
    return recs


def summarize(recs) -> None:
    """Per dtype and geometry, each instance's time summed over the five
    resnet-tiny convs, beside the other kernel's and cuDNN's."""
    for dtype in {r["dtype"] for r in recs}:
        for v, bk, hb in GEOMETRIES:
            rows = [r for r in recs if r["dtype"] == dtype and r["v"] == v
                    and r["hb"] == hb and r["bk"] == bk
                    and not r["conv"].startswith("resnet18")]
            if len(rows) != 5 or not all(r["tiled_us"] for r in rows):
                continue
            insts = set.intersection(*(set(r["tiled_us"]) for r in rows))
            sums = {i: sum(r["tiled_us"][i] for r in rows) for i in sorted(insts)}
            rule = sum(r["tiled_us"][r["rule"]] for r in rows)
            old = (None if any(r["scalar_us"] is None for r in rows)
                   else sum(r["scalar_us"] for r in rows))
            print(f"SUM resnet-tiny {dtype} v{v} bk{bk} hb{hb}: tiled (us) "
                  + " ".join(f"{i}={t:.2f}" for i, t in sums.items())
                  + f"; rule {rule:.2f}; conv2d_fused_banded.cu "
                  + ("refused" if old is None else f"{old:.2f}")
                  + f"; cuDNN {sum(r['cudnn_us'] for r in rows):.2f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune: no CUDA device; this runs only on the card")
    from repro_torch.kernels import _build

    print(torch.cuda.get_device_name(0), flush=True)
    for inst, regs, spill in banded_tiled_registers(_build.build().parent / "build.log"):
        print(f"conv2d_fused_banded_tiled {inst}: {regs} registers, {spill}",
              flush=True)
    recs = sweep()
    summarize(recs)
    print("TUNE " + json.dumps(recs), flush=True)
    if args.out is not None:
        args.out.write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
