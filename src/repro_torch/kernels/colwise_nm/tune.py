"""Time the tiled column-wise N:M kernels under each of their instances,
the measurements behind
:func:`~repro_torch.kernels.colwise_nm.kernel.tiled_block_rows` (the linear
section) and :func:`~repro_torch.kernels.colwise_nm.kernel.strips_tiled_config`
(the strips section).

Linear: for each of smollm-360m's four linear shapes (q/o 960->960, k/v
960->320, gate/up 960->2560, down 2560->960; 50% kept, T = d_out, f32) and
each row count, every block size of the kernel is timed by CUDA-graph replay
(the dispatch profiler's timer) and checked to give the same bits as the
rule's pick.

Strips: for resnet-tiny's five pruned convs (batch 256, O 16, tile 8, 50%
kept) and ResNet-18's 3x3 convs at batch 8 (tile 8, 50% kept: layer1 64 ->
64 at 56x56, layer2 128 at 28x28, layer3 256 at 14x14, layer4 512 at 7x7),
in f32 and bf16, strips of 128: every instance of
``csrc/colwise_nm_strips_tiled.cu`` (columns a thread; under ``hb`` 2
strips a block also 1 or 2 strip lanes) under both entry points (one strip
a block; ``hb`` 2 strips a block) is checked ``torch.equal`` to ``csrc/colwise_nm_strips.cu`` and timed beside
it, ``csrc/colwise_nm_strips_pipelined.cu`` and ``torch.matmul`` of the
dense masked [O, K] weight by the strips.  At layer3 and layer4, where no
banded conv fits, the two-kernel plans' totals (``im2col_pack`` and the
strip GEMM each entry point's rule picks) are timed beside
``conv2d_fused.cu`` and ``F.conv2d`` (cuDNN, TF32 off).

Prints one line per shape (and entry point), then ``TUNE <json>``; with
``--out PATH`` also writes the JSON there; ``--only linear|strips`` runs one
section.  On a machine with the card, from the repository root:

    PYTHONPATH=src python -m repro_torch.kernels.colwise_nm.tune
    PYTHONPATH=src python -m repro_torch.kernels.colwise_nm.tune --only strips
"""
from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.colwise_nm.kernel import (
    STRIPS_TILED_CPT,
    TILED_BLOCK_ROWS,
    colwise_nm_matmul_strips_cuda,
    colwise_nm_matmul_strips_pipelined_cuda,
    colwise_nm_matmul_strips_pipelined_scalar_cuda,
    colwise_nm_matmul_strips_pipelined_tiled_cuda,
    colwise_nm_matmul_strips_scalar_cuda,
    colwise_nm_matmul_strips_tiled_cuda,
    colwise_nm_matmul_tiled_cuda,
    strips_tiled_geometry,
    tiled_block_rows,
)

SHAPES = ((960, 960), (960, 320), (960, 2560), (2560, 960))
ROWS = (1, 4, 16, 17, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def _compressed(d_in: int, d_out: int, rng, device):
    k_kept = d_in // 2
    values = rng.standard_normal((1, k_kept, d_out), dtype=np.float32)
    idx = np.sort(rng.choice(d_in, k_kept, replace=False))[None]
    return (torch.from_numpy(values).to(device),
            torch.from_numpy(idx.astype(np.int32)).to(device))


def sweep(rows=ROWS, shapes=SHAPES, seed: int = 0) -> list:
    from repro_torch.dispatch import device_time_us

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    recs = []
    for d_in, d_out in shapes:
        values, idx = _compressed(d_in, d_out, rng, dev)
        for n in rows:
            x = torch.from_numpy(rng.standard_normal(
                (n, d_in), dtype=np.float32)).to(dev)
            pick = tiled_block_rows(n, d_out)
            want = colwise_nm_matmul_tiled_cuda(x, values, idx)
            us = {}
            for bm in TILED_BLOCK_ROWS:
                got = colwise_nm_matmul_tiled_cuda(x, values, idx, block_rows=bm)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"{d_in}->{d_out} rows={n}: BM {bm} "
                                       f"differs from BM {pick}")
                us[bm] = device_time_us(
                    lambda: colwise_nm_matmul_tiled_cuda(x, values, idx,
                                                         block_rows=bm),
                    device=dev)
            best = min(us, key=us.get)
            recs.append({"d_in": d_in, "d_out": d_out, "rows": n,
                         "us": {str(k): v for k, v in us.items()},
                         "rule": pick, "best": best})
            print(f"{d_in}->{d_out} rows={n}: " + " ".join(
                f"BM{bm}={t:.2f}us" for bm, t in us.items())
                + f"; rule BM{pick} ({us[pick] / us[best]:.3f}x the best, "
                f"BM{best})", flush=True)
    return recs


# (name, C, B, H, W, O, k, stride, pad): resnet-tiny's pruned convs at
# batch 256 (configs/resnet_tiny.py), then ResNet-18's 3x3 convs at batch 8
STRIP_CONVS = (("blocks[0]/conv1", 8, 256, 16, 16, 16, 3, 1, 1),
               ("blocks[0]/conv2", 16, 256, 16, 16, 16, 3, 1, 1),
               ("blocks[1]/conv1", 16, 256, 16, 16, 16, 3, 2, 1),
               ("blocks[1]/conv2", 16, 256, 8, 8, 16, 3, 1, 1),
               ("blocks[1]/proj", 16, 256, 16, 16, 16, 1, 2, 0),
               ("resnet18/layer1", 64, 8, 56, 56, 64, 3, 1, 1),
               ("resnet18/layer2", 128, 8, 28, 28, 128, 3, 1, 1),
               ("resnet18/layer3", 256, 8, 14, 14, 256, 3, 1, 1),
               ("resnet18/layer4", 512, 8, 7, 7, 512, 3, 1, 1))
# convs whose two-kernel plans are timed whole: no banded kernel fits them
PLAN_CONVS = ("resnet18/layer3", "resnet18/layer4")
STRIP_TILE, STRIP_V, STRIP_HB = 8, 128, 2
# H100 SXM: device memory bytes/s; TFLOP/s of f32 on the CUDA cores and of
# bf16 on the tensor cores (chip_smoke.py's bound)
HBM_BYTES_PER_S = 3.35e12
PEAK_TFLOPS = {torch.float32: 67.0, torch.bfloat16: 989.0}
DTYPES = (torch.float32, torch.bfloat16)


def strips_tiled_registers(log: Path) -> list:
    """(instance, registers, spills) of each colwise_nm_strips_tiled.cu
    instance, from the ``-Xptxas -v`` output the build keeps: instance as
    "f32|bf16 cpt=c" (columns a thread)."""
    out, inst, spill = [], None, ""
    for line in log.read_text().splitlines():
        m = re.search(r"strips_tiled_kernelI(f|13__nv_bfloat16)Li(\d+)EE", line)
        if "Compiling entry function" in line:
            inst = (f"{'f32' if m.group(1) == 'f' else 'bf16'} "
                    f"cpt={m.group(2)}") if m else None
        elif inst and "spill" in line:
            spill = line.strip()
        elif inst and "registers" in line:
            out.append((inst, int(re.search(r"Used (\d+) registers", line)
                                  .group(1)), spill))
            inst = None
    return out


def _strip_problem(c, b, h, w, o, k, stride, pad, dtype, dev, rng):
    """A CNHW map, its packed strips of 128, 50%-kept tiles of 8 rows and
    the dense masked [O, K] weight, on the card."""
    from repro_torch.core.formats import ColwiseMeta, unpack_colwise
    from repro_torch.kernels.im2col_pack import im2col_pack_cuda

    k_rows = k * k * c
    k_kept = k_rows // 2
    n_tiles = o // STRIP_TILE
    x = torch.from_numpy(rng.standard_normal((c, b, h, w), dtype=np.float32))
    values = torch.from_numpy(rng.standard_normal(
        (n_tiles, k_kept, STRIP_TILE), dtype=np.float32))
    idx = torch.from_numpy(np.stack([
        np.sort(rng.choice(k_rows, k_kept, replace=False))
        for _ in range(n_tiles)]).astype(np.int32))
    x, values, idx = x.to(dev, dtype), values.to(dev, dtype), idx.to(dev)
    strips = im2col_pack_cuda(x, k, k, stride, pad, STRIP_V)
    w_dense = unpack_colwise(values, idx, ColwiseMeta(
        k_rows, o, STRIP_TILE, k_rows, k_kept)).T.contiguous()  # [O, K]
    return x, strips, values, idx, w_dense


def _label(cpt, lanes, hb):
    return f"cpt{cpt}" + (f" lanes{lanes}" if hb > 1 else "")


def _instances(strips, values, hb):
    n_strips, _, v = strips.shape
    n_tiles, k_kept, tile = values.shape
    for cpt in STRIPS_TILED_CPT:
        for lanes in sorted({1, hb}):
            inst = dict(cpt=cpt, lanes=lanes) if hb > 1 else dict(cpt=cpt)
            if strips_tiled_geometry(n_strips, v, n_tiles, k_kept, tile,
                                     strips.element_size(), hb,
                                     **inst) is not None:
                yield _label(cpt, lanes, hb), inst


def sweep_strips(convs=STRIP_CONVS, dtypes=DTYPES, seed: int = 0,
                 iters: int = 20) -> list:
    from repro_torch.dispatch import device_time_us
    from repro_torch.kernels.conv_gemm import conv2d_fused_cuda
    from repro_torch.kernels.im2col_pack import im2col_pack_cuda, out_size

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    recs = []

    def us_of(fn):
        return device_time_us(fn, iters=iters, device=dev)

    for name, c, b, h, w, o, k, stride, pad in convs:
        for dtype in dtypes:
            x, strips, values, idx, w_dense = _strip_problem(
                c, b, h, w, o, k, stride, pad, dtype, dev, rng)
            n_strips, _, v = strips.shape
            n_tiles, k_kept, tile = values.shape
            want = colwise_nm_matmul_strips_scalar_cuda(strips, values, idx)
            old = {"colwise_nm_strips.cu": us_of(
                lambda: colwise_nm_matmul_strips_scalar_cuda(strips, values,
                                                             idx)),
                   "colwise_nm_strips_pipelined.cu": us_of(
                lambda: colwise_nm_matmul_strips_pipelined_scalar_cuda(
                    strips, values, idx, hb=STRIP_HB))}
            matmul_us = us_of(lambda: torch.matmul(w_dense, strips))
            gflop = 2 * o * k_kept * n_strips * v / 1e9
            # the least time the card could take: each kept strip row, the
            # values, the indices and the output moved once, or the FMAs at
            # the dtype's peak (chip_smoke.py's rule), whichever is longer
            isz = strips.element_size()
            n_bytes = (n_strips * torch.unique(idx).numel() * v * isz
                       + values.numel() * isz + idx.numel() * 4
                       + o * n_strips * v * isz)
            n_pos = b * out_size(h, k, stride, pad) * out_size(w, k, stride, pad)
            bound = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e6,
                     "operations": 2 * o * k_kept * n_pos / PEAK_TFLOPS[dtype]
                     / 1e6}
            bound_by = max(bound, key=bound.get)
            tag = str(dtype).replace("torch.", "")
            for entry, hb in (("tiled", 1), ("pipelined_tiled", STRIP_HB)):
                def call(**inst):
                    if hb == 1:
                        return colwise_nm_matmul_strips_tiled_cuda(
                            strips, values, idx, **inst)
                    return colwise_nm_matmul_strips_pipelined_tiled_cuda(
                        strips, values, idx, hb=hb, **inst)

                us = {}
                for label, inst in _instances(strips, values, hb):
                    got = call(**inst)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise RuntimeError(f"{name} {tag} {entry} {label}: "
                                           "not the bits of colwise_nm_strips.cu")
                    us[label] = us_of(lambda: call(**inst))
                geo = strips_tiled_geometry(n_strips, v, n_tiles, k_kept, tile,
                                            strips.element_size(), hb)
                rule = _label(geo["cpt"], geo["lanes"], hb)
                best = min(us, key=us.get)
                rec = {"conv": name, "dtype": tag, "entry": entry, "hb": hb,
                       "n_strips": n_strips, "n_tiles": n_tiles,
                       "k_kept": k_kept, "us": us, "old_us": old,
                       "matmul_us": matmul_us, "rule": rule, "best": best,
                       "gflop": gflop, "bound_us": bound[bound_by],
                       "bound_by": bound_by}
                if name in PLAN_CONVS:
                    geo_args = dict(kh=k, kw=k, stride=stride, pad=pad)

                    def plan():
                        s = im2col_pack_cuda(x, k, k, stride, pad, STRIP_V)
                        if hb == 1:
                            return colwise_nm_matmul_strips_cuda(s, values, idx)
                        return colwise_nm_matmul_strips_pipelined_cuda(
                            s, values, idx, hb=hb)

                    x_nchw = x.permute(1, 0, 2, 3).contiguous()
                    w_oihw = (w_dense.reshape(o, k, k, c).permute(0, 3, 1, 2)
                              .contiguous())
                    rec["plan_us"] = {
                        "im2col_pack": us_of(lambda: im2col_pack_cuda(
                            x, k, k, stride, pad, STRIP_V)),
                        "two_kernel": us_of(plan),
                        "conv2d_fused.cu": us_of(lambda: conv2d_fused_cuda(
                            x, values, idx, v=STRIP_V, **geo_args)),
                        "F.conv2d": us_of(lambda: F.conv2d(
                            x_nchw, w_oihw, stride=stride, padding=pad))}
                recs.append(rec)
                times = " ".join(f"{kk}={t:.2f}" for kk, t in us.items())
                plans = "" if "plan_us" not in rec else "; plan (us) " + " ".join(
                    f"{kk}={t:.2f}" for kk, t in rec["plan_us"].items())
                print(f"{name} {tag} {entry} hb{hb} ({n_strips} strips x "
                      f"{n_tiles} tiles, k_kept {k_kept}): tiled (us) {times}; "
                      f"old (us) " + " ".join(f"{kk}={t:.2f}"
                                              for kk, t in old.items())
                      + f"; torch.matmul {matmul_us:.2f}; bound "
                      f"{bound[bound_by]:.2f} ({bound_by}); rule {rule} "
                      f"({us[rule] / us[best]:.3f}x the best, {best}, "
                      f"{gflop / us[best] * 1e3:.2f} TFLOP/s){plans}; "
                      "bit-identical", flush=True)
    return recs


def summarize_strips(recs) -> None:
    """Per dtype and entry point, each instance's time summed over the five
    resnet-tiny convs, beside the rule's, the old kernels' and
    torch.matmul's."""
    for dtype in sorted({r["dtype"] for r in recs}):
        for entry in ("tiled", "pipelined_tiled"):
            rows = [r for r in recs if r["dtype"] == dtype
                    and r["entry"] == entry
                    and not r["conv"].startswith("resnet18")]
            if len(rows) != 5:
                continue
            insts = set.intersection(*(set(r["us"]) for r in rows))
            sums = {i: sum(r["us"][i] for r in rows) for i in sorted(insts)}
            rule = sum(r["us"][r["rule"]] for r in rows)
            old = {kk: sum(r["old_us"][kk] for r in rows)
                   for kk in rows[0]["old_us"]}
            print(f"SUM resnet-tiny {dtype} {entry}: tiled (us) "
                  + " ".join(f"{i}={t:.2f}" for i, t in sums.items())
                  + f"; rule {rule:.2f}; bound "
                  f"{sum(r['bound_us'] for r in rows):.2f}; old "
                  + " ".join(f"{kk}={t:.2f}" for kk, t in old.items())
                  + f"; torch.matmul {sum(r['matmul_us'] for r in rows):.2f}",
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--only", choices=("linear", "strips"), default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune: no CUDA device; this runs only on the card")
    from repro_torch.kernels import _build

    print(torch.cuda.get_device_name(0), flush=True)
    recs = {}
    if args.only != "strips":
        recs["linear"] = sweep()
    if args.only != "linear":
        for inst, regs, spill in strips_tiled_registers(
                _build.build().parent / "build.log"):
            print(f"colwise_nm_strips_tiled {inst}: {regs} registers, {spill}",
                  flush=True)
        recs["strips"] = sweep_strips()
        summarize_strips(recs["strips"])
    print("TUNE " + json.dumps(recs), flush=True)
    if args.out is not None:
        args.out.write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
