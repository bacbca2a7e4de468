"""Time the tiled im2col + pack under each of its instances: the measurements
behind :func:`~repro_torch.kernels.im2col_pack.kernel.im2col_tiled_config`.

For resnet-tiny's five pruned convs (batch 256) and ResNet-18's layer1-4 3x3
convs at batch 8 (64 -> 56x56, 128 -> 28x28, 256 -> 14x14, 512 -> 7x7), in
f32 and bf16, at strip widths 128 and 256 (the conv families' widths), every
instance of ``csrc/im2col_pack_tiled.cu`` (channels a block, taps a block,
channels a thread loads before it stores) is checked to give the bits of
``csrc/im2col_pack.cu`` (``torch.equal`` on the element bits) and timed by
CUDA-graph replay (the dispatch profiler's timer, L2 warm), beside
``im2col_pack.cu``, ``F.unfold`` on the NCHW map and the bytes bound (each
map element the taps touch read once, the strips written once, at 3.35
TB/s).  The rule's pick and ``im2col_pack.cu`` are also timed with L2
flushed before each call (a 128 MiB buffer written between calls, its own
time taken off).  Prints one line per conv, dtype and width, then the five
resnet-tiny convs summed per instance and for the rule's pick.

Prints the registers and spills of the kernel's instances (``-Xptxas -v``)
first and ``TUNE <json>`` last; with ``--out PATH`` it also writes the JSON
there.  On a machine with the card, from the repository root:

    PYTHONPATH=src python -m repro_torch.kernels.im2col_pack.tune
"""
from __future__ import annotations

import argparse
import itertools
import json
import re
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.im2col_pack.kernel import (IM2COL_TILED_CBS,
                                                    IM2COL_TILED_TGS,
                                                    IM2COL_TILED_UNROLLS,
                                                    im2col_pack_scalar_cuda,
                                                    im2col_pack_tiled_cuda,
                                                    im2col_tiled_config,
                                                    im2col_tiled_geometry)
from repro_torch.roofline.kernels import pack_bytes

# (name, C, B, H, W, k, stride, pad): resnet-tiny's pruned convs at batch 256
# (configs/resnet_tiny.py), then ResNet-18's layer1-4 3x3 convs at batch 8
CONVS = (("blocks[0]/conv1", 8, 256, 16, 16, 3, 1, 1),
         ("blocks[0]/conv2", 16, 256, 16, 16, 3, 1, 1),
         ("blocks[1]/conv1", 16, 256, 16, 16, 3, 2, 1),
         ("blocks[1]/conv2", 16, 256, 8, 8, 3, 1, 1),
         ("blocks[1]/proj", 16, 256, 16, 16, 1, 2, 0),
         ("resnet18/layer1", 64, 8, 56, 56, 3, 1, 1),
         ("resnet18/layer2", 128, 8, 28, 28, 3, 1, 1),
         ("resnet18/layer3", 256, 8, 14, 14, 3, 1, 1),
         ("resnet18/layer4", 512, 8, 7, 7, 3, 1, 1))
WIDTHS = (128, 256)  # dispatch/registry.py's strip widths
DTYPES = (torch.float32, torch.bfloat16)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (chip_smoke.py's bound)
FLUSH_BYTES = 128 << 20  # written between calls to flush the 50 MB L2


def tiled_registers(log: Path) -> list:
    """(instance, registers, spills) of each im2col_pack_tiled.cu instance,
    from the ``-Xptxas -v`` output the build keeps: instance as "f32|bf16
    U=u" (channels a thread loads before it stores)."""
    out, inst, spill = [], None, ""
    for line in log.read_text().splitlines():
        m = re.search(r"im2col_pack_tiled_kernelI(j|t)Li(\d+)EE", line)
        if "Compiling entry function" in line:
            inst = (f"{'f32' if m.group(1) == 'j' else 'bf16'} "
                    f"U={m.group(2)}") if m else None
        elif inst and "spill" in line:
            spill = line.strip()
        elif inst and "registers" in line:
            out.append((inst, int(re.search(r"Used (\d+) registers", line)
                                  .group(1)), spill))
            inst = None
    return out


def cold_us(fn, dev, iters: int = 10) -> float:
    """Device time of one ``fn()`` with L2 flushed before it: graph replays
    of ``iters`` (flush, call) pairs less those of ``iters`` flushes alone,
    a flush writing ``FLUSH_BYTES``."""
    from repro_torch.dispatch import device_time_us

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def both():
        flush.fill_(0.0)
        fn()

    return (device_time_us(both, iters=iters, device=dev)
            - device_time_us(lambda: flush.fill_(0.0), iters=iters, device=dev))


def _label(cb, tg, unroll):
    return f"cb={cb} tg={tg} U={unroll}"


def sweep(convs=CONVS, widths=WIDTHS, dtypes=DTYPES, seed: int = 0,
          iters: int = 20) -> list:
    from repro_torch.dispatch import device_time_us

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)

    def us_of(fn):
        return device_time_us(fn, iters=iters, device=dev)

    recs = []
    for name, c, b, h, w, k, stride, pad in convs:
        for dtype in dtypes:
            x = torch.from_numpy(rng.standard_normal((c, b, h, w),
                                                     dtype=np.float32))
            x = x.to(dev, dtype)
            isz = x.element_size()
            ints = torch.int32 if isz == 4 else torch.int16
            x_nchw = x.permute(1, 0, 2, 3).contiguous()
            unfold_us = us_of(lambda: F.unfold(x_nchw, (k, k), padding=pad,
                                               stride=stride))
            for v in widths:
                args = (x, k, k, stride, pad, v)
                want = im2col_pack_scalar_cuda(*args).view(ints)
                old_us = us_of(lambda: im2col_pack_scalar_cuda(*args))
                us = {}
                for inst in itertools.product(IM2COL_TILED_CBS,
                                              IM2COL_TILED_TGS,
                                              IM2COL_TILED_UNROLLS):
                    cb, tg, unroll = inst
                    if im2col_tiled_geometry(c, b, h, w, k, k, stride, pad, v,
                                             isz, cb=cb, tg=tg,
                                             unroll=unroll) is None:
                        continue
                    call = lambda: im2col_pack_tiled_cuda(  # noqa: E731
                        *args, cb=cb, tg=tg, unroll=unroll)
                    got = call()
                    torch.cuda.synchronize()
                    if not torch.equal(got.view(ints), want):
                        raise RuntimeError(f"{name} {dtype} v{v} "
                                           f"{_label(*inst)}: not the bits "
                                           "of im2col_pack.cu")
                    us[_label(*inst)] = us_of(call)
                config = im2col_tiled_config(c, b, h, w, k, k, stride, pad, v,
                                             isz)
                pick = _label(*config)
                best = min(us, key=us.get)
                bound_us = pack_bytes(c, b, h, w, k, stride, pad, v,
                                      isz) / HBM_BYTES_PER_S * 1e6
                cold = {"rule": cold_us(lambda: im2col_pack_tiled_cuda(*args),
                                        dev),
                        "scalar": cold_us(lambda: im2col_pack_scalar_cuda(*args),
                                          dev)}
                geo = im2col_tiled_geometry(c, b, h, w, k, k, stride, pad, v,
                                            isz)
                rec = {"conv": name, "dtype": str(dtype).replace("torch.", ""),
                       "v": v, "tiled_us": us, "scalar_us": old_us,
                       "unfold_us": unfold_us, "bound_us": bound_us,
                       "rule": pick, "best": best, "cold_us": cold,
                       "blocks": geo["blocks"], "threads": geo["threads"]}
                recs.append(rec)
                print(f"pack {name} {rec['dtype']} v{v}: tiled (us) "
                      + " ".join(f"{kk}={t:.2f}" for kk, t in us.items())
                      + f"; rule {pick} {us[pick]:.2f} ({us[pick] / us[best]:.3f}x"
                      f" the best, {best}; {geo['blocks']} blocks of "
                      f"{geo['threads']}); im2col_pack.cu {old_us:.2f}; "
                      f"F.unfold {unfold_us:.2f}; bound {bound_us:.2f} (bytes); "
                      f"L2 flushed: rule {cold['rule']:.2f}, im2col_pack.cu "
                      f"{cold['scalar']:.2f}; bit-identical", flush=True)
    return recs


def summarize(recs) -> None:
    """Per dtype and width, each instance's time summed over the five
    resnet-tiny convs and the rule's pick, beside im2col_pack.cu, F.unfold
    and the bound."""
    for dtype in sorted({r["dtype"] for r in recs}):
        for v in WIDTHS:
            rows = [r for r in recs if r["dtype"] == dtype and r["v"] == v
                    and not r["conv"].startswith("resnet18")]
            if len(rows) != 5:
                continue
            insts = set.intersection(*(set(r["tiled_us"]) for r in rows))
            sums = {i: sum(r["tiled_us"][i] for r in rows) for i in sorted(insts)}

            def total(key):
                return sum(r[key] for r in rows)

            print(f"SUM pack resnet-tiny {dtype} v{v}: tiled (us) "
                  + " ".join(f"{i}={t:.2f}" for i, t in sums.items())
                  + f"; rule {sum(r['tiled_us'][r['rule']] for r in rows):.2f}"
                  f"; best per conv "
                  f"{sum(min(r['tiled_us'].values()) for r in rows):.2f}; "
                  f"im2col_pack.cu {total('scalar_us'):.2f}; F.unfold "
                  f"{total('unfold_us'):.2f}; bound {total('bound_us'):.2f}; L2 "
                  f"flushed: rule {sum(r['cold_us']['rule'] for r in rows):.2f}"
                  f", im2col_pack.cu "
                  f"{sum(r['cold_us']['scalar'] for r in rows):.2f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune: no CUDA device; this runs only on the card")
    from repro_torch.kernels import _build

    print(torch.cuda.get_device_name(0), flush=True)
    log = _build.build().parent / "build.log"
    for inst, regs, spill in tiled_registers(log):
        print(f"im2col_pack_tiled {inst}: {regs} registers, {spill}", flush=True)
    recs = sweep()
    summarize(recs)
    print("TUNE " + json.dumps(recs), flush=True)
    if args.out is not None:
        args.out.write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
