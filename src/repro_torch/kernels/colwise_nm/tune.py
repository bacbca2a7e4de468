"""Time the tiled sparse linear kernel under each rows-per-block choice, the
measurement behind :func:`~repro_torch.kernels.colwise_nm.kernel.tiled_block_rows`.

For each of smollm-360m's four linear shapes (q/o 960->960, k/v 960->320,
gate/up 960->2560, down 2560->960; 50% kept, T = d_out, f32) and each row
count, every block size of the kernel is timed by CUDA-graph replay (the
dispatch profiler's timer) and checked to give the same bits as the rule's
pick.  Prints one line per shape and row count, then ``TUNE <json>``; with
``--out PATH`` also writes the JSON there.  On a machine with the card,
from the repository root:

    PYTHONPATH=src python -m repro_torch.kernels.colwise_nm.tune
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.colwise_nm.kernel import (TILED_BLOCK_ROWS,
                                                   colwise_nm_matmul_tiled_cuda,
                                                   tiled_block_rows)

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune: no CUDA device; this runs only on the card")
    print(torch.cuda.get_device_name(0), flush=True)
    recs = sweep()
    print("TUNE " + json.dumps(recs), flush=True)
    if args.out is not None:
        args.out.write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
