"""Time the tiled flash kernel and the split paged kernel under each of
their instances, the measurements behind
:func:`~repro_torch.kernels.flash_attn.kernel.flash_tiled_config` and
:func:`~repro_torch.kernels.flash_attn.paged.paged_split_config`.

Flash: for each head width D (16, 32, 64, 128) at smollm-360m's scoring
shape (B 4, S 2048, H 15, KV 5, causal), in f32 and bf16, every instance of
``csrc/flash_attention_tiled.cu`` (query rows of a block x rows a thread)
that fits a block's shared memory is checked to give the bits of
``csrc/flash_attention.cu`` (``torch.equal``) and timed by CUDA-graph replay
(the dispatch profiler's timer), beside the other kernel and
``F.scaled_dot_product_attention`` on K/V pre-expanded to 15 heads (TF32
off).

Paged: at the decode step's shape (B 4, Sq 1, H 15, KV 5, D 64, page size
16, lengths 0, 16, 37 and 150 in a 10-page table), the other shapes
``chip_smoke.py`` checks (B 8; Sq 4 with causal new keys; bf16) and
qwen2-0.5b's decode heads (H 14, KV 2: 7 query rows a KV head), every warp
count of ``csrc/paged_attention_split.cu`` that fits is held against the
plain version (``torch.allclose`` within 1e-4 of max|y| in f32, 2e-2 in
bf16) and timed beside ``csrc/paged_attention.cu``, the plain version and
SDPA on K/V pre-gathered to [B, H, n_max * ps + Sq, D].

Prints one line per case, then ``TUNE <json>``; with ``--out PATH`` also
writes the JSON there; ``--seq`` shortens the flash sequence for a quick
check, ``--only flash|paged`` runs one section.  On a machine with the
card, from the repository root:

    PYTHONPATH=src python -m repro_torch.kernels.flash_attn.tune
"""
from __future__ import annotations

import argparse
import json
import re
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
from repro_torch.kernels.flash_attn.paged import (PAGED_SPLIT_WARPS,
                                                  paged_attention_scalar_cuda,
                                                  paged_attention_split_cuda,
                                                  paged_split_config,
                                                  paged_split_smem_bytes,
                                                  paged_split_tile_bound)
from repro_torch.kernels.flash_attn.ref import paged_attention_ref

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


# the paged section: (B, Sq, H, KV, lengths, dtype) at D 64, page size 16,
# a 10-page table; chip_smoke.py's phase-6 cases, then qwen2-0.5b's heads
PAGED_D, PAGED_PS, PAGED_NMAX = 64, 16, 10
PAGED_CASES = [(4, 1, 15, 5, [0, 16, 37, 150], torch.float32),
               (8, 1, 15, 5, [0, 16, 37, 150, 1, 159, 64, 90], torch.float32),
               (4, 4, 15, 5, [31, 0, 16, 100], torch.float32),
               (4, 1, 15, 5, [0, 16, 37, 150], torch.bfloat16),
               (4, 1, 14, 2, [0, 16, 37, 150], torch.float32)]
PAGED_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # of max|y|


def paged_split_registers(log: Path) -> list:
    """(instance, registers, spills) of each paged_attention_split.cu
    instance, from the ``-Xptxas -v`` output the build keeps: instance as
    "f32|bf16 W=w R=r NC=n" (warps, query rows a lane holds, columns a lane
    owns)."""
    out, inst, spill = [], None, ""
    for line in log.read_text().splitlines():
        m = re.search(r"paged_split_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)"
                      r"ELi(\d+)E", line)
        if "Compiling entry function" in line:
            inst = (f"{'f32' if m.group(1) == 'f' else 'bf16'} W={m.group(2)} "
                    f"R={m.group(3)} NC={m.group(4)}") if m else None
        elif inst and "spill" in line:
            spill = line.strip()
        elif inst and "registers" in line:
            out.append((inst, int(re.search(r"Used (\d+) registers", line)
                                  .group(1)), spill))
            inst = None
    return out


def paged_problem(b, sq, lengths, dtype, dev, seed, *, h=15, kv=5,
                  d=PAGED_D, ps=PAGED_PS, n_max=PAGED_NMAX):
    """Paged operands from a seed: random q, new K/V and pages, a shuffled
    page table padded with the trash page (the last physical page), int32
    lengths."""
    rng = np.random.default_rng(seed)
    n_phys = b * n_max + 1

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, dtype)

    q = f(b, sq, h, d)
    kn, vn = f(b, sq, kv, d), f(b, sq, kv, d)
    kp = f(n_phys, ps, kv, d)
    vp = f(n_phys, ps, kv, d)
    pages = rng.permutation(b * n_max).reshape(b, n_max)
    for i, n in enumerate(lengths):
        pages[i, -(-n // ps):] = n_phys - 1
    return (q, kn, vn, kp, vp,
            torch.from_numpy(pages.astype(np.int32)).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def paged_sdpa(args):
    """The SDPA yardstick of a paged call: K/V gathered to [B, H, n_max *
    ps + Sq, D] and the mask built beforehand (not timed); returns the
    call."""
    q, kn, vn, kp, vp, tables, lens = args
    b, sq, h, d = q.shape
    kv, ps = kp.shape[2], kp.shape[1]
    s_c = tables.shape[1] * ps
    dev = q.device

    def heads(cache, new):
        flat = cache[tables.long()].reshape(b, s_c, kv, d)
        return (torch.cat([flat, new], 1).repeat_interleave(h // kv, dim=2)
                .transpose(1, 2).contiguous())

    k_all, v_all = heads(kp, kn), heads(vp, vn)
    qh = q.transpose(1, 2).contiguous()
    cache_ok = (torch.arange(s_c, device=dev)[None, None, :]
                < lens[:, None, None]).expand(b, sq, s_c)
    ar = torch.arange(sq, device=dev)
    new_ok = (ar[None, :] <= ar[:, None])[None].expand(b, sq, sq)
    mask = torch.cat([cache_ok, new_ok], -1)[:, None]
    return lambda: F.scaled_dot_product_attention(qh, k_all, v_all,
                                                  attn_mask=mask)


def paged_sweep(seed: int = 0) -> list:
    """Every warp count of the split kernel over ``PAGED_CASES``, each held
    against the plain version, timed beside the other kernel, the plain
    version and SDPA."""
    from repro_torch.dispatch import device_time_us

    dev = torch.device("cuda")
    recs = []
    for i, (b, sq, h, kv, lengths, dtype) in enumerate(PAGED_CASES):
        args = paged_problem(b, sq, lengths, dtype, dev, seed + i, h=h, kv=kv)
        want = paged_attention_ref(*args).float()
        tol = PAGED_RTOL[dtype] * float(want.abs().max())
        rows = (h // kv) * sq
        tiles = paged_split_tile_bound(PAGED_PS, PAGED_NMAX, sq)
        itemsize = args[0].element_size()
        us, err = {}, {}
        for warps in PAGED_SPLIT_WARPS:
            if paged_split_smem_bytes(PAGED_PS, PAGED_D, rows, itemsize,
                                      warps, tiles) > SMEM_BYTES:
                continue
            got = paged_attention_split_cuda(*args, page_size=PAGED_PS,
                                             warps=warps)
            torch.cuda.synchronize()
            if not torch.allclose(got.float(), want, rtol=0, atol=tol):
                raise RuntimeError(
                    f"case {i} warps {warps}: max err "
                    f"{float((got.float() - want).abs().max())} > {tol}")
            err[warps] = float((got.float() - want).abs().max())
            us[warps] = device_time_us(
                lambda: paged_attention_split_cuda(*args, page_size=PAGED_PS,
                                                   warps=warps),
                iters=20, device=dev)
        old = paged_attention_scalar_cuda(*args, page_size=PAGED_PS)
        torch.cuda.synchronize()
        if not torch.allclose(old.float(), want, rtol=0, atol=tol):
            raise RuntimeError(f"case {i}: paged_attention.cu off the plain "
                               "version")
        old_us = device_time_us(
            lambda: paged_attention_scalar_cuda(*args, page_size=PAGED_PS),
            iters=20, device=dev)
        plain_us = device_time_us(lambda: paged_attention_ref(*args),
                                  iters=5, device=dev)
        sdpa_us = device_time_us(paged_sdpa(args), iters=20, device=dev)
        pick = paged_split_config(PAGED_PS, PAGED_D, rows, tiles, dtype)[0]
        best = min(us, key=us.get)
        dt = str(dtype).replace("torch.", "")
        recs.append({"b": b, "sq": sq, "h": h, "kv": kv, "lengths": lengths,
                     "dtype": dt, "us": {f"W{w}": x for w, x in us.items()},
                     "max_abs_err": {f"W{w}": x for w, x in err.items()},
                     "old_us": old_us, "plain_us": plain_us,
                     "sdpa_us": sdpa_us, "rule": f"W{pick}",
                     "best": f"W{best}"})
        print(f"paged B={b} Sq={sq} H={h} KV={kv} lengths={lengths} {dt}: "
              + " ".join(f"W{w}={x:.2f}us" for w, x in us.items())
              + f"; paged_attention.cu {old_us:.2f}us, plain {plain_us:.2f}"
              f"us, SDPA {sdpa_us:.2f}us; rule W{pick} ({us[pick] / us[best]:.3f}x "
              f"the best, W{best}); max err {max(err.values()):.3e} <= "
              f"{tol:.3e}", flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--seq", type=int, default=S)
    ap.add_argument("--only", choices=("flash", "paged"), default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune: no CUDA device; this runs only on the card")
    from repro_torch.kernels import _build

    print(torch.cuda.get_device_name(0), flush=True)
    recs = {}
    if args.only != "paged":
        recs["flash"] = sweep(seq=args.seq)
    if args.only != "flash":
        for inst, regs, spill in paged_split_registers(
                _build.build().parent / "build.log"):
            print(f"paged_attention_split {inst}: {regs} registers, {spill}",
                  flush=True)
        recs["paged"] = paged_sweep()
    print("TUNE " + json.dumps(recs), flush=True)
    if args.out is not None:
        args.out.write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
