#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Phases:
  1. card   : name and power limit (nvidia-smi); TF32 off for the references
  2. build  : the hand-written kernels from src/repro_torch/csrc (nvcc)
  3. kernels: each kernel against its plain PyTorch version at the five
              pruned-conv shapes of resnet-tiny at batch 256 (f32) and one
              bf16 case; kernel, plain-version and library-call times beside
              each kernel's bound
  4. main   : pruned resnet-tiny inference through ``vision_apply`` under
              both conv plans, with the launch counts, the logits held against
              a dense reference on the card, the masked -> compressed tree
              check, and the forward time
  5. report : one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
              line last

Run from the repository root:  python3 chip_smoke.py
Any failed check raises, so the script exits non-zero and prints no ok line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # non-tensor f32; bf16
BATCH = 256
N_BATCHES = 3
F32_RTOL = 1e-4   # of max|y|: the same sums taken in another order
BF16_RTOL = 2e-2  # of max|y|: one bf16 rounding of the output, other sum order
SEED = 0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _events_ms(run, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph and replayed between CUDA events, so the host's launch cost is
    not in it.  L2 stays warm, as it is between the layers of a forward."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as CUDA graphs need
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(graph.replay, iters)
    del graph
    return ms


def eager_ms(fn, iters: int = 20) -> float:
    """Time of one call of ``fn`` issued eagerly from Python, back to back:
    the host's launch cost included (what an eager forward pays)."""
    def run():
        for _ in range(iters):
            fn()  # each output dies at once, as a layer's input does

    fn()
    torch.cuda.synchronize()
    return _events_ms(run, iters)


def touched_elems(shape, kh, kw, stride, pad, rows, device) -> int:
    """Distinct map elements that output positions read through im2col
    rows ``rows`` ((kh, kw, c)-flattened): what the work needs from x."""
    from repro_torch.kernels.im2col_pack import out_size, tap_coords

    c, b, h, w = shape
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    p = torch.arange(b * ho * wo, device=device)
    mark = torch.zeros(c * b * h * w, dtype=torch.bool, device=device)
    rows = rows.long()
    for tap in torch.unique(rows // c).tolist():
        chans = torch.unique(rows[rows // c == tap] % c)
        valid, bc, ihc, iwc = tap_coords(
            p, ikh=tap // kw, ikw=tap % kw, stride=stride, pad=pad, b=b, h=h,
            w=w, ho=ho, wo=wo)
        pos = ((bc * h + ihc) * w + iwc)[valid]
        mark[(chans[:, None] * (b * h * w) + pos[None, :]).reshape(-1)] = True
    return int(mark.sum())


def bound_ms(n_bytes: int, flops: int, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_convs(params, cfg):
    """(name, layer params, C, H, W, kh, kw, stride, pad) of every
    compressed conv in forward order, with the map shape it sees."""
    from repro_torch.kernels.im2col_pack import out_size
    from repro_torch.models.vision import _block_strides

    out = []
    h, w = cfg.image_hw
    for i, (block, (_si, _bi, stride, c_in, c_out)) in enumerate(
            zip(params["blocks"], _block_strides(cfg))):
        ho, wo = out_size(h, 3, stride, 1), out_size(w, 3, stride, 1)
        for name, c, hh, ww, k, s, p in (("conv1", c_in, h, w, 3, stride, 1),
                                         ("conv2", c_out, ho, wo, 3, 1, 1),
                                         ("proj", c_in, h, w, 1, stride, 0)):
            layer = block.get(name)
            if layer is not None and "values" in layer:
                out.append((f"blocks[{i}]/{name}", layer, c, hh, ww, k, k, s, p))
        h, w = ho, wo
    return out


def check_kernels(params, cfg, dev):
    """Phase 3: every kernel against its plain version at the main path's
    shapes; returns per-kernel sums over the five f32 convs."""
    from repro_torch.kernels.colwise_nm import (
        colwise_nm_matmul_strips_cuda, colwise_nm_matmul_strips_ref)
    from repro_torch.kernels.conv_gemm import (
        conv2d_fused_cuda, conv2d_fused_ref)
    from repro_torch.kernels.im2col_pack import (
        im2col_pack_cuda, im2col_pack_ref, out_size)
    from repro_torch.core.formats import ColwiseMeta, unpack_colwise

    rng = np.random.default_rng(SEED)
    keys = ("ms", "eager_ms", "plain_ms", "bound_ms", "library_ms")
    tot = {k: {m: 0.0 for m in keys} | {"max_abs_err": 0.0, "bound_by": {}}
           for k in ("conv2d_fused", "im2col_pack", "colwise_nm_matmul_strips")}
    cases = [(*conv, torch.float32) for conv in main_path_convs(params, cfg)]
    cases.append((*cases[1][:-1], torch.bfloat16))
    check(len(cases) == 6, f"expected 5 pruned convs, got {len(cases) - 1}")
    for name, layer, c, h, w, kh, kw, stride, pad, dtype in cases:
        x = torch.from_numpy(rng.standard_normal((c, BATCH, h, w),
                                                 dtype=np.float32))
        x = x.to(dev, dtype)
        values, idx = layer["values"].to(dtype), layer["idx"]
        n_tiles, k_kept, tile = values.shape
        o, k_rows = n_tiles * tile, kh * kw * c
        ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
        n_pos = BATCH * ho * wo
        isz = x.element_size()
        geo = dict(kh=kh, kw=kw, stride=stride, pad=pad)
        rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
        tag = f"{name} {str(dtype).replace('torch.', '')} C={c} {h}x{w} " \
              f"k{kh} s{stride} p{pad} k_kept={k_kept}"
        w_dense = unpack_colwise(values, idx, ColwiseMeta(
            k_rows, o, tile, k_rows, k_kept)).T.contiguous()  # [O, K]
        w_oihw = w_dense.reshape(o, kh, kw, c).permute(0, 3, 1, 2).contiguous()
        x_nchw = x.permute(1, 0, 2, 3).contiguous()
        idx_bytes = idx.numel() * idx.element_size()
        w_bytes = values.numel() * isz + idx_bytes
        flops = 2 * o * k_kept * n_pos
        kept_rows = torch.unique(idx)

        # fused conv
        y_k = conv2d_fused_cuda(x, values, idx, **geo)
        y_p = conv2d_fused_ref(x, values, idx, **geo)
        torch.cuda.synchronize()
        err = float((y_k.float() - y_p.float()).abs().max())
        scale = float(y_p.float().abs().max())
        check(bool(torch.isfinite(y_k).all()), f"conv2d_fused {tag}: non-finite")
        check(err <= rtol * scale, f"conv2d_fused {tag}: err {err} > "
              f"{rtol} * {scale}")
        nb = (touched_elems(x.shape, kh, kw, stride, pad, kept_rows, dev) * isz
              + w_bytes + y_k.numel() * isz)
        r = measure(lambda: conv2d_fused_cuda(x, values, idx, **geo),
                    lambda: conv2d_fused_ref(x, values, idx, **geo),
                    lambda: F.conv2d(x_nchw, w_oihw, stride=stride,
                                     padding=pad))
        r["bound_ms"], by = bound_ms(nb, flops, dtype)
        report(tot, "conv2d_fused", tag, r, by, err, scale, dtype)

        # im2col + pack: exact copy
        s_k = im2col_pack_cuda(x, kh, kw, stride, pad, 128)
        s_p = im2col_pack_ref(x, kh, kw, stride, pad, 128)
        torch.cuda.synchronize()
        check(torch.equal(s_k, s_p), f"im2col_pack {tag}: not bit-exact")
        all_rows = torch.arange(k_rows, device=dev)
        nb = (touched_elems(x.shape, kh, kw, stride, pad, all_rows, dev) * isz
              + s_k.numel() * isz)
        r = measure(lambda: im2col_pack_cuda(x, kh, kw, stride, pad, 128),
                    lambda: im2col_pack_ref(x, kh, kw, stride, pad, 128),
                    lambda: F.unfold(x_nchw, (kh, kw), padding=pad,
                                     stride=stride))
        r["bound_ms"], by = bound_ms(nb, 0, dtype)
        report(tot, "im2col_pack", tag, r, by, 0.0, 1.0, dtype)

        # strip-major sparse GEMM on the packed strips
        g_k = colwise_nm_matmul_strips_cuda(s_p, values, idx)
        g_p = colwise_nm_matmul_strips_ref(s_p, values, idx)
        torch.cuda.synchronize()
        err = float((g_k.float() - g_p.float()).abs().max())
        scale = float(g_p.float().abs().max())
        check(bool(torch.isfinite(g_k).all()),
              f"colwise_nm_matmul_strips {tag}: non-finite")
        check(err <= rtol * scale, f"colwise_nm_matmul_strips {tag}: err "
              f"{err} > {rtol} * {scale}")
        n_strips = s_p.shape[0]
        nb = (n_strips * kept_rows.numel() * 128 * isz + w_bytes
              + g_k.numel() * isz)
        r = measure(lambda: colwise_nm_matmul_strips_cuda(s_p, values, idx),
                    lambda: colwise_nm_matmul_strips_ref(s_p, values, idx),
                    lambda: torch.matmul(w_dense, s_p))
        r["bound_ms"], by = bound_ms(nb, flops, dtype)
        report(tot, "colwise_nm_matmul_strips", tag, r, by, err, scale, dtype)
    return tot


# The one PyTorch call timed beside each kernel (never called by the port),
# and how its layout differs from the kernel's.
LIBRARY_CALLS = {
    "conv2d_fused": "F.conv2d on the dense masked weight (cuDNN, TF32 off); "
                    "NCHW in and out instead of CNHW in, [O, S*V] out",
    "im2col_pack": "F.unfold on NCHW; rows (c, kh, kw) instead of (kh, kw, c), "
                   "batch-leading [B, K, L], no V-wide strips",
    "colwise_nm_matmul_strips": "torch.matmul of the dense masked [O, K] "
                                "weight by the [S, K, V] strips; every K row "
                                "instead of the kept ones, out [S, O, V]",
}


def measure(kernel_fn, plain_fn, library_fn) -> dict:
    """Device times (CUDA graph replay) of the kernel, its plain version and
    the library yardstick, and the kernel's eager per-call time."""
    return {"ms": time_ms(kernel_fn), "eager_ms": eager_ms(kernel_fn),
            "plain_ms": time_ms(plain_fn, iters=5),
            "library_ms": time_ms(library_fn)}


def report(tot, kernel, tag, r, by, err, scale, dtype):
    print(f"  {kernel:26s} {tag}: ms={r['ms']:.5f} eager_ms={r['eager_ms']:.5f}"
          f" plain_ms={r['plain_ms']:.5f} library_ms={r['library_ms']:.5f}"
          f" bound_ms={r['bound_ms']:.6f} ({by}) max_abs_err={err:.3e}"
          f" (max|y|={scale:.3e})", flush=True)
    if dtype != torch.float32:
        return  # the kernel list sums the five f32 main-path convs
    for k in ("ms", "eager_ms", "plain_ms", "bound_ms", "library_ms"):
        tot[kernel][k] += r[k]
    tot[kernel]["max_abs_err"] = max(tot[kernel]["max_abs_err"], err)
    by_ms = tot[kernel]["bound_by"]  # bound time by what bounds it
    by_ms[by] = by_ms.get(by, 0.0) + r["bound_ms"]


def dense_reference(params):
    """The same network with every compressed conv unpacked to its dense
    masked OHWI weight: a forward that runs no kernel of the port."""
    from repro_torch.core.formats import ColwiseMeta, unpack_colwise

    def walk(t):
        if isinstance(t, dict):
            if "values" in t:
                kh, kw, c = (int(v) for v in t["conv_geom"].tolist())
                n_tiles, k_kept, tile = t["values"].shape
                o, k_rows = n_tiles * tile, kh * kw * c
                w = unpack_colwise(t["values"], t["idx"], ColwiseMeta(
                    k_rows, o, tile, k_rows, k_kept))
                return {"w": w.T.reshape(o, kh, kw, c).contiguous()}
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t

    return walk(params)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def run_main_path(params, cfg, dev):
    """Phase 4: pruned resnet-tiny inference through ``vision_apply``."""
    from repro_torch.core.sparse_conv import compress_conv_tree
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.models.vision import (synth_batch, vision_accuracy,
                                           vision_apply, vision_init)

    two = "im2col_sparse_pallas"
    batches = [synth_batch(cfg, SEED + 1 + i, BATCH, device=dev)
               for i in range(N_BATCHES)]
    counts = {}
    logits = {}
    for plan in (None, two):
        vision_apply(params, cfg, batches[0][0], impl=plan)  # warm
        torch.cuda.synchronize()
        reset_launch_counts()
        logits[plan] = [vision_apply(params, cfg, x, impl=plan)
                        for x, _ in batches]
        torch.cuda.synchronize()
        counts[plan] = {k.name: k.launches for k in KERNELS}
        print(f"  plan {plan or 'default (fused)'}: launches over "
              f"{N_BATCHES} forwards = {counts[plan]}", flush=True)
    n = 5 * N_BATCHES
    check(counts[None] == {"conv2d_fused": n, "im2col_pack": 0,
                           "colwise_nm_matmul_strips": 0},
          f"default plan launches {counts[None]}")
    check(counts[two] == {"conv2d_fused": 0, "im2col_pack": n,
                          "colwise_nm_matmul_strips": n},
          f"two-kernel plan launches {counts[two]}")

    # two plain paths: cuDNN on the unpacked weights on the card (no port
    # kernel), and the port's own plain versions on the CPU
    ref_params = dense_reference(params)
    cpu_params = tree_to(params, torch.device("cpu"))
    for i, (x, _labels) in enumerate(batches):
        refs = {"dense reference on the card": vision_apply(ref_params, cfg, x),
                "plain versions on the CPU":
                    vision_apply(cpu_params, cfg, x.cpu()).to(dev)}
        errs = []
        for plan in (None, two):
            y = logits[plan][i]
            check(tuple(y.shape) == (BATCH, cfg.num_classes),
                  f"logits shape {tuple(y.shape)}")
            check(bool(torch.isfinite(y).all()), "non-finite logits")
            for name, ref in refs.items():
                e = rel_err(y, ref)
                check(e <= F32_RTOL, f"plan {plan} vs {name}: {e}")
                errs.append(f"{plan or 'fused'} vs {name} {e:.3e}")
        e_plans = rel_err(logits[None][i], logits[two][i])
        check(e_plans <= F32_RTOL, f"fused vs two-kernel logits: {e_plans}")
        print(f"  batch {i}: rel err of the logits: " + "; ".join(errs)
              + f"; the two plans agree to {e_plans:.3e}", flush=True)

    cfg_m = cfg.with_(sparsity=cfg.sparsity.with_(format="masked"))
    masked = vision_init(cfg_m, SEED + 7, device=dev)
    packed = compress_conv_tree(masked, cfg.sparsity)
    x = batches[0][0]
    e = rel_err(vision_apply(packed, cfg, x), vision_apply(masked, cfg_m, x))
    check(e <= F32_RTOL, f"compressed vs masked forward: {e}")
    print(f"  masked -> compress_conv_tree: compressed vs masked forward "
          f"rel err = {e:.3e}", flush=True)

    acc = vision_accuracy(params, cfg, *batches[0])
    timing = {}
    for plan in (None, two, None, two):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            for x, _ in batches:
                vision_apply(params, cfg, x, impl=plan)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (10 * N_BATCHES)
        timing[plan] = min(ms, timing.get(plan, float("inf")))
    x = batches[0][0]
    for plan, ms in timing.items():
        dev_ms = time_ms(lambda: vision_apply(params, cfg, x, impl=plan),
                         iters=10)
        print(f"  forward, plan {plan or 'default (fused)'}: {ms:.4f} ms per "
              f"batch of {BATCH} ({BATCH / ms * 1e3:.1f} images/s; host clock "
              f"with synchronize, best of 2 runs of {10 * N_BATCHES}); device "
              f"time {dev_ms:.4f} ms (CUDA graph replay), device idle share of "
              f"the eager forward {max(0.0, 1 - dev_ms / ms):.3f}", flush=True)
    ref_ms = time_ms(lambda: vision_apply(ref_params, cfg, x), iters=10)
    print(f"  forward of the dense reference (cuDNN F.conv2d on the unpacked "
          f"weights): device time {ref_ms:.4f} ms (CUDA graph replay)",
          flush=True)
    print(f"  accuracy of the random-weight model on batch 0: {acc:.3f} "
          f"(chance is {1 / cfg.num_classes:.3f})", flush=True)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch._compat import is_hopper
    from repro_torch.configs import get_vision_config
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.models.vision import vision_init

    print("== 1. card", flush=True)
    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("  TF32 off for cuDNN and matmul (references in full float32)")
    dev = torch.device("cuda")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}", flush=True)
    check(is_hopper(), "the kernels are built for sm_90a: a Hopper card")

    print("== 2. build", flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"  built {lib.relative_to(ROOT)} from "
          f"{_build.CSRC.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in (lib.parent / "build.log").read_text().splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)

    cfg = get_vision_config("resnet-tiny")
    params = vision_init(cfg, SEED, device=dev)

    print(f"== 3. kernels at the main path's shapes (batch {BATCH})", flush=True)
    for name, call in LIBRARY_CALLS.items():
        print(f"  library_ms of {name}: {call}", flush=True)
    tot = check_kernels(params, cfg, dev)

    print(f"== 4. main path: resnet-tiny inference, batch {BATCH}", flush=True)
    counts = run_main_path(params, cfg, dev)

    print("== 5. report", flush=True)
    launches = {"conv2d_fused": counts[None]["conv2d_fused"],
                "im2col_pack": counts["im2col_sparse_pallas"]["im2col_pack"],
                "colwise_nm_matmul_strips":
                    counts["im2col_sparse_pallas"]["colwise_nm_matmul_strips"]}
    kernels = []
    for k in KERNELS:
        t = tot[k.name]
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": max(t["bound_by"], key=t["bound_by"].get),
            "library_ms": t["library_ms"], "library_call": LIBRARY_CALLS[k.name],
            "eager_ms": t["eager_ms"],
            "per": "sum over the 5 pruned convs of one batch-256 forward",
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
