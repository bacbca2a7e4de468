#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Phases:
  1. card   : name and power limit (nvidia-smi); TF32 off for the references
  2. build  : the hand-written kernels from src/repro_torch/csrc (nvcc, one
              process per source, all started together)
  3. kernels: each kernel against its plain PyTorch version at the main
              path's shapes: the five pruned-conv shapes of resnet-tiny at
              batch 256 (f32, and one bf16 case) for the conv kernels, and
              smollm-360m's MLP widths (960 -> 2560, 2560 -> 960) at 256
              rows for the sparse linear kernel; kernel, plain-version and
              library-call times beside each kernel's bound
  4. main   : pruned resnet-tiny inference through ``vision_apply`` at batch
              256: (a) the default plan with an empty profile DB, (b) the
              plan ``plan_params(profile=True)`` races on the card, with every
              candidate's device time per layer, profiled again to see
              whether the winners hold, (c) the forward forced under each
              conv family; launch counts, logits held against a dense
              reference, the masked -> compressed tree check, forward times,
              and the host cost of the dispatch lookup per conv call
  5. linear : compressed linear layers (serving's sparsity config, tile 8
              and tile 12) through ``linear_apply``'s dispatch, by the
              heuristic and by a profile, against the plain version
  6. report : one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
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
HB = 2  # strips per band / per block: the banded and pipelined default geometry
LINEAR_ROWS = 256
# (d_in, d_out, tile, dtype): smollm-360m's MLP widths under serving's
# SparsityConfig(tile=None), so T = d_out; then tile 8, and bf16
LINEAR_CASES = [(960, 2560, None, torch.float32), (2560, 960, None, torch.float32),
                (960, 2560, 8, torch.float32), (960, 2560, None, torch.bfloat16)]
# (d_in, d_out, tile) of the dispatch phase: the f32 cases above, and a tile
# that is not a multiple of the kernels' 8-row register block
DISPATCH_LINEAR_CASES = [(960, 2560, None), (2560, 960, None), (960, 2560, 8),
                         (960, 2400, 12)]
N_PROFILES = 3  # profiles of the main path, to see whether the winners hold
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
    """Device time of one call of ``fn`` by the profiler's own timer:
    ``iters`` calls captured in a CUDA graph, the median of three replays
    between CUDA events, so the host's launch cost is not in it.  L2 stays
    warm, as it is between the layers of a forward."""
    from repro_torch.dispatch import device_time_us

    return device_time_us(fn, iters=iters, device=torch.device("cuda")) / 1e3


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
    """Phase 3, conv kernels: each against its plain version at the main
    path's shapes; returns per-kernel sums over the five f32 convs."""
    from repro_torch.kernels.colwise_nm import (
        colwise_nm_matmul_strips_cuda, colwise_nm_matmul_strips_pipelined_cuda,
        colwise_nm_matmul_strips_pipelined_ref, colwise_nm_matmul_strips_ref)
    from repro_torch.kernels.conv_gemm import (
        conv2d_fused_banded_cuda, conv2d_fused_banded_ref, conv2d_fused_cuda,
        conv2d_fused_ref)
    from repro_torch.kernels.im2col_pack import (
        im2col_pack_cuda, im2col_pack_ref, out_size)
    from repro_torch.core.formats import ColwiseMeta, unpack_colwise

    rng = np.random.default_rng(SEED)
    tot = {}
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
        conv_bytes = (touched_elems(x.shape, kh, kw, stride, pad, kept_rows, dev)
                      * isz + w_bytes + o * n_pos * isz)
        library_conv = lambda: F.conv2d(x_nchw, w_oihw, stride=stride,  # noqa: E731
                                        padding=pad)

        # fused conv, and the banded one, which must give the same bits
        y_k = conv2d_fused_cuda(x, values, idx, **geo)
        y_p = conv2d_fused_ref(x, values, idx, **geo)
        err = max_err(y_k, y_p, f"conv2d_fused {tag}", rtol)
        r = measure(lambda: conv2d_fused_cuda(x, values, idx, **geo),
                    lambda: conv2d_fused_ref(x, values, idx, **geo),
                    library_conv)
        r["bound_ms"], by = bound_ms(conv_bytes, flops, dtype)
        report(tot, "conv2d_fused", tag, r, by, err, dtype)

        y_b = conv2d_fused_banded_cuda(x, values, idx, hb=HB, **geo)
        err = max_err(y_b, conv2d_fused_banded_ref(x, values, idx, hb=HB, **geo),
                      f"conv2d_fused_banded {tag}", rtol)
        check(torch.equal(y_b, y_k), f"conv2d_fused_banded {tag}: not "
              "bit-identical to conv2d_fused")
        r = measure(lambda: conv2d_fused_banded_cuda(x, values, idx, hb=HB, **geo),
                    lambda: conv2d_fused_banded_ref(x, values, idx, hb=HB, **geo),
                    library_conv)
        r["bound_ms"], by = bound_ms(conv_bytes, flops, dtype)
        report(tot, "conv2d_fused_banded", tag, r, by, err, dtype)

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
        report(tot, "im2col_pack", tag, r, by, 0.0, dtype)

        # strip-major sparse GEMM on the packed strips, and the pipelined
        # one, which must give the same bits
        g_k = colwise_nm_matmul_strips_cuda(s_p, values, idx)
        err = max_err(g_k, colwise_nm_matmul_strips_ref(s_p, values, idx),
                      f"colwise_nm_matmul_strips {tag}", rtol)
        n_strips = s_p.shape[0]
        strip_bytes = (n_strips * kept_rows.numel() * 128 * isz + w_bytes
                       + g_k.numel() * isz)
        library_gemm = lambda: torch.matmul(w_dense, s_p)  # noqa: E731
        r = measure(lambda: colwise_nm_matmul_strips_cuda(s_p, values, idx),
                    lambda: colwise_nm_matmul_strips_ref(s_p, values, idx),
                    library_gemm)
        r["bound_ms"], by = bound_ms(strip_bytes, flops, dtype)
        report(tot, "colwise_nm_matmul_strips", tag, r, by, err, dtype)

        g_pk = colwise_nm_matmul_strips_pipelined_cuda(s_p, values, idx, hb=HB)
        err = max_err(g_pk, colwise_nm_matmul_strips_pipelined_ref(
            s_p, values, idx, hb=HB), f"colwise_nm_matmul_strips_pipelined {tag}",
            rtol)
        check(torch.equal(g_pk, g_k), f"colwise_nm_matmul_strips_pipelined "
              f"{tag}: not bit-identical to colwise_nm_matmul_strips")
        r = measure(
            lambda: colwise_nm_matmul_strips_pipelined_cuda(s_p, values, idx,
                                                            hb=HB),
            lambda: colwise_nm_matmul_strips_pipelined_ref(s_p, values, idx,
                                                           hb=HB),
            library_gemm)
        r["bound_ms"], by = bound_ms(strip_bytes, flops, dtype)
        report(tot, "colwise_nm_matmul_strips_pipelined", tag, r, by, err, dtype)
    return tot


def check_linear_kernel(dev, tot):
    """Phase 3, the sparse linear kernel at smollm-360m's MLP widths with
    serving's sparsity config (whole-d_out tiles), and at tile 8."""
    from repro_torch.core.formats import ColwiseMeta, unpack_colwise
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.core.sparse_linear import linear_init
    from repro_torch.kernels.colwise_nm import (colwise_nm_matmul_cuda,
                                                colwise_nm_matmul_ref)

    gen = torch.Generator().manual_seed(SEED)
    rng = np.random.default_rng(SEED + 11)
    for d_in, d_out, tile, dtype in LINEAR_CASES:
        sp = SparsityConfig(sparsity=0.5, m=None, tile=tile, min_dim=64,
                            format="compressed_pallas")
        layer = linear_init(gen, d_in, d_out, sp, dtype=dtype, device=dev)
        values, idx = layer["values"], layer["idx"]
        n_tiles, k_kept, t = values.shape
        x = torch.from_numpy(rng.standard_normal((LINEAR_ROWS, d_in),
                                                 dtype=np.float32)).to(dev, dtype)
        isz = x.element_size()
        rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
        tag = (f"{d_in}->{d_out} T={t} k_kept={k_kept} "
               f"{str(dtype).replace('torch.', '')} rows={LINEAR_ROWS}")
        y_k = colwise_nm_matmul_cuda(x, values, idx)
        err = max_err(y_k, colwise_nm_matmul_ref(x, values, idx),
                      f"colwise_nm_matmul {tag}", rtol)
        w_dense = unpack_colwise(values, idx, ColwiseMeta(
            d_in, d_out, t, d_in, k_kept))
        nb = (LINEAR_ROWS * torch.unique(idx).numel() * isz
              + values.numel() * isz + idx.numel() * idx.element_size()
              + LINEAR_ROWS * d_out * isz)
        r = measure(lambda: colwise_nm_matmul_cuda(x, values, idx),
                    lambda: colwise_nm_matmul_ref(x, values, idx),
                    lambda: torch.matmul(x, w_dense))
        r["bound_ms"], by = bound_ms(nb, 2 * LINEAR_ROWS * k_kept * d_out, dtype)
        # the kernel list sums the two serving widths; tile 8 and bf16 are
        # checked and printed
        report(tot, "colwise_nm_matmul", tag, r, by, err, dtype,
               count=tile is None)
    return tot


def max_err(got, want, what, rtol) -> float:
    """Max |got - want| after a synchronise; raises past ``rtol`` of
    max|want| or on a non-finite output."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    check(err <= rtol * scale, f"{what}: err {err} > {rtol} * {scale}")
    return err


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
    "colwise_nm_matmul": "torch.matmul of x [256, d_in] by the dense masked "
                         "[d_in, d_out] weight (TF32 off); every d_in row "
                         "instead of the kept ones",
    "colwise_nm_matmul_strips_pipelined": "torch.matmul of the dense masked "
                                          "[O, K] weight by the [S, K, V] "
                                          "strips, as for the strip GEMM",
    "conv2d_fused_banded": "F.conv2d on the dense masked weight, as for the "
                           "fused conv",
}
KEYS = ("ms", "eager_ms", "plain_ms", "bound_ms", "library_ms")


def measure(kernel_fn, plain_fn, library_fn) -> dict:
    """Device times (CUDA graph replay) of the kernel, its plain version and
    the library yardstick, and the kernel's eager per-call time."""
    return {"ms": time_ms(kernel_fn), "eager_ms": eager_ms(kernel_fn),
            "plain_ms": time_ms(plain_fn, iters=5),
            "library_ms": time_ms(library_fn)}


def report(tot, kernel, tag, r, by, err, dtype, count=True):
    print(f"  {kernel:34s} {tag}: ms={r['ms']:.5f} eager_ms={r['eager_ms']:.5f}"
          f" plain_ms={r['plain_ms']:.5f} library_ms={r['library_ms']:.5f}"
          f" bound_ms={r['bound_ms']:.6f} ({by}) max_abs_err={err:.3e}",
          flush=True)
    if dtype != torch.float32 or not count:
        return  # the kernel list sums the f32 main-path shapes
    t = tot.setdefault(kernel, {k: 0.0 for k in KEYS}
                       | {"max_abs_err": 0.0, "bound_by": {}})
    for k in KEYS:
        t[k] += r[k]
    t["max_abs_err"] = max(t["max_abs_err"], err)
    t["bound_by"][by] = t["bound_by"].get(by, 0.0) + r["bound_ms"]


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


SPARSE = ("values", "idx")
# Kernels each conv family launches for one pruned conv.
FAMILY_KERNELS = {
    "fused_sparse_pallas": {"conv2d_fused": 1},
    "fused_banded_pallas": {"conv2d_fused_banded": 1},
    "two_kernel_pipelined": {"im2col_pack": 1,
                             "colwise_nm_matmul_strips_pipelined": 1},
    "im2col_sparse_pallas": {"im2col_pack": 1, "colwise_nm_matmul_strips": 1},
    "im2col_sparse_xla": {"im2col_pack": 1},
}
PROFILE_DB = ROOT / "build" / "repro_torch" / "chip_smoke_profile.json"


def expected_launches(impls, n_forwards: int) -> dict:
    from repro_torch.kernels import KERNELS

    want = {k.name: 0 for k in KERNELS}
    for impl in impls:
        for name, n in FAMILY_KERNELS[impl.split("@")[0]].items():
            want[name] += n * n_forwards
    return want


def main_path_keys(params, cfg):
    """(name, OpKey) of every pruned conv, as ``conv2d_sparse`` forms it."""
    from repro_torch import dispatch

    out = []
    for name, layer, c, h, w, kh, kw, stride, pad in main_path_convs(params, cfg):
        n_tiles, k_kept, tile = layer["values"].shape
        out.append((name, dispatch.conv_key(
            c, h, w, n_tiles * tile, kh, kw, stride, pad, k_kept, tile,
            v=cfg.strip_v, dtype=layer["values"].dtype, batch=BATCH)))
    return out


def run_main_path(params, cfg, dev):
    """Phase 4: pruned resnet-tiny inference through ``vision_apply``: the
    default plan with an empty profile DB, the profiled plan, and every
    conv family forced.  Returns the launch counts of each run."""
    from repro_torch import dispatch
    from repro_torch.core.sparse_conv import compress_conv_tree
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.models.vision import (conv_hints, synth_batch,
                                           vision_accuracy, vision_apply,
                                           vision_init)

    PROFILE_DB.unlink(missing_ok=True)
    db = dispatch.ProfileDB(path=PROFILE_DB)
    dispatch.set_db(db)
    keys = main_path_keys(params, cfg)
    check(len(keys) == 5, f"expected 5 pruned convs, got {len(keys)}")
    batches = [synth_batch(cfg, SEED + 1 + i, BATCH, device=dev)
               for i in range(N_BATCHES)]
    # two plain paths: cuDNN on the unpacked weights on the card (no port
    # kernel), and the port's own plain versions on the CPU
    ref_params = dense_reference(params)
    cpu_params = tree_to(params, torch.device("cpu"))
    refs = [{"dense reference on the card": vision_apply(ref_params, cfg, x),
             "plain versions on the CPU": vision_apply(
                 cpu_params, cfg, x.cpu(), impl="im2col_sparse_xla").to(dev)}
            for x, _ in batches]
    runs = {}

    def drive(label, impl, layer_impls):
        vision_apply(params, cfg, batches[0][0], impl=impl)  # warm
        torch.cuda.synchronize()
        reset_launch_counts()
        logits = [vision_apply(params, cfg, x, impl=impl) for x, _ in batches]
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in KERNELS}
        want = expected_launches(layer_impls, N_BATCHES)
        print(f"  plan {label}: launches over {N_BATCHES} forwards = "
              f"{ {k: n for k, n in counts.items() if n} }", flush=True)
        check(counts == want, f"plan {label}: launches {counts}, want {want}")
        errs = []
        for y, ref in zip(logits, refs):
            check(tuple(y.shape) == (BATCH, cfg.num_classes),
                  f"logits shape {tuple(y.shape)}")
            check(bool(torch.isfinite(y).all()), f"plan {label}: non-finite")
            for name, r in ref.items():
                e = rel_err(y, r)
                check(e <= F32_RTOL, f"plan {label} vs {name}: {e}")
                errs.append(e)
        print(f"  plan {label}: rel err of the logits vs the two references "
              f"<= {max(errs):.3e}", flush=True)
        runs[label] = {"impl": impl, "logits": logits, "counts": counts}

    print("  (a) default plan, empty profile DB", flush=True)
    for name, key in keys:
        spec, source = dispatch.resolve(key, param_keys=SPARSE, device=dev)
        print(f"    {name}: {key.token} -> {spec.name} ({source})", flush=True)
        check(source == "heuristic" and spec.name == "fused_sparse_pallas"
              and spec.backend == "cuda",
              f"{name}: default resolves {spec.name} ({source})")
    drive("default", None, ["fused_sparse_pallas"] * len(keys))

    print("  (b) plan_params(profile=True) on the card (device time of each "
          "candidate, CUDA graph replay)", flush=True)
    hints = conv_hints(cfg, batch=BATCH)
    t0 = time.perf_counter()
    plan = dispatch.plan_params(params, profile=True, db=db, conv_hints=hints)
    print(f"    profiled {len(plan)} conv tokens in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(sorted(plan) == sorted(k.token for _, k in keys),
          f"planned tokens {sorted(plan)}")
    winners = []
    for name, key in keys:
        spec, source = dispatch.resolve(key, param_keys=SPARSE, device=dev)
        check(source == "db" and spec.name == plan[key.token]
              and spec.backend == "cuda",
              f"{name}: profiled plan resolves {spec.name} ({source})")
        rec = db.get(key.token)
        raced = [dispatch.REGISTRY.get("conv", n) for n in rec["all"]]
        check(all(s.backend == "cuda" for s in raced),
              f"{name}: the card raced a plain candidate: {sorted(rec['all'])}")
        times = " ".join(f"{n}={us:.2f}" for n, us in
                         sorted(rec["all"].items(), key=lambda kv: kv[1]))
        print(f"    {name}: {key.token} -> {spec.name} ({source}, "
              f"{rec['wall_us']:.2f} us); candidates (us): {times}", flush=True)
        winners.append(spec.name)
    profiles = [{name: db.get(key.token) for name, key in keys}]
    for i in range(1, N_PROFILES):  # the same race again, into fresh DBs
        again = dispatch.ProfileDB(path=PROFILE_DB.with_suffix(f".{i}.json"))
        again.path.unlink(missing_ok=True)
        dispatch.plan_params(params, profile=True, db=again, conv_hints=hints)
        profiles.append({name: again.get(key.token) for name, key in keys})
        again.path.unlink(missing_ok=True)
    for name, _ in keys:
        picks = [p[name]["impl"] for p in profiles]
        print(f"    winners of {name} over {N_PROFILES} profiles: {picks}",
              flush=True)
    steady = sum(len({p[name]["impl"] for p in profiles}) == 1
                 for name, _ in keys)
    print(f"    winners held in {steady} of {len(keys)} layers over "
          f"{N_PROFILES} profiles", flush=True)
    print("PROFILE " + json.dumps([{name: {"token": key.token, **p[name]}
                                    for name, key in keys} for p in profiles]),
          flush=True)
    drive("profiled", None, winners)

    print("  (c) every conv family forced, at its default geometry", flush=True)
    for family in FAMILY_KERNELS:
        drive(family, family, [family] * len(keys))
    for label, run in runs.items():
        for i, y in enumerate(run["logits"]):
            e = rel_err(y, runs["default"]["logits"][i])
            check(e <= F32_RTOL, f"plan {label} vs default, batch {i}: {e}")

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
    labels = list(runs)
    for label in labels + labels[::-1]:
        impl = runs[label]["impl"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            for x, _ in batches:
                vision_apply(params, cfg, x, impl=impl)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (10 * N_BATCHES)
        timing[label] = min(ms, timing.get(label, float("inf")))
    x = batches[0][0]
    for label, ms in timing.items():
        impl = runs[label]["impl"]
        dev_ms = time_ms(lambda: vision_apply(params, cfg, x, impl=impl),
                         iters=10)
        print(f"  forward, plan {label}: {ms:.4f} ms per batch of {BATCH} "
              f"({BATCH / ms * 1e3:.1f} images/s; host clock with "
              f"synchronize, best of 2 runs of {10 * N_BATCHES}); device time "
              f"{dev_ms:.4f} ms (CUDA graph replay), device idle share of the "
              f"eager forward {max(0.0, 1 - dev_ms / ms):.3f}", flush=True)
    ref_ms = time_ms(lambda: vision_apply(ref_params, cfg, x), iters=10)
    print(f"  forward of the dense reference (cuDNN F.conv2d on the unpacked "
          f"weights): device time {ref_ms:.4f} ms (CUDA graph replay)",
          flush=True)
    dispatch_host_cost(params, cfg, dev)
    print(f"  accuracy of the random-weight model on batch 0: {acc:.3f} "
          f"(chance is {1 / cfg.num_classes:.3f})", flush=True)
    return {label: run["counts"] for label, run in runs.items()}


def dispatch_host_cost(params, cfg, dev) -> None:
    """Host time of issuing each pruned conv through ``conv2d_sparse``'s
    dispatch lookup (naming the fused plan, so the kernel is the same)
    against calling ``conv2d_fused`` directly, and of the memoised lookup
    alone.  Issue time only (the queue drains after the clock stops); best
    of 4 interleaved rounds of 200 calls."""
    from repro_torch import dispatch
    from repro_torch.kernels.conv_gemm.ops import conv2d_fused, conv2d_sparse

    rng = np.random.default_rng(SEED + 5)
    total = {"direct": 0.0, "dispatch": 0.0, "lookup": 0.0}
    for name, layer, c, h, w, kh, kw, stride, pad in main_path_convs(params, cfg):
        x = torch.from_numpy(rng.standard_normal((c, BATCH, h, w),
                                                 dtype=np.float32)).to(dev)
        values, idx = layer["values"], layer["idx"]
        args = dict(kh=kh, kw=kw, stride=stride, pad=pad, v=cfg.strip_v)

        def lookup():  # the site tuple and memo hit conv2d_sparse makes
            return dispatch.site_impl(
                ("conv", x.shape, values.shape, x.dtype, x.device, kh, kw,
                 stride, pad, cfg.strip_v), None, param_keys=SPARSE,
                force="fused_sparse_pallas", device=x.device)

        fns = {"direct": lambda: conv2d_fused(x, values, idx, **args),
               "dispatch": lambda: conv2d_sparse(x, values, idx,
                                                 impl="fused_sparse_pallas",
                                                 **args),
               "lookup": lookup}
        best = {}
        fns["dispatch"]()  # fills the site memo
        for _ in range(4):
            for label, fn in fns.items():
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                us = (time.perf_counter() - t0) * 1e6 / 200
                torch.cuda.synchronize()
                best[label] = min(us, best.get(label, float("inf")))
        for label in total:
            total[label] += best[label]
        print(f"  host issue time of {name}: direct conv2d_fused "
              f"{best['direct']:.2f} us, through dispatch "
              f"{best['dispatch']:.2f} us per call; the memoised lookup alone "
              f"{best['lookup']:.2f} us", flush=True)
    print(f"  host cost of dispatch per forward (5 convs): "
          f"{total['dispatch'] - total['direct']:.2f} us "
          f"({total['direct']:.2f} us direct, {total['dispatch']:.2f} us "
          f"through dispatch, of which {total['lookup']:.2f} us is the "
          f"memoised lookup)", flush=True)


def run_linear_path(dev) -> int:
    """Phase 5: compressed linear layers built with serving's sparsity
    config (and tiles 8 and 12) through ``linear_apply``'s dispatch on the
    card, first with an empty DB (the heuristic), then with the layer
    profiled.  Returns the sparse-linear launches of the phase."""
    from repro_torch import dispatch
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.core.sparse_linear import linear_apply, linear_init
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.kernels.colwise_nm import colwise_nm_matmul_ref

    gen = torch.Generator().manual_seed(SEED + 3)
    rng = np.random.default_rng(SEED + 4)
    launches = 0
    db_path = PROFILE_DB.with_suffix(".linear.json")
    for d_in, d_out, tile in DISPATCH_LINEAR_CASES:
        sp = SparsityConfig(sparsity=0.5, m=None, tile=tile, min_dim=64,
                            format="compressed_pallas")
        layer = linear_init(gen, d_in, d_out, sp, device=dev)
        x = torch.from_numpy(rng.standard_normal((LINEAR_ROWS, d_in),
                                                 dtype=np.float32)).to(dev)
        key = dispatch.linear_key_from(x.shape, layer["values"].shape, x.dtype)
        want = colwise_nm_matmul_ref(x, layer["values"], layer["idx"])
        db_path.unlink(missing_ok=True)
        db = dispatch.ProfileDB(path=db_path)
        dispatch.set_db(db)
        for rung in ("heuristic", "db"):
            if rung == "db":
                plan = dispatch.plan_params({"mlp": layer}, profile=True,
                                            batch_hint=LINEAR_ROWS, db=db)
                check(list(plan) == [key.token], f"linear plan {plan}")
            spec, source = dispatch.resolve(key, param_keys=SPARSE, device=dev)
            check(source == rung and spec.backend == "cuda"
                  and (rung == "db" or spec.name == "compressed_pallas"),
                  f"linear {key.token} resolves {spec.name} ({source})")
            linear_apply(layer, x)  # warm
            torch.cuda.synchronize()
            reset_launch_counts()
            y = linear_apply(layer, x)
            torch.cuda.synchronize()
            counts = {k.name: k.launches for k in KERNELS if k.launches}
            check(counts == {"colwise_nm_matmul": 1},
                  f"linear launches {counts}")
            launches += counts["colwise_nm_matmul"]
            e = rel_err(y, want)
            check(e <= F32_RTOL, f"linear {key.token} vs plain: {e}")
            timed = ""
            if rung == "db":
                rec = db.get(key.token)
                timed = "; candidates (us): " + " ".join(
                    f"{n}={us:.2f}" for n, us in
                    sorted(rec["all"].items(), key=lambda kv: kv[1]))
            print(f"  linear {d_in}->{d_out} T={layer['values'].shape[2]}: "
                  f"{key.token} -> {spec.name} ({source}); 1 launch; rel err "
                  f"vs plain {e:.3e}{timed}", flush=True)
        db_path.unlink(missing_ok=True)
    dispatch.set_db(None)
    return launches


def main() -> int:
    t_start = time.perf_counter()
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
    check_linear_kernel(dev, tot)

    print(f"== 4. main path: resnet-tiny inference, batch {BATCH}", flush=True)
    counts = run_main_path(params, cfg, dev)

    print(f"== 5. compressed linear layers through dispatch, {LINEAR_ROWS} rows",
          flush=True)
    linear_launches = run_linear_path(dev)

    print("== 6. report", flush=True)
    launches = {
        "conv2d_fused": counts["default"]["conv2d_fused"],
        "im2col_pack": counts["im2col_sparse_pallas"]["im2col_pack"],
        "colwise_nm_matmul_strips":
            counts["im2col_sparse_pallas"]["colwise_nm_matmul_strips"],
        "conv2d_fused_banded":
            counts["fused_banded_pallas"]["conv2d_fused_banded"],
        "colwise_nm_matmul_strips_pipelined":
            counts["two_kernel_pipelined"]["colwise_nm_matmul_strips_pipelined"],
        "colwise_nm_matmul": linear_launches,
    }
    per = {"colwise_nm_matmul": "ms etc.: sum over the 960->2560 and "
                                "2560->960 layers at 256 rows (T = d_out); "
                                "launches: the linear phase, 4 layers each "
                                "by the heuristic and by a profile"}
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
            "per": per.get(k.name, "sum over the 5 pruned convs of one "
                                   "batch-256 forward"),
        })
    print(f"  chip_smoke took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
