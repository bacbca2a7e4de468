#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Phases:
  1. card   : name and power limit (nvidia-smi); TF32 off for the references
  2. build  : the hand-written kernels from src/repro_torch/csrc (nvcc, one
              process per source, all started together)
  3. kernels: each kernel against its plain PyTorch version at the main
              path's shapes: the five pruned-conv shapes of resnet-tiny at
              batch 256 (f32, and one bf16 case) for the conv kernels (both
              banded kernels equal bit for bit to each other and to the
              fused conv, timed per conv beside F.conv2d, then
              conv2d_fused_banded_cuda over the six cases and a misaligned
              view, each launching the kernel the shape rule picks, then
              the tiled kernel's tile-group path at ResNet-18 layer2's
              conv, bit for bit against the fused conv), and
              smollm-360m's MLP widths (960 -> 2560, 2560 -> 960) at 256
              rows for the two sparse linear kernels, the tiled one (T a
              multiple of 64) equal bit for bit to the other (f32, bf16);
              kernel, plain-version and library-call times beside each
              kernel's bound; then both linear kernels timed at 4, 256 and
              8192 rows beside their bound, plain version and torch.matmul
  4. main   : pruned resnet-tiny inference through ``vision_apply`` at batch
              256: (a) the default plan with an empty profile DB, (b) the
              plan ``plan_params(profile=True)`` races on the card, with every
              candidate's device time per layer, profiled again to see
              whether the winners hold, (c) the forward forced under each
              conv family (the banded family launches, per conv, the banded
              kernel the shape rule picks); launch counts, logits held against a dense
              reference, the masked -> compressed tree check, forward times,
              and the host cost of the dispatch lookup per conv call
  5. linear : compressed linear layers (serving's sparsity config, tile 8
              and tile 12) through ``linear_apply``'s dispatch, by the
              heuristic (the tiled kernel for T = d_out, the other for tiles
              8 and 12) and by a profile racing both families, against the
              plain version
  6. paged  : the paged-attention kernel against its plain version at
              smollm-360m's serving shapes (H 15, KV 5, D 64, page size 16;
              B 4 and 8; ragged lengths with 0, one page and a ragged last
              page; shuffled page ids, trash-padded tables; one Sq 4 and one
              bf16 case), with its bound and an SDPA yardstick
  7. serve  : pruned smollm-360m at its published widths (32 layers, random
              weights from the seed) served through ``Scheduler(paged=True)``:
              8 synthetic requests, greedy; request, page-pool and
              launch-count checks (every linear through the tiled kernel,
              the other linear kernel and flash launched 0 times), a
              teacher-forced replay of every step through the plain
              versions, host times per step and the device time of one
              decode step, with both linear kernels timed at its rows
  8. flash  : both flash-attention kernels against their plain version over
              the JAX flash tests' sweep, the (5, 2) GQA map with the
              top-left mask, D 128, a ragged Sq = Sk = 130, a D 18 head
              (which only flash_attention.cu takes) and smollm-360m's
              scoring shape (B 4, S 2048, H 15, KV 5, D 64), in f32 and
              bf16, with their bounds and an SDPA yardstick; the tiled
              kernel equal bit for bit (torch.equal) to flash_attention.cu
              wherever it takes the case; then ``ops.flash_attention`` over
              the same cases, each launching the kernel the shape rule
              routes it to
  9. score  : the same pruned smollm-360m scored under attn_impl="pallas"
              through ``registry.loss_fn`` and ``forward_fn`` on 2 batches of
              4 x 2048 tokens of the port's ``SyntheticLM``: exact launch
              counts (32 tiled-flash and 224 tiled-linear launches per
              forward, none of flash_attention.cu),
              logits and NLL against a replay through the plain versions,
              the NLLs equal to the ones the other linear kernel and
              flash_attention.cu gave (the bits are the same), host and device ms per forward, tokens/s,
              idle share and the kernels' shares of the device time
 10. report : one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
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
# phase 3's row sweep of both linear kernels: decode's 4 rows, phase 3's 256
# and scoring's 8192, at smollm-360m's MLP widths with T = d_out, f32
SWEEP_ROWS = (4, 256, 8192)
SWEEP_WIDTHS = ((960, 2560), (2560, 960))
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
# phase 6: (B, Sq, lengths, dtype) at smollm-360m's heads and page size 16;
# n_max = 10 pages, the serving phase's table width
PAGED_H, PAGED_KV, PAGED_D, PAGED_PS, PAGED_NMAX = 15, 5, 64, 16, 10
PAGED_CASES = [(4, 1, [0, 16, 37, 150], torch.float32),   # the decode step's
               (8, 1, [0, 16, 37, 150, 1, 159, 64, 90], torch.float32),
               (4, 4, [31, 0, 16, 100], torch.float32),   # causal new keys
               (4, 1, [0, 16, 37, 150], torch.bfloat16)]
# phase 7
SERVE_SLOTS, SERVE_REQUESTS = 4, 8
SERVE_PROMPTS, SERVE_BUDGETS = (16, 128), (16, 32)
# teacher-forced replay through the plain versions: 32 layers of sums taken
# in another order (the kernels' f32 accumulation vs cuBLAS and einsum)
REPLAY_RTOL = 1e-3  # of max|logit| per step
# phase 8: (B, Sq, Sk, H, KV, D, causal).  tests/test_flash_attn.py's sweep
# in the Pallas kernel's [BH, S, D] layout (H = KV = 1), the (5, 2) GQA map
# with the top-left mask at Sq > Sk, the widest head (D 128), a ragged last
# query block and key tile (Sq = Sk = 130), a head the tiled kernel refuses
# (D 18: not whole 16-byte rows, so flash_attention.cu takes it), and the
# scoring forward's shape, which the kernel list carries
FLASH_CASES = [(2, 32, 32, 1, 1, 16, True), (1, 16, 48, 1, 1, 16, False),
               (2, 24, 24, 1, 1, 32, True), (1, 8, 8, 1, 1, 16, True),
               (3, 33, 17, 1, 1, 16, True), (2, 33, 17, 5, 2, 16, True),
               (1, 70, 70, 2, 1, 128, True), (2, 130, 130, 15, 5, 64, True),
               (2, 33, 17, 5, 2, 18, True), (4, 2048, 2048, 15, 5, 64, True)]
# JAX's flash TOL (tests/test_flash_attn.py), here of max|y|
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# phase 9: 2 batches of 4 sequences of 2048 tokens (SmolLM's training
# context), each scored by loss_fn and forward_fn
SCORE_BATCH, SCORE_SEQ, SCORE_BATCHES = 4, 2048, 2
SCORE_NLL_RTOL = 1e-4  # of the replay's NLL
# the two scoring NLLs that colwise_nm_matmul and flash_attention.cu gave on
# the same seeded weights and tokens (PERF.md): the tiled kernels' bits are
# theirs
SCORE_NLLS = (11.006677627563477, 10.987235069274902)
# the kernel each compressed-linear family launches
LINEAR_FAMILY_KERNEL = {"compressed_tiled": "colwise_nm_matmul_tiled",
                        "compressed_pallas": "colwise_nm_matmul"}


def flash_tiled_registers(log: Path) -> list:
    """(instance, registers, spills) of each flash_attention_tiled.cu
    instance, from the ``-Xptxas -v`` output the build keeps: instance as
    "f32|bf16 BQxRPT DG" (query rows of a block, rows a thread, 32-column
    groups)."""
    import re

    out, inst, spill = [], None, ""
    for line in log.read_text().splitlines():
        m = re.search(r"flash_tiled_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)E",
                      line)
        if "Compiling entry function" in line:
            inst = (f"{'f32' if m.group(1) == 'f' else 'bf16'} "
                    f"{m.group(2)}x{m.group(3)} DG{m.group(4)}") if m else None
        elif inst and "spill" in line:
            spill = line.strip()
        elif inst and "registers" in line:
            out.append((inst, int(re.search(r"Used (\d+) registers", line)
                                  .group(1)), spill))
            inst = None
    return out


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
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.conv_gemm import (
        CONV2D_FUSED_BANDED, CONV2D_FUSED_BANDED_TILED, banded_tiled_geometry,
        banded_tiled_takes,
        conv2d_fused_banded_cuda, conv2d_fused_banded_ref,
        conv2d_fused_banded_scalar_cuda, conv2d_fused_banded_tiled_cuda,
        conv2d_fused_banded_tiled_ref, conv2d_fused_cuda, conv2d_fused_ref)
    from repro_torch.kernels.im2col_pack import (
        im2col_pack_cuda, im2col_pack_ref, out_size)
    from repro_torch.core.formats import ColwiseMeta, unpack_colwise

    rng = np.random.default_rng(SEED)
    tot = {}
    routed = []  # (x, values, idx, geometry) of each case, for the routing run
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

        # both banded kernels: conv2d_fused_banded.cu called directly (the
        # rule gives every case here to the tiled kernel), then the tiled
        # one; each equal bit for bit to the fused conv and to the other
        banded_ref = conv2d_fused_banded_ref(x, values, idx, hb=HB, **geo)
        y_b = conv2d_fused_banded_scalar_cuda(x, values, idx, hb=HB, **geo)
        err = max_err(y_b, banded_ref, f"conv2d_fused_banded {tag}", rtol)
        check(torch.equal(y_b, y_k), f"conv2d_fused_banded {tag}: not "
              "bit-identical to conv2d_fused")
        r_old = measure(
            lambda: conv2d_fused_banded_scalar_cuda(x, values, idx, hb=HB, **geo),
            lambda: conv2d_fused_banded_ref(x, values, idx, hb=HB, **geo),
            library_conv)
        r_old["bound_ms"], by = bound_ms(conv_bytes, flops, dtype)
        report(tot, "conv2d_fused_banded", tag, r_old, by, err, dtype)

        check(banded_tiled_takes(x, values, hb=HB, **geo),
              f"{tag}: the tiled banded kernel refuses a main-path conv")
        y_t = conv2d_fused_banded_tiled_cuda(x, values, idx, hb=HB, **geo)
        max_err(y_t, banded_ref, f"conv2d_fused_banded_tiled {tag} vs "
                "conv2d_fused_banded_ref", rtol)
        err = max_err(y_t, conv2d_fused_banded_tiled_ref(x, values, idx, hb=HB,
                                                         **geo),
                      f"conv2d_fused_banded_tiled {tag}", rtol)
        check(torch.equal(y_t, y_b), f"conv2d_fused_banded_tiled {tag}: not "
              "bit-identical to conv2d_fused_banded")
        check(torch.equal(y_t, y_k), f"conv2d_fused_banded_tiled {tag}: not "
              "bit-identical to conv2d_fused")
        r = measure(
            lambda: conv2d_fused_banded_tiled_cuda(x, values, idx, hb=HB, **geo),
            lambda: conv2d_fused_banded_tiled_ref(x, values, idx, hb=HB, **geo),
            library_conv)
        r["bound_ms"], by = bound_ms(conv_bytes, flops, dtype)
        report(tot, "conv2d_fused_banded_tiled", tag, r, by, err, dtype)
        gf = flops / 1e6  # GFLOP/s = flops / 1e9 / (ms / 1e3)
        print(f"  banded {tag}: tiled {r['ms']:.5f} ms ({gf / r['ms']:.1f} "
              f"GFLOP/s), conv2d_fused_banded {r_old['ms']:.5f} ms "
              f"({gf / r_old['ms']:.1f}), F.conv2d {r['library_ms']:.5f} ms "
              f"({gf / r['library_ms']:.1f}), bound {r['bound_ms']:.6f} ms; "
              f"tiled {r_old['ms'] / r['ms']:.2f}x faster than the other, "
              f"{r['library_ms'] / r['ms']:.2f}x cuDNN's speed; bit-identical",
              flush=True)
        routed.append((x, values, idx, geo))

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

    # the banded routing rule over the six cases and a misaligned view of
    # the first: the tiled kernel takes the six, conv2d_fused_banded.cu the view
    x0, v0, i0, geo0 = routed[0]
    flat = torch.empty(x0.numel() + 1, dtype=x0.dtype, device=dev)
    x_mis = flat[1:].view(x0.shape)
    x_mis.copy_(x0)
    check(not banded_tiled_takes(x_mis, v0, hb=HB, **geo0),
          "the rule takes a misaligned map")
    want = [conv2d_fused_banded_scalar_cuda(x, vv, ii, hb=HB, **g)
            for x, vv, ii, g in routed]
    torch.cuda.synchronize()
    reset_launch_counts()
    got = [conv2d_fused_banded_cuda(x, vv, ii, hb=HB, **g)
           for x, vv, ii, g in routed]
    got.append(conv2d_fused_banded_cuda(x_mis, v0, i0, hb=HB, **geo0))
    torch.cuda.synchronize()
    route = {"conv2d_fused_banded_tiled": CONV2D_FUSED_BANDED_TILED.launches,
             "conv2d_fused_banded": CONV2D_FUSED_BANDED.launches}
    check(route == {"conv2d_fused_banded_tiled": len(routed),
                    "conv2d_fused_banded": 1},
          f"conv2d_fused_banded_cuda launched {route}")
    check(all(torch.equal(g, w) for g, w in zip(got, want + want[:1])),
          "the routed banded convs are not the bits of conv2d_fused_banded.cu")
    print(f"  conv2d_fused_banded_cuda over the {len(routed)} cases and a "
          f"misaligned view: launches {route}; bit-identical", flush=True)

    # the tiled kernel's other path, which resnet-tiny never takes: ResNet-18
    # layer2's 3x3 conv (128 -> 128 at 28x28, batch 8, f32, 50% kept, bands
    # of one strip), whose weights a block stages a group of tiles at a time
    c2, b2, h2, n2 = 128, 8, 28, 16
    k2 = 9 * c2
    x2 = torch.from_numpy(rng.standard_normal((c2, b2, h2, h2),
                                              dtype=np.float32)).to(dev)
    v2 = torch.from_numpy(rng.standard_normal((n2, k2 // 2, 8),
                                              dtype=np.float32)).to(dev)
    i2 = torch.from_numpy(np.stack([
        np.sort(rng.choice(k2, k2 // 2, replace=False)) for _ in range(n2)
    ]).astype(np.int32)).to(dev)
    g2 = dict(kh=3, kw=3, stride=1, pad=1, v=128)
    group = banded_tiled_geometry(c2, b2, h2, h2, 3, 3, 1, 1, 128, 1, n2,
                                  k2 // 2, 8, 4)["group"]
    check(group < n2, f"resnet18/layer2: tiles staged in one group of {group}")
    y2 = conv2d_fused_banded_tiled_cuda(x2, v2, i2, hb=1, **g2)
    max_err(y2, conv2d_fused_banded_tiled_ref(x2, v2, i2, hb=1, **g2),
            "conv2d_fused_banded_tiled resnet18/layer2", F32_RTOL)
    check(torch.equal(y2, conv2d_fused_cuda(x2, v2, i2, **g2)),
          "conv2d_fused_banded_tiled resnet18/layer2: not bit-identical to "
          "conv2d_fused")
    w2 = unpack_colwise(v2, i2, ColwiseMeta(k2, 8 * n2, 8, k2, k2 // 2)).T
    w2 = w2.reshape(8 * n2, 3, 3, c2).permute(0, 3, 1, 2).contiguous()
    x2_nchw = x2.permute(1, 0, 2, 3).contiguous()
    ms2 = time_ms(lambda: conv2d_fused_banded_tiled_cuda(x2, v2, i2, hb=1, **g2))
    lib2 = time_ms(lambda: F.conv2d(x2_nchw, w2, padding=1))
    gf = 2 * 8 * n2 * (k2 // 2) * b2 * h2 * h2 / 1e6
    print(f"  banded resnet18/layer2 f32 C=128 28x28 batch 8 v128 hb1 "
          f"({group} of {n2} tiles staged at once): tiled {ms2:.5f} ms "
          f"({gf / ms2:.1f} GFLOP/s), F.conv2d {lib2:.5f} ms "
          f"({gf / lib2:.1f}); bit-identical to conv2d_fused", flush=True)
    return tot, route


def linear_bound(rows, values, idx, dtype) -> tuple:
    """(ms, "bytes" | "operations") of one sparse linear call: the kept
    columns of x, values, idx and the output moved once; 2 FLOPs per kept
    row per output."""
    n_tiles, k_kept, tile = values.shape
    isz = values.element_size()
    nb = (rows * torch.unique(idx).numel() * isz + values.numel() * isz
          + idx.numel() * idx.element_size() + rows * n_tiles * tile * isz)
    return bound_ms(nb, 2 * rows * k_kept * n_tiles * tile, dtype)


def check_linear_kernel(dev, tot):
    """Phase 3, the sparse linear kernels at smollm-360m's MLP widths with
    serving's sparsity config (whole-d_out tiles), and at tile 8: the tiled
    kernel wherever T is a multiple of 64, bit for bit equal to the other."""
    from repro_torch.core.formats import ColwiseMeta, unpack_colwise
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.core.sparse_linear import linear_init
    from repro_torch.kernels.colwise_nm import (TILED_BN, colwise_nm_matmul_cuda,
                                                colwise_nm_matmul_ref,
                                                colwise_nm_matmul_tiled_cuda)

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
        rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
        tag = (f"{d_in}->{d_out} T={t} k_kept={k_kept} "
               f"{str(dtype).replace('torch.', '')} rows={LINEAR_ROWS}")
        want = colwise_nm_matmul_ref(x, values, idx)
        y_k = colwise_nm_matmul_cuda(x, values, idx)
        err = max_err(y_k, want, f"colwise_nm_matmul {tag}", rtol)
        w_dense = unpack_colwise(values, idx, ColwiseMeta(
            d_in, d_out, t, d_in, k_kept))
        library = lambda: torch.matmul(x, w_dense)  # noqa: E731
        r = measure(lambda: colwise_nm_matmul_cuda(x, values, idx),
                    lambda: colwise_nm_matmul_ref(x, values, idx), library)
        r["bound_ms"], by = linear_bound(LINEAR_ROWS, values, idx, dtype)
        # the kernel list sums the two serving widths; tile 8 and bf16 are
        # checked and printed
        report(tot, "colwise_nm_matmul", tag, r, by, err, dtype,
               count=tile is None)
        if t % TILED_BN:
            continue  # tile 8 stays on the kernel above
        y_t = colwise_nm_matmul_tiled_cuda(x, values, idx)
        err = max_err(y_t, want, f"colwise_nm_matmul_tiled {tag}", rtol)
        check(torch.equal(y_t, y_k), f"colwise_nm_matmul_tiled {tag}: not "
              "bit-identical to colwise_nm_matmul")
        r = measure(lambda: colwise_nm_matmul_tiled_cuda(x, values, idx),
                    lambda: colwise_nm_matmul_ref(x, values, idx), library)
        r["bound_ms"], by = linear_bound(LINEAR_ROWS, values, idx, dtype)
        report(tot, "colwise_nm_matmul_tiled", tag, r, by, err, dtype,
               count=tile is None)
    return tot


def sweep_linear_kernels(dev) -> None:
    """Phase 3, both linear kernels at decode's, phase 3's and scoring's row
    counts at smollm-360m's MLP widths (T = d_out, f32): device and eager
    times, the bound, the plain version and ``torch.matmul`` of the dense
    masked weight (TF32 off), which does twice the sparse work."""
    from repro_torch.core.formats import ColwiseMeta, unpack_colwise
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.core.sparse_linear import linear_init
    from repro_torch.kernels.colwise_nm import (colwise_nm_matmul_cuda,
                                                colwise_nm_matmul_ref,
                                                colwise_nm_matmul_tiled_cuda)

    gen = torch.Generator().manual_seed(SEED + 12)
    rng = np.random.default_rng(SEED + 13)
    sp = SparsityConfig(sparsity=0.5, m=None, tile=None, min_dim=64,
                        format="compressed_pallas")
    recs = []
    for d_in, d_out in SWEEP_WIDTHS:
        layer = linear_init(gen, d_in, d_out, sp, device=dev)
        values, idx = layer["values"], layer["idx"]
        k_kept = values.shape[1]
        w_dense = unpack_colwise(values, idx, ColwiseMeta(
            d_in, d_out, d_out, d_in, k_kept))
        for rows in SWEEP_ROWS:
            x = torch.from_numpy(rng.standard_normal(
                (rows, d_in), dtype=np.float32)).to(dev)
            y_t = colwise_nm_matmul_tiled_cuda(x, values, idx)
            y_k = colwise_nm_matmul_cuda(x, values, idx)
            max_err(y_t, colwise_nm_matmul_ref(x, values, idx),
                    f"colwise_nm_matmul_tiled {d_in}->{d_out} rows={rows}",
                    F32_RTOL)
            check(torch.equal(y_t, y_k), f"colwise_nm_matmul_tiled {d_in}->"
                  f"{d_out} rows={rows}: not bit-identical")
            tiled = lambda: colwise_nm_matmul_tiled_cuda(x, values, idx)  # noqa: E731
            old = lambda: colwise_nm_matmul_cuda(x, values, idx)  # noqa: E731
            bound, by = linear_bound(rows, values, idx, torch.float32)
            rec = {"d_in": d_in, "d_out": d_out, "rows": rows,
                   "k_kept": k_kept, "tiled_ms": time_ms(tiled),
                   "tiled_eager_ms": eager_ms(tiled), "old_ms": time_ms(old),
                   "old_eager_ms": eager_ms(old),
                   "plain_ms": time_ms(lambda: colwise_nm_matmul_ref(
                       x, values, idx), iters=5),
                   "matmul_ms": time_ms(lambda: torch.matmul(x, w_dense)),
                   "bound_ms": bound, "bound_by": by,
                   "sparse_gflop": 2 * rows * k_kept * d_out / 1e9}
            recs.append(rec)
            print(f"  sweep {d_in}->{d_out} rows={rows}: tiled "
                  f"ms={rec['tiled_ms']:.5f} (eager {rec['tiled_eager_ms']:.5f}) "
                  f"colwise_nm_matmul ms={rec['old_ms']:.5f} (eager "
                  f"{rec['old_eager_ms']:.5f}) plain_ms={rec['plain_ms']:.5f} "
                  f"torch.matmul ms={rec['matmul_ms']:.5f} (dense, "
                  f"{2 * rec['sparse_gflop']:.3f} GFLOP: twice the sparse "
                  f"work) bound_ms={bound:.6f} ({by}); tiled "
                  f"{rec['sparse_gflop'] / rec['tiled_ms']:.2f} TFLOP/s; "
                  "bit-identical", flush=True)
    print("SWEEP " + json.dumps(recs), flush=True)


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
    "colwise_nm_matmul_tiled": "torch.matmul of x [256, d_in] by the dense "
                               "masked weight, as for colwise_nm_matmul",
    "colwise_nm_matmul_strips_pipelined": "torch.matmul of the dense masked "
                                          "[O, K] weight by the [S, K, V] "
                                          "strips, as for the strip GEMM",
    "conv2d_fused_banded": "F.conv2d on the dense masked weight, as for the "
                           "fused conv",
    "conv2d_fused_banded_tiled": "F.conv2d on the dense masked weight, as "
                                 "for the fused conv",
    "paged_attention": "F.scaled_dot_product_attention on K/V pre-gathered "
                       "to [B, H, n_max*ps + Sq, D] with a boolean mask; the "
                       "gather is not timed",
    "flash_attention": "F.scaled_dot_product_attention(is_causal=causal) on "
                       "[B, H, S, D] with K/V pre-expanded to H heads (the "
                       "transposes and the expansion not timed); timed where "
                       "Sq == Sk or not causal, as SDPA aligns its causal "
                       "mask bottom-right",
    "flash_attention_tiled": "F.scaled_dot_product_attention, as for "
                             "flash_attention",
}
KEYS = ("ms", "eager_ms", "plain_ms", "bound_ms", "library_ms")


def measure(kernel_fn, plain_fn, library_fn) -> dict:
    """Device times (CUDA graph replay) of the kernel, its plain version and
    the library yardstick (``None`` where there is none), and the kernel's
    eager per-call time."""
    return {"ms": time_ms(kernel_fn), "eager_ms": eager_ms(kernel_fn),
            "plain_ms": time_ms(plain_fn, iters=5),
            "library_ms": None if library_fn is None else time_ms(library_fn)}


def report(tot, kernel, tag, r, by, err, dtype, count=True):
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
    print(f"  {kernel:34s} {tag}: ms={r['ms']:.5f} eager_ms={r['eager_ms']:.5f}"
          f" plain_ms={r['plain_ms']:.5f} library_ms={lib}"
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
# Kernels each conv family launches for one pruned conv; the banded family's
# kernel depends on the conv's shape (family_kernels).
FAMILY_KERNELS = {
    "fused_sparse_pallas": {"conv2d_fused": 1},
    "fused_banded_pallas": None,
    "two_kernel_pipelined": {"im2col_pack": 1,
                             "colwise_nm_matmul_strips_pipelined": 1},
    "im2col_sparse_pallas": {"im2col_pack": 1, "colwise_nm_matmul_strips": 1},
    "im2col_sparse_xla": {"im2col_pack": 1},
}
PROFILE_DB = ROOT / "build" / "repro_torch" / "chip_smoke_profile.json"


def family_kernels(impl, conv) -> dict:
    """Kernels one pruned conv launches under the candidate ``impl``: the
    banded family's by the shape rule (``banded_tiled_geometry``) at the
    candidate's strip width and band depth."""
    from repro_torch import dispatch
    from repro_torch.kernels.conv_gemm import banded_tiled_geometry

    family = impl.split("@")[0]
    if FAMILY_KERNELS[family] is not None:
        return FAMILY_KERNELS[family]
    spec = dispatch.REGISTRY.get("conv", impl)
    _name, layer, c, h, w, kh, kw, stride, pad = conv
    n_tiles, k_kept, tile = layer["values"].shape
    tiled = banded_tiled_geometry(
        c, BATCH, h, w, kh, kw, stride, pad, spec.geom("v"), spec.geom("hb"),
        n_tiles, k_kept, tile, layer["values"].element_size()) is not None
    return {"conv2d_fused_banded_tiled" if tiled else "conv2d_fused_banded": 1}


def expected_launches(impls, convs, n_forwards: int) -> dict:
    from repro_torch.kernels import KERNELS

    want = {k.name: 0 for k in KERNELS}
    for impl, conv in zip(impls, convs, strict=True):
        for name, n in family_kernels(impl, conv).items():
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
    # the default plan is timed, after the profile has filled db, against a
    # DB that stays empty: the heuristic's plan
    empty = dispatch.ProfileDB(path=PROFILE_DB.with_suffix(".empty.json"))
    empty.path.unlink(missing_ok=True)
    keys = main_path_keys(params, cfg)
    convs = main_path_convs(params, cfg)
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
        want = expected_launches(layer_impls, convs, N_BATCHES)
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
        runs[label] = {"impl": impl, "logits": logits, "counts": counts,
                       "db": empty if label == "default" else db}

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
        dispatch.set_db(runs[label]["db"])
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
        dispatch.set_db(runs[label]["db"])
        dev_ms = time_ms(lambda: vision_apply(params, cfg, x, impl=impl),
                         iters=10)
        print(f"  forward, plan {label}: {ms:.4f} ms per batch of {BATCH} "
              f"({BATCH / ms * 1e3:.1f} images/s; host clock with "
              f"synchronize, best of 2 runs of {10 * N_BATCHES}); device time "
              f"{dev_ms:.4f} ms (CUDA graph replay), device idle share of the "
              f"eager forward {max(0.0, 1 - dev_ms / ms):.3f}", flush=True)
    dispatch.set_db(db)
    check(not empty.path.exists(), "the default plan's timing wrote a profile")
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
                 stride, pad, cfg.strip_v, ""), None, param_keys=SPARSE,
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


def run_linear_path(dev) -> dict:
    """Phase 5: compressed linear layers built with serving's sparsity
    config (and tiles 8 and 12) through ``linear_apply``'s dispatch on the
    card, first with an empty DB (the heuristic: the tiled kernel where T is
    a multiple of 64, the other kernel for tiles 8 and 12), then with the
    layer profiled among both families.  Returns the launches of each
    sparse-linear kernel over the phase."""
    from repro_torch import dispatch
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.core.sparse_linear import linear_apply, linear_init
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.kernels.colwise_nm import TILED_BN, colwise_nm_matmul_ref

    gen = torch.Generator().manual_seed(SEED + 3)
    rng = np.random.default_rng(SEED + 4)
    launches = {name: 0 for name in LINEAR_FAMILY_KERNEL.values()}
    db_path = PROFILE_DB.with_suffix(".linear.json")
    for d_in, d_out, tile in DISPATCH_LINEAR_CASES:
        sp = SparsityConfig(sparsity=0.5, m=None, tile=tile, min_dim=64,
                            format="compressed_pallas")
        layer = linear_init(gen, d_in, d_out, sp, device=dev)
        x = torch.from_numpy(rng.standard_normal((LINEAR_ROWS, d_in),
                                                 dtype=np.float32)).to(dev)
        key = dispatch.linear_key_from(x.shape, layer["values"].shape, x.dtype)
        want = colwise_nm_matmul_ref(x, layer["values"], layer["idx"])
        t = layer["values"].shape[2]
        heuristic = "compressed_tiled" if t % TILED_BN == 0 else "compressed_pallas"
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
                  and (rung == "db" or spec.name == heuristic),
                  f"linear {key.token} resolves {spec.name} ({source})")
            kernel = LINEAR_FAMILY_KERNEL[spec.name.split("@")[0]]
            linear_apply(layer, x)  # warm
            torch.cuda.synchronize()
            reset_launch_counts()
            y = linear_apply(layer, x)
            torch.cuda.synchronize()
            counts = {k.name: k.launches for k in KERNELS if k.launches}
            check(counts == {kernel: 1}, f"linear launches {counts}, want "
                  f"{kernel} once")
            launches[kernel] += 1
            e = rel_err(y, want)
            check(e <= F32_RTOL, f"linear {key.token} vs plain: {e}")
            timed = ""
            if rung == "db":
                rec = db.get(key.token)
                families = {n.split("@")[0] for n in rec["all"]}
                want_families = ({"compressed_tiled", "compressed_pallas"}
                                 if t % TILED_BN == 0 else {"compressed_pallas"})
                check(families == want_families,
                      f"linear {key.token} profiled {sorted(rec['all'])}")
                timed = "; candidates (us): " + " ".join(
                    f"{n}={us:.2f}" for n, us in
                    sorted(rec["all"].items(), key=lambda kv: kv[1]))
            print(f"  linear {d_in}->{d_out} T={t}: {key.token} -> "
                  f"{spec.name} ({source}); 1 launch of {kernel}; rel err "
                  f"vs plain {e:.3e}{timed}", flush=True)
        db_path.unlink(missing_ok=True)
    dispatch.set_db(None)
    return launches


def paged_problem(b, sq, lengths, dtype, dev, seed):
    """Phase 6 operands: random q, new K/V and pages, a shuffled page table
    padded with the trash page (the last physical page), int32 lengths."""
    rng = np.random.default_rng(seed)
    n_phys = b * PAGED_NMAX + 1

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, dtype)

    q = f(b, sq, PAGED_H, PAGED_D)
    kn, vn = f(b, sq, PAGED_KV, PAGED_D), f(b, sq, PAGED_KV, PAGED_D)
    kp = f(n_phys, PAGED_PS, PAGED_KV, PAGED_D)
    vp = f(n_phys, PAGED_PS, PAGED_KV, PAGED_D)
    pages = rng.permutation(b * PAGED_NMAX).reshape(b, PAGED_NMAX)
    for i, n in enumerate(lengths):
        pages[i, -(-n // PAGED_PS):] = n_phys - 1
    return (q, kn, vn, kp, vp,
            torch.from_numpy(pages.astype(np.int32)).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def paged_bound(args, dtype) -> tuple:
    """(ms, "bytes" | "operations") of one paged-attention call: the valid
    cache rows of K and V, q, the new K/V and the output read or written
    once, the tables and lengths; QK and PV over the valid rows."""
    q, kn, vn, _, _, tables, lengths = args
    b, sq, h, d = q.shape
    kv = kn.shape[2]
    cap = tables.shape[1] * PAGED_PS
    rows = [min(int(n), cap) for n in lengths.tolist()]
    isz = q.element_size()
    nb = ((2 * sum(rows) * kv * d + 2 * q.numel() + kn.numel() + vn.numel())
          * isz + 4 * (tables.numel() + lengths.numel()))
    flops = sum(4 * h * d * (n + sq) * sq for n in rows)
    return bound_ms(nb, flops, dtype)


def check_paged_kernel(dev, tot):
    """Phase 6: the paged-attention kernel against its plain version at
    smollm-360m's serving shapes, with an SDPA yardstick."""
    from repro_torch.kernels.flash_attn import (paged_attention_cuda,
                                                paged_attention_ref)

    for i, (b, sq, lengths, dtype) in enumerate(PAGED_CASES):
        args = paged_problem(b, sq, lengths, dtype, dev, SEED + 20 + i)
        q, kn, vn, kp, vp, tables, lens = args
        rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
        tag = (f"B={b} Sq={sq} H={PAGED_H} KV={PAGED_KV} D={PAGED_D} "
               f"ps={PAGED_PS} n_max={PAGED_NMAX} lengths={lengths} "
               f"{str(dtype).replace('torch.', '')}")
        y_p = paged_attention_ref(*args)
        err = max_err(paged_attention_cuda(*args, page_size=PAGED_PS), y_p,
                      f"paged_attention {tag}", rtol)
        # the yardstick: K/V gathered to [B, H, n_max*ps + Sq, D] beforehand
        g = PAGED_H // PAGED_KV
        s_c = PAGED_NMAX * PAGED_PS

        def heads(cache, new):
            flat = cache[tables.long()].reshape(b, s_c, PAGED_KV, PAGED_D)
            return (torch.cat([flat, new], 1).repeat_interleave(g, dim=2)
                    .transpose(1, 2).contiguous())

        k_all, v_all = heads(kp, kn), heads(vp, vn)
        qh = q.transpose(1, 2).contiguous()
        cache_ok = (torch.arange(s_c, device=dev)[None, None, :]
                    < lens[:, None, None]).expand(b, sq, s_c)
        ar = torch.arange(sq, device=dev)
        new_ok = (ar[None, :] <= ar[:, None])[None].expand(b, sq, sq)
        mask = torch.cat([cache_ok, new_ok], -1)[:, None]
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, k_all, v_all, attn_mask=mask)
        max_err(library().transpose(1, 2), y_p, f"SDPA yardstick {tag}", rtol)
        r = measure(lambda: paged_attention_cuda(*args, page_size=PAGED_PS),
                    lambda: paged_attention_ref(*args), library)
        r["bound_ms"], by = paged_bound(args, dtype)
        report(tot, "paged_attention", tag, r, by, err, dtype,
               count=(b, sq) == (4, 1))
    return tot


LINEARS = (("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
           ("mlp", "gate"), ("mlp", "up"), ("mlp", "down"))


def pruned_smollm(dev):
    """smollm-360m at its published widths, every q/k/v/o/gate/up/down
    pruned to 50% (T = d_out), random weights from ``SEED`` on the card:
    the model phases 7 and 9 serve and score."""
    from repro_torch.configs import get_config
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.models import lm

    cfg = get_config("smollm-360m").with_(sparsity=SparsityConfig(
        sparsity=0.5, m=None, tile=None, format="compressed_pallas"))
    t0 = time.perf_counter()
    params = lm.lm_init(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    layers = params["layers"]
    check(all("values" in layers[a][n] for a, n in LINEARS),
          "every q/k/v/o/gate/up/down layer is compressed")
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
          f"(padded {cfg.padded_vocab}), f32; sparsity 0.5, T = d_out; "
          f"{n_params} stored values and indices, random from seed {SEED}, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, params


def run_serving(dev, cfg, params) -> dict:
    """Phase 7: pruned smollm-360m served at its published widths through
    ``Scheduler(paged=True, alloc="reserve")``.  Returns the launch counts
    of the served run."""
    from repro_torch import dispatch
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.kernels.colwise_nm import (colwise_nm_matmul_cuda,
                                                colwise_nm_matmul_tiled_cuda)
    from repro_torch.kernels.flash_attn import (FLASH_ATTENTION,
                                                FLASH_ATTENTION_TILED,
                                                paged_attention_cuda)
    from repro_torch.models import lm
    from repro_torch.models import registry as reg
    from repro_torch.models.blocks import layer_params
    from repro_torch.serve import (Engine, Scheduler, latency_percentiles,
                                   synthetic_trace)

    layers = params["layers"]
    db_path = PROFILE_DB.with_suffix(".serve.json")
    db_path.unlink(missing_ok=True)
    dispatch.set_db(dispatch.ProfileDB(path=db_path))
    engine = Engine(cfg, params)
    sched = Scheduler(engine, n_slots=SERVE_SLOTS, paged=True,
                      page_size=PAGED_PS, alloc="reserve")
    plan = engine.dispatch_plan
    check(all(dispatch.REGISTRY.get("linear", n).backend == "cuda"
              for n in plan.values()), f"the serving plan runs plain: {plan}")
    print(f"  dispatch plan: {len(plan)} phase-tagged linear tokens, all "
          f"{sorted(set(plan.values()))}", flush=True)
    # warm-up (not counted): the first calls load the library and fill the
    # dispatch memos
    sched.run(synthetic_trace(2, seed=SEED + 1, vocab=cfg.vocab_size,
                              prompt_lens=(8, 16), new_tokens=(2, 3)))

    steps = []  # (kind, inputs, logits) of every step of the counted run
    cache_shape = []
    prefill, decode = engine.packed_prefill_step, engine.paged_decode_step

    def rec_prefill(cache, packed, tables, *, page_size):
        cache_shape[:] = cache["k"].shape
        logits, cache = prefill(cache, packed, tables, page_size=page_size)
        steps.append(("prefill", (packed, tables.copy()), logits.clone()))
        return logits, cache

    def rec_decode(cache, tokens, pos, tables, *, page_size):
        inputs = (tokens.copy(), pos.copy(), tables.copy())
        logits, cache = decode(cache, *inputs, page_size=page_size)
        steps.append(("decode", inputs, logits.clone()))
        return logits, cache

    engine.packed_prefill_step, engine.paged_decode_step = rec_prefill, rec_decode
    trace = synthetic_trace(SERVE_REQUESTS, seed=SEED, vocab=cfg.vocab_size,
                            prompt_lens=SERVE_PROMPTS, new_tokens=SERVE_BUDGETS)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    comps = sched.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    engine.packed_prefill_step, engine.paged_decode_step = prefill, decode
    st = dict(sched.stats)

    by_uid = {c.uid: c for c in comps}
    check(sorted(by_uid) == [r.uid for r in trace], f"completions {sorted(by_uid)}")
    for r in trace:
        c = by_uid[r.uid]
        check(c.status == "ok" and c.n_generated == r.max_new_tokens
              and c.prompt_len == len(r.prompt)
              and bool((c.tokens >= 0).all() and (c.tokens < cfg.vocab_size).all()),
              f"request {r.uid}: {c.status}, {c.n_generated} of "
              f"{r.max_new_tokens} tokens")
    check(st["pages_mapped"] == 0, f"{st['pages_mapped']} pages leaked")
    n_dec, n_pre = st["decode_steps"], st["prefill_calls"]
    want = {"paged_attention": cfg.n_layers * n_dec,
            "colwise_nm_matmul_tiled": len(LINEARS) * cfg.n_layers * (n_dec + n_pre)}
    print(f"  served {len(comps)} requests (prompts {SERVE_PROMPTS}, budgets "
          f"{SERVE_BUDGETS}, {SERVE_SLOTS} slots, page size {PAGED_PS}): "
          f"{n_pre} packed prefills, {n_dec} decode steps, "
          f"{st['generated_tokens']} tokens, every request 'ok' with its whole "
          f"budget; page pool invariants hold, 0 pages mapped after the run "
          f"(peak {st['pages_peak']}, {st['pages_stranded']} stranded)",
          flush=True)
    flash = FLASH_ATTENTION.launches + FLASH_ATTENTION_TILED.launches
    print(f"  launches in the served run: {counts} (want {want}); flash "
          f"attention {flash} (it is not on the serving path)", flush=True)
    check(counts == want, f"serving launches {counts}, want {want}")
    check(flash == 0, "the served run launched flash")
    # exact counts: every attention and linear call launched its kernel, so
    # no plain version ran on the card, and colwise_nm_matmul did not run
    print("  no plain version ran: every one of the "
          f"{want['paged_attention']} attention and "
          f"{want['colwise_nm_matmul_tiled']} linear calls launched its "
          "kernel, every linear the tiled one", flush=True)

    decode_tokens = st["generated_tokens"] - len(comps)
    p50, p99 = latency_percentiles(comps)
    ttft = sorted(c.ttft_s for c in comps)
    host_step_ms = st["decode_s"] / n_dec * 1e3
    print(f"  host clock, each step synchronised by its token read: "
          f"prefill {st['prefill_s'] / n_pre * 1e3:.3f} ms per packed prefill "
          f"call; decode {host_step_ms:.3f} ms per step, "
          f"{decode_tokens / st['decode_s']:.1f} tokens/s; run {wall:.3f} s; "
          f"latency p50 {p50:.3f} s p99 {p99:.3f} s; TTFT p50 "
          f"{ttft[len(ttft) // 2]:.3f} s", flush=True)

    # teacher-forced replay: the kernel path's own inputs through the same
    # steps with the plain versions forced, on a fresh cache
    cache = reg.paged_cache_init_fn(cfg, cache_shape[1] - 1, PAGED_PS, dev)()
    reset_launch_counts()
    worst, agree, total = 0.0, 0, 0
    with dispatch.force_scope(linear="compressed_xla",
                              paged_attn="paged_attn_ref"):
        for kind, inputs, logits_k in steps:
            if kind == "prefill":
                logits_p, cache = prefill(cache, *inputs, page_size=PAGED_PS)
                live = torch.ones(logits_k.shape[0], dtype=torch.bool)
            else:
                logits_p, cache = decode(cache, *inputs, page_size=PAGED_PS)
                live = torch.from_numpy(inputs[1] > 0)  # active slots
            e = rel_err(logits_k, logits_p)
            check(e <= REPLAY_RTOL, f"{kind} step: kernel vs plain logits {e}")
            worst = max(worst, e)
            same = engine.sample(logits_k).cpu() == engine.sample(logits_p).cpu()
            agree += int(same[live].sum())
            total += int(live.sum())
    torch.cuda.synchronize()
    check(all(k.launches == 0 for k in KERNELS), "the replay launched a kernel")
    print(f"  teacher-forced replay of all {len(steps)} steps through the "
          f"plain versions (paged_attn_ref, compressed_xla): max rel err of the "
          f"logits {worst:.3e} <= {REPLAY_RTOL} of max|logit| ({cfg.n_layers} "
          f"layers of sums in another order); sampled tokens agree {agree} of "
          f"{total}",
          flush=True)

    # device time of one full-batch decode step, and its kernels alone
    full = next((x for kind, x, _ in steps if kind == "decode"
                 and bool((x[1] > 0).all())), None)
    check(full is not None, "no decode step ran with every slot active")
    tok_d, pos_d, tab_d = (torch.from_numpy(a).to(dev) for a in full)
    with dispatch.phase_scope("decode"):
        step_ms = time_ms(lambda: lm.paged_decode_step(
            params, cfg, cache, tok_d, pos_d, tab_d, PAGED_PS), iters=3)
    layer0 = layer_params(layers, 0)
    rng = np.random.default_rng(SEED + 9)
    lin_ms, old_ms = 0.0, 0.0
    d_ins = {"o": cfg.padded_heads * cfg.resolved_head_dim, "down": cfg.d_ff}
    for a, n in LINEARS:
        vals, idx = layer0[a][n]["values"], layer0[a][n]["idx"]
        d_in = d_ins.get(n, cfg.d_model)
        x = torch.from_numpy(rng.standard_normal((SERVE_SLOTS, d_in),
                                                 dtype=np.float32)).to(dev)
        lin_ms += time_ms(lambda: colwise_nm_matmul_tiled_cuda(x, vals, idx))
        old_ms += time_ms(lambda: colwise_nm_matmul_cuda(x, vals, idx))
    kc, vc = cache["k"][0], cache["v"][0]
    qd = torch.from_numpy(rng.standard_normal(
        (SERVE_SLOTS, 1, cfg.padded_heads, cfg.resolved_head_dim),
        dtype=np.float32)).to(dev)
    knd = qd[:, :, :cfg.n_kv_heads].contiguous()
    att_ms = time_ms(lambda: paged_attention_cuda(
        qd, knd, knd, kc, vc, tab_d, pos_d, page_size=PAGED_PS))
    h = torch.zeros((SERVE_SLOTS, 1, cfg.d_model), device=dev)
    unembed_ms = time_ms(lambda: lm._unembed(params, cfg, h))
    idle = max(0.0, 1 - step_ms / host_step_ms)
    print(f"  one full-batch decode step ({SERVE_SLOTS} slots, lengths "
          f"{full[1].tolist()}): device {step_ms:.4f} ms (CUDA graph replay of "
          f"lm.paged_decode_step), host {host_step_ms:.4f} ms with sampling "
          f"-> device idle share {idle:.3f}; kernels alone: "
          f"{cfg.n_layers} x {lin_ms:.4f} ms of 7 tiled linears = "
          f"{cfg.n_layers * lin_ms:.4f} ms (colwise_nm_matmul would take "
          f"{cfg.n_layers} x {old_ms:.4f} ms), {cfg.n_layers} x {att_ms:.4f} ms "
          f"of paged attention = {cfg.n_layers * att_ms:.4f} ms, unembed "
          f"{unembed_ms:.4f} ms", flush=True)
    print("SERVE " + json.dumps({
        "requests": len(comps), "prefill_calls": n_pre, "decode_steps": n_dec,
        "generated_tokens": st["generated_tokens"],
        "prefill_host_ms": st["prefill_s"] / n_pre * 1e3,
        "decode_host_ms": host_step_ms,
        "decode_tokens_per_s": decode_tokens / st["decode_s"],
        "decode_step_device_ms": step_ms, "idle_share": idle,
        "linear_ms_per_layer": lin_ms, "old_linear_ms_per_layer": old_ms,
        "paged_ms_per_layer": att_ms,
        "unembed_ms": unembed_ms, "replay_max_rel_err": worst,
        "tokens_agree": [agree, total], "latency_p50_s": p50,
        "latency_p99_s": p99, "run_s": wall}), flush=True)
    dispatch.set_db(None)
    db_path.unlink(missing_ok=True)
    return counts


def flash_bound(b, sq, sk, h, kv, d, causal, dtype) -> tuple:
    """(ms, "bytes" | "operations") of one flash call: QK and PV over the
    (causal) pairs, 4 * B*H * D per pair; Q, K, V (at KV heads) and O read
    or written once."""
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk)
    isz = torch.empty((), dtype=dtype).element_size()
    nb = (2 * b * sq * h * d + 2 * b * sk * kv * d) * isz
    return bound_ms(nb, 4 * b * h * d * pairs, dtype)


def check_flash_kernel(dev, tot):
    """Phase 8: both flash kernels against their plain version, f32 and
    bf16, with their bounds and an SDPA yardstick; the tiled kernel equal
    bit for bit to the other wherever it takes the case.  Then the public
    entry point over the same cases with the launch counts reset: each case
    must launch the kernel ``flash_tiled_takes`` routes it to.  Returns those
    counts."""
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_gqa_ref,
                                                flash_attention_scalar_cuda,
                                                flash_attention_tiled_cuda,
                                                flash_tiled_config,
                                                flash_tiled_takes)

    inputs = []
    for i, (b, sq, sk, h, kv, d, causal) in enumerate(FLASH_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(SEED + 40 + i)
            q, k, v = (torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to(dev, dtype) for shape in (
                    (b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
            tiled = flash_tiled_takes(q, k, v)
            inputs.append((q, k, v, causal, tiled))
            tag = (f"B={b} Sq={sq} Sk={sk} H={h} KV={kv} D={d} "
                   f"{'causal' if causal else 'full'} "
                   f"{str(dtype).replace('torch.', '')}")
            want = flash_attention_gqa_ref(q, k, v, causal=causal)
            y_old = flash_attention_scalar_cuda(q, k, v, causal=causal)
            err_old = max_err(y_old, want, f"flash_attention {tag}",
                              FLASH_TOL[dtype])
            library = None
            if sq == sk or not causal:
                mapping = (torch.arange(h, device=dev) * kv) // h
                qh = q.transpose(1, 2).contiguous()
                kh = k[:, :, mapping].transpose(1, 2).contiguous()
                vh = v[:, :, mapping].transpose(1, 2).contiguous()
                library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qh, kh, vh, is_causal=causal)
                max_err(library().transpose(1, 2), want,
                        f"SDPA yardstick {tag}", FLASH_TOL[dtype])
            bound, by = flash_bound(b, sq, sk, h, kv, d, causal, dtype)
            scoring = (b, sq, h) == (SCORE_BATCH, SCORE_SEQ, 15)
            plain = lambda: flash_attention_gqa_ref(q, k, v, causal=causal)  # noqa: E731
            r_old = measure(
                lambda: flash_attention_scalar_cuda(q, k, v, causal=causal),
                plain, library)
            r_old["bound_ms"] = bound
            report(tot, "flash_attention", tag, r_old, by, err_old, dtype,
                   count=scoring)
            if not tiled:
                print(f"  flash_attention_tiled {tag}: refused by the shape "
                      "rule (flash_attention.cu takes it)", flush=True)
                continue
            y_t = flash_attention_tiled_cuda(q, k, v, causal=causal)
            err = max_err(y_t, want, f"flash_attention_tiled {tag}",
                          FLASH_TOL[dtype])
            check(torch.equal(y_t, y_old), f"flash_attention_tiled {tag}: "
                  "not bit-identical to flash_attention")
            r = measure(
                lambda: flash_attention_tiled_cuda(q, k, v, causal=causal),
                plain, library)
            r["bound_ms"] = bound
            rows, rpt = flash_tiled_config(d, dtype)
            report(tot, "flash_attention_tiled", f"{tag} ({rows}x{rpt})", r,
                   by, err, dtype, count=scoring)
            if scoring:
                gflop = 4 * b * h * d * sq * (sq + 1) / 2 / 1e9
                lib = ("none" if r["library_ms"] is None
                       else f"{gflop / r['library_ms']:.2f}")
                print(f"  scoring shape {tag}: tiled {gflop / r['ms']:.2f} "
                      f"TFLOP/s, flash_attention.cu "
                      f"{gflop / r_old['ms']:.2f}, SDPA {lib} ({gflop:.2f} "
                      f"GFLOP; bound {bound:.4f} ms by {by}); tiled / SDPA "
                      f"= {r['ms'] / r['library_ms']:.3f}, tiled / old = "
                      f"{r['ms'] / r_old['ms']:.3f}; bit-identical",
                      flush=True)
    torch.cuda.synchronize()

    # the public entry point, with the counts reset just before it
    reset_launch_counts()
    want = {"flash_attention": 0, "flash_attention_tiled": 0}
    with torch.no_grad():
        for q, k, v, causal, tiled in inputs:
            flash_attention(q, k, v, causal=causal)
            want["flash_attention_tiled" if tiled else "flash_attention"] += 1
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    print(f"  ops.flash_attention over the {len(inputs)} cases: launches "
          f"{counts} (want {want}: the tiled kernel wherever the shape rule "
          "takes the case)", flush=True)
    check(counts == want, f"flash routing launches {counts}, want {want}")
    return counts


def run_scoring(dev, cfg, params) -> dict:
    """Phase 9: pruned smollm-360m scored under attn_impl="pallas" through
    ``registry.loss_fn`` and ``forward_fn``, held against a replay through
    the plain versions.  Returns the launch counts of the scored run."""
    from repro_torch import dispatch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.kernels.colwise_nm import (colwise_nm_matmul_cuda,
                                                colwise_nm_matmul_tiled_cuda)
    from repro_torch.kernels.flash_attn import (flash_attention_cuda,
                                                flash_attention_scalar_cuda)
    from repro_torch.models import lm
    from repro_torch.models import registry as reg
    from repro_torch.models.blocks import layer_params

    cfg = cfg.with_(attn_impl="pallas")
    cfg_plain = cfg.with_(attn_impl="naive")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=SCORE_BATCH,
                                  seq_len=SCORE_SEQ, kind="uniform", seed=SEED))
    batches = [{"tokens": torch.from_numpy(data.batch_at(i)["tokens"]).to(dev)}
               for i in range(SCORE_BATCHES)]
    n_tok = SCORE_BATCH * SCORE_SEQ
    db_path = PROFILE_DB.with_suffix(".score.json")
    db_path.unlink(missing_ok=True)
    dispatch.set_db(dispatch.ProfileDB(path=db_path))
    forward, loss = reg.forward_fn(cfg), reg.loss_fn(cfg)
    with torch.no_grad():
        forward(params, batches[0])  # warm-up: the dispatch memos at 8192 rows
        torch.cuda.synchronize()
        reset_launch_counts()
        outs = []
        for batch in batches:
            total, aux = loss(params, batch)
            outs.append((forward(params, batch), aux["nll"], total))
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in KERNELS if k.launches}
        n_fwd = 2 * SCORE_BATCHES
        want = {"flash_attention_tiled": cfg.n_layers * n_fwd,
                "colwise_nm_matmul_tiled": len(LINEARS) * cfg.n_layers * n_fwd}
        print(f"  launches over {n_fwd} scoring forwards ({SCORE_BATCHES} "
              f"batches x loss_fn and forward_fn): {counts} (want {want})",
              flush=True)
        check(counts == want, f"scoring launches {counts}, want {want}")
        for logits, nll, total in outs:
            check(tuple(logits.shape) == (SCORE_BATCH, SCORE_SEQ,
                                          cfg.padded_vocab),
                  f"logits shape {tuple(logits.shape)}")
            check(bool(torch.isfinite(logits).all()), "non-finite logits")
            check(bool(torch.isfinite(nll)) and float(total) == float(nll),
                  f"loss {float(total)} vs nll {float(nll)} (aux is 0)")

        # replay through the plain versions: naive attention, the
        # gather-einsum linears
        reset_launch_counts()
        worst, nll_worst, nlls = 0.0, 0.0, []
        with dispatch.force_scope(linear="compressed_xla"):
            for (logits, nll, _), batch in zip(outs, batches):
                e = rel_err(logits, reg.forward_fn(cfg_plain)(params, batch))
                _, aux_p = reg.loss_fn(cfg_plain)(params, batch)
                e_nll = abs(float(nll) - float(aux_p["nll"])) / float(aux_p["nll"])
                check(e <= REPLAY_RTOL, f"scoring logits vs plain: {e}")
                check(e_nll <= SCORE_NLL_RTOL, f"scoring NLL vs plain: {e_nll}")
                worst, nll_worst = max(worst, e), max(nll_worst, e_nll)
                nlls.append((float(nll), float(aux_p["nll"])))
        torch.cuda.synchronize()
        check(all(k.launches == 0 for k in KERNELS), "the replay launched a kernel")
        print(f"  replay through the plain versions (attn_impl='naive', "
              f"compressed_xla): max rel err of the logits {worst:.3e} <= "
              f"{REPLAY_RTOL} of max|logit|; NLL kernel/plain {nlls} (rel err "
              f"<= {nll_worst:.3e}; ln(vocab) = {np.log(cfg.vocab_size):.4f})",
              flush=True)
        got = tuple(k for k, _ in nlls)
        check(got == SCORE_NLLS, f"scoring NLLs {got}: not the "
              f"{SCORE_NLLS} of colwise_nm_matmul and flash_attention.cu on "
              "the same inputs")
        print(f"  the NLLs equal the {SCORE_NLLS} of colwise_nm_matmul and "
              "flash_attention.cu exactly", flush=True)
        del outs

        batch = batches[0]
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(params, batch)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        host_ms = min(host)
        dev_ms = time_ms(lambda: forward(params, batch), iters=1)
        rng = np.random.default_rng(SEED + 50)
        d, hd = cfg.d_model, cfg.resolved_head_dim
        q = torch.from_numpy(rng.standard_normal(
            (SCORE_BATCH, SCORE_SEQ, cfg.padded_heads, hd),
            dtype=np.float32)).to(dev)
        kv = q[:, :, :cfg.n_kv_heads].contiguous()
        flash_ms = time_ms(lambda: flash_attention_cuda(q, kv, kv), iters=5)
        old_flash_ms = time_ms(lambda: flash_attention_scalar_cuda(q, kv, kv),
                               iters=5)
        layer0 = layer_params(params["layers"], 0)
        d_ins = {"o": cfg.padded_heads * hd, "down": cfg.d_ff}
        lin_ms, old_ms = 0.0, 0.0
        for a, n in LINEARS:
            vals, idx = layer0[a][n]["values"], layer0[a][n]["idx"]
            x = torch.from_numpy(rng.standard_normal(
                (n_tok, d_ins.get(n, d)), dtype=np.float32)).to(dev)
            lin_ms += time_ms(
                lambda: colwise_nm_matmul_tiled_cuda(x, vals, idx), iters=5)
            old_ms += time_ms(lambda: colwise_nm_matmul_cuda(x, vals, idx),
                              iters=5)
        h = torch.from_numpy(rng.standard_normal(
            (SCORE_BATCH, SCORE_SEQ, d), dtype=np.float32)).to(dev)
        unembed_ms = time_ms(lambda: lm._unembed(params, cfg, h), iters=5)
    idle = max(0.0, 1 - dev_ms / host_ms)
    flash_share = cfg.n_layers * flash_ms / dev_ms
    lin_share = cfg.n_layers * lin_ms / dev_ms
    print(f"  one scoring forward ({SCORE_BATCH} x {SCORE_SEQ} tokens): host "
          f"{host_ms:.3f} ms (best of {len(host)}, synchronised; "
          f"{n_tok / host_ms * 1e3:.1f} tokens/s), device {dev_ms:.3f} ms "
          f"(CUDA graph replay) -> device idle share {idle:.3f}; kernels "
          f"alone: {cfg.n_layers} x {flash_ms:.4f} ms of flash attention = "
          f"{cfg.n_layers * flash_ms:.3f} ms ({flash_share:.3f} of the device "
          f"time; flash_attention.cu would take {cfg.n_layers} x "
          f"{old_flash_ms:.4f} ms), {cfg.n_layers} x {lin_ms:.4f} ms of 7 tiled sparse linears "
          f"= {cfg.n_layers * lin_ms:.3f} ms ({lin_share:.3f}; "
          f"colwise_nm_matmul would take {cfg.n_layers} x {old_ms:.4f} ms), "
          f"tied unembedding {unembed_ms:.3f} ms ({unembed_ms / dev_ms:.3f})",
          flush=True)
    print("SCORE " + json.dumps({
        "batch": SCORE_BATCH, "seq_len": SCORE_SEQ, "forwards": n_fwd,
        "host_ms_per_forward": host_ms, "device_ms_per_forward": dev_ms,
        "idle_share": idle, "tokens_per_s": n_tok / host_ms * 1e3,
        "flash_ms_per_layer": flash_ms, "flash_share": flash_share,
        "old_flash_ms_per_layer": old_flash_ms,
        "linear_ms_per_layer": lin_ms, "linear_share": lin_share,
        "old_linear_ms_per_layer": old_ms, "unembed_ms": unembed_ms, "replay_max_rel_err": worst,
        "nll_max_rel_err": nll_worst, "nll": nlls}), flush=True)
    dispatch.set_db(None)
    db_path.unlink(missing_ok=True)
    return counts


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch._compat import is_hopper
    from repro_torch.configs import get_vision_config
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.kernels.conv_gemm.tune import banded_tiled_registers
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
    for inst, regs, spill in flash_tiled_registers(lib.parent / "build.log"):
        print(f"  flash_attention_tiled {inst}: {regs} registers, {spill}",
              flush=True)
    for inst, regs, spill in banded_tiled_registers(lib.parent / "build.log"):
        print(f"  conv2d_fused_banded_tiled {inst}: {regs} registers, {spill}",
              flush=True)

    cfg = get_vision_config("resnet-tiny")
    params = vision_init(cfg, SEED, device=dev)

    print(f"== 3. kernels at the main path's shapes (batch {BATCH})", flush=True)
    for name, call in LIBRARY_CALLS.items():
        print(f"  library_ms of {name}: {call}", flush=True)
    tot, banded_route = check_kernels(params, cfg, dev)
    check_linear_kernel(dev, tot)
    sweep_linear_kernels(dev)

    print(f"== 4. main path: resnet-tiny inference, batch {BATCH}", flush=True)
    counts = run_main_path(params, cfg, dev)

    print(f"== 5. compressed linear layers through dispatch, {LINEAR_ROWS} rows",
          flush=True)
    linear_launches = run_linear_path(dev)

    print("== 6. paged-attention kernel at the serving shapes", flush=True)
    print(f"  library_ms of paged_attention: {LIBRARY_CALLS['paged_attention']}",
          flush=True)
    check_paged_kernel(dev, tot)

    print(f"== 7. serving: pruned smollm-360m, {SERVE_REQUESTS} requests "
          "through Scheduler(paged=True)", flush=True)
    lm_cfg, lm_params = pruned_smollm(dev)
    serve_counts = run_serving(dev, lm_cfg, lm_params)

    print("== 8. flash-attention kernel at the sweep and scoring shapes",
          flush=True)
    for name in ("flash_attention", "flash_attention_tiled"):
        print(f"  library_ms of {name}: {LIBRARY_CALLS[name]}", flush=True)
    flash_route = check_flash_kernel(dev, tot)

    print(f"== 9. scoring: pruned smollm-360m, attn_impl='pallas', "
          f"{SCORE_BATCHES} batches of {SCORE_BATCH} x {SCORE_SEQ} tokens",
          flush=True)
    score_counts = run_scoring(dev, lm_cfg, lm_params)

    print("== 10. report", flush=True)
    launches = {
        "conv2d_fused": counts["default"]["conv2d_fused"],
        "im2col_pack": counts["im2col_sparse_pallas"]["im2col_pack"],
        "colwise_nm_matmul_strips":
            counts["im2col_sparse_pallas"]["colwise_nm_matmul_strips"],
        "conv2d_fused_banded": banded_route["conv2d_fused_banded"],
        "conv2d_fused_banded_tiled":
            counts["fused_banded_pallas"]["conv2d_fused_banded_tiled"],
        "colwise_nm_matmul_strips_pipelined":
            counts["two_kernel_pipelined"]["colwise_nm_matmul_strips_pipelined"],
        "colwise_nm_matmul": linear_launches["colwise_nm_matmul"],
        "paged_attention": serve_counts["paged_attention"],
        "flash_attention": flash_route["flash_attention"],
        "colwise_nm_matmul_tiled": serve_counts["colwise_nm_matmul_tiled"],
        "flash_attention_tiled": score_counts["flash_attention_tiled"],
    }
    print(f"  the linear phase (5) launched {linear_launches}; the served run "
          f"colwise_nm_matmul_tiled {launches['colwise_nm_matmul_tiled']} times "
          f"and the scored run {score_counts['colwise_nm_matmul_tiled']}",
          flush=True)
    check(all(launches.values()), f"a kernel was not launched: {launches}")
    per = {"colwise_nm_matmul": "ms etc.: sum over the 960->2560 and "
                                "2560->960 layers at 256 rows (T = d_out); "
                                "launches: the linear phase (5), tiles 8 and "
                                "12 and any profiled winner",
           "colwise_nm_matmul_tiled": "ms etc.: sum over the 960->2560 and "
                                      "2560->960 layers at 256 rows (T = "
                                      "d_out); launches: the served "
                                      "smollm-360m run (7 per layer per step)",
           "paged_attention": "ms etc.: B 4, Sq 1, f32, H 15, KV 5, D 64, "
                              "page size 16 (the decode step's shape); "
                              "launches: the served smollm-360m run (1 per "
                              "layer per decode step)",
           "flash_attention": "ms etc.: B 4, S 2048, H 15, KV 5, D 64, "
                              "causal, f32 (the scoring forward's shape, "
                              "where it is the tiled kernel's bitwise "
                              "yardstick); launches: ops.flash_attention "
                              "over phase 8's cases, the D 18 heads the "
                              "tiled kernel refuses",
           "flash_attention_tiled": "ms etc.: B 4, S 2048, H 15, KV 5, D "
                                    "64, causal, f32 (the scoring forward's "
                                    "shape); launches: the scored "
                                    "smollm-360m run (1 per layer per "
                                    "forward)",
           "conv2d_fused_banded": "ms etc.: sum over the 5 pruned convs of "
                                  "one batch-256 forward, called directly "
                                  "(the tiled kernel's bitwise yardstick); "
                                  "launches: conv2d_fused_banded_cuda over "
                                  "phase 3's six cases and a misaligned "
                                  "view, the view the rule refuses",
           "conv2d_fused_banded_tiled": "ms etc.: sum over the 5 pruned convs "
                                        "of one batch-256 forward; launches: "
                                        "the forced banded plan (5 per "
                                        "forward, x3)"}
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
