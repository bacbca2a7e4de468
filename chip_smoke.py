#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Phases:
  1. card   : name and power limit (nvidia-smi); TF32 off for the references
  2. build  : the hand-written kernels from src/repro_torch/csrc (nvcc, one
              process per source, all started together); the registers and
              spills of the tiled flash, tiled banded, tiled fused,
              tiled strip-GEMM, tiled pack and split paged instances
  3. kernels: each kernel against its plain PyTorch version at the main
              path's shapes: the five pruned-conv shapes of resnet-tiny at
              batch 256 (f32, and one bf16 case) for the conv kernels (both
              fused kernels and both banded kernels equal bit for bit to
              each other, timed per conv beside F.conv2d, then
              conv2d_fused_banded_cuda and conv2d_fused_cuda over the six
              cases and a case each rule refuses, each launching the kernel
              the shape rule picks, then the tiled banded kernel's
              tile-group path at ResNet-18 layer2's conv and the tiled
              fused kernel at ResNet-18 layer3's and layer4's in f32 and
              bf16, bit for bit against conv2d_fused.cu, beside cuDNN and
              the two-kernel plans); both pack kernels (im2col_pack.cu and
              im2col_pack_tiled.cu) equal bit for bit to each other and to
              the plain versions on the six cases, also on a map of NaN
              payloads and -0.0, timed beside F.unfold and the bound (warm
              and with L2 flushed), then im2col_pack_cuda over the six
              cases and strips of 6, each launching the kernel the shape
              rule picks, and both at ResNet-18 layer1-4 (f32, bf16); and
              smollm-360m's MLP widths (960 -> 2560, 2560 -> 960) at 256
              rows for the two sparse linear kernels, the tiled one (T a
              multiple of 64) equal bit for bit to the other (f32, bf16);
              kernel, plain-version and library-call times beside each
              kernel's bound; then both linear kernels timed at 4, 256 and
              8192 rows beside their bound, plain version and torch.matmul
  4. main   : pruned resnet-tiny inference through ``vision_apply`` at batch
              256: (a) the default plan with an empty profile DB (the
              fused family: the tiled fused kernel for every conv), (b) the
              plan ``plan_params(profile=True)`` races on the card, with every
              candidate's device time per layer, profiled again to see
              whether the winners hold, (c) the forward forced under each
              conv family (the fused, banded and strip-GEMM families
              launch, per conv, the kernel the shape rule picks); launch
              counts, logits held against a dense
              reference, the masked -> compressed tree check, forward times,
              the profiled forward counted by the op counter
              (``roofline.count``) through the kernels and through the plain
              versions (FLOPs, bytes and each kernel family's work equal;
              the counted t_bound beside the device ms), and the host cost
              of the dispatch lookup per conv call
  5. linear : compressed linear layers (serving's sparsity config, tile 8
              and tile 12) through ``linear_apply``'s dispatch, by the
              heuristic (the tiled kernel for T = d_out, the other for tiles
              8 and 12) and by a profile racing both families, against the
              plain version
  6. paged  : both paged-attention kernels against their plain version at
              smollm-360m's serving shapes (H 15, KV 5, D 64, page size 16;
              B 4 and 8; ragged lengths with 0, one page and a ragged last
              page; shuffled page ids, trash-padded tables; one Sq 4 and one
              bf16 case), the split kernel also against paged_attention.cu,
              each timed beside its bound, the plain version and an SDPA
              yardstick; then ``paged_attention_cuda`` over the cases and
              one with 24 query rows a KV head (Sq 8), each launching the
              kernel the shape rule picks (4 split, 1 paged_attention.cu)
  7. serve  : pruned smollm-360m at its published widths (32 layers, random
              weights from the seed) served through ``Scheduler(paged=True)``:
              8 synthetic requests, greedy; request, page-pool and
              launch-count checks (every attention through the split paged
              kernel, every linear through the tiled kernel; the other
              linear and paged kernels and flash launched 0 times), a
              teacher-forced replay of every step through the plain
              versions, host times per step and the device time of one
              decode step, that step counted through the kernels and through
              the plain versions as in phase 4 (t_bound beside it), with
              both linear and both paged kernels timed at its shapes
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
 10. train  : pruned resnet-tiny finetuned at batch 256 through
              ``train_step`` (SGD with momentum; the autograd twins of the
              sparse conv and linear): 3 steps under the default plan, the
              profiled plan and each conv family forced; launches per
              forward equal to phase 4's (the backward launches none),
              losses, parameters and momentum held against the same steps
              through the plain versions on the CPU and against a dense
              masked step on the card (F.conv2d), two runs equal bit for
              bit; host and device ms a step (torch.profiler), idle share,
              the forward kernels' share, beside the dense step; the convs'
              backward with the repeatable scatter and with index_add_
 11. tier   : the training tier: (a) resnet-tiny's ``SparseTrainer`` at
              batch 256 under the default plan, 6 steps with a checkpoint
              a step (step 1's loss bit-equal to phase 10's, 5 tiled-fused
              launches a step); (b) the same run in child processes,
              killed by SIGKILL after step 3's checkpoint and restarted,
              then ended by SIGTERM and restarted: both end bit-equal to
              (a), with no tmp.* left and every kept directory deep-valid;
              (c) the LM ``Trainer`` on pruned smollm-360m at its published
              widths, 4 AdamW steps on 4 x 256 uniform tokens under naive
              attention (224 tiled-linear launches a step; step 1 against
              a replay through the plain versions), its 2.5 GB checkpoint
              restored bit for bit by a fresh trainer; host and device ms
              a step and idle share of both trainers
 12. serve  : the rest of serving on the same pruned smollm-360m:
              ``Engine.generate``, the contiguous ``Scheduler`` and the
              paged ``alloc="grow"`` one (a pool that forces a preemption)
              on 4 prompts of 128 tokens, 32 new tokens each, greedy:
              exact launch counts (224 tiled-linear launches a prefill,
              prefill chunk and contiguous decode step; 224 and 32
              split-paged a paged decode step; no flash), the tokens
              equal across the three runs or a near-tie where one departs,
              a teacher-forced replay of generate's and the contiguous
              run's steps through the plain versions, host and device ms
              a contiguous and a paged decode step, a cancel, a deadline
              and a drain, temperature draws against softmax(logits / T),
              and ``launch.serve.main`` static and continuous paged grow
 13. chaos  : faults injected through the port's fault sites, on the card:
              (a) resnet-tiny's default-plan forward at batch 256 with the
              fused family's first run faulted (dispatch.execute): one
              quarantine, every conv on another hand-written family, the
              logits within 1e-4 of phase 4's, and the tiled fused kernel
              back after clear_quarantine(); (b) phase 12's grow run under
              scheduler.iter:p=0.05,page_pool.alloc:n=1 with obs on: every
              request terminal, no page leaked, the survivors' tokens equal
              to phase 12's, iter_faults equal to the plan's, a trace that
              validates with one serve.iter span per iteration run and one
              fault.inject per injection; the probes a decode step makes;
              a paged decode step's host ms with obs off and on; the
              serving launcher with --faults and --trace; (c) phase 5's
              960 -> 2560 layer at 4 rows with its tiled kernel faulted:
              the retry on colwise_nm_linear.cu bit-equal, or a raise, never
              a plain candidate; (d) the SparseTrainer of phase 11a faulted
              at step 3 and resumed bit-equal to 11a, and a ckpt.rename
              fault whose orphaned tmp.* the next run collects; then the
              host cost of maybe_fail, span, instant and a metric update
              with everything off, under 1% of a contiguous decode step
 14. zoo    : the dense LM zoo: pruned qwen2-7b and nemotron-4-15b (sparsity
              0.5, T = d_out) at their published widths, the full padded
              vocab and the untied unembedding, 2 layers each, and pruned
              qwen2-0.5b whole, random weights from the seed: each served
              through ``Scheduler(paged=True)`` (4 requests of 64 prompt
              tokens, 8 new, greedy; exact launch counts: one tiled linear a
              linear a layer a step, one split paged attention a layer a
              decode step; a teacher-forced replay of every step through the
              plain versions) and scored once on 2 x 512 tokens under
              attn_impl="pallas" (one tiled flash a layer, the NLL against
              the plain replay); ``Tuner.tune(profile=True)`` at 960 -> 2560,
              each tile timed on the kernel it routes to; the twins of the
              four JAX examples at the JAX sizes (conv_pipeline against its
              dense oracle, quickstart's 120 steps, prune_and_finetune's
              compressed forward against the masked one, serve_pruned at
              0, 50% and 75%), each kernel launch counted; init, host and
              device seconds
 15. moe    : the MoE family: pruned olmoe-1b-7b whole (16 layers) and
              moonshot-v1-16b-a3b at its published widths cut to 2 layers
              (sparsity 0.5, T = d_out, the full padded vocab), random
              weights from the seed: each served through
              ``Scheduler(paged=True)`` (4 requests of 64 prompt tokens, 8
              new, greedy) and ``Engine.generate`` (prefill and the
              contiguous decode step) on the same prompts, with exact launch
              counts (4 tiled linears a layer a step, one split paged
              attention a layer a paged decode step; the experts run as the
              JAX package's XLA path does, no kernel), the assignments each
              prefill dropped (none in a decode step), a teacher-forced
              replay of every step through the plain versions; and scored
              once on 2 x 512 tokens under attn_impl="pallas" (one tiled
              flash a layer; NLL and aux against the plain replay).  The
              router is wrapped (``RouteLog``) and each replay is held row
              by row: a request's first token routed apart from the
              replay's must be a near-tie (its top k + 1 probabilities
              within 1e-5 of a neighbour), and only the logits rows of a
              request so routed apart are exempt.  Init s, a paged decode
              step's host and device ms, idle share, the experts' and the
              attention linears' shares of its device kernel time
              (torch.profiler, each kernel counted once, within 0.8-1.25x
              of the step's graph replay) and the peak device memory
 16. recur. : the recurrent families: colwise_nm_linear.cu (#1a) at
              zamba2-7b's in_proj (3584 -> 14576, T = 14576, which no
              multiple of 64 divides) at 4 and 1024 rows against its plain
              version, timed beside torch.matmul and its bound; then pruned
              xlstm-350m whole (24 layers) and zamba2-7b at its published
              widths cut to 15 layers (2 superblocks of 6 Mamba2 layers and
              the shared block, a tail of 3), sparsity 0.5, T = d_out, the
              full padded vocab, random weights from the seed: each served
              by ``Engine.generate`` (4 prompts of 64 tokens, 8 new,
              greedy; the prefill is 64 decode steps into the state cache)
              with exact launch counts (xlstm-350m 111 #1b a token step;
              zamba2-7b 15 #1a and 31 #1b), every linear launch held
              against its plain version on its own input (LinearCheck), a
              teacher-forced replay of every step through the plain
              versions (zamba2-7b: tokens equal, logits within 1e-3 of
              max|logit|; xlstm-350m, whose random weights amplify
              rounding through its depth: measured beside the same replay
              on the CPU; then cuts of the same tree served
              again by ``generate``: its first 16 layers, 74 #1b a token
              step, tokens held and logits measured beside the CPU's plain
              versions (two float orders of the plain version part there
              by a few 1e-3) and beside controls, the plain replay under
              Gaussian noise of the kernel's rms error a launch (three
              fresh draws and one drawn once a linear and repeated) and of
              the CPU order's, and held within 2x the farthest
              kernel-sized one, and its first 8, 37 #1b a token step, held:
              logits within 1e-3 of max|logit|, tokens equal), and scored once on 2 x 512 tokens
              under attn_impl="pallas" (the same linears a forward, and
              zamba2-7b 2 tiled flash; NLL within 1e-4 of the plain
              replay).  Init s, a decode step's host and device ms, idle
              share, the shares of its device kernel time taken by #1a, #1b
              and the blocks' plain scan code (torch.profiler), and the peak
              device memory
 17. encdec/vlm: the encoder-decoder and VLM families: the tiled flash
              kernel (#7b) non-causal at whisper-small's encoder attention
              (B 2, S 1500, 12 heads of 64, f32) against its plain version
              and bit for bit against flash_attention.cu, timed beside SDPA
              (is_causal=False) and its bound; pruned whisper-small whole
              (12 encoder and 12 decoder layers) and qwen2-vl-72b at its
              published widths cut to 2 layers (sparsity 0.5, T = d_out, the
              full padded vocab), random weights from the seed: whisper
              served by ``Engine.generate`` (4 prompts of 8 tokens, 32 new,
              greedy, 1500 frames in ``extras``; 192 #1b a prefill, 96 a
              decode step) and scored once on 2 x 448 tokens under
              attn_impl="pallas" (192 #1b and 24 #7b a forward, the
              encoder's 12 non-causal); qwen2-vl-72b served through
              ``Scheduler(paged=True)`` and ``Engine.generate`` on the same 4
              prompts of 64 tokens, 8 new (14 #1b a step, 2 #8b a paged
              decode step; tokens equal across the two or a near-tie), and
              scored on 2 x 512 tokens with 256 vision patches at Qwen2-VL
              3-D positions (2 #7b a forward); every generate's linear
              launch held against its plain version on its own input
              (LinearCheck), a teacher-forced replay of every step through
              the plain versions, the NLL against the plain replay; init s,
              a decode step's host and device ms, idle share and the peak
              device memory
 18. moe train: (a) ``make_train_step`` on olmoe-1b-7b at its published
              widths, pruned 50% (T = d_out), cut to 8 of its 16 layers
              (phase 15's tree, its layer stacks sliced on the card: nothing
              drawn again), 3 AdamW steps on 2 x 256 uniform tokens: step 1
              against the same step through the plain versions on the card
              (loss, aux and grad norm within 1e-4 relative, params within
              1e-4; the plain step launches nothing), aux > 0 and a finite
              grad norm (so every gradient is finite), two runs of step 1
              equal (a digest of every leaf's bits), exactly 32 #1b each
              step and each run of step 1 (q, k, v, o of 8 layers; the
              experts and the backward launch none) and no flash; host and
              device ms a step, idle share, peak device memory; step 1 again
              with remat=True (loss within 1e-6, grad norm within 1e-5 of
              step 1, the recompute through the autograd twins); (b) the LM
              ``Trainer`` on a 2-layer cut of the same tree: 4 steps, a run
              to step 2 with its checkpoint, and a Trainer restored from it
              repeats steps 3 and 4 bit for bit; (c) on a world-1 NCCL group
              (``make_host_mesh("cuda")``), (b)'s step under the
              ``ShardingCtx`` with ``moe_impl="shard_map"`` equal bit for
              bit to the step without, and the train launcher with ``--smoke
              --mesh host``; (d) pruned smollm-360m whole with
              ``shard_local_reduce``: its o and down projections in the
              REDUCE format (plain gather + einsum), scored on 2 x 512
              tokens, 160 #1b a forward (5 of the 7 linears of 32 layers),
              the NLL within 1e-4 of the plain replay, which launches
              nothing.  The train launches reported are those counted
 19. contracts: (a) the port's checker (``repro_torch.analysis``) in
              process over ``src/repro_torch`` and its ``csrc/``, with the
              committed (empty) baseline: zero findings, its seconds; (b)
              the on-card half of DP301/DP302: for every CUDA candidate of
              the dispatch registry and every small probe key its
              ``feasible`` admits, one call of the key's shapes through
              dispatch, forced to the candidate (``force_scope``; a paged
              key at Sq 1 and at Sq = min(bq, its rows)), held against its
              plain version (1e-4 / 2e-2 of max|y|, f32 / bf16), launching
              exactly the kernel the checker names, its
              ``last_smem_bytes`` equal to the checker's count and at most
              the registry's ``smem_bytes(key)`` (kernels that size their
              own shared memory keep no ``last_smem_bytes``; their count is
              checked on the CPU only), and every over-budget probe key
              refused by ``feasible`` with no launch; the launches of each
              kernel; (c) ``ring_allgather_matmul`` (x [256, 1024] by w
              [1024, 512]) and ``crosspod_psum_compressed`` on CUDA tensors
              over a world-1 NCCL group (``make_host_mesh``): y equal to x
              @ w, the reduction equal to the rank's own dequantized part.
              At world size 1 nothing crosses a link: (c) shows only that
              the code runs on the card with NCCL, no traffic between cards
 20. layout : pruned smollm-360m whole at its published widths with
              cfg.tp 2 (16 q heads, one zero-padded), its params laid out
              (``launch.steps.distribute_tree``) on worlds of 2 ranks
              (model 2) and 4 (data 2 x model 2), child processes on the
              one card joined by gloo: (a) scored on 2 x 512 tokens under
              attn_impl="pallas", prefilled on 4 x 128 and 8 greedy decode
              steps on each rank's shards, each rank's global logits within
              1e-5 of max|logit| of the same calls on whole params in this
              process, the NLL within 1e-6, the tokens equal, the launches
              exact (#1b for q, gate, up, o, down, #1a for k and v on 160
              columns, #7b on the rank's heads); (b) the same with
              shard_local_reduce, one REDUCE group a model rank, within
              1e-5 too (at model 2 the all-reduce adds the two groups'
              partial products, the whole run's einsum sums both in one
              product); (c) #1b on a rank's 512 q columns,
              #1a on its 160 k columns and #7b on its heads, each
              torch.equal to the same part of the whole launch; (d) each
              rank's local param bytes against the whole model's and (a)'s
              device ms for a prefill and a decode step (CUDA events; gloo
              stages every collective through the host, so these are a
              layout check, not tensor-parallel speed); and in the data 2 x
              model 2 world, on the same shards, training under naive
              attention on 2 x 256 uniform tokens: the LM ``Trainer`` runs
              step 1 and rank 0 alone writes its checkpoint (the trees
              gathered whole), ``make_train_step`` runs step 2, and a new
              ``Trainer`` restores the checkpoint and repeats step 2 bit
              for bit; loss and grad_norm within 1e-5 of
              ``make_train_step`` on whole params in this process, each
              rank's params within the CPU tests' bound shard by shard,
              the launches a rank a step exact (#1b 5 a layer, #1a 2), no
              temporary directory and no card memory left behind; host
              and device ms a step, local param and optimizer-state bytes
 21. report : one ``{"kernels": [...]}`` line (launches in the main runs and
              phases 19 and 20, ``train_launches`` in phases 10, 11, 13, 14,
              18 and 20 (d)), then the ``{"ok": true, ...}`` line last

Run from the repository root:  python3 chip_smoke.py
Any failed check raises, so the script exits non-zero and prints no ok line.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.roofline.kernels import (  # noqa: E402
    bound_ms, conv_work, flash_work, linear_work, pack_work, paged_work,
    strips_work)

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
# a call the split kernel's rule refuses: 3 x 8 = 24 query rows a KV head
PAGED_REFUSED = (4, 8, [31, 0, 16, 100], torch.float32)
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
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.conv_gemm import (
        CONV2D_FUSED, CONV2D_FUSED_BANDED, CONV2D_FUSED_BANDED_TILED,
        CONV2D_FUSED_TILED, banded_tiled_geometry, banded_tiled_takes,
        conv2d_fused_banded_cuda, conv2d_fused_banded_ref,
        conv2d_fused_banded_scalar_cuda, conv2d_fused_banded_tiled_cuda,
        conv2d_fused_banded_tiled_ref, conv2d_fused_cuda, conv2d_fused_ref,
        conv2d_fused_scalar_cuda, conv2d_fused_tiled_cuda,
        conv2d_fused_tiled_ref, fused_tiled_geometry, fused_tiled_takes)
    from repro_torch.kernels.im2col_pack import out_size
    from repro_torch.core.formats import ColwiseMeta, unpack_colwise

    rng = np.random.default_rng(SEED)
    tot = {}
    routed = []  # (x, values, idx, geometry) of each case, for the routing run
    packs = []  # (x, geometry, strips) of each case, for the pack's routing run
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
        isz = x.element_size()
        geo = dict(kh=kh, kw=kw, stride=stride, pad=pad)
        rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
        tag = f"{name} {str(dtype).replace('torch.', '')} C={c} {h}x{w} " \
              f"k{kh} s{stride} p{pad} k_kept={k_kept}"
        w_dense = unpack_colwise(values, idx, ColwiseMeta(
            k_rows, o, tile, k_rows, k_kept)).T.contiguous()  # [O, K]
        w_oihw = w_dense.reshape(o, kh, kw, c).permute(0, 3, 1, 2).contiguous()
        x_nchw = x.permute(1, 0, 2, 3).contiguous()
        work = conv_work(x, values, idx, **geo)
        flops = work.flops
        library_conv = lambda: F.conv2d(x_nchw, w_oihw, stride=stride,  # noqa: E731
                                        padding=pad)

        # both fused convs: conv2d_fused.cu called directly (the rule gives
        # every case here to the tiled kernel), then the tiled one, which
        # must give the same bits; then the banded ones, which must too
        y_k = conv2d_fused_scalar_cuda(x, values, idx, **geo)
        y_p = conv2d_fused_ref(x, values, idx, **geo)
        err = max_err(y_k, y_p, f"conv2d_fused {tag}", rtol)
        r_old = measure(lambda: conv2d_fused_scalar_cuda(x, values, idx, **geo),
                        lambda: conv2d_fused_ref(x, values, idx, **geo),
                        library_conv)
        r_old["bound_ms"], by = bound_ms(work, dtype)
        report(tot, "conv2d_fused", tag, r_old, by, err, dtype)

        check(fused_tiled_takes(x, values, **geo),
              f"{tag}: the tiled fused kernel refuses a main-path conv")
        y_f = conv2d_fused_tiled_cuda(x, values, idx, **geo)
        err = max_err(y_f, conv2d_fused_tiled_ref(x, values, idx, **geo),
                      f"conv2d_fused_tiled {tag}", rtol)
        check(torch.equal(y_f, y_k), f"conv2d_fused_tiled {tag}: not "
              "bit-identical to conv2d_fused")
        r = measure(lambda: conv2d_fused_tiled_cuda(x, values, idx, **geo),
                    lambda: conv2d_fused_tiled_ref(x, values, idx, **geo),
                    library_conv)
        r["bound_ms"], by = bound_ms(work, dtype)
        report(tot, "conv2d_fused_tiled", tag, r, by, err, dtype)
        gf = flops / 1e6  # GFLOP/s = flops / 1e9 / (ms / 1e3)
        fg = fused_tiled_geometry(c, BATCH, h, w, kh, kw, stride, pad, 128,
                                  n_tiles, k_kept, tile, isz)
        print(f"  fused {tag}: tiled (CPT={fg['cpt']} G={fg['group']} "
              f"BK={fg['bk']}) "
              f"{r['ms']:.5f} ms ({gf / r['ms']:.1f} GFLOP/s), conv2d_fused "
              f"{r_old['ms']:.5f} ms ({gf / r_old['ms']:.1f}), F.conv2d "
              f"{r['library_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms; tiled "
              f"{r_old['ms'] / r['ms']:.2f}x faster than the other, "
              f"{r['library_ms'] / r['ms']:.2f}x cuDNN's speed; bit-identical",
              flush=True)

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
        r_old["bound_ms"], by = bound_ms(work, dtype)
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
        check(torch.equal(y_f, y_t), f"conv2d_fused_tiled {tag}: not "
              "bit-identical to conv2d_fused_banded_tiled")
        r = measure(
            lambda: conv2d_fused_banded_tiled_cuda(x, values, idx, hb=HB, **geo),
            lambda: conv2d_fused_banded_tiled_ref(x, values, idx, hb=HB, **geo),
            library_conv)
        r["bound_ms"], by = bound_ms(work, dtype)
        report(tot, "conv2d_fused_banded_tiled", tag, r, by, err, dtype)
        print(f"  banded {tag}: tiled {r['ms']:.5f} ms ({gf / r['ms']:.1f} "
              f"GFLOP/s), conv2d_fused_banded {r_old['ms']:.5f} ms "
              f"({gf / r_old['ms']:.1f}), F.conv2d {r['library_ms']:.5f} ms "
              f"({gf / r['library_ms']:.1f}), bound {r['bound_ms']:.6f} ms; "
              f"tiled {r_old['ms'] / r['ms']:.2f}x faster than the other, "
              f"{r['library_ms'] / r['ms']:.2f}x cuDNN's speed; bit-identical",
              flush=True)
        routed.append((x, values, idx, geo))

        packs.append((x, geo, check_pack(x, geo, tag, tot)))

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

    # the fused routing rule over the six cases and a misaligned view of the
    # first case's values (the tiled kernel copies a kept row's values by 16
    # bytes): the tiled kernel takes the six, conv2d_fused.cu the view
    flat = torch.empty(v0.numel() + 1, dtype=v0.dtype, device=dev)
    v_mis = flat[1:].view(v0.shape)
    v_mis.copy_(v0)
    check(not fused_tiled_takes(x0, v_mis, **geo0),
          "the fused rule takes misaligned values")
    want = [conv2d_fused_scalar_cuda(x, vv, ii, **g) for x, vv, ii, g in routed]
    torch.cuda.synchronize()
    reset_launch_counts()
    got = [conv2d_fused_cuda(x, vv, ii, **g) for x, vv, ii, g in routed]
    got.append(conv2d_fused_cuda(x0, v_mis, i0, **geo0))
    torch.cuda.synchronize()
    fused_route = {"conv2d_fused_tiled": CONV2D_FUSED_TILED.launches,
                   "conv2d_fused": CONV2D_FUSED.launches}
    check(fused_route == {"conv2d_fused_tiled": len(routed),
                          "conv2d_fused": 1},
          f"conv2d_fused_cuda launched {fused_route}")
    check(all(torch.equal(g, w) for g, w in zip(got, want + want[:1])),
          "the routed fused convs are not the bits of conv2d_fused.cu")
    print(f"  conv2d_fused_cuda over the {len(routed)} cases and a misaligned "
          f"view of the values: launches {fused_route}; bit-identical",
          flush=True)
    pack_route = route_packs(packs)

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
    check(torch.equal(y2, conv2d_fused_scalar_cuda(x2, v2, i2, **g2)),
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
    check_pack_resnet18(rng, dev)
    check_fused_resnet18(rng, dev)
    return tot, route, fused_route, pack_route


def bits_of(t: torch.Tensor) -> torch.Tensor:
    """The element bits of a f32 or bf16 tensor, as integers: NaN payloads
    and -0.0 compare as what they are."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def with_specials(x: torch.Tensor) -> torch.Tensor:
    """``x`` with NaNs of several payloads (quiet and signalling, both
    signs) and -0.0 spread over it, as element bits."""
    specials = ([0x7FC01234, 0x7F800001, -0x3FE0000, -0x80000000]
                if x.element_size() == 4 else [0x7FC3, 0x7F81, -0x7E, -0x8000])
    flat = bits_of(x).clone().reshape(-1)
    for i, b in enumerate(specials):
        flat[i::7] = b
    return flat.view(x.dtype).reshape(x.shape)


def check_pack(x, geo, tag, tot):
    """Phase 3, both pack kernels at one main-path conv (V 128):
    im2col_pack.cu called directly (the rule gives every main-path conv to
    the tiled kernel), then the tiled kernel, each equal bit for bit to the
    plain versions and to each other, also on a map of NaN payloads and
    -0.0; each timed beside F.unfold and the bound, and with L2 flushed
    before each call.  Returns the strips."""
    from repro_torch.kernels.im2col_pack import (
        im2col_pack_ref, im2col_pack_scalar_cuda, im2col_pack_tiled_cuda,
        im2col_pack_tiled_ref, im2col_tiled_geometry, im2col_tiled_takes)
    from repro_torch.kernels.im2col_pack.tune import cold_us

    c, b, h, w = x.shape
    args = (x, geo["kh"], geo["kw"], geo["stride"], geo["pad"], 128)
    check(im2col_tiled_takes(*args),
          f"{tag}: the tiled pack refuses a main-path conv")
    ig = im2col_tiled_geometry(c, b, h, w, *args[1:], x.element_size())
    scalar = lambda: im2col_pack_scalar_cuda(*args)  # noqa: E731
    plain = lambda: im2col_pack_ref(*args)  # noqa: E731
    tiled = lambda: im2col_pack_tiled_cuda(*args)  # noqa: E731
    tiled_plain = lambda: im2col_pack_tiled_ref(  # noqa: E731
        *args, cb=ig["cb"], tg=ig["tg"])
    for label, xx in (("", x), (" (NaN payloads, -0.0)", with_specials(x))):
        got = [bits_of(f(xx, *args[1:])) for f in (
            im2col_pack_scalar_cuda, im2col_pack_tiled_cuda, im2col_pack_ref,
            lambda *a: im2col_pack_tiled_ref(*a, cb=ig["cb"], tg=ig["tg"]))]
        torch.cuda.synchronize()
        check(all(torch.equal(g, got[0]) for g in got[1:]),
              f"im2col_pack(_tiled) {tag}{label}: the two kernels and the "
              "plain versions are not bit for bit the same")
    strips = tiled()
    work = pack_work(x, geo["kh"], geo["kw"], geo["stride"], geo["pad"], 128)
    unfold = lambda: F.unfold(  # noqa: E731
        x.permute(1, 0, 2, 3).contiguous(), (geo["kh"], geo["kw"]),
        padding=geo["pad"], stride=geo["stride"])
    r_old = measure(scalar, plain, unfold)
    r_old["bound_ms"], by = bound_ms(work, x.dtype)
    report(tot, "im2col_pack", tag, r_old, by, 0.0, x.dtype)
    r = measure(tiled, tiled_plain, unfold)
    r["bound_ms"], by = bound_ms(work, x.dtype)
    report(tot, "im2col_pack_tiled", tag, r, by, 0.0, x.dtype)
    dev = x.device
    cold, cold_old = cold_us(tiled, dev) / 1e3, cold_us(scalar, dev) / 1e3
    print(f"  pack {tag}: tiled (cb={ig['cb']} tg={ig['tg']} "
          f"U={ig['unroll']}, {ig['blocks']} blocks of {ig['threads']}) "
          f"{r['ms']:.5f} ms ({cold:.5f} with L2 flushed), im2col_pack.cu "
          f"{r_old['ms']:.5f} ms ({cold_old:.5f}), F.unfold "
          f"{r['library_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms; tiled "
          f"{r_old['ms'] / r['ms']:.2f}x faster than the other, "
          f"{r['bound_ms'] / r['ms']:.2f} of its bound; bit-identical",
          flush=True)
    return strips


def route_packs(packs) -> dict:
    """Phase 3, the pack's routing rule over the six cases and a strip
    width it refuses (6): the tiled kernel takes the six, im2col_pack.cu the
    narrow one; every result the bits of im2col_pack.cu."""
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.im2col_pack import (
        IM2COL_PACK, IM2COL_PACK_TILED, im2col_pack_cuda,
        im2col_pack_scalar_cuda, im2col_tiled_takes)

    x0, g0, _ = packs[0]
    narrow = (x0, g0["kh"], g0["kw"], g0["stride"], g0["pad"], 6)
    check(not im2col_tiled_takes(*narrow), "the pack rule takes strips of 6")
    want_narrow = im2col_pack_scalar_cuda(*narrow)
    torch.cuda.synchronize()
    reset_launch_counts()
    got = [im2col_pack_cuda(x, g["kh"], g["kw"], g["stride"], g["pad"], 128)
           for x, g, _ in packs]
    got.append(im2col_pack_cuda(*narrow))
    torch.cuda.synchronize()
    route = {k.name: k.launches for k in (IM2COL_PACK_TILED, IM2COL_PACK)}
    check(route == {"im2col_pack_tiled": len(packs), "im2col_pack": 1},
          f"im2col_pack_cuda launched {route}")
    want = [s for *_, s in packs] + [want_narrow]
    check(all(torch.equal(bits_of(g), bits_of(w)) for g, w in zip(got, want)),
          "the routed packs are not the bits of im2col_pack.cu")
    print(f"  im2col_pack_cuda over the {len(packs)} cases and strips of 6: "
          f"launches {route}; bit-identical", flush=True)
    return route


# ResNet-18's layer1-4 3x3 convs at batch 8: (name, C, H = W)
RESNET18_CONVS = (("layer1", 64, 56), ("layer2", 128, 28), ("layer3", 256, 14),
                  ("layer4", 512, 7))


def check_pack_resnet18(rng, dev) -> None:
    """Phase 3, both pack kernels at ResNet-18's layer1-4 3x3 convs (batch
    8, V 128), f32 and bf16: the tiled kernel bit for bit against
    im2col_pack.cu, both timed beside F.unfold and the bound, the tiled one
    also with L2 flushed."""
    from repro_torch.kernels.im2col_pack import (im2col_pack_scalar_cuda,
                                                 im2col_pack_tiled_cuda,
                                                 im2col_tiled_geometry)
    from repro_torch.kernels.im2col_pack.tune import cold_us

    for name, c, hw in RESNET18_CONVS:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.standard_normal((c, 8, hw, hw),
                                                     dtype=np.float32))
            x = x.to(dev, dtype)
            args = (x, 3, 3, 1, 1, 128)
            ig = im2col_tiled_geometry(c, 8, hw, hw, 3, 3, 1, 1, 128,
                                       x.element_size())
            got = im2col_pack_tiled_cuda(*args)
            check(torch.equal(bits_of(got),
                              bits_of(im2col_pack_scalar_cuda(*args))),
                  f"im2col_pack_tiled resnet18/{name} {dtype}: not "
                  "bit-identical to im2col_pack.cu")
            x_nchw = x.permute(1, 0, 2, 3).contiguous()
            ms = time_ms(lambda: im2col_pack_tiled_cuda(*args))
            old = time_ms(lambda: im2col_pack_scalar_cuda(*args))
            lib = time_ms(lambda: F.unfold(x_nchw, (3, 3), padding=1))
            cold = cold_us(lambda: im2col_pack_tiled_cuda(*args), dev) / 1e3
            bound = bound_ms(pack_work(x, 3, 3, 1, 1, 128), dtype)[0]
            print(f"  pack resnet18/{name} {str(dtype)[6:]} C={c} {hw}x{hw} "
                  f"batch 8 v128: tiled (cb={ig['cb']} tg={ig['tg']} "
                  f"U={ig['unroll']}) {ms:.5f} ms ({cold:.5f} with L2 "
                  f"flushed), im2col_pack.cu {old:.5f} ms, F.unfold {lib:.5f} "
                  f"ms, bound {bound:.6f} ms (bytes); {bound / ms:.2f} of its "
                  "bound; bit-identical", flush=True)


def check_fused_resnet18(rng, dev) -> None:
    """Phase 3, the tiled fused kernel at ResNet-18's layer3 and layer4 3x3
    convs (256 -> 256 at 14x14 and 512 -> 512 at 7x7, batch 8, tile 8, 50%
    kept), which no banded kernel takes in f32, in f32 and bf16: bit for
    bit against conv2d_fused.cu, timed beside it, cuDNN and the two-kernel
    plans (im2col_pack_cuda, which takes the tiled pack here, then the strip
    GEMM at one strip or HB strips a block)."""
    from repro_torch.core.formats import ColwiseMeta, unpack_colwise
    from repro_torch.kernels.colwise_nm import (
        colwise_nm_matmul_strips_cuda, colwise_nm_matmul_strips_pipelined_cuda)
    from repro_torch.kernels.conv_gemm import (
        conv2d_fused_scalar_cuda, conv2d_fused_tiled_cuda,
        conv2d_fused_tiled_ref, fused_tiled_geometry)
    from repro_torch.kernels.im2col_pack import (im2col_pack_cuda,
                                                 im2col_tiled_takes)

    for name, c, hw in RESNET18_CONVS[2:]:
        for dtype in (torch.float32, torch.bfloat16):
            b, n_tiles, k_rows = 8, c // 8, 9 * c
            x = torch.from_numpy(rng.standard_normal((c, b, hw, hw),
                                                     dtype=np.float32))
            x = x.to(dev, dtype)
            vals = torch.from_numpy(rng.standard_normal(
                (n_tiles, k_rows // 2, 8), dtype=np.float32)).to(dev, dtype)
            ids = torch.from_numpy(np.stack([
                np.sort(rng.choice(k_rows, k_rows // 2, replace=False))
                for _ in range(n_tiles)]).astype(np.int32)).to(dev)
            g = dict(kh=3, kw=3, stride=1, pad=1, v=128)
            fg = fused_tiled_geometry(c, b, hw, hw, 3, 3, 1, 1, 128, n_tiles,
                                      k_rows // 2, 8, x.element_size())
            tag = f"resnet18/{name} {str(dtype)[6:]}"
            y = conv2d_fused_tiled_cuda(x, vals, ids, **g)
            max_err(y, conv2d_fused_tiled_ref(x, vals, ids, **g),
                    f"conv2d_fused_tiled {tag}",
                    F32_RTOL if dtype == torch.float32 else BF16_RTOL)
            check(torch.equal(y, conv2d_fused_scalar_cuda(x, vals, ids, **g)),
                  f"conv2d_fused_tiled {tag}: not bit-identical to "
                  "conv2d_fused")
            check(im2col_tiled_takes(x, 3, 3, 1, 1, 128),
                  f"{tag}: the two-kernel plans do not take the tiled pack")
            w = unpack_colwise(vals, ids, ColwiseMeta(k_rows, c, 8, k_rows,
                                                      k_rows // 2)).T
            w = w.reshape(c, 3, 3, c).permute(0, 3, 1, 2).contiguous()
            x_nchw = x.permute(1, 0, 2, 3).contiguous()

            def plan(hb):
                strips = im2col_pack_cuda(x, 3, 3, 1, 1, 128)
                if hb == 1:
                    return colwise_nm_matmul_strips_cuda(strips, vals, ids)
                return colwise_nm_matmul_strips_pipelined_cuda(strips, vals,
                                                               ids, hb=hb)

            ms = time_ms(lambda: conv2d_fused_tiled_cuda(x, vals, ids, **g))
            old = time_ms(lambda: conv2d_fused_scalar_cuda(x, vals, ids, **g))
            lib = time_ms(lambda: F.conv2d(x_nchw, w, padding=1))
            plans = {hb: time_ms(lambda: plan(hb)) for hb in (1, HB)}
            gf = 2 * c * (k_rows // 2) * b * hw * hw / 1e6
            print(f"  fused {tag} C={c} {hw}x{hw} batch 8 v128 "
                  f"(CPT={fg['cpt']} G={fg['group']} BK={fg['bk']}): tiled "
                  f"{ms:.5f} ms ({gf / ms:.1f} GFLOP/s), conv2d_fused "
                  f"{old:.5f} ms, two-kernel plan (tiled pack + strip GEMM) "
                  f"{plans[1]:.5f} ms (hb {HB}: {plans[HB]:.5f}), F.conv2d "
                  f"{lib:.5f} ms ({gf / lib:.1f}); bit-identical to "
                  "conv2d_fused", flush=True)


def check_strip_kernels(params, cfg, dev, tot):
    """Phase 3, the four strip GEMMs at the five pruned convs' packed strips
    (V 128), in f32 and bf16: colwise_nm_strips.cu and
    colwise_nm_strips_pipelined.cu called directly (the bitwise
    yardsticks), then the tiled kernel's two entry points (one strip a
    block; HB strips a block), each against its plain version and all four
    equal bit for bit; each timed beside its bound, its plain version and
    torch.matmul.  Then the routing wrappers over the ten cases and a
    misaligned view, each launching the kernel the shape rule picks.
    Returns the routing run's launch counts."""
    from repro_torch.core.formats import ColwiseMeta, unpack_colwise
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.colwise_nm import (
        COLWISE_NM_STRIPS, COLWISE_NM_STRIPS_PIPELINED,
        COLWISE_NM_STRIPS_PIPELINED_TILED, COLWISE_NM_STRIPS_TILED,
        colwise_nm_matmul_strips_cuda, colwise_nm_matmul_strips_pipelined_cuda,
        colwise_nm_matmul_strips_pipelined_ref,
        colwise_nm_matmul_strips_pipelined_scalar_cuda,
        colwise_nm_matmul_strips_pipelined_tiled_cuda,
        colwise_nm_matmul_strips_pipelined_tiled_ref,
        colwise_nm_matmul_strips_ref, colwise_nm_matmul_strips_scalar_cuda,
        colwise_nm_matmul_strips_tiled_cuda, colwise_nm_matmul_strips_tiled_ref,
        strips_tiled_takes)
    from repro_torch.kernels.im2col_pack import im2col_pack_cuda, out_size

    rng = np.random.default_rng(SEED + 3)
    routed = []  # (strips, values, idx, bits) of each case
    for name, layer, c, h, w, kh, kw, stride, pad in main_path_convs(params, cfg):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.standard_normal((c, BATCH, h, w),
                                                     dtype=np.float32))
            x = x.to(dev, dtype)
            values, idx = layer["values"].to(dtype), layer["idx"]
            n_tiles, k_kept, tile = values.shape
            o, k_rows = n_tiles * tile, kh * kw * c
            ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
            rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
            tag = (f"{name} {str(dtype).replace('torch.', '')} C={c} {h}x{w} "
                   f"k{kh} s{stride} p{pad} k_kept={k_kept}")
            strips = im2col_pack_cuda(x, kh, kw, stride, pad, 128)
            check(strips_tiled_takes(strips, values)
                  and strips_tiled_takes(strips, values, hb=HB),
                  f"{tag}: the tiled strip GEMM refuses a main-path conv")
            w_dense = unpack_colwise(values, idx, ColwiseMeta(
                k_rows, o, tile, k_rows, k_kept)).T.contiguous()  # [O, K]
            work = strips_work(strips, values, idx, n_pos=BATCH * ho * wo)
            flops = work.flops
            library_gemm = lambda: torch.matmul(w_dense, strips)  # noqa: E731
            runs = (
                ("colwise_nm_matmul_strips",
                 lambda: colwise_nm_matmul_strips_scalar_cuda(strips, values, idx),
                 lambda: colwise_nm_matmul_strips_ref(strips, values, idx)),
                ("colwise_nm_matmul_strips_pipelined",
                 lambda: colwise_nm_matmul_strips_pipelined_scalar_cuda(
                     strips, values, idx, hb=HB),
                 lambda: colwise_nm_matmul_strips_pipelined_ref(
                     strips, values, idx, hb=HB)),
                ("colwise_nm_matmul_strips_tiled",
                 lambda: colwise_nm_matmul_strips_tiled_cuda(strips, values, idx),
                 lambda: colwise_nm_matmul_strips_tiled_ref(strips, values, idx)),
                ("colwise_nm_matmul_strips_pipelined_tiled",
                 lambda: colwise_nm_matmul_strips_pipelined_tiled_cuda(
                     strips, values, idx, hb=HB),
                 lambda: colwise_nm_matmul_strips_pipelined_tiled_ref(
                     strips, values, idx, hb=HB)))
            bits, ms = None, {}
            for kernel, kernel_fn, plain_fn in runs:
                got = kernel_fn()
                err = max_err(got, plain_fn(), f"{kernel} {tag}", rtol)
                if bits is None:
                    bits = got
                check(torch.equal(got, bits), f"{kernel} {tag}: not "
                      "bit-identical to colwise_nm_matmul_strips")
                r = measure(kernel_fn, plain_fn, library_gemm)
                r["bound_ms"], by = bound_ms(work, dtype)
                report(tot, kernel, tag, r, by, err, dtype)
                ms[kernel] = r["ms"]
            gf = flops / 1e6  # GFLOP/s = flops / 1e9 / (ms / 1e3)
            print(f"  strips {tag}: " + ", ".join(
                f"{k.replace('colwise_nm_matmul_', '')} {t:.5f} ms "
                f"({gf / t:.1f} GFLOP/s)" for k, t in ms.items())
                + f", torch.matmul {r['library_ms']:.5f} ms, bound "
                f"{r['bound_ms']:.6f} ms; all four bit-identical", flush=True)
            routed.append((strips, values, idx, bits))

    # the strip routing rule over the ten cases and one call each that it
    # refuses: the tiled kernel takes the ten; colwise_nm_strips.cu a
    # misaligned view of the first case's strips, and
    # colwise_nm_strips_pipelined.cu (which takes no misaligned strips) a
    # tile whose values (1000 kept rows of 64, f32) pass 227 KB
    s0, v0, i0, b0 = routed[0]
    flat = torch.empty(s0.numel() + 1, dtype=s0.dtype, device=dev)
    s_mis = flat[1:].view(s0.shape)
    s_mis.copy_(s0)
    check(not strips_tiled_takes(s_mis, v0), "the rule takes misaligned strips")
    s_big = torch.from_numpy(rng.standard_normal((2, 1200, 128),
                                                 dtype=np.float32)).to(dev)
    v_big = torch.from_numpy(rng.standard_normal((1, 1000, 64),
                                                 dtype=np.float32)).to(dev)
    i_big = torch.from_numpy(np.sort(rng.choice(1200, 1000, replace=False))
                             [None].astype(np.int32)).to(dev)
    check(not strips_tiled_takes(s_big, v_big, hb=HB),
          "the rule takes values past 227 KB")
    want_big = colwise_nm_matmul_strips_pipelined_ref(s_big, v_big, i_big, hb=HB)
    torch.cuda.synchronize()
    reset_launch_counts()
    got = [colwise_nm_matmul_strips_cuda(st, vv, ii) for st, vv, ii, _ in routed]
    got += [colwise_nm_matmul_strips_pipelined_cuda(st, vv, ii, hb=HB)
            for st, vv, ii, _ in routed]
    got.append(colwise_nm_matmul_strips_cuda(s_mis, v0, i0))
    g_big = colwise_nm_matmul_strips_pipelined_cuda(s_big, v_big, i_big, hb=HB)
    torch.cuda.synchronize()
    max_err(g_big, want_big, "colwise_nm_strips_pipelined.cu, 1000 kept rows",
            F32_RTOL)
    route = {k.name: k.launches for k in (
        COLWISE_NM_STRIPS_TILED, COLWISE_NM_STRIPS_PIPELINED_TILED,
        COLWISE_NM_STRIPS, COLWISE_NM_STRIPS_PIPELINED)}
    n = len(routed)
    check(route == {"colwise_nm_matmul_strips_tiled": n,
                    "colwise_nm_matmul_strips_pipelined_tiled": n,
                    "colwise_nm_matmul_strips": 1,
                    "colwise_nm_matmul_strips_pipelined": 1},
          f"the strip GEMM wrappers launched {route}")
    want = [b for *_, b in routed] * 2 + [b0]
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "the routed strip GEMMs are not the bits of colwise_nm_strips.cu")
    print(f"  colwise_nm_matmul_strips(_pipelined)_cuda over the {n} cases, a "
          f"misaligned view and a tile of 1000 kept rows of 64: launches "
          f"{route}; bit-identical", flush=True)
    return route


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
        r["bound_ms"], by = bound_ms(
            linear_work(LINEAR_ROWS, values, idx, d_in), dtype)
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
        r["bound_ms"], by = bound_ms(
            linear_work(LINEAR_ROWS, values, idx, d_in), dtype)
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
            bound, by = bound_ms(linear_work(rows, values, idx, d_in),
                                 torch.float32)
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
    "conv2d_fused_tiled": "F.conv2d on the dense masked weight, as for the "
                          "fused conv",
    "im2col_pack": "F.unfold on NCHW; rows (c, kh, kw) instead of (kh, kw, c), "
                   "batch-leading [B, K, L], no V-wide strips",
    "im2col_pack_tiled": "F.unfold on NCHW, as for im2col_pack",
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
    "colwise_nm_matmul_strips_tiled": "torch.matmul of the dense masked "
                                      "[O, K] weight by the [S, K, V] strips, "
                                      "as for the strip GEMM",
    "colwise_nm_matmul_strips_pipelined_tiled": "torch.matmul of the dense "
                                                "masked [O, K] weight by the "
                                                "[S, K, V] strips, as for the "
                                                "strip GEMM",
    "conv2d_fused_banded": "F.conv2d on the dense masked weight, as for the "
                           "fused conv",
    "conv2d_fused_banded_tiled": "F.conv2d on the dense masked weight, as "
                                 "for the fused conv",
    "paged_attention": "F.scaled_dot_product_attention on K/V pre-gathered "
                       "to [B, H, n_max*ps + Sq, D] with a boolean mask; the "
                       "gather is not timed",
    "paged_attention_split": "F.scaled_dot_product_attention, as for "
                             "paged_attention",
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
# The conv families phase 4 forces, in order.  The kernels each launches for
# one pruned conv depend on the conv's shape (family_kernels).
FAMILY_KERNELS = ("fused_sparse_pallas", "fused_banded_pallas",
                  "two_kernel_pipelined", "im2col_sparse_pallas",
                  "im2col_sparse_xla")
PROFILE_DB = ROOT / "build" / "repro_torch" / "chip_smoke_profile.json"
# what phase 13 holds its chaos runs against, kept by the phases that made
# it: phase 4's first batch and default-plan logits, phase 11a's final
# state, phase 12's prompts, grow tokens and contiguous decode host ms
PHASE_REFS: dict = {}


def family_kernels(impl, conv) -> dict:
    """Kernels one pruned conv launches under the candidate ``impl``: the
    fused family's by the fused shape rule (``fused_tiled_geometry``) at the
    candidate's strip width, the banded family's by the banded shape rule
    (``banded_tiled_geometry``) at the candidate's strip width and band
    depth; the pack of the strip GEMM families and of the plain-GEMM family
    by the pack's shape rule (``im2col_tiled_geometry``), and the strip
    GEMM's by the strip shape rule (``strips_tiled_geometry``), each at the
    strips they pack: the caller's width and one strip a block, or the
    candidate's width and ``hb``."""
    from repro_torch import dispatch
    from repro_torch.kernels.colwise_nm import strips_tiled_geometry
    from repro_torch.kernels.conv_gemm import (banded_tiled_geometry,
                                               fused_tiled_geometry)
    from repro_torch.kernels.im2col_pack import im2col_tiled_geometry, out_size

    family = impl.split("@")[0]
    spec = dispatch.REGISTRY.get("conv", impl)
    _name, layer, c, h, w, kh, kw, stride, pad = conv
    n_tiles, k_kept, tile = layer["values"].shape
    isz = layer["values"].element_size()
    if family == "fused_sparse_pallas":
        tiled = fused_tiled_geometry(
            c, BATCH, h, w, kh, kw, stride, pad, spec.geom("v"), n_tiles,
            k_kept, tile, isz) is not None
        return {"conv2d_fused_tiled" if tiled else "conv2d_fused": 1}
    if family == "fused_banded_pallas":
        tiled = banded_tiled_geometry(
            c, BATCH, h, w, kh, kw, stride, pad, spec.geom("v"),
            spec.geom("hb"), n_tiles, k_kept, tile, isz) is not None
        return {"conv2d_fused_banded_tiled" if tiled
                else "conv2d_fused_banded": 1}
    pipelined = family == "two_kernel_pipelined"
    v = spec.geom("v") if pipelined else 128
    hb = spec.geom("hb") if pipelined else 1
    pack = ("im2col_pack_tiled" if im2col_tiled_geometry(
        c, BATCH, h, w, kh, kw, stride, pad, v, isz) is not None
        else "im2col_pack")
    if family == "im2col_sparse_xla":
        return {pack: 1}
    n_pos = BATCH * out_size(h, kh, stride, pad) * out_size(w, kw, stride, pad)
    tiled = strips_tiled_geometry(-(-n_pos // v), v, n_tiles, k_kept, tile,
                                  isz, hb) is not None
    name = ("colwise_nm_matmul_strips_pipelined" if pipelined
            else "colwise_nm_matmul_strips") + ("_tiled" if tiled else "")
    return {pack: 1, name: 1}


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


def counted_twice(fn, plain, label: str, device_ms: float) -> dict:
    """Phases 4 and 7: ``fn`` counted by the op counter
    (``roofline/counter.py``) through the kernels and again inside
    ``plain`` (a ``force_scope`` of the plain versions).  The two counts'
    FLOPs, bytes and per-family work must be equal: each kernel family's
    call counts its ``roofline/kernels.py`` work whichever implementation
    ran.  Prints the counted ``t_bound`` (f32 peak, one card, no
    collectives) beside the device ms the phase measured."""
    from repro_torch.roofline import Roofline, count

    t0 = time.perf_counter()
    kern = count(fn)
    with plain:
        ref = count(fn)
    for key in ("flops", "bytes", "by_kernel"):
        check(kern[key] == ref[key], f"{label}: counted {key} through the "
              f"kernels {kern[key]} != through the plain versions {ref[key]}")
    rl = Roofline(flops=kern["flops"], hlo_bytes=kern["bytes"],
                  collective_bytes=0, model_flops=0.0, chips=1,
                  dtype="float32")
    print(f"  {label}, counted (roofline.count; the same through the plain "
          f"versions): {kern['flops']} FLOPs, {kern['bytes']} bytes, by "
          f"kernel family {kern['by_kernel']}; t_bound {rl.t_bound * 1e3:.6f} "
          f"ms ({rl.bottleneck}) beside {device_ms:.4f} device ms; both "
          f"counts took {time.perf_counter() - t0:.2f} s", flush=True)
    return {"flops": kern["flops"], "bytes": kern["bytes"],
            "by_kernel": kern["by_kernel"], "t_bound_ms": rl.t_bound * 1e3,
            "device_ms": device_ms}


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
    PHASE_REFS["vision"] = (batches[0][0], runs["default"]["logits"][0])

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
    dev_times = {}
    for label, ms in timing.items():
        impl = runs[label]["impl"]
        dispatch.set_db(runs[label]["db"])
        dev_ms = dev_times[label] = time_ms(
            lambda: vision_apply(params, cfg, x, impl=impl), iters=10)
        print(f"  forward, plan {label}: {ms:.4f} ms per batch of {BATCH} "
              f"({BATCH / ms * 1e3:.1f} images/s; host clock with "
              f"synchronize, best of 2 runs of {10 * N_BATCHES}); device time "
              f"{dev_ms:.4f} ms (CUDA graph replay), device idle share of the "
              f"eager forward {max(0.0, 1 - dev_ms / ms):.3f}", flush=True)
    dispatch.set_db(db)
    with torch.no_grad():
        counted_twice(
            lambda: vision_apply(params, cfg, x),
            dispatch.force_scope(conv="im2col_sparse_xla",
                                 linear="compressed_xla"),
            "resnet-tiny's profiled forward", dev_times["profiled"])
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
    """Phase 6 operands at smollm-360m's heads and page size 16: random q,
    new K/V and pages, a shuffled page table padded with the trash page
    (the last physical page), int32 lengths."""
    from repro_torch.kernels.flash_attn.tune import paged_problem as problem

    return problem(b, sq, lengths, dtype, dev, seed, h=PAGED_H, kv=PAGED_KV,
                   d=PAGED_D, ps=PAGED_PS, n_max=PAGED_NMAX)


def check_paged_kernel(dev, tot) -> dict:
    """Phase 6: both paged-attention kernels against their plain version at
    smollm-360m's serving shapes, with an SDPA yardstick; then the routing
    wrapper over the cases and one the split kernel refuses.  Returns the
    routed run's launch counts."""
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.flash_attn import (
        PAGED_ATTENTION, PAGED_ATTENTION_SPLIT, paged_attention_cuda,
        paged_attention_ref, paged_attention_scalar_cuda,
        paged_attention_split_cuda, paged_split_takes)
    from repro_torch.kernels.flash_attn.tune import paged_sdpa

    for i, (b, sq, lengths, dtype) in enumerate(PAGED_CASES):
        args = paged_problem(b, sq, lengths, dtype, dev, SEED + 20 + i)
        rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
        tag = (f"B={b} Sq={sq} H={PAGED_H} KV={PAGED_KV} D={PAGED_D} "
               f"ps={PAGED_PS} n_max={PAGED_NMAX} lengths={lengths} "
               f"{str(dtype).replace('torch.', '')}")
        check(paged_split_takes(*args[:6]), f"the split rule refuses {tag}")
        y_p = paged_attention_ref(*args)
        y_old = paged_attention_scalar_cuda(*args, page_size=PAGED_PS)
        y_split = paged_attention_split_cuda(*args, page_size=PAGED_PS)
        err_old = max_err(y_old, y_p, f"paged_attention {tag}", rtol)
        err = max_err(y_split, y_p, f"paged_attention_split {tag}", rtol)
        split_old = max_err(y_split, y_old,
                            f"paged_attention_split vs paged_attention {tag}",
                            rtol)
        library = paged_sdpa(args)
        max_err(library().transpose(1, 2), y_p, f"SDPA yardstick {tag}", rtol)
        q, kn, vn, _, _, tables, lengths = args
        bound, by = bound_ms(paged_work(q, kn, vn, tables, lengths, PAGED_PS),
                             dtype)
        for name, fn, e in (
                ("paged_attention",
                 lambda: paged_attention_scalar_cuda(*args, page_size=PAGED_PS),
                 err_old),
                ("paged_attention_split",
                 lambda: paged_attention_split_cuda(*args, page_size=PAGED_PS),
                 err)):
            r = measure(fn, lambda: paged_attention_ref(*args), library)
            r["bound_ms"] = bound
            report(tot, name, tag, r, by, e, dtype, count=(b, sq) == (4, 1))
        print(f"  {'':34s} {tag}: split vs paged_attention.cu max |diff| "
              f"{split_old:.3e} (sums in another order)", flush=True)

    # the routing wrapper: the split kernel wherever its rule holds
    cases = [*enumerate(PAGED_CASES), (len(PAGED_CASES), PAGED_REFUSED)]
    problems = [paged_problem(b, sq, lengths, dtype, dev, SEED + 20 + i)
                for i, (b, sq, lengths, dtype) in cases]
    check(not paged_split_takes(*problems[-1][:6]),
          f"the split rule takes {PAGED_REFUSED}")
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [paged_attention_cuda(*args, page_size=PAGED_PS)
            for args in problems]
    torch.cuda.synchronize()
    route = {"paged_attention_split": PAGED_ATTENTION_SPLIT.launches,
             "paged_attention": PAGED_ATTENTION.launches}
    for (i, (b, sq, lengths, dtype)), args, out in zip(cases, problems, outs):
        rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
        max_err(out, paged_attention_ref(*args),
                f"paged_attention_cuda B={b} Sq={sq} {lengths}", rtol)
    want = {"paged_attention_split": len(PAGED_CASES), "paged_attention": 1}
    print(f"  paged_attention_cuda over the {len(PAGED_CASES)} cases and "
          f"B={PAGED_REFUSED[0]} Sq={PAGED_REFUSED[1]} (24 query rows a KV "
          f"head, which the split rule refuses): {route} (want {want})",
          flush=True)
    check(route == want, f"paged routing {route}, want {want}")
    return route


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
                                                paged_attention_scalar_cuda,
                                                paged_attention_split_cuda)
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
    st = dict(sched.stats, **sched.page_stats, prefill_calls=sched.prefill_calls,
              prefill_s=sched.prefill_s)

    by_uid = {c.uid: c for c in comps}
    check(sorted(by_uid) == [r.uid for r in trace], f"completions {sorted(by_uid)}")
    for r in trace:
        c = by_uid[r.uid]
        check(c.status == "ok" and c.n_generated == r.max_new_tokens
              and c.prompt_len == len(r.prompt)
              and bool((c.tokens >= 0).all() and (c.tokens < cfg.vocab_size).all()),
              f"request {r.uid}: {c.status}, {c.n_generated} of "
              f"{r.max_new_tokens} tokens")
    check(st["pages_active"] == 0, f"{st['pages_active']} pages leaked")
    n_dec, n_pre = st["decode_steps"], st["prefill_calls"]
    want = {"paged_attention_split": cfg.n_layers * n_dec,
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
    # no plain version ran on the card, and neither colwise_nm_matmul nor
    # paged_attention.cu ran
    print("  no plain version ran: every one of the "
          f"{want['paged_attention_split']} attention and "
          f"{want['colwise_nm_matmul_tiled']} linear calls launched its "
          "kernel, every attention the split one and every linear the tiled "
          "one", flush=True)

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
        counted_step = counted_twice(
            lambda: lm.paged_decode_step(params, cfg, cache, tok_d, pos_d,
                                         tab_d, PAGED_PS),
            dispatch.force_scope(linear="compressed_xla",
                                 paged_attn="paged_attn_ref"),
            "one full-batch paged decode step", step_ms)
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
    att_ms = time_ms(lambda: paged_attention_split_cuda(
        qd, knd, knd, kc, vc, tab_d, pos_d, page_size=PAGED_PS))
    old_att_ms = time_ms(lambda: paged_attention_scalar_cuda(
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
          f"of split paged attention = {cfg.n_layers * att_ms:.4f} ms "
          f"(paged_attention.cu would take {cfg.n_layers} x {old_att_ms:.4f} "
          f"ms), unembed {unembed_ms:.4f} ms", flush=True)
    print("SERVE " + json.dumps({
        "requests": len(comps), "prefill_calls": n_pre, "decode_steps": n_dec,
        "generated_tokens": st["generated_tokens"],
        "prefill_host_ms": st["prefill_s"] / n_pre * 1e3,
        "decode_host_ms": host_step_ms,
        "decode_tokens_per_s": decode_tokens / st["decode_s"],
        "decode_step_device_ms": step_ms, "idle_share": idle,
        "counted_decode_step": counted_step,
        "linear_ms_per_layer": lin_ms, "old_linear_ms_per_layer": old_ms,
        "paged_ms_per_layer": att_ms, "old_paged_ms_per_layer": old_att_ms,
        "unembed_ms": unembed_ms, "replay_max_rel_err": worst,
        "tokens_agree": [agree, total], "latency_p50_s": p50,
        "latency_p99_s": p99, "run_s": wall}), flush=True)
    dispatch.set_db(None)
    db_path.unlink(missing_ok=True)
    return counts


# phase 12: static generate, the contiguous scheduler and the paged grow
# scheduler on the same GEN_BATCH prompts of GEN_PROMPT tokens, GEN_NEW new
# tokens each, greedy
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 128, 32
GEN_CHUNK = 32  # the contiguous scheduler's prefill chunk
# the grow scheduler's pool: 32 pages of 16 rows hold the four prompts (8
# pages each) and nothing more, so the first decode step's grow preempts
GROW_BUDGET_ROWS = 512
TEMP, TEMP_DRAWS, TEMP_BATCH = 0.7, 20000, 2500
TEMP_P_MIN = 1e-3  # the chi-square test's p-value must exceed this


class StepRecorder:
    """Wraps an engine's step methods and ``sample`` for one run: records
    every step's inputs and logits (for the teacher-forced replay) and the
    logits row behind each request's j-th token, keyed (uid, j), by
    following the scheduler's admit/preempt/retire log (``log``).  Under
    ``generate`` (no log) row r of every sample is request r."""

    STEPS = ("prefill_step", "prefill_chunk_step", "decode_step",
             "packed_prefill_step", "paged_decode_step")

    def __init__(self, engine, static: bool = False):
        self.engine, self.static = engine, static
        self.orig = {n: getattr(engine, n) for n in self.STEPS + ("sample",)}
        self.steps = []  # (name, inputs, logits)
        self.rows = {}  # (uid, j) -> logits row on the host
        self.count = {}
        self.slot_uid = {}
        self.pending = []
        self.admitting = False
        for n in self.STEPS:
            setattr(engine, n, self._step(n))
        engine.sample = self._sample

    def restore(self):
        # drop the wrappers: a bound method of the engine stored back on the
        # engine would make a cycle that keeps its params alive until the
        # cycle collector runs
        for n in self.orig:
            delattr(self.engine, n)

    def _step(self, name):
        orig = self.orig[name]

        def step(*args, **kw):
            self.admitting = name in ("prefill_chunk_step", "packed_prefill_step")
            inputs = [a.copy() if isinstance(a, np.ndarray) else a
                      for a in args[1:]] if name != "prefill_step" else list(args)
            if name == "prefill_chunk_step":  # the slot of the pool view
                sub = args[0]["k"]
                inputs.insert(0, sub.storage_offset() // sub.stride(1))
            logits, cache = orig(*args, **kw)
            if name in ("decode_step", "paged_decode_step"):
                # a recurrent model's state cache has no KV rows
                inputs.append(tuple(cache["k"].shape) if "k" in cache
                              else None)
            self.steps.append((name, inputs, kw,
                               None if logits is None else logits.clone()))
            return logits, cache
        return step

    def _put(self, uid, row):
        j = self.count.get(uid, 0)
        self.rows[(uid, j)] = row
        self.count[uid] = j + 1

    def _sample(self, logits):
        rows = logits[:, -1].float().cpu()
        if self.static:
            for r in range(rows.shape[0]):
                self._put(r, rows[r])
        elif self.admitting:
            self.pending.extend(rows)
        else:
            for slot, uid in self.slot_uid.items():
                self._put(uid, rows[slot])
        return self.orig["sample"](logits)

    def log(self, msg: str):
        fields = dict(f.split("=", 1) for f in msg.split() if "=" in f)
        if msg.startswith("[admit]"):
            uid, slot = int(fields["uid"]), int(fields["slot"])
            self._put(uid, self.pending.pop(0))
            self.slot_uid[slot] = uid
        elif msg.startswith(("[retire]", "[preempt]")):
            uid = int(fields["uid"])
            self.slot_uid = {s: u for s, u in self.slot_uid.items() if u != uid}


def replay_steps(rec, cfg, dev, label, routes=None) -> float:
    """Teacher-forced replay of a run's steps, contiguous or paged, through
    the plain versions (``compressed_xla``, ``paged_attn_ref``) on a fresh
    cache: each step's logits within REPLAY_RTOL of max|logit|.  Returns
    the largest error.

    With ``routes`` (a ``RouteLog`` that recorded the run under ``label``)
    the replay's routing is recorded under ``label + " plain"`` and
    ``RouteLog.hold`` judges the logits row by row: a row is exempt only
    where its request's tokens were routed apart by a near-tie."""
    from repro_torch import dispatch
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.models import registry as reg

    name, shape, kw = next((n, i[-1], k) for n, i, k, _ in rec.steps
                           if n in ("decode_step", "paged_decode_step"))
    if name == "paged_decode_step":
        cache = reg.paged_cache_init_fn(cfg, shape[1] - 1, kw["page_size"],
                                        dev)()
    else:
        cache = reg.cache_init_fn(cfg, shape[1], shape[2], dev)()
    worst, held = 0.0, []
    reset_launch_counts()
    with dispatch.force_scope(linear="compressed_xla",
                              paged_attn="paged_attn_ref"), (
            routes.record(label + " plain") if routes else nullcontext()):
        for name, inputs, kw, logits_k in rec.steps:
            if name == "prefill_step":
                logits_p, cache = rec.orig[name](*inputs)
            elif name == "prefill_chunk_step":
                slot, rest = inputs[0], inputs[1:]
                sub = {k: v[:, slot:slot + 1] for k, v in cache.items()}
                logits_p, _ = rec.orig[name](sub, *rest, **kw)
            elif name == "packed_prefill_step":
                logits_p, cache = rec.orig[name](cache, *inputs, **kw)
            else:
                logits_p, cache = rec.orig[name](cache, *inputs[:-1], **kw)
            if routes is not None:
                held.append(step_owners(name, inputs)
                            + (row_errs(logits_k, logits_p),))
                continue
            if logits_k is None:
                continue
            e = rel_err(logits_k, logits_p)
            check(e <= REPLAY_RTOL, f"{label} {name}: kernel vs plain "
                  f"logits {e}")
            worst = max(worst, e)
    torch.cuda.synchronize()
    check(all(k.launches == 0 for k in KERNELS), f"the {label} replay launched")
    if routes is not None:
        worst = routes.hold(label, held, cfg.n_layers)
    return worst


def row_errs(a, b):
    """Each logits row's largest |a - b| over max|b| of the whole step, on
    the host."""
    d = (a - b).abs().reshape(a.shape[0], -1).amax(dim=1)
    return (d / max(float(b.abs().max()), 1e-30)).cpu()


def step_owners(name, inputs) -> tuple:
    """(owner of each token the step routes, owners it starts afresh, owner
    of each logits row) of a recorded engine step.  An owner is a slot:
    its tokens' hidden states depend on one another (attention) and on
    the other owners' only through the experts' capacity."""
    if name == "prefill_step":
        b, s = np.asarray(inputs[0]).shape
        rows = np.arange(b)
        return np.repeat(rows, s), set(rows.tolist()), rows
    if name == "packed_prefill_step":
        packed = inputs[0]
        ids = np.asarray(packed.slot_ids)
        return ids, set(ids.tolist()), ids[np.asarray(packed.last_idx)]
    check(name in ("decode_step", "paged_decode_step"),
          f"no owners known for a {name}")
    rows = np.arange(np.asarray(inputs[0]).shape[0])
    return rows, set(), rows


def hold_tokens(ref, runs, cfg) -> list:
    """Tokens of each request equal across the runs; where a run first
    departs from ``generate``, that step's logits must agree within
    REPLAY_RTOL and their top-2 gap be under it (a near-tie, returned)."""
    ties = []
    for label, (comps, rec) in runs.items():
        for uid, c in comps.items():
            want = ref["tokens"][uid]
            diff = [j for j in range(len(want)) if j >= c.n_generated
                    or c.tokens[j] != want[j]]
            if not diff:
                continue
            j = diff[0]
            la, lb = ref["rec"].rows[(uid, j)], rec.rows[(uid, j)]
            e = rel_err(lb, la)
            top = la[:cfg.vocab_size].topk(2).values
            gap = float(top[0] - top[1]) / max(float(la.abs().max()), 1e-30)
            check(e <= REPLAY_RTOL and gap < REPLAY_RTOL,
                  f"{label} request {uid} departs from generate at token "
                  f"{j}: logits differ by {e:.3e}, top-2 gap {gap:.3e} of "
                  f"max|logit| (not a near-tie)")
            ties.append((label, uid, j, e, gap))
    return ties


def chi_square_p(counts, probs) -> float:
    """p-value of category counts against probabilities; the categories
    expected fewer than 5 times are merged into one."""
    from scipy import stats as sstats

    exp = probs * counts.sum()
    small = exp < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(exp[~small], exp[small].sum())
    return float(sstats.chisquare(obs, exp).pvalue)


def check_temperature(engine, cfg, dev) -> dict:
    """TEMP_DRAWS draws at T = TEMP from one fixed logits row on the card:
    none names a padded id, and their counts pass a chi-square test
    against softmax(logits / T), as on the CPU; the same seed repeats."""
    row = np.random.default_rng(SEED + 12).standard_normal(
        cfg.padded_vocab).astype(np.float32) * 2.0
    row[cfg.vocab_size:] = 50.0  # padded ids (if any): never drawn
    logits = torch.from_numpy(row).to(dev).expand(TEMP_BATCH, 1, -1)
    engine.scfg.temperature = TEMP
    engine.reseed()
    drawn = torch.cat([engine.sample(logits)
                       for _ in range(TEMP_DRAWS // TEMP_BATCH)])
    engine.reseed()
    again = torch.cat([engine.sample(logits)
                       for _ in range(TEMP_DRAWS // TEMP_BATCH)])
    engine.scfg.temperature = 0.0
    check(drawn.device.type == "cuda", "the draws left the card")
    check(bool(torch.equal(drawn, again)), "the same seed drew other tokens")
    counts = np.bincount(drawn.cpu().numpy(), minlength=cfg.padded_vocab)
    check(int(counts[cfg.vocab_size:].sum()) == 0, "a padded id was drawn")
    def softmax(t):
        z = row[:cfg.vocab_size].astype(np.float64) / t
        e = np.exp(z - z.max())
        return e / e.sum()

    p = chi_square_p(counts[:cfg.vocab_size], softmax(TEMP))
    p_other = chi_square_p(counts[:cfg.vocab_size], softmax(1.0))
    check(p > TEMP_P_MIN, f"temperature draws fail the chi-square test: p {p}")
    check(p_other < TEMP_P_MIN, f"the test cannot tell T = 1: p {p_other}")
    return {"p": p, "p_at_T1": p_other}


def run_serving_rest(dev, cfg, params) -> dict:
    """Phase 12: ``Engine.generate``, the contiguous ``Scheduler`` and the
    paged ``alloc="grow"`` one on the same requests, at smollm-360m's
    published widths; their launch counts, tokens, replays, lifecycle,
    temperature draws and the serving launcher.  Returns the launch
    counts of the three runs."""
    from repro_torch import dispatch
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.kernels.flash_attn import FLASH_ATTENTION, FLASH_ATTENTION_TILED
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import lm
    from repro_torch.serve import (STATUSES, Engine, PagePool, Request,
                                   Scheduler, ServeConfig)

    db_path = PROFILE_DB.with_suffix(".serve12.json")
    db_path.unlink(missing_ok=True)
    dispatch.set_db(dispatch.ProfileDB(path=db_path))
    n_lin = len(LINEARS) * cfg.n_layers
    prompts = np.random.default_rng(SEED + 12).integers(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT)).astype(np.int32)

    def requests():
        return [Request(uid=i, prompt=prompts[i], max_new_tokens=GEN_NEW)
                for i in range(GEN_BATCH)]

    def counted(run):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        flash = FLASH_ATTENTION.launches + FLASH_ATTENTION_TILED.launches
        counts = {k.name: k.launches for k in KERNELS if k.launches}
        check(flash == 0, "a serving run launched flash")
        return out, counts, wall

    # warm-up (not counted): the first calls fill the dispatch memos
    warm = Engine(cfg, params, ServeConfig(max_new_tokens=2))
    warm.generate(prompts[:, :16])
    Scheduler(warm, n_slots=GEN_BATCH, prefill_chunk=GEN_CHUNK).run(
        [Request(0, prompts[0, :40], max_new_tokens=2)])

    # (a) static generate
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=GEN_NEW))
    rec_g = StepRecorder(engine, static=True)
    res, counts_g, wall_g = counted(lambda: engine.generate(prompts))
    rec_g.restore()
    res["rec"] = rec_g
    n_dec_g = sum(n == "decode_step" for n, *_ in rec_g.steps)
    want = {"colwise_nm_matmul_tiled": n_lin * (1 + n_dec_g)}
    check(counts_g == want, f"generate launches {counts_g}, want {want}")
    print(f"  generate: {GEN_BATCH} prompts of {GEN_PROMPT} tokens, "
          f"{GEN_NEW} new: 1 prefill + {n_dec_g} decode steps, launches "
          f"{counts_g} ({n_lin} a step, 0 flash, 0 paged); prefill "
          f"{res['prefill_s'] * 1e3:.3f} ms, decode {res['decode_s'] * 1e3:.3f}"
          f" ms ({res['decode_s'] / n_dec_g * 1e3:.3f} ms a step), run "
          f"{wall_g:.3f} s", flush=True)

    # (b) the contiguous scheduler, (c) the paged grow scheduler
    runs, scheds, walls, counts = {}, {}, {}, {}
    for label, kw in (("contiguous", dict(prefill_chunk=GEN_CHUNK)),
                      ("grow", dict(paged=True, page_size=PAGED_PS,
                                    alloc="grow",
                                    kv_budget_rows=GROW_BUDGET_ROWS))):
        eng = Engine(cfg, params, ServeConfig(max_new_tokens=GEN_NEW))
        sched = Scheduler(eng, n_slots=GEN_BATCH, **kw)
        rec = StepRecorder(eng)
        comps, counts[label], walls[label] = counted(
            lambda: sched.run(requests(), log_fn=rec.log))
        rec.restore()
        st = sched.stats
        check(sorted(c.uid for c in comps) == list(range(GEN_BATCH))
              and all(c.status == "ok" and c.n_generated == GEN_NEW
                      for c in comps), f"{label} completions")
        n_dec, n_pre = st["decode_steps"], sched.prefill_calls
        want = {"colwise_nm_matmul_tiled": n_lin * (n_pre + n_dec)}
        if label == "grow":
            want["paged_attention_split"] = cfg.n_layers * n_dec
            check(st["preemptions"] >= 1, "the grow run preempted nothing")
            check(sched.page_stats["pages_active"] == 0, "grow leaked pages")
        check(counts[label] == want,
              f"{label} launches {counts[label]}, want {want}")
        runs[label] = ({c.uid: c for c in comps}, rec)
        scheds[label] = sched
        print(f"  {label} scheduler ({GEN_BATCH} slots"
              + (f", chunk {GEN_CHUNK}" if label == "contiguous" else
                 f", page size {PAGED_PS}, {GROW_BUDGET_ROWS} KV rows, "
                 f"{st['preemptions']} preemption(s), pages peak "
                 f"{sched.page_stats['pages_peak']}") +
              f"): {n_pre} prefill calls, {n_dec} decode steps, launches "
              f"{counts[label]} (want {want}); host "
              f"{st['decode_s'] / n_dec * 1e3:.3f} ms a decode step, "
              f"{st['decode_tok_s']:.1f} tokens/s, run {walls[label]:.3f} s",
              flush=True)

    PHASE_REFS["serve"] = {"prompts": prompts, "grow_tokens": {
        u: c.tokens for u, c in runs["grow"][0].items()}}
    ties = hold_tokens(res, runs, cfg)
    same = {label: sum(np.array_equal(c.tokens, res["tokens"][u])
                       for u, c in comps.items())
            for label, (comps, _) in runs.items()}
    print(f"  tokens equal to generate's: {same} of {GEN_BATCH} requests "
          f"each; near-ties where a run departs (run, uid, token, logits "
          f"rel err, top-2 gap): {ties or 'none'}", flush=True)

    worst = {"generate": replay_steps(rec_g, cfg, dev, "generate"),
             "contiguous": replay_steps(runs["contiguous"][1], cfg, dev,
                                        "contiguous")}
    print(f"  teacher-forced replay through the plain versions "
          f"(compressed_xla): max rel err of the logits {worst} <= "
          f"{REPLAY_RTOL} of max|logit|", flush=True)

    # one contiguous and one paged decode step: launches and device time
    _, cache = engine.prefill_step(prompts, GEN_PROMPT + GEN_NEW)
    tok_d = torch.from_numpy(prompts[:, :1].copy()).to(dev)
    pos_d = torch.full((GEN_BATCH,), GEN_PROMPT, dtype=torch.int32, device=dev)
    with dispatch.phase_scope("decode"):
        _, one, _ = counted(lambda: lm.decode_step(params, cfg, cache, tok_d,
                                                   pos_d))
        check(one == {"colwise_nm_matmul_tiled": n_lin},
              f"a contiguous decode step launched {one}")
        contig_ms = time_ms(lambda: lm.decode_step(params, cfg, cache, tok_d,
                                                   pos_d), iters=3)
        pool = PagePool(GEN_BATCH * 10, PAGED_PS)
        for i in range(GEN_BATCH):
            pool.alloc(i, GEN_PROMPT + GEN_NEW)
        tables = torch.from_numpy(pool.table_array(GEN_BATCH, 10)).to(dev)
        from repro_torch.models import registry as reg

        pcache = reg.paged_cache_init_fn(cfg, pool.n_pages, PAGED_PS, dev)()
        paged_ms = time_ms(lambda: lm.paged_decode_step(
            params, cfg, pcache, tok_d, pos_d, tables, PAGED_PS), iters=3)
    host = {label: scheds[label].stats["decode_s"]
            / scheds[label].stats["decode_steps"] * 1e3 for label in scheds}
    host["generate"] = res["decode_s"] / n_dec_g * 1e3
    PHASE_REFS["serve"]["contiguous_decode_host_ms"] = host["contiguous"]
    print(f"  a decode step at {GEN_BATCH} x {GEN_PROMPT} rows: device "
          f"{contig_ms:.4f} ms contiguous (lm.decode_step, {n_lin} tiled "
          f"linears, plain attention), {paged_ms:.4f} ms paged "
          f"(lm.paged_decode_step); host ms a step with sampling: "
          f"generate {host['generate']:.3f}, contiguous "
          f"{host['contiguous']:.3f}, grow {host['grow']:.3f}; idle "
          f"{max(0.0, 1 - contig_ms / host['contiguous']):.3f} contiguous, "
          f"{max(0.0, 1 - paged_ms / host['grow']):.3f} paged", flush=True)

    # lifecycle: a cancel, a deadline and a drain in one grow run
    eng = Engine(cfg, params, ServeConfig(max_new_tokens=8))
    sched = Scheduler(eng, n_slots=GEN_BATCH, paged=True, page_size=PAGED_PS,
                      alloc="grow", kv_budget_rows=GROW_BUDGET_ROWS)
    life = [Request(uid=i, prompt=prompts[i % GEN_BATCH, :16 + 8 * i],
                    max_new_tokens=8) for i in range(8)]
    life[5].deadline_s = 1e-9
    sched.cancel(1)
    seen, beats = [], []
    for c in sched.run_iter(life, should_drain=lambda: len(seen) >= 2,
                            heartbeat=lambda: beats.append(1)):
        seen.append(c)
    by = {c.uid: c.status for c in seen}
    st = sched.stats
    check(len(seen) == len(by) == len(life), f"lifecycle completions {by}")
    check(all(s in STATUSES for s in by.values()), f"statuses {by}")
    check(by[1] == "cancelled" and by[5] == "timeout"
          and "ok" in by.values(), f"lifecycle statuses {by}")
    check(sum(st[f"retired_{s}"] for s in STATUSES) == len(life),
          "the retired counts do not add up")
    check(sched.page_stats["pages_active"] == 0, "lifecycle leaked pages")
    check(len(beats) >= st["decode_steps"], "a heartbeat was missed")
    print(f"  lifecycle (grow, {len(life)} requests; uid 1 cancelled, uid 5 "
          f"a 1 ns deadline, drain after 2 completions): statuses {by}, "
          f"{len(beats)} heartbeats for {st['decode_steps']} decode steps; "
          f"page pool invariants hold, 0 pages mapped at the end", flush=True)

    temp = check_temperature(eng, cfg, dev)
    print(f"  temperature {TEMP}: {TEMP_DRAWS} draws on the card from one "
          f"row, no padded id, chi-square p {temp['p']:.4f} > {TEMP_P_MIN} "
          f"against softmax(logits / T) (p {temp['p_at_T1']:.2e} against "
          f"T = 1); the same seed repeats", flush=True)

    # the serving launcher, in process, static and continuous paged grow
    t0 = time.perf_counter()
    for argv in (["--arch", "smollm-360m", "--batch", "4", "--prompt-len",
                  "32", "--new-tokens", "8"],
                 ["--arch", "smollm-360m", "--continuous", "--paged",
                  "--alloc", "grow", "--requests", "6", "--slots", "4",
                  "--prompt-len", "32", "--new-tokens", "8"]):
        print(f"  python -m repro_torch.launch.serve {' '.join(argv)}:",
              flush=True)
        launch_serve.main(argv)
    print(f"  both launcher runs exited normally in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print("SERVE12 " + json.dumps({
        "generate_decode_host_ms": host["generate"],
        "contiguous_decode_host_ms": host["contiguous"],
        "grow_decode_host_ms": host["grow"],
        "contiguous_step_device_ms": contig_ms, "paged_step_device_ms": paged_ms,
        "prefill_s": res["prefill_s"], "replay_max_rel_err": worst,
        "tokens_equal": same, "near_ties": ties,
        "preemptions": scheds["grow"].stats["preemptions"],
        "temperature_p": temp["p"],
        "launches": dict(counts, generate=counts_g)}), flush=True)
    dispatch.set_db(None)
    db_path.unlink(missing_ok=True)
    total = {}
    for c in (counts_g, counts["contiguous"], counts["grow"]):
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


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
            bound, by = bound_ms(flash_work(b, sq, sk, h, kv, d, causal,
                                            dtype.itemsize), dtype)
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


# phase 10: 3 SGD steps a plan at the main path's batch, the batches of
# batch_for_step(cfg, SEED, k); the step's timing windows
TRAIN_STEPS = 3
TRAIN_TIMED_STEPS = 10  # host clock, best of 2 windows
TRAIN_PROFILED_STEPS = 5  # torch.profiler window for the device time
TRAIN_LOSS_RTOL = 1e-5  # of the reference's loss
# the port's own CUDA kernels as the profiler names them (csrc/*.cu); every
# other kernel in a window is PyTorch's or cuDNN's
PORT_KERNEL_RE = (r"^(void )?(\(anonymous namespace\)::)?"
                  r"(conv2d_fused|fused_tiled|banded|banded_tiled|"
                  r"im2col_pack|im2col_pack_tiled|strips|strips_tiled|"
                  r"pipelined|linear|tiled|flash|flash_tiled|paged|"
                  r"paged_split)_kernel\b")


def masked_reference(params):
    """The same network with every compressed conv unpacked to a masked
    layer: its dense OHWI weight and the kept support as ``mask``, so a
    train step on it runs autograd through F.conv2d on the unpacked masked
    weights and keeps the same support."""
    from repro_torch.core.formats import ColwiseMeta, unpack_colwise

    def walk(t):
        if isinstance(t, dict):
            if "values" in t:
                kh, kw, c = (int(v) for v in t["conv_geom"].tolist())
                n_tiles, k_kept, tile = t["values"].shape
                o, k_rows = n_tiles * tile, kh * kw * c
                meta = ColwiseMeta(k_rows, o, tile, k_rows, k_kept)

                def ohwi(vals):
                    return unpack_colwise(vals, t["idx"], meta).T.reshape(
                        o, kh, kw, c).contiguous()

                return {"w": ohwi(t["values"]),
                        "mask": ohwi(torch.ones_like(t["values"])) != 0}
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t

    return walk(params)


def packed_like(sparse, masked):
    """``masked`` (a tree of masked_reference's layout) read at ``sparse``'s
    packed positions, as float leaves in ``sparse``'s structure: a masked
    layer's [O, kh, kw, C] tensor becomes [n_tiles, k_kept, T] at ``idx``."""
    if isinstance(sparse, dict):
        if "values" in sparse:
            n_tiles, _k, tile = sparse["values"].shape
            idx = sparse["idx"].long()
            w = masked["w"]
            wmat = w.reshape(w.shape[0], -1).T  # [K, O]
            return {"values": torch.stack([
                wmat[idx[t], t * tile:(t + 1) * tile] for t in range(n_tiles)])}
        return {k: packed_like(v, masked[k]) for k, v in sparse.items()}
    if isinstance(sparse, list):
        return [packed_like(a, b) for a, b in zip(sparse, masked, strict=True)]
    return sparse if not masked.is_floating_point() else masked


def float_leaves(tree):
    return [t for t in tree_leaves(tree) if t.is_floating_point()]


def run_steps(params, cfg, batches):
    """``TRAIN_STEPS`` train steps from ``params``; returns the (params,
    momentum, loss) after each."""
    from repro_torch.models.vision import sgd_init, train_step

    p, m = params, sgd_init(params)
    out = []
    for x, labels in batches:
        p, m, loss = train_step(p, m, cfg, x, labels)
        out.append((p, m, loss))
    return out


def hold_steps(got, want, label, what) -> float:
    """Max over the steps of each float leaf's max |got - want| over its
    max |want| (params and momentum), after the losses agree."""
    worst = 0.0
    for k, ((gp, gm, gl), (wp, wm, wl)) in enumerate(zip(got, want,
                                                          strict=True)):
        e = abs(float(gl) - float(wl)) / abs(float(wl))
        check(e <= TRAIN_LOSS_RTOL, f"train {label} vs {what}, step {k}: "
              f"loss {float(gl)} against {float(wl)}")
        for a, b in zip(float_leaves((gp, gm)), float_leaves((wp, wm)),
                        strict=True):
            check(bool(torch.isfinite(a).all()),
                  f"train {label}, step {k}: non-finite")
            e = rel_err(a.float().cpu(), b.float().cpu())
            check(e <= F32_RTOL, f"train {label} vs {what}, step {k}: {e}")
            worst = max(worst, e)
    return worst


PROFILE_TRACES = 3  # traces profiled_ms takes at most to see every launch


def profiled_ms(fn, n: int):
    """(device ms per call, port-kernel device ms per call) of ``fn`` over
    ``n`` calls, by torch.profiler tracing the device alone: the sum of the
    kernel times, which on one stream do not overlap.  One call first as
    the schedule's warm-up, whose events are dropped (tracing starts late
    on its first kernels).  The port's kernels are told by name, and their
    count must equal the launch counters' rise: a trace that lost a call's
    kernels (seen on the card, one step of five) is taken again, up to
    ``PROFILE_TRACES`` traces, and only a complete one is used."""
    for attempt in range(PROFILE_TRACES):
        total, port, port_calls, launched, names = _trace(fn, n)
        check(total > 0, "torch.profiler saw no device time")
        if port_calls == launched:
            return total / n / 1e3, port / n / 1e3
        print(f"  torch.profiler trace {attempt + 1} saw {port_calls} port "
              f"kernels, the launch counters {launched}: traced again",
              flush=True)
    check(False, f"the profiler saw {port_calls} port kernels, the launch "
          f"counters {launched} in {PROFILE_TRACES} traces; device events "
          f"{names}")


def _trace(fn, n: int):
    """One torch.profiler trace of ``n`` calls after a warm-up call:
    (device us, port-kernel device us, port kernels seen, launch counters'
    rise, device event names)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import KERNELS

    traced = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        for i in range(n + 1):
            if i == 1:
                n0 = sum(k.launches for k in KERNELS)
            fn()
            torch.cuda.synchronize()
            prof.step()
    check(len(traced) == 1, f"torch.profiler gave {len(traced)} traces")
    total = port = 0.0
    port_calls = 0
    names = []
    for e in traced[0]:
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        total += us
        names.append(e.key[:80])
        if re.match(PORT_KERNEL_RE, e.key):
            port += us
            port_calls += e.count
    launched = sum(k.launches for k in KERNELS) - n0
    return total, port, port_calls, launched, names


def host_ms_per_step(fn, n: int = TRAIN_TIMED_STEPS) -> float:
    best = float("inf")
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3 / n)
    return best


def time_conv_backward(params, cfg, dev) -> dict:
    """Device ms of the five pruned convs' backward (``conv2d_sparse_bwd``)
    at batch 256 with the repeatable scatter, and with an ``index_add_``
    scatter in its place (atomics, an order that changes from run to run;
    timed here only, the port never runs it), each twice in turns."""
    from repro_torch.kernels.colwise_nm import ops as colwise_ops
    from repro_torch.kernels.conv_gemm import ops as conv_ops
    from repro_torch.kernels.im2col_pack import out_size

    rng = np.random.default_rng(SEED + 21)
    calls = []
    for _name, layer, c, h, w, kh, kw, stride, pad in main_path_convs(params,
                                                                     cfg):
        ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
        o = layer["values"].shape[0] * layer["values"].shape[2]
        x = torch.from_numpy(rng.standard_normal((c, BATCH, h, w),
                                                 dtype=np.float32)).to(dev)
        dy = torch.from_numpy(rng.standard_normal((o, BATCH, ho, wo),
                                                  dtype=np.float32)).to(dev)
        calls.append((x, layer["values"], layer["idx"], dy,
                      dict(kh=kh, kw=kw, stride=stride, pad=pad)))

    def backward():
        for x, values, idx, dy, geo in calls:
            conv_ops.conv2d_sparse_bwd(x, values, idx, dy, **geo)

    def index_add(n, index, src):
        out = torch.zeros(n, dtype=torch.float32, device=src.device)
        return out.index_add_(0, index.reshape(-1), src.reshape(-1).float())

    repeatable = colwise_ops.scatter_add_f32
    out = {"repeatable": [], "index_add_": []}
    try:
        for which in ("repeatable", "index_add_", "index_add_", "repeatable"):
            conv_ops.scatter_add_f32 = (repeatable if which == "repeatable"
                                        else index_add)
            out[which].append(profiled_ms(backward, 5)[0])
    finally:
        conv_ops.scatter_add_f32 = repeatable
    return {k: min(v) for k, v in out.items()}


def run_training(params, cfg, dev, forward_counts) -> dict:
    """Phase 10: ``TRAIN_STEPS`` SGD steps of pruned resnet-tiny at batch
    256 under the default plan (an empty DB), the profiled plan (phase 4's
    DB) and each conv family forced.  Each plan's launches over the steps
    equal phase 4's over as many forwards (the backward launches none);
    its losses, parameters and momentum hold against the same steps through
    the plain versions on the CPU and against a dense masked train step on
    the card (autograd through F.conv2d on the unpacked weights); a second
    run gives the same bits.  Then the step's host and device time, idle
    share and the forward kernels' share, beside the dense step's, and the
    convs' backward with either scatter.  Returns each kernel's launches
    over the plans' counted runs, and the default plan's first loss."""
    from repro_torch import dispatch
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.models.vision import batch_for_step, sgd_init, train_step

    batches = [batch_for_step(cfg, SEED, k, BATCH, device=dev)
               for k in range(TRAIN_STEPS)]
    t0 = time.perf_counter()
    cpu_params = tree_to(params, torch.device("cpu"))
    dispatch.set_db(dispatch.ProfileDB(path=PROFILE_DB.with_suffix(
        ".train_cpu.json")))
    plain = [tuple(tree_to(t, dev) for t in step) for step in run_steps(
        cpu_params, cfg, [(x.cpu(), y.cpu()) for x, y in batches])]
    print(f"  the plain versions on the CPU: {TRAIN_STEPS} steps in "
          f"{time.perf_counter() - t0:.1f} s; losses "
          f"{[round(float(s[2]), 6) for s in plain]}", flush=True)
    masked = masked_reference(params)
    dense_steps = run_steps(masked, cfg, batches)
    dense = [(packed_like(params, p), packed_like(params, m), loss)
             for p, m, loss in dense_steps]
    e = hold_steps(dense, plain, "dense masked", "the plain versions")
    print(f"  the dense masked step on the card (F.conv2d, TF32 off) vs the "
          f"plain versions: rel err <= {e:.3e}", flush=True)

    empty = dispatch.ProfileDB(path=PROFILE_DB.with_suffix(".train.json"))
    empty.path.unlink(missing_ok=True)
    profiled = dispatch.ProfileDB(path=PROFILE_DB)
    check(len(profiled) == 5, f"phase 4's profile holds {len(profiled)} tokens")
    plans = [("default", None, empty), ("profiled", None, profiled)] + [
        (family, family, empty) for family in FAMILY_KERNELS]
    x0, y0 = batches[0]
    train_launches = {k.name: 0 for k in KERNELS}
    report_rows = {}
    for label, family, db in plans:
        dispatch.set_db(db)
        with dispatch.force_scope(**({"conv": family} if family else {})):
            train_step(params, sgd_init(params), cfg, x0, y0)  # warm
            torch.cuda.synchronize()
            reset_launch_counts()
            first = run_steps(params, cfg, batches)
            torch.cuda.synchronize()
            counts = {k.name: k.launches for k in KERNELS}
            check(counts == forward_counts[label],
                  f"train {label}: launches {counts}, phase 4's forwards "
                  f"{forward_counts[label]}")
            for k in KERNELS:
                train_launches[k.name] += counts[k.name]
            second = run_steps(params, cfg, batches)
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(first), tree_leaves(second), strict=True))
            check(same, f"train {label}: two runs of the same steps differ")
            e_plain = hold_steps(first, plain, label, "the plain versions")
            e_dense = hold_steps(first, dense, label, "dense autograd")
            mom = sgd_init(params)

            def step():
                train_step(params, mom, cfg, x0, y0)

            host = host_ms_per_step(step)
            dev_ms, port_ms = profiled_ms(step, TRAIN_PROFILED_STEPS)
        per_forward = {k: n // TRAIN_STEPS for k, n in counts.items() if n}
        row = {"losses": [float(s[2]) for s in first],
               "launches_per_forward": per_forward, "bitwise_repeat": same,
               "max_rel_err_plain": e_plain, "max_rel_err_dense": e_dense,
               "host_ms": host, "device_ms": dev_ms,
               "idle_share": max(0.0, 1 - dev_ms / host),
               "forward_kernels_ms": port_ms,
               "forward_kernels_share": port_ms / dev_ms}
        report_rows[label] = row
        print(f"  plan {label}: launches per forward {per_forward}; losses "
              f"{[round(v, 6) for v in row['losses']]}; rel err vs plain "
              f"{e_plain:.3e}, vs dense {e_dense:.3e}; two runs bitwise "
              f"equal; step {host:.4f} host ms, {dev_ms:.4f} device ms "
              f"(torch.profiler), idle share {row['idle_share']:.3f}; the "
              f"forward kernels {port_ms:.4f} ms (share "
              f"{row['forward_kernels_share']:.3f})", flush=True)
    check(not empty.path.exists(), "a train step wrote a profile")
    dispatch.set_db(empty)
    dmom = sgd_init(masked)

    def dense_step():
        train_step(masked, dmom, cfg, x0, y0)

    host = host_ms_per_step(dense_step)
    dev_ms, port_ms = profiled_ms(dense_step, TRAIN_PROFILED_STEPS)
    check(port_ms == 0, "the dense step ran a port kernel")
    report_rows["dense"] = {"host_ms": host, "device_ms": dev_ms,
                            "idle_share": max(0.0, 1 - dev_ms / host)}
    print(f"  dense masked step (the library yardstick: autograd through "
          f"F.conv2d on the unpacked masked weights, TF32 off): {host:.4f} "
          f"host ms, {dev_ms:.4f} device ms, idle share "
          f"{report_rows['dense']['idle_share']:.3f}", flush=True)
    bwd = time_conv_backward(params, cfg, dev)
    report_rows["conv_backward_ms"] = bwd
    print(f"  the five convs' backward at batch {BATCH}: "
          f"{bwd['repeatable']:.4f} device ms with the repeatable scatter "
          f"(index_put_, accumulate), {bwd['index_add_']:.4f} with "
          f"index_add_ (timed only)", flush=True)
    dispatch.set_db(None)
    print("TRAIN " + json.dumps(report_rows), flush=True)
    return train_launches, report_rows["default"]["losses"][0]

# phase 11: the training tier.  (a)/(b): resnet-tiny's SparseTrainer as
# phase 10's default plan runs it, TIER_STEPS steps with a checkpoint a step
TIER_STEPS = 6
TIER_KEEP = 3
# the children's pause before each step, so a signal sent after a step's
# checkpoint lands while the run goes on (a step takes about 15 ms)
TIER_PACE_S = 0.3
TIER_CHILD_TIMEOUT_S = 300
# (c): the LM Trainer on pruned smollm-360m at its published widths
TIER_LM_STEPS = 4
TIER_LM_BATCH, TIER_LM_SEQ = 4, 256
TIER_LM_LR = 3e-4
TIER_LM_RTOL = 1e-4  # of the plain replay's step-1 loss and grad norm
TIER_LM_TIMED_STEPS = 5  # host clock, best of 2 windows; profiler window

# a SparseTrainer in a child process, as a user's restarted job runs it:
# argv = config JSON, profile DB path, pause before each step (s)
TIER_CHILD = """
import json, sys, time
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch import dispatch
from repro_torch.train import SparseTrainConfig, SparseTrainer

dispatch.set_db(dispatch.ProfileDB(path=sys.argv[2]))
pace = float(sys.argv[3])


class Paced(SparseTrainer):
    def batch_at(self, step):
        time.sleep(pace)
        return super().batch_at(step)


out = Paced(SparseTrainConfig(**json.loads(sys.argv[1]))).run()
print("RESULT " + json.dumps({k: out[k] for k in
                              ("start_step", "final_step", "preempted")}))
"""


def tier_sparse_cfg(ckpt_dir):
    from repro_torch.train import SparseTrainConfig

    return SparseTrainConfig(steps=TIER_STEPS, batch=BATCH, lr=0.05,
                             momentum=0.9, data_seed=SEED, init_seed=SEED,
                             ckpt_dir=str(ckpt_dir) if ckpt_dir else None,
                             ckpt_every=1 if ckpt_dir else 0, keep=TIER_KEEP)


def tier_child(ckpt_dir, db, pace, stop_after=None, sig=None) -> dict:
    """Run a SparseTrainer child to the budget; with ``stop_after`` (a
    step), send it ``sig`` once that step's checkpoint is committed.
    Returns {"rc", "result", "stopped_at"}: the exit code, the run's RESULT
    line (None when killed) and the newest committed step when the signal
    went out."""
    import dataclasses

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cfg = json.dumps(dataclasses.asdict(tier_sparse_cfg(ckpt_dir)))
    proc = subprocess.Popen([sys.executable, "-c", TIER_CHILD, cfg, str(db),
                             str(pace)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    stopped_at = None
    try:
        if stop_after is not None:
            marker = Path(ckpt_dir) / f"step_{stop_after:08d}" / "manifest.json"
            t0 = time.perf_counter()
            while not marker.exists():
                if proc.poll() is not None:
                    check(False, f"the child ended before step {stop_after}'s "
                          f"checkpoint: {proc.stderr.read()[-2000:]}")
                check(time.perf_counter() - t0 < TIER_CHILD_TIMEOUT_S,
                      f"no step {stop_after} checkpoint in time")
                time.sleep(0.005)
            proc.send_signal(sig)
            stopped_at = max(int(d.name[5:]) for d in
                             Path(ckpt_dir).glob("step_*"))
        out, err = proc.communicate(timeout=TIER_CHILD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    result = None
    for line in out.splitlines():
        if line.startswith("RESULT "):
            result = json.loads(line[len("RESULT "):])
    if sig != signal.SIGKILL:
        check(proc.returncode == 0 and result is not None,
              f"the child failed (rc {proc.returncode}): {err[-3000:]}")
    return {"rc": proc.returncode, "result": result, "stopped_at": stopped_at}


def same_bits(a, b) -> bool:
    """The two trees hold the same leaves, float leaves compared as bits."""
    def of(t):
        return bits_of(t) if t.is_floating_point() else t

    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(of(x), of(y)) for x, y in zip(la, lb))


def check_ckpt_dir(mgr, label) -> list:
    """No tmp.* left, at most TIER_KEEP valid step directories, each deep
    valid; returns the valid steps."""
    check(not list(mgr.dir.glob("tmp.*")), f"{label}: a tmp.* directory "
          f"was left: {sorted(p.name for p in mgr.dir.iterdir())}")
    steps = mgr.valid_steps()
    check(len(steps) <= TIER_KEEP, f"{label}: {len(steps)} valid "
          f"checkpoints, keep is {TIER_KEEP}")
    for s in steps:
        reason = mgr.validate(mgr.dir / f"step_{s:08d}", deep=True)
        check(reason is None, f"{label}: step {s} fails deep validation: "
              f"{reason}")
    return steps


def tier_sparse(dev, first_loss, work) -> dict:
    """(a) and (b): the SparseTrainer in this process, then killed and
    preempted in child processes.  Returns the report row."""
    from repro_torch import dispatch
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.train import CheckpointManager, SparseTrainer

    db = work / "empty_profile.json"
    dispatch.set_db(dispatch.ProfileDB(path=db))
    reset_launch_counts()
    tr = SparseTrainer(tier_sparse_cfg(work / "a"), device=dev)
    t0 = time.perf_counter()
    out = tr.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    want = {"conv2d_fused_tiled": 5 * TIER_STEPS}
    check(counts == want, f"SparseTrainer launches {counts}, want {want}")
    losses = [h["loss"] for h in out["history"]]
    check(all(np.isfinite(losses)), f"SparseTrainer losses {losses}")
    check(losses[0] == first_loss, f"SparseTrainer step 1 loss {losses[0]!r} "
          f"is not phase 10's {first_loss!r}")
    check(out["final_step"] == TIER_STEPS, f"SparseTrainer {out}")
    steps_a = check_ckpt_dir(tr.ckpt, "(a)")
    print(f"  (a) {TIER_STEPS} steps in {run_s:.3f} s ({run_s * 1e3 / TIER_STEPS:.3f}"
          f" host ms a step of run(), a checkpoint a step included); "
          f"launches {counts}; losses {losses}; step 1 bit-equal to phase "
          f"10's; valid checkpoints {steps_a}", flush=True)

    lone = SparseTrainer(tier_sparse_cfg(None), device=dev)

    def step():
        lone.run(steps=1)

    host = host_ms_per_step(step)
    dev_ms, port_ms = profiled_ms(step, TRAIN_PROFILED_STEPS)
    print(f"  (a) a step of run() without checkpoints: {host:.4f} host ms, "
          f"{dev_ms:.4f} device ms (torch.profiler), idle share "
          f"{max(0.0, 1 - dev_ms / host):.3f}; the forward kernels "
          f"{port_ms:.4f} ms", flush=True)

    protos = {"params": tr.params, "mom": tr.mom}
    ref, _ = tr.ckpt.restore(TIER_STEPS, protos)
    check(same_bits(ref, protos), "(a)'s last checkpoint is not its state")
    PHASE_REFS["tier_state"] = protos
    rows = {}
    for label, sig, stop_after in (("sigkill", signal.SIGKILL, 3),
                                   ("sigterm", signal.SIGTERM, 2)):
        d = work / label
        t0 = time.perf_counter()
        stopped = tier_child(d, db, TIER_PACE_S, stop_after, sig)
        restarted = tier_child(d, db, 0.0)
        secs = time.perf_counter() - t0
        r = restarted["result"]
        if sig == signal.SIGKILL:
            check(stopped["rc"] == -signal.SIGKILL and stopped["result"] is None,
                  f"{label}: the child was not killed mid-run: {stopped}")
        else:
            s = stopped["result"]
            check(s["preempted"] and s["final_step"] < TIER_STEPS,
                  f"{label}: the child was not preempted mid-run: {stopped}")
            check(r["start_step"] == s["final_step"], f"{label}: restarted "
                  f"at {r['start_step']}, preempted at {s['final_step']}")
        check(stopped["stopped_at"] < TIER_STEPS and r["start_step"] < TIER_STEPS
              and r["final_step"] == TIER_STEPS and not r["preempted"],
              f"{label}: {stopped} then {restarted}")
        mgr = CheckpointManager(d, keep=TIER_KEEP)
        steps = check_ckpt_dir(mgr, label)
        got, _ = mgr.restore(TIER_STEPS, protos)
        check(same_bits(got, ref), f"{label}: step {TIER_STEPS} differs from "
              f"the uninterrupted run's")
        rows[label] = {"signal_after_step": stopped["stopped_at"],
                       "stopped": stopped["result"] or {"rc": stopped["rc"]},
                       "restart": r, "valid_steps": steps, "seconds": secs}
        print(f"  (b) {label} once step {stopped['stopped_at']}'s checkpoint "
              f"was committed (rc {stopped['rc']}, "
              f"{stopped['result']}); restart {r}; step {TIER_STEPS} bit-equal "
              f"to (a) (params and momentum); no tmp.*; valid {steps}, each "
              f"deep-valid; {secs:.1f} s for both children", flush=True)
    dispatch.set_db(None)
    return {"launches": counts, "losses": losses, "run_host_ms_per_step":
            run_s * 1e3 / TIER_STEPS, "host_ms": host, "device_ms": dev_ms,
            "idle_share": max(0.0, 1 - dev_ms / host),
            "forward_kernels_ms": port_ms, **rows}


def tier_lm(dev, cfg, params, work) -> dict:
    """(c): the LM Trainer on pruned smollm-360m at its published widths.
    Returns the report row."""
    from repro_torch import dispatch
    from repro_torch._tree import tree_map
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.data import DataConfig
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = cfg.with_(attn_impl="naive", sparsity=SparsityConfig(
        sparsity=0.5, m=None, tile=None, min_dim=64, format="compressed_xla"))
    data = DataConfig(vocab_size=cfg.vocab_size, batch=TIER_LM_BATCH,
                      seq_len=TIER_LM_SEQ, seed=0, kind="uniform")
    opt = AdamWConfig(lr=TIER_LM_LR)
    tcfg = TrainConfig(steps=TIER_LM_STEPS, ckpt_dir=str(work / "lm"),
                       log_every=1)
    dispatch.set_db(dispatch.ProfileDB(path=work / "lm_profile.json"))
    tr = Trainer(cfg, data, opt, tcfg, params=params)
    batch0 = tr.data.batch_at(0)
    with dispatch.force_scope(linear="compressed_xla"):
        _, _, plain = tr.step_fn(tr.params, tr.opt_state, batch0)
        plain = {k: float(v) for k, v in plain.items()}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = tr.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    want = {"colwise_nm_matmul_tiled": 224 * TIER_LM_STEPS}
    check(counts == want, f"Trainer launches {counts}, want {want}")
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    for k in ("loss", "grad_norm"):
        e = abs(hist[0][k] - plain[k]) / abs(plain[k])
        check(e <= TIER_LM_RTOL, f"Trainer step 1 {k} {hist[0][k]} against "
              f"the plain replay's {plain[k]}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"Trainer losses {losses}")
    steps_s = sum(h["sec_per_step"] for h in hist)
    man = json.loads((tr.ckpt.dir / f"step_{TIER_LM_STEPS:08d}"
                      / "manifest.json").read_text())
    print(f"  (c) {cfg.name}, {cfg.n_layers} layers, {TIER_LM_STEPS} AdamW "
          f"steps (lr {TIER_LM_LR}) on {TIER_LM_BATCH} x {TIER_LM_SEQ} uniform "
          f"tokens, attn_impl naive: launches {counts}; losses {losses}; "
          f"grad norms {[h['grad_norm'] for h in hist]}; step 1 vs the plain "
          f"replay: loss {hist[0]['loss']!r} / {plain['loss']!r}, grad norm "
          f"{hist[0]['grad_norm']!r} / {plain['grad_norm']!r}; host s a step "
          f"{[round(h['sec_per_step'], 4) for h in hist]}", flush=True)
    zeros = tree_map(torch.zeros_like, params)  # the fresh trainer's protos
    fresh = Trainer(cfg, data, opt, tcfg, params=zeros)
    t0 = time.perf_counter()
    restored = fresh.maybe_restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(restored == TIER_LM_STEPS, f"the fresh Trainer restored {restored}")
    check(same_bits(fresh.params, tr.params)
          and same_bits(fresh.opt_state, tr.opt_state),
          "the restored params or opt state differ from the trained ones")
    print(f"  (c) checkpoint at step {TIER_LM_STEPS}: {man['arrays_bytes']} "
          f"bytes, {len(man['arrays'])} arrays, written in about "
          f"{run_s - steps_s:.1f} s (run() minus its steps), restored by a "
          f"fresh Trainer in {restore_s:.1f} s (deep crc check included), "
          f"params and opt state bit for bit", flush=True)
    del fresh, zeros

    p, o = tr.params, tr.opt_state

    def step():
        return tr.step_fn(p, o, batch0)

    a, b = step(), step()
    repeat = same_bits(a[:2], b[:2])
    del a, b
    host = host_ms_per_step(step, TIER_LM_TIMED_STEPS)
    dev_ms, port_ms = profiled_ms(step, TIER_LM_TIMED_STEPS)
    print(f"  (c) a Trainer step: {host:.3f} host ms, {dev_ms:.3f} device ms "
          f"(torch.profiler), idle share {max(0.0, 1 - dev_ms / host):.3f}; "
          f"the tiled linear {port_ms:.3f} ms (share {port_ms / dev_ms:.3f}); "
          f"the same step twice gives the same bits: {repeat}", flush=True)
    dispatch.set_db(None)
    return {"launches": counts, "losses": losses,
            "grad_norms": [h["grad_norm"] for h in hist], "plain_step1": plain,
            "ckpt_bytes": man["arrays_bytes"], "ckpt_write_s": run_s - steps_s,
            "restore_s": restore_s, "host_ms": host, "device_ms": dev_ms,
            "idle_share": max(0.0, 1 - dev_ms / host),
            "tiled_linear_ms": port_ms, "bitwise_repeat": repeat}


def run_tier(dev, first_loss, lm_cfg, lm_params) -> dict:
    """Phase 11.  Returns each kernel's launches in this process's
    counted runs ((a)'s and (c)'s)."""
    work = Path(tempfile.mkdtemp(prefix="tier-", dir=ROOT / "build"))
    try:
        sparse = tier_sparse(dev, first_loss, work)
        lm = tier_lm(dev, lm_cfg, lm_params, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("TIER " + json.dumps({"sparse_trainer": sparse, "lm_trainer": lm}),
          flush=True)
    launches = dict(sparse["launches"])
    for k, n in lm["launches"].items():
        launches[k] = launches.get(k, 0) + n
    return launches


def tree_leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


# phase 13: chaos.  Faults injected on the card through the port's fault
# sites: (a) a dispatch.execute fault on resnet-tiny's fused family, (b)
# phase 12's grow scheduler under scheduler.iter and page_pool.alloc faults
# with obs on, then the serving launcher with --faults and --trace, (c) a
# guarded linear whose tiled kernel refuses, (d) SparseTrainer faults and
# resume; then the cost of the probes with everything off
CHAOS_CONV_SPEC = "dispatch.execute@fused_sparse_pallas:n=1"
CHAOS_SERVE_SPEC = "scheduler.iter:p=0.05,page_pool.alloc:n=1"
CHAOS_LINEAR_SPEC = "dispatch.execute@compressed_tiled:n=1"
CHAOS_LINEAR_ROWS = 4  # decode's rows of phase 5's 960 -> 2560 layer
CHAOS_PROBE_CALLS = 10 ** 6
CHAOS_PROBE_SHARE = 0.01  # of a contiguous decode step's host ms, at most


def chaos_vision(dev, params, cfg) -> dict:
    """(a): one batch-256 forward of the default plan with the fused
    family's first run faulted.  Returns the launches of both forwards."""
    from repro_torch import dispatch, fault, obs
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.models.vision import vision_apply

    x, want = PHASE_REFS["vision"]
    db_path = PROFILE_DB.with_suffix(".chaos.json")
    db_path.unlink(missing_ok=True)
    dispatch.set_db(dispatch.ProfileDB(path=db_path))  # empty: the heuristic
    dispatch.clear_quarantine()
    obs.reset()
    obs.set_enabled(True)
    torch.cuda.synchronize()
    reset_launch_counts()
    with fault.fault_scope(CHAOS_CONV_SPEC) as plan:
        y = vision_apply(params, cfg, x)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    obs.set_enabled(False)
    events = obs.events()
    quarantines = [e["args"] for e in events
                   if e["name"] == "dispatch.quarantine"]
    retries = [e["args"] for e in events
               if e["name"] == "dispatch.execute_retry"]
    n_quarantined = obs.snapshot()["counters"]["dispatch.quarantine"]
    check(plan.fired == {"dispatch.execute": 1}, f"(a) fired {plan.fired}")
    check(n_quarantined == 1 and len(quarantines) == 1
          and quarantines[0]["impl"] == "fused_sparse_pallas",
          f"(a) quarantines: counter {n_quarantined}, events {quarantines}")
    check(dispatch.quarantined("conv") == {"fused_sparse_pallas"},
          f"(a) denylist {dispatch.quarantined()}")
    impls = []
    for name, key in main_path_keys(params, cfg):
        spec = dispatch.resolve(key, param_keys=SPARSE, device=dev)[0]
        check(spec.backend == "cuda"
              and dispatch.family(spec.name) != "fused_sparse_pallas",
              f"(a) {name} resolves {spec.name} under the quarantine")
        impls.append(spec.name)
    want_counts = {k: n for k, n in expected_launches(
        impls, main_path_convs(params, cfg), 1).items() if n}
    check(counts == want_counts, f"(a) launches {counts}, want {want_counts}")
    check(not counts.get("conv2d_fused_tiled") and not counts.get("conv2d_fused"),
          f"(a) the quarantined family launched: {counts}")
    e = rel_err(y, want)
    check(e <= F32_RTOL, f"(a) logits vs phase 4's default plan: {e}")
    print(f"  (a) {CHAOS_CONV_SPEC}: fired {plan.fired}; 1 quarantine "
          f"({quarantines[0]['impl']}: {quarantines[0]['reason'][:60]}); "
          f"retry {[(r['failed'], r['retry']) for r in retries]}; the convs "
          f"resolve {impls}; launches {counts}; logits rel err vs phase 4's "
          f"default plan {e:.3e} (bit-equal: {torch.equal(y, want)})",
          flush=True)

    dispatch.clear_quarantine()
    torch.cuda.synchronize()
    reset_launch_counts()
    y = vision_apply(params, cfg, x)
    torch.cuda.synchronize()
    after = {k.name: k.launches for k in KERNELS if k.launches}
    check(after == {"conv2d_fused_tiled": 5},
          f"(a) after clear_quarantine: launches {after}")
    check(torch.equal(y, want), "(a) after clear_quarantine the logits are "
          "not phase 4's default plan's")
    print(f"  (a) clear_quarantine(): the next forward launches {after}, "
          f"logits bit-equal to phase 4's", flush=True)
    dispatch.set_db(None)
    db_path.unlink(missing_ok=True)
    total = dict(counts)
    for k, n in after.items():
        total[k] = total.get(k, 0) + n
    return total


def chaos_serving(dev, cfg, params, work) -> dict:
    """(b): phase 12's paged grow run under CHAOS_SERVE_SPEC with obs on,
    its trace dumped and validated, then the serving launcher with
    --faults and --trace.  Returns the launches of the scheduler run and the
    probe counts of a decode step."""
    import contextlib
    import io

    from repro_torch import dispatch, fault, obs
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.launch import serve as launch_serve
    from repro_torch.obs import metrics as om
    from repro_torch.serve import STATUSES, Engine, Request, Scheduler, ServeConfig

    ref = PHASE_REFS["serve"]
    db_path = PROFILE_DB.with_suffix(".chaos_serve.json")
    db_path.unlink(missing_ok=True)
    dispatch.set_db(dispatch.ProfileDB(path=db_path))

    def requests():
        return [Request(uid=i, prompt=ref["prompts"][i], max_new_tokens=GEN_NEW)
                for i in range(GEN_BATCH)]

    def grow_sched():
        return Scheduler(Engine(cfg, params, ServeConfig(max_new_tokens=GEN_NEW)),
                         n_slots=GEN_BATCH, paged=True, page_size=PAGED_PS,
                         alloc="grow", kv_budget_rows=GROW_BUDGET_ROWS)

    sched = grow_sched()
    beats = []
    obs.reset()
    obs.set_enabled(True)
    torch.cuda.synchronize()
    reset_launch_counts()
    with fault.fault_scope(CHAOS_SERVE_SPEC, seed=0) as plan:
        comps = sched.run(requests(), heartbeat=lambda: beats.append(1))
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    obs.set_enabled(False)
    st = sched.stats
    by = {c.uid: c for c in comps}
    check(sorted(by) == list(range(GEN_BATCH))
          and all(c.status in STATUSES for c in comps),
          f"(b) completions {[(c.uid, c.status) for c in comps]}")
    check(sched.page_stats["pages_active"] == 0, "(b) pages leaked")
    survivors = [u for u, c in by.items() if c.status == "ok"]
    for u, c in by.items():
        want = ref["grow_tokens"][u]
        if c.status == "ok":
            check(np.array_equal(c.tokens, want), f"(b) uid {u}: tokens "
                  f"{c.tokens.tolist()} differ from phase 12's grow run "
                  f"{want.tolist()}")
        else:
            check(np.array_equal(c.tokens, want[:len(c.tokens)]),
                  f"(b) uid {u} ({c.status}): its tokens are not a prefix "
                  f"of phase 12's")
    fired = dict(plan.fired)
    check(st["iter_faults"] == fired.get("scheduler.iter", 0),
          f"(b) iter_faults {st['iter_faults']}, fired {fired}")
    # (the p=0.05 rule's first draw under 0.05 is its 36th: a run shorter
    # than that sees no iteration fault; the launcher below forces one)
    check(fired.get("page_pool.alloc", 0) >= 1, f"(b) fired {fired}")
    path = work / "chaos_serve_trace.json"
    n_events = obs.dump_chrome_trace(path, metadata={"metrics": obs.snapshot()})
    summary = obs.validate_chrome_trace(path)
    evs = json.loads(path.read_text())["traceEvents"]
    n_iter = sum(e["name"] == "serve.iter" and e["ph"] == "B" for e in evs)
    n_inject = sum(e["name"] == "fault.inject" for e in evs)
    check(n_iter == len(beats) - st["iter_faults"],
          f"(b) {n_iter} serve.iter spans for {len(beats)} iterations, "
          f"{st['iter_faults']} of them faulted")
    check(n_inject == sum(fired.values()),
          f"(b) {n_inject} fault.inject instants, fired {fired}")
    print(f"  (b) {CHAOS_SERVE_SPEC} (seed 0), phase 12's grow run: fired "
          f"{fired}; statuses {[(u, c.status) for u, c in sorted(by.items())]};"
          f" {len(survivors)} survivors token-equal to phase 12's; "
          f"iter_faults {st['iter_faults']}, preemptions {st['preemptions']}, "
          f"0 pages mapped at the end; launches {counts}; trace of {n_events} "
          f"events validates ({summary}), {n_iter} serve.iter spans for "
          f"{len(beats)} iterations less {st['iter_faults']} faulted, "
          f"{n_inject} fault.inject instants", flush=True)

    # the probes a decode step makes: a contiguous run with obs on, every
    # site probed (a plan whose only rule never fires) and every update of
    # the global registry counted
    updates = [0]

    def counting_on():
        updates[0] += 1
        return True

    def contiguous_run():
        eng = Engine(cfg, params, ServeConfig(max_new_tokens=GEN_NEW))
        sched = Scheduler(eng, n_slots=GEN_BATCH, prefill_chunk=GEN_CHUNK)
        sched.run(requests())
        return sched

    plain_ms = contiguous_run().stats
    plain_ms = plain_ms["decode_s"] / plain_ms["decode_steps"] * 1e3
    insts = list(om.REGISTRY._instruments.values())
    obs.reset()
    obs.set_enabled(True)
    for inst in insts:
        inst._on = counting_on
    try:
        with fault.fault_scope("data.batch:n=0") as probe_plan:
            csched = contiguous_run()
    finally:
        for inst in insts:
            inst._on = obs.enabled
        obs.set_enabled(False)
    snap = obs.snapshot()["counters"]
    evs = obs.events()
    n_steps = csched.stats["decode_steps"]
    per_step = {"maybe_fail": sum(probe_plan.probes.values()) / n_steps,
                "span": sum(e["ph"] == "B" for e in evs) / n_steps,
                "instant": sum(e["ph"] == "i" for e in evs) / n_steps,
                "metric": updates[0] / n_steps}
    print(f"  probes a contiguous decode step makes (the whole run's, prefill "
          f"included, over its {n_steps} decode steps): "
          f"{ {k: round(v, 2) for k, v in per_step.items()} }; fault probes "
          f"by site {dict(probe_plan.probes)}; dispatch counters "
          f"{ {k: v for k, v in snap.items() if k.startswith('dispatch.')} };"
          f" the run's decode step {csched.stats['decode_s'] / n_steps * 1e3:.3f}"
          f" host ms with obs on and every site probed, {plain_ms:.3f} with "
          f"both off", flush=True)

    # one paged decode step's host ms with obs off and on (no plan)
    host = {}
    for label, on in (("off", False), ("on", True), ("off", False),
                      ("on", True)):
        s = grow_sched()
        obs.reset()
        obs.set_enabled(on)
        s.run(requests())
        obs.set_enabled(False)
        ms = s.stats["decode_s"] / s.stats["decode_steps"] * 1e3
        host[label] = min(ms, host.get(label, float("inf")))
    obs.reset()
    print(f"  a paged decode step (grow scheduler, {GEN_BATCH} x "
          f"{GEN_PROMPT} rows), host ms with sampling, best of 2 runs: obs "
          f"off {host['off']:.3f}, obs on {host['on']:.3f}", flush=True)

    # the launcher, in process, at full width
    trace_path = work / "chaos_launch_trace.json"
    spec = "scheduler.iter:n=1,page_pool.alloc:n=1"
    argv = ["--arch", "smollm-360m", "--continuous", "--paged", "--alloc",
            "grow", "--requests", "6", "--slots", "4", "--prompt-len", "32",
            "--new-tokens", "8", "--faults", spec, "--trace", str(trace_path)]
    print(f"  python -m repro_torch.launch.serve {' '.join(argv)}:", flush=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(argv)
    text = out.getvalue()
    print("    " + text.rstrip().replace("\n", "\n    "), flush=True)
    check("faults: fired {'scheduler.iter': 1, 'page_pool.alloc': 1}" in text
          and "iter faults 1" in text,
          "(b) the launcher printed no faults: fired line or iteration fault")
    launch_summary = obs.validate_chrome_trace(trace_path)
    check(not fault.enabled() and not obs.enabled(),
          "(b) the launcher left a plan or obs on")
    print(f"  (b) the launcher exited normally; its trace validates "
          f"({launch_summary})", flush=True)
    dispatch.set_db(None)
    db_path.unlink(missing_ok=True)
    return {"launches": counts, "per_step": per_step, "host": host,
            "contiguous_host_ms": plain_ms, "fired": fired,
            "statuses": {u: c.status for u, c in by.items()}}


def chaos_linear(dev) -> dict:
    """(c): phase 5's 960 -> 2560 layer at decode's rows with its tiled
    kernel faulted: the retry lands on the other sparse linear kernel,
    bit-equal, or raises; never a plain candidate.  Returns the launches."""
    from repro_torch import dispatch, fault, obs
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.core.sparse_linear import linear_apply, linear_init
    from repro_torch.kernels import KERNELS, reset_launch_counts

    gen = torch.Generator().manual_seed(SEED + 3)  # phase 5's first layer
    sp = SparsityConfig(sparsity=0.5, m=None, tile=None, min_dim=64,
                        format="compressed_pallas")
    layer = linear_init(gen, 960, 2560, sp, device=dev)
    x = torch.from_numpy(np.random.default_rng(SEED + 13).standard_normal(
        (CHAOS_LINEAR_ROWS, 960), dtype=np.float32)).to(dev)
    db_path = PROFILE_DB.with_suffix(".chaos_linear.json")
    db_path.unlink(missing_ok=True)
    dispatch.set_db(dispatch.ProfileDB(path=db_path))
    dispatch.clear_quarantine()
    y_tiled = linear_apply(layer, x)
    obs.reset()
    obs.set_enabled(True)
    torch.cuda.synchronize()
    reset_launch_counts()
    outcome = "retry"
    with fault.fault_scope(CHAOS_LINEAR_SPEC) as plan:
        try:
            y = linear_apply(layer, x)
        except fault.InjectedFault as e:
            outcome = f"raised ({e}; cause {e.__cause__!r})"
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    obs.set_enabled(False)
    retries = [(e["args"]["failed"], e["args"]["retry"]) for e in obs.events()
               if e["name"] == "dispatch.execute_retry"]
    check(plan.fired == {"dispatch.execute": 1}, f"(c) fired {plan.fired}")
    for _failed, impl in retries:
        check(dispatch.REGISTRY.get("linear", impl).backend == "cuda",
              f"(c) the retry ran the plain candidate {impl}")
    if outcome == "retry":
        check(counts == {"colwise_nm_matmul": 1}, f"(c) launches {counts}")
        check(torch.equal(y, y_tiled), "(c) the retry's output is not "
              "bit-equal to the tiled kernel's")
        detail = "bit-equal to the tiled kernel's"
    else:
        check(not counts, f"(c) launches {counts} before the raise")
        detail = "no cuda candidate left"
    print(f"  (c) {CHAOS_LINEAR_SPEC} on 960->2560 at {CHAOS_LINEAR_ROWS} "
          f"rows: {outcome}; retries {retries}; launches {counts}; {detail}",
          flush=True)
    dispatch.clear_quarantine()
    dispatch.set_db(None)
    db_path.unlink(missing_ok=True)
    return counts


def chaos_training(dev, work) -> dict:
    """(d): the SparseTrainer of phase 11a faulted at step 3 and resumed,
    bit-equal to 11a; then a ckpt.rename fault, an orphaned tmp.* and a
    fresh trainer's run.  Returns the launches."""
    from repro_torch import dispatch, fault, obs
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.train import CheckpointManager, SparseTrainer

    dispatch.set_db(dispatch.ProfileDB(path=work / "chaos_empty_profile.json"))
    obs.reset()
    obs.set_enabled(True)
    reset_launch_counts()
    t0 = time.perf_counter()
    d = work / "train_step"
    tb = SparseTrainer(tier_sparse_cfg(d), device=dev)
    with fault.fault_scope("train.step:iter=3") as plan:
        try:
            tb.run()
            check(False, "(d) the train.step fault did not fire")
        except fault.InjectedFault:
            pass
        tb.ckpt.wait()
    check(plan.fired == {"train.step": 1} and tb.ckpt.latest_step() == 3,
          f"(d) fired {plan.fired}, latest step {tb.ckpt.latest_step()}")
    tc = SparseTrainer(tier_sparse_cfg(d), device=dev)
    out = tc.run()
    check(out["start_step"] == 3 and out["final_step"] == TIER_STEPS,
          f"(d) resumed {out['start_step']} -> {out['final_step']}")
    check(same_bits({"params": tc.params, "mom": tc.mom},
                    PHASE_REFS["tier_state"]),
          "(d) the resumed run is not bit-equal to phase 11a's")
    steps_a = check_ckpt_dir(tc.ckpt, "(d) train.step")
    print(f"  (d) train.step:iter=3: InjectedFault at step 3, a fresh "
          f"trainer resumed 3 -> {TIER_STEPS}; params and momentum bit-equal "
          f"to phase 11a's; valid {steps_a}, each deep-valid", flush=True)

    d = work / "ckpt_rename"
    td = SparseTrainer(tier_sparse_cfg(d), device=dev)
    with fault.fault_scope("ckpt.rename:n=1") as plan:
        try:
            td.run()
            check(False, "(d) the ckpt.rename fault did not surface")
        except fault.InjectedFault:
            pass
        td.ckpt.wait()
    orphans = sorted(p.name for p in d.glob("tmp.*"))
    check(plan.fired == {"ckpt.rename": 1} and len(orphans) == 1
          and not list(d.glob("step_*")),
          f"(d) fired {plan.fired}, left {sorted(p.name for p in d.iterdir())}")
    te = SparseTrainer(tier_sparse_cfg(d), device=dev)
    out = te.run()
    mgr = CheckpointManager(d, keep=TIER_KEEP)
    steps_b = check_ckpt_dir(mgr, "(d) ckpt.rename")
    check(out["start_step"] == 0 and out["final_step"] == TIER_STEPS
          and same_bits({"params": te.params, "mom": te.mom},
                        PHASE_REFS["tier_state"]),
          f"(d) the run after the rename fault: {out['start_step']} -> "
          f"{out['final_step']}, or not bit-equal to phase 11a's")
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    snap = obs.snapshot()["counters"]
    obs.set_enabled(False)
    n_steps = snap["train.steps"]
    check(counts == {"conv2d_fused_tiled": 5 * n_steps},
          f"(d) launches {counts} for {n_steps} steps")
    print(f"  (d) ckpt.rename:n=1: the step-1 save died before its rename "
          f"(surfaced at the next save), leaving {orphans} and no step "
          f"directory; a fresh trainer ran 0 -> {TIER_STEPS} bit-equal to "
          f"phase 11a's, no tmp.* left, valid {steps_b}, each deep-valid; "
          f"{n_steps} steps in all, launches {counts}, ckpt.saved "
          f"{snap['ckpt.saved']}, ckpt.tmp_gc {snap['ckpt.tmp_gc']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    obs.reset()
    dispatch.set_db(None)
    return counts


def probe_cost_us() -> dict:
    """Host µs per call of each probe with everything off, over
    CHAOS_PROBE_CALLS calls (the loop's own cost included)."""
    from repro_torch import fault, obs
    from repro_torch.obs import metrics as om

    check(not fault.enabled() and not obs.enabled(), "a probe is armed")
    counter = om.counter("serve.decode_steps")
    out = {}
    n = CHAOS_PROBE_CALLS
    t0 = time.perf_counter()
    for _ in range(n):
        fault.maybe_fail("scheduler.iter", it=0)
    out["maybe_fail"] = (time.perf_counter() - t0) * 1e6 / n
    t0 = time.perf_counter()
    for _ in range(n):
        with obs.span("serve.iter", it=0):
            pass
    out["span"] = (time.perf_counter() - t0) * 1e6 / n
    t0 = time.perf_counter()
    for _ in range(n):
        obs.instant("serve.retire", uid=0)
    out["instant"] = (time.perf_counter() - t0) * 1e6 / n
    t0 = time.perf_counter()
    for _ in range(n):
        counter.inc()
    out["metric"] = (time.perf_counter() - t0) * 1e6 / n
    check(counter.value == 0 and not obs.events(), "an off probe recorded")
    return out


def run_chaos(dev, vision_cfg, vision_params, lm_cfg, lm_params) -> dict:
    """Phase 13.  Returns each kernel's launches in its runs, the training
    ones apart."""
    work = Path(tempfile.mkdtemp(prefix="chaos-", dir=ROOT / "build"))
    try:
        conv = chaos_vision(dev, vision_params, vision_cfg)
        serve = chaos_serving(dev, lm_cfg, lm_params, work)
        linear = chaos_linear(dev)
        train = chaos_training(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cost = probe_cost_us()
    per_step = serve["per_step"]
    step_us = sum(per_step[k] * cost[k] for k in cost)
    host_ms = PHASE_REFS["serve"]["contiguous_decode_host_ms"]
    # against the smaller of phase 12's step and this phase's own
    share = step_us / (min(host_ms, serve["contiguous_host_ms"]) * 1e3)
    print(f"  host cost per call with everything off, over "
          f"{CHAOS_PROBE_CALLS} calls: "
          f"{ {k: round(v, 4) for k, v in cost.items()} } us; times the "
          f"probes of a decode step: {step_us:.2f} us, {share:.5f} of a "
          f"contiguous decode step (phase 12's {host_ms:.3f}, this phase's "
          f"{serve['contiguous_host_ms']:.3f} host ms)", flush=True)
    check(share < CHAOS_PROBE_SHARE, f"the probes cost {share:.4f} of a "
          f"decode step, at most {CHAOS_PROBE_SHARE}")
    launches = dict(conv)
    for c in (serve["launches"], linear):
        for k, n in c.items():
            launches[k] = launches.get(k, 0) + n
    print("CHAOS " + json.dumps({
        "launches": launches, "train_launches": train,
        "probe_cost_us": cost, "probes_per_decode_step": per_step,
        "probe_share_of_decode_step": share,
        "paged_decode_host_ms": serve["host"], "serve_fired": serve["fired"],
        "serve_statuses": serve["statuses"]}), flush=True)
    return {"launches": launches, "train_launches": train}


# phase 14: the dense LM zoo.  Pruned qwen2-7b and nemotron-4-15b at their
# published widths (the full padded vocab and the untied unembedding), depth
# cut to ZOO_LAYERS, and qwen2-0.5b whole, each served and scored; then the
# Tuner shim and the twins of the JAX package's four examples
ZOO_MODELS = (("qwen2-7b", 2), ("nemotron-4-15b", 2), ("qwen2-0.5b", None))
ZOO_REQUESTS, ZOO_PROMPT, ZOO_NEW = 4, 64, 8
ZOO_SCORE_BATCH, ZOO_SCORE_SEQ = 2, 512
ZOO_TUNER_SHAPE = (LINEAR_ROWS, 960, 2560)  # rows, d_in, d_out


def zoo_model(dev, arch, n_layers):
    """``arch`` at its published widths, ``n_layers`` deep (``None``: its
    own depth), every linear pruned to 50% with T = d_out, random weights
    from ``SEED`` on the card.  Returns (cfg, params, linears, init s)."""
    from repro_torch.configs import get_config
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.kernels.colwise_nm import TILED_BN
    from repro_torch.models import lm

    cfg = get_config(arch)
    depth = (f"{cfg.n_layers} layers (published)" if n_layers is None else
             f"{n_layers} layers (reduced from {cfg.n_layers})")
    cfg = cfg.with_(n_layers=n_layers or cfg.n_layers,
                    sparsity=SparsityConfig(sparsity=0.5, m=None, tile=None,
                                            format="compressed_pallas"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.lm_init(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layers = params["layers"]
    linears = [(a, n) for a, n in LINEARS if a in layers and n in layers[a]]
    check(all("values" in layers[a][n] for a, n in linears),
          f"{arch}: every linear is compressed")
    experts = ""
    if cfg.is_moe:
        stacks = [layers["moe"][n] for n in ("gate", "up", "down")
                  if n in layers["moe"]]
        check(all("values" in t for t in stacks)
              and layers["moe"]["router"].dtype == torch.float32,
              f"{arch}: every expert compressed, the router f32")
        experts = (f"{cfg.n_experts} experts, top {cfg.top_k}, expert values "
                   f"{[tuple(t['values'].shape) for t in stacks]}; ")
    widths = sorted({int(layers[a][n]["values"].shape[-1])
                     for a, n in linears})
    check(all(w % TILED_BN == 0 for w in widths),
          f"{arch}: T = d_out {widths}, each a multiple of {TILED_BN}")
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"  {arch}: {depth}, d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads}, head_dim {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), "
          f"{cfg.norm}, {cfg.mlp_act}, "
          f"{'tied' if cfg.tie_embeddings else 'untied'} embeddings, f32; "
          f"sparsity 0.5, T = d_out {widths}; {len(linears)} linears a "
          f"layer; {experts}{n_params} stored values and indices from seed "
          f"{SEED}, "
          f"built in {init_s:.1f} s", flush=True)
    return cfg, params, linears, init_s


def zoo_prompts(cfg, seed) -> np.ndarray:
    """ZOO_REQUESTS uniform prompts of ZOO_PROMPT tokens from ``seed``."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (ZOO_REQUESTS, ZOO_PROMPT)).astype(np.int32)


def zoo_serve(dev, cfg, params, linears, routes=None, keep=False) -> dict:
    """ZOO_REQUESTS requests of ZOO_PROMPT tokens and ZOO_NEW new ones,
    greedy, through ``Scheduler(paged=True)``: exact launch counts, a
    teacher-forced replay of every step through the plain versions, host
    ms a decode step and the device ms of one.  With ``routes`` (an MoE
    model): the run's routing recorded, the replay held under the near-tie
    rule, the assignments each step dropped, and the decode step's
    experts' and attention linears' shares of its device time.  With
    ``keep``, the completions by uid (``"comps"``) and the recorder
    (``"rec"``) come back too, for ``hold_tokens``."""
    from repro_torch import dispatch
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.models import registry as reg
    from repro_torch.serve import Engine, Request, Scheduler

    label = f"{cfg.name} paged"
    engine = Engine(cfg, params)
    sched = Scheduler(engine, n_slots=ZOO_REQUESTS, paged=True,
                      page_size=PAGED_PS, alloc="reserve")
    trace = [Request(uid=i, prompt=p, max_new_tokens=ZOO_NEW)
             for i, p in enumerate(zoo_prompts(cfg, SEED + 14))]
    rec = StepRecorder(engine)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with routes.record(label) if routes else nullcontext():
        comps = sched.run(trace, log_fn=rec.log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    rec.restore()
    st = sched.stats
    n_dec, n_pre = st["decode_steps"], sched.prefill_calls
    check(sorted(c.uid for c in comps) == list(range(ZOO_REQUESTS))
          and all(c.status == "ok" and c.n_generated == ZOO_NEW
                  and bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size))
                           .all()) for c in comps),
          f"{cfg.name}: completions "
          f"{[(c.uid, c.status, c.n_generated) for c in comps]}")
    check(sched.page_stats["pages_active"] == 0, f"{cfg.name}: pages leaked")
    want = {"paged_attention_split": cfg.n_layers * n_dec,
            "colwise_nm_matmul_tiled":
                len(linears) * cfg.n_layers * (n_dec + n_pre)}
    print(f"  {cfg.name} served {len(comps)} requests of {ZOO_PROMPT} "
          f"prompt tokens, {ZOO_NEW} new each: {n_pre} packed prefills, "
          f"{n_dec} decode steps in {wall:.3f} s; launches {counts} (want "
          f"{want}: {len(linears)} tiled linears a layer a step, one split "
          "paged attention a layer a decode step"
          + ("; the experts none)" if routes else ")"), flush=True)
    check(counts == want, f"{cfg.name} serving launches {counts}, want {want}")
    out = {"launches": counts, "host_s": wall}
    if keep:
        out.update(comps={c.uid: c for c in comps}, rec=rec)
    if routes:
        out["drops"] = moe_drops(routes, label, rec, cfg)
    out["replay_max_rel_err"] = replay_steps(rec, cfg, dev, label, routes)

    inputs = next(i for n, i, _, _ in rec.steps if n == "paged_decode_step")
    cache = reg.paged_cache_init_fn(cfg, inputs[-1][1] - 1, PAGED_PS, dev)()
    tok_d, pos_d, tab_d = (torch.from_numpy(a).to(dev) for a in inputs[:3])

    def step():
        return lm.paged_decode_step(params, cfg, cache, tok_d, pos_d, tab_d,
                                    PAGED_PS)

    with dispatch.phase_scope("decode"):
        step_ms = time_ms(step, iters=2)
        if routes:
            (out["decode_profiled_ms"], out["expert_share"],
             out["attn_linear_share"]) = moe_step_shares(step, step_ms)
    rec_ms = st["decode_s"] / n_dec * 1e3
    # the same requests again with the recorder off, which clones the
    # logits and copies rows to the host each step: the host ms the idle
    # share reads
    quiet = Scheduler(engine, n_slots=ZOO_REQUESTS, paged=True,
                      page_size=PAGED_PS, alloc="reserve")
    quiet.run([Request(uid=r.uid, prompt=r.prompt,
                       max_new_tokens=ZOO_NEW) for r in trace])
    torch.cuda.synchronize()
    host_ms = quiet.stats["decode_s"] / quiet.stats["decode_steps"] * 1e3
    idle = max(0.0, 1 - step_ms / host_ms)
    print(f"  {cfg.name} replay of all {len(rec.steps)} steps through the "
          f"plain versions: max rel err of the logits "
          f"{out['replay_max_rel_err']:.3e} <= {REPLAY_RTOL} of max|logit|"
          + (f" in the rows held (RouteLog.hold: {routes.ties[label]})"
             if routes else "")
          + f"; decode step host {host_ms:.3f} ms (the recorder off; "
          f"{rec_ms:.3f} on), device {step_ms:.4f} ms (graph replay), idle "
          f"share {idle:.3f}"
          + (f"; torch.profiler {out['decode_profiled_ms']:.4f} ms a step, "
             f"the experts {out['expert_share']:.3f} of it, the attention "
             f"linears (#1b) {out['attn_linear_share']:.3f}"
             if routes else ""), flush=True)
    out.update({"device_s": n_dec * step_ms / 1e3, "decode_host_ms": host_ms,
                "decode_host_ms_recorder_on": rec_ms,
                "decode_device_ms": step_ms, "idle": idle})
    return out


def zoo_score(dev, cfg, params, linears, routes=None, want=None,
              seq=ZOO_SCORE_SEQ, extras=None) -> dict:
    """One ``loss_fn`` and one ``forward_fn`` on ZOO_SCORE_BATCH x ``seq``
    uniform tokens (and the batch's ``extras``: an encoder-decoder's
    frames, a VLM's vision inputs and 3-D positions, on the card) under
    attn_impl="pallas": exact launch
    counts (``want``, the two forwards' launches, else one tiled flash and
    one tiled linear of ``linears`` a layer a forward), logits and NLL (and
    an MoE model's aux) against the plain replay; with ``routes`` (an MoE
    model) the logits are held row by row under ``RouteLog.hold``, and the
    NLL and aux only where no batch row was routed apart."""
    from repro_torch import dispatch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.models import registry as reg

    cfg = cfg.with_(attn_impl="pallas")
    label = f"{cfg.name} score"
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  batch=ZOO_SCORE_BATCH, seq_len=seq,
                                  kind="uniform", seed=SEED))
    batch = {"tokens": torch.from_numpy(data.batch_at(0)["tokens"]).to(dev),
             **(extras or {})}
    forward, loss = reg.forward_fn(cfg), reg.loss_fn(cfg)
    with torch.no_grad():
        forward(params, batch)  # warm-up: the dispatch memos at these rows
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        total, aux = loss(params, batch)
        with routes.record(label) if routes else nullcontext():
            logits = forward(params, batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 2
        counts = {k.name: k.launches for k in KERNELS if k.launches}
        if want is None:
            want = {"flash_attention_tiled": 2 * cfg.n_layers,
                    "colwise_nm_matmul_tiled": 2 * len(linears) * cfg.n_layers}
        check(counts == want, f"{cfg.name} scoring launches {counts}, want "
              f"{want}")
        check(tuple(logits.shape) == (ZOO_SCORE_BATCH, seq, cfg.padded_vocab)
              and bool(torch.isfinite(logits).all()),
              f"{cfg.name} logits {tuple(logits.shape)}")
        nll, aux_k = float(aux["nll"]), float(aux["aux"])
        check(np.isfinite(nll)
              and float(total) == float(aux["nll"] + 0.01 * aux["aux"]),
              f"{cfg.name} loss {float(total)} vs nll {nll}, aux {aux_k}")
        reset_launch_counts()
        plain = cfg.with_(attn_impl="naive")
        with dispatch.force_scope(linear="compressed_xla"):
            with routes.record(label + " plain") if routes else nullcontext():
                logits_p = reg.forward_fn(plain)(params, batch)
            parts = reg.loss_fn(plain)(params, batch)[1]
            nll_p, aux_p = float(parts["nll"]), float(parts["aux"])
        torch.cuda.synchronize()
        check(all(k.launches == 0 for k in KERNELS),
              "the replay launched a kernel")
        e_nll = abs(nll - nll_p) / nll_p
        e_aux = abs(aux_k - aux_p) / max(abs(aux_p), 1e-30)
        if cfg.is_moe:
            check(aux_k > 0, f"{cfg.name} aux {aux_k}")
        if routes is None:
            e = rel_err(logits, logits_p)
            check(e <= REPLAY_RTOL, f"{cfg.name} scoring vs plain: logits "
                  f"{e} (<= {REPLAY_RTOL})")
        else:  # an MoE model: the rows of a batch row routed apart exempt
            b, s = batch["tokens"].shape
            e = routes.hold(label, [(np.repeat(np.arange(b), s),
                                     set(range(b)), np.arange(b),
                                     row_errs(logits, logits_p))],
                            cfg.n_layers)
        # the loss's forward routes as ``forward`` did: where a batch row
        # was routed apart, the NLL and aux are the run's and not held
        apart = routes is not None and routes.ties[label]["rows_exempt"] > 0
        check(apart or (e_nll <= SCORE_NLL_RTOL
                        and e_aux <= SCORE_NLL_RTOL),
              f"{cfg.name} scoring vs plain: NLL {e_nll}, aux {e_aux} "
              f"(<= {SCORE_NLL_RTOL})")
        del logits, logits_p
        dev_ms = time_ms(lambda: forward(params, batch), iters=1)
    print(f"  {cfg.name} scored {ZOO_SCORE_BATCH} x {seq} tokens"
          + (f" with {sorted(extras)}" if extras else "") + ": "
          f"launches {counts} (want {want}); NLL {nll} against the plain "
          f"replay's {nll_p} (rel err {e_nll:.3e} <= {SCORE_NLL_RTOL}; "
          f"ln(vocab) {np.log(cfg.vocab_size):.4f}), "
          + (f"aux {aux_k} against {aux_p} (rel err {e_aux:.3e}), "
             if cfg.is_moe else "")
          + f"logits rel err {e:.3e} <= {REPLAY_RTOL}; host {host_ms:.3f} ms, "
          f"device {dev_ms:.3f} ms a forward (graph replay)", flush=True)
    return {"launches": counts, "host_s": 2 * host_ms / 1e3,
            "device_s": 2 * dev_ms / 1e3, "nll": [nll, nll_p],
            "aux": [aux_k, aux_p], "forward_host_ms": host_ms,
            "forward_device_ms": dev_ms}


def zoo_tuner(dev) -> dict:
    """``Tuner.tune(profile=True)`` at ZOO_TUNER_SHAPE into a fresh cache
    under build/: each tile timed on the kernel it routes to."""
    from repro_torch.core.tuning import Tuner, enumerate_candidates
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.kernels.colwise_nm import TILED_BN

    rows, d_in, d_out = ZOO_TUNER_SHAPE
    path = ROOT / "build" / "repro_torch" / "chip_smoke_tuning.json"
    path.unlink(missing_ok=True)
    reset_launch_counts()
    r = Tuner(cache_path=path, device=dev).tune(rows, d_in, d_out,
                                                profile=True)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    tiles = sorted({c.tile for c in enumerate_candidates(d_in, d_out)})
    routed = {"colwise_nm_matmul_tiled": sum(t % TILED_BN == 0 for t in tiles),
              "colwise_nm_matmul": sum(t % TILED_BN != 0 for t in tiles)}
    check(set(counts) == {k for k, n in routed.items() if n}
          and all(counts[k] >= routed[k] for k in counts),
          f"the tuner launched {counts}, tiles {tiles}")
    check(r["tile"] in tiles and r["wall_us"] > 0 and path.exists(),
          f"the tuner's pick {r}")
    again = Tuner(cache_path=path, device=dev).tune(rows, d_in, d_out)
    check(again == r, f"the cached pick {again} is not {r}")
    print(f"  Tuner.tune(profile=True) at {rows} rows, {d_in} -> {d_out}: "
          f"tiles {tiles} timed on the card, launches {counts}; pick {r}, "
          f"cached in {path.relative_to(ROOT)}", flush=True)
    path.unlink(missing_ok=True)
    return counts


def zoo_examples(dev) -> tuple:
    """The four example twins on the card at the JAX examples' sizes, each
    launch counted; returns (inference launches, training launches)."""
    from repro_torch.examples import (conv_pipeline, prune_and_finetune,
                                      quickstart, serve_pruned)
    from repro_torch.kernels import KERNELS, reset_launch_counts

    def counted(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {k.name: k.launches for k in KERNELS if k.launches}, (
            time.perf_counter() - t0)

    work = Path(tempfile.mkdtemp(prefix="examples-", dir=ROOT / "build"))
    try:
        conv, c_conv, s_conv = counted(lambda: conv_pipeline.main(dev))
        quick, c_quick, s_quick = counted(lambda: quickstart.main(
            dev, ckpt_dir=work / "quickstart"))
        prune, c_prune, s_prune = counted(lambda: prune_and_finetune.main(dev))
        serve, c_serve, s_serve = counted(lambda: serve_pruned.main(dev))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n_conv = len(conv_pipeline.LAYERS)
    check(set(c_conv) <= {"conv2d_fused", "conv2d_fused_tiled"}
          and sum(c_conv.values()) == n_conv,
          f"conv_pipeline launched {c_conv}: one fused conv a layer")
    worst = max(layer["max_err"] / layer["max_ref"] for layer in conv["layers"])
    print(f"  conv_pipeline ({s_conv:.2f} s): launches {c_conv}; max|err| "
          f"{[layer['max_err'] for layer in conv['layers']]}, at most "
          f"{worst:.2e} of max|y| <= {conv_pipeline.RTOL}", flush=True)
    steps = quick["final_step"]
    n_lin = 7 * quick["cfg"].n_layers
    check(steps == 120 and c_quick == {"colwise_nm_matmul_tiled":
                                       n_lin * steps},
          f"quickstart: {steps} steps, launches {c_quick}")
    print(f"  quickstart ({s_quick:.2f} s): {steps} steps, loss "
          f"{quick['history'][0]['loss']:.4f} -> "
          f"{quick['history'][-1]['loss']:.4f}, launches {c_quick} ({n_lin} "
          "tiled linears a step forward; the backward is plain)", flush=True)
    check(c_prune == {"colwise_nm_matmul": 14},
          f"prune_and_finetune launched {c_prune}: the masked steps none, "
          "the compressed forward (tile 8) 7 linears x 2 layers")
    print(f"  prune_and_finetune ({s_prune:.2f} s): dense nll "
          f"{prune['dense_nll']:.4f}, {prune['results']}; compressed loss "
          f"{prune['compressed_loss']:.6f} vs masked "
          f"{prune['masked_loss']:.6f} (<= {prune_and_finetune.LOSS_RTOL} "
          f"rel); launches {c_prune}", flush=True)
    n_gen = 0
    for s, res in serve.items():
        check(res["tokens"].shape == (32, 24), f"serve_pruned at {s}: tokens "
              f"{res['tokens'].shape}")
        n_gen += 2 if s else 0  # warm-up and timed generate of the pruned
    want = {"colwise_nm_matmul_tiled": n_gen * 24 * 7 * 4}
    check(c_serve == want, f"serve_pruned launched {c_serve}, want {want}")
    print(f"  serve_pruned ({s_serve:.2f} s): tokens at sparsity "
          f"{list(serve)}, launches {c_serve} (7 tiled linears x 4 layers x "
          "24 steps a generate, 2 generates a pruned model)", flush=True)
    launches = {}
    for c in (c_conv, c_prune, c_serve):
        for k, n in c.items():
            launches[k] = launches.get(k, 0) + n
    return launches, c_quick, s_conv + s_quick + s_prune + s_serve


def run_zoo(dev) -> dict:
    """Phase 14.  Returns each kernel's launches, the training ones
    apart."""
    from repro_torch import dispatch

    t0 = time.perf_counter()
    db_path = PROFILE_DB.with_suffix(".zoo.json")
    db_path.unlink(missing_ok=True)
    dispatch.set_db(dispatch.ProfileDB(path=db_path))
    launches, init_s, host_s, device_s, rows = {}, 0.0, 0.0, 0.0, {}

    def add(c):
        for k, n in c.items():
            launches[k] = launches.get(k, 0) + n

    try:
        for arch, n_layers in ZOO_MODELS:
            cfg, params, linears, s = zoo_model(dev, arch, n_layers)
            served = zoo_serve(dev, cfg, params, linears)
            scored = zoo_score(dev, cfg, params, linears)
            del params
            torch.cuda.empty_cache()
            init_s += s
            host_s += served["host_s"] + scored["host_s"]
            device_s += served["device_s"] + scored["device_s"]
            add(served["launches"])
            add(scored["launches"])
            rows[arch] = {"layers": cfg.n_layers, "init_s": s,
                          "serve": {k: v for k, v in served.items()
                                    if k != "launches"},
                          "score": {k: v for k, v in scored.items()
                                    if k != "launches"}}
        add(zoo_tuner(dev))
        ex_launches, train, ex_s = zoo_examples(dev)
        add(ex_launches)
    finally:
        dispatch.set_db(None)
        db_path.unlink(missing_ok=True)
    print(f"  the zoo's models: init {init_s:.1f} s, served and scored "
          f"{host_s:.3f} host s, of which {device_s:.4f} device s measured "
          f"(decode steps and forwards by graph replay); the examples "
          f"{ex_s:.1f} s; phase 14 took {time.perf_counter() - t0:.1f} s",
          flush=True)
    print("ZOO " + json.dumps({"models": rows, "launches": launches,
                               "train_launches": train, "init_s": init_s,
                               "host_s": host_s, "device_s": device_s,
                               "examples_s": ex_s}), flush=True)
    return {"launches": launches, "train_launches": train}


# phase 15: the MoE family.  Pruned olmoe-1b-7b whole and moonshot-v1-16b-a3b
# at its published widths, depth cut to 2 (its 48 layers would draw about
# 14 G values on the host), each served paged and contiguous and scored
MOE_MODELS = (("olmoe-1b-7b", None), ("moonshot-v1-16b-a3b", 2))
# a token's margin: the least gap between neighbours among its k + 1
# highest routing probabilities.  A token whose routing departs from the
# replay's, of a request whose routing had not departed yet, must have a
# margin under this (a near-tie)
NEAR_TIE_MARGIN = 1e-5
MOE_PROFILED_STEPS = 3  # torch.profiler window of the paged decode step
# the profiled kernels' sum a step over its graph replay's device ms: eager
# steps run the same kernels with host gaps between them, which the sum
# leaves out; a range counted twice would land near 2
MOE_PROFILE_BAND = (0.8, 1.25)
# the sparse linear kernel (#1b) as the profiler names it
LINEAR_TILED_RE = r"^(void )?(\(anonymous namespace\)::)?tiled_kernel\b"


class RouteLog:
    """Wraps the port's MoE router and dispatch (``moe._route``,
    ``moe._dispatch_group``) while phase 15 runs, as the launch counters
    wrap the kernels.  Under a label (``record``) it keeps, on the card,
    each router call's ``top_i``, each token's margin and each
    assignment's ``keep``.

    ``hold`` judges a run against its plain replay.  The two differ by
    rounding, so a token near a tie may be routed apart, and then its
    request's hidden states, its cache rows and, through the experts'
    capacity, other requests' assignments in that call move too.  Owners
    (requests' slots, or batch rows) are followed call by call: an owner
    is apart from the call where one of its tokens routes apart (``top_i``
    in another order or set, or another ``keep``) until a prefill starts
    it afresh.  A token of an owner not yet apart may route apart only
    within NEAR_TIE_MARGIN; the logits rows of an owner not apart are held
    within REPLAY_RTOL, and only the rows of an owner apart are exempt."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe = moe
        self.orig = (moe._route, moe._dispatch_group)
        self.runs, self.label, self.ties = {}, None, {}
        moe._route, moe._dispatch_group = self._route, self._dispatch

    def restore(self):
        self.moe._route, self.moe._dispatch_group = self.orig

    @contextmanager
    def record(self, label):
        self.runs[label] = {"top_i": [], "gap": [], "keep": []}
        prev, self.label = self.label, label
        try:
            yield self.runs[label]
        finally:
            self.label = prev

    def _route(self, params, cfg, xg):
        probs, top_p, top_i = self.orig[0](params, cfg, xg)
        if self.label is not None:
            top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
            run = self.runs[self.label]
            run["top_i"].append(top_i.clone())
            run["gap"].append((top[..., :-1] - top[..., 1:]).amin(dim=-1))
        return probs, top_p, top_i

    def _dispatch(self, xt, top_i, e, cap, k):
        out = self.orig[1](xt, top_i, e, cap, k)
        if self.label is not None:
            self.runs[self.label]["keep"].append(out[3].clone())
        return out

    def hold(self, label, steps, n_layers) -> float:
        """Judge ``label``'s run against its replay (``label + " plain"``).
        ``steps``: a step's (owner of each routed token, owners it starts
        afresh, owner of each logits row, each row's error from
        ``row_errs``), each step n_layers router calls.  Returns the
        largest error of a row held; records the tokens routed apart and
        the rows exempt in ``ties``."""
        a, b = self.runs[label], self.runs[label + " plain"]
        n_calls = len(steps) * n_layers
        check(len(a["top_i"]) == len(b["top_i"]) == n_calls,
              f"{label}: {len(a['top_i'])} and {len(b['top_i'])} router "
              f"calls for {len(steps)} steps of {n_layers} layers")
        apart, worst, moved, exempt, worst_exempt = set(), 0.0, 0, 0, 0.0
        for i, (owner, fresh, row_owner, errs) in enumerate(steps):
            apart -= fresh
            owner = torch.as_tensor(owner)
            for c in range(i * n_layers, (i + 1) * n_layers):
                ia, ib = a["top_i"][c], b["top_i"][c]
                k = ia.shape[-1]
                went = (ia != ib).any(dim=-1).reshape(-1).cpu()
                dropped = (a["keep"][c] != b["keep"][c]).reshape(
                    -1, k).any(dim=-1).cpu()
                was = torch.tensor([int(o) in apart for o in owner])
                new = went & ~was
                if bool(new.any()):
                    gap = float(a["gap"][c].reshape(-1).cpu()[new].max())
                    check(gap < NEAR_TIE_MARGIN,
                          f"{label} step {i} layer {c - i * n_layers}: "
                          f"{int(new.sum())} tokens routed apart from the "
                          f"replay's, largest margin {gap:.3e} (not a "
                          f"near-tie: under {NEAR_TIE_MARGIN})")
                moved += int(went.sum())
                apart |= {int(o) for o in owner[went | dropped]}
            off = torch.tensor([int(o) in apart for o in row_owner])
            if bool((~off).any()):
                e = float(errs[~off].max())
                check(e <= REPLAY_RTOL, f"{label} step {i}: kernel vs plain "
                      f"logits {e} in a row whose routing never departed")
                worst = max(worst, e)
            if bool(off.any()):
                exempt += int(off.sum())
                worst_exempt = max(worst_exempt, float(errs[off].max()))
        self.ties[label] = {"tokens_routed_apart": moved,
                            "rows_exempt": exempt,
                            "worst_exempt": worst_exempt}
        if moved:
            print(f"  near-tie: {label}: {moved} tokens routed apart from "
                  f"the replay's, each first one of its request within "
                  f"{NEAR_TIE_MARGIN}; {exempt} logits rows of those "
                  f"requests exempt (largest error {worst_exempt:.3e})",
                  flush=True)
        return worst

    def drops(self, label, steps, n_layers) -> list:
        """(step name, dropped, assigned) of each step of a run."""
        keep = self.runs[label]["keep"]
        check(len(keep) == len(steps) * n_layers,
              f"{label}: {len(keep)} dispatches for {len(steps)} steps")
        d = [int((~x).sum()) for x in keep]
        a = [x.numel() for x in keep]
        return [(name, sum(d[i * n_layers:(i + 1) * n_layers]),
                 sum(a[i * n_layers:(i + 1) * n_layers]))
                for i, name in enumerate(steps)]


def moe_step_shares(fn, graph_ms) -> tuple:
    """(device ms a call, the experts' share, the attention linears' share)
    of ``fn`` over MOE_PROFILED_STEPS calls after a warm-up, by
    torch.profiler.  The device time sums the kernels (and copies) only:
    a ``record_function`` range also shows as a device event of its own,
    a span that would count its kernels twice.  The experts are the
    kernels launched under a ``moe.experts`` range around
    ``moe._expert_ffn`` (its host event's device time), the attention
    linears the sparse linear kernel (#1b) by name.  The kernels' sum a
    call must lie within MOE_PROFILE_BAND of ``graph_ms``, the same step's
    graph replay."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import moe

    ffn = moe._expert_ffn

    def ranged(*args):
        with record_function("moe.experts"):
            return ffn(*args)

    moe._expert_ffn = ranged
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(MOE_PROFILED_STEPS):
                fn()
            torch.cuda.synchronize()
    finally:
        moe._expert_ffn = ffn
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name != "moe.experts"]
    total = sum(e.time_range.elapsed_us() for e in kernels)
    experts = sum(e.device_time_total for e in events
                  if e.name == "moe.experts"
                  and e.device_type == DeviceType.CPU)
    linears = sum(e.time_range.elapsed_us() for e in kernels
                  if re.match(LINEAR_TILED_RE, e.name))
    ms = total / MOE_PROFILED_STEPS / 1e3
    lo, hi = MOE_PROFILE_BAND
    check(0 < experts < total and 0 < linears < total
          and lo <= ms / graph_ms <= hi,
          f"torch.profiler: kernels {total} us over {MOE_PROFILED_STEPS} "
          f"steps ({ms} ms a step, graph replay {graph_ms} ms), experts "
          f"{experts} us, attention linears {linears} us")
    return ms, experts / total, linears / total


def moe_drops(routes, label, rec, cfg) -> dict:
    """The assignments each prefill of a recorded run dropped (printed);
    a decode step of ZOO_REQUESTS slots drops none."""
    per = routes.drops(label, [n for n, *_ in rec.steps], cfg.n_layers)
    pre = [(d, a) for n, d, a in per if "prefill" in n]
    dec = [(d, a) for n, d, a in per if "decode" in n]
    check(sum(d for d, _ in dec) == 0, f"{label}: a decode step of "
          f"{ZOO_REQUESTS} slots dropped {[d for d, _ in dec]}")
    print(f"  {label}: (dropped, routed) assignments of each prefill over "
          f"{cfg.n_layers} layers (capacity factor {cfg.capacity_factor}): "
          f"{pre}; its decode steps dropped 0 of {sum(a for _, a in dec)}",
          flush=True)
    return {"prefill": pre, "decode": sum(a for _, a in dec)}


def moe_generate(dev, cfg, params, linears, routes) -> dict:
    """``Engine.generate`` (prefill and the contiguous decode step) on the
    prompts ``zoo_serve`` serves: exact launch counts, the assignments its
    prefill dropped, a teacher-forced replay under the near-tie rule."""
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.serve import Engine, ServeConfig

    label = f"{cfg.name} generate"
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=ZOO_NEW))
    rec = StepRecorder(engine, static=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with routes.record(label):
        res = engine.generate(zoo_prompts(cfg, SEED + 14))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    rec.restore()
    n_dec = sum(n == "decode_step" for n, *_ in rec.steps)
    want = {"colwise_nm_matmul_tiled": len(linears) * cfg.n_layers
            * (1 + n_dec)}
    check(counts == want, f"{label} launches {counts}, want {want}")
    check(res["tokens"].shape == (ZOO_REQUESTS, ZOO_NEW)
          and bool(((res["tokens"] >= 0)
                    & (res["tokens"] < cfg.vocab_size)).all()),
          f"{label} tokens {res['tokens'].shape}")
    print(f"  {label} (contiguous): 1 prefill + {n_dec} decode steps in "
          f"{wall:.3f} s, launches {counts} (want {want}); its tokens are "
          "not held to the paged run's: capacity drops depend on which "
          "tokens share a call", flush=True)
    drops = moe_drops(routes, label, rec, cfg)
    worst = replay_steps(rec, cfg, dev, label, routes)
    print(f"  {label} replay of all {len(rec.steps)} steps through the "
          f"plain versions: max rel err of the logits {worst:.3e} <= "
          f"{REPLAY_RTOL} of max|logit| in the rows held (RouteLog.hold: "
          f"{routes.ties[label]})", flush=True)
    return {"launches": counts, "host_s": wall, "drops": drops,
            "replay_max_rel_err": worst}


def run_moe(dev) -> dict:
    """Phase 15.  Returns each kernel's launches."""
    from repro_torch import dispatch

    t0 = time.perf_counter()
    db_path = PROFILE_DB.with_suffix(".moe.json")
    db_path.unlink(missing_ok=True)
    dispatch.set_db(dispatch.ProfileDB(path=db_path))
    routes = RouteLog()
    launches, rows, kept = {}, {}, None
    try:
        for arch, n_layers in MOE_MODELS:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            cfg, params, linears, init_s = zoo_model(dev, arch, n_layers)
            check(cfg.is_moe
                  and [n for _, n in linears] == ["q", "k", "v", "o"],
                  f"{arch}: MoE with the 4 attention linears, {linears}")
            served = zoo_serve(dev, cfg, params, linears, routes)
            gen = moe_generate(dev, cfg, params, linears, routes)
            scored = zoo_score(dev, cfg, params, linears, routes)
            peak = torch.cuda.max_memory_allocated()
            if arch == MOE_TRAIN_ARCH:  # phase 18 trains its first layers
                kept = (cfg.with_(n_layers=MOE_TRAIN_LAYERS),
                        cut_layers(params, MOE_TRAIN_LAYERS, clone=True))
            del params
            routes.runs.clear()
            torch.cuda.empty_cache()
            for c in (served["launches"], gen["launches"],
                      scored["launches"]):
                for k, n in c.items():
                    launches[k] = launches.get(k, 0) + n
            print(f"  {arch}: init {init_s:.1f} s, peak device memory "
                  f"{peak} bytes (torch.cuda.max_memory_allocated; {held} "
                  "held before its init)", flush=True)
            rows[arch] = {"layers": cfg.n_layers, "init_s": init_s,
                          "peak_bytes": peak, "held_bytes": held,
                          "serve": served, "generate": gen,
                          "score": scored}
    finally:
        routes.restore()
        dispatch.set_db(None)
        db_path.unlink(missing_ok=True)
    print(f"  routings apart from the replays' (RouteLog.hold): "
          f"{routes.ties}; "
          f"phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)
    print("MOE " + json.dumps({"models": rows, "launches": launches,
                               "near_ties": routes.ties}), flush=True)
    return {"launches": launches, "train_tree": kept}


def cut_layers(params, n: int, clone: bool = False):
    """The tree's first ``n`` stacked layers (views, or copies on the card
    with ``clone``, so the rest can be freed); the other leaves as they
    are."""
    from repro_torch._tree import tree_map

    cut = tree_map(lambda t: t[:n].clone() if clone else t[:n],
                   params["layers"])
    return dict(params, layers=cut)


# phase 16: the recurrent families.  xlstm-350m whole, and zamba2-7b at its
# published widths with its depth cut to 15 layers: 2 superblocks of 6 Mamba2
# layers, each followed by the shared attention block, and a tail of 3 (81 =
# 13 x 6 + 3 in miniature; all 81 layers would draw about 3.5 G values on the
# host).  Each: (arch, layers or None, launches a token step, tiled flash
# launches a scored forward, whether its step replay is held to
# REPLAY_RTOL).  A token step is one decode step, and one scored forward
# launches the same linears.  xlstm-350m at random weights amplifies
# rounding through its depth (no block has a pre-norm, the hidden state
# grows about 3x every few blocks): its plain version on the CPU departs
# from its plain version on the card by up to a third of max|logit| within
# 8 steps (PERF.md), so no float order meets REPLAY_RTOL there; its
# replay is measured beside the CPU's, and every linear launch of both
# models is held against its plain version on its own input (LinearCheck)
RECURRENT_MODELS = (
    ("xlstm-350m", None, {"colwise_nm_matmul_tiled": 111}, 0, False),
    ("zamba2-7b", 15, {"colwise_nm_matmul": 15,
                       "colwise_nm_matmul_tiled": 31}, 2, True),
)
RECURRENT_PROFILED_STEPS = 3  # torch.profiler window of the decode step
# the old sparse linear kernel (#1a) as the profiler names it
LINEAR_OLD_RE = r"^(void )?(\(anonymous namespace\)::)?linear_kernel\b"
# zamba2-7b's in_proj: d_out = 2 x 7168 + 2 x 64 + 112 = 14576 = 16 x 911,
# so no tile that divides it is a multiple of 64: #1a takes it.  Its rows in
# a decode step of 4 sequences, and in a scored 2 x 512 forward
IN_PROJ_SHAPE = (3584, 14576)
IN_PROJ_ROWS = (4, 1024)


def linear_launches(params, n_shared: int) -> dict:
    """Each sparse linear kernel's launches in one pass over ``params``:
    one a stacked layer (the leading axes of ``values``), the shared block's
    ``n_shared`` times; #1b where T is a multiple of its 64 columns, else
    #1a."""
    from repro_torch.kernels.colwise_nm import TILED_BN

    counts = {}

    def walk(tree, mult):
        if "values" in tree:
            v = tree["values"]
            k = ("colwise_nm_matmul_tiled" if v.shape[-1] % TILED_BN == 0
                 else "colwise_nm_matmul")
            counts[k] = counts.get(k, 0) + mult * int(np.prod(v.shape[:-3]))
            return
        for key, sub in tree.items():
            if isinstance(sub, dict):
                walk(sub, mult * (n_shared if key == "shared" else 1))

    walk(params, 1)
    return counts


def check_in_proj_kernel(dev) -> list:
    """Phase 16: colwise_nm_linear.cu (#1a) at zamba2-7b's in_proj, 3584 ->
    14576 at 50% with T = 14576, at IN_PROJ_ROWS rows, against its plain
    version within F32_RTOL, timed by graph replay beside the bound, the
    plain version and ``torch.matmul`` of the dense masked weight (TF32
    off).  These launches are not counted."""
    from repro_torch.core.formats import ColwiseMeta, unpack_colwise
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.core.sparse_linear import linear_init
    from repro_torch.kernels.colwise_nm import (colwise_nm_matmul_cuda,
                                                colwise_nm_matmul_ref)

    d_in, d_out = IN_PROJ_SHAPE
    gen = torch.Generator().manual_seed(SEED + 16)
    rng = np.random.default_rng(SEED + 17)
    sp = SparsityConfig(sparsity=0.5, m=None, tile=None,
                        format="compressed_pallas")
    layer = linear_init(gen, d_in, d_out, sp, device=dev)
    values, idx = layer["values"], layer["idx"]
    k_kept = values.shape[1]
    check(tuple(values.shape) == (1, d_in // 2, d_out),
          f"in_proj values {tuple(values.shape)}")
    w_dense = unpack_colwise(values, idx, ColwiseMeta(d_in, d_out, d_out,
                                                      d_in, k_kept))
    recs = []
    for rows in IN_PROJ_ROWS:
        x = torch.from_numpy(rng.standard_normal(
            (rows, d_in), dtype=np.float32)).to(dev)
        err = max_err(colwise_nm_matmul_cuda(x, values, idx),
                      colwise_nm_matmul_ref(x, values, idx),
                      f"colwise_nm_matmul in_proj rows={rows}", F32_RTOL)
        kernel = lambda: colwise_nm_matmul_cuda(x, values, idx)  # noqa: E731
        bound, by = bound_ms(linear_work(rows, values, idx, d_in),
                             torch.float32)
        rec = {"d_in": d_in, "d_out": d_out, "rows": rows, "k_kept": k_kept,
               "max_abs_err": err, "ms": time_ms(kernel),
               "eager_ms": eager_ms(kernel),
               "plain_ms": time_ms(lambda: colwise_nm_matmul_ref(
                   x, values, idx), iters=5),
               "matmul_ms": time_ms(lambda: torch.matmul(x, w_dense)),
               "bound_ms": bound, "bound_by": by,
               "sparse_gflop": 2 * rows * k_kept * d_out / 1e9}
        recs.append(rec)
        print(f"  colwise_nm_matmul (#1a) at zamba2-7b's in_proj {d_in}->"
              f"{d_out} (T = {d_out}, k_kept {k_kept}) rows={rows}: max|err| "
              f"{err:.3e} (<= {F32_RTOL} of max|y|); ms={rec['ms']:.5f} "
              f"(eager {rec['eager_ms']:.5f}) plain_ms={rec['plain_ms']:.5f} "
              f"torch.matmul ms={rec['matmul_ms']:.5f} (dense masked, TF32 "
              f"off) bound_ms={bound:.6f} ({by}); "
              f"{rec['sparse_gflop'] / rec['ms']:.2f} TFLOP/s", flush=True)
    del w_dense
    return recs


def recurrent_model(dev, arch, n_layers, per_step):
    """``arch`` at its published widths, ``n_layers`` deep (``None``: its
    own depth), every linear pruned to 50% with T = d_out, random weights
    from ``SEED`` on the card.  Returns (cfg, params, init s)."""
    from repro_torch._tree import leaves_with_path
    from repro_torch.configs import get_config
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.models import lm

    cfg = get_config(arch)
    depth = (f"{cfg.n_layers} layers (published)" if n_layers is None else
             f"{n_layers} layers (reduced from {cfg.n_layers})")
    cfg = cfg.with_(n_layers=n_layers or cfg.n_layers,
                    sparsity=SparsityConfig(sparsity=0.5, m=None, tile=None,
                                            format="compressed_pallas"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.lm_init(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_shared = (lm.n_shared_applications(cfg)
                if cfg.block_pattern == "mamba_shared_attn" else 0)
    got = linear_launches(params, n_shared)
    check(got == per_step, f"{arch}: sparse linears a token step {got}, "
          f"want {per_step}")
    widths = sorted({int(t.shape[-1]) for path, t in leaves_with_path(params)
                     if path[-1] == "values"})
    n_params = sum(t.numel() for t in tree_leaves(params))
    if cfg.block_pattern == "xlstm":
        blocks = (f"{cfg.n_layers // cfg.slstm_every} superblocks of "
                  f"{cfg.slstm_every - 1} mLSTM + 1 sLSTM, {cfg.n_heads} heads")
    else:
        every = cfg.shared_attn_every
        blocks = (f"{n_shared} superblocks of {every} Mamba2 + the shared "
                  f"block (one KV cache each), a tail of "
                  f"{cfg.n_layers - n_shared * every}; heads {cfg.n_heads}/"
                  f"{cfg.n_kv_heads}, head_dim {cfg.resolved_head_dim}, SSM "
                  f"state {cfg.ssm_state}, d_ff {cfg.d_ff}")
    print(f"  {arch}: {depth}, {blocks}, d_model {cfg.d_model}, expand "
          f"{cfg.expand}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), "
          f"untied embeddings, f32; sparsity 0.5, T = d_out {widths}; "
          f"sparse linears a token step {got}; {n_params} "
          f"stored values and indices from seed {SEED}, built in "
          f"{init_s:.1f} s", flush=True)
    return cfg, params, init_s


class LinearCheck:
    """Holds every sparse linear call of the models (``linear_apply`` as
    the model modules bound it) against the plain version on the same
    input while it is entered: each output within F32_RTOL of its max|y|.
    The plain call launches no kernel, so the launch counts stay the
    run's.  Each call's kernel-vs-plain rms error over max|y| goes to
    ``rms`` and the cosine of that error with y to ``cos``; with
    ``orders``, also, at every ORDER_STRIDE-th call, the plain version's on
    the CPU against the card's, on the same input (max and rms over max|y|,
    cosine), to ``order_max``, ``order_rms`` and ``order_cos``: the
    rounding of another float order beside the kernel's."""

    MODULES = ("attention", "blocks", "encdec", "lm", "mlp", "ssm", "xlstm")

    def __init__(self, orders: bool = False):
        self.orders = orders

    def __enter__(self):
        import importlib

        from repro_torch import dispatch

        self.mods = [importlib.import_module(f"repro_torch.models.{m}")
                     for m in self.MODULES]
        orig = self.orig = self.mods[0].linear_apply
        self.calls, self.worst = 0, 0.0
        self.rms, self.cos, on_cpu = [], [], {}
        self.order_max, self.order_rms, self.order_cos = [], [], []

        def rms(a, b):
            return float((a - b).pow(2).mean().sqrt()) / max(
                float(b.abs().max()), 1e-30)

        def cos(a, b):
            e, y = (a - b).reshape(-1).double(), b.reshape(-1).double()
            return float(e @ y) / max(float(e.norm() * y.norm()), 1e-300)

        def held(params, x, **kw):
            y = orig(params, x, **kw)
            if "values" in params:
                with dispatch.force_scope(linear="compressed_xla"):
                    want = orig(params, x, **kw)
                    if self.orders and self.calls % ORDER_STRIDE == 0:
                        # the layer's storage: a model slices its stacks
                        # into new views at every call
                        key = tuple((t.data_ptr(), tuple(t.shape)) for t in
                                    params.values())
                        if key not in on_cpu:
                            on_cpu[key] = {k: t.cpu() for k, t in
                                           params.items()}
                        cpu = orig(on_cpu[key], x.cpu(), **kw)
                        self.order_max.append(rel_err(want.cpu(), cpu))
                        self.order_rms.append(rms(want.cpu(), cpu))
                        self.order_cos.append(cos(want.cpu(), cpu))
                err = rel_err(y, want)
                check(err <= F32_RTOL, f"a linear {tuple(x.shape)} -> "
                      f"{tuple(y.shape)}: kernel vs plain on its input {err}")
                self.calls += 1
                self.worst = max(self.worst, err)
                self.rms.append(rms(y, want))
                self.cos.append(cos(y, want))
            return y

        for m in self.mods:
            m.linear_apply = held
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.linear_apply = self.orig
        return False


ORDER_STRIDE = 8  # LinearCheck(orders=True) takes every 8th call to the CPU


class NoisyLinears:
    """While entered, every sparse linear call of the models adds seeded
    Gaussian noise of ``sigma`` times its max|y| to its output: a control
    that gives the plain version rounding errors of a chosen size.  With
    ``repeat``, a linear's noise is drawn once for each output shape and
    added again at every call, as a rounding that a kernel makes alike on
    alike inputs would be."""

    def __init__(self, sigma: float, device, seed: int = SEED,
                 repeat: bool = False):
        self.sigma, self.repeat, self.drawn = sigma, repeat, {}
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def draw(self, params, y):
        key = (tuple((t.data_ptr(), tuple(t.shape)) for t in params.values()),
               tuple(y.shape))
        if not self.repeat or key not in self.drawn:
            self.drawn[key] = torch.randn(y.shape, generator=self.gen,
                                          device=y.device, dtype=y.dtype)
        return self.drawn[key]

    def __enter__(self):
        import importlib

        self.mods = [importlib.import_module(f"repro_torch.models.{m}")
                     for m in LinearCheck.MODULES]
        orig = self.orig = self.mods[0].linear_apply

        def noisy(params, x, **kw):
            y = orig(params, x, **kw)
            if "values" not in params:
                return y
            return y + self.sigma * y.abs().max() * self.draw(params, y)

        for m in self.mods:
            m.linear_apply = noisy
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.linear_apply = self.orig
        return False


def recurrent_replay(run_steps, steps, cfg, label, tokens, held,
                     tokens_held=None) -> dict:
    """Teacher-forced replay of a ``generate`` run's recorded ``steps`` (the
    prefill by decode steps, then each decode step) through ``run_steps``
    (the recorded engine's or another's step methods) with the plain
    versions, on a fresh cache.  With ``held``, each step's logits within
    REPLAY_RTOL of max|logit| of the recorded ones; with ``tokens_held``
    (by default ``held``), each greedy token equal to the replay's unless
    the replay puts the run's token within twice the step's error of its
    maximum (a near-tie).  Returns each
    step's error against the recorded logits, the replay's logits, the
    near-ties and the tokens apart from the replay's greedy ones."""
    from repro_torch import dispatch
    from repro_torch.kernels import KERNELS, reset_launch_counts

    tokens_held = held if tokens_held is None else tokens_held
    errs, logits, ties, apart_n, cache = [], [], 0, 0, None
    reset_launch_counts()
    with dispatch.force_scope(linear="compressed_xla"):
        for j, (name, inputs, kw, logits_k) in enumerate(steps):
            if name == "prefill_step":
                logits_p, cache = run_steps[name](*inputs)
            else:
                logits_p, cache = run_steps[name](cache, *inputs[:-1], **kw)
            logits_p = logits_p.to(logits_k.device)
            logits.append(logits_p)
            e = rel_err(logits_k, logits_p)
            errs.append(e)
            lp = logits_p[:, -1, :cfg.vocab_size].float()
            top = lp.max(dim=-1).values
            tok = torch.from_numpy(tokens[:, j].astype(np.int64)).to(lp.device)
            apart = lp.argmax(dim=-1) != tok
            apart_n += int(apart.sum())
            if held:
                check(e <= REPLAY_RTOL, f"{label} {name} {j}: kernel vs "
                      f"plain logits {e}")
            if tokens_held and bool(apart.any()):
                gap = float((top - lp.gather(1, tok[:, None])[:, 0])[apart]
                            .max())
                slack = 2 * e * float(logits_p.abs().max())
                check(gap <= slack, f"{label} {name} {j}: token apart from "
                      f"the replay's by {gap} (not a near-tie: over {slack})")
                ties += int(apart.sum())
    torch.cuda.synchronize()
    check(all(k.launches == 0 for k in KERNELS), f"the {label} replay launched")
    return {"errs": errs, "logits": logits, "ties": ties, "apart": apart_n}


def recurrent_generate(dev, cfg, params, per_step, held,
                       tokens_held=None, controls=False) -> dict:
    """``Engine.generate`` on ZOO_REQUESTS prompts of ZOO_PROMPT tokens,
    ZOO_NEW new, greedy: the prefill is ZOO_PROMPT decode steps into an empty
    state cache, then ZOO_NEW - 1 decode steps.  Exact launch counts, every
    linear launch held against its plain version on its input
    (``LinearCheck``), the plain replay (held to REPLAY_RTOL where
    ``held``, else measured beside the plain version's replay on the CPU,
    and with ``controls`` beside the plain replay under noise of the
    kernel's rms error a launch (``NoisyLinears``: XLSTM_NOISE_SEEDS
    draws, and one drawn once a linear and repeated) and of the CPU order's,
    and held to XLSTM_CONTROL_FACTOR times the farthest of the kernel-sized
    ones; its tokens held where ``tokens_held``, by default where
    ``held``), and the run again with the recorder off for the host
    times."""
    from repro_torch._tree import tree_map
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.serve import Engine, ServeConfig

    label = f"{cfg.name} ({cfg.n_layers} layers) generate"
    prompts = zoo_prompts(cfg, SEED + 16)
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=ZOO_NEW))
    rec = StepRecorder(engine, static=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with LinearCheck(orders=controls) as lin:
        res = engine.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    rec.restore()
    n_dec = sum(n == "decode_step" for n, *_ in rec.steps)
    steps = ZOO_PROMPT + n_dec
    want = {k: n * steps for k, n in per_step.items()}
    check(n_dec == ZOO_NEW - 1 and len(rec.steps) == ZOO_NEW,
          f"{label}: steps {[n for n, *_ in rec.steps]}")
    check(counts == want, f"{label} launches {counts}, want {want}")
    toks = res["tokens"]
    check(toks.shape == (ZOO_REQUESTS, ZOO_NEW)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{label} tokens {toks.shape}")
    check(lin.calls == sum(want.values()), f"{label}: {lin.calls} linear "
          f"calls held, {sum(want.values())} launched")
    print(f"  {label}: a prefill of {ZOO_PROMPT} decode steps into the state "
          f"cache, then {n_dec} decode steps, in {wall:.3f} s (each linear "
          f"held as it ran); launches {counts} (want {want}: {per_step} a "
          f"token step, {steps} token steps); every one of the {lin.calls} "
          f"linear launches within {lin.worst:.3e} <= {F32_RTOL} of max|y| "
          "of the plain version on its own input", flush=True)
    out = {"launches": counts, "host_s": wall, "linear_calls": lin.calls,
           "linear_max_rel_err": lin.worst}
    plain = recurrent_replay(rec.orig, rec.steps, cfg, label, toks, held,
                             tokens_held)
    worst = max(plain["errs"])
    out.update(replay_max_rel_err=worst, near_ties=plain["ties"],
               tokens_apart=plain["apart"])
    if held:
        print(f"  {label} replay of all {len(rec.steps)} steps through the "
              f"plain versions ({steps} token steps): max rel err of the "
              f"logits {worst:.3e} <= {REPLAY_RTOL} of max|logit|, tokens "
              f"equal (near-ties {plain['ties']})", flush=True)
    else:
        # the same steps through the plain versions on the CPU, held to
        # nothing either: how far two float orders of the plain version
        # part on this model
        cpu = Engine(cfg, tree_map(lambda t: t.cpu(), params),
                     ServeConfig(max_new_tokens=ZOO_NEW))
        card_plain = [(n, i, k, lg) for (n, i, k, _), lg in zip(
            rec.steps, plain["logits"])]
        on_cpu = recurrent_replay({n: getattr(cpu, n) for n in rec.orig},
                                  card_plain, cfg, label + " cpu", toks, False)
        del cpu
        out.update(cpu_vs_card_errs=on_cpu["errs"], kernel_errs=plain["errs"])
        print(f"  {label} replay of all {len(rec.steps)} steps through the "
              f"plain versions ({steps} token steps), not held: the logits' "
              f"rel err per step {[f'{e:.2e}' for e in plain['errs']]} (max "
              f"{worst:.3e}), {plain['apart']} of {toks.size} tokens apart "
              f"from the replay's greedy ones; the plain versions on the CPU "
              f"against the card's: {[f'{e:.2e}' for e in on_cpu['errs']]} "
              f"(max {max(on_cpu['errs']):.3e})", flush=True)
        if controls:
            out.update(noise_controls(dev, cfg, label, rec, card_plain, toks,
                                      lin, worst))
    quiet = engine.generate(prompts)
    check(np.array_equal(quiet["tokens"], toks),
          f"{label}: the recorder-off run's tokens differ")
    prefill_ms = quiet["prefill_s"] / ZOO_PROMPT * 1e3
    host_ms = quiet["decode_s"] / (ZOO_NEW - 1) * 1e3
    print(f"  {label} with the recorder off: tokens equal again, host "
          f"{prefill_ms:.3f} ms a prefill token step, {host_ms:.3f} ms a "
          "decode step (sampling included)", flush=True)
    out.update(prefill_host_ms_a_step=prefill_ms, decode_host_ms=host_ms)
    return out


def noise_controls(dev, cfg, label, rec, card_plain, toks, lin,
                   worst) -> dict:
    """The plain replay of ``rec``'s steps again on the card under
    ``NoisyLinears``, each against the plain replay (``card_plain``):
    noise of the kernel's mean rms error a launch (``lin``), drawn anew
    at every call from XLSTM_NOISE_SEEDS seeds and drawn once a linear and
    repeated, then of the CPU order's.  Holds the kernel's replay
    (``worst``) within XLSTM_CONTROL_FACTOR of the farthest kernel-sized
    one.  Returns the row."""
    k_rms, o_rms = float(np.mean(lin.rms)), float(np.mean(lin.order_rms))
    runs = [(f"kernel-sized, seed {s}", k_rms, s, False)
            for s in XLSTM_NOISE_SEEDS]
    runs += [("kernel-sized, repeated", k_rms, SEED, True),
             ("order-sized", o_rms, SEED, False)]
    noise = {}
    for name, sigma, seed, repeat in runs:
        t0 = time.perf_counter()
        with NoisyLinears(sigma, dev, seed, repeat):
            errs = recurrent_replay(rec.orig, card_plain, cfg,
                                    f"{label} {name} noise", toks,
                                    False)["errs"]
        noise[name] = errs
        print(f"  {label} plain replay under {name} noise "
              f"(sigma {sigma:.3e} of max|y| a launch): parts by "
              f"{[f'{e:.2e}' for e in errs]} ({time.perf_counter() - t0:.1f}"
              " s)", flush=True)
    control = max(max(e) for n, e in noise.items() if n.startswith("kernel"))
    ratio = worst / max(control, 1e-30)
    check(ratio <= XLSTM_CONTROL_FACTOR, f"{label}: the kernel's replay "
          f"parts by {worst}, {ratio}x the farthest plain replay under noise "
          f"of the kernel's size a launch ({control})")
    print(f"  {label} a launch, over max|y|: kernel vs plain rms {k_rms:.3e} "
          f"(max {lin.worst:.3e}, mean cosine with y "
          f"{float(np.mean(lin.cos)):.3e}); the plain version on the CPU vs "
          f"the card's rms {o_rms:.3e} (max {max(lin.order_max):.3e}, mean "
          f"cosine {float(np.mean(lin.order_cos)):.3e}); the kernel's replay "
          f"{worst:.3e}, {ratio:.2f}x the farthest kernel-sized control "
          f"{control:.3e} (<= {XLSTM_CONTROL_FACTOR})", flush=True)
    return {"kernel_rms": k_rms, "kernel_cos": float(np.mean(lin.cos)),
            "order_rms": o_rms, "order_max": max(lin.order_max),
            "order_cos": float(np.mean(lin.order_cos)), "noise": noise,
            "control_ratio": ratio}


def recurrent_step_shares(fn, graph_ms) -> dict:
    """Device ms a call of ``fn`` (a decode step) over
    RECURRENT_PROFILED_STEPS calls after a warm-up, by torch.profiler, each
    kernel counted once, and the shares of that kernel time taken by #1a
    and #1b (by name) and by the recurrent blocks' own code: the kernels
    under a ``recurrent.block`` range around each Mamba2, mLSTM and sLSTM
    decode, less those under a ``recurrent.linear`` range around their
    projections.  The kernels' sum a call must lie within MOE_PROFILE_BAND
    of ``graph_ms``, the same step's graph replay."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import ssm, xlstm

    saved = []

    def ranged(mod, name, label):
        f = getattr(mod, name)
        saved.append((mod, name, f))

        def g(*args, **kw):
            with record_function(label):
                return f(*args, **kw)
        setattr(mod, name, g)

    for mod in (ssm, xlstm):
        ranged(mod, "linear_apply", "recurrent.linear")
    for mod, name in ((ssm, "mamba_decode"), (xlstm, "mlstm_decode"),
                      (xlstm, "slstm_decode")):
        ranged(mod, name, "recurrent.block")
    labels = ("recurrent.linear", "recurrent.block")
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(RECURRENT_PROFILED_STEPS):
                fn()
            torch.cuda.synchronize()
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in labels]
    total = sum(e.time_range.elapsed_us() for e in kernels)

    def ranged_us(label):
        return sum(e.device_time_total for e in events
                   if e.name == label and e.device_type == DeviceType.CPU)

    old = sum(e.time_range.elapsed_us() for e in kernels
              if re.match(LINEAR_OLD_RE, e.name))
    tiled = sum(e.time_range.elapsed_us() for e in kernels
                if re.match(LINEAR_TILED_RE, e.name))
    scan = ranged_us("recurrent.block") - ranged_us("recurrent.linear")
    ms = total / RECURRENT_PROFILED_STEPS / 1e3
    lo, hi = MOE_PROFILE_BAND
    check(0 < tiled < total and 0 <= old < total and 0 < scan < total
          and lo <= ms / graph_ms <= hi,
          f"torch.profiler: kernels {total} us over {RECURRENT_PROFILED_STEPS}"
          f" steps ({ms} ms a step, graph replay {graph_ms} ms), #1a {old} "
          f"us, #1b {tiled} us, the blocks' own code {scan} us")
    return {"profiled_ms": ms, "linear_share": old / total,
            "linear_tiled_share": tiled / total, "scan_share": scan / total,
            "other_share": 1 - (old + tiled + scan) / total}


def recurrent_decode_step(dev, cfg, params, host_ms) -> dict:
    """One decode step of ZOO_REQUESTS sequences at position ZOO_PROMPT
    (the shared block's attention over ZOO_PROMPT rows): device ms by graph
    replay, the idle share against ``host_ms`` (generate's decode step),
    and the kernels' shares (``recurrent_step_shares``)."""
    from repro_torch import dispatch
    from repro_torch.models import lm

    cache = lm.cache_init(cfg, ZOO_REQUESTS, ZOO_PROMPT + ZOO_NEW, dev)
    tok = torch.from_numpy(zoo_prompts(cfg, SEED + 16)[:, :1].copy()).to(dev)
    pos = torch.full((ZOO_REQUESTS,), ZOO_PROMPT, dtype=torch.int32,
                     device=dev)

    def step():
        return lm.decode_step(params, cfg, cache, tok, pos)

    with dispatch.phase_scope("decode"):
        step_ms = time_ms(step, iters=2)
        shares = recurrent_step_shares(step, step_ms)
    idle = max(0.0, 1 - step_ms / host_ms)
    print(f"  {cfg.name} decode step: host {host_ms:.3f} ms (generate, "
          f"recorder off), device {step_ms:.4f} ms (graph replay), idle share "
          f"{idle:.3f}; torch.profiler {shares['profiled_ms']:.4f} ms a step, "
          f"of it #1a {shares['linear_share']:.3f}, #1b "
          f"{shares['linear_tiled_share']:.3f}, the recurrent blocks' plain "
          f"code (scans, conv, gates) {shares['scan_share']:.3f}, the rest "
          f"(embedding, norms, shared attention core, unembedding) "
          f"{shares['other_share']:.3f}", flush=True)
    return dict(shares, decode_device_ms=step_ms, idle=idle)


# xlstm-350m cut to its first superblocks, sliced from the whole tree: each
# superblock amplifies rounding, so the whole model (3) is measured, not
# held.  At 2 (16 layers) two float orders of the plain version already
# part by 1.5e-3 to 5.7e-3 of max|logit| (the card's against the CPU's,
# on phase 16's prompts), so its tokens are held and its logits measured
# beside the controls of ``recurrent_generate``; at 1 (8 layers) the replay
# is held to REPLAY_RTOL with the tokens equal.
# (layers, sparse linears a token step: 7 mLSTM x 5 + 1 sLSTM x 2 a
# superblock, logits held)
XLSTM_CUTS = ((16, 74, False), (8, 37, True))
# the unheld cut's replay may part from the plain one by at most this many
# times as far as the plain replay parts under noise of the kernel's rms
# error a launch (the farthest of these draws): rounding of the kernel's
# size, amplified by the model, with a margin for the draws' spread (the
# kernel's replay read 0.45x on an H100)
XLSTM_CONTROL_FACTOR = 2.0
XLSTM_NOISE_SEEDS = (SEED, SEED + 1, SEED + 2)


def xlstm_cuts(dev, cfg, params) -> dict:
    """Each XLSTM_CUTS cut of the whole model's tree (views: nothing drawn
    again) served by ``generate`` on phase 16's prompts, its replay's
    tokens held (no near-tie admitted where the logits are held too).
    Returns {layers: generate's row}."""
    from repro_torch._tree import tree_map

    rows = {}
    for n_layers, per, held in XLSTM_CUTS:
        n_super = n_layers // cfg.slstm_every
        cut = dict(params,
                   mlstm=tree_map(lambda t: t[:n_super], params["mlstm"]),
                   slstm=tree_map(lambda t: t[:n_super], params["slstm"]))
        per_step = {"colwise_nm_matmul_tiled": per}
        got = linear_launches(cut, 0)
        check(got == per_step, f"{cfg.name} cut to {n_layers} layers: sparse "
              f"linears a token step {got}, want {per_step}")
        gen = recurrent_generate(dev, cfg.with_(n_layers=n_layers), cut,
                                 per_step, held, tokens_held=True,
                                 controls=not held)
        check(not held or gen["near_ties"] == 0, f"{cfg.name} cut to "
              f"{n_layers} layers: {gen['near_ties']} tokens apart")
        rows[n_layers] = gen
    return rows


def run_recurrent(dev) -> dict:
    """Phase 16.  Returns each kernel's launches."""
    from repro_torch import dispatch

    t0 = time.perf_counter()
    in_proj = check_in_proj_kernel(dev)
    db_path = PROFILE_DB.with_suffix(".recurrent.json")
    db_path.unlink(missing_ok=True)
    dispatch.set_db(dispatch.ProfileDB(path=db_path))
    launches, rows = {}, {}
    try:
        for arch, n_layers, per_step, flash, replay_held in RECURRENT_MODELS:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            cfg, params, init_s = recurrent_model(dev, arch, n_layers,
                                                  per_step)
            gen = recurrent_generate(dev, cfg, params, per_step,
                                     replay_held)
            step = recurrent_decode_step(dev, cfg, params,
                                         gen["decode_host_ms"])
            want = {k: 2 * n for k, n in per_step.items()}
            if flash:
                want["flash_attention_tiled"] = 2 * flash
            scored = zoo_score(dev, cfg, params, None, want=want)
            peak = torch.cuda.max_memory_allocated()
            if cfg.block_pattern == "xlstm":
                cuts = xlstm_cuts(dev, cfg, params)
                for cut in cuts.values():
                    gen["launches"] = {k: n + cut["launches"].get(k, 0)
                                       for k, n in gen["launches"].items()}
                rows[f"{arch} cuts"] = cuts
            del params
            torch.cuda.empty_cache()
            for c in (gen["launches"], scored["launches"]):
                for k, n in c.items():
                    launches[k] = launches.get(k, 0) + n
            print(f"  {arch}: init {init_s:.1f} s, peak device memory {peak} "
                  f"bytes (torch.cuda.max_memory_allocated; {held} held "
                  "before its init)", flush=True)
            rows[arch] = {"layers": cfg.n_layers, "init_s": init_s,
                          "peak_bytes": peak, "held_bytes": held,
                          "generate": gen, "decode_step": step,
                          "score": scored}
    finally:
        dispatch.set_db(None)
        db_path.unlink(missing_ok=True)
    print(f"  phase 16 took {time.perf_counter() - t0:.1f} s", flush=True)
    print("RECURRENT " + json.dumps({"in_proj": in_proj, "models": rows,
                                     "launches": launches}), flush=True)
    return {"launches": launches}


# phase 17: the encoder-decoder and VLM families.  #7b alone at whisper's
# encoder attention (non-causal: B 2, S 1500 frames, 12 heads of 64); pruned
# whisper-small whole (12 encoder and 12 decoder layers), served by
# generate with its frames in ``extras`` and scored on Whisper's text
# context of 448 tokens (arXiv:2212.04356); pruned qwen2-vl-72b at its
# published widths cut to VLM_LAYERS layers, served paged and by generate
# and scored with VLM_GRID vision patches at Qwen2-VL 3-D positions
NONCAUSAL_SHAPE = (2, 1500, 12, 12, 64)  # B, S, H, KV, D
ENCDEC_ARCH = "whisper-small"
ENCDEC_PROMPT, ENCDEC_NEW, ENCDEC_SCORE_SEQ = 8, 32, 448
# #1b launches of whisper-small: a prefill or scored pass (the encoder's 6
# linears a layer, the decoder's 10: self q/k/v/o, cross q/k/v/o, up, down)
# and a decode step (the decoder's 8: the cross k/v come from the cache)
ENCDEC_PASS, ENCDEC_STEP = 12 * 6 + 12 * 10, 12 * 8
VLM_ARCH, VLM_LAYERS = "qwen2-vl-72b", 2
VLM_GRID = (16, 16)  # the config's 256 vision patches as one image


def check_noncausal_flash(dev) -> dict:
    """Phase 17: #7b (flash_attention_tiled.cu) at whisper-small's encoder
    attention, non-causal, f32, against its plain version within
    FLASH_TOL and bit for bit against flash_attention.cu, timed beside its
    plain version, SDPA (is_causal=False) and its operations bound.  These
    launches are not counted."""
    from repro_torch.kernels.flash_attn import (flash_attention_gqa_ref,
                                                flash_attention_scalar_cuda,
                                                flash_attention_tiled_cuda,
                                                flash_tiled_config,
                                                flash_tiled_takes)

    b, s, h, kv, d = NONCAUSAL_SHAPE
    rng = np.random.default_rng(SEED + 170)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev) for shape in (
            (b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    tag = f"B={b} S={s} H={h} KV={kv} D={d} non-causal f32"
    check(flash_tiled_takes(q, k, v), f"the tiled flash rule refuses {tag}")
    want = flash_attention_gqa_ref(q, k, v, causal=False)
    y = flash_attention_tiled_cuda(q, k, v, causal=False)
    err = max_err(y, want, f"flash_attention_tiled {tag}",
                  FLASH_TOL[torch.float32])
    check(torch.equal(y, flash_attention_scalar_cuda(q, k, v, causal=False)),
          f"flash_attention_tiled {tag}: not bit-identical to "
          "flash_attention.cu")
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    max_err(F.scaled_dot_product_attention(qh, kh, vh, is_causal=False)
            .transpose(1, 2), want, f"SDPA {tag}", FLASH_TOL[torch.float32])
    r = measure(lambda: flash_attention_tiled_cuda(q, k, v, causal=False),
                lambda: flash_attention_gqa_ref(q, k, v, causal=False),
                lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                       is_causal=False))
    r["bound_ms"], by = bound_ms(flash_work(b, s, s, h, kv, d, False, 4),
                                 torch.float32)
    gflop = 4 * b * h * d * s * s / 1e9
    rows, rpt = flash_tiled_config(d, torch.float32)
    print(f"  flash_attention_tiled (#7b) at whisper-small's encoder {tag} "
          f"({rows}x{rpt}): max|err| {err:.3e} (<= "
          f"{FLASH_TOL[torch.float32]} of max|y|), bit-identical to "
          f"flash_attention.cu; ms={r['ms']:.5f} (eager {r['eager_ms']:.5f}) "
          f"plain_ms={r['plain_ms']:.5f} SDPA ms={r['library_ms']:.5f} "
          f"bound_ms={r['bound_ms']:.6f} ({by}); {gflop / r['ms']:.2f} "
          f"TFLOP/s, SDPA {gflop / r['library_ms']:.2f}; tiled / SDPA = "
          f"{r['ms'] / r['library_ms']:.3f}", flush=True)
    return dict(r, bound_by=by, max_abs_err=err, shape=list(NONCAUSAL_SHAPE),
                gflop=gflop)


def encdec_model(dev):
    """whisper-small whole, every linear pruned to 50% with T = d_out,
    random weights from ``SEED`` on the card.  Returns (cfg, params, init
    s)."""
    from repro_torch._tree import leaves_with_path
    from repro_torch.configs import get_config
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.kernels.colwise_nm import TILED_BN
    from repro_torch.models import registry as reg

    cfg = get_config(ENCDEC_ARCH).with_(sparsity=SparsityConfig(
        sparsity=0.5, m=None, tile=None, format="compressed_pallas"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = reg.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    got = linear_launches(params, 0)
    check(got == {"colwise_nm_matmul_tiled": ENCDEC_PASS},
          f"{cfg.name}: sparse linears a pass {got}, want {ENCDEC_PASS} #1b")
    widths = sorted({int(t.shape[-1]) for path, t in leaves_with_path(params)
                     if path[-1] == "values"})
    check(all(w % TILED_BN == 0 for w in widths), f"T = d_out {widths}")
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"  {cfg.name}: {cfg.encoder_layers} encoder + {cfg.n_layers} "
          f"decoder layers (published), d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} (padded {cfg.padded_vocab}, tied), {cfg.norm}, "
          f"{cfg.mlp_act}, sinusoidal positions, f32; sparsity 0.5, T = d_out "
          f"{widths}; {ENCDEC_PASS} #1b a prefill or scored pass, "
          f"{ENCDEC_STEP} a decode step; {n_params} stored values and "
          f"indices from seed {SEED}, built in {init_s:.1f} s", flush=True)
    return cfg, params, init_s


def family_generate(cfg, prompts, engine, per_prefill, per_decode,
                    extras=None) -> dict:
    """``engine.generate`` on ``prompts`` (and ``extras``), greedy: exact
    #1b launches (``per_prefill`` + ``per_decode`` a decode step, nothing
    else), every linear launch held against its plain version on its own
    input (``LinearCheck``), a teacher-forced replay of every step through
    the plain versions held to REPLAY_RTOL with the tokens equal to the
    replay's or a near-tie, and the run again with the recorder off for
    the host times.  Returns the numbers, the tokens and the recorder."""
    from repro_torch.kernels import KERNELS, reset_launch_counts

    label = f"{cfg.name} generate"
    new = engine.scfg.max_new_tokens
    rec = StepRecorder(engine, static=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with LinearCheck() as lin:
        res = engine.generate(prompts, extras=extras)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    rec.restore()
    n_dec = sum(n == "decode_step" for n, *_ in rec.steps)
    check(n_dec == new - 1 and len(rec.steps) == new,
          f"{label}: steps {[n for n, *_ in rec.steps]}")
    want = {"colwise_nm_matmul_tiled": per_prefill + n_dec * per_decode}
    check(counts == want, f"{label} launches {counts}, want {want}")
    toks = res["tokens"]
    check(toks.shape == (len(prompts), new)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{label} tokens {toks.shape}")
    check(lin.calls == sum(want.values()), f"{label}: {lin.calls} linear "
          f"calls held, {sum(want.values())} launched")
    print(f"  {label}: {len(prompts)} prompts of {prompts.shape[1]} tokens"
          + (f" with {sorted(extras)}" if extras else "")
          + f", 1 prefill + {n_dec} decode steps in {wall:.3f} s (each "
          f"linear held as it ran); launches {counts} (want {want}: "
          f"{per_prefill} a prefill, {per_decode} a decode step); every one "
          f"of the {lin.calls} linear launches within {lin.worst:.3e} <= "
          f"{F32_RTOL} of max|y| of the plain version on its own input",
          flush=True)
    plain = recurrent_replay(rec.orig, rec.steps, cfg, label, toks, True)
    worst = max(plain["errs"])
    print(f"  {label} replay of all {len(rec.steps)} steps through the "
          f"plain versions: max rel err of the logits {worst:.3e} <= "
          f"{REPLAY_RTOL} of max|logit|, tokens equal (near-ties "
          f"{plain['ties']})", flush=True)
    quiet = engine.generate(prompts, extras=extras)
    check(np.array_equal(quiet["tokens"], toks),
          f"{label}: the recorder-off run's tokens differ")
    host_ms = quiet["decode_s"] / (new - 1) * 1e3
    print(f"  {label} with the recorder off: tokens equal again, prefill "
          f"{quiet['prefill_s'] * 1e3:.3f} ms, host {host_ms:.3f} ms a decode "
          "step (sampling included)", flush=True)
    return {"launches": counts, "host_s": wall, "linear_calls": lin.calls,
            "linear_max_rel_err": lin.worst, "replay_max_rel_err": worst,
            "near_ties": plain["ties"], "prefill_ms": quiet["prefill_s"] * 1e3,
            "decode_host_ms": host_ms, "tokens": toks, "rec": rec}


def encdec_decode_step(dev, cfg, params, host_ms) -> dict:
    """One whisper-small decode step of ZOO_REQUESTS sequences at position
    ENCDEC_PROMPT against the cross K/V of ``cfg.encoder_seq`` frames:
    device ms by graph replay and the idle share against ``host_ms``
    (generate's decode step)."""
    from repro_torch import dispatch
    from repro_torch.models import registry as reg

    cache = reg.cache_init_fn(cfg, ZOO_REQUESTS, ENCDEC_PROMPT + ENCDEC_NEW,
                              dev)()
    tok = torch.ones((ZOO_REQUESTS, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor(ENCDEC_PROMPT, dtype=torch.int32, device=dev)
    step = reg.decode_fn(cfg)
    with dispatch.phase_scope("decode"):
        step_ms = time_ms(lambda: step(params, cache, tok, pos), iters=2)
    idle = max(0.0, 1 - step_ms / host_ms)
    print(f"  {cfg.name} decode step: host {host_ms:.3f} ms (generate, "
          f"recorder off), device {step_ms:.4f} ms (graph replay), idle share "
          f"{idle:.3f}", flush=True)
    return {"decode_device_ms": step_ms, "decode_host_ms": host_ms,
            "idle": idle}


@contextmanager
def flash_causal_tally():
    """Counts the model's flash calls by their ``causal`` flag while
    entered."""
    from repro_torch.kernels import flash_attn

    orig = flash_attn.flash_attention
    tally = {True: 0, False: 0}

    def counted(q, k, v, *, causal=True, **kw):
        tally[causal] += 1
        return orig(q, k, v, causal=causal, **kw)

    flash_attn.flash_attention = counted
    try:
        yield tally
    finally:
        flash_attn.flash_attention = orig


def encdec_frames(cfg, b, seed, dev) -> torch.Tensor:
    """``b`` sequences of ``cfg.encoder_seq`` stub frame embeddings from
    ``seed``, on ``dev``."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)).to(dev)


def run_encdec(dev) -> dict:
    """whisper-small whole: generate, a decode step's times, the scoring
    forward's flash flags and the scored pass."""
    from repro_torch.models import registry as reg
    from repro_torch.serve import Engine, ServeConfig

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cfg, params, init_s = encdec_model(dev)
    prompts = np.random.default_rng(SEED + 171).integers(
        0, cfg.vocab_size, (ZOO_REQUESTS, ENCDEC_PROMPT)).astype(np.int32)
    frames = encdec_frames(cfg, ZOO_REQUESTS, SEED + 172, dev)
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=ENCDEC_NEW))
    gen = family_generate(cfg, prompts, engine, ENCDEC_PASS, ENCDEC_STEP,
                          extras={"enc_embeds": frames})
    del gen["rec"], engine
    step = encdec_decode_step(dev, cfg, params, gen["decode_host_ms"])
    extras = {"enc_embeds": encdec_frames(cfg, ZOO_SCORE_BATCH, SEED + 173,
                                          dev)}
    scfg = cfg.with_(attn_impl="pallas")
    tokens = torch.zeros((ZOO_SCORE_BATCH, ENCDEC_SCORE_SEQ),
                         dtype=torch.int32, device=dev)
    with torch.no_grad(), flash_causal_tally() as tally:
        reg.forward_fn(scfg)(params, dict(extras, tokens=tokens))
    want_flags = {False: cfg.encoder_layers, True: cfg.n_layers}
    check(tally == want_flags, f"{cfg.name} scoring flash calls by causal "
          f"flag {tally}, want {want_flags}")
    print(f"  {cfg.name} scoring forward: flash calls by causal flag {tally} "
          "(the encoder's non-causal, the decoder's causal; cross-attention "
          "plain SDPA)", flush=True)
    scored = zoo_score(dev, cfg, params, None, seq=ENCDEC_SCORE_SEQ,
                       extras=extras, want={
                           "colwise_nm_matmul_tiled": 2 * ENCDEC_PASS,
                           "flash_attention_tiled":
                               2 * (cfg.encoder_layers + cfg.n_layers)})
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    print(f"  {cfg.name}: init {init_s:.1f} s, peak device memory {peak} "
          f"bytes (torch.cuda.max_memory_allocated; {held} held before its "
          "init)", flush=True)
    gen["tokens"] = gen["tokens"].tolist()
    return {"layers": [cfg.encoder_layers, cfg.n_layers], "init_s": init_s,
            "peak_bytes": peak, "held_bytes": held, "generate": gen,
            "decode_step": step, "score": scored,
            "flash_by_causal": {str(k): n for k, n in tally.items()}}


def vlm_extras(cfg, dev) -> dict:
    """ZOO_SCORE_BATCH x ZOO_SCORE_SEQ tokens' vision inputs: one image of
    VLM_GRID patches after 1 + row text tokens in batch row ``row``, its
    embeddings from the seed, and Qwen2-VL's 3-D positions (the image's
    patches share a temporal index and take their row and column; the text
    after it continues from the largest of the three plus one)."""
    b, s = ZOO_SCORE_BATCH, ZOO_SCORE_SEQ
    gh, gw = VLM_GRID
    n = gh * gw
    check(n == cfg.vision_patches, f"{VLM_GRID} is not {cfg.vision_patches} "
          "patches")
    pos = np.zeros((b, 3, s), np.int32)
    vpos = np.zeros((b, n), np.int32)
    ii, jj = np.divmod(np.arange(n), gw)
    for r in range(b):
        off = 1 + r
        pos[r, :, :off] = np.arange(off)
        pos[r, 0, off:off + n] = off
        pos[r, 1, off:off + n] = off + ii
        pos[r, 2, off:off + n] = off + jj
        nxt = pos[r, :, :off + n].max() + 1
        pos[r, :, off + n:] = nxt + np.arange(s - off - n)
        vpos[r] = off + np.arange(n)
    ve = np.random.default_rng(SEED + 174).standard_normal(
        (b, n, cfg.d_model), dtype=np.float32)
    return {k: torch.from_numpy(a).to(dev) for k, a in (
        ("mrope_positions", pos), ("vision_embeds", ve), ("vision_pos", vpos))}


def run_vlm(dev) -> dict:
    """qwen2-vl-72b at its published widths, VLM_LAYERS deep: the paged
    scheduler and generate on the same prompts (tokens equal, or a
    near-tie), and the scored pass with vision inputs."""
    from repro_torch.serve import Engine, ServeConfig

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cfg, params, linears, init_s = zoo_model(dev, VLM_ARCH, VLM_LAYERS)
    check(cfg.mrope and cfg.mrope_sections == (16, 24, 24) and len(linears) == 7,
          f"{cfg.name}: M-RoPE {cfg.mrope_sections}, linears {linears}")
    served = zoo_serve(dev, cfg, params, linears, keep=True)
    per = len(linears) * cfg.n_layers
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=ZOO_NEW))
    gen = family_generate(cfg, zoo_prompts(cfg, SEED + 14), engine, per, per)
    del engine
    ties = hold_tokens({"tokens": gen.pop("tokens"), "rec": gen.pop("rec")},
                       {"paged": (served.pop("comps"), served.pop("rec"))},
                       cfg)
    print(f"  {cfg.name}: the paged run's tokens equal generate's "
          f"(near-ties {ties})", flush=True)
    scored = zoo_score(dev, cfg, params, linears, extras=vlm_extras(cfg, dev))
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    print(f"  {cfg.name}: init {init_s:.1f} s, peak device memory {peak} "
          f"bytes (torch.cuda.max_memory_allocated; {held} held before its "
          "init)", flush=True)
    return {"layers": cfg.n_layers, "init_s": init_s, "peak_bytes": peak,
            "held_bytes": held, "serve": served, "generate": gen,
            "near_ties": [list(t) for t in ties], "score": scored}


def run_encdec_vlm(dev) -> dict:
    """Phase 17.  Returns each kernel's launches."""
    from repro_torch import dispatch

    t0 = time.perf_counter()
    noncausal = check_noncausal_flash(dev)
    db_path = PROFILE_DB.with_suffix(".encdec.json")
    db_path.unlink(missing_ok=True)
    dispatch.set_db(dispatch.ProfileDB(path=db_path))
    launches, rows = {}, {}
    try:
        rows[ENCDEC_ARCH] = run_encdec(dev)
        rows[VLM_ARCH] = run_vlm(dev)
    finally:
        dispatch.set_db(None)
        db_path.unlink(missing_ok=True)
    for row in rows.values():
        for part in ("serve", "generate", "score"):
            for k, n in row.get(part, {"launches": {}})["launches"].items():
                launches[k] = launches.get(k, 0) + n
    print(f"  phase 17 took {time.perf_counter() - t0:.1f} s", flush=True)
    print("ENCDEC_VLM " + json.dumps({"noncausal_flash": noncausal,
                                      "models": rows, "launches": launches}),
          flush=True)
    return {"launches": launches}


# phase 18: MoE training.  (a) olmoe-1b-7b at its published widths cut to
# MOE_TRAIN_LAYERS of 16 (phase 15's tree, its stacks sliced: the
# functional AdamW step holds the old and new params and optimizer state at
# once, about 7x the float32 parameter bytes at the peak, so all 16 layers
# (14.3 GB) do not fit 80 GB and 8 (7.5 GB) do); (b) the LM Trainer on a
# 2-layer cut; (c) a world-1 NCCL group under the ShardingCtx; (d) the
# REDUCE format on smollm-360m whole
MOE_TRAIN_ARCH = "olmoe-1b-7b"
MOE_TRAIN_LAYERS = 8
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 256
MOE_TRAIN_STEPS = 3
MOE_TRAIN_LR = 3e-4
MOE_TRAIN_RTOL = 1e-4   # step 1's loss, aux, grad norm against the plain step
MOE_TRAIN_ATOL = 1e-4   # step 1's params against the plain step's
MOE_TRAIN_TIMED_STEPS = 3
MOE_TRAINER_LAYERS = 2
MOE_TRAINER_STEPS = 4
REDUCE_ARCH = "smollm-360m"
REDUCE_BATCH, REDUCE_SEQ = 2, 512


def bits_digest(tree) -> list:
    """Each leaf's bits reduced on the card to three int64 sums (of the
    32- or 16-bit words, of the words times an odd constant with wrap, and
    of the words xor-shifted): equal steps give equal digests, and a step
    whose float sums ran in another order moves at least one."""
    out = []
    for t in tree_leaves(tree):
        if t.is_floating_point():
            t = bits_of(t)
        w = t.reshape(-1).to(torch.int32) if t.element_size() < 4 else (
            t.reshape(-1).view(torch.int32) if t.element_size() == 4
            else t.reshape(-1))
        out.append(torch.stack([w.sum(dtype=torch.int64),
                                (w * 1000003).sum(dtype=torch.int64),
                                (w ^ (w >> 13)).sum(dtype=torch.int64)]))
    return torch.stack(out).cpu().tolist()


def moe_train_step(dev, cfg, params) -> dict:
    """(a).  Returns the report row."""
    from repro_torch import dispatch
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    tokens = np.random.default_rng(SEED + 18).integers(
        0, cfg.vocab_size, (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    step = make_train_step(cfg, AdamWConfig(lr=MOE_TRAIN_LR))
    opt0 = adamw_init(params)
    want = {"colwise_nm_matmul_tiled": 4 * cfg.n_layers}
    measured = {}

    def counted(label):
        """This step's launches, held to ``want`` and added to ``measured``."""
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in KERNELS if k.launches}
        check(counts == want, f"moe train {label} launches {counts}, want "
              f"{want}")
        for k, n in counts.items():
            measured[k] = measured.get(k, 0) + n

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with dispatch.force_scope(linear="compressed_xla"):
        p_plain, o_plain, m_plain = step(params, opt0, batch)
    torch.cuda.synchronize()
    check(all(k.launches == 0 for k in KERNELS), "the plain moe train step "
          f"launched {[(k.name, k.launches) for k in KERNELS if k.launches]}")
    plain_host = [t.cpu() for t in tree_leaves(p_plain)]
    m_plain = {k: float(v) for k, v in m_plain.items()}
    del p_plain, o_plain
    reset_launch_counts()
    p1, o1, m1 = step(params, opt0, batch)
    counted("step 1")
    m1f = {k: float(v) for k, v in m1.items()}
    for k in ("loss", "aux", "grad_norm"):
        e = abs(m1f[k] - m_plain[k]) / abs(m_plain[k])
        check(e <= MOE_TRAIN_RTOL, f"moe train step 1 {k} {m1f[k]!r} against "
              f"the plain step's {m_plain[k]!r}: {e}")
    check(m1f["aux"] > 0 and np.isfinite(m1f["grad_norm"])
          and np.isfinite(m1f["loss"]),
          f"moe train step 1: aux {m1f['aux']}, grad norm {m1f['grad_norm']}")
    param_err = max(float((t - h.to(dev)).abs().max()) for t, h in zip(
        tree_leaves(p1), plain_host) if t.is_floating_point())
    check(param_err <= MOE_TRAIN_ATOL, f"moe train step 1 params against "
          f"the plain step's: {param_err}")
    del plain_host
    digest = bits_digest((p1, o1, m1))
    del p1, o1, m1
    reset_launch_counts()
    p1, o1, m1 = step(params, opt0, batch)
    counted("step 1 again")
    repeat = bits_digest((p1, o1, m1)) == digest
    check(repeat, "two runs of moe train step 1 differ")
    del opt0
    peak = torch.cuda.max_memory_allocated()
    losses, gnorms = [m1f["loss"]], [m1f["grad_norm"]]
    p, o = p1, o1
    del p1, o1, m1
    for i in range(1, MOE_TRAIN_STEPS):
        reset_launch_counts()
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        counted(f"step {i + 1}")
    check(all(np.isfinite(losses)), f"moe train losses {losses}")

    def one():
        return step(p, o, batch)

    host = host_ms_per_step(one, MOE_TRAIN_TIMED_STEPS)
    dev_ms, port_ms = profiled_ms(one, MOE_TRAIN_TIMED_STEPS)
    del p, o

    # step 1 again with remat: each block recomputed in the backward, its
    # sparse linears' autograd twins (and so the kernels) run again there
    reset_launch_counts()
    t_remat = time.perf_counter()
    _p, _o, m_r = make_train_step(cfg.with_(remat=True), AdamWConfig(
        lr=MOE_TRAIN_LR))(params, adamw_init(params), batch)
    m_r = {k: float(v) for k, v in m_r.items()}
    del _p, _o
    torch.cuda.synchronize()
    t_remat = time.perf_counter() - t_remat
    remat_launches = {k.name: k.launches for k in KERNELS if k.launches}
    remat_err = {k: abs(m_r[k] - m1f[k]) / abs(m1f[k])
                 for k in ("loss", "grad_norm")}
    check(remat_err["loss"] <= 1e-6 and remat_err["grad_norm"] <= 1e-5,
          f"moe train step 1 with remat: loss {m_r['loss']!r}, grad norm "
          f"{m_r['grad_norm']!r} against {m1f['loss']!r}, "
          f"{m1f['grad_norm']!r} without: {remat_err}")
    print(f"  (a) {cfg.name} at its published widths, {cfg.n_layers} of 16 "
          f"layers ({cfg.n_experts} experts of d_ff {cfg.d_ff}, top "
          f"{cfg.top_k}), {MOE_TRAIN_STEPS} AdamW steps (lr {MOE_TRAIN_LR}) "
          f"on {MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ} uniform tokens: launches "
          f"{want} a step; losses {losses}, grad norms {gnorms}, step 1 aux "
          f"{m1f['aux']!r}; step 1 vs the plain step: loss {m1f['loss']!r} / "
          f"{m_plain['loss']!r}, aux {m1f['aux']!r} / {m_plain['aux']!r}, "
          f"grad norm {m1f['grad_norm']!r} / {m_plain['grad_norm']!r}, params "
          f"within {param_err:.3e}; step 1 twice: equal digests {repeat}; "
          f"step 1 with remat=True: loss {m_r['loss']!r}, grad norm "
          f"{m_r['grad_norm']!r} (rel err {remat_err}), launches "
          f"{remat_launches} (the forward's and the recompute's), "
          f"{t_remat:.2f} s", flush=True)
    print(f"  (a) a step: {host:.3f} host ms, {dev_ms:.3f} device ms "
          f"(torch.profiler), idle share {max(0.0, 1 - dev_ms / host):.3f}; "
          f"#1b {port_ms:.3f} ms (share {port_ms / dev_ms:.4f}); peak device "
          f"memory {peak} bytes (torch.cuda.max_memory_allocated)", flush=True)
    return {"launches_a_step": want, "launches": measured,
            "steps": MOE_TRAIN_STEPS,
            "losses": losses, "grad_norms": gnorms, "aux_step1": m1f["aux"],
            "plain_step1": m_plain, "param_err": param_err,
            "digest_repeat": repeat, "remat_step1": m_r,
            "remat_rel_err": remat_err, "remat_launches": remat_launches,
            "host_ms": host, "device_ms": dev_ms,
            "idle_share": max(0.0, 1 - dev_ms / host), "tiled_linear_ms": port_ms,
            "peak_bytes": peak}


def moe_trainer(dev, cfg, params, work) -> dict:
    """(b): 4 steps; a run to step 2 with its checkpoint; a Trainer restored
    from it repeats steps 3 and 4 bit for bit.  Returns the report row."""
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    data = DataConfig(vocab_size=cfg.vocab_size, batch=MOE_TRAIN_BATCH,
                      seq_len=MOE_TRAIN_SEQ, seed=0, kind="uniform")
    opt = AdamWConfig(lr=MOE_TRAIN_LR)

    def trainer(steps, ckpt):
        return Trainer(cfg, data, opt, TrainConfig(
            steps=steps, ckpt_dir=ckpt, ckpt_every=10 ** 6, log_every=1),
            params=params)

    from repro_torch.kernels import KERNELS, reset_launch_counts

    ta = trainer(MOE_TRAINER_STEPS, None)
    reset_launch_counts()
    out_a = ta.run()
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    want = {"colwise_nm_matmul_tiled": 4 * cfg.n_layers * MOE_TRAINER_STEPS}
    check(counts == want, f"the MoE Trainer launched {counts}, want {want}")
    t0 = time.perf_counter()
    trainer(2, str(work / "b")).run()
    write_s = time.perf_counter() - t0
    tc = trainer(MOE_TRAINER_STEPS, str(work / "b"))
    t0 = time.perf_counter()
    out_c = tc.run()
    resume_s = time.perf_counter() - t0
    check(out_c["start_step"] == 2 and out_c["final_step"] == MOE_TRAINER_STEPS,
          f"the restored Trainer ran {out_c['start_step']}..{out_c['final_step']}")
    la = [h["loss"] for h in out_a["history"]]
    lc = [h["loss"] for h in out_c["history"]]
    check(la[2:] == lc, f"restored losses {lc} against {la}")
    check(same_bits(ta.params, tc.params)
          and same_bits(ta.opt_state, tc.opt_state),
          "the restored run's params or opt state differ from the straight run")
    check(all(h["aux"] > 0 for h in out_a["history"]), "aux not positive")
    man = json.loads((tc.ckpt.dir / f"step_{MOE_TRAINER_STEPS:08d}"
                      / "manifest.json").read_text())
    print(f"  (b) the LM Trainer, {cfg.n_layers} layers of the same tree: "
          f"losses {la}; a run to step 2 with its checkpoint in {write_s:.1f} "
          f"s, then a Trainer restored from it ran steps 3-4 in "
          f"{resume_s:.1f} s (restore, steps, a {man['arrays_bytes']}-byte "
          f"checkpoint): losses {lc}, params and opt state bit for bit",
          flush=True)
    shutil.rmtree(work / "b", ignore_errors=True)
    return {"losses": la, "resumed_losses": lc, "ckpt_bytes":
            man["arrays_bytes"], "write_s": write_s, "resume_s": resume_s,
            "launches": counts}


def moe_world1(dev, cfg, params) -> dict:
    """(c): the 2-layer step on a world-1 NCCL group, plain and under the
    ShardingCtx with moe_impl="shard_map"; then the launcher."""
    import torch.distributed as dist

    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding import ShardingCtx, use_ctx

    tokens = np.random.default_rng(SEED + 19).integers(
        0, cfg.vocab_size, (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    started = not dist.is_initialized()
    mesh = make_host_mesh(dev)
    try:
        plain = make_train_step(cfg, AdamWConfig(lr=MOE_TRAIN_LR))(
            params, adamw_init(params), batch)
        with use_ctx(ShardingCtx(mesh=mesh)):
            shard = make_train_step(cfg.with_(moe_impl="shard_map"),
                                    AdamWConfig(lr=MOE_TRAIN_LR))(
                params, adamw_init(params), batch)
        same = same_bits(plain[:2], shard[:2]) and all(
            torch.equal(plain[2][k], shard[2][k]) for k in plain[2])
        check(same, "the step under the world-1 ShardingCtx differs")
        backend = dist.get_backend()
        del plain, shard
        t0 = time.perf_counter()
        launch_train.main(["--arch", MOE_TRAIN_ARCH, "--smoke", "--mesh",
                           "host", "--steps", "2"])
        launcher_s = time.perf_counter() - t0
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    print(f"  (c) a world-1 {backend} group, mesh {tuple(mesh.shape)} "
          f"{mesh.mesh_dim_names}: the step under the ShardingCtx with "
          f"moe_impl='shard_map' equal bit for bit to the step without; the "
          f"launcher --arch {MOE_TRAIN_ARCH} --smoke --mesh host --steps 2 "
          f"returned in {launcher_s:.1f} s", flush=True)
    return {"backend": backend, "bitwise": same, "launcher_s": launcher_s}


def reduce_scoring(dev) -> dict:
    """(d): smollm-360m whole under shard_local_reduce, scored once."""
    from repro_torch import dispatch
    from repro_torch.configs import get_config
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.models import registry as reg

    cfg = get_config(REDUCE_ARCH).with_(sparsity=SparsityConfig(
        sparsity=0.5, m=None, tile=None, format="compressed_pallas",
        shard_local_reduce=True))
    t0 = time.perf_counter()
    params = lm.lm_init(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layers = params["layers"]
    check("values_r" in layers["attn"]["o"] and "values_r" in
          layers["mlp"]["down"] and all("values" in layers[a][n] for a, n in
                                         LINEARS if n not in ("o", "down")),
          "the REDUCE format on o and down, the tiled format on the rest")
    shapes = {n: tuple(layers[a][n]["values_r"].shape)
              for a, n in (("attn", "o"), ("mlp", "down"))}
    tokens = np.random.default_rng(SEED + 20).integers(
        0, cfg.vocab_size, (REDUCE_BATCH, REDUCE_SEQ)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    loss = reg.loss_fn(cfg)
    with torch.no_grad():
        reset_launch_counts()
        with dispatch.force_scope(linear="compressed_xla"):
            want_nll = float(loss(params, batch)[1]["nll"])
        torch.cuda.synchronize()
        check(all(k.launches == 0 for k in KERNELS), "the plain REDUCE replay "
              f"launched {[(k.name, k.launches) for k in KERNELS if k.launches]}")
        reset_launch_counts()
        nll = float(loss(params, batch)[1]["nll"])
        counts = {k.name: k.launches for k in KERNELS if k.launches}
        want = {"colwise_nm_matmul_tiled": 5 * cfg.n_layers}
        check(counts == want, f"REDUCE scoring launches {counts}, want {want}")
        err = abs(nll - want_nll) / abs(want_nll)
        check(err <= SCORE_NLL_RTOL, f"REDUCE scoring NLL {nll!r} against the "
              f"plain replay's {want_nll!r}")
        host = eager_ms(lambda: loss(params, batch), 3)
    print(f"  (d) {cfg.name} whole ({cfg.n_layers} layers), sparsity 0.5 with "
          f"shard_local_reduce: o and down in the REDUCE format "
          f"(values_r {shapes}), built in {init_s:.1f} s; scored on "
          f"{REDUCE_BATCH} x {REDUCE_SEQ} tokens: launches {counts} a "
          f"forward; NLL {nll!r} against the plain replay's {want_nll!r} "
          f"(rel {err:.2e}); {host:.3f} host ms a forward", flush=True)
    return {"launches": counts, "nll": nll, "plain_nll": want_nll,
            "host_ms": host, "values_r": shapes}


def run_moe_train(dev, tree) -> dict:
    """Phase 18 on phase 15's kept tree.  Returns each kernel's launches."""
    from repro_torch import dispatch

    t0 = time.perf_counter()
    cfg, params = tree
    db_path = PROFILE_DB.with_suffix(".moe_train.json")
    db_path.unlink(missing_ok=True)
    dispatch.set_db(dispatch.ProfileDB(path=db_path))
    work = Path(tempfile.mkdtemp(prefix="moe-train-", dir=ROOT / "build"))
    try:
        small_cfg = cfg.with_(n_layers=MOE_TRAINER_LAYERS)
        small = cut_layers(params, MOE_TRAINER_LAYERS)
        trainer = moe_trainer(dev, small_cfg, small, work)
        world1 = moe_world1(dev, small_cfg, small)
        del small
        torch.cuda.empty_cache()
        step = moe_train_step(dev, cfg, params)
        del params, tree
        torch.cuda.empty_cache()
        reduce = reduce_scoring(dev)
    finally:
        dispatch.set_db(None)
        db_path.unlink(missing_ok=True)
        shutil.rmtree(work, ignore_errors=True)
    # the train launches as counted: (a)'s step 1, its repeat and steps
    # 2-3, and (b)'s straight run; the scoring launches: (d)'s forward
    train = dict(step["launches"])
    for k, n in trainer["launches"].items():
        train[k] = train.get(k, 0) + n
    print(f"  phase 18 took {time.perf_counter() - t0:.1f} s", flush=True)
    print("MOE_TRAIN " + json.dumps({"step": step, "trainer": trainer,
                                     "world1": world1, "reduce": reduce}),
          flush=True)
    return {"launches": reduce["launches"], "train_launches": train}


# phase 19: the port's contracts.  (a) the checker; (b) the on-card half of
# DP301/DP302 over the registry's CUDA candidates at the checker's small
# probe keys; (c) the ring collective matmul and the compressed cross-pod
# reduction on a world-1 NCCL group
RING_SHAPE = (256, 1024, 512)  # rows, d_in, d_out
CROSSPOD_SHAPE = (4096, 1024)


def run_checker() -> dict:
    """(a): the checker over the tree, in process; raises on any finding."""
    from repro_torch.analysis import engine

    port = ROOT / "src" / "repro_torch"
    t0 = time.perf_counter()
    report = engine.run([port], baseline=engine.load_baseline(
        port / "analysis" / "baseline.json"))
    secs = time.perf_counter() - t0
    check(not report.findings and not report.unused_waivers and
          not report.waived, "the checker reports:\n" +
          engine.render_text(report))
    rules = [r.id for r in engine.all_rules()]
    print(f"  (a) repro_torch.analysis over {report.files} files "
          f"(src/repro_torch, csrc/ included), rules {rules}: 0 findings, "
          f"0 waived, in {secs:.2f} s", flush=True)
    return {"files": report.files, "findings": 0, "s": secs}


def probe_call(spec, key, launch, dev):
    """The operands of ``launch.call`` for ``key`` on ``dev`` (seeded),
    the forced call through dispatch and its plain version: (y, plain)."""
    from repro_torch import dispatch
    from repro_torch.core.sparse_linear import forward_compressed_xla, linear_apply
    from repro_torch.kernels.conv_gemm.ops import _to_cnhw, conv2d_sparse
    from repro_torch.kernels.conv_gemm.ref import conv2d_fused_ref
    from repro_torch.kernels.flash_attn import paged_attention
    from repro_torch.kernels.flash_attn.ref import paged_attention_ref

    dtype = torch.float32 if key.dtype == "f32" else torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def compressed(d_in):
        n_tiles = key.d_out // key.tile
        values = rand(n_tiles, key.k_kept, key.tile) / key.k_kept ** 0.5
        idx = torch.argsort(torch.rand((n_tiles, d_in), generator=gen,
                                       device=dev), dim=1)[:, :key.k_kept]
        return values, torch.sort(idx, dim=1).values.to(torch.int32)

    if key.op == "linear":
        rows, d_in = launch.call
        x = rand(rows, d_in)
        values, idx = compressed(d_in)
        with dispatch.force_scope(linear=spec.name):
            y = linear_apply({"values": values, "idx": idx}, x)
        return y, forward_compressed_xla(x, values, idx)
    if key.op == "conv":
        c, b, h, w = launch.call
        kh, kw, s, p, v = (key.get(n) for n in ("kh", "kw", "s", "p", "v"))
        x = rand(c, b, h, w)
        values, idx = compressed(kh * kw * c)
        with dispatch.force_scope(conv=spec.name):
            y = conv2d_sparse(x, values, idx, kh=kh, kw=kw, stride=s, pad=p,
                              v=v)
        plain = conv2d_fused_ref(x, values, idx, kh=kh, kw=kw, stride=s,
                                 pad=p, v=v)
        return y, _to_cnhw(plain, b, y.shape[2], y.shape[3])
    b, sq, n_max = launch.call
    ps = spec.geom("ps")
    hd, kv = key.get("hd"), key.k_kept
    h = key.d_out // hd
    q, k_new, v_new = rand(b, sq, h, hd), rand(b, sq, kv, hd), rand(b, sq, kv, hd)
    k_pages = rand(b * n_max + 1, ps, kv, hd)
    v_pages = rand(b * n_max + 1, ps, kv, hd)
    tables = torch.arange(b * n_max, dtype=torch.int32,
                          device=dev).reshape(b, n_max)
    lengths = torch.randint(0, n_max * ps + 1, (b,), generator=gen,
                            device=dev, dtype=torch.int32)
    args = (q, k_new, v_new, k_pages, v_pages, tables, lengths)
    with dispatch.force_scope(paged_attn=spec.name):
        y = paged_attention(*args, page_size=ps)
    return y, paged_attention_ref(*args)


def card_calls(spec, launches):
    """The calls of a key phase 19 makes on the card: the one call of a
    linear or conv key; a paged key's at Sq 1 (decode) and at Sq =
    min(bq, its rows)."""
    if spec.op != "paged_attn":
        return launches
    top = min(spec.geom("bq"), max(la.call[1] for la in launches))
    return [la for la in launches if la.call[1] in (1, top)]


def run_smem_audit(dev) -> dict:
    """(b): every CUDA candidate at the small probe keys it admits, then the
    over-budget keys.  Returns each kernel's launches."""
    from repro_torch import dispatch
    from repro_torch.analysis import rules_dispatch as D
    from repro_torch.dispatch import registry as R
    from repro_torch.kernels import KERNELS, reset_launch_counts

    by_name = {k.name: k for k in KERNELS}
    packs = ("im2col_pack", "im2col_pack_tiled")
    totals = {k.name: 0 for k in KERNELS}
    calls, sized, impls, refused = 0, 0, set(), []
    db_path = PROFILE_DB.with_suffix(".contracts.json")
    db_path.unlink(missing_ok=True)
    dispatch.set_db(dispatch.ProfileDB(path=db_path))
    over = D.over_budget(R)
    try:
        for spec, key, launches in D.audit(R):
            if key in over or not (D.small(key) and spec.feasible(key)[0]):
                continue
            check(launches, f"{spec.name} admits {key.token} but its wrapper "
                  "refuses every call of its shapes")
            declared = spec.smem_bytes(key)
            for la in card_calls(spec, launches):
                reset_launch_counts()
                with torch.no_grad():
                    y, plain = probe_call(spec, key, la, dev)
                torch.cuda.synchronize()
                got = {k.name: k.launches for k in KERNELS if k.launches}
                for n, c in got.items():
                    totals[n] += c
                # the two-kernel plans pack first (the pack kernel sizes no
                # shared memory)
                two_kernel = spec.name.startswith(("im2col_sparse_pallas",
                                                   "two_kernel_pipelined"))
                n_packs = sum(got.pop(n, 0) for n in packs)
                check(got == {la.kernel: 1} and n_packs == int(two_kernel),
                      f"{spec.name} at {key.token}, call {la.call}: launched "
                      f"{got} and {n_packs} packs, want {la.kernel} once")
                kernel = by_name[la.kernel]
                if la.sized:
                    check(kernel.last_smem_bytes == la.smem <= declared,
                          f"{spec.name} at {key.token}, call {la.call}: "
                          f"{la.kernel} requested {kernel.last_smem_bytes} "
                          f"bytes; the checker counts {la.smem}, the "
                          f"registry {declared}")
                    sized += 1
                rtol = F32_RTOL if key.dtype == "f32" else BF16_RTOL
                err = rel_err(y.float(), plain.float())
                check(torch.isfinite(y).all() and err <= rtol,
                      f"{spec.name} at {key.token}, call {la.call}: rel err "
                      f"{err:.3e} > {rtol}")
                calls += 1
                impls.add(spec.name)
        for key in over:
            for spec in R.REGISTRY.candidates(key.op):
                if spec.backend != "cuda":
                    continue
                most = max((la.smem for la in D.probe_launches(spec, key)),
                           default=0)
                if most <= R.SMEM_BYTES:
                    continue
                reset_launch_counts()
                ok, why = spec.feasible(key)
                check(not ok and not any(k.launches for k in KERNELS),
                      f"{spec.name} admits over-budget {key.token} "
                      f"({most} bytes)")
                refused.append({"impl": spec.name, "key": key.token,
                                "smem": most, "why": why})
    finally:
        dispatch.set_db(None)
        db_path.unlink(missing_ok=True)
    reset_launch_counts()
    launched = {n: c for n, c in totals.items() if c}
    print(f"  (b) {calls} forced calls of {len(impls)} CUDA candidates at "
          f"the small probe keys, each within 1e-4 / 2e-2 of max|y| of its "
          f"plain version and launching the kernel the checker names; "
          f"last_smem_bytes equal to the checker's count and within the "
          f"registry's in {sized} (the rest: conv2d_fused.cu and "
          f"colwise_nm_strips.cu size their own); launches {launched}",
          flush=True)
    print(f"  (b) {len(refused)} over-budget (candidate, key) pairs refused "
          f"by feasible with no launch: "
          f"{[(r['impl'], r['key'], r['smem']) for r in refused]}", flush=True)
    return {"calls": calls, "sized": sized, "refused": refused,
            "launches": launched}


def run_collectives(dev) -> dict:
    """(c): the ring and the cross-pod reduction on a world-1 NCCL group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.grad_compress import (compress_with_feedback,
                                                 crosspod_psum_compressed,
                                                 dequantize_int8)
    from repro_torch.sharding import (ShardingCtx, ring_allgather_matmul,
                                      ring_allgather_matmul_local, use_ctx)

    gen = torch.Generator(device=dev).manual_seed(SEED + 39)
    rows, d_in, d_out = RING_SHAPE
    x = torch.randn((rows, d_in), generator=gen, device=dev)
    w = torch.randn((d_in, d_out), generator=gen, device=dev)
    g = torch.randn(CROSSPOD_SHAPE, generator=gen, device=dev)
    e = 0.01 * torch.randn(CROSSPOD_SHAPE, generator=gen, device=dev)
    started = not dist.is_initialized()
    mesh = make_host_mesh(dev)
    try:
        backend = dist.get_backend()
        with torch.no_grad():
            y = ring_allgather_matmul(x, w, mesh, axis="model")
            y_group = ring_allgather_matmul_local(
                x, w, group=mesh.get_group("model"))
            want = x @ w
        check(y.device.type == dev.type and torch.equal(y, want)
              and torch.equal(y_group, want),
              "the ring at world size 1 differs from x @ w")
        q, scale, err = compress_with_feedback(g, e)
        with use_ctx(ShardingCtx(mesh=mesh)):
            reduced, new_error = crosspod_psum_compressed(g, e, axis="pod")
            reduced_m, _ = crosspod_psum_compressed(g, e, axis="model")
        own = dequantize_int8(q, scale)
        check(reduced.device.type == dev.type and torch.equal(reduced, own)
              and torch.equal(reduced_m, own) and torch.equal(new_error, err),
              "the cross-pod reduction at world size 1 is not the rank's own "
              "dequantized part")
        torch.cuda.synchronize()
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    print(f"  (c) a world-1 {backend} group, mesh {tuple(mesh.shape)} "
          f"{mesh.mesh_dim_names}: ring_allgather_matmul x {list(x.shape)} @ "
          f"w {list(w.shape)} (through the mesh and through the model "
          f"group) equal to x @ w; crosspod_psum_compressed of "
          f"{list(g.shape)} (axis 'pod', absent, and 'model', of 1 rank) "
          "equal to the rank's dequantized part, its error bit for bit. "
          "World size 1: nothing crosses a link, so this shows only that "
          "the code runs on the card with NCCL; no traffic between cards is "
          "measured", flush=True)
    return {"backend": backend, "ring_equal": True, "crosspod_equal": True}


def run_contracts(dev) -> dict:
    """Phase 19.  Returns each kernel's launches."""
    t0 = time.perf_counter()
    checker = run_checker()
    audit = run_smem_audit(dev)
    collectives = run_collectives(dev)
    secs = time.perf_counter() - t0
    print(f"  phase 19 took {secs:.1f} s", flush=True)
    print("CONTRACTS " + json.dumps({"checker": checker, "audit": audit,
                                     "collectives": collectives, "s": secs}),
          flush=True)
    return {"launches": audit["launches"]}


# phase 20: the layout.  smollm-360m whole at its published widths, pruned
# as pruned_smollm prunes it with cfg.tp = 2 (16 q heads, one zero-padded),
# laid out on worlds of 2 ranks (model 2) and 4 (data 2 x model 2), spawned
# on the one card and joined by gloo: the scoring loss and forward under
# attn_impl="pallas", a prefill and greedy decode steps on each rank's
# shards, held against the same calls on whole params in this process
LAYOUT_WORLDS = ((1, 2), (2, 2))  # (data, model)
LAYOUT_VARIANTS = ("compressed", "reduce")
LAYOUT_SCORE = (2, 512)   # B, S of the scoring forward
LAYOUT_PROMPT = (4, 128)  # B, S of the prefill
LAYOUT_NEW = 8            # greedy decode steps
LAYOUT_TOL = 1e-5         # of max|logit|, against whole params (REDUCE too)
LAYOUT_NLL_RTOL = 1e-6
LAYOUT_TIMEOUT_S = 300
LAYOUT_LABEL = "gloo, staged through the host: a layout check, not " \
               "tensor-parallel speed"
LAYOUT_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; chip_smoke.layout_rank(*sys.argv[2:])")


# (d): training under the layout in the data 2 x model 2 world, on the
# params its ranks laid out: 2 AdamW steps on LAYOUT_TRAIN_BATCH rows of
# LAYOUT_TRAIN_SEQ tokens of the LM pipeline (batch_at(step), a pure
# function of the step), a checkpoint written by rank 0 after step 1 and a
# resume in the same world that repeats step 2; held against
# make_train_step on whole params in this process
LAYOUT_TRAIN_BATCH, LAYOUT_TRAIN_SEQ = 2, 256
LAYOUT_TRAIN_OPT = dict(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
LAYOUT_TRAIN_RTOL = 1e-5  # loss and grad_norm, against whole params
LAYOUT_GRAD_TOL = 1e-5    # the CPU tests' gradient tolerance (of max|g|)


def layout_cfg(variant: str, tp: int):
    """smollm-360m pruned as ``pruned_smollm`` prunes it, ``cfg.tp`` the
    model axis, scored under ``attn_impl="pallas"``; the "reduce" variant
    with ``shard_local_reduce`` and one REDUCE group a model rank."""
    from repro_torch.configs import get_config
    from repro_torch.core.pruning import SparsityConfig

    reduce = variant == "reduce"
    return get_config("smollm-360m").with_(
        tp=tp, attn_impl="pallas", sparsity=SparsityConfig(
            sparsity=0.5, m=None, tile=None, format="compressed_pallas",
            shard_local_reduce=reduce, reduce_groups=tp if reduce else 0))


def layout_run(cfg, params, dev, mesh=None) -> dict:
    """The phase's main path through the registry on ``params``, whole or
    laid out on ``mesh``: the scoring loss and forward on LAYOUT_SCORE
    uniform tokens, a prefill of LAYOUT_PROMPT tokens and LAYOUT_NEW greedy
    decode steps.  Returns the global outputs (``sharding.full``)."""
    from repro_torch.models import registry as reg
    from repro_torch.sharding.api import full, local

    rng = np.random.default_rng(SEED + 60)
    score = torch.from_numpy(rng.integers(0, cfg.vocab_size, LAYOUT_SCORE,
                                          dtype=np.int32)).to(dev)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, LAYOUT_PROMPT,
                                           dtype=np.int32)).to(dev)
    out = {}
    with torch.no_grad():
        _, metrics = reg.loss_fn(cfg)(params, {"tokens": score})
        out["nll"] = float(metrics["nll"])
        out["score_logits"] = full(reg.forward_fn(cfg)(params,
                                                       {"tokens": score}))
        logits, pre = reg.prefill_fn(cfg)(params, {"tokens": prompt})
        b, p = prompt.shape
        cache = reg.cache_init_fn(cfg, b, p + LAYOUT_NEW, device=dev,
                                  mesh=mesh)()
        for k, v in cache.items():
            local(v)[:, :, :p] = local(pre[k])
        steps, toks = [full(logits)], []
        for i in range(LAYOUT_NEW):
            tok = steps[-1][:, -1, :cfg.vocab_size].argmax(-1).to(
                torch.int32)[:, None]
            toks.append(tok)
            logits, cache = reg.decode_fn(cfg)(params, cache, tok, p + i)
            steps.append(full(logits))
        out["steps"] = torch.stack(steps)
        out["tokens"] = torch.cat(toks, dim=1)
    return out


def layout_train_cfg():
    """(d)'s config: the "compressed" variant's, under naive attention
    (the flash kernel has no gradient)."""
    return layout_cfg("compressed", 2).with_(attn_impl="naive")


def layout_train_data(cfg):
    from repro_torch.data import DataConfig

    # uniform tokens: the bigram table would be vocab x vocab (49152^2)
    return DataConfig(vocab_size=cfg.vocab_size, batch=LAYOUT_TRAIN_BATCH,
                      seq_len=LAYOUT_TRAIN_SEQ, seed=SEED, kind="uniform")


def _cpu_tree(tree):
    return {k: _cpu_tree(v) for k, v in tree.items()} if isinstance(
        tree, dict) else (None if tree is None else tree.detach().cpu())


def layout_train_ref(dev, work: Path) -> list:
    """(d)'s reference in this process: make_train_step on whole params
    drawn from SEED, 2 steps.  Writes the params after each step and the
    first step's gradients to ``work``; returns each step's loss and
    grad_norm."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_grad_fn, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = layout_train_cfg()
    params = lm.lm_init(cfg, SEED, device=dev)
    data = SyntheticLM(layout_train_data(cfg))
    _, _, grads = make_grad_fn(cfg)(params, data.batch_at(0))
    torch.save(_cpu_tree(grads), work / "train_grads1.pt")
    del grads
    step = make_train_step(cfg, AdamWConfig(**LAYOUT_TRAIN_OPT))
    opt = adamw_init(params)
    out = []
    for k in range(2):
        params, opt, m = step(params, opt, data.batch_at(k))
        out.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])})
        torch.save(_cpu_tree(params), work / f"train_ref{k + 1}.pt")
    del params, opt
    torch.cuda.empty_cache()
    return out


def hold_update(got, want, grad, grad_norm) -> float:
    """The CPU tests' bound on one AdamW step's params
    (``tests/test_torch_layout_train.py::_hold_update``): where the whole
    step's clipped gradient |g| exceeds its rounding d, lr * eps * d / ((|g|
    - d + eps)(|g| + eps)); else 2 * lr; plus 1e-6 (|p| + lr).  Returns
    the largest excess over the bound (<= 0 where it holds)."""
    lr, eps = LAYOUT_TRAIN_OPT["lr"], 1e-8
    scale = min(1.0, LAYOUT_TRAIN_OPT["grad_clip"] / grad_norm)
    g = grad.double().abs() * scale
    d = LAYOUT_GRAD_TOL * g.max() + LAYOUT_TRAIN_RTOL * g
    bound = torch.where(g > d, lr * eps * d / ((g - d + eps) * (g + eps)),
                        torch.full_like(g, 2 * lr)) \
        + 1e-6 * (want.double().abs() + lr)
    return float(((got.double() - want.double()).abs() - bound).max())


def _timed_step(fn):
    """(fn()'s result, host ms to its synchronize, device ms by events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def layout_train(laid, mesh, dev, work: Path) -> dict:
    """(d) on one rank: the LM Trainer on the rank's laid-out params runs
    step 1 and checkpoints (rank 0 writes), its train step runs step 2;
    then a new Trainer restores the checkpoint and repeats step 2.  Each
    step's launches counted from 0; each step's params held shard by shard
    against the whole-params reference (step 1 by the CPU tests' bound,
    step 2 within 2 lr more than step 1's difference: one more step moves
    an element at most 2 lr further)."""
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding.api import lay_out_like, local
    from repro_torch.train import TrainConfig, Trainer, checkpoint

    cfg = layout_train_cfg()
    ckpt = work / "train_ckpt"
    saves = []
    manager = checkpoint.CheckpointManager
    save = manager.save
    manager.save = lambda self, step, *a, **kw: (
        saves.append(step), save(self, step, *a, **kw))[1]

    def counts():
        return {k.name: k.launches for k in KERNELS if k.launches}

    def trainer():
        return Trainer(cfg, layout_train_data(cfg),
                       AdamWConfig(**LAYOUT_TRAIN_OPT),
                       TrainConfig(steps=1, ckpt_dir=str(ckpt), ckpt_every=2,
                                   log_every=1), params=laid)

    res = {}
    mem0 = _allocated()
    try:
        tr = trainer()
        res["local_bytes"] = {
            "params": sum(local(t).numel() * t.element_size()
                          for t in _leaves(tr.params)),
            "opt": sum(local(t).numel() * t.element_size()
                       for t in _leaves(tr.opt_state))}
        res["whole_bytes"] = {
            "params": sum(t.numel() * t.element_size()
                          for t in _leaves(tr.params)),
            "opt": sum(t.numel() * t.element_size()
                       for t in _leaves(tr.opt_state))}
        reset_launch_counts()
        t0 = time.perf_counter()
        tr.run(1)  # step 1, then rank 0 writes its checkpoint
        torch.cuda.synchronize()
        res["step1_and_save_s"] = time.perf_counter() - t0
        res["counts"] = [counts()]
        h = tr.history[0]
        res["metrics"] = [{"loss": h["loss"], "grad_norm": h["grad_norm"]}]
        res["host_ms"] = [h["sec_per_step"] * 1e3]
        p1 = tr.params
        batch = tr.data.batch_at(1)
        reset_launch_counts()
        (p2, o2, m2), host, devms = _timed_step(
            lambda: tr.step_fn(tr.params, tr.opt_state, batch))
        res["counts"].append(counts())
        res["metrics"].append({"loss": float(m2["loss"]),
                               "grad_norm": float(m2["grad_norm"])})
        res["host_ms"].append(host)
        res["device_ms"] = [None, devms]
        t0 = time.perf_counter()
        back = trainer()
        res["restored_step"] = back.maybe_restore()
        res["restore_s"] = time.perf_counter() - t0
        reset_launch_counts()
        (q2, u2, n2), host, devms = _timed_step(
            lambda: back.step_fn(back.params, back.opt_state, batch))
        res["counts"].append(counts())
        res["host_ms"].append(host)
        res["device_ms"].append(devms)
        res["resume_bitwise"] = (
            all(torch.equal(local(a), local(b)) for a, b in zip(
                _leaves({"p": p2, "o": o2}), _leaves({"p": q2, "o": u2})))
            and all(torch.equal(m2[k], n2[k]) for k in m2))
        res["param_excess"] = layout_param_excess(p1, p2, work, dev)
        res["saves"] = saves
        res["leftover"] = sorted(p.name for p in ckpt.glob("tmp.*"))
        del tr, back, p1, p2, o2, q2, u2
    finally:
        manager.save = save
    gc.collect()
    res["mem_before_after"] = [mem0, _allocated()]
    return res


def _allocated() -> int:
    """The card's bytes held by live tensors, after PyTorch drops its cuBLAS
    workspaces (a new thread's handle, as the autograd engine's, caches 32
    MiB of its own for the life of the process)."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def layout_param_excess(p1, p2, work: Path, dev) -> list:
    """Each step's largest excess of the rank's params over their bound
    against the whole-params reference, shard by shard (<= 0 where every
    element holds): step 1 by the CPU tests' bound (``hold_update``), step
    2 within 2 lr more than step 1's difference; integer leaves equal."""
    from repro_torch.sharding.api import lay_out_like, local

    meta = json.loads((work / "train_ref.json").read_text())
    grads = torch.load(work / "train_grads1.pt", map_location=dev)
    lr = LAYOUT_TRAIN_OPT["lr"]
    excess, diff1 = [], {}
    for k, got in ((1, p1), (2, p2)):
        ref = torch.load(work / f"train_ref{k}.pt", map_location=dev)
        worst = -float("inf")
        for path, g, w, gr in _paths(got, ref, grads):
            want = local(lay_out_like(w, g))
            if not g.is_floating_point():
                worst = max(worst, 0.0 if torch.equal(local(g), want)
                            else 1.0)
                continue
            err = (local(g).double() - want.double()).abs()
            if k == 1:
                worst = max(worst, hold_update(
                    local(g), want, local(lay_out_like(gr, g)),
                    meta[0]["grad_norm"]))
                diff1[path] = err
            else:
                worst = max(worst, float((err - diff1[path] - 2 * lr - 1e-6
                                          * (want.double().abs() + lr))
                                         .max()))
        excess.append(worst)
    return excess


def _paths(tree, *rest, prefix=()):
    """(path, leaf, the leaves at the same place in ``rest``) of a dict
    tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, *(r[k] for r in rest), prefix=prefix + (k,))
    else:
        yield (prefix, tree, *rest)


def layout_bits(dev) -> dict:
    """(c): the q projection's #1 launch on each model rank's 512 columns
    (#1b), the k projection's on its 160 (not a multiple of 64: #1a), and
    #7b on each rank's 8 q heads with their KV heads by JAX's map, each
    ``torch.equal`` to the same part of the whole launch."""
    from repro_torch.core.sparse_linear import linear_init
    from repro_torch.kernels.colwise_nm import (colwise_nm_matmul_cuda,
                                                colwise_nm_matmul_tiled_cuda)
    from repro_torch.kernels.flash_attn import flash_attention_tiled_cuda
    from repro_torch.models.attention import _rank_kv_map

    cfg = layout_cfg("compressed", 2)
    tp, hd = cfg.tp, cfg.resolved_head_dim
    h, kv = cfg.padded_heads, cfg.n_kv_heads
    gen = torch.Generator().manual_seed(SEED + 61)
    b, s = LAYOUT_SCORE
    x = torch.randn((b * s, cfg.d_model), generator=gen).to(dev)
    out = {}
    for name, width in (("q", h * hd), ("k", kv * hd)):
        layer = linear_init(gen, cfg.d_model, width, cfg.sparsity, device=dev)
        values, idx = layer["values"], layer["idx"]
        whole = colwise_nm_matmul_tiled_cuda(x, values, idx)
        for r in range(tp):
            lo, hi = r * width // tp, (r + 1) * width // tp
            part = values[..., lo:hi].contiguous()
            fn = (colwise_nm_matmul_tiled_cuda if (hi - lo) % 64 == 0
                  else colwise_nm_matmul_cuda)
            y = fn(x, part, idx)
            check(torch.equal(y, whole[:, lo:hi]),
                  f"(c) {name} columns {lo}:{hi} through {fn.__name__} "
                  "differ from the whole launch's")
            out[f"{name}{r}"] = f"{fn.__name__} [{lo}:{hi}]"
    q = torch.randn((b, s, h, hd), generator=gen).to(dev)
    k = torch.randn((b, s, kv, hd), generator=gen).to(dev)
    v = torch.randn((b, s, kv, hd), generator=gen).to(dev)
    whole = flash_attention_tiled_cuda(q, k, v, causal=True)
    for r in range(tp):
        hl = h // tp
        m = _rank_kv_map(h, kv, tp, r, q.device)
        y = flash_attention_tiled_cuda(
            q[:, :, r * hl:(r + 1) * hl].contiguous(), k[:, :, m].contiguous(),
            v[:, :, m].contiguous(), causal=True)
        check(torch.equal(y, whole[:, :, r * hl:(r + 1) * hl]),
              f"(c) flash on rank {r}'s heads differs from the whole launch's")
        out[f"flash{r}"] = (f"heads {r * hl}:{(r + 1) * hl}, KV heads "
                            f"{m.tolist()}")
    torch.cuda.synchronize()
    return out


def layout_expected(cfg) -> dict:
    """A rank's launches over one ``layout_run``: 2 scoring forwards (one
    #7b a layer each), a prefill and LAYOUT_NEW decode steps; q, gate, up
    (and o, down outside the REDUCE format) through #1b, k and v on their
    160 columns through #1a."""
    passes = 2 + 1 + LAYOUT_NEW
    tiled = 3 if cfg.sparsity.shard_local_reduce else 5
    return {"colwise_nm_matmul_tiled": passes * cfg.n_layers * tiled,
            "colwise_nm_matmul": passes * cfg.n_layers * 2,
            "flash_attention_tiled": 2 * cfg.n_layers}


def _event_ms(fn) -> float:
    """One warm call of ``fn`` between CUDA events (the host's waits on
    gloo included)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def layout_rank(rank, world, dp, tp, work, device_type) -> None:
    """One rank of a phase-20 world (``LAYOUT_CHILD``): gloo through a file
    store in ``work``; every variant drawn whole from SEED, laid out by its
    shardings, run (``layout_run``) with the launch counts reset just
    before, held against this process's copy of the parent's whole-params
    outputs; then (the first variant) a prefill and a decode step timed,
    and in the data 2 x model 2 world (d), training on the same shards
    (``layout_train``).  Writes ``rank<r>.json``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import dispatch
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.launch.steps import distribute_tree
    from repro_torch.models import lm
    from repro_torch.models import registry as reg
    from repro_torch.sharding.api import local, specs_to_shardings

    rank, world, dp, tp, work = int(rank), int(world), int(dp), int(tp), \
        Path(work)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device_type)
    # the world's ranks share the host's cores: no rank oversubscribes them
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dispatch.set_db(dispatch.ProfileDB(path=work / f"profile{rank}.json"))
    dist.init_process_group("gloo",
                            init_method=f"file://{work}/store{dp}x{tp}",
                            rank=rank, world_size=world)
    res = {"rank": rank}
    t0 = time.perf_counter()
    try:
        torch.zeros((), device=dev).item()  # the context, apart
        res["context_s"] = time.perf_counter() - t0
        mesh = init_device_mesh(device_type, (dp, tp),
                                mesh_dim_names=("data", "model"))
        res["mesh_s"] = time.perf_counter() - t0 - res["context_s"]
        res["coords"] = {ax: mesh.get_local_rank(ax) for ax in ("data",
                                                                 "model")}
        for variant in LAYOUT_VARIANTS:
            t1 = time.perf_counter()
            cfg = layout_cfg(variant, tp)
            whole = lm.lm_init(cfg, SEED, device=dev)
            laid = distribute_tree(whole, specs_to_shardings(
                reg.param_specs(cfg), whole, mesh))
            del whole
            torch.cuda.empty_cache()
            leaves = [t for t in _leaves(laid)]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            reset_launch_counts()
            got = layout_run(cfg, laid, dev, mesh)
            torch.cuda.synchronize()
            counts = {k.name: k.launches for k in KERNELS if k.launches}
            t3 = time.perf_counter()
            ref = torch.load(work / f"ref_{variant}.pt", map_location=dev)
            times = {}
            if variant == LAYOUT_VARIANTS[0]:
                prompt = torch.from_numpy(np.random.default_rng(
                    SEED + 60).integers(0, cfg.vocab_size, LAYOUT_PROMPT,
                                        dtype=np.int32)).to(dev)
                with torch.no_grad():
                    times["prefill_ms"] = _event_ms(lambda: reg.prefill_fn(
                        cfg)(laid, {"tokens": prompt}))
                    cache = reg.cache_init_fn(cfg, LAYOUT_PROMPT[0],
                                              LAYOUT_PROMPT[1] + 1,
                                              device=dev, mesh=mesh)()
                    times["decode_ms"] = _event_ms(lambda: reg.decode_fn(cfg)(
                        laid, cache, prompt[:, -1:], LAYOUT_PROMPT[1]))
                    del cache
            if variant == "compressed" and dp == 2:
                res["train"] = layout_train(laid, mesh, dev, work)
            res[variant] = {
                "counts": counts,
                "score_err": rel_err(got["score_logits"], ref["score_logits"]),
                "steps_err": rel_err(got["steps"], ref["steps"]),
                "nll": got["nll"], "nll_ref": float(ref["nll"]),
                "tokens_equal": bool(torch.equal(got["tokens"],
                                                 ref["tokens"])),
                "tokens": got["tokens"].tolist(),
                "local_bytes": sum(local(t).numel() * t.element_size()
                                   for t in leaves),
                "whole_bytes": sum(t.numel() * t.element_size()
                                   for t in leaves),
                "init_s": t2 - t1, "run_s": t3 - t2,
                "timed_s": time.perf_counter() - t3, **times}
            del laid, got, ref, leaves
            torch.cuda.empty_cache()
    except Exception:  # reported to the parent through the results file
        import traceback

        res["error"] = traceback.format_exc()
    finally:
        (work / f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def layout_world(dp: int, tp: int, work: Path, dev) -> list:
    """Spawn a world of dp x tp ranks on the card; returns each rank's
    results.  Any rank that fails or outlives LAYOUT_TIMEOUT_S ends the
    world: every rank is killed."""
    world = dp * tp
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    logs = [open(work / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", LAYOUT_CHILD, str(ROOT), str(r), str(world),
         str(dp), str(tp), str(work), dev.type], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            check(time.perf_counter() - t0 < LAYOUT_TIMEOUT_S,
                  f"a rank of the {dp} x {tp} world outlived "
                  f"{LAYOUT_TIMEOUT_S} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    out = []
    for r, p in enumerate(procs):
        path = work / f"rank{r}.json"
        tail = (work / f"rank{r}.log").read_text()[-3000:]
        check(path.exists(), f"rank {r} of {dp} x {tp} wrote no results "
              f"(rc {p.returncode}): {tail}")
        res = json.loads(path.read_text())
        check("error" not in res, f"rank {r} of {dp} x {tp}: "
              f"{res.get('error', '')[-3000:]}")
        check(p.returncode == 0, f"rank {r} of {dp} x {tp} rc "
              f"{p.returncode}: {tail}")
        out.append(res)
    return out


def layout_train_expected(cfg) -> dict:
    """A rank's launches a train step of (d): the forward's q, gate, up (the
    rank's columns), o and down (whole) through #1b, k and v on their 160
    columns through #1a; the backward is the autograd twin's plain one."""
    return {"colwise_nm_matmul_tiled": 5 * cfg.n_layers,
            "colwise_nm_matmul": 2 * cfg.n_layers}


def layout_train_checks(ranks, ref, card) -> dict:
    """(d)'s checks over the data 2 x model 2 world's ranks; returns the
    launches summed over ranks and steps."""
    want = layout_train_expected(layout_train_cfg())
    launches = {}
    print("LAYOUT_TRAIN " + json.dumps([res["train"] for res in ranks]),
          flush=True)
    for res in ranks:
        r, tag = res["train"], f"(d) rank {res['rank']} {res['coords']}"
        errs = [max(abs(m[k] - w[k]) / abs(w[k]) for k in w)
                for m, w in zip(r["metrics"], ref)]
        lb, wb = r["local_bytes"], r["whole_bytes"]
        print(f"  {tag}: launches a step {r['counts']} (want {want}); loss, "
              f"grad_norm {r['metrics']} (rel err {max(errs):.2e} <= "
              f"{LAYOUT_TRAIN_RTOL}); params within the bound (largest "
              f"excess {max(r['param_excess']):.3e}); resumed from step "
              f"{r['restored_step']}, step 2 bit for bit; wrote "
              f"{r['saves']}; host ms a step {r['host_ms']} (step 1 by the "
              f"Trainer's clock, then step 2 and its repeat), device ms by "
              f"events {r['device_ms'][1:]}; step 1 and its checkpoint "
              f"{r['step1_and_save_s']:.1f} s, the restore "
              f"{r['restore_s']:.1f} s; local params {lb['params']} of "
              f"{wb['params']} bytes ({lb['params'] / wb['params']:.3f}), "
              f"optimizer state {lb['opt']} of {wb['opt']} "
              f"({lb['opt'] / wb['opt']:.3f}); {LAYOUT_LABEL}; {card}",
              flush=True)
        check(max(errs) <= LAYOUT_TRAIN_RTOL,
              f"{tag}: loss/grad_norm {r['metrics']} vs whole {ref}")
        check(max(r["param_excess"]) <= 0,
              f"{tag}: params past their bound by {r['param_excess']}")
        check(r["restored_step"] == 1 and r["resume_bitwise"],
              f"{tag}: the resume from step {r['restored_step']} differs "
              "from the uninterrupted step 2")
        check(r["saves"] == ([1] if res["rank"] == 0 else []),
              f"{tag}: wrote checkpoints {r['saves']}")
        check(not r["leftover"], f"{tag}: left {r['leftover']}")
        before, after = r["mem_before_after"]
        check(after - before <= 2 ** 20, f"{tag}: {after - before} bytes "
              "of the card left allocated after training")
        for k, c in enumerate(r["counts"]):
            check(c == want, f"{tag}: step {k} launched {c}, want {want}")
            for name, n in c.items():
                launches[name] = launches.get(name, 0) + n
    return launches


def run_layout(dev) -> dict:
    """Phase 20.  Returns the launches of the laid-out main path and of
    (d)'s training (each rank's, summed)."""
    from repro_torch.models import lm

    t0 = time.perf_counter()
    card = card_line()
    bits = layout_bits(dev)
    print(f"  (c) bit for bit against the whole launch: {bits}", flush=True)
    work = Path(tempfile.mkdtemp(prefix="layout-", dir=ROOT / "build"))
    launches, train_launches = {}, {}
    try:
        refs = {}
        for variant in LAYOUT_VARIANTS:
            cfg = layout_cfg(variant, 2)
            params = lm.lm_init(cfg, SEED, device=dev)
            ref = layout_run(cfg, params, dev)
            torch.save({k: v.cpu() if torch.is_tensor(v) else v
                        for k, v in ref.items()}, work / f"ref_{variant}.pt")
            refs[variant] = {"nll": ref["nll"],
                             "tokens": ref["tokens"].tolist()}
            del params, ref
            torch.cuda.empty_cache()
        print(f"  whole params on this process (cfg.tp 2: 16 q heads): NLL "
              f"{ {v: r['nll'] for v, r in refs.items()} }, greedy tokens "
              f"{refs['compressed']['tokens']}", flush=True)
        train_ref = layout_train_ref(dev, work)
        (work / "train_ref.json").write_text(json.dumps(train_ref))
        print(f"  (d) whole params on this process, make_train_step "
              f"(naive attention), {LAYOUT_TRAIN_BATCH} x "
              f"{LAYOUT_TRAIN_SEQ} tokens a step: {train_ref}", flush=True)
        print(f"  (c) and the whole-params runs took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for dp, tp in LAYOUT_WORLDS:
            t1 = time.perf_counter()
            ranks = layout_world(dp, tp, work, dev)
            split = {v: [round(ranks[0][v][k], 1)
                         for k in ("init_s", "run_s", "timed_s")]
                     for v in LAYOUT_VARIANTS}
            print(f"  the {dp} x {tp} world took "
                  f"{time.perf_counter() - t1:.1f} s: rank 0's context "
                  f"{ranks[0]['context_s']:.1f} s and mesh "
                  f"{ranks[0]['mesh_s']:.1f} s, then each variant's init, "
                  f"run and timed calls {split} s", flush=True)
            for variant in LAYOUT_VARIANTS:
                cfg = layout_cfg(variant, tp)
                tol = LAYOUT_TOL
                want = layout_expected(cfg)
                for res in ranks:
                    r = res[variant]
                    tag = (f"{variant} {dp} x {tp} rank {res['rank']} "
                           f"{res['coords']}")
                    check(r["counts"] == want,
                          f"{tag}: launches {r['counts']}, want {want}")
                    check(r["score_err"] <= tol and r["steps_err"] <= tol,
                          f"{tag}: logits rel err {r['score_err']}, "
                          f"{r['steps_err']} > {tol}")
                    nll_err = abs(r["nll"] - r["nll_ref"]) / abs(r["nll_ref"])
                    check(nll_err <= LAYOUT_NLL_RTOL,
                          f"{tag}: NLL {r['nll']} vs {r['nll_ref']}")
                    check(r["tokens_equal"], f"{tag}: tokens {r['tokens']} "
                          f"vs {refs[variant]['tokens']}")
                    for name, n in r["counts"].items():
                        launches[name] = launches.get(name, 0) + n
                    print(f"  ({'a' if variant == 'compressed' else 'b'}) "
                          f"{tag}: launches {r['counts']} (want {want}); "
                          f"scoring logits rel err {r['score_err']:.3e}, "
                          f"prefill and decode logits {r['steps_err']:.3e} "
                          f"(<= {tol} of max|logit|); NLL {r['nll']!r} vs "
                          f"{r['nll_ref']!r} (rel {nll_err:.2e}); "
                          f"{LAYOUT_NEW} greedy tokens equal", flush=True)
                    times = (f"; device ms by CUDA events, prefill of "
                             f"{LAYOUT_PROMPT[0]} x {LAYOUT_PROMPT[1]} "
                             f"{r['prefill_ms']:.3f}, decode step "
                             f"{r['decode_ms']:.3f} ({LAYOUT_LABEL}); {card}"
                             if "decode_ms" in r else "")
                    print(f"  (d) {tag}: local params {r['local_bytes']} of "
                          f"{r['whole_bytes']} bytes "
                          f"({r['local_bytes'] / r['whole_bytes']:.3f})"
                          + times, flush=True)
            if dp == 2:
                train_launches = layout_train_checks(ranks, train_ref, card)
            print("LAYOUT " + json.dumps({"world": [dp, tp], "ranks": ranks}),
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"  (b) at model 2 the all-reduce adds the two REDUCE groups' "
          f"partial products, where the whole run's einsum sums both groups "
          f"in one product: held within {LAYOUT_TOL} of max|logit|, as at "
          f"model 2; phase 20 took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"launches": launches, "train_launches": train_launches}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch._compat import is_hopper
    from repro_torch.configs import get_vision_config
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.kernels.colwise_nm.tune import strips_tiled_registers
    from repro_torch.kernels.conv_gemm.tune import (banded_tiled_registers,
                                                    fused_tiled_registers)
    from repro_torch.kernels.flash_attn.tune import paged_split_registers
    from repro_torch.kernels.im2col_pack.tune import tiled_registers
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
    for inst, regs, spill in fused_tiled_registers(lib.parent / "build.log"):
        print(f"  conv2d_fused_tiled {inst}: {regs} registers, {spill}",
              flush=True)
    for inst, regs, spill in tiled_registers(lib.parent / "build.log"):
        print(f"  im2col_pack_tiled {inst}: {regs} registers, {spill}",
              flush=True)
    for inst, regs, spill in strips_tiled_registers(lib.parent / "build.log"):
        print(f"  colwise_nm_strips_tiled {inst}: {regs} registers, {spill}",
              flush=True)
    for inst, regs, spill in paged_split_registers(lib.parent / "build.log"):
        print(f"  paged_attention_split {inst}: {regs} registers, {spill}",
              flush=True)

    cfg = get_vision_config("resnet-tiny")
    params = vision_init(cfg, SEED, device=dev)

    print(f"== 3. kernels at the main path's shapes (batch {BATCH})", flush=True)
    for name, call in LIBRARY_CALLS.items():
        print(f"  library_ms of {name}: {call}", flush=True)
    tot, banded_route, fused_route, pack_route = check_kernels(params, cfg,
                                                               dev)
    strip_route = check_strip_kernels(params, cfg, dev, tot)
    check_linear_kernel(dev, tot)
    sweep_linear_kernels(dev)

    print(f"== 4. main path: resnet-tiny inference, batch {BATCH}", flush=True)
    counts = run_main_path(params, cfg, dev)

    print(f"== 5. compressed linear layers through dispatch, {LINEAR_ROWS} rows",
          flush=True)
    linear_launches = run_linear_path(dev)

    print("== 6. paged-attention kernels at the serving shapes", flush=True)
    print(f"  library_ms of paged_attention: {LIBRARY_CALLS['paged_attention']}",
          flush=True)
    paged_route = check_paged_kernel(dev, tot)

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

    print(f"== 10. train: resnet-tiny, batch {BATCH}", flush=True)
    t0 = time.perf_counter()
    train_launches, first_loss = run_training(params, cfg, dev, counts)
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"== 11. the training tier: SparseTrainer (resnet-tiny, batch "
          f"{BATCH}) and Trainer (smollm-360m)", flush=True)
    t0 = time.perf_counter()
    tier_launches = run_tier(dev, first_loss, lm_cfg, lm_params)
    for name, n in tier_launches.items():
        train_launches[name] += n
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"== 12. serving, the rest: pruned smollm-360m, generate, the "
          f"contiguous and the paged grow Scheduler on {GEN_BATCH} prompts "
          f"of {GEN_PROMPT} tokens", flush=True)
    t0 = time.perf_counter()
    rest_counts = run_serving_rest(dev, lm_cfg, lm_params)
    print(f"  phase 12 took {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"== 13. chaos: faults on the card (resnet-tiny at batch {BATCH}, "
          f"pruned smollm-360m serving, a guarded linear, the SparseTrainer)",
          flush=True)
    t0 = time.perf_counter()
    chaos = run_chaos(dev, cfg, params, lm_cfg, lm_params)
    for name, n in chaos["train_launches"].items():
        train_launches[name] += n
    print(f"  phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("== 14. the dense LM zoo: pruned qwen2-7b and nemotron-4-15b at "
          "their published widths, qwen2-0.5b whole, the Tuner shim and the "
          "example twins", flush=True)
    zoo = run_zoo(dev)
    for name, n in zoo["train_launches"].items():
        train_launches[name] += n

    print("== 15. the MoE family: pruned olmoe-1b-7b whole and "
          "moonshot-v1-16b-a3b at its published widths (2 layers), served "
          "paged and contiguous and scored", flush=True)
    moe = run_moe(dev)

    print("== 16. the recurrent families: #1a at zamba2-7b's in_proj, pruned "
          "xlstm-350m whole and zamba2-7b at its published widths (15 "
          "layers), served by generate and scored", flush=True)
    recurrent = run_recurrent(dev)

    print("== 17. the encoder-decoder and VLM families: #7b non-causal at "
          "whisper-small's encoder, pruned whisper-small whole and "
          "qwen2-vl-72b at its published widths (2 layers), served and "
          "scored", flush=True)
    encdec_vlm = run_encdec_vlm(dev)

    print(f"== 18. moe train: {MOE_TRAIN_ARCH} at its published widths, "
          f"{MOE_TRAIN_LAYERS} of 16 layers, trained by make_train_step; the "
          f"LM Trainer's resume; a world-1 NCCL ShardingCtx; {REDUCE_ARCH} "
          "scored with the REDUCE format", flush=True)
    moe_train = run_moe_train(dev, moe.pop("train_tree"))
    for name, n in moe_train["train_launches"].items():
        train_launches[name] += n

    print("== 19. contracts: the port's checker over src/repro_torch and "
          "csrc/, every CUDA candidate of the registry at the checker's "
          "small probe keys (DP301/DP302 on the card), the ring collective "
          "matmul and the compressed cross-pod reduction on a world-1 NCCL "
          "group", flush=True)
    contracts = run_contracts(dev)

    print("== 20. layout: pruned smollm-360m whole (cfg.tp 2) laid out on "
          "worlds of 2 (model 2) and 4 (data 2 x model 2) gloo ranks on the "
          "card: scored, prefilled and decoded on each rank's shards against "
          "whole params; (d) trained 2 AdamW steps on the data 2 x model 2 "
          "shards, checkpointed by rank 0 and resumed", flush=True)
    layout = run_layout(dev)
    for name, n in layout["train_launches"].items():
        train_launches[name] += n

    print("== 21. report", flush=True)
    launches = {
        "conv2d_fused": fused_route["conv2d_fused"],
        "conv2d_fused_tiled": counts["default"]["conv2d_fused_tiled"],
        "im2col_pack": pack_route["im2col_pack"],
        "im2col_pack_tiled":
            counts["im2col_sparse_pallas"]["im2col_pack_tiled"],
        "colwise_nm_matmul_strips": strip_route["colwise_nm_matmul_strips"],
        "colwise_nm_matmul_strips_tiled":
            counts["im2col_sparse_pallas"]["colwise_nm_matmul_strips_tiled"],
        "conv2d_fused_banded": banded_route["conv2d_fused_banded"],
        "conv2d_fused_banded_tiled":
            counts["fused_banded_pallas"]["conv2d_fused_banded_tiled"],
        "colwise_nm_matmul_strips_pipelined":
            strip_route["colwise_nm_matmul_strips_pipelined"],
        "colwise_nm_matmul_strips_pipelined_tiled":
            counts["two_kernel_pipelined"][
                "colwise_nm_matmul_strips_pipelined_tiled"],
        "colwise_nm_matmul": linear_launches["colwise_nm_matmul"],
        "paged_attention": paged_route["paged_attention"],
        "paged_attention_split": serve_counts["paged_attention_split"]
        + rest_counts["paged_attention_split"],
        "flash_attention": flash_route["flash_attention"],
        "colwise_nm_matmul_tiled": serve_counts["colwise_nm_matmul_tiled"]
        + rest_counts["colwise_nm_matmul_tiled"],
        "flash_attention_tiled": score_counts["flash_attention_tiled"],
    }
    for name, n in (list(chaos["launches"].items())
                    + list(zoo["launches"].items())
                    + list(moe["launches"].items())
                    + list(recurrent["launches"].items())
                    + list(encdec_vlm["launches"].items())
                    + list(moe_train["launches"].items())
                    + list(contracts["launches"].items())
                    + list(layout["launches"].items())):
        launches[name] += n
    print(f"  the linear phase (5) launched {linear_launches}; the served runs "
          f"(phases 7 and 12) colwise_nm_matmul_tiled "
          f"{launches['colwise_nm_matmul_tiled']} times and the scored run "
          f"{score_counts['colwise_nm_matmul_tiled']}", flush=True)
    check(all(launches.values()), f"a kernel was not launched: {launches}")
    per = {"colwise_nm_matmul": "ms etc.: sum over the 960->2560 and "
                                "2560->960 layers at 256 rows (T = d_out); "
                                "launches: the linear phase (5), tiles 8 and "
                                "12 and any profiled winner, phase 13's "
                                "retry of the faulted tiled kernel, "
                                "phase 14's tuner (tile 32) and "
                                "prune_and_finetune (tile 8), and phase 16's "
                                "zamba2-7b (its in_proj, T = 14576, 1 per "
                                "Mamba2 layer per token step: generate, "
                                "scored), and phase 20's laid-out "
                                "smollm-360m (k and v on a rank's 160 "
                                "columns: 2 a layer a pass, every rank); "
                                "train_launches phase 20 (d)'s laid-out "
                                "train steps (2 a layer a step a rank)",
           "colwise_nm_matmul_tiled": "ms etc.: sum over the 960->2560 and "
                                      "2560->960 layers at 256 rows (T = "
                                      "d_out); launches: the served "
                                      "smollm-360m runs of phases 7, 12 and "
                                      "13 (7 per layer per step), phase "
                                      "13's guarded linear, phase 14's "
                                      "zoo (served and scored models, the "
                                      "tuner, serve_pruned), phase 15's "
                                      "MoE models (4 per layer per step: "
                                      "served paged, generate, scored) and "
                                      "phase 16's recurrent models (111 "
                                      "(xlstm-350m) and 31 (zamba2-7b) per "
                                      "token step: generate, scored; 74 "
                                      "and 37 (xlstm-350m's 16- and "
                                      "8-layer cuts): generate) and "
                                      "phase 17's whisper-small (192 a "
                                      "prefill or scored pass, 96 a decode "
                                      "step: generate, scored) and "
                                      "qwen2-vl-72b (14 a step: served "
                                      "paged, generate, scored) and phase "
                                      "18's smollm-360m scored with the "
                                      "REDUCE format (160 a forward) and "
                                      "phase 20's laid-out smollm-360m "
                                      "(q, gate, up on a rank's columns, "
                                      "o, down whole: 5 a layer a pass, 3 "
                                      "with REDUCE; every rank); "
                                      "train_launches also phase 18's "
                                      "olmoe-1b-7b train steps (32 a step) "
                                      "and its 2-layer Trainer (8 a step) "
                                      "and phase 20 (d)'s laid-out train "
                                      "steps (5 a layer a step a rank)",
           "paged_attention": "ms etc.: B 4, Sq 1, f32, H 15, KV 5, D 64, "
                              "page size 16 (the decode step's shape), "
                              "called directly (the split kernel's "
                              "yardstick); launches: paged_attention_cuda "
                              "over phase 6's cases, the Sq 8 case the "
                              "split rule refuses",
           "paged_attention_split": "ms etc.: B 4, Sq 1, f32, H 15, KV 5, D "
                                    "64, page size 16 (the decode step's "
                                    "shape); launches: the served "
                                    "smollm-360m runs of phases 7 and 12's "
                                    "and 13's grow schedulers and phases "
                                    "14's, 15's and 17's served models (1 "
                                    "per layer per paged decode step)",
           "flash_attention": "ms etc.: B 4, S 2048, H 15, KV 5, D 64, "
                              "causal, f32 (the scoring forward's shape, "
                              "where it is the tiled kernel's bitwise "
                              "yardstick); launches: ops.flash_attention "
                              "over phase 8's cases, the D 18 heads the "
                              "tiled kernel refuses",
           "flash_attention_tiled": "ms etc.: B 4, S 2048, H 15, KV 5, D "
                                    "64, causal, f32 (the scoring forward's "
                                    "shape); launches: the scored "
                                    "smollm-360m run, phases 14's and 15's "
                                    "scored models (1 per layer per "
                                    "forward), phase 16's scored "
                                    "zamba2-7b (1 per shared-block "
                                    "application, D 112) and phase 17's "
                                    "scored whisper-small (12 non-causal "
                                    "encoder and 12 causal decoder "
                                    "launches a forward, S 1500 and 448) "
                                    "and qwen2-vl-72b (D 128), and phase "
                                    "20's laid-out smollm-360m (a rank's 8 "
                                    "q heads, 1 a layer a scoring forward, "
                                    "every rank)",
           "colwise_nm_matmul_strips": "ms etc.: sum over the 5 pruned convs "
                                       "of one batch-256 forward, called "
                                       "directly (the tiled kernel's bitwise "
                                       "yardstick); launches: "
                                       "colwise_nm_matmul_strips_cuda over "
                                       "phase 3's ten cases and a misaligned "
                                       "view, the view the rule refuses",
           "colwise_nm_matmul_strips_pipelined": "ms etc.: sum over the 5 "
                                                 "pruned convs, called "
                                                 "directly at hb 2; launches: "
                                                 "the pipelined wrapper over "
                                                 "phase 3's ten cases and a "
                                                 "tile of 1000 kept rows of "
                                                 "64, the one the rule "
                                                 "refuses",
           "colwise_nm_matmul_strips_tiled": "ms etc.: sum over the 5 pruned "
                                             "convs of one batch-256 forward; "
                                             "launches: the forced two-kernel "
                                             "plan (5 per forward, x3)",
           "colwise_nm_matmul_strips_pipelined_tiled": "ms etc.: sum over the "
                                                       "5 pruned convs at hb "
                                                       "2; launches: the "
                                                       "forced pipelined plan "
                                                       "(5 per forward, x3)",
           "im2col_pack": "ms etc.: sum over the 5 pruned convs of one "
                          "batch-256 forward, called directly (the tiled "
                          "kernel's bitwise yardstick); launches: "
                          "im2col_pack_cuda over phase 3's six cases and "
                          "strips of 6, the width the rule refuses",
           "im2col_pack_tiled": "ms etc.: sum over the 5 pruned convs of one "
                                "batch-256 forward; launches: the forced "
                                "two-kernel plan (5 per forward, x3)",
           "conv2d_fused": "ms etc.: sum over the 5 pruned convs of one "
                           "batch-256 forward, called directly (the tiled "
                           "kernel's bitwise yardstick); launches: "
                           "conv2d_fused_cuda over phase 3's six cases and a "
                           "misaligned view of the values, the view the rule "
                           "refuses, and any conv of phase 14's "
                           "conv_pipeline the tiled rule refuses",
           "conv2d_fused_tiled": "ms etc.: sum over the 5 pruned convs of one "
                                 "batch-256 forward; launches: the default "
                                 "plan (5 per forward, x3), phase 13's "
                                 "forward after clear_quarantine and "
                                 "phase 14's conv_pipeline (the kernel the "
                                 "fused shape rule picks)",
           "conv2d_fused_banded": "ms etc.: sum over the 5 pruned convs of "
                                  "one batch-256 forward, called directly "
                                  "(the tiled kernel's bitwise yardstick); "
                                  "launches: conv2d_fused_banded_cuda over "
                                  "phase 3's six cases and a misaligned "
                                  "view, the view the rule refuses",
           "conv2d_fused_banded_tiled": "ms etc.: sum over the 5 pruned convs "
                                        "of one batch-256 forward; launches: "
                                        "the forced banded plan (5 per "
                                        "forward, x3) and phase 13's forward "
                                        "with the fused family quarantined"}
    kernels = []
    for k in KERNELS:
        t = tot[k.name]
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "train_launches": train_launches[k.name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": max(t["bound_by"], key=t["bound_by"].get),
            "library_ms": t["library_ms"], "library_call": LIBRARY_CALLS[k.name],
            "eager_ms": t["eager_ms"],
            "per": per.get(k.name, "sum over the 5 pruned convs of one "
                                   "batch-256 forward")
            + (f"; and phase 19's {contracts['launches'][k.name]} forced "
               "calls through dispatch"
               if k.name in contracts["launches"] else ""),
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
