"""The port stands alone and never falls back to the CPU unasked:
``repro_torch`` imports neither JAX nor the JAX package, and without a CUDA
card its entry points raise unless the caller passes ``device="cpu"``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    return sorted(".".join(p.relative_to(SRC).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax_or_repro():
    mods = _modules()
    for m in ("repro_torch.data", "repro_torch.data.pipeline",
              "repro_torch.kernels.flash_attn.ops",
              "repro_torch.kernels.flash_attn.kernel", "repro_torch._tree",
              "repro_torch.optim", "repro_torch.optim.adamw",
              "repro_torch.optim.grad_compress", "repro_torch.train",
              "repro_torch.train.checkpoint", "repro_torch.train.fault",
              "repro_torch.train.sparse", "repro_torch.train.trainer",
              "repro_torch.launch", "repro_torch.launch.steps",
              "repro_torch.launch.train", "repro_torch.launch.serve",
              "repro_torch.serve", "repro_torch.serve.engine",
              "repro_torch.serve.scheduler", "repro_torch.core.tuning",
              "repro_torch.configs.qwen2_7b",
              "repro_torch.configs.nemotron_4_15b",
              "repro_torch.examples", "repro_torch.examples.conv_pipeline",
              "repro_torch.examples.quickstart",
              "repro_torch.examples.prune_and_finetune",
              "repro_torch.examples.serve_pruned",
              "repro_torch.sharding", "repro_torch.sharding.api",
              "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
              "repro_torch.roofline", "repro_torch.roofline.analysis",
              "repro_torch.roofline.kernels", "repro_torch.roofline.counter",
              "repro_torch.sharding.collective_matmul",
              "repro_torch.analysis", "repro_torch.analysis.__main__",
              "repro_torch.analysis.engine",
              "repro_torch.analysis.rules_registry",
              "repro_torch.analysis.rules_dispatch",
              "repro_torch.analysis.rules_kernels"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_import_statement_names_jax_or_repro(path):
    """Also the imports inside functions, which an import test never runs."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


@pytest.fixture
def tdb(tmp_path):
    """An empty profile DB for the port's dispatch."""
    from repro_torch import dispatch

    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    yield
    dispatch.set_db(None)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points rightly run on it")


def test_entry_points_raise_without_a_card(no_card):
    from repro_torch._compat import resolve_device
    from repro_torch.configs import get_vision_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core.formats import init_compressed
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.core.sparse_conv import conv_init
    from repro_torch.core.sparse_linear import linear_init
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.dispatch import choose_page_size
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.attention import cache_init
    from repro_torch.models.attention import paged_cache_init
    from repro_torch.models.common import embed_init, norm_init
    from repro_torch.models.lm import lm_init
    from repro_torch.models.vision import synth_batch, vision_init
    from repro_torch.train import SparseTrainConfig, SparseTrainer, Trainer

    cfg = get_vision_config("resnet-tiny")
    lm_cfg = smoke_config("smollm-360m")
    sp = SparsityConfig(sparsity=0.5, tile=8, min_dim=16,
                        format="compressed_pallas")
    gen = torch.Generator().manual_seed(0)
    calls = [
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: vision_init(cfg, 0),
        lambda: synth_batch(cfg, 0, 2),
        lambda: params_from_jax({"w": np.zeros((2, 2), np.float32)}),
        lambda: conv_init(gen, 16, 16, 3, 3, sp),
        lambda: linear_init(gen, 16, 16, sp),
        lambda: init_compressed(gen, 72, 16, sp),
        lambda: lm_init(lm_cfg, 0),
        lambda: paged_cache_init(lm_cfg, 4, 8, 2, torch.float32),
        lambda: norm_init(16),
        lambda: embed_init(gen, 8, 4),
        lambda: choose_page_size(4, 2, 16, 64),
        lambda: SparseTrainer(SparseTrainConfig(steps=1, batch=2)),
        lambda: Trainer(lm_cfg, DataConfig(vocab_size=lm_cfg.vocab_size)),
        lambda: train_main(["--arch", "smollm-360m", "--smoke", "--steps", "1"]),
        lambda: cache_init(lm_cfg, 2, 8, 2, torch.float32),
        lambda: serve_main(["--arch", "smollm-360m", "--smoke"]),
        lambda: serve_main(["--arch", "smollm-360m", "--smoke",
                            "--continuous", "--paged", "--alloc", "grow"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert SparseTrainer(SparseTrainConfig(steps=1, batch=2),
                         device="cpu").device == torch.device("cpu")
    assert Trainer(lm_cfg, DataConfig(vocab_size=lm_cfg.vocab_size),
                   device="cpu").device == torch.device("cpu")


def test_kernel_launchers_never_take_cpu_tensors():
    """A CPU tensor given to a kernel's launcher raises; it is never routed
    to the plain version there, and no launch is counted."""
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.kernels.colwise_nm import (
        colwise_nm_matmul_cuda, colwise_nm_matmul_strips_cuda,
        colwise_nm_matmul_strips_pipelined_cuda)
    from repro_torch.kernels.conv_gemm import (
        conv2d_fused_banded_cuda, conv2d_fused_cuda)
    from repro_torch.kernels.flash_attn import (flash_attention_cuda,
                                                paged_attention_cuda)
    from repro_torch.kernels.im2col_pack import im2col_pack_cuda

    reset_launch_counts()
    x = torch.zeros((8, 1, 4, 4))
    values = torch.zeros((2, 36, 8))
    idx = torch.zeros((2, 36), dtype=torch.int32)
    strips = torch.zeros((1, 72, 128))
    with pytest.raises(ValueError, match="CUDA tensor"):
        im2col_pack_cuda(x, 3, 3, 1, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        colwise_nm_matmul_strips_cuda(strips, values, idx)
    with pytest.raises(ValueError, match="CUDA tensor"):
        colwise_nm_matmul_strips_pipelined_cuda(strips, values, idx)
    with pytest.raises(ValueError, match="CUDA tensor"):
        colwise_nm_matmul_cuda(torch.zeros((4, 72)), values, idx)
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv2d_fused_banded_cuda(x, values, idx, kh=3, kw=3, pad=1)
    q = torch.zeros((1, 1, 4, 16))
    kv = torch.zeros((1, 1, 2, 16))
    pages = torch.zeros((2, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_attention_cuda(q, kv, kv, pages, pages,
                             torch.zeros((1, 1), dtype=torch.int32),
                             torch.zeros((1,), dtype=torch.int32), page_size=8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q[:, :, 0], kv[:, :, 0], kv[:, :, 0])
    assert all(k.launches == 0 for k in KERNELS)


def test_tiled_linear_launcher_never_takes_cpu_tensors():
    """The tiled linear's launcher raises on CPU tensors before any shape
    rule, and counts no launch."""
    from repro_torch.kernels.colwise_nm import (COLWISE_NM_LINEAR_TILED,
                                                colwise_nm_matmul_tiled_cuda)

    COLWISE_NM_LINEAR_TILED.launches = 0
    values = torch.zeros((2, 36, 64))
    idx = torch.zeros((2, 36), dtype=torch.int32)
    for x in (torch.zeros((4, 72)), torch.zeros((0, 72))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            colwise_nm_matmul_tiled_cuda(x, values, idx)
    assert COLWISE_NM_LINEAR_TILED.launches == 0


def test_tiled_linear_takes_no_cpu_fallback_on_a_device_tensor(tdb):
    """Only a CPU tensor runs the tiled linear's plain version, through its
    wrapper or through dispatch: a ``meta`` tensor goes to the launcher."""
    from repro_torch.core.sparse_linear import linear_apply
    from repro_torch.kernels.colwise_nm import colwise_nm_matmul_tiled

    meta = dict(device="meta")
    values = torch.zeros((2, 36, 64), **meta)
    idx = torch.zeros((2, 36), dtype=torch.int32, **meta)
    x = torch.zeros((3, 4, 72), **meta)
    for call in (lambda: colwise_nm_matmul_tiled(x, values, idx),
                 lambda: linear_apply({"values": values, "idx": idx}, x,
                                      impl="compressed_tiled")):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


def test_wrappers_take_no_cpu_fallback_on_a_device_tensor(tdb):
    """Only a CPU tensor runs a plain version: a tensor on any other device
    goes to the kernel's launcher, which takes CUDA tensors alone (here a
    ``meta`` tensor stands in for one on a card that is not there)."""
    from repro_torch.core.sparse_linear import linear_apply
    from repro_torch.kernels.colwise_nm import (
        colwise_nm_matmul, colwise_nm_matmul_strips,
        colwise_nm_matmul_strips_pipelined)
    from repro_torch.kernels.conv_gemm import (
        conv2d_fused, conv2d_fused_banded, conv2d_two_kernel,
        conv2d_two_kernel_pipelined)
    from repro_torch.kernels.flash_attn import flash_attention

    meta = dict(device="meta")
    x = torch.zeros((8, 2, 6, 6), **meta)
    values = torch.zeros((2, 36, 8), **meta)
    idx = torch.zeros((2, 36), dtype=torch.int32, **meta)
    strips = torch.zeros((1, 72, 128), **meta)
    geo = dict(kh=3, kw=3, pad=1)
    calls = [
        lambda: colwise_nm_matmul(torch.zeros((4, 72), **meta), values, idx),
        lambda: colwise_nm_matmul_strips(strips, values, idx),
        lambda: colwise_nm_matmul_strips_pipelined(strips, values, idx),
        lambda: conv2d_fused(x, values, idx, **geo),
        lambda: conv2d_fused_banded(x, values, idx, **geo),
        lambda: conv2d_two_kernel(x, values, idx, **geo),
        lambda: conv2d_two_kernel_pipelined(x, values, idx, **geo),
        lambda: linear_apply({"values": values, "idx": idx},
                             torch.zeros((4, 72), **meta),
                             impl="compressed_pallas"),
        lambda: flash_attention(torch.zeros((1, 8, 4, 16), **meta),
                                torch.zeros((1, 8, 2, 16), **meta),
                                torch.zeros((1, 8, 2, 16), **meta)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


def test_cpu_wrappers_run_plain_versions_and_count_no_launch(tdb):
    from repro_torch import dispatch
    from repro_torch.kernels import KERNELS, reset_launch_counts
    from repro_torch.kernels.conv_gemm import conv2d_sparse

    reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 1, 6, 6)).astype(np.float32))
    values = torch.from_numpy(rng.standard_normal((2, 36, 8)).astype(np.float32))
    idx = torch.arange(0, 72, 2, dtype=torch.int32).repeat(2, 1)
    impls = [None] + [s.name for s in dispatch.REGISTRY.candidates(
        "conv", param_keys=("values", "idx"))]
    for impl in impls:
        y = conv2d_sparse(x, values, idx, kh=3, kw=3, pad=1, impl=impl)
        assert tuple(y.shape) == (16, 1, 6, 6)
    assert all(k.launches == 0 for k in KERNELS)


def test_unported_plans_and_layers_raise(tdb):
    """What still raises now that every conv plan and the compressed linear
    run: a plan name no registry knows (``KeyError``, as the JAX dispatch
    raises), and a forced plan that cannot execute the layer's params, such
    as ``dense_conv`` on a compressed conv."""
    from repro_torch.core.sparse_linear import linear_apply
    from repro_torch.kernels.conv_gemm import conv2d_sparse

    x = torch.zeros((8, 1, 4, 4))
    values = torch.zeros((2, 36, 8))
    idx = torch.zeros((2, 36), dtype=torch.int32)
    with pytest.raises(KeyError, match="not a registered"):
        conv2d_sparse(x, values, idx, kh=3, kw=3, pad=1, impl="no_such_plan")
    for impl in ("dense_conv", "im2col_dense_gemm"):
        with pytest.raises(KeyError, match="requires"):
            conv2d_sparse(x, values, idx, kh=3, kw=3, pad=1, impl=impl)
    layer = {"values": torch.zeros((1, 8, 16)),
             "idx": torch.zeros((1, 8), dtype=torch.int32)}
    with pytest.raises(KeyError, match="requires"):
        linear_apply(layer, torch.zeros((2, 16)), impl="dense")
    with pytest.raises(KeyError, match="not a registered"):
        linear_apply(layer, torch.zeros((2, 16)), impl="fused_sparse_pallas")
