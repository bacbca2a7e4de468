"""The twins of the JAX package's four examples, on the CPU at small sizes:
each runs through its ``main`` and meets the check its JAX example prints
(``conv_pipeline``: every layer's max|err| against the dense oracle within
1e-4 of its max|y|, half the dense FLOPs; ``prune_and_finetune``: the
compressed forward's loss equal to the masked one within 1e-4, half the
body weights stored; ``serve_pruned``: tokens at 0, 50% and 75%;
``quickstart``: trains, checkpoints, and a rerun resumes), and
``conv_pipeline``'s layers are held against the JAX example's own
functions.  Each also runs as ``python -m repro_torch.examples.<name>
--device cpu``, and without a card and without ``device="cpu"`` each
raises."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import dispatch
from repro_torch.examples import (conv_pipeline, prune_and_finetune,
                                  quickstart, serve_pruned)
from repro_torch.kernels import KERNELS, reset_launch_counts
from repro_torch.train import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("conv_pipeline", "quickstart", "prune_and_finetune", "serve_pruned")


@pytest.fixture(autouse=True)
def db(tmp_path):
    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    reset_launch_counts()
    yield
    dispatch.set_db(None)
    assert all(k.launches == 0 for k in KERNELS)  # the CPU runs no kernel


def _jax_example(name):
    """The JAX example module (``examples/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_are_the_jax_examples():
    assert conv_pipeline.LAYERS == _jax_example("conv_pipeline").LAYERS
    assert conv_pipeline.SPARSITY == _jax_example("conv_pipeline").SPARSITY
    assert (prune_and_finetune.SPARSITY
            == _jax_example("prune_and_finetune").SPARSITY)


@pytest.mark.parametrize("seed,v", [(0, 32), (1, 32), (2, 128)])
def test_conv_pipeline_meets_the_dense_oracle(seed, v):
    out = conv_pipeline.main("cpu", batch=2, hw=16, v=v, seed=seed)
    assert len(out["layers"]) == len(conv_pipeline.LAYERS)
    for layer in out["layers"]:
        assert layer["max_err"] <= conv_pipeline.RTOL * layer["max_ref"]
        assert layer["flops"] * 2 == layer["dense_flops"]
    assert out["flops"] * 2 == out["dense_flops"]


@pytest.mark.parametrize("seed", [0, 1])
def test_conv_pipeline_layers_match_the_jax_example(seed, monkeypatch):
    """Each layer of the twin held against the JAX example's own
    ``compress_conv_weights`` and ``conv2d_colwise_sparse`` (Pallas,
    interpret mode) on the same weights and inputs, within 1e-5 of the
    layer's max|y|."""
    import jax.numpy as jnp

    jex = _jax_example("conv_pipeline")
    real_compress = conv_pipeline.compress_conv_weights
    real_conv = conv_pipeline.conv2d_colwise_sparse
    weights, layers = [], []

    def compress(w, cfg):
        weights.append((w.numpy().copy(), cfg))
        return real_compress(w, cfg)

    def conv(x, values, idx, **kw):
        y = real_conv(x, values, idx, **kw)
        layers.append((x.numpy().copy(), kw, y.numpy().copy()))
        return y

    monkeypatch.setattr(conv_pipeline, "compress_conv_weights", compress)
    monkeypatch.setattr(conv_pipeline, "conv2d_colwise_sparse", conv)
    conv_pipeline.main("cpu", batch=2, hw=16, seed=seed)
    assert len(layers) == len(weights) == len(conv_pipeline.LAYERS)
    for (w, cfg), (x, kw, y) in zip(weights, layers):
        jcfg = jex.SparsityConfig(sparsity=cfg.sparsity, m=cfg.m,
                                  tile=cfg.tile, format=cfg.format)
        values, idx, _ = jex.compress_conv_weights(jnp.asarray(w), jcfg)
        want = np.asarray(jex.conv2d_colwise_sparse(jnp.asarray(x), values,
                                                    idx, **kw))
        assert y.shape == want.shape
        assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()


def test_conv_pipeline_raises_past_its_tolerance(monkeypatch):
    """The check is a check: a wrong conv fails it."""
    from repro_torch.kernels import conv_gemm

    real = conv_gemm.conv2d_colwise_sparse
    monkeypatch.setattr(conv_pipeline, "conv2d_colwise_sparse",
                        lambda *a, **k: real(*a, **k) * 1.01)
    with pytest.raises(AssertionError, match=r"max\|err\|"):
        conv_pipeline.main("cpu")


def test_quickstart_trains_checkpoints_and_resumes(tmp_path):
    ck = tmp_path / "ckpt"
    out = quickstart.main("cpu", steps=6, batch=4, seq_len=16, ckpt_dir=ck,
                          ckpt_every=3, log_every=2)
    assert out["final_step"] == 6 and out["start_step"] == 0
    losses = [h["loss"] for h in out["history"]]
    assert all(np.isfinite(losses)) and len(losses) == 4
    assert out["cfg"].sparsity.sparsity == 0.5
    assert CheckpointManager(ck).latest_step() == 6
    again = quickstart.main("cpu", steps=6, batch=4, seq_len=16, ckpt_dir=ck,
                            ckpt_every=3)
    assert again["start_step"] == 6 and again["history"] == []


def test_prune_and_finetune_compressed_equals_masked():
    out = prune_and_finetune.main("cpu", dense_steps=6, finetune_steps=3,
                                  batch=4, seq_len=16, eval_batches=2)
    assert np.isfinite(out["dense_nll"])
    assert set(out["results"]) == {"colwise adaptive-M (paper)",
                                   "rowwise 2:4 baseline"}
    for one_shot, ft in out["results"].values():
        assert np.isfinite(one_shot) and np.isfinite(ft)
    assert (abs(out["compressed_loss"] - out["masked_loss"])
            <= prune_and_finetune.LOSS_RTOL * abs(out["masked_loss"]))
    assert out["kept"] * 2 == out["total"]


def test_serve_pruned_emits_tokens_at_each_sparsity():
    out = serve_pruned.main("cpu", n_prompts=4, prompt_len=8, new_tokens=5,
                            n_layers=2, d_model=128, d_ff=256)
    assert list(out) == list(serve_pruned.SPARSITIES) == [0.0, 0.5, 0.75]
    for res in out.values():
        assert res["tokens"].shape == (4, 5)
        assert ((res["tokens"] >= 0) & (res["tokens"] < 512)).all()
        assert res["decode_tok_s"] > 0


@pytest.mark.parametrize("sparsity", [0.5, 0.75])
def test_serve_pruned_builds_the_jax_model(sparsity):
    """Untied qwen2-7b smoke widened as in JAX; every linear compressed
    (T = d_out) where JAX compresses it."""
    cfg, params = serve_pruned.build(sparsity, "cpu")
    assert not cfg.tie_embeddings and "unembed" in params
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff) == (4, 512, 4096)
    assert set(params["layers"]["mlp"]["up"]) == {"values", "idx"}
    assert params["layers"]["mlp"]["up"]["values"].shape[-1] == 4096


def test_examples_run_as_modules():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.conv_pipeline",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "block total" in out.stdout


@pytest.mark.parametrize("name", NAMES)
def test_examples_raise_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the examples rightly run on it")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()
