"""The recurrent families of the port against the JAX package, on the CPU:
Mamba2 (zamba2-7b) and xLSTM (xlstm-350m).

The block twins of ``tests/test_recurrence_equivalence.py``, each held
against JAX's function on the same input: ``mamba_apply`` and
``mamba_decode`` at chunks 4, 8 and 16 and the ragged chunk 5 on length 13,
``mlstm_apply`` and ``mlstm_decode`` the same way and over 256 steps,
``slstm_apply`` and ``slstm_decode``, and Zamba2's shared block.  Then the
smoke models: the init tree leaf for leaf (the float32 leaves included),
the scoring forward and loss, the cache tree, six decode steps at a scalar
and a per-sequence position, ``prefill`` (``(logits, None)``),
``Engine.generate``, one AdamW step of ``make_train_step`` with every
gradient finite, and checkpoints each package restores from the other.

Outputs and logits are held within ``RTOL`` of max|y|, states within
``RTOL`` of their leaf's max, dense and with every linear compressed
(sparsity 0.5, ``min_dim`` 32, so every projection takes the plain version
of the sparse linear kernel).  Inputs come from numpy seeds; params come
from JAX through ``params_from_jax``."""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.configs import smoke_config as j_smoke_config
from repro.core.pruning import SparsityConfig as JSparsityConfig
from repro.core.sparse_linear import unbox_tree
from repro.launch import steps as jsteps
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch import dispatch
from repro_torch._tree import (keystr, leaves_with_path, tree_leaves, tree_map,
                               value_and_grad)
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import SparsityConfig
from repro_torch.launch.steps import make_train_step
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train.checkpoint import CheckpointManager

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("xlstm-350m", "zamba2-7b")
SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=32,
              format="compressed_pallas")
FMTS = ("dense", "sparse")
RTOL = 1e-4  # of max|y|
# AdamW's first step moves an element by lr * g / (|g| + eps): about lr
# whatever the size of g once |g| >> eps, so an element whose gradient is
# zero but for rounding (1e-9 here) moves by up to lr either way with the
# sign rounding gave it.  eps 1e-6 (not 1e-8) keeps such an element's step
# under 1e-2 lr, and the updated params are held within PARAM_ATOL
OPT = dict(lr=1e-3, weight_decay=0.01, eps=1e-6)
PARAM_ATOL = 1e-4


@pytest.fixture(autouse=True)
def dbs(tmp_path):
    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    jdispatch.set_db(jdispatch.ProfileDB(path=str(tmp_path / "jax.json")))
    yield
    dispatch.set_db(None)
    jdispatch.set_db(None)


def _cfgs(arch, fmt="sparse", **kw):
    jcfg, tcfg = j_smoke_config(arch).with_(**kw), smoke_config(arch).with_(**kw)
    if fmt == "sparse":
        jcfg = jcfg.with_(sparsity=JSparsityConfig(**SPARSE))
        tcfg = tcfg.with_(sparsity=SparsityConfig(**SPARSE))
    return jcfg, tcfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _params(arch, fmt="sparse"):
    """JAX's params of the smoke model (its ``lm_init``, jitted: eager, the
    stacked inits take several times as long)."""
    cfg = _cfgs(arch, fmt)[0]
    init = jax.jit(lambda key: unbox_tree(jlm.lm_init(cfg, key))[0])
    return _np(init(jax.random.PRNGKey(0)))


def _tparams(arch, fmt="sparse"):
    return params_from_jax(_params(arch, fmt), device="cpu")


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 503, shape).astype(np.int32)


def _ints(a):
    return torch.from_numpy(np.asarray(a, np.int32).copy())


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(got - want).max())
    assert err <= RTOL * max(float(np.abs(want).max()), 1e-30), (what, err)


def _trees_close(got, want):
    """Leaf for leaf: the same keys (JAX's keystr), shapes and dtypes, each
    leaf within RTOL of its max."""
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = {keystr(p): v for p, v in leaves_with_path(got)}
    assert sorted(tl) == sorted(jax.tree_util.keystr(p) for p, _ in jl)
    for path, w in jl:
        t = tl[jax.tree_util.keystr(path)]
        w = np.asarray(w)
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).replace("torch.", "") == str(w.dtype), path
        _close(t, w, jax.tree_util.keystr(path))


def _block(init, cfg_j, cfg_t):
    """One block's params from JAX: (numpy tree, the port's tree)."""
    jp = _np(unbox_tree(init(jax.random.PRNGKey(0), cfg_j))[0])
    return jp, params_from_jax(jp, device="cpu")


def _decode_seq(fn, params, cfg, cache, x, cat):
    """A per-token decode over x [B, S, d]: (outputs stacked on S, cache)."""
    outs = []
    for t in range(x.shape[1]):
        y, cache = fn(params, cfg, x[:, t:t + 1], cache)
        outs.append(y)
    return cat(outs), cache


def _apply_and_decode(jmod, tmod, name, cfg_j, cfg_t, x, jcache, tcache):
    """``name``_apply and a decode over x in both packages: outputs and the
    final states held to JAX's."""
    jp, tp = _block(getattr(jmod, f"{name}_init"), cfg_j, cfg_t)
    y_j = getattr(jmod, f"{name}_apply")(jp, cfg_j, jnp.asarray(x))
    dec = getattr(jmod, f"{name}_decode")
    jdec = jax.jit(lambda p, h, c: dec(p, cfg_j, h, c))
    ys_j, jc = _decode_seq(lambda p, _, h, c: jdec(p, h, c), jp, cfg_j,
                           jcache, jnp.asarray(x),
                           lambda o: jnp.concatenate(o, axis=1))
    with torch.no_grad():
        y_t = getattr(tmod, f"{name}_apply")(tp, cfg_t, torch.from_numpy(x))
        ys_t, tc = _decode_seq(getattr(tmod, f"{name}_decode"), tp, cfg_t,
                               tcache, torch.from_numpy(x),
                               lambda o: torch.cat(o, dim=1))
    _close(y_t, y_j, "apply")
    _close(ys_t, ys_j, "decode")
    _trees_close(tc, jc)
    return y_t


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------


MAMBA_CASES = {"chunk4": (4, 16), "chunk8": (8, 16), "chunk16": (16, 16),
               "ragged5": (5, 13)}


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", list(MAMBA_CASES))
def test_mamba_apply_and_decode_match_jax(case, fmt):
    chunk, s = MAMBA_CASES[case]
    kw = dict(d_model=32, ssm_head_dim=8, ssm_state=8, ssm_chunk=chunk,
              expand=2)
    cfg_j, cfg_t = _cfgs("zamba2-7b", fmt, **kw)
    x = _x((2, s, 32), 1)
    _apply_and_decode(jssm, tssm, "mamba", cfg_j, cfg_t, x,
                      jssm.mamba_cache_init(cfg_j, 2),
                      tssm.mamba_cache_init(cfg_t, 2, device="cpu"))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", list(MAMBA_CASES))
def test_mlstm_apply_and_decode_match_jax(case, fmt):
    chunk, s = MAMBA_CASES[case]
    kw = dict(d_model=32, n_heads=2, n_kv_heads=2, ssm_chunk=chunk, expand=2)
    cfg_j, cfg_t = _cfgs("xlstm-350m", fmt, **kw)
    x = _x((2, s, 32), 2)
    _apply_and_decode(jxlstm, txlstm, "mlstm", cfg_j, cfg_t, x,
                      jxlstm.mlstm_cache_init(cfg_j, 2),
                      txlstm.mlstm_cache_init(cfg_t, 2, device="cpu"))


def test_mlstm_long_sequence_is_stable_like_jax():
    """256 steps of exponential gating on large inputs stay finite (the
    stabiliser), and equal JAX's."""
    kw = dict(d_model=32, n_heads=2, n_kv_heads=2, ssm_chunk=16, expand=2)
    cfg_j, cfg_t = _cfgs("xlstm-350m", "dense", **kw)
    jp, tp = _block(jxlstm.mlstm_init, cfg_j, cfg_t)
    x = _x((1, 256, 32), 3, scale=2.0)
    y_j = jxlstm.mlstm_apply(jp, cfg_j, jnp.asarray(x))
    with torch.no_grad():
        y_t = txlstm.mlstm_apply(tp, cfg_t, torch.from_numpy(x))
    assert bool(torch.isfinite(y_t).all())
    _close(y_t, y_j)


@pytest.mark.parametrize("fmt", FMTS)
def test_slstm_apply_and_decode_match_jax(fmt):
    kw = dict(d_model=32, n_heads=2, n_kv_heads=2, expand=2)
    cfg_j, cfg_t = _cfgs("xlstm-350m", fmt, **kw)
    x = _x((2, 12, 32), 4)
    _apply_and_decode(jxlstm, txlstm, "slstm", cfg_j, cfg_t, x,
                      jxlstm.slstm_cache_init(cfg_j, 2),
                      txlstm.slstm_cache_init(cfg_t, 2, device="cpu"))


@pytest.mark.parametrize("fmt", FMTS)
def test_shared_block_apply_and_decode_match_jax(fmt):
    """Zamba2's shared block over [h, h0], then three decode steps against
    one application's cache (positions 5, 6, 7 of a 12-row cache)."""
    cfg_j, cfg_t = _cfgs("zamba2-7b", fmt)
    jp, tp = _block(jblocks.shared_block_init, cfg_j, cfg_t)
    h, h0 = _x((2, 9, 64), 5), _x((2, 9, 64), 6)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9))
    y_j = jblocks.shared_block_apply(jp, cfg_j, jnp.asarray(h), jnp.asarray(h0),
                                     positions=jnp.asarray(pos))
    with torch.no_grad():
        y_t = tblocks.shared_block_apply(tp, cfg_t, torch.from_numpy(h),
                                         torch.from_numpy(h0),
                                         positions=torch.from_numpy(pos.copy()))
    _close(y_t, y_j, "apply")
    kv = _x((2, 2, 12, 2, 16), 7)
    jk, jv = jnp.asarray(kv[0]), jnp.asarray(kv[1])
    tk, tv = torch.from_numpy(kv[0].copy()), torch.from_numpy(kv[1].copy())
    for t in range(3):
        x, x0 = _x((2, 1, 64), 10 + t), _x((2, 1, 64), 20 + t)
        y_j, (kn, vn) = jblocks.shared_block_decode(
            jp, cfg_j, jnp.asarray(x), jnp.asarray(x0), (jk, jv),
            pos=jnp.asarray(5 + t, jnp.int32))
        with torch.no_grad():
            y_t, (tkn, tvn) = tblocks.shared_block_decode(
                tp, cfg_t, torch.from_numpy(x), torch.from_numpy(x0),
                (tk, tv), pos=torch.full((2,), 5 + t, dtype=torch.int32))
        _close(y_t, y_j, f"decode {t}")
        _close(tkn, kn)
        _close(tvn, vn)
        jk = jk.at[:, 5 + t].set(kn[:, 0])
        jv = jv.at[:, 5 + t].set(vn[:, 0])
        tk[:, 5 + t], tv[:, 5 + t] = tkn[:, 0], tvn[:, 0]


# ---------------------------------------------------------------------------
# The smoke models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,param_dtype", [("dense", "float32"),
                                             ("sparse", "bfloat16")])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_init_tree_matches_jax_leaf_for_leaf(arch, fmt, param_dtype):
    """Keys, shapes and dtypes; ``A_log``, ``D``, ``dt_bias``, ``gates_b``
    and the sLSTM ``b`` float32 whatever ``param_dtype`` is."""
    jcfg, tcfg = _cfgs(arch, fmt, param_dtype=param_dtype)
    jp = jax.eval_shape(
        lambda: unbox_tree(jlm.lm_init(jcfg, jax.random.PRNGKey(0)))[0])
    tp = tlm.lm_init(tcfg, 0, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = {keystr(p): v for p, v in leaves_with_path(tp)}
    assert sorted(tflat) == sorted(jax.tree_util.keystr(p) for p, _ in jflat)
    for path, leaf in jflat:
        t = tflat[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
    if arch == "zamba2-7b":
        assert tuple(tp["mamba_tail"]["A_log"].shape) == (1, 8)
        assert tuple(tp["mamba"]["A_log"].shape) == (2, 2, 8)
        assert tp["mamba"]["A_log"].dtype == torch.float32
    else:
        assert tuple(tp["mlstm"]["gates_b"].shape) == (2, 1, 4)
        assert tp["slstm"]["b"].dtype == torch.float32
    assert treg.init_params(tcfg, 0, device="cpu").keys() == tp.keys()


@pytest.mark.parametrize("arch,fmt,attn_impl", [
    ("xlstm-350m", "dense", "naive"), ("xlstm-350m", "sparse", "naive"),
    ("zamba2-7b", "sparse", "naive"), ("zamba2-7b", "sparse", "pallas")])
def test_forward_and_loss_match_jax(arch, fmt, attn_impl):
    """Logits, loss and NLL, aux 0; under ``attn_impl="pallas"`` the port's
    flash wrapper runs its plain version, JAX its kernel in interpret
    mode."""
    jcfg, tcfg = _cfgs(arch, fmt, attn_impl=attn_impl)
    toks = _tokens((2, 13), 3)
    jl, jaux = jlm.lm_forward(_params(arch, fmt), jcfg,
                              {"tokens": jnp.asarray(toks)})
    jloss, jparts = jreg.loss_fn(jcfg)(_params(arch, fmt),
                                       {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl = treg.forward_fn(tcfg)(_tparams(arch, fmt), {"tokens": _ints(toks)})
        tloss, tparts = treg.loss_fn(tcfg)(_tparams(arch, fmt),
                                           {"tokens": _ints(toks)})
    _close(tl, jl)
    assert float(tparts["aux"]) == float(jaux) == 0.0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(tparts["nll"]), float(jparts["nll"]),
                               rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_init_tree_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    want = _np(jreg.cache_init_fn(jcfg, 3, 10)())
    got = treg.cache_init_fn(tcfg, 3, 10, "cpu")()
    _trees_close(got, want)
    if arch == "zamba2-7b":
        assert sorted(got) == ["mamba", "mamba_tail", "shared_kv"]
        assert tuple(got["shared_kv"]["k"].shape) == (2, 3, 10, 2, 16)
        assert tlm.n_shared_applications(tcfg) == 2
    else:
        assert sorted(got) == ["mlstm", "slstm"]
        # every leaf a tensor of its own: a decode step writes in place
        ptrs = [t.data_ptr() for t in tree_leaves(got)]
        assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("pos_kind", ["scalar", "per_seq"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, pos_kind):
    """Six decode steps from an empty cache, at a scalar position or at
    per-sequence positions (the shared block's KV rows move apart):
    logits each step, and the caches leaf by leaf after the last."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch), _tparams(arch)
    toks = _tokens((3, 6), 4)
    jc = jreg.cache_init_fn(jcfg, 3, 12)()
    tc = treg.cache_init_fn(tcfg, 3, 12, "cpu")()
    jdec = jax.jit(jreg.decode_fn(jcfg))
    for t in range(6):
        pos = (np.int32(t) if pos_kind == "scalar"
               else np.array([t, t + 2, 11], np.int32))
        jl, jc = jdec(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        with torch.no_grad():
            tl, tc = treg.decode_fn(tcfg)(tp, tc, _ints(toks[:, t:t + 1]), pos)
        _close(tl, jl, f"step {t}")
    _trees_close(tc, _np(jc))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_returns_last_logits_and_no_cache(arch):
    """``prefill`` is (the forward's last-position logits, None), as in
    the JAX package; the engine's prefill by decode steps gives the same
    logits and JAX's cache."""
    jcfg, tcfg = _cfgs(arch)
    toks = _tokens((2, 9), 5)
    jl, jc = jreg.prefill_fn(jcfg)(_params(arch), {"tokens": jnp.asarray(toks)})
    with torch.no_grad(), dispatch.phase_scope("prefill"):
        tl, tc = treg.prefill_fn(tcfg)(_tparams(arch), {"tokens": _ints(toks)})
    assert jc is None and tc is None
    assert tuple(tl.shape) == (2, 1, tcfg.padded_vocab)
    _close(tl, jl)
    jl2, jc2 = JEngine(jcfg, _params(arch), JServeConfig()).prefill_step(toks, 12)
    with torch.no_grad():
        tl2, tc2 = Engine(tcfg, _tparams(arch)).prefill_step(toks, 12)
    _close(tl2, jl2)
    _close(tl2, jl)
    _trees_close(tc2, _np(jc2))


@pytest.mark.parametrize("eos", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_equals_jax(arch, eos):
    """Greedy tokens and gen_lens identical to the JAX engine's; with an
    EOS that the free run emits, the tail after it is masked to EOS."""
    jcfg, tcfg = _cfgs(arch)
    prompts = _tokens((3, 7), 6)
    eos_id = None
    if eos:
        free = Engine(tcfg, _tparams(arch),
                      ServeConfig(max_new_tokens=6)).generate(prompts)
        eos_id = int(free["tokens"][1, 2])
    jres = JEngine(jcfg, _params(arch), JServeConfig(
        max_new_tokens=6, eos_id=eos_id)).generate(prompts)
    with torch.no_grad():
        res = Engine(tcfg, _tparams(arch), ServeConfig(
            max_new_tokens=6, eos_id=eos_id)).generate(prompts)
    assert np.array_equal(res["tokens"], np.asarray(jres["tokens"]))
    assert np.array_equal(res["gen_lens"], jres["gen_lens"])
    if eos:
        assert res["gen_lens"][1] <= 3
        assert (res["tokens"][1, res["gen_lens"][1]:] == eos_id).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One AdamW step of ``make_train_step`` from JAX's params on the same
    tokens: the loss and the gradients' global norm within RTOL, the
    updated params within PARAM_ATOL, every gradient finite (the masked
    exponents of the SSD chunk and the mLSTM)."""
    jcfg, tcfg = _cfgs(arch)
    toks = _tokens((2, 12), 7)
    jp = jax.tree_util.tree_map(jnp.asarray, _params(arch))
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(**OPT)))
    jp2, _, jm = jstep(jp, j_adamw_init(jp), {"tokens": jnp.asarray(toks)})
    tp = _tparams(arch)
    (_, _), grads = value_and_grad(
        lambda p: treg.loss_fn(tcfg)(p, {"tokens": _ints(toks)}), tp)
    for path, g in leaves_with_path(grads):
        assert bool(torch.isfinite(g).all()), keystr(path)
    assert any(float(g.abs().max()) > 0 for g in tree_leaves(grads))
    step = make_train_step(tcfg, AdamWConfig(**OPT))
    tp2, _, tm = step(tp, adamw_init(tp), {"tokens": _ints(toks)})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL)
    tflat = {keystr(p): v for p, v in leaves_with_path(tp2)}
    for path, w in jax.tree_util.tree_leaves_with_path(_np(jp2)):
        t = tflat[jax.tree_util.keystr(path)]
        assert str(t.dtype).replace("torch.", "") == str(w.dtype), path
        assert float(np.abs(t.float().numpy() - w).max()) <= PARAM_ATOL, path


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_packages(arch, tmp_path):
    """A recurrent params tree written by each package's checkpoint
    manager and restored by the other, bit for bit."""
    jtree = {"params": _params(arch)}
    JCheckpointManager(tmp_path / "jax").save(3, jtree)
    proto = {"params": params_from_jax(jtree["params"], device="cpu")}
    zeros = tree_map(torch.zeros_like, proto)
    out, _ = CheckpointManager(tmp_path / "jax").restore(None, zeros)
    for (pa, a), (_, b) in zip(leaves_with_path(out), leaves_with_path(proto),
                               strict=True):
        assert torch.equal(a, b), keystr(pa)
    CheckpointManager(tmp_path / "port").save(4, proto)
    jout, _ = JCheckpointManager(tmp_path / "port").restore(None, jtree)
    for a, b in zip(jax.tree_util.tree_leaves(jout),
                    jax.tree_util.tree_leaves(jtree), strict=True):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------


def test_serve_launcher_static_runs_xlstm():
    """``python -m repro_torch.launch.serve --arch xlstm-350m --smoke
    --device cpu`` (static mode) exits 0."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "xlstm-350m", "--smoke", "--device", "cpu", "--batch", "2",
         "--new-tokens", "4", "--prompt-len", "8"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "arch=xlstm-350m" in out.stdout and "seq1:" in out.stdout


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_continuous_refuses_like_the_scheduler(arch):
    from repro_torch.launch import serve as launch_serve

    with pytest.raises(ValueError, match="continuous batching requires"):
        launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--continuous", "--requests", "2", "--slots", "2"])


def test_train_launcher_runs_zamba(tmp_path, capsys):
    """``launch/train.py --arch zamba2-7b --smoke``: two AdamW steps and a
    checkpoint of the recurrent tree."""
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "8",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert "loss" in capsys.readouterr().out
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000002"]
