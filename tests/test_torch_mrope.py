"""The port's VLM family (Qwen2-VL's M-RoPE and vision embeddings,
qwen2-vl-72b) against the JAX package's, on the CPU, at qwen2-vl-72b's
smoke size (d_model 64, 4/2 heads of 16, M-RoPE sections (2, 3, 3), 4
vision patches), dense and with every linear compressed (sparsity 0.5,
``min_dim`` 16): the configs field for field; ``mrope_cos_sin`` with
unequal position components, and equal to ``rope_cos_sin`` bit for bit
where the three are equal; the vision scatter bit for bit; the scoring
forward and loss with vision embeddings and Qwen2-VL's 3-D positions
under every ``attn_impl`` (the JAX flash kernel in interpret mode under
"pallas"); the serving steps (prefill, decode at a scalar and per-slot
position, the chunked prefill), ``Engine.generate`` and both schedulers
(greedy tokens equal); one ``make_train_step`` with 1 and 2 microbatches
on vision inputs; and that ``make_train_step`` hands the loss every leaf
of the batch, split along the batch dim.

The 3-D positions follow Qwen2-VL's layout, so no test rests on equal
components: text before the image counts up on all three; the image's
patches share one temporal index and take their row and column for h and
w; the text after it continues from the largest of the three plus one.

Logits are held within 1e-4 of max|logit|, other f32 values within
``F32_TOL``.  Inputs come from numpy seeds; params come from JAX through
``params_from_jax``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.core.pruning import SparsityConfig as JSparsityConfig
from repro.core.sparse_linear import unbox_tree
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.serve import Engine as JEngine
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeConfig as JServeConfig
from repro.serve import synthetic_trace as j_synthetic_trace
from repro_torch import dispatch
from repro_torch._tree import keystr, leaves_with_path
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import SparsityConfig
from repro_torch.launch import steps as tsteps
from repro_torch.launch.steps import make_train_step
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serve import Engine, Scheduler, ServeConfig, synthetic_trace

ARCH = "qwen2-vl-72b"
SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=16,
              format="compressed_pallas")
FMTS = ("dense", "sparse")
IMPLS = ("naive", "chunked", "pallas")
LOGIT_RTOL = 1e-4  # of max|logit|
F32_TOL = 1e-5
OPT = dict(lr=1e-3, weight_decay=0.01, eps=1e-6)
PARAM_ATOL = 1e-4
GRID = (2, 2)  # the smoke config's 4 patches as a 2 x 2 image


@pytest.fixture(autouse=True)
def dbs(tmp_path):
    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    jdispatch.set_db(jdispatch.ProfileDB(path=str(tmp_path / "jax.json")))
    yield
    dispatch.set_db(None)
    jdispatch.set_db(None)


def _cfgs(fmt="sparse", **kw):
    jcfg, tcfg = j_smoke_config(ARCH).with_(**kw), smoke_config(ARCH).with_(**kw)
    if fmt == "sparse":
        jcfg = jcfg.with_(sparsity=JSparsityConfig(**SPARSE))
        tcfg = tcfg.with_(sparsity=SparsityConfig(**SPARSE))
    return jcfg, tcfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _params(fmt="sparse"):
    cfg = _cfgs(fmt)[0]
    init = jax.jit(lambda key: unbox_tree(jlm.lm_init(cfg, key))[0])
    return _np(init(jax.random.PRNGKey(0)))


def _jparams(fmt="sparse"):
    return jax.tree_util.tree_map(jnp.asarray, _params(fmt))


def _tparams(fmt="sparse"):
    return params_from_jax(_params(fmt), device="cpu")


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 503, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _logits_close(got, want):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= LOGIT_RTOL * float(np.abs(want).max()), err


def qwen2vl_positions(b, s, grid=GRID, first=1):
    """Qwen2-VL's 3-D positions [B, 3, S] for one image of ``grid`` patches
    a sequence, placed after ``first + row`` text tokens in batch row
    ``row``, and its patches' token indices [B, P]."""
    gh, gw = grid
    n = gh * gw
    pos = np.zeros((b, 3, s), np.int32)
    vision_pos = np.zeros((b, n), np.int32)
    ii, jj = np.divmod(np.arange(n), gw)
    for r in range(b):
        off = first + r
        assert off + n < s
        pos[r, :, :off] = np.arange(off)
        pos[r, 0, off:off + n] = off
        pos[r, 1, off:off + n] = off + ii
        pos[r, 2, off:off + n] = off + jj
        nxt = pos[r, :, :off + n].max() + 1
        pos[r, :, off + n:] = nxt + np.arange(s - off - n)
        vision_pos[r] = off + np.arange(n)
    return pos, vision_pos


def _batch(b, s, seed):
    pos, vpos = qwen2vl_positions(b, s)
    ve = np.random.default_rng(seed + 1).standard_normal(
        (b, vpos.shape[1], 64)).astype(np.float32)
    return {"tokens": _tokens((b, s), seed), "mrope_positions": pos,
            "vision_embeds": ve, "vision_pos": vpos}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Config, M-RoPE, the vision scatter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["published", "smoke"])
def test_config_matches_jax(which):
    mine, theirs = ((get_config(ARCH), j_get_config(ARCH)) if which ==
                    "published" else (smoke_config(ARCH), j_smoke_config(ARCH)))
    for f in dataclasses.fields(mine):
        if f.name != "sparsity":
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    for prop in ("resolved_head_dim", "padded_heads", "padded_vocab"):
        assert getattr(mine, prop) == getattr(theirs, prop), prop
    assert mine.mrope and mine.family == "vlm"
    assert sum(mine.mrope_sections) == mine.resolved_head_dim // 2


@pytest.mark.parametrize("hd,sections,theta", [(16, (2, 3, 3), 1e6),
                                               (128, (16, 24, 24), 1e6),
                                               (64, (8, 12, 12), 1e4)])
def test_mrope_cos_sin_matches_jax_with_unequal_components(hd, sections,
                                                           theta):
    """cos/sin of Qwen2-VL's 3-D positions, and of random unequal ones,
    within F32_TOL of JAX's; they differ from 1-D RoPE at the same
    temporal positions (the sections' choice matters)."""
    pos3, _ = qwen2vl_positions(2, 12)
    rnd = np.random.default_rng(hd).integers(0, 3000, (2, 3, 12)).astype(
        np.int32)
    for p in (pos3, rnd):
        jc, js = jcommon.mrope_cos_sin(jnp.asarray(p), hd, theta, sections)
        tc, ts = tcommon.mrope_cos_sin(_t(p), hd, theta, sections)
        assert tuple(tc.shape) == jc.shape == (2, 12, hd // 2)
        assert tc.dtype == torch.float32
        _close(tc, jc)
        _close(ts, js)
        rc, _ = tcommon.rope_cos_sin(_t(p[:, 0]), hd, theta)
        assert not torch.equal(rc, tc)


@pytest.mark.parametrize("hd,sections", [(16, (2, 3, 3)), (128, (16, 24, 24))])
def test_mrope_with_equal_components_is_rope_bit_for_bit(hd, sections):
    pos = np.random.default_rng(0).integers(0, 5000, (3, 9)).astype(np.int32)
    pos3 = np.broadcast_to(pos[:, None], (3, 3, 9))
    tc, ts = tcommon.mrope_cos_sin(_t(pos3), hd, 1e6, sections)
    rc, rs = tcommon.rope_cos_sin(_t(pos), hd, 1e6)
    assert torch.equal(tc, rc) and torch.equal(ts, rs)
    jc, _ = jcommon.mrope_cos_sin(jnp.asarray(pos3), hd, 1e6, sections)
    jr, _ = jcommon.rope_cos_sin(jnp.asarray(pos), hd, 1e6)
    assert np.array_equal(np.asarray(jc), np.asarray(jr))


def test_mrope_sections_must_sum_to_half_the_head():
    with pytest.raises(ValueError, match="must sum to head_dim/2"):
        tcommon.mrope_cos_sin(torch.zeros((1, 3, 2), dtype=torch.int32), 16,
                              1e4, (2, 3, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_scatter_matches_jax_bit_for_bit(dtype):
    """The vision embeddings, cast to the activation dtype, written over
    the token embeddings at ``vision_pos``; a config of another family
    ignores them, as in JAX."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    batch = _batch(2, 10, 3)
    want = np.asarray(jlm._embed_tokens(_jparams(), jcfg, _jb(batch)))
    got = tlm._embed_tokens(_tparams(), tcfg, _tb(batch))
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    got = got.view(torch.int16) if dtype == "bfloat16" else got
    assert got.numpy().tobytes() == want.tobytes()
    plain = tlm._embed_tokens(_tparams(), tcfg.with_(family="dense"),
                              _tb(batch))
    assert torch.equal(plain, tlm._embed(_tparams(), tcfg.with_(
        family="dense"), _t(batch["tokens"])))


# ---------------------------------------------------------------------------
# The scoring forward and loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("attn_impl", IMPLS)
def test_forward_and_loss_match_jax(fmt, attn_impl):
    """``forward_fn``/``loss_fn`` with vision embeddings and 3-D
    positions: the logits, the NLL and aux."""
    jcfg, tcfg = _cfgs(fmt, attn_impl=attn_impl, attn_chunk=4)
    batch = _batch(2, 12, 4)
    jlogits = jreg.forward_fn(jcfg)(_jparams(fmt), _jb(batch))
    jloss, jparts = jreg.loss_fn(jcfg)(_jparams(fmt), _jb(batch))
    with torch.no_grad():
        logits = treg.forward_fn(tcfg)(_tparams(fmt), _tb(batch))
        loss, parts = treg.loss_fn(tcfg)(_tparams(fmt), _tb(batch))
    assert tuple(logits.shape) == (2, 12, tcfg.padded_vocab)
    _logits_close(logits, jlogits)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=F32_TOL)
    np.testing.assert_allclose(float(parts["nll"]), float(jparts["nll"]),
                               rtol=F32_TOL)
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0


@pytest.mark.parametrize("fmt", FMTS)
def test_forward_without_mrope_positions_is_1d_rope(fmt):
    """A batch without ``mrope_positions`` rotates by 1-D RoPE, in both
    packages; with Qwen2-VL's 3-D positions the logits differ from it."""
    jcfg, tcfg = _cfgs(fmt)
    batch = _batch(2, 12, 5)
    flat = {k: v for k, v in batch.items() if k != "mrope_positions"}
    want = jreg.forward_fn(jcfg)(_jparams(fmt), _jb(flat))
    with torch.no_grad():
        got = treg.forward_fn(tcfg)(_tparams(fmt), _tb(flat))
        rope3 = treg.forward_fn(tcfg)(_tparams(fmt), _tb(batch))
        dense = treg.forward_fn(tcfg.with_(mrope=False))(_tparams(fmt),
                                                         _tb(batch))
    _logits_close(got, want)
    assert torch.equal(got, dense)
    assert float((rope3 - got).abs().max()) > 1e-3 * float(got.abs().max())


# ---------------------------------------------------------------------------
# Serving: text positions (the three components equal)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn_impl", ["naive", "chunked"])
def test_prefill_and_decode_steps_match_jax(attn_impl):
    """``prefill``'s logits and cache, then decode steps at a scalar and
    at per-slot positions against the same cache."""
    jcfg, tcfg = _cfgs(attn_impl=attn_impl, attn_chunk=4)
    toks = _tokens((2, 9), 6)
    jp, tp = _jparams(), _tparams()
    jl, jc = jreg.prefill_fn(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = treg.prefill_fn(tcfg)(tp, {"tokens": _t(toks)})
    _logits_close(tl, jl)
    for k in ("k", "v"):
        _close(tc[k], jc[k])
    jfull = jreg.cache_init_fn(jcfg, 2, 16)()
    jfull = {k: jfull[k].at[:, :, :9].set(jc[k]) for k in ("k", "v")}
    tfull = treg.cache_init_fn(tcfg, 2, 16, "cpu")()
    for k in ("k", "v"):
        tfull[k][:, :, :9] = tc[k]
    for pos in (9, np.array([10, 7], np.int32)):
        tok = _tokens((2, 1), 7)
        jl, jfull = jreg.decode_fn(jcfg)(jp, jfull, jnp.asarray(tok),
                                         jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            tl, tfull = treg.decode_fn(tcfg)(tp, tfull, _t(tok),
                                             torch.as_tensor(pos))
        _logits_close(tl, jl)
    for k in ("k", "v"):
        _close(tfull[k], jfull[k])


def test_prefill_chunk_matches_jax():
    jcfg, tcfg = _cfgs()
    toks = _tokens((1, 10), 8)
    jcache = jreg.cache_init_fn(jcfg, 1, 16)()
    tcache = treg.cache_init_fn(tcfg, 1, 16, "cpu")()
    for start in (0, 4, 8):
        chunk = np.zeros((1, 4), np.int32)
        part = toks[:, start:start + 4]
        chunk[:, :part.shape[1]] = part
        jl, jcache = jreg.prefill_chunk_fn(jcfg)(
            _jparams(), jcache, jnp.asarray(chunk), jnp.asarray(start))
        with torch.no_grad():
            tl, tcache = treg.prefill_chunk_fn(tcfg)(_tparams(), tcache,
                                                     _t(chunk), start)
        _logits_close(tl, jl)
    for k in ("k", "v"):
        _close(tcache[k], jcache[k])


@pytest.mark.parametrize("fmt", FMTS)
def test_generate_equals_jax(fmt):
    """Greedy ``generate``; ``extras`` reach a decoder-only model's prefill
    not at all, in either package."""
    jcfg, tcfg = _cfgs(fmt)
    prompts = _tokens((3, 9), 9)
    extras = {k: v for k, v in _batch(3, 9, 10).items() if k != "tokens"}
    want = JEngine(jcfg, _jparams(fmt), JServeConfig(max_new_tokens=6)
                   ).generate(prompts, extras=extras)
    got = Engine(tcfg, _tparams(fmt), ServeConfig(max_new_tokens=6)
                 ).generate(prompts, extras=extras)
    plain = Engine(tcfg, _tparams(fmt), ServeConfig(max_new_tokens=6)
                   ).generate(prompts)
    assert np.array_equal(got["tokens"], np.asarray(want["tokens"]))
    assert np.array_equal(got["gen_lens"], np.asarray(want["gen_lens"]))
    assert np.array_equal(got["tokens"], plain["tokens"])


@pytest.mark.parametrize("paged", [True, False])
def test_scheduler_tokens_equal_jax(paged):
    """The paged scheduler (packed prefill and paged decode, 1-D RoPE) and
    the contiguous one (chunked prefill, equal components)."""
    jcfg, tcfg = _cfgs()
    kw = dict(seed=3, vocab=503, prompt_lens=(3, 14), new_tokens=(2, 8))
    opts = dict(n_slots=3, paged=paged, page_size=8 if paged else None,
                prefill_chunk=4)
    jsched = JScheduler(JEngine(jcfg, _jparams(), JServeConfig()), **opts)
    want = {c.uid: c for c in jsched.run(j_synthetic_trace(5, **kw))}
    sched = Scheduler(Engine(tcfg, _tparams()), **opts)
    got = {c.uid: c for c in sched.run(synthetic_trace(5, **kw))}
    assert sorted(got) == sorted(want) == list(range(5))
    for uid, c in got.items():
        assert c.status == want[uid].status == "ok"
        assert np.array_equal(c.tokens, want[uid].tokens), uid


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    """One AdamW step on vision inputs and 3-D positions: the loss and the
    gradients' global norm within 1e-4, every updated leaf within
    PARAM_ATOL."""
    jcfg, tcfg = _cfgs()
    batch = _batch(4, 10, 11)
    jp = _jparams()
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(**OPT),
                                           microbatches))
    jp2, _, jm = jstep(jp, j_adamw_init(jp), _jb(batch))
    tp = _tparams()
    step = make_train_step(tcfg, AdamWConfig(**OPT), microbatches)
    tp2, _, tm = step(tp, adamw_init(tp), _tb(batch))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    tflat = {keystr(p): v for p, v in leaves_with_path(tp2)}
    for path, w in jax.tree_util.tree_leaves_with_path(_np(jp2)):
        t = tflat[jax.tree_util.keystr(path)]
        assert str(t.dtype).replace("torch.", "") == str(w.dtype), path
        assert float(np.abs(t.float().numpy() - w).max()) <= PARAM_ATOL, path


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_hands_the_loss_every_batch_leaf(monkeypatch,
                                                         microbatches):
    """The loss receives every key of the batch, each leaf split along the
    batch dim into ``microbatches`` consecutive parts (JAX's reshape), and
    the step's loss is their mean."""
    from repro_torch.configs import smoke_config as port_smoke

    cfg = port_smoke("smollm-360m")
    seen = []

    def loss_fn(_cfg):
        def lfn(params, batch):
            seen.append({k: v.clone() for k, v in batch.items()})
            nll = (params["final_norm"]["scale"].sum()
                   * batch["extra"].float().mean()) + batch["tokens"].sum()
            return nll, {"nll": nll, "aux": torch.zeros(())}
        return lfn

    monkeypatch.setattr(tsteps.reg, "loss_fn", loss_fn)
    params = tlm.lm_init(cfg, 0, device="cpu")
    batch = {"tokens": _t(np.arange(8, dtype=np.int32).reshape(4, 2)),
             "extra": _t(np.arange(12, dtype=np.float32).reshape(4, 3))}
    step = make_train_step(cfg, AdamWConfig(**OPT), microbatches)
    _, _, metrics = step(params, adamw_init(params), batch)
    assert len(seen) == microbatches
    rows = 4 // microbatches
    for i, got in enumerate(seen):
        assert set(got) == {"tokens", "extra"}
        for k, v in batch.items():
            assert torch.equal(got[k], v[i * rows:(i + 1) * rows]), k
    scale = float(params["final_norm"]["scale"].sum())
    want = np.mean([scale * float(b["extra"].mean()) + float(b["tokens"].sum())
                    for b in seen])
    np.testing.assert_allclose(float(metrics["loss"]), want, rtol=1e-6)
