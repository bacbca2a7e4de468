"""The port's encoder-decoder family (``repro_torch.models.encdec``,
whisper-small) against the JAX package's, on the CPU, at whisper-small's
smoke size (2 encoder and 2 decoder layers, d_model 64, 4/2 heads, 24
frames), dense and with every linear compressed (sparsity 0.5,
``min_dim`` 16): the configs field for field; the init tree leaf for
leaf; ``sinusoidal_positions`` bit for bit; ``encode``, ``decode_forward``
and ``encdec_loss`` under every ``attn_impl`` (the JAX flash kernel in
interpret mode under "pallas"); ``encdec_prefill``'s logits and every
cache leaf; each ``encdec_decode_step`` over a prompt; ``Engine.generate``
with ``extras`` (greedy tokens equal, also with fewer frames than
``encoder_seq``, which ``_grow_cache`` must carry whole); one
``make_train_step`` with 1 and 2 microbatches; and the refusals of the
paged steps, the chunked prefill and the ``Scheduler``, word for word.

Logits are held within 1e-4 of max|logit|, activations and cache leaves
within ``F32_TOL`` (the same sums in another order).  Inputs come from
numpy seeds; params come from JAX through ``params_from_jax``."""
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
from repro.models import encdec as jencdec
from repro.models import registry as jreg
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.serve import Engine as JEngine
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeConfig as JServeConfig
from repro_torch import dispatch
from repro_torch._tree import keystr, leaves_with_path
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import SparsityConfig
from repro_torch.launch.steps import make_train_step
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as tencdec
from repro_torch.models import registry as treg
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serve import Engine, Scheduler, ServeConfig

ARCH = "whisper-small"
SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=16,
              format="compressed_pallas")
FMTS = ("dense", "sparse")
IMPLS = ("naive", "chunked", "pallas")
LOGIT_RTOL = 1e-4  # of max|logit|
F32_TOL = 1e-5
# AdamW as tests/test_torch_recurrent.py steps it: eps 1e-6 keeps an
# element whose gradient is zero but for rounding from moving by ~lr
OPT = dict(lr=1e-3, weight_decay=0.01, eps=1e-6)
PARAM_ATOL = 1e-4


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
    init = jax.jit(lambda key: unbox_tree(jencdec.encdec_init(cfg, key))[0])
    return _np(init(jax.random.PRNGKey(0)))


def _jparams(fmt="sparse"):
    return jax.tree_util.tree_map(jnp.asarray, _params(fmt))


def _tparams(fmt="sparse"):
    return params_from_jax(_params(fmt), device="cpu")


def _frames(b, s, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, 64)).astype(np.float32)


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


# ---------------------------------------------------------------------------
# Config, init, positions
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
    assert mine.is_encoder_decoder and not mine.use_rope
    assert mine.padded_vocab == (51968 if which == "published" else 512)


@pytest.mark.parametrize("fmt", FMTS)
def test_init_tree_matches_jax_leaf_for_leaf(fmt):
    """The same keys (JAX's keystr), shapes and dtypes, from the port's own
    init and from the registry."""
    jcfg, tcfg = _cfgs(fmt)
    jp = jax.eval_shape(
        lambda: unbox_tree(jencdec.encdec_init(jcfg, jax.random.PRNGKey(0)))[0])
    for tp in (tencdec.encdec_init(tcfg, 0, device="cpu"),
               treg.init_params(tcfg, 0, device="cpu")):
        tflat = {keystr(p): v for p, v in leaves_with_path(tp)}
        jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
        assert sorted(tflat) == sorted(jax.tree_util.keystr(p)
                                       for p, _ in jflat)
        for path, leaf in jflat:
            t = tflat[jax.tree_util.keystr(path)]
            assert tuple(t.shape) == leaf.shape, path
            assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
    assert set(tp) == {"dec_embed", "enc_layers", "dec_layers", "enc_norm",
                       "dec_norm"}
    assert set(tp["dec_layers"]) == {"ln1", "self_attn", "ln_x",
                                     "cross_attn", "ln2", "mlp"}


@pytest.mark.parametrize("n,d", [(24, 64), (1500, 768), (448, 768), (9, 3),
                                 (4, 2), (3, 1)])
def test_sinusoidal_positions_bit_for_bit(n, d):
    got = tcommon.sinusoidal_positions(n, d)
    want = jcommon.sinusoidal_positions(n, d)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert torch.equal(tcommon.sinusoidal_on(n, d, torch.device("cpu")),
                       torch.from_numpy(want))


# ---------------------------------------------------------------------------
# The scoring forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("attn_impl", IMPLS)
def test_encode_matches_jax(fmt, attn_impl, monkeypatch):
    """The non-causal encoder: under "pallas" one flash call a layer, each
    with causal=False."""
    from repro_torch.kernels import flash_attn

    calls, orig = [], flash_attn.flash_attention

    def flash(q, k, v, **kw):
        calls.append(kw["causal"])
        return orig(q, k, v, **kw)

    monkeypatch.setattr(flash_attn, "flash_attention", flash)
    jcfg, tcfg = _cfgs(fmt, attn_impl=attn_impl, attn_chunk=8)
    frames = _frames(2, 24)
    want = jencdec.encode(_jparams(fmt), jcfg, jnp.asarray(frames))
    with torch.no_grad():
        got = tencdec.encode(_tparams(fmt), tcfg, _t(frames))
    assert tuple(got.shape) == (2, 24, 64)
    _close(got, want)
    assert calls == ([False] * tcfg.encoder_layers if attn_impl == "pallas"
                     else [])


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("attn_impl", IMPLS)
def test_decode_forward_matches_jax(fmt, attn_impl):
    """The scoring decoder over the JAX encoder's states: causal
    self-attention, cross-attention, the tied unembedding."""
    jcfg, tcfg = _cfgs(fmt, attn_impl=attn_impl, attn_chunk=4)
    enc = jencdec.encode(_jparams(fmt), jcfg, jnp.asarray(_frames(2, 24)))
    toks = _tokens((2, 11), 2)
    want = jencdec.decode_forward(_jparams(fmt), jcfg, jnp.asarray(toks), enc)
    with torch.no_grad():
        got = tencdec.decode_forward(_tparams(fmt), tcfg, _t(toks),
                                     _t(np.asarray(enc)))
    assert tuple(got.shape) == (2, 11, tcfg.padded_vocab)
    _logits_close(got, want)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("attn_impl", IMPLS)
def test_loss_and_forward_fn_match_jax(fmt, attn_impl):
    """``registry.loss_fn``/``forward_fn``: the NLL (the padded vocab
    masked), aux zero, the logits."""
    jcfg, tcfg = _cfgs(fmt, attn_impl=attn_impl, attn_chunk=8)
    batch = {"enc_embeds": _frames(2, 24, 3), "tokens": _tokens((2, 13), 4)}
    jloss, jparts = jreg.loss_fn(jcfg)(
        _jparams(fmt), {k: jnp.asarray(v) for k, v in batch.items()})
    jlogits = jreg.forward_fn(jcfg)(
        _jparams(fmt), {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, parts = treg.loss_fn(tcfg)(_tparams(fmt), tb)
        logits = treg.forward_fn(tcfg)(_tparams(fmt), tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=F32_TOL)
    assert float(parts["nll"]) == float(loss)
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
    _logits_close(logits, jlogits)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _cache_close(got, want):
    assert set(got) == set(want) == {"k", "v", "xk", "xv"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k], want[k])


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("attn_impl", ["naive", "chunked"])
@pytest.mark.parametrize("frames", [24, 17])
def test_prefill_matches_jax(fmt, attn_impl, frames, monkeypatch):
    """Last-token logits and every cache leaf; the cross K/V sized by the
    frames given, not by ``encoder_seq``; flash never called."""
    from repro_torch.kernels import flash_attn

    monkeypatch.setattr(flash_attn, "flash_attention",
                        lambda *a, **k: pytest.fail("prefill called flash"))
    jcfg, tcfg = _cfgs(fmt, attn_impl=attn_impl, attn_chunk=4)
    enc, toks = _frames(2, frames, 5), _tokens((2, 9), 6)
    jl, jc = jreg.prefill_fn(jcfg)(_jparams(fmt), {
        "enc_embeds": jnp.asarray(enc), "tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = treg.prefill_fn(tcfg)(_tparams(fmt), {
            "enc_embeds": _t(enc), "tokens": _t(toks)})
    assert tuple(tl.shape) == (2, 1, tcfg.padded_vocab)
    assert tuple(tc["xk"].shape) == (2, 2, frames, 2, 16)
    _logits_close(tl, jl)
    _cache_close(tc, jc)


@pytest.mark.parametrize("fmt", FMTS)
def test_decode_steps_match_jax(fmt):
    """Prefill a prompt into a cache of 12 rows, then decode its tokens
    one by one: each step's logits, and the cache after the last."""
    jcfg, tcfg = _cfgs(fmt)
    enc, toks = _frames(2, 20, 7), _tokens((2, 8), 8)
    jp, tp = _jparams(fmt), _tparams(fmt)
    _, jc = jreg.prefill_fn(jcfg)(jp, {"enc_embeds": jnp.asarray(enc),
                                       "tokens": jnp.asarray(toks[:, :3])})
    with torch.no_grad():
        _, tc = treg.prefill_fn(tcfg)(tp, {"enc_embeds": _t(enc),
                                           "tokens": _t(toks[:, :3])})
    jfull = jreg.cache_init_fn(jcfg, 2, 12)()
    tfull = treg.cache_init_fn(tcfg, 2, 12, "cpu")()
    assert tuple(tfull["xk"].shape) == jfull["xk"].shape == (2, 2, 24, 2, 16)
    jfull = dict(jfull, k=jfull["k"].at[:, :, :3].set(jc["k"]),
                 v=jfull["v"].at[:, :, :3].set(jc["v"]), xk=jc["xk"],
                 xv=jc["xv"])
    tfull["k"][:, :, :3] = tc["k"]
    tfull["v"][:, :, :3] = tc["v"]
    tfull.update(xk=tc["xk"], xv=tc["xv"])
    for pos in range(3, 8):
        jl, jfull = jreg.decode_fn(jcfg)(jp, jfull,
                                         jnp.asarray(toks[:, pos:pos + 1]),
                                         jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            tl, tfull = treg.decode_fn(tcfg)(tp, tfull,
                                             _t(toks[:, pos:pos + 1]),
                                             torch.tensor(pos, dtype=torch.int32))
        assert tuple(tl.shape) == (2, 1, tcfg.padded_vocab)
        _logits_close(tl, jl)
    _cache_close(tfull, jfull)


def test_decode_step_takes_a_scalar_pos():
    _, tcfg = _cfgs()
    cache = treg.cache_init_fn(tcfg, 2, 8, "cpu")()
    with pytest.raises(ValueError, match="scalar pos"):
        tencdec.encdec_decode_step(_tparams(), tcfg, cache, _t(_tokens(
            (2, 1), 0)), torch.tensor([1, 2], dtype=torch.int32))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("frames", [24, 17])
def test_generate_with_extras_equals_jax(fmt, frames):
    """Greedy ``generate`` with ``extras={"enc_embeds": ...}``: the tokens
    and gen_lens equal JAX's; with fewer frames than ``encoder_seq`` the
    prefill's cross K/V must reach the decode steps whole."""
    jcfg, tcfg = _cfgs(fmt)
    prompts, enc = _tokens((3, 5), 9), _frames(3, frames, 10)
    want = JEngine(jcfg, _jparams(fmt), JServeConfig(max_new_tokens=7)).generate(
        prompts, extras={"enc_embeds": enc})
    got = Engine(tcfg, _tparams(fmt), ServeConfig(max_new_tokens=7)).generate(
        prompts, extras={"enc_embeds": enc})
    assert np.array_equal(got["tokens"], want["tokens"])
    assert np.array_equal(got["gen_lens"], want["gen_lens"])


def test_grow_cache_carries_the_cross_kv_whole():
    """``prefill_step`` grows the self K/V to max_len and keeps the
    prefill's cross K/V (17 frames, not ``encoder_seq``'s 24)."""
    _, tcfg = _cfgs()
    engine = Engine(tcfg, _tparams())
    enc = _frames(2, 17, 11)
    logits, cache = engine.prefill_step(_tokens((2, 4), 12), 10,
                                        extras={"enc_embeds": enc})
    _, want = treg.prefill_fn(tcfg)(engine.params, {
        "enc_embeds": _t(enc), "tokens": _t(_tokens((2, 4), 12))})
    assert tuple(cache["k"].shape) == (2, 2, 10, 2, 16)
    assert torch.equal(cache["k"][:, :, :4], want["k"])
    assert not bool(cache["k"][:, :, 4:].any())
    for k in ("xk", "xv"):
        assert torch.equal(cache[k], want[k])


def test_refusals_match_jax():
    """The paged steps, the chunked prefill and the Scheduler refuse an
    encoder-decoder model in JAX's words."""
    jcfg, tcfg = _cfgs()
    for mine, theirs in (
            (lambda: treg.prefill_chunk_fn(tcfg),
             lambda: jreg.prefill_chunk_fn(jcfg)),
            (lambda: treg.paged_decode_fn(tcfg, 4),
             lambda: jreg.paged_decode_fn(jcfg, 4)),
            (lambda: treg.prefill_packed_fn(tcfg, 4),
             lambda: jreg.prefill_packed_fn(jcfg, 4)),
            (lambda: treg.paged_cache_init_fn(tcfg, 8, 4, "cpu"),
             lambda: jreg.paged_cache_init_fn(jcfg, 8, 4))):
        with pytest.raises(NotImplementedError) as want:
            theirs()
        with pytest.raises(NotImplementedError) as got:
            mine()
        assert str(got.value) == str(want.value)
        assert str(got.value).endswith(" (encoder-decoder)")
    with pytest.raises(ValueError) as want:
        JScheduler(JEngine(jcfg, _jparams(), JServeConfig()), paged=True)
    with pytest.raises(ValueError) as got:
        Scheduler(Engine(tcfg, _tparams()), paged=True)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    """One AdamW step of ``make_train_step`` on frames and tokens: the loss
    and the gradients' global norm within 1e-4, every updated leaf within
    PARAM_ATOL."""
    jcfg, tcfg = _cfgs()
    batch = {"enc_embeds": _frames(4, 24, 13), "tokens": _tokens((4, 10), 14)}
    jp = _jparams()
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(**OPT),
                                           microbatches))
    jp2, _, jm = jstep(jp, j_adamw_init(jp),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    tp = _tparams()
    step = make_train_step(tcfg, AdamWConfig(**OPT), microbatches)
    tp2, _, tm = step(tp, adamw_init(tp), {k: _t(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    tflat = {keystr(p): v for p, v in leaves_with_path(tp2)}
    for path, w in jax.tree_util.tree_leaves_with_path(_np(jp2)):
        t = tflat[jax.tree_util.keystr(path)]
        assert str(t.dtype).replace("torch.", "") == str(w.dtype), path
        assert float(np.abs(t.float().numpy() - w).max()) <= PARAM_ATOL, path
