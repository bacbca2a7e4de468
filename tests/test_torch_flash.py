"""The port's scoring forward against the JAX package's, on the CPU: the
flash kernel's plain version against ``flash_attention_pallas`` in
interpret mode over ``tests/test_flash_attn.py``'s sweep (JAX's TOL, f32 and
bf16); the GQA wrapper against JAX's ``flash_attention`` and ``sdpa_gqa``
(3e-5); ``sdpa_gqa``/``sdpa_gqa_chunked`` case for case with
``tests/test_attention_chunked.py`` (2e-5); ``attn_apply``'s three branches;
``forward_fn``/``loss_fn`` of smollm-360m's smoke config, dense and pruned,
under each ``attn_impl`` (1e-4 of max|logit|, NLL 1e-5 relative); the
qwen2-0.5b smoke twin of ``test_model_level_pallas_attention``;
``SyntheticLM`` (bit-identical); and the rules around the kernels: forward
only, off the serving path, and the shape rule that routes a call on the
card to the tiled kernel or to the other (with the tiled kernel's shared
memory), on either side of which the CPU path matches JAX.  Inputs come from numpy seeds; params come
from JAX through ``params_from_jax``.

``test_gradients_match`` of the chunked tests has no twin: the port has no
training path yet, and the flash kernel has no gradient in either package.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.configs import smoke_config as j_smoke_config
from repro.core.pruning import SparsityConfig as JSparsityConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels.flash_attn import flash_attention as j_flash_attention
from repro.kernels.flash_attn import flash_attention_pallas
from repro.models import attention as jattn
from repro.models import registry as jreg
from repro_torch import dispatch
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import SparsityConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import KERNELS
from repro_torch.kernels.flash_attn import (
    FLASH_TILED_SHAPES,
    flash_attention,
    flash_attention_ref,
    flash_smem_bytes,
    flash_tiled_config,
    flash_tiled_smem_bytes,
    flash_tiled_takes,
)
from repro_torch.kernels.flash_attn.kernel import FLASH_MAX_D
from repro_torch.models import attention as tattn
from repro_torch.models import registry as treg
from repro_torch.models.blocks import block_apply, layer_params

SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=16,
              format="compressed_pallas")
TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # tests/test_flash_attn.py's TOL
WRAPPER_TOL = 3e-5  # test_gqa_wrapper_matches_sdpa
CHUNKED_TOL = 2e-5  # tests/test_attention_chunked.py
LOGIT_RTOL = 1e-4   # of max|logit|: the same sums in another order
NLL_RTOL = 1e-5
# tests/test_flash_attn.py's sweep: (bh, sq, sk, d, bq, bk, causal)
SWEEP = [
    (2, 32, 32, 16, 8, 8, True),
    (1, 16, 48, 16, 8, 16, False),   # cross-attn-like
    (2, 24, 24, 32, 16, 8, True),    # ragged q blocks
    (1, 8, 8, 16, 128, 128, True),   # blocks > dims
    (3, 33, 17, 16, 8, 8, True),     # ragged both: the top-left mask
]
IMPLS = ["naive", "chunked", "pallas"]


@pytest.fixture(autouse=True)
def dbs(tmp_path):
    """Empty profile DBs for both packages' dispatch."""
    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    jdispatch.set_db(jdispatch.ProfileDB(path=str(tmp_path / "jax.json")))
    yield
    dispatch.set_db(None)
    jdispatch.set_db(None)


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _both(arrays, dtype="float32"):
    """The same values as JAX arrays and as CPU tensors of ``dtype``."""
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(got)
                                          else got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The kernel's plain version and the wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,sq,sk,d,bq,bk,causal", SWEEP)
def test_plain_version_matches_pallas_interpret(bh, sq, sk, d, bq, bk, causal,
                                                dtype):
    (jq, jk, jv), (q, k, v) = _both(
        _normal(bh * sq + sk, (bh, sq, d), (bh, sk, d), (bh, sk, d)), dtype)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, block_q=bq,
                                  block_k=bk, interpret=True)
    got = flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == q.dtype and tuple(got.shape) == want.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (5, 2)])
def test_wrapper_matches_jax_flash_and_sdpa(h, kvh):
    """The GQA map (h * KV) // H, defined for H % KV != 0 too."""
    b, sq, d = 2, 16, 16
    (jq, jk, jv), (q, k, v) = _both(
        _normal(7, (b, sq, h, d), (b, sq, kvh, d), (b, sq, kvh, d)))
    got = flash_attention(q, k, v, causal=True, block_q=8, block_k=8)
    assert tuple(got.shape) == (b, sq, h, d)
    _close(got, j_flash_attention(jq, jk, jv, causal=True, block_q=8,
                                  block_k=8), WRAPPER_TOL)
    _close(got, jattn.sdpa_gqa(jq, jk, jv, causal=True), WRAPPER_TOL)
    _close(got, tattn.sdpa_gqa(q, k, v, causal=True), WRAPPER_TOL)


def test_large_logits_stay_finite():
    """Logits that overflow a naive exp (q = k = 30)."""
    (jq, jk, jv), (q, k, v) = _both(
        [np.full((1, 8, 16), 30.0, np.float32),
         np.full((1, 8, 16), 30.0, np.float32), *_normal(0, (1, 8, 16))])
    want = flash_attention_pallas(jq, jk, jv, causal=False, block_q=4,
                                  block_k=4, interpret=True)
    got = flash_attention_ref(q, k, v, causal=False)
    assert bool(torch.isfinite(got).all())
    _close(got, want, TOL["float32"])
    wrapped = flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                              causal=True)
    assert bool(torch.isfinite(wrapped).all())


def test_flash_is_forward_only():
    """The twin of ``jax.grad`` failing through the Pallas kernel: under
    autograd with an input that requires grad the wrapper raises, rather
    than differentiate through the plain version."""
    q, k, v = (torch.from_numpy(a) for a in
               _normal(1, (1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16)))
    with pytest.raises(RuntimeError, match="forward only"):
        flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert tuple(flash_attention(q, k, v).shape) == (1, 8, 2, 16)
    with pytest.raises(ValueError, match="positive"):
        flash_attention(q.detach(), k, v, block_q=0)
    cfg = smoke_config("smollm-360m").with_(attn_impl="pallas")
    params = treg.init_params(cfg, 0, device="cpu")
    params["embed"].requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        treg.loss_fn(cfg)(params, {"tokens": np.zeros((1, 8), np.int32)})
    with torch.no_grad():
        loss, _ = treg.loss_fn(cfg)(params, {"tokens": np.zeros((1, 8),
                                                                np.int32)})
    assert bool(torch.isfinite(loss))


# ---------------------------------------------------------------------------
# The two kernels' routing rule and the tiled kernel's shared memory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_tiled_takes_whole_16_byte_rows(dtype):
    """The tiled kernel takes D % 4 == 0 (f32) or D % 8 == 0 (bf16) up to
    D 128, with 16-byte aligned operands; ``flash_attention.cu`` takes the
    rest up to D 128.  A rule of the shape and pointers alone (CPU tensors
    here: it needs no card)."""
    vec = 4 if dtype == torch.float32 else 8
    for d in range(1, 131):
        q = torch.zeros((1, 3, 5, d), dtype=dtype)
        k = torch.zeros((1, 3, 2, d), dtype=dtype)
        want = d % vec == 0 and d <= FLASH_MAX_D
        assert flash_tiled_takes(q, k, k) == want, d
        assert (flash_tiled_smem_bytes(d, dtype, 64) is not None) == want, d
        assert (flash_smem_bytes(d) is not None) == (d <= FLASH_MAX_D), d
    base = torch.zeros(1 + 3 * 5 * 64, dtype=dtype)
    q = base[1:].view(1, 3, 5, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    k = torch.zeros((1, 3, 2, 64), dtype=dtype)
    assert not flash_tiled_takes(q, k, k)
    assert flash_tiled_takes(q.clone(), k, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_tiled_smem_fits_every_head_it_takes(dtype):
    """The rule's instance fits a block's 227 KB for every D the kernel
    takes, and the footprint is the C side's: Q and two stages of K and V
    in the operands' dtype with rows padded by 16 bytes, and the f32
    probabilities [64][rows + 4]."""
    isz = 4 if dtype == torch.float32 else 2
    for d in range(1, FLASH_MAX_D + 1):
        if d * isz % 16:
            continue
        rows, rpt = flash_tiled_config(d, dtype)
        assert (rows, rpt) in FLASH_TILED_SHAPES
        assert rpt == 4 or d <= 64
        smem = flash_tiled_smem_bytes(d, dtype, rows)
        ld = d + 16 // isz
        assert smem == (rows + 4 * 64) * ld * isz + 64 * (rows + 4) * 4
        assert smem <= 227 * 1024, (d, rows, smem)
    assert flash_tiled_smem_bytes(64, torch.float32, 32) is None
    assert flash_tiled_smem_bytes(64, torch.float16, 64) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 18, 20, 64])
def test_cpu_path_matches_jax_flash_either_side_of_the_rule(d, dtype):
    """On the CPU ``flash_attention`` runs its plain version whichever
    kernel the card would take (D 18 and, in bf16, D 20 go to
    ``flash_attention.cu`` there): it matches JAX's ``flash_attention``,
    which runs the Pallas kernel in interpret mode here, at the (5, 2) GQA
    map with the top-left mask and ragged blocks."""
    b, sq, sk, h, kvh = 1, 19, 13, 5, 2
    (jq, jk, jv), (q, k, v) = _both(
        _normal(d, (b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)), dtype)
    got = flash_attention(q, k, v, causal=True, block_q=8, block_k=8)
    assert got.dtype == q.dtype and tuple(got.shape) == (b, sq, h, d)
    _close(got, j_flash_attention(jq, jk, jv, causal=True, block_q=8,
                                  block_k=8), TOL[dtype])


# ---------------------------------------------------------------------------
# sdpa_gqa and sdpa_gqa_chunked, case for case with the JAX chunked tests
# ---------------------------------------------------------------------------


def _mk(b, sq, sk, h, kvh, d, seed=0):
    return _both(_normal(seed, (b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,chunk,causal", [
    (2, 16, 16, 4, 2, 8, 4, True),
    (2, 16, 16, 4, 2, 8, 16, True),     # single chunk
    (1, 8, 24, 4, 4, 8, 7, False),      # ragged chunks, MHA
    (2, 12, 12, 6, 2, 8, 5, True),      # ragged + GQA 3:1
    (1, 8, 8, 5, 2, 8, 4, True),        # h % kvh != 0 (mapped)
])
def test_sdpa_and_chunked_match_jax(b, sq, sk, h, kvh, d, chunk, causal):
    (jq, jk, jv), (q, k, v) = _mk(b, sq, sk, h, kvh, d)
    want = jattn.sdpa_gqa(jq, jk, jv, causal=causal)
    _close(tattn.sdpa_gqa(q, k, v, causal=causal), want, CHUNKED_TOL)
    got = tattn.sdpa_gqa_chunked(q, k, v, causal=causal, chunk=chunk)
    _close(got, want, CHUNKED_TOL)
    _close(got, jattn.sdpa_gqa_chunked(jq, jk, jv, causal=causal, chunk=chunk),
           CHUNKED_TOL)


def test_kv_len_mask():
    (jq, jk, jv), (q, k, v) = _mk(2, 1, 32, 4, 2, 8)
    want = jattn.sdpa_gqa(jq, jk, jv, causal=False, kv_len=jnp.asarray([5, 17]))
    kv_len = torch.tensor([5, 17])
    _close(tattn.sdpa_gqa(q, k, v, causal=False, kv_len=kv_len), want,
           CHUNKED_TOL)
    _close(tattn.sdpa_gqa_chunked(q, k, v, causal=False, kv_len=kv_len,
                                  chunk=8), want, CHUNKED_TOL)


def test_q_offset_decode_window():
    (jq, jk, jv), (q, k, v) = _mk(1, 4, 16, 2, 2, 4)
    want = jattn.sdpa_gqa(jq, jk, jv, causal=True, q_offset=12)
    _close(tattn.sdpa_gqa(q, k, v, causal=True, q_offset=12), want,
           CHUNKED_TOL)
    _close(tattn.sdpa_gqa_chunked(q, k, v, causal=True, q_offset=12, chunk=5),
           want, CHUNKED_TOL)


# ---------------------------------------------------------------------------
# attn_apply, the blocks and the model
# ---------------------------------------------------------------------------


def _jcfg(name="smollm-360m", sparse=False, **kw):
    cfg = j_smoke_config(name).with_(**kw)
    return cfg.with_(sparsity=JSparsityConfig(**SPARSE)) if sparse else cfg


def _tcfg(name="smollm-360m", sparse=False, **kw):
    cfg = smoke_config(name).with_(**kw)
    return cfg.with_(sparsity=SparsityConfig(**SPARSE)) if sparse else cfg


@functools.lru_cache(maxsize=None)
def _jparams(name, sparse, n_layers):
    cfg = _jcfg(name, sparse, n_layers=n_layers)
    jp, _ = jreg.init_params(cfg, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


def _batch(seq_len=24, seed=3):
    """A bigram batch of the smoke vocab, from the port's own stream."""
    return SyntheticLM(DataConfig(vocab_size=503, batch=2, seq_len=seq_len,
                                  seed=seed)).batch_at(0)


def _jimpl(impl):
    return dict(attn_impl=impl, attn_chunk=8)


@pytest.mark.parametrize("impl", IMPLS)
def test_attn_apply_and_block_match_jax(impl):
    from repro.models import blocks as jblocks

    jp = _jparams("smollm-360m", True, 2)
    jl0 = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    tl0 = layer_params(params_from_jax(jp, device="cpu")["layers"], 0)
    jcfg, tcfg = _jcfg(sparse=True, **_jimpl(impl)), _tcfg(sparse=True,
                                                          **_jimpl(impl))
    (x,) = _normal(4, (2, 24, 64))
    pos = np.broadcast_to(np.arange(24)[None], (2, 24))
    want = jattn.attn_apply(jl0["attn"], jcfg, jnp.asarray(x),
                            positions=jnp.asarray(pos))
    got = tattn.attn_apply(tl0["attn"], tcfg, torch.from_numpy(x),
                           positions=torch.from_numpy(pos.copy()))
    _close(got, want, 1e-5)
    jh, jaux = jblocks.block_apply(jl0, jcfg, jnp.asarray(x),
                                   positions=jnp.asarray(pos))
    th, taux = block_apply(tl0, tcfg, torch.from_numpy(x),
                           positions=torch.from_numpy(pos.copy()))
    _close(th, jh, 1e-5)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "pruned"])
def test_forward_and_loss_match_jax(sparse, impl):
    """smollm-360m's smoke config (vocab 503, so the padded-vocab mask is
    exercised) under each attention: the port's forward_fn logits and
    loss_fn NLL against the JAX package's on the same params and batch."""
    jcfg = _jcfg(sparse=sparse, **_jimpl(impl))
    tcfg = _tcfg(sparse=sparse, **_jimpl(impl))
    assert tcfg.padded_vocab != tcfg.vocab_size
    jp = _jparams("smollm-360m", sparse, 2)
    tp = params_from_jax(jp, device="cpu")
    if sparse:
        assert "values" in tp["layers"]["mlp"]["down"]
    batch = _batch()
    jbatch = {"tokens": jnp.asarray(batch["tokens"])}
    want = jax.jit(jreg.forward_fn(jcfg))(jp, jbatch)
    jloss, jaux = jax.jit(jreg.loss_fn(jcfg))(jp, jbatch)
    with torch.no_grad():
        got = treg.forward_fn(tcfg)(tp, batch)
        loss, aux = treg.loss_fn(tcfg)(tp, batch)
    assert tuple(got.shape) == want.shape == (2, 24, tcfg.padded_vocab)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= LOGIT_RTOL * float(np.abs(want).max()), err
    np.testing.assert_allclose(float(aux["nll"]), float(jaux["nll"]),
                               rtol=NLL_RTOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=NLL_RTOL)
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    assert all(k.launches == 0 for k in KERNELS)


def test_qwen2_smoke_pallas_matches_naive_and_jax():
    """The twin of ``test_model_level_pallas_attention``: one layer of
    qwen2-0.5b's smoke config (qkv bias, H 4, KV 2), naive against pallas
    within 2e-4, and the port against the JAX package."""
    jcfg = _jcfg("qwen2-0.5b", n_layers=1, attn_impl="pallas")
    tcfg_n = _tcfg("qwen2-0.5b", n_layers=1, attn_impl="naive")
    tcfg_p = tcfg_n.with_(attn_impl="pallas")
    assert tcfg_p.qkv_bias
    jp = _jparams("qwen2-0.5b", False, 1)
    tp = params_from_jax(jp, device="cpu")
    assert "b" in tp["layers"]["attn"]["q"]
    tokens = np.random.default_rng(1).integers(0, 503, (2, 16)).astype(np.int32)
    ln = treg.forward_fn(tcfg_n)(tp, {"tokens": tokens})
    lp = treg.forward_fn(tcfg_p)(tp, {"tokens": tokens})
    _close(ln, lp.numpy(), 2e-4)
    want = np.asarray(jreg.forward_fn(jcfg)(jp, {"tokens": jnp.asarray(tokens)}))
    err = float(np.abs(lp.numpy() - want).max())
    assert err <= LOGIT_RTOL * float(np.abs(want).max()), err


# ---------------------------------------------------------------------------
# The data stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1234])
@pytest.mark.parametrize("kind", ["bigram", "uniform"])
def test_synthetic_lm_is_bit_identical(kind, seed):
    kw = dict(vocab_size=503, batch=3, seq_len=40, seed=seed, kind=kind)
    mine, theirs = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
    for step in (0, 1, 7):
        a, b = mine.batch_at(step)["tokens"], theirs.batch_at(step)["tokens"]
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b), step
    if kind == "bigram":
        assert np.array_equal(mine.table, theirs.table)
    else:
        assert mine.table is None  # the [V, V] table is never built
    it = mine.iterate(5)
    assert np.array_equal(next(it)["tokens"], theirs.batch_at(5)["tokens"])
    assert SyntheticLM.resume_step(mine.state_dict(9)) == 9


def test_full_vocab_uniform_stream_needs_no_table():
    """The scoring run's stream: vocab 49152, 4 x 2048, uniform."""
    kw = dict(vocab_size=49152, batch=4, seq_len=2048, seed=0, kind="uniform")
    toks = SyntheticLM(DataConfig(**kw)).batch_at(0)["tokens"]
    want = np.random.default_rng((0, 0)).integers(0, 49152, (4, 2048))
    assert np.array_equal(toks, want.astype(np.int32))


# ---------------------------------------------------------------------------
# Flash runs where the reference runs it, and nowhere else
# ---------------------------------------------------------------------------


def test_flash_stays_off_the_serving_path(monkeypatch):
    """A counting stand-in for ``flash_attention`` sees every layer of the
    scoring forward under "pallas", and no call at all from the paged
    scheduler's prefill and decode steps under the same config."""
    from repro_torch.kernels import flash_attn
    from repro_torch.serve import Engine, Scheduler, synthetic_trace

    calls = []
    real = flash_attn.flash_attention

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(flash_attn, "flash_attention", counting)
    cfg = _tcfg(sparse=True, attn_impl="pallas")
    params = params_from_jax(_jparams("smollm-360m", True, 2), device="cpu")
    with torch.no_grad():
        treg.forward_fn(cfg)(params, _batch())
    assert len(calls) == cfg.n_layers
    calls.clear()
    sched = Scheduler(Engine(cfg, params), n_slots=2, paged=True, page_size=4)
    done = sched.run(synthetic_trace(3, seed=2, vocab=503, prompt_lens=(3, 9),
                                     new_tokens=(2, 5)))
    assert len(done) == 3 and sched.stats["decode_steps"] > 0
    assert calls == []
    for impl in ("naive", "chunked"):
        treg.forward_fn(cfg.with_(attn_impl=impl))(params, _batch())
    assert calls == []
