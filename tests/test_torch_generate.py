"""The port's contiguous serving steps and static generation against the JAX
package's, on the CPU, at the smoke size of smollm-360m and qwen2-0.5b
(``qkv_bias``) with every linear compressed (sparsity 0.5, ``min_dim=16``):
``prefill`` (every ``attn_impl``; never the flash kernel), ``prefill_chunk``
with a padded final chunk, ``decode_step`` at a scalar and a per-slot
position (logits within 1e-4 of max|logit|, cache rows within ``F32_TOL``:
the same sums in another order), ``cache_write``'s clamp (bit for bit),
``Engine.generate``'s greedy tokens and ``gen_lens`` (identical), and
temperature sampling (a chi-square test against softmax(logits / T), to
which ``jax.random.categorical`` is held too).  Inputs come from numpy
seeds; params come from JAX through ``params_from_jax``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sstats

from repro import dispatch as jdispatch
from repro.configs import smoke_config as j_smoke_config
from repro.core.pruning import SparsityConfig as JSparsityConfig
from repro.models import attention as jattn
from repro.models import registry as jreg
from repro.serve import Engine as JEngine
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeConfig as JServeConfig
from repro_torch import dispatch
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import SparsityConfig
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.serve import Engine, Scheduler, ServeConfig

SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=16,
              format="compressed_pallas")
LOGIT_RTOL = 1e-4  # of max|logit|
F32_TOL = 1e-5
ARCHS = ("smollm-360m", "qwen2-0.5b")
TEMP = 0.7
N_DRAWS = 20000
P_MIN = 1e-3  # the chi-square test's p-value must exceed this


@pytest.fixture(autouse=True)
def dbs(tmp_path):
    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    jdispatch.set_db(jdispatch.ProfileDB(path=str(tmp_path / "jax.json")))
    yield
    dispatch.set_db(None)
    jdispatch.set_db(None)


def _jcfg(arch="smollm-360m", **kw):
    return j_smoke_config(arch).with_(sparsity=JSparsityConfig(**SPARSE), **kw)


def _tcfg(arch="smollm-360m", **kw):
    return smoke_config(arch).with_(sparsity=SparsityConfig(**SPARSE), **kw)


@functools.lru_cache(maxsize=None)
def _params(arch="smollm-360m"):
    jp, _ = jreg.init_params(_jcfg(arch), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


def _tparams(arch="smollm-360m"):
    return params_from_jax(_params(arch), device="cpu")


def _ints(a):
    return torch.from_numpy(np.asarray(a, np.int32).copy())


def _logits_close(got, want):
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= LOGIT_RTOL * float(np.abs(want).max()), err


def _cache_close(got, want):
    for k in ("k", "v"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=F32_TOL, atol=F32_TOL)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 503, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# The model's contiguous serving steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("attn_impl", ["naive", "chunked", "pallas"])
def test_prefill_matches_jax(arch, attn_impl, monkeypatch):
    """Last-token logits and the prompt's cache rows; under
    ``attn_impl="pallas"`` the flash kernel is never called, as in JAX."""
    kw = dict(attn_impl=attn_impl, attn_chunk=4)
    jcfg, tcfg = _jcfg(arch, **kw), _tcfg(arch, **kw)
    toks = _tokens((2, 11), 0)
    from repro_torch.kernels import flash_attn

    monkeypatch.setattr(flash_attn, "flash_attention",
                        lambda *a, **k: pytest.fail("prefill called flash"))
    jl, jc = jreg.prefill_fn(jcfg)(_params(arch), {"tokens": jnp.asarray(toks)})
    with dispatch.phase_scope("prefill"):
        tl, tc = treg.prefill_fn(tcfg)(_tparams(arch), {"tokens": _ints(toks)})
    assert tuple(tl.shape) == (2, 1, tcfg.padded_vocab)
    assert tuple(tc["k"].shape) == (2, 2, 11, tcfg.n_kv_heads, 16)
    _logits_close(tl, jl)
    _cache_close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_jax(arch):
    """An 11-token prompt in chunks of 4 into a 16-row cache: the final
    chunk is right-padded.  Every chunk's logits (the middle one without
    logits), and the whole cache, pad rows included."""
    jcfg, tcfg = _jcfg(arch), _tcfg(arch)
    toks = _tokens((2, 11), 1)
    jc = jreg.cache_init_fn(jcfg, 2, 16)()
    tc = treg.cache_init_fn(tcfg, 2, 16, "cpu")()
    ptr = tc["k"].data_ptr()
    for start in range(0, 11, 4):
        chunk = toks[:, start:start + 4]
        chunk = np.pad(chunk, ((0, 0), (0, 4 - chunk.shape[1])))
        with_logits = start != 4
        jl, jc = jreg.prefill_chunk_fn(jcfg)(
            _params(arch), jc, jnp.asarray(chunk), jnp.asarray(start, jnp.int32),
            with_logits)
        with dispatch.phase_scope("prefill"):
            tl, tc = treg.prefill_chunk_fn(tcfg)(_tparams(arch), tc,
                                                 _ints(chunk), start, with_logits)
        if with_logits:
            assert tuple(tl.shape) == (2, 4, tcfg.padded_vocab)
            _logits_close(tl, jl)
        else:
            assert tl is None and jl is None
    assert tc["k"].data_ptr() == ptr  # written in place
    _cache_close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step_matches_jax(arch, per_slot):
    """Prefill, then three decode steps at a scalar position, or at a [B]
    vector of mixed lengths (slot 2 parked at the cache's last row, so its
    write clamps)."""
    jcfg, tcfg = _jcfg(arch), _tcfg(arch)
    toks = _tokens((3, 6), 2)
    engine = Engine(tcfg, _tparams(arch))
    jengine = JEngine(jcfg, _params(arch), JServeConfig())
    jl, jc = jengine.prefill_step(toks, 12)
    tl, tc = engine.prefill_step(toks, 12)
    _logits_close(tl, jl)
    _cache_close(tc, jc)
    pos = np.array([6, 3, 11], np.int32) if per_slot else np.int32(6)
    feed = np.array([[5], [77], [400]], np.int32)
    for _ in range(3):
        jl, jc = jreg.decode_fn(jcfg)(_params(arch), jc, jnp.asarray(feed),
                                      jnp.asarray(pos))
        tl, tc = engine.decode_step(tc, feed, pos)
        _logits_close(tl, jl)
        _cache_close(tc, jc)
        feed = np.asarray(jnp.argmax(jl[:, -1, :503], -1), np.int32)[:, None]
        pos = np.minimum(pos + 1, 11).astype(np.int32)


def test_decode_step_scalar_equals_vector_position():
    tcfg = _tcfg()
    engine = Engine(tcfg, _tparams())
    _, cache = engine.prefill_step(_tokens((2, 6), 3), 12)
    feed = np.array([[5], [7]], np.int32)
    c1 = {k: v.clone() for k, v in cache.items()}
    c2 = {k: v.clone() for k, v in cache.items()}
    l1, c1 = engine.decode_step(c1, feed, 6)
    l2, c2 = engine.decode_step(c2, feed, np.full((2,), 6, np.int32))
    assert torch.equal(l1, l2) and torch.equal(c1["k"], c2["k"])


def test_decode_step_moves_nothing_to_the_host(monkeypatch):
    """A contiguous decode step reads no tensor back."""
    tcfg = _tcfg()
    tp = _tparams()
    cache = treg.cache_init_fn(tcfg, 2, 8, "cpu")()
    tokens, pos = _ints([[1], [2]]), _ints([0, 3])
    called = []
    for name in ("item", "tolist", "cpu", "numpy"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _o=orig, _n=name, **k: (
                                called.append(_n), _o(self, *a, **k))[1])
    with dispatch.phase_scope("decode"):
        treg.decode_fn(tcfg)(tp, cache, tokens, pos)
    assert called == []


@pytest.mark.parametrize("pos", ["S", "S-C+1", "neg", "vector"])
def test_cache_write_clamps_like_jax(pos):
    """Starts past S - C clamp back and negative ones to 0, exactly as
    ``dynamic_update_slice`` clamps them: equal to JAX bit for bit, written
    in place, also through a view of one slot's rows."""
    rng = np.random.default_rng(4)
    L, B, S, KV, D = 2, 4, 10, 2, 8
    c_len = 1 if pos == "vector" else 3
    ck = rng.standard_normal((L, B, S, KV, D)).astype(np.float32)
    cv = rng.standard_normal((L, B, S, KV, D)).astype(np.float32)
    kn = rng.standard_normal((L, B, c_len, KV, D)).astype(np.float32)
    vn = rng.standard_normal((L, B, c_len, KV, D)).astype(np.float32)
    p = {"S": np.int32(S), "S-C+1": np.int32(S - c_len + 1),
         "neg": np.int32(-3),
         "vector": np.array([S, S - 1, 0, 4], np.int32)}[pos]
    jk, jv = jattn.cache_write(jnp.asarray(ck), jnp.asarray(cv),
                               jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(p))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ptr = tk.data_ptr()
    gk, gv = tattn.cache_write(tk, tv, torch.from_numpy(kn),
                               torch.from_numpy(vn), p)
    assert gk.data_ptr() == ptr
    assert np.array_equal(gk.numpy(), np.asarray(jk))
    assert np.array_equal(gv.numpy(), np.asarray(jv))
    # one slot's view of a pool: only that slot's rows change
    pool_k = torch.from_numpy(ck.copy())
    pool_v = torch.from_numpy(cv.copy())
    tattn.cache_write(pool_k[:, 1:2], pool_v[:, 1:2], torch.from_numpy(kn[:, :1]),
                      torch.from_numpy(vn[:, :1]), p if p.ndim == 0 else p[1])
    want = ck.copy()
    jk1, _ = jattn.cache_write(jnp.asarray(ck[:, 1:2]), jnp.asarray(cv[:, 1:2]),
                               jnp.asarray(kn[:, :1]), jnp.asarray(vn[:, :1]),
                               jnp.asarray(p if p.ndim == 0 else p[1]))
    want[:, 1:2] = np.asarray(jk1)
    assert np.array_equal(pool_k.numpy(), want)


def test_recurrent_patterns_raise_naming_item_10():
    """The recurrent families are ported (item 10c), but not for what the
    JAX package refuses them too: the chunked prefill, the paged steps and
    the ``Scheduler`` refuse ``xlstm`` and ``mamba_shared_attn`` with JAX's
    messages."""
    for pattern in ("xlstm", "mamba_shared_attn"):
        _refuses_like_jax(pattern)


def _refuses_like_jax(pattern):
    tcfg = _tcfg(block_pattern=pattern)
    jcfg = _jcfg(block_pattern=pattern)
    tp = _tparams()
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
        assert "requires a decoder-only attention family" in str(got.value)
    for step, args in ((tlm.prefill_chunk, (None, _ints([[1]]), 0)),
                       (tlm.paged_decode_step, (None, _ints([[1]]), None,
                                                None, 4)),
                       (tlm.prefill_packed, (None,) * 6 + (4,))):
        with pytest.raises(NotImplementedError,
                           match="supports attention families only"):
            step(tp, tcfg, *args)
    with pytest.raises(ValueError, match="continuous batching requires") as got:
        Scheduler(Engine(tcfg, tp))
    with pytest.raises(ValueError) as want:
        JScheduler(JEngine(jcfg, _params(), JServeConfig()))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(block_pattern="xlstm"),
                                dict(block_pattern="mamba_shared_attn"),
                                dict(n_experts=4), dict(mrope=True)],
                         ids=["xlstm", "zamba", "moe", "mrope"])
def test_unported_families_raise_naming_item_10(kw):
    """Item 10's families are all ported: no case raises any more.  Each
    runs init, the forward, the loss and a decode step (the recurrent ones
    and M-RoPE on their own smoke configs, M-RoPE with 3-D positions whose
    components differ)."""
    tcfg = _tcfg(**kw)
    if "block_pattern" in kw:
        arch = {"xlstm": "xlstm-350m",
                "mamba_shared_attn": "zamba2-7b"}[kw["block_pattern"]]
        tcfg = _tcfg(arch)
    if kw.get("mrope"):
        tcfg = _tcfg("qwen2-vl-72b")
    if tcfg.is_moe:
        tcfg = tcfg.with_(top_k=2)
    tp = treg.init_params(tcfg, 0, device="cpu")
    if tcfg.is_moe:
        assert tuple(tp["layers"]["moe"]["router"].shape) == (2, 64, 4)
    elif tcfg.mrope:
        assert tcfg.mrope_sections == (2, 3, 3) and "unembed" in tp
    else:
        assert "layers" not in tp
    toks = {"tokens": _ints([[1, 2, 3]])}
    if tcfg.mrope:
        toks["mrope_positions"] = _ints([[[0, 1, 1], [0, 1, 2], [0, 2, 1]]])
    logits = treg.forward_fn(tcfg)(tp, toks)
    loss, parts = treg.loss_fn(tcfg)(tp, toks)
    cache = treg.cache_init_fn(tcfg, 1, 8, "cpu")()
    step, _ = treg.decode_fn(tcfg)(tp, cache, _ints([[1]]), 0)
    assert tuple(logits.shape) == (1, 3, tcfg.padded_vocab)
    assert tuple(step.shape) == (1, 1, tcfg.padded_vocab)
    assert (float(parts["aux"]) > 0) == tcfg.is_moe
    assert torch.isfinite(loss)
    assert bool(torch.isfinite(logits).all() & torch.isfinite(step).all())


# ---------------------------------------------------------------------------
# Engine.generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("eos", [False, True])
def test_generate_greedy_equals_jax(arch, eos):
    """Greedy tokens and gen_lens identical to the JAX engine's; with an
    EOS that the free run emits, the tail after it is masked to EOS."""
    prompts = _tokens((3, 7), 5)
    eos_id = None
    if eos:
        free = Engine(_tcfg(arch), _tparams(arch),
                      ServeConfig(max_new_tokens=8)).generate(prompts)
        eos_id = int(free["tokens"][1, 2])
    jres = JEngine(_jcfg(arch), _params(arch),
                   JServeConfig(max_new_tokens=8, eos_id=eos_id)).generate(prompts)
    res = Engine(_tcfg(arch), _tparams(arch),
                 ServeConfig(max_new_tokens=8, eos_id=eos_id)).generate(prompts)
    assert res["tokens"].dtype == np.int32
    assert np.array_equal(res["tokens"], np.asarray(jres["tokens"]))
    assert np.array_equal(res["gen_lens"], jres["gen_lens"])
    assert set(res) == set(jres)
    assert res["prefill_s"] > 0 and res["decode_s"] > 0
    if eos:
        assert res["gen_lens"][1] == 3
        assert (res["tokens"][1, 2:] == eos_id).all()


# ---------------------------------------------------------------------------
# Temperature sampling
# ---------------------------------------------------------------------------


def _row():
    """A fixed logits row over the smoke vocab (503 of 512 padded ids)."""
    row = np.random.default_rng(6).standard_normal(512).astype(np.float32)
    return row * 2.0


def chi_square_p(counts: np.ndarray, probs: np.ndarray) -> float:
    """p-value of observed category counts against probabilities; the
    categories expected fewer than 5 times are merged into one."""
    n = counts.sum()
    exp = probs * n
    small = exp < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(exp[~small], exp[small].sum())
    return float(sstats.chisquare(obs, exp).pvalue)


def softmax_probs(row: np.ndarray, vocab: int, t: float) -> np.ndarray:
    z = row[:vocab].astype(np.float64) / t
    p = np.exp(z - z.max())
    return p / p.sum()


def test_temperature_draws_follow_softmax_and_never_a_padded_id():
    tcfg = _tcfg()
    engine = Engine(tcfg, _tparams(), ServeConfig(temperature=TEMP, seed=3))
    row = _row()
    row[510] = 50.0  # a padded id with the largest logit: never drawn
    logits = torch.from_numpy(np.tile(row, (N_DRAWS, 1, 1)))
    got = engine.sample(logits)
    assert got.dtype == torch.int32 and got.device == logits.device
    assert int(got.max()) < tcfg.vocab_size
    counts = np.bincount(got.numpy(), minlength=512)
    probs = softmax_probs(row, tcfg.vocab_size, TEMP)
    assert chi_square_p(counts[:tcfg.vocab_size], probs) > P_MIN
    # the JAX engine's categorical draws pass the same test
    jengine = JEngine(_jcfg(), _params(), JServeConfig(temperature=TEMP))
    jgot = np.asarray(jengine.sample(jnp.asarray(logits.numpy()),
                                     jax.random.PRNGKey(3)))
    assert int(jgot.max()) < tcfg.vocab_size
    jcounts = np.bincount(jgot, minlength=512)
    assert chi_square_p(jcounts[:tcfg.vocab_size], probs) > P_MIN
    # the test has power: the draws do not fit another temperature
    assert chi_square_p(counts[:tcfg.vocab_size],
                        softmax_probs(row, tcfg.vocab_size, 1.0)) < P_MIN


def test_temperature_generate_is_seeded():
    prompts = _tokens((2, 5), 7)

    def run(seed):
        return Engine(_tcfg(), _tparams(), ServeConfig(
            max_new_tokens=6, temperature=TEMP, seed=seed)).generate(prompts)

    a, b, c = run(1), run(1), run(2)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert (a["tokens"] < 503).all()
    engine = Engine(_tcfg(), _tparams(), ServeConfig(max_new_tokens=6,
                                                     temperature=TEMP, seed=1))
    assert engine.generator.device == engine.device
    assert np.array_equal(engine.generate(prompts)["tokens"],
                          engine.generate(prompts)["tokens"])
