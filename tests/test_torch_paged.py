"""The port's paged attention against the JAX package's, on the CPU: the
plain version against ``paged_attention_ref`` and the Pallas kernel in
interpret mode over the cases of ``tests/test_paged_attn.py`` and serving
shapes; the ``paged_attn`` dispatch family (names, tokens, feasibility,
page-size choice, phase tags); the paged-cache bookkeeping (exact); and the
attention pieces of the serving steps (1e-5).  Inputs come from numpy
seeds; layer params come from JAX through ``params_from_jax``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _paged_cases import CASES, case_id, case_kwargs, problem
from repro import dispatch as jdispatch
from repro.configs import smoke_config as j_smoke_config
from repro.core.pruning import SparsityConfig as JSparsityConfig
from repro.kernels.flash_attn import paged as jpaged
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import registry as jreg
from repro_torch import dispatch
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import SparsityConfig
from repro_torch.kernels import KERNELS, reset_launch_counts
from repro_torch.kernels.flash_attn import paged_attention, paged_attention_ref
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models.blocks import layer_params

SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=16,
              format="compressed_pallas")
F32_TOL = 1e-5
BF16_TOL = 2e-2  # one bf16 rounding of the output, other sum order


@pytest.fixture(autouse=True)
def dbs(tmp_path):
    """Empty profile DBs for both packages' dispatch."""
    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    jdispatch.set_db(jdispatch.ProfileDB(path=str(tmp_path / "jax.json")))
    yield
    dispatch.set_db(None)
    jdispatch.set_db(None)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The kernel's plain version against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_version_matches_jax_ref(case):
    arrays = problem(**case_kwargs(case))
    want = jpaged.paged_attention_ref(*(jnp.asarray(a) for a in arrays))
    got = paged_attention_ref(*(_t(a) for a in arrays))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("case", CASES[:4] + CASES[-1:], ids=case_id)
def test_plain_version_matches_pallas_interpret(case):
    kw = case_kwargs(case)
    arrays = problem(**kw)
    want = jpaged.paged_attention_pallas(
        *(jnp.asarray(a) for a in arrays), page_size=kw["page_size"],
        interpret=True)
    _close(paged_attention_ref(*(_t(a) for a in arrays)), want)


def test_bf16_inputs():
    """bf16 operands: both frameworks' plain versions in bf16 agree to a
    bf16 rounding, and on the same bf16 values upcast to f32 to 1e-5."""
    arrays = problem(b=2, sq=4, lengths=[11, 26], shuffle=True)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) if a.dtype == np.float32
          else jnp.asarray(a) for a in arrays]
    tb = [_t(a).to(torch.bfloat16) if a.dtype == np.float32 else _t(a)
          for a in arrays]
    got = paged_attention_ref(*tb)
    assert got.dtype == torch.bfloat16
    want = jpaged.paged_attention_ref(*jb)
    _close(got.float(), want.astype(jnp.float32), BF16_TOL)
    want32 = jpaged.paged_attention_pallas(
        *(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a for a in jb),
        page_size=8, interpret=True)
    _close(paged_attention_ref(*(t.float() if t.is_floating_point() else t
                                 for t in tb)), want32)


def test_trash_page_junk_and_masked_pages_add_nothing():
    """Whatever the trash page holds (finite), the output does not change;
    a sequence with an empty cache attends to its new keys alone."""
    kw = dict(b=3, sq=4, lengths=[0, 9, 17])
    a = problem(trash_value=1e4, **kw)
    b = problem(trash_value=-7.0, **kw)
    got_a = paged_attention_ref(*(_t(x) for x in a))
    got_b = paged_attention_ref(*(_t(x) for x in b))
    assert torch.equal(got_a, got_b)
    _close(got_a, jpaged.paged_attention_ref(*(jnp.asarray(x) for x in a)))


def test_gqa_head_mapping_when_h_is_not_a_multiple_of_kv():
    """The plain version takes H % KV != 0 through the head-mapped
    expansion, as the JAX reference does (the kernel refuses it)."""
    arrays = problem(b=2, sq=2, h=3, kv=2, lengths=[5, 12])
    want = jpaged.paged_attention_ref(*(jnp.asarray(a) for a in arrays))
    _close(paged_attention_ref(*(_t(a) for a in arrays)), want)


def test_dispatch_entry_runs_the_plain_version_on_the_cpu():
    arrays = [_t(a) for a in problem(b=2, lengths=[13, 7])]
    reset_launch_counts()
    for impl in (None, "paged_attn_ref"):
        got = paged_attention(*arrays, page_size=8, impl=impl)
        assert torch.equal(got, paged_attention_ref(*arrays))
    with pytest.raises(KeyError, match="not a registered"):
        paged_attention(*arrays, page_size=8, impl="no_such_impl")
    assert all(k.launches == 0 for k in KERNELS)


def test_kernel_wrapper_takes_no_cpu_or_device_fallback():
    """A tensor on no CPU goes to the kernel's launcher, which takes CUDA
    tensors alone (a ``meta`` tensor stands in for a card's)."""
    from repro_torch.kernels.flash_attn import paged_attention_cuda

    meta = [_t(a).to("meta") for a in problem()]
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_attention(*meta, page_size=8, impl="paged_attn_pallas@ps8_bq8")
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_attention_cuda(*(_t(a) for a in problem()), page_size=8)


# ---------------------------------------------------------------------------
# The paged_attn dispatch family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args,kw", [
    ((8, 4, 2, 16, 64), dict(page_size=8)),
    ((4, 15, 5, 64, 160), dict(page_size=16, phase="decode")),
    ((257, 15, 5, 64, 1000), dict(dtype="bfloat16")),
    ((1, 4, 2, 16, 1), dict(page_size=32, phase="prefill")),
])
def test_paged_attn_tokens_match_jax(args, kw):
    tkw = dict(kw)
    if "dtype" in tkw:
        tkw["dtype"] = getattr(torch, tkw["dtype"])
    assert (dispatch.paged_attn_key(*args, **tkw).token
            == jdispatch.paged_attn_key(*args, **kw).token)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_phase_tagged_tokens_match_jax(phase):
    for args in [(4, 960, 2560, 480, 2560), (300, 2560, 960, 1280, 960)]:
        assert (dispatch.linear_key(*args, phase=phase).token
                == jdispatch.linear_key(*args, phase=phase).token)
    conv = (16, 16, 16, 16, 3, 3, 2, 1, 72, 8)
    assert (dispatch.conv_key(*conv, batch=4, phase=phase).token
            == jdispatch.conv_key(*conv, batch=4, phase=phase).token)
    with dispatch.phase_scope(phase), jdispatch.phase_scope(phase):
        assert dispatch.current_phase() == jdispatch.current_phase() == phase
        with dispatch.phase_scope(None):
            assert dispatch.current_phase() == ""
    assert dispatch.current_phase() == ""


def test_geometry_grid_and_feasibility_match_jax():
    assert dispatch.PAGED_ATTN_GEOMETRY == jdispatch.PAGED_ATTN_GEOMETRY
    assert dispatch.DEFAULT_PAGE_SIZE == jdispatch.DEFAULT_PAGE_SIZE
    for key_args in [(8, 4, 2, 16, 64, 8), (8, 4, 2, 16, 64, 0),
                     (4, 15, 5, 64, 160, 16), (8, 3, 2, 16, 64, 8)]:
        mine = dispatch.paged_attn_key(*key_args[:5], page_size=key_args[5])
        theirs = jdispatch.paged_attn_key(*key_args[:5], page_size=key_args[5])
        feas = {s.name for s in dispatch.REGISTRY.candidates("paged_attn")
                if s.feasible(mine)[0]}
        jfeas = {s.name for s in jdispatch.REGISTRY.candidates("paged_attn")
                 if s.feasible(theirs)[0]}
        assert feas == jfeas, key_args


def test_card_resolution_of_the_paged_family():
    """On a CUDA device only kernel geometries resolve: the default one for
    page size 16, the pinned variant for 8 and 32, none for 4."""
    from repro_torch.dispatch import TuningError
    from repro_torch.dispatch.dispatch import _resolve

    db = dispatch.get_db()
    for ps, name in ((16, "paged_attn_pallas"), (8, "paged_attn_pallas@ps8_bq8"),
                     (32, "paged_attn_pallas@ps32_bq8"),
                     (0, "paged_attn_pallas")):
        key = dispatch.paged_attn_key(4, 15, 5, 64, 160, page_size=ps)
        spec, source = _resolve(key, frozenset(), None, db, "cuda")
        assert (spec.name, source) == (name, "heuristic")
    with pytest.raises(TuningError):
        _resolve(dispatch.paged_attn_key(4, 15, 5, 64, 160, page_size=4),
                 frozenset(), None, db, "cuda")
    # a DB entry naming the plain version is not taken on the card
    key = dispatch.paged_attn_key(4, 15, 5, 64, 160, page_size=16)
    db.put(key.token, {"impl": "paged_attn_ref", "wall_us": 1.0})
    assert _resolve(key, frozenset(), None, db, "cuda")[0].backend == "cuda"
    assert _resolve(key, frozenset(), None, db, "cpu")[0].name == "paged_attn_ref"


def test_choose_page_size_and_cpu_profile():
    assert dispatch.choose_page_size(4, 2, 16, 64, q_rows=8,
                                     device="cpu") == dispatch.DEFAULT_PAGE_SIZE
    # a CPU profile races every candidate (the kernels' names run their
    # plain version on CPU tensors) and picks a registered page size
    ps = dispatch.choose_page_size(4, 2, 16, 64, q_rows=8, device="cpu",
                                   profile=True)
    assert ps in {dict(g)["ps"] for g in dispatch.PAGED_ATTN_GEOMETRY}
    key = dispatch.paged_attn_key(8, 4, 2, 16, 64, page_size=0, phase="decode")
    assert set(dispatch.get_db().get(key.token)["all"]) == {
        s.name for s in dispatch.REGISTRY.candidates("paged_attn")}


def test_force_scope_is_read_by_every_call_site():
    from repro_torch.core.sparse_linear import linear_apply

    layer = {"values": torch.zeros((1, 8, 16)),
             "idx": torch.zeros((1, 8), dtype=torch.int32)}
    with dispatch.force_scope(linear="dense"):
        with pytest.raises(KeyError, match="requires"):
            linear_apply(layer, torch.zeros((2, 16)))
        assert dispatch.forced_impl("linear", "masked") == "masked"
        assert dispatch.forced_impl("paged_attn", None) is None
    assert dispatch.forced_impl("linear", None) is None
    linear_apply(layer, torch.zeros((2, 16)))


# ---------------------------------------------------------------------------
# Paged-cache bookkeeping (exact) and the attention pieces (1e-5)
# ---------------------------------------------------------------------------


def test_page_rows_and_cache_write_equal_jax():
    rng = np.random.default_rng(0)
    tables = rng.permutation(12).reshape(3, 4).astype(np.int32)
    tables[2, 2:] = 12  # the trash page
    seq = np.array([0, 0, 1, 2, 1, 0], np.int32)
    pos = np.array([0, 5, 9, 3, 15, 12], np.int32)
    want = np.asarray(jattn.page_rows(jnp.asarray(tables), jnp.asarray(seq),
                                      jnp.asarray(pos), 4))
    got = tattn.page_rows(_t(tables), _t(seq), _t(pos), 4)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    shape = (2, 13, 4, 2, 8)
    ck, cv = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    kn, vn = (rng.standard_normal((2, 6, 2, 8), dtype=np.float32)
              for _ in range(2))
    jk, jv = jattn.paged_cache_write(jnp.asarray(ck), jnp.asarray(cv),
                                     jnp.asarray(kn), jnp.asarray(vn),
                                     jnp.asarray(want))
    tk, tv = _t(ck.copy()), _t(cv.copy())
    rk, rv = tattn.paged_cache_write(tk, tv, _t(kn), _t(vn), got)
    assert rk is tk and rv is tv  # written in place
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_paged_cache_init_equals_jax():
    cfg = smoke_config("smollm-360m")
    jc = jattn.paged_cache_init(j_smoke_config("smollm-360m"), 5, 4, 2,
                                jnp.float32)
    tc = tattn.paged_cache_init(cfg, 5, 4, 2, torch.float32, device="cpu")
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == jc[k].shape and not tc[k].any()


@functools.lru_cache(maxsize=None)
def _params():
    """Smoke smollm-360m params (sparsity 0.5, min_dim 16) from JAX, and
    their port twins."""
    cfg = j_smoke_config("smollm-360m").with_(sparsity=JSparsityConfig(**SPARSE))
    jp, _ = jreg.init_params(cfg, jax.random.PRNGKey(1))
    jp = jax.tree_util.tree_map(np.asarray, jp)
    return cfg, jp, params_from_jax(jp, device="cpu")


def _tcfg():
    return smoke_config("smollm-360m").with_(sparsity=SparsityConfig(**SPARSE))


def _layer(l=1):
    _, jp, tp = _params()
    return (jax.tree_util.tree_map(lambda a: a[l], jp["layers"]),
            layer_params(tp["layers"], l))


def test_rope_and_rmsnorm_match_jax():
    rng = np.random.default_rng(2)
    assert np.array_equal(tcommon.rope_freqs(16, 1e4),
                          jcommon.rope_freqs(16, 1e4))
    pos = rng.integers(0, 300, (3, 7)).astype(np.int32)
    jc, js = jcommon.rope_cos_sin(jnp.asarray(pos), 64, 1e4)
    tc, ts = tcommon.rope_cos_sin(_t(pos), 64, 1e4)
    _close(tc, jc)
    _close(ts, js)
    x = rng.standard_normal((3, 7, 5, 64), dtype=np.float32)
    _close(tcommon.apply_rope(_t(x), tc, ts),
           jcommon.apply_rope(jnp.asarray(x), jc, js))
    scale = rng.standard_normal((64,), dtype=np.float32)
    x2 = rng.standard_normal((3, 7, 64), dtype=np.float32) * 3
    _close(tcommon.norm_apply({"scale": _t(scale)}, _t(x2)),
           jcommon.norm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x2),
                              "rmsnorm"))
    table = rng.standard_normal((11, 4), dtype=np.float32)
    ids = np.array([[3, 0, 10]], np.int32)
    assert np.array_equal(tcommon.embed_lookup(_t(table), _t(ids)).numpy(),
                          np.asarray(jcommon.embed_lookup(jnp.asarray(table),
                                                          jnp.asarray(ids))))


def test_mlp_and_qkv_match_jax():
    from repro.models import mlp as jmlp
    from repro_torch.models import mlp as tmlp

    jcfg, _, _ = _params()
    jl, tl = _layer()
    x = np.random.default_rng(3).standard_normal((2, 5, 64), dtype=np.float32)
    _close(tmlp.mlp_apply(tl["mlp"], _tcfg(), _t(x)),
           jmlp.mlp_apply(jl["mlp"], jcfg, jnp.asarray(x)))
    pos = np.tile(np.arange(5, dtype=np.int32) + 3, (2, 1))
    want = jattn._qkv(jl["attn"], jcfg, jnp.asarray(x), jnp.asarray(pos), None)
    got = tattn._qkv(tl["attn"], _tcfg(), _t(x), _t(pos))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal,c_len", [(True, 1), (True, 4), (False, 3)])
@pytest.mark.parametrize("h,kv", [(4, 2), (3, 2)])
def test_cached_attention_matches_jax(causal, c_len, h, kv):
    rng = np.random.default_rng(c_len + h)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    q, kn, vn = f(2, c_len, h, 8), f(2, c_len, kv, 8), f(2, c_len, kv, 8)
    kc, vc = f(2, 10, kv, 8), f(2, 10, kv, 8)
    limit = np.array([0, 7], np.int32)
    want = jattn._cached_attention(*(jnp.asarray(a) for a in (q, kn, vn, kc, vc)),
                                   limit=jnp.asarray(limit), causal=causal)
    got = tattn._cached_attention(*(_t(a) for a in (q, kn, vn, kc, vc)),
                                  limit=_t(limit), causal=causal)
    _close(got, want)


@pytest.mark.parametrize("h,kv", [(4, 2), (3, 2)])
def test_packed_sdpa_matches_jax(h, kv):
    rng = np.random.default_rng(h)
    seq = np.array([0, 0, 0, 2, 2, 1, 1, 1, 1], np.int32)
    q = rng.standard_normal((1, 9, h, 8), dtype=np.float32)
    k, v = (rng.standard_normal((1, 9, kv, 8), dtype=np.float32)
            for _ in range(2))
    want = jattn.packed_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             seq_ids=jnp.asarray(seq))
    _close(tattn.packed_sdpa(_t(q), _t(k), _t(v), seq_ids=_t(seq)), want)


def test_attention_steps_match_jax():
    """attn_prefill_packed, then paged_attn_decode on the cache the prefill
    wrote, against JAX on the same layer params."""
    jcfg, _, _ = _params()
    jl, tl = _layer(0)
    rng = np.random.default_rng(5)
    seq = np.array([0, 0, 0, 1, 1], np.int32)
    pos = np.array([0, 1, 2, 0, 1], np.int32)
    x = rng.standard_normal((1, 5, 64), dtype=np.float32)
    jo, (jk, jv) = jattn.attn_prefill_packed(
        jl["attn"], jcfg, jnp.asarray(x), seq_ids=jnp.asarray(seq),
        positions=jnp.asarray(pos))
    to, (tk, tv) = tattn.attn_prefill_packed(
        tl["attn"], _tcfg(), _t(x), seq_ids=_t(seq), positions=_t(pos))
    for g, w in ((to, jo), (tk, jk), (tv, jv)):
        _close(g, w)
    tables = np.array([[0, 1], [2, 4]], np.int32)  # page 4 is the trash page
    rows = np.asarray(jattn.page_rows(jnp.asarray(tables), jnp.asarray(seq),
                                      jnp.asarray(pos), 4))
    cache = jattn.paged_cache_init(jcfg, 4, 4, 1, jnp.float32)
    ck, cv = jattn.paged_cache_write(cache["k"], cache["v"], jk[None, 0],
                                     jv[None, 0], jnp.asarray(rows))
    xd = rng.standard_normal((2, 1, 64), dtype=np.float32)
    lens = np.array([3, 2], np.int32)
    jo2, (jk2, _) = jattn.paged_attn_decode(
        jl["attn"], jcfg, jnp.asarray(xd), (ck[0], cv[0]),
        pos=jnp.asarray(lens), tables=jnp.asarray(tables), page_size=4)
    to2, (tk2, _) = tattn.paged_attn_decode(
        tl["attn"], _tcfg(), _t(xd), (_t(np.asarray(ck[0])),
                                      _t(np.asarray(cv[0]))),
        pos=_t(lens), tables=_t(tables), page_size=4)
    _close(to2, jo2)
    _close(tk2, jk2)
