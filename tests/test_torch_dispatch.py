"""The port's dispatch layer against the JAX package's: the same candidate
names, tokens and planned token sets; the registry, profile DB and selection
cases of the JAX dispatch tests that do not read environment switches; the
shared-memory feasibility of the conv ladder; and resnet-tiny and compressed
linear layers under every candidate, held against the JAX package on the same
numpy inputs (1e-4).  On the CPU nothing here launches a kernel."""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.configs import get_vision_config as j_get_config
from repro.core import linear_apply as j_linear_apply
from repro.core import linear_init as j_linear_init
from repro.core import SparsityConfig as JSparsityConfig
from repro.core.sparse_linear import unbox_tree
from repro.models import vision as jv
from repro_torch import dispatch
from repro_torch.configs import get_vision_config
from repro_torch.convert import params_from_jax
from repro_torch.core.sparse_linear import linear_apply
from repro_torch.dispatch import REGISTRY, OpKey, ProfileDB, SCHEMA_VERSION
from repro_torch.dispatch.dispatch import _heuristic
from repro_torch.kernels import KERNELS, reset_launch_counts
from repro_torch.kernels.colwise_nm import pipelined_smem_bytes
from repro_torch.kernels.conv_gemm import band_plan, banded_smem_bytes
from repro_torch.models import vision as tv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPARSE = ("values", "idx")
CPU = dict(device="cpu")


@pytest.fixture
def db(tmp_path):
    d = ProfileDB(path=tmp_path / "profile.json")
    dispatch.set_db(d)
    yield d
    dispatch.set_db(None)


@pytest.fixture
def jdb(tmp_path):
    d = jdispatch.ProfileDB(path=str(tmp_path / "jax_profile.json"))
    jdispatch.set_db(d)
    yield d
    jdispatch.set_db(None)


def _small_key():
    return dispatch.linear_key(batch=8, d_in=64, d_out=64, k_kept=32, tile=16)


@functools.lru_cache(maxsize=None)
def _jax_params(cfg, seed):
    init = jax.jit(lambda key: unbox_tree(jv.vision_init(cfg, key))[0])
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# The same names, tokens and plans as the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["linear", "conv"])
def test_candidates_match_the_jax_registry(op):
    mine = {s.name: s for s in REGISTRY.candidates(op)}
    theirs = {s.name: s for s in jdispatch.REGISTRY.candidates(op)}
    assert sorted(mine) == sorted(theirs)
    for name, spec in mine.items():
        ref = theirs[name]
        assert spec.requires == ref.requires, name
        assert spec.priority == ref.priority, name
        assert spec.geometry == ref.geometry, name
        assert spec.backend == {"pallas": "cuda", "xla": "torch"}[ref.backend]
        assert (spec.apply is None) == (ref.apply is None), name
    assert REGISTRY.ops() == sorted(set(jdispatch.REGISTRY.ops()) - {"paged_attn"})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 257])
def test_tokens_are_string_equal(dtype, rows):
    tdtype = getattr(torch, dtype)
    for args in [(8, 64, 64, 32, 16), (rows, 960, 2560, 480, 2560),
                 (rows, 2560, 960, 1280, 960), (1, 5, 7, 3, 7)]:
        assert (dispatch.linear_key(*args, dtype=tdtype).token ==
                jdispatch.linear_key(*args, dtype=dtype).token)
    assert (dispatch.linear_key_from((2, rows, 96), (3, 48, 32), tdtype).token
            == jdispatch.linear_key_from((2, rows, 96), (3, 48, 32),
                                         dtype).token)
    for args, kw in [((16, 16, 16, 16, 3, 3, 2, 1, 72, 8), dict(batch=rows)),
                     ((8, 10, 7, 16, 1, 1, 1, 0, 4, 8), dict(v=256, batch=3)),
                     ((3, 7, 7, 8, 3, 3, 1, 1, 14, 8), {})]:
        assert (dispatch.conv_key(*args, dtype=tdtype, **kw).token
                == jdispatch.conv_key(*args, dtype=dtype, **kw).token)


def test_plan_params_tokens_match_jax(db, jdb):
    jcfg, tcfg = j_get_config("resnet-tiny"), get_vision_config("resnet-tiny")
    jp = _jax_params(jcfg, 3)
    want = jdispatch.plan_params(jp, conv_hints=jv.conv_hints(jcfg, batch=2))
    got = dispatch.plan_params(params_from_jax(jp, **CPU),
                               conv_hints=tv.conv_hints(tcfg, batch=2))
    assert sorted(got) == sorted(want) and len(got) == 5
    # on the CPU both heuristics pick the plain-framework rung
    assert set(got.values()) == set(want.values()) == {"im2col_sparse_xla"}
    assert tv.conv_hints(tcfg, batch=2) == jv.conv_hints(jcfg, batch=2)


# ---------------------------------------------------------------------------
# Registry and feasibility (the JAX dispatch tests' registry cases)
# ---------------------------------------------------------------------------


class TestRegistry:
    def test_geometry_variants_registered(self):
        linear = {s.name for s in REGISTRY.candidates("linear")}
        assert "compressed_pallas" in linear
        assert any(n.startswith("compressed_pallas@") for n in linear)
        conv = {s.name for s in REGISTRY.candidates("conv")}
        for family in ("fused_sparse_pallas", "fused_banded_pallas",
                       "two_kernel_pipelined"):
            assert family in conv
            assert any(n.startswith(family + "@") for n in conv)
        for s in REGISTRY.candidates("linear"):
            if s.name.startswith("compressed_pallas"):
                assert s.geom("bb") > 0 and s.geom("bk") > 0

    def test_param_keys_filter(self):
        names = {s.name for s in REGISTRY.candidates("linear", param_keys=SPARSE)}
        assert {n.split("@")[0] for n in names} == {
            "compressed_xla", "compressed_pallas"}

    def test_masked_layer_never_resolves_dense(self):
        names = {s.name for s in
                 REGISTRY.candidates("linear", param_keys=("w", "mask"))}
        assert names == {"masked"}
        names = {s.name for s in REGISTRY.candidates("linear", param_keys=("w",))}
        assert names == {"dense"}

    def test_divisibility_infeasibility(self):
        odd = OpKey(op="linear", batch=8, d_in=64, d_out=60, k_kept=30, tile=7)
        ok, reason = REGISTRY.get("linear", "compressed_pallas").feasible(odd)
        assert not ok and "tile" in reason

    def test_infeasible_key_still_dispatches(self, db):
        odd = OpKey(op="linear", batch=8, d_in=64, d_out=60, k_kept=30, tile=7)
        spec, source = dispatch.resolve(odd, param_keys=SPARSE, **CPU)
        assert (spec.name, source) == ("compressed_xla", "heuristic")
        conv = dispatch.conv_key(8, 10, 10, 14, 3, 3, 1, 1, 36, 7)
        spec, source = dispatch.resolve(conv, param_keys=SPARSE, **CPU)
        assert (spec.name, source) == ("im2col_sparse_xla", "heuristic")

    @pytest.mark.parametrize("tile", [12, 3, 2560])
    def test_kernels_take_any_tile_that_covers_d_out(self, tile):
        key = dispatch.linear_key(256, 960, 2560 // tile * tile, 480, tile)
        for spec in REGISTRY.candidates("linear", param_keys=SPARSE):
            assert spec.feasible(key)[0], (spec.name, spec.feasible(key)[1])
        conv = dispatch.conv_key(8, 10, 10, 2 * tile, 3, 3, 1, 1, 36, tile,
                                 batch=2)
        ok, reason = REGISTRY.get("conv", "fused_sparse_pallas").feasible(conv)
        # the fused conv stages a [block_k, T] chunk of values: a T that wide
        # is refused for its shared memory, never for its width
        assert ok if tile < 64 else "shared memory" in reason

    def test_the_card_keeps_only_the_kernels_where_there_are_any(self):
        sparse = REGISTRY.candidates("conv", param_keys=SPARSE,
                                     device_type="cuda")
        assert len(sparse) == 12 and {s.backend for s in sparse} == {"cuda"}
        assert {s.backend for s in REGISTRY.candidates(
            "linear", param_keys=SPARSE, device_type="cuda")} == {"cuda"}
        # a dense layer has no kernel: its plain rung stays
        assert [s.name for s in REGISTRY.candidates(
            "linear", param_keys=("w",), device_type="cuda")] == ["dense"]
        assert len(REGISTRY.candidates("conv", param_keys=SPARSE,
                                       device_type="cpu")) == 13


class TestSharedMemoryFeasibility:
    """The predicates read the launch's shared memory from the kernels' own
    size functions, against a Hopper block's 227 KB."""

    @staticmethod
    def _stride2_conv1(dtype):
        # resnet-tiny blocks[1]/conv1 at batch 256
        return dispatch.conv_key(16, 16, 16, 16, 3, 3, 2, 1, 72, 8,
                                 dtype=dtype, batch=256)

    @pytest.mark.parametrize("name", ["fused_banded_pallas@v256_bk128_hb2",
                                      "fused_banded_pallas@v128_bk128_hb4"])
    def test_banded_double_buffer_needs_bf16_on_the_stride2_conv(self, name):
        spec = REGISTRY.get("conv", name)
        f32, bf16 = self._stride2_conv1("float32"), self._stride2_conv1("bfloat16")
        assert not spec.feasible(f32)[0] and spec.feasible(bf16)[0]
        assert "shared memory" in spec.feasible(f32)[1]
        _, rows = band_plan(b=256, h=16, kh=3, stride=2, pad=1, ho=8, wo=8,
                            v=spec.geom("v"), hb=spec.geom("hb"))
        two_bands = 2 * 16 * rows * 16 * 4
        assert two_bands == 258 * 1024  # 258 KB of f32 windows
        assert spec.smem_bytes(f32) == banded_smem_bytes(16, 16, rows, 72, 4)
        assert spec.smem_bytes(f32) > two_bands
        assert REGISTRY.get("conv", "fused_banded_pallas").feasible(f32)[0]

    def test_pipelined_ring_of_wide_slices_needs_bf16(self):
        # two [128, 256] f32 slices of gathered rows are 256 KB; at resnet-
        # tiny's 72 kept rows the slices are shorter and fit
        spec = REGISTRY.get("conv", "two_kernel_pipelined@v256_bk128_hb2")
        assert spec.feasible(self._stride2_conv1("float32"))[0]
        wide = [dispatch.conv_key(32, 16, 16, 16, 3, 3, 1, 1, 144, 8,
                                  dtype=d, batch=256)
                for d in ("float32", "bfloat16")]
        assert not spec.feasible(wide[0])[0] and spec.feasible(wide[1])[0]
        assert spec.smem_bytes(wide[0]) == pipelined_smem_bytes(256, 128, 4)

    def test_main_path_convs_all_feasible_and_fused_first_on_the_card(self):
        cfg = get_vision_config("resnet-tiny")
        params = tv.vision_init(cfg, 0, **CPU)
        keys = []
        for path, op, info in dispatch.iter_op_layers(params):
            assert op == "conv"
            hint = dispatch.dispatch._match_conv_hint(
                tv.conv_hints(cfg, batch=256), path)
            n_tiles, k_kept, tile = info["values"].shape
            keys.append(dispatch.conv_key(
                info["c_in"], hint["h"], hint["w"], n_tiles * tile, info["kh"],
                info["kw"], hint["stride"], hint["pad"], k_kept, tile,
                batch=256))
        assert len(keys) == 5
        for key in keys:
            feas = REGISTRY.feasible(key, param_keys=SPARSE)
            assert len(feas) >= 11, key.token
            assert _heuristic(feas, key, "cuda").name == "fused_sparse_pallas"
            assert _heuristic(feas, key, "cpu").name == "im2col_sparse_xla"

    def test_linear_footprint_does_not_grow_with_the_tile(self):
        spec = REGISTRY.get("linear", "compressed_pallas")
        wide = dispatch.linear_key(256, 960, 2560, 480, 2560)
        narrow = dispatch.linear_key(256, 960, 2560, 480, 8)
        assert spec.feasible(wide)[0] and spec.feasible(narrow)[0]
        assert spec.smem_bytes(wide) == spec.smem_bytes(
            dispatch.linear_key(256, 960, 128, 480, 128))
        feas = REGISTRY.feasible(wide, param_keys=SPARSE)
        assert _heuristic(feas, wide, "cuda").name == "compressed_pallas"
        assert _heuristic(feas, wide, "cpu").name == "compressed_xla"


# ---------------------------------------------------------------------------
# Profile DB persistence (the JAX dispatch tests' DB cases)
# ---------------------------------------------------------------------------


class TestProfileDB:
    def test_roundtrip(self, tmp_path):
        p = tmp_path / "db.json"
        ProfileDB(path=p).put("k1", {"impl": "compressed_xla", "wall_us": 1.0})
        d2 = ProfileDB(path=p)
        assert d2.get("k1") == {"impl": "compressed_xla", "wall_us": 1.0}
        assert not d2.invalidated

    def test_atomic_write_leaves_no_temp(self, tmp_path):
        p = tmp_path / "db.json"
        d = ProfileDB(path=p)
        for i in range(5):
            d.put(f"k{i}", {"impl": "x", "wall_us": float(i)})
        assert [f.name for f in tmp_path.iterdir()] == ["db.json"]
        json.loads(p.read_text())

    @pytest.mark.parametrize("field,value", [
        ("version", SCHEMA_VERSION - 1), ("device", "not-a-real-card"),
        ("torch", "0.0")])
    def test_mismatch_invalidates(self, tmp_path, field, value):
        p = tmp_path / "db.json"
        ProfileDB(path=p).put("k1", {"impl": "x"})
        data = json.loads(p.read_text())
        if field == "version":
            data["version"] = value
        else:
            data["fingerprint"][field] = value
        p.write_text(json.dumps(data))
        d2 = ProfileDB(path=p)
        assert d2.invalidated and len(d2) == 0

    def test_bare_dict_invalidated(self, tmp_path):
        p = tmp_path / "tuning_cache.json"
        p.write_text(json.dumps({"b64_i256_o256_s50": {"tile": 64}}))
        d = ProfileDB(path=p)
        assert d.invalidated and len(d) == 0

    def test_lru_caps_entries(self, tmp_path, monkeypatch):
        monkeypatch.setattr(ProfileDB, "MAX_ENTRIES", 3)
        d = ProfileDB(path=tmp_path / "db.json")
        for i in range(6):
            d.put(f"k{i}", {"impl": "x"})
        assert len(d) == 3 and d.get("k5") is not None and d.get("k0") is None
        assert len(ProfileDB(path=tmp_path / "db.json")) == 3

    def test_default_path_is_in_the_gitignored_build_tree(self):
        path = dispatch.DEFAULT_DB_PATH.relative_to(REPO)
        assert path.parts[:2] == ("build", "repro_torch")


# ---------------------------------------------------------------------------
# Selection: frozen DB, force, memo invalidation
# ---------------------------------------------------------------------------


class TestSelection:
    def test_frozen_db_overrides_heuristic(self, db):
        key = _small_key()
        db.put(key.token, {"impl": "compressed_pallas", "wall_us": 1.0})
        spec, source = dispatch.resolve(key, param_keys=SPARSE, **CPU)
        assert (spec.name, source) == ("compressed_pallas", "db")
        names = {dispatch.best_impl(key, param_keys=SPARSE, **CPU).name
                 for _ in range(10)}
        assert names == {"compressed_pallas"}

    def test_profile_then_select_consistent(self, db):
        key = _small_key()
        rec = dispatch.profile_op(key, db, param_keys=SPARSE, iters=2, **CPU)
        assert rec["impl"] in rec["all"] and len(rec["all"]) == 4
        assert dispatch.best_impl(key, param_keys=SPARSE, **CPU).name == rec["impl"]
        assert dispatch.ensure_profiled(key, db=db, **CPU) is db.get(key.token)

    def test_force(self, db):
        key = _small_key()
        spec, source = dispatch.resolve(key, param_keys=SPARSE,
                                        force="compressed_pallas@bb256_bk128",
                                        **CPU)
        assert (spec.name, source) == ("compressed_pallas@bb256_bk128", "forced")
        with pytest.raises(KeyError, match="not a registered"):
            dispatch.best_impl(key, force="no_such_impl", **CPU)
        with pytest.raises(KeyError, match="requires"):
            dispatch.best_impl(key, param_keys=SPARSE, force="dense", **CPU)

    def test_new_registration_invalidates_memo(self, db):
        key = _small_key()
        assert dispatch.best_impl(key, param_keys=SPARSE, **CPU).name == "compressed_xla"
        spec = REGISTRY.get("linear", "compressed_xla")
        try:
            REGISTRY.register(dataclasses.replace(spec, name="compressed_xla2",
                                                  priority=1))
            assert dispatch.best_impl(
                key, param_keys=SPARSE, **CPU).name == "compressed_xla2"
        finally:
            del REGISTRY._impls["linear"]["compressed_xla2"]
            REGISTRY.generation += 1

    @staticmethod
    def _on_card(key, db, force=None):
        """The card's resolution, read without a card: the same lookup with
        the device type a CUDA tensor gives."""
        return dispatch.dispatch._resolve(key, frozenset(SPARSE), force, db,
                                          "cuda")

    def test_the_card_runs_a_kernel_unless_forced(self, db):
        # tile 12 is not a multiple of the kernels' 8-row register block
        key = dispatch.linear_key(256, 960, 2560 // 12 * 12, 480, 12)
        assert [(s.name, src) for s, src in [self._on_card(key, db)]] == [
            ("compressed_pallas", "heuristic")]
        # a DB entry naming the plain rung does not move the card off the
        # kernel; the CPU takes it
        db.put(key.token, {"impl": "compressed_xla", "wall_us": 1.0})
        assert self._on_card(key, db)[0].name == "compressed_pallas"
        assert dispatch.resolve(key, param_keys=SPARSE, **CPU) == (
            REGISTRY.get("linear", "compressed_xla"), "db")
        # the card runs the plain rung only when the call site forces it
        assert self._on_card(key, db, force="compressed_xla") == (
            REGISTRY.get("linear", "compressed_xla"), "forced")
        conv = dispatch.conv_key(8, 10, 10, 24, 3, 3, 1, 1, 36, 12, batch=2)
        db.put(conv.token, {"impl": "im2col_sparse_xla", "wall_us": 1.0})
        assert self._on_card(conv, db) == (
            REGISTRY.get("conv", "fused_sparse_pallas"), "heuristic")

    def test_the_card_raises_where_no_kernel_is_feasible(self, db):
        odd = OpKey(op="linear", batch=8, d_in=64, d_out=60, k_kept=30, tile=7)
        with pytest.raises(dispatch.TuningError, match="d_out=60"):
            self._on_card(odd, db)
        assert self._on_card(odd, db, force="compressed_xla")[1] == "forced"

    def test_site_memo_follows_the_db(self, db):
        jparams, x = _linear_problem()
        tparams = params_from_jax(jparams, **CPU)
        xt = torch.from_numpy(x)
        site = ("linear", xt.shape, tparams["values"].shape, xt.dtype,
                xt.device)
        key = dispatch.linear_key_from(x.shape, tparams["values"].shape)
        calls = []

        def make_key():
            calls.append(1)
            return key

        def lookup():
            return dispatch.site_impl(site, make_key, param_keys=SPARSE,
                                      force=None, device=xt.device).name

        assert lookup() == lookup() == "compressed_xla" and len(calls) == 1
        db.put(key.token, {"impl": "compressed_pallas@bb128_bk64"})
        assert lookup() == "compressed_pallas@bb128_bk64" and len(calls) == 2

    def test_lookups_default_to_the_card(self, db):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default rightly uses it")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dispatch.best_impl(_small_key(), param_keys=SPARSE)

    def test_cross_process_determinism(self, db):
        """A frozen profile DB gives the same selection in fresh processes."""
        key = _small_key()
        db.put(key.token, {"impl": "compressed_pallas", "wall_us": 1.0})
        snippet = (
            "from repro_torch import dispatch\n"
            f"db = dispatch.ProfileDB(path={str(db.path)!r})\n"
            "key = dispatch.linear_key(batch=8, d_in=64, d_out=64, k_kept=32, tile=16)\n"
            "print(dispatch.best_impl(key, param_keys=('values', 'idx'), db=db, "
            "device='cpu').name)\n")
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
        outs = []
        for _ in range(2):
            r = subprocess.run([sys.executable, "-c", snippet], env=env,
                               capture_output=True, text=True, timeout=300)
            assert r.returncode == 0, r.stderr
            outs.append(r.stdout.strip())
        assert outs == ["compressed_pallas", "compressed_pallas"]


# ---------------------------------------------------------------------------
# Every candidate against the JAX package
# ---------------------------------------------------------------------------


def _linear_problem(d_in=64, d_out=96, batch=4, tile=None, seed=0):
    cfg = dict(sparsity=0.5, m=None, tile=tile, min_dim=8,
               format="compressed_pallas")
    jparams = jax.tree_util.tree_map(np.asarray, unbox_tree(
        j_linear_init(jax.random.PRNGKey(seed), d_in, d_out,
                      JSparsityConfig(**cfg)))[0])
    x = np.random.default_rng(seed).standard_normal((batch, d_in)).astype(np.float32)
    return jparams, x


class TestLinearEquivalence:
    @pytest.mark.parametrize("tile", [None, 8])
    def test_every_candidate_matches_jax(self, db, jdb, tile):
        jparams, x = _linear_problem(tile=tile)
        want = np.asarray(j_linear_apply(jparams, jax.numpy.asarray(x)))
        tparams = params_from_jax(jparams, **CPU)
        xt = torch.from_numpy(x)
        checked = 0
        for spec in REGISTRY.candidates("linear", param_keys=SPARSE):
            got = linear_apply(tparams, xt, impl=spec.name)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4,
                                       err_msg=spec.name)
            checked += 1
        assert checked == 4
        np.testing.assert_allclose(linear_apply(tparams, xt).numpy(), want,
                                   rtol=1e-4, atol=1e-4)

    def test_dense_and_masked_candidates_match_the_dense_reference(self):
        rng = np.random.default_rng(0)
        w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
        mask = torch.from_numpy(rng.random((64, 32)) < 0.5)
        x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
        for name, params, want in [("dense", {"w": w}, x @ w),
                                   ("masked", {"w": w, "mask": mask},
                                    x @ (w * mask))]:
            got = REGISTRY.get("linear", name).apply(params, x)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5)

    def test_linear_apply_executes_db_selection(self, db, monkeypatch):
        jparams, x = _linear_problem()
        tparams = params_from_jax(jparams, **CPU)
        key = dispatch.linear_key_from(x.shape, tparams["values"].shape)
        db.put(key.token, {"impl": "compressed_pallas@bb128_bk64", "wall_us": 1.0})
        calls = []
        spec = REGISTRY.get("linear", "compressed_pallas@bb128_bk64")
        counting = dataclasses.replace(
            spec, apply=lambda p, xx: (calls.append(1), spec.apply(p, xx))[1])
        monkeypatch.setitem(REGISTRY._impls["linear"],
                            "compressed_pallas@bb128_bk64", counting)
        linear_apply(tparams, torch.from_numpy(x))
        assert calls, "the profile-DB winner was not executed"


@pytest.mark.parametrize("impl", [None] + [
    s.name for s in REGISTRY.candidates("conv", param_keys=SPARSE)])
def test_resnet_tiny_under_every_plan_matches_jax(db, jdb, impl):
    jcfg, tcfg = j_get_config("resnet-tiny"), get_vision_config("resnet-tiny")
    jp = _jax_params(jcfg, 3)
    x = np.random.default_rng(4).standard_normal(
        (jcfg.c_in, 2, *jcfg.image_hw)).astype(np.float32)
    want = _jax_default_logits(jcfg, x)
    reset_launch_counts()
    got = tv.vision_apply(params_from_jax(jp, **CPU), tcfg, torch.from_numpy(x),
                          impl=impl)
    assert all(k.launches == 0 for k in KERNELS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_default_logits_cached(cfg, x_bytes, shape):
    x = np.frombuffer(x_bytes, np.float32).reshape(shape)
    jp = _jax_params(cfg, 3)
    return np.asarray(jv.vision_apply(jp, cfg, jax.numpy.asarray(x)))


def _jax_default_logits(cfg, x):
    return _jax_default_logits_cached(cfg, x.tobytes(), x.shape)


@pytest.mark.parametrize("impl", ["fused_banded_pallas",
                                  "two_kernel_pipelined@v128_bk64_hb1"])
def test_resnet_tiny_forced_plans_match_jax_forced(db, jdb, impl):
    jcfg, tcfg = j_get_config("resnet-tiny"), get_vision_config("resnet-tiny")
    jp = _jax_params(jcfg, 3)
    x = np.random.default_rng(5).standard_normal(
        (jcfg.c_in, 2, *jcfg.image_hw)).astype(np.float32)
    want = jv.vision_apply(jp, jcfg, jax.numpy.asarray(x), impl=impl)
    got = tv.vision_apply(params_from_jax(jp, **CPU), tcfg, torch.from_numpy(x),
                          impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


class TestPlanParams:
    def test_plan_finds_compressed_linear_layers(self, db, jdb):
        jparams, _ = _linear_problem(d_in=64, d_out=64, tile=16)
        jtree = {"blocks": [{"mlp": jparams}], "head": {"w": np.zeros((4, 4))}}
        want = jdispatch.plan_params(jtree, batch_hint=8)
        got = dispatch.plan_params(params_from_jax(jtree, **CPU), batch_hint=8)
        assert list(got) == list(want) and len(got) == 1
        (token, impl), = got.items()
        assert token.startswith("linear|") and impl == "compressed_xla"

    def test_plan_respects_frozen_db(self, db):
        jparams, _ = _linear_problem(d_in=64, d_out=64, tile=16)
        tree = {"l": params_from_jax(jparams, **CPU)}
        token = next(iter(dispatch.plan_params(tree, batch_hint=8)))
        db.put(token, {"impl": "compressed_pallas", "wall_us": 1.0})
        assert dispatch.plan_params(tree, batch_hint=8)[token] == "compressed_pallas"


def test_profiled_plan_runs_the_winners(db):
    """plan_params(profile=True) on CPU params times every compressed conv
    candidate and records the winners; the forward then resolves each conv
    from the DB."""
    cfg = get_vision_config("resnet-tiny")
    params = tv.vision_init(cfg, 0, **CPU)
    hints = tv.conv_hints(cfg, batch=2)
    plan = dispatch.plan_params(params, profile=True, conv_hints=hints, db=db)
    assert len(plan) == 5 and len(db) == 5
    for token, impl in plan.items():
        rec = db.get(token)
        assert rec["impl"] == impl and len(rec["all"]) >= 11
    x, _ = tv.synth_batch(cfg, 1, 2, **CPU)
    want = tv.vision_apply(params, cfg, x, impl="im2col_sparse_xla")
    np.testing.assert_allclose(tv.vision_apply(params, cfg, x).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-5)
