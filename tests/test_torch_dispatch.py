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
from repro_torch.kernels.colwise_nm import (linear_tiled_smem_bytes,
                                            pipelined_smem_bytes,
                                            strips_tiled_geometry,
                                            tiled_block_rows)
from repro_torch.kernels._build import SMEM_BYTES
from repro_torch.kernels.conv_gemm import (band_plan, banded_smem_bytes,
                                          banded_tiled_geometry,
                                          banded_tiled_smem_bytes)
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


# Families the port registers and the JAX registry does not (ROADMAP queue
# 3, divergences by design): the tiled sparse linear kernel.
PORT_ONLY = {"linear": {"compressed_tiled"}}


@pytest.mark.parametrize("op", ["linear", "conv", "paged_attn"])
def test_candidates_match_the_jax_registry(op):
    mine = {s.name: s for s in REGISTRY.candidates(op)}
    theirs = {s.name: s for s in jdispatch.REGISTRY.candidates(op)}
    extra = PORT_ONLY.get(op, set())
    assert extra <= set(mine) and not extra & set(theirs)
    assert all(mine.pop(name).backend == "cuda" for name in extra)
    assert sorted(mine) == sorted(theirs)
    for name, spec in mine.items():
        ref = theirs[name]
        assert spec.requires == ref.requires, name
        assert spec.priority == ref.priority, name
        assert spec.geometry == ref.geometry, name
        assert spec.backend == {"pallas": "cuda", "xla": "torch"}[ref.backend]
        assert (spec.apply is None) == (ref.apply is None), name
    assert REGISTRY.ops() == sorted(jdispatch.REGISTRY.ops())


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
            "compressed_xla", "compressed_pallas", "compressed_tiled"}

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
            ok, reason = spec.feasible(key)
            if spec.name == "compressed_tiled":  # 64-column blocks of T
                assert ok == (tile % 64 == 0) and (ok or "64" in reason)
            else:
                assert ok, (spec.name, reason)
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
        """conv2d_fused_banded.cu's two f32 windows do not fit here; the
        shape rule gives the conv to the tiled kernel, whose one padded
        window and all of the weights fit in both dtypes."""
        spec = REGISTRY.get("conv", name)
        f32, bf16 = self._stride2_conv1("float32"), self._stride2_conv1("bfloat16")
        v, hb = spec.geom("v"), spec.geom("hb")
        _, rows = band_plan(b=256, h=16, kh=3, stride=2, pad=1, ho=8, wo=8,
                            v=v, hb=hb)
        two_bands = 2 * 16 * rows * 16 * 4
        assert two_bands == 258 * 1024  # 258 KB of f32 windows
        assert banded_smem_bytes(16, 16, rows, 72, 4) > SMEM_BYTES
        geo = {isz: banded_tiled_geometry(16, 256, 16, 16, 3, 3, 2, 1, v, hb,
                                          2, 72, 8, isz) for isz in (4, 2)}
        assert geo[4]["group"] == geo[2]["group"] == 2
        assert spec.feasible(f32)[0] and spec.feasible(bf16)[0]
        for key, isz in ((f32, 4), (bf16, 2)):
            assert spec.smem_bytes(key) == geo[isz]["smem"] == \
                banded_tiled_smem_bytes(16, geo[isz]["plane"], 2, 72, 8, isz,
                                        2)
        assert REGISTRY.get("conv", "fused_banded_pallas").feasible(f32)[0]

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_banded_smem_follows_the_rule_on_resnet_tiny(self, dtype):
        """Every banded geometry of resnet-tiny's five pruned convs goes to
        the tiled kernel with all of its weights staged at once (one group
        of both tiles), and the predicate reports that launch's shared
        memory."""
        isz = 4 if dtype == "float32" else 2
        convs = [(8, 16, 16, 3, 1, 1), (16, 16, 16, 3, 1, 1),
                 (16, 16, 16, 3, 2, 1), (16, 8, 8, 3, 1, 1),
                 (16, 16, 16, 1, 2, 0)]
        for c, h, w, k, s, p in convs:
            k_kept = k * k * c // 2
            key = dispatch.conv_key(c, h, w, 16, k, k, s, p, k_kept, 8,
                                    dtype=dtype, batch=256)
            for name in ("fused_banded_pallas",
                         "fused_banded_pallas@v256_bk128_hb2",
                         "fused_banded_pallas@v128_bk128_hb4",
                         "fused_banded_pallas@v128_bk64_hb1"):
                spec = REGISTRY.get("conv", name)
                v, hb = spec.geom("v"), spec.geom("hb")
                geo = banded_tiled_geometry(c, 256, h, w, k, k, s, p, v, hb,
                                            2, k_kept, 8, isz)
                assert geo is not None, (key.token, name)
                assert spec.feasible(key)[0]
                assert geo["group"] == 2
                assert spec.smem_bytes(key) == geo["smem"] == \
                    banded_tiled_smem_bytes(c, geo["plane"], 2, k_kept, 8,
                                            isz, 2) <= SMEM_BYTES

    @pytest.mark.parametrize("c,h,name,group", [
        # ResNet-18 layer1 at batch 8: all 8 tiles at once
        (64, 56, "fused_banded_pallas@v128_bk64_hb1", 8),
        (64, 56, "fused_banded_pallas", 4),  # a taller window: 2 groups of 4
        (64, 56, "fused_banded_pallas@v256_bk128_hb2", 1),  # a tile at a time
        (128, 28, "fused_banded_pallas@v128_bk64_hb1", 2),  # layer2: 8 of 2
        # the window and one tile's weights do not fit
        (128, 28, "fused_banded_pallas", None),
    ])
    def test_banded_tiled_stages_wide_weights_a_group_of_tiles_at_a_time(
            self, c, h, name, group):
        """Where all of the weights do not fit beside the padded window,
        the tiled kernel stages them in the fewest equal groups of tiles
        that do, and the predicate reports that launch's shared memory;
        where one tile's weights do not fit, conv2d_fused_banded.cu's."""
        n_tiles, k_kept = c // 8, 9 * c // 2
        key = dispatch.conv_key(c, h, h, c, 3, 3, 1, 1, k_kept, 8,
                                dtype="float32", batch=8)
        spec = REGISTRY.get("conv", name)
        v, hb = spec.geom("v"), spec.geom("hb")
        geo = banded_tiled_geometry(c, 8, h, h, 3, 3, 1, 1, v, hb, n_tiles,
                                    k_kept, 8, 4)
        if group is None:
            assert geo is None
            _, rows = band_plan(b=8, h=h, kh=3, stride=1, pad=1, ho=h, wo=h,
                                v=v, hb=hb)
            assert spec.smem_bytes(key) == banded_smem_bytes(
                c, h, rows, spec.geom("bk"), 4)
            return
        assert geo["group"] == group
        smem = functools.partial(banded_tiled_smem_bytes, c, geo["plane"],
                                 n_tiles, k_kept, 8, 4)
        assert spec.smem_bytes(key) == geo["smem"] == smem(group) <= SMEM_BYTES
        n_groups = -(-n_tiles // group)
        if n_groups > 1:  # one group fewer does not fit
            assert smem(-(-n_tiles // (n_groups - 1))) > SMEM_BYTES

    def test_banded_smem_keeps_the_other_kernel_where_the_rule_refuses(self):
        # W = 10 f32: 40-byte rows are not whole 16-byte copies
        key = dispatch.conv_key(8, 10, 10, 16, 3, 3, 1, 1, 36, 8,
                                dtype="float32", batch=2)
        spec = REGISTRY.get("conv", "fused_banded_pallas")
        assert banded_tiled_geometry(8, 2, 10, 10, 3, 3, 1, 1, 128, 2, 2, 36,
                                     8, 4) is None
        _, rows = band_plan(b=2, h=10, kh=3, stride=1, pad=1, ho=10, wo=10,
                            v=128, hb=2)
        assert spec.smem_bytes(key) == banded_smem_bytes(8, 10, rows, 36, 4)
        # tile 12: not a whole number of 8-row groups
        key12 = dispatch.conv_key(8, 16, 16, 24, 3, 3, 1, 1, 36, 12,
                                  dtype="float32", batch=2)
        assert banded_tiled_geometry(8, 2, 16, 16, 3, 3, 1, 1, 128, 2, 2, 36,
                                     12, 4) is None
        _, rows = band_plan(b=2, h=16, kh=3, stride=1, pad=1, ho=16, wo=16,
                            v=128, hb=2)
        assert spec.smem_bytes(key12) == banded_smem_bytes(8, 16, rows,
                                                           36, 4)

    def test_pipelined_ring_of_wide_slices_needs_bf16(self):
        # colwise_nm_strips_pipelined.cu: two [128, 256] f32 slices of
        # gathered rows are 256 KB; at resnet-tiny's 72 kept rows the slices
        # are shorter and fit.  The tiled strip GEMM's ring holds 8-row
        # slices, so the registry sizes that ring wherever its shape rule
        # takes the strips, and the other ring only where it refuses them
        spec = REGISTRY.get("conv", "two_kernel_pipelined@v256_bk128_hb2")
        assert spec.feasible(self._stride2_conv1("float32"))[0]
        assert pipelined_smem_bytes(256, 128, 4) > SMEM_BYTES
        assert pipelined_smem_bytes(256, 128, 2) <= SMEM_BYTES
        wide = [dispatch.conv_key(32, 16, 16, 16, 3, 3, 1, 1, 144, 8,
                                  dtype=d, batch=256)
                for d in ("float32", "bfloat16")]
        for key, isz in zip(wide, (4, 2)):
            geo = strips_tiled_geometry(256, 256, 2, 144, 8, isz, 2)
            assert spec.feasible(key)[0] and spec.smem_bytes(key) == geo["smem"]
        # 1000 kept rows of a 64-row tile: 256 KB of f32 values, so the rule
        # refuses them and the f32 key needs the other, too-wide ring
        big = [dispatch.conv_key(112, 16, 16, 64, 3, 3, 1, 1, 1000, 64,
                                 dtype=d, batch=256)
               for d in ("float32", "bfloat16")]
        assert strips_tiled_geometry(256, 256, 1, 1000, 64, 4, 2) is None
        assert spec.smem_bytes(big[0]) == pipelined_smem_bytes(256, 128, 4)
        assert not spec.feasible(big[0])[0] and spec.feasible(big[1])[0]

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
        # on the card the wide tile goes to the tiled kernel, tile 8 to this
        # one
        feas = REGISTRY.feasible(wide, param_keys=SPARSE)
        assert _heuristic(feas, wide, "cuda").name == "compressed_tiled"
        assert _heuristic(feas, wide, "cpu").name == "compressed_xla"
        feas = REGISTRY.feasible(narrow, param_keys=SPARSE)
        assert _heuristic(feas, narrow, "cuda").name == "compressed_pallas"


class TestTiledLinear:
    """The port-only ``compressed_tiled`` family: the tiled sparse linear
    kernel, feasible where T is a multiple of 64 and ranked first there on
    the card."""

    SPEC = REGISTRY.get("linear", "compressed_tiled")

    def test_registered_below_the_pallas_priority(self):
        spec = self.SPEC
        assert (spec.op, spec.backend, spec.geometry) == ("linear", "cuda", ())
        assert spec.requires == frozenset(SPARSE)
        assert spec.priority == 5 < REGISTRY.get(
            "linear", "compressed_pallas").priority
        assert spec.apply is not None and spec.make_bench is not None

    @pytest.mark.parametrize("tile", [64, 320, 960, 2560])
    def test_feasible_for_multiples_of_64(self, tile):
        key = dispatch.linear_key(256, 960, 2 * tile, 480, tile)
        assert self.SPEC.feasible(key) == (True, "ok")

    @pytest.mark.parametrize("tile", [8, 12, 100])
    def test_infeasible_for_other_widths_with_a_reason(self, tile):
        key = dispatch.linear_key(256, 960, 24 * tile, 480, tile)
        ok, reason = self.SPEC.feasible(key)
        assert not ok and f"tile={tile}" in reason and "64" in reason

    @staticmethod
    def _on_card(key, db):
        return dispatch.dispatch._resolve(key, frozenset(SPARSE), None, db,
                                          "cuda")

    @pytest.mark.parametrize("rows", [4, 256, 8192])
    @pytest.mark.parametrize("d_in,d_out", [(960, 2560), (2560, 960),
                                            (960, 320)])
    def test_the_card_picks_the_tiled_kernel_at_every_row_count(
            self, db, rows, d_in, d_out):
        key = dispatch.linear_key(rows, d_in, d_out, d_in // 2, d_out)
        assert self._on_card(key, db) == (self.SPEC, "heuristic")
        assert dispatch.resolve(key, param_keys=SPARSE, **CPU) == (
            REGISTRY.get("linear", "compressed_xla"), "heuristic")

    @pytest.mark.parametrize("rows", [4, 256, 8192])
    @pytest.mark.parametrize("tile,d_out", [(8, 2560), (12, 2400)])
    def test_the_card_keeps_the_linear_kernel_for_narrow_tiles(
            self, db, rows, tile, d_out):
        key = dispatch.linear_key(rows, 960, d_out, 480, tile)
        assert self._on_card(key, db) == (
            REGISTRY.get("linear", "compressed_pallas"), "heuristic")

    @pytest.mark.parametrize("bm", [16, 64, 128])
    @pytest.mark.parametrize("itemsize", [4, 2])
    def test_smem_formula(self, bm, itemsize):
        # two stages of [32, bm + 4] f32 activations and [32, 64] values
        want = 2 * (32 * (bm + 4) * 4 + 32 * 64 * itemsize)
        assert linear_tiled_smem_bytes(bm, 32, itemsize) == want
        assert want <= 50176 < 227 * 1024

    @pytest.mark.parametrize("rows,d_out,bm", [
        (0, 2560, 16), (1, 960, 16), (4, 2560, 16), (16, 64, 16),
        (16, 16384, 16),    # every row in one block: more rows cannot help
        (17, 2560, 16),     # 2 x 40 = 80 blocks of 16 rows
        (128, 960, 16),     # 8 x 15 = 120
        (256, 320, 16),     # 16 x 5 = 80
        (64, 2560, 64),     # 160 blocks of 16 rows; one block of 64
        (256, 960, 64),     # 240 of 16; 4 x 15 = 60 of 64
        (128, 2560, 64), (512, 320, 64), (1024, 320, 64),
        (256, 2560, 128),   # 160 blocks of 64 rows
        (2048, 320, 128), (1024, 960, 128), (8192, 2560, 128),
        (8192, 320, 128), (100, 16384, 128)])
    def test_block_rows_rule(self, rows, d_out, bm):
        assert tiled_block_rows(rows, d_out) == bm

    def test_rows_per_block_never_fall_as_rows_grow(self):
        for d_out in (64, 320, 960, 2560, 4864):
            bms = [tiled_block_rows(n, d_out) for n in range(0, 40000, 7)]
            assert bms == sorted(bms)
            # so the key's bucketed rows ask at least the launch's memory
            for n in (3, 17, 100, 700, 5000):
                key = dispatch.linear_key(n, 960, d_out, 480, d_out)
                assert self.SPEC.smem_bytes(key) >= linear_tiled_smem_bytes(
                    tiled_block_rows(n, d_out), 32, 4)

    @pytest.mark.parametrize("dtype,itemsize", [("float32", 4),
                                                ("bfloat16", 2)])
    def test_smem_of_a_key(self, dtype, itemsize):
        key = dispatch.linear_key(8192, 960, 2560, 480, 2560, dtype=dtype)
        assert self.SPEC.smem_bytes(key) == linear_tiled_smem_bytes(
            128, 32, itemsize)
        key = dispatch.linear_key(4, 960, 2560, 480, 2560, dtype=dtype)
        assert self.SPEC.smem_bytes(key) == linear_tiled_smem_bytes(
            16, 32, itemsize)

    @pytest.mark.parametrize("tile", [64, 128])
    def test_forced_on_the_cpu_matches_jax(self, db, jdb, tile):
        jparams, x = _linear_problem(d_in=96, d_out=256, batch=5, tile=tile)
        want = np.asarray(j_linear_apply(jparams, jax.numpy.asarray(x)))
        tparams = params_from_jax(jparams, **CPU)
        reset_launch_counts()
        got = linear_apply(tparams, torch.from_numpy(x),
                           impl="compressed_tiled")
        assert all(k.launches == 0 for k in KERNELS)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


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
        ("torch", "0.0"), ("kernels", "0" * 16)])
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
        assert checked == 5
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
