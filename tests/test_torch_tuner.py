"""The deprecated ``Tuner`` shim and ``core.tuning`` against the JAX
package's (``tests/test_dispatch.py``'s ``TestTunerFixes`` and
``tests/test_substrate.py``'s ``TestTuner``), on the CPU: the tile list,
the block grid, the ``profile=False`` pick, the cache key, the versioned
file, a seed-era cache dropped, and ``profile=True`` timing the plain
version of each tile.

A divergence by design: the port's feasibility is the linear kernel's
shared memory against a Hopper block's 227 KB, and that does not grow with
``d_in`` (the kernel stages ``block_k`` kept rows of ``block_b`` rows at a
time, never a whole row block), where JAX's VMEM estimate holds a whole
``[block_b, d_in]`` block.  So the shapes JAX refuses for VMEM (``d_in =
10_000_000``; ``65536 x 2048``) are feasible here; the cases are held to
JAX where both predicates agree, and ``TuningError`` is reached through a
predicate made to refuse."""
import json

import pytest
import torch

from repro.core import tuning as jtuning
from repro.dispatch import profiler as jprofiler
from repro_torch import dispatch
from repro_torch.core import tuning
from repro_torch.dispatch import profiler
from repro_torch.dispatch.registry import LINEAR_GEOMETRY
from repro_torch.kernels import KERNELS, _build, reset_launch_counts

SHAPES = [(256, 256), (512, 512), (960, 2560), (2560, 960), (896, 4864),
          (512, 96)]


def _tuner(path, **kw):
    return tuning.Tuner(cache_path=str(path), device="cpu", **kw)


def test_core_tuning_reexports_the_shim():
    assert tuning.Tuner is dispatch.Tuner is profiler.Tuner
    assert tuning.Candidate is dispatch.Candidate
    assert tuning.enumerate_candidates is dispatch.enumerate_candidates
    assert tuning.TuningError is dispatch.TuningError
    assert tuning.SMEM_BYTES == _build.SMEM_BYTES == 227 * 1024
    assert issubclass(tuning.TuningError, RuntimeError)


@pytest.mark.parametrize("d_in,d_out", SHAPES)
def test_tile_list_and_block_grid_match_jax(d_in, d_out):
    """The same (tile, block_b, block_k) points in the same order; every
    one feasible on both sides at these shapes."""
    mine = tuning.enumerate_candidates(d_in, d_out)
    theirs = jtuning.enumerate_candidates(d_in, d_out)
    assert [(c.tile, c.block_b, c.block_k) for c in mine] == [
        (c.tile, c.block_b, c.block_k) for c in theirs]
    assert all(c.feasible for c in theirs) and all(c.feasible for c in mine)
    for c in mine:
        assert c.smem_bytes == _build_smem(c)
        assert c.wall_us is None and c.score == 0.0


def _build_smem(c):
    from repro_torch.kernels.colwise_nm import linear_smem_bytes

    return linear_smem_bytes(c.tile, c.block_b, c.block_k)


@pytest.mark.parametrize("d_in,d_out", [(10_000_000, 512), (65536, 2048)])
def test_feasibility_does_not_grow_with_d_in(d_in, d_out):
    """The divergence by design: JAX refuses these for VMEM, the port's
    shared memory is the same as at any other d_in."""
    theirs = jtuning.enumerate_candidates(d_in, d_out)
    mine = tuning.enumerate_candidates(d_in, d_out)
    assert any(not c.feasible for c in theirs)
    assert all(c.feasible for c in mine)
    assert [c.smem_bytes for c in mine] == [
        c.smem_bytes for c in tuning.enumerate_candidates(256, d_out)]


def test_all_infeasible_raises_named_error(tmp_path, monkeypatch):
    """JAX's case, with the port's predicate made to refuse every
    candidate (its own never refuses at this d_in)."""
    with pytest.raises(jtuning.TuningError, match=r"d_in=10000000"):
        jtuning.Tuner(cache_path=str(tmp_path / "j.json")).tune(
            batch=1, d_in=10_000_000, d_out=512, profile=False)
    t = _tuner(tmp_path / "c.json")
    assert t.tune(batch=1, d_in=10_000_000, d_out=512, profile=False)
    monkeypatch.setattr(profiler, "_linear_smem",
                        lambda bb, bk, tile: _build.SMEM_BYTES + 1)
    with pytest.raises(tuning.TuningError, match=r"d_in=10000000") as e:
        _tuner(tmp_path / "d.json").tune(batch=1, d_in=10_000_000, d_out=512,
                                         profile=False)
    assert "shared memory" in str(e.value)


@pytest.mark.parametrize("d_in,d_out", [(256, 256), (960, 2560), (512, 96)])
def test_profile_disabled_takes_least_smem_and_matches_jax(tmp_path, d_in,
                                                           d_out):
    """``profile=False`` times nothing and picks the least shared memory,
    then the least tile: the same point JAX's least-VMEM rule picks."""
    r = _tuner(tmp_path / "c.json").tune(batch=8, d_in=d_in, d_out=d_out,
                                         profile=False)
    feas = [c for c in tuning.enumerate_candidates(d_in, d_out) if c.feasible]
    assert r["smem_bytes"] == min(c.smem_bytes for c in feas)
    assert r["wall_us"] is None
    j = jtuning.Tuner(cache_path=str(tmp_path / "j.json")).tune(
        batch=8, d_in=d_in, d_out=d_out, profile=False)
    assert (r["tile"], r["block_b"], r["block_k"]) == (
        j["tile"], j["block_b"], j["block_k"])
    # the result keys: smem_bytes where JAX has vmem_bytes
    assert set(r) == set(j) - {"vmem_bytes"} | {"smem_bytes"}


def test_stale_seed_cache_not_reused(tmp_path):
    p = tmp_path / "tuning_cache.json"
    stale = {"b8_i256_o256_s50": {"tile": 999, "block_b": 1, "block_k": 1,
                                  "wall_us": 0.1, "smem_bytes": 1}}
    p.write_text(json.dumps(stale))
    t = _tuner(p)
    assert len(t.db) == 0 and t.db.invalidated
    r = t.tune(batch=8, d_in=256, d_out=256, profile=False)
    assert r["tile"] != 999


def test_tuner_persists_versioned_format(tmp_path):
    p = tmp_path / "c.json"
    t = _tuner(p)
    assert t.path == p
    t.tune(batch=8, d_in=256, d_out=256, profile=False)
    data = json.loads(p.read_text())
    assert data["version"] == profiler.SCHEMA_VERSION
    assert "fingerprint" in data and "entries" in data
    assert data["fingerprint"]["kernels"] == _build._digest()
    assert list(data["entries"]) == ["b8_i256_o256_s50"]
    assert t.cache == data["entries"]


@pytest.mark.parametrize("args", [(8, 256, 256, 0.5), (64, 960, 2560, 0.75),
                                  (1, 512, 96, 0.125)])
def test_cache_key_matches_jax(tmp_path, args):
    j = jtuning.Tuner(cache_path=str(tmp_path / "j.json"))
    assert _tuner(tmp_path / "c.json")._key(*args) == j._key(*args)


def test_tuner_profiles_and_caches(tmp_path):
    """TestTuner's case: a profiled pick among the tiles, a positive wall
    time, and a second tuner on the same file returns it untimed.  On the
    CPU each tile is timed through its plain version: no launch."""
    cands = tuning.enumerate_candidates(512, 512)
    assert any(c.feasible for c in cands)
    reset_launch_counts()
    t = _tuner(tmp_path / "cache.json")
    r1 = t.tune(batch=64, d_in=256, d_out=256, sparsity=0.5)
    assert r1["tile"] in (32, 64, 128, 256) and r1["wall_us"] > 0
    assert all(k.launches == 0 for k in KERNELS)
    t2 = _tuner(tmp_path / "cache.json")
    assert t2.tune(batch=64, d_in=256, d_out=256, sparsity=0.5) == r1
    assert t2.tuned_tile(64, 256, 256) == r1["tile"]


def test_profile_times_each_tile_once_and_scores_by_smem(tmp_path,
                                                         monkeypatch):
    """Each tile is timed once, every block point carries its tile's time,
    and the score adds a tenth of the shared-memory share."""
    timed = []

    def fake_time(batch, d_in, d_out, sparsity, tile, device, *geometry):
        assert geometry == ()
        timed.append(tile)
        return {32: 5.0, 64: 3.0, 128: 4.0, 256: 6.0}[tile]

    monkeypatch.setattr(profiler, "_time_tile", fake_time)
    r = _tuner(tmp_path / "c.json").tune(batch=8, d_in=256, d_out=256)
    assert sorted(timed) == [32, 64, 128, 256]
    assert (r["tile"], r["block_b"], r["block_k"]) == (64, 128, 64)
    assert r["wall_us"] == 3.0


def test_profile_times_each_geometry_of_a_1a_tile_on_the_card(tmp_path,
                                                             monkeypatch):
    """On the card a tile that routes to colwise_nm_linear.cu is timed at
    every block geometry it takes, so the pick's geometry is one that was
    timed; the tiled kernel's tiles are timed once each."""
    timed = {}

    def fake_time(batch, d_in, d_out, sparsity, tile, device, *geometry):
        assert device.type == "cuda"
        wall = {(32, (128, 128)): 5.0, (32, (256, 128)): 2.0,
                (32, (128, 64)): 4.0}.get((tile, geometry), 3.0)
        timed[(tile, geometry)] = wall
        return wall

    monkeypatch.setattr(profiler, "_time_tile", fake_time)
    t = _tuner(tmp_path / "c.json")
    t.device = torch.device("cuda")
    r = t.tune(batch=8, d_in=256, d_out=256)
    geos = [(dict(g)["bb"], dict(g)["bk"]) for g in LINEAR_GEOMETRY]
    assert sorted(timed) == sorted([(32, g) for g in geos]
                                   + [(t, ()) for t in (64, 128, 256)])
    assert (r["tile"], r["block_b"], r["block_k"]) == (32, 256, 128)
    assert r["wall_us"] == 2.0


@pytest.mark.parametrize("tile", [32, 64])
def test_timed_tile_runs_the_plain_version_on_the_cpu(tile, monkeypatch):
    """Each tile is timed through the wrapper of the kernel it routes to
    (a multiple of 64 columns: the tiled kernel's), which on the CPU runs
    the plain version."""
    from repro_torch.kernels import colwise_nm

    calls = []
    for name in ("colwise_nm_matmul", "colwise_nm_matmul_tiled"):
        def spy(x, v, i, _orig=getattr(colwise_nm, name), _name=name):
            calls.append(_name)
            return _orig(x, v, i)

        monkeypatch.setattr(colwise_nm, name, spy)
    reset_launch_counts()
    us = profiler._time_tile(8, 128, 128, 0.5, tile, torch.device("cpu"))
    assert us > 0 and calls
    want = "colwise_nm_matmul_tiled" if tile % 64 == 0 else "colwise_nm_matmul"
    assert set(calls) == {want}
    assert all(k.launches == 0 for k in KERNELS)


def test_tuner_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the tuner rightly runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuning.Tuner(cache_path=str(tmp_path / "c.json"))


def test_jax_profiler_tuner_is_the_reference():
    """The shim's twin is the JAX package's own, also behind its dispatch."""
    assert jtuning.Tuner is jprofiler.Tuner
