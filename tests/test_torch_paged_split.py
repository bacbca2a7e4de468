"""The split paged-attention kernel's plain version and shape rule, and the
no-grad check of every kernel wrapper, on the CPU.

``paged_attention_split_ref`` (the per-warp partials of
``csrc/paged_attention_split.cu`` over its page assignment, then its
combine) is held against the JAX package's ``paged_attention_ref`` and its
Pallas kernel in interpret mode over every case of
``tests/_paged_cases.py``, in f32 (1e-5) and bf16 (2e-2), under each warp
count of the kernel; ``paged_split_takes`` and the shared memory of the
launch the wrapper makes are checked on the shapes it must take and refuse.
Every ``*_cuda`` wrapper refuses a call autograd would record before any
other check, so CPU tensors that require grad show the wiring here; the
card tests show the same on the card.  Inputs come from numpy seeds."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _paged_cases import CASES, case_id, case_kwargs, problem
from _wrapper_calls import MODULES, NAMES, call_with_grad, n_floats
from repro import dispatch as jdispatch
from repro.kernels.flash_attn import paged as jpaged
from repro_torch import dispatch
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import (
    PAGED_SPLIT_WARPS,
    paged_attention_ref,
    paged_attention_split_ref,
    paged_launch_smem_bytes,
    paged_smem_bytes,
    paged_split_config,
    paged_split_smem_bytes,
    paged_split_takes,
    paged_split_tile_bound,
    paged_split_tiles,
)

F32_TOL = 1e-5
BF16_TOL = 2e-2  # one bf16 rounding of the output, other sum order


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _jax_ref(i):
    return np.asarray(jpaged.paged_attention_ref(
        *(jnp.asarray(a) for a in problem(**case_kwargs(CASES[i])))))


@functools.lru_cache(maxsize=None)
def _jax_interpret(i):
    kw = case_kwargs(CASES[i])
    return np.asarray(jpaged.paged_attention_pallas(
        *(jnp.asarray(a) for a in problem(**kw)), page_size=kw["page_size"],
        interpret=True))


# ---------------------------------------------------------------------------
# The split kernel's plain version against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warps", PAGED_SPLIT_WARPS)
@pytest.mark.parametrize("i", range(len(CASES)), ids=[case_id(c) for c in CASES])
def test_split_ref_matches_jax_ref(i, warps):
    got = paged_attention_split_ref(
        *(_t(a) for a in problem(**case_kwargs(CASES[i]))), warps=warps)
    want = _jax_ref(i)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("i", range(len(CASES)), ids=[case_id(c) for c in CASES])
def test_split_ref_matches_pallas_interpret(i):
    arrays = [_t(a) for a in problem(**case_kwargs(CASES[i]))]
    for warps in PAGED_SPLIT_WARPS:
        _close(paged_attention_split_ref(*arrays, warps=warps),
               _jax_interpret(i))


@pytest.mark.parametrize("i", range(len(CASES)), ids=[case_id(c) for c in CASES])
def test_split_ref_bf16_matches_jax_ref(i):
    arrays = problem(**case_kwargs(CASES[i]))
    jb = [jnp.asarray(a).astype(jnp.bfloat16) if a.dtype == np.float32
          else jnp.asarray(a) for a in arrays]
    tb = [_t(a).to(torch.bfloat16) if a.dtype == np.float32 else _t(a)
          for a in arrays]
    want = np.asarray(jpaged.paged_attention_ref(*jb).astype(jnp.float32))
    for warps in PAGED_SPLIT_WARPS:
        got = paged_attention_split_ref(*tb, warps=warps)
        assert got.dtype == torch.bfloat16
        _close(got.float(), want, BF16_TOL)


@pytest.mark.parametrize("warps", [1, 2, 3, 4])
def test_more_pages_than_warps(warps):
    """A 150-row sequence has 10 pages and a tile of new keys: each warp
    takes several tiles, their partials merged by the online update and
    then by the combine."""
    kw = dict(b=4, sq=1, h=15, kv=5, d=64, n_pages=10, page_size=16,
              lengths=[0, 16, 37, 150], shuffle=True)
    arrays = problem(**kw)
    _, n_tiles = paged_split_tiles(_t(arrays[6]), 1, 16, 10)
    assert n_tiles.tolist() == [1, 2, 4, 11] and int(n_tiles.max()) > warps
    want = jpaged.paged_attention_ref(*(jnp.asarray(a) for a in arrays))
    _close(paged_attention_split_ref(*(_t(a) for a in arrays), warps=warps),
           want)


def test_new_keys_past_one_page_and_idle_warps():
    """Sq 12 at page size 8: the new keys are two tiles, the second of
    which only the later query rows see; at 16 warps most have no tile and
    add nothing; an empty cache attends to the new keys alone."""
    arrays = problem(b=2, sq=12, h=2, kv=2, d=16, n_pages=3, page_size=8,
                     lengths=[0, 19], shuffle=True)
    n_used, n_tiles = paged_split_tiles(_t(arrays[6]), 12, 8, 3)
    assert n_used.tolist() == [0, 3] and n_tiles.tolist() == [2, 5]
    want = paged_attention_ref(*(_t(a) for a in arrays))
    for warps in (1, 4, 16):
        _close(paged_attention_split_ref(*(_t(a) for a in arrays),
                                         warps=warps), want)


def test_split_ref_junk_past_the_length_adds_nothing():
    """Rows past a length are never read: whatever the trash page holds,
    NaN included, the output is that of a finite trash page."""
    kw = dict(b=3, sq=4, lengths=[0, 9, 17])
    finite = [_t(a) for a in problem(trash_value=1e4, **kw)]
    poisoned = [_t(a) for a in problem(trash_value=float("nan"), **kw)]
    for warps in PAGED_SPLIT_WARPS:
        got = paged_attention_split_ref(*poisoned, warps=warps)
        assert bool(torch.isfinite(got).all())
        _close(got, paged_attention_split_ref(*finite, warps=warps))


# ---------------------------------------------------------------------------
# The shape rule and the launch's shared memory
# ---------------------------------------------------------------------------


def _operands(b=4, sq=1, h=15, kv=5, d=64, ps=16, n_max=10,
              dtype=torch.float32):
    q = torch.zeros((b, sq, h, d), dtype=dtype)
    kn = torch.zeros((b, sq, kv, d), dtype=dtype)
    pages = torch.zeros((b * n_max + 1, ps, kv, d), dtype=dtype)
    tables = torch.zeros((b, n_max), dtype=torch.int32)
    return q, kn, kn.clone(), pages, pages.clone(), tables


@pytest.mark.parametrize("kw,takes", [
    (dict(), True),                                  # smollm-360m's decode
    (dict(dtype=torch.bfloat16), True),
    (dict(h=14, kv=2), True),                        # qwen2-0.5b: 7 rows
    (dict(sq=4), True),                              # 12 rows, causal new keys
    (dict(h=4, kv=2, d=16, ps=8, sq=8), True),       # 16 rows
    (dict(h=4, kv=2, d=16, ps=8, sq=12), False),     # 24 rows
    (dict(sq=8), False),                             # 24 rows
    (dict(d=18), False),                             # 72-byte rows
    (dict(d=20, dtype=torch.bfloat16), False),       # 40-byte rows
    (dict(d=128), True),
    (dict(d=160), False),
    (dict(ps=32), True),
    (dict(ps=64), False),
    (dict(h=3, kv=2, d=16), False),                  # H % KV != 0
    (dict(n_max=40), True),                          # two slots, 8 warps
    (dict(d=128, ps=32, n_max=40), False),           # two slots pass 227 KB
])
def test_split_rule_takes_and_refuses(kw, takes):
    assert paged_split_takes(*_operands(**kw)) is takes


def test_split_rule_refuses_a_misaligned_operand():
    ops = list(_operands())
    assert paged_split_takes(*ops)
    buf = torch.zeros(ops[0].numel() + 1)
    ops[0] = buf[1:].view(ops[0].shape)  # 4 bytes past an aligned start
    assert not paged_split_takes(*ops)


@pytest.mark.parametrize("rows,inst", [(1, 4), (3, 4), (4, 4), (7, 8),
                                       (12, 16), (16, 16), (17, None)])
def test_split_config_rows_instance(rows, inst):
    cfg = paged_split_config(16, 64, rows, 11, torch.float32)
    assert (cfg[1] if cfg else None) == inst
    if cfg:
        assert cfg[0] in PAGED_SPLIT_WARPS


def test_split_config_takes_the_most_warps_that_fit():
    # decode, f32: 11 tiles at most, so 16 warps of one slot (135 KB); a
    # 20-page table needs two slots a warp: 8 warps
    assert paged_split_tile_bound(16, 10, 1) == 11
    assert paged_split_config(16, 64, 3, 11, torch.float32) == (16, 4)
    assert paged_split_config(16, 64, 3, 21, torch.float32) == (8, 4)
    assert paged_split_config(16, 64, 3, 21, torch.bfloat16) == (16, 4)
    assert paged_split_config(32, 128, 16, 40, torch.float32) is None


def test_split_smem_and_the_registry_footprint():
    # decode, f32: q rows of the 4-row instance, 64 floats each; per warp
    # one or two slots of 16 K rows of 68 floats and 16 V rows of 64, more
    # than the 3 x 66-float partial
    slot = 16 * 132 * 4
    assert paged_split_smem_bytes(16, 64, 3, 4, 8, 11) == 1024 + 8 * 2 * slot
    assert paged_split_smem_bytes(16, 64, 3, 4, 16, 11) == 1024 + 16 * slot
    # bf16 K rows padded by 8 elements
    assert paged_split_smem_bytes(16, 64, 3, 2, 16, 11) == \
        1024 + 16 * 16 * 136 * 2
    # 16 rows of D 16 at page size 1: the partial is the larger
    assert paged_split_smem_bytes(1, 16, 16, 4, 4, 2) == 1024 + 4 * 16 * 18 * 4
    assert paged_launch_smem_bytes(16, 64, 15, 5, 1, 10, torch.float32, 8) == \
        paged_split_smem_bytes(16, 64, 3, 4, 16, 11)
    # 8 queries of 3 heads a KV head: paged_attention.cu, 8 rows a block
    assert paged_launch_smem_bytes(16, 64, 15, 5, 8, 10, torch.float32, 8) == \
        paged_smem_bytes(16, 64, 24)
    # the registry sizes a geometry at the largest launch of a call of the
    # key: each Sq from 1 to the most either kernel takes a block, no more
    # than the key's (bucketed) query rows, and a table as wide as its
    # bucketed capacity
    for name in ("paged_attn_pallas", "paged_attn_pallas@ps8_bq8"):
        spec = dispatch.REGISTRY.get("paged_attn", name)
        ps, bq = spec.geom("ps"), spec.geom("bq")
        for h, kv, d in ((15, 5, 64), (4, 2, 16), (2, 2, 16)):
            key = dispatch.paged_attn_key(4, h, kv, d, 160, page_size=ps)
            assert spec.smem_bytes(key) == max(
                paged_launch_smem_bytes(ps, d, h, kv, sq, 256 // ps,
                                        torch.float32, bq)
                for sq in range(1, 9))
            assert spec.feasible(key)[0]


def test_registry_counts_the_decode_launch():
    """A key's calls at bq query rows a sequence go to paged_attention.cu
    (4 x 8 rows a KV head), its decode calls (Sq 1) to the split kernel,
    whose launch is far the larger (136192 bytes against 27072): the
    registry's count covers the decode launch."""
    spec = dispatch.REGISTRY.get("paged_attn", "paged_attn_pallas")
    key = dispatch.paged_attn_key(8, 8, 2, 64, 256, page_size=16)
    warps = paged_split_config(16, 64, 4, 17, torch.float32)[0]
    decode = paged_launch_smem_bytes(16, 64, 8, 2, 1, 16, torch.float32, 8)
    assert decode == paged_split_smem_bytes(16, 64, 4, 4, warps, 17) == 136192
    assert paged_launch_smem_bytes(16, 64, 8, 2, 8, 16, torch.float32, 8) \
        == paged_smem_bytes(16, 64, 32) == 27072
    assert decode <= spec.smem_bytes(key) <= _build.SMEM_BYTES
    assert spec.feasible(key)[0]


def test_feasible_sets_still_match_jax():
    """The feasibility predicates size the kernel the rule picks, and admit
    the same geometries as the JAX registry, split kernel or not."""
    for key_args in [(8, 4, 2, 16, 64, 8), (8, 2, 2, 16, 64, 8),
                     (4, 15, 5, 64, 160, 16), (4, 14, 2, 64, 160, 0),
                     (8, 4, 4, 128, 64, 32)]:
        mine = dispatch.paged_attn_key(*key_args[:5], page_size=key_args[5])
        theirs = jdispatch.paged_attn_key(*key_args[:5], page_size=key_args[5])
        feas = {s.name for s in dispatch.REGISTRY.candidates("paged_attn")
                if s.feasible(mine)[0]}
        jfeas = {s.name for s in jdispatch.REGISTRY.candidates("paged_attn")
                 if s.feasible(theirs)[0]}
        assert feas == jfeas, key_args


# ---------------------------------------------------------------------------
# Every kernel wrapper refuses an autograd-recorded call
# ---------------------------------------------------------------------------


def test_the_table_covers_every_kernel_wrapper():
    found = {name for mod in MODULES for name in dir(mod)
             if name.endswith("_cuda") and callable(getattr(mod, name))}
    assert found == set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_every_wrapper_refuses_a_recorded_call_first(name):
    """CPU tensors would fail the wrapper's device check; the no-grad check
    comes first, for each float operand that requires grad."""
    for which in range(n_floats(name)):
        with pytest.raises(RuntimeError, match="forward only"):
            call_with_grad(name, "cpu", which)
    # without grad the same call reaches the device check
    with pytest.raises(ValueError, match="CUDA tensor"):
        call_with_grad(name, "cpu", -1)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        call_with_grad(name, "cpu", 0)


def test_check_no_grad():
    a = torch.zeros(3, requires_grad=True)
    b = torch.zeros(3)
    _build.check_no_grad("k", b, b)
    with torch.no_grad():
        _build.check_no_grad("k", a, b)
    with pytest.raises(RuntimeError) as e:
        _build.check_no_grad("colwise_nm_matmul", b, a)
    msg = str(e.value)
    assert msg.startswith("colwise_nm_matmul is forward only")
    assert "JAX counterpart differentiates" in msg
    assert "conv2d_sparse/conv_apply" in msg and "linear_apply" in msg
    with pytest.raises(RuntimeError, match="the reference kernel has no "
                                           "gradient"):
        _build.check_no_grad("paged attention", a, why=_build.NO_VJP)
    with torch.enable_grad():
        with pytest.raises(RuntimeError, match="forward only"):
            _build.check_no_grad("k", a)


def test_plain_paths_still_differentiate_on_the_cpu():
    """On the CPU the plain versions run, and they differentiate: the
    no-grad check guards the kernels, not the ops entry points."""
    arrays = [_t(a) for a in problem(b=2, lengths=[13, 7])]
    q = arrays[0].clone().requires_grad_()
    out = paged_attention_ref(q, *arrays[1:])
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
