"""The port's roofline tier against the JAX package, on the CPU.

- ``ModelConfig.param_count``/``active_param_count``, ``SHAPES``,
  ``LONG_CONTEXT_ARCHS`` and ``model_flops_for`` equal JAX's for every
  arch (and cell); ``input_specs`` gives the keys, shapes and dtypes of
  JAX's ``ShapeDtypeStruct``s; ``Roofline.to_dict`` has JAX's keys.
- The op counter (``roofline.count``) on the five cases of
  ``tests/test_hlo_analyzer.py`` and on the twin of
  ``tests/test_system.py::test_sparsity_reduces_flops`` (the port's eager
  FLOPs within 15% of JAX's ``analyze_hlo`` of the jitted forward).
- One call of each kernel family (#1-#8) counted as the ``Work`` worked by
  hand below, the same whichever plan or plain version dispatch runs.
- A collective counts the bytes it reads or writes, the larger, once (a
  world-1 gloo group; 2 ranks in ``test_torch_layout_train.py``).
- ``remat``: the gradients equal the ones without it (bit for bit: the
  recompute runs the same ops in the same order) and JAX's remat gradients
  within 1e-5, and the train step's FLOPs rise by the recomputed forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro import dispatch as jdispatch
from repro.configs import LONG_CONTEXT_ARCHS as J_LONG
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.core.pruning import SparsityConfig as JSparsityConfig
from repro.models import registry as jreg
from repro.roofline.analysis import Roofline as JRoofline
from repro.roofline.analysis import model_flops_for as j_model_flops_for
from repro.roofline.hlo_analyzer import analyze_hlo
from repro_torch import dispatch
from repro_torch._tree import (keystr, leaves_with_path, tree_leaves,
                               value_and_grad)
from repro_torch.configs import (LONG_CONTEXT_ARCHS, SHAPES, get_config,
                                 list_archs, smoke_config)
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import SparsityConfig
from repro_torch.core.sparse_linear import forward_compressed_xla, linear_apply
from repro_torch.kernels.colwise_nm import ops as lin_ops
from repro_torch.kernels.conv_gemm import ops as conv_ops
from repro_torch.kernels.flash_attn import flash_attention, paged_attention
from repro_torch.kernels.im2col_pack import im2col_pack
from repro_torch.launch import steps
from repro_torch.models import registry as treg
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.roofline import Roofline, count, model_flops_for
from repro_torch.roofline.kernels import Work

F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def dbs(tmp_path):
    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    jdispatch.set_db(jdispatch.ProfileDB(path=str(tmp_path / "jax.json")))
    yield
    dispatch.set_db(None)
    jdispatch.set_db(None)


# ---------------------------------------------------------------------------
# Configs, cells, model FLOPs, input specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_equal_jax(arch):
    for t, j in ((get_config(arch), j_get_config(arch)),
                 (smoke_config(arch), j_smoke_config(arch))):
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert (t.remat, t.remat_policy) == (j.remat, j.remat_policy)


def test_shapes_and_long_context_archs_equal_jax():
    assert LONG_CONTEXT_ARCHS == J_LONG
    assert list(SHAPES) == list(J_SHAPES)
    for name, cell in SHAPES.items():
        j = J_SHAPES[name]
        assert (cell.name, cell.seq_len, cell.global_batch, cell.kind,
                cell.is_serve) == (j.name, j.seq_len, j.global_batch, j.kind,
                                   j.is_serve)


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_jax(arch):
    for name in SHAPES:
        for s in (0.0, 0.5):
            want = j_model_flops_for(j_get_config(arch), J_SHAPES[name], s)
            got = model_flops_for(get_config(arch), SHAPES[name], s)
            assert got == pytest.approx(want, rel=1e-12), (name, s)


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _flat(tree, jax_side):
    if jax_side:
        pairs = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {jax.tree_util.keystr(p): (tuple(a.shape),
                                          str(np.dtype(a.dtype)))
                for p, a in pairs}
    return {keystr(p): (tuple(t.shape), _dtype_name(t.dtype))
            for p, t in leaves_with_path(tree)}


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_jax(arch):
    """Every cell's keys, and every leaf's shape and dtype (bf16, as the dry
    run builds the configs), the decode cache's included; every leaf on
    ``meta``."""
    tcfg = get_config(arch).with_(dtype="bfloat16", param_dtype="bfloat16")
    jcfg = j_get_config(arch).with_(dtype="bfloat16", param_dtype="bfloat16")
    for name in SHAPES:
        t = treg.input_specs(tcfg, SHAPES[name])
        j = jreg.input_specs(jcfg, J_SHAPES[name])
        assert set(t) == set(j) and t["kind"] == j["kind"], name
        tt = {k: v for k, v in t.items() if k != "kind"}
        jj = {k: v for k, v in j.items() if k != "kind"}
        assert _flat(tt, False) == _flat(jj, True), name
        assert all(x.device.type == "meta" for x in tree_leaves(tt))


def test_roofline_to_dict_has_jax_keys():
    kw = dict(flops=1e12, hlo_bytes=2e9, collective_bytes=3e8,
              model_flops=4e14, chips=256)
    assert set(Roofline(**kw, dtype="float32").to_dict()) == set(
        JRoofline(**kw).to_dict())


# ---------------------------------------------------------------------------
# The op counter: twins of tests/test_hlo_analyzer.py
# ---------------------------------------------------------------------------


def test_counter_plain_matmul():
    x, w = torch.zeros(128, 256), torch.zeros(256, 64)
    got = count(lambda: x @ w)
    assert got["flops"] == 2 * 128 * 256 * 64
    c = jax.jit(lambda a, b: a @ b).lower(jnp.zeros((128, 256)),
                                          jnp.zeros((256, 64))).compile()
    assert got["flops"] == pytest.approx(analyze_hlo(c.as_text())["flops"],
                                         rel=0.01)


def test_counter_batched_einsum():
    a, b = torch.zeros(4, 32, 16), torch.zeros(4, 16, 8)
    got = count(lambda: torch.einsum("bik,bkj->bij", a, b))
    assert got["flops"] == pytest.approx(2 * 4 * 32 * 16 * 8, rel=0.01)


def test_counter_loop_counts_each_trip():
    x, w = torch.zeros(64, 64), torch.zeros(64, 64)

    def f(c):
        for _ in range(7):
            c = torch.tanh(c @ w)
        return c

    got = count(f, x)["flops"]
    per_iter = 2 * 64 * 64 * 64
    assert 7 * per_iter <= got < 7 * per_iter * 1.5


def test_counter_nested_loop():
    x, w = torch.zeros(32, 32), torch.zeros(32, 32)

    def f(c):
        for _ in range(5):
            for _ in range(3):
                c = c @ w
        return c

    got = count(f, x)["flops"]
    per = 2 * 32 * 32 * 32
    assert 15 * per <= got < 15 * per * 1.5


def test_counter_bytes_of_an_elementwise_chain():
    """Eager traffic: each of tanh, *2 and +1 reads and writes the array,
    so 6x its bytes, where XLA's one fusion moves 2x."""
    x = torch.zeros(1024, 1024)
    got = count(lambda: torch.tanh(x) * 2 + 1)
    nbytes = 1024 * 1024 * 4
    assert nbytes * 1.5 <= got["bytes"] <= nbytes * 6


def _qwen_flops(s):
    """Twin of test_system.py::test_sparsity_reduces_flops: JAX's
    analyze_hlo of the jitted forward and the port's count of its eager
    one, on the same params (``params_from_jax``)."""
    kw = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
              d_ff=512, vocab_size=128)
    fmt = "compressed_xla" if s else "dense"
    jcfg = j_smoke_config("qwen2-7b").with_(**kw, sparsity=JSparsityConfig(
        sparsity=s, m=None, tile=None, format=fmt, min_dim=32))
    tcfg = smoke_config("qwen2-7b").with_(**kw, sparsity=SparsityConfig(
        sparsity=s, m=None, tile=None, format=fmt, min_dim=32))
    jp, _ = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    batch = {"tokens": jnp.ones((2, 32), jnp.int32)}
    txt = jax.jit(jreg.forward_fn(jcfg)).lower(jp, batch).compile().as_text()
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    with torch.no_grad():
        got = count(treg.forward_fn(tcfg), tp,
                    {"tokens": torch.ones((2, 32), dtype=torch.int32)})
    return analyze_hlo(txt)["flops"], got, tp


@pytest.fixture(scope="module")
def world1():
    """A world-1 gloo group from a ``HashStore`` (no network), destroyed
    after the module where this fixture started it."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    assert dist.get_world_size() == 1
    yield
    if started:
        dist.destroy_process_group()


SHARD = torch.ones(1024)  # 4096 bytes


def _all_gather():
    import torch.distributed as dist

    dist.all_gather([torch.empty_like(SHARD)], SHARD)


def _all_reduce():
    import torch.distributed as dist

    dist.all_reduce(SHARD.clone())


def _reduce_scatter():
    import torch.distributed as dist

    dist.reduce_scatter(torch.empty_like(SHARD), [SHARD.clone()])


@pytest.mark.parametrize("kind,fn", [("all-gather", _all_gather),
                                     ("all-reduce", _all_reduce),
                                     ("reduce-scatter", _reduce_scatter)])
def test_counter_counts_a_collective_once(world1, kind, fn):
    """A collective counts max(what it reads, what it writes) once: the
    output buffers a c10d op takes as arguments are not read.  Into one part
    an all-gather counts its shard (n shards into n parts), a reduce-scatter
    its one input shard, an all-reduce its buffer; the test file of the
    layout's training counts the same over 2 ranks."""
    got = count(fn)
    assert got["collective_by_kind"] == {kind: 4096}
    assert got["collective_counts"] == {kind: 1}


def test_sparsity_reduces_counted_flops_as_jax():
    j0, t0, _ = _qwen_flops(0.0)
    j50, t50, tp = _qwen_flops(0.5)
    for j, t in ((j0, t0), (j50, t50)):
        assert t["flops"] == pytest.approx(j, rel=0.15)
    assert t50["flops"] / t0["flops"] == pytest.approx(j50 / j0, abs=0.05)
    assert t50["flops"] < 0.75 * t0["flops"]
    # the 14 compressed linears (q, k, v, o, gate, up, down of 2 layers),
    # each once, by linear_work: 2 FLOPs a kept row an output a row
    linears = [leaf for path, leaf in leaves_with_path(tp)
               if path[-1] == "values"]
    want = sum(2 * 64 * v.shape[1] * v.shape[2] * v.shape[3] * v.shape[0]
               for v in linears)  # [L, n_tiles, k, T] stacks, 64 rows
    lin = t50["by_kernel"]["linear"]
    assert (lin["calls"], lin["flops"]) == (14, want)
    assert "linear" not in t0["by_kernel"]


# ---------------------------------------------------------------------------
# One call of each kernel family, counted by hand
# ---------------------------------------------------------------------------


def _work(fn, *args, **kw):
    with torch.no_grad():
        got = count(fn, *args, **kw)
    (family, k), = got["by_kernel"].items()
    assert k["calls"] == 1
    assert (got["flops"], got["bytes"]) == (k["flops"], k["bytes"])
    return family, Work(k["flops"], k["bytes"])


def _linear_case():
    """x [3, 5, 64] (15 rows), 2 tiles of T 64 keeping 16 rows each: tile 0
    rows 0-15, tile 1 rows 8-23, so 24 distinct rows of x are read."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64), dtype=np.float32))
    values = torch.from_numpy(rng.standard_normal((2, 16, 64),
                                                  dtype=np.float32))
    idx = torch.stack([torch.arange(16), torch.arange(8, 24)]).to(torch.int32)
    return x, values, idx


# 15 rows x 24 kept columns, values, idx, 15 x 128 outputs, f32; 2 FLOPs a
# kept row (16) an output (128) a row (15)
LINEAR_WORK = Work(2 * 15 * 16 * 128,
                   4 * (15 * 24 + 2 * 16 * 64 + 2 * 16 + 15 * 128))


def test_linear_family_counts_by_hand_under_every_plan():
    x, values, idx = _linear_case()
    params = {"values": values, "idx": idx}
    calls = [lambda: lin_ops.colwise_nm_matmul(x, values, idx),
             lambda: lin_ops.colwise_nm_matmul_tiled(x, values, idx),
             lambda: forward_compressed_xla(x, values, idx)]
    for impl in ("compressed_xla", "compressed_pallas", "compressed_tiled"):
        def forced(impl=impl):
            with dispatch.force_scope(linear=impl):
                return linear_apply(params, x)
        calls.append(forced)
    for fn in calls:
        assert _work(fn) == ("linear", LINEAR_WORK)


def _conv_case():
    """A CNHW map [C 2, B 1, 4, 4], a 3x3 conv (stride 1, pad 1) to O 8 in
    one tile keeping rows 0, 2, 4, 6 of K = 18: taps 0-3 of channel 0."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 1, 4, 4), dtype=np.float32))
    values = torch.from_numpy(rng.standard_normal((1, 4, 8), dtype=np.float32))
    idx = torch.tensor([[0, 2, 4, 6]], dtype=torch.int32)
    return x, values, idx


# Taps (0,0), (0,1), (0,2) read map rows 0-2 (columns 0-2, 0-3, 1-3) and
# tap (1,0) rows 0-3 (columns 0-2): 12 + 12 - 9 = 15 elements of channel 0.
# Then values (32 f32), idx (4 int32) and the [8, 16] output; 2 FLOPs a
# kept row (4) an output (8) a position (16)
CONV_WORK = Work(2 * 8 * 4 * 16, 15 * 4 + 32 * 4 + 4 * 4 + 8 * 16 * 4)
GEO = dict(kh=3, kw=3, stride=1, pad=1)


def test_conv_families_count_by_hand_under_every_plan():
    """#5 and #6 and every other conv plan: one count, ``conv_work``."""
    x, values, idx = _conv_case()
    calls = [lambda: conv_ops.conv2d_fused(x, values, idx, v=8, **GEO),
             lambda: conv_ops.conv2d_fused_banded(x, values, idx, v=8, hb=2,
                                                  **GEO),
             lambda: conv_ops.conv2d_two_kernel(x, values, idx, v=8, **GEO),
             lambda: conv_ops.conv2d_two_kernel_pipelined(x, values, idx, v=8,
                                                          **GEO),
             lambda: conv_ops.conv2d_xla_ref(x, values, idx, v=8, **GEO)]
    for impl in ("im2col_sparse_xla", "im2col_sparse_pallas",
                 "fused_sparse_pallas", "fused_banded_pallas",
                 "two_kernel_pipelined"):
        calls.append(lambda impl=impl: conv_ops.conv2d_sparse(
            x, values, idx, v=8, impl=impl, **GEO))
    for fn in calls:
        assert _work(fn) == ("conv", CONV_WORK)


def test_pack_family_counts_by_hand():
    """#4: every element of the [2, 1, 4, 4] map is some tap's (32), and 2
    strips of 9 taps x 2 channels x V 8 are written (288); no FLOPs."""
    x, _, _ = _conv_case()
    assert _work(lambda: im2col_pack(x, v=8, **GEO)) == (
        "pack", Work(0, (32 + 288) * 4))


@pytest.mark.parametrize("pipelined", [False, True])
def test_strip_families_count_by_hand(pipelined):
    """#2 and #3: 2 strips of K 18 x V 8; the kept rows (4) of each strip,
    values, idx and the [8, 16] output; 2 FLOPs a kept row an output a
    column."""
    x, values, idx = _conv_case()
    strips = im2col_pack(x, v=8, **GEO)
    fn = (lin_ops.colwise_nm_matmul_strips_pipelined if pipelined
          else lin_ops.colwise_nm_matmul_strips)
    want = Work(2 * 8 * 4 * 16,
                (2 * 4 * 8 + 32 + 4 + 8 * 2 * 8) * 4)
    assert _work(lambda: fn(strips, values, idx)) == ("strips", want)


def test_flash_family_counts_by_hand():
    """#7: q [1, 5, 4, 8] over k/v [1, 7, 2, 8], causal from the top left:
    1 + 2 + 3 + 4 + 5 = 15 pairs, 4 * H * D FLOPs a pair; Q, K, V, O."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 5, 4, 8), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 7, 2, 8),
                                                 dtype=np.float32))
            for _ in range(2))
    want = Work(4 * 4 * 8 * 15, (2 * 5 * 4 * 8 + 2 * 7 * 2 * 8) * 4)
    assert _work(lambda: flash_attention(q, k, v, causal=True)) == (
        "flash", want)


def test_paged_family_counts_by_hand_under_every_plan():
    """#8: 2 sequences of 5 and 9 cached rows (pages of 4, tables of 3),
    one new token each, 4 heads on 2 KV heads of 8: the valid K/V rows (14
    a head), q, the new K/V and the output, the tables and lengths; QK and
    PV over 6 and 10 rows, 4 * H * D FLOPs a row."""
    rng = np.random.default_rng(3)

    def f32(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32))

    q, kn, vn = f32(2, 1, 4, 8), f32(2, 1, 2, 8), f32(2, 1, 2, 8)
    kp, vp = f32(7, 4, 2, 8), f32(7, 4, 2, 8)
    tables = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    lengths = torch.tensor([5, 9], dtype=torch.int32)
    want = Work(4 * 4 * 8 * (6 + 10),
                (2 * 14 * 2 * 8 + 2 * 64 + 32 + 32) * 4 + 4 * (6 + 2))
    for impl in ("paged_attn_ref", "paged_attn_pallas"):
        assert _work(lambda: paged_attention(
            q, kn, vn, kp, vp, tables, lengths, page_size=4,
            impl=impl)) == ("paged", want)


def test_counts_read_no_data_on_meta():
    """On ``meta`` a count takes the most the shapes allow: every row kept,
    the whole map read."""
    x, values, idx = (t.to("meta") for t in _linear_case())
    assert _work(lambda: forward_compressed_xla(x, values, idx)) == (
        "linear", Work(LINEAR_WORK.flops,
                       LINEAR_WORK.bytes + 4 * 15 * (32 - 24)))


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=16,
              format="compressed_xla")


def _grads(cfg, params, toks):
    lfn = treg.loss_fn(cfg)
    (loss, _), grads = value_and_grad(lambda p: lfn(p, {"tokens": toks}),
                                      params)
    return loss, grads


def test_remat_gradients_equal_and_match_jax():
    jcfg = j_smoke_config("smollm-360m").with_(
        sparsity=JSparsityConfig(**SPARSE), remat=True)
    tcfg = smoke_config("smollm-360m").with_(sparsity=SparsityConfig(**SPARSE))
    jp, _ = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(4).integers(0, 503, (2, 16)).astype(np.int32)
    jgrads = jax.grad(lambda p: jreg.loss_fn(jcfg)(
        p, {"tokens": jnp.asarray(toks)})[0], allow_int=True)(jp)
    jflat = dict((jax.tree_util.keystr(p), np.asarray(g)) for p, g in
                 jax.tree_util.tree_flatten_with_path(jgrads)[0])
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    t_toks = torch.from_numpy(toks)
    loss0, g0 = _grads(tcfg, tp, t_toks)
    for policy in ("nothing", "dots"):
        loss, g = _grads(tcfg.with_(remat=True, remat_policy=policy), tp,
                         t_toks)
        assert torch.equal(loss, loss0), policy
        for (path, a), (_, b) in zip(leaves_with_path(g),
                                     leaves_with_path(g0)):
            if a is None:
                continue
            assert torch.equal(a, b), (policy, keystr(path))
            np.testing.assert_allclose(a.numpy(), jflat[keystr(path)],
                                       rtol=F32_TOL, atol=F32_TOL)


def test_remat_adds_the_recomputed_forward_to_the_step():
    """Under remat "nothing" the train step counts each block's forward
    twice: the FLOPs rise by the blocks' forward, exactly where the
    recompute runs to the block's end (early stop off); by default it stops
    once the backward has what it saved, so by less.  Under "dots" the rise
    is smaller still: the matrix products are kept, not recomputed."""
    tcfg = smoke_config("smollm-360m").with_(sparsity=SparsityConfig(**SPARSE))
    params = treg.init_params(tcfg, 0, device="cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(5).integers(
        0, 503, (2, 16)).astype(np.int32))}

    def step_flops(cfg):
        step = steps.make_train_step(cfg, AdamWConfig())
        opt = adamw_init(params)
        return count(step, params, opt, batch)["flops"]

    base = step_flops(tcfg)
    full = step_flops(tcfg.with_(remat=True))
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        whole = step_flops(tcfg.with_(remat=True))
    dots = step_flops(tcfg.with_(remat=True, remat_policy="dots"))
    # the blocks' forward: the scoring forward less what runs outside them
    from repro_torch.models import lm as tlm
    from repro_torch.models.blocks import layer_params

    h = torch.zeros(2, 16, 64)
    pos = torch.arange(16)[None].expand(2, 16)
    with torch.no_grad():
        blocks = count(lambda: [tlm.block_apply(
            layer_params(params["layers"], l), tcfg, h, positions=pos,
            mrope_positions=None) for l in range(tcfg.n_layers)])
    assert whole - base == blocks["flops"]
    assert 0.5 * blocks["flops"] < full - base <= blocks["flops"]
    assert base < dots < full


# ---------------------------------------------------------------------------
# The counts against the formulas chip_smoke.py and tune.py kept before them
# ---------------------------------------------------------------------------

_HBM, _PEAK = 3.35e12, {torch.float32: 67e12, torch.bfloat16: 989e12}


def _former_bound_ms(n_bytes, flops, dtype):
    t_bytes = n_bytes / _HBM * 1e3
    t_ops = flops / _PEAK[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _former_touched_elems(shape, kh, kw, stride, pad, rows):
    from repro_torch.kernels.im2col_pack import out_size, tap_coords

    c, b, h, w = shape
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    p = torch.arange(b * ho * wo)
    mark = torch.zeros(c * b * h * w, dtype=torch.bool)
    rows = rows.long()
    for tap in torch.unique(rows // c).tolist():
        chans = torch.unique(rows[rows // c == tap] % c)
        valid, bc, ihc, iwc = tap_coords(
            p, ikh=tap // kw, ikw=tap % kw, stride=stride, pad=pad, b=b, h=h,
            w=w, ho=ho, wo=wo)
        pos = ((bc * h + ihc) * w + iwc)[valid]
        mark[(chans[:, None] * (b * h * w) + pos[None, :]).reshape(-1)] = True
    return int(mark.sum())


def _former_pack_bytes(c, b, h, w, k, stride, pad, v, itemsize):
    from repro_torch.kernels.im2col_pack import out_size

    ho, wo = out_size(h, k, stride, pad), out_size(w, k, stride, pad)
    hit = np.zeros((h, w), dtype=bool)
    for ikh in range(k):
        ih = np.arange(ho) * stride - pad + ikh
        for ikw in range(k):
            iw = np.arange(wo) * stride - pad + ikw
            hit[np.ix_(ih[(ih >= 0) & (ih < h)], iw[(iw >= 0) & (iw < w)])] = True
    n_strips = -(-b * ho * wo // v)
    return (int(hit.sum()) * c * b + n_strips * k * k * c * v) * itemsize


def test_counts_equal_the_former_chip_smoke_formulas():
    """Each ``bound_ms`` that ``chip_smoke.py`` prints now comes from
    ``roofline/kernels.py``; here the counts meet the formulas it kept
    before, bit for bit: resnet-tiny's five pruned convs (at batch 8: the
    same formula as at the card's 256) for the conv, pack and strip
    families, f32 and bf16; the linear at smollm-360m's and zamba2-7b's
    widths and the card's rows; the paged and flash cases at the card's
    shapes."""
    from repro_torch.configs import get_vision_config
    from repro_torch.core.sparse_linear import linear_init
    from repro_torch.kernels.flash_attn.tune import paged_problem
    from repro_torch.kernels.im2col_pack import out_size
    from repro_torch.models.vision import _block_strides, vision_init
    from repro_torch.roofline import kernels as K

    cfg = get_vision_config("resnet-tiny")
    params = vision_init(cfg, 0, device="cpu")
    rng = np.random.default_rng(6)
    h = w = cfg.image_hw[0]
    convs = []
    for block, (_si, _bi, stride, c_in, c_out) in zip(params["blocks"],
                                                      _block_strides(cfg)):
        ho = out_size(h, 3, stride, 1)
        for name, c, hh, k, s, p in (("conv1", c_in, h, 3, stride, 1),
                                     ("conv2", c_out, ho, 3, 1, 1),
                                     ("proj", c_in, h, 1, stride, 0)):
            if "values" in block.get(name, {}):
                convs.append((block[name], c, hh, k, s, p))
        h = w = ho
    assert len(convs) == 5
    for layer, c, hh, k, s, p in convs:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.standard_normal((c, 8, hh, hh),
                                                     dtype=np.float32)).to(dtype)
            values, idx = layer["values"].to(dtype), layer["idx"]
            n_tiles, k_kept, tile = values.shape
            o, isz = n_tiles * tile, x.element_size()
            n_pos = 8 * out_size(hh, k, s, p) ** 2
            conv_bytes = (_former_touched_elems(x.shape, k, k, s, p,
                                                torch.unique(idx)) * isz
                          + values.numel() * isz + idx.numel() * 4
                          + o * n_pos * isz)
            assert K.bound_ms(K.conv_work(x, values, idx, kh=k, kw=k,
                                          stride=s, pad=p), dtype) == \
                _former_bound_ms(conv_bytes, 2 * o * k_kept * n_pos, dtype)
            assert K.bound_ms(K.pack_work(x, k, k, s, p, 128), dtype) == \
                _former_bound_ms(_former_pack_bytes(c, 8, hh, hh, k, s, p, 128,
                                                    isz), 0, dtype)
            strips = im2col_pack(x, kh=k, kw=k, stride=s, pad=p, v=128)
            ns = strips.shape[0]
            strip_bytes = (ns * torch.unique(idx).numel() * 128 * isz
                           + values.numel() * isz + idx.numel() * 4
                           + o * ns * 128 * isz)
            assert K.bound_ms(K.strips_work(strips, values, idx, n_pos=n_pos),
                              dtype) == _former_bound_ms(
                strip_bytes, 2 * o * k_kept * n_pos, dtype)
    gen = torch.Generator().manual_seed(0)
    for d_in, d_out, tile, dtype in ((960, 2560, None, torch.float32),
                                     (2560, 960, None, torch.float32),
                                     (960, 2560, 8, torch.float32),
                                     (960, 2560, None, torch.bfloat16),
                                     (3584, 14576, None, torch.float32)):
        layer = linear_init(gen, d_in, d_out, SparsityConfig(
            sparsity=0.5, m=None, tile=tile, min_dim=64,
            format="compressed_pallas"), dtype=dtype, device="cpu")
        values, idx = layer["values"], layer["idx"]
        n_tiles, k_kept, t = values.shape
        isz = values.element_size()
        for rows in (4, 256, 1024, 8192):
            nb = (rows * torch.unique(idx).numel() * isz + values.numel() * isz
                  + idx.numel() * 4 + rows * n_tiles * t * isz)
            assert K.bound_ms(K.linear_work(rows, values, idx, d_in),
                              dtype) == _former_bound_ms(
                nb, 2 * rows * k_kept * n_tiles * t, dtype)
    for b, sq, lengths, dtype in ((4, 1, [0, 16, 37, 150], torch.float32),
                                  (8, 4, [5, 99, 160, 1, 64, 33, 0, 120],
                                   torch.bfloat16)):
        q, kn, vn, _, _, tables, ln = paged_problem(
            b, sq, lengths, dtype, "cpu", 0, h=15, kv=5, d=64, ps=16,
            n_max=10)
        rows = [min(int(n), 160) for n in ln.tolist()]
        nb = ((2 * sum(rows) * 5 * 64 + 2 * q.numel() + kn.numel()
               + vn.numel()) * q.element_size() + 4 * (tables.numel() + b))
        assert K.bound_ms(K.paged_work(q, kn, vn, tables, ln, 16), dtype) == \
            _former_bound_ms(nb, sum(4 * 15 * 64 * (n + sq) * sq
                                     for n in rows), dtype)
    for b, sq, sk, h, kv, d, causal in ((4, 2048, 2048, 15, 5, 64, True),
                                        (1, 16, 48, 1, 1, 16, False),
                                        (2, 1500, 1500, 12, 12, 64, False),
                                        (1, 130, 130, 5, 2, 18, True)):
        for dtype in (torch.float32, torch.bfloat16):
            pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
                     else sq * sk)
            nb = (2 * b * sq * h * d + 2 * b * sk * kv * d) * dtype.itemsize
            assert K.bound_ms(K.flash_work(b, sq, sk, h, kv, d, causal,
                                           dtype.itemsize), dtype) == \
                _former_bound_ms(nb, 4 * b * h * d * pairs, dtype)
