"""The dense attention LM on params laid out on a data x model mesh, on the
CPU.

One world of 4 gloo ranks is spawned for the module
(``tests/_torch_layout_workers.py``, joined through a file store: no
network).  It runs the meshes (data 2, model 2) and (data 1, model 4).  On
each, every rank lays out (``launch.steps.distribute_tree``) the same
params, made with numpy from a seed, and runs on its shards the scoring
loss and forward, a prefill and 4 decode steps (a scalar position, then a
per-sequence one, alternately).

* Two smoke configs of two layers: qwen2-7b's (untied unembedding, q/k/v
  biases) with 8 q and 4 KV heads, which both model axes divide, and
  smollm-360m's ratio, 15 q and 5 KV heads of 8: the q heads are padded to
  16, and the model axis splits the KV heads inside a head (20 of 40
  columns at model 2, 10 at model 4), so each q head reads its KV head by
  JAX's map.  Each in the dense, masked, compressed and REDUCE formats (4
  groups: two a rank at model 2, one at model 4), and smollm's compressed
  one also under ``attn_impl="pallas"`` (the flash kernel's plain version
  on the CPU).
* Each rank's global outputs (``sharding.full``) against the port with
  whole params on one rank within 1e-5 of max|logit| (and of max|k|, max|v|
  for the caches), the NLL within 1e-5 relative; and against JAX's
  unsharded functions on the same params within 1e-4 (JAX's sharded step
  is not a reference: ROADMAP queue 3).
* Each rank's local shapes of every param and cache leaf equal the shard
  that JAX's ``resolve_spec`` gives, on JAX's spec trees, for the mesh's
  sizes.
* A laid-out tree of another family (MoE, xLSTM) raises naming slice 25.
  Training on laid-out params is held in ``test_torch_layout_train.py``.

The layout's numbers differ from whole params by rounding only: column
slices of a product, the row-parallel sums over the model axis and the
NLL's mean over the data ranks.
"""
import multiprocessing
import pickle
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_layout_workers as workers
from repro import dispatch as jdispatch
from repro.configs import smoke_config as j_smoke_config
from repro.core.pruning import SparsityConfig as JSparsityConfig
from repro.models import registry as jreg
from repro.sharding import RULES as J_RULES
from repro.sharding import resolve_spec as j_resolve_spec
from repro_torch import dispatch
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import SparsityConfig
from repro_torch.models import registry as treg

WORLD = 4
MESHES = [(2, 2), (1, 4)]
FORMATS = {
    "dense": None,
    "masked": dict(sparsity=0.5, min_dim=16, format="masked"),
    "compressed": dict(sparsity=0.5, min_dim=16, format="compressed_xla"),
    "reduce": dict(sparsity=0.5, min_dim=16, format="compressed_xla",
                   shard_local_reduce=True, reduce_groups=4),
}
ARCHS = {"divides": ("qwen2-7b", dict(n_heads=8, n_kv_heads=4, head_dim=8)),
         "split": ("smollm-360m", dict(n_heads=15, n_kv_heads=5,
                                       head_dim=8))}
CASES = [(arch, fmt, "naive", mesh) for mesh in MESHES for arch in ARCHS
         for fmt in FORMATS] + [("split", "compressed", "pallas", mesh)
                                for mesh in MESHES]
B, S_SCORE, S_PROMPT, N_DECODE = 4, 16, 8, 4
VOCAB = 503
PORT_TOL = 1e-5   # of max|logit| (max|k|, max|v|), whole params on one rank
JAX_TOL = 1e-4    # of max|logit|, JAX's unsharded functions
NLL_PORT_RTOL = 1e-5
NLL_JAX_RTOL = 1e-4
SPAWN_TIMEOUT_S = 120


def _key(case):
    arch, fmt, impl, mesh = case
    return f"{arch}-{fmt}-{impl}-{mesh[0]}x{mesh[1]}"


def _cfgs(arch, fmt, tp, impl="naive"):
    """(JAX's config, the port's) of a case."""
    name, over = ARCHS[arch]
    jc = j_smoke_config(name).with_(**over, tp=tp, attn_impl=impl)
    tc = smoke_config(name).with_(**over, tp=tp, attn_impl=impl)
    kw = FORMATS[fmt]
    if kw is None:
        return jc, tc
    return (jc.with_(sparsity=JSparsityConfig(**kw)),
            tc.with_(sparsity=SparsityConfig(**kw)))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def numpy_params(tcfg, seed):
    """A params tree of the config's layout, every leaf drawn with numpy
    from ``seed``: weights N(0, 1/d_in), the compressed layers' kept rows
    sorted and distinct within d_in (within a group for REDUCE), masks of
    one half, norms near 1."""
    rng = np.random.default_rng(seed)
    shapes, _ = treg.abstract_params(tcfg)
    flat = _flat(shapes)
    d_in = {"q": tcfg.d_model, "k": tcfg.d_model, "v": tcfg.d_model,
            "gate": tcfg.d_model, "up": tcfg.d_model, "down": tcfg.d_ff,
            "o": tcfg.padded_heads * tcfg.resolved_head_dim}
    out = {}
    for path, t in flat.items():
        shape, leaf = tuple(t.shape), path[-1]
        if leaf == "idx":
            rows = [np.sort(rng.choice(d_in[path[-2]], shape[-1],
                                       replace=False))
                    for _ in range(int(np.prod(shape[:-1])))]
            a = np.stack(rows).reshape(shape).astype(np.int32)
        elif leaf == "idx_r":
            m = d_in[path[-2]] // shape[-2]
            rows = [np.sort(rng.choice(m, shape[-1], replace=False))
                    for _ in range(int(np.prod(shape[:-1])))]
            a = np.stack(rows).reshape(shape).astype(np.int32)
        elif leaf == "mask":
            a = rng.random(shape) < 0.5
        elif leaf in ("w", "values", "values_r"):
            a = rng.standard_normal(shape) / np.sqrt(d_in[path[-2]])
        elif leaf in ("embed", "unembed"):
            a = 0.5 * rng.standard_normal(shape)
        elif leaf == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:  # biases
            a = 0.1 * rng.standard_normal(shape)
        out[path] = a if a.dtype.kind in "bi" else a.astype(np.float32)
    for path in out:
        if path[-1] == "mask":
            w = path[:-1] + ("w",)
            out[w] = (out[w] * out[path]).astype(np.float32)
    return _unflat(out)


def _inputs():
    rng = np.random.default_rng(40)
    return {"score": rng.integers(0, VOCAB, (B, S_SCORE)).astype(np.int32),
            "prompt": rng.integers(0, VOCAB, (B, S_PROMPT)).astype(np.int32),
            "feeds": [rng.integers(0, VOCAB, (B, 1)).astype(np.int32)
                      for _ in range(N_DECODE)]}


def _positions():
    return [S_PROMPT + i if i % 2 == 0
            else np.full((B,), S_PROMPT + i, np.int32)
            for i in range(N_DECODE)]


def port_whole(tcfg, params, inp) -> dict:
    """The same calls as the ranks make, on whole params."""
    p = params_from_jax(params, device="cpu")
    score = {"tokens": torch.from_numpy(inp["score"])}
    out = {}
    with torch.no_grad():
        loss, metrics = treg.loss_fn(tcfg)(p, score)
        out["nll"] = float(metrics["nll"])
        out["logits"] = treg.forward_fn(tcfg)(p, score).numpy()
        pl, pc = treg.prefill_fn(tcfg)(p, {"tokens": torch.from_numpy(
            inp["prompt"])})
        out["prefill_logits"] = pl.numpy()
        out["prefill_cache"] = {k: v.numpy() for k, v in pc.items()}
        cache = treg.cache_init_fn(tcfg, B, S_PROMPT + N_DECODE,
                                   device="cpu")()
        for k, v in cache.items():
            v[:, :, :S_PROMPT] = pc[k]
        out["decode_logits"] = []
        for feed, pos in zip(inp["feeds"], _positions()):
            dl, cache = treg.decode_fn(tcfg)(p, cache, torch.from_numpy(feed),
                                             pos)
            out["decode_logits"].append(dl.numpy())
        out["decode_cache"] = {k: v.numpy() for k, v in cache.items()}
    return out


def jax_unsharded(jcfg, params, inp) -> dict:
    """JAX's unsharded loss, forward, prefill and decode steps on the same
    params, jitted as one function (one compile a config)."""
    @jax.jit
    def run(p, score, prompt, feeds):
        _, metrics = jreg.loss_fn(jcfg)(p, {"tokens": score})
        logits = jreg.forward_fn(jcfg)(p, {"tokens": score})
        pl, pc = jreg.prefill_fn(jcfg)(p, {"tokens": prompt})
        cache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, N_DECODE), (0, 0),
                                (0, 0))) for k, v in pc.items()}
        steps = []
        for i, pos in enumerate(_positions()):
            dl, cache = jreg.decode_fn(jcfg)(p, cache, feeds[i],
                                             jnp.asarray(pos))
            steps.append(dl)
        return metrics["nll"], logits, pl, pc, steps, cache

    nll, logits, pl, pc, steps, cache = run(
        params, jnp.asarray(inp["score"]), jnp.asarray(inp["prompt"]),
        jnp.asarray(np.stack(inp["feeds"])))
    return {"nll": float(nll), "logits": np.asarray(logits),
            "prefill_logits": np.asarray(pl),
            "prefill_cache": {k: np.asarray(v) for k, v in pc.items()},
            "decode_logits": [np.asarray(dl) for dl in steps],
            "decode_cache": {k: np.asarray(v) for k, v in cache.items()}}


def _spawn(outdir: Path):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=workers.layout_worker,
                         args=(r, WORLD, str(outdir))) for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


def _join(procs, outdir: Path, t0: float):
    try:
        for p in procs:
            p.join(max(1.0, SPAWN_TIMEOUT_S - (time.time() - t0)))
            assert p.exitcode is not None, \
                f"a rank hung past {SPAWN_TIMEOUT_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(WORLD):
        path = outdir / f"rank{r}.pkl"
        assert path.exists(), (r, procs[r].exitcode)
        res = pickle.loads(path.read_bytes())
        assert "error" not in res, res.get("error")
        out.append(res)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(case -> (the port's whole-params outputs, JAX's), each rank's
    results).  The port's and JAX's references run while the ranks do."""
    d = tmp_path_factory.mktemp("layout")
    inp = _inputs()
    params = {(arch, fmt): numpy_params(_cfgs(arch, fmt, 2)[1], seed)
              for seed, (arch, fmt) in enumerate(
                  (a, f) for a in ARCHS for f in FORMATS)}
    cases = {_key(c): {"cfg": _cfgs(c[0], c[1], c[3][1], c[2])[1],
                       "mesh": c[3], "params": (c[0], c[1])} for c in CASES}
    refusal = {"moe": smoke_config("olmoe-1b-7b").with_(tp=2),
               "xlstm": smoke_config("xlstm-350m")}
    (d / "cases.pkl").write_bytes(pickle.dumps({
        "meshes": MESHES, "cases": cases, "params": params, "inputs": inp,
        "refusal_mesh": (2, 2), "refusal_cfgs": refusal}))
    t0 = time.time()
    procs = _spawn(d)
    # fresh profile DBs: each package's heuristic, the plain versions
    dispatch.set_db(dispatch.ProfileDB(path=d / "profile.json"))
    jdispatch.set_db(jdispatch.ProfileDB(path=str(d / "jax.json")))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # smoke widths: the thread pool only costs
    try:
        jax_out = {k: jax_unsharded(_cfgs(*k, 2)[0], params[k], inp)
                   for k in params}
        refs = {_key(c): (port_whole(cases[_key(c)]["cfg"],
                                     params[c[:2]], inp), jax_out[c[:2]])
                for c in CASES}
    finally:
        torch.set_num_threads(threads)
        dispatch.set_db(None)
        jdispatch.set_db(None)
        ranks = _join(procs, d, t0)
    return refs, ranks


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _hold(res, ref, tol, nll_rtol):
    assert abs(res["nll"] - ref["nll"]) <= nll_rtol * abs(ref["nll"])
    _close(res["logits"], ref["logits"], tol, "logits")
    _close(res["prefill_logits"], ref["prefill_logits"], tol,
           "prefill logits")
    for i, (g, w) in enumerate(zip(res["decode_logits"],
                                   ref["decode_logits"])):
        _close(g, w, tol, f"decode step {i}")
    for k in ("k", "v"):
        _close(res["prefill_cache"][k], ref["prefill_cache"][k], tol,
               f"prefill cache {k}")
        _close(res["decode_cache"][k], ref["decode_cache"][k], tol,
               f"decode cache {k}")


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_layout_matches_whole_params(runs, case):
    """Every rank's global outputs against the port on whole params."""
    refs, ranks = runs
    for res in ranks:
        _hold(res[_key(case)], refs[_key(case)][0], PORT_TOL, NLL_PORT_RTOL)


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_layout_matches_jax_unsharded(runs, case):
    """Every rank's global outputs against JAX's unsharded functions (naive
    attention, also for the port's "pallas" cases)."""
    refs, ranks = runs
    for res in ranks:
        _hold(res[_key(case)], refs[_key(case)][1], JAX_TOL, NLL_JAX_RTOL)


def _shard_shape(shape, entries, sizes):
    out = []
    for dim, part in zip(shape, tuple(entries) + (None,) * len(shape)):
        axes = () if part is None else (part if isinstance(part, tuple)
                                        else (part,))
        out.append(dim // int(np.prod([sizes[a] for a in axes])))
    return tuple(out)


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_shards_are_jax_resolved(runs, case):
    """Each rank's local shape of every param and cache leaf is the shard
    JAX's ``resolve_spec`` gives on JAX's spec trees."""
    _, ranks = runs
    arch, fmt, impl, mesh = case
    jc = _cfgs(arch, fmt, mesh[1], impl)[0]

    class FakeMesh:
        shape = {"data": mesh[0], "model": mesh[1]}

    shapes, specs = jreg.abstract_params(jc)
    specs = _flat_specs(specs)
    want = {p: _shard_shape(a.shape, j_resolve_spec(
        tuple(a.shape), specs[p], J_RULES, FakeMesh), FakeMesh.shape)
        for p, a in _flat(shapes).items()}
    cache = jreg.abstract_cache(jc, B, S_PROMPT + N_DECODE)
    cspecs = jreg.cache_specs(jc, cache)
    cwant = {(k,): _shard_shape(cache[k].shape, j_resolve_spec(
        tuple(cache[k].shape), cspecs[k], J_RULES, FakeMesh),
        FakeMesh.shape) for k in cache}
    for res in ranks:
        got = res[_key(case)]
        assert got["param_shapes"] == want
        assert got["cache_shapes"] == cwant
    # the layout splits something on every mesh: the rank holds less
    assert any(w != tuple(a.shape) for w, a in zip(
        want.values(), _flat(shapes).values()))


def _flat_specs(tree, prefix=()):
    """{path: spec} of a JAX spec tree (a tuple is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("what,slice_no", [("moe", 25), ("xlstm", 25)])
def test_laid_out_tree_refused_naming_the_slice(runs, what, slice_no):
    _, ranks = runs
    for res in ranks:
        msg = res["refusals"][what]
        assert msg is not None and f"slice {slice_no}" in msg, msg
