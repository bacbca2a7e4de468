"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the CPU.

Its cells run in one subprocess, since the fake process group of 256 ranks
that each step runs in is process-global: smollm-360m ``decode_32k`` and
``train_4k`` and olmoe-1b-7b ``train_4k --moe shard_map`` on the single-pod
mesh, a ``long_500k`` skip, and a cell that fails.  Each record holds the
keys of JAX's record, read from JAX's ``run_cell``/``analyze`` source (its
dry run itself is a known failure here and is not run), and its model
FLOPs equal JAX's ``model_flops_for``.  The train step counts at least its
rank's share of the model FLOPs, and its gradient all-reduce moves exactly
the float params' bytes plus the three averaged metrics.  The decode cell
runs on rank 0's shards of the params, cache and tokens laid out by
``serve_shardings``: its argument bytes are those shards' bytes, and its
layout's collectives are counted.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.roofline.analysis import model_flops_for as j_model_flops_for

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

CELLS = {
    "decode": ["--arch", "smollm-360m", "--shape", "decode_32k"],
    "train": ["--arch", "smollm-360m", "--shape", "train_4k"],
    "moe": ["--arch", "olmoe-1b-7b", "--shape", "train_4k", "--moe",
            "shard_map"],
    "skip": ["--arch", "smollm-360m", "--shape", "long_500k"],
    "fail": ["--arch", "no-such-arch", "--shape", "decode_32k"],
}

SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    from repro_torch.models import registry as reg
    from repro_torch._tree import tree_leaves

    out = {}
    for name, argv in json.loads(sys.argv[1]).items():
        d = sys.argv[2] + "/" + name
        try:
            dryrun.main(argv + ["--mesh", "single", "--out", d])
            rc = 0
        except SystemExit as e:
            rc = e.code
        out[name] = {"rc": rc, "files": {}}
        import os
        for f in sorted(os.listdir(d)):
            out[name]["files"][f] = json.load(open(os.path.join(d, f)))
    cfg = dryrun.build_cfg("smollm-360m", 0.5, "compressed_xla",
                           dryrun._world(False))
    out["float_param_bytes"] = sum(
        t.numel() * t.element_size()
        for t in tree_leaves(reg.abstract_params(cfg)[0])
        if t.is_floating_point())
    # rank 0's shard bytes of the decode cell's arguments, from the
    # resolved entries: each leaf's bytes over the sizes of its split axes
    from repro_torch.configs import SHAPES
    from repro_torch.launch import steps
    from repro_torch.sharding.api import axis_sizes, spec_map
    mesh = dryrun._world(False)
    sizes = axis_sizes(mesh)
    spec = reg.input_specs(cfg, SHAPES["decode_32k"])
    params, specs = reg.abstract_params(cfg)
    (p_sh, c_sh, tok_sh, _), _ = steps.serve_shardings(
        cfg, mesh, params, specs, spec, cache_auto=False)

    def shard_bytes(sh, t):
        n = t.numel() * t.element_size()
        for part in sh.spec:
            for ax in (part if isinstance(part, tuple) else (part,)):
                n //= sizes[ax] if ax else 1
        return n

    out["decode_shard_bytes"] = sum(tree_leaves(
        spec_map(shard_bytes, {"p": p_sh, "c": c_sh, "t": tok_sh},
                 {"p": params, "c": spec["cache"], "t": spec["tokens"]}))) \
        + spec["pos"].element_size()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(CELLS),
                           str(d)], env=env, capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _record(runs, name):
    (fname, rec), = runs[name]["files"].items()
    return fname, rec


def _jax_keys():
    """The keys JAX's dry run writes into an ``[ok]`` record, and those of
    its nested dicts, from its source."""
    tree = ast.parse((SRC / "repro/launch/dryrun.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def dict_keys(node):
        return {k.value for k in node.keys if isinstance(k, ast.Constant)}

    top, nested = set(), {}
    for n in ast.walk(fns["analyze"]):
        if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict):
            top |= dict_keys(n.value)
            for k, v in zip(n.value.keys, n.value.values):
                if isinstance(v, ast.Dict):
                    nested[k.value] = dict_keys(v)
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and n.targets[0].id == "mem_d" and n.value.keys):
            nested["memory_analysis"] = dict_keys(n.value)
    for n in ast.walk(fns["run_cell"]):
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and n.targets[0].id == "rec"):
            top |= dict_keys(n.value)
    return top | {"compile_seconds"}, nested


def _check_ok(rec, laid_out=False):
    top, nested = _jax_keys()
    assert top <= set(rec), top - set(rec)
    assert set(rec) - top == {"layout", "by_kernel", "memory_note"}
    for k, keys in nested.items():
        assert set(rec[k]) == keys, k
    assert rec["layout"] == (
        "laid out by serve_shardings: each rank holds its shard of the "
        "params, batch and cache" if laid_out else
        "params whole on every rank; data parallel over pod×data")
    assert rec["memory_analysis"]["generated_code_size_in_bytes"] is None
    want = j_model_flops_for(j_get_config(rec["arch"]).with_(tp=16),
                             J_SHAPES[rec["shape"]], rec["sparsity"])
    assert rec["roofline"]["model_flops"] == pytest.approx(want, rel=1e-12)
    assert rec["roofline"]["chips"] == 256


def test_decode_cell_writes_an_ok_record_with_jax_keys(runs):
    assert runs["decode"]["rc"] == 0
    fname, rec = _record(runs, "decode")
    assert fname == "smollm-360m__decode_32k__pod16x16__s50.json"
    _check_ok(rec, laid_out=True)
    # rank 0's shards of the params, the cache and the tokens, and the
    # layout's all-gathers (FSDP weights, k/v split inside a head) and
    # the embedding's all-reduce over the model axis
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        runs["decode_shard_bytes"]
    assert rec["collectives"]["bytes"]["all-gather"] > 0
    assert rec["collectives"]["bytes"]["all-reduce"] > 0
    # the H100 terms: bf16 peak, HBM rate, NVLink
    rl = rec["roofline"]
    assert rl["t_compute_s"] == pytest.approx(rl["flops_per_chip"] / 989e12)
    assert rl["t_memory_s"] == pytest.approx(
        rl["hlo_bytes_per_chip"] / 3.35e12)
    # q, o, gate, up, down of 32 layers (k and v, 320 wide, stay dense
    # under min_dim 512)
    assert rec["by_kernel"]["linear"]["calls"] == 5 * 32


def test_train_cell_counts_its_share_and_the_gradient_all_reduce(runs):
    assert runs["train"]["rc"] == 0
    fname, rec = _record(runs, "train")
    assert fname == "smollm-360m__train_4k__pod16x16__s50.json"
    _check_ok(rec)
    rl = rec["roofline"]
    assert rl["flops_per_chip"] >= rl["model_flops"] / 16  # dp = 16
    # every float gradient (bf16, one microbatch) and loss, nll, aux (f32)
    assert rec["collectives"]["bytes"] == {
        "all-reduce": runs["float_param_bytes"] + 3 * 4}
    assert rl["t_collective_s"] == pytest.approx(
        rl["collective_bytes_per_chip"] / 450e9)


def test_moe_shard_map_cell_all_reduces_over_the_model_group(runs):
    assert runs["moe"]["rc"] == 0
    _, rec = _record(runs, "moe")
    _check_ok(rec)
    assert rec["collectives"]["bytes"]["all-reduce"] > 0
    assert rec["collectives"]["counts"]["all-reduce"] > 0


def test_long_context_cell_of_a_full_attention_arch_is_skipped(runs):
    assert runs["skip"]["rc"] == 0
    fname, rec = _record(runs, "skip")
    assert fname == "smollm-360m__long_500k__pod16x16__s50.json"
    assert rec["skipped"].startswith("long_500k needs sub-quadratic attention")


def test_a_failing_cell_writes_its_err_json_and_exits_1(runs):
    assert runs["fail"]["rc"] == 1
    fname, rec = _record(runs, "fail")
    assert fname == "no-such-arch__decode_32k__pod16x16__s50.err.json"
    assert rec["error"].startswith("KeyError")
    assert "traceback" in rec and "compile_seconds" in rec
