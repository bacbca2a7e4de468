"""Dry run of the dry-run grid (twin of ``repro/launch/dryrun.py``): the
roofline terms of one step of the port for every arch x shape x mesh, with
no card.

JAX lowers and compiles each cell for a mesh of host devices and reads the
compiled HLO.  Here nothing is compiled: each cell runs one step of the
port on the ``meta`` device (shapes and dtypes, no data, nothing allocated)
under the op counter (``roofline.count``), as rank 0 of a fake process
group of 256 ranks (``single``, the 16 x 16 mesh) or 512 (``multi``, 2 x 16
x 16), inside the ``ShardingCtx`` of ``make_production_mesh``:

  train_4k                 ``make_train_step`` with AdamW
  prefill_32k              ``make_prefill_step``
  decode_32k, long_500k    ``make_decode_step``

The port builds the step, so the per-rank numbers are the port's, not
JAX's (each record's ``layout``).  Every cell of the dense attention LMs
runs on rank 0's shards: ``train_4k`` on its shards of params, optimizer
state and batch laid out by ``train_shardings``, the serving cells
(``prefill_32k``, ``decode_32k``, ``long_500k``) on its shards of params,
batch and cache laid out by ``serve_shardings`` (``cache_auto=False``),
with the layout's all-gathers and all-reduces counted (and, in training,
those of the backward and the optimizer).  Every other cell holds the
params whole on every rank and computes this rank's rows of the global
batch, data parallel over the pod and data axes, where JAX's GSPMD shards
the params too.

The records go to ``build/dryrun`` by default (JAX's ``artifacts/dryrun``
holds the JAX package's records under the same names).

Run (CPU only; no card is needed or used):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape decode_32k --mesh single
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch._tree import tree_leaves
from repro_torch.sharding.api import lay_out, local
from repro_torch.configs import LONG_CONTEXT_ARCHS, SHAPES, get_config, list_archs
from repro_torch.core.pruning import SparsityConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh, mesh_dp, mesh_tp
from repro_torch.models import registry as reg
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.roofline import Roofline, count, model_flops_for
from repro_torch.sharding import ShardingCtx, use_ctx

LAYOUT_WHOLE = "params whole on every rank; data parallel over pod×data"
LAYOUT_LAID = ("laid out by serve_shardings: each rank holds its shard of "
               "the params, batch and cache")
LAYOUT_LAID_TRAIN = ("laid out by train_shardings: each rank holds its shard "
                     "of the params, optimizer state and batch")
TEMP_NOTE = ("temp_size_in_bytes: the counter's peak of live op outputs, an "
             "eager peak without the caching allocator")


def cell_skipped(arch: str, shape: str) -> str:
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return "long_500k needs sub-quadratic attention; skipped for pure full-attention archs (DESIGN.md §6)"
    return ""


# per-cell microbatch counts for the big training cells (activation memory)
MICROBATCH = {
    ("qwen2-vl-72b", "train_4k"): 8,
    ("nemotron-4-15b", "train_4k"): 4,
    ("qwen2-7b", "train_4k"): 4,
    ("zamba2-7b", "train_4k"): 4,
    ("moonshot-v1-16b-a3b", "train_4k"): 2,
}


def build_cfg(arch: str, sparsity: float, fmt: str, mesh, attn: str = "naive",
              local_reduce: bool = False, remat_policy: str = "nothing",
              attn_chunk: int = 512, moe_impl: str = "auto"):
    cfg = get_config(arch)
    scfg = SparsityConfig(
        sparsity=sparsity,
        m=None,               # adaptive M = full reduction dim (paper §3.1)
        tile=None,
        format=fmt if sparsity > 0 else "dense",
        min_dim=512,
        shard_local_reduce=local_reduce,
        reduce_groups=mesh_tp(mesh),
    )
    return cfg.with_(
        dtype="bfloat16",
        param_dtype="bfloat16",
        remat=True,
        tp=mesh_tp(mesh),
        dp=mesh_dp(mesh),
        sparsity=scfg,
        attn_impl=attn,
        remat_policy=remat_policy,
        attn_chunk=attn_chunk,
        moe_impl=moe_impl,
    )


def _nbytes(tree) -> int:
    """The bytes this rank holds of a tree's tensors (a laid-out leaf's
    shard)."""
    return sum(local(t).numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def run_step(arch: str, shape: str, mesh, sparsity: float, fmt: str,
             attn: str = "naive", local_reduce: bool = False,
             remat_policy: str = "nothing", attn_chunk: int = 512,
             moe_impl: str = "auto"):
    """Run one step of the cell on ``meta`` under the op counter.  Returns
    (cfg, cell, counts, FlopCounterMode's total, argument bytes, output
    bytes, the layout)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = build_cfg(arch, sparsity, fmt, mesh, attn, local_reduce,
                    remat_policy, attn_chunk, moe_impl)
    cell = SHAPES[shape]
    spec = reg.input_specs(cfg, cell)
    params, specs = reg.abstract_params(cfg)
    layout = LAYOUT_WHOLE
    opt = None
    if spec["kind"] == "train" and reg.layout_covers(cfg):
        layout = LAYOUT_LAID_TRAIN
        (p_sh, _, b_sh), _ = steps_mod.train_shardings(
            cfg, mesh, params, specs, spec["batch"])
        params = lay_out(params, p_sh)
        opt = adamw_init(params)  # laid out as the params: opt_state_specs
        spec = dict(spec, batch=lay_out(spec["batch"], b_sh))
    elif spec["kind"] != "train" and reg.layout_covers(cfg):
        layout = LAYOUT_LAID
        shs = steps_mod.serve_shardings(cfg, mesh, params, specs, spec,
                                        cache_auto=False)
        if spec["kind"] == "prefill":
            p_sh, b_sh = shs
            spec = dict(spec, batch=lay_out(spec["batch"], b_sh))
        else:
            (p_sh, c_sh, tok_sh, _), _ = shs
            spec = dict(spec, cache=lay_out(spec["cache"], c_sh),
                        tokens=lay_out(spec["tokens"], tok_sh))
        params = lay_out(params, p_sh)
    if spec["kind"] == "train":
        step = steps_mod.make_train_step(
            cfg, AdamWConfig(), microbatches=MICROBATCH.get((arch, shape), 1))
        args = (params, opt if opt is not None else adamw_init(params),
                spec["batch"])
    elif spec["kind"] == "prefill":
        step = steps_mod.make_prefill_step(cfg)
        args = (params, spec["batch"])
    else:
        step = steps_mod.make_decode_step(cfg)
        args = (params, spec["cache"], spec["tokens"], spec["pos"])
    outs = []
    flop_counter = FlopCounterMode(display=False)

    def run():
        with flop_counter:
            outs.append(step(*args))

    with use_ctx(ShardingCtx(mesh=mesh)):
        counts = count(run)
    return (cfg, cell, counts, flop_counter.get_total_flops(), _nbytes(args),
            _nbytes(outs), layout)


def analyze(cfg, cell, counts, raw_flops, arg_bytes, out_bytes, chips: int,
            sparsity: float, layout: str = LAYOUT_WHOLE):
    rl = Roofline(
        flops=counts["flops"],
        hlo_bytes=counts["bytes"],
        collective_bytes=counts["collective_bytes"],
        model_flops=model_flops_for(cfg, cell, sparsity),
        chips=chips,
        dtype=cfg.dtype,
    )
    return {
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": counts["peak_bytes"],
            "generated_code_size_in_bytes": None,
        },
        "cost_analysis_raw": {"flops": raw_flops,
                              "bytes_accessed": counts["bytes"]},
        "collectives": {
            "counts": counts["collective_counts"],
            "bytes": counts["collective_by_kind"],
        },
        "roofline": rl.to_dict(),
        "by_kernel": counts["by_kernel"],
        "hlo_size_chars": None,
        "layout": layout,
        "memory_note": TEMP_NOTE,
    }


def _world(multi_pod: bool):
    """Make this process rank 0 of a fake process group of the mesh's size
    (256 or 512 ranks), replacing any group of another size; returns the
    production mesh, on the CPU."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    size = 512 if multi_pod else 256
    if dist.is_initialized() and dist.get_world_size() != size:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def run_cell(arch, shape, multi_pod, sparsity, fmt, out_dir: Path, tag="", attn="naive",
             local_reduce=False, remat_policy="nothing", attn_chunk=512, moe_impl="auto"):
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    name = f"{arch}__{shape}__{mesh_name}__s{int(sparsity*100)}{tag}"
    out_path = out_dir / f"{name}.json"
    if out_path.exists():
        print(f"[skip-cached] {name}")
        return True
    skip = cell_skipped(arch, shape)
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "sparsity": sparsity, "format": fmt if sparsity > 0 else "dense",
    }
    if skip:
        rec["skipped"] = skip
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[skipped] {name}: {skip}")
        return True
    t0 = time.time()
    try:
        mesh = _world(multi_pod)
        cfg, cell, counts, raw, arg_b, out_b, layout = run_step(
            arch, shape, mesh, sparsity, fmt, attn, local_reduce,
            remat_policy, attn_chunk, moe_impl)
        rec.update(analyze(cfg, cell, counts, raw, arg_b, out_b,
                           mesh.size(), sparsity, layout))
        rec["compile_seconds"] = time.time() - t0
        out_path.write_text(json.dumps(rec, indent=1))
        rl = rec["roofline"]
        print(
            f"[ok] {name}: bottleneck={rl['bottleneck']} "
            f"tc={rl['t_compute_s']:.4f}s tm={rl['t_memory_s']:.4f}s "
            f"tcoll={rl['t_collective_s']:.4f}s frac={rl['roofline_fraction']:.3f} "
            f"({rec['compile_seconds']:.0f}s counted)"
        )
        return True
    except Exception as e:  # noqa: BLE001 - a cell's failure is its record
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        rec["compile_seconds"] = time.time() - t0
        out_path.with_suffix(".err.json").write_text(json.dumps(rec, indent=1))
        print(f"[FAIL] {name}: {rec['error'][:300]}")
        return False


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run driver (meta, CPU)")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--format", default="compressed_xla")
    # not JAX's artifacts/dryrun: that holds the JAX package's records under
    # the same names, which --out would skip as cached
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--attn", default="naive", choices=["naive", "chunked"])
    ap.add_argument("--local-reduce", action="store_true")
    ap.add_argument("--remat-policy", default="nothing", choices=["nothing", "dots"])
    ap.add_argument("--attn-chunk", type=int, default=512)
    ap.add_argument("--moe", default="auto", choices=["auto", "shard_map"])
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                ok = run_cell(arch, shape, mp, args.sparsity, args.format, out_dir,
                              tag=args.tag, attn=args.attn, local_reduce=args.local_reduce,
                              remat_policy=args.remat_policy, attn_chunk=args.attn_chunk,
                              moe_impl=args.moe)
                n_fail += 0 if ok else 1
    print(f"done; failures={n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
