"""Serving launcher (twin of ``repro/launch/serve.py``): batched generation
with the column-wise N:M engine, on the CUDA card unless ``--device cpu``
asks for the plain versions on the CPU.

Static batch (pads every request to the slowest sequence):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --batch 4 --new-tokens 32 --sparsity 0.5 [--device cpu]

Continuous batching over a synthetic mixed-length request trace; bare
``--trace`` prints the admit/retire event log:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --continuous --requests 12 --slots 4 --trace

``--paged`` puts the continuous scheduler on the paged KV cache
(``--page-size``, ``--kv-budget-rows``), and ``--alloc grow`` maps pages as
decode reaches them, preempting and restoring on exhaustion:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --continuous --paged --alloc grow --deadline-s 30

SIGTERM (or Ctrl-C) drains: admissions stop, in-flight requests finish and
queued ones flush as cancelled.  ``--watchdog-s`` aborts a wedged serve
loop.  ``--faults SPEC`` (with ``--faults-seed``) installs a seeded
fault-injection plan (``repro_torch.fault`` grammar) and prints what fired
at exit; ``--trace PATH`` turns the obs layer on and writes a Chrome trace
(Perfetto loads it) with the metrics snapshot under ``otherData``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --device cpu --continuous --paged --alloc grow \
        --faults 'page_pool.alloc:n=1' --trace out.json
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import fault as rfault
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.pruning import SparsityConfig
from repro_torch.models import registry as reg
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot
from repro_torch.serve import (
    STATUSES,
    Engine,
    Scheduler,
    ServeConfig,
    latency_percentiles,
    synthetic_trace,
)
from repro_torch.train.fault import PreemptionGuard, StepWatchdog


def build_engine(args) -> Engine:
    scfg = SparsityConfig(sparsity=args.sparsity, m=None, tile=None,
                          format="compressed_xla" if args.sparsity > 0 else "dense",
                          min_dim=64 if args.smoke else 512)
    cfg = (smoke_config(args.arch) if args.smoke else get_config(args.arch)).with_(
        sparsity=scfg)
    params = reg.init_params(cfg, 0, device=args.device)
    return Engine(cfg, params, ServeConfig(max_new_tokens=args.new_tokens,
                                           temperature=args.temperature))


def run_static(args) -> None:
    eng = build_engine(args)
    cfg = eng.cfg
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    eng.generate(prompts)  # warm-up: fills the dispatch memos
    res = eng.generate(prompts)
    print(f"arch={cfg.name} sparse={args.sparsity} batch={args.batch} "
          f"device={eng.device}")
    print(f"prefill {res['prefill_s']*1e3:.1f} ms; decode {res['decode_tok_s']:.1f} tok/s")
    for i, row in enumerate(res["tokens"][:2]):
        print(f"  seq{i}: {row[:16].tolist()}")


def run_continuous(args) -> None:
    if args.requests < 1:
        raise SystemExit("--continuous needs --requests >= 1")
    eng = build_engine(args)
    cfg = eng.cfg
    trace = synthetic_trace(
        args.requests, seed=0, vocab=cfg.vocab_size,
        prompt_lens=(max(args.prompt_len // 4, 1), args.prompt_len),
        new_tokens=(max(args.new_tokens // 4, 1), args.new_tokens))
    if args.deadline_s is not None:
        for r in trace:
            r.deadline_s = args.deadline_s
    sched = Scheduler(eng, n_slots=args.slots, prefill_chunk=args.prefill_chunk,
                      paged=args.paged, page_size=args.page_size,
                      kv_budget_rows=args.kv_budget_rows, alloc=args.alloc)
    log = print if args.trace == "" else None
    # SIGTERM/SIGINT -> graceful drain (finish in flight, flush the queue);
    # the watchdog aborts the process if no scheduler iteration completes
    # inside the window
    guard = PreemptionGuard().install()
    dog = StepWatchdog(timeout_s=args.watchdog_s,
                       trace_path=args.trace or None).start()
    try:
        completions = sched.run(trace, log_fn=log,
                                should_drain=lambda: guard.requested,
                                heartbeat=dog.beat)
    finally:
        dog.stop()
        guard.uninstall()
    stats = sched.stats
    p50, p99 = latency_percentiles(completions)
    mode = f"paged(page_size={sched.page_size},alloc={args.alloc})" \
        if args.paged else "contiguous"
    print(f"arch={cfg.name} sparse={args.sparsity} continuous kv={mode} "
          f"slots={args.slots} requests={len(completions)} device={eng.device}")
    by_status = " ".join(
        f"{s}={int(stats[f'retired_{s}'])}" for s in STATUSES
        if stats[f"retired_{s}"])
    print(f"status: {by_status or 'none'}; "
          f"preemptions {int(stats['preemptions'])}, "
          f"iter faults {int(stats['iter_faults'])}"
          + (" [drained]" if guard.requested else ""))
    print(f"decode {stats['decode_tok_s']:.1f} tok/s "
          f"({stats['generated_tokens']} tokens, "
          f"{stats['decode_steps']} steps); "
          f"latency p50 {p50*1e3:.1f} ms p99 {p99*1e3:.1f} ms")
    print(f"ttft p50 {stats['ttft_p50_s']*1e3:.1f} ms "
          f"p99 {stats['ttft_p99_s']*1e3:.1f} ms; "
          f"tpot p50 {stats['tpot_p50_s']*1e3:.2f} ms "
          f"p99 {stats['tpot_p99_s']*1e3:.2f} ms")
    if args.paged:
        ps = sched.page_stats
        print(f"pages peak {int(ps['pages_peak'])} "
              f"(hwm {int(ps['kv_rows_hwm'])} KV rows), "
              f"occupancy {int(ps['pages_active'])} active / "
              f"{int(ps['pages_free'])} free, "
              f"fragmentation {ps['page_fragmentation']:.2f}")
    for c in completions[:2]:
        print(f"  uid={c.uid}: {c.tokens[:16].tolist()}")


def _finish_trace(path: str) -> None:
    n = _ot.dump_chrome_trace(path, metadata={"metrics": _om.snapshot()})
    print(f"trace: wrote {n} events to {path} (load in ui.perfetto.dev)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-friendly)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--continuous", action="store_true",
                    help="slot-based continuous batching over a synthetic "
                         "mixed-length request trace")
    ap.add_argument("--requests", type=int, default=12,
                    help="trace size for --continuous")
    ap.add_argument("--slots", type=int, default=4,
                    help="KV slot count (decode batch width) for --continuous")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--paged", action="store_true",
                    help="page the KV cache and prefill admitted prompts as "
                         "one packed padding-free stream; --continuous only")
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV rows per page; default lets "
                         "dispatch.choose_page_size pick it")
    ap.add_argument("--kv-budget-rows", type=int, default=None,
                    help="total physical KV rows for the paged pool "
                         "(default: slots * max_len)")
    ap.add_argument("--alloc", choices=("reserve", "grow"), default="reserve",
                    help="paged allocation policy: reserve prompt+budget up "
                         "front, or grow on demand with preemption-restore "
                         "on exhaustion")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline (seconds from submission) "
                         "stamped onto every trace request; expiry retires "
                         "with status=timeout")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="seeded fault-injection plan, repro_torch.fault "
                         "grammar (e.g. 'page_pool.alloc:n=2,"
                         "kernel.paged_attn:iter=0')")
    ap.add_argument("--faults-seed", type=int, default=0,
                    help="seed for probabilistic (p=) fault rules")
    ap.add_argument("--watchdog-s", type=float, default=300.0,
                    help="scheduler-iteration watchdog: abort the process "
                         "if no iteration completes within this window")
    ap.add_argument("--trace", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="bare: print per-request admit/retire events; "
                         "with PATH: enable the obs layer and write a "
                         "Perfetto-loadable Chrome trace to PATH")
    args = ap.parse_args(argv)
    if args.paged and not args.continuous:
        raise SystemExit("--paged requires --continuous (the static engine "
                         "uses the contiguous per-batch cache)")
    if (args.alloc != "reserve" or args.deadline_s is not None) \
            and not args.continuous:
        raise SystemExit("--alloc/--deadline-s require --continuous")
    trace_path = args.trace if args.trace else None
    obs_was_on = _ot.enabled()
    if trace_path:
        # the trace and its metrics describe this run alone
        _ot.reset()
        _om.reset()
        _ot.set_enabled(True)
    if args.faults:
        rfault.install(args.faults, seed=args.faults_seed)
    try:
        if args.continuous:
            run_continuous(args)
        else:
            run_static(args)
    finally:
        if args.faults:
            print(f"faults: fired {dict(rfault.plan().fired)} "
                  f"of probes {dict(rfault.plan().probes)}")
            rfault.uninstall()
        if trace_path:
            _finish_trace(trace_path)
            _ot.set_enabled(obs_was_on)


if __name__ == "__main__":
    main()
