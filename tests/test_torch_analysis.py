"""The port's contract checker (``repro_torch.analysis``), the twin of
``tests/test_analysis.py``: each rule fires on a bad fixture written under
``tmp_path`` and stays silent on the good one, seeded faults in the live
registry are caught, the shipped port is clean with an empty baseline, the
reports are deterministic, the CLI's exit codes, waivers, the run-time
budget, and RC201/RC202 parity with the JAX package's checker."""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from repro.analysis import engine as jengine
from repro_torch.analysis import engine
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.rules_kernels import functions, blank, kernel_decls

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
BASELINE = PORT / "analysis" / "baseline.json"

JAX_KERNEL = """\
    def helper(x):
        return pl.pallas_call(kernel, out_shape=x)(x)


    def k_pallas(x, w):
        return helper(x)


    def not_a_kernel(x):
        return x
"""

CU_ENTRY = """\
    #include "common.cuh"
    // k: [n] -> [n]
    extern "C" int repro_k(const void* x, void* out, int dtype, int n,
                           long long smem_bytes, void* stream) {
      return 0;
    }
"""

PY_DECL = """\
    import ctypes
    from repro_torch.kernels._build import CudaKernel

    K = CudaKernel(
        "k", "repro_k",
        {argtypes},
        source="src/repro_torch/csrc/k.cu",
        replaces="{replaces}",
        sized_smem={sized},
    )
"""
GOOD_ARGTYPES = "[ctypes.c_void_p] * 2 + [ctypes.c_int] * 2"


def make_repo(tmp_path: Path, files: dict) -> Path:
    """A fixture tree: the root markers and registries the file rules read,
    without ``dispatch/registry.py``, so the project rules skip."""
    root = tmp_path / "fixrepo"
    (root / "docs").mkdir(parents=True)
    (root / "docs" / "observability.md").write_text(textwrap.dedent("""\
        # schema
        | `demo.event` | instant | x |
        Counters: `demo.count`.
    """))
    for pkg in ("repro", "repro_torch"):
        (root / "src" / pkg).mkdir(parents=True)
        (root / "src" / pkg / "fault.py").write_text(
            'SITES = ("demo.site", "other.site")\n')
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def run_rules(root: Path, only):
    return engine.run([root / "src" / "repro_torch"], only=only)


def rule_ids(report):
    return sorted({f.rule for f in report.findings})


def anchors(report):
    return sorted(f.waiver_key.rsplit(":", 1)[1] for f in report.findings)


# ---------------------------------------------------------------------------
# CU1xx: the CUDA sources
# ---------------------------------------------------------------------------

KERNEL = """\
    #include "common.cuh"
    __global__ void k(const float* x, float* out, int n) {{
      extern __shared__ float s[];
      repro::cp_async16(s, x);
      {after}
      out[0] = s[0];
    }}
"""

PIPELINE = """\
    __global__ void k(const float* x, float* out, int n) {
      extern __shared__ float s[];
      auto stage = [&](int i) {
        repro::cp_async16(s + (i & 1) * 4, x + 4 * i);
      };
      stage(0);
      repro::cp_async_commit();
      for (int i = 0; i < n; ++i) {
        repro::cp_async_wait<0>();
        __syncthreads();
        GUARD stage(i + 1);
        repro::cp_async_commit();
        out[i] = s[(i & 1) * 4];
      }
    }
"""


@pytest.mark.parametrize("after,fires", [
    ("repro::cp_async_commit();\n  repro::cp_async_wait<0>();", None),
    ("repro::cp_async_commit();", "k.wait"),
    ("", "k.commit"),
    ("repro::cp_async_wait<0>();\n  repro::cp_async_commit();", "k.wait"),
], ids=["committed-waited", "never-waited", "never-committed", "wait-first"])
def test_cu101_copy_protocol(tmp_path, after, fires):
    root = make_repo(tmp_path, {"src/repro_torch/csrc/k.cu":
                                KERNEL.format(after=after)})
    report = run_rules(root, only=["CU101"])
    assert anchors(report) == ([] if fires is None else [fires])
    if fires:
        (f,) = report.findings
        assert f.path == "src/repro_torch/csrc/k.cu" and f.line in (4, 5, 6)


@pytest.mark.parametrize("guard,fires", [
    ("if (i + 1 < n)", False), ("", True)], ids=["guarded", "unguarded"])
def test_cu101_loop_carried_wait(tmp_path, guard, fires):
    """A pipelined loop's wait at the top of the body drains the group the
    previous iteration committed; the last iteration's group is empty only
    where its copies are guarded by the walk's end."""
    root = make_repo(tmp_path, {"src/repro_torch/csrc/k.cu":
                                PIPELINE.replace("GUARD", guard)})
    assert anchors(run_rules(root, only=["CU101"])) == (
        ["k.wait"] if fires else [])


def test_cu102_raw_cp_async_asm(tmp_path):
    asm = ('asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" '
           '::"r"(d), "l"(p));')
    helper = f"""\
        __device__ void cp_async16(void* s, const void* p) {{
          const unsigned d = 0;
          {asm}
        }}
    """
    kernel = f"""\
        __global__ void k(const float* p) {{
          const unsigned d = 0;
          {asm}
          // asm("cp.async ...") in a comment is no finding
        }}
    """
    root = make_repo(tmp_path, {"src/repro_torch/csrc/common.cuh": helper,
                                "src/repro_torch/csrc/k.cu": kernel})
    report = run_rules(root, only=["CU102"])
    assert [(f.path, f.line) for f in report.findings] == \
        [("src/repro_torch/csrc/k.cu", 3)]
    assert anchors(report) == ["k"]


def test_cu104_half_precision_math(tmp_path):
    bad = """\
        __global__ void k(const __nv_bfloat16* a, float* out) {
          out[0] = to_f32(__hmul(a[0], a[1]));
          out[1] = to_f32(__hfma2(a[0], a[1], a[2]));
        }
    """
    good = """\
        __global__ void k(const __nv_bfloat16* a, float* out) {
          out[0] = fmaf(to_f32(a[0]), to_f32(a[1]), 0.f);  // not __hmul
          out[1] = __half2float(a[0]);
        }
    """
    root = make_repo(tmp_path, {"src/repro_torch/csrc/k.cu": bad})
    assert anchors(run_rules(root, only=["CU104"])) == ["k.__hfma2",
                                                        "k.__hmul"]
    root = make_repo(tmp_path / "g", {"src/repro_torch/csrc/k.cu": good})
    assert run_rules(root, only=["CU104"]).findings == []


def _abi_repo(tmp_path, argtypes=GOOD_ARGTYPES, sized="True",
              replaces="src/repro/kernels/k.py:5 k_pallas", entry=CU_ENTRY):
    return make_repo(tmp_path, {
        "src/repro_torch/kernels/k.py": PY_DECL.format(
            argtypes=argtypes, sized=sized, replaces=replaces),
        "src/repro_torch/csrc/k.cu": entry,
        "src/repro/kernels/k.py": JAX_KERNEL})


@pytest.mark.parametrize("kw,want", [
    ({}, []),
    ({"argtypes": "[ctypes.c_void_p] * 2 + [ctypes.c_int]"}, ["repro_k.count"]),
    ({"argtypes": "[ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int]"},
     ["repro_k.types"]),
    ({"sized": "False"}, ["repro_k.count", "repro_k.sized_smem"]),
    ({"replaces": "src/repro/kernels/k.py:6 k_pallas"}, ["repro_k.replaces"]),
    ({"replaces": "src/repro/kernels/k.py:9 not_a_kernel"},
     ["repro_k.replaces"]),
    ({"replaces": "src/repro/kernels/gone.py:5 k_pallas"},
     ["repro_k.replaces"]),
    ({"entry": CU_ENTRY.replace('extern "C" ', "")}, ["repro_k.source"]),
    ({"argtypes": "[ctypes.c_void_p] * 2 + [ctypes.c_int] * 2",
      "entry": CU_ENTRY.replace("int n,", "float n,")}, ["repro_k.types"]),
], ids=["good", "one-short", "int-longlong-swapped", "sized-smem-wrong",
        "replaces-off-by-one", "replaces-no-pallas-call", "replaces-no-file",
        "not-extern-c", "float-param"])
def test_cu106_kernel_abi(tmp_path, kw, want):
    root = _abi_repo(tmp_path, **kw)
    report = run_rules(root, only=["CU106"])
    assert anchors(report) == want, engine.render_text(report)
    for f in report.findings:
        assert f.path == "src/repro_torch/kernels/k.py" and f.line == 4


def test_cu106_reads_every_shipped_declaration():
    """The shipped port declares 16 kernels; the rule resolves each one's C
    entry (a rule that read nothing would pass vacuously)."""
    decls = []
    for path in sorted((PORT / "kernels").rglob("*.py")):
        for d in kernel_decls(ast.parse(path.read_text())):
            entry = [f for f in functions(blank((REPO / d.source).read_text()))
                     if f.name == d.symbol]
            assert len(entry) == 1 and entry[0].extern_c, d.symbol
            decls.append(d.symbol)
    assert len(decls) == len(set(decls)) == 16


# ---------------------------------------------------------------------------
# RC2xx: registry coherence
# ---------------------------------------------------------------------------


RC_FIXTURE = """\
    from repro_torch import fault
    from repro_torch.obs import trace as _ot
    from repro_torch.obs import metrics as _om
    from repro_torch.obs.trace import instant

    _C = _om.counter("demo.count")                 # documented
    _BAD = _om.counter("demo.rogue_counter")       # not in docs

    def f():
        fault.maybe_fail("demo.site", step=1)      # registered
        fault.maybe_fail("bogus.site", step=2)     # not in SITES
        with fault.fault_scope("other.site:n=1, bogus.scope:p=0.5"):
            pass
        _ot.instant("demo.event", x=1)             # documented
        instant("demo.rogue_event")                # direct import, bad
        private.counter("demo.also_rogue")         # private registry: exempt
"""


def test_rc201_and_rc202(tmp_path):
    root = make_repo(tmp_path, {"src/repro_torch/mod.py": RC_FIXTURE})
    assert anchors(run_rules(root, only=["RC201"])) == ["bogus.scope",
                                                         "bogus.site"]
    assert anchors(run_rules(root, only=["RC202"])) == ["demo.rogue_counter",
                                                         "demo.rogue_event"]


def test_rc201_rc202_parity_with_the_jax_checker(tmp_path):
    """The JAX package's engine and the port's, over one fixture tree, give
    the same (rule, path, line, waiver key) set for RC201 and RC202."""
    root = make_repo(tmp_path, {"src/repro_torch/mod.py": RC_FIXTURE})
    only = ["RC201", "RC202"]
    mine = engine.run([root / "src"], only=only).findings
    theirs = jengine.run([root / "src"], only=only).findings
    assert len(mine) == 4
    assert {(f.rule, f.path, f.line, f.waiver_key) for f in mine} == \
        {(f.rule, f.path, f.line, f.waiver_key) for f in theirs}


def test_rc203_reads_no_repro_variable_at_all(tmp_path):
    """Stricter than JAX's RC203: the port has no env registry, so every
    REPRO_* read is a finding, through os.environ, os.getenv or an alias."""
    src = """\
        import os
        import os as _os
        from os import environ as ENV, getenv
        E = os.environ

        def f():
            a = os.environ.get("REPRO_STRAY")           # bad
            b = os.environ["REPRO_SUBSCRIPT"]           # bad
            c = os.getenv("REPRO_GETENV")               # bad
            d = _os.environ.get("REPRO_OS_ALIAS")       # bad
            e = ENV.get("REPRO_ENVIRON_ALIAS")          # bad
            g = getenv("REPRO_GETENV_ALIAS")            # bad
            h = E["REPRO_ASSIGNED_ALIAS"]               # bad
            i = "REPRO_IN" in os.environ                # bad
            j = os.environ.get("OTHER_PREFIX")          # out of scope
            os.environ["REPRO_WRITE"] = "1"             # a write, not a read
            return a, b, c, d, e, g, h, i, j
    """
    root = make_repo(tmp_path, {"src/repro_torch/mod.py": src})
    assert anchors(run_rules(root, only=["RC203"])) == [
        "REPRO_ASSIGNED_ALIAS", "REPRO_ENVIRON_ALIAS", "REPRO_GETENV",
        "REPRO_GETENV_ALIAS", "REPRO_IN", "REPRO_OS_ALIAS", "REPRO_STRAY",
        "REPRO_SUBSCRIPT"]


def test_e000_syntax_error_is_a_finding(tmp_path):
    root = make_repo(tmp_path, {"src/repro_torch/mod.py": "def f(:\n"})
    assert rule_ids(run_rules(root, only=["RC203"])) == ["E000"]


# ---------------------------------------------------------------------------
# DP3xx: seeded faults in the live registry
# ---------------------------------------------------------------------------


def _seeded(op, family, **changes):
    from repro_torch.dispatch import registry as R

    base = R.REGISTRY.get(op, family)
    spec = dataclasses.replace(base, name=family + "@seededbug", **changes)
    R.REGISTRY.register(spec)
    return R, spec


def _unseed(R, spec):
    R.REGISTRY._impls[spec.op].pop(spec.name, None)
    R.REGISTRY.generation += 1


def test_dp301_catches_a_count_that_assumes_bf16():
    """JAX's seeded bug, here: a tiled-linear count that sizes every key at
    bf16 width under-counts each f32 key's launch."""
    from repro_torch.dispatch import registry as R

    base = R.REGISTRY.get("linear", "compressed_tiled")
    R, spec = _seeded("linear", "compressed_tiled", smem_bytes=lambda key: (
        base.smem_bytes(dataclasses.replace(key, dtype="bf16"))))
    try:
        report = engine.run([PORT], only=["DP301"])
        hits = [f for f in report.findings if "@seededbug" in f.msg]
        assert hits and all("f32" in f.msg for f in hits), \
            engine.render_text(report)
    finally:
        _unseed(R, spec)
    assert engine.run([PORT], only=["DP301", "DP302"]).findings == []


def test_dp302_catches_a_predicate_that_admits_everything():
    R, spec = _seeded("conv", "fused_banded_pallas",
                      feasible=lambda key: (True, "ok"))
    try:
        report = engine.run([PORT], only=["DP302"])
        assert [f.waiver_key for f in report.findings] == [
            "DP302:src/repro_torch/dispatch/registry.py:"
            "conv:fused_banded_pallas@seededbug:f32:budget"]
    finally:
        _unseed(R, spec)


def test_every_cuda_candidate_launches_on_a_small_probe_key():
    """The audit the card repeats: each CUDA candidate has a launch on some
    small probe key it admits, within its count and the budget; each
    over-budget key is refused by some candidate."""
    from repro_torch.analysis import rules_dispatch as D
    from repro_torch.dispatch import registry as R

    seen = set()
    for spec, key, launches in D.audit(R):
        if D.small(key) and spec.feasible(key)[0]:
            assert launches, (spec.name, key.token)
            seen.add(spec.name)
            assert max(la.smem for la in launches) <= spec.smem_bytes(key) \
                <= R.SMEM_BYTES
    assert seen == {s.name for op in R.REGISTRY.ops()
                    for s in R.REGISTRY.candidates(op) if s.backend == "cuda"}
    for key in D.over_budget(R):
        assert any(not s.feasible(key)[0] for s in
                   R.REGISTRY.candidates(key.op) if s.backend == "cuda")


# ---------------------------------------------------------------------------
# Engine mechanics and the shipped tree
# ---------------------------------------------------------------------------

BAD_CU = KERNEL.format(after="repro::cp_async_commit();")


def test_waiver_roundtrip_and_unused_waiver(tmp_path):
    root = make_repo(tmp_path, {"src/repro_torch/csrc/k.cu": BAD_CU})
    (f,) = run_rules(root, only=["CU101"]).findings
    assert f.waiver_key == "CU101:src/repro_torch/csrc/k.cu:k.wait"
    waived = engine.run([root / "src"], only=["CU101"],
                        baseline={f.waiver_key: "known debt"})
    assert waived.findings == [] and len(waived.waived) == 1
    stale = engine.run([root / "src"], only=["CU101"],
                       baseline={f.waiver_key: "x", "CU101:gone.cu:fn": "y"})
    assert stale.unused_waivers == ["CU101:gone.cu:fn"]
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"waivers": [{"key": f.waiver_key,
                                             "reason": "known debt"}]}))
    assert engine.load_baseline(base) == {f.waiver_key: "known debt"}
    assert analysis_main([str(root / "src"), "--baseline", str(base)]) == 0


def test_cli_exit_codes(tmp_path, capsys):
    root = make_repo(tmp_path, {"src/repro_torch/csrc/k.cu": BAD_CU})
    assert analysis_main([str(root / "src"), "--no-baseline",
                          "--only", "CU101"]) == 1
    assert analysis_main([str(root / "src"), "--no-baseline",
                          "--only", "CU102"]) == 0
    assert analysis_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rid in ("CU101", "CU102", "CU104", "CU106", "DP301", "DP302",
                "RC201", "RC202", "RC203"):
        assert rid in listed
    assert analysis_main([str(root / "nope")]) == 2
    assert analysis_main(["--only", "XX999", str(root / "src")]) == 2
    assert analysis_main(["--no-such-flag"]) == 2
    capsys.readouterr()


def test_json_reporter_schema(tmp_path):
    root = make_repo(tmp_path, {"src/repro_torch/csrc/k.cu": BAD_CU})
    payload = json.loads(engine.render_json(run_rules(root, only=["CU101"])))
    assert payload["version"] == engine.JSON_SCHEMA_VERSION
    assert set(payload) == {"version", "files", "findings", "waived",
                            "unused_waivers"}
    (f,) = payload["findings"]
    assert set(f) == {"rule", "path", "line", "msg", "waiver_key"}
    assert f["path"] == "src/repro_torch/csrc/k.cu"


def test_cross_process_determinism():
    """Two CLI runs over the shipped port (both started at once) print the
    same bytes and exit 0."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.analysis",
                               "--json"], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out.decode() + err.decode()
    assert outs[0][0] == outs[1][0]
    assert json.loads(outs[0][0])["findings"] == []


def test_committed_baseline_is_empty_and_the_shipped_port_clean():
    assert json.loads(BASELINE.read_text()) == {}
    start = time.monotonic()
    report = engine.run([PORT], baseline=engine.load_baseline(BASELINE))
    elapsed = time.monotonic() - start
    assert report.findings == [], engine.render_text(report)
    assert report.unused_waivers == [] and report.waived == []
    assert report.files > 100  # the Python modules and csrc/
    assert elapsed < 10.0


def test_analyzer_runtime_budget():
    """The whole CLI run, torch's import included, within 10 s."""
    start = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         cwd=REPO, capture_output=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stdout.decode() + out.stderr.decode()
    assert time.monotonic() - start < 10.0
