"""Rule engine of the port's contract checker (twin of
``repro/analysis/engine.py``).

The port rests on contracts between layers that no type system sees: the
ctypes signature of each kernel must be its ``extern "C"`` entry's, the
dispatch registry's shared-memory count must cover what each wrapper's
launch requests, the ``cp.async`` copies of a kernel must be committed and
waited on, fault-site literals must be in ``fault.SITES`` and obs names in
``docs/observability.md``.  The rules here check them with the standard
library alone (``ast`` for Python, a comment- and string-blind scan for
CUDA C++), return :class:`Finding` records, and ``python -m
repro_torch.analysis`` exits non-zero on any finding its baseline does not
waive.

Design, as in the JAX package's engine:

  * **Deterministic output.**  Files are visited in sorted order, findings
    sorted on ``(path, line, rule, msg)``, paths root-relative POSIX, and
    the JSON carries no timestamps: two runs over one tree give the same
    bytes.
  * **Line-free waiver keys.**  ``rule:path:anchor``, the anchor a symbol
    the rule chooses (a function, a site literal, a kernel's C symbol),
    never a line number.
  * **Three rule scopes.**  ``check_module(ctx, path, tree)`` sees one
    parsed ``*.py`` file, ``check_source(ctx, path, text)`` one ``*.cu`` or
    ``*.cuh`` file, and ``check_project(ctx)`` runs once a run.  Project
    rules fire only when the tree analyzed holds the real
    ``src/repro_torch`` package, so a fixture tree exercises the file rules
    without importing torch.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = ["Finding", "Rule", "Context", "all_rules", "register", "nodes",
           "iter_files", "load_baseline", "run", "render_text",
           "render_json"]

JSON_SCHEMA_VERSION = 1

PY_SUFFIXES = (".py",)
CUDA_SUFFIXES = (".cu", ".cuh")

# Directory names never descended into (caches, VCS metadata, envs).
_SKIP_DIRS = {"__pycache__", ".git", ".hg", ".cache", ".venv", "node_modules"}

PORT = "src/repro_torch"


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at one location."""

    path: str  # root-relative POSIX path
    line: int  # 1-indexed
    rule: str  # e.g. "CU106"
    msg: str
    waiver_key: str  # "rule:path:anchor": line-free, stable in a baseline

    def as_dict(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "msg": self.msg, "waiver_key": self.waiver_key}


class Rule:
    """Base class: subclass, set ``id``/``title``, implement one hook."""

    id: str = ""
    title: str = ""

    def finding(self, path: str, line: int, msg: str,
                anchor: Optional[str] = None) -> Finding:
        key = f"{self.id}:{path}:{anchor if anchor is not None else 'module'}"
        return Finding(path=path, line=line, rule=self.id, msg=msg,
                       waiver_key=key)

    def check_module(self, ctx: "Context", path: str,
                     tree: ast.Module) -> Iterable[Finding]:
        return ()

    def check_source(self, ctx: "Context", path: str,
                     text: str) -> Iterable[Finding]:
        return ()

    def check_project(self, ctx: "Context") -> Iterable[Finding]:
        return ()


_RULES: List[Rule] = []


def nodes(tree: ast.AST) -> List[ast.AST]:
    """``ast.walk(tree)`` as a list, walked once a tree however many rules
    read it."""
    cached = getattr(tree, "_walked", None)
    if cached is None:
        cached = list(ast.walk(tree))
        tree._walked = cached
    return cached


def register(rule_cls):
    """Class decorator adding a rule (one shared instance) to the engine."""
    _RULES.append(rule_cls())
    return rule_cls


def all_rules() -> List[Rule]:
    # the rule modules register when imported; imported here, so engine.py
    # has no import cycle with them
    from repro_torch.analysis import rules_dispatch  # noqa: F401
    from repro_torch.analysis import rules_kernels  # noqa: F401
    from repro_torch.analysis import rules_registry  # noqa: F401

    return sorted(_RULES, key=lambda r: r.id)


def find_root(start: Path) -> Optional[Path]:
    """Walk up from ``start`` to the repository root: the directory that
    holds ``src/repro_torch``."""
    p = start.resolve()
    if p.is_file():
        p = p.parent
    for cand in (p, *p.parents):
        if (cand / PORT).is_dir():
            return cand
    return None


class Context:
    """Shared state of one run: the root (where found), the files, and the
    cross-file facts parsed once (fault sites, documented obs names)."""

    def __init__(self, root: Optional[Path], files: Sequence[Path]):
        self.root = root
        self.files = list(files)
        self._fault_sites: Optional[frozenset] = None
        self._obs_names: Optional[frozenset] = None
        # the project rules audit the live registry: only where the tree
        # analyzed holds the real port
        self.has_port_src = root is not None and any(
            _is_under(f, root / PORT) for f in self.files)

    def relpath(self, path: Path) -> str:
        if self.root is not None:
            try:
                return path.resolve().relative_to(self.root).as_posix()
            except ValueError:
                pass
        return path.as_posix()

    def fault_sites(self) -> Optional[frozenset]:
        """``repro_torch.fault.SITES``, parsed from the AST (no import)."""
        if self._fault_sites is None:
            self._fault_sites = _parse_fault_sites(self.root)
        return self._fault_sites or None

    def documented_obs_names(self) -> Optional[frozenset]:
        """Dotted event/metric names backticked in docs/observability.md."""
        if self._obs_names is None:
            self._obs_names = _parse_documented_names(self.root)
        return self._obs_names or None


def _is_under(path: Path, parent: Path) -> bool:
    try:
        path.resolve().relative_to(parent.resolve())
        return True
    except ValueError:
        return False


def _parse_fault_sites(root: Optional[Path]) -> frozenset:
    if root is None:
        return frozenset()
    src = root / PORT / "fault.py"
    if not src.is_file():
        return frozenset()
    tree = ast.parse(src.read_text(), filename=str(src))
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "SITES" \
                    and isinstance(node.value, (ast.Tuple, ast.List)):
                return frozenset(
                    e.value for e in node.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str))
    return frozenset()


# dotted lowercase identifiers like `dispatch.resolve` or `bench.<name>.us`
_DOC_NAME_RE = re.compile(
    r"`([a-z][a-z0-9_]*(?:\.(?:[a-z0-9_]+|<[a-z0-9_]+>))+)`")


def _parse_documented_names(root: Optional[Path]) -> frozenset:
    if root is None:
        return frozenset()
    doc = root / "docs" / "observability.md"
    if not doc.is_file():
        return frozenset()
    return frozenset(_DOC_NAME_RE.findall(doc.read_text()))


# ---------------------------------------------------------------------------
# File discovery, baseline, run
# ---------------------------------------------------------------------------


def iter_files(paths: Sequence[Path]) -> List[Path]:
    """The ``*.py``, ``*.cu`` and ``*.cuh`` files at or under ``paths``."""
    suffixes = PY_SUFFIXES + CUDA_SUFFIXES
    out = []
    for p in paths:
        p = Path(p)
        if p.is_file() and p.suffix in suffixes:
            out.append(p)
        elif p.is_dir():
            for f in sorted(p.rglob("*")):
                if f.suffix in suffixes and f.is_file() \
                        and not any(part in _SKIP_DIRS for part in f.parts):
                    out.append(f)
    return sorted(set(out))


def load_baseline(path: Optional[Path]) -> Dict[str, str]:
    """Waivers: ``{"waivers": [{"key": ..., "reason": ...}]}`` -> ``{key:
    reason}``.  A missing file, or ``{}``, is an empty baseline."""
    if path is None or not Path(path).is_file():
        return {}
    data = json.loads(Path(path).read_text())
    waivers = data.get("waivers", []) if isinstance(data, dict) else []
    out = {}
    for w in waivers:
        if isinstance(w, dict) and "key" in w:
            out[str(w["key"])] = str(w.get("reason", ""))
    return out


@dataclasses.dataclass
class Report:
    findings: List[Finding]          # not waived, sorted
    waived: List[Finding]            # matched a baseline key
    unused_waivers: List[str]        # baseline keys that matched nothing
    files: int


def run(paths: Sequence[Path], *, root: Optional[Path] = None,
        only: Optional[Sequence[str]] = None,
        baseline: Optional[Dict[str, str]] = None) -> Report:
    """Run the rules over ``paths`` and split the findings by ``baseline``."""
    files = iter_files([Path(p) for p in paths])
    if root is None and files:
        root = find_root(files[0])
    ctx = Context(root, files)
    rules = all_rules()
    if only is not None:
        wanted = set(only)
        rules = [r for r in rules if r.id in wanted]
    findings: List[Finding] = []
    for f in files:
        rel = ctx.relpath(f)
        text = f.read_text()
        if f.suffix in CUDA_SUFFIXES:
            for rule in rules:
                findings.extend(rule.check_source(ctx, rel, text))
            continue
        try:
            tree = ast.parse(text, filename=str(f))
        except SyntaxError as e:
            findings.append(Finding(
                path=rel, line=e.lineno or 1, rule="E000",
                msg=f"syntax error: {e.msg}", waiver_key=f"E000:{rel}:module"))
            continue
        for rule in rules:
            findings.extend(rule.check_module(ctx, rel, tree))
    if ctx.has_port_src:
        for rule in rules:
            findings.extend(rule.check_project(ctx))
    findings.sort()
    baseline = dict(baseline or {})
    live, waived = [], []
    matched = set()
    for f in findings:
        if f.waiver_key in baseline:
            matched.add(f.waiver_key)
            waived.append(f)
        else:
            live.append(f)
    unused = sorted(set(baseline) - matched)
    return Report(findings=live, waived=waived, unused_waivers=unused,
                  files=len(files))


# ---------------------------------------------------------------------------
# Reporters
# ---------------------------------------------------------------------------


def render_text(report: Report) -> str:
    lines = [f"{f.path}:{f.line}: {f.rule} {f.msg}" for f in report.findings]
    for key in report.unused_waivers:
        lines.append(f"baseline: unused waiver {key}")
    n = len(report.findings)
    lines.append(
        f"{n} finding{'s' if n != 1 else ''} "
        f"({len(report.waived)} waived) in {report.files} files")
    return "\n".join(lines)


def render_json(report: Report) -> str:
    payload = {
        "version": JSON_SCHEMA_VERSION,
        "files": report.files,
        "findings": [f.as_dict() for f in report.findings],
        "waived": [f.as_dict() for f in report.waived],
        "unused_waivers": list(report.unused_waivers),
    }
    return json.dumps(payload, indent=1, sort_keys=True)
