"""Registry coherence (RC2xx): the port's runtime names.

``repro_torch.fault.SITES`` registers the fault-injection sites and the
tables of ``docs/observability.md`` the obs event and metric names.  Code
that invents a name outside its registry works (both layers tolerate
unknown names at run time) and drops out of every tool built on the
registry: an unregistered site never fires under a chaos spec, an
undocumented event is invisible to the schema's readers.  The port has no
environment switches at all (its entry points take arguments), so any
read of a ``REPRO_*`` variable is a finding: stricter than the JAX
package's RC203, which sends such reads through ``repro.env``.

The registries are parsed from source and docs (no imports), so these rules
run on fixture trees too.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional, Set

from repro_torch.analysis.engine import PORT, Context, Rule, nodes, register

_FAULT_REGISTRY = f"{PORT}/fault.py"

# the obs emit surface whose first (literal) argument is a schema name
_OBS_FNS = {"span", "instant", "counter", "gauge", "histogram"}


def _literal_first_arg(call: ast.Call) -> Optional[str]:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def _dotted_parts(node: ast.expr):
    """``a.b.c`` -> ["a", "b", "c"]; None for non-name chains."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


def spec_sites(spec: str) -> Iterable[str]:
    """Site names of a fault-plan string (``site[@match]:kind=value``
    entries, comma-separated)."""
    for entry in spec.split(","):
        site = entry.strip().partition(":")[0].partition("@")[0].strip()
        if site:
            yield site


@register
class UnknownFaultSite(Rule):
    """RC201: ``maybe_fail``/``fault_scope`` site literals must be members of
    ``repro_torch.fault.SITES``.  The run time tolerates unknown sites (a
    probe that never runs never fires), which is why a mistyped site in a
    chaos spec, or a new probe missing from the registry, stays invisible."""

    id = "RC201"
    title = "fault-site literal not registered in fault.SITES"

    def check_module(self, ctx: Context, path: str, tree: ast.Module):
        if path == _FAULT_REGISTRY:
            return  # the registry itself (docstrings, the plan parser)
        sites = ctx.fault_sites()
        if sites is None:
            return
        for node in nodes(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            if name == "maybe_fail":
                site = _literal_first_arg(node)
                if site is not None and site not in sites:
                    yield self.finding(
                        path, node.lineno,
                        f"maybe_fail site {site!r} is not in fault.SITES; "
                        f"register it in {_FAULT_REGISTRY}", anchor=site)
            elif name == "fault_scope":
                for site in spec_sites(_literal_first_arg(node) or ""):
                    if site not in sites:
                        yield self.finding(
                            path, node.lineno,
                            f"fault_scope spec names unknown site {site!r}; "
                            f"register it in {_FAULT_REGISTRY}", anchor=site)


def _obs_aliases(tree: ast.Module) -> Dict[str, Set[str]]:
    """Local bindings of the obs emit surface: names bound to an ``obs``
    package or its ``trace``/``metrics`` modules, and emit functions
    imported directly (``from repro_torch.obs.trace import span``)."""
    modules: Set[str] = set()
    functions: Set[str] = set()
    for node in nodes(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            if node.module == "repro_torch" or node.module.endswith(".obs"):
                for a in node.names:
                    if a.name in ("obs", "trace", "metrics"):
                        modules.add(a.asname or a.name)
            if node.module.endswith("obs.trace") \
                    or node.module.endswith("obs.metrics"):
                for a in node.names:
                    if a.name in _OBS_FNS:
                        functions.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name in ("repro_torch.obs", "repro_torch.obs.trace",
                              "repro_torch.obs.metrics"):
                    modules.add(a.asname or a.name.split(".")[0])
    return {"modules": modules, "functions": functions}


@register
class UndocumentedObsName(Rule):
    """RC202: span/instant/counter/gauge/histogram name literals emitted
    through the obs modules must appear in the tables of
    ``docs/observability.md`` (the document the JAX package reads too).  A
    method of a private registry instance is not the schema's and is not
    checked."""

    id = "RC202"
    title = "obs event/metric name missing from docs/observability.md"

    def check_module(self, ctx: Context, path: str, tree: ast.Module):
        documented = ctx.documented_obs_names()
        if documented is None:
            return
        aliases = _obs_aliases(tree)
        if not aliases["modules"] and not aliases["functions"]:
            return
        for node in nodes(tree):
            if not isinstance(node, ast.Call):
                continue
            emit = None
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _OBS_FNS:
                parts = _dotted_parts(node.func)
                if parts is not None and parts[0] in aliases["modules"]:
                    emit = node.func.attr
            elif isinstance(node.func, ast.Name) \
                    and node.func.id in aliases["functions"]:
                emit = node.func.id
            if emit is None:
                continue
            name = _literal_first_arg(node)
            if name is not None and name not in documented:
                yield self.finding(
                    path, node.lineno,
                    f"obs {emit} name {name!r} is not documented in "
                    f"docs/observability.md; add it to the schema tables",
                    anchor=name)


def _env_aliases(tree: ast.Module):
    """Names bound to the ``os`` module, to ``os.environ`` and to
    ``os.getenv`` (imports and plain assignments of them)."""
    os_names, environ, getenv = {"os"}, set(), set()
    for node in nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "os":
                    os_names.add(a.asname or "os")
        elif isinstance(node, ast.ImportFrom) and node.module == "os":
            for a in node.names:
                if a.name == "environ":
                    environ.add(a.asname or a.name)
                elif a.name == "getenv":
                    getenv.add(a.asname or a.name)
    for node in nodes(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            parts = _dotted_parts(node.value)
            if parts is None:
                continue
            if parts in ([o, "environ"] for o in os_names) \
                    or (len(parts) == 1 and parts[0] in environ):
                environ.add(node.targets[0].id)
            elif parts in ([o, "getenv"] for o in os_names):
                getenv.add(node.targets[0].id)
    return os_names, environ, getenv


def _is_environ(node: ast.expr, os_names, environ) -> bool:
    parts = _dotted_parts(node)
    return parts is not None and (
        (len(parts) == 2 and parts[0] in os_names and parts[1] == "environ")
        or (len(parts) == 1 and parts[0] in environ))


def _repro_name(node: Optional[ast.expr]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value.startswith("REPRO_"):
        return node.value
    return None


@register
class StrayEnvRead(Rule):
    """RC203: the port reads no ``REPRO_*`` environment variable.  Its
    switches are arguments (``impl=``, ``device=``, ``force_scope``), so a
    read through ``os.environ``, ``os.getenv`` or an alias of either is a
    hidden knob that no caller sees and no test sets."""

    id = "RC203"
    title = "REPRO_* environment read in the port"

    def check_module(self, ctx: Context, path: str, tree: ast.Module):
        os_names, environ, getenv = _env_aliases(tree)
        for node in nodes(tree):
            name = how = None
            if isinstance(node, ast.Call):
                fn = node.func
                first = node.args[0] if node.args else None
                if isinstance(fn, ast.Attribute) and fn.attr in (
                        "get", "pop", "setdefault") \
                        and _is_environ(fn.value, os_names, environ):
                    name, how = _repro_name(first), f"os.environ.{fn.attr}"
                elif _dotted_parts(fn) in ([o, "getenv"] for o in os_names) \
                        or (isinstance(fn, ast.Name) and fn.id in getenv):
                    name, how = _repro_name(first), "os.getenv"
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and _is_environ(node.value, os_names, environ):
                name, how = _repro_name(node.slice), "os.environ[...]"
            elif isinstance(node, ast.Compare) and len(node.ops) == 1 \
                    and isinstance(node.ops[0], (ast.In, ast.NotIn)) \
                    and _is_environ(node.comparators[0], os_names, environ):
                name, how = _repro_name(node.left), "'in os.environ'"
            if name is not None:
                yield self.finding(
                    path, node.lineno,
                    f"{how} read of {name!r}: the port has no environment "
                    f"switches; take it as an argument", anchor=name)
