"""Kernel rules (CU1xx): the CUDA twins of the JAX package's Pallas lints
(PK1xx), and the ctypes contract between each kernel's wrapper and its
``extern "C"`` entry.

The sources under ``src/repro_torch/csrc/`` share one copy protocol:
asynchronous global -> shared copies go through ``common.cuh``'s helpers
(``cp_async16``, ``cp_async4`` and their ``_zfill`` forms), are closed into
groups by ``cp_async_commit`` and drained by ``cp_async_wait<N>`` before the
shared memory is read.  A copy group that is never waited on races with the
reads of its shared memory; small test sizes can miss it.  These rules read
the ``.cu``/``.cuh`` text without a compiler: comments and string contents
are blanked (offsets and line numbers kept), and functions are split by
brace matching.

  * CU101 (after PK101): a function that issues ``cp_async*`` copies
    commits them and waits after its last commit (in a pipelined loop, the
    wait at the top of the next iteration).
  * CU102 (after PK102): raw ``cp.async`` inline assembly only inside
    ``common.cuh``'s ``cp_async*`` helpers, so the protocol has one audited
    implementation.
  * CU104 (after PK104): no half-precision arithmetic intrinsics
    (``__hmul``, ``__hfma``, ``__hadd`` ...): products are accumulated in
    f32, as ``dot_f32`` makes the Pallas kernels do.
  * CU106 (the port's own): each ``CudaKernel(...)`` declaration agrees with
    its C entry (count and types of the parameters, the shared-memory size
    where ``sized_smem``), and its ``replaces`` names the line of a JAX
    function that reaches ``pallas_call``.

PK103 (an ANY-memory operand indexed directly) has no twin: a CUDA thread
may read global memory directly, and the gathers of these kernels do so by
design.  PK105 (a DMA scratch with both double-buffer halves) has none
either: the kernels carve their rings out of one dynamic ``extern
__shared__`` array at offsets computed at run time, so the slot count is not
in the text; the ring's bytes are checked instead, by DP301/DP302 against
the wrappers' counts and by CU106's ``sized_smem`` contract.
"""
from __future__ import annotations

import ast
import bisect
import dataclasses
import functools
import re
from typing import List, Optional

from repro_torch.analysis.engine import Context, Rule, nodes, register

# ---------------------------------------------------------------------------
# A compiler-free reading of CUDA C++ text
# ---------------------------------------------------------------------------


_LEXEMES = re.compile(r"//[^\n]*|/\*.*?\*/|\"(?:\\.|[^\"\\\n])*\"?"
                      r"|'(?:\\.|[^'\\\n])*'?", re.S)


@functools.lru_cache(maxsize=64)
def blank(text: str, strings: bool = True) -> str:
    """``text`` with comments (and, where ``strings``, the contents of
    string and character literals) replaced by spaces; newlines, offsets and
    the quotes themselves stay, so line numbers and positions are the
    source's."""
    def sub(m):
        tok = m.group(0)
        if tok.startswith("/"):
            return re.sub(r"[^\n]", " ", tok)
        if not strings or len(tok) < 2:
            return tok
        closed = tok[-1] == tok[0]
        inner = tok[1:-1] if closed else tok[1:]
        return tok[0] + " " * len(inner) + (tok[0] if closed else "")

    return _LEXEMES.sub(sub, text)


@dataclasses.dataclass
class CFunction:
    name: str
    params: List[str]   # the parameter list's entries, whitespace-squeezed
    body_start: int     # offset of the body's "{"
    body_end: int       # offset just past the body's "}"
    extern_c: bool


_CONTAINER = re.compile(r"^(namespace\b[\w:\s]*|extern\s+\"[^\"]*\"|"
                        r"(template\s*<.*>\s*)?(struct|class|union|enum)\b[^()]*)$")
_DIRECTIVE = re.compile(r"^[ \t]*#(?:[^\n]*\\\n)*[^\n]*", re.M)
_NOT_FUNCTION = re.compile(r"^(if|for|while|switch|do|else|return|catch)\b")


def _match(text: str, i: int, open_: str, close: str) -> int:
    """Offset just past the bracket closing the one at ``i``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_:
            depth += 1
        elif text[j] == close:
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


def _split_params(inner: str) -> List[str]:
    parts, depth, cur = [], 0, []
    for ch in inner:
        if ch in "(<[":
            depth += 1
        elif ch in ")>]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    parts = [" ".join(p.split()) for p in parts]
    return [] if parts in ([""], ["void"]) else parts


@functools.lru_cache(maxsize=64)
def functions(text: str) -> List[CFunction]:
    """The function definitions of blanked ``text`` at namespace scope
    (inside ``namespace`` and ``extern "C"`` blocks too); lambdas and nested
    blocks belong to their enclosing function."""
    out: List[CFunction] = []
    text = _DIRECTIVE.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)), text)

    def scan(lo: int, hi: int, extern_c: bool) -> None:
        stmt = lo
        i = lo
        while i < hi:
            ch = text[i]
            if ch in ";}":
                stmt = i + 1
            elif ch == "(":
                i = _match(text, i, "(", ")")
                continue
            elif ch == "{":
                header = " ".join(text[stmt:i].split())
                end = _match(text, i, "{", "}")
                container = _CONTAINER.match(header)
                if container:
                    scan(i + 1, end - 1,
                         extern_c or header.startswith("extern"))
                elif header.endswith(")") and "=" not in header.split("(")[0] \
                        and not _NOT_FUNCTION.match(header):
                    close = len(header)
                    open_ = _open_of(header, close - 1)
                    name = re.findall(r"([A-Za-z_]\w*)\s*$", header[:open_])
                    if name:
                        out.append(CFunction(
                            name=name[0],
                            params=_split_params(header[open_ + 1:close - 1]),
                            body_start=i, body_end=end,
                            extern_c=extern_c
                            or header.startswith("extern \"")))
                i = end
                stmt = i
                continue
            i += 1

    scan(0, len(text), False)
    return out


def _open_of(s: str, close: int) -> int:
    depth = 0
    for j in range(close, -1, -1):
        if s[j] == ")":
            depth += 1
        elif s[j] == "(":
            depth -= 1
            if depth == 0:
                return j
    return 0


class LineIndex:
    def __init__(self, text: str):
        self.starts = [0] + [m.end() for m in re.finditer("\n", text)]

    def line(self, offset: int) -> int:
        return bisect.bisect_right(self.starts, offset)


def _enclosing(funcs: List[CFunction], offset: int) -> Optional[CFunction]:
    for f in funcs:
        if f.body_start <= offset < f.body_end:
            return f
    return None


# ---------------------------------------------------------------------------
# CU101 / CU102 / CU104
# ---------------------------------------------------------------------------

_COPY = re.compile(r"\bcp_async(?:16|4)(?:_zfill)?\s*\(")
_COMMIT = re.compile(r"\bcp_async_commit\s*\(")
_WAIT = re.compile(r"\bcp_async_wait\s*<")
_ASM = re.compile(r"\basm\b(?:\s+volatile\b|\s+__volatile__\b)?\s*\(")
_HALF_MATH = re.compile(
    r"\b(__h2?(?:add|sub|mul|fma|div|neg|abs|max|min)2?(?:_rn|_sat|_relu)?"
    r"|__h2div)\s*\(")
_COMMON = "csrc/common.cuh"


_LAMBDA = re.compile(r"\bauto\s+([A-Za-z_]\w*)\s*=\s*\[[^\]]*\]\s*\(")
_LOOP = re.compile(r"\b(?:for|while)\s*\(|\bdo\s*\{")
_IF = re.compile(r"\bif\s*\(")


def _block_after(body: str, i: int) -> tuple:
    """The range of the statement at offset ``i``: a braced block, or up to
    its ``;``."""
    while i < len(body) and body[i].isspace():
        i += 1
    if i < len(body) and body[i] == "{":
        return i, _match(body, i, "{", "}")
    j = i
    depth = 0
    while j < len(body):
        if body[j] in "({[":
            depth += 1
        elif body[j] in ")}]":
            depth -= 1
        elif body[j] == ";" and depth == 0:
            return i, j + 1
        j += 1
    return i, j


def _controlled(body: str, pattern) -> List[tuple]:
    """The ranges of the statements that ``if``/loop heads control."""
    out = []
    for m in pattern.finditer(body):
        if body[m.end() - 1] == "{":  # do {
            out.append((m.end() - 1, _match(body, m.end() - 1, "{", "}")))
        else:
            out.append(_block_after(body, _match(body, m.end() - 1, "(", ")")))
    return out


def protocol_events(body: str) -> dict:
    """Offsets of the copies, commits and waits a function body runs:
    ``cp_async*`` calls, and calls of a lambda of the body that makes them
    (at the call, in the lambda's order, not in the lambda's text).
    ``"guarded"`` holds the copies of lambdas whose every copy is under an
    ``if`` of the lambda's own."""
    kinds = (("copy", _COPY), ("commit", _COMMIT), ("wait", _WAIT))
    ifs = _controlled(body, _IF)
    lambdas = []
    for m in _LAMBDA.finditer(body):
        lo = body.find("{", _match(body, m.end() - 1, "(", ")"))
        hi = _match(body, lo, "{", "}")
        does = [k for k, rx in kinds if rx.search(body, lo, hi)]
        guarded = all(any(lo <= a <= c.start() < b <= hi for a, b in ifs)
                      for c in _COPY.finditer(body, lo, hi))
        if does:
            lambdas.append((m.group(1), m.start(), hi, does, guarded))
    events = {k: [m.start() for m in rx.finditer(body)
                  if not any(lo <= m.start() < hi
                             for _, lo, hi, _, _ in lambdas)]
              for k, rx in kinds}
    events["guarded"] = []
    for name, lo, hi, does, guarded in lambdas:
        for m in re.finditer(rf"\b{name}\s*\(", body):
            if lo <= m.start() < hi:
                continue
            for step, k in enumerate(does):
                events[k].append(m.start() + step)
            if guarded and "copy" in does:
                events["guarded"].append(m.start())
    return {k: sorted(v) for k, v in events.items()}


def drained(body: str, events: dict) -> bool:
    """Whether a wait follows the last group committed: one after it in the
    text, or, where the commit sits in a loop, the wait earlier in the
    loop's body that the next iteration runs, provided the copies the body
    issues between that wait and the commit are under an ``if`` (at the
    call or inside the lambda making them): the walk's end, so the last
    iteration's group is empty."""
    commit, waits = events["commit"][-1], events["wait"]
    if any(w > commit for w in waits):
        return True
    loops = [(lo, hi) for lo, hi in _controlled(body, _LOOP)
             if lo <= commit < hi]
    if not loops:
        return False
    lo, hi = max(loops)  # the innermost loop
    first = min((w for w in waits if lo <= w < commit), default=None)
    if first is None:
        return False
    guards = [(a, b) for a, b in _controlled(body, _IF) if lo <= a and b <= hi]
    return all(c in events["guarded"] or any(a <= c < b for a, b in guards)
               for c in events["copy"] if first < c < commit)


@register
class UndrainedAsyncCopy(Rule):
    """CU101: a function that issues ``cp_async*`` copies (itself or
    through a lambda of its own) commits every copy into a group (a
    ``cp_async_commit`` after its last copy) and waits (``cp_async_wait<N>``)
    after its last commit.  In a pipelined loop the wait at the top of the
    body drains the group the previous iteration committed; the last
    iteration's group must then be empty, which the rule reads as: the
    body's copies between that wait and the commit are under an ``if``.  A
    group left uncommitted or never waited on lets the block read shared
    memory the copy has not written yet.  The text shows neither that the
    ``if`` is the walk's end nor what a ``cp_async_wait<N>`` with N > 0
    leaves in flight: the rule trusts both."""

    id = "CU101"
    title = "cp.async copies not committed and waited on"

    def check_source(self, ctx: Context, path: str, text: str):
        clean = blank(text)
        lines = LineIndex(clean)
        for fn in functions(clean):
            body = clean[fn.body_start:fn.body_end]
            events = protocol_events(body)
            copies, commits = events["copy"], events["commit"]
            if not copies:
                continue
            if not commits or commits[-1] < copies[-1]:
                yield self.finding(
                    path, lines.line(fn.body_start + copies[-1]),
                    f"{fn.name}() issues cp_async copies after its last "
                    f"cp_async_commit(): they are never committed to a group",
                    anchor=f"{fn.name}.commit")
            elif not drained(body, events):
                yield self.finding(
                    path, lines.line(fn.body_start + commits[-1]),
                    f"{fn.name}() commits cp_async copies that no "
                    f"cp_async_wait<N>() drains before it ends: the group "
                    f"races with the reads of its shared memory",
                    anchor=f"{fn.name}.wait")


@register
class RawCpAsyncAsm(Rule):
    """CU102: ``cp.async`` inline assembly belongs to ``common.cuh``'s
    ``cp_async*`` helpers alone, the one audited statement of the copy
    protocol (sizes, cache hints, the zero-fill form)."""

    id = "CU102"
    title = "raw cp.async inline assembly outside common.cuh's helpers"

    def check_source(self, ctx: Context, path: str, text: str):
        code = blank(text, strings=False)
        funcs = functions(blank(text))
        lines = LineIndex(code)
        for m in _ASM.finditer(code):
            end = _match(code, m.end() - 1, "(", ")")
            if "cp.async" not in code[m.start():end]:
                continue
            fn = _enclosing(funcs, m.start())
            if path.endswith(_COMMON) and fn is not None \
                    and fn.name.startswith("cp_async"):
                continue
            where = fn.name if fn is not None else "module"
            yield self.finding(
                path, lines.line(m.start()),
                f"raw cp.async inline assembly in {where}(); use "
                f"common.cuh's cp_async16/cp_async4 helpers and "
                f"cp_async_commit/cp_async_wait", anchor=where)


@register
class HalfPrecisionMath(Rule):
    """CU104: no half-precision arithmetic intrinsics.  The kernels convert
    each operand to f32 (``to_f32``) and accumulate in f32, the twin of the
    Pallas kernels' ``dot_f32``; a ``__hmul``/``__hfma`` product rounds to
    16 bits at every step and breaks the bitwise agreement with the plain
    versions."""

    id = "CU104"
    title = "half-precision arithmetic intrinsic in a kernel"

    def check_source(self, ctx: Context, path: str, text: str):
        clean = blank(text)
        funcs = functions(clean)
        lines = LineIndex(clean)
        for m in _HALF_MATH.finditer(clean):
            fn = _enclosing(funcs, m.start())
            where = fn.name if fn is not None else "module"
            yield self.finding(
                path, lines.line(m.start()),
                f"{m.group(1)} in {where}(): half-precision arithmetic; "
                f"convert with to_f32 and accumulate in f32",
                anchor=f"{where}.{m.group(1)}")


# ---------------------------------------------------------------------------
# CU106: the ctypes ABI
# ---------------------------------------------------------------------------

CTYPES_OF = {"pointer": "c_void_p", "int": "c_int", "long long": "c_longlong",
             "float": "c_float", "double": "c_double"}
_QUALIFIERS = {"const", "volatile", "__restrict__", "restrict", "signed"}
_TYPE_WORDS = {"int", "long", "float", "double", "void", "char", "short",
               "unsigned", "size_t", "cudaStream_t"}


def c_param_type(param: str) -> str:
    """The C type of one parameter, as a key of :data:`CTYPES_OF` where it
    is one of those ("pointer" for any pointer), else its words."""
    if "*" in param or "[" in param:
        return "pointer"
    words = [w for w in re.findall(r"[A-Za-z_]\w*", param)
             if w not in _QUALIFIERS]
    if len(words) > 1 and words[-1] not in _TYPE_WORDS:
        words = words[:-1]  # the parameter's name
    return " ".join(words)


def _param_name(param: str) -> str:
    words = re.findall(r"[A-Za-z_]\w*", param)
    return words[-1] if words else ""


class _Unreadable(Exception):
    pass


def eval_argtypes(node: ast.expr) -> List[str]:
    """The ctypes names of an ``argtypes`` expression: lists of
    ``ctypes.c_*`` (or bare ``c_*``), joined by ``+`` and repeated by
    ``* <int>``."""
    if isinstance(node, (ast.List, ast.Tuple)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
                    and e.value.id == "ctypes":
                out.append(e.attr)
            elif isinstance(e, ast.Name) and e.id.startswith("c_"):
                out.append(e.id)
            else:
                raise _Unreadable(ast.unparse(e))
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return eval_argtypes(node.left) + eval_argtypes(node.right)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, count in ((node.left, node.right), (node.right, node.left)):
            if isinstance(count, ast.Constant) and isinstance(count.value, int):
                return eval_argtypes(seq) * count.value
    raise _Unreadable(ast.unparse(node))


@dataclasses.dataclass
class KernelDecl:
    """One ``CudaKernel(...)`` call of the port, read from its AST."""

    line: int
    name: Optional[str]
    symbol: Optional[str]
    argtypes: ast.expr
    source: Optional[str]
    replaces: Optional[str]
    sized_smem: bool


def _const(node) -> Optional[object]:
    if node is None:
        return None
    try:
        return ast.literal_eval(node)
    except ValueError:
        return None


def kernel_decls(tree: ast.Module) -> List[KernelDecl]:
    out = []
    for node in nodes(tree):
        if not (isinstance(node, ast.Call) and (
                (isinstance(node.func, ast.Name)
                 and node.func.id == "CudaKernel")
                or (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "CudaKernel"))):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        pos = list(node.args) + [None] * 3
        out.append(KernelDecl(
            line=node.lineno, name=_const(kw.get("name", pos[0])),
            symbol=_const(kw.get("symbol", pos[1])),
            argtypes=kw.get("argtypes", pos[2]),
            source=_const(kw.get("source")),
            replaces=_const(kw.get("replaces")),
            sized_smem=bool(_const(kw.get("sized_smem")))))
    return out


_REPLACES = re.compile(r"^(\S+):(\d+) ([A-Za-z_]\w*)$")


def reaches_pallas_call(tree: ast.Module, fn_name: str) -> bool:
    """Whether module function ``fn_name`` calls ``pallas_call``, itself or
    through the module's other functions it calls by name."""
    defs = {n.name: n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    seen, todo = set(), [fn_name]
    while todo:
        name = todo.pop()
        if name in seen or name not in defs:
            continue
        seen.add(name)
        for node in ast.walk(defs[name]):
            if not isinstance(node, ast.Call):
                continue
            callee = node.func
            if isinstance(callee, ast.Attribute) and callee.attr == "pallas_call":
                return True
            if isinstance(callee, ast.Name):
                if callee.id == "pallas_call":
                    return True
                todo.append(callee.id)
    return False


@register
class KernelAbiMismatch(Rule):
    """CU106: a ``CudaKernel`` declaration and its C entry agree.  ctypes
    passes whatever ``argtypes`` says, so a parameter too few, or an ``int``
    where the entry takes a ``long long``, launches with wrong arguments and
    raises nothing.  Checked: ``source`` exists and defines ``symbol`` as
    ``extern "C"``; its parameters are ``argtypes``, then a ``long long``
    shared-memory size exactly where ``sized_smem``, then the stream; each
    type matches (pointer to ``c_void_p``, ``int`` to ``c_int``, ``long
    long`` to ``c_longlong``, ``float`` to ``c_float``); and ``replaces``
    reads ``path:line function`` with the ``def`` of ``function`` at that
    line of the JAX source, a function that reaches ``pallas_call``."""

    id = "CU106"
    title = "CudaKernel declaration disagrees with its C entry or its TPU kernel"

    def check_module(self, ctx: Context, path: str, tree: ast.Module):
        decls = kernel_decls(tree)
        if not decls or ctx.root is None:
            return
        for d in decls:
            yield from self._check(ctx, path, d)

    def _check(self, ctx: Context, path: str, d: KernelDecl):
        sym = d.symbol or d.name or "kernel"

        def bad(what, msg):
            return self.finding(path, d.line, f"{d.name}: {msg}",
                                anchor=f"{sym}.{what}")

        try:
            argtypes = eval_argtypes(d.argtypes)
        except _Unreadable as e:
            yield bad("argtypes", f"argtypes entry {e} is not a ctypes type "
                                  "the checker can read")
            return
        if d.replaces is not None:
            yield from (bad("replaces", m)
                        for m in self._replaces(ctx, d.replaces))
        src = ctx.root / d.source if d.source else None
        if src is None or not src.is_file():
            yield bad("source", f"source {d.source!r} does not exist")
            return
        entry = next((f for f in functions(blank(src.read_text()))
                      if f.name == d.symbol), None)
        if entry is None or not entry.extern_c:
            yield bad("source", f"{d.source} defines no extern \"C\" "
                                f"{d.symbol!r}")
            return
        params = entry.params
        ctypes_params = [CTYPES_OF.get(c_param_type(p)) for p in params]
        has_smem = (len(params) >= 2 and c_param_type(params[-2]) == "long long"
                    and "smem" in _param_name(params[-2]))
        if has_smem != d.sized_smem:
            yield bad("sized_smem",
                      f"sized_smem={d.sized_smem}, but {d.symbol} "
                      f"{'takes' if has_smem else 'takes no'} a long long "
                      f"shared-memory size")
        want = len(argtypes) + int(d.sized_smem) + 1
        if len(params) != want:
            yield bad("count",
                      f"{len(argtypes)} argtypes{' + smem' * d.sized_smem} + "
                      f"stream = {want} parameters, but {d.symbol} in "
                      f"{d.source} takes {len(params)}")
            return
        for i, (have, c) in enumerate(zip(argtypes, ctypes_params)):
            if have != c:
                yield bad("types",
                          f"argument {i} is ctypes.{have}, but {d.symbol}'s "
                          f"parameter {i} is {params[i]!r}")
                return
        if d.sized_smem and ctypes_params[-2] != "c_longlong":
            yield bad("types", f"{d.symbol}'s shared-memory size is "
                               f"{params[-2]!r}, not long long")
        if ctypes_params[-1] != "c_void_p":
            yield bad("types", f"{d.symbol}'s last parameter {params[-1]!r} "
                               "is not the stream (a pointer)")

    def _replaces(self, ctx: Context, replaces: str):
        m = _REPLACES.match(replaces)
        if m is None:
            yield f"replaces {replaces!r} does not read 'path:line function'"
            return
        rel, line, fn = m.group(1), int(m.group(2)), m.group(3)
        jax_src = ctx.root / rel
        if not jax_src.is_file():
            yield f"replaces names {rel}, which does not exist"
            return
        text = jax_src.read_text()
        lines = text.splitlines()
        if not (0 < line <= len(lines)
                and re.match(rf"\s*def\s+{fn}\s*\(", lines[line - 1])):
            yield (f"replaces {replaces!r}: line {line} of {rel} is not "
                   f"the def of {fn}")
            return
        if not reaches_pallas_call(ast.parse(text), fn):
            yield f"replaces {replaces!r}: {fn} does not reach pallas_call"
