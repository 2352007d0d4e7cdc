"""Lint core: module model, finding model, checker registry, baseline.

A *finding* carries a stable ``key`` (``checker:path:symbol`` — no line
numbers, so unrelated edits don't churn the baseline) plus the file:line
for humans. Suppression, in priority order:

- inline: a ``# lint: ignore[<checker>] — reason`` comment on the flagged
  line (use sparingly; the reason is part of the convention);
- baseline: an entry in the checked-in baseline JSON
  (``tools/lint/baseline.json``), each with a mandatory ``reason`` —
  the accepted-violation set, ideally empty.

Shared-work tier: ``load_modules`` keeps a cross-run parse cache
(one ``ast.parse`` + tokenize per file *content*, reused by every family
and every ``run_lint`` call), each :class:`LintContext` carries a
``memo`` dict the expensive cross-family artifacts hang off (the lock
class table, the import-resolution index), and :mod:`dataflow` memoizes
CFG construction per function node — so 14 families cost one parse, one
class scan, one index, and one CFG per function, not 14.

Families registered with ``whole_program=True`` (thread topology,
config-key conformance) reason over the *entire* package at once: under
a scoped run (``--changed``) they are handed the full-package context
and only their findings are filtered down to the selected files — a
spawn-site edit in file A can surface a role violation in untouched
file B, and scoping must not hide the edge, only the noise.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_IGNORE_RE = re.compile(r"lint:\s*ignore\[([a-z\-,\s]+)\]")

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")


@dataclass(frozen=True)
class Finding:
    checker: str   # lock-guard | lock-order | pairing | tracer | wire | config
    path: str      # path as scanned (relative when the scan root is)
    line: int
    symbol: str    # stable anchor: Class.field:method, func qualname, key...
    message: str

    @property
    def key(self) -> str:
        return f"{self.checker}:{self.path}:{self.symbol}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}"


class Module:
    """One parsed source file: AST + raw lines + comment map (the AST drops
    comments, and ``# guarded-by:`` / ``# lint: ignore`` live in them)."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        self.comments: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(source).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = \
                        tok.string.lstrip("#").strip()
        except (tokenize.TokenError, IndentationError):  # partial map is ok
            pass

    def comment_in_range(self, lo: int, hi: int,
                         pattern: "re.Pattern") -> Optional["re.Match"]:
        """First comment line in [lo, hi] matching ``pattern`` (multi-line
        statements carry their annotation on any of their lines)."""
        for ln in range(lo, hi + 1):
            c = self.comments.get(ln)
            if c:
                m = pattern.search(c)
                if m:
                    return m
        return None

    def ignored(self, line: int, checker: str) -> bool:
        m = _IGNORE_RE.search(self.comments.get(line, ""))
        if m is None:
            return False
        names = {s.strip() for s in m.group(1).split(",")}
        return checker in names or "all" in names


class LintContext:
    """Everything a checker sees: the parsed modules, keyed by relpath.

    ``memo`` is the per-run shared-artifact cache: families that build
    the same expensive structure (the ``# guarded-by:`` class table, the
    import-resolution index) stash it here so the 14-family suite pays
    for it once. Keys are namespaced strings (``"lint.classes"``,
    ``"lint.index"``); values must be treated as immutable by readers.
    """

    def __init__(self, modules: List[Module]):
        self.modules = modules
        self.by_path: Dict[str, Module] = {m.relpath: m for m in modules}
        self.memo: Dict[str, object] = {}

    def module_of(self, relpath: str) -> Optional[Module]:
        return self.by_path.get(relpath)


# -- registry ---------------------------------------------------------------

CheckFn = Callable[[LintContext], List[Finding]]
_CHECKERS: List[Tuple[str, CheckFn]] = []
_WHOLE_PROGRAM: set = set()


def register(name: str, whole_program: bool = False):
    """Register a checker family. ``whole_program=True`` marks families
    whose findings depend on files *outside* the scanned set (the thread
    spawn graph, package-wide config-key rules): scoped runs give them
    the full package and filter their findings, instead of starving them
    of the cross-file edges they exist to check."""
    def deco(fn: CheckFn) -> CheckFn:
        _CHECKERS.append((name, fn))
        if whole_program:
            _WHOLE_PROGRAM.add(name)
        return fn
    return deco


def whole_program_families() -> frozenset:
    _load_checkers()
    return frozenset(_WHOLE_PROGRAM)


def checker_names() -> List[str]:
    _load_checkers()
    return [n for n, _ in _CHECKERS]


_LOADED = False


def _load_checkers() -> None:
    """Import the checker modules exactly once (registration side effect)."""
    global _LOADED
    if _LOADED:
        return
    from pinot_tpu_torch.tools.lint import (  # noqa: F401
        configkeys,
        conservation,
        decisions,
        declines,
        device,
        exactness,
        locks,
        pairing,
        protocol,
        sync,
        threads,
        tracer,
        wire,
    )
    _LOADED = True


# -- file collection --------------------------------------------------------

def _collect_files(paths: Sequence[str]) -> List[Tuple[str, str]]:
    """-> [(abspath, display path)], deterministic order."""
    out: List[Tuple[str, str]] = []
    for p in paths:
        if os.path.isfile(p):
            out.append((p, os.path.basename(p)))
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d != "__pycache__" and not d.startswith("."))
            for f in sorted(files):
                if f.endswith(".py"):
                    ap = os.path.join(root, f)
                    out.append((ap, os.path.relpath(ap, os.path.dirname(p))))
    return out


# (abspath, display path) -> parsed Module, reused across run_lint calls
# when the file CONTENT is unchanged (compared exactly — mtimes lie on
# fast rewrites). One ast.parse + tokenize per file per edit, however
# many families or consecutive runs consume it. Bounded: cleared
# wholesale past the cap (fixture-heavy test sessions churn tmp files).
_MODULE_CACHE: Dict[Tuple[str, str], Module] = {}
_MODULE_CACHE_CAP = 4096


def load_modules(paths: Sequence[str]) -> Tuple[LintContext, List[Finding]]:
    modules: List[Module] = []
    findings: List[Finding] = []
    for ap, rel in _collect_files(paths):
        try:
            with open(ap, encoding="utf-8") as f:
                src = f.read()
            key = (os.path.abspath(ap), rel)
            hit = _MODULE_CACHE.get(key)
            if hit is not None and hit.source == src:
                modules.append(hit)
                continue
            m = Module(ap, rel, src)
            if len(_MODULE_CACHE) >= _MODULE_CACHE_CAP:
                _MODULE_CACHE.clear()
            _MODULE_CACHE[key] = m
            modules.append(m)
        except SyntaxError as e:
            findings.append(Finding(
                "parse", rel, e.lineno or 0, "syntax",
                f"cannot parse: {e.msg}"))
    return LintContext(modules), findings


# -- changed-file selection (--changed <git-ref>) ---------------------------

def _imported_modules(tree: ast.AST) -> List[str]:
    """Dotted module names a parsed file imports (absolute imports; the
    codebase convention). ``from a.b import c`` contributes both ``a.b``
    and ``a.b.c`` — ``c`` may be a module."""
    out: List[str] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.append(node.module)
            out.extend(f"{node.module}.{a.name}" for a in node.names)
    return out


def build_import_graph(pkg_dir: str) -> Dict[str, List[str]]:
    """abs file -> abs files it imports, over one package tree."""
    pkg_name = os.path.basename(os.path.normpath(pkg_dir))
    parent = os.path.dirname(os.path.normpath(pkg_dir))

    def module_file(dotted: str) -> Optional[str]:
        if not dotted.startswith(pkg_name + ".") and dotted != pkg_name:
            return None
        rel = dotted.split(".")
        cand = os.path.join(parent, *rel) + ".py"
        if os.path.isfile(cand):
            return cand
        init = os.path.join(parent, *rel, "__init__.py")
        return init if os.path.isfile(init) else None

    graph: Dict[str, List[str]] = {}
    for ap, _rel in _collect_files([pkg_dir]):
        try:
            with open(ap, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=ap)
        except SyntaxError:
            graph[ap] = []
            continue
        deps = []
        for dotted in _imported_modules(tree):
            mf = module_file(dotted)
            if mf and mf != ap:
                deps.append(mf)
        graph[ap] = sorted(set(deps))
    return graph


def select_changed(ref: str, pkg_dir: str) -> List[str]:
    """Package files to lint for ``--changed <ref>``: files changed vs
    the git ref, plus their DIRECT imports (interprocedural families
    compare against the modules a changed file talks to — protocol needs
    plan.py next to a changed consumer) plus their TRANSITIVE reverse
    importers (a changed module can break every consumer's obligations).
    """
    import subprocess

    pkg_dir = os.path.abspath(pkg_dir)
    res = subprocess.run(
        ["git", "diff", "--name-only", ref, "--", "*.py"],
        cwd=pkg_dir, capture_output=True, text=True, check=True)
    root = subprocess.run(
        ["git", "rev-parse", "--show-toplevel"],
        cwd=pkg_dir, capture_output=True, text=True, check=True
    ).stdout.strip()
    changed = set()
    for line in res.stdout.splitlines():
        ap = os.path.abspath(os.path.join(root, line.strip()))
        if ap.startswith(pkg_dir + os.sep) and os.path.isfile(ap):
            changed.add(ap)
    if not changed:
        return []
    graph = build_import_graph(pkg_dir)
    importers: Dict[str, List[str]] = {}
    for src, deps in graph.items():
        for d in deps:
            importers.setdefault(d, []).append(src)
    selected = set(changed)
    frontier = list(changed)              # reverse: transitive
    while frontier:
        f = frontier.pop()
        for imp in importers.get(f, []):
            if imp not in selected:
                selected.add(imp)
                frontier.append(imp)
    # forward: one hop of context for EVERY selected file — base classes
    # (inherited lock annotations), pack-side plan.py for protocol, the
    # tracing/config tables — without pulling the transitive world in
    for f in list(selected):
        selected.update(graph.get(f, []))
    return sorted(selected)


# -- baseline ---------------------------------------------------------------

def load_baseline(path: Optional[str]) -> Dict[str, str]:
    """-> {finding key: reason}. Missing file = empty baseline."""
    if not path or not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    out: Dict[str, str] = {}
    for e in data.get("entries", []):
        out[e["key"]] = e.get("reason", "")
    return out


# -- runner -----------------------------------------------------------------

def run_lint(paths: Sequence[str], baseline: Optional[str] = None,
             families: Optional[Sequence[str]] = None,
             whole_program_root: Optional[str] = None
             ) -> Tuple[List[Finding], List[Finding]]:
    """Run every registered checker over ``paths``.

    ``families`` restricts the run to the named checker families
    (parse errors always report). ``whole_program_root`` (set by
    ``--changed``) names the package directory whole-program families
    analyze in full: they see every package file — the spawn graph and
    config-key universe don't truncate at the changed set — and their
    findings are then scoped down to the files in ``paths``. Returns
    ``(new, accepted)``: findings not covered by the baseline, and
    findings the baseline (or an inline ignore) covers. Exit policy is
    the caller's (the CLI exits non-zero iff ``new`` is non-empty).
    """
    _load_checkers()
    if families is not None:
        wanted = set(families)
        unknown = wanted - {n for n, _ in _CHECKERS}
        if unknown:
            raise ValueError(
                f"unknown lint families {sorted(unknown)}; "
                f"known: {[n for n, _ in _CHECKERS]}")
    ctx, findings = load_modules(paths)
    wp_ctx: Optional[LintContext] = None
    selected_abs: set = set()
    if whole_program_root is not None and any(
            n in _WHOLE_PROGRAM for n, _ in _CHECKERS
            if families is None or n in families):
        wp_ctx, _ = load_modules([whole_program_root])
        selected_abs = {os.path.abspath(m.path) for m in ctx.modules}
    for name, fn in _CHECKERS:
        if families is not None and name not in families:
            continue
        if wp_ctx is not None and name in _WHOLE_PROGRAM:
            for f in fn(wp_ctx):
                m = wp_ctx.module_of(f.path)
                if m is None or os.path.abspath(m.path) in selected_abs:
                    findings.append(f)
        else:
            findings.extend(fn(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.checker, f.symbol))

    accepted_keys = load_baseline(baseline)
    new: List[Finding] = []
    accepted: List[Finding] = []
    for f in findings:
        mod = ctx.module_of(f.path)
        if mod is None and wp_ctx is not None:
            mod = wp_ctx.module_of(f.path)
        if mod is not None and mod.ignored(f.line, f.checker):
            accepted.append(f)
        elif f.key in accepted_keys:
            accepted.append(f)
        else:
            new.append(f)
    return new, accepted


# -- shared AST helpers (used by several checkers) --------------------------

def call_name(node: ast.Call) -> Optional[str]:
    """Last path segment of the called thing: ``a.b.c(...)`` -> 'c'."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def attr_base_name(node: ast.expr) -> Optional[str]:
    """Root Name of an attribute chain: ``a.b.c`` -> 'a'; None otherwise."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def is_self_attr(node: ast.expr, attr: Optional[str] = None) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and (attr is None or node.attr == attr))
