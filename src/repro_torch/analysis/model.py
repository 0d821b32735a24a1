"""Shared project model for the invariant checkers (DESIGN.md §15).

A ``Project`` is a set of parsed ``Module`` trees keyed by repo-relative
path plus access to non-Python resources (DESIGN.md). Checkers
are pure functions over that model: they never import repo code, so the
analyzer runs without jax/numpy installed and can never be confused by
import-time side effects.

Suppression has two layers, both explicit and reviewable:

* ``# lint: allow(<rule>[, <rule>...])`` on the offending line or on a
  comment-only line directly above it — for violations that are by
  design. Each allow should carry a justification comment.
* a checked-in baseline (``src/repro_torch/analysis/baseline.json``,
  inside the package: the reference's ``tools/`` stays its own) listing
  findings that predate a rule — shipped EMPTY and expected to stay so
  (real violations get fixed, not baselined).
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: subdirectories of the repo root that are scanned for Python modules:
#: the port, and the homes of its benchmarks and their gate once they
#: exist (the reference's ``src/repro``, ``benchmarks`` and ``tools`` are
#: ``repro.analysis``'s)
DEFAULT_SUBDIRS = ("src/repro_torch", "benchmarks_torch", "tools_torch")

#: default location of the baseline file, relative to the repo root
BASELINE_RELPATH = "src/repro_torch/analysis/baseline.json"

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\(([\w\s,-]+)\)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a file:line."""
    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    severity: str = "error"  # "error" gates CI; "warning" is informational

    def key(self) -> Tuple[str, str, int]:
        return (self.rule, self.path, self.line)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Module:
    """One parsed Python source file: AST + per-line allowlist."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        # 1-based line -> set of rule names allowed on that line
        self.allow: Dict[int, set] = {}
        for i, line in enumerate(self.lines, 1):
            m = _ALLOW_RE.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                if rules:
                    self.allow[i] = rules

    def _comment_only(self, lineno: int) -> bool:
        if not (1 <= lineno <= len(self.lines)):
            return False
        return self.lines[lineno - 1].lstrip().startswith("#")

    def allowed(self, rule: str, lineno: int) -> bool:
        """True if ``rule`` is suppressed at ``lineno`` — by a trailing
        ``# lint: allow(rule)`` on the same line, or by one on a
        comment-only line directly above."""
        if rule in self.allow.get(lineno, ()):
            return True
        prev = lineno - 1
        return (rule in self.allow.get(prev, ())
                and self._comment_only(prev))

    def allow_count(self, rule: str) -> int:
        """Number of allow annotations naming ``rule`` in this module."""
        return sum(1 for rules in self.allow.values() if rule in rules)


class Project:
    """All scanned modules plus lazy access to non-Python root files."""

    def __init__(self, root: Optional[str], modules: Dict[str, Module]):
        self.root = root
        self.modules = modules

    @classmethod
    def load(cls, root: str,
             subdirs: Sequence[str] = DEFAULT_SUBDIRS) -> "Project":
        modules: Dict[str, Module] = {}
        for sub in subdirs:
            base = os.path.join(root, sub)
            if not os.path.isdir(base):
                continue
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = sorted(d for d in dirnames
                                     if not d.startswith(".")
                                     and d != "__pycache__")
                for fn in sorted(filenames):
                    if not fn.endswith(".py"):
                        continue
                    path = os.path.join(dirpath, fn)
                    rel = os.path.relpath(path, root).replace(os.sep, "/")
                    with open(path, "r", encoding="utf-8") as f:
                        modules[rel] = Module(rel, f.read())
        return cls(root, modules)

    @classmethod
    def from_sources(cls, sources: Dict[str, str],
                     root: Optional[str] = None) -> "Project":
        """Build a project from in-memory {relpath: source} — the fixture
        harness: known-bad snippets are mapped to virtual paths inside a
        checker's scope."""
        return cls(root, {rel: Module(rel, src)
                          for rel, src in sources.items()})

    def iter_modules(self, pred=None) -> Iterable[Module]:
        for rel in sorted(self.modules):
            if pred is None or pred(rel):
                yield self.modules[rel]

    def module(self, relpath: str) -> Optional[Module]:
        return self.modules.get(relpath)

    def text(self, relpath: str) -> Optional[str]:
        """Source of any root-relative file (e.g. DESIGN.md), whether or
        not it was scanned as a module."""
        mod = self.modules.get(relpath)
        if mod is not None:
            return mod.source
        if self.root is None:
            return None
        path = os.path.join(self.root, relpath.replace("/", os.sep))
        if not os.path.isfile(path):
            return None
        with open(path, "r", encoding="utf-8") as f:
            return f.read()


class Checker:
    """Protocol: a named rule family over a Project."""

    #: checker name, used for --only selection
    name: str = "?"
    #: rule identifiers this checker can emit (for allow() comments)
    rules: Sequence[str] = ()

    def run(self, project: Project) -> List[Finding]:
        raise NotImplementedError


# ---------------------------------------------------------------- helpers

def dotted_name(node: ast.AST) -> str:
    """Best-effort dotted text of a Name/Attribute chain: ``time.time``,
    ``self.faults.fire``, ``np.random.default_rng``. Empty string for
    anything that is not a plain attribute chain (calls, subscripts)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif parts:
        # chain rooted at a call/subscript — keep the attribute tail so
        # e.g. ``store.open(...).as_plan`` still reports ``.as_plan``
        parts.append("")
    else:
        return ""
    return ".".join(reversed(parts))


def call_name(node: ast.Call) -> str:
    return dotted_name(node.func)


def filter_allowed(findings: Iterable[Finding],
                   project: Project) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (kept, suppressed-by-allow-comment)."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        mod = project.module(f.path)
        if mod is not None and mod.allowed(f.rule, f.line):
            suppressed.append(f)
        else:
            kept.append(f)
    return kept, suppressed


def load_baseline(path: str) -> List[dict]:
    """Baseline entries: [{"rule": ..., "path": ..., "line": ...}]. A
    missing file is an empty baseline."""
    if not os.path.isfile(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    entries = data.get("findings", []) if isinstance(data, dict) else data
    if not isinstance(entries, list):
        raise ValueError(f"baseline {path}: expected a list of findings")
    return entries


def filter_baselined(findings: Iterable[Finding],
                     baseline: Sequence[dict]
                     ) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (kept, matched-by-baseline). Baseline entries
    match on (rule, path) and, when present, line — line drift within a
    file does not resurrect a baselined finding."""
    kept: List[Finding] = []
    matched: List[Finding] = []
    for f in findings:
        hit = any(e.get("rule") == f.rule and e.get("path") == f.path
                  and ("line" not in e or e["line"] == f.line)
                  for e in baseline)
        (matched if hit else kept).append(f)
    return kept, matched
