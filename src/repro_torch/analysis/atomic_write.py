"""Atomic-write checker (DESIGN.md §12/§13/§15).

Every persisted artifact — plans, plan stores, checkpoints, bench
trajectory JSONs — must be published with the tmp + ``os.replace``
idiom (``repro_torch.ioutil``): readers see the old file or the new one,
never a truncated in-between, and a crash mid-write leaves no commit
point behind.

Scope: the port's counterparts of the reference's (``checkpoint/``,
``ooc/``, ``core/plan.py``, the benchmarks) plus its own publishers: the
kernel libraries and their build logs (``kernels/build.py``) and the
dataset cache (``graph/datasets.py``).

The rule flags write-mode ``open()`` calls in artifact-producing scopes
unless the write demonstrably flows through the idiom: the enclosing
function is an ``atomic_*`` helper, calls one, or calls
``os.replace``/``os.rename`` itself — or (for streaming writers like
``PlanStoreWriter``, whose commit point is a later ``finalize``) some
method of the enclosing class does.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.model import (Checker, Finding, Module, Project,
                                        call_name)

RULE = "atomic-write"

SCOPE_PREFIXES = ("src/repro_torch/checkpoint/", "src/repro_torch/ooc/",
                  "benchmarks_torch/")
SCOPE_FILES = ("src/repro_torch/core/plan.py",
               "src/repro_torch/kernels/build.py",
               "src/repro_torch/graph/datasets.py")

_PUBLISH_CALLS = {"os.replace", "os.rename"}


def in_scope(relpath: str) -> bool:
    return relpath.startswith(SCOPE_PREFIXES) or relpath in SCOPE_FILES


def _write_mode(node: ast.Call) -> Optional[str]:
    """The mode string of an `open()` call iff it writes; None for reads
    or non-literal modes (which we cannot judge statically)."""
    mode_node = None
    if len(node.args) >= 2:
        mode_node = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if isinstance(mode_node, ast.Constant) and isinstance(mode_node.value,
                                                          str):
        mode = mode_node.value
        if any(c in mode for c in "wax+"):
            return mode
    return None


def _publishes(tree: ast.AST) -> bool:
    """True if any call inside ``tree`` is os.replace/os.rename or an
    atomic_* helper."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name in _PUBLISH_CALLS or "atomic" in name.split(".")[-1]:
                return True
    return False


class AtomicWriteChecker(Checker):
    name = "atomic-write"
    rules = (RULE,)

    def run(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.iter_modules(in_scope):
            out.extend(self._check_module(mod))
        return out

    def _check_module(self, mod: Module) -> List[Finding]:
        out: List[Finding] = []
        # parent chain: for each write-open, find enclosing function+class
        stack: List[ast.AST] = []

        def visit(node: ast.AST) -> None:
            if isinstance(node, ast.Call) and call_name(node) == "open":
                mode = _write_mode(node)
                if mode is not None and not self._sanctioned(stack):
                    out.append(Finding(
                        RULE, mod.relpath, node.lineno,
                        f"write-mode open(..., {mode!r}) on an artifact "
                        "path without a tmp + os.replace publish — route "
                        "it through repro_torch.ioutil (atomic_write_text / "
                        "atomic_write_json / atomic_savez)"))
            stack.append(node)
            for child in ast.iter_child_nodes(node):
                visit(child)
            stack.pop()

        visit(mod.tree)
        return out

    @staticmethod
    def _sanctioned(stack: List[ast.AST]) -> bool:
        fn = next((n for n in reversed(stack)
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))), None)
        if fn is not None:
            if "atomic" in fn.name:
                return True
            if _publishes(fn):
                return True
        cls = next((n for n in reversed(stack)
                    if isinstance(n, ast.ClassDef)), None)
        if cls is not None and _publishes(cls):
            # streaming writer: payload appends commit via a later
            # finalize() that publishes atomically
            return True
        return False
