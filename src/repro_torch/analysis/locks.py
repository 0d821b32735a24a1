"""Lock-discipline checker for the threaded tiers (DESIGN.md §11/§12/§15).

Builds the lock-acquisition graph of every ``with <lock>:`` site across
the serving tier, the prefetch loader, the elastic coordinator and the
kernel build cache (``kernels/build.py``, whose lock guards the loaded
libraries and the launch counts), then enforces four rules:

* ``lock-order`` — the per-module acquisition graph must be acyclic: two
  functions that nest the same pair of locks in opposite orders can
  deadlock under concurrency.
* ``lock-blocking`` — no blocking call while a lock is held: file I/O,
  ``Future.result()``, thread joins, ``Event.wait``, a kernel build or a
  graph compile (the port's counterparts of jit compilation:
  ``repro_torch.analysis.jit_cache.compiles``), or an engine
  ``run``/``swap`` (which may fault in out-of-core batches). Holding a
  lock across any of these stalls every thread behind it.
* ``condvar-wait`` — ``Condition.wait`` must sit inside a ``while``
  predicate loop: bare waits miss spurious wakeups and lost notifies.
* ``clock-injectable`` — threaded code never touches ``time.time`` /
  ``time.sleep`` directly; all timing flows through the injectable clock
  (``repro_torch.serve.common.SystemClock`` / a ``clock=`` parameter) so
  the FakeClock test suite can drive it deterministically. The
  ``SystemClock`` class itself is the one sanctioned home for the real
  clock and is exempt by name.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.jit_cache import compiles
from repro_torch.analysis.model import (Checker, Finding, Module, Project,
                                        call_name, dotted_name)

RULE_ORDER = "lock-order"
RULE_BLOCKING = "lock-blocking"
RULE_CONDVAR = "condvar-wait"
RULE_CLOCK = "clock-injectable"

SCOPE_PREFIXES = ("src/repro_torch/serve/",)
SCOPE_FILES = ("src/repro_torch/data/loader.py",
               "src/repro_torch/train/elastic.py",
               "src/repro_torch/kernels/build.py")

#: attribute tails that mark a `with` context expression as a lock
_LOCK_TAIL = re.compile(r"(^|_)(lock|cond|condition|mutex)$")

#: calls that block (or can block unboundedly) regardless of receiver
_BLOCKING_CALLS = {
    "open", "os.replace", "os.rename", "os.fsync", "os.remove",
    "np.load", "np.save", "np.savez", "np.savez_compressed",
    "json.dump", "json.load", "shutil.rmtree", "shutil.copyfile",
    "time.sleep",
}

#: direct wall-clock references banned outside SystemClock
_CLOCK_REFS = {"time.time", "time.sleep", "time.monotonic",
               "time.perf_counter"}

_THREADISH = re.compile(r"thread|worker|proc|fut")


def in_scope(relpath: str) -> bool:
    return relpath.startswith(SCOPE_PREFIXES) or relpath in SCOPE_FILES


def lock_label(expr: ast.AST, class_name: str) -> Optional[str]:
    """Label of a lock-acquisition context expr, or None if the `with`
    item is not a lock. Labels are qualified by enclosing class so
    same-named locks on different objects don't alias in the graph."""
    name = dotted_name(expr)
    if not name:
        return None
    tail = name.split(".")[-1]
    if not _LOCK_TAIL.search(tail):
        return None
    local = name[5:] if name.startswith("self.") else name
    return f"{class_name or '<module>'}:{local}"


class _FunctionScanner(ast.NodeVisitor):
    """Walks ONE function body tracking held locks and loop depth."""

    def __init__(self, checker: "LockDisciplineChecker", mod: Module,
                 class_name: str):
        self.checker = checker
        self.mod = mod
        self.class_name = class_name
        self.held: List[str] = []      # lock labels, outermost first
        self.loop_depth = 0

    def _finding(self, rule: str, node: ast.AST, msg: str) -> None:
        self.checker.found.append(
            Finding(rule, self.mod.relpath, node.lineno, msg))

    # -- locks ----------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            label = lock_label(item.context_expr, self.class_name)
            if label is not None:
                if self.held:
                    self.checker.edges.setdefault(
                        (self.held[-1], label), (self.mod.relpath,
                                                 node.lineno))
                self.held.append(label)
                pushed += 1
            else:
                # e.g. `with open(...)` under a held lock
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        del self.held[len(self.held) - pushed:]

    # -- loops (for the condvar predicate rule) -------------------------
    def visit_While(self, node: ast.While) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = visit_While  # type: ignore[assignment]

    # -- nested defs get their own scanner ------------------------------
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # a nested def/lambda body does not run under the enclosing
        # `with`; scan it with a fresh lock stack
        sub = _FunctionScanner(self.checker, self.mod, self.class_name)
        for stmt in node.body:
            sub.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Lambda(self, node: ast.Lambda) -> None:
        sub = _FunctionScanner(self.checker, self.mod, self.class_name)
        sub.visit(node.body)

    # -- calls ----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = call_name(node)
        tail = name.split(".")[-1] if name else ""
        receiver = name[:len(name) - len(tail) - 1] if "." in name else ""

        if tail == "wait" and "cond" in receiver:
            if self.loop_depth == 0:
                self._finding(
                    RULE_CONDVAR, node,
                    f"`{name}()` outside a `while <predicate>` loop — "
                    "spurious wakeups and lost notifies require "
                    "re-checking the predicate after every wait")
        elif self.held:
            self._check_blocking(node, name, tail, receiver)
        self.generic_visit(node)

    def _check_blocking(self, node: ast.Call, name: str, tail: str,
                        receiver: str) -> None:
        held = self.held[-1]
        msg = None
        if name in _BLOCKING_CALLS:
            msg = f"blocking call `{name}` while holding `{held}`"
        elif compiles(node):
            msg = (f"kernel build or graph compile `{name}` under held "
                   f"lock `{held}`")
        elif tail == "result":
            msg = (f"`{name}()` (future result — unbounded wait) while "
                   f"holding `{held}`")
        elif tail == "join" and _THREADISH.search(receiver):
            msg = f"`{name}()` (thread join) while holding `{held}`"
        elif tail == "wait" and "cond" not in receiver:
            msg = (f"`{name}()` (event wait) while holding `{held}` — "
                   "the waiter can never be woken by a thread stuck on "
                   "this lock")
        elif tail in ("run", "swap") and "engine" in receiver:
            msg = (f"`{name}()` under held lock `{held}` — engine "
                   f"{tail} jit-compiles on first use and may fault in "
                   "out-of-core batches (disk I/O)")
        if msg:
            self._finding(RULE_BLOCKING, node,
                          msg + "; move the slow work outside the "
                          "critical section or annotate the by-design "
                          "case `# lint: allow(lock-blocking)`")


class LockDisciplineChecker(Checker):
    name = "locks"
    rules = (RULE_ORDER, RULE_BLOCKING, RULE_CONDVAR, RULE_CLOCK)

    def run(self, project: Project) -> List[Finding]:
        self.found: List[Finding] = []
        for mod in project.iter_modules(in_scope):
            # per-module acquisition graph: (outer, inner) -> provenance
            self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
            self._scan_module(mod)
            self.found.extend(self._order_findings())
        return self.found

    def _scan_module(self, mod: Module) -> None:
        # only top-level functions and direct methods: nested defs are
        # scanned (with a fresh lock stack) by their enclosing scanner
        def top_functions(body, cls):
            for node in body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    yield node, cls
                elif isinstance(node, ast.ClassDef):
                    yield from top_functions(node.body, node.name)

        for fn, cls in top_functions(mod.tree.body, ""):
            if cls == "SystemClock":
                continue  # the sanctioned real-clock shim
            scanner = _FunctionScanner(self, mod, cls)
            for stmt in fn.body:
                scanner.visit(stmt)
        self._scan_clock_refs(mod)

    def _scan_clock_refs(self, mod: Module) -> None:
        """Flag any reference (not just call) to the raw clock outside
        class SystemClock — `self._now = time.time` is as untestable as
        calling it."""
        sanctioned: Set[int] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and node.name == "SystemClock":
                sanctioned.update(
                    n.lineno for n in ast.walk(node)
                    if hasattr(n, "lineno"))
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) \
                    and dotted_name(node) in _CLOCK_REFS \
                    and node.lineno not in sanctioned:
                self.found.append(Finding(
                    RULE_CLOCK, mod.relpath, node.lineno,
                    f"direct `{dotted_name(node)}` in threaded code — "
                    "route timing through the injectable clock "
                    "(repro_torch.serve.common.SystemClock / a clock= "
                    "parameter) so FakeClock tests stay deterministic"))

    def _order_findings(self) -> List[Finding]:
        """DFS cycle detection over the module's acquisition graph."""
        out: List[Finding] = []
        graph: Dict[str, List[str]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, []).append(b)

        def reaches(src: str, dst: str, seen: Set[str]) -> bool:
            if src == dst:
                return True
            for nxt in graph.get(src, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    if reaches(nxt, dst, seen):
                        return True
            return False

        for (a, b), (path, line) in sorted(self.edges.items(),
                                           key=lambda kv: kv[1]):
            # edge a->b closes a cycle iff b already reaches a
            if reaches(b, a, {b}):
                out.append(Finding(
                    RULE_ORDER, path, line,
                    f"lock-order inversion: `{a}` -> `{b}` here, but "
                    f"another site nests them in the opposite order — "
                    "pick one global order"))
        return out
