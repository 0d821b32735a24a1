"""Bench-gate cross-checker (DESIGN.md §15).

A gate module (the reference's ``tools/check_bench_json.py``; the
port's is ``tools_torch/check_bench_json.py``) gates CI on named bench
rows; the rows are emitted by the modules under ``benchmarks_torch/``.
Until the port has benchmarks and a gate, it reports nothing. Nothing
previously
tied the two together: renaming a row in a bench module silently turns
the CI gate into a tautology (or a permanent failure).

This checker parses the gate's required-row tables (``REQUIRED_ROWS``,
``REQUIRED_PREFIXES`` — one literal dict each, shared with the gate
logic itself) and verifies every required op name / prefix is emitted
somewhere under ``benchmarks_torch/``. Ops built with f-strings
(``f"kernels/agg_e2e_{name}"``) are matched by their constant parts.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.model import Checker, Finding, Module, Project

RULE = "bench-gate"

GATE_MODULE = "tools_torch/check_bench_json.py"
BENCH_PREFIX = "benchmarks_torch/"


def _literal_dict(source: str, name: str) -> Optional[dict]:
    tree = ast.parse(source)
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    try:
                        val = ast.literal_eval(node.value)
                    except (ValueError, SyntaxError):
                        return None
                    return val if isinstance(val, dict) else None
    return None


def emitted_patterns(mod: Module) -> Tuple[Set[str], List[Tuple[str, str]]]:
    """(exact string literals, [(regex, static_prefix)] for f-strings)
    for every op-shaped string in a bench module. Only strings with a
    '/' are considered — op names are namespaced ``table/row``."""
    exact: Set[str] = set()
    patterns: List[Tuple[str, str]] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if "/" in node.value:
                exact.add(node.value)
        elif isinstance(node, ast.JoinedStr):
            parts = []
            prefix_parts = []
            prefix_open = True
            for v in node.values:
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    parts.append(re.escape(v.value))
                    if prefix_open:
                        prefix_parts.append(v.value)
                else:
                    parts.append(".*")
                    prefix_open = False
            prefix = "".join(prefix_parts)
            if "/" in prefix:
                patterns.append(("".join(parts), prefix))
    return exact, patterns


class BenchGateChecker(Checker):
    name = "bench-gate"
    rules = (RULE,)

    def run(self, project: Project) -> List[Finding]:
        gate = project.module(GATE_MODULE) or None
        gate_src = gate.source if gate else project.text(GATE_MODULE)
        if gate_src is None:
            return []  # fixture project without a gate — nothing to check
        rows = _literal_dict(gate_src, "REQUIRED_ROWS")
        prefixes = _literal_dict(gate_src, "REQUIRED_PREFIXES")
        if rows is None or prefixes is None:
            return [Finding(
                RULE, GATE_MODULE, 1,
                "REQUIRED_ROWS / REQUIRED_PREFIXES literal tables not "
                "found — the gate's required rows are no longer "
                "statically checkable")]

        exact: Set[str] = set()
        patterns: List[Tuple[str, str]] = []
        for mod in project.iter_modules(
                lambda p: p.startswith(BENCH_PREFIX)):
            e, pats = emitted_patterns(mod)
            exact |= e
            patterns.extend(pats)

        out: List[Finding] = []
        for mode, ops in sorted(rows.items()):
            for op in ops:
                if op in exact:
                    continue
                if any(re.fullmatch(pat, op) for pat, _ in patterns):
                    continue
                out.append(Finding(
                    RULE, GATE_MODULE, 1,
                    f"required row `{op}` (mode {mode}) is never "
                    "emitted by any module under benchmarks_torch/"))
        for mode, pres in sorted(prefixes.items()):
            for pre in pres:
                if any(lit.startswith(pre) for lit in exact):
                    continue
                if any(pre.startswith(sp) or sp.startswith(pre)
                       for _, sp in patterns):
                    continue
                out.append(Finding(
                    RULE, GATE_MODULE, 1,
                    f"required row prefix `{pre}` (mode {mode}) matches "
                    "nothing emitted under benchmarks_torch/"))
        return out
