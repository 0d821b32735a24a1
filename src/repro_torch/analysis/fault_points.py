"""Fault-point registry checker (DESIGN.md §12/§15).

``repro_torch.faults.FAULT_POINTS`` is the canonical registry of the
port's injection point names. This checker parses it STATICALLY (never
imports repo code) and enforces, in both directions:

* every point name passed to ``fire``/``delay``/``should_fire`` on a
  fault-injector receiver, and every key of a ``rates=``/``script=``
  dict literal at a ``FaultInjector(...)`` construction, is registered;
* point names at injection sites are string literals (a computed name
  cannot be checked against the registry);
* every registered point is actually used by at least one call site;
* the DESIGN.md §12 table lists exactly the registered points (the
  port keeps the reference's points, so one table serves both).
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.model import Checker, Finding, Project, call_name

RULE = "fault-point"

FAULTS_MODULE = "src/repro_torch/faults.py"
DESIGN_FILE = "DESIGN.md"
DESIGN_SECTION = "12"

_FIRE_TAILS = ("fire", "should_fire", "delay")
_TABLE_ROW = re.compile(r"^\|\s*`([a-z_]+)`\s*\|", re.MULTILINE)
_SECTION_RE = re.compile(r"^##\s+§12\b.*?(?=^##\s+§|\Z)",
                         re.MULTILINE | re.DOTALL)


def registry_from_source(source: str) -> Optional[Dict[str, str]]:
    """Parse FAULT_POINTS out of faults.py source without importing it."""
    tree = ast.parse(source)
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "FAULT_POINTS":
                try:
                    reg = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    return None
                return reg if isinstance(reg, dict) else None
    return None


def design_table_points(design_text: str) -> Optional[Set[str]]:
    """Point names in the DESIGN.md §12 fault table, or None if the
    section is missing."""
    m = _SECTION_RE.search(design_text)
    if not m:
        return None
    return set(_TABLE_ROW.findall(m.group(0)))


def _point_calls(mod) -> List[Tuple[int, Optional[str], str]]:
    """(line, point-or-None, call-text) for every fault-injection call
    site in a module. ``point`` is None for non-literal names."""
    sites = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        tail = name.split(".")[-1] if name else ""
        receiver = name[:len(name) - len(tail) - 1] if "." in name else ""
        if tail in _FIRE_TAILS and "fault" in receiver.lower():
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                sites.append((node.lineno, node.args[0].value, name))
            else:
                sites.append((node.lineno, None, name))
        elif tail == "FaultInjector" or name == "FaultInjector":
            for kw in node.keywords:
                if kw.arg in ("rates", "script", "delays") \
                        and isinstance(kw.value, ast.Dict):
                    for k in kw.value.keys:
                        if isinstance(k, ast.Constant) \
                                and isinstance(k.value, str):
                            sites.append((k.lineno, k.value,
                                          f"FaultInjector({kw.arg}=)"))
    return sites


class FaultPointChecker(Checker):
    name = "fault-points"
    rules = (RULE,)

    def run(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        faults_mod = project.module(FAULTS_MODULE)
        if faults_mod is None:
            return out  # out-of-repo fixture project without faults.py
        registry = registry_from_source(faults_mod.source)
        if registry is None:
            return [Finding(RULE, FAULTS_MODULE, 1,
                            "no FAULT_POINTS literal dict found — the "
                            "canonical injection-point registry is gone")]

        used: Set[str] = set()
        for mod in project.iter_modules():
            if mod.relpath == FAULTS_MODULE:
                continue  # the injector's own should_fire(point) plumbing
            for line, point, text in _point_calls(mod):
                if point is None:
                    out.append(Finding(
                        RULE, mod.relpath, line,
                        f"`{text}` with a non-literal point name — "
                        "points must be string literals so the registry "
                        "stays statically checkable"))
                elif point not in registry:
                    out.append(Finding(
                        RULE, mod.relpath, line,
                        f"unregistered fault point `{point}` — add it to "
                        "repro_torch.faults.FAULT_POINTS and the DESIGN.md "
                        "§12 table"))
                else:
                    used.add(point)

        for point in sorted(set(registry) - used):
            out.append(Finding(
                RULE, FAULTS_MODULE, 1,
                f"registered fault point `{point}` has no injection "
                "site in src/repro_torch/ or benchmarks_torch/ — dead "
                "registry entry"))

        design = project.text(DESIGN_FILE)
        if design is not None:
            table = design_table_points(design)
            if table is None:
                out.append(Finding(RULE, DESIGN_FILE, 1,
                                   "DESIGN.md has no §12 fault table"))
            else:
                for point in sorted(set(registry) - table):
                    out.append(Finding(
                        RULE, DESIGN_FILE, 1,
                        f"registered point `{point}` missing from the "
                        "DESIGN.md §12 table"))
                for point in sorted(table - set(registry)):
                    out.append(Finding(
                        RULE, DESIGN_FILE, 1,
                        f"DESIGN.md §12 table lists `{point}` which is "
                        "not in repro_torch.faults.FAULT_POINTS"))
        return out
