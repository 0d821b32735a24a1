"""CLI for the invariant analyzer: ``python -m repro_torch.analysis``.

Exit code 0 iff no findings remain after allow-comment and baseline
filtering. ``--format json`` emits a machine-readable report (the CI
artifact); the default text format prints one ``path:line: [rule]``
line per finding plus a summary.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis import ALL_CHECKERS
from repro_torch.analysis.model import (BASELINE_RELPATH, Finding, Project,
                                  filter_allowed, filter_baselined,
                                  load_baseline)


def find_repo_root() -> str:
    """The repo root is three levels above this package (src/repro_torch/
    analysis) — overridable with --root for out-of-tree use."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.abspath(os.path.join(here, "..", "..", ".."))


def run_checkers(project: Project,
                 only: Optional[Sequence[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for cls in ALL_CHECKERS:
        if only and cls.name not in only:
            continue
        findings.extend(cls().run(project))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based invariant analyzer (DESIGN.md §15)")
    ap.add_argument("paths", nargs="*",
                    help="restrict findings to these repo-relative path "
                         "prefixes (default: whole repo)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detected)")
    ap.add_argument("--only", action="append", default=None,
                    metavar="CHECKER",
                    help="run only this checker (repeatable): " +
                         ", ".join(c.name for c in ALL_CHECKERS))
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: <root>/"
                         f"{BASELINE_RELPATH})")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root) if args.root else find_repo_root()
    project = Project.load(root)
    findings = run_checkers(project, only=args.only)

    if args.paths:
        prefixes = tuple(p.rstrip("/") for p in args.paths)
        findings = [f for f in findings
                    if f.path in prefixes
                    or any(f.path.startswith(p + "/") for p in prefixes)]

    findings, allowed = filter_allowed(findings, project)
    baseline_path = args.baseline or os.path.join(root, BASELINE_RELPATH)
    findings, baselined = filter_baselined(findings,
                                           load_baseline(baseline_path))

    if args.format == "json":
        json.dump({
            "root": root,
            "findings": [f.as_dict() for f in findings],
            "suppressed": {
                "allow_comments": [f.as_dict() for f in allowed],
                "baseline": [f.as_dict() for f in baselined],
            },
        }, sys.stdout, indent=1)
        sys.stdout.write("\n")
    else:
        for f in findings:
            print(f.render())
        print(f"{len(findings)} finding(s) "
              f"({len(allowed)} allowed by lint comments, "
              f"{len(baselined)} baselined) over "
              f"{len(project.modules)} modules")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
