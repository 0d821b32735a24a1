"""Compiled-executable cache hygiene checker (DESIGN.md §14/§15); the
port's counterpart of the reference's jit-cache rule, under its name.

The reference guards ``jax.jit``, whose every construction is a fresh
executable cache. The port calls no ``jax.jit``; its homes for compiled
executables are the kernel library cache (``kernels.build.build``,
``build_all`` and ``load_library``: an ``nvcc`` run at first use, then a
keyed, loaded library), ``torch.compile`` and CUDA graphs
(``torch.cuda.CUDAGraph``, ``torch.cuda.graph``). Constructing one per
request or per loop iteration rebuilds, recompiles or re-records it on
every call. The sanctioned homes are module level, ``__init__``/builder
functions whose result is stored, the wrappers that launch a kernel
(``load_library`` there is a lookup in its keyed cache) and decorators
on module-level functions.

The rule flags any of them (bare, or ``torch.compile`` via
``functools.partial``) constructed inside a loop, or inside a
per-request entry point (``run``/``submit``/``query``/``dispatch``/
``forward``/``__call__``, the reference's ``PER_REQUEST``).
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.model import Checker, Finding, Module, Project, \
    call_name, dotted_name

RULE = "jit-cache"

SCOPE_PREFIXES = ("src/repro_torch/",)

#: function names that run once per request / per step — an executable
#: built here is rebuilt on every call
PER_REQUEST = {"run", "submit", "query", "dispatch", "_dispatch",
               "forward", "__call__", "handle", "answer", "serve"}

#: torch's compiled-executable constructors, by dotted name
TORCH_COMPILERS = {"torch.compile", "torch.cuda.CUDAGraph",
                   "torch.cuda.graph"}
#: the kernel build cache's entry points (``repro_torch.kernels.build``),
#: called as ``build.<fn>`` or by a bare imported name
BUILD_FNS = {"build", "build_all", "load_library"}


def in_scope(relpath: str) -> bool:
    return relpath.startswith(SCOPE_PREFIXES)


def _compiler_name(name: str) -> bool:
    if name in TORCH_COMPILERS:
        return True
    parts = name.split(".")
    if parts[-1] not in BUILD_FNS:
        return False
    return len(parts) == 1 or parts[-2] == "build"


def compiles(node: ast.AST) -> bool:
    """True for a call that builds, compiles or records an executable
    (``torch.compile(...)``, ``build.load_library(...)``,
    ``partial(torch.compile, ...)``, ...) or, as a decorator, a bare
    ``torch.compile``."""
    if isinstance(node, ast.Attribute):
        return dotted_name(node) in TORCH_COMPILERS
    if isinstance(node, ast.Call):
        name = call_name(node)
        if _compiler_name(name):
            return True
        if name in ("partial", "functools.partial") and node.args:
            return dotted_name(node.args[0]) in TORCH_COMPILERS
    return False


def _what(node: ast.AST) -> str:
    if isinstance(node, ast.Call):
        name = call_name(node)
        if name in ("partial", "functools.partial"):
            return dotted_name(node.args[0])
        return name
    return dotted_name(node)


class JitCacheChecker(Checker):
    name = "jit-cache"
    rules = (RULE,)

    def run(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.iter_modules(in_scope):
            out.extend(self._check_module(mod))
        return out

    def _check_module(self, mod: Module) -> List[Finding]:
        out: List[Finding] = []
        stack: List[ast.AST] = []  # loops + functions enclosing the node

        def classify(node: ast.AST) -> str:
            what = _what(node)
            in_loop = any(isinstance(n, (ast.For, ast.While))
                          for n in stack)
            if in_loop:
                return (f"`{what}` constructed inside a loop — a fresh "
                        "compiled executable (and a rebuild, recompile "
                        "or re-record) every iteration")
            fn = next((n for n in reversed(stack)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))), None)
            if fn is not None and fn.name in PER_REQUEST:
                return (f"`{what}` constructed inside per-request entry "
                        f"point `{fn.name}()` — hoist to module level, "
                        "__init__, or a keyed executable cache "
                        "(the _build_forward idiom)")
            return ""

        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # decorators evaluate in the ENCLOSING scope, not inside
                # the function they decorate
                for dec in node.decorator_list:
                    if compiles(dec):
                        msg = classify(dec)
                        if msg:
                            out.append(Finding(RULE, mod.relpath,
                                               dec.lineno, msg))
            elif compiles(node) and isinstance(node, ast.Call):
                msg = classify(node)
                if msg:
                    out.append(Finding(RULE, mod.relpath, node.lineno,
                                       msg))
            stack.append(node)
            for child in ast.iter_child_nodes(node):
                # skip decorator subtrees: handled above with the right
                # scope, and a second visit would double-report
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and child in node.decorator_list:
                    continue
                visit(child)
            stack.pop()

        visit(mod.tree)
        return out
