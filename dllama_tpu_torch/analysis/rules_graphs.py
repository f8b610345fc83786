"""Captured-program discipline (rules ``graph-site`` / ``graph-label``): the
port's counterpart of the JAX package's ``jit-scope`` / ``jit-label``
(``dllama_tpu/analysis/rules_jit.py``).

JAX brackets every cached-jit dispatch in ``LEDGER.scope(fn, key)`` so the
compile ledger can bill what the callsite compiles. In the port the
programs are CUDA graphs, and ``engine/graphs.Program`` records each
capture in the ledger itself (``_capture_graph`` calls
``LEDGER.record_capture`` under ``Programs.label``), counts the launches a
replay makes, and takes ``utils/profiling.GRAPH_GATE`` around every capture
and replay. So the port's rules are about WHERE graphs are made:

* ``graph-site``: ``torch.cuda.CUDAGraph``, ``torch.cuda.graph(...)``, a
  ``.replay()`` call and any construction of ``graphs.Program`` appear only
  in ``engine/graphs.py``. A capture made anywhere else escapes the ledger,
  the launch counts and the gate.
* ``graph-label``: every function label ``Programs.label`` can return, and
  every literal passed to ``LEDGER.record_capture``, is a key of
  ``obs/compile.COMPILE_FNS``. The labels are read from the AST: string
  literals, conditional expressions, and ``key[0]`` under a guard of the
  enclosing ``if`` (``key[0] == "lit"``, ``key[0] in NAME`` with NAME a
  module-level tuple of literals).
"""

from __future__ import annotations

import ast

from dllama_tpu_torch.analysis.core import (
    PKG,
    Diagnostic,
    dotted,
    module_strings,
    str_arg,
)
from dllama_tpu_torch.obs.compile import COMPILE_FNS

GRAPHS = PKG + "engine/graphs.py"


def _program_names(tree: ast.Module) -> set[str]:
    """Local names under which the module imports graphs.Program or the
    graphs module (``Program(...)``, ``graphs.Program(...)``)."""
    out = {"graphs.Program"}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if node.module.endswith("engine.graphs") and a.name == "Program":
                    out.add(a.asname or a.name)
                if node.module.endswith(".engine") and a.name == "graphs":
                    out.add(f"{a.asname or a.name}.Program")
    return out


def _site(node: ast.AST, programs: set[str]) -> str | None:
    """What graph machinery `node` touches, or None."""
    if isinstance(node, ast.Call):
        d = dotted(node.func)
        if d is not None and (d == "torch.cuda.graph" or d.endswith("cuda.graph")):
            return "torch.cuda.graph(...)"
        if d is not None and (d in programs or d.endswith(".graphs.Program")):
            return "graphs.Program(...)"
        if isinstance(node.func, ast.Attribute) and node.func.attr == "replay":
            return ".replay()"
    if isinstance(node, ast.Attribute):
        d = dotted(node)
        if d is not None and d.endswith("cuda.CUDAGraph"):
            return "torch.cuda.CUDAGraph"
    return None


def _check_sites(project, diags):
    for src in project.py_sources():
        if src.rel == GRAPHS:
            continue
        programs = _program_names(src.tree)
        for node in src.nodes:
            what = _site(node, programs)
            if what is not None:
                diags.append(Diagnostic(
                    src.rel, node.lineno, "graph-site",
                    f"{what} outside engine/graphs.py: a capture made here "
                    "escapes the capture ledger, the launch counts and "
                    "GRAPH_GATE (build programs through graphs.Programs)"))


def _guard_values(expr: ast.AST, guards: list, tree: ast.Module) -> set[str] | None:
    """The literals `expr` can hold under the enclosing if-tests."""
    want = ast.dump(expr)
    for test in reversed(guards):
        for node in ast.walk(test):
            if not (isinstance(node, ast.Compare) and len(node.ops) == 1
                    and ast.dump(node.left) == want):
                continue
            op, right = node.ops[0], node.comparators[0]
            if isinstance(op, ast.Eq) and isinstance(right, ast.Constant) \
                    and isinstance(right.value, str):
                return {right.value}
            if isinstance(op, ast.In):
                if isinstance(right, (ast.Tuple, ast.List, ast.Set)):
                    return {e.value for e in right.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)}
                if isinstance(right, ast.Name):
                    got = module_strings(tree, right.id)
                    if got is not None:
                        return set(got[0])
    return None


def _values(expr: ast.AST, guards: list, tree: ast.Module) -> set[str] | None:
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return {expr.value}
    if isinstance(expr, ast.IfExp):
        a = _values(expr.body, guards, tree)
        b = _values(expr.orelse, guards, tree)
        return None if a is None or b is None else a | b
    return _guard_values(expr, guards, tree)


def label_values(src) -> tuple[list[tuple[int, set[str] | None]], int] | None:
    """[(line, labels or None when unresolved)] for every binding of ``fn``
    in ``Programs.label``, and the method's line; None without it."""
    label = next((fn for cls in src.nodes
                  if isinstance(cls, ast.ClassDef) and cls.name == "Programs"
                  for fn in cls.body
                  if isinstance(fn, ast.FunctionDef) and fn.name == "label"), None)
    if label is None:
        return None
    out: list = []

    def walk(stmts, guards):
        for st in stmts:
            if isinstance(st, ast.If):
                walk(st.body, guards + [st.test])
                walk(st.orelse, guards)
                continue
            if isinstance(st, ast.Assign):
                for t in st.targets:
                    if isinstance(t, ast.Name) and t.id == "fn":
                        out.append((st.lineno, _values(st.value, guards, src.tree)))
                    elif isinstance(t, ast.Tuple) and isinstance(st.value, ast.Tuple):
                        for el, v in zip(t.elts, st.value.elts):
                            if isinstance(el, ast.Name) and el.id == "fn":
                                out.append((st.lineno, _values(v, guards, src.tree)))
            for attr in ("body", "orelse", "finalbody"):
                inner = getattr(st, attr, None)
                if isinstance(inner, list) and not isinstance(st, ast.If):
                    walk(inner, guards)

    walk(label.body, [])
    return out, label.lineno


def _check_labels(project, diags):
    known = ", ".join(sorted(COMPILE_FNS))
    graphs = project.parsed(GRAPHS)
    if graphs is not None:
        got = label_values(graphs)
        if got is None or not got[0]:
            diags.append(Diagnostic(
                GRAPHS, 1 if got is None else got[1], "graph-label",
                "Programs.label() binding `fn` is missing: it names every "
                "capture in the ledger"))
        else:
            for line, labels in got[0]:
                if labels is None:
                    diags.append(Diagnostic(
                        GRAPHS, line, "graph-label",
                        "Programs.label() binds `fn` to a value the analyzer "
                        "cannot resolve to literals: keep the labels literal"))
                    continue
                for lab in sorted(labels - set(COMPILE_FNS)):
                    diags.append(Diagnostic(
                        GRAPHS, line, "graph-label",
                        f"Programs.label() can return fn {lab!r}, not in "
                        f"obs/compile.COMPILE_FNS ({known})"))
    for src in project.py_sources():
        for node in src.nodes:
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                if d is not None and d.endswith("LEDGER.record_capture"):
                    lab = str_arg(node, 0)
                    if lab is not None and lab not in COMPILE_FNS:
                        diags.append(Diagnostic(
                            src.rel, node.lineno, "graph-label",
                            f"LEDGER.record_capture fn label {lab!r} is not "
                            f"in obs/compile.COMPILE_FNS ({known})"))


def check(project) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    _check_sites(project, diags)
    _check_labels(project, diags)
    return diags
