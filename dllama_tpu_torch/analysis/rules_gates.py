"""Repo-contract gates (``gate-*``) and doc drift (``doc-*``): the port's
counterpart of ``dllama_tpu/analysis/rules_gates.py``.

* ``gate-routes``: ``engine/kernel_select.PAGED_ROUTES`` (read from the
  AST: the module imports torch) and the README "Port route" table match,
  both directions, and the shipped routes stay (``REQUIRED_ROUTES``).
* ``gate-kernels`` (JAX's ``gate-aot``: its AOT inventory of Pallas kernels
  becomes the card's inventory): every library of ``ops/build.SIGNATURES``
  has its ``.cu`` under ``ops/csrc/`` and at least one row of
  ``chip_smoke.KERNEL_ROWS``, and every row's source is a built library.
* ``gate-phases`` (JAX's ``gate-scripts``: its smoke scripts become the
  card smoke's phases): ``chip_smoke.py``'s default ``--phases`` keeps
  every phase of ``REQUIRED_PHASES``.
* ``doc-rules`` / ``doc-ranks``: the README "Port rule" and "Port lock"
  tables match :data:`~dllama_tpu_torch.analysis.core.RULE_CATALOG` and
  ``utils/locks.LOCK_RANKS``, both directions. Their headers are the
  port's own, so the JAX analyzer's tables (``| Rule |``, ``| Lock |``)
  and these never read each other's rows.

A gate file missing from an in-memory fixture is no finding; missing from
a tree on disk it is.
"""

from __future__ import annotations

import ast
import re

from dllama_tpu_torch.analysis.core import (
    PKG,
    RULE_CATALOG,
    Diagnostic,
    line_of,
    module_strings,
)
from dllama_tpu_torch.utils.locks import LOCK_RANKS

_KSEL = PKG + "engine/kernel_select.py"
_BUILD = PKG + "ops/build.py"
_CSRC = PKG + "ops/csrc/"
SMOKE = "chip_smoke.py"

#: routes that must keep EXISTING: deleting a shipped route from both the
#: tuple and the README must still fail, not pass as "consistent"
REQUIRED_ROUTES = ("paged_kernel", "paged_gather")

#: chip_smoke phases the default run must keep: each is the card's proof
#: of a path of the port (the JAX package gates smoke scripts instead)
REQUIRED_PHASES = ("card", "kernels", "golden", "kbench", "forward", "serve",
                   "batch", "hybrid", "radix", "obs", "supervision", "router",
                   "inference", "styles", "spec", "spec_batch", "graphs",
                   "dequantize", "mesh", "mesh_dp_sp", "mesh_pp_ep",
                   "mesh_supervision", "f8", "q80", "moe", "tools", "analysis")

#: the README tables' header prefixes
RULE_HEADER, LOCK_HEADER, ROUTE_HEADER = "| Port rule |", "| Port lock |", "| Port route |"


def _table_rows(src, header_prefix: str) -> list[tuple[int, str]]:
    """(line, id) rows of the first README table whose header row starts
    with `header_prefix`."""
    rows, in_table = [], False
    for i, line in enumerate(src.lines, 1):
        if line.startswith(header_prefix):
            in_table = True
            continue
        if in_table:
            if not line.startswith("|"):
                break
            m = re.match(r"^\| `([a-zA-Z0-9_.-]+)` \|", line)
            if m:
                rows.append((i, m.group(1)))
    return rows


def _missing(project, rel: str, rule: str, diags) -> bool:
    """True when `rel` cannot be read; reported when the tree is on disk
    (a broken file is reported once, as parse-error)."""
    if project.parsed(rel) is not None:
        return False
    if project.source(rel) is None and project.root is not None:
        diags.append(Diagnostic(rel, 1, rule, f"{rel} missing from the tree"))
    return True


def _check_routes(project, diags):
    ksel = project.parsed(_KSEL)
    if ksel is None:
        return  # a broken file is reported once as parse-error
    got = module_strings(ksel.tree, "PAGED_ROUTES")
    routes, route_line = got if got is not None else ([], 1)
    if not routes:
        diags.append(Diagnostic(
            _KSEL, route_line, "gate-routes",
            "PAGED_ROUTES tuple missing: it is the single definition site "
            "of the paged attention routes"))
        return
    for r in REQUIRED_ROUTES:
        if r not in routes:
            diags.append(Diagnostic(
                _KSEL, route_line, "gate-routes",
                f"shipped route {r!r} missing from PAGED_ROUTES: "
                "resolve_kernels can no longer pick it"))
    readme = project.source("README.md")
    if readme is None:
        diags.append(Diagnostic(
            "README.md", 1, "gate-routes",
            "README.md missing: the port-route table cannot be "
            "drift-checked"))
        return
    rows = _table_rows(readme, ROUTE_HEADER)
    anchor = line_of(readme, ROUTE_HEADER)
    for r in routes:
        if r not in {name for _, name in rows}:
            diags.append(Diagnostic(
                "README.md", anchor, "gate-routes",
                f"README port-route table lost its `{r}` row "
                "(kernel_select.PAGED_ROUTES names it)"))
    for line, r in rows:
        if r not in routes:
            diags.append(Diagnostic(
                "README.md", line, "gate-routes",
                f"README port-route row `{r}` names a route "
                "kernel_select.PAGED_ROUTES does not hold"))


def _dict_node(tree: ast.Module, name: str) -> ast.Dict | None:
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name and isinstance(node.value, ast.Dict):
            return node.value
    return None


def _check_kernels(project, diags):
    if _missing(project, _BUILD, "gate-kernels", diags):
        return
    build = project.parsed(_BUILD)
    sig = _dict_node(build.tree, "SIGNATURES")
    if sig is None:
        diags.append(Diagnostic(_BUILD, 1, "gate-kernels",
                                "SIGNATURES dict missing: it lists the kernel "
                                "libraries the card builds"))
        return
    libs = {k.value: k.lineno for k in sig.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)}
    for lib, line in sorted(libs.items()):
        if not project.exists(f"{_CSRC}{lib}.cu"):
            diags.append(Diagnostic(
                _BUILD, line, "gate-kernels",
                f"library {lib!r} has no source {_CSRC}{lib}.cu"))
    if _missing(project, SMOKE, "gate-kernels", diags):
        return
    smoke = project.parsed(SMOKE)
    rows = _dict_node(smoke.tree, "KERNEL_ROWS")
    if rows is None:
        diags.append(Diagnostic(SMOKE, 1, "gate-kernels",
                                "KERNEL_ROWS dict missing: the smoke's kernel "
                                "line is built from it"))
        return
    sources = {}
    for k, v in zip(rows.keys, rows.values):
        src = None
        if isinstance(v, ast.Tuple) and len(v.elts) > 1 \
                and isinstance(v.elts[1], ast.Constant):
            src = v.elts[1].value
        name = k.value if isinstance(k, ast.Constant) else "?"
        sources.setdefault(src, name)
        lib = (src[len(_CSRC):-len(".cu")] if isinstance(src, str)
               and src.startswith(_CSRC) and src.endswith(".cu") else None)
        if lib not in libs:
            diags.append(Diagnostic(
                SMOKE, v.lineno, "gate-kernels",
                f"KERNEL_ROWS[{name!r}] names source {src!r}, which is no "
                "library of ops/build.SIGNATURES"))
    for lib in sorted(libs):
        if f"{_CSRC}{lib}.cu" not in sources:
            diags.append(Diagnostic(
                SMOKE, rows.lineno, "gate-kernels",
                f"library {lib!r} has no KERNEL_ROWS row: the smoke would "
                "build it and never hold it against its plain version"))


def _default_phases(tree: ast.Module) -> tuple[set[str], int] | None:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == "--phases":
            for kw in node.keywords:
                if kw.arg == "default" and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    return set(kw.value.value.split(",")), node.lineno
            return set(), node.lineno
    return None


def _check_phases(project, diags):
    if _missing(project, SMOKE, "gate-phases", diags):
        return
    got = _default_phases(project.parsed(SMOKE).tree)
    if got is None:
        diags.append(Diagnostic(SMOKE, 1, "gate-phases",
                                "chip_smoke.py has no --phases option"))
        return
    phases, line = got
    for p in REQUIRED_PHASES:
        if p not in phases:
            diags.append(Diagnostic(
                SMOKE, line, "gate-phases",
                f"the default --phases lost {p!r}: the default card run no "
                "longer proves that path"))


def _check_docs(project, diags):
    readme = project.source("README.md")
    if readme is None:
        return
    for header, catalog, rule, what in (
            (RULE_HEADER, RULE_CATALOG, "doc-rules", "analysis.RULE_CATALOG"),
            (LOCK_HEADER, LOCK_RANKS, "doc-ranks", "utils/locks.LOCK_RANKS")):
        rows = _table_rows(readme, header)
        anchor = line_of(readme, header)
        for name in sorted(set(catalog) - {r for _, r in rows}):
            diags.append(Diagnostic(
                "README.md", anchor, rule,
                f"`{name}` of {what} has no row in the README table "
                f"headed {header!r}"))
        for line, name in rows:
            if name not in catalog:
                diags.append(Diagnostic(
                    "README.md", line, rule,
                    f"README row `{name}` names no entry of {what}"))


def check(project) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    _check_routes(project, diags)
    _check_kernels(project, diags)
    _check_phases(project, diags)
    _check_docs(project, diags)
    return diags
