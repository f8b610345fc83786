"""Analyzer core: sources, suppressions, the rule registry, the runner (the
port's copy of ``dllama_tpu/analysis/core.py``).

Design constraints (the package docstring has the why): stdlib-only, well
under 5 s on the whole package, one ``ast.parse`` per file shared by every
rule, and diagnostics that are plain data so ``--json`` is a dump, not a
second code path.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass

#: the analyzed package: every rule's paths are relative to the repo root
#: and start with it
PKG = "dllama_tpu_torch/"

#: rule-id -> one-line description. The SINGLE definition site of the rule
#: catalog: the README "Port rule" table is drift-checked against this
#: (rule ``doc-rules``), and a suppression naming an unknown rule is itself
#: a finding (``suppress-unknown``).
RULE_CATALOG = {
    "graph-site": "CUDA-graph capture, replay or graphs.Program construction "
                  "outside engine/graphs.py",
    "graph-label": "capture-ledger function label (Programs.label, "
                   "LEDGER.record_capture) not in obs/compile.COMPILE_FNS",
    "dev-state": "rebind of an engine tensor a captured program holds by "
                 "address (device_state()) outside __init__ and the "
                 "allocation helpers",
    "catalog-metric": "metric family created outside obs/instruments.py",
    "catalog-span": "span name not in obs/trace.SPAN_CATALOG",
    "catalog-event": "event name not in obs/trace.EVENT_CATALOG",
    "catalog-fault": "faults.fire/flag point not in utils/faults.POINTS",
    "transfer-note": "host<->device transfer in a steady-state decode/spec "
                     "path without note_transfer accounting",
    "lock-order": "static lock-graph edge that descends or re-enters "
                  "utils/locks.LOCK_RANKS",
    "lock-leaf": "lock acquired while holding a leaf lock (metrics "
                 "registry / tracer)",
    "lock-unranked": "named lock whose name is missing from LOCK_RANKS "
                     "(or a rank no lock uses)",
    "gate-routes": "engine/kernel_select.PAGED_ROUTES drifted from the "
                   "README port-route table",
    "gate-kernels": "a library of ops/build.SIGNATURES without its .cu "
                    "source or a chip_smoke.KERNEL_ROWS row, or a row whose "
                    "source is no built library",
    "gate-phases": "chip_smoke.py's default --phases lost a required phase",
    "doc-rules": "README port-rule table drifted from "
                 "analysis.RULE_CATALOG",
    "doc-ranks": "README port-lock table drifted from "
                 "utils/locks.LOCK_RANKS",
    "suppress-reason": "# dllama: allow[...] suppression without a reason",
    "suppress-unknown": "# dllama: allow[...] naming an unknown rule id",
    "parse-error": "a .py file under analysis does not parse (the file is "
                   "excluded from every other rule)",
}


@dataclass(frozen=True)
class Diagnostic:
    path: str  # repo-relative, forward slashes
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


_SUPPRESS_RE = re.compile(
    r"#\s*dllama:\s*allow\[([A-Za-z0-9_,\s-]+)\]\s*(.*?)\s*$")


class Source:
    """One analyzed file: text + (for .py) a lazily-parsed AST, the
    suppression map, and the function-extent index that lets a suppression
    on a ``def`` line cover the whole function body."""

    def __init__(self, rel: str, text: str):
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self._tree: ast.Module | None = None
        self._nodes: list[ast.AST] | None = None
        self._def_spans: list[tuple[int, int]] | None = None
        # line -> set of allowed rule ids; bare entries recorded separately
        self.suppressions: dict[int, set[str]] = {}
        self.bare_suppressions: list[tuple[int, str]] = []
        self.unknown_suppressions: list[tuple[int, str]] = []
        for i, ln in self._comments():
            m = _SUPPRESS_RE.search(ln)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            for r in rules:
                if r not in RULE_CATALOG:
                    self.unknown_suppressions.append((i, r))
            self.suppressions[i] = rules
            if not m.group(2):
                self.bare_suppressions.append((i, ",".join(sorted(rules))))

    def _comments(self):
        """(line, comment_text) for REAL comment tokens only: a suppression
        spelled inside a docstring or string literal is prose, not policy
        (tokenize, not a line regex)."""
        if not self.is_py:
            return
        try:
            toks = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in toks:
                if tok.type == tokenize.COMMENT:
                    yield tok.start[0], tok.string
        except (tokenize.TokenError, SyntaxError,
                IndentationError):  # broken source: no comments to scan
            return

    @property
    def is_py(self) -> bool:
        return self.rel.endswith(".py")

    @property
    def tree(self) -> ast.Module:
        if self._tree is None:
            self._tree = ast.parse(self.text, filename=self.rel)
        return self._tree

    @property
    def nodes(self) -> list[ast.AST]:
        """Every node of the tree, walked once and shared by the rules."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def parse_error(self) -> SyntaxError | None:
        """The file's SyntaxError, or None when it parses: a broken file is
        ONE ``parse-error`` diagnostic, never an analyzer traceback."""
        try:
            self.tree
        except SyntaxError as e:
            return e
        return None

    def _spans(self) -> list[tuple[int, int]]:
        if self._def_spans is None:
            self._def_spans = [
                (node.lineno, node.end_lineno or node.lineno)
                for node in self.nodes
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))]
        return self._def_spans

    def suppressed(self, rule: str, line: int) -> bool:
        """True when `rule` is allowed at `line`: by a comment on the line
        itself or on the ``def`` line of any enclosing function."""
        s = self.suppressions.get(line)
        if s and rule in s:
            return True
        if not self.is_py or not self.suppressions:
            return False
        for start, end in self._spans():
            if start <= line <= end:
                s = self.suppressions.get(start)
                if s and rule in s:
                    return True
        return False


class Project:
    """The analyzed file set: repo-relative path -> :class:`Source`.

    ``from_disk`` walks the real tree; tests build in-memory projects from
    ``{relpath: text}`` mappings so every red fixture is a tiny literal.
    ``root`` (None for in-memory projects) lets the rules that read
    filesystem facts (a kernel's ``.cu`` source, a missing gate file) run."""

    #: non-package files the gate and doc rules read
    EXTRA_FILES = ("README.md", "chip_smoke.py")

    #: directories of the package that hold no analyzed Python: caches, the
    #: kernels' build output, and the CUDA/C++ sources
    SKIP_DIRS = ("__pycache__", "build", "csrc")

    def __init__(self, files: dict[str, str], root: str | None = None):
        self.root = root
        self.sources: dict[str, Source] = {
            rel.replace("\\", "/"): Source(rel.replace("\\", "/"), text)
            for rel, text in files.items()
        }

    @classmethod
    def from_disk(cls, root: str) -> "Project":
        import os

        files: dict[str, str] = {}
        for dirpath, dirnames, filenames in os.walk(os.path.join(root, PKG)):
            dirnames[:] = sorted(d for d in dirnames if d not in cls.SKIP_DIRS)
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, root).replace(os.sep, "/")
                with open(full, encoding="utf-8") as f:
                    files[rel] = f.read()
        for rel in cls.EXTRA_FILES:
            full = os.path.join(root, rel)
            if os.path.exists(full):
                with open(full, encoding="utf-8") as f:
                    files[rel] = f.read()
        return cls(files, root=root)

    def source(self, rel: str) -> Source | None:
        return self.sources.get(rel)

    def exists(self, rel: str) -> bool:
        """Whether `rel` is part of the tree: an analyzed source, or (on
        disk) any file, such as a kernel's ``.cu`` under ``csrc/``."""
        if rel in self.sources:
            return True
        if self.root is None:
            return False
        import os

        return os.path.exists(os.path.join(self.root, rel))

    def py_sources(self, prefix: str = PKG) -> list[Source]:
        """Parseable .py sources under `prefix`: files with syntax errors
        are excluded here and reported once by run() as ``parse-error``."""
        return [s for rel, s in sorted(self.sources.items())
                if s.is_py and rel.startswith(prefix)
                and s.parse_error() is None]

    def parsed(self, rel: str) -> Source | None:
        """The source at `rel` when it exists and parses, else None (a
        broken file is reported once, as ``parse-error``)."""
        src = self.sources.get(rel)
        if src is None or (src.is_py and src.parse_error() is not None):
            return None
        return src


# --------------------------------------------------------------- helpers

def dotted(node: ast.AST) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def str_arg(call: ast.Call, index: int = 0) -> str | None:
    """The index-th positional argument when it is a string literal."""
    if len(call.args) > index:
        a = call.args[index]
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value
    return None


def parent_map(tree: ast.Module) -> dict[ast.AST, ast.AST]:
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def line_of(src, needle: str, default: int = 1) -> int:
    """The first line of `src` that contains `needle`."""
    for i, ln in enumerate(src.lines, 1):
        if needle in ln:
            return i
    return default


def module_strings(tree: ast.Module, name: str) -> tuple[list[str], int] | None:
    """(string elements, line) of the module-level ``NAME = (...)`` tuple or
    list, read from the AST (the module itself may import torch), or None
    when the module does not bind `name`."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name:
            vals = []
            if isinstance(node.value, (ast.Tuple, ast.List)):
                vals = [e.value for e in node.value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)]
            return vals, node.lineno
    return None


# ---------------------------------------------------------------- runner

def run(project: Project) -> list[Diagnostic]:
    """Run every rule; returns unsuppressed diagnostics sorted by
    (path, line, rule). Suppressions without a reason, or naming unknown
    rules, are findings themselves: a silent blanket allow is exactly
    the drift this analyzer exists to stop."""
    from dllama_tpu_torch.analysis import rules_catalog, rules_gates, rules_graphs
    from dllama_tpu_torch.analysis import rules_locks, rules_state

    diags: list[Diagnostic] = []
    for rel, src in sorted(project.sources.items()):
        if src.is_py:
            err = src.parse_error()
            if err is not None:
                diags.append(Diagnostic(
                    rel, err.lineno or 1, "parse-error",
                    f"file does not parse ({err.msg}); excluded from every "
                    "other rule"))
    for checker in (rules_graphs.check, rules_state.check, rules_catalog.check,
                    rules_locks.check, rules_gates.check):
        diags.extend(checker(project))
    out = []
    for d in diags:
        src = project.source(d.path)
        if src is not None and src.suppressed(d.rule, d.line):
            continue
        out.append(d)
    for rel, src in sorted(project.sources.items()):
        for line, rules in src.bare_suppressions:
            out.append(Diagnostic(
                rel, line, "suppress-reason",
                f"suppression allow[{rules}] has no reason: say why the "
                "rule does not apply here"))
        for line, rule in src.unknown_suppressions:
            out.append(Diagnostic(
                rel, line, "suppress-unknown",
                f"suppression names unknown rule {rule!r} "
                f"(catalog: {', '.join(sorted(RULE_CATALOG))})"))
    out.sort(key=lambda d: (d.path, d.line, d.rule))
    return out
