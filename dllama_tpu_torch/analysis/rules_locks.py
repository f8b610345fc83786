"""Static lock discipline (rules ``lock-order`` / ``lock-leaf`` /
``lock-unranked``), the compile-time half of the utils/locks sanitizer: the
port's copy of ``dllama_tpu/analysis/rules_locks.py``.

Extraction, over every ``dllama_tpu_torch/`` module:

1. **Lock identities.** Every ``locks.make_lock("name")`` /
   ``make_rlock("name")`` binding is collected: class attributes
   (``self._mu = locks.make_rlock("engine.pool")``), module globals, and
   dataclass ``field(default_factory=lambda: locks.make_lock(...))``.
   Aliases (``self._mu = pool._mu``: the radix tree riding the pool's
   RLock) resolve by attribute name against the collected bindings;
   ambiguous names resolve only when every candidate agrees.
2. **Acquisitions.** ``with <lock>:`` statements, resolved to a lock name
   via the enclosing class, the module globals, or the alias table.
3. **Edges.** Inside a with-block holding L: a nested with acquiring M is
   an edge L->M; every call contributes edges L->X for each lock X the
   callee may (transitively) acquire. Callees resolve within the analyzed
   modules (same-class methods, same-module functions) plus a small
   builtin table for the observability surface (instrument mutations ->
   the metrics leaf, tracer emissions -> the tracer leaf, fault hooks,
   ``note_transfer``, the capture ledger's ``record_capture``).

Verdicts: every edge must STRICTLY ascend ``utils/locks.LOCK_RANKS``
(same-lock re-entry is legal only for reentrant locks); any edge out of a
leaf lock (metrics/tracer) is ``lock-leaf``, the scrape-path deadlock
shape; a name outside the rank table (or a ranked name no lock uses) is
``lock-unranked``. With all edges ascending, the graph is acyclic by
construction.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from dllama_tpu_torch.analysis.core import PKG, Diagnostic, dotted, str_arg
from dllama_tpu_torch.utils.locks import LEAF_LOCKS, LOCK_RANKS

#: call-pattern knowledge for the observability surface the whole stack
#: leans on — attribute method names that mutate metric families (all
#: paths end in the family lock) and tracer emissions
_METRIC_METHODS = {"inc", "dec", "set", "observe", "observe_n", "labels",
                   "value", "render", "sample", "names"}
_TRACER_METHODS = {"span", "span_at", "event", "req_submit", "req_admitted",
                   "req_prefill_done", "req_first_token", "req_chunk",
                   "req_mark", "req_end", "export_chrome",
                   "requests_summary", "request_timeline", "stats"}


@dataclass
class _Func:
    """Per-function lock facts: direct with-acquisitions, callee names,
    and (lock, inner-thing) containment for edge building."""

    qual: str  # module:Class.fn
    rel: str
    acquires: set = field(default_factory=set)  # lock names w/ sites
    calls: list = field(default_factory=list)  # (callee key tuple, line)
    # (lockname, line_of_with, [inner items]) where inner items are
    # ("lock", name, line) or ("call", callee_keys, line)
    regions: list = field(default_factory=list)


def _binding_value_lockname(value: ast.AST) -> tuple[str, bool] | None:
    """(name, reentrant) when `value` constructs a named lock."""
    if isinstance(value, ast.Call):
        d = dotted(value.func)
        if d is not None:
            leaf = d.split(".")[-1]
            if leaf in ("make_lock", "make_rlock"):
                name = str_arg(value, 0)
                if name is not None:
                    return name, leaf == "make_rlock"
            if leaf == "field":  # dataclass field(default_factory=...)
                for kw in value.keywords:
                    if kw.arg == "default_factory":
                        v = kw.value
                        if isinstance(v, ast.Lambda):
                            return _binding_value_lockname(v.body)
    return None


def _collect_bindings(project):
    """class_attr[(rel, Class)][attr] = name; mod_global[rel][var] = name;
    attr_names[attr] = set of names (for alias resolution); reentrant
    lock names; alias requests [(rel, Class, attr, src_attr, line)]."""
    class_attr: dict = {}
    mod_global: dict = {}
    attr_names: dict = {}
    reentrant: set = set()
    aliases: list = []
    for src in project.py_sources():
        mod_global.setdefault(src.rel, {})
        for node in src.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                got = _binding_value_lockname(node.value)
                if got:
                    mod_global[src.rel][node.targets[0].id] = got[0]
                    if got[1]:
                        reentrant.add(got[0])
        for cls in src.nodes:
            if not isinstance(cls, ast.ClassDef):
                continue
            key = (src.rel, cls.name)
            for node in ast.walk(cls):
                tgt = None
                val = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    tgt, val = node.targets[0], node.value
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    tgt, val = node.target, node.value
                if tgt is None:
                    continue
                attr = None
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    attr = tgt.attr
                elif isinstance(tgt, ast.Name):
                    attr = tgt.id  # dataclass field at class level
                if attr is None:
                    continue
                got = _binding_value_lockname(val)
                if got:
                    class_attr.setdefault(key, {})[attr] = got[0]
                    attr_names.setdefault(attr, set()).add(got[0])
                    if got[1]:
                        reentrant.add(got[0])
                elif (isinstance(val, ast.Attribute)
                      and attr not in class_attr.get(key, {})):
                    # alias: self.X = <expr>.Y — resolve Y later
                    aliases.append((key, attr, val.attr))
    for key, attr, src_attr in aliases:
        names = attr_names.get(src_attr, set())
        if len(names) == 1:
            class_attr.setdefault(key, {}).setdefault(attr, next(iter(names)))
            attr_names.setdefault(attr, set()).add(next(iter(names)))
    return class_attr, mod_global, attr_names, reentrant


def _imports(tree: ast.Module) -> dict[str, list[tuple[str, str | None]]]:
    """Local name -> candidate (module file, name in it) pairs for the
    package's ``from M import NAME`` statements: ``(M/NAME.py, None)`` when
    NAME is a submodule (``from dllama_tpu_torch.utils import faults``),
    ``(M.py, NAME)`` when it is a module attribute (``from
    dllama_tpu_torch.utils.profiling import GRAPH_GATE``). Module-global
    locks resolve across modules through this map; a candidate that names
    no module-global lock simply resolves to nothing."""
    out: dict = {}
    for node in tree.body:
        if not (isinstance(node, ast.ImportFrom) and node.module
                and node.module.split(".")[0] == PKG.rstrip("/")):
            continue
        base = node.module.replace(".", "/")
        for a in node.names:
            out[a.asname or a.name] = [(f"{base}/{a.name}.py", None),
                                       (f"{base}.py", a.name)]
    return out


def _external_acquires(call: ast.Call) -> set:
    """Locks a call into the observability surface may take (the builtin
    knowledge table — see module docstring)."""
    out: set = set()
    d = dotted(call.func)
    f = call.func
    if isinstance(f, ast.Attribute):
        base = dotted(f.value) or ""
        segs = base.split(".")
        last = segs[-1] if segs else ""
        if f.attr in _METRIC_METHODS and "at" not in segs:
            caps = last.isupper() and len(last) > 1
            if caps or segs[0] in ("ins", "metrics") or last == "REGISTRY":
                out.add("obs.metrics")
            elif f.attr in ("labels", "observe", "observe_n", "inc", "dec"):
                # family handles travel under local names too (e.g. the
                # time ledger's injected counter): .labels/.observe/.inc
                # are metrics-family verbs in this codebase
                out.add("obs.metrics")
        if f.attr in _TRACER_METHODS and (
                last in ("TRACER", "tr", "tracer")
                or base.endswith(".TRACER")):
            out.add("obs.tracer")
    if d is not None:
        leaf = d.split(".")[-1]
        if d in ("faults.fire", "faults.flag"):
            out |= {"faults.point", "obs.metrics", "obs.tracer"}
        if leaf == "note_transfer":
            out |= {"obs.transfers", "obs.metrics"}
        if leaf in ("scope", "ensure_listener") and "LEDGER" in d.upper():
            out.add("obs.ledger")
        if leaf == "record_capture" and "LEDGER" in d.upper():
            # the capture ledger classifies against its contract, records,
            # then bills the metrics and emits a compile span
            out |= {"obs.contract", "obs.ledger", "obs.metrics", "obs.tracer"}
    return out


class _FuncVisitor(ast.NodeVisitor):
    """Build the _Func table for one module."""

    def __init__(self, src, class_attr, mod_global, attr_names, funcs):
        self.src = src
        self.class_attr = class_attr
        self.mod_global = mod_global
        self.attr_names = attr_names
        self.funcs = funcs
        self.cls_stack: list[str] = []
        self.fn_stack: list[_Func] = []
        self.lock_stack: list[tuple[str, int]] = []
        self.imports = _imports(src.tree)

    # ------------------------------------------------------- lock naming

    def _lockname(self, expr: ast.AST) -> str | None:
        if isinstance(expr, ast.Name):
            name = self.mod_global.get(self.src.rel, {}).get(expr.id)
            for rel, var in self.imports.get(expr.id, ()):
                if name is None and var is not None:
                    # a module-global lock imported by name (GRAPH_GATE)
                    name = self.mod_global.get(rel, {}).get(var)
            return name
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            if isinstance(expr.value, ast.Name):
                for rel, var in self.imports.get(expr.value.id, ()):
                    # a module-global lock of an imported module
                    # (faults.edit_lock)
                    name = self.mod_global.get(rel, {}).get(attr) \
                        if var is None else None
                    if name:
                        return name
            if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                    and self.cls_stack:
                key = (self.src.rel, self.cls_stack[-1])
                name = self.class_attr.get(key, {}).get(attr)
                if name:
                    return name
            # non-self receiver (fam._lock, f.lock, ledger._lock): resolve
            # by attribute name when every known binding agrees
            names = self.attr_names.get(attr, set())
            if len(names) == 1:
                return next(iter(names))
        return None

    # --------------------------------------------------------- structure

    def visit_ClassDef(self, node):
        self.cls_stack.append(node.name)
        self.generic_visit(node)
        self.cls_stack.pop()

    def _qual(self, name: str) -> str:
        cls = self.cls_stack[-1] if self.cls_stack else ""
        return f"{self.src.rel}:{cls}.{name}" if cls \
            else f"{self.src.rel}:{name}"

    def visit_FunctionDef(self, node):
        fn = _Func(self._qual(node.name), self.src.rel)
        self.funcs.setdefault(self.src.rel, {})
        self.funcs[self.src.rel][
            (self.cls_stack[-1] if self.cls_stack else "", node.name)] = fn
        self.fn_stack.append(fn)
        outer_locks = self.lock_stack
        self.lock_stack = []  # lexical holds don't cross function bounds
        self.generic_visit(node)
        self.lock_stack = outer_locks
        self.fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node):
        pushed = 0
        for item in node.items:
            self.visit(item.context_expr)
            name = self._lockname(item.context_expr)
            if name is not None and self.fn_stack:
                fn = self.fn_stack[-1]
                fn.acquires.add(name)
                line = getattr(item.context_expr, "lineno", node.lineno)
                for outer, _oline in self.lock_stack:
                    fn.regions.append((outer, _oline, ("lock", name, line)))
                # push per item so `with A, B:` records the A->B edge
                self.lock_stack.append((name, node.lineno))
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        if pushed:
            del self.lock_stack[-pushed:]

    def visit_Call(self, node):
        if self.fn_stack and self.lock_stack:
            fn = self.fn_stack[-1]
            keys = self._callee_keys(node)
            ext = _external_acquires(node)
            for outer, line in self.lock_stack:
                if keys or ext:
                    fn.regions.append((outer, line,
                                       ("call", keys, ext, node.lineno)))
        if self.fn_stack:
            self.fn_stack[-1].calls.append((self._callee_keys(node),
                                            _external_acquires(node)))
        self.generic_visit(node)

    def _callee_keys(self, call: ast.Call):
        """Possible (rel, class, name) resolutions inside the project."""
        f = call.func
        keys = []
        if isinstance(f, ast.Name):
            keys.append((self.src.rel, "", f.id))
        elif isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "self" \
                    and self.cls_stack:
                keys.append((self.src.rel, self.cls_stack[-1], f.attr))
            else:
                keys.append((self.src.rel, "*", f.attr))  # same-module scan
        return keys


def _resolve(funcs, rel, cls, name):
    mod = funcs.get(rel, {})
    if cls == "*":
        # attribute call on a non-self receiver: only CLASS methods can
        # match — a module-level function is called by bare name, and
        # matching it here confuses builtin container methods (dict.clear)
        # with same-named module functions
        hits = [fn for (c, n), fn in mod.items() if n == name and c]
        return hits if len(hits) == 1 else []
    fn = mod.get((cls, name))
    if fn is not None:
        return [fn]
    if cls:  # fall back: method defined on another class in the module
        hits = [f for (c, n), f in mod.items() if n == name]
        return hits if len(hits) == 1 else []
    return []


def _may_acquire(funcs):
    """Transitive closure: function -> set of lock names it may take."""
    memo: dict = {}

    def go(fn, stack):
        if fn.qual in memo:
            return memo[fn.qual]
        if fn.qual in stack:
            return set()
        stack = stack | {fn.qual}
        out = set(fn.acquires)
        for keys, ext in fn.calls:
            out |= ext
            for rel, cls, name in keys:
                for callee in _resolve(funcs, rel, cls, name):
                    out |= go(callee, stack)
        memo[fn.qual] = out
        return out

    for mod in funcs.values():
        for fn in mod.values():
            go(fn, frozenset())
    return memo


def build_graph(project):
    """[(holder, acquired, rel, line)] — the static lock-order edges.
    Exposed for ``--lock-graph`` and the README's rank-table docs."""
    class_attr, mod_global, attr_names, reentrant = _collect_bindings(project)
    funcs: dict = {}
    for src in project.py_sources():
        _FuncVisitor(src, class_attr, mod_global, attr_names,
                     funcs).visit(src.tree)
    may = _may_acquire(funcs)
    edges = []
    seen = set()
    for mod in funcs.values():
        for fn in mod.values():
            for region in fn.regions:
                outer = region[0]
                inner = region[2] if len(region) == 3 else None
                if inner is None:
                    continue
                if inner[0] == "lock":
                    _, name, line = inner
                    key = (outer, name, fn.rel, line)
                    if key not in seen:
                        seen.add(key)
                        edges.append((outer, name, fn.rel, line))
                else:
                    _, keys, ext, line = inner
                    targets = set(ext)
                    for rel, cls, name in keys:
                        for callee in _resolve(funcs, rel, cls, name):
                            targets |= may.get(callee.qual, set())
                    for t in sorted(targets):
                        key = (outer, t, fn.rel, line)
                        if key not in seen:
                            seen.add(key)
                            edges.append((outer, t, fn.rel, line))
    return edges, reentrant, class_attr, mod_global


def check(project) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    edges, reentrant, class_attr, mod_global = build_graph(project)

    # unranked names at their construction site
    for src in project.py_sources():
        for node in src.nodes:
            if isinstance(node, ast.Call):
                got = _binding_value_lockname(node)
                if got and got[0] not in LOCK_RANKS:
                    diags.append(Diagnostic(
                        src.rel, node.lineno, "lock-unranked",
                        f"lock name {got[0]!r} is not in "
                        "utils/locks.LOCK_RANKS — rank it (and the README "
                        "port-lock table) before using it"))
    used = {n for names in
            ([list(v.values()) for v in class_attr.values()]
             + [list(v.values()) for v in mod_global.values()])
            for n in names}
    locks_src = project.source(PKG + "utils/locks.py")
    if locks_src is not None:
        for name in sorted(set(LOCK_RANKS) - used):
            line = next((i for i, ln in enumerate(locks_src.lines, 1)
                         if f'"{name}"' in ln), 1)
            diags.append(Diagnostic(
                locks_src.rel, line, "lock-unranked",
                f"LOCK_RANKS entry {name!r} is bound by no "
                "make_lock/make_rlock site — stale rank rows hide real "
                "order bugs"))

    for holder, acquired, rel, line in edges:
        if holder not in LOCK_RANKS or acquired not in LOCK_RANKS:
            continue  # unranked already reported at the binding
        if holder == acquired:
            if acquired in reentrant:
                continue
            diags.append(Diagnostic(
                rel, line, "lock-order",
                f"re-acquisition of non-reentrant lock {acquired!r} while "
                "holding it — self-deadlock"))
            continue
        if holder in LEAF_LOCKS:
            diags.append(Diagnostic(
                rel, line, "lock-leaf",
                f"acquiring {acquired!r} while holding leaf lock "
                f"{holder!r} — the scrape-path deadlock shape; leaf locks "
                "(metrics registry, tracer) must do pure work only"))
        elif LOCK_RANKS[holder] >= LOCK_RANKS[acquired]:
            diags.append(Diagnostic(
                rel, line, "lock-order",
                f"lock-order inversion: {acquired!r} "
                f"(rank {LOCK_RANKS[acquired]}) acquired while holding "
                f"{holder!r} (rank {LOCK_RANKS[holder]}) — edges must "
                "strictly ascend utils/locks.LOCK_RANKS"))
    return diags
