"""Held-tensor write discipline (``dev-state``) and the steady-state
host-transfer lint (``transfer-note``): the port's counterpart of
``dllama_tpu/analysis/rules_state.py``, recast for captured programs.

``dev-state``: in the JAX package the decode carries are rebound from the
jitted step's outputs, so the rule there guards WHICH whole-array rebinds
are allowed. In the port every tensor a decode, prefill or spec program
reads or writes is held by address in a CUDA graph: a rebind leaves the
captured program reading the old tensor, silently. So the rule flags every
``self.X = ...`` / ``self.X op= ...`` (and ``self.X.y = ...``) to a held
attribute, wherever it is, except:

* ``__init__`` and the methods ``__init__`` itself calls (read from the
  code, per class);
* a first allocation: an assignment inside ``if self.Y is None:`` with Y a
  held attribute (the engines' lazy allocators, ``_ensure_counts`` and
  ``_ensure_spec``: a tensor bound for the first time is held by no
  program yet).

``warm_restart`` is NOT a sanctioned site (it is in the JAX package): the
port refills every held tensor in place. In-place writes are what the rule
wants and never match: ``.copy_``, ``.fill_``, ``.zero_``,
``.index_copy_``, ``_set_row(...)``, subscript stores.

The held attributes are read from the code: the ``self.X`` roots of the
values of every ``device_state()`` method of an engine class (the dict it
returns is the single definition site; ``BatchEngine.device_state`` and
``InferenceEngine.device_state``). The rule applies their union to every
class under ``engine/``.

``transfer-note``: inside the steady-state decode/spec functions of
``engine/batch.py``, a host<->device transfer (``.item()``, ``.cpu()``,
``.numpy()``, ``.tolist()``, ``.to(<device>)``, ``torch.as_tensor`` /
``torch.tensor(..., device=...)``, a ``.copy_`` across devices: every such
copy in the port passes ``non_blocking`` or a host-made source, and
``torch.cuda.synchronize`` / ``.synchronize()``) must sit within
``NOTE_WINDOW`` statements of a ``note_transfer`` call in some enclosing
statement list: JAX's window rule, unchanged.
"""

from __future__ import annotations

import ast

from dllama_tpu_torch.analysis.core import PKG, Diagnostic, dotted, parent_map

ENGINE_PREFIX = PKG + "engine/"

#: the method whose returned dict names every held tensor
STATE_FN = "device_state"

#: the steady-state functions of engine/batch.py the transfer lint guards:
#: the JAX package's six and the per-chunk helpers the port's dispatch calls
STEADY_FILE = PKG + "engine/batch.py"
STEADY_FNS = ("decode_dispatch", "_spec_dispatch", "hybrid_dispatch",
              "decode_consume", "_sync_vectors", "nonfinite",
              "_decode_launch", "_outputs_to_host", "_spec_consume",
              "_prefill_slice", "_nan_drill")

#: a transfer is "annotated" when a note_transfer call sits within this
#: many statements of it in some enclosing statement list
NOTE_WINDOW = 4

#: methods whose call moves data between the host and the card
_TRANSFER_METHODS = {"item", "cpu", "numpy", "tolist", "synchronize"}
#: calls that make a host tensor (a ``.copy_`` from one crosses devices)
_HOST_MAKERS = {"_pinned", "pin_memory", "from_numpy", "as_tensor", "tensor"}


def _root_attr(node: ast.AST) -> str | None:
    """X for an expression rooted at ``self.X`` through attributes, calls
    and subscripts (``self.cache.k``, ``self._spec_out.items()``)."""
    while True:
        if isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr
            node = node.value
        else:
            return None


def _rebound_attr(target: ast.AST) -> str | None:
    """X when assigning to `target` rebinds ``self.X`` or an attribute of
    it (``self.X``, ``self.X.k``); None for subscript stores and locals."""
    node = target
    while isinstance(node, ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            return node.attr
        node = node.value
    return None


def held_attrs(project) -> dict[str, tuple[str, int]]:
    """attr -> (file, line) of the device_state() value that names it."""
    out: dict[str, tuple[str, int]] = {}
    for src in project.py_sources(ENGINE_PREFIX):
        for fn in src.nodes:
            if not (isinstance(fn, ast.FunctionDef) and fn.name == STATE_FN):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Dict):
                    vals = list(node.values)
                elif isinstance(node, ast.DictComp):
                    vals = [g.iter for g in node.generators]
                elif isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Subscript) for t in node.targets):
                    vals = [node.value]
                else:
                    continue
                for v in vals:
                    a = _root_attr(v) if v is not None else None
                    if a is not None:
                        out.setdefault(a, (src.rel, v.lineno))
    return out


def _first_allocation(test: ast.AST, held) -> bool:
    """The test holds ``self.Y is None`` for a held Y."""
    for node in ast.walk(test):
        if (isinstance(node, ast.Compare) and len(node.ops) == 1
                and isinstance(node.ops[0], ast.Is)
                and isinstance(node.comparators[0], ast.Constant)
                and node.comparators[0].value is None
                and _rebound_attr(node.left) in held):
            return True
    return False


def _init_helpers(cls: ast.ClassDef) -> set[str]:
    """``__init__`` and the methods it calls as ``self.M(...)``."""
    out = {"__init__"}
    for fn in cls.body:
        if isinstance(fn, ast.FunctionDef) and fn.name == "__init__":
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "self"):
                    out.add(node.func.attr)
    return out


def _check_dev_state(src, held, diags):
    def flag(node, attr, why):
        where = "{}:{}".format(*held[attr])
        diags.append(Diagnostic(
            src.rel, node.lineno, "dev-state",
            f"rebind of self.{attr} ({why}), a tensor captured programs hold "
            f"by address (device_state(), {where}): refill it in place "
            "(copy_/fill_/zero_/index_copy_, a subscript store) or bind it "
            "in __init__; a captured graph keeps reading the old tensor"))

    class V(ast.NodeVisitor):
        def __init__(self):
            self.sanctioned = 0
            self.helpers: list[set[str]] = []

        def visit_ClassDef(self, node):
            self.helpers.append(_init_helpers(node))
            self.generic_visit(node)
            self.helpers.pop()

        def visit_FunctionDef(self, node):
            ok = bool(self.helpers) and node.name in self.helpers[-1]
            self.sanctioned += ok
            self.generic_visit(node)
            self.sanctioned -= ok

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_If(self, node):
            first = _first_allocation(node.test, held)
            self.visit(node.test)
            self.sanctioned += first
            for stmt in node.body:
                self.visit(stmt)
            self.sanctioned -= first
            for stmt in node.orelse:
                self.visit(stmt)

        def _targets(self, node, targets, why):
            if self.sanctioned:
                return
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                for el in elts:
                    a = _rebound_attr(el)
                    if a in held:
                        flag(node, a, why)

        def visit_Assign(self, node):
            self._targets(node, node.targets,
                          f"assigned {type(node.value).__name__}")
            self.generic_visit(node)

        def visit_AnnAssign(self, node):
            if node.value is not None:
                self._targets(node, [node.target],
                              f"assigned {type(node.value).__name__}")
            self.generic_visit(node)

        def visit_AugAssign(self, node):
            self._targets(node, [node.target], "augmented assignment")
            self.generic_visit(node)

    V().visit(src.tree)


def _is_note(stmt: ast.AST) -> bool:
    """The statement ITSELF (not a nested sub-block) calls note_transfer:
    descending into child statement lists would let a compound statement
    (an ``if`` holding both a transfer and a note deep inside) annotate its
    own transfers from the outer level."""
    stack = [stmt]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Call):
            d = dotted(n.func)
            if d is not None and d.split(".")[-1] == "note_transfer":
                return True
        for name, value in ast.iter_fields(n):
            if name in ("body", "orelse", "finalbody", "handlers") \
                    and isinstance(value, list):
                continue  # nested statement lists are their own level
            if isinstance(value, list):
                stack.extend(v for v in value if isinstance(v, ast.AST))
            elif isinstance(value, ast.AST):
                stack.append(value)
    return False


def _blocks_of(fn: ast.FunctionDef):
    """Every statement list in `fn` (bodies of the function, ifs, withs,
    loops, try arms) as (list, {stmt_node: index})."""
    out = []
    stack = [fn]
    while stack:
        node = stack.pop()
        for attr in ("body", "orelse", "finalbody"):
            stmts = getattr(node, attr, None)
            if isinstance(stmts, list) and stmts:
                out.append((stmts, {id(s): i for i, s in enumerate(stmts)}))
                stack.extend(stmts)
        for h in getattr(node, "handlers", []) or []:
            out.append((h.body, {id(s): i for i, s in enumerate(h.body)}))
            stack.extend(h.body)
    return out


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


def _device_like(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] in ("cpu", "cuda")
    if isinstance(node, ast.Call):
        return dotted(node.func) == "torch.device"
    d = dotted(node)
    return d is not None and "device" in d.split(".")[-1]


def transfer_kind(call: ast.Call) -> str | None:
    """A name for the transfer `call` makes, or None when it makes none."""
    d = dotted(call.func)
    if d in ("torch.as_tensor", "torch.tensor") and _has_kw(call, "device"):
        return d
    if d == "torch.cuda.synchronize":
        return d
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in _TRANSFER_METHODS:
        return f".{f.attr}()"
    if f.attr == "to" and (_has_kw(call, "device")
                           or (call.args and _device_like(call.args[0]))):
        return ".to(<device>)"
    if f.attr == "copy_":
        src = call.args[0] if call.args else None
        made = (isinstance(src, ast.Call) and dotted(src.func) is not None
                and dotted(src.func).split(".")[-1] in _HOST_MAKERS)
        if _has_kw(call, "non_blocking") or made:
            return ".copy_(<other device>)"
    return None


def _check_transfers(src, diags, parents):
    for node in src.nodes:
        if not isinstance(node, ast.FunctionDef) \
                or node.name not in STEADY_FNS:
            continue
        blocks = _blocks_of(node)
        noted_idx = [({id(s) for s in stmts},
                      sorted(i for i, s in enumerate(stmts) if _is_note(s)))
                     for stmts, _ in blocks]

        def annotated(call: ast.AST) -> bool:
            # walk ancestor statements: at each enclosing statement list,
            # is a note_transfer-bearing statement within NOTE_WINDOW?
            cur = call
            while cur is not node:
                parent = parents.get(cur)
                if parent is None:
                    break
                for (stmts, index), (ids, notes) in zip(blocks, noted_idx):
                    if id(cur) in ids:
                        i = index[id(cur)]
                        if any(abs(i - j) <= NOTE_WINDOW for j in notes):
                            return True
                cur = parent
            return False

        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            kind = transfer_kind(sub)
            if kind is not None and not annotated(sub):
                diags.append(Diagnostic(
                    src.rel, sub.lineno, "transfer-note",
                    f"host<->device transfer ({kind}) in steady-state "
                    f"{node.name}() with no note_transfer(...) within "
                    f"{NOTE_WINDOW} statements: the zero-steady-upload "
                    "invariant erodes invisibly"))


def check(project) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    held = held_attrs(project)
    steady = project.parsed(STEADY_FILE)
    if held:
        for src in project.py_sources(ENGINE_PREFIX):
            _check_dev_state(src, held, diags)
    elif steady is not None:
        diags.append(Diagnostic(
            STEADY_FILE, 1, "dev-state",
            f"no engine class defines {STATE_FN}(): it is the single "
            "definition site of the tensors captured programs hold"))
    if steady is not None:
        _check_transfers(steady, diags, parent_map(steady.tree))
    return diags
