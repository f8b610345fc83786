"""Single-site catalog discipline (``catalog-*`` rules), the port's copy of
``dllama_tpu/analysis/rules_catalog.py``.

The observability stack has one definition site per catalog: every metric
family in ``obs/instruments.py``, every span/event name in
``obs/trace.{SPAN,EVENT}_CATALOG``, every fault point in
``utils/faults.POINTS``. Code that registers or emits outside the catalog
fails at the callsite, with its location. The port's catalogs are the JAX
package's, name for name; the modules that hold them import neither torch
nor numpy.
"""

from __future__ import annotations

import ast

from dllama_tpu_torch.analysis.core import PKG, Diagnostic, dotted, str_arg
from dllama_tpu_torch.obs.trace import EVENT_CATALOG, SPAN_CATALOG
from dllama_tpu_torch.utils.faults import POINTS

#: the only modules allowed to create metric families (metrics.py defines
#: the registry helpers themselves)
METRIC_SITES = (PKG + "obs/instruments.py", PKG + "obs/metrics.py")

_FACTORIES = {"counter", "gauge", "histogram"}

#: receivers whose .span/.span_at/.event calls are tracer emissions
_TRACER_BASES = {"tr", "tracer", "TRACER"}


def _is_metric_factory(call: ast.Call) -> bool:
    d = dotted(call.func)
    if d is None:
        return False
    parts = d.split(".")
    if parts[-1] not in _FACTORIES or len(parts) < 2:
        return False
    return parts[-2] in ("metrics", "REGISTRY") or parts[0] == "REGISTRY"


def _is_tracer_call(call: ast.Call, src_rel: str) -> str | None:
    """'span' | 'event' when the call is a tracer emission."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    kind = {"span": "span", "span_at": "span", "event": "event"}.get(f.attr)
    if kind is None:
        return None
    base = dotted(f.value)
    if base is None:
        return None
    if base.split(".")[-1] in _TRACER_BASES:
        return kind
    if base == "self" and src_rel == PKG + "obs/trace.py":
        return kind  # the tracer's own catalog-named emissions
    return None


def check(project) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    for src in project.py_sources():
        for node in src.nodes:
            if not isinstance(node, ast.Call):
                continue
            if _is_metric_factory(node) and src.rel not in METRIC_SITES:
                name = str_arg(node, 0)
                diags.append(Diagnostic(
                    src.rel, node.lineno, "catalog-metric",
                    f"metric family {name or '<dynamic>'!r} created outside "
                    "obs/instruments.py: the catalog (and its README "
                    "drift check) is the single registration site"))
            kind = _is_tracer_call(node, src.rel)
            if kind is not None:
                name = str_arg(node, 0)
                catalog = SPAN_CATALOG if kind == "span" else EVENT_CATALOG
                if name is not None and name not in catalog:
                    which = "SPAN_CATALOG" if kind == "span" else "EVENT_CATALOG"
                    diags.append(Diagnostic(
                        src.rel, node.lineno, f"catalog-{kind}",
                        f"{kind} name {name!r} is not in obs/trace.{which}: "
                        "add the catalog row (and its README entry) with "
                        "the emit site"))
            if dotted(node.func) in ("faults.fire", "faults.flag"):
                point = str_arg(node, 0)
                if point is not None and point not in POINTS:
                    diags.append(Diagnostic(
                        src.rel, node.lineno, "catalog-fault",
                        f"fault point {point!r} is not in utils/faults.POINTS: "
                        "an undeclared point can never be armed, so the "
                        "drill silently never fires"))
    return diags
