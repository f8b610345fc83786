"""``python -m dllama_tpu_torch.analysis``: run the port's invariant analyzer.

Exit 0 with zero findings, 1 otherwise. Diagnostics are one per line in
``file:line: rule-id message`` form; ``--json`` emits the machine-readable
document instead. ``--lock-graph`` prints the static lock-order edges
(holder -> acquired @ site) and exits 0: the graph behind the
``lock-order`` verdicts.

Stdlib-only by construction: the run asserts that it loaded neither torch,
nor jax, nor the JAX package (a module not loaded before the run is not
loaded after it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: top-level modules the analyzer must never load
FORBIDDEN = ("torch", "jax", "dllama_tpu")


def _detect_root(explicit: str | None) -> str:
    if explicit:
        return os.path.abspath(explicit)
    # <root>/dllama_tpu_torch/analysis/__main__.py
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _check_loaded(had: set) -> None:
    """Raise when the run loaded a FORBIDDEN module it did not find loaded."""
    loaded = [m for m in FORBIDDEN if m in sys.modules and m not in had]
    if loaded:
        raise RuntimeError(f"the analyzer loaded {loaded}: it must stay stdlib-only")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dllama_tpu_torch.analysis",
        description="the PyTorch port's static invariant analyzer")
    ap.add_argument("--root", default=None,
                    help="repo root to analyze (default: this checkout)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable diagnostics on stdout")
    ap.add_argument("--lock-graph", action="store_true",
                    help="print the static lock-order edges and exit")
    args = ap.parse_args(argv)

    had = {m for m in FORBIDDEN if m in sys.modules}
    t0 = time.monotonic()
    from dllama_tpu_torch.analysis.core import RULE_CATALOG, Project, run

    project = Project.from_disk(_detect_root(args.root))

    if args.lock_graph:
        from dllama_tpu_torch.analysis.rules_locks import build_graph
        from dllama_tpu_torch.utils.locks import LOCK_RANKS

        edges, _reentrant, _ca, _mg = build_graph(project)
        for holder, acquired, rel, line in sorted(set(edges)):
            hr = LOCK_RANKS.get(holder, "?")
            ar = LOCK_RANKS.get(acquired, "?")
            print(f"{holder}({hr}) -> {acquired}({ar})  @ {rel}:{line}")
        _check_loaded(had)
        return 0

    diags = run(project)
    dt = time.monotonic() - t0
    _check_loaded(had)
    if args.json:
        print(json.dumps({
            "findings": [{"path": d.path, "line": d.line, "rule": d.rule,
                          "message": d.message} for d in diags],
            "count": len(diags),
            "files": len(project.sources),
            "rules": len(RULE_CATALOG),
            "seconds": round(dt, 3),
            "loaded": sorted(m for m in FORBIDDEN if m in sys.modules),
        }, indent=2))
    else:
        for d in diags:
            print(d)
        status = "FAIL" if diags else "OK"
        print(f"analysis: {status}, {len(diags)} finding(s) over "
              f"{len(project.sources)} files, {len(RULE_CATALOG)} rules "
              f"({dt:.2f}s, no torch)", file=sys.stderr)
    return 1 if diags else 0


if __name__ == "__main__":
    raise SystemExit(main())
