"""``python -m dllama_tpu_torch.analysis.smoke``: the analyzer's own drill,
the counterpart of the JAX package's ``scripts/analysis_smoke.sh``. A gate
that cannot fail is decoration, so this proves that it fails:

1. the analyzed file set (the package without caches and build output,
   ``README.md``, ``chip_smoke.py``) is copied into a temp root, and
   ``python -m dllama_tpu_torch.analysis --root <copy>`` must exit 0 with
   no finding and without loading torch;
2. one file of the copy is seeded with four violations: an off-catalog
   fault point, a ``torch.cuda.graph(`` outside ``engine/graphs.py``, a
   rebind of ``self._pos_dev`` outside ``__init__``, and a descending
   ``with`` of two named locks; the run must exit 1 and report exactly
   those four, each at its own ``file:line`` under its rule id.

Exit 0 when both hold. Stdlib only: it runs the analyzer in child
processes of this interpreter.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from dllama_tpu_torch.analysis.core import PKG, Project

SEEDED = PKG + "engine/_seeded_violation.py"

#: (rule, the seeded line that must be reported under it)
SEEDED_CASES = (
    ("catalog-fault", 'faults.fire("not.a.real.point")'),
    ("graph-site", "with torch.cuda.graph(graph):"),
    ("dev-state", "self._pos_dev = torch.zeros(4, dtype=torch.int32)  # rebind"),
    ("lock-order", "with self._seed_sched:"),
)

SEEDED_TEXT = '''import torch

from dllama_tpu_torch.utils import faults, locks

faults.fire("not.a.real.point")


class Seeded:
    def __init__(self):
        self._pos_dev = torch.zeros(4, dtype=torch.int32)
        self._seed_pool = locks.make_rlock("engine.pool")
        self._seed_sched = locks.make_lock("scheduler.metrics")

    def capture(self, graph, body):
        with torch.cuda.graph(graph):
            body()

    def rewind(self):
        self._pos_dev = torch.zeros(4, dtype=torch.int32)  # rebind

    def inverted(self):
        with self._seed_pool:
            with self._seed_sched:
                pass
'''


def _repo_root() -> str:
    # <root>/dllama_tpu_torch/analysis/smoke.py
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def copy_tree(root: str, dst: str) -> None:
    """The analyzed file set of `root` into `dst` (the kernels' .cu sources
    too: gate-kernels reads that they exist)."""
    skip = shutil.ignore_patterns(*(d for d in Project.SKIP_DIRS if d != "csrc"))
    shutil.copytree(os.path.join(root, PKG), os.path.join(dst, PKG), ignore=skip)
    for rel in Project.EXTRA_FILES:
        if os.path.exists(os.path.join(root, rel)):
            shutil.copy2(os.path.join(root, rel), os.path.join(dst, rel))


def _analyze(root: str, tree: str) -> tuple[int, dict]:
    out = subprocess.run([sys.executable, "-m", "dllama_tpu_torch.analysis", "--root", tree,
                          "--json"], cwd=root, capture_output=True, text=True, timeout=120)
    try:
        doc = json.loads(out.stdout)
    except json.JSONDecodeError:
        doc = {"error": (out.stdout + out.stderr)[-2000:]}
    return out.returncode, doc


def drill(root: str | None = None) -> dict:
    """Run both halves on a temp copy of `root`; returns the report, whose
    ``ok`` says whether the gate both passed the pristine copy and failed
    the seeded one exactly as expected."""
    root = root or _repo_root()
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="dllama_analysis_smoke_") as tmp:
        copy_tree(root, tmp)
        rc0, clean = _analyze(root, tmp)
        with open(os.path.join(tmp, SEEDED), "w", encoding="utf-8") as f:
            f.write(SEEDED_TEXT)
        rc1, seeded = _analyze(root, tmp)
    lines = SEEDED_TEXT.splitlines()
    want = sorted((SEEDED, next(i for i, ln in enumerate(lines, 1) if ln.strip() == text), rule)
                  for rule, text in SEEDED_CASES)
    got = sorted((d["path"], d["line"], d["rule"]) for d in seeded.get("findings", []))
    report = {
        "pristine_rc": rc0, "pristine_findings": clean.get("count"),
        "pristine_loaded": clean.get("loaded"), "seeded_rc": rc1,
        "expected": [f"{p}:{ln}: {r}" for p, ln, r in want],
        "reported": [f"{p}:{ln}: {r}" for p, ln, r in got],
        "seconds": round(time.monotonic() - t0, 3),
    }
    report["ok"] = (rc0 == 0 and clean.get("count") == 0 and clean.get("loaded") == []
                    and rc1 == 1 and got == want)
    if "error" in clean or "error" in seeded:
        report["error"] = clean.get("error") or seeded.get("error")
    return report


def main(argv=None) -> int:
    report = drill()
    print("analysis smoke: pristine copy exit", report["pristine_rc"], "with",
          report["pristine_findings"], "finding(s), loaded", report["pristine_loaded"])
    print("analysis smoke: seeded copy exit", report["seeded_rc"])
    for line in report["reported"]:
        print("  reported", line)
    for line in report["expected"]:
        print("  expected", line)
    if report.get("error"):
        print(report["error"], file=sys.stderr)
    print(f"analysis smoke: {'PASS' if report['ok'] else 'FAIL'} ({report['seconds']} s)")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
