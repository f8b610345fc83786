"""The port's invariant analyzer (`dllama_tpu_torch.analysis`) against the JAX
package's (`dllama_tpu.analysis`), and the page pool's named lock.

* parity: every fixture is written once with a package placeholder and run
  through both analyzers; the shared rule families (catalog, lock,
  suppression, parse-error) must give the same (path, line, rule) lists;
* red and green fixtures for each rule the port recasts or replaces
  (graph-site, graph-label, dev-state, transfer-note, gate-routes,
  gate-kernels, gate-phases, doc-rules, doc-ranks);
* the live tree: 0 findings in under 5 s, torch/jax/dllama_tpu not loaded by
  the analyzer, an ascending lock graph; the seeded-violation drill;
* the page pool's lock: the named reentrant lock `engine.pool` in both
  packages, failing the same out-of-rank acquisition.

No model but the golden fixture; the CLI runs spawn small interpreters.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from dllama_tpu.analysis import core as jax_core
from dllama_tpu.engine import batch as jax_batch
from dllama_tpu.utils import locks as jax_locks
from dllama_tpu_torch.analysis import rules_gates, smoke
from dllama_tpu_torch.analysis.core import RULE_CATALOG, Project, run
from dllama_tpu_torch.engine import batch as tbatch
from dllama_tpu_torch.engine.radix import RadixCache
from dllama_tpu_torch.utils import locks

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: rule families whose meaning is the JAX analyzer's
SHARED = {"catalog-metric", "catalog-span", "catalog-event", "catalog-fault", "lock-order",
          "lock-leaf", "lock-unranked", "suppress-reason", "suppress-unknown", "parse-error"}


def _env():
    return dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)


# ------------------------------------------------------------ parity fixtures

_LOCKS = '''
from {pkg}.utils import faults, locks

_SCHED = locks.make_lock("scheduler.metrics")


class A:
    def __init__(self):
        self._metrics = locks.make_lock("obs.metrics")
        self._pool = locks.make_rlock("engine.pool")
        self._sched = locks.make_lock("scheduler.metrics")
        self._perf = locks.make_lock("obs.perf")

    def f(self):
{body}

    def g(self):
        with self._sched:
            pass
'''


def _locks(body: str) -> dict:
    return {"{pkg}/serve/fake.py": _LOCKS.format(pkg="{pkg}", body=textwrap.indent(
        textwrap.dedent(body).strip("\n"), " " * 8))}


PARITY = {
    "suppress-on-line": ({"{pkg}/serve/fake.py": (
        'from {pkg}.utils import faults\n'
        'faults.fire("nope")  # dllama: allow[catalog-fault] a drill point\n')}, []),
    "suppress-on-def": ({"{pkg}/serve/fake.py": (
        'from {pkg}.utils import faults\n\n\n'
        'def drill():  # dllama: allow[catalog-fault] points the test arms itself\n'
        '    faults.fire("nope")\n'
        '    faults.flag("nope.either")\n')}, []),
    "suppress-bare": ({"{pkg}/serve/fake.py": (
        'from {pkg}.utils import faults\n'
        'faults.fire("nope")  # dllama: allow[catalog-fault]\n')}, ["suppress-reason"]),
    "suppress-unknown": ({"{pkg}/serve/fake.py": (
        'x = 1  # dllama: allow[no-such-rule] a reason\n')}, ["suppress-unknown"]),
    "suppress-in-docstring": ({"{pkg}/serve/fake.py": (
        'from {pkg}.utils import faults\n\n\n'
        'def drill():\n'
        '    "# dllama: allow[catalog-fault] prose, not policy"\n'
        '    faults.fire("nope")\n')}, ["catalog-fault"]),
    "parse-error": ({"{pkg}/engine/broken.py": "def broken(:\n",
                     "{pkg}/serve/fake.py": (
                         'from {pkg}.utils import faults\nfaults.fire("nope")\n')},
                    ["catalog-fault", "parse-error"]),
    "catalog-metric": ({"{pkg}/serve/fake.py": (
        'from {pkg}.obs import metrics\nX = metrics.counter("x", "h")\n')}, ["catalog-metric"]),
    "catalog-metric-sited": ({"{pkg}/obs/instruments.py": (
        'from {pkg}.obs import metrics\nX = metrics.counter("x", "h")\n')}, []),
    "catalog-span": ({"{pkg}/serve/fake.py": (
        'from {pkg}.obs import trace\n\n\ndef go():\n    tr = trace.TRACER\n'
        '    tr.span_at("bogus.span", 0.0, 1.0)\n    tr.span_at("decode.device", 0.0, 1.0)\n')},
        ["catalog-span"]),
    "catalog-event": ({"{pkg}/serve/fake.py": (
        'from {pkg}.obs import trace\n\n\ndef go():\n    trace.TRACER.event("bogus.event")\n'
        '    trace.TRACER.event("drain.begin")\n')}, ["catalog-event"]),
    "catalog-fault": ({"{pkg}/serve/fake.py": (
        'from {pkg}.utils import faults\nfaults.fire("definitely.not.a.point")\n'
        'faults.fire("engine.decode")\n')}, ["catalog-fault"]),
    "lock-order-nested": (_locks('''
        with self._pool:
            with self._sched:
                pass
        '''), ["lock-order"]),
    "lock-order-same-module-callee": (_locks('''
        with self._pool:
            self.g()
        '''), ["lock-order"]),
    "lock-order-callee-in-another-module": (_locks('''
        with self._perf:
            faults.fire("engine.decode")
        '''), ["lock-order"]),
    "lock-leaf": (_locks('''
        with self._metrics:
            with self._pool:
                pass
        '''), ["lock-leaf"]),
    "lock-ascending": (_locks('''
        with self._sched, self._pool:
            with self._metrics:
                pass
        '''), []),
    "rlock-reentry": (_locks('''
        with self._pool:
            with self._pool:
                pass
        '''), []),
    "lock-reentry-non-reentrant": (_locks('''
        with self._sched:
            with self._sched:
                pass
        '''), ["lock-order"]),
    "lock-alias": ({"{pkg}/engine/fake.py": '''
from {pkg}.utils import locks

_SCHED = locks.make_lock("scheduler.metrics")


class Pool:
    def __init__(self):
        self._pool_mu = locks.make_rlock("engine.pool")


class Tree:
    def __init__(self, pool):
        self._mu = pool._pool_mu

    def insert(self):
        with self._mu:
            with _SCHED:
                pass
'''}, ["lock-order"]),
    "lock-dataclass-field": ({"{pkg}/utils/fake.py": '''
from dataclasses import dataclass, field

from {pkg}.utils import locks

_PLAN = locks.make_lock("faults.plan")


@dataclass
class Point:
    lock: object = field(default_factory=lambda: locks.make_lock("faults.point"), repr=False)

    def fire(self):
        with self.lock:
            with _PLAN:
                pass
'''}, ["lock-order"]),
    "lock-unranked": ({"{pkg}/serve/fake.py": (
        'from {pkg}.utils import locks\n_X = locks.make_lock("not.ranked")\n')},
        ["lock-unranked"]),
}


def _shared(diags, pkg: str) -> list[tuple[str, int, str]]:
    return sorted((d.path.replace(pkg + "/", "PKG/", 1), d.line, d.rule)
                  for d in diags if d.rule in SHARED)


def _files(fixture: dict, pkg: str) -> dict:
    return {rel.format(pkg=pkg): text.replace("{pkg}", pkg) for rel, text in fixture.items()}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_shared_rules_match_the_jax_analyzer(case):
    fixture, want = PARITY[case]
    jax = _shared(jax_core.run(jax_core.Project(_files(fixture, "dllama_tpu"))), "dllama_tpu")
    port = _shared(run(Project(_files(fixture, "dllama_tpu_torch"))), "dllama_tpu_torch")
    assert port == jax, (port, jax)
    assert sorted(r for _, _, r in port) == sorted(want), port


# -------------------------------------------------- the port's own rules

def _rules(files: dict, rule: str, root=None) -> list[tuple[str, int]]:
    return [(d.path, d.line) for d in run(Project(files, root=root)) if d.rule == rule]


def _line(text: str, needle: str) -> int:
    return next(i for i, ln in enumerate(text.splitlines(), 1) if needle in ln)


GRAPH_USES = '''import torch
from dllama_tpu_torch.engine import graphs
from dllama_tpu_torch.engine.graphs import Program as P


def capture(body, state):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        body()
    g.replay()
    return graphs.Program(body, {}, state, "cuda", True), P(body, {}, state, "cuda", True)
'''


def test_graph_site_red_outside_graphs_and_green_inside():
    rel = "dllama_tpu_torch/engine/fake.py"
    got = _rules({rel: GRAPH_USES}, "graph-site")
    want = [(rel, _line(GRAPH_USES, n)) for n in ("CUDAGraph()", "torch.cuda.graph(g)",
                                                  "g.replay()", "return graphs.Program")]
    assert sorted(got) == sorted(want + [want[-1]])  # both constructions on the last line
    assert _rules({"dllama_tpu_torch/engine/graphs.py": GRAPH_USES}, "graph-site") == []


LABEL = '''SPEC_VARIANTS = ("spec", "spec_pen")


class Programs:
    def label(self, key):
        single = self.tier == "single"
        if key[0] == "prefill":
            fn = "single_step" if single else "prefill_chunk"
        elif key[0] == "single_spec":
            fn, bucket = key[0], "k"
        elif key[0] in SPEC_VARIANTS:
            fn, bucket = key[0], "n"
        else:
            fn = "single_decode" if single else "decode"
        return fn, "b"
'''


@pytest.mark.parametrize("edit,needle", [
    (None, None),
    (('"decode"', '"decode_bogus"'), 'fn = "single_decode"'),
    (('("spec", "spec_pen")', '("spec", "spec_off")'), "elif key[0] in SPEC_VARIANTS"),
    (('fn, bucket = key[0], "k"', 'fn, bucket = self.tier, "k"'), "fn, bucket = self.tier"),
])
def test_graph_label_reads_every_label_programs_can_return(edit, needle):
    text = LABEL if edit is None else LABEL.replace(*edit)
    rel = "dllama_tpu_torch/engine/graphs.py"
    want = [] if needle is None else [(rel, _line(text, needle) + (needle.startswith("elif")))]
    assert _rules({rel: text}, "graph-label") == want


def test_graph_label_red_for_a_record_capture_literal():
    text = ('from dllama_tpu_torch.obs import compile as compile_obs\n'
            'compile_obs.LEDGER.record_capture("decode", "n1", 0.1, 0.0)\n'
            'compile_obs.LEDGER.record_capture("jit_step", "n1", 0.1, 0.0)\n')
    assert _rules({"dllama_tpu_torch/serve/fake.py": text}, "graph-label") == [
        ("dllama_tpu_torch/serve/fake.py", 3)]


DEV = '''import torch


def _set_row(dev, row, value):
    dev[row : row + 1].fill_(value)


class BatchEngine:
    def __init__(self, n):
        self._pos_dev = torch.zeros(n)
        self._counts = None
        self._alloc(n)

    def _alloc(self, n):
        self._last_dev = torch.zeros(n)

    def _ensure_counts(self):
        if self._counts is None:
            self._counts = torch.zeros(4)

    def device_state(self):
        out = {"pos": self._pos_dev, "last": self._last_dev, "k": self.cache.k}
        if self._counts is not None:
            out["counts"] = self._counts
        return out

    def {name}(self, slot):
        {body}
'''


def _dev(name: str, body: str) -> str:
    return DEV.replace("{name}", name).replace("{body}", body)


@pytest.mark.parametrize("name,body", [
    ("warm_restart", "self._pos_dev.copy_(torch.zeros(4))"),  # refilled in place
    ("warm_restart", "self._pos_dev.zero_(); self._last_dev.fill_(0)"),
    ("release", "_set_row(self._pos_dev, slot, 0)"),
    ("release", "self._counts[slot] = 0"),
    ("release", "self.cache.k[:, slot] = 0"),
    ("release", "self._last_dev.index_copy_(0, slot, self._pos_dev)"),
    ("release", "self.pos = torch.zeros(4)"),  # a host mirror, not a held tensor
])
def test_dev_state_green(name, body):
    files = {"dllama_tpu_torch/engine/batch.py": _dev(name, body)}
    assert _rules(files, "dev-state") == []


@pytest.mark.parametrize("name,body", [
    ("warm_restart", "self._pos_dev = torch.zeros(4)"),  # sanctioned in JAX, not here
    ("release", "self._pos_dev += 1"),
    ("release", "self.cache.k = torch.zeros(4)"),
    ("release", "self._last_dev, x = torch.zeros(4), 1"),
    ("release", "self._counts = torch.zeros(4)"),
])
def test_dev_state_red(name, body):
    text = _dev(name, body)
    rel = "dllama_tpu_torch/engine/batch.py"
    assert _rules({rel: text}, "dev-state") == [(rel, len(text.splitlines()))]


def test_dev_state_needs_its_definition_site():
    text = _dev("release", "pass").replace("def device_state", "def state")
    assert _rules({"dllama_tpu_torch/engine/batch.py": text}, "dev-state") == [
        ("dllama_tpu_torch/engine/batch.py", 1)]


XFER = '''import torch
from dllama_tpu_torch.obs import compile as compile_obs


class BatchEngine:
    def decode_consume(self, chunk):
        toks = {call}
        {note}
        a = 1
        b = 2
        c = 3
        return toks
'''


@pytest.mark.parametrize("call", [
    "chunk.toks.numpy()", "chunk.bad.item()", "chunk.toks.cpu()", "chunk.toks.tolist()",
    "chunk.toks.to(self.device)", "chunk.toks.to('cpu')",
    "torch.tensor([1], device=self.device)", "chunk.host.copy_(chunk.toks, non_blocking=True)",
    "chunk.dev.copy_(self._pinned(chunk.arr))", "torch.cuda.synchronize()",
    "chunk.event.synchronize()",
])
def test_transfer_note_red_without_a_note_and_green_with_one(call):
    rel = "dllama_tpu_torch/engine/batch.py"
    assert _rules({rel: XFER.format(call=call, note="pass")}, "transfer-note") == [(rel, 7)]
    noted = XFER.format(call=call, note='compile_obs.note_transfer("d2h", "decode_tokens", 8)')
    assert _rules({rel: noted}, "transfer-note") == []


@pytest.mark.parametrize("call", ["chunk.toks.to(torch.float32)", "chunk.arr.copy()",
                                  "chunk.dev.copy_(chunk.other)", "torch.tensor([1])"])
def test_transfer_note_ignores_what_moves_nothing_between_devices(call):
    rel = "dllama_tpu_torch/engine/batch.py"
    assert _rules({rel: XFER.format(call=call, note="pass")}, "transfer-note") == []


def test_transfer_note_only_guards_steady_functions():
    text = XFER.format(call="chunk.toks.numpy()", note="pass").replace("decode_consume",
                                                                       "session_cache")
    assert _rules({"dllama_tpu_torch/engine/batch.py": text}, "transfer-note") == []


_KSEL = "dllama_tpu_torch/engine/kernel_select.py"


def _readme(routes=("paged_kernel", "paged_gather"), rules=tuple(RULE_CATALOG),
            ranks=tuple(locks.LOCK_RANKS)) -> str:
    out = ["# x", "", "| Port route | When |", "|---|---|"]
    out += [f"| `{r}` | x |" for r in routes]
    out += ["", "| Port rule | Checks |", "|---|---|"] + [f"| `{r}` | x |" for r in rules]
    out += ["", "| Port lock | Rank | Guards |", "|---|---|---|"]
    out += [f"| `{r}` | 1 | x |" for r in ranks]
    return "\n".join(out) + "\n"


def test_gate_routes_green_and_red_both_directions():
    ksel = 'PAGED_ROUTES = ("paged_kernel", "paged_gather")\n'
    assert _rules({_KSEL: ksel, "README.md": _readme()}, "gate-routes") == []
    readme = _readme(routes=("paged_kernel", "paged_stale"))
    got = [d for d in run(Project({_KSEL: ksel, "README.md": readme}))
           if d.rule == "gate-routes"]
    msgs = " | ".join(d.message for d in got)
    assert "`paged_gather`" in msgs and "`paged_stale`" in msgs and len(got) == 2
    assert _rules({_KSEL: 'PAGED_ROUTES = ("paged_kernel",)\n',
                   "README.md": _readme(routes=("paged_kernel",))}, "gate-routes") == [(_KSEL, 1)]
    assert _rules({_KSEL: "X = 1\n", "README.md": _readme()}, "gate-routes") == [(_KSEL, 1)]


def test_the_jax_route_rule_ignores_the_port_tables():
    # the port's README tables sit beside the JAX ones in one README
    diags = [d for d in jax_core.run(jax_core.Project({
        "dllama_tpu/engine/kernel_select.py": 'PAGED_ROUTES = ("paged_kernel", "paged_gather")\n',
        "README.md": _readme()})) if d.rule in ("gate-routes", "doc-rules", "doc-ranks")]
    assert {d.rule for d in diags} <= {"doc-rules", "doc-ranks"}
    assert all(d.line == 1 for d in diags)  # missing JAX rows only, none of the port's read


_BUILD = "dllama_tpu_torch/ops/build.py"


def _kernel_files(libs=("q40_decode", "rms_norm"), cus=("q40_decode", "rms_norm"),
                  rows=("q40_decode", "rms_norm")) -> dict:
    build = "SIGNATURES = {\n" + "".join(f'    "{n}": (),\n' for n in libs) + "}\n"
    smoke_rows = "".join(f'    "{n}": ("case", "dllama_tpu_torch/ops/csrc/{n}.cu", "x", None),\n'
                         for n in rows)
    files = {_BUILD: build, "chip_smoke.py": "KERNEL_ROWS = {\n" + smoke_rows + "}\n"}
    files.update({f"dllama_tpu_torch/ops/csrc/{n}.cu": "" for n in cus})
    return files


def test_gate_kernels_green_and_red():
    assert _rules(_kernel_files(), "gate-kernels") == []
    assert _rules(_kernel_files(cus=("q40_decode",)), "gate-kernels") == [(_BUILD, 3)]
    assert _rules(_kernel_files(rows=("q40_decode",)), "gate-kernels") == [("chip_smoke.py", 1)]
    assert _rules(_kernel_files(rows=("q40_decode", "rms_norm", "kbench")),
                  "gate-kernels") == [("chip_smoke.py", 4)]


def test_gate_kernels_and_phases_on_disk_need_their_files(tmp_path):
    assert sorted(r for _, _, r in (
        (d.path, d.line, d.rule) for d in run(Project({}, root=str(tmp_path)))
        if d.rule in ("gate-kernels", "gate-phases"))) == ["gate-kernels", "gate-phases"]


def test_gate_phases_green_and_red():
    def smoke_text(phases):
        return ('import argparse\nap = argparse.ArgumentParser()\n'
                f'ap.add_argument("--phases", default="{",".join(phases)}")\n')

    full = rules_gates.REQUIRED_PHASES
    assert _rules({"chip_smoke.py": smoke_text(full + ("profile",))}, "gate-phases") == []
    lost = [p for p in full if p != "analysis"]
    got = [d for d in run(Project({"chip_smoke.py": smoke_text(lost)}))
           if d.rule == "gate-phases"]
    assert [(d.path, d.line) for d in got] == [("chip_smoke.py", 3)]
    assert "'analysis'" in got[0].message


def test_doc_rules_and_ranks_green_and_red():
    assert _rules({"README.md": _readme()}, "doc-rules") == []
    assert _rules({"README.md": _readme()}, "doc-ranks") == []
    readme = _readme(rules=[r for r in RULE_CATALOG if r != "dev-state"] + ["jit-scope"],
                     ranks=[r for r in locks.LOCK_RANKS if r != "engine.graphs"] + ["x.y"])
    got = {(d.rule, d.message.split("`")[1]) for d in run(Project({"README.md": readme}))
           if d.rule in ("doc-rules", "doc-ranks")}
    assert got == {("doc-rules", "dev-state"), ("doc-rules", "jit-scope"),
                   ("doc-ranks", "engine.graphs"), ("doc-ranks", "x.y")}


# -------------------------------------------------------------- live tree

def test_live_tree_zero_findings_fast_and_torch_free():
    out = subprocess.run([sys.executable, "-m", "dllama_tpu_torch.analysis", "--json"],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    doc = json.loads(out.stdout)
    assert doc["count"] == 0 and doc["findings"] == [], doc["findings"]
    assert doc["rules"] == len(RULE_CATALOG) == 19
    assert doc["seconds"] < 5.0, doc
    # the analyzer asserts it loaded none of them; here none was loaded at all
    assert doc["loaded"] == []


def test_lock_graph_cli_is_ascending():
    out = subprocess.run([sys.executable, "-m", "dllama_tpu_torch.analysis", "--lock-graph"],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    edges = out.stdout.strip().splitlines()
    assert edges
    for line in edges:
        holder, _, rest = line.partition(" -> ")
        hr = int(holder[holder.index("(") + 1:-1])
        ar = int(rest[rest.index("(") + 1:rest.index(")")])
        same = holder.split("(")[0] == rest.split("(")[0]
        assert hr < ar or (same and holder.split("(")[0] in ("engine.pool", "faults.edit",
                                                             "parallel.link")), line


def test_the_seeded_drill_fails_at_every_seeded_line():
    report = smoke.drill(ROOT)
    assert report["ok"], report
    assert len(report["reported"]) == 4


# ------------------------------------------------------- the page pool lock

def _lock_sequence(pool, lk) -> list[str]:
    """Hold the pool's lock, then take a higher, a lower and the same lock."""
    out = []
    with pool._mu:
        for name in ("faults.plan", "scheduler.metrics"):
            other = lk.make_lock(name)
            try:
                other.acquire()
                other.release()
                out.append(f"{name}: ok")
            except lk.LockOrderError:
                out.append(f"{name}: LockOrderError")
        with pool._mu:
            out.append("reenter: " + ",".join(lk.held_names()))
    return out


def test_page_pool_lock_is_named_and_fails_like_the_jax_pool():
    assert locks.armed() and jax_locks.armed()  # tests/conftest.py arms the audit
    port = tbatch.PagePool(8, 16, 2, 4)
    ref = jax_batch.PagePool(8, 16, 2, 4)
    assert isinstance(port._mu, locks.AuditedLock)
    assert (port._mu.name, port._mu.rank, port._mu.reentrant) == ("engine.pool", 20, True)
    assert RadixCache(port)._mu is port._mu  # the tree rides the pool's lock
    got, want = _lock_sequence(port, locks), _lock_sequence(ref, jax_locks)
    assert got == want == ["faults.plan: ok", "scheduler.metrics: LockOrderError",
                           "reenter: engine.pool,engine.pool"]


def test_inference_engine_device_state_keeps_its_addresses():
    from dllama_tpu_torch.engine.loader import load_model
    from tests.test_golden import FIXTURE_M

    eng = load_model(FIXTURE_M, device="cpu").engine
    before = {k: t.data_ptr() for k, t in eng.device_state().items()}
    assert {"cache.k", "cache.v", "token", "pos", "sampling"} <= set(before)
    eng.prefill(np.array([[1, 2, 3]]))
    eng.decode_greedy_n(4, 3)
    eng.decode_spec_greedy_n([1, 2, 3], 4, 4, k=2)
    after = {k: t.data_ptr() for k, t in eng.device_state().items()}
    assert {k: after[k] for k in before} == before
    assert {"spec.history", "spec.counters", "spec.n", "spec.out2"} <= set(after)
