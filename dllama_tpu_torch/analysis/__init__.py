"""The port's static invariant analyzer, the counterpart of
``dllama_tpu/analysis/``: a dependency-free (stdlib ``ast`` only; no torch,
no jax, nothing of ``dllama_tpu``) rule engine that machine-checks the
conventions the port's serving stack rests on. Run as
``python -m dllama_tpu_torch.analysis`` with ``file:line: rule-id message``
diagnostics, inline suppressions (``# dllama: allow[rule-id] reason``) and
a ``--json`` mode; ``python -m dllama_tpu_torch.analysis.smoke`` is its
seeded-violation drill.

Rule families (the README "Port rule" table is drift-checked against
:data:`RULE_CATALOG` both directions):

* **graph**: CUDA graphs are captured and replayed only in
  ``engine/graphs.py``, whose ``Program`` records every capture in the
  ledger under an ``obs/compile.COMPILE_FNS`` label (JAX's jit rules,
  recast over captured programs).
* **dev**: a tensor a captured program holds by address (the engines'
  ``device_state()``) is refilled in place, never rebound.
* **catalog**: metrics families, span/event names and fault points register
  only through their single-site catalogs (the JAX package's catalogs,
  name for name).
* **transfer**: host<->device transfers inside the steady-state decode/spec
  paths only at ``note_transfer``-annotated sites.
* **lock**: the static cross-module lock-order graph (named locks from
  ``utils/locks``) strictly ascends ``LOCK_RANKS``; nothing is acquired
  under the metrics/tracer leaf locks. The runtime half is the
  ``DLLAMA_LOCK_AUDIT=1`` sanitizer in ``utils/locks``.
* **gate**: the paged routes, the card's kernel inventory and the card
  smoke's default phases keep existing.
* **doc**: the README port-rule and port-lock tables match the code.
"""

from dllama_tpu_torch.analysis.core import (  # noqa: F401
    RULE_CATALOG,
    Diagnostic,
    Project,
    run,
)
