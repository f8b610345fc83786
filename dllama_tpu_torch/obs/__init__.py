"""Serving telemetry: the port's copy of the JAX package's ``obs`` package
(metrics registry, Prometheus exposition, the dllama_* catalog, request-flow
tracing, the perf aggregator and the capture ledger) plus request-id
minting. The registry, catalog and tracer are stdlib only, so every layer
(engine, scheduler, API tier) imports them without cycles.

* :mod:`dllama_tpu_torch.obs.metrics`: the registry core and text exposition.
* :mod:`dllama_tpu_torch.obs.instruments`: the dllama_* metrics catalog,
  family for family the JAX package's.
* :mod:`dllama_tpu_torch.obs.trace`: the bounded ring-buffer tracer and
  per-request flight recorder behind ``GET /debug/trace`` and
  ``GET /debug/requests`` (CLI: ``--trace-buffer``).
* :mod:`dllama_tpu_torch.obs.perf`: latency windows, the scheduler time
  ledger, decode-step pricing and the SLO policy.
* :mod:`dllama_tpu_torch.obs.compile`: the CUDA-graph capture ledger, the
  shape contract and host/device transfer accounting.
* :func:`new_request_id`: per-request ids (``req_...``) minted at HTTP
  admission and carried api -> scheduler -> engine; every response carries
  it in ``X-Request-Id``, every request-scoped log line as ``request_id``
  and every trace span in its args.
"""

from __future__ import annotations

import re
import uuid

from dllama_tpu_torch.obs import metrics, trace
from dllama_tpu_torch.obs.metrics import REGISTRY

_REQ_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,128}$")


def new_request_id(client_supplied: str | None = None) -> str:
    """Mint a ``req_<hex>`` id, or adopt a well-formed client-supplied
    ``X-Request-Id`` verbatim (a malformed one is replaced, never echoed
    into headers or logs)."""
    if client_supplied and _REQ_ID_RE.match(client_supplied):
        return client_supplied
    return "req_" + uuid.uuid4().hex[:24]


__all__ = ["metrics", "trace", "REGISTRY", "new_request_id"]
