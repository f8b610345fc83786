"""Shared logger setup: one place every entry point (CLI, benches, embedded
servers) configures logging, with an opt-in structured JSON mode
(``--log-format json``).

JSON schema (one object per line on stderr)::

    {"ts": "2026-08-03T12:00:00.123Z", "level": "INFO",
     "logger": "dllama_tpu_torch.serve", "msg": "...",
     "request_id": "req_...",          # when the line is request-scoped
     "exc": "Traceback ..."}           # when the record carries one

Any ``extra={...}`` fields a call site attaches (request ids, fault points,
HTTP status codes) are lifted into the object — the serving tier logs with
``extra={"request_id": rid}`` so shed/completed/failed traffic is
correlatable with the ``X-Request-Id`` response header. The text formatter
appends the same request id as a ``request_id=...`` suffix, so correlation
works in both modes.
"""

from __future__ import annotations

import json
import logging
import time

#: standard LogRecord attributes — anything else on a record came from
#: `extra=` and belongs in the structured output
_RESERVED = set(vars(logging.LogRecord("", 0, "", 0, "", (), None))) | {
    "message", "asctime", "taskName",
}


def _record_extras(record: logging.LogRecord) -> dict:
    return {
        k: v if isinstance(v, (str, int, float, bool, type(None))) else repr(v)
        for k, v in record.__dict__.items()
        if k not in _RESERVED and not k.startswith("_")
    }


class JsonFormatter(logging.Formatter):
    """One JSON object per record; extras lifted to top-level keys."""

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
        out = {
            "ts": f"{ts}.{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        out.update(_record_extras(record))
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class TextFormatter(logging.Formatter):
    """The classic human format, plus a ``request_id=...`` suffix whenever a
    record carries one — grep-for-the-header works in text mode too."""

    def format(self, record: logging.LogRecord) -> str:
        s = super().format(record)
        rid = record.__dict__.get("request_id")
        if rid:
            s += f" request_id={rid}"
        return s


def setup_logging(fmt: str = "text", verbose: bool = False) -> None:
    """Install the process-wide handler (replaces any prior root handlers —
    calling twice, e.g. tests re-entering main(), must not double-log)."""
    handler = logging.StreamHandler()
    if fmt == "json":
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            TextFormatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(logging.DEBUG if verbose else logging.INFO)
