"""Structured logging setup shared by the CLIs and daemons.

Reference: slog 1.x with -v verbosity flags (cli/src/main.rs:83-88,
server-cli/src/lib.rs:29-36); here stdlib logging with one canonical
format: timestamp, level, logger, message.

``SDA_LOG_FORMAT=json`` switches to one JSON object per record, stamped
with the active ``trace_id``/``span_id`` from the tracing layer
(``sda_tpu_torch.obs``) so logs and traces join on one key.
"""

from __future__ import annotations

import json
import logging
import os

_LEVELS = [logging.WARNING, logging.INFO, logging.DEBUG]
FORMAT = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts, level, logger, message, plus
    trace_id/span_id when a span is active on the logging thread."""

    def format(self, record: logging.LogRecord) -> str:
        from .. import obs

        obj = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        ctx = obs.current_context()
        if ctx is not None:
            obj["trace_id"] = ctx.trace_id
            obj["span_id"] = ctx.span_id
        if record.exc_info:
            obj["exc_info"] = self.formatException(record.exc_info)
        return json.dumps(obj)


def log_format() -> str:
    """``"json"`` when SDA_LOG_FORMAT=json, else ``"text"``."""
    raw = os.environ.get("SDA_LOG_FORMAT", "").strip().lower()
    return "json" if raw == "json" else "text"


def configure_logging(verbosity: int = 0) -> None:
    """verbosity 0 -> WARNING, 1 -> INFO, >=2 -> DEBUG (the -v/-vv flags).
    Honors ``SDA_LOG_FORMAT=json`` (trace-correlated structured logs)."""
    level = _LEVELS[min(int(verbosity), len(_LEVELS) - 1)]
    if log_format() == "json":
        handler = logging.StreamHandler()
        handler.setFormatter(JsonFormatter())
        logging.basicConfig(level=level, handlers=[handler])
    else:
        logging.basicConfig(level=level, format=FORMAT)
