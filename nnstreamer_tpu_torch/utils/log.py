"""Structured logging with backtrace support.

Parity with the reference logging layer (gst/nnstreamer/nnstreamer_log.h:
ml_logi/w/e/d macros + ml_loge_stacktrace): standard logging channel
``nnstreamer_tpu_torch`` plus an error-with-backtrace helper.

``NNS_LOG=json`` switches the channel to one-JSON-object-per-line
(machine-parseable for log aggregation)::

    {"ts": 1722700000.123, "level": "WARNING",
     "logger": "nnstreamer_tpu_torch", "msg": "...",
     "thread": "src:videotestsrc0"}

Any other ``NNS_LOG`` value sets the channel's level by name (e.g.
``NNS_LOG=debug``); both may be combined as ``NNS_LOG=json,debug``.
The JAX package's trace-context filter is not carried over: the port has
no pipeline tracer yet.
"""

from __future__ import annotations

import json
import logging
import os
import traceback

logger = logging.getLogger("nnstreamer_tpu_torch")


class JsonFormatter(logging.Formatter):
    """One JSON object per line (``NNS_LOG=json``)."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
            "thread": record.threadName,
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def configure_from_env(env: "str | None" = None) -> None:
    """Apply ``NNS_LOG`` (idempotent): ``json`` installs the JSON
    formatter on a dedicated handler for the channel; a level name sets
    the channel level.  Comma-separated to combine."""
    spec = os.environ.get("NNS_LOG", "") if env is None else env
    if not spec:
        return
    for token in str(spec).split(","):
        token = token.strip().lower()
        if not token:
            continue
        if token == "json":
            for h in logger.handlers:
                if isinstance(h.formatter, JsonFormatter):
                    break
            else:
                handler = logging.StreamHandler()
                handler.setFormatter(JsonFormatter())
                logger.addHandler(handler)
                logger.propagate = False   # no double-emit via root
        else:
            level = logging.getLevelName(token.upper())
            if isinstance(level, int):
                logger.setLevel(level)


configure_from_env()

ml_logd = logger.debug
ml_logi = logger.info
ml_logw = logger.warning
ml_loge = logger.error


def ml_loge_stacktrace(msg: str, *args) -> None:
    """Error + formatted python stack (reference _backtrace_to_string)."""
    stack = "".join(traceback.format_stack()[:-1])
    logger.error(msg + "\nBacktrace:\n%s", *args, stack)
