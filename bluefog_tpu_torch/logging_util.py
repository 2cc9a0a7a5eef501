"""Leveled logging for bluefog_tpu_torch.

Port of ``bluefog_tpu/logging_util.py``: the C++ ``BFLOG`` macros
(reference bluefog/common/logging.h:54-73) and the Python logger
"bluefog" (bluefog/common/basics.py:27-34).  Level comes from
``BLUEFOG_LOG_LEVEL`` with the same names.

``BLUEFOG_LOG_FORMAT=json`` switches to structured output: one JSON
object per line carrying ``ts`` (unix seconds), ``level``, ``logger``,
``rank``, and ``msg``.  When the calling thread is inside an open
tracer span (``observe/tracer.py``), the line additionally carries
``span`` and ``track`` correlation fields, so structured logs join
against the Chrome trace.
"""

from __future__ import annotations

import json
import logging
import sys

from bluefog_tpu_torch import config as bfconfig

_LEVELS = {
    "trace": logging.DEBUG,  # python logging has no TRACE; map to DEBUG
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_logger = None


class _JsonFormatter(logging.Formatter):
    """One JSON object per record; exceptions fold into ``exc``; the
    calling thread's open tracer span (if any) folds into
    ``span``/``track`` so the line joins the Chrome trace."""

    def format(self, record: logging.LogRecord) -> str:
        obj = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "rank": bfconfig.process_id() or 0,
            "msg": record.getMessage(),
        }
        try:
            # lazy import: logging comes up before (and without) the
            # observe layer; a formatter must never fail a log call
            from bluefog_tpu_torch.observe.tracer import publish_tracer

            tr = publish_tracer()
            sp = tr.active_span() if tr is not None else None
            if sp is not None:
                obj["track"], obj["span"] = sp
        except Exception:
            pass
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj)


def _make_formatter() -> logging.Formatter:
    if bfconfig.log_format() == "json":
        return _JsonFormatter()
    fmt = "[%(levelname)s] %(name)s: %(message)s"
    if not bfconfig.log_hide_time():
        fmt = "%(asctime)s " + fmt
    return logging.Formatter(fmt)


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        logger = logging.getLogger("bluefog_tpu_torch")
        logger.setLevel(_LEVELS.get(bfconfig.log_level(), logging.WARNING))
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_make_formatter())
        logger.addHandler(handler)
        logger.propagate = False
        _logger = logger
    return _logger
