"""Scoped structured logging with dedup window, on ``logging``.

The port's own copy of the JAX package's ``utils/log.py`` behaviour
(reference: internal/log/log.go:18-135 — slog JSON logger with scope
fields and a sha256-keyed dedup window, default 5 s, env
LOG_DEDUP_WINDOW).  The port's modules log through
``logging.getLogger(__name__)``, and a scoped logger is a
``logging.LoggerAdapter(L, {...})``; so here:

- ``JSONFormatter`` writes the reference's line: ``time``, ``level``,
  ``msg``, the scope fields (a record's attributes that a bare
  ``LogRecord`` lacks: an adapter's ``extra``) and ``exc``;
- ``DedupFilter`` drops a repeat of the same level, message and sorted
  scope inside ``conf.env().log_dedup_window_s`` seconds (0 turns it
  off), keyed and pruned as the reference's ``Logger._should_emit``;
  one filter serves every handler, and its verdict rides on the record,
  so a line dropped on stderr is dropped in the file too;
- ``install()`` puts both on the ``pbs_plus_tpu_torch`` logger's stderr
  handler at INFO (where the reference does so at import), and
  ``add_rotating_file`` on a size-rotated file (50 MiB x 5).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import sys
import threading
import time
from typing import Any

ROOT = "pbs_plus_tpu_torch"
# the record attribute that carries the dedup verdict between handlers
_VERDICT = "_pbs_log_emit"
_BARE = frozenset(logging.LogRecord("", 0, "", 0, "", None, None).__dict__) \
    | {"message", "asctime", _VERDICT}

_lock = threading.Lock()
_dedup: dict[bytes, float] = {}
_filter: "DedupFilter | None" = None


def scope_of(record: logging.LogRecord) -> dict[str, Any]:
    """The record's scope fields: every attribute a bare record lacks, in
    the order the adapter's ``extra`` gave them."""
    return {k: v for k, v in record.__dict__.items() if k not in _BARE}


class JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry: dict[str, Any] = {
            "time": self.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
            "level": record.levelname,
            "msg": record.getMessage(),
        }
        scope = scope_of(record)
        if scope:
            entry.update(scope)
        if record.exc_info and record.exc_info[0] is not None:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry, separators=(",", ":"), default=str)


class DedupFilter(logging.Filter):
    """Drops a repeat of one level, message and scope inside
    ``conf.env().log_dedup_window_s`` seconds."""

    def __init__(self):
        super().__init__()
        from . import conf
        self._window = conf.env().log_dedup_window_s

    def filter(self, record: logging.LogRecord) -> bool:
        verdict = record.__dict__.get(_VERDICT)
        if verdict is None:
            verdict = self._should_emit(record.levelno, record.getMessage(),
                                        scope_of(record))
            record.__dict__[_VERDICT] = verdict
        return verdict

    def _should_emit(self, level: int, msg: str,
                     scope: dict[str, Any]) -> bool:
        if self._window <= 0:
            return True
        key = hashlib.sha256(
            f"{level}|{msg}|{sorted(scope.items())}".encode()
        ).digest()
        now = time.monotonic()
        with _lock:
            last = _dedup.get(key, 0.0)
            if now - last < self._window:
                return False
            _dedup[key] = now
            if len(_dedup) > 4096:
                cutoff = now - self._window
                for k in [k for k, v in _dedup.items() if v < cutoff]:
                    del _dedup[k]
        return True


def dedup_filter() -> DedupFilter:
    """The one filter every handler of the package's logger shares."""
    global _filter
    with _lock:
        if _filter is None:
            _filter = DedupFilter()
        return _filter


def _handler(h: logging.Handler) -> logging.Handler:
    h.setFormatter(JSONFormatter())
    h.addFilter(dedup_filter())
    return h


def install() -> logging.Logger:
    """The package's logger with a JSON stderr handler at INFO, as the
    reference sets up its own at import; a logger that already has
    handlers is left as it is."""
    log = logging.getLogger(ROOT)
    if not log.handlers:
        log.addHandler(_handler(logging.StreamHandler(sys.stderr)))
        log.setLevel(logging.INFO)
    return log


def add_rotating_file(path: str) -> None:
    """The package's log also into a size-rotated JSON file, 50 MiB x 5
    (reference: lumberjack rotation, internal/log/log_unix.go)."""
    import logging.handlers
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    logging.getLogger(ROOT).addHandler(_handler(
        logging.handlers.RotatingFileHandler(path, maxBytes=50 << 20,
                                             backupCount=5)))
