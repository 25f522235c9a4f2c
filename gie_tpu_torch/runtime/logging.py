"""Leveled structured JSON logging.

Mirror of reference pkg/common/observability/logging: zap-style JSON lines,
a shared atomic level adjustable at runtime, and the custom verbosity
mapping V(1-3)->info, V(4)->debug, V(5)->trace
(logger.go:35-52 customLevelEncoder; const.go:20-25 DEFAULT=2..TRACE=5).
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from typing import Any

# Verbosity levels (reference logging/const.go:20-25).
ERROR = 0
WARNING = 1
DEFAULT = 2
VERBOSE = 3
DEBUG = 4
TRACE = 5

_LEVEL_NAMES = {0: "error", 1: "warn", 2: "info", 3: "info", 4: "debug", 5: "trace"}


class _AtomicLevel:
    def __init__(self, v: int = DEFAULT):
        self._v = v
        self._lock = threading.Lock()

    def get(self) -> int:
        return self._v

    def set(self, v: int) -> None:
        with self._lock:
            self._v = v


_level = _AtomicLevel()


def set_verbosity(v: int) -> None:
    """Runtime level change (the -v flag bridge, reference
    logging/options.go:60-75)."""
    _level.set(v)


def trace_enabled() -> bool:
    """Public accessor: is TRACE verbosity live right now? Hot paths
    (runtime/tracing.py span exits) gate record construction on this
    instead of reaching into the private ``_level`` holder."""
    return _level.get() >= TRACE


class Logger:
    """JSON-lines logger with key-value context (zap sugar analogue)."""

    def __init__(self, name: str = "", stream=None, **context: Any):
        self.name = name
        self.stream = stream if stream is not None else sys.stderr
        self.context = context

    def with_values(self, **kv: Any) -> "Logger":
        merged = dict(self.context)
        merged.update(kv)
        return Logger(self.name, self.stream, **merged)

    def with_name(self, name: str) -> "Logger":
        full = f"{self.name}.{name}" if self.name else name
        return Logger(full, self.stream, **self.context)

    def v(self, level: int):
        return _Leveled(self, level)

    def info(self, msg: str, **kv: Any) -> None:
        self._emit(DEFAULT, msg, kv)

    def error(self, msg: str, err: Exception | None = None, **kv: Any) -> None:
        if err is not None:
            kv["error"] = f"{type(err).__name__}: {err}"
        self._emit(ERROR, msg, kv)

    def _emit(self, level: int, msg: str, kv: dict) -> None:
        if level > _level.get():
            return
        record = {
            "ts": round(time.time(), 6),
            "level": _LEVEL_NAMES.get(level, "info"),
            "logger": self.name,
            "msg": msg,
        }
        record.update(self.context)
        record.update(kv)
        try:
            self.stream.write(json.dumps(record, default=str) + "\n")
            self.stream.flush()
        except Exception:  # logging must never take the server down
            pass


class _Leveled:
    def __init__(self, logger: Logger, level: int):
        self._logger = logger
        self._level = level

    def info(self, msg: str, **kv: Any) -> None:
        self._logger._emit(self._level, msg, kv)


def get_logger(name: str = "gie") -> Logger:
    return Logger(name)
