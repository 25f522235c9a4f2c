"""Lightweight span tracing for the request path (port of
gie_tpu/runtime/tracing.py).

Span durations go into a per-span histogram of the port's own collector
(runtime/metrics.py: same name, label and buckets as the reference's
prometheus histogram) and, at TRACE verbosity, into structured span logs.
Spans nest via a context manager; the overhead when nobody scrapes/logs is
two clock reads.
"""

from __future__ import annotations

import time

from gie_tpu_torch.runtime import logging as own_logging
from gie_tpu_torch.runtime.logging import TRACE, get_logger
from gie_tpu_torch.runtime.metrics import Histogram

SPANS = Histogram(
    "gie_span_seconds",
    "Duration of traced request-path spans",
    ["span"],
    buckets=(1e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0),
)

_log = get_logger("trace")

# Label-child cache: span names are a small fixed set on the admission
# hot path (2 spans per request), so resolve each child once.
_CHILDREN: dict = {}


def _child(name: str):
    child = _CHILDREN.get(name)
    if child is None:
        child = _CHILDREN[name] = SPANS.labels(span=name)
    return child


class _Span:
    """Slotted context manager: the histogram observe is always live, the
    TRACE log record is only constructed when TRACE verbosity is actually
    enabled."""

    __slots__ = ("name", "attrs", "started")

    def __init__(self, name: str, attrs):
        self.name = name
        self.attrs = attrs
        self.started = 0.0

    def __enter__(self):
        self.started = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        elapsed = time.monotonic() - self.started
        _child(self.name).observe(elapsed)
        if own_logging.trace_enabled():
            _log.v(TRACE).info(
                "span", name=self.name, seconds=round(elapsed, 6),
                **self.attrs
            )
        return False


def span(name: str, **attrs) -> _Span:
    """Time a request-path section: histogram always, TRACE-level
    structured log when verbosity allows."""
    return _Span(name, attrs)
