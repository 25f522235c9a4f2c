"""Request tracing for the pick service (from gie_tpu/obs/__init__.py).

`trace.py` (a copy of gie_tpu/obs/trace.py) carries the TraceCtx a
PickRequest rides through the flow queue and the wave; the picker stamps
its stages on `PickRequest.trace` when the transport attached one. The
process-global tracer is None until installed. The flight recorder and
the /debugz pages come with the observability slice of the port
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

TRACER = None     # Optional[trace.Tracer]


def install(tracer=None) -> None:
    """Install the process-global tracer (None leaves tracing off)."""
    global TRACER
    TRACER = tracer


def uninstall() -> None:
    global TRACER
    TRACER = None
