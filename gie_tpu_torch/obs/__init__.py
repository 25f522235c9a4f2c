"""Request tracing for the pick service (from gie_tpu/obs/__init__.py).

`trace.py` (a copy of gie_tpu/obs/trace.py) carries the TraceCtx a
PickRequest rides through the flow queue and the wave; the picker stamps
its stages on `PickRequest.trace` when the transport attached one. The
process-global tracer is None until installed. `debugz.py` serves the
/debugz pages whose providers exist without the flight recorder; the
flight recorder, its pages and the trace pages come with the
observability slice of the port (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

# The hot-path flag the ext-proc loop reads per request: True while a
# tracer is installed.
ENABLED = False
TRACER = None     # Optional[trace.Tracer]


def install(tracer=None) -> None:
    """Install the process-global tracer (None leaves tracing off)."""
    global ENABLED, TRACER
    TRACER = tracer
    ENABLED = tracer is not None


def uninstall() -> None:
    global ENABLED, TRACER
    ENABLED = False
    TRACER = None
