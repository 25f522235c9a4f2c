"""gie-obs: the causality layer (copy of gie_tpu/obs/__init__.py,
docs/OBSERVABILITY.md).

Aggregate histograms can say THAT p99 moved but never WHY request X
landed on pod Y, got a 503, or took 900 ms. This package is the missing
per-request record:

  trace.py     TraceCtx propagation (W3C ``traceparent`` / Envoy
               ``x-request-id``) through admission -> flow-queue hold ->
               wave -> pick -> serve outcome, with deterministic head
               sampling plus always-sample for errors/sheds/deadline
               breaches/latency tail outliers.
  recorder.py  the pick flight recorder: a fixed-size lock-free ring of
               per-request decision records (candidates, exclusions,
               scorer breakdown, rung, outcome) with JSON export.
  debugz.py    the /debugz introspection plane on the metrics HTTP
               surface (zpages for traces, pick explanations, breaker
               board, ladder, drain set, flow queue, datastore) plus the
               OpenMetrics exemplar exposition.
  otlp.py      batched OTLP/HTTP JSON span export of the exported traces.
  metricscheck.py  the metrics-catalog lint over the port's collector.

Install pattern mirrors resilience/faults.py: module globals guarded by
one attribute load so every woven site costs a falsy branch while obs
is uninstalled (the pick path's recorder writes happen at
wave-completion cadence, off the admission hot path entirely).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

# THE hot-path flags. extproc/batching read these per request/wave and
# branch away immediately while nothing is installed.
ENABLED = False
TRACER = None     # Optional[trace.Tracer]  — None also when sample rate 0
RECORDER = None   # Optional[recorder.FlightRecorder]


def install(tracer=None, recorder=None) -> None:
    """Install the process-global tracer and/or flight recorder (the
    runner does this at startup; tests install their own). Passing None
    for either leaves that surface disabled."""
    global ENABLED, TRACER, RECORDER
    TRACER = tracer
    RECORDER = recorder
    ENABLED = tracer is not None or recorder is not None


def uninstall() -> None:
    global ENABLED, TRACER, RECORDER
    ENABLED = False
    TRACER = None
    RECORDER = None


def dump_artifact(directory: str, name: str) -> Optional[str]:
    """Write the installed flight recorder (and, when tracing, the
    recent/error trace feeds) to ``directory/<name>-flightrec.json`` so
    a failed chaos scenario explains itself. Returns the path, or None
    when nothing is installed. Never raises — artifact capture rides on
    shutdown/test-failure paths that must complete regardless."""
    if RECORDER is None and TRACER is None:
        return None
    try:
        os.makedirs(directory, exist_ok=True)
        safe = "".join(
            c if (c.isalnum() or c in "-_.") else "-" for c in name)
        path = os.path.join(directory, f"{safe}-flightrec.json")
        payload = {
            "name": name,
            "written_at": time.time(),
            "records": RECORDER.snapshot() if RECORDER is not None else [],
        }
        if TRACER is not None:
            payload["traces"] = TRACER.traces("recent", n=64)
            payload["error_traces"] = TRACER.traces("errors", n=64)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        return path
    except Exception:
        return None
