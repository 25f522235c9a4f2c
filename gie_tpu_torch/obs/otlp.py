"""(Copy of gie_tpu/obs/otlp.py, imports rewritten to gie_tpu_torch.)

OTLP/HTTP JSON span export (docs/OBSERVABILITY.md "OTLP export").

The traces the Tracer already exports to the /debugz feeds additionally
POST to an OpenTelemetry collector as OTLP/HTTP **JSON** (`/v1/traces`) —
the encoding the OTLP spec defines alongside protobuf, so no new dependency rides in.

Hot-path contract: ``export`` (the Tracer.on_export sink) only appends
to a bounded deque and sets an event — serialization and the HTTP POST
happen on this module's background thread, batched (``batch_max`` spans
or ``flush_interval_s``, whichever first). A slow or dead collector
costs dropped spans (the deque bound), never a slow request teardown.

Span mapping: one root span per exported trace (name "gie.request",
the trace's own W3C trace ID, a span ID derived deterministically from
it) whose span EVENTS are the trace's stage events. A federation hop
(the ``federation:<peer>`` stage the batching completer stamps on a
cross-cluster pick, docs/FEDERATION.md) additionally becomes a CHILD
span "gie.federation" carrying the peer cluster attribute — so a pick
that spilled to a peer reads as one joined trace in the collector, the
gateway leg parented over the cross-cluster leg.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
import zlib
from collections import deque
from typing import Optional

from gie_tpu_torch.runtime.logging import get_logger

_NS = 1_000_000_000


def _span_id(trace_id: str, salt: str = "") -> str:
    """Deterministic 16-hex span ID from the trace ID (no RNG: replays
    and multi-replica exports agree)."""
    a = zlib.crc32((trace_id + salt).encode()) & 0xFFFFFFFF
    b = zlib.crc32((salt + trace_id[::-1]).encode()) & 0xFFFFFFFF
    sid = f"{a:08x}{b:08x}"
    return sid if sid != "0" * 16 else "1" + sid[1:]


def _attr(key: str, value) -> dict:
    if isinstance(value, bool):
        return {"key": key, "value": {"boolValue": value}}
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if isinstance(value, int):
            return {"key": key, "value": {"intValue": str(value)}}
        return {"key": key, "value": {"doubleValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


def trace_to_spans(trace: dict) -> list:
    """One exported Tracer dict -> OTLP span list (root + optional
    federation child). Pure function — unit-testable without a wire."""
    trace_id = str(trace.get("trace_id", "")).ljust(32, "0")[:32]
    end_s = float(trace.get("finished_at", time.time()))
    latency_s = float(trace.get("latency_ms", 0.0)) / 1e3
    start_s = end_s - max(latency_s, 0.0)
    from gie_tpu_torch.obs.trace import Tracer

    root_sid = _span_id(trace_id)
    outcome = str(trace.get("outcome", ""))
    # ONE error classification for both surfaces: the /debugz feeds and
    # the exported span status must agree on what counts as an error
    # (shed and deadline included — overload failures are exactly what
    # collector-side alerts watch).
    err = outcome in Tracer.ERROR_OUTCOMES
    root = {
        "traceId": trace_id,
        "spanId": root_sid,
        "name": "gie.request",
        "kind": 2,  # SPAN_KIND_SERVER
        "startTimeUnixNano": str(int(start_s * _NS)),
        "endTimeUnixNano": str(int(end_s * _NS)),
        "attributes": [
            _attr("gie.outcome", outcome),
            _attr("gie.sampled", bool(trace.get("sampled", False))),
            _attr("gie.request_id", str(trace.get("request_id", ""))),
        ],
        "status": {"code": 2 if err else 1},
        "events": [],
    }
    pick = trace.get("pick")
    if isinstance(pick, dict):
        root["attributes"].append(_attr("gie.chosen", pick.get("chosen", "")))
        root["attributes"].append(_attr("gie.rung", pick.get("rung", "")))
    spans = [root]
    for ev in trace.get("events", ()):
        stage = str(ev.get("stage", ""))
        at_s = start_s + float(ev.get("at_ms", 0.0)) / 1e3
        root["events"].append({
            "timeUnixNano": str(int(at_s * _NS)),
            "name": stage,
        })
        if stage.startswith("federation:"):
            # The cross-cluster hop as its own child span: from the
            # spill decision to the end of the request (the remote
            # serve), parented under the gateway leg.
            peer = stage.partition(":")[2]
            spans.append({
                "traceId": trace_id,
                "spanId": _span_id(trace_id, salt=stage),
                "parentSpanId": root_sid,
                "name": "gie.federation",
                "kind": 3,  # SPAN_KIND_CLIENT
                "startTimeUnixNano": str(int(at_s * _NS)),
                "endTimeUnixNano": str(int(end_s * _NS)),
                "attributes": [_attr("gie.peer_cluster", peer)],
                "status": {"code": root["status"]["code"]},
            })
    return spans


class OtlpSpanExporter:
    """Batched background OTLP/HTTP JSON exporter. ``export`` is the
    Tracer.on_export sink (enqueue-only); ``close`` flushes."""

    def __init__(self, endpoint: str, *, service_name: str = "gie-tpu-epp",
                 batch_max: int = 64, flush_interval_s: float = 2.0,
                 queue_max: int = 2048, timeout_s: float = 5.0,
                 post=None):
        self.url = endpoint.rstrip("/") + "/v1/traces"
        self.service_name = service_name
        self.batch_max = max(int(batch_max), 1)
        self.flush_interval_s = flush_interval_s
        self.timeout_s = timeout_s
        self._post = post if post is not None else self._http_post
        self.log = get_logger("obs.otlp")
        # deque appends/popleft are GIL-atomic; the bound makes a dead
        # collector cost dropped spans, never memory.
        self._queue: deque = deque(maxlen=max(int(queue_max), 1))
        self._kick = threading.Event()
        self._stop = threading.Event()
        self.exported = 0
        self.dropped = 0
        self.post_errors = 0
        self._thread = threading.Thread(
            target=self._loop, name="otlp-export", daemon=True)
        self._thread.start()

    # -- sink (request-teardown side; never blocks) ------------------------

    def export(self, trace: dict) -> None:
        if len(self._queue) == self._queue.maxlen:
            self.dropped += 1  # the append below evicts the oldest
        self._queue.append(trace)
        if len(self._queue) >= self.batch_max:
            self._kick.set()

    # -- background side ---------------------------------------------------

    def _http_post(self, body: bytes) -> None:
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            r.read()

    def _drain(self) -> list:
        out = []
        while len(out) < self.batch_max:
            try:
                out.append(self._queue.popleft())
            except IndexError:
                break
        return out

    def _flush(self) -> None:
        while True:
            batch = self._drain()
            if not batch:
                return
            spans = []
            for trace in batch:
                try:
                    spans.extend(trace_to_spans(trace))
                except Exception:
                    self.dropped += 1
            if not spans:
                continue
            payload = {
                "resourceSpans": [{
                    "resource": {"attributes": [
                        _attr("service.name", self.service_name)]},
                    "scopeSpans": [{
                        # The reference's scope name: a collector sees
                        # one instrumentation scope for either package.
                        "scope": {"name": "gie_tpu.obs"},
                        "spans": spans,
                    }],
                }],
            }
            try:
                self._post(json.dumps(payload).encode())
                self.exported += len(spans)
            except Exception as e:
                self.post_errors += 1
                self.dropped += len(batch)
                self.log.v(3).info("otlp post failed", err=str(e))

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(self.flush_interval_s)
            self._kick.clear()
            try:
                self._flush()
            except Exception as e:  # the exporter must never die
                self.log.error("otlp flush failed", err=e)

    def close(self) -> None:
        self._stop.set()
        self._kick.set()
        self._thread.join(timeout=5)
        try:
            self._flush()  # final drain on the caller's thread
        except Exception:
            pass

    def report(self) -> dict:
        return {
            "url": self.url,
            "queued": len(self._queue),
            "exported": self.exported,
            "dropped": self.dropped,
            "post_errors": self.post_errors,
        }
