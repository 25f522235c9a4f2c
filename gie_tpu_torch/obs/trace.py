"""(Copy of gie_tpu/obs/trace.py, imports rewritten to gie_tpu_torch.)

End-to-end request tracing: context extraction, deterministic head
sampling, and the bounded export feeds the /debugz zpages read.

The reference ships no in-tree tracing (SURVEY.md 5.1 — OTLP appears
only as an indirect dependency). This is the minimal in-process form
that answers "why did request X land on pod Y / 503 / take 900 ms":

  * the trace ID comes from the W3C ``traceparent`` header when Envoy
    (or the client's own tracer) supplies one, else from Envoy's
    ``x-request-id``, else it is generated — so one ID correlates the
    gateway's view with the mesh's, and exemplars on the admission/pick
    histograms link Prometheus buckets back to exactly these traces;
  * sampling is a pure function of (seed, trace ID): every replica of
    an EPP fleet keeps or drops the SAME requests, and a replayed
    request samples identically (tests pin bit-identical keep/drop);
  * errors, sheds, deadline breaches, and latency tail outliers export
    regardless of the head decision — the traces worth having are
    exactly the ones head sampling would lose at low rates.

Hot-path budget: with sampling off (rate 0) the runner installs no
Tracer at all, so admission pays one module-attribute load and a falsy
branch (the bench-extproc guard pins it). With tracing on, every
request carries a slotted TraceCtx whose events are (name, monotonic)
tuple appends; the export dict is built only for kept traces, inside
``finish``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import zlib
from collections import deque
from typing import Optional

# Context headers read at the ext-proc headers hop (joined into
# extproc.server.NEEDED_REQUEST_HEADERS so the fast lane's needed-keys
# scan copies them).
TRACEPARENT_HEADER = "traceparent"
REQUEST_ID_HEADER = "x-request-id"

_HEX = set("0123456789abcdef")


def trace_id_from_headers(headers: dict) -> tuple[str, str]:
    """-> (trace_id, request_id). ``traceparent`` wins (the 32-hex trace
    field of ``00-<32 hex>-<16 hex>-<2 hex>``), else ``x-request-id``
    (Envoy's UUID, dashes stripped so the ID is exemplar/URL-clean),
    else empty — the caller generates. Malformed values fall through
    rather than erroring: tracing must never fail a request."""
    rid = ""
    vals = headers.get(REQUEST_ID_HEADER)
    if vals:
        rid = vals[0]
    vals = headers.get(TRACEPARENT_HEADER)
    if vals:
        tp = vals[0]
        # version-format per W3C: fixed offsets, lowercase hex.
        if len(tp) >= 55 and tp[2] == "-" and tp[35] == "-":
            tid = tp[3:35]
            if all(c in _HEX for c in tid) and tid != "0" * 32:
                return tid, rid
    if rid:
        stripped = rid.replace("-", "").lower()
        if stripped and all(c in _HEX for c in stripped):
            return stripped[:32], rid
        # Non-hex request IDs still correlate: hash to a stable 32-hex.
        return f"{zlib.crc32(rid.encode()):08x}" + "0" * 24, rid
    return "", rid


class TraceCtx:
    """Per-request trace context: slotted, allocated once at the ext-proc
    headers hop, threaded by reference through admission -> flow queue ->
    wave assembly -> pick -> serve outcome. Events are (stage, monotonic)
    tuples; holders append directly (list.append is GIL-atomic and the
    context belongs to one request)."""

    __slots__ = ("trace_id", "request_id", "sampled", "started", "events")

    def __init__(self, trace_id: str, request_id: str, sampled: bool,
                 started: float):
        self.trace_id = trace_id
        self.request_id = request_id
        self.sampled = sampled
        self.started = started
        self.events: list = [("admission", started)]

    def event(self, name: str) -> None:
        self.events.append((name, time.monotonic()))


class Sampler:
    """Deterministic head sampler: keep/drop is a pure function of
    (seed, trace_id) via a seeded CRC32 — bit-identical across calls,
    instances, and replicas (tests/test_obs.py pins this). No RNG state,
    so concurrent admission threads never contend."""

    __slots__ = ("rate", "seed", "_threshold")

    def __init__(self, rate: float, seed: int = 0):
        if not (0.0 <= rate <= 1.0):
            raise ValueError(f"sample rate must be in [0, 1], got {rate}")
        self.rate = rate
        self.seed = seed & 0xFFFFFFFF
        self._threshold = int(rate * 0x1_0000_0000)

    def keep(self, trace_id: str) -> bool:
        if self._threshold >= 0x1_0000_0000:
            return True
        if self._threshold <= 0:
            return False
        return zlib.crc32(trace_id.encode(), self.seed) < self._threshold


class Tracer:
    """Begin/finish surface + the bounded export feeds.

    ``begin`` runs on the admission path for every request while tracing
    is on: extract/generate the ID, decide sampling, hand back a
    TraceCtx. ``finish`` runs at stream teardown on EVERY exit path
    (extproc.server._process's finally — ok, shed, deadline 503,
    unavailable, stream abort, internal error) and exports the trace
    when it was head-sampled OR its outcome/latency makes it one of the
    always-sample classes. Export feeds are deques (appends GIL-atomic)
    behind one leaf lock (lockorder.toml rank 91) held only for the
    append + counter bump — no I/O, no serialization under it.
    """

    # Outcomes that export regardless of the head-sampling decision.
    ERROR_OUTCOMES = frozenset({
        "shed", "deadline", "unavailable", "error", "aborted", "serve_5xx",
    })

    def __init__(self, sample_rate: float, seed: int = 0,
                 slow_s: float = 0.25, keep: int = 256,
                 tenant_rates: Optional[dict] = None):
        self.sampler = Sampler(sample_rate, seed)
        # Per-tenant head-sampling overrides (--obs-tenant-sample,
        # docs/FAIRNESS.md): one noisy tenant traced at 1.0 while the
        # fleet stays at the fleet rate. Keyed by the request's fairness
        # ID (x-gateway-inference-fairness-id); same deterministic
        # seeded-CRC32 keep/drop as the fleet sampler, so replicas agree
        # per trace ID within a tenant too. Empty map = zero extra work
        # in begin() beyond one falsy check.
        self.tenant_rates = dict(tenant_rates or {})
        self._tenant_thresholds: dict[str, int] = {}
        self._tenant_header = ""
        if self.tenant_rates:
            # Deferred import: extproc.metadata is constant-only, but the
            # package import edge must not run at obs-module import time.
            from gie_tpu_torch.extproc import metadata as _md

            self._tenant_header = _md.FLOW_FAIRNESS_ID_KEY
            for tenant, rate in self.tenant_rates.items():
                if not (0.0 <= rate <= 1.0):
                    raise ValueError(
                        f"tenant sample rate must be in [0, 1]: "
                        f"{tenant}={rate}")
                self._tenant_thresholds[tenant] = int(rate * 0x1_0000_0000)
        # Latency tail threshold: a request slower than this exports even
        # unsampled (the "why did request X take 900 ms" class).
        self.slow_s = slow_s
        self._gen = itertools.count(1)
        self._gen_prefix = f"{os.getpid() & 0xFFFF:04x}"
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=keep)
        self._errors: deque = deque(maxlen=keep)
        self._slow: deque = deque(maxlen=keep)
        self.started_total = 0
        self.exported_total = 0
        # Optional export sink (obs/otlp.py OtlpSpanExporter.export):
        # called OUTSIDE the feed lock with the finished trace dict. The
        # contract is enqueue-only — the sink must never block (the OTLP
        # exporter batches on its own thread).
        self.on_export = None

    # -- request path ------------------------------------------------------

    def begin(self, headers: dict) -> TraceCtx:
        tid, rid = trace_id_from_headers(headers)
        if not tid:
            # No upstream context: generate a local, collision-safe ID
            # (pid-prefixed counter — deterministic, no RNG).
            tid = f"{self._gen_prefix}{next(self._gen):012x}" + "0" * 16
        self.started_total += 1  # GIL-atomic; approximate under races
        sampled = self.sampler.keep(tid)
        if self._tenant_thresholds:
            vals = headers.get(self._tenant_header)
            if vals:
                threshold = self._tenant_thresholds.get(vals[0])
                if threshold is not None:
                    # Tenant override REPLACES the fleet decision both
                    # ways: a noisy tenant at 1.0 always keeps, a spammy
                    # one at 0.0 always drops (errors still always
                    # export via finish()).
                    sampled = (
                        threshold >= 0x1_0000_0000
                        or (threshold > 0 and zlib.crc32(
                            tid.encode(), self.sampler.seed) < threshold))
        return TraceCtx(tid, rid, sampled, time.monotonic())

    def finish(self, ctx: TraceCtx, outcome: str,
               record: Optional[dict] = None, detail: str = "") -> None:
        """Close one trace. Builds and stores the export dict only when
        the trace is kept; the drop path is two float compares."""
        now = time.monotonic()
        latency = now - ctx.started
        is_error = outcome in self.ERROR_OUTCOMES
        is_slow = latency >= self.slow_s
        if not (ctx.sampled or is_error or is_slow):
            return
        # Deferred import: runtime.metrics is import-light, but keeping
        # the module edge lazy lets unit tests drive the tracer bare.
        from gie_tpu_torch.runtime import metrics as own_metrics

        own_metrics.TRACES_EXPORTED.labels(
            reason="error" if is_error else
            ("slow" if is_slow else "sampled")).inc()
        started = ctx.started
        trace = {
            "trace_id": ctx.trace_id,
            "request_id": ctx.request_id,
            "sampled": ctx.sampled,
            "outcome": outcome,
            "detail": detail,
            "latency_ms": round(latency * 1e3, 3),
            "finished_at": time.time(),
            "events": [
                {"stage": name, "at_ms": round((t - started) * 1e3, 3)}
                for name, t in ctx.events
            ],
        }
        if record is not None:
            # Summary only — the full decision record lives in the
            # flight recorder and /debugz/pick joins on trace_id.
            trace["pick"] = {
                "chosen": record.get("chosen", ""),
                "rung": record.get("rung", ""),
                "outcome": record.get("outcome", ""),
            }
        with self._lock:
            self._recent.append(trace)
            if is_error:
                self._errors.append(trace)
            if is_slow:
                self._slow.append(trace)
            self.exported_total += 1
        sink = self.on_export
        if sink is not None:
            try:
                sink(trace)
            except Exception:
                pass  # span export must never fail a request teardown

    # -- zpage reads -------------------------------------------------------

    def traces(self, kind: str = "recent", n: int = 50) -> list[dict]:
        feed = {"recent": self._recent, "errors": self._errors,
                "slow": self._slow}.get(kind)
        if feed is None:
            return []
        with self._lock:
            items = list(feed)
        return items[-max(n, 0):][::-1]  # newest first

    def get(self, trace_id: str) -> Optional[dict]:
        # All three feeds: a tail-latency trace evicted from _recent
        # (but retained in _slow) must stay findable by ID — "why did
        # request X take 900 ms" is the lookup this method exists for.
        with self._lock:
            items = (list(self._recent) + list(self._errors)
                     + list(self._slow))
        for t in reversed(items):
            if t["trace_id"] == trace_id:
                return t
        return None

    def report(self) -> dict:
        with self._lock:
            return {
                "sample_rate": self.sampler.rate,
                "slow_ms": self.slow_s * 1e3,
                "started_total": self.started_total,
                "exported_total": self.exported_total,
                "recent": len(self._recent),
                "errors": len(self._errors),
                "slow": len(self._slow),
            }
