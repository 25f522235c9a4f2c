"""ext-proc StreamingServer: the request data path (port of
gie_tpu/extproc/server.py).

Behavioral port of reference pkg/lwepp/handlers/{server,request,response}.go
onto a transport-agnostic stream (recv/send), so the same Process loop runs
under the real gRPC service and under in-memory test streams (the
mockProcessServer pattern of reference handlers/server_test.go:33-59).

Choreography (reference server.go:105-287):
  RequestHeaders  -> parse headers + subset hint; pick immediately iff
                     end_of_stream, else defer until the body completes
  RequestBody     -> accumulate (10 MiB cap); on end_of_stream pick, emit the
                     deferred headers response, then the body response
  ResponseHeaders -> echo the served endpoint from envoy.lb metadata +
                     feed the served signal back to the picker
  ResponseBody    -> empty passthrough

Errors follow lwepp: no pods / no candidates -> gRPC UNAVAILABLE (the data
plane converts per FailureMode); shed -> ImmediateResponse 429 per the
endpoint-picker protocol (004 README:80).

Unlike the reference, ExtProcError carries its status by its gRPC name
("UNAVAILABLE", "RESOURCE_EXHAUSTED", ...), so the pick service and this
loop import no grpc; the transport (service.py) is the one place that maps
the name to a status code. The pick-facing types (PickRequest,
PickResult, ExtProcError, ShedError) are defined in extproc/pick.py, which
imports no protobuf, and re-exported here.
"""

from __future__ import annotations

import dataclasses
import math
import re
import time
from collections import deque
from typing import Optional, Protocol

from google.protobuf.message import DecodeError as _DecodeError

from gie_tpu_torch import obs
from gie_tpu_torch.bbr.chain import parse_body
from gie_tpu_torch.extproc import codec, envoy, fieldscan, metadata, pb, wire, wirecodec
from gie_tpu_torch.extproc.pick import (  # re-exported: defined without protobuf
    INTERNAL,
    INVALID_ARGUMENT,
    RESOURCE_EXHAUSTED,
    UNAVAILABLE,
    ExtProcError,
    PickRequest,
    PickResult,
    ShedError,
)
from gie_tpu_torch.obs import trace as obs_trace
from gie_tpu_torch.resilience import deadline as deadline_mod
from gie_tpu_torch.resilience import faults
from gie_tpu_torch.resilience.deadline import DeadlineExceeded
from gie_tpu_torch.runtime import metrics as own_metrics
from gie_tpu_torch.runtime import tracing

MAX_REQUEST_BODY_SIZE = 10 * 1024 * 1024  # reference server.go:103

# Request headers the pick path actually reads (by exact key, the way the
# readers look them up). The fast lane copies ONLY these out of the
# Envoy header map — the legacy path copied every header into ctx.headers
# per request, and the pick never read the rest (cookies, tracing
# baggage, auth material). Extend via StreamingServer(needed_headers=...)
# when a custom picker consumes additional keys.
NEEDED_REQUEST_HEADERS = frozenset({
    "content-type",                       # gRPC-in detection (codec)
    metadata.DECODE_TOKENS_HINT_KEY,
    metadata.MODEL_NAME_REWRITE_KEY,
    metadata.OBJECTIVE_KEY,               # criticality band (batching)
    metadata.FLOW_FAIRNESS_ID_KEY,        # fair interleave (batching)
    metadata.TTFT_SLO_MS_KEY,             # SLO admission (batching)
    metadata.TEST_ENDPOINT_SELECTION_HEADER,
    # Deadline propagation (resilience/deadline.py): the caller-pinned
    # bound and Envoy's route timeout.
    deadline_mod.GATEWAY_DEADLINE_HEADER,
    deadline_mod.ENVOY_TIMEOUT_HEADER,
    # Trace-context propagation (gie_tpu/obs, docs/OBSERVABILITY.md):
    # the W3C trace ID and Envoy's request ID.
    obs_trace.TRACEPARENT_HEADER,
    obs_trace.REQUEST_ID_HEADER,
})


# Body fields carrying the client's output-token cap, by API generation:
# completions/chat legacy, newer chat, responses API. The tuple lives in
# fieldscan so the native scanner, its fallback, and this module agree on
# field order (precedence) forever.
_MAX_TOKENS_FIELDS = fieldscan.MAX_TOKENS_FIELDS


# Bound on client-supplied token hints: beyond any real context window,
# and small enough that downstream features (decode_len / DECODE_NORM)
# stay finite — an inf/1e400 from a hostile body must not reach the
# predictor's training buffer (one NaN gradient poisons every later pick).
_DECODE_TOKENS_CAP = 1_000_000.0


def _clamp_tokens(v: float) -> float:
    if not math.isfinite(v) or v <= 0:
        return 0.0
    return min(v, _DECODE_TOKENS_CAP)


def _decode_tokens(
    headers: dict[str, list[str]],
    parsed: Optional[dict],
    scan: Optional[fieldscan.FieldScan] = None,
) -> float:
    """Expected output tokens for one request: explicit decode-tokens
    header first, else the body's max_tokens-style cap — read from the
    parsed dict (legacy lane) or the zero-parse field scan (fast lane;
    fieldscan.caps aligns with _MAX_TOKENS_FIELDS and applies the same
    numeric-not-bool rule). 0.0 when neither is present/parsable (the
    scheduler treats 0 as unknown). Values are clamped to a finite cap —
    JSON and float() both happily produce inf."""
    clamp = _clamp_tokens
    hint = headers.get(metadata.DECODE_TOKENS_HINT_KEY)
    if hint:
        # Guarded conversion, not try-first: the no-hint common case must
        # not pay a float("") ValueError per request.
        try:
            val = clamp(float(hint[0]))
            if val > 0:
                return val
        except (TypeError, ValueError):
            pass
    if parsed:
        for field in _MAX_TOKENS_FIELDS:
            v = parsed.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                val = clamp(float(v))
                if val > 0:
                    return val
    elif scan is not None and scan.valid:
        for v in scan.caps:
            if v is not None:
                val = clamp(v)
                if val > 0:
                    return val
    return 0.0


class EndpointPicker(Protocol):
    """reference handlers/server.go:80-82."""

    def pick(self, req: PickRequest, candidates: list) -> PickResult: ...


class RoundRobinPicker:
    """reference handlers/server.go:85-101."""

    def __init__(self) -> None:
        self._i = 0

    def pick(self, req: PickRequest, candidates: list) -> PickResult:
        if not candidates:
            raise ExtProcError(UNAVAILABLE, "no endpoints available")
        self._i += 1
        ep = candidates[self._i % len(candidates)]
        return PickResult(endpoint=ep.hostport)


@dataclasses.dataclass(slots=True)
class RequestContext:
    """Per-stream state. Slotted (no per-instance __dict__) and recycled
    through a bounded pool on the fast lane — one context is born and
    reset per request at full admission rate. Hooks receiving a context
    (on_served / on_response_complete) must not retain it past the call;
    reset hands out FRESH containers, so a PickRequest that outlives the
    stream (e.g. an abandoned scheduler item) keeps its own headers dict.
    """

    headers: dict[str, list[str]] = dataclasses.field(default_factory=dict)
    candidates: list = dataclasses.field(default_factory=list)
    # Which admission path served the pick ("fast" | "legacy") — the
    # gie_extproc_admission_seconds label, so rollout dashboards compare
    # the two lanes' latency live.
    lane: str = "legacy"
    # Monotonic request deadline from the deadline headers (0.0 = none).
    deadline_at: float = 0.0
    pick_result: Optional[PickResult] = None
    target_endpoint: str = ""
    selected_pod_ip: str = ""
    # http-in -> gRPC-out transcoding state (proposal 2162).
    transcoding: bool = False
    transcode_failed: bool = False
    stream_requested: bool = False
    model: str = ""
    frame_decoder: object = None
    response_frames: list = dataclasses.field(default_factory=list)
    held_bytes: int = 0  # running size of buffered response_frames
    # Response-stream observation (TPOT training signal, reference 006's
    # two-headed latency model): endpoint reported as having served, token
    # count harvested from the stream, and first/last body-chunk times.
    served_hostport: str = ""
    resp_tokens: int = 0
    resp_first_at: float = 0.0
    resp_last_at: float = 0.0
    # Data-plane outcome harvest (docs/RESILIENCE.md): when the pick
    # landed (monotonic; serve latency = response-headers time minus
    # this), the Envoy :status observed on the response (0 = none yet),
    # and whether response headers arrived at all — a stream that ends
    # after a pick but BEFORE response headers is an upstream reset, fed
    # back through on_stream_aborted so the assumed-load charge is
    # released and the breaker sees the reset.
    picked_at: float = 0.0
    resp_status: int = 0
    resp_headers_seen: bool = False
    # True when the stream ended ABNORMALLY (cancellation / transport /
    # protocol error) — the reset signal; a clean half-close leaves it
    # False and teardown only releases the charge.
    aborted: bool = False
    # Split-"data:" guard across chunk boundaries; seeded with a virtual
    # newline so a frame at stream start (no preceding terminator) anchors.
    sse_carry: bytes = b"\n"
    resp_tail: bytes = b""   # last bytes kept for the usage-block parse
    # True once bytes have been dropped from resp_tail: the tail is no
    # longer the whole body, so start-of-stream inferences (the leading
    # [DONE] sentinel arm) must not fire. An explicit flag, not a length
    # test — an exactly-4096-byte untruncated body is indistinguishable
    # from a truncated one by length alone.
    resp_tail_truncated: bool = False
    last_frame: Optional[bytes] = None  # last decoded Generate frame
    # True when the response chunk timing reflects GENERATION cadence
    # (transcoded Generate frames, or >=2 SSE data frames) — a buffered
    # JSON body split across network flushes must never train TPOT.
    timing_is_generation: bool = False
    # Trace context for this stream (obs.trace.TraceCtx, None while
    # tracing is off) and the outcome class its closure reports when an
    # exit path decided it explicitly (shed / deadline / unavailable /
    # error); "" lets teardown derive it from the stream state.
    trace: object = None
    trace_outcome: str = ""
    # Candidate set pinned by an upstream subset filter (strict
    # subsetting): threaded into PickRequest.subset so the federation
    # spill policy never widens it.
    subset: bool = False

    def reset(self) -> None:
        """Return to the pristine state with FRESH containers (never
        .clear() — a retained reference from a prior stream must keep its
        own data)."""
        self.headers = {}
        self.candidates = []
        self.lane = "legacy"
        self.deadline_at = 0.0
        self.pick_result = None
        self.target_endpoint = ""
        self.selected_pod_ip = ""
        self.transcoding = False
        self.transcode_failed = False
        self.stream_requested = False
        self.model = ""
        self.frame_decoder = None
        self.response_frames = []
        self.held_bytes = 0
        self.served_hostport = ""
        self.resp_tokens = 0
        self.resp_first_at = 0.0
        self.resp_last_at = 0.0
        self.sse_carry = b"\n"
        self.resp_tail = b""
        self.resp_tail_truncated = False
        self.last_frame = None
        self.subset = False
        self.timing_is_generation = False
        self.picked_at = 0.0
        self.resp_status = 0
        self.resp_headers_seen = False
        self.aborted = False
        self.trace = None
        self.trace_outcome = ""


# Bounded RequestContext free-list (fast lane): one context per stream at
# full admission rate; deque.append/pop are GIL-atomic so no lock.
_CTX_POOL: "deque[RequestContext]" = deque(maxlen=256)


def _acquire_ctx() -> RequestContext:
    try:
        ctx = _CTX_POOL.pop()
    except IndexError:
        return RequestContext()
    ctx.reset()
    return ctx


class StreamAborted(Exception):
    """The Envoy processing stream ended ABNORMALLY — cancellation or a
    transport error, raised by ``Stream.recv``. Distinct from a clean
    half-close (``recv() -> None``): Envoy tears the ext-proc stream
    down this way when the HTTP stream resets, while a clean close with
    no response phase just means response processing is not configured
    for this route — only the former is a serve outcome
    (docs/RESILIENCE.md data-plane signals)."""


class Stream(Protocol):
    def recv(self) -> Optional[pb.ProcessingRequest]: ...

    def send(self, resp: pb.ProcessingResponse) -> None: ...


class _HeadersTemplatePool:
    """Pre-serialized ProcessingResponse skeletons for the headers
    response, keyed by the sorted header-key tuple.

    The legacy path rebuilt the same nested tree — HeadersResponse /
    CommonResponse / HeaderMutation / N HeaderValueOptions / the
    dynamic-metadata Struct pyramid — from Python per request; only the
    VALUES differ between requests with the same key set (the overwhelming
    majority: the two protocol keys, plus BBR's model header when a chain
    runs). Here the skeleton is built once, serialized, and each request
    revives it with one C-level MergeFromString and patches the values.
    A fresh message per request, never a shared one: responses are queued
    for serialization by the gRPC layer (service.py) and held by test
    streams, so reusing a message object across requests would let a
    later pick mutate an earlier, not-yet-serialized response.

    Byte parity with the built-from-scratch path is pinned by
    tests/test_extproc_fastlane.py. The cache is bounded: header keys
    come from pick-result extra_headers, and an adversarial plugin must
    not grow an unbounded dict.
    """

    __slots__ = ("_templates", "_limit")

    def __init__(self, limit: int = 64):
        self._templates: dict[tuple[str, ...], bytes] = {}
        self._limit = limit

    def build(
        self, set_headers: dict[str, str], endpoint: str
    ) -> pb.ProcessingResponse:
        keys = tuple(sorted(set_headers))
        tpl = self._templates.get(keys)
        if tpl is None:
            skeleton = pb.ProcessingResponse(
                request_headers=pb.HeadersResponse(
                    response=pb.CommonResponse(
                        clear_route_cache=True,
                        header_mutation=envoy.generate_headers_mutation(
                            {k: "" for k in keys}
                        ),
                    )
                ),
                dynamic_metadata=envoy.make_dynamic_metadata(
                    metadata.DESTINATION_ENDPOINT_NAMESPACE,
                    {metadata.DESTINATION_ENDPOINT_KEY: ""},
                ),
            )
            tpl = skeleton.SerializeToString()
            if len(self._templates) < self._limit:
                # GIL-atomic insert; a racing duplicate build is harmless.
                self._templates[keys] = tpl
        resp = pb.ProcessingResponse()
        resp.MergeFromString(tpl)
        mutation = resp.request_headers.response.header_mutation
        for opt, key in zip(mutation.set_headers, keys):
            opt.header.raw_value = set_headers[key].encode()
        (
            resp.dynamic_metadata
            .fields[metadata.DESTINATION_ENDPOINT_NAMESPACE]
            .struct_value.fields[metadata.DESTINATION_ENDPOINT_KEY]
            .string_value
        ) = endpoint
        return resp


def _empty_body_response(request_path: bool) -> pb.ProcessingResponse:
    if request_path:
        return pb.ProcessingResponse(
            request_body=pb.BodyResponse(response=pb.CommonResponse())
        )
    return pb.ProcessingResponse(
        response_body=pb.BodyResponse(response=pb.CommonResponse())
    )


# Shared immutable pass-through responses (fast lane): nothing ever
# mutates these after construction, and concurrent SerializeToString on
# one message is read-only, so every stream can send the same object —
# the legacy path built a fresh two-level tree per body chunk.
_PASSTHROUGH_REQUEST_BODY = _empty_body_response(request_path=True)
_PASSTHROUGH_RESPONSE_BODY = _empty_body_response(request_path=False)

# Pre-resolved admission-histogram children: Histogram.labels() hashes the
# label tuple under a lock per call — measurable at per-request cadence.
_ADMISSION_LANES = {
    "fast": own_metrics.ADMISSION_SECONDS.labels(lane="fast"),
    "legacy": own_metrics.ADMISSION_SECONDS.labels(lane="legacy"),
}


def _observe_admission(ctx: "RequestContext", t0: float) -> None:
    """Admission histogram observe, with an OpenMetrics exemplar linking
    the bucket to this request's trace when it was head-sampled (the
    dashboards' histogram -> trace join, docs/OBSERVABILITY.md). The
    untraced path is the bare observe the fast lane always paid."""
    dt = time.perf_counter() - t0
    tr = ctx.trace
    if tr is not None and tr.sampled:
        _ADMISSION_LANES[ctx.lane].observe(dt, {"trace_id": tr.trace_id})
    else:
        _ADMISSION_LANES[ctx.lane].observe(dt)


def _shed_response(e: Exception) -> pb.ProcessingResponse:
    """ImmediateResponse for a request the EPP will not schedule: 429 for
    load shedding (ShedError, 004 README:80), 503 for an exhausted
    request deadline (DeadlineExceeded — the client's own budget gave up,
    per the protocol's unavailable semantics)."""
    if isinstance(e, DeadlineExceeded):
        return pb.ProcessingResponse(
            immediate_response=envoy.make_immediate_response(
                503, details="request deadline exceeded"))
    return pb.ProcessingResponse(
        immediate_response=envoy.make_immediate_response(
            429, details="request shed"))


# Pre-serialized constant responses for the wire lane (identity
# response_serializer): computed ONCE from the same message constructors
# the legacy path uses, so byte identity holds by construction.
_PASSTHROUGH_REQUEST_BODY_BYTES = _PASSTHROUGH_REQUEST_BODY.SerializeToString()
_PASSTHROUGH_RESPONSE_BODY_BYTES = _PASSTHROUGH_RESPONSE_BODY.SerializeToString()
_SHED_429_BYTES = _shed_response(ShedError()).SerializeToString()
_SHED_503_BYTES = _shed_response(DeadlineExceeded("wire")).SerializeToString()


class _StreamState:
    """Per-stream frame-loop state, shared verbatim between the legacy
    recv loop (_process_with) and the wire session: the accumulating
    request body, the deferred-headers flag, and the done latch the shed
    paths set (legacy `return`s; the wire session has no loop to return
    from)."""

    __slots__ = ("body", "headers_deferred", "done")

    def __init__(self):
        self.body = bytearray()
        self.headers_deferred = False
        self.done = False


class StreamingServer:
    """One instance serves all streams; Process is invoked per HTTP request
    (Envoy opens an ext-proc stream per request)."""

    def __init__(self, datastore, picker: EndpointPicker, on_served=None,
                 bbr_chain=None, transcode_h2c: bool = True,
                 on_response_complete=None, fast_lane: bool = True,
                 needed_headers=None, on_stream_aborted=None,
                 clock=None):
        self.datastore = datastore
        self.picker = picker
        # Clock seam (runtime/clock.py): deadline resolution/expiry and
        # the picked_at/serve-latency stamps the resilience layer
        # consumes are BEHAVIOR, so a virtual-time storm must serve them
        # from its own clock. Defaults to the picker's clock (the two
        # compare timestamps against each other), else real time.
        from gie_tpu_torch.runtime.clock import MONOTONIC

        self._clock = (clock if clock is not None
                       else getattr(picker, "_clock", MONOTONIC))
        # Admission fast lane (docs/EXTPROC.md): zero-parse field scan
        # instead of json.loads when the BBR chain can run from the scan,
        # needed-keys header copy, and pooled response templates. Off =
        # the seed's build-everything-per-request path (--extproc-fast-
        # lane rollout flag); outputs are byte-identical either way.
        self.fast_lane = fast_lane
        self._needed_headers = (
            NEEDED_REQUEST_HEADERS
            if needed_headers is None
            else frozenset(NEEDED_REQUEST_HEADERS) | frozenset(needed_headers)
        )
        self._headers_templates = _HeadersTemplatePool()
        # Compiled needed-keys spec for the native header scan (stable
        # bytes identity — the C side caches its parse per pointer).
        self._header_spec = fieldscan.HeaderSpec(self._needed_headers)
        # appProtocol cache, keyed on the datastore's pool generation.
        self._pool_proto_gen: Optional[int] = None
        self._pool_proto_grpc = False
        # Served-endpoint feedback hook (004 README:84-101): called with the
        # hostport reported by the data plane at response time.
        self.on_served = on_served
        # Response-stream-complete hook: called with the RequestContext
        # once the response body finishes — carries the harvested token
        # count + chunk timings (the TPOT training signal the
        # response-headers hop cannot observe).
        self.on_response_complete = on_response_complete
        # Stream-abort hook (docs/RESILIENCE.md data-plane signals):
        # called with the RequestContext when a stream that PICKED ends
        # before response headers arrive — an upstream reset or client
        # disconnect. The wired picker releases the assumed-load charge
        # (on_served will never fire for this stream) and records a
        # reset serve outcome against the primary endpoint's breaker.
        self.on_stream_aborted = on_stream_aborted
        # Optional BBR plugin chain (proposal 1964): runs over the complete
        # request body before the pick; its headers join the header mutation
        # and its body mutation is forwarded chunked.
        self.bbr_chain = bbr_chain
        # http-in -> gRPC-out transcoding for h2c pools (proposal 2162,
        # preferred detection: the observed InferencePool's appProtocol).
        self.transcode_h2c = transcode_h2c

    def _pool_wants_grpc(self) -> bool:
        if not self.transcode_h2c:
            return False
        # Pool specs change on reconcile cadence, not request cadence:
        # cache the appProtocol decision against the datastore's pool
        # generation instead of taking the datastore lock per request.
        gen = getattr(self.datastore, "pool_generation", None)
        if gen is not None and gen == self._pool_proto_gen:
            return self._pool_proto_grpc
        try:
            pool = self.datastore.pool_get()
        except Exception:
            value = False
        else:
            value = getattr(pool, "app_protocol", "http") == "kubernetes.io/h2c"
        if gen is not None:
            self._pool_proto_grpc = value
            self._pool_proto_gen = gen
        return value

    # ------------------------------------------------------------------ #

    def process(self, stream: Stream) -> None:
        own_metrics.STREAMS.inc()
        try:
            self._process(stream)
        finally:
            own_metrics.STREAMS.dec()

    def _process(self, stream: Stream) -> None:
        ctx = _acquire_ctx() if self.fast_lane else RequestContext()
        try:
            self._process_with(ctx, stream)
        except StreamAborted:
            ctx.aborted = True  # cancelled/reset: nothing left to send
        except ExtProcError as e:
            ctx.aborted = True  # stream-fatal protocol error
            if not ctx.trace_outcome:
                ctx.trace_outcome = (
                    "unavailable" if e.code == UNAVAILABLE
                    else "error")
            raise
        except Exception:
            ctx.aborted = True  # stream-fatal internal error
            if not ctx.trace_outcome:
                ctx.trace_outcome = "error"
            raise
        finally:
            # Teardown accounting (both lanes, every exit path): a stream
            # that picked but never saw response headers released nothing
            # and fed the breaker nothing; the hook releases the charge
            # on every such exit and records a reset outcome only for
            # ABNORMAL ends (ctx.aborted) — a clean half-close with no
            # response phase just means response processing is not
            # configured for this route, and counting those as resets
            # would quarantine every healthy pod behind such a listener.
            self._finish_stream(ctx)
            # Trace closure rides the same every-exit-path finally: ok,
            # shed, deadline 503, unavailable, abort, internal error —
            # every stream that began a trace closes it exactly once.
            if ctx.trace is not None:
                self._finish_trace(ctx)
            if self.fast_lane:
                # Hooks ran synchronously inside the loop; nothing holds
                # the context once the stream ends (reset() hands out
                # fresh containers for anything that does hold a dict).
                _CTX_POOL.append(ctx)

    def _finish_stream(self, ctx: RequestContext) -> None:
        """Stream teardown: if a pick happened but the response headers
        never arrived (Envoy reset the upstream stream, the client went
        away, the stream died on a protocol error, or the route simply
        has no response processing), the serve feedback loop would
        otherwise silently never fire — the assumed-load charge leaks
        until pod eviction. The hook releases it; ``ctx.aborted``
        decides whether the breaker also sees a reset outcome."""
        if (ctx.pick_result is None or ctx.resp_headers_seen
                or self.on_stream_aborted is None):
            return
        try:
            self.on_stream_aborted(ctx)
        except Exception:
            pass  # teardown accounting must never mask the stream error

    def _finish_trace(self, ctx: RequestContext) -> None:
        """Close this stream's trace (docs/OBSERVABILITY.md lifecycle).
        Outcome precedence: an exit path's explicit verdict (shed /
        deadline / unavailable / error), else the stream state (abort,
        serve 5xx), else ok. The pick's flight-recorder record — if one
        was published — is summarized into the exported trace."""
        tracer = obs.TRACER
        if tracer is None:
            return  # tracer uninstalled mid-stream (tests): drop quietly
        outcome = ctx.trace_outcome
        if not outcome:
            if ctx.aborted:
                outcome = "aborted"
            elif ctx.resp_status >= 500:
                outcome = "serve_5xx"
            else:
                outcome = "ok"
        pr = ctx.pick_result
        try:
            tracer.finish(ctx.trace, outcome,
                          record=pr.record if pr is not None else None)
        except Exception:
            pass  # trace export must never mask the stream outcome

    def _process_with(self, ctx: RequestContext, stream: Stream) -> None:
        state = _StreamState()
        recv, send, dispatch = stream.recv, stream.send, self._dispatch
        while True:
            req = recv()
            if req is None:
                return
            dispatch(ctx, req, state, send)
            if state.done:
                return

    def _dispatch(
        self, ctx: RequestContext, req: pb.ProcessingRequest,
        state: _StreamState, emit
    ) -> None:
        """One materialized frame through the Process choreography. The
        legacy loop feeds it straight from recv(); the wire session feeds
        it only the frames the walker FALLBACKed on (emit then serializes)
        — the choreography itself has exactly one implementation."""
        which = req.WhichOneof("request")
        if which == "request_headers":
            admission_t0 = time.perf_counter()
            if self.fast_lane:
                # No per-request tracing spans on the fast lane: two
                # span observes cost more than the scan they would
                # time; gie_extproc_admission_seconds carries the
                # admission signal instead (spans return with the
                # rollout flag off).
                self._handle_request_headers(ctx, req)
            else:
                with tracing.span("extproc.request_headers"):
                    self._handle_request_headers(ctx, req)
            if req.request_headers.end_of_stream:
                try:
                    self._pick(ctx, None)
                except (ShedError, DeadlineExceeded) as e:
                    ctx.trace_outcome = (
                        "deadline" if isinstance(e, DeadlineExceeded)
                        else "shed")
                    emit(_shed_response(e))
                    state.done = True
                    return
                emit(self._headers_response(ctx))
                _observe_admission(ctx, admission_t0)
            else:
                state.headers_deferred = True
        elif which == "request_body":
            chunk = req.request_body.body
            if len(state.body) + len(chunk) > MAX_REQUEST_BODY_SIZE:
                raise ExtProcError(
                    RESOURCE_EXHAUSTED,
                    f"request body size limit of {MAX_REQUEST_BODY_SIZE} "
                    "bytes exceeded",
                )
            state.body.extend(chunk)
            if req.request_body.end_of_stream:
                admission_t0 = time.perf_counter()
                try:
                    result = self._pick(ctx, bytes(state.body))
                except (ShedError, DeadlineExceeded) as e:
                    ctx.trace_outcome = (
                        "deadline" if isinstance(e, DeadlineExceeded)
                        else "shed")
                    emit(_shed_response(e))
                    state.done = True
                    return
                if state.headers_deferred:
                    emit(self._headers_response(ctx))
                    state.headers_deferred = False
                if result.mutated_body is not None:
                    for resp in envoy.build_chunked_body_responses(
                        result.mutated_body, request_path=True
                    ):
                        emit(resp)
                elif self.fast_lane:
                    emit(_PASSTHROUGH_REQUEST_BODY)
                else:
                    emit(
                        pb.ProcessingResponse(
                            request_body=pb.BodyResponse(
                                response=pb.CommonResponse()
                            )
                        )
                    )
                _observe_admission(ctx, admission_t0)
            # Intermediate chunks need no reply in buffered-partial mode.
        elif which == "response_headers":
            emit(self._handle_response_headers(ctx, req))
        elif which == "response_body":
            now = self._clock.now()
            if req.response_body.body:
                if ctx.resp_first_at == 0.0:
                    ctx.resp_first_at = now
                ctx.resp_last_at = now
            if ctx.transcoding:
                emit(
                    self._transcode_response_body(ctx, req.response_body)
                )
            else:
                self._count_plain_tokens(ctx, req.response_body.body)
                if self.fast_lane:
                    emit(_PASSTHROUGH_RESPONSE_BODY)
                else:
                    emit(
                        pb.ProcessingResponse(
                            response_body=pb.BodyResponse(
                                response=pb.CommonResponse()
                            )
                        )
                    )
            if req.response_body.end_of_stream:
                self._finish_token_count(ctx)
                if self.on_response_complete is not None:
                    self.on_response_complete(ctx)
        else:
            # request_trailers / response_trailers parse (wire-correct
            # fields 4/7) but are ignored, matching the reference
            # (server.go:283-285). Envoy only sends them when the
            # processing mode asks, which this EPP never does.
            return

    # ------------------------------------------------------------------ #

    def _handle_request_headers(
        self, ctx: RequestContext, req: pb.ProcessingRequest
    ) -> None:
        """reference handlers/request.go:34-139."""
        hdrs = req.request_headers
        if self.fast_lane:
            # Needed-keys scan: copy only the headers the pick path reads
            # (NEEDED_REQUEST_HEADERS + constructor extensions). Envoy
            # sends HTTP/2 headers lowercased, and every reader looks up
            # the exact lowercase key, so exact-match filtering sees
            # precisely what the legacy full copy made visible.
            # Native path: one C-level HeaderMap serialize + one wire walk
            # beats iterating N message wrappers from Python; the pure-
            # Python loop below is the no-library fallback (inlined
            # get_header_value — a function call per header is real money
            # at 12+ headers x full admission rate).
            out = ctx.headers
            pairs = (
                fieldscan.scan_headers(
                    hdrs.headers.SerializeToString(), self._header_spec
                )
                if fieldscan.headers_available()
                else None
            )
            if pairs is not None:
                for key, value in pairs:
                    bucket = out.get(key)
                    if bucket is None:
                        out[key] = [value]
                    else:
                        bucket.append(value)
            else:
                needed = self._needed_headers
                for h in hdrs.headers.headers:
                    key = h.key
                    if key in needed:
                        raw = h.raw_value
                        value = (
                            raw.decode("utf-8", "replace") if raw else h.value
                        )
                        bucket = out.get(key)
                        if bucket is None:
                            out[key] = [value]
                        else:
                            bucket.append(value)
        else:
            for h in hdrs.headers.headers:
                ctx.headers.setdefault(h.key, []).append(
                    envoy.get_header_value(h)
                )

        # Trace begin (gie_tpu/obs): with tracing off (sample rate 0 or
        # obs uninstalled) this is one module-attribute load and a None
        # check — the bench-extproc guard pins the unsampled fast lane.
        if obs.ENABLED:
            tracer = obs.TRACER
            if tracer is not None:
                ctx.trace = tracer.begin(ctx.headers)

        # Deadline propagation (resilience/deadline.py): resolve the
        # monotonic budget once, at header time. The no-deadline common
        # case costs two dict lookups.
        if (deadline_mod.GATEWAY_DEADLINE_HEADER in ctx.headers
                or deadline_mod.ENVOY_TIMEOUT_HEADER in ctx.headers):
            ctx.deadline_at = deadline_mod.deadline_from_headers(
                ctx.headers, now=self._clock.now())

        # Subset hint from filter metadata: string ("ip1,ip2") or array forms
        # (reference request.go:51-77 — both Envoy pathways supported).
        # Requests without filter metadata (the overwhelming majority) skip
        # the struct->dict conversion entirely.
        md = (
            envoy.extract_metadata_values(req)
            if req.metadata_context.filter_metadata
            else {}
        )
        has_subset_filter = False
        metadata_endpoints: list[str] = []
        subset_ns = md.get(metadata.SUBSET_FILTER_NAMESPACE)
        if isinstance(subset_ns, dict) and metadata.SUBSET_FILTER_KEY in subset_ns:
            has_subset_filter = True
            val = subset_ns[metadata.SUBSET_FILTER_KEY]
            if isinstance(val, str):
                parts = val.split(",")
            elif isinstance(val, list):
                parts = []
                for item in val:
                    if isinstance(item, str):
                        parts.extend(item.split(","))
            else:
                parts = []
            metadata_endpoints = [p.strip() for p in parts if p.strip()]

        # Test steering header takes priority (reference request.go:84-97).
        # Fast lane: the needed-keys pass above already captured it, so
        # read the dict instead of rescanning (and re-lowercasing) every
        # header. Envoy lowercases HTTP/2 header keys, so the exact-match
        # copy sees what the case-insensitive legacy scan would.
        if self.fast_lane:
            vals = ctx.headers.get(metadata.TEST_ENDPOINT_SELECTION_HEADER)
            test_val = vals[0] if vals else None
        else:
            test_val = envoy.extract_header_value(
                hdrs, metadata.TEST_ENDPOINT_SELECTION_HEADER
            )
        self._resolve_candidates(
            ctx, test_val, metadata_endpoints, has_subset_filter
        )

    def _resolve_candidates(
        self, ctx: RequestContext, test_val: Optional[str],
        metadata_endpoints: list[str], has_subset_filter: bool
    ) -> None:
        """Candidate-set resolution shared by both header handlers (the
        materialized one above and the wire lane's): steering header over
        subset hint over the datastore's non-draining snapshot."""
        filter_endpoints: list[str] = []
        if test_val:
            filter_endpoints = [p.strip() for p in test_val.split(",") if p.strip()]
        if not filter_endpoints and metadata_endpoints:
            filter_endpoints = metadata_endpoints

        all_eps = self.datastore.endpoints()
        if not all_eps:
            raise ExtProcError(UNAVAILABLE, "no pods available")

        if has_subset_filter or filter_endpoints:
            # ip or ip:port entries; bare ip allows all ports
            # (reference request.go:104-129).
            allow_all_ports: set[str] = set()
            allowed: set[str] = set()
            for e in filter_endpoints:
                if ":" in e:
                    allowed.add(e)
                else:
                    allow_all_ports.add(e)
            ctx.candidates = [
                ep
                for ep in all_eps
                if ep.address in allow_all_ports or ep.hostport in allowed
            ]
            ctx.subset = True
            # Strict subsetting: empty candidate set stays empty
            # (request.go:130-133) -> UNAVAILABLE at pick time. Subset
            # hints stay on the FULL list — a steering decision made
            # upstream is honored verbatim even mid-drain, and the
            # wave-level drain filter still prefers any non-draining
            # members of the subset.
            return
        # Graceful drain (docs/RESILIENCE.md): default candidacy is the
        # non-DRAINING snapshot — endpoints of terminating pods stop
        # receiving NEW picks while their in-flight streams complete.
        # Falls back to the full set when everything drains
        # (availability beats drain). getattr: latency/protocol tests
        # stub the datastore with plain endpoint lists.
        pick_cands = getattr(self.datastore, "pick_candidates", None)
        ctx.candidates = pick_cands() if pick_cands is not None else all_eps

    def _pick(self, ctx: RequestContext, body: Optional[bytes]) -> PickResult:
        """reference handlers/request.go:141-163."""
        if self.fast_lane:  # admission histogram replaces the span
            return self._pick_inner(ctx, body)
        with tracing.span("extproc.pick", candidates=len(ctx.candidates)):
            return self._pick_inner(ctx, body)

    def _pick_inner(self, ctx: RequestContext, body: Optional[bytes]) -> PickResult:
        """Admission core. Two lanes, byte-identical outputs:

        fast   (fast_lane on, and the BBR chain — if any — can answer
               from the field scan): ZERO json.loads. The native scanner
               (fieldscan) pulls model/stream/max_tokens in one pass; the
               body flows through untouched.
        legacy (flag off, or a plugin needs the parsed dict / mutates the
               body): at most ONE json.loads for the whole request path —
               the chain's shared parse (1964 README:59) rides into the
               decode-tokens extraction AND the transcoding codec below,
               which previously re-parsed the same bytes
               (bbr/chain.py:78 + codec.py:108).
        """
        if ctx.deadline_at and deadline_mod.expired(
                ctx.deadline_at, now=self._clock.now()):
            # Budget already exhausted at admission (it queued behind
            # flow control / a slow hop upstream): shed with 503 before
            # the scheduler charges a TPU cycle for an answer nobody is
            # waiting for.
            own_metrics.DEADLINE_SHED.labels(stage="admission").inc()
            raise DeadlineExceeded("admission")
        bbr_headers: dict[str, str] = {}
        bbr_body: Optional[bytes] = None
        parsed: Optional[dict] = None
        scan: Optional[fieldscan.FieldScan] = None
        # gRPC transcoding (checked up front so the lane choice can see
        # it): a body that will be reframed as a GenerateRequest needs a
        # full parse no matter what — scanning first would only add work.
        # The single parse below then rides into the codec.
        will_transcode = (
            body is not None
            and self._pool_wants_grpc()
            and not codec.is_grpc_request(ctx.headers)
        )
        if self.fast_lane and body and not will_transcode:
            chain = self.bbr_chain
            if chain is None:
                scan = fieldscan.scan(body)
            elif getattr(chain, "supports_scan", True):
                # supports_scan is checked BEFORE scanning: a chain that
                # statically cannot answer from the scan (a plugin without
                # the execute_scanned hook) must not pay a wasted body
                # pass per request on top of its full parse.
                scan = fieldscan.scan(body)
                scanned_headers = chain.execute_scanned(scan)
                if scanned_headers is None:
                    # THIS request needs the full parse (a body mutation
                    # fires): run the legacy chain. One parse.
                    scan = None
                else:
                    bbr_headers = scanned_headers
        if scan is None and body:
            if self.bbr_chain is not None:
                with tracing.span("extproc.bbr"):
                    bbr_headers, bbr_body, parsed = self.bbr_chain.execute(body)
            else:
                # No BBR chain: the EPP still owes the scheduler its
                # output-length hint; this is the request path's one parse
                # (same at-most-once contract as the chain's).
                parsed = parse_body(body)
        # Lane label = the rollout flag, not the per-request parse path:
        # templates and the needed-keys header scan apply flag-wide, and
        # dashboards compare deployments by flag setting. (A chain- or
        # transcode-forced full parse under the flag still reports fast.)
        ctx.lane = "fast" if self.fast_lane else "legacy"
        # Model precedence: an explicit rewrite (from BBR's rewrite plugin,
        # else the upstream rewrite header) beats the chain-extracted
        # model header, which beats the raw BODY model (proposal 1816
        # rewrite > 1964 extraction). The body fallback matters when no
        # BBR chain runs (demo/storm deployments): without it the pick
        # request carried model="" — LoRA-affinity scheduling went blind
        # to adapter identity and the flight-recorder records (the
        # TraceReplay/trainer substrate) recorded no model at all. Both
        # lanes read the same value: the zero-parse scan when it is
        # valid, else the shared parse (scan/parse model equality is
        # pinned by tests/test_fieldscan.py).
        rewrite = ctx.headers.get(metadata.MODEL_NAME_REWRITE_KEY)
        body_model = ""
        if scan is not None and scan.valid and isinstance(scan.model, str):
            body_model = scan.model
        elif parsed:
            pm = parsed.get("model")
            if isinstance(pm, str):
                body_model = pm
        model = (
            bbr_headers.get(metadata.MODEL_NAME_REWRITE_KEY)
            or (rewrite[0] if rewrite else "")
            or bbr_headers.get(metadata.MODEL_NAME_HEADER)
            or body_model
        )
        result = self.picker.pick(
            PickRequest(
                headers=ctx.headers,
                body=bbr_body if bbr_body is not None else body,
                model=model,
                decode_tokens=_decode_tokens(ctx.headers, parsed, scan),
                deadline_at=ctx.deadline_at,
                trace=ctx.trace,
                subset=ctx.subset,
            ),
            ctx.candidates,
        )
        if result.extra_headers:
            result.extra_headers = {**bbr_headers, **result.extra_headers}
        elif bbr_headers:
            # bbr_headers is a fresh per-request dict (chain.execute /
            # execute_scanned build it); handing it over avoids a copy.
            result.extra_headers = bbr_headers
        if result.mutated_body is None and bbr_body is not None:
            result.mutated_body = bbr_body

        # http-in -> gRPC-out (proposal 2162): JSON clients talking to an
        # h2c/gRPC pool get their (possibly BBR-mutated) completion body
        # reframed as a gRPC GenerateRequest. gRPC-in clients pass through.
        if will_transcode:
            source = result.mutated_body if result.mutated_body is not None else body
            # At-most-once parse: hand the codec the dict this request
            # already paid for — valid only when `source` IS the bytes
            # that dict came from (the raw body, or the chain's final
            # mutation; a picker-supplied mutated_body is neither).
            framed, stream_requested, model_name = codec.json_to_generate_request(
                source,
                parsed=parsed if (source is body or source is bbr_body) else None,
            )
            if framed is not None:
                ctx.stream_requested = stream_requested
                ctx.transcoding = True
                ctx.model = model_name
                result.mutated_body = framed
                result.extra_headers = {
                    **result.extra_headers,
                    "content-type": codec.GRPC_CONTENT_TYPE,
                    "te": "trailers",
                }
        ctx.target_endpoint = result.destination_value
        ctx.selected_pod_ip = result.endpoint.rsplit(":", 1)[0]
        ctx.picked_at = self._clock.now()
        ctx.pick_result = result
        return result

    def _response_set_headers(self, ctx: RequestContext) -> dict[str, str]:
        """The headers-response mutation values — one construction for
        the message lanes (_headers_response) and the wire lane's byte
        builder, so a drift can only be a serialization bug, never a
        content bug."""
        set_headers = {
            metadata.DESTINATION_ENDPOINT_KEY: ctx.target_endpoint,
            # Conformance affordance: ask the echo backend to reflect the
            # served endpoint (reference server.go:162-166, Appendix B).
            "X-Echo-Set-Header": (
                metadata.CONFORMANCE_TEST_RESULT_HEADER + ":" + ctx.target_endpoint
            ),
        }
        extra = ctx.pick_result
        if extra is not None and extra.extra_headers:
            set_headers.update(extra.extra_headers)
        if ctx.deadline_at:
            # Surface the remaining budget so downstream hops (the model
            # server, a nested gateway) can inherit it.
            rem_ms = max(
                deadline_mod.remaining_s(
                    ctx.deadline_at, now=self._clock.now()), 0.0) * 1000.0
            set_headers[deadline_mod.REMAINING_HEADER] = str(int(rem_ms))
        return set_headers

    def _headers_response(self, ctx: RequestContext) -> pb.ProcessingResponse:
        """Destination via BOTH header and envoy.lb dynamic metadata
        (004 README:46-82; reference server.go:148-190). Fast lane: the
        response skeleton comes from the pre-serialized template pool and
        only the endpoint-bearing values are patched — byte-identical to
        the built-from-scratch legacy path (pinned by
        tests/test_extproc_fastlane.py)."""
        set_headers = self._response_set_headers(ctx)
        if self.fast_lane:
            return self._headers_templates.build(
                set_headers, ctx.target_endpoint
            )
        return pb.ProcessingResponse(
            request_headers=pb.HeadersResponse(
                response=pb.CommonResponse(
                    clear_route_cache=True,
                    header_mutation=envoy.generate_headers_mutation(set_headers),
                )
            ),
            dynamic_metadata=envoy.make_dynamic_metadata(
                metadata.DESTINATION_ENDPOINT_NAMESPACE,
                {metadata.DESTINATION_ENDPOINT_KEY: ctx.target_endpoint},
            ),
        )

    # ------------------------------------------------------------------ #
    # Wire lane (docs/EXTPROC.md): raw frame bytes in, raw response bytes
    # out — zero ProcessingRequest objects on the classified paths.

    def wire_session(self) -> "WireSession":
        """One per Process stream, created by the wire service handler
        (service.py). Requires the fast lane: the wire path IS the fast
        lane minus the protobuf, and shares its template/scan machinery."""
        if not self.fast_lane:
            raise ValueError("wire lane requires fast_lane=True")
        return WireSession(self)

    def _wire_dispatch(
        self, ctx: RequestContext, data: bytes, state: _StreamState,
        out: list
    ) -> None:
        """One raw frame through admission. Classified header/body frames
        never materialize; FALLBACK/INVALID verdicts funnel through
        wire.materialize into the shared _dispatch — for INVALID bytes
        FromString raises there, failing the stream exactly where the
        legacy request_deserializer would have."""
        verdict, off, length = wire.walk(data)
        if verdict < 0:
            self._dispatch(ctx, wire.materialize(data), state,
                           lambda resp: out.append(resp.SerializeToString()))
            return
        kind = verdict & 0x07
        if kind == wire.KIND_NONE:
            return  # no oneof arm set: the handler ignores the frame
        eos = bool(verdict & wire.EOS_BIT)
        payload = data[off:off + length] if verdict & wire.PAYLOAD_BIT else b""
        if kind == wire.KIND_REQUEST_HEADERS:
            admission_t0 = time.perf_counter()
            self._wire_request_headers(ctx, payload)
            if eos:
                try:
                    self._pick(ctx, None)
                except (ShedError, DeadlineExceeded) as e:
                    ctx.trace_outcome = (
                        "deadline" if isinstance(e, DeadlineExceeded)
                        else "shed")
                    out.append(_SHED_503_BYTES
                               if isinstance(e, DeadlineExceeded)
                               else _SHED_429_BYTES)
                    state.done = True
                    return
                out.append(wirecodec.headers_response_bytes(
                    self._response_set_headers(ctx), ctx.target_endpoint))
                _observe_admission(ctx, admission_t0)
            else:
                state.headers_deferred = True
        elif kind == wire.KIND_REQUEST_BODY:
            if len(state.body) + len(payload) > MAX_REQUEST_BODY_SIZE:
                raise ExtProcError(
                    RESOURCE_EXHAUSTED,
                    f"request body size limit of {MAX_REQUEST_BODY_SIZE} "
                    "bytes exceeded",
                )
            state.body.extend(payload)
            if eos:
                admission_t0 = time.perf_counter()
                try:
                    result = self._pick(ctx, bytes(state.body))
                except (ShedError, DeadlineExceeded) as e:
                    ctx.trace_outcome = (
                        "deadline" if isinstance(e, DeadlineExceeded)
                        else "shed")
                    out.append(_SHED_503_BYTES
                               if isinstance(e, DeadlineExceeded)
                               else _SHED_429_BYTES)
                    state.done = True
                    return
                if state.headers_deferred:
                    out.append(wirecodec.headers_response_bytes(
                        self._response_set_headers(ctx),
                        ctx.target_endpoint))
                    state.headers_deferred = False
                if result.mutated_body is not None:
                    for resp in envoy.build_chunked_body_responses(
                        result.mutated_body, request_path=True
                    ):
                        out.append(resp.SerializeToString())
                else:
                    out.append(_PASSTHROUGH_REQUEST_BODY_BYTES)
                _observe_admission(ctx, admission_t0)
            # Intermediate chunks need no reply in buffered-partial mode.
        elif kind == wire.KIND_RESPONSE_BODY and not ctx.transcoding:
            now = self._clock.now()
            if payload:
                if ctx.resp_first_at == 0.0:
                    ctx.resp_first_at = now
                ctx.resp_last_at = now
            self._count_plain_tokens(ctx, payload)
            out.append(_PASSTHROUGH_RESPONSE_BODY_BYTES)
            if eos:
                self._finish_token_count(ctx)
                if self.on_response_complete is not None:
                    self.on_response_complete(ctx)
        else:
            # response_headers (the :status harvest + served-endpoint
            # echo, once per stream — and the real Envoy frame carries
            # metadata_context, FALLBACKing above anyway) and transcoded
            # response bodies (codec work on message objects) take the
            # materialized choreography.
            self._dispatch(ctx, wire.materialize(data), state,
                           lambda resp: out.append(resp.SerializeToString()))

    def _wire_request_headers(self, ctx: RequestContext, hmap: bytes) -> None:
        """_handle_request_headers for a classified frame: the needed-keys
        scan runs directly on the frame's HeaderMap slice — the legacy
        fast lane re-serializes the materialized map per request just to
        feed the same scanner. No metadata subset arm: frames carrying
        metadata_context never classify (FALLBACK)."""
        out = ctx.headers
        pairs = (
            fieldscan.scan_headers(hmap, self._header_spec)
            if fieldscan.headers_available()
            else None
        )
        if pairs is None:
            # No native library (or >cap matches): a pure-Python walk of
            # the same wire bytes — still zero protobuf objects.
            pairs = wire.scan_header_map_py(hmap, self._needed_headers)
        for key, value in pairs:
            bucket = out.get(key)
            if bucket is None:
                out[key] = [value]
            else:
                bucket.append(value)

        if obs.ENABLED:
            tracer = obs.TRACER
            if tracer is not None:
                ctx.trace = tracer.begin(ctx.headers)

        if (deadline_mod.GATEWAY_DEADLINE_HEADER in ctx.headers
                or deadline_mod.ENVOY_TIMEOUT_HEADER in ctx.headers):
            ctx.deadline_at = deadline_mod.deadline_from_headers(
                ctx.headers, now=self._clock.now())

        vals = ctx.headers.get(metadata.TEST_ENDPOINT_SELECTION_HEADER)
        self._resolve_candidates(ctx, vals[0] if vals else None, [], False)

    # ------------------------------------------------------------------ #

    @staticmethod
    def _replace_body(body: bytes) -> pb.ProcessingResponse:
        return pb.ProcessingResponse(
            response_body=pb.BodyResponse(
                response=pb.CommonResponse(
                    status=pb.CommonResponse.CONTINUE_AND_REPLACE,
                    body_mutation=pb.BodyMutation(body=body),
                )
            )
        )

    def _transcode_failure(self, ctx: RequestContext, message: str) -> pb.ProcessingResponse:
        """Mid-stream transcode failure: the client already saw rewritten
        response headers (JSON/SSE content-type), so emit a clean error in
        the promised format and blank every further chunk — never mix raw
        gRPC bytes into a half-transcoded response."""
        ctx.transcode_failed = True
        if ctx.stream_requested:
            return self._replace_body(codec.error_sse(message))
        return self._replace_body(codec.error_json(message))

    def _transcode_response_body(
        self, ctx: RequestContext, body_msg: pb.HttpBody
    ) -> pb.ProcessingResponse:
        """gRPC-out response stream -> SSE (streaming) or JSON (buffered)
        for the HTTP/JSON client (proposal 2162 response path)."""
        if ctx.transcode_failed:
            return self._replace_body(b"")
        if ctx.frame_decoder is None:
            ctx.frame_decoder = codec.FrameDecoder()
        # Memory bound: what we HOLD (decoder buffer + buffered frames), not
        # cumulative stream volume — long SSE streams drain continuously and
        # must not be killed for total size.
        held = ctx.frame_decoder.buffered_bytes() + ctx.held_bytes
        if held + len(body_msg.body) > MAX_REQUEST_BODY_SIZE:
            return self._transcode_failure(
                ctx, "upstream response exceeds the transcoding buffer limit"
            )
        try:
            messages = ctx.frame_decoder.feed(body_msg.body)
            if messages:
                # TPOT harvest: one Generate frame ~ one token group; the
                # final frame's completion_tokens overrides at stream end.
                ctx.resp_tokens += len(messages)
                ctx.last_frame = messages[-1]
            if ctx.stream_requested:
                out = b"".join(
                    codec.generate_response_to_sse(m, ctx.model) for m in messages
                )
                if body_msg.end_of_stream and ctx.frame_decoder.has_partial():
                    return self._transcode_failure(
                        ctx, "upstream response truncated mid-frame"
                    )
                return self._replace_body(out)
            ctx.response_frames.extend(messages)
            ctx.held_bytes += sum(len(m) for m in messages)
            if not body_msg.end_of_stream:
                return self._replace_body(b"")
            if ctx.frame_decoder.has_partial():
                return self._transcode_failure(
                    ctx, "upstream response truncated mid-frame"
                )
            return self._replace_body(
                codec.generate_payloads_to_json(ctx.response_frames, ctx.model)
            )
        except (codec.FrameFormatError, _DecodeError) as e:
            # The payload is not the Generate protocol we can decode; EPP
            # programming errors are NOT masked here — they propagate.
            return self._transcode_failure(
                ctx, f"upstream response not decodable: {type(e).__name__}"
            )

    # Matches the OpenAI usage block's completion-token count in a JSON
    # response (or an SSE stream's final usage frame).
    _USAGE_RE = re.compile(rb'"completion_tokens"\s*:\s*(\d+)')
    # SSE field lines start a line (WHATWG EventSource §9.2.5): a `data:`
    # anywhere else is payload content, not a frame. The alternation keeps
    # CRLF/CR/LF terminators each to one match.
    _SSE_FRAME_RE = re.compile(rb"(?:\r\n|\r|\n)data:")
    # [ \t]*, NOT \s*: \s matches newlines, which would let an empty data
    # frame followed by a bare "[DONE]" payload line fire the decrement.
    _SSE_DONE_RE = re.compile(rb"(?:\r\n|\r|\n)data:[ \t]*\[DONE\]")

    def _count_plain_tokens(self, ctx: RequestContext, data: bytes) -> None:
        """Token-count harvest on the NON-transcoded response path:
        line-anchored SSE `data:` frames approximate one token-group each
        (a completion whose *text* contains "data:" must not inflate the
        count); the carry keeps enough tail bytes that a frame marker
        split across chunk boundaries still counts exactly once. A
        rolling tail is kept so a final usage block — the authoritative
        count — can override in _finish_token_count."""
        if not data:
            return
        carry = ctx.sse_carry
        buf = carry + data
        # Matches ENDING in this chunk only: any match wholly inside the
        # carry was counted when its own chunk arrived (the carry spans
        # the longest marker, `\r\ndata:`, so boundary splits land here).
        ctx.resp_tokens += (
            len(self._SSE_FRAME_RE.findall(buf))
            - len(self._SSE_FRAME_RE.findall(carry))
        )
        ctx.sse_carry = buf[-7:]
        tail = ctx.resp_tail + data
        if len(tail) > 4096:
            ctx.resp_tail_truncated = True
        ctx.resp_tail = tail[-4096:]

    def _finish_token_count(self, ctx: RequestContext) -> None:
        """End of response stream: prefer authoritative counts. Transcoded
        streams read completion_tokens from the final Generate frame;
        plain streams fall back to the usage block in the tail; the SSE
        frame count (minus the [DONE] sentinel) remains the floor. The
        sentinel check is line-anchored too — "data: [DONE]" inside a
        completion's text must not trigger the decrement. resp_tail
        accumulates raw bytes across chunks, so a [DONE] frame split by
        chunking is contiguous here; the startswith arm covers a stream
        that begins with the sentinel (only trustworthy while the tail
        was never truncated, i.e. it still IS the whole body —
        resp_tail_truncated tracks that explicitly)."""
        if ctx.resp_tokens and (
            self._SSE_DONE_RE.search(ctx.resp_tail)
            or (not ctx.resp_tail_truncated
                and self._SSE_DONE_RE.match(b"\n" + ctx.resp_tail))
        ):
            ctx.resp_tokens -= 1
        # Timing provenance BEFORE any authoritative-count override: the
        # transcoded path's chunks are upstream Generate frames (real
        # generation cadence, streamed or buffered mode alike); the plain
        # path's timing only means generation when the body actually was
        # an SSE stream (>=2 data frames).
        ctx.timing_is_generation = (
            ctx.transcoding or ctx.resp_tokens >= 2
        )
        if ctx.transcoding and ctx.last_frame is not None:
            from gie_tpu_torch.extproc.pb import generate_pb2

            try:
                last = generate_pb2.GenerateResponse.FromString(
                    ctx.last_frame)
                if last.completion_tokens > 0:
                    ctx.resp_tokens = int(last.completion_tokens)
                    return
            except _DecodeError:
                pass
        m = None
        for m in self._USAGE_RE.finditer(ctx.resp_tail):
            pass  # keep the LAST usage block (cumulative in SSE streams)
        if m is not None:
            ctx.resp_tokens = int(m.group(1))

    def _handle_response_headers(
        self, ctx: RequestContext, req: pb.ProcessingRequest
    ) -> pb.ProcessingResponse:
        """reference handlers/response.go:30-92."""
        md = envoy.extract_metadata_values(req)
        served = ""
        lb = md.get(metadata.DESTINATION_ENDPOINT_NAMESPACE)
        if isinstance(lb, dict):
            v = lb.get(metadata.DESTINATION_ENDPOINT_SERVED_KEY)
            if isinstance(v, str):
                served = v
        ctx.served_hostport = served
        # Data-plane outcome harvest (docs/RESILIENCE.md): the :status
        # pseudo-header is the serve verdict Envoy routes back through
        # the EPP for exactly this purpose (PAPER.md ext-proc protocol).
        # Response headers arrive once per stream — a plain loop, not
        # the needed-keys machinery of the per-request hot path.
        status = 0
        for h in req.response_headers.headers.headers:
            if h.key == ":status":
                raw = h.raw_value
                try:
                    status = int(raw.decode() if raw else h.value)
                except (TypeError, ValueError):
                    status = 0
                break
        if faults.ENABLED:
            # Chaos seams for the data-plane loop, keyed by the serving
            # endpoint so `keys=` can storm one pod: endpoint.reset
            # simulates an upstream reset BEFORE response headers (skip
            # the harvest + on_served; the stream-teardown abort path
            # then releases the charge and records the reset);
            # endpoint.serve_5xx rewrites the observed verdict to 503.
            hp = served or (
                ctx.pick_result.endpoint if ctx.pick_result else "")
            if faults.fire("endpoint.reset", key=hp).kind in (
                    faults.ERROR, faults.CORRUPT):
                ctx.served_hostport = ""  # a reset stream trains nothing
                ctx.aborted = True        # teardown records the reset
                return pb.ProcessingResponse(
                    response_headers=pb.HeadersResponse(
                        response=pb.CommonResponse()))
            if faults.fire("endpoint.serve_5xx", key=hp).kind in (
                    faults.ERROR, faults.CORRUPT):
                status = 503
        ctx.resp_status = status
        ctx.resp_headers_seen = True
        if ctx.trace is not None:
            ctx.trace.event("response_headers")
        report = served
        if not report and ctx.pick_result is not None:
            # Envoy local reply (upstream connect refused/timed out, or a
            # filter-generated 5xx): response headers arrive with NO
            # served-endpoint metadata because no upstream ever served.
            # Attribute the verdict to the attempted primary — the Envoy
            # outlier-detection attribution rule — otherwise the exact
            # connect-refused pods this loop exists to catch would stay
            # invisible to the breaker and their assumed-load charges
            # would leak (resp_headers_seen suppresses the abort path).
            report = ctx.pick_result.endpoint
            ctx.served_hostport = report
        if report and self.on_served is not None:
            self.on_served(report, ctx)
        set_headers = {metadata.WENT_INTO_RESP_HEADERS: "true"}
        if served:
            set_headers[metadata.CONFORMANCE_TEST_RESULT_HEADER] = served
        if ctx.transcoding:
            # The backend answered application/grpc but the client gets
            # SSE/JSON after transcoding — relabel accordingly (2162).
            set_headers["content-type"] = (
                "text/event-stream" if ctx.stream_requested
                else "application/json"
            )
        return pb.ProcessingResponse(
            response_headers=pb.HeadersResponse(
                response=pb.CommonResponse(
                    header_mutation=envoy.generate_headers_mutation(set_headers)
                )
            )
        )


class WireSession:
    """One ext-proc stream on the wire lane: raw frame bytes in via
    :meth:`feed`, raw serialized responses out, with the same lifecycle
    accounting as the legacy ``process(stream)`` path — STREAMS gauge,
    context pool, abort teardown, trace closure — replicated step for
    step (the wire service handler has no recv loop to wrap).

    The generator handler in service.py drives it inline on the gRPC
    thread (no per-stream worker thread: a thread spawn costs more than
    the whole classified admission), so feed() runs strictly
    sequentially per session and needs no locking.
    """

    __slots__ = ("_server", "_ctx", "_state", "_closed")

    def __init__(self, server: StreamingServer):
        self._server = server
        own_metrics.STREAMS.inc()
        self._ctx = _acquire_ctx()
        self._state = _StreamState()
        self._closed = False

    @property
    def done(self) -> bool:
        """True after a shed/deadline ImmediateResponse: the legacy loop
        returns there, so the wire handler must also end the stream."""
        return self._state.done

    def feed(self, data: bytes) -> list:
        """Process one raw ProcessingRequest frame; returns the raw
        serialized responses to send (possibly empty). Raises
        ExtProcError / DecodeError for stream-fatal conditions — the
        caller routes them through close(error)."""
        out: list = []
        self._server._wire_dispatch(self._ctx, data, self._state, out)
        return out

    def close(self, error: Exception = None) -> None:
        """Stream teardown, every exit path — mirrors _process's
        except/finally ladder: StreamAborted marks an abnormal end
        quietly, ExtProcError/internal errors also stamp the trace
        outcome, and the finally-side accounting (abort hook, trace
        closure, context-pool return, STREAMS dec) always runs."""
        if self._closed:
            return
        self._closed = True
        ctx = self._ctx
        srv = self._server
        if error is not None:
            ctx.aborted = True
            if not isinstance(error, StreamAborted) and not ctx.trace_outcome:
                if isinstance(error, ExtProcError):
                    ctx.trace_outcome = (
                        "unavailable"
                        if error.code == UNAVAILABLE
                        else "error")
                else:
                    ctx.trace_outcome = "error"
        try:
            srv._finish_stream(ctx)
            if ctx.trace is not None:
                srv._finish_trace(ctx)
        finally:
            _CTX_POOL.append(ctx)
            own_metrics.STREAMS.dec()
