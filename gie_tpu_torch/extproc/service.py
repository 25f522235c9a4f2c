"""gRPC service registration for the ext-proc StreamingServer (port of
gie_tpu/extproc/service.py).

Registers under Envoy's service name
(`envoy.service.ext_proc.v3.ExternalProcessor`, method `Process`) via grpc
generic handlers — no protoc-gen-grpc plugin needed — so an Envoy configured
for a standard ext-proc cluster reaches us without config changes (reference
runserver.go:115 RegisterExternalProcessorServer).

Two registrations share the wire:

legacy (wire=False): ProcessingRequest.FromString as the request
    deserializer, a per-stream worker thread driving server.process —
    every frame is a materialized protobuf.
wire (wire=True, docs/EXTPROC.md): IDENTITY deserializer/serializer
    (None — grpc passes raw message bytes both ways) and an inline
    generator driving a WireSession on the gRPC thread. Classified
    frames never become ProcessingRequest objects; the walker's
    FALLBACK verdict routes a frame through wire.materialize into the
    same choreography, so responses are byte-identical lane to lane.
    Inline, not thread-per-stream: the protocol is strictly
    request-driven (one request frame -> zero or more response frames),
    and a thread spawn costs more than the whole classified admission.

The port's ExtProcError carries its status by name; ``grpc_status`` here
is the one place the name becomes a grpc.StatusCode, for every abort.
"""

from __future__ import annotations

import queue
import threading

import grpc

from google.protobuf.message import DecodeError as _DecodeError

from gie_tpu_torch.extproc import pb
from gie_tpu_torch.extproc.server import (
    INTERNAL,
    ExtProcError,
    StreamAborted,
    StreamingServer,
)
from gie_tpu_torch.runtime import metrics as own_metrics

SERVICE_NAME = "envoy.service.ext_proc.v3.ExternalProcessor"


def grpc_status(name: str) -> grpc.StatusCode:
    """An ExtProcError's status name -> its grpc.StatusCode (UNKNOWN for a
    name gRPC does not define)."""
    return getattr(grpc.StatusCode, name, grpc.StatusCode.UNKNOWN)


def _process_handler(server: StreamingServer, on_accept=None):
    def process(request_iterator, context: grpc.ServicerContext):
        if on_accept is not None:
            on_accept()
        out: queue.Queue = queue.Queue()
        done = object()

        class _Stream:
            def recv(self):
                try:
                    return next(request_iterator)
                except StopIteration:
                    return None  # clean half-close: not a serve outcome
                except grpc.RpcError:
                    # Envoy tears the ext-proc stream down this way when
                    # the HTTP stream resets/cancels — the data-plane
                    # abort signal (docs/RESILIENCE.md), distinct from a
                    # clean close on a route without response processing.
                    raise StreamAborted()

            def send(self, resp: pb.ProcessingResponse) -> None:
                out.put(resp)

        failure: list[ExtProcError] = []

        def run() -> None:
            try:
                server.process(_Stream())
            except ExtProcError as e:
                failure.append(e)
            except Exception as e:  # stream-fatal internal error
                failure.append(
                    ExtProcError(INTERNAL, f"internal error: {e}")
                )
            finally:
                if failure:
                    # Stream-fatal failures by gRPC code (gie-obs): the
                    # aborts Envoy converts per FailureMode were
                    # previously visible only in Envoy's own stats.
                    own_metrics.STREAM_ERRORS.labels(
                        code=failure[0].code.lower()).inc()
                out.put(done)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        while True:
            item = out.get()
            if item is done:
                break
            yield item
        t.join()
        if failure:
            context.abort(grpc_status(failure[0].code), failure[0].message)

    return process


def _wire_process_handler(server: StreamingServer, on_accept=None):
    def process(request_iterator, context: grpc.ServicerContext):
        if on_accept is not None:
            on_accept()
        session = server.wire_session()
        error = None
        try:
            while True:
                try:
                    data = next(request_iterator)
                except StopIteration:
                    break  # clean half-close: not a serve outcome
                except grpc.RpcError:
                    error = StreamAborted()  # reset/cancel mid-recv
                    break
                try:
                    for resp in session.feed(data):
                        yield resp
                except ExtProcError as e:
                    error = e
                    break
                except _DecodeError as e:
                    # The legacy lane fails these in the request
                    # deserializer before the handler ever runs; the wire
                    # lane meets them at wire.materialize instead and
                    # owes the same stream-fatal outcome.
                    error = ExtProcError(
                        INTERNAL,
                        f"malformed ProcessingRequest: {e}")
                    break
                except Exception as e:  # stream-fatal internal error
                    error = ExtProcError(
                        INTERNAL, f"internal error: {e}")
                    break
                if session.done:
                    break  # ImmediateResponse sent: stream over
        except GeneratorExit:
            # grpc closes the generator at a yield point when the RPC is
            # cancelled mid-send — the same abort recv would have seen.
            session.close(StreamAborted())
            raise
        finally:
            session.close(error)
            if error is not None and not isinstance(error, StreamAborted):
                own_metrics.STREAM_ERRORS.labels(
                    code=error.code.lower()).inc()
        if error is not None and not isinstance(error, StreamAborted):
            context.abort(grpc_status(error.code), error.message)

    return process


def add_extproc_service(
    grpc_server: grpc.Server, server: StreamingServer, *,
    wire: bool = False, on_accept=None,
) -> None:
    """Register Process. ``wire=True`` selects the zero-protobuf lane
    (requires the fast lane); ``on_accept`` is called once per accepted
    stream — the worker pool wires per-worker tallies through it."""
    if wire:
        handler = grpc.stream_stream_rpc_method_handler(
            _wire_process_handler(server, on_accept),
            request_deserializer=None,   # raw frame bytes in
            response_serializer=None,    # raw response bytes out
        )
    else:
        handler = grpc.stream_stream_rpc_method_handler(
            _process_handler(server, on_accept),
            request_deserializer=pb.ProcessingRequest.FromString,
            response_serializer=pb.ProcessingResponse.SerializeToString,
        )
    generic = grpc.method_handlers_generic_handler(
        SERVICE_NAME, {"Process": handler}
    )
    grpc_server.add_generic_rpc_handlers((generic,))
