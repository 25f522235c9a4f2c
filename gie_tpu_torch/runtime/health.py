"""gRPC health service (grpc.health.v1) with pool-sync-gated readiness
(copy of gie_tpu/runtime/health.py).

Mirror of reference runserver.go:117-123,132-157: the ext-proc server
exposes health BOTH colocated (on the ext-proc port, under the ext-proc
service name) and on a dedicated health port whose readiness flips to
SERVING only once the datastore has synced the InferencePool (100 ms poll),
per the protocol's liveness/readiness semantics (004 README:103-137).
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import grpc

from gie_tpu_torch.extproc.pb import health_pb2
from gie_tpu_torch.extproc.service import SERVICE_NAME as EXTPROC_SERVICE

HEALTH_SERVICE = "grpc.health.v1.Health"

# Named sub-services per the endpoint-picker protocol (004 README:103-137):
# liveness = process alive (no datastore/leader dependency); readiness and
# the ext-proc service name = synced AND leading. "replication" (when a
# replication manager is wired) = this replica is a warm takeover target:
# leading, or synced within the staleness bound (docs/REPLICATION.md) —
# the probe a rollout controller asks before trusting a standby.
# "resilience" (when the resilience layer is wired) = the pick path is on
# the FULL ladder rung with no open circuit breakers; NOT_SERVING means
# degraded-but-serving (docs/RESILIENCE.md) — an alerting signal, never a
# traffic gate (readiness stays SERVING on purpose while degraded).
LIVENESS_SERVICE = "liveness"
READINESS_SERVICE = "readiness"
REPLICATION_SERVICE = "replication"
RESILIENCE_SERVICE = "resilience"

SERVING = health_pb2.HealthCheckResponse.SERVING
NOT_SERVING = health_pb2.HealthCheckResponse.NOT_SERVING


class HealthService:
    """Check/Watch backed by a ready-predicate per service name."""

    def __init__(
        self,
        ready_fn: Callable[[], bool],
        replication_fn: Callable[[], bool] | None = None,
        resilience_fn: Callable[[], bool] | None = None,
    ):
        self.ready_fn = ready_fn
        self.replication_fn = replication_fn
        self.resilience_fn = resilience_fn

    def _status(self, service: str) -> int:
        if service == LIVENESS_SERVICE:
            return SERVING  # answering at all == alive
        if service == REPLICATION_SERVICE:
            if self.replication_fn is None:
                return health_pb2.HealthCheckResponse.SERVICE_UNKNOWN
            return SERVING if self.replication_fn() else NOT_SERVING
        if service == RESILIENCE_SERVICE:
            if self.resilience_fn is None:
                return health_pb2.HealthCheckResponse.SERVICE_UNKNOWN
            return SERVING if self.resilience_fn() else NOT_SERVING
        known = ("", READINESS_SERVICE, EXTPROC_SERVICE, HEALTH_SERVICE)
        if service not in known:
            return health_pb2.HealthCheckResponse.SERVICE_UNKNOWN
        return SERVING if self.ready_fn() else NOT_SERVING

    def check(self, request, context):
        return health_pb2.HealthCheckResponse(status=self._status(request.service))

    def watch(self, request, context):
        # Poll-based watch (reference HealthServerRunnable polls at 100 ms,
        # runserver.go:147-149); emits on every state change.
        last = None
        while context.is_active():
            status = self._status(request.service)
            if status != last:
                last = status
                yield health_pb2.HealthCheckResponse(status=status)
            time.sleep(0.1)

    def add_to_server(self, server: grpc.Server) -> None:
        handlers = {
            "Check": grpc.unary_unary_rpc_method_handler(
                self.check,
                request_deserializer=health_pb2.HealthCheckRequest.FromString,
                response_serializer=health_pb2.HealthCheckResponse.SerializeToString,
            ),
            "Watch": grpc.unary_stream_rpc_method_handler(
                self.watch,
                request_deserializer=health_pb2.HealthCheckRequest.FromString,
                response_serializer=health_pb2.HealthCheckResponse.SerializeToString,
            ),
        }
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(HEALTH_SERVICE, handlers),)
        )


def start_dedicated_health_server(
    ready_fn: Callable[[], bool],
    port: int,
    replication_fn: Callable[[], bool] | None = None,
    resilience_fn: Callable[[], bool] | None = None,
) -> tuple[grpc.Server, int]:
    """The dedicated health listener, started BEFORE the manager/cache sync
    so probes get NOT_SERVING instead of connection refused (reference
    cmd/lwepp/main.go:104-109)."""
    from concurrent import futures

    # Watch handlers hold a worker for their stream's lifetime; size the
    # pool so long-lived watchers cannot starve Check probes.
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=10))
    HealthService(ready_fn, replication_fn, resilience_fn).add_to_server(
        server)
    bound = server.add_insecure_port(f"0.0.0.0:{port}")
    if bound == 0:
        raise OSError(f"failed to bind health port {port}")
    server.start()
    return server, bound
