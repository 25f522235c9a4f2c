"""Multi-core ext-proc acceptors (--extproc-workers, docs/EXTPROC.md); a
copy of gie_tpu/extproc/workers.py.

One gRPC server is one completion queue drained under one GIL-bound
poller — at wire-lane admission cost (~tens of microseconds) a single
acceptor caps one EPP pod at roughly one core. The pool runs N
in-process ``grpc.server`` instances, each with its own completion
queue and thread pool, all bound to the SAME port via SO_REUSEPORT
(``grpc.so_reuseport`` — on by default in Linux grpc builds; the pool
sets it explicitly and verifies every worker landed on the first
worker's port). The kernel then spreads incoming CONNECTIONS across
the listening sockets — Envoy maintains a connection pool to the EPP
cluster, so its per-request ext-proc streams fan out worker by worker.

Shared, not per-worker:
  - the StreamingServer (and through it the Datastore's cached
    endpoint-snapshot / pool-generation machinery, the scheduler, the
    picker) — every worker routes against the same world view;
  - the metrics registry — one scrape shows the whole pod, with
    per-worker accept tallies (gie_extproc_worker_accepted_streams_total)
    so a one-worker skew is visible on the scorecard.

Threads, not forked processes: the CUDA runtime, the scraper threads,
and the datastore locks do not survive fork(), and a forked design
would need IPC for every datastore update. In-process workers share
the GIL for Python bookkeeping but do protobuf-free wire-lane work and
all gRPC I/O in C, which is where the scaling headroom lives.

Lifecycle mirrors the single ``grpc.Server`` the runner used
(``bind -> start -> stop(grace).wait() / wait_for_termination``), so
runner.py swaps the implementation without changing its shutdown
choreography. ``stop`` initiates a graceful drain on every worker
concurrently: new RPCs are refused, in-flight ext-proc streams run to
completion within the grace window (pinned by the drain test in
tests/test_extproc_wirelane.py).
"""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Optional

import grpc

from gie_tpu_torch.extproc.service import add_extproc_service
from gie_tpu_torch.runtime import metrics as own_metrics


class _AllStopped:
    """Aggregate of the per-worker stop events: ``wait`` returns True
    once EVERY worker finished draining (the same contract a single
    server's ``stop(grace).wait()`` had)."""

    __slots__ = ("_events",)

    def __init__(self, events):
        self._events = events

    def wait(self, timeout: Optional[float] = None) -> bool:
        ok = True
        for e in self._events:
            ok = bool(e.wait(timeout)) and ok
        return ok


class ExtProcWorkerPool:
    """N SO_REUSEPORT gRPC acceptors over one shared StreamingServer."""

    def __init__(self, streaming, workers: int, *, wire: bool = False,
                 health_factory=None, threads_per_worker: int = 64):
        if workers < 1:
            raise ValueError(f"extproc workers must be >= 1, got {workers}")
        self._streaming = streaming
        self._workers = workers
        self._wire = wire
        # Called with each worker's grpc.server: the runner registers
        # its colocated HealthService here, per acceptor — a health
        # probe must exercise the same socket spread real traffic hits.
        self._health_factory = health_factory
        self._threads = threads_per_worker
        self._servers: list[grpc.Server] = []
        self._port = 0
        # Guards bind/start/stop transitions only — never held on the
        # accept/dispatch path (on_accept touches just its pre-resolved
        # counter child). Ranked in lint/lockorder.toml.
        self._lock = threading.Lock()

    @property
    def port(self) -> int:
        return self._port

    @property
    def workers(self) -> int:
        return self._workers

    def _make_server(self, index: int) -> grpc.Server:
        srv = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=self._threads,
                thread_name_prefix=f"extproc-w{index}",
            ),
            options=(("grpc.so_reuseport", 1),),
        )
        accepts = own_metrics.WORKER_ACCEPTS.labels(worker=str(index))
        add_extproc_service(srv, self._streaming, wire=self._wire,
                            on_accept=accepts.inc)
        if self._health_factory is not None:
            self._health_factory(srv)
        return srv

    def bind(self, addr: str, credentials=None) -> int:
        """Bind every worker to ``addr`` ("host:port"; port 0 lets the
        first worker choose, the rest reuse its choice). Returns the
        bound port; raises OSError when the port cannot be (re)bound —
        a kernel without SO_REUSEPORT fails here, loudly, instead of
        silently serving on one core."""
        with self._lock:
            if self._servers:
                raise RuntimeError("worker pool already bound")
            host, _, _ = addr.rpartition(":")
            first = self._make_server(0)
            port = (first.add_secure_port(addr, credentials)
                    if credentials is not None
                    else first.add_insecure_port(addr))
            if port == 0:
                raise OSError(f"failed to bind ext-proc port {addr}")
            servers = [first]
            shared = f"{host}:{port}"
            for i in range(1, self._workers):
                srv = self._make_server(i)
                p = (srv.add_secure_port(shared, credentials)
                     if credentials is not None
                     else srv.add_insecure_port(shared))
                if p != port:
                    raise OSError(
                        f"worker {i} failed to SO_REUSEPORT-bind {shared} "
                        f"(got port {p})")
                servers.append(srv)
            self._servers = servers
            self._port = port
            return port

    def start(self) -> None:
        with self._lock:
            for srv in self._servers:
                srv.start()

    def stop(self, grace: Optional[float] = None) -> _AllStopped:
        """Initiate graceful drain on ALL workers concurrently (each
        stop() call is non-blocking); the returned handle's wait()
        blocks until every in-flight stream finished or the grace
        window expired everywhere."""
        with self._lock:
            events = [srv.stop(grace) for srv in self._servers]
        return _AllStopped(events)

    def wait_for_termination(self, timeout: Optional[float] = None) -> None:
        with self._lock:
            servers = list(self._servers)
        for srv in servers:
            srv.wait_for_termination(timeout)
