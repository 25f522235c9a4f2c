"""lwepp-equivalent entrypoint (port of gie_tpu/runtime/main.py; reference
cmd/lwepp/main.go:36-116).

    python -m gie_tpu_torch.runtime.main --pool-name my-pool --demo \
        --no-resilience --no-obs
    python -m gie_tpu_torch.runtime.main --pool-name my-pool --kube \
        --kubeconfig ~/.kube/config --publish-status-parents my-gateway

The scheduler runs on the CUDA card, or over a mesh of cards with
--mesh-devices N.

The ClusterClient seam (controller/cluster.py) is served either by a real
kube-apiserver — with --kube, the stdlib list/watch adapter of
controller/kube.py (in-cluster service account, or --kubeconfig), which
also carries the pool status publication (--publish-status-parents), the
Lease elector and the autoscale actuator's patch — or, with --demo, by an
in-process FakeCluster populated with simulated vLLM pods whose /metrics
endpoints are real HTTP servers backed by VLLMStub dynamics, so the whole
binary is drivable end to end on one machine.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

# Seconds between two pool status publications (--publish-status-parents).
STATUS_INTERVAL_S = 10.0


def _demo_cluster(opts, n_pods: int):
    """FakeCluster + stub fleet with live HTTP /metrics."""
    import http.server

    from gie_tpu_torch.api import types as api
    from gie_tpu_torch.controller import FakeCluster
    from gie_tpu_torch.datastore.objects import Pod
    from gie_tpu_torch.simulator import StubConfig, VLLMStub

    cluster = FakeCluster()
    stubs, servers = [], []
    n_pods = min(n_pods, 8)  # one targetPort per pod, max 8 (API limit)
    for i in range(n_pods):
        stub = VLLMStub(StubConfig(), name=f"demo-pod-{i}")

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self, s=stub):
                body = s.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                # Which pod served — lets a data-plane smoke test (an
                # Envoy routing on x-gateway-destination-endpoint via
                # original_dst, hack/envoy_smoke.sh) assert the EPP's
                # steering was honored end to end.
                self.send_header("X-Served-By",
                                 "%s:%d" % self.server.server_address)
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                # Drain the body so keep-alive connections stay in sync.
                n = int(self.headers.get("Content-Length", 0) or 0)
                if n:
                    self.rfile.read(n)
                self.do_GET()

            def log_message(self, *a):
                pass

        httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        stubs.append(stub)
        servers.append(httpd)

    # Clock driver so stub queues evolve.
    def tick():
        import time

        while True:
            for s in stubs:
                s.step(0.05)
            time.sleep(0.05)

    threading.Thread(target=tick, daemon=True).start()

    # Every stub listens on its own localhost port; the pool lists them all
    # as targetPorts (max 8) and each pod's active-ports annotation narrows
    # to its own stub, exercising the per-pod rank filtering.
    ports = [s.server_address[1] for s in servers]
    cluster.apply_pool(
        api.InferencePool(
            metadata=api.ObjectMeta(
                name=opts.pool_name, namespace=opts.pool_namespace
            ),
            spec=api.InferencePoolSpec(
                selector=api.LabelSelector(matchLabels={"app": "demo"}),
                targetPorts=[api.Port(p) for p in ports],
                endpointPickerRef=api.EndpointPickerRef(
                    name="epp", port=api.Port(opts.grpc_port)
                ),
            ),
        )
    )
    for i, httpd in enumerate(servers):
        cluster.apply_pod(
            Pod(
                name=f"demo-pod-{i}",
                namespace=opts.pool_namespace,
                labels={"app": "demo"},
                ip="127.0.0.1",
                annotations={
                    api.ACTIVE_PORTS_ANNOTATION: str(httpd.server_address[1])
                },
            )
        )
    return cluster


def main(argv=None) -> int:
    from gie_tpu_torch.runtime.logging import get_logger, set_verbosity
    from gie_tpu_torch.runtime.options import Options
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner

    parser = argparse.ArgumentParser(prog="gie-tpu-epp")
    Options.add_flags(parser)
    parser.add_argument(
        "--demo", action="store_true",
        help="run against an in-process simulated cluster",
    )
    parser.add_argument("--demo-pods", type=int, default=4)
    parser.add_argument(
        "--kube", action="store_true",
        help="connect to a real kube-apiserver (in-cluster config, or "
             "--kubeconfig); stdlib HTTP list/watch, no client dependency",
    )
    parser.add_argument("--kubeconfig", default=None)
    parser.add_argument(
        "--publish-status-parents", default=None,
        help="comma-separated Gateway names to publish InferencePool "
             "parent status for (Accepted/ResolvedRefs conditions through "
             "the status subresource); kube mode only",
    )
    args = parser.parse_args(argv)
    opts = Options.from_args(args)
    opts.validate()
    set_verbosity(opts.verbosity)
    log = get_logger("main")

    kube_client = None
    if args.demo:
        cluster = _demo_cluster(opts, args.demo_pods)
    elif args.kube:
        from gie_tpu_torch.controller.kube import KubeClusterClient

        kube_client = KubeClusterClient(
            opts.pool_namespace, opts.pool_name, kubeconfig=args.kubeconfig
        )
        cluster = kube_client
    else:
        log.error(
            "no cluster integration configured; run with --demo (simulated) "
            "or --kube (real apiserver over stdlib HTTP list/watch)"
        )
        return 2

    if opts.autoscale_mode == "apply" and kube_client is None:
        # The demo FakeCluster has no apiserver to patch; the actuator
        # degrades to metrics-only and every apply counts as no_target.
        log.error(
            "--autoscale-mode apply needs --kube (an apiserver to patch "
            "spec.replicas on); running recommend-only against the demo "
            "cluster"
        )

    runner = ExtProcServerRunner(opts, cluster)
    runner.setup()
    if kube_client is not None:
        kube_client.start()  # watches begin after reconcilers subscribe
    runner.start()

    status_stop = None
    if kube_client is not None and args.publish_status_parents:
        # Periodic parent-condition publication (controller/status.py):
        # unchanged cycles skip the patch, so the loop is churn-free.
        from gie_tpu_torch.controller.status import PoolStatusController

        status_ctrl = PoolStatusController(
            kube_client, opts.pool_namespace, opts.pool_name,
            parents=[p.strip()
                     for p in args.publish_status_parents.split(",")
                     if p.strip()],
            service_exists=kube_client.service_exists,
        )
        status_stop = threading.Event()

        def status_loop():
            while not status_stop.wait(STATUS_INTERVAL_S):
                try:
                    status_ctrl.reconcile()
                except Exception as e:  # status must never take us down
                    log.error("pool status publication failed", err=e)

        threading.Thread(target=status_loop, daemon=True).start()

    stop = threading.Event()

    def on_signal(signum, frame):
        log.info("signal received, shutting down", signal=signum)
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    log.info("serving", pool=opts.pool_name)
    stop.wait()
    if status_stop is not None:
        status_stop.set()
    if kube_client is not None:
        kube_client.stop()
    runner.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
