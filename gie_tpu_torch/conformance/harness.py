"""ConformanceEnv: in-process cluster + inference-gateway data plane
(copy of conformance/harness.py over gie_tpu_torch).

Plays the role the real cluster + Envoy/Istio play for the reference suite
(reference conformance/conformance.go:194-224 SetupConformanceTestSuite +
the echo-backend fixtures of resources/base.yaml):

  control plane — FakeCluster objects (InferencePool, Pods) + Gateways,
      HTTPRoutes, Services; a gateway status controller maintaining the
      per-parent conditions the tests assert (Accepted / ResolvedRefs /
      EndpointPickerRefMissing / BackendNotFound semantics).
  EPP — one REAL EPP stack per pool (Datastore + reconcilers + scheduler +
      StreamingServer), with a replica count so tests can scale it to zero
      (MakeServiceUnavailable, reference helpers.go:361-409).
  data plane — send(): route matching (host + path prefix), weighted
      backendRef selection, the full ext-proc exchange against the pool's
      EPP (request headers/body -> destination header; response phase ->
      served-endpoint echo), fail-open/fail-close per EndpointPickerRef.
      failureMode, and echo-backend identity responses
      (X-Echo-Set-Header reflection, reference Appendix B).

The "tpu" EPP's Scheduler runs on `device` (None: the CUDA card, as every
port entry point) with `profile` (None: the reference harness's
Scheduler() defaults) and an optional Gumbel `noise_source`, so a run on
the card can be replayed on the CPU. The meshed EPP ("tpu-mesh") runs
the same Scheduler dp-sharded over every available position of that
device (parallel/mesh.py: the cards, or the CPU's virtual positions).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

from google.protobuf import struct_pb2

from gie_tpu_torch.api import types as api
from gie_tpu_torch.api.gateway import (
    ROUTE_ACCEPTED,
    ROUTE_REASON_ACCEPTED,
    ROUTE_REASON_BACKEND_NOT_FOUND,
    ROUTE_RESOLVED_REFS,
    Gateway,
    HTTPRoute,
    Service,
)
from gie_tpu_torch.controller import FakeCluster, InferencePoolReconciler, PodReconciler
from gie_tpu_torch.controller.reconcilers import wire
from gie_tpu_torch.controller.status import (
    desired_parent_statuses,
    merge_parent_statuses,
)
from gie_tpu_torch.datastore import Datastore, Pod
from gie_tpu_torch.extproc import metadata as mdkeys, pb
from gie_tpu_torch.extproc.envoy import get_header_value
from gie_tpu_torch.extproc.server import (
    UNAVAILABLE,
    ExtProcError,
    RoundRobinPicker,
    StreamingServer,
)
from gie_tpu_torch.utils.kubemeta import GKNN

GATEWAY_CONTROLLER_NAME = "gie-tpu.inference.networking.k8s.io/gateway"


@dataclasses.dataclass
class Response:
    status: int
    headers: dict[str, str]
    body: bytes = b""
    backend_pod: str = ""       # which echo pod served
    protocol: str = "http"      # appProtocol used for the backend hop
    # What the backend actually received after EPP mutations (gRPC
    # transcoding etc.): body bytes + forwarded content-type.
    backend_received: bytes = b""
    backend_content_type: str = ""


class _FakeStream:
    def __init__(self, messages):
        self.messages = list(messages)
        self.sent = []

    def recv(self):
        return self.messages.pop(0) if self.messages else None

    def send(self, resp):
        self.sent.append(resp)


class EppInstance:
    """One EPP per pool: the real server components, plus a replica count so
    the suite can take it down (EppUnAvailableFailOpen).

    picker_mode: "rr" (the lwepp-parity round-robin), "tpu" (the full
    batched scheduler through BatchingTPUPicker — proving conformance holds
    for the real scheduling path, not just the trivial picker), or
    "tpu-mesh" (the same scheduler dp-sharded over every available device —
    the --mesh-devices production path).
    """

    def __init__(self, env: "ConformanceEnv", pool_ns: str, pool_name: str,
                 picker_mode: str = "rr"):
        self.datastore = Datastore()
        self._closers = []
        if picker_mode in ("tpu", "tpu-mesh"):
            from gie_tpu_torch.metricsio import MetricsStore
            from gie_tpu_torch.sched.batching import BatchingTPUPicker
            from gie_tpu_torch.sched.profile import ProfileConfig, Scheduler

            mesh = None
            if picker_mode == "tpu-mesh":
                # The --mesh-devices production path: dp-shard the cycle
                # over every available position (conformance must hold
                # for the distributed pick path bit-for-bit).
                from gie_tpu_torch.parallel.mesh import make_mesh

                mesh = make_mesh(device=env.device, tp=1)
            picker = BatchingTPUPicker(
                Scheduler(env.profile or ProfileConfig(),
                          device=None if mesh is not None else env.device,
                          noise_source=env.noise_source, mesh=mesh),
                self.datastore, MetricsStore(), max_wait_s=0.002,
            )
            self._closers.append(picker.close)
        elif picker_mode == "rr":
            picker = RoundRobinPicker()
        else:
            raise ValueError(f"unknown picker_mode {picker_mode!r}")
        self.server = StreamingServer(self.datastore, picker)
        self.replicas = 1
        gknn = GKNN(api.GROUP, "InferencePool", pool_ns, pool_name)
        self._pool_rec = InferencePoolReconciler(env.cluster, self.datastore, gknn)
        self._pod_rec = PodReconciler(env.cluster, self.datastore)
        wire(env.cluster, self._pool_rec, self._pod_rec)
        # Initial sync for pre-existing objects.
        self._pool_rec.reconcile(pool_ns, pool_name)
        for pod in env.cluster.list_pods(pool_ns):
            self._pod_rec.reconcile(pod.namespace, pod.name)

    @property
    def available(self) -> bool:
        return self.replicas > 0

    def close(self) -> None:
        for fn in self._closers:
            fn()


class ConformanceEnv:
    def __init__(self, seed: int = 0, picker_mode: str = "rr",
                 name: str = "local", *, device=None, profile=None,
                 noise_source=None):
        self.name = name
        self.picker_mode = picker_mode
        # The "tpu" EPPs' Scheduler arguments (see the module docstring).
        self.device = device
        self.profile = profile
        self.noise_source = noise_source
        self.cluster = FakeCluster()
        self.gateways: dict[str, Gateway] = {}
        self.routes: dict[tuple[str, str], HTTPRoute] = {}
        self.services: dict[tuple[str, str], Service] = {}
        self.epps: dict[tuple[str, str], EppInstance] = {}
        # Multi-cluster surface (proposal 1374): controller-managed imports
        # keyed by (namespace, name), and the router installed by
        # conformance.multicluster.MultiClusterInferenceEnv that carries a
        # request to an exporting cluster (Endpoint or Parent mode).
        self.imports: dict[tuple[str, str], api.InferencePoolImport] = {}
        self.remote_router = None
        self._ip_counter = 0
        self.rng = random.Random(seed)

    # ---- resource application (manifest-equivalents) ---------------------

    def apply_gateway(self, gw: Gateway) -> None:
        self.gateways[gw.name] = gw
        self._reconcile_statuses()

    def apply_service(self, svc: Service) -> None:
        self.services[(svc.namespace, svc.name)] = svc
        self._reconcile_statuses()

    def delete_service(self, namespace: str, name: str) -> None:
        self.services.pop((namespace, name), None)
        self._reconcile_statuses()

    def apply_pool(self, pool: api.InferencePool) -> None:
        self.cluster.apply_pool(pool)
        key = (pool.metadata.namespace, pool.metadata.name)
        if key not in self.epps:
            self.epps[key] = EppInstance(self, *key,
                                         picker_mode=self.picker_mode)
        self._reconcile_statuses()

    def close(self) -> None:
        """Tear down every EPP instance (picker collector threads etc.)."""
        for epp in self.epps.values():
            epp.close()

    def delete_pool(self, namespace: str, name: str) -> None:
        self.cluster.delete_pool(namespace, name)
        epp = self.epps.pop((namespace, name), None)
        if epp is not None:
            epp.close()
        self._reconcile_statuses()

    def set_imports(
        self, imports: dict[tuple[str, str], api.InferencePoolImport]
    ) -> None:
        """Install the controller-managed InferencePoolImport set (CRUD'd by
        the export controller; users never author these,
        reference 1374 README 'Distribution')."""
        self.imports = dict(imports)
        self._reconcile_statuses()

    def apply_route(self, route: HTTPRoute) -> None:
        self.routes[(route.namespace, route.name)] = route
        self._reconcile_statuses()

    def delete_route(self, namespace: str, name: str) -> None:
        self.routes.pop((namespace, name), None)
        self._reconcile_statuses()

    def deploy_model_servers(
        self,
        prefix: str,
        replicas: int,
        labels: dict[str, str],
        namespace: str = "default",
        annotations: Optional[dict[str, str]] = None,
    ) -> list[Pod]:
        """Echo-backend deployment (reference base.yaml model servers ×3)."""
        pods = []
        for i in range(replicas):
            self._ip_counter += 1
            pod = Pod(
                name=f"{prefix}-{i}",
                namespace=namespace,
                labels=dict(labels),
                annotations=dict(annotations or {}),
                ip=f"10.1.{self._ip_counter // 256}.{self._ip_counter % 256}",
            )
            self.cluster.apply_pod(pod)
            pods.append(pod)
        return pods

    def scale_epp(self, namespace: str, pool: str, replicas: int) -> None:
        """MakeServiceUnavailable / restore (reference helpers.go:361-409)."""
        self.epps[(namespace, pool)].replicas = replicas

    def get_pool(self, namespace: str, name: str) -> Optional[api.InferencePool]:
        return self.cluster.get_pool(namespace, name)

    # ---- status controller ----------------------------------------------

    def _reconcile_statuses(self) -> None:
        """Maintain pool + route per-parent conditions (the gateway
        implementation's bookkeeping the conformance tests assert)."""
        # Route conditions first (and collect pool parents on the way).
        pool_parents: dict[tuple[str, str], set[str]] = {}
        import_parents: dict[tuple[str, str], set[str]] = {}
        for route in self.routes.values():
            for gw_name in route.parent_gateways:
                ps = route.parent_status(gw_name)
                if gw_name not in self.gateways:
                    ps.set_condition(api.Condition(
                        ROUTE_ACCEPTED, "False", "NoMatchingParent",
                        "gateway not found"))
                    continue
                ps.set_condition(api.Condition(
                    ROUTE_ACCEPTED, "True", ROUTE_REASON_ACCEPTED, "accepted"))
                unresolved = []
                for rule in route.rules:
                    for ref in rule.backend_refs:
                        key = (route.namespace, ref.name)
                        if ref.kind == "InferencePoolImport":
                            # Resolvable iff the export controller has
                            # materialized the import locally (1374 README
                            # 'Importing Controller').
                            if key not in self.imports:
                                unresolved.append(
                                    f"InferencePoolImport {ref.name}")
                            else:
                                import_parents.setdefault(key, set()).add(
                                    gw_name)
                            continue
                        if ref.kind != "InferencePool":
                            continue
                        if self.cluster.get_pool(*key) is None:
                            unresolved.append(f"InferencePool {ref.name}")
                        else:
                            pool_parents.setdefault(key, set()).add(gw_name)
                if unresolved:
                    ps.set_condition(api.Condition(
                        ROUTE_RESOLVED_REFS, "False",
                        ROUTE_REASON_BACKEND_NOT_FOUND,
                        f"backendRefs not found: {unresolved}"))
                else:
                    ps.set_condition(api.Condition(
                        ROUTE_RESOLVED_REFS, "True", "ResolvedRefs", "ok"))

        # Import controllers[].parents maintenance (1374 README 'Import
        # Controller': add an entry per managed parent, remove it when the
        # import is no longer referenced by a managed HTTPRoute).
        for key, imp in self.imports.items():
            gws = sorted(import_parents.get(key, ()))
            others = [c for c in imp.status.controllers
                      if c.name != GATEWAY_CONTROLLER_NAME]
            if gws:
                entry = api.ImportController(name=GATEWAY_CONTROLLER_NAME)
                for gw_name in gws:
                    ps = api.ParentStatus(parentRef=api.ParentReference(
                        name=gw_name, group="gateway.networking.k8s.io",
                        kind="Gateway"))
                    ps.set_condition(api.Condition(
                        api.COND_ACCEPTED, "True", api.REASON_ACCEPTED,
                        "referenced by managed HTTPRoute"))
                    entry.parents.append(ps)
                imp.status.controllers = others + [entry]
            else:
                imp.status.controllers = others

        # Pool per-parent conditions (reference api conditions, C1) — the
        # SAME computation PoolStatusController publishes to a real
        # apiserver (gie_tpu/controller/status.py).
        for (ns, name), parents in pool_parents.items():
            pool = self.cluster.get_pool(ns, name)
            if pool is None:
                continue
            computed = desired_parent_statuses(
                pool, parents,
                lambda sns, sname: (sns, sname) in self.services)
            pool.status.parents = merge_parent_statuses(
                pool.status.parents, computed)

        # Pools no longer referenced by any route lose their gateway parent
        # status (InferencePoolResolvedRefsCondition clear-on-change
        # semantics); export-controller entries survive.
        for (ns, name), _epp in self.epps.items():
            pool = self.cluster.get_pool(ns, name)
            if pool is not None and (ns, name) not in pool_parents:
                pool.status.parents = [
                    p for p in pool.status.parents
                    if p.parentRef.kind == "InferencePoolImport"
                ]

    # ---- data plane ------------------------------------------------------

    def send(
        self,
        gateway: str,
        host: str,
        path: str,
        headers: Optional[dict[str, str]] = None,
        body: bytes = b"",
        method: str = "GET",
    ) -> Response:
        """One HTTP request through the gateway."""
        headers = dict(headers or {})
        route, rule = self._match_route(gateway, host, path)
        if route is None or rule is None:
            return Response(404, {}, b"no matching route")
        ref = self._pick_backend(rule)
        if ref.kind == "InferencePoolImport":
            # Cross-cluster hop (1374 README 'Data Path'): the installed
            # router carries the request to an exporting cluster in the
            # configured routing mode (Endpoint or Parent).
            imp = self.imports.get((route.namespace, ref.name))
            if imp is None:
                return Response(500, {}, b"backend not found")
            if self.remote_router is None:
                return Response(500, {}, b"no multi-cluster router installed")
            return self.remote_router(self, imp, host, path, headers, body)
        if ref.kind != "InferencePool":
            return Response(500, {}, b"non-pool backends not modeled")
        pool = self.cluster.get_pool(route.namespace, ref.name)
        if pool is None:
            return Response(500, {}, b"backend not found")
        # NOTE: ref.port for InferencePool backends is IGNORED by contract
        # (reference inferencepool_httproute_port_validation.go scenario 3).
        epp = self.epps[(route.namespace, ref.name)]
        return self._forward(pool, epp, headers, body)

    def _match_route(self, gateway, host, path):
        best = (None, None, -1)
        for route in self.routes.values():
            if gateway not in route.parent_gateways:
                continue
            if route.hostnames and host not in route.hostnames:
                continue
            for rule in route.rules:
                p = rule.path_prefix
                if path.startswith(p) and len(p) > best[2]:
                    best = (route, rule, len(p))
        return best[0], best[1]

    def _pick_backend(self, rule):
        total = sum(max(r.weight, 0) for r in rule.backend_refs)
        if total <= 0:
            return rule.backend_refs[0]
        x = self.rng.uniform(0, total)
        acc = 0.0
        for ref in rule.backend_refs:
            acc += max(ref.weight, 0)
            if x <= acc:
                return ref
        return rule.backend_refs[-1]

    def _forward(self, pool, epp: EppInstance, headers, body) -> Response:
        failure_mode = (
            pool.spec.endpointPickerRef.failureMode
            if pool.spec.endpointPickerRef is not None
            else api.FAIL_CLOSE
        )
        has_epp = pool.spec.endpointPickerRef is not None
        ready = epp.datastore.endpoints()

        if not has_epp or not epp.available:
            # EPP-less pool or EPP down: fail-open routes to any ready
            # endpoint, fail-close rejects (004 README failure semantics).
            if not has_epp or failure_mode == api.FAIL_OPEN:
                if not ready:
                    return Response(503, {}, b"no ready endpoints")
                ep = self.rng.choice(ready)
                return self._echo(pool, ep.hostport, {}, body)
            return Response(503, {}, b"EPP unavailable (FailClose)")

        # Real ext-proc exchange against the pool's EPP.
        hm = pb.HeaderMap()
        for k, v in headers.items():
            hm.headers.append(pb.HeaderValue(key=k, raw_value=v.encode()))
        msgs = [pb.ProcessingRequest(
            request_headers=pb.HttpHeaders(headers=hm, end_of_stream=not body))]
        if body:
            msgs.append(pb.ProcessingRequest(
                request_body=pb.HttpBody(body=body, end_of_stream=True)))
        stream = _FakeStream(msgs)
        try:
            epp.server.process(stream)
        except ExtProcError as e:
            if failure_mode == api.FAIL_OPEN and ready:
                ep = self.rng.choice(ready)
                return self._echo(pool, ep.hostport, {}, body)
            status = 503 if e.code == UNAVAILABLE else 500
            return Response(status, {}, e.message.encode())

        if stream.sent and stream.sent[0].WhichOneof("response") == "immediate_response":
            imm = stream.sent[0].immediate_response
            return Response(imm.status.code, {}, imm.body)

        # Extract destination from the headers response; verify the dual
        # dynamic-metadata signal agrees (004 README:46-82).
        hdr_resp = stream.sent[0]
        mutation = hdr_resp.request_headers.response.header_mutation
        set_headers = {
            o.header.key: get_header_value(o.header) for o in mutation.set_headers
        }
        dest = set_headers.get(mdkeys.DESTINATION_ENDPOINT_KEY, "")
        md = hdr_resp.dynamic_metadata
        lb = md.fields.get(mdkeys.DESTINATION_ENDPOINT_NAMESPACE)
        md_dest = (
            lb.struct_value.fields[mdkeys.DESTINATION_ENDPOINT_KEY].string_value
            if lb is not None else ""
        )
        if dest != md_dest:
            return Response(500, {}, b"header/metadata destination mismatch")

        # Walk the ordered fallback list to a live endpoint.
        by_hostport = {e.hostport: e for e in ready}
        chosen = None
        for candidate in [d.strip() for d in dest.split(",") if d.strip()]:
            if candidate in by_hostport:
                chosen = candidate
                break
        if chosen is None:
            return Response(503, {}, b"no live destination")

        # Apply EPP body mutations (BBR rewrites, gRPC transcoding): the
        # data plane forwards the CONTINUE_AND_REPLACE chunks, not the
        # original body (proposal 2162 request path).
        forwarded_body = body
        mutated = [
            sent.request_body.response.body_mutation.body
            for sent in stream.sent
            if sent.WhichOneof("response") == "request_body"
            and sent.request_body.response.status
            == pb.CommonResponse.CONTINUE_AND_REPLACE
        ]
        if mutated:
            forwarded_body = b"".join(mutated)

        # Forward to the echo backend, honoring X-Echo-Set-Header.
        echo_extra = {}
        if "X-Echo-Set-Header" in set_headers:
            k, _, v = set_headers["X-Echo-Set-Header"].partition(":")
            echo_extra[k.strip()] = v.strip()
        resp = self._echo(pool, chosen, echo_extra, forwarded_body)
        resp.backend_content_type = set_headers.get(
            "content-type", headers.get("content-type", ""))

        # Response phase: report the served endpoint back to the EPP
        # (004 README:84-101) and apply its response-header mutation.
        served_req = pb.ProcessingRequest(response_headers=pb.HttpHeaders())
        st = struct_pb2.Struct()
        st.fields[mdkeys.DESTINATION_ENDPOINT_SERVED_KEY].string_value = chosen
        served_req.metadata_context.filter_metadata[
            mdkeys.DESTINATION_ENDPOINT_NAMESPACE].CopyFrom(st)
        s2 = _FakeStream([served_req])
        epp.server.process(s2)
        if s2.sent:
            mut = s2.sent[0].response_headers.response.header_mutation
            for o in mut.set_headers:
                resp.headers[o.header.key] = get_header_value(o.header)
        return resp

    def _echo(self, pool, hostport, extra_headers, body) -> Response:
        """The echo-basic model-server stand-in: identifies its pod
        (reference base.yaml:80,124) and reflects requested headers."""
        ip = hostport.rsplit(":", 1)[0]
        pod = next(
            (p for p in self.cluster.list_pods(pool.metadata.namespace)
             if p.ip == ip),
            None,
        )
        if pod is None:
            return Response(503, {}, b"endpoint pod gone")
        headers = dict(extra_headers)
        headers["x-pod-name"] = pod.name
        return Response(
            200,
            headers,
            b"echo from " + pod.name.encode(),
            backend_pod=pod.name,
            protocol="h2c" if pool.spec.appProtocol == api.APP_PROTOCOL_H2C
            else "http",
            backend_received=body,  # every path records what the pod got
        )


def build_base_env(**env_kwargs) -> ConformanceEnv:
    """The suite's shared base environment (reference
    conformance/resources/base.yaml: two gateways + echo model-server
    deployments x3 + EPP service) — reference conformance.go:149-192
    builds the same fixed base before dispatching tests. `env_kwargs` go
    to ConformanceEnv (picker_mode and the "tpu" EPPs' Scheduler
    arguments)."""
    e = ConformanceEnv(**env_kwargs)
    e.apply_gateway(Gateway("primary-gateway"))
    e.apply_gateway(Gateway("secondary-gateway"))
    e.apply_service(Service("epp-svc"))
    e.deploy_model_servers("primary-model-server", 3, {"app": "primary"})
    e.deploy_model_servers("secondary-model-server", 3, {"app": "secondary"})
    return e
