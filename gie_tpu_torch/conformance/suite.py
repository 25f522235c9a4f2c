"""The conformance cases over the port's harness (the cases of
tests/test_conformance.py and the loop of conformance/run.py, over
gie_tpu_torch).

Every Gateway-profile case of the reference suite but the meshed one
(which waits for the multi-device slice), with the reference's checks.
`BASE_CASES` take the shared base environment (build_base_env), the
`OWN_CASES` build their own from ConformanceEnv keyword arguments; each
raises ConformanceFailure naming what did not hold. `run(**env_kwargs)`
runs them all and returns the ConformanceReport with each failure's
traceback, so the same cases run under pytest on the CPU and with the
Scheduler on the card.
"""

from __future__ import annotations

import collections
import json
import traceback

from gie_tpu_torch.api import types as api
from gie_tpu_torch.api.gateway import (
    ROUTE_ACCEPTED,
    ROUTE_REASON_BACKEND_NOT_FOUND,
    ROUTE_RESOLVED_REFS,
    BackendRef,
    Gateway,
    HTTPRoute,
    RouteRule,
    Service,
)
from gie_tpu_torch.conformance.harness import ConformanceEnv, build_base_env
from gie_tpu_torch.conformance.report import ConformanceReport
from gie_tpu_torch.extproc import metadata as mdkeys


class ConformanceFailure(AssertionError):
    """A conformance check that did not hold."""


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise ConformanceFailure(what)


def make_pool(name, selector, ports=(8000,), epp="epp-svc",
              failure_mode=api.FAIL_CLOSE,
              app_protocol=api.APP_PROTOCOL_HTTP, namespace="default"):
    return api.InferencePool(
        metadata=api.ObjectMeta(name=name, namespace=namespace),
        spec=api.InferencePoolSpec(
            selector=api.LabelSelector(matchLabels=selector),
            targetPorts=[api.Port(p) for p in ports],
            appProtocol=app_protocol,
            endpointPickerRef=(
                api.EndpointPickerRef(name=epp, port=api.Port(9002),
                                      failureMode=failure_mode)
                if epp else None),
        ),
    )


def pool_condition(env, ns, name, parent, ctype):
    pool = env.get_pool(ns, name)
    for ps in pool.status.parents:
        if ps.parentRef.name == parent:
            return ps.get_condition(ctype)
    return None


def simple_route(name, gateway, pool, path="/", host=None):
    return HTTPRoute(
        name=name, hostnames=[host] if host else [],
        parent_gateways=[gateway],
        rules=[RouteRule(path_prefix=path,
                         backend_refs=[BackendRef(name=pool)])])


def _primary_pods(env):
    return [p for p in env.cluster.list_pods("default")
            if p.labels.get("app") == "primary"]


# -- status choreography --------------------------------------------------


def inferencepool_accepted(env):
    """reference tests/inferencepool_accepted.go:38."""
    env.apply_pool(make_pool("pool-a", {"app": "primary"}))
    env.apply_route(simple_route("route-a", "primary-gateway", "pool-a"))
    cond = pool_condition(env, "default", "pool-a", "primary-gateway",
                          api.COND_ACCEPTED)
    expect(cond is not None and cond.status == "True",
           f"pool-a Accepted: {cond}")


def inferencepool_resolvedrefs_add_and_clear(env):
    """Parent status appears with the route ref and clears when the route
    goes away (reference tests/inferencepool_resolvedrefs_condition.go)."""
    env.apply_pool(make_pool("pool-b", {"app": "primary"}))
    expect(env.get_pool("default", "pool-b").status.parents == [],
           "pool-b has parents before any route")
    env.apply_route(simple_route("route-b", "primary-gateway", "pool-b"))
    cond = pool_condition(env, "default", "pool-b", "primary-gateway",
                          api.COND_RESOLVED_REFS)
    expect(cond is not None and cond.status == "True",
           f"pool-b ResolvedRefs: {cond}")
    env.delete_route("default", "route-b")
    expect(env.get_pool("default", "pool-b").status.parents == [],
           "pool-b kept its parents after the route went away")


def invalid_epp_service(env):
    """Dangling EPP Service ref -> ResolvedRefs False/InvalidExtensionRef
    (reference tests/inferencepool_invalid_epp_service.go:42)."""
    env.apply_pool(make_pool("pool-c", {"app": "primary"}, epp="no-such-svc"))
    env.apply_route(simple_route("route-c", "primary-gateway", "pool-c"))
    cond = pool_condition(env, "default", "pool-c", "primary-gateway",
                          api.COND_RESOLVED_REFS)
    expect(cond.status == "False"
           and cond.reason == api.REASON_INVALID_EXTENSION_REF,
           f"pool-c ResolvedRefs: {cond}")


def missing_epp_ref(env):
    """endpointPickerRef is optional; the pool is accepted and served
    round-robin (reference tests/inferencepool_missing_epp_ref.go:40)."""
    env.apply_pool(make_pool("pool-d", {"app": "primary"}, epp=None))
    env.apply_route(
        simple_route("route-d", "primary-gateway", "pool-d", path="/d"))
    cond = pool_condition(env, "default", "pool-d", "primary-gateway",
                          api.COND_ACCEPTED)
    expect(cond.status == "True", f"pool-d Accepted: {cond}")
    resp = env.send("primary-gateway", "d.example.com", "/d")
    expect(resp.status == 200 and resp.backend_pod.startswith("primary-"),
           f"pool-d answer: {resp}")


def app_protocol(env):
    """http default + h2c honored (reference
    tests/inferencepool_appprotocol.go:39)."""
    env.apply_pool(make_pool("pool-http", {"app": "primary"}, ports=(8000,)))
    env.apply_pool(make_pool("pool-h2c", {"app": "secondary"}, ports=(8001,),
                             app_protocol=api.APP_PROTOCOL_H2C))
    env.apply_route(simple_route("route-http", "primary-gateway", "pool-http",
                                 path="/http"))
    env.apply_route(simple_route("route-h2c", "primary-gateway", "pool-h2c",
                                 path="/h2c"))
    expect(env.send("primary-gateway", "x", "/http").protocol == "http",
           "/http was not served over http")
    expect(env.send("primary-gateway", "x", "/h2c").protocol == "h2c",
           "/h2c was not served over h2c")


def port_validation(env):
    """backendRef port unspecified/matching/non-matching all route fine
    (reference tests/inferencepool_httproute_port_validation.go)."""
    env.apply_pool(make_pool("pool-e", {"app": "primary"}))
    for name, path, port in (("route-port-unspec", "/unspec", None),
                             ("route-port-match", "/match", 8000),
                             ("route-port-mismatch", "/mismatch", 7777)):
        env.apply_route(HTTPRoute(
            name=name, parent_gateways=["primary-gateway"],
            rules=[RouteRule(path_prefix=path, backend_refs=[
                BackendRef(name="pool-e", port=port)])]))
        ps = env.routes[("default", name)].parent_status("primary-gateway")
        expect(ps.get_condition(ROUTE_ACCEPTED).status == "True"
               and ps.get_condition(ROUTE_RESOLVED_REFS).status == "True",
               f"{name}: {ps.conditions}")
        resp = env.send("primary-gateway", "x", path)
        expect(resp.status == 200, f"{name}: status {resp.status}")


def route_invalid_pool_ref(env):
    """Route to a nonexistent pool: Accepted=True, ResolvedRefs=False/
    BackendNotFound (reference tests/httproute_invalid_inferencepool_ref.go)."""
    env.apply_route(simple_route("route-f", "primary-gateway", "ghost-pool"))
    ps = env.routes[("default", "route-f")].parent_status("primary-gateway")
    rr = ps.get_condition(ROUTE_RESOLVED_REFS)
    expect(ps.get_condition(ROUTE_ACCEPTED).status == "True"
           and rr.status == "False"
           and rr.reason == ROUTE_REASON_BACKEND_NOT_FOUND,
           f"route-f: {ps.conditions}")


# -- routing --------------------------------------------------------------


def _steered(env, pods, spread: bool) -> list:
    """100 requests steered to the first 1, 2 and 3 of `pods`: none may
    reach a pod outside its subset and, with `spread`, a subset of more
    than one pod gets more than one (reference
    tests/gateway_following_epp_routing.go:114-213). -> the responses."""
    out = []
    for subset_size in (1, 2, 3):
        subset = pods[:subset_size]
        allowed = {p.name for p in subset}
        steering = ",".join(p.ip for p in subset)
        served = collections.Counter()
        for _ in range(100):
            resp = env.send("primary-gateway", "x", "/", headers={
                mdkeys.TEST_ENDPOINT_SELECTION_HEADER: steering})
            expect(resp.status == 200, f"steered status {resp.status}")
            served[resp.backend_pod] += 1
            out.append(resp)
        expect(set(served) <= allowed, f"misroutes: {served} vs {allowed}")
        expect(not spread or subset_size == 1 or len(served) > 1,
               f"load did not spread across {allowed}: {served}")
    return out


def gateway_follows_epp_routing(env):
    env.apply_pool(make_pool("pool-g", {"app": "primary"}))
    env.apply_route(simple_route("route-g", "primary-gateway", "pool-g"))
    _steered(env, _primary_pods(env), spread=True)


def epp_routing_dp_ranks(env):
    """Multiple targetPorts = DP ranks; steering by ip:port must hit the
    exact rank (reference tests/gateway_following_epp_routing_dp.go:54)."""
    env.apply_pool(make_pool("pool-dp", {"app": "primary"},
                             ports=(3000, 3002, 3004)))
    env.apply_route(simple_route("route-dp", "primary-gateway", "pool-dp"))
    pod = _primary_pods(env)[0]
    for port in (3000, 3002, 3004):
        resp = env.send("primary-gateway", "x", "/", headers={
            mdkeys.TEST_ENDPOINT_SELECTION_HEADER: f"{pod.ip}:{port}"})
        expect(resp.status == 200 and resp.backend_pod == pod.name,
               f"rank {port}: {resp.status} {resp.backend_pod}")


def multiple_gateways_different_pools(env):
    """Two gateways -> two pools stay isolated (reference
    tests/httproute_multiple_gateways_different_pools.go:36)."""
    env.apply_pool(make_pool("pool-p", {"app": "primary"}))
    env.apply_pool(make_pool("pool-s", {"app": "secondary"}, ports=(8001,)))
    env.apply_route(simple_route("route-p", "primary-gateway", "pool-p"))
    env.apply_route(simple_route("route-s", "secondary-gateway", "pool-s"))
    for _ in range(20):
        for gateway, app in (("primary-gateway", "primary-"),
                             ("secondary-gateway", "secondary-")):
            pod = env.send(gateway, "x", "/").backend_pod
            expect(pod.startswith(app), f"{gateway} reached {pod}")


def multiple_rules_different_pools(env):
    """One route, two rules -> two pools (reference
    tests/inferencepool_multiple_rules_different_pools.go:37)."""
    env.apply_pool(make_pool("pool-r1", {"app": "primary"}))
    env.apply_pool(make_pool("pool-r2", {"app": "secondary"}, ports=(8001,)))
    env.apply_route(HTTPRoute(
        name="route-two-rules", parent_gateways=["primary-gateway"],
        rules=[RouteRule(path_prefix="/one",
                         backend_refs=[BackendRef(name="pool-r1")]),
               RouteRule(path_prefix="/two",
                         backend_refs=[BackendRef(name="pool-r2")])]))
    for _ in range(10):
        for path, app in (("/one", "primary-"), ("/two", "secondary-")):
            pod = env.send("primary-gateway", "x", path).backend_pod
            expect(pod.startswith(app), f"{path} reached {pod}")


def weighted_two_pools(env):
    """Weighted backendRef split across pools (reference
    tests/gateway_weighted_two_pools.go:51)."""
    env.apply_pool(make_pool("pool-w1", {"app": "primary"}))
    env.apply_pool(make_pool("pool-w2", {"app": "secondary"}, ports=(8001,)))
    env.apply_route(HTTPRoute(
        name="route-weighted", parent_gateways=["primary-gateway"],
        rules=[RouteRule(path_prefix="/", backend_refs=[
            BackendRef(name="pool-w1", weight=9),
            BackendRef(name="pool-w2", weight=1)])]))
    hits = collections.Counter()
    for _ in range(300):
        resp = env.send("primary-gateway", "x", "/")
        expect(resp.status == 200, f"weighted status {resp.status}")
        hits["w1" if resp.backend_pod.startswith("primary-") else "w2"] += 1
    expect(hits["w1"] > hits["w2"] * 3 and hits["w2"] > 0,
           f"a 9:1 split came out {dict(hits)}")


def epp_unavailable_fail_open(env):
    """Traffic still served when the EPP is scaled to 0 with FailOpen;
    FailClose rejects (reference tests/epp_unavailable_fail_open.go:40)."""
    env.apply_pool(make_pool("pool-open", {"app": "primary"},
                             failure_mode=api.FAIL_OPEN))
    env.apply_pool(make_pool("pool-close", {"app": "secondary"}, ports=(8001,),
                             failure_mode=api.FAIL_CLOSE))
    env.apply_route(simple_route("route-open", "primary-gateway", "pool-open",
                                 path="/open"))
    env.apply_route(simple_route("route-close", "primary-gateway",
                                 "pool-close", path="/close"))
    pod = _primary_pods(env)[0]
    resp = env.send("primary-gateway", "x", "/open",
                    headers={mdkeys.TEST_ENDPOINT_SELECTION_HEADER: pod.ip})
    expect(resp.status == 200 and resp.backend_pod == pod.name,
           f"steered /open: {resp.status} {resp.backend_pod}")
    env.scale_epp("default", "pool-open", 0)
    env.scale_epp("default", "pool-close", 0)
    for _ in range(10):
        status = env.send("primary-gateway", "x", "/open").status
        expect(status == 200, f"FailOpen with the EPP down: {status}")
    status = env.send("primary-gateway", "x", "/close").status
    expect(status == 503, f"FailClose with the EPP down: {status}")


def destination_endpoint_served(env):
    """The data plane reports the served endpoint back; the EPP echoes it
    (reference tests/gateway_destination_endpoint_served.go:40)."""
    env.apply_pool(make_pool("pool-served", {"app": "primary"}))
    env.apply_route(simple_route("route-served", "primary-gateway",
                                 "pool-served"))
    resp = env.send("primary-gateway", "x", "/")
    served = resp.headers.get(mdkeys.CONFORMANCE_TEST_RESULT_HEADER)
    expect(resp.status == 200 and served is not None,
           f"served echo: {resp.status} {resp.headers}")
    pod = next(p for p in env.cluster.list_pods("default")
               if p.name == resp.backend_pod)
    expect(served.startswith(pod.ip + ":"), f"{served} is not {pod.ip}")


def grpc_model_server_transcoding(env):
    """An h2c pool receives gRPC-framed GenerateRequests transcoded from
    the client's OpenAI JSON (proposal 2162); plain pools are untouched."""
    from gie_tpu_torch.extproc import codec
    from gie_tpu_torch.extproc.pb import generate_pb2

    env.apply_pool(make_pool("pool-grpc", {"app": "primary"},
                             app_protocol=api.APP_PROTOCOL_H2C))
    env.apply_route(simple_route("route-grpc", "primary-gateway", "pool-grpc"))
    body = json.dumps({"model": "m", "prompt": "transcode me",
                       "max_tokens": 5}).encode()
    resp = env.send("primary-gateway", "x", "/", body=body, method="POST")
    expect(resp.status == 200 and resp.backend_pod.startswith("primary-")
           and resp.backend_content_type == codec.GRPC_CONTENT_TYPE,
           f"h2c answer: {resp.status} {resp.backend_content_type}")
    (payload,) = list(codec.iter_frames(resp.backend_received))
    req = generate_pb2.GenerateRequest.FromString(payload)
    expect(req.prompt == "transcode me" and req.max_tokens == 5,
           f"transcoded request: {req}")
    env.apply_pool(make_pool("pool-plain", {"app": "secondary"},
                             ports=(8001,)))
    env.apply_route(simple_route("route-plain", "primary-gateway",
                                 "pool-plain", path="/plain"))
    resp = env.send("primary-gateway", "x", "/plain", body=body,
                    method="POST")
    expect(resp.status == 200 and resp.backend_received == body,
           "a plain-http pool's body was changed")


# -- cases that build their own environment -------------------------------


def routing_conformance(env: ConformanceEnv, pool_name: str = "pool-tpu",
                        route_name: str = "route-tpu") -> list:
    """The zero-misroute routing contract on a fresh environment: the
    steered subsets, then 20 unsteered requests. -> the responses."""
    env.apply_gateway(Gateway("primary-gateway"))
    env.apply_service(Service("epp-svc"))
    env.deploy_model_servers("primary-model-server", 3, {"app": "primary"})
    env.apply_pool(make_pool(pool_name, {"app": "primary"}))
    env.apply_route(simple_route(route_name, "primary-gateway", pool_name))
    out = _steered(env, _primary_pods(env), spread=False)
    for _ in range(20):
        resp = env.send("primary-gateway", "x", "/")
        expect(resp.status == 200 and resp.backend_pod.startswith("primary-"),
               f"unsteered: {resp.status} {resp.backend_pod}")
        out.append(resp)
    return out


def routing_with_tpu_scheduler(**env_kwargs):
    """The strictest routing test against the EPP's picker (the batched
    Scheduler in "tpu" mode)."""
    env = ConformanceEnv(**env_kwargs)
    try:
        routing_conformance(env)
    finally:
        env.close()


def _multicluster(routing_mode: str, parent: bool, env_kwargs: dict):
    from gie_tpu_torch.conformance.multicluster import (
        MultiClusterInferenceEnv,
    )

    mc = MultiClusterInferenceEnv(["exporter", "importer"],
                                  routing_mode=routing_mode, **env_kwargs)
    try:
        exp = mc.env("exporter")
        exp.apply_service(Service("epp-svc"))
        pods = exp.deploy_model_servers("remote-model-server", 3,
                                        {"app": "remote"})
        pool = make_pool("shared-pool", {"app": "remote"})
        pool.metadata.annotations[api.EXPORT_ANNOTATION] = (
            api.EXPORT_SCOPE_CLUSTERSET)
        mc.apply_pool("exporter", pool)
        if parent:
            exp.apply_gateway(Gateway("remote-gateway"))
            exp.apply_route(simple_route("remote-route", "remote-gateway",
                                         "shared-pool"))
        imp_env = mc.env("importer")
        imp_env.apply_gateway(Gateway("primary-gateway"))
        imp_env.apply_route(HTTPRoute(
            name="import-route", parent_gateways=["primary-gateway"],
            rules=[RouteRule(backend_refs=[BackendRef(
                name="shared-pool", kind="InferencePoolImport",
                group=api.GROUP_X)])]))
        names = {p.name for p in pods}
        for _ in range(1 if parent else 6):
            resp = imp_env.send("primary-gateway", "x", "/", body=b"q")
            expect(resp.status == 200 and resp.backend_pod in names,
                   f"imported pool: {resp.status} {resp.backend_pod}")
    finally:
        mc.close()


def multicluster_endpoint_mode(**env_kwargs):
    """Proposal 1374 Endpoint routing mode."""
    from gie_tpu_torch.conformance.multicluster import ROUTING_MODE_ENDPOINT

    _multicluster(ROUTING_MODE_ENDPOINT, False, env_kwargs)


def multicluster_parent_mode(**env_kwargs):
    """Proposal 1374 Parent routing mode."""
    from gie_tpu_torch.conformance.multicluster import ROUTING_MODE_PARENT

    _multicluster(ROUTING_MODE_PARENT, True, env_kwargs)


# Report name -> case: over the shared base environment ...
BASE_CASES = {
    "InferencePoolAccepted": inferencepool_accepted,
    "InferencePoolResolvedRefsCondition":
        inferencepool_resolvedrefs_add_and_clear,
    "InferencePoolInvalidEPPService": invalid_epp_service,
    "InferencePoolMissingEPPRef": missing_epp_ref,
    "InferencePoolAppProtocol": app_protocol,
    "InferencePoolHTTPRoutePortValidation": port_validation,
    "HTTPRouteInvalidInferencePoolRef": route_invalid_pool_ref,
    "GatewayFollowingEPPRouting": gateway_follows_epp_routing,
    "GatewayFollowingEPPRoutingWithDataParallelism": epp_routing_dp_ranks,
    "HTTPRouteMultipleGatewaysDifferentPools":
        multiple_gateways_different_pools,
    "HTTPRouteMultipleRulesDifferentPools": multiple_rules_different_pools,
    "GatewayWeightedAcrossTwoInferencePools": weighted_two_pools,
    "EppUnAvailableFailOpen": epp_unavailable_fail_open,
    "GatewayDestinationEndpointServed": destination_endpoint_served,
    "GatewayGRPCModelServerTranscoding": grpc_model_server_transcoding,
}
# ... and building their own from the ConformanceEnv keyword arguments.
OWN_CASES = {
    "GatewayFollowingEPPRoutingTPUScheduler": routing_with_tpu_scheduler,
    "MultiClusterEndpointMode": multicluster_endpoint_mode,
    "MultiClusterParentMode": multicluster_parent_mode,
}


def run_case(name: str, **env_kwargs) -> None:
    """One case by its report name, with ConformanceEnv(**env_kwargs)."""
    if name in OWN_CASES:
        OWN_CASES[name](**env_kwargs)
        return
    env = build_base_env(**env_kwargs)
    try:
        BASE_CASES[name](env)
    finally:
        env.close()


def run(**env_kwargs) -> tuple[ConformanceReport, dict]:
    """Every case, each recorded passed or failed. -> the report and
    {report name: traceback} of the cases that failed."""
    report, errors = ConformanceReport(), {}
    for name in list(BASE_CASES) + list(OWN_CASES):
        try:
            run_case(name, **env_kwargs)
        except Exception:       # a case's failure is its verdict
            report.add(name, False)
            errors[name] = traceback.format_exc()
        else:
            report.add(name, True)
    return report, errors
