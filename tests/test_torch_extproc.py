"""The port's ext-proc transport against gie_tpu's, side by side on the CPU.

The same flags parse to the same Options; the same frames through the same
stub picker leave both StreamingServers with byte-equal responses, on every
lane (legacy, fast, wire) and frame kind (headers only, headers + body,
response headers, shed 429, deadline 503, subset hint, unavailable, and a
body transcoded to gRPC for an h2c pool); and
the port's runner and main build every option's pieces, the kube
slice's and the multi-device slice's (--mesh-devices) included, and
refuse none.
"""

import argparse
import dataclasses
import importlib
import json
import socket
import urllib.request

import pytest

from tests.test_extproc_wire import (
    GOLDEN_REQUEST_HEADERS,
    GOLDEN_RESPONSE_HEADERS,
    GOLDEN_SUBSET_HINT,
    header_map_bytes,
    header_value_bytes,
    http_headers_bytes,
    ld,
    vi,
)

PKGS = ("gie_tpu", "gie_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# -- options --------------------------------------------------------------

ARGVS = [
    [],
    ["--pool-name", "pool-a", "--pool-namespace", "ns1"],
    ["--grpc-port", "19002", "--grpc-health-port", "19003",
     "--metrics-port", "19090"],
    ["--insecure-serving"],
    ["--no-resilience", "--no-obs"],
    ["--scheduler-config", "config/scheduler/sinkhorn-tuned.yaml"],
    ["--batch-window-ms", "5", "--scrape-interval-ms", "500"],
    ["--extproc-workers", "4", "--no-extproc-wire"],
    ["--no-extproc-fast-lane"],
    ["--queue-bound", "64", "--queue-max-age-s", "2.5"],
    ["--objective", "chat=2", "--objective", "batch=0"],
    ["--fairness-weights", "paid=4,free=1", "--fairness-top-k", "4"],
    ["--debugz-bind", "0.0.0.0", "--debugz-token", "s3cret"],
    ["--fed-cluster", "east", "--fed-peer", "west=http://w:9010"],
    ["--fault", "scrape.fetch=error:0.2", "--fault-seed", "7"],
]


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _parse(pkg: str, argv):
    Options = _mod(pkg, "runtime.options").Options
    parser = argparse.ArgumentParser()
    Options.add_flags(parser)
    return Options.from_args(parser.parse_args(argv))


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "empty")
def test_options_parse_equal(argv):
    ref, port = (_parse(pkg, argv) for pkg in PKGS)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    outcomes = []
    for opts in (ref, port):
        opts.pool_name = opts.pool_name or "p"
        try:
            opts.validate()
            outcomes.append("ok")
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[1] == outcomes[0]


# -- frames through both StreamingServers ---------------------------------


class _Stream:
    def __init__(self, messages):
        self.messages = list(messages)
        self.sent = []

    def recv(self):
        return self.messages.pop(0) if self.messages else None

    def send(self, resp):
        self.sent.append(resp)


class _StubPicker:
    """A fixed pick from the candidates (first, then two fallbacks, plus
    an extra header); the objective header "shed" / "deadline" makes it
    raise that side's ShedError / DeadlineExceeded."""

    def __init__(self, pkg: str):
        self.server = _mod(pkg, "extproc.server")
        self.deadline = _mod(pkg, "resilience.deadline")
        # The reference carries a grpc.StatusCode, the port its name.
        self.unavailable = getattr(self.server, "UNAVAILABLE", None)
        if self.unavailable is None:
            import grpc

            self.unavailable = grpc.StatusCode.UNAVAILABLE

    def pick(self, req, candidates):
        mode = req.headers.get("x-gateway-inference-objective", [""])[0]
        if mode == "shed":
            raise self.server.ShedError()
        if mode == "deadline":
            raise self.deadline.DeadlineExceeded("queue")
        if not candidates:
            raise self.server.ExtProcError(self.unavailable,
                                           "no endpoints available")
        hostports = [ep.hostport for ep in candidates]
        return self.server.PickResult(
            endpoint=hostports[0], fallbacks=hostports[1:3],
            extra_headers={"x-picked-by": "stub"})


def _datastore(pkg: str, app_protocol: str = "http"):
    ds = _mod(pkg, "datastore").Datastore()
    objects = _mod(pkg, "datastore.objects")
    ds.pool_set(objects.EndpointPool({"app": "v"}, [8000], "default",
                                     app_protocol=app_protocol))
    for i in range(4):
        ds.pod_update_or_add(objects.Pod(
            name=f"p{i}", labels={"app": "v"}, ip=f"10.0.0.{i + 1}"))
    return ds


def _headers_frame(extra=(), end_of_stream=True) -> bytes:
    values = [header_value_bytes(":path", raw=b"/v1/completions"),
              header_value_bytes("content-type", raw=b"application/json")]
    values += [header_value_bytes(k, raw=v.encode()) for k, v in extra]
    return ld(2, http_headers_bytes(header_map_bytes(*values), end_of_stream))


def _body_frame(body: bytes) -> bytes:
    return ld(3, ld(1, body) + vi(2, 1))     # HttpBody{body=1, eos=2}


BODY = (b'{"model": "adapter-3", "prompt": "SYSTEM: be brief. ' + b"x" * 300
        + b'", "max_tokens": 64}')
FRAMES = {
    "headers-only": [GOLDEN_REQUEST_HEADERS],
    "headers+body": [_headers_frame(end_of_stream=False), _body_frame(BODY)],
    "response-headers": [GOLDEN_REQUEST_HEADERS, GOLDEN_RESPONSE_HEADERS],
    "shed-429": [_headers_frame([("x-gateway-inference-objective", "shed")])],
    "deadline-503": [_headers_frame(
        [("x-gateway-inference-objective", "deadline")], False),
        _body_frame(BODY)],
    "subset": [GOLDEN_SUBSET_HINT],
    "h2c-transcode": [_headers_frame(end_of_stream=False), _body_frame(BODY)],
    "empty-subset-unavailable": [_headers_frame(
        [("test-epp-endpoint-selection", "10.9.9.9")])],
}


def _run(pkg: str, lane: str, frames):
    """-> (serialized responses, error status name or None, served list)."""
    server_mod = _mod(pkg, "extproc.server")
    picker = _StubPicker(pkg)
    served = []
    protocol = "kubernetes.io/h2c" if frames is FRAMES["h2c-transcode"] \
        else "http"
    srv = server_mod.StreamingServer(
        _datastore(pkg, protocol), picker, fast_lane=lane != "legacy",
        on_served=lambda hostport, ctx: served.append(hostport))
    error = None
    if lane == "wire":
        session = srv.wire_session()
        out = []
        try:
            for data in frames:
                out += session.feed(data)
                if session.done:
                    break
        except server_mod.ExtProcError as e:
            error = e
        session.close(error)
    else:
        pb = _mod(pkg, "extproc.pb")
        stream = _Stream([pb.ProcessingRequest.FromString(f) for f in frames])
        try:
            srv.process(stream)
        except server_mod.ExtProcError as e:
            error = e
        out = [r.SerializeToString() for r in stream.sent]
    code = None if error is None else getattr(error.code, "name", error.code)
    return out, code, served


@pytest.mark.parametrize("kind", list(FRAMES))
@pytest.mark.parametrize("lane", ["legacy", "fast", "wire"])
def test_streaming_server_bytes_equal(lane, kind):
    ref, port = (_run(pkg, lane, FRAMES[kind]) for pkg in PKGS)
    assert port == ref
    out, code, _ = port
    if kind == "empty-subset-unavailable":
        assert code == "UNAVAILABLE" and out == []
    else:
        assert code is None and out


def test_lanes_agree_with_each_other():
    """Within the port, the three lanes answer the same frames with the
    same bytes (the reference's own lane contract)."""
    for kind, frames in FRAMES.items():
        outs = [_run("gie_tpu_torch", lane, frames) for lane in
                ("legacy", "fast", "wire")]
        assert outs[1] == outs[0] and outs[2] == outs[0], kind


def test_grpc_status_mapping():
    import grpc

    from gie_tpu_torch.extproc.server import RESOURCE_EXHAUSTED, UNAVAILABLE
    from gie_tpu_torch.extproc.service import grpc_status

    assert grpc_status(UNAVAILABLE) == grpc.StatusCode.UNAVAILABLE
    assert grpc_status(RESOURCE_EXHAUSTED) == grpc.StatusCode.RESOURCE_EXHAUSTED
    assert grpc_status("INTERNAL") == grpc.StatusCode.INTERNAL
    assert grpc_status("NO_SUCH_CODE") == grpc.StatusCode.UNKNOWN


def test_descriptors_byte_identical():
    """Both packages register the same envoy/*.proto files in protobuf's
    default pool, which refuses a second registration that differs."""
    for name in ("extproc.pb.envoy.service.ext_proc.v3.external_processor_pb2",
                 "extproc.pb.envoy.config.core.v3.base_pb2",
                 "extproc.pb.envoy.type.v3.http_status_pb2",
                 "extproc.pb.health_pb2", "extproc.pb.generate_pb2"):
        ref, port = (_mod(pkg, name).DESCRIPTOR for pkg in PKGS)
        assert port.serialized_pb == ref.serialized_pb, name


# -- refusals -------------------------------------------------------------

LIVE = ["--no-resilience", "--no-obs"]
# (argv, None: the runner builds every one; a slice's key here would name
# an option refused until that slice came. The resilience and
# observability layers, both on by default, --fault arming, the KV-event
# listener, the learned scorer, the file-lease elector, replication, the
# autoscale loop in both modes, federation, the fleet picker and the mesh
# are ported; with an injected scheduler --mesh-devices builds no mesh, as
# in the reference).
REFUSED = [
    ([], None),                                 # resilience + obs on
    (["--no-resilience"], None),                # obs on
    (LIVE + ["--leader-elect"], None),
    (LIVE + ["--replication-port", "19100"], None),
    (LIVE + ["--autoscale-mode", "recommend"], None),
    # Ported: with no kube cluster client the actuator has nothing to
    # patch and every apply counts as no_target, as in the reference.
    (LIVE + ["--autoscale-mode", "apply"], None),
    (LIVE + ["--fed-cluster", "east", "--fed-peer", "w=http://w:1"], None),
    (LIVE + ["--fed-drain", "--fed-cluster", "east"], None),
    (LIVE + ["--kv-events-port", "19300"], None),
    (LIVE + ["--fleet-topk", "2"], None),
    (LIVE + ["--mesh-devices", "2"], None),
    # Ported: with a scheduler injected the runner reads no artifact,
    # as the reference's does not.
    (LIVE + ["--scorer", "learned", "--policy-artifact", "x.json"], None),
    # Ported: with a scheduler injected the runner builds no trainer, as
    # the reference's does not.
    (LIVE + ["--enable-predictor"], None),
    (LIVE + ["--fault", "scrape.fetch=error:0.5"], None),
]


@pytest.mark.parametrize("argv, key", REFUSED,
                         ids=[" ".join(a) or "defaults" for a, _ in REFUSED])
def test_runner_refuses_out_of_slice(argv, key, tmp_path):
    from gie_tpu_torch.controller import FakeCluster
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner
    from gie_tpu_torch.sched import Scheduler

    opts = _parse("gie_tpu_torch", argv + ["--pool-name", "p"])
    if key is None:
        if opts.kv_events_port:
            opts.kv_events_port = _free_port()   # the listener binds it
        if opts.replication_port:
            opts.replication_port = _free_port()  # the manager binds it
        if opts.leader_elect:
            opts.leader_lease_path = str(tmp_path / "lease")
        runner = ExtProcServerRunner(opts, FakeCluster(),
                                     scheduler=Scheduler(device="cpu"))
        try:
            assert (runner.resilience is not None) == opts.resilience
            assert runner.picker.resilience is runner.resilience
            assert runner._obs_installed == opts.obs
            # An injected scheduler: no trainer, --enable-predictor or not.
            assert runner.trainer is None and runner.picker.trainer is None
            if opts.kv_events_port:
                # start() builds the listener after the ext-proc pool.
                runner._start_kv_events()
                assert runner.kv_events_server.port == opts.kv_events_port
                req = urllib.request.Request(
                    f"http://127.0.0.1:{opts.kv_events_port}/events",
                    data=b'{"type": "BlockStored", "endpoint": "x:1", '
                         b'"hashes": [5]}', method="POST")
                with urllib.request.urlopen(req, timeout=10) as resp:
                    assert json.loads(resp.read()) == {"accepted": 1}
                assert runner.kv_events.dropped == 1   # no such endpoint
            assert (runner.elector is not None) == opts.leader_elect
            assert ((runner.replication is not None)
                    == (opts.replication_port > 0))
            assert ((runner.autoscaler is not None)
                    == (opts.autoscale_mode != "off"))
            if runner.autoscaler is not None:
                actuator = runner.autoscaler.actuator
                assert actuator.client is None
                assert actuator.dry_run == (opts.autoscale_mode != "apply")
            fed = bool(opts.fed_peers or opts.fed_drain)
            assert (runner.federation is not None) == fed
            assert runner.picker.federation is runner.federation
            if fed:
                assert runner.federation.draining == opts.fed_drain
                assert sorted(runner.fed_exchange.links) == sorted(
                    p.partition("=")[0] for p in opts.fed_peers)
                assert runner.fed_exchange.server is None  # no --fed-port
        finally:
            runner.stop()
        return
    raise AssertionError(f"{argv}: no option is refused any more ({key})")


def test_fault_scenario_refused_at_validate():
    """--fault-scenario loads the recorded scenario at validate: a shipped
    one validates, an unknown name or one beside --fault is refused."""
    opts = _parse("gie_tpu_torch", LIVE + ["--pool-name", "p",
                                           "--fault-scenario", "mixed-soak"])
    opts.validate()
    opts.fault_scenario = "no-such-scenario"
    with pytest.raises(ValueError, match="--fault-scenario: no such"):
        opts.validate()
    opts.fault_scenario = "mixed-soak"
    opts.fault_specs = ["scrape.fetch=error:0.5"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        opts.validate()


def test_main_refuses_kube(tmp_path, monkeypatch):
    """main --kube builds the kube adapter, which refuses to start with no
    kubeconfig outside a cluster (as the reference's does); the multi-
    device mesh is no longer refused: with --mesh-devices the flags reach
    the kube adapter, and a dp axis that is no power of two is refused at
    validate, as in the reference."""
    from gie_tpu_torch.controller import kube
    from gie_tpu_torch.runtime.main import main

    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.setattr(kube, "_SA_DIR", str(tmp_path / "no-sa"))
    with pytest.raises(RuntimeError, match="no usable Kubernetes"):
        main(["--kube", "--pool-name", "p", "--insecure-serving"] + LIVE)
    with pytest.raises(RuntimeError, match="no usable Kubernetes"):
        main(["--kube", "--pool-name", "p", "--insecure-serving",
              "--mesh-devices", "2"] + LIVE)
    with pytest.raises(ValueError, match="power of two"):
        main(["--kube", "--pool-name", "p", "--mesh-devices", "6"] + LIVE)


def test_pod_manifest_event_refused():
    """A pod manifest riding on a watch event (the informer pass-through)
    is no longer refused: both packages reconcile the same manifests,
    readiness, labels and deletion included, into the same endpoints."""
    got = []
    for pkg in PKGS:
        controller = _mod(pkg, "controller")
        objects = _mod(pkg, "datastore.objects")
        ds = _mod(pkg, "datastore").Datastore()
        ds.pool_set(objects.EndpointPool({"app": "v"}, [8000], "default"))
        rec = controller.PodReconciler(controller.FakeCluster(), ds)
        seen = []
        for i, (ready, app, deleting) in enumerate((
                (True, "v", False), (False, "v", False), (True, "w", False),
                (True, "v", True), (True, "v", False))):
            meta = {"name": f"p{i % 4}", "namespace": "default",
                    "labels": {"app": app}}
            if deleting:
                meta["deletionTimestamp"] = "2026-01-01T00:00:00Z"
            rec.reconcile("default", meta["name"], obj={
                "metadata": meta, "status": {
                    "podIP": f"127.7.0.{i + 1}", "conditions": [{
                        "type": "Ready",
                        "status": "True" if ready else "False"}]}})
            seen.append((sorted(e.hostport for e in ds.endpoints()),
                         sorted(e.hostport for e in ds.pick_candidates())))
        got.append(seen)
    assert got[1] == got[0]
    assert got[1][0] == (["127.7.0.1:8000"], ["127.7.0.1:8000"])


def test_pd_scheduler_config_builds_a_pd_runner(tmp_path, monkeypatch):
    """A --scheduler-config with pd_disaggregation: true builds the runner
    over a pd Scheduler, its picker holding --pd-budget-floor-ms."""
    import functools

    from gie_tpu_torch.controller import FakeCluster
    from gie_tpu_torch.runtime import runner as runner_mod
    from gie_tpu_torch.sched import Scheduler

    monkeypatch.setattr(runner_mod, "Scheduler",
                        functools.partial(Scheduler, device="cpu"))
    path = tmp_path / "pd.yaml"
    path.write_text("picker: sinkhorn\npd_disaggregation: true\n")
    opts = _parse("gie_tpu_torch", LIVE + [
        "--pool-name", "p", "--scheduler-config", str(path),
        "--pd-budget-floor-ms", "120"])
    runner = runner_mod.ExtProcServerRunner(opts, FakeCluster())
    try:
        assert runner.scheduler.cfg.pd_disaggregation
        assert runner.scheduler.cfg.picker == "sinkhorn"
        assert runner.picker.pd_budget_floor_s == pytest.approx(0.12)
    finally:
        runner.stop()


def test_acceptors_keep_arrived_calls_until_the_poller_takes_them(
        monkeypatch):
    """Every SO_REUSEPORT acceptor is built with gRPC core's limit on an
    arrived call's wait for the acceptor's poller raised past any stream
    timeout (grpcio 1.80 cancels such a call after 30 s by default; the
    card test test_acceptor_answers_a_stream_that_waited_past_30_s holds
    it there)."""
    import grpc

    from gie_tpu_torch.extproc import workers

    seen = []
    real = grpc.server

    def spy(*args, **kwargs):
        seen.append(dict(kwargs.get("options", ())))
        return real(*args, **kwargs)

    monkeypatch.setattr(workers.grpc, "server", spy)
    pool = workers.ExtProcWorkerPool(object(), 3, wire=True)
    assert pool.bind("127.0.0.1:0") > 0
    pool.stop(0).wait(10)
    assert len(seen) == 3
    for options in seen:
        assert options == {
            "grpc.so_reuseport": 1,
            "grpc.server_max_unrequested_time_in_server":
                workers.UNREQUESTED_MAX_S}
    assert workers.UNREQUESTED_MAX_S >= 3600
