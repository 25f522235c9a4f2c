"""The port's ExtProcServerRunner against gie_tpu's, side by side on the CPU.

Both runners serve the same FakeCluster of 16 pods with Options(
resilience=False, obs=False), scraping off (both engines closed) and the
same scraped rows on a fixed clock. The port's Scheduler runs on the CPU
with the JAX scheduler's Gumbel draws replayed (`jax_noise_replay`), the
reference's JAX Scheduler on the CPU (its Pallas kernels in interpret
mode). 24 sequential Envoy-shaped streams (request headers, JSON body,
response headers echoing the pick) must leave byte-equal responses, in the
Sinkhorn-kernel and the top-k-kernel configuration. A real gRPC drive of
the port's runner then returns the destination header, its health port
answers, and its /metrics exposes the reference's metric families. The
runner's two inputs are held to the reference's too: scraped text parses
to the same rows, and cluster events leave the same endpoints.

Pods sit on loopback addresses: a runner that scrapes (the gRPC drive)
must reach nothing beyond this host.
"""

import dataclasses
import importlib
import json
import socket
import urllib.request

import grpc
import numpy as np
import pytest
import torch

from gie_tpu_torch.sched import constants as C
from tests.test_extproc_wire import GOLDEN_REQUEST_HEADERS
from tests.test_torch_slice import jax_noise_replay

SEED = 0
NOW = 1000.0
PODS = 16
STREAMS = 24
ADAPTERS = [f"adapter-{k}" for k in range(12)]
BASE = "SYSTEM: You are a helpful assistant specialised in task %d. "
PKGS = ("gie_tpu", "gie_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _cluster(pkg: str):
    api = _mod(pkg, "api.types")
    cluster = _mod(pkg, "controller").FakeCluster()
    cluster.apply_pool(api.InferencePool(
        metadata=api.ObjectMeta(name="pool"),
        spec=api.InferencePoolSpec(
            selector=api.LabelSelector(matchLabels={"app": "vllm"}),
            targetPorts=[api.Port(8000)])))
    Pod = _mod(pkg, "datastore.objects").Pod
    for i in range(PODS):
        cluster.apply_pod(Pod(name=f"vllm-{i}", labels={"app": "vllm"},
                              ip=f"127.3.0.{i + 1}"))
    return cluster


def _scheduler(pkg: str, config: str):
    sched = _mod(pkg, "sched")
    if config == "sinkhorn-kernel":
        cfg, w = _mod(pkg, "sched.config").tuned_profile()
        cfg = dataclasses.replace(cfg, use_pallas_sinkhorn=True)
    else:
        cfg, w = sched.ProfileConfig(picker="topk", use_pallas_topk=True), None
    if pkg == "gie_tpu":
        return sched.Scheduler(cfg, w, seed=SEED)
    return sched.Scheduler(cfg, w, device="cpu",
                           noise_source=jax_noise_replay(SEED))


def _runner(pkg: str, config: str, **opts):
    Options = _mod(pkg, "runtime.options").Options
    Runner = _mod(pkg, "runtime.runner").ExtProcServerRunner
    runner = Runner(Options(pool_name="pool", resilience=False, obs=False,
                            secure_serving=False, **opts),
                    _cluster(pkg), scheduler=_scheduler(pkg, config))
    # The reference's runner warms its jit lattice on a background thread
    # (runner.py:346), which changes no pick; the port has no jit and
    # passes False. Off here too, or the thread is still compiling when
    # the test process exits.
    runner.picker.background_warm = False
    return runner


def _quiet(runner) -> None:
    """Scraping off, and the same rows on a fixed clock on either side."""
    runner.scraper.close()
    runner.setup()
    rng = np.random.default_rng(SEED)
    reg = runner.lora_registry
    rows = [(ep.slot, {C.Metric.QUEUE_DEPTH: float(rng.integers(0, 50)),
                       C.Metric.KV_CACHE_UTIL: float(rng.uniform(0, 0.95)),
                       C.Metric.MAX_LORA: 8.0},
             [reg.id_for(ADAPTERS[j]) for j in rng.choice(12, 3, False)], ())
            for ep in runner.datastore.endpoints()]
    runner.metrics_store._clock = lambda: NOW
    runner.metrics_store.update_rows(rows, now=NOW)


class _EnvoyStream:
    """One exchange as Envoy sends it: request headers, the JSON body,
    then the response headers echoing the picked primary."""

    def __init__(self, pkg: str, i: int):
        pb = self.pb = _mod(pkg, "extproc.pb")
        self.envoy = _mod(pkg, "extproc.envoy")
        rng = np.random.default_rng(100 + i)
        lora = int(rng.integers(-1, 12))
        body = json.dumps({
            "model": "" if lora < 0 else ADAPTERS[lora],
            "prompt": BASE % (i % 5) * 6 + f"user question {i}",
            "max_tokens": int(rng.integers(1, 300))}).encode()
        headers = pb.HeaderMap(headers=[
            pb.HeaderValue(key=":path", raw_value=b"/v1/completions"),
            pb.HeaderValue(key="x-gateway-inference-fairness-id",
                           raw_value=b"tenant-%d" % (i % 3)),
            pb.HeaderValue(key="x-gateway-inference-objective",
                           raw_value=[b"", b"critical", b"standard",
                                      b"sheddable"][i % 4])])
        self.frames = [
            pb.ProcessingRequest(request_headers=pb.HttpHeaders(
                headers=headers, end_of_stream=False)),
            pb.ProcessingRequest(request_body=pb.HttpBody(
                body=body, end_of_stream=True))]
        self.sent = []
        self._echoed = False

    def recv(self):
        if not self.frames and not self._echoed and self.sent:
            self._echoed = True
            dest = _destination(self.sent[0]).split(",")[0]
            req = self.pb.ProcessingRequest(
                response_headers=self.pb.HttpHeaders(
                    headers=self.pb.HeaderMap(headers=[self.pb.HeaderValue(
                        key=":status", raw_value=b"200")])))
            req.metadata_context.filter_metadata["envoy.lb"].CopyFrom(
                self.envoy.make_dynamic_metadata(
                    "envoy.lb",
                    {"x-gateway-destination-endpoint-served": dest},
                ).fields["envoy.lb"].struct_value)
            self.frames.append(req)
        return self.frames.pop(0) if self.frames else None

    def send(self, resp):
        self.sent.append(resp)


def _destination(resp) -> str:
    for opt in resp.request_headers.response.header_mutation.set_headers:
        if opt.header.key == "x-gateway-destination-endpoint":
            return opt.header.raw_value.decode()
    return ""


@pytest.mark.parametrize("config", ["sinkhorn-kernel", "topk-kernel"])
def test_runner_streams_byte_equal(config):
    torch.use_deterministic_algorithms(True)
    runners = [_runner(pkg, config) for pkg in PKGS]
    try:
        for r in runners:
            _quiet(r)
        for i in range(STREAMS):
            sent = []
            for pkg, r in zip(PKGS, runners):
                stream = _EnvoyStream(pkg, i)
                r.streaming.process(stream)
                assert len(stream.sent) == 3, (pkg, i)
                assert _destination(stream.sent[0]), (pkg, i)
                sent.append([m.SerializeToString() for m in stream.sent])
            assert sent[1] == sent[0], f"stream {i}"
        loads = [np.asarray(r.scheduler.snapshot_assumed_load())
                 for r in runners]
        np.testing.assert_allclose(loads[1], loads[0], rtol=0, atol=1e-5)
    finally:
        for r in runners:
            r.stop()
        torch.use_deterministic_algorithms(False)


def _families(text: str) -> dict:
    """{family: (type, {(sample name, label names)})} of an exposition."""
    from gie_tpu_torch.metricsio.scrape import parse_sample_lines

    out, types = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            types[name] = kind
            out[name] = (kind, set())
    for sample in parse_sample_lines(text):
        family = max((f for f in out if sample.name.startswith(f)), key=len)
        out[family][1].add((sample.name, tuple(sorted(sample.labels))))
    return out


def _grpc_drive(port: int, n: int) -> list:
    with grpc.insecure_channel(f"127.0.0.1:{port}") as chan:
        method = chan.stream_stream(
            "/envoy.service.ext_proc.v3.ExternalProcessor/Process")
        return [list(method(iter([GOLDEN_REQUEST_HEADERS]), timeout=60))
                for _ in range(n)]


def _health(pkg: str, port: int, service: str) -> int:
    """grpc.health.v1 Check against `port`."""
    health_pb2 = _mod(pkg, "extproc.pb.health_pb2")
    with grpc.insecure_channel(f"127.0.0.1:{port}") as chan:
        check = chan.unary_unary(
            "/grpc.health.v1.Health/Check",
            request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb2.HealthCheckResponse.FromString)
        return check(health_pb2.HealthCheckRequest(service=service),
                     timeout=10).status


def test_grpc_drive_health_and_metrics():
    """The port's runner served over real gRPC on free ports: its answers
    carry the destination header, its dedicated health port answers
    SERVING for readiness, and its /metrics carries only families of the
    reference's exposition after the same drive (the reference runner
    driven in memory: its gRPC server is not started in a test process),
    each with the same type and, where both hold samples, the port's
    sample names and label names among the reference's."""
    import prometheus_client

    import gie_tpu.runtime.metrics as ref_metrics

    pb = _mod("gie_tpu_torch", "extproc.pb")
    ports = {k: _free_port() for k in
             ("grpc_port", "grpc_health_port", "metrics_port")}
    port_runner = _runner("gie_tpu_torch", "topk-kernel", extproc_workers=2,
                          **ports)
    ref_runner = _runner("gie_tpu", "topk-kernel")
    url = f"http://127.0.0.1:{ports['metrics_port']}"
    try:
        port_runner.setup()
        grpc_port = port_runner.start()
        answers = _grpc_drive(grpc_port, 4)
        assert all(len(a) == 1 for a in answers)
        dests = [_destination(pb.ProcessingResponse.FromString(a[0]))
                 for a in answers]
        assert all(d.split(",")[0].startswith("127.3.0.") for d in dests)
        assert _health("gie_tpu_torch", ports["grpc_health_port"],
                       "readiness") == 1
        assert _health("gie_tpu_torch", grpc_port, "liveness") == 1
        with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
            text = resp.read().decode()
        with urllib.request.urlopen(url + "/debugz", timeout=30) as resp:
            pages = json.loads(resp.read())["pages"]

        ref_runner.setup()
        ref_pb = _mod("gie_tpu", "extproc.pb")
        for _ in range(4):
            stream = _Frames([ref_pb.ProcessingRequest.FromString(
                GOLDEN_REQUEST_HEADERS)])
            ref_runner.streaming.process(stream)
            assert _destination(stream.sent[0])
        # What the reference's start() stamps, and its two acceptors'
        # accept-counter children (ExtProcWorkerPool._make_server).
        for worker in ("0", "1"):
            ref_metrics.WORKER_ACCEPTS.labels(worker=worker)
        ref_metrics.set_build_info(fast_lane=True, resilience=False,
                                   obs=False, wire=True, workers=2)
        ref_metrics.set_policy_info(scorer="blend", weights={"queue": 1.0})
        ref_text = prometheus_client.generate_latest(
            ref_metrics.REGISTRY).decode()
    finally:
        port_runner.stop()
        ref_runner.stop()
    assert pages == sorted(f"/debugz/{p}" for p in (
        "buildinfo", "datastore", "drain", "policy", "queue", "scheduler",
        "tenants"))
    ref, port = _families(ref_text), _families(text)
    for family in ("gie_build_info", "gie_pick_latency_seconds",
                   "gie_active_streams", "gie_pool_endpoints"):
        assert family in port
    assert sorted(set(port) - set(ref)) == []
    for family, (kind, samples) in port.items():
        assert kind == ref[family][0], family
        if samples and ref[family][1]:
            assert samples <= ref[family][1], family


class _Frames:
    def __init__(self, messages):
        self.messages = list(messages)
        self.sent = []

    def recv(self):
        return self.messages.pop(0) if self.messages else None

    def send(self, resp):
        self.sent.append(resp)


def test_runner_without_device_needs_a_card(monkeypatch):
    """With no injected scheduler the runner builds Scheduler(tuned
    profile) with no device argument: CUDA, and an error without a card."""
    from gie_tpu_torch.runtime.options import Options
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExtProcServerRunner(Options(pool_name="p", resilience=False,
                                    obs=False), _cluster("gie_tpu_torch"))


# -- the runner's inputs: scraped text and cluster events -------------------

HAND_WRITTEN = r"""# HELP vllm:num_requests_waiting Number of requests waiting.
# TYPE vllm:num_requests_waiting gauge
vllm:num_requests_waiting{model_name="m"} 7
vllm:num_requests_running{model_name="m"} 3 1700000000000
vllm:kv_cache_usage_perc 0.25
vllm:cache_config_info{block_size="32",num_gpu_blocks="4096"} 1
vllm:lora_requests_info{max_lora="4",running_lora_adapters="a,b",waiting_lora_adapters=""} 10.5
vllm:lora_requests_info{max_lora="4",running_lora_adapters="c",waiting_lora_adapters="d"} 9.0
# TYPE vllm:time_to_first_token_seconds histogram
vllm:time_to_first_token_seconds_bucket{le="0.1"} 3
vllm:time_to_first_token_seconds_bucket{le="+Inf"} 4
vllm:time_to_first_token_seconds_sum 0.7
vllm:time_to_first_token_seconds_count 4
nv_trt_llm_request_metrics{request_type="waiting",model="x\"y"} 5
nv_trt_llm_request_metrics{request_type="scheduled"} 2
nv_trt_llm_kv_cache_block_metrics{kv_cache_block_type="fraction"} 0.5
nv_trt_llm_kv_cache_block_metrics{kv_cache_block_type="tokens_per"} 64
nv_trt_llm_kv_cache_block_metrics{kv_cache_block_type="max"} 1000
trtllm_num_requests_waiting 1
trtllm_num_requests_running 6
trtllm_kv_cache_utilization 0.125
trtllm_kv_cache_tokens_per_block 32
trtllm_kv_cache_max_blocks 2048
sglang:num_queue_reqs 4
sglang:num_running_reqs 2
sglang:token_usage 0.75
sglang:cache_config_info{page_size="16",num_pages="512"} 1
sglang:lora_requests_info{max_lora="2",running_lora_adapters="x",waiting_lora_adapters="y,z"} 3
"""


def _expositions() -> list:
    """Scrapes as model servers send them: a VLLMStub's own text as it
    loads and runs adapters, and hand-written text for every server
    mapping (label escapes, a timestamp, HELP lines, two LoRA-info series
    of which the fresher wins, families no mapping reads)."""
    from gie_tpu_torch.simulator import StubConfig, VLLMStub

    stub = VLLMStub(StubConfig(), name="s")
    texts = [stub.metrics_text()]
    for k in range(8):
        stub.submit((BASE % k).encode() * 4, 64.0,
                    lora=ADAPTERS[k % 5] if k % 2 else None)
        stub.step(0.2)
        texts.append(stub.metrics_text())
    return texts + [HAND_WRITTEN]


@pytest.mark.parametrize("server", ["vllm", "triton-tensorrt-llm",
                                    "trtllm-serve", "sglang"])
def test_scrape_parse_equal(server):
    """The port's own exposition-line parser (it does not use
    prometheus_client) reads every scrape into the same metric columns and
    LoRA ids as the reference's prometheus_client parse."""
    texts = _expositions()
    got = []
    for pkg in PKGS:
        scrape = _mod(pkg, "metricsio.scrape")
        mapping = _mod(pkg, "metricsio.mappings").BY_NAME[server]
        reg = _mod(pkg, "utils.lora").LoraRegistry()
        rows = []
        for text in texts:
            cols, active, waiting = scrape.parse_scrape(
                text, mapping, lora=reg, use_native=False)
            rows.append(({int(k): v for k, v in cols.items()},
                         active, waiting))
        got.append(rows)
    assert got[1] == got[0]
    assert any(cols for cols, _, _ in got[1])


def _wired(pkg: str):
    """A FakeCluster wired to a Datastore through both reconcilers, as the
    runner's setup() wires them."""
    api = _mod(pkg, "api.types")
    ctrl = _mod(pkg, "controller")
    cluster, ds = ctrl.FakeCluster(), _mod(pkg, "datastore").Datastore()
    gknn = _mod(pkg, "utils.kubemeta").GKNN(api.GROUP, "InferencePool",
                                             "default", "pool")
    _mod(pkg, "controller.reconcilers").wire(
        cluster, ctrl.InferencePoolReconciler(cluster, ds, gknn),
        ctrl.PodReconciler(cluster, ds))
    return api, cluster, ds


def test_reconcilers_follow_cluster_events_equal():
    """The same pool and pod events (ready, unready, another label, an
    active-ports annotation, a new IP, termination, deletion, a selector
    and port change, pool deletion) leave both datastores with the same
    endpoints, ranks and slots after every event."""
    views = []
    for pkg in PKGS:
        api, cluster, ds = _wired(pkg)
        Pod = _mod(pkg, "datastore.objects").Pod

        def pool(app, ports, api=api):
            return api.InferencePool(
                metadata=api.ObjectMeta(name="pool"),
                spec=api.InferencePoolSpec(
                    selector=api.LabelSelector(matchLabels={"app": app}),
                    targetPorts=[api.Port(p) for p in ports]))

        view = []

        def snap(ds=ds, view=view):
            view.append((ds.pool_has_synced(), sorted(
                (ep.name, ep.address, ep.port, ep.rank, ep.slot,
                 getattr(ep, "draining", None)) for ep in ds.endpoints())))

        cluster.apply_pool(pool("v", [8000, 8002]))
        snap()
        for i in range(6):
            cluster.apply_pod(Pod(
                name=f"p{i}", labels={"app": "w" if i == 4 else "v"},
                ip=f"127.4.0.{i + 1}", ready=i != 3,
                annotations=({api.ACTIVE_PORTS_ANNOTATION: "8002"}
                             if i == 5 else {})))
            snap()
        cluster.apply_pod(Pod(name="p1", labels={"app": "v"},
                              ip="127.4.0.9"))
        snap()
        cluster.apply_pod(Pod(name="p2", labels={"app": "v"},
                              ip="127.4.0.3",
                              deletionTimestamp="2026-01-01T00:00:00Z"))
        snap()
        cluster.delete_pod("default", "p0")
        snap()
        cluster.apply_pool(pool("w", [8000]))
        snap()
        cluster.delete_pool("default", "pool")
        snap()
        views.append(view)
    assert views[1] == views[0]
    assert any(endpoints for _, endpoints in views[1])
