"""The port's observability layer against the reference on the CPU.

gie_tpu_torch's flight recorder, tracer wiring, /debugz pages, OpenMetrics
exposition with exemplars, OTLP exporter, dump CLI and catalog lint, side
by side with gie_tpu's. The two packages keep separate obs globals; the
autouse fixture uninstalls both around every test.

Tolerances: exact (record fields except the wall-clock reads `ts` and
`serve_latency_ms`, response bytes, page
shapes, exposition text with its timestamps masked, OTLP payloads),
except the flight records' `ranked` scores, held within atol=2e-5 (the
Sinkhorn lane tiebreak rewrites low mantissa bits; tests/test_torch_slice.py).
"""

import importlib
import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import prometheus_client
import pytest
import torch
from prometheus_client.openmetrics import exposition as openmetrics

from tests.test_torch_picker import NOW, SIDES, _request, _stack
from tests.test_torch_runner import (
    _EnvoyStream,
    _cluster,
    _destination,
    _free_port,
    _quiet,
    _scheduler,
)

PKGS = ("gie_tpu", "gie_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _clean_globals():
    for pkg in PKGS:
        _mod(pkg, "obs").uninstall()
        _mod(pkg, "resilience.faults").uninstall()
    yield
    for pkg in PKGS:
        _mod(pkg, "obs").uninstall()
        _mod(pkg, "resilience.faults").uninstall()


def _split_ranked(records: list) -> tuple:
    """-> (records without wall-clock reads and ranked, ranked slots,
    ranked scores)."""
    out, slots, scores = [], [], []
    for rec in records:
        rec = {k: v for k, v in rec.items()
               if k not in ("ts", "serve_latency_ms")}
        ranked = rec.pop("ranked", [])
        out.append(rec)
        slots.append([e["slot"] for e in ranked])
        scores += [e["score"] for e in ranked]
    return out, slots, scores


# -- (a) the runner with the reference's default flags --------------------


class _TracedStream(_EnvoyStream):
    """An Envoy exchange carrying a W3C traceparent, so both packages
    trace (and record) the stream under the same trace ID."""

    def __init__(self, pkg: str, i: int):
        super().__init__(pkg, i)
        self.trace_id = f"{i + 1:032x}"
        self.frames[0].request_headers.headers.headers.append(
            self.pb.HeaderValue(key="traceparent", raw_value=(
                f"00-{self.trace_id}-{i + 1:016x}-01").encode()))


def _default_runner(pkg: str):
    """The runner main() builds from `--pool-name pool --insecure-serving
    --obs-sample-rate 1.0`: resilience and obs on (the defaults)."""
    Options = _mod(pkg, "runtime.options").Options
    Runner = _mod(pkg, "runtime.runner").ExtProcServerRunner
    runner = Runner(Options(pool_name="pool", secure_serving=False,
                            obs_sample_rate=1.0),
                    _cluster(pkg), scheduler=_scheduler(pkg, "topk-kernel"))
    runner.picker.background_warm = False  # see tests/test_torch_runner.py
    return runner


def _shape(obj):
    """A JSON page's shape: dict keys (recursively), list element shapes."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return sorted({json.dumps(_shape(v), sort_keys=True) for v in obj})
    return type(obj).__name__ if not isinstance(obj, (int, float)) else "num"


def test_runner_with_default_flags_serves_records_and_traces_equal():
    """Resilience and obs on, every stream sampled: 12 streams leave
    byte-equal responses, equal flight records (trace IDs included),
    equal trace stages and outcomes, /debugz pages of the same shape,
    and the port's OpenMetrics carries a trace_id exemplar on the
    pick-latency histogram."""
    torch.use_deterministic_algorithms(True)
    runners = [_default_runner(pkg) for pkg in PKGS]
    try:
        for r in runners:
            _quiet(r)
        for i in range(12):
            sent = []
            for pkg, r in zip(PKGS, runners):
                stream = _TracedStream(pkg, i)
                r.streaming.process(stream)
                assert _destination(stream.sent[0]), (pkg, i)
                sent.append([m.SerializeToString() for m in stream.sent])
            assert sent[1] == sent[0], f"stream {i}"
        obs_mods = [_mod(pkg, "obs") for pkg in PKGS]
        recs = [_split_ranked(o.RECORDER.snapshot()) for o in obs_mods]
        assert recs[1][:2] == recs[0][:2]
        np.testing.assert_allclose(recs[1][2], recs[0][2], rtol=0, atol=2e-5)
        records = recs[1][0]
        assert len(records) == 12
        assert {r["rung"] for r in records} == {"full"}
        assert {r["outcome"] for r in records} == {"2xx"}
        assert all(r["served"] == r["chosen"] for r in records)
        traces = [[(t["trace_id"], t["outcome"], t["pick"],
                    [e["stage"] for e in t["events"]])
                   for t in o.TRACER.traces("recent", 50)] for o in obs_mods]
        assert traces[1] == traces[0] and len(traces[1]) == 12
        pages = []
        for r in runners:
            providers = r._debugz_providers()
            trace_id = records[3]["trace_id"]
            pages.append({name: _shape(fn({"id": trace_id,
                                           "trace": trace_id}))
                          for name, fn in sorted(providers.items())
                          if name not in ("scheduler", "buildinfo")})
        assert pages[1] == pages[0]
        assert set(pages[1]) >= {"traces", "trace", "picks", "pick",
                                 "breakers", "ladder"}
        port = runners[1]
        assert port.resilience.healthy()
        assert port._debugz_providers()["trace"](
            {"id": records[3]["trace_id"]})["trace_id"] == records[3][
                "trace_id"]
        text = _mod("gie_tpu_torch", "runtime.metrics").generate_openmetrics()
        assert re.search(rb'gie_pick_latency_seconds_bucket\{le="[^"]+"\} '
                         rb'[0-9.]+ # \{trace_id="[0-9a-f]{32}"\}', text)
    finally:
        for r in runners:
            r.stop()
        torch.use_deterministic_algorithms(False)
    assert _mod("gie_tpu_torch", "obs").RECORDER is None  # stop uninstalls


class _AbortAfter:
    """Request headers, then an Envoy cancellation (StreamAborted) or a
    clean half-close, before any response headers."""

    def __init__(self, pkg: str, abort: bool):
        self.pb = _mod(pkg, "extproc.pb")
        self.aborted = _mod(pkg, "extproc.server").StreamAborted
        self.abort = abort
        from tests.test_extproc_wire import GOLDEN_REQUEST_HEADERS

        self.messages = [self.pb.ProcessingRequest.FromString(
            GOLDEN_REQUEST_HEADERS)]
        self.sent = []

    def recv(self):
        if self.messages:
            return self.messages.pop(0)
        if self.abort:
            raise self.aborted()
        return None

    def send(self, resp):
        self.sent.append(resp)


def test_records_close_on_abort_and_half_close():
    """A stream aborted after its pick closes its record as "reset" (and
    releases the charge), a clean half-close as "closed" — equal records
    in both packages."""
    out = []
    for side in SIDES:
        pkg = "gie_tpu" if side.jax else "gie_tpu_torch"
        recorder = _mod(pkg, "obs.recorder").FlightRecorder(16)
        _mod(pkg, "obs").install(recorder=recorder)
        st = _stack(side, "default")
        srv = _mod(pkg, "extproc.server").StreamingServer(
            st.ds, st.picker, on_served=st.picker.observe_served,
            on_stream_aborted=st.picker.observe_stream_aborted)
        try:
            for abort in (True, False, True):
                srv.process(_AbortAfter(pkg, abort))
            records, slots, scores = _split_ranked(recorder.snapshot())
            load = float(np.abs(np.asarray(
                st.sched.snapshot_assumed_load())).sum())
            out.append((records, slots, scores, load))
        finally:
            st.picker.close()
    assert out[1][:2] == out[0][:2]
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=0, atol=2e-5)
    assert [r["outcome"] for r in out[1][0]] == ["reset", "closed", "reset"]
    assert out[1][3] == pytest.approx(0.0, abs=1e-4)


def test_shed_and_unavailable_records_equal():
    """Waves on a saturated pool (sheddable requests shed) and with an
    unroutable candidate set record "shed" / "unavailable" alike."""
    from types import SimpleNamespace

    out = []
    for side in SIDES:
        pkg = "gie_tpu" if side.jax else "gie_tpu_torch"
        recorder = _mod(pkg, "obs.recorder").FlightRecorder(64)
        _mod(pkg, "obs").install(recorder=recorder)
        st = _stack(side, "default", queue=200.0)
        try:
            items = [side.Pending(_request(side, i), st.ds.pick_candidates(),
                                  now=NOW) for i in range(8)]
            items.append(side.Pending(_request(side, 8),
                                      [SimpleNamespace(slot=-1)], now=NOW))
            st.picker._run_batch(items)
            for it in items:
                assert it.event.wait(60)
            out.append(_split_ranked(recorder.snapshot()))
        finally:
            st.picker.close()
    assert out[1][:2] == out[0][:2]
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=0, atol=2e-5)
    outcomes = {r["outcome"] for r in out[1][0]}
    assert {"shed", "unavailable"} <= outcomes


# -- (b) exposition: OpenMetrics with exemplars, text 0.0.4, name[] -------


_TS = re.compile(rb"(_created(?:\{[^}]*\})? )[0-9.e+]+|(# \{[^}]*\} \S+) [0-9.]+")


def _mask(text: bytes) -> bytes:
    """Creation and exemplar timestamps are wall-clock reads."""
    return _TS.sub(lambda m: (m.group(1) or m.group(2) + b" ") + b"T", text)


def _families(text: bytes) -> list:
    """The masked exposition's family blocks, sorted: prometheus_client
    yields a name[]-restricted registry's metrics in set order."""
    text = _mask(text)
    eof = text.endswith(b"# EOF\n")
    blocks = re.split(rb"(?m)^(?=# HELP )", text[:-6] if eof else text)
    return sorted(blocks) + [eof]


def _twins(seed: int):
    """Every metric of the port's catalog (set_function gauges aside)
    rebuilt in two private registries — prometheus_client's and the
    port's — and fed the same observations, exemplars on the histograms'
    sampled observations."""
    own = _mod("gie_tpu_torch", "runtime.metrics")
    rng = np.random.default_rng(seed)
    ref_reg, port_reg = prometheus_client.CollectorRegistry(), []
    for metric in own.REGISTRY:
        if getattr(metric, "_function", None) is not None:
            continue
        kw = {"buckets": metric.buckets} if metric.kind == "histogram" else {}
        cls = {"counter": prometheus_client.Counter,
               "gauge": prometheus_client.Gauge,
               "histogram": prometheus_client.Histogram}[metric.kind]
        ref = cls(metric.name, metric.documentation, metric.labelnames,
                  registry=ref_reg, **kw)
        port = type(metric)(metric.name, metric.documentation,
                            metric.labelnames, registry=port_reg, **kw)
        for _ in range(int(rng.integers(0, 6))):
            labels = [f"v{int(rng.integers(0, 3))}"
                      for _ in metric.labelnames]
            pair = [(m.labels(*labels) if labels else m) for m in (ref, port)]
            if metric.kind == "counter":
                amount = float(rng.integers(1, 5))
                for m in pair:
                    m.inc(amount)
            elif metric.kind == "gauge":
                value = float(rng.uniform(-5, 5))
                for m in pair:
                    m.set(value)
            else:
                value = float(rng.lognormal(-5, 2))
                exemplar = ({"trace_id": f"{int(rng.integers(1 << 62)):032x}"}
                            if rng.random() < 0.5 else None)
                for m in pair:
                    m.observe(value, exemplar)
    return ref_reg, port_reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expositions_equal_prometheus_client(seed):
    """The port's OpenMetrics text (exemplars included) and its text
    0.0.4 equal prometheus_client's renderings of the same observations,
    whole and under a name[] restriction."""
    own = _mod("gie_tpu_torch", "runtime.metrics")
    ref_reg, port_reg = _twins(seed)
    assert _mask(own.generate_openmetrics(port_reg)) == _mask(
        openmetrics.generate_latest(ref_reg))
    assert _mask(own.generate_latest(port_reg)) == _mask(
        prometheus_client.generate_latest(ref_reg))
    assert b' # {trace_id="' in own.generate_openmetrics(port_reg)
    names = ["gie_pick_latency_seconds_bucket", "gie_picks_total",
             "gie_degraded_mode", "gie_serve_outcome_created",
             "gie_outlier_ejections", "gie_no_such_metric"]
    assert _families(own.generate_openmetrics(port_reg, names)) == _families(
        openmetrics.generate_latest(ref_reg.restricted_registry(names)))
    assert _families(own.generate_latest(port_reg, names)) == _families(
        prometheus_client.generate_latest(ref_reg.restricted_registry(names)))


def _get(port, path, accept=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    if accept:
        req.add_header("Accept", accept)
    with urllib.request.urlopen(req, timeout=5) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_debugz_server_negotiates_openmetrics():
    """/metrics answers text 0.0.4 by default, OpenMetrics with the
    exemplar under Accept negotiation, name[]-filtered and gzipped on
    request; /debugz lists and serves the pages."""
    import gzip

    from gie_tpu_torch.obs.debugz import DebugzServer
    from gie_tpu_torch.runtime import metrics as own_metrics

    srv = DebugzServer(0, {"ping": lambda q: {"ok": True, "n": q.get("n")}},
                       bind="127.0.0.1")
    try:
        catalog = json.loads(_get(srv.port, "/debugz")[2])
        assert "/debugz/ping" in catalog["pages"]
        assert json.loads(_get(srv.port, "/debugz/ping?n=3")[2]) == {
            "ok": True, "n": "3"}
        status, ctype, body = _get(srv.port, "/metrics")
        assert status == 200 and ctype == own_metrics.CONTENT_TYPE_LATEST
        assert b"gie_picks_total" in body and b"# EOF" not in body
        own_metrics.PICK_LATENCY.observe(0.012, {"trace_id": "feed" * 8})
        status, ctype, body = _get(
            srv.port, "/metrics",
            accept="application/openmetrics-text; version=1.0.0")
        assert "openmetrics" in ctype and body.rstrip().endswith(b"# EOF")
        assert b'# {trace_id="' + b"feed" * 8 + b'"} 0.012 ' in body
        filtered = _get(srv.port, "/metrics?name[]=gie_active_streams")[2]
        assert b"gie_active_streams" in filtered
        assert b"gie_picks_total" not in filtered
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/metrics",
                                     headers={"Accept-Encoding": "gzip"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            assert resp.headers.get("Content-Encoding") == "gzip"
            assert b"gie_picks_total" in gzip.decompress(resp.read())
        with pytest.raises(urllib.error.HTTPError):
            _get(srv.port, "/debugz/nope")
    finally:
        srv.close()


def test_debugz_bind_and_token_hardening(monkeypatch):
    """/debugz is loopback-only unless --debugz-bind names a non-loopback
    ADDRESS (aliases and typos stay gated); a blocked peer gets 403 on
    every /debugz path; with --debugz-token a remote peer needs the
    bearer token (401 otherwise), even with the bind opened; /metrics is
    never gated."""
    from gie_tpu_torch.obs.debugz import DebugzServer

    srv = DebugzServer(0, {"ping": lambda q: {"ok": True}}, bind="127.0.0.1")
    try:
        assert srv._debugz_allowed("127.0.0.1") and srv._debugz_allowed("::1")
        for peer in ("10.0.0.5", "192.168.1.9", "not-an-ip"):
            assert not srv._debugz_allowed(peer)
        assert _get(srv.port, "/debugz/ping")[0] == 200
        monkeypatch.setattr(srv, "_debugz_allowed", lambda peer: False)
        for path in ("/debugz", "/debugz/ping", "/debugz/nope"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(srv.port, path)
            assert ei.value.code == 403
        assert _get(srv.port, "/metrics")[0] == 200
    finally:
        srv.close()
    for bind, opens in (("0.0.0.0", True), ("127.0.0.2", False),
                        (" 127.0.0.1 ", False), ("Localhost", False),
                        ("wat", False)):
        gate = DebugzServer(0, {}, bind="127.0.0.1", debugz_bind=bind)
        try:
            assert gate._debugz_allowed("10.0.0.5") == opens, bind
        finally:
            gate.close()
    for debugz_bind in ("127.0.0.1", "0.0.0.0"):
        tok = DebugzServer(0, {"ping": lambda q: {"ok": True}},
                           bind="127.0.0.1", debugz_bind=debugz_bind,
                           debugz_token="s3cret-tok")
        try:
            assert _get(tok.port, "/debugz/ping")[0] == 200  # loopback
            monkeypatch.setattr(tok, "_peer_is_loopback", lambda peer: False)
            for headers in ({}, {"Authorization": "Bearer wrong"},
                            {"Authorization": "Basic s3cret-tok"}):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    _get(tok.port, "/debugz/ping", headers=headers)
                assert ei.value.code == 401, headers
            assert _get(tok.port, "/debugz/ping", headers={
                "Authorization": "Bearer s3cret-tok"})[0] == 200
            assert _get(tok.port, "/metrics")[0] == 200
        finally:
            tok.close()


# -- (c) OTLP export ------------------------------------------------------


def _trace_dict(trace_id="ab" * 16, outcome="ok", events=None):
    return {
        "trace_id": trace_id, "request_id": "rid-1", "sampled": True,
        "outcome": outcome, "latency_ms": 12.5, "finished_at": 1.7e9,
        "events": events if events is not None else [
            {"stage": "admission", "at_ms": 0.0},
            {"stage": "picked", "at_ms": 3.0}],
        "pick": {"chosen": "10.0.0.1:8000", "rung": "full",
                 "outcome": "picked"},
    }


def test_otlp_payloads_equal():
    """The same trace dicts (ok, error-class, a federation hop, one that
    cannot map) -> byte-equal OTLP/HTTP JSON batches from both exporters,
    batched at batch_max alike."""
    traces = [_trace_dict(f"{i:032x}", outcome, events)
              for i, (outcome, events) in enumerate([
                  ("ok", None), ("serve_5xx", None),
                  ("ok", [{"stage": "admission", "at_ms": 0.0},
                          {"stage": "federation:west", "at_ms": 2.0},
                          {"stage": "picked", "at_ms": 3.0}]),
                  ("shed", []), ("ok", None)])]
    traces.append({"trace_id": "not-hex", "finished_at": 1.7e9})
    bodies = []
    for pkg in PKGS:
        otlp = _mod(pkg, "obs.otlp")
        sent = []
        exporter = otlp.OtlpSpanExporter("http://127.0.0.1:1", batch_max=4,
                                         flush_interval_s=60.0,
                                         post=sent.append)
        for trace in traces:
            exporter.export(trace)
        exporter.close()
        bodies.append((sent, exporter.report()))
    assert bodies[1] == bodies[0]
    assert len(bodies[1][0]) == 2


def test_otlp_exporter_posts_to_sink_and_survives_dead_collector():
    """Tracer.on_export -> the exporter's background batch POST reaches a
    loopback HTTP sink; against a dead collector export never blocks,
    posts fail and spans drop, and the thread lives on."""
    import http.server

    from gie_tpu_torch.obs.otlp import OtlpSpanExporter
    from gie_tpu_torch.obs.trace import Tracer

    bodies, got = [], threading.Event()

    class Sink(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0) or 0)
            bodies.append(json.loads(self.rfile.read(n)))
            got.set()
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    exporter = OtlpSpanExporter(f"http://127.0.0.1:{httpd.server_address[1]}",
                                flush_interval_s=0.05)
    tracer = Tracer(1.0)
    tracer.on_export = exporter.export
    try:
        ctx = tracer.begin({})
        ctx.event("federation:west")
        tracer.finish(ctx, "ok")
        assert got.wait(5.0), "sink never received a batch"
        spans = bodies[0]["resourceSpans"][0]["scopeSpans"][0]["spans"]
        assert {s["name"] for s in spans} == {"gie.request", "gie.federation"}
    finally:
        exporter.close()
        httpd.shutdown()
        httpd.server_close()
    dead = OtlpSpanExporter("http://127.0.0.1:1", timeout_s=0.2,
                            flush_interval_s=0.05, queue_max=4)
    try:
        t0 = time.monotonic()
        for _ in range(32):
            dead.export(_trace_dict())
        assert time.monotonic() - t0 < 0.5, "export blocked the caller"
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and dead.post_errors == 0:
            time.sleep(0.05)
        assert dead.post_errors > 0 and dead.dropped > 0
        assert dead.exported == 0 and dead._thread.is_alive()
    finally:
        dead.close()


# -- (d) recorder, dumps, CLI and the catalog lint ------------------------


@pytest.mark.parametrize("n", [0, 3])
def test_recorder_ring_equal(n):
    """The same appends past the ring size -> equal snapshots (oldest
    first; newest first when trimmed to n), finds and lengths."""
    out = []
    for pkg in PKGS:
        rec = _mod(pkg, "obs.recorder").FlightRecorder(5)
        for i in range(9):
            rec.append({"trace_id": f"t{i % 4}", "i": i})
        out.append((rec.snapshot(n), rec.find(trace_id="t1"),
                    rec.find(seq=6), rec.find(seq=1), len(rec),
                    rec.export_json(n)))
    assert out[1] == out[0]


def test_dump_artifact_rotation_and_cli(tmp_path):
    """obs.dump_artifact and DumpRotator write the reference's envelope,
    the rotator keeps its newest files, and `python -m gie_tpu_torch.obs
    dump` harvests /debugz/picks from a running debugz server into a
    file the reference's loader reads."""
    from gie_tpu import obs as ref_obs
    from gie_tpu.obs.recorder import load_records
    from gie_tpu_torch import obs
    from gie_tpu_torch.obs import __main__ as cli
    from gie_tpu_torch.obs.debugz import DebugzServer
    from gie_tpu_torch.obs.recorder import DumpRotator, FlightRecorder

    assert obs.dump_artifact(str(tmp_path), "nothing") is None
    recorder = FlightRecorder(8)
    for i in range(3):
        recorder.append({"trace_id": f"{i:032x}", "outcome": "picked"})
    obs.install(recorder=recorder)
    path = obs.dump_artifact(str(tmp_path), "scn/1")
    payload = json.loads(open(path).read())
    assert path.endswith("scn-1-flightrec.json")
    assert [r["seq"] for r in payload["records"]] == [0, 1, 2]
    assert ref_obs.RECORDER is None  # the reference's global is its own
    rot = DumpRotator(str(tmp_path / "rot"), keep=2)
    paths = [rot.rotate_once() for _ in range(4)]
    assert rot.rotation_files() == paths[-2:]
    srv = DebugzServer(0, {"picks": lambda q: recorder.snapshot(
        n=int(q.get("n", "100")))}, bind="127.0.0.1")
    try:
        out_dir = tmp_path / "cli"
        assert cli.main(["dump", "--out", str(out_dir),
                         "--port", str(srv.port)]) == 0
        (dump,) = list(out_dir.iterdir())
        assert len(load_records(dump.read_text())) == 3
    finally:
        srv.close()


def test_metricscheck_clean_on_port_catalog_and_catches_bad_metrics():
    from gie_tpu_torch.obs import metricscheck
    from gie_tpu_torch.runtime import metrics as own_metrics

    assert metricscheck.main() == 0
    assert metricscheck.check_registry(own_metrics.REGISTRY) == []
    bad = [own_metrics.Counter("requests_total", "Requests", registry=None),
           own_metrics.Gauge("gie_x", "gie_x", registry=None),
           own_metrics.Counter("gie_wide_total", "Wide", ["a", "b", "c", "d",
                                                          "e"], registry=None),
           own_metrics.Gauge("gie_per_pod", "Per pod", ["pod"],
                             registry=None)]
    codes = sorted(f.split()[0] for f in metricscheck.check_registry(bad))
    assert codes == ["OC001", "OC002", "OC003", "OC004"]
