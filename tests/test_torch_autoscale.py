"""The port's autoscale loop (gie_tpu_torch.autoscale) against the JAX
reference's (gie_tpu.autoscale) on the CPU.

  signals      SignalCollector over a seeded trace of the five counter
               families it differentiates (twins of the runtime metrics
               in a private registry of each package) and of a
               MetricsStore of each package on a fixed clock: every
               PoolSignals field equal, floats within 1e-12 (the
               collector sums integer counts and one histogram sum; the
               bound covers summation order);
  model        CapacityModel and AutoscaleRecommender over a seeded
               signal program (idle, a shed burst past the sustain
               window, capacity materializing, a quiet spell past the
               cooldown, a stale spell, scale-from-zero): every
               Recommendation and estimate equal (exact: same float
               operations on both sides);
  controller   AutoscaleController.step with twin collectors and the
               dry-run actuator: recommendations and the gie_autoscale_*
               gauges equal;
  persistence  CapacityModel.save / restore through the port's .npz
               (converged and not), an unreadable directory restoring as
               False, and its digest section installing into the
               reference's model;
  actuator     the dry run's outcomes equal the reference's;
  runner       --autoscale-mode recommend, --replication-port and
               --leader-elect build and start the runner (readiness gated
               on leadership, gie_autoscale_* on /metrics); over a kube
               cluster client --autoscale-mode apply builds a writing
               actuator and --leader-elect a Lease elector.
"""

import dataclasses
import math
import os
import socket
import time
import urllib.request

import numpy as np
import prometheus_client
import pytest

from gie_tpu.autoscale import actuator as ref_actuator
from gie_tpu.autoscale import controller as ref_controller
from gie_tpu.autoscale import model as ref_model
from gie_tpu.autoscale import recommender as ref_recommender
from gie_tpu.autoscale import signals as ref_signals
from gie_tpu.metricsio.store import MetricsStore as RefStore
from gie_tpu.runtime import metrics as ref_metrics

from gie_tpu_torch.autoscale import actuator, controller, model, recommender
from gie_tpu_torch.autoscale import signals
from gie_tpu_torch.metricsio.store import MetricsStore
from gie_tpu_torch.runtime import metrics as own_metrics
from gie_tpu_torch.sched import constants as C

T0 = 1.7e9
SLOTS = 12


class _Ep:
    def __init__(self, slot):
        self.slot = slot


class _Engine:
    def __init__(self):
        self.age = 0.0

    def staleness_seconds(self):
        return self.age


def _twins():
    """The families the collector reads, rebuilt in a prometheus_client
    registry (reference) and a port registry list."""
    ref_reg, port_reg, pairs = prometheus_client.CollectorRegistry(), [], {}
    for metric in own_metrics.REGISTRY:
        if metric.name not in signals._READ:
            continue
        kw = {"buckets": metric.buckets} if metric.kind == "histogram" else {}
        cls = {"counter": prometheus_client.Counter,
               "gauge": prometheus_client.Gauge,
               "histogram": prometheus_client.Histogram}[metric.kind]
        ref = cls(metric.name, metric.documentation, metric.labelnames,
                  registry=ref_reg, **kw)
        port = type(metric)(metric.name, metric.documentation,
                            metric.labelnames, registry=port_reg, **kw)
        pairs[metric.name] = (ref, port)
    assert set(pairs) == set(signals._READ)
    return ref_reg, port_reg, pairs


def _feed(rng, pairs, ref_store, port_store, engines, t, spotty=False):
    """One seeded step of traffic counters and scraped rows on both sides
    (`spotty`: rows skip scrapes and go stale)."""
    picks = pairs["gie_picks_total"]
    for outcome in ("ok", "shed", "error"):
        n = int(rng.integers(0, 40 if outcome == "ok" else 6))
        for m in picks:
            m.labels(outcome=outcome).inc(n)
    for reason in ("depth", "evicted", "age"):
        for band in ("sheddable", "standard"):
            n = int(rng.integers(0, 3))
            if n:
                for m in pairs["gie_flow_queue_shed_total"]:
                    m.labels(reason=reason, band=band).inc(n)
    depth = float(rng.integers(0, 20))
    for m in pairs["gie_flow_queue_depth"]:
        m.set(depth)
    for name in ("gie_device_wait_seconds", "gie_host_assembly_seconds"):
        for _ in range(int(rng.integers(0, 4))):
            v = float(rng.integers(1, 2000)) / 1e5
            for m in pairs[name]:
                m.observe(v)
    for slot in range(SLOTS):
        if not spotty or rng.random() < 0.5:
            metrics = {int(C.Metric.QUEUE_DEPTH): float(rng.integers(0, 12)),
                       int(C.Metric.KV_CACHE_UTIL): float(rng.uniform(0, 1))}
            at = t - float(rng.uniform(0, 3 if spotty else 1))
            for store in (ref_store, port_store):
                store.update(slot, metrics, now=at)
    if rng.random() < 0.2:
        for store in (ref_store, port_store):
            store.note_empty_pool_arrival()
    age = float(rng.uniform(0, 3 if spotty else 1.5))
    for e in engines:
        e.age = age


def _collectors(seed):
    ref_reg, port_reg, pairs = _twins()
    ref_store, port_store = RefStore(clock=lambda: T0), MetricsStore(
        clock=lambda: T0)
    engines = (_Engine(), _Engine())
    eps = lambda: [_Ep(s) for s in range(SLOTS)]      # noqa: E731
    ref = ref_signals.SignalCollector(
        ref_store, eps, queue_limit=8.0, staleness_s=2.0, registry=ref_reg,
        scrape_engine=engines[0])
    port = signals.SignalCollector(
        port_store, eps, queue_limit=8.0, staleness_s=2.0, registry=port_reg,
        scrape_engine=engines[1])
    rng = np.random.default_rng(seed)
    return rng, pairs, ref_store, port_store, engines, ref, port


def _assert_signals_equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert set(da) == set(db)
    for k in da:
        if isinstance(da[k], dict):
            assert set(da[k]) == set(db[k]), k
            for band in da[k]:
                assert math.isclose(da[k][band], db[k][band], rel_tol=1e-12,
                                    abs_tol=1e-12), (k, band)
        elif isinstance(da[k], float):
            assert math.isclose(da[k], db[k], rel_tol=1e-12,
                                abs_tol=1e-12) or da[k] == db[k], k
        else:
            assert da[k] == db[k], k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_signal_collector_matches_the_reference(seed):
    rng, pairs, rs, ps, engines, ref, port = _collectors(seed)
    t = T0
    stale_seen = fresh_seen = 0
    for step in range(30):
        t += float(rng.choice([0.5, 1.0, 2.0, 0.0]))   # 0.0: same instant
        _feed(rng, pairs, rs, ps, engines, t, spotty=(step // 6) % 2 == 1)
        a, b = ref.sample(now=t), port.sample(now=t)
        _assert_signals_equal(a, b)
        if b is not None:
            stale_seen += b.stale
            fresh_seen += not b.stale
    assert stale_seen and fresh_seen


def test_collector_reads_names_the_ports_picker_writes():
    names = {m.name for m in own_metrics.REGISTRY}
    assert signals._READ <= names
    for name in (signals._PICKS, signals._QUEUE_SHED, signals._FLOW_DEPTH):
        assert name in names
    for name in (signals._DEVICE_WAIT_SUM, signals._HOST_ASSEMBLY_SUM):
        assert name[:-len("_sum")] in names


def _signal_program(mod):
    """A seeded program of PoolSignals exercising every recommender
    branch; built from the same numbers in each package."""
    rng = np.random.default_rng(7)
    out, t, ready = [], T0, 4
    phases = ([("idle", 4)] + [("shed", 8)] + [("grown", 4)]
              + [("quiet", 40)] + [("stale", 3)] + [("quiet", 4)])
    for kind, n in phases:
        for _ in range(n):
            t += 1.0
            admitted = float(rng.integers(10, 30))
            shed = float(rng.integers(5, 15)) if kind == "shed" else 0.0
            if kind == "grown":
                ready = 6
            if kind == "quiet":
                admitted = float(rng.integers(0, 3))
            out.append(mod.PoolSignals(
                at=t, window_s=1.0, ready_replicas=ready,
                queue_depth_total=float(rng.integers(0, 40)),
                kv_cache_util_mean=float(rng.uniform(0, 1)),
                saturated_fraction=(0.75 if kind == "shed"
                                    else float(rng.uniform(0, 0.4))),
                flow_queue_depth=0.0, admitted_per_s=admitted,
                shed_per_s=shed, shed_per_s_by_band={"sheddable": shed},
                evict_per_s=0.0, pipeline_occupancy=0.5,
                device_wait_share=0.1, metrics_age_max_s=0.1,
                stale=kind == "stale"))
    return out


def _run_recommender(rec_mod, model_mod, sig_mod, min_replicas=2):
    rec = rec_mod.AutoscaleRecommender(
        rec_mod.RecommenderConfig(min_replicas=min_replicas, max_replicas=9,
                                  shed_high_per_s=0.5, up_sustain_s=2.0,
                                  down_cooldown_s=10.0),
        model=model_mod.CapacityModel())
    out, current = [], 4
    for sig in _signal_program(sig_mod):
        r = rec.observe(sig, current, now=sig.at,
                        predicted_ttft_s=2.0 if sig.at % 7 == 0 else None,
                        ttft_slo_s=1.5)
        out.append((r.at, r.current, r.desired, r.reason, r.direction,
                    rec.model.per_replica(), rec.model.converged))
        current = r.desired
    # Scale-from-zero: an empty pool, then a wake arrival.
    zero = dataclasses.replace(_signal_program(sig_mod)[0],
                               ready_replicas=0, admitted_per_s=0.0)
    rec0 = rec_mod.AutoscaleRecommender(rec_mod.RecommenderConfig(
        min_replicas=0, max_replicas=3))
    for wake in (0, 2):
        r = rec0.observe(dataclasses.replace(zero, wake_arrivals=wake), 0,
                         now=T0)
        out.append((r.desired, r.reason))
    r = rec.observe(None, 5, now=T0 + 999)
    out.append((r.desired, r.reason))
    return out


def test_model_and_recommender_match_the_reference():
    port = _run_recommender(recommender, model, signals)
    ref = _run_recommender(ref_recommender, ref_model, ref_signals)
    assert port == ref
    directions = {row[4] for row in port if len(row) == 7}
    assert directions == {"up", "down", "hold"}
    reasons = " ".join(str(row[3] if len(row) == 7 else row[1])
                       for row in port)
    for want in ("sustained", "utilization", "hold-stale", "wake-from-zero"):
        assert want in reasons


def test_controller_matches_the_reference():
    rng, pairs, rs, ps, engines, ref_col, port_col = _collectors(5)
    ref_rec = ref_recommender.AutoscaleRecommender(
        ref_recommender.RecommenderConfig(min_replicas=2, max_replicas=20))
    port_rec = recommender.AutoscaleRecommender(
        recommender.RecommenderConfig(min_replicas=2, max_replicas=20))
    ref_ctl = ref_controller.AutoscaleController(
        ref_col, ref_rec,
        ref_actuator.ReplicaActuator(None, "default", None, dry_run=True))
    port_ctl = controller.AutoscaleController(
        port_col, port_rec,
        actuator.ReplicaActuator(None, "default", None, dry_run=True))
    t = T0
    recs = 0
    for _ in range(25):
        t += 1.0
        _feed(rng, pairs, rs, ps, engines, t)
        a, b = ref_ctl.step(now=t), port_ctl.step(now=t)
        assert (a is None) == (b is None)
        if b is None:
            continue
        recs += 1
        assert (b.at, b.current, b.desired, b.reason) == (
            a.at, a.current, a.desired, a.reason)
        for port_g, ref_g in (
                (own_metrics.AUTOSCALE_DESIRED, ref_metrics.AUTOSCALE_DESIRED),
                (own_metrics.AUTOSCALE_CURRENT, ref_metrics.AUTOSCALE_CURRENT),
                (own_metrics.AUTOSCALE_CAPACITY,
                 ref_metrics.AUTOSCALE_CAPACITY),
                (own_metrics.AUTOSCALE_SHED_RATE,
                 ref_metrics.AUTOSCALE_SHED_RATE),
                (own_metrics.AUTOSCALE_STALE, ref_metrics.AUTOSCALE_STALE)):
            assert port_g.value() == ref_g._value.get(), port_g.name
    assert recs >= 20
    assert own_metrics.AUTOSCALE_RECS.value("hold") > 0


def test_capacity_model_persists_as_npz(tmp_path):
    m = model.CapacityModel()
    m.save(str(tmp_path / "cold"))
    assert sorted(os.listdir(tmp_path / "cold")) == ["pytree.npz"]
    fresh = model.CapacityModel()
    assert fresh.restore(str(tmp_path / "cold")) and not fresh.converged
    m._ewma = 17.25
    m.save(str(tmp_path / "warm"))
    fresh = model.CapacityModel()
    assert fresh.restore(str(tmp_path / "warm"))
    assert fresh.per_replica() == np.float32(17.25)
    # Missing, orbax-shaped (no .npz) and corrupt directories restore as
    # False and never raise.
    assert not fresh.restore(str(tmp_path / "missing"))
    (tmp_path / "orbax" / "d").mkdir(parents=True)
    (tmp_path / "orbax" / "_METADATA").write_text("{}")
    assert not fresh.restore(str(tmp_path / "orbax"))
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "pytree.npz").write_bytes(b"not a zip")
    assert not fresh.restore(str(tmp_path / "bad"))
    assert fresh.per_replica() == np.float32(17.25)   # kept
    # Its digest section installs into the reference's model, and back.
    ref = ref_model.CapacityModel()
    assert ref.install_state(m.export_state())
    assert ref.per_replica() == m.per_replica()
    back = model.CapacityModel()
    assert back.install_state(ref.export_state())
    assert back.per_replica() == ref.per_replica()
    assert not back.install_state({})


def test_actuator_dry_run_matches_the_reference():
    cases = []
    for mod in (actuator, ref_actuator):
        rec_mod = recommender if mod is actuator else ref_recommender
        out = []
        for dry_run in (True, False):
            for leader in (None, True, False):
                act = mod.ReplicaActuator(
                    None, "ns", "deploy", dry_run=dry_run,
                    is_leader=None if leader is None else (lambda v=leader: v))
                for current, desired in ((3, 3), (3, 5), (3, 2)):
                    out.append(act.apply(rec_mod.Recommendation(
                        T0, current, desired, "r")))
                out.append(act.current_replicas())
        cases.append(out)
    assert cases[0] == cases[1]
    assert {"noop", "dry_run", "not_leader", "no_target"} == set(
        c for c in cases[0] if c is not None)
    # A kube client is taken (the kube slice): the actuator writes to it.
    client = object()
    assert actuator.ReplicaActuator(client, "ns", "deploy").client is client


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _options(argv):
    import argparse

    from gie_tpu_torch.runtime.options import Options

    parser = argparse.ArgumentParser()
    Options.add_flags(parser)
    return Options.from_args(parser.parse_args(argv))


def test_runner_builds_and_serves_with_autoscale_replication_and_lease(
        tmp_path):
    import grpc

    from gie_tpu_torch.controller import FakeCluster
    from gie_tpu_torch.extproc.pb import health_pb2
    from gie_tpu_torch.runtime.health import SERVING
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner
    from gie_tpu_torch.sched import Scheduler

    ports = [_free_port() for _ in range(4)]
    opts = _options([
        "--pool-name", "p", "--insecure-serving", "--no-resilience",
        "--no-obs", "--grpc-port", str(ports[0]),
        "--grpc-health-port", str(ports[1]), "--metrics-port", str(ports[2]),
        "--autoscale-mode", "recommend", "--replication-port", str(ports[3]),
        "--leader-elect", "--leader-lease-path", str(tmp_path / "lease"),
        "--autoscale-state-dir", str(tmp_path / "cap")])
    runner = ExtProcServerRunner(opts, FakeCluster(),
                                 scheduler=Scheduler(device="cpu"))
    runner.picker.background_warm = False
    assert runner.elector.identity.endswith(f"|127.0.0.1:{ports[3]}")
    assert runner.replication.capacity_model is runner.capacity_model

    def health(service):
        with grpc.insecure_channel(f"127.0.0.1:{ports[1]}") as chan:
            rpc = chan.unary_unary(
                "/grpc.health.v1.Health/Check",
                request_serializer=health_pb2.HealthCheckRequest
                .SerializeToString,
                response_deserializer=health_pb2.HealthCheckResponse
                .FromString)
            return rpc(health_pb2.HealthCheckRequest(service=service),
                       timeout=10).status

    try:
        runner.setup()
        runner.start()
        deadline = time.monotonic() + 10
        while not runner.elector.is_leader() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert runner.elector.is_leader()
        assert health("replication") == SERVING
        runner.autoscaler.step(now=T0)             # the baseline window
        runner.autoscaler.step(now=T0 + 1.0)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ports[2]}/metrics", timeout=10) as r:
            text = r.read().decode()
        for family in ("gie_autoscale_desired_replicas",
                       "gie_autoscale_recommendations_total",
                       "gie_replication_role"):
            assert family in text, family
    finally:
        runner.stop()
    assert os.path.exists(tmp_path / "cap" / "pytree.npz")   # leader saved
    assert not os.path.exists(tmp_path / "lease")            # released


@pytest.mark.parametrize("argv, what", [
    (["--autoscale-mode", "apply"], "--autoscale-mode apply"),
    (["--leader-elect"], "KubeLeaseElector"),
])
def test_runner_refuses_the_kube_slices_actuation_and_lease(argv, what):
    """The kube slice is ported: over a kube cluster client the runner
    builds the writing actuator and the Lease elector it used to refuse
    (construction calls the apiserver for neither)."""
    from gie_tpu_torch.controller import FakeCluster
    from gie_tpu_torch.runtime.leader import KubeLeaseElector
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner
    from gie_tpu_torch.sched import Scheduler

    class KubeCluster(FakeCluster):
        def _json(self, method, path, body=None):
            raise AssertionError("never called")

    opts = _options(["--pool-name", "p", "--no-resilience", "--no-obs"]
                    + argv)
    cluster = KubeCluster()
    runner = ExtProcServerRunner(opts, cluster,
                                 scheduler=Scheduler(device="cpu"))
    try:
        if what == "KubeLeaseElector":
            assert isinstance(runner.elector, KubeLeaseElector)
            assert runner.elector.client is cluster
        else:
            actuator = runner.autoscaler.actuator
            assert actuator.client is cluster and not actuator.dry_run
    finally:
        runner.stop()
