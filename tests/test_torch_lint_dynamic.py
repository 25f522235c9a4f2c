"""The port's dynamic lock-order confirmer: the tracker's own behaviour,
then real port traffic against the port's lockorder.toml: the scrape
engine and store, the ext-proc worker pool's lifecycle lock, and the CPU
Scheduler's _lock -> _queue_lock nesting through apply_prefix_events and
evict_endpoint, each asserting the expected nestings were OBSERVED so
the consistency check cannot pass vacuously."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from gie_tpu_torch.lint.dynamic import LockTracker, TrackedLock, default_ranks

P = "gie_tpu_torch."
ENGINE_LOCK = P + "metricsio.engine.ScrapeEngine._lock"
STORE_LOCK = P + "metricsio.store.MetricsStore._lock"
SCHED_LOCK = P + "sched.profile.Scheduler._lock"
QUEUE_LOCK = P + "sched.profile.Scheduler._queue_lock"
WARM_LOCK = P + "sched.profile.Scheduler._warm_lock"


class _Box:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()


def test_tracker_records_inversion_and_order():
    tracker = LockTracker(ranks={"t.a": 10, "t.b": 20})
    box = _Box()
    tracker.wrap(box, "a", "t.a")
    tracker.wrap(box, "b", "t.b")
    with box.a:
        with box.b:
            pass
    assert tracker.violations == []
    assert ("t.a", "t.b") in tracker.observed()
    with box.b:
        with box.a:
            pass
    assert [(v.outer, v.inner) for v in tracker.violations] == [
        ("t.b", "t.a")]
    with pytest.raises(AssertionError, match="rank inversion"):
        tracker.assert_consistent()


def test_tracker_is_per_thread():
    tracker = LockTracker(ranks={"t.a": 10, "t.b": 20})
    box = _Box()
    tracker.wrap(box, "a", "t.a")
    tracker.wrap(box, "b", "t.b")
    barrier = threading.Barrier(2)

    def hold_b():
        with box.b:
            barrier.wait()
            barrier.wait()

    t = threading.Thread(target=hold_b)
    t.start()
    barrier.wait()
    with box.a:
        pass
    barrier.wait()
    t.join()
    tracker.assert_consistent()
    assert tracker.observed() == set()


def test_tracked_lock_delegates_condition_api_and_is_idempotent():
    tracker = LockTracker(ranks={"t.c": 10, "t.a": 20})
    holder = type("H", (), {})()
    holder.c = threading.Condition()
    first = tracker.wrap(holder, "c", "t.c")
    assert isinstance(holder.c, TrackedLock)
    assert tracker.wrap(holder, "c", "t.c") is first
    with holder.c:
        holder.c.wait(0.01)
        holder.c.notify_all()
    assert holder.c.acquire(timeout=1)
    holder.c.release()
    tracker.assert_consistent()


def test_default_ranks_load_the_port_hierarchy():
    ranks = default_ranks()
    assert ranks[ENGINE_LOCK] < ranks[STORE_LOCK]
    assert ranks[WARM_LOCK] < ranks[SCHED_LOCK] < ranks[QUEUE_LOCK]
    assert all(name.startswith(P) for name in ranks)


def test_engine_store_traffic_matches_declared_hierarchy():
    from gie_tpu_torch.metricsio.engine import ScrapeEngine
    from gie_tpu_torch.metricsio.mappings import BY_NAME
    from gie_tpu_torch.metricsio.store import MetricsStore

    store = MetricsStore()
    payload = (b"vllm:num_requests_running 2.0\n"
               b"vllm:num_requests_waiting 1.0\n"
               b"vllm:gpu_cache_usage_perc 0.5\n")
    engine = ScrapeEngine(store, interval_s=0.01, workers=2,
                          fetcher=lambda url: payload)
    tracker = LockTracker(ranks=default_ranks())
    tracker.wrap(engine, "_lock", ENGINE_LOCK)
    tracker.wrap(store, "_lock", STORE_LOCK)
    try:
        for slot in range(8):
            engine.attach(slot, f"http://127.0.0.{slot + 1}:9400/metrics",
                          BY_NAME["vllm"])
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            store.pool_rows(list(range(8)))
            engine.staleness_seconds()
            if ((ENGINE_LOCK, STORE_LOCK) in tracker.observed()
                    and store.pool_rows([0])[0].sum() > 0):
                break
            time.sleep(0.02)
        engine.detach(3)
    finally:
        engine.close()
    tracker.assert_consistent()
    observed = tracker.observed()
    assert (ENGINE_LOCK, STORE_LOCK) in observed, sorted(observed)
    assert (STORE_LOCK, ENGINE_LOCK) not in observed


def test_worker_pool_lifecycle_lock_stays_off_the_dispatch_path():
    """Streams through a 2-acceptor SO_REUSEPORT pool with the pool's
    lifecycle lock and the datastore lock tracked: no nesting involving
    the pool lock may be observed while traffic flows."""
    import grpc

    from gie_tpu_torch.datastore import Datastore
    from gie_tpu_torch.datastore.objects import EndpointPool, Pod
    from gie_tpu_torch.extproc.server import RoundRobinPicker, StreamingServer
    from gie_tpu_torch.extproc.workers import ExtProcWorkerPool
    from tests.test_extproc_wire import GOLDEN_REQUEST_HEADERS

    pool_lock = P + "extproc.workers.ExtProcWorkerPool._lock"
    ds_lock = P + "datastore.datastore.Datastore._lock"
    ds = Datastore()
    ds.pool_set(EndpointPool({"app": "v"}, [8000], "default"))
    for i in range(3):
        ds.pod_update_or_add(Pod(name=f"p{i}", labels={"app": "v"},
                                 ip=f"127.0.0.{i + 1}"))
    streaming = StreamingServer(ds, RoundRobinPicker(), fast_lane=True)
    pool = ExtProcWorkerPool(streaming, 2, wire=True)
    tracker = LockTracker(ranks=default_ranks())
    tracker.wrap(pool, "_lock", pool_lock)
    tracker.wrap(ds, "_lock", ds_lock)
    port = pool.bind("127.0.0.1:0")
    pool.start()
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        process = channel.stream_stream(
            "/envoy.service.ext_proc.v3.ExternalProcessor/Process",
            request_serializer=lambda b: b, response_deserializer=lambda b: b)
        for _ in range(10):
            assert len(list(process(iter([GOLDEN_REQUEST_HEADERS]),
                                    timeout=30))) == 1
        channel.close()
    finally:
        pool.stop(grace=2.0).wait(5)
    tracker.assert_consistent()
    for outer, inner in tracker.observed():
        assert pool_lock not in (outer, inner), (outer, inner)


def test_scheduler_queue_lock_nests_inside_the_scheduler_lock():
    """The CPU Scheduler under threads: KV events (apply_prefix_events),
    evictions and waves beside each other, with _warm_lock, _lock and
    _queue_lock tracked; the _lock -> _queue_lock nesting is observed and
    no inversion is."""
    from gie_tpu_torch.sched import Scheduler
    from gie_tpu_torch.sched.config import tuned_profile
    from gie_tpu_torch.utils.testing import make_endpoints, make_requests

    sched = Scheduler(*tuned_profile(), device="cpu")
    tracker = LockTracker(ranks=default_ranks())
    for attr, name in (("_lock", SCHED_LOCK), ("_queue_lock", QUEUE_LOCK),
                       ("_warm_lock", WARM_LOCK)):
        tracker.wrap(sched, attr, name)
    m = 64
    eps = make_endpoints(m, queue=[float(i % 5) for i in range(m)],
                         m_slots=m, device="cpu")
    rng = np.random.default_rng(0)
    errors = []

    def events(k):
        try:
            for i in range(6):
                sched.apply_prefix_events(
                    (k + i) % m, rng.integers(1, 2**32, 8, dtype=np.uint64)
                    .astype(np.uint32), np.zeros(0, np.uint32))
        except Exception as e:      # reported by the assertion below
            errors.append(e)

    def evictions():
        try:
            for slot in range(0, m, 3):
                sched.evict_endpoint(slot)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=events, args=(k,)) for k in range(3)]
    threads.append(threading.Thread(target=evictions))
    for t in threads:
        t.start()
    for w in range(2):
        reqs = make_requests(8, prompts=[b"p%d" % (w * 8 + i)
                                         for i in range(8)],
                             m_slots=m, device="cpu")
        sched.pick(reqs, eps)
    for t in threads:
        t.join(60)
    assert errors == []
    tracker.assert_consistent()
    observed = tracker.observed()
    assert (SCHED_LOCK, QUEUE_LOCK) in observed, sorted(observed)
    assert (QUEUE_LOCK, SCHED_LOCK) not in observed
