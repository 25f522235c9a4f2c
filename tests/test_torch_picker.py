"""The port's pick service against the reference on the CPU.

gie_tpu_torch's BatchingTPUPicker, assemble_wave, MetricsStore, Datastore
and fairness order side by side with gie_tpu's, fed the same inputs made
from a numpy seed. The port's Scheduler runs with device="cpu"; the JAX
Scheduler's Gumbel draws are replayed into it through `noise_source`
(`jax_noise_replay`), so picks compare exactly.

Tolerances: integer, bool and endpoint outputs exact (RequestBatch
fields, metric snapshots, datastore tables, primaries and fallbacks,
error kinds and status names, prefix-table words and counters); u32 chunk
hashes compared as uint32 at the boundary; the float state of
export_state (assumed_load, ot_v) within atol=1e-5, as
tests/test_torch_slice.py holds it.

Every wave keeps its prompts in one chunk bucket (8 lanes) and its
endpoints in one M bucket (64), so JAX compiles once per configuration.
"""

import dataclasses
import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from gie_tpu_torch import convert
from gie_tpu_torch.api.types import ACTIVE_PORTS_ANNOTATION, ROLE_LABEL
from gie_tpu_torch.extproc import metadata as mdkeys
from gie_tpu_torch.runtime.metrics import PIPELINE_WAVES
from gie_tpu_torch.sched import constants as C
from tests.test_torch_slice import _assert_states, jax_noise_replay

SEED = 5
NOW = 1000.0
PODS = 40
MB = 64
ADAPTERS = [f"adapter-{k}" for k in range(12)]
BASE = b"SYSTEM: You are a helpful assistant specialised in task %d. "
BANDS = ["", "critical", "standard", "sheddable"]
CONFIGS = ["tuned-sinkhorn-kernel", "topk-kernel", "default"]


class _Side:
    """One package's pick-service classes under common names."""

    def __init__(self, pkg: str):
        def mod(name):
            return importlib.import_module(f"{pkg}.{name}")

        batching = mod("sched.batching")
        server = mod("extproc.server")
        objects = mod("datastore.objects")
        fairness = mod("fairness")
        sched = mod("sched")
        self.jax = pkg == "gie_tpu"
        self.Picker = batching.BatchingTPUPicker
        self.Pending = batching._Pending
        self.assemble_wave = batching.assemble_wave
        self.fair_order = batching._fair_order
        self.PickRequest = server.PickRequest
        self.ShedError = server.ShedError
        self.ExtProcError = server.ExtProcError
        self.Datastore = mod("datastore").Datastore
        self.Pod, self.EndpointPool = objects.Pod, objects.EndpointPool
        self.MetricsStore = mod("metricsio").MetricsStore
        self.FairnessState = fairness.FairnessState
        self.FairnessConfig = fairness.FairnessConfig
        self.DeadlineExceeded = mod("resilience.deadline").DeadlineExceeded
        self.LoraRegistry = mod("utils.lora").LoraRegistry
        self.Scheduler, self.ProfileConfig = sched.Scheduler, sched.ProfileConfig
        self.tuned_profile = mod("sched.config").tuned_profile

    def scheduler(self, config: str):
        if config == "tuned-sinkhorn-kernel":
            cfg, w = self.tuned_profile()
            cfg = dataclasses.replace(cfg, use_pallas_sinkhorn=True)
        elif config == "topk-kernel":
            cfg, w = self.ProfileConfig(picker="topk", use_pallas_topk=True), None
        else:
            cfg, w = self.ProfileConfig(), None
        if self.jax:
            return self.Scheduler(cfg, w, seed=SEED)
        return self.Scheduler(cfg, w, device="cpu",
                              noise_source=jax_noise_replay(SEED))


JAX, TORCH = _Side("gie_tpu"), _Side("gie_tpu_torch")
SIDES = (JAX, TORCH)


def _code(err) -> str:
    """A status by its gRPC name: grpc.StatusCode in the reference, the
    name itself in the port."""
    return getattr(err.code, "name", err.code)


def _request(side, i: int, **kw):
    """Request i of the mix: four bands, three tenants, base model or one
    of twelve adapters, five shared system prompts (~380 bytes: one chunk
    bucket), a decode hint."""
    rng = np.random.default_rng(1000 + i)
    headers = {mdkeys.FLOW_FAIRNESS_ID_KEY: [f"tenant-{i % 3}"]}
    if BANDS[i % 4]:
        headers[mdkeys.OBJECTIVE_KEY] = [BANDS[i % 4]]
    model = "" if i % 3 == 0 else ADAPTERS[int(rng.integers(0, 12))]
    body = (BASE % (i % 5)) * 6 + b"user question %d" % i
    return side.PickRequest(headers=headers, body=body, model=model,
                            decode_tokens=float(rng.integers(0, 300)), **kw)


def _stack(side, config: str, queue=None, **picker_kw):
    """Scheduler + MetricsStore + Datastore (one pool, PODS ready pods) +
    BatchingTPUPicker, with scraped rows from the seed (or `queue`)."""
    sched = side.scheduler(config)
    ms = side.MetricsStore(clock=lambda: NOW)
    ds = side.Datastore(on_slot_reclaimed=lambda s: (sched.evict_endpoint(s),
                                                     ms.remove(s)),
                        clock=lambda: NOW)
    ds.pool_set(side.EndpointPool({"app": "x"}, [8000], "default"))
    for i in range(PODS):
        ds.pod_update_or_add(side.Pod(name=f"p{i}", labels={"app": "x"},
                                      ip=f"10.9.0.{i + 1}"))
    registry = side.LoraRegistry()
    for name in ADAPTERS:
        registry.id_for(name)
    rng = np.random.default_rng(SEED)
    rows = []
    for ep in ds.endpoints():
        q = float(rng.integers(0, 50)) if queue is None else queue
        rows.append((ep.slot, {C.Metric.QUEUE_DEPTH: q,
                               C.Metric.KV_CACHE_UTIL: float(rng.uniform(0, 0.95)),
                               C.Metric.MAX_LORA: 8.0},
                     [registry.id_for(ADAPTERS[j])
                      for j in rng.integers(0, 12, 2)], ()))
    ms.update_rows(rows, now=NOW)
    picker_kw.setdefault("max_wait_s", 0.0005)
    picker = side.Picker(sched, ds, ms, lora_registry=registry, **picker_kw)
    return SimpleNamespace(sched=sched, ds=ds, picker=picker)


def _outcome(side, call) -> tuple:
    """What a pick came to, comparable across the two packages."""
    try:
        res = call()
    except side.ShedError as e:
        return ("shed", e.band, e.tenant)
    except side.DeadlineExceeded as e:
        return ("deadline", str(e))
    except side.ExtProcError as e:
        return ("error", _code(e), e.message)
    return ("ok", res.endpoint, tuple(res.fallbacks), res.charged_slot,
            round(res.assumed_cost, 6))


def _item_outcome(side, item) -> tuple:
    def call():
        if item.error is not None:
            raise item.error
        return item.result
    return _outcome(side, call)


# -- (a) wave assembly ----------------------------------------------------


@pytest.mark.parametrize("n", [1, 9, 64])
def test_assemble_wave_fields_equal(n):
    """Same PickRequests and candidate slots (subsets, slots past the M
    bucket, unrouted -1 slots) -> every RequestBatch field equal."""
    rng = np.random.default_rng(n)
    cands = []
    for i in range(n):
        slots = rng.choice(MB + 8, size=int(rng.integers(1, 20)),
                           replace=False).tolist() + [-1]
        cands.append([SimpleNamespace(slot=int(s)) for s in slots])
    out = []
    for side in SIDES:
        items = [side.Pending(_request(side, i), cands[i]) for i in range(n)]
        out.append(side.assemble_wave(items, MB, side.LoraRegistry()))
    (jreqs, *jhost), (treqs, *thost) = out
    port = convert.requests_to_numpy(treqs)
    for f in dataclasses.fields(treqs):
        ref = np.asarray(getattr(jreqs, f.name))
        assert port[f.name].dtype == ref.dtype, f.name
        np.testing.assert_array_equal(port[f.name], ref, err_msg=f.name)
    for j, t in zip(jhost, thost):
        assert j.dtype == t.dtype
        np.testing.assert_array_equal(t, j)


# -- (b) metrics store ----------------------------------------------------


def test_metrics_store_snapshots_equal():
    """The same update / update_rows / remove sequence with explicit
    clocks -> equal EndpointBatch arrays, queue columns and pool rows."""
    rng = np.random.default_rng(SEED)
    roles = ["prefill", "decode", "both", ""]
    eps = [SimpleNamespace(slot=s, labels={ROLE_LABEL: roles[s % 4]})
           for s in range(0, MB, 3)]
    ops = []
    for step in range(12):
        slot = int(rng.integers(0, MB))
        row = {C.Metric.QUEUE_DEPTH: float(rng.integers(0, 50)),
               C.Metric.KV_CACHE_UTIL: float(rng.uniform(0, 1)),
               C.Metric.RUNNING_REQUESTS: float(rng.integers(0, 9))}
        active = rng.integers(1, 12, int(rng.integers(0, 6))).tolist()
        if step % 3 == 0:
            ops.append(("update", (slot, row, active, [3]), NOW + step))
        elif step % 3 == 1:
            rows = [(int(s), row, active, ()) for s in rng.integers(0, MB, 4)]
            ops.append(("update_rows", (rows,), NOW + step))
        else:
            ops.append(("remove", (slot,), None))
    stores = [side.MetricsStore(clock=lambda: NOW) for side in SIDES]
    for name, args, now in ops:
        for store in stores:
            kw = {} if now is None else {"now": now}
            getattr(store, name)(*args, **kw)
        jb, tb = (s.endpoint_batch(eps, now=NOW + 20, m_slots=MB)
                  for s in stores)
        for f in dataclasses.fields(tb):
            ref = np.asarray(getattr(jb, f.name))
            port = getattr(tb, f.name)
            assert port.device.type == "cpu"
            assert port.numpy().dtype == ref.dtype, f.name
            np.testing.assert_array_equal(port.numpy(), ref, err_msg=f.name)
        np.testing.assert_array_equal(stores[1].host_queue_depths(),
                                      stores[0].host_queue_depths())
        jrows, jages = stores[0].pool_rows(range(MB), now=NOW + 20)
        trows, tages = stores[1].pool_rows(range(MB), now=NOW + 20)
        np.testing.assert_array_equal(trows, jrows)
        np.testing.assert_array_equal(tages, jages)


# -- (c) datastore --------------------------------------------------------


@pytest.mark.parametrize("ports", [[8000], [8000, 8001]])
def test_datastore_sequence_equal(ports):
    """The same pod add / update / ready-flip / drain / delete / resync
    sequence -> equal endpoints(), pick_candidates(), slot maps and
    on_slot_reclaimed calls. A ready flip goes where the pod reconciler
    sends it: a NotReady pod that serves is drained."""
    t = {"now": NOW}
    logs, stores, pods = [], [], [{}, {}]
    for side in SIDES:
        log = []
        ds = side.Datastore(on_slot_reclaimed=log.append,
                            clock=lambda: t["now"], drain_deadline_s=5.0)
        ds.pool_set(side.EndpointPool({"app": "x"}, ports, "default"))
        logs.append(log)
        stores.append(ds)

    steps = [
        *[("add", i, {}) for i in range(6)],
        ("add", 1, {"labels": {"app": "x", "v": "2"}}),
        ("add", 2, {"ready": False}),
        ("add", 3, {"annotations": {ACTIVE_PORTS_ANNOTATION: "8001"}}),
        ("add", 2, {}),
        ("add", 4, {"labels": {"app": "y"}}),
        ("add", 5, {"ready": False}),
        ("add", 6, {}),
        ("tick", 10.0, {}),
        ("add", 7, {}),
        ("delete", 0, {}),
        ("add", 8, {}),
        ("drain", 1, {}),
        ("add", 1, {}),
        ("add", 8, {"ready": False}),
        ("resync", 0, {}),
    ]

    def view(ds, log):
        def rows(eps):
            return [dataclasses.asdict(ep) for ep in eps]
        return (rows(ds.endpoints()), rows(ds.pick_candidates()),
                ds.slot_map(), ds.draining_count(), ds.overflow_count(),
                list(log))

    for op, i, kw in steps:
        for side, ds, known in zip(SIDES, stores, pods):
            if op == "add":
                kw.setdefault("labels", {"app": "x", "v": "1"})
                pod = side.Pod(name=f"p{i}", ip=f"10.1.0.{i + 1}", **kw)
                known[pod.name] = pod
                if pod.ready:
                    ds.pod_update_or_add(pod)
                else:
                    assert ds.pod_mark_draining("default", pod.name)
            elif op == "drain":
                assert ds.pod_mark_draining("default", f"p{i}")
            elif op == "delete":
                ds.pod_delete("default", f"p{i}")
                known.pop(f"p{i}")
            elif op == "resync":
                ds.pool_set(side.EndpointPool({"app": "x"}, ports + [9000],
                                              "default"),
                            pod_lister=lambda known=known: list(known.values()))
        if op == "tick":
            t["now"] += i
            for ds in stores:
                ds.reap_expired_drains()
        assert view(stores[1], logs[1]) == view(stores[0], logs[0]), (op, i)
    assert len(logs[1]) >= 3      # drains reaped, deletes and resync evicted


# -- (d) fairness order ---------------------------------------------------


def test_fair_order_and_fairness_state_agree():
    """_fair_order and a weighted FairnessState (its deficits carried over
    three drains) order a mixed-tenant, mixed-band list identically."""
    rng = np.random.default_rng(SEED)
    spec = [(int(rng.integers(0, 4)), int(rng.integers(0, 5)),
             int(rng.integers(1, 40)), float(rng.integers(0, 500)))
            for _ in range(60)]

    def items(side):
        out = []
        for band, tenant, reps, dec in spec:
            headers = {mdkeys.FLOW_FAIRNESS_ID_KEY: [f"t{tenant}"]}
            if BANDS[band]:
                headers[mdkeys.OBJECTIVE_KEY] = [BANDS[band]]
            req = side.PickRequest(headers=headers, body=b"x" * (50 * reps),
                                   decode_tokens=dec)
            out.append(side.Pending(req, []))
        return out

    orders = []
    for side in SIDES:
        its = items(side)
        index = {id(it): k for k, it in enumerate(its)}
        seq = [[index[id(it)] for it in side.fair_order(its)]]
        state = side.FairnessState(
            side.FairnessConfig(weights={"t0": 3.0, "t2": 0.5}),
            clock=lambda: NOW)
        pending = its
        for _ in range(3):
            pending = state.order(pending, take=16)
            seq.append([index[id(it)] for it in pending])
            pending = pending[16:]
        seq.append(sorted(state.report()["deficits"].items()))
        orders.append(seq)
    assert orders[1] == orders[0]
    assert sorted(orders[0][0]) == list(range(60))


# -- (e) end to end, sequential picks ------------------------------------


@pytest.mark.parametrize("config", CONFIGS)
def test_pickers_agree_over_sequential_picks(config):
    """48 sequential one-request waves through both BatchingTPUPickers with
    carried state and served feedback on every other pick: equal
    outcomes (primary, fallbacks, charge) and equal export_state()."""
    stacks = [_stack(side, config) for side in SIDES]
    waves = PIPELINE_WAVES.value()
    try:
        outcomes = ([], [])
        for i in range(48):
            for side, st, out in zip(SIDES, stacks, outcomes):
                req = _request(side, i)
                res = []

                def call(st=st, req=req, res=res):
                    res.append(st.picker.pick(req, st.ds.pick_candidates()))
                    return res[0]

                out.append(_outcome(side, call))
                if res and i % 2 == 0:
                    st.picker.observe_served(res[0].endpoint, SimpleNamespace(
                        pick_result=res[0], resp_status=200, picked_at=0.0,
                        headers=req.headers))
        assert outcomes[1] == outcomes[0]
        assert sum(o[0] == "ok" for o in outcomes[0]) >= 40
        assert PIPELINE_WAVES.value() - waves == 48      # one wave a pick
        _assert_states(stacks[0].sched.export_state(),
                       stacks[1].sched.export_state())
    finally:
        for st in stacks:
            st.picker.close()


# -- (f) one wave of eight, fixed order -----------------------------------


def test_one_wave_through_run_batch_agrees():
    """Eight requests in a fixed order (some on a five-endpoint subset)
    dispatched as one wave through each picker's _run_batch: equal
    results. Concurrent pick() would not fix the order of the wave."""
    stacks = [_stack(side, "tuned-sinkhorn-kernel") for side in SIDES]
    try:
        results = []
        for side, st in zip(SIDES, stacks):
            cands = st.ds.pick_candidates()
            items = [side.Pending(_request(side, i),
                                  cands if i % 3 else cands[:5])
                     for i in range(8)]
            assert st.picker._run_batch(items) == []
            assert all(it.event.wait(60) for it in items)
            results.append([_item_outcome(side, it) for it in items])
        assert results[1] == results[0]
        assert all(o[0] == "ok" for o in results[0])
        _assert_states(stacks[0].sched.export_state(),
                       stacks[1].sched.export_state())
    finally:
        for st in stacks:
            st.picker.close()


# -- (g) error paths ------------------------------------------------------


def _queue_bound_overflow(side, st) -> list:
    """A wedged dispatcher holds one wave; one more pick fills the queue
    (queue_bound=1); a third same-band pick sheds at once."""
    gate, entered = threading.Event(), threading.Event()

    def wedged(batch):
        entered.set()
        gate.wait(10)
        return []

    st.picker._run_batch = wedged
    got = []
    first = threading.Thread(target=lambda: got.append(_outcome(
        side, lambda: st.picker.pick(_request(side, 2),
                                     st.ds.pick_candidates()))))
    first.start()
    assert entered.wait(10)
    second = threading.Thread(target=lambda: got.append(_outcome(
        side, lambda: st.picker.pick(_request(side, 2),
                                     st.ds.pick_candidates()))))
    second.start()
    deadline = time.monotonic() + 10
    while st.picker.queue_report()["depth"] < 1:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    t0 = time.monotonic()
    shed = _outcome(side, lambda: st.picker.pick(_request(side, 2),
                                                 st.ds.pick_candidates()))
    assert time.monotonic() - t0 < 1.0       # shed at once, never queued
    gate.set()
    first.join(10)
    second.join(10)
    assert not first.is_alive() and not second.is_alive()
    return [shed] + sorted(got)


@pytest.mark.parametrize("case", ["empty", "saturated-sheddable",
                                  "deadline", "queue-bound"])
def test_error_paths_match_reference(case):
    outs = []
    for side in SIDES:
        kw = {}
        if case == "saturated-sheddable":
            kw["queue"] = 1000.0
        if case == "queue-bound":
            kw.update(queue_bound=1, pick_timeout_s=0.5)
        st = _stack(side, "default", **kw)
        try:
            if case == "empty":
                out = _outcome(side, lambda: st.picker.pick(_request(side, 2), []))
            elif case == "saturated-sheddable":
                out = _outcome(side, lambda: st.picker.pick(
                    _request(side, 3), st.ds.pick_candidates()))
            elif case == "deadline":
                req = _request(side, 2, deadline_at=time.monotonic() - 1.0)
                out = _outcome(side, lambda: st.picker.pick(
                    req, st.ds.pick_candidates()))
            else:
                out = _queue_bound_overflow(side, st)
        finally:
            st.picker.close()
        outs.append(out)
    assert outs[1] == outs[0]
    want = {"empty": ("error", "UNAVAILABLE", "no endpoints available"),
            "saturated-sheddable": ("shed", int(C.Criticality.SHEDDABLE),
                                    "tenant-0"),
            "deadline": ("deadline", "request deadline exceeded at queue")}
    if case == "queue-bound":
        assert outs[0][0] == ("shed", int(C.Criticality.STANDARD), "tenant-2")
        assert [o[:2] for o in outs[0][1:]] == [("error", "UNAVAILABLE")] * 2
    else:
        assert outs[0] == want[case]
