"""The port's resilience layer against the reference on the CPU.

gie_tpu_torch's breaker board, degradation ladder, outlier ejector,
scenario files and the picker's resilience half (the rung gate, the
breaker candidate filter, the degraded rungs, dispatch and materialize
failures answered degraded, serve-outcome feedback) side by side with
gie_tpu's, driven by the same event sequences made from a numpy seed.

Clocks are injected (a shared fake clock for breakers, ladders and
ejectors), so dwell and probe decisions do not depend on how fast either
side runs. The two packages keep separate fault-injector and recorder
globals: each test installs the same seeded FaultInjector (same seed,
same rules) in both, and the autouse fixture uninstalls both.

Tolerances: every compared value is exact (states, reports, event logs,
transition timelines, picks, fallbacks, charged slots, record fields
except `ts` and `trace_id`), except `ranked` scores on the device path,
held within atol=2e-5 (the Sinkhorn lane tiebreak rewrites low mantissa
bits; tests/test_torch_slice.py).
"""

import ast
import importlib
import pathlib
import time

import numpy as np
import pytest

from tests.test_extproc_wire import (
    GOLDEN_REQUEST_HEADERS,
    header_map_bytes,
    header_value_bytes,
    http_headers_bytes,
    ld,
    metadata_context_bytes,
    struct_string_value,
    struct_with_field,
)
from tests.test_torch_picker import (
    NOW,
    SIDES,
    TORCH,
    _item_outcome,
    _outcome,
    _request,
    _stack,
)

PKGS = ("gie_tpu", "gie_tpu_torch")
REPO = pathlib.Path(__file__).resolve().parent.parent


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _clean_globals():
    for pkg in PKGS:
        _mod(pkg, "resilience.faults").uninstall()
        _mod(pkg, "obs").uninstall()
    yield
    for pkg in PKGS:
        _mod(pkg, "resilience.faults").uninstall()
        _mod(pkg, "obs").uninstall()


class _Clock:
    def __init__(self, t: float = NOW):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _rs(pkg: str, clk, static_subset: int = 4, board_cfg=None, **ladder_kw):
    """A ResilienceState of `pkg` on the fake clock `clk`."""
    breaker = _mod(pkg, "resilience.breaker")
    ladder = _mod(pkg, "resilience.ladder")
    board = breaker.BreakerBoard(
        breaker.BreakerConfig(**(board_cfg or {})), clock=clk)
    return ladder.ResilienceState(
        board=board,
        ladder=ladder.DegradationLadder(ladder.LadderConfig(**ladder_kw),
                                        clock=clk),
        static_subset=static_subset, on_change=lambda r: None)


def _strip(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in ("ts", "trace_id")}


# -- (a) breaker, ladder and ejector state machines -----------------------


def _breaker_ops(seed: int, n: int = 400) -> list:
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        key, r = int(rng.integers(0, 6)), rng.random()
        if r < 0.3:
            ops.append(("record", key, bool(rng.random() < 0.4)))
        elif r < 0.65:
            ops.append(("record_serve_outcome", key, bool(rng.random() < 0.5),
                        float(rng.uniform(0.0, 2.0))))
        elif r < 0.7:
            ops.append(("trip", key))
        elif r < 0.8:
            ops.append(("allow", key))
        elif r < 0.9:
            ops.append(("quarantined", key))
        elif r < 0.93:
            ops.append(("drop", key))
        else:
            ops.append(("tick", float(rng.uniform(0.0, 3.0))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_breaker_boards_equal(seed):
    """The same scrape/serve outcomes, trips, probes, drops and clock
    steps -> equal return values, states, open counts, event logs and
    report() after every step."""
    traces = []
    for pkg in PKGS:
        breaker = _mod(pkg, "resilience.breaker")
        clk = _Clock()
        board = breaker.BreakerBoard(breaker.BreakerConfig(
            open_after=3, open_s=2.0, close_after=2, serve_window_s=4.0,
            serve_min_samples=4), clock=clk)
        trace = []
        for op, *args in _breaker_ops(seed):
            if op == "tick":
                clk.t += args[0]
                ret = None
            else:
                ret = getattr(board, op)(*args)
            trace.append((op, ret, board.has_open, board.states(),
                          board.open_count(), board.report()))
        traces.append((trace, list(board.events)))
    assert traces[1] == traces[0]
    assert any(step[2] for step in traces[0][0])  # breakers did open


def _ladder_ops(seed: int, n: int = 400) -> list:
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.2:
            ops.append(("note_dispatch_error",))
        elif r < 0.4:
            ops.append(("note_dispatch_ok", float(rng.choice([0.01, 2.5]))))
        elif r < 0.5:
            ops.append(("note_metrics_staleness", float(rng.uniform(0, 9))))
        elif r < 0.7:
            ops.append(("note_serve_outcome", bool(rng.random() < 0.45)))
        elif r < 0.8:
            ops.append(("should_probe",))
        elif r < 0.82:
            ops.append(("force_level", int(rng.integers(0, 4))))
        else:
            ops.append(("tick", float(rng.uniform(0.0, 1.5))))
    return ops


LADDER_CFGS = {
    "defaults": {},
    "small": dict(dispatch_error_streak=2, recover_streak=2, min_dwell_s=1.0,
                  probe_interval_s=0.5, latency_breach_streak=3,
                  serve_min_samples=5, serve_window_s=4.0),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg", list(LADDER_CFGS))
def test_ladders_equal(cfg, seed):
    """The same dispatch outcomes, staleness readings, serve outcomes,
    probes and clock steps -> equal rungs, reports, probe grants and
    transition timelines; ResilienceState.report and healthy agree."""
    traces = []
    for pkg in PKGS:
        clk = _Clock()
        rs = _rs(pkg, clk, **LADDER_CFGS[cfg])
        lad = rs.ladder
        changes = []
        lad.on_change = changes.append
        trace = []
        for op, *args in _ladder_ops(seed):
            if op == "tick":
                clk.t += args[0]
                ret = None
            else:
                ret = getattr(lad, op)(*args)
            trace.append((op, ret, int(lad.rung()), lad.report(),
                          rs.healthy(), rs.report()))
        traces.append((trace, list(lad.transitions), changes))
    assert traces[1] == traces[0]
    assert len({step[2] for step in traces[0][0]}) > 1  # it moved


@pytest.mark.parametrize("seed", [0, 1])
def test_outlier_ejectors_equal(seed):
    """Serve latencies with one slow endpoint -> the same ejections at
    the same evals, equal reports and equal breaker boards."""
    rng = np.random.default_rng(seed)
    ops = []
    for step in range(600):
        slot = int(rng.integers(0, 6))
        slow = slot == 2 and step > 100
        ops.append((slot, float(rng.lognormal(np.log(0.4 if slow else 0.05),
                                              0.3))))
    traces = []
    for pkg in PKGS:
        breaker = _mod(pkg, "resilience.breaker")
        outlier = _mod(pkg, "resilience.outlier")
        clk = _Clock()
        board = breaker.BreakerBoard(clock=clk)
        ej = outlier.OutlierEjector(outlier.OutlierConfig(
            eval_interval_s=0.5, breach_streak=2), clock=clk)
        trace = []
        for step, (slot, lat) in enumerate(ops):
            ej.note(slot, lat)
            clk.t += 0.02
            if step % 10 == 0:
                trace.append(ej.evaluate(board))
            if step == 500:
                ej.drop(4)
        traces.append((trace, ej.report(), board.report(), board.events))
    assert traces[1] == traces[0]
    assert any(traces[0][0])  # the slow endpoint was ejected


# -- (b) the picker's resilience half -------------------------------------


RUNGS = {  # name -> (forced level, wrr_queue_alpha)
    "cached": (1, 1.0),
    "round_robin-alpha0": (2, 0.0),
    "round_robin-alpha1": (2, 1.0),
    "static": (3, 1.0),
}


def _candidates(ds, rng) -> list:
    pool = ds.pick_candidates()
    k = int(rng.integers(1, len(pool) + 1))
    keep = set(rng.choice(len(pool), size=k, replace=False).tolist())
    return [ep for i, ep in enumerate(pool) if i in keep]


@pytest.mark.parametrize("rung", list(RUNGS))
def test_degraded_picks_equal(rung):
    """Waves answered on a forced degraded rung, with two endpoints
    quarantined and one draining -> equal picks, fallbacks, uncharged
    results and flight records; the WRR credit and the static rotation
    carry across waves alike."""
    level, alpha = RUNGS[rung]
    out = []
    for side in SIDES:
        pkg = "gie_tpu" if side.jax else "gie_tpu_torch"
        clk = _Clock()
        rs = _rs(pkg, clk, probe_interval_s=1e9, wrr_queue_alpha=alpha)
        rs.ladder.force_level(level)
        recorder = _mod(pkg, "obs.recorder").FlightRecorder(512)
        _mod(pkg, "obs").install(recorder=recorder)
        st = _stack(side, "default", resilience=rs)
        try:
            for slot in (3, 7):
                for _ in range(5):
                    rs.board.record(slot, False)
            assert st.ds.pod_mark_draining("default", "p5")
            rng = np.random.default_rng(17)
            outcomes = []
            for wave in range(6):
                items = [side.Pending(_request(side, 7 * wave + i),
                                      _candidates(st.ds, rng), now=NOW)
                         for i in range(7)]
                st.picker._run_batch(items)
                outcomes += [_item_outcome(side, it) for it in items]
            out.append((outcomes, [_strip(r) for r in recorder.snapshot()]))
        finally:
            st.picker.close()
    assert out[1] == out[0]
    outcomes, records = out[0]
    assert all(o[0] == "ok" and o[3] == -1 for o in outcomes)
    assert {r["rung"] for r in records} == {rung.split("-")[0]}
    assert len(records) == 42


class _SchedProxy:
    """Scheduler wrapper overriding pick_async only."""

    def __init__(self, real, pick_async):
        self._real = real
        self.pick_async = pick_async

    def __getattr__(self, name):
        return getattr(self._real, name)


class _BadPending:
    def materialize(self):
        raise RuntimeError("device died mid-cycle")


FAILURES = ["dispatch-fault", "dispatch-error", "materialize-error"]


def _failing_run(side, failure: str, n_fail: int = 4, n: int = 16):
    """Sequential one-request waves with the first `n_fail` device
    cycles failing, the ladder at its default config on a fake clock
    stepped 0.5 s per pick. -> (per-pick timeline, ladder transitions,
    end rung, healthy, records)."""
    pkg = "gie_tpu" if side.jax else "gie_tpu_torch"
    faults = _mod(pkg, "resilience.faults")
    clk = _Clock()
    rs = _rs(pkg, clk)
    recorder = _mod(pkg, "obs.recorder").FlightRecorder(512)
    _mod(pkg, "obs").install(recorder=recorder)
    st = _stack(side, "default", resilience=rs)
    calls = {"n": 0}
    real = st.sched.pick_async

    def pick_async(*a, **kw):
        calls["n"] += 1
        if calls["n"] <= n_fail:
            if failure == "dispatch-error":
                raise RuntimeError("device dispatch failed")
            return _BadPending()
        return real(*a, **kw)

    if failure == "dispatch-fault":
        faults.install(faults.FaultInjector(
            23, {"device.dispatch": faults.FaultRule(p_error=1.0,
                                                     max_fires=n_fail)}))
    else:
        st.picker.scheduler = _SchedProxy(st.sched, pick_async)
    timeline = []
    try:
        for i in range(n):
            before = int(rs.ladder.rung())
            res = _outcome(side, lambda: st.picker.pick(
                _request(side, i), st.ds.pick_candidates()))
            timeline.append((before, res, recorder.snapshot()[-1]["rung"]))
            clk.t += 0.5
    finally:
        st.picker.close()
    fired = (faults.installed().fired.get("device.dispatch", 0)
             if failure == "dispatch-fault" else None)
    return (timeline, list(rs.ladder.transitions), int(rs.ladder.rung()),
            rs.healthy(), [_strip(r) for r in recorder.snapshot()], fired)


@pytest.mark.parametrize("failure", FAILURES)
def test_dispatch_and_materialize_failures_answered_degraded(failure):
    """A device that fails its first four cycles: every pick answered
    (degraded at CACHED or below, uncharged), the ladder descends after
    dispatch_error_streak failures, probes at probe_interval_s, and
    climbs back to FULL after min_dwell_s and recover_streak good
    probes — the same timeline, picks and records in both packages."""
    ref, port = (_failing_run(side, failure) for side in SIDES)
    assert port == ref
    timeline, transitions, end, healthy, records, fired = port
    assert all(res[0] == "ok" for _, res, _ in timeline)
    assert timeline[0][2] == "cached" and timeline[0][1][3] == -1
    assert transitions[0][1] == 1 and end == 0 and healthy
    assert timeline[-1][2] == "full"
    if failure == "dispatch-fault":
        assert fired == 4


class _UnavailablePending:
    def materialize(self):
        from gie_tpu_torch.ops import KernelUnavailable

        raise KernelUnavailable("fused_sinkhorn_plan: shape refused")


@pytest.mark.parametrize("where", ["dispatch", "materialize"])
def test_kernel_unavailable_fails_the_wave_instead_of_degrading(where):
    """A kernel that cannot run here (build, load or shape refused) is no
    sick device: with a ResilienceState the wave still fails, and the
    ladder, the degraded-pick counter and the next wave are untouched."""
    from gie_tpu_torch.ops import KernelUnavailable
    from gie_tpu_torch.runtime import metrics as own_metrics

    clk = _Clock()
    rs = _rs("gie_tpu_torch", clk)
    st = _stack(TORCH, "default", resilience=rs)
    real = st.sched.pick_async
    calls = {"n": 0}

    def pick_async(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            return real(*a, **kw)
        if where == "dispatch":
            raise KernelUnavailable("the port's CUDA kernels cannot be built")
        return _UnavailablePending()

    st.picker.scheduler = _SchedProxy(st.sched, pick_async)
    degraded0 = sum(own_metrics.DEGRADED_PICKS.value(r)
                    for r in ("cached", "round_robin", "static"))
    try:
        failed = _outcome(TORCH, lambda: st.picker.pick(
            _request(TORCH, 0), st.ds.pick_candidates()))
        clk.t += 0.5
        after = _outcome(TORCH, lambda: st.picker.pick(
            _request(TORCH, 1), st.ds.pick_candidates()))
    finally:
        st.picker.close()
    assert failed[:2] == ("error", "INTERNAL")
    assert "cannot be built" in failed[2] or "shape refused" in failed[2]
    assert after[0] == "ok" and after[3] >= 0
    assert int(rs.ladder.rung()) == 0 and not rs.ladder.transitions
    assert rs.healthy()
    assert sum(own_metrics.DEGRADED_PICKS.value(r)
               for r in ("cached", "round_robin", "static")) == degraded0


def test_breaker_filter_and_fallback_tail():
    """Device-path waves with three endpoints quarantined: each item's
    excluded slots (excl_breaker) and its fallback tail leave them out —
    unless they are all it has (availability beats quarantine) — and
    both packages answer and record alike."""
    out, scores = [], []
    for side in SIDES:
        pkg = "gie_tpu" if side.jax else "gie_tpu_torch"
        clk = _Clock()
        rs = _rs(pkg, clk)
        recorder = _mod(pkg, "obs.recorder").FlightRecorder(512)
        _mod(pkg, "obs").install(recorder=recorder)
        st = _stack(side, "default", resilience=rs)
        try:
            quarantined = (1, 4, 9)
            for slot in quarantined:
                for _ in range(5):
                    rs.board.record(slot, False)
            rng = np.random.default_rng(3)
            pool = st.ds.pick_candidates()
            waves = []
            for wave in range(3):
                items = [side.Pending(_request(side, 9 * wave + i),
                                      _candidates(st.ds, rng), now=NOW)
                         for i in range(8)]
                items[0] = side.Pending(
                    _request(side, 9 * wave + 8),
                    [ep for ep in pool if ep.slot in quarantined], now=NOW)
                st.picker._run_batch(items)
                for it in items:
                    assert it.event.wait(60)
                waves.append([(_item_outcome(side, it), it.excl_breaker,
                               set(it.cand_slots.tolist()) <= set(quarantined))
                              for it in items])
            records = [_strip(r) for r in recorder.snapshot()]
            ranked = [r.pop("ranked", []) for r in records]
            out.append((waves, records, [[e["slot"] for e in r]
                                         for r in ranked]))
            scores.append([e["score"] for r in ranked for e in r])
            sick = {ep.hostport for ep in pool if ep.slot in quarantined}
        finally:
            st.picker.close()
    assert out[1] == out[0]
    np.testing.assert_allclose(scores[1], scores[0], rtol=0, atol=2e-5)
    waves = out[0][0]
    for wave in waves:
        for outcome, excl, only_sick in wave:
            assert outcome[0] == "ok"
            if only_sick:  # availability beats quarantine
                assert excl == ()
            else:
                assert sick.isdisjoint([outcome[1], *outcome[2]])
        assert wave[0][2]
    assert any(excl for wave in waves for _, excl, _ in wave)


# -- (c) serve storms from the scenario files -----------------------------


def _resp_headers(served: str) -> bytes:
    """ProcessingRequest.response_headers with :status 200 and the
    served-endpoint echo Envoy puts in the envoy.lb metadata."""
    return ld(5, http_headers_bytes(
        header_map_bytes(header_value_bytes(":status", raw=b"200")),
        end_of_stream=True)) + ld(8, metadata_context_bytes(
            "envoy.lb", struct_with_field(
                "x-gateway-destination-endpoint-served",
                struct_string_value(served))))


class _EchoStream:
    """Request headers, then response headers echoing the picked primary
    as the served endpoint with a 200 (the chaos seams rewrite the
    verdict from there)."""

    def __init__(self, pb):
        self.pb = pb
        self.messages = [pb.ProcessingRequest.FromString(
            GOLDEN_REQUEST_HEADERS)]
        self.sent = []

    def recv(self):
        if not self.messages and len(self.sent) == 1:
            self.messages.append(self.pb.ProcessingRequest.FromString(
                _resp_headers(self.destination())))
        return self.messages.pop(0) if self.messages else None

    def send(self, resp):
        self.sent.append(resp)

    def destination(self) -> str:
        mut = self.sent[0].request_headers.response.header_mutation
        return next(o.header.raw_value.decode() for o in mut.set_headers
                    if o.header.key == "x-gateway-destination-endpoint"
                    ).split(",")[0]


STORM_POINTS = {"serve-5xx-storm": "endpoint.serve_5xx",
                "reset-storm": "endpoint.reset"}
STORM_BOARDS = {  # the reference's own acceptance configs for each file
    "serve-5xx-storm": dict(open_after=50, open_s=30.0, serve_window_s=10.0,
                            serve_rate_open=0.5, serve_min_samples=6),
    "reset-storm": dict(open_after=5, open_s=30.0),
}


def _storm(pkg: str, name: str):
    """Replay a serve-storm scenario file through `pkg`'s StreamingServer
    and picker: -> (per-stream timeline, board events, ladder and board
    reports, injector fire counts, assumed load, sick hostport)."""
    side = SIDES[0] if pkg == "gie_tpu" else TORCH
    scn = _mod(pkg, "resilience.scenarios").load(name)
    clk = _Clock()
    rs = _rs(pkg, clk, board_cfg=STORM_BOARDS[name],
             serve_min_samples=10_000)
    sched = side.scheduler("default")
    ms = side.MetricsStore(clock=lambda: NOW)
    ds = side.Datastore(on_slot_reclaimed=lambda s: (sched.evict_endpoint(s),
                                                     ms.remove(s)))
    ds.pool_set(side.EndpointPool({"app": "x"}, [8000], "default"))
    for i in range(scn.drive["pods"]):
        ds.pod_update_or_add(side.Pod(name=f"p{i}", labels={"app": "x"},
                                      ip=f"10.9.1.{i + 1}"))
    sick = scn.drive["sick"]
    # The sick pod looks the most attractive (empty queue): only the
    # data-plane outcome loop can break that attraction.
    queue = int(_mod(pkg, "sched.constants").Metric.QUEUE_DEPTH)
    ms.update_rows([(ep.slot, {queue: 0.0 if ep.hostport == sick else 8.0},
                     (), ()) for ep in ds.endpoints()], now=NOW)
    picker = side.Picker(sched, ds, ms, max_wait_s=0.0005, resilience=rs)
    server = _mod(pkg, "extproc.server").StreamingServer(
        ds, picker, on_served=picker.observe_served,
        on_response_complete=picker.observe_response_complete,
        on_stream_aborted=picker.observe_stream_aborted)
    pb = _mod(pkg, "extproc.pb")
    inj = scn.arm()
    sick_slot = ds.endpoint_by_hostport(sick).slot
    timeline = []
    try:
        for _ in range(scn.drive["requests"]):
            if name == "serve-5xx-storm":
                # A pristine scrape sweep between requests: the control
                # plane swears the sick pod is healthy throughout.
                for ep in ds.endpoints():
                    rs.board.record(ep.slot, True)
            stream = _EchoStream(pb)
            server.process(stream)
            timeline.append((stream.destination(),
                             rs.board.state(sick_slot)))
            clk.t += 0.1
        load = sched.snapshot_assumed_load()
        return (timeline, list(rs.board.events), rs.board.report(),
                rs.ladder.report(), dict(inj.fired),
                float(np.abs(np.asarray(load)).sum()), sick)
    finally:
        picker.close()


@pytest.mark.parametrize("name", ["serve-5xx-storm", "reset-storm"])
def test_scenario_serve_storms_equal(name):
    """The shipped serve-5xx and reset storms through both servers and
    pickers: equal destinations, breaker timelines, reports and fire
    counts; the sick endpoint's breaker opens, picks route around it
    afterwards, and a reset storm leaks no assumed load."""
    ref, port = (_storm(pkg, name) for pkg in PKGS)
    assert port == ref
    timeline, events, _report, _ladder, fired, load, sick = port
    opened = [i for i, (_, state) in enumerate(timeline) if state == "open"]
    assert opened, "the storm never opened the sick endpoint's breaker"
    assert all(dest != sick for dest, _ in timeline[opened[0] + 1:])
    assert fired[STORM_POINTS[name]] >= 5 and events
    if name == "reset-storm":
        assert load == pytest.approx(0.0, abs=1e-4)


# -- (d) woven fault points -----------------------------------------------


def test_engine_scrape_fault_feeds_breakers():
    """scrape.fetch errors on one endpoint open its breaker through the
    port's scrape engine (record on failure and success), the healthy
    endpoint scrapes, the gauge follows, and detach drops the breaker."""
    from gie_tpu_torch.metricsio import MetricsStore
    from gie_tpu_torch.metricsio.engine import ScrapeEngine
    from gie_tpu_torch.metricsio.mappings import VLLM
    from gie_tpu_torch.resilience import faults
    from gie_tpu_torch.resilience.breaker import (
        BreakerBoard, BreakerConfig, BreakerState)
    from gie_tpu_torch.runtime import metrics as own_metrics
    from tests.test_metricsio_sim import VLLM_TEXT

    board = BreakerBoard(BreakerConfig(open_after=3, open_s=60.0))
    store = MetricsStore()
    faults.install(faults.FaultInjector(11, {
        "scrape.fetch": faults.FaultRule(p_error=1.0, keys=("10.2.0.1",)),
    }))
    eng = ScrapeEngine(store, interval_s=0.01, fetcher=lambda u: VLLM_TEXT,
                       workers=1, breaker_board=board)
    try:
        eng.attach(0, "http://10.2.0.1:8000/metrics", VLLM)
        eng.attach(1, "http://10.2.0.2:8000/metrics", VLLM)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not board.has_open:
            time.sleep(0.01)
        assert board.state(0) == BreakerState.OPEN
        assert board.state(1) == BreakerState.CLOSED
        assert store._has_data[1]
        deadline = time.monotonic() + 2.0
        while (time.monotonic() < deadline
               and own_metrics.BREAKER_OPEN.value() < 1.0):
            time.sleep(0.01)
        assert own_metrics.BREAKER_OPEN.value() == 1.0
        eng.detach(0)
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and board.has_open:
            time.sleep(0.01)
        assert board.state(0) == BreakerState.CLOSED
    finally:
        eng.close()


def test_slow_and_hung_endpoints_do_not_open_breakers():
    """endpoint.slow and endpoint.hang delay their endpoints' scrapes:
    every endpoint still lands rows, and latency is not failure."""
    from gie_tpu_torch.metricsio import MetricsStore
    from gie_tpu_torch.metricsio.engine import ScrapeEngine
    from gie_tpu_torch.metricsio.mappings import VLLM
    from gie_tpu_torch.resilience import faults
    from gie_tpu_torch.resilience.breaker import BreakerBoard
    from tests.test_metricsio_sim import VLLM_TEXT

    ms = MetricsStore()
    board = BreakerBoard()
    faults.install(faults.FaultInjector(17, {
        "endpoint.slow": faults.FaultRule(p_latency=1.0, latency_s=0.03,
                                          keys=("10.3.0.1",)),
        "endpoint.hang": faults.FaultRule(p_hang=1.0, hang_s=0.25,
                                          keys=("10.3.0.2",), max_fires=2),
    }))
    eng = ScrapeEngine(ms, interval_s=0.01, fetcher=lambda u: VLLM_TEXT,
                       workers=2, breaker_board=board)
    try:
        for slot in range(3):
            eng.attach(slot, f"http://10.3.0.{slot + 1}:8000/metrics", VLLM)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not all(
                ms._has_data[s] for s in (0, 1, 2)):
            time.sleep(0.01)
        assert all(ms._has_data[s] for s in (0, 1, 2))
        inj = faults.installed()
        assert inj.fired.get("endpoint.slow", 0) > 0
        assert inj.fired.get("endpoint.hang", 0) == 2
        assert not board.has_open
    finally:
        eng.close()


def test_fieldscan_native_scan_fault_falls_back_to_python():
    from gie_tpu_torch.extproc import fieldscan
    from gie_tpu_torch.resilience import faults

    body = b'{"model": "m1", "stream": true, "max_tokens": 7}'
    want = fieldscan.scan_py(body)
    faults.install(faults.FaultInjector(
        2, {"native.scan": faults.FaultRule(p_error=1.0)}))
    assert fieldscan.scan(body) == want
    assert faults.installed().fired.get("native.scan", 0) >= 1
    faults.uninstall()
    assert fieldscan.scan(body) == want


# Points whose subsystem a later slice of the port brings: named here,
# neither woven in the port nor exercised by its tests yet (the peer.*
# points came with the federation slice, kube.patch with the kube slice:
# none is left).
LATER_POINTS = set()


def _literals(path: pathlib.Path) -> set:
    return {node.value for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Constant) and isinstance(node.value, str)}


def test_every_port_fault_point_is_woven_and_exercised_or_later():
    """Each point of the port's faults.CATALOG is either woven into
    gie_tpu_torch (a string literal outside faults.py) and named by a
    port test, or belongs to a later slice — never both, never neither."""
    from gie_tpu_torch.resilience.faults import CATALOG

    woven, tested = set(), set()
    for path in (REPO / "gie_tpu_torch").rglob("*.py"):
        if path.name != "faults.py":
            woven |= _literals(path) & set(CATALOG)
    for path in (REPO / "tests").glob("test_torch_*.py"):
        tested |= _literals(path) & set(CATALOG)
    tested -= LATER_POINTS  # this file names them in LATER_POINTS
    assert LATER_POINTS <= set(CATALOG)
    for point in CATALOG:
        if point in LATER_POINTS:
            assert point not in woven, f"{point} is woven: drop it from LATER"
        else:
            assert point in woven, f"{point} is not woven into the port"
            assert point in tested, f"{point} is exercised by no port test"
