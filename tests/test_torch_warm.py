"""The port's warm lattice, static state and explain against the reference
on the CPU.

gie_tpu_torch's Scheduler(device="cpu") beside gie_tpu's Scheduler, fed
the same inputs (gie_tpu/utils/testing.py's make_* over a numpy seed,
converted with gie_tpu_torch.convert) with the JAX scheduler's Gumbel
draws replayed into the port (`jax_noise_replay`). On the CPU warming
runs the eager cycle once on a throwaway state, so the warm API, its
counters and the "touches no live state" property hold here as they do
where a warm captures a CUDA graph (tests/test_torch_cuda.py).

Tolerances: picks, statuses, masks, shed flags, prefix-table words and
counters exact; float columns and the float state (assumed_load, ot_v)
within atol=1e-5, as tests/test_torch_slice.py holds them.
"""

import logging
import threading

import numpy as np
import pytest
import torch

from gie_tpu.sched import ProfileConfig as JaxProfileConfig
from gie_tpu.sched import Scheduler as JaxScheduler
from gie_tpu.sched import constants as JC
from gie_tpu.utils.testing import make_endpoints, make_requests

from gie_tpu_torch import convert, ops
from gie_tpu_torch.sched import ProfileConfig, Scheduler
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.types import EndpointBatch, RequestBatch
from tests.test_torch_slice import (
    _assert_states,
    _configs,
    jax_noise_replay,
)

SEED = 13
BASE = b"SYSTEM: You are a helpful assistant specialised in task %d. "
CONFIGS = ["tuned-sinkhorn-kernel", "topk-kernel"]


def _pair(name, seed=SEED):
    """(JAX scheduler, port scheduler) of configuration `name`."""
    jc, jw, tc, tw = _configs(name)
    return (JaxScheduler(jc, jw, seed=seed),
            Scheduler(tc, tw, seed=seed, device="cpu",
                      noise_source=jax_noise_replay(seed)))


def _wave(w, n, m_slots, live):
    """Wave w: n requests over 16 shared system prompts, LoRA ids -1..11,
    against `live` endpoints on an m_slots-wide axis, as numpy-built
    reference batches."""
    rng = np.random.default_rng(SEED + w)
    prompts = [(BASE % ((i + w) % 16)) * 6 + b"q %d" % (i + 97 * w)
               for i in range(n)]
    reqs = make_requests(n, prompts=prompts,
                         lora_id=rng.integers(-1, 12, n).tolist(),
                         criticality=rng.integers(0, 3, n).tolist(),
                         m_slots=m_slots)
    eps = make_endpoints(live, queue=rng.integers(0, 50, live).tolist(),
                         kv=rng.uniform(0, 0.95, live).tolist(), max_lora=8,
                         lora_active=[rng.integers(-1, 12, 3).tolist()
                                      for _ in range(live)],
                         m_slots=m_slots)
    return reqs, eps


def _port(reqs, eps):
    return (convert.requests_from_numpy(reqs, device="cpu"),
            convert.endpoints_from_numpy(eps, device="cpu"))


def _pick_both(js, ts, reqs, eps):
    ref = js.pick(reqs, eps)
    port = ts.pick(*_port(reqs, eps))
    np.testing.assert_array_equal(port.indices, np.asarray(ref.indices))
    np.testing.assert_array_equal(port.status, np.asarray(ref.status))
    return ref, port


def test_background_lattice_warm_removes_inline_stall():
    """Port of tests/test_sched_pipeline.py's lattice test, both packages
    side by side: after warm_lattice_async(64, MAX_CHUNKS).join(), waves
    in three different N buckets of that lattice warm nothing inline; a
    shape outside it warms once inline. The counters, the warm sets and
    the picks equal the reference's."""
    js = JaxScheduler(JaxProfileConfig(enable_prefix=False))
    ts = Scheduler(ProfileConfig(enable_prefix=False), device="cpu")
    for s, lanes in ((js, JC.MAX_CHUNKS), (ts, C.MAX_CHUNKS)):
        t = s.warm_lattice_async(64, lanes)
        t.join(timeout=600)
        assert not t.is_alive(), "lattice warm thread did not finish"
        assert s.warm_inline_compiles == 0
    assert ts._warm_buckets == js._warm_buckets == {
        (n, 64, C.MAX_CHUNKS) for n in C.N_BUCKETS}

    eps = make_endpoints(4, queue=[0, 1, 2, 3], m_slots=64)
    for n in (1, 5, 60):
        _, port = _pick_both(js, ts, make_requests(n, m_slots=64), eps)
        assert port.status.tolist() == [C.Status.OK] * n
    assert ts.warm_inline_compiles == js.warm_inline_compiles == 0

    eps256 = make_endpoints(4, queue=[0, 1, 2, 3], m_slots=256)
    _pick_both(js, ts, make_requests(2, m_slots=256), eps256)
    assert ts.warm_inline_compiles == js.warm_inline_compiles == 1
    assert sorted(ts._warm_buckets) == sorted(js._warm_buckets)


def _pod_stack(pkg, **picker_kw):
    """The reference test's _stack: a Scheduler(load_decay=1.0), two pods
    and a BatchingTPUPicker (max_wait_s=0.02) of package `pkg`."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    sched_mod = mod("sched")
    kw = {} if pkg == "gie_tpu" else {"device": "cpu"}
    sched = sched_mod.Scheduler(sched_mod.ProfileConfig(load_decay=1.0), **kw)
    ms = mod("metricsio").MetricsStore()
    objects = mod("datastore.objects")
    ds = mod("datastore").Datastore(
        on_slot_reclaimed=lambda s: (sched.evict_endpoint(s), ms.remove(s)))
    ds.pool_set(objects.EndpointPool({"app": "x"}, [8000], "default"))
    for i in range(2):
        ds.pod_update_or_add(objects.Pod(name=f"p{i}", labels={"app": "x"},
                                         ip=f"10.9.0.{i + 1}"))
    picker = mod("sched.batching").BatchingTPUPicker(
        sched, ds, ms, max_wait_s=0.02, **picker_kw)
    pick_request = (mod("extproc.server").PickRequest if pkg == "gie_tpu"
                    else mod("extproc.pick").PickRequest)
    return sched, ds, picker, pick_request


@pytest.mark.parametrize("pkg", ["gie_tpu", "gie_tpu_torch"])
def test_dispatcher_kicks_background_lattice_warm_once(pkg):
    """Port of tests/test_batching_robustness.py's kick test, run on each
    package: with background_warm=True the first wave of a lattice kicks
    warm_lattice_async once, its thread joins with the whole N lattice of
    (M_BUCKETS[0], C_BUCKETS[0]) warm, the same lattice kicks no second
    thread, and a picker built without the flag kicks nothing."""
    sched, ds, picker, req = _pod_stack(pkg, background_warm=True)
    try:
        picker.pick(req(headers={}, body=b"x"), ds.endpoints())
        assert len(picker._warm_threads) == 1
        picker._warm_threads[0].join(timeout=600)
        assert not picker._warm_threads[0].is_alive()
        for n in C.N_BUCKETS:
            assert (n, C.M_BUCKETS[0], C.C_BUCKETS[0]) in sched._warm_buckets
        picker.pick(req(headers={}, body=b"y"), ds.endpoints())
        assert len(picker._warm_threads) == 1
        assert sched.warm_inline_compiles == 1
    finally:
        picker.close()

    sched2, ds2, picker2, req2 = _pod_stack(pkg)
    try:
        picker2.pick(req2(headers={}, body=b"x"), ds2.endpoints())
        assert picker2._warm_threads == []
    finally:
        picker2.close()


@pytest.mark.parametrize("name", CONFIGS)
def test_warm_leaves_live_state_and_noise_untouched(name):
    """_warm and a whole lattice warm on a scheduler that has carried two
    waves leave its state bit-identical and draw no noise: the next wave
    still equals the reference's, which never warmed."""
    js, ts = _pair(name)
    for w in range(2):
        _pick_both(js, ts, *_wave(w, 24, 64, 40))
    before = ts.export_state()
    reqs, eps = _port(*_wave(9, 64, 64, 40))
    ts._warm(reqs, eps)
    t = ts.warm_lattice_async(64, 16)
    t.join(timeout=600)
    assert not t.is_alive()
    after = ts.export_state()
    assert set(after) == set(before)
    for k in before:
        assert after[k].tobytes() == before[k].tobytes(), k
    _pick_both(js, ts, *_wave(2, 24, 64, 40))
    _assert_states(js.export_state(), ts.export_state())


def _pointers(sched) -> dict:
    """{(m, field): data_ptr} over every bucket state allocated so far."""
    return {(m, k): t.data_ptr()
            for m, st in sched._states.items()
            for k, t in (("keys", st.prefix.keys),
                         ("present", st.prefix.present),
                         ("ages", st.prefix.ages),
                         ("assumed_load", st.assumed_load),
                         ("rr", st.rr), ("tick", st.tick), ("ot_v", st.ot_v))}


@pytest.mark.parametrize("name", CONFIGS)
def test_state_survives_bucket_changes_and_installs_in_place(name):
    """Waves across M buckets 64 -> 256 -> 64 with completion feedback,
    then an install_state of another scheduler's digest: every bucket's
    tensors keep their storage, the live state is its bucket's, and the
    values equal the reference's export_state after the same steps."""
    js, ts = _pair(name)
    seen = {}
    for w, m in enumerate((64, 64, 256, 256, 64)):
        reqs, eps = _wave(w, 24, m, 40)
        _, port = _pick_both(js, ts, reqs, eps)
        done, costs = port.indices[:12, 0], np.full(12, 0.5, np.float32)
        js.complete(done, costs)
        ts.complete(done, costs)
        ptrs = _pointers(ts)
        assert all(seen.get(k, p) == p for k, p in ptrs.items())
        seen.update(ptrs)
        assert ts.state is ts._states[m]
        _assert_states(js.export_state(), ts.export_state())
    assert set(ts._states) == {64, 256}

    # A leader's digest at the other bucket installs into that bucket's
    # tensors, which become the live ones.
    jl, tl = _pair(name, seed=SEED + 1)
    _pick_both(jl, tl, *_wave(7, 24, 256, 40))
    digest = tl.export_state()
    assert ts.install_state(digest) and js.install_state(digest)
    assert _pointers(ts) == seen and ts.state is ts._states[256]
    _assert_states(js.export_state(), ts.export_state())
    _assert_states(tl.export_state(), ts.export_state())
    _pick_both(js, ts, *_wave(8, 24, 256, 40))
    _assert_states(js.export_state(), ts.export_state())
    assert _pointers(ts) == seen

    # A digest whose prefix table has another row count cannot be copied
    # into the allocated tables: refused, the state kept.
    bad = dict(digest)
    for k in ("prefix_keys", "prefix_ages"):
        bad[k] = bad[k][:-32]
    bad["prefix_present"] = bad["prefix_present"][:-32]
    assert ts.prepare_install(bad) is None
    assert not ts.install_state(bad)
    _assert_states(js.export_state(), ts.export_state())


def _explain_both(js, ts, reqs, eps):
    ref = js.explain(reqs, eps)
    port = ts.explain(*_port(reqs, eps))
    assert set(port) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        assert port[k].shape == r.shape, k
        if k in ("mask", "shed"):
            np.testing.assert_array_equal(port[k], r, err_msg=k)
        else:
            np.testing.assert_allclose(port[k], r, atol=1e-5, err_msg=k)
    return port


@pytest.mark.parametrize("name", ["default"] + CONFIGS)
def test_explain_matches_reference(name):
    """tests/test_config_explain.py's cases on both packages, then after
    two carried waves (load and prefix state behind the columns) and
    against another M bucket than the live one (the resized copy): every
    column equal to the reference's, and the state untouched."""
    if name == "default":
        js = JaxScheduler(JaxProfileConfig())
        ts = Scheduler(ProfileConfig(), device="cpu")
    else:
        js, ts = _pair(name)
    # test_explain_decomposes_the_pick
    eps = make_endpoints(3, queue=[0, 30, 60], kv=[0.1, 0.5, 0.9])
    out = _explain_both(js, ts, make_requests(2, subset=[[0, 1, 2], [1]]),
                        eps)
    assert out["total"].shape == (2, C.M_MAX)
    if name == "default":
        assert out["queue"][0, 0] > out["queue"][0, 1] > out["queue"][0, 2]
    assert out["mask"][1, 1] and not out["mask"][1, 0]
    assert int(ts.state.tick) == 0
    # test_explain_matches_actual_pick
    eps = make_endpoints(4, queue=[5, 0, 9, 3])
    reqs = make_requests(3)
    out = _explain_both(js, ts, reqs, eps)
    _, res = _pick_both(js, ts, reqs, eps)
    if name == "default":
        for i in range(3):
            best = int(np.argmax(np.where(out["mask"][i], out["total"][i],
                                          -1e9)))
            assert int(res.indices[i, 0]) == best
    # Carried state, a shed-prone mix, and a bucket other than the live.
    for w in range(2):
        _pick_both(js, ts, *_wave(w, 24, 64, 40))
    before = ts.export_state()
    for m in (64, 256):
        _explain_both(js, ts, *_wave(5, 24, m, 40))
    after = ts.export_state()
    assert all(after[k].tobytes() == before[k].tobytes() for k in before)


def test_debug_report_carries_the_warm_cache():
    """debug_report's warm fields equal the reference's after the same
    picks and lattice warm."""
    js = JaxScheduler(JaxProfileConfig(enable_prefix=False))
    ts = Scheduler(ProfileConfig(enable_prefix=False), device="cpu")
    reqs, eps = make_requests(3, m_slots=64), make_endpoints(4, m_slots=64)
    _pick_both(js, ts, reqs, eps)
    for s in (js, ts):
        s.warm_lattice_async(64, 8).join(timeout=600)
    ref, port = js.debug_report(), ts.debug_report()
    for k in ("warm_buckets", "warm_inline_compiles", "m_bucket", "tick"):
        assert port[k] == ref[k], k
    assert port["warm_inline_compiles"] == 1
    assert (8, 64, C.MAX_CHUNKS) in port["warm_buckets"]


@pytest.mark.parametrize("pkg", ["gie_tpu", "gie_tpu_torch"])
def test_runner_builds_its_picker_with_background_warm(pkg):
    """main()'s runner hands its picker background_warm=True in both
    packages."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    kw = {} if pkg == "gie_tpu" else {"device": "cpu"}
    runner = mod("runtime.runner").ExtProcServerRunner(
        mod("runtime.options").Options(pool_name="p", secure_serving=False,
                                       resilience=False, obs=False),
        mod("controller").FakeCluster(),
        scheduler=mod("sched").Scheduler(**kw))
    try:
        assert runner.picker.background_warm is True
        assert runner.picker._warm_threads == []
    finally:
        runner.stop()


def _refusing_warm(sched):
    """Make `sched`'s warm fail as a refused capture does."""
    def refuse(reqs, eps):
        raise ops.GraphCaptureFailed("capture refused")
    sched._warm = refuse


def test_failed_background_warm_raises_at_the_next_wave_of_its_key(caplog):
    """A warm that fails on the lattice thread is logged, stops the
    thread, and is raised to the next pick_async of its key (and only
    that one: the wave after warms inline again)."""
    ts = Scheduler(ProfileConfig(enable_prefix=False), device="cpu")
    real = ts._warm
    _refusing_warm(ts)
    with caplog.at_level(logging.ERROR):
        t = ts.warm_lattice_async(64, C.MAX_CHUNKS)
        t.join(timeout=60)
    assert not t.is_alive()
    assert "capture refused" in caplog.text
    assert ts._warm_buckets == set()
    ts._warm = real
    reqs = convert.requests_from_numpy(make_requests(1, m_slots=64),
                                       device="cpu")
    eps = convert.endpoints_from_numpy(make_endpoints(4, m_slots=64),
                                       device="cpu")
    with pytest.raises(ops.GraphCaptureFailed, match="capture refused"):
        ts.pick_async(reqs, eps)
    assert (ts.pick(reqs, eps).status == 0).all()
    assert ts.warm_inline_compiles == 1


def test_failed_capture_fails_the_wave_instead_of_degrading():
    """A capture that fails inline raises through the picker with a
    ResilienceState: the wave's waiters get INTERNAL, nothing is answered
    degraded, the ladder stays FULL, and once capture works the next wave
    is picked on the device path."""
    from gie_tpu_torch.datastore import Datastore
    from gie_tpu_torch.datastore.objects import EndpointPool, Pod
    from gie_tpu_torch.extproc.pick import ExtProcError, PickRequest
    from gie_tpu_torch.metricsio import MetricsStore
    from gie_tpu_torch.resilience import ResilienceState
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.sched.batching import BatchingTPUPicker

    sched = Scheduler(device="cpu")
    real = sched._warm
    _refusing_warm(sched)
    ms, ds = MetricsStore(), Datastore()
    ds.pool_set(EndpointPool({"app": "x"}, [8000], "default"))
    for i in range(4):
        ds.pod_update_or_add(Pod(name=f"p{i}", labels={"app": "x"},
                                 ip=f"10.9.0.{i + 1}"))
    rs = ResilienceState()
    picker = BatchingTPUPicker(sched, ds, ms, max_wait_s=0.002,
                               resilience=rs)
    degraded = sum(own_metrics.DEGRADED_PICKS.value(r)
                   for r in ("cached", "round_robin", "static"))
    try:
        with pytest.raises(ExtProcError, match="capture refused"):
            picker.pick(PickRequest(headers={}, body=b"a"),
                        ds.pick_candidates())
        assert int(rs.ladder.rung()) == 0 and not rs.ladder.transitions
        assert sum(own_metrics.DEGRADED_PICKS.value(r)
                   for r in ("cached", "round_robin", "static")) == degraded
        sched._warm = real
        res = picker.pick(PickRequest(headers={}, body=b"b"),
                          ds.pick_candidates())
        assert res.charged_slot >= 0
    finally:
        picker.close()


def test_launch_tally_takes_this_threads_launches_only():
    """ops.count_launch counts into the wrapper's `launches` unless this
    thread has a tally open; another thread's launches are not taken."""
    class Wrapper:
        launches = 0

    wrapper = Wrapper()
    ops.count_launch(wrapper)
    sink = {}
    with ops.tally(sink):
        ops.count_launch(wrapper)
        ops.count_launch(wrapper)
        other = threading.Thread(target=ops.count_launch, args=(wrapper,))
        other.start()
        other.join(10)
    ops.count_launch(wrapper)
    assert sink == {wrapper: 2}
    assert wrapper.launches == 3


def test_empty_batches_match_the_reference():
    """RequestBatch.empty and EndpointBatch.empty, the waves a lattice is
    warmed with, equal the reference's, field for field and dtype for
    dtype (chunk hashes at the lattice's lane count)."""
    from gie_tpu.sched.types import EndpointBatch as JaxEndpointBatch
    from gie_tpu.sched.types import RequestBatch as JaxRequestBatch

    ref = JaxRequestBatch.empty(8, 64)
    port = convert.requests_to_numpy(RequestBatch.empty(8, 64, lanes=16))
    for k, v in port.items():
        r = np.asarray(getattr(ref, k))
        if k == "chunk_hashes":
            r = r[:, :16]
        assert v.dtype == r.dtype and np.array_equal(v, r), k
    ref_e = JaxEndpointBatch.empty(64)
    port_e = EndpointBatch.empty(64)
    for k in ("metrics", "valid", "lora_active", "lora_waiting", "role"):
        np.testing.assert_array_equal(getattr(port_e, k).numpy(),
                                      np.asarray(getattr(ref_e, k)),
                                      err_msg=k)
    assert all(t.dtype in (torch.float32, torch.bool, torch.int32)
               for t in vars(port_e).values())
