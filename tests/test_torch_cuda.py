"""gie_tpu_torch's CUDA kernels on a card, against their plain versions.

Every test here needs a CUDA card (marker `cuda`) and skips without one;
the file imports neither JAX nor gie_tpu, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: sinkhorn plan and duals atol=1e-5 (the dual-form kernel sums
in another order than the plain matrix form); blend-top-k indices exact
and values atol=1e-5 (the kernel's blend is the plain version's rounded
f32 arithmetic in the same order).

The kernels are also held under CUDA graph capture (a captured launch
replays bitwise equal to an eager one), and the Scheduler's waves, each a
replay of the cycle captured for its shape, against the eager
scheduling_cycle on a copy of the state with the same inputs and noise:
indices, status and the prefix table exact; scores, affinity and the
float state within atol=1e-5 (the state update's index_add_ sums with
atomics, whose order may differ between two runs).

The last tests hold the pick service's handoff to the card: pick_async
queues a wave without waiting for the device, a wave's materialize()
waits for that wave only, and the batching picker answers a burst. The
storm twin, run under virtual time with its Scheduler on the card,
reaches the decisions of the same storm on the CPU (decision
fingerprints equal)."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from gie_tpu_torch.ops.fused_sinkhorn import (
    fused_sinkhorn_plan,
    fused_sinkhorn_plan_reference,
    layout,
)
from gie_tpu_torch.ops.fused_topk import (
    MAX_K,
    MAX_S,
    fused_blend_topk,
    fused_blend_topk_reference,
)
from gie_tpu_torch.sched import ProfileConfig, Scheduler
from gie_tpu_torch.sched.config import tuned_profile
from gie_tpu_torch.sched.constants import N_BUCKETS, Metric
from gie_tpu_torch.sched.profile import gumbel_noise
from gie_tpu_torch.utils.testing import make_endpoints, make_requests

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _sinkhorn_inputs(n, m, seed, dev):
    rng = np.random.default_rng(seed)
    k = np.where(rng.uniform(size=(n, m)) < 0.6,
                 np.exp((rng.uniform(size=(n, m)) - 1.0) / 0.02), 0.0)
    k[min(3, n - 1)] = 0.0                      # a row with no candidates
    cap = rng.uniform(0.5, 8.0, m) * n / m
    warm = rng.uniform(0.05, 1.0, m)
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (k, cap, warm)]


@pytest.mark.parametrize("n, m", [(1, 64), (7, 64), (8, 512), (1024, 64),
                                  (1024, 256), (1024, 1024)])
def test_sinkhorn_kernel_matches_plain(dev, n, m):
    k, cap, warm = _sinkhorn_inputs(n, m, seed=m, dev=dev)
    for v_init in (torch.ones_like(warm), warm):
        before = fused_sinkhorn_plan.launches
        plan, v = fused_sinkhorn_plan(k, cap, v_init)
        torch.cuda.synchronize()
        assert fused_sinkhorn_plan.launches == before + 1
        plan_ref, v_ref = fused_sinkhorn_plan_reference(k, cap, v_init)
        torch.testing.assert_close(plan, plan_ref, atol=1e-5, rtol=0)
        torch.testing.assert_close(v, v_ref, atol=1e-5, rtol=0)
        # No atomics: a second run is bitwise identical.
        again, v_again = fused_sinkhorn_plan(k, cap, v_init)
        assert torch.equal(again, plan) and torch.equal(v_again, v)
        assert (plan[min(3, n - 1)] == 0).all()       # the zero row


def test_sinkhorn_call_is_one_device_launch(dev):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    k, cap, warm = _sinkhorn_inputs(1024, 256, seed=4, dev=dev)
    fused_sinkhorn_plan(k, cap, warm)                 # build and warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fused_sinkhorn_plan(k, cap, warm)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    assert [(e.count, "sinkhorn_persistent" in e.key) for e in kernels] == [
        (1, True)], [(e.key, e.count) for e in kernels]
    lay = layout(dev, 1024, 256)            # one band of whole rows per SM
    assert lay.rows == -(-1024 // lay.sms) and lay.grid <= lay.sms
    assert lay.grid * lay.rows >= 1024 > (lay.grid - 1) * lay.rows


def _topk_inputs(s, n, m, seed, dev):
    rng = np.random.default_rng(seed)
    stacked = rng.uniform(size=(s, n, m)).astype(np.float32)
    stacked[:, 4, :] = 0.5                      # a row of exact ties
    mask = rng.uniform(size=(n, m)) < 0.7
    mask[5] = False                             # a fully masked row
    mask[6] = False
    mask[6, [3, m - 1]] = True                  # fewer candidates than k
    wvec = np.asarray([2.0, 1.0, 1.5, 4.0, 8.0, 1.0, 0.5, 3.0][:s],
                      np.float32)
    return [torch.from_numpy(a).to(dev) for a in (stacked, wvec, mask)]


@pytest.mark.parametrize("s, n, m", [(6, 1024, 256), (6, 1024, 1024),
                                     (3, 9, 64), (6, 1024, 40), (3, 64, 37),
                                     (6, 1024, 2048), (8, 16, 4096)])
def test_blend_topk_kernel_matches_plain(dev, s, n, m):
    stacked, wvec, mask = _topk_inputs(s, n, m, seed=m, dev=dev)
    before = fused_blend_topk.launches
    vals, idx = fused_blend_topk(stacked, wvec, mask)
    torch.cuda.synchronize()
    assert fused_blend_topk.launches == before + 1
    v_ref, i_ref = fused_blend_topk_reference(stacked, wvec, mask)
    torch.testing.assert_close(idx, i_ref, atol=0, rtol=0)
    torch.testing.assert_close(vals, v_ref, atol=1e-5, rtol=0)
    assert idx[4].tolist() == sorted(idx[4].tolist())   # lowest index first
    assert idx[5].tolist() == [0, 0, 0, 0]                # fully masked
    assert sorted(idx[6, :2].tolist()) == [3, m - 1]     # then the first
    assert idx[6, 2:].tolist() == [0, 0]                 # NEG lane again


def test_blend_topk_takes_k_up_to_its_bound(dev):
    stacked, wvec, mask = _topk_inputs(6, 64, 100, seed=5, dev=dev)
    vals, idx = fused_blend_topk(stacked, wvec, mask, k=MAX_K)
    v_ref, i_ref = fused_blend_topk_reference(stacked, wvec, mask, k=MAX_K)
    torch.testing.assert_close(idx, i_ref, atol=0, rtol=0)
    torch.testing.assert_close(vals, v_ref, atol=1e-5, rtol=0)


def test_wrappers_raise_instead_of_falling_back(dev):
    k, cap, warm = _sinkhorn_inputs(64, 64, seed=1, dev=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fused_sinkhorn_plan(k.t(), cap, warm)
    with pytest.raises(TypeError):
        fused_sinkhorn_plan(k.double(), cap, warm)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        fused_sinkhorn_plan(k, cap.cpu(), warm)
    stacked, wvec, mask = _topk_inputs(2, 8, 64, seed=1, dev=dev)
    with pytest.raises(ValueError, match="k <= 8"):
        fused_blend_topk(stacked, wvec, mask, k=MAX_K + 1)
    wide = stacked.repeat(MAX_S, 1, 1)[: MAX_S + 1].contiguous()
    with pytest.raises(ValueError, match="S <= 8"):
        fused_blend_topk(wide, torch.ones(MAX_S + 1, device=dev), mask)


# -- the kernels under CUDA graph capture ---------------------------------


def _capture(fn, stream):
    """fn() captured into a CUDA graph on `stream` in thread-local mode
    (the scheduler's mode) -> (graph, fn's return value)."""
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return graph, out


# A word of round 1's tag holding 123.0f: the worst garbage a reused
# Sinkhorn scratch could hold, were the kernel not to clear it first.
_ROUND1_WORD = (1 << 32) | 0x42F60000


@pytest.mark.parametrize("n, m", [(1024, 256), (1024, 1024), (7, 64)])
def test_captured_cooperative_sinkhorn_replays_bitwise(dev, n, m):
    """The Sinkhorn kernel's cooperative launch, captured into a CUDA
    graph, replays bitwise equal to the eager launch, twice, on one
    caller-owned scratch filled with round-tagged garbage before each
    replay: the kernel clears its scratch before round 1."""
    from gie_tpu_torch.ops import build

    k, cap, warm = _sinkhorn_inputs(n, m, seed=n + m, dev=dev)
    plan_ref, v_ref = fused_sinkhorn_plan(k, cap, warm)
    lay = layout(dev, n, m)
    lib = build.library()
    plan, v = torch.empty_like(plan_ref), torch.empty_like(v_ref)
    scratch = torch.empty((lay.scratch_floats,), dtype=torch.float32,
                          device=dev)

    def launch():
        build.check(lib.gie_fused_sinkhorn_plan(
            k.data_ptr(), cap.data_ptr(), warm.data_ptr(), plan.data_ptr(),
            v.data_ptr(), scratch.data_ptr(), n, m, 8,
            torch.cuda.current_stream().cuda_stream),
            "fused_sinkhorn_plan")

    graph, _ = _capture(launch, torch.cuda.Stream(dev))
    for _ in range(2):
        scratch.view(torch.int64).fill_(_ROUND1_WORD)
        plan.fill_(float("nan"))
        v.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(plan, plan_ref) and torch.equal(v, v_ref)


@pytest.mark.parametrize("wrapper", ["fused_sinkhorn_plan",
                                     "fused_blend_topk"])
def test_captured_wrapper_replays_and_counts_per_replay(dev, wrapper):
    """A wrapper called under capture launches nothing and counts into
    the open tally, not into `launches`; the graph replays bitwise equal
    to the eager call, twice, on the scratch and outputs it allocated in
    its pool."""
    from gie_tpu_torch import ops

    if wrapper == "fused_sinkhorn_plan":
        fn, args = fused_sinkhorn_plan, _sinkhorn_inputs(1024, 256, 5, dev)
    else:
        fn, args = fused_blend_topk, _topk_inputs(6, 1024, 256, 5, dev)
    ref = fn(*args)
    torch.cuda.synchronize()
    before = fn.launches
    counted = {}
    with ops.tally(counted):
        graph, out = _capture(lambda: fn(*args), torch.cuda.Stream(dev))
    assert counted == {fn: 1} and fn.launches == before
    for _ in range(2):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("config", ["tuned+sinkhorn-kernel", "topk-kernel"])
def test_scheduler_refuses_an_unavailable_kernel_at_construction(
        dev, config, monkeypatch):
    """A CUDA Scheduler builds and loads the kernels its profile launches
    (and checks the Sinkhorn layout at every wave bucket) when it is
    constructed: a build or shape refusal raises there, not in a wave."""
    from gie_tpu_torch.ops import KernelUnavailable, ShapeRefused, build
    from gie_tpu_torch.ops import fused_sinkhorn as fs

    if config == "topk-kernel":
        cfg = ProfileConfig(picker="topk", use_pallas_topk=True)
    else:
        cfg = dataclasses.replace(tuned_profile()[0], use_pallas_sinkhorn=True)
    Scheduler(cfg, device=dev)
    assert build._lib is not None
    seen = []

    def refuse(device, n, m):
        seen.append((n, m))
        raise ShapeRefused(f"N={n} x M={m} refused")

    monkeypatch.setattr(fs, "layout", refuse)
    if config == "topk-kernel":
        Scheduler(cfg, device=dev)            # no Sinkhorn kernel to check
        assert not seen

        def no_library():
            raise KernelUnavailable("build failed")

        monkeypatch.setattr(build, "library", no_library)
    with pytest.raises(KernelUnavailable):
        Scheduler(cfg, device=dev)


def test_kernel_error_codes_name_launch_refusals(dev):
    """The codes ops.build.KERNEL_ERRORS takes for a kernel that cannot run
    are the runtime's launch refusals; an illegal address is not one."""
    from gie_tpu_torch.ops import build

    text = {e: build.library().gie_cuda_error_string(e).decode().lower()
            for e in (*build.KERNEL_ERRORS, 700)}
    assert "invalid configuration" in text[9]
    assert "invalid device function" in text[98]
    assert "no kernel image" in text[209]
    assert "too many resources" in text[701]
    assert "cooperative" in text[720]
    assert "illegal" in text[700] and 700 not in build.KERNEL_ERRORS


@pytest.mark.parametrize("config", ["tuned+sinkhorn-kernel", "topk-kernel"])
def test_scheduler_on_card_matches_cpu(dev, config):
    if config == "topk-kernel":
        cfg, weights = ProfileConfig(picker="topk", use_pallas_topk=True), None
        counter = fused_blend_topk
    else:
        cfg, weights = tuned_profile()
        cfg = dataclasses.replace(cfg, use_pallas_sinkhorn=True)
        counter = fused_sinkhorn_plan
    gen = torch.Generator(device=dev).manual_seed(0)
    drawn = []

    def noise(shape):
        drawn.append(gumbel_noise(shape, gen, dev))
        return drawn[-1]

    gpu = Scheduler(cfg, weights, noise_source=noise)   # device: cuda
    cpu = Scheduler(cfg, weights, device="cpu",
                    noise_source=lambda shape: drawn[-1].cpu())
    assert gpu.device.type == "cuda"
    rng = np.random.default_rng(2)
    kw = dict(queue=rng.integers(0, 50, 50).tolist(),
              kv=rng.uniform(0, 0.95, 50).tolist(), max_lora=8, m_slots=64)
    base = b"SYSTEM: You are a helpful assistant specialised in task %d. "
    before, warm_before = counter.launches, counter.warmup_launches
    for w in range(3):
        prompts = [(base % (i % 16)) * 6 + b"q %d" % (i + 64 * w)
                   for i in range(64)]
        rk = dict(prompts=prompts, lora_id=rng.integers(-1, 12, 64).tolist(),
                  m_slots=64)
        cpu.install_state(gpu.export_state())
        res = gpu.pick(make_requests(64, device=dev, **rk),
                       make_endpoints(50, device=dev, **kw))
        ref = cpu.pick(make_requests(64, **rk), make_endpoints(50, **kw))
        np.testing.assert_array_equal(res.status, ref.status)
        agree = (res.indices[:, 0] == ref.indices[:, 0]).mean()
        assert agree >= 0.95
    # Three replays of one graph, which its inline capture's warm-up pass
    # (one launch on a throwaway state) preceded.
    assert counter.launches == before + 3
    assert counter.warmup_launches == warm_before + 1


# -- the pick service on the card -----------------------------------------

SPIN = 10_000_000          # torch.cuda._sleep cycles: ~5 ms on an H100


def _wave_inputs(n=64, m=64, live=50, seed=3):
    """A wave as the batching picker hands it over: CPU tensors."""
    rng = np.random.default_rng(seed)
    base = b"SYSTEM: You are a helpful assistant specialised in task %d. "
    prompts = [(base % (i % 16)) * 6 + b"q %d" % i for i in range(n)]
    reqs = make_requests(n, prompts=prompts,
                         lora_id=rng.integers(-1, 12, n).tolist(), m_slots=m)
    eps = make_endpoints(live, queue=rng.integers(0, 50, live).tolist(),
                         kv=rng.uniform(0, 0.95, live).tolist(), max_lora=8,
                         m_slots=m)
    return reqs, eps


def _sinkhorn_scheduler():
    cfg, weights = tuned_profile()
    return Scheduler(dataclasses.replace(cfg, use_pallas_sinkhorn=True),
                     weights)


def test_pick_async_returns_while_its_wave_is_queued(dev):
    """pick_async makes no call that waits for the card: under
    set_sync_debug_mode("error") it raises on any, and queued behind a
    spin it returns with its wave's event still pending."""
    sched = _sinkhorn_scheduler()
    reqs, eps = _wave_inputs()
    for _ in range(3):                     # build, warm the pinned pool
        sched.pick(reqs, eps)
    torch.cuda.synchronize()
    torch.cuda._sleep(20 * SPIN)           # ~100 ms of queued device work
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        wave = sched.pick_async(reqs, eps, snapshot_load=True)
        host_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(before)
    assert not wave.event.query(), f"host took {host_s * 1e3:.2f} ms"
    assert host_s < 0.05
    res = wave.materialize()
    assert wave.event.query()
    assert (res.status == 0).all()
    assert np.isfinite(wave.materialize_load()).all()


def test_materialize_waits_for_its_own_wave_only(dev):
    """Wave k, then a long spin, then wave k+1 on the one stream:
    materialize() of wave k returns while wave k+1 is still queued."""
    sched = _sinkhorn_scheduler()
    reqs, eps = _wave_inputs()
    for _ in range(3):
        sched.pick(reqs, eps)
    torch.cuda.synchronize()
    first = sched.pick_async(reqs, eps)
    torch.cuda._sleep(40 * SPIN)           # ~200 ms between the waves
    second = sched.pick_async(reqs, eps)
    res = first.materialize()
    assert not second.event.query()
    assert (res.status == 0).all()
    assert (second.materialize().status == 0).all()


@pytest.mark.parametrize("config", ["tuned+sinkhorn-kernel", "topk-kernel"])
def test_batching_picker_answers_a_burst_on_card(dev, config):
    """64 concurrent picks through the port's BatchingTPUPicker over a
    Scheduler on the card: every pick answered with a live candidate,
    and the path's kernel launched once per dispatched wave."""
    from gie_tpu_torch.datastore import Datastore
    from gie_tpu_torch.datastore.objects import EndpointPool, Pod
    from gie_tpu_torch.extproc.pick import PickRequest
    from gie_tpu_torch.metricsio import MetricsStore
    from gie_tpu_torch.runtime.metrics import PIPELINE_WAVES
    from gie_tpu_torch.sched.batching import BatchingTPUPicker

    if config == "topk-kernel":
        sched = Scheduler(ProfileConfig(picker="topk", use_pallas_topk=True))
        counter = fused_blend_topk
    else:
        sched = _sinkhorn_scheduler()
        counter = fused_sinkhorn_plan
    ms = MetricsStore()
    ds = Datastore(on_slot_reclaimed=lambda s: (sched.evict_endpoint(s),
                                                ms.remove(s)))
    ds.pool_set(EndpointPool({"app": "x"}, [8000], "default"))
    for i in range(40):
        ds.pod_update_or_add(Pod(name=f"p{i}", labels={"app": "x"},
                                 ip=f"10.9.0.{i + 1}"))
    rng = np.random.default_rng(0)
    ms.update_rows([(ep.slot, {Metric.QUEUE_DEPTH: float(rng.integers(0, 50))},
                     (), ())
                    for ep in ds.endpoints()])
    picker = BatchingTPUPicker(sched, ds, ms, max_wait_s=0.002)
    try:
        picker.pick(PickRequest(headers={}, body=b"warm up"),
                    ds.pick_candidates())
        before, waves = counter.launches, PIPELINE_WAVES.value()
        barrier = threading.Barrier(64)
        got = [None] * 64

        def one(i):
            barrier.wait(30)
            got[i] = picker.pick(
                PickRequest(headers={}, body=b"prompt %d" % i * 20),
                ds.pick_candidates())

        threads = [threading.Thread(target=one, args=(i,)) for i in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        live = {ep.hostport for ep in ds.pick_candidates()}
        assert all(r is not None and r.endpoint in live for r in got)
        assert all(len(set(r.fallbacks)) == len(r.fallbacks) for r in got)
        dispatched = PIPELINE_WAVES.value() - waves
        assert counter.launches - before == dispatched >= 1
    finally:
        picker.close()


@pytest.mark.parametrize("config", ["tuned+sinkhorn-kernel", "topk-kernel"])
def test_degraded_wave_touches_no_cuda_and_probe_launches_once(dev, config):
    """With the ladder held at CACHED, a wave is answered host-side: no
    kernel launch, no CUDA allocation, nothing charged. When the probe
    interval has elapsed, the next wave is a probe through the device
    cycle: the path's kernel launches exactly once."""
    from gie_tpu_torch.datastore import Datastore
    from gie_tpu_torch.datastore.objects import EndpointPool, Pod
    from gie_tpu_torch.extproc.pick import PickRequest
    from gie_tpu_torch.metricsio import MetricsStore
    from gie_tpu_torch.resilience import (
        DegradationLadder, LadderConfig, ResilienceState, Rung)
    from gie_tpu_torch.runtime.metrics import DEGRADED_PICKS, PIPELINE_WAVES
    from gie_tpu_torch.sched.batching import BatchingTPUPicker

    if config == "topk-kernel":
        sched = Scheduler(ProfileConfig(picker="topk", use_pallas_topk=True))
        counter = fused_blend_topk
    else:
        sched = _sinkhorn_scheduler()
        counter = fused_sinkhorn_plan
    clock = {"t": 1000.0}
    rs = ResilienceState(ladder=DegradationLadder(
        LadderConfig(probe_interval_s=10.0), clock=lambda: clock["t"]),
        on_change=lambda r: None)
    ms = MetricsStore()
    ds = Datastore()
    ds.pool_set(EndpointPool({"app": "x"}, [8000], "default"))
    for i in range(40):
        ds.pod_update_or_add(Pod(name=f"p{i}", labels={"app": "x"},
                                 ip=f"10.9.0.{i + 1}"))
    ms.update_rows([(ep.slot, {Metric.QUEUE_DEPTH: float(ep.slot % 7)},
                     (), ()) for ep in ds.endpoints()])
    picker = BatchingTPUPicker(sched, ds, ms, max_wait_s=0.002,
                               resilience=rs)

    def pick(i):
        return picker.pick(PickRequest(headers={}, body=b"prompt %d" % i),
                           ds.pick_candidates())

    try:
        pick(0)                                  # FULL: builds the kernel
        rs.ladder.force_level(Rung.CACHED)
        assert rs.ladder.should_probe()          # the probe a descent arms
        torch.cuda.synchronize()
        launches, waves = counter.launches, PIPELINE_WAVES.value()
        degraded = DEGRADED_PICKS.value("cached")
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
        for i in range(1, 5):
            res = pick(i)
            assert res.charged_slot == -1 and res.endpoint
        assert counter.launches == launches
        assert PIPELINE_WAVES.value() == waves
        assert DEGRADED_PICKS.value("cached") == degraded + 4
        assert torch.cuda.memory_stats()[
            "allocation.all.allocated"] == allocs
        clock["t"] += 10.0                       # the probe interval
        res = pick(5)
        assert res.charged_slot >= 0
        assert counter.launches == launches + 1
        assert PIPELINE_WAVES.value() == waves + 1
    finally:
        picker.close()


# -- the ext-proc server on the card ---------------------------------------


def _card_runner(config: str, pods: int = 16):
    """The port's ExtProcServerRunner as main() builds it (no scheduler
    injected, so no device argument), scraping off and rows on a fixed
    clock, over a FakeCluster of `pods` ready pods."""
    import json
    import tempfile

    from gie_tpu_torch.api import types as api
    from gie_tpu_torch.controller import FakeCluster
    from gie_tpu_torch.datastore.objects import Pod
    from gie_tpu_torch.runtime.options import Options
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner
    from gie_tpu_torch.sched.types import Weights

    if config == "topk-kernel":
        cfg, weights = ProfileConfig(picker="topk", use_pallas_topk=True), None
    else:
        cfg, weights = tuned_profile()
        cfg = dataclasses.replace(cfg, use_pallas_sinkhorn=True)
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        json.dump({**dataclasses.asdict(cfg), "weights": dataclasses.asdict(
            weights if weights is not None else Weights.default())}, f)
    cluster = FakeCluster()
    cluster.apply_pool(api.InferencePool(
        metadata=api.ObjectMeta(name="pool"),
        spec=api.InferencePoolSpec(
            selector=api.LabelSelector(matchLabels={"app": "x"}),
            targetPorts=[api.Port(8000)])))
    for i in range(pods):
        cluster.apply_pod(Pod(name=f"p{i}", labels={"app": "x"},
                              ip=f"10.9.0.{i + 1}"))
    runner = ExtProcServerRunner(
        Options(pool_name="pool", resilience=False, obs=False,
                secure_serving=False, scheduler_config=f.name), cluster)
    runner.scraper.close()
    runner.setup()
    rng = np.random.default_rng(0)
    runner.metrics_store.update_rows(
        [(ep.slot, {Metric.QUEUE_DEPTH: float(rng.integers(0, 50))}, (), ())
         for ep in runner.datastore.endpoints()])
    return runner


class _GoldenStream:
    """Request headers, a JSON body, then the response headers echoing the
    pick, as Envoy sends them (in memory)."""

    def __init__(self, i: int):
        from gie_tpu_torch.extproc import envoy, pb

        self.pb, self.envoy = pb, envoy
        body = b'{"model": "adapter-%d", "prompt": "%s", "max_tokens": 64}' % (
            i % 4, b"SYSTEM: be brief. " * 20 + b"q %d" % i)
        self.frames = [
            pb.ProcessingRequest(request_headers=pb.HttpHeaders(
                headers=pb.HeaderMap(headers=[pb.HeaderValue(
                    key=":path", raw_value=b"/v1/completions")]))),
            pb.ProcessingRequest(request_body=pb.HttpBody(
                body=body, end_of_stream=True))]
        self.sent = []

    def recv(self):
        if not self.frames and len(self.sent) == 2:
            opts = self.sent[0].request_headers.response.header_mutation
            dest = [o.header.raw_value.decode() for o in opts.set_headers
                    if o.header.key == "x-gateway-destination-endpoint"]
            req = self.pb.ProcessingRequest(
                response_headers=self.pb.HttpHeaders(
                    headers=self.pb.HeaderMap(headers=[self.pb.HeaderValue(
                        key=":status", raw_value=b"200")])))
            req.metadata_context.filter_metadata["envoy.lb"].CopyFrom(
                self.envoy.make_dynamic_metadata(
                    "envoy.lb", {"x-gateway-destination-endpoint-served":
                                 dest[0].split(",")[0]},
                ).fields["envoy.lb"].struct_value)
            self.frames.append(req)
        return self.frames.pop(0) if self.frames else None

    def send(self, resp):
        self.sent.append(resp)


def test_runner_without_device_holds_its_state_on_the_card(dev):
    """main()'s runner builds its Scheduler with no device argument: the
    scheduler and its carried state live on the card, and a stream's
    pick launches the configured kernel there."""
    runner = _card_runner("topk-kernel")
    try:
        assert runner.scheduler.device.type == "cuda"
        before = fused_blend_topk.launches
        stream = _GoldenStream(0)
        runner.streaming.process(stream)
        assert len(stream.sent) == 3
        state = runner.scheduler.state
        tensors = [v for part in (state, state.prefix)
                   for v in vars(part).values() if isinstance(v, torch.Tensor)]
        assert len(tensors) >= 5 and all(t.is_cuda for t in tensors)
        assert fused_blend_topk.launches == before + 1
    finally:
        runner.stop()


@pytest.mark.parametrize("config", ["tuned+sinkhorn-kernel", "topk-kernel"])
def test_golden_stream_makes_no_synchronizing_call(dev, config):
    """A whole Envoy-shaped stream through runner.streaming.process (pick,
    headers and body responses, served feedback releasing the charge)
    under set_sync_debug_mode("error"): any call that waits for the card
    on the pick path raises and fails the stream."""
    runner = _card_runner(config)
    try:
        for i in range(3):                     # build, warm the pinned pool
            runner.streaming.process(_GoldenStream(i))
        # The first stream kicked the lattice warm; a device-wide
        # synchronize while it captures would fail both.
        for t in runner.picker._warm_threads:
            t.join(120)
        assert runner.picker._warm_threads
        torch.cuda.synchronize()
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            stream = _GoldenStream(7)
            runner.streaming.process(stream)
        finally:
            torch.cuda.set_sync_debug_mode(before)
        assert len(stream.sent) == 3
        assert stream.sent[0].WhichOneof("response") == "request_headers"
    finally:
        runner.stop()


# -- waves as replays of the captured cycle --------------------------------


def _config(config):
    """(cfg, weights, the path's kernel wrapper) of a card configuration;
    a "+pd" suffix turns on pd_disaggregation. "learned+sinkhorn-kernel"
    is the tuned Sinkhorn-kernel profile under the committed policy
    artifact's exponents, "tuned+random" the tuned profile with the random
    picker (no kernel: its wrapper is None)."""
    pd = config.endswith("+pd")
    if config == "learned+sinkhorn-kernel":
        from gie_tpu_torch.learn import artifact

        art = artifact.load_artifact("config/policy/storm-lora-v1.json")
        cfg, _ = tuned_profile()
        return (dataclasses.replace(cfg, use_pallas_sinkhorn=True,
                                    scorer="learned"),
                artifact.to_sched_weights(art), fused_sinkhorn_plan)
    if config == "tuned+random":
        cfg, weights = tuned_profile()
        return dataclasses.replace(cfg, picker="random"), weights, None
    if config.startswith("topk-kernel"):
        return (ProfileConfig(picker="topk", use_pallas_topk=True,
                              pd_disaggregation=pd), None, fused_blend_topk)
    cfg, weights = tuned_profile()
    return (dataclasses.replace(cfg, use_pallas_sinkhorn=True,
                                pd_disaggregation=pd), weights,
            fused_sinkhorn_plan)


def _recorded_scheduler(config, dev, seed=0):
    """A Scheduler on the card whose noise is drawn from a seeded generator
    and kept (`sched.drawn`), so an eager cycle can reuse a wave's."""
    cfg, weights, _ = _config(config)
    gen = torch.Generator(device=dev).manual_seed(seed)
    drawn = []

    def noise(shape):
        drawn.append(gumbel_noise(shape, gen, dev))
        return drawn[-1]

    sched = Scheduler(cfg, weights, noise_source=noise)
    sched.drawn = drawn
    return sched


def _replay_matches_eager(sched, reqs, eps):
    """One wave through pick() (a replay) against scheduling_cycle on a
    copy of the state it started from, with its noise; -> the result. The
    eager cycle's kernel launches are a comparison's and go to a tally of
    their own, not into the wrappers' `launches`."""
    from gie_tpu_torch import ops
    from gie_tpu_torch.sched.profile import (
        _batch_to_device, _copy_state, scheduling_cycle)
    from gie_tpu_torch.sched.types import bucket_for, pad_requests

    n, m = int(reqs.valid.shape[0]), int(eps.valid.shape[0])
    with sched._lock:
        # The wave applies the queued complete() calls first; so does
        # the copy it is checked against.
        sched._apply_queued()
        start = _copy_state(sched._use_bucket(m))
    res = sched.pick(reqs, eps)
    gumbel = sched.drawn[-1] if sched.cfg.picker != "topk" else None
    with ops.tally({}):
        ref, end = scheduling_cycle(
            start, pad_requests(_batch_to_device(reqs, sched.device),
                                bucket_for(n)),
            _batch_to_device(eps, sched.device), sched.weights, gumbel,
            cfg=sched.cfg)
    np.testing.assert_array_equal(res.indices, ref.indices[:n].cpu().numpy())
    np.testing.assert_array_equal(res.status, ref.status[:n].cpu().numpy())
    assert (res.prefill is None) == (ref.prefill is None)
    if ref.prefill is not None:
        np.testing.assert_array_equal(res.prefill,
                                      ref.prefill[:n].cpu().numpy())
    for k in ("scores", "affinity"):
        np.testing.assert_allclose(getattr(res, k),
                                   getattr(ref, k)[:n].cpu().numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    live = sched.state
    for a, b in ((live.prefix.keys, end.prefix.keys),
                 (live.prefix.present, end.prefix.present),
                 (live.prefix.ages, end.prefix.ages),
                 (live.rr, end.rr), (live.tick, end.tick)):
        assert torch.equal(a, b)
    for a, b in ((live.assumed_load, end.assumed_load),
                 (live.ot_v, end.ot_v)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    return res


@pytest.mark.parametrize("config", ["tuned+sinkhorn-kernel", "topk-kernel"])
def test_replayed_waves_match_the_eager_cycle(dev, config):
    """5 carried waves of 1024 requests x 256 endpoints, each a replay of
    the captured cycle, against the eager cycle on a copy of the state,
    with completion feedback between them; the path's kernel counts one
    launch a replay, and one warm-up launch for the one capture."""
    sched = _recorded_scheduler(config, dev)
    counter = _config(config)[2]
    before, warm = counter.launches, counter.warmup_launches
    for w in range(5):
        reqs, eps = _wave_inputs(n=1024, m=256, live=200, seed=w)
        res = _replay_matches_eager(sched, reqs, eps)
        assert (res.status == 0).mean() > 0.9
        sched.complete(res.indices[:512, 0], np.full(512, 0.5, np.float32))
    assert sched.warm_inline_compiles == 1
    assert list(sched._graphs) == [(1024, 256, 32)]
    assert counter.launches == before + 5
    assert counter.warmup_launches == warm + 1


@pytest.mark.parametrize("config", ["learned+sinkhorn-kernel", "tuned+random"])
def test_learned_and_random_replays_match_the_eager_cycle(dev, config):
    """3 carried waves of 1024 x 256 under the learned scorer (the
    multiplicative total into the Sinkhorn kernel) and under the random
    picker (the wave's noise scaled by sample_temperature), each a replay
    of the captured cycle, against the eager cycle on a copy of the state
    with the same noise; one Sinkhorn launch a learned wave, none for the
    random picker."""
    sched = _recorded_scheduler(config, dev)
    counter = _config(config)[2]
    before = {fn: fn.launches for fn in (fused_sinkhorn_plan,
                                         fused_blend_topk)}
    for w in range(3):
        reqs, eps = _wave_inputs(n=1024, m=256, live=200, seed=w)
        res = _replay_matches_eager(sched, reqs, eps)
        assert (res.status == 0).mean() > 0.9
        sched.complete(res.indices[:512, 0], np.full(512, 0.5, np.float32))
    assert len(sched.drawn) == 3 and sched.warm_inline_compiles == 1
    for fn, n in before.items():
        assert fn.launches == n + (3 if fn is counter else 0)


def test_save_state_during_waves_restores_a_consistent_state(dev, tmp_path):
    """save_state while another thread picks wave after wave on the card:
    each checkpoint restores (on the card and on the CPU) to the state
    after one of those waves, bit for bit, never a mix of two."""
    sched = _recorded_scheduler("tuned+sinkhorn-kernel", dev)
    states, errors = {}, []
    done = threading.Event()

    def waves():
        try:
            for w in range(16):
                reqs, eps = _wave_inputs(n=1024, m=256, live=200, seed=w % 4)
                sched.pick(reqs, eps)       # only picks change the state
                state = sched.export_state()
                states[int(state["tick"])] = state
        except Exception as e:          # reported by the main thread
            errors.append(e)
        finally:
            done.set()

    t = threading.Thread(target=waves)
    t.start()
    saves = []
    while not done.is_set() and len(saves) < 8:
        d = tmp_path / f"s{len(saves)}"
        sched.save_state(str(d))
        saves.append(d)
    t.join()
    assert not errors and saves
    states[0] = None                    # a save before the first wave
    for d in saves:
        for where in (dev, torch.device("cpu")):
            fresh = Scheduler(*_config("tuned+sinkhorn-kernel")[:2],
                              device=where)
            assert fresh.restore_state(str(d))
            got = fresh.export_state()
            want = states[int(got["tick"])]
            if want is None:
                continue
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("config", ["tuned+sinkhorn-kernel", "topk-kernel"])
def test_replay_reads_the_state_after_bucket_trips_and_installs(dev, config):
    """Graphs captured at M=64 and M=256 go on reading the live state after
    the state moves 64 -> 256 -> 64 and after install_state of another
    scheduler's digest: each wave equals the eager cycle on a copy of the
    state it started from, and no state tensor changes its storage."""
    sched = _recorded_scheduler(config, dev)
    other = _recorded_scheduler(config, dev, seed=1)
    for m in (64, 256, 64):
        _replay_matches_eager(sched, *_wave_inputs(n=64, m=m, live=50,
                                                   seed=m))
    ptrs = {(m, k): t.data_ptr() for m, st in sched._states.items()
            for k, t in vars(st).items() if torch.is_tensor(t)}
    for m in (256, 64):
        _replay_matches_eager(other, *_wave_inputs(n=64, m=m, live=50,
                                                   seed=7 + m))
        assert sched.install_state(other.export_state())
        assert sched.state is sched._states[m]
        _replay_matches_eager(sched, *_wave_inputs(n=64, m=m, live=50,
                                                   seed=9 + m))
    assert ptrs == {(m, k): t.data_ptr() for m, st in sched._states.items()
                    for k, t in vars(st).items() if torch.is_tensor(t)}
    assert sched.warm_inline_compiles == 2


@pytest.mark.parametrize("config", ["tuned+sinkhorn-kernel", "topk-kernel"])
def test_capture_beside_live_waves_and_completions(dev, config):
    """A lattice captured on a warm thread while another thread runs live
    waves and complete() feedback at another shape: neither breaks the
    other, and the freshly captured shapes then replay without an inline
    capture and equal the eager cycle."""
    sched = _recorded_scheduler(config, dev)
    reqs, eps = _wave_inputs(n=64, m=64, live=50, seed=1)
    sched.pick(reqs, eps)
    stop, errors, waves = threading.Event(), [], [0]

    def live():
        try:
            while not stop.is_set():
                res = sched.pick(reqs, eps)
                assert (res.status == 0).all()
                sched.complete(res.indices[:32, 0],
                               np.full(32, 0.25, np.float32))
                waves[0] += 1
        except Exception as e:          # reported below
            errors.append(e)

    t_live = threading.Thread(target=live)
    t_live.start()
    try:
        warm = sched.warm_lattice_async(256, 16)
        warm.join(timeout=300)
        assert not warm.is_alive()
    finally:
        stop.set()
        t_live.join(60)
    assert not errors, errors
    assert waves[0] >= 1 and not sched._warm_failures
    assert {(n, 256, 16) for n in N_BUCKETS} <= sched._warm_buckets
    inline = sched.warm_inline_compiles
    from gie_tpu_torch.sched.types import chunk_bucket_for

    for n in (1, 8, 200):
        r, e = _wave_inputs(n=n, m=256, live=200, seed=n)
        lanes = chunk_bucket_for(int(r.n_chunks.max()))
        assert lanes <= 16
        r = r.replace(chunk_hashes=r.chunk_hashes[:, :16].contiguous())
        _replay_matches_eager(sched, r, e)
    assert sched.warm_inline_compiles == inline


@pytest.mark.parametrize("config", ["tuned+sinkhorn-kernel", "topk-kernel"])
def test_a_warmed_wave_is_one_graph_launch(dev, config):
    """torch.profiler over 3 warmed waves: one cudaGraphLaunch a wave, and
    no kernel of the cycle launched from the host (only the noise draw's
    elementwise kernels on the sinkhorn path)."""
    from torch.profiler import ProfilerActivity, profile

    sched = _recorded_scheduler(config, dev)
    sched.noise_source = None            # the generator's own draw
    reqs, eps = _wave_inputs(n=1024, m=256, live=200)
    for _ in range(2):
        sched.pick(reqs, eps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            sched.pick(reqs, eps)
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages()}
    assert calls.get("cudaGraphLaunch", 0) == 3, calls
    kernels = calls.get("cudaLaunchKernel", 0) + calls.get(
        "cudaLaunchKernelExC", 0)
    assert kernels <= (3 * 6 if config != "topk-kernel" else 0), calls


@pytest.mark.parametrize("config", ["tuned+sinkhorn-kernel", "topk-kernel"])
def test_pick_async_host_time_on_a_warmed_wave(dev, config):
    """pick_async of a warmed 1024 x 256 wave handed over as CPU tensors
    (as the batching picker hands it) takes at most 2 ms of host time,
    the median of 20 waves."""
    sched = _recorded_scheduler(config, dev)
    sched.noise_source = None
    reqs, eps = _wave_inputs(n=1024, m=256, live=200)
    for _ in range(3):
        sched.pick(reqs, eps)
    torch.cuda.synchronize()
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        wave = sched.pick_async(reqs, eps)
        host.append(time.perf_counter() - t0)
        wave.materialize()
    median = sorted(host)[10]
    assert median <= 0.002, f"median {median * 1e3:.3f} ms"


@pytest.mark.parametrize("config", ["tuned+sinkhorn-kernel", "topk-kernel"])
def test_failed_capture_raises_through_the_picker(dev, config):
    """A cycle that cannot be captured (here: one that reads a device
    value on the host, which stream capture refuses) raises
    GraphCaptureFailed at pick_async; through a picker with a
    ResilienceState the wave fails instead of degrading, and the ladder
    stays at FULL."""
    from gie_tpu_torch.datastore import Datastore
    from gie_tpu_torch.datastore.objects import EndpointPool, Pod
    from gie_tpu_torch.extproc.pick import ExtProcError, PickRequest
    from gie_tpu_torch.metricsio import MetricsStore
    from gie_tpu_torch.ops import GraphCaptureFailed
    from gie_tpu_torch.resilience import ResilienceState
    from gie_tpu_torch.runtime.metrics import DEGRADED_PICKS
    from gie_tpu_torch.sched.batching import BatchingTPUPicker

    sched = Scheduler(_config(config)[0], _config(config)[1])
    real = sched._cycle

    def host_read(*args):
        result = real(*args)
        int(result.status.sum())          # a sync: refused under capture
        return result

    sched._cycle = host_read
    reqs, eps = _wave_inputs()
    with pytest.raises(GraphCaptureFailed):
        sched.pick_async(reqs, eps)
    ms, ds = MetricsStore(), Datastore()
    ds.pool_set(EndpointPool({"app": "x"}, [8000], "default"))
    for i in range(8):
        ds.pod_update_or_add(Pod(name=f"p{i}", labels={"app": "x"},
                                 ip=f"10.9.0.{i + 1}"))
    rs = ResilienceState()
    picker = BatchingTPUPicker(sched, ds, ms, max_wait_s=0.002,
                               resilience=rs)
    degraded = sum(DEGRADED_PICKS.value(r)
                   for r in ("cached", "round_robin", "static"))
    try:
        with pytest.raises(ExtProcError, match="could not be captured"):
            picker.pick(PickRequest(headers={}, body=b"x"),
                        ds.pick_candidates())
        assert int(rs.ladder.rung()) == 0 and not rs.ladder.transitions
        assert sum(DEGRADED_PICKS.value(r) for r in
                   ("cached", "round_robin", "static")) == degraded
        sched._cycle = real
        res = picker.pick(PickRequest(headers={}, body=b"y"),
                          ds.pick_candidates())
        assert res.charged_slot >= 0
    finally:
        picker.close()


@pytest.mark.parametrize("config", ["tuned+sinkhorn-kernel", "topk-kernel"])
def test_explain_on_card_matches_cpu(dev, config):
    """explain() on the card (eager build_stages on a copy of the state,
    at the live M bucket and resized to another) equals a CPU scheduler's
    on the same state: mask and shed exact, columns within 1e-5; the
    card's state is untouched."""
    cfg, weights, _ = _config(config)
    gpu = _recorded_scheduler(config, dev)
    cpu = Scheduler(cfg, weights, device="cpu")
    gpu.pick(*_wave_inputs(n=64, m=64, live=50, seed=4))
    cpu.install_state(gpu.export_state())
    before = gpu.export_state()
    for m in (64, 256):
        reqs, eps = _wave_inputs(n=40, m=m, live=50, seed=5)
        got, ref = gpu.explain(reqs, eps), cpu.explain(reqs, eps)
        assert set(got) == set(ref)
        for k in ref:
            if k in ("mask", "shed"):
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k], ref[k], atol=1e-5,
                                           rtol=0, err_msg=k)
    after = gpu.export_state()
    assert all(after[k].tobytes() == before[k].tobytes() for k in before)


def test_storm_twin_on_card_reaches_the_cpu_decisions(dev):
    """storm-equivalence under virtual time through the storm twin with its
    Scheduler on the card and then on the CPU, both drawing Gumbel noise
    from a CPU generator seeded alike (each draw moved to the engine's
    device): the same decision_fingerprint, so the same picks at the same
    virtual times, sheds, breaker events and rung trace."""
    from gie_tpu_torch.resilience import faults
    from gie_tpu_torch.storm.engine import run_scenario

    def noise(device):
        gen = torch.Generator()
        gen.manual_seed(7)
        return lambda shape: gumbel_noise(
            shape, gen, torch.device("cpu")).to(device)

    cards = []
    for device in (dev, torch.device("cpu")):
        try:
            cards.append(run_scenario(
                "storm-equivalence", virtual_time=True, device=device,
                noise_source=noise(device)).scorecard)
        finally:
            faults.uninstall()
            faults.set_clock(None)
    on_card, on_cpu = cards
    assert on_card["ok"] > 0 and on_card["client_5xx"] == 0
    assert on_card["decision_fingerprint"] == on_cpu["decision_fingerprint"]


# -- the pd dual pick and KV-cache events on the card ----------------------

def _role_wave(n, m, live, seed):
    """_wave_inputs with endpoint roles drawn from the seed: 3/8 prefill,
    3/8 decode, 1/4 both."""
    from gie_tpu_torch.sched.constants import Role

    reqs, eps = _wave_inputs(n=n, m=m, live=live, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    roles = rng.choice([int(Role.PREFILL)] * 3 + [int(Role.DECODE)] * 3
                       + [int(Role.BOTH)] * 2, m)
    return reqs, eps.replace(role=torch.from_numpy(roles.astype(np.int32)))


@pytest.mark.parametrize("config", ["tuned+sinkhorn-kernel+pd",
                                    "topk-kernel+pd"])
def test_pd_replays_match_the_eager_pd_cycle(dev, config):
    """3 carried pd waves of 1024 x 256, each a replay of the captured dual
    pick ([2, N, M] static noise, a static `prefill` output), against the
    eager cycle on a copy of the state; the Sinkhorn path launches its
    kernel twice a wave, the top-k path once (the prefill pick)."""
    sched = _recorded_scheduler(config, dev)
    counter = _config(config)[2]
    per_wave = 2 if counter is fused_sinkhorn_plan else 1
    before = counter.launches
    for w in range(3):
        reqs, eps = _role_wave(1024, 256, 200, seed=w)
        res = _replay_matches_eager(sched, reqs, eps)
        ok = res.status == 0
        assert ok.mean() > 0.9
        roles = eps.role.numpy()
        assert (roles[res.prefill[ok]] != 2).all()      # never DECODE-only
        assert (roles[res.indices[ok, 0]] != 1).all()   # never PREFILL-only
    assert counter.launches == before + 3 * per_wave
    graph = sched._graphs[(1024, 256, 32)]
    if counter is fused_sinkhorn_plan:
        assert tuple(graph.gumbel.shape) == (2, 1024, 256)


def test_cuda_fold_equals_cpu_fold_bit_for_bit(dev):
    """The same event program, grown to M=512 by slot 300 and with a
    10,000-hash batch (parts of 4096), through a Scheduler on the card and
    one on the CPU: equal exports."""
    cards = [Scheduler(ProfileConfig(), device=d)
             for d in (dev, torch.device("cpu"))]
    rng = np.random.default_rng(4)
    pool = rng.integers(1, 2**32, 20_000, dtype=np.uint32)
    program = [(2, pool[:10_000], pool[:0]), (7, pool[5000:5600], pool[:300]),
               (300, pool[100:164], pool[:0]), (2, pool[:0], pool[9000:9500])]
    for sched in cards:
        for slot, stored, removed in program:
            sched.apply_prefix_events(slot, stored, removed)
        sched.clear_prefix_endpoint(7)
    card, cpu = (sched.export_state() for sched in cards)
    assert cards[0].state.m == 512
    assert {m for m, _ in cards[0]._fold_graphs} == {64, 512}
    for k in cpu:
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)


@pytest.mark.parametrize("bound", [None, 512])
def test_events_from_32_threads_during_waves_equal_a_serial_replay(dev,
                                                                   bound):
    """32 threads push apply_prefix_events (and a cache reset each) while
    waves run. The calls only queue, and no fold runs on a pushing thread:
    each wave applies the queue first, in call order, and past the queue's
    bound (512 lanes forces it) the drainer thread applies it between
    waves. The order of folds and waves is recorded as the card applies
    them and replayed serially on the CPU: the prefix table, ages and tick
    equal bit for bit."""
    cfg = ProfileConfig(enable_prefix=False)   # waves move the tick only
    gpu = Scheduler(cfg)
    if bound is not None:
        gpu._QUEUE_MAX_LANES = bound
    waver = threading.current_thread().name
    log, threads_seen = [], set()
    fold, clear, apply = (gpu._fold_events, gpu._clear_prefix,
                          gpu._apply_queued)

    def logged_fold(calls):
        threads_seen.add(threading.current_thread().name)
        log.extend(("events",) + tuple(call) for call in calls)
        fold(calls)

    def logged_clear(slot):
        threads_seen.add(threading.current_thread().name)
        log.append(("clear", slot))
        clear(slot)

    def logged_apply():
        apply()
        if threading.current_thread().name == waver:
            log.append(("mark",))              # a wave follows

    gpu._fold_events, gpu._clear_prefix = logged_fold, logged_clear
    gpu._apply_queued = logged_apply
    reqs, eps = _wave_inputs(n=64, m=64, live=50, seed=9)
    gpu.pick(reqs, eps)                           # capture first
    log.clear()

    def pusher(t):
        rng = np.random.default_rng(t)
        for i in range(20):
            gpu.apply_prefix_events(
                t % 50, rng.integers(1, 2**32, 64, dtype=np.uint32),
                rng.integers(1, 2**32, 8, dtype=np.uint32))
            if i == 10:
                gpu.clear_prefix_endpoint(t % 50)

    threads = [threading.Thread(target=pusher, args=(t,)) for t in range(32)]
    for t in threads:
        t.start()
    waves = 0
    while any(t.is_alive() for t in threads) or waves < 10:
        gpu.pick(reqs, eps)
        waves += 1
    for t in threads:
        t.join()
    card = gpu.export_state()
    assert threads_seen <= {waver, "sched-queue-drain"}
    assert bound is None or "sched-queue-drain" in threads_seen
    cpu = Scheduler(cfg, device="cpu")
    cpu.pick(reqs, eps)
    marks = 0
    for entry in log:
        if entry[0] == "events":
            cpu.apply_prefix_events(*entry[1:])
        elif entry[0] == "clear":
            cpu.clear_prefix_endpoint(entry[1])
        else:
            marks += 1
            if marks <= waves:
                cpu.pick(reqs, eps)
    assert sum(e[0] == "events" for e in log) == 32 * 20
    assert sum(e[0] == "clear" for e in log) == 32
    ref = cpu.export_state()
    for k in ("prefix_keys", "prefix_present", "prefix_ages", "tick"):
        np.testing.assert_array_equal(card[k], ref[k], err_msg=k)


@pytest.mark.parametrize("config", ["tuned+sinkhorn-kernel+pd",
                                    "topk-kernel+pd"])
def test_pd_lattice_warms_and_explain_matches_cpu(dev, config):
    """A pd profile's lattice warms on a background thread like a classic
    one (no inline capture after the join), its waves replay the captured
    dual pick, and explain() on the card equals the CPU's."""
    cfg, weights, _ = _config(config)
    sched = Scheduler(cfg, weights)
    reqs, eps = _role_wave(64, 256, 200, seed=4)
    thread = sched.warm_lattice_async(256, int(reqs.chunk_hashes.shape[1]))
    thread.join(300)
    assert not thread.is_alive() and not sched._warm_failures
    res = sched.pick(reqs, eps)
    assert sched.warm_inline_compiles == 0
    assert res.prefill is not None and (res.status == 0).mean() > 0.9
    cpu = Scheduler(cfg, weights, device="cpu")
    assert cpu.install_state(sched.export_state())
    got, ref = sched.explain(reqs, eps), cpu.explain(reqs, eps)
    for k in ref:
        if k in ("mask", "shed"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=0,
                                       err_msg=k)


_HELD_SERVER = r"""
import ctypes, sys, time
from gie_tpu_torch.extproc.workers import ExtProcWorkerPool

class Session:
    done = False
    def feed(self, data):
        return [data]
    def close(self, error):
        pass

class Streaming:
    def wire_session(self):
        return Session()

pool = ExtProcWorkerPool(Streaming(), 1, wire=True)
print(pool.bind("127.0.0.1:0"), flush=True)
pool.start()
sys.stdin.readline()                         # the client is connected
time.sleep(0.5)
ctypes.PyDLL(None).sleep(int(sys.argv[1]))   # blocks with the GIL held
time.sleep(int(sys.argv[1]) / 2 + 5)
pool.stop(0).wait(10)
"""


def test_acceptor_answers_a_stream_that_waited_past_30_s(dev):
    """grpcio 1.80 cancels a call that its server has not taken up within
    30 s, and a call is taken up by the acceptor's poller thread, which
    needs the GIL. The port's acceptors raise that limit
    (extproc/workers.py UNREQUESTED_MAX_S): with the server's GIL held
    35 s while a stream opens every 0.5 s, every stream is answered, the
    longest after waiting past 30 s."""
    import subprocess
    import sys

    import grpc

    hold = 35
    server = subprocess.Popen(
        [sys.executable, "-c", _HELD_SERVER, str(hold)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        port = int(server.stdout.readline())
        chan = grpc.insecure_channel(f"127.0.0.1:{port}")
        method = chan.stream_stream(
            "/envoy.service.ext_proc.v3.ExternalProcessor/Process")
        assert list(method(iter([b"warm"]), timeout=30)) == [b"warm"]
        server.stdin.write("go\n")
        server.stdin.flush()
        out = []

        def one(i):
            time.sleep(i * 0.5)
            t0 = time.monotonic()
            try:
                got = list(method(iter([b"x%d" % i]), timeout=3 * hold))
                out.append((got == [b"x%d" % i], time.monotonic() - t0))
            except grpc.RpcError as e:
                out.append((f"{e.code()}: {e.details()}",
                            time.monotonic() - t0))

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(2 * hold)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(4 * hold)
        chan.close()
        assert not any(t.is_alive() for t in threads)
        assert [o for o in out if o[0] is not True] == []
        assert len(out) == 2 * hold and max(w for _, w in out) > 30.0
    finally:
        server.kill()
        server.wait(30)
