"""gie_tpu_torch's CUDA kernels on a card, against their plain versions.

Every test here needs a CUDA card (marker `cuda`) and skips without one;
the file imports neither JAX nor gie_tpu, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: sinkhorn plan and duals atol=1e-5 (the dual-form kernel sums
in another order than the plain matrix form); blend-top-k indices exact
and values atol=1e-5 (the kernel's blend is the plain version's rounded
f32 arithmetic in the same order).

The last tests hold the pick service's handoff to the card: pick_async
queues a wave without waiting for the device, a wave's materialize()
waits for that wave only, and the batching picker answers a burst."""

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
from gie_tpu_torch.sched.constants import Metric
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
    before = counter.launches
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
    assert counter.launches == before + 3


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
