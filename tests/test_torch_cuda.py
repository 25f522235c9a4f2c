"""gie_tpu_torch's CUDA kernels on a card, against their plain versions.

Every test here needs a CUDA card (marker `cuda`) and skips without one;
the file imports neither JAX nor gie_tpu, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: sinkhorn plan and duals atol=1e-5 (the dual-form kernel sums
in another order than the plain matrix form); blend-top-k indices exact
and values atol=1e-5 (the kernel's blend is the plain version's rounded
f32 arithmetic in the same order)."""

import dataclasses

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
