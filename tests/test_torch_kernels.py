"""The port's two kernels against the JAX reference.

On the CPU each wrapper computes its plain PyTorch version, which is held
here to the Pallas kernel run in interpret mode (the way the reference's
own tests run it). Tolerances: plan and duals atol=1e-5, the bar of the
reference's own Pallas-vs-XLA test (tests/test_sched_pipeline.py:485-535);
top-k indices exact, values atol=1e-6. The CUDA kernels themselves are held
to the plain versions on a card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gie_tpu.ops.fused_sinkhorn import fused_sinkhorn_plan as jax_sinkhorn
from gie_tpu.ops.fused_topk import fused_blend_topk as jax_blend_topk
from gie_tpu.sched import sinkhorn as jsinkhorn
from gie_tpu.utils.testing import make_endpoints

from gie_tpu_torch import convert
from gie_tpu_torch.ops import KernelUnavailable, build, on_cuda
from gie_tpu_torch.ops.fused_sinkhorn import (
    fused_sinkhorn_plan,
    fused_sinkhorn_plan_reference,
)
from gie_tpu_torch.ops.fused_topk import (
    fused_blend_topk,
    fused_blend_topk_reference,
)
from gie_tpu_torch.sched import sinkhorn

NEG = -1e9


def _sinkhorn_inputs(n, m, m_live, seed):
    rng = np.random.default_rng(seed)
    eps = make_endpoints(m_live, queue=rng.integers(0, 40, m_live).tolist(),
                         kv=rng.uniform(0, 0.9, m_live).tolist(), m_slots=m)
    cap = np.array(jsinkhorn.capacities(eps, float(n), queue_limit=128.0))
    k = np.where(rng.uniform(0, 1, (n, m)) > 0.5,
                 rng.uniform(0, 1, (n, m)), 0.0).astype(np.float32)
    k[:, m_live:] = 0.0
    k[3] = 0.0                                  # a row with no candidates
    warm = rng.uniform(0.05, 1.0, m).astype(np.float32)
    return eps, k, cap, warm


@pytest.mark.parametrize("n, m", [(64, 64), (48, 256)])
@pytest.mark.parametrize("start", ["cold", "warm"])
def test_sinkhorn_plain_matches_pallas_interpret(n, m, start):
    _, k, cap, warm = _sinkhorn_inputs(n, m, m_live=min(m, 40), seed=n + m)
    v_init = np.ones(m, np.float32) if start == "cold" else warm
    plan_ref, v_ref = jax_sinkhorn(jnp.asarray(k), jnp.asarray(cap),
                                   jnp.asarray(v_init), iters=8,
                                   interpret=True)
    plan, v = fused_sinkhorn_plan_reference(
        torch.from_numpy(k), torch.from_numpy(cap), torch.from_numpy(v_init),
        iters=8)
    np.testing.assert_allclose(plan.numpy(), np.asarray(plan_ref), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=1e-5)
    # The wrapper on CPU tensors is the plain version, and counts nothing.
    before = fused_sinkhorn_plan.launches
    plan_w, v_w = fused_sinkhorn_plan(
        torch.from_numpy(k), torch.from_numpy(cap), torch.from_numpy(v_init))
    assert torch.equal(plan_w, plan) and torch.equal(v_w, v)
    assert fused_sinkhorn_plan.launches == before


@pytest.mark.parametrize("n, m", [(64, 64), (48, 256)])
@pytest.mark.parametrize("start", ["cold", "warm"])
def test_dual_form_solve_matches_reference(n, m, start):
    _, k, cap, warm = _sinkhorn_inputs(n, m, m_live=min(m, 40), seed=7 + m)
    v_init = np.ones(m, np.float32) if start == "cold" else warm
    plan_ref, v_ref = jsinkhorn._solve_plan(
        jnp.asarray(k), jnp.asarray(cap), jnp.asarray(v_init), iters=8,
        mesh=None)
    plan, v = sinkhorn._solve_plan(
        torch.from_numpy(k), torch.from_numpy(cap), torch.from_numpy(v_init),
        iters=8)
    np.testing.assert_allclose(plan.numpy(), np.asarray(plan_ref), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=1e-5)
    # And the dual form agrees with the kernel's matrix form.
    plan_m, v_m = fused_sinkhorn_plan_reference(
        torch.from_numpy(k), torch.from_numpy(cap), torch.from_numpy(v_init))
    np.testing.assert_allclose(plan.numpy(), plan_m.numpy(), atol=1e-5)
    np.testing.assert_allclose(v.numpy(), v_m.numpy(), atol=1e-5)


@pytest.mark.parametrize("m", [64, 256])
def test_capacities_match_reference(m):
    eps, _, _, _ = _sinkhorn_inputs(16, m, m_live=40, seed=m)
    teps = convert.endpoints_from_numpy(eps, device="cpu")
    ref = jsinkhorn.capacities(eps, 37.0, queue_limit=128.0)
    port = sinkhorn.capacities(teps, torch.tensor(37.0), queue_limit=128.0)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-6)


def _topk_inputs(s, n, m, seed):
    rng = np.random.default_rng(seed)
    stacked = rng.uniform(0, 1, (s, n, m)).astype(np.float32)
    stacked[:, 4, :] = 0.5                      # a row of exact ties
    wvec = np.asarray([2.0, 1.0, 1.5, 4.0, 8.0, 1.0][:s], np.float32)
    mask = rng.uniform(size=(n, m)) < 0.7
    mask[5] = False                             # a fully masked row
    mask[6] = False
    mask[6, [3, 9]] = True                      # fewer candidates than k
    return stacked, wvec, mask


@pytest.mark.parametrize("s, n, m", [(6, 64, 64), (6, 32, 256), (3, 8, 64),
                                     (3, 16, 40), (6, 16, 40), (3, 16, 96),
                                     (6, 16, 96)])
def test_blend_topk_plain_matches_pallas_interpret(s, n, m):
    stacked, wvec, mask = _topk_inputs(s, n, m, seed=s + n + m)
    v_ref, i_ref = jax_blend_topk(jnp.asarray(stacked), jnp.asarray(wvec),
                                  jnp.asarray(mask), k=4, interpret=True)
    vals, idx = fused_blend_topk_reference(
        torch.from_numpy(stacked), torch.from_numpy(wvec),
        torch.from_numpy(mask), k=4)
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(vals.numpy(), np.asarray(v_ref), atol=1e-6)
    # Ties go to the lowest index; a masked row reads NEG at lane 0.
    np.testing.assert_array_equal(idx[4].numpy(),
                                  np.sort(idx[4].numpy()))
    assert (vals[5] == NEG).all() and (idx[5] == 0).all()
    assert sorted(idx[6, :2].tolist()) == [3, 9]
    assert idx[6, 2:].tolist() == [0, 0]        # then the first NEG lane
    before = fused_blend_topk.launches
    vals_w, idx_w = fused_blend_topk(torch.from_numpy(stacked),
                                     torch.from_numpy(wvec),
                                     torch.from_numpy(mask))
    assert torch.equal(vals_w, vals) and torch.equal(idx_w, idx)
    assert fused_blend_topk.launches == before


def test_dispatch_rule_refuses_other_devices():
    cpu = torch.zeros(2)
    assert on_cuda(cpu, cpu) is False
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        on_cuda(cpu, torch.zeros(2, device="meta"))


def test_kernel_sources_are_keyed():
    names = sorted(p.rsplit("/", 1)[-1] for p in build._sources())
    assert names == ["errors.cu", "fused_sinkhorn.cu", "fused_topk.cu"]
    assert build.source_hash() == build.source_hash()


def test_build_failure_raises_kernel_unavailable(monkeypatch, tmp_path):
    """A build that cannot run (no nvcc here) is KernelUnavailable, the
    error the picker re-raises instead of degrading around it."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    with pytest.raises(KernelUnavailable, match="nvcc not found"):
        build.library()
    assert build._lib is None


@pytest.mark.parametrize("err, kernel", [(9, True), (209, True), (720, True),
                                         (700, False), (719, False)])
def test_launch_errors_split_kernel_from_device(monkeypatch, err, kernel):
    """Launch configuration refused -> KernelUnavailable; an error of the
    device (illegal address, launch failure: sticky on CUDA) -> a plain
    RuntimeError, which the degradation ladder takes."""
    lib = type("Lib", (), {"gie_cuda_error_string":
                           staticmethod(lambda e: b"text")})
    monkeypatch.setattr(build, "library", lambda: lib)
    with pytest.raises(RuntimeError, match=f"CUDA error {err}") as info:
        build.check(err, "k")
    assert isinstance(info.value, KernelUnavailable) is kernel
