"""Bytes and operations budget of the port's scheduling cycle.

The port's counterpart of tests/test_cost_budget.py: the same north-star
fixture as gie_tpu/utils/costmodel.py, counted op by op by
gie_tpu_torch/utils/costmodel.py (a TorchDispatchMode, the kernels'
declared costs once per call). Ceilings are the port's own measured
values + ~15%, the reference's rule (never XLA's numbers), and a 5 MB
floor guards against the count collapsing to nonsense. chip_smoke.py
phase 21 holds the card's count to this CPU count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from gie_tpu_torch import ops
from gie_tpu_torch.ops.fused_sinkhorn import (
    fused_sinkhorn_cost, fused_sinkhorn_plan)
from gie_tpu_torch.ops.fused_topk import (
    fused_blend_topk, fused_blend_topk_cost)
from gie_tpu_torch.sched import ProfileConfig
from gie_tpu_torch.utils import costmodel
from gie_tpu_torch.utils.costmodel import OpCounter, count_cycle, cycle_cost

CONFIGS = costmodel.configs()


def test_fixture_equals_the_reference_fixture():
    """The port's fixture is gie_tpu/utils/costmodel.py's, array for array
    (the same rng draws, prompts, LoRA ids and chunk bucket)."""
    from gie_tpu.sched.types import chunk_bucket_for
    from gie_tpu.utils.testing import make_endpoints, make_requests
    from gie_tpu_torch.convert import endpoints_to_numpy, requests_to_numpy

    n, m = 1024, 256
    rng = np.random.default_rng(0)
    eps = make_endpoints(
        m, queue=rng.integers(0, 50, m).tolist(),
        kv=rng.uniform(0, 0.95, m).tolist(), max_lora=8, m_slots=m)
    base = b"SYSTEM: task %d. "
    prompts = [(base % (i % 16)) * 6 + b"u%d" % i for i in range(n)]
    reqs = make_requests(
        n, prompts=prompts, lora_id=rng.integers(-1, 12, n).tolist(),
        m_slots=m)
    cb = chunk_bucket_for(int(np.asarray(reqs.n_chunks).max()))
    reqs = reqs.replace(chunk_hashes=reqs.chunk_hashes[:, :cb])

    t_reqs, t_eps = costmodel.fixture(n, m, "cpu")
    for got, want in ((requests_to_numpy(t_reqs), reqs),
                      (endpoints_to_numpy(t_eps), eps)):
        for name, arr in got.items():
            ref = np.asarray(getattr(want, name))
            assert arr.shape == ref.shape, name
            np.testing.assert_array_equal(arr, ref.astype(arr.dtype),
                                          err_msg=name)
    assert t_reqs.chunk_hashes.shape[1] == cb


@pytest.mark.parametrize("name", list(CONFIGS))
def test_counts_are_deterministic(name):
    a = count_cycle(CONFIGS[name], device="cpu")
    b = count_cycle(CONFIGS[name], device="cpu")
    assert a.totals() == b.totals()
    assert a.by_op == b.by_op and a.bytes_by_op == b.bytes_by_op
    assert a.flops_by_op == b.flops_by_op
    assert sum(a.by_op.values()) == a.ops
    # Every op is attributed to the package function that called it.
    assert a.by_site == b.by_site and sum(a.by_site.values()) == a.ops
    assert "<outside>" not in a.by_site
    assert a.by_site.most_common(1)[0][0].startswith("sched/")


@pytest.mark.parametrize("name,kernel,cost", [
    ("tuned+use_pallas_sinkhorn", "fused_sinkhorn_plan",
     lambda n, m: fused_sinkhorn_cost(n, m, 8)),
    ("topk+use_pallas_topk", "fused_blend_topk",
     lambda n, m: fused_blend_topk_cost(6, n, m, 4)),
])
def test_a_kernels_declared_cost_counts_once(name, kernel, cost):
    """The wave's kernel call is one operation carrying its formula's
    bytes and flops; nothing of the plain version it runs on the CPU is
    counted (a kernel config counts fewer ops than its plain twin)."""
    n, m = 1024, 256
    c = count_cycle(CONFIGS[name], n, m, device="cpu")
    nbytes, flops = cost(n, m)
    assert c.by_op[kernel] == 1
    module = {"fused_sinkhorn_plan": "fused_sinkhorn",
              "fused_blend_topk": "fused_topk"}[kernel]
    assert c.by_site[f"ops/{module}.py:{kernel}"] == 1
    assert c.bytes_by_op[kernel] == nbytes
    assert c.flops_by_op[kernel] == flops
    plain = dataclasses.replace(CONFIGS[name], use_pallas_sinkhorn=False,
                                use_pallas_topk=False)
    assert c.ops < count_cycle(plain, n, m, device="cpu").ops


def test_wrapper_counts_its_call_once_and_its_plain_version_not_at_all():
    rng = np.random.default_rng(3)
    k = torch.from_numpy(rng.uniform(size=(16, 64)).astype(np.float32))
    cap = torch.full((64,), 2.0)
    stacked = torch.from_numpy(rng.uniform(size=(3, 16, 64))
                               .astype(np.float32))
    wvec = torch.tensor([1.0, 2.0, 3.0])
    mask = torch.from_numpy(rng.uniform(size=(16, 64)) < 0.7)
    v = torch.ones(64)
    counter = OpCounter()
    with ops.cost_sink(counter), counter:
        fused_sinkhorn_plan(k, cap, v)
        fused_blend_topk(stacked, wvec, mask, k=4)
    assert dict(counter.count.by_op) == {"fused_sinkhorn_plan": 1,
                                         "fused_blend_topk": 1}
    assert counter.count.bytes == (fused_sinkhorn_cost(16, 64)[0]
                                   + fused_blend_topk_cost(3, 16, 64)[0])
    # Without a sink the wrappers declare nothing and run as before.
    assert fused_sinkhorn_plan(k, cap, v)[0].shape == (16, 64)


def test_kernel_formulas_are_the_bound_chip_smoke_used():
    """The formulas chip_smoke.py's phase 2 inlined before they moved
    beside their kernels."""
    n, m = 1024, 256
    assert fused_sinkhorn_cost(n, m) == (2 * n * m * 4 + 3 * m * 4,
                                         (8 * 4 + 5) * n * m)
    for s in (6, 7):
        assert fused_blend_topk_cost(s, n, m) == (
            s * n * m * 4 + n * m + s * 4 + n * 4 * 8,
            (2 * s + 1 + 2 * 4) * n * m)


def test_op_counter_rules():
    """Views and allocations are free; a product is 2*M*N*K flops, a
    reduction one per input element, an elementwise op one per output
    element; an op's bytes are its distinct tensors' (a broadcast input
    read once, an in-place operand once)."""
    a = torch.ones(8, 4)
    b = torch.ones(4, 3)
    row = torch.ones(1, 4)
    counter = OpCounter()
    with counter:
        a.view(4, 8).t()
        torch.empty(5)
        a @ b                                   # mm
        a.sum(dim=1)                            # reduction
        a + row.expand(8, 4)                    # broadcast read once
        a.mul_(2.0)                             # in place
    c = counter.count
    assert dict(c.by_op) == {"mm": 1, "sum": 1, "add": 1, "mul_": 1}
    assert c.flops_by_op["mm"] == 2 * 8 * 4 * 3
    assert c.bytes_by_op["mm"] == (32 + 12 + 24) * 4
    assert c.flops_by_op["sum"] == 32
    assert c.bytes_by_op["add"] == (32 + 4 + 32) * 4
    assert c.bytes_by_op["mul_"] == 32 * 4 and c.flops_by_op["mul_"] == 32


def test_cuda_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cycle_cost(ProfileConfig())


def test_refuses_to_count_nothing(monkeypatch):
    monkeypatch.setattr("gie_tpu_torch.sched.profile.scheduling_cycle",
                        lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="vacuously"):
        cycle_cost(ProfileConfig(), n=8, m=64, device="cpu")


# Measured on the CPU (hack/torch_cost_analysis.py, 1024 x 256): bytes in
# MB and operations; ceilings = measured + ~15%, the reference's rule.
#   default-topk                 338.010456 MB, 363 ops
#   sinkhorn / tuned             429.013728 MB, 677 ops
#   tuned+use_pallas_sinkhorn    366.426784 MB, 431 ops
#   topk+use_pallas_topk         284.360972 MB, 318 ops
@pytest.mark.parametrize("name,ceiling_mb,ceiling_ops", [
    ("default-topk", 389.0, 417),
    ("sinkhorn", 493.0, 778),
    ("tuned", 493.0, 778),
    ("tuned+use_pallas_sinkhorn", 421.0, 495),
    ("topk+use_pallas_topk", 327.0, 365),
])
def test_cycle_bytes_and_ops_budget(name, ceiling_mb, ceiling_ops):
    got = cycle_cost(CONFIGS[name], device="cpu")
    mb = got["bytes"] / 1e6
    assert mb >= 5.0, (
        f"{name} cycle counts only {mb:.1f} MB — the counter is no longer "
        "measuring the real program")
    assert mb <= ceiling_mb, (
        f"{name} cycle now moves {mb:.1f} MB (> {ceiling_mb} MB): run "
        "hack/torch_cost_analysis.py to see which ops grew")
    assert got["ops"] <= ceiling_ops, (
        f"{name} cycle now runs {got['ops']:.0f} device operations "
        f"(> {ceiling_ops}): run hack/torch_cost_analysis.py")
    assert got["flops"] > 0
