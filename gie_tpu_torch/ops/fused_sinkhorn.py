"""fused_sinkhorn_plan: the Sinkhorn solve's CUDA kernel and its plain version.

Port of gie_tpu/ops/fused_sinkhorn.py. The kernel (ops/csrc/fused_sinkhorn.cu:
one cooperative persistent launch, K resident in shared memory, dual form,
no atomics) runs on CUDA tensors; `fused_sinkhorn_plan_reference` is the
matrix-form loop of the TPU kernel in plain PyTorch and runs on CPU tensors.
Both return (row-normalized plan f32[N, M], column duals f32[M]).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from gie_tpu_torch.ops import (
    ShapeRefused, build, check_input, count_launch, current, on_cuda,
    raw_stream)


class Layout(NamedTuple):
    """The launch geometry the kernel picks for one shape on one device."""

    grid: int
    rows: int
    smem_bytes: int
    smem_max: int
    scratch_floats: int
    sms: int
    blocks_per_sm: int


_layouts: dict = {}


def layout(device: torch.device, n: int, m: int) -> Layout:
    """The kernel's grid, band and scratch for an [n, m] solve (cached per
    device and shape). Raises ShapeRefused when a block's K slab does not fit
    in shared memory: the kernel takes N up to SMs x the rows one block
    holds (7128 rows at M=1024 on a 132-SM H100)."""
    key = (device.index, n, m)
    lay = _layouts.get(key)
    if lay is None:
        out = (ctypes.c_int * len(Layout._fields))()
        with current(device):
            err = build.library().gie_fused_sinkhorn_layout(n, m, out)
        build.check(err, "fused_sinkhorn_plan")
        lay = _layouts[key] = Layout(*out)
    if lay.smem_bytes > lay.smem_max:
        raise ShapeRefused(
            f"fused_sinkhorn_plan: N={n} x M={m} needs a K slab of {lay.rows} "
            f"rows per block, {lay.smem_bytes} bytes of shared memory; a "
            f"block has at most {lay.smem_max}")
    return lay


def fused_sinkhorn_plan_reference(
    kernel_matrix: torch.Tensor,    # f32[N, M] masked Gibbs weights
    cap: torch.Tensor,              # f32[M] per-endpoint wave capacity
    v_init: Optional[torch.Tensor] = None,  # f32[M] warm-start duals
    *,
    iters: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's loop: plan_0 = K diag(v_init); `iters` rounds of
    row-normalize then column-cap (v carries the running product of the
    column scales); one final row-normalize."""
    m = kernel_matrix.shape[1]
    if v_init is None:
        v_init = torch.ones((m,), dtype=torch.float32,
                            device=kernel_matrix.device)
    one = torch.ones((), dtype=torch.float32, device=kernel_matrix.device)
    p = kernel_matrix * v_init[None, :]
    v = v_init
    for _ in range(iters):
        row = p.sum(dim=1, keepdim=True)
        p = torch.where(row > 0, p / row, p)
        col = p.sum(dim=0)
        scale = torch.where(col > cap, cap / torch.clamp(col, min=1e-9), one)
        p = p * scale[None, :]
        v = v * scale
    row = p.sum(dim=1, keepdim=True)
    return torch.where(row > 0, p / row, p), v


def fused_sinkhorn_plan(
    kernel_matrix: torch.Tensor,
    cap: torch.Tensor,
    v_init: Optional[torch.Tensor] = None,
    *,
    iters: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (plan f32[N, M], v f32[M]). CPU tensors: the plain version. CUDA
    tensors: the CUDA kernel (built on first use), or an exception."""
    m = kernel_matrix.shape[1]
    if v_init is None:
        v_init = torch.ones((m,), dtype=torch.float32,
                            device=kernel_matrix.device)
    if not on_cuda(kernel_matrix, cap, v_init):
        return fused_sinkhorn_plan_reference(
            kernel_matrix, cap, v_init, iters=iters)
    n = kernel_matrix.shape[0]
    check_input(kernel_matrix, "kernel_matrix", torch.float32, (n, m))
    check_input(cap, "cap", torch.float32, (m,))
    check_input(v_init, "v_init", torch.float32, (m,))
    dev = kernel_matrix.device
    lay = layout(dev, n, m)
    lib = build.library()
    plan = torch.empty((n, m), dtype=torch.float32, device=dev)
    v_out = torch.empty((m,), dtype=torch.float32, device=dev)
    scratch = torch.empty((lay.scratch_floats,), dtype=torch.float32,
                          device=dev)
    with current(dev):
        err = lib.gie_fused_sinkhorn_plan(
            kernel_matrix.data_ptr(), cap.data_ptr(), v_init.data_ptr(),
            plan.data_ptr(), v_out.data_ptr(), scratch.data_ptr(), n, m,
            iters, raw_stream(dev))
    build.check(err, "fused_sinkhorn_plan")
    count_launch(fused_sinkhorn_plan)
    return plan, v_out


# Launches of the CUDA kernel on live waves, and on throwaway states before
# a capture (ops.count_launch; plain-version calls count in neither).
fused_sinkhorn_plan.launches = 0
fused_sinkhorn_plan.warmup_launches = 0
