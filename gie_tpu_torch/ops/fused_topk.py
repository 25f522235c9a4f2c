"""fused_blend_topk: the blend + top-k CUDA kernel and its plain version.

Port of gie_tpu/ops/fused_topk.py. The kernel (ops/csrc/fused_topk.cu, one
warp per request row, 16-byte loads, a per-lane top-k list in registers)
runs on CUDA tensors; `fused_blend_topk_reference`
computes the same function in plain PyTorch and runs on CPU tensors. Both
return (values f32[N, k], indices i32[N, k]); ties go to the lowest index,
and ineligible lanes read NEG_SCORE.
"""

from __future__ import annotations

import torch

from gie_tpu_torch.ops import (
    ShapeRefused, build, check_input, costed, count_launch, current, on_cuda,
    raw_stream)
from gie_tpu_torch.sched.constants import NEG_SCORE as NEG

# What the kernel takes (ops/csrc/fused_topk.cu): S scorer columns and k
# rounds up to these; any N and any M >= 1.
MAX_S = 8
MAX_K = 8


def fused_blend_topk_cost(s: int, n: int, m: int,
                          k: int = 4) -> tuple[int, int]:
    """(bytes, flops) of one call: the S columns and the mask read once,
    the weights read, k (value f32, index i32) pairs written per row; a
    multiply and an add per column and element, the mask select, and k
    rounds of a compare and a select."""
    return (s * n * m * 4 + n * m + s * 4 + n * k * 8,
            (2 * s + 1 + 2 * k) * n * m)


def fused_blend_topk_reference(
    stacked: torch.Tensor,  # f32[S, N, M]
    wvec: torch.Tensor,     # f32[S]
    mask: torch.Tensor,     # bool[N, M]
    *,
    k: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blend sum_s w[s] * col[s] in order s = 0, 1, ..., divided by
    max(sum w, 1e-6); masked lanes to NEG; then k rounds of (row max,
    first index holding it, mask that lane out)."""
    s, n, m = stacked.shape
    total = torch.zeros((n, m), dtype=torch.float32, device=stacked.device)
    wsum = torch.zeros((), dtype=torch.float32, device=stacked.device)
    for si in range(s):
        total = total + wvec[si] * stacked[si]
        wsum = wsum + wvec[si]
    total = total / torch.clamp(wsum, min=1e-6)
    neg = torch.full((), NEG, dtype=torch.float32, device=stacked.device)
    x = torch.where(mask, total, neg)
    iota = torch.arange(m, dtype=torch.int32, device=stacked.device)
    vals, idxs = [], []
    for _ in range(k):
        rowmax = x.amax(dim=1, keepdim=True)
        idx = torch.where(x == rowmax, iota, m).amin(dim=1, keepdim=True)
        vals.append(rowmax[:, 0])
        idxs.append(idx[:, 0])
        x = torch.where(iota[None, :] == idx, neg, x)
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def fused_blend_topk(
    stacked: torch.Tensor,
    wvec: torch.Tensor,
    mask: torch.Tensor,
    *,
    k: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (values f32[N, k], indices i32[N, k]). CPU tensors: the plain
    version. CUDA tensors: the CUDA kernel (built on first use), or an
    exception. The kernel takes 1 <= S <= MAX_S, 1 <= k <= MAX_K and any
    N and M."""
    s, n, m = stacked.shape
    with costed(fused_blend_topk, *fused_blend_topk_cost(s, n, m, k)):
        if not on_cuda(stacked, wvec, mask):
            return fused_blend_topk_reference(stacked, wvec, mask, k=k)
        return _launch(stacked, wvec, mask, k)


def _launch(stacked, wvec, mask, k):
    """The kernel on CUDA inputs of one card: checked, launched, counted."""
    s, n, m = stacked.shape
    check_input(stacked, "stacked", torch.float32, (s, n, m))
    check_input(wvec, "wvec", torch.float32, (s,))
    check_input(mask, "mask", torch.bool, (n, m))
    if not (1 <= s <= MAX_S and 1 <= k <= MAX_K):
        raise ShapeRefused(f"fused_blend_topk takes 1 <= S <= {MAX_S} scorer "
                         f"columns and 1 <= k <= {MAX_K}; got S={s}, k={k}")
    lib = build.library()
    dev = stacked.device
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((n, k), dtype=torch.int32, device=dev)
    with current(dev):
        err = lib.gie_fused_blend_topk(
            stacked.data_ptr(), wvec.data_ptr(), mask.data_ptr(),
            vals.data_ptr(), idxs.data_ptr(), s, n, m, k, raw_stream(dev))
    build.check(err, "fused_blend_topk")
    count_launch(fused_blend_topk)
    return vals, idxs


# Launches of the CUDA kernel on live waves, and on throwaway states before
# a capture (ops.count_launch; plain-version calls count in neither).
fused_blend_topk.launches = 0
fused_blend_topk.warmup_launches = 0
