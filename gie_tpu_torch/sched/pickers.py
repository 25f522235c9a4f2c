"""Pick stage: scores + mask -> ordered endpoint lists + status (port of
gie_tpu/sched/pickers.py). 503 when a request has no eligible endpoint,
429 when a SHEDDABLE request is load-shed."""

from __future__ import annotations

import torch

from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.types import PickResult

NEG = C.NEG_SCORE

# Score quantization for the topk picker's rotating tie-break (see the
# reference module): deltas below _TIE_RESOLUTION are ties, broken by a
# rotation strictly below one quantum.
_TIE_RESOLUTION = float(1.0 / 4096.0)
_TIE_EPS = _TIE_RESOLUTION / float(C.M_MAX + 1)


def _topk(masked: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Iterative top-k by strict threshold descent: round j takes the max
    (first index on ties) over {x : x < bound_{j-1}}. Needs pairwise
    distinct in-row values to list ties as separate entries, which every
    caller guarantees (rotation or _iota_tiebreak)."""
    vals, idxs = [], []
    bound = torch.full(masked.shape[:-1], float("inf"), dtype=masked.dtype,
                       device=masked.device)
    neg = torch.full((), NEG, dtype=masked.dtype, device=masked.device)
    for _ in range(k):
        x = torch.where(masked < bound[:, None], masked, neg)
        v, i = x.max(dim=-1)
        vals.append(v)
        idxs.append(i.to(torch.int32))
        bound = v
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def _iota_tiebreak(masked: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace the low ceil(log2(M)) mantissa bits of every eligible lane
    with its lane index (an f32 <-> i32 bit view), so in-row values are
    pairwise distinct by construction. Ineligible lanes keep NEG."""
    m = masked.shape[-1]
    low = (1 << max((m - 1).bit_length(), 1)) - 1
    lane = torch.arange(m, dtype=torch.int32, device=masked.device)
    bits = masked.contiguous().view(torch.int32)
    bits = (bits & ~low) | lane[None, :]
    return torch.where(mask, bits.view(torch.float32), masked)


def finalize_from_topk(
    top_scores: torch.Tensor,  # f32[N, k] (NEG-filled where ineligible)
    top_idx: torch.Tensor,     # i32[N, k]
    mask: torch.Tensor,
    shed: torch.Tensor,
    valid: torch.Tensor,
) -> PickResult:
    """Status/index gating shared by every picker (the fused kernel path
    included): ok-threshold, NO_CAPACITY/SHED cascade, OK-only indices."""
    ok = top_scores > NEG / 2
    minus1 = torch.full_like(top_idx, -1, dtype=torch.int32)
    indices = torch.where(ok, top_idx.to(torch.int32), minus1)

    def code(s: C.Status) -> torch.Tensor:
        return torch.full(valid.shape, int(s), dtype=torch.int32,
                          device=valid.device)

    any_candidate = mask.any(dim=-1)
    status = torch.where(any_candidate, code(C.Status.OK),
                         code(C.Status.NO_CAPACITY))
    status = torch.where(shed, code(C.Status.SHED), status)
    status = torch.where(valid, status, code(C.Status.NO_CAPACITY))

    indices = torch.where((status == int(C.Status.OK))[:, None], indices,
                          minus1)
    return PickResult(indices=indices, status=status, scores=top_scores)


def _finalize(
    masked: torch.Tensor,  # f32[N, M] with ineligible lanes at NEG
    mask: torch.Tensor,
    shed: torch.Tensor,
    valid: torch.Tensor,
    *,
    lane_tiebreak: bool = True,
) -> PickResult:
    """Shared pick postlude: top-k fallback list + status gating.
    topk_picker opts out of the lane tiebreak (its rotation already makes
    values distinct)."""
    if lane_tiebreak:
        masked = _iota_tiebreak(masked, mask)
    top_scores, top_idx = _topk(masked, C.FALLBACKS)
    return finalize_from_topk(top_scores, top_idx, mask, shed, valid)


def topk_picker(
    scores: torch.Tensor,  # f32[N, M]
    mask: torch.Tensor,    # bool[N, M]
    shed: torch.Tensor,    # bool[N]
    valid: torch.Tensor,   # bool[N]
    rr: torch.Tensor,      # int64 scalar (u32 tie-break counter)
) -> PickResult:
    """Deterministic best-score picker: scores quantized to
    _TIE_RESOLUTION, ties broken by a lane rotation derived from `rr`."""
    m = scores.shape[-1]
    quantized = torch.round(scores / _TIE_RESOLUTION) * _TIE_RESOLUTION
    lane = torch.arange(m, dtype=torch.int64, device=scores.device)
    rot = (((lane + rr) & C.U32_MASK) % m).to(torch.float32)
    neg = torch.full((), NEG, dtype=torch.float32, device=scores.device)
    masked = torch.where(mask, quantized + rot * _TIE_EPS, neg)
    return _finalize(masked, mask, shed, valid, lane_tiebreak=False)


def weighted_random_picker(
    scores: torch.Tensor,  # f32[N, M]
    mask: torch.Tensor,    # bool[N, M]
    shed: torch.Tensor,    # bool[N]
    valid: torch.Tensor,   # bool[N]
    gumbel: torch.Tensor,  # f32[N, M] standard Gumbel noise
    *,
    temperature: float = 0.05,
) -> PickResult:
    """Gumbel-top-k sampling picker: spreads a wave across near-equal
    endpoints instead of herding it onto the argmax. The reference draws
    the noise from the wave's key inside the cycle; here it comes in as
    `gumbel`, the same standard draws the sinkhorn picker takes, scaled by
    `temperature`."""
    neg = torch.full((), NEG, dtype=torch.float32, device=scores.device)
    masked = torch.where(mask, scores + gumbel * float(temperature), neg)
    return _finalize(masked, mask, shed, valid)
