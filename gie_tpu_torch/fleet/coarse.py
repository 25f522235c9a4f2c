"""Coarse stage: score request batches against cells, emit candidates
(port of gie_tpu/fleet/coarse.py).

The cell blend reuses the dense chain's normalization formulas over the
per-cell aggregates and the dense Weights fields: a cell row scores like a
virtual endpoint carrying its members' mean metrics. The session column
has no cell-level analogue and is left out of the coarse blend.

Selection is two-phase: per request, the top-K cells by coarse score
(flight-record provenance); per batch, the K highest cells of the
request-max score, gathered in ascending cell-id order. The ascending
order is the parity keystone: with k >= cells the selection is every
cell id whatever the scores were, so the compressed dense stage sees the
dense cycle's inputs unchanged.

Ties. Every ineligible cell scores -1e9, and so does every padded row's
advocacy, so ties are common, and the reference breaks them toward the
lower cell id (jax.lax.top_k lists the first occurrence first).
torch.topk promises no order among ties, so both selections here take the
first k columns of a STABLE descending sort, which keeps tied cells in
index order.
"""

from __future__ import annotations

import numpy as np
import torch

from gie_tpu_torch.fleet.cells import CellRows
from gie_tpu_torch.sched.types import EndpointBatch, RequestBatch

# The Weights fields the coarse blend reads, in the order it sums them.
COARSE_WEIGHTS = ("queue", "kv_cache", "assumed_load", "prefix", "lora")

_NEG = -1e9


def coarse_total(
    rows: CellRows,
    prefix_col: torch.Tensor,   # f32[N, cells] cell-granular match fraction
    reqs: RequestBatch,
    weights,
    *,
    queue_norm: float,
    load_norm: float,
) -> torch.Tensor:
    """Blended coarse score -> f32[N, cells] (higher = better cell).
    `weights` carries the COARSE_WEIGHTS fields as floats (a Weights) or as
    0-d float32 tensors (a captured cycle's static weight buffer); their
    sum is taken in float32, in the reference's order."""
    w = {k: getattr(weights, k) for k in COARSE_WEIGHTS}
    queue = torch.clamp(1.0 - rows.queue / queue_norm, 0.0, 1.0)
    kv = torch.clamp(1.0 - rows.kv, 0.0, 1.0)
    load = torch.clamp(1.0 - rows.load / load_norm, 0.0, 1.0)
    # Residency bloom probe: base-model requests are indifferent (1.0);
    # adapter requests prefer cells already holding bit (id % 32).
    lora_id = reqs.lora_id.long()
    bit = torch.bitwise_left_shift(torch.ones_like(lora_id),
                                   torch.clamp(lora_id, min=0) % 32)
    resident = ((rows.lora[None, :] & bit[:, None]) != 0).to(torch.float32)
    lora = torch.where(lora_id[:, None] >= 0, resident,
                       torch.ones_like(resident))

    cellwise = (w["queue"] * queue + w["kv_cache"] * kv
                + w["assumed_load"] * load)[None, :]
    requestwise = w["prefix"] * prefix_col + w["lora"] * lora
    if torch.is_tensor(w["queue"]):
        wsum = w["queue"]
        for k in COARSE_WEIGHTS[1:]:
            wsum = wsum + w[k]
    else:
        acc = np.float32(0.0)
        for k in COARSE_WEIGHTS:
            acc = np.float32(acc + np.float32(w[k]))
        wsum = torch.full((), float(acc), dtype=torch.float32,
                          device=queue.device)
    # A 0-d tensor on the device either way: a true division, as the
    # reference's (a host scalar divisor may become a reciprocal multiply).
    wsum = torch.clamp(wsum, min=1e-6)
    return (cellwise + requestwise) / wsum


def _first_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row of `x`, best first, the lower
    index first among equals -> (values, indices int64)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_cells(
    coarse: torch.Tensor,       # f32[N, cells]
    rows: CellRows,
    reqs: RequestBatch,
    eps: EndpointBatch,
    *,
    cell_cap: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (sel i32[k] ascending, cand_cells i32[N, k], cand_scores
    f32[N, k]).

    Eligibility folds the request's candidate-subset hint and slot
    liveness to cell granularity. Ineligible and dead cells score -1e9;
    with k >= cells they are still selected (their slots stay masked in
    the dense stage), which keeps the covering selection
    score-independent."""
    n, cells = int(coarse.shape[0]), int(coarse.shape[1])
    elig = (reqs.subset_mask.reshape(n, cells, cell_cap)
            & eps.valid.reshape(cells, cell_cap)[None, :, :]).any(dim=2)
    neg = torch.full_like(coarse, _NEG)
    scored = torch.where(elig & rows.valid[None, :], coarse, neg)

    # Per-request candidates: provenance and the recall property's subject.
    cand_scores, cand_cells = _first_k(scored, k)

    # Batch selection: request-max advocacy (padded rows advocate for
    # nothing), ties toward the lower cell id.
    advocacy = torch.where(reqs.valid[:, None], scored, neg).amax(dim=0)
    _, sel = _first_k(advocacy, k)
    # Canonical ascending gather order: k == cells makes this
    # arange(cells) whatever was scored.
    sel = torch.sort(sel).values
    return (sel.to(torch.int32), cand_cells.to(torch.int32), cand_scores)
