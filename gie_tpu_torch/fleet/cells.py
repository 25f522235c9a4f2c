"""Bounded per-cell rows: the coarse stage's view of the fleet (port of
gie_tpu/fleet/cells.py).

A CELL is a fixed, contiguous run of ``cell_cap`` endpoint slots: cell c
owns global slots [c*cell_cap, (c+1)*cell_cap). Per-cell rows fold the
dense endpoint tensors into O(cells) aggregates (mean queue depth, mean KV
utilization, mean assumed load, live-slot count, a LoRA-residency bloom)
that the coarse stage scores like virtual endpoints.

Sums follow the Sinkhorn solve's grouped-partial discipline (fixed group
partials, then an ordered left-to-right fold). torch has no bitwise-OR
reduction: an OR of u32 words (int64 carriers, sched/types.py) goes
through its 32 bit planes here (`_or_fold`), and where only "some bit is
set" matters the fold is an `any` over the words.
"""

from __future__ import annotations

import dataclasses

import torch

from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.sinkhorn import _fold_last, _group_count
from gie_tpu_torch.sched.types import EndpointBatch, PrefixTable, RequestBatch


@dataclasses.dataclass(frozen=True)
class CellRows:
    """One bounded row per cell: everything the coarse stage scores. Raw
    aggregates, normalized in coarse.py with the dense chain's formulas."""

    queue: torch.Tensor    # f32[cells] mean queue depth over valid slots
    kv: torch.Tensor       # f32[cells] mean KV-cache utilization
    load: torch.Tensor     # f32[cells] mean assumed load
    n_valid: torch.Tensor  # f32[cells] live slot count (integer-valued)
    lora: torch.Tensor     # int64[cells] u32 bloom: bit (id % 32) per adapter
    valid: torch.Tensor    # bool[cells] cell has at least one live slot


def _cell_fold(x: torch.Tensor, cell_cap: int) -> torch.Tensor:
    """Grouped-partial per-cell sum: f32[cells*cap] -> f32[cells]: fixed
    contiguous group partials over the cap axis, then an ordered fold."""
    cells = int(x.shape[0]) // cell_cap
    g = _group_count(cell_cap)
    return _fold_last(x.reshape(cells, g, cell_cap // g).sum(dim=2))


def _or_fold(x: torch.Tensor, cell_cap: int) -> torch.Tensor:
    """Bitwise-OR per-cell fold: u32[cells*cap] -> u32[cells] (int64
    carriers). Each of the 32 bit planes is an `any` over the cell's
    slots; the planes' distinct bits sum back into the exact word."""
    cells = int(x.shape[0]) // cell_cap
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    planes = ((x.reshape(cells, cell_cap, 1) >> shifts) & 1).amax(dim=1)
    return (planes << shifts).sum(dim=1)


def lora_residency_bits(eps: EndpointBatch) -> torch.Tensor:
    """Per-slot adapter bloom -> u32[m] (int64 carriers): bit
    (adapter_id % 32) for every resident adapter of a valid slot. A bloom,
    not a map: false positives send a request to a cell that must page
    the adapter in, false negatives cannot happen."""
    ids = eps.lora_active.long()
    bits = torch.where(ids >= 0, torch.bitwise_left_shift(
        torch.ones_like(ids), ids % 32), torch.zeros_like(ids))
    # Each lane holds at most one bit, so the lanes' OR is the sum of their
    # distinct bits: a lane whose bit an earlier lane of the slot holds
    # (the same adapter twice, or two ids 32 apart) is left out.
    lanes = ids.shape[1]
    earlier = torch.ones((lanes, lanes), dtype=torch.bool,
                         device=ids.device).tril(-1)
    repeat = ((bits[:, :, None] == bits[:, None, :]) & earlier).any(dim=2)
    slot_bits = torch.where(repeat, torch.zeros_like(bits), bits).sum(dim=1)
    return torch.where(eps.valid, slot_bits, torch.zeros_like(slot_bits))


def build_cell_rows(
    eps: EndpointBatch,
    assumed_load: torch.Tensor,
    *,
    cell_cap: int,
) -> CellRows:
    """Fold the dense endpoint tensors into per-cell rows. Means are over
    VALID slots only (a half-empty cell of idle pods must not look twice
    as loaded as a full one); cells with no live slot are invalid."""
    valid_f = eps.valid.to(torch.float32)
    n_valid = _cell_fold(valid_f, cell_cap)
    denom = torch.clamp(n_valid, min=1.0)

    def mean(col: torch.Tensor) -> torch.Tensor:
        return _cell_fold(torch.where(eps.valid, col, torch.zeros_like(col)),
                          cell_cap) / denom

    return CellRows(
        queue=mean(eps.metrics[:, C.Metric.QUEUE_DEPTH]),
        kv=mean(eps.metrics[:, C.Metric.KV_CACHE_UTIL]),
        load=mean(assumed_load),
        n_valid=n_valid,
        lora=_or_fold(lora_residency_bits(eps), cell_cap),
        valid=n_valid > 0,
    )


def cell_match_from_table(
    table: PrefixTable,
    reqs: RequestBatch,
    tick: torch.Tensor,
    *,
    cell_cap: int,
    max_age: int,
) -> torch.Tensor:
    """Cell-granular longest-prefix match fraction -> f32[N, cells], from a
    PER-ENDPOINT packed table (exact mode). The prefix.match_scores gather
    and cumulative AND, with each chunk's presence words collapsed to one
    flag per cell ("some endpoint of this cell holds the chunk") before
    the depth count."""
    wpc = cell_cap // 32
    nslots = int(table.keys.shape[0])
    slots = reqs.chunk_hashes & (nslots - 1)
    keys = table.keys[slots]                                    # [N, C]
    cmax = reqs.chunk_hashes.shape[1]
    dev = slots.device
    chunk_valid = (torch.arange(cmax, dtype=torch.int32, device=dev)[None, :]
                   < reqs.n_chunks[:, None])
    fresh = ((tick - table.ages[slots]) & C.U32_MASK) <= max_age
    hit = ((keys == reqs.chunk_hashes) & (reqs.chunk_hashes != 0)
           & chunk_valid & fresh)
    words = table.present[slots] * hit[..., None]               # [N, C, W]
    n, _, w = words.shape
    cells = w // wpc
    # One [N, cells] slice per chunk lane, never the unpacked bit tensor;
    # an OR of the cell's words is non-zero exactly when one of them is.
    cell_words = words.reshape(n, cmax, cells, wpc)
    acc = torch.ones((n, cells), dtype=torch.bool, device=dev)
    depth = torch.zeros((n, cells), dtype=torch.float32, device=dev)
    for ci in range(cmax):
        acc = acc & (cell_words[:, ci] != 0).any(dim=2)
        depth = depth + acc.to(torch.float32)
    denom = torch.clamp(reqs.n_chunks.to(torch.float32), min=1.0)
    return depth / denom[:, None]
