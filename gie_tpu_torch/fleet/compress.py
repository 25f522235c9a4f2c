"""Candidate compression: gather selected cells into a dense block (port
of gie_tpu/fleet/compress.py).

Every helper gathers in the caller's ascending cell order and pads the
block up to an M bucket with dead slots (valid=False, subset bit off,
presence words zero), so one captured compressed cycle serves every
selection and the pad can never be picked. On the scatter-back side a
padded position (global slot -1) writes to a scratch slot past the end,
which is dropped: it touches nothing of the fleet-width state, as the
reference's out-of-bounds "drop" scatter.

Duplicate indices: the selection holds distinct cells, so the global slots
of a block are distinct and every scatter here writes each live target
once; only the padded positions share the scratch slot, whose value is
thrown away.

When the selection is arange(cells) (top-K covers every cell) every gather
returns its input unchanged and the compressed cycle's inputs equal the
dense cycle's.

u32 presence words ride as int64 masked to 32 bits (sched/types.py); an
OR of words is taken where only "some bit set" matters (an `any`), and
the cell bits of a sketch word are distinct, so their OR is their sum.
"""

from __future__ import annotations

import torch

from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.types import EndpointBatch


def global_slots(sel: torch.Tensor, *, cell_cap: int, m_c: int) -> torch.Tensor:
    """Compressed slot j -> global endpoint slot, i32[m_c]. Padded tail
    positions (j >= k*cell_cap) hold -1."""
    k = int(sel.shape[0])
    lanes = (sel.long()[:, None] * cell_cap + torch.arange(
        cell_cap, dtype=torch.int64, device=sel.device)[None, :]).reshape(-1)
    pad = m_c - k * cell_cap
    if pad:
        lanes = torch.cat([lanes, torch.full(
            (pad,), -1, dtype=torch.int64, device=sel.device)])
    return lanes.to(torch.int32)


def _pad_rows(x: torch.Tensor, pad: int, fill) -> torch.Tensor:
    if not pad:
        return x
    tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail])


def gather_endpoints(eps: EndpointBatch, sel: torch.Tensor, *, cell_cap: int,
                     m_c: int) -> EndpointBatch:
    """Selected cells' endpoint rows -> EndpointBatch at width m_c."""
    k = int(sel.shape[0])
    pad = m_c - k * cell_cap
    idx = sel.long()

    def rows(x: torch.Tensor, fill) -> torch.Tensor:
        cells = int(x.shape[0]) // cell_cap
        per_cell = x.reshape((cells, cell_cap) + tuple(x.shape[1:]))
        picked = per_cell.index_select(0, idx)
        return _pad_rows(picked.reshape((k * cell_cap,) + tuple(x.shape[1:])),
                         pad, fill)

    return EndpointBatch(
        metrics=rows(eps.metrics, 0.0),
        valid=rows(eps.valid, False),
        lora_active=rows(eps.lora_active, -1),
        lora_waiting=rows(eps.lora_waiting, -1),
        role=rows(eps.role, 0),
    )


def gather_request_cols(x: torch.Tensor, gslots: torch.Tensor) -> torch.Tensor:
    """[N, fleet_m] request-by-endpoint matrix -> [N, m_c] compressed
    columns; padded positions (gslots == -1) read the dtype's zero (False
    for the subset mask), never a clamped neighbour's value."""
    vals = x.index_select(1, torch.clamp(gslots, min=0).long())
    return torch.where(gslots[None, :] >= 0, vals, torch.zeros_like(vals))


def gather_vec(x: torch.Tensor, gslots: torch.Tensor, fill: float) -> torch.Tensor:
    """Fleet-width per-endpoint vector -> compressed vector; padded
    positions take `fill` (0 load, 1.0 cold Sinkhorn duals)."""
    vals = x.index_select(0, torch.clamp(gslots, min=0).long())
    return torch.where(gslots >= 0, vals, torch.full_like(vals, fill))


def scatter_vec(full: torch.Tensor, gslots: torch.Tensor,
                compressed: torch.Tensor) -> torch.Tensor:
    """Compressed per-endpoint values written back at fleet width -> a new
    vector; padded positions write to a scratch slot past the end, which
    is dropped."""
    m = int(full.shape[0])
    out = torch.cat([full, full.new_zeros((1,))])
    target = torch.where(gslots >= 0, gslots,
                         torch.full_like(gslots, m)).long()
    out.index_put_((target,), compressed)
    return out[:m]


def gather_words(present: torch.Tensor, sel: torch.Tensor, *, cell_cap: int,
                 m_c: int) -> torch.Tensor:
    """Exact mode: per-endpoint packed presence u32[S, fleet_m/32] ->
    compressed u32[S, m_c/32]. cell_cap is a multiple of 32, so a cell's
    presence is whole words and the gather is exact."""
    wpc = cell_cap // 32
    k = int(sel.shape[0])
    s = int(present.shape[0])
    cells = int(present.shape[1]) // wpc
    per_cell = present.reshape(s, cells, wpc)
    out = per_cell.index_select(1, sel.long()).reshape(s, k * wpc)
    pad = m_c // 32 - k * wpc
    if pad:
        out = torch.cat([out, out.new_zeros((s, pad))], dim=1)
    return out


def scatter_words(
    present: torch.Tensor,
    sel: torch.Tensor,
    compressed: torch.Tensor,
    new_keys_differ: torch.Tensor,  # bool[S] rows the compressed insert recycled
    *,
    cell_cap: int,
) -> torch.Tensor:
    """Inverse of gather_words -> a new table. Rows whose KEY the
    compressed insert recycled are cleared across ALL fleet words first:
    the insert's row clear reached only the gathered columns, and a
    recycled row must not keep the evicted key's bits for cells that were
    not selected this wave."""
    wpc = cell_cap // 32
    k = int(sel.shape[0])
    s = int(present.shape[0])
    cleared = torch.where(new_keys_differ[:, None], torch.zeros_like(present),
                          present)
    cells = int(present.shape[1]) // wpc
    per_cell = cleared.reshape(s, cells, wpc)
    new_cols = compressed[:, : k * wpc].reshape(s, k, wpc)
    return per_cell.index_copy(1, sel.long(), new_cols).reshape(present.shape)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[S, 32*w] -> u32[S, w] words, bit j of word i = column 32*i + j
    (distinct bits, so the OR is the sum)."""
    s = int(bits.shape[0])
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (bits.reshape(s, -1, 32).to(torch.int64) << shifts).sum(dim=2)


def compact_presence(present: torch.Tensor, *, cell_cap: int,
                     out_cells: int | None = None) -> torch.Tensor:
    """Seed the fleet-level sketch from the packed per-endpoint table:
    u32[S, m/32] -> u32[S, out_cells/32], bit c = "some endpoint of cell c
    holds this chunk". `out_cells` >= the source cell count pads the
    sketch out to a grown fleet's cell axis (and word-aligns it)."""
    wpc = cell_cap // 32
    s = int(present.shape[0])
    cells = int(present.shape[1]) // wpc
    if out_cells is None:
        out_cells = cells
    if out_cells < cells or out_cells % 32:
        raise ValueError(
            f"out_cells {out_cells} must be a multiple of 32 covering the "
            f"{cells} source cells")
    bits = (present.reshape(s, cells, wpc) != 0).any(dim=2)   # [S, cells]
    if out_cells > cells:
        bits = torch.cat([bits, bits.new_zeros((s, out_cells - cells))], dim=1)
    return _pack_bits(bits)


def broadcast_presence(
    cell_present: torch.Tensor,  # u32[S, cells/32] cell-bit sketch table
    sel: torch.Tensor,
    *,
    cell_cap: int,
    m_c: int,
) -> torch.Tensor:
    """Sketch mode: expand selected cells' sketch bits to compressed
    per-endpoint words u32[S, m_c/32]: every slot of a sketch-hit cell
    reads as present (cluster-grain affinity)."""
    wpc = cell_cap // 32
    k = int(sel.shape[0])
    s = int(cell_present.shape[0])
    idx = sel.long()
    word = idx // 32
    bit = torch.bitwise_left_shift(torch.ones_like(idx), idx % 32)
    hit = (cell_present.index_select(1, word) & bit[None, :]) != 0  # [S, k]
    full = torch.full(hit.shape, C.U32_MASK, dtype=torch.int64,
                      device=hit.device)
    words = torch.where(hit, full, torch.zeros_like(full))
    out = words[:, :, None].expand(s, k, wpc).reshape(s, k * wpc)
    pad = m_c // 32 - k * wpc
    if pad:
        out = torch.cat([out, out.new_zeros((s, pad))], dim=1)
    return out
