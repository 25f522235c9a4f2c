"""Prefix-cache index: batched match, insert and KV-event ingest (port of
gie_tpu/sched/prefix.py).

The table is a direct-mapped array of PREFIX_SLOTS rows, each a u32 key, a
BITPACKED per-endpoint presence row (bit m of word m//32) and a u32 age
tick; all u32 columns are int64 tensors masked to 32 bits, so the packed
words stay bit-identical to the reference's:

  slot(h)     = h & (S - 1)                        direct-mapped
  hit(n,c)    = keys[slot(h_nc)] == h_nc           chunk known at all
  run(n,c,w)  = AND_{c'<=c} present[slot, w] * hit longest-prefix property
  match(n,m)  = sum_c bit_m(run(n,c))              bit-sliced counters
  score       = match / n_chunks

Duplicate scatter targets. Within one wave, lanes that insert into the
same (row, word) cell resolve LAST-LANE-WINS in the reference (JAX's CPU
scatter applies updates in lane order). torch's `index_put_` gives no such
order on the CPU and none at all on CUDA, so `insert` makes the rule
explicit: per target, `scatter_reduce(amax)` of the flat lane id picks the
winning lane, and only winners write. This reproduces the reference table
exactly and is deterministic on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.types import PrefixTable, RequestBatch


def _slots(hashes: torch.Tensor, table_slots: int) -> torch.Tensor:
    return hashes & (table_slots - 1)


def match_scores(
    table: PrefixTable,
    reqs: RequestBatch,
    tick: torch.Tensor,
    *,
    max_age: int,
) -> torch.Tensor:
    """Longest-prefix match fraction per (request, endpoint) -> f32[N, m]."""
    slots = _slots(reqs.chunk_hashes, table.keys.shape[0])     # [N, C]
    keys = table.keys[slots]                                   # [N, C]
    cmax = reqs.chunk_hashes.shape[1]
    dev = slots.device
    chunk_valid = (torch.arange(cmax, dtype=torch.int32, device=dev)[None, :]
                   < reqs.n_chunks[:, None])
    fresh = ((tick - table.ages[slots]) & C.U32_MASK) <= max_age
    hit = ((keys == reqs.chunk_hashes) & (reqs.chunk_hashes != 0)
           & chunk_valid & fresh)

    words = table.present[slots] * hit[..., None]              # [N, C, W]

    # One sequential sweep over the chunk axis: `acc` is the running
    # cumulative AND of the packed words, `planes[k]` holds bit k of every
    # endpoint's running depth (a ripple-carry add of `acc` on whole words).
    n_planes = max(cmax.bit_length(), 1)
    acc = torch.full_like(words[:, 0, :], C.U32_MASK)
    planes = [torch.zeros_like(acc) for _ in range(n_planes)]
    for c in range(cmax):
        acc = acc & words[:, c, :]
        carry = acc
        for k in range(n_planes):
            planes[k], carry = planes[k] ^ carry, planes[k] & carry
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    matched = sum(
        ((p[..., None] >> shifts) & 1).to(torch.float32) * float(1 << k)
        for k, p in enumerate(planes)
    ).reshape(words.shape[0], -1)                              # [N, M]
    denom = torch.clamp(reqs.n_chunks.to(torch.float32), min=1.0)
    return matched / denom[:, None]


def _cell(ep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Endpoint slot -> (word column, bit value) in the packed row."""
    return ep // 32, torch.bitwise_left_shift(torch.ones_like(ep), ep % 32)


def _winners(target: torch.Tensor, valid: torch.Tensor,
             size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Last valid lane per target -> (int64[size] its lane id, -1 where no
    valid lane targets it; bool[L] lane l is that winner). Targets lie in
    [0, size)."""
    lane = torch.arange(target.shape[0], dtype=torch.int64,
                        device=target.device)
    lane_or_neg = torch.where(valid, lane, torch.full_like(lane, -1))
    winner = torch.full((size,), -1, dtype=torch.int64, device=target.device)
    winner.scatter_reduce_(0, target, lane_or_neg, "amax")
    return winner, valid & (winner[target] == lane)


def insert(
    table: PrefixTable,
    reqs: RequestBatch,
    picked: torch.Tensor,  # i32[N] primary endpoint slot per request (-1 = none)
    tick: torch.Tensor,    # int64 scalar (u32)
) -> PrefixTable:
    """Record the batch's chunks as cached on their picked endpoints, IN
    PLACE, and return the table.

    Per (request, chunk) lane: if the slot already holds this hash, OR the
    picked endpoint's bit into its presence row; otherwise evict (clear
    the row, write the new key) and set the bit. Evictions are decided
    against the table as it was before this call and applied first; each
    lane then ORs its bit into the cell as it stood after the evictions,
    and of several lanes on one cell the last lane's value stands.

    Every step is a fixed-shape scatter or select: no boolean indexing,
    whose nonzero() would make the host wait for the device mid-cycle.
    """
    n, cmax = reqs.chunk_hashes.shape
    nslots = table.keys.shape[0]
    w = table.present.shape[1]
    flat_hash = reqs.chunk_hashes.reshape(-1)                       # [N*C]
    flat_slot = _slots(flat_hash, nslots)
    dev = flat_hash.device
    chunk_valid = (torch.arange(cmax, dtype=torch.int32, device=dev)[None, :]
                   < reqs.n_chunks[:, None])
    valid = (chunk_valid & (reqs.chunk_hashes != 0)
             & (picked[:, None] >= 0)).reshape(-1)

    ep = torch.clamp(picked.long(), 0, w * 32 - 1)
    ep = ep[:, None].expand(n, cmax).reshape(-1)                    # [N*C]
    word, bit = _cell(ep)
    evict = valid & (table.keys[flat_slot] != flat_hash)
    cell = flat_slot * w + word
    # Evictions and winning lanes are decided on the table as it was
    # before this call, as in the reference.
    row_winner, _ = _winners(flat_slot, valid, nslots)
    evicted, _ = _winners(flat_slot, evict, nslots)
    _, cell_winner = _winners(cell, valid, nslots * w)

    # 1) Evictions: clear the packed presence row of every row some lane
    #    evicts.
    table.present.masked_fill_((evicted >= 0)[:, None], 0)
    # 2) OR the winning lane's bit into its (row, word) cell, reading the
    #    cell as the evictions left it. Words are >= 0, so an amax with
    #    0 from every other lane leaves the winner's value.
    flat_present = table.present.view(-1)
    won = torch.where(cell_winner, flat_present[cell] | bit,
                      torch.zeros_like(bit))
    flat_present.scatter_reduce_(0, cell, won, "amax")
    # 3) Keys and ages of every touched row, from its winning lane.
    touched = row_winner >= 0
    lane = torch.clamp(row_winner, min=0)
    table.keys.copy_(torch.where(touched, flat_hash[lane], table.keys))
    table.ages.copy_(torch.where(touched, tick, table.ages))
    return table


def ingest_keys(
    table: PrefixTable,
    hashes: torch.Tensor,  # int64[B] u32 chunk hashes, 0 = padding
    ep_slot: int,          # the reporting endpoint's slot
    tick: torch.Tensor,    # int64 scalar (u32)
    *,
    remove: bool,
) -> PrefixTable:
    """Fold one endpoint's KV-cache event batch into the table, IN PLACE,
    and return it (the reference's ingest_keys).

    Stored: the same evict-then-OR as `insert`, for one endpoint: rows
    whose key differs from a lane's hash are cleared, every touched row
    takes the last lane's key and `tick`, and the endpoint's bit is ORed
    in. Removed: only this endpoint's bit is cleared, and only on rows
    whose key matches (other endpoints may still hold the chunk; a row
    holding another key was recycled)."""
    ep = torch.full_like(hashes, ep_slot)
    kind = torch.full(hashes.shape, remove, dtype=torch.bool,
                      device=hashes.device)
    return ingest_lanes(table, hashes, ep, kind, tick)


def ingest_lanes(
    table: PrefixTable,
    hashes: torch.Tensor,  # int64[L] u32 chunk hashes, 0 = padding
    ep: torch.Tensor,      # int64[L] the reporting endpoint of each lane
    remove: torch.Tensor,  # bool[L] removed (True) or stored (False)
    tick: torch.Tensor,    # int64 scalar (u32)
    scratch: "torch.Tensor | None" = None,
) -> PrefixTable:
    """ingest_keys for several event batches at once, IN PLACE: lane l
    carries one hash of endpoint ep[l]'s stored or removed batch. Lanes of
    two different batches must not share a table row; then every batch
    reads and writes only its own rows, and the fold equals the batches
    folded one after another.

    Every write is a scatter over the lanes' own rows, so a fold costs
    O(lanes), not O(table): each lane that writes a presence cell writes
    the same value (one endpoint and one kind per row), and the keys and
    ages take the row's last storing lane, found through `scratch`
    (int64[2, table rows], all -1; per-row winners are reduced into it and
    it is left all -1 again; allocated here when None). Words, keys and
    ages lie in [0, 2**32), so an amax with 0 and an amin with U32_MASK
    leave a target that no lane of that step names as it was."""
    nslots = table.keys.shape[0]
    w = table.present.shape[1]
    dev = hashes.device
    if scratch is None:
        scratch = torch.full((2, nslots), -1, dtype=torch.int64, device=dev)
    valid = hashes != 0
    slot = _slots(hashes, nslots)
    word, bit = _cell(ep)
    match = table.keys[slot] == hashes
    store = valid & ~remove
    drop = valid & remove & match
    # Per row, over its storing lanes: the last lane, and whether any lane
    # evicts (holds another hash than the row's key).
    lane = torch.arange(hashes.shape[0], dtype=torch.int64, device=dev)
    neg = torch.full_like(lane, -1)
    last, evicting = scratch[0], scratch[1]
    last.scatter_reduce_(0, slot, torch.where(store, lane, neg), "amax")
    evicting.scatter_reduce_(0, slot, torch.where(store & ~match, lane, neg),
                             "amax")
    winner, evicted = last[slot], evicting[slot] >= 0
    last.index_fill_(0, slot, -1)
    evicting.index_fill_(0, slot, -1)

    zero = torch.zeros_like(hashes)
    full = torch.full_like(hashes, C.U32_MASK)
    flat = table.present.view(-1)
    # 1) Evictions clear the row's every word.
    row_cells = (slot[:, None] * w
                 + torch.arange(w, dtype=torch.int64, device=dev)).reshape(-1)
    flat.scatter_reduce_(0, row_cells, torch.where(
        store & evicted, zero, full)[:, None].expand(-1, w).reshape(-1),
        "amin")
    # 2) Stored lanes OR their bit into the cell as the evictions left it;
    #    removed lanes that match clear theirs.
    cell = slot * w + word
    old = flat[cell]
    flat.scatter_reduce_(0, cell, torch.where(store, old | bit, zero), "amax")
    flat.scatter_reduce_(0, cell, torch.where(
        drop, old & (~bit & C.U32_MASK), full), "amin")
    # 3) Keys and ages of every stored row, from its last storing lane.
    won = hashes[torch.clamp(winner, min=0)]
    for col, value in ((table.keys, won), (table.ages, tick.expand_as(won))):
        col.scatter_reduce_(0, slot, torch.where(store, zero, full), "amin")
        col.scatter_reduce_(0, slot, torch.where(store, value, zero), "amax")
    return table


def snapshot_table(table: PrefixTable) -> dict:
    """Host uint32 arrays of the packed table, laid out exactly as the
    reference's snapshot_table returns them."""
    return {
        "keys": table.keys.cpu().numpy().astype(np.uint32),
        "present": table.present.cpu().numpy().astype(np.uint32),
        "ages": table.ages.cpu().numpy().astype(np.uint32),
    }


def table_from_arrays(arrays: dict, *, device) -> "PrefixTable | None":
    """Validated inverse of snapshot_table, or None when the arrays are not
    a coherent packed table (wrong rank, mismatched row counts, or a
    presence width that is not whole 32-endpoint words)."""
    try:
        keys = np.asarray(arrays["keys"], np.uint32)
        present = np.asarray(arrays["present"], np.uint32)
        ages = np.asarray(arrays["ages"], np.uint32)
    except (KeyError, TypeError, ValueError):
        return None
    if keys.ndim != 1 or present.ndim != 2 or ages.shape != keys.shape:
        return None
    if present.shape[0] != keys.shape[0] or present.shape[1] < 1:
        return None
    return PrefixTable(
        keys=torch.from_numpy(keys.astype(np.int64)).to(device),
        present=torch.from_numpy(present.astype(np.int64)).to(device),
        ages=torch.from_numpy(ages.astype(np.int64)).to(device),
    )


def clear_endpoint(table: PrefixTable, slot: int) -> PrefixTable:
    """Clear one endpoint's presence bit across the table, in place."""
    word, bit = slot // 32, 1 << (slot % 32)
    table.present[:, word] &= (~bit) & C.U32_MASK
    return table
