"""FleetPicker: the hierarchical two-level pick cycle, as a Scheduler
(port of gie_tpu/fleet/picker.py).

`fleet_cycle` has the shape of profile.scheduling_cycle (state, reqs, eps,
weights, gumbel) -> (result, state), updating the state in place, so
FleetPicker subclasses the Scheduler facade and swaps the cycle: locking,
warming, the captured graph per wave shape, completion feedback, the KV
event queue, checkpoints and the replication digest are inherited, and
the batching collector cannot tell the difference.

Two resolution modes, chosen by the carried state's presence width:

  exact  - fleet_m is a dense M bucket: the state is a dense SchedState,
           the coarse stage derives cell rows and cell sketches from it on
           the fly, and the compressed stage gathers the true per-endpoint
           presence words. The parity mode: a top-K covering every cell
           makes every gather the identity and the picks bit-equal to the
           dense cycle.
  sketch - fleet_m exceeds the largest M bucket: the prefix table is at
           CELL grain (a PrefixTable whose packed axis is the cells),
           affinity inside a selected cell is the cell's bit, and inserts
           and KV events land at cell grain.

The dense stage runs the port's unchanged scheduling_cycle over one M
bucket m_c = m_bucket_for(K * cell_cap), so its kernels (the fused
Sinkhorn solve, the fused blend + top-k) run at [N, m_c], and its Gumbel
noise is drawn at (N, m_c), where the reference draws it.
"""

from __future__ import annotations

import collections
import threading
import types
from typing import Optional

import numpy as np
import torch

from gie_tpu_torch.fleet.cells import build_cell_rows, cell_match_from_table
from gie_tpu_torch.fleet.coarse import COARSE_WEIGHTS, coarse_total, select_cells
from gie_tpu_torch.fleet.compress import (
    broadcast_presence,
    compact_presence,
    gather_endpoints,
    gather_request_cols,
    gather_vec,
    gather_words,
    global_slots,
    scatter_vec,
    scatter_words,
)
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched import prefix
from gie_tpu_torch.sched.profile import (
    ProfileConfig,
    Scheduler,
    check_state_shapes,
    scheduling_cycle,
)
from gie_tpu_torch.sched.types import (
    FleetAux,
    PickResult,
    PrefixTable,
    SchedState,
    Weights,
    m_bucket_for,
    resize_into,
)

__all__ = ["FleetAux", "FleetPicker", "coarse_stage", "fleet_cycle",
           "fleet_resize_into", "fleet_resize_state"]


def _is_sketch(state: SchedState) -> bool:
    """Presence width tells the mode: a dense table packs fleet_m bits a
    row, the sketch table one bit per CELL."""
    return int(state.prefix.present.shape[1]) * 32 != state.m


def compressed_width(m: int, *, cell_cap: int, topk: int) -> int:
    """The dense stage's width at fleet width m: one M bucket."""
    return m_bucket_for(min(topk, m // cell_cap) * cell_cap)


def fleet_state(m: int, *, cell_cap: int, device) -> SchedState:
    """A fresh fleet state of width m: dense up to the largest M bucket,
    with a cell-grain (sketch) prefix table past it."""
    if m <= C.M_BUCKETS[-1]:
        return SchedState.init(m=m, device=device)
    return SchedState(
        prefix=PrefixTable.empty(C.PREFIX_SLOTS, m // cell_cap,
                                 device=device),
        assumed_load=torch.zeros((m,), dtype=torch.float32, device=device),
        rr=torch.zeros((), dtype=torch.int64, device=device),
        tick=torch.zeros((), dtype=torch.int64, device=device),
        ot_v=torch.ones((m,), dtype=torch.float32, device=device),
    )


def coarse_stage(state: SchedState, reqs, eps, weights, *,
                 cfg: ProfileConfig, cell_cap: int, k: int):
    """The coarse stage: bounded cell rows scored against the requests ->
    (sel i32[k] ascending, cand_cells i32[N, k], cand_scores f32[N, k]).
    Reads `state`, writes nothing."""
    cells = int(eps.valid.shape[0]) // cell_cap
    rows = build_cell_rows(eps, state.assumed_load, cell_cap=cell_cap)
    if not cfg.enable_prefix:
        pref_cells = torch.zeros((reqs.valid.shape[0], cells),
                                 dtype=torch.float32, device=eps.valid.device)
    elif _is_sketch(state):
        # The sketch table's packed axis IS the cell axis: the dense
        # matcher runs on it unchanged.
        pref_cells = prefix.match_scores(state.prefix, reqs, state.tick,
                                         max_age=cfg.prefix_max_age)
    else:
        pref_cells = cell_match_from_table(
            state.prefix, reqs, state.tick, cell_cap=cell_cap,
            max_age=cfg.prefix_max_age)
    coarse = coarse_total(rows, pref_cells, reqs, weights,
                          queue_norm=cfg.queue_norm, load_norm=cfg.load_norm)
    return select_cells(coarse, rows, reqs, eps, cell_cap=cell_cap, k=k)


def fleet_cycle(
    state: SchedState,
    reqs,
    eps,
    weights: Weights,
    gumbel: Optional[torch.Tensor],
    *,
    cfg: ProfileConfig,
    cell_cap: int,
    topk: int,
    wvec: Optional[torch.Tensor] = None,
    coarse_weights=None,
    predictor_fn=None,
    predictor_params=None,
) -> tuple[PickResult, SchedState]:
    """One hierarchical pick cycle over `state`, updated IN PLACE.

    `gumbel` is the dense stage's noise at (N, m_c) ([2, N, m_c] for a
    dual pick); `wvec` the dense blend's weights as the cycle's static
    buffer and `coarse_weights` the COARSE_WEIGHTS fields as 0-d tensors
    of it, in a captured cycle; both default to `weights`. A latency
    column (`predictor_fn`, `predictor_params`) is the dense stage's, over
    the compressed block with its own lane ids as slot ids, as the
    reference computes it. The cycle makes
    no call that waits for the device, so it can be captured."""
    fleet_m = int(eps.valid.shape[0])
    k_sel = min(topk, fleet_m // cell_cap)
    m_c = m_bucket_for(k_sel * cell_cap)
    sketch = _is_sketch(state)
    px = state.prefix
    # ---- Coarse stage: bounded cell rows -> top-K candidates ----------
    sel, cand_cells, cand_scores = coarse_stage(
        state, reqs, eps, weights if coarse_weights is None
        else coarse_weights, cfg=cfg, cell_cap=cell_cap, k=k_sel)

    # ---- Compression: ascending-cell gather into one M bucket ---------
    gslots = global_slots(sel, cell_cap=cell_cap, m_c=m_c)
    eps_c = gather_endpoints(eps, sel, cell_cap=cell_cap, m_c=m_c)
    reqs_c = reqs.replace(
        subset_mask=gather_request_cols(reqs.subset_mask, gslots))
    present_c = (
        broadcast_presence(px.present, sel, cell_cap=cell_cap, m_c=m_c)
        if sketch else
        gather_words(px.present, sel, cell_cap=cell_cap, m_c=m_c))
    # The dense stage updates its state in place, so it gets copies: the
    # fleet-width state is written only by the scatter-back below (in
    # sketch mode the compressed table's insert is a throwaway, and the
    # cell-grain insert reads the wave's tick before the dense stage's
    # increment).
    state_c = SchedState(
        prefix=PrefixTable(keys=px.keys.clone(), present=present_c,
                           ages=px.ages.clone()),
        assumed_load=gather_vec(state.assumed_load, gslots, 0.0),
        rr=state.rr.clone(),
        tick=state.tick.clone(),
        ot_v=gather_vec(state.ot_v, gslots, 1.0),
    )

    # ---- Dense stage: the UNCHANGED cycle over the block --------------
    res_c, new_c = scheduling_cycle(state_c, reqs_c, eps_c, weights, gumbel,
                                    cfg=cfg, wvec=wvec,
                                    predictor_fn=predictor_fn,
                                    predictor_params=predictor_params)

    # ---- Scatter back + remap to global slots -------------------------
    gslots_l = gslots.long()

    def remap(idx: torch.Tensor) -> torch.Tensor:
        g = gslots_l[torch.clamp(idx, min=0).long()].to(idx.dtype)
        return torch.where(idx >= 0, g, idx)

    indices_g = remap(res_c.indices)
    state.assumed_load.copy_(scatter_vec(
        state.assumed_load * cfg.load_decay, gslots, new_c.assumed_load))
    state.ot_v.copy_(scatter_vec(state.ot_v, gslots, new_c.ot_v))
    if cfg.enable_prefix:
        if sketch:
            # Cell-grain insert into the sketch table, at the wave's tick.
            primary = indices_g[:, 0]
            primary_cell = torch.where(primary >= 0, primary // cell_cap,
                                       torch.full_like(primary, -1))
            prefix.insert(px, reqs, primary_cell, state.tick)
        else:
            differ = new_c.prefix.keys != px.keys
            px.present.copy_(scatter_words(
                px.present, sel, new_c.prefix.present, differ,
                cell_cap=cell_cap))
            px.keys.copy_(new_c.prefix.keys)
            px.ages.copy_(new_c.prefix.ages)
    state.rr.copy_(new_c.rr)
    state.tick.copy_(new_c.tick)
    result = PickResult(
        indices=indices_g,
        status=res_c.status,
        scores=res_c.scores,
        prefill=(remap(res_c.prefill)
                 if res_c.prefill is not None else None),
        affinity=res_c.affinity,
        fleet_cells=cand_cells,
        fleet_scores=cand_scores,
    )
    return result, state


def fleet_resize_into(src: SchedState, dst: SchedState, *,
                      cell_cap: int) -> SchedState:
    """resize_into across the exact<->sketch boundary: carry `src` into
    `dst`'s own tensors (a captured cycle holds their addresses) -> dst.

    Within exact mode it is the dense migration; sketch to sketch pads or
    cuts the cell words; crossing UP seeds the sketch from the packed
    dense table (compact_presence: surviving endpoints keep cell-grain
    affinity); crossing DOWN broadcasts cell bits to endpoint words (every
    member of a warm cell starts warm, the safe direction for an
    approximate index)."""
    sketch_src, sketch_dst = _is_sketch(src), _is_sketch(dst)
    if not sketch_src and not sketch_dst:
        return resize_into(src, dst)
    k = min(src.m, dst.m)
    dst.assumed_load[:k].copy_(src.assumed_load[:k])
    dst.assumed_load[k:].zero_()
    dst.ot_v[:k].copy_(src.ot_v[:k])
    dst.ot_v[k:].fill_(1.0)
    present = dst.prefix.present
    cells_new = dst.m // cell_cap
    if sketch_dst and sketch_src:
        w = min(int(src.prefix.present.shape[1]), int(present.shape[1]))
        present[:, :w].copy_(src.prefix.present[:, :w])
        present[:, w:].zero_()
    elif sketch_dst:
        words = src.prefix.present
        short = -int(words.shape[1]) % (cell_cap // 32)
        if short:
            # A dense table narrower than whole cells (the first bucket
            # under a wide cell: 64 slots, cell_cap 256) pads with empty
            # words first; the reference's compact_presence refuses it.
            words = torch.cat([words, words.new_zeros(
                (int(words.shape[0]), short))], dim=1)
        present.copy_(compact_presence(words, cell_cap=cell_cap,
                                       out_cells=cells_new))
    else:
        present.copy_(broadcast_presence(
            src.prefix.present,
            torch.arange(cells_new, dtype=torch.int32, device=present.device),
            cell_cap=cell_cap, m_c=dst.m))
    dst.prefix.keys.copy_(src.prefix.keys)
    dst.prefix.ages.copy_(src.prefix.ages)
    dst.rr.copy_(src.rr)
    dst.tick.copy_(src.tick)
    return dst


def fleet_resize_state(state: SchedState, *, m: int,
                       cell_cap: int) -> SchedState:
    """The reference's fleet_resize_state: `state` carried to width m, as
    a new state (or `state` itself at its own width)."""
    if m == state.m:
        return state
    dst = fleet_state(m, cell_cap=cell_cap, device=state.assumed_load.device)
    return fleet_resize_into(state, dst, cell_cap=cell_cap)


class FleetPicker(Scheduler):
    """Host facade: the Scheduler, running the hierarchical cycle.

    One state per fleet width, allocated once, as every bucket's is; on
    CUDA one captured graph per (N bucket, fleet width, chunk lanes), with
    the coarse weights beside the dense blend's in its static weight
    buffer. A mesh is accepted for constructor parity with the Scheduler
    and kept on `deploy_mesh` for /debugz/fleet; the inner dense cycle
    runs mesh-free (its block is one M bucket, replicated by design), so
    the fused Sinkhorn kernel runs in a meshed deployment, as in the
    reference."""

    def __init__(
        self,
        cfg: ProfileConfig = ProfileConfig(),
        weights: Optional[Weights] = None,
        *,
        seed: int = 0,
        device=None,
        noise_source=None,
        predictor_fn=None,
        predictor_params=None,
        mesh=None,
        topk: int = 4,
        cell_cap: int = 64,
    ):
        if cell_cap < 32 or cell_cap % 32:
            raise ValueError(
                f"fleet cell_cap must be a positive multiple of 32 "
                f"(packed presence words are 32 endpoints wide); got "
                f"{cell_cap}")
        if topk < 1:
            raise ValueError(f"fleet topk must be >= 1; got {topk}")
        if topk * cell_cap > C.M_BUCKETS[-1]:
            raise ValueError(
                f"fleet topk*cell_cap = {topk * cell_cap} exceeds the "
                f"largest compressed bucket {C.M_BUCKETS[-1]}: the whole "
                f"candidate block must fit one dense cycle")
        self.fleet_topk = int(topk)
        self.fleet_cell_cap = int(cell_cap)
        if mesh is not None and device is None:
            device = mesh.device(0, 0)
        super().__init__(cfg, weights, seed=seed, device=device,
                         noise_source=noise_source,
                         predictor_fn=predictor_fn,
                         predictor_params=predictor_params, mesh=None)
        self.deploy_mesh = mesh
        # /debugz/fleet counters, fed by the batching completer (host
        # arrays, never under the pick lock): where the final pick landed
        # in its request's candidate list, and per-cell pick tallies.
        self._fleet_lock = threading.Lock()
        self._rank_hits: collections.Counter = collections.Counter()
        self._cell_picks: collections.Counter = collections.Counter()
        self._fleet_waves = 0

    # -- width policy ------------------------------------------------------

    def _m_ok(self, m: int) -> bool:
        if m % self.fleet_cell_cap:
            return False
        if m in C.M_BUCKETS:
            return True
        return m > C.M_BUCKETS[-1] and (m // self.fleet_cell_cap) % 32 == 0

    def _width_for(self, count: int) -> int:
        """Smallest valid width covering `count` slots: a dense M bucket
        while those fit, else the next multiple of cell_cap*32 (cells stay
        whole 32-bit sketch words)."""
        if count <= C.M_BUCKETS[-1]:
            return m_bucket_for(count)
        step = self.fleet_cell_cap * 32
        return -(-count // step) * step

    def _init_state(self, m: int) -> SchedState:
        return fleet_state(m, cell_cap=self.fleet_cell_cap,
                           device=self.device)

    def _resize_into(self, src: SchedState, dst: SchedState) -> SchedState:
        return fleet_resize_into(src, dst, cell_cap=self.fleet_cell_cap)

    def _state_shapes_ok(self, state: SchedState) -> bool:
        return check_state_shapes(state, cell_cap=self.fleet_cell_cap)

    def _graph_schema(self) -> tuple[str, ...]:
        return super()._graph_schema() + COARSE_WEIGHTS

    def _run_cycle(self, state, reqs, eps, gumbel, wvec=None):
        dense_w = coarse_w = None
        if wvec is not None:
            s = len(super()._graph_schema())
            dense_w = wvec[:s]
            coarse_w = types.SimpleNamespace(**{
                k: wvec[s + i] for i, k in enumerate(COARSE_WEIGHTS)})
        return fleet_cycle(
            state, reqs, eps, self.weights, gumbel, cfg=self.cfg,
            cell_cap=self.fleet_cell_cap, topk=self.fleet_topk,
            wvec=dense_w, coarse_weights=coarse_w,
            predictor_fn=self.predictor_fn,
            predictor_params=self.predictor_params)

    def _noise_shape(self, n: int, m: int) -> Optional[tuple]:
        # The dense stage draws the wave's noise at its own width.
        return super()._noise_shape(n, self.compressed_width(m))

    def compressed_width(self, m: int) -> int:
        """The dense stage's width (one M bucket) at fleet width m."""
        return compressed_width(m, cell_cap=self.fleet_cell_cap,
                                topk=self.fleet_topk)

    def compression_ratio(self, m: int) -> float:
        """Fraction of the fleet the dense stage scores at width m (the
        flight record's figure)."""
        cells = max(m // self.fleet_cell_cap, 1)
        k_sel = min(self.fleet_topk, cells)
        return m_bucket_for(k_sel * self.fleet_cell_cap) / float(m)

    # -- event paths in the sketch regime ------------------------------------

    def _clear_prefix(self, slot: int) -> None:
        """Exact mode: clear the endpoint's bits. Sketch mode: nothing;
        cell grain cannot express one endpoint's cache reset (or death)
        without erasing its cell-mates' affinity, and the stale bit ages
        out (prefix_max_age). Eviction keeps clearing load and duals."""
        if slot < self.state.m and not _is_sketch(self.state):
            prefix.clear_endpoint(self.state.prefix, slot)

    def _event_lanes(self, slot: int, stored: np.ndarray,
                     removed: np.ndarray, width: int):
        """In sketch mode (width past the largest bucket) a KV event lands
        at its endpoint's CELL, stored chunks only: one endpoint evicting a
        chunk says nothing of its cell-mates."""
        if width <= C.M_BUCKETS[-1]:
            return slot, stored, removed
        return slot // self.fleet_cell_cap, stored, removed[:0]

    # -- observability -------------------------------------------------------

    def note_fleet_wave(self, cand_cells: np.ndarray,
                        primary_slots: np.ndarray) -> None:
        """Completer-side tally (host arrays): where in its candidate list
        each request's final pick landed."""
        chosen_cells = primary_slots // self.fleet_cell_cap
        picked = primary_slots >= 0
        match = cand_cells == chosen_cells[:, None]
        ranks = np.argmax(match, axis=1)
        listed = match.any(axis=1)
        with self._fleet_lock:
            self._fleet_waves += 1
            for rank, ok, p in zip(ranks, listed, picked):
                if p:
                    self._rank_hits[int(rank) if ok else -1] += 1
            for cell, p in zip(chosen_cells, picked):
                if p:
                    self._cell_picks[int(cell)] += 1

    def fleet_report(self, max_cells: int = 32) -> dict:
        """/debugz/fleet payload: static configuration and bounded tallies
        (the hottest `max_cells` cells plus an aggregate, so the page's
        size is bounded whatever the fleet's)."""
        state = self.state
        m = state.m
        with self._fleet_lock:
            ranks = dict(sorted(self._rank_hits.items()))
            hot = self._cell_picks.most_common(max_cells)
            other = sum(self._cell_picks.values()) - sum(c for _, c in hot)
            waves = self._fleet_waves
        return {
            "topk": self.fleet_topk,
            "cell_cap": self.fleet_cell_cap,
            "cells": m // self.fleet_cell_cap,
            "fleet_m": m,
            "mode": "sketch" if _is_sketch(state) else "exact",
            "compression_ratio": round(self.compression_ratio(m), 6),
            "waves": waves,
            # rank -> picks landing on the request's rank-th candidate
            # cell; -1 = the tail filter walked outside the list.
            "topk_hit_histogram": {str(k): v for k, v in ranks.items()},
            "hot_cells": [{"cell": c, "picks": n} for c, n in hot],
            "other_cell_picks": max(other, 0),
        }

    def debug_report(self) -> dict:
        report = super().debug_report()
        report["fleet"] = {
            "topk": self.fleet_topk,
            "cell_cap": self.fleet_cell_cap,
            "compression_ratio": round(
                self.compression_ratio(self.state.m), 6),
        }
        return report
