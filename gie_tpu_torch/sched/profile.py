"""Profile composition: the full scheduling cycle (port of
gie_tpu/sched/profile.py).

A cycle is filter -> score (normalized, weighted blend) -> exactly one pick
-> state update (assumed load, prefix index, rr/tick, Sinkhorn duals), as
masked tensor algebra over the [N, M] grid. `Scheduler` is the facade the
data plane calls: it pads micro-batches to a bucket, runs the cycle on its
device with the state updated in place, and takes the request-termination
feedback that reconciles assumed load.

On CUDA every wave replays the cycle captured as a CUDA graph for its
(N bucket, M bucket, chunk lanes) key (sched/graphs.py), the counterpart of
the reference's compiled executable per key; warm_lattice_async captures a
lattice of keys on a background thread, as the reference compiles one. On
the CPU the cycle runs eagerly and warming runs it once on a throwaway
state.

`Scheduler(mesh=)` runs the cycle over a (dp, tp) mesh of shards
(parallel/mesh.py). The single-device cycle is the same code over a 1 x 1
grid, so the picks are bit-identical in any layout.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import logging
import os
import threading
import time
import zipfile
from typing import Callable, Optional

import numpy as np
import torch

from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched import filters, pickers, prefix, scorers
from gie_tpu_torch.sched.graphs import CycleGraph, FoldGraph
from gie_tpu_torch.sched.sinkhorn import _combine, _on
from gie_tpu_torch.sched.sinkhorn import _gather as _cat
from gie_tpu_torch.sched.types import (
    EndpointBatch,
    PickResult,
    RequestBatch,
    SchedState,
    Weights,
    bucket_for,
    m_bucket_for,
    pad_requests,
    resize_into,
)

log = logging.getLogger(__name__)

@dataclasses.dataclass(frozen=True)
class ProfileConfig:
    """Static profile configuration (the reference's fields and defaults;
    see gie_tpu/sched/profile.py for each knob's rationale)."""

    queue_limit: float = 128.0
    kv_limit: float = 0.95
    pd_disaggregation: bool = False
    pd_colocation_bonus: float = 0.25
    queue_norm: float = 64.0
    load_norm: float = 32.0
    load_decay: float = 0.95
    prefix_max_age: int = 50_000
    enable_saturation: bool = True
    enable_lora: bool = True
    enable_prefix: bool = True
    enable_session: bool = True
    session_key_chunks: int = 1
    shed_sheddable: bool = True
    picker: str = "topk"         # "topk" | "random" | "sinkhorn"
    sample_temperature: float = 0.05
    sinkhorn_tau: float = 0.02
    sinkhorn_iters: int = 8
    sinkhorn_rounding_temp: float = 0.1
    # Route the topk pick through the fused blend + top-k kernel
    # (first-max tie-break instead of the rotating quantized tie-break).
    use_pallas_topk: bool = False
    # Route the Sinkhorn solve through the fused Sinkhorn kernel.
    use_pallas_sinkhorn: bool = False
    scorer: str = "blend"        # "blend" | "learned"
    record_affinity: bool = True

    def __post_init__(self) -> None:
        # The reference's own validation, in its order.
        if self.sample_temperature <= 0.0:
            raise ValueError(
                f"sample_temperature must be > 0 (got "
                f"{self.sample_temperature}): zero noise permits exact "
                "score ties, which truncate the ordered fallback list")
        if self.sinkhorn_rounding_temp <= 0.0:
            raise ValueError(
                f"sinkhorn_rounding_temp must be > 0 (got "
                f"{self.sinkhorn_rounding_temp}): zero noise permits "
                "exact score ties, which truncate the fallback list")
        if self.scorer not in ("blend", "learned"):
            raise ValueError(
                f"scorer must be 'blend' or 'learned' (got {self.scorer!r})")
        if self.scorer == "learned" and self.use_pallas_topk:
            raise ValueError(
                "scorer='learned' is incompatible with use_pallas_topk: "
                "the fused kernel hard-codes the weighted-sum blend")
        if self.scorer == "learned" and self.pd_disaggregation:
            raise ValueError(
                "scorer='learned' is incompatible with pd_disaggregation: "
                "the dual pick de-blends the linear total arithmetically")
        if self.picker not in ("topk", "random", "sinkhorn"):
            raise ValueError(
                f"unknown picker {self.picker!r}; known: topk, random, "
                "sinkhorn")


def _affinity_columns(named: dict, primary: torch.Tensor,
                      picked_ok: torch.Tensor) -> torch.Tensor:
    """(prefix, session) scorer values at each request's primary pick
    -> f32[N, 2]; disabled columns and non-OK rows read 0.0."""
    n = primary.shape[0]
    zero = torch.zeros((n,), dtype=torch.float32, device=primary.device)
    safe = torch.clamp(primary, min=0).long()[:, None]

    def at_primary(col):
        if col is None:
            return zero
        return torch.gather(col, 1, safe)[:, 0]

    pair = torch.stack(
        [at_primary(named.get("prefix")), at_primary(named.get("session"))],
        dim=-1)
    return torch.where(picked_ok[:, None], pair, torch.zeros_like(pair))


def request_cost(reqs: RequestBatch) -> torch.Tensor:
    """Assumed cost of admitting each request, in normalized units."""
    return torch.clamp((reqs.prompt_len + reqs.decode_len) / 2048.0,
                       0.25, 8.0)


def request_cost_host(prompt_len: float, decode_len: float = 0.0) -> float:
    """Host-side twin of request_cost (completion must release exactly
    what pick time charged)."""
    return float(np.clip((prompt_len + decode_len) / 2048.0, 0.25, 8.0))


def pd_costs(reqs: RequestBatch) -> tuple[torch.Tensor, torch.Tensor]:
    """Split assumed costs for the dual pick: the prefill worker carries
    the prompt, the decode worker the generation."""
    prefill = torch.clamp(reqs.prompt_len / 2048.0, 0.125, 8.0)
    decode = torch.clamp(reqs.decode_len / 2048.0, 0.125, 8.0)
    return prefill, decode


def pd_costs_host(prompt_len: float, decode_len: float) -> tuple[float, float]:
    """Host-side twin of pd_costs (the same release-what-you-charged
    contract as request_cost_host)."""
    return (
        float(np.clip(prompt_len / 2048.0, 0.125, 8.0)),
        float(np.clip(decode_len / 2048.0, 0.125, 8.0)),
    )


def feature_schema(cfg: ProfileConfig, *,
                   has_predictor: bool = False) -> tuple[str, ...]:
    """Ordered names of the scorer columns build_stages stacks (the one
    source of truth a learned policy artifact is validated against); the
    latency predictor's column, when bound, comes last."""
    cols = ["queue", "kv_cache", "assumed_load"]
    if cfg.enable_prefix:
        cols.append("prefix")
    if cfg.enable_session:
        cols.append("session")
    if cfg.enable_lora:
        cols.append("lora")
    if has_predictor:
        cols.append("latency")
    return tuple(cols)


@functools.lru_cache(maxsize=64)
def _weight_vector(weights: Weights, names: tuple,
                   device: torch.device) -> torch.Tensor:
    """The blend weights of `names` as f32[S] on `device`, made once per
    (weights, columns, device): a host-to-device copy on every wave would
    make the host wait for the device's queue. Callers never write it."""
    return torch.tensor([getattr(weights, k) for k in names],
                        dtype=torch.float32, device=device)


# -- the cycle over a grid of blocks -----------------------------------------
# The cycle runs over a (dp, tp) grid of blocks: position (i, j) works on
# request rows i, endpoint columns j and the state's tp shard j. One
# device's whole wave is the 1 x 1 grid, where every gather and combine
# below passes its one block through, so the single-device cycle and the
# meshed one (parallel/mesh.py) are one code path. docs/MESH.md's three
# classes of operation map onto it as follows.
#
#   1. Elementwise and max/argmax work (filters, scorer columns, the blend,
#      the lane tiebreak, the top-k) is exact in any layout. A row's
#      cross-shard flags and maxima combine its blocks' in tp order; each
#      pick gathers its row block's tp columns ([N/dp, M]) and runs the
#      picker there (the fused top-k kernel once per dp row).
#   2. Noise: the wave's one draw, cut into blocks (mesh.shard_noise).
#   3. Coupled float sums (the Sinkhorn solve, its capacities and
#      warm-start gate) run as fixed group partials, gathered in mesh order
#      and folded as on one device (sched/sinkhorn.py).
#
# The state update sends each charge to the shard that owns its slot, over
# every row of the wave in dp order (the order the single-device scatter
# sums in), and every shard decides the prefix table's winning lanes over
# the whole wave (last lane wins), writing the presence cells it holds.


@dataclasses.dataclass
class _Wave:
    """The blocks of one wave and the state shards it updates."""

    mesh: object          # the Mesh, or None for one device's whole wave
    reqs: list            # [dp][tp] RequestBatch
    eps: list             # [dp][tp] EndpointBatch
    shards: list          # [tp] SchedState, updated in place
    st: list              # [dp][tp] SchedState as each position reads it
    windows: list         # [tp] each shard's block of the presence matrix
    words_axis: bool      # whether `present` splits on its word axis

    @staticmethod
    def of(mesh, state, reqs, eps) -> "_Wave":
        """One device's whole tensors (mesh None: the 1 x 1 grid), or a
        ShardedState and [dp][tp] shards over `mesh`."""
        if mesh is None:
            return _Wave(None, [[reqs]], [[eps]], [state], [[state]], [{}],
                         True)
        return _Wave(mesh, reqs, eps, state.shards,
                     [[state.at(i, j) for j in range(mesh.tp)]
                      for i in range(mesh.dp)],
                     [state.window(j) for j in range(mesh.tp)],
                     state.words_axis)

    @property
    def dp(self) -> int:
        return len(self.reqs)

    @property
    def tp(self) -> int:
        return len(self.reqs[0])

    @property
    def m_loc(self) -> int:
        return int(self.eps[0][0].valid.shape[0])

    def dev(self, i: int, j: int) -> torch.device:
        return self.eps[i][j].valid.device

    def home(self, i: int) -> torch.device:
        return self.dev(i, 0)

    def cells(self):
        for i in range(self.dp):
            for j in range(self.tp):
                yield i, j

    def grid(self, fn: Callable) -> list:
        return [[fn(i, j) for j in range(self.tp)] for i in range(self.dp)]

    def row(self, blocks: list, i: int, dim: int = -1) -> torch.Tensor:
        """Row i's tp blocks gathered into one [N/dp, M] row block."""
        return _cat(blocks[i], dim, self.home(i))


def _prefix_blocks(w: _Wave, cfg: ProfileConfig) -> list:
    """The prefix scorer column's blocks. Word shards read their own
    words; slot shards each contribute the words of the slots they hold
    (zeros elsewhere), ORed in tp order into the row's whole words."""
    if w.words_axis:
        return w.grid(lambda i, j: prefix.match_scores(
            w.st[i][j].prefix, w.reqs[i][j], w.st[i][j].tick,
            max_age=cfg.prefix_max_age))
    out = []
    for i in range(w.dp):
        words = None
        for j in range(w.tp):
            part = _on(prefix.hit_words(
                w.st[i][j].prefix, w.reqs[i][j], w.st[i][j].tick,
                max_age=cfg.prefix_max_age,
                row0=w.windows[j]["row0"]), w.home(i))
            words = part if words is None else words | part
        full = prefix.match_from_words(words, w.reqs[i][0])
        out.append([_on(full[:, j * w.m_loc:(j + 1) * w.m_loc].contiguous(),
                        w.dev(i, j)) for j in range(w.tp)])
    return out


def _session_blocks(w: _Wave, cfg: ProfileConfig) -> list:
    """The session scorer column's blocks: each block's rendezvous hashes
    at its global slots, the row's winner and runner-up hashes combined
    across tp."""
    keyed = w.grid(lambda i, j: scorers.session_hash(
        w.reqs[i][j], w.eps[i][j], key_chunks=cfg.session_key_chunks,
        col0=j * w.m_loc))
    out = []
    for i in range(w.dp):
        hs = [h for _, h in keyed[i]]
        top = _combine([h.amax(dim=-1, keepdim=True) for h in hs],
                       w.home(i), "amax")
        ranked = [scorers.runner_up_hash(h, _on(top, h.device)) for h in hs]
        second = _combine([h2.amax(dim=-1, keepdim=True) for _, h2 in ranked],
                          w.home(i), "amax")
        out.append([scorers.session_from_hash(
            w.reqs[i][j], w.eps[i][j], keyed[i][j][0], hs[j], *ranked[j],
            _on(second, hs[j].device)) for j in range(w.tp)])
    return out


def _stages(w: _Wave, weights: Weights, *, cfg: ProfileConfig, wvec=None,
            predictor_fn=None, predictor_params=None):
    """build_stages over the blocks -> (mask [dp][tp], shed [dp], named
    [dp][tp] dicts, stacked [dp][tp], wvec, total [dp][tp] or None)."""
    mask = [[None] * w.tp for _ in range(w.dp)]
    memb = [[None] * w.tp for _ in range(w.dp)]
    for i, j in w.cells():
        r, e = w.reqs[i][j], w.eps[i][j]
        mk = filters.base_mask(r, e)
        if cfg.enable_lora:
            memb[i][j] = filters.lora_membership(r, e)
            mk = mk & filters.lora_capacity_mask(r, e, memb[i][j])
        mask[i][j] = mk
    shed = [torch.zeros(w.reqs[i][0].valid.shape, dtype=torch.bool,
                        device=w.home(i)) for i in range(w.dp)]
    if cfg.enable_saturation:
        sat = w.grid(lambda i, j: mask[i][j] & filters.saturation_mask(
            w.reqs[i][j], w.eps[i][j], queue_limit=cfg.queue_limit,
            kv_limit=cfg.kv_limit))
        for i in range(w.dp):
            had = _combine([b.any(dim=-1) for b in mask[i]], w.home(i), "any")
            any_unsat = _combine([b.any(dim=-1) for b in sat[i]], w.home(i),
                                 "any")
            sheddable = (w.reqs[i][0].criticality
                         == int(C.Criticality.SHEDDABLE))
            if cfg.shed_sheddable:
                shed[i] = sheddable & had & ~any_unsat
                keep_hard = sheddable | any_unsat
            else:
                keep_hard = any_unsat
            for j in range(w.tp):
                kh = _on(keep_hard, w.dev(i, j))
                mask[i][j] = torch.where(kh[:, None], sat[i][j], mask[i][j])

    pref = _prefix_blocks(w, cfg) if cfg.enable_prefix else None
    sess = _session_blocks(w, cfg) if cfg.enable_session else None
    named = [[None] * w.tp for _ in range(w.dp)]
    stacked = [[None] * w.tp for _ in range(w.dp)]
    for i, j in w.cells():
        r, e, s = w.reqs[i][j], w.eps[i][j], w.st[i][j]
        shape = mask[i][j].shape
        nm = {
            "queue": scorers.queue_score(
                e, queue_norm=cfg.queue_norm)[None, :].expand(shape),
            "kv_cache": scorers.kv_cache_score(e)[None, :].expand(shape),
            "assumed_load": scorers.assumed_load_score(
                s.assumed_load, load_norm=cfg.load_norm)[None, :]
            .expand(shape),
        }
        if pref is not None:
            nm["prefix"] = pref[i][j]
        if sess is not None:
            nm["session"] = sess[i][j]
        if cfg.enable_lora:
            nm["lora"] = scorers.lora_affinity_score(r, e, memb[i][j])
        if predictor_fn is not None:
            # Replicated params: each position reads them on its device.
            params = (None if predictor_params is None else
                      {k: _on(v, w.dev(i, j))
                       for k, v in predictor_params.items()})
            # A tp shard names the global slot of its first lane.
            at = {"col0": j * w.m_loc} if w.tp > 1 else {}
            nm["latency"] = predictor_fn(params, r, e, s.assumed_load, **at)
        named[i][j] = nm
        stacked[i][j] = torch.stack(list(nm.values()))       # [S, n, m]
    if wvec is None:
        wvec = _weight_vector(weights, tuple(named[0][0]), w.dev(0, 0))
    total = None
    if cfg.scorer == "learned" or cfg.pd_disaggregation or not (
            cfg.picker == "topk" and cfg.use_pallas_topk):
        total = [[None] * w.tp for _ in range(w.dp)]
        for i, j in w.cells():
            wv = _on(wvec, w.dev(i, j))
            if cfg.scorer == "learned":
                # The gie-learn multiplicative policy; the reference
                # forbids it beside the fused top-k and the dual pick
                # (ProfileConfig).
                from gie_tpu_torch.learn.policy import multiplicative_total

                total[i][j] = multiplicative_total(stacked[i][j], wv)
            else:
                total[i][j] = blend(wv, stacked[i][j])
    return mask, shed, named, stacked, wvec, total


def build_stages(
    state: SchedState,
    reqs: RequestBatch,
    eps: EndpointBatch,
    weights: Weights,
    *,
    cfg: ProfileConfig,
    wvec: Optional[torch.Tensor] = None,
    predictor_fn: Optional[Callable] = None,
    predictor_params=None,
    mesh=None,
):
    """Filter + score stages -> (mask, shed, named column dict,
    stacked [S,N,M], wvec [S], blended total [N,M]). `total` is None on
    the fused top-k path, whose kernel blends the columns itself (the
    reference computes it there too, and XLA drops it as dead code),
    unless the profile is disaggregated: the decode pick de-blends it.
    `wvec`, when given, is the blend weights of feature_schema(cfg) as a
    tensor the caller fills (a captured cycle's static buffer); otherwise
    they come from `weights`. `predictor_fn(predictor_params, reqs, eps,
    assumed_load) -> f32[N, M]`, when given, adds the "latency" column
    last (models.latency.predictor_score_fn builds it); over several tp
    shards it also takes `col0`, the global slot of eps' first lane.

    With `mesh`, the inputs are shards as scheduling_cycle takes them and
    every output but wvec is its [dp][tp] blocks (shed its [dp] rows).

    Saturation is a soft filter: unsaturated candidates are preferred;
    when all are saturated SHEDDABLE traffic is shed (429) and STANDARD
    falls back to the full candidate set (CRITICAL bypasses it)."""
    mask, shed, named, stacked, wvec, total = _stages(
        _Wave.of(mesh, state, reqs, eps), weights, cfg=cfg, wvec=wvec,
        predictor_fn=predictor_fn, predictor_params=predictor_params)
    if mesh is not None:
        return mask, shed, named, stacked, wvec, total
    return (mask[0][0], shed[0], named[0][0], stacked[0][0], wvec,
            None if total is None else total[0][0])


def blend(wvec: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """The weighted blend of the scorer columns -> f32[N, M]: sum_s w[s] *
    col[s] folded in order s = 0, 1, ... (each product rounded, then
    added), divided by max(sum w, 1e-6). Elementwise, so a block of the
    grid blends bit-equal to the whole on every device, as a matrix
    product, whose summation order follows its shape, would not; the
    weight sum is one replicated scalar."""
    total = wvec[0] * stacked[0]
    for si in range(1, stacked.shape[0]):
        total = total + wvec[si] * stacked[si]
    return total / torch.clamp(wvec.sum(), min=1e-6)


def _pick_stage(w: _Wave, total, stacked, wvec, mask, shed, gumbel,
                cfg: ProfileConfig) -> tuple[list, dict]:
    """The configured picker over the blocks -> ([dp] PickResult row
    shards, aux with the Sinkhorn duals' [tp] shards). `gumbel` is the
    blocks of the wave's standard Gumbel noise, which the random and
    sinkhorn pickers take (the reference hands both the wave's key)."""
    valid = [w.reqs[i][0].valid for i in range(w.dp)]
    if cfg.picker == "topk" and cfg.use_pallas_topk:
        from gie_tpu_torch.ops.fused_topk import fused_blend_topk

        out = []
        for i in range(w.dp):
            # One launch per dp row over its rows, the tp columns
            # gathered: the kernel is row-local and exact.
            mk = w.row(mask, i)
            vals, idxs = fused_blend_topk(
                w.row(stacked, i, dim=2), _on(wvec, w.home(i)), mk,
                k=C.FALLBACKS)
            out.append(pickers.finalize_from_topk(vals, idxs, mk, shed[i],
                                                  valid[i]))
        return out, {}
    if cfg.picker == "random":
        if gumbel is None:
            raise ValueError("the random picker needs a Gumbel noise tensor")
        return [pickers.weighted_random_picker(
            w.row(total, i), w.row(mask, i), shed[i], valid[i],
            w.row(gumbel, i), temperature=cfg.sample_temperature)
            for i in range(w.dp)], {}
    if cfg.picker == "sinkhorn":
        from gie_tpu_torch.sched.sinkhorn import sinkhorn_picker

        if gumbel is None:
            raise ValueError("the sinkhorn picker needs a Gumbel noise tensor")
        rows, v_out = sinkhorn_picker(
            total, mask, shed, valid, w.eps, gumbel,
            queue_limit=cfg.queue_limit, tau=cfg.sinkhorn_tau,
            iters=cfg.sinkhorn_iters,
            rounding_temp=cfg.sinkhorn_rounding_temp,
            use_kernel=cfg.use_pallas_sinkhorn and w.mesh is None,
            v0=[s.ot_v for s in w.st[0]])
        return rows, {"ot_v": v_out}
    return [pickers.topk_picker(w.row(total, i), w.row(mask, i), shed[i],
                                valid[i], w.st[i][0].rr)
            for i in range(w.dp)], {}


def _charge(w: _Wave, lanes: list, decay: float) -> None:
    """The assumed-load update: every (slot, cost) lane list, each over
    the whole wave in dp order, summed into each shard's own slots (over
    several shards the others' go to a dropped scratch slot), then load =
    load * decay + added on every shard."""
    m_loc = w.m_loc
    for j, s in enumerate(w.shards):
        dev = s.assumed_load.device
        added = torch.zeros((m_loc + (w.tp > 1),), dtype=torch.float32,
                            device=dev)
        for slot, cost in lanes:
            slot, cost = _on(slot, dev), _on(cost, dev)
            if w.tp > 1:
                local = slot - j * m_loc
                own = (local >= 0) & (local < m_loc)
                slot = torch.where(own, local, m_loc)
                cost = torch.where(own, cost, torch.zeros_like(cost))
            added.index_add_(0, slot, cost)
        s.assumed_load.mul_(decay).add_(added[:m_loc])


@dataclasses.dataclass(frozen=True)
class _Lanes:
    """The (request, chunk) lanes prefix.insert reads from a wave."""

    chunk_hashes: torch.Tensor
    n_chunks: torch.Tensor


def _insert(w: _Wave, picked: list) -> None:
    """prefix.insert over the shards: the whole wave's lanes in dp order
    on every shard, each writing the presence cells it holds."""
    for j, s in enumerate(w.shards):
        dev = s.prefix.keys.device
        lanes = _Lanes(
            chunk_hashes=_cat([w.reqs[i][j].chunk_hashes
                               for i in range(w.dp)], 0, dev),
            n_chunks=_cat([w.reqs[i][j].n_chunks for i in range(w.dp)], 0,
                          dev))
        prefix.insert(s.prefix, lanes, _cat(picked, 0, dev), s.tick,
                      **w.windows[j])


def _advance(w: _Wave) -> None:
    for s in w.shards:
        s.rr.add_(1).bitwise_and_(C.U32_MASK)
        s.tick.add_(1).bitwise_and_(C.U32_MASK)


def _affinity(w: _Wave, named: list, i: int, primary, ok) -> torch.Tensor:
    row = {k: _cat([nm[k] for nm in named[i]], -1, w.home(i))
           for k in ("prefix", "session") if k in named[i][0]}
    return _affinity_columns(row, primary, ok)


def scheduling_cycle(
    state: SchedState,
    reqs: RequestBatch,
    eps: EndpointBatch,
    weights: Weights,
    gumbel: Optional[torch.Tensor],
    *,
    cfg: ProfileConfig,
    wvec: Optional[torch.Tensor] = None,
    predictor_fn: Optional[Callable] = None,
    predictor_params=None,
    mesh=None,
) -> tuple[PickResult, SchedState]:
    """One full scheduling cycle. Updates `state`'s tensors IN PLACE (the
    role of the reference's donated buffers) and returns (result, state).

    With `mesh` the cycle runs over its shards: `state` is a ShardedState,
    `reqs` and `eps` [dp][tp] shards, `gumbel` the noise's blocks, and the
    result is [dp] PickResult row shards (parallel/mesh.py's shard_* and
    unshard_* helpers). Without, it runs the same code over the 1 x 1
    grid of the whole tensors.

    `gumbel` is the standard Gumbel noise f32[N, M] the sinkhorn picker's
    rounding and the random picker's sampling use (the reference draws it
    from its PRNG key inside the cycle), f32[2, N, M] under
    pd_disaggregation (plane 0 for the prefill pick, plane 1 for the
    decode pick: the reference's split of the wave's key); the top-k
    picker ignores it and takes None. `wvec`, `predictor_fn` and
    `predictor_params`: see build_stages. The cycle makes no call that
    waits for the device, so it can be captured into a CUDA graph
    (sched/graphs.py).
    """
    w = _Wave.of(mesh, state, reqs, eps)
    if mesh is None and gumbel is not None:
        gumbel = [[gumbel]]
    mask, shed, named, stacked, wvec, total = _stages(
        w, weights, cfg=cfg, wvec=wvec, predictor_fn=predictor_fn,
        predictor_params=predictor_params)
    if cfg.pd_disaggregation:
        rows = _pd_cycle(w, gumbel, cfg, mask=mask, shed=shed, named=named,
                         stacked=stacked, wvec=wvec, total=total)
    else:
        rows, aux = _pick_stage(w, total, stacked, wvec, mask, shed, gumbel,
                                cfg)
        m = w.m_loc * w.tp
        slots, costs, primaries = [], [], []
        for i, res in enumerate(rows):
            primary = res.indices[:, 0]             # i32[N], -1 on non-OK
            picked_ok = primary >= 0
            if cfg.record_affinity:
                rows[i] = res.replace(
                    affinity=_affinity(w, named, i, primary, picked_ok))
            cost = request_cost(w.reqs[i][0])
            costs.append(torch.where(picked_ok, cost, torch.zeros_like(cost)))
            slots.append(torch.where(picked_ok, primary, m - 1).long())
            primaries.append(primary)
        home = w.dev(0, 0)
        _charge(w, [(_cat(slots, 0, home), _cat(costs, 0, home))],
                cfg.load_decay)
        if cfg.enable_prefix:
            _insert(w, primaries)
        _advance(w)
        if "ot_v" in aux:
            for s, v in zip(w.shards, aux["ot_v"]):
                s.ot_v.copy_(v)
    return (rows[0] if mesh is None else rows), state


# Locality columns that only describe the PREFILL side (the prefix cache
# and session affinity live where prefill runs); the decode blend drops
# them and uses load/queue/kv signals plus the co-location bonus.
_PREFILL_ONLY_COLUMNS = ("prefix", "session")


def _pd_cycle(w: _Wave, gumbel, cfg: ProfileConfig, *, mask, shed, named,
              stacked, wvec, total) -> list:
    """Dual pick for disaggregated serving (the reference's _pd_cycle):
    the prefill endpoint (full blend over PREFILL/BOTH roles), then the
    decode endpoint (locality columns dropped, co-location bonus, over
    DECODE/BOTH roles). `indices` is the decode pick and `prefill` names
    the prefill worker -> [dp] PickResult row shards. Updates the state in
    place; neither solve writes the carried Sinkhorn duals (one vector
    under two capacity patterns would poison both warm starts)."""
    prefill_ok = w.grid(lambda i, j: mask[i][j] & (
        w.eps[i][j].role != int(C.Role.DECODE))[None, :])
    decode_ok = w.grid(lambda i, j: mask[i][j] & (
        w.eps[i][j].role != int(C.Role.PREFILL))[None, :])
    if gumbel is None:
        g_p = g_d = None
    else:
        g_p = w.grid(lambda i, j: gumbel[i][j][0])
        g_d = w.grid(lambda i, j: gumbel[i][j][1])
    p_rows, _ = _pick_stage(w, total, stacked, wvec, prefill_ok, shed, g_p,
                            cfg)
    p_primary = [r.indices[:, 0] for r in p_rows]

    names = list(named[0][0])
    keep = torch.ones_like(wvec)
    for k, name in enumerate(names):
        if name in _PREFILL_ONLY_COLUMNS:
            keep[k].fill_(0.0)            # a device fill: capturable
    d_wvec = wvec * keep
    # Incremental de-blend: (total * sum(w) - the prefill-only columns) /
    # sum(kept w), two column reads instead of re-reducing the stack.
    # Degeneracy guard: when the kept weights are negligible against the
    # total mass (a locality-only tuning) the subtraction leaves float32
    # cancellation residue that a tiny denominator would blow up past the
    # co-location bonus; the decode side then has no signal, so 0.
    wsum = torch.clamp(wvec.sum(), min=1e-6)
    d_wsum = d_wvec.sum()
    bonus = float(np.float32(cfg.pd_colocation_bonus))
    d_total = [[None] * w.tp for _ in range(w.dp)]
    for i, j in w.cells():
        dev = w.dev(i, j)
        wv, ws, dws = _on(wvec, dev), _on(wsum, dev), _on(d_wsum, dev)
        dropped = torch.zeros((), dtype=torch.float32, device=dev)
        for k, name in enumerate(names):
            if name in _PREFILL_ONLY_COLUMNS:
                dropped = dropped + wv[k] * named[i][j][name]
        dt = torch.where(dws > 1e-4 * ws,
                         (total[i][j] * ws - dropped)
                         / torch.clamp(dws, min=1e-6),
                         torch.zeros((), dtype=torch.float32, device=dev))
        # The same endpoint as the prefill pick needs no KV transfer: a
        # bonus on that lane (only BOTH-role endpoints can win both picks).
        lanes = torch.arange(j * w.m_loc, (j + 1) * w.m_loc,
                             dtype=torch.int32, device=dev)
        colocated = lanes[None, :] == _on(p_primary[i], dev)[:, None]
        d_total[i][j] = dt + bonus * colocated
    # The fused top-k recomputes the blend from (stacked, wvec) and would
    # drop the co-location bonus: the decode pick never takes it.
    d_cfg = (dataclasses.replace(cfg, use_pallas_topk=False)
             if cfg.use_pallas_topk else cfg)
    d_rows, _ = _pick_stage(w, d_total, stacked, d_wvec, decode_ok, shed,
                            g_d, d_cfg)

    m = w.m_loc * w.tp
    out, p_lanes, d_lanes, prefills = [], [], [], []
    for i in range(w.dp):
        p_res, d_res = p_rows[i], d_rows[i]
        d_primary = d_res.indices[:, 0]
        ok = (p_primary[i] >= 0) & (d_primary >= 0)
        # SHED (from either pick) wins over NO_CAPACITY; OK requires both.
        status = torch.maximum(p_res.status, d_res.status)
        is_ok = status == int(C.Status.OK)
        status = torch.where(
            ~ok & is_ok, torch.full_like(status, int(C.Status.NO_CAPACITY)),
            status)
        # Each side's cost to its own worker, prefill first.
        p_cost_all, d_cost_all = pd_costs(w.reqs[i][0])
        zero = torch.zeros_like(p_cost_all)
        p_lanes.append((torch.where(ok, p_primary[i], m - 1).long(),
                        torch.where(ok, p_cost_all, zero)))
        d_lanes.append((torch.where(ok, d_primary, m - 1).long(),
                        torch.where(ok, d_cost_all, zero)))
        prefill = torch.where(ok, p_primary[i],
                              torch.full_like(p_primary[i], -1))
        prefills.append(prefill)
        out.append(PickResult(
            indices=d_res.indices, status=status, scores=d_res.scores,
            prefill=prefill,
            # Affinity is a PREFILL-side property: gathered at the prefill
            # pick, not the decode destination.
            affinity=(_affinity(w, named, i, p_primary[i], ok)
                      if cfg.record_affinity else None)))
    home = w.dev(0, 0)

    def whole(lanes):
        return (_cat([s for s, _ in lanes], 0, home),
                _cat([c for _, c in lanes], 0, home))

    _charge(w, [whole(p_lanes), whole(d_lanes)], cfg.load_decay)
    if cfg.enable_prefix:
        # Only OK requests run: a rejected request must not record its
        # chunks as cached on the prefill worker.
        _insert(w, prefills)
    _advance(w)
    return out


@dataclasses.dataclass
class PendingWave:
    """Handle to one dispatched scheduling cycle.

    On CUDA, pick_async returns with the cycle's kernels and the copies of
    its live result rows (and of the load snapshot) into pinned host
    tensors queued on the stream, followed by `event`: `materialize()`
    waits on that event alone, so it never waits for waves queued after
    this one. On the CPU the tensors are the results and `event` is None.
    """

    result: PickResult        # host tensors, rows [0, n) are live
    n: int                    # pre-padding request count
    load_snapshot: Optional[torch.Tensor] = None  # post-cycle load, host
    event: Optional[torch.cuda.Event] = None

    def _wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def materialize(self) -> PickResult:
        """-> PickResult of numpy arrays, rows [0, n)."""
        self._wait()
        return PickResult(**{
            f.name: (None if getattr(self.result, f.name) is None
                     else getattr(self.result, f.name).numpy()[: self.n])
            for f in dataclasses.fields(PickResult)})

    def materialize_load(self) -> Optional[np.ndarray]:
        if self.load_snapshot is None:
            return None
        self._wait()
        return self.load_snapshot.numpy()


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """A pinned host tensor that a copy of device tensor `t`, queued on
    the current stream, fills."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


def check_state_shapes(state: SchedState,
                       cell_cap: Optional[int] = None) -> bool:
    """Cross-field shape consistency of a SchedState built from external
    arrays (digest install): the width is an M bucket shared by load and
    duals, the packed presence matrix matches the table's rows and the
    bucket's word width, and the counters are scalars. With `cell_cap` (a
    fleet picker's) a width past the largest bucket is accepted too when
    it is whole 32-cell words of cells, with a presence matrix of one bit
    per cell (the fleet's sketch table)."""
    try:
        m = int(state.assumed_load.shape[0])
    except (TypeError, IndexError):
        return False
    if m in C.M_BUCKETS:
        words = m // 32
    elif (cell_cap and m > C.M_BUCKETS[-1] and m % cell_cap == 0
          and (m // cell_cap) % 32 == 0):
        words = m // cell_cap // 32
    else:
        return False
    px = state.prefix
    return (
        tuple(state.assumed_load.shape) == (m,)
        and tuple(state.ot_v.shape) == (m,)
        and px.keys.dim() == 1
        and tuple(px.present.shape) == (int(px.keys.shape[0]), words)
        and tuple(px.ages.shape) == tuple(px.keys.shape)
        and tuple(state.rr.shape) == ()
        and tuple(state.tick.shape) == ()
    )


def _complete_update(state: SchedState, slots: torch.Tensor,
                     costs: torch.Tensor) -> SchedState:
    """Request-termination feedback, in place: subtract reconciled assumed
    load. Slots beyond the state's M bucket are dropped, not clamped."""
    m = state.m
    ok = (slots >= 0) & (slots < m)
    safe = torch.where(ok, slots, torch.zeros_like(slots)).long()
    sub = torch.zeros((m,), dtype=torch.float32, device=costs.device)
    sub.index_add_(0, safe, torch.where(ok, costs, torch.zeros_like(costs)))
    state.assumed_load.sub_(sub).clamp_(min=0.0)
    return state


def gumbel_noise(shape: tuple, generator: torch.Generator,
                 device, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard Gumbel noise f32[shape] drawn from `generator`:
    -log(-log(U)) with U clamped to [finfo.tiny, 1), the range
    jax.random.gumbel draws its uniforms from. With `out` the noise is
    drawn into it in place: the same draws, the same values."""
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.rand(shape, generator=generator, dtype=torch.float32,
               device=device, out=out)
    out.clamp_(min=torch.finfo(torch.float32).tiny)
    return out.log_().neg_().log_().neg_()


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`. A host tensor bound for CUDA goes through pinned
    memory as a copy queued on the current stream: a copy from pageable
    memory would make the host wait for everything queued before it."""
    if t.device == device or device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _batch_to_device(batch, device):
    """The same batch with every tensor on `device`."""
    return type(batch)(**{
        f.name: _to_device(getattr(batch, f.name), device)
        for f in dataclasses.fields(batch)})


def resolve_device(device) -> torch.device:
    """The scheduler's device: CUDA unless the caller names another. With
    no CUDA and no explicit device this raises; it never moves to the CPU
    on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "gie_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    # A definite index: the threads that dispatch and complete waves may
    # each have another current device.
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


class Scheduler:
    """Host facade over the scheduling cycle.

    Thread-safe: calls serialize on a lock around the state, which the
    cycle updates in place. Each M bucket's state is allocated once, on
    first use, and never reallocated: a bucket change fills the target
    bucket's tensors from the current one's (resize_into) and an install
    copies into them, so the addresses a captured cycle holds stay live.
    Randomness: the sinkhorn and random pickers' Gumbel noise comes from a
    torch.Generator on the scheduler's device seeded with `seed`, or from
    `noise_source(shape) -> Tensor` when given (the parity tests replay
    the JAX scheduler's noise through it).

    Warming (the reference's compile cache, keyed (n_bucket, m,
    chunk_lanes)): on CUDA a key is warm once its cycle is captured as a
    CUDA graph, and every wave of that key replays it; a wave of a cold key
    captures it inline first and counts `warm_inline_compiles`. On the CPU
    warming runs the eager cycle once on a throwaway state.

    The latency column (`predictor_fn`, models.latency.predictor_score_fn):
    the configured latency weight is the ceiling gate_latency_column
    scales toward, and the live blend starts at 0. `predictor_params` are
    copied once into static buffers on the scheduler's device, made before
    any capture and never reallocated: set_predictor_params copies new
    params into them, so a captured cycle reads them at the addresses it
    holds and a handoff never recaptures.
    """

    def __init__(
        self,
        cfg: ProfileConfig = ProfileConfig(),
        weights: Optional[Weights] = None,
        *,
        seed: int = 0,
        device=None,
        noise_source: Optional[Callable[[tuple], object]] = None,
        predictor_fn=None,
        predictor_params=None,
        mesh=None,
    ):
        if mesh is not None:
            # Every padded wave must split evenly over the dp axis; the N
            # buckets are powers of two, so dp must be one too.
            dp = int(mesh.shape["dp"])
            if dp & (dp - 1) or dp > C.N_BUCKETS[-1]:
                raise ValueError(
                    f"mesh dp axis must be a power of two <= "
                    f"{C.N_BUCKETS[-1]} to divide the request buckets "
                    f"{C.N_BUCKETS}; got dp={dp}")
            if cfg.picker == "sinkhorn" and cfg.use_pallas_sinkhorn:
                # The reference's own rule (use_pallas and mesh is None):
                # the fused kernel solves one device's whole wave.
                log.warning(
                    "use_pallas_sinkhorn is set, but a meshed scheduler runs "
                    "the grouped Sinkhorn solve over its shards and never "
                    "launches the fused kernel (debug_report: "
                    "sinkhorn_solve)")
        # A meshed scheduler's device is its first position's: the state's
        # first shard, the noise draw and the gathered results live there.
        self.mesh = mesh
        self._min_bucket = 1 if mesh is None else int(mesh.shape["dp"])
        self.cfg = cfg
        self.weights = weights if weights is not None else Weights.default()
        self.device = (mesh.device(0, 0) if mesh is not None and device is None
                       else resolve_device(device))
        if mesh is not None and mesh.device(0, 0) != self.device:
            raise ValueError(f"a mesh whose first position is "
                             f"{mesh.device(0, 0)} for a scheduler on "
                             f"{self.device}")
        # Whether waves replay captured graphs and state calls queue for
        # them: on CUDA, unless the mesh spans several cards (a capture
        # covers one device's stream; such a mesh runs its cycle eagerly).
        self._captured = self.device.type == "cuda" and (
            mesh is None or len(mesh.distinct_devices) == 1)
        # The configured latency weight is the CEILING the phase-in gate
        # scales toward; with a predictor column the live blend starts at
        # 0, so an untrained model never dilutes the heuristics.
        self.base_latency_weight = float(self.weights.latency)
        if predictor_fn is not None and self.base_latency_weight > 0.0:
            self.weights = self.weights.replace(latency=0.0)
        self.predictor_fn = predictor_fn
        self.predictor_params = _static_params(predictor_params, self.device)
        self.noise_source = noise_source
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._lock = threading.Lock()
        # One state per M bucket; `state` is the live bucket's. It starts
        # at the smallest bucket; the first pick moves it to the width the
        # caller's EndpointBatch arrives with.
        self._states: dict[int, SchedState] = {}
        self.state = self._bucket_state(C.M_BUCKETS[0])
        # Warm cache: (n_bucket, m, chunk_lanes) keys whose cycle is ready.
        self._warm_buckets: set[tuple[int, int, int]] = set()
        self._warm_lock = threading.Lock()
        # Waves that had to warm their own key first (each one a wave
        # stalled behind a capture, the stall warm_lattice_async exists to
        # remove). Reads are racy but monotonic, which is all its readers
        # need.
        self.warm_inline_compiles = 0
        # A background warm's failure, raised to the next wave of its key.
        self._warm_failures: dict[tuple[int, int, int], Exception] = {}
        # CUDA: the captured cycle of each warm key, and the stream that
        # captures run on.
        self._graphs: dict[tuple[int, int, int], CycleGraph] = {}
        self._capture_stream: Optional[torch.cuda.Stream] = None
        # CUDA: the KV-event fold captured per (M bucket, lane bucket), and
        # the stream those captures run on (the cycle's warm threads
        # capture on theirs meanwhile).
        self._fold_graphs: dict[tuple[int, int], FoldGraph] = {}
        self._fold_stream: Optional[torch.cuda.Stream] = None
        # CUDA: the stream the last wave was queued on (pick_async's
        # current stream). A digest export or install from another thread
        # queues its copies there, behind the waves and ahead of the next.
        self._wave_stream: Optional[torch.cuda.Stream] = None
        # CUDA: complete(), apply_prefix_events() and
        # clear_prefix_endpoint() calls not yet applied to the state, in
        # call order, as host arrays (see complete()), their lanes, and the
        # thread that applies them past _QUEUE_MAX_LANES. _queue_lock
        # guards only these and the KV-event journal.
        self._queued: list[tuple] = []
        self._queued_lanes = 0
        self._drainer: Optional[threading.Thread] = None
        self._drain_failure: Optional[Exception] = None
        self._queue_lock = threading.Lock()
        # KV-event batches, journaled at call time and replayed over a
        # digest install (commit_install): (monotonic time, slot, stored,
        # removed).
        self._kv_journal: collections.deque = collections.deque(
            maxlen=self._KV_JOURNAL_MAX)
        if self.device.type == "cuda":
            self._prepare_kernels()
            self._capture_stream = torch.cuda.Stream(self.device)
            self._fold_stream = torch.cuda.Stream(self.device)

    def _prepare_kernels(self) -> None:
        """Build and load the kernels this profile launches and check the
        Sinkhorn kernel's layout at every wave bucket, so that a kernel
        that cannot run here fails construction (KernelUnavailable) rather
        than a wave."""
        cfg = self.cfg
        # Under a mesh the grouped solve runs instead of the Sinkhorn
        # kernel, as in the reference (its use_pallas and mesh is None).
        sinkhorn = (cfg.picker == "sinkhorn" and cfg.use_pallas_sinkhorn
                    and self.mesh is None)
        topk = cfg.picker == "topk" and cfg.use_pallas_topk
        if not (sinkhorn or topk):
            return
        from gie_tpu_torch.ops import build, fused_sinkhorn

        build.library()
        if sinkhorn:
            for n in C.N_BUCKETS:
                for m in C.M_BUCKETS:
                    fused_sinkhorn.layout(self.device, n, m)

    # Width-policy hooks: the places the facade assumes "endpoint width =
    # dense M bucket", kept apart so fleet.FleetPicker (whose widths run
    # past the buckets, with a cell-grain prefix table there) overrides
    # policy, not plumbing.

    def _m_ok(self, m: int) -> bool:
        """Whether a wave may arrive at endpoint width m."""
        return m in C.M_BUCKETS

    def _width_for(self, count: int) -> int:
        """The smallest width covering `count` slots (a KV event's grow)."""
        return m_bucket_for(count)

    def _init_state(self, m: int) -> SchedState:
        """A fresh state of width m (its shards under a mesh)."""
        if self.mesh is not None:
            from gie_tpu_torch.parallel.mesh import ShardedState

            return ShardedState.init(self.mesh, m)
        return SchedState.init(m=m, device=self.device)

    def _resize_into(self, src: SchedState, dst: SchedState) -> SchedState:
        """Carry `src` into `dst`'s own tensors (another width or not).
        Under a mesh, through whole states: a bucket change or an install
        is rare beside the waves."""
        if self.mesh is None:
            return resize_into(src, dst)
        if not isinstance(src, SchedState):
            src = src.gather()
        whole = SchedState.init(int(src.prefix.keys.shape[0]), dst.m,
                                device=self.device)
        return dst.scatter_(resize_into(src, whole))

    def _whole_state(self) -> SchedState:
        """The live state as one SchedState: itself, or its shards
        gathered (fresh tensors) under a mesh. Caller holds _lock."""
        return self.state if self.mesh is None else self.state.gather()

    def _load_of(self, state) -> torch.Tensor:
        """A fresh copy of `state`'s whole assumed-load vector."""
        if self.mesh is None:
            return state.assumed_load.clone()
        return state.load()

    def _state_shapes_ok(self, state: SchedState) -> bool:
        """Whether an installed state has a layout this scheduler runs."""
        return check_state_shapes(state)

    def _graph_schema(self) -> tuple[str, ...]:
        """The Weights fields a captured cycle reads from its static
        weight buffer, in order."""
        return feature_schema(self.cfg,
                              has_predictor=self.predictor_fn is not None)

    def _run_cycle(self, state, reqs, eps, gumbel, wvec=None):
        """One cycle over `state`, in place -> (result, state); `wvec` is
        the static weight buffer of _graph_schema() in a captured cycle.
        Under a mesh the wave's whole batches are cut into their shards
        and the row shards' results gathered, all on the device (inside
        the capture on CUDA)."""
        if self.mesh is None:
            return scheduling_cycle(state, reqs, eps, self.weights, gumbel,
                                    cfg=self.cfg, wvec=wvec,
                                    predictor_fn=self.predictor_fn,
                                    predictor_params=self.predictor_params)
        from gie_tpu_torch.parallel import mesh as pm

        rows, state = scheduling_cycle(
            state, pm.shard_requests(self.mesh, reqs),
            pm.shard_endpoints(self.mesh, eps), self.weights,
            pm.shard_noise(self.mesh, gumbel), cfg=self.cfg, wvec=wvec,
            predictor_fn=self.predictor_fn,
            predictor_params=self.predictor_params, mesh=self.mesh)
        return pm.unshard_result(rows, self.device), state

    def _bucket_state(self, m: int) -> SchedState:
        """Bucket m's state, allocated on first use. Callers hold _lock
        (or own the scheduler, in __init__)."""
        state = self._states.get(m)
        if state is None:
            state = self._states[m] = self._init_state(m)
        return state

    def _use_bucket(self, m: int) -> SchedState:
        """Make bucket m's state the live one, carrying the current
        bucket's over (_resize_into). Caller holds
        _lock."""
        if self.state.m != m:
            self.state = self._resize_into(self.state, self._bucket_state(m))
        return self.state

    def _noise_shape(self, n: int, m: int) -> Optional[tuple]:
        """The Gumbel noise a wave of (n, m) draws: [n, m] for the sinkhorn
        and random pickers, [2, n, m] for their dual pick, none for top-k."""
        if self.cfg.picker == "topk":
            return None
        return (2, n, m) if self.cfg.pd_disaggregation else (n, m)

    def _noise(self, shape: tuple,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.noise_source is None:
            return gumbel_noise(shape, self._gen, self.device, out=out)
        noise = self.noise_source(shape)
        if not torch.is_tensor(noise):
            noise = torch.from_numpy(np.array(noise, np.float32))
        noise = _to_device(noise.to(dtype=torch.float32), self.device)
        return noise if out is None else out.copy_(noise)

    def _cycle(self, state, reqs, eps, gumbel, wvec) -> PickResult:
        """The cycle a CycleGraph captures: its weights come in `wvec`."""
        return self._run_cycle(state, reqs, eps, gumbel, wvec)[0]

    def _warm(self, reqs: RequestBatch, eps: EndpointBatch) -> None:
        """Make the wave shape of (reqs, eps), already padded to its N
        bucket, ready OUTSIDE the state lock without touching live state.
        On CUDA: capture its cycle over the live state of its M bucket
        (CycleGraph.capture: an eager pass on a throwaway state, then a
        capture that executes nothing); raises ops.GraphCaptureFailed. On
        the CPU: run the cycle once on a throwaway state with zero noise,
        as the reference compiles on one."""
        n, m = int(reqs.valid.shape[0]), int(eps.valid.shape[0])
        key = (n, m, int(reqs.chunk_hashes.shape[1]))
        shape = self._noise_shape(n, m)
        if not self._captured:
            gumbel = (None if shape is None else torch.zeros(
                shape, dtype=torch.float32, device=self.device))
            self._run_cycle(
                self._init_state(m), _batch_to_device(reqs, self.device),
                _batch_to_device(eps, self.device), gumbel)
            return
        with self._lock:
            state = self._bucket_state(m)
        graph = CycleGraph(key, state, self._graph_schema(), shape,
                           self.device)
        graph.capture(self._cycle, self._capture_stream, self.weights)
        self._graphs[key] = graph

    def _ensure_warm(self, key: tuple[int, int, int], wave) -> None:
        """Warm `key` inline unless it is warm: `wave()` -> the (reqs, eps)
        to warm it with. Raises a background warm's failure of this key."""
        if key in self._warm_buckets:
            return
        with self._warm_lock:
            failed = self._warm_failures.pop(key, None)
            if failed is not None:
                raise failed
            if key in self._warm_buckets:
                return
            # Inline stall: this wave waits for its own warm. The lattice
            # warmer exists to make this path unreachable in steady state.
            self.warm_inline_compiles += 1
            self._warm(*wave())
            self._warm_buckets.add(key)

    def warm_lattice_async(self, m: int, chunk_lanes: int) -> threading.Thread:
        """Warm every still-cold N bucket of the (m, chunk_lanes) lattice on
        a daemon thread, with all-invalid waves (a key is a shape, so a
        masked wave warms what a live one would). Each bucket holds
        `_warm_lock` only for its own warm, so a live cold-shape pick
        interleaves per bucket instead of waiting for the lattice. A warm
        that fails is logged and raised to the next pick_async of its
        key, and the thread stops. Returns the thread."""

        def _run() -> None:
            for n in C.N_BUCKETS:
                if n < self._min_bucket:
                    continue      # a meshed scheduler pads below dp up
                key = (n, m, chunk_lanes)
                if key in self._warm_buckets:
                    continue
                reqs = RequestBatch.empty(n, m, lanes=chunk_lanes)
                eps = EndpointBatch.empty(m)
                with self._warm_lock:
                    if key in self._warm_buckets:
                        continue
                    try:
                        self._warm(reqs, eps)
                    except Exception as e:
                        log.exception("warming wave shape %s failed; the "
                                      "next wave of that shape raises it",
                                      key)
                        self._warm_failures[key] = e
                        return
                    self._warm_buckets.add(key)

        t = threading.Thread(
            target=_run, name=f"warm-lattice-m{m}-c{chunk_lanes}",
            daemon=True)
        t.start()
        return t

    def pick(self, reqs: RequestBatch, eps: EndpointBatch) -> PickResult:
        """Schedule a micro-batch; host-side PickResult rows for the
        original (pre-padding) batch."""
        return self.pick_async(reqs, eps).materialize()

    def pick_async(
        self,
        reqs: RequestBatch,
        eps: EndpointBatch,
        *,
        snapshot_load: bool = False,
    ) -> PendingWave:
        """Run one scheduling cycle without waiting for its results.
        `snapshot_load=True` also copies the post-cycle assumed load.

        On CUDA nothing here waits for the device: the wave's inputs go up
        in one copy from pinned memory into its key's static inputs, its
        noise is drawn into the static noise buffer, the captured cycle is
        replayed, and the copies of its results down to pinned memory and
        an event after them, which PendingWave waits on, are queued, all
        on the device's current stream."""
        n = int(reqs.valid.shape[0])
        bucket = bucket_for(max(n, self._min_bucket))
        m = int(eps.valid.shape[0])
        if not self._m_ok(m):
            raise ValueError(
                f"EndpointBatch width {m} is not an M bucket {C.M_BUCKETS} "
                f"(or a valid fleet width for this scheduler)")
        if int(reqs.subset_mask.shape[1]) != m:
            raise ValueError(
                f"subset_mask width {reqs.subset_mask.shape[1]} != "
                f"endpoint width {m}")
        lanes = int(reqs.chunk_hashes.shape[1])
        key = (bucket, m, lanes)
        if not self._captured:
            reqs = pad_requests(_batch_to_device(reqs, self.device), bucket)
            eps = _batch_to_device(eps, self.device)
            self._ensure_warm(key, lambda: (reqs, eps))
            with self._lock:
                state = self._use_bucket(m)
                shape = self._noise_shape(bucket, m)
                gumbel = None if shape is None else self._noise(shape)
                result, _ = self._run_cycle(state, reqs, eps, gumbel)
                snap = self._load_of(state) if snapshot_load else None
                if self.device.type != "cuda":
                    return PendingWave(result=result, n=n, load_snapshot=snap)
                # A mesh over several cards: eager, its results copied down
                # as a captured wave's are.
                host = PickResult(**{
                    f.name: (None if getattr(result, f.name) is None
                             else _to_host_async(getattr(result, f.name)[:n]))
                    for f in dataclasses.fields(PickResult)})
                snap = None if snap is None else _to_host_async(snap)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            return PendingWave(result=host, n=n, load_snapshot=snap,
                               event=event)
        self._ensure_warm(key, lambda: (
            RequestBatch.empty(bucket, m, lanes=lanes), EndpointBatch.empty(m)))
        graph = self._graphs[key]
        staged = graph.pack(reqs, eps, self.weights)
        with self._lock:
            self._apply_queued()
            state = self._use_bucket(m)
            graph.upload(*staged)
            if graph.gumbel is not None:
                self._noise(tuple(graph.gumbel.shape), out=graph.gumbel)
            result = graph.replay()
            # Queued behind this replay and ahead of the next one, which
            # overwrites the static outputs and updates the state again:
            # the copies are this wave's, and the event follows them and
            # nothing of a later wave.
            snap = (_to_host_async(self._load_of(state)) if snapshot_load
                    else None)
            host = PickResult(**{
                f.name: (None if getattr(result, f.name) is None
                         else _to_host_async(getattr(result, f.name)[:n]))
                for f in dataclasses.fields(PickResult)})
            event = torch.cuda.Event()
            self._wave_stream = torch.cuda.current_stream(self.device)
            event.record(self._wave_stream)
        return PendingWave(result=host, n=n, load_snapshot=snap, event=event)

    def complete(self, endpoint_slots, costs) -> None:
        """Terminated-request feedback: release each request's charge.

        On CUDA the call only queues host arrays; the next section that
        reads or writes the state under the lock (the next wave first of
        all) applies every queued call in order, as this call would have,
        before anything else. The callers are the server's stream handler
        threads, one call a stream: applied here, each would make its own
        pinned staging copies, uploads and kernel launches and free them
        again, hundreds of threads at once against the dispatcher's
        waves."""
        slots = np.array(endpoint_slots, np.int64)
        costs = np.array(costs, np.float32)
        if self._captured:
            self._enqueue(("complete", slots, costs))
            return
        with self._lock:
            slots_t = _to_device(torch.from_numpy(slots), self.device)
            costs_t = _to_device(torch.from_numpy(costs), self.device)
            if self.mesh is not None:
                self.state.complete(slots_t, costs_t)
            else:
                _complete_update(self.state, slots_t, costs_t)

    # The queue's bound in lanes (a call counts one, plus its hashes or
    # released slots). Past it a thread of its own applies the queue under
    # _lock: with no wave to apply it, a stream of KV events would grow it
    # without end and the next locked access would fold all of it at once.
    _QUEUE_MAX_LANES = 16384

    def _enqueue(self, call: tuple, journal: Optional[tuple] = None) -> None:
        """Queue one state call for the next locked section (_apply_queued):
        ("complete", slots, costs), ("events", slot, stored, removed) or
        ("clear", slot); `journal`, a KV-event journal entry, is written
        with it. The call that takes the queue past _QUEUE_MAX_LANES starts
        the drainer; the caller's thread makes no CUDA call."""
        lanes = 1 + (len(call[1]) if call[0] == "complete" else
                     len(call[2]) + len(call[3]) if call[0] == "events"
                     else 0)
        drainer = None
        with self._queue_lock:
            self._queued.append(call)
            self._queued_lanes += lanes
            if journal is not None:
                self._kv_journal.append(journal)
            if (self._queued_lanes > self._QUEUE_MAX_LANES
                    and self._drainer is None):
                drainer = self._drainer = threading.Thread(
                    target=self._drain, name="sched-queue-drain",
                    daemon=True)
        if drainer is not None:
            drainer.start()

    def _drain(self) -> None:
        """The drainer: apply the queue under _lock until it is back within
        its bound. Its failure is raised by the next locked access."""
        try:
            while True:
                with self._lock:
                    self._apply_queued()
                with self._queue_lock:
                    if self._queued_lanes <= self._QUEUE_MAX_LANES:
                        self._drainer = None
                        return
        except Exception as e:
            log.exception("applying the scheduler's queued calls failed")
            with self._queue_lock:
                self._drain_failure, self._drainer = e, None

    def _apply_queued(self) -> None:
        """Apply the queued calls to the state in call order. Caller holds
        _lock. Consecutive complete() calls apply together with a few
        launches a layer (_apply_releases), consecutive KV-event calls
        fold together (_fold_events); prefix clears apply where they were
        called."""
        with self._queue_lock:
            failed, self._drain_failure = self._drain_failure, None
            if failed is None:
                queued, self._queued = self._queued, []
                self._queued_lanes = 0
        if failed is not None:
            raise failed
        for kind, run in itertools.groupby(queued, key=lambda c: c[0]):
            calls = [call[1:] for call in run]
            if kind == "complete":
                self._apply_releases(calls)
            elif kind == "events":
                self._fold_events(calls)
            else:
                for (slot,) in calls:
                    self._clear_prefix(slot)

    def _apply_releases(self, queued: list) -> None:
        """Apply complete() calls [(slots, costs)] to the assumed load in
        order, with a few launches a layer. Each call's charges are
        summed per slot (as _complete_update's index_add sums them); a
        slot's n-th release in the run goes into layer n, so a layer names
        each slot once and its releases apply elementwise, max(load - sum,
        0) per slot in call order, bit-equal to the calls one by one.
        Caller holds _lock."""
        m = self.state.m
        layers: list[tuple[list, list]] = []
        depth: dict[int, int] = {}
        for slots, costs in queued:
            ok = (slots >= 0) & (slots < m)   # beyond the bucket: dropped
            idx, inv = np.unique(slots[ok], return_inverse=True)
            sums = np.zeros(len(idx), np.float32)
            np.add.at(sums, inv, costs[ok])
            for slot, amount in zip(idx.tolist(), sums):
                d = depth.get(slot, 0)
                depth[slot] = d + 1
                if d == len(layers):
                    layers.append(([], []))
                layers[d][0].append(slot)
                layers[d][1].append(amount)
        if not layers:
            return
        if self.mesh is not None:
            for layer_slots, layer_sums in layers:
                self.state.release_layer(
                    np.array(layer_slots, np.int64),
                    np.array(layer_sums, np.float32),
                    lambda a, dev: _to_device(torch.from_numpy(a), dev))
            return
        slots = _to_device(torch.from_numpy(np.array(
            [s for layer in layers for s in layer[0]], np.int64)), self.device)
        sums = _to_device(torch.from_numpy(np.array(
            [v for layer in layers for v in layer[1]], np.float32)),
            self.device)
        load = self.state.assumed_load
        at = 0
        for layer in layers:
            k = len(layer[0])
            sl = slots[at:at + k]
            load[sl] = (load[sl] - sums[at:at + k]).clamp_(min=0.0)
            at += k

    # -- KV-cache events (sched/kvevents.py) -------------------------------

    # An event batch folds in parts of at most the largest of these sizes,
    # each padded to one of them: a later part's evictions are decided
    # against the table the earlier part left, as in the reference.
    _EVENT_BUCKETS = (64, 512, 4096)
    # Locally observed KV events are journaled and REPLAYED over a digest
    # install (commit_install), so an event that arrived after the leader
    # exported the digest is not overwritten by it. Entries older than the
    # TTL are presumed reflected in the digest stream; replay is
    # idempotent (the same evict-then-OR fold).
    _KV_JOURNAL_MAX = 256
    _KV_REPLAY_TTL_S = 10.0

    def _fold_events(self, calls: list) -> None:
        """Fold apply_prefix_events calls [(slot, stored, removed)] (uint32
        host arrays) into the live state's prefix table in call order, as
        the reference folds them one by one: each call's stored, then its
        removed hashes, in parts of at most _EVENT_BUCKETS[-1], ages at the
        state's tick; a slot beyond the live bucket grows the state first.
        Consecutive parts whose table rows are disjoint fold together
        (prefix.ingest_lanes): the same result with one fold for many
        small batches, every lane in one upload. Caller holds _lock."""
        top = self._EVENT_BUCKETS[-1]
        mask = int(self.state.prefix.keys.shape[0]) - 1
        hashes, slots, kinds = [], [], []     # one entry per part
        grows: list = []                      # (before part k, width)
        width = self.state.m
        for slot, stored, removed in calls:
            if slot >= width:
                width = self._width_for(slot + 1)
                grows.append((len(hashes), width))
            target, stored, removed = self._event_lanes(
                slot, stored, removed, width)
            for batch, remove in ((stored, False), (removed, True)):
                for start in range(0, len(batch), top):
                    part = batch[start:start + top].astype(np.int64)
                    part = part[part != 0]
                    if len(part):
                        hashes.append(part)
                        slots.append(target)
                        kinds.append(remove)
        # Groups: runs of parts whose rows no earlier part of the run
        # touched, of at most `top` lanes, split where the state grows.
        starts, last_touch = [], np.full(mask + 1, -1, np.int64)
        cut = {k for k, _ in grows}
        first = count = 0
        for k, part in enumerate(hashes):
            rows = part & mask
            if (not starts or k in cut or count + len(part) > top
                    or last_touch[rows].max() >= first):
                starts.append(k)
                first, count = k, 0
            last_touch[rows] = k
            count += len(part)
        bounds = starts + [len(hashes)]
        lens = np.array([len(h) for h in hashes], np.int64)
        sizes = [next(b for b in self._EVENT_BUCKETS
                      if int(lens[a:z].sum()) <= b)
                 for a, z in zip(bounds[:-1], bounds[1:])]
        lanes = None
        if hashes:
            # One upload: rows (hash, endpoint, removed), each group's
            # lanes padded with zeros to its bucket.
            host = np.zeros((3, sum(sizes)), np.int64)
            offsets = np.concatenate([[0], np.cumsum(sizes)])
            at = np.concatenate([
                offsets[g] + np.arange(int(lens[a:z].sum()))
                for g, (a, z) in enumerate(zip(bounds[:-1], bounds[1:]))])
            host[0, at] = np.concatenate(hashes)
            host[1, at] = np.repeat(slots, lens)
            host[2, at] = np.repeat(kinds, lens)
            lanes = _to_device(torch.from_numpy(host), self.device)
        pending = list(grows)
        for g, (a, size) in enumerate(zip(bounds[:-1], sizes)):
            while pending and pending[0][0] <= a:
                self._use_bucket(pending.pop(0)[1])
            group = lanes[:, offsets[g]:offsets[g] + size]
            if self._captured:
                self._fold_graph(size).replay(group)
            elif self.mesh is not None:
                self.state.ingest_lanes(group[0], group[1], group[2] != 0)
            else:
                prefix.ingest_lanes(self.state.prefix, group[0], group[1],
                                    group[2] != 0, self.state.tick)
        for _, m in pending:
            self._use_bucket(m)

    def _event_lanes(self, slot: int, stored: np.ndarray,
                     removed: np.ndarray, width: int):
        """-> (table column, stored, removed) of one KV-event call folded
        into a state of `width`: the endpoint's own column here."""
        return slot, stored, removed

    def _fold_graph(self, size: int) -> FoldGraph:
        """The live bucket's fold graph of `size` lanes, captured on first
        use. Caller holds _lock."""
        key = (self.state.m, size)
        graph = self._fold_graphs.get(key)
        if graph is None:
            graph = FoldGraph(self.state, size, self.device)
            graph.capture(self._fold_stream)
            self._fold_graphs[key] = graph
        return graph

    def _clear_prefix(self, slot: int) -> None:
        """Clear one endpoint's presence bits. Caller holds _lock."""
        if slot >= self.state.m:  # beyond the live bucket: nothing recorded
            return
        if self.mesh is not None:
            self.state.clear_endpoint(slot)
        else:
            prefix.clear_endpoint(self.state.prefix, slot)

    def apply_prefix_events(self, slot: int, stored: np.ndarray,
                            removed: np.ndarray) -> None:
        """KV-cache event ingestion: fold a model server's reported stored
        and evicted chunk-chain hashes into the prefix index, and journal
        the batch so a later digest install replays it. On CUDA the fold
        is queued as complete() queues its releases (the callers are the
        event listener's handler threads)."""
        stored = np.array(stored, np.uint32, copy=True)
        removed = np.array(removed, np.uint32, copy=True)
        entry = (time.monotonic(), slot, stored, removed)
        if self._captured:
            self._enqueue(("events", slot, stored, removed), journal=entry)
            return
        with self._lock:
            self._fold_events([(slot, stored, removed)])
            with self._queue_lock:
                self._kv_journal.append(entry)

    def prefix_hot_keys(self, max_keys: int = 2048) -> np.ndarray:
        """The first `max_keys` live prefix-table keys in table order, as
        uint32 (the federation digest's export). The lock covers only a
        device copy."""
        with self._lock:
            self._apply_queued()
            keys = self.state.prefix.keys.clone()
        host = keys.cpu().numpy().reshape(-1)
        host = host[host != 0]
        return host[: max(int(max_keys), 0)].astype(np.uint32)

    def evict_endpoint(self, slot: int) -> None:
        """Forget an endpoint slot (pod deleted or slot reassigned): its
        prefix bits, assumed load and Sinkhorn dual, and its journaled KV
        events (a replay would resurrect the dead pod's bits on whatever
        reuses the slot)."""
        with self._lock:
            self._apply_queued()
            with self._queue_lock:
                if any(e[1] == slot for e in self._kv_journal):
                    self._kv_journal = collections.deque(
                        (e for e in self._kv_journal if e[1] != slot),
                        maxlen=self._KV_JOURNAL_MAX)
            if slot >= self.state.m:
                return  # beyond the live bucket: nothing was ever recorded
            if self.mesh is not None:
                self.state.evict(slot)
                return
            self._clear_prefix(slot)
            self.state.assumed_load[slot] = 0.0
            self.state.ot_v[slot] = 1.0

    def clear_prefix_endpoint(self, slot: int) -> None:
        """Forget an endpoint's cached chunks, keeping its assumed load
        (live-pod cache reset). Queued on CUDA, as apply_prefix_events."""
        if self._captured:
            self._enqueue(("clear", slot))
            return
        with self._lock:
            self._clear_prefix(slot)

    def set_predictor_params(self, params) -> None:
        """Install retrained predictor params (the online-training
        handoff): copied under the lock into the static buffers the
        captured cycles read, on the stream the waves run on, so the copy
        lands between two waves and the next replay reads the new column.
        Nothing is recaptured or rebound. Raises ValueError when `params`
        do not match the buffers' names and shapes."""
        with self._lock, self._state_stream():
            _copy_params_into(self.predictor_params, params)

    def gate_latency_column(self, confidence: float) -> float:
        """Phase the latency column into the blend as the predictor earns
        trust: live weight = configured weight x confidence in [0, 1]
        (OnlineTrainer.confidence). The weights travel with every wave's
        inputs (CycleGraph.pack), so this never recaptures. Returns the
        live weight."""
        w = self.base_latency_weight * float(np.clip(confidence, 0.0, 1.0))
        with self._lock:
            self.weights = self.weights.replace(
                latency=float(np.float32(w)))
        return w

    def explain(self, reqs: RequestBatch,
                eps: EndpointBatch) -> dict[str, np.ndarray]:
        """Debug surface: each scorer column, the blended total, the
        eligibility mask and the shed flags of a batch, as numpy rows of
        the original batch, WITHOUT touching scheduler state. Runs the
        same build_stages as the cycle (eagerly, on a copy of the state
        taken under the lock and resized when the batch's M bucket is not
        the live one), so the decomposition cannot diverge from the pick."""
        n, m = int(reqs.valid.shape[0]), int(eps.valid.shape[0])
        reqs = pad_requests(_batch_to_device(reqs, self.device), bucket_for(n))
        eps = _batch_to_device(eps, self.device)
        with self._lock:
            self._apply_queued()
            whole = self._whole_state()
            state = (_copy_state(whole) if whole.m == m
                     else resize_into(whole, SchedState.init(
                         int(whole.prefix.keys.shape[0]), m,
                         device=self.device)))
            weights = self.weights
            params = _clone_params(self.predictor_params)
        mask, shed, named, stacked, wvec, total = build_stages(
            state, reqs, eps, weights, cfg=self.cfg,
            predictor_fn=self.predictor_fn, predictor_params=params)
        if total is None:        # the fused top-k path blends in its kernel
            total = blend(wvec, stacked)
        out = {name: col[:n].cpu().numpy() for name, col in named.items()}
        out["total"] = total[:n].cpu().numpy()
        out["mask"] = mask[:n].cpu().numpy()
        out["shed"] = shed[:n].cpu().numpy()
        return out

    def debug_report(self) -> dict:
        """Scheduler zpage payload: blend weights, picker identity, state
        width and tick, device, and the warm cache."""
        state = self.state
        return {
            "picker": self.cfg.picker,
            "pd_disaggregation": self.cfg.pd_disaggregation,
            "m_bucket": state.m,
            "tick": int(state.tick),
            "weights": {
                f.name: round(float(getattr(self.weights, f.name)), 5)
                for f in dataclasses.fields(Weights)
            },
            "latency_weight_ceiling": self.base_latency_weight,
            "device": str(self.device),
            "warm_buckets": sorted(self._warm_buckets),
            "warm_inline_compiles": self.warm_inline_compiles,
            "mesh": None if self.mesh is None else dict(self.mesh.shape),
            # Which Sinkhorn solve the waves run: a mesh runs the grouped
            # one even where the profile asks for the kernel.
            "sinkhorn_solve": (
                None if self.cfg.picker != "sinkhorn" else
                "kernel" if self.cfg.use_pallas_sinkhorn and self.mesh is None
                else "grouped"),
        }

    def snapshot_assumed_load(self) -> np.ndarray:
        """Host copy of the assumed-load vector (the lock covers only a
        device copy; the transfer runs outside it)."""
        with self._lock:
            self._apply_queued()
            load = self._load_of(self.state)
        return load.cpu().numpy()

    # -- warm-restart persistence -------------------------------------------
    # The reference accepts prefix-index loss on restart; a checkpoint lets
    # a restarted EPP keep its cache affinity. The reference writes it with
    # orbax, a JAX library; the port, which imports no JAX, writes the
    # export_state arrays as one .npz (the two formats differ; a reference
    # checkpoint crosses over through export_state / install_state).

    _CHECKPOINT = "sched_state.npz"

    def save_state(self, directory: str) -> None:
        """Write the live state to `directory`: export_state's copy, taken
        under the lock after the queued completions and event folds are
        applied (so the file holds one consistent state) and read to host
        outside it; written to a temporary name and renamed over the
        checkpoint."""
        arrays = self.export_state()
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, self._CHECKPOINT)
        with open(path + ".tmp", "wb") as f:
            np.savez(f, **arrays)
        os.replace(path + ".tmp", path)

    def restore_state(self, directory: str) -> bool:
        """Install the checkpoint in `directory`; False (the state left as
        it was) when it is missing, unreadable or inconsistent. The saved
        state keeps the M bucket it was saved at, which becomes the live
        one (the next pick migrates it as usual). A checkpoint written
        before the Sinkhorn duals existed restores with them at ones, as
        the reference's legacy restore fills them. The cross-field shape
        check (check_state_shapes) refuses a mixed layout, and a prefix
        table of another row count than this scheduler's is refused too:
        its states are allocated once."""
        path = os.path.join(directory, self._CHECKPOINT)
        try:
            with np.load(path, allow_pickle=False) as saved:
                arrays = {k: saved[k] for k in saved.files}
        except (OSError, ValueError, EOFError, zipfile.BadZipFile):
            return False
        if "ot_v" not in arrays and "assumed_load" in arrays:
            arrays["ot_v"] = np.ones(np.shape(arrays["assumed_load"]),
                                     np.float32)
        restored = self.prepare_install(arrays)
        if restored is None:
            return False
        with self._lock:
            self._apply_queued()           # then overwritten
            self.state = self._resize_into(restored,
                                           self._bucket_state(restored.m))
        return True

    # -- replication digest surface ----------------------------------------

    def _state_stream(self):
        """A context that makes the waves' stream current (see
        _wave_stream); a no-op on the CPU and before the first wave."""
        stream = self._wave_stream
        if stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(stream)

    def export_state(self) -> dict:
        """Flat host-array dict of the full state, array-compatible with
        gie_tpu's Scheduler.export_state (uint32 table columns and
        counters).

        The lock covers only the queued calls' apply and a device copy of
        the state; the device-to-host transfer of that copy runs outside
        it, so a leader's periodic digest refresh never holds a wave back
        for a transfer. On CUDA both are queued on the waves' stream
        (behind every wave already queued), and the transfer waits on
        that stream alone: never a device-wide synchronize, so a capture
        on a warm thread is never broken."""
        from gie_tpu_torch.convert import state_to_numpy

        with self._state_stream():
            with self._lock:
                self._apply_queued()
                snap = (_copy_state(self.state) if self.mesh is None
                        else self.state.gather())
            return state_to_numpy(snap)

    def prepare_install(self, arrays: dict) -> Optional[SchedState]:
        """Validate digest arrays into a SchedState on this scheduler's
        device without touching live state; None on any malformation,
        including a prefix table of another row count than this
        scheduler's (its states are allocated once, at that count)."""
        from gie_tpu_torch.convert import state_from_numpy

        try:
            with self._state_stream():
                restored = state_from_numpy(arrays, device=self.device)
        except (KeyError, TypeError, ValueError):
            return None
        if not self._state_shapes_ok(restored):
            return None
        if restored.prefix.keys.shape != self.state.prefix.keys.shape:
            return None
        return restored

    def commit_install(self, state: SchedState) -> None:
        """Install a prepare_install-validated state: copied into the
        tensors of its M bucket, which becomes the live one (on CUDA,
        copies queued on the waves' stream; a bucket's tensors are never
        reallocated, since a captured cycle holds their addresses)."""
        with self._lock, self._state_stream():
            self._apply_queued()           # then overwritten, as before
            self.state = self._resize_into(state, self._bucket_state(state.m))
            # Journaled KV events newer than the TTL fold into the
            # installed state: a follower's locally observed prefix truth
            # survives a digest exported before it.
            now = time.monotonic()
            with self._queue_lock:
                fresh = [e for e in self._kv_journal
                         if now - e[0] <= self._KV_REPLAY_TTL_S]
                self._kv_journal = collections.deque(
                    fresh, maxlen=self._KV_JOURNAL_MAX)
            self._fold_events([e[1:] for e in fresh])

    def install_state(self, arrays: dict) -> bool:
        """Validated inverse of export_state; False keeps the prior state."""
        prepared = self.prepare_install(arrays)
        if prepared is None:
            return False
        self.commit_install(prepared)
        return True


def _static_params(params, device: torch.device):
    """The scheduler's own copy of predictor params on `device`: a dict of
    fresh tensors (arrays and tensors on any device accepted), or None."""
    if params is None:
        return None
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device=device, copy=True)
            for k, v in params.items()}


def _clone_params(params):
    return None if params is None else {k: v.clone()
                                        for k, v in params.items()}


def _copy_params_into(dst, src) -> None:
    """Copy predictor params `src` into the static buffers `dst`, in
    place, on the current stream. A source tensor on another device's or
    stream's memory is marked used by this stream, so its owner freeing it
    cannot recycle it under the queued copy."""
    if dst is None or src is None:
        if dst is None and src is None:
            return
        raise ValueError("predictor params must match the scheduler's: "
                         "it was built with "
                         f"{'no' if dst is None else 'a'} params tree")
    if set(dst) != set(src):
        raise ValueError(f"predictor params {sorted(src)} do not match the "
                         f"scheduler's {sorted(dst)}")
    for k, buf in dst.items():
        v = src[k]
        v = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        if tuple(v.shape) != tuple(buf.shape):
            raise ValueError(f"predictor param {k}: shape {tuple(v.shape)} "
                             f"!= {tuple(buf.shape)}")
        if buf.device.type == "cuda" and v.device.type == "cpu":
            v = v.pin_memory()
        buf.copy_(v, non_blocking=True)
        if v.device.type == "cuda":
            v.record_stream(torch.cuda.current_stream(v.device))


def _copy_state(state: SchedState) -> SchedState:
    px = state.prefix
    return SchedState(
        prefix=px.replace(keys=px.keys.clone(), present=px.present.clone(),
                          ages=px.ages.clone()),
        assumed_load=state.assumed_load.clone(),
        rr=state.rr.clone(), tick=state.tick.clone(),
        ot_v=state.ot_v.clone())
