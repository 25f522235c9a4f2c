"""Profile composition: the full scheduling cycle (port of
gie_tpu/sched/profile.py, single device).

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
"""

from __future__ import annotations

import collections
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

# Later slices of the port (ROADMAP.md, Queue 1) that bring what this one
# rejects at construction.
_LATER = {
    "predictor_fn": "the latency-predictor slice",
    "mesh": "the multi-device slice",
    "federation": "the federation slice",
    "kube": "the kube slice",
    "replication": "the replication slice",
    "autoscale": "the autoscale slice",
    "fleet": "the fleet slice",
}


def _not_ported(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to gie_tpu_torch yet; it comes with "
        f"{_LATER[key]} (ROADMAP.md, Queue 1)")


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


def feature_schema(cfg: ProfileConfig) -> tuple[str, ...]:
    """Ordered names of the scorer columns build_stages stacks."""
    cols = ["queue", "kv_cache", "assumed_load"]
    if cfg.enable_prefix:
        cols.append("prefix")
    if cfg.enable_session:
        cols.append("session")
    if cfg.enable_lora:
        cols.append("lora")
    return tuple(cols)


@functools.lru_cache(maxsize=64)
def _weight_vector(weights: Weights, names: tuple,
                   device: torch.device) -> torch.Tensor:
    """The blend weights of `names` as f32[S] on `device`, made once per
    (weights, columns, device): a host-to-device copy on every wave would
    make the host wait for the device's queue. Callers never write it."""
    return torch.tensor([getattr(weights, k) for k in names],
                        dtype=torch.float32, device=device)


def build_stages(
    state: SchedState,
    reqs: RequestBatch,
    eps: EndpointBatch,
    weights: Weights,
    *,
    cfg: ProfileConfig,
    wvec: Optional[torch.Tensor] = None,
):
    """Filter + score stages -> (mask, shed, named column dict,
    stacked [S,N,M], wvec [S], blended total [N,M]). `total` is None on
    the fused top-k path, whose kernel blends the columns itself (the
    reference computes it there too, and XLA drops it as dead code),
    unless the profile is disaggregated: the decode pick de-blends it.
    `wvec`, when given, is the blend weights of feature_schema(cfg) as a
    tensor the caller fills (a captured cycle's static buffer); otherwise
    they come from `weights`.

    Saturation is a soft filter: unsaturated candidates are preferred;
    when all are saturated SHEDDABLE traffic is shed (429) and STANDARD
    falls back to the full candidate set (CRITICAL bypasses it)."""
    mask = filters.base_mask(reqs, eps)
    membership = (filters.lora_membership(reqs, eps) if cfg.enable_lora
                  else None)
    if cfg.enable_lora:
        mask = mask & filters.lora_capacity_mask(reqs, eps, membership)
    no_shed = torch.zeros(reqs.valid.shape, dtype=torch.bool,
                          device=mask.device)
    if cfg.enable_saturation:
        sat_mask = mask & filters.saturation_mask(
            reqs, eps, queue_limit=cfg.queue_limit, kv_limit=cfg.kv_limit)
        had_candidates = mask.any(dim=-1)
        any_unsaturated = sat_mask.any(dim=-1)
        sheddable = reqs.criticality == int(C.Criticality.SHEDDABLE)
        if cfg.shed_sheddable:
            shed = sheddable & had_candidates & ~any_unsaturated
            keep_hard = sheddable | any_unsaturated
        else:
            shed = no_shed
            keep_hard = any_unsaturated
        mask = torch.where(keep_hard[:, None], sat_mask, mask)
    else:
        shed = no_shed

    shape = mask.shape
    named: dict[str, torch.Tensor] = {
        "queue": scorers.queue_score(
            eps, queue_norm=cfg.queue_norm)[None, :].expand(shape),
        "kv_cache": scorers.kv_cache_score(eps)[None, :].expand(shape),
        "assumed_load": scorers.assumed_load_score(
            state.assumed_load, load_norm=cfg.load_norm)[None, :].expand(shape),
    }
    if cfg.enable_prefix:
        named["prefix"] = prefix.match_scores(
            state.prefix, reqs, state.tick, max_age=cfg.prefix_max_age)
    if cfg.enable_session:
        named["session"] = scorers.session_affinity_score(
            reqs, eps, key_chunks=cfg.session_key_chunks)
    if cfg.enable_lora:
        named["lora"] = scorers.lora_affinity_score(reqs, eps, membership)

    stacked = torch.stack(list(named.values()))               # [S, N, M]
    if wvec is None:
        wvec = _weight_vector(weights, tuple(named), mask.device)
    total = None
    if cfg.scorer == "learned":
        # The gie-learn multiplicative policy; the reference forbids it
        # beside the fused top-k and the dual pick (ProfileConfig).
        from gie_tpu_torch.learn.policy import multiplicative_total

        total = multiplicative_total(stacked, wvec)
    elif cfg.pd_disaggregation or not (cfg.picker == "topk"
                                       and cfg.use_pallas_topk):
        total = blend(wvec, stacked)
    return mask, shed, named, stacked, wvec, total


def blend(wvec: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """The weighted blend of the scorer columns -> f32[N, M]."""
    return torch.einsum("s,snm->nm", wvec, stacked) / torch.clamp(
        wvec.sum(), min=1e-6)


def _pick_stage(
    total: Optional[torch.Tensor],
    stacked: torch.Tensor,
    wvec: torch.Tensor,
    mask: torch.Tensor,
    shed: torch.Tensor,
    reqs: RequestBatch,
    eps: EndpointBatch,
    state: SchedState,
    gumbel: Optional[torch.Tensor],
    cfg: ProfileConfig,
) -> tuple[PickResult, dict]:
    """The configured picker; the aux dict carries the Sinkhorn duals.
    `gumbel` is the wave's standard Gumbel noise, which the random and
    sinkhorn pickers take (the reference hands both the wave's key)."""
    if cfg.picker == "topk" and cfg.use_pallas_topk:
        from gie_tpu_torch.ops.fused_topk import fused_blend_topk

        vals, idxs = fused_blend_topk(stacked, wvec, mask, k=C.FALLBACKS)
        return pickers.finalize_from_topk(
            vals, idxs, mask, shed, reqs.valid), {}
    if cfg.picker == "random":
        if gumbel is None:
            raise ValueError("the random picker needs a Gumbel noise tensor")
        return pickers.weighted_random_picker(
            total, mask, shed, reqs.valid, gumbel,
            temperature=cfg.sample_temperature), {}
    if cfg.picker == "sinkhorn":
        from gie_tpu_torch.sched.sinkhorn import sinkhorn_picker

        if gumbel is None:
            raise ValueError("the sinkhorn picker needs a Gumbel noise tensor")
        res, v_out = sinkhorn_picker(
            total, mask, shed, reqs.valid, eps, gumbel,
            queue_limit=cfg.queue_limit,
            tau=cfg.sinkhorn_tau,
            iters=cfg.sinkhorn_iters,
            rounding_temp=cfg.sinkhorn_rounding_temp,
            use_kernel=cfg.use_pallas_sinkhorn,
            v0=state.ot_v,
        )
        return res, {"ot_v": v_out}
    return pickers.topk_picker(total, mask, shed, reqs.valid, state.rr), {}


def scheduling_cycle(
    state: SchedState,
    reqs: RequestBatch,
    eps: EndpointBatch,
    weights: Weights,
    gumbel: Optional[torch.Tensor],
    *,
    cfg: ProfileConfig,
    wvec: Optional[torch.Tensor] = None,
) -> tuple[PickResult, SchedState]:
    """One full scheduling cycle. Updates `state`'s tensors IN PLACE (the
    role of the reference's donated buffers) and returns (result, state).

    `gumbel` is the standard Gumbel noise f32[N, M] the sinkhorn picker's
    rounding and the random picker's sampling use (the reference draws it
    from its PRNG key inside the cycle), f32[2, N, M] under
    pd_disaggregation (plane 0 for the prefill pick, plane 1 for the
    decode pick: the reference's split of the wave's key); the top-k
    picker ignores it and takes None. `wvec`: see
    build_stages. The cycle makes no call that waits for the device, so
    it can be captured into a CUDA graph (sched/graphs.py).
    """
    mask, shed, named, stacked, wvec, total = build_stages(
        state, reqs, eps, weights, cfg=cfg, wvec=wvec)

    if cfg.pd_disaggregation:
        return _pd_cycle(state, reqs, eps, gumbel, cfg, mask=mask, shed=shed,
                         named=named, stacked=stacked, wvec=wvec, total=total)

    result, pick_aux = _pick_stage(
        total, stacked, wvec, mask, shed, reqs, eps, state, gumbel, cfg)

    m = state.m
    primary = result.indices[:, 0]                  # i32[N], -1 on non-OK
    picked_ok = primary >= 0
    if cfg.record_affinity:
        result = result.replace(
            affinity=_affinity_columns(named, primary, picked_ok))
    cost = request_cost(reqs)
    cost = torch.where(picked_ok, cost, torch.zeros_like(cost))
    slot = torch.where(picked_ok, primary, m - 1).long()
    added = torch.zeros((m,), dtype=torch.float32,
                        device=cost.device).index_add_(0, slot, cost)
    state.assumed_load.mul_(cfg.load_decay).add_(added)

    if cfg.enable_prefix:
        prefix.insert(state.prefix, reqs, primary, state.tick)
    state.rr.add_(1).bitwise_and_(C.U32_MASK)
    state.tick.add_(1).bitwise_and_(C.U32_MASK)
    if "ot_v" in pick_aux:
        state.ot_v.copy_(pick_aux["ot_v"])
    return result, state


# Locality columns that only describe the PREFILL side (the prefix cache
# and session affinity live where prefill runs); the decode blend drops
# them and uses load/queue/kv signals plus the co-location bonus.
_PREFILL_ONLY_COLUMNS = ("prefix", "session")


def _pd_cycle(
    state: SchedState,
    reqs: RequestBatch,
    eps: EndpointBatch,
    gumbel: Optional[torch.Tensor],
    cfg: ProfileConfig,
    *,
    mask: torch.Tensor,
    shed: torch.Tensor,
    named: dict,
    stacked: torch.Tensor,
    wvec: torch.Tensor,
    total: torch.Tensor,
) -> tuple[PickResult, SchedState]:
    """Dual pick for disaggregated serving (the reference's _pd_cycle):
    the prefill endpoint (full blend over PREFILL/BOTH roles), then the
    decode endpoint (locality columns dropped, co-location bonus, over
    DECODE/BOTH roles). `indices` is the decode pick and `prefill` names
    the prefill worker. Updates `state` in place; neither solve writes the
    carried Sinkhorn duals (one vector under two capacity patterns would
    poison both warm starts)."""
    prefill_ok = mask & (eps.role != int(C.Role.DECODE))[None, :]
    decode_ok = mask & (eps.role != int(C.Role.PREFILL))[None, :]
    g_p, g_d = (None, None) if gumbel is None else (gumbel[0], gumbel[1])

    p_res, _ = _pick_stage(total, stacked, wvec, prefill_ok, shed, reqs, eps,
                           state, g_p, cfg)
    p_primary = p_res.indices[:, 0]

    keep = torch.ones_like(wvec)
    for i, k in enumerate(named):
        if k in _PREFILL_ONLY_COLUMNS:
            keep[i].fill_(0.0)            # a device fill: capturable
    d_wvec = wvec * keep
    # Incremental de-blend: (total * sum(w) - the prefill-only columns) /
    # sum(kept w), two column reads instead of re-reducing the stack.
    # Degeneracy guard: when the kept weights are negligible against the
    # total mass (a locality-only tuning) the subtraction leaves float32
    # cancellation residue that a tiny denominator would blow up past the
    # co-location bonus; the decode side then has no signal, so 0.
    wsum = torch.clamp(wvec.sum(), min=1e-6)
    d_wsum = d_wvec.sum()
    dropped = torch.zeros((), dtype=torch.float32, device=wvec.device)
    for i, k in enumerate(named):
        if k in _PREFILL_ONLY_COLUMNS:
            dropped = dropped + wvec[i] * named[k]
    d_total = torch.where(
        d_wsum > 1e-4 * wsum,
        (total * wsum - dropped) / torch.clamp(d_wsum, min=1e-6),
        torch.zeros((), dtype=torch.float32, device=total.device))
    # The same endpoint as the prefill pick needs no KV transfer: a bonus
    # on that lane (only BOTH-role endpoints can win both picks).
    m = d_total.shape[1]
    colocated = (torch.arange(m, dtype=torch.int32, device=total.device)[None, :]
                 == p_primary[:, None])
    d_total = d_total + float(np.float32(cfg.pd_colocation_bonus)) * colocated

    # The fused top-k recomputes the blend from (stacked, wvec) and would
    # drop the co-location bonus: the decode pick never takes it.
    d_cfg = (dataclasses.replace(cfg, use_pallas_topk=False)
             if cfg.use_pallas_topk else cfg)
    d_res, _ = _pick_stage(d_total, stacked, d_wvec, decode_ok, shed, reqs,
                           eps, state, g_d, d_cfg)
    d_primary = d_res.indices[:, 0]

    ok = (p_primary >= 0) & (d_primary >= 0)
    # SHED (from either pick) wins over NO_CAPACITY; OK requires both.
    status = torch.maximum(p_res.status, d_res.status)
    is_ok = status == int(C.Status.OK)
    status = torch.where(~ok & is_ok,
                         torch.full_like(status, int(C.Status.NO_CAPACITY)),
                         status)

    # State update: each side's cost to its own worker, prefill first.
    m_state = state.m
    p_cost_all, d_cost_all = pd_costs(reqs)
    zero = torch.zeros_like(p_cost_all)
    p_cost = torch.where(ok, p_cost_all, zero)
    d_cost = torch.where(ok, d_cost_all, zero)
    p_slot = torch.where(ok, p_primary, m_state - 1).long()
    d_slot = torch.where(ok, d_primary, m_state - 1).long()
    added = torch.zeros((m_state,), dtype=torch.float32, device=zero.device)
    added.index_add_(0, p_slot, p_cost).index_add_(0, d_slot, d_cost)
    state.assumed_load.mul_(cfg.load_decay).add_(added)

    prefill = torch.where(ok, p_primary, torch.full_like(p_primary, -1))
    if cfg.enable_prefix:
        # Only OK requests run: a rejected request must not record its
        # chunks as cached on the prefill worker.
        prefix.insert(state.prefix, reqs, prefill, state.tick)
    state.rr.add_(1).bitwise_and_(C.U32_MASK)
    state.tick.add_(1).bitwise_and_(C.U32_MASK)
    result = PickResult(
        indices=d_res.indices, status=status, scores=d_res.scores,
        prefill=prefill,
        # Affinity is a PREFILL-side property: gathered at the prefill
        # pick, not the decode destination.
        affinity=(_affinity_columns(named, p_primary, ok)
                  if cfg.record_affinity else None))
    return result, state


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


def check_state_shapes(state: SchedState) -> bool:
    """Cross-field shape consistency of a SchedState built from external
    arrays (digest install): the width is an M bucket shared by load and
    duals, the packed presence matrix matches the table's rows and the
    bucket's word width, and the counters are scalars."""
    try:
        m = int(state.assumed_load.shape[0])
    except (TypeError, IndexError):
        return False
    px = state.prefix
    return (
        m in C.M_BUCKETS
        and tuple(state.assumed_load.shape) == (m,)
        and tuple(state.ot_v.shape) == (m,)
        and px.keys.dim() == 1
        and tuple(px.present.shape) == (int(px.keys.shape[0]), m // 32)
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
        mesh=None,
    ):
        if predictor_fn is not None:
            raise _not_ported("a predictor_fn", "predictor_fn")
        if mesh is not None:
            raise _not_ported("a mesh", "mesh")
        self.cfg = cfg
        self.weights = weights if weights is not None else Weights.default()
        self.device = resolve_device(device)
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
        sinkhorn = cfg.picker == "sinkhorn" and cfg.use_pallas_sinkhorn
        topk = cfg.picker == "topk" and cfg.use_pallas_topk
        if not (sinkhorn or topk):
            return
        from gie_tpu_torch.ops import build, fused_sinkhorn

        build.library()
        if sinkhorn:
            for n in C.N_BUCKETS:
                for m in C.M_BUCKETS:
                    fused_sinkhorn.layout(self.device, n, m)

    def _bucket_state(self, m: int) -> SchedState:
        """Bucket m's state, allocated on first use. Callers hold _lock
        (or own the scheduler, in __init__)."""
        state = self._states.get(m)
        if state is None:
            state = self._states[m] = SchedState.init(m=m, device=self.device)
        return state

    def _use_bucket(self, m: int) -> SchedState:
        """Make bucket m's state the live one, carrying the current
        bucket's over (resize_into). Caller holds
        _lock."""
        if self.state.m != m:
            self.state = resize_into(self.state, self._bucket_state(m))
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
        return scheduling_cycle(state, reqs, eps, self.weights, gumbel,
                                cfg=self.cfg, wvec=wvec)[0]

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
        if self.device.type != "cuda":
            gumbel = (None if shape is None else torch.zeros(
                shape, dtype=torch.float32, device=self.device))
            scheduling_cycle(
                SchedState.init(m=m, device=self.device),
                _batch_to_device(reqs, self.device),
                _batch_to_device(eps, self.device), self.weights, gumbel,
                cfg=self.cfg)
            return
        with self._lock:
            state = self._bucket_state(m)
        graph = CycleGraph(key, state, feature_schema(self.cfg), shape,
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
        bucket = bucket_for(n)
        m = int(eps.valid.shape[0])
        if m not in C.M_BUCKETS:
            raise ValueError(
                f"EndpointBatch width {m} is not an M bucket {C.M_BUCKETS}")
        if int(reqs.subset_mask.shape[1]) != m:
            raise ValueError(
                f"subset_mask width {reqs.subset_mask.shape[1]} != "
                f"endpoint width {m}")
        lanes = int(reqs.chunk_hashes.shape[1])
        key = (bucket, m, lanes)
        if self.device.type != "cuda":
            reqs = pad_requests(_batch_to_device(reqs, self.device), bucket)
            eps = _batch_to_device(eps, self.device)
            self._ensure_warm(key, lambda: (reqs, eps))
            with self._lock:
                state = self._use_bucket(m)
                shape = self._noise_shape(bucket, m)
                gumbel = None if shape is None else self._noise(shape)
                result, _ = scheduling_cycle(
                    state, reqs, eps, self.weights, gumbel, cfg=self.cfg)
                snap = state.assumed_load.clone() if snapshot_load else None
            return PendingWave(result=result, n=n, load_snapshot=snap)
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
            snap = (_to_host_async(state.assumed_load) if snapshot_load
                    else None)
            host = PickResult(**{
                f.name: (None if getattr(result, f.name) is None
                         else _to_host_async(getattr(result, f.name)[:n]))
                for f in dataclasses.fields(PickResult)})
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
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
        if self.device.type == "cuda":
            self._enqueue(("complete", slots, costs))
            return
        with self._lock:
            _complete_update(self.state, torch.from_numpy(slots),
                             torch.from_numpy(costs))

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
                width = m_bucket_for(slot + 1)
                grows.append((len(hashes), width))
            for batch, remove in ((stored, False), (removed, True)):
                for start in range(0, len(batch), top):
                    part = batch[start:start + top].astype(np.int64)
                    part = part[part != 0]
                    if len(part):
                        hashes.append(part)
                        slots.append(slot)
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
            if self.device.type == "cuda":
                self._fold_graph(size).replay(group)
            else:
                prefix.ingest_lanes(self.state.prefix, group[0], group[1],
                                    group[2] != 0, self.state.tick)
        for _, m in pending:
            self._use_bucket(m)

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
        if slot < self.state.m:  # beyond the live bucket: nothing recorded
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
        if self.device.type == "cuda":
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
            prefix.clear_endpoint(self.state.prefix, slot)
            self.state.assumed_load[slot] = 0.0
            self.state.ot_v[slot] = 1.0

    def clear_prefix_endpoint(self, slot: int) -> None:
        """Forget an endpoint's cached chunks, keeping its assumed load
        (live-pod cache reset). Queued on CUDA, as apply_prefix_events."""
        if self.device.type == "cuda":
            self._enqueue(("clear", slot))
            return
        with self._lock:
            self._clear_prefix(slot)

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
            state = (_copy_state(self.state) if self.state.m == m
                     else resize_into(self.state, SchedState.init(
                         m=m, device=self.device)))
            weights = self.weights
        mask, shed, named, stacked, wvec, total = build_stages(
            state, reqs, eps, weights, cfg=self.cfg)
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
            "device": str(self.device),
            "warm_buckets": sorted(self._warm_buckets),
            "warm_inline_compiles": self.warm_inline_compiles,
        }

    def snapshot_assumed_load(self) -> np.ndarray:
        """Host copy of the assumed-load vector (the lock covers only a
        device copy; the transfer runs outside it)."""
        with self._lock:
            self._apply_queued()
            load = self.state.assumed_load.clone()
        return load.cpu().numpy()

    # -- warm-restart persistence -------------------------------------------
    # The reference accepts prefix-index loss on restart; a checkpoint lets
    # a restarted EPP keep its cache affinity. The reference writes it with
    # orbax, a JAX library; the port, which imports no JAX, writes the
    # export_state arrays as one .npz (the two formats differ; a reference
    # checkpoint crosses over through export_state / install_state).

    _CHECKPOINT = "sched_state.npz"

    def save_state(self, directory: str) -> None:
        """Write the live state to `directory`: read to host under the
        lock, after the queued completions and event folds are applied, so
        the file holds one consistent state; written to a temporary name
        and renamed over the checkpoint."""
        from gie_tpu_torch.convert import state_to_numpy

        with self._lock:
            self._apply_queued()
            arrays = state_to_numpy(self.state)
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
            self.state = resize_into(restored, self._bucket_state(restored.m))
        return True

    # -- replication digest surface ----------------------------------------

    def export_state(self) -> dict:
        """Flat host-array dict of the full state, array-compatible with
        gie_tpu's Scheduler.export_state (uint32 table columns and
        counters)."""
        from gie_tpu_torch.convert import state_to_numpy

        with self._lock:
            self._apply_queued()
            snap = _copy_state(self.state)
        return state_to_numpy(snap)

    def prepare_install(self, arrays: dict) -> Optional[SchedState]:
        """Validate digest arrays into a SchedState on this scheduler's
        device without touching live state; None on any malformation,
        including a prefix table of another row count than this
        scheduler's (its states are allocated once, at that count)."""
        from gie_tpu_torch.convert import state_from_numpy

        try:
            restored = state_from_numpy(arrays, device=self.device)
        except (KeyError, TypeError, ValueError):
            return None
        if not check_state_shapes(restored):
            return None
        if restored.prefix.keys.shape != self.state.prefix.keys.shape:
            return None
        return restored

    def commit_install(self, state: SchedState) -> None:
        """Install a prepare_install-validated state: copied into the
        tensors of its M bucket, which becomes the live one."""
        with self._lock:
            self._apply_queued()           # then overwritten, as before
            self.state = resize_into(state, self._bucket_state(state.m))
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


def _copy_state(state: SchedState) -> SchedState:
    px = state.prefix
    return SchedState(
        prefix=px.replace(keys=px.keys.clone(), present=px.present.clone(),
                          ages=px.ages.clone()),
        assumed_load=state.assumed_load.clone(),
        rr=state.rr.clone(), tick=state.tick.clone(),
        ot_v=state.ot_v.clone())
