"""Sinkhorn optimal-transport picker (port of gie_tpu/sched/sinkhorn.py).

Assigns the whole wave at once:

  maximize   sum_{n,m} P[n,m] * score[n,m]
  subject to sum_m P[n,m] = 1           (each request placed once)
             sum_n P[n,m] <= cap[m]     (endpoint capacity this wave)

solved approximately by Sinkhorn iterations on K = exp(score / tau), then
rounded per request with Gumbel noise.

Mesh sharding (docs/MESH.md, parallel/mesh.py). Every coupled sum runs as
the reference's fixed GROUPS-way contiguous partials folded left to right.
Under a (dp, tp) mesh each position holds a [N/dp, M/tp] block of the
kernel and computes the partials of its own whole groups; the partials
are gathered (concatenated in dp or tp order, the reference's ordered
all_gather) and the same fold runs over them, so the sharded solve is
bit-equal to the single-device one. The single-device solve is that same
code over a 1 x 1 grid, where the gather is the identity.

Noise seam: `sinkhorn_picker` takes the standard Gumbel tensor as an
argument instead of a PRNG key (the port cannot reproduce JAX's threefry
bits; Scheduler draws the tensor from a torch.Generator, or from a caller's
`noise_source`). Under a mesh each position takes its block of the one
wave draw, so sharded noise equals unsharded noise by construction.
"""

from __future__ import annotations

from typing import Optional

import torch

from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.pickers import NEG, _finalize
from gie_tpu_torch.sched.types import EndpointBatch

# Canonical reduction-group count, as in the reference.
GROUPS = 8


def _group_count(axis_len: int) -> int:
    for g in (GROUPS, 4, 2, 1):
        if axis_len % g == 0:
            return g
    return 1


def _fold_first(parts: torch.Tensor) -> torch.Tensor:
    """Ordered left-to-right sum over the leading (group) axis."""
    acc = parts[0]
    for i in range(1, parts.shape[0]):
        acc = acc + parts[i]
    return acc


def _fold_last(parts: torch.Tensor) -> torch.Tensor:
    acc = parts[..., 0]
    for i in range(1, parts.shape[-1]):
        acc = acc + parts[..., i]
    return acc


def _sum_m_shards(shards: list, device: torch.device) -> torch.Tensor:
    """Scalar sum of an endpoint-axis vector held as its tp shards (one
    shard: the whole vector), on `device`: each shard's own groups' fixed
    partials, gathered in tp order, then an ordered fold."""
    g = _group_count(sum(int(x.shape[0]) for x in shards)) // len(shards)
    parts = [x.reshape(g, -1).sum(dim=1) for x in shards]
    return _fold_first(_gather(parts, 0, device))


def _headroom(eps: EndpointBatch, queue_limit: float) -> torch.Tensor:
    """Raw per-endpoint free capacity (queue room x kv room, zero on
    invalid slots) -> f32[M]; feeds both the caps and the warm-start gate."""
    queue = eps.metrics[:, C.Metric.QUEUE_DEPTH]
    kv = eps.metrics[:, C.Metric.KV_CACHE_UTIL]
    headroom = (torch.clamp(queue_limit - queue, 0.0, queue_limit)
                * torch.clamp(1.0 - kv, 0.05, 1.0))
    return torch.where(eps.valid, headroom, torch.zeros_like(headroom))


def capacities(eps: EndpointBatch, n_requests: torch.Tensor, *,
               queue_limit: float) -> torch.Tensor:
    """Per-endpoint wave capacity -> f32[M], scaled to sum to 1.25x the
    effective request mass."""
    return _capacities([eps], n_requests, queue_limit, eps.valid.device)[0]


def _capacities(cols: list, n_requests: torch.Tensor, queue_limit: float,
                device: torch.device) -> list:
    """capacities over the endpoint axis's tp shards -> [tp] f32[M/tp];
    the total headroom is summed on `device`."""
    heads = []
    for e in cols:
        h = _headroom(e, queue_limit) + 1e-3
        heads.append(torch.where(e.valid, h, torch.zeros_like(h)))
    total = torch.clamp(_sum_m_shards(heads, device), min=1e-6)
    scale = n_requests / total
    return [h * _on(scale, h.device) * 1.25 for h in heads]


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def _gather(parts: list, dim: int, device: torch.device) -> torch.Tensor:
    """The shards' partials concatenated on `dim` in mesh order, on
    `device`: the reference's tiled all_gather. One shard: itself."""
    if len(parts) == 1:
        return _on(parts[0], device)
    return torch.cat([_on(p, device) for p in parts], dim=dim)


def _combine(parts: list, device: torch.device, op: str) -> torch.Tensor:
    """An exact cross-shard reduction of per-shard values on `device`:
    "any", "amax", or "sum" of whole-number counts (exact in any order).
    One shard: itself."""
    if len(parts) == 1:
        return _on(parts[0], device)
    stacked = torch.stack([_on(p, device) for p in parts])
    if op == "any":
        return stacked.any(dim=0)
    return stacked.amax(dim=0) if op == "amax" else stacked.sum(dim=0)


def _dual_solve(
    k: list,        # [dp][tp] f32[n_loc, m_loc] kernel blocks
    cap: list,      # [tp] f32[m_loc]
    v_init: list,   # [tp] f32[m_loc] warm-started column duals
    *,
    iters: int,
    gn: int,        # LOCAL request-axis group count (total // dp)
    gm: int,        # LOCAL endpoint-axis group count (total // tp)
) -> tuple[list, list]:
    """The reference's `_dual_solve` over a grid of blocks: dual-form
    iterations p_t = diag(u_t) K diag(v_t), two grouped matvecs per round,
    the plan materialized once at the end. Row sums gather their
    per-(row, m-group) partials across tp, column sums their per-(n-group,
    column) partials across dp (the global column-dual all-reduce), and
    both fold in group order. Row vectors live on each dp row's first
    position, column vectors on each tp column's first. -> ([dp][tp] plan
    blocks, [tp] duals)."""
    dp, tp = len(k), len(k[0])
    n_loc, m_loc = k[0][0].shape
    row_dev = [k[i][0].device for i in range(dp)]
    col_dev = [k[0][j].device for j in range(tp)]
    kg = [[b.reshape(gn, n_loc // gn, gm, m_loc // gm) for b in row]
          for row in k]
    # Column sums reduce a transposed copy over its innermost axis: a
    # reduction over a middle axis may take another summation order when
    # the block's width changes (torch's CPU kernel does at 16 columns),
    # one over the innermost axis depends on that axis's length alone.
    kt = [[b.t().contiguous().reshape(gm, m_loc // gm, gn, n_loc // gn)
           for b in row] for row in k]

    def row_sums(v: list) -> list:
        out = []
        for i in range(dp):
            parts = [(kg[i][j] * _on(v[j], kg[i][j].device).reshape(
                1, 1, gm, m_loc // gm)).sum(dim=3) for j in range(tp)]
            out.append(_fold_last(_gather(parts, 2, row_dev[i])).reshape(
                n_loc))
        return out

    def col_sums(u: list) -> list:
        out = []
        for j in range(tp):
            parts = [(kt[i][j] * _on(u[i], kt[i][j].device).reshape(
                1, 1, gn, n_loc // gn)).sum(dim=3) for i in range(dp)]
            out.append(_fold_last(_gather(parts, 2, col_dev[j])).reshape(
                m_loc))
        return out

    u = [torch.ones((n_loc,), dtype=torch.float32, device=d) for d in row_dev]
    v = list(v_init)
    for _ in range(iters):
        r = row_sums(v)
        u = [torch.where(r[i] > 0, 1.0 / r[i], u[i]) for i in range(dp)]
        cs = col_sums(u)
        for j in range(tp):
            col = v[j] * cs[j]
            one = torch.ones((), dtype=torch.float32, device=col_dev[j])
            v[j] = v[j] * torch.where(
                col > cap[j], cap[j] / torch.clamp(col, min=1e-9), one)
    plan = [[k[i][j] * _on(u[i], k[i][j].device)[:, None]
             * _on(v[j], k[i][j].device)[None, :] for j in range(tp)]
            for i in range(dp)]
    for i in range(dp):
        parts = [plan[i][j].reshape(gn, n_loc // gn, gm, m_loc // gm)
                 .sum(dim=3) for j in range(tp)]
        row = _fold_last(_gather(parts, 2, row_dev[i])).reshape(n_loc)
        for j in range(tp):
            rj = _on(row, plan[i][j].device)[:, None]
            plan[i][j] = torch.where(rj > 0, plan[i][j] / rj, plan[i][j])
    return plan, v


def _solve_plan(
    k,                      # f32[N, M], or [dp][tp] blocks of it
    cap,                    # f32[M], or its [tp] blocks
    v_init,                 # f32[M], or its [tp] blocks
    *,
    iters: int,
):
    """The grouped dual solve of a whole wave (-> plan, duals) or of a
    grid of its blocks (-> [dp][tp] plan blocks, [tp] duals), whose axes
    must divide the canonical group counts (the reference's error)."""
    if torch.is_tensor(k):
        plan, v = _solve_plan([[k]], [cap], [v_init], iters=iters)
        return plan[0][0], v[0]
    dp, tp = len(k), len(k[0])
    n = int(k[0][0].shape[0]) * dp
    m = int(k[0][0].shape[1]) * tp
    gn_total, gm_total = _group_count(n), _group_count(m)
    if gn_total % dp or gm_total % tp:
        raise ValueError(
            f"sinkhorn mesh axes (dp={dp}, tp={tp}) must divide the "
            f"canonical reduction groups (gn={gn_total}, gm={gm_total} "
            f"for a {n}x{m} wave) — mesh axes are capped at {GROUPS}")
    return _dual_solve(k, cap, v_init, iters=iters, gn=gn_total // dp,
                       gm=gm_total // tp)


def sinkhorn_picker(
    scores: list,           # [dp][tp] f32[N/dp, M/tp]
    mask: list,             # [dp][tp] bool[N/dp, M/tp]
    shed: list,             # [dp] bool[N/dp]
    valid: list,            # [dp] bool[N/dp]
    eps: list,              # [dp][tp] EndpointBatch shards
    gumbel: list,           # [dp][tp] blocks of the standard Gumbel noise
    *,
    queue_limit: float,
    tau: float,
    iters: int,
    rounding_temp: float,
    use_kernel: bool = False,
    v0: Optional[list] = None,  # [tp] blocks of last wave's column duals
):
    """-> ([dp] PickResult row shards, [tp] new column-dual shards).

    The arguments are a wave's blocks over a (dp, tp) grid; one device's
    whole wave is the 1 x 1 grid. Row maxima and candidate flags combine
    across tp exactly, request counts too; the float sums go through
    _sum_m_shards and the grouped solve, so any grid picks bit-equal to
    the 1 x 1 one. `use_kernel` routes a 1 x 1 solve through
    ops.fused_sinkhorn_plan (the reference's use_pallas_sinkhorn; a mesh
    runs the grouped solve, as the reference's does)."""
    dp, tp = len(scores), len(scores[0])
    row_dev = [scores[i][0].device for i in range(dp)]
    col_dev = [scores[0][j].device for j in range(tp)]
    home = row_dev[0]
    f32 = torch.float32
    cols = eps[0]

    any_row = [_combine([b.any(dim=1) for b in mask[i]], row_dev[i], "any")
               for i in range(dp)]
    n_eff = torch.clamp(_combine(
        [(valid[i] & any_row[i]).to(f32).sum() for i in range(dp)], home,
        "sum"), min=1.0)
    cap = _capacities(cols, n_eff, queue_limit, home)

    k = [[None] * tp for _ in range(dp)]
    for i in range(dp):
        row_max = _combine([
            torch.where(mask[i][j], scores[i][j], torch.full(
                (), float("-inf"), dtype=f32, device=col_dev[j]))
            .amax(dim=1, keepdim=True) for j in range(tp)], row_dev[i],
            "amax")
        row_max = torch.where(torch.isfinite(row_max), row_max,
                              torch.zeros_like(row_max))
        for j in range(tp):
            s = scores[i][j]
            k[i][j] = torch.where(
                mask[i][j], torch.exp((s - _on(row_max, s.device)) / tau),
                torch.zeros_like(s))

    # Warm start gated by fleet utilization (see the reference):
    # idle -> ones, saturated -> sqrt of last wave's duals.
    if v0 is None:
        v_init = [torch.ones(k[0][j].shape[1:], dtype=f32, device=col_dev[j])
                  for j in range(tp)]
    else:
        free = [_headroom(e, queue_limit) for e in cols]
        n_valid = _combine([e.valid.to(f32).sum() for e in cols], home, "sum")
        idle_free = queue_limit * torch.clamp(n_valid, min=1.0)
        u = torch.clamp(1.0 - _sum_m_shards(free, home) / idle_free, 0.0, 1.0)
        v_init = [torch.clamp(v0[j], 1e-6, 1.0) ** (0.5 * _on(u, col_dev[j]))
                  for j in range(tp)]

    if use_kernel:
        if dp * tp != 1:
            raise ValueError("the fused Sinkhorn kernel solves one device's "
                             f"whole wave, not a {dp} x {tp} grid")
        from gie_tpu_torch.ops.fused_sinkhorn import fused_sinkhorn_plan

        p, v = fused_sinkhorn_plan(k[0][0], cap[0], v_init[0].contiguous(),
                                   iters=iters)
        plan, v_out = [[p]], [v]
    else:
        plan, v_out = _solve_plan(k, cap, v_init, iters=iters)

    results = []
    for i in range(dp):
        masked = []
        for j in range(tp):
            p = plan[i][j]
            g = gumbel[i][j] * rounding_temp
            neg = torch.full((), NEG, dtype=f32, device=p.device)
            masked.append(torch.where(mask[i][j] & (p > 0),
                                      torch.log(p + 1e-20) + g, neg))
        results.append(_finalize(_gather(masked, 1, row_dev[i]),
                                 _gather(list(mask[i]), 1, row_dev[i]),
                                 shed[i], valid[i]))
    return results, v_out
