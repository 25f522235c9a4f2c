"""(Copy of gie_tpu/fairness/drr.py, imports rewritten to gie_tpu_torch.)

Band-scoped weighted deficit-round-robin flow ordering
(docs/FAIRNESS.md "DRR algebra").

The flow queue's fairness contract (proposal 1199) is scoped WITHIN a
criticality band: CRITICAL drains before STANDARD before SHEDDABLE, and
inside each band tenants share capacity. The seed's round-robin shared
request COUNTS; this orderer shares request COST — each drained item
charges ``item.cost`` (prompt + decode-estimate in the scheduler's own
``request_cost`` units, cached on the item at enqueue) against the
tenant's deficit counter, and a tenant is only drained while its
deficit covers the head-of-queue cost. Per-round credit is
``quantum * weight(tenant)``, so ``--fairness-weights a=2`` gives
tenant ``a`` twice the cost share of a weight-1 neighbor; uniform
weights (the default) converge to equal cost shares regardless of
request size mix. Gavel (PAPERS.md) frames the same knob as a max-min
policy over an arbitrary weighted metric — the weight map is the seam
a learned policy later replaces.

Ordering invariants (pinned by tests/test_fairness.py):

  * per-tenant FIFO is preserved (tenant queues only pop from the head);
  * bands drain strictly CRITICAL -> STANDARD -> SHEDDABLE;
  * long-run drained-cost shares converge to the weight ratios while
    tenants stay backlogged;
  * empty and single-tenant inputs degenerate to plain FIFO.

Statefulness: deficits persist ACROSS waves for tenants that remain
backlogged at the take boundary (the classic DRR carry), and reset to
zero when a tenant's queue fully drains (no credit hoarding). Only the
first ``take`` outputs charge the persistent state — those are the
items the collector's next wave actually drains; the remainder is
re-ordered next wave and must not be double-charged. Collector-thread
only: no lock.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class FairnessConfig:
    """Tenant-isolation knobs (the runner wires ``--fairness-*``)."""

    # tenant -> weight; absent tenants get default_weight (uniform).
    weights: Mapping[str, float] = dataclasses.field(default_factory=dict)
    default_weight: float = 1.0
    # DRR per-round credit in cost units; 0 = auto (the wave's max item
    # cost, the classic choice that guarantees every round drains >= 1
    # item from the visited tenant).
    quantum: float = 0.0
    # Over-fair-share verdict: a tenant whose windowed OFFERED-cost
    # share exceeds ``factor x`` its weighted fair share is eligible for
    # preemptive SHEDDABLE sheds under saturation. The formula
    # self-guards the degenerate pool: a lone tenant's share is 1.0 and
    # its fair share is 1.0, so factor > 1 never flags it.
    over_share_factor: float = 2.0
    # Sliding window for every per-tenant rate/cost ledger.
    window_s: float = 10.0
    # Cached over-share set recompute interval (wave cadence reads it).
    eval_interval_s: float = 0.25
    # Bounded-cardinality label policy: top_k tenants by traffic keep
    # their own gie_tenant_* label value, the rest fold into "other";
    # at most label_cap distinct tenants are ever promoted process-wide.
    top_k: int = 8
    # Bounded state: per-tenant accounts and deficit entries beyond this
    # are evicted (least-traffic first).
    max_tracked: int = 512

    def __post_init__(self):
        if self.default_weight <= 0:
            raise ValueError("default_weight must be > 0")
        for t, w in self.weights.items():
            if w <= 0:
                raise ValueError(f"fairness weight for {t!r} must be > 0")
        if self.quantum < 0:
            raise ValueError("quantum must be >= 0 (0 = auto)")
        if self.over_share_factor <= 1.0:
            raise ValueError("over_share_factor must be > 1")
        if self.window_s <= 0 or self.eval_interval_s <= 0:
            raise ValueError("windows must be positive")
        if self.top_k < 1 or self.max_tracked < 1:
            raise ValueError("top_k and max_tracked must be >= 1")

    @property
    def label_cap(self) -> int:
        return 4 * self.top_k

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, self.default_weight)


class DeficitRoundRobin:
    """The orderer. Items need three attributes: ``band`` (int, lower =
    more critical), ``tenant`` (str), ``cost`` (float > 0)."""

    def __init__(self, cfg: FairnessConfig | None = None):
        self.cfg = cfg if cfg is not None else FairnessConfig()
        # (band, tenant) -> carried deficit, bounded by _prune.
        self._deficit: dict[tuple[int, str], float] = {}

    def deficits(self) -> dict:
        """Live carried deficits for /debugz/tenants ("band:tenant")."""
        return {
            f"{band}:{tenant or 'default'}": round(d, 4)
            for (band, tenant), d in self._deficit.items()
        }

    def _prune(self, items) -> None:
        if len(self._deficit) <= self.cfg.max_tracked:
            return
        live = {(it.band, it.tenant) for it in items}
        for key in [k for k in self._deficit if k not in live]:
            del self._deficit[key]

    def order(self, items, take: int = 0) -> list:
        """Full ordering of ``items`` (bands strict, DRR within a band).
        Deficit charges persist only for the first ``take`` outputs
        (0 = all)."""
        n = len(items)
        if n <= 1:
            return list(items)
        self._prune(items)
        bands: dict[int, dict[str, deque]] = {}
        tenant_order: dict[int, list[str]] = {}
        for it in items:
            per = bands.setdefault(it.band, {})
            q = per.get(it.tenant)
            if q is None:
                per[it.tenant] = q = deque()
                tenant_order.setdefault(it.band, []).append(it.tenant)
            q.append(it)
        out: list = []
        limit = take if take and take > 0 else n
        persisted = False
        for band in sorted(bands):
            per = bands[band]
            tenants = tenant_order[band]
            if len(tenants) == 1:
                # Degenerate single-tenant band: plain FIFO; a fully-
                # drained tenant carries no deficit forward.
                out.extend(per[tenants[0]])
                per[tenants[0]].clear()
                if not persisted:
                    self._deficit.pop((band, tenants[0]), None)
                    persisted = len(out) >= limit
                continue
            quantum = self.cfg.quantum or max(
                it.cost for q in per.values() for it in q)
            quantum = max(quantum, 1e-9)
            weights = {t: self.cfg.weight(t) for t in tenants}
            local = {t: self._deficit.get((band, t), 0.0) for t in tenants}
            active = deque(tenants)
            while active:
                t = active.popleft()
                q = per[t]
                local[t] += quantum * weights[t]
                while q and local[t] >= q[0].cost:
                    head = q.popleft()
                    local[t] -= head.cost
                    out.append(head)
                    if not persisted and len(out) >= limit:
                        # The take boundary: the next wave drains exactly
                        # this prefix, so THIS is the deficit state the
                        # drain leaves behind. Later pops reorder the
                        # remainder best-effort without touching it.
                        self._persist_band(band, local, per,
                                           quantum, weights)
                        persisted = True
                if q:
                    active.append(t)
                else:
                    # Classic DRR: an emptied queue forfeits its credit —
                    # an idle tenant must not bank a burst allowance.
                    local[t] = 0.0
            if not persisted:
                self._persist_band(band, local, per, quantum, weights)
        return out

    def _persist_band(self, band: int, local: dict, per: dict,
                      quantum: float, weights: dict) -> None:
        """Snapshot one band's boundary-time deficits into the carried
        state: backlogged tenants keep their (capped) deficit, fully
        drained tenants reset to zero."""
        for t, d in local.items():
            if not per[t]:
                self._deficit.pop((band, t), None)
            else:
                cap = 2.0 * quantum * weights[t]
                self._deficit[(band, t)] = min(max(d, 0.0), cap)
