"""(Copy of gie_tpu/fairness/__init__.py, imports rewritten to gie_tpu_torch.)

gie-fair: per-tenant isolation for the flow-control plane
(docs/FAIRNESS.md).

The fairness key (``x-gateway-inference-fairness-id``, proposal 1199)
was parsed but unenforced: ``_fair_order`` interleaved tenants by
request COUNT, so one tenant sending 8k-prompt/4k-decode requests took
an order of magnitude more capacity per drained slot than a neighbor
sending chat turns — and nothing shed the abuser first, traced the
abuser harder, or explained per-tenant state. This package is the
isolation layer the batching picker threads through admission, the
flow queue, the shed path, and the serve-outcome loop:

  drr.py      band-scoped weighted deficit-round-robin ordering: each
              drained request charges its COST (the scheduler's own
              request_cost units) against a per-(band, tenant) deficit
              counter, with configurable weights — Gavel's max-min
              formulation (PAPERS.md) specialized to cost shares, so a
              learned weight function can later replace the static map.
  budgets.py  windowed per-tenant accounting (arrival/drained cost,
              shed and serve-error rates via the breaker's WindowedRate
              pattern), the over-fair-share verdict driving preemptive
              SHEDDABLE sheds under saturation, and the bounded-
              cardinality tenant labeler (top-K by traffic + "other")
              behind every ``gie_tenant_*`` series.

``FairnessState`` is the bundle the picker owns (one per picker, like
``ResilienceState``); the runner configures it from
``--fairness-weights`` and /debugz/tenants reads its report.
"""

from __future__ import annotations

import time
from typing import Optional

from gie_tpu_torch.fairness.budgets import TenantBudgets
from gie_tpu_torch.fairness.drr import DeficitRoundRobin, FairnessConfig

__all__ = [
    "DeficitRoundRobin",
    "FairnessConfig",
    "FairnessState",
    "TenantBudgets",
    "parse_weights",
]


def parse_weights(specs) -> dict[str, float]:
    """``["tenant=weight", ...]`` (or one comma-joined string) -> weight
    map for FairnessConfig. Rejects malformed and non-positive entries
    loudly — a typoed weight silently defaulting to 1.0 would un-isolate
    exactly the tenant the operator meant to constrain."""
    out: dict[str, float] = {}
    if isinstance(specs, str):
        specs = [specs]
    for spec in specs or ():
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            name, sep, raw = part.partition("=")
            if not sep or not name:
                raise ValueError(
                    f"fairness weight {part!r} must be TENANT=WEIGHT")
            try:
                w = float(raw)
            except ValueError:
                raise ValueError(
                    f"fairness weight {part!r}: {raw!r} is not a number"
                ) from None
            if w <= 0:
                raise ValueError(
                    f"fairness weight {part!r} must be > 0")
            out[name] = w
    return out


class FairnessState:
    """The per-picker fairness bundle: one DRR orderer (collector-thread
    state), one budget ledger (its own leaf lock — admission, collector
    and response threads all feed it), and the metric fan-out. Every
    method is cheap enough for its call site: ``note_arrival`` is one
    short lock on the pick path, ``order``/``note_wave`` run at wave
    cadence on the collector, ``over_share_set`` returns a cached
    frozenset recomputed at a bounded interval."""

    def __init__(self, cfg: Optional[FairnessConfig] = None,
                 clock=time.monotonic):
        self.cfg = cfg if cfg is not None else FairnessConfig()
        self.drr = DeficitRoundRobin(self.cfg)
        self.budgets = TenantBudgets(self.cfg, clock=clock)

    # -- flow queue (collector thread) ------------------------------------

    def order(self, items, take: int = 0):
        """Band-scoped weighted-DRR ordering of the pending queue; only
        the first ``take`` items' costs persist into the deficit state
        (they are the ones the next wave drains)."""
        return self.drr.order(items, take=take)

    def note_wave(self, items) -> None:
        """Charge one drained wave's costs to the tenants' windowed
        drained-cost ledgers + gie_tenant_cost_total."""
        from gie_tpu_torch.runtime import metrics as own_metrics

        for it in items:
            label = self.budgets.note_drained(it.tenant, it.cost)
            own_metrics.TENANT_COST.labels(tenant=label).inc(it.cost)

    # -- admission path ----------------------------------------------------

    def note_arrival(self, tenant: str, cost: float) -> None:
        from gie_tpu_torch.runtime import metrics as own_metrics

        label = self.budgets.note_arrival(tenant, cost)
        own_metrics.TENANT_REQUESTS.labels(tenant=label).inc()

    # -- shed / serve feedback --------------------------------------------

    def note_shed(self, tenant: str, band: str) -> None:
        from gie_tpu_torch.runtime import metrics as own_metrics

        label = self.budgets.note_shed(tenant)
        own_metrics.TENANT_SHED.labels(tenant=label, band=band).inc()

    def note_serve(self, tenant: str, ok: bool, cls: str = "") -> None:
        from gie_tpu_torch.runtime import metrics as own_metrics

        label = self.budgets.note_serve(tenant, ok)
        if not ok:
            own_metrics.TENANT_SERVE_ERRORS.labels(tenant=label).inc()

    # -- isolation verdicts -----------------------------------------------

    def over_share_set(self) -> frozenset:
        """Tenants currently over their weighted fair share of OFFERED
        load (cached; see TenantBudgets.over_share_set)."""
        return self.budgets.over_share_set()

    def label(self, tenant: str) -> str:
        return self.budgets.label(tenant)

    def report(self) -> dict:
        """/debugz/tenants payload: budgets + weights + live deficits."""
        rep = self.budgets.report()
        rep["weights"] = dict(self.cfg.weights)
        rep["default_weight"] = self.cfg.default_weight
        rep["deficits"] = self.drr.deficits()
        return rep
