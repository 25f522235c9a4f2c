"""(Copy of gie_tpu/fairness/budgets.py, imports rewritten to gie_tpu_torch.)

Per-tenant isolation budgets: windowed accounting, the
over-fair-share verdict, and the bounded-cardinality tenant labeler
(docs/FAIRNESS.md "budget windows" / "tenant-label cardinality").

Three ledgers per tenant, all sliding-window so a reformed abuser ages
out instead of being punished forever:

  arrival cost   offered load at enqueue (cost units) — the over-share
                 input. DRR already caps what a flooding tenant DRAINS
                 at its fair share, so the abuse signal must be what it
                 OFFERS, not what it wins.
  drained cost   what actually entered waves (capacity consumed).
  shed / serve   outcome rates via the breaker's WindowedRate pattern
                 (resilience/breaker.py): sheds vs admissions, serve
                 errors (5xx/reset) vs clean serves.

The labeler bounds ``gie_tenant_*`` series cardinality (OC004's intent
applied to tenants): the top-K tenants by cumulative traffic keep their
own label value, everyone else exports as ``"other"``, the empty
fairness ID exports as ``"default"``, and at most ``label_cap`` distinct
tenants are ever promoted process-wide — an adversarial tenant-ID churn
cannot mint unbounded series.

One leaf lock (lockorder.toml rank 83) held for dict math only; the
wave-cadence ``over_share_set`` read is a cached frozenset recomputed at
``eval_interval_s``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from gie_tpu_torch.fairness.drr import FairnessConfig
from gie_tpu_torch.resilience.breaker import BucketWindow, WindowedRate


class WindowedSum(BucketWindow):
    """Time-bucketed float accumulator on the shared BucketWindow core
    (costs arrive at request cadence; rates need counts, budgets need
    magnitudes). Not thread-safe; callers hold their own lock."""

    __slots__ = ()
    _ZERO = (0.0,)

    def note(self, value: float, now: float) -> None:
        self._live_bucket(now)[1] += value

    def total(self, now: float) -> float:
        self._prune(now)
        return sum(b[1] for b in self._buckets)


class _Account:
    __slots__ = ("arrival_cost", "drained_cost", "shed_window",
                 "serve_window", "requests", "last_seen")

    def __init__(self, window_s: float, now: float):
        self.arrival_cost = WindowedSum(window_s)
        self.drained_cost = WindowedSum(window_s)
        # ok=arrival, err=shed. A shed request notes BOTH (it arrived,
        # then shed): report() divides sheds by arrivals, never by the
        # raw note count.
        self.shed_window = WindowedRate(window_s)
        self.serve_window = WindowedRate(window_s)  # ok=clean, err=5xx/reset
        self.requests = 0
        self.last_seen = now


class TenantBudgets:
    def __init__(self, cfg: FairnessConfig | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg if cfg is not None else FairnessConfig()
        self.clock = clock
        self._lock = threading.Lock()
        self._accounts: dict[str, _Account] = {}
        # Labeler state: promoted tenants keep their own label value.
        self._topk: frozenset = frozenset()
        self._promoted: set[str] = set()
        self._notes_since_rank = 0
        # Cached over-share verdict (wave-cadence reads).
        self._over: frozenset = frozenset()
        self._over_at = -1.0

    # -- accounting feeds --------------------------------------------------

    def _account_locked(self, tenant: str, now: float) -> _Account:
        acct = self._accounts.get(tenant)
        if acct is None:
            if len(self._accounts) >= self.cfg.max_tracked:
                # Evict the least-traffic account: a long-tail tenant's
                # ledger, never the heavy hitters the verdicts watch.
                victim = min(self._accounts,
                             key=lambda t: self._accounts[t].requests)
                del self._accounts[victim]
            acct = self._accounts[tenant] = _Account(self.cfg.window_s, now)
        acct.last_seen = now
        return acct

    def note_arrival(self, tenant: str, cost: float) -> str:
        """One enqueue: offered-cost + traffic count. Returns the
        bounded metric label for the caller's series."""
        now = self.clock()
        with self._lock:
            acct = self._account_locked(tenant, now)
            acct.requests += 1
            acct.arrival_cost.note(max(cost, 0.0), now)
            acct.shed_window.note(True, now)
            self._notes_since_rank += 1
            if self._notes_since_rank >= 256 or not self._topk:
                self._notes_since_rank = 0
                self._rerank_locked()
            return self._label_locked(tenant)

    def note_drained(self, tenant: str, cost: float) -> str:
        now = self.clock()
        with self._lock:
            acct = self._account_locked(tenant, now)
            acct.drained_cost.note(max(cost, 0.0), now)
            return self._label_locked(tenant)

    def note_shed(self, tenant: str) -> str:
        now = self.clock()
        with self._lock:
            acct = self._account_locked(tenant, now)
            acct.shed_window.note(False, now)
            return self._label_locked(tenant)

    def note_serve(self, tenant: str, ok: bool) -> str:
        now = self.clock()
        with self._lock:
            acct = self._account_locked(tenant, now)
            acct.serve_window.note(ok, now)
            return self._label_locked(tenant)

    # -- over-fair-share verdict -------------------------------------------

    def over_share_set(self) -> frozenset:
        """Tenants whose windowed OFFERED-cost share exceeds their
        over-share threshold. Fair share = weight / sum of ACTIVE
        tenants' weights; the threshold is ``factor x fair`` CAPPED at
        the midpoint between fair and 1.0 — without the cap, a pool of
        two equal tenants has fair share 0.5 and ``2 x 0.5 = 1.0`` is a
        share no tenant can exceed, so a 2-tenant flooder would never
        flag. The cap keeps the lone-tenant case self-guarding (fair =
        1.0 -> threshold 1.0, unreachable strictly). Cached; recomputed
        at eval_interval_s so the wave-cadence caller pays a frozenset
        read."""
        now = self.clock()
        with self._lock:
            if now - self._over_at < self.cfg.eval_interval_s:
                return self._over
            self._over_at = now
            shares: dict[str, float] = {}
            total = 0.0
            for t, acct in self._accounts.items():
                c = acct.arrival_cost.total(now)
                if c > 0.0:
                    shares[t] = c
                    total += c
            if total <= 0.0 or len(shares) < 2:
                self._over = frozenset()
                return self._over
            weight_sum = sum(self.cfg.weight(t) for t in shares)
            factor = self.cfg.over_share_factor
            over = set()
            for t, c in shares.items():
                fair = self.cfg.weight(t) / weight_sum
                threshold = min(factor * fair, (1.0 + fair) / 2.0)
                if c / total > threshold:
                    over.add(t)
            self._over = frozenset(over)
            return self._over

    # -- bounded-cardinality labels ----------------------------------------

    def _rerank_locked(self) -> None:
        ranked = sorted(self._accounts,
                        key=lambda t: self._accounts[t].requests,
                        reverse=True)[: self.cfg.top_k]
        topk = set()
        for t in ranked:
            if t in self._promoted or len(self._promoted) < self.cfg.label_cap:
                self._promoted.add(t)
                topk.add(t)
        self._topk = frozenset(topk)

    def _label_locked(self, tenant: str) -> str:
        if tenant in self._topk:
            return tenant or "default"
        return "other" if tenant else "default"

    def label(self, tenant: str) -> str:
        with self._lock:
            return self._label_locked(tenant)

    # -- introspection -----------------------------------------------------

    def report(self, limit: int = 32) -> dict:
        """/debugz/tenants core: per-tenant windowed ledgers + verdicts,
        heaviest tenants first, row count bounded."""
        over = self.over_share_set()
        now = self.clock()
        with self._lock:
            ranked = sorted(self._accounts.items(),
                            key=lambda kv: kv[1].requests, reverse=True)
            tenants = {}
            for t, acct in ranked[:limit]:
                # shed_window notes ok=arrival and err=shed, and a shed
                # request appears as BOTH (it arrived, then shed), so
                # WindowedRate.rate's err/(ok+err) would saturate at 0.5
                # for a fully-shed tenant. The operator-facing quantity
                # is sheds/ARRIVALS: recover the raw counts and divide.
                frac, shed_n = acct.shed_window.rate(now)
                sheds = round(frac * shed_n)
                arrivals = shed_n - sheds
                shed_rate = (min(sheds / arrivals, 1.0) if arrivals
                             else (1.0 if sheds else 0.0))
                err_rate, err_n = acct.serve_window.rate(now)
                tenants[t or "default"] = {
                    "label": self._label_locked(t),
                    "requests_total": acct.requests,
                    "arrival_cost_w": round(acct.arrival_cost.total(now), 3),
                    "drained_cost_w": round(acct.drained_cost.total(now), 3),
                    "shed_rate_w": round(shed_rate, 4),
                    "shed_samples_w": shed_n,
                    "serve_error_rate_w": round(err_rate, 4),
                    "serve_samples_w": err_n,
                    "weight": self.cfg.weight(t),
                    "over_share": t in over,
                }
            return {
                "window_s": self.cfg.window_s,
                "over_share_factor": self.cfg.over_share_factor,
                "top_k": self.cfg.top_k,
                "tracked": len(self._accounts),
                "over_share": sorted(t or "default" for t in over),
                "tenants": tenants,
            }
