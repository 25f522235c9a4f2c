"""AutoscaleRecommender: hysteresis-bounded replica recommendations
(copy of gie_tpu/autoscale/recommender.py).

Control shape (docs/AUTOSCALE.md):

  FAST UP   — shed is users being 429'd NOW: once shed persists past a
              short sustain window, jump toward the capacity model's
              demand estimate (bounded by max_up_step per decision).
  SLOW DOWN — spare capacity costs money but removing it is risky and
              (for TPU pods) slow to undo; scale-down takes one step at a
              time, only when utilization sits below a LOWER threshold
              than the one scale-up targets (hysteresis band), and only
              after a cooldown since ANY scaling action (flap damping:
              at most one downward step per cooldown window).
  HOLD      — stale signals freeze the loop entirely: a scrape outage
              looks exactly like an idle fleet, and scaling on it would
              drain a loaded pool.

All recommendations are clamped to [min_replicas, max_replicas] except
the stale hold, which pins to the observed current state by definition.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from gie_tpu_torch.runtime.clock import REALTIME
from gie_tpu_torch.autoscale.model import CapacityModel
from gie_tpu_torch.autoscale.signals import PoolSignals


@dataclasses.dataclass(frozen=True)
class RecommenderConfig:
    min_replicas: int = 1
    max_replicas: int = 16
    # Fast scale-up trigger: shed rate (429/s) that must persist for
    # up_sustain_s before replicas are added. The sustain window rejects
    # single-wave blips; sustained shed is capacity shortfall.
    shed_high_per_s: float = 0.5
    up_sustain_s: float = 2.0
    max_up_step: int = 4
    # Utilization hysteresis band: scale-up sizes the pool for demand at
    # target_utilization; scale-down only engages below
    # scale_down_utilization (strictly lower, so the two decisions can
    # never chase each other across one boundary).
    target_utilization: float = 0.75
    scale_down_utilization: float = 0.5
    # Flap damping: minimum seconds since the LAST scaling action (either
    # direction) before one downward step may be taken.
    down_cooldown_s: float = 60.0

    def __post_init__(self):
        if not (0 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 0 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}")
        if self.scale_down_utilization >= self.target_utilization:
            raise ValueError(
                "scale_down_utilization must sit strictly below "
                "target_utilization (the hysteresis band)")


@dataclasses.dataclass(frozen=True)
class Recommendation:
    at: float
    current: int
    desired: int
    reason: str

    @property
    def direction(self) -> str:
        if self.desired > self.current:
            return "up"
        if self.desired < self.current:
            return "down"
        return "hold"


class AutoscaleRecommender:
    def __init__(
        self,
        cfg: RecommenderConfig = RecommenderConfig(),
        model: Optional[CapacityModel] = None,
    ):
        self.cfg = cfg
        self.model = model if model is not None else CapacityModel()
        self._shed_since: Optional[float] = None
        self._last_scale_at: Optional[float] = None

    def _clamp(self, n: int) -> int:
        return max(self.cfg.min_replicas, min(self.cfg.max_replicas, n))

    def observe(
        self,
        signals: Optional[PoolSignals],
        current: int,
        now: Optional[float] = None,
        *,
        predicted_ttft_s: Optional[float] = None,
        ttft_slo_s: Optional[float] = None,
    ) -> Recommendation:
        """One control decision. `current` is the workload's current
        replica count (the actuator's observed spec, or ready_replicas in
        recommend-only mode)."""
        now = REALTIME() if now is None else now
        cfg = self.cfg
        if signals is None or signals.stale:
            # NEVER scale on stale data — not even to clamp into bounds:
            # the bounds describe desired state, and desired state cannot
            # be computed from a view that may be a scrape outage.
            self._shed_since = None
            return Recommendation(now, current, current, "hold-stale")

        if signals.ready_replicas == 0 and current == 0:
            if cfg.min_replicas < 1:
                if signals.wake_arrivals > 0:
                    # Scale-FROM-zero: a request 503'd against the empty
                    # pool — the one traffic signal a scaled-to-zero pool
                    # can emit (nothing to scrape, nothing to pick).
                    # Immediate 0->1, no sustain window: the sustain gate
                    # exists to reject shed BLIPS on a serving pool, but
                    # here every arrival is a hard failure until a
                    # replica exists.
                    self._last_scale_at = now
                    return Recommendation(
                        now, current, self._clamp(1),
                        f"wake-from-zero ({signals.wake_arrivals} "
                        "arrivals on empty pool)")
                # Scale-to-zero configured: an empty pool at zero demand
                # is the DESIRED state — bootstrapping to 1 here would
                # flap the workload 0<->1 forever.
                return Recommendation(now, current, 0, "hold")
            # Empty pool bootstrap: nothing is serving and nothing is
            # scheduled to; bring up the floor.
            return Recommendation(
                now, current, self._clamp(cfg.min_replicas), "bootstrap")

        per_replica = self.model.update(
            signals,
            predicted_ttft_s=predicted_ttft_s,
            ttft_slo_s=ttft_slo_s,
        )
        demand = signals.admitted_per_s + signals.shed_per_s
        utilization = (
            demand / (per_replica * signals.ready_replicas)
            if signals.ready_replicas > 0 else float("inf")
        )

        # -- fast path: sustained pressure -> add capacity now ------------
        # Pressure is either sustained shed (users 429'd) or demand above
        # the SLO-derated capacity estimate (the predictor cross-check:
        # predicted TTFT past the SLO shrinks per_replica, pushing
        # utilization over 1.0 BEFORE hard shedding starts). Gated on the
        # requested capacity having MATERIALIZED (ready >= current): while
        # pods from the last step are still booting, pressure is expected
        # and re-asking every cycle would ratchet the spec toward
        # max_replicas blind — the next decision waits until the fleet it
        # already asked for is serving (this also neutralizes the
        # ready==0/current>0 window, where utilization is meaningless).
        shedding = signals.shed_per_s > cfg.shed_high_per_s
        if ((shedding or utilization > 1.0) and demand > 0.0
                and signals.ready_replicas >= current):
            if self._shed_since is None:
                self._shed_since = now
            if now - self._shed_since >= cfg.up_sustain_s:
                want = self.model.replicas_for(
                    demand, target_utilization=cfg.target_utilization)
                desired = self._clamp(
                    min(max(want, current + 1), current + cfg.max_up_step))
                if desired > current:
                    self._last_scale_at = now
                    reason = (
                        f"shed {signals.shed_per_s:.2f}/s > "
                        f"{cfg.shed_high_per_s}/s sustained" if shedding
                        else f"demand {demand:.2f}/s above capacity "
                             f"(utilization {utilization:.2f})")
                    return Recommendation(now, current, desired, reason)
        else:
            self._shed_since = None

        # -- slow path: cooldown-gated single-step scale-down -------------
        if (signals.shed_per_s == 0.0
                and utilization < cfg.scale_down_utilization
                and current > cfg.min_replicas
                and (self._last_scale_at is None
                     or now - self._last_scale_at >= cfg.down_cooldown_s)):
            self._last_scale_at = now
            return Recommendation(
                now, current, self._clamp(current - 1),
                f"utilization {utilization:.2f} < "
                f"{cfg.scale_down_utilization}")

        # -- hold (bounds still enforced on the way out) ------------------
        desired = self._clamp(current)
        if desired != current:
            self._last_scale_at = now
            return Recommendation(now, current, desired, "bounds-clamp")
        return Recommendation(now, current, current, "hold")
