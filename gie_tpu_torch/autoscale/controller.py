"""AutoscaleController: the loop gluing signals -> model -> recommender ->
actuator together (copy of gie_tpu/autoscale/controller.py).

`step()` is one synchronous control cycle (the closed-loop simulator test
drives it with a virtual clock); `start()/stop()` wrap it in the runner's
background thread with a wall-clock interval.
"""

from __future__ import annotations

import threading
from typing import Optional

from gie_tpu_torch.runtime.clock import REALTIME
from gie_tpu_torch.autoscale.actuator import ReplicaActuator
from gie_tpu_torch.autoscale.recommender import AutoscaleRecommender, Recommendation
from gie_tpu_torch.autoscale.signals import SignalCollector
from gie_tpu_torch.runtime import metrics as own_metrics
from gie_tpu_torch.runtime.logging import get_logger


class AutoscaleController:
    def __init__(
        self,
        collector: SignalCollector,
        recommender: AutoscaleRecommender,
        actuator: ReplicaActuator,
        *,
        interval_s: float = 2.0,
        ttft_probe=None,
        is_leader=None,
    ):
        self.collector = collector
        self.recommender = recommender
        self.actuator = actuator
        self.interval_s = interval_s
        # Optional () -> bool leadership gate. A FOLLOWER's pick counters
        # never move (its ext-proc readiness is NOT_SERVING), so its view
        # is "fresh metrics, zero traffic" — which the recommender reads
        # as utilization 0 and turns into a standing scale-down export.
        # Only the leader may recommend; followers keep sampling so their
        # counter baselines stay windowed for the moment they promote.
        self.is_leader = is_leader
        # Optional () -> (predicted_ttft_s, ttft_slo_s) | None: the latency
        # predictor's pool-typical TTFT forecast (runner wiring). Feeds the
        # capacity model's SLO derate so scale-up starts while answers are
        # merely LATE, before hard shedding.
        self.ttft_probe = ttft_probe
        self.log = get_logger("autoscale")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def step(self, now: Optional[float] = None) -> Optional[Recommendation]:
        """One control cycle; returns the recommendation (None while the
        collector is still establishing its first rate window)."""
        now = REALTIME() if now is None else now
        signals = self.collector.sample(now)
        if signals is None:
            return None
        if self.is_leader is not None and not self.is_leader():
            # Follower: sample (baselines stay fresh for promotion) but
            # never recommend/export/actuate on zero-traffic counters.
            return None
        # Recommend against the CONFIGURED replica count when a scale
        # target exists (re-asking while pods come up would overshoot);
        # fall back to the observed ready count in recommend-only mode.
        current = self.actuator.current_replicas()
        if current is None:
            current = signals.ready_replicas
        probe = None
        if self.ttft_probe is not None:
            try:
                probe = self.ttft_probe()
            except Exception as e:  # the probe must never stall the loop
                self.log.v(3).info("autoscale ttft probe failed", err=str(e))
        rec = self.recommender.observe(
            signals, current, now,
            predicted_ttft_s=probe[0] if probe else None,
            ttft_slo_s=probe[1] if probe else None,
        )
        own_metrics.AUTOSCALE_CURRENT.set(current)
        own_metrics.AUTOSCALE_DESIRED.set(rec.desired)
        own_metrics.AUTOSCALE_CAPACITY.set(
            self.recommender.model.per_replica())
        own_metrics.AUTOSCALE_SHED_RATE.set(signals.shed_per_s)
        own_metrics.AUTOSCALE_STALE.set(1.0 if signals.stale else 0.0)
        own_metrics.AUTOSCALE_RECS.labels(direction=rec.direction).inc()
        self.actuator.apply(rec)
        return rec

    # -- runner lifecycle --------------------------------------------------

    def start(self) -> None:
        self._stop.clear()  # restartable: a prior stop() must not leak in
        self._thread = threading.Thread(
            target=self._loop, name="autoscale", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception as e:  # the loop must never take the EPP down
                self.log.error("autoscale step failed", err=e)
