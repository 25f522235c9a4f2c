"""Autoscaling recommender: closed-loop capacity control from live
scheduler signals (port of gie_tpu/autoscale/).

  signals.py     — PoolSignals derived from MetricsStore + the runtime
                   counters (shed/evict rates, pipeline occupancy,
                   device-wait share, staleness)
  model.py       — CapacityModel: online EWMA of per-replica goodput
                   observed near saturation
  recommender.py — hysteresis-bounded replica recommendations (fast
                   scale-up on sustained shed, slow cooldown-gated
                   scale-down, min/max bounds, flap damping)
  actuator.py    — the leader-gated SSA patch of the Deployment's
                   spec.replicas through the kube client, or a dry run
  controller.py  — the loop gluing the four together for the runner
"""

from gie_tpu_torch.autoscale.actuator import ReplicaActuator
from gie_tpu_torch.autoscale.controller import AutoscaleController
from gie_tpu_torch.autoscale.model import CapacityModel
from gie_tpu_torch.autoscale.recommender import (
    AutoscaleRecommender,
    Recommendation,
    RecommenderConfig,
)
from gie_tpu_torch.autoscale.signals import PoolSignals, SignalCollector

__all__ = [
    "AutoscaleController",
    "AutoscaleRecommender",
    "CapacityModel",
    "PoolSignals",
    "Recommendation",
    "RecommenderConfig",
    "ReplicaActuator",
    "SignalCollector",
]
