"""Reconcile layer: watch events -> datastore updates."""

from gie_tpu_torch.controller.cluster import FakeCluster, WatchEvent
from gie_tpu_torch.controller.reconcilers import (
    InferencePoolReconciler,
    PodReconciler,
    RequeueAfter,
)

__all__ = [
    "FakeCluster",
    "WatchEvent",
    "InferencePoolReconciler",
    "PodReconciler",
    "RequeueAfter",
]
