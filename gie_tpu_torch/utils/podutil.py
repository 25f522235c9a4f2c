"""Pod readiness (is_pod_ready of gie_tpu/utils/podutil.py; reference
pkg/lwepp/util/pod/pod.go)."""

from __future__ import annotations

from gie_tpu_torch.datastore.objects import Pod


def is_pod_ready(pod: Pod) -> bool:
    """Ready condition true and not terminating (reference pod.go:24-36 +
    pod_reconciler.go deletionTimestamp eviction)."""
    return pod.ready and pod.deletionTimestamp is None and bool(pod.ip)
