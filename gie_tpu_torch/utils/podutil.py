"""Pod readiness + pool mapping helpers (copy of gie_tpu/utils/podutil.py;
reference pkg/lwepp/util/pod/pod.go and pkg/lwepp/util/pool/pool.go)."""

from __future__ import annotations

from gie_tpu_torch.api.types import InferencePool
from gie_tpu_torch.datastore.objects import EndpointPool, Pod


def is_pod_ready(pod: Pod) -> bool:
    """Ready condition true and not terminating (reference pod.go:24-36 +
    pod_reconciler.go deletionTimestamp eviction)."""
    return pod.ready and pod.deletionTimestamp is None and bool(pod.ip)


def to_endpoint_pool(pool: InferencePool) -> EndpointPool:
    """InferencePool -> scheduler-facing EndpointPool (reference
    pkg/lwepp/util/pool/pool.go:24-43)."""
    return EndpointPool(
        selector=dict(pool.spec.selector.matchLabels),
        target_ports=[p.number for p in pool.spec.targetPorts],
        namespace=pool.metadata.namespace,
        app_protocol=pool.spec.appProtocol,
    )
