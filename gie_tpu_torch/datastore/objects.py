"""(Copy of gie_tpu/datastore/objects.py, imports rewritten to gie_tpu_torch.)

Kube-facing object model for the data layer.

Light-weight equivalents of the corev1.Pod fields the reference consumes and
its datastore structs (reference pkg/lwepp/datastore/datastore.go:40-52).
The TPU addition is `Endpoint.slot`: a stable dense index into the scheduler's
fixed [0, M_MAX) endpoint axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Pod:
    """The subset of corev1.Pod the EPP consumes (reference
    pkg/lwepp/util/pod/pod.go:24-36 readiness; datastore annotations use)."""

    name: str
    namespace: str = "default"
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)
    ip: str = ""
    ready: bool = True
    deletionTimestamp: Optional[str] = None


@dataclasses.dataclass
class EndpointPool:
    """Scheduler-facing pool view (reference datastore.go:48-52; built from
    an InferencePool by pool_util.to_endpoint_pool, the analogue of
    pkg/lwepp/util/pool/pool.go:24-43)."""

    selector: dict[str, str]
    target_ports: list[int]
    namespace: str
    app_protocol: str = "http"  # "http" | "kubernetes.io/h2c"


@dataclasses.dataclass
class Endpoint:
    """One (pod, rank) endpoint (reference datastore.go:40-46; rank naming
    `<pod>-rank-<idx>` per createEndpointNamespacedName datastore.go:329-334).
    """

    name: str            # "<pod>-rank-<idx>"
    namespace: str
    pod_name: str
    address: str         # pod IP
    port: int
    rank: int            # index into pool.target_ports
    slot: int            # dense scheduler slot in [0, M_MAX)
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    # Graceful drain (docs/RESILIENCE.md): a pod entering rolling-upgrade
    # termination (deletionTimestamp) or going NotReady while serving is
    # DRAINED, not hard-evicted — the slot leaves new-pick candidacy
    # while in-flight waves and open streams complete, then reclaims at
    # drain_until (monotonic) or on actual pod deletion, whichever first.
    draining: bool = False
    drain_until: float = 0.0
    # Multi-cluster federation (docs/FEDERATION.md): non-empty names the
    # peer cluster this endpoint was IMPORTED from (InferencePoolImport,
    # Endpoint routing mode). Imported endpoints share the local slot
    # space and metrics rows but are excluded from default new-pick
    # candidacy (the spill policy adds them), from pod reconciliation,
    # and from the scrape engine (their rows come from peer digests).
    cluster: str = ""

    @property
    def hostport(self) -> str:
        return f"{self.address}:{self.port}"
