"""InferencePool v1 and InferencePoolImport v1alpha1 API types (copy of
gie_tpu/api/types.py: field names, enums, defaults and validation as the
reference CRDs): the pool's spec and status (parent conditions, the
Exported condition), the import types the multi-cluster controller
materializes, their manifest (de)serializers, and the literal band names
of the objective header (which gie_tpu keeps in api/objectives.py). The
Gateway API types the conformance harness routes with are in
api/gateway.py.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

from gie_tpu_torch.sched.constants import Criticality

GROUP = "inference.networking.k8s.io"
GROUP_X = "inference.networking.x-k8s.io"
VERSION = "v1"
VERSION_X = "v1alpha1"

# Annotation enabling per-pod DP-rank port filtering
# (reference pkg/lwepp/datastore/datastore.go:59-64).
ACTIVE_PORTS_ANNOTATION = f"{GROUP}/active-ports"
# Pod label declaring the serving role for disaggregated prefill/decode
# ("prefill" | "decode" | "both"/absent). Reference analogue: none — the
# reference lists disaggregated serving as roadmap (README.md:115).
ROLE_LABEL = f"{GROUP}/role"
# Annotation requesting multi-cluster export
# (reference apix/v1alpha1/shared_types.go:19-24).
EXPORT_ANNOTATION = f"{GROUP_X}/export"
EXPORT_SCOPE_CLUSTERSET = "ClusterSet"


class ValidationError(ValueError):
    """Raised where the reference's CEL/structural CRD validation rejects."""


_LABEL_VALUE_RE = re.compile(r"^(([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9])?$")
_NAME_RE = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")



# ---------------------------------------------------------------------------
# Conditions (reference api/v1/inferencepool_types.go:274-379)
# ---------------------------------------------------------------------------

COND_ACCEPTED = "Accepted"
REASON_ACCEPTED = "Accepted"
REASON_NOT_SUPPORTED_BY_PARENT = "NotSupportedByParent"
REASON_HTTPROUTE_NOT_ACCEPTED = "HTTPRouteNotAccepted"
REASON_EPP_REF_MISSING = "EndpointPickerRefMissing"

COND_RESOLVED_REFS = "ResolvedRefs"
REASON_RESOLVED_REFS = "ResolvedRefs"
REASON_INVALID_EXTENSION_REF = "InvalidExtensionRef"

COND_EXPORTED = "Exported"
REASON_EXPORTED = "Exported"
REASON_NOT_REQUESTED = "NotRequested"
REASON_NOT_SUPPORTED = "NotSupported"

REASON_PENDING = "Pending"

# Default parent controller identity for gateways
DEFAULT_PARENT_GROUP = "gateway.networking.k8s.io"
DEFAULT_PARENT_KIND = "Gateway"


@dataclasses.dataclass
class Condition:
    """metav1.Condition subset."""

    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    observedGeneration: int = 0
    lastTransitionTime: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Spec types
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LabelSelector:
    """matchLabels-only selector (reference api/v1/shared_types.go:134-143 —
    matchExpressions deliberately unsupported)."""

    matchLabels: dict[str, str] = dataclasses.field(default_factory=dict)

    def validate(self) -> None:
        for k, v in self.matchLabels.items():
            if len(k) == 0 or len(k) > 316:
                raise ValidationError(f"invalid label key {k!r}")
            if len(v) > 63 or not _LABEL_VALUE_RE.match(v):
                raise ValidationError(f"invalid label value {v!r}")

    def matches(self, labels: dict[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in self.matchLabels.items())


@dataclasses.dataclass
class Port:
    number: int = 0

    def validate(self) -> None:
        if not (1 <= self.number <= 65535):
            raise ValidationError(
                f"port number {self.number} must be in 1-65535"
            )


FAIL_OPEN = "FailOpen"
FAIL_CLOSE = "FailClose"
FailureMode = str


@dataclasses.dataclass
class EndpointPickerRef:
    """Reference to the EPP service (reference
    api/v1/inferencepool_types.go:129-189)."""

    name: str = ""
    group: str = ""           # default "" = core
    kind: str = "Service"     # default Service
    port: Optional[Port] = None
    failureMode: FailureMode = FAIL_CLOSE

    def validate(self) -> None:
        if not self.name:
            raise ValidationError("endpointPickerRef.name is required")
        # CEL: self.kind != 'Service' || has(self.port)
        # (reference inferencepool_types.go:128)
        if self.kind == "Service" and self.port is None:
            raise ValidationError(
                "port is required when kind is 'Service' or unspecified "
                "(defaults to 'Service')"
            )
        if self.port is not None:
            self.port.validate()
        if self.failureMode not in (FAIL_OPEN, FAIL_CLOSE):
            raise ValidationError(
                f"failureMode must be FailOpen or FailClose, got {self.failureMode!r}"
            )


APP_PROTOCOL_HTTP = "http"
APP_PROTOCOL_H2C = "kubernetes.io/h2c"


@dataclasses.dataclass
class InferencePoolSpec:
    """reference api/v1/inferencepool_types.go:60-101."""

    selector: LabelSelector = dataclasses.field(default_factory=LabelSelector)
    targetPorts: list[Port] = dataclasses.field(default_factory=list)
    appProtocol: str = APP_PROTOCOL_HTTP
    endpointPickerRef: Optional[EndpointPickerRef] = None

    def validate(self) -> None:
        self.selector.validate()
        # MinItems=1 MaxItems=8 + uniqueness CEL
        # (reference inferencepool_types.go:76-78)
        if not (1 <= len(self.targetPorts) <= 8):
            raise ValidationError(
                f"targetPorts must have 1-8 items, got {len(self.targetPorts)}"
            )
        numbers = [p.number for p in self.targetPorts]
        if len(set(numbers)) != len(numbers):
            raise ValidationError("port number must be unique")
        for p in self.targetPorts:
            p.validate()
        if self.appProtocol not in (APP_PROTOCOL_HTTP, APP_PROTOCOL_H2C):
            raise ValidationError(
                f"appProtocol must be 'http' or 'kubernetes.io/h2c', "
                f"got {self.appProtocol!r}"
            )
        if self.endpointPickerRef is not None:
            self.endpointPickerRef.validate()


# ---------------------------------------------------------------------------
# Status types
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ParentReference:
    """reference api/v1/inferencepool_types.go:383-413."""

    name: str = ""
    group: str = DEFAULT_PARENT_GROUP
    kind: str = DEFAULT_PARENT_KIND
    namespace: str = ""


@dataclasses.dataclass
class ParentStatus:
    """Per-parent conditions (reference inferencepool_types.go:210-232;
    max 8 conditions per parent, max 32 parents)."""

    parentRef: ParentReference = dataclasses.field(default_factory=ParentReference)
    conditions: list[Condition] = dataclasses.field(default_factory=list)

    def set_condition(self, cond: Condition) -> None:
        for i, c in enumerate(self.conditions):
            if c.type == cond.type:
                self.conditions[i] = cond
                return
        if len(self.conditions) >= 8:
            raise ValidationError("at most 8 conditions per parent")
        self.conditions.append(cond)

    def get_condition(self, ctype: str) -> Optional[Condition]:
        for c in self.conditions:
            if c.type == ctype:
                return c
        return None


@dataclasses.dataclass
class InferencePoolStatus:
    parents: list[ParentStatus] = dataclasses.field(default_factory=list)

    def validate(self) -> None:
        if len(self.parents) > 32:
            raise ValidationError("at most 32 parents")


@dataclasses.dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)
    generation: int = 1
    deletionTimestamp: Optional[str] = None

    def validate(self) -> None:
        if not self.name or len(self.name) > 253 or not _NAME_RE.match(self.name):
            raise ValidationError(f"invalid object name {self.name!r}")


@dataclasses.dataclass
class InferencePool:
    """reference api/v1/inferencepool_types.go:32-48."""

    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    spec: InferencePoolSpec = dataclasses.field(default_factory=InferencePoolSpec)
    status: InferencePoolStatus = dataclasses.field(
        default_factory=InferencePoolStatus
    )

    apiVersion: str = f"{GROUP}/{VERSION}"
    kind: str = "InferencePool"

    def validate(self) -> None:
        self.metadata.validate()
        self.spec.validate()
        self.status.validate()

    @property
    def export_requested(self) -> bool:
        return (
            self.metadata.annotations.get(EXPORT_ANNOTATION)
            == EXPORT_SCOPE_CLUSTERSET
        )


# ---------------------------------------------------------------------------
# InferencePoolImport (reference apix/v1alpha1/inferencepoolimport_types.go)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExportingCluster:
    """reference apix/v1alpha1/inferencepoolimport_types.go:138-150."""

    name: str = ""


@dataclasses.dataclass
class ImportController:
    """reference apix/v1alpha1/inferencepoolimport_types.go:66-110."""

    name: str = ""
    exportingClusters: list[ExportingCluster] = dataclasses.field(
        default_factory=list
    )
    parents: list[ParentStatus] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class InferencePoolImportStatus:
    controllers: list[ImportController] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class InferencePoolImport:
    """Status-only CRD materialized by multi-cluster controllers when a pool
    is exported (reference apix/v1alpha1/inferencepoolimport_types.go:32-60,
    docs/proposals/1374-multi-cluster-inference/README.md:36-53)."""

    metadata: ObjectMeta = dataclasses.field(default_factory=ObjectMeta)
    status: InferencePoolImportStatus = dataclasses.field(
        default_factory=InferencePoolImportStatus
    )
    apiVersion: str = f"{GROUP_X}/{VERSION_X}"
    kind: str = "InferencePoolImport"

    def validate(self) -> None:
        self.metadata.validate()


# ---------------------------------------------------------------------------
# (De)serialization — k8s-manifest-shaped dicts
# ---------------------------------------------------------------------------


def clean_manifest(d: Any) -> Any:
    """Prune empties from a manifest-shaped dict tree (shared by every
    serializer that emits k8s patch/apply bodies)."""
    if isinstance(d, dict):
        return {
            k: clean_manifest(v)
            for k, v in d.items()
            if v not in (None, "", [], {})
        }
    if isinstance(d, list):
        return [clean_manifest(x) for x in d]
    return d


_clean = clean_manifest


def pool_to_dict(pool: InferencePool) -> dict:
    d = dataclasses.asdict(pool)
    d["apiVersion"] = pool.apiVersion
    d["kind"] = pool.kind
    return _clean(d)


def _status_from_dict(status: dict) -> InferencePoolStatus:
    """Parse status.parents (needed so controllers can carry forward
    lastTransitionTime instead of re-stamping unchanged conditions)."""
    parents = []
    for p in status.get("parents", []) or []:
        ref = p.get("parentRef", {}) or {}
        ps = ParentStatus(parentRef=ParentReference(
            name=ref.get("name", ""),
            group=ref.get("group", DEFAULT_PARENT_GROUP),
            kind=ref.get("kind", DEFAULT_PARENT_KIND),
            namespace=ref.get("namespace", ""),
        ))
        for c in p.get("conditions", []) or []:
            ps.conditions.append(Condition(
                type=c.get("type", ""),
                status=c.get("status", ""),
                reason=c.get("reason", ""),
                message=c.get("message", ""),
                observedGeneration=c.get("observedGeneration", 0),
                lastTransitionTime=c.get("lastTransitionTime", ""),
            ))
        parents.append(ps)
    return InferencePoolStatus(parents=parents)


def pool_from_dict(d: dict) -> InferencePool:
    meta = d.get("metadata", {})
    spec = d.get("spec", {})
    epp = spec.get("endpointPickerRef")
    pool = InferencePool(
        metadata=ObjectMeta(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            labels=dict(meta.get("labels", {})),
            annotations=dict(meta.get("annotations", {})),
            generation=meta.get("generation", 1),
        ),
        spec=InferencePoolSpec(
            selector=LabelSelector(
                matchLabels=dict(spec.get("selector", {}).get("matchLabels", {}))
            ),
            targetPorts=[
                Port(number=p.get("number", 0)) for p in spec.get("targetPorts", [])
            ],
            appProtocol=spec.get("appProtocol", APP_PROTOCOL_HTTP),
            endpointPickerRef=(
                EndpointPickerRef(
                    name=epp.get("name", ""),
                    group=epp.get("group", ""),
                    kind=epp.get("kind", "Service"),
                    port=(
                        Port(number=epp["port"]["number"])
                        if epp.get("port")
                        else None
                    ),
                    failureMode=epp.get("failureMode", FAIL_CLOSE),
                )
                if epp
                else None
            ),
        ),
    )
    pool.status = _status_from_dict(d.get("status", {}) or {})
    return pool


def import_to_dict(imp: InferencePoolImport) -> dict:
    """InferencePoolImport -> k8s-manifest-shaped dict (the multi-cluster
    controller writes these to importing clusters; docs/FEDERATION.md)."""
    d = dataclasses.asdict(imp)
    d["apiVersion"] = imp.apiVersion
    d["kind"] = imp.kind
    # A status-only CRD: clean_manifest would prune an EMPTY controllers
    # list, but a present-and-empty status is the valid initial shape.
    out = _clean(d)
    out.setdefault("status", {})
    return out


def import_from_dict(d: dict) -> InferencePoolImport:
    meta = d.get("metadata", {}) or {}
    status = d.get("status", {}) or {}
    controllers = []
    for c in status.get("controllers", []) or []:
        controllers.append(ImportController(
            name=c.get("name", ""),
            exportingClusters=[
                ExportingCluster(name=e.get("name", ""))
                for e in c.get("exportingClusters", []) or []
            ],
        ))
    return InferencePoolImport(
        metadata=ObjectMeta(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            labels=dict(meta.get("labels", {})),
            annotations=dict(meta.get("annotations", {})),
        ),
        status=InferencePoolImportStatus(controllers=controllers),
    )


# Literal band names accepted in the objective header (gie_tpu keeps this
# map in api/objectives.py beside its ObjectiveRegistry).
LITERAL_BANDS = {
    "critical": int(Criticality.CRITICAL),
    "standard": int(Criticality.STANDARD),
    "sheddable": int(Criticality.SHEDDABLE),
}
