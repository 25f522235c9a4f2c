"""InferencePool v1 API types (copy of the InferencePool half of
gie_tpu/api/types.py: field names, enums, defaults and validation as the
reference CRD) and the literal band names of the objective header (which
gie_tpu keeps in api/objectives.py). The pool's status (parent
conditions, export), the InferencePoolImport types and the manifest
(de)serializers come with the kube slice of the port.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from gie_tpu_torch.sched.constants import Criticality

GROUP = "inference.networking.k8s.io"
VERSION = "v1"

# Annotation enabling per-pod DP-rank port filtering
# (reference pkg/lwepp/datastore/datastore.go:59-64).
ACTIVE_PORTS_ANNOTATION = f"{GROUP}/active-ports"
# Pod label declaring the serving role for disaggregated prefill/decode
# ("prefill" | "decode" | "both"/absent). Reference analogue: none — the
# reference lists disaggregated serving as roadmap (README.md:115).
ROLE_LABEL = f"{GROUP}/role"


class ValidationError(ValueError):
    """Raised where the reference's CEL/structural CRD validation rejects."""


_LABEL_VALUE_RE = re.compile(r"^(([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9])?$")
_NAME_RE = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")


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

    apiVersion: str = f"{GROUP}/{VERSION}"
    kind: str = "InferencePool"

    def validate(self) -> None:
        self.metadata.validate()
        self.spec.validate()


# Literal band names accepted in the objective header (gie_tpu keeps this
# map in api/objectives.py beside its ObjectiveRegistry).
LITERAL_BANDS = {
    "critical": int(Criticality.CRITICAL),
    "standard": int(Criticality.STANDARD),
    "sheddable": int(Criticality.SHEDDABLE),
}
