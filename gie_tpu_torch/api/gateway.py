"""Minimal Gateway API object model for the conformance tier
(copy of gie_tpu/api/gateway.py).

The reference consumes these types from sigs.k8s.io/gateway-api; only the
surface the Inference Extension conformance suite exercises is modeled:
Gateway identity, HTTPRoute (hostnames, path matches, weighted backendRefs
to InferencePools or Services), Service (EPP backend resolution), and route
status conditions per parent.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from gie_tpu_torch.api.types import Condition

# Route condition types/reasons (gateway-api RouteConditionType).
ROUTE_ACCEPTED = "Accepted"
ROUTE_RESOLVED_REFS = "ResolvedRefs"
ROUTE_REASON_ACCEPTED = "Accepted"
ROUTE_REASON_BACKEND_NOT_FOUND = "BackendNotFound"


@dataclasses.dataclass
class Gateway:
    name: str
    namespace: str = "default"
    gateway_class: str = "gie-tpu"


@dataclasses.dataclass
class Service:
    """EPP Service (resolution target of EndpointPickerRef)."""

    name: str
    namespace: str = "default"
    port: int = 9002


@dataclasses.dataclass
class BackendRef:
    name: str
    kind: str = "InferencePool"       # InferencePool | Service
    group: str = "inference.networking.k8s.io"
    port: Optional[int] = None
    weight: int = 1


@dataclasses.dataclass
class RouteRule:
    path_prefix: str = "/"
    backend_refs: list[BackendRef] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RouteParentStatus:
    gateway: str
    conditions: list[Condition] = dataclasses.field(default_factory=list)

    def set_condition(self, cond: Condition) -> None:
        for i, c in enumerate(self.conditions):
            if c.type == cond.type:
                self.conditions[i] = cond
                return
        self.conditions.append(cond)

    def get_condition(self, ctype: str) -> Optional[Condition]:
        for c in self.conditions:
            if c.type == ctype:
                return c
        return None


@dataclasses.dataclass
class HTTPRoute:
    name: str
    namespace: str = "default"
    hostnames: list[str] = dataclasses.field(default_factory=list)
    parent_gateways: list[str] = dataclasses.field(default_factory=list)
    rules: list[RouteRule] = dataclasses.field(default_factory=list)
    status: list[RouteParentStatus] = dataclasses.field(default_factory=list)

    def parent_status(self, gateway: str) -> RouteParentStatus:
        for ps in self.status:
            if ps.gateway == gateway:
                return ps
        ps = RouteParentStatus(gateway=gateway)
        self.status.append(ps)
        return ps
