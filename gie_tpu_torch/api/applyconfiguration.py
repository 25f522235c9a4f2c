"""Apply-configuration builders (the client-go applyconfiguration analogue)
(copy of gie_tpu/api/applyconfiguration.py).

Reference C3: client-go/applyconfiguration/* generates, per API type, a
sparse builder whose With* methods set only the fields the caller owns;
the resulting patch is sent as a server-side apply. The Python-native
equivalent: chainable `with_*` builders producing a SPARSE dict (absent
keys mean "not owned, leave alone"), plus the server-side-apply merge that
folds the patch onto the stored object — maps merge recursively, scalars
and lists replace (k8s SSA treats untyped lists as atomic).

Usage (mirrors the client-go flow):

    cfg = (InferencePoolApply("pool-a", "default")
           .with_spec(InferencePoolSpecApply()
                      .with_target_ports(8000, 8001)))
    client.server_side_apply(cfg)          # InferencePoolClient

Cited reference shape: client-go/applyconfiguration/api/v1/
inferencepool.go (WithName/WithNamespace/WithSpec...), consumed through
clientset.Apply(...).
"""

from __future__ import annotations

import copy
from typing import Optional

from gie_tpu_torch.api import types as api


def ssa_merge(base: dict, patch: dict) -> dict:
    """Server-side-apply merge: dict-on-dict recurses, everything else
    (scalars, lists) replaces. Returns a new dict; inputs untouched."""
    out = copy.deepcopy(base)
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = ssa_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class _Builder:
    """Sparse-dict builder base: only fields explicitly set appear."""

    def __init__(self) -> None:
        self._fields: dict = {}

    def _set(self, key: str, value):
        self._fields[key] = value
        return self

    def to_dict(self) -> dict:
        out = {}
        for k, v in self._fields.items():
            if isinstance(v, _Builder):
                v = v.to_dict()
            elif isinstance(v, list):
                v = [x.to_dict() if isinstance(x, _Builder) else x for x in v]
            out[k] = v
        return out


class TargetPortApply(_Builder):
    def __init__(self, number: Optional[int] = None):
        super().__init__()
        if number is not None:
            self.with_number(number)

    def with_number(self, number: int) -> "TargetPortApply":
        return self._set("number", int(number))


class EndpointPickerApply(_Builder):
    """EndpointPickerRef builder (reference EndpointPickerRefApplyConfiguration)."""

    def with_group(self, group: str) -> "EndpointPickerApply":
        return self._set("group", group)

    def with_kind(self, kind: str) -> "EndpointPickerApply":
        return self._set("kind", kind)

    def with_name(self, name: str) -> "EndpointPickerApply":
        return self._set("name", name)

    def with_port(self, number: int) -> "EndpointPickerApply":
        return self._set("port", {"number": int(number)})

    def with_failure_mode(self, mode: str) -> "EndpointPickerApply":
        return self._set("failureMode", mode)


class InferencePoolSpecApply(_Builder):
    def with_selector(self, match_labels: dict) -> "InferencePoolSpecApply":
        return self._set("selector", {"matchLabels": dict(match_labels)})

    def with_target_ports(self, *numbers: int) -> "InferencePoolSpecApply":
        return self._set(
            "targetPorts", [TargetPortApply(n) for n in numbers])

    def with_app_protocol(self, proto: str) -> "InferencePoolSpecApply":
        return self._set("appProtocol", proto)

    def with_endpoint_picker_ref(
        self, ref: EndpointPickerApply
    ) -> "InferencePoolSpecApply":
        return self._set("endpointPickerRef", ref)


class InferencePoolApply(_Builder):
    """Top-level builder (reference InferencePoolApplyConfiguration:
    name+namespace are the identity and always present, like client-go's
    constructor arguments)."""

    def __init__(self, name: str, namespace: str = "default"):
        super().__init__()
        self._set("apiVersion", f"{api.GROUP}/v1")
        self._set("kind", "InferencePool")
        self._set("metadata", {"name": name, "namespace": namespace})

    @property
    def name(self) -> str:
        return self._fields["metadata"]["name"]

    @property
    def namespace(self) -> str:
        return self._fields["metadata"]["namespace"]

    def with_labels(self, labels: dict) -> "InferencePoolApply":
        md = dict(self._fields["metadata"])
        md["labels"] = dict(labels)
        return self._set("metadata", md)

    def with_spec(self, spec: InferencePoolSpecApply) -> "InferencePoolApply":
        return self._set("spec", spec)


def apply_pool_configuration(
    existing: Optional[api.InferencePool], cfg: InferencePoolApply
) -> api.InferencePool:
    """The server's half of SSA: merge the sparse patch onto the stored
    object (or create from the patch alone) and re-validate. Returns the
    merged typed object; raises api.ValidationError like an apiserver
    admission failure."""
    base = api.pool_to_dict(existing) if existing is not None else {}
    merged = ssa_merge(base, cfg.to_dict())
    pool = api.pool_from_dict(merged)
    pool.validate()
    return pool
