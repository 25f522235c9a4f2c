"""Resource identity helpers (reference pkg/common/kubemeta.go:28-36)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GKNN:
    """Group/Kind + Namespace/Name identity of a resource."""

    group: str
    kind: str
    namespace: str
    name: str

    def __str__(self) -> str:
        return f"{self.group}/{self.kind}/{self.namespace}/{self.name}"
