"""InferenceObjective API + registry (copy of gie_tpu/api/objectives.py).

Port of reference docs/proposals/1199-inferencemodel-api-evolution/README.md:
named request-objective objects per pool carrying an integer criticality
("int carries inherent stack rank value"); requests select an objective by
name via the `x-gateway-inference-objective` header and inherit its band.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from gie_tpu_torch.api.types import LITERAL_BANDS
from gie_tpu_torch.sched.constants import Criticality


@dataclasses.dataclass
class InferenceObjective:
    name: str
    pool_ref: str
    criticality: int = 1      # higher = more critical (stack-rank value)
    namespace: str = "default"


def band_for(criticality: int) -> int:
    """Map the open-ended stack-rank int onto the scheduler's three bands:
    >= 2 CRITICAL, 1 STANDARD, <= 0 SHEDDABLE."""
    if criticality >= 2:
        return int(Criticality.CRITICAL)
    if criticality <= 0:
        return int(Criticality.SHEDDABLE)
    return int(Criticality.STANDARD)


class ObjectiveRegistry:
    """Name -> objective lookup for the request path. The objective header
    carries either a registered objective NAME or (back-compat) a literal
    band name ('critical'/'standard'/'sheddable')."""

    _LITERALS = LITERAL_BANDS

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # Keyed by objective NAME: the registry instance is already scoped
        # to one EPP / one pool, matching how the header carries bare names.
        self._objectives: dict[str, InferenceObjective] = {}

    def apply(self, obj: InferenceObjective) -> None:
        with self._lock:
            self._objectives[obj.name] = obj

    def delete(self, namespace: str, name: str) -> None:
        with self._lock:
            self._objectives.pop(name, None)

    def resolve_band(self, header_value: str) -> Optional[int]:
        """Scheduler band for an objective header value, or None when the
        value names nothing known (callers default to STANDARD)."""
        value = header_value.strip()
        if not value:
            return None
        with self._lock:
            obj = self._objectives.get(value)
        if obj is not None:
            return band_for(obj.criticality)
        return self._LITERALS.get(value.lower())
