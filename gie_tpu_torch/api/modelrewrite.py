"""InferenceModelRewrite API + matching engine
(copy of gie_tpu/api/modelrewrite.py).

Port of reference docs/proposals/1816-inferenceomodelrewrite/README.md:33-145:
per-pool ordered rewrite rules matching the request body's `model` field,
with weighted targets (traffic split / canary) and the mandated precedence:
Exact match > generic (empty matches); ties across resources -> oldest
creation timestamp; ties within a resource -> first rule in list order.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional


@dataclasses.dataclass
class TargetModel:
    modelRewrite: str
    weight: int = 1


@dataclasses.dataclass
class ModelMatch:
    value: str
    type: str = "Exact"


@dataclasses.dataclass
class RewriteRule:
    matches: list[ModelMatch] = dataclasses.field(default_factory=list)
    targets: list[TargetModel] = dataclasses.field(default_factory=list)

    def matches_model(self, model: str) -> bool:
        if not self.matches:
            return True  # generic rule matches all
        return any(m.value == model for m in self.matches)

    @property
    def is_exact(self) -> bool:
        return bool(self.matches)


@dataclasses.dataclass
class InferenceModelRewrite:
    name: str
    pool_ref: str
    rules: list[RewriteRule]
    namespace: str = "default"
    creation_index: int = 0  # ordinal stand-in for creationTimestamp


class RewriteEngine:
    """Merged view of every InferenceModelRewrite targeting a pool."""

    def __init__(self, seed: int = 0):
        self._rewrites: dict[tuple[str, str], InferenceModelRewrite] = {}
        self._counter = 0
        self._rng = random.Random(seed)

    def apply(self, rw: InferenceModelRewrite) -> None:
        key = (rw.namespace, rw.name)
        if key not in self._rewrites:
            rw.creation_index = self._counter
            self._counter += 1
        else:  # updates keep the original creation order
            rw.creation_index = self._rewrites[key].creation_index
        self._rewrites[key] = rw

    def delete(self, namespace: str, name: str) -> None:
        self._rewrites.pop((namespace, name), None)

    def resolve(self, pool: str, model: str, namespace: str = "default") -> Optional[str]:
        """Rewritten model name for `model` on `pool`, or None if no rule
        matches. Precedence per the proposal (1816 README:65-79)."""
        candidates: list[tuple[int, int, RewriteRule]] = []
        for rw in self._rewrites.values():
            if rw.namespace != namespace or rw.pool_ref != pool:
                continue
            for idx, rule in enumerate(rw.rules):
                if rule.matches_model(model):
                    candidates.append((rw.creation_index, idx, rule))
        if not candidates:
            return None
        exact = [c for c in candidates if c[2].is_exact]
        pool_c = exact if exact else candidates
        pool_c.sort(key=lambda c: (c[0], c[1]))  # oldest resource, first rule
        rule = pool_c[0][2]
        if not rule.targets:
            return None
        total = sum(max(t.weight, 0) for t in rule.targets)
        if total <= 0:
            return rule.targets[0].modelRewrite
        x = self._rng.uniform(0, total)
        acc = 0.0
        for t in rule.targets:
            acc += max(t.weight, 0)
            if x <= acc:
                return t.modelRewrite
        return rule.targets[-1].modelRewrite
