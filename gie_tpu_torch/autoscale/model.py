"""CapacityModel: online per-replica capacity estimation (copy of
gie_tpu/autoscale/model.py; its checkpoint is the port's `.npz`,
utils/checkpoint.py, where the reference writes orbax).

Gavel (arXiv:2008.09213) and Tesserae both observe that scheduler-internal
throughput signals beat external utilization proxies for capacity
decisions; the same holds here. The only moment the gateway can OBSERVE
capacity (rather than demand) is when the pool runs near saturation: below
it, admitted throughput measures offered load, not what a replica can do.
So the model EWMAs admitted-picks-per-replica only over near-saturation
samples, and holds the last converged estimate otherwise.

The latency predictor cross-check: throughput at saturation can still be
throughput of LATE answers. When the caller supplies a predicted TTFT and
an SLO, an estimate measured while predictions exceed the SLO is derated
by the headroom ratio — the pool's "capacity" for goodput purposes is
what it serves within the SLO, so the recommender asks for more replicas.
Derating applies to the returned estimate, never the EWMA itself: the raw
observation stays unpoisoned for when latency recovers.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from gie_tpu_torch.autoscale.signals import PoolSignals


class CapacityModel:
    def __init__(
        self,
        *,
        alpha: float = 0.3,
        default_per_replica: float = 8.0,
        min_per_replica: float = 0.1,
        saturation_threshold: float = 0.5,
    ):
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self.default_per_replica = default_per_replica
        self.min_per_replica = min_per_replica
        self.saturation_threshold = saturation_threshold
        self._ewma: Optional[float] = None
        self._slo_derate = 1.0

    def update(
        self,
        signals: PoolSignals,
        *,
        predicted_ttft_s: Optional[float] = None,
        ttft_slo_s: Optional[float] = None,
    ) -> float:
        """Fold one sample in; returns the current per-replica estimate."""
        near_saturation = (
            signals.saturated_fraction >= self.saturation_threshold
            or signals.shed_per_s > 0.0
        )
        if (not signals.stale and near_saturation
                and signals.ready_replicas > 0
                and signals.admitted_per_s > 0.0):
            observed = signals.admitted_per_s / signals.ready_replicas
            self._ewma = (
                observed if self._ewma is None
                else self.alpha * observed + (1.0 - self.alpha) * self._ewma
            )
        self._slo_derate = 1.0
        if (predicted_ttft_s is not None and ttft_slo_s is not None
                and ttft_slo_s > 0.0 and predicted_ttft_s > ttft_slo_s):
            self._slo_derate = ttft_slo_s / predicted_ttft_s
        return self.per_replica()

    def per_replica(self) -> float:
        """Current per-replica capacity estimate (requests/s), SLO-derated."""
        base = (self._ewma if self._ewma is not None
                else self.default_per_replica)
        return max(base * self._slo_derate, self.min_per_replica)

    @property
    def converged(self) -> bool:
        """True once at least one near-saturation observation landed."""
        return self._ewma is not None

    # -- persistence + replication (ROADMAP: a restarted EPP must not
    # re-learn capacity from the default) ---------------------------------

    def export_state(self) -> dict:
        """Replication digest "autoscale" section: the raw capacity EWMA
        (NaN while unconverged — the honest encoding of "no estimate",
        distinct from any real capacity). The SLO derate is deliberately
        NOT carried: it is recomputed from the live predictor every cycle,
        and a follower inheriting a stale derate would double-count."""
        return {"ewma": np.float32(
            np.nan if self._ewma is None else self._ewma)}

    def prepare_install(self, arrays: dict) -> Optional[float]:
        """Validation half of install_state (NaN stands in for
        "unconverged" so the staged value is never None on success)."""
        try:
            v = float(np.asarray(arrays["ewma"]).reshape(()))
        except (KeyError, TypeError, ValueError):
            return None
        return v

    def commit_install(self, staged: float) -> None:
        """Non-finite or non-positive values install as "unconverged"
        rather than poisoning replicas_for with a zero divisor."""
        self._ewma = (
            staged if np.isfinite(staged) and staged > 0.0 else None)

    def install_state(self, arrays: dict) -> bool:
        """Validated inverse of export_state; returns False (prior state
        kept) on malformation."""
        staged = self.prepare_install(arrays)
        if staged is None:
            return False
        self.commit_install(staged)
        return True

    def save(self, directory: str) -> None:
        """Persist the EWMA through the shared `.npz` helpers (leader
        shutdown hook): a restarted single-replica EPP — no standby to
        promote — seeds from the last converged estimate instead of
        default_per_replica."""
        from gie_tpu_torch.utils.checkpoint import save_pytree

        save_pytree(directory, self.export_state())

    def restore(self, directory: str) -> bool:
        from gie_tpu_torch.utils.checkpoint import restore_pytree

        restored = restore_pytree(
            directory, {"ewma": np.float32(np.nan)})
        if restored is None:
            return False
        return self.install_state(restored)

    def replicas_for(
        self, demand_per_s: float, *, target_utilization: float = 0.75
    ) -> int:
        """Replicas needed to serve `demand_per_s` at the target
        utilization (the headroom that keeps queues short between
        recommendation cycles)."""
        if demand_per_s <= 0.0:
            return 0
        per = self.per_replica() * max(min(target_utilization, 1.0), 1e-6)
        return int(math.ceil(demand_per_s / per))
