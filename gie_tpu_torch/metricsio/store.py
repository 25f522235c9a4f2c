"""MetricsStore: the dense endpoint-metrics sink (port of
gie_tpu/metricsio/store.py).

The reference's data layer stores scraped PodMetrics per endpoint object
(reference docs/proposals/1023-data-layer-architecture/README.md:104-164
Endpoint.Store/GetAttributes). Here the store IS the tensor: per-slot rows of
a float32 [M_MAX, NUM_METRICS] matrix plus LoRA residency slots, snapshotted
into an EndpointBatch for the scheduler in O(1) copies. The snapshot is
CPU tensors over its numpy copy; the Scheduler moves it to its device.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from gie_tpu_torch.api.types import ROLE_LABEL
from gie_tpu_torch.datastore.objects import Endpoint
from gie_tpu_torch.runtime.clock import REALTIME
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.types import EndpointBatch

# Pod-label value -> Role column value (unknown/absent -> BOTH).
_ROLE_BY_LABEL = {
    "prefill": int(C.Role.PREFILL),
    "decode": int(C.Role.DECODE),
    "both": int(C.Role.BOTH),
}


class MetricsStore:
    def __init__(self, clock: Callable[[], float] = REALTIME) -> None:
        # Clock seam (gie_tpu/runtime/clock.py): row freshness stamps.
        # Default is wall time (the store's historical convention); a
        # virtual-time storm passes its own clock so row ages and the
        # staleness verdicts derived from them live on the simulated
        # timeline.
        self._clock = clock
        self._lock = threading.Lock()
        self._metrics = np.zeros((C.M_MAX, C.NUM_METRICS), np.float32)
        self._lora_active = np.full((C.M_MAX, C.LORA_SLOTS), -1, np.int32)
        self._lora_waiting = np.full((C.M_MAX, C.LORA_SLOTS), -1, np.int32)
        self._scraped_at = np.zeros((C.M_MAX,), np.float64)
        self._has_data = np.zeros((C.M_MAX,), bool)
        # Scale-from-zero wake signal (ROADMAP): arrivals that found an
        # EMPTY pool (the ext-proc layer 503s them before any endpoint
        # state exists to scrape). The autoscale SignalCollector drains
        # this counter into PoolSignals.wake_arrivals each window.
        self._wake_arrivals = 0

    def update(
        self,
        slot: int,
        metrics: dict[int, float],
        lora_active: Sequence[int] = (),
        lora_waiting: Sequence[int] = (),
        now: Optional[float] = None,
    ) -> None:
        """Record one endpoint's scrape result (metric-column -> value)."""
        now = self._clock() if now is None else now
        with self._lock:
            self._apply_locked(slot, metrics, lora_active, lora_waiting, now)

    def update_rows(
        self,
        rows: Sequence[tuple],
        now: Optional[float] = None,
    ) -> None:
        """Apply one scrape-engine shard's completed sweep under a SINGLE
        lock acquisition: ``rows`` is a sequence of
        ``(slot, metrics, lora_active, lora_waiting)`` tuples, each with
        the exact semantics of ``update()``. At hundreds of endpoints per
        50 ms tick the per-row lock traffic of the thread-per-endpoint
        path measurably contended the scheduler's snapshot reads; the
        batched form costs the readers one acquisition per sweep."""
        now = self._clock() if now is None else now
        with self._lock:
            for slot, metrics, lora_active, lora_waiting in rows:
                self._apply_locked(slot, metrics, lora_active, lora_waiting,
                                   now)

    def _apply_locked(
        self,
        slot: int,
        metrics: dict[int, float],
        lora_active: Sequence[int],
        lora_waiting: Sequence[int],
        now: float,
    ) -> None:
        for col, val in metrics.items():
            self._metrics[slot, col] = val
        self._lora_active[slot] = -1
        self._lora_active[slot, : len(lora_active)] = list(lora_active)[
            : C.LORA_SLOTS
        ]
        self._lora_waiting[slot] = -1
        self._lora_waiting[slot, : len(lora_waiting)] = list(lora_waiting)[
            : C.LORA_SLOTS
        ]
        self._scraped_at[slot] = now
        self._has_data[slot] = True

    def host_queue_depths(self) -> np.ndarray:
        """Host-side copy of the queue-depth column (flow-control hold
        checks run before any device work)."""
        with self._lock:
            return self._metrics[:, C.Metric.QUEUE_DEPTH].copy()

    def pool_rows(
        self, slots: Sequence[int], now: Optional[float] = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Copies of the metric rows + scrape ages for the given slots
        (autoscale signal derivation). Ages are +inf for slots that have
        never been scraped: a fresh pod's row is zeros — optimistic for
        ROUTING (cold-start admission), but a capacity decision must not
        read 'no data yet' as 'idle'."""
        idx = list(slots)
        now = self._clock() if now is None else now
        with self._lock:
            rows = self._metrics[idx].copy()
            ages = np.where(
                self._has_data[idx],
                now - self._scraped_at[idx],
                np.inf,
            )
        return rows, ages

    def pool_aggregates(
        self,
        slots: Sequence[int],
        *,
        queue_limit: float,
        kv_limit: float,
        now: Optional[float] = None,
    ) -> dict:
        """Pool-saturation aggregates over the given slots — the ONE
        derivation shared by the HPA pool gauges (runner._pool_snapshot)
        and the autoscale SignalCollector, so the exported metrics and
        the replica controller can never desynchronize on what
        'saturated' means."""
        rows, ages = self.pool_rows(slots, now=now)
        if len(rows) == 0:
            return {"queue_depth_total": 0.0, "kv_cache_util_mean": 0.0,
                    "saturated_fraction": 0.0, "metrics_age_max_s": 0.0}
        queue = rows[:, C.Metric.QUEUE_DEPTH]
        kv = rows[:, C.Metric.KV_CACHE_UTIL]
        saturated = (queue >= queue_limit) | (kv >= kv_limit)
        return {
            "queue_depth_total": float(queue.sum()),
            "kv_cache_util_mean": float(kv.mean()),
            "saturated_fraction": float(saturated.mean()),
            "metrics_age_max_s": float(ages.max()),
        }

    def note_empty_pool_arrival(self) -> None:
        """Record one request that 503'd against an empty pool — the only
        traffic signal a scaled-to-zero pool can emit (there is no endpoint
        to scrape and no pick to count). Feeds the recommender's
        wake-from-zero trigger."""
        with self._lock:
            self._wake_arrivals += 1

    def take_wake_arrivals(self) -> int:
        """Drain-and-reset the empty-pool arrival count (one consumer: the
        autoscale SignalCollector's window sampling)."""
        with self._lock:
            n, self._wake_arrivals = self._wake_arrivals, 0
            return n

    def remove(self, slot: int) -> None:
        """Forget a reclaimed slot (wired to Datastore.on_slot_reclaimed)."""
        with self._lock:
            self._metrics[slot] = 0.0
            self._lora_active[slot] = -1
            self._lora_waiting[slot] = -1
            self._scraped_at[slot] = 0.0
            self._has_data[slot] = False

    def endpoint_batch(
        self,
        endpoints: Iterable[Endpoint],
        now: Optional[float] = None,
        m_slots: int = C.M_MAX,
    ) -> EndpointBatch:
        """Dense snapshot for one scheduling cycle. Endpoints without any
        scrape yet are still valid (zero metrics = optimistic cold start,
        matching the reference's fresh-endpoint admission).

        `m_slots` is the endpoint-axis width of the snapshot (an M bucket —
        the batching layer sizes it to the live high-water slot so the
        compiled cycle scores only the lanes that can exist); every
        endpoint's slot must be < m_slots."""
        now = self._clock() if now is None else now
        with self._lock:
            metrics = self._metrics[:m_slots].copy()
            active = self._lora_active[:m_slots].copy()
            waiting = self._lora_waiting[:m_slots].copy()
            age = np.where(
                self._has_data[:m_slots],
                now - self._scraped_at[:m_slots], 0.0
            ).astype(np.float32)
        metrics[:, C.Metric.METRICS_AGE_S] = age
        valid = np.zeros((m_slots,), bool)
        role = np.zeros((m_slots,), np.int32)
        for ep in endpoints:
            valid[ep.slot] = True
            labels = getattr(ep, "labels", None) or {}
            role[ep.slot] = _ROLE_BY_LABEL.get(
                labels.get(ROLE_LABEL, ""), C.Role.BOTH)
        return EndpointBatch(
            metrics=torch.from_numpy(metrics),
            valid=torch.from_numpy(valid),
            lora_active=torch.from_numpy(active),
            lora_waiting=torch.from_numpy(waiting),
            role=torch.from_numpy(role),
        )
