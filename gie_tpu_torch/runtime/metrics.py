"""The pick path's own metrics (port of gie_tpu/runtime/metrics.py).

The same metric names, label names and histogram buckets as the
reference, for the subset the pick service writes. They are backed by a
small in-process collector instead of prometheus_client, so the pick
service runs where only PyTorch is installed; Prometheus exposition of
REGISTRY comes with the Runner slice of the port (ROADMAP.md, Queue 1).

Every metric offers what its prometheus_client counterpart offers the
pick path (`labels()`, `inc()`, `dec()`, `set()`, `observe()`), and
values that tests and chip_smoke.py read back: `value(*labels)` for
counters and gauges, `count`/`sum`/`bucket_counts` for histograms, and
the most recent raw observations (`recent()`), which per-wave medians
need and bucket counts cannot give.
"""

from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Optional

# Every metric this module defines, in definition order.
REGISTRY: list["_Metric"] = []

# Raw observations a histogram keeps for recent().
RECENT = 8192


class _Child:
    """One label combination of a metric (what `labels()` returns)."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "_Metric", key: tuple):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._metric._add(self._key, amount)

    def dec(self, amount: float = 1.0) -> None:
        self._metric._add(self._key, -amount)

    def set(self, value: float) -> None:
        self._metric._set(self._key, value)

    def observe(self, value: float, exemplar: Optional[dict] = None) -> None:
        del exemplar  # exemplars come with the exposition (Runner slice)
        self._metric._observe(self._key, value)


class _Metric:
    kind = ""

    def __init__(self, name: str, documentation: str,
                 labelnames: tuple = (), buckets: tuple = ()):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self._lock = threading.Lock()
        self._values: dict[tuple, object] = {}
        REGISTRY.append(self)

    def labels(self, *values, **by_name) -> _Child:
        if by_name:
            if values or set(by_name) != set(self.labelnames):
                raise ValueError(
                    f"{self.name}: labels {sorted(by_name)} != "
                    f"{list(self.labelnames)}")
            values = tuple(by_name[n] for n in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{list(self.labelnames)}, got {list(values)}")
        return _Child(self, tuple(str(v) for v in values))

    def _bare(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name} is labelled: call labels() first")
        return _Child(self, ())

    # The unlabelled forms, as prometheus_client offers them.
    def inc(self, amount: float = 1.0) -> None:
        self._bare().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._bare().dec(amount)

    def set(self, value: float) -> None:
        self._bare().set(value)

    def observe(self, value: float, exemplar: Optional[dict] = None) -> None:
        self._bare().observe(value, exemplar)

    def _add(self, key: tuple, amount: float) -> None:
        raise TypeError(f"{self.kind} {self.name} has no inc/dec")

    def _set(self, key: tuple, value: float) -> None:
        raise TypeError(f"{self.kind} {self.name} has no set")

    def _observe(self, key: tuple, value: float) -> None:
        raise TypeError(f"{self.kind} {self.name} has no observe")

    def reset(self) -> None:
        with self._lock:
            self._values.clear()


class Counter(_Metric):
    kind = "counter"

    def _add(self, key: tuple, amount: float) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} can only increase")
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(amount)

    def value(self, *labels) -> float:
        with self._lock:
            return float(self._values.get(tuple(str(v) for v in labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def _add(self, key: tuple, amount: float) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(amount)

    def _set(self, key: tuple, value: float) -> None:
        with self._lock:
            self._values[key] = float(value)

    def value(self, *labels) -> float:
        with self._lock:
            return float(self._values.get(tuple(str(v) for v in labels), 0.0))


class _Series:
    __slots__ = ("counts", "sum", "count", "recent")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # the last is +Inf
        self.sum = 0.0
        self.count = 0
        self.recent: deque = deque(maxlen=RECENT)


class Histogram(_Metric):
    kind = "histogram"

    def _observe(self, key: tuple, value: float) -> None:
        value = float(value)
        with self._lock:
            series = self._values.get(key)
            if series is None:
                series = self._values[key] = _Series(len(self.buckets))
            series.counts[bisect.bisect_left(self.buckets, value)] += 1
            series.sum += value
            series.count += 1
            series.recent.append(value)

    def _series(self, labels) -> Optional[_Series]:
        return self._values.get(tuple(str(v) for v in labels))

    def count(self, *labels) -> int:
        with self._lock:
            s = self._series(labels)
            return 0 if s is None else s.count

    def sum(self, *labels) -> float:
        with self._lock:
            s = self._series(labels)
            return 0.0 if s is None else s.sum

    def bucket_counts(self, *labels) -> list[int]:
        """Per-bucket (not cumulative) counts; the last entry is +Inf."""
        with self._lock:
            s = self._series(labels)
            return [0] * (len(self.buckets) + 1) if s is None else list(s.counts)

    def recent(self, *labels) -> list[float]:
        """The last RECENT raw observations, oldest first."""
        with self._lock:
            s = self._series(labels)
            return [] if s is None else list(s.recent)


def reset() -> None:
    """Zero every metric (tests and chip_smoke.py, between phases)."""
    for metric in REGISTRY:
        metric.reset()


PICKS = Counter(
    "gie_picks_total", "Endpoint picks by outcome", ["outcome"])
PICK_LATENCY = Histogram(
    "gie_pick_latency_seconds",
    "End-to-end pick latency (enqueue to result)",
    buckets=(1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0))
BATCH_SIZE = Histogram(
    "gie_sched_batch_size",
    "Requests per scheduling cycle",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
QUEUE_DEPTH = Gauge(
    "gie_flow_queue_depth",
    "Picks waiting in the flow-control queue (reference flow-controller "
    "queue, proposal 0683)")
QUEUE_SHED = Counter(
    "gie_flow_queue_shed_total",
    "Picks shed by the flow-control queue bounds",
    ["reason", "band"])  # reason: depth|evicted|age|tenant
HOST_ASSEMBLY = Histogram(
    "gie_host_assembly_seconds",
    "Pipeline stage-1 host work per wave: queue-drain decisions, vectorized "
    "column assembly, and the async cycle dispatch (docs/PIPELINE.md)",
    buckets=(1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1))
DEVICE_WAIT = Histogram(
    "gie_device_wait_seconds",
    "Pipeline stage-2 wait per wave: async dispatch until the device "
    "results materialize on the host (the overlap window the two-stage "
    "collector hides behind the next wave's assembly)",
    buckets=(1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1))
PIPELINE_DEPTH = Gauge(
    "gie_pipeline_waves_in_flight",
    "Waves dispatched to the device but not yet fanned out (bounded by the "
    "collector's pipeline depth); >0 under load means the overlap is live")
PIPELINE_WAVES = Counter(
    "gie_pipeline_waves_total",
    "Waves through the two-stage collector. Occupancy over a window = "
    "rate(gie_device_wait_seconds_sum) /"
    " (rate(gie_device_wait_seconds_sum) + dispatcher idle time); the "
    "per-wave histograms above give both terms")
DEADLINE_SHED = Counter(
    "gie_deadline_shed_total",
    "Requests shed with 503 because their propagated deadline expired",
    ["stage"])  # admission|queue
SERVE_OUTCOME = Counter(
    "gie_serve_outcome_total",
    "Data-plane serve outcomes observed on the response path",
    ["class"])  # 2xx|3xx|4xx|5xx|reset
SERVE_LATENCY = Histogram(
    "gie_serve_latency_seconds",
    "Observed pick-to-response-headers serve latency",
    buckets=(0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0))
DRAINING_ENDPOINTS = Gauge(
    "gie_draining_endpoints",
    "Endpoints in graceful DRAINING state (excluded from new picks, "
    "in-flight streams completing)")
HOLD_BUDGET_BYPASS = Counter(
    "gie_hold_budget_bypass_total",
    "Saturation holds skipped because the request's remaining deadline "
    "budget could not survive another hold retry (picked best-effort "
    "now instead of held to die)")
TRACES_EXPORTED = Counter(
    "gie_obs_traces_exported_total",
    "Request traces exported to the /debugz feeds, by why they were "
    "kept (head sample, error-class outcome, latency tail outlier)",
    ["reason"])  # sampled|error|slow
TENANT_REQUESTS = Counter(
    "gie_tenant_requests_total",
    "Flow-queue enqueues by tenant (x-gateway-inference-fairness-id; "
    "top-K tenants labeled individually, the long tail as 'other')",
    ["tenant"])
TENANT_COST = Counter(
    "gie_tenant_cost_total",
    "Drained request cost (scheduler request_cost units) by tenant — "
    "the capacity each tenant actually consumed through the flow queue",
    ["tenant"])
TENANT_SHED = Counter(
    "gie_tenant_shed_total",
    "Requests shed (429) by tenant and criticality band, all shed "
    "sources: queue bounds, cycle saturation, SLO reversal, and the "
    "over-fair-share preemptive shed",
    ["tenant", "band"])
TENANT_SERVE_ERRORS = Counter(
    "gie_tenant_serve_errors_total",
    "Data-plane serve errors (5xx/reset) observed per tenant at the "
    "response hop — the per-tenant half of gie_serve_outcome_total",
    ["tenant"])
