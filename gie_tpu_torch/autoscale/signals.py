"""PoolSignals: per-pool saturation inputs for the autoscale loop (port of
gie_tpu/autoscale/signals.py).

Everything here is derived from state the gateway already maintains — the
dense MetricsStore tensor (scraped queue depth / KV-cache utilization per
endpoint slot) and the runtime prometheus counters the pick path already
increments (shed and evict counts by criticality band, pick outcomes, the
pipeline stage histograms from docs/PIPELINE.md). No new instrumentation
runs on the hot path; the collector reads counters at its own cadence and
differentiates them into windowed rates.

Staleness is a first-class signal: a capacity decision taken on stale
metrics is worse than no decision (a scrape outage looks exactly like an
idle fleet), so the collector marks the sample stale whenever any live
slot's scrape age exceeds the bound — including slots never scraped at
all — and the recommender holds on stale samples.

The reference reads prometheus_client's registry; the port reads its own
collector (runtime/metrics.py), a list of metrics with the same sample
names, labels and values. Only the five families below are read, so a
sample never evaluates the pool-aggregate gauges (whose snapshot reads
the assumed load back from the card).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from gie_tpu_torch.runtime.clock import REALTIME
from gie_tpu_torch.sched import constants as C

# Counter/gauge sample names read from the runtime registry (the names
# runtime/metrics.py registers; _created samples are skipped).
_PICKS = "gie_picks_total"                    # labels: outcome
_QUEUE_SHED = "gie_flow_queue_shed_total"     # labels: reason, band
_FLOW_DEPTH = "gie_flow_queue_depth"
_DEVICE_WAIT_SUM = "gie_device_wait_seconds_sum"
_HOST_ASSEMBLY_SUM = "gie_host_assembly_seconds_sum"
# The metrics those samples belong to.
_READ = frozenset({"gie_picks_total", "gie_flow_queue_shed_total",
                   "gie_flow_queue_depth", "gie_device_wait_seconds",
                   "gie_host_assembly_seconds"})


@dataclasses.dataclass(frozen=True)
class PoolSignals:
    """One windowed sample of pool saturation state."""

    at: float                 # sample clock (collector-supplied)
    window_s: float           # width of the rate window this sample covers
    ready_replicas: int       # routable endpoints in the datastore
    queue_depth_total: float  # sum of scraped per-endpoint queue depth
    kv_cache_util_mean: float
    saturated_fraction: float  # endpoints past the scheduler's thresholds
    flow_queue_depth: float    # picks waiting in the gateway's own queue
    admitted_per_s: float      # OK picks per second (goodput proxy)
    shed_per_s: float          # 429s per second, all shed sources
    shed_per_s_by_band: dict   # criticality band -> shed rate
    evict_per_s: float         # queue-bound evictions per second
    pipeline_occupancy: float  # device share of the dispatch pipeline
    device_wait_share: float   # device-wait seconds per wall second
    metrics_age_max_s: float   # oldest scrape age among live slots
    stale: bool                # hold recommendations when True
    # Requests that 503'd against an EMPTY pool this window (the ext-proc
    # layer records them in MetricsStore; scale-from-zero wake trigger).
    # Defaulted so hand-built PoolSignals in tests keep their meaning.
    wake_arrivals: int = 0


def _counter_totals(registry) -> dict:
    """(sample name, sorted label items) -> summed value."""
    out: dict = {}
    for metric in registry:
        if metric.name not in _READ:
            continue
        for name, labels, value, _exemplar in metric._samples():
            if name.endswith("_created"):
                continue
            key = (name, tuple(sorted(labels)))
            out[key] = out.get(key, 0.0) + value
    return out


def _sum_where(totals: dict, name: str, **labels) -> float:
    """Sum every sample of `name` whose labels include `labels`."""
    want = set(labels.items())
    return sum(
        v for (n, lbls), v in totals.items()
        if n == name and want <= set(lbls)
    )


def _band_sums(totals: dict, name: str) -> dict:
    out: dict = {}
    for (n, lbls), v in totals.items():
        if n != name:
            continue
        band = dict(lbls).get("band", "")
        out[band] = out.get(band, 0.0) + v
    return out


class SignalCollector:
    """Differentiates the gateway's own counters into PoolSignals.

    `endpoints` returns the live datastore endpoints (objects with a
    `.slot`); `registry` (a list of runtime/metrics.py metrics) defaults
    to the runtime metrics registry. The
    first `sample()` only establishes counter baselines and returns None —
    rates need a window.
    """

    def __init__(
        self,
        metrics_store,
        endpoints: Callable[[], list],
        *,
        queue_limit: float = 128.0,
        kv_limit: float = 0.95,
        staleness_s: float = 2.0,
        registry=None,
        scrape_engine=None,
    ):
        if registry is None:
            from gie_tpu_torch.runtime.metrics import REGISTRY

            registry = REGISTRY
        self.metrics_store = metrics_store
        self.endpoints = endpoints
        self.queue_limit = queue_limit
        self.kv_limit = kv_limit
        self.staleness_s = staleness_s
        self.registry = registry
        # Optional metricsio ScrapeEngine: its staleness_seconds() (time
        # since each endpoint's last SUCCESSFUL scrape, from the engine's
        # own monotonic clocks) is a second input to the stale-hold. It
        # covers ingestion outages the store's row ages miss — e.g. a
        # slot whose age was reset by a detach/attach cycle while the
        # pool is actually unreachable and backing off.
        self.scrape_engine = scrape_engine
        self._prev: Optional[dict] = None
        self._prev_at = 0.0

    def sample(self, now: Optional[float] = None) -> Optional[PoolSignals]:
        now = REALTIME() if now is None else now
        totals = _counter_totals(self.registry)
        prev, prev_at = self._prev, self._prev_at
        if prev is not None and now - prev_at <= 0:
            # Same-instant / backward-stepped clock: keep the OLD baseline
            # so the increments that landed since it still count toward
            # the next real window instead of being silently absorbed.
            return None
        self._prev, self._prev_at = totals, now
        if prev is None:
            return None
        window = now - prev_at
        # Drain AFTER the baseline gate: the first (None) sample must not
        # swallow a wake arrival that should count toward the first real
        # window. take_wake_arrivals is drain-and-reset, so each arrival
        # is observed by exactly one sample.
        wake = int(self.metrics_store.take_wake_arrivals())

        def rate(name: str, **labels) -> float:
            delta = (_sum_where(totals, name, **labels)
                     - _sum_where(prev, name, **labels))
            return max(delta, 0.0) / window

        slots = [ep.slot
                 for ep in self.endpoints() if 0 <= ep.slot < C.M_MAX]
        n = len(slots)
        agg = self.metrics_store.pool_aggregates(
            slots, queue_limit=self.queue_limit, kv_limit=self.kv_limit,
            now=now)
        age_max = agg["metrics_age_max_s"]
        if self.scrape_engine is not None and n > 0:
            age_max = max(
                age_max, float(self.scrape_engine.staleness_seconds()))

        band_prev = _band_sums(prev, _QUEUE_SHED)
        shed_by_band = {
            band: max(total - band_prev.get(band, 0.0), 0.0) / window
            for band, total in _band_sums(totals, _QUEUE_SHED).items()
        }
        # All shed sources: the flow-queue bounds AND the cycle/admission
        # sheds counted under pick outcomes.
        shed_per_s = (sum(shed_by_band.values())
                      + rate(_PICKS, outcome="shed"))
        dw = rate(_DEVICE_WAIT_SUM)      # device-wait seconds per second
        ha = rate(_HOST_ASSEMBLY_SUM)    # host-assembly seconds per second
        return PoolSignals(
            at=now,
            window_s=window,
            ready_replicas=n,
            queue_depth_total=agg["queue_depth_total"],
            kv_cache_util_mean=agg["kv_cache_util_mean"],
            saturated_fraction=agg["saturated_fraction"],
            flow_queue_depth=_sum_where(totals, _FLOW_DEPTH),
            admitted_per_s=rate(_PICKS, outcome="ok"),
            shed_per_s=shed_per_s,
            shed_per_s_by_band=shed_by_band,
            evict_per_s=rate(_QUEUE_SHED, reason="evicted"),
            pipeline_occupancy=dw / (dw + ha) if (dw + ha) > 0 else 0.0,
            device_wait_share=min(dw, 1.0),
            metrics_age_max_s=age_max,
            # A pool with live pods whose freshest view is older than the
            # bound (or never scraped: age +inf from pool_rows) must HOLD
            # — a scrape outage is indistinguishable from an idle fleet.
            stale=n > 0 and age_max > self.staleness_s,
            wake_arrivals=wake,
        )
