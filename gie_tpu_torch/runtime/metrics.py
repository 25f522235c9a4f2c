"""The EPP's own metrics (port of gie_tpu/runtime/metrics.py).

The same metric names, label names and histogram buckets as the
reference, for the subset the port writes (the pick service, the ext-proc
transport, the scrape engine and the runner). They are backed by a small
in-process collector instead of prometheus_client, so the port runs where
only PyTorch (and, for the transport, grpcio and protobuf) is installed.

Every metric offers what its prometheus_client counterpart offers its
callers (`labels()`, `inc()`, `dec()`, `set()`, `set_function()`,
`observe()`), and values that tests and chip_smoke.py read back:
`value(*labels)` for counters and gauges, `count`/`sum`/`bucket_counts`
for histograms, and the most recent raw observations (`recent()`), which
per-wave medians need and bucket counts cannot give.

`generate_latest()` renders REGISTRY in the Prometheus text format 0.0.4
exactly as prometheus_client's generate_latest does: HELP and TYPE lines,
`_total` counter samples, `_bucket`/`_count`/`_sum` histogram samples, and
a `_created` gauge family beside every counter and histogram.
`generate_openmetrics()` renders it in OpenMetrics 1.0.0 exactly as
prometheus_client's openmetrics.generate_latest does, with the trace-ID
EXEMPLAR an observation carried on its histogram bucket (the bucket ->
trace join, docs/OBSERVABILITY.md). Both take `names`, the
prometheus_client `name[]` filter. `start_metrics_server` serves them on
/metrics, chosen by the scrape's Accept header, with the /debugz pages
(obs/debugz.py).
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Callable, Optional

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
        self._metric._observe(self._key, value, exemplar)


class _Metric:
    kind = ""

    def __init__(self, name: str, documentation: str,
                 labelnames: tuple = (), buckets: tuple = (),
                 registry: Optional[list] = REGISTRY):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self._lock = threading.Lock()
        self._values: dict[tuple, object] = {}
        # Creation time of each label combination (the `_created` series);
        # an unlabelled metric exists from its definition on.
        self._created: dict[tuple, float] = {}
        if not self.labelnames:
            self._created[()] = time.time()
        if registry is not None:
            registry.append(self)

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

    def _observe(self, key: tuple, value: float,
                 exemplar: Optional[dict] = None) -> None:
        raise TypeError(f"{self.kind} {self.name} has no observe")

    def reset(self) -> None:
        with self._lock:
            self._values.clear()
            if self.labelnames:
                self._created.clear()

    def _touch(self, key: tuple) -> None:
        """Record `key`'s creation time (caller holds the lock)."""
        if key not in self._created:
            self._created[key] = time.time()

    @property
    def family(self) -> str:
        """The OpenMetrics family name (a counter's without `_total`)."""
        if self.kind == "counter" and self.name.endswith("_total"):
            return self.name[:-6]
        return self.name

    def _samples(self) -> list[tuple[str, tuple, float, Optional[tuple]]]:
        """(sample name, (label, value) pairs, value, exemplar) in the
        OpenMetrics order: each label combination's samples together,
        its `_created` last. An exemplar is (labels dict, value, unix
        time) or None."""
        raise NotImplementedError

    def _created_at(self, key: tuple) -> list:
        """The `_created` sample of one label combination (caller holds
        the lock)."""
        ts = self._created.get(key)
        if ts is None:
            return []
        return [(f"{self.family}_created", tuple(zip(self.labelnames, key)),
                 ts, None)]

    def _expose(self, out: list[str], names=None) -> None:
        """Append this metric's families in the text format 0.0.4."""
        samples = _filtered(self._samples(), names)
        if samples is None:
            return
        family = self.family + ("_total" if self.kind == "counter" else "")
        doc = _escape_help(self.documentation)
        out.append(f"# HELP {family} {doc}\n# TYPE {family} {self.kind}\n")
        created = f"{self.family}_created"
        for sample, labels, value, _ex in samples:
            if sample != created:
                out.append(_sample_line(sample, labels, value))
        tail = [s for s in samples if s[0] == created]
        if tail:
            out.append(f"# HELP {created} {doc}\n# TYPE {created} gauge\n")
            for sample, labels, value, _ex in tail:
                out.append(_sample_line(sample, labels, value))

    def _expose_openmetrics(self, out: list[str], names=None) -> None:
        """Append this metric's family in OpenMetrics 1.0.0."""
        samples = _filtered(self._samples(), names)
        if samples is None:
            return
        doc = _escape_label(self.documentation)
        out.append(f"# HELP {self.family} {doc}\n"
                   f"# TYPE {self.family} {self.kind}\n")
        for sample, labels, value, exemplar in samples:
            line = _sample_line(sample, labels, value)
            if exemplar is not None:
                ex_labels, ex_value, ex_ts = exemplar
                body = ",".join(f'{k}="{_escape_label(str(v))}"'
                                for k, v in sorted(ex_labels.items()))
                line = (f"{line[:-1]} # {{{body}}} "
                        f"{_go_float(ex_value)} {ex_ts}\n")
            out.append(line)


class Counter(_Metric):
    kind = "counter"

    def _add(self, key: tuple, amount: float) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} can only increase")
        with self._lock:
            self._touch(key)
            self._values[key] = self._values.get(key, 0.0) + float(amount)

    def value(self, *labels) -> float:
        with self._lock:
            return float(self._values.get(tuple(str(v) for v in labels), 0.0))

    def _samples(self):
        out = []
        with self._lock:
            items = list(self._values.items())
            if not self.labelnames and not items:
                items = [((), 0.0)]
            for key, value in items:
                out.append((self.name, tuple(zip(self.labelnames, key)),
                            value, None))
                out.extend(self._created_at(key))
        return out


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, documentation: str,
                 labelnames: tuple = (), registry: Optional[list] = REGISTRY):
        super().__init__(name, documentation, labelnames, registry=registry)
        self._function: Optional[Callable[[], float]] = None

    def set_function(self, fn: Callable[[], float]) -> None:
        """Evaluate `fn` at exposition time (an unlabelled gauge only)."""
        self._bare()
        self._function = fn

    def _add(self, key: tuple, amount: float) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(amount)

    def _set(self, key: tuple, value: float) -> None:
        with self._lock:
            self._values[key] = float(value)

    def value(self, *labels) -> float:
        if self._function is not None:
            return float(self._function())
        with self._lock:
            return float(self._values.get(tuple(str(v) for v in labels), 0.0))

    def _samples(self):
        if self._function is not None:
            return [(self.name, (), float(self._function()), None)]
        with self._lock:
            items = list(self._values.items())
            if not self.labelnames and not items:
                items = [((), 0.0)]
        return [(self.name, tuple(zip(self.labelnames, key)), value, None)
                for key, value in items]


class _Series:
    __slots__ = ("counts", "sum", "count", "recent", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # the last is +Inf
        self.sum = 0.0
        self.count = 0
        self.recent: deque = deque(maxlen=RECENT)
        # Per bucket, the last exemplar observed into it (or None).
        self.exemplars: list = [None] * (n_buckets + 1)


class Histogram(_Metric):
    kind = "histogram"

    def _observe(self, key: tuple, value: float,
                 exemplar: Optional[dict] = None) -> None:
        value = float(value)
        with self._lock:
            self._touch(key)
            series = self._values.get(key)
            if series is None:
                series = self._values[key] = _Series(len(self.buckets))
            bucket = bisect.bisect_left(self.buckets, value)
            series.counts[bucket] += 1
            series.sum += value
            series.count += 1
            series.recent.append(value)
            if exemplar:
                series.exemplars[bucket] = (
                    {str(k): str(v) for k, v in exemplar.items()},
                    value, time.time())

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

    def _samples(self):
        n = len(self.buckets) + 1
        with self._lock:
            items = [(key, list(s.counts), s.count, s.sum, list(s.exemplars),
                      self._created_at(key))
                     for key, s in self._values.items()]
            if not self.labelnames and not items:
                items = [((), [0] * n, 0, 0.0, [None] * n,
                          self._created_at(()))]
        out = []
        edges = [_go_float(b) for b in self.buckets] + ["+Inf"]
        for key, counts, count, total, exemplars, created in items:
            labels = tuple(zip(self.labelnames, key))
            cumulative = 0
            for edge, k, ex in zip(edges, counts, exemplars):
                cumulative += k
                out.append((f"{self.name}_bucket", labels + (("le", edge),),
                            float(cumulative), ex))
            out.append((f"{self.name}_count", labels, float(count), None))
            out.append((f"{self.name}_sum", labels, total, None))
            out.extend(created)
        return out


def reset() -> None:
    """Zero every metric (tests and chip_smoke.py, between phases)."""
    for metric in REGISTRY:
        metric.reset()


# -- text exposition (format 0.0.4, as prometheus_client renders it) ------

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"


def _go_float(value: float) -> str:
    """prometheus_client's floatToGoString: Go's float formatting."""
    value = float(value)
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    if value != value:
        return "NaN"
    s = repr(value)
    dot = s.find(".")
    # Go switches to exponents sooner than Python.
    if value > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _sample_line(name: str, labels: tuple, value) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape_label(str(v))}"'
                        for k, v in sorted(labels))
        return f"{name}{{{body}}} {_go_float(value)}\n"
    return f"{name} {_go_float(value)}\n"


def _filtered(samples: list, names) -> Optional[list]:
    """prometheus_client's `name[]` restriction: only the samples whose
    name is listed, and None (no family at all) when none is."""
    if not names:
        return samples
    kept = [s for s in samples if s[0] in names]
    return kept or None


def generate_latest(registry: list = REGISTRY, names=None) -> bytes:
    """`registry` in the text format 0.0.4."""
    out: list[str] = []
    for metric in registry:
        metric._expose(out, names)
    return "".join(out).encode("utf-8")


CONTENT_TYPE_OPENMETRICS = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8")


def generate_openmetrics(registry: list = REGISTRY, names=None) -> bytes:
    """`registry` in OpenMetrics 1.0.0, exemplars included."""
    out: list[str] = []
    for metric in registry:
        metric._expose_openmetrics(out, names)
    out.append("# EOF\n")
    return "".join(out).encode("utf-8")


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
STREAMS = Gauge("gie_active_streams", "Open ext-proc streams")
# Multi-core acceptors (extproc/workers.py, --extproc-workers): streams
# accepted per SO_REUSEPORT worker; the label is the worker index.
WORKER_ACCEPTS = Counter(
    "gie_extproc_worker_accepted_streams_total",
    "ext-proc streams accepted, by SO_REUSEPORT worker index",
    ["worker"])
# Admission (extproc/server.py): per-request EPP overhead between "request
# fully received" and "routing decision sent", by lane.
ADMISSION_SECONDS = Histogram(
    "gie_extproc_admission_seconds",
    "Per-request admission processing time (pick + parse/scan + response "
    "build) by lane (fast = zero-parse scan path, legacy = full parse)",
    ["lane"],
    buckets=(1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3))
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
# Multiplexed scrape engine (metricsio/engine.py): ingestion health.
SCRAPE_STALENESS = Histogram(
    "gie_scrape_staleness_seconds",
    "Time between consecutive successful scrapes of the same endpoint "
    "(attach-to-first-scrape for new endpoints)",
    buckets=(0.01, 0.025, 0.05, 0.075, 0.1, 0.15, 0.25, 0.5, 1.0, 2.5))
SCRAPE_FETCH = Histogram(
    "gie_scrape_fetch_seconds",
    "Per-endpoint fetch + parse latency on the scrape-engine shards",
    buckets=(1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0))
SCRAPE_REUSE = Gauge(
    "gie_scrape_connection_reuse_ratio",
    "Fraction of keep-alive HTTP fetches that reused a live connection "
    "(low values mean model servers are closing idle keep-alives faster "
    "than the scrape interval)")
SCRAPE_FAILS_MAX = Gauge(
    "gie_scrape_consecutive_failures_max",
    "Largest consecutive-failure streak among attached endpoints (the "
    "worst endpoint's adaptive-backoff driver)")
SCRAPE_ENDPOINTS = Gauge(
    "gie_scrape_endpoints",
    "Endpoints currently attached to the scrape engine")
SLOT_OVERFLOW = Gauge(
    "gie_endpoint_slot_overflow_total",
    "Endpoint admissions refused because every scheduler slot (M_MAX) was "
    "taken — the pool outgrew the compiled capacity")
# Autoscaling recommender (autoscale/): the closed-loop replica
# controller's own observability. In recommend-only mode these gauges ARE
# the product — operators compare the desired series against their HPA
# before handing over actuation.
AUTOSCALE_DESIRED = Gauge(
    "gie_autoscale_desired_replicas",
    "Replica count the recommender currently wants for the pool workload")
AUTOSCALE_CURRENT = Gauge(
    "gie_autoscale_current_replicas",
    "Configured replica count the recommendation was made against")
AUTOSCALE_CAPACITY = Gauge(
    "gie_autoscale_capacity_per_replica",
    "Online per-replica capacity estimate (admitted picks/s near "
    "saturation, EWMA, SLO-derated)")
AUTOSCALE_SHED_RATE = Gauge(
    "gie_autoscale_shed_per_s",
    "Windowed shed rate (all 429 sources) the last recommendation saw")
AUTOSCALE_STALE = Gauge(
    "gie_autoscale_signals_stale",
    "1 while the recommender is holding because pool metrics are stale "
    "(scrape outage / never-scraped pods) — never scale on stale data")
AUTOSCALE_RECS = Counter(
    "gie_autoscale_recommendations_total",
    "Recommendations by direction",
    ["direction"])  # up|down|hold
AUTOSCALE_APPLIED = Counter(
    "gie_autoscale_apply_total",
    "Actuation outcomes",
    ["outcome"])  # patched|noop|dry_run|not_leader|no_target|error
# HA state replication (replication/): the warm-standby sync loop's own
# observability. On a leader the epoch is the publisher's; on a follower
# it is the last INSTALLED epoch, and lag / staleness quantify how cold a
# takeover would be right now.
REPLICATION_ROLE = Gauge(
    "gie_replication_role",
    "1 while this replica leads (publishes digests), 0 while it syncs")
REPLICATION_EPOCH = Gauge(
    "gie_replication_epoch",
    "State epoch: published (leader) or last installed (follower)")
REPLICATION_EPOCH_LAG = Gauge(
    "gie_replication_epoch_lag",
    "Leader epoch minus last installed epoch, as observed by the follower")
REPLICATION_DIGEST_BYTES = Gauge(
    "gie_replication_digest_bytes",
    "Encoded size of the current full state digest")
REPLICATION_STALENESS = Gauge(
    "gie_replication_staleness_seconds",
    "Seconds since the follower last confirmed the leader's state "
    "(install or 304); -1 before first contact, 0 while leading")
REPLICATION_INSTALL_SECONDS = Histogram(
    "gie_replication_install_seconds",
    "Digest decode-to-installed latency on the follower",
    buckets=(1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0))
REPLICATION_SYNCS = Counter(
    "gie_replication_sync_total",
    "Follower sync attempts by outcome",
    # installed|not_modified|no_leader|fetch_error|corrupt|stale_epoch|
    # delta_mismatch|rejected
    ["outcome"])
PD_BUDGET_SINGLEHOP = Counter(
    "gie_pd_budget_singlehop_total",
    "Disaggregated picks collapsed to the decode worker only because "
    "the request's remaining deadline budget could not afford the "
    "cross-worker prefill hop")
# Unified resilience layer (resilience/): the degradation ladder's current
# rung (0 = full device pick, 1 = cached-snapshot pick, 2 = weighted
# round-robin, 3 = static subset), breaker quarantine, and degraded-pick
# volume.
DEGRADED_MODE = Gauge(
    "gie_degraded_mode",
    "Pick-path degradation ladder rung (0 full TPU pick, 1 cached-"
    "snapshot pick, 2 weighted round-robin, 3 static subset)")
DEGRADED_PICKS = Counter(
    "gie_degraded_picks_total",
    "Picks served by a degraded ladder rung",
    ["rung"])  # cached|round_robin|static
BREAKER_OPEN = Gauge(
    "gie_breaker_open_endpoints",
    "Endpoints currently quarantined by an OPEN circuit breaker")
OUTLIER_EJECTIONS = Counter(
    "gie_outlier_ejections_total",
    "Endpoints quarantined by p99 serve-latency outlier ejection "
    "(windowed per-endpoint quantile vs pool median, --outlier-ejection)")
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
# Build identity: the constant-1 info gauge, joinable onto any series.
BUILD_INFO = Gauge(
    "gie_build_info",
    "Constant 1 with build/runtime identity labels: package version and "
    "the lane/resilience/obs/wire feature-flag mix (plus acceptor count) "
    "this replica runs",
    ["version", "fast_lane", "resilience", "obs", "wire", "workers"])
STREAM_ERRORS = Counter(
    "gie_extproc_stream_errors_total",
    "Stream-fatal ext-proc failures surfaced to Envoy, by gRPC status "
    "code (label values are the bounded grpc.StatusCode enum)",
    ["code"])
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
# Multi-cluster federation (federation/). The peer label is bounded by
# configuration (--fed-peer entries), never by workload.
FED_PEERS = Gauge(
    "gie_federation_peers",
    "Configured federation peer clusters")
FED_REMOTE_ENDPOINTS = Gauge(
    "gie_federation_remote_endpoints",
    "Imported peer endpoints currently schedulable, per peer cluster",
    ["peer"])
FED_STALENESS = Gauge(
    "gie_federation_staleness_seconds",
    "Seconds since the peer digest was last confirmed (install or 304); "
    "-1 before first contact",
    ["peer"])
FED_LOCAL_ONLY = Gauge(
    "gie_federation_local_only",
    "1 while the peer is excluded from spillover (stale link past the "
    "local-only floor), else 0",
    ["peer"])
FED_PENALTY = Gauge(
    "gie_federation_penalty_queue_units",
    "Effective cross-cluster cost penalty applied to the peer's "
    "imported endpoints, in queue-depth units (staleness-inflated)",
    ["peer"])
FED_SYNCS = Counter(
    "gie_federation_syncs_total",
    "Peer digest exchange attempts by outcome (installed, not_modified, "
    "fetch_error, corrupt, stale_epoch, era_regression, ...)",
    ["peer", "outcome"])
FED_SPILL = Counter(
    "gie_federation_spill_total",
    "Picks that landed on an imported peer endpoint, by peer cluster "
    "and criticality band",
    ["peer", "band"])
FED_ERA_FLIPS = Counter(
    "gie_federation_era_flips_total",
    "Peer publisher era changes observed (peer failover / partition "
    "heal; the split-brain convergence events)",
    ["peer"])
FED_DRAINING = Gauge(
    "gie_federation_cluster_draining",
    "1 while THIS cluster is draining its traffic to peers, else 0")
# Scorer identity: the same constant-1 info idiom as gie_build_info.
POLICY_INFO = Gauge(
    "gie_policy_info",
    "Constant 1 with scheduling-policy identity labels: active scorer "
    "kind (blend|learned), the loaded policy artifact's schema version/"
    "checksum/trained-at (empty for the heuristic), and the live blend "
    "weights as name=value pairs",
    ["scorer", "artifact_schema", "checksum", "trained_at", "weights"])


def set_policy_info(scorer: str, weights: dict,
                    artifact: Optional[dict] = None) -> None:
    """Stamp the constant-1 policy-identity series (runner startup).
    ``weights`` is {column: float}: the LIVE values the cycle blends."""
    prov = (artifact or {}).get("provenance", {})
    POLICY_INFO.labels(
        scorer=str(scorer),
        artifact_schema=str((artifact or {}).get("schema", "")),
        checksum=str((artifact or {}).get("checksum", "")),
        trained_at=str(prov.get("trained_at", "")),
        weights=",".join(
            f"{name}={float(val):g}" for name, val in sorted(
                weights.items())),
    ).set(1)


def set_build_info(fast_lane: bool, resilience: bool, obs: bool,
                   wire: bool = False, workers: int = 1) -> None:
    """Stamp the constant-1 build-identity series (runner startup)."""
    from gie_tpu_torch import __version__

    BUILD_INFO.labels(
        version=__version__,
        fast_lane=str(bool(fast_lane)).lower(),
        resilience=str(bool(resilience)).lower(),
        obs=str(bool(obs)).lower(),
        wire=str(bool(wire)).lower(),
        workers=str(int(workers)),
    ).set(1)


_POOL_SNAPSHOT = {"fn": lambda: {}, "registered": False,
                  "cache": {}, "cached_at": -1.0}


def _pool_snapshot_cached() -> dict:
    """One snapshot per scrape, not one per gauge: the 5 gauges evaluate
    within the same exposition pass, and each uncached call would take the
    scheduler lock and read the assumed load back from the card."""
    now = time.monotonic()
    if now - _POOL_SNAPSHOT["cached_at"] > 0.25:
        _POOL_SNAPSHOT["cache"] = _POOL_SNAPSHOT["fn"]()
        _POOL_SNAPSHOT["cached_at"] = now
    return _POOL_SNAPSHOT["cache"]


def register_pool_aggregates(snapshot) -> None:
    """Pool-level aggregate gauges for autoscaling. `snapshot` is a
    callable returning a dict with keys ready_endpoints /
    queue_depth_total / kv_cache_util_mean / assumed_load_total /
    saturated_fraction; each gauge evaluates it at scrape time
    (set_function). Re-registration swaps the snapshot source instead of
    duplicating the gauges (the registry is process-global; tests build
    several runners)."""
    _POOL_SNAPSHOT["fn"] = snapshot
    _POOL_SNAPSHOT["cached_at"] = -1.0  # new source: drop any cache
    if _POOL_SNAPSHOT["registered"]:
        return
    _POOL_SNAPSHOT["registered"] = True
    specs = [
        ("gie_pool_endpoints", "Ready routable endpoints in the pool",
         "ready_endpoints"),
        ("gie_pool_queue_depth_total",
         "Sum of scraped queue depth across ready endpoints",
         "queue_depth_total"),
        ("gie_pool_kv_cache_util_mean",
         "Mean scraped KV-cache utilization across ready endpoints",
         "kv_cache_util_mean"),
        ("gie_pool_assumed_load_total",
         "Total in-flight assumed load (picks not yet reconciled)",
         "assumed_load_total"),
        ("gie_pool_saturated_fraction",
         "Fraction of ready endpoints past the saturation thresholds",
         "saturated_fraction"),
    ]
    for name, doc, field in specs:
        Gauge(name, doc).set_function(
            lambda field=field: float(
                _pool_snapshot_cached().get(field, 0.0)))


def start_metrics_server(port: int, providers=None,
                         debugz_bind: str = "127.0.0.1",
                         debugz_token=None):
    """Start the operator HTTP listener: /metrics (the text exposition of
    REGISTRY) plus the /debugz pages of whatever providers the caller
    registers, loopback-only unless ``debugz_bind`` names a non-loopback
    address (obs/debugz.py). Returns the server (close() to stop)."""
    from gie_tpu_torch.obs.debugz import start_debugz_server

    return start_debugz_server(port, providers,
                               debugz_bind=debugz_bind,
                               debugz_token=debugz_token)
