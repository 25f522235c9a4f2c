"""Metrics-catalog lint (copy of gie_tpu/obs/metricscheck.py, walking the
port's own collector, runtime/metrics.py).

The catalog IS an API: dashboards, alerts, and the autoscale/HPA story
all key on metric names and label shapes, and a metric that lands with
the wrong prefix, no help text, or a per-endpoint-ID label (unbounded
cardinality — one series per pod IP will eventually kill the Prometheus
that scrapes a large fleet) is a production incident deferred. This
check walks the process-global registry after importing every module
that registers instruments and enforces:

  OC001  every metric name is ``gie_``-prefixed (one namespace; the
         default python_/process_ collectors are not registered on the
         EPP's own registry).
  OC002  help text present and not just the name echoed back.
  OC003  label-set width bounded (<= MAX_LABELS): labels multiply
         series; anything wider than a few enum-ish dimensions belongs
         in the flight recorder, not the exposition. ``_info`` gauges
         get a wider bound (MAX_INFO_LABELS): the constant-1 info idiom
         is one series total no matter how many identity labels it
         carries, and build/feature-flag mixes legitimately stack up.
  OC004  no per-endpoint/per-request identity labels (endpoint, pod,
         ip, slot, trace/request IDs, url...): identity lives in
         exemplars and /debugz records, never in series labels.

Run: ``python -m gie_tpu_torch.obs.metricscheck`` (exit 1 on findings).
"""

from __future__ import annotations

import sys

MAX_LABELS = 4
MAX_INFO_LABELS = 8  # _info gauges: one constant-1 series by idiom

# Identity-shaped label names whose value sets scale with the pool or
# the request stream — per-series cardinality bombs.
FORBIDDEN_LABELS = frozenset({
    "endpoint", "hostport", "host", "pod", "pod_name", "ip", "address",
    "slot", "trace_id", "request_id", "url", "path", "id", "name",
})

# Label names histograms/summaries synthesize; never the catalog's.
_SYNTHETIC = frozenset({"le", "quantile"})


def check_registry(registry) -> list[str]:
    """-> list of human-readable findings (empty = catalog clean).
    ``registry`` is a list of runtime/metrics.py metrics, which carry
    their declared shape (name, help text, label names)."""
    findings: list[str] = []
    for metric in registry:
        labels = [ln for ln in metric.labelnames if ln not in _SYNTHETIC]
        findings.extend(_check_one(metric.family, metric.documentation,
                                   labels))
    return findings


def _check_one(name: str, doc: str, labels: list) -> list[str]:
    out = []
    if not name.startswith("gie_"):
        out.append(f"OC001 {name}: metric name must be gie_-prefixed")
    if not doc.strip() or doc.strip() == name:
        out.append(f"OC002 {name}: help text missing")
    bound = MAX_INFO_LABELS if name.endswith("_info") else MAX_LABELS
    if len(labels) > bound:
        out.append(
            f"OC003 {name}: {len(labels)} labels {sorted(labels)} exceeds "
            f"the {bound}-label cardinality bound")
    bad = sorted(set(labels) & FORBIDDEN_LABELS)
    if bad:
        out.append(
            f"OC004 {name}: per-identity label(s) {bad} — identity belongs "
            "in exemplars/flight-recorder records, not series labels")
    return out


def main(argv=None) -> int:
    # Import FOR REGISTRATION: every module that defines instruments on
    # the shared registry. runtime.metrics carries the whole catalog
    # (the pool-aggregate gauges register lazily — force them with a
    # stub snapshot so their names are checked too); runtime.tracing
    # adds gie_span_seconds.
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.runtime import tracing  # noqa: F401 — registers SPANS

    own_metrics.register_pool_aggregates(lambda: {})
    findings = check_registry(own_metrics.REGISTRY)
    for f in findings:
        print(f)
    n = len(own_metrics.REGISTRY)
    if findings:
        print(f"obs-check: {len(findings)} finding(s) over {n} metrics",
              file=sys.stderr)
        return 1
    print(f"obs-check: catalog clean ({n} metrics)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
