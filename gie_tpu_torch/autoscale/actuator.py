"""ReplicaActuator: apply replica recommendations to the model-server
workload (copy of gie_tpu/autoscale/actuator.py).

Speaks to the apiserver through the stdlib kube client's `_json` HTTP
core (controller/kube.py — the same seam leader election uses), so it
works against a real cluster and the in-process fake apiserver alike. The
write is a server-side-apply patch on the Deployment scoped to ONE field
(`spec.replicas`, fieldManager gie-tpu-autoscale): SSA keeps field
ownership honest — this controller owns the replica count and nothing
else, and a human `kubectl apply` that stops specifying replicas cedes
the field instead of fighting the loop.

Two gates sit in front of every write:

  leader   — in multi-replica EPP deployments only the LEADER may
             actuate (the same `is_leader` readiness predicate the
             ext-proc data plane gates on); followers run the full
             signal->recommendation loop warm but write nothing.
  dry-run  — recommend-only mode exports gie_autoscale_* metrics and
             skips the patch, so operators can watch the recommendation
             stream against their own HPA before handing over control.
"""

from __future__ import annotations

from typing import Callable, Optional

from gie_tpu_torch.autoscale.recommender import Recommendation
from gie_tpu_torch.resilience import faults
from gie_tpu_torch.resilience.policy import BackoffPolicy, retry_call
from gie_tpu_torch.runtime import metrics as own_metrics
from gie_tpu_torch.runtime.logging import get_logger

FIELD_MANAGER = "gie-tpu-autoscale"

# One-shot patch retry (resilience/policy.py): before this policy a
# failed SSA patch was retried only at the NEXT control cycle (seconds
# away) — a transient apiserver blip cost a full actuation interval.
# Three in-call attempts with a short jittered backoff absorb blips; a
# real outage still degrades to "error" and the next cycle re-derives.
PATCH_RETRY = BackoffPolicy(base_s=0.1, max_s=1.0)
PATCH_ATTEMPTS = 3


class ReplicaActuator:
    """`client` is anything exposing the stdlib adapter's
    `_json(method, path, body, content_type=...)` core (KubeClusterClient
    or a test fake); None means there is nothing to actuate against and
    every apply degrades to recommend-only."""

    def __init__(
        self,
        client,
        namespace: str,
        target: Optional[str],
        *,
        dry_run: bool = False,
        is_leader: Optional[Callable[[], bool]] = None,
    ):
        self.client = client
        self.namespace = namespace
        self.target = target
        self.dry_run = dry_run
        self.is_leader = is_leader
        self.log = get_logger("autoscale.actuator")

    def _path(self) -> str:
        return (f"/apis/apps/v1/namespaces/{self.namespace}"
                f"/deployments/{self.target}")

    def current_replicas(self) -> Optional[int]:
        """The workload's CONFIGURED replica count (spec, not status):
        the recommender must reason against what was already asked for,
        or it re-asks every cycle while pods are still coming up."""
        if self.client is None or not self.target:
            return None
        from gie_tpu_torch.controller.kube import ApiError

        try:
            body = self.client._json("GET", self._path())
        except ApiError as e:
            if e.status == 404:
                return None
            raise
        replicas = (body.get("spec") or {}).get("replicas")
        return int(replicas) if replicas is not None else None

    def apply(self, rec: Recommendation) -> str:
        """Actuate one recommendation; returns the outcome label
        (`patched` / `noop` / `dry_run` / `not_leader` / `no_target` /
        `error`), which is also counted on gie_autoscale_apply_total."""
        outcome = self._apply(rec)
        own_metrics.AUTOSCALE_APPLIED.labels(outcome=outcome).inc()
        return outcome

    def _apply(self, rec: Recommendation) -> str:
        if rec.desired == rec.current:
            return "noop"
        if self.is_leader is not None and not self.is_leader():
            # Follower replicas keep their control loop warm (signals,
            # capacity EWMA) but never write — exactly one actuator.
            return "not_leader"
        if self.dry_run:
            self.log.info(
                "autoscale recommendation (dry-run)",
                current=rec.current, desired=rec.desired, reason=rec.reason)
            return "dry_run"
        if self.client is None or not self.target:
            return "no_target"
        def _patch():
            if faults.ENABLED:
                # gie-chaos: a kube-API outage is a failing SSA patch.
                faults.check("kube.patch", key=self.target or "")
            self.client._json(
                "PATCH",
                f"{self._path()}?fieldManager={FIELD_MANAGER}&force=true",
                {
                    "apiVersion": "apps/v1",
                    "kind": "Deployment",
                    "metadata": {"name": self.target,
                                 "namespace": self.namespace},
                    "spec": {"replicas": rec.desired},
                },
                content_type="application/apply-patch+yaml",
            )

        try:
            # retry_on=OSError: network-shaped failures only (URLError /
            # ConnectionError / timeouts — what "apiserver blip" means).
            # Deterministic rejections surface as ApiError (RuntimeError:
            # 404 target, 403 RBAC, 422 schema) and must NOT burn 3
            # patch attempts + sleeps per cycle on a request that can
            # never succeed — they degrade to "error" immediately and
            # the next cycle re-derives.
            retry_call(_patch, PATCH_RETRY, attempts=PATCH_ATTEMPTS,
                       retry_on=(OSError,))
        except Exception as e:
            # The loop must survive apiserver unavailability: the next
            # cycle re-derives the recommendation from fresh signals.
            self.log.error("autoscale patch failed", err=e)
            return "error"
        self.log.info(
            "autoscale applied", target=self.target,
            current=rec.current, desired=rec.desired, reason=rec.reason)
        return "patched"
