"""ReplicaActuator: apply replica recommendations to the model-server
workload (port of gie_tpu/autoscale/actuator.py, recommend-only).

The reference writes the recommendation as a server-side-apply patch of
the Deployment's `spec.replicas` through the stdlib kube client. The port
has no kube client yet (it comes with the kube slice, with the
`kube.patch` fault point and `--autoscale-mode apply`), so an actuator is
built with no client and never writes: every recommendation ends as
`noop`, `not_leader`, `dry_run` or `no_target`, counted on
gie_autoscale_apply_total exactly as the reference counts them. A client
is refused with the port's not-ported error.

Two gates sit in front of every write, as in the reference:

  leader   — in multi-replica EPP deployments only the LEADER may
             actuate; followers run the full signal->recommendation loop
             warm but write nothing.
  dry-run  — recommend-only mode exports gie_autoscale_* metrics and
             skips the patch, so operators can watch the recommendation
             stream against their own HPA before handing over control.
"""

from __future__ import annotations

from typing import Callable, Optional

from gie_tpu_torch.autoscale.recommender import Recommendation
from gie_tpu_torch.runtime import metrics as own_metrics
from gie_tpu_torch.runtime.logging import get_logger
from gie_tpu_torch.sched.profile import _not_ported


class ReplicaActuator:
    """`client` must be None in the port (nothing to actuate against:
    every apply that would write degrades to recommend-only)."""

    def __init__(
        self,
        client,
        namespace: str,
        target: Optional[str],
        *,
        dry_run: bool = False,
        is_leader: Optional[Callable[[], bool]] = None,
    ):
        if client is not None:
            raise _not_ported("the autoscale actuator's Deployment patch",
                              "kube")
        self.client = None
        self.namespace = namespace
        self.target = target
        self.dry_run = dry_run
        self.is_leader = is_leader
        self.log = get_logger("autoscale.actuator")

    def current_replicas(self) -> Optional[int]:
        """The workload's configured replica count; None with no client
        (the controller then recommends against the ready count)."""
        return None

    def apply(self, rec: Recommendation) -> str:
        """Actuate one recommendation; returns the outcome label
        (`noop` / `dry_run` / `not_leader` / `no_target`), which is also
        counted on gie_autoscale_apply_total."""
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
        return "no_target"
