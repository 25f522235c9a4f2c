"""Pool status choreography: per-parent Accepted / ResolvedRefs conditions
(copy of gie_tpu/controller/status.py).

The reference's condition set lives on InferencePool.status.parents
(reference api/v1/inferencepool_types.go:192-379): one entry per parent
(Gateway), each carrying Accepted (the parent supports routing to the pool)
and ResolvedRefs (the endpointPickerRef resolves to an existing Service).
In the reference ecosystem the gateway implementation owns these writes;
this module exposes the same computation for BOTH consumers:

  - conformance/harness.py's in-process gateway controller, and
  - PoolStatusController, which publishes through a real apiserver via the
    kube adapter's status-subresource patch (KubeClusterClient.
    patch_pool_status), so a real-cluster deployment surfaces conditions.
"""

from __future__ import annotations

from typing import Callable, Iterable

from gie_tpu_torch.api import types as api


def desired_parent_statuses(
    pool: api.InferencePool,
    parents: Iterable[str],
    service_exists: Callable[[str, str], bool],
) -> list[api.ParentStatus]:
    """The per-parent condition set for a pool referenced by `parents`.

    `service_exists(namespace, name)` answers whether the EPP Service the
    endpointPickerRef names is present. Parent entries owned by other
    controllers (the multi-cluster export entry with parentRef kind
    InferencePoolImport) are NOT produced here — callers preserve those
    separately (1374 README ControllerName contract)."""
    namespace = pool.metadata.namespace
    out: list[api.ParentStatus] = []
    for gw_name in sorted(parents):
        parent = api.ParentStatus(
            parentRef=api.ParentReference(name=gw_name)
        )
        parent.set_condition(api.Condition(
            api.COND_ACCEPTED, "True", api.REASON_ACCEPTED,
            "supported by parent"))
        epp = pool.spec.endpointPickerRef
        if epp is None:
            # This implementation supports EPP-less pools (plain
            # round-robin), so Accepted stays True
            # (InferencePoolMissingEPPRef allows either semantic).
            parent.set_condition(api.Condition(
                api.COND_RESOLVED_REFS, "True",
                api.REASON_RESOLVED_REFS, "no endpointPickerRef"))
        elif not service_exists(namespace, epp.name):
            parent.set_condition(api.Condition(
                api.COND_RESOLVED_REFS, "False",
                api.REASON_INVALID_EXTENSION_REF,
                f"BackendNotFound: Service {epp.name}"))
        else:
            parent.set_condition(api.Condition(
                api.COND_RESOLVED_REFS, "True",
                api.REASON_RESOLVED_REFS, "ok"))
        out.append(parent)
    return out


def merge_parent_statuses(
    existing: list[api.ParentStatus],
    computed: list[api.ParentStatus],
) -> list[api.ParentStatus]:
    """Foreign-controller entries (export controller's InferencePoolImport
    parentRef) survive; gateway-owned entries are replaced wholesale."""
    preserved = [p for p in existing
                 if p.parentRef.kind == "InferencePoolImport"]
    return preserved + computed


class PoolStatusController:
    """Publishes the pool's parent conditions to a real apiserver.

    The client needs `get_pool(ns, name)` and
    `patch_pool_status(ns, name, status)` (KubeClusterClient provides both;
    tests use a duck-typed fake). `parents` is the set of Gateways routing
    to the pool — on a real cluster this comes from the implementation's
    HTTPRoute view (flag-fed for a standalone EPP deployment)."""

    def __init__(
        self,
        client,
        namespace: str,
        pool_name: str,
        parents: Iterable[str],
        service_exists: Callable[[str, str], bool],
    ):
        self.client = client
        self.namespace = namespace
        self.pool_name = pool_name
        self.parents = list(parents)
        self.service_exists = service_exists

    def reconcile(self) -> bool:
        """Compute + patch; returns False when the pool is absent.

        metav1.Condition contract: lastTransitionTime moves only when the
        condition's status actually transitions — unchanged conditions
        carry their previous timestamp forward, and a patch is skipped
        entirely when nothing changed (no resourceVersion churn, no
        spurious watcher wakeups)."""
        pool = self.client.get_pool(self.namespace, self.pool_name)
        if pool is None:
            return False
        before = pool.status.parents
        computed = desired_parent_statuses(
            pool, self.parents, self.service_exists)
        _carry_transition_times(before, computed)
        merged = merge_parent_statuses(before, computed)
        if _conditions_equal(before, merged):
            return True
        pool.status.parents = merged
        pool.status.validate()
        self.client.patch_pool_status(
            self.namespace, self.pool_name, pool.status)
        return True


def _carry_transition_times(
    existing: list[api.ParentStatus],
    computed: list[api.ParentStatus],
) -> None:
    """Copy lastTransitionTime from existing conditions whose (parentRef,
    type) matches and whose status did not change."""
    by_ref = {
        (p.parentRef.kind, p.parentRef.name): p for p in existing
    }
    for parent in computed:
        prev = by_ref.get((parent.parentRef.kind, parent.parentRef.name))
        if prev is None:
            continue
        for cond in parent.conditions:
            old = prev.get_condition(cond.type)
            if old is not None and old.status == cond.status:
                cond.lastTransitionTime = old.lastTransitionTime


def _conditions_equal(
    a: list[api.ParentStatus], b: list[api.ParentStatus]
) -> bool:
    def key(parents):
        return [
            (
                p.parentRef.kind, p.parentRef.name, p.parentRef.namespace,
                [(c.type, c.status, c.reason, c.message,
                  c.lastTransitionTime) for c in p.conditions],
            )
            for p in parents
        ]

    return key(a) == key(b)
