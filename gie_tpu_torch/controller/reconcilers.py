"""Pod + InferencePool reconcilers (copy of gie_tpu/controller/reconcilers.py).

Faithful behavioral port of reference pkg/lwepp/controller/
{inferencepool,pod}_reconciler.go onto the ClusterClient abstraction:

  InferencePoolReconciler (inferencepool_reconciler.go:37-78):
    not-found / deleting  -> datastore.clear()
    otherwise             -> to_endpoint_pool -> pool_set (with pod lister
                             for the resync-on-change path)

  PodReconciler (pod_reconciler.go:37-102):
    pool not synced       -> requeue 5 s
    not-found             -> pod_delete
    ready && labels match -> pod_update_or_add, else pod_delete

One graceful-drain deviation from the reference (docs/RESILIENCE.md): a
label-matching pod that stops being ready WHILE it still has serving
endpoints — rolling-upgrade termination (deletionTimestamp) or a failed
readiness probe mid-serve — is marked DRAINING instead of hard-deleted.
Its endpoints leave new-pick candidacy immediately, in-flight waves and
open streams complete against the live slot, and the slot reclaims at
the bounded drain deadline or on the pod's actual deletion event,
whichever arrives first. A pod that was never serving (or whose labels
left the pool) still hard-deletes: there is nothing to drain.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from gie_tpu_torch.controller.cluster import ClusterClient, WatchEvent
from gie_tpu_torch.datastore.datastore import Datastore
from gie_tpu_torch.utils.kubemeta import GKNN
from gie_tpu_torch.utils.podutil import is_pod_ready, to_endpoint_pool


@dataclasses.dataclass
class RequeueAfter:
    """Reconcile result asking the driver to retry later (reference
    pod_reconciler.go:44-47 requeue-5s-until-pool-synced)."""

    seconds: float


class InferencePoolReconciler:
    def __init__(self, client: ClusterClient, datastore: Datastore, pool_gknn: GKNN):
        self.client = client
        self.datastore = datastore
        self.pool_gknn = pool_gknn

    def reconcile(self, namespace: str, name: str) -> Optional[RequeueAfter]:
        # Scoped cache: only the configured pool identity is watched
        # (reference controller_manager.go:45-68 field-selector scoping).
        if (namespace, name) != (self.pool_gknn.namespace, self.pool_gknn.name):
            return None
        pool = self.client.get_pool(namespace, name)
        if pool is None or pool.metadata.deletionTimestamp is not None:
            self.datastore.clear()
            return None
        self.datastore.pool_set(
            to_endpoint_pool(pool),
            pod_lister=lambda: self.client.list_pods(namespace),
        )
        return None


class PodReconciler:
    def __init__(self, client: ClusterClient, datastore: Datastore):
        self.client = client
        self.datastore = datastore

    def reconcile(self, namespace: str, name: str,
                  obj: Optional[dict] = None) -> Optional[RequeueAfter]:
        if not self.datastore.pool_has_synced():
            return RequeueAfter(5.0)
        pool = self.datastore.pool_get()
        if namespace != pool.namespace:
            return None
        if obj is not None:
            # Informer-style pass-through: the watch/relist already carried
            # the manifest at this event's resourceVersion — no re-GET
            # (the reference gets this from controller-runtime's cache).
            from gie_tpu_torch.controller.kube import pod_from_k8s

            pod = pod_from_k8s(obj)
        else:
            pod = self.client.get_pod(namespace, name)
        if pod is None:
            self.datastore.pod_delete(namespace, name)
            return None
        labels_match = all(
            pod.labels.get(k) == v for k, v in pool.selector.items()
        )
        if is_pod_ready(pod) and labels_match:
            self.datastore.pod_update_or_add(pod)
        elif labels_match:
            # Still OUR pod, no longer ready: terminating (rolling
            # upgrade sets deletionTimestamp long before the pod object
            # disappears) or NotReady while serving. Drain instead of
            # hard-evicting — mark_draining returns False when the pod
            # has no serving endpoints, in which case there is nothing
            # to drain and the plain delete applies.
            if not self.datastore.pod_mark_draining(namespace, name):
                self.datastore.pod_delete(namespace, name)
        else:
            self.datastore.pod_delete(namespace, name)
        return None


def wire(
    cluster,
    pool_reconciler: InferencePoolReconciler,
    pod_reconciler: PodReconciler,
) -> None:
    """Subscribe both reconcilers to a cluster's watch stream (the manager
    wiring of reference runserver.go:78-93)."""

    def on_event(ev: WatchEvent) -> None:
        if ev.kind == "InferencePool":
            # Pool events always re-GET: there is one pool object, its
            # events are rare, and deletionTimestamp semantics stay in
            # one place (get_pool).
            pool_reconciler.reconcile(ev.namespace, ev.name)
        elif ev.kind == "Pod":
            pod_reconciler.reconcile(
                ev.namespace, ev.name, obj=getattr(ev, "object", None))

    cluster.subscribe(on_event)
