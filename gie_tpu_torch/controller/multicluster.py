"""Multi-cluster inference: export annotation -> InferencePoolImport
(copy of gie_tpu/controller/multicluster.py).

Port of reference docs/proposals/1374-multi-cluster-inference/README.md:36-53
and the InferencePoolImport API (apix/v1alpha1): a pool annotated
`inference.networking.x-k8s.io/export: ClusterSet` is exported from its home
cluster; the multi-cluster controller materializes a same-name
InferencePoolImport in every OTHER member cluster, recording the exporting
cluster(s) in status.controllers, and maintains the pool's Exported
condition (Exported / NotRequested / NotSupported,
reference api/v1/inferencepool_types.go:352-379).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from gie_tpu_torch.api import types as api
from gie_tpu_torch.runtime.logging import get_logger

CONTROLLER_NAME = "gie-tpu.inference.networking.k8s.io/multicluster"

# Routing modes (reference 1374 README:48-53): an implementation must
# support at least one; this one supports both.
#   Endpoint: importing IG routes to endpoints selected by the EPP of the
#       exported pool (pod/service connectivity between clusters).
#   Parent: importing IG routes to a parent (Gateway) of the exported pool
#       (parent connectivity between clusters); the remote gateway performs
#       its own EPP exchange.
ROUTING_MODE_ENDPOINT = "Endpoint"
ROUTING_MODE_PARENT = "Parent"


class ClusterSet:
    """A named set of member clusters, each holding pools and imports."""

    def __init__(self, members: list[str]):
        self.members = list(members)
        # (cluster, namespace, name) -> object
        self.pools: dict[tuple[str, str, str], api.InferencePool] = {}
        self.imports: dict[tuple[str, str, str], api.InferencePoolImport] = {}

    def apply_pool(self, cluster: str, pool: api.InferencePool) -> None:
        if cluster not in self.members:
            raise ValueError(f"unknown member cluster {cluster!r}")
        pool.validate()
        self.pools[(cluster, pool.metadata.namespace, pool.metadata.name)] = pool
        self.reconcile()

    def delete_pool(self, cluster: str, namespace: str, name: str) -> None:
        self.pools.pop((cluster, namespace, name), None)
        self.reconcile()

    def get_import(
        self, cluster: str, namespace: str, name: str
    ) -> Optional[api.InferencePoolImport]:
        return self.imports.get((cluster, namespace, name))

    # ------------------------------------------------------------------ #

    def reconcile(self) -> None:
        """Recompute all imports + Exported conditions from pool state."""
        desired: dict[tuple[str, str, str], list[str]] = {}
        for (cluster, ns, name), pool in self.pools.items():
            raw = pool.metadata.annotations.get(api.EXPORT_ANNOTATION)
            exported = raw == api.EXPORT_SCOPE_CLUSTERSET
            # Exported condition on the pool itself; a present-but-unknown
            # scope is NotSupported, absence is NotRequested
            # (reference inferencepool_types.go:352-379 reason set).
            self._set_exported_condition(pool, exported, raw)
            if not exported:
                continue
            for member in self.members:
                if member == cluster:
                    continue
                desired.setdefault((member, ns, name), []).append(cluster)

        # Materialize / update imports.
        for key, exporting in desired.items():
            member, ns, name = key
            imp = self.imports.get(key)
            if imp is None:
                imp = api.InferencePoolImport(
                    metadata=api.ObjectMeta(name=name, namespace=ns)
                )
                self.imports[key] = imp
            # Update ONLY this controller's entry: controllers[] is shared
            # with importing-side controllers (e.g. the gateway controller's
            # parents entry), and each controller owns exactly its own
            # entries (1374 README ControllerName contract).
            entry = api.ImportController(
                name=CONTROLLER_NAME,
                exportingClusters=[
                    api.ExportingCluster(name=c) for c in sorted(exporting)
                ],
            )
            others = [c for c in imp.status.controllers
                      if c.name != CONTROLLER_NAME]
            imp.status.controllers = [entry] + others
        # Prune imports whose export stopped.
        for key in [k for k in self.imports if k not in desired]:
            del self.imports[key]

    @staticmethod
    def _set_exported_condition(
        pool: api.InferencePool, exported: bool, raw_scope
    ) -> None:
        """Maintain the export-controller parent entry: a parentRef of kind
        InferencePoolImport with the ns/name of the exported pool (1374
        README 'InferencePool Status' MUST), carrying the Exported
        condition (reasons Exported / NotRequested / NotSupported,
        reference api/v1/inferencepool_types.go:352-379)."""
        ours = [p for p in pool.status.parents
                if p.parentRef.kind == "InferencePoolImport"]
        others = [p for p in pool.status.parents
                  if p.parentRef.kind != "InferencePoolImport"]
        if exported:
            cond = api.Condition(api.COND_EXPORTED, "True",
                                 api.REASON_EXPORTED,
                                 "exported to ClusterSet")
        elif raw_scope is not None:
            cond = api.Condition(api.COND_EXPORTED, "False",
                                 api.REASON_NOT_SUPPORTED,
                                 f"unsupported export scope {raw_scope!r}")
        else:
            cond = api.Condition(api.COND_EXPORTED, "False",
                                 api.REASON_NOT_REQUESTED,
                                 "no export annotation")
        if ours:
            ps = ours[0]
        else:
            ps = api.ParentStatus(parentRef=api.ParentReference(
                name=pool.metadata.name,
                namespace=pool.metadata.namespace,
                group=api.GROUP_X,
                kind="InferencePoolImport",
            ))
        ps.set_condition(cond)
        pool.status.parents = others + [ps]


class MultiClusterController:
    """ClusterSet reconciliation over LIVE cluster watches
    (docs/FEDERATION.md "control plane"): one apiserver client per
    member cluster, pool watch events funneled through a single worker
    thread driving the in-memory :class:`ClusterSet`, whose outcome is
    pushed back out — InferencePoolImport objects materialized /
    updated / deleted in every importing member, and the Exported
    condition patched onto the exporting pool's status.

    Single-threaded by construction (one queue, one worker): no lock is
    held across the apiserver HTTP calls, and event order per cluster
    is the watch's own order. Clients need the KubeClusterClient
    surface (``_json`` + ``subscribe``/``start`` + pool paths); the
    fakeapi server drives the whole loop in tests
    (tests/test_federation.py)."""

    def __init__(self, clients: dict, namespace: str = "default"):
        self.clients = dict(clients)
        self.namespace = namespace
        self.cluster_set = ClusterSet(sorted(self.clients))
        self.log = get_logger("multicluster")
        self._queue: "queue.Queue[tuple]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # (cluster, ns, name) keys of imports THIS controller wrote:
        # the delete sweep is written-minus-desired (we own exactly our
        # entries, never another controller's objects). Desired imports
        # are ALWAYS re-PUT on reconcile — level-triggered repair of
        # out-of-band deletions, see _push_imports.
        self._written: set = set()
        self.reconciles = 0

    # -- wiring ------------------------------------------------------------

    def start(self) -> None:
        for cluster, client in self.clients.items():
            client.subscribe(
                lambda ev, c=cluster: self._on_event(c, ev))
            client.start()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="multicluster", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        for client in self.clients.values():
            client.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _on_event(self, cluster: str, ev) -> None:
        if getattr(ev, "kind", "") == "InferencePool":
            self._queue.put((cluster, ev))

    # -- worker ------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                cluster, ev = self._queue.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                self._handle(cluster, ev)
                self.reconciles += 1
            except Exception as e:  # the control loop must never die
                self.log.error("multicluster reconcile failed",
                               cluster=cluster, err=e)

    def _handle(self, cluster: str, ev) -> None:
        from gie_tpu_torch.controller.kube import ApiError, pool_status_to_dict

        cs = self.cluster_set
        if ev.type == "DELETED":
            cs.delete_pool(cluster, ev.namespace, ev.name)
        else:
            obj = getattr(ev, "object", None)
            pool = (api.pool_from_dict(obj) if isinstance(obj, dict)
                    else self.clients[cluster].get_pool(
                        ev.namespace, ev.name))
            if pool is None:
                cs.delete_pool(cluster, ev.namespace, ev.name)
            else:
                before = pool_status_to_dict(pool.status)
                cs.apply_pool(cluster, pool)
                # Exported condition back onto the exporting pool — only
                # when reconcile CHANGED it: our own status patch emits a
                # MODIFIED event, and an unconditional re-patch would
                # chase its own tail forever.
                if pool_status_to_dict(pool.status) != before:
                    try:
                        self.clients[cluster].patch_pool_status(
                            ev.namespace, ev.name, pool.status)
                    except ApiError as e:
                        if e.status != 404:
                            raise
                        # Deleted between the event and the patch: the
                        # DELETED event is already behind us in the queue.
        self._push_imports()

    def _imports_path(self, ns: str) -> str:
        return (f"/apis/{api.GROUP_X}/{api.VERSION_X}/namespaces/{ns}"
                "/inferencepoolimports")

    def _push_imports(self) -> None:
        from gie_tpu_torch.controller.kube import ApiError

        desired = dict(self.cluster_set.imports)
        for (cluster, ns, name), imp in desired.items():
            client = self.clients.get(cluster)
            if client is None:
                continue
            body = api.import_to_dict(imp)
            body["metadata"]["namespace"] = ns
            path = f"{self._imports_path(ns)}/{name}"
            # Level-triggered: ALWAYS write the desired import on a
            # reconcile (an out-of-band deletion leaves no InferencePool
            # event, so a changed-body dedup would suppress the repair
            # forever; the controller has no import watch — noted as a
            # residual in docs/FEDERATION.md). PUT repairs in place,
            # POST covers the missing object.
            try:
                client._json("PUT", path, body)
            except Exception:
                try:
                    client._json("POST", self._imports_path(ns), body)
                except Exception as e:
                    self.log.error("import write failed", cluster=cluster,
                                   name=name, err=e)
                    continue
            self._written.add((cluster, ns, name))
        for key in sorted(self._written - set(desired)):
            cluster, ns, name = key
            client = self.clients.get(cluster)
            if client is None:
                continue
            try:
                client._json("DELETE", f"{self._imports_path(ns)}/{name}")
            except ApiError as e:
                if e.status != 404:
                    self.log.error("import delete failed", cluster=cluster,
                                   name=name, err=e)
                    continue
                # Already gone (out-of-band delete): the desired state
                # holds — forget it rather than retrying a 404 forever.
            except Exception as e:
                self.log.error("import delete failed", cluster=cluster,
                               name=name, err=e)
                continue
            self._written.discard(key)
