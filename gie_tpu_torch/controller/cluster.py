"""Cluster client abstraction + in-memory fake (copy of
gie_tpu/controller/cluster.py).

The reference consumes the kube-apiserver through controller-runtime's cached
client with namespace/name-scoped caches (reference
pkg/lwepp/server/controller_manager.go:45-68). This module defines the narrow
client surface the reconcilers need (get/list/watch) and an in-memory
FakeCluster implementing it — the test tier's stand-in for envtest/fake
client (reference test strategy, SURVEY.md section 4), and the seam where a
real kubernetes client plugs in when one is available.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable, Iterator, Optional, Protocol

from gie_tpu_torch.api.types import InferencePool
from gie_tpu_torch.datastore.objects import Pod


@dataclasses.dataclass
class WatchEvent:
    """ADDED / MODIFIED / DELETED event for a Pod or InferencePool."""

    type: str        # "ADDED" | "MODIFIED" | "DELETED"
    kind: str        # "Pod" | "InferencePool"
    namespace: str
    name: str
    # Raw manifest carried by the watch stream / relist (informer-style
    # pass-through so per-event reconciles need no re-GET). None for
    # DELETED events and for sources that don't carry objects
    # (FakeCluster) — consumers fall back to a client GET.
    object: Optional[dict] = None


class ClusterClient(Protocol):
    def get_pod(self, namespace: str, name: str) -> Optional[Pod]: ...

    def list_pods(self, namespace: str) -> list[Pod]: ...

    def get_pool(self, namespace: str, name: str) -> Optional[InferencePool]: ...


class FakeCluster:
    """In-memory apiserver: objects + synchronous watch fan-out.

    Doubles as the fake-clientset analogue (reference C3
    client-go/clientset/versioned/fake/): every client call is recorded in
    `actions` as (verb, resource, "namespace/name") — the clienttesting
    Actions() surface — and `add_reactor(verb, resource, fn)` intercepts
    calls the way client-go reactors do: fn(action) returns
    (handled, result); handled short-circuits the real store, and fn may
    raise to simulate apiserver errors (conflicts, timeouts)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._pods: dict[tuple[str, str], Pod] = {}
        self._pools: dict[tuple[str, str], InferencePool] = {}
        self._subscribers: list[Callable[[WatchEvent], None]] = []
        # Bounded: FakeCluster also backs long-running simulated
        # deployments (runtime/main.py --demo), where unbounded action
        # history would be a slow leak; 10k covers any test's assertions.
        self.actions: "deque[tuple[str, str, str]]" = deque(maxlen=10_000)
        self._reactors: list[tuple[str, str, Callable]] = []

    # -- fake-clientset surface (actions + reactors) -----------------------

    def add_reactor(self, verb: str, resource: str, fn: Callable) -> None:
        """Intercept `verb` on `resource` ("*" wildcards allowed).
        fn((verb, resource, key)) -> (handled, result)."""
        self._reactors.append((verb, resource, fn))

    def _react(self, verb: str, resource: str, key: str):
        self.actions.append((verb, resource, key))
        for rv, rr, fn in self._reactors:
            if rv in (verb, "*") and rr in (resource, "*"):
                handled, result = fn((verb, resource, key))
                if handled:
                    return True, result
        return False, None

    # -- client surface ----------------------------------------------------

    def get_pod(self, namespace: str, name: str) -> Optional[Pod]:
        handled, result = self._react("get", "pods", f"{namespace}/{name}")
        if handled:
            return result
        with self._lock:
            return self._pods.get((namespace, name))

    def list_pods(self, namespace: str) -> list[Pod]:
        handled, result = self._react("list", "pods", namespace)
        if handled:
            return result
        with self._lock:
            return [p for (ns, _), p in self._pods.items() if ns == namespace]

    def get_pool(self, namespace: str, name: str) -> Optional[InferencePool]:
        handled, result = self._react(
            "get", "inferencepools", f"{namespace}/{name}")
        if handled:
            return result
        with self._lock:
            return self._pools.get((namespace, name))

    # -- mutation (test driver / simulator side) ---------------------------

    def apply_pod(self, pod: Pod) -> None:
        handled, _ = self._react(
            "apply", "pods", f"{pod.namespace}/{pod.name}")
        if handled:
            return
        with self._lock:
            key = (pod.namespace, pod.name)
            etype = "MODIFIED" if key in self._pods else "ADDED"
            self._pods[key] = pod
        self._emit(WatchEvent(etype, "Pod", pod.namespace, pod.name))

    def delete_pod(self, namespace: str, name: str) -> None:
        handled, _ = self._react("delete", "pods", f"{namespace}/{name}")
        if handled:
            return
        with self._lock:
            self._pods.pop((namespace, name), None)
        self._emit(WatchEvent("DELETED", "Pod", namespace, name))

    def apply_pool(self, pool: InferencePool) -> None:
        pool.validate()
        handled, _ = self._react(
            "apply", "inferencepools",
            f"{pool.metadata.namespace}/{pool.metadata.name}")
        if handled:
            return
        with self._lock:
            key = (pool.metadata.namespace, pool.metadata.name)
            etype = "MODIFIED" if key in self._pools else "ADDED"
            self._pools[key] = pool
        self._emit(
            WatchEvent(etype, "InferencePool", pool.metadata.namespace,
                       pool.metadata.name)
        )

    def delete_pool(self, namespace: str, name: str) -> None:
        handled, _ = self._react(
            "delete", "inferencepools", f"{namespace}/{name}")
        if handled:
            return
        with self._lock:
            self._pools.pop((namespace, name), None)
        self._emit(WatchEvent("DELETED", "InferencePool", namespace, name))

    # -- watch -------------------------------------------------------------

    def subscribe(self, fn: Callable[[WatchEvent], None]) -> None:
        self._subscribers.append(fn)

    def _emit(self, event: WatchEvent) -> None:
        for fn in list(self._subscribers):
            fn(event)

    def events(self) -> Iterator[WatchEvent]:  # pragma: no cover - helper
        raise NotImplementedError
