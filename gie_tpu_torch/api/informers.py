"""Shared informers + listers: the cached-client layer (SURVEY C3)
(copy of gie_tpu/api/informers.py).

The reference's generated clientset ships informers (watch-driven local
caches with event handlers) and listers (read-only snapshot views) under
client-go/ — controller-runtime builds its cached client on the same
machinery. This is the equivalent over the ClusterClient seam: a
SharedInformer keeps a thread-safe local cache of one kind in sync from the
cluster's watch fan-out, fires add/update/delete handlers, and hands out
Listers that read the CACHE, never the apiserver. A factory scopes one
informer per kind and gates start-up on cache sync, mirroring
SharedInformerFactory.Start / WaitForCacheSync.

Event flow mirrors client-go's reflector+indexer shape, simplified: the
watch event carries (kind, namespace, name) and the informer re-reads the
object through the client (the reconciler tier here is level-triggered the
same way, controller/reconcilers.py), so the cache holds the freshest
object without a delta queue.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, Optional, TypeVar

from gie_tpu_torch.controller.cluster import WatchEvent

T = TypeVar("T")

# Handler signature: (event_type, key, object-or-None for deletes).
EventHandler = Callable[[str, tuple[str, str], Optional[object]], None]


class Lister(Generic[T]):
    """Read-only snapshot view over an informer's cache (client-go lister:
    List/Get never touch the apiserver)."""

    def __init__(self, informer: "SharedInformer"):
        self._informer = informer

    def get(self, namespace: str, name: str) -> Optional[T]:
        with self._informer._lock:
            return self._informer._cache.get((namespace, name))

    def list(self, namespace: Optional[str] = None) -> list[T]:
        with self._informer._lock:
            items = list(self._informer._cache.items())
        if namespace is None:
            return [obj for _, obj in items]
        return [obj for (ns, _), obj in items if ns == namespace]


class SharedInformer(Generic[T]):
    """Watch-driven cache of one kind.

    `kind` matches WatchEvent.kind; `getter(ns, name)` re-reads one object;
    `initial_list()` returns the objects present at start (the reflector's
    initial LIST before the WATCH)."""

    def __init__(
        self,
        kind: str,
        getter: Callable[[str, str], Optional[T]],
        initial_list: Callable[[], list[tuple[tuple[str, str], T]]],
        namespace: Optional[str] = None,
    ):
        self.kind = kind
        self._getter = getter
        self._initial_list = initial_list
        # Scope: events outside this namespace are dropped (the reference
        # scopes its cache to the pool namespace the same way,
        # controller_manager.go:45-68). None = cluster-wide.
        self.namespace = namespace
        self._cache: dict[tuple[str, str], T] = {}
        self._lock = threading.RLock()
        self._handlers: list[EventHandler] = []
        self._synced = False

    # -- wiring ------------------------------------------------------------

    def add_event_handler(self, handler: EventHandler) -> None:
        """Register before OR after start: handlers added after cache sync
        receive synthetic ADDED events for everything cached (client-go
        AddEventHandler's replay semantics)."""
        replay: list[tuple[tuple[str, str], T]] = []
        with self._lock:
            self._handlers.append(handler)
            if self._synced:
                replay = list(self._cache.items())
        for key, obj in replay:
            handler("ADDED", key, obj)

    def start(self) -> None:
        """Initial LIST -> cache + ADDED fan-out, then mark synced. The
        owner must route subsequent watch events into on_event (the
        factory subscribes to the cluster's fan-out BEFORE the list, so a
        racing event may have populated the cache already — those keys are
        skipped: the watch path saw a fresher object than the list
        snapshot, and its handlers already fired)."""
        items = self._initial_list()
        fresh: list[tuple[tuple[str, str], T]] = []
        with self._lock:
            for key, obj in items:
                if key in self._cache:
                    continue
                self._cache[key] = obj
                fresh.append((key, obj))
            self._synced = True
            handlers = list(self._handlers)
        for key, obj in fresh:
            for h in handlers:
                h("ADDED", key, obj)

    def has_synced(self) -> bool:
        with self._lock:
            return self._synced

    def lister(self) -> Lister[T]:
        return Lister(self)

    # -- event ingestion ---------------------------------------------------

    def on_event(self, event: WatchEvent) -> None:
        if event.kind != self.kind:
            return
        if self.namespace is not None and event.namespace != self.namespace:
            return
        key = (event.namespace, event.name)
        if event.type == "DELETED":
            with self._lock:
                existed = self._cache.pop(key, None) is not None
                handlers = list(self._handlers)
            if existed:
                for h in handlers:
                    h("DELETED", key, None)
            return
        obj = self._getter(event.namespace, event.name)
        if obj is None:
            # The object vanished between the event and the re-read: treat
            # as a delete (level-triggered semantics).
            self.on_event(WatchEvent("DELETED", event.kind,
                                     event.namespace, event.name))
            return
        with self._lock:
            is_new = key not in self._cache
            self._cache[key] = obj
            handlers = list(self._handlers)
        for h in handlers:
            h("ADDED" if is_new else "MODIFIED", key, obj)


class SharedInformerFactory:
    """One informer per kind over a ClusterClient (clientset's
    SharedInformerFactory). The cluster must expose subscribe() (watch
    fan-out — FakeCluster and KubeClusterClient both do), get_pool/get_pod,
    and list_pods; pools are discovered via the namespaces+names seen at
    subscribe time plus watch events (the reference scopes its cache to the
    pool namespace the same way, controller_manager.go:45-68)."""

    def __init__(self, cluster, namespace: str,
                 pool_names: Optional[list[str]] = None):
        self.cluster = cluster
        self.namespace = namespace
        self._pool_names = list(pool_names or [])
        self._pods = SharedInformer[object](
            "Pod",
            cluster.get_pod,
            lambda: [
                ((p.namespace, p.name), p)
                for p in cluster.list_pods(namespace)
            ],
            namespace=namespace,
        )
        self._pools = SharedInformer[object](
            "InferencePool",
            cluster.get_pool,
            lambda: [
                ((namespace, n), pool)
                for n in self._pool_names
                if (pool := cluster.get_pool(namespace, n)) is not None
            ],
            namespace=namespace,
        )
        self._started = False

    def pods(self) -> SharedInformer:
        return self._pods

    def pools(self) -> SharedInformer:
        return self._pools

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        # Subscribe BEFORE the initial list so no event can fall between
        # list and watch (the reflector's list+watch ordering guarantee,
        # inverted: our fan-out is synchronous, so early events simply
        # re-read the object).
        self.cluster.subscribe(self._pods.on_event)
        self.cluster.subscribe(self._pools.on_event)
        self._pods.start()
        self._pools.start()

    def wait_for_cache_sync(self) -> bool:
        return self._pods.has_synced() and self._pools.has_synced()
