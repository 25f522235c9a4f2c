"""(Copy of gie_tpu/datastore/datastore.py, imports rewritten to gie_tpu_torch.)

Thread-safe datastore: pool spec + per-(pod, rank) endpoints + slot map.

Re-design of reference pkg/lwepp/datastore/datastore.go:67-334 with one TPU
addition: a dense slot allocator. Every endpoint owns a stable slot in
[0, M_MAX) for as long as it lives; the scheduler's device state (assumed
load, prefix presence columns) is indexed by slot, so pod churn translates to
mask flips and column clears — never to a shape change or recompile.

Semantics preserved from the reference:
  - pool must be set before pods are admitted (errPoolNotSynced,
    datastore.go:54)
  - one endpoint per (pod, targetPort index "rank"), named
    `<pod>-rank-<idx>` (datastore.go:329-334)
  - the `inference.networking.k8s.io/active-ports` annotation filters which
    ranks are active per pod, as a comma-separated port list restricted to
    the pool's targetPorts (datastore.go:307-325)
  - selector/targetPorts change triggers a full resync against a pod lister
    (datastore.go:131-147, 267-304)
  - Clear() drops everything (pool deletion, datastore.go:111-116)
"""

from __future__ import annotations

import heapq
import threading
from typing import Callable, Iterable, Optional

from gie_tpu_torch.datastore.objects import Endpoint, EndpointPool, Pod
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.api.types import ACTIVE_PORTS_ANNOTATION


class PoolNotSyncedError(RuntimeError):
    """InferencePool is not initialized in the data store."""


# Called with the freed slot whenever an endpoint is removed, so the
# scheduler can invalidate per-slot device state (prefix presence, assumed
# load) before the slot is reused. Invoked AFTER the datastore lock is
# released: the callback may block (device dispatch; scrape-engine detach
# itself is O(1) and non-blocking) and must not stall concurrent
# data-plane readers.
SlotReclaimedFn = Callable[[int], None]


def _active_ports(pod: Pod, target_ports: list[int]) -> list[int]:
    """Parse the active-ports annotation (reference datastore.go:307-325):
    absent -> all target ports; present -> intersection with targetPorts."""
    raw = pod.annotations.get(ACTIVE_PORTS_ANNOTATION)
    if raw is None:
        return list(target_ports)
    allowed = set(target_ports)
    active = []
    for part in raw.split(","):
        part = part.strip()
        try:
            num = int(part)
        except ValueError:
            continue
        if num > 0 and num in allowed:
            active.append(num)
    return active


class Datastore:
    """In-memory cache shared by reconcilers (writers) and the request path
    (readers). Reference interface: datastore.go:67-84."""

    def __init__(
        self,
        on_slot_reclaimed: Optional[SlotReclaimedFn] = None,
        max_slots: int = C.M_MAX,
        drain_deadline_s: float = 30.0,
        clock=None,
    ):
        # Clock seam (runtime/clock.py): drain deadlines are behavior —
        # a virtual-time storm's rolling upgrade must reap on the
        # simulated timeline. A callable returning seconds; defaults to
        # the monotonic clock.
        if clock is None:
            from gie_tpu_torch.runtime.clock import MONOTONIC

            clock = MONOTONIC.now
        self._clock = clock
        self._lock = threading.RLock()
        self._pool: Optional[EndpointPool] = None
        self._endpoints: dict[str, Endpoint] = {}  # key: "<ns>/<pod>-rank-<i>"
        # hostport index for the served-feedback hot path (one lookup per
        # response instead of an O(n) scan).
        self._by_hostport: dict[str, Endpoint] = {}
        self._free_slots: list[int] = list(range(max_slots))
        heapq.heapify(self._free_slots)
        self._on_slot_reclaimed = on_slot_reclaimed
        self._max_slots = max_slots
        # Slots freed under the lock, awaiting callback delivery outside it.
        self._pending_reclaims: list[int] = []
        # Admissions refused because every slot was taken (degrade mode).
        self._overflow = 0
        # Admission fast path (extproc/server.py): the full-endpoint list
        # is read once per REQUEST but changes only on pod churn, so a
        # cached snapshot turns the per-request O(endpoints) copy-under-
        # lock into one attribute read. Invalidated (None) by every
        # membership mutation; callers must treat the returned list as
        # immutable. pool_generation lets the ext-proc layer cache
        # pool-derived decisions (appProtocol transcoding) the same way.
        self._snapshot: Optional[list[Endpoint]] = None
        self.pool_generation = 0
        # Graceful drain (docs/RESILIENCE.md): endpoints of terminating /
        # NotReady-while-serving pods are marked DRAINING instead of
        # hard-evicted — excluded from new-pick candidacy while in-flight
        # waves and open streams complete, reclaimed at their bounded
        # drain deadline (or on actual pod deletion, whichever first).
        # Key -> drain_until (monotonic). The pick path's cached
        # non-draining snapshot lives beside the full one.
        self.drain_deadline_s = drain_deadline_s
        self._draining: dict[str, float] = {}
        self._snapshot_ready: Optional[list[Endpoint]] = None

    # ---- pool ------------------------------------------------------------

    def pool_set(
        self,
        pool: EndpointPool,
        pod_lister: Optional[Callable[[], Iterable[Pod]]] = None,
    ) -> None:
        """Install/replace the pool spec. If the selector or targetPorts
        changed, resync all endpoints from `pod_lister` (reference
        datastore.go:119-150 + podResyncAll :267-304)."""
        admit: list[Pod] = []
        with self._lock:
            old = self._pool
            self._pool = pool
            self.pool_generation += 1
            changed = old is not None and (
                old.selector != pool.selector
                or old.target_ports != pool.target_ports
            )
            need_resync = (old is None or changed) and pod_lister is not None
            if need_resync:
                admit = self._resync_evictions(pod_lister())
        # Two-phase resync: evictions' reclaim callbacks must run (outside
        # the lock) BEFORE admissions, or at capacity the freed slots are
        # still unallocatable and the admitted pods would be skipped with
        # no later event to retry them.
        self._drain_reclaims()
        if admit:
            with self._lock:
                for pod in admit:
                    self._pod_update_or_add_locked(pod)
            self._drain_reclaims()

    def pool_get(self) -> EndpointPool:
        with self._lock:
            if self._pool is None:
                raise PoolNotSyncedError(
                    "InferencePool is not initialized in data store"
                )
            return self._pool

    def pool_has_synced(self) -> bool:
        with self._lock:
            return self._pool is not None

    def clear(self) -> None:
        with self._lock:
            self._pool = None
            self.pool_generation += 1
            self._snapshot = None
            self._snapshot_ready = None
            for key in list(self._endpoints):
                self._remove_endpoint(key)
        self._drain_reclaims()

    # ---- pods / endpoints ------------------------------------------------

    def pod_update_or_add(self, pod: Pod) -> None:
        """Admit/refresh a ready, label-matching pod: ensure exactly one
        endpoint per active rank (reference PodUpdateOrAddIfNotExist,
        datastore.go:195-255)."""
        # Pod churn is exactly when slots are needed: reap expired drains
        # FIRST so a stuck terminating pod past its deadline frees its
        # slot for the replacement being admitted — the wave-cadence reap
        # never fires on an idle pool (the collector sleeps without
        # traffic), and the bounded-deadline contract must hold there too.
        self.reap_expired_drains()
        with self._lock:
            self._pod_update_or_add_locked(pod)
        self._drain_reclaims()

    def _pod_update_or_add_locked(self, pod: Pod) -> None:
        self._snapshot = None
        self._snapshot_ready = None
        pool = self.pool_get()
        active = set(_active_ports(pod, pool.target_ports))
        for idx, port in enumerate(pool.target_ports):
            key = self._key(pod.namespace, pod.name, idx)
            existing = self._endpoints.get(key)
            if port in active:
                if existing is None:
                    slot = self._alloc_slot()
                    if slot is None:
                        continue  # capacity degrade: skip, keep reconciling
                    ep = Endpoint(
                        name=f"{pod.name}-rank-{idx}",
                        namespace=pod.namespace,
                        pod_name=pod.name,
                        address=pod.ip,
                        port=port,
                        rank=idx,
                        slot=slot,
                        labels=dict(pod.labels),
                    )
                    self._endpoints[key] = ep
                    self._by_hostport[ep.hostport] = ep
                else:
                    # Refresh mutable fields in place; slot is sticky.
                    # Port too: a targetPorts change re-binds the same
                    # rank index to a new port number. Only pop OUR
                    # entry: on transient hostport collisions (k8s IP
                    # reuse) another live endpoint may own the key.
                    if self._by_hostport.get(existing.hostport) is existing:
                        del self._by_hostport[existing.hostport]
                    existing.address = pod.ip
                    existing.port = port
                    existing.labels = dict(pod.labels)
                    # A pod re-admitted ready cancels its drain (a
                    # rolled-back upgrade, a flapped readiness probe):
                    # the endpoint rejoins new-pick candidacy.
                    if existing.draining:
                        existing.draining = False
                        existing.drain_until = 0.0
                        self._draining.pop(key, None)
                    self._by_hostport[existing.hostport] = existing
            else:
                if existing is not None:
                    self._remove_endpoint(key)
        # Drop stale ranks beyond the current targetPorts length
        # (targetPorts shrink during resync, datastore.go:267-304).
        rank = len(pool.target_ports)
        while True:
            key = self._key(pod.namespace, pod.name, rank)
            if key not in self._endpoints:
                break
            self._remove_endpoint(key)
            rank += 1

    def pod_delete(self, namespace: str, pod_name: str) -> None:
        """Drop all rank endpoints of a pod (reference PodDelete,
        datastore.go:257-265)."""
        with self._lock:
            prefix = f"{namespace}/{pod_name}-rank-"
            for key in [k for k in self._endpoints if k.startswith(prefix)]:
                self._remove_endpoint(key)
        self._drain_reclaims()

    def endpoints(
        self, predicate: Optional[Callable[[Endpoint], bool]] = None
    ) -> list[Endpoint]:
        """Snapshot of endpoints (reference PodList, datastore.go:181-193).
        The no-predicate form returns a cached immutable snapshot (rebuilt
        after membership changes) — do not mutate the result."""
        if predicate is None:
            snap = self._snapshot  # GIL-atomic read; None after mutation
            if snap is not None:
                return snap
            with self._lock:
                snap = self._snapshot
                if snap is None:
                    snap = list(self._endpoints.values())
                    self._snapshot = snap
            return snap
        with self._lock:
            eps = list(self._endpoints.values())
        return [e for e in eps if predicate(e)]

    def pick_candidates(self) -> list[Endpoint]:
        """Endpoints eligible for NEW picks: the cached snapshot minus
        DRAINING slots and minus IMPORTED peer endpoints (federation's
        spill policy adds those per pick — default candidacy is local).
        Availability ladder when filtering empties the set: draining
        locals beat nothing, healthy remotes beat draining locals'
        absence (a fully-drained local cluster must keep answering from
        its peers). Same immutability contract as endpoints()."""
        snap = self._snapshot_ready  # GIL-atomic read; None after mutation
        if snap is not None:
            return snap
        with self._lock:
            snap = self._snapshot_ready
            if snap is None:
                eps = list(self._endpoints.values())
                local = [e for e in eps if not e.cluster]
                ready = [e for e in local if not e.draining]
                if ready:
                    snap = ready
                elif local:
                    snap = local
                else:
                    remote_ready = [e for e in eps
                                    if e.cluster and not e.draining]
                    snap = remote_ready if remote_ready else eps
                self._snapshot_ready = snap
        return snap

    def local_endpoints(self) -> list[Endpoint]:
        """Locally-reconciled endpoints only (no federation imports):
        the view the scrape engine, autoscale signals, and the HPA pool
        gauges consume — peer capacity must never read as local
        replicas."""
        with self._lock:
            return [e for e in self._endpoints.values() if not e.cluster]

    # ---- federation imports (docs/FEDERATION.md) -------------------------

    @staticmethod
    def _external_key(cluster: str, name: str) -> str:
        # "fed:" cannot collide with pod keys ("<ns>/<pod>-rank-<i>").
        return f"fed:{cluster}/{name}"

    def external_upsert(
        self, cluster: str, name: str, address: str, port: int
    ) -> Optional[Endpoint]:
        """Admit/refresh one IMPORTED peer endpoint into the shared slot
        space (InferencePoolImport Endpoint routing mode). Returns the
        endpoint, or None when slot capacity is exhausted — local pods
        keep priority and the import is skipped this round (the next
        peer digest retries). No pool sync required: imports exist
        independently of the local InferencePool."""
        if not cluster:
            raise ValueError("imported endpoints need a cluster name")
        key = self._external_key(cluster, name)
        hostport = f"{address}:{port}"
        with self._lock:
            existing = self._endpoints.get(key)
            owner = self._by_hostport.get(hostport)
            if owner is not None and owner is not existing:
                # Hostport collision (overlapping pod CIDRs across
                # clusters): the current owner wins — a LOCAL pod
                # always, and between two imports the first one —
                # because a second claimant would hijack serve-outcome
                # attribution and, on its removal, delete the owner's
                # hostport mapping.
                return None
            if existing is None:
                slot = self._alloc_slot()
                if slot is None:
                    return None
                ep = Endpoint(
                    name=name,
                    namespace="",
                    pod_name="",
                    address=address,
                    port=port,
                    rank=0,
                    slot=slot,
                    cluster=cluster,
                )
                self._endpoints[key] = ep
                self._by_hostport[ep.hostport] = ep
                self._snapshot = None
                self._snapshot_ready = None
                return ep
            if self._by_hostport.get(existing.hostport) is existing:
                del self._by_hostport[existing.hostport]
            existing.address = address
            existing.port = port
            # Never shadow another endpoint that claimed the hostport
            # between refreshes (owner wins, symmetric with the guard
            # above).
            cur = self._by_hostport.get(existing.hostport)
            if cur is None or cur is existing:
                self._by_hostport[existing.hostport] = existing
            self._snapshot = None
            self._snapshot_ready = None
            return existing

    def external_remove(self, cluster: str, name: str) -> None:
        """Drop one imported endpoint (peer summary no longer lists it,
        or the import was deleted). Slot reclaim runs the same callback
        path pod eviction does."""
        key = self._external_key(cluster, name)
        with self._lock:
            if key in self._endpoints:
                self._remove_endpoint(key)
        self._drain_reclaims()

    def external_clear(self, cluster: str) -> int:
        """Drop every imported endpoint of one peer cluster (the import
        was deleted / the peer left the ClusterSet)."""
        prefix = f"fed:{cluster}/"
        with self._lock:
            keys = [k for k in self._endpoints if k.startswith(prefix)]
            for key in keys:
                self._remove_endpoint(key)
        self._drain_reclaims()
        return len(keys)

    # ---- graceful drain --------------------------------------------------

    def pod_mark_draining(
        self, namespace: str, pod_name: str,
        now: Optional[float] = None,
    ) -> bool:
        """Enter DRAINING for all of a pod's endpoints (rolling-upgrade
        termination / NotReady-while-serving): new picks exclude them,
        in-flight waves and open streams complete against the live slot,
        and reap_expired_drains() reclaims at the bounded deadline if the
        pod's actual deletion doesn't arrive first. Idempotent (the
        deadline is set once, at first mark). Returns False when the pod
        has no serving endpoints — nothing to drain, the caller should
        plain-delete."""
        now = self._clock() if now is None else now
        marked = False
        with self._lock:
            prefix = f"{namespace}/{pod_name}-rank-"
            for key, ep in self._endpoints.items():
                if not key.startswith(prefix):
                    continue
                marked = True
                if not ep.draining:
                    ep.draining = True
                    ep.drain_until = now + self.drain_deadline_s
                    self._draining[key] = ep.drain_until
                    self._snapshot_ready = None
        return marked

    def reap_expired_drains(self, now: Optional[float] = None) -> int:
        """Reclaim endpoints whose bounded drain deadline passed without
        the pod's deletion event arriving (a stuck terminating pod must
        not hold its scheduler slot forever). Cheap no-op while nothing
        drains — callers may invoke it at wave cadence."""
        if not self._draining:  # GIL-atomic read on the common path
            return 0
        now = self._clock() if now is None else now
        with self._lock:
            expired = [k for k, until in self._draining.items()
                       if now >= until]
            for key in expired:
                if key in self._endpoints:
                    self._remove_endpoint(key)
        self._drain_reclaims()
        return len(expired)

    def draining_count(self) -> int:
        with self._lock:
            return len(self._draining)

    def debug_report(self) -> dict:
        """Datastore zpage (/debugz/datastore, gie_tpu/obs): the pool
        sync state, snapshot generation, slot pressure, and the live
        endpoint table with drain deadlines — the exact inputs the pick
        path's cached snapshots were built from. Lock held only for the
        dict build; no callbacks, no I/O."""
        now = self._clock()
        with self._lock:
            return {
                "pool_synced": self._pool is not None,
                "pool_generation": self.pool_generation,
                "endpoints": [
                    {
                        "name": ep.name,
                        "hostport": ep.hostport,
                        "slot": ep.slot,
                        "cluster": ep.cluster or None,
                        "draining": bool(ep.draining),
                        "drain_remaining_s": (
                            round(max(ep.drain_until - now, 0.0), 2)
                            if ep.draining else None),
                    }
                    for ep in self._endpoints.values()
                ],
                "draining": len(self._draining),
                "free_slots": len(self._free_slots),
                "overflow": self._overflow,
                "drain_deadline_s": self.drain_deadline_s,
            }

    def endpoint_by_hostport(self, hostport: str) -> Optional[Endpoint]:
        with self._lock:
            return self._by_hostport.get(hostport)

    def slot_map(self) -> dict[str, int]:
        """hostport -> slot for subset-mask construction."""
        with self._lock:
            return {e.hostport: e.slot for e in self._endpoints.values()}

    # ---- internals -------------------------------------------------------

    @staticmethod
    def _key(namespace: str, pod_name: str, rank: int) -> str:
        return f"{namespace}/{pod_name}-rank-{rank}"

    def _alloc_slot(self) -> Optional[int]:
        """Pop the lowest free slot, or None when capacity is exhausted.
        Exhaustion is a DEGRADE, not a crash: the reconciler keeps running,
        the overflowed endpoint is simply not admitted until churn frees a
        slot (it re-enters via the next watch event / resync), and
        overflow_count() surfaces the condition for alerting."""
        if not self._free_slots:
            self._overflow += 1
            return None
        return heapq.heappop(self._free_slots)

    def overflow_count(self) -> int:
        """How many endpoint admissions were refused for lack of slots
        since startup (monotonic; nonzero means the pool outgrew
        max_slots and needs a bigger M_MAX build or fewer ranks)."""
        with self._lock:
            return self._overflow

    def _remove_endpoint(self, key: str) -> None:
        self._snapshot = None
        self._snapshot_ready = None
        self._draining.pop(key, None)
        ep = self._endpoints.pop(key)
        if self._by_hostport.get(ep.hostport) is ep:
            del self._by_hostport[ep.hostport]
        if self._on_slot_reclaimed is None:
            heapq.heappush(self._free_slots, ep.slot)
        else:
            # The slot stays OUT of the free heap until its reclaim callback
            # has run (the callback contract is "before the slot is reused"):
            # pushing now would let a concurrent allocation grab the slot and
            # then have the deferred callback wipe the new owner's state.
            self._pending_reclaims.append(ep.slot)

    def _drain_reclaims(self) -> None:
        """Deliver queued slot-reclaim callbacks, then return the slots to
        the free heap. Must be called WITHOUT the lock held: the runner's
        callback dispatches to the device (and historically joined scraper
        threads), which would otherwise block every concurrent endpoints()/
        endpoint_by_hostport() reader for seconds during churn."""
        with self._lock:
            pending, self._pending_reclaims = self._pending_reclaims, []
        for i, slot in enumerate(pending):
            try:
                if self._on_slot_reclaimed is not None:
                    self._on_slot_reclaimed(slot)
            except BaseException:
                # Return this slot and requeue the rest so a raising
                # callback can never permanently leak scheduler capacity.
                with self._lock:
                    heapq.heappush(self._free_slots, slot)
                    self._pending_reclaims.extend(pending[i + 1:])
                raise
            with self._lock:
                heapq.heappush(self._free_slots, slot)

    def _resync_evictions(self, pods: Iterable[Pod]) -> list[Pod]:
        """Eviction phase of the full resync (reference podResyncAll,
        datastore.go:267-304): evict endpoints of non-matching pods and
        return the matching+ready pods for the caller's admission phase.
        Split in two because at capacity the evicted slots only become
        allocatable after their reclaim callbacks run (outside the lock) —
        admitting in the same locked pass would skip endpoints that no
        later watch event would retry."""
        assert self._pool is not None
        from gie_tpu_torch.utils.podutil import is_pod_ready

        admit: list[Pod] = []
        matching: set[str] = set()
        for pod in pods:
            labels_match = all(
                pod.labels.get(k) == v for k, v in self._pool.selector.items()
            )
            if labels_match and is_pod_ready(pod):
                matching.add(f"{pod.namespace}/{pod.name}")
                admit.append(pod)
        for key in list(self._endpoints):
            ep = self._endpoints[key]
            if ep.cluster:
                continue  # imports are not pod-reconciled state
            if f"{ep.namespace}/{ep.pod_name}" not in matching:
                self._remove_endpoint(key)
        return admit
