"""FederationState: imported pools as first-class schedulable endpoints
(copy of gie_tpu/federation/state.py).

The InferencePoolImport controller (controller/multicluster.py)
decides WHICH peer pools exist; this module makes their endpoints REAL
to the scheduler:

  * every peer endpoint from a fed.load summary is admitted into the
    SAME datastore slot space local pods use (Datastore.external_upsert
    — Endpoint routing mode of proposal 1374: the importing EPP routes
    straight to the exported pool's pods), so the jitted cycle scores
    them with zero shape changes, the serve-outcome path finds them by
    hostport, and breakers/ejection apply to them like any pod;
  * the CROSS-CLUSTER COST PENALTY enters the cost model in queue-depth
    units: a remote slot's metrics row is the peer-advertised queue
    PLUS the penalty, inflated by link staleness — the queue scorer,
    the saturation filter, and the CACHED degraded rung all see remote
    capacity as real-but-more-expensive through the one row surface
    they already read (no new cycle input, no recompile);
  * peer hot-prefix keys fold into the device prefix table against the
    peer's slots (Scheduler.apply_prefix_events), so a spilled session
    sticks to the peer whose fleet already holds its prefix;
  * STALENESS-DRIVEN DEGRADATION reuses the ladder's blackout-floor
    pattern: past ``local_only_after_s`` the peer is LOCAL-ONLY — its
    endpoints leave candidate sets and its rows saturate — and the
    verdict lifts hysteretically once staleness falls back under half
    the threshold (one fresh confirm, by construction);
  * the SPILL POLICY is band-aware: non-critical traffic spills only
    when every LOCAL candidate is saturated; CRITICAL never crosses
    while any local capacity exists at all; a whole-cluster DRAIN
    inverts the preference (new picks bleed to healthy peers, local
    serves only as the availability floor).

On the card a remote slot is one more slot of the captured cycle: its
rows reach each wave through the metrics store like a local pod's, and
the peer prefix fold is queued by ``Scheduler.apply_prefix_events`` and
applied into the buffers the graphs hold at the scheduler's next locked
state access.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from gie_tpu_torch.federation import summary
from gie_tpu_torch.runtime.clock import MONOTONIC
from gie_tpu_torch.runtime.logging import get_logger
from gie_tpu_torch.sched import constants as C


class _PeerView:
    """One peer cluster's installed state (guarded by FederationState's
    lock except where noted)."""

    __slots__ = ("name", "link", "endpoints", "slots", "peer_draining",
                 "local_only", "prefix_keys", "last_meta_era",
                 "local_only_spells")

    def __init__(self, name: str):
        self.name = name
        self.link = None                       # PeerLink (set at register)
        self.endpoints: dict[str, summary.PeerEndpoint] = {}
        self.slots: dict[str, object] = {}     # hostport -> Endpoint
        self.peer_draining = False
        self.local_only = True                 # until the first install
        self.local_only_spells = 0
        self.prefix_keys: Optional[np.ndarray] = None
        self.last_meta_era: Optional[tuple] = None


class FederationState:
    def __init__(
        self,
        datastore,
        metrics_store,
        *,
        scheduler=None,
        cluster: str = "local",
        penalty: float = 4.0,
        stale_inflate_s: float = 5.0,
        local_only_after_s: float = 10.0,
        spill_queue_limit: float = 8.0,
        max_prefix_fold: int = 2048,
        clock=MONOTONIC.now,
    ):
        self.datastore = datastore
        self.metrics_store = metrics_store
        self.scheduler = scheduler
        self.cluster = cluster
        self.penalty = float(penalty)
        self.stale_inflate_s = float(stale_inflate_s)
        self.local_only_after_s = float(local_only_after_s)
        self.spill_queue_limit = float(spill_queue_limit)
        self.max_prefix_fold = int(max_prefix_fold)
        self.clock = clock
        self.log = get_logger("federation.state")
        # Whole-cluster drain flag: written by the exchange/debug
        # surface, read per wave (GIL-atomic bool).
        self.draining = False
        # Rank 22 (lockorder.toml): ABOVE the datastore (25) and store
        # (70) locks — installs reconcile endpoints and write rows while
        # holding it. Never taken by those layers in the other
        # direction.
        self._lock = threading.Lock()
        self._peers: dict[str, _PeerView] = {}
        self._last_refresh = 0.0

    # -- wiring ------------------------------------------------------------

    def register_peer(self, name: str, link) -> None:
        with self._lock:
            view = self._peers.get(name)
            if view is None:
                view = _PeerView(name)
                self._peers[name] = view
            view.link = link

    def has_peers(self) -> bool:
        return bool(self._peers)

    # -- publish side ------------------------------------------------------

    def local_load_rows(self) -> list:
        """(hostport, queue, kv, draining) rows for the fed.load export:
        LOCAL endpoints only — re-exporting an imported peer's endpoints
        would let load summaries circulate forever (and double-penalize
        a two-hop route this design does not take)."""
        eps = self.datastore.local_endpoints()
        if not eps:
            return []
        slots = [ep.slot for ep in eps]
        rows, _ages = self.metrics_store.pool_rows(slots)
        return [
            (ep.hostport,
             float(rows[i, C.Metric.QUEUE_DEPTH]),
             float(rows[i, C.Metric.KV_CACHE_UTIL]),
             bool(getattr(ep, "draining", False)))
            for i, ep in enumerate(eps)
        ]

    # -- install side (PeerLink callback) ----------------------------------

    def install_peer(self, name: str, sections: dict, *, delta: bool,
                     meta=None) -> bool:
        """Install one decoded peer digest. Unknown sections are skipped
        (forward compat); a delta without a section keeps that section's
        prior view. Returns False only on a malformed KNOWN section —
        the link rejects the frame and keeps everything."""
        load = None
        if summary.LOAD_SECTION in sections:
            load = summary.decode_load(sections[summary.LOAD_SECTION])
            if load is None:
                return False
        prefix = None
        if summary.PREFIX_SECTION in sections:
            prefix = summary.decode_prefix(sections[summary.PREFIX_SECTION])
            if prefix is None:
                return False
        if meta is not None and meta.cluster and meta.cluster != name:
            # The digest names a DIFFERENT cluster than this link is
            # configured for (a typo'd --fed-peer URL, a load balancer
            # fronting the wrong EPP): installing it would admit the
            # wrong cluster's endpoints under this peer's name and
            # mis-attribute every verdict. Reject loudly.
            self.log.error("peer digest names a different cluster",
                           link=name, digest_cluster=meta.cluster)
            return False
        with self._lock:
            view = self._peers.get(name)
            if view is None:
                view = _PeerView(name)
                self._peers[name] = view
            if meta is not None:
                view.peer_draining = meta.draining
                view.last_meta_era = meta.era
            if load is not None:
                view.endpoints = {ep.hostport: ep for ep in load}
                self._reconcile_endpoints_locked(view)
            if prefix is not None:
                self._fold_prefix_locked(view, prefix)
            # A confirmed install IS the freshness signal: staleness is
            # ~0 here, strictly under the half-threshold hysteresis
            # bound, so the local-only verdict lifts now rather than one
            # observe() tick later (same rule, applied eagerly — the
            # blackout floor's lift condition, docs/FEDERATION.md).
            if view.local_only:
                view.local_only = False
            # Staleness 0 by fiat: the link updates its contact clock
            # only after this callback returns, and the install itself
            # is the confirm the clock measures.
            self._apply_rows_locked(view, staleness=0.0)
        return True

    def _reconcile_endpoints_locked(self, view: _PeerView) -> None:
        """Desired peer endpoints -> datastore external endpoints. The
        datastore lock (rank 25) nests inside ours (22): ascending."""
        desired = set(view.endpoints)
        current = set(view.slots)
        for hostport in current - desired:
            ep = view.slots.pop(hostport)
            self.datastore.external_remove(view.name, ep.name)
        for hostport in desired - current:
            host, _, port = hostport.rpartition(":")
            ep = self.datastore.external_upsert(
                view.name, hostport, host, int(port))
            if ep is None:
                # Slot capacity exhausted: local pods keep priority; the
                # peer endpoint is simply not imported this round.
                self.log.v(2).info("peer endpoint not imported (no slot)",
                                   peer=view.name, hostport=hostport)
                continue
            view.slots[hostport] = ep

    def _fold_prefix_locked(self, view: _PeerView, keys: np.ndarray) -> None:
        """Fold the DIFF of the peer's hot-prefix sample into the device
        prefix table against every imported slot of that peer, so the
        prefix-affinity column scores spillover stickiness. Bounded by
        max_prefix_fold per install; cluster-level approximation (the
        summary has no per-pod split) documented in docs/FEDERATION.md."""
        if self.scheduler is None or not view.slots:
            view.prefix_keys = keys
            return
        new = np.unique(keys[: self.max_prefix_fold].astype(np.uint32))
        old = (view.prefix_keys if view.prefix_keys is not None
               else np.zeros(0, np.uint32))
        stored = np.setdiff1d(new, old, assume_unique=False)
        removed = np.setdiff1d(old, new, assume_unique=False)
        view.prefix_keys = new
        if stored.size == 0 and removed.size == 0:
            return
        for ep in view.slots.values():
            try:
                self.scheduler.apply_prefix_events(ep.slot, stored, removed)
            except Exception as e:
                self.log.error("peer prefix fold failed",
                               peer=view.name, err=e)
                return

    def _effective_penalty(self, view: _PeerView,
                           staleness: float) -> float:
        """Cross-cluster penalty in queue-depth units, inflated by link
        staleness: fresh = base; at the local-only threshold the row is
        saturated outright (the saturation filter drops it for
        non-critical traffic even before the local-only exclusion)."""
        if view.local_only or staleness == float("inf"):
            return max(self.spill_queue_limit * 4.0, self.penalty)
        return self.penalty * (1.0 + max(staleness, 0.0)
                               / max(self.stale_inflate_s, 1e-6))

    def _apply_rows_locked(self, view: _PeerView,
                           staleness: Optional[float] = None) -> None:
        """Write the peer's endpoint rows (advertised load + effective
        penalty) into the metrics store — the seam through which the
        penalty enters the scheduler's cost model."""
        if not view.slots:
            return
        if staleness is None:
            staleness = (view.link.staleness_s() if view.link is not None
                         else 0.0)
        pen = self._effective_penalty(view, staleness)
        rows = []
        for hostport, ep in view.slots.items():
            info = view.endpoints.get(hostport)
            if info is None:
                continue
            rows.append((ep.slot, {
                int(C.Metric.QUEUE_DEPTH): info.queue_depth + pen,
                int(C.Metric.KV_CACHE_UTIL): info.kv_util,
            }, (), ()))
        if rows:
            self.metrics_store.update_rows(rows)

    # -- wave-cadence tick -------------------------------------------------

    def observe(self, now: Optional[float] = None) -> None:
        """Per-wave tick from the batching dispatcher (mirrors
        ResilienceState.observe): fold each link's staleness clock into
        the local-only verdict and re-apply penalty rows. Rate-limited
        to 4 Hz — with fresh links this is one clock read and a falsy
        branch per wave."""
        now = self.clock() if now is None else now
        if now - self._last_refresh < 0.25:
            return
        self._last_refresh = now
        with self._lock:
            for view in self._peers.values():
                if view.link is None:
                    continue
                staleness = view.link.staleness_s()
                if not view.local_only and staleness > self.local_only_after_s:
                    view.local_only = True
                    view.local_only_spells += 1
                    self.log.info("peer degraded to local-only",
                                  peer=view.name,
                                  staleness_s=round(staleness, 2))
                elif (view.local_only
                      and staleness < self.local_only_after_s * 0.5):
                    # The ladder's blackout-recovery hysteresis: lift
                    # only once the clock falls well back under the
                    # threshold (a fresh confirm resets it to ~0).
                    view.local_only = False
                    self.log.info("peer readmitted from local-only",
                                  peer=view.name)
                self._apply_rows_locked(view)

    # -- pick-path policy --------------------------------------------------

    def spill_candidates(self, band: int, local_slots: np.ndarray,
                         queues: np.ndarray) -> Optional[list]:
        """Remote endpoints to APPEND to one pick's candidate set, or
        None when the pick stays local. ``local_slots``/``queues`` are
        the item's local candidate slots and the host queue-depth
        column the dispatcher already holds.

        Rules (docs/FEDERATION.md "spill policy"):
          drain     cluster draining -> remote-first for every band
                    (the caller REPLACES candidates when we return
                    non-empty and drain is on);
          saturated non-critical spills when every local candidate is
                    at/past spill_queue_limit (the same bound the
                    cycle's sheddable-429 machinery reads);
          critical  crosses ONLY when no local candidate exists at all
                    — local capacity sufficing means CRITICAL stays
                    home, the storm-pinned property.
        """
        if not self.draining:
            if local_slots.size:
                s = local_slots[(local_slots >= 0)
                                & (local_slots < queues.shape[0])]
                if band == int(C.Criticality.CRITICAL):
                    return None  # local candidates exist: never cross
                if s.size and not bool(
                        np.all(queues[s] >= self.spill_queue_limit)):
                    return None  # local capacity suffices
        out: list = []
        with self._lock:
            for view in self._peers.values():
                if view.local_only or view.peer_draining:
                    continue
                for hostport, ep in view.slots.items():
                    info = view.endpoints.get(hostport)
                    if info is not None and info.draining:
                        continue
                    out.append(ep)
        return out if out else None

    def note_remote_pick(self, cluster: str, band_name: str) -> None:
        """A wave pick landed on an imported endpoint: the completer's
        gie_federation_spill_total tally."""
        from gie_tpu_torch.runtime import metrics as own_metrics

        own_metrics.FED_SPILL.labels(peer=cluster, band=band_name).inc()

    # -- reporting ---------------------------------------------------------

    def capacity_matrix(self) -> dict:
        """The per-cluster capacity matrix (/debugz/federation + the
        autoscale view): one row per cluster — local first — with
        endpoint count, advertised queue mass, drain/local-only state,
        and the effective penalty. This is the 'one cluster is a
        capacity ceiling' ledger: total schedulable capacity is the sum
        over rows, discounted by penalty and staleness."""
        local_rows = self.local_load_rows()
        matrix = {
            self.cluster: {
                "local": True,
                "endpoints": len(local_rows),
                "queue_total": round(sum(r[1] for r in local_rows), 2),
                "draining": self.draining,
                "penalty": 0.0,
                "local_only": False,
            }
        }
        with self._lock:
            for name, view in sorted(self._peers.items()):
                staleness = (view.link.staleness_s()
                             if view.link is not None else float("inf"))
                matrix[name] = {
                    "local": False,
                    "endpoints": len(view.slots),
                    "queue_total": round(sum(
                        e.queue_depth for e in view.endpoints.values()), 2),
                    "draining": view.peer_draining,
                    "penalty": round(
                        self._effective_penalty(view, staleness), 2),
                    "local_only": view.local_only,
                    "local_only_spells": view.local_only_spells,
                    "staleness_s": (round(staleness, 3)
                                    if staleness != float("inf") else None),
                    "era": (list(view.last_meta_era)
                            if view.last_meta_era else None),
                }
        return matrix

    def export_metrics(self) -> None:
        """Refresh the gie_federation_* gauges (called from observe
        consumers at their own cadence; bounded by the peer count)."""
        from gie_tpu_torch.runtime import metrics as own_metrics

        own_metrics.FED_PEERS.set(len(self._peers))
        own_metrics.FED_DRAINING.set(1.0 if self.draining else 0.0)
        with self._lock:
            for name, view in self._peers.items():
                staleness = (view.link.staleness_s()
                             if view.link is not None else float("inf"))
                own_metrics.FED_REMOTE_ENDPOINTS.labels(peer=name).set(
                    len(view.slots))
                own_metrics.FED_STALENESS.labels(peer=name).set(
                    staleness if staleness != float("inf") else -1.0)
                own_metrics.FED_LOCAL_ONLY.labels(peer=name).set(
                    1.0 if view.local_only else 0.0)
                own_metrics.FED_PENALTY.labels(peer=name).set(
                    self._effective_penalty(view, staleness))
