"""ReplicationManager: role-transition wiring for warm-standby followers
(copy of gie_tpu/replication/manager.py).

One loop thread serves both roles and flips with the election:

  leader    refresh the publisher every interval (exporters snapshot the
            live scheduler and autoscale state; the epoch bumps only
            when something changed) and serve /replication/digest.
  follower  drive FollowerSync.poll_once: discover the leader from the
            Lease holder identity, pull digests, validate, and install
            into the SAME live objects the scheduler serves from — so
            winning an election later needs no restore step at all. The
            promotion IS the warm state already sitting in place.

On demotion (lost lease, partition healed against us) the ex-leader's next
tick simply polls again; its publisher era survives, but followers of the
NEW leader resync full snapshots by era mismatch, so no stale state wins.

The Lease is also the discovery channel: `replication_identity` suffixes
the elector's holder identity with the advertised digest address
(``<identity>|host:port``), and `advertise_from_identity` parses it back on
the follower side. A deployment that disables replication keeps the plain
identity and nothing changes on the wire.

With a trainer (models.latency.OnlineTrainer) the digest carries its
"predictor" section in the reference's keys (every param leaf of the
flax tree plus the loss EMA and observed count), so a port follower
installs a reference leader's section and the reverse; an installed
section is handed to the scheduler's static param buffers and gates its
column with the replicated confidence.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Optional

from gie_tpu_torch.replication import follower as follower_mod
from gie_tpu_torch.replication.follower import FollowerSync
from gie_tpu_torch.replication.publisher import ReplicationHTTPServer, StatePublisher
from gie_tpu_torch.runtime import metrics as own_metrics
from gie_tpu_torch.runtime.logging import get_logger

_ADDR_SEP = "|"


def replication_identity(advertise: str, base: Optional[str] = None) -> str:
    """Elector holder identity carrying the replication advertise address."""
    base = base or f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
    return f"{base}{_ADDR_SEP}{advertise}"


def advertise_from_identity(holder: Optional[str]) -> Optional[str]:
    """Parse the advertised ``host:port`` back out of a Lease holder
    identity; None when the holder does not advertise (replication off on
    the leader, or a pre-replication build holding the lease)."""
    if not holder or _ADDR_SEP not in holder:
        return None
    addr = holder.rsplit(_ADDR_SEP, 1)[1].strip()
    if not addr or ":" not in addr:
        return None
    return addr


class ReplicationManager:
    def __init__(
        self,
        *,
        scheduler,
        trainer=None,
        capacity_model=None,
        elector=None,
        port: int = 0,
        bind: str = "127.0.0.1",
        advertise: Optional[str] = None,
        interval_s: float = 1.0,
        stale_after_s: float = 10.0,
        era: Optional[str] = None,
    ):
        self.scheduler = scheduler
        self.trainer = trainer
        self.capacity_model = capacity_model
        self.elector = elector
        self.interval_s = interval_s
        self.stale_after_s = stale_after_s
        self.log = get_logger("replication")

        exporters = {"sched": scheduler.export_state}
        if trainer is not None:
            exporters["predictor"] = trainer.export_state
        if capacity_model is not None:
            exporters["autoscale"] = capacity_model.export_state
        self.publisher = StatePublisher(exporters, era=era)
        self.http = ReplicationHTTPServer(
            self.publisher, port, bind=bind, role_fn=self.is_leader)
        self.advertise = advertise or f"{bind}:{self.http.port}"
        self.follower = FollowerSync(
            self._leader_url, self._install, interval_s=interval_s)

        self.promoted_with_epoch: Optional[int] = None
        self._was_leader: Optional[bool] = None
        self._last_refresh = 0.0  # monotonic
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- role plumbing ----------------------------------------------------- #

    def attach_elector(self, elector) -> None:
        """Late binding for the port=0 bootstrap order: the elector
        identity needs the bound advertise address, which needs the HTTP
        server, which the manager owns."""
        self.elector = elector

    def is_leader(self) -> bool:
        # No elector = single-replica deployment: this process publishes
        # (so an operator can point a cold standby at it) and never syncs.
        return self.elector is None or bool(self.elector.is_leader())

    def on_role_change(self, leader: bool) -> None:
        """Elector role callback (leader.py). Runs on the elector's renew
        thread — keep it cheap; the manager loop does the actual work on
        its next tick."""
        if leader:
            self.promoted_with_epoch = self.follower.installed_epoch
            self.log.info(
                "promoted to leader with warm replicated state",
                epoch=self.follower.installed_epoch,
                era=self.follower.installed_era,
                staleness_s=round(self.follower.staleness_s(), 3),
            )
        else:
            self.log.info("demoted to follower; resuming digest sync")
        own_metrics.REPLICATION_ROLE.set(1.0 if leader else 0.0)

    def _leader_url(self) -> Optional[str]:
        if self.elector is None:
            return None
        holder = None
        try:
            holder = self.elector.holder_identity()
        except Exception:
            return None
        if not holder or holder == getattr(self.elector, "identity", None):
            return None
        addr = advertise_from_identity(holder)
        return f"http://{addr}" if addr else None

    # -- install ----------------------------------------------------------- #

    def _install(self, sections: dict, *, delta: bool) -> bool:
        """Dispatch digest sections to their installers, in TWO phases:
        validate every known section first, then commit them all. A
        digest whose 'autoscale' section rejects must not leave the
        scheduler already swapped to the new epoch — a mixed-epoch state
        would be exactly what a promotion then serves. Unknown sections
        are skipped (forward compat: a newer leader may ship state this
        build has no home for, as a leader's 'predictor' section is for a
        follower without a trainer)."""
        handlers = {
            "sched": (self.scheduler.prepare_install,
                      self.scheduler.commit_install),
        }
        if self.trainer is not None:
            handlers["predictor"] = (
                self.trainer.prepare_install, self._commit_predictor)
        if self.capacity_model is not None:
            handlers["autoscale"] = (
                self.capacity_model.prepare_install,
                self.capacity_model.commit_install)
        staged = []
        for name, arrays in sections.items():
            entry = handlers.get(name)
            if entry is None:
                continue
            prepare, commit = entry
            prepared = prepare(arrays)
            if prepared is None:
                self.log.error("digest section rejected", section=name)
                return False  # nothing committed yet
            staged.append((commit, prepared))
        # All known sections validated: commit them all.
        for commit, prepared in staged:
            commit(prepared)
        return True

    def _commit_predictor(self, staged) -> None:
        self.trainer.commit_install(staged)
        # A cycle that binds the column must see the replicated weights,
        # gated by the replicated confidence.
        if getattr(self.scheduler, "predictor_fn", None) is not None:
            self.scheduler.set_predictor_params(self.trainer.params)
            self.scheduler.gate_latency_column(self.trainer.confidence())

    # -- health ------------------------------------------------------------ #

    def healthy(self) -> bool:
        """Replication health for the probe surface: a leader is healthy by
        definition (it IS the source); a follower is healthy once synced
        and not stale. Before any leader exists to sync from, report
        unhealthy — a probe asking "is this standby warm?" must not get a
        yes from a cold one."""
        if self.is_leader():
            return True
        return (
            self.follower.installed_epoch > 0
            and self.follower.staleness_s() <= self.stale_after_s
        )

    # -- loop -------------------------------------------------------------- #

    def step(self, now: Optional[float] = None) -> Optional[str]:
        """One tick (test seam): leader refreshes, follower polls."""
        now = time.monotonic() if now is None else now
        leader = self.is_leader()
        if leader != self._was_leader:
            self._was_leader = leader
            own_metrics.REPLICATION_ROLE.set(1.0 if leader else 0.0)
            if leader:
                self._last_refresh = 0.0  # publish immediately on promotion
        if leader:
            if now - self._last_refresh < self.interval_s:
                return "idle"
            self._last_refresh = now
            epoch = self.publisher.refresh()
            own_metrics.REPLICATION_EPOCH.set(epoch)
            own_metrics.REPLICATION_EPOCH_LAG.set(0.0)
            own_metrics.REPLICATION_DIGEST_BYTES.set(
                self.publisher.digest_bytes)
            own_metrics.REPLICATION_STALENESS.set(0.0)
            return "published"
        outcome = self.follower.poll_once(now)
        if outcome is not None:
            own_metrics.REPLICATION_SYNCS.labels(outcome=outcome).inc()
            if outcome == follower_mod.INSTALLED:
                own_metrics.REPLICATION_INSTALL_SECONDS.observe(
                    self.follower.last_install_s)
        own_metrics.REPLICATION_EPOCH.set(self.follower.installed_epoch)
        own_metrics.REPLICATION_EPOCH_LAG.set(self.follower.epoch_lag())
        staleness = self.follower.staleness_s()
        own_metrics.REPLICATION_STALENESS.set(
            staleness if staleness != float("inf") else -1.0)
        return outcome

    def _loop(self) -> None:
        # The loop granularity is finer than interval_s so a role flip is
        # picked up quickly; the follower's own backoff and the leader's
        # _last_refresh gate bound the actual work to once per interval.
        # A leader refresh is NOT free even when nothing changed — it
        # exports + encodes every section to fingerprint it (the state
        # has no cheap cross-component dirty bit; see docs/REPLICATION.md
        # follow-ups) — which is why refresh never runs at loop
        # granularity, only at interval_s.
        granularity = min(max(self.interval_s, 0.01), 0.25)
        while not self._stop.wait(granularity):
            try:
                self.step()
            except Exception as e:  # sync must never take the EPP down
                self.log.error("replication step failed", err=e)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="replication", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.http.close()
