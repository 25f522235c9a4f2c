"""Leader election for multi-replica EPP deployments (port of
gie_tpu/runtime/leader.py, the file lease only).

Reference semantics (internal/runnable/leader_election.go + the endpoint-
picker protocol's readiness rules, 004 README:111-115): multiple replicas
run, exactly one leads; followers keep liveness SERVING but readiness
NOT_SERVING so the data plane only routes ext-proc traffic to the leader.

  LeaseFileElector — a filesystem lease with atomic primitives: the
      single-host elector, built by the runner's --leader-elect when the
      cluster has no kube client. The reference's KubeLeaseElector (a
      coordination.k8s.io/v1 Lease) comes with the kube slice.

File-lease mutual exclusion:

  takeover of an expired lease = rename(lease -> lease.expired.<id>)
      (exactly one contender's rename succeeds; losers get ENOENT), then
      exclusive-create (O_CREAT|O_EXCL) of the fresh lease;
  absent lease                 = exclusive-create directly;
  renewal by the holder        = write-temp + rename (atomic, holder-only).

A lease whose timestamp is in the FUTURE beyond the TTL is treated as
corrupt and eligible for takeover (clock steps / pre-created files must not
brick the deployment). Leadership is derived from what the lease file
actually says, so a transiently failed renewal does not drop a leadership
the file still grants, and stop() only releases a lease this replica still
holds.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Optional


class _RoleCallbackBase:
    """Shared role-transition plumbing for the electors.

    `on_role_change` is an optional (is_leader: bool) -> None invoked
    from the renew thread on every leadership flip (the replication
    manager's promotion/demotion hook). Exceptions are swallowed: a
    callback bug must not kill the election loop. All `_leader` writes
    on the loop/stop paths go through `_set_leader` so observers can
    never miss a flip."""

    on_role_change = None
    _leader = False

    def is_leader(self) -> bool:
        return self._leader

    def _set_leader(self, leader: bool) -> None:
        was, self._leader = self._leader, leader
        if leader != was and self.on_role_change is not None:
            try:
                self.on_role_change(leader)
            except Exception:
                pass


class LeaseFileElector(_RoleCallbackBase):
    def __init__(
        self,
        lease_path: str,
        *,
        identity: Optional[str] = None,
        lease_ttl_s: float = 5.0,
        renew_interval_s: float = 1.0,
        on_role_change=None,
    ):
        self.lease_path = lease_path
        self.identity = identity or f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self.lease_ttl_s = lease_ttl_s
        self.renew_interval_s = renew_interval_s
        self.on_role_change = on_role_change  # see _RoleCallbackBase
        self._leader = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # Release only a lease we still hold (we may have lost it while
        # stalled; unlinking the new leader's lease would cause a second
        # avoidable takeover race).
        holder, _ = self._read_lease()
        if holder == self.identity:
            try:
                os.unlink(self.lease_path)
            except OSError:
                pass
        self._set_leader(False)  # demotion observers fire on clean stop too

    def holder_identity(self) -> Optional[str]:
        """Current live lease holder (None when absent/expired) — the
        reference KubeLeaseElector.holder_identity's leader-discovery
        contract.
        The file read is local and cheap, so no observation cache is
        needed here."""
        holder, ts = self._read_lease()
        if holder is None or not self._lease_valid(ts, time.time()):
            return None
        return holder

    # ------------------------------------------------------------------ #

    def _read_lease(self) -> tuple[Optional[str], float]:
        try:
            with open(self.lease_path) as f:
                holder, ts = f.read().strip().split("\n")
            return holder, float(ts)
        except (OSError, ValueError):
            return None, 0.0

    def _lease_valid(self, ts: float, now: float) -> bool:
        """Within TTL, in either direction — a far-future timestamp is
        corruption, not an eternal lease."""
        return abs(now - ts) <= self.lease_ttl_s

    def _renew(self) -> bool:
        """Holder-only atomic refresh."""
        tmp = f"{self.lease_path}.{self.identity}.tmp"
        try:
            with open(tmp, "w") as f:
                f.write(f"{self.identity}\n{time.time()}")
            os.replace(tmp, self.lease_path)
            return True
        except OSError:
            return False

    def _exclusive_create(self) -> bool:
        """Claim an absent lease; exactly one contender's O_EXCL wins."""
        try:
            fd = os.open(self.lease_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError:
            return False
        try:
            os.write(fd, f"{self.identity}\n{time.time()}".encode())
        finally:
            os.close(fd)
        return True

    def _take_over_expired(self) -> bool:
        """Atomically retire the dead lease (one rename wins), then claim."""
        retired = f"{self.lease_path}.expired.{self.identity}"
        try:
            os.rename(self.lease_path, retired)
        except OSError:
            return False  # someone else won the takeover
        try:
            os.unlink(retired)
        except OSError:
            pass
        return self._exclusive_create()

    def _tick(self) -> bool:
        holder, ts = self._read_lease()
        now = time.time()
        if holder == self.identity:
            if self._renew():
                return True
            # Transient write failure: the file still grants us the lease
            # while it is fresh — do not flap readiness over one EIO.
            holder, ts = self._read_lease()
            return holder == self.identity and self._lease_valid(ts, now)
        if holder is None:
            return self._exclusive_create()
        if not self._lease_valid(ts, now):
            return self._take_over_expired()
        return False

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._set_leader(self._tick())
            except Exception:
                self._set_leader(False)
            self._stop.wait(self.renew_interval_s)
