"""Leader election for multi-replica EPP deployments (copy of
gie_tpu/runtime/leader.py).

Reference semantics (internal/runnable/leader_election.go + the endpoint-
picker protocol's readiness rules, 004 README:111-115): multiple replicas
run, exactly one leads; followers keep liveness SERVING but readiness
NOT_SERVING so the data plane only routes ext-proc traffic to the leader.

Two electors share the start/stop/is_leader surface:

  KubeLeaseElector — coordination.k8s.io/v1 Lease objects through the
      stdlib kube adapter (the reference's client-go leaderelection
      equivalent): acquire-on-404/expiry, holder-only renew, optimistic
      concurrency via resourceVersion (a 409 means another replica won),
      graceful release on stop. The real-cluster elector.
  LeaseFileElector — a filesystem lease with atomic primitives: the
      single-host/demo fallback.

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

import datetime
import os
import threading
import time
import uuid
from typing import Optional

_LEASES = "/apis/coordination.k8s.io/v1/namespaces/{ns}/leases"


class _RoleCallbackBase:
    """Shared role-transition plumbing for both electors.

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


def _microtime(t: Optional[float] = None) -> str:
    """metav1.MicroTime wire format. (Written, never parsed: expiry is
    judged by locally-observed record CHANGES, not by wall-clock
    comparison — see KubeLeaseElector.)"""
    return (
        datetime.datetime.fromtimestamp(
            time.time() if t is None else t, datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%S.%fZ")
    )


class KubeLeaseElector(_RoleCallbackBase):
    """Distributed leader election on a coordination.k8s.io/v1 Lease.

    `client` is the stdlib kube adapter (controller/kube.py
    KubeClusterClient) — anything exposing its `_json(method, path,
    body)` HTTP core works. Contention rules (reference
    internal/runnable/leader_election.go via client-go leaderelection):

      404                -> POST create with our holderIdentity; a 409
                            means another replica created first.
      holder == us       -> PUT renewTime refresh carrying the observed
                            resourceVersion; 409 = someone took the
                            lease from under us -> follower.
      holder empty/other -> take over ONLY when the lease is expired;
                            the PUT carries the observed resourceVersion
                            so exactly one contender wins the takeover.

    Expiry is judged by LOCAL observation, never by the record's own
    timestamps (client-go leaderelection's rule): a foreign lease is
    expired when its (holder, renewTime) pair has not CHANGED for
    leaseDurationSeconds of this replica's monotonic clock. Comparing
    the holder's wall-clock renewTime against our wall clock would let
    a replica with a skewed clock steal a live lease — two ready
    leaders.

    Failed renews get a grace window: a transient apiserver error keeps
    locally-confirmed leadership until the lease we last wrote would
    have expired anyway (client-go's renewDeadline tolerance) — without
    it, one 5xx blips readiness fleet-wide while the unexpired Lease
    still blocks every other replica. A 409 (someone else holds the
    lease) always drops leadership immediately.

    stop() releases a lease we still hold by blanking holderIdentity, so
    failover needs no TTL wait on clean shutdown."""

    def __init__(
        self,
        client,
        namespace: str,
        lease_name: str,
        *,
        identity: Optional[str] = None,
        lease_ttl_s: float = 15.0,
        renew_interval_s: float = 2.0,
        on_role_change=None,
    ):
        self.client = client
        self.path = _LEASES.format(ns=namespace) + f"/{lease_name}"
        self.create_path = _LEASES.format(ns=namespace)
        self.lease_name = lease_name
        self.namespace = namespace
        self.identity = identity or f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self.lease_ttl_s = lease_ttl_s
        self.renew_interval_s = renew_interval_s
        self.on_role_change = on_role_change  # see _RoleCallbackBase
        self._leader = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Local-observation record for skew-safe expiry:
        # (holder, renewTime-string) -> monotonic time we FIRST saw it.
        self._observed: Optional[tuple[str, str]] = None
        self._observed_at = 0.0
        # Monotonic deadline until which a transient renew failure keeps
        # locally-confirmed leadership (see class docstring).
        self._good_until = 0.0

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._leader:
            try:
                lease = self.client._json("GET", self.path)
                spec = lease.get("spec") or {}
                if spec.get("holderIdentity") == self.identity:
                    spec["holderIdentity"] = ""
                    spec["renewTime"] = _microtime()
                    lease["spec"] = spec
                    self.client._json("PUT", self.path, lease)
            except Exception:
                pass  # release is best-effort; the TTL backstops it
        self._set_leader(False)  # demotion observers fire on clean stop too

    def holder_identity(self) -> Optional[str]:
        """Lease holder identity as last OBSERVED by the renew loop —
        the replication follower's leader-discovery channel: the holder
        string carries the leader's advertised digest address
        (replication.manager.replication_identity). Served from the
        `_observed` record `_tick` already maintains (at most
        renew_interval_s stale) instead of a fresh GET: the follower
        polls this every sync interval, and doubling the apiserver's
        lease-read QPS per follower just to re-learn what the elector
        read moments ago would scale badly across pools and replicas."""
        rec = self._observed
        if rec is not None and rec[0]:
            return rec[0]
        # Before the loop's first successful GET (or while we hold the
        # lease ourselves via the create path): our own leadership is
        # authoritative locally.
        return self.identity if self._leader else None

    # ------------------------------------------------------------------ #

    def _lease_body(self, acquire: bool, base: Optional[dict] = None) -> dict:
        lease = base if base is not None else {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": self.lease_name,
                         "namespace": self.namespace},
        }
        spec = dict(lease.get("spec") or {})
        now = _microtime()
        if acquire:
            spec["acquireTime"] = now
            spec["leaseTransitions"] = int(
                spec.get("leaseTransitions") or 0) + 1
        spec["holderIdentity"] = self.identity
        spec["renewTime"] = now
        spec["leaseDurationSeconds"] = int(max(self.lease_ttl_s, 1))
        lease["spec"] = spec
        return lease

    def _tick(self) -> bool:
        from gie_tpu_torch.controller.kube import ApiError

        try:
            lease = self.client._json("GET", self.path)
        except ApiError as e:
            if e.status != 404:
                raise
            try:
                self.client._json(
                    "POST", self.create_path, self._lease_body(acquire=True))
                return True
            except ApiError as e2:
                if e2.status == 409:
                    return False  # another replica created first
                raise
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity") or ""
        ttl = float(spec.get("leaseDurationSeconds")
                    or self.lease_ttl_s)
        # Skew-safe expiry: the lease is stale only when ITS OWN record
        # (holder + renewTime string) has sat unchanged for ttl seconds
        # of OUR monotonic clock. The record's wall-clock value is never
        # compared against ours.
        record = (holder, str(spec.get("renewTime") or ""))
        now_mono = time.monotonic()
        if record != self._observed:
            self._observed = record
            self._observed_at = now_mono
        expired = (now_mono - self._observed_at) > ttl
        if holder == self.identity:
            body = self._lease_body(acquire=False, base=lease)
        elif not holder or expired:
            body = self._lease_body(acquire=True, base=lease)
        else:
            return False  # live foreign lease
        try:
            self.client._json("PUT", self.path, body)
            return True
        except ApiError as e:
            if e.status == 409:
                return False  # lost the optimistic-concurrency race
            raise

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._set_leader(self._tick())
                if self._leader:
                    # The lease we just wrote blocks every other replica
                    # for ttl; transient failures inside that window keep
                    # leadership (renewDeadline grace).
                    self._good_until = (
                        time.monotonic() + self.lease_ttl_s)
            except Exception:
                # Apiserver unreachable: keep locally-confirmed
                # leadership while our last written lease is still
                # unexpired (no one else can hold it), then fail safe to
                # follower. Followers stay followers.
                self._set_leader(
                    self._leader
                    and time.monotonic() < self._good_until
                )
            self._stop.wait(self.renew_interval_s)


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
        """Current live lease holder (None when absent/expired) — same
        leader-discovery contract as KubeLeaseElector.holder_identity.
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
