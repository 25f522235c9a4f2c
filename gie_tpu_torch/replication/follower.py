"""Follower sync loop: poll the leader's digest, validate, install
(copy of gie_tpu/replication/follower.py).

The follower's one invariant: its live state only ever moves FORWARD to a
digest that decoded cleanly, passed the installers' cross-field validation,
and belongs to the (era, epoch) lineage it is tracking. Everything else —
corrupt bytes, epoch regressions, deltas against a base it never installed,
fetch failures — leaves the prior state untouched and is absorbed by
jittered backoff, never raised out of the loop.

Discovery is indirect on purpose: the leader is whoever holds the election
Lease, and the Lease holder identity carries the leader's advertised
replication address (manager.replication_identity). The follower re-reads
the holder every poll, so a failover redirects the sync without any
follower-side configuration.
"""

from __future__ import annotations

import random
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Optional

from gie_tpu_torch.replication import codec
from gie_tpu_torch.replication.publisher import DIGEST_PATH, EPOCH_HEADER, ERA_HEADER
from gie_tpu_torch.resilience import faults
from gie_tpu_torch.resilience.policy import Backoff, BackoffPolicy
from gie_tpu_torch.runtime.logging import get_logger

# poll_once outcomes (metric label values; see runtime/metrics.py).
INSTALLED = "installed"
NOT_MODIFIED = "not_modified"
NO_LEADER = "no_leader"
FETCH_ERROR = "fetch_error"
CORRUPT = "corrupt"
STALE_EPOCH = "stale_epoch"
DELTA_MISMATCH = "delta_mismatch"
REJECTED = "rejected"


def _header(headers: dict, name: str) -> Optional[str]:
    for k, v in headers.items():
        if k.lower() == name.lower():
            return v
    return None


class FollowerSync:
    """Anti-entropy pull loop body. The manager drives `poll_once` from its
    role loop (no thread of its own), so a role flip to leader simply stops
    the polling without any pause/resume handshake."""

    def __init__(
        self,
        leader_url: Callable[[], Optional[str]],
        install: Callable[..., bool],
        *,
        interval_s: float = 1.0,
        timeout_s: float = 3.0,
        backoff_max_s: float = 8.0,
        jitter: float = 0.25,
        fetch: Optional[Callable] = None,
        seed: Optional[int] = None,
    ):
        self.leader_url = leader_url
        self.install = install
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.backoff_max_s = backoff_max_s
        self.jitter = jitter
        # fetch(base_url, since, era, etag) -> (status, headers, body);
        # injectable for the in-memory round-trip smoke test.
        self._fetch = fetch if fetch is not None else self._http_fetch
        self._rng = random.Random(seed)
        self.log = get_logger("replication.follower")

        self.installed_epoch = 0
        self.installed_era: Optional[str] = None
        self.leader_epoch = 0          # newest epoch seen from the leader
        self.last_etag: Optional[str] = None
        self.last_contact_at = 0.0     # monotonic; 0 = never
        self.last_install_at = 0.0
        self.last_install_s = 0.0      # wall time of the last install
        self.installs = 0
        self.rejects = 0
        self.fetch_errors = 0
        self.last_delta = False        # last install was a delta frame
        self._want_full = True
        # Shared jittered-backoff policy (resilience/policy.py) replacing
        # the hand-rolled double-from-base arithmetic: same shape —
        # interval*2**streak capped at backoff_max_s, jitter strictly
        # upward from this follower's seeded RNG (parity pinned by
        # tests/test_resilience.py).
        self._backoff = Backoff(
            BackoffPolicy(base_s=interval_s, max_s=max(backoff_max_s,
                                                       interval_s),
                          jitter=jitter),
            rng=self._rng)
        self._next_poll = 0.0          # monotonic deadline

    # ------------------------------------------------------------------ #

    def staleness_s(self, now: Optional[float] = None) -> float:
        """Seconds since the follower last CONFIRMED the leader's state
        (install or 304); inf before first contact."""
        if self.last_contact_at == 0.0:
            return float("inf")
        now = time.monotonic() if now is None else now
        return max(now - self.last_contact_at, 0.0)

    def epoch_lag(self) -> int:
        return max(self.leader_epoch - self.installed_epoch, 0)

    def _schedule(self, now: float, *, failed: bool) -> None:
        delay = self._backoff.fail() if failed else self._backoff.ok()
        self._next_poll = now + delay

    def _http_fetch(self, base_url, since, era, etag):
        query = {}
        if since is not None and era:
            query = {"since": str(since), "era": era}
        url = base_url.rstrip("/") + DIGEST_PATH
        if query:
            url += "?" + urllib.parse.urlencode(query)
        headers = {"If-None-Match": etag} if etag else {}
        req = urllib.request.Request(url, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            body = b""
            try:
                body = e.read()
            except Exception:
                pass
            return e.code, dict(e.headers or {}), body

    # ------------------------------------------------------------------ #

    def poll_once(self, now: Optional[float] = None) -> Optional[str]:
        """One backoff-gated sync attempt; returns the outcome label or
        None when the backoff window has not elapsed yet."""
        now = time.monotonic() if now is None else now
        if now < self._next_poll:
            return None
        url = self.leader_url()
        if not url:
            self._schedule(now, failed=True)
            return NO_LEADER
        since = None
        if not self._want_full and self.installed_era is not None:
            since = self.installed_epoch
        try:
            if faults.ENABLED:
                # gie-chaos: a replication partition is a failing digest
                # poll. FaultError is ConnectionError-shaped, so the
                # handler below absorbs it into FETCH_ERROR + backoff —
                # exactly the real-world path (and injected transports
                # see the same schedule the HTTP one would).
                faults.check("replication.poll", key=url)
            status, headers, body = self._fetch(
                url, since, self.installed_era, self.last_etag)
        except Exception as e:
            self.fetch_errors += 1
            self.log.v(3).info("digest fetch failed", url=url, err=str(e))
            self._schedule(now, failed=True)
            return FETCH_ERROR
        if status == 304:
            self.last_contact_at = now
            epoch = _header(headers, EPOCH_HEADER)
            if epoch is not None and epoch.isdigit():
                self.leader_epoch = int(epoch)
            self._schedule(now, failed=False)
            return NOT_MODIFIED
        if status != 200:
            self.fetch_errors += 1
            self._schedule(now, failed=True)
            return FETCH_ERROR

        digest = codec.decode_digest(body)
        if digest is None:
            self.rejects += 1
            self._schedule(now, failed=True)
            return CORRUPT
        era = _header(headers, ERA_HEADER) or ""
        self.leader_epoch = max(digest.epoch, 0)
        if digest.delta and (
            era != self.installed_era
            or digest.base_epoch != self.installed_epoch
        ):
            # A delta against a base we never installed (leader changed,
            # or we missed a window): force a full snapshot next poll.
            self._want_full = True
            self._schedule(now, failed=False)
            self._next_poll = now  # re-poll immediately with since=None
            return DELTA_MISMATCH
        if era == self.installed_era and digest.epoch <= self.installed_epoch:
            # Epoch regression within one era (a replayed or reordered
            # response): state only moves forward.
            self.rejects += 1
            self._schedule(now, failed=False)
            return STALE_EPOCH

        t0 = time.perf_counter()
        try:
            ok = bool(self.install(digest.sections, delta=digest.delta))
        except Exception as e:
            # Installer bugs must degrade to "kept prior state", exactly
            # like corrupt bytes.
            self.log.error("digest install raised", err=e)
            ok = False
        self.last_install_s = time.perf_counter() - t0
        if not ok:
            self.rejects += 1
            self._schedule(now, failed=True)
            return REJECTED
        self.installed_epoch = digest.epoch
        self.installed_era = era
        self.last_delta = digest.delta
        self.last_etag = _header(headers, "ETag")
        self.last_contact_at = now
        self.last_install_at = now
        self.installs += 1
        self._want_full = False
        self._schedule(now, failed=False)
        return INSTALLED
