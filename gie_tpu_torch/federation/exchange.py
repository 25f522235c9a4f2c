"""Peer-to-peer digest exchange: push/long-poll delta frames between
cluster EPPs (copy of gie_tpu/federation/exchange.py; a port PeerLink
installs from a reference FederationHTTPServer and the other way round).

The PR-3 replication protocol was a pure 1 Hz pull — fine for a warm
standby, but a staleness FLOOR of one poll interval for routing state
(the ROADMAP item-4 gap this module closes). The federation exchange
upgrades it to long-poll push semantics over the SAME codec and the
SAME ETag/era/delta machinery:

  * a peer's GET carries ``wait_s``: when the publisher has nothing new
    (If-None-Match hits), it PARKS the request on a condition variable
    and answers the instant the next refresh bumps the epoch — a state
    change propagates in one network RTT instead of one poll interval;
  * delta frames (``?since=N&era=E``) carry only the changed sections,
    full snapshots remain the anti-entropy fallback (era mismatch,
    missed window), exactly the replication publisher's contract.

Per-peer robustness lives in :class:`PeerLink`: a circuit breaker on
the exchange link (an unreachable peer costs one probe per dwell, not a
timeout per poll), jittered backoff, a staleness clock the state layer
turns into penalty inflation / local-only degradation, and the era
ordering rule — installed lineage only ever moves FORWARD to a greater
(seq, token) era, so interleaved frames from both sides of a healed
split brain converge deterministically on max(era) and the zombie
lineage's frames reject as ``era_regression``.
"""

from __future__ import annotations

import json
import random
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Optional

from gie_tpu_torch.federation import summary
from gie_tpu_torch.replication import codec
from gie_tpu_torch.replication.publisher import EPOCH_HEADER, StatePublisher
from gie_tpu_torch.resilience import faults
from gie_tpu_torch.resilience.policy import Backoff, BackoffPolicy
from gie_tpu_torch.runtime.clock import MONOTONIC, Clock
from gie_tpu_torch.runtime.logging import get_logger

DIGEST_PATH = "/federation/digest"
STATUS_PATH = "/federation/status"

# PeerLink.poll_once outcome labels (gie_federation_syncs_total).
INSTALLED = "installed"
NOT_MODIFIED = "not_modified"
FETCH_ERROR = "fetch_error"
CORRUPT = "corrupt"
STALE_EPOCH = "stale_epoch"
ERA_REGRESSION = "era_regression"
DELTA_MISMATCH = "delta_mismatch"
REJECTED = "rejected"
BREAKER_OPEN = "breaker_open"


def era_str(era: tuple) -> str:
    """Era pair -> the wire string used for ETag/era query comparison
    (the NUMERIC pair in fed.meta stays the ordering authority)."""
    return f"{int(era[0])}.{int(era[1]):016x}"


class FederationPublisher:
    """A :class:`StatePublisher` with an era PAIR and long-poll wakeup.

    The underlying publisher owns payload fingerprinting, the epoch
    counter, ETag/304, and delta assembly; this wrapper adds the
    condition variable refresh() notifies so a parked ``serve(...,
    wait_s=)`` answers the moment state changes, and ``bump_era`` — the
    failover/split-brain seam (a restarted or re-elected peer EPP mints
    a GREATER era, carried in both the HTTP era header and fed.meta)."""

    def __init__(self, exporters: dict, *, era_seq: int = 1,
                 era_token: Optional[int] = None,
                 clock: Clock = MONOTONIC):
        token = (int(era_token) if era_token is not None
                 else random.getrandbits(63))
        self.era = (int(era_seq), token)
        self._pub = StatePublisher(dict(exporters), era=era_str(self.era))
        # Clock seam (runtime/clock.py): the long-poll park window is
        # clock-governed — a virtual-time storm parks and wakes it on
        # the simulated timeline.
        self._clock = clock
        # Long-poll park/wake. Declared rank 52 (lockorder.toml): held
        # only around epoch compares + waits, never across the
        # publisher's own lock (rank 55) or any I/O.
        self._cv = threading.Condition()

    @property
    def epoch(self) -> int:
        return self._pub.epoch

    def refresh(self) -> int:
        epoch = self._pub.refresh()
        with self._cv:
            self._clock.notify_all(self._cv)
        return epoch

    def bump_era(self, seq: Optional[int] = None) -> tuple:
        """Mint a new, strictly greater era (seq+1 unless given, fresh
        token). Peers resync a full snapshot on the flip; the OLD era's
        frames become era regressions everywhere — deterministically,
        because (seq, token) ordering is total."""
        new_seq = int(seq) if seq is not None else self.era[0] + 1
        if new_seq <= self.era[0] and seq is not None:
            raise ValueError("era seq must increase")
        self.era = (new_seq, random.getrandbits(63))
        self._pub.era = era_str(self.era)
        with self._cv:
            self._clock.notify_all(self._cv)
        return self.era

    def serve(self, *, since: Optional[int] = None,
              era: Optional[str] = None,
              if_none_match: Optional[str] = None,
              wait_s: float = 0.0) -> tuple:
        """One digest request (the HTTP handler and the in-memory test
        transport share it). ``wait_s > 0`` long-polls: a 304 parks on
        the refresh condition until the epoch moves or the window ends,
        then re-serves — the push half of push/long-poll."""
        if faults.ENABLED:
            # gie-chaos peer.publish: the serving side of the exchange
            # link. ERROR = a peer EPP that stopped answering; CORRUPT
            # flips a byte in the outgoing frame (the codec CRC on the
            # polling side absorbs it). Drawn before any lock.
            verdict = faults.fire("peer.publish")
            if verdict.kind == faults.ERROR:
                return 503, {}, b"injected fault"
        else:
            verdict = None
        status, headers, body = self._pub.serve(
            since=since, era=era, if_none_match=if_none_match)
        if status == 304 and wait_s > 0.0:
            deadline = self._clock.now() + min(wait_s, 60.0)
            etag = if_none_match
            with self._cv:
                while True:
                    remaining = deadline - self._clock.now()
                    if remaining <= 0:
                        break
                    # Cheap staleness probe: the ETag is era:epoch, so a
                    # refresh OR an era bump changes it.
                    if self._pub._etag() != etag:
                        break
                    self._clock.wait(self._cv, remaining)
            status, headers, body = self._pub.serve(
                since=since, era=era, if_none_match=if_none_match)
        if (verdict is not None and verdict.kind == faults.CORRUPT
                and body):
            flipped = bytearray(body)
            flipped[len(flipped) // 2] ^= 0xFF
            body = bytes(flipped)
        return status, headers, body

    def status(self) -> dict:
        return {**self._pub.status(), "era_pair": list(self.era)}


class FederationHTTPServer:
    """The exchange listener. Same security posture as the replication
    listener (a forged digest steers routing): loopback bind by
    default, the pod network is an explicit decision. GET-only."""

    def __init__(self, publisher: FederationPublisher, port: int = 0,
                 *, bind: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        pub = publisher

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib naming)
                parsed = urllib.parse.urlparse(self.path)
                if parsed.path == STATUS_PATH:
                    body = json.dumps(pub.status()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if parsed.path != DIGEST_PATH:
                    self.send_error(404)
                    return
                q = urllib.parse.parse_qs(parsed.query)

                def _one(key, cast, default):
                    try:
                        return cast(q[key][0]) if key in q else default
                    except (ValueError, IndexError):
                        return default

                if faults.ENABLED:
                    # gie-chaos peer.partition, inbound half: a severed
                    # link fails BOTH directions — the peer's polls of
                    # us die here, ours die at PeerLink.poll_once.
                    try:
                        faults.check("peer.partition", key="inbound")
                    except faults.FaultError:
                        self.send_error(503)
                        return
                status, headers, body = pub.serve(
                    since=_one("since", int, None),
                    era=q.get("era", [None])[0],
                    if_none_match=self.headers.get("If-None-Match"),
                    wait_s=min(max(_one("wait_s", float, 0.0), 0.0), 60.0),
                )
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((bind, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="federation-http", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class PeerLink:
    """One peer cluster's pull side: long-poll, validate, order by era,
    install. Single-threaded by contract (the exchange runs one loop
    thread per link); the scalar fields other threads read (staleness,
    installed era, counters) are GIL-atomic stores.

    Era rule (the split-brain contract, pinned by
    tests/test_federation.py):

      era <  installed  ->  ERA_REGRESSION, rejected. The zombie side
                            of a healed partition keeps publishing its
                            old era; every importer rejects it
                            identically because era ordering is total.
      era == installed  ->  normal lineage: epoch must advance (a
                            replayed/reordered frame is STALE_EPOCH),
                            deltas must base on the installed epoch.
      era >  installed  ->  a new lineage (peer failover, partition
                            heal): only a FULL snapshot installs (a
                            delta from an unknown base forces one), and
                            the installed era ratchets forward — both
                            sides converge on max(era) regardless of
                            frame interleaving.
    """

    def __init__(
        self,
        name: str,
        url: str,
        install: Callable[..., bool],
        *,
        interval_s: float = 1.0,
        wait_s: float = 10.0,
        timeout_margin_s: float = 5.0,
        backoff_max_s: float = 8.0,
        open_after: int = 3,
        open_s: float = 5.0,
        fetch: Optional[Callable] = None,
        seed: Optional[int] = None,
        stop_check: Optional[Callable[[], bool]] = None,
        clock: Clock = MONOTONIC,
    ):
        self.name = name
        self.url = url.rstrip("/")
        self.install = install
        # Clock seam: pacing, backoff, breaker dwell, and the staleness
        # clock the state layer's penalty inflation reads all live on
        # this clock (virtual in a time-compressed storm).
        self._clock = clock
        # Shutdown seam: a long-poll fetch can park for wait_s past the
        # owner's stop() (urllib cannot be interrupted); checking this
        # before install keeps a late-returning poll from mutating
        # datastore/metrics state mid-teardown.
        self._stop_check = stop_check
        self.interval_s = interval_s
        self.wait_s = wait_s
        self.timeout_s = wait_s + timeout_margin_s
        self.open_after = max(int(open_after), 1)
        self.open_s = open_s
        self._fetch = fetch if fetch is not None else self._http_fetch
        self.log = get_logger("federation.link")

        self.installed_era: Optional[tuple] = None
        self.installed_epoch = 0
        self.peer_epoch = 0
        self.last_etag: Optional[str] = None
        self.last_contact_at = 0.0     # monotonic; 0 = never
        self.installs = 0
        self.rejects = 0
        self.fetch_errors = 0
        self.era_flips = 0
        self.era_regressions = 0
        self._want_full = True
        self._backoff = Backoff(
            BackoffPolicy(base_s=max(interval_s, 0.0),
                          max_s=max(backoff_max_s, interval_s, 0.001)),
            rng=random.Random(seed) if seed is not None else None)
        self._next_poll = 0.0
        # Link circuit breaker: `open_after` consecutive link failures
        # (fetch errors / corrupt frames) open it for `open_s`; one
        # half-open probe per dwell afterwards. An unreachable peer
        # costs one timeout per dwell, not one per poll. _open_reported
        # makes each dwell emit ONE breaker_open sync outcome (not one
        # per gated loop tick).
        self._fail_streak = 0
        self._open_until = 0.0
        self._open_reported = False

    # -- reads -------------------------------------------------------------

    def staleness_s(self, now: Optional[float] = None) -> float:
        """Seconds since this link last CONFIRMED the peer's state
        (install or 304); inf before first contact. The state layer's
        penalty inflation and local-only verdicts key off this."""
        if self.last_contact_at == 0.0:
            return float("inf")
        now = self._clock.now() if now is None else now
        return max(now - self.last_contact_at, 0.0)

    def breaker_open(self, now: Optional[float] = None) -> bool:
        now = self._clock.now() if now is None else now
        return now < self._open_until

    def report(self) -> dict:
        stale = self.staleness_s()
        return {
            "url": self.url,
            "installed_era": (list(self.installed_era)
                              if self.installed_era else None),
            "installed_epoch": self.installed_epoch,
            "peer_epoch": self.peer_epoch,
            "staleness_s": round(stale, 3) if stale != float("inf") else None,
            "installs": self.installs,
            "rejects": self.rejects,
            "fetch_errors": self.fetch_errors,
            "era_flips": self.era_flips,
            "era_regressions": self.era_regressions,
            "breaker_open": self.breaker_open(),
        }

    # -- transport ---------------------------------------------------------

    def _http_fetch(self, url, since, era, etag, wait_s):
        query = {}
        if since is not None and era:
            query["since"] = str(since)
            query["era"] = era
        if wait_s > 0:
            query["wait_s"] = f"{wait_s:.3f}"
        full = url + DIGEST_PATH
        if query:
            full += "?" + urllib.parse.urlencode(query)
        headers = {"If-None-Match": etag} if etag else {}
        req = urllib.request.Request(full, headers=headers)
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

    # -- one poll ----------------------------------------------------------

    def _fail(self, now: float, outcome: str) -> str:
        self._fail_streak += 1
        if self._fail_streak >= self.open_after:
            self._open_until = now + self.open_s
            self._open_reported = False
        self._next_poll = now + self._backoff.fail()
        return outcome

    def _ok_link(self, now: float) -> None:
        self._fail_streak = 0
        self._open_until = 0.0
        self._backoff.reset()
        # Long-poll provides the healthy-cadence pacing; without a wait
        # window (tests, degraded servers) fall back to interval pacing.
        self._next_poll = now + (0.0 if self.wait_s > 0 else self.interval_s)

    def poll_once(self, now: Optional[float] = None) -> Optional[str]:
        """One breaker/backoff-gated exchange attempt; returns the
        outcome label, or None when the pacing window has not elapsed.
        Blocks up to wait_s + margin inside the long-poll fetch."""
        now = self._clock.now() if now is None else now
        if now < self._next_poll:
            return None
        if self.breaker_open(now):
            if not self._open_reported:
                # One observable outcome per dwell: the sync counter
                # distinguishes breaker dwell from mere pacing without
                # spamming a label per gated loop tick.
                self._open_reported = True
                return BREAKER_OPEN
            return None
        since = None
        era_q = None
        if not self._want_full and self.installed_era is not None:
            since = self.installed_epoch
            era_q = era_str(self.installed_era)
        try:
            if faults.ENABLED:
                # gie-chaos: peer.partition is the sustained two-way
                # severance (scenarios key it per peer); peer.poll the
                # flaky-link point. Both are ConnectionError-shaped and
                # absorbed below — the real network-failure path.
                faults.check("peer.partition", key=self.name)
                faults.check("peer.poll", key=self.name)
            status, headers, body = self._fetch(
                self.url, since, era_q, self.last_etag, self.wait_s)
        except Exception as e:
            self.fetch_errors += 1
            self.log.v(3).info("peer digest fetch failed",
                               peer=self.name, err=str(e))
            # A failed half-open probe re-opens too: _fail's streak is
            # already >= open_after there, so one path covers both.
            return self._fail(self._clock.now(), FETCH_ERROR)
        now = self._clock.now()  # the long poll may have parked for seconds
        if status == 304:
            self.last_contact_at = now
            epoch = headers.get(EPOCH_HEADER) or _header(
                headers, EPOCH_HEADER)
            if epoch is not None and str(epoch).isdigit():
                self.peer_epoch = int(epoch)
            self._ok_link(now)
            return NOT_MODIFIED
        if status != 200:
            self.fetch_errors += 1
            return self._fail(now, FETCH_ERROR)

        digest = codec.decode_digest(body)
        if digest is None:
            self.rejects += 1
            return self._fail(now, CORRUPT)
        self.peer_epoch = max(digest.epoch, 0)
        meta = summary.decode_meta(
            digest.sections.get(summary.META_SECTION))
        if meta is None and not digest.delta:
            # A full snapshot without a decodable lineage marker is
            # uninstallable: era ordering is the safety rule.
            self.rejects += 1
            return self._fail(now, REJECTED)
        era = meta.era if meta is not None else self.installed_era
        if self.installed_era is not None and era is not None:
            if era < self.installed_era:
                # The zombie lineage (or a replayed pre-failover frame).
                # NOT a link failure — the peer is reachable, its frames
                # just lose the era ordering — so no breaker/backoff.
                # But it is NOT freshness either: the staleness clock
                # deliberately keeps climbing, because routing on a
                # lost leader's state would be wrong — a zombie-only
                # peer degrades to local-only until the true lineage
                # answers.
                self.era_regressions += 1
                self.rejects += 1
                self._next_poll = now + self.interval_s
                return ERA_REGRESSION
            if era > self.installed_era and digest.delta:
                # New lineage mid-delta: only a full snapshot may carry
                # an era flip.
                self._want_full = True
                self._next_poll = now
                return DELTA_MISMATCH
        if digest.delta and (
                self.installed_era is None
                or digest.base_epoch != self.installed_epoch):
            self._want_full = True
            self._next_poll = now
            return DELTA_MISMATCH
        if (era == self.installed_era
                and digest.epoch <= self.installed_epoch):
            self.rejects += 1
            self._next_poll = now + self.interval_s
            return STALE_EPOCH

        if self._stop_check is not None and self._stop_check():
            return None  # owner is tearing down: never install late
        try:
            ok = bool(self.install(self.name, digest.sections,
                                   delta=digest.delta, meta=meta))
        except Exception as e:
            self.log.error("peer digest install raised",
                           peer=self.name, err=e)
            ok = False
        if not ok:
            self.rejects += 1
            return self._fail(now, REJECTED)
        if (era is not None and self.installed_era is not None
                and era > self.installed_era):
            self.era_flips += 1
            from gie_tpu_torch.runtime import metrics as own_metrics

            own_metrics.FED_ERA_FLIPS.labels(peer=self.name).inc()
        if era is not None:
            self.installed_era = era
        self.installed_epoch = digest.epoch
        self.last_etag = _header(headers, "ETag")
        self.last_contact_at = now
        self.installs += 1
        self._want_full = False
        self._ok_link(now)
        return INSTALLED


def _header(headers: dict, name: str) -> Optional[str]:
    for k, v in headers.items():
        if k.lower() == name.lower():
            return v
    return None


class FederationExchange:
    """The whole peer exchange for one cluster: publisher + listener +
    one PeerLink loop thread per configured peer, installing into the
    FederationState (federation/state.py).

    Symmetric by construction: every cluster both serves its digest and
    pulls every peer's. A deployment configures the same ``--fed-peer``
    set on each side."""

    def __init__(
        self,
        state,
        *,
        cluster: str,
        peers: Optional[dict] = None,
        port: int = 0,
        bind: str = "127.0.0.1",
        serve: bool = True,
        era_seq: int = 1,
        era_token: Optional[int] = None,
        interval_s: float = 1.0,
        wait_s: float = 10.0,
        max_endpoints: int = 64,
        max_prefix_keys: int = 2048,
        prefix_keys_fn: Optional[Callable] = None,
        fetch: Optional[Callable] = None,
        link_open_after: int = 3,
        link_open_s: float = 5.0,
        seed: Optional[int] = None,
        clock: Clock = MONOTONIC,
    ):
        self.state = state
        self.cluster = cluster
        self.interval_s = interval_s
        self.max_endpoints = max_endpoints
        self.max_prefix_keys = max_prefix_keys
        self.prefix_keys_fn = prefix_keys_fn
        self._clock = clock
        self.log = get_logger("federation")
        exporters = {
            summary.META_SECTION: self._export_meta,
            summary.LOAD_SECTION: self._export_load,
        }
        if prefix_keys_fn is not None:
            exporters[summary.PREFIX_SECTION] = self._export_prefix
        self.publisher = FederationPublisher(
            exporters, era_seq=era_seq, era_token=era_token, clock=clock)
        self.server = (FederationHTTPServer(self.publisher, port, bind=bind)
                       if serve else None)
        self._stop = threading.Event()  # before the links: they hold is_set
        self.links: dict[str, PeerLink] = {}
        for i, (name, url) in enumerate(sorted((peers or {}).items())):
            self.links[name] = PeerLink(
                name, url, self.state.install_peer,
                interval_s=interval_s, wait_s=wait_s,
                open_after=link_open_after, open_s=link_open_s,
                fetch=fetch,
                seed=None if seed is None else seed + i,
                stop_check=self._stop.is_set,
                clock=clock)
            self.state.register_peer(name, self.links[name])
        self._threads: list[threading.Thread] = []

    # -- exporters (run by refresh, outside the publisher lock) ------------

    def _export_meta(self) -> dict:
        return summary.encode_meta(
            self.publisher.era, self.state.draining, self.cluster)

    def _export_load(self) -> dict:
        return summary.encode_load(
            self.state.local_load_rows(), max_endpoints=self.max_endpoints)

    def _export_prefix(self) -> dict:
        return summary.encode_prefix(
            self.prefix_keys_fn(), max_keys=self.max_prefix_keys)

    # -- lifecycle ---------------------------------------------------------

    def set_draining(self, draining: bool) -> None:
        """Whole-cluster drain toggle: publishes the flag to peers (they
        stop spilling INTO us) and flips the local spill policy (new
        picks bleed to healthy peers; in-flight completes locally)."""
        self.state.draining = bool(draining)
        self.refresh()

    def refresh(self) -> int:
        return self.publisher.refresh()

    def step_links(self, now: Optional[float] = None) -> dict:
        """Drive every link one poll (test/harness seam; production uses
        the per-link threads). Returns {peer: outcome|None}."""
        return {name: link.poll_once(now)
                for name, link in self.links.items()}

    def _refresh_loop(self) -> None:
        tok = self._clock.actor_begin("federation-refresh")
        try:
            while not self._clock.wait_event(
                    self._stop, max(self.interval_s, 0.05)):
                try:
                    self.refresh()
                    # Gauge refresh at publish cadence (not wave
                    # cadence): the staleness/local-only/penalty series
                    # must move even while the cluster is idle — a
                    # partition during a lull is exactly when an
                    # operator reads them.
                    self.state.export_metrics()
                except Exception as e:  # the exchange must never die
                    self.log.error("federation refresh failed", err=e)
        finally:
            self._clock.actor_end(tok)

    def _link_loop(self, link: PeerLink) -> None:
        from gie_tpu_torch.runtime import metrics as own_metrics

        tok = self._clock.actor_begin(f"federation-{link.name}")
        try:
            while not self._clock.wait_event(self._stop, 0.05):
                try:
                    outcome = link.poll_once()
                except Exception as e:
                    self.log.error("peer link loop failed",
                                   peer=link.name, err=e)
                    continue
                if outcome is not None:
                    own_metrics.FED_SYNCS.labels(
                        peer=link.name, outcome=outcome).inc()
        finally:
            self._clock.actor_end(tok)

    def start(self) -> None:
        self._stop.clear()
        t = threading.Thread(target=self._refresh_loop,
                             name="federation-refresh", daemon=True)
        t.start()
        self._threads = [t]
        for link in self.links.values():
            lt = threading.Thread(target=self._link_loop, args=(link,),
                                  name=f"federation-{link.name}",
                                  daemon=True)
            lt.start()
            self._threads.append(lt)

    def stop(self) -> None:
        self._clock.set_event(self._stop)
        for t in self._threads:
            t.join(timeout=5)
        if self.server is not None:
            self.server.close()

    def report(self) -> dict:
        return {
            "cluster": self.cluster,
            "era": list(self.publisher.era),
            "epoch": self.publisher.epoch,
            "draining": self.state.draining,
            "peers": {name: link.report()
                      for name, link in self.links.items()},
            "matrix": self.state.capacity_matrix(),
        }
