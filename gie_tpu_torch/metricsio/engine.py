"""ScrapeEngine: multiplexed keep-alive metrics ingestion (copy of
gie_tpu/metricsio/engine.py, imports pointed at the port).

The reference's data layer mandates a fast poll (~50 ms) per endpoint
(proposal 1023 README:59-60). The seed implementation spent one Python
thread and one fresh TCP connection per endpoint per tick — at the
ROADMAP's hundreds-of-replicas scale that is hundreds of runnable threads
churning the GIL, thousands of connection setups per second, and one
MetricsStore lock acquisition per row, all stolen from the pick path.

This engine keeps the 50 ms cadence with a SMALL FIXED pool of worker
shards (default ``min(8, cpu)``), each driving many endpoints:

  deadline min-heap   each shard schedules its endpoints by earliest-due
                      deadline (jittered so a pool attached in one sweep
                      does not thundering-herd every tick thereafter).
  keep-alive fetch    one persistent ``http.client`` connection per
                      endpoint, reused across scrapes; a failed reuse
                      retries once on a fresh connection (servers may
                      close idle keep-alives at any time).
  O(1) attach/detach  lifecycle events post a command to the owning
                      shard's inbox and return immediately — detach never
                      joins a thread, so a fetch hung on a dead pod can
                      no longer stall slot reclaim for its 2 s timeout.
  adaptive backoff    an unreachable endpoint's effective interval
                      doubles per consecutive failure up to
                      ``max_backoff_s`` (1 s) and snaps back to the base
                      interval on the first success, so dead pods stop
                      taxing the shard budget live pods need.
  batched writes      a shard's completed sweep lands in the store via
                      ONE ``MetricsStore.update_rows`` lock acquisition,
                      not one per endpoint.

Observability (runtime/metrics.py): ``gie_scrape_staleness_seconds``
(achieved row refresh interval), ``gie_scrape_fetch_seconds``,
``gie_scrape_connection_reuse_ratio``, ``gie_scrape_consecutive_failures_max``
and ``gie_scrape_endpoints``. The autoscale SignalCollector reads
``staleness_seconds()`` as a second staleness source next to the store's
row ages (docs/METRICSIO.md).
"""

from __future__ import annotations

import heapq
import http.client
import itertools
import random
import threading
import urllib.parse
from typing import Optional

from gie_tpu_torch.metricsio.mappings import ServerMapping
from gie_tpu_torch.metricsio.store import MetricsStore
from gie_tpu_torch.resilience import faults
from gie_tpu_torch.resilience.policy import JITTER_SYMMETRIC, Backoff, BackoffPolicy
from gie_tpu_torch.runtime.clock import MONOTONIC, Clock
from gie_tpu_torch.utils.lora import LoraRegistry


def _default_workers() -> int:
    import os

    return max(1, min(8, os.cpu_count() or 1))


class _Endpoint:
    """One attached endpoint's scrape state. Owned by exactly one shard
    after attach; the engine lock guards only the fields the control
    plane touches (``dead``)."""

    __slots__ = (
        "slot", "url", "mapping", "host", "port", "path", "conn",
        "due", "backoff", "last_success", "attached_at", "dead",
    )

    def __init__(self, slot: int, url: str, mapping: ServerMapping,
                 backoff: Backoff, attached_at: float):
        self.slot = slot
        self.url = url
        self.mapping = mapping
        parts = urllib.parse.urlsplit(url)
        self.host = parts.hostname or ""
        self.port = parts.port or 80
        self.path = (parts.path or "/") + (
            f"?{parts.query}" if parts.query else "")
        self.conn: Optional[http.client.HTTPConnection] = None
        self.due = 0.0             # clock deadline for the next scrape
        # Shared resilience policy (gie_tpu/resilience/policy.py): the
        # per-endpoint failure-streak state machine that used to be a bare
        # counter plus inline 2**min(streak, 20) arithmetic here.
        self.backoff = backoff
        self.last_success = 0.0    # clock time; 0 = never scraped
        self.attached_at = attached_at
        self.dead = False          # set under the engine lock on detach

    @property
    def fail_streak(self) -> int:
        return self.backoff.failures

    def close_conn(self) -> None:
        conn, self.conn = self.conn, None
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass


# Flush the pending batched writes once this many rows accumulate even if
# more endpoints are due (bounds the staleness a write can sit unflushed).
_FLUSH_MAX = 32


class ScrapeEngine:
    """Multiplexed fast-poll scraper: ``workers`` shard threads drive any
    number of endpoints over persistent connections.

    Drop-in lifecycle API: ``attach(slot, url, mapping)`` /
    ``detach(slot)`` / ``close()`` — both non-blocking (detach marks the
    endpoint dead and clears its row; the owning shard drops the heap
    entry lazily). ``fetcher`` overrides the keep-alive HTTP path with a
    plain callable (tests, benchmarks, simulators).
    """

    def __init__(
        self,
        store: MetricsStore,
        lora: Optional[LoraRegistry] = None,
        interval_s: float = 0.05,
        fetcher=None,
        workers: Optional[int] = None,
        max_backoff_s: float = 1.0,
        timeout_s: Optional[float] = None,
        jitter: float = 0.1,
        breaker_board=None,
        clock: Clock = MONOTONIC,
        rng=None,
    ):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        # Clock seam (gie_tpu/runtime/clock.py): shard deadline heaps,
        # backoff pacing, and the staleness clocks all read this — a
        # virtual-time storm drives the whole scrape plane off the
        # simulated timeline. ``rng`` (default: the module-level random
        # the engine always used) seeds the attach phase-stagger AND the
        # per-endpoint backoff jitter, so a seeded engine schedules
        # deterministically.
        self._clock = clock
        self._rng = rng if rng is not None else random
        self.store = store
        self.lora = lora or LoraRegistry()
        self.interval_s = interval_s
        self.fetcher = fetcher
        self.workers = workers if workers else _default_workers()
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        # Backoff never caps below the base interval (an operator running
        # a slow 2 s poll must not see failures SPEED polling up).
        self.max_backoff_s = max(max_backoff_s, interval_s)
        # Shared jittered-backoff policy (resilience/policy.py) replacing
        # the hand-rolled streak-exponent arithmetic: same shape — double
        # per consecutive failure, exponent capped at 20, symmetric
        # jitter, snap back to the base cadence on success (parity pinned
        # by tests/test_resilience.py).
        self._backoff_policy = BackoffPolicy(
            base_s=interval_s,
            max_s=self.max_backoff_s,
            jitter=jitter,
            jitter_mode=JITTER_SYMMETRIC,
            max_exponent=20,
        )
        # Optional resilience.BreakerBoard: fetch outcomes feed the
        # per-endpoint circuit breakers the pick path's candidate filter
        # reads (docs/RESILIENCE.md).
        self.breaker_board = breaker_board
        # Connect/read timeout: a SYN-black-holed pod (typical k8s death —
        # no RST) blocks its shard for the FULL timeout per attempt, so
        # the default scales with the poll cadence instead of inheriting
        # the legacy flat 2 s: at 50 ms that is a 250 ms worst-case shard
        # stall, and with the 1 s backoff between attempts the dead pod
        # costs its shard <25% duty instead of ~70%. Overridable for slow
        # backends.
        self.timeout_s = (timeout_s if timeout_s is not None
                          else min(2.0, max(5.0 * interval_s, 0.25)))
        self._lock = threading.Lock()
        self._live: dict[int, _Endpoint] = {}
        self._fetches = 0        # keep-alive path attempts (engine lock)
        self._reused = 0         # ... that reused a live connection
        self._closed = False
        # Early-scrape window: an endpoint due within this many seconds is
        # scraped NOW instead of paying a timed sleep for the gap. Timed
        # waits on small timeouts cost ~1 ms of timer slack on stock
        # kernels — sleeping per sub-millisecond heap gap convoys the
        # shard into permanent backlog. Scraping early is harmless: the
        # next deadline keys off the fetch start, so cadence is preserved
        # (a constant phase shift, not drift).
        self._early_s = min(0.005, interval_s / 4.0)
        self._shards = [_Shard(self, i) for i in range(self.workers)]
        for s in self._shards:
            s.thread.start()

    # -- lifecycle (control plane; O(1), never blocks on I/O) -------------

    def _shard_for(self, slot: int) -> "_Shard":
        return self._shards[slot % self.workers]

    def attach(self, slot: int, url: str, mapping: ServerMapping) -> None:
        with self._lock:
            if self._closed:
                return
            prev = self._live.get(slot)
            if prev is not None and prev.url == url:
                return
            if prev is not None:
                # Endpoint re-bound (port renumber / pod IP change): the
                # old state is dropped by its shard; the row survives
                # (same pod identity, new address).
                prev.dead = True
            now = self._clock.now()
            ep = _Endpoint(slot, url, mapping,
                           Backoff(self._backoff_policy, rng=self._rng),
                           attached_at=now)
            # Phase-stagger the first scrape so a pool attached in one
            # reconcile sweep spreads over the interval instead of
            # thundering every tick in lockstep.
            ep.due = now + self._rng.uniform(0, self.interval_s)
            self._live[slot] = ep
        shard = self._shard_for(slot)
        shard.inbox.append(ep)
        self._clock.set_event(shard.wake)

    def detach(self, slot: int) -> None:
        """Stop scraping ``slot`` and clear its row. Returns immediately:
        the kill is a flag flip under the engine lock — a fetch currently
        hung on this endpoint finishes (or times out) on its shard and
        its result is discarded by the dead check inside the same lock
        that ordered this removal, so the cleared row cannot be
        resurrected by a late write."""
        with self._lock:
            ep = self._live.pop(slot, None)
            if ep is not None:
                ep.dead = True
            self.store.remove(slot)
        if self.breaker_board is not None:
            # Breaker history must not outlive the endpoint: a reused
            # slot starts CLOSED.
            self.breaker_board.drop(slot)
        if ep is not None:
            self._clock.set_event(self._shard_for(slot).wake)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            slots = list(self._live)
            for ep in self._live.values():
                ep.dead = True
            self._live.clear()
            for slot in slots:
                self.store.remove(slot)
        for s in self._shards:
            self._clock.set_event(s.wake)
        for s in self._shards:
            # Bounded: a shard hung inside a fetch is a daemon thread and
            # holds no locks anyone waits on — close must not inherit the
            # stall the non-blocking detach was built to avoid.
            s.thread.join(timeout=1)

    # -- introspection (autoscale staleness input, tests, bench) ----------

    def staleness_seconds(self, now: Optional[float] = None) -> float:
        """Oldest time-since-last-successful-scrape across attached
        endpoints (attach age for never-scraped ones); 0.0 when nothing
        is attached. The autoscale SignalCollector reads this next to
        the store's row ages: it covers the ingestion-side outage modes
        the row ages cannot (every endpoint unreachable and backing off,
        or a wedged shard), straight from the engine's own clocks."""
        now = self._clock.now() if now is None else now
        with self._lock:
            if not self._live:
                return 0.0
            return max(
                now - (ep.last_success or ep.attached_at)
                for ep in self._live.values()
            )

    def consecutive_failures_max(self) -> int:
        with self._lock:
            return max(
                (ep.fail_streak for ep in self._live.values()), default=0)

    def connection_reuse_ratio(self) -> float:
        with self._lock:
            return self._reused / self._fetches if self._fetches else 0.0

    def endpoint_count(self) -> int:
        with self._lock:
            return len(self._live)

    # -- data plane (shard threads) ---------------------------------------

    def _fetch(self, ep: _Endpoint) -> bytes:
        """Keep-alive GET with a single fresh-connection retry (an idle
        keep-alive may be closed server-side between scrapes; only the
        retry's failure is a real endpoint failure)."""
        if faults.ENABLED:
            # gie-chaos fault points (resilience/faults.py): per-endpoint
            # added latency / hang, then the fetch failure itself. Keyed
            # by URL so a scenario can target a subset of the pool and a
            # seed reproduces the same per-endpoint schedule.
            faults.check("endpoint.slow", key=ep.url)
            faults.check("endpoint.hang", key=ep.url)
            faults.check("scrape.fetch", key=ep.url)
        if self.fetcher is not None:
            return self.fetcher(ep.url)
        fresh = ep.conn is None
        for attempt in (0, 1):
            if ep.conn is None:
                ep.conn = http.client.HTTPConnection(
                    ep.host, ep.port, timeout=self.timeout_s)
                fresh = True
            try:
                ep.conn.request("GET", ep.path)
                resp = ep.conn.getresponse()
                body = resp.read()
                if resp.status != 200:
                    raise OSError(f"HTTP {resp.status} from {ep.url}")
                if resp.will_close:
                    ep.close_conn()
                with self._lock:
                    self._fetches += 1
                    if not fresh:
                        self._reused += 1
                return body
            except Exception:
                ep.close_conn()
                if fresh or attempt == 1:
                    raise
                # else: stale keep-alive; retry once on a new connection.
        raise AssertionError("unreachable")

    def _scrape(self, ep: _Endpoint):
        """Fetch + parse one endpoint; reschedules ``ep.due``. Returns the
        store row tuple or None (failure / empty exposition)."""
        from gie_tpu_torch.metricsio.scrape import parse_scrape
        from gie_tpu_torch.runtime import metrics as own_metrics

        t0 = self._clock.now()
        try:
            payload = self._fetch(ep)
            metrics, active, waiting = parse_scrape(
                payload, ep.mapping, self.lora)
        except Exception:
            # Unreachable endpoint: leave the last row (staleness shows up
            # via METRICS_AGE_S; the reference keeps stale metrics rather
            # than evicting) and back the poll off so a dead pod stops
            # taxing the shard budget its live peers need. The delay
            # shape (exponent capped at 20, symmetric jitter, max_s
            # ceiling) lives in the shared policy module now.
            ep.due = self._clock.now() + ep.backoff.fail()
            if self.breaker_board is not None:
                self.breaker_board.record(ep.slot, False)
            return None
        done = self._clock.now()
        own_metrics.SCRAPE_FETCH.observe(done - t0)
        own_metrics.SCRAPE_STALENESS.observe(
            done - (ep.last_success or ep.attached_at))
        ep.last_success = done
        if self.breaker_board is not None:
            self.breaker_board.record(ep.slot, True)
        # Snap back to the base cadence; next deadline keyed off the fetch
        # START, matching the legacy interval - elapsed pacing; never
        # sooner than 1 ms out.
        ep.due = max(t0 + ep.backoff.ok(), done + 0.001)
        if not metrics:
            return None
        return (ep, metrics, active, waiting)

    def _flush(self, pending: list) -> None:
        """Apply a shard's completed sweep: one engine-lock section, one
        store-lock acquisition (update_rows). The dead check inside this
        lock is what makes detach's row clear final."""
        from gie_tpu_torch.runtime import metrics as own_metrics

        with self._lock:
            rows = [
                (ep.slot, metrics, active, waiting)
                for ep, metrics, active, waiting in pending
                if not ep.dead and self._live.get(ep.slot) is ep
            ]
            if rows:
                self.store.update_rows(rows)
            n_live = len(self._live)
            streak = max(
                (e.fail_streak for e in self._live.values()), default=0)
            reuse = self._reused / self._fetches if self._fetches else 0.0
        pending.clear()
        # Gauges update even on an EMPTY sweep: during a full outage no
        # rows complete, and a failure gauge frozen at its pre-outage
        # value is worthless exactly when it matters.
        own_metrics.SCRAPE_ENDPOINTS.set(n_live)
        own_metrics.SCRAPE_FAILS_MAX.set(streak)
        own_metrics.SCRAPE_REUSE.set(reuse)
        if self.breaker_board is not None:
            own_metrics.BREAKER_OPEN.set(self.breaker_board.open_count())


class _Shard:
    """One worker: a deadline min-heap over its endpoints, an inbox for
    O(1) attach handoff, and a wake event for early deadlines/shutdown."""

    def __init__(self, engine: ScrapeEngine, index: int):
        self.engine = engine
        self.inbox: list[_Endpoint] = []  # append/pop both GIL-atomic
        self.wake = threading.Event()
        self.thread = threading.Thread(
            target=self._run, name=f"scrape-shard-{index}", daemon=True)

    def _run(self) -> None:
        eng = self.engine
        # Virtual-time actor registration (runtime/clock.py): the shard
        # is one of the simulation's parked/active participants; on the
        # real clock this is a no-op.
        tok = eng._clock.actor_begin(self.thread.name)
        try:
            self._run_inner()
        finally:
            eng._clock.actor_end(tok)

    def _run_inner(self) -> None:
        eng = self.engine
        heap: list[tuple[float, int, _Endpoint]] = []
        seq = itertools.count()  # heap tiebreak: _Endpoint is unordered
        pending: list = []
        while True:
            while self.inbox:
                ep = self.inbox.pop()
                heapq.heappush(heap, (ep.due, next(seq), ep))
            if eng._closed:
                eng._flush(pending)
                return
            if not heap:
                eng._flush(pending)
                eng._clock.wait_event(self.wake, 0.2)
                self.wake.clear()
                continue
            due, _, ep = heap[0]
            if ep.dead:
                heapq.heappop(heap)
                ep.close_conn()
                continue
            now = eng._clock.now()
            if due > now + eng._early_s:
                # Idle until the earliest deadline: the sweep is complete,
                # so write it out, then sleep interruptibly (attach of an
                # earlier-due endpoint or close sets the wake event).
                # Deadlines inside the early window are taken immediately
                # instead — see ScrapeEngine._early_s.
                eng._flush(pending)
                eng._clock.wait_event(self.wake, min(due - now, 0.2))
                self.wake.clear()
                continue
            heapq.heappop(heap)
            row = eng._scrape(ep)
            if row is not None:
                pending.append(row)
                if len(pending) >= _FLUSH_MAX:
                    eng._flush(pending)
            heapq.heappush(heap, (ep.due, next(seq), ep))
