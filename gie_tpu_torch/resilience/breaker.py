"""(Copy of gie_tpu/resilience/breaker.py, imports rewritten to gie_tpu_torch.)

Per-endpoint circuit breakers, fed from BOTH planes.

A persistently failing endpoint today costs the pool forever: the
scrape engine backs off its polls, but the PICK path keeps routing to
it on stale last-known-good metrics until the datastore evicts the pod.
The breaker closes that gap: an error streak OPENS the endpoint's
breaker (the pick path's candidate filter drops it, the scrape engine
clamps it to its slowest cadence), a dwell later it goes HALF_OPEN (one
subsystem probe is allowed through), and only a hysteretic streak of
successes CLOSES it again — one flapping success cannot un-quarantine a
sick pod.

Two outcome planes feed a breaker (docs/RESILIENCE.md "data-plane
signals"):

  control plane  scrape fetch outcomes via :meth:`BreakerBoard.record`
                 — the scrape-streak model.
  data plane     per-request serve outcomes (Envoy ``:status`` 5xx,
                 upstream resets) via
                 :meth:`BreakerBoard.record_serve_outcome` — the Envoy
                 outlier-detection model: consecutive-5xx *or* an
                 error RATE over a sliding window opens, so a pod that
                 scrapes healthy but serves errors still quarantines,
                 even when interleaved scrape successes keep resetting
                 the streak.

The planes are deliberately asymmetric on RECOVERY: a breaker opened by
serve outcomes ("serve"-opened) can only be closed by serve outcomes —
a healthy ``/metrics`` endpoint says nothing about whether inference
requests stop 5xx-ing. For serve-opened breakers the pick path's
``quarantined()`` read doubles as the probe gate: once the dwell
elapses, the endpoint is re-admitted HALF_OPEN and live traffic is the
probe — safe now precisely because the response path records every
outcome (the objection "a probe whose outcome is never recorded",
no longer holds).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

from gie_tpu_torch.runtime.clock import MONOTONIC


class BreakerState:
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


# Which plane opened a breaker (recovery routing; see module docstring).
SCRAPE = "scrape"
SERVE = "serve"


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    open_after: int = 5        # consecutive failures that OPEN
    open_s: float = 2.0        # dwell before the half-open probe window
    close_after: int = 2       # consecutive half-open successes to CLOSE
    # Data-plane windowed error-rate model (serve outcomes): the breaker
    # also opens when >= serve_rate_open of the last serve_window_s of
    # serve outcomes failed, given at least serve_min_samples — the
    # rate-over-window half of "consecutive-5xx OR rate-over-window".
    serve_window_s: float = 10.0
    serve_rate_open: float = 0.5
    serve_min_samples: int = 10

    def __post_init__(self):
        if self.open_after < 1 or self.close_after < 1 or self.open_s < 0:
            raise ValueError("breaker thresholds must be positive")
        if not (0.0 < self.serve_rate_open <= 1.0):
            raise ValueError("serve_rate_open must be in (0, 1]")
        if self.serve_window_s <= 0 or self.serve_min_samples < 1:
            raise ValueError("serve window parameters must be positive")


class BucketWindow:
    """Fixed-bucket sliding-window core: O(1) note, O(buckets) read, no
    per-sample storage. Shared by :class:`WindowedRate` (here) and the
    fairness ledgers' ``WindowedSum`` (gie_tpu/fairness/budgets.py) so
    one place owns bucket width, pruning, and live-bucket selection —
    the two can never age differently over the same ``window_s``.
    Subclasses declare the zero payload stored after each bucket's
    index (``_ZERO``). Not thread-safe; callers hold their own lock."""

    __slots__ = ("window_s", "_bucket_s", "_buckets")
    _N_BUCKETS = 8
    _ZERO: tuple = ()

    def __init__(self, window_s: float):
        self.window_s = window_s
        self._bucket_s = window_s / self._N_BUCKETS
        # Each entry: [bucket_index, *payload], oldest first.
        self._buckets: list[list] = []

    def _prune(self, now: float) -> None:
        floor = int(now / self._bucket_s) - self._N_BUCKETS
        buckets = self._buckets
        while buckets and buckets[0][0] <= floor:
            buckets.pop(0)

    def _live_bucket(self, now: float) -> list:
        self._prune(now)
        idx = int(now / self._bucket_s)
        if not self._buckets or self._buckets[-1][0] != idx:
            self._buckets.append([idx, *self._ZERO])
        return self._buckets[-1]

    def reset(self) -> None:
        self._buckets = []


class WindowedRate(BucketWindow):
    """Sliding-window ok/error counts — serve outcomes arrive at
    request cadence."""

    __slots__ = ()
    _ZERO = (0, 0)

    def note(self, ok: bool, now: float) -> None:
        self._live_bucket(now)[1 if ok else 2] += 1

    def rate(self, now: float) -> tuple[float, int]:
        """-> (error_fraction, sample_count) over the live window."""
        self._prune(now)
        ok = sum(b[1] for b in self._buckets)
        err = sum(b[2] for b in self._buckets)
        n = ok + err
        return (err / n if n else 0.0), n


class CircuitBreaker:
    """One endpoint's breaker. Not thread-safe on its own — the board
    serializes access (one short lock per record/allow, far off any hot
    path: outcomes arrive at scrape cadence, reads at pick cadence only
    while at least one breaker is non-closed)."""

    __slots__ = ("cfg", "clock", "state", "fail_streaks", "ok_streak",
                 "opened_at", "opened_by", "transitions", "serve_window")

    def __init__(self, cfg: BreakerConfig,
                 clock: Callable[[], float] = MONOTONIC.now):
        self.cfg = cfg
        self.clock = clock
        self.state = BreakerState.CLOSED
        # Per-PLANE consecutive-failure streaks: a serve success must not
        # reset the scrape streak (or vice versa) — a metrics-dead pod
        # serving 2xx at normal QPS would otherwise never accumulate the
        # scrape streak that quarantines it, and a 5xx streak at 4 plus
        # one scrape hiccup would open as scrape-owned, handing recovery
        # to the wrong plane.
        self.fail_streaks = {SCRAPE: 0, SERVE: 0}
        self.ok_streak = 0
        self.opened_at = 0.0
        self.opened_by = SCRAPE
        self.transitions = 0
        self.serve_window = WindowedRate(cfg.serve_window_s)

    @property
    def fail_streak(self) -> int:
        """Worst plane streak (introspection/ops reporting)."""
        return max(self.fail_streaks.values())

    def _to(self, state: str, plane: str = SCRAPE) -> None:
        if state != self.state:
            self.state = state
            self.transitions += 1
            if state == BreakerState.OPEN:
                self.opened_at = self.clock()
                self.opened_by = plane
            elif state == BreakerState.CLOSED:
                # Fresh slate: the window's pre-quarantine errors (and
                # either plane's stale streak) must not instantly
                # re-open a breaker that just healed.
                self.serve_window.reset()
                self.fail_streaks[SCRAPE] = 0
                self.fail_streaks[SERVE] = 0

    def record(self, ok: bool, plane: str = SCRAPE) -> None:
        if ok:
            # A success only vouches for its OWN plane: it clears that
            # plane's streak and may probe/close only a breaker that
            # plane opened. Cross-plane successes are inert — a healthy
            # /metrics fetch says nothing about whether inference
            # requests stop 5xx-ing (serve-opened would close within
            # two sweeps under the exact scrapes-clean-serves-5xx
            # condition that opened it), and a clean serve says nothing
            # about the /metrics endpoint a scrape-opened breaker is
            # quarantining (in-flight 2xx would close it with zero
            # dwell and flap a metrics-dead pod in and out of rotation).
            self.fail_streaks[plane] = 0
            if (self.state != BreakerState.CLOSED
                    and plane != self.opened_by):
                return
            if self.state == BreakerState.HALF_OPEN:
                self.ok_streak += 1
                if self.ok_streak >= self.cfg.close_after:
                    self._to(BreakerState.CLOSED)
            elif self.state == BreakerState.OPEN:
                # A success observed while OPEN (e.g. a data-plane
                # fallback served): treat as an early probe result.
                self.ok_streak = 1
                self._to(BreakerState.HALF_OPEN)
            return
        self.ok_streak = 0
        self.fail_streaks[plane] += 1
        if self.state == BreakerState.HALF_OPEN:
            # Probe failed: dwell again, KEEPING the original opening
            # plane — a transient cross-plane failure must not hand
            # recovery ownership to the wrong plane's successes (the
            # condition that opened the breaker is still unresolved; if
            # the other plane is genuinely failing too, its own streak
            # or the serve window will reclassify on the next open).
            self._to(BreakerState.OPEN, self.opened_by)
        elif (self.state == BreakerState.CLOSED
              and self.fail_streaks[plane] >= self.cfg.open_after):
            self._to(BreakerState.OPEN, plane)

    def record_serve(self, ok: bool, latency_s: float = 0.0) -> None:
        """One data-plane serve outcome (5xx / upstream reset / success).
        Feeds both open models: the shared consecutive-failure streak
        (record) AND the sliding error-rate window — scrape successes
        interleaved at sweep cadence reset the streak, so a pod serving
        steady 5xx behind a healthy /metrics endpoint only opens via the
        rate. ``latency_s`` is accepted for API completeness (exported
        via gie_serve_latency_seconds by the caller; not yet a trip
        signal)."""
        del latency_s
        now = self.clock()
        self.serve_window.note(ok, now)
        self.record(ok, plane=SERVE)
        if self.state == BreakerState.CLOSED and not ok:
            err, n = self.serve_window.rate(now)
            if (n >= self.cfg.serve_min_samples
                    and err >= self.cfg.serve_rate_open):
                self._to(BreakerState.OPEN, SERVE)

    def allow(self) -> bool:
        """May traffic/probes reach this endpoint right now? OPEN flips
        itself to HALF_OPEN once the dwell elapses (clock-driven, so a
        quiet period still lets the probe window arrive)."""
        if self.state == BreakerState.CLOSED:
            return True
        if self.state == BreakerState.OPEN:
            if self.clock() - self.opened_at >= self.cfg.open_s:
                self.ok_streak = 0
                self._to(BreakerState.HALF_OPEN)
                return True
            return False
        return True  # HALF_OPEN: probes flow; outcomes decide


class BreakerBoard:
    """Keyed breaker registry (key = endpoint slot). ``has_open`` is the
    pick path's cheap guard: a plain bool read, maintained on every
    state transition, so the per-request candidate filter costs one
    attribute check while the whole pool is healthy."""

    def __init__(self, cfg: Optional[BreakerConfig] = None,
                 clock: Callable[[], float] = MONOTONIC.now):
        self.cfg = cfg if cfg is not None else BreakerConfig()
        self.clock = clock
        self._lock = threading.Lock()
        self._breakers: dict[int, CircuitBreaker] = {}
        self.has_open = False
        # Ordered state-transition log: (key, state, owning_plane) per
        # observed transition, times deliberately omitted — the real-vs-
        # virtual equivalence contract (docs/STORM.md) compares EVENT
        # ORDER across clock modes, and wall timestamps would never
        # match. Bounded; storms record hundreds, not millions.
        self.events: list[tuple[int, str, str]] = []
        self._events_cap = 4096

    def _refresh_has_open(self) -> None:
        self.has_open = any(
            b.state != BreakerState.CLOSED
            for b in self._breakers.values())

    def _log_event_locked(self, key: int, b: CircuitBreaker) -> None:
        if len(self.events) < self._events_cap:
            self.events.append((key, b.state, b.opened_by))

    def _record_with(self, key: int, ok: bool, apply) -> bool:
        """Shared get-or-create + transition bookkeeping for both outcome
        planes; returns True when the breaker changed state."""
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                if ok:
                    return False  # healthy unknown endpoint
                b = CircuitBreaker(self.cfg, self.clock)
                self._breakers[key] = b
            before = b.state
            apply(b)
            changed = b.state != before
            if changed:
                self._refresh_has_open()
                self._log_event_locked(key, b)
            return changed

    def record(self, key: int, ok: bool) -> None:
        """Control-plane (scrape fetch) outcome."""
        self._record_with(key, ok, lambda b: b.record(ok))

    def record_serve_outcome(self, key: int, ok: bool,
                             latency_s: float = 0.0) -> bool:
        """Data-plane serve outcome for one endpoint (Envoy ``:status``
        5xx, upstream reset, or a clean serve) — the response-path half
        of the feedback loop (docs/RESILIENCE.md). Returns True when the
        breaker changed state, so the caller can refresh
        gie_breaker_open_endpoints without paying open_count() per
        request."""
        return self._record_with(
            key, ok, lambda b: b.record_serve(ok, latency_s))

    def trip(self, key: int, plane: str = SERVE) -> bool:
        """Force-open one endpoint's breaker (p99 outlier ejection,
        resilience/outlier.py): the ejector's verdict is not a single
        outcome, so it cannot arrive through record()/record_serve_
        outcome — it trips the breaker directly, on the SERVE plane by
        default so RECOVERY reuses the serve-opened machinery (dwell,
        HALF_OPEN re-admission via quarantined(), live-traffic probes
        closing or re-opening it). Returns True when the call actually
        opened a closed/half-open breaker."""
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = CircuitBreaker(self.cfg, self.clock)
                self._breakers[key] = b
            if b.state == BreakerState.OPEN:
                return False
            b.ok_streak = 0
            b._to(BreakerState.OPEN, plane)
            self._refresh_has_open()
            self._log_event_locked(key, b)
            return True

    def allow(self, key: int) -> bool:
        if not self.has_open:
            return True
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                return True
            before = b.state
            verdict = b.allow()
            if b.state != before:
                self._refresh_has_open()
                self._log_event_locked(key, b)
            return verdict

    def quarantined(self, key: int) -> bool:
        """Data-plane pick check: should this endpoint be excluded?

        For SCRAPE-opened breakers this stays strictly read-only — the
        half-open probe budget belongs to the scrape engine, which both
        admits probes and records their outcomes; a pick admitted as a
        "probe" whose outcome is never recorded would re-expose live
        traffic without ever helping the breaker close.

        For SERVE-opened breakers the pick path IS the probing
        subsystem now: the response path records every serve outcome
        (including aborts, fed back as resets), so once the dwell
        elapses the endpoint is re-admitted HALF_OPEN and live traffic
        probes it — serve successes close it, the first failure
        re-quarantines it for another dwell (the Envoy outlier-ejection
        recovery model). Without this, a serve-opened breaker could
        never close: scrape successes are deliberately ignored for it.
        """
        if not self.has_open:
            return False
        with self._lock:
            b = self._breakers.get(key)
            if b is None or b.state == BreakerState.CLOSED:
                return False
            if b.opened_by == SERVE:
                before = b.state
                verdict = not b.allow()
                if b.state != before:
                    self._log_event_locked(key, b)
                return verdict
            return True

    def state(self, key: int) -> str:
        with self._lock:
            b = self._breakers.get(key)
            return b.state if b is not None else BreakerState.CLOSED

    def states(self) -> dict[int, str]:
        """Non-closed breakers only (the health/ops report)."""
        with self._lock:
            return {
                k: b.state for k, b in self._breakers.items()
                if b.state != BreakerState.CLOSED
            }

    def open_count(self) -> int:
        with self._lock:
            return sum(1 for b in self._breakers.values()
                       if b.state == BreakerState.OPEN)

    def report(self) -> dict:
        """Full per-endpoint breaker dump for the /debugz/breakers zpage
        (gie_tpu/obs): state, owning plane, both planes' streaks, the
        serve window's live error rate, and dwell age — everything
        states() summarizes away. Leaf-lock only; no I/O under it."""
        with self._lock:
            now = self.clock()
            out = {}
            for key, b in self._breakers.items():
                err, n = b.serve_window.rate(now)
                out[str(key)] = {
                    "state": b.state,
                    "opened_by": b.opened_by,
                    "fail_streaks": dict(b.fail_streaks),
                    "ok_streak": b.ok_streak,
                    "open_age_s": (
                        round(now - b.opened_at, 3)
                        if b.state != BreakerState.CLOSED else 0.0),
                    "serve_error_rate": round(err, 4),
                    "serve_samples": n,
                    "transitions": b.transitions,
                }
            return {"has_open": self.has_open, "breakers": out}

    def drop(self, key: int) -> None:
        """Endpoint evicted: its breaker history must not outlive it (a
        reused slot starts CLOSED)."""
        with self._lock:
            if self._breakers.pop(key, None) is not None:
                self._refresh_has_open()
