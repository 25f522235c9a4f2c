"""(Copy of gie_tpu/resilience/ladder.py, imports rewritten to gie_tpu_torch.)

Pick-path degradation ladder.

The batched TPU pick is the best scheduler this gateway has — and the
only one the seed had. A device-dispatch failure, a metrics blackout,
or a pick path suddenly taking seconds used to mean UNAVAILABLE for
every request until a human intervened. The ladder gives the pick path
defined degraded modes instead, each strictly dumber and strictly more
dependable than the one above:

  FULL         the batched device cycle (scorers, prefix affinity, OT)
  CACHED       host-side pick over the bounded-staleness metrics rows
               (least queue+KV, assumed-load spread within the wave) —
               for when the DEVICE is sick but the data is fresh
  ROUND_ROBIN  smooth weighted round-robin over last-known-good rows —
               for when the data went dark too (metrics blackout)
  STATIC       plain rotation over a fixed subset of live endpoints —
               the "never 503 the whole pool" floor

Descent is immediate (an error streak, a blackout, a latency breach);
ascent is hysteretic: a minimum dwell on the current rung plus a streak
of successful full-path probes, so a flapping device cannot oscillate
the pool between scheduling regimes. `gie_degraded_mode` exports the
current rung; the health endpoint's "resilience" sub-service reports it
with breaker states.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Callable, Optional

from gie_tpu_torch.resilience.breaker import BreakerBoard, WindowedRate
from gie_tpu_torch.runtime.clock import MONOTONIC


class Rung(enum.IntEnum):
    FULL = 0
    CACHED = 1
    ROUND_ROBIN = 2
    STATIC = 3


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    # Descent triggers.
    dispatch_error_streak: int = 3    # consecutive device errors -> down
    blackout_stale_s: float = 5.0     # metrics older than this -> RR floor
    latency_breach_s: float = 1.0     # a "slow" full pick
    latency_breach_streak: int = 8    # consecutive slow picks -> CACHED
    # Hysteretic ascent.
    recover_streak: int = 4           # successful probes to climb one rung
    min_dwell_s: float = 2.0          # min time on a rung before climbing
    probe_interval_s: float = 1.0     # full-path probe cadence while down
    # Blackout recovery hysteresis: staleness must fall back below
    # blackout_stale_s * this fraction before the RR floor lifts.
    blackout_recover_fraction: float = 0.5
    # Data-plane serve-outcome floor: a POOL-WIDE 5xx/reset storm (error
    # rate over the sliding window >= serve_error_rate with at least
    # serve_min_samples) pins the ladder at ROUND_ROBIN even when
    # scrapes look clean — whatever data the full path is scoring on is
    # demonstrably not predicting serve outcomes, so spread uniformly
    # and let the per-endpoint breakers carve out the truly sick pods.
    # The floor lifts when the rate falls under serve_error_rate *
    # blackout_recover_fraction, or when the window drains empty.
    serve_window_s: float = 10.0
    serve_error_rate: float = 0.5
    serve_min_samples: int = 20
    # CACHED-rung score weight: the host-side degraded pick ranks
    # endpoints by ``queue_depth + cached_kv_weight * kv_util``. The
    # default comes from the storm sweep recorded in docs/RESILIENCE.md
    # ("ladder calibration"): under a forced-CACHED flash-crowd storm,
    # w=0 (KV-blind) is clearly worst (-8% goodput, +58% TTFT p99 —
    # queue depth alone cannot see a pod whose cache is about to
    # thrash), while 2..32 sit on a flat plateau with 8 at its optimum
    # — so 8 stays. The runner wires --ladder-cached-kv-weight.
    cached_kv_weight: float = 8.0
    # ROUND_ROBIN-rung smooth-WRR weight shape: per-endpoint weight is
    # ``(1 + last_known_queue_depth) ** -wrr_queue_alpha``. 0 = uniform
    # rotation (ignore the stale rows entirely), 1 = the inverse-queue
    # default, larger = steer harder away from queues the blackout froze.
    # Calibrated by the storm sweep recorded in docs/RESILIENCE.md
    # ("ladder calibration"); the runner wires --ladder-wrr-alpha.
    wrr_queue_alpha: float = 1.0

    def __post_init__(self):
        if (self.dispatch_error_streak < 1 or self.recover_streak < 1
                or self.latency_breach_streak < 1):
            raise ValueError("ladder streaks must be >= 1")
        if not (0.0 < self.blackout_recover_fraction <= 1.0):
            raise ValueError("blackout_recover_fraction must be in (0, 1]")
        if not (0.0 < self.serve_error_rate <= 1.0):
            raise ValueError("serve_error_rate must be in (0, 1]")
        if self.serve_window_s <= 0 or self.serve_min_samples < 1:
            raise ValueError("serve window parameters must be positive")
        if self.cached_kv_weight < 0:
            raise ValueError("cached_kv_weight must be >= 0")
        if self.wrr_queue_alpha < 0:
            raise ValueError("wrr_queue_alpha must be >= 0")


class DegradationLadder:
    """Thread-safe rung state machine. ``note_*`` feeds come from the
    batching collector (dispatch outcomes, per-wave) and whoever owns a
    staleness clock (the scrape engine via ResilienceState.observe);
    ``rung()`` is read per wave, never per request."""

    def __init__(
        self,
        cfg: Optional[LadderConfig] = None,
        clock: Callable[[], float] = MONOTONIC.now,
        on_change: Optional[Callable[[int], None]] = None,
    ):
        self.cfg = cfg if cfg is not None else LadderConfig()
        self.clock = clock
        self.on_change = on_change
        self._lock = threading.Lock()
        self._level = Rung.FULL          # error-driven component
        self._blackout_floor = Rung.FULL  # staleness-driven component
        self._serve_floor = Rung.FULL    # data-plane serve-outcome component
        self._serve_window = WindowedRate(self.cfg.serve_window_s)
        self._err_streak = 0
        self._ok_streak = 0
        self._slow_streak = 0
        self._changed_at = clock()
        self._last_probe = 0.0
        self.transitions: list[tuple[float, int]] = []  # (t, rung) trace

    # -- reads -------------------------------------------------------------

    def rung(self) -> Rung:
        with self._lock:
            # Lazy serve-floor lift: with traffic gone the window drains
            # empty and no note_serve_outcome will ever arrive to lift
            # the floor — re-evaluate on read (wave cadence, one rate()
            # over <= 8 buckets).
            if self._serve_floor > Rung.FULL:
                self._reeval_serve_floor_locked(self.clock())
            return self._effective()

    def _effective(self) -> Rung:
        return Rung(max(self._level, self._blackout_floor,
                        self._serve_floor))

    def report(self) -> dict:
        with self._lock:
            err, n = self._serve_window.rate(self.clock())
            return {
                "rung": int(self._effective()),
                "rung_name": self._effective().name,
                "level": int(self._level),
                "blackout_floor": int(self._blackout_floor),
                "serve_floor": int(self._serve_floor),
                "serve_error_rate": err,
                "serve_samples": n,
                "error_streak": self._err_streak,
                "since_s": max(self.clock() - self._changed_at, 0.0),
            }

    # -- feeds -------------------------------------------------------------

    def _set(self, level: Optional[Rung] = None,
             floor: Optional[Rung] = None,
             serve_floor: Optional[Rung] = None) -> None:
        """Caller holds the lock. Records transitions of the EFFECTIVE
        rung and fires on_change for them."""
        before = self._effective()
        if level is not None:
            self._level = level
        if floor is not None:
            self._blackout_floor = floor
        if serve_floor is not None:
            self._serve_floor = serve_floor
        after = self._effective()
        if after != before:
            self._changed_at = self.clock()
            self.transitions.append((self._changed_at, int(after)))
            if self.on_change is not None:
                self.on_change(int(after))

    def note_dispatch_error(self) -> None:
        """A device dispatch/materialize failure (full path only)."""
        with self._lock:
            self._ok_streak = 0
            self._err_streak += 1
            if (self._err_streak >= self.cfg.dispatch_error_streak
                    and self._level < Rung.STATIC):
                self._err_streak = 0
                self._set(level=Rung(self._level + 1))

    def note_dispatch_ok(self, latency_s: float = 0.0) -> None:
        """A successful full-path wave (steady state or probe)."""
        cfg = self.cfg
        with self._lock:
            self._err_streak = 0
            if latency_s > cfg.latency_breach_s:
                # A breaching wave is NOT a recovery signal: counting it
                # toward the ascent streak would let a consistently-slow
                # device climb back to FULL, route the pool through the
                # breached path until the slow streak demotes it again,
                # and oscillate forever — the exact flap the hysteresis
                # exists to prevent. Slow probes keep the ladder down.
                self._ok_streak = 0
                self._slow_streak += 1
                if (self._slow_streak >= cfg.latency_breach_streak
                        and self._level < Rung.CACHED):
                    # Sustained pick-latency breach: the full path is
                    # technically alive but violating its budget — the
                    # cached pick answers in microseconds instead.
                    self._slow_streak = 0
                    self._set(level=Rung.CACHED)
                return
            self._slow_streak = 0
            if self._level == Rung.FULL:
                return
            self._ok_streak += 1
            if (self._ok_streak >= cfg.recover_streak
                    and self.clock() - self._changed_at >= cfg.min_dwell_s):
                self._ok_streak = 0
                self._set(level=Rung(self._level - 1))

    def note_metrics_staleness(self, stale_s: float) -> None:
        """Ingestion-side staleness (the scrape engine's own clocks).
        A blackout floors the ladder at ROUND_ROBIN — the cached rows
        CACHED picks from are exactly what went stale."""
        cfg = self.cfg
        with self._lock:
            if stale_s > cfg.blackout_stale_s:
                if self._blackout_floor < Rung.ROUND_ROBIN:
                    self._set(floor=Rung.ROUND_ROBIN)
            elif (self._blackout_floor > Rung.FULL
                  and stale_s < cfg.blackout_stale_s
                  * cfg.blackout_recover_fraction):
                self._set(floor=Rung.FULL)

    def note_serve_outcome(self, ok: bool) -> None:
        """One data-plane serve outcome (any endpoint): maintains the
        pool-wide sliding error rate and the serve floor it drives. A
        5xx/reset storm descends the ladder to ROUND_ROBIN even while
        every scrape looks healthy; recovery is hysteretic (rate must
        fall under serve_error_rate * blackout_recover_fraction) so a
        storm's trailing edge cannot flap the pool between regimes."""
        with self._lock:
            now = self.clock()
            self._serve_window.note(ok, now)
            self._reeval_serve_floor_locked(now)

    def _reeval_serve_floor_locked(self, now: float) -> None:
        cfg = self.cfg
        err, n = self._serve_window.rate(now)
        if n >= cfg.serve_min_samples and err >= cfg.serve_error_rate:
            if self._serve_floor < Rung.ROUND_ROBIN:
                self._set(serve_floor=Rung.ROUND_ROBIN)
        elif (self._serve_floor > Rung.FULL
              and (n == 0
                   or err < cfg.serve_error_rate
                   * cfg.blackout_recover_fraction)):
            self._set(serve_floor=Rung.FULL)

    def force_level(self, rung: Rung) -> None:
        """Pin the error-driven level (storm sweeps + tests): combined
        with a prohibitive recover_streak/probe_interval_s config this
        holds the pool on one rung so a sweep can measure THAT rung's
        policy (e.g. the CACHED kv-weight calibration in
        docs/RESILIENCE.md) instead of the transition dynamics."""
        with self._lock:
            self._ok_streak = 0
            self._set(level=Rung(rung))

    def should_probe(self) -> bool:
        """While degraded by LEVEL, let one wave through the full path
        every probe interval — its outcome is the ascent signal. A pure
        blackout floor is not probed here (the full path would still
        score on dark data); it lifts from the staleness feed."""
        with self._lock:
            if self._level == Rung.FULL:
                return False
            now = self.clock()
            if now - self._last_probe >= self.cfg.probe_interval_s:
                self._last_probe = now
                return True
            return False


class ResilienceState:
    """The bundle the runner threads through the stack: one breaker
    board (scrape engine writes, pick path reads), one ladder (batching
    collector drives), one staleness source (engine clocks), and the
    static-subset size for the bottom rung."""

    def __init__(
        self,
        board: Optional[BreakerBoard] = None,
        ladder: Optional[DegradationLadder] = None,
        staleness_fn: Optional[Callable[[], float]] = None,
        static_subset: int = 4,
        on_change: Optional[Callable[[int], None]] = None,
        ejector=None,
    ):
        self.board = board if board is not None else BreakerBoard()
        self.ladder = ladder if ladder is not None else DegradationLadder(
            on_change=on_change)
        if self.ladder.on_change is None and on_change is None:
            # Default observability: the ladder drives gie_degraded_mode
            # directly (runtime.metrics is import-light). Applies to a
            # caller-supplied ladder too — a ladder built from the
            # --ladder-* flags must not silently lose the gauge.
            from gie_tpu_torch.runtime import metrics as own_metrics

            self.ladder.on_change = (
                lambda r: own_metrics.DEGRADED_MODE.set(r))
        self.staleness_fn = staleness_fn
        self.static_subset = max(static_subset, 1)
        # Optional p99 serve-latency outlier ejector (resilience/
        # outlier.py, --outlier-ejection): fed latencies by the serve-
        # outcome path, evaluated here at wave cadence.
        self.ejector = ejector

    def observe(self) -> None:
        """Per-wave tick from the batching collector: fold the staleness
        clock into the ladder and run the outlier-ejection eval. Cheap
        (one callable + one lock each, and the ejector rate-limits its
        own eval) and wave-cadence, never request-cadence."""
        if self.staleness_fn is not None:
            try:
                self.ladder.note_metrics_staleness(float(self.staleness_fn()))
            except Exception:
                pass  # a broken staleness source must not fail picks
        if self.ejector is not None:
            try:
                ejected = self.ejector.evaluate(self.board)
                if ejected:
                    from gie_tpu_torch.runtime import metrics as own_metrics

                    own_metrics.OUTLIER_EJECTIONS.inc(len(ejected))
                    own_metrics.BREAKER_OPEN.set(self.board.open_count())
            except Exception:
                pass  # ejection is advisory: it must never fail picks

    def healthy(self) -> bool:
        """The health endpoint's 'resilience' sub-service predicate."""
        return (self.ladder.rung() == Rung.FULL
                and not self.board.has_open)

    def report(self) -> dict:
        return {
            **self.ladder.report(),
            "breakers": self.board.states(),
            "breakers_open": self.board.open_count(),
        }
