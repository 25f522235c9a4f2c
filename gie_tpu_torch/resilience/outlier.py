"""(Copy of gie_tpu/resilience/outlier.py, imports rewritten to gie_tpu_torch.)

p99 serve-latency outlier ejection (docs/RESILIENCE.md).

A pod can be sick without ever failing: a throttled accelerator, a
neighbor saturating HBM bandwidth, a dying NIC — it serves 2xx at 5-10x
the pool's latency, the error breakers never trip, and the queue-based
scorers may even steer MORE traffic at it as its slow serves keep its
queue short. The ejector closes that gap with the Envoy
outlier-detection shape applied to latency:

  signal     per-endpoint serve latency (the same observation exported
             as gie_serve_latency_seconds and recorded per request by
             the flight recorder's serve_latency_ms) folded into a
             windowed fixed-bucket histogram per endpoint.
  decision   every eval interval, each endpoint's windowed quantile
             (default p99) is compared against the REST of the pool
             (its own samples excluded — an outlier must not be judged
             against a reference it contaminates): it breaches when it
             exceeds ``ratio`` x the rest's median AND the rest's own
             tail at the same quantile. The second guard is what keeps
             ordinary queueing tails safe — a healthy endpoint's p99
             sits ~10x above the pool median under Poisson bursts, but
             never above the REST's p99, because every peer has the
             same tail. Relative both ways, so a pool-wide slowdown
             (overload — everyone slow together) ejects nobody. (The
             dual of that robustness: a CORRELATED latency failure of a
             large pool fraction inflates the reference and is not
             ejected — that is overload/heterogeneity, the ladder's and
             capacity planning's territory, not outlier ejection's.)
  action     the endpoint's breaker is tripped OPEN on the SERVE plane
             (:meth:`BreakerBoard.trip`), so recovery reuses the
             serve-opened machinery: a dwell, then live traffic probes
             it HALF_OPEN and its own outcomes close or re-open it.

Hysteresis (the anti-flap contract tests/test_storm.py pins):

  * an endpoint must breach for ``breach_streak`` CONSECUTIVE evals
    before it is ejected — one slow wave is not an outlier;
  * both the endpoint and the pool need minimum sample counts — a
    quiet pool ejects nobody on noise;
  * a per-endpoint ``cooldown_s`` bounds re-ejection cadence;
  * at most ``max_eject_fraction`` of the pool may be quarantined by
    the ejector at once — latency ejection must never empty a pool
    (availability beats ejection, same rule as every other filter).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import numpy as np

from gie_tpu_torch.resilience.breaker import BreakerBoard, BreakerState
from gie_tpu_torch.runtime.clock import MONOTONIC


@dataclasses.dataclass(frozen=True)
class OutlierConfig:
    window_s: float = 30.0       # sliding latency window
    quantile: float = 0.99       # per-endpoint quantile compared
    ratio: float = 3.0           # breach when q > ratio * pool median
    min_samples: int = 20        # per-endpoint samples needed in window
    pool_min_samples: int = 50   # pool samples needed in window
    breach_streak: int = 3       # consecutive breaching evals to eject
    eval_interval_s: float = 1.0
    cooldown_s: float = 30.0     # min between ejections of one endpoint
    max_eject_fraction: float = 0.34
    floor_s: float = 0.010       # median floor: sub-10ms pools don't eject

    def __post_init__(self):
        if not (0.5 <= self.quantile < 1.0):
            raise ValueError("quantile must be in [0.5, 1)")
        if self.ratio <= 1.0:
            raise ValueError("ratio must be > 1 (q vs pool median)")
        if self.window_s <= 0 or self.eval_interval_s <= 0:
            raise ValueError("window/eval interval must be > 0")
        if self.min_samples < 1 or self.pool_min_samples < 1:
            raise ValueError("sample minima must be >= 1")
        if self.breach_streak < 1:
            raise ValueError("breach_streak must be >= 1")
        if not (0.0 < self.max_eject_fraction <= 1.0):
            raise ValueError("max_eject_fraction must be in (0, 1]")


# Log-spaced latency bucket edges, 1 ms .. ~120 s: the quantile precision
# an ejection RATIO test needs (adjacent edges differ ~29%), at O(1)
# memory per (endpoint, time-bucket) instead of per-sample storage.
_EDGES = np.geomspace(1e-3, 120.0, 46)


class _LatencyWindow:
    """Time-bucketed latency histogram: O(1) note, O(buckets) quantile.
    Not thread-safe; the ejector holds its own lock."""

    __slots__ = ("_bucket_s", "_buckets")
    _N_TIME = 8

    def __init__(self, window_s: float):
        self._bucket_s = window_s / self._N_TIME
        self._buckets: list = []  # [time_idx, counts ndarray], oldest first

    def _prune(self, now: float) -> None:
        floor = int(now / self._bucket_s) - self._N_TIME
        while self._buckets and self._buckets[0][0] <= floor:
            self._buckets.pop(0)

    def note(self, latency_s: float, now: float) -> None:
        self._prune(now)
        idx = int(now / self._bucket_s)
        if not self._buckets or self._buckets[-1][0] != idx:
            self._buckets.append([idx, np.zeros(len(_EDGES), np.int64)])
        b = int(np.searchsorted(_EDGES, max(latency_s, 0.0)))
        self._buckets[-1][1][min(b, len(_EDGES) - 1)] += 1

    def counts(self, now: float) -> np.ndarray:
        self._prune(now)
        if not self._buckets:
            return np.zeros(len(_EDGES), np.int64)
        return np.sum([c for _, c in self._buckets], axis=0)


def _quantile_from_counts(counts: np.ndarray, q: float) -> float:
    total = int(counts.sum())
    if total == 0:
        return 0.0
    rank = q * (total - 1)
    cum = np.cumsum(counts)
    i = int(np.searchsorted(cum, rank + 1))
    return float(_EDGES[min(i, len(_EDGES) - 1)])


class OutlierEjector:
    """Windowed per-endpoint serve-latency quantile vs pool median,
    tripping the breaker board's SERVE plane on sustained breaches.

    ``note`` is called from the serve-outcome path (request cadence, one
    leaf lock); ``evaluate`` from the wave-cadence resilience tick."""

    def __init__(self, cfg: Optional[OutlierConfig] = None,
                 clock: Callable[[], float] = MONOTONIC.now):
        self.cfg = cfg if cfg is not None else OutlierConfig()
        self.clock = clock
        self._lock = threading.Lock()
        self._windows: dict[int, _LatencyWindow] = {}
        self._streaks: dict[int, int] = {}
        self._last_eject: dict[int, float] = {}
        self._next_eval = 0.0
        # (t, slot, endpoint_q_s, pool_median_s) — the run's audit trail.
        self.ejections: list[tuple] = []

    def note(self, slot: int, latency_s: float) -> None:
        """One SUCCESSFUL serve's latency (errors already feed the error
        breaker; a fast local-reply 503 would drag the outlier's own
        quantile down exactly while it is sickest)."""
        now = self.clock()
        with self._lock:
            w = self._windows.get(slot)
            if w is None:
                w = self._windows[slot] = _LatencyWindow(self.cfg.window_s)
            w.note(latency_s, now)

    def drop(self, slot: int) -> None:
        """Endpoint evicted: its latency history must not outlive it
        (slot reuse would inherit the old pod's quantiles)."""
        with self._lock:
            self._windows.pop(slot, None)
            self._streaks.pop(slot, None)
            self._last_eject.pop(slot, None)

    def evaluate(self, board: BreakerBoard) -> list[int]:
        """One eval tick (rate-limited internally to eval_interval_s):
        returns the slots ejected THIS call. Trips ``board`` on the
        SERVE plane so recovery is the serve-opened dwell + live-traffic
        probe machinery."""
        cfg = self.cfg
        now = self.clock()
        with self._lock:
            if now < self._next_eval:
                return []
            self._next_eval = now + cfg.eval_interval_s
            per_slot = {s: w.counts(now) for s, w in self._windows.items()}
        pool_counts = (np.sum(list(per_slot.values()), axis=0)
                       if per_slot else np.zeros(len(_EDGES), np.int64))
        if int(pool_counts.sum()) < cfg.pool_min_samples:
            return []
        # Ejection budget: endpoints the ejector (or anything else)
        # already quarantined count against the fraction cap.
        already_open = sum(
            1 for s in per_slot
            if board.state(s) != BreakerState.CLOSED)
        budget = max(
            int(len(per_slot) * cfg.max_eject_fraction) - already_open, 0)
        ejected: list[int] = []
        with self._lock:
            for slot, counts in sorted(per_slot.items()):
                if board.state(slot) != BreakerState.CLOSED:
                    # Quarantined endpoints accrue no streak: their
                    # window is starving by design, and a stale streak
                    # must not insta-eject them the moment they heal.
                    self._streaks[slot] = 0
                    continue
                n = int(counts.sum())
                if n < cfg.min_samples:
                    self._streaks[slot] = 0
                    continue
                rest = pool_counts - counts
                if int(rest.sum()) < cfg.min_samples:
                    self._streaks[slot] = 0
                    continue  # no reference pool to be an outlier OF
                rest_median = max(
                    _quantile_from_counts(rest, 0.5), cfg.floor_s)
                rest_q = _quantile_from_counts(rest, cfg.quantile)
                q = _quantile_from_counts(counts, cfg.quantile)
                if q > cfg.ratio * rest_median and q > rest_q:
                    self._streaks[slot] = self._streaks.get(slot, 0) + 1
                else:
                    self._streaks[slot] = 0
                    continue
                if self._streaks[slot] < cfg.breach_streak:
                    continue
                if now - self._last_eject.get(slot, -1e18) < cfg.cooldown_s:
                    continue
                if len(ejected) >= budget:
                    break  # availability beats ejection
                self._streaks[slot] = 0
                self._last_eject[slot] = now
                self.ejections.append((now, slot, q, rest_median))
                ejected.append(slot)
        for slot in ejected:
            board.trip(slot)
        return ejected

    def report(self) -> dict:
        """/debugz-shaped summary (streaks, ejection history)."""
        with self._lock:
            return {
                "streaks": {str(s): v for s, v in self._streaks.items()
                            if v > 0},
                "tracked": sorted(self._windows),
                "ejections": [
                    {"t": round(t, 3), "slot": s,
                     "endpoint_q_s": round(q, 4),
                     "pool_median_s": round(m, 4)}
                    for t, s, q, m in self.ejections[-50:]],
            }
