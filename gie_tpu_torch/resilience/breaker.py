"""Sliding-window counters (copy of BucketWindow and WindowedRate from
gie_tpu/resilience/breaker.py).

The fairness ledgers (fairness/budgets.py) count over these windows. The
circuit breakers that share them in the reference come with the
resilience slice of the port (ROADMAP.md, Queue 1).
"""

from __future__ import annotations


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
