"""The shared jittered-backoff/retry policy.

Before this module, three subsystems hand-rolled the same exponential
backoff with three subtly different shapes (replication follower:
double-from-base, jitter strictly upward from a seeded RNG; scrape
engine: streak-exponent with a capped exponent and symmetric jitter;
autoscale: none — a failed patch retried at full cadence forever). One
implementation now covers all of them; the parity tests in
tests/test_resilience.py pin the migrated call sites to the exact delay
sequences the hand-rolled code produced.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional

from gie_tpu_torch.runtime.clock import MONOTONIC

JITTER_UP = "up"               # delay * (1 + jitter * rng.random())
JITTER_SYMMETRIC = "symmetric"  # delay * (1 + uniform(-jitter, +jitter))


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """``base_s`` is both the healthy cadence and the first failure's
    pre-doubling base; delays grow ``base * factor**streak`` capped at
    ``max_s``. ``max_exponent`` bounds the exponent so a streak counter
    left running for hours cannot overflow the float (the streak itself
    keeps counting — it is an observability signal). ``base_s`` may be
    exactly 0: every delay collapses to 0 (the in-memory test
    transports' poll-immediately mode, which the hand-rolled follower
    backoff also honored)."""

    base_s: float
    max_s: float
    factor: float = 2.0
    jitter: float = 0.25
    jitter_mode: str = JITTER_UP
    max_exponent: int = 20

    def __post_init__(self):
        if self.base_s < 0 or self.max_s < self.base_s:
            raise ValueError("need 0 <= base_s <= max_s")
        if self.jitter < 0 or self.factor <= 1.0:
            raise ValueError("need jitter >= 0 and factor > 1")
        if self.jitter_mode not in (JITTER_UP, JITTER_SYMMETRIC):
            raise ValueError(f"unknown jitter_mode {self.jitter_mode!r}")


class Backoff:
    """One failure-streak state machine. ``fail()``/``ok()`` return the
    next jittered delay; callers own the clock (some sleep, some feed a
    deadline heap, some just gate a poll timestamp)."""

    __slots__ = ("policy", "rng", "failures")

    def __init__(self, policy: BackoffPolicy, rng=None,
                 seed: Optional[int] = None):
        self.policy = policy
        # Default to the module-level random functions (the scrape
        # engine's historical source); a seeded Random keeps a subsystem
        # deterministic (the follower's historical source).
        self.rng = rng if rng is not None else (
            random.Random(seed) if seed is not None else random)
        self.failures = 0

    def _jittered(self, delay: float) -> float:
        p = self.policy
        if p.jitter == 0.0:
            return delay
        if p.jitter_mode == JITTER_UP:
            return delay * (1.0 + p.jitter * self.rng.random())
        return delay * (1.0 + self.rng.uniform(-p.jitter, p.jitter))

    def raw_delay(self) -> float:
        """Current un-jittered delay for this streak."""
        p = self.policy
        if self.failures == 0:
            return p.base_s
        exponent = min(self.failures, p.max_exponent)
        return min(p.base_s * (p.factor ** exponent), p.max_s)

    def fail(self) -> float:
        self.failures += 1
        return self._jittered(self.raw_delay())

    def ok(self) -> float:
        self.failures = 0
        return self._jittered(self.policy.base_s)

    def reset(self) -> None:
        self.failures = 0


def retry_call(
    fn: Callable,
    policy: BackoffPolicy,
    *,
    attempts: int = 3,
    retry_on: tuple = (Exception,),
    sleep: Callable[[float], None] = MONOTONIC.sleep,
    seed: Optional[int] = None,
):
    """Call ``fn`` up to ``attempts`` times with policy-shaped sleeps
    between failures; the last failure propagates. For one-shot control
    operations (a kube patch), not for daemon loops — loops own their
    cadence and use :class:`Backoff` directly."""
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    backoff = Backoff(policy, seed=seed)
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on:
            if attempt == attempts - 1:
                raise
            sleep(backoff.fail())
    raise AssertionError("unreachable")
