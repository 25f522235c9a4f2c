"""Dynamic lock-order confirmer: the runtime half of the lock lint.

The static analyzer proves what the call graph CAN do; this records what
running code ACTUALLY does. A :class:`LockTracker` wraps chosen
``threading`` locks in-place (attribute swap — every ``with self._lock:``
site looks the lock up per use, so existing code needs no changes) and
keeps a per-thread stack of held locks. Each acquisition is checked
against the same ``lockorder.toml`` ranks the static layer enforces;
inversions are recorded, not raised, so one test run reports every
violation instead of dying on the first.

Used by tests/test_torch_lint_dynamic.py: build the real engine/store pair,
drive real traffic, then ``assert_consistent()`` — and assert the
expected nestings were OBSERVED, so the check cannot pass vacuously.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from gie_tpu_torch.lint import tomlmini
from gie_tpu_torch.lint.runner import DEFAULT_CONFIG


def default_ranks() -> dict[str, int]:
    return dict(tomlmini.load(DEFAULT_CONFIG).get("ranks", {}))


@dataclass
class OrderViolation:
    outer: str
    inner: str
    thread: str

    def render(self) -> str:
        return (f"{self.thread}: acquired {self.inner} while holding "
                f"{self.outer} (rank inversion)")


@dataclass
class LockTracker:
    ranks: dict = field(default_factory=default_ranks)

    def __post_init__(self):
        self._tls = threading.local()
        self._mu = threading.Lock()  # guards the two records below
        self.violations: list[OrderViolation] = []
        self._observed: set[tuple[str, str]] = set()

    # -- bookkeeping (called by TrackedLock) -------------------------------

    def _stack(self) -> list[str]:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def note_acquire(self, name: str) -> None:
        stack = self._stack()
        if stack:
            top = stack[-1]
            if top != name:
                with self._mu:
                    self._observed.add((top, name))
                r_top, r_new = self.ranks.get(top), self.ranks.get(name)
                if r_top is not None and r_new is not None \
                        and r_new <= r_top:
                    with self._mu:
                        self.violations.append(OrderViolation(
                            top, name, threading.current_thread().name))
        stack.append(name)

    def note_release(self, name: str) -> None:
        stack = self._stack()
        # Releases normally pop the top; an out-of-order release (legal
        # with bare acquire/release) removes the most recent entry.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    # -- instrumentation ---------------------------------------------------

    def wrap(self, obj, attr: str, name: str) -> "TrackedLock":
        """Swap ``obj.attr`` for a tracked proxy. ``name`` must be the
        lock's lockorder.toml address so ranks line up."""
        inner = getattr(obj, attr)
        if isinstance(inner, TrackedLock):  # idempotent
            return inner
        tracked = TrackedLock(inner, name, self)
        setattr(obj, attr, tracked)
        return tracked

    # -- assertions --------------------------------------------------------

    def observed(self) -> set[tuple[str, str]]:
        with self._mu:
            return set(self._observed)

    def assert_consistent(self) -> None:
        with self._mu:
            bad = list(self.violations)
        if bad:
            raise AssertionError(
                "lock-order inversions observed at runtime:\n"
                + "\n".join(v.render() for v in bad))


class TrackedLock:
    """Order-recording proxy around a Lock/RLock/Condition. Context
    manager and acquire/release are intercepted; everything else
    (wait/notify/locked/...) delegates to the wrapped object — a
    Condition's wait() releases and re-acquires internally without
    touching the recorded stack, which models held-ness as seen by the
    hierarchy (the waiter still logically owns the critical section)."""

    def __init__(self, inner, name: str, tracker: LockTracker):
        self._inner = inner
        self._name = name
        self._tracker = tracker

    def acquire(self, *a, **kw):
        got = self._inner.acquire(*a, **kw)
        if got:
            self._tracker.note_acquire(self._name)
        return got

    def release(self):
        self._tracker.note_release(self._name)
        return self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, item):
        return getattr(self._inner, item)
