"""(Copy of gie_tpu/runtime/clock.py, imports rewritten to gie_tpu_torch.)

The Clock seam: one time authority for every clock-governed path
(docs/STORM.md "virtual clock").

Every subsystem whose BEHAVIOR depends on time — breaker dwells, ladder
probe cadence, outlier windows, deadline budgets, backoff pacing, the
scrape engine's shard heaps, the autoscale loop, the federation
staleness clocks, and the storm engine's whole timeline — reads time
and blocks through a :class:`Clock` instead of calling ``time`` /
``threading`` primitives directly (lint rule GC001 enforces this for
the storm/resilience/metricsio/autoscale/federation packages).
Observability timestamps (trace events, bench numbers, flight-record
``ts`` fields) deliberately stay on the real clock: they describe when
something happened in the world, not when the simulation said it did.

Two implementations:

:class:`MonotonicClock` (the module singleton :data:`MONOTONIC`) is a
thin passthrough — ``now`` is ``time.monotonic``, ``sleep`` is
``time.sleep``, the wait/notify surface maps 1:1 onto the underlying
``threading`` primitive. Production behavior is bit-identical to the
pre-seam code.

:class:`VirtualClock` is a deterministic discrete-event clock for the
gie-twin digital twin (ROADMAP item 6): time is a number that advances
only when every REGISTERED ACTOR is parked in a clock primitive. The
rules that make a multi-threaded simulation deterministic:

  * an *actor* is a thread registered via :meth:`actor_begin` /
    :meth:`actor_thread`; unregistered threads that park are counted as
    ephemeral actors for the duration of the park (warmup helpers,
    teardown), never between parks;
  * ``sleep``/``wait``/``wait_event`` PARK the calling actor: a heap
    entry records its virtual deadline (untimed condition waits have
    none — they wake only by notification);
  * ``notify``/``set_event`` never wake a waiter directly: they move
    its entry to the READY queue *at the current virtual instant* and
    the waiter stays parked until the clock fires it;
  * when the last actor parks, the clock fires exactly ONE entry —
    READY entries first (FIFO: notification order), then the earliest
    heap deadline (advancing ``now`` to it; ties break by registration
    sequence). The fired actor runs to its next park before anything
    else is woken, so execution is a serialized run-to-completion
    schedule and two same-seed runs replay the identical interleaving
    (the storm scorecard's ``decision_fingerprint`` pins this).

The actual wake actions (``Event.set`` / ``Condition.notify_all``) run
on a dedicated non-actor waker thread so the advancing thread never
acquires another actor's condition lock while holding the clock lock.

Lock order: an actor may call into the clock while holding the
condition it waits on/notifies, so ``VirtualClock._lock`` ranks below
every such condition in the declared hierarchy (lockorder.toml) and no
clock method takes any other lock while holding it.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Optional


class Clock:
    """The seam's surface. ``wait``/``notify`` take a
    ``threading.Condition`` whose lock the caller holds (the stdlib
    contract); ``wait_event``/``set_event`` take a ``threading.Event``.
    On the real clock every method is a passthrough; on the virtual
    clock they are the park/wake points the simulation is built from."""

    is_virtual = False

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def wait(self, cond, timeout: Optional[float] = None) -> bool:
        raise NotImplementedError

    def notify(self, cond) -> None:
        raise NotImplementedError

    def notify_all(self, cond) -> None:
        raise NotImplementedError

    def wait_event(self, event, timeout: Optional[float] = None) -> bool:
        raise NotImplementedError

    def set_event(self, event) -> None:
        raise NotImplementedError

    # -- actor registration (no-ops on the real clock) ---------------------

    def actor_begin(self, name: str = ""):
        """Register the CURRENT thread as an actor; returns a token for
        :meth:`actor_end`."""
        return None

    def actor_end(self, token) -> None:
        pass

    def actor_thread(self, target, name: Optional[str] = None,
                     args: tuple = ()) -> threading.Thread:
        """An unstarted daemon thread pre-registered as an actor (the
        registration counts from NOW, so the clock cannot advance past
        work the spawner just scheduled)."""
        return threading.Thread(target=target, name=name, args=args,
                                daemon=True)


class MonotonicClock(Clock):
    """Production clock: a thin ``time.monotonic`` passthrough."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)

    def wait(self, cond, timeout: Optional[float] = None) -> bool:
        return cond.wait(timeout)

    def notify(self, cond) -> None:
        cond.notify()

    def notify_all(self, cond) -> None:
        cond.notify_all()

    def wait_event(self, event, timeout: Optional[float] = None) -> bool:
        return event.wait(timeout)

    def set_event(self, event) -> None:
        event.set()


MONOTONIC = MonotonicClock()

# Wall-clock callable for subsystems whose historical convention is
# epoch-seconds stamps (MetricsStore rows, the autoscale signal
# windows). A virtual-time harness swaps in its own callable; what
# matters is that producers and consumers of one timestamp family share
# a single source — GC001 keeps direct ``time.time()`` calls out of the
# clock-governed packages so the swap point stays unique.
REALTIME = time.time


# _Entry states.
_PARKED = 0
_READY = 1
_FIRED = 2
_DONE = 3


class _Entry:
    """One parked actor's wake record."""

    __slots__ = ("kind", "cond", "watch", "wake", "deadline", "state",
                 "timed_out", "seq")

    def __init__(self, kind: str, cond=None, watch=None, wake=None):
        self.kind = kind          # "sleep" | "cond" | "evt"
        self.cond = cond          # the Condition a "cond" entry waits on
        self.watch = watch        # the Event an "evt" entry waits for
        self.wake = wake          # private Event for "sleep"/"evt" parks
        self.deadline: Optional[float] = None
        self.state = _PARKED
        self.timed_out = False
        self.seq = 0


class VirtualClock(Clock):
    """Deterministic event-heap clock (module docstring has the rules)."""

    is_virtual = True

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()
        self._seqs = itertools.count()
        self._actors = 0
        self._parked = 0
        self._heap: list[tuple[float, int, _Entry]] = []
        self._ready: deque[_Entry] = deque()
        # id(obj) -> (obj, [entries]) — the obj reference keeps the id
        # stable while entries exist.
        self._cond_waiters: dict[int, tuple] = {}
        self._evt_waiters: dict[int, tuple] = {}
        self._tl = threading.local()
        # Wake executor: a NON-actor daemon performing the real
        # Event.set / Condition.notify_all for fired entries, so the
        # thread that triggered an advance never takes another actor's
        # condition lock itself.
        self._fire_q: deque[_Entry] = deque()
        self._fire_wake = threading.Event()
        self._stopped = False
        self._waker = threading.Thread(
            target=self._waker_loop, name="virtual-clock-waker", daemon=True)
        self._waker.start()

    # -- introspection -----------------------------------------------------

    def now(self) -> float:
        return self._now

    def shutdown(self) -> None:
        """Stop the waker thread (engine teardown). Idempotent."""
        self._stopped = True
        self._fire_wake.set()

    # -- actor registry ----------------------------------------------------

    def actor_begin(self, name: str = ""):
        self._tl.actor = True
        with self._lock:
            self._actors += 1
        return name or "actor"

    def actor_end(self, token) -> None:
        self._tl.actor = False
        with self._lock:
            self._actors -= 1
            self._maybe_advance_locked()

    def actor_thread(self, target, name: Optional[str] = None,
                     args: tuple = ()) -> threading.Thread:
        with self._lock:
            self._actors += 1

        def run():
            self._tl.actor = True
            try:
                target(*args)
            finally:
                self._tl.actor = False
                with self._lock:
                    self._actors -= 1
                    self._maybe_advance_locked()

        return threading.Thread(target=run, name=name, daemon=True)

    def _ephemeral_begin(self) -> bool:
        """Unregistered thread about to park: count it as an actor for
        the duration of the park only (warmup/teardown helpers must not
        stall the advance rule while blocked, and must not gate it while
        running)."""
        if getattr(self._tl, "actor", False):
            return False
        with self._lock:
            self._actors += 1
        return True

    def _ephemeral_end_locked(self) -> None:
        self._actors -= 1
        self._maybe_advance_locked()

    # -- the advance rule --------------------------------------------------

    def _maybe_advance_locked(self) -> None:
        """Fire exactly one entry once every registered actor is parked.
        Caller holds ``_lock``."""
        if self._actors <= 0 or self._parked < self._actors:
            return
        while self._ready:
            e = self._ready.popleft()
            if e.state == _READY:
                self._fire_locked(e)
                return
        while self._heap:
            deadline, _seq, e = self._heap[0]
            heapq.heappop(self._heap)
            if e.state != _PARKED:
                continue  # notified/fired since scheduling: lazy-dropped
            if deadline > self._now:
                self._now = deadline
            e.timed_out = True
            self._fire_locked(e)
            return
        # All actors parked with nothing scheduled and nothing ready:
        # the simulation is idle (pre-traffic construction, post-run
        # teardown). Progress resumes when an external thread posts
        # work; a genuine mid-run deadlock surfaces as the caller's own
        # bounded timeout (every daemon loop's waits are GR001-bounded).

    def _fire_locked(self, e: _Entry) -> None:
        e.state = _FIRED
        self._parked -= 1
        self._fire_q.append(e)
        self._fire_wake.set()

    def _waker_loop(self) -> None:
        while not self._stopped:
            self._fire_wake.wait(0.2)
            self._fire_wake.clear()
            while self._fire_q:
                e = self._fire_q.popleft()
                if e.kind == "cond":
                    with e.cond:
                        e.cond.notify_all()
                else:
                    e.wake.set()

    # -- parks -------------------------------------------------------------

    def sleep(self, seconds: float) -> None:
        eph = self._ephemeral_begin()
        e = _Entry("sleep", wake=threading.Event())
        with self._lock:
            e.seq = next(self._seqs)
            e.deadline = self._now + max(float(seconds), 0.0)
            heapq.heappush(self._heap, (e.deadline, e.seq, e))
            self._parked += 1
            self._maybe_advance_locked()
        e.wake.wait()
        with self._lock:
            e.state = _DONE
            if eph:
                self._ephemeral_end_locked()

    def wait(self, cond, timeout: Optional[float] = None) -> bool:
        """Park on ``cond`` (caller holds its lock, stdlib contract)
        until notified through the clock or the virtual timeout elapses.
        Returns False only on timeout."""
        eph = self._ephemeral_begin()
        e = _Entry("cond", cond=cond)
        with self._lock:
            e.seq = next(self._seqs)
            self._cond_waiters.setdefault(id(cond), (cond, []))[1].append(e)
            if timeout is not None:
                e.deadline = self._now + max(float(timeout), 0.0)
                heapq.heappush(self._heap, (e.deadline, e.seq, e))
            self._parked += 1
            self._maybe_advance_locked()
        # The check-then-wait is race-free because the caller holds the
        # condition's lock: the waker cannot notify until cond.wait()
        # releases it.
        while e.state in (_PARKED, _READY):
            cond.wait()
        with self._lock:
            e.state = _DONE
            pair = self._cond_waiters.get(id(cond))
            if pair is not None:
                try:
                    pair[1].remove(e)
                except ValueError:
                    pass
                if not pair[1]:
                    del self._cond_waiters[id(cond)]
            if eph:
                self._ephemeral_end_locked()
        return not e.timed_out

    def wait_event(self, event, timeout: Optional[float] = None) -> bool:
        if event.is_set():
            return True
        eph = self._ephemeral_begin()
        e = _Entry("evt", watch=event, wake=threading.Event())
        parked = False
        with self._lock:
            if event.is_set():  # set_event raced in under the clock lock
                if eph:
                    self._ephemeral_end_locked()
            else:
                e.seq = next(self._seqs)
                self._evt_waiters.setdefault(
                    id(event), (event, []))[1].append(e)
                if timeout is not None:
                    e.deadline = self._now + max(float(timeout), 0.0)
                    heapq.heappush(self._heap, (e.deadline, e.seq, e))
                self._parked += 1
                parked = True
                self._maybe_advance_locked()
        if not parked:
            return True
        e.wake.wait()
        with self._lock:
            e.state = _DONE
            pair = self._evt_waiters.get(id(event))
            if pair is not None:
                try:
                    pair[1].remove(e)
                except ValueError:
                    pass
                if not pair[1]:
                    del self._evt_waiters[id(event)]
            if eph:
                self._ephemeral_end_locked()
        return event.is_set()

    # -- wakes (defer to the advance rule; see module docstring) -----------

    def _ready_cond_locked(self, cond, limit: Optional[int] = None) -> None:
        pair = self._cond_waiters.get(id(cond))
        if pair is None:
            return
        n = 0
        for e in pair[1]:
            if e.state == _PARKED:
                e.state = _READY
                self._ready.append(e)
                n += 1
                if limit is not None and n >= limit:
                    break

    def notify(self, cond) -> None:
        with self._lock:
            self._ready_cond_locked(cond, limit=1)
            self._maybe_advance_locked()
        # Real notify too: a non-clock waiter on the same condition (or
        # a clock waiter re-checking its state) must not be stranded.
        cond.notify_all()

    def notify_all(self, cond) -> None:
        with self._lock:
            self._ready_cond_locked(cond)
            self._maybe_advance_locked()
        cond.notify_all()

    def set_event(self, event) -> None:
        with self._lock:
            event.set()
            pair = self._evt_waiters.get(id(event))
            if pair is not None:
                for e in pair[1]:
                    if e.state == _PARKED:
                        e.state = _READY
                        self._ready.append(e)
            self._maybe_advance_locked()
