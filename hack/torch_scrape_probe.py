#!/usr/bin/env python3
"""chip_smoke.py's phase 6 (the ext-proc server under 1024-stream bursts)
under a lock, GIL and transport watch, to name what stalls the server and
what cancels its streams.

    python3 hack/torch_scrape_probe.py [--after-phases] [--repeat R]
        [--call-watch] [--inject-hold S] [--out PREFIX]
    python3 hack/torch_scrape_probe.py --selftest --out PREFIX
    python3 hack/torch_scrape_probe.py --grpc-unrequested [--hold S]

Runs chip_smoke.phase_server for both configurations R times in a child
process, after building
the kernels (and, with --after-phases, after chip_smoke's phases 2-5, as
main() runs them first), and watches it two ways:

  in the child   the scrape engine's, metrics store's, breaker board's and
                 scheduler's locks are wrapped to record their owner; a
                 ticker thread does nothing but tick every 0.1 s: a tick
                 late by over STALL_S is a stall (no thread could hand
                 it the GIL); a watchdog thread, when one of those locks
                 has been held for over STALL_S, writes the owner's
                 Python stack and those of the threads that are no gRPC
                 handler to PREFIX.locks.txt. Every scrape that fails or takes over 0.5 s is
                 kept, with the staleness the ladder's blackout floor
                 reads (sampled every 50 ms);
                 with --call-watch every thread that is no gRPC handler
                 runs under a profile hook
                 (threading.setprofile_all_threads) that keeps its last
                 call event (kind, callee, monotonic time, frame); a
                 thread silent for over GAP_S goes into a preallocated
                 ring with the call it sat in, and after each stall a
                 reporter thread writes to PREFIX.calls.txt the silences
                 that cover it, calls that may keep the GIL first: a
                 thread silent in such a call across the whole stall
                 held the GIL through it;
                 torch.cuda.set_sync_debug_mode("warn") during the phase
                 runs: each synchronising call counted by thread and call
                 site (stacks in PREFIX.syncs.txt), with the CUDA and
                 pinned-host allocators' counters before and after;
                 every stream's hand-over by its acceptor's poller to
                 the handler pool and its handler's entry, with the
                 stream's id read from its body frame, against each
                 client's send and end of the same stream (the client
                 processes run chip_smoke.client_process with aio_stream
                 timed), PREFIX.streams.<run>.json: how long each call
                 waited to be taken up, per round; and each wave's steps
                 (the dispatcher's batch, pick_async, the queued
                 complete() calls' apply, materialize, the completer's
                 fan-out) timed, PREFIX.streams.<run>.waves.json;
  in the parent  /proc of the child, every 0.5 s: each thread's state,
                 CPU ticks and the syscall it sits in. When the ticker's
                 heartbeat is older than STALL_S it writes each thread's
                 name, the CPU it took during the stall and its syscall
                 to PREFIX.gil.txt, with the CPU each other process
                 descended from the child (the stub fleet, the clients)
                 and the machine as a whole took over the same window:
                 threads of the child that ran mean the watchdog was only
                 starved; none, with CPU elsewhere, a server that was not
                 scheduled; none anywhere, a blocking call with the GIL
                 held; and every 0.5 s, to PREFIX.cpu.jsonl, the CPU each
                 thread group of the child (scrape shards, gRPC pollers,
                 handlers, dispatcher, completer, gRPC core) and each
                 other process took: who holds the GIL during a burst;
                 and a byte echoed every 0.1 s over loopback TCP and over
                 a UNIX socket pair, each round trip over 0.2 s written
                 to PREFIX.net.jsonl: a stall of the network stack shows
                 on TCP alone; beside them, on threads of their own, a
                 read of /proc/self/stat, of the server's stat and its
                 main thread's, of each other descendant's stat, a thread
                 started and joined and a page mapped and unmapped, every
                 0.1 s, each over 0.2 s written there too: a stall that
                 blocks the reads of the server alone is a lock of its
                 address space, one that blocks every /proc read and the
                 thread start is the sandbox's task table; and, every
                 0.1 s to PREFIX.mm.jsonl, readings that never touch the
                 server's mm, each source read on a thread of its own and
                 timed (a read over 0.2 s is written with its path, so the
                 path that blocks names itself): /proc/vmstat deltas
                 (compact_stall, compact_fail, thp_fault_alloc,
                 thp_fault_fallback, allocstall_*, pgmajfault), the
                 pressure stall lines of /proc/pressure/{cpu,memory,io},
                 the cgroup's cpu.stat (nr_throttled, throttled_usec) and
                 memory.events (high, max) deltas, and each server
                 thread's state field and wchan (from
                 /proc/<pid>/task/<tid>/stat and wchan), counted by state
                 and by wchan; once, at the start, the transparent huge
                 page settings (enabled, defrag), nproc and the cgroup's
                 cpu.max and memory.max (PREFIX.mm.jsonl's first line and
                 the standard output).

--inject-hold S holds the server's GIL S seconds in a blocking C call 1 s
into each run's first measured burst: a stand-in for a stall, to show
what a stall does to the streams that arrive during it.

--grpc-unrequested asks gRPC core, under the installed grpcio, whether it
cancels calls that the server has not taken up in time: a server whose
main thread holds the GIL for --hold seconds in a blocking C call while a
client opens a stream every 0.5 s (with the acceptors' options, then with
grpc.server_max_unrequested_time_in_server at 5 s), and a server whose
GIL is free but whose one handler thread is busy for --hold seconds. It
prints each variant's statuses and how long the streams waited.

Prints one JSON line per phase run (configuration, passed or the
error) and a summary line with the stalls. Needs the card,
as chip_smoke.py does; --selftest checks the watch on the CPU (a lock
held 3 s, the GIL held by a backtracking regular expression, then by a
thread blocked in a C call).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STALL_S = 2.0
GAP_S = 1.0                # a watched thread silent this long is recorded
RING = 4096


# -- child: phase 6 with its locks watched -----------------------------------

class OwnedLock:
    """A threading.Lock that records which thread holds it since when."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.owner = None
        self.since = 0.0

    def acquire(self, blocking=True, timeout=-1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            self.owner, self.since = threading.get_ident(), time.monotonic()
        return got

    def release(self):
        self.owner = None
        self._lock.release()

    def locked(self):
        return self._lock.locked()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()


LOCKS: list = []


def _wrap_init(cls, attrs, label):
    init = cls.__init__

    def wrapped(self, *args, **kwargs):
        init(self, *args, **kwargs)
        for attr in attrs:
            lock = OwnedLock(f"{label}.{attr}")
            setattr(self, attr, lock)
            LOCKS.append(lock)

    cls.__init__ = wrapped


class CallWatch:
    """Each watched thread's last profile event, and a preallocated ring of
    the silences between two events of one thread longer than GAP_S.

    A silence is the time a thread spent inside one call (a C call when
    the event before it is 'c_call'): blocked with the GIL released, or
    holding it. The thread whose silence ends first after a stall, and
    began before it, is the one that held the GIL: while it holds it no
    other thread can post an event."""

    def __init__(self, skip=("extproc-w", "probe-")):
        self.skip = skip
        self.last: dict = {}
        self.ring: list = [None] * RING
        self.n = 0

    def hook(self):
        mono, ident_of, gap = time.monotonic, threading.get_ident, GAP_S
        last, ring, skip, size = self.last, self.ring, self.skip, RING

        def profile(frame, event, arg):
            ident = ident_of()
            now = mono()
            slot = last.get(ident)
            if slot is None:
                name = threading.current_thread().name
                if name.startswith(skip):
                    sys.setprofile(None)
                    return
                last[ident] = [event, arg, now, frame, name]
                return
            if now - slot[2] > gap:
                i = self.n
                self.n = i + 1
                ring[i % size] = (slot[4], slot[0], _callee(slot[1]),
                                  slot[2], now,
                                  traceback.extract_stack(slot[3], limit=14))
            slot[0], slot[1], slot[2], slot[3] = event, arg, now, frame

        return profile

    def spanning(self, onset: float, end: float) -> list:
        """Silences that cover the stall, the first to end first; then
        threads still silent since it began. The ticker's last tick
        before a stall (`onset`) may come up to one tick before the call
        that stalled began, so a silence counts from onset + 2 ticks."""
        start, stop = onset + 0.2, end - 0.2
        done = [r for r in self.ring[:min(self.n, RING)]
                if r is not None and r[3] <= start and r[4] >= stop]
        done.sort(key=lambda r: r[4])
        live = sys._current_frames()
        open_ = [(s[4], s[0], _callee(s[1]), s[2], None,
                  traceback.extract_stack(s[3], limit=14))
                 for ident, s in list(self.last.items())
                 if ident in live and s[2] <= start]
        return done + sorted(open_, key=lambda r: r[3])


def _callee(arg) -> str:
    if arg is None:
        return ""
    mod = getattr(arg, "__module__", None) or type(
        getattr(arg, "__self__", None)).__name__
    return f"{mod}.{getattr(arg, '__qualname__', repr(arg)[:60])}"


# Calls that release the GIL while they wait: a silence in one of these is
# a thread parked, not a holder.
WAITS = ("acquire", "wait", "sleep", "select", "poll", "recv", "recv_into",
         "accept", "get", "join", "read", "readinto", "_wait_for_tstate_lock",
         "next_event", "synchronize")


def _calls_report(watch, onset, end) -> str:
    """The silences that cover a stall, calls that keep the GIL first. A
    holder loses the GIL at its first check after its C call returns,
    which may come before its next profile event, so the waits that
    cover the stall may end a hair earlier than the holder's call."""
    rows = watch.spanning(onset, end)
    held = [r for r in rows if r[2].rsplit(".", 1)[-1] not in WAITS][:30]
    parked = [r for r in rows if r[2].rsplit(".", 1)[-1] in WAITS][:30]
    lines = [f"== stall {onset:.3f} -> {end:.3f} ({end - onset:.3f} s): "
             f"{len(held)} watched threads silent across it in a call that "
             f"may keep the GIL, {len(parked)} parked in a wait\n"]
    for k, (name, kind, callee, t0, t1, stack) in enumerate(held + parked):
        tag = ("HOLDER? " if k < len(held) else "parked ") + (
            "FIRST " if k == 0 else "")
        lines.append(
            f"-- {tag}{name}: {kind} {callee or '(a call the hook cannot '
            'see: ctypes, pybind11 method)'} from {t0:.3f} "
            f"({t0 - onset:+.3f} s from the onset) to "
            f"{'(still in it)' if t1 is None else f'{t1:.3f}'}\n")
        lines.extend("   " + ln for ln in traceback.format_list(stack)[-8:])
    return "".join(lines)


class SyncLog:
    """torch.cuda.set_sync_debug_mode("warn")'s warnings counted by thread
    (its name less the pool index) and call site, the first stack kept."""

    def __init__(self):
        self.counts: collections.Counter = collections.Counter()
        self.stacks: dict = {}

    def install(self):
        import warnings

        warnings.filterwarnings("always", message=".*synchroniz")
        shown = warnings.showwarning

        def showwarning(message, category, filename, lineno, file=None,
                        line=None):
            if "synchroniz" not in str(message):
                return shown(message, category, filename, lineno, file, line)
            name = threading.current_thread().name.rsplit("_", 1)[0]
            key = f"{name} @ {os.path.relpath(filename, ROOT)}:{lineno}"
            self.counts[key] += 1
            if key not in self.stacks:
                self.stacks[key] = "".join(traceback.format_stack(
                    sys._getframe(1), limit=8))

        warnings.showwarning = showwarning

    def take(self) -> dict:
        out = dict(self.counts.most_common(20))
        self.counts.clear()
        return out


def _allocator_counts() -> dict:
    """The CUDA caching allocator's and the pinned-host allocator's
    counters that a synchronising allocation or free moves."""
    import torch

    dev = torch.cuda.memory_stats()
    out = {k: dev.get(k, 0) for k in (
        "num_alloc_retries", "num_ooms", "num_sync_all_streams",
        "num_device_alloc", "num_device_free",
        "reserved_bytes.all.current")}
    host = getattr(torch.cuda, "host_memory_stats", None)
    if host is not None:
        for k, v in host().items():
            if isinstance(v, (int, float)) and ("alloc" in k or "free" in k):
                out[f"host.{k}"] = v
    return out


_POOL = threading.local()


def _stamp_submits() -> None:
    """Each task a gRPC acceptor's poller hands its handler pool carries
    the time it was handed over: the poller took the call up then (it
    matches one new call per turn of its loop, under the GIL)."""
    from concurrent import futures

    submit = futures.ThreadPoolExecutor.submit

    def stamped(self, fn, /, *args, **kwargs):
        if not self._thread_name_prefix.startswith("extproc-w"):
            return submit(self, fn, *args, **kwargs)
        t = time.monotonic()

        def run(*a, **k):
            _POOL.submitted = t
            return fn(*a, **k)

        return submit(self, run, *args, **kwargs)

    futures.ThreadPoolExecutor.submit = stamped


def _stamp_handlers(service, entries: list):
    """Wrap the ext-proc service's handler factories so that each stream
    appends [poller hand-over time, handler entry time, stream id] to
    `entries`, the id read from the body frame's prompt ("user question
    <id>")."""
    import re

    find = re.compile(rb"user question (-?\d+)")

    def stamped(make):
        def factory(server, on_accept=None):
            inner = make(server, on_accept)

            def process(request_iterator, context):
                rec = [getattr(_POOL, "submitted", None), time.monotonic(),
                       None]
                entries.append(rec)

                def frames():
                    for f in request_iterator:
                        if rec[2] is None:
                            raw = (f if isinstance(f, (bytes, bytearray))
                                   else f.SerializeToString())
                            m = find.search(raw)
                            if m:
                                rec[2] = int(m.group(1))
                        yield f

                return inner(frames(), context)

            return process

        return factory

    service._wire_process_handler = stamped(service._wire_process_handler)
    service._process_handler = stamped(service._process_handler)


def probe_client_process(*args) -> None:
    """chip_smoke.client_process with aio_stream timed: appends (round,
    stream, send, end, status, details) per stream to the file named by
    $PROBE_STREAMS plus this client's share."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    rows = []
    one = chip_smoke.aio_stream

    async def timed(method, w, i):
        t0 = time.monotonic()
        try:
            r = await one(method, w, i)
        except Exception as e:
            code = getattr(e, "code", None)
            rows.append((w, i, t0, time.monotonic(),
                         str(code()) if callable(code) else type(e).__name__,
                         (e.details() if hasattr(e, "details")
                          else repr(e))[:200]))
            raise
        rows.append((w, i, t0, time.monotonic(), "OK", round(r[1], 4)))
        return r

    chip_smoke.aio_stream = timed
    try:
        chip_smoke.client_process(*args)
    finally:
        with open(f"{os.environ['PROBE_STREAMS']}.c{args[3]}.json", "w") as f:
            json.dump(rows, f)


WAVE_STEPS = (("dispatch", "gie_tpu_torch.sched.batching",
               "BatchingTPUPicker", "_run_batch"),
              ("pick_async", "gie_tpu_torch.sched.profile", "Scheduler",
               "pick_async"),
              ("apply_queued", "gie_tpu_torch.sched.profile", "Scheduler",
               "_apply_queued"),
              ("materialize", "gie_tpu_torch.sched.profile", "PendingWave",
               "materialize"),
              ("complete_wave", "gie_tpu_torch.sched.batching",
               "BatchingTPUPicker", "_complete_wave"))


def _time_wave_steps(steps: dict) -> None:
    """Record (start, seconds) of every call of each step of a wave: the
    dispatcher's batch (assembly and pick_async), pick_async (graph
    replay and copies queued), the queued complete() calls' apply (inside
    pick_async, under the scheduler's lock), materialize (the wave's event
    waited on) and the completer's fan-out, into steps[name]."""
    import importlib

    for name, module, cls, attr in WAVE_STEPS:
        owner = getattr(importlib.import_module(module), cls)
        inner = getattr(owner, attr)
        steps[name] = []

        def timed(*a, _inner=inner, _out=steps[name], **k):
            t0 = time.monotonic()
            try:
                return _inner(*a, **k)
            finally:
                _out.append((round(t0, 3), round(time.monotonic() - t0, 4)))

        setattr(owner, attr, timed)


def _steps_summary(steps: dict, prefix: str) -> dict:
    with open(prefix + ".waves.json", "w") as f:
        json.dump(steps, f)
    return {name: {"n": len(v), "longest": sorted(v, key=lambda x: -x[1])[:4]}
            for name, v in steps.items()}


def _streams_summary(prefix: str, entries: list) -> dict:
    """Per stream id: the client's send against the poller's hand-over
    (how long the call waited to be taken up: gRPC core cancels one that
    waits too long) and the handler's entry (the handler pool's queue),
    each round's worst; for the failed streams, their status and how long
    they waited, and whether the poller ever took them up."""
    rows = []
    for k in range(8):
        try:
            with open(f"{prefix}.c{k}.json") as f:
                rows.extend(json.load(f))
        except OSError:
            continue
    seen = {sid: (sub, ent) for sub, ent, sid in entries if sid is not None}
    lag, pool = collections.defaultdict(list), collections.defaultdict(list)
    failed, failed_waits, failed_taken = collections.Counter(), [], 0
    for w, i, t0, t1, status, detail in rows:
        sid = i + 1024 * w
        if status != "OK":
            failed[f"w{w} {status}: {detail}"[:160]] += 1
            failed_waits.append(t1 - t0)
            failed_taken += sid in seen
        if sid in seen and seen[sid][0] is not None:
            lag[w].append(seen[sid][0] - t0)
            pool[w].append(seen[sid][1] - seen[sid][0])
    with open(prefix + ".json", "w") as f:
        json.dump({"client": rows, "entries": entries}, f)
    q = (lambda xs, p: round(sorted(xs)[min(len(xs) - 1, int(p * len(xs)))],
                             3) if xs else None)
    return {
        "streams": len(rows), "handler_entries": len(entries),
        "poller_lag_s": {w: [q(v, 0.5), q(v, 0.99), round(max(v), 3)]
                         for w, v in sorted(lag.items())},
        "pool_wait_s": {w: [q(v, 0.5), q(v, 0.99), round(max(v), 3)]
                        for w, v in sorted(pool.items())},
        "failed": dict(failed), "failed_taken_up": failed_taken,
        "failed_wait_s": [q(failed_waits, 0.0), q(failed_waits, 0.5),
                          max(failed_waits, default=None)]}


def _stack(frame) -> str:
    return "".join(traceback.format_stack(frame)) if frame else "  (gone)\n"


def _ticker(beat_path, stop, stalls: list) -> None:
    """Tick every 0.1 s, doing nothing else: the heartbeat file the parent
    reads, and a stall (a tick late by over STALL_S: this thread could
    not run, so no Python thread got the GIL to it) put on `stalls`."""
    prev = time.monotonic()
    while not stop.is_set():
        now = time.monotonic()
        if now - prev > STALL_S:
            stalls.append((prev, now))
        with open(beat_path, "w") as f:
            f.write(repr(now))
        prev = now
        time.sleep(0.1)


def _watchdog(names_path, locks_out, stop) -> None:
    """Every 0.1 s: the thread names for the parent, and the stacks of a
    watched lock's owner held over STALL_S. (No faulthandler dump: it
    prints at most 100 threads, the newest first, and a dump while the
    others run can crash the process.)"""
    dumped = set()
    last_names = 0.0
    while not stop.is_set():
        now = time.monotonic()
        if now - last_names > 1.0:
            last_names = now
            with open(names_path + ".tmp", "w") as f:
                json.dump({t.native_id: t.name for t in threading.enumerate()
                           if t.native_id is not None}, f)
            os.replace(names_path + ".tmp", names_path)
        for lock in list(LOCKS):
            owner, since = lock.owner, lock.since
            if owner is None or now - since < STALL_S:
                continue
            if (id(lock), since) in dumped:
                continue
            dumped.add((id(lock), since))
            frames = sys._current_frames()
            by_ident = {t.ident: t.name for t in threading.enumerate()}
            lines = [f"== {lock.name} held {now - since:.3f} s by "
                     f"{by_ident.get(owner, owner)} at {now:.3f}\n",
                     _stack(frames.get(owner))]
            for ident, name in by_ident.items():
                if ident == owner or name.startswith(
                        ("extproc-", "ThreadPoolExecutor")):
                    continue
                lines.append(f"-- {name}\n{_stack(frames.get(ident))}")
            locks_out.write("".join(lines))
            locks_out.flush()
        time.sleep(0.1)


def _reporter(stalls: list, watch, calls_out, stop) -> None:
    """Write the call watch's report of each stall once the ring has
    caught up (1 s after the stall ended)."""
    while not stop.is_set() or stalls:
        while stalls and time.monotonic() - stalls[0][1] > 1.0:
            calls_out.write(_calls_report(watch, *stalls.pop(0)))
            calls_out.flush()
        if stop.is_set():
            break
        time.sleep(0.2)


def child(args) -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch
    from gie_tpu_torch.metricsio import engine as scrape_engine
    from gie_tpu_torch.metricsio.store import MetricsStore
    from gie_tpu_torch.ops import build
    from gie_tpu_torch.ops.fused_sinkhorn import fused_sinkhorn_plan
    from gie_tpu_torch.ops.fused_topk import fused_blend_topk
    from gie_tpu_torch.resilience.breaker import BreakerBoard
    from gie_tpu_torch.runtime import runner as runner_mod
    from gie_tpu_torch.sched import ProfileConfig
    from gie_tpu_torch.sched.config import tuned_profile
    from gie_tpu_torch.sched.profile import Scheduler

    _wrap_init(scrape_engine.ScrapeEngine, ("_lock",), "scrape")
    _wrap_init(MetricsStore, ("_lock",), "store")
    _wrap_init(BreakerBoard, ("_lock",), "board")
    _wrap_init(Scheduler, ("_lock", "_warm_lock"), "scheduler")

    fetches, staleness, collections_ = [], [], []
    gc_start = {}

    def on_gc(phase, info):
        if phase == "start":
            gc_start["t"] = time.monotonic()
        elif time.monotonic() - gc_start.get("t", 0.0) > 0.05:
            collections_.append((round(gc_start["t"], 3), round(
                time.monotonic() - gc_start["t"], 3), info["generation"]))

    gc.callbacks.append(on_gc)
    scrape = scrape_engine.ScrapeEngine._scrape

    def timed_scrape(self, ep):
        t0, before = time.monotonic(), ep.last_success
        try:
            return scrape(self, ep)
        finally:
            dt = time.monotonic() - t0
            if ep.last_success == before or dt > 0.5:
                fetches.append(("fail" if ep.last_success == before
                                else "slow", round(t0, 3), round(dt, 3),
                                ep.url))

    scrape_engine.ScrapeEngine._scrape = timed_scrape
    start, stop_ = (runner_mod.ExtProcServerRunner.start,
                    runner_mod.ExtProcServerRunner.stop)
    sampling = threading.Event()

    def sampled_start(self, *a, **k):
        port = start(self, *a, **k)
        sampling.set()

        def sample():
            while sampling.is_set():
                staleness.append((round(time.monotonic(), 3),
                                  round(self.scraper.staleness_seconds(), 3)))
                time.sleep(0.05)

        threading.Thread(target=sample, name="probe-sampler",
                         daemon=True).start()
        return port

    def sampled_stop(self, *a, **k):
        sampling.clear()
        return stop_(self, *a, **k)

    runner_mod.ExtProcServerRunner.start = sampled_start
    runner_mod.ExtProcServerRunner.stop = sampled_stop

    stop = threading.Event()
    locks_out = open(args.out + ".locks.txt", "w")
    stalls: list = []
    threading.Thread(target=_ticker, name="probe-ticker", daemon=True,
                     args=(args.beat, stop, stalls)).start()
    threading.Thread(target=_watchdog, name="probe-watchdog", daemon=True,
                     args=(args.names, locks_out, stop)).start()
    watch = reporter = None
    if args.call_watch or args.selftest:
        calls_out = open(args.out + ".calls.txt", "w")
        watch = CallWatch()
        reporter = threading.Thread(
            target=_reporter, name="probe-reporter", daemon=True,
            args=(stalls, watch, calls_out, stop))
        reporter.start()
        threading.setprofile_all_threads(watch.hook())

    if args.selftest:
        # The harness itself, on the CPU: a store lock held 3 s, then the
        # GIL held ~3 s by a regular expression that backtracks.
        import re

        import ctypes

        store = MetricsStore()
        with store._lock:
            time.sleep(3.0)
        re.match(r"(a+)+$", "a" * 26 + "b")
        time.sleep(1.5)
        # A thread of its own blocks 3 s in a C call that keeps the GIL:
        # the calls report must name it first.
        holder = threading.Thread(target=ctypes.PyDLL(None).sleep,
                                  args=(3,), name="selftest-holder")
        holder.start()
        holder.join()
        time.sleep(2.0)
        stop.set()
        threading.setprofile_all_threads(None)
        reporter.join(10)
        calls_out.close()
        with open(args.out + ".calls.txt") as f:
            calls = f.read()
        ok = "HOLDER? FIRST selftest-holder" in calls
        print(json.dumps({"probe": "selftest", "holder_named_first": ok,
                          "ring_records": watch.n}), flush=True)
        return 0 if ok else 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.library()
    cfg, weights = tuned_profile()
    configs = [
        ("tuned+use_pallas_sinkhorn",
         dataclasses.replace(cfg, use_pallas_sinkhorn=True),
         weights, "fused_sinkhorn_plan"),
        ("topk+use_pallas_topk",
         ProfileConfig(picker="topk", use_pallas_topk=True), None,
         "fused_blend_topk")]
    kernels = {"fused_sinkhorn_plan": fused_sinkhorn_plan,
               "fused_blend_topk": fused_blend_topk}
    if args.after_phases:
        # The process as chip_smoke.main leaves it for phase 6: the
        # kernels checked, then phases 3-5 for both configurations.
        chip_smoke.phase_kernels(dev)
        for name, c, w, own in configs:
            chip_smoke.phase_slice(dev, name, c, w, kernels, own)
        for name, c, w, own in configs:
            chip_smoke.phase_picker(dev, name, c, w, kernels, own)
    from gie_tpu_torch.extproc import service

    if args.inject_hold:
        # A stand-in for a stall of the server: at each phase run's first
        # measured burst, its GIL is held inject_hold seconds in a
        # blocking C call, 1 s after the burst is released.
        import ctypes

        mark = chip_smoke.time_completer

        def held(picker):
            def hold():
                time.sleep(1.0)
                ctypes.PyDLL(None).sleep(int(args.inject_hold))

            threading.Thread(target=hold, name="probe-hold",
                             daemon=True).start()
            return mark(picker)

        chip_smoke.time_completer = held
    entries: list = []
    steps: dict = {}
    _stamp_submits()
    _stamp_handlers(service, entries)
    _time_wave_steps(steps)
    chip_smoke.client_process = probe_client_process
    syncs = SyncLog()
    syncs.install()
    torch.cuda.set_sync_debug_mode("warn")
    failed = 0
    runs = [(r, cfg) for r in range(args.repeat) for cfg in configs]
    for r, (name, c, w, own) in runs:
        del fetches[:], staleness[:], collections_[:], entries[:]
        for v in steps.values():
            del v[:]
        os.environ["PROBE_STREAMS"] = streams = (
            f"{args.out}.streams.r{r}.{name.split('+')[0]}")
        alloc0 = _allocator_counts()
        syncs.take()
        t0 = time.monotonic()
        error = None
        with tempfile.TemporaryDirectory() as tmp:
            try:
                chip_smoke.phase_server(dev, name, c, w, kernels, own, tmp)
            except Exception as e:
                error = repr(e)[:600]
                failed += 1
        alloc = _allocator_counts()
        print(json.dumps({
            "probe": "phase6", "repeat": r, "config": name,
            "passed": error is None, "error": error,
            "start": round(t0, 3), "seconds": time.monotonic() - t0,
            "failed_fetches": [f for f in fetches
                               if f[0] == "fail"][:10],
            "slowest_fetches": sorted(
                (f for f in fetches if f[0] == "slow"),
                key=lambda f: -f[2])[:10],
            "staleness_max": max(staleness, key=lambda s: s[1],
                                 default=None),
            "longest_collections": sorted(
                collections_, key=lambda c: -c[1])[:3],
            "gc_tracked_objects": len(gc.get_objects()),
            "syncs": syncs.take(),
            "allocator_delta": {k: alloc[k] - alloc0.get(k, 0)
                                for k in alloc if alloc[k] != alloc0.get(k)},
            "streams": _streams_summary(streams, list(entries)),
        "wave_steps": _steps_summary(steps, streams),
        }), flush=True)
    torch.cuda.set_sync_debug_mode(0)
    if watch is not None:
        threading.setprofile_all_threads(None)
    with open(args.out + ".syncs.txt", "w") as f:
        for key, stack in syncs.stacks.items():
            f.write(f"== {key}\n{stack}")
    stop.set()
    return 1 if failed else 0


# -- gRPC core's treatment of calls the poller has not requested -------------

_SLOW: list = []        # the pool variant's first stream sleeps this long


def _echo(request_iterator, context):
    if _SLOW:
        time.sleep(_SLOW.pop())     # releases the GIL; the pool's one
    for frame in request_iterator:  # worker is taken meanwhile
        yield frame


def _unrequested_server(port_q, hold_s, options, go, mode) -> None:
    import ctypes
    from concurrent import futures

    import grpc

    srv = grpc.server(futures.ThreadPoolExecutor(1 if mode == "pool" else 8),
                      options=options)
    srv.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "probe.Echo", {"Stream": grpc.stream_stream_rpc_method_handler(
            _echo)}),))
    port_q.put(srv.add_insecure_port("127.0.0.1:0"))
    srv.start()
    go.wait()
    if mode == "pool":
        _SLOW.append(hold_s)
        time.sleep(hold_s * 2 + 10)
    else:
        time.sleep(0.5)
        ctypes.PyDLL(None).sleep(int(hold_s))    # blocks, the GIL held
        time.sleep(hold_s / 2 + 5)
    srv.stop(0)


def grpc_unrequested(hold_s: float) -> int:
    """Streams opened every 0.5 s for hold_s + 5 s against a server whose
    GIL is held for hold_s: each one's status and seconds to its end."""
    import multiprocessing

    import grpc

    ctx = multiprocessing.get_context("spawn")
    acceptor = (("grpc.so_reuseport", 1),)
    for label, mode, options in (
            ("GIL held, acceptor options", "gil", acceptor),
            ("GIL held, max unrequested 5 s", "gil", acceptor + (
                ("grpc.server_max_unrequested_time_in_server", 5),)),
            ("GIL free, the handler pool's one worker busy", "pool",
             acceptor)):
        q, go = ctx.Queue(), ctx.Event()
        proc = ctx.Process(target=_unrequested_server,
                           args=(q, hold_s, options, go, mode), daemon=True)
        proc.start()
        port = q.get(timeout=60)
        chan = grpc.insecure_channel(f"127.0.0.1:{port}")
        method = chan.stream_stream("/probe.Echo/Stream")
        list(method(iter([b"warm"]), timeout=30))
        go.set()
        if mode == "pool":
            time.sleep(0.5)         # the slow stream takes the worker first
        out = []

        def one(i):
            time.sleep(i * 0.5)
            t0 = time.monotonic()
            try:
                list(method(iter([b"x"]), timeout=hold_s * 3))
                status = "OK"
            except grpc.RpcError as e:
                status = f"{e.code()}: {e.details()}"
            out.append((i, status, round(time.monotonic() - t0, 2)))

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(int(2 * hold_s) + 10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        chan.close()
        proc.join(hold_s + 30)
        by = collections.defaultdict(list)
        for i, status, waited in sorted(out):
            by[status].append(waited)
        print(json.dumps({"probe": "grpc-unrequested", "grpc": grpc.__version__,
                          "server": label, "hold_s": hold_s,
                          "by_status": {k: {"n": len(v), "wait_min_s": min(v),
                                            "wait_max_s": max(v)}
                                        for k, v in by.items()}}), flush=True)
    return 0


# -- parent: /proc of the child ----------------------------------------------

def _tasks(pid):
    out = {}
    base = f"/proc/{pid}/task"
    try:
        tids = os.listdir(base)
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"{base}/{tid}/stat") as f:
                stat = f.read()
            fields = stat[stat.rindex(")") + 2:].split()
            state, ticks = fields[0], int(fields[11]) + int(fields[12])
            try:
                with open(f"{base}/{tid}/syscall") as f:
                    sysc = f.read().strip()
            except OSError as e:
                sysc = f"unreadable: {e.strerror}"
            with open(f"{base}/{tid}/comm") as f:
                comm = f.read().strip()
            out[int(tid)] = (state, ticks, sysc, comm)
        except (OSError, ValueError, IndexError):
            continue
    return out


def _machine(root: int) -> dict:
    """CPU ticks of every process descended from `root` (the stub fleet
    and the clients), by pid, and the machine's busy and idle ticks."""
    parent, out = {}, {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            fields = stat[stat.rindex(")") + 2:].split()
            parent[int(name)] = (int(fields[1]), int(fields[11])
                                 + int(fields[12]),
                                 stat[stat.index("(") + 1:stat.rindex(")")])
        except (OSError, ValueError, IndexError):
            continue
    for pid, (ppid, ticks, comm) in parent.items():
        seen, p = 0, ppid
        while p in parent and p != root and seen < 8:
            p, seen = parent[p][0], seen + 1
        if p == root:
            out[pid] = (ticks, comm)
    try:
        with open("/proc/stat") as f:
            cpu = [int(x) for x in f.readline().split()[1:]]
        out["machine"] = (sum(cpu) - cpu[3] - cpu[4], cpu[3] + cpu[4])
    except (OSError, ValueError, IndexError):
        pass
    return out


def _machine_report(procs, onset) -> str:
    first = next((s for t, s in procs if t >= onset), procs[-1][1])
    last = procs[-1][1]
    lines = ["-- other processes and the machine over the same window\n"]
    for pid, val in sorted(last.items(), key=lambda kv: str(kv[0])):
        if pid == "machine":
            busy = val[0] - first.get(pid, val)[0]
            idle = val[1] - first.get(pid, val)[1]
            lines.append(f"machine: busy {busy} idle {idle} ticks "
                         f"(idle share {idle / max(1, busy + idle):.3f})\n")
        else:
            lines.append(f"{val[0] - first.get(pid, val)[0]:6d} pid {pid} "
                         f"{val[1]}\n")
    return "".join(lines)


def _gil_report(ring, names, onset, now) -> str:
    # CPU from the first sample in the stall to the newest; state and
    # syscall from the newest sample still inside it.
    first = next((s for t, s in ring if t >= onset), ring[-1][1])
    last = ring[-1][1]
    inside = ring[-2][1] if len(ring) > 1 else last
    rows = []
    for tid, (_, ticks, _, comm) in last.items():
        state, _, sysc, _ = inside.get(tid, ("?", 0, "?", ""))
        cpu = ticks - first.get(tid, (None, ticks))[1]
        rows.append((cpu, tid, state, sysc, names.get(str(tid), comm)))
    rows.sort(reverse=True)
    try:
        with open("/proc/loadavg") as f:
            load = f.read().strip()
    except OSError:
        load = "?"
    lines = [f"== heartbeat stale since {onset:.3f}, report at {now:.3f}: "
             f"{len(rows)} threads, loadavg {load}\n"
             "-- by CPU ticks during the stall\n"]
    for cpu, tid, state, sysc, name in rows[:25]:
        lines.append(f"{cpu:6d} {tid} {name} {state} {sysc}\n")
    groups = collections.defaultdict(list)
    for _, tid, state, sysc, name in rows:
        parts = sysc.split()
        key = (parts[0], parts[1]) if len(parts) > 1 else (sysc,)
        groups[key].append(name)
    lines.append("-- by syscall and first argument\n")
    for key, who in sorted(groups.items(), key=lambda kv: -len(kv[1])):
        lines.append(f"{len(who):5d} {' '.join(key)}: "
                     f"{', '.join(sorted(set(w.rsplit('_', 1)[0] for w in who)))[:400]}\n")
    return "".join(lines)


# Thread groups of the server process for the CPU timeline, by name.
GROUPS = (("scrape", "scrape-shard"), ("poller", "(_serve)"),
          ("handler", "extproc-w"), ("dispatcher", "(_loop)"),
          ("completer", "(_completer_loop)"), ("warm", "warm-lattice"),
          ("grpc_core", "event_engine"), ("grpc_core", "grpc_global"))


def _group(name: str) -> str:
    for group, mark in GROUPS:
        if mark in name:
            return group
    return "other"


def _timeline_row(prev, cur, names, t) -> dict:
    """CPU ticks (1/100 s) each thread group of the child and each other
    process took between two samples."""
    by = collections.Counter()
    for tid, (_, ticks, _, comm) in cur[0].items():
        before = prev[0].get(tid, (None, ticks))[1]
        by[_group(names.get(str(tid), comm))] += ticks - before
    others = {str(pid): val[0] - prev[1].get(pid, val)[0]
              for pid, val in cur[1].items() if pid != "machine"}
    return {"t": round(t, 2), "server": dict(by), "others": others}


def _pinger(kind: str, out, stop) -> None:
    """Echo one byte every 0.1 s over a loopback TCP connection or a UNIX
    socket pair, in the parent (no GIL shared with the server), and write
    each round trip over 0.2 s to `out`: a stall of the machine's network
    stack shows on TCP and not on the socket pair."""
    import socket

    if kind == "tcp":
        listener = socket.socket()
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        a = socket.create_connection(listener.getsockname())
        b, _ = listener.accept()
        listener.close()
        a.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        b.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    else:
        a, b = socket.socketpair()

    def echo():
        while True:
            data = b.recv(1)
            if not data:
                return
            b.sendall(data)

    threading.Thread(target=echo, daemon=True).start()
    while not stop.is_set():
        t0 = time.monotonic()
        a.sendall(b"x")
        a.recv(1)
        rtt = time.monotonic() - t0
        if rtt > 0.2:
            out.write(json.dumps({"kind": kind, "t": round(t0, 3),
                                  "rtt_s": round(rtt, 3)}) + "\n")
            out.flush()
        time.sleep(0.1)
    a.close()


def _timed_calls(kind: str, fn, out, stop) -> None:
    """Call `fn` every 0.1 s, in the parent, and write each call over
    0.2 s to `out` as the pingers do: which of the machine's paths a
    stall of the server blocks. /proc reads of the parent's own process,
    of the server and of its descendants (the stub fleet, the clients)
    tell a lock of the server's address space from a lock of the
    sandbox's task table; a thread started and joined, and a page mapped,
    touched and unmapped, tell those from the machine's CPU."""
    while not stop.is_set():
        t0 = time.monotonic()
        try:
            what = fn()
        except OSError as e:
            what = f"error: {e.strerror}"
        took = time.monotonic() - t0
        if took > 0.2:
            out.write(json.dumps({"kind": kind, "t": round(t0, 3),
                                  "rtt_s": round(took, 3),
                                  "what": what}) + "\n")
            out.flush()
        time.sleep(0.1)


def _path_checks(server: int, others: list) -> dict:
    """{kind: call} for _timed_calls; `others` holds the pids of the
    server's descendants, refreshed by the parent's loop."""
    import mmap

    def read(path):
        with open(path) as f:
            f.read()

    def read_others():
        slowest, worst = None, 0.0
        for pid in list(others):
            t0 = time.monotonic()
            try:
                read(f"/proc/{pid}/stat")
            except OSError:
                continue
            if time.monotonic() - t0 > worst:
                slowest, worst = pid, time.monotonic() - t0
        return f"slowest pid {slowest}: {worst:.3f} s"

    def clone():
        t = threading.Thread(target=lambda: None)
        t.start()
        t.join()

    def page():
        m = mmap.mmap(-1, 1 << 16)
        m[0] = 1
        m.close()

    return {"proc-self": lambda: read("/proc/self/stat"),
            "proc-server": lambda: read(f"/proc/{server}/stat"),
            "proc-server-task": lambda: read(
                f"/proc/{server}/task/{server}/stat"),
            "proc-others": read_others, "clone": clone, "mmap": page}


VMSTAT_KEYS = ("compact_stall", "compact_fail", "thp_fault_alloc",
               "thp_fault_fallback", "pgmajfault")


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _cgroup_dir() -> str:
    """This process's cgroup v2 directory (the server's is the same: it
    is our child)."""
    try:
        for line in _read("/proc/self/cgroup").splitlines():
            if line.startswith("0::"):
                return "/sys/fs/cgroup" + line[3:].strip()
    except OSError:
        pass
    return "/sys/fs/cgroup"


def _kv(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        bits = line.split()
        if len(bits) == 2:
            try:
                out[bits[0]] = int(bits[1])
            except ValueError:
                pass
    return out


def mm_settings() -> dict:
    """The host's memory-management settings that decide a stall's cause,
    read once."""
    cg = _cgroup_dir()
    out = {"nproc": os.cpu_count(), "cgroup": cg}
    for key, path in (
            ("kernel", "/proc/version"),
            ("thp_enabled", "/sys/kernel/mm/transparent_hugepage/enabled"),
            ("thp_defrag", "/sys/kernel/mm/transparent_hugepage/defrag"),
            ("cpu_max", f"{cg}/cpu.max"),
            ("memory_max", f"{cg}/memory.max"),
            ("memory_high", f"{cg}/memory.high")):
        try:
            out[key] = _read(path).strip()
        except OSError as e:
            out[key] = f"unreadable: {e.strerror}"
    return out


def _mm_sources(server: int) -> dict:
    """{name: read() -> dict} of readings that never touch the server's
    mm (the caller takes the counters' deltas)."""
    cg = _cgroup_dir()

    def vmstat():
        kv = _kv(_read("/proc/vmstat"))
        out = {k: kv[k] for k in VMSTAT_KEYS if k in kv}
        out.update({k: v for k, v in kv.items()
                    if k.startswith("allocstall")})
        return out

    def pressure():
        out = {}
        for res in ("cpu", "memory", "io"):
            try:
                text = _read(f"/proc/pressure/{res}")
            except OSError:
                continue
            for line in text.splitlines():
                kind, *fields = line.split()
                vals = dict(f.split("=") for f in fields)
                out[f"{res}.{kind}.avg10"] = float(vals["avg10"])
                out[f"{res}.{kind}.total"] = int(vals["total"])
        return out

    def cgroup():
        out = {}
        for name, keys in (("cpu.stat", ("nr_throttled", "throttled_usec")),
                           ("memory.events", ("high", "max", "oom"))):
            try:
                kv = _kv(_read(f"{cg}/{name}"))
            except OSError:
                continue
            out.update({f"{name}.{k}": kv[k] for k in keys if k in kv})
        return out

    def threads():
        # A kernel view without wchan files (a sandboxed one) still gives
        # each thread's state; its wchan then counts as "absent".
        states, wchans = {}, {}
        for tid in os.listdir(f"/proc/{server}/task"):
            try:
                stat = _read(f"/proc/{server}/task/{tid}/stat")
            except OSError:
                continue
            try:
                wchan = _read(f"/proc/{server}/task/{tid}/wchan").strip()
            except OSError:
                wchan = "absent"
            state = stat[stat.rindex(")") + 2]
            states[state] = states.get(state, 0) + 1
            if state != "S" or wchan not in ("0", "", "absent"):
                key = f"{state}:{wchan or '0'}"
                wchans[key] = wchans.get(key, 0) + 1
        return {"states": states, "wchans": wchans}

    return {"vmstat": vmstat, "pressure": pressure, "cgroup": cgroup,
            "threads": threads}


def _mm_watch(name: str, fn, out, lock, stop) -> None:
    """Read one source every 0.1 s on this thread: counters as deltas
    (only those that moved), pressure as its stall microseconds and
    non-zero averages, thread states as read; every read over 0.2 s is
    written with its time, so a path that blocks names itself."""
    prev = None
    while not stop.is_set():
        t0 = time.monotonic()
        try:
            cur, err = fn(), None
        except OSError as e:
            cur, err = None, e.strerror
        took = time.monotonic() - t0
        rec = {"src": name, "t": round(t0, 3)}
        if took > 0.2:
            rec["slow_s"] = round(took, 3)
        if err:
            rec["error"] = err
        if cur is not None and name in ("vmstat", "cgroup"):
            if prev is not None:
                moved = {k: v - prev.get(k, v) for k, v in cur.items()
                         if v != prev.get(k, v)}
                if moved:
                    rec["delta"] = moved
            prev = cur
        elif cur is not None and name == "pressure":
            if prev is not None:
                moved = {k[:-6]: v - prev.get(k, v) for k, v in cur.items()
                         if k.endswith(".total") and v != prev.get(k, v)}
                if moved:
                    rec["stall_us"] = moved
                    rec["avg10"] = {k[:-6]: v for k, v in cur.items()
                                    if k.endswith(".avg10") and v}
            prev = cur
        elif cur is not None:
            rec.update(cur)
        if len(rec) > 2:
            with lock:
                out.write(json.dumps(rec) + "\n")
        time.sleep(max(0.1 - took, 0.0))


def parent(args) -> int:
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    work = tempfile.mkdtemp(prefix="probe-")
    beat, names_path = f"{work}/beat", f"{work}/names.json"
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child",
         "--repeat", str(args.repeat), "--out", args.out,
         "--beat", beat, "--names", names_path]
        + (["--selftest"] if args.selftest else [])
        + (["--call-watch"] if args.call_watch else [])
        + ["--inject-hold", str(args.inject_hold)]
        + (["--after-phases"] if args.after_phases else []))
    ring = collections.deque(maxlen=200)
    procs = collections.deque(maxlen=200)
    gil = open(args.out + ".gil.txt", "w")
    timeline = open(args.out + ".cpu.jsonl", "w")
    net, net_stop = open(args.out + ".net.jsonl", "w"), threading.Event()
    for kind in ("tcp", "unix"):
        threading.Thread(target=_pinger, args=(kind, net, net_stop),
                         daemon=True).start()
    others: list = []
    for kind, fn in _path_checks(proc.pid, others).items():
        threading.Thread(target=_timed_calls, args=(kind, fn, net, net_stop),
                         daemon=True).start()
    settings = mm_settings()
    print(json.dumps({"probe": "mm-settings", **settings}), flush=True)
    mm, mm_lock = open(args.out + ".mm.jsonl", "w"), threading.Lock()
    mm.write(json.dumps({"src": "settings", **settings}) + "\n")
    for name, fn in _mm_sources(proc.pid).items():
        threading.Thread(target=_mm_watch, args=(name, fn, mm, mm_lock,
                                                 net_stop),
                         daemon=True).start()
    stalls, onset, reported, last_beat = [], None, False, None
    names: dict = {}
    while proc.poll() is None:
        now = time.monotonic()
        ring.append((now, _tasks(proc.pid)))
        procs.append((now, _machine(proc.pid)))
        others[:] = [pid for pid in procs[-1][1] if pid != "machine"]
        if len(ring) > 1:
            try:
                with open(names_path) as f:
                    names = json.load(f)
            except (OSError, ValueError):
                pass
            timeline.write(json.dumps(_timeline_row(
                (ring[-2][1], procs[-2][1]), (ring[-1][1], procs[-1][1]),
                names, now)) + "\n")
        try:
            with open(beat) as f:
                last_beat = float(f.read())
        except (OSError, ValueError):
            pass                        # not written yet, or mid-write
        stale = last_beat is not None and now - last_beat > STALL_S
        if stale and onset is None:
            onset, reported = last_beat, False
        if onset is not None and (not stale or (
                not reported and now - onset > 15.0)):
            reported = True
            gil.write(_gil_report(ring, names, onset, now)
                      + _machine_report(procs, onset))
            gil.flush()
            if not stale:
                stalls.append((round(onset, 3), round(now - onset, 3)))
                onset = None
        time.sleep(0.5)
    net_stop.set()
    time.sleep(0.3)                     # the watchers' last writes
    with mm_lock:
        mm.close()
    timeline.close()
    print(json.dumps({"probe": "summary", "child_rc": proc.returncode,
                      "gil_stalls": stalls}), flush=True)
    return proc.returncode


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--repeat", type=int, default=2)
    p.add_argument("--out", default="chiprun_out/probe")
    p.add_argument("--after-phases", action="store_true",
                   help="run chip_smoke's phases 2-5 first, as main does")
    p.add_argument("--child", action="store_true")
    p.add_argument("--selftest", action="store_true",
                   help="check the watch on the CPU, no phase run")
    p.add_argument("--call-watch", action="store_true",
                   help="the profile hook on every thread but the gRPC "
                        "handlers (it slows those threads)")
    p.add_argument("--inject-hold", type=float, default=0.0,
                   help="hold the server's GIL this long at each run's "
                        "first measured burst")
    p.add_argument("--grpc-unrequested", action="store_true",
                   help="gRPC core's cancel of calls not requested in time")
    p.add_argument("--hold", type=float, default=40.0)
    p.add_argument("--beat")
    p.add_argument("--names")
    args = p.parse_args()
    if args.grpc_unrequested:
        return grpc_unrequested(args.hold)
    return child(args) if args.child else parent(args)


if __name__ == "__main__":
    sys.exit(main())
