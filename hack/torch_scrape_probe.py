#!/usr/bin/env python3
"""chip_smoke.py's phase 6 (the ext-proc server under 1024-stream bursts)
under a lock and GIL watch, to name what stalls the server.

    python3 hack/torch_scrape_probe.py [--after-phases] [--repeat R] [--out PREFIX]
    python3 hack/torch_scrape_probe.py --selftest --out PREFIX

Runs chip_smoke.phase_server for both configurations R times in a child
process, after building the kernels (and, with --after-phases, after
chip_smoke's phases 2-5, as main() runs them first), and watches it two
ways:

  in the child   the scrape engine's, metrics store's, breaker board's and
                 scheduler's locks are wrapped to record their owner; a
                 watchdog thread ticks every 0.1 s, and when one of those
                 locks has been held for over STALL_S it writes the
                 owner's Python stack and those of the threads that are no
                 gRPC handler to PREFIX.locks.txt; every scrape that fails
                 or takes over 0.5 s is kept, with the staleness the
                 ladder's blackout floor reads (sampled every 50 ms);
  in the parent  /proc of the child, every 0.5 s: each thread's state,
                 CPU ticks and the syscall it sits in. When the watchdog's
                 heartbeat is older than STALL_S (no Python thread of the
                 child could run: the GIL is held), it writes each
                 thread's name, the CPU it took during the stall and its
                 syscall to PREFIX.gil.txt, threads grouped by the futex
                 they wait on.

Prints one JSON line per phase run (configuration, passed or the error)
and a summary line with the stalls. Needs the card, as chip_smoke.py
does; --selftest checks the watch itself on the CPU (a lock held 3 s,
then the GIL held by a backtracking regular expression).
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


def _stack(frame) -> str:
    return "".join(traceback.format_stack(frame)) if frame else "  (gone)\n"


def _watchdog(beat_path, names_path, locks_out, stop):
    dumped = set()
    last_names = 0.0
    while not stop.is_set():
        now = time.monotonic()
        with open(beat_path, "w") as f:
            f.write(repr(now))
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
    threading.Thread(target=_watchdog, name="probe-watchdog", daemon=True,
                     args=(args.beat, args.names, locks_out, stop)).start()

    if args.selftest:
        # The harness itself, on the CPU: a store lock held 3 s, then the
        # GIL held ~3 s by a regular expression that backtracks.
        import re

        store = MetricsStore()
        with store._lock:
            time.sleep(3.0)
        re.match(r"(a+)+$", "a" * 26 + "b")
        time.sleep(1.0)
        stop.set()
        return 0
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
    failed = 0
    for r in range(args.repeat):
        for name, c, w, own in configs:
            del fetches[:], staleness[:], collections_[:]
            t0 = time.monotonic()
            error = None
            with tempfile.TemporaryDirectory() as tmp:
                try:
                    chip_smoke.phase_server(dev, name, c, w, kernels, own, tmp)
                except Exception as e:
                    error = repr(e)[:600]
                    failed += 1
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
            }), flush=True)
    stop.set()
    return 1 if failed else 0


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


def parent(args) -> int:
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    work = tempfile.mkdtemp(prefix="probe-")
    beat, names_path = f"{work}/beat", f"{work}/names.json"
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child",
         "--repeat", str(args.repeat), "--out", args.out,
         "--beat", beat, "--names", names_path]
        + (["--selftest"] if args.selftest else [])
        + (["--after-phases"] if args.after_phases else []))
    ring = collections.deque(maxlen=200)
    gil = open(args.out + ".gil.txt", "w")
    stalls, onset, reported, last_beat = [], None, False, None
    while proc.poll() is None:
        now = time.monotonic()
        ring.append((now, _tasks(proc.pid)))
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
            try:
                with open(names_path) as f:
                    names = json.load(f)
            except (OSError, ValueError):
                names = {}
            gil.write(_gil_report(ring, names, onset, now))
            gil.flush()
            if not stale:
                stalls.append((round(onset, 3), round(now - onset, 3)))
                onset = None
        time.sleep(0.5)
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
    p.add_argument("--beat")
    p.add_argument("--names")
    args = p.parse_args()
    return child(args) if args.child else parent(args)


if __name__ == "__main__":
    sys.exit(main())
