"""(Copy of gie_tpu/obs/recorder.py, imports rewritten to gie_tpu_torch.)

Pick flight recorder: a fixed-size lock-free ring of per-request
scheduling decision records.

Every answered pick — full TPU cycle or degraded rung — appends one
record: the candidate subset the request arrived with, who was excluded
and why (breaker quarantine, graceful drain), the ranked choice with
its blended score vector, a host-side scorer breakdown for the chosen
endpoint, the ladder rung, the remaining deadline budget, and (filled
in later by the serve-outcome path) what the data plane actually did
with the decision. This is the record "Simple is Better" (PAPERS.md)
assumes exists: rich enough to replay and score scheduling policies
offline, and the raw material for offline work (learned-policy
training traces, p99 outlier ejection, real-hardware calibration).

Concurrency: writers are the batching completer, the dispatcher's
degraded path, and the ext-proc response threads (outcome updates) —
all append/mutate without a lock. The ring is a preallocated slot list;
each writer takes a ticket from an ``itertools.count`` (its C-level
``next`` is atomic under the GIL) and stores a FULLY-BUILT dict with
one list-item assignment. Readers reconstruct order from the ``seq``
embedded in each record, so a torn read can only miss the newest
in-flight slot, never see a half-written record. Outcome updates mutate
fields of an already-published dict (GIL-atomic item assignment).

Records are written at wave-completion cadence on the completer thread
— NEVER under the scheduler's pick lock, and with no device pulls of
their own (the scorer breakdown reads the wave's already-materialized
host-side arrays; gie-lint's GL002 blocking set covers the JSON export
so it can never creep under a declared lock).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Optional

# Record-schema version, stamped as ``v`` on every published record.
# Offline consumers (the learned-policy trainers, replay tooling) key
# compatibility off it: bump it when a field CHANGES MEANING, never for
# additive fields — loaders tolerate unknown fields by contract
# (:func:`load_records`). Version history lives in docs/OBSERVABILITY.md
# ("record schema").
#
# v2: ``scorers`` grew device-gathered ``prefix``/``session`` affinity
# columns (PickResult.affinity — the v1 breakdown only carried the three
# host-reconstructible columns, so a v2 trainer reading a v1 dump sees
# them defaulted-and-counted by gie_tpu/learn/dataset.py, same as any
# absent column). A meaning bump, not additive: ``scorers`` changed from
# "everything host-derivable" to "the device blend's locality columns
# included". Hierarchical picks may also carry a ``fleet`` provenance
# object (candidate cells / coarse scores / compression) — additive.
SCHEMA_VERSION = 2


def load_records(text: str, stats: Optional[dict] = None) -> list[dict]:
    """Tolerant loader for flight-recorder dumps (export_json /
    obs.dump_artifact artifacts): accepts a bare record list or a
    ``{"records": [...]}`` envelope, keeps unknown fields verbatim, and
    treats records from ANY schema version as loadable — pre-version
    dumps (no ``v``) are stamped ``v: 0``, future-version records are
    kept as-is rather than dropped (the consumer decides what of a newer
    record it understands; a trainer that crashed on a new field would
    rot every archived dump the day the schema grew one).

    Tolerance is COUNTED, never silent: pass ``stats`` (any dict) and
    the loader increments a reason key per tolerated entry —
    ``junk_entry`` for non-dict list items, ``unversioned`` for records
    missing a schema version. Records a serve outcome never closed
    (abort/5xx cleared or never wrote ``served``) load fine here; it is
    the CONSUMER's job to skip them with its own counted reason
    (gie_tpu/learn/dataset.py does exactly that) rather than KeyError on
    the missing field."""

    def _count(reason: str) -> None:
        if stats is not None:
            stats[reason] = stats.get(reason, 0) + 1

    raw = json.loads(text)
    if isinstance(raw, dict):
        raw = raw.get("records", [])
    if not isinstance(raw, list):
        raise ValueError(
            "flight-recorder dump must be a record list or a "
            "{'records': [...]} envelope")
    out: list[dict] = []
    for rec in raw:
        if not isinstance(rec, dict):
            _count("junk_entry")
            continue  # tolerate-unknown: skip non-record junk entries
        if not isinstance(rec.get("v"), int):
            _count("unversioned")
            rec = {**rec, "v": 0}
        out.append(rec)
    return out


class FlightRecorder:
    """Fixed-size lock-free decision-record ring."""

    def __init__(self, size: int = 512):
        if size < 1:
            raise ValueError("flight recorder size must be >= 1")
        self.size = size
        self._slots: list = [None] * size
        self._tickets = itertools.count()

    def append(self, record: dict) -> dict:
        """Publish one fully-built record (stamps ``seq`` + the schema
        version ``v``); returns it so callers can keep the reference for
        later outcome updates."""
        i = next(self._tickets)          # atomic ticket
        record["seq"] = i
        record["v"] = SCHEMA_VERSION
        self._slots[i % self.size] = record  # atomic publish
        return record

    def __len__(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def snapshot(self, n: int = 0) -> list[dict]:
        """Shallow copies of the live records, oldest first (newest-first
        when trimmed to the last ``n``). Copying detaches the zpage/JSON
        view from in-flight outcome mutations; record field values are
        scalars/small lists, so a shallow copy is a consistent-enough
        read without any writer coordination."""
        live = [dict(s) for s in list(self._slots) if s is not None]
        live.sort(key=lambda r: r.get("seq", 0))
        if n > 0:
            live = live[-n:][::-1]
        return live

    def find(self, trace_id: str = "", seq: Optional[int] = None
             ) -> Optional[dict]:
        """Newest record matching a trace ID (or exact seq) — the
        /debugz/pick join."""
        best = None
        for s in list(self._slots):
            if s is None:
                continue
            if seq is not None:
                if s.get("seq") == seq:
                    return dict(s)
                continue
            if trace_id and s.get("trace_id") == trace_id:
                if best is None or s.get("seq", 0) > best.get("seq", 0):
                    best = s
        return dict(best) if best is not None else None

    def export_json(self, n: int = 0) -> str:
        """Serialize the ring for artifacts/zpages. Listed in gie-lint's
        GL002 blocking set: serialization is I/O-scale work and must
        never run under a declared lock (the pick lock above all)."""
        return json.dumps(self.snapshot(n), default=str)


class DumpRotator:
    """Periodic flight-recorder harvesting with a bounded file budget —
    gie-learn's training feed (--obs-dump-interval-s, docs/LEARNED.md).

    Each :meth:`rotate_once` snapshots the installed recorder into
    ``directory/<name>-<seq>.json`` (the same envelope shape
    obs.dump_artifact writes, so gie_tpu.learn.dataset loads both), then
    prunes the oldest rotation files beyond ``keep``. The lock guards
    ONLY the sequence counter — callers race from the runner's rotation
    thread and ad-hoc harvests (tests, a future zpage action) — while
    every snapshot/serialize/unlink happens OUTSIDE it, per the GL002
    rule that recorder export I/O never runs under a declared lock.
    """

    def __init__(self, directory: str, *, keep: int = 8,
                 name: str = "rotation", clock=None):
        if keep < 1:
            raise ValueError("dump rotation keep must be >= 1")
        self.directory = directory
        self.keep = keep
        self.name = name
        self._clock = clock
        self._seq = 0
        self._lock = threading.Lock()

    def _next_seq(self) -> int:
        with self._lock:
            seq = self._seq
            self._seq += 1
        return seq

    def rotation_files(self) -> list[str]:
        """This rotator's dump files, oldest first (zero-padded sequence
        numbers make name order == age order). Other artifacts in the
        directory — chaos-scenario dumps, foreign rotators — are never
        listed, so they can never be pruned by this one."""
        prefix = f"{self.name}-"
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(
            os.path.join(self.directory, n) for n in names
            if n.startswith(prefix) and n.endswith(".json"))

    def rotate_once(self, recorder=None) -> Optional[str]:
        """Dump one snapshot and prune; returns the written path, or
        None when no recorder is installed or the write failed (the
        rotation thread rides shutdown-adjacent paths — it logs through
        its caller, never raises)."""
        from gie_tpu_torch import obs

        rec = recorder if recorder is not None else obs.RECORDER
        if rec is None:
            return None
        seq = self._next_seq()
        try:
            os.makedirs(self.directory, exist_ok=True)
            path = os.path.join(
                self.directory, f"{self.name}-{seq:08d}.json")
            payload = {
                "name": f"{self.name}-{seq:08d}",
                "written_at": (self._clock() if self._clock is not None
                               else time.time()),
                "records": rec.snapshot(),
            }
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(payload, fh, indent=1, default=str)
            for stale in self.rotation_files()[:-self.keep]:
                try:
                    os.unlink(stale)
                except OSError:
                    pass  # pruned by a racing rotate, or perms — skip
            return path
        except (OSError, ValueError):
            return None
