"""Flight-recorder dumps -> training matrices for gie-learn (copy of
gie_tpu/learn/dataset.py; records load through the port's recorder).

A v1 decision record (gie_tpu/obs/recorder.py) carries the chosen
endpoint's host-side scorer breakdown (``scorers``: queue / kv_cache /
assumed_load, each already normalized to [0, 1] by the same formulas the
device columns use) and — once the serve-outcome path closed it — who
actually served, the fallback rank the data plane walked, the outcome
class, and the pick-to-response-headers serve latency. build_dataset joins
those into (features, latency) regression rows.

Exclusion rules (each a COUNTED skip reason, never a KeyError):

- ``reset`` / ``closed`` streams never wrote ``served`` or a latency —
  and MUST NOT become targets even if a later schema adds timing: an
  aborted stream's elapsed time measures the client, not the endpoint
  (the rule that TPOT never trains on reset streams).
- ``5xx`` serves are excluded the same way: an Envoy local-reply 503
  arrives FAST, and a low-latency error sample would teach the policy
  that the sick endpoint is the most attractive one in the pool.
- Failovers (``served`` != ``chosen``) are skipped because the recorded
  features describe the PRIMARY endpoint, so the observed latency would
  mislabel the pair (mirrors the online TPOT trainer's rule).

Split discipline: every record belongs to a GROUP keyed by the schedule
fingerprint of the run that produced its dump (or a content hash when
the dump has none), and the train/eval split assigns whole groups — so
an eval trace is never trained on, no matter how records interleave.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Iterable

import numpy as np

from gie_tpu_torch.obs.recorder import load_records

# The scorer columns v1 records actually carry in their breakdown.
# Columns a record is missing load as 1.0 — the multiplicative policy's
# neutral element (col**w == 1 contributes nothing at col == 1) — and
# are counted, so a dump from a profile with a column disabled still
# trains cleanly and the default is visible, not silent.
DEFAULT_FEATURES: tuple[str, ...] = ("queue", "kv_cache", "assumed_load")

# Schema-v2 breakdown (gie_tpu/obs/recorder.py SCHEMA_VERSION): the
# device-gathered prefix/session affinity of the CHOSEN endpoint ride
# along in ``scorers`` (PickResult.affinity — the gie-learn residual:
# v1 policies trained blind to locality because the completer could not
# reconstruct those columns host-side). v1 dumps train under this schema
# too: the absent columns default to _NEUTRAL with counted
# ``defaulted_prefix`` / ``defaulted_session`` reasons.
AFFINITY_FEATURES: tuple[str, ...] = DEFAULT_FEATURES + ("prefix", "session")

_NEUTRAL = np.float32(1.0)


@dataclasses.dataclass(frozen=True)
class Dataset:
    """Aligned row-wise arrays plus the skip/tolerance ledger."""

    schema: tuple[str, ...]        # feature column names, in order
    features: np.ndarray           # [R, S] f32 raw normalized columns
    latency_ms: np.ndarray         # [R] f32 regression target
    fallback_rank: np.ndarray      # [R] i32 rank the data plane walked
    group: np.ndarray              # [R] i32 index into fingerprints
    fingerprints: tuple[str, ...]  # split key per group
    skipped: dict                  # reason -> count

    def __len__(self) -> int:
        return int(self.features.shape[0])


def content_fingerprint(records: list[dict]) -> str:
    """sha256 over canonical record bytes — the fallback split key for
    dumps that did not record the schedule fingerprint of the run that
    produced them. Same records => same key, so re-building the dataset
    can never migrate a group across the train/eval boundary."""
    h = hashlib.sha256()
    for rec in records:
        h.update(json.dumps(rec, sort_keys=True, default=str).encode())
        h.update(b"\n")
    return h.hexdigest()


def load_dump(path: str) -> tuple[str, list[dict]]:
    """Read one dump file -> (fingerprint, records). An envelope-level
    ``schedule_fingerprint`` (storm-produced dumps) wins; otherwise the
    content hash stands in."""
    with open(path) as f:
        text = f.read()
    stats: dict = {}
    records = load_records(text, stats=stats)
    fingerprint = ""
    try:
        raw = json.loads(text)
        if isinstance(raw, dict):
            fingerprint = str(raw.get("schedule_fingerprint", "") or "")
    except ValueError:
        pass
    return fingerprint or content_fingerprint(records), records


def load_dumps(paths: Iterable[str]) -> list[tuple[str, list[dict]]]:
    """load_dump over files or directories (directories contribute their
    ``*.json`` files in sorted-name order — deterministic corpus)."""
    out = []
    for path in paths:
        if os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                if name.endswith(".json"):
                    out.append(load_dump(os.path.join(path, name)))
        else:
            out.append(load_dump(path))
    return out


def _skip(skipped: dict, reason: str) -> None:
    skipped[reason] = skipped.get(reason, 0) + 1


def build_dataset(
    dumps: Iterable[tuple[str, list[dict]]],
    schema: tuple[str, ...] = DEFAULT_FEATURES,
) -> Dataset:
    """Join decision records with realized outcomes into regression rows.

    ``dumps`` is (fingerprint, records) pairs — from :func:`load_dumps`
    or built programmatically (the tests do). Rows keep the RAW
    normalized column values; the trainer takes logs itself so the
    feature floor lives in exactly one place (policy.EPS).
    """
    skipped: dict = {}
    feats: list[list[float]] = []
    lats: list[float] = []
    ranks: list[int] = []
    groups: list[int] = []
    fingerprints: list[str] = []
    for fingerprint, records in dumps:
        gi = len(fingerprints)
        fingerprints.append(fingerprint)
        for rec in records:
            if not isinstance(rec, dict):
                _skip(skipped, "junk_entry")
                continue
            outcome = rec.get("outcome")
            if outcome in ("shed", "unavailable"):
                _skip(skipped, outcome)      # nothing was served
                continue
            if outcome in ("reset", "closed"):
                _skip(skipped, outcome)      # abort cleared the serve;
                continue                     # never a latency target
            if outcome == "picked":
                _skip(skipped, "unresolved")  # outcome never arrived
                continue
            if outcome == "5xx":
                _skip(skipped, "error_5xx")  # errored serves train nothing
                continue
            if outcome != "2xx":
                _skip(skipped, f"outcome_{outcome}")
                continue
            served = rec.get("served")
            if not served:
                _skip(skipped, "missing_served")
                continue
            if served != rec.get("chosen"):
                _skip(skipped, "failover")
                continue
            latency = rec.get("serve_latency_ms")
            if not isinstance(latency, (int, float)) or latency <= 0:
                _skip(skipped, "missing_latency")
                continue
            scorer_cols = rec.get("scorers")
            if not isinstance(scorer_cols, dict):
                _skip(skipped, "missing_scorers")
                continue
            row = []
            for col in schema:
                val = scorer_cols.get(col)
                if not isinstance(val, (int, float)):
                    _skip(skipped, f"defaulted_{col}")
                    val = _NEUTRAL
                row.append(float(val))
            feats.append(row)
            lats.append(float(latency))
            ranks.append(int(rec.get("fallback_rank", 0)))
            groups.append(gi)
    return Dataset(
        schema=tuple(schema),
        features=np.asarray(feats, np.float32).reshape(len(feats),
                                                       len(schema)),
        latency_ms=np.asarray(lats, np.float32),
        fallback_rank=np.asarray(ranks, np.int32),
        group=np.asarray(groups, np.int32),
        fingerprints=tuple(fingerprints),
        skipped=skipped,
    )


def split_by_fingerprint(
    ds: Dataset,
    eval_fraction: float = 0.25,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """(train_rows, eval_rows) index arrays. Assignment is per GROUP:
    each fingerprint hashes (with the seed as salt) to a unit-interval
    point, and groups under ``eval_fraction`` go to eval WHOLE — a
    fingerprint can appear on one side only, by construction. With more
    than one group and a positive fraction, at least one group is forced
    to eval (lowest hash point) so the guard never silently degrades to
    train-on-everything."""
    if not 0.0 <= eval_fraction < 1.0:
        raise ValueError(
            f"eval_fraction must be in [0, 1) (got {eval_fraction})")
    points = []
    for fingerprint in ds.fingerprints:
        digest = hashlib.sha256(
            f"gie-learn-split/{seed}:{fingerprint}".encode()).digest()
        points.append(int.from_bytes(digest[:8], "big") / 2.0 ** 64)
    eval_groups = {
        gi for gi, p in enumerate(points) if p < eval_fraction}
    if (eval_fraction > 0.0 and not eval_groups
            and len(ds.fingerprints) > 1):
        eval_groups = {int(np.argmin(np.asarray(points)))}
    is_eval = np.asarray(
        [gi in eval_groups for gi in ds.group], bool)
    rows = np.arange(len(ds))
    return rows[~is_eval], rows[is_eval]
