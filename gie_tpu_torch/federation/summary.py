"""Federation digest sections: what one cluster tells its peers (copy of
gie_tpu/federation/summary.py; its frames equal the reference's byte for
byte, so a port cluster and a reference cluster federate with each other).

The peer exchange rides the replication codec (replication/codec.py —
CRC-guarded, length-prefixed, numpy-native frames with
skip-unknown forward compat), so its wire hardening is inherited
wholesale. This module owns the SECTION layer above it: three
bounded sections a cluster publishes and a peer installs.

  fed.meta   era pair + epoch lineage marker, the whole-cluster DRAINING
             flag, and the cluster name. The era pair (seq, token) is
             the split-brain ordering key: eras compare as tuples, and a
             peer link only ever moves FORWARD to the numerically
             greatest era it has seen — both sides of a healed
             partition deterministically converge on max(era), and the
             zombie lineage's frames reject as era regressions
             (docs/FEDERATION.md "split brain").
  fed.load   the schedulable-endpoint summary: hostports (fixed-width
             utf-8 rows), scraped queue depth / KV utilization, and
             per-endpoint drain flags, BOUNDED to max_endpoints rows
             (a truncated flag records the clip — silent truncation
             would read as "that's the whole cluster").
  fed.prefix a bounded sample of hot prefix-table keys, so a spillover
             pick can prefer the peer whose fleet already holds the
             request's prefix.

Unknown sections and unknown arrays inside known sections are ignored
by the installers (forward compat between peer clusters on different
builds — pinned by tests/test_federation.py's cross-version fuzz);
malformed KNOWN sections decode to ``None`` and the whole frame
rejects, keeping the link's prior view.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

META_SECTION = "fed.meta"
LOAD_SECTION = "fed.load"
PREFIX_SECTION = "fed.prefix"

# Fixed hostport row width: "255.255.255.255:65535" is 21 bytes; 64
# leaves room for DNS-named endpoints without unbounded rows.
HOSTPORT_BYTES = 64
MAX_CLUSTER_NAME_BYTES = 64


@dataclasses.dataclass(frozen=True)
class PeerMeta:
    """Decoded fed.meta: the peer's lineage + drain state."""

    era: tuple  # (seq, token) — ordering key, compared as a tuple
    draining: bool
    cluster: str


@dataclasses.dataclass(frozen=True)
class PeerEndpoint:
    """One row of a decoded fed.load section."""

    hostport: str
    queue_depth: float
    kv_util: float
    draining: bool


def encode_meta(era: tuple, draining: bool, cluster: str) -> dict:
    name = cluster.encode("utf-8")[:MAX_CLUSTER_NAME_BYTES]
    return {
        "era": np.asarray([int(era[0]), int(era[1])], np.uint64),
        "draining": np.asarray(1 if draining else 0, np.uint8),
        "cluster": np.frombuffer(name, np.uint8).copy(),
    }


def decode_meta(arrays: Optional[dict]) -> Optional[PeerMeta]:
    """Validated inverse of encode_meta; None on any malformation (the
    link rejects the whole frame — an unordered era would defeat the
    split-brain convergence rule). Unknown extra arrays are ignored."""
    if not isinstance(arrays, dict):
        return None
    try:
        era = np.asarray(arrays["era"], np.uint64).reshape(-1)
        if era.shape[0] != 2:
            return None
        draining = bool(int(np.asarray(arrays["draining"]).reshape(())))
        cluster = bytes(
            np.asarray(arrays.get("cluster", np.zeros(0, np.uint8)),
                       np.uint8)
        ).decode("utf-8", errors="replace")
    except (KeyError, TypeError, ValueError, OverflowError):
        return None
    return PeerMeta(era=(int(era[0]), int(era[1])), draining=draining,
                    cluster=cluster)


def encode_load(endpoints: list, *, max_endpoints: int) -> dict:
    """Endpoint summary rows -> fed.load arrays. ``endpoints`` is a list
    of (hostport, queue_depth, kv_util, draining) tuples; rows beyond
    the bound are CLIPPED with the truncated flag set (lowest-queue rows
    are kept — the useful spill capacity, not an arbitrary prefix)."""
    rows = list(endpoints)
    truncated = len(rows) > max_endpoints
    if truncated:
        rows.sort(key=lambda r: (float(r[1]), r[0]))
        rows = rows[:max_endpoints]
    n = len(rows)
    hp = np.zeros((n, HOSTPORT_BYTES), np.uint8)
    queue = np.zeros((n,), np.float32)
    kv = np.zeros((n,), np.float32)
    draining = np.zeros((n,), np.uint8)
    for i, (hostport, q, k, d) in enumerate(rows):
        b = str(hostport).encode("utf-8")[:HOSTPORT_BYTES]
        hp[i, : len(b)] = np.frombuffer(b, np.uint8)
        queue[i] = q
        kv[i] = k
        draining[i] = 1 if d else 0
    return {
        "hostports": hp,
        "queue": queue,
        "kv": kv,
        "draining": draining,
        "truncated": np.asarray(1 if truncated else 0, np.uint8),
    }


def decode_load(arrays: Optional[dict]) -> Optional[list]:
    """fed.load arrays -> list[PeerEndpoint], or None on malformation.
    Rows whose hostport is empty or not host:port-shaped are dropped
    (never installed as routable endpoints); unknown arrays ignored."""
    if not isinstance(arrays, dict):
        return None
    try:
        hp = np.asarray(arrays["hostports"], np.uint8)
        queue = np.asarray(arrays["queue"], np.float32).reshape(-1)
        kv = np.asarray(arrays["kv"], np.float32).reshape(-1)
        draining = np.asarray(arrays["draining"], np.uint8).reshape(-1)
    except (KeyError, TypeError, ValueError):
        return None
    if hp.ndim != 2 or not (
            hp.shape[0] == queue.shape[0] == kv.shape[0]
            == draining.shape[0]):
        return None
    out: list = []
    for i in range(hp.shape[0]):
        raw = bytes(hp[i])
        hostport = raw.rstrip(b"\x00").decode("utf-8", errors="replace")
        host, sep, port = hostport.rpartition(":")
        if not sep or not host or not port.isdigit():
            continue
        if not (0 < int(port) < 65536):
            continue
        q = float(queue[i])
        k = float(kv[i])
        if not (np.isfinite(q) and np.isfinite(k)):
            continue  # NaN/inf rows would poison the cost model
        out.append(PeerEndpoint(
            hostport=hostport, queue_depth=max(q, 0.0),
            kv_util=min(max(k, 0.0), 1.0), draining=bool(draining[i])))
    return out


def _u32(keys) -> np.ndarray:
    """Prefix keys as the wire's uint32, from the port's int64 carriers
    (u32 values masked to 32 bits) or from uint32 arrays alike."""
    k = np.asarray(keys)
    if k.dtype != np.uint32:
        k = (k.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
    return k.reshape(-1)


def encode_prefix(keys, *, max_keys: int) -> dict:
    k = _u32(keys)
    k = k[k != 0]
    return {"keys": k[: max(int(max_keys), 0)]}


def decode_prefix(arrays: Optional[dict]) -> Optional[np.ndarray]:
    if not isinstance(arrays, dict):
        return None
    try:
        return np.asarray(arrays["keys"], np.uint32).reshape(-1)
    except (KeyError, TypeError, ValueError):
        return None
