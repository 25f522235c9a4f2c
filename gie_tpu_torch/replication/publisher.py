"""Leader-side digest publication: epoch-versioned snapshots over HTTP
(copy of gie_tpu/replication/publisher.py).

The publisher periodically snapshots a set of EXPORTERS (callables
returning flat array dicts — Scheduler.export_state,
CapacityModel.export_state; the reference's OnlineTrainer comes with the
latency-predictor slice), fingerprints each section's
encoded payload, and bumps a single state EPOCH whenever anything changed.
Followers address digests by (era, epoch):

  era    a random token minted per publisher incarnation. Epochs are only
         comparable within one era — a failover elects a NEW leader whose
         counter restarts, and a follower that carried the old era must
         resync a full snapshot rather than misread epoch 3 of the new
         leader as older state than epoch 40 of the dead one.
  epoch  monotonically increasing per state change; doubles as the HTTP
         ETag, so an unchanged-state poll is one 304 with no body.

Delta frames: ``?since=N&era=E`` returns only the sections whose state
changed after epoch N (base_epoch=N in the digest header). A follower at
the current epoch short-circuits via If-None-Match; anything the publisher
cannot serve incrementally (era mismatch, future epoch) falls back to a
full snapshot — anti-entropy must always converge, delta is only an
optimization.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
import zlib
from typing import Callable, Optional

from gie_tpu_torch.replication.codec import build_digest, encode_section
from gie_tpu_torch.resilience import faults
from gie_tpu_torch.runtime.logging import get_logger

DIGEST_PATH = "/replication/digest"
STATUS_PATH = "/replication/status"
ERA_HEADER = "X-Replication-Era"
EPOCH_HEADER = "X-Replication-Epoch"


class StatePublisher:
    """Snapshots exporters into versioned digests; thread-safe."""

    def __init__(
        self,
        exporters: dict,
        *,
        era: Optional[str] = None,
    ):
        self.exporters = dict(exporters)
        self.era = era if era is not None else uuid.uuid4().hex[:12]
        self.log = get_logger("replication.publisher")
        self._lock = threading.Lock()
        self._payloads: dict[str, bytes] = {}
        self._crcs: dict[str, int] = {}
        self._section_epoch: dict[str, int] = {}
        self._epoch = 0
        self.last_refresh_at = 0.0   # monotonic
        self.digest_bytes = 0        # size of the current FULL digest

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def refresh(self) -> int:
        """Snapshot every exporter; bump the epoch if any section's encoded
        payload changed. Exporters run OUTSIDE the publisher lock (they take
        their own component locks and may force a device sync); a failing
        exporter keeps its previous payload rather than tearing a section
        out of the digest mid-flight."""
        fresh: dict[str, bytes] = {}
        for name, fn in self.exporters.items():
            try:
                arrays = fn()
                if arrays:
                    fresh[name] = encode_section(arrays)
            except Exception as e:
                self.log.error(
                    "replication exporter failed", section=name, err=e)
        with self._lock:
            changed = [
                name for name, payload in fresh.items()
                if self._crcs.get(name) != zlib.crc32(payload) & 0xFFFFFFFF
            ]
            if changed:
                self._epoch += 1
                for name in changed:
                    self._payloads[name] = fresh[name]
                    self._crcs[name] = zlib.crc32(fresh[name]) & 0xFFFFFFFF
                    self._section_epoch[name] = self._epoch
            self.last_refresh_at = time.monotonic()
            self.digest_bytes = sum(len(p) for p in self._payloads.values())
            return self._epoch

    def _etag(self) -> str:
        return f'"{self.era}:{self._epoch}"'

    def serve(
        self,
        *,
        since: Optional[int] = None,
        era: Optional[str] = None,
        if_none_match: Optional[str] = None,
        leader: bool = True,
    ) -> tuple[int, dict, bytes]:
        """One digest request -> (status, headers, body). Shared by the
        HTTP handler and the in-memory transport tests use, so the two
        paths cannot diverge on protocol semantics."""
        if not leader:
            # A non-leader must not serve digests: a follower's copy lags
            # the leader's, and chaining syncs through it would let stale
            # state win the anti-entropy race.
            return 503, {}, b"not leader"
        verdict = None
        if faults.ENABLED:
            # gie-chaos: drawn OUTSIDE the publisher lock (a latency/hang
            # verdict sleeps in fire()). ERROR models a leader that stops
            # serving; CORRUPT flips a byte in the outgoing frame — the
            # codec's CRC guard on the follower is what must absorb it.
            verdict = faults.fire("replication.publish")
            if verdict.kind == faults.ERROR:
                return 503, {}, b"injected fault"
        with self._lock:
            if self._epoch == 0:
                return 503, {}, b"no digest published yet"
            etag = self._etag()
            headers = {
                "ETag": etag,
                ERA_HEADER: self.era,
                EPOCH_HEADER: str(self._epoch),
            }
            if if_none_match == etag:
                return 304, headers, b""
            delta = (
                era == self.era
                and since is not None
                and 0 <= since <= self._epoch
            )
            if delta:
                payloads = {
                    n: p for n, p in self._payloads.items()
                    if self._section_epoch[n] > since
                }
                blob = build_digest(
                    self._epoch, payloads, delta=True, base_epoch=since)
            else:
                blob = build_digest(self._epoch, dict(self._payloads))
            headers["Content-Type"] = "application/octet-stream"
        if verdict is not None and verdict.kind == faults.CORRUPT:
            flipped = bytearray(blob)
            flipped[len(flipped) // 2] ^= 0xFF
            blob = bytes(flipped)
        return 200, headers, blob

    def status(self) -> dict:
        with self._lock:
            return {
                "era": self.era,
                "epoch": self._epoch,
                "sections": dict(self._section_epoch),
                "digest_bytes": self.digest_bytes,
            }


class ReplicationHTTPServer:
    """Digest transport on the gateway's control surface.

    Same posture as the KV-events listener (this is control-plane state;
    a forged digest steers routing): loopback bind by default, the pod-
    network interface is an explicit decision. GET-only."""

    def __init__(
        self,
        publisher: StatePublisher,
        port: int = 0,
        *,
        bind: str = "127.0.0.1",
        role_fn: Callable[[], bool] = lambda: True,
    ):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        pub = publisher

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib naming)
                parsed = urlparse(self.path)
                if parsed.path == STATUS_PATH:
                    body = json.dumps({
                        **pub.status(), "leader": bool(role_fn())}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if parsed.path != DIGEST_PATH:
                    self.send_error(404)
                    return
                q = parse_qs(parsed.query)
                since = None
                try:
                    if "since" in q:
                        since = int(q["since"][0])
                except (ValueError, IndexError):
                    since = None
                era = q.get("era", [None])[0]
                status, headers, body = pub.serve(
                    since=since,
                    era=era,
                    if_none_match=self.headers.get("If-None-Match"),
                    leader=bool(role_fn()),
                )
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((bind, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="replication-http", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
