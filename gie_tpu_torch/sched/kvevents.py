"""KV-cache event interface: remote caches feed the prefix index (port of
gie_tpu/sched/kvevents.py).

Reference roadmap item 1 (reference README.md:108): "Prefix-cache aware
load balancing with interfaces for remote caches". The pick-time index
(prefix.insert) is an optimistic guess — it never observes server-side
evictions, and decays only by age. Model servers that publish KV-cache
events (vLLM's KVEvents — BlockStored/BlockRemoved/AllBlocksCleared — or
a cache sidecar) can drive the same device table with ground truth
instead: stored chunks OR their endpoint bit in, removed chunks clear it,
a cleared cache drops the endpoint's whole presence column.

Event hashes are the EPP's own chunk-chain hashes (sched/hashing.py:
CRC32-chained 64-byte chunks) — the published contract for servers or
sidecars joining a pool with events enabled. Transport is pluggable: the
aggregator is a plain thread-safe sink; `KVEventHTTPServer` accepts
JSON-lines POSTs (one event per line) for deployments where pods push,
and the simulator publishes in-process.

Wire format (one JSON object per line, POST /events):

    {"type": "BlockStored",  "endpoint": "10.0.0.1:8000", "hashes": [..]}
    {"type": "BlockRemoved", "endpoint": "10.0.0.1:8000", "hashes": [..]}
    {"type": "AllBlocksCleared", "endpoint": "10.0.0.1:8000"}
"""

from __future__ import annotations

import hmac
import json
import threading
from typing import Callable, Optional

import numpy as np

from gie_tpu_torch.sched import constants as C

BLOCK_STORED = "BlockStored"
BLOCK_REMOVED = "BlockRemoved"
ALL_CLEARED = "AllBlocksCleared"


class KVEventAggregator:
    """Thread-safe sink batching events per endpoint slot, flushed into
    the scheduler's device index.

    `resolve_slot` maps an endpoint "ip:port" to its scheduler slot (the
    datastore's hostport index); unknown endpoints are dropped — events
    from pods not (yet) in the pool carry no routable meaning.
    """

    def __init__(
        self,
        scheduler,
        resolve_slot: Callable[[str], Optional[int]],
        flush_every: int = 256,
    ):
        self._scheduler = scheduler
        self._resolve = resolve_slot
        self._flush_every = flush_every
        self._lock = threading.Lock()
        # slot -> (stored list, removed list)
        self._pending: dict[int, tuple[list, list]] = {}
        self._pending_n = 0
        self.dropped = 0       # events for unknown endpoints
        self.ingested = 0

    def publish(self, event: dict) -> None:
        """Accept one event dict (see module docstring for the shape)."""
        etype = event.get("type")
        slot = self._resolve(str(event.get("endpoint", "")))
        if slot is None or not (0 <= slot < C.M_MAX):
            self.dropped += 1
            return
        if etype == ALL_CLEARED:
            self.flush()
            # Cache reset on a LIVE pod (vLLM emits AllBlocksCleared on
            # cache reset, not pod death): forget its chunks, keep its
            # assumed load — the pod still carries its in-flight queue.
            # Full eviction (prefix + load) belongs to PodDelete.
            self._scheduler.clear_prefix_endpoint(slot)
            self.ingested += 1
            return
        hashes = [int(h) & 0xFFFFFFFF for h in event.get("hashes", [])]
        hashes = [h for h in hashes if h != 0]
        if etype not in (BLOCK_STORED, BLOCK_REMOVED) or not hashes:
            return
        with self._lock:
            stored, removed = self._pending.setdefault(slot, ([], []))
            (stored if etype == BLOCK_STORED else removed).extend(hashes)
            self._pending_n += len(hashes)
            do_flush = self._pending_n >= self._flush_every
        self.ingested += 1
        if do_flush:
            self.flush()

    def publish_lines(self, payload: bytes) -> int:
        """JSON-lines ingestion (the HTTP transport); returns events read."""
        n = 0
        for line in payload.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
                if not isinstance(event, dict):
                    continue  # a bare scalar/list parses but is no event
                self.publish(event)
                n += 1
            except (ValueError, TypeError):
                continue
        return n

    def flush(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, {}
            self._pending_n = 0
        for slot, (stored, removed) in pending.items():
            self._scheduler.apply_prefix_events(
                slot,
                np.asarray(stored, np.uint32),
                np.asarray(removed, np.uint32),
            )


class KVEventHTTPServer:
    """Minimal push transport: POST /events with JSON lines.

    This is a CONTROL-PLANE input — forged events steer routing — so it
    ships with the same posture as the ext-proc surface: loopback bind by
    default (set `bind` to the pod-network interface explicitly), an
    optional shared bearer token (401 on mismatch when configured), and a
    bounded request body (413 above `max_body` — the Content-Length is
    never trusted to size a read)."""

    MAX_BODY_DEFAULT = 4 * 1024 * 1024  # 4 MiB of JSON lines per POST

    def __init__(
        self,
        aggregator: KVEventAggregator,
        port: int = 0,
        *,
        bind: str = "127.0.0.1",
        token: Optional[str] = None,
        max_body: int = MAX_BODY_DEFAULT,
    ):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        agg = aggregator

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 (stdlib naming)
                if self.path != "/events":
                    self.send_error(404)
                    return
                if token is not None:
                    got = self.headers.get("Authorization", "")
                    if not hmac.compare_digest(got, f"Bearer {token}"):
                        self.send_error(401)
                        return
                try:
                    length = int(self.headers.get("Content-Length", ""))
                except ValueError:
                    self.send_error(411)  # length required
                    return
                if length < 0 or length > max_body:
                    self.send_error(413)
                    return
                body = self.rfile.read(length)
                n = agg.publish_lines(body)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(json.dumps({"accepted": n}).encode())

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((bind, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
