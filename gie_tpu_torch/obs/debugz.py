"""/debugz introspection plane on the metrics HTTP surface (a slim copy
of gie_tpu/obs/debugz.py).

One stdlib ThreadingHTTPServer serves the EPP's single operator port:

  /metrics            Prometheus text exposition (format 0.0.4) of the
                      port's own collector (runtime/metrics.py), gzipped
                      under Accept-Encoding as the reference's.
  /debugz             JSON catalog of the registered zpages.
  /debugz/<page>      one zpage, JSON. The runner registers: queue /
                      tenants / datastore / scheduler / drain / policy /
                      buildinfo.

Not carried here: the OpenMetrics form with trace-ID exemplars and the
flight-recorder and trace pages, which come with the observability slice
of the port (ROADMAP.md, Queue 1). The loopback gate and the bearer-token
gate on /debugz are the reference's.

Providers are callables ``(query: dict[str, str]) -> object`` so the
plane stays dependency-inverted: it knows nothing about the runner's
subsystems, the runner hands in closures. Handlers run on the HTTP
server's worker threads; every provider reads snapshots/reports that
take at most a leaf lock briefly — never the pick lock, and all JSON
serialization happens here.
"""

from __future__ import annotations

import gzip
import hmac
import ipaddress
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Mapping
from urllib.parse import parse_qsl, urlparse

from gie_tpu_torch.runtime import metrics as own_metrics

Provider = Callable[[dict], object]


def _jsonable(obj):
    """json.dumps default: numpy scalars -> python, everything else str."""
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(obj)


# --debugz-bind NAMES that keep /debugz loopback-only (the default);
# numeric values are classified with the same is_loopback predicate the
# peer gate applies, so 127.0.0.2 (a loopback alias) stays gated and a
# typo cannot silently disable the hardening.
_LOOPBACK_BIND_NAMES = frozenset({"", "localhost", "loopback"})


def _is_loopback_bind(value: str) -> bool:
    value = (value or "").strip().lower()
    if value in _LOOPBACK_BIND_NAMES:
        return True
    try:
        return ipaddress.ip_address(value.split("%")[0]).is_loopback
    except ValueError:
        # Unrecognized value: keep the GATE CLOSED — "loopback-only
        # unless a non-loopback ADDRESS is named" means an unparsable
        # name must not become an accidental opt-out.
        return True


class DebugzServer:
    """The combined /metrics + /debugz listener.

    The SOCKET stays on ``bind`` (0.0.0.0 by default — Prometheus must
    scrape /metrics from off-pod), but the /debugz zpages are a
    different trust story: pick explanations, breaker boards, and
    datastore dumps are operator introspection, plaintext JSON with no
    auth. ``debugz_bind`` therefore gates the /debugz PATHS by peer
    address: with a loopback value (the default) requests from any
    non-loopback peer get 403 and a pointer at the flag; an explicit
    non-loopback ``--debugz-bind`` (e.g. the pod IP, or 0.0.0.0) is the
    operator's opt-out (docs/OBSERVABILITY.md "bind hardening").
    """

    def __init__(self, port: int, providers: Mapping[str, Provider],
                 bind: str = "0.0.0.0", debugz_bind: str = "127.0.0.1",
                 debugz_token: str | None = None):
        self.providers = dict(providers)
        self.debugz_bind = debugz_bind
        self._debugz_loopback_only = _is_loopback_bind(debugz_bind)
        # Bearer-token auth for off-loopback zpage access
        # (--debugz-token, docs/OBSERVABILITY.md "bind hardening"): with
        # a token configured, a NON-loopback peer must present
        # ``Authorization: Bearer <token>`` (constant-time compare) on
        # every /debugz path — 401 otherwise — regardless of the
        # debugz_bind opt-out (the token is the stronger gate and always
        # wins for remote peers). Loopback peers never need it, and
        # /metrics is untouched either way.
        self._debugz_token = debugz_token or None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                try:
                    outer._handle(self)
                except BrokenPipeError:
                    pass  # scraper went away mid-write
                except Exception as e:  # debug plane must never crash
                    try:
                        self.send_error(500, f"{type(e).__name__}: {e}")
                    except Exception:
                        pass

            def log_message(self, *args):
                pass  # operator plane: no per-scrape stderr chatter

        try:
            self._httpd = ThreadingHTTPServer((bind, port), Handler)
        except OSError as e:
            raise OSError(f"failed to bind metrics/debugz port {port}: {e}")
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="gie-debugz", daemon=True)
        self._thread.start()

    # -- request handling --------------------------------------------------

    def _debugz_allowed(self, peer_host: str) -> bool:
        """May this peer read /debugz pages? Loopback peers always may;
        anyone else only when the operator opted out of the loopback
        default with an explicit --debugz-bind."""
        return (not self._debugz_loopback_only
                or self._peer_is_loopback(peer_host))

    def _peer_is_loopback(self, peer_host: str) -> bool:
        """THE peer-classification predicate — both gates (bind opt-out
        and token) route through it, so they can never disagree about
        the same peer. Unparsable peers are treated as remote."""
        try:
            return ipaddress.ip_address(peer_host.split("%")[0]).is_loopback
        except ValueError:
            return False

    def _token_ok(self, req: BaseHTTPRequestHandler) -> bool:
        """Constant-time bearer-token check (hmac.compare_digest — the
        zpage gate must not become a timing oracle for its own secret).
        Compared as BYTES: compare_digest rejects non-ASCII strings with
        a TypeError, which would turn a hostile non-ASCII Authorization
        header into a 500 instead of the documented 401."""
        auth = req.headers.get("Authorization", "") or ""
        if not auth.startswith("Bearer "):
            return False
        return hmac.compare_digest(
            auth[7:].strip().encode("utf-8", "surrogateescape"),
            self._debugz_token.encode("utf-8", "surrogateescape"))

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(req.path)
        path = parsed.path.rstrip("/") or "/"
        if path == "/debugz" or path.startswith("/debugz/"):
            peer = req.client_address[0]
            if self._debugz_token and not self._peer_is_loopback(peer):
                # Token configured: it is the remote-peer gate, stronger
                # than (and overriding) the bind opt-out.
                if not self._token_ok(req):
                    req.send_error(
                        401, "debugz requires Authorization: Bearer "
                             "<--debugz-token> from non-loopback peers")
                    return
            elif not self._debugz_allowed(peer):
                req.send_error(
                    403, "debugz is loopback-only by default; start with "
                         "an explicit --debugz-bind (or --debugz-token) "
                         "to expose it")
                return
        if path == "/debugz":
            self._send_json(req, {
                "pages": sorted(f"/debugz/{name}" for name in self.providers),
                "metrics": "/metrics",
            })
            return
        if path.startswith("/debugz/"):
            name = path[len("/debugz/"):]
            provider = self.providers.get(name)
            if provider is None:
                req.send_error(404, f"no such zpage: {name}")
                return
            query = dict(parse_qsl(parsed.query))
            self._send_json(req, provider(query))
            return
        # Everything else is the exposition — prometheus_client's
        # start_http_server serves metrics on ANY path, and existing
        # scrape configs may point at non-/metrics paths.
        self._serve_metrics(req)

    def _serve_metrics(self, req: BaseHTTPRequestHandler) -> None:
        """The exposition, gzipped under Accept-Encoding (Prometheus sends
        it by default)."""
        body = own_metrics.generate_latest()
        ctype = own_metrics.CONTENT_TYPE_LATEST
        req.send_response(200)
        req.send_header("Content-Type", ctype)
        if "gzip" in req.headers.get("Accept-Encoding", ""):
            body = gzip.compress(body, 5)
            req.send_header("Content-Encoding", "gzip")
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    def _send_json(self, req: BaseHTTPRequestHandler, obj) -> None:
        body = json.dumps(obj, indent=1, default=_jsonable).encode()
        req.send_response(200)
        req.send_header("Content-Type", "application/json")
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    # ----------------------------------------------------------------------

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def start_debugz_server(
    port: int, providers: Mapping[str, Provider] | None = None,
    bind: str = "0.0.0.0", debugz_bind: str = "127.0.0.1",
    debugz_token: str | None = None,
) -> DebugzServer:
    """Start the combined listener (the runner's metrics-port server)."""
    return DebugzServer(port, providers or {}, bind=bind,
                        debugz_bind=debugz_bind, debugz_token=debugz_token)
