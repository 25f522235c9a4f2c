"""Kubernetes watch adapter: the real-cluster ClusterClient
(copy of gie_tpu/controller/kube.py).

The in-process FakeCluster serves tests and the demo; this adapter plugs
an actual kube-apiserver into the same seam (reference analogue:
controller-runtime's cached client + watches,
pkg/lwepp/server/controller_manager.go:45-68).

Deliberately STDLIB-ONLY HTTP (urllib + ssl): the official `kubernetes`
client is a heavyweight optional dependency this image doesn't ship, and
the protocol surface the EPP needs — GET/PATCH JSON plus chunked
list/watch streams with resourceVersion bookkeeping and 410-Gone relist
(the semantics reference controllers get from client-go reflectors) — is
small enough to own. That also makes the watch loop, backoff, and resync
paths testable against an in-process HTTP apiserver
(tests/test_kube_apiserver.py) instead of only duck-typed dicts.

Auth: in-cluster service account (token + CA from the serviceaccount
mount, host from KUBERNETES_SERVICE_* envs) or a kubeconfig file
(server / bearer token / CA / client cert-key contexts).
"""

from __future__ import annotations

import json
import os
import ssl
import threading
import urllib.error
import urllib.request
from typing import Callable, Optional

from gie_tpu_torch.api import types as api
from gie_tpu_torch.controller.cluster import WatchEvent
from gie_tpu_torch.datastore.objects import Pod

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def pod_from_k8s(obj) -> Pod:
    """corev1.Pod -> datastore Pod.

    Accepts BOTH key shapes seen in practice: camelCase (raw watch-event /
    manifest dicts) and snake_case (the kubernetes client's .to_dict()
    output). Readiness = PodReady condition True (reference pod.go:24-36).
    """
    if hasattr(obj, "to_dict"):
        obj = obj.to_dict()
    meta = obj.get("metadata") or {}
    status = obj.get("status") or {}

    def get(o, camel, default=None):
        if not isinstance(o, dict):
            return default
        value = o.get(camel)
        if value is None:
            value = o.get(_snake(camel))
        return default if value is None else value

    conditions = get(status, "conditions", []) or []
    ready = any(
        get(c, "type") == "Ready" and get(c, "status") == "True"
        for c in conditions
        if isinstance(c, dict)
    )
    return Pod(
        name=get(meta, "name", ""),
        namespace=get(meta, "namespace", "default"),
        labels=dict(get(meta, "labels", {}) or {}),
        annotations=dict(get(meta, "annotations", {}) or {}),
        ip=get(status, "podIP", "") or "",
        ready=ready,
        deletionTimestamp=get(meta, "deletionTimestamp", None),
    )


def _snake(camel: str) -> str:
    """camelCase -> snake_case matching the kubernetes client's to_dict
    keys (podIP -> pod_ip, deletionTimestamp -> deletion_timestamp)."""
    out = []
    prev_lower = False
    for ch in camel:
        if ch.isupper():
            if prev_lower:
                out.append("_")
            out.append(ch.lower())
            prev_lower = False
        else:
            out.append(ch)
            prev_lower = True
    return "".join(out)


class ApiError(RuntimeError):
    def __init__(self, status: int, message: str = ""):
        super().__init__(f"apiserver returned {status}: {message}")
        self.status = status


class KubeClusterClient:
    """ClusterClient over a real kube-apiserver (stdlib HTTP).

    Explicit `server`/`token` parameters exist for tests and custom
    wiring; otherwise `kubeconfig` (a path) or the in-cluster service
    account is used, in that order.
    """

    def __init__(
        self,
        namespace: str,
        pool_name: str,
        kubeconfig: Optional[str] = None,
        *,
        server: Optional[str] = None,
        token: Optional[str] = None,
        ca_cert: Optional[str] = None,
        client_cert: Optional[tuple[str, str]] = None,
        insecure_skip_verify: bool = False,
        request_timeout_s: float = 30.0,
        watch_timeout_s: int = 60,
        backoff_s: float = 1.0,
    ):
        self.namespace = namespace
        self.pool_name = pool_name
        self.request_timeout_s = request_timeout_s
        self.watch_timeout_s = watch_timeout_s
        self.backoff_s = backoff_s
        ca_data: Optional[str] = None
        if server is None:
            if kubeconfig:
                (server, token, ca_cert, ca_data, client_cert,
                 insecure_skip_verify) = _load_kubeconfig(kubeconfig)
            else:
                server, token, ca_cert = _load_incluster()
        self._server = server.rstrip("/")
        self._token = token
        self._ssl = self._make_ssl(ca_cert, ca_data, client_cert,
                                   insecure_skip_verify)
        self._subscribers: list[Callable[[WatchEvent], None]] = []
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    @staticmethod
    def _make_ssl(ca_cert, ca_data, client_cert,
                  insecure) -> Optional[ssl.SSLContext]:
        ctx = ssl.create_default_context(cafile=ca_cert, cadata=ca_data)
        if insecure:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if client_cert:
            ctx.load_cert_chain(certfile=client_cert[0],
                                keyfile=client_cert[1])
        return ctx

    # -- HTTP core ---------------------------------------------------------

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 content_type: str = "application/json",
                 timeout: Optional[float] = None):
        req = urllib.request.Request(
            self._server + path,
            method=method,
            data=json.dumps(body).encode() if body is not None else None,
        )
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        if body is not None:
            req.add_header("Content-Type", content_type)
        kwargs = {"timeout": timeout or self.request_timeout_s}
        if self._server.startswith("https"):
            kwargs["context"] = self._ssl
        return urllib.request.urlopen(req, **kwargs)

    def _json(self, method: str, path: str, body: Optional[dict] = None,
              content_type: str = "application/json") -> dict:
        try:
            with self._request(method, path, body, content_type) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            raise ApiError(e.code, e.read().decode(errors="replace")) from e

    # -- ClusterClient surface --------------------------------------------

    def _pods_path(self, namespace: str) -> str:
        return f"/api/v1/namespaces/{namespace}/pods"

    def _pools_path(self, namespace: str) -> str:
        return (f"/apis/{api.GROUP}/{api.VERSION}/namespaces/{namespace}"
                "/inferencepools")

    def get_pod(self, namespace: str, name: str) -> Optional[Pod]:
        try:
            return pod_from_k8s(
                self._json("GET", f"{self._pods_path(namespace)}/{name}"))
        except ApiError as e:
            # Only a confirmed 404 means "deleted" (the reconciler evicts
            # on None); transient apiserver failures must NOT drop
            # endpoints.
            if e.status == 404:
                return None
            raise

    def list_pods(self, namespace: str) -> list[Pod]:
        body = self._json("GET", self._pods_path(namespace))
        return [pod_from_k8s(item) for item in body.get("items", [])]

    def get_pool(self, namespace: str, name: str) -> Optional[api.InferencePool]:
        try:
            return api.pool_from_dict(
                self._json("GET", f"{self._pools_path(namespace)}/{name}"))
        except ApiError as e:
            if e.status == 404:
                return None
            raise

    def patch_pool_status(self, namespace: str, name: str,
                          status: api.InferencePoolStatus) -> None:
        self._json(
            "PATCH",
            f"{self._pools_path(namespace)}/{name}/status",
            {"status": pool_status_to_dict(status)},
            content_type="application/merge-patch+json",
        )

    def service_exists(self, namespace: str, name: str) -> bool:
        """EPP Service resolution for the ResolvedRefs condition."""
        try:
            self._json(
                "GET", f"/api/v1/namespaces/{namespace}/services/{name}")
            return True
        except ApiError as e:
            if e.status == 404:
                return False
            raise

    # -- watch fan-out (reconciler wiring seam) ----------------------------

    def subscribe(self, fn: Callable[[WatchEvent], None]) -> None:
        self._subscribers.append(fn)

    def start(self) -> None:
        """Run pod + pool watches, fanning events to subscribers."""
        for path, kind in (
            (self._pods_path(self.namespace), "Pod"),
            (self._pools_path(self.namespace), "InferencePool"),
        ):
            t = threading.Thread(
                target=self._watch_loop, args=(path, kind), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()

    def _emit(self, event: WatchEvent) -> None:
        for fn in list(self._subscribers):
            fn(event)

    def _watch_loop(self, path: str, kind: str) -> None:
        """client-go-reflector semantics on stdlib HTTP: LIST to learn the
        resourceVersion (emitting one synthetic event per listed item —
        the reconcilers are level-triggered, so a relist is a resync),
        then WATCH from it, following per-event resourceVersions; 410
        Gone (either an ERROR event or an HTTP 410) drops back to relist;
        transport errors back off and retry; a server-side timeout close
        resumes from the last seen resourceVersion without relisting.

        The reflector's Replace semantics are honored: `known` tracks
        every (namespace, name) this watch has surfaced, and a relist
        emits synthetic DELETED events for names that vanished while the
        watch was down — without them, a pod deleted during an outage
        would stay in the datastore as a routable endpoint forever.
        Listed/watched objects ride on the events (WatchEvent.object) so
        reconciles don't re-GET what the stream already carried."""
        rv: Optional[str] = None
        known: set[tuple[str, str]] = set()
        while not self._stop.is_set():
            try:
                if rv is None:
                    body = self._json("GET", path)
                    rv = (body.get("metadata") or {}).get(
                        "resourceVersion", "0")
                    current: set[tuple[str, str]] = set()
                    for item in body.get("items", []):
                        meta = item.get("metadata") or {}
                        ns = meta.get("namespace", self.namespace)
                        name = meta.get("name", "")
                        current.add((ns, name))
                        self._emit(WatchEvent(
                            type="MODIFIED", kind=kind, namespace=ns,
                            name=name, object=item))
                        if self._stop.is_set():
                            return
                    for ns, name in sorted(known - current):
                        self._emit(WatchEvent(
                            type="DELETED", kind=kind,
                            namespace=ns, name=name))
                    known = current
                rv = self._watch_once(path, kind, rv, known)
            except ApiError as e:
                if e.status == 410:
                    rv = None  # compacted away: relist
                else:
                    self._stop.wait(self.backoff_s)
            except Exception:
                self._stop.wait(self.backoff_s)

    def _watch_once(self, path: str, kind: str, rv: str,
                    known: set[tuple[str, str]]) -> Optional[str]:
        """One watch stream until server close; returns the next
        resourceVersion to resume from (None = relist needed). Maintains
        `known` incrementally so the next relist can diff correctly."""
        url = (f"{path}?watch=1&resourceVersion={rv}"
               f"&timeoutSeconds={self.watch_timeout_s}"
               "&allowWatchBookmarks=true")
        try:
            resp = self._request(
                "GET", url, timeout=self.watch_timeout_s + 15)
        except urllib.error.HTTPError as e:
            raise ApiError(e.code, e.read().decode(errors="replace")) from e
        with resp:
            for line in resp:
                if self._stop.is_set():
                    return rv
                line = line.strip()
                if not line:
                    continue
                ev = json.loads(line)
                obj = ev.get("object") or {}
                if ev.get("type") == "ERROR":
                    if obj.get("code") == 410:
                        return None
                    raise ApiError(int(obj.get("code") or 500),
                                   str(obj.get("message", "")))
                new_rv = (obj.get("metadata") or {}).get("resourceVersion")
                if new_rv:
                    rv = new_rv
                if ev.get("type") == "BOOKMARK":
                    continue
                event = watch_event_from_k8s(ev, kind)
                key = (event.namespace, event.name)
                if event.type == "DELETED":
                    known.discard(key)
                else:
                    known.add(key)
                self._emit(event)
        return rv


def _load_incluster() -> tuple[str, Optional[str], Optional[str]]:
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    token_path = os.path.join(_SA_DIR, "token")
    if not host or not os.path.exists(token_path):
        raise RuntimeError(
            "no usable Kubernetes configuration: pass --kubeconfig outside "
            "a cluster, or run in-cluster with a service account")
    with open(token_path) as f:
        token = f.read().strip()
    ca = os.path.join(_SA_DIR, "ca.crt")
    return (f"https://{host}:{port}", token,
            ca if os.path.exists(ca) else None)


def _load_kubeconfig(path: str):
    """Minimal kubeconfig reader: current-context -> (server, token,
    CA file, CA PEM data, client cert/key pair, skip-verify).

    Handles BOTH kubeconfig shapes: file references
    (certificate-authority / client-certificate / client-key) and the
    inline base64 `*-data` fields kind/minikube/GKE emit. CA data stays
    in memory (ssl cadata=); client cert/key data must become files for
    load_cert_chain, so they are materialized 0600 in a private 0700
    tempdir. Exec/auth-provider plugins are out of scope and raise a
    clear error rather than silently failing every request."""
    import base64
    import tempfile

    try:
        import yaml
    except ImportError as e:  # pragma: no cover - env without pyyaml
        raise RuntimeError(
            "--kubeconfig needs PyYAML to parse the file (the adapter "
            "itself is stdlib-only); install pyyaml, or pass server="
            "/token= explicitly, or run in-cluster"
        ) from e

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}

    def by_name(section, name):
        for entry in cfg.get(section, []) or []:
            if entry.get("name") == name:
                return entry
        return {}

    ctx_name = cfg.get("current-context", "")
    ctx = by_name("contexts", ctx_name).get("context", {})
    cluster = by_name("clusters", ctx.get("cluster", "")).get("cluster", {})
    user = by_name("users", ctx.get("user", "")).get("user", {})
    server = cluster.get("server")
    if not server:
        raise RuntimeError(
            f"kubeconfig {path}: current-context names no cluster server")

    ca_data = None
    if cluster.get("certificate-authority-data"):
        ca_data = base64.b64decode(
            cluster["certificate-authority-data"]).decode()

    client_cert = None
    if user.get("client-certificate") and user.get("client-key"):
        client_cert = (user["client-certificate"], user["client-key"])
    elif (user.get("client-certificate-data")
          and user.get("client-key-data")):
        d = tempfile.mkdtemp(prefix="gie-kubeconfig-", dir=None)
        os.chmod(d, 0o700)
        paths = []
        for fname, b64 in (("client.crt", user["client-certificate-data"]),
                           ("client.key", user["client-key-data"])):
            p = os.path.join(d, fname)
            fd = os.open(p, os.O_CREAT | os.O_WRONLY | os.O_EXCL, 0o600)
            with os.fdopen(fd, "wb") as fh:
                fh.write(base64.b64decode(b64))
            paths.append(p)
        client_cert = (paths[0], paths[1])

    token = user.get("token")
    if token is None and client_cert is None and (
            user.get("exec") or user.get("auth-provider")):
        raise RuntimeError(
            f"kubeconfig {path}: user {ctx.get('user', '')!r} authenticates "
            "via an exec/auth-provider plugin, which this stdlib adapter "
            "does not run — use a token or client-certificate credential, "
            "or pass server=/token= explicitly")

    return (
        server,
        token,
        cluster.get("certificate-authority"),
        ca_data,
        client_cert,
        bool(cluster.get("insecure-skip-tls-verify", False)),
    )


def pool_status_to_dict(status: api.InferencePoolStatus) -> dict:
    """InferencePoolStatus -> the status-subresource patch body's `status`
    value (manifest-shaped, empties pruned like api.pool_to_dict).

    metav1.Condition requires lastTransitionTime: conditions built without
    one (the shared desired_parent_statuses computation leaves it empty)
    are stamped here so the patch is admitted by clusters running the
    upstream CRD, not just this repo's committed one."""
    import dataclasses as _dc
    import datetime as _dt

    now = (
        _dt.datetime.now(_dt.timezone.utc)
        .replace(microsecond=0)
        .isoformat()
        .replace("+00:00", "Z")
    )
    parents = []
    for p in status.parents:
        d = _dc.asdict(p)
        for cond in d.get("conditions", []):
            if not cond.get("lastTransitionTime"):
                cond["lastTransitionTime"] = now
        parents.append(d)
    return api.clean_manifest({"parents": parents})


def patch_pool_status(custom_api, namespace: str, name: str,
                      status: api.InferencePoolStatus) -> None:
    """Publish pool status through a duck-typed CustomObjectsApi-shaped
    client (kept for callers wired to the official client or test fakes;
    KubeClusterClient.patch_pool_status is the in-tree HTTP path)."""
    custom_api.patch_namespaced_custom_object_status(
        api.GROUP, api.VERSION, namespace, "inferencepools", name,
        {"status": pool_status_to_dict(status)},
    )


def watch_event_from_k8s(ev: dict, kind: str) -> WatchEvent:
    """kubernetes watch event dict -> WatchEvent (pure; tested).

    The manifest rides on non-DELETED events (informer-style object
    pass-through); a DELETED event's object is its LAST state — carrying
    it would make a level-triggered consumer resurrect the pod, so
    deletions deliberately carry None and force the client-GET path
    (which confirms the 404)."""
    obj = ev.get("object", {})
    if hasattr(obj, "to_dict"):
        obj = obj.to_dict()
    meta = obj.get("metadata", {}) or {}
    etype = ev.get("type", "MODIFIED")
    return WatchEvent(
        type=etype,
        kind=kind,
        namespace=meta.get("namespace", "default"),
        name=meta.get("name", ""),
        object=None if etype == "DELETED" else obj,
    )
