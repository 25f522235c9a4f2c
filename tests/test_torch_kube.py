"""The port's kube adapter (gie_tpu_torch/controller/kube.py and
status.py) against the reference's, side by side on the CPU.

  manifests   pod_from_k8s, watch_event_from_k8s and pool_status_to_dict
              on the same seeded manifests, camelCase and snake_case keys,
              deleting, unready and bare pods and client objects with
              to_dict: equal Pods, events and status bodies;
  live        the port's and the reference's KubeClusterClient watching
              one tests/fakeapi.py server through one seeded script of
              pod adds, updates and deletes, pool updates, and a compacted
              event log that sends both into 410 Gone and a relist: the
              same event sequence per kind, and each package's
              reconcilers and datastore (the manifest rides on the event)
              holding the same endpoints, after the relist the server's
              ready pods;
  status      patch_pool_status and PoolStatusController: equal status
              bodies, the transition times carried, no patch when
              nothing changed;
  auth        kubeconfig (token, CA file, inline CA and client cert and
              key data, file references, exec plugins refused, no server)
              and in-cluster loading from temp files: equal results;
  main        `python -m gie_tpu_torch.runtime.main --kube --kubeconfig`
              against a fakeapi server (the Scheduler on the CPU): the
              pool's pods arrive from the watch, the Gateway's parent
              status is patched, the Lease names this process and
              ext-proc streams are answered with the pool's pods.
"""

import base64
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import yaml

from gie_tpu.api import types as r_api
from gie_tpu.controller import kube as r_kube
from gie_tpu.controller import reconcilers as r_rec
from gie_tpu.controller import status as r_status
from gie_tpu.datastore import Datastore as RDatastore
from gie_tpu.utils.kubemeta import GKNN as RGKNN
from gie_tpu_torch.api import types as p_api
from gie_tpu_torch.controller import kube as p_kube
from gie_tpu_torch.controller import reconcilers as p_rec
from gie_tpu_torch.controller import status as p_status
from gie_tpu_torch.datastore import Datastore as PDatastore
from gie_tpu_torch.utils.kubemeta import GKNN as PGKNN
from tests.fakeapi import FakeKubeApiServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "default"
POOL = "kube-pool"
SEED = 15
SIDES = ((r_kube, r_api, r_rec, RDatastore, RGKNN),
         (p_kube, p_api, p_rec, PDatastore, PGKNN))


def _snake_keys(obj):
    """The kubernetes client's to_dict() key shape."""
    if isinstance(obj, dict):
        return {r_kube._snake(k): _snake_keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_snake_keys(v) for v in obj]
    return obj


class _ToDict:
    def __init__(self, d):
        self._d = d

    def to_dict(self):
        return self._d


def pod_manifest(name, ip, ready=True, labels=None, deleting=False,
                 ns=NS) -> dict:
    meta = {"name": name, "namespace": ns,
            "labels": labels or {"app": "vllm"}}
    if deleting:
        meta["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    return {"kind": "Pod", "metadata": meta, "status": {
        "podIP": ip, "conditions": [
            {"type": "PodScheduled", "status": "True"},
            {"type": "Ready", "status": "True" if ready else "False"}]}}


def pool_manifest(ports=(8000,)) -> dict:
    return {"kind": "InferencePool",
            "metadata": {"name": POOL, "namespace": NS},
            "spec": {"selector": {"matchLabels": {"app": "vllm"}},
                     "targetPorts": [{"number": p} for p in ports],
                     "endpointPickerRef": {"name": "epp",
                                           "port": {"number": 9002}}}}


def _manifests() -> list:
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(24):
        m = pod_manifest(f"p{i}", f"10.0.{i}.{int(rng.integers(1, 250))}",
                         ready=bool(rng.random() < 0.7),
                         deleting=bool(rng.random() < 0.2),
                         labels={"app": "vllm", "rank": str(i % 3)})
        if i % 4 == 1:
            m["metadata"]["annotations"] = {"x/active-ports": "8000"}
        out += [m, _snake_keys(m), _ToDict(copy.deepcopy(m))]
    out += [{}, {"metadata": {"name": "bare"}},
            {"metadata": {"name": "x"}, "status": {"conditions": None,
                                                   "podIP": None}},
            {"metadata": {"name": "y"}, "status": {"conditions": [
                "not-a-dict", {"type": "Ready", "status": "False"}]}}]
    return out


def test_pod_from_k8s_equal_reference():
    pods = [[dataclasses.asdict(mod.pod_from_k8s(m)) for m in _manifests()]
            for mod in (r_kube, p_kube)]
    assert pods[1] == pods[0]
    # A deleting pod carries its timestamp in both key shapes.
    deleting = [p for p in pods[1] if p["deletionTimestamp"]]
    assert deleting and len(deleting) % 3 == 0


def test_watch_event_from_k8s_equal_reference():
    events = []
    for m in _manifests()[:30]:
        for etype in ("ADDED", "MODIFIED", "DELETED", "BOOKMARK", None):
            ev = {"object": m} if etype is None else {"type": etype,
                                                        "object": m}
            events.append(ev)
    events.append({"type": "MODIFIED"})
    got = [[dataclasses.asdict(mod.watch_event_from_k8s(ev, "Pod"))
            for ev in events] for mod in (r_kube, p_kube)]
    assert got[1] == got[0]
    assert all(e["object"] is None for e in got[1] if e["type"] == "DELETED")


def _status(api, stamped: bool):
    """Two parents, one carrying fixed transition times, one with none."""
    times = "2026-01-01T00:00:00Z" if stamped else ""
    parents = []
    for name, kind in (("gw-a", "Gateway"), ("east", "InferencePoolImport")):
        ps = api.ParentStatus(parentRef=api.ParentReference(
            name=name, kind=kind))
        ps.set_condition(api.Condition(api.COND_ACCEPTED, "True",
                                       api.REASON_ACCEPTED, "ok",
                                       lastTransitionTime=times))
        ps.set_condition(api.Condition(api.COND_RESOLVED_REFS, "False",
                                       api.REASON_INVALID_EXTENSION_REF,
                                       "missing", lastTransitionTime=times))
        parents.append(ps)
    return api.InferencePoolStatus(parents=parents)


def _strip_times(body):
    if isinstance(body, dict):
        return {k: _strip_times(v) for k, v in body.items()
                if k != "lastTransitionTime"}
    if isinstance(body, (list, tuple)):
        return [_strip_times(v) for v in body]
    return body


def test_pool_status_to_dict_equal_reference():
    for stamped in (True, False):
        got = [mod.pool_status_to_dict(_status(api, stamped))
               for mod, api in ((r_kube, r_api), (p_kube, p_api))]
        if stamped:
            assert got[1] == got[0]
        else:
            assert _strip_times(got[1]) == _strip_times(got[0])
        conds = [c for p in got[1]["parents"] for c in p["conditions"]]
        assert all(c["lastTransitionTime"] for c in conds)


# -- live watches against one apiserver -----------------------------------


def _wait(pred, timeout_s: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


class _Side:
    """One package's client, event log and reconciled datastore."""

    def __init__(self, srv, kube, api, rec, datastore, gknn):
        self.client = kube.KubeClusterClient(
            NS, POOL, server=srv.url, token="t", watch_timeout_s=1,
            backoff_s=0.05)
        self.events = {"Pod": [], "InferencePool": []}
        self.client.subscribe(lambda ev: self.events[ev.kind].append(
            dataclasses.asdict(ev)))
        self.ds = datastore()
        rec.wire(self.client,
                 rec.InferencePoolReconciler(
                     self.client, self.ds,
                     gknn(api.GROUP, "InferencePool", NS, POOL)),
                 rec.PodReconciler(self.client, self.ds))

    def endpoints(self):
        return (sorted(e.hostport for e in self.ds.endpoints()),
                sorted(e.hostport for e in self.ds.pick_candidates()))


def _settled(sides, counts) -> None:
    assert _wait(lambda: all(
        [len(s.events[k]) for k in ("Pod", "InferencePool")] == counts
        for s in sides)), [
        [len(s.events[k]) for k in ("Pod", "InferencePool")] for s in sides]


def test_clients_over_one_apiserver_equal_reference():
    rng = np.random.default_rng(SEED)
    srv = FakeKubeApiServer()
    srv.apply("pools", pool_manifest())
    live = {}
    for i in range(6):
        live[f"p{i}"] = f"127.5.0.{i + 1}"
        srv.apply("pods", pod_manifest(f"p{i}", live[f"p{i}"]))
    sides = [_Side(srv, *side) for side in SIDES]
    try:
        for s in sides:
            s.client.start()
        counts = [6, 1]
        _settled(sides, counts)
        for step in range(24):
            op = int(rng.integers(0, 5))
            if op == 0 or not live:
                name = f"n{step}"
                live[name] = f"127.5.1.{step + 1}"
                srv.apply("pods", pod_manifest(name, live[name]))
            elif op == 1:
                name = sorted(live)[int(rng.integers(0, len(live)))]
                srv.apply("pods", pod_manifest(
                    name, live[name], ready=bool(rng.random() < 0.5)))
            elif op == 2:
                name = sorted(live)[int(rng.integers(0, len(live)))]
                srv.apply("pods", pod_manifest(name, live[name],
                                               deleting=True))
            elif op == 3:
                name = sorted(live)[int(rng.integers(0, len(live)))]
                srv.delete("pods", NS, name)
                del live[name]
            else:
                srv.apply("pools", pool_manifest(
                    ports=(8000,) if step % 2 else (8000, 8002)))
                counts[1] += 1
                _settled(sides, counts)
                continue
            counts[0] += 1
            _settled(sides, counts)
            assert sides[1].endpoints() == sides[0].endpoints(), step
        # A compacted window: one delete and one add that no watch
        # streams (the lock keeps every watcher asleep), then 410 Gone on
        # each watch's resume and a relist that surfaces both.
        gone = sorted(live)[0]
        with srv._lock:
            srv.compact()
            srv.delete("pods", NS, gone)
            del live[gone]
            live["late"] = "127.5.2.1"
            srv.apply("pods", pod_manifest("late", live["late"]))
            srv.compact()
        counts = [counts[0] + len(live) + 1, counts[1] + 1]
        _settled(sides, counts)
        for s in sides:
            assert s.events["Pod"][-1] == {
                "type": "DELETED", "kind": "Pod", "namespace": NS,
                "name": gone, "object": None}
        for kind in ("Pod", "InferencePool"):
            assert sides[1].events[kind] == sides[0].events[kind], kind
        assert sides[1].endpoints() == sides[0].endpoints()
        ready = {n for (r, _ns, n), obj in srv._objects.items()
                 if r == "pods" and p_kube.pod_from_k8s(obj).ready
                 and not obj["metadata"].get("deletionTimestamp")}
        pool = p_api.pool_from_dict(srv._objects[("pools", NS, POOL)])
        ports = [p.number for p in pool.spec.targetPorts]
        want = sorted(f"{live[n]}:{p}" for n in ready for p in ports)
        assert sides[1].endpoints()[1] == want
    finally:
        for s in sides:
            s.client.stop()
        srv.close()


def test_status_publication_equal_reference():
    patches = []
    for kube, api, status_mod in ((r_kube, r_api, r_status),
                                  (p_kube, p_api, p_status)):
        srv = FakeKubeApiServer()
        try:
            srv.apply("pools", pool_manifest())
            client = kube.KubeClusterClient(NS, POOL, server=srv.url,
                                            token="t")
            seen = []

            def record():
                # Copied as each patch lands: the fake apiserver merges the
                # next patch into the dict it recorded for the first.
                seen.extend(copy.deepcopy(srv.status_patches[len(seen):]))

            client.patch_pool_status(NS, POOL, _status(api, True))
            record()
            srv.apply("services", {"kind": "Service", "metadata": {
                "name": "epp", "namespace": NS}})
            ctl = status_mod.PoolStatusController(
                client, NS, POOL, parents=["gw-b", "gw-a"],
                service_exists=client.service_exists)
            assert ctl.reconcile()
            record()
            assert ctl.reconcile()                       # no patch
            record()
            srv.delete("services", NS, "epp")
            assert ctl.reconcile()                       # ResolvedRefs flips
            record()
            assert not status_mod.PoolStatusController(
                client, NS, "absent", ["gw-a"],
                client.service_exists).reconcile()
            patches.append(seen)
        finally:
            srv.close()
    assert len(patches[0]) == 3
    assert patches[1][0] == patches[0][0]       # explicit transition times
    assert _strip_times(patches[1]) == _strip_times(patches[0])
    # The unchanged Accepted condition of gw-a kept its transition time
    # through the ResolvedRefs flip, in both.
    for got in patches:
        by_type = [{c["type"]: c for c in p["conditions"]} for p in
                   got[1][2]["status"]["parents"]
                   if p["parentRef"]["name"] == "gw-a"]
        flipped = [{c["type"]: c for c in p["conditions"]} for p in
                   got[2][2]["status"]["parents"]
                   if p["parentRef"]["name"] == "gw-a"]
        assert (flipped[0]["Accepted"]["lastTransitionTime"]
                == by_type[0]["Accepted"]["lastTransitionTime"])
        assert flipped[0]["ResolvedRefs"]["status"] == "False"


# -- auth -----------------------------------------------------------------


def _kubeconfig(tmp_path, name: str, cluster: dict, user: dict) -> str:
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump({
        "apiVersion": "v1", "kind": "Config", "current-context": "ctx",
        "contexts": [{"name": "other", "context": {"cluster": "x"}},
                     {"name": "ctx", "context": {"cluster": "c",
                                                 "user": "u"}}],
        "clusters": [{"name": "c", "cluster": cluster}],
        "users": [{"name": "u", "user": user}]}))
    return str(path)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_kubeconfig_and_incluster_loading_equal_reference(tmp_path,
                                                          monkeypatch):
    b64 = lambda s: base64.b64encode(s.encode()).decode()   # noqa: E731
    cases = {
        "token": ({"server": "https://k:6443",
                   "certificate-authority": "/etc/ca.crt",
                   "insecure-skip-tls-verify": True}, {"token": "tok"}),
        "inline": ({"server": "https://k:6443",
                    "certificate-authority-data": b64("CA PEM")},
                   {"client-certificate-data": b64("CERT"),
                    "client-key-data": b64("KEY")}),
        "files": ({"server": "http://127.0.0.1:1"},
                  {"client-certificate": "/c.crt", "client-key": "/c.key"}),
        "exec": ({"server": "https://k"}, {"exec": {"command": "x"}}),
        "no-server": ({}, {"token": "t"}),
    }
    for name, (cluster, user) in cases.items():
        path = _kubeconfig(tmp_path, name, cluster, user)
        got = [_outcome(mod._load_kubeconfig, path)
               for mod in (r_kube, p_kube)]
        if name == "inline":
            for g in got:
                cert, key = g[1][4]
                g[1] = g[1][:4] + ((_read(cert), _read(key)),) + g[1][5:]
                assert oct(os.stat(key).st_mode & 0o777) == "0o600"
        assert got[1] == got[0], name
    assert got[1][0] == "error"
    sa = tmp_path / "sa"
    sa.mkdir()
    (sa / "token").write_text("sa-token\n")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.96.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "8443")
    results = []
    for with_ca in (False, True):
        if with_ca:
            (sa / "ca.crt").write_text("CA")
        for mod in (r_kube, p_kube):
            monkeypatch.setattr(mod, "_SA_DIR", str(sa))
            results.append(mod._load_incluster())
    assert results[1] == results[0] and results[3] == results[2]
    assert results[3] == ("https://10.96.0.1:8443", "sa-token",
                          str(sa / "ca.crt"))
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST")
    errors = [_outcome(mod._load_incluster) for mod in (r_kube, p_kube)]
    assert errors[1] == errors[0] and errors[1][0] == "error"


def _outcome(fn, *args):
    try:
        return ["ok", fn(*args)]
    except Exception as e:
        return ["error", type(e).__name__, str(e)]


# -- main --kube on the CPU -----------------------------------------------

# main() with the port's Scheduler defaulted to the CPU (with no device
# it runs on the card) and the status loop every 0.5 s.
_MAIN = """
import sys
from gie_tpu_torch.sched import profile
_resolve = profile.resolve_device
profile.resolve_device = lambda d=None: _resolve("cpu" if d is None else d)
from gie_tpu_torch.runtime import main
main.STATUS_INTERVAL_S = 0.5
sys.exit(main.main(sys.argv[1:]))
"""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _kube_fixture(srv, n_pods: int) -> dict:
    """The pool, its EPP Service, its Gateway, its Deployment and ready
    pods on loopback addresses; -> {pod name: ip}."""
    srv.apply("pools", pool_manifest())
    srv.apply("services", {"kind": "Service",
                           "metadata": {"name": "epp", "namespace": NS}})
    srv.apply("gateways", {"kind": "Gateway",
                           "metadata": {"name": "gw", "namespace": NS}})
    srv.apply("deployments", {
        "kind": "Deployment", "metadata": {"name": "vllm", "namespace": NS},
        "spec": {"replicas": 2, "selector": {"matchLabels": {"app": "vllm"}},
                 "template": {"metadata": {"labels": {"app": "vllm"}}}}})
    pods = {}
    for i in range(n_pods):
        pods[f"p{i}"] = f"127.6.0.{i + 1}"
        srv.apply("pods", pod_manifest(f"p{i}", pods[f"p{i}"]))
    return pods


def test_main_kube_serves_from_the_watch(tmp_path):
    import grpc

    from gie_tpu_torch.extproc import pb
    from tests.test_extproc_wire import GOLDEN_REQUEST_HEADERS

    srv = FakeKubeApiServer()
    pods = _kube_fixture(srv, 6)
    kubeconfig = _kubeconfig(tmp_path, "kc", {"server": srv.url},
                             {"token": "t"})
    ports = [_free_port() for _ in range(3)]
    argv = ["--kube", "--kubeconfig", kubeconfig, "--pool-name", POOL,
            "--publish-status-parents", "gw", "--leader-elect",
            "--insecure-serving", "--no-resilience", "--no-obs",
            "--grpc-port", str(ports[0]), "--grpc-health-port",
            str(ports[1]), "--metrics-port", str(ports[2])]
    log = open(tmp_path / "main.log", "w")
    proc = subprocess.Popen([sys.executable, "-c", _MAIN] + argv, cwd=REPO,
                            stdout=log, stderr=subprocess.STDOUT)
    try:
        lease = ("leases", NS, f"{POOL}-epp-leader")
        assert _wait(lambda: lease in srv._objects or proc.poll() is not None,
                     60), "no Lease"
        assert proc.poll() is None, (tmp_path / "main.log").read_text()
        holder = srv._objects[lease]["spec"]["holderIdentity"]
        assert holder.startswith(f"{proc.pid}-")

        def accepted():
            for ns, name, patch in srv.status_patches:
                for p in patch["status"]["parents"]:
                    conds = {c["type"]: c["status"] for c in p["conditions"]}
                    if (name == POOL and p["parentRef"]["name"] == "gw"
                            and conds == {"Accepted": "True",
                                          "ResolvedRefs": "True"}):
                        return True
            return False

        assert _wait(accepted, 30), srv.status_patches
        answers = []
        with grpc.insecure_channel(f"127.0.0.1:{ports[0]}") as chan:
            method = chan.stream_stream(
                "/envoy.service.ext_proc.v3.ExternalProcessor/Process")
            deadline = time.monotonic() + 60
            while len(answers) < 8 and time.monotonic() < deadline:
                try:
                    got = list(method(iter([GOLDEN_REQUEST_HEADERS]),
                                      timeout=30))
                except grpc.RpcError:
                    time.sleep(0.2)     # pods not in the datastore yet
                    continue
                resp = pb.ProcessingResponse.FromString(got[0])
                mut = resp.request_headers.response.header_mutation
                answers += [o.header.raw_value.decode()
                            for o in mut.set_headers
                            if o.header.key == "x-gateway-destination-endpoint"]
        assert len(answers) == 8, (tmp_path / "main.log").read_text()
        ips = set(pods.values())
        assert all(a.split(",")[0].rsplit(":", 1)[0] in ips for a in answers)
        proc.terminate()
        assert proc.wait(timeout=30) == 0
        # The lease was released on the way out.
        assert srv._objects[lease]["spec"]["holderIdentity"] == ""
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
        srv.close()
