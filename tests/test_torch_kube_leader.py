"""The port's Lease elector (gie_tpu_torch/runtime/leader.py
KubeLeaseElector) and the autoscale actuator's apply path
(gie_tpu_torch/autoscale/actuator.py) against the reference's, on the CPU
over tests/fakeapi.py.

  lease     two port electors and one reference elector contend one
            coordination.k8s.io Lease: exactly one holder at any time and
            the holder the Lease names; a graceful stop hands the Lease
            over without waiting out the TTL, a crashed holder's Lease is
            taken once it expires, and every holder change is a new
            acquireTime and leaseTransitions count;
  actuator  the SSA patch of spec.replicas: the calls each package makes
            for the same recommendations (leader-gated, dry run, no
            target, noop, patched) are equal, the fake apiserver keeps the
            Deployment's other fields, a transient error is retried and a
            404 is not, and the kube.patch fault point fires three times
            and degrades the apply to "error" in both;
  runner    the port's runner over a port KubeClusterClient builds a
            KubeLeaseElector for --leader-elect (readiness gated on it)
            and a writing actuator for --autoscale-mode apply.
"""

import time

import pytest

from gie_tpu.autoscale import actuator as r_act
from gie_tpu.autoscale import recommender as r_recommender
from gie_tpu.controller import kube as r_kube
from gie_tpu.resilience import faults as r_faults
from gie_tpu.runtime import leader as r_leader
from gie_tpu_torch.autoscale import actuator as p_act
from gie_tpu_torch.autoscale import recommender as p_recommender
from gie_tpu_torch.controller import kube as p_kube
from gie_tpu_torch.resilience import faults as p_faults
from gie_tpu_torch.runtime import leader as p_leader
from tests.fakeapi import FakeKubeApiServer

NS = "default"
LEASE = ("leases", NS, "pool-epp-leader")


def _wait(pred, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


@pytest.fixture()
def apiserver():
    srv = FakeKubeApiServer()
    yield srv
    srv.close()


def _elector(srv, kube, leader, ident, ttl=0.6, renew=0.05):
    client = kube.KubeClusterClient(NS, "pool", server=srv.url, token="t")
    return leader.KubeLeaseElector(client, NS, "pool-epp-leader",
                                   identity=ident, lease_ttl_s=ttl,
                                   renew_interval_s=renew)


def _holder(srv) -> str:
    obj = srv._objects.get(LEASE)
    return "" if obj is None else obj["spec"].get("holderIdentity") or ""


def test_port_and_reference_electors_share_one_lease(apiserver):
    electors = {
        "port-a": _elector(apiserver, p_kube, p_leader, "port-a"),
        "port-b": _elector(apiserver, p_kube, p_leader, "port-b"),
        "ref": _elector(apiserver, r_kube, r_leader, "ref"),
    }
    holders = []

    def leaders():
        return [n for n, e in electors.items() if e.is_leader()]

    for e in electors.values():
        e.start()
    try:
        assert _wait(lambda: len(leaders()) == 1)
        for _ in range(15):                       # never two leaders
            time.sleep(0.05)
            assert len(leaders()) <= 1
        first = leaders()[0]
        assert _holder(apiserver) == first
        holders.append(first)
        # Graceful stop: the Lease is blanked and taken at once (TTL far
        # longer than the wait).
        for e in electors.values():
            e.lease_ttl_s = 30.0
        electors.pop(first).stop()
        assert _wait(lambda: len(leaders()) == 1, 3.0)
        second = leaders()[0]
        assert second != first and _holder(apiserver) == second
        holders.append(second)
        # A crash (no release): taken only after the Lease expires, by
        # the duration the holder last wrote into it (1 s, the floor).
        for e in electors.values():
            e.lease_ttl_s = 0.6
        assert _wait(lambda: apiserver._objects[LEASE]["spec"][
            "leaseDurationSeconds"] == 1)
        crashed = electors.pop(second)
        crashed._stop.set()
        crashed._thread.join(timeout=2)
        t0 = time.monotonic()
        (last,) = electors
        assert _wait(lambda: electors[last].is_leader(), 5.0)
        assert time.monotonic() - t0 >= 0.5     # waited out the TTL
        assert _holder(apiserver) == last
        holders.append(last)
    finally:
        for e in electors.values():
            e.stop()
    assert "ref" in holders or len(set(holders)) == 3
    spec = apiserver._objects[LEASE]["spec"]
    assert spec["holderIdentity"] == ""           # the last one released
    assert spec["leaseTransitions"] >= 3


def test_lease_bodies_equal_reference(monkeypatch):
    """The Lease bodies each package writes for the same contention,
    with time frozen: create, renew, takeover of an empty Lease, release."""
    calls = []
    for kube, leader in ((r_kube, r_leader), (p_kube, p_leader)):
        monkeypatch.setattr(leader.time, "time", lambda: 1_700_000_000.25)
        log = []
        store = {}

        class Client:
            def _json(self, method, path, body=None, _log=log,
                      _kube=kube):
                _log.append((method, path, body))
                if method == "GET":
                    if "lease" not in store:
                        raise _kube.ApiError(404, "")
                    return dict(store["lease"])
                store["lease"] = body
                return body

        e = leader.KubeLeaseElector(Client(), NS, "pool-epp-leader",
                                    identity="me")
        out = [e._tick(), e._tick()]
        store["lease"]["spec"]["holderIdentity"] = ""
        out.append(e._tick())
        e._leader = True
        e.stop()
        calls.append((out, log))
    assert calls[1] == calls[0]
    assert calls[1][0] == [True, True, True]


# -- the actuator's apply path --------------------------------------------


class _Recorder:
    """A kube client core recording each call; GET answers a Deployment."""

    def __init__(self, kube, fail=None):
        self.kube = kube
        self.calls = []
        self.fail = fail or []

    def _json(self, method, path, body=None,
              content_type="application/json"):
        self.calls.append((method, path, body, content_type))
        if self.fail:
            raise self.fail.pop(0)
        if method == "GET":
            return {"spec": {"replicas": 4}}
        return {}


def _actuate(act_mod, rec_mod, kube) -> list:
    out = []
    for dry_run in (False, True):
        for leader in (None, True, False):
            client = _Recorder(kube)
            for target in ("vllm", None):
                act = act_mod.ReplicaActuator(
                    client, "ns", target, dry_run=dry_run,
                    is_leader=None if leader is None else (lambda v=leader: v))
                out.append(act.current_replicas())
                for current, desired in ((3, 3), (3, 5), (4, 1)):
                    out.append(act.apply(rec_mod.Recommendation(
                        0.0, current, desired, "r")))
            out.append(client.calls)
    # A transient error is retried in the call; an apiserver 404 is not.
    client = _Recorder(kube, fail=[ConnectionError("blip")])
    act = act_mod.ReplicaActuator(client, "ns", "vllm")
    out.append(act.apply(rec_mod.Recommendation(0.0, 2, 3, "r")))
    client = _Recorder(kube, fail=[kube.ApiError(404, "gone")])
    act = act_mod.ReplicaActuator(client, "ns", "vllm")
    out.append(act.apply(rec_mod.Recommendation(0.0, 2, 3, "r")))
    out.append([c[0] for c in client.calls])
    client = _Recorder(kube, fail=[kube.ApiError(404, "gone")])
    out.append(act_mod.ReplicaActuator(client, "ns", "vllm")
               .current_replicas())
    return out


def test_actuator_patch_calls_equal_reference():
    ref = _actuate(r_act, r_recommender, r_kube)
    port = _actuate(p_act, p_recommender, p_kube)
    assert port == ref
    # The calls of the first client (no dry run, no leader gate): each
    # target's 1 read and 3 applies come before them.
    patches = [c for c in port[2 * 4] if c[0] == "PATCH"]
    assert patches == [(
        "PATCH",
        "/apis/apps/v1/namespaces/ns/deployments/vllm"
        "?fieldManager=gie-tpu-autoscale&force=true",
        {"apiVersion": "apps/v1", "kind": "Deployment",
         "metadata": {"name": "vllm", "namespace": "ns"},
         "spec": {"replicas": 5}},
        "application/apply-patch+yaml")] + [(
        "PATCH",
        "/apis/apps/v1/namespaces/ns/deployments/vllm"
        "?fieldManager=gie-tpu-autoscale&force=true",
        {"apiVersion": "apps/v1", "kind": "Deployment",
         "metadata": {"name": "vllm", "namespace": "ns"},
         "spec": {"replicas": 1}},
        "application/apply-patch+yaml")]
    assert port[-4:] == ["patched", "error", ["PATCH"], None]


def test_actuator_patches_the_fake_apiserver_keeping_the_spec(apiserver):
    spec = {"replicas": 2, "selector": {"matchLabels": {"app": "vllm"}},
            "template": {"metadata": {"labels": {"app": "vllm"}}}}
    apiserver.apply("deployments", {"kind": "Deployment", "metadata": {
        "name": "vllm", "namespace": NS}, "spec": dict(spec)})
    client = p_kube.KubeClusterClient(NS, "pool", server=apiserver.url,
                                      token="t")
    act = p_act.ReplicaActuator(client, NS, "vllm")
    assert act.current_replicas() == 2
    assert act.apply(p_recommender.Recommendation(0.0, 2, 7, "r")) == (
        "patched")
    got = apiserver._objects[("deployments", NS, "vllm")]["spec"]
    assert got == {**spec, "replicas": 7}
    assert act.current_replicas() == 7
    missing = p_act.ReplicaActuator(client, NS, "absent")
    assert missing.current_replicas() is None
    assert missing.apply(p_recommender.Recommendation(0.0, 1, 2, "r")) == (
        "error")


def test_kube_patch_fault_fires_as_reference():
    out = []
    for act_mod, rec_mod, faults in ((r_act, r_recommender, r_faults),
                                     (p_act, p_recommender, p_faults)):
        class Client:
            def _json(self, *a, **kw):
                raise AssertionError("the fault must intercept the patch")

        faults.install(faults.FaultInjector(
            5, {"kube.patch": faults.FaultRule(p_error=1.0)}))
        try:
            act = act_mod.ReplicaActuator(Client(), NS, target="vllm")
            out.append((act.apply(rec_mod.Recommendation(0.0, 2, 3, "r")),
                        dict(faults.installed().fired),
                        list(faults.installed().log)))
        finally:
            faults.uninstall()
    assert out[1] == out[0]
    assert out[1][0] == "error" and out[1][1] == {"kube.patch": 3}


# -- the runner -----------------------------------------------------------


def _options(argv):
    import argparse

    from gie_tpu_torch.runtime.options import Options

    parser = argparse.ArgumentParser()
    Options.add_flags(parser)
    return Options.from_args(parser.parse_args(argv))


def test_runner_builds_lease_elector_and_apply_actuator(apiserver):
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner
    from gie_tpu_torch.sched import Scheduler

    client = p_kube.KubeClusterClient(NS, "pool", server=apiserver.url,
                                      token="t")
    opts = _options(["--pool-name", "pool", "--no-resilience", "--no-obs",
                     "--leader-elect", "--autoscale-mode", "apply",
                     "--autoscale-target", "vllm"])
    runner = ExtProcServerRunner(opts, client,
                                 scheduler=Scheduler(device="cpu"))
    try:
        assert isinstance(runner.elector, p_leader.KubeLeaseElector)
        assert runner.elector.path.endswith("/leases/pool-epp-leader")
        act = runner.autoscaler.actuator
        assert act.client is client and act.dry_run is False
        assert act.target == "vllm"
        runner.elector.lease_ttl_s = 0.6
        runner.elector.renew_interval_s = 0.05
        runner.elector.start()
        assert _wait(lambda: runner.elector.is_leader())
        assert _holder(apiserver) == runner.elector.identity
        assert runner.ready() is False          # the pool has not synced
        other = _elector(apiserver, r_kube, r_leader, "other")
        other.start()
        try:
            time.sleep(0.25)
            assert not other.is_leader()
        finally:
            other.stop()
    finally:
        runner.stop()
    assert _holder(apiserver) == ""
