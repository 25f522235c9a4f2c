"""The port's multi-cluster controller and InferencePoolImport types against
the reference's.

ClusterSet (gie_tpu_torch/controller/multicluster.py) replays the cases of
tests/test_multicluster_flow.py that need no scheduler: exports
materializing imports in every other member, the Exported condition
(Exported / NotRequested / NotSupported), several exporters merging and
pruning, another controller's import entry kept. Each case's operation
sequence runs through both packages' ClusterSet, and after every step
the imports (as import_to_dict manifests) and each pool's status
(dataclasses.asdict) are equal. The (de)serializers of the types this
slice brings give equal manifests and objects. MultiClusterController,
each package's on its own pair of fake apiservers (tests/fakeapi.py)
through its own package's KubeClusterClient, reconciles the same pool manifests into the same import
objects and Exported conditions, repairs an import deleted out of band
and settles a DELETE that finds nothing. All comparisons are exact."""

import dataclasses
import time

import pytest

from gie_tpu.api import types as r_api
from gie_tpu.controller import multicluster as r_mc
from gie_tpu_torch.api import types as p_api
from gie_tpu_torch.controller import multicluster as p_mc

SIDES = ((r_api, r_mc), (p_api, p_mc))


def make_pool(api, name="pool", scope="ClusterSet", ns="default"):
    annotations = {api.EXPORT_ANNOTATION: scope} if scope else {}
    return api.InferencePool(
        metadata=api.ObjectMeta(name=name, namespace=ns,
                                annotations=annotations),
        spec=api.InferencePoolSpec(
            selector=api.LabelSelector(matchLabels={"app": "vllm"}),
            targetPorts=[api.Port(8000)],
            endpointPickerRef=api.EndpointPickerRef(
                name="epp", port=api.Port(9002))),
    )


def snapshot(api, cs, pools):
    return ({k: api.import_to_dict(v) for k, v in sorted(cs.imports.items())},
            [dataclasses.asdict(p.status) for p in pools])


CASES = {
    "export-materializes-imports": (["east", "west", "south"], [
        ("apply", "east", "pool", "ClusterSet")]),
    "exported-condition": (["east", "west"], [
        ("apply", "east", "pool", "ClusterSet"),
        ("apply", "east", "local", ""),
        ("apply", "west", "other", "Region")]),
    "multiple-exporters-merge-and-prune": (["east", "west", "south"], [
        ("apply", "east", "pool", "ClusterSet"),
        ("apply", "west", "pool", "ClusterSet"),
        ("delete", "east", "pool", None),
        ("delete", "west", "pool", None)]),
    "export-withdrawn-and-readded": (["east", "west"], [
        ("apply", "east", "pool", "ClusterSet"),
        ("apply", "east", "pool", ""),
        ("apply", "east", "pool", "ClusterSet"),
        ("apply", "west", "pool", "Region")]),
    "foreign-controller-entry-kept": (["east", "west"], [
        ("apply", "east", "pool", "ClusterSet"),
        ("foreign", "west", "pool", None),
        ("apply", "east", "pool", "ClusterSet")]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_clusterset_equals_the_reference(case):
    members, steps = CASES[case]
    sets = [mc.ClusterSet(members) for _, mc in SIDES]
    pools = [[], []]
    for op, cluster, name, scope in steps:
        snaps = []
        for (api, mc), cs, mine in zip(SIDES, sets, pools):
            if op == "apply":
                pool = make_pool(api, name, scope)
                cs.apply_pool(cluster, pool)
                mine.append(pool)
            elif op == "delete":
                cs.delete_pool(cluster, "default", name)
            else:
                # Another controller's entry on the import (the importing
                # side's gateway controller): reconcile must keep it.
                imp = cs.get_import(cluster, "default", name)
                imp.status.controllers.append(api.ImportController(
                    name="gateway.example/controller",
                    parents=[api.ParentStatus(
                        parentRef=api.ParentReference(name="gw"))]))
            snaps.append(snapshot(api, cs, mine))
        assert snaps[1] == snaps[0], (op, cluster, name)
    assert r_mc.CONTROLLER_NAME == p_mc.CONTROLLER_NAME
    assert (r_mc.ROUTING_MODE_ENDPOINT, r_mc.ROUTING_MODE_PARENT) == (
        p_mc.ROUTING_MODE_ENDPOINT, p_mc.ROUTING_MODE_PARENT)


def test_unknown_member_and_invalid_pool_are_refused():
    for api, mc in SIDES:
        cs = mc.ClusterSet(["east"])
        with pytest.raises(ValueError):
            cs.apply_pool("north", make_pool(api))
        with pytest.raises(api.ValidationError):
            cs.apply_pool("east", make_pool(api, name="Bad_Name"))


def test_serializers_equal_the_reference():
    manifests = []
    for api, mc in SIDES:
        pool = make_pool(api)
        cs = mc.ClusterSet(["east", "west"])
        cs.apply_pool("east", pool)
        imp = cs.get_import("west", "default", "pool")
        d_pool = api.pool_to_dict(pool)
        d_imp = api.import_to_dict(imp)
        back = api.pool_from_dict(d_pool)
        manifests.append((
            d_pool, d_imp,
            api.import_to_dict(api.import_from_dict(d_imp)),
            dataclasses.asdict(back),
            api.import_to_dict(api.InferencePoolImport(
                metadata=api.ObjectMeta(name="x"))),
            api.clean_manifest({"a": [], "b": {"c": ""}, "d": [1, {}]}),
            pool.export_requested,
            (api.GROUP_X, api.VERSION_X, api.EXPORT_ANNOTATION,
             api.EXPORT_SCOPE_CLUSTERSET, api.COND_EXPORTED,
             api.REASON_EXPORTED, api.REASON_NOT_REQUESTED,
             api.REASON_NOT_SUPPORTED)))
    assert manifests[1] == manifests[0]


def test_parent_status_caps_conditions_like_the_reference():
    out = []
    for api, _ in SIDES:
        ps = api.ParentStatus()
        for i in range(8):
            ps.set_condition(api.Condition(f"T{i}", "True"))
        ps.set_condition(api.Condition("T3", "False", "R"))
        with pytest.raises(api.ValidationError):
            ps.set_condition(api.Condition("T8", "True"))
        with pytest.raises(api.ValidationError):
            api.InferencePoolStatus(parents=[ps] * 33).validate()
        out.append((dataclasses.asdict(ps),
                    ps.get_condition("T3").to_dict()))
    assert out[1] == out[0]


# -- the controller over live watches --------------------------------------


def _manifest(name="pool", export=True, labels=None):
    meta = {"name": name, "namespace": "default",
            "annotations": ({r_api.EXPORT_ANNOTATION:
                             r_api.EXPORT_SCOPE_CLUSTERSET}
                            if export else {})}
    if labels:
        meta["labels"] = labels
    return {
        "apiVersion": f"{r_api.GROUP}/{r_api.VERSION}",
        "kind": "InferencePool", "metadata": meta,
        "spec": {"selector": {"matchLabels": {"app": "vllm"}},
                 "targetPorts": [{"number": 8000}],
                 "endpointPickerRef": {"name": "epp",
                                       "port": {"number": 9002}}},
    }


def _wait(pred, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def _conditions(server):
    """The Exported conditions patched onto east's pools, without their
    wall-clock transition times."""
    out = []
    for ns, name, patch in server.status_patches:
        for parent in patch.get("status", patch).get("parents", []):
            for c in parent.get("conditions", []):
                out.append((ns, name, parent["parentRef"].get("kind"),
                            c["type"], c["status"], c.get("reason")))
    return out


def _drive(mc):
    """Export, repair an out-of-band deletion, withdraw onto a DELETE that
    finds nothing; the imports seen at each step and the conditions."""
    from gie_tpu.controller import kube as r_kube
    from gie_tpu_torch.controller import kube as p_kube
    from tests.fakeapi import FakeKubeApiServer

    client = (p_kube if mc is p_mc else r_kube).KubeClusterClient
    east, west = FakeKubeApiServer(), FakeKubeApiServer()
    ctl = mc.MultiClusterController({
        "east": client("default", "pool", server=east.url),
        "west": client("default", "pool", server=west.url),
    })
    ctl.start()
    key = ("imports", "default", "pool")
    seen = []

    def body():
        obj = dict(west._objects[key])
        meta = {k: v for k, v in obj["metadata"].items()
                if k in ("name", "namespace")}
        return {**obj, "metadata": meta}

    try:
        east.apply("pools", _manifest())
        assert _wait(lambda: key in west._objects)
        assert key not in east._objects
        assert _wait(lambda: any(n == "pool" for _ns, n, _p
                                 in east.status_patches))
        seen.append(body())
        west.delete("imports", "default", "pool")
        east.apply("pools", _manifest(labels={"touched": "1"}))
        assert _wait(lambda: key in west._objects)
        seen.append(body())
        west.delete("imports", "default", "pool")
        east.apply("pools", _manifest(export=False))
        assert _wait(lambda: not ctl._written)
        assert key not in west._objects
        time.sleep(0.3)
        return seen, _conditions(east)
    finally:
        ctl.stop()
        east.close()
        west.close()


def test_controller_over_live_watches_equals_the_reference():
    ref, port = _drive(r_mc), _drive(p_mc)
    assert port == ref
    seen, conds = ref
    assert seen[0]["status"]["controllers"][0]["exportingClusters"] == [
        {"name": "east"}]
    assert ("default", "pool", "InferencePoolImport", "Exported", "True",
            "Exported") in conds
