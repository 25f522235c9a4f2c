"""The port's API layer (gie_tpu_torch/api, version.py) against the
reference's (gie_tpu/api), side by side on the CPU.

  cel           every expression and admission case of the reference's
                tests/test_cel_rules.py, as one parametrised table: the
                port's evaluator gives the same value or raises the same
                error class with the same message; admission (defaults,
                then every committed rule) gives the same failure list on
                the committed CRD, broken rules included, and agrees with
                both packages' validate();
  crdgen        generate(out_dir) writes files byte-equal to the
                reference's and to config/crd/bases/, every rule inside
                the port's supported subset, and an unsupported rule is
                refused the same way;
  informers     one event script through both packages' FakeCluster and
                SharedInformerFactory: the handlers' event logs and the
                listers' contents equal;
  apply         the apply builders' dicts and ssa_merge over seeded
                nested dicts equal; server-side apply, status updates and
                the YAML round trip through InferencePoolClient give equal
                manifests and equal recorded actions;
  modelrewrite  RewriteEngine under one seed resolves the same sequence;
  gateway       the Gateway API types' fields, defaults and condition
                bookkeeping equal.
"""

import copy
import dataclasses
import filecmp
import os

import numpy as np
import pytest
import yaml

from gie_tpu.api import applyconfiguration as r_apply
from gie_tpu.api import cel as r_cel
from gie_tpu.api import client as r_client
from gie_tpu.api import crdgen as r_crdgen
from gie_tpu.api import gateway as r_gw
from gie_tpu.api import informers as r_inf
from gie_tpu.api import modelrewrite as r_mr
from gie_tpu.api import types as r_api
from gie_tpu.controller import cluster as r_cluster
from gie_tpu.datastore import objects as r_obj
from gie_tpu_torch.api import applyconfiguration as p_apply
from gie_tpu_torch.api import cel as p_cel
from gie_tpu_torch.api import client as p_client
from gie_tpu_torch.api import crdgen as p_crdgen
from gie_tpu_torch.api import gateway as p_gw
from gie_tpu_torch.api import informers as p_inf
from gie_tpu_torch.api import modelrewrite as p_mr
from gie_tpu_torch.api import types as p_api
from gie_tpu_torch.controller import cluster as p_cluster
from gie_tpu_torch.datastore import objects as p_obj
from tests.test_cel_rules import CRD_PATH, SPEC_VECTORS_TRUE, base_pool_dict

SEED = 15
CRD_DIR = os.path.dirname(CRD_PATH)


def _outcome(fn, *args):
    """What a call gives: its value, or its error's class name and text."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the comparison is the point
        return ("error", type(e).__name__, str(e))


def _both(name, *args):
    """The outcome of cel.<name>(*args) in the reference and the port."""
    return (_outcome(getattr(r_cel, name), *args),
            _outcome(getattr(p_cel, name), *args))


# -- cel ------------------------------------------------------------------

_ERR = "boom.missing"
# (expression, the value bound to `self`): every evaluate_rule call of the
# reference's tests/test_cel_rules.py.
CEL_CASES = [
    ("self == 3", 3), ("self != 3", 3),
    ("self.all(x, x > 0)", [1, 2, 3]), ("self.all(x, x > 0)", [1, -2]),
    ("self.exists_one(x, x == 2)", [1, 2, 3]),
    ("self.exists_one(x, x == 2)", [2, 2]),
    ("has(self.a)", {"a": 1}), ("has(self.a)", {"b": 1}),
    ("size(self) <= 2", [1, 2]), ("self.startsWith('ab')", "abc"),
    ("'x' in self", ["x", "y"]), ("!(self > 2) || self == 9", 9),
    ("self.kind != 'Service' || has(self.port)", {"kind": "Other"}),
    ("self.missing == 1", {"present": 1}), ("self ==", 1),
    ("self < 'a'", 1), ("self.matches('[')", "abc"),
    ("self.all(p1, self.exists_one(p2, p1.number==p2.number))",
     [{"number": 1}, {"number": 2}]),
    ("self.all(p1, self.exists_one(p2, p1.number==p2.number))",
     [{"number": 1}, {"number": 1}]),
    (f"true || {_ERR}", None), (f"{_ERR} || true", None),
    (f"false && {_ERR}", None), (f"{_ERR} && false", None),
    (f"false || {_ERR}", None), (f"true && {_ERR}", None),
    (f"{_ERR} || {_ERR}", None),
    ("size(self) == 3", "ééé"), ("self.size() == 1", "\U0001f600"),
    ("1 == 1.0", None), ("self == 'x'", 1), ("self != 'x'", 1),
] + [(expr, None) for expr in SPEC_VECTORS_TRUE]

# validate_rule_support's cases: the reference's unsupported features and
# syntax, and the committed rules.
SUPPORT_CASES = [
    "int(self) == 1", "self.map(x, x).min() == 1",
    "duration(self) < duration('1s')", "self.orValue(1) == 1",
    "self.matches('(?=lookahead)')", "self.matches('(a)\\\\1')",
    "self.matches('(?P<a>x)(?P=a)')", "self.matches('(?(1)a|b)')",
    "self == '\\n'", "self ? 1 : 2", "self * 2 == 4", "self % 2 == 0",
    "self / 2 == 1", "1u == 1u", "b'x' == b'x'",
]


@pytest.mark.parametrize("expr, value", CEL_CASES,
                         ids=[f"{i}" for i in range(len(CEL_CASES))])
def test_cel_evaluate_rule_equal_reference(expr, value):
    ref, port = _both("evaluate_rule", expr, value)
    assert port == ref
    compiled = [_outcome(mod.compile_rule, expr) for mod in (r_cel, p_cel)]
    assert compiled[1][0] == compiled[0][0]
    if compiled[1][0] == "ok":
        assert (_outcome(compiled[1][1], value)
                == _outcome(compiled[0][1], value))


@pytest.mark.parametrize("rule", SUPPORT_CASES)
def test_cel_support_gate_equal_reference(rule):
    ref, port = _both("validate_rule_support", rule)
    assert port == ref
    assert port[0] == "error"


@pytest.fixture(scope="module")
def schemas():
    with open(CRD_PATH) as f:
        crd = yaml.safe_load(f)
    return r_cel.crd_schema(crd), p_cel.crd_schema(crd)


def _manifests() -> dict:
    """The admission scenarios of the reference's CEL tests."""
    out = {"valid": base_pool_dict()}
    obj = base_pool_dict()
    obj["spec"]["appProtocol"] = "kubernetes.io/h2c"
    out["h2c"] = obj
    obj = base_pool_dict()
    del obj["spec"]["endpointPickerRef"]["kind"]
    del obj["spec"]["endpointPickerRef"]["port"]
    out["kind-unset-portless"] = obj
    obj = base_pool_dict()
    del obj["spec"]["endpointPickerRef"]["port"]
    out["service-portless"] = obj
    obj = copy.deepcopy(obj)
    obj["spec"]["endpointPickerRef"]["kind"] = "EndpointPicker"
    out["picker-portless"] = obj
    for name, ports in (("unique", (8000, 80, 8081, 443)),
                        ("duplicate", (8000, 80, 8000, 443)),
                        ("duplicate-pair", (80, 80))):
        obj = base_pool_dict()
        obj["spec"]["targetPorts"] = [{"number": n} for n in ports]
        out[name] = obj
    return out


MANIFESTS = _manifests()


@pytest.mark.parametrize("name", list(MANIFESTS))
def test_cel_admission_equal_reference(schemas, name):
    verdicts = []
    for mod, schema, api in ((r_cel, schemas[0], r_api),
                             (p_cel, schemas[1], p_api)):
        manifest = copy.deepcopy(MANIFESTS[name])
        defaulted = mod.apply_defaults(schema, manifest)
        failures = mod.validate_against_schema(schema, defaulted)
        pool = api.pool_from_dict(MANIFESTS[name])
        try:
            pool.validate()
            valid = True
        except api.ValidationError:
            valid = False
        verdicts.append((defaulted, failures, valid))
    assert verdicts[1] == verdicts[0]
    _, failures, valid = verdicts[1]
    assert (failures == []) == valid


@pytest.mark.parametrize("rule", [
    "self.all(p1, self.exists_one(",
    "self.all(p1, p1.nunber > 0)",
])
def test_cel_broken_committed_rule_equal_reference(schemas, rule):
    got = []
    for mod, schema in ((r_cel, schemas[0]), (p_cel, schemas[1])):
        broken = copy.deepcopy(schema)
        tp = broken["properties"]["spec"]["properties"]["targetPorts"]
        tp["x-kubernetes-validations"][0]["rule"] = rule
        got.append(mod.validate_against_schema(
            broken, mod.apply_defaults(broken, base_pool_dict())))
    assert got[1] == got[0]
    assert any("rule error" in f for f in got[1])


# -- crdgen ---------------------------------------------------------------


def test_crdgen_byte_equal_reference_and_committed(tmp_path):
    ref = r_crdgen.generate(str(tmp_path / "ref"))
    port = p_crdgen.generate(str(tmp_path / "port"))
    assert [os.path.basename(p) for p in port] == [
        os.path.basename(p) for p in ref]
    for r, p in zip(ref, port):
        committed = os.path.join(CRD_DIR, os.path.basename(p))
        assert filecmp.cmp(p, r, shallow=False), p
        assert filecmp.cmp(p, committed, shallow=False), p
    rules = [list(p_cel.iter_rules(crd)) for crd in (
        p_crdgen.inferencepool_crd(), p_crdgen.inferencepoolimport_crd())]
    assert sum(map(len, rules)) >= 2
    for rule in sum(rules, []):
        p_cel.validate_rule_support(rule)
    assert rules == [list(r_cel.iter_rules(crd)) for crd in (
        r_crdgen.inferencepool_crd(), r_crdgen.inferencepoolimport_crd())]


def test_crdgen_refuses_unsupported_rule_as_reference(tmp_path, monkeypatch):
    errors = []
    for mod in (r_crdgen, p_crdgen):
        broken = mod.inferencepool_crd()
        broken["spec"]["versions"][0]["schema"]["openAPIV3Schema"].setdefault(
            "x-kubernetes-validations", []).append(
            {"rule": "duration(self.x) < duration('1s')", "message": "no"})
        monkeypatch.setattr(mod, "inferencepool_crd", lambda b=broken: b)
        with pytest.raises(ValueError, match="supported CEL subset") as e:
            mod.generate(str(tmp_path / mod.__name__))
        errors.append(str(e.value))
    assert errors[1] == errors[0]


def test_version_equals_reference():
    import gie_tpu.version as r_version
    import gie_tpu_torch.version as p_version

    for name in ("__version__", "BUNDLE_VERSION",
                 "BUNDLE_VERSION_ANNOTATION"):
        assert getattr(p_version, name) == getattr(r_version, name)


# -- informers ------------------------------------------------------------


def _pool(api, name="pool", ports=(8000,)):
    return api.InferencePool(
        metadata=api.ObjectMeta(name=name),
        spec=api.InferencePoolSpec(
            selector=api.LabelSelector(matchLabels={"app": "m"}),
            targetPorts=[api.Port(p) for p in ports],
            endpointPickerRef=api.EndpointPickerRef(
                name="epp", port=api.Port(9002))))


def _informer_script(api, cluster_mod, inf_mod, obj_mod) -> list:
    """A seeded run of adds, updates and deletes over pods and pools in
    two namespaces, with a handler registered before start and one after:
    the event logs and the listers' contents after every step."""
    rng = np.random.default_rng(SEED)
    cluster = cluster_mod.FakeCluster()
    cluster.apply_pool(_pool(api))
    cluster.apply_pod(obj_mod.Pod(name="p0", labels={"app": "m"},
                                  ip="10.0.0.1"))
    factory = inf_mod.SharedInformerFactory(cluster, "default",
                                            pool_names=["pool"])
    log = []
    factory.pods().add_event_handler(
        lambda t, key, obj: log.append(
            ("pod", t, key, obj and obj.ip)))
    factory.pools().add_event_handler(
        lambda t, key, obj: log.append(
            ("pool", t, key, obj and [p.number
                                      for p in obj.spec.targetPorts])))
    out = [factory.wait_for_cache_sync()]
    factory.start()
    out.append(factory.wait_for_cache_sync())
    late = []
    factory.pods().add_event_handler(
        lambda t, key, obj: late.append((t, key)))
    for step in range(40):
        op = int(rng.integers(0, 4))
        name = f"p{int(rng.integers(0, 6))}"
        ns = "default" if rng.random() < 0.8 else "other"
        if op <= 1:
            cluster.apply_pod(obj_mod.Pod(
                name=name, namespace=ns, labels={"app": "m"},
                ip=f"10.0.{step}.{int(rng.integers(1, 250))}"))
        elif op == 2:
            cluster.delete_pod(ns, name)
        else:
            cluster.apply_pool(_pool(api, ports=(8000 + step,)))
        pods = factory.pods().lister()
        out.append(sorted((p.namespace, p.name, p.ip)
                          for p in pods.list()))
        out.append([p.number for p in factory.pools().lister().get(
            "default", "pool").spec.targetPorts])
    return out + [log, late]


def test_informers_equal_reference():
    ref = _informer_script(r_api, r_cluster, r_inf, r_obj)
    port = _informer_script(p_api, p_cluster, p_inf, p_obj)
    assert port == ref
    assert ref[0] is False and ref[1] is True


# -- applyconfiguration, ssa_merge and the typed client -------------------


def _full_cfg(mod, name="pool-a"):
    return mod.InferencePoolApply(name, "default").with_labels(
        {"team": "a"}).with_spec(
        mod.InferencePoolSpecApply()
        .with_selector({"app": "model"})
        .with_target_ports(8000, 8001)
        .with_app_protocol("http")
        .with_endpoint_picker_ref(
            mod.EndpointPickerApply().with_group("").with_name("epp")
            .with_kind("Service").with_port(9002)
            .with_failure_mode("FailOpen")))


def _random_tree(rng, depth=0):
    """A seeded nested dict of scalars, lists and dicts."""
    out = {}
    for i in range(int(rng.integers(1, 5))):
        key = f"k{int(rng.integers(0, 6))}"
        kind = int(rng.integers(0, 4 if depth < 3 else 3))
        if kind == 0:
            out[key] = int(rng.integers(0, 100))
        elif kind == 1:
            out[key] = [int(x) for x in rng.integers(0, 9, 3)]
        elif kind == 2:
            out[key] = None if rng.random() < 0.3 else f"s{i}"
        else:
            out[key] = _random_tree(rng, depth + 1)
    return out


def test_apply_builders_and_ssa_merge_equal_reference():
    rng = np.random.default_rng(SEED)
    for _ in range(50):
        base, patch = _random_tree(rng), _random_tree(rng)
        before = copy.deepcopy((base, patch))
        got = [mod.ssa_merge(base, patch) for mod in (r_apply, p_apply)]
        assert got[1] == got[0]
        assert (base, patch) == before           # inputs untouched
    dicts = [_full_cfg(mod).to_dict() for mod in (r_apply, p_apply)]
    assert dicts[1] == dicts[0]
    sparse = [mod.InferencePoolApply("p", "ns").with_spec(
        mod.InferencePoolSpecApply().with_target_ports(8000)).to_dict()
        for mod in (r_apply, p_apply)]
    assert sparse[1] == sparse[0] == {
        **sparse[0], "spec": {"targetPorts": [{"number": 8000}]}}
    fresh = [r_api.pool_to_dict(r_apply.apply_pool_configuration(
                 None, _full_cfg(r_apply, "fresh"))),
             p_api.pool_to_dict(p_apply.apply_pool_configuration(
                 None, _full_cfg(p_apply, "fresh")))]
    assert fresh[1] == fresh[0]


def _client_script(api, apply_mod, client_mod, cluster_mod) -> list:
    """Server-side apply, a narrowing re-apply, a rejected apply, a status
    update, YAML round trip and delete through InferencePoolClient."""
    cluster = cluster_mod.FakeCluster()
    client = client_mod.InferencePoolClient(cluster)
    out = [api.pool_to_dict(client.server_side_apply(_full_cfg(apply_mod)))]
    narrow = apply_mod.InferencePoolApply("pool-a", "default").with_spec(
        apply_mod.InferencePoolSpecApply().with_target_ports(9000))
    out.append(api.pool_to_dict(client.server_side_apply(narrow)))
    dup = apply_mod.InferencePoolApply("pool-a", "default").with_spec(
        apply_mod.InferencePoolSpecApply().with_target_ports(8000, 8000))
    out.append(_outcome(client.server_side_apply, dup)[:2])
    pool = client.get("pool-a", "default")
    status = api.InferencePoolStatus(parents=[api.ParentStatus(
        parentRef=api.ParentReference(name="gw"),
        conditions=[api.Condition(api.COND_ACCEPTED, "True",
                                  api.REASON_ACCEPTED, "ok")])])
    out.append(api.pool_to_dict(client.update_status(pool, status)))
    text = client.to_yaml(pool)
    out += [text, api.pool_to_dict(client.from_yaml(text))]
    client.delete("pool-a", "default")
    out.append(client.get("pool-a", "default"))
    out.append([(v, r, k) for v, r, k in cluster.actions])
    return out


def test_typed_client_equal_reference():
    ref = _client_script(r_api, r_apply, r_client, r_cluster)
    port = _client_script(p_api, p_apply, p_client, p_cluster)
    assert port == ref
    assert ref[2][0] == "error" and ref[-2] is None


# -- modelrewrite ---------------------------------------------------------


def _rewrites(mod) -> list:
    eng = mod.RewriteEngine(seed=SEED)
    eng.apply(mod.InferenceModelRewrite(
        name="generic", pool_ref="pool",
        rules=[mod.RewriteRule(targets=[mod.TargetModel("fallback")])]))
    eng.apply(mod.InferenceModelRewrite(
        name="split", pool_ref="pool",
        rules=[mod.RewriteRule(
            matches=[mod.ModelMatch("base")],
            targets=[mod.TargetModel("a", 5), mod.TargetModel("b", 2),
                     mod.TargetModel("c", 0)]),
            mod.RewriteRule(matches=[mod.ModelMatch("m2")],
                            targets=[mod.TargetModel("z", 0)])]))
    eng.apply(mod.InferenceModelRewrite(
        name="newer", pool_ref="pool", namespace="default",
        rules=[mod.RewriteRule(matches=[mod.ModelMatch("base")],
                               targets=[mod.TargetModel("never")])]))
    rng = np.random.default_rng(SEED)
    models = ["base", "m2", "other", "base"]
    out = [eng.resolve("pool", models[int(rng.integers(0, 4))])
           for _ in range(300)]
    out.append(eng.resolve("other-pool", "base"))
    out.append(eng.resolve("pool", "base", namespace="elsewhere"))
    eng.delete("default", "split")
    out.append(eng.resolve("pool", "base"))
    return out


def test_modelrewrite_picks_equal_reference():
    ref, port = _rewrites(r_mr), _rewrites(p_mr)
    assert port == ref
    # The older resource's rule wins until it is deleted.
    assert {"a", "b", "z", "fallback"} <= set(ref[:300])
    assert "never" not in ref[:300] and ref[-1] == "never"


# -- gateway types --------------------------------------------------------


def _gateway_objects(gw, api) -> list:
    route = gw.HTTPRoute(
        name="r", hostnames=["x.example.com"], parent_gateways=["g1", "g2"],
        rules=[gw.RouteRule(path_prefix="/v1", backend_refs=[
            gw.BackendRef(name="pool"),
            gw.BackendRef(name="svc", kind="Service", port=80, weight=3)])])
    ps = route.parent_status("g1")
    ps.set_condition(api.Condition(gw.ROUTE_ACCEPTED, "True",
                                   gw.ROUTE_REASON_ACCEPTED, "ok"))
    ps.set_condition(api.Condition(gw.ROUTE_RESOLVED_REFS, "False",
                                   gw.ROUTE_REASON_BACKEND_NOT_FOUND, "no"))
    ps.set_condition(api.Condition(gw.ROUTE_ACCEPTED, "False", "x", "y"))
    assert route.parent_status("g1") is ps
    return [dataclasses.asdict(o) for o in (
        gw.Gateway("g1"), gw.Service("epp"), route)] + [
        dataclasses.asdict(ps.get_condition(gw.ROUTE_ACCEPTED)),
        ps.get_condition("Missing")]


def test_gateway_types_equal_reference():
    ref, port = _gateway_objects(r_gw, r_api), _gateway_objects(p_gw, p_api)
    assert port == ref
    back = p_gw.HTTPRoute(**{**port[2], "rules": [
        p_gw.RouteRule(r["path_prefix"],
                       [p_gw.BackendRef(**b) for b in r["backend_refs"]])
        for r in port[2]["rules"]], "status": []})
    assert dataclasses.asdict(back)["rules"] == ref[2]["rules"]
