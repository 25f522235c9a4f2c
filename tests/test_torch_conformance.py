"""The conformance suite against the port (gie_tpu_torch/conformance): every
case of tests/test_conformance.py but the meshed one (the port's copies
in gie_tpu_torch/conformance/suite.py), each run with the round-robin EPP
("rr") and with the port's batched Scheduler behind BatchingTPUPicker on
the CPU ("tpu"), then a parity case, the meshed mode on the CPU and the
reports.

  cases    the 15 Gateway-profile cases over the shared base environment,
           the zero-misroute routing case and the two multi-cluster
           routing modes, with the reference suite's checks;
  parity   one scenario (steered subsets, DP ranks, unsteered traffic, a
           weighted split, fail-open and fail-close with the EPP scaled
           to zero, served-endpoint echo, a 404) through the reference's
           harness and the port's, both seeded alike and "tpu" with the
           port's Scheduler replaying the reference's noise: equal status
           codes, headers, bodies and serving pods;
  meshed   "tpu-mesh" serves a Scheduler over every virtual CPU position
           (dp 8, tp 1) and passes every case, and an unknown mode is
           refused;
  report   each mode's ConformanceReport records every case passed, and
           suite.run() gives the same verdicts.
"""

import json

import pytest

from gie_tpu_torch.api import types as api
from gie_tpu_torch.conformance import ConformanceEnv, ConformanceReport, suite
from gie_tpu_torch.conformance.harness import build_base_env
from gie_tpu_torch.extproc import metadata as mdkeys

MODES = ("rr", "tpu")
REPORTS = {mode: ConformanceReport() for mode in MODES + ("tpu-mesh",)}
CASES = list(suite.BASE_CASES) + list(suite.OWN_CASES)


def env_kwargs(mode: str) -> dict:
    """The port's "tpu" EPPs run their Scheduler on the CPU here."""
    return {"picker_mode": mode, "device": "cpu"}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_conformance_case(case, mode):
    try:
        suite.run_case(case, **env_kwargs(mode))
    except Exception:
        REPORTS[mode].add(case, False)
        raise
    REPORTS[mode].add(case, True)


@pytest.mark.parametrize("case", CASES)
def test_conformance_case_meshed(case):
    """Every case through "tpu-mesh": the --mesh-devices production path
    on the CPU's virtual positions."""
    try:
        suite.run_case(case, **env_kwargs("tpu-mesh"))
    except Exception:
        REPORTS["tpu-mesh"].add(case, False)
        raise
    REPORTS["tpu-mesh"].add(case, True)


def test_meshed_mode_raises_not_ported():
    """Not refused any more: "tpu-mesh" builds its EPP over the meshed
    Scheduler on the CPU (test_conformance_case_meshed runs the suite
    through it)."""
    env = ConformanceEnv(picker_mode="tpu-mesh", device="cpu")
    try:
        env.apply_pool(suite.make_pool("pool-mesh", {"app": "primary"}))
        (epp,) = env.epps.values()
        assert epp.server.picker.scheduler.mesh.shape == {"dp": 8, "tp": 1}
    finally:
        env.close()
    with pytest.raises(ValueError, match="unknown picker_mode"):
        ConformanceEnv(picker_mode="nope").apply_pool(
            suite.make_pool("p", {"app": "primary"}))


def parity_scenario(env, gw, api_mod, mdkeys_mod) -> list:
    """One seeded scenario over the base environment: -> every response
    as (status, headers, body, pod, protocol, what the pod received)."""
    def pool(name, selector, ports=(8000,), failure_mode=None):
        return api_mod.InferencePool(
            metadata=api_mod.ObjectMeta(name=name),
            spec=api_mod.InferencePoolSpec(
                selector=api_mod.LabelSelector(matchLabels=selector),
                targetPorts=[api_mod.Port(p) for p in ports],
                endpointPickerRef=api_mod.EndpointPickerRef(
                    name="epp-svc", port=api_mod.Port(9002),
                    failureMode=failure_mode or api_mod.FAIL_CLOSE)))

    def route(name, gateway, refs, path="/"):
        return gw.HTTPRoute(name=name, parent_gateways=[gateway], rules=[
            gw.RouteRule(path_prefix=path, backend_refs=[
                gw.BackendRef(name=n, weight=w) for n, w in refs])])

    env.apply_pool(pool("pool-a", {"app": "primary"}, ports=(8000, 8002),
                        failure_mode=api_mod.FAIL_OPEN))
    env.apply_pool(pool("pool-b", {"app": "secondary"}, ports=(8001,)))
    env.apply_route(route("r-a", "primary-gateway", [("pool-a", 1)]))
    env.apply_route(route("r-w", "primary-gateway",
                          [("pool-a", 3), ("pool-b", 1)], path="/w"))
    env.apply_route(route("r-b", "secondary-gateway", [("pool-b", 1)]))
    pods = sorted((p for p in env.cluster.list_pods("default")
                   if p.labels.get("app") == "primary"),
                  key=lambda p: p.name)
    sel = mdkeys_mod.TEST_ENDPOINT_SELECTION_HEADER
    sends = []
    for k in (1, 2, 3):
        steer = ",".join(p.ip for p in pods[:k])
        sends += [("primary-gateway", "/", {sel: steer}, b"")] * 12
    sends += [("primary-gateway", "/", {sel: f"{pods[1].ip}:8002"}, b"")]
    body = json.dumps({"model": "m", "prompt": "hi", "max_tokens": 9})
    for i in range(40):
        gateway = "secondary-gateway" if i % 5 == 4 else "primary-gateway"
        path = "/w" if i % 3 == 0 else "/"
        sends.append((gateway, path, {}, body.encode() if i % 2 else b""))
    out = [env.send(g, "x", p, headers=h, body=b) for g, p, h, b in sends]
    env.scale_epp("default", "pool-a", 0)
    env.scale_epp("default", "pool-b", 0)
    out += [env.send("primary-gateway", "x", "/") for _ in range(5)]
    out.append(env.send("secondary-gateway", "x", "/"))
    out.append(env.send("no-such-gateway", "x", "/"))
    statuses = {(p.parentRef.name, c.type, c.status, c.reason)
                for name in ("pool-a", "pool-b")
                for p in env.get_pool("default", name).status.parents
                for c in p.conditions}
    return [(r.status, r.headers, r.body, r.backend_pod, r.protocol,
             r.backend_received) for r in out] + [sorted(statuses)]


@pytest.mark.parametrize("parity_mode", MODES)
def test_responses_equal_reference_harness(parity_mode):
    from conformance.harness import build_base_env as ref_base_env
    from gie_tpu.api import gateway as r_gw
    from gie_tpu.api import types as r_api
    from gie_tpu.extproc import metadata as r_mdkeys
    from gie_tpu_torch.api import gateway as p_gw
    from tests.test_torch_slice import jax_noise_replay

    ref_env = ref_base_env()
    ref_env.picker_mode = parity_mode
    port_env = build_base_env(picker_mode=parity_mode, device="cpu",
                              noise_source=jax_noise_replay(0))
    try:
        ref = parity_scenario(ref_env, r_gw, r_api, r_mdkeys)
        port = parity_scenario(port_env, p_gw, api, mdkeys)
    finally:
        ref_env.close()
        port_env.close()
    assert port == ref
    served = {r[3] for r in port[:-1] if r[0] == 200}
    assert any(s.startswith("primary-") for s in served)
    assert any(s.startswith("secondary-") for s in served)


def test_zzz_emit_report(tmp_path, monkeypatch):
    """Each mode's versioned ConformanceReport records every case passed
    (this runs last in the file); suite.run() records the same verdicts
    (its cases stubbed: they ran above)."""
    for mode, report in REPORTS.items():
        path = tmp_path / f"report-{mode}.yaml"
        report.write(str(path))
        text = path.read_text()
        assert "ConformanceReport" in text and "Passed" in text
        assert sorted(r.short_name for r in report.results) == sorted(CASES)
        assert all(r.passed for r in report.results), mode
    failing = CASES[3]

    def run_case(name, **kwargs):
        if name == failing:
            raise suite.ConformanceFailure("stubbed failure")

    monkeypatch.setattr(suite, "run_case", run_case)
    report, errors = suite.run(picker_mode="rr")
    assert [(r.short_name, r.passed) for r in report.results] == [
        (name, name != failing) for name in CASES]
    assert list(errors) == [failing] and "stubbed failure" in errors[failing]
