"""The port's gie-learn judge against the reference's judge on the CPU.

Each judged scenario runs the storm twin twice at one seed, with the
heuristic blend and with the artifact's exponents. Here the reference
judge (gie_tpu.learn.judge, JAX on the CPU) and the port's
(gie_tpu_torch.learn.judge on device="cpu") judge the shipped artifact on
the recorded trace fixture and on a short storm-equivalence (duration
cut to 3 s), the port's engines taking the reference scheduler's Gumbel
draws (jax_noise_replay(0): the reference engine seeds its Scheduler with
PRNGKey(0), and a fresh replay per engine run). The judgments must be
equal field for field, decision fingerprints included, and on the trace
the port's row must equal the one the shipped artifact records.
"""

import pytest

from gie_tpu.learn import judge as ref_judge
from gie_tpu.resilience import faults as ref_faults
from gie_tpu_torch.learn import artifact, judge
from gie_tpu_torch.resilience import faults as port_faults
from tests.test_torch_slice import jax_noise_replay

ARTIFACT = "config/policy/storm-lora-v1.json"
TRACE = "tests/fixtures/learn/storm-fixture-flightrec.json"


@pytest.fixture(autouse=True)
def _clean_globals():
    for faults in (ref_faults, port_faults):
        faults.uninstall()
        faults.set_clock(None)
    yield
    for faults in (ref_faults, port_faults):
        faults.uninstall()
        faults.set_clock(None)


def _both(**kw):
    art = artifact.load_artifact(ARTIFACT)
    ref = ref_judge.judge(art, **kw)
    ref_faults.set_clock(None)
    port = judge.judge(art, device="cpu",
                       noise_sources=lambda: jax_noise_replay(0), **kw)
    return art, ref, port


def test_trace_judgment_equals_the_reference_and_the_shipped_one():
    art, ref, port = _both(trace_dumps=(TRACE,))
    judge.validate(port)
    assert port == ref
    (row,) = port["scenarios"]
    assert row["kind"] == "trace_replay" and row["learned"]["completed"] > 0
    shipped = {r["name"]: r for r in art["judgment"]["scenarios"]}
    assert row == shipped[f"trace:{TRACE}"]
    assert (row["heuristic"]["decision_fingerprint"]
            != row["learned"]["decision_fingerprint"])


def test_short_storm_judgment_equals_the_reference():
    _, ref, port = _both(scenarios=("storm-equivalence",), duration_s=3.0)
    assert port == ref
    assert port["scenarios"][0]["learned"]["completed"] > 0


def test_judgment_validation_matches_reference():
    good = {"schema": judge.SCHEMA, "promote": True, "scenarios": [{
        "name": "x", "kind": "storm", "seed": 1, "schedule_fingerprint": "f",
        "heuristic": {"schedule_fingerprint": "f"},
        "learned": {"schedule_fingerprint": "f"}, "gates": {},
        "passed": True}]}
    judge.validate(good)
    bad = [
        {**good, "schema": "other/1"},
        {**good, "scenarios": []},
        {**good, "promote": False},
        {**good, "scenarios": [{**good["scenarios"][0],
                                "learned": {"schedule_fingerprint": "g"}}]},
        {**good, "scenarios": [{"name": "x"}]},
    ]
    for case in bad:
        with pytest.raises(ValueError) as port_err:
            judge.validate(case)
        with pytest.raises(ValueError) as ref_err:
            ref_judge.validate(case)
        assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="at least one scenario"):
        judge.judge(artifact.load_artifact(ARTIFACT), device="cpu")
    assert judge.policy_weights_spec(artifact.load_artifact(ARTIFACT)) == (
        ref_judge.policy_weights_spec(artifact.load_artifact(ARTIFACT)))
