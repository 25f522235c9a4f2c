"""storm-fleet on the port against the reference, decision for decision.

storm-fleet replays 16 simulated clusters (the 3-pod local pool plus 15
two-pod peer clusters imported through the digest exchange) through the
FleetPicker (topk 2, cell_cap 32: at m = 64 the top-K covers both cells)
under virtual time: through gie_tpu.storm.engine.run_scenario (JAX on the
CPU) and through gie_tpu_torch.storm.engine.run_scenario(device="cpu")
with the reference scheduler's Gumbel draws replayed (jax_noise_replay(0),
drawn at the dense stage's width). The scorecards are compared whole and
exactly, the fleet block included, with the readings that the scorer
takes after run() releases the clock left out as tests/test_torch_storm_fed.py
leaves them out. storm-fleet arms no fault rule, so no count is read after
the storm. Then the port's own parity contract: the same storm re-run on
the port's dense Scheduler lands on the same decision fingerprint, as the
reference's tests/test_storm.py asserts for the reference.
"""

import pytest

from gie_tpu.resilience import faults as ref_faults
from gie_tpu.storm.engine import run_scenario as ref_run
from gie_tpu_torch.resilience import faults as port_faults
from gie_tpu_torch.resilience import scenarios
from gie_tpu_torch.storm import scorecard
from gie_tpu_torch.storm.engine import engine_from_drive
from gie_tpu_torch.storm.engine import run_scenario as port_run
from tests.test_torch_slice import jax_noise_replay
from tests.test_torch_storm_fed import _assert_cards_equal


def _clean():
    for faults in (ref_faults, port_faults):
        faults.uninstall()
        faults.set_clock(None)


@pytest.fixture(scope="module")
def port_card():
    _clean()
    try:
        yield port_run("storm-fleet", virtual_time=True, device="cpu",
                       noise_source=jax_noise_replay(0)).scorecard
    finally:
        _clean()


def test_fleet_storm_reaches_the_reference_decisions(port_card):
    _clean()
    try:
        ref = ref_run("storm-fleet", virtual_time=True).scorecard
    finally:
        _clean()
    scorecard.validate(port_card)
    _assert_cards_equal(port_card, ref)
    assert port_card["fleet"] == ref["fleet"]
    fleet, fed = port_card["fleet"], port_card["federation"]
    assert fleet["mode"] == "exact" and fleet["compression_ratio"] == 1.0
    assert fleet["topk_hit_histogram"].get("-1", 0) == 0   # covering K
    assert len(fed["peers"]) == 15 and fed["critical_remote_picks"] == 0
    assert port_card["client_5xx"] == 0


def test_fleet_storm_equals_the_dense_rerun_on_the_port(port_card):
    """Covering top-K: the port's fleet cycle is its dense cycle, so the
    whole storm lands on the dense re-run's decision fingerprint."""
    scn = scenarios.load("storm-fleet")
    drive = dict(scn.drive["storm"])
    drive.pop("fleet_topk")
    drive.pop("fleet_cell_cap", None)
    _clean()
    eng = engine_from_drive(drive, seed=scn.seed, name="storm-fleet-dense",
                            device="cpu", noise_source=jax_noise_replay(0))
    try:
        dense = eng.run().scorecard
    finally:
        eng.close()
        _clean()
    assert "fleet" in port_card and "fleet" not in dense
    assert dense["schedule_fingerprint"] == port_card["schedule_fingerprint"]
    assert dense["decision_fingerprint"] == port_card["decision_fingerprint"]
