"""storm-flash-upgrade on the port against the reference, decision for
decision (CPU, virtual time): a flash crowd over LoRA churn and a
long-context slice, a rolling upgrade of all six pods mid-crowd, a
bounded device.dispatch burst (max_fires 5, spent inside the storm, so
its count compares exactly) and the autoscale loop adding two replicas.
The comparison is tests/test_torch_storm_autoscale.py's, in a file of its
own so the two ~30 s storms land on different workers of the suite."""

import pytest

from gie_tpu.resilience import faults as ref_faults
from gie_tpu_torch.resilience import faults as port_faults
from tests.test_torch_storm_autoscale import assert_storm_parity


@pytest.fixture(autouse=True)
def _clean_globals():
    for faults in (ref_faults, port_faults):
        faults.uninstall()
        faults.set_clock(None)
    yield
    for faults in (ref_faults, port_faults):
        faults.uninstall()
        faults.set_clock(None)


def test_storm_flash_upgrade_reaches_the_reference_decisions():
    result = assert_storm_parity("storm-flash-upgrade")
    card = result.scorecard
    assert card["client_5xx"] == 0 and card["shed"] > 0
    assert [u["step"] for u in card["upgrades"]].count("replace") == 6
    (event,) = card["autoscale_events"]
    assert (event["from"], event["to"]) == (6, 8)
    assert card["fault_fired"] == {"device.dispatch": 5}
    assert result.fault_fired_in_storm == {"device.dispatch": 5}
    assert card["max_rung"] > 0 and card["final_rung"] == 0
