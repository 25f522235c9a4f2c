"""The reference storm suite's claims, held on the port's twin (CPU).

gie_tpu_torch.storm runs here with device="cpu" and the port's own noise
(the Scheduler's torch.Generator seeded 0, no replay): the properties
tests/test_storm.py holds for the reference hold for the port.

  real vs virtual   storm-equivalence in real time and under virtual time:
                    the same schedule fingerprint, no sheds, no client
                    5xx, the breaker order open, half_open, closed, and
                    every REQUIRED_FIELDS entry in both cards;
  noisy neighbor    the abuser absorbs the sheds, no critical shed, and
                    the vip tenant against its same-seed solo baseline;
  tenants zpage     the picker's tenants_report names the abuser;
  determinism       two same-seed virtual runs of storm-search-smoke (chaos
                    armed, flash crowd, both degraded rungs) give the same
                    decision fingerprint.
The bounds are the reference tests' own."""

import json

import pytest

from gie_tpu_torch.resilience import faults
from gie_tpu_torch.resilience import scenarios
from gie_tpu_torch.storm import scorecard as SC
from gie_tpu_torch.storm import shapes as S
from gie_tpu_torch.storm.engine import (
    EngineConfig,
    PoolSpec,
    StormEngine,
    run_scenario,
)


@pytest.fixture(autouse=True)
def _clean_globals():
    faults.uninstall()
    faults.set_clock(None)
    yield
    faults.uninstall()
    faults.set_clock(None)


def test_real_vs_virtual_equivalence_on_short_scenario():
    real = run_scenario("storm-equivalence", device="cpu",
                        cfg=EngineConfig(virtual_time=False)).scorecard
    virt = run_scenario("storm-equivalence", device="cpu",
                        cfg=EngineConfig(virtual_time=True)).scorecard
    assert real["virtual_time"] is False and virt["virtual_time"] is True
    assert real["schedule_fingerprint"] == virt["schedule_fingerprint"]
    assert real["seed"] == virt["seed"]
    assert real["shed"] == virt["shed"] == 0
    assert real["shed_by_band"] == virt["shed_by_band"]
    assert real["client_5xx"] == 0 and virt["client_5xx"] == 0
    assert real["breaker_events"] == virt["breaker_events"]
    assert [st for _slot, st, _plane in real["breaker_events"]] == [
        "open", "half_open", "closed"]
    for card in (real, virt):
        SC.validate(card)
        assert [f for f in SC.REQUIRED_FIELDS if f not in card] == []
        # Presence, not value: the two modes' latencies live on
        # different clocks.
        assert card["ttft_p50_s"] is not None
        assert card["serve_latency_p99_ms"] >= 0


def _solo_baseline_path(tmp_path) -> str:
    """storm-noisy-neighbor minus the abusive_tenant shape, same seed."""
    scn = scenarios.load("storm-noisy-neighbor")
    with open(scn.path, "r", encoding="utf-8") as fh:
        raw = json.load(fh)
    raw["name"] = "storm-noisy-neighbor-solo"
    raw["drive"]["storm"]["shapes"] = [
        s for s in raw["drive"]["storm"]["shapes"]
        if s["kind"] != "abusive_tenant"]
    path = str(tmp_path / "storm-noisy-neighbor-solo.json")
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(raw, fh)
    return path


def test_storm_noisy_neighbor_isolates_victim(tmp_path):
    card = run_scenario("storm-noisy-neighbor", device="cpu",
                        dump_dir=str(tmp_path)).scorecard
    assert card["virtual_time"] is True
    assert card["client_5xx"] == 0, card["client_5xx_detail"]
    assert card["resets"] == 0 and card["timeouts"] == 0
    assert card["shed"] >= 10, "the 20x flood never saturated the pool"
    per = card["per_tenant"]
    abuser = per["abuser"]
    assert abuser["shed"] / card["shed"] >= 0.6, per
    assert card["shed_by_band"].get("critical", 0) == 0
    assert card["shed_by_band"].get("sheddable", 0) >= abuser["shed"]
    vip = per["vip"]
    assert vip["shed"] == 0 and vip["client_5xx"] == 0
    assert vip["completed"] > 5
    solo = run_scenario(
        _solo_baseline_path(tmp_path), device="cpu",
        dump_dir=str(tmp_path)).scorecard["per_tenant"]["vip"]
    assert solo["completed"] > 5
    assert vip["slo_attainment"] >= solo["slo_attainment"] - 0.2, (vip, solo)
    assert vip["ttft_p99_s"] <= max(4.0 * solo["ttft_p99_s"],
                                    solo["ttft_p99_s"] + 2.0), (vip, solo)


def test_noisy_neighbor_tenant_zpage_explains_the_abuser():
    prog = S.Program(
        S.TrafficConfig(base_qps=40.0, duration_s=4.0,
                        sheddable_fraction=0.5, critical_fraction=0.0),
        [S.TenantMix(tenants=3),
         S.AbusiveTenant("abuser", share=0.15, rate_x=15.0, at_s=0.5,
                         ramp_s=0.5, hold_s=3.0)],
        seed=21)
    eng = StormEngine(prog, pool=PoolSpec(n_pods=3),
                      cfg=EngineConfig(queue_limit=3.0), name="nn-zpage",
                      virtual_time=True, device="cpu")
    try:
        eng.run()
        rep = eng.picker.tenants_report()
    finally:
        eng.close()
    assert "abuser" in rep["tenants"], rep["tenants"].keys()
    row = rep["tenants"]["abuser"]
    assert row["requests_total"] > 50
    assert row["arrival_cost_w"] >= 0.0
    assert "weights" in rep and "deficits" in rep and "queue" in rep
    assert 0.0 <= row["shed_rate_w"] <= 1.0


def test_same_seed_virtual_runs_pin_the_decisions():
    r1, r2 = (run_scenario("storm-search-smoke", device="cpu")
              for _ in range(2))
    c1, c2 = r1.scorecard, r2.scorecard
    # Read at the storm's end, before run() releases the clock, every
    # rule's count is a function of the seed, scrape.fetch's included.
    assert r1.fault_fired_in_storm == r2.fault_fired_in_storm
    assert set(r1.fault_fired_in_storm) == {"scrape.fetch",
                                            "device.dispatch"}
    assert c1["virtual_time"] is True
    assert c1["max_rung"] >= 2, "the chaos windows forced no degraded rung"
    assert c1["decision_fingerprint"] == c2["decision_fingerprint"]
    for k in ("schedule_fingerprint", "arrivals", "ok", "shed", "completed",
              "client_5xx", "breaker_events", "rung_trace", "ttft_p99_s"):
        assert c1[k] == c2[k], (k, c1[k], c2[k])
