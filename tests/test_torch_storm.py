"""The port's storm twin against the reference's, decision for decision.

Each of the three scenarios this slice runs (storm-equivalence,
storm-noisy-neighbor, storm-search-smoke) is replayed under virtual time
through gie_tpu.storm.engine.run_scenario (JAX on the CPU) and through
gie_tpu_torch.storm.engine.run_scenario(device="cpu") with the reference
scheduler's Gumbel draws replayed (jax_noise_replay(0): the reference
engine seeds its Scheduler with PRNGKey(0), and both packages draw once
per dispatched wave; warm-up draws nothing on either side). Each run arms
its own package's fault injector from the scenario's rules. One more
program, built in both packages, covers the engine paths those three
leave out: a rolling upgrade's drain and replace steps, LoRA churn, the
admission gate and the outlier ejector.

Under virtual time the scorecard is a pure function of the seed and the
noise, latencies included (they are read on the virtual clock), so the
cards are compared exactly and in full: the schedule and decision
fingerprints, ok / shed / shed_by_band / client_5xx / resets / timeouts,
each tenant's row, the breaker events in order, the rung trace, the TTFT
percentiles and fault_fired, with one exception that lies in the
reference: run() releases the virtual clock before it scores, and
run_scenario reads the injector's counts after that, so a rule that has
fires left when the storm ends (storm-search-smoke's scrape.fetch) keeps
firing on scrapes made after the storm, as many as the host's speed
allows before the read. That rule's count and the log length are not a
function of the seed on either side, and are left out for that scenario.
The breaker events and the decision fingerprint are read late too, but
change only once the rule's remaining fires (over 700 of its 1100) are
spent and the breakers close, far more than happens while the read
takes; test_reference_fault_count_includes_draws_after_the_storm shows
both on the reference (ROADMAP.md, Queue 3)."""

import pytest

from gie_tpu.resilience import faults as ref_faults
from gie_tpu.storm.engine import run_scenario as ref_run
from gie_tpu_torch.resilience import faults as port_faults
from gie_tpu_torch.storm import scorecard
from gie_tpu_torch.storm.engine import run_scenario as port_run
from tests.test_torch_slice import jax_noise_replay

SCENARIOS = ("storm-equivalence", "storm-noisy-neighbor",
             "storm-search-smoke")

# The fields the parity contract names; the whole card is compared after.
FIELDS = ("schedule_fingerprint", "decision_fingerprint", "arrivals", "ok",
          "shed", "shed_by_band", "client_5xx", "resets", "timeouts",
          "client_skipped", "completed", "breaker_events", "rung_trace",
          "pool_size_trace", "max_rung", "final_rung", "ttft_p50_s",
          "ttft_p99_s", "serve_latency_p50_ms", "serve_latency_p99_ms",
          "goodput_tokens_per_s", "slo_attainment", "fault_fired",
          "fault_log_len")


@pytest.fixture(autouse=True)
def _clean_globals():
    """Both packages' fault injectors and fault clocks are module globals:
    none may leak into (or out of) a storm."""
    for faults in (ref_faults, port_faults):
        faults.uninstall()
        faults.set_clock(None)
    yield
    for faults in (ref_faults, port_faults):
        faults.uninstall()
        faults.set_clock(None)


# (scenario, fault point) pairs whose count runs on after the storm.
AFTER_THE_STORM = {"storm-search-smoke": ("scrape.fetch",)}


@pytest.fixture(scope="module")
def reference_cards():
    """The reference's card per scenario, run once per module."""
    cards = {}

    def card(name):
        if name not in cards:
            cards[name] = ref_run(name, virtual_time=True).scorecard
            ref_faults.set_clock(None)
        return cards[name]

    return card


def _without_after_storm_counts(name, card):
    late = AFTER_THE_STORM.get(name, ())
    if not late:
        return card
    return {**card, "fault_log_len": None, "fault_fired": {
        k: v for k, v in card["fault_fired"].items() if k not in late}}


@pytest.mark.parametrize("name", SCENARIOS)
def test_port_storm_reaches_the_reference_decisions(name, reference_cards):
    ref = reference_cards(name)
    port = port_run(name, virtual_time=True, device="cpu",
                    noise_source=jax_noise_replay(0)).scorecard
    scorecard.validate(port)
    assert port["virtual_time"] is True and ref["virtual_time"] is True
    assert port["ok"] > 0
    ref = _without_after_storm_counts(name, ref)
    port = _without_after_storm_counts(name, port)
    for field in FIELDS:
        assert port[field] == ref[field], (field, port[field], ref[field])
    assert port["per_tenant"] == ref["per_tenant"]
    diff = sorted(k for k in set(port) | set(ref)
                  if port.get(k) != ref.get(k))
    assert diff == []


def test_reference_fault_count_includes_draws_after_the_storm(
        reference_cards, monkeypatch):
    """The reference's storm-search-smoke, scored only once every breaker
    has closed again on the free-running clock (at most 30 s of wall
    time): the storm's own outcome is the same, but the scrape.fetch
    count, the breaker events and with them the decision fingerprint take
    in scrapes made after the storm. device.dispatch, drawn only by
    picks, cannot fire after the storm and keeps its count."""
    import time

    from gie_tpu.storm.engine import StormEngine

    score = StormEngine._score

    def late_score(self, schedule):
        deadline = time.monotonic() + 30.0
        while self.board.states() and time.monotonic() < deadline:
            time.sleep(0.01)
        return score(self, schedule)

    name = "storm-search-smoke"
    base = reference_cards(name)
    assert base["breaker_opens"], "the blackout opened no breaker"
    monkeypatch.setattr(StormEngine, "_score", late_score)
    late = ref_run(name, virtual_time=True).scorecard
    for field in ("schedule_fingerprint", "ok", "shed", "completed",
                  "rung_trace", "per_tenant", "ttft_p99_s"):
        assert late[field] == base[field], field
    assert late["fault_fired"]["device.dispatch"] == \
        base["fault_fired"]["device.dispatch"]
    assert late["fault_fired"]["scrape.fetch"] > \
        base["fault_fired"]["scrape.fetch"]
    n = len(base["breaker_events"])
    assert late["breaker_events"][:n] == base["breaker_events"]
    assert late["breaker_opens"] == {} and len(late["breaker_events"]) > n
    assert late["decision_fingerprint"] != base["decision_fingerprint"]


def _engine_program(S):
    """A short storm over the engine paths the three scenarios leave
    out: a rolling upgrade (drain and replace control events), LoRA
    churn and a flash crowd."""
    return S.Program(
        S.TrafficConfig(base_qps=20.0, duration_s=3.0, n_sessions=8,
                        decode_tokens_mean=16.0),
        [S.LoraChurn(adapters=4, hot=2, rotate_every_s=1.0, p=0.5),
         S.RollingUpgrade(start_s=0.4, pods=2, interval_s=1.0,
                          settle_s=0.5),
         S.FlashCrowd(at_s=1.0, ramp_s=0.3, hold_s=1.0, magnitude=2.0)],
        seed=4343)


def test_port_engine_paths_reach_the_reference_decisions():
    """The same program through both packages' StormEngine under virtual
    time, with the admission gate (2 workers) and the outlier ejector
    armed: whole scorecards equal, the upgrade steps, the gate's report
    and the ejections included."""
    from gie_tpu.resilience.outlier import OutlierConfig as RefOutlier
    from gie_tpu.storm import engine as ref_engine
    from gie_tpu.storm import shapes as ref_shapes
    from gie_tpu_torch.resilience.outlier import OutlierConfig as PortOutlier
    from gie_tpu_torch.storm import engine as port_engine
    from gie_tpu_torch.storm import shapes as port_shapes

    cards = []
    for eng_mod, S, outlier, kw in (
            (ref_engine, ref_shapes, RefOutlier, {}),
            (port_engine, port_shapes, PortOutlier,
             {"device": "cpu", "noise_source": jax_noise_replay(0)})):
        cfg = eng_mod.EngineConfig(extproc_workers=2,
                                   extproc_admission_s=0.002,
                                   outlier=outlier())
        eng = eng_mod.StormEngine(_engine_program(S),
                                  pool=eng_mod.PoolSpec(n_pods=4), cfg=cfg,
                                  name="engine-paths", virtual_time=True,
                                  **kw)
        try:
            cards.append(eng.run().scorecard)
        finally:
            eng.close()
    ref, port = cards
    assert [u["step"] for u in port["upgrades"]] == [
        "drain", "replace", "drain", "replace"]
    assert port["lora_arrivals"] > 0
    assert port["extproc"]["admitted"] > 0
    diff = sorted(k for k in set(port) | set(ref)
                  if port.get(k) != ref.get(k))
    assert diff == [], [(k, port.get(k), ref.get(k)) for k in diff[:3]]
