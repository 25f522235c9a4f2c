"""The port's federation storms against the reference's, decision for
decision.

storm-fed-spill, storm-fed-drain and storm-fed-partition replay under
virtual time through gie_tpu.storm.engine.run_scenario (JAX on the CPU)
and through gie_tpu_torch.storm.engine.run_scenario(device="cpu") with
the reference scheduler's Gumbel draws replayed (jax_noise_replay(0), as
tests/test_torch_storm.py runs the first storms). None of the three
scenarios has a fault rule, so no count is read after the storm (ROADMAP
Queue 3 item 5). The scorecards are compared whole and exactly, the
federation block included (per-cluster picks and serves, CRITICAL
crossings, pick times, the local-only timeline, the drain / partition /
heal events, the link's counters and installed era, the capacity
matrix), with the readings left out that the scorer takes on the clock
after run() has released it, so they grow with the host's speed on
either side: the link's staleness and, derived from it, each peer row's
effective penalty and staleness in the matrix; the link's counts of
polls and installs (`rejects`, `era_regressions`, `installs`,
`installed_epoch`, `peer_epoch`); and each matrix row's `queue_total`.
The link's poller, the peer's publisher and the scrape engine keep
running after the release (the virtual clock then advances whenever
every remaining actor parks): after a heal with a flipped era the old
lineage answers every other poll, each answer a rejected era
regression; a late refresh of the peer moves its epoch and the link's
installs; and the local row's queue total is whatever the last scrape
saw when the scorer reads it. The reference's run() ends its main actor
before it scores in the same order (gie_tpu/storm/engine.py:1274-1285),
so the same readings are late there: under six concurrent test
processes storm-fed-spill's local queue total read 0 in most runs and 1
in some, on the reference and on the port alike.
hack/torch_fed_late_reads.py prints the port's readings for a wall delay
before the scorecard. A partition healed with a
flipped era mints the new era's token from the module-level `random` of
each package's exchange; the test gives both the same seeded generator.

storm-longhorizon's two virtual hours overrun the reference's own 90-s
wall budget on this host, so a cut of it is held instead: a program built
in the test with its federation, autoscale, rolling-upgrade, diurnal and
flip-era partition shapes over four virtual minutes."""

import random
import types

import pytest

from gie_tpu.federation import exchange as ref_exchange
from gie_tpu.resilience import faults as ref_faults
from gie_tpu.storm.engine import run_scenario as ref_run
from gie_tpu_torch.federation import exchange as port_exchange
from gie_tpu_torch.resilience import faults as port_faults
from gie_tpu_torch.storm import scorecard
from gie_tpu_torch.storm.engine import run_scenario as port_run
from tests.test_torch_slice import jax_noise_replay
from tests.test_torch_storm import FIELDS

STORMS = ("storm-fed-spill", "storm-fed-drain", "storm-fed-partition")
ERA_SEED = 12


@pytest.fixture(autouse=True)
def _clean_globals(monkeypatch):
    for faults in (ref_faults, port_faults):
        faults.uninstall()
        faults.set_clock(None)
    yield
    for faults in (ref_faults, port_faults):
        faults.uninstall()
        faults.set_clock(None)


def _seed_eras(monkeypatch):
    for mod in (ref_exchange, port_exchange):
        rng = random.Random(ERA_SEED)
        monkeypatch.setattr(mod, "random", types.SimpleNamespace(
            Random=random.Random, getrandbits=rng.getrandbits))


# Link fields that move after run() releases the clock.
_LATE_LINK = ("staleness_s", "rejects", "era_regressions", "installs",
              "installed_epoch", "peer_epoch")


def _without_late_reads(card):
    fed = dict(card["federation"])
    fed["link"] = {k: v for k, v in fed["link"].items()
                   if k not in _LATE_LINK}
    fed["matrix"] = {
        name: {k: v for k, v in row.items() if k != "queue_total"
               and (row["local"] or k not in ("staleness_s", "penalty"))}
        for name, row in fed["matrix"].items()}
    return {**card, "federation": fed}


def _assert_cards_equal(port, ref):
    assert port["virtual_time"] is True and ref["virtual_time"] is True
    for field in FIELDS:
        if field in ref:      # run_scenario adds the fault counts
            assert port[field] == ref[field], (field, port[field],
                                               ref[field])
    port, ref = _without_late_reads(port), _without_late_reads(ref)
    assert port["federation"] == ref["federation"]
    diff = sorted(k for k in set(port) | set(ref)
                  if port.get(k) != ref.get(k))
    assert diff == [], [(k, port.get(k), ref.get(k)) for k in diff[:3]]


@pytest.mark.parametrize("name", STORMS)
def test_fed_storm_reaches_the_reference_decisions(name, monkeypatch):
    _seed_eras(monkeypatch)
    ref = ref_run(name, virtual_time=True).scorecard
    ref_faults.set_clock(None)
    _seed_eras(monkeypatch)
    port = port_run(name, virtual_time=True, device="cpu",
                    noise_source=jax_noise_replay(0)).scorecard
    scorecard.validate(port)
    _assert_cards_equal(port, ref)
    fed = ref["federation"]
    if name == "storm-fed-spill":
        assert fed["picks"]["west"]["total"] > 0
        assert fed["critical_remote_picks"] == 0
    elif name == "storm-fed-drain":
        # A drain bleeds every band, CRITICAL included.
        assert [e["event"] for e in fed["events"]] == ["cluster_drain"]
        assert fed["draining"] is True
    else:
        assert [e["event"] for e in fed["events"]] == ["partition", "heal"]
        assert 1 in [v for _, v in fed["local_only_trace"]]
        assert fed["link"]["era_flips"] == 1
        # The zombie lineage was rejected, on both sides.
        assert fed["link"]["era_regressions"] > 0
        assert port["federation"]["link"]["era_regressions"] > 0



def _longhorizon_program(S):
    """storm-longhorizon's shapes over four virtual minutes."""
    return S.Program(
        S.TrafficConfig(base_qps=0.8, duration_s=240.0, n_sessions=12,
                        system_prompt_bytes=1024, user_suffix_bytes=96,
                        decode_tokens_mean=16.0, sheddable_fraction=0.25,
                        critical_fraction=0.05, dt=0.25),
        [S.DiurnalRamp(period_s=120.0, floor=0.3, peak=1.0, phase_s=30.0),
         S.RollingUpgrade(start_s=60.0, pods=4, interval_s=20.0,
                          settle_s=8.0),
         S.PeerPartition(at_s=120.0, heal_s=180.0, flip_era=True)],
        seed=0)


def test_cut_longhorizon_reaches_the_reference_decisions(monkeypatch):
    from gie_tpu.storm import engine as ref_engine
    from gie_tpu.storm import shapes as ref_shapes
    from gie_tpu_torch.storm import engine as port_engine
    from gie_tpu_torch.storm import shapes as port_shapes

    cards = []
    for eng_mod, S, kw in (
            (ref_engine, ref_shapes, {}),
            (port_engine, port_shapes,
             {"device": "cpu", "noise_source": jax_noise_replay(0)})):
        _seed_eras(monkeypatch)
        cfg = eng_mod.EngineConfig(
            ttft_slo_s=3.0, queue_limit=8.0, autoscale_max_extra=2,
            autoscale_interval_s=5.0, scrape_interval_s=0.5,
            world_dt_s=0.1,
            federation=eng_mod.FederationSpec(
                peer_name="west", n_pods=2, penalty=2.0, interval_s=1.0,
                wait_s=3.0, stale_inflate_s=30.0, local_only_after_s=12.0,
                link_open_after=3, link_open_s=10.0))
        eng = eng_mod.StormEngine(
            _longhorizon_program(S),
            pool=eng_mod.PoolSpec(n_pods=4, drain_deadline_s=60.0),
            cfg=cfg, name="longhorizon-cut", virtual_time=True, **kw)
        try:
            cards.append(eng.run().scorecard)
        finally:
            eng.close()
        ref_faults.set_clock(None)
        port_faults.set_clock(None)
    ref, port = cards
    assert [u["step"] for u in ref["upgrades"]].count("replace") == 4
    assert [e["event"] for e in ref["federation"]["events"]] == [
        "partition", "heal"]
    _assert_cards_equal(port, ref)
