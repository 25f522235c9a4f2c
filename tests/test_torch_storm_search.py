"""The port's storm search harness, CLI, device rule and refusals (CPU).

  search     search("storm-search-smoke", configs=[2 configs], rounds=1,
             device="cpu") gives a leaderboard validate() accepts, and a
             second call the same leaderboard (virtual time: every
             number in it is a function of the seed and the config).
  slices     the subsystems of the later slices run from an
             EngineConfig: a mesh (mesh_devices=8 serves the storm through
             Scheduler(mesh=) over 8 virtual CPU positions), federation
             and the fleet picker; their scenarios build, every shipped
             storm runs, and nothing is refused any more.
  device     with no CUDA device and no device argument, run_scenario,
             search and the CLI's main raise (so `python -m` exits
             non-zero); none moves to the CPU on its own.
             A kernel that cannot run (ops.KernelUnavailable) ends the
             storm, at warm-up or mid-storm, instead of being scored as
             client 5xx. A stack that fails to build leaves no faults
             clock, actor or thread behind.
  CLI        python -m gie_tpu_torch.storm storm-equivalence --virtual
             --device cpu prints a scorecard validate() accepts.
"""

import json
import pathlib
import subprocess
import sys
import threading
import time

import pytest
import torch

from gie_tpu_torch.ops import KernelUnavailable
from gie_tpu_torch.resilience import faults
from gie_tpu_torch.resilience import scenarios
from gie_tpu_torch.runtime import clock as clock_mod
from gie_tpu_torch.sched.profile import Scheduler
from gie_tpu_torch.storm import scorecard as SC
from gie_tpu_torch.storm import search as SR
from gie_tpu_torch.storm import shapes as S
from gie_tpu_torch.storm.engine import (
    EngineConfig,
    FederationSpec,
    StormEngine,
    run_scenario,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
NO_CARD = "runs on a CUDA device by default and none is available"

SEARCH_CONFIGS = [
    {"ladder.cached_kv_weight": 8.0, "ladder.wrr_queue_alpha": 1.0},
    {"ladder.cached_kv_weight": 0.0, "ladder.wrr_queue_alpha": 8.0},
]


@pytest.fixture(autouse=True)
def _clean_globals():
    faults.uninstall()
    faults.set_clock(None)
    yield
    faults.uninstall()
    faults.set_clock(None)


def test_search_smoke_leaderboard_is_valid_and_repeats():
    boards = [SR.search("storm-search-smoke", configs=SEARCH_CONFIGS,
                        rounds=1, device="cpu") for _ in range(2)]
    first, second = boards
    SR.validate(first)
    assert first["virtual_time"] is True and first["n_configs"] == 2
    assert sorted(json.dumps(r["config"], sort_keys=True)
                  for r in first["leaderboard"]) == sorted(
        json.dumps(c, sort_keys=True) for c in SEARCH_CONFIGS)
    assert all(r["rounds_survived"] == 1 and r["client_5xx"] == 0
               for r in first["leaderboard"])
    assert second == first


def _program(shapes=()):
    return S.Program(S.TrafficConfig(base_qps=4.0, duration_s=2.0),
                     list(shapes), seed=5)


# The subsystems a later slice of the port brought, each of which was
# refused at construction until its slice came.
LATER_SLICES = {
    "mesh": (EngineConfig(mesh_devices=8), ()),
}


@pytest.mark.parametrize("case", sorted(LATER_SLICES))
def test_later_slice_subsystem_is_refused_at_construction(case):
    """Not refused any more: the storm runs through the meshed Scheduler
    (dp 4 x tp 2 virtual CPU positions) under virtual time, as the
    reference's storm-ci smoke runs through its 8-device mesh, with no
    client 5xx and a valid scorecard; the engine hands the fault clock
    back as it found it."""
    from gie_tpu_torch.sched import profile

    assert not hasattr(profile, "_LATER")
    cfg, shapes = LATER_SLICES[case]
    eng = StormEngine(_program(shapes), cfg=cfg, virtual_time=True,
                      device="cpu")
    try:
        assert eng.scheduler.mesh.shape == {"dp": 4, "tp": 2}
        card = eng.run().scorecard
    finally:
        eng.close()
    SC.validate(card)
    assert card["client_5xx"] == 0 and card["ok"] > 0
    assert faults._clock is clock_mod.MONOTONIC
    assert faults.installed() is None


def test_federation_engine_config_runs():
    """The federation slice is ported: a storm with a peer cluster runs
    under virtual time, imports the peer before its waves and scores the
    federation block."""
    prog = S.Program(S.TrafficConfig(base_qps=6.0, duration_s=2.0),
                     [S.ClusterDrain(at_s=1.0)], seed=5)
    eng = StormEngine(prog, cfg=EngineConfig(federation=FederationSpec()),
                      virtual_time=True, device="cpu")
    try:
        card = eng.run().scorecard
    finally:
        eng.close()
    SC.validate(card)
    fed = card["federation"]
    assert fed["link"]["installs"] >= 1
    assert fed["matrix"]["west"]["endpoints"] == FederationSpec().n_pods
    assert [e["event"] for e in fed["events"]] == ["cluster_drain"]
    assert sum(p["total"] for p in fed["picks"].values()) == card["ok"] \
        + card["client_5xx"]


def test_fleet_engine_config_runs():
    """The fleet slice is ported: fleet_topk > 0 builds the FleetPicker in
    place of the Scheduler, a storm runs through it under virtual time, and
    the scorecard carries the fleet section."""
    from gie_tpu_torch.fleet import FleetPicker

    eng = StormEngine(_program(), cfg=EngineConfig(fleet_topk=4,
                                                   fleet_cell_cap=32),
                      virtual_time=True, device="cpu")
    try:
        assert isinstance(eng.scheduler, FleetPicker)
        card = eng.run().scorecard
    finally:
        eng.close()
    SC.validate(card)
    fleet = card["fleet"]
    assert fleet["topk"] == 4 and fleet["cell_cap"] == 32
    assert fleet["mode"] == "exact" and fleet["waves"] > 0
    assert sum(fleet["topk_hit_histogram"].values()) == sum(
        c["picks"] for c in fleet["hot_cells"]) + fleet["other_cell_picks"]


FED_SCENARIOS = ("storm-fed-drain", "storm-fed-partition",
                 "storm-fed-spill", "storm-fleet", "storm-longhorizon")


@pytest.mark.parametrize("name", FED_SCENARIOS)
def test_federation_scenario_builds(name):
    """Each scenario that waited for federation builds its engine (the
    peer fleet, publisher, exchange and picker; storm-fleet's with the
    FleetPicker) and closes with no thread left behind."""
    from gie_tpu_torch.fleet import FleetPicker
    from gie_tpu_torch.storm.engine import engine_from_drive

    before = set(threading.enumerate())
    scn = scenarios.load(name)
    eng = engine_from_drive(scn.drive["storm"], seed=scn.seed, name=name,
                            virtual_time=True, device="cpu")
    try:
        assert eng.fed_state is not None and eng.picker.federation is \
            eng.fed_state
        assert eng.fed_exchange.links and eng.peer_pub is not None
        assert isinstance(eng.scheduler, FleetPicker) == (
            name == "storm-fleet")
    finally:
        eng.close()
    deadline = time.monotonic() + 10
    while (set(threading.enumerate()) - before
           and time.monotonic() < deadline):
        time.sleep(0.05)      # the clock's waker ends on its next wake
    assert set(threading.enumerate()) - before == set()


def test_all_twelve_storm_scenarios_run_on_the_port():
    """Named for the three storms that ran first; since the autoscale
    loop, the replication standby, federation and the fleet picker came,
    every shipped storm runs on the port and none is refused."""
    runnable = sorted(n for n in scenarios.list_scenarios()
                      if n.startswith("storm-"))
    assert runnable == ["storm-capacity", "storm-equivalence",
                        "storm-fed-drain", "storm-fed-partition",
                        "storm-fed-spill", "storm-flash-upgrade",
                        "storm-fleet", "storm-learn-judge",
                        "storm-longhorizon", "storm-noisy-neighbor",
                        "storm-search-smoke", "storm-soak"]
    assert "fleet" not in LATER_SLICES


def test_twin_and_search_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match=NO_CARD):
        run_scenario("storm-equivalence")
    with pytest.raises(RuntimeError, match=NO_CARD):
        SR.search("storm-search-smoke", configs=SEARCH_CONFIGS[:1], rounds=1)
    assert set(threading.enumerate()) - before == set()
    assert faults._clock is clock_mod.MONOTONIC


def _no_stack(*_args, **_kw):
    raise RuntimeError("stack refused here")


@pytest.mark.parametrize("part", ["Scheduler", "ScrapeEngine"])
def test_stack_build_failure_leaves_no_clock_or_thread(monkeypatch, part):
    # Scheduler fails first of all; ScrapeEngine last, after the picker's
    # threads have started.
    from gie_tpu_torch.storm import engine as engine_mod

    monkeypatch.setattr(engine_mod, part, _no_stack)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="stack refused here"):
        StormEngine(_program(), virtual_time=True, device="cpu")
    for t in set(threading.enumerate()) - before:
        t.join(5)
    assert not [t for t in set(threading.enumerate()) - before
                if t.is_alive()]
    assert faults._clock is clock_mod.MONOTONIC


def _unavailable(*_args, **_kw):
    raise KernelUnavailable("kernel refused here")


def test_kernel_failure_at_warmup_ends_the_storm(monkeypatch):
    monkeypatch.setattr(Scheduler, "pick_async", _unavailable)
    with pytest.raises(KernelUnavailable, match="refused here"):
        run_scenario("storm-equivalence", device="cpu", virtual_time=True)
    assert faults._clock is clock_mod.MONOTONIC


@pytest.mark.parametrize("virtual", [True, False])
def test_kernel_failure_mid_storm_ends_the_storm(virtual):
    eng = StormEngine(_program(), virtual_time=virtual, device="cpu")
    try:
        schedule = eng.program.compile()
        eng.warmup(schedule)
        eng.scheduler.pick_async = _unavailable
        with pytest.raises(KernelUnavailable, match="refused here"):
            eng.run(schedule=schedule, warmup=False)
    finally:
        eng.close()


def test_cli_prints_a_valid_scorecard_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "gie_tpu_torch.storm", "storm-equivalence",
         "--virtual", "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    card = json.loads(out.stdout)
    SC.validate(card)
    assert card["virtual_time"] is True and card["client_5xx"] == 0
    assert card["fault_fired"] == {"scrape.fetch": 6}


def test_cli_without_a_device_raises_with_no_card(monkeypatch, capsys):
    from gie_tpu_torch.storm.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=NO_CARD):
        main(["storm-equivalence", "--virtual"])
    assert capsys.readouterr().out == ""
