"""The port's storm search harness, CLI, device rule and refusals (CPU).

  search     search("storm-search-smoke", configs=[2 configs], rounds=1,
             device="cpu") gives a leaderboard validate() accepts, and a
             second call the same leaderboard (virtual time: every
             number in it is a function of the seed and the config).
  refusals   each subsystem of a later slice raises the port's
             not-ported error naming that slice — from an EngineConfig,
             a standby_failover shape, or a shipped scenario that needs
             it through run_scenario — before any stub, thread or clock
             hand-off exists.
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

import pytest
import torch

from gie_tpu_torch.ops import KernelUnavailable
from gie_tpu_torch.resilience import faults
from gie_tpu_torch.resilience import scenarios
from gie_tpu_torch.runtime import clock as clock_mod
from gie_tpu_torch.sched.profile import _LATER, Scheduler
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


REFUSALS = {
    "mesh": (EngineConfig(mesh_devices=8), ()),
    "fleet": (EngineConfig(fleet_topk=4), ()),
    "federation": (EngineConfig(federation=FederationSpec()), ()),
    "autoscale": (EngineConfig(autoscale_max_extra=2), ()),
    "replication": (EngineConfig(standby=True), ()),
    "replication-shape": (EngineConfig(), (S.StandbyFailover(),)),
}


def _assert_refused_cleanly(fn, key):
    before = set(threading.enumerate())
    with pytest.raises(NotImplementedError) as e:
        fn()
    assert _LATER[key] in str(e.value)
    assert set(threading.enumerate()) - before == set()
    assert faults._clock is clock_mod.MONOTONIC
    assert faults.installed() is None


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_later_slice_subsystem_is_refused_at_construction(case):
    cfg, shapes = REFUSALS[case]
    _assert_refused_cleanly(
        lambda: StormEngine(_program(shapes), cfg=cfg, virtual_time=True,
                            device="cpu"),
        case.split("-")[0])


def _needs(name) -> str:
    """The first later slice a shipped scenario's drive asks for, in the
    engine's construction order."""
    storm = scenarios.load(name).drive["storm"]
    if storm.get("fleet_topk", 0) > 0:
        return "fleet"
    if "federation" in storm:
        return "federation"
    if storm.get("autoscale_max_extra", 0) > 0:
        return "autoscale"
    if any(s["kind"] == "standby_failover" for s in storm.get("shapes", [])):
        return "replication"
    return ""


UNPORTED = [n for n in scenarios.list_scenarios()
            if n.startswith("storm-") and _needs(n)]


def test_only_three_storm_scenarios_run_on_this_slice():
    runnable = sorted(n for n in scenarios.list_scenarios()
                      if n.startswith("storm-") and not _needs(n))
    assert runnable == ["storm-equivalence", "storm-noisy-neighbor",
                        "storm-search-smoke"]
    assert len(UNPORTED) == 9


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_scenario_is_refused_by_run_scenario(name):
    _assert_refused_cleanly(lambda: run_scenario(name, device="cpu"),
                            _needs(name))


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
