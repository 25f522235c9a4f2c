"""The port's storm shapes against the reference's, on the CPU.

gie_tpu_torch/storm/shapes.py is a copy of gie_tpu/storm/shapes.py (numpy
only), so compiling the same program with the same seed must give the
same schedule: the same arrivals and events, compared field by field, and
the same `Schedule.fingerprint()`. Held for a program of each kind in
SHAPE_KINDS, for every shipped storm-* scenario's drive.storm, for a
TraceReplay of the same records (given in memory and read from a dump
file), and for the ValueErrors a bad drive section raises. Every
comparison is exact."""

import dataclasses
import json

import pytest

from gie_tpu.resilience import scenarios as ref_scenarios
from gie_tpu.storm import shapes as JS
from gie_tpu_torch.resilience import scenarios as port_scenarios
from gie_tpu_torch.storm import shapes as TS

SIDES = (JS, TS)

RECORDS = [
    {"ts": 100.0, "trace_id": "aa", "prompt_bytes": 2048,
     "decode_tokens": 32.0, "band": "critical", "model": "adapter-1",
     "tenant": "t0", "v": 1},
    {"ts": 100.5, "trace_id": "bb", "prompt_bytes": 512,
     "decode_tokens": 8.0, "band": "sheddable", "model": "base-model",
     "v": 1},
    {"ts": 101.25, "model": "base-model", "v": 1},
    {"ts": 102.0, "trace_id": "cc", "band": "bogus", "tenant": "t1"},
    {"junk": True},
]

# One program per kind: constructor kwargs that make the shape act inside
# a 6 s storm (its rate window, decorations or control events).
KIND_KWARGS = {
    "constant": {"factor": 1.5},
    "diurnal": {"period_s": 4.0, "floor": 0.2, "peak": 1.0, "phase_s": 0.5},
    "flash_crowd": {"at_s": 1.0, "ramp_s": 0.5, "hold_s": 1.5,
                    "magnitude": 3.0, "decay_s": 1.0},
    "lora_churn": {"adapters": 6, "hot": 2, "rotate_every_s": 1.5, "p": 0.8},
    "long_context": {"fraction": 0.3, "prompt_bytes": 4096,
                     "decode_scale": 2.0},
    "rolling_upgrade": {"start_s": 1.0, "pods": 3, "interval_s": 1.0,
                        "settle_s": 0.5},
    "standby_failover": {"every_s": 1.5, "start_s": 0.5},
    "tenant_mix": {"tenants": 5, "zipf_a": 1.1},
    "pinned_tenant": {"tenant": "vip", "share": 0.2, "band": "critical"},
    "abusive_tenant": {"tenant": "abuser", "share": 0.1, "rate_x": 8.0,
                       "at_s": 1.0, "ramp_s": 0.5, "hold_s": 2.0,
                       "decay_s": 1.0, "sheddable_fraction": 0.8},
    "cluster_drain": {"at_s": 2.0},
    "peer_partition": {"at_s": 1.0, "heal_s": 4.0, "flip_era": True},
    "trace_replay": {"records": RECORDS, "time_scale": 2.0},
}


def _traffic(S, **kw):
    base = dict(base_qps=30.0, duration_s=6.0, n_sessions=8,
                sheddable_fraction=0.3, critical_fraction=0.1)
    base.update(kw)
    return S.TrafficConfig(**base)


def _same_schedule(ref, port):
    assert [dataclasses.astuple(a) for a in port.arrivals] == \
        [dataclasses.astuple(a) for a in ref.arrivals]
    assert [dataclasses.astuple(e) for e in port.events] == \
        [dataclasses.astuple(e) for e in ref.events]
    assert dataclasses.astuple(port.traffic) == \
        dataclasses.astuple(ref.traffic)
    assert port.seed == ref.seed
    assert port.fingerprint() == ref.fingerprint()


def test_shape_kinds_match_reference():
    assert sorted(TS.SHAPE_KINDS) == sorted(JS.SHAPE_KINDS)
    assert sorted(KIND_KWARGS) == sorted(JS.SHAPE_KINDS)
    assert TS.BANDS == JS.BANDS


@pytest.mark.parametrize("kind", sorted(KIND_KWARGS))
def test_each_shape_kind_compiles_the_reference_schedule(kind):
    ref, port = (
        S.Program(_traffic(S), S.shapes_from_specs(
            [{"kind": kind, **KIND_KWARGS[kind]}]), seed=4242).compile()
        for S in SIDES)
    assert ref.arrivals
    _same_schedule(ref, port)


def test_composed_program_compiles_the_reference_schedule():
    specs = [{"kind": k, **KIND_KWARGS[k]} for k in (
        "diurnal", "flash_crowd", "lora_churn", "long_context",
        "tenant_mix", "pinned_tenant", "abusive_tenant", "rolling_upgrade",
        "standby_failover", "cluster_drain", "peer_partition")]
    ref, port = (S.Program(_traffic(S), S.shapes_from_specs(specs),
                           seed=99).compile() for S in SIDES)
    assert ref.events and ref.arrivals
    _same_schedule(ref, port)


def _storm_scenarios():
    names = [n for n in port_scenarios.list_scenarios()
             if n.startswith("storm-")]
    assert names == [n for n in ref_scenarios.list_scenarios()
                     if n.startswith("storm-")]
    return names


@pytest.mark.parametrize("name", _storm_scenarios())
def test_shipped_storm_scenario_compiles_the_reference_schedule(name):
    ref_scn, port_scn = ref_scenarios.load(name), port_scenarios.load(name)
    assert port_scn.drive == ref_scn.drive and port_scn.seed == ref_scn.seed
    ref, port = (
        S.program_from_drive(scn.drive["storm"], seed=scn.seed).compile()
        for S, scn in zip(SIDES, (ref_scn, port_scn)))
    assert ref.arrivals
    _same_schedule(ref, port)


def test_trace_replay_from_records_and_from_a_dump_file(tmp_path):
    path = tmp_path / "flightrec.json"
    path.write_text(json.dumps({"records": RECORDS}), encoding="utf-8")
    tc = {"base_qps": 1.0, "duration_s": 0.5, "n_sessions": 4}
    schedules = []
    for S in SIDES:
        for replay in (S.TraceReplay(records=RECORDS),
                       S.TraceReplay(path=str(path), time_scale=0.5)):
            schedules.append(S.Program(
                S.TrafficConfig(**tc),
                [replay, S.RollingUpgrade(start_s=0.2, pods=2,
                                          interval_s=0.5, settle_s=0.1)],
                seed=3).compile())
    ref_mem, ref_file, port_mem, port_file = schedules
    assert len(ref_mem.arrivals) == 4
    _same_schedule(ref_mem, port_mem)
    _same_schedule(ref_file, port_file)


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", [
    "unknown_traffic_field", "unknown_kind", "missing_kind",
    "bad_kwargs", "bad_flash_crowd", "bad_band_fractions",
    "bad_partition_window", "replay_needs_one_source",
    "replay_without_timestamps",
])
def test_bad_drive_sections_raise_the_reference_errors(case):
    def make(S):
        return {
            "unknown_traffic_field": lambda: S.program_from_drive(
                {"traffic": {"qps": 3.0}}, seed=1),
            "unknown_kind": lambda: S.shapes_from_specs([{"kind": "tsunami"}]),
            "missing_kind": lambda: S.shapes_from_specs([{"at_s": 1.0}]),
            "bad_kwargs": lambda: S.shapes_from_specs(
                [{"kind": "flash_crowd", "height": 2.0}]),
            "bad_flash_crowd": lambda: S.program_from_drive(
                {"shapes": [{"kind": "flash_crowd", "magnitude": 0.5}]},
                seed=1),
            "bad_band_fractions": lambda: S.TrafficConfig(
                sheddable_fraction=0.8, critical_fraction=0.4),
            "bad_partition_window": lambda: S.PeerPartition(
                at_s=3.0, heal_s=2.0),
            "replay_needs_one_source": lambda: S.TraceReplay(),
            "replay_without_timestamps": lambda: S.TraceReplay(
                records=[{"x": 1}]),
        }[case]

    assert _error(make(TS)) == _error(make(JS))
