"""gie-learn and the random picker on the port against the JAX reference
on the CPU: the multiplicative scorer, the artifact, the trainer, the
learned and random cycles, the runner's --scorer learned and the storm
twin's learned scorer.

Inputs come from numpy seeds and go through both packages; the port's
Gumbel noise replays the JAX scheduler's key sequence
(tests/test_torch_slice.jax_noise_replay, jax_pd_noise_replay for the
dual pick). The random picker takes the wave's key as the sinkhorn picker
does, so one replay serves both.

Tolerances: picks, statuses and every integer column exact; the
multiplicative total within the reference's own 128-ULP bound against
numpy (tests/test_learn.py); scores within tests/test_torch_slice.py's
bound (atol 1e-5, plus two lane-tiebreak fields of relative slack on the
sinkhorn and random paths); carried states as test_torch_slice holds
them.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gie_tpu.learn import artifact as ref_artifact
from gie_tpu.learn import dataset as ref_dataset
from gie_tpu.learn import policy as ref_policy
from gie_tpu.learn import train as ref_train
from gie_tpu.sched import ProfileConfig as JaxProfileConfig
from gie_tpu.sched import Scheduler as JaxScheduler
from gie_tpu.sched.config import tuned_profile as jax_tuned_profile

from gie_tpu_torch import convert
from gie_tpu_torch.learn import artifact, dataset, policy, train
from gie_tpu_torch.sched import ProfileConfig, Scheduler
from gie_tpu_torch.sched.config import tuned_profile
from tests.test_torch_pd import _endpoints as _pd_endpoints
from tests.test_torch_pd import jax_pd_noise_replay
from tests.test_torch_slice import (
    N,
    SEED,
    _assert_results,
    _assert_states,
    _endpoints,
    _wave,
    jax_noise_replay,
)

ARTIFACT = "config/policy/storm-lora-v1.json"
FIXTURES = "tests/fixtures/learn"


@pytest.fixture(autouse=True)
def _deterministic_torch():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _ulp_diff(a, b) -> int:
    """Max ULP distance between two strictly positive float32 arrays."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


# -- the multiplicative scorer -------------------------------------------------

@pytest.mark.parametrize("shape, seed", [((3, 16, 32), 11), ((6, 48, 64), 3)])
def test_multiplicative_total_matches_reference_within_ulps(shape, seed):
    rng = np.random.default_rng(seed)
    stacked = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    stacked[0, 0, :4] = 0.0                      # the EPS floor
    wvec = rng.uniform(0.0, 3.5, shape[0]).astype(np.float32)
    port = policy.multiplicative_total(
        torch.from_numpy(stacked), torch.from_numpy(wvec)).numpy()
    jaxed = np.asarray(jax.jit(ref_policy.multiplicative_total)(
        jnp.asarray(stacked), jnp.asarray(wvec)))
    numpy_ref = policy.multiplicative_total_reference(stacked, wvec)
    np.testing.assert_array_equal(
        numpy_ref, ref_policy.multiplicative_total_reference(stacked, wvec))
    assert port.dtype == np.float32 and port.shape == shape[1:]
    assert np.isfinite(port).all() and (port > 0).all()
    assert _ulp_diff(port, numpy_ref) <= 128
    assert _ulp_diff(port, jaxed) <= 128


def test_float32_hex_and_weights_from_mapping_match_reference():
    for value in (0.0, 1.0, 0.23914434015750885, 3.0714311599731445, -2.5):
        hexed = policy.float32_hex(value)
        assert hexed == ref_policy.float32_hex(value)
        assert policy.float32_from_hex(hexed) == np.float32(value)
    with pytest.raises(ValueError, match="8 hex chars"):
        policy.float32_from_hex("abcd")
    mapping = {"queue": 0.25, "kv_cache": 3.07, "prefix": 1.5}
    assert policy.weights_from_mapping(mapping) == convert.weights_from_numpy(
        ref_policy.weights_from_mapping(mapping))
    with pytest.raises(ValueError, match="unknown scorer columns"):
        policy.weights_from_mapping({"bogus": 1.0})


# -- the artifact ----------------------------------------------------------------

def _built(module):
    return module.build_artifact(
        {"queue": 0.5, "kv_cache": 2.0, "assumed_load": 0.0},
        ("queue", "kv_cache", "assumed_load"), {"seed": 3, "n_rows": 10})


def test_artifact_round_trip_is_byte_equal_to_reference():
    art = _built(artifact)
    text = artifact.dumps_artifact(art)
    assert text == ref_artifact.dumps_artifact(_built(ref_artifact))
    assert artifact.loads_artifact(text) == art
    shipped = artifact.load_artifact(ARTIFACT)
    assert shipped == ref_artifact.load_artifact(ARTIFACT)
    assert artifact.to_sched_weights(shipped) == convert.weights_from_numpy(
        ref_artifact.to_sched_weights(shipped))
    values = artifact.artifact_weight_values(shipped)
    assert {k: policy.float32_hex(v) for k, v in values.items()} == {
        "queue": "41e2743e", "kv_cache": "54924440",
        "assumed_load": "00000000"}
    judged = artifact.attach_judgment(art, {"promote": True})
    assert judged["checksum"] == ref_artifact.attach_judgment(
        _built(ref_artifact), {"promote": True})["checksum"]
    assert artifact.validate_artifact(judged) is judged


def _tampered():
    cases = {}
    art = _built(artifact)
    cases["checksum"] = dict(art, checksum="sha256:00")
    bad = json.loads(json.dumps(art))
    bad["weights"]["queue"]["value"] = 0.75
    bad["checksum"] = artifact.compute_checksum(bad)
    cases["half-edited"] = bad
    newer = json.loads(json.dumps(art))
    newer["schema"] = "gie-learn-policy/2"
    newer["checksum"] = artifact.compute_checksum(newer)
    cases["newer-major"] = newer
    missing = {k: v for k, v in art.items() if k != "provenance"}
    cases["missing-field"] = missing
    cases["not-a-policy"] = dict(art, schema="other/1")
    return cases


@pytest.mark.parametrize("case", sorted(_tampered()))
def test_tampered_artifact_is_refused_as_the_reference_refuses_it(case):
    art = _tampered()[case]
    with pytest.raises(ValueError) as port_err:
        artifact.validate_artifact(json.loads(json.dumps(art)))
    with pytest.raises(ValueError) as ref_err:
        ref_artifact.validate_artifact(json.loads(json.dumps(art)))
    assert str(port_err.value) == str(ref_err.value)


def test_feature_schema_gate():
    shipped = artifact.load_artifact(ARTIFACT)
    from gie_tpu.sched.profile import feature_schema as ref_schema
    from gie_tpu_torch.sched.profile import feature_schema

    live = feature_schema(tuned_profile()[0])
    assert live == ref_schema(jax_tuned_profile()[0])
    artifact.validate_feature_schema(shipped, tuple(reversed(live)))
    blind = artifact.build_artifact(
        {"queue": 1.0, "latency": 0.5}, ("queue", "latency"), {})
    with pytest.raises(ValueError, match=r"columns \['latency'\]"):
        artifact.validate_feature_schema(blind, live)


# -- dataset and trainer ---------------------------------------------------------

def test_trainer_rebuilds_the_shipped_artifact_byte_for_byte():
    """The fixture dumps through the port's loader and trainer give the
    reference trainer's artifact text, and the committed weight bits."""
    dumps = dataset.load_dumps([FIXTURES])
    ref_dumps = ref_dataset.load_dumps([FIXTURES])
    assert dumps == ref_dumps
    ds, ref_ds = dataset.build_dataset(dumps), ref_dataset.build_dataset(
        ref_dumps)
    np.testing.assert_array_equal(ds.features, ref_ds.features)
    np.testing.assert_array_equal(ds.latency_ms, ref_ds.latency_ms)
    assert ds.skipped == ref_ds.skipped and len(ds) > 100
    for frac in (0.0, 0.5):
        assert [a.tolist() for a in dataset.split_by_fingerprint(
            ds, frac, seed=7)] == [a.tolist() for a in
                                   ref_dataset.split_by_fingerprint(
                                       ref_ds, frac, seed=7)]
    art = train.train(dumps, seed=7, eval_fraction=0.0, l2=1.0)
    assert artifact.dumps_artifact(art) == ref_artifact.dumps_artifact(
        ref_train.train(ref_dumps, seed=7, eval_fraction=0.0, l2=1.0))
    shipped = artifact.load_artifact(ARTIFACT)
    assert {k: v["hex"] for k, v in art["weights"].items()} == {
        k: v["hex"] for k, v in shipped["weights"].items()}


def test_trainer_refuses_a_dump_with_nothing_to_train():
    with pytest.raises(ValueError, match="no trainable rows"):
        train.train([("fp", [{"outcome": "5xx"}])])


# -- the cycles ------------------------------------------------------------------

def _learned(jc, tc):
    art = artifact.load_artifact(ARTIFACT)
    return (dataclasses.replace(jc, scorer="learned"),
            ref_artifact.to_sched_weights(art),
            dataclasses.replace(tc, scorer="learned"),
            artifact.to_sched_weights(art))


def _cycle_configs(name):
    jc, jw = jax_tuned_profile()
    tc, tw = tuned_profile()
    if name == "learned-sinkhorn":
        return _learned(jc, tc)
    if name == "learned-sinkhorn-kernel":
        return _learned(dataclasses.replace(jc, use_pallas_sinkhorn=True),
                        dataclasses.replace(tc, use_pallas_sinkhorn=True))
    if name == "learned-topk":
        return _learned(JaxProfileConfig(picker="topk"),
                        ProfileConfig(picker="topk"))
    if name == "random":
        return (JaxProfileConfig(picker="random"), None,
                ProfileConfig(picker="random"), None)
    if name == "random-tuned":
        return (dataclasses.replace(jc, picker="random"), jw,
                dataclasses.replace(tc, picker="random"), tw)
    return (dataclasses.replace(jc, picker="random", pd_disaggregation=True),
            jw, dataclasses.replace(tc, picker="random",
                                    pd_disaggregation=True), tw)


CYCLES = ["learned-sinkhorn", "learned-sinkhorn-kernel", "learned-topk",
          "random", "random-tuned", "random-pd"]


@pytest.mark.parametrize("name", CYCLES)
def test_cycle_matches_reference_over_carried_waves(name):
    """Three carried waves with complete() feedback: indices, statuses
    and the prefix table exact; scores, load and duals within bounds.
    The random picker spreads each wave, so its picks are its noise's;
    the learned sinkhorn path solves on the multiplicative total."""
    jc, jw, tc, tw = _cycle_configs(name)
    pd = jc.pd_disaggregation
    jsched = JaxScheduler(jc, jw, seed=SEED)
    tsched = Scheduler(tc, tw, seed=SEED, device="cpu",
                       noise_source=(jax_pd_noise_replay if pd
                                     else jax_noise_replay)(SEED))
    eps = _pd_endpoints() if pd else _endpoints()
    teps = convert.endpoints_from_numpy(eps, device="cpu")
    picked = 0
    for w in range(3):
        reqs = _wave(w)
        ref = jsched.pick(reqs, eps)
        port = tsched.pick(convert.requests_from_numpy(reqs, device="cpu"),
                           teps)
        _assert_results(ref, port, tc.picker != "topk")
        if pd:
            np.testing.assert_array_equal(port.prefill,
                                          np.asarray(ref.prefill))
        picked += int((port.indices[:, 0] >= 0).sum())
        done = port.indices[: N // 2, 0]
        costs = np.full(done.shape, 0.25, np.float32)
        jsched.complete(done, costs)
        tsched.complete(done, costs)
        _assert_states(jsched.export_state(), tsched.export_state())
    assert picked > N * 3 // 2


def test_random_picker_spreads_a_wave_of_identical_requests():
    """Identical requests over identical endpoints: the top-k picker's
    quantized scores tie, so its rotation gives every request of the wave
    one endpoint; the random picker's noise spreads them."""
    from gie_tpu_torch.utils.testing import make_endpoints, make_requests

    eps = make_endpoints(16, m_slots=64)
    reqs = make_requests(64, prompt_len=[512.0] * 64, m_slots=64)
    topk = Scheduler(ProfileConfig(picker="topk"), device="cpu")
    rand = Scheduler(ProfileConfig(picker="random"), seed=2, device="cpu")
    assert len(set(topk.pick(reqs, eps).indices[:, 0].tolist())) == 1
    spread = set(rand.pick(reqs, eps).indices[:, 0].tolist())
    assert len(spread) >= 8 and spread <= set(range(16))


def test_reference_guards_still_apply():
    with pytest.raises(ValueError, match="use_pallas_topk"):
        ProfileConfig(scorer="learned", picker="topk", use_pallas_topk=True)
    with pytest.raises(ValueError, match="pd_disaggregation"):
        ProfileConfig(scorer="learned", pd_disaggregation=True)
    with pytest.raises(ValueError, match="scorer must be"):
        ProfileConfig(scorer="bogus")
    assert ProfileConfig(picker="random").picker == "random"


# -- the runner and the storm twin -----------------------------------------------

def _runner_for(pkg, argv, monkeypatch):
    import importlib

    from tests.test_torch_extproc import _parse
    from tests.test_torch_runner import _cluster

    opts = _parse(pkg, argv + ["--pool-name", "p", "--no-resilience",
                               "--no-obs"])
    runner_mod = importlib.import_module(f"{pkg}.runtime.runner")
    if pkg == "gie_tpu_torch":
        # The runner builds its Scheduler with no device (the card); the
        # CPU build here differs from it in the device alone.
        cpu = runner_mod.Scheduler
        monkeypatch.setattr(runner_mod, "Scheduler",
                            lambda *a, **k: cpu(*a, device="cpu", **k))
    runner = runner_mod.ExtProcServerRunner(opts, _cluster(pkg))
    runner.picker.background_warm = False
    return runner


def test_runner_loads_the_policy_as_the_reference_does(monkeypatch):
    argv = ["--scorer", "learned", "--policy-artifact", ARTIFACT]
    port = _runner_for("gie_tpu_torch", argv, monkeypatch)
    ref = _runner_for("gie_tpu", argv, monkeypatch)
    try:
        assert port.scheduler.cfg.scorer == "learned"
        assert dataclasses.asdict(port.scheduler.cfg) == dataclasses.asdict(
            ref.scheduler.cfg)
        assert port.scheduler.weights == convert.weights_from_numpy(
            ref.scheduler.weights)
        report = port._policy_report()
        assert report == ref._policy_report()
        assert report["artifact"]["checksum"] == artifact.load_artifact(
            ARTIFACT)["checksum"]
        assert report["artifact"]["judgment_promote"] is True
    finally:
        port.stop()
        ref.stop()


def test_runner_refuses_a_stale_artifact(tmp_path, monkeypatch):
    blind = artifact.build_artifact(
        {"queue": 1.0, "latency": 0.5}, ("queue", "latency"), {})
    path = tmp_path / "blind.json"
    path.write_text(artifact.dumps_artifact(blind))
    with pytest.raises(ValueError, match="live profile does not produce"):
        _runner_for("gie_tpu_torch", ["--scorer", "learned",
                                      "--policy-artifact", str(path)],
                    monkeypatch)


def test_storm_engine_builds_the_learned_scorer():
    from gie_tpu.learn.judge import policy_weights_spec
    from gie_tpu_torch.storm.engine import EngineConfig, engine_from_drive

    art = artifact.load_artifact(ARTIFACT)
    storm = {"traffic": {"base_qps": 2.0, "duration_s": 1.0,
                         "n_sessions": 2}, "pool": {"n_pods": 3}}
    engine = engine_from_drive(
        storm, seed=1, name="learned", device="cpu",
        cfg=EngineConfig(scorer="learned",
                         policy_weights=policy_weights_spec(art)))
    try:
        assert engine.scheduler.cfg.scorer == "learned"
        assert engine.scheduler.weights == artifact.to_sched_weights(art)
    finally:
        engine.close()
