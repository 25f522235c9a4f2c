"""gie_tpu_torch's latency predictor against gie_tpu/models/latency.py on
the CPU, and the predictor's wiring (Scheduler column, picker feedback and
SLO admission, runner, autoscale probe, replication) against the
reference's behaviour cases.

Inputs come from numpy seeds and gie_tpu/utils/testing.py; params are
carried from the reference's flax tree with gie_tpu_torch.convert.

Tolerances, and why:
  * build_features and host_features: exact (the same f32 ops; every
    normalizer is a power of two).
  * The MLP's outputs, request latency and the scorer column: rtol 2e-3.
    Both sides round to bf16 after each op of the hidden layers, but the
    bf16 products and tanh round differently inside (measured: max
    relative error 7e-4 on [1024, 256] grids).
  * One AdamW step: the loss within rtol 1e-4; each param within
    2 * lr + 1e-5 of the reference's, and 99% of them within 1e-5. Adam's
    first step moves an element by about lr * sign(gradient), so a
    gradient near zero whose sign the bf16 rounding flips moves it the
    other way: 2 * lr is the only bound a step can promise there.
  * The cycle with the column: exact, through a FIXED column given to both
    Schedulers (the reference's own seam: predictor_fn is a callable).
  * The trainer's buffer, masks, index draws and confidence: exact.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from gie_tpu.models import latency as JL
from gie_tpu.sched import ProfileConfig as JaxProfileConfig
from gie_tpu.sched import Scheduler as JaxScheduler
from gie_tpu.sched import Weights as JaxWeights
from gie_tpu.sched.profile import feature_schema as jax_feature_schema
from gie_tpu.utils.testing import make_endpoints, make_requests

from gie_tpu_torch import convert
from gie_tpu_torch.models import latency as TL
from gie_tpu_torch.sched import ProfileConfig, Scheduler
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.profile import feature_schema
from tests.test_torch_pd import jax_pd_noise_replay
from tests.test_torch_slice import _configs, _endpoints, _wave, jax_noise_replay

RTOL = 2e-3
SEED = 11


def _carried(seed: int = 0):
    """(reference params, the same params in the port's layout)."""
    ref = JL.LatencyPredictor().init(jax.random.PRNGKey(seed))
    ref = jax.tree.map(np.asarray, ref)
    return ref, convert.predictor_params_from_numpy(ref, device="cpu")


def _batch(n: int, m: int, seed: int):
    """A reference (reqs, eps, load) triple with every feature live:
    prompt and decode lengths, LoRA ids, queue, KV, running, metrics ages
    below 0 and above the clip, assumed load."""
    rng = np.random.default_rng(seed)
    live = m - 3
    reqs = make_requests(n, prompt_len=rng.uniform(10, 9000, n).tolist(),
                         lora_id=rng.integers(-1, 5, n).tolist(), m_slots=m)
    reqs = reqs.replace(decode_len=jnp.asarray(
        rng.uniform(0, 4096, n).astype(np.float32)))
    eps = make_endpoints(live, queue=rng.integers(0, 90, live).tolist(),
                         kv=rng.uniform(0, 1, live).tolist(),
                         running=rng.integers(0, 70, live).tolist(),
                         m_slots=m)
    metrics = np.asarray(eps.metrics).copy()
    metrics[:, C.Metric.METRICS_AGE_S] = rng.uniform(-2, 14, m)
    eps = eps.replace(metrics=jnp.asarray(metrics))
    load = rng.uniform(0, 40, m).astype(np.float32)
    return reqs, eps, load


def _port(reqs, eps, load):
    return (convert.requests_from_numpy(reqs, device="cpu"),
            convert.endpoints_from_numpy(eps, device="cpu"),
            torch.from_numpy(load))


# -- features ------------------------------------------------------------


@pytest.mark.parametrize("n, m", [(8, 64), (33, 256)])
def test_build_features_exact(n, m):
    reqs, eps, load = _batch(n, m, seed=n + m)
    ref = np.asarray(JL.build_features(reqs, eps, jnp.asarray(load)))
    got = TL.build_features(*_port(reqs, eps, load)).numpy()
    assert got.shape == (n, m, TL.NUM_FEATURES)
    np.testing.assert_array_equal(got, ref)


def test_host_features_exact_and_equal_to_the_grid():
    reqs, eps, load = _batch(16, 64, seed=3)
    grid = TL.build_features(*_port(reqs, eps, load)).numpy()
    metrics = np.asarray(eps.metrics)
    plen, dlen = np.asarray(reqs.prompt_len), np.asarray(reqs.decode_len)
    lora = np.asarray(reqs.lora_id)
    for i, s in [(0, 0), (3, 17), (15, 63), (7, 60)]:
        args = (metrics[s], float(load[s]), float(plen[i]), float(dlen[i]),
                bool(lora[i] >= 0))
        got = TL.host_features(*args)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, JL.host_features(*args))
        np.testing.assert_array_equal(got, grid[i, s])


# -- the MLP and the column ------------------------------------------------


@pytest.mark.parametrize("what", ["predict", "request_latency", "score_fn"])
def test_mlp_and_column_within_tolerance(what):
    ref_params, params = _carried()
    jp, tp = JL.LatencyPredictor(), TL.LatencyPredictor()
    if what == "score_fn":
        reqs, eps, load = _batch(64, 256, seed=9)
        ref = JL.predictor_score_fn(jp)(ref_params, reqs, eps,
                                        jnp.asarray(load))
        got = TL.predictor_score_fn(tp)(params, *_port(reqs, eps, load))
        assert got.shape == (64, 256)
        assert float(got.min()) > 0.0 and float(got.max()) <= 1.0
    else:
        rng = np.random.default_rng(4)
        feats = rng.uniform(0, 1, (48, 200, TL.NUM_FEATURES)).astype(
            np.float32)
        slots = rng.integers(-3, C.M_MAX + 5, (48, 200)).astype(np.int32)
        if what == "predict":
            ref = jp.predict(ref_params, feats, slots)
            got = tp.predict(params, feats, slots)
        else:
            decode = rng.uniform(0, 4096, 48).astype(np.float32)
            ref = jp.request_latency(ref_params, feats, slots,
                                     jnp.asarray(decode))
            got = tp.request_latency(params, feats, slots,
                                     torch.from_numpy(decode))
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


def test_init_follows_flax_distributions():
    ref, _ = _carried()
    params = TL.LatencyPredictor().init(seed=0)
    assert set(params) == set(TL.param_shapes(TL.LatencyPredictorConfig()))
    tree = convert.predictor_params_to_numpy(params)
    n = 0
    for module, leaves in ref["params"].items():
        for leaf, want in leaves.items():
            got = tree["params"][module][leaf]
            assert got.shape == want.shape and got.dtype == np.float32
            n += got.size
            if leaf == "bias":
                assert not got.any()
                continue
            # The same law: the std within 5%, and a Dense kernel truncated
            # at two of its normal's standard deviations.
            assert abs(got.std() / want.std() - 1) < 0.05, module
            if module.startswith("Dense"):
                bound = 2 / np.sqrt(got.shape[0]) / .87962566103423978
                assert np.abs(got).max() <= bound + 1e-6, module
    assert n == 27146
    # The init is the generator's, on any device: same seed, same params.
    again = TL.LatencyPredictor().init(seed=0)
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_one_train_step_within_tolerance():
    ref_params, params = _carried()
    jp, tp = JL.LatencyPredictor(), TL.LatencyPredictor()
    tx = optax.adamw(1e-3, weight_decay=1e-4)
    step = JL.make_train_step(jp, tx)
    module = tp.module()
    module.load_state_dict(params)
    opt = TL.make_optimizer(module, tp.cfg)
    rng = np.random.default_rng(1)
    f = rng.uniform(size=(256, 8)).astype(np.float32)
    s = rng.integers(0, C.M_MAX + 1, 256).astype(np.int32)
    t = rng.uniform(0, 2, (256, 2)).astype(np.float32)
    w = (rng.uniform(size=(256, 2)) < 0.7).astype(np.float32)
    new_ref, _, loss_ref = step(ref_params, tx.init(ref_params), f, s, t, w)
    loss = TL.make_train_step(tp)(
        module, opt, torch.from_numpy(f), torch.from_numpy(s.astype(np.int64)),
        torch.from_numpy(t), torch.from_numpy(w))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-4)
    want = convert.predictor_params_from_numpy(
        jax.tree.map(np.asarray, new_ref), device="cpu")
    close = total = 0
    for k, v in module.state_dict().items():
        diff = (v - want[k]).abs()
        assert float(diff.max()) <= 2 * 1e-3 + 1e-5, k
        close += int((diff <= 1e-5).sum())
        total += diff.numel()
    assert close >= 0.99 * total


def _fill(trainer, rng, count):
    for _ in range(count):
        f = rng.uniform(0, 1, TL.NUM_FEATURES).astype(np.float32)
        head = rng.integers(0, 3)
        trainer.observe(f, ttft_s=None if head == 1 else float(f[3]),
                        tpot_s=None if head == 0 else float(f[4]) * 0.1,
                        slot=int(rng.integers(-5, C.M_MAX + 9)))
    trainer.observe(np.zeros(TL.NUM_FEATURES, np.float32), None, None)


def test_online_trainer_host_logic_equals_reference():
    """Ring buffer (it wraps), per-head masks, slot clipping, the index
    draws of np.random.default_rng(seed), PREDICT_PAD and confidence()
    given the same loss: exact."""
    ref = JL.OnlineTrainer(JL.LatencyPredictor(), seed=3, capacity=96,
                           batch_size=32, confidence_min_samples=150)
    port = TL.OnlineTrainer(TL.LatencyPredictor(), seed=3, capacity=96,
                            batch_size=32, confidence_min_samples=150,
                            device="cpu")
    for trainer in (ref, port):
        _fill(trainer, np.random.default_rng(8), 130)
    for name in ("_feats", "_slots", "_targets", "_weights", "_n", "_head",
                 "_observed_total", "capacity", "PREDICT_PAD"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), err_msg=name)
    assert ref.confidence() == port.confidence() == 0.0
    carried = convert.predictor_params_from_numpy(
        jax.tree.map(np.asarray, ref.params), device="cpu")
    port._load_params({k: v.numpy() for k, v in carried.items()})
    assert ref.train(steps=3) is not None and port.train(steps=3) is not None
    assert (port._rng.bit_generator.state == ref._rng.bit_generator.state)
    np.testing.assert_allclose(port.last_loss, ref.last_loss, rtol=1e-3)
    for ema in (0.01, 0.05, 0.2):
        ref._loss_ema = port._loss_ema = ema
        assert port.confidence() == ref.confidence()
    few = JL.OnlineTrainer(JL.LatencyPredictor(), batch_size=32)
    assert few.train() is None
    assert TL.OnlineTrainer(TL.LatencyPredictor(), batch_size=32,
                            device="cpu").train() is None
    # predict_ttft: the padded forward, within the column's tolerance.
    feats = ref._feats[:70]
    slots = ref._slots[:70]
    carried = convert.predictor_params_from_numpy(
        jax.tree.map(np.asarray, ref.params), device="cpu")
    port._load_params({k: v.numpy() for k, v in carried.items()})
    np.testing.assert_allclose(port.predict_ttft(feats, slots),
                               ref.predict_ttft(feats, slots), rtol=RTOL)
    assert port.predict_ttft(feats[:0], slots[:0]).shape == (0,)


def test_trainer_reduces_loss():
    """tests/test_models_parallel.py's case on the port: the MLP learns a
    simple latency relationship online (the loss halves)."""
    trainer = TL.OnlineTrainer(TL.LatencyPredictor(), batch_size=64,
                               device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(512):
        f = rng.uniform(0, 1, TL.NUM_FEATURES).astype(np.float32)
        trainer.observe(f, ttft_s=0.1 + 2.0 * f[3], tpot_s=0.01 + 0.05 * f[4])
    first = trainer.train(steps=1)
    for _ in range(30):
        last = trainer.train(steps=5)
    assert first is not None and last is not None
    assert last < first * 0.5


# -- digests and checkpoints ------------------------------------------------


def _trainers():
    ref = JL.OnlineTrainer(JL.LatencyPredictor(), seed=1)
    ref._loss_ema, ref._observed_total = 0.03, 500
    port = TL.OnlineTrainer(TL.LatencyPredictor(), seed=2, device="cpu")
    port._loss_ema, port._observed_total = 0.02, 700
    return ref, port


def _same_digest(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y, equal_nan=True), k


def test_digest_keys_and_installs_both_ways():
    ref, port = _trainers()
    want, got = ref.export_state(), port.export_state()
    assert list(got) == list(want)
    for k in want:
        assert np.asarray(got[k]).shape == np.asarray(want[k]).shape, k
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    # Reference leader -> port follower: bit-equal, same confidence.
    assert port.install_state(want)
    _same_digest(port.export_state(), want)
    assert port.confidence() == ref.confidence()
    assert port.optimizer.state == {}          # restarted fresh
    # Port leader -> reference follower.
    ref2, port2 = _trainers()
    assert ref2.install_state(port2.export_state())
    _same_digest(ref2.export_state(), port2.export_state())
    assert ref2.confidence() == port2.confidence()


@pytest.mark.parametrize("fault", ["shape", "missing-param", "missing-ema"])
def test_digest_rejects_whole(fault):
    ref, port = _trainers()
    exported = ref.export_state()
    leaf = "param['params']['Dense_1']['kernel']"
    if fault == "shape":
        exported[leaf] = np.zeros((129, 128), np.float32)
    elif fault == "missing-param":
        del exported[leaf]
    else:
        del exported["loss_ema"]
    before = port.export_state()
    assert not port.install_state(exported)
    assert not ref.install_state(exported)
    _same_digest(port.export_state(), before)


def test_npz_checkpoint_round_trip(tmp_path):
    _, port = _trainers()
    port.save(str(tmp_path / "ckpt"))
    other = TL.OnlineTrainer(TL.LatencyPredictor(), seed=9, device="cpu")
    assert other.restore(str(tmp_path / "ckpt"))
    _same_digest(other.export_state(), port.export_state())
    assert other.confidence() == port.confidence()
    # The file holds the reference's {"params", "meta"} tree, flattened.
    with np.load(tmp_path / "ckpt" / "pytree.npz") as saved:
        keys = set(saved.files)
    assert "params['params']['Embed_0']['embedding']" in keys
    assert {"meta['loss_ema']", "meta['observed_total']"} <= keys
    assert not other.restore(str(tmp_path / "missing"))


def test_legacy_params_only_checkpoint_seeds_full_confidence(tmp_path):
    from gie_tpu_torch.utils.checkpoint import save_pytree

    ref, _ = _trainers()
    tree = {k[len("param"):]: v for k, v in ref.export_state().items()
            if k.startswith("param")}
    save_pytree(str(tmp_path / "legacy"), tree)
    port = TL.OnlineTrainer(TL.LatencyPredictor(), device="cpu")
    assert port.confidence() == 0.0
    assert port.restore(str(tmp_path / "legacy"))
    assert port.confidence() == 1.0
    got = port.export_state()
    for k, v in tree.items():
        np.testing.assert_array_equal(got["param" + k], v)


# -- the column in the Scheduler --------------------------------------------


def _fixed_columns(seed: int):
    """(reference predictor_fn, port predictor_fn) returning one fixed
    [N, M] column a shape, the same on both sides."""
    rng = np.random.default_rng(seed)
    cols: dict = {}

    def col(reqs, eps):
        key = (int(reqs.valid.shape[0]), int(eps.valid.shape[0]))
        if key not in cols:
            cols[key] = rng.uniform(0.05, 1.0, key).astype(np.float32)
        return cols[key]

    return (lambda p, r, e, l: jnp.asarray(col(r, e)),
            lambda p, r, e, l: torch.from_numpy(col(r, e)))


def _pair(name: str, pd: bool, latency: float = 1.5):
    if name in ("random", "learned"):
        kw = ({"picker": "random"} if name == "random"
              else {"scorer": "learned", "picker": "sinkhorn"})
        jc, jw = JaxProfileConfig(**kw), None
        tc, tw = ProfileConfig(**kw), None
    else:
        jc, jw, tc, tw = _configs(name)
    if pd:
        jc = dataclasses.replace(jc, pd_disaggregation=True)
        tc = dataclasses.replace(tc, pd_disaggregation=True)
    jw = (jw or JaxWeights.default()).replace(latency=jnp.float32(latency))
    jfn, tfn = _fixed_columns(SEED)
    js = JaxScheduler(jc, jw, predictor_fn=jfn, seed=SEED)
    ts = Scheduler(tc, convert.weights_from_numpy(jw), seed=SEED,
                   device="cpu", predictor_fn=tfn,
                   noise_source=(jax_pd_noise_replay if pd
                                 else jax_noise_replay)(SEED))
    return js, ts


CYCLES = [(name, pd) for name in ("tuned-sinkhorn-kernel", "topk-kernel",
                                   "random") for pd in (False, True)]
CYCLES.append(("learned", False))


@pytest.mark.parametrize(
    "name, pd", CYCLES,
    ids=[f"{name}-{'pd' if pd else 'classic'}" for name, pd in CYCLES])
def test_cycle_with_a_fixed_column_equals_reference(name, pd):
    js, ts = _pair(name, pd)
    assert ts.weights.latency == 0.0 and ts.base_latency_weight == 1.5
    for conf in (0.0, 0.5, 1.0):
        assert ts.gate_latency_column(conf) == js.gate_latency_column(conf)
        assert ts.weights.latency == float(js.weights.latency)
    eps = _endpoints()
    if pd:
        roles = np.random.default_rng(2).integers(0, 3, eps.valid.shape[0])
        eps = eps.replace(role=jnp.asarray(roles.astype(np.int32)))
    teps = convert.endpoints_from_numpy(eps, device="cpu")
    for w, conf in enumerate((0.3, 1.0, 0.7)):
        js.gate_latency_column(conf)
        ts.gate_latency_column(conf)
        reqs = _wave(w)
        ref = js.pick(reqs, eps)
        got = ts.pick(convert.requests_from_numpy(reqs, device="cpu"), teps)
        np.testing.assert_array_equal(got.indices, np.asarray(ref.indices))
        np.testing.assert_array_equal(got.status, np.asarray(ref.status))
        if pd:
            np.testing.assert_array_equal(got.prefill,
                                          np.asarray(ref.prefill))
        assert (got.status == 0).sum() > 0


def test_explain_and_schema_carry_the_column():
    js, ts = _pair("tuned-sinkhorn-kernel", False)
    js.gate_latency_column(1.0)
    ts.gate_latency_column(1.0)
    eps = _endpoints()
    reqs = _wave(0)
    ref = js.explain(reqs, eps)
    got = ts.explain(convert.requests_from_numpy(reqs, device="cpu"),
                     convert.endpoints_from_numpy(eps, device="cpu"))
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), atol=1e-6,
                                   err_msg=k)
    for kw in ({}, {"enable_prefix": False}, {"enable_lora": False,
                                              "enable_session": False}):
        for has in (False, True):
            assert feature_schema(ProfileConfig(**kw), has_predictor=has) == (
                jax_feature_schema(JaxProfileConfig(**kw), has_predictor=has))
    assert ts._graph_schema()[-1] == "latency"
    assert ts.debug_report()["latency_weight_ceiling"] == 1.5


def test_real_column_in_the_cycle_within_tolerance():
    """The predictor's own column (carried params) in explain, and a
    parameter handoff that changes it."""
    ref_params, params = _carried()
    jp, tp = JL.LatencyPredictor(), TL.LatencyPredictor()
    jw = JaxWeights.default().replace(latency=jnp.float32(2.0))
    js = JaxScheduler(JaxProfileConfig(), jw,
                      predictor_fn=JL.predictor_score_fn(jp),
                      predictor_params=ref_params)
    ts = Scheduler(ProfileConfig(), convert.weights_from_numpy(jw),
                   device="cpu", predictor_fn=TL.predictor_score_fn(tp),
                   predictor_params=params)
    assert ts.predictor_params["Dense_1.weight"] is not params[
        "Dense_1.weight"]          # the scheduler's own static copy
    eps, reqs = _endpoints(), _wave(1)
    teps = convert.endpoints_from_numpy(eps, device="cpu")
    treqs = convert.requests_from_numpy(reqs, device="cpu")
    np.testing.assert_allclose(ts.explain(treqs, teps)["latency"],
                               np.asarray(js.explain(reqs, eps)["latency"]),
                               rtol=RTOL)
    ref2, params2 = _carried(seed=5)
    buffers = dict(ts.predictor_params)
    js.set_predictor_params(ref2)
    ts.set_predictor_params(params2)
    assert all(ts.predictor_params[k] is buffers[k] for k in buffers)
    np.testing.assert_allclose(ts.explain(treqs, teps)["latency"],
                               np.asarray(js.explain(reqs, eps)["latency"]),
                               rtol=RTOL)
    with pytest.raises(ValueError, match="shape"):
        ts.set_predictor_params({**params2, "Dense_0.bias": torch.zeros(3)})
    with pytest.raises(ValueError, match="match"):
        ts.set_predictor_params({"Dense_0.bias": torch.zeros(128)})


def test_learned_artifact_validates_with_the_column():
    """An artifact trained on the latency column validates against a
    profile with the predictor bound and fails startup without it, in
    both packages."""
    from gie_tpu.learn import artifact as jax_artifact

    from gie_tpu_torch.learn import artifact as artifact_mod

    art = artifact_mod.load_artifact("config/policy/storm-lora-v1.json")
    art = dict(art, feature_schema=list(art["feature_schema"]) + ["latency"])
    for mod, schema in ((artifact_mod, feature_schema),
                        (jax_artifact, jax_feature_schema)):
        cfg = (ProfileConfig() if mod is artifact_mod
               else JaxProfileConfig())
        mod.validate_feature_schema(art, schema(cfg, has_predictor=True))
        with pytest.raises(ValueError, match="latency"):
            mod.validate_feature_schema(art, schema(cfg))


def test_fleet_picker_at_covering_k_passes_the_column():
    from gie_tpu.fleet import FleetPicker as JaxFleetPicker

    from gie_tpu_torch.fleet import FleetPicker

    jfn, tfn = _fixed_columns(7)
    jc, jw, tc, tw = _configs("tuned-sinkhorn-kernel")
    jw = jw.replace(latency=jnp.float32(1.0))
    js = JaxFleetPicker(jc, jw, predictor_fn=jfn, seed=SEED, topk=2,
                        cell_cap=32)
    ts = FleetPicker(tc, convert.weights_from_numpy(jw), seed=SEED,
                     device="cpu", noise_source=jax_noise_replay(SEED),
                     predictor_fn=tfn, topk=2, cell_cap=32)
    js.gate_latency_column(1.0)
    ts.gate_latency_column(1.0)
    assert ts._graph_schema()[:len(feature_schema(tc, has_predictor=True))] \
        == feature_schema(tc, has_predictor=True)
    eps = _endpoints()
    teps = convert.endpoints_from_numpy(eps, device="cpu")
    for w in range(2):
        reqs = _wave(w)
        ref = js.pick(reqs, eps)
        got = ts.pick(convert.requests_from_numpy(reqs, device="cpu"), teps)
        np.testing.assert_array_equal(got.indices, np.asarray(ref.indices))
        np.testing.assert_array_equal(got.status, np.asarray(ref.status))


def test_trained_tpot_column_steers_pd_decode_pick():
    """tests/test_tpot_training.py's pd case on the port: the TPOT head
    learns that slot 0 decodes fast, and every decode pick goes there."""
    from gie_tpu_torch.sched.profile import scheduling_cycle
    from gie_tpu_torch.sched.types import SchedState, Weights
    from gie_tpu_torch.utils.testing import make_endpoints as t_endpoints
    from gie_tpu_torch.utils.testing import make_requests as t_requests

    predictor = TL.LatencyPredictor()
    trainer = TL.OnlineTrainer(predictor, batch_size=64, device="cpu")
    feats = np.zeros((TL.NUM_FEATURES,), np.float32)
    rng = np.random.default_rng(0)
    for _ in range(256):
        trainer.observe(feats, ttft_s=0.1,
                        tpot_s=0.01 + rng.normal(0, 1e-4), slot=0)
        trainer.observe(feats, ttft_s=0.1,
                        tpot_s=0.20 + rng.normal(0, 1e-4), slot=1)
    for _ in range(60):
        trainer.train(steps=5)
    pred = predictor.predict(trainer.params, np.stack([feats, feats]),
                             np.asarray([0, 1]))
    assert pred[0, 1] < pred[1, 1], "TPOT head failed to separate slots"

    cfg = ProfileConfig(pd_disaggregation=True, enable_prefix=False,
                        enable_session=False)
    eps = t_endpoints(4, queue=[0] * 4, kv=[0.1] * 4,
                      role=[int(C.Role.DECODE), int(C.Role.DECODE),
                            int(C.Role.PREFILL), int(C.Role.PREFILL)],
                      m_slots=64)
    reqs = t_requests(8, prompt_len=[2048.0] * 8, m_slots=64)
    reqs = reqs.replace(decode_len=torch.full((8,), 4096.0))
    res, _ = scheduling_cycle(
        SchedState.init(m=64, device="cpu"), reqs, eps,
        Weights.default().replace(latency=2.0), None, cfg=cfg,
        predictor_fn=TL.predictor_score_fn(predictor),
        predictor_params=trainer.params)
    assert (res.indices[:, 0] == 0).all(), res.indices[:, 0]


# -- the picker: feedback and SLO admission ---------------------------------


def _picker(n_pods=2, **kw):
    from gie_tpu_torch.datastore import Datastore
    from gie_tpu_torch.datastore.objects import EndpointPool, Pod
    from gie_tpu_torch.metricsio import MetricsStore
    from gie_tpu_torch.sched.batching import BatchingTPUPicker

    sched = Scheduler(ProfileConfig(load_decay=1.0), device="cpu")
    ms = MetricsStore()
    ds = Datastore()
    ds.pool_set(EndpointPool({"app": "x"}, [8000], "default"))
    for i in range(n_pods):
        ds.pod_update_or_add(
            Pod(name=f"p{i}", labels={"app": "x"}, ip=f"10.9.1.{i + 1}"))
    return sched, ds, BatchingTPUPicker(sched, ds, ms, max_wait_s=0.02, **kw)


def test_picks_carry_feedback_and_served_trains_ttft():
    from gie_tpu_torch.extproc.pick import PickRequest

    trainer = TL.OnlineTrainer(TL.LatencyPredictor(), batch_size=8,
                               device="cpu")
    sched, ds, picker = _picker(trainer=trainer)
    try:
        res = picker.pick(PickRequest(headers={}, body=b"x" * 100),
                          ds.endpoints())
        feats, slot, picked_at, hostport = res.feedback
        assert hostport == res.endpoint and slot == res.charged_slot
        # The row is the host twin of the wave's features, with the load
        # the cycle left on the picked slot.
        assert feats[0] == np.float32(100 / TL.PROMPT_NORM)
        assert feats[7] == np.float32(res.assumed_cost / TL.LOAD_NORM)
        picker.observe_served(res.endpoint, SimpleNamespace(
            pick_result=res, resp_status=200))
        assert trainer._n == 1 and trainer._weights[0].tolist() == [1.0, 0.0]
        # Failover and 5xx train nothing.
        picker.observe_served("10.9.1.9:8000", SimpleNamespace(
            pick_result=res, resp_status=200))
        picker.observe_served(res.endpoint, SimpleNamespace(
            pick_result=res, resp_status=503))
        assert trainer._n == 1
    finally:
        picker.close()


def test_observe_response_complete_trains_tpot_head():
    """tests/test_tpot_training.py's case on the port's picker."""
    trainer = TL.OnlineTrainer(TL.LatencyPredictor(), batch_size=8,
                               device="cpu")
    _, _, picker = _picker(trainer=trainer)
    try:
        feats = np.zeros((TL.NUM_FEATURES,), np.float32)
        ctx = SimpleNamespace(
            pick_result=SimpleNamespace(
                feedback=(feats, 1, 0.0, "10.9.1.2:8000")),
            served_hostport="10.9.1.2:8000", resp_tokens=11,
            resp_first_at=10.0, resp_last_at=10.5,
            timing_is_generation=True)
        picker.observe_response_complete(ctx)
        assert trainer._n == 1
        np.testing.assert_allclose(trainer._targets[0], [0.0, 0.05])
        np.testing.assert_allclose(trainer._weights[0], [0.0, 1.0])
        ctx.served_hostport = "10.9.1.1:8000"          # failover
        picker.observe_response_complete(ctx)
        ctx.served_hostport = "10.9.1.2:8000"
        ctx.resp_tokens = 1                            # one chunk
        picker.observe_response_complete(ctx)
        ctx.resp_tokens, ctx.timing_is_generation = 500, False
        picker.observe_response_complete(ctx)
        assert trainer._n == 1
    finally:
        picker.close()


def test_slo_admission_sheds_and_releases_charge():
    """tests/test_batching_robustness.py's case on the port."""
    from gie_tpu_torch.extproc import metadata as mdkeys
    from gie_tpu_torch.extproc.pick import PickRequest

    trainer = TL.OnlineTrainer(TL.LatencyPredictor(), device="cpu")
    trainer.predict_ttft = lambda feats, slots: np.full(
        (len(slots),), 9.9, np.float32)        # everything predicted late
    sched, ds, picker = _picker(trainer=trainer)
    try:
        slo = {mdkeys.TTFT_SLO_MS_KEY: ["500"]}
        cold = picker.pick(PickRequest(headers=slo, body=b"x"),
                           ds.endpoints())
        assert ":" in cold.endpoint                 # cold start admits
        picker.observe_served(cold.endpoint,
                              SimpleNamespace(pick_result=cold))
        trainer.last_loss = 0.01
        with pytest.raises(Exception) as exc:
            picker.pick(PickRequest(headers=slo, body=b"x"), ds.endpoints())
        assert type(exc.value).__name__ == "ShedError"
        assert float(sched.snapshot_assumed_load().sum()) == pytest.approx(
            0.0, abs=1e-6)
        ok = picker.pick(PickRequest(headers={}, body=b"x"), ds.endpoints())
        assert ":" in ok.endpoint
        crit = picker.pick(PickRequest(
            headers={**slo, mdkeys.OBJECTIVE_KEY: ["critical"]}, body=b"x"),
            ds.endpoints())
        assert ":" in crit.endpoint
    finally:
        picker.close()


# -- the runner, the autoscale probe and replication ------------------------


@pytest.fixture
def cpu_default(monkeypatch):
    """The runner builds its Scheduler and trainer with no device (the
    card); here the default becomes the CPU."""
    from gie_tpu_torch.sched import profile

    real = profile.resolve_device
    monkeypatch.setattr(profile, "resolve_device",
                        lambda d: real("cpu" if d is None else d))


def _runner(tmp_path, latency: float, **kw):
    from gie_tpu_torch.controller import FakeCluster
    from gie_tpu_torch.runtime.options import Options
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner

    path = tmp_path / "sched.yaml"
    path.write_text(f"weights:\n  latency: {latency}\n")
    opts = Options(pool_name="p", enable_predictor=True,
                   scheduler_config=str(path), **kw)
    return ExtProcServerRunner(opts, FakeCluster())


def test_runner_binds_the_column_only_with_a_ceiling(tmp_path, cpu_default):
    """tests/test_runtime.py's case: with --enable-predictor and no
    weights.latency the trainer runs but the cycle has no column."""
    runner = _runner(tmp_path, 0.0)
    try:
        assert runner.trainer is not None
        assert runner.picker.trainer is runner.trainer
        assert runner.scheduler.predictor_fn is None
        assert runner.scheduler.base_latency_weight == 0.0
    finally:
        runner.stop()
    runner = _runner(tmp_path, 1.0)
    try:
        assert runner.scheduler.predictor_fn is not None
        assert runner.scheduler.base_latency_weight == 1.0
        assert runner.scheduler.weights.latency == 0.0
        assert runner.scheduler._graph_schema()[-1] == "latency"
    finally:
        runner.stop()


def test_runner_train_loop_hands_off_gates_and_checkpoints(tmp_path,
                                                          cpu_default):
    ckpt = tmp_path / "ckpt"
    runner = _runner(tmp_path, 1.0, predictor_checkpoint_dir=str(ckpt),
                     predictor_train_interval_s=0.05)
    trainer, sched = runner.trainer, runner.scheduler
    try:
        trainer.batch_size = 16
        rng = np.random.default_rng(0)
        for _ in range(2048):
            f = rng.uniform(0, 1, TL.NUM_FEATURES).astype(np.float32)
            trainer.observe(f, ttft_s=0.05, tpot_s=0.01)
        buffers = dict(sched.predictor_params)
        runner._train_thread = None
        runner._train_stop.clear()
        import threading

        runner._train_thread = threading.Thread(target=runner._train_loop,
                                                daemon=True)
        runner._train_thread.start()
        deadline = 200
        while (trainer.last_loss is None or not ckpt.exists()
               or sched.weights.latency == 0.0) and deadline:
            runner._train_stop.wait(0.05)
            deadline -= 1
        assert sched.weights.latency > 0.0
        # The handoff copied into the same static buffers.
        assert all(sched.predictor_params[k] is buffers[k] for k in buffers)
        assert not torch.equal(buffers["Dense_1.weight"],
                               TL.LatencyPredictor().init()["Dense_1.weight"])
    finally:
        runner.stop()
    confidence = trainer.confidence()
    again = _runner(tmp_path, 1.0, predictor_checkpoint_dir=str(ckpt))
    try:
        assert again.trainer.confidence() > 0.0
        assert again.scheduler.weights.latency == pytest.approx(
            min(1.0, again.trainer.confidence()), rel=1e-6)
        assert abs(again.trainer.confidence() - confidence) < 0.5
    finally:
        again.stop()


def test_autoscale_probe_reads_the_predictor(tmp_path, cpu_default):
    from gie_tpu_torch.datastore.objects import EndpointPool, Pod

    runner = _runner(tmp_path, 0.0, autoscale_mode="recommend",
                     autoscale_ttft_slo_ms=800.0)
    try:
        assert runner.autoscaler.ttft_probe == runner._autoscale_ttft_probe
        assert runner._autoscale_ttft_probe() is None    # untrained
        runner.datastore.pool_set(EndpointPool({"app": "x"}, [8000],
                                               "default"))
        for i in range(3):
            runner.datastore.pod_update_or_add(
                Pod(name=f"p{i}", labels={"app": "x"}, ip=f"10.9.2.{i + 1}"))
        runner.trainer.last_loss = 0.1
        pred, slo = runner._autoscale_ttft_probe()
        assert slo == 0.8 and np.isfinite(pred) and pred > 0.0
    finally:
        runner.stop()
    runner = _runner(tmp_path, 0.0, autoscale_mode="recommend")
    try:
        assert runner.autoscaler.ttft_probe is None      # no SLO given
    finally:
        runner.stop()


def test_replication_manager_carries_the_predictor_section():
    """tests/test_replication.py's trainer roundtrip through two port
    managers: the follower's params bit-equal, the same confidence, and
    its scheduler's column handed the replicated params and gate."""
    from gie_tpu_torch.replication import ReplicationManager

    ref_params, params = _carried()
    leader_t = TL.OnlineTrainer(TL.LatencyPredictor(), seed=1, device="cpu")
    leader_t._loss_ema, leader_t._observed_total = 0.03, 600
    follower_t = TL.OnlineTrainer(TL.LatencyPredictor(), seed=2,
                                  device="cpu")
    tp = TL.LatencyPredictor()
    sched = Scheduler(ProfileConfig(), Scheduler(device="cpu").weights.replace(
        latency=1.0), device="cpu", predictor_fn=TL.predictor_score_fn(tp),
        predictor_params=follower_t.params)
    leader = ReplicationManager(scheduler=Scheduler(device="cpu"),
                                trainer=leader_t)
    follower = ReplicationManager(scheduler=sched, trainer=follower_t)
    try:
        sections = {"sched": leader.scheduler.export_state(),
                    "predictor": leader_t.export_state()}
        assert follower._install(sections, delta=False)
        _same_digest(follower_t.export_state(), leader_t.export_state())
        assert follower_t.confidence() == leader_t.confidence()
        for k, v in sched.predictor_params.items():
            assert torch.equal(v, leader_t.params[k]), k
        assert sched.weights.latency == pytest.approx(
            leader_t.confidence(), rel=1e-6)
        assert "predictor" in leader.publisher.exporters
    finally:
        leader.stop()
        follower.stop()


def test_readers_never_see_a_half_stepped_tree():
    """train() on one thread while others export the digest, predict and
    hand the params to a Scheduler: every tree a reader sees is one the
    trainer published whole (bit-equal to one publish), never a mix of
    two steps. Time-bounded, with a short switch interval."""
    import sys
    import threading

    trainer = TL.OnlineTrainer(TL.LatencyPredictor(), batch_size=32,
                               device="cpu")
    _fill(trainer, np.random.default_rng(2), 200)
    published = [trainer.params_numpy()]
    real = trainer._publish

    def logged(snapshot):
        real(snapshot)
        published.append(trainer.params_numpy())

    trainer._publish = logged
    tp = TL.LatencyPredictor()
    sched = Scheduler(ProfileConfig(), device="cpu",
                      predictor_fn=TL.predictor_score_fn(tp),
                      predictor_params=trainer.params)
    seen, errors = [], []
    stop = threading.Event()

    def read():
        try:
            while not stop.is_set():
                seen.append(trainer.export_state())
                sched.set_predictor_params(trainer.params)
                with sched._lock:       # as the cycle reads its buffers
                    seen.append({"param" + k: v.numpy().copy() for k, v in
                                 sched.predictor_params.items()})
                trainer.predict_ttft(trainer._feats[:5], trainer._slots[:5])
        except Exception as e:   # reported by the assertion below
            errors.append(e)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    readers = [threading.Thread(target=read) for _ in range(3)]
    try:
        for t in readers:
            t.start()
        for _ in range(15):
            trainer.train(steps=2)
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=30)
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in readers) and not errors, errors
    assert len(published) == 16 and len(seen) >= 6
    digests = [convert.flatten_predictor_tree(
        convert.predictor_params_to_numpy(p), "param") for p in published]
    for got in seen:
        if "param['params']['Dense_0']['kernel']" in got:
            match = [d for d in digests
                     if all(np.array_equal(got[k], d[k]) for k in d)]
        else:                      # the scheduler's buffers, port layout
            match = [p for p in published
                     if all(np.array_equal(got["param" + k], v)
                            for k, v in p.items())]
        assert match, "a reader saw a tree that was never published"
