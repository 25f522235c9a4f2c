"""The whole ported slice against the JAX reference on the CPU: the JAX
`Scheduler` and gie_tpu_torch's `Scheduler(device="cpu")` side by side
over three carried waves of shared-prefix prompts with LoRA ids (the
bench.py mix, scaled down), with complete() feedback, in the two
configurations whose picks run the port's kernels:

  * the tuned profile with use_pallas_sinkhorn=True (the production path
    with its solve routed through the fused Sinkhorn kernel);
  * picker="topk" with use_pallas_topk=True (the fused blend + top-k).

The port's Gumbel noise is replayed from the JAX scheduler's key sequence
(PRNGKey(seed), then per pick `key, sub = split(key)`, gumbel(sub,
(n_bucket, m))), so picks compare exactly.

Tolerances: indices and status exact; the prefix table (keys, packed
presence words, ages) bit-exact; assumed_load and ot_v within atol=1e-5.
Scores within atol=1e-5 plus, on the sinkhorn path, two lane-tiebreak
fields of relative slack: the tiebreak rewrites the low ceil(log2 M)
mantissa bits, so a one-ulp difference in the solve can move a chosen
lane's log-plan score by 2**ceil(log2 M) ulps.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gie_tpu.sched import ProfileConfig as JaxProfileConfig
from gie_tpu.sched import Scheduler as JaxScheduler
from gie_tpu.sched.config import load_scheduler_config as jax_load_config
from gie_tpu.sched.config import tuned_profile as jax_tuned_profile
from gie_tpu.sched.types import chunk_bucket_for
from gie_tpu.utils.testing import make_endpoints, make_requests

from gie_tpu_torch import convert
from gie_tpu_torch.sched import ProfileConfig, Scheduler
from gie_tpu_torch.sched.config import load_scheduler_config, tuned_profile
from gie_tpu_torch.sched.profile import gumbel_noise

N, M, M_LIVE, SEED = 48, 64, 40, 11
BASE = b"SYSTEM: You are a helpful assistant specialised in task %d. "
CONFIGS = ["tuned-sinkhorn-kernel", "topk-kernel"]


@pytest.fixture(autouse=True)
def _deterministic_torch():
    """Parity runs with torch's deterministic algorithms on."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _configs(name):
    if name == "tuned-sinkhorn-kernel":
        jc, jw = jax_tuned_profile()
        tc, tw = tuned_profile()
        return (dataclasses.replace(jc, use_pallas_sinkhorn=True), jw,
                dataclasses.replace(tc, use_pallas_sinkhorn=True), tw)
    return (JaxProfileConfig(picker="topk", use_pallas_topk=True), None,
            ProfileConfig(picker="topk", use_pallas_topk=True), None)


def jax_noise_replay(seed):
    """noise_source replaying the JAX Scheduler's per-pick Gumbel draws."""
    key = jax.random.PRNGKey(seed)

    def source(shape):
        nonlocal key
        key, sub = jax.random.split(key)
        return np.asarray(jax.random.gumbel(sub, shape, jnp.float32))

    return source


def _endpoints():
    rng = np.random.default_rng(SEED)
    return make_endpoints(
        M_LIVE, queue=rng.integers(0, 50, M_LIVE).tolist(),
        kv=rng.uniform(0, 0.95, M_LIVE).tolist(), max_lora=8,
        lora_active=[rng.integers(-1, 12, 3).tolist() for _ in range(M_LIVE)],
        m_slots=M)


def _wave(w):
    """Wave w of the bench mix: 16 shared system prompts (many requests
    share chunk 0 — same-wave prefix collisions), LoRA ids -1..11, the
    chunk axis cut to the wave's bucket as the batching layer does."""
    rng = np.random.default_rng(100 + w)
    prompts = [(BASE % ((i + w) % 16)) * 6 + b"user question %d" % (i + N * w)
               for i in range(N)]
    reqs = make_requests(N, prompts=prompts,
                         lora_id=rng.integers(-1, 12, N).tolist(),
                         criticality=rng.integers(0, 3, N).tolist(),
                         m_slots=M)
    cb = chunk_bucket_for(int(np.asarray(reqs.n_chunks).max()))
    return reqs.replace(chunk_hashes=reqs.chunk_hashes[:, :cb])


def _assert_results(ref, port, sinkhorn_path):
    np.testing.assert_array_equal(port.indices, np.asarray(ref.indices))
    np.testing.assert_array_equal(port.status, np.asarray(ref.status))
    rtol = 2 * 2 ** math.ceil(math.log2(M)) * 2.0**-23 if sinkhorn_path else 0
    np.testing.assert_allclose(port.scores, np.asarray(ref.scores),
                               atol=1e-5, rtol=rtol)
    np.testing.assert_allclose(port.affinity, np.asarray(ref.affinity),
                               atol=1e-5)


def _assert_states(ref: dict, port: dict):
    assert set(ref) == set(port)
    for k in ("prefix_keys", "prefix_present", "prefix_ages", "rr", "tick"):
        assert port[k].dtype == np.uint32, k
        np.testing.assert_array_equal(port[k], np.asarray(ref[k]), err_msg=k)
    for k in ("assumed_load", "ot_v"):
        assert port[k].dtype == np.float32, k
        np.testing.assert_allclose(port[k], np.asarray(ref[k]), atol=1e-5,
                                   err_msg=k)


def _run_waves(name, waves=3):
    jc, jw, tc, tw = _configs(name)
    jsched = JaxScheduler(jc, jw, seed=SEED)
    tsched = Scheduler(tc, tw, seed=SEED, device="cpu",
                       noise_source=jax_noise_replay(SEED))
    eps = _endpoints()
    teps = convert.endpoints_from_numpy(eps, device="cpu")
    picks = 0
    for w in range(waves):
        reqs = _wave(w)
        ref = jsched.pick(reqs, eps)
        port = tsched.pick(convert.requests_from_numpy(reqs, device="cpu"),
                           teps)
        _assert_results(ref, port, name.startswith("tuned"))
        picks += int((port.indices[:, 0] >= 0).sum())
        # Completion feedback for half the wave, then the carried state.
        done = port.indices[: N // 2, 0]
        costs = np.full(done.shape, 0.25, np.float32)
        jsched.complete(done, costs)
        tsched.complete(done, costs)
        _assert_states(jsched.export_state(), tsched.export_state())
    assert picks > N * waves // 2  # the waves really scheduled
    return jsched, tsched, eps, teps


@pytest.mark.parametrize("name", CONFIGS)
def test_slice_matches_reference_over_carried_waves(name):
    _run_waves(name)


@pytest.mark.parametrize("name", CONFIGS)
def test_cross_install_both_directions(name):
    """A JAX leader's digest installs on the port and the port's
    export_state installs on a JAX Scheduler: after either install both
    sides schedule the next wave identically."""
    jsched, tsched, eps, teps = _run_waves(name, waves=2)
    jc, jw, tc, tw = _configs(name)
    # JAX -> port: a fresh port follower installs the leader's digest.
    follower = Scheduler(tc, tw, device="cpu",
                         noise_source=jax_noise_replay(SEED + 1))
    prepared = follower.prepare_install(jsched.export_state())
    assert prepared is not None
    follower.commit_install(prepared)
    _assert_states(jsched.export_state(), follower.export_state())
    # port -> JAX: a fresh JAX follower installs the port's digest.
    jfollower = JaxScheduler(jc, jw, seed=SEED + 1)
    assert jfollower.install_state(tsched.export_state())
    _assert_states(tsched.export_state(), jfollower.export_state())

    reqs = _wave(5)
    ref = jfollower.pick(reqs, eps)
    port = follower.pick(convert.requests_from_numpy(reqs, device="cpu"),
                         teps)
    _assert_results(ref, port, name.startswith("tuned"))
    _assert_states(jfollower.export_state(), follower.export_state())
    # Malformed digests are refused and leave the state as it was.
    bad = dict(tsched.export_state())
    bad["ot_v"] = bad["ot_v"][:-1]
    assert follower.prepare_install(bad) is None
    assert not follower.install_state({"assumed_load": np.zeros(64)})


def test_evict_and_clear_prefix_match_reference():
    jsched, tsched, _, _ = _run_waves("tuned-sinkhorn-kernel", waves=1)
    for slot in (0, 3, 500):
        jsched.evict_endpoint(slot)
        tsched.evict_endpoint(slot)
    jsched.clear_prefix_endpoint(7)
    tsched.clear_prefix_endpoint(7)
    _assert_states(jsched.export_state(), tsched.export_state())
    np.testing.assert_allclose(tsched.snapshot_assumed_load(),
                               jsched.snapshot_assumed_load(), atol=1e-5)
    report = tsched.debug_report()
    assert report["picker"] == "sinkhorn" and report["m_bucket"] == M
    assert report["tick"] == 1 and report["device"] == "cpu"


def test_queued_completions_apply_as_the_calls_one_by_one():
    """On CUDA complete() queues its arrays and the next locked section
    applies the queue (Scheduler._apply_queued). Driven here on the
    CPU: the same calls, queued, then applied, leave the assumed load
    bit-equal to the calls applied one by one, and equal to the
    reference's complete() within its state tolerance."""
    jsched, tsched, _, _ = _run_waves("tuned-sinkhorn-kernel", waves=1)
    queued = Scheduler(*tuned_profile(), seed=SEED, device="cpu")
    assert queued.install_state(tsched.export_state())
    rng = np.random.default_rng(5)
    for _ in range(40):
        k = int(rng.integers(1, 4))
        slots = rng.integers(-2, M + 3, k)       # a few beyond the bucket
        costs = rng.uniform(0, 0.5, k).astype(np.float32)
        jsched.complete(slots, costs)
        tsched.complete(slots, costs)
        queued._enqueue(("complete", slots.astype(np.int64), costs))
    np.testing.assert_array_equal(queued.snapshot_assumed_load(),
                                  tsched.snapshot_assumed_load())
    assert queued._queued == []
    _assert_states(jsched.export_state(), queued.export_state())


def test_pick_async_snapshot_and_padding():
    sched = Scheduler(*tuned_profile(), seed=3, device="cpu")
    teps = convert.endpoints_from_numpy(_endpoints(), device="cpu")
    reqs = convert.requests_from_numpy(_wave(0), device="cpu")
    wave = sched.pick_async(reqs, teps, snapshot_load=True)
    res = wave.materialize()
    assert res.indices.shape == (N, 4) and res.status.shape == (N,)
    load = wave.materialize_load()
    np.testing.assert_array_equal(load, sched.snapshot_assumed_load())
    assert load.sum() > 0
    ok = res.status == 0
    assert (res.indices[ok, 0] >= 0).all() and (res.indices[ok, 0] < M_LIVE).all()


def test_default_generator_is_seeded_and_gumbel_shaped():
    a = Scheduler(*tuned_profile(), seed=5, device="cpu")
    b = Scheduler(*tuned_profile(), seed=5, device="cpu")
    teps = convert.endpoints_from_numpy(_endpoints(), device="cpu")
    reqs = convert.requests_from_numpy(_wave(1), device="cpu")
    np.testing.assert_array_equal(a.pick(reqs, teps).indices,
                                  b.pick(reqs, teps).indices)
    gen = torch.Generator().manual_seed(0)
    g = gumbel_noise((256, 256), gen, "cpu")
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.02   # Euler-Mascheroni
    assert abs(float(g.var()) - math.pi**2 / 6) < 0.05


def test_yaml_config_matches_reference():
    text = """
picker: sinkhorn
queue_limit: 96
plugins: {prefix: true, lora: false}
weights: {queue: 2.5, prefix: 4.0, session: 8.0}
"""
    jcfg, jw = jax_load_config(text)
    cfg, w = load_scheduler_config(text)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert w == convert.weights_from_numpy(jw)
    assert type(jw)(**convert.weights_to_numpy(w)) == jw
    with pytest.raises(ValueError, match="unknown scheduler config key"):
        load_scheduler_config("bogus: 1")


def test_queued_releases_on_a_hot_slot_apply_as_the_calls_one_by_one():
    """A queue whose calls mostly release one slot (hundreds of layers,
    as a burst's completions pile up behind a capture): applied in its
    layers, the load is bit-equal to the calls applied one by one."""
    _, tsched, _, _ = _run_waves("tuned-sinkhorn-kernel", waves=1)
    queued = Scheduler(*tuned_profile(), seed=SEED, device="cpu")
    assert queued.install_state(tsched.export_state())
    rng = np.random.default_rng(6)
    calls = []
    for _ in range(600):
        slots = np.where(rng.uniform(size=2) < 0.8, 3,
                         rng.integers(-1, M + 2, 2)).astype(np.int64)
        calls.append(("complete", slots,
                      rng.uniform(0, 0.05, 2).astype(np.float32)))
    for call in calls:
        tsched.complete(call[1], call[2])
        queued._enqueue(call)
    np.testing.assert_array_equal(queued.snapshot_assumed_load(),
                                  tsched.snapshot_assumed_load())
    assert queued._queued == []
