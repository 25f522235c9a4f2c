"""The disaggregated prefill/decode dual pick against the JAX reference on
the CPU: the port's `_pd_cycle` through `Scheduler(device="cpu")` beside
the reference's over carried waves of mixed roles, in the two
configurations whose picks run the port's kernels (tuned +
use_pallas_sinkhorn, whose wave solves twice through the Sinkhorn kernel's
plain version; topk + use_pallas_topk, whose prefill pick takes the
blend-top-k kernel's), the reference's own pd cases, and the pick
service's pd bookkeeping (the prefill header, both releases, the
budget-aware single hop).

Noise: the reference splits each wave's key into (key_p, key_d) and draws
a Gumbel plane from each; the port's pd wave draws one [2, N, M] tensor,
plane 0 for the prefill solve and plane 1 for the decode solve, replayed
here from the reference's key sequence.

Tolerances: prefill, indices and status exact; the prefix table (keys,
presence words, ages), rr and tick exact; the assumed load and duals
within atol=1e-5, the state tolerance of tests/test_torch_slice.py (the
first wave's load is exact; from the second on XLA rounds
load * decay + charge once, the port twice); scores within atol=1e-5 plus,
on the sinkhorn path, that file's lane-tiebreak slack (2 * 2**ceil(log2 M)
ulps relative).
"""

import dataclasses
import math
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gie_tpu.sched import ProfileConfig as JaxProfileConfig
from gie_tpu.sched import Scheduler as JaxScheduler
from gie_tpu.sched import Weights as JaxWeights
from gie_tpu.sched.config import tuned_profile as jax_tuned_profile
from gie_tpu.sched.types import chunk_bucket_for
from gie_tpu.utils.testing import make_endpoints, make_requests

from gie_tpu_torch import convert
from gie_tpu_torch.sched import ProfileConfig, Scheduler, Weights
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.config import tuned_profile
from gie_tpu_torch.sched.profile import pd_costs_host

R = C.Role
N, M, M_LIVE, SEED = 64, 64, 48, 21
BASE = b"SYSTEM: You are a helpful assistant specialised in task %d. "
CONFIGS = ["tuned-sinkhorn-kernel", "topk-kernel"]


@pytest.fixture(autouse=True)
def _deterministic_torch():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def jax_pd_noise_replay(seed):
    """noise_source replaying the JAX Scheduler's per-pick Gumbel draws,
    [n, m] for a classic wave and [2, n, m] for a pd wave: the wave's key
    split into (key_p, key_d), a plane from each."""
    key = jax.random.PRNGKey(seed)

    def source(shape):
        nonlocal key
        key, sub = jax.random.split(key)
        if len(shape) == 2:
            return np.asarray(jax.random.gumbel(sub, shape, jnp.float32))
        key_p, key_d = jax.random.split(sub)
        return np.stack([
            np.asarray(jax.random.gumbel(k, shape[1:], jnp.float32))
            for k in (key_p, key_d)])

    return source


def _configs(name, **pd):
    if name == "tuned-sinkhorn-kernel":
        jc, jw = jax_tuned_profile()
        tc, tw = tuned_profile()
        return (dataclasses.replace(jc, use_pallas_sinkhorn=True,
                                    pd_disaggregation=True, **pd), jw,
                dataclasses.replace(tc, use_pallas_sinkhorn=True,
                                    pd_disaggregation=True, **pd), tw)
    kw = dict(picker="topk", use_pallas_topk=True, pd_disaggregation=True,
              **pd)
    return JaxProfileConfig(**kw), None, ProfileConfig(**kw), None


def _endpoints():
    """M_LIVE endpoints of mixed roles: 3/8 prefill, 3/8 decode, 1/4
    both, from the seed."""
    rng = np.random.default_rng(SEED)
    roles = rng.choice([int(R.PREFILL)] * 3 + [int(R.DECODE)] * 3
                       + [int(R.BOTH)] * 2, M_LIVE).tolist()
    return make_endpoints(
        M_LIVE, queue=rng.integers(0, 50, M_LIVE).tolist(),
        kv=rng.uniform(0, 0.95, M_LIVE).tolist(), max_lora=8,
        lora_active=[rng.integers(-1, 12, 3).tolist() for _ in range(M_LIVE)],
        role=roles, m_slots=M)


def _wave(w):
    rng = np.random.default_rng(200 + w)
    prompts = [(BASE % ((i + w) % 8)) * 6 + b"user question %d" % (i + N * w)
               for i in range(N)]
    reqs = make_requests(N, prompts=prompts,
                         lora_id=rng.integers(-1, 12, N).tolist(),
                         criticality=rng.integers(0, 3, N).tolist(),
                         m_slots=M)
    cb = chunk_bucket_for(int(np.asarray(reqs.n_chunks).max()))
    return reqs.replace(
        chunk_hashes=reqs.chunk_hashes[:, :cb],
        decode_len=jnp.asarray(rng.uniform(0, 4096, N), jnp.float32))


def _assert_results(ref, port, sinkhorn_path):
    for k in ("prefill", "indices", "status"):
        np.testing.assert_array_equal(getattr(port, k),
                                      np.asarray(getattr(ref, k)), err_msg=k)
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
        np.testing.assert_allclose(port[k], np.asarray(ref[k]), atol=1e-5,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("name", CONFIGS)
def test_pd_cycle_equals_reference_over_carried_waves(name):
    jc, jw, tc, tw = _configs(name)
    jsched = JaxScheduler(jc, weights=jw, seed=SEED)
    tsched = Scheduler(tc, tw, device="cpu",
                       noise_source=jax_pd_noise_replay(SEED))
    eps = _endpoints()
    teps = convert.endpoints_from_numpy(eps, device="cpu")
    roles = np.asarray(eps.role)
    for w in range(3):
        reqs = _wave(w)
        ref = jsched.pick(reqs, eps)
        port = tsched.pick(convert.requests_from_numpy(reqs, device="cpu"),
                           teps)
        _assert_results(ref, port, name.startswith("tuned"))
        ok = port.status == C.Status.OK
        assert ok.sum() > N // 2
        assert (roles[port.prefill[ok]] != R.DECODE).all()
        assert (roles[port.indices[ok, 0]] != R.PREFILL).all()
        assert (port.prefill[~ok] == -1).all()
        _assert_states(jsched.export_state(), tsched.export_state())
        # Served feedback releases both sides' charges.
        half = np.flatnonzero(ok)[: N // 4]
        costs = [pd_costs_host(float(p), float(d)) for p, d in zip(
            np.asarray(reqs.prompt_len)[half],
            np.asarray(reqs.decode_len)[half])]
        slots = np.concatenate([port.prefill[half], port.indices[half, 0]])
        amounts = np.asarray([c[0] for c in costs] + [c[1] for c in costs],
                             np.float32)
        jsched.complete(slots, amounts)
        tsched.complete(slots, amounts)
    _assert_states(jsched.export_state(), tsched.export_state())
    assert tsched.debug_report()["pd_disaggregation"]


def test_pd_noise_is_one_two_plane_draw_per_wave():
    drawn = []

    def source(shape):
        drawn.append(shape)
        return np.zeros(shape, np.float32)

    cfg = ProfileConfig(picker="sinkhorn", pd_disaggregation=True)
    s = Scheduler(cfg, device="cpu", noise_source=source)
    eps = convert.endpoints_from_numpy(
        make_endpoints(4, role=[R.PREFILL, R.PREFILL, R.DECODE, R.DECODE]),
        device="cpu")
    s.pick(convert.requests_from_numpy(make_requests(3), device="cpu"), eps)
    assert drawn == [(2, 8, C.M_MAX)]
    s = Scheduler(dataclasses.replace(cfg, picker="topk"), device="cpu",
                  noise_source=source)
    s.pick(convert.requests_from_numpy(make_requests(3), device="cpu"), eps)
    assert drawn == [(2, 8, C.M_MAX)]          # top-k draws nothing


def test_locality_only_weights_equal_reference():
    """The de-blend's degeneracy guard: with every decode-kept weight 0
    the decode side has no signal and the co-location bonus decides; the
    port's picks equal the reference's."""
    kw = dict(queue=0.0, kv_cache=0.0, prefix=7.7, lora=0.0,
              assumed_load=0.0, latency=0.0, session=2.2)
    jsched = JaxScheduler(JaxProfileConfig(pd_disaggregation=True),
                          weights=JaxWeights(**{
                              k: np.float32(v) for k, v in kw.items()}))
    tsched = Scheduler(ProfileConfig(pd_disaggregation=True),
                       Weights(**kw), device="cpu")
    eps = make_endpoints(8, queue=[0.0] * 8, kv=[0.1] * 8,
                         role=[R.BOTH] * 8, m_slots=64)
    teps = convert.endpoints_from_numpy(eps, device="cpu")
    prompts = [b"shared system prompt " * 10 + b"u%d" % i for i in range(16)]
    for _ in range(2):
        reqs = make_requests(16, prompts=prompts, m_slots=64)
        ref = jsched.pick(reqs, eps)
        port = tsched.pick(convert.requests_from_numpy(reqs, device="cpu"),
                           teps)
        for k in ("prefill", "indices", "status"):
            np.testing.assert_array_equal(getattr(port, k),
                                          np.asarray(getattr(ref, k)))
    ok = port.prefill >= 0
    assert ok.any()
    np.testing.assert_array_equal(port.indices[ok, 0], port.prefill[ok])
    _assert_states(jsched.export_state(), tsched.export_state())


# -- the reference's pd cases, on the port --------------------------------

def _pd_sched(weights=None, **kw):
    return Scheduler(ProfileConfig(pd_disaggregation=True, **kw), weights,
                     device="cpu")


def _pick(s, reqs, eps):
    return s.pick(convert.requests_from_numpy(reqs, device="cpu"),
                  convert.endpoints_from_numpy(eps, device="cpu"))


def test_role_masks_partition_the_dual_pick():
    eps = make_endpoints(
        5, queue=[0, 0, 0, 0, 0],
        role=[R.PREFILL, R.PREFILL, R.DECODE, R.DECODE, R.BOTH])
    reqs = make_requests(
        16, prompts=[b"SYS shared " * 20 + b"q%d" % i for i in range(16)])
    res = _pick(_pd_sched(), reqs, eps)
    assert (res.status == C.Status.OK).all()
    assert set(res.prefill) <= {0, 1, 4}
    assert set(res.indices[:, 0]) <= {2, 3, 4}


@pytest.mark.parametrize("picker", ["topk", "sinkhorn"])
def test_every_ported_picker_supports_pd(picker):
    eps = make_endpoints(4, role=[R.PREFILL, R.PREFILL, R.DECODE, R.DECODE])
    res = _pick(_pd_sched(picker=picker), make_requests(8), eps)
    assert (res.status == C.Status.OK).all()
    assert np.isin(res.prefill, [0, 1]).all()
    assert np.isin(res.indices[:, 0], [2, 3]).all()


def test_missing_role_capacity_is_503():
    s = _pd_sched()
    res = _pick(s, make_requests(4), make_endpoints(
        2, role=[R.PREFILL, R.PREFILL]))
    assert (res.status == C.Status.NO_CAPACITY).all()
    assert (res.prefill == -1).all()
    res = _pick(s, make_requests(4), make_endpoints(
        2, role=[R.DECODE, R.DECODE]))
    assert (res.status == C.Status.NO_CAPACITY).all()


@pytest.mark.parametrize("use_pallas_topk", [False, True],
                         ids=["plain", "topk-kernel"])
def test_colocation_bonus_prefers_same_endpoint(use_pallas_topk):
    """Under the top-k kernel too: the decode pick never takes the kernel,
    which recomputes the blend and would drop the bonus."""
    res = _pick(_pd_sched(pd_colocation_bonus=5.0,
                          use_pallas_topk=use_pallas_topk),
                make_requests(8), make_endpoints(4, queue=[0, 0, 0, 0]))
    assert (res.status == C.Status.OK).all()
    np.testing.assert_array_equal(res.prefill, res.indices[:, 0])


def test_split_load_charging_and_release():
    s = _pd_sched(load_decay=1.0, enable_prefix=False)
    res = _pick(s, make_requests(1, prompt_len=[4096.0]),
                make_endpoints(2, role=[R.PREFILL, R.DECODE]))
    p, d = int(res.prefill[0]), int(res.indices[0, 0])
    assert (p, d) == (0, 1)
    load = s.snapshot_assumed_load()
    p_cost, d_cost = pd_costs_host(4096.0, 0.0)
    assert load[0] == pytest.approx(p_cost)
    assert load[1] == pytest.approx(d_cost)
    s.complete(np.asarray([p, d], np.int32),
               np.asarray([p_cost, d_cost], np.float32))
    assert s.snapshot_assumed_load()[:2] == pytest.approx([0.0, 0.0])


def test_prefix_index_tracks_prefill_worker():
    eps = make_endpoints(4, role=[R.PREFILL, R.PREFILL, R.DECODE, R.DECODE])
    s = _pd_sched()
    prompt = b"SYSTEM: very long shared system prompt " * 40
    first = int(_pick(s, make_requests(1, prompts=[prompt]), eps).prefill[0])
    for _ in range(3):
        assert int(_pick(s, make_requests(1, prompts=[prompt]),
                         eps).prefill[0]) == first


def test_classic_mode_has_no_prefill():
    res = _pick(Scheduler(ProfileConfig(), device="cpu"), make_requests(8),
                make_endpoints(4, queue=[3, 1, 2, 0]))
    assert res.prefill is None


def test_rejected_pd_requests_do_not_pollute_prefix_index():
    s = _pd_sched()
    prompt = b"UNIQUE SYSTEM PREAMBLE " * 40
    res = _pick(s, make_requests(1, prompts=[prompt]),
                make_endpoints(2, role=[R.PREFILL, R.PREFILL]))
    assert int(res.status[0]) == C.Status.NO_CAPACITY
    full = make_endpoints(4, role=[R.PREFILL, R.PREFILL, R.DECODE, R.DECODE])
    cols = s.explain(
        convert.requests_from_numpy(make_requests(1, prompts=[prompt]),
                                    device="cpu"),
        convert.endpoints_from_numpy(full, device="cpu"))
    assert float(cols["prefix"].max()) == 0.0


def test_small_but_legit_decode_weight_is_honored():
    weights = Weights(queue=0.008, kv_cache=0.0, prefix=7.7, lora=0.0,
                      assumed_load=0.0, latency=0.0, session=2.2)
    s = _pd_sched(weights, pd_colocation_bonus=0.0)
    eps = make_endpoints(
        4, queue=[0.0, 0.0, 0.0, 60.0], kv=[0.1] * 4,
        role=[R.PREFILL, R.PREFILL, R.DECODE, R.DECODE], m_slots=64)
    prompts = [b"shared system prompt " * 10 + b"u%d" % i for i in range(8)]
    decode = _pick(s, make_requests(8, prompts=prompts, m_slots=64),
                   eps).indices[:, 0]
    ok = decode >= 0
    assert ok.any() and (decode[ok] == 2).all()


# -- the pick service -----------------------------------------------------

def _pd_picker(**picker_kw):
    from gie_tpu_torch.api.types import ROLE_LABEL
    from gie_tpu_torch.datastore import Datastore
    from gie_tpu_torch.datastore.objects import EndpointPool, Pod
    from gie_tpu_torch.metricsio import MetricsStore
    from gie_tpu_torch.sched.batching import BatchingTPUPicker

    ds = Datastore()
    ds.pool_set(EndpointPool({"app": "x"}, [8000], "default"))
    ds.pod_update_or_add(Pod(name="pf0", labels={
        "app": "x", ROLE_LABEL: "prefill"}, ip="10.0.0.1"))
    ds.pod_update_or_add(Pod(name="dc0", labels={
        "app": "x", ROLE_LABEL: "decode"}, ip="10.0.0.2"))
    sched = _pd_sched(load_decay=1.0, enable_prefix=False)
    picker = BatchingTPUPicker(sched, ds, MetricsStore(), max_wait_s=0.001,
                               **picker_kw)
    return sched, ds, picker


class _Ctx:
    def __init__(self, res):
        self.pick_result = res


def test_batching_emits_prefill_header_and_releases_both():
    from gie_tpu_torch.extproc import metadata as mdkeys
    from gie_tpu_torch.extproc.pick import PickRequest

    sched, ds, picker = _pd_picker()
    try:
        res = picker.pick(PickRequest(headers={}, body=b"hello world"),
                          ds.endpoints())
        assert res.endpoint.startswith("10.0.0.2:")      # decode destination
        assert res.extra_headers[mdkeys.PREFILL_ENDPOINT_KEY].startswith(
            "10.0.0.1:")
        assert res.charged is not None and len(res.charged) == 2
        assert sched.snapshot_assumed_load().sum() > 0
        picker.observe_served(res.endpoint, _Ctx(res))
        assert sched.snapshot_assumed_load().sum() == pytest.approx(0.0)
    finally:
        picker.close()


def test_budget_single_hop_releases_prefill_and_counts():
    """A request whose remaining deadline is below pd_budget_floor_s goes
    to the decode worker alone: no prefill header, the prefill charge
    released at once, gie_pd_budget_singlehop_total counted, and served
    feedback releases the decode charge."""
    from gie_tpu_torch.extproc import metadata as mdkeys
    from gie_tpu_torch.extproc.pick import PickRequest
    from gie_tpu_torch.runtime import metrics as own_metrics

    sched, ds, picker = _pd_picker(pd_budget_floor_s=5.0)
    before = own_metrics.PD_BUDGET_SINGLEHOP.value()
    try:
        far = picker.pick(PickRequest(headers={}, body=b"x" * 4096,
                                      deadline_at=time.monotonic() + 60.0),
                          ds.endpoints())
        assert mdkeys.PREFILL_ENDPOINT_KEY in far.extra_headers
        assert own_metrics.PD_BUDGET_SINGLEHOP.value() == before
        picker.observe_served(far.endpoint, _Ctx(far))
        near = picker.pick(PickRequest(headers={}, body=b"x" * 4096,
                                       deadline_at=time.monotonic() + 2.0),
                           ds.endpoints())
        assert near.endpoint.startswith("10.0.0.2:")
        assert mdkeys.PREFILL_ENDPOINT_KEY not in near.extra_headers
        assert own_metrics.PD_BUDGET_SINGLEHOP.value() == before + 1
        assert [c[2] for c in near.charged] == [near.endpoint]
        load = sched.snapshot_assumed_load()
        _, d_cost = pd_costs_host(4096.0, 0.0)
        assert load[0] == pytest.approx(0.0)       # prefill released
        assert load[1] == pytest.approx(d_cost)
        picker.observe_served(near.endpoint, _Ctx(near))
        assert sched.snapshot_assumed_load().sum() == pytest.approx(0.0)
    finally:
        picker.close()


def test_release_skips_a_reused_slot():
    """A charged worker whose slot now belongs to another hostport is not
    released (its eviction already cleared the slot)."""
    from gie_tpu_torch.extproc.pick import PickResult

    sched, ds, picker = _pd_picker()
    try:
        sched.complete(np.asarray([0, 1]), np.asarray([0.0, 0.0]))
        sched._use_bucket(64).assumed_load[:2] = torch.tensor([1.0, 1.0])
        hp = {ep.slot: ep.hostport for ep in ds.endpoints()}
        res = PickResult(endpoint=hp[1], charged=[
            (1, 0.5, hp[1]), (0, 0.5, "10.9.9.9:8000")])
        picker.observe_served(res.endpoint, _Ctx(res))
        np.testing.assert_allclose(sched.snapshot_assumed_load()[:2],
                                   [1.0, 0.5])
    finally:
        picker.close()
