"""The multi-device slice on the CPU: gie_tpu_torch/parallel against the
port's own single-device cycle and against the reference's sharded cycle.

Sharding is a layout choice, never a semantics change. The port's mesh is
a (dp, tp) grid of positions, here 8 virtual positions of the CPU
(make_mesh(n, device="cpu"), the counterpart of the reference's forced
8-device CPU platform), each holding its own shards.

  matrix    mesh {1, 2, 4, 8} x picker {topk, sinkhorn, random} on a
            contended 37-endpoint pool in a 64-wide bucket (ragged shard
            lane mixes), two waves through carried state: picks,
            statuses, ot_v, prefix keys, words and ages bit-exact against
            the port's unmeshed cycle, assumed_load within atol 1e-6;
  reference at mesh 8, per picker and for pd: the same inputs and noise
            through gie_tpu.parallel.sharded_cycle (JAX, 8 CPU devices):
            picks, statuses, prefix keys and words exact, ot_v and
            assumed_load within the port-vs-reference atol 1e-5 (the
            port's unmeshed cycle is held to the same bound);
  layouts   tp {1, 2, 4, 8}, the warm-start duals over three waves, the
            presence matrix's shard shapes (words at tp <= 2, table slots
            beyond, never the whole table per position), pd, the latency
            column (picks exact, the column within the predictor tests'
            rtol 2e-3);
  facade    Scheduler(mesh=make_mesh(8, device="cpu")) against the unmeshed
            facade over three waves (_min_bucket 4, a 3-request pad), and
            complete / evict_endpoint / clear_prefix_endpoint /
            apply_prefix_events / export / install / .npz round trip;
  guards    dp = 3, an over-requested mesh, --mesh-devices 6, a Sinkhorn
            solve whose groups the mesh does not divide;
  training  sharded_train_step over 8 positions against the single step.

The cycle runs under torch.use_deterministic_algorithms(True).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gie_tpu_torch import convert
from gie_tpu_torch.parallel import mesh as pm
from gie_tpu_torch.parallel import make_mesh
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.config import tuned_profile
from gie_tpu_torch.sched.profile import (
    ProfileConfig,
    Scheduler,
    build_stages,
    scheduling_cycle,
)
from gie_tpu_torch.sched.types import SchedState, Weights
from gie_tpu_torch.utils.testing import make_endpoints, make_requests

CPU = torch.device("cpu")
PICKERS = ("topk", "sinkhorn", "random")


@pytest.fixture(autouse=True)
def _deterministic_torch():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _loaded_pool(m_valid: int, m_slots: int, seed: int):
    """A contended pool (queues near the limit, mixed KV) so the Sinkhorn
    caps bind and the warm-start gate engages."""
    rng = np.random.default_rng(seed)
    return make_endpoints(
        m_valid, queue=rng.integers(40, 120, m_valid).tolist(),
        kv=rng.uniform(0.1, 0.9, m_valid).tolist(), m_slots=m_slots)


def _requests(n: int, wave: int, tag: bytes = b"MAT", m: int = 64):
    prompts = [b"%s %d " % (tag, i % 4) * 30 + b"w%d q%d" % (wave, i)
               for i in range(n)]
    return make_requests(n, prompts=prompts, m_slots=m)


def _noise(shape, seed):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(shape, generator=g).clamp_(min=torch.finfo(torch.float32)
                                              .tiny)
    return -torch.log(-torch.log(u))


def _both(cfg, mesh, state, sharded, reqs, eps, gumbel, weights=None,
          **kw):
    """One wave through the unmeshed cycle over `state` and the meshed one
    over `sharded`, both in place -> (single result, meshed result)."""
    weights = weights or Weights.default()
    r1, _ = scheduling_cycle(state, reqs, eps, weights, gumbel, cfg=cfg,
                             **kw)
    rows, _ = scheduling_cycle(
        sharded, pm.shard_requests(mesh, reqs), pm.shard_endpoints(mesh, eps),
        weights, pm.shard_noise(mesh, gumbel), cfg=cfg, mesh=mesh, **kw)
    return r1, pm.unshard_result(rows)


def _assert_equal(r1, r2, s1: SchedState, s2):
    for f in ("indices", "status", "prefill", "affinity"):
        a, b = getattr(r1, f), getattr(r2, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
    g = s2.gather()
    for name, a, b in (("ot_v", s1.ot_v, g.ot_v),
                       ("keys", s1.prefix.keys, g.prefix.keys),
                       ("present", s1.prefix.present, g.prefix.present),
                       ("ages", s1.prefix.ages, g.prefix.ages),
                       ("rr", s1.rr, g.rr), ("tick", s1.tick, g.tick)):
        assert torch.equal(a, b), name
    torch.testing.assert_close(s1.assumed_load, g.assumed_load, atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("n_mesh", [1, 2, 4, 8])
@pytest.mark.parametrize("picker", PICKERS)
def test_mesh_size_equivalence_matrix(n_mesh, picker):
    cfg = ProfileConfig(picker=picker)
    eps = _loaded_pool(37, 64, seed=21)
    mesh = make_mesh(n_mesh, device="cpu")
    state = SchedState.init(m=64, device=CPU)
    sharded = pm.shard_state(mesh, state)
    for wave in range(2):
        reqs = _requests(64, wave)
        gumbel = None if picker == "topk" else _noise((64, 64), 100 + wave)
        r1, r2 = _both(cfg, mesh, state, sharded, reqs, eps, gumbel)
        _assert_equal(r1, r2, state, sharded)
    # Not vacuous: picks landed, and the Sinkhorn duals moved.
    assert (r1.indices[:, 0] >= 0).any()
    if picker == "sinkhorn":
        assert not torch.allclose(state.ot_v, torch.ones_like(state.ot_v))


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_mesh_axis_extremes_equivalence(tp):
    cfg = ProfileConfig(picker="sinkhorn")
    eps = _loaded_pool(37, 64, seed=22)
    mesh = make_mesh(8, tp=tp, device="cpu")
    assert mesh.shape == {"dp": 8 // tp, "tp": tp}
    reqs = make_requests(32, prompts=[b"EX %d " % (i % 3) * 25 + b"q%d" % i
                                      for i in range(32)], m_slots=64)
    state = SchedState.init(m=64, device=CPU)
    sharded = pm.shard_state(mesh, state)
    r1, r2 = _both(cfg, mesh, state, sharded, reqs, eps, _noise((32, 64), 5))
    _assert_equal(r1, r2, state, sharded)


def test_warm_start_duals_sharded_parity():
    """The duals flow through the meshed cycle tp-sharded and come back
    bit-identical to the single-device iterates, wave after wave."""
    mesh = make_mesh(8, device="cpu")
    layout = pm.state_shardings(mesh)
    assert layout.ot_v == ("tp",) and layout.assumed_load == ("tp",)
    cfg = ProfileConfig(picker="sinkhorn")
    eps = _loaded_pool(48, 64, seed=23)
    state = SchedState.init(m=64, device=CPU)
    sharded = pm.shard_state(mesh, state)
    iterates = []
    for wave in range(3):
        reqs = make_requests(
            64, prompts=[b"WS %d " % (i % 5) * 20 + b"w%d r%d" % (wave, i)
                         for i in range(64)], m_slots=64)
        r1, r2 = _both(cfg, mesh, state, sharded, reqs, eps,
                       _noise((64, 64), wave))
        _assert_equal(r1, r2, state, sharded)
        assert [tuple(s.ot_v.shape) for s in sharded.shards] == [(32,), (32,)]
        iterates.append(state.ot_v.clone())
    assert not torch.equal(iterates[0], iterates[1])


def test_prefix_presence_tp_sharded_never_replicated():
    """The packed presence matrix splits at every power-of-two tp: on its
    words while the smallest bucket's word count divides tp, on its table
    slots beyond; no position holds the whole table."""
    words = C.M_BUCKETS[0] // 32
    for tp in (1, 2, 4, 8):
        mesh = make_mesh(8, tp=tp, device="cpu")
        spec = pm.state_shardings(mesh).prefix.present
        st = pm.ShardedState.init(mesh, 256)
        shapes = {tuple(s.prefix.present.shape) for s in st.shards}
        assert len(st.shards) == tp and len(shapes) == 1
        (shape,) = shapes
        if words % tp == 0:
            assert spec == (None, "tp") and st.words_axis
            assert shape == (C.PREFIX_SLOTS, 256 // 32 // tp)
        else:
            assert spec == ("tp", None) and not st.words_axis
            assert shape == (C.PREFIX_SLOTS // tp, 256 // 32)
        if tp > 1:
            assert shape[0] * shape[1] < C.PREFIX_SLOTS * 256 // 32
        assert {tuple(s.assumed_load.shape) for s in st.shards} == {
            (256 // tp,)}
        # Separate tensors, even where positions share the CPU.
        ptrs = {s.prefix.present.data_ptr() for s in st.shards}
        assert len(ptrs) == tp


def _pd_endpoints():
    roles = [C.Role.PREFILL, C.Role.PREFILL, C.Role.DECODE, C.Role.DECODE,
             C.Role.BOTH, C.Role.BOTH, C.Role.PREFILL, C.Role.DECODE]
    rng = np.random.default_rng(11)
    return roles, rng.integers(0, 30, 8).tolist(), rng.uniform(
        0, 0.9, 8).tolist()


@pytest.mark.parametrize("picker", PICKERS)
def test_pd_cycle_sharded_equivalence(picker):
    """The dual prefill/decode pick survives the mesh bit for bit: both
    picks, the status merge, the split load charge."""
    cfg = ProfileConfig(picker=picker, pd_disaggregation=True)
    roles, queue, kv = _pd_endpoints()
    eps = make_endpoints(8, queue=queue, kv=kv, role=[int(r) for r in roles],
                         m_slots=64)
    mesh = make_mesh(8, device="cpu")
    state = SchedState.init(m=64, device=CPU)
    sharded = pm.shard_state(mesh, state)
    for wave in range(2):
        reqs = _requests(32, wave, tag=b"PD")
        reqs = reqs.replace(decode_len=torch.full((32,), 300.0 * (wave + 1)))
        gumbel = None if picker == "topk" else _noise((2, 32, 64), wave)
        r1, r2 = _both(cfg, mesh, state, sharded, reqs, eps, gumbel)
        _assert_equal(r1, r2, state, sharded)
    assert (r1.prefill >= 0).any()


def test_fused_topk_under_mesh_matches():
    """picker="topk" + use_pallas_topk under a mesh: the kernel's plain
    version here (the wrapper launches the kernel on a card tensor), once
    per dp shard over its rows with the tp columns gathered."""
    cfg = ProfileConfig(picker="topk", use_pallas_topk=True)
    eps = _loaded_pool(37, 64, seed=24)
    mesh = make_mesh(8, device="cpu")
    state = SchedState.init(m=64, device=CPU)
    sharded = pm.shard_state(mesh, state)
    for wave in range(2):
        r1, r2 = _both(cfg, mesh, state, sharded, _requests(64, wave), eps,
                       None)
        _assert_equal(r1, r2, state, sharded)


def test_sharded_cycle_with_predictor_column():
    """The latency column inside the meshed cycle, params replicated:
    picks exact, the column within the predictor tests' rtol 2e-3 of the
    unmeshed column (the MLP's matmuls run at another batch shape per
    block)."""
    from gie_tpu_torch.models.latency import (
        LatencyPredictor,
        predictor_score_fn,
    )

    predictor = LatencyPredictor()
    params = predictor.init(seed=0)
    fn = predictor_score_fn(predictor)
    cfg = ProfileConfig()
    weights = Weights.default().replace(latency=0.3)
    eps = make_endpoints(8, queue=[0, 1, 2, 3, 4, 5, 6, 7], m_slots=64)
    reqs = make_requests(16, prompt_len=[256.0] * 16, m_slots=64)
    mesh = make_mesh(8, device="cpu")
    state = SchedState.init(m=64, device=CPU)
    sharded = pm.shard_state(mesh, state)
    r1, r2 = _both(cfg, mesh, state, sharded, reqs, eps, None, weights,
                   predictor_fn=fn, predictor_params=params)
    assert torch.equal(r1.indices, r2.indices)
    assert torch.equal(r1.status, r2.status)

    fresh = SchedState.init(m=64, device=CPU)
    _, _, named, *_ = build_stages(fresh, reqs, eps, weights, cfg=cfg,
                                   predictor_fn=fn, predictor_params=params)
    _, _, blocks, *_ = build_stages(
        pm.shard_state(mesh, fresh), pm.shard_requests(mesh, reqs),
        pm.shard_endpoints(mesh, eps), weights, cfg=cfg, predictor_fn=fn,
        predictor_params=params, mesh=mesh)
    column = torch.cat([torch.cat([b["latency"] for b in row], dim=1)
                        for row in blocks], dim=0)
    assert tuple(blocks[0][0]["latency"].shape) == (4, 32)
    torch.testing.assert_close(column, named["latency"], rtol=2e-3, atol=0)


def test_scheduler_facade_with_mesh_matches_single_device():
    """Scheduler(mesh=), the --mesh-devices path, returns the unmeshed
    facade's picks over state-carrying waves and the dp bucket floor."""
    for cfg, weights in ((ProfileConfig(), None), tuned_profile()):
        rng = np.random.default_rng(3)
        m = 16
        eps = make_endpoints(m, queue=rng.integers(0, 30, m).tolist(),
                             kv=rng.uniform(0, 0.9, m).tolist(), m_slots=64)
        plain = Scheduler(cfg, weights, seed=5, device="cpu")
        meshed = Scheduler(cfg, weights, seed=5,
                           mesh=make_mesh(8, device="cpu"))
        assert meshed._min_bucket == 4 and meshed.device == CPU
        for wave in range(3):
            prompts = [b"S%d " % (i % 4) * 30 + b"w%d q%d" % (wave, i)
                       for i in range(24)]
            reqs = make_requests(24, prompts=prompts, m_slots=64)
            r1, r2 = plain.pick(reqs, eps), meshed.pick(reqs, eps)
            np.testing.assert_array_equal(r1.indices, r2.indices)
            np.testing.assert_array_equal(r1.status, r2.status)
        np.testing.assert_allclose(plain.snapshot_assumed_load(),
                                   meshed.snapshot_assumed_load(), atol=1e-6)
        # A 3-request batch pads to the dp floor and still round-trips.
        small = make_requests(3, m_slots=64)
        got = meshed.pick(small, eps)
        assert got.indices.shape[0] == 3
        np.testing.assert_array_equal(got.indices,
                                      plain.pick(small, eps).indices)
        assert meshed.debug_report()["mesh"] == {"dp": 4, "tp": 2}
    # A profile that asks for the Sinkhorn kernel runs the grouped solve
    # under a mesh, as the reference's does, and its zpage says so.
    cfg, weights = tuned_profile()
    asked = dataclasses.replace(cfg, use_pallas_sinkhorn=True)
    reports = [Scheduler(asked, weights, **kw).debug_report()
               for kw in ({"device": "cpu"},
                          {"mesh": make_mesh(8, device="cpu")})]
    assert [r["sinkhorn_solve"] for r in reports] == ["kernel", "grouped"]


def test_meshed_facade_methods_equal_unmeshed(tmp_path):
    """Each facade method that touches state sends each slot to its owner
    shard, or gathers and scatters whole arrays: the states stay equal to
    the unmeshed scheduler's, arrays and checkpoints interchange."""
    cfg, weights = tuned_profile()
    eps = _loaded_pool(40, 64, seed=31)
    plain = Scheduler(cfg, weights, seed=9, device="cpu")
    meshed = Scheduler(cfg, weights, seed=9,
                       mesh=make_mesh(4, tp=4, device="cpu"))
    assert not meshed.state.words_axis
    for s in (plain, meshed):
        s.pick(_requests(24, 0, tag=b"F"), eps)
        s.complete([1, 2, 2, 70, 33], [0.5, 0.25, 0.25, 1.0, 0.75])
        s.evict_endpoint(3)
        s.evict_endpoint(40)
        s.clear_prefix_endpoint(5)
        s.apply_prefix_events(7, np.array([11, 12, 13], np.uint32),
                              np.array([], np.uint32))
        s.apply_prefix_events(40, np.array([99, 12], np.uint32),
                              np.array([11], np.uint32))
    a, b = plain.export_state(), meshed.export_state()
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    meshed.save_state(str(tmp_path))
    fresh = Scheduler(cfg, weights, seed=9,
                      mesh=make_mesh(4, tp=4, device="cpu"))
    assert fresh.restore_state(str(tmp_path))
    c = fresh.export_state()
    for k in a:
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    # An unmeshed export installs into a meshed scheduler and back.
    assert meshed.install_state(a) and plain.install_state(b)
    reqs = _requests(24, 1, tag=b"F")
    np.testing.assert_array_equal(plain.pick(reqs, eps).indices,
                                  meshed.pick(reqs, eps).indices)
    np.testing.assert_array_equal(plain.prefix_hot_keys(),
                                  meshed.prefix_hot_keys())
    e1, e2 = plain.explain(reqs, eps), meshed.explain(reqs, eps)
    for k in e1:
        np.testing.assert_array_equal(e1[k], e2[k], err_msg=k)


def test_mesh_guardrails():
    """Clear startup errors: a dp axis that is no power of two, an
    over-requested mesh, --mesh-devices 6, and a Sinkhorn solve whose
    reduction groups the mesh axes do not divide."""
    from gie_tpu_torch.runtime.options import Options
    from gie_tpu_torch.sched.sinkhorn import _solve_plan

    with pytest.raises(ValueError, match="power of two"):
        Scheduler(ProfileConfig(), mesh=make_mesh(6, tp=2, device="cpu"))
    with pytest.raises(ValueError, match="available"):
        make_mesh(pm.CPU_POSITIONS + 1, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        make_mesh(6, tp=4, device="cpu")
    opts = Options(pool_name="p", mesh_devices=6)
    with pytest.raises(ValueError, match="power of two"):
        opts.validate()
    Options(pool_name="p", mesh_devices=8).validate()
    mesh = make_mesh(devices=["cpu"] * 16, tp=1)      # dp 16 > 8 groups
    k = [[torch.ones((1, 64), device=mesh.device(i, 0))]
         for i in range(mesh.dp)]
    with pytest.raises(ValueError, match="must divide the canonical"):
        _solve_plan(k, [torch.ones(64)], [torch.ones(64)], iters=2)
    # An explicit device list may repeat a device.
    rep = make_mesh(devices=["cpu"] * 4, tp=2)
    assert rep.shape == {"dp": 2, "tp": 2} and rep.distinct_devices == [CPU]


def test_shard_helpers_round_trip():
    mesh = make_mesh(8, device="cpu")
    rng = np.random.default_rng(4)
    arrays = {
        "prefix_keys": rng.integers(0, 2**32, C.PREFIX_SLOTS, np.uint32),
        "prefix_present": rng.integers(0, 2**32, (C.PREFIX_SLOTS, 8),
                                       np.uint32),
        "prefix_ages": rng.integers(0, 2**32, C.PREFIX_SLOTS, np.uint32),
        "assumed_load": rng.uniform(0, 4, 256).astype(np.float32),
        "ot_v": rng.uniform(0, 1, 256).astype(np.float32),
        "rr": np.uint32(7), "tick": np.uint32(9)}
    state = convert.state_from_numpy(arrays, device=CPU)
    back = convert.state_to_numpy(pm.unshard_state(pm.shard_state(mesh,
                                                                  state)))
    for k, v in convert.state_to_numpy(state).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    reqs = _requests(16, 0, m=256)
    shards = pm.shard_requests(mesh, reqs)
    assert len(shards) == 4 and len(shards[0]) == 2
    assert tuple(shards[1][1].subset_mask.shape) == (4, 128)
    assert torch.equal(shards[1][1].subset_mask,
                       reqs.subset_mask[4:8, 128:256])
    layout = pm.cycle_shardings(mesh)
    assert layout[1].subset_mask == ("dp", "tp") and layout[2].valid == (
        "tp",)
    with pytest.raises(ValueError, match="does not split"):
        pm.shard_requests(mesh, _requests(6, 0))


def test_sharded_train_step_matches_single_step():
    """The predictor step over 8 positions (batch on dp, Dense weights on
    tp) against make_train_step's single step from the same params: the
    losses within rtol 1e-4, and every gradient within two bf16 steps of
    its largest element (the hidden layers run in bf16, and a row-split
    layer rounds its summed partials to bf16 once, as the whole matmul
    rounds its accumulation)."""
    from gie_tpu_torch.models.latency import (
        NUM_FEATURES,
        LatencyPredictor,
        make_optimizer,
        make_train_step,
    )

    predictor = LatencyPredictor()
    mesh = make_mesh(8, device="cpu")
    layout = pm.predictor_param_shardings(mesh, predictor.init())
    assert layout["Dense_0.weight"] == ("tp", None)
    assert layout["Dense_1.weight"] == (None, "tp")
    assert layout["Dense_0.bias"] == () and layout["Embed_0.weight"] == ()
    rng = np.random.default_rng(0)
    batch = 32
    feats = torch.from_numpy(rng.uniform(0, 1, (batch, NUM_FEATURES))
                             .astype(np.float32))
    slots = torch.from_numpy(rng.integers(0, 8, batch).astype(np.int64))
    targets = torch.from_numpy(rng.uniform(0, 1, (batch, 2))
                               .astype(np.float32))
    weights = torch.ones((batch, 2))
    losses, grads = [], []
    for step_fn in (make_train_step(predictor),
                    pm.sharded_train_step(mesh, predictor)):
        module = predictor.module(seed=0)
        opt = make_optimizer(module, predictor.cfg)
        losses.append(float(step_fn(module, opt, feats, slots, targets,
                                    weights)))
        grads.append({k: v.grad.clone()
                      for k, v in module.named_parameters()})
    assert losses[1] == pytest.approx(losses[0], rel=1e-4)
    for k, g in grads[0].items():
        assert grads[1][k].abs().max() > 0, k
        torch.testing.assert_close(grads[1][k], g, rtol=0,
                                   atol=float(g.abs().max()) * 2.0**-7)


# -- against the reference's sharded cycle (JAX, 8 CPU devices) --------------

@pytest.mark.parametrize("case", ["topk", "sinkhorn", "random", "pd"])
def test_mesh8_matches_reference_sharded_cycle(case):
    import jax
    import jax.numpy as jnp

    from gie_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from gie_tpu.parallel.mesh import sharded_cycle
    from gie_tpu.sched.profile import ProfileConfig as JaxProfileConfig
    from gie_tpu.sched.types import SchedState as JaxSchedState
    from gie_tpu.sched.types import Weights as JaxWeights
    from gie_tpu.utils import testing as jt

    assert len(jax.devices()) >= 8
    pd = case == "pd"
    picker = "sinkhorn" if pd else case
    jcfg = JaxProfileConfig(picker=picker, pd_disaggregation=pd)
    cfg = ProfileConfig(picker=picker, pd_disaggregation=pd)
    rng = np.random.default_rng(21)
    if pd:
        roles, queue, kv = _pd_endpoints()
        jeps = jt.make_endpoints(8, queue=queue, kv=kv,
                                 role=[int(r) for r in roles], m_slots=64)
    else:
        jeps = jt.make_endpoints(
            37, queue=rng.integers(40, 120, 37).tolist(),
            kv=rng.uniform(0.1, 0.9, 37).tolist(), m_slots=64)
    eps = convert.endpoints_from_numpy(jeps, device=CPU)
    jsharded = sharded_cycle(jax_make_mesh(8), jcfg, None)
    jstate = JaxSchedState.init(m=64)
    mesh = make_mesh(8, device="cpu")
    sharded = pm.ShardedState.init(mesh, 64)
    weights = Weights.default()
    for wave in range(2):
        prompts = [b"MAT %d " % (i % 4) * 30 + b"w%d q%d" % (wave, i)
                   for i in range(64)]
        jreqs = jt.make_requests(64, prompts=prompts, m_slots=64)
        key = jax.random.PRNGKey(100 + wave)
        jr, jstate = jsharded(jstate, jreqs, jeps, JaxWeights.default(), key,
                              None)
        if pd:
            kp, kd = jax.random.split(key)
            noise = np.stack([np.asarray(jax.random.gumbel(
                k, (64, 64), jnp.float32)) for k in (kp, kd)])
        else:
            noise = np.asarray(jax.random.gumbel(key, (64, 64), jnp.float32))
        gumbel = None if picker == "topk" else torch.from_numpy(noise)
        reqs = convert.requests_from_numpy(jreqs, device=CPU)
        rows, _ = scheduling_cycle(
            sharded, pm.shard_requests(mesh, reqs),
            pm.shard_endpoints(mesh, eps), weights,
            pm.shard_noise(mesh, gumbel), cfg=cfg, mesh=mesh)
        got = pm.unshard_result(rows)
        for f in ("indices", "status", "prefill"):
            if getattr(jr, f) is not None:
                np.testing.assert_array_equal(
                    getattr(got, f).numpy(), np.asarray(getattr(jr, f)),
                    err_msg=f)
        ref = {k: np.asarray(v) for k, v in dataclasses.asdict(
            jstate.prefix).items()}
        port = convert.state_to_numpy(sharded.gather())
        for k in ("keys", "present", "ages"):
            np.testing.assert_array_equal(port[f"prefix_{k}"],
                                          ref[k].astype(np.uint32),
                                          err_msg=k)
        for k in ("assumed_load", "ot_v"):
            np.testing.assert_allclose(port[k], np.asarray(getattr(jstate, k)),
                                       atol=1e-5, rtol=0, err_msg=k)
    assert (got.indices[:, 0] >= 0).any()
