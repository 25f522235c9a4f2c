"""gie_tpu_torch/simulator/cluster.py against gie_tpu/simulator/cluster.py
on the CPU: the closed loop the reference's own tests train the latency
predictor in.

Without a trainer the two SimClusters are the same simulation: the
baseline policies equal the reference's stats field for field, and so does
the tpu policy with the port's Scheduler taking the reference Scheduler's
Gumbel noise (jax_noise_replay), so every wave picks the same endpoints.
With a trainer the port passes the reference test's own assertions
(tests/test_goodput.py): the predictor trains online to a loss under 1.0
and goodput stays above 1.2x least-kv's.
"""

import dataclasses

import pytest

from gie_tpu.sched.profile import Scheduler as JaxScheduler
from gie_tpu.sched.config import tuned_profile as jax_tuned_profile
from gie_tpu.simulator import StubConfig as JaxStubConfig
from gie_tpu.simulator.cluster import SimCluster as JaxSimCluster
from gie_tpu.simulator.cluster import WorkloadConfig as JaxWorkloadConfig

from gie_tpu_torch.sched import ProfileConfig, Scheduler, Weights
from gie_tpu_torch.sched.config import tuned_profile
from gie_tpu_torch.simulator import StubConfig
from gie_tpu_torch.simulator.cluster import (
    SimCluster,
    WorkloadConfig,
    tuned_scheduler,
)
from tests.test_torch_slice import jax_noise_replay

WORKLOAD = dict(arrival_qps=75.0, n_sessions=64, system_prompt_bytes=8192,
                user_suffix_bytes=128, decode_tokens_mean=32.0,
                ttft_slo_s=2.5)
STUB = dict(max_running=8, prefill_tokens_per_s=4000.0,
            decode_tokens_per_s=50.0, prefix_cache_chunks=2048)


def _run(pkg: str, policy: str, duration: float, **kw):
    if pkg == "ref":
        cluster = JaxSimCluster(n_pods=8, stub_cfg=JaxStubConfig(**STUB),
                                seed=0)
        return cluster.run(policy, JaxWorkloadConfig(**WORKLOAD),
                           duration_s=duration, **kw)
    cluster = SimCluster(n_pods=8, stub_cfg=StubConfig(**STUB), seed=0)
    return cluster.run(policy, WorkloadConfig(**WORKLOAD),
                       duration_s=duration, **kw)


@pytest.mark.parametrize("policy", ["least-kv", "least-kv-assumed",
                                    "round-robin"])
def test_baselines_equal_reference(policy):
    ref = _run("ref", policy, 3.0)
    port = _run("port", policy, 3.0)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_tpu_policy_equals_reference_under_replayed_noise():
    jc, jw = jax_tuned_profile()
    tc, tw = tuned_profile()
    ref = _run("ref", "tpu", 3.0, scheduler=JaxScheduler(jc, jw, seed=0))
    port = _run("port", "tpu", 3.0, scheduler=Scheduler(
        tc, tw, device="cpu", noise_source=jax_noise_replay(0)))
    assert ref.completed > 100
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_tuned_scheduler_is_the_tuned_profile_on_the_named_device():
    sched = tuned_scheduler(device="cpu")
    assert (sched.cfg, sched.weights) == tuned_profile()
    assert sched.device.type == "cpu"


def test_predictor_trains_online_in_sim_without_regression():
    """tests/test_goodput.py's case on the port: the predictor column
    learns from sim completions and must not regress goodput."""
    from gie_tpu_torch.models.latency import (
        LatencyPredictor,
        OnlineTrainer,
        predictor_score_fn,
    )

    p = LatencyPredictor()
    trainer = OnlineTrainer(p, batch_size=64, device="cpu")
    sched = Scheduler(
        ProfileConfig(load_decay=0.95, load_norm=8, queue_norm=16,
                      picker="sinkhorn"),
        weights=Weights(queue=2.0, kv_cache=1.0, prefix=4.0, lora=1.0,
                        assumed_load=1.5, latency=1.0),
        device="cpu", predictor_fn=predictor_score_fn(p),
        predictor_params=trainer.params)
    base = _run("port", "least-kv", 12.0)
    stats = _run("port", "tpu", 12.0, scheduler=sched, trainer=trainer)
    assert trainer.last_loss is not None and trainer.last_loss < 1.0
    assert stats.goodput_tokens_per_s > base.goodput_tokens_per_s * 1.2
    # The handoff landed: the column was phased in.
    assert 0.0 < sched.weights.latency <= 1.0


def test_slo_admission_sheds_in_the_sim():
    """slo_admission sheds exactly the arrivals whose forecast misses the
    SLO: here every pick on an odd slot."""
    import numpy as np

    from gie_tpu_torch.models.latency import LatencyPredictor, OnlineTrainer

    trainer = OnlineTrainer(LatencyPredictor(), batch_size=16, device="cpu")
    late = []

    def predict_ttft(feats, slots):
        pred = np.where(np.asarray(slots) % 2 == 1, 99.0, 0.0)
        late.append(int((pred > 0).sum()))
        return pred.astype(np.float32)

    trainer.predict_ttft = predict_ttft
    stats = _run("port", "tpu", 2.0, scheduler=tuned_scheduler(device="cpu"),
                 trainer=trainer, slo_admission=True)
    assert stats.shed == sum(late) > 0
    assert stats.completed > 0
