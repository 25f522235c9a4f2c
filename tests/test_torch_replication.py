"""HA state replication on the port (gie_tpu_torch.replication) against the
JAX reference (gie_tpu.replication) on the CPU.

  bytes      the same export_state arrays (a reference Scheduler's after
             two waves, installed into a port Scheduler and exported
             again) encode to identical section payloads and digests,
             with the epoch and the publisher's era fixed;
  interop    a reference digest decodes in the port and a port digest in
             the reference, array for array; a flipped byte is refused by
             both;
  publisher  ETag, 304, `since` deltas, era mismatch, non-leader and
             not-yet-published answers equal the reference's, call for
             call;
  HTTP HA    a port follower syncs from the reference's publisher over
             loopback HTTP, and the reference's follower from the port's;
             each side's export_state after the sync is bit-equal to its
             leader's;
  manager    two port ReplicationManagers over two LeaseFileElectors on
             one temp lease and a fake clock: the leader publishes, the
             follower installs (full, then a delta), the lease expires,
             the follower promotes warm, and the new era makes the old
             leader resync in full;
  faults     replication.publish (error, corrupt) and replication.poll
             fire as in the reference, verdict for verdict.

Tolerance: none. Digests, sections and exports compare byte for byte.
"""

import time

import numpy as np
import pytest

from gie_tpu.autoscale.model import CapacityModel as RefCapacity
from gie_tpu.replication import codec as ref_codec
from gie_tpu.replication import follower as ref_follower
from gie_tpu.replication import manager as ref_manager
from gie_tpu.replication import publisher as ref_publisher
from gie_tpu.resilience import faults as ref_faults
from gie_tpu.sched import Scheduler as JaxScheduler
from gie_tpu.sched.config import tuned_profile as jax_tuned_profile

from gie_tpu_torch import convert
from gie_tpu_torch.autoscale.model import CapacityModel
from gie_tpu_torch.replication import codec
from gie_tpu_torch.replication import follower as follower_mod
from gie_tpu_torch.replication import manager as manager_mod
from gie_tpu_torch.replication import publisher as publisher_mod
from gie_tpu_torch.resilience import faults
from gie_tpu_torch.runtime import leader as leader_mod
from gie_tpu_torch.sched import Scheduler
from gie_tpu_torch.sched.config import tuned_profile
from tests.test_torch_slice import SEED, _endpoints, _wave, jax_noise_replay

ERA = "fixed-era"


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (faults, ref_faults):
        f.uninstall()
    yield
    for f in (faults, ref_faults):
        f.uninstall()


@pytest.fixture(scope="module")
def ref_state():
    """A reference Scheduler after two waves of the bench mix, and its
    export."""
    jc, jw = jax_tuned_profile()
    sched = JaxScheduler(jc, jw, seed=SEED)
    eps = _endpoints()
    for w in range(2):
        sched.pick(_wave(w), eps)
    return sched, sched.export_state()


def _port_sched(seed=SEED):
    return Scheduler(*tuned_profile(), seed=seed, device="cpu",
                     noise_source=jax_noise_replay(seed))


def _assert_bit_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        a_k, b_k = np.asarray(a[k]), np.asarray(b[k])
        assert a_k.dtype == b_k.dtype and a_k.shape == b_k.shape, k
        np.testing.assert_array_equal(a_k, b_k, err_msg=k)


def _capacity(cls, ewma):
    model = cls()
    if ewma is not None:
        model._ewma = ewma
    return model


def test_digest_bytes_equal_the_reference(ref_state):
    _, exported = ref_state
    port = _port_sched()
    assert port.install_state(exported)
    port_export = port.export_state()
    _assert_bit_equal(exported, port_export)
    ref_cap, cap = _capacity(RefCapacity, 12.5), _capacity(CapacityModel,
                                                           12.5)
    for name, ref_arrays, arrays in (
            ("sched", exported, port_export),
            ("autoscale", ref_cap.export_state(), cap.export_state())):
        assert codec.encode_section(arrays) == ref_codec.encode_section(
            ref_arrays), name
    sections = {"sched": port_export, "autoscale": cap.export_state()}
    ref_sections = {"sched": exported, "autoscale": ref_cap.export_state()}
    for delta, base in ((False, 0), (True, 3)):
        assert codec.encode_digest(7, sections, delta=delta,
                                   base_epoch=base) == \
            ref_codec.encode_digest(7, ref_sections, delta=delta,
                                    base_epoch=base)
    # Whole publisher output, the era fixed: the same bytes and headers.
    pub = publisher_mod.StatePublisher(
        {"sched": port.export_state, "autoscale": cap.export_state}, era=ERA)
    ref_pub = ref_publisher.StatePublisher(
        {"sched": lambda: exported, "autoscale": ref_cap.export_state},
        era=ERA)
    assert pub.refresh() == ref_pub.refresh() == 1
    assert pub.serve() == ref_pub.serve()
    assert pub.status() == ref_pub.status()
    assert pub.digest_bytes > 1 << 16


def test_digests_decode_across_packages(ref_state):
    _, exported = ref_state
    ref_blob = ref_codec.encode_digest(5, {"sched": exported})
    port_blob = codec.encode_digest(
        5, {"sched": _port_sched().export_state(),
            "autoscale": CapacityModel().export_state()})
    for blob, decode in ((ref_blob, codec.decode_digest),
                         (port_blob, ref_codec.decode_digest)):
        ours = (codec.decode_digest(blob) if decode is ref_codec.decode_digest
                else ref_codec.decode_digest(blob))
        theirs = decode(blob)
        assert theirs is not None and ours is not None
        assert (theirs.epoch, theirs.base_epoch, theirs.delta) == (
            ours.epoch, ours.base_epoch, ours.delta)
        assert set(theirs.sections) == set(ours.sections)
        for name in ours.sections:
            _assert_bit_equal(ours.sections[name], theirs.sections[name])
    rng = np.random.default_rng(SEED)
    for pos in rng.integers(0, len(port_blob), 24):
        flipped = bytearray(port_blob)
        flipped[int(pos)] ^= 0x5A
        assert codec.decode_digest(bytes(flipped)) is None
        assert ref_codec.decode_digest(bytes(flipped)) is None
    assert codec.decode_digest(port_blob[:-1]) is None
    assert codec.decode_digest(b"") is None


def _publisher_script(pub_mod, leader_box):
    """One call sequence through a StatePublisher over exporters that
    change between refreshes; -> every (status, headers, body)."""
    state = {"a": np.arange(6, dtype=np.uint32), "b": np.float32(1.5)}
    other = {"c": np.zeros((2, 3), np.float32)}
    pub = pub_mod.StatePublisher(
        {"s1": lambda: dict(state), "s2": lambda: dict(other)}, era=ERA)
    out = [pub.serve()]                        # nothing published yet
    out.append(pub.refresh())
    first = pub.serve()
    etag = first[1]["ETag"]
    out += [first, pub.serve(if_none_match=etag)]
    out.append(pub.refresh())                  # unchanged: no new epoch
    state["a"] = state["a"] + 1
    out.append(pub.refresh())                  # s1 changed: epoch 2
    out += [pub.serve(since=1, era=ERA),       # delta of s1 only
            pub.serve(since=0, era=ERA),       # delta of both
            pub.serve(since=1, era="other"),   # era mismatch: full
            pub.serve(since=9, era=ERA),       # future epoch: full
            pub.serve(if_none_match=etag),     # old etag: full
            pub.serve(leader=leader_box[0])]
    out.append(pub.status())
    return out


def test_publisher_semantics_equal_the_reference():
    port = _publisher_script(publisher_mod, [False])
    ref = _publisher_script(ref_publisher, [False])
    assert port == ref
    assert port[0][0] == 503 and port[3][0] == 304
    assert port[1] == port[4] == 1 and port[5] == 2
    delta = codec.decode_digest(port[6][2])
    assert delta.delta and delta.base_epoch == 1 and set(delta.sections) == {
        "s1"}
    assert set(codec.decode_digest(port[7][2]).sections) == {"s1", "s2"}
    for full in (port[8], port[9], port[10]):
        digest = codec.decode_digest(full[2])
        assert not digest.delta and set(digest.sections) == {"s1", "s2"}
    assert port[11][0] == 503                  # not the leader


class _Elector:
    """A fixed holder for a follower: never leads."""

    def __init__(self, holder):
        self.identity = "follower"
        self._holder = holder

    def is_leader(self):
        return False

    def holder_identity(self):
        return self._holder


def test_cross_package_ha_over_loopback_http(ref_state):
    """A port follower syncs from the reference's publisher, and the
    reference's follower from the port's, both over real HTTP."""
    jsched, exported = ref_state
    ref_leader = ref_manager.ReplicationManager(scheduler=jsched, era="ref")
    port_follower = manager_mod.ReplicationManager(scheduler=_port_sched())
    port_leader_sched = _port_sched()
    eps = convert.endpoints_from_numpy(_endpoints(), device="cpu")
    for w in range(3):
        port_leader_sched.pick(
            convert.requests_from_numpy(_wave(w), device="cpu"), eps)
    port_leader = manager_mod.ReplicationManager(
        scheduler=port_leader_sched, era="port")
    jc, jw = jax_tuned_profile()
    ref_follower_mgr = ref_manager.ReplicationManager(
        scheduler=JaxScheduler(jc, jw, seed=SEED + 1))
    try:
        port_follower.attach_elector(_Elector(
            manager_mod.replication_identity(ref_leader.advertise, "ref")))
        ref_follower_mgr.attach_elector(_Elector(
            ref_manager.replication_identity(port_leader.advertise, "port")))
        t0 = time.monotonic()
        assert ref_leader.step(now=t0) == "published"
        assert port_leader.step(now=t0) == "published"
        assert port_follower.step(now=t0) == follower_mod.INSTALLED
        assert ref_follower_mgr.step(now=t0) == ref_follower.INSTALLED
        _assert_bit_equal(port_follower.scheduler.export_state(), exported)
        _assert_bit_equal(ref_follower_mgr.scheduler.export_state(),
                          port_leader_sched.export_state())
        assert port_follower.follower.installed_era == "ref"
        assert ref_follower_mgr.follower.installed_era == "port"
        # Unchanged state: the next poll is one 304 on each side.
        assert port_follower.step(now=t0 + 2) == follower_mod.NOT_MODIFIED
        assert ref_follower_mgr.step(now=t0 + 2) == ref_follower.NOT_MODIFIED
        assert port_follower.healthy() and ref_follower_mgr.healthy()
    finally:
        for mgr in (ref_leader, port_follower, port_leader, ref_follower_mgr):
            mgr.stop()


class _FakeTime:
    """The wall and monotonic clocks the lease module reads."""

    def __init__(self, t):
        self.t = t

    def time(self):
        return self.t

    def monotonic(self):
        return self.t


def _tick(elector):
    elector._set_leader(elector._tick())


def test_manager_fails_over_warm_and_the_old_leader_resyncs_in_full(
        tmp_path, monkeypatch):
    clock = _FakeTime(1000.0)
    monkeypatch.setattr(leader_mod, "time", clock)
    lease = str(tmp_path / "lease")
    a = manager_mod.ReplicationManager(scheduler=_port_sched(), era="era-a")
    b = manager_mod.ReplicationManager(scheduler=_port_sched(SEED + 1),
                                       era="era-b")
    electors = {}
    try:
        for name, mgr in (("a", a), ("b", b)):
            el = leader_mod.LeaseFileElector(
                lease, identity=manager_mod.replication_identity(
                    mgr.advertise, name))
            el.on_role_change = mgr.on_role_change
            mgr.attach_elector(el)
            electors[name] = el
        _tick(electors["a"])
        _tick(electors["b"])
        assert electors["a"].is_leader() and not electors["b"].is_leader()
        assert a.healthy() and not b.healthy()     # b is cold

        eps = convert.endpoints_from_numpy(_endpoints(), device="cpu")

        def waves(sched, ws):
            for w in ws:
                res = sched.pick(
                    convert.requests_from_numpy(_wave(w), device="cpu"), eps)
                done = res.indices[:8, 0]
                sched.complete(done, np.full(done.shape, 0.25, np.float32))

        waves(a.scheduler, range(2))
        t0 = time.monotonic()      # the managers' clock (the lease's is fake)
        assert a.step(now=t0) == "published"
        assert b.step(now=t0) == follower_mod.INSTALLED
        assert not b.follower.last_delta and b.healthy()
        _assert_bit_equal(b.scheduler.export_state(),
                          a.scheduler.export_state())
        waves(a.scheduler, [2])
        assert a.step(now=t0 + 2) == "published"
        assert b.step(now=t0 + 2) == follower_mod.INSTALLED
        assert b.follower.last_delta                 # only "sched" changed
        _assert_bit_equal(b.scheduler.export_state(),
                          a.scheduler.export_state())
        installed = b.follower.installed_epoch

        # The leader stops renewing; past the TTL the follower takes over.
        clock.t += electors["b"].lease_ttl_s + 1.0
        _tick(electors["b"])
        assert electors["b"].is_leader()
        assert b.promoted_with_epoch == installed
        # Promoted warm: its state is the old leader's, before any sync.
        _assert_bit_equal(b.scheduler.export_state(),
                          a.scheduler.export_state())
        _tick(electors["a"])
        assert not electors["a"].is_leader()
        assert b.step(now=t0 + 4) == "published"     # publishes at once
        waves(b.scheduler, [3])
        assert b.step(now=t0 + 6) == "published"
        # The old leader, now a follower, sees the new era: a full sync.
        assert a.step(now=t0 + 6) == follower_mod.INSTALLED
        assert a.follower.installed_era == "era-b"
        assert not a.follower.last_delta
        _assert_bit_equal(a.scheduler.export_state(),
                          b.scheduler.export_state())
    finally:
        for mgr in (a, b):
            mgr.stop()


def test_install_is_two_phase_and_skips_unknown_sections(ref_state):
    """A digest whose autoscale section is malformed commits nothing (the
    scheduler keeps its state); a reference leader's predictor section is
    skipped by a manager without a trainer and installed by one with a
    port trainer."""
    _, exported = ref_state
    cap = CapacityModel()
    mgr = manager_mod.ReplicationManager(scheduler=_port_sched(),
                                         capacity_model=cap)
    try:
        before = mgr.scheduler.export_state()
        assert not mgr._install({"sched": exported, "autoscale": {}},
                                delta=False)
        _assert_bit_equal(mgr.scheduler.export_state(), before)
        assert not cap.converged
        assert mgr._install({"sched": exported,
                             "autoscale": {"ewma": np.float32(3.0)},
                             "predictor": {"w": np.zeros(3, np.float32)}},
                            delta=False)
        _assert_bit_equal(mgr.scheduler.export_state(), exported)
        assert cap.per_replica() == 3.0
        # A table of another row count is refused by prepare_install.
        short = dict(exported, prefix_keys=exported["prefix_keys"][:-32],
                     prefix_present=exported["prefix_present"][:-32],
                     prefix_ages=exported["prefix_ages"][:-32])
        assert not mgr._install({"sched": short}, delta=False)
    finally:
        mgr.stop()
    from gie_tpu.models.latency import LatencyPredictor as JaxPredictor
    from gie_tpu.models.latency import OnlineTrainer as JaxTrainer

    from gie_tpu_torch.models.latency import LatencyPredictor, OnlineTrainer

    leader = JaxTrainer(JaxPredictor(), seed=4)
    leader._loss_ema, leader._observed_total = 0.02, 900
    section = leader.export_state()
    trainer = OnlineTrainer(LatencyPredictor(), device="cpu")
    mgr = manager_mod.ReplicationManager(scheduler=_port_sched(),
                                         trainer=trainer)
    try:
        bad = dict(section)
        del bad["observed_total"]
        assert not mgr._install({"sched": exported, "predictor": bad},
                                delta=False)
        assert trainer.confidence() == 0.0           # nothing committed
        assert mgr._install({"sched": exported, "predictor": section},
                            delta=False)
        _assert_bit_equal(mgr.scheduler.export_state(), exported)
        got = trainer.export_state()
        assert list(got) == list(section)
        for k, v in section.items():
            assert np.array_equal(np.asarray(v), got[k], equal_nan=True), k
        assert trainer.confidence() == leader.confidence()
    finally:
        mgr.stop()


def _fault_script(pub_mod, follower_module, faults_mod):
    faults_mod.install(faults_mod.FaultInjector(31, faults_mod.parse_spec([
        "replication.publish=error:0.3,corrupt:0.3",
        "replication.poll=error:0.4"])))
    pub = pub_mod.StatePublisher(
        {"s": lambda: {"x": np.arange(16, dtype=np.float32)}}, era=ERA)
    pub.refresh()
    serves = [pub.serve()[0] for _ in range(20)]
    installs = []
    fol = follower_module.FollowerSync(
        lambda: "http://leader", lambda s, delta: installs.append(1) or True,
        # Every poll a full fetch, so a corrupt verdict reaches the codec.
        interval_s=0.0, fetch=lambda url, since, era, etag: pub.serve(),
        seed=3)
    outcomes = [fol.poll_once(now=float(k)) for k in range(20)]
    inj = faults_mod.installed()
    return serves, outcomes, dict(inj.fired), list(inj.log)


def test_replication_fault_points_fire_as_in_the_reference():
    port = _fault_script(publisher_mod, follower_mod, faults)
    faults.uninstall()
    ref = _fault_script(ref_publisher, ref_follower, ref_faults)
    assert port == ref
    serves, outcomes, fired, _log = port
    assert 503 in serves and 200 in serves
    assert fired["replication.publish"] > 0 and fired["replication.poll"] > 0
    assert follower_mod.FETCH_ERROR in outcomes
    assert follower_mod.CORRUPT in outcomes
    assert follower_mod.INSTALLED in outcomes


def test_health_and_metrics_follow_the_role():
    from gie_tpu_torch.runtime import metrics as own_metrics

    mgr = manager_mod.ReplicationManager(scheduler=_port_sched())
    try:
        assert mgr.is_leader() and mgr.healthy()     # no elector: leads
        assert mgr.step(now=1.0) == "published"
        assert own_metrics.REPLICATION_ROLE.value() == 1.0
        assert own_metrics.REPLICATION_EPOCH.value() == 1.0
        assert own_metrics.REPLICATION_DIGEST_BYTES.value() == \
            mgr.publisher.digest_bytes
        mgr.attach_elector(_Elector(None))           # no leader to sync from
        assert mgr.step(now=2.0) == follower_mod.NO_LEADER
        assert not mgr.healthy()
        assert own_metrics.REPLICATION_ROLE.value() == 0.0
        assert own_metrics.REPLICATION_STALENESS.value() == -1.0
        assert own_metrics.REPLICATION_SYNCS.value("no_leader") >= 1
        assert manager_mod.advertise_from_identity("x|h:1") == "h:1"
        assert manager_mod.advertise_from_identity("x") is None
    finally:
        mgr.stop()
