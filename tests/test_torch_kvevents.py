"""The KV-cache event interface against the JAX reference on the CPU:
`prefix.ingest_keys`, the Scheduler's event fold (parts of at most 4096
hashes, stored before removed, bucket growth, ages at the state's tick),
its journal replayed over a digest install, `prefix_hot_keys`, the
aggregator and its HTTP transport, the queued form of the calls the card
runs, and the simulator stub's event sink.

Inputs are made from numpy seeds and carried to both packages; the prefix
table (keys, packed presence words, ages) must be equal word for word,
and the assumed load within the state tolerance of tests/test_torch_slice.py
(atol=1e-5).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gie_tpu.sched import ProfileConfig as JaxProfileConfig
from gie_tpu.sched import Scheduler as JaxScheduler
from gie_tpu.sched import prefix as jprefix
from gie_tpu.sched.types import PrefixTable as JaxPrefixTable
from gie_tpu.utils.testing import make_endpoints, make_requests

from gie_tpu_torch import convert
from gie_tpu_torch.sched import ProfileConfig, Scheduler
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched import prefix
from gie_tpu_torch.sched.hashing import chunk_hashes
from gie_tpu_torch.sched.kvevents import (
    ALL_CLEARED,
    BLOCK_REMOVED,
    BLOCK_STORED,
    KVEventAggregator,
    KVEventHTTPServer,
)

EMPTY = np.zeros((0,), np.uint32)
_ingest = jax.jit(jprefix.ingest_keys, static_argnames=("remove",))


@pytest.fixture(autouse=True)
def _deterministic_torch():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _hashes_for(prompt: bytes) -> np.ndarray:
    h, n = chunk_hashes(prompt)
    return np.asarray(h[:n], np.uint32)


def _assert_states(ref: dict, port: dict):
    assert set(ref) == set(port)
    for k in ("prefix_keys", "prefix_present", "prefix_ages", "rr", "tick"):
        assert port[k].dtype == np.uint32, k
        np.testing.assert_array_equal(port[k], np.asarray(ref[k]), err_msg=k)
    for k in ("assumed_load", "ot_v"):
        np.testing.assert_allclose(port[k], np.asarray(ref[k]), atol=1e-5,
                                   err_msg=k)


def _pair(**kw):
    return JaxScheduler(JaxProfileConfig(**kw)), Scheduler(
        ProfileConfig(**kw), device="cpu")


# -- ingest_keys ----------------------------------------------------------

def _table(seed, m=64):
    """A random table: half its rows hold a key (one that maps to its
    row), with random presence words and ages."""
    rng = np.random.default_rng(seed)
    s = C.PREFIX_SLOTS
    keys = (np.arange(s) + s * rng.integers(1, 2**32 // s, s)).astype(
        np.uint32)
    keys[rng.uniform(size=s) < 0.5] = 0
    present = rng.integers(0, 2**32, (s, m // 32), dtype=np.uint32)
    ages = rng.integers(0, 1000, s, dtype=np.uint32)
    return {"keys": keys, "present": present, "ages": ages}


def _batch(table, seed, n=512):
    """n hashes: keys the table holds (a removal matches them), hashes
    that collide on one row with each other and with a held key (same
    row, different values inside the batch), and padding zeros."""
    rng = np.random.default_rng(seed)
    s = C.PREFIX_SLOTS
    held = table["keys"][table["keys"] != 0]
    out = rng.integers(1, 2**32, n, dtype=np.uint32)
    out[: n // 4] = rng.choice(held, n // 4)
    rows = rng.integers(0, s, n // 8)
    for j, row in enumerate(rows):   # 3 lanes per row, values all differ
        base = n // 4 + 3 * j
        if base + 3 > n - n // 8:
            break
        out[base:base + 3] = (row + s * rng.choice(
            np.arange(1, 2**32 // s), 3, replace=False)).astype(np.uint32)
    out[rng.uniform(size=n) < 0.1] = 0
    rng.shuffle(out)
    return out


@pytest.mark.parametrize("remove", [False, True], ids=["stored", "removed"])
@pytest.mark.parametrize("seed, slot", [(0, 3), (1, 37), (2, 63)])
def test_ingest_keys_equals_reference(seed, slot, remove):
    arrays = _table(seed)
    hashes = _batch(arrays, seed + 10)
    tick = np.uint32(12345)
    ref = _ingest(
        JaxPrefixTable(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        jnp.asarray(hashes), jnp.int32(slot), jnp.uint32(tick),
        remove=remove)
    table = prefix.table_from_arrays(arrays, device="cpu")
    out = prefix.ingest_keys(
        table, torch.from_numpy(hashes.astype(np.int64)), slot,
        torch.tensor(int(tick)), remove=remove)
    assert out is table                       # in place
    port = prefix.snapshot_table(table)
    for k in ("keys", "present", "ages"):
        np.testing.assert_array_equal(port[k], np.asarray(getattr(ref, k)),
                                      err_msg=k)
    changed = (port["present"] != arrays["present"]).any(axis=1)
    assert changed.sum() > 50                  # the batch did real work


def test_ingest_lanes_leaves_its_scratch_as_it_found_it():
    arrays = _table(4)
    hashes = torch.from_numpy(_batch(arrays, 14).astype(np.int64))
    scratch = torch.full((2, C.PREFIX_SLOTS), -1, dtype=torch.int64)
    table = prefix.table_from_arrays(arrays, device="cpu")
    prefix.ingest_lanes(table, hashes, torch.full_like(hashes, 9),
                        torch.arange(len(hashes)) % 2 == 0, torch.tensor(3),
                        scratch)
    assert (scratch == -1).all()


# -- the Scheduler's fold -------------------------------------------------

def test_apply_prefix_events_large_batch_and_growth_equal_reference():
    """10,000 hashes fold in parts of 4096 (a later part's evictions see
    the table the earlier part left), removals after stores, and an event
    for slot 80 grows the state to M=256, as the reference's."""
    jsched, tsched = _pair()
    assert tsched.state.m == C.M_BUCKETS[0]
    rng = np.random.default_rng(0)
    hashes = rng.integers(1, 2**32, 10_000, dtype=np.uint32)
    removed = hashes[rng.uniform(size=10_000) < 0.3]
    for sched in (jsched, tsched):
        sched.apply_prefix_events(2, hashes, EMPTY)
        sched.apply_prefix_events(5, hashes[:3000], removed)
        sched.apply_prefix_events(80, np.asarray([7, 9], np.uint32),
                                  hashes[:100])
    assert tsched.state.m == 256
    _assert_states(jsched.export_state(), tsched.export_state())
    present = tsched.export_state()["prefix_present"]
    assert (present[:, 80 // 32] & np.uint32(1 << (80 % 32))).any()
    np.testing.assert_array_equal(tsched.prefix_hot_keys(),
                                  jsched.prefix_hot_keys())
    np.testing.assert_array_equal(tsched.prefix_hot_keys(64),
                                  jsched.prefix_hot_keys(64))
    assert tsched.prefix_hot_keys(0).shape == (0,)


def test_events_after_waves_stamp_the_ticks_tick():
    """Events between waves age at the tick the state has reached, and a
    following wave matches against what they stored."""
    jsched, tsched = _pair()
    eps = make_endpoints(6, queue=[0] * 6)
    prompt = b"EVENT DRIVEN SYSTEM PROMPT " * 30
    for w in range(2):
        reqs = make_requests(4, prompts=[b"warm %d " % w * 40] * 4)
        jsched.pick(reqs, eps)
        tsched.pick(convert.requests_from_numpy(reqs, device="cpu"),
                    convert.endpoints_from_numpy(eps, device="cpu"))
    for sched in (jsched, tsched):
        sched.apply_prefix_events(3, _hashes_for(prompt), EMPTY)
    _assert_states(jsched.export_state(), tsched.export_state())
    assert int(tsched.export_state()["tick"]) == 2
    res = tsched.pick(
        convert.requests_from_numpy(make_requests(4, prompts=[prompt] * 4),
                                    device="cpu"),
        convert.endpoints_from_numpy(eps, device="cpu"))
    assert (res.indices[:, 0] == 3).all()


def test_stored_events_create_affinity_without_any_pick():
    s = Scheduler(ProfileConfig(), device="cpu")
    prompt = b"EVENT DRIVEN SYSTEM PROMPT " * 30
    s.apply_prefix_events(3, _hashes_for(prompt), EMPTY)
    eps = convert.endpoints_from_numpy(make_endpoints(6, queue=[0] * 6),
                                       device="cpu")
    cols = s.explain(convert.requests_from_numpy(
        make_requests(1, prompts=[prompt]), device="cpu"), eps)
    assert cols["prefix"][0][3] == pytest.approx(1.0)
    assert cols["prefix"][0][[0, 1, 2, 4, 5]].max() == 0.0


def test_removed_events_clear_only_that_endpoint():
    jsched, tsched = _pair()
    h = _hashes_for(b"SHARED CACHED PREFIX " * 30)
    for sched in (jsched, tsched):
        sched.apply_prefix_events(1, h, EMPTY)
        sched.apply_prefix_events(2, h, EMPTY)
        sched.apply_prefix_events(1, EMPTY, h)
    _assert_states(jsched.export_state(), tsched.export_state())
    eps = convert.endpoints_from_numpy(make_endpoints(4), device="cpu")
    cols = tsched.explain(convert.requests_from_numpy(
        make_requests(1, prompts=[b"SHARED CACHED PREFIX " * 30]),
        device="cpu"), eps)
    assert cols["prefix"][0][1] == 0.0
    assert cols["prefix"][0][2] == pytest.approx(1.0)


# -- the journal over a digest install ------------------------------------

def _digest():
    """A leader's digest: one reference wave of shared prompts."""
    leader = JaxScheduler(JaxProfileConfig())
    eps = make_endpoints(8, queue=[2.0] * 8, kv=[0.2] * 8, m_slots=64)
    prompts = [b"SYS %d " % (i % 3) * 8 + b"user %d" % i for i in range(8)]
    leader.pick(make_requests(8, prompts=prompts, m_slots=64), eps)
    return leader.export_state()


def _bit(export: dict, h: int, slot: int) -> bool:
    keys, present = export["prefix_keys"], export["prefix_present"]
    row = int(h) & (keys.shape[0] - 1)
    if keys[row] != np.uint32(h):
        return False
    return bool((present[row, slot // 32] >> (slot % 32)) & 1)


def test_install_replays_local_events_newer_than_the_digest():
    digest = _digest()
    jsched, tsched = _pair()
    stored = np.asarray([0xA1B2C3D4, 0x00C0FFEE, 0x12345678], np.uint32)
    for sched in (jsched, tsched):
        assert sched.install_state(digest)
        sched.apply_prefix_events(3, stored, EMPTY)
        assert sched.install_state(digest)   # the same, older snapshot
    _assert_states(jsched.export_state(), tsched.export_state())
    assert all(_bit(tsched.export_state(), h, 3) for h in stored)
    for sched in (jsched, tsched):
        sched.apply_prefix_events(3, EMPTY, stored[:1])
        assert sched.install_state(digest)
    out = tsched.export_state()
    _assert_states(jsched.export_state(), out)
    assert not _bit(out, stored[0], 3) and _bit(out, stored[1], 3)


def test_install_journal_ttl_and_eviction_pruning():
    digest = _digest()
    # TTL: with the TTL forced to zero the journal never replays.
    jsched, tsched = _pair()
    for sched in (jsched, tsched):
        assert sched.install_state(digest)
        sched._KV_REPLAY_TTL_S = 0.0
        sched.apply_prefix_events(2, np.asarray([0xDEADBEEF], np.uint32),
                                  EMPTY)
        assert _bit(sched.export_state(), 0xDEADBEEF, 2)
    time.sleep(0.01)
    for sched in (jsched, tsched):
        assert sched.install_state(digest)
        assert not _bit(sched.export_state(), 0xDEADBEEF, 2)
    _assert_states(jsched.export_state(), tsched.export_state())
    # Eviction: PodDelete between the event and the next install.
    jsched, tsched = _pair()
    for sched in (jsched, tsched):
        assert sched.install_state(digest)
        sched.apply_prefix_events(5, np.asarray([0xBEEFCAFE], np.uint32),
                                  EMPTY)
        sched.evict_endpoint(5)
        assert sched.install_state(digest)
        assert not _bit(sched.export_state(), 0xBEEFCAFE, 5)
    _assert_states(jsched.export_state(), tsched.export_state())
    assert len(tsched._kv_journal) == 0


def test_install_replay_grows_the_installed_state():
    """A journaled event for a slot beyond the digest's bucket grows the
    installed state, as the reference's replay does."""
    digest = _digest()
    jsched, tsched = _pair()
    for sched in (jsched, tsched):
        sched.apply_prefix_events(300, np.asarray([11, 12], np.uint32), EMPTY)
        assert sched.install_state(digest)
    assert tsched.state.m == 512
    _assert_states(jsched.export_state(), tsched.export_state())


# -- the queued form (the card's) -----------------------------------------

def test_queued_calls_apply_as_the_calls_one_by_one():
    """On CUDA complete(), apply_prefix_events() and
    clear_prefix_endpoint() queue host arrays and the next locked section
    applies them in call order. Driven here on the CPU: the same mixed
    calls, queued, leave the state bit-equal to the calls one by one, and
    equal to the reference's."""
    digest = _digest()
    jsched, tsched = _pair()
    queued = Scheduler(ProfileConfig(), device="cpu")
    for sched in (jsched, tsched, queued):
        assert sched.install_state(digest)
    rng = np.random.default_rng(7)
    pool = rng.integers(1, 2**32, 600, dtype=np.uint32)
    for i in range(60):
        kind = ("complete", "events", "clear")[i % 3 if i % 7 else 1]
        if kind == "complete":
            slots = rng.integers(-2, 70, int(rng.integers(1, 4)))
            costs = rng.uniform(0, 0.5, len(slots)).astype(np.float32)
            jsched.complete(slots, costs)
            tsched.complete(slots, costs)
            queued._enqueue(("complete", slots.astype(np.int64), costs))
        elif kind == "events":
            slot = int(rng.integers(0, 8)) if i != 31 else 100  # grows
            stored = rng.choice(pool, int(rng.integers(0, 40)))
            removed = rng.choice(pool, int(rng.integers(0, 10)))
            jsched.apply_prefix_events(slot, stored, removed)
            tsched.apply_prefix_events(slot, stored, removed)
            queued._enqueue(("events", slot, stored, removed))
        else:
            slot = int(rng.integers(0, 8))
            jsched.clear_prefix_endpoint(slot)
            tsched.clear_prefix_endpoint(slot)
            queued._enqueue(("clear", slot))
    out = queued.export_state()
    assert queued._queued == []
    ref = tsched.export_state()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert queued.state.m == 256
    _assert_states(jsched.export_state(), out)


def test_queue_past_its_bound_is_applied_by_the_drainer():
    """With no wave to apply it, a queue past _QUEUE_MAX_LANES is applied
    under the lock by a thread of its own, in call order: the state ends
    bit-equal to the calls one by one, and the queue back within its
    bound with no locked access of the caller's."""
    direct = Scheduler(ProfileConfig(), device="cpu")
    queued = Scheduler(ProfileConfig(), device="cpu")
    queued._QUEUE_MAX_LANES = 100
    rng = np.random.default_rng(12)
    for i in range(40):
        slot = i % 8
        stored = rng.integers(1, 2**32, 16, dtype=np.uint32)
        slots = rng.integers(0, 8, 3)
        costs = rng.uniform(0, 0.5, 3).astype(np.float32)
        direct.apply_prefix_events(slot, stored, EMPTY)
        direct.complete(slots, costs)
        queued._enqueue(("events", slot, stored, EMPTY))
        queued._enqueue(("complete", slots, costs))
    deadline = time.monotonic() + 30
    while queued._drainer is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert queued._drainer is None
    assert queued._queued_lanes <= 100 and len(queued._queued) < 80
    out, ref = queued.export_state(), direct.export_state()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_drainer_failure_is_raised_by_the_next_locked_access(monkeypatch):
    """A drainer that fails leaves its error to the next locked access,
    which raises it; the access after that applies the queue again."""
    sched = Scheduler(ProfileConfig(), device="cpu")
    sched._QUEUE_MAX_LANES = 10
    boom = RuntimeError("fold failed")

    def failing_fold(calls):
        raise boom

    monkeypatch.setattr(sched, "_fold_events", failing_fold)
    sched._enqueue(("events", 3, np.arange(1, 21, dtype=np.uint32), EMPTY))
    deadline = time.monotonic() + 30
    while sched._drainer is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sched._drainer is None
    sched._enqueue(("complete", np.array([3]), np.array([0.5], np.float32)))
    with pytest.raises(RuntimeError, match="fold failed"):
        sched.snapshot_assumed_load()
    assert len(sched._queued) == 1
    sched.snapshot_assumed_load()
    assert sched._queued == [] and sched._queued_lanes == 0


def test_small_batches_fold_together_and_equal_reference(monkeypatch):
    """Many small queued batches (the aggregator's flushes) fold in a few
    groups of disjoint table rows, equal to the reference's calls one by
    one; batches that share a row with the open group start a new one."""
    jsched, tsched = _pair()
    folds = []
    ingest = prefix.ingest_lanes
    monkeypatch.setattr(prefix, "ingest_lanes",
                        lambda *a: folds.append(int(a[1].shape[0]))
                        or ingest(*a))
    rng = np.random.default_rng(11)
    calls = []
    for i in range(200):
        stored = rng.integers(1, 2**32, 16, dtype=np.uint32)
        removed = (calls[-1][1][:4] if calls and i % 5 == 0 else EMPTY)
        calls.append((i % 8, stored, removed))
    calls.append((3, calls[0][1], EMPTY))          # rows of call 0 again
    for call in calls:
        jsched.apply_prefix_events(*call)
        tsched._enqueue(("events",) + call)
    _assert_states(jsched.export_state(), tsched.export_state())
    # Every removal of the previous batch's rows opens a group (40 of
    # them); random collisions a few more.
    assert 40 <= len(folds) < len(calls) // 4 and max(folds) <= 4096


# -- the aggregator and its transport -------------------------------------

def test_aggregator_batches_resolves_and_flushes():
    s = Scheduler(ProfileConfig(), device="cpu")
    slots = {"10.0.0.1:8000": 0, "10.0.0.2:8000": 1}
    agg = KVEventAggregator(s, lambda hp: slots.get(hp), flush_every=10_000)
    prompt = b"AGGREGATED PREFIX " * 30
    h = [int(x) for x in _hashes_for(prompt)]
    agg.publish({"type": BLOCK_STORED, "endpoint": "10.0.0.1:8000",
                 "hashes": h})
    agg.publish({"type": BLOCK_STORED, "endpoint": "ghost:1", "hashes": h})
    assert agg.dropped == 1
    eps = convert.endpoints_from_numpy(make_endpoints(4), device="cpu")
    one = convert.requests_from_numpy(make_requests(1, prompts=[prompt]),
                                      device="cpu")
    assert s.explain(one, eps)["prefix"].max() == 0.0   # not flushed yet
    agg.flush()
    assert s.explain(one, eps)["prefix"][0][0] == pytest.approx(1.0)
    res = s.pick(convert.requests_from_numpy(
        make_requests(4, prompts=[prompt] * 4), device="cpu"), eps)
    assert (res.indices[:, 0] == 0).all()
    load_before = s.snapshot_assumed_load()
    assert load_before[0] > 0.0
    # AllBlocksCleared drops the presence column but keeps the load.
    agg.publish({"type": ALL_CLEARED, "endpoint": "10.0.0.1:8000"})
    assert s.explain(one, eps)["prefix"].max() == 0.0
    assert s.snapshot_assumed_load()[0] == pytest.approx(load_before[0])
    s.evict_endpoint(0)
    assert s.snapshot_assumed_load()[0] == 0.0


def test_aggregator_feeds_both_packages_alike():
    """The same event program through each package's aggregator: equal
    tables, flush_every crossings and AllBlocksCleared included."""
    from gie_tpu.sched.kvevents import KVEventAggregator as JaxAggregator

    jsched, tsched = _pair()
    slots = {f"10.0.0.{i}:8000": i for i in range(8)}
    aggs = [JaxAggregator(jsched, slots.get, flush_every=300),
            KVEventAggregator(tsched, slots.get, flush_every=300)]
    rng = np.random.default_rng(3)
    for i in range(80):
        hp = f"10.0.0.{int(rng.integers(0, 9))}:8000"   # 8 is unknown
        kind = (BLOCK_STORED, BLOCK_STORED, BLOCK_REMOVED)[i % 3]
        event = {"type": ALL_CLEARED if i % 29 == 28 else kind,
                 "endpoint": hp,
                 "hashes": rng.integers(0, 2**33, 20).tolist()}
        for agg in aggs:
            agg.publish(dict(event))
    for agg in aggs:
        agg.flush()
    assert (aggs[1].dropped, aggs[1].ingested) == (aggs[0].dropped,
                                                   aggs[0].ingested)
    _assert_states(jsched.export_state(), tsched.export_state())


def _post(port, body: bytes, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/events",
                                 data=body, method="POST",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


def test_http_transport_json_lines():
    s = Scheduler(ProfileConfig(), device="cpu")
    agg = KVEventAggregator(s, lambda hp: 5 if hp == "10.9.9.9:80" else None)
    server = KVEventHTTPServer(agg, port=0)
    try:
        prompt = b"HTTP PUSHED PREFIX " * 30
        h = [int(x) for x in _hashes_for(prompt)]
        lines = (json.dumps({"type": BLOCK_STORED, "endpoint": "10.9.9.9:80",
                             "hashes": h}) + "\nnot json at all\n[1, 2]\n"
                 + json.dumps({"type": BLOCK_REMOVED, "endpoint": "nope:1",
                               "hashes": [1]}))
        assert _post(server.port, lines.encode())["accepted"] == 2
        agg.flush()
        cols = s.explain(
            convert.requests_from_numpy(make_requests(1, prompts=[prompt]),
                                        device="cpu"),
            convert.endpoints_from_numpy(make_endpoints(8), device="cpu"))
        assert cols["prefix"][0][5] == pytest.approx(1.0)
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/other", data=b"", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 404
    finally:
        server.close()


def test_http_transport_auth_length_and_body_cap():
    import http.client

    s = Scheduler(ProfileConfig(), device="cpu")
    seen = []
    agg = KVEventAggregator(s, lambda hp: seen.append(hp) or 0)
    server = KVEventHTTPServer(agg, port=0, token="s3cret", max_body=256)
    line = json.dumps(
        {"type": BLOCK_STORED, "endpoint": "a:1", "hashes": [1]}).encode()
    try:
        for headers in ({}, {"Authorization": "Bearer wrong"}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server.port, line, headers)
            assert e.value.code == 401
        assert not seen
        auth = {"Authorization": "Bearer s3cret"}
        assert _post(server.port, line, auth)["accepted"] == 1
        assert seen == ["a:1"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.port, b"x" * 1024, auth)
        assert e.value.code == 413
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
        conn.putrequest("POST", "/events")
        conn.putheader("Authorization", "Bearer s3cret")
        conn.endheaders()
        assert conn.getresponse().status == 411
        conn.close()
    finally:
        server.close()


def test_listener_binds_loopback_by_default():
    server = KVEventHTTPServer(
        KVEventAggregator(Scheduler(ProfileConfig(), device="cpu"),
                          lambda hp: None), port=0)
    try:
        assert server._httpd.server_address[0] == "127.0.0.1"
    finally:
        server.close()


# -- the simulator stub's sink --------------------------------------------

def test_stub_sink_publishes_the_reference_events():
    from gie_tpu.simulator import StubConfig as JaxStubConfig
    from gie_tpu.simulator import VLLMStub as JaxStub

    from gie_tpu_torch.simulator import StubConfig, VLLMStub

    events = ([], [])
    stubs = (JaxStub(JaxStubConfig(prefix_cache_chunks=48), name="s"),
             VLLMStub(StubConfig(prefix_cache_chunks=48), name="s"))
    for stub, out in zip(stubs, events):
        stub.hostport = "10.0.0.7:8000"
        stub.event_sink = out.append
        for i in range(6):
            stub.submit(b"SYSTEM PROMPT %d " % (i % 2) * 200
                        + b"question %d" % i, 4.0)
        for _ in range(80):
            stub.step(0.05)
    assert events[0] and events[1] == events[0]
    assert {e["type"] for e in events[1]} == {BLOCK_STORED, BLOCK_REMOVED}
    assert max(len(e["hashes"]) for e in events[1]
               if e["type"] == BLOCK_STORED) == C.MAX_CHUNKS
