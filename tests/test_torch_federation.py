"""The port's federation exchange and state against the reference's.

Every case runs once with the reference on both sides (gie_tpu publisher
and gie_tpu link, state and datastore) and again with the port on one
side or on both: the reference's publisher polled by a port PeerLink, a
port publisher polled by a reference PeerLink (over real loopback HTTP
where the reference's case uses it), and the port alone. Each run yields
a trace (poll outcomes, the link's counters, the imported endpoints and
their slots, the metrics rows the penalty writes); the traces must be
equal, integers and flags exactly and floats within 1e-5. The cases
mirror tests/test_federation.py: the sections' codec (frames byte for
byte), install then not-modified then delta, the long poll, era
regression and split-brain convergence, the era flip mid-delta, stale
and metaless frames, unknown sections, a corrupted-frame fuzz, the link
breaker, staleness and the local-only floor, the spill bands, the
capacity matrix and the prefix fold into each package's Scheduler. The
chaos scenarios fed-partition and fed-split-brain-heal replay through
both exchanges with the same seed and log the same faults. The runner
builds with --fed-*, serves /debugz/federation, and names the
gie_federation_* families as the reference does."""

from __future__ import annotations

import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

import gie_tpu.datastore as r_ds
import gie_tpu.datastore.objects as r_obj
import gie_tpu.federation.exchange as r_ex
import gie_tpu.federation.state as r_st
import gie_tpu.federation.summary as r_sum
import gie_tpu.metricsio as r_mio
import gie_tpu.replication.codec as r_codec
import gie_tpu.resilience.faults as r_faults
import gie_tpu.resilience.scenarios as r_scn
import gie_tpu.sched.constants as r_C
import gie_tpu_torch.datastore as p_ds
import gie_tpu_torch.datastore.objects as p_obj
import gie_tpu_torch.federation.exchange as p_ex
import gie_tpu_torch.federation.state as p_st
import gie_tpu_torch.federation.summary as p_sum
import gie_tpu_torch.metricsio as p_mio
import gie_tpu_torch.replication.codec as p_codec
import gie_tpu_torch.resilience.faults as p_faults
import gie_tpu_torch.resilience.scenarios as p_scn
import gie_tpu_torch.sched.constants as p_C

ATOL = 1e-5
T0 = 1000.0     # the metrics stores' fixed clock


def _pkg(ds, obj, ex, st, sm, mio, codec, faults, scn, C):
    return types.SimpleNamespace(
        Datastore=ds.Datastore, EndpointPool=obj.EndpointPool, Pod=obj.Pod,
        ex=ex, FederationState=st.FederationState, summary=sm,
        MetricsStore=mio.MetricsStore, codec=codec, faults=faults,
        scenarios=scn, C=C)


REF = _pkg(r_ds, r_obj, r_ex, r_st, r_sum, r_mio, r_codec, r_faults,
           r_scn, r_C)
PORT = _pkg(p_ds, p_obj, p_ex, p_st, p_sum, p_mio, p_codec, p_faults,
            p_scn, p_C)
# (publisher side, link side): the reference-only run is the expectation.
DIRECTIONS = {"ref->port": (REF, PORT), "port->ref": (PORT, REF),
              "port->port": (PORT, PORT)}


@pytest.fixture(autouse=True)
def _no_faults():
    for f in (r_faults, p_faults):
        f.uninstall()
    yield
    for f in (r_faults, p_faults):
        f.uninstall()


def make_datastore(P, local_pods=1):
    ds = P.Datastore()
    ds.pool_set(P.EndpointPool(selector={"app": "x"}, target_ports=[8000],
                               namespace="default"))
    for i in range(local_pods):
        ds.pod_update_or_add(
            P.Pod(name=f"l{i}", labels={"app": "x"}, ip=f"10.1.0.{i + 1}"))
    return ds


def make_peer_pub(P, endpoints=None, era=(1, 42), draining=False,
                  cluster="west"):
    eps = endpoints if endpoints is not None else [
        ("10.9.0.1:8000", 1.0, 0.1, False),
        ("10.9.0.2:8000", 2.0, 0.2, False),
    ]
    pub = P.ex.FederationPublisher({
        P.summary.META_SECTION: lambda: P.summary.encode_meta(
            pub.era, draining, cluster),
        P.summary.LOAD_SECTION: lambda: P.summary.encode_load(
            list(eps), max_endpoints=64),
    }, era_seq=era[0], era_token=era[1])
    pub.refresh()
    return pub, eps


def make_state(P, ds=None, **kw):
    ds = ds if ds is not None else make_datastore(P)
    store = P.MetricsStore(clock=lambda: T0)
    kw.setdefault("cluster", "east")
    kw.setdefault("penalty", 4.0)
    kw.setdefault("spill_queue_limit", 8.0)
    return P.FederationState(ds, store, **kw), ds, store


def make_link(L, pub, state, name="west", **kw):
    def fetch(url, since, era, etag, wait_s):
        return pub.serve(since=since, era=era, if_none_match=etag)

    kw.setdefault("wait_s", 0.0)
    kw.setdefault("interval_s", 0.0)
    link = L.ex.PeerLink(name, "mem://" + name, state.install_peer,
                         fetch=kw.pop("fetch", fetch), **kw)
    state.register_peer(name, link)
    return link


def remote(ds):
    return sorted((e.hostport, e.slot, e.cluster)
                  for e in ds.endpoints() if e.cluster)


def link_counts(link):
    return {k: getattr(link, k) for k in (
        "installed_era", "installed_epoch", "peer_epoch", "installs",
        "rejects", "fetch_errors", "era_flips", "era_regressions")}


def rows(store, ds, C):
    slots = sorted(e.slot for e in ds.endpoints() if e.cluster)
    if not slots:
        return []
    r, _ = store.pool_rows(slots)
    return np.asarray(r)[:, [int(C.Metric.QUEUE_DEPTH),
                             int(C.Metric.KV_CACHE_UTIL)]].tolist()


def assert_same(got, want, path="trace"):
    """Integers, strings and flags exactly; floats within ATOL."""
    if isinstance(want, float) or isinstance(got, float):
        assert got == pytest.approx(want, abs=ATOL), path
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def parity(case):
    """Run `case(P, L)` for every direction against the reference-only
    run; returns the reference's trace."""
    want = case(REF, REF)
    for name, (P, L) in DIRECTIONS.items():
        assert_same(case(P, L), want, name)
    return want


# -- the sections' codec ---------------------------------------------------


SECTIONS = [
    ("meta", lambda S: S.encode_meta((3, 0xDEAD), True, "east-1")),
    ("meta-long-name", lambda S: S.encode_meta((7, 2**63 - 1), False,
                                               "c" * 90)),
    ("load", lambda S: S.encode_load(
        [(f"10.0.{i}.{i + 1}:8000", float(i) * 0.5, 0.07 * i, i % 3 == 0)
         for i in range(12)], max_endpoints=64)),
    ("load-clipped", lambda S: S.encode_load(
        [(f"10.0.0.{i}:{8000 + i}", float(9 - i), 0.1, False)
         for i in range(10)], max_endpoints=4)),
    ("prefix", lambda S: S.encode_prefix(
        np.random.default_rng(3).integers(0, 2**32, 64, dtype=np.uint64)
        .astype(np.uint32), max_keys=40)),
]


@pytest.mark.parametrize("name, make", SECTIONS,
                         ids=[n for n, _ in SECTIONS])
def test_section_frames_are_byte_equal(name, make):
    ref = r_codec.encode_digest(5, {name: make(r_sum)})
    port = p_codec.encode_digest(5, {name: make(p_sum)})
    assert port == ref
    # Each package decodes the other's frame into the same section.
    for codec, blob in ((p_codec, ref), (r_codec, port)):
        d = codec.decode_digest(blob)
        assert d.epoch == 5 and set(d.sections) == {name}


def test_prefix_section_from_int64_carriers():
    """The port carries u32 as int64: its prefix section converts at the
    boundary, so the frame equals the reference's from uint32 keys."""
    keys = np.random.default_rng(4).integers(0, 2**32, 50, dtype=np.uint64)
    keys[[3, 9]] = 0
    ref = r_codec.encode_section(r_sum.encode_prefix(
        keys.astype(np.uint32), max_keys=45))
    port = p_codec.encode_section(p_sum.encode_prefix(
        keys.astype(np.int64), max_keys=45))
    assert port == ref


def test_decoders_agree_on_good_and_malformed_sections():
    cases = [
        ("meta", lambda S: S.encode_meta((2, 9), False, "west")),
        ("meta", lambda S: {}),
        ("meta", lambda S: {"era": np.zeros(3, np.uint64),
                            "draining": np.uint8(0)}),
        ("load", lambda S: S.encode_load(
            [("not-a-hostport", 1.0, 0.0, False),
             ("10.0.0.1:8000", float("nan"), 0.0, False),
             ("10.0.0.2:0", 1.0, 0.0, False),
             ("10.0.0.3:8000", -2.0, 1.5, True)], max_endpoints=8)),
        ("load", lambda S: {"hostports": np.zeros((2, 8), np.uint8),
                            "queue": np.zeros(1, np.float32),
                            "kv": np.zeros(2, np.float32),
                            "draining": np.zeros(2, np.uint8)}),
        ("prefix", lambda S: S.encode_prefix(
            np.asarray([0, 7, 9, 0, 11], np.uint32), max_keys=2)),
        ("prefix", lambda S: {"nokeys": np.zeros(1)}),
    ]
    for kind, make in cases:
        out = []
        for S in (r_sum, p_sum):
            arrays = make(S)
            dec = getattr(S, f"decode_{kind}")(arrays)
            if isinstance(dec, np.ndarray):
                dec = dec.tolist()
            elif isinstance(dec, list):
                dec = [(e.hostport, e.queue_depth, e.kv_util, e.draining)
                       for e in dec]
            elif dec is not None:
                dec = (dec.era, dec.draining, dec.cluster)
            out.append(dec)
        assert out[1] == out[0], kind


# -- the exchange ----------------------------------------------------------


def test_install_then_not_modified_then_delta():
    def case(P, L):
        frames = []
        pub, eps = make_peer_pub(P)
        state, ds, store = make_state(L)

        def fetch(url, since, era, etag, wait_s):
            status, headers, body = pub.serve(
                since=since, era=era, if_none_match=etag)
            if status == 200:
                d = L.codec.decode_digest(body)
                frames.append((d.delta, sorted(d.sections)))
            return status, headers, body

        link = make_link(L, pub, state, fetch=fetch)
        out = [link.poll_once(), link.poll_once()]
        eps.append(("10.9.0.3:8000", 0.0, 0.0, False))
        pub.refresh()
        out.append(link.poll_once())
        return {"out": out, "frames": frames, "link": link_counts(link),
                "remote": remote(ds), "rows": rows(store, ds, L.C)}

    want = parity(case)
    assert want["out"] == ["installed", "not_modified", "installed"]
    assert want["frames"][1] == (True, ["fed.load"])


def test_installs_over_real_http_in_both_directions():
    """A link of one package long-polls the other package's
    FederationHTTPServer: the first poll installs, the next parks on the
    server and wakes on the publisher's refresh before its window."""
    def case(P, L):
        pub, eps = make_peer_pub(P)
        srv = P.ex.FederationHTTPServer(pub, 0)
        try:
            state, ds, store = make_state(L)
            link = L.ex.PeerLink("west", f"http://127.0.0.1:{srv.port}",
                                 state.install_peer, wait_s=2.0,
                                 interval_s=0.0)
            state.register_peer("west", link)
            out = [link.poll_once()]
            eps.append(("10.9.0.4:8000", 0.0, 0.0, False))

            def bump():
                time.sleep(0.1)
                pub.refresh()

            t = threading.Thread(target=bump)
            t.start()
            t0 = time.monotonic()
            out.append(link.poll_once())
            woke = time.monotonic() - t0 < 1.5
            t.join()
            # Unchanged state: a short window expires back to 304.
            link.wait_s = 0.05
            out.append(link.poll_once())
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/federation/status",
                    timeout=10) as r:
                status = json.loads(r.read())
        finally:
            srv.close()
        return {"out": out, "woke": woke, "link": link_counts(link),
                "remote": remote(ds), "rows": rows(store, ds, L.C),
                "era_pair": status["era_pair"]}

    want = parity(case)
    assert want["out"] == ["installed", "installed", "not_modified"]
    assert want["woke"] is True


def test_era_regression_rejected_and_state_kept():
    def case(P, L):
        pub_new, _ = make_peer_pub(P, era=(2, 50))
        pub_old, _ = make_peer_pub(
            P, endpoints=[("10.9.9.9:8000", 0.0, 0.0, False)], era=(1, 99))
        state, ds, _ = make_state(L)
        link = make_link(L, pub_new, state)
        out = [link.poll_once()]
        link._fetch = lambda *a: pub_old.serve()
        out.append(link.poll_once())
        return {"out": out, "link": link_counts(link), "remote": remote(ds)}

    want = parity(case)
    assert want["out"] == ["installed", "era_regression"]


@pytest.mark.parametrize("zombie_first", [True, False])
def test_split_brain_interleave_converges_on_max_era(zombie_first):
    def case(P, L):
        pub_a, _ = make_peer_pub(
            P, endpoints=[("10.9.1.1:8000", 0.0, 0.0, False)], era=(1, 10))
        pub_b, _ = make_peer_pub(
            P, endpoints=[("10.9.2.1:8000", 0.0, 0.0, False)], era=(2, 7))
        state, ds, _ = make_state(L)
        order = [pub_a, pub_b] if zombie_first else [pub_b, pub_a]
        calls = {"n": 0}

        def fetch(url, since, era, etag, wait_s):
            pub = order[calls["n"] % 2]
            calls["n"] += 1
            return pub.serve()

        link = make_link(L, pub_a, state, fetch=fetch)
        out = [link.poll_once() for _ in range(6)]
        return {"out": out, "link": link_counts(link), "remote": remote(ds)}

    want = parity(case)
    assert want["link"]["installed_era"] == (2, 7)
    assert [r[0] for r in want["remote"]] == ["10.9.2.1:8000"]


def test_era_flip_mid_delta_forces_full_snapshot():
    def case(P, L):
        pub, eps = make_peer_pub(P, era=(1, 5))
        state, ds, _ = make_state(L)
        link = make_link(L, pub, state)
        out = [link.poll_once()]
        pub.era = (1, 5)
        pub.bump_era(seq=2)
        eps.append(("10.9.0.7:8000", 0.0, 0.0, False))
        pub.refresh()
        out.append(link.poll_once())
        counts = link_counts(link)
        counts["installed_era"] = counts["installed_era"][0]  # fresh token
        return {"out": out, "link": counts, "remote": remote(ds)}

    want = parity(case)
    assert want["link"]["era_flips"] == 1


def test_stale_epoch_replay_and_metaless_snapshot_rejected():
    def case(P, L):
        pub, _ = make_peer_pub(P)
        state, _, _ = make_state(L)
        replay = {}

        def fetch(url, since, era, etag, wait_s):
            replay.setdefault("frame", pub.serve())
            return replay["frame"]

        link = make_link(L, pub, state, fetch=fetch)
        out = [link.poll_once(), link.poll_once()]
        blob = P.codec.encode_digest(1, {
            P.summary.LOAD_SECTION: {
                "hostports": np.zeros((0, 8), np.uint8),
                "queue": np.zeros(0, np.float32),
                "kv": np.zeros(0, np.float32),
                "draining": np.zeros(0, np.uint8)}})
        bare = L.ex.PeerLink("west", "mem://x", state.install_peer,
                             fetch=lambda *a: (200, {}, blob),
                             wait_s=0.0, interval_s=0.0)
        out.append(bare.poll_once())
        return {"out": out, "link": link_counts(link)}

    want = parity(case)
    assert want["out"] == ["installed", "stale_epoch", "rejected"]


def test_unknown_sections_and_arrays_skip_unknown():
    def case(P, L):
        state, ds, store = make_state(L)
        load = P.summary.encode_load(
            [("10.9.0.1:8000", 1.0, 0.1, False)], max_endpoints=8)
        load["future_column"] = np.ones(1, np.float32)
        blob = P.codec.encode_digest(1, {
            P.summary.META_SECTION: P.summary.encode_meta(
                (1, 1), False, "west"),
            P.summary.LOAD_SECTION: load,
            "fed.future-section": {"x": np.arange(4, dtype=np.uint32)},
        })
        link = L.ex.PeerLink("west", "mem://x", state.install_peer,
                             fetch=lambda *a: (200, {}, blob),
                             wait_s=0.0, interval_s=0.0)
        state.register_peer("west", link)
        return {"out": link.poll_once(), "remote": remote(ds),
                "rows": rows(store, ds, L.C)}

    assert parity(case)["out"] == "installed"


def test_corrupted_frames_reject_and_keep_state():
    def case(P, L):
        pub, _ = make_peer_pub(P)
        state, ds, _ = make_state(L)
        link = make_link(L, pub, state)
        out = [link.poll_once()]
        baseline = remote(ds)
        _, headers, body = pub.serve()
        rng = np.random.default_rng(7)
        for _ in range(48):
            i = int(rng.integers(len(body)))
            flipped = bytearray(body)
            flipped[i] ^= 1 << int(rng.integers(8))
            link._fetch = (lambda *a, b=bytes(flipped):
                           (200, dict(headers), b))
            link._next_poll = 0.0
            link._fail_streak = 0
            link._open_until = 0.0
            out.append(link.poll_once())
            assert remote(ds) == baseline
        return {"out": out, "link": link_counts(link)}

    want = parity(case)
    assert "corrupt" in want["out"]


def test_link_breaker_opens_and_half_open_probe_recovers():
    def case(P, L):
        pub, _ = make_peer_pub(P)
        state, ds, _ = make_state(L)
        broken = {"on": True}

        def fetch(url, since, era, etag, wait_s):
            if broken["on"]:
                raise ConnectionError("severed")
            return pub.serve(since=since, era=era, if_none_match=etag)

        link = make_link(L, pub, state, fetch=fetch, open_after=3,
                         open_s=30.0, seed=3)
        now = time.monotonic()
        out = []
        for _ in range(3):
            link._next_poll = 0.0
            out.append(link.poll_once(now))
        opened = link.breaker_open()
        link._next_poll = 0.0
        out += [link.poll_once(), link.poll_once()]
        link._open_until = 0.0
        link._next_poll = 0.0
        out.append(link.poll_once())
        reopened = link.breaker_open()
        broken["on"] = False
        link._open_until = 0.0
        link._next_poll = 0.0
        out.append(link.poll_once())
        return {"out": out, "opened": opened, "reopened": reopened,
                "closed": not link.breaker_open(),
                "link": link_counts(link), "remote": remote(ds)}

    want = parity(case)
    assert want["out"][3:5] == ["breaker_open", None]
    assert want["opened"] and want["reopened"] and want["closed"]


def test_fault_points_peer_publish_and_corrupt():
    """peer.publish on the serving side: an ERROR is a 503 (fetch error),
    a CORRUPT frame is caught by the codec's CRC on the polling side."""
    def case(P, L):
        pub, _ = make_peer_pub(P)
        state, ds, _ = make_state(L)
        link = make_link(L, pub, state)
        P.faults.install(P.faults.FaultInjector(
            3, {"peer.publish": P.faults.FaultRule(p_error=1.0,
                                                   max_fires=1)}))
        try:
            out = [link.poll_once()]
            link._next_poll = 0.0
            out.append(link.poll_once())
            P.faults.install(P.faults.FaultInjector(
                4, {"peer.publish": P.faults.FaultRule(
                    p_corrupt=1.0, max_fires=1)}))
            link.last_etag = None
            link._want_full = True
            link._next_poll = 0.0
            out.append(link.poll_once())
            fired = dict(P.faults.installed().fired)
        finally:
            P.faults.uninstall()
        return {"out": out, "fired": fired, "link": link_counts(link),
                "remote": remote(ds)}

    assert parity(case)["out"] == ["fetch_error", "installed", "corrupt"]


def test_fault_points_peer_poll_and_partition_scoped_by_key():
    """peer.partition keyed to one peer severs that link only; peer.poll
    is the flaky-link point. Both fire on the polling side."""
    def case(P, L):
        state, _, _ = make_state(L)
        link_w = make_link(L, make_peer_pub(P)[0], state, name="west")
        state2, _, _ = make_state(L, ds=make_datastore(L))
        link_n = make_link(L, make_peer_pub(P, cluster="north")[0], state2,
                           name="north")
        L.faults.install(L.faults.FaultInjector(5, {
            "peer.partition": L.faults.FaultRule(p_error=1.0,
                                                 keys=("west",)),
            "peer.poll": L.faults.FaultRule(p_error=0.0)}))
        try:
            out = [link_w.poll_once(), link_n.poll_once()]
            L.faults.install(L.faults.FaultInjector(6, {
                "peer.poll": L.faults.FaultRule(p_error=1.0,
                                                max_fires=1)}))
            link_w._fail_streak = 0
            link_w._open_until = 0.0
            link_w._next_poll = 0.0
            out.append(link_w.poll_once())
            log = list(L.faults.installed().log)
        finally:
            L.faults.uninstall()
        return {"out": out, "log": log}

    assert parity(case)["out"] == ["fetch_error", "installed",
                                   "fetch_error"]


# -- FederationState -------------------------------------------------------


def test_staleness_local_only_hysteresis_and_penalty_inflation():
    def case(P, L):
        pub, _ = make_peer_pub(P)
        clock = {"t": 1000.0}
        state, ds, store = make_state(L, stale_inflate_s=1.0,
                                      local_only_after_s=2.0,
                                      clock=lambda: clock["t"])
        link = make_link(L, pub, state)
        trace = [link.poll_once(), rows(store, ds, L.C)]
        view = state._peers["west"]
        for stale in (1.5, 0.5, 2.5, 5.0, 1.5, 0.9):
            # A frozen staleness reading per tick (the link's own clock
            # keeps running between ticks).
            link.staleness_s = lambda now=None, s=stale: s
            clock["t"] += 10.0
            state.observe()
            trace.append((stale, view.local_only, view.local_only_spells,
                          rows(store, ds, L.C),
                          state.spill_candidates(
                              int(L.C.Criticality.STANDARD),
                              np.asarray([0]), np.full(64, 99.0))
                          is not None))
        return trace

    want = parity(case)
    assert [t[1] for t in want[2:]] == [False, False, True, True, True,
                                        False]


BANDS = ("CRITICAL", "STANDARD", "SHEDDABLE")


def test_spill_candidates_in_every_band():
    def case(P, L):
        out = []
        for peer_draining in (False, True):
            for drain in (False, True):
                state, ds, _ = make_state(L, ds=make_datastore(L, 2))
                pub, _ = make_peer_pub(
                    P, draining=peer_draining,
                    endpoints=[("10.9.0.1:8000", 1.0, 0.1, False),
                               ("10.9.0.2:8000", 2.0, 0.2, True),
                               ("10.9.0.3:8000", 0.0, 0.0, False)])
                assert make_link(L, pub, state).poll_once() == "installed"
                state.draining = drain
                for band in BANDS:
                    b = int(getattr(L.C.Criticality, band))
                    for local in ([0, 1], [1], [], [0, 99]):
                        for q in (0.0, 7.9, 8.0, 99.0):
                            queues = np.full(64, q)
                            queues[0] = 0.0 if q == 7.9 else q
                            got = state.spill_candidates(
                                b, np.asarray(local, np.int64), queues)
                            out.append(None if got is None else sorted(
                                (e.hostport, e.slot) for e in got))
        return out

    want = parity(case)
    assert any(w is None for w in want) and any(w for w in want)


def test_capacity_matrix_and_exported_metrics():
    from gie_tpu.runtime import metrics as r_metrics
    from gie_tpu_torch.runtime import metrics as p_metrics

    def case(P, L):
        state, ds, store = make_state(L, ds=make_datastore(L, 3))
        slots = [e.slot for e in ds.local_endpoints()]
        store.update_rows([(s, {int(L.C.Metric.QUEUE_DEPTH): 1.5 * s,
                                int(L.C.Metric.KV_CACHE_UTIL): 0.25},
                            (), ()) for s in slots], now=T0)
        link = make_link(L, make_peer_pub(P)[0], state)
        link.poll_once()
        link.staleness_s = lambda now=None: 0.75
        state.draining = True
        state.export_metrics()
        m = r_metrics if L is REF else p_metrics
        if L is REF:
            def gauge(g, **kw):
                return (g.labels(**kw) if kw else g)._value.get()
        else:
            def gauge(g, **kw):
                return g.value(*kw.values())
        metrics = [gauge(m.FED_PEERS), gauge(m.FED_DRAINING)] + [
            gauge(getattr(m, n), peer="west") for n in (
                "FED_REMOTE_ENDPOINTS", "FED_STALENESS", "FED_LOCAL_ONLY",
                "FED_PENALTY")]
        return {"matrix": state.capacity_matrix(), "metrics": metrics,
                "local_rows": state.local_load_rows()}

    want = parity(case)
    assert want["matrix"]["west"]["endpoints"] == 2


def test_prefix_fold_into_each_schedulers_table():
    """Peer hot-prefix keys fold (as diffs) into each package's own
    Scheduler against every imported slot; the prefix tables equal."""
    from gie_tpu.sched import ProfileConfig as RefProfile
    from gie_tpu.sched import Scheduler as RefScheduler
    from gie_tpu_torch.sched import ProfileConfig, Scheduler

    rng = np.random.default_rng(11)
    first = rng.integers(1, 2**32, 300, dtype=np.uint64).astype(np.uint32)
    second = np.concatenate([first[100:], rng.integers(
        1, 2**32, 80, dtype=np.uint64).astype(np.uint32)])

    def case(P, L):
        sched = (RefScheduler(RefProfile()) if L is REF
                 else Scheduler(ProfileConfig(), device="cpu"))
        state, ds, _ = make_state(L, scheduler=sched, max_prefix_fold=256)
        make_link(L, make_peer_pub(P)[0], state).poll_once()
        for keys in (first, second):
            assert state.install_peer("west", {
                P.summary.PREFIX_SECTION: P.summary.encode_prefix(
                    keys, max_keys=4096)}, delta=True)
        export = sched.export_state()
        return {k: np.asarray(export[k]).tolist() for k in (
            "prefix_keys", "prefix_present")}

    want = parity(case)
    assert any(any(r) for r in want["prefix_present"])


# -- chaos scenarios -------------------------------------------------------


def _fed_fixture(P, L, local_only_after_s=0.25):
    ds = make_datastore(L)
    state = L.FederationState(
        ds, L.MetricsStore(clock=lambda: T0), cluster="east", penalty=2.0,
        stale_inflate_s=0.1, local_only_after_s=local_only_after_s,
        spill_queue_limit=8.0)
    pub = P.ex.FederationPublisher({
        P.summary.META_SECTION: lambda: P.summary.encode_meta(
            pub.era, False, "west"),
        P.summary.LOAD_SECTION: lambda: P.summary.encode_load(
            [("10.9.0.1:8000", 1.0, 0.1, False)], max_endpoints=8),
    }, era_seq=1, era_token=9)
    pub.refresh()
    link = L.ex.PeerLink(
        "west", "mem://west", state.install_peer,
        fetch=lambda url, since, era, etag, wait_s: pub.serve(
            since=since, era=era, if_none_match=etag),
        wait_s=0.0, interval_s=0.0, open_after=3, open_s=0.05)
    state.register_peer("west", link)
    return state, ds, link


def test_fed_partition_fault_log_equals_the_reference():
    def case(P, L):
        scn = L.scenarios.load("fed-partition")
        drive = scn.drive["federation"]
        state, ds, link = _fed_fixture(
            P, L, local_only_after_s=float(drive["local_only_after_s"]))
        inj = scn.arm()
        try:
            out = [link.poll_once()]
            for _ in range(int(drive["poll_rounds"])):
                link._next_poll = 0.0
                link._open_until = min(link._open_until, time.monotonic())
                link.poll_once()
                state._last_refresh = 0.0
                state.observe()
                time.sleep(float(drive["round_sleep_s"]))
            out.append(state._peers["west"].local_only)
        finally:
            L.faults.uninstall()
        return {"log": list(inj.log), "fired": dict(inj.fired),
                "fetch_errors": link.fetch_errors, "final": out,
                "remote": remote(ds)}

    want = parity(case)
    assert want["fired"].get("peer.partition", 0) == 40
    assert want["final"] == ["installed", False]


def test_fed_split_brain_heal_fault_log_equals_the_reference():
    def case(P, L):
        scn = L.scenarios.load("fed-split-brain-heal")
        drive = scn.drive["federation"]
        state, ds, link = _fed_fixture(P, L)
        pub_old = P.ex.FederationPublisher({
            P.summary.META_SECTION: lambda: P.summary.encode_meta(
                pub_old.era, False, "west"),
            P.summary.LOAD_SECTION: lambda: P.summary.encode_load(
                [("10.9.0.1:8000", 1.0, 0.1, False)], max_endpoints=8),
        }, era_seq=1, era_token=9)
        pub_new = P.ex.FederationPublisher({
            P.summary.META_SECTION: lambda: P.summary.encode_meta(
                pub_new.era, False, "west"),
            P.summary.LOAD_SECTION: lambda: P.summary.encode_load(
                [("10.9.2.1:8000", 0.5, 0.0, False)], max_endpoints=8),
        }, era_seq=2, era_token=3)
        pub_old.refresh()
        pub_new.refresh()
        flip = {"n": 0}

        def fetch(url, since, era, etag, wait_s):
            flip["n"] += 1
            return (pub_old if flip["n"] % 2 == 0 else pub_new).serve()

        link._fetch = fetch
        inj = scn.arm()
        seen = []
        try:
            for _ in range(int(drive["poll_rounds"])):
                link._next_poll = 0.0
                link._fail_streak = 0
                link._open_until = 0.0
                seen.append((link.poll_once(), remote(ds)))
        finally:
            L.faults.uninstall()
        return {"log": list(inj.log), "fired": dict(inj.fired),
                "seen": seen, "link": link_counts(link)}

    want = parity(case)
    assert want["link"]["installed_era"] == (2, 3)
    assert want["link"]["era_regressions"] > 0
    assert want["fired"].get("peer.poll", 0) > 0


# -- the runner ------------------------------------------------------------


def test_fed_metric_families_equal_the_reference():
    from gie_tpu.runtime import metrics as r_metrics
    from gie_tpu_torch.runtime import metrics as p_metrics

    names = ("FED_PEERS", "FED_REMOTE_ENDPOINTS", "FED_STALENESS",
             "FED_LOCAL_ONLY", "FED_PENALTY", "FED_SYNCS", "FED_SPILL",
             "FED_ERA_FLIPS", "FED_DRAINING")
    for n in names:
        r, p = getattr(r_metrics, n), getattr(p_metrics, n)
        # prometheus_client keeps a counter's name without "_total".
        assert p.name.removesuffix("_total") == r._name, n
        assert p.labelnames == tuple(r._labelnames), n
        assert p.documentation == r._documentation, n
        assert type(p).__name__ == type(r).__name__, n


def test_runner_serves_the_federation_page(tmp_path):
    """A port runner built with --fed-* polls a reference cluster's
    exchange, imports its endpoints into the slot space, and serves
    /debugz/federation (peer link and capacity matrix) and the
    gie_federation_* families."""
    from gie_tpu_torch.controller import FakeCluster
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner
    from gie_tpu_torch.sched import Scheduler
    from tests.test_torch_extproc import _free_port, _parse

    pub, _ = make_peer_pub(REF)
    srv = r_ex.FederationHTTPServer(pub, 0)
    fed_port = _free_port()
    opts = _parse("gie_tpu_torch", [
        "--pool-name", "p", "--no-resilience", "--no-obs",
        "--insecure-serving",
        "--grpc-port", str(_free_port()),
        "--grpc-health-port", str(_free_port()),
        "--metrics-port", str(_free_port()),
        "--fed-cluster", "east", "--fed-port", str(fed_port),
        "--fed-peer", f"west=http://127.0.0.1:{srv.port}",
        "--fed-interval-s", "0.1", "--fed-wait-s", "0.5"])
    runner = ExtProcServerRunner(opts, FakeCluster(),
                                 scheduler=Scheduler(device="cpu"))
    try:
        assert runner.picker.federation is runner.federation
        runner.fed_exchange.start()
        link = runner.fed_exchange.links["west"]
        deadline = time.monotonic() + 10
        while link.installs < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert link.installs >= 1
        imported = [e for e in runner.datastore.endpoints() if e.cluster]
        assert sorted(e.hostport for e in imported) == [
            "10.9.0.1:8000", "10.9.0.2:8000"]
        # Imports are no local pods: neither in local_endpoints() (the
        # scrape engine's view) nor exported back to peers.
        assert runner.datastore.local_endpoints() == []
        assert runner.federation.local_load_rows() == []
        page = runner._debugz_providers()["federation"]({})
        assert page["cluster"] == "east"
        assert page["peers"]["west"]["installed_era"] == [1, 42]
        assert page["matrix"]["west"]["endpoints"] == 2
        # This cluster's own exchange serves a reference link once its
        # refresh loop has published a first snapshot.
        pub_east = runner.fed_exchange.publisher
        deadline = time.monotonic() + 10
        while pub_east.epoch < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert pub_east.epoch >= 1
        state, ds, _ = make_state(REF, ds=make_datastore(REF, 0))
        ref_link = r_ex.PeerLink("east", f"http://127.0.0.1:{fed_port}",
                                 state.install_peer, wait_s=0.0)
        state.register_peer("east", ref_link)
        assert ref_link.poll_once() == "installed"
        runner.federation.export_metrics()
        assert own_metrics.FED_REMOTE_ENDPOINTS.value("west") == 2.0
        text = own_metrics.generate_latest().decode()
        assert 'gie_federation_remote_endpoints{peer="west"} 2' in text
    finally:
        runner.stop()
        srv.close()
