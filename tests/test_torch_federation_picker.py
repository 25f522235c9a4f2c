"""The port's picker with federation= against the reference's on the CPU.

Each package builds its own pick service (tests/test_torch_picker.py's
mix: 40 local pods, scraped rows from a seed, the tuned Sinkhorn profile
with the JAX scheduler's Gumbel draws replayed into the port) and its own
FederationState, which imports 8 endpoints of a peer cluster "west" from a
publisher of the same package. The link and the state read fixed clocks,
so the penalty rows are a function of the inputs alone. The same waves go
through each picker's _run_batch in a fixed order:

  local      locals unsaturated: nothing spills;
  spill      every local slot's scraped queue at the spill limit: every
             non-CRITICAL item gains the peer's endpoints, CRITICAL items
             stay home;
  drain      the cluster drains: every band's candidates become the peer's;
  held       drain on and the peer saturated too, so every non-CRITICAL
             item is held; the drain is lifted and the held items re-enter
             (the drain-replaced decision is undone and re-made), then the
             drain is raised again for a second re-entry.

Picks, fallbacks, charged slots and assumed costs, each item's fed_remote
and candidate slots, the gie_federation_spill_total counts and the flight
records are compared exactly, except the records' ranked scores: Sinkhorn
scores differ from JAX's by up to 2**ceil(log2 M) ulps (64 at M=64, the
lane tiebreak; tests/test_torch_slice.py) and the records round them to 5
decimals, so they are held within rtol 8e-6 (64 float32 ulps) plus atol
2e-5 (tests/test_torch_obs.py's rounding allowance). The scheduler state
is held within atol 1e-5 (tests/test_torch_slice.py's rule)."""

import numpy as np
import pytest

from gie_tpu.obs import recorder as r_recorder
from gie_tpu.runtime import metrics as r_metrics
from gie_tpu_torch.obs import recorder as p_recorder
from gie_tpu_torch.runtime import metrics as p_metrics
from gie_tpu_torch.sched import constants as C
from tests.test_torch_picker import (
    ADAPTERS,
    JAX,
    NOW,
    PODS,
    SEED,
    SIDES,
    _item_outcome,
    _request,
)
from tests.test_torch_obs import _split_ranked
from tests.test_torch_slice import _assert_states

PEERS = 8
QUEUE_LIMIT = 8.0
BAND_NAMES = ("critical", "standard", "sheddable")


class _FixedClock:
    """The PeerLink's clock: staleness reads 0 after each confirm."""

    def now(self):
        return NOW


def _fed_stack(side, hold=False):
    import importlib

    def mod(name):
        pkg = "gie_tpu" if side.jax else "gie_tpu_torch"
        return importlib.import_module(f"{pkg}.{name}")

    summary = mod("federation.summary")
    exchange = mod("federation.exchange")
    cfg, w = side.tuned_profile()
    import dataclasses

    cfg = dataclasses.replace(cfg, use_pallas_sinkhorn=True,
                              queue_limit=QUEUE_LIMIT)
    if side.jax:
        sched = side.Scheduler(cfg, w, seed=SEED)
    else:
        from tests.test_torch_slice import jax_noise_replay

        sched = side.Scheduler(cfg, w, device="cpu",
                               noise_source=jax_noise_replay(SEED))
    ms = side.MetricsStore(clock=lambda: NOW)
    ds = side.Datastore(on_slot_reclaimed=lambda s: (sched.evict_endpoint(s),
                                                     ms.remove(s)),
                        clock=lambda: NOW)
    ds.pool_set(side.EndpointPool({"app": "x"}, [8000], "default"))
    for i in range(PODS):
        ds.pod_update_or_add(side.Pod(name=f"p{i}", labels={"app": "x"},
                                      ip=f"10.9.0.{i + 1}"))
    registry = side.LoraRegistry()
    for name in ADAPTERS:
        registry.id_for(name)
    peer_rows = [(f"10.77.0.{i + 1}:8000", float(i % 4), 0.1 * (i % 5),
                  False) for i in range(PEERS)]
    pub = exchange.FederationPublisher({
        summary.META_SECTION: lambda: summary.encode_meta(
            pub.era, False, "west"),
        summary.LOAD_SECTION: lambda: summary.encode_load(
            list(peer_rows), max_endpoints=64),
    }, era_seq=1, era_token=7)
    pub.refresh()
    state = mod("federation.state").FederationState(
        ds, ms, scheduler=sched, cluster="east", penalty=2.0,
        spill_queue_limit=QUEUE_LIMIT, clock=lambda: NOW)
    link = exchange.PeerLink(
        "west", "mem://west", state.install_peer,
        fetch=lambda url, since, era, etag, wait_s: pub.serve(
            since=since, era=era, if_none_match=etag),
        wait_s=0.0, interval_s=0.0, clock=_FixedClock())
    state.register_peer("west", link)
    assert link.poll_once() == "installed"
    kw = dict(hold_max_s=30.0, hold_queue_limit=QUEUE_LIMIT) if hold else {}
    picker = side.Picker(sched, ds, ms, lora_registry=registry,
                         max_wait_s=0.0005, federation=state, **kw)
    return sched, ds, ms, state, picker, registry, peer_rows, pub


def _set_local_queues(side, ds, ms, registry, queue):
    rng = np.random.default_rng(SEED)
    rows = []
    for ep in ds.local_endpoints():
        q = float(rng.integers(0, 6)) if queue is None else queue
        rows.append((ep.slot, {C.Metric.QUEUE_DEPTH: q,
                               C.Metric.KV_CACHE_UTIL: float(
                                   rng.uniform(0, 0.9)),
                               C.Metric.MAX_LORA: 8.0},
                     [registry.id_for(ADAPTERS[j])
                      for j in rng.integers(0, 12, 2)], ()))
    ms.update_rows(rows, now=NOW)


def _spills(side):
    out = {}
    for band in BAND_NAMES:
        if side.jax:
            v = r_metrics.FED_SPILL.labels(peer="west", band=band)._value.get()
        else:
            v = p_metrics.FED_SPILL.value("west", band)
        out[band] = float(v)
    return out


def _items(side, ds, n, first=0):
    cands = ds.pick_candidates()
    return [side.Pending(_request(side, i), cands)
            for i in range(first, first + n)]


def _item_view(side, it):
    return (_item_outcome(side, it) if it.event.is_set() else ("held",),
            tuple(int(s) for s in it.fed_remote),
            tuple(int(s) for s in it.cand_slots))


def _set_peer_queues(state, peer_rows, pub, queue):
    peer_rows[:] = [(h, queue, k, d) for h, _, k, d in peer_rows]
    pub.refresh()
    assert state._peers["west"].link.poll_once() == "installed"


def _settle(picker, items, batch):
    """One _run_batch over `batch`; waits for every item it picked and
    returns the ones it held."""
    held = picker._run_batch(batch)
    for it in items:
        if not any(it is h for h in held):
            assert it.event.wait(60)
    return held


RECORD_FIELDS = ("outcome", "band", "tenant", "candidates", "fed_remote",
                 "chosen", "chosen_slot", "fallbacks", "ranked", "rung",
                 "excluded_drain", "excluded_breaker")


def _run(side, waves):
    """Drive the waves through one package's picker; returns what each
    wave came to, the spill counts moved and the flight records."""
    recorder_mod = r_recorder if side.jax else p_recorder
    obs_mod = __import__("gie_tpu.obs" if side.jax else "gie_tpu_torch.obs",
                         fromlist=["install"])
    rec = recorder_mod.FlightRecorder(4096)
    obs_mod.install(recorder=rec)
    stack = _fed_stack(side, hold=True)
    sched, ds, ms, state, picker, registry, peer_rows, pub = stack
    out = []
    try:
        spills0 = _spills(side)
        for kind, n in waves:
            if kind == "local":
                state.draining = False
                _set_local_queues(side, ds, ms, registry, None)
                items = _items(side, ds, n)
            elif kind == "spill":
                _set_local_queues(side, ds, ms, registry, QUEUE_LIMIT)
                items = _items(side, ds, n, first=100)
            elif kind == "drain":
                state.draining = True
                items = _items(side, ds, n, first=200)
            elif kind == "held":
                # The peer saturates too: every candidate set is full, so
                # the drain-replaced non-CRITICAL items are held.
                _set_peer_queues(state, peer_rows, pub, 50.0)
                state.draining = True
                items = _items(side, ds, n, first=300)
                held = _settle(picker, items, items)
                views = [(len(held), [_item_view(side, it) for it in items])]
                # Drain lifted, then raised again: each re-entry undoes
                # the last decision and makes the new one (still held).
                for flag in (False, True):
                    state.draining = flag
                    held = _settle(picker, items, held)
                    views.append((len(held),
                                  [_item_view(side, it) for it in items]))
                # The peer frees up: the held items are picked.
                _set_peer_queues(state, peer_rows, pub, 0.0)
                held = _settle(picker, items, held)
                views.append((len(held),
                              [_item_view(side, it) for it in items]))
                out.append((kind, views))
                continue
            assert picker._run_batch(items) == []
            assert all(it.event.wait(60) for it in items)
            out.append((kind, [_item_view(side, it) for it in items]))
        spills = {b: v - spills0[b] for b, v in _spills(side).items()}
        records = [{k: r.get(k) for k in RECORD_FIELDS}
                   for r in rec.snapshot()]
        return out, spills, records, sched.export_state()
    finally:
        picker.close()
        obs_mod.uninstall()


@pytest.mark.parametrize("waves", [
    [("local", 12), ("spill", 12)],
    [("spill", 16), ("drain", 12), ("local", 8)],
    [("spill", 8), ("held", 12)],
], ids=["local-then-spill", "spill-drain-local", "held-reentry"])
def test_fed_waves_equal_the_reference(waves):
    results = [_run(side, waves) for side in SIDES]
    (ref_out, ref_spills, ref_recs, ref_state), \
        (out, spills, recs, state) = results
    assert out == ref_out
    assert spills == ref_spills
    recs, slots, scores = _split_ranked(recs)
    ref_recs, ref_slots, ref_scores = _split_ranked(ref_recs)
    assert recs == ref_recs
    assert slots == ref_slots
    np.testing.assert_allclose(scores, ref_scores, rtol=8e-6, atol=2e-5)
    _assert_states(ref_state, state)
    # The properties themselves, read off the reference's run.
    peer_slots = set(range(PODS, PODS + PEERS))
    for entry in ref_out:
        if entry[0] == "local":
            assert all(v[0][0] == "ok" and not v[1] for v in entry[1])
        if entry[0] == "spill":
            for i, v in enumerate(entry[1]):
                band = _request(JAX, 100 + i).headers.get(
                    "x-gateway-inference-objective", [""])[0]
                assert bool(v[1]) == (band != "critical")
                assert set(v[1]) <= peer_slots
        if entry[0] == "drain":
            assert all(set(v[2]) <= peer_slots for v in entry[1])
    assert sum(ref_spills.values()) > 0
