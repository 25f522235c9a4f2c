"""Stage-by-stage parity of gie_tpu_torch against the JAX reference on the
CPU: filters, scorers, the prefix index (match, insert with same-wave
collisions, clear, snapshot) and the pickers.

Tolerances: integer and bool outputs exact; float columns within
atol=1e-6 (in practice bit-equal: the same f32 ops in the same order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gie_tpu.sched import filters as jfilters
from gie_tpu.sched import hashing as jhashing
from gie_tpu.sched import pickers as jpickers
from gie_tpu.sched import prefix as jprefix
from gie_tpu.sched import scorers as jscorers
from gie_tpu.sched import types as jtypes
from gie_tpu.sched.types import PrefixTable as JaxPrefixTable
from gie_tpu.utils.testing import make_endpoints, make_requests

from gie_tpu_torch import convert
from gie_tpu_torch.sched import filters, hashing, pickers, prefix, scorers
from gie_tpu_torch.sched import types
from gie_tpu_torch.sched.types import PrefixTable
from gie_tpu_torch.utils import testing as ttesting

CPU = "cpu"
BASE = b"SYSTEM: You are a helpful assistant specialised in task %d. "


@pytest.fixture(autouse=True)
def _deterministic_torch():
    """Parity runs with torch's deterministic algorithms on."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _inputs(n, m_live, m, seed, *, shared=4, lora_slots=True):
    """Seeded (JAX reqs, JAX eps) with shared system prompts, LoRA ids,
    criticality bands and a few strict subsets."""
    rng = np.random.default_rng(seed)
    active = [rng.integers(-1, 6, 3).tolist() for _ in range(m_live)]
    waiting = [rng.integers(-1, 6, 2).tolist() for _ in range(m_live)]
    eps = make_endpoints(
        m_live,
        queue=rng.integers(0, 160, m_live).tolist(),
        kv=rng.uniform(0, 1.0, m_live).tolist(),
        max_lora=4,
        lora_active=active if lora_slots else None,
        lora_waiting=waiting if lora_slots else None,
        m_slots=m,
    )
    prompts = [(BASE % (i % shared)) * int(rng.integers(1, 9))
               + b"user %d" % i for i in range(n)]
    subset = [None] * n
    subset[1] = [0, 1, 2]
    subset[2] = []
    reqs = make_requests(
        n, prompts=prompts, lora_id=rng.integers(-1, 6, n).tolist(),
        criticality=rng.integers(0, 3, n).tolist(), subset=subset, m_slots=m)
    return reqs, eps


def _port(reqs, eps):
    return (convert.requests_from_numpy(reqs, device=CPU),
            convert.endpoints_from_numpy(eps, device=CPU))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b.numpy() if torch.is_tensor(b) else b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _close(a, b, atol=1e-6):
    a, b = np.asarray(a), b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def test_chunk_hashes_match_reference():
    prompts = [b"", b"x" * 63, b"abc" * 100, (BASE % 3) * 40]
    h_ref, c_ref = jhashing.batch_chunk_hashes(prompts)
    h, c = hashing.batch_chunk_hashes(prompts)
    _eq(h_ref, h)
    _eq(c_ref, c)


def test_fixture_builders_match_reference():
    rng = np.random.default_rng(5)
    kw_eps = dict(queue=rng.integers(0, 9, 6).tolist(),
                  kv=rng.uniform(0, 1, 6).tolist(), running=[1] * 6,
                  max_lora=3, lora_active=[[1, 2]], lora_waiting=[[4]],
                  role=[0, 1, 2, 0, 1, 2], m_slots=64)
    ref, port = make_endpoints(6, **kw_eps), ttesting.make_endpoints(6, **kw_eps)
    for k, v in convert.endpoints_to_numpy(port).items():
        _eq(getattr(ref, k), v)
    kw_reqs = dict(prompts=[BASE % i * 3 for i in range(5)],
                   lora_id=[-1, 0, 1, 2, 3], criticality=[0, 1, 2, 1, 0],
                   subset=[None, [1, 2], None, [], None], m_slots=64)
    ref, port = make_requests(5, **kw_reqs), ttesting.make_requests(5, **kw_reqs)
    for k, v in convert.requests_to_numpy(port).items():
        _eq(getattr(ref, k), v)


@pytest.mark.parametrize("m", [64, 256])
def test_filters_match_reference(m):
    reqs, eps = _inputs(48, 40, m, seed=m)
    treqs, teps = _port(reqs, eps)
    _eq(jfilters.base_mask(reqs, eps), filters.base_mask(treqs, teps))
    _eq(jfilters.saturation_mask(reqs, eps, queue_limit=128.0, kv_limit=0.95),
        filters.saturation_mask(treqs, teps, queue_limit=128.0, kv_limit=0.95))
    for a, b in zip(jfilters.lora_membership(reqs, eps),
                    filters.lora_membership(treqs, teps)):
        _eq(a, b)
    _eq(jfilters.lora_capacity_mask(reqs, eps),
        filters.lora_capacity_mask(treqs, teps))


@pytest.mark.parametrize("m", [64, 256])
def test_scorers_match_reference(m):
    reqs, eps = _inputs(48, 40, m, seed=10 + m)
    treqs, teps = _port(reqs, eps)
    _close(jscorers.queue_score(eps, queue_norm=16.0),
           scorers.queue_score(teps, queue_norm=16.0))
    _close(jscorers.kv_cache_score(eps), scorers.kv_cache_score(teps))
    _close(jscorers.lora_affinity_score(reqs, eps),
           scorers.lora_affinity_score(treqs, teps))
    load = np.random.default_rng(m).uniform(0, 12, m).astype(np.float32)
    _close(jscorers.assumed_load_score(jnp.asarray(load), load_norm=8.0),
           scorers.assumed_load_score(torch.from_numpy(load), load_norm=8.0))


@pytest.mark.parametrize("m, key_chunks", [(64, 1), (256, 1), (256, 2)])
def test_session_hash_bit_exact(m, key_chunks):
    """The splitmix32 rendezvous hash wraps u32 in the reference; the port
    carries it in int64 with a 32-bit mask and must agree to the bit."""
    reqs, eps = _inputs(64, 50, m, seed=20 + m, shared=7)
    treqs, teps = _port(reqs, eps)
    ref = np.asarray(jscorers.session_affinity_score(
        reqs, eps, key_chunks=key_chunks))
    port = scorers.session_affinity_score(
        treqs, teps, key_chunks=key_chunks).numpy()
    _eq(ref.view(np.uint32), port.view(np.uint32))
    # Every row with a session key has one winner at 1.0.
    assert ((port == 1.0).sum(axis=1) >= 1).all()


def _jax_table(table: PrefixTable) -> JaxPrefixTable:
    arrays = prefix.snapshot_table(table)
    return JaxPrefixTable(keys=jnp.asarray(arrays["keys"]),
                          present=jnp.asarray(arrays["present"]),
                          ages=jnp.asarray(arrays["ages"]))


def _tables_equal(jt, tt):
    ref = jprefix.snapshot_table(jt)
    port = prefix.snapshot_table(tt)
    for k in ("keys", "present", "ages"):
        assert ref[k].dtype == port[k].dtype == np.uint32
        _eq(ref[k], port[k])


def _random_table(m, seed, slots=1 << 15):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, slots, dtype=np.uint64).astype(np.uint32)
    keys[rng.uniform(size=slots) < 0.5] = 0
    present = rng.integers(0, 2**32, (slots, m // 32),
                           dtype=np.uint64).astype(np.uint32)
    ages = rng.integers(0, 2**32, slots, dtype=np.uint64).astype(np.uint32)
    return prefix.table_from_arrays(
        {"keys": keys, "present": present, "ages": ages}, device=CPU)


@pytest.mark.parametrize("m", [64, 256])
def test_match_scores_match_reference(m):
    reqs, eps = _inputs(48, 40, m, seed=30 + m)
    treqs, _ = _port(reqs, eps)
    table = PrefixTable.empty(m=m, device=CPU)
    picked = torch.from_numpy(
        np.random.default_rng(m).integers(-1, 40, 48).astype(np.int32))
    prefix.insert(table, treqs, picked, torch.tensor(7))
    # Age some rows past max_age through the u32 wraparound of tick - age.
    table.ages[::3] = 2**32 - 5
    jt = _jax_table(table)
    for tick in (7, 60, 2**32 - 1):
        ref = jprefix.match_scores(jt, reqs, jnp.uint32(tick), max_age=50)
        port = prefix.match_scores(table, treqs, torch.tensor(tick),
                                   max_age=50)
        _eq(ref, port)
    assert port.max() > 0


def _collision_wave(n, m, seed):
    """Many requests sharing chunk 0 (one system prompt), picked onto
    endpoints that share packed words, plus hashes forced onto one slot
    with different keys (same-wave evictions)."""
    rng = np.random.default_rng(seed)
    prompts = [BASE * 2 + b"tail %d" % (i % 3) * 20 for i in range(n)]
    reqs = make_requests(n, prompts=prompts, m_slots=m)
    hashes = np.array(reqs.chunk_hashes)
    # Rows 0..7: chunk 1 rewritten to distinct keys on ONE table slot.
    hashes[:8, 1] = (np.arange(8, dtype=np.uint32) << 15) | 12345
    reqs = reqs.replace(chunk_hashes=jnp.asarray(hashes))
    picked = rng.integers(0, 32, n).astype(np.int32)     # all in word 0
    picked[::5] = rng.integers(32, m, len(picked[::5]))
    picked[3] = -1
    return reqs, picked


@pytest.mark.parametrize("m, start", [(64, "empty"), (256, "random")])
def test_insert_collision_wave_is_last_wins_exact(m, start):
    reqs, picked = _collision_wave(64, m, seed=m)
    treqs = convert.requests_from_numpy(reqs, device=CPU)
    table = (PrefixTable.empty(m=m, device=CPU) if start == "empty"
             else _random_table(m, seed=m))
    jt = _jax_table(table)
    for tick, perm in ((5, None), (6, np.random.default_rng(1).permutation(64))):
        r, p = reqs, picked
        if perm is not None:   # a second wave, reordered: hits + evictions
            r = reqs.replace(**{k: getattr(reqs, k)[perm] for k in
                                ("valid", "chunk_hashes", "n_chunks")})
            p = picked[perm]
        jt = jprefix.insert(jt, r, jnp.asarray(p), jnp.uint32(tick))
        prefix.insert(table, convert.requests_from_numpy(r, device=CPU),
                      torch.from_numpy(p), torch.tensor(tick))
        _tables_equal(jt, table)
    # The wave really collided: one (row, word) cell took >1 lanes.
    slot0 = int(np.asarray(reqs.chunk_hashes)[0, 0]) & ((1 << 15) - 1)
    assert bin(int(table.present[slot0, 0])).count("1") >= 1
    assert treqs.chunk_hashes.shape[0] == 64


def test_clear_endpoint_and_snapshot_roundtrip():
    table = _random_table(256, seed=4)
    jt = _jax_table(table)
    for slot in (0, 37, 255):
        jt = jprefix.clear_endpoint(jt, jnp.int32(slot))
        prefix.clear_endpoint(table, slot)
    _tables_equal(jt, table)
    again = prefix.table_from_arrays(prefix.snapshot_table(table), device=CPU)
    _tables_equal(jt, again)
    assert prefix.table_from_arrays({"keys": np.zeros(4)}, device=CPU) is None
    assert prefix.table_from_arrays(
        {"keys": np.zeros(4), "present": np.zeros((3, 2)),
         "ages": np.zeros(4)}, device=CPU) is None


def _scores(n, m, seed, ties=False):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0, 1, (n, m)).astype(np.float32)
    if ties:
        s = np.round(s * 8) / 8
    mask = rng.uniform(size=(n, m)) < 0.8
    mask[0] = False
    mask[1, :] = False
    mask[1, 5] = True
    return s, mask


@pytest.mark.parametrize("m", [64, 256])
def test_iota_tiebreak_and_topk_exact(m):
    s, mask = _scores(32, m, seed=m, ties=True)
    masked = np.where(mask, s, np.float32(jpickers.NEG)).astype(np.float32)
    ref = np.asarray(jpickers._iota_tiebreak(jnp.asarray(masked),
                                             jnp.asarray(mask)))
    port = pickers._iota_tiebreak(torch.from_numpy(masked),
                                  torch.from_numpy(mask)).numpy()
    _eq(ref.view(np.int32), port.view(np.int32))
    for k in (1, 4):
        rv, ri = jpickers._topk(jnp.asarray(ref), k)
        tv, ti = pickers._topk(torch.from_numpy(port), k)
        _eq(rv, tv)
        _eq(ri, ti)


@pytest.mark.parametrize("m", [64, 256])
def test_finalize_and_topk_picker_exact(m):
    s, mask = _scores(40, m, seed=100 + m, ties=True)
    rng = np.random.default_rng(m)
    shed = rng.uniform(size=40) < 0.2
    valid = rng.uniform(size=40) < 0.9
    for rr in (0, 5, 2**32 - 3):
        ref = jpickers.topk_picker(
            jnp.asarray(s), jnp.asarray(mask), jnp.asarray(shed),
            jnp.asarray(valid), jnp.uint32(rr))
        port = pickers.topk_picker(
            torch.from_numpy(s), torch.from_numpy(mask),
            torch.from_numpy(shed), torch.from_numpy(valid),
            torch.tensor(rr))
        _eq(ref.indices, port.indices)
        _eq(ref.status, port.status)
        _eq(ref.scores, port.scores)
    vals = np.sort(s, axis=1)[:, ::-1][:, :4].copy()
    vals[2] = jpickers.NEG
    idx = np.argsort(-s, axis=1)[:, :4].astype(np.int32)
    ref = jpickers.finalize_from_topk(
        jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(mask),
        jnp.asarray(shed), jnp.asarray(valid))
    port = pickers.finalize_from_topk(
        torch.from_numpy(vals), torch.from_numpy(idx), torch.from_numpy(mask),
        torch.from_numpy(shed), torch.from_numpy(valid))
    _eq(ref.indices, port.indices)
    _eq(ref.status, port.status)


@pytest.mark.parametrize("count", [0, 1, 7, 8, 9, 33, 64, 65, 256, 1000, 1024])
def test_bucket_helpers_match_reference(count):
    for ref_fn, port_fn in ((jtypes.bucket_for, types.bucket_for),
                            (jtypes.m_bucket_for, types.m_bucket_for),
                            (jtypes.chunk_bucket_for, types.chunk_bucket_for)):
        assert port_fn(count) == ref_fn(count)
    with pytest.raises(ValueError):
        types.bucket_for(1025)
    with pytest.raises(ValueError):
        types.m_bucket_for(1025)


def test_pad_requests_matches_reference():
    reqs, eps = _inputs(5, 8, 64, seed=3)
    ref = jtypes.pad_requests(reqs, 8)
    port = types.pad_requests(_port(reqs, eps)[0], 8)
    for k, v in convert.requests_to_numpy(port).items():
        _eq(getattr(ref, k), v)
    with pytest.raises(ValueError):
        types.pad_requests(port, 4)


@pytest.mark.parametrize("m_from, m_to", [(64, 256), (256, 64), (64, 1024)])
def test_resize_state_matches_reference(m_from, m_to):
    rng = np.random.default_rng(m_from + m_to)
    table = _random_table(m_from, seed=m_from)
    arrays = {"prefix_" + k: v for k, v in prefix.snapshot_table(table).items()}
    arrays.update(assumed_load=rng.uniform(0, 4, m_from).astype(np.float32),
                  ot_v=rng.uniform(0.1, 1, m_from).astype(np.float32),
                  rr=np.uint32(7), tick=np.uint32(2**32 - 1))
    port = convert.state_from_numpy(arrays, device=CPU)
    ref = jtypes.SchedState(
        prefix=_jax_table(table),
        assumed_load=jnp.asarray(arrays["assumed_load"]),
        rr=jnp.uint32(7), tick=jnp.uint32(2**32 - 1),
        ot_v=jnp.asarray(arrays["ot_v"]))
    ref = jtypes.resize_state(ref, m_to)
    # The port migrates in place, into a bucket's state that holds another
    # wave's values: every one of them is overwritten.
    dst = types.SchedState.init(slots=int(port.prefix.keys.shape[0]),
                                m=m_to, device=CPU)
    for t in (dst.prefix.keys, dst.prefix.present, dst.prefix.ages,
              dst.assumed_load, dst.rr, dst.tick, dst.ot_v):
        t.fill_(5)
    got = convert.state_to_numpy(types.resize_into(port, dst))
    _eq(np.asarray(ref.prefix.present), got["prefix_present"])
    _eq(np.asarray(ref.assumed_load), got["assumed_load"])
    _eq(np.asarray(ref.ot_v), got["ot_v"])
    _eq(np.asarray(ref.tick), got["tick"])
    _eq(np.asarray(ref.rr), got["rr"])
    _eq(np.asarray(ref.prefix.keys), got["prefix_keys"])
    _eq(np.asarray(ref.prefix.ages), got["prefix_ages"])
