"""The port's fleet picker (gie_tpu_torch/fleet) against the reference's
(gie_tpu/fleet) on the CPU.

Inputs come from numpy seeds and gie_tpu/utils/testing.py and cross with
gie_tpu_torch.convert. Integer and bool outputs (cell ids, selections,
packed presence words, counts, picks, status) must be exact; coarse scores
and cell means within atol 1e-6. Pick scores and the carried float state
are bounded as tests/test_torch_slice.py bounds them, and the Gumbel noise
of the dense stage is the reference's, replayed at (n_bucket, m_c)
(jax_noise_replay).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gie_tpu.fleet import FleetPicker as JaxFleetPicker
from gie_tpu.fleet import cells as jcells
from gie_tpu.fleet import coarse as jcoarse
from gie_tpu.fleet import compress as jcompress
from gie_tpu.fleet.picker import fleet_resize_state as jax_resize
from gie_tpu.sched import ProfileConfig as JaxProfileConfig
from gie_tpu.sched.config import tuned_profile as jax_tuned_profile
from gie_tpu.sched.types import PrefixTable as JaxPrefixTable
from gie_tpu.sched.types import SchedState as JaxSchedState
from gie_tpu.sched.types import Weights as JaxWeights
from gie_tpu.sched.types import chunk_bucket_for
from gie_tpu.utils.testing import make_endpoints, make_requests

from gie_tpu_torch import convert
from gie_tpu_torch.fleet import FleetPicker, cells, coarse, compress
from gie_tpu_torch.fleet.picker import (
    _is_sketch,
    fleet_resize_state,
    fleet_state,
)
from gie_tpu_torch.sched import ProfileConfig, Scheduler
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.config import tuned_profile
from gie_tpu_torch.sched import profile as profile_mod
from gie_tpu_torch.sched.types import Weights
from tests.test_torch_slice import jax_noise_replay

CPU = "cpu"


@pytest.fixture(autouse=True)
def _deterministic_torch():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _u32(x):
    """A u32 carrier (torch int64 or jax uint32) as numpy uint32."""
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.uint32)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _endpoints(m, live, seed, *, dead_cell=None, cell_cap=32):
    """Endpoints with seeded queue/KV and LoRA ids -1..11 (duplicates and
    ids 32 apart included); slots past `live`, and `dead_cell` if given,
    are invalid."""
    rng = np.random.default_rng(seed)
    ids = [rng.integers(-1, 12, 3).tolist() for _ in range(live)]
    ids[0] = [5, 5, 37]            # the same bit three ways
    eps = make_endpoints(live, queue=rng.integers(0, 50, live).tolist(),
                         kv=rng.uniform(0, 0.95, live).tolist(), max_lora=8,
                         lora_active=ids, m_slots=m)
    if dead_cell is not None:
        valid = np.asarray(eps.valid).copy()
        valid[dead_cell * cell_cap:(dead_cell + 1) * cell_cap] = False
        eps = eps.replace(valid=jnp.asarray(valid))
    return eps


def _prompts(n, wave=0):
    return [b"S%d " % (i % 4) * 30 + b"w%d q%d" % (wave, i) for i in range(n)]


def _requests(n, m, seed, wave=0, subset=None):
    rng = np.random.default_rng(seed + 1000 * wave)
    reqs = make_requests(n, prompts=_prompts(n, wave),
                         lora_id=rng.integers(-1, 12, n).tolist(),
                         criticality=rng.integers(0, 3, n).tolist(),
                         subset=subset, m_slots=m)
    cb = chunk_bucket_for(int(np.asarray(reqs.n_chunks).max()))
    return reqs.replace(chunk_hashes=reqs.chunk_hashes[:, :cb])


def _table(m_words, seed, reqs=None):
    """A packed table with seeded words, some rows keyed by the requests'
    own chunk hashes (so matches happen), ages near tick 40."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2**32, C.PREFIX_SLOTS, dtype=np.uint64)
    if reqs is not None:
        h = np.asarray(reqs.chunk_hashes).reshape(-1)
        h = h[h != 0]
        keys[h & (C.PREFIX_SLOTS - 1)] = h
    present = rng.integers(0, 2**32, (C.PREFIX_SLOTS, m_words),
                           dtype=np.uint64)
    present[rng.random(present.shape) < 0.5] = 0
    ages = rng.integers(0, 50, C.PREFIX_SLOTS, dtype=np.uint64)
    return {"keys": keys.astype(np.uint32),
            "present": present.astype(np.uint32),
            "ages": ages.astype(np.uint32)}


def _jax_table(t):
    return JaxPrefixTable(keys=jnp.asarray(t["keys"]),
                          present=jnp.asarray(t["present"]),
                          ages=jnp.asarray(t["ages"]))


def _port_table(t):
    from gie_tpu_torch.sched.prefix import table_from_arrays
    return table_from_arrays(t, device=CPU)


# ==========================================================================
# cells
# ==========================================================================


@pytest.mark.parametrize("m, cap, dead", [(128, 32, 1), (2048, 64, None)])
def test_build_cell_rows_matches_reference(m, cap, dead):
    eps = _endpoints(m, m - 40, 1, dead_cell=dead, cell_cap=cap)
    load = np.random.default_rng(2).uniform(0, 3, m).astype(np.float32)
    ref = jcells.build_cell_rows(eps, jnp.asarray(load), cell_cap=cap)
    port = cells.build_cell_rows(convert.endpoints_from_numpy(eps, device=CPU),
                                 torch.from_numpy(load), cell_cap=cap)
    for f in ("queue", "kv", "load"):
        np.testing.assert_allclose(_np(getattr(port, f)),
                                   np.asarray(getattr(ref, f)), atol=1e-6)
    np.testing.assert_array_equal(_np(port.n_valid), np.asarray(ref.n_valid))
    np.testing.assert_array_equal(_u32(port.lora), _u32(ref.lora))
    np.testing.assert_array_equal(_np(port.valid), np.asarray(ref.valid))
    if dead is not None:
        assert not bool(port.valid[dead])


def test_lora_bloom_and_or_fold_are_exact():
    eps = _endpoints(256, 200, 3)
    teps = convert.endpoints_from_numpy(eps, device=CPU)
    bits = cells.lora_residency_bits(teps)
    np.testing.assert_array_equal(_u32(bits),
                                  _u32(jcells.lora_residency_bits(eps)))
    assert int(bits[0]) == 1 << 5                  # 5, 5 and 37: one bit
    words = np.random.default_rng(4).integers(
        0, 2**32, 256, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        _u32(cells._or_fold(torch.from_numpy(words.astype(np.int64)), 32)),
        _u32(jcells._or_fold(jnp.asarray(words), 32)))


@pytest.mark.parametrize("cap", [32, 64])
def test_cell_match_from_table_matches_reference(cap):
    m = 256
    reqs = _requests(24, m, 5)
    t = _table(m // 32, 6, reqs)
    tick = 45
    ref = jcells.cell_match_from_table(
        _jax_table(t), reqs, jnp.uint32(tick), cell_cap=cap, max_age=30)
    port = cells.cell_match_from_table(
        _port_table(t), convert.requests_from_numpy(reqs, device=CPU),
        torch.tensor(tick), cell_cap=cap, max_age=30)
    np.testing.assert_allclose(_np(port), np.asarray(ref), atol=1e-6)
    assert float(port.max()) > 0


# ==========================================================================
# coarse
# ==========================================================================


def _coarse_inputs(case):
    """(eps, reqs, load, table) of a coarse case. "ties": two identical
    halves of cells, one dead cell, a subset hint that makes cells
    ineligible and padded (invalid) request rows, so most cell scores tie
    and many sit at -1e9."""
    m, cap, n = 512, 32, 40
    if case == "random":
        eps = _endpoints(m, m - 50, 7, cell_cap=cap)
        reqs = _requests(n, m, 8)
        load = np.random.default_rng(9).uniform(0, 4, m).astype(np.float32)
        return eps, reqs, load, cap
    half = make_endpoints(m // 2, queue=[3.0] * (m // 2), kv=[0.5] * (m // 2),
                          m_slots=m // 2)
    metrics = np.concatenate([np.asarray(half.metrics)] * 2)
    valid = np.concatenate([np.asarray(half.valid)] * 2)
    valid[5 * cap:6 * cap] = False
    eps = make_endpoints(m, m_slots=m).replace(
        metrics=jnp.asarray(metrics), valid=jnp.asarray(valid))
    rng = np.random.default_rng(10)
    subset = [None if i % 3 == 0 else
              sorted(rng.choice(m, 40, replace=False).tolist())
              for i in range(n)]
    reqs = _requests(n, m, 11, subset=subset)
    rvalid = np.asarray(reqs.valid).copy()
    rvalid[n - 12:] = False
    reqs = reqs.replace(valid=jnp.asarray(rvalid))
    return eps, reqs, np.zeros(m, np.float32), cap


@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("k", [3, 16])
def test_coarse_total_and_select_cells_match_reference(case, k):
    eps, reqs, load, cap = _coarse_inputs(case)
    teps = convert.endpoints_from_numpy(eps, device=CPU)
    treqs = convert.requests_from_numpy(reqs, device=CPU)
    jw, tw = JaxWeights.default(), Weights.default()
    jrows = jcells.build_cell_rows(eps, jnp.asarray(load), cell_cap=cap)
    trows = cells.build_cell_rows(teps, torch.from_numpy(load), cell_cap=cap)
    t = _table(eps.valid.shape[0] // 32, 12, reqs)
    jpref = jcells.cell_match_from_table(_jax_table(t), reqs, jnp.uint32(3),
                                         cell_cap=cap, max_age=100)
    tpref = cells.cell_match_from_table(_port_table(t), treqs,
                                        torch.tensor(3), cell_cap=cap,
                                        max_age=100)
    jc = jcoarse.coarse_total(jrows, jpref, reqs, jw, queue_norm=64.0,
                              load_norm=32.0)
    tc = coarse.coarse_total(trows, tpref, treqs, tw, queue_norm=64.0,
                             load_norm=32.0)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=1e-6)
    jsel, jcand, jscores = jcoarse.select_cells(
        jc, jrows, reqs, eps, cell_cap=cap, k=k)
    tsel, tcand, tscores = coarse.select_cells(
        tc, trows, treqs, teps, cell_cap=cap, k=k)
    np.testing.assert_array_equal(_np(tsel), np.asarray(jsel))
    np.testing.assert_array_equal(_np(tcand), np.asarray(jcand))
    np.testing.assert_allclose(_np(tscores), np.asarray(jscores), atol=1e-6)
    assert (np.diff(_np(tsel)) > 0).all()       # ascending, distinct
    if case == "ties":
        # Equal cells tie exactly, and at k = 16 (every cell) the dead and
        # ineligible cells tie at -1e9: the lower cell id comes first.
        assert (np.diff(_np(tscores), axis=1) == 0).any()
        assert (_np(tscores) == -1e9).any() == (k == 16)


def test_coarse_weights_from_tensors_equal_floats():
    """A captured cycle reads the coarse weights as 0-d tensors of its
    static buffer: the blend is the same as from the Weights' floats."""
    eps, reqs, load, cap = _coarse_inputs("random")
    teps = convert.endpoints_from_numpy(eps, device=CPU)
    treqs = convert.requests_from_numpy(reqs, device=CPU)
    rows = cells.build_cell_rows(teps, torch.from_numpy(load), cell_cap=cap)
    pref = torch.rand((treqs.valid.shape[0], 16),
                      generator=torch.Generator().manual_seed(0))
    w = Weights(queue=1.5, kv_cache=0.7, prefix=3.1, lora=0.4,
                assumed_load=2.2, latency=0.0)
    import types
    wt = types.SimpleNamespace(**{
        k: torch.tensor(getattr(w, k), dtype=torch.float32)
        for k in coarse.COARSE_WEIGHTS})
    a = coarse.coarse_total(rows, pref, treqs, w, queue_norm=16.0,
                            load_norm=8.0)
    b = coarse.coarse_total(rows, pref, treqs, wt, queue_norm=16.0,
                            load_norm=8.0)
    assert torch.equal(a, b)


# ==========================================================================
# compress
# ==========================================================================

SELECTIONS = [([1, 3], 32, 64), ([0, 2, 5], 32, 256), ([4], 64, 64),
              ([0, 1, 2, 3], 32, 128)]


@pytest.mark.parametrize("sel, cap, m_c", SELECTIONS)
def test_global_slots_and_gathers_match_reference(sel, cap, m_c):
    m = 512
    eps = _endpoints(m, m - 30, 13, cell_cap=cap)
    jsel = jnp.asarray(sel, jnp.int32)
    tsel = torch.tensor(sel, dtype=torch.int32)
    jg = jcompress.global_slots(jsel, cell_cap=cap, m_c=m_c)
    tg = compress.global_slots(tsel, cell_cap=cap, m_c=m_c)
    np.testing.assert_array_equal(_np(tg), np.asarray(jg))
    assert tg.dtype == torch.int32
    je = jcompress.gather_endpoints(eps, jsel, cell_cap=cap, m_c=m_c)
    te = compress.gather_endpoints(convert.endpoints_from_numpy(eps, device=CPU),
                                   tsel, cell_cap=cap, m_c=m_c)
    for k, v in convert.endpoints_to_numpy(te).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(je, k)), err_msg=k)
    reqs = _requests(8, m, 14, subset=[list(range(i, m, 3)) for i in range(8)])
    np.testing.assert_array_equal(
        _np(compress.gather_request_cols(
            torch.from_numpy(np.array(reqs.subset_mask)), tg)),
        np.asarray(jcompress.gather_request_cols(reqs.subset_mask, jg)))
    vec = np.random.default_rng(15).uniform(0, 5, m).astype(np.float32)
    for fill in (0.0, 1.0):
        np.testing.assert_array_equal(
            _np(compress.gather_vec(torch.from_numpy(vec), tg, fill)),
            np.asarray(jcompress.gather_vec(jnp.asarray(vec), jg, fill)))
    words = _table(m // 32, 16)["present"][:64]
    np.testing.assert_array_equal(
        _u32(compress.gather_words(torch.from_numpy(words.astype(np.int64)),
                                   tsel, cell_cap=cap, m_c=m_c)),
        _u32(jcompress.gather_words(jnp.asarray(words), jsel, cell_cap=cap,
                                    m_c=m_c)))


@pytest.mark.parametrize("sel, cap, m_c", SELECTIONS)
def test_scatter_vec_matches_reference_and_drops_the_pad(sel, cap, m_c):
    """Padded positions write to the dropped scratch slot; every live
    target is distinct (the selection's cells are), so each is written
    once: the result equals a plain loop over the live positions."""
    m = 512
    rng = np.random.default_rng(17)
    full = rng.uniform(0, 5, m).astype(np.float32)
    comp = rng.uniform(5, 9, m_c).astype(np.float32)
    jg = jcompress.global_slots(jnp.asarray(sel, jnp.int32), cell_cap=cap,
                                m_c=m_c)
    tg = compress.global_slots(torch.tensor(sel, dtype=torch.int32),
                               cell_cap=cap, m_c=m_c)
    out = _np(compress.scatter_vec(torch.from_numpy(full), tg,
                                   torch.from_numpy(comp)))
    np.testing.assert_array_equal(out, np.asarray(jcompress.scatter_vec(
        jnp.asarray(full), jg, jnp.asarray(comp))))
    live = _np(tg)[_np(tg) >= 0]
    assert len(np.unique(live)) == len(live) == len(sel) * cap
    expect = full.copy()
    for j, g in enumerate(_np(tg)):
        if g >= 0:
            expect[g] = comp[j]
    np.testing.assert_array_equal(out, expect)


@pytest.mark.parametrize("sel", [[1, 3], [0, 1, 2, 3], [2]])
def test_scatter_words_clears_recycled_rows_as_reference(sel):
    cap, m, rows = 32, 128, 16
    rng = np.random.default_rng(18)
    present = rng.integers(0, 2**32, (rows, m // 32),
                           dtype=np.uint64).astype(np.uint32)
    comp = rng.integers(0, 2**32, (rows, len(sel)),
                        dtype=np.uint64).astype(np.uint32)
    differ = rng.random(rows) < 0.4
    ref = jcompress.scatter_words(jnp.asarray(present),
                                  jnp.asarray(sel, jnp.int32),
                                  jnp.asarray(comp), jnp.asarray(differ),
                                  cell_cap=cap)
    port = compress.scatter_words(torch.from_numpy(present.astype(np.int64)),
                                  torch.tensor(sel, dtype=torch.int32),
                                  torch.from_numpy(comp.astype(np.int64)),
                                  torch.from_numpy(differ), cell_cap=cap)
    np.testing.assert_array_equal(_u32(port), _u32(ref))
    unselected = [c for c in range(m // 32) if c not in sel]
    if unselected:
        assert (_u32(port)[differ][:, unselected] == 0).all()


@pytest.mark.parametrize("m, cap, out_cells", [(128, 32, 32), (1024, 32, 32),
                                               (1024, 64, 64)])
def test_compact_and_broadcast_presence_match_reference(m, cap, out_cells):
    dense = _table(m // 32, 19)["present"][:40]
    jc = jcompress.compact_presence(jnp.asarray(dense), cell_cap=cap,
                                    out_cells=out_cells)
    tc = compress.compact_presence(torch.from_numpy(dense.astype(np.int64)),
                                   cell_cap=cap, out_cells=out_cells)
    np.testing.assert_array_equal(_u32(tc), _u32(jc))
    cells_n = m // cap
    sel = np.arange(cells_n, dtype=np.int32)[::2]
    m_c = 1024 if len(sel) * cap > 512 else 512
    jb = jcompress.broadcast_presence(jc, jnp.asarray(sel), cell_cap=cap,
                                      m_c=m_c)
    tb = compress.broadcast_presence(tc, torch.from_numpy(sel), cell_cap=cap,
                                     m_c=m_c)
    np.testing.assert_array_equal(_u32(tb), _u32(jb))
    with pytest.raises(ValueError):
        compress.compact_presence(torch.from_numpy(dense.astype(np.int64)),
                                  cell_cap=cap, out_cells=31)


# ==========================================================================
# fleet_resize_state
# ==========================================================================


def _seeded_exact(m):
    rng = np.random.default_rng(20)
    t = _table(m // 32, 21)
    return {"prefix_keys": t["keys"], "prefix_present": t["present"],
            "prefix_ages": t["ages"],
            "assumed_load": rng.uniform(0, 3, m).astype(np.float32),
            "ot_v": rng.uniform(0.5, 2, m).astype(np.float32),
            "rr": np.uint32(7), "tick": np.uint32(40)}


def _jax_state(a):
    return JaxSchedState(
        prefix=JaxPrefixTable(keys=jnp.asarray(a["prefix_keys"]),
                              present=jnp.asarray(a["prefix_present"]),
                              ages=jnp.asarray(a["prefix_ages"])),
        assumed_load=jnp.asarray(a["assumed_load"]),
        rr=jnp.asarray(a["rr"]), tick=jnp.asarray(a["tick"]),
        ot_v=jnp.asarray(a["ot_v"]))


@pytest.mark.parametrize("path", [(64, 256), (64, 2048), (1024, 4096),
                                  (64, 2048, 4096), (64, 2048, 64),
                                  (64, 4096, 2048)])
def test_fleet_resize_state_transitions_match_reference(path):
    """exact->exact, exact->sketch, sketch->sketch (grow and shrink) and
    sketch->exact, each carried on from the previous step."""
    cap = 32
    arrays = _seeded_exact(path[0])
    jst = _jax_state(arrays)
    tst = convert.state_from_numpy(arrays, device=CPU)
    for m in path[1:]:
        jst = jax_resize(jst, m=m, cell_cap=cap)
        tst = fleet_resize_state(tst, m=m, cell_cap=cap)
        assert _is_sketch(tst) == (m > C.M_BUCKETS[-1])
        ref = {"prefix_keys": jst.prefix.keys,
               "prefix_present": jst.prefix.present,
               "prefix_ages": jst.prefix.ages,
               "assumed_load": jst.assumed_load, "ot_v": jst.ot_v,
               "rr": jst.rr, "tick": jst.tick}
        for k, v in convert.state_to_numpy(tst).items():
            np.testing.assert_array_equal(v, np.asarray(ref[k]), err_msg=k)


def test_exact_to_sketch_pads_a_table_narrower_than_a_cell():
    """The first bucket (64 slots) under a 256-slot cell: the reference's
    compact_presence refuses the 2-word table; the port pads it to the
    cell's 8 words, so the first wave at a sketch width can grow a fresh
    picker's state. Slot 35's chunk lands on cell 0."""
    arrays = _seeded_exact(64)
    with pytest.raises((TypeError, ValueError)):
        jax_resize(_jax_state(arrays), m=65536, cell_cap=256)
    tst = convert.state_from_numpy(arrays, device=CPU)
    sk = fleet_resize_state(tst, m=65536, cell_cap=256)
    assert _is_sketch(sk) and tuple(sk.prefix.present.shape) == (
        C.PREFIX_SLOTS, 8)
    held = (arrays["prefix_present"] != 0).any(axis=1)
    got = _u32(sk.prefix.present)
    np.testing.assert_array_equal(got[:, 0], held.astype(np.uint32))
    assert (got[:, 1:] == 0).all()
    np.testing.assert_array_equal(_np(sk.assumed_load[:64]),
                                  arrays["assumed_load"])


# ==========================================================================
# FleetPicker against the reference's
# ==========================================================================

# name -> (m, live, cell_cap, topk, profile)
PICKERS = {
    "covering-topk-kernel": (64, 50, 32, 2, "topk-kernel"),
    "covering-sinkhorn-kernel": (64, 50, 32, 2, "tuned-sinkhorn-kernel"),
    "covering-random": (64, 50, 32, 2, "random"),
    "partial-k2-sinkhorn-kernel": (256, 230, 32, 2, "tuned-sinkhorn-kernel"),
    "partial-k2-topk-kernel": (256, 230, 32, 2, "topk-kernel"),
    "sketch-sinkhorn-kernel": (2048, 2000, 64, 4, "tuned-sinkhorn-kernel"),
    "sketch-topk-kernel": (2048, 2000, 64, 4, "topk-kernel"),
}


def _profiles(name):
    if name == "tuned-sinkhorn-kernel":
        jc, jw = jax_tuned_profile()
        tc, tw = tuned_profile()
        return (dataclasses.replace(jc, use_pallas_sinkhorn=True), jw,
                dataclasses.replace(tc, use_pallas_sinkhorn=True), tw)
    if name == "topk-kernel":
        return (JaxProfileConfig(picker="topk", use_pallas_topk=True), None,
                ProfileConfig(picker="topk", use_pallas_topk=True), None)
    return (JaxProfileConfig(picker=name), None, ProfileConfig(picker=name),
            None)


def _assert_results(ref, port, sinkhorn):
    np.testing.assert_array_equal(port.indices, np.asarray(ref.indices))
    np.testing.assert_array_equal(port.status, np.asarray(ref.status))
    np.testing.assert_array_equal(port.fleet.cells,
                                  np.asarray(ref.fleet.cells))
    np.testing.assert_allclose(port.fleet.scores,
                               np.asarray(ref.fleet.scores), atol=1e-6)
    rtol = 2 * 1024 * 2.0**-23 if sinkhorn else 0
    np.testing.assert_allclose(port.scores, np.asarray(ref.scores),
                               atol=1e-5, rtol=rtol)
    np.testing.assert_allclose(port.affinity, np.asarray(ref.affinity),
                               atol=1e-5)


def _assert_states(ref, port):
    assert set(ref) == set(port)
    for k in ("prefix_keys", "prefix_present", "prefix_ages", "rr", "tick"):
        np.testing.assert_array_equal(port[k], np.asarray(ref[k]), err_msg=k)
    for k in ("assumed_load", "ot_v"):
        np.testing.assert_allclose(port[k], np.asarray(ref[k]), atol=1e-5,
                                   err_msg=k)


def _pair(name, seed=4):
    m, live, cap, topk, prof = PICKERS[name]
    jc, jw, tc, tw = _profiles(prof)
    j = JaxFleetPicker(jc, jw, seed=seed, topk=topk, cell_cap=cap)
    t = FleetPicker(tc, tw, seed=seed, device=CPU, topk=topk, cell_cap=cap,
                    noise_source=jax_noise_replay(seed))
    return j, t, m, live


def _waves(name, j, t, m, live, waves=2, n=32):
    eps = _endpoints(m, live, 22)
    teps = convert.endpoints_from_numpy(eps, device=CPU)
    for w in range(waves):
        reqs = _requests(n, m, 23, wave=w)
        ref = j.pick(reqs, eps)
        port = t.pick(convert.requests_from_numpy(reqs, device=CPU), teps)
        _assert_results(ref, port, "sinkhorn" in name)
        assert (port.indices[:, 0] >= 0).sum() > n // 2
        # Completion feedback for half the wave, and the provenance tally.
        done = port.indices[: n // 2, 0]
        costs = np.full(done.shape, 0.25, np.float32)
        j.complete(done, costs)
        t.complete(done, costs)
        j.note_fleet_wave(np.asarray(ref.fleet.cells),
                          np.asarray(ref.indices)[:, 0])
        t.note_fleet_wave(port.fleet.cells, port.indices[:, 0])
        _assert_states(j.export_state(), t.export_state())
    return eps, teps


@pytest.mark.parametrize("name", list(PICKERS))
def test_fleet_picker_matches_reference_over_carried_waves(name):
    j, t, m, live = _pair(name)
    _waves(name, j, t, m, live)
    assert t.fleet_report() == j.fleet_report()
    assert t.debug_report()["fleet"] == j.debug_report()["fleet"]
    assert t.fleet_report()["mode"] == ("sketch" if m > 1024 else "exact")


def test_sketch_event_paths_match_reference():
    """Sketch mode: complete(), evict_endpoint (load and duals only),
    clear_prefix_endpoint (a no-op) and KV events ingested at cell grain
    (stored chunks only; removals dropped), then a third wave."""
    name = "sketch-sinkhorn-kernel"
    j, t, m, live = _pair(name)
    eps, teps = _waves(name, j, t, m, live)
    rng = np.random.default_rng(24)
    for slot in (3, 700, 1999, 5000):
        j.evict_endpoint(slot)
        t.evict_endpoint(slot)
    for slot in (5, 1500):
        j.clear_prefix_endpoint(slot)
        t.clear_prefix_endpoint(slot)
    for slot in (17, 900, 1300, 2040):
        stored = rng.integers(1, 2**32, 50, dtype=np.uint64).astype(np.uint32)
        removed = stored[:10].copy()
        j.apply_prefix_events(slot, stored, removed)
        t.apply_prefix_events(slot, stored, removed)
    _assert_states(j.export_state(), t.export_state())
    reqs = _requests(32, m, 25, wave=7)
    _assert_results(
        j.pick(reqs, eps),
        t.pick(convert.requests_from_numpy(reqs, device=CPU), teps), True)
    _assert_states(j.export_state(), t.export_state())


def test_kv_event_grows_into_sketch_mode_as_reference():
    """A KV event from a slot past the largest bucket grows the state to
    the next fleet width (exact -> sketch) before it lands at cell grain."""
    j, t, _, _ = _pair("covering-sinkhorn-kernel")
    stored = np.arange(1, 40, dtype=np.uint32) * 7919
    for slot in (10, 3000):
        j.apply_prefix_events(slot, stored, stored[:3])
        t.apply_prefix_events(slot, stored, stored[:3])
    assert t.state.m == j.state.m == 3072 and _is_sketch(t.state)
    _assert_states(j.export_state(), t.export_state())


@pytest.mark.parametrize("prof", ["topk-kernel", "tuned-sinkhorn-kernel",
                                  "random"])
def test_covering_fleet_equals_dense_scheduler_bitwise(prof):
    """Covering K: the port's fleet cycle is the port's dense cycle, pick
    for pick and bit for bit in the carried state."""
    _, _, tc, tw = _profiles(prof)
    dense = Scheduler(tc, tw, seed=6, device=CPU)
    fleet = FleetPicker(tc, tw, seed=6, device=CPU, topk=2, cell_cap=32)
    eps = convert.endpoints_from_numpy(_endpoints(64, 50, 26), device=CPU)
    for w in range(3):
        reqs = convert.requests_from_numpy(_requests(40, 64, 27, wave=w),
                                           device=CPU)
        a, b = dense.pick(reqs, eps), fleet.pick(reqs, eps)
        for f in ("indices", "status", "scores", "affinity"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert a.fleet is None and b.fleet is not None
        done = a.indices[:20, 0]
        dense.complete(done, np.full(done.shape, 0.5, np.float32))
        fleet.complete(done, np.full(done.shape, 0.5, np.float32))
        sa, sb = dense.export_state(), fleet.export_state()
        for k in sa:
            np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)


def test_sketch_export_round_trips_and_equals_reference_layout(tmp_path):
    name = "sketch-topk-kernel"
    j, t, m, live = _pair(name)
    eps, teps = _waves(name, j, t, m, live, waves=1)
    arrays = t.export_state()
    ref = j.export_state()
    assert {k: v.shape for k, v in arrays.items()} == {
        k: np.asarray(v).shape for k, v in ref.items()}
    assert arrays["prefix_present"].shape == (C.PREFIX_SLOTS, m // 64 // 32)
    _, _, tc, tw = _profiles("topk-kernel")
    other = FleetPicker(tc, tw, device=CPU, topk=4, cell_cap=64)
    assert other.install_state(arrays)
    assert _is_sketch(other.state) and other.state.m == m
    for k, v in other.export_state().items():
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)
    t.save_state(str(tmp_path))
    restored = FleetPicker(tc, tw, device=CPU, topk=4, cell_cap=64)
    assert restored.restore_state(str(tmp_path))
    for k, v in restored.export_state().items():
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)
    # A sketch table of another width, or a dense scheduler, refuses it.
    bad = dict(arrays, prefix_present=np.concatenate(
        [arrays["prefix_present"]] * 2, axis=1))
    assert other.prepare_install(bad) is None
    assert Scheduler(tc, tw, device=CPU).prepare_install(arrays) is None
    # The restored picker schedules the next wave as the original does.
    reqs = convert.requests_from_numpy(_requests(32, m, 28, wave=3),
                                       device=CPU)
    np.testing.assert_array_equal(restored.pick(reqs, teps).indices,
                                  t.pick(reqs, teps).indices)


def test_fleet_picker_validation_width_and_refusals():
    with pytest.raises(ValueError):
        FleetPicker(cell_cap=31, device=CPU)
    with pytest.raises(ValueError):
        FleetPicker(topk=0, device=CPU)
    with pytest.raises(ValueError):
        FleetPicker(topk=64, cell_cap=1024, device=CPU)
    from gie_tpu_torch.parallel import make_mesh

    deployed = FleetPicker(mesh=make_mesh(2, device="cpu"))
    assert deployed.deploy_mesh.shape == {"dp": 1, "tp": 2}
    assert deployed.mesh is None and deployed.device.type == "cpu"
    t = FleetPicker(topk=2, cell_cap=32, device=CPU)
    assert [t._m_ok(m) for m in (64, 96, 1024, 2048, 1024 + 32 * 32)] == [
        True, False, True, True, True]
    assert t._width_for(1025) == 2048 and t._width_for(300) == 512
    assert t.compressed_width(65536) == 64
    assert t.compression_ratio(65536) == pytest.approx(64 / 65536)
    eps = convert.endpoints_from_numpy(_endpoints(96, 90, 1), device=CPU)
    reqs = convert.requests_from_numpy(_requests(4, 96, 1), device=CPU)
    with pytest.raises(ValueError, match="fleet width"):
        t.pick(reqs, eps)
    report = t.fleet_report()
    assert report["waves"] == 0 and report["mode"] == "exact"
    assert not hasattr(profile_mod, "_LATER")
    state = fleet_state(4096, cell_cap=32, device=CPU)
    assert tuple(state.prefix.present.shape) == (C.PREFIX_SLOTS, 4)
