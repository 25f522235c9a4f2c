"""Scheduler checkpoints on the port (save_state / restore_state) against
the JAX reference on the CPU.

The reference writes an orbax checkpoint (a JAX library); the port,
which imports no JAX, writes its export_state arrays as one .npz. The
two formats differ; a reference checkpoint crosses over through the
reference's restore_state and export_state, then the port's
install_state. What the port keeps of the reference's restore: the
state's own M bucket becomes the live one (the cross-bucket restore), a
checkpoint from before the Sinkhorn duals existed restores with them at
ones (the legacy restore), and a missing, corrupt or mixed-layout
checkpoint returns False and leaves the state as it was.

Tolerances as tests/test_torch_slice.py: the restored export bit-equal
to the saved one, picks after a restore exact against the reference.
"""

import threading
import zipfile

import numpy as np
import pytest
import torch

from gie_tpu.sched import Scheduler as JaxScheduler
from gie_tpu.sched.config import tuned_profile as jax_tuned_profile

from gie_tpu_torch import convert
from gie_tpu_torch.sched import Scheduler
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.config import tuned_profile
from gie_tpu_torch.utils.testing import make_endpoints, make_requests
from tests.test_torch_slice import (
    SEED,
    _assert_results,
    _assert_states,
    _endpoints,
    _wave,
    jax_noise_replay,
)

CHECKPOINT = Scheduler._CHECKPOINT


@pytest.fixture(autouse=True)
def _deterministic_torch():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _scheduler(seed=SEED):
    return Scheduler(*tuned_profile(), seed=seed, device="cpu",
                     noise_source=jax_noise_replay(seed))


def _picked(sched, waves=2):
    eps = convert.endpoints_from_numpy(_endpoints(), device="cpu")
    for w in range(waves):
        res = sched.pick(convert.requests_from_numpy(_wave(w), device="cpu"),
                         eps)
        done = res.indices[:8, 0]
        sched.complete(done, np.full(done.shape, 0.25, np.float32))
    return sched


def _assert_bit_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_round_trip_restores_the_state_and_the_next_pick(tmp_path):
    saved = _picked(_scheduler())
    saved.save_state(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [CHECKPOINT]
    fresh = Scheduler(*tuned_profile(), device="cpu")
    assert fresh.restore_state(str(tmp_path))
    _assert_bit_equal(saved.export_state(), fresh.export_state())
    # Saving again over the checkpoint replaces it whole.
    _picked(saved, waves=1)
    saved.save_state(str(tmp_path))
    assert fresh.restore_state(str(tmp_path))
    _assert_bit_equal(saved.export_state(), fresh.export_state())


def test_restore_takes_the_saved_bucket(tmp_path):
    """A checkpoint saved at M=256 restores into a scheduler live at
    M=64: bucket 256 becomes the live one, and the next pick at M=64
    migrates it back as any bucket change does."""
    saved = _scheduler()
    saved.pick(make_requests(16, prompts=[b"wide %d" % i for i in range(16)],
                             m_slots=256),
               make_endpoints(200, queue=list(range(200)), m_slots=256))
    assert saved.state.m == 256
    saved.save_state(str(tmp_path))
    fresh = _picked(_scheduler(seed=3), waves=1)
    assert fresh.state.m == 64
    assert fresh.restore_state(str(tmp_path))
    assert fresh.state.m == 256
    _assert_bit_equal(saved.export_state(), fresh.export_state())
    _picked(fresh, waves=1)
    assert fresh.state.m == 64


def _rewrite(tmp_path, **changes):
    path = tmp_path / CHECKPOINT
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    for k, v in changes.items():
        if v is None:
            del arrays[k]
        else:
            arrays[k] = v
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def test_legacy_checkpoint_without_duals_restores_them_at_ones(tmp_path):
    saved = _picked(_scheduler())
    saved.save_state(str(tmp_path))
    _rewrite(tmp_path, ot_v=None)
    fresh = Scheduler(*tuned_profile(), device="cpu")
    assert fresh.restore_state(str(tmp_path))
    got, want = fresh.export_state(), saved.export_state()
    np.testing.assert_array_equal(got["ot_v"],
                                  np.ones_like(want["ot_v"]))
    want["ot_v"] = got["ot_v"]
    _assert_bit_equal(want, got)


def _corrupt(tmp_path, case):
    path = tmp_path / CHECKPOINT
    if case == "missing-directory":
        return str(tmp_path / "absent")
    if case == "garbage":
        path.write_bytes(b"not a checkpoint at all")
    elif case == "truncated":
        path.write_bytes(path.read_bytes()[:200])
    elif case == "mixed-layout":
        _rewrite(tmp_path, ot_v=np.ones((512,), np.float32))
    elif case == "not-a-bucket":
        _rewrite(tmp_path, assumed_load=np.zeros((100,), np.float32),
                 ot_v=np.ones((100,), np.float32))
    elif case == "no-prefix-table":
        _rewrite(tmp_path, prefix_keys=None)
    elif case == "table-rows":
        with np.load(path) as z:
            rows = z["prefix_keys"].shape[0] // 2
            _rewrite(tmp_path, prefix_keys=z["prefix_keys"][:rows],
                     prefix_present=z["prefix_present"][:rows],
                     prefix_ages=z["prefix_ages"][:rows])
    elif case == "pickled-object":
        _rewrite(tmp_path, rr=np.array([object()], dtype=object))
    return str(tmp_path)


@pytest.mark.parametrize("case", [
    "missing-directory", "garbage", "truncated", "mixed-layout",
    "not-a-bucket", "no-prefix-table", "table-rows", "pickled-object"])
def test_bad_checkpoint_returns_false_and_keeps_the_state(tmp_path, case):
    saved = _picked(_scheduler())
    saved.save_state(str(tmp_path))
    live = _picked(_scheduler(seed=5), waves=1)
    before = live.export_state()
    assert live.restore_state(_corrupt(tmp_path, case)) is False
    _assert_bit_equal(before, live.export_state())


def test_reference_checkpoint_carries_across(tmp_path):
    """A reference scheduler's orbax checkpoint, restored through gie_tpu
    and installed on the port: the port then schedules the next wave as
    the restored reference does, and the port's own checkpoint of that
    state restores bit-equal."""
    jc, jw = jax_tuned_profile()
    jsched = JaxScheduler(jc, jw, seed=SEED)
    eps = _endpoints()
    for w in range(2):
        jsched.pick(_wave(w), eps)
    jsched.save_state(str(tmp_path / "orbax"))
    jrestored = JaxScheduler(jc, jw, seed=SEED + 1)
    assert jrestored.restore_state(str(tmp_path / "orbax"))
    port = Scheduler(*tuned_profile(), device="cpu",
                     noise_source=jax_noise_replay(SEED + 1))
    assert port.install_state(jrestored.export_state())
    _assert_states(jsched.export_state(), port.export_state())
    reqs = _wave(3)
    ref = jrestored.pick(reqs, eps)
    res = port.pick(convert.requests_from_numpy(reqs, device="cpu"),
                    convert.endpoints_from_numpy(eps, device="cpu"))
    _assert_results(ref, res, True)
    port.save_state(str(tmp_path / "port"))
    again = Scheduler(*tuned_profile(), device="cpu")
    assert again.restore_state(str(tmp_path / "port"))
    _assert_bit_equal(port.export_state(), again.export_state())


def test_save_during_waves_on_another_thread_is_one_consistent_state(
        tmp_path):
    """save_state reads the state under the scheduler's lock: a save made
    while another thread picks wave after wave holds the state after one
    of those waves, never a mix of two."""
    sched = _scheduler()
    eps = convert.endpoints_from_numpy(_endpoints(), device="cpu")
    states, stop = [sched.export_state()], threading.Event()

    def waves():
        w = 0
        while not stop.is_set() and w < 12:
            sched.pick(convert.requests_from_numpy(_wave(w % 4),
                                                   device="cpu"), eps)
            states.append(sched.export_state())
            w += 1

    t = threading.Thread(target=waves)
    t.start()
    saves = []
    while t.is_alive() and len(saves) < 6:
        d = tmp_path / f"s{len(saves)}"
        sched.save_state(str(d))
        saves.append(d)
    stop.set()
    t.join()
    assert saves
    for d in saves:
        fresh = Scheduler(*tuned_profile(), device="cpu")
        assert fresh.restore_state(str(d))
        got = fresh.export_state()
        assert any(int(s["tick"]) == int(got["tick"]) for s in states)
        want = next(s for s in states if int(s["tick"]) == int(got["tick"]))
        _assert_bit_equal(want, got)


def test_checkpoint_is_a_plain_npz_of_the_export_arrays(tmp_path):
    sched = _picked(_scheduler(), waves=1)
    sched.save_state(str(tmp_path))
    with zipfile.ZipFile(tmp_path / CHECKPOINT) as z:
        names = sorted(z.namelist())
    assert names == sorted(f"{k}.npy" for k in sched.export_state())
    with np.load(tmp_path / CHECKPOINT, allow_pickle=False) as z:
        assert z["prefix_present"].shape[1] == sched.state.m // 32
        assert z["assumed_load"].shape == (sched.state.m,)
        assert sched.state.m in C.M_BUCKETS
