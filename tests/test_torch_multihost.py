"""The port's multi-process path (gie_tpu_torch/parallel/multihost.py): two
OS processes join one gloo process group over tcp:// on the CPU and run
one dp-sharded predictor train step whose loss terms and gradients
all-reduce across the process boundary, as tests/test_multihost.py runs
the reference's over two JAX processes.

Each process supplies only its own 8 rows (the reference worker's batch,
from numpy seeded with its rank). Both start from the reference's
LatencyPredictor params of PRNGKey(0), carried over with convert.py, so
both ranks' loss must be the same, within rtol 1e-6 of the port's own
one-process step on the two shards concatenated (only the f32 order of
the loss terms' sum differs), and within rtol 3e-4 of the reference's
single-device step on them: the port's bf16 MLP differs from the
reference's by 1.01e-4 of this loss in one process, so a bound of 1e-4
cannot hold and 3e-4 is the bound just above that reading. Each rank's
stepped params are held to the reference's stepped params as the
predictor tests hold one train step: every element within two learning
rates, and 99% of them within 1e-5. A first Adam step moves an element
by about one learning rate in its gradient's sign, so a gradient that
was not all-reduced flips the step of many elements and fails the
second bound.

This file is also the worker: `python tests/test_torch_multihost.py
<rank> <world> <port> <params.npz>` (it imports no JAX then). The test
spawns both workers once, with a timeout of its own, and every case reads
that one run.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

PER_HOST = 8
WORKER_TIMEOUT_S = 120


def _batch(rank: int):
    """The reference worker's per-process batch (tests/multihost_worker.py)."""
    from gie_tpu_torch.models.latency import NUM_FEATURES

    rng = np.random.default_rng(rank)
    feats = rng.uniform(0, 1, (PER_HOST, NUM_FEATURES)).astype(np.float32)
    slots = rng.integers(0, 8, (PER_HOST,)).astype(np.int32)
    targets = rng.uniform(0, 1, (PER_HOST, 2)).astype(np.float32)
    weights = np.ones((PER_HOST, 2), np.float32)
    return feats, slots, targets, weights


def _worker(rank: int, world: int, port: str, params_path: str) -> None:
    import torch

    from gie_tpu_torch import convert
    from gie_tpu_torch.parallel import multihost

    device = multihost.initialize(f"127.0.0.1:{port}", world, rank,
                                  device="cpu")
    try:
        mesh = multihost.global_mesh(tp=1)
        step, module, optimizer = multihost.multihost_train_step(mesh)
        with np.load(params_path) as f:
            tree = {"params": {}}
            for key in f.files:
                mod, leaf = key.split("/")
                tree["params"].setdefault(mod, {})[leaf] = f[key]
        module.load_state_dict(convert.predictor_params_from_numpy(
            tree, device=device))
        shards = [multihost.host_local_batch_to_global(mesh, a)
                  for a in _batch(rank)]
        loss = step(module, optimizer, *shards)
        digest = float(sum(p.detach().double().sum()
                           for p in module.parameters()))
        np.savez(f"{params_path}.rank{rank}.npz",
                 **{k: v.detach().cpu().numpy()
                    for k, v in module.state_dict().items()})
        print("MULTIHOST_OK " + json.dumps({
            "rank": rank, "world": torch.distributed.get_world_size(),
            "mesh": mesh.shape, "backend": torch.distributed.get_backend(),
            "global_rows": shards[0].global_shape[0],
            "offset": shards[0].offset, "local_rows": int(
                shards[0].local.shape[0]),
            "loss": float(loss), "params_sum": digest}), flush=True)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_RUN: dict = {}


def _run(tmp_path_factory):
    """Spawn the two workers once; -> (their reports, the reference loss)."""
    if _RUN:
        return _RUN["reports"], _RUN["ref_loss"]
    import jax
    import jax.numpy as jnp
    import optax

    from gie_tpu.models.latency import LatencyPredictor, make_train_step

    predictor = LatencyPredictor()
    params = predictor.init(jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("multihost") / "params.npz"
    flat = {f"{mod}/{leaf}": np.asarray(v, np.float32)
            for mod, leaves in params["params"].items()
            for leaf, v in leaves.items()}
    np.savez(path, **flat)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), "2", port,
         str(path)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append(out)
            assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = [json.loads(line.split(" ", 1)[1]) for out in outs
               for line in out.splitlines()
               if line.startswith("MULTIHOST_OK ")]

    batches = [_batch(rank) for rank in range(2)]
    whole = [np.concatenate([b[k] for b in batches]) for k in range(4)]
    tx = optax.adamw(predictor.cfg.learning_rate,
                     weight_decay=predictor.cfg.weight_decay)
    step = make_train_step(predictor, tx)
    new, _, loss = step(params, tx.init(params), *(jnp.asarray(a)
                                                   for a in whole))
    stepped = []
    for rank in range(2):
        with np.load(f"{path}.rank{rank}.npz") as f:
            stepped.append({k: f[k] for k in f.files})
    _RUN.update(reports=reports, ref_loss=float(loss),
                port_loss=_port_single_loss(params, whole),
                ref_params=_torch_layout(new), stepped=stepped)
    return reports, float(loss)


def _torch_layout(params) -> dict:
    """The reference's params as numpy arrays under the port's names."""
    import jax

    from gie_tpu_torch import convert

    return {k: v.numpy() for k, v in convert.predictor_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu").items()}


def _port_single_loss(params, whole) -> float:
    """The port's make_train_step on the concatenated batch, in this
    process, from the same carried params."""
    import torch

    from gie_tpu_torch import convert
    from gie_tpu_torch.models.latency import (
        LatencyPredictor,
        make_optimizer,
        make_train_step,
    )

    predictor = LatencyPredictor()
    module = predictor.module(0)
    module.load_state_dict(convert.predictor_params_from_numpy(
        params, device="cpu"))
    return float(make_train_step(predictor)(
        module, make_optimizer(module, predictor.cfg),
        *(torch.from_numpy(a) for a in whole)))


def test_two_process_global_train_step(tmp_path_factory):
    reports, _ = _run(tmp_path_factory)
    assert sorted(r["rank"] for r in reports) == [0, 1]
    for r in reports:
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["mesh"] == {"dp": 2, "tp": 1}
    # Both ranks computed the same loss and stepped their replicas alike
    # (the gradients all-reduced across the process boundary).
    assert len({r["loss"] for r in reports}) == 1
    assert len({r["params_sum"] for r in reports}) == 1


def test_each_rank_holds_only_its_shard(tmp_path_factory):
    reports, _ = _run(tmp_path_factory)
    by_rank = {r["rank"]: r for r in reports}
    for rank, r in by_rank.items():
        assert r["global_rows"] == 2 * PER_HOST
        assert r["local_rows"] == PER_HOST
        assert r["offset"] == rank * PER_HOST


def test_loss_matches_reference_single_device_step(tmp_path_factory):
    reports, ref_loss = _run(tmp_path_factory)
    port_loss = _RUN["port_loss"]
    for r in reports:
        assert abs(r["loss"] - port_loss) <= 1e-6 * abs(port_loss), (
            r["loss"], port_loss)
        assert abs(r["loss"] - ref_loss) <= 3e-4 * abs(ref_loss), (
            r["loss"], ref_loss)


def test_stepped_params_match_reference_single_device_step(
        tmp_path_factory):
    _run(tmp_path_factory)
    from gie_tpu_torch.models.latency import LatencyPredictor

    lr = LatencyPredictor().cfg.learning_rate
    want = _RUN["ref_params"]
    for rank, got in enumerate(_RUN["stepped"]):
        assert sorted(got) == sorted(want)
        close = total = 0
        for k, v in got.items():
            diff = np.abs(v - want[k])
            assert float(diff.max()) <= 2 * lr + 1e-5, (rank, k)
            close += int((diff <= 1e-5).sum())
            total += diff.size
        assert close >= 0.99 * total, (rank, close, total)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
