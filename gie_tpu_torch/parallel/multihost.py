"""Multi-process operation (port of gie_tpu/parallel/multihost.py).

The reference forms a multi-process JAX system and runs one SPMD program
over a global mesh. The port crosses the process boundary with
torch.distributed: every process is one position of the global mesh's dp
axis, holds only its own shard of a batch, and all-reduces what the
reference's compiled step would all-reduce (the predictor's gradients and
its loss terms). NCCL when every rank has a card of its own, gloo
otherwise (gloo all-reduces CUDA tensors too; NCCL refuses two ranks on
one card). Within a process the scheduling cycle needs no process group:
parallel/mesh.py drives every local position from one process.

Tested with two processes on the CPU (tests/test_torch_multihost.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gie_tpu_torch.parallel.mesh import Mesh


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, device=None) -> torch.device:
    """Join the process group (call once, before any collective).
    `coordinator_address` is "host:port" of process 0; `device` this
    process's device (its CUDA card by rank when there are enough, else
    the CPU). -> the device."""
    import datetime

    if device is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        device = (torch.device("cuda", process_id % n_cards) if n_cards
                  else torch.device("cpu"))
    device = torch.device(device)
    own_card = (device.type == "cuda"
                and torch.cuda.device_count() >= num_processes)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend="nccl" if own_card else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    _STATE["device"] = device
    return device


# This process's device, set by initialize with the process group it
# joins (both are per process).
_STATE: dict = {}
# How long a collective waits for the other processes.
JOIN_TIMEOUT_S = 120.0


def local_device() -> torch.device:
    return _STATE.get("device", torch.device("cpu"))


def global_mesh(tp: int = 1) -> Mesh:
    """The ("dp", "tp") mesh over every process's position, one a process
    laid out by rank (position (i, j) is rank i * tp + j); this process
    holds its own position's device only, so every position names it."""
    n = dist.get_world_size()
    if tp <= 0 or n % tp:
        raise ValueError(f"tp={tp} does not divide device count {n}")
    return Mesh([[local_device()] * tp for _ in range(n // tp)])


@dataclasses.dataclass
class HostShard:
    """This process's rows of a batch split on dp across processes: its
    own tensor, the global batch's shape and this shard's row offset. No
    process holds the global batch."""

    local: torch.Tensor
    global_shape: tuple
    offset: int


def host_local_batch_to_global(mesh: Mesh, local_batch) -> HostShard:
    """This process's shard of a batch split on dp across processes (the
    reference's make_array_from_process_local_data): the row counts are
    all-gathered so every process knows the global shape and its
    offset."""
    local = torch.as_tensor(local_batch).to(local_device())
    # NCCL gathers only card tensors, gloo any.
    rows = torch.tensor([int(local.shape[0])], dtype=torch.int64,
                        device=(local_device() if dist.get_backend() == "nccl"
                                else "cpu"))
    sizes = [torch.zeros_like(rows) for _ in range(dist.get_world_size())]
    dist.all_gather(sizes, rows)
    sizes = [int(s) for s in sizes]
    rank = dist.get_rank()
    del mesh
    return HostShard(local=local,
                     global_shape=(sum(sizes),) + tuple(local.shape[1:]),
                     offset=sum(sizes[:rank]))


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def multihost_train_step(mesh: Mesh, seed: int = 0):
    """-> (step, module, optimizer) for the predictor on the global mesh:
    a dp step over each process's batch shard with replicated params.
    step(module, optimizer, feats, slots, targets, weights) takes this
    process's rows (tensors or HostShards) and returns the global loss:
    the all-reduced sum of weighted squared errors over the all-reduced
    weight sum, the same on every process. The gradients of that loss are
    all-reduced before optimizer.step(), so every process steps its
    replica alike. Optimizer settings come from the predictor config, as
    OnlineTrainer's do."""
    from gie_tpu_torch.models.latency import LatencyPredictor, make_optimizer

    del mesh
    predictor = LatencyPredictor()
    module = predictor.module(seed).to(local_device())
    optimizer = make_optimizer(module, predictor.cfg)

    def local(x):
        return x.local if isinstance(x, HostShard) else torch.as_tensor(
            x).to(local_device())

    def step(module, optimizer, feats, slots, targets, weights):
        feats, slots, targets, weights = map(
            local, (feats, slots, targets, weights))
        pred = module(feats, slots)
        se = (weights * (pred - targets) ** 2).sum()
        totals = _all_reduce(torch.stack([se.detach(), weights.sum()]))
        denom = torch.clamp(totals[1], min=1.0)
        optimizer.zero_grad(set_to_none=True)
        (se / denom).backward()
        for p in module.parameters():
            if p.grad is not None:
                _all_reduce(p.grad)
        optimizer.step()
        return totals[0] / denom

    return step, module, optimizer
