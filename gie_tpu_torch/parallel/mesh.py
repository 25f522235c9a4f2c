"""The (dp, tp) mesh and its shards (port of gie_tpu/parallel/mesh.py).

Parallelism map (docs/MESH.md):

  dp — the request axis of the scheduling cycle: every [N, ...] tensor
       (the request batch, the cost matrix rows, the pick results) splits
       here.
  tp — the endpoint axis: every [M, ...] tensor (endpoint metrics, LoRA
       tables, assumed load, the Sinkhorn column duals, the cost matrix
       columns, the packed prefix-presence words or table slots) splits
       here, so a position holds O(N*M / (dp*tp)) of the [N, M] grid and
       O(M / tp) of each endpoint vector. The latency MLP's Dense weights
       split on tp in the training step.

The reference drives every chip from one process and GSPMD partitions the
jitted cycle. PyTorch has no GSPMD, so the port does in the open what
shard_map does: a Mesh is a (dp, tp) grid of torch.device positions, each
position holds its own shard tensors (separate tensors even where
positions share a device), and every value that crosses shards is
computed from partials gathered in a fixed mesh order (sched/profile.py's
cycle over a grid of blocks, sched/sinkhorn.py). torch.distributed comes in only across processes
(parallel/multihost.py). So the sharded cycle's picks, statuses, duals and
prefix words are bit-identical to the single-device cycle's.

Positions: on CUDA, distinct visible cards; make_mesh(n, device="cpu")
gives n virtual positions on the CPU (up to 8, the port's counterpart of
the reference's forced 8-device CPU platform); an explicit `devices` list
may repeat a device (n positions on one card).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched import prefix
from gie_tpu_torch.sched.sinkhorn import _on
from gie_tpu_torch.sched.types import (
    EndpointBatch,
    PickResult,
    PrefixTable,
    RequestBatch,
    SchedState,
    Weights,
)

# Virtual positions make_mesh gives on the CPU: the reference's tests force
# an 8-device CPU platform, and mesh axes are capped at the Sinkhorn
# solve's 8 reduction groups.
CPU_POSITIONS = 8


def _definite(device) -> torch.device:
    """`device` with a definite index on CUDA (the current card when it
    names none), as the Scheduler's own device is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A (dp, tp) grid of device positions. `shape` is {"dp": dp, "tp":
    tp}, as the reference's Mesh.shape reads; `devices[i][j]` is position
    (i, j)'s device."""

    def __init__(self, devices: list):
        if not devices or not devices[0] or any(
                len(row) != len(devices[0]) for row in devices):
            raise ValueError("a mesh is a non-empty (dp, tp) grid")
        self.devices = [[_definite(d) for d in row] for row in devices]

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    def device(self, i: int, j: int) -> torch.device:
        return self.devices[i][j]

    @property
    def distinct_devices(self) -> list:
        out: list = []
        for row in self.devices:
            for d in row:
                if d not in out:
                    out.append(d)
        return out

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, tp={self.tp}, devices="
                f"{[str(d) for d in self.distinct_devices]})")


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None, *,
              device=None, devices: Optional[list] = None) -> Mesh:
    """2-D ("dp", "tp") mesh over n positions. `tp` defaults to 2 when n is
    even, else 1. Positions: `devices` when given (a device may repeat);
    else the first n CUDA cards (the default, as every entry point runs on
    the card) or, with device="cpu", n virtual CPU positions. Asking for
    more positions than there are raises ValueError(... available)."""
    if devices is not None:
        pool = [torch.device(d) for d in devices]
    else:
        from gie_tpu_torch.sched.profile import resolve_device

        dev = resolve_device(device)
        if dev.type == "cuda":
            pool = [torch.device("cuda", k)
                    for k in range(torch.cuda.device_count())]
        else:
            pool = [dev] * CPU_POSITIONS
    n = len(pool) if n_devices is None else int(n_devices)
    if n > len(pool):
        raise ValueError(
            f"requested a {n}-device mesh but only {len(pool)} "
            f"device(s) are available")
    if n < 1:
        raise ValueError(f"a mesh needs at least one position; got {n}")
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 2 else 1
    if tp < 1 or n % tp:
        raise ValueError(f"tp={tp} does not divide the {n} positions")
    pool = pool[:n]
    return Mesh([pool[i * tp:(i + 1) * tp] for i in range(n // tp)])


# -- layouts -----------------------------------------------------------------
# A layout names, per tensor dimension, the mesh axis it splits on (None:
# whole); () is replicated: the reference's PartitionSpec. These functions
# are the one place the layout is decided: the shard helpers, ShardedState
# and the tensor-parallel MLP below cut what they return.

def state_shardings(mesh: Mesh) -> SchedState:
    """The layout of each SchedState field under `mesh`: the endpoint
    vectors (assumed load, Sinkhorn duals) split on tp; the packed
    presence matrix splits on tp, on its word axis while the smallest M
    bucket's word count divides tp (tp <= 2), else on its table slots
    (PREFIX_SLOTS divides any power-of-two tp), never replicated; keys,
    ages and the counters are replicated."""
    words = (C.M_BUCKETS[0] // 32) % mesh.tp == 0
    present = (None, "tp") if words else ("tp", None)
    return SchedState(
        prefix=PrefixTable(keys=(), present=present, ages=()),
        assumed_load=("tp",), rr=(), tick=(), ot_v=("tp",))


def cycle_shardings(mesh: Mesh) -> tuple:
    """The layouts of scheduling_cycle's inputs under `mesh`: (state,
    requests, endpoints, weights, noise). Request fields split on dp, the
    subset mask and the noise on both axes, endpoint fields on tp; the
    weights are replicated."""
    reqs = RequestBatch(**{f.name: ("dp",)
                           for f in dataclasses.fields(RequestBatch)})
    reqs = reqs.replace(subset_mask=("dp", "tp"))
    eps = EndpointBatch(**{f.name: ("tp",)
                           for f in dataclasses.fields(EndpointBatch)})
    weights = Weights(**{f.name: () for f in dataclasses.fields(Weights)})
    return state_shardings(mesh), reqs, eps, weights, ("dp", "tp")


# -- shards ------------------------------------------------------------------

def _piece(t: torch.Tensor, device: torch.device,
           whole: torch.Tensor) -> torch.Tensor:
    """A separate tensor on `device` holding block `t` of `whole`; the
    whole tensor itself where the block is all of it, on its device (a
    1 x 1 mesh's shards are its inputs)."""
    if t is whole and t.device == device:
        return t
    return t.to(device, copy=True).contiguous()


def _check_split(total: int, parts: int, what: str) -> int:
    if total % parts:
        raise ValueError(f"{what} of {total} does not split over {parts}")
    return total // parts


def _block(t: torch.Tensor, spec: tuple, i: int, j: int, mesh: Mesh,
           what: str) -> torch.Tensor:
    """Position (i, j)'s block of `t` under `spec`: a view, or `t` itself
    where no axis it splits on has more than one position."""
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        parts, k = (mesh.dp, i) if axis == "dp" else (mesh.tp, j)
        if parts == 1:
            continue
        size = _check_split(int(t.shape[d]), parts, what)
        t = t.narrow(d, k * size, size)
    return t


def _shard(mesh: Mesh, batch, layout, what: str) -> list:
    """-> [dp][tp] batches of `batch`'s type: position (i, j) holds each
    field's block under `layout`, one tensor per block and device (the
    positions of a block on one device share it)."""
    cls = type(batch)
    made: dict = {}

    def field(name: str, i: int, j: int) -> torch.Tensor:
        spec = getattr(layout, name)
        dev = mesh.device(i, j)
        key = (name, i if "dp" in spec else None,
               j if "tp" in spec else None, dev)
        if key not in made:
            t = getattr(batch, name)
            made[key] = _piece(_block(t, spec, i, j, mesh, what), dev, t)
        return made[key]

    return [[cls(**{f.name: field(f.name, i, j)
                    for f in dataclasses.fields(cls)})
             for j in range(mesh.tp)] for i in range(mesh.dp)]


def shard_requests(mesh: Mesh, reqs: RequestBatch) -> list:
    """-> [dp][tp] RequestBatch under cycle_shardings: position (i, j)
    holds rows i of every field and the (i, j) block of the subset
    mask."""
    return _shard(mesh, reqs, cycle_shardings(mesh)[1], "a request batch")


def shard_endpoints(mesh: Mesh, eps: EndpointBatch) -> list:
    """-> [dp][tp] EndpointBatch under cycle_shardings: position (i, j)
    holds endpoint shard j."""
    return _shard(mesh, eps, cycle_shardings(mesh)[2], "an endpoint batch")


def shard_noise(mesh: Mesh, gumbel: Optional[torch.Tensor]):
    """The wave's one noise draw, f32[N, M] (or [2, N, M] for a dual
    pick), cut into its [dp][tp] blocks under cycle_shardings: sharded
    noise equals unsharded noise by construction. None stays None."""
    if gumbel is None:
        return None
    spec = (None,) * (gumbel.dim() - 2) + cycle_shardings(mesh)[4]
    return [[_piece(_block(gumbel, spec, i, j, mesh, "a noise draw"),
                    mesh.device(i, j), gumbel)
             for j in range(mesh.tp)] for i in range(mesh.dp)]


def unshard_result(rows: list, device=None) -> PickResult:
    """[dp] PickResult row shards -> one PickResult on `device` (the first
    row's by default)."""
    dev = rows[0].status.device if device is None else torch.device(device)
    if len(rows) == 1 and dev == rows[0].status.device:
        return rows[0]
    fields = {}
    for f in dataclasses.fields(PickResult):
        parts = [getattr(r, f.name) for r in rows]
        fields[f.name] = (None if parts[0] is None else
                          torch.cat([_on(p, dev) for p in parts], dim=0))
    return PickResult(**fields)


@dataclasses.dataclass
class ShardedState:
    """A SchedState held as its tp shards (state_shardings' layout).

    `shards[j]` is a SchedState on position (0, j)'s device holding tp
    shard j of the endpoint vectors and of `present`, and its own replica
    of the replicated fields (keys, ages, rr, tick): every update applies
    to every replica alike, so they stay equal. The dp rows of the mesh
    read shard j (a copy where their device is another). Each shard is
    allocated once and updated in place, so a captured cycle holds its
    addresses."""

    mesh: Mesh
    shards: list
    words_axis: bool

    @staticmethod
    def init(mesh: Mesh, m: int,
             slots: int = C.PREFIX_SLOTS) -> "ShardedState":
        layout = state_shardings(mesh)

        def local(shape: tuple, spec: tuple, what: str) -> tuple:
            whole = torch.empty(shape, device="meta")
            return tuple(_block(whole, spec, 0, 0, mesh, what).shape)

        words_axis = layout.prefix.present == (None, "tp")
        (m_loc,) = local((m,), layout.assumed_load, "an endpoint width")
        shape = local((slots, m // 32), layout.prefix.present,
                      "a presence matrix")
        shards = []
        for j in range(mesh.tp):
            dev = mesh.device(0, j)
            shards.append(SchedState(
                prefix=PrefixTable(
                    keys=torch.zeros((slots,), dtype=torch.int64, device=dev),
                    present=torch.zeros(shape, dtype=torch.int64, device=dev),
                    ages=torch.zeros((slots,), dtype=torch.int64,
                                     device=dev)),
                assumed_load=torch.zeros((m_loc,), dtype=torch.float32,
                                         device=dev),
                rr=torch.zeros((), dtype=torch.int64, device=dev),
                tick=torch.zeros((), dtype=torch.int64, device=dev),
                ot_v=torch.ones((m_loc,), dtype=torch.float32, device=dev)))
        return ShardedState(mesh, shards, words_axis)

    # -- shape -----------------------------------------------------------
    @property
    def m_loc(self) -> int:
        return int(self.shards[0].assumed_load.shape[0])

    @property
    def m(self) -> int:
        return self.m_loc * len(self.shards)

    @property
    def rows(self) -> int:
        return int(self.shards[0].prefix.keys.shape[0])

    @property
    def prefix(self) -> PrefixTable:
        """Shard 0's table: its keys and ages are the replicated columns,
        its present shard 0's block only."""
        return self.shards[0].prefix

    @property
    def tick(self) -> torch.Tensor:
        return self.shards[0].tick

    def window(self, j: int) -> dict:
        """Shard j's block of the whole presence matrix, as prefix.insert
        and prefix.ingest_lanes take it."""
        words = self.m // 32
        rows, w_loc = self.shards[j].prefix.present.shape
        if self.words_axis:
            return {"row0": 0, "word0": j * int(w_loc), "words": words}
        return {"row0": j * int(rows), "word0": 0, "words": words}

    def at(self, i: int, j: int) -> SchedState:
        """Shard j as position (i, j) reads it: the shard itself on its own
        device, else a copy."""
        s, dev = self.shards[j], self.mesh.device(i, j)
        if s.assumed_load.device == dev:
            return s
        px = s.prefix
        return SchedState(
            prefix=PrefixTable(keys=px.keys.to(dev), present=px.present.to(dev),
                               ages=px.ages.to(dev)),
            assumed_load=s.assumed_load.to(dev), rr=s.rr.to(dev),
            tick=s.tick.to(dev), ot_v=s.ot_v.to(dev))

    # -- gather / scatter ------------------------------------------------
    def load(self) -> torch.Tensor:
        """The whole assumed-load vector (fresh), on shard 0's device."""
        dev = self.mesh.device(0, 0)
        return torch.cat([_on(s.assumed_load, dev) for s in self.shards])

    def gather(self) -> SchedState:
        """The whole state as one SchedState of fresh tensors on shard 0's
        device, laid out as the unsharded cycle's."""
        dev = self.mesh.device(0, 0)
        s0 = self.shards[0]
        axis = 1 if self.words_axis else 0
        return SchedState(
            prefix=PrefixTable(
                keys=s0.prefix.keys.clone(),
                present=torch.cat([_on(s.prefix.present, dev)
                                   for s in self.shards], dim=axis),
                ages=s0.prefix.ages.clone()),
            assumed_load=self.load(),
            rr=s0.rr.clone(), tick=s0.tick.clone(),
            ot_v=torch.cat([_on(s.ot_v, dev) for s in self.shards]))

    def scatter_(self, full: SchedState) -> "ShardedState":
        """Copy a whole state of this width and table into the shards, in
        place (their storage stays)."""
        if int(full.assumed_load.shape[0]) != self.m:
            raise ValueError(f"a state of width {full.m} into shards of "
                             f"width {self.m}")
        m_loc = self.m_loc
        for j, s in enumerate(self.shards):
            cols = slice(j * m_loc, (j + 1) * m_loc)
            rows, w_loc = s.prefix.present.shape
            win = self.window(j)
            block = full.prefix.present[
                win["row0"]:win["row0"] + rows,
                win["word0"]:win["word0"] + w_loc]
            s.prefix.present.copy_(block)
            s.prefix.keys.copy_(full.prefix.keys)
            s.prefix.ages.copy_(full.prefix.ages)
            s.assumed_load.copy_(full.assumed_load[cols])
            s.ot_v.copy_(full.ot_v[cols])
            s.rr.copy_(full.rr)
            s.tick.copy_(full.tick)
        return self

    def blank_like(self) -> "ShardedState":
        """A fresh sharded state of this layout with SchedState.init's
        values."""
        return ShardedState.init(self.mesh, self.m, self.rows)

    # -- facade updates, each slot sent to the shard that owns it --------
    def complete(self, slots: torch.Tensor, costs: torch.Tensor) -> None:
        """sched.profile._complete_update over the shards: each release
        subtracts from its slot's owner; slots past the width drop."""
        m_loc = self.m_loc
        for j, s in enumerate(self.shards):
            dev = s.assumed_load.device
            local = _on(slots, dev) - j * m_loc
            own = (local >= 0) & (local < m_loc)
            sub = torch.zeros((m_loc + 1,), dtype=torch.float32, device=dev)
            sub.index_add_(0, torch.where(own, local, m_loc).long(),
                           torch.where(own, _on(costs, dev),
                                       torch.zeros_like(_on(costs, dev))))
            s.assumed_load.sub_(sub[:m_loc]).clamp_(min=0.0)

    def release_layer(self, slots, amounts, to_device: Callable) -> None:
        """One layer of Scheduler._apply_releases (distinct host slots,
        their summed releases): each slot's load on its owner shard drops
        by its amount, floored at 0. `to_device(array, device)` uploads."""
        m_loc = self.m_loc
        for j, s in enumerate(self.shards):
            own = (slots >= j * m_loc) & (slots < (j + 1) * m_loc)
            if not own.any():
                continue
            dev = s.assumed_load.device
            sl = to_device(slots[own] - j * m_loc, dev)
            amt = to_device(amounts[own], dev)
            load = s.assumed_load
            load[sl] = (load[sl] - amt).clamp_(min=0.0)

    def ingest_lanes(self, hashes: torch.Tensor, ep: torch.Tensor,
                     remove: torch.Tensor, scratch=None) -> None:
        """prefix.ingest_lanes over the shards: every shard folds every
        lane into its replicated keys and ages and writes the presence
        cells it holds."""
        for j, s in enumerate(self.shards):
            dev = s.prefix.keys.device
            prefix.ingest_lanes(
                s.prefix, _on(hashes, dev), _on(ep, dev), _on(remove, dev),
                s.tick, None if scratch is None else _on(scratch, dev),
                **self.window(j))

    def clear_endpoint(self, slot: int) -> None:
        for j, s in enumerate(self.shards):
            prefix.clear_endpoint(s.prefix, slot,
                                  word0=self.window(j)["word0"])

    def evict(self, slot: int) -> None:
        """Scheduler.evict_endpoint's state update: the slot's presence
        bits, and its load and dual on its owner shard."""
        self.clear_endpoint(slot)
        j, local = divmod(slot, self.m_loc)
        self.shards[j].assumed_load[local] = 0.0
        self.shards[j].ot_v[local] = 1.0


def shard_state(mesh: Mesh, state: SchedState) -> ShardedState:
    """A new ShardedState holding `state`."""
    return ShardedState.init(mesh, state.m,
                             int(state.prefix.keys.shape[0])).scatter_(state)


def unshard_state(state: ShardedState) -> SchedState:
    return state.gather()


def sharded_cycle(mesh: Mesh, cfg, predictor_fn=None) -> Callable:
    """The scheduling cycle over `mesh`: -> cycle(state, reqs, eps,
    weights, gumbel, predictor_params=None, *, wvec=None) -> ([dp]
    PickResult row shards, state), over a ShardedState, [dp][tp] request
    and endpoint shards (shard_requests, shard_endpoints) and the noise's
    blocks (shard_noise). The state updates in place, as the unsharded
    cycle's does. Predictor params are replicated (each position reads
    them on its own device)."""
    from gie_tpu_torch.sched.profile import scheduling_cycle

    def cycle(state, reqs, eps, weights, gumbel, predictor_params=None, *,
              wvec=None):
        return scheduling_cycle(
            state, reqs, eps, weights, gumbel, cfg=cfg, wvec=wvec,
            predictor_fn=predictor_fn, predictor_params=predictor_params,
            mesh=mesh)

    return cycle


# -- the latency predictor's training step -----------------------------------

def predictor_param_shardings(mesh: Mesh, params: dict) -> dict:
    """The tensor-parallel layout of the LatencyMLP's params (torch names
    and [out, in] weights): the even Dense_i weights split their output
    features on tp (the reference's column split of the [in, out] kernel,
    P(None, "tp")), the odd ones their input features (its row split,
    P("tp", None)); biases, the embedding and other leaves are
    replicated."""
    del mesh

    def spec(name: str, x) -> tuple:
        if name.startswith("Dense_") and name.endswith(".weight") and (
                getattr(x, "ndim", len(getattr(x, "shape", ()))) == 2):
            idx = int(name[len("Dense_"):].split(".")[0])
            return ("tp", None) if idx % 2 == 0 else (None, "tp")
        return ()

    return {k: spec(k, v) for k, v in params.items()}


def _split(total: int, tp: int) -> list:
    """tp contiguous pieces of `total` features; with tp not dividing it
    (the 2-wide head at tp > 2) the first position holds them all, as
    GSPMD pads an indivisible split."""
    if total % tp:
        return [slice(0, total)] + [slice(total, total)] * (tp - 1)
    k = total // tp
    return [slice(j * k, (j + 1) * k) for j in range(tp)]


def _tp_mlp(mesh: Mesh, params: dict, layers: int, x: torch.Tensor,
            slots: torch.Tensor, i: int) -> torch.Tensor:
    """models.latency.mlp_apply on dp row i, tensor-parallel over tp as
    predictor_param_shardings lays it out: a column-split layer's output
    features over the tp positions (activations sharded), a row-split
    layer's input features (each position's partial product in f32,
    summed in tp order, then rounded to bf16 once as the whole bf16
    matmul rounds its f32 accumulation). -> f32[B, 2] on position
    (i, 0)."""
    from gie_tpu_torch.models.latency import gelu_tanh_bf16

    bf16 = torch.bfloat16
    tp = mesh.tp
    layout = predictor_param_shardings(mesh, params)
    home = mesh.device(i, 0)
    devs = [mesh.device(i, j) for j in range(tp)]
    table = params["Embed_0.weight"].to(bf16)
    emb = table[torch.clamp(slots, 0, C.M_MAX).long()]
    h = torch.cat([x.to(bf16), emb], dim=-1)          # replicated
    parts = None                                      # sharded activations
    for layer in range(layers + 1):
        w = params[f"Dense_{layer}.weight"]
        b = params[f"Dense_{layer}.bias"]
        last = layer == layers
        if layout[f"Dense_{layer}.weight"] == ("tp", None):   # column split
            outs = []
            for j, sl in enumerate(_split(w.shape[0], tp)):
                wj = _on(w[sl], devs[j])
                bj = _on(b[sl], devs[j])
                hj = _on(h, devs[j])
                if last:
                    outs.append(torch.matmul(hj.float(), wj.t()) + bj)
                else:
                    outs.append(gelu_tanh_bf16(
                        torch.matmul(hj, wj.to(bf16).t()) + bj.to(bf16)))
            parts, h = outs, None
        else:                                         # row split
            acc = None
            for j, sl in enumerate(_split(w.shape[1], tp)):
                hj = parts[j]
                wj = _on(w[:, sl], hj.device)
                if last:
                    p = torch.matmul(hj.float(), wj.t())
                else:
                    p = torch.matmul(hj.float(), wj.to(bf16).float().t())
                acc = _on(p, home) if acc is None else acc + _on(p, home)
            if last:
                out = acc + _on(b, home)
                return torch.logaddexp(out, torch.zeros_like(out))
            h, parts = gelu_tanh_bf16(acc.to(bf16) + _on(b, home).to(bf16)), None
    out = torch.cat([_on(p, home) for p in parts], dim=-1)
    return torch.logaddexp(out, torch.zeros_like(out))


def sharded_train_step(mesh: Mesh, predictor) -> Callable:
    """The predictor's train step over `mesh`, with make_train_step's
    signature: step(module, optimizer, feats, slots, targets, weights)
    -> the loss. The batch splits on dp (its rows must divide), the Dense
    weights split on tp per predictor_param_shardings, and the loss is
    the dp rows' weighted squared errors summed in dp order over their
    summed weights; autograd carries the backward pass through the
    shards into the module's params, and the optimizer steps them."""
    layers = predictor.cfg.layers

    def step(module, optimizer, feats, slots, targets, weights):
        params = dict(module.named_parameters())
        b = _check_split(int(feats.shape[0]), mesh.dp, "a training batch")
        se = wsum = None
        for i in range(mesh.dp):
            rows = slice(i * b, (i + 1) * b)
            dev = mesh.device(i, 0)
            pred = _tp_mlp(mesh, params, layers, _on(feats[rows], dev),
                           _on(slots[rows], dev), i)
            w_i = _on(weights[rows], dev)
            s_i = (w_i * (pred - _on(targets[rows], dev)) ** 2).sum()
            home = mesh.device(0, 0)
            se = _on(s_i, home) if se is None else se + _on(s_i, home)
            wi = _on(w_i.sum(), home)
            wsum = wi if wsum is None else wsum + wi
        loss = se / torch.clamp(wsum, min=1.0)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


__all__ = [
    "CPU_POSITIONS",
    "Mesh",
    "ShardedState",
    "cycle_shardings",
    "make_mesh",
    "predictor_param_shardings",
    "shard_endpoints",
    "shard_noise",
    "shard_requests",
    "shard_state",
    "sharded_cycle",
    "sharded_train_step",
    "state_shardings",
    "unshard_result",
    "unshard_state",
]
