"""Profile composition: the full scheduling cycle (port of
gie_tpu/sched/profile.py, single device).

A cycle is filter -> score (normalized, weighted blend) -> exactly one pick
-> state update (assumed load, prefix index, rr/tick, Sinkhorn duals), as
masked tensor algebra over the [N, M] grid. `Scheduler` is the facade the
data plane calls: it pads micro-batches to a bucket, runs the cycle on its
device with the state updated in place, and takes the request-termination
feedback that reconciles assumed load.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Callable, Optional

import numpy as np
import torch

from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched import filters, pickers, prefix, scorers
from gie_tpu_torch.sched.types import (
    EndpointBatch,
    PickResult,
    RequestBatch,
    SchedState,
    Weights,
    bucket_for,
    pad_requests,
    resize_state,
)

# Later slices of the port (ROADMAP.md, Queue 1) that bring what this one
# rejects at construction.
_LATER = {
    "pd_disaggregation": "the pd dual-pick slice",
    "scorer": "the learned-scorer slice",
    "picker": "the random-picker slice",
    "predictor_fn": "the latency-predictor slice",
    "mesh": "the multi-device slice",
    "resilience": "the resilience slice",
    "federation": "the federation slice",
    "background_warm": "the warm-lattice slice",
    "kube": "the kube slice",
    "obs": "the observability slice",
    "replication": "the replication slice",
    "autoscale": "the autoscale slice",
    "kv_events": "the KV-events slice",
    "fleet": "the fleet slice",
}


def _not_ported(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to gie_tpu_torch yet; it comes with "
        f"{_LATER[key]} (ROADMAP.md, Queue 1)")


@dataclasses.dataclass(frozen=True)
class ProfileConfig:
    """Static profile configuration (the reference's fields and defaults;
    see gie_tpu/sched/profile.py for each knob's rationale)."""

    queue_limit: float = 128.0
    kv_limit: float = 0.95
    pd_disaggregation: bool = False
    pd_colocation_bonus: float = 0.25
    queue_norm: float = 64.0
    load_norm: float = 32.0
    load_decay: float = 0.95
    prefix_max_age: int = 50_000
    enable_saturation: bool = True
    enable_lora: bool = True
    enable_prefix: bool = True
    enable_session: bool = True
    session_key_chunks: int = 1
    shed_sheddable: bool = True
    picker: str = "topk"         # "topk" | "sinkhorn" ("random": later slice)
    sample_temperature: float = 0.05
    sinkhorn_tau: float = 0.02
    sinkhorn_iters: int = 8
    sinkhorn_rounding_temp: float = 0.1
    # Route the topk pick through the fused blend + top-k kernel
    # (first-max tie-break instead of the rotating quantized tie-break).
    use_pallas_topk: bool = False
    # Route the Sinkhorn solve through the fused Sinkhorn kernel.
    use_pallas_sinkhorn: bool = False
    scorer: str = "blend"        # "blend" ("learned": later slice)
    record_affinity: bool = True

    def __post_init__(self) -> None:
        # The reference's own validation, in its order.
        if self.sample_temperature <= 0.0:
            raise ValueError(
                f"sample_temperature must be > 0 (got "
                f"{self.sample_temperature}): zero noise permits exact "
                "score ties, which truncate the ordered fallback list")
        if self.sinkhorn_rounding_temp <= 0.0:
            raise ValueError(
                f"sinkhorn_rounding_temp must be > 0 (got "
                f"{self.sinkhorn_rounding_temp}): zero noise permits "
                "exact score ties, which truncate the fallback list")
        if self.scorer not in ("blend", "learned"):
            raise ValueError(
                f"scorer must be 'blend' or 'learned' (got {self.scorer!r})")
        if self.scorer == "learned" and self.use_pallas_topk:
            raise ValueError(
                "scorer='learned' is incompatible with use_pallas_topk: "
                "the fused kernel hard-codes the weighted-sum blend")
        if self.scorer == "learned" and self.pd_disaggregation:
            raise ValueError(
                "scorer='learned' is incompatible with pd_disaggregation: "
                "the dual pick de-blends the linear total arithmetically")
        if self.picker not in ("topk", "random", "sinkhorn"):
            raise ValueError(
                f"unknown picker {self.picker!r}; known: topk, random, "
                "sinkhorn")
        # What this slice of the port does not carry yet.
        if self.pd_disaggregation:
            raise _not_ported("pd_disaggregation=True", "pd_disaggregation")
        if self.scorer == "learned":
            raise _not_ported("scorer='learned'", "scorer")
        if self.picker == "random":
            raise _not_ported("picker='random'", "picker")


def _affinity_columns(named: dict, primary: torch.Tensor,
                      picked_ok: torch.Tensor) -> torch.Tensor:
    """(prefix, session) scorer values at each request's primary pick
    -> f32[N, 2]; disabled columns and non-OK rows read 0.0."""
    n = primary.shape[0]
    zero = torch.zeros((n,), dtype=torch.float32, device=primary.device)
    safe = torch.clamp(primary, min=0).long()[:, None]

    def at_primary(col):
        if col is None:
            return zero
        return torch.gather(col, 1, safe)[:, 0]

    pair = torch.stack(
        [at_primary(named.get("prefix")), at_primary(named.get("session"))],
        dim=-1)
    return torch.where(picked_ok[:, None], pair, torch.zeros_like(pair))


def request_cost(reqs: RequestBatch) -> torch.Tensor:
    """Assumed cost of admitting each request, in normalized units."""
    return torch.clamp((reqs.prompt_len + reqs.decode_len) / 2048.0,
                       0.25, 8.0)


def request_cost_host(prompt_len: float, decode_len: float = 0.0) -> float:
    """Host-side twin of request_cost (completion must release exactly
    what pick time charged)."""
    return float(np.clip((prompt_len + decode_len) / 2048.0, 0.25, 8.0))


def feature_schema(cfg: ProfileConfig) -> tuple[str, ...]:
    """Ordered names of the scorer columns build_stages stacks."""
    cols = ["queue", "kv_cache", "assumed_load"]
    if cfg.enable_prefix:
        cols.append("prefix")
    if cfg.enable_session:
        cols.append("session")
    if cfg.enable_lora:
        cols.append("lora")
    return tuple(cols)


@functools.lru_cache(maxsize=64)
def _weight_vector(weights: Weights, names: tuple,
                   device: torch.device) -> torch.Tensor:
    """The blend weights of `names` as f32[S] on `device`, made once per
    (weights, columns, device): a host-to-device copy on every wave would
    make the host wait for the device's queue. Callers never write it."""
    return torch.tensor([getattr(weights, k) for k in names],
                        dtype=torch.float32, device=device)


def build_stages(
    state: SchedState,
    reqs: RequestBatch,
    eps: EndpointBatch,
    weights: Weights,
    *,
    cfg: ProfileConfig,
):
    """Filter + score stages -> (mask, shed, named column dict,
    stacked [S,N,M], wvec [S], blended total [N,M]). `total` is None on
    the fused top-k path, whose kernel blends the columns itself (the
    reference computes it there too, and XLA drops it as dead code).

    Saturation is a soft filter: unsaturated candidates are preferred;
    when all are saturated SHEDDABLE traffic is shed (429) and STANDARD
    falls back to the full candidate set (CRITICAL bypasses it)."""
    mask = filters.base_mask(reqs, eps)
    membership = (filters.lora_membership(reqs, eps) if cfg.enable_lora
                  else None)
    if cfg.enable_lora:
        mask = mask & filters.lora_capacity_mask(reqs, eps, membership)
    no_shed = torch.zeros(reqs.valid.shape, dtype=torch.bool,
                          device=mask.device)
    if cfg.enable_saturation:
        sat_mask = mask & filters.saturation_mask(
            reqs, eps, queue_limit=cfg.queue_limit, kv_limit=cfg.kv_limit)
        had_candidates = mask.any(dim=-1)
        any_unsaturated = sat_mask.any(dim=-1)
        sheddable = reqs.criticality == int(C.Criticality.SHEDDABLE)
        if cfg.shed_sheddable:
            shed = sheddable & had_candidates & ~any_unsaturated
            keep_hard = sheddable | any_unsaturated
        else:
            shed = no_shed
            keep_hard = any_unsaturated
        mask = torch.where(keep_hard[:, None], sat_mask, mask)
    else:
        shed = no_shed

    shape = mask.shape
    named: dict[str, torch.Tensor] = {
        "queue": scorers.queue_score(
            eps, queue_norm=cfg.queue_norm)[None, :].expand(shape),
        "kv_cache": scorers.kv_cache_score(eps)[None, :].expand(shape),
        "assumed_load": scorers.assumed_load_score(
            state.assumed_load, load_norm=cfg.load_norm)[None, :].expand(shape),
    }
    if cfg.enable_prefix:
        named["prefix"] = prefix.match_scores(
            state.prefix, reqs, state.tick, max_age=cfg.prefix_max_age)
    if cfg.enable_session:
        named["session"] = scorers.session_affinity_score(
            reqs, eps, key_chunks=cfg.session_key_chunks)
    if cfg.enable_lora:
        named["lora"] = scorers.lora_affinity_score(reqs, eps, membership)

    stacked = torch.stack(list(named.values()))               # [S, N, M]
    wvec = _weight_vector(weights, tuple(named), mask.device)
    total = None
    if not (cfg.picker == "topk" and cfg.use_pallas_topk):
        total = torch.einsum("s,snm->nm", wvec, stacked) / torch.clamp(
            wvec.sum(), min=1e-6)
    return mask, shed, named, stacked, wvec, total


def _pick_stage(
    total: Optional[torch.Tensor],
    stacked: torch.Tensor,
    wvec: torch.Tensor,
    mask: torch.Tensor,
    shed: torch.Tensor,
    reqs: RequestBatch,
    eps: EndpointBatch,
    state: SchedState,
    gumbel: Optional[torch.Tensor],
    cfg: ProfileConfig,
) -> tuple[PickResult, dict]:
    """The configured picker; the aux dict carries the Sinkhorn duals."""
    if cfg.picker == "topk" and cfg.use_pallas_topk:
        from gie_tpu_torch.ops.fused_topk import fused_blend_topk

        vals, idxs = fused_blend_topk(stacked, wvec, mask, k=C.FALLBACKS)
        return pickers.finalize_from_topk(
            vals, idxs, mask, shed, reqs.valid), {}
    if cfg.picker == "sinkhorn":
        from gie_tpu_torch.sched.sinkhorn import sinkhorn_picker

        if gumbel is None:
            raise ValueError("the sinkhorn picker needs a Gumbel noise tensor")
        res, v_out = sinkhorn_picker(
            total, mask, shed, reqs.valid, eps, gumbel,
            queue_limit=cfg.queue_limit,
            tau=cfg.sinkhorn_tau,
            iters=cfg.sinkhorn_iters,
            rounding_temp=cfg.sinkhorn_rounding_temp,
            use_kernel=cfg.use_pallas_sinkhorn,
            v0=state.ot_v,
        )
        return res, {"ot_v": v_out}
    return pickers.topk_picker(total, mask, shed, reqs.valid, state.rr), {}


def scheduling_cycle(
    state: SchedState,
    reqs: RequestBatch,
    eps: EndpointBatch,
    weights: Weights,
    gumbel: Optional[torch.Tensor],
    *,
    cfg: ProfileConfig,
) -> tuple[PickResult, SchedState]:
    """One full scheduling cycle. Updates `state`'s tensors IN PLACE (the
    role of the reference's donated buffers) and returns (result, state).

    `gumbel` is the standard Gumbel noise f32[N, M] the sinkhorn picker's
    rounding uses (the reference draws it from its PRNG key inside the
    cycle); other pickers ignore it and take None.
    """
    mask, shed, named, stacked, wvec, total = build_stages(
        state, reqs, eps, weights, cfg=cfg)

    result, pick_aux = _pick_stage(
        total, stacked, wvec, mask, shed, reqs, eps, state, gumbel, cfg)

    m = state.m
    primary = result.indices[:, 0]                  # i32[N], -1 on non-OK
    picked_ok = primary >= 0
    if cfg.record_affinity:
        result = result.replace(
            affinity=_affinity_columns(named, primary, picked_ok))
    cost = request_cost(reqs)
    cost = torch.where(picked_ok, cost, torch.zeros_like(cost))
    slot = torch.where(picked_ok, primary, m - 1).long()
    added = torch.zeros((m,), dtype=torch.float32,
                        device=cost.device).index_add_(0, slot, cost)
    state.assumed_load.mul_(cfg.load_decay).add_(added)

    if cfg.enable_prefix:
        prefix.insert(state.prefix, reqs, primary, state.tick)
    state.rr.add_(1).bitwise_and_(C.U32_MASK)
    state.tick.add_(1).bitwise_and_(C.U32_MASK)
    if "ot_v" in pick_aux:
        state.ot_v.copy_(pick_aux["ot_v"])
    return result, state


@dataclasses.dataclass
class PendingWave:
    """Handle to one dispatched scheduling cycle.

    On CUDA, pick_async returns with the cycle's kernels and the copies of
    its live result rows (and of the load snapshot) into pinned host
    tensors queued on the stream, followed by `event`: `materialize()`
    waits on that event alone, so it never waits for waves queued after
    this one. On the CPU the tensors are the results and `event` is None.
    """

    result: PickResult        # host tensors, rows [0, n) are live
    n: int                    # pre-padding request count
    load_snapshot: Optional[torch.Tensor] = None  # post-cycle load, host
    event: Optional[torch.cuda.Event] = None

    def _wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def materialize(self) -> PickResult:
        """-> PickResult of numpy arrays, rows [0, n)."""
        self._wait()
        return PickResult(**{
            f.name: (None if getattr(self.result, f.name) is None
                     else getattr(self.result, f.name).numpy()[: self.n])
            for f in dataclasses.fields(PickResult)})

    def materialize_load(self) -> Optional[np.ndarray]:
        if self.load_snapshot is None:
            return None
        self._wait()
        return self.load_snapshot.numpy()


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """A pinned host tensor that a copy of device tensor `t`, queued on
    the current stream, fills."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


def check_state_shapes(state: SchedState) -> bool:
    """Cross-field shape consistency of a SchedState built from external
    arrays (digest install): the width is an M bucket shared by load and
    duals, the packed presence matrix matches the table's rows and the
    bucket's word width, and the counters are scalars."""
    try:
        m = int(state.assumed_load.shape[0])
    except (TypeError, IndexError):
        return False
    px = state.prefix
    return (
        m in C.M_BUCKETS
        and tuple(state.assumed_load.shape) == (m,)
        and tuple(state.ot_v.shape) == (m,)
        and px.keys.dim() == 1
        and tuple(px.present.shape) == (int(px.keys.shape[0]), m // 32)
        and tuple(px.ages.shape) == tuple(px.keys.shape)
        and tuple(state.rr.shape) == ()
        and tuple(state.tick.shape) == ()
    )


def _complete_update(state: SchedState, slots: torch.Tensor,
                     costs: torch.Tensor) -> SchedState:
    """Request-termination feedback, in place: subtract reconciled assumed
    load. Slots beyond the state's M bucket are dropped, not clamped."""
    m = state.m
    ok = (slots >= 0) & (slots < m)
    safe = torch.where(ok, slots, torch.zeros_like(slots)).long()
    sub = torch.zeros((m,), dtype=torch.float32, device=costs.device)
    sub.index_add_(0, safe, torch.where(ok, costs, torch.zeros_like(costs)))
    state.assumed_load.sub_(sub).clamp_(min=0.0)
    return state


def gumbel_noise(shape: tuple, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Standard Gumbel noise f32[shape] drawn from `generator`:
    -log(-log(U)) with U clamped to [finfo.tiny, 1), the range
    jax.random.gumbel draws its uniforms from."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`. A host tensor bound for CUDA goes through pinned
    memory as a copy queued on the current stream: a copy from pageable
    memory would make the host wait for everything queued before it."""
    if t.device == device or device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _batch_to_device(batch, device):
    """The same batch with every tensor on `device`."""
    return type(batch)(**{
        f.name: _to_device(getattr(batch, f.name), device)
        for f in dataclasses.fields(batch)})


def resolve_device(device) -> torch.device:
    """The scheduler's device: CUDA unless the caller names another. With
    no CUDA and no explicit device this raises; it never moves to the CPU
    on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "gie_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    # A definite index: the threads that dispatch and complete waves may
    # each have another current device.
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


class Scheduler:
    """Host facade over the scheduling cycle.

    Thread-safe: calls serialize on a lock around the state, which the
    cycle updates in place. Randomness: the sinkhorn picker's Gumbel
    noise comes from a torch.Generator on the scheduler's device seeded
    with `seed`, or from `noise_source(shape) -> Tensor` when given (the
    parity tests replay the JAX scheduler's noise through it).
    """

    def __init__(
        self,
        cfg: ProfileConfig = ProfileConfig(),
        weights: Optional[Weights] = None,
        *,
        seed: int = 0,
        device=None,
        noise_source: Optional[Callable[[tuple], object]] = None,
        predictor_fn=None,
        mesh=None,
    ):
        if predictor_fn is not None:
            raise _not_ported("a predictor_fn", "predictor_fn")
        if mesh is not None:
            raise _not_ported("a mesh", "mesh")
        self.cfg = cfg
        self.weights = weights if weights is not None else Weights.default()
        self.device = resolve_device(device)
        self.noise_source = noise_source
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # State starts at the smallest M bucket; the first pick migrates it
        # to the width the caller's EndpointBatch arrives with.
        self.state = SchedState.init(m=C.M_BUCKETS[0], device=self.device)
        self._lock = threading.Lock()

    def _noise(self, shape: tuple) -> torch.Tensor:
        if self.noise_source is None:
            return gumbel_noise(shape, self._gen, self.device)
        noise = self.noise_source(shape)
        if not torch.is_tensor(noise):
            noise = torch.from_numpy(np.array(noise, np.float32))
        return _to_device(noise.to(dtype=torch.float32), self.device)

    def pick(self, reqs: RequestBatch, eps: EndpointBatch) -> PickResult:
        """Schedule a micro-batch; host-side PickResult rows for the
        original (pre-padding) batch."""
        return self.pick_async(reqs, eps).materialize()

    def pick_async(
        self,
        reqs: RequestBatch,
        eps: EndpointBatch,
        *,
        snapshot_load: bool = False,
    ) -> PendingWave:
        """Run one scheduling cycle without waiting for its results.
        `snapshot_load=True` also copies the post-cycle assumed load.

        On CUDA nothing here waits for the device: the inputs go up from
        pinned memory, the cycle and the copies of its results down to
        pinned memory are queued on the device's current stream, and an
        event recorded after them is what PendingWave waits on."""
        n = int(reqs.valid.shape[0])
        bucket = bucket_for(n)
        m = int(eps.valid.shape[0])
        if m not in C.M_BUCKETS:
            raise ValueError(
                f"EndpointBatch width {m} is not an M bucket {C.M_BUCKETS}")
        if int(reqs.subset_mask.shape[1]) != m:
            raise ValueError(
                f"subset_mask width {reqs.subset_mask.shape[1]} != "
                f"endpoint width {m}")
        reqs = pad_requests(_batch_to_device(reqs, self.device), bucket)
        eps = _batch_to_device(eps, self.device)
        on_cuda = self.device.type == "cuda"
        with self._lock:
            if self.state.m != m:
                self.state = resize_state(self.state, m)
            gumbel = (self._noise((bucket, m))
                      if self.cfg.picker == "sinkhorn" else None)
            result, self.state = scheduling_cycle(
                self.state, reqs, eps, self.weights, gumbel, cfg=self.cfg)
            if not on_cuda:
                snap = (self.state.assumed_load.clone() if snapshot_load
                        else None)
                return PendingWave(result=result, n=n, load_snapshot=snap)
            # Queued behind this cycle and ahead of the next one's in-place
            # updates, so the snapshot is this cycle's state; the event
            # follows this wave's copies and nothing of a later wave.
            snap = (_to_host_async(self.state.assumed_load) if snapshot_load
                    else None)
            host = PickResult(**{
                f.name: (None if getattr(result, f.name) is None
                         else _to_host_async(getattr(result, f.name)[:n]))
                for f in dataclasses.fields(PickResult)})
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return PendingWave(result=host, n=n, load_snapshot=snap, event=event)

    def complete(self, endpoint_slots, costs) -> None:
        """Terminated-request feedback: release each request's charge."""
        slots = _to_device(torch.from_numpy(
            np.asarray(endpoint_slots, np.int64)), self.device)
        costs = _to_device(torch.from_numpy(
            np.asarray(costs, np.float32)), self.device)
        with self._lock:
            self.state = _complete_update(self.state, slots, costs)

    def evict_endpoint(self, slot: int) -> None:
        """Forget an endpoint slot (pod deleted or slot reassigned): its
        prefix bits, assumed load and Sinkhorn dual."""
        with self._lock:
            if slot >= self.state.m:
                return  # beyond the live bucket: nothing was ever recorded
            prefix.clear_endpoint(self.state.prefix, slot)
            self.state.assumed_load[slot] = 0.0
            self.state.ot_v[slot] = 1.0

    def clear_prefix_endpoint(self, slot: int) -> None:
        """Forget an endpoint's cached chunks, keeping its assumed load
        (live-pod cache reset)."""
        with self._lock:
            if slot >= self.state.m:
                return
            prefix.clear_endpoint(self.state.prefix, slot)

    def debug_report(self) -> dict:
        """Scheduler zpage payload: blend weights, picker identity, state
        width and tick, device."""
        state = self.state
        return {
            "picker": self.cfg.picker,
            "pd_disaggregation": self.cfg.pd_disaggregation,
            "m_bucket": state.m,
            "tick": int(state.tick),
            "weights": {
                f.name: round(float(getattr(self.weights, f.name)), 5)
                for f in dataclasses.fields(Weights)
            },
            "device": str(self.device),
        }

    def snapshot_assumed_load(self) -> np.ndarray:
        """Host copy of the assumed-load vector (the lock covers only a
        device copy; the transfer runs outside it)."""
        with self._lock:
            load = self.state.assumed_load.clone()
        return load.cpu().numpy()

    # -- replication digest surface ----------------------------------------

    def export_state(self) -> dict:
        """Flat host-array dict of the full state, array-compatible with
        gie_tpu's Scheduler.export_state (uint32 table columns and
        counters)."""
        from gie_tpu_torch.convert import state_to_numpy

        with self._lock:
            snap = _copy_state(self.state)
        return state_to_numpy(snap)

    def prepare_install(self, arrays: dict) -> Optional[SchedState]:
        """Validate digest arrays into a SchedState on this scheduler's
        device without touching live state; None on any malformation."""
        from gie_tpu_torch.convert import state_from_numpy

        try:
            restored = state_from_numpy(arrays, device=self.device)
        except (KeyError, TypeError, ValueError):
            return None
        return restored if check_state_shapes(restored) else None

    def commit_install(self, state: SchedState) -> None:
        """Swap in a prepare_install-validated state."""
        with self._lock:
            self.state = state

    def install_state(self, arrays: dict) -> bool:
        """Validated inverse of export_state; False keeps the prior state."""
        prepared = self.prepare_install(arrays)
        if prepared is None:
            return False
        self.commit_install(prepared)
        return True


def _copy_state(state: SchedState) -> SchedState:
    px = state.prefix
    return SchedState(
        prefix=px.replace(keys=px.keys.clone(), present=px.present.clone(),
                          ages=px.ages.clone()),
        assumed_load=state.assumed_load.clone(),
        rr=state.rr.clone(), tick=state.tick.clone(),
        ot_v=state.ot_v.clone())
