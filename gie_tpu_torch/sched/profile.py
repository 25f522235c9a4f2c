"""Profile composition: the full scheduling cycle (port of
gie_tpu/sched/profile.py, single device).

A cycle is filter -> score (normalized, weighted blend) -> exactly one pick
-> state update (assumed load, prefix index, rr/tick, Sinkhorn duals), as
masked tensor algebra over the [N, M] grid. `Scheduler` is the facade the
data plane calls: it pads micro-batches to a bucket, runs the cycle on its
device with the state updated in place, and takes the request-termination
feedback that reconciles assumed load.

On CUDA every wave replays the cycle captured as a CUDA graph for its
(N bucket, M bucket, chunk lanes) key (sched/graphs.py), the counterpart of
the reference's compiled executable per key; warm_lattice_async captures a
lattice of keys on a background thread, as the reference compiles one. On
the CPU the cycle runs eagerly and warming runs it once on a throwaway
state.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import threading
from typing import Callable, Optional

import numpy as np
import torch

from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched import filters, pickers, prefix, scorers
from gie_tpu_torch.sched.graphs import CycleGraph
from gie_tpu_torch.sched.types import (
    EndpointBatch,
    PickResult,
    RequestBatch,
    SchedState,
    Weights,
    bucket_for,
    pad_requests,
    resize_into,
)

log = logging.getLogger(__name__)

# Later slices of the port (ROADMAP.md, Queue 1) that bring what this one
# rejects at construction.
_LATER = {
    "pd_disaggregation": "the pd dual-pick slice",
    "scorer": "the learned-scorer slice",
    "picker": "the random-picker slice",
    "predictor_fn": "the latency-predictor slice",
    "mesh": "the multi-device slice",
    "federation": "the federation slice",
    "kube": "the kube slice",
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
    wvec: Optional[torch.Tensor] = None,
):
    """Filter + score stages -> (mask, shed, named column dict,
    stacked [S,N,M], wvec [S], blended total [N,M]). `total` is None on
    the fused top-k path, whose kernel blends the columns itself (the
    reference computes it there too, and XLA drops it as dead code).
    `wvec`, when given, is the blend weights of feature_schema(cfg) as a
    tensor the caller fills (a captured cycle's static buffer); otherwise
    they come from `weights`.

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
    if wvec is None:
        wvec = _weight_vector(weights, tuple(named), mask.device)
    total = None
    if not (cfg.picker == "topk" and cfg.use_pallas_topk):
        total = blend(wvec, stacked)
    return mask, shed, named, stacked, wvec, total


def blend(wvec: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """The weighted blend of the scorer columns -> f32[N, M]."""
    return torch.einsum("s,snm->nm", wvec, stacked) / torch.clamp(
        wvec.sum(), min=1e-6)


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
    wvec: Optional[torch.Tensor] = None,
) -> tuple[PickResult, SchedState]:
    """One full scheduling cycle. Updates `state`'s tensors IN PLACE (the
    role of the reference's donated buffers) and returns (result, state).

    `gumbel` is the standard Gumbel noise f32[N, M] the sinkhorn picker's
    rounding uses (the reference draws it from its PRNG key inside the
    cycle); other pickers ignore it and take None. `wvec`: see
    build_stages. The cycle makes no call that waits for the device, so
    it can be captured into a CUDA graph (sched/graphs.py).
    """
    mask, shed, named, stacked, wvec, total = build_stages(
        state, reqs, eps, weights, cfg=cfg, wvec=wvec)

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
                 device, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard Gumbel noise f32[shape] drawn from `generator`:
    -log(-log(U)) with U clamped to [finfo.tiny, 1), the range
    jax.random.gumbel draws its uniforms from. With `out` the noise is
    drawn into it in place: the same draws, the same values."""
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.rand(shape, generator=generator, dtype=torch.float32,
               device=device, out=out)
    out.clamp_(min=torch.finfo(torch.float32).tiny)
    return out.log_().neg_().log_().neg_()


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
    cycle updates in place. Each M bucket's state is allocated once, on
    first use, and never reallocated: a bucket change fills the target
    bucket's tensors from the current one's (resize_into) and an install
    copies into them, so the addresses a captured cycle holds stay live.
    Randomness: the sinkhorn picker's Gumbel noise comes from a
    torch.Generator on the scheduler's device seeded with `seed`, or from
    `noise_source(shape) -> Tensor` when given (the parity tests replay
    the JAX scheduler's noise through it).

    Warming (the reference's compile cache, keyed (n_bucket, m,
    chunk_lanes)): on CUDA a key is warm once its cycle is captured as a
    CUDA graph, and every wave of that key replays it; a wave of a cold key
    captures it inline first and counts `warm_inline_compiles`. On the CPU
    warming runs the eager cycle once on a throwaway state.
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
        self._lock = threading.Lock()
        # One state per M bucket; `state` is the live bucket's. It starts
        # at the smallest bucket; the first pick moves it to the width the
        # caller's EndpointBatch arrives with.
        self._states: dict[int, SchedState] = {}
        self.state = self._bucket_state(C.M_BUCKETS[0])
        # Warm cache: (n_bucket, m, chunk_lanes) keys whose cycle is ready.
        self._warm_buckets: set[tuple[int, int, int]] = set()
        self._warm_lock = threading.Lock()
        # Waves that had to warm their own key first (each one a wave
        # stalled behind a capture, the stall warm_lattice_async exists to
        # remove). Reads are racy but monotonic, which is all its readers
        # need.
        self.warm_inline_compiles = 0
        # A background warm's failure, raised to the next wave of its key.
        self._warm_failures: dict[tuple[int, int, int], Exception] = {}
        # CUDA: the captured cycle of each warm key, and the stream that
        # captures run on.
        self._graphs: dict[tuple[int, int, int], CycleGraph] = {}
        self._capture_stream: Optional[torch.cuda.Stream] = None
        # CUDA: complete() calls not yet applied to the state, in order,
        # as host arrays (see complete()); _completions_lock guards only
        # the list.
        self._completions: list[tuple[np.ndarray, np.ndarray]] = []
        self._completions_lock = threading.Lock()
        if self.device.type == "cuda":
            self._prepare_kernels()
            self._capture_stream = torch.cuda.Stream(self.device)

    def _prepare_kernels(self) -> None:
        """Build and load the kernels this profile launches and check the
        Sinkhorn kernel's layout at every wave bucket, so that a kernel
        that cannot run here fails construction (KernelUnavailable) rather
        than a wave."""
        cfg = self.cfg
        sinkhorn = cfg.picker == "sinkhorn" and cfg.use_pallas_sinkhorn
        topk = cfg.picker == "topk" and cfg.use_pallas_topk
        if not (sinkhorn or topk):
            return
        from gie_tpu_torch.ops import build, fused_sinkhorn

        build.library()
        if sinkhorn:
            for n in C.N_BUCKETS:
                for m in C.M_BUCKETS:
                    fused_sinkhorn.layout(self.device, n, m)

    def _bucket_state(self, m: int) -> SchedState:
        """Bucket m's state, allocated on first use. Callers hold _lock
        (or own the scheduler, in __init__)."""
        state = self._states.get(m)
        if state is None:
            state = self._states[m] = SchedState.init(m=m, device=self.device)
        return state

    def _use_bucket(self, m: int) -> SchedState:
        """Make bucket m's state the live one, carrying the current
        bucket's over (resize_into). Caller holds
        _lock."""
        if self.state.m != m:
            self.state = resize_into(self.state, self._bucket_state(m))
        return self.state

    def _noise(self, shape: tuple,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.noise_source is None:
            return gumbel_noise(shape, self._gen, self.device, out=out)
        noise = self.noise_source(shape)
        if not torch.is_tensor(noise):
            noise = torch.from_numpy(np.array(noise, np.float32))
        noise = _to_device(noise.to(dtype=torch.float32), self.device)
        return noise if out is None else out.copy_(noise)

    def _cycle(self, state, reqs, eps, gumbel, wvec) -> PickResult:
        """The cycle a CycleGraph captures: its weights come in `wvec`."""
        return scheduling_cycle(state, reqs, eps, self.weights, gumbel,
                                cfg=self.cfg, wvec=wvec)[0]

    def _warm(self, reqs: RequestBatch, eps: EndpointBatch) -> None:
        """Make the wave shape of (reqs, eps), already padded to its N
        bucket, ready OUTSIDE the state lock without touching live state.
        On CUDA: capture its cycle over the live state of its M bucket
        (CycleGraph.capture: an eager pass on a throwaway state, then a
        capture that executes nothing); raises ops.GraphCaptureFailed. On
        the CPU: run the cycle once on a throwaway state with zero noise,
        as the reference compiles on one."""
        n, m = int(reqs.valid.shape[0]), int(eps.valid.shape[0])
        key = (n, m, int(reqs.chunk_hashes.shape[1]))
        sinkhorn = self.cfg.picker == "sinkhorn"
        if self.device.type != "cuda":
            gumbel = (torch.zeros((n, m), dtype=torch.float32,
                                  device=self.device) if sinkhorn else None)
            scheduling_cycle(
                SchedState.init(m=m, device=self.device),
                _batch_to_device(reqs, self.device),
                _batch_to_device(eps, self.device), self.weights, gumbel,
                cfg=self.cfg)
            return
        with self._lock:
            state = self._bucket_state(m)
        graph = CycleGraph(key, state, feature_schema(self.cfg), sinkhorn,
                           self.device)
        graph.capture(self._cycle, self._capture_stream, self.weights)
        self._graphs[key] = graph

    def _ensure_warm(self, key: tuple[int, int, int], wave) -> None:
        """Warm `key` inline unless it is warm: `wave()` -> the (reqs, eps)
        to warm it with. Raises a background warm's failure of this key."""
        if key in self._warm_buckets:
            return
        with self._warm_lock:
            failed = self._warm_failures.pop(key, None)
            if failed is not None:
                raise failed
            if key in self._warm_buckets:
                return
            # Inline stall: this wave waits for its own warm. The lattice
            # warmer exists to make this path unreachable in steady state.
            self.warm_inline_compiles += 1
            self._warm(*wave())
            self._warm_buckets.add(key)

    def warm_lattice_async(self, m: int, chunk_lanes: int) -> threading.Thread:
        """Warm every still-cold N bucket of the (m, chunk_lanes) lattice on
        a daemon thread, with all-invalid waves (a key is a shape, so a
        masked wave warms what a live one would). Each bucket holds
        `_warm_lock` only for its own warm, so a live cold-shape pick
        interleaves per bucket instead of waiting for the lattice. A warm
        that fails is logged and raised to the next pick_async of its
        key, and the thread stops. Returns the thread."""

        def _run() -> None:
            for n in C.N_BUCKETS:
                key = (n, m, chunk_lanes)
                if key in self._warm_buckets:
                    continue
                reqs = RequestBatch.empty(n, m, lanes=chunk_lanes)
                eps = EndpointBatch.empty(m)
                with self._warm_lock:
                    if key in self._warm_buckets:
                        continue
                    try:
                        self._warm(reqs, eps)
                    except Exception as e:
                        log.exception("warming wave shape %s failed; the "
                                      "next wave of that shape raises it",
                                      key)
                        self._warm_failures[key] = e
                        return
                    self._warm_buckets.add(key)

        t = threading.Thread(
            target=_run, name=f"warm-lattice-m{m}-c{chunk_lanes}",
            daemon=True)
        t.start()
        return t

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

        On CUDA nothing here waits for the device: the wave's inputs go up
        in one copy from pinned memory into its key's static inputs, its
        noise is drawn into the static noise buffer, the captured cycle is
        replayed, and the copies of its results down to pinned memory and
        an event after them, which PendingWave waits on, are queued, all
        on the device's current stream."""
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
        lanes = int(reqs.chunk_hashes.shape[1])
        key = (bucket, m, lanes)
        if self.device.type != "cuda":
            reqs = pad_requests(_batch_to_device(reqs, self.device), bucket)
            eps = _batch_to_device(eps, self.device)
            self._ensure_warm(key, lambda: (reqs, eps))
            with self._lock:
                state = self._use_bucket(m)
                gumbel = (self._noise((bucket, m))
                          if self.cfg.picker == "sinkhorn" else None)
                result, _ = scheduling_cycle(
                    state, reqs, eps, self.weights, gumbel, cfg=self.cfg)
                snap = state.assumed_load.clone() if snapshot_load else None
            return PendingWave(result=result, n=n, load_snapshot=snap)
        self._ensure_warm(key, lambda: (
            RequestBatch.empty(bucket, m, lanes=lanes), EndpointBatch.empty(m)))
        graph = self._graphs[key]
        staged = graph.pack(reqs, eps, self.weights)
        with self._lock:
            self._apply_completions()
            state = self._use_bucket(m)
            graph.upload(*staged)
            if graph.gumbel is not None:
                self._noise(tuple(graph.gumbel.shape), out=graph.gumbel)
            result = graph.replay()
            # Queued behind this replay and ahead of the next one, which
            # overwrites the static outputs and updates the state again:
            # the copies are this wave's, and the event follows them and
            # nothing of a later wave.
            snap = (_to_host_async(state.assumed_load) if snapshot_load
                    else None)
            host = PickResult(**{
                f.name: (None if getattr(result, f.name) is None
                         else _to_host_async(getattr(result, f.name)[:n]))
                for f in dataclasses.fields(PickResult)})
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return PendingWave(result=host, n=n, load_snapshot=snap, event=event)

    def complete(self, endpoint_slots, costs) -> None:
        """Terminated-request feedback: release each request's charge.

        On CUDA the call only queues host arrays; the next section that
        reads or writes the state under the lock (the next wave first of
        all) applies every queued call in order, as this call would have,
        before anything else. The callers are the server's stream handler
        threads, one call a stream: applied here, each would make its own
        pinned staging copies, uploads and kernel launches and free them
        again, hundreds of threads at once against the dispatcher's
        waves."""
        slots = np.array(endpoint_slots, np.int64)
        costs = np.array(costs, np.float32)
        if self.device.type == "cuda":
            with self._completions_lock:
                self._completions.append((slots, costs))
            return
        with self._lock:
            _complete_update(self.state, torch.from_numpy(slots),
                             torch.from_numpy(costs))

    def _apply_completions(self) -> None:
        """Apply the queued complete() calls to the state in order, with a
        fixed number of launches. Each call's charges are summed per slot
        (as _complete_update's index_add sums them); a slot's n-th release
        in the queue goes into layer n, so a layer names each slot once
        and its releases apply elementwise, max(load - sum, 0) per slot in
        queue order, as the calls one by one would. Caller holds _lock."""
        with self._completions_lock:
            queued, self._completions = self._completions, []
        if not queued:
            return
        m = self.state.m
        layers: list[tuple[list, list]] = []
        depth: dict[int, int] = {}
        for slots, costs in queued:
            ok = (slots >= 0) & (slots < m)   # beyond the bucket: dropped
            idx, inv = np.unique(slots[ok], return_inverse=True)
            sums = np.zeros(len(idx), np.float32)
            np.add.at(sums, inv, costs[ok])
            for slot, amount in zip(idx.tolist(), sums):
                d = depth.get(slot, 0)
                depth[slot] = d + 1
                if d == len(layers):
                    layers.append(([], []))
                layers[d][0].append(slot)
                layers[d][1].append(amount)
        if not layers:
            return
        slots = _to_device(torch.from_numpy(np.array(
            [s for layer in layers for s in layer[0]], np.int64)), self.device)
        sums = _to_device(torch.from_numpy(np.array(
            [v for layer in layers for v in layer[1]], np.float32)),
            self.device)
        load = self.state.assumed_load
        at = 0
        for layer in layers:
            k = len(layer[0])
            sl = slots[at:at + k]
            load[sl] = (load[sl] - sums[at:at + k]).clamp_(min=0.0)
            at += k

    def evict_endpoint(self, slot: int) -> None:
        """Forget an endpoint slot (pod deleted or slot reassigned): its
        prefix bits, assumed load and Sinkhorn dual."""
        with self._lock:
            self._apply_completions()
            if slot >= self.state.m:
                return  # beyond the live bucket: nothing was ever recorded
            prefix.clear_endpoint(self.state.prefix, slot)
            self.state.assumed_load[slot] = 0.0
            self.state.ot_v[slot] = 1.0

    def clear_prefix_endpoint(self, slot: int) -> None:
        """Forget an endpoint's cached chunks, keeping its assumed load
        (live-pod cache reset)."""
        with self._lock:
            self._apply_completions()
            if slot >= self.state.m:
                return
            prefix.clear_endpoint(self.state.prefix, slot)

    def explain(self, reqs: RequestBatch,
                eps: EndpointBatch) -> dict[str, np.ndarray]:
        """Debug surface: each scorer column, the blended total, the
        eligibility mask and the shed flags of a batch, as numpy rows of
        the original batch, WITHOUT touching scheduler state. Runs the
        same build_stages as the cycle (eagerly, on a copy of the state
        taken under the lock and resized when the batch's M bucket is not
        the live one), so the decomposition cannot diverge from the pick."""
        n, m = int(reqs.valid.shape[0]), int(eps.valid.shape[0])
        reqs = pad_requests(_batch_to_device(reqs, self.device), bucket_for(n))
        eps = _batch_to_device(eps, self.device)
        with self._lock:
            self._apply_completions()
            state = (_copy_state(self.state) if self.state.m == m
                     else resize_into(self.state, SchedState.init(
                         m=m, device=self.device)))
            weights = self.weights
        mask, shed, named, stacked, wvec, total = build_stages(
            state, reqs, eps, weights, cfg=self.cfg)
        if total is None:        # the fused top-k path blends in its kernel
            total = blend(wvec, stacked)
        out = {name: col[:n].cpu().numpy() for name, col in named.items()}
        out["total"] = total[:n].cpu().numpy()
        out["mask"] = mask[:n].cpu().numpy()
        out["shed"] = shed[:n].cpu().numpy()
        return out

    def debug_report(self) -> dict:
        """Scheduler zpage payload: blend weights, picker identity, state
        width and tick, device, and the warm cache."""
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
            "warm_buckets": sorted(self._warm_buckets),
            "warm_inline_compiles": self.warm_inline_compiles,
        }

    def snapshot_assumed_load(self) -> np.ndarray:
        """Host copy of the assumed-load vector (the lock covers only a
        device copy; the transfer runs outside it)."""
        with self._lock:
            self._apply_completions()
            load = self.state.assumed_load.clone()
        return load.cpu().numpy()

    # -- replication digest surface ----------------------------------------

    def export_state(self) -> dict:
        """Flat host-array dict of the full state, array-compatible with
        gie_tpu's Scheduler.export_state (uint32 table columns and
        counters)."""
        from gie_tpu_torch.convert import state_to_numpy

        with self._lock:
            self._apply_completions()
            snap = _copy_state(self.state)
        return state_to_numpy(snap)

    def prepare_install(self, arrays: dict) -> Optional[SchedState]:
        """Validate digest arrays into a SchedState on this scheduler's
        device without touching live state; None on any malformation,
        including a prefix table of another row count than this
        scheduler's (its states are allocated once, at that count)."""
        from gie_tpu_torch.convert import state_from_numpy

        try:
            restored = state_from_numpy(arrays, device=self.device)
        except (KeyError, TypeError, ValueError):
            return None
        if not check_state_shapes(restored):
            return None
        if restored.prefix.keys.shape != self.state.prefix.keys.shape:
            return None
        return restored

    def commit_install(self, state: SchedState) -> None:
        """Install a prepare_install-validated state: copied into the
        tensors of its M bucket, which becomes the live one."""
        with self._lock:
            self._apply_completions()      # then overwritten, as before
            self.state = resize_into(state, self._bucket_state(state.m))

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
