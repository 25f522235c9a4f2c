"""BatchingTPUPicker: micro-batching bridge from per-stream picks to the
batched scheduling cycle (port of gie_tpu/sched/batching.py).

Ext-proc opens one stream per HTTP request, so concurrent Process threads
enqueue here; a collector thread drains the queue every `max_wait_s` (or
at `max_batch`) and runs ONE scheduling cycle for the whole wave.

The collector is a TWO-STAGE pipeline (docs/PIPELINE.md): the dispatcher
drains the queue, assembles the wave with vectorized numpy column ops, and
dispatches the cycle asynchronously (Scheduler.pick_async: on CUDA the
cycle and the copies of its results are queued on the stream, and the
handle's event marks their end); a completer thread waits on that event,
materializes the results and fans them out. The card runs cycle k while
the host assembles cycle k+1, and a bounded in-flight depth caps the tail
latency a dispatched wave can accumulate behind its predecessors.

With a ResilienceState (`resilience=`), each wave first asks the
degradation ladder whether it takes the device cycle (always at FULL; as
a probe at probe cadence while degraded) or is answered host-side on a
degraded rung (`_degraded_pick`: numpy over the MetricsStore's host rows,
no device state touched, nothing charged), and quarantined endpoints
leave each request's candidates. A failed dispatch or materialize
answers its wave degraded instead of failing it, except for a kernel
that cannot run here at all (ops.KernelUnavailable: build, load or shape
refused), which fails the wave as it does without a ResilienceState: the
Scheduler builds its kernels at construction, so that error belongs to
the deployment, not to a sick device (a cycle that cannot be captured
into a CUDA graph raises its subclass GraphCaptureFailed, and fails its
wave the same way). While a flight recorder
is installed (obs.RECORDER), the completer writes one decision record
per request from host arrays only.

With `background_warm=True` (the runner's wiring) the dispatcher's first
wave of each (M bucket, chunk lanes) lattice hands the rest of its N
buckets to Scheduler.warm_lattice_async, which captures their cycles on a
background thread, so a later wave of another size replays a graph
instead of capturing one inline.

With `federation=` (a FederationState) each wave first runs the spill
policy: an item whose local candidates are all saturated gains the
imported peer endpoints, and under a whole-cluster drain its candidates
become the peers'. Imported endpoints are slots of the same slot space,
so the wave goes through the same captured cycle and kernels.

With `trainer=` (a models.latency.OnlineTrainer) each dispatch also
copies the post-cycle assumed load, the completer records each pick's
feature row (`PickResult.feedback`), served feedback trains the TTFT head
and response completion the TPOT head, and SLO admission sheds picks
whose predicted TTFT misses their x-gateway-inference-ttft-slo-ms bound
before the waiters wake (the predictor's forward runs on the trainer's
own stream, never behind the queued waves).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from gie_tpu_torch import obs
from gie_tpu_torch.api.types import LITERAL_BANDS
from gie_tpu_torch.extproc import metadata as mdkeys
from gie_tpu_torch.extproc.pick import (
    INTERNAL,
    INVALID_ARGUMENT,
    UNAVAILABLE,
    ExtProcError,
    PickRequest,
    PickResult,
    ShedError,
)
from gie_tpu_torch.fairness import FairnessState
from gie_tpu_torch.models.latency import host_features
from gie_tpu_torch.ops import KernelUnavailable
from gie_tpu_torch.resilience import deadline as deadline_mod
from gie_tpu_torch.resilience import faults
from gie_tpu_torch.resilience.ladder import ResilienceState, Rung
from gie_tpu_torch.runtime import metrics as own_metrics
from gie_tpu_torch.runtime.clock import MONOTONIC, Clock
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.filters import drain_filter
from gie_tpu_torch.sched.hashing import batch_chunk_hashes
from gie_tpu_torch.sched.profile import (
    Scheduler,
    pd_costs_host,
    request_cost_host,
)
from gie_tpu_torch.sched.types import (
    RequestBatch,
    chunk_bucket_for,
    m_bucket_for,
)
from gie_tpu_torch.utils.lora import LoraRegistry

_BAND_NAMES = {
    int(C.Criticality.CRITICAL): "critical",
    int(C.Criticality.STANDARD): "standard",
    int(C.Criticality.SHEDDABLE): "sheddable",
}


def _band_for(headers: dict, registry=None) -> int:
    """Scheduler band from the objective header: a registered
    InferenceObjective name (proposal 1199) or a literal band name."""
    value = headers.get(mdkeys.OBJECTIVE_KEY, [""])[0]
    if registry is not None:
        band = registry.resolve_band(value)
        if band is not None:
            return band
    return LITERAL_BANDS.get(value.lower().strip(),
                             int(C.Criticality.STANDARD))


def _ctx_tenant(ctx) -> str:
    """Fairness ID from a stream's captured headers (the response hops
    have the RequestContext, not the _Pending)."""
    vals = getattr(ctx, "headers", None)
    vals = vals.get(mdkeys.FLOW_FAIRNESS_ID_KEY) if vals else None
    return (vals[0] if isinstance(vals, list) and vals
            and isinstance(vals[0], str) else "")


def _fair_order(items: list["_Pending"]) -> list["_Pending"]:
    """Criticality bands first, weighted deficit-round-robin by fairness
    ID within a band (docs/FAIRNESS.md). This module-level form is
    STATELESS (uniform weights, fresh deficits) for tests and direct
    callers; the picker itself orders through its persistent
    FairnessState."""
    from gie_tpu_torch.fairness.drr import DeficitRoundRobin

    return DeficitRoundRobin().order(items)


class _Pending:
    __slots__ = ("req", "candidates", "event", "result", "error",
                 "enqueued_at", "abandoned", "band", "cand_slots",
                 "excl_breaker", "excl_drain", "tenant", "cost",
                 "fed_remote", "fed_base")

    def __init__(self, req: PickRequest, candidates: list,
                 band: Optional[int] = None,
                 now: Optional[float] = None):
        self.req = req
        self.candidates = candidates
        self.event = threading.Event()
        self.result: Optional[PickResult] = None
        self.error: Optional[Exception] = None
        # Clock-seam timestamp: age sheds and queue-wait metrics compare
        # this against the picker's clock.
        self.enqueued_at = MONOTONIC.now() if now is None else now
        # Set when the caller's pick() wait expired: the collector must DROP
        # the item rather than schedule it — a scheduled pick charges assumed
        # load that no served feedback will ever release.
        self.abandoned = False
        # Criticality band resolved ONCE, at enqueue. pick() resolves
        # through the objective registry; direct constructions (tests)
        # fall back to literal band names.
        self.band = _band_for(req.headers) if band is None else band
        # Candidate slot ids as a dense vector: wave assembly and the hold
        # check index numpy arrays instead of iterating endpoint objects.
        self.cand_slots = np.fromiter(
            (getattr(ep, "slot", -1) for ep in candidates),
            np.int64, len(candidates))
        # Slots the wave-level filters excluded for THIS item (flight-
        # recorder provenance): breaker quarantine and graceful drain.
        # Empty tuples until a filter actually fires.
        self.excl_breaker: tuple = ()
        self.excl_drain: tuple = ()
        # Imported peer-cluster slots the federation spill policy ADDED to
        # this item's candidate set (flight-recorder provenance), and the
        # pre-spill candidate list, kept so a drain CANCELLED while this
        # item is held can restore its local set (None until federation
        # first mutates).
        self.fed_remote: tuple = ()
        self.fed_base = None
        # Tenant identity + request cost, resolved ONCE at enqueue for the
        # fairness layer; cost shares request_cost_host's units.
        vals = req.headers.get(mdkeys.FLOW_FAIRNESS_ID_KEY)
        self.tenant = (vals[0] if isinstance(vals, list) and vals
                       and isinstance(vals[0], str) else "")
        self.cost = request_cost_host(
            float(len(req.body) if req.body else 0.0),
            float(req.decode_tokens or 0.0) * C.CHARS_PER_TOKEN)


def assemble_wave(
    batch: list["_Pending"], mb: int, lora_registry: LoraRegistry
) -> tuple[RequestBatch, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized host assembly of one wave: numpy COLUMN ops over the
    pending items, not a per-request Python loop.

    Returns (RequestBatch of CPU tensors, plen, dlen, lora): the wave in
    the reference's row order (the order of `batch`), u32 chunk hashes
    as int64, plus the host columns the completer's fan-out re-reads.
    """
    n = len(batch)
    prompts = [it.req.body or b"" for it in batch]
    hashes, counts = batch_chunk_hashes(prompts)
    # Chunk-axis bucket: short-prompt waves run 8/16 prefix lanes.
    cb = chunk_bucket_for(int(counts.max()) if n else 1)
    hashes = hashes[:, :cb]
    # LoRA ids: one registry lookup per DISTINCT model, in first-occurrence
    # order, so new-adapter id assignment matches a per-item loop.
    ids = {it.req.model: -1 for it in batch}
    for name in ids:
        ids[name] = lora_registry.id_for(name)
    lora = np.fromiter((ids[it.req.model] for it in batch), np.int32, n)
    crit = np.fromiter((it.band for it in batch), np.int32, n)
    plen = np.fromiter((len(p) for p in prompts), np.float32, n)
    # Decode-length hint in prompt-char-equivalents; charge and release
    # share this one array.
    dlen = np.float32(C.CHARS_PER_TOKEN) * np.fromiter(
        (it.req.decode_tokens or 0.0 for it in batch), np.float32, n)
    # Subset mask via one flat scatter: rows repeated by candidate count,
    # columns from the cached per-item slot vectors.
    n_cands = np.fromiter((it.cand_slots.size for it in batch), np.intp, n)
    rows = np.repeat(np.arange(n), n_cands)
    cols = (np.concatenate([it.cand_slots for it in batch])
            if n else np.zeros((0,), np.int64))
    ok = (cols >= 0) & (cols < mb)
    mask = np.zeros((n, mb), bool)
    mask[rows[ok], cols[ok]] = True

    reqs = RequestBatch(
        valid=torch.ones((n,), dtype=torch.bool),
        lora_id=torch.from_numpy(lora),
        criticality=torch.from_numpy(crit),
        prompt_len=torch.from_numpy(plen),
        decode_len=torch.from_numpy(dlen),
        chunk_hashes=torch.from_numpy(hashes.astype(np.int64)),
        n_chunks=torch.from_numpy(counts),
        subset_mask=torch.from_numpy(mask),
    )
    return reqs, plen, dlen, lora


class _Wave:
    """One dispatched wave in flight between dispatcher and completer."""

    __slots__ = ("batch", "pending", "endpoints", "eps_metrics", "plen",
                 "dlen", "lora")

    def __init__(self, batch, pending, endpoints, eps_metrics, plen, dlen,
                 lora):
        self.batch = batch            # list[_Pending], waiters to wake
        self.pending = pending        # profile.PendingWave
        self.endpoints = endpoints    # datastore endpoints at dispatch time
        # The wave's metrics rows as the CPU EndpointBatch holds them (the
        # flight recorder's scorer breakdown and the trainer's feature
        # rows; never the device copy).
        self.eps_metrics = eps_metrics
        self.plen = plen
        self.dlen = dlen
        self.lora = lora


# Sentinel the dispatcher pushes on close(): the completer drains every
# wave queued BEFORE it, then exits — in-flight picks complete, never hang.
_CLOSE = object()


class _WaveQueue:
    """Unbounded FIFO between dispatcher and completer, built on a
    Condition threaded through the Clock seam (``queue.Queue``'s internal
    waits are invisible to a virtual clock). ``get`` raises
    ``queue.Empty``; ``put`` never blocks."""

    def __init__(self, clock: Clock):
        self._clock = clock
        self._items: list = []
        self._cond = threading.Condition()

    def put(self, item, timeout: Optional[float] = None) -> None:
        del timeout  # unbounded: put never blocks (queue.Queue parity)
        with self._cond:
            self._items.append(item)
            self._clock.notify(self._cond)

    def get(self, timeout: Optional[float] = None):
        """One bounded receive: an empty queue waits at most ``timeout``
        (a wake with nothing to take raises ``queue.Empty`` early)."""
        with self._cond:
            if not self._items:
                self._clock.wait(self._cond, timeout)
                if not self._items:
                    raise queue.Empty
            return self._items.pop(0)

    def get_nowait(self):
        with self._cond:
            if not self._items:
                raise queue.Empty
            return self._items.pop(0)

    def empty(self) -> bool:
        return not self._items


class BatchingTPUPicker:
    """EndpointPicker backed by the batched Scheduler."""

    _M_SHRINK_PATIENCE = 64  # consecutive smaller-bucket waves before shrink
    _DEPTH_RETUNE_WAVES = 32  # auto pipeline-depth retune cadence

    def __init__(
        self,
        scheduler: Scheduler,
        datastore,
        metrics_store,
        *,
        max_wait_s: float = 0.002,
        max_batch: int = C.N_BUCKETS[-1],
        lora_registry: Optional[LoraRegistry] = None,
        trainer=None,
        hold_max_s: float = 0.0,
        hold_queue_limit: float = 128.0,
        hold_retry_s: float = 0.01,
        pick_timeout_s: float = 60.0,
        pd_budget_floor_s: float = 0.0,
        queue_bound: int = 0,
        queue_max_age_s: float = 0.0,
        pipeline_depth=2,
        background_warm: bool = False,
        resilience: Optional[ResilienceState] = None,
        fairness: Optional[FairnessState] = None,
        federation=None,
        clock: Clock = MONOTONIC,
    ):
        # Clock seam: every BEHAVIORAL read of time in the pick path goes
        # through this clock. Pipeline stage times stay on the real clock
        # (they are observability, not behavior).
        self._clock = clock
        self.scheduler = scheduler
        self.datastore = datastore
        self.metrics_store = metrics_store
        self.max_wait_s = max_wait_s
        self.max_batch = max_batch
        # MUST be the same registry the metrics scraper interns adapter
        # names through, or affinity compares ids from two unrelated spaces.
        self.lora_registry = (lora_registry if lora_registry is not None
                              else LoraRegistry())
        # Online latency-predictor training (models.latency.OnlineTrainer):
        # picks carry their feature rows, recorded and completed by served
        # feedback; None = no predictor.
        self.trainer = trainer
        # Optional objective registry resolving named InferenceObjectives
        # to criticality bands (proposal 1199): anything with resolve_band.
        self.objective_registry = None
        # Flow-control wait queueing: when > 0, non-critical requests whose
        # every candidate is saturated are HELD and re-scheduled until
        # capacity frees or the hold deadline passes (then best-effort).
        self.hold_max_s = hold_max_s
        self.hold_queue_limit = hold_queue_limit
        self.hold_retry_s = hold_retry_s
        self.pick_timeout_s = pick_timeout_s
        # Budget-aware pd split: a disaggregated pick whose remaining
        # deadline budget is below this floor collapses to the decode
        # worker only (the cross-worker prefill hop would eat the budget).
        # 0 disables; the runner wires --pd-budget-floor-ms.
        self.pd_budget_floor_s = pd_budget_floor_s
        # Flow-control queue BOUNDS (proposal 0683): queue_bound > 0 caps
        # pending depth (an arrival into a full queue evicts a strictly-
        # lower-criticality waiter or is itself shed with 429);
        # queue_max_age_s > 0 sheds non-critical items that waited longer.
        if queue_bound < 0 or queue_max_age_s < 0:
            raise ValueError("queue bounds must be non-negative")
        if 0 < queue_max_age_s <= hold_max_s:
            # An age bound inside the hold window would shed every held
            # pick on its first retry.
            raise ValueError(
                f"queue_max_age_s ({queue_max_age_s}) must exceed "
                f"hold_max_s ({hold_max_s}) when both are enabled")
        self.queue_bound = queue_bound
        self.queue_max_age_s = queue_max_age_s
        # Endpoint-axis (M) bucket: sized to the datastore's high-water
        # slot, grown immediately, shrunk only after _M_SHRINK_PATIENCE
        # consecutive waves fit the smaller bucket. Collector-thread-only.
        self._m_bucket = C.M_BUCKETS[0]
        self._m_shrink_streak = 0
        self._pending: list[_Pending] = []
        self._cond = threading.Condition()
        self._closed = False
        # Two-stage pipeline: the in-flight bound is the backpressure seam
        # (depth ~2 keeps the card fed without stacking tail latency).
        # pipeline_depth="auto" derives the bound 1-3 from the measured
        # host-assembly / device-wait ratio, retuned every
        # _DEPTH_RETUNE_WAVES waves: host-bound (>= 2x) -> 1, balanced
        # (0.5x..2x) -> 3, device-bound (< 0.5x) -> 2.
        self._depth_auto = pipeline_depth == "auto"
        if self._depth_auto:
            pipeline_depth = 2
        if not isinstance(pipeline_depth, int) or pipeline_depth < 1:
            raise ValueError('pipeline_depth must be >= 1 or "auto"')
        self._depth_limit = pipeline_depth
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        # Stage-time EWMAs feeding the auto policy, each written from its
        # own stage's thread and read racily by the retune.
        self._asm_ewma = 0.0
        self._cycle_ewma = 0.0
        self._depth_waves = 0
        self._depth_want_prev = pipeline_depth
        self._waves = _WaveQueue(clock)
        # Background lattice warming: the first wave of a new (m,
        # chunk_lanes) lattice kicks Scheduler.warm_lattice_async for the
        # rest of its N buckets. Opt-in (the runner turns it on): the warm
        # threads contend for the host, which latency tests that build
        # this picker directly must not absorb. Dispatcher-thread-only.
        self.background_warm = background_warm
        self._warmed_lattices: set[tuple[int, int]] = set()
        self._warm_threads: list[threading.Thread] = []
        # Multi-tenant fairness (docs/FAIRNESS.md): weighted-DRR flow
        # ordering, per-tenant budgets and the over-fair-share shed.
        self.fairness = (fairness if fairness is not None
                         else FairnessState(clock=clock.now))
        # Unified resilience layer (resilience/, docs/RESILIENCE.md):
        # breaker board filtering candidates, degradation ladder deciding
        # per WAVE whether this wave takes the full device path, a probe
        # wave, or a host-side degraded pick. None = no ladder.
        self.resilience = resilience
        # Multi-cluster federation (federation/): imported peer endpoints
        # join candidate sets through the spill policy at wave cadence.
        # None = single cluster.
        self.federation = federation
        # Smooth-weighted-round-robin credit per slot and the static-
        # subset rotation cursor (degraded rungs; collector/completer
        # threads only — the two never pick the same wave).
        self._wrr_credit: dict[int, float] = {}
        self._static_rr = 0
        self._degraded_lock = threading.Lock()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        self._completer = threading.Thread(
            target=self._completer_loop, daemon=True)
        self._completer.start()

    # -- EndpointPicker interface -----------------------------------------

    def pick(self, req: PickRequest, candidates: list) -> PickResult:
        if not candidates:
            # Scale-from-zero wake signal: an arrival against an EMPTY pool
            # is recorded before the 503.
            note = getattr(self.metrics_store, "note_empty_pool_arrival", None)
            eps = getattr(self.datastore, "endpoints", lambda: ())
            if note is not None and not eps():
                note()
            raise ExtProcError(UNAVAILABLE, "no endpoints available")
        try:
            band = _band_for(req.headers, self.objective_registry)
        except Exception as e:
            # A malformed objective header fails THIS request at its own
            # call site, never the collector's pre-batch section.
            raise ExtProcError(
                INVALID_ARGUMENT,
                f"malformed objective header: {type(e).__name__}: {e}")
        item = _Pending(req, candidates, band=band,
                        now=self._clock.now())
        self.fairness.note_arrival(item.tenant, item.cost)
        tr = req.trace
        if tr is not None:
            tr.event("queued")
        with self._cond:
            if self._closed:
                raise ExtProcError(UNAVAILABLE, "picker shut down")
            if self.queue_bound > 0 and len(self._pending) >= self.queue_bound:
                self._admit_into_full_queue(band, tenant=item.tenant)
            self._pending.append(item)
            own_metrics.QUEUE_DEPTH.set(len(self._pending))
            self._clock.notify(self._cond)
        # Bounded wait: a wedged collector fails the stream instead of
        # hanging the caller's thread forever.
        if not self._clock.wait_event(
                item.event, self.hold_max_s + self.pick_timeout_s):
            item.abandoned = True
            raise ExtProcError(UNAVAILABLE, "scheduler did not respond in time")
        if item.error is not None:
            raise item.error
        if item.result is None:
            raise ExtProcError(INTERNAL, "pick woke without a result")
        return item.result

    def _admit_into_full_queue(self, band: int, tenant: str = "") -> None:
        """Overload policy for a full flow-control queue (caller holds the
        lock): drop an abandoned waiter if one exists, else evict the
        newest waiter of the lowest band present (strictly lower than the
        arrival's; an over-share tenant's waiter first), else shed the
        arrival. Raises ShedError when the arrival loses."""
        for i in range(len(self._pending) - 1, -1, -1):
            if self._pending[i].abandoned:
                del self._pending[i]
                return
        worst_i, worst_band = -1, band
        for i in range(len(self._pending) - 1, -1, -1):
            b = self._pending[i].band
            if b > worst_band:
                worst_i, worst_band = i, b
                if b == int(C.Criticality.SHEDDABLE):
                    break  # no worse band exists
        if worst_i < 0:
            own_metrics.QUEUE_SHED.labels(
                reason="depth", band=_BAND_NAMES.get(band, "standard")).inc()
            self.fairness.note_shed(
                tenant, _BAND_NAMES.get(band, "standard"))
            raise ShedError("flow-control queue full",
                            band=band, tenant=tenant)
        over = self.fairness.over_share_set()
        if over:
            for i in range(len(self._pending) - 1, -1, -1):
                it = self._pending[i]
                if it.band == worst_band and it.tenant in over:
                    worst_i = i
                    break
        victim = self._pending.pop(worst_i)
        victim.error = ShedError("evicted by higher-criticality arrival",
                                 band=victim.band, tenant=victim.tenant)
        victim.event.set()
        own_metrics.QUEUE_SHED.labels(
            reason="evicted",
            band=_BAND_NAMES.get(worst_band, "standard")).inc()
        self.fairness.note_shed(
            victim.tenant, _BAND_NAMES.get(worst_band, "standard"))

    def _preemptive_shed(self, batch: list["_Pending"],
                         over: frozenset) -> list["_Pending"]:
        """SLO-tier enforcement under saturation (docs/FAIRNESS.md):
        SHEDDABLE items of over-fair-share tenants shed 429 when every
        candidate endpoint is past the scheduler's queue saturation bound.
        CRITICAL and STANDARD are never touched here."""
        host_q = getattr(self.metrics_store, "host_queue_depths", None)
        cfg = getattr(self.scheduler, "cfg", None)
        limit = float(getattr(cfg, "queue_limit", 0.0) or 0.0)
        if host_q is None or limit <= 0.0:
            return batch
        queues = host_q()
        kept: list[_Pending] = []
        for it in batch:
            if (it.band != int(C.Criticality.SHEDDABLE)
                    or it.tenant not in over):
                kept.append(it)
                continue
            slots = it.cand_slots
            slots = slots[(slots >= 0) & (slots < queues.shape[0])]
            if slots.size and bool(np.all(queues[slots] >= limit)):
                it.error = ShedError(
                    "tenant over fair share under saturation",
                    band=it.band, tenant=it.tenant)
                self._clock.set_event(it.event)
                own_metrics.QUEUE_SHED.labels(
                    reason="tenant", band="sheddable").inc()
                self.fairness.note_shed(it.tenant, "sheddable")
            else:
                kept.append(it)
        return kept

    def observe_served(self, served_hostport: str, ctx) -> None:
        """Served-endpoint feedback -> assumed-load release + data-plane
        serve outcome (breaker, ladder, metrics and the tenant ledger) +
        the latency predictor's TTFT training signal."""
        pick_result = getattr(ctx, "pick_result", None)
        self._release_charge(pick_result, served_hostport)
        status = int(getattr(ctx, "resp_status", 0) or 0)
        primary = getattr(pick_result, "endpoint", "")
        rec = getattr(pick_result, "record", None)
        if rec is not None:
            # Close the flight-recorder record with what the data plane
            # actually did: who served, which fallback rank Envoy walked
            # to, the observed verdict and serve latency. Field writes
            # on a published dict are GIL-atomic; zpage reads snapshot.
            rec["served"] = served_hostport
            ranked = [primary] + list(
                getattr(pick_result, "fallbacks", None) or [])
            rec["fallback_rank"] = (
                ranked.index(served_hostport)
                if served_hostport in ranked else -1)
            if status > 0:
                rec["outcome"] = f"{status // 100}xx"
                picked_at = float(getattr(ctx, "picked_at", 0.0) or 0.0)
                if picked_at:
                    rec["serve_latency_ms"] = round(max(
                        self._clock.now() - picked_at, 0.0) * 1e3, 1)
        if primary and served_hostport and served_hostport != primary:
            # Envoy walked the fallback list: the primary refused the
            # connection or reset before the fallback served.
            self._note_serve_outcome(primary, ok=False, cls="reset")
        if status > 0:
            picked_at = float(getattr(ctx, "picked_at", 0.0) or 0.0)
            latency_s = (
                max(self._clock.now() - picked_at, 0.0) if picked_at else 0.0)
            self._note_serve_outcome(
                served_hostport, ok=status < 500,
                cls=f"{status // 100}xx", latency_s=latency_s,
                trace=getattr(ctx, "trace", None),
                tenant=_ctx_tenant(ctx))
            if status >= 500:
                # An errored serve trains nothing: a fast local-reply 503
                # would teach the predictor that the sick endpoint is the
                # most attractive one in the pool.
                return
        feedback = getattr(pick_result, "feedback", None)
        if self.trainer is not None and feedback is not None:
            features, slot, picked_at, picked_hostport = feedback
            if served_hostport != picked_hostport:
                # Failover to a fallback: the recorded features describe
                # the PRIMARY endpoint, so this latency would mislabel it.
                return
            elapsed = max(self._clock.now() - picked_at, 1e-4)
            # Response headers arrive about at the first token: elapsed
            # approximates TTFT; TPOT is unobservable at this hop (its
            # head is masked) and arrives with observe_response_complete.
            self.trainer.observe(features, ttft_s=elapsed, tpot_s=None,
                                 slot=slot)

    def _release_charge(self, pick_result, served_hostport: str = "") -> None:
        """Release the assumed load the cycle CHARGED (the primary pick,
        or both pd workers), not that of whichever endpoint served (on
        failover the primary's charge would leak). Slot-reuse guard: if a
        charged endpoint was evicted, its eviction already cleared the
        slot's load."""
        cost = getattr(pick_result, "assumed_cost", 1.0)
        charged = getattr(pick_result, "charged", None)
        if charged:
            # Disaggregated: release every charged worker whose slot still
            # belongs to the charged hostport.
            slots, costs = [], []
            for slot, slot_cost, hostport in charged:
                ep = self.datastore.endpoint_by_hostport(hostport)
                if ep is not None and ep.slot == slot:
                    slots.append(slot)
                    costs.append(slot_cost)
            if slots:
                self.scheduler.complete(np.asarray(slots, np.int32),
                                        np.asarray(costs, np.float32))
            return
        release_slot = None
        charged_slot = getattr(pick_result, "charged_slot", None)
        primary = getattr(pick_result, "endpoint", None)
        if charged_slot is not None and primary is not None:
            ep = self.datastore.endpoint_by_hostport(primary)
            if ep is not None and ep.slot == charged_slot:
                release_slot = charged_slot
        elif served_hostport:  # pick results without bookkeeping
            ep = self.datastore.endpoint_by_hostport(served_hostport)
            if ep is not None:
                release_slot = ep.slot
        if release_slot is not None:
            self.scheduler.complete(
                np.asarray([release_slot], np.int32),
                np.asarray([cost], np.float32),
            )

    def observe_stream_aborted(self, ctx) -> None:
        """Stream-teardown feedback: the stream ended after a pick but
        BEFORE response headers, so the release observe_served would have
        made happens here. A reset outcome is counted against the primary
        only when the end was ABNORMAL (ctx.aborted)."""
        pick_result = getattr(ctx, "pick_result", None)
        if pick_result is None:
            return
        self._release_charge(pick_result)
        primary = getattr(pick_result, "endpoint", "")
        aborted = getattr(ctx, "aborted", True)
        rec = getattr(pick_result, "record", None)
        if rec is not None:
            rec["outcome"] = "reset" if aborted else "closed"
        if primary and aborted:
            self._note_serve_outcome(primary, ok=False, cls="reset",
                                     tenant=_ctx_tenant(ctx))

    def _note_serve_outcome(self, hostport: str, ok: bool, cls: str,
                            latency_s: float = 0.0, trace=None,
                            tenant: str = "") -> None:
        """Fan one data-plane serve outcome into the resilience layer:
        gie_serve_outcome_total, the serving endpoint's breaker (windowed
        error-rate + streak), the ladder's pool-wide serve floor, the
        outlier ejector and the per-tenant budget ledger. A head-sampled
        request's serve-latency observation carries a trace-ID exemplar
        (docs/OBSERVABILITY.md)."""
        own_metrics.SERVE_OUTCOME.labels(cls).inc()
        if latency_s > 0.0:
            if trace is not None and getattr(trace, "sampled", False):
                own_metrics.SERVE_LATENCY.observe(
                    latency_s, {"trace_id": trace.trace_id})
            else:
                own_metrics.SERVE_LATENCY.observe(latency_s)
        self.fairness.note_serve(tenant, ok=ok, cls=cls)
        rs = self.resilience
        if rs is None:
            return
        ep = self.datastore.endpoint_by_hostport(hostport)
        if ep is not None and rs.board.record_serve_outcome(
                ep.slot, ok, latency_s=latency_s):
            # State transition: refresh the gauge here rather than
            # paying open_count()'s lock per request.
            own_metrics.BREAKER_OPEN.set(rs.board.open_count())
        if (ep is not None and ok and latency_s > 0.0
                and rs.ejector is not None):
            # p99 outlier ejection input: only SUCCESSFUL serves'
            # latencies — a fast local-reply 503 would drag a sick
            # endpoint's quantile down. The eval itself runs at wave
            # cadence (ResilienceState.observe).
            rs.ejector.note(ep.slot, latency_s)
        rs.ladder.note_serve_outcome(ok)

    def observe_response_complete(self, ctx) -> None:
        """Response-stream-complete feedback -> the TPOT training signal:
        the response-body hop harvests the output token count and the
        first and last body-chunk times, whose quotient is the measured
        per-token latency. Trains the TPOT head only (the TTFT half was
        observed at the response-headers hop)."""
        if self.trainer is None:
            return
        if (getattr(ctx, "aborted", False)
                or int(getattr(ctx, "resp_status", 0) or 0) >= 500):
            return   # a reset or errored stream's timing is the failure's
        pick_result = getattr(ctx, "pick_result", None)
        feedback = getattr(pick_result, "feedback", None)
        if feedback is None:
            return
        features, slot, _picked_at, picked_hostport = feedback
        served = getattr(ctx, "served_hostport", "")
        if served and served != picked_hostport:
            return   # failover: the features describe the primary
        if not getattr(ctx, "timing_is_generation", False):
            # Buffered JSON split across network flushes: chunk spacing
            # measures the proxy's write cadence, not token generation.
            return
        tokens = int(getattr(ctx, "resp_tokens", 0))
        t0 = getattr(ctx, "resp_first_at", 0.0)
        t1 = getattr(ctx, "resp_last_at", 0.0)
        if tokens < 2 or t1 <= t0:
            return   # a single chunk: no inter-token interval exists
        tpot = (t1 - t0) / (tokens - 1)
        self.trainer.observe(features, ttft_s=None, tpot_s=tpot, slot=slot)

    def queue_report(self) -> dict:
        """Flow-queue zpage: live depth, per-band composition, and the
        oldest waiter's age."""
        now = self._clock.now()
        with self._cond:
            items = list(self._pending)
        bands: dict[str, int] = {}
        oldest = 0.0
        for it in items:
            name = _BAND_NAMES.get(it.band, str(it.band))
            bands[name] = bands.get(name, 0) + 1
            oldest = max(oldest, now - it.enqueued_at)
        return {
            "depth": len(items),
            "bands": bands,
            "oldest_wait_ms": round(oldest * 1e3, 1),
            "queue_bound": self.queue_bound,
            "queue_max_age_s": self.queue_max_age_s,
            "pipeline_depth_limit": self._depth_limit,
            "waves_in_flight": self._inflight,
        }

    def tenants_report(self) -> dict:
        """Per-tenant zpage: live queue composition joined with the
        fairness layer's budgets, weights, verdicts and DRR deficits."""
        with self._cond:
            pending = [(it.tenant, it.band) for it in self._pending]
        per_tenant: dict[str, dict[str, int]] = {}
        for tenant, band in pending:
            per = per_tenant.setdefault(tenant or "default", {})
            name = _BAND_NAMES.get(band, str(band))
            per[name] = per.get(name, 0) + 1
        rep = self.fairness.report()
        rep["queue"] = per_tenant
        rep["queue_depth"] = len(pending)
        return rep

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._clock.notify(self._cond)
        self._worker.join(timeout=5)
        # DRAIN, don't abandon: the sentinel is FIFO-ordered behind every
        # wave the dispatcher already pushed.
        self._waves.put(_CLOSE)
        self._completer.join(timeout=5)
        if not self._completer.is_alive():
            # A dispatcher that outlived its join can push a wave AFTER
            # the sentinel: fail those waiters now.
            while True:
                try:
                    wave = self._waves.get_nowait()
                except queue.Empty:
                    break
                if wave is _CLOSE:
                    continue
                for item in wave.batch:
                    if item.result is None and item.error is None:
                        item.error = ExtProcError(
                            UNAVAILABLE, "picker shut down")
                    self._clock.set_event(item.event)
                with self._inflight_cv:
                    self._inflight -= 1
                    self._clock.notify_all(self._inflight_cv)
        # A lattice warm still capturing must not outlive its picker into
        # interpreter shutdown.
        for t in self._warm_threads:
            t.join(timeout=60)

    # -- collector ---------------------------------------------------------

    def _loop(self) -> None:
        tok = self._clock.actor_begin("picker-collector")
        try:
            self._loop_inner()
        finally:
            self._clock.actor_end(tok)

    def _loop_inner(self) -> None:
        # The collector must NEVER die: every path that can raise fails the
        # affected waiters and keeps looping.
        while True:
            batch: list[_Pending] = []
            try:
                with self._cond:
                    while not self._pending and not self._closed:
                        self._clock.wait(self._cond)
                    if self._closed and not self._pending:
                        return
                    # Micro-batch window: collect stragglers before draining.
                    if len(self._pending) < self.max_batch:
                        self._clock.wait(self._cond, self.max_wait_s)
                    if len(self._pending) > self.max_batch:
                        # When demand exceeds one cycle, weighted DRR across
                        # fairness IDs; only the drained prefix charges the
                        # persistent deficit state.
                        self._pending = self.fairness.order(
                            self._pending, take=self.max_batch)
                    batch = self._pending[: self.max_batch]
                    self._pending = self._pending[self.max_batch :]
                    own_metrics.QUEUE_DEPTH.set(len(self._pending))
                held = self._run_batch(batch)
            except Exception as e:  # propagate to all waiters
                if not batch:
                    # Failure in the pre-batch section: the poisoned item
                    # is still queued and would wedge the loop — fail the
                    # whole queue rather than hang it.
                    with self._cond:
                        batch, self._pending = self._pending, []
                        own_metrics.QUEUE_DEPTH.set(0)
                for item in batch:
                    # A fresh exception per waiter (handler threads raise
                    # them concurrently), caused by the wave's failure.
                    item.error = ExtProcError(
                        INTERNAL, f"scheduler failure: {e}")
                    item.error.__cause__ = e
                    self._clock.set_event(item.event)
                continue
            if held:
                with self._cond:
                    # Held items rejoin at the HEAD; pace retries only when
                    # nothing NEW is waiting.
                    new_arrivals = len(self._pending) > 0
                    self._pending = held + self._pending
                    own_metrics.QUEUE_DEPTH.set(len(self._pending))
                    if not new_arrivals:
                        self._clock.wait(self._cond, self.hold_retry_s)

    def _retune_depth(self) -> None:
        """pipeline_depth="auto": the in-flight bound 1-3 from the measured
        stage-time ratio. A change applies only when two consecutive
        retunes agree. Dispatcher-thread only."""
        cycle = self._cycle_ewma
        if cycle <= 0.0 or self._asm_ewma <= 0.0:
            return  # no completed wave measured yet
        ratio = self._asm_ewma / cycle
        if ratio >= 2.0:
            want = 1
        elif ratio >= 0.5:
            want = 3
        else:
            want = 2
        agreed, self._depth_want_prev = want == self._depth_want_prev, want
        if not agreed or want == self._depth_limit:
            return
        with self._inflight_cv:
            self._depth_limit = want
            self._clock.notify_all(self._inflight_cv)

    def _pick_m_bucket(self, endpoints) -> int:
        """Endpoint-axis bucket for this wave: smallest M bucket covering
        the high-water live slot. Grows immediately; shrinks only after
        _M_SHRINK_PATIENCE consecutive waves fit the smaller bucket.
        Collector-thread only."""
        high = 1 + max((ep.slot for ep in endpoints), default=-1)
        needed = m_bucket_for(max(high, 1))
        if needed > self._m_bucket:
            self._m_bucket = needed
            self._m_shrink_streak = 0
        elif needed < self._m_bucket:
            self._m_shrink_streak += 1
            if self._m_shrink_streak >= self._M_SHRINK_PATIENCE:
                self._m_bucket = needed
                self._m_shrink_streak = 0
        else:
            self._m_shrink_streak = 0
        return self._m_bucket

    def _run_batch(self, batch: list[_Pending]) -> list["_Pending"]:
        """Pipeline stage 1 (dispatcher): shed/hold decisions, vectorized
        wave assembly, async cycle dispatch, handoff to the completer.
        Returns the held items the collector should requeue. Blocks only
        when `pipeline_depth` waves are already in flight."""
        # Timed-out callers are gone: scheduling their items would charge
        # assumed load that nothing would release.
        batch = [it for it in batch if not it.abandoned]
        if batch:
            # Deadline propagation: a pick whose budget expired while
            # queued sheds with 503 BEFORE the wave charges device work.
            now = self._clock.now()
            kept: list[_Pending] = []
            for it in batch:
                d = it.req.deadline_at
                if d and now >= d:
                    it.error = deadline_mod.DeadlineExceeded("queue")
                    self._clock.set_event(it.event)
                    own_metrics.DEADLINE_SHED.labels(stage="queue").inc()
                else:
                    kept.append(it)
            batch = kept
        if self.queue_max_age_s > 0 and batch:
            # Age bound: a non-critical pick that waited beyond the bound
            # sheds with 429 instead of occupying a wave slot.
            now = self._clock.now()
            kept = []
            for it in batch:
                if (
                    it.band != int(C.Criticality.CRITICAL)
                    and now - it.enqueued_at > self.queue_max_age_s
                ):
                    it.error = ShedError("queued beyond flow-control age bound",
                                         band=it.band, tenant=it.tenant)
                    self._clock.set_event(it.event)
                    own_metrics.QUEUE_SHED.labels(
                        reason="age",
                        band=_BAND_NAMES.get(it.band, "standard")).inc()
                    self.fairness.note_shed(
                        it.tenant, _BAND_NAMES.get(it.band, "standard"))
                else:
                    kept.append(it)
            batch = kept
        if batch:
            # Preemptive per-tenant shed under saturation; with nobody
            # over budget this is one read and a falsy branch.
            over = self.fairness.over_share_set()
            if over:
                batch = self._preemptive_shed(batch, over)
        if not batch:
            return []
        # Graceful-drain housekeeping at wave cadence: reap expired drains,
        # export the gauge, drop DRAINING endpoints from each item's
        # candidate set (drain_filter keeps a set it would empty).
        draining_count = getattr(self.datastore, "draining_count", None)
        if draining_count is not None:
            self.datastore.reap_expired_drains()
            n_draining = draining_count()
            own_metrics.DRAINING_ENDPOINTS.set(n_draining)
            if n_draining:
                for it in batch:
                    allowed = drain_filter(it.candidates)
                    if allowed is not it.candidates:
                        it.excl_drain = tuple(
                            int(getattr(ep, "slot", -1))
                            for ep in it.candidates
                            if getattr(ep, "draining", False))
                        it.candidates = allowed
                        it.cand_slots = np.fromiter(
                            (getattr(ep, "slot", -1) for ep in allowed),
                            np.int64, len(allowed))
        # Federation spillover, decided per wave BEFORE the hold check: a
        # pick whose local candidates are all saturated gains the imported
        # peer endpoints (penalized in the cost model) instead of being
        # held to die, and under whole-cluster drain the preference
        # inverts (new picks bleed to healthy peers). An upstream-pinned
        # subset never spills; CRITICAL never crosses while local
        # candidates exist (FederationState.spill_candidates owns the band
        # rules). Host-only: observe() and the queue column read no
        # device state.
        fed = self.federation
        if fed is not None and (fed.has_peers() or fed.draining):
            fed.observe()
            queues_f = self.metrics_store.host_queue_depths()
            for it in batch:
                if getattr(it.req, "subset", False):
                    continue
                if it.fed_remote:
                    # Already spilled on a prior cycle (a HELD item
                    # re-enters): re-appending would duplicate remotes, so
                    # the set is kept — EXCEPT when the drain flag flipped
                    # since the spill: a drain-REPLACED item whose drain
                    # was cancelled comes home (restore the pre-spill
                    # locals and re-evaluate), and a spill-APPENDED item
                    # caught by a newly-raised drain drops its locals.
                    was_replaced = all(
                        getattr(ep, "cluster", "") for ep in it.candidates)
                    if was_replaced == bool(fed.draining):
                        continue  # decision still matches the flag
                    if it.fed_base is not None:
                        it.candidates = it.fed_base
                    it.fed_remote = ()
                    it.cand_slots = np.fromiter(
                        (getattr(ep, "slot", -1) for ep in it.candidates),
                        np.int64, len(it.candidates))
                remote = fed.spill_candidates(
                    it.band, it.cand_slots, queues_f)
                if not remote:
                    continue
                it.fed_base = list(it.candidates)
                it.fed_remote = tuple(
                    int(getattr(ep, "slot", -1)) for ep in remote)
                if fed.draining:
                    # Drain bleed: local endpoints leave NEW-pick
                    # candidacy (spill_candidates returned None if no
                    # healthy peer exists — availability beats drain).
                    it.candidates = list(remote)
                else:
                    it.candidates = list(it.candidates) + list(remote)
                it.cand_slots = np.fromiter(
                    (getattr(ep, "slot", -1) for ep in it.candidates),
                    np.int64, len(it.candidates))
        # Flow-control hold, decided BEFORE any scheduling so a held
        # request never touches device state: non-critical, within the
        # hold window, and EVERY candidate saturated.
        held: list[_Pending] = []
        if self.hold_max_s > 0:
            queues = self.metrics_store.host_queue_depths()
            now = self._clock.now()
            runnable: list[_Pending] = []
            for it in batch:
                slots = it.cand_slots
                slots = slots[(slots >= 0) & (slots < C.M_MAX)]
                if (
                    it.band != C.Criticality.CRITICAL
                    and now - it.enqueued_at < self.hold_max_s
                    and bool(np.all(queues[slots] >= self.hold_queue_limit))
                ):
                    d = it.req.deadline_at
                    if d and d - now < 2.0 * self.hold_retry_s:
                        # Budget-aware hold: the remaining deadline cannot
                        # survive another retry window — pick now.
                        own_metrics.HOLD_BUDGET_BYPASS.inc()
                        runnable.append(it)
                    else:
                        tr_h = it.req.trace
                        if tr_h is not None and (
                                not tr_h.events
                                or tr_h.events[-1][0] != "held"):
                            # One event per hold SPELL, not per retry.
                            tr_h.event("held")
                        held.append(it)
                else:
                    runnable.append(it)
            batch = runnable
            if not batch:
                return held
        # Drained-cost ledger: this batch IS the wave (full device path or
        # degraded rung alike).
        self.fairness.note_wave(batch)
        rs = self.resilience
        if rs is not None:
            # Per-WAVE resilience decision (never per request): fold the
            # staleness clock into the ladder, then either serve this
            # wave host-side on the current degraded rung or let it
            # through the full device path (always when FULL; as a probe
            # at probe cadence while level-degraded).
            rs.observe()
            rung = rs.ladder.rung()
            if rung != Rung.FULL and not rs.ladder.should_probe():
                self._degraded_pick(batch, rung)
                return held
            if rs.board.has_open:
                # Breaker candidate filter: quarantined endpoints drop
                # out of each item's candidate set — unless that would
                # empty it (availability beats quarantine; the breaker's
                # own half-open probes need traffic to heal).
                for it in batch:
                    allowed, dropped = [], []
                    for ep in it.candidates:
                        if rs.board.quarantined(getattr(ep, "slot", -1)):
                            dropped.append(ep)
                        else:
                            allowed.append(ep)
                    if allowed and dropped:
                        it.excl_breaker = tuple(
                            int(getattr(ep, "slot", -1)) for ep in dropped)
                        it.candidates = allowed
                        it.cand_slots = np.fromiter(
                            (getattr(ep, "slot", -1) for ep in allowed),
                            np.int64, len(allowed))
        t0 = time.perf_counter()
        n = len(batch)
        endpoints = self.datastore.endpoints()
        mb = self._pick_m_bucket(endpoints)
        own_metrics.BATCH_SIZE.observe(n)
        reqs, plen, dlen, lora = assemble_wave(batch, mb, self.lora_registry)
        eps = self.metrics_store.endpoint_batch(endpoints, m_slots=mb)
        # Async dispatch: the cycle is queued on the card and the host
        # returns. A failure here fails this wave's waiters, or, with a
        # resilience state, answers them degraded.
        try:
            if faults.ENABLED:
                faults.check("device.dispatch")
            # With a trainer the post-cycle load is copied too: the
            # completer's feature rows read the load the wave left, as the
            # reference's (and the simulator's feature twin) do.
            pending = self.scheduler.pick_async(
                reqs, eps, snapshot_load=self.trainer is not None)
        except KernelUnavailable:
            raise  # a kernel that cannot run here is no sick device
        except Exception:
            if rs is None:
                raise  # the collector fails the waiters
            # Device dispatch failed: feed the ladder and serve THIS wave
            # host-side at CACHED or worse — a sick device must cost a
            # slower pick, never an UNAVAILABLE storm.
            rs.ladder.note_dispatch_error()
            self._degraded_pick(
                batch, Rung(max(rs.ladder.rung(), Rung.CACHED)))
            return held
        lattice = (mb, int(reqs.chunk_hashes.shape[1]))
        if self.background_warm and lattice not in self._warmed_lattices:
            self._warmed_lattices.add(lattice)
            self._warm_threads.append(
                self.scheduler.warm_lattice_async(*lattice))
        asm_s = time.perf_counter() - t0
        own_metrics.HOST_ASSEMBLY.observe(asm_s)
        if self._depth_auto:
            self._asm_ewma = (asm_s if self._asm_ewma == 0.0
                              else 0.9 * self._asm_ewma + 0.1 * asm_s)
            self._depth_waves += 1
            if self._depth_waves >= self._DEPTH_RETUNE_WAVES:
                self._depth_waves = 0
                self._retune_depth()
        # Backpressure: block while `_depth_limit` waves are in flight.
        with self._inflight_cv:
            while self._inflight >= self._depth_limit:
                self._clock.wait(self._inflight_cv)
            self._inflight += 1
        own_metrics.PIPELINE_DEPTH.inc()
        own_metrics.PIPELINE_WAVES.inc()
        self._waves.put(
            _Wave(batch, pending, endpoints, eps.metrics, plen, dlen, lora))
        return held

    # -- completer (pipeline stage 2) --------------------------------------

    def _completer_loop(self) -> None:
        tok = self._clock.actor_begin("picker-completer")
        try:
            self._completer_loop_inner()
        finally:
            self._clock.actor_end(tok)

    def _completer_loop_inner(self) -> None:
        # Strictly dispatch-ordered and, like the dispatcher, it must NEVER
        # die: a failure touches only its own wave's waiters.
        while True:
            # Bounded receive: exit once the dispatcher is gone AND the
            # queue is verifiably empty (or at the sentinel).
            try:
                wave = self._waves.get(timeout=1.0)
            except queue.Empty:
                if (self._closed and not self._worker.is_alive()
                        and self._waves.empty()):
                    return
                continue
            if wave is _CLOSE:
                return
            # Release the in-flight slot at PICKUP, not completion: the
            # next wave's assembly may overlap this wave's fan-out.
            with self._inflight_cv:
                self._inflight -= 1
                self._clock.notify_all(self._inflight_cv)
            try:
                self._complete_wave(wave)
            except Exception as e:
                for item in wave.batch:
                    if item.result is None and item.error is None:
                        item.error = ExtProcError(
                            INTERNAL, f"scheduler failure: {e}")
                        item.error.__cause__ = e
                    self._clock.set_event(item.event)
            finally:
                own_metrics.PIPELINE_DEPTH.dec()

    def _complete_wave(self, wave: _Wave) -> None:
        """Materialize one wave's results (waiting on its own event only)
        and fan them out."""
        batch, plen, dlen, lora = wave.batch, wave.plen, wave.dlen, wave.lora
        rs = self.resilience
        t0 = time.perf_counter()
        try:
            result = wave.pending.materialize()
        except KernelUnavailable:
            raise
        except Exception:
            if rs is None:
                raise  # _completer_loop fails the waiters
            # The dispatched cycle died on the card: descend the ladder
            # and serve this wave's waiters host-side instead of failing
            # them.
            rs.ladder.note_dispatch_error()
            self._degraded_pick(batch, Rung(max(rs.ladder.rung(),
                                                Rung.CACHED)))
            return
        wait_s = time.perf_counter() - t0
        own_metrics.DEVICE_WAIT.observe(wait_s)
        if rs is not None:
            # Full-path success (steady state or a probe wave while
            # degraded): the ladder's ascent signal, with the device wait
            # as the pick-latency-breach clock.
            rs.ladder.note_dispatch_ok(latency_s=wait_s)
        if self._depth_auto:
            self._cycle_ewma = (wait_s if self._cycle_ewma == 0.0
                                else 0.9 * self._cycle_ewma + 0.1 * wait_s)
        # The load the cycle left, copied with the wave's results. Guarded
        # on the snapshot, not self.trainer: a trainer attached between
        # dispatch and completion must not make this index a snapshot the
        # dispatcher never requested.
        load_snapshot = wave.pending.materialize_load()
        metrics_np = (wave.eps_metrics.numpy() if load_snapshot is not None
                      else None)
        by_slot = {ep.slot: ep for ep in wave.endpoints}
        indices = result.indices
        status = result.status
        prefill = result.prefill   # the dual pick's prefill slots, or None
        # Hierarchical fleet provenance (gie_tpu_torch/fleet): per-request
        # candidate cells feed both the flight record and the picker's
        # /debugz/fleet tallies, so they are read even with obs off.
        fleet = getattr(result, "fleet", None)
        fleet_cells = fleet_scores = fleet_ratio = None
        if fleet is not None:
            fleet_cells, fleet_scores = fleet.cells, fleet.scores
            ratio_fn = getattr(self.scheduler, "compression_ratio", None)
            if ratio_fn is not None:
                fleet_ratio = round(
                    ratio_fn(int(wave.eps_metrics.shape[0])), 6)
        # Ranked-fallback-tail hygiene flags, read once per wave: the
        # subset mask constrained the PRIMARY at dispatch, but the ranked
        # tail spans the whole pool, so quarantined or DRAINING endpoints
        # (read now: a drain marked between dispatch and fan-out still
        # excludes) must not ride along as failover targets.
        board_open = rs is not None and rs.board.has_open
        any_draining = any(
            getattr(ep, "draining", False) for ep in wave.endpoints)
        now_mono = self._clock.now()
        # Flight recorder (obs/, docs/OBSERVABILITY.md): one decision
        # record per request, built HERE on the completer from host
        # arrays only — the materialized result and the wave's CPU
        # metrics rows. Nothing is built while obs is off.
        recorder = obs.RECORDER
        rec_scores = rec_metrics = affinity = None
        rec_draining: list = []
        if recorder is not None:
            rec_scores = result.scores
            rec_metrics = wave.eps_metrics.numpy()
            affinity = result.affinity
            rec_draining = sorted(
                int(s) for s, ep in by_slot.items()
                if getattr(ep, "draining", False))

        def _rec_base(item: _Pending) -> dict:
            req = item.req
            tr = req.trace
            return {
                "ts": time.time(),
                "trace_id": tr.trace_id if tr is not None else "",
                "model": req.model,
                "band": _BAND_NAMES.get(item.band, str(item.band)),
                "prompt_bytes": int(len(req.body) if req.body else 0),
                "decode_tokens": float(req.decode_tokens or 0.0),
                "tenant": item.tenant,
                "rung": "full",
                "candidates": [int(s) for s in item.cand_slots],
                "excluded_breaker": list(item.excl_breaker),
                "excluded_drain": list(item.excl_drain),
                "fed_remote": list(item.fed_remote),
                "draining": rec_draining,
                "deadline_remaining_ms": (
                    round((req.deadline_at - now_mono) * 1e3, 1)
                    if req.deadline_at else None),
            }

        for i, item in enumerate(batch):
            self._observe_pick_latency(item)
            if status[i] == C.Status.SHED:
                own_metrics.PICKS.labels(outcome="shed").inc()
                item.error = ShedError(band=item.band, tenant=item.tenant)
                self.fairness.note_shed(
                    item.tenant, _BAND_NAMES.get(item.band, "standard"))
                if recorder is not None:
                    rec = _rec_base(item)
                    rec["outcome"] = "shed"
                    recorder.append(rec)
                continue
            picked_slots = [
                int(s) for s in indices[i] if s >= 0 and s in by_slot]
            if picked_slots and (board_open or any_draining):
                # Keep the raw list only if filtering would empty it
                # (availability beats quarantine AND drain, the same rule
                # as the dispatch-side filters).
                healthy = [
                    s for s in picked_slots
                    if not ((board_open and rs.board.quarantined(s))
                            or (any_draining and getattr(
                                by_slot[s], "draining", False)))]
                if healthy:
                    picked_slots = healthy
            picked = [by_slot[s].hostport for s in picked_slots]
            if status[i] != C.Status.OK or not picked:
                own_metrics.PICKS.labels(outcome="unavailable").inc()
                item.error = ExtProcError(UNAVAILABLE,
                                          "no endpoints available")
                if recorder is not None:
                    rec = _rec_base(item)
                    rec["outcome"] = "unavailable"
                    recorder.append(rec)
                continue
            res = PickResult(endpoint=picked[0], fallbacks=picked[1:])
            res.assumed_cost = request_cost_host(
                float(plen[i]), float(dlen[i]))
            peer = getattr(by_slot[picked_slots[0]], "cluster", "")
            if peer and self.federation is not None:
                # Cross-cluster pick: tally the spill
                # (gie_federation_spill_total) and stamp the trace, which
                # the OTLP exporter turns into a gie.federation span.
                self.federation.note_remote_pick(
                    peer, _BAND_NAMES.get(item.band, "standard"))
                tr_f = item.req.trace
                if tr_f is not None:
                    tr_f.event(f"federation:{peer}")
            # The cycle charges the RAW primary; if that slot wasn't
            # routable, picked[0] differs and observe_served's guard skips
            # the release.
            res.charged_slot = int(indices[i][0])
            if prefill is not None:
                self._charge_pd(res, item, int(prefill[i]), by_slot,
                                float(plen[i]), float(dlen[i]), now_mono)
            if load_snapshot is not None:
                slot = int(indices[i][0])
                res.feedback = (
                    host_features(metrics_np[slot], float(load_snapshot[slot]),
                                  float(plen[i]), float(dlen[i]),
                                  bool(lora[i] >= 0)),
                    slot,         # feeds the per-endpoint embedding
                    self._clock.now(),
                    picked[0],    # the primary hostport the row describes
                )
            if recorder is not None:
                rec = _rec_base(item)
                rec["outcome"] = "picked"
                rec["chosen"] = picked[0]
                rec["chosen_slot"] = picked_slots[0]
                rec["fallbacks"] = picked[1:]
                # Ranked blend scores straight from the cycle's result —
                # the chosen endpoint's entry may not be rank 0 when the
                # tail filter dropped a quarantined/draining primary.
                rec["ranked"] = [
                    {"slot": int(s), "score": round(float(v), 5)}
                    for s, v in zip(indices[i], rec_scores[i]) if s >= 0]
                # Host-side scorer breakdown for the CHOSEN slot,
                # mirroring scorers.py's normalization formulas over the
                # wave's own metrics rows.
                cfg = self.scheduler.cfg
                row = rec_metrics[picked_slots[0]]
                q = float(row[C.Metric.QUEUE_DEPTH])
                kvu = float(row[C.Metric.KV_CACHE_UTIL])
                breakdown = {
                    "queue": round(
                        min(max(1.0 - q / cfg.queue_norm, 0.0), 1.0), 5),
                    "kv_cache": round(min(max(1.0 - kvu, 0.0), 1.0), 5),
                }
                if affinity is not None:
                    # Device-side columns: the prefix fraction depends on
                    # the live table and session on the rendezvous hash.
                    breakdown["prefix"] = round(float(affinity[i][0]), 5)
                    breakdown["session"] = round(float(affinity[i][1]), 5)
                rec["scorers"] = breakdown
                rec["queue_depth"] = q
                rec["kv_util"] = kvu
                if fleet_cells is not None:
                    rec["fleet"] = {
                        "cells": [int(c) for c in fleet_cells[i]],
                        "cell_scores": [
                            round(float(v), 5) for v in fleet_scores[i]],
                        "compression": fleet_ratio,
                    }
                if prefill is not None:
                    rec["prefill_slot"] = int(prefill[i])
                res.record = recorder.append(rec)
            item.result = res
        if fleet_cells is not None:
            note = getattr(self.scheduler, "note_fleet_wave", None)
            if note is not None:
                # One host-side tally a wave for /debugz/fleet's top-K hit
                # histogram, from the materialized arrays.
                note(fleet_cells, indices[:, 0])
        # Admission runs BEFORE the waiters wake: a shed decision replaces
        # the result, never races the caller reading it.
        self._slo_admission(batch)
        for item in batch:
            if item.result is not None:
                own_metrics.PICKS.labels(outcome="ok").inc()
            self._clock.set_event(item.event)

    def _slo_admission(self, batch: list[_Pending]) -> None:
        """Predictive SLO shedding: after the cycle picked, non-critical
        requests carrying an x-gateway-inference-ttft-slo-ms header whose
        PREDICTED TTFT on the picked endpoint already misses the bound are
        shed with 429, and the charge the cycle added for them is released
        at once. Admits everything until the predictor has trained once
        (shedding on a random init would starve the trainer)."""
        if self.trainer is None:
            return
        if getattr(self.trainer, "last_loss", None) is None:
            return
        rows, slots, slos, items = [], [], [], []
        for item in batch:
            if item.result is None or item.result.feedback is None:
                continue
            raw = item.req.headers.get(mdkeys.TTFT_SLO_MS_KEY, [""])[0]
            try:
                slo_s = float(raw) / 1000.0
            except (TypeError, ValueError):
                continue
            if slo_s <= 0 or item.band == C.Criticality.CRITICAL:
                continue
            features, slot, _, _ = item.result.feedback
            rows.append(features)
            slots.append(slot)
            slos.append(slo_s)
            items.append(item)
        if not items:
            return
        pred = self.trainer.predict_ttft(np.stack(rows), np.asarray(slots))
        for j, item in enumerate(items):
            if pred[j] <= slos[j]:
                continue
            res = item.result
            item.result = None
            item.error = ShedError(band=item.band, tenant=item.tenant)
            self.fairness.note_shed(
                item.tenant, _BAND_NAMES.get(item.band, "standard"))
            if res.record is not None:
                # The decision record outlives the reversal: picked, then
                # SLO-shed after the pick.
                res.record["outcome"] = "shed_slo"
            # The cycle charged the pick; the request will not run.
            if res.charged:
                self.scheduler.complete(
                    np.asarray([s for s, _, _ in res.charged], np.int32),
                    np.asarray([c for _, c, _ in res.charged], np.float32))
            elif res.charged_slot is not None and res.charged_slot >= 0:
                self.scheduler.complete(
                    np.asarray([res.charged_slot], np.int32),
                    np.asarray([res.assumed_cost], np.float32))
            own_metrics.PICKS.labels(outcome="shed").inc()

    def _charge_pd(self, res: PickResult, item: _Pending, p_slot: int,
                   by_slot: dict, plen: float, dlen: float,
                   now_mono: float) -> None:
        """A dual pick's bookkeeping: the decode charge always, then the
        prefill worker's header and charge, unless the request's remaining
        deadline budget is below pd_budget_floor_s, where the pick collapses
        to the decode worker (which prefills locally) and the prefill
        charge is released at once: the skipped hop must not phantom-load
        a worker that never sees the request."""
        p_ep = by_slot.get(p_slot)
        p_cost, d_cost = pd_costs_host(plen, dlen)
        # Always a charged list: the single-slot release would free the
        # whole request cost from a slot the cycle charged d_cost.
        res.charged = [(res.charged_slot, d_cost, res.endpoint)]
        d = item.req.deadline_at
        if (p_ep is not None and self.pd_budget_floor_s > 0 and d
                and d - now_mono < self.pd_budget_floor_s):
            self.scheduler.complete(np.asarray([p_slot], np.int32),
                                    np.asarray([p_cost], np.float32))
            own_metrics.PD_BUDGET_SINGLEHOP.inc()
            p_ep = None
        if p_ep is not None:
            res.extra_headers = {**res.extra_headers,
                                 mdkeys.PREFILL_ENDPOINT_KEY: p_ep.hostport}
            res.charged.append((p_slot, p_cost, p_ep.hostport))
        # else: the prefill pod vanished between the cycle and this wave;
        # its eviction already cleared the slot's load.

    def _observe_pick_latency(self, item: _Pending) -> None:
        """The "picked" trace stage and the pick-latency observation, with
        a trace-ID exemplar for a head-sampled request (the bucket ->
        trace join, docs/OBSERVABILITY.md)."""
        lat = self._clock.now() - item.enqueued_at
        tr = item.req.trace
        if tr is not None:
            tr.event("picked")
            if tr.sampled:
                own_metrics.PICK_LATENCY.observe(
                    lat, {"trace_id": tr.trace_id})
                return
        own_metrics.PICK_LATENCY.observe(lat)

    # -- degraded pick path (resilience ladder rungs 1-3) ------------------

    _RUNG_LABELS = {
        Rung.CACHED: "cached",
        Rung.ROUND_ROBIN: "round_robin",
        Rung.STATIC: "static",
    }

    def _degraded_pick(self, batch: list[_Pending], rung: Rung) -> None:
        """Serve one wave entirely host-side on a degraded ladder rung
        (docs/RESILIENCE.md):

          CACHED       least (queue-depth + scaled KV) over the bounded-
                       staleness metrics rows, with an in-wave spread so
                       a burst does not pile onto one endpoint.
          ROUND_ROBIN  smooth weighted round-robin on the last-known-good
                       rows (weights from queue depth; stale data is only
                       trusted as a static weight, not a live signal).
          STATIC       plain rotation over a fixed subset of live
                       endpoints — the "never 503 the whole pool" floor.

        No device state is touched and no CUDA tensor is read: the rows
        come from the MetricsStore's host arrays, nothing is charged
        (charged_slot = -1 makes observe_served's slot-match guard skip
        the release), no prefix inserts, no tick. Called from the
        dispatcher (rung gate, dispatch failure) or the completer
        (materialize failure), never both for one wave; the shared
        WRR/rotation cursors are behind _degraded_lock."""
        endpoints = self.datastore.endpoints()
        by_slot = {ep.slot: ep for ep in endpoints}
        # Degraded rungs honor graceful drain exactly like the full path:
        # a terminating pod leaves new-pick candidacy even while the
        # ladder is down, with the same availability floor.
        ready = {s: ep for s, ep in by_slot.items()
                 if not getattr(ep, "draining", False)}
        drain_set = {s for s in by_slot if s not in ready} if ready else set()
        if ready:
            by_slot = ready
        rs = self.resilience
        breaker_set: set = set()
        if rs is not None and rs.board.has_open and len(by_slot) > 1:
            allowed = {s for s in by_slot if not rs.board.quarantined(s)}
            if allowed:  # quarantine never empties the pool
                breaker_set = set(by_slot) - allowed
                by_slot = {s: ep for s, ep in by_slot.items()
                           if s in allowed}
        live = sorted(by_slot)
        if not live:
            for item in batch:
                item.error = ExtProcError(UNAVAILABLE,
                                          "no endpoints available")
                self._clock.set_event(item.event)
                own_metrics.PICKS.labels(outcome="unavailable").inc()
            return
        label = self._RUNG_LABELS.get(rung, "static")
        kvw = (rs.ladder.cfg.cached_kv_weight if rs is not None else 8.0)
        # Last-known-good rows: queue depth + KV utilization, read once
        # per wave. On the RR/STATIC rungs these may be arbitrarily stale
        # — they only shape static weights there.
        rows, _ages = self.metrics_store.pool_rows(live)
        queue = rows[:, C.Metric.QUEUE_DEPTH].astype(np.float64)
        kv = rows[:, C.Metric.KV_CACHE_UTIL].astype(np.float64)
        col_of = {s: i for i, s in enumerate(live)}
        with self._degraded_lock:
            # Slot hygiene: WRR credit must not outlive the endpoint that
            # earned it (prune against the unfiltered endpoint set so a
            # merely-quarantined slot keeps its credit).
            if self._wrr_credit:
                pool_slots = {ep.slot for ep in endpoints}
                for s in [s for s in self._wrr_credit
                          if s not in pool_slots]:
                    del self._wrr_credit[s]
            if rung == Rung.STATIC:
                subset = live[: max(
                    rs.static_subset if rs is not None else 4, 1)]
            for item in batch:
                cands = [int(s) for s in item.cand_slots if s in by_slot]
                if not cands:
                    cands = live
                if rung == Rung.CACHED:
                    # Fresh-enough data: least queue+KV now, plus an
                    # in-wave +1 spread per assignment.
                    scores = [queue[col_of[s]] + kvw * kv[col_of[s]]
                              for s in cands]
                    order = sorted(range(len(cands)),
                                   key=lambda j: (scores[j], cands[j]))
                    picked = [cands[j] for j in order]
                    queue[col_of[picked[0]]] += 1.0
                elif rung == Rung.ROUND_ROBIN:
                    # Smooth WRR: weight ~ (1+queue)^-alpha from the last
                    # good rows; every candidate gains its weight, the
                    # winner pays the pot back. Alpha 0 is uniform RR,
                    # 1 the default.
                    alpha = (rs.ladder.cfg.wrr_queue_alpha
                             if rs is not None else 1.0)
                    weights = {
                        s: (1.0 + max(queue[col_of[s]], 0.0)) ** -alpha
                        for s in cands}
                    for s, w in weights.items():
                        self._wrr_credit[s] = (
                            self._wrr_credit.get(s, 0.0) + w)
                    picked = sorted(
                        cands,
                        key=lambda s: (-self._wrr_credit[s], s))
                    self._wrr_credit[picked[0]] -= sum(weights.values())
                else:  # STATIC
                    pool = [s for s in cands if s in subset] or cands
                    self._static_rr += 1
                    first = pool[self._static_rr % len(pool)]
                    picked = [first] + [s for s in pool if s != first]
                res = PickResult(
                    endpoint=by_slot[picked[0]].hostport,
                    fallbacks=[by_slot[s].hostport for s in picked[1:4]],
                )
                res.assumed_cost = 0.0
                res.charged_slot = -1  # nothing charged: skip the release
                recorder = obs.RECORDER
                if recorder is not None:
                    # Degraded picks record too (same schema as the full
                    # path): rung + exclusions explain why this request
                    # skipped the device cycle; raw row signals stand in
                    # for the scorer breakdown the rung used.
                    tr = item.req.trace
                    j = col_of[picked[0]]
                    d = item.req.deadline_at
                    res.record = recorder.append({
                        "ts": time.time(),
                        "trace_id": tr.trace_id if tr is not None else "",
                        "model": item.req.model,
                        "band": _BAND_NAMES.get(item.band, str(item.band)),
                        "rung": label,
                        "candidates": [int(s) for s in item.cand_slots],
                        "excluded_breaker": sorted(
                            int(s) for s in item.cand_slots
                            if s in breaker_set),
                        "excluded_drain": sorted(
                            int(s) for s in item.cand_slots
                            if s in drain_set),
                        "draining": sorted(int(s) for s in drain_set),
                        "deadline_remaining_ms": (
                            round((d - self._clock.now()) * 1e3, 1)
                            if d else None),
                        "outcome": "picked",
                        "chosen": res.endpoint,
                        "chosen_slot": int(picked[0]),
                        "fallbacks": list(res.fallbacks),
                        "scorers": {"degraded_" + label: round(
                            float(queue[j] + kvw * kv[j]), 5)},
                        "queue_depth": float(queue[j]),
                        "kv_util": float(kv[j]),
                    })
                item.result = res
                own_metrics.DEGRADED_PICKS.labels(rung=label).inc()
                own_metrics.PICKS.labels(outcome="ok").inc()
                # Same trace lifecycle as the full path: the "picked"
                # stage and the exemplar must not vanish exactly while
                # the pool is degraded — that is when traces are read.
                self._observe_pick_latency(item)
                self._clock.set_event(item.event)
