"""StormEngine: execute a compiled storm schedule against the port's stack
(port of gie_tpu/storm/engine.py, docs/STORM.md).

One run drives

  ext-proc admission   every arrival is a real StreamingServer stream
                       (fast-lane scan of a JSON body, objective /
                       decode-hint headers, pooled response templates)
  flow queue + waves   the BatchingTPUPicker (fair ordering, holds,
                       micro-batched scheduling cycles on the
                       Scheduler's device)
  resilience           the BreakerBoard / DegradationLadder / graceful
                       drain / outlier ejector, fed by the serve-outcome
                       response path
  scrape plane         the multiplexed ScrapeEngine polling each stub's
                       Prometheus text over the fetcher seam
  chaos                optional fault schedules (a scenario's ``rules``),
                       layered over the storm

against a fleet of VLLMStub model servers, in real time or on a
VirtualClock. The data plane between Envoy and the model server is
emulated: a pick's destination is submitted to that stub, the response-
headers hop fires at the stub's first token (TTFT) with a real
``:status``, and dead endpoints serve 503.

What the port adds to the reference engine, and nothing else:
  device        StormEngine, engine_from_drive and run_scenario take a
                ``device`` for the Scheduler: CUDA when None (raising when
                there is none), ``"cpu"`` on request; never a fallback.
  noise_source  passed to the Scheduler as its Gumbel source (the parity
                tests replay the reference scheduler's draws through it).
  kernels       a kernel that cannot run here (ops.KernelUnavailable, the
                cause of the INTERNAL error the picker fails its wave
                with) ends the storm: warm-up, the run and its recovery
                probes raise it, where the reference's engine scores any
                stream error as a client 5xx and carries on.

The learned scorer (``scorer``, ``policy_weights``) runs as the
reference runs it, the judge's path (learn/judge.py), and so do the
autoscale loop (``autoscale_max_extra``: the real SignalCollector ->
CapacityModel -> AutoscaleRecommender, actuation = pods joining this
pool) and the replication standby probe (``standby`` and the
``standby_failover`` shape: the real StatePublisher digest, fetched and
decoded the way a follower would), and so does federation (a
``federation`` spec: a second stub fleet as the peer cluster, published
through a real FederationPublisher and imported through a real PeerLink /
FederationState, with the drain, partition and heal control events), and
so does the fleet picker (``fleet_topk``: the hierarchical FleetPicker in
place of the Scheduler, and the scorecard's ``fleet`` section), and so
does the mesh (``mesh_devices`` > 1: the Scheduler(mesh=) production path,
the dp x tp sharded cycle over that many cards, or over that many virtual
positions of the CPU when the engine runs there).

Determinism: the SCHEDULE is bit-identical per seed (shapes.py). Under
``virtual_time`` the decision sequence is a pure function of the seed and
the noise; in real time it varies with thread scheduling.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import random
import threading
from collections import defaultdict
from typing import Callable, Optional

import numpy as np

from gie_tpu_torch.autoscale.model import CapacityModel
from gie_tpu_torch.autoscale.recommender import (
    AutoscaleRecommender,
    RecommenderConfig,
)
from gie_tpu_torch.autoscale.signals import SignalCollector
from gie_tpu_torch.datastore import Datastore
from gie_tpu_torch.datastore.objects import EndpointPool, Pod
from gie_tpu_torch.extproc import metadata as mdkeys
from gie_tpu_torch.extproc import pb
from gie_tpu_torch.extproc.server import (
    ExtProcError,
    PickRequest,
    StreamAborted,
    StreamingServer,
)
from gie_tpu_torch.federation import (
    FederationExchange,
    FederationPublisher,
    FederationState,
)
from gie_tpu_torch.federation import summary as fed_summary
from gie_tpu_torch.learn.policy import float32_from_hex, weights_from_mapping
from gie_tpu_torch.metricsio import MetricsStore
from gie_tpu_torch.metricsio.engine import ScrapeEngine
from gie_tpu_torch.metricsio.mappings import VLLM
from gie_tpu_torch.ops import KernelUnavailable
from gie_tpu_torch.replication import StatePublisher, codec
from gie_tpu_torch.resilience import faults
from gie_tpu_torch.resilience import scenarios as scenarios_mod
from gie_tpu_torch.resilience.breaker import BreakerBoard, BreakerConfig
from gie_tpu_torch.resilience.ladder import (
    DegradationLadder,
    LadderConfig,
    ResilienceState,
    Rung,
)
from gie_tpu_torch.resilience.outlier import OutlierEjector
from gie_tpu_torch.runtime.clock import MONOTONIC, VirtualClock
from gie_tpu_torch.sched.batching import BatchingTPUPicker
from gie_tpu_torch.sched.config import tuned_profile
from gie_tpu_torch.sched.hashing import batch_chunk_hashes
from gie_tpu_torch.sched.profile import Scheduler, resolve_device
from gie_tpu_torch.sched.types import chunk_bucket_for
from gie_tpu_torch.simulator.vllm_stub import StubConfig, VLLMStub
from gie_tpu_torch.storm import scorecard as scorecard_mod
from gie_tpu_torch.storm.shapes import (
    Arrival,
    Program,
    Schedule,
    program_from_drive,
)
from gie_tpu_torch.utils.lora import LoraRegistry

POOL = EndpointPool(selector={"app": "storm"}, target_ports=[8000],
                    namespace="default")

# Engine-default stub dynamics: ~13 req/s per pod at the default decode
# mix — small enough that a 3-4x flash crowd saturates a 6-pod pool
# within a CI-scale run.
DEFAULT_STUB = StubConfig(
    max_running=8,
    num_kv_blocks=4096,
    prefill_tokens_per_s=6000.0,
    decode_tokens_per_s=40.0,
    prefix_cache_chunks=1024,
    max_lora=4,
    lora_load_s=0.15,
)

# Engine-default breaker: fast-recovery variants of the production
# defaults (a CI storm must see open AND close in seconds). Module-level
# so the search harness (storm/search.py) can base breaker.* knobs on
# the exact config an unconfigured storm runs with.
DEFAULT_BREAKER = BreakerConfig(
    open_after=4, open_s=1.0, close_after=2,
    serve_window_s=4.0, serve_rate_open=0.6, serve_min_samples=8)


@dataclasses.dataclass
class PoolSpec:
    """The emulated fleet the storm starts with."""

    n_pods: int = 6
    stub: object = None            # StubConfig | list[StubConfig] | None
    ip_base: str = "10.77.0"
    replacement_ip_base: str = "10.78.0"
    drain_deadline_s: float = 10.0

    def stub_cfgs(self) -> list[StubConfig]:
        s = self.stub if self.stub is not None else DEFAULT_STUB
        if isinstance(s, list):
            if len(s) != self.n_pods:
                raise ValueError("need one StubConfig per pod")
            return list(s)
        return [s] * self.n_pods


@dataclasses.dataclass
class FederationSpec:
    """A peer cluster for federation storms (docs/FEDERATION.md): the engine runs a SECOND stub fleet as the
    peer's data plane, publishes its load through a REAL
    FederationPublisher + HTTP listener (era machinery included), and
    the local stack imports it through a real PeerLink/FederationState
    — so spillover, drain bleed, partition degradation, and split-brain
    convergence all exercise the production code path; only the peer's
    own EPP scheduling is emulated (its digest IS what a peer EPP would
    publish)."""

    peer_name: str = "west"
    n_pods: int = 3
    ip_base: str = "10.79.0"
    # Fleet-scale storms (docs/FLEET.md): run N peer clusters
    # instead of one. Peer 0 keeps `peer_name` and ALL the single-peer
    # machinery (partition, zombie split-brain, the pinned decision
    # fingerprints are byte-identical at n_peers=1); peers 1..N-1 are
    # named `{peer_name}{i}`, publish through their own real
    # FederationPublisher each, and always answer (the chaos events stay
    # scoped to peer 0).
    n_peers: int = 1
    # Cross-cluster penalty in queue-depth units (storm-scale default:
    # small enough that a saturated local pool actually spills).
    penalty: float = 2.0
    # Link cadence — CI-scale fast-recovery variants of the production
    # defaults (a storm must see degrade AND readmit in seconds).
    interval_s: float = 0.1
    wait_s: float = 0.5
    stale_inflate_s: float = 0.5
    local_only_after_s: float = 1.5
    link_open_after: int = 3
    link_open_s: float = 0.4


@dataclasses.dataclass
class EngineConfig:
    """The reference's fields and defaults (see gie_tpu/storm/engine.py
    for each knob's rationale)."""

    ttft_slo_s: float = 2.5
    scrape_interval_s: float = 0.025
    world_dt_s: float = 0.02
    max_concurrency: int = 128     # client-side in-flight cap
    batch_window_s: float = 0.002
    # ProfileConfig saturation bounds scaled to the stub fleet: the
    # cycle's SHEDDABLE shed (the real 429 path) engages when every
    # candidate is past these.
    queue_limit: float = 8.0
    kv_limit: float = 0.95
    # Resilience layer (fast-recovery variants of the production
    # defaults — a CI storm must see descent AND recovery in seconds).
    ladder: Optional[LadderConfig] = None
    breaker: Optional[BreakerConfig] = None
    outlier: object = None         # OutlierConfig | None
    static_subset: int = 4
    autoscale_max_extra: int = 0
    autoscale_interval_s: float = 0.5
    autoscale_up_sustain_s: float = 0.75
    autoscale_shed_high_per_s: float = 1.0
    standby: bool = False
    # Storm sweeps: pin the ladder's error-driven level for the whole
    # run (e.g. Rung.CACHED for the cached-kv-weight calibration).
    force_rung: Optional[int] = None
    # Per-request data-plane resolution timeout (engine-clock seconds).
    serve_timeout_s: float = 30.0
    # The multi-core ext-proc acceptor pool modelled in engine time. 0
    # disables; >= 1 routes every arrival's admission through a
    # per-worker serial-service gate before the real ext-proc stream.
    extproc_workers: int = 0
    extproc_admission_s: float = 0.0
    federation: Optional[FederationSpec] = None
    # Run the whole stack on a deterministic discrete-event VirtualClock.
    # Real mode keeps each subsystem's monotonic default.
    virtual_time: bool = False
    # > 1 serves the storm through Scheduler(mesh=): the dp x tp sharded
    # cycle over that many positions (parallel/mesh.py). 0/1 = one device.
    mesh_devices: int = 0
    scorer: str = "blend"
    policy_weights: tuple = ()
    fleet_topk: int = 0
    fleet_cell_cap: int = 64

    def fast_ladder(self) -> LadderConfig:
        return LadderConfig(
            dispatch_error_streak=2, blackout_stale_s=2.0,
            latency_breach_s=5.0, latency_breach_streak=200,
            recover_streak=2, min_dwell_s=0.3, probe_interval_s=0.15,
            serve_min_samples=10_000)


class _ZombieSnapshot:
    """Frozen pre-failover publisher lineage for split-brain storms: it
    serves the same full frame (old era, old epoch) forever — what a
    partitioned-away leader that never learned it lost looks like to an
    importer."""

    def __init__(self, pub):
        self.response = pub.serve()

    def serve(self, **_kw):
        return self.response


class _AdmissionGate:
    """Engine-time model of the multi-core ext-proc acceptor pool: each
    arrival's admission is one serial service interval on one of N
    workers, assigned round robin. The gate charges queueing + service
    time on the ENGINE clock before the real StreamingServer stream runs.
    The lock covers only the next-free bookkeeping, never a sleep."""

    def __init__(self, workers: int, service_s: float, clock):
        self.workers = workers
        self.service_s = service_s
        self._clock = clock
        self._lock = threading.Lock()
        self._rr = 0
        self._next_free = [0.0] * workers
        self._accepts = [0] * workers
        self._waits: list[float] = []

    def admit(self) -> int:
        """Block (on the engine clock) until the assigned worker has
        served this admission; returns the worker index."""
        now = self._clock.now()
        with self._lock:
            w = self._rr % self.workers
            self._rr += 1
            start = max(now, self._next_free[w])
            self._next_free[w] = start + self.service_s
            self._accepts[w] += 1
            self._waits.append(start - now)
        delay = (start + self.service_s) - now
        if delay > 0:
            self._clock.sleep(delay)
        return w

    def accepts(self) -> list[int]:
        with self._lock:
            return list(self._accepts)

    def report(self) -> dict:
        with self._lock:
            accepts = list(self._accepts)
            waits = sorted(self._waits)
        n = len(waits)

        def pct(p: float) -> float:
            if not n:
                return 0.0
            return round(waits[min(int(p * (n - 1)), n - 1)] * 1e3, 3)

        return {
            "workers": self.workers,
            "admission_service_s": self.service_s,
            "admitted": sum(accepts),
            "per_worker_accepts": accepts,
            "per_worker_busy_s": [round(a * self.service_s, 3)
                                  for a in accepts],
            "admission_wait_p50_ms": pct(0.50),
            "admission_wait_p99_ms": pct(0.99),
        }


class _StubSlot:
    """One emulated model server + its lifecycle state."""

    __slots__ = ("stub", "alive", "zombie")

    def __init__(self, stub: VLLMStub):
        self.stub = stub
        self.alive = True      # accepts new submits
        self.zombie = False    # deleted from the pool; finishing in-flight


class _InFlight:
    """One picked request waiting on its stub's first token."""

    __slots__ = ("stream", "arrival", "t_enqueue", "t_pick", "resolved",
                 "tokens")

    def __init__(self, stream, arrival, t_enqueue, t_pick):
        self.stream = stream
        self.arrival = arrival
        self.t_enqueue = t_enqueue
        self.t_pick = t_pick
        self.resolved = False
        self.tokens = 0.0


class _StormStream:
    """One ext-proc exchange: request headers + JSON body in, pick out,
    then a BLOCKING response-headers hop resolved by the engine's data
    plane at the stub's first token — the stream the gRPC adapter would
    carry, minus the wire."""

    def __init__(self, engine: "StormEngine", arrival):
        self.engine = engine
        self.arrival = arrival
        self._stage = 0
        self._resolved = threading.Event()
        self.resolution: Optional[tuple] = None  # (kind, served, status)
        self.dest: Optional[str] = None
        self.immediate_code: Optional[int] = None
        self.sent: list = []

    # -- engine side -------------------------------------------------------

    def resolve(self, kind: str, served: str = "", status: int = 200) -> None:
        self.resolution = (kind, served, status)
        self.engine.clock.set_event(self._resolved)

    # -- Stream interface (extproc/server.py) ------------------------------

    def recv(self):
        if self._stage == 0:
            self._stage = 1
            return self.engine._headers_msg(self.arrival)
        if self._stage == 1:
            self._stage = 2
            return self.engine._body_msg(self.arrival)
        if self._stage == 2:
            self._stage = 3
            if self.dest is None:
                return None  # shed / immediate response: clean close
            if not self.engine.clock.wait_event(
                    self._resolved, self.engine.cfg.serve_timeout_s):
                self.resolution = ("timeout", "", 0)
                raise StreamAborted()
            kind, served, status = self.resolution
            if kind == "reset":
                raise StreamAborted()
            return self.engine._resp_headers_msg(served, status)
        return None

    def send(self, resp) -> None:
        self.sent.append(resp)
        which = resp.WhichOneof("response")
        if which == "request_headers":
            mut = resp.request_headers.response.header_mutation
            for o in mut.set_headers:
                if o.header.key == mdkeys.DESTINATION_ENDPOINT_KEY:
                    self.dest = o.header.raw_value.decode().split(",")[0]
                    self.engine._submit(self)
                    break
        elif which == "immediate_response":
            self.immediate_code = int(resp.immediate_response.status.code)


class StormResult:
    """A finished run: the scorecard plus live handles for assertions."""

    def __init__(self, card: dict, schedule: Schedule, resilience,
                 board: BreakerBoard, scheduler: Scheduler, datastore):
        self.scorecard = card
        self.schedule = schedule
        self.resilience = resilience
        self.board = board
        self.scheduler = scheduler
        self.datastore = datastore
        # The installed injector's fired counts when the storm ended, read
        # before run() released the clock ({} with none installed).
        self.fault_fired_in_storm: dict = {}


class StormEngine:
    def __init__(self, program: Program, pool: Optional[PoolSpec] = None,
                 cfg: Optional[EngineConfig] = None, name: str = "storm",
                 virtual_time: Optional[bool] = None, *, device=None,
                 noise_source: Optional[Callable[[tuple], object]] = None):
        self.program = program
        self.pool = pool if pool is not None else PoolSpec()
        self.cfg = cfg if cfg is not None else EngineConfig()
        self.name = name
        # Refusals and the device come first: nothing below (the clock
        # hand-off to faults, stubs, threads) may exist when they raise.
        self.device = resolve_device(device)
        self.noise_source = noise_source
        # The constructor kwarg overrides the config.
        self.virtual = (self.cfg.virtual_time if virtual_time is None
                        else bool(virtual_time))
        self.clock = VirtualClock() if self.virtual else MONOTONIC
        # Seeded rng for the scrape phase stagger + backoff jitter:
        # virtual runs must be bit-identical per seed. Real mode keeps
        # the unseeded source.
        self._rng = (random.Random(program.seed ^ 0x51C0_C10C)
                     if self.virtual else None)
        if self.virtual:
            # Chaos latency/hang sleeps are clock-governed: serve them
            # from the virtual clock (restored by close()).
            faults.set_clock(self.clock)
        # Virtual mode registers the MAIN thread as an actor for the
        # whole engine lifetime (construction -> run): while main is
        # active the clock cannot advance, so the virtual time consumed
        # by construction/warmup/arming is exactly the time the parked
        # subsystems were waited on. run() releases it; close() backstops.
        self._main_tok = (self.clock.actor_begin("storm-main")
                          if self.virtual else None)
        self._sessions = [
            (b"STORM SYSTEM PROMPT %03d | " % s) * 2
            + b"s" * max(self.program.traffic.system_prompt_bytes - 52, 0)
            for s in range(self.program.traffic.n_sessions)
        ]
        self._world_lock = threading.Lock()
        try:
            self._build_stack()
        except BaseException:
            # A stack that cannot be built (no card, a bad device, a
            # kernel build error) leaves no clock, actor or thread behind.
            self.close()
            raise
        # Run state.
        self._pending: dict[tuple[str, int], _InFlight] = {}
        self._stop = threading.Event()
        self._t0 = 0.0
        self._sem = threading.Semaphore(self.cfg.max_concurrency)
        # Multi-core admission model: None = no admission stage.
        self._admission = (
            _AdmissionGate(self.cfg.extproc_workers,
                           self.cfg.extproc_admission_s, self.clock)
            if self.cfg.extproc_workers >= 1 else None)
        # Tallies (worker threads append; small lists, GIL-atomic).
        self._completions: list[tuple] = []   # (ttft_s, tokens, tenant)
        self._client_5xx: list[tuple] = []    # (t, phase, detail)
        self._resets: list[tuple] = []
        self._shed = 0
        self._ok = 0
        self._timeouts = 0
        self._client_skipped = 0
        # Per-tenant / per-band breakdowns: the noisy-neighbor proof.
        self._tenant_ok: dict = defaultdict(int)
        self._tenant_shed: dict = defaultdict(int)
        self._tenant_5xx: dict = defaultdict(int)
        self._shed_bands: dict = defaultdict(int)
        self._rung_trace: list[tuple] = []
        self._pool_trace: list[tuple] = []
        self._autoscale_events: list[dict] = []
        self._upgrades: list[dict] = []
        self._failover_checks: list[dict] = []
        # Federation tallies: per-cluster pick/serve counts, the local-only
        # timeline, and the control-event log the scorecard's per-cluster
        # section is built from.
        self._fed_picks: dict = defaultdict(int)    # (cluster, band) -> n
        self._fed_serves: dict = defaultdict(int)   # cluster -> 2xx serves
        self._fed_pick_times: list[tuple] = []      # (t, cluster)
        self._fed_local_only_trace: list[tuple] = []
        self._fed_events: list[dict] = []
        # Decision log: every landed pick as (t, destination, band), the
        # core of the scorecard's decision_fingerprint.
        self._pick_log: list[tuple] = []
        # Workers in flight, counted by the engine (not Thread.is_alive:
        # a thread's OS-level teardown is real-world nondeterminism, and
        # the virtual drain loop's observations must be clock-exact).
        self._workers_live = 0
        # A kernel that cannot run here (ops.KernelUnavailable, the cause
        # of the INTERNAL error the picker fails its wave with) ends the
        # storm: run() raises the first one instead of scoring its streams
        # as client 5xx.
        self._kernel_failures: list[KernelUnavailable] = []

    # -- stack construction ------------------------------------------------

    def _build_stack(self) -> None:
        cfg, pool = self.cfg, self.pool
        # The tuned batch-aware profile, with the saturation bounds scaled
        # to the stub fleet so the cycle's sheddable 429 path engages
        # under a genuine overload.
        prof, weights = tuned_profile()
        prof = dataclasses.replace(
            prof, queue_limit=cfg.queue_limit, kv_limit=cfg.kv_limit)
        if cfg.scorer != "blend":
            # The gie-learn judge path: the multiplicative scorer with the
            # trained exponents (bit-exact from their float32 hex form).
            prof = dataclasses.replace(prof, scorer=cfg.scorer)
            if cfg.policy_weights:
                weights = weights_from_mapping({
                    name: float(float32_from_hex(hexed))
                    for name, hexed in cfg.policy_weights})
        mesh = None
        if cfg.mesh_devices > 1:
            # The production --mesh-devices path end to end: the storm's
            # waves run the dp x tp sharded cycle (docs/MESH.md), over
            # virtual positions when the engine runs on the CPU.
            from gie_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(cfg.mesh_devices, device=self.device)
        if cfg.fleet_topk > 0:
            # gie-fleet: the hierarchical two-level pick cycle (coarse cell
            # stage, then the unchanged dense cycle over the gathered
            # candidate block). With a covering top-K the decision
            # fingerprint equals the dense scheduler's.
            from gie_tpu_torch.fleet import FleetPicker

            self.scheduler = FleetPicker(
                prof, weights=weights, device=self.device,
                noise_source=self.noise_source, topk=cfg.fleet_topk,
                cell_cap=cfg.fleet_cell_cap, mesh=mesh)
        else:
            self.scheduler = Scheduler(prof, weights=weights,
                                       device=self.device,
                                       noise_source=self.noise_source,
                                       mesh=mesh)
        # Virtual mode hands every subsystem the same clock; real mode
        # keeps each subsystem's default (monotonic for the resilience
        # layer, wall time for the store's row stamps).
        self.metrics_store = (MetricsStore(clock=self.clock.now)
                              if self.virtual else MetricsStore())
        self.lora_registry = LoraRegistry()
        self.board = BreakerBoard(
            cfg.breaker if cfg.breaker is not None else DEFAULT_BREAKER,
            clock=self.clock.now)
        ladder = DegradationLadder(
            cfg.ladder if cfg.ladder is not None else cfg.fast_ladder(),
            clock=self.clock.now)
        ejector = (OutlierEjector(cfg.outlier, clock=self.clock.now)
                   if cfg.outlier is not None else None)
        self.resilience = ResilienceState(
            board=self.board, ladder=ladder,
            static_subset=cfg.static_subset, ejector=ejector)
        self.datastore = Datastore(
            on_slot_reclaimed=self._slot_reclaimed,
            drain_deadline_s=pool.drain_deadline_s,
            clock=self.clock.now)
        self.datastore.pool_set(POOL)
        self._stubs: dict[str, _StubSlot] = {}
        self._pod_names: list[str] = []
        for i, scfg in enumerate(pool.stub_cfgs()):
            self._add_pod(f"p{i}", f"{pool.ip_base}.{i + 1}", scfg)
        # -- federation peer cluster (docs/FEDERATION.md) -------------------
        self.fed_state = self.fed_exchange = None
        self.peer_pub = self.peer_server = None
        self.peer_pubs: dict = {}
        self._peer_hostports: set[str] = set()
        self._peer_cluster: dict[str, str] = {}
        self._fed_partitioned = False
        self._zombie_pub = None
        self._zombie_alternator = 0
        fed = cfg.federation
        if fed is not None:
            # Peer fleets: same stub dict (the data plane routes by
            # hostport), never the local datastore — a peer's pods
            # become schedulable only through the digest import. Peer 0
            # keeps fed.peer_name / fed.ip_base (the classic single-peer
            # engine, byte-identical at n_peers=1); fleet-scale storms
            # add peers "{peer_name}{i}" on bumped second-octet subnets.
            stub_cfg = pool.stub_cfgs()[0]
            octets = fed.ip_base.split(".")
            peer_specs: list[tuple[str, str]] = []
            for p in range(max(1, fed.n_peers)):
                name = fed.peer_name if p == 0 else f"{fed.peer_name}{p}"
                ip_base = (fed.ip_base if p == 0 else
                           f"{octets[0]}.{int(octets[1]) + p}.{octets[2]}")
                peer_specs.append((name, ip_base))
            peer_hosts: dict[str, list[str]] = {}
            for name, ip_base in peer_specs:
                hosts = []
                for i in range(fed.n_pods):
                    hostport = f"{ip_base}.{i + 1}:8000"
                    self._stubs[hostport] = _StubSlot(
                        VLLMStub(stub_cfg, name=f"{name}-p{i}"))
                    self._stubs[hostport].stub.hostport = hostport
                    self._peer_hostports.add(hostport)
                    self._peer_cluster[hostport] = name
                    hosts.append(hostport)
                peer_hosts[name] = sorted(hosts)

            def _make_sections(name: str, hosts: list[str]):
                def _peer_meta():
                    return fed_summary.encode_meta(
                        self.peer_pubs[name].era, False, name)

                def _peer_load():
                    rows = []
                    with self._world_lock:
                        for hostport in hosts:
                            slot = self._stubs.get(hostport)
                            if slot is None or not slot.alive:
                                continue
                            rows.append((hostport,
                                         float(len(slot.stub.queue)),
                                         float(slot.stub.kv_utilization()),
                                         False))
                    return fed_summary.encode_load(
                        rows, max_endpoints=64)

                return {fed_summary.META_SECTION: _peer_meta,
                        fed_summary.LOAD_SECTION: _peer_load}

            for p, (name, _ip) in enumerate(peer_specs):
                self.peer_pubs[name] = FederationPublisher(
                    _make_sections(name, peer_hosts[name]),
                    era_seq=1,
                    # Deterministic era token: the pair's ordering
                    # semantics never read it, but a reproducible
                    # scorecard should not carry run-unique randomness.
                    era_token=((self.program.seed + p) & 0x7FFF_FFFF) or 1,
                    clock=self.clock)
                self.peer_pubs[name].refresh()
            # The first peer IS the classic peer: every single-peer seam
            # (partition, zombie, the scorecard's peer_era) aliases it.
            self.peer_pub = self.peer_pubs[fed.peer_name]
            self.fed_state = FederationState(
                self.datastore, self.metrics_store,
                scheduler=self.scheduler,
                cluster="local",
                penalty=fed.penalty,
                stale_inflate_s=fed.stale_inflate_s,
                local_only_after_s=fed.local_only_after_s,
                spill_queue_limit=cfg.queue_limit,
                clock=self.clock.now)
            self.fed_exchange = FederationExchange(
                self.fed_state,
                cluster="local",
                # The transport is the injected in-process fetch (the
                # same serve() surface the HTTP handler fronts; real-
                # wire long-poll is pinned by tests/test_federation.py)
                # — the partition/zombie machinery needs the seam. The
                # first peer keeps the historic bare URL (pinned
                # fingerprints); extra peers route by path suffix.
                peers={name: ("storm://peer" if name == fed.peer_name
                              else f"storm://peer/{name}")
                       for name in self.peer_pubs},
                serve=False,
                interval_s=fed.interval_s,
                wait_s=fed.wait_s,
                link_open_after=fed.link_open_after,
                link_open_s=fed.link_open_s,
                fetch=self._fed_fetch,
                seed=self.program.seed,
                clock=self.clock)
        self.picker = BatchingTPUPicker(
            self.scheduler, self.datastore, self.metrics_store,
            max_wait_s=cfg.batch_window_s,
            # Wave width capped at 48 so every wave fits the n=64 bucket
            # the warmup readies: a storm must never stall mid-crowd on
            # an inline warm of a bigger bucket.
            max_batch=48,
            lora_registry=self.lora_registry,
            resilience=self.resilience,
            federation=self.fed_state,
            clock=self.clock)
        self.server = StreamingServer(
            self.datastore, self.picker,
            on_served=self.picker.observe_served,
            on_response_complete=self.picker.observe_response_complete,
            on_stream_aborted=self.picker.observe_stream_aborted)
        self.scrape = ScrapeEngine(
            self.metrics_store, lora=self.lora_registry,
            interval_s=cfg.scrape_interval_s, max_backoff_s=0.2,
            fetcher=self._fetch_metrics, workers=2,
            breaker_board=self.board,
            clock=self.clock, rng=self._rng)
        self.resilience.staleness_fn = self.scrape.staleness_seconds
        self._sync_scrapers()
        # Autoscale loop (optional): the real recommender over the real
        # signal collector; actuation = pods joining this pool.
        self.collector = self.recommender = None
        if cfg.autoscale_max_extra > 0:
            self.collector = SignalCollector(
                self.metrics_store, self.datastore.local_endpoints,
                queue_limit=cfg.queue_limit, staleness_s=2.0,
                scrape_engine=self.scrape)
            self.recommender = AutoscaleRecommender(RecommenderConfig(
                min_replicas=pool.n_pods,
                max_replicas=pool.n_pods + cfg.autoscale_max_extra,
                shed_high_per_s=cfg.autoscale_shed_high_per_s,
                up_sustain_s=cfg.autoscale_up_sustain_s,
                down_cooldown_s=3600.0), model=CapacityModel())
        # Replication standby probe (optional): the leader's digest
        # publisher over the live scheduler state; failover_check events
        # fetch + decode it the way a follower would.
        self.publisher = None
        if cfg.standby:
            self.publisher = StatePublisher(
                {"sched": self.scheduler.export_state}, era="storm")

    def _slot_reclaimed(self, slot: int) -> None:
        self.scheduler.evict_endpoint(slot)
        self.metrics_store.remove(slot)
        self.scrape.detach(slot)
        if self.resilience.ejector is not None:
            self.resilience.ejector.drop(slot)

    def _add_pod(self, name: str, ip: str, scfg: StubConfig) -> None:
        hostport = f"{ip}:8000"
        self._stubs[hostport] = _StubSlot(VLLMStub(scfg, name=name))
        self._stubs[hostport].stub.hostport = hostport
        self.datastore.pod_update_or_add(
            Pod(name=name, labels={"app": "storm"}, ip=ip))
        self._pod_names.append(name)

    def _sync_scrapers(self) -> None:
        for ep in self.datastore.local_endpoints():
            self.scrape.attach(
                ep.slot, f"http://{ep.hostport}/metrics", VLLM)

    def _fetch_metrics(self, url: str) -> str:
        hostport = url.split("//", 1)[-1].split("/", 1)[0]
        with self._world_lock:
            slot = self._stubs.get(hostport)
            if slot is None or not slot.alive:
                raise ConnectionError(f"storm: {hostport} is down")
            return slot.stub.metrics_text()

    def _cluster_of(self, hostport: str) -> str:
        return self._peer_cluster.get(hostport, "local")

    def _fed_fetch(self, url, since, era, etag, wait_s):
        """PeerLink transport for federation storms: the real peer
        publishers over an in-process call. The FIRST peer (bare
        "storm://peer" URL) carries the chaos seams — the partition flag
        severing it and, after a split-brain heal, the ZOMBIE old-era
        publisher answering alternate polls (the deterministic
        interleave whose convergence the scorecard pins). Extra fleet
        peers ("storm://peer/<name>") always answer."""
        name = url.rsplit("/", 1)[-1] if url.count("/") > 2 else None
        if name is not None and name in self.peer_pubs:
            return self._serve_peer(name, since, era, etag, wait_s)
        if self._fed_partitioned:
            raise ConnectionError("storm: peer link partitioned")
        if self._zombie_pub is not None:
            self._zombie_alternator += 1
            if self._zombie_alternator % 2 == 0:
                # The zombie lineage: pre-failover era, still publishing.
                # No etag/delta: a zombie serves its own full frames.
                return self._zombie_pub.serve(wait_s=0.0)
        return self._fed_exchange_fetch(url, since, era, etag, wait_s)

    def _fed_exchange_fetch(self, url, since, era, etag, wait_s):
        return self.peer_pub.serve(
            since=since, era=era, if_none_match=etag,
            wait_s=min(wait_s, 0.2))

    def _serve_peer(self, name, since, era, etag, wait_s):
        return self.peer_pubs[name].serve(
            since=since, era=era, if_none_match=etag,
            wait_s=min(wait_s, 0.2))

    def _fetch_metrics(self, url: str) -> str:
        hostport = url.split("//", 1)[-1].split("/", 1)[0]
        with self._world_lock:
            slot = self._stubs.get(hostport)
            if slot is None or not slot.alive:
                raise ConnectionError(f"storm: {hostport} is down")
            return slot.stub.metrics_text()

    # -- message builders --------------------------------------------------

    def _headers_msg(self, a) -> pb.ProcessingRequest:
        hm = pb.HeaderMap()

        def add(k: str, v: str) -> None:
            hm.headers.append(pb.HeaderValue(key=k, raw_value=v.encode()))

        add(":method", "POST")
        add(":path", "/v1/completions")
        add("content-type", "application/json")
        if a.band != "standard":
            add(mdkeys.OBJECTIVE_KEY, a.band)
        if a.tenant:
            add(mdkeys.FLOW_FAIRNESS_ID_KEY, a.tenant)
        return pb.ProcessingRequest(
            request_headers=pb.HttpHeaders(headers=hm, end_of_stream=False))

    def _body_bytes(self, a) -> bytes:
        # What a client sends: the model (LoRA adapter or base), the
        # prompt (shared session prefix + unique suffix — real prefix-
        # affinity input for the scan + chunk hashes), and a max_tokens
        # cap (the power-of-two client hint; the TRUE decode length
        # stays engine-side).
        prompt = (self._sessions[a.session % len(self._sessions)]
                  + b"u%08x" % (hash((a.t, a.session)) & 0xFFFFFFFF))
        prompt = prompt[: max(a.prompt_bytes, 64)]
        if a.prompt_bytes > len(prompt):
            prompt = prompt + b"L" * (a.prompt_bytes - len(prompt))
        cap = 1 << max(4, int(np.ceil(np.log2(max(a.decode_tokens, 1.0)))))
        return json.dumps({
            "model": a.lora or "base-model",
            "prompt": prompt.decode("latin-1"),
            "max_tokens": int(cap),
        }).encode()

    def _body_msg(self, a) -> pb.ProcessingRequest:
        return pb.ProcessingRequest(
            request_body=pb.HttpBody(body=self._body_bytes(a),
                                     end_of_stream=True))

    @staticmethod
    def _resp_headers_msg(served: str, status: int) -> pb.ProcessingRequest:
        from google.protobuf import struct_pb2

        hm = pb.HeaderMap()
        hm.headers.append(pb.HeaderValue(
            key=":status", raw_value=str(status).encode()))
        req = pb.ProcessingRequest(
            response_headers=pb.HttpHeaders(headers=hm))
        if served:
            st = struct_pb2.Struct()
            st.fields[
                mdkeys.DESTINATION_ENDPOINT_SERVED_KEY].string_value = served
            req.metadata_context.filter_metadata[
                mdkeys.DESTINATION_ENDPOINT_NAMESPACE].CopyFrom(st)
        return req

    # -- data plane --------------------------------------------------------

    def _submit(self, stream: _StormStream) -> None:
        """The pick landed: hand the request to the destination stub.
        A dead destination is an Envoy local-reply 503 (client-visible);
        the response-headers hop then attributes it to the primary."""
        a = stream.arrival
        now = self.clock.now()
        self._pick_log.append((round(self._now(), 6), stream.dest, a.band))
        if self.fed_state is not None:
            cluster = self._cluster_of(stream.dest)
            self._fed_picks[(cluster, a.band)] += 1
            self._fed_pick_times.append((self._now(), cluster))
        with self._world_lock:
            slot = self._stubs.get(stream.dest)
            if slot is None or not slot.alive:
                stream.resolve("served", "", 503)
                return
            prompt_bytes = max(a.prompt_bytes, 64)
            rid = slot.stub.submit(
                b"p" * prompt_bytes, decode_tokens=a.decode_tokens,
                lora=a.lora)
            self._pending[(stream.dest, rid)] = _InFlight(
                stream, a, t_enqueue=getattr(stream, "t_enqueue", now),
                t_pick=now)

    def _serve_one(self, a) -> None:
        """One arrival, end to end through the ext-proc server."""
        tenant = a.tenant or "default"
        stream = _StormStream(self, a)
        stream.t_enqueue = self.clock.now()
        try:
            if self._admission is not None:
                # The acceptor-pool stage: queueing + service on the
                # assigned worker elapses BEFORE the ext-proc exchange,
                # so admission waits land inside the user TTFT.
                self._admission.admit()
            self.server.process(stream)
        except ExtProcError as e:
            if isinstance(e.__cause__, KernelUnavailable):
                self._kernel_failures.append(e.__cause__)
                return
            self._client_5xx.append(
                (self._now(), "extproc", f"{e.code}: {e}"))
            self._tenant_5xx[tenant] += 1
            return
        except Exception as e:  # engine bug surfacing as a stream error
            self._client_5xx.append(
                (self._now(), "internal", f"{type(e).__name__}: {e}"))
            self._tenant_5xx[tenant] += 1
            return
        finally:
            self._sem.release()
        if stream.immediate_code is not None:
            if stream.immediate_code >= 500:
                self._client_5xx.append(
                    (self._now(), "immediate", stream.immediate_code))
                self._tenant_5xx[tenant] += 1
            else:
                self._shed += 1
                self._tenant_shed[tenant] += 1
                self._shed_bands[a.band] += 1
            return
        res = stream.resolution
        if res is None:
            # No pick, no immediate response: the server closed the
            # stream without answering (should not happen).
            self._client_5xx.append((self._now(), "unanswered", ""))
            self._tenant_5xx[tenant] += 1
            return
        kind, _served, status = res
        if kind == "timeout":
            self._timeouts += 1
            self._client_5xx.append((self._now(), "timeout", stream.dest))
            self._tenant_5xx[tenant] += 1
        elif kind == "reset":
            self._resets.append((self._now(), stream.dest))
        elif status >= 500:
            self._client_5xx.append((self._now(), "serve", stream.dest))
            self._tenant_5xx[tenant] += 1
        else:
            self._ok += 1
            self._tenant_ok[tenant] += 1
            if self.fed_state is not None:
                self._fed_serves[self._cluster_of(_served)] += 1

    def _now(self) -> float:
        return self.clock.now() - self._t0

    # -- world loop --------------------------------------------------------

    def _world_tick(self, dt: float) -> None:
        """Advance every stub, resolve first tokens, finalize
        completions, reap empty zombies."""
        resolved: list[tuple[_InFlight, str, float]] = []
        finished: list[tuple[_InFlight, object]] = []
        with self._world_lock:
            for hostport, slot in list(self._stubs.items()):
                comps = slot.stub.step(dt)
                # First-token scan: the response-headers hop fires at
                # TTFT, while decode continues (the serve latency the
                # breakers/ejector see is TTFT).
                for r in slot.stub.running:
                    if r.first_token_at >= 0:
                        inf = self._pending.get((hostport, r.rid))
                        if inf is not None and not inf.resolved:
                            inf.resolved = True
                            resolved.append((inf, hostport, r.first_token_at))
                for c in comps:
                    inf = self._pending.pop((hostport, c.rid), None)
                    if inf is not None:
                        finished.append((inf, c))
                if slot.zombie and not slot.stub.running \
                        and not slot.stub.queue:
                    del self._stubs[hostport]
        for inf, hostport, _t_ft in resolved:
            inf.stream.resolve("served", hostport, 200)
        for inf, c in finished:
            if not inf.resolved:
                # Completed within one tick: resolve late, still a 200.
                inf.resolved = True
                inf.stream.resolve("served", inf.stream.dest, 200)
            # User TTFT spans the whole chain: the ext-proc leg (enqueue
            # to pick) plus the stub's submit-relative TTFT (queue +
            # prefill). Tokens at the TRUE generated length.
            ttft = (inf.t_pick - inf.t_enqueue) + c.ttft_s
            self._completions.append(
                (ttft, float(c.output_tokens),
                 inf.arrival.tenant or "default"))

    def _autoscale_tick(self) -> None:
        # The signal window and the store's row stamps must share one
        # clock family: virtual now in virtual mode, the collector's
        # wall-clock default otherwise (matching the store's default).
        now = self.clock.now() if self.virtual else None
        sig = self.collector.sample(now=now)
        current = len(self.datastore.local_endpoints())
        rec = self.recommender.observe(sig, current=current, now=now)
        if rec.desired > current:
            base = len(self._pod_names)
            for k in range(rec.desired - current):
                self._add_pod(
                    f"as{base + k}",
                    f"{self.pool.replacement_ip_base}.{200 + base + k}",
                    self.pool.stub_cfgs()[0])
            self._sync_scrapers()
            self._autoscale_events.append({
                "t": round(self._now(), 3), "from": current,
                "to": rec.desired, "reason": rec.reason})

    def _control_event(self, ev) -> None:
        """Rolling-upgrade steps, standby probes and the federation's
        drain, partition and heal."""
        if ev.kind == "drain":
            i = ev.args[0]
            name = f"p{i}"
            hostport = f"{self.pool.ip_base}.{i + 1}:8000"
            if self.datastore.pod_mark_draining("default", name):
                self._upgrades.append({
                    "t": round(self._now(), 3), "pod": name,
                    "step": "drain", "hostport": hostport})
        elif ev.kind == "replace":
            i = ev.args[0]
            name = f"p{i}"
            hostport = f"{self.pool.ip_base}.{i + 1}:8000"
            self.datastore.pod_delete("default", name)
            with self._world_lock:
                slot = self._stubs.get(hostport)
                if slot is not None:
                    # The kubelet grace window: in-flight streams finish
                    # on the terminating pod, new connects are refused.
                    slot.alive = False
                    slot.zombie = True
            self._add_pod(
                f"{name}-r", f"{self.pool.replacement_ip_base}.{i + 1}",
                self.pool.stub_cfgs()[min(i, len(self.pool.stub_cfgs()) - 1)])
            self._sync_scrapers()
            self._upgrades.append({
                "t": round(self._now(), 3), "pod": name,
                "step": "replace", "hostport": hostport})
        elif ev.kind == "failover_check" and self.publisher is not None:
            self._failover_probe()
        elif ev.kind == "cluster_drain" and self.fed_exchange is not None:
            # Whole-cluster drain: new picks bleed to the peer, the flag
            # publishes so peers stop spilling in (docs/FEDERATION.md).
            self.fed_exchange.set_draining(True)
            self._fed_events.append(
                {"t": round(self._now(), 3), "event": "cluster_drain"})
        elif ev.kind == "peer_partition" and self.fed_exchange is not None:
            self._fed_partitioned = True
            self._fed_events.append(
                {"t": round(self._now(), 3), "event": "partition"})
        elif ev.kind == "peer_heal" and self.fed_exchange is not None:
            flip_era = bool(ev.args and ev.args[0])
            if flip_era:
                # The far side failed over during the partition: its NEW
                # publisher carries a greater era, while the OLD lineage
                # (the zombie) keeps answering alternate polls after the
                # heal — the split-brain interleave.
                self._zombie_pub = _ZombieSnapshot(self.peer_pub)
                self.peer_pub.bump_era()
                self.peer_pub.refresh()
            self._fed_partitioned = False
            self._fed_events.append(
                {"t": round(self._now(), 3), "event": "heal",
                 "flip_era": flip_era})

    def _failover_probe(self) -> None:
        """Warm-standby readiness: publish the live digest, fetch and
        decode it the way a follower would. The probe asserts nothing
        itself — the scorecard records epoch and decoded-section evidence
        for the test to pin."""
        self.publisher.refresh()
        status, _headers, body = self.publisher.serve(
            since=None, era=None, if_none_match=None)
        n_arrays = 0
        digest = codec.decode_digest(body) if status == 200 else None
        if digest is not None:
            n_arrays = sum(len(v) for v in digest.sections.values())
        self._failover_checks.append({
            "t": round(self._now(), 3), "status": int(status),
            "epoch": self.publisher.status().get("epoch"),
            "decoded_arrays": n_arrays,
            "ok": bool(digest is not None and n_arrays > 0)})

    # -- run ---------------------------------------------------------------

    def warmup(self, schedule: Optional[Schedule] = None) -> None:
        """Ready the wave lattices OUTSIDE the storm window (on the card:
        capture their cycles; a bounded fault schedule must not burn out
        during a first-pick capture, and a mid-run capture stalls every
        pick behind it). Bodies must be REAL-SHAPED: the lattice is keyed
        by the chunk-lane bucket of the wave's longest body. One solo pick
        sizes bucket 1; concurrent bursts of 8 and 12 size buckets 8 and
        64 — every size the 48-wide waves can reach — for each distinct
        chunk-lane bucket the schedule's prompt-length classes map to.

        Federation first: the peer's endpoints are IMPORTED before the warm
        picks run, so the M bucket covering the remote slots is readied
        here — a first spill's inline capture mid-crowd would stall every
        pick behind it."""
        self._start_federation()
        tc = self.program.traffic
        sizes = {tc.system_prompt_bytes + tc.user_suffix_bytes}
        if schedule is not None:
            sizes.update(a.prompt_bytes for a in schedule.arrivals)
        # One warm body per distinct CHUNK-LANE BUCKET (the lattice key),
        # not per raw byte length.
        bodies: dict[int, bytes] = {}
        for pb_ in sorted(sizes):
            body = self._body_bytes(Arrival(
                t=0.0, session=0, prompt_bytes=pb_, decode_tokens=16.0))
            _, counts = batch_chunk_hashes([body])
            bodies.setdefault(chunk_bucket_for(int(counts.max())), body)

        for body in bodies.values():
            self._harness_pick(body)
            for n in (8, 12):
                # Concurrent burst with a CLOCK-MEDIATED join: the last
                # finisher sets the done event through the clock, so in
                # virtual mode the main thread parks (letting the
                # batching window fire) instead of blocking the advance
                # rule in a real join.
                done = threading.Event()
                finished = itertools.count(1)  # atomic ticket

                def burst(body=body, n=n, done=done, finished=finished):
                    try:
                        self._harness_pick(body)
                    except KernelUnavailable as e:
                        self._kernel_failures.append(e)
                    finally:
                        if next(finished) == n:
                            self.clock.set_event(done)

                ts = [self.clock.actor_thread(burst, name="storm-warm")
                      for _ in range(n)]
                [t.start() for t in ts]
                self.clock.wait_event(done, 600.0)
                [t.join(timeout=60) for t in ts]
                self._raise_kernel_failure()

    def _start_federation(self) -> None:
        """Start the exchange (idempotent) and block briefly until the
        first peer digest installs — remote slots must exist before
        warmup sizes the M bucket."""
        if self.fed_exchange is None or getattr(self, "_fed_started", False):
            return
        self._fed_started = True
        self.fed_exchange.start()
        deadline = self.clock.now() + 5.0
        links = list(self.fed_exchange.links.values())
        while (self.clock.now() < deadline
               and any(link.installs == 0 for link in links)):
            self.clock.sleep(0.02)

    def _harness_pick(self, body: bytes) -> None:
        """A pick the harness makes (warm-up, recovery probes): its
        refusals are ignored, a kernel that cannot run here is raised."""
        try:
            self.picker.pick(PickRequest(headers={}, body=body),
                             self.datastore.pick_candidates())
        except ExtProcError as e:
            if isinstance(e.__cause__, KernelUnavailable):
                raise e.__cause__
        except Exception:
            pass

    def _spawn_worker(self, a) -> threading.Thread:
        self._workers_live += 1

        def serve():
            try:
                self._serve_one(a)
            finally:
                # GIL-atomic int decrement; the drain loop polls it on
                # the engine clock.
                self._workers_live -= 1

        w = self.clock.actor_thread(serve, name="storm-worker")
        w.start()
        return w

    def run(self, schedule: Optional[Schedule] = None,
            warmup: bool = True) -> StormResult:
        cfg = self.cfg
        if schedule is None:
            schedule = self.program.compile()
        self._start_federation()
        if warmup:
            self.warmup(schedule)
        if cfg.force_rung is not None:
            self.resilience.ladder.force_level(Rung(cfg.force_rung))
        self._t0 = self.clock.now()
        world = self.clock.actor_thread(self._world_loop, name="storm-world")
        world.start()
        workers: list[threading.Thread] = []
        events = list(schedule.events)
        next_ev = 0
        try:
            for a in schedule.arrivals:
                self._raise_kernel_failure()
                # ONE timeline: due control events fire (at their own
                # times) before the next arrival; events trailing the
                # last arrival drain in the loop below.
                while next_ev < len(events) and events[next_ev].t <= a.t:
                    ev = events[next_ev]
                    next_ev += 1
                    self._wait_until(ev.t)
                    self._control_event(ev)
                self._wait_until(a.t)
                if not self._sem.acquire(blocking=False):
                    # Client-side concurrency cap: the submitter must
                    # NEVER block. Skipped arrivals are load the clients
                    # never offered; the scorecard records them.
                    self._client_skipped += 1
                    continue
                workers.append(self._spawn_worker(a))
                if self.virtual:
                    # Yield one advance cycle so the spawned worker runs
                    # to its first park before the next arrival: same-
                    # instant arrivals would otherwise race their flow-
                    # queue enqueues.
                    self.clock.sleep(0.0)
            while next_ev < len(events):
                ev = events[next_ev]
                next_ev += 1
                self._wait_until(ev.t)
                self._control_event(ev)
            self._wait_until(schedule.traffic.duration_s)
            # Drain: let in-flight serves finish (bounded). Virtual mode
            # polls the engine-owned counter on the virtual clock; real
            # mode joins.
            deadline = self.clock.now() + 20.0
            if self.virtual:
                while (self._workers_live > 0
                       and self.clock.now() < deadline):
                    self.clock.sleep(0.05)
            else:
                for w in workers:
                    w.join(timeout=max(deadline - self.clock.now(), 0.0))
            self._raise_kernel_failure()
            # Recovery window: keep the world (and probes) ticking until
            # the ladder climbs home or the bounded window ends.
            recover_until = self.clock.now() + 10.0
            while (self.clock.now() < recover_until
                   and cfg.force_rung is None
                   and self.resilience.ladder.rung() != Rung.FULL):
                self._harness_pick(b"probe")
                self.clock.sleep(0.05)
        finally:
            self._stop.set()
            # The fault counts at the storm's end, read while the main
            # actor still holds the clock: after it ends, scrapes made
            # while the world joins and the card is scored keep drawing
            # (the scorecard's fault_fired, read later, takes those in).
            inj = faults.installed()
            self._fault_fired = dict(inj.fired) if inj is not None else {}
            # Unregister BEFORE joining: a virtual clock only advances
            # (and wakes the world loop so it can observe _stop) while
            # no registered actor is active.
            if self._main_tok is not None:
                self.clock.actor_end(self._main_tok)
                self._main_tok = None
            world.join(timeout=10)
        card = self._score(schedule)
        result = StormResult(card, schedule, self.resilience, self.board,
                             self.scheduler, self.datastore)
        result.fault_fired_in_storm = self._fault_fired
        return result

    def _raise_kernel_failure(self) -> None:
        if self._kernel_failures:
            raise self._kernel_failures[0]

    def close(self) -> None:
        if self._main_tok is not None:
            # run() never happened: release the main actor so teardown's
            # parked threads can be woken.
            self.clock.actor_end(self._main_tok)
            self._main_tok = None
        if getattr(self, "fed_exchange", None) is not None:
            self.fed_exchange.stop()
        for part in ("scrape", "picker"):      # absent if the build failed
            if hasattr(self, part):
                getattr(self, part).close()
        if self.virtual:
            faults.set_clock(None)
            self.clock.shutdown()

    def _wait_until(self, t_storm: float) -> None:
        delay = (self._t0 + t_storm) - self.clock.now()
        if delay > 0:
            self.clock.sleep(delay)

    def _world_loop(self) -> None:
        cfg = self.cfg
        next_autoscale = cfg.autoscale_interval_s
        next_trace = 0.0
        last = self.clock.now()
        while not self._stop.is_set():
            self.clock.sleep(cfg.world_dt_s)
            now = self.clock.now()
            dt, last = now - last, now
            try:
                self._world_tick(min(dt, 0.25))
            except Exception:
                pass  # the world must keep turning
            t = self._now()
            if t >= next_trace:
                next_trace = t + 0.1
                self._rung_trace.append(
                    (round(t, 2), int(self.resilience.ladder.rung())))
                self._pool_trace.append(
                    (round(t, 2), len(self.datastore.local_endpoints())))
                if self.fed_exchange is not None:
                    # Keep cross-cluster state flowing (the long-poll
                    # push needs fresh epochs) and record the local-only
                    # verdict timeline the partition property is
                    # asserted on.
                    try:
                        for pub in self.peer_pubs.values():
                            pub.refresh()
                        self.fed_state.observe()
                    except Exception:
                        pass
                    link = next(iter(self.fed_exchange.links.values()))
                    view = self.fed_state._peers.get(link.name)
                    self._fed_local_only_trace.append(
                        (round(t, 2),
                         1 if (view is None or view.local_only) else 0))
            if self.recommender is not None and t >= next_autoscale:
                next_autoscale = t + cfg.autoscale_interval_s
                try:
                    self._autoscale_tick()
                except Exception:
                    pass

    # -- scoring -----------------------------------------------------------

    def _decision_fingerprint(self) -> str:
        """Digest of the run's DECISION SEQUENCE — every landed pick (in
        order, with its timestamp and band), every shed/error tally, the
        breaker transition order, the rung/pool traces and the control-
        plane outcomes: the reference's fields, so the digests compare
        across the two packages. "fed_picks" is the value the reference
        records with federation off."""
        ej = (self.resilience.ejector.ejections
              if self.resilience.ejector is not None else [])
        decisions = {
            "picks": self._pick_log,
            "ok": self._ok,
            "shed": self._shed,
            "client_5xx": len(self._client_5xx),
            "resets": len(self._resets),
            "timeouts": self._timeouts,
            "client_skipped": self._client_skipped,
            "shed_by_band": {k: self._shed_bands[k]
                             for k in sorted(self._shed_bands)},
            "tenant_ok": {k: self._tenant_ok[k]
                          for k in sorted(self._tenant_ok)},
            "tenant_shed": {k: self._tenant_shed[k]
                            for k in sorted(self._tenant_shed)},
            "breaker_events": list(self.board.events),
            "rung_trace": self._rung_trace,
            "pool_trace": self._pool_trace,
            "ejection_slots": [int(e[1]) for e in ej],
            "autoscale": [(e["from"], e["to"])
                          for e in self._autoscale_events],
            "upgrades": [(u["step"], u["pod"]) for u in self._upgrades],
            "fed_picks": sorted(
                (c, b, n) for (c, b), n in self._fed_picks.items()),
        }
        if self._admission is not None:
            decisions["extproc_accepts"] = self._admission.accepts()
        return hashlib.sha256(json.dumps(
            decisions, sort_keys=True, default=float).encode()).hexdigest()

    def _score(self, schedule: Schedule) -> dict:
        ttfts = [c[0] for c in self._completions]
        tokens = [c[1] for c in self._completions]
        duration = schedule.traffic.duration_s
        core = scorecard_mod.score_completions(
            ttfts, tokens, duration, self.cfg.ttft_slo_s)
        serve_ms = sorted(t * 1e3 for t in ttfts)

        def pct(p):
            if not serve_ms:
                return 0.0
            return float(serve_ms[min(int(p * (len(serve_ms) - 1)),
                                      len(serve_ms) - 1)])

        rungs = [r for _, r in self._rung_trace] or [0]
        ej = (self.resilience.ejector.ejections
              if self.resilience.ejector is not None else [])
        # Per-tenant breakdowns, scored with the SAME definitions as the
        # cluster-level numbers.
        arrivals_by_tenant: dict[str, int] = {}
        for a in schedule.arrivals:
            key = a.tenant or "default"
            arrivals_by_tenant[key] = arrivals_by_tenant.get(key, 0) + 1
        comps_by_tenant: dict[str, list] = {}
        for c in self._completions:
            comps_by_tenant.setdefault(c[2], []).append(c)
        per_tenant = {}
        tenant_keys = (set(arrivals_by_tenant) | set(comps_by_tenant)
                       | set(self._tenant_ok) | set(self._tenant_shed)
                       | set(self._tenant_5xx))
        for tenant in sorted(tenant_keys):
            comps = comps_by_tenant.get(tenant, [])
            core_t = scorecard_mod.score_completions(
                [c[0] for c in comps], [c[1] for c in comps],
                duration, self.cfg.ttft_slo_s)
            per_tenant[tenant] = {
                "arrivals": arrivals_by_tenant.get(tenant, 0),
                "ok": self._tenant_ok.get(tenant, 0),
                "shed": self._tenant_shed.get(tenant, 0),
                "client_5xx": self._tenant_5xx.get(tenant, 0),
                "completed": len(comps),
                **core_t,
            }
        card = {
            "schema": scorecard_mod.SCHEMA,
            "name": self.name,
            "seed": schedule.seed,
            "duration_s": duration,
            "schedule_fingerprint": schedule.fingerprint(),
            "arrivals": len(schedule.arrivals),
            "completed": len(self._completions),
            "ok": self._ok,
            "shed": self._shed,
            "client_5xx": len(self._client_5xx),
            "client_5xx_detail": [
                {"t": round(t, 3), "phase": p, "detail": str(d)}
                for t, p, d in self._client_5xx[:20]],
            "resets": len(self._resets),
            "timeouts": self._timeouts,
            "client_skipped": self._client_skipped,
            "per_tenant": per_tenant,
            "shed_by_band": dict(self._shed_bands),
            **core,
            "serve_latency_p50_ms": round(pct(0.50), 1),
            "serve_latency_p99_ms": round(pct(0.99), 1),
            "max_rung": int(max(rungs)),
            "final_rung": int(self.resilience.ladder.rung()),
            "rung_trace": self._rung_trace,
            "pool_size_trace": self._pool_trace,
            "breaker_opens": dict(self.board.states()),
            "ejections": [
                {"t": round(max(t - self._t0, 0.0), 3), "slot": s,
                 "endpoint_q_s": round(q, 4),
                 "pool_median_s": round(m, 4)}
                for t, s, q, m in ej],
            "upgrades": self._upgrades,
            "autoscale_events": self._autoscale_events,
            "failover_checks": self._failover_checks,
            "final_endpoints": sorted(
                ep.hostport for ep in self.datastore.endpoints()),
            "lora_arrivals": sum(
                1 for a in schedule.arrivals if a.lora is not None),
            "long_context_arrivals": sum(
                1 for a in schedule.arrivals if a.kind == "long_context"),
            # Whether the run executed on the virtual clock, the ordered
            # breaker transition log (no timestamps on purpose: compared
            # across clock modes), and the decision-sequence digest.
            "virtual_time": self.virtual,
            "breaker_events": [list(e) for e in self.board.events],
            "decision_fingerprint": self._decision_fingerprint(),
        }
        if self._admission is not None:
            card["extproc"] = self._admission.report()
        if hasattr(self.scheduler, "fleet_report"):
            # Hierarchical-picker section: coarse-stage provenance (top-K
            # hit ranks, hot cells, compression).
            card["fleet"] = self.scheduler.fleet_report()
        if self.fed_state is not None:
            # Per-cluster federation section: the four pinned
            # properties — spill with CRITICAL locality, drain bleed,
            # partition -> local-only within the staleness window, and
            # deterministic era convergence on heal — are all asserted
            # on these fields (tests/test_storm.py).
            fed = self.cfg.federation
            link = next(iter(self.fed_exchange.links.values()))
            picks_by_cluster: dict = {}
            crit_remote = 0
            for (cluster, band), n in self._fed_picks.items():
                per = picks_by_cluster.setdefault(
                    cluster, {"total": 0, "bands": {}})
                per["total"] += n
                per["bands"][band] = per["bands"].get(band, 0) + n
                if cluster != "local" and band == "critical":
                    crit_remote += n
            card["federation"] = {
                "peer": fed.peer_name,
                "peers": sorted(self.peer_pubs),
                "local_only_after_s": fed.local_only_after_s,
                "picks": picks_by_cluster,
                "serves": dict(self._fed_serves),
                "critical_remote_picks": crit_remote,
                "pick_times": [
                    (round(t, 3), c) for t, c in self._fed_pick_times],
                "local_only_trace": self._fed_local_only_trace,
                "events": self._fed_events,
                "link": link.report(),
                "peer_era": list(self.peer_pub.era),
                "matrix": self.fed_state.capacity_matrix(),
                "draining": self.fed_state.draining,
            }
        return card


# -- scenario-file entry point --------------------------------------------

# Everything a drive.storm section may carry: the Program inputs plus
# the whitelisted engine knobs run_scenario applies.
_STORM_DRIVE_KEYS = frozenset({
    "base_qps", "duration_s", "traffic", "shapes", "pool",
    "ttft_slo_s", "autoscale_max_extra", "queue_limit",
    "max_concurrency", "federation",
    "virtual_time", "scrape_interval_s", "world_dt_s",
    "autoscale_interval_s",
    "extproc_workers", "extproc_admission_s",
    "fleet_topk", "fleet_cell_cap", "mesh_devices",
})


def engine_from_drive(storm: dict, *, seed: int,
                      pool: Optional[PoolSpec] = None,
                      cfg: Optional[EngineConfig] = None,
                      name: str = "storm",
                      virtual_time: Optional[bool] = None,
                      device=None,
                      noise_source: Optional[Callable] = None) -> StormEngine:
    """A StormEngine from a ``drive.storm`` dict: the Program compile,
    the pool spec, the whitelisted engine knobs, the federation block,
    and the standby inference — shared by :func:`run_scenario` and the
    parameter-search harness (storm/search.py)."""
    unknown = set(storm) - _STORM_DRIVE_KEYS
    if unknown:
        # A typoed knob silently falling back to a default would replay
        # a DIFFERENT storm than the file records.
        raise ValueError(
            f"storm drive {name!r}: unknown drive.storm keys "
            f"{sorted(unknown)}; known: {sorted(_STORM_DRIVE_KEYS)}")
    program = program_from_drive(storm, seed=seed)
    pool_kw = dict(storm.get("pool") or {})
    if pool is None and pool_kw:
        unknown = set(pool_kw) - {
            f.name for f in dataclasses.fields(PoolSpec)}
        if unknown:
            raise ValueError(f"unknown storm pool fields {sorted(unknown)}")
        pool = PoolSpec(**pool_kw)
    if cfg is None:
        cfg = EngineConfig()
    # Whitelisted engine knobs a scenario may pin (everything else in
    # EngineConfig is harness policy, not scenario content).
    for key, cast in (("ttft_slo_s", float), ("autoscale_max_extra", int),
                      ("queue_limit", float), ("max_concurrency", int),
                      ("virtual_time", bool), ("scrape_interval_s", float),
                      ("world_dt_s", float),
                      ("autoscale_interval_s", float),
                      ("extproc_workers", int),
                      ("extproc_admission_s", float),
                      ("fleet_topk", int), ("fleet_cell_cap", int),
                      ("mesh_devices", int)):
        if key in storm:
            cfg = dataclasses.replace(cfg, **{key: cast(storm[key])})
    if "federation" in storm:
        fed_kw = dict(storm["federation"] or {})
        unknown = set(fed_kw) - {
            f.name for f in dataclasses.fields(FederationSpec)}
        if unknown:
            raise ValueError(
                f"unknown storm federation fields {sorted(unknown)}")
        cfg = dataclasses.replace(cfg, federation=FederationSpec(**fed_kw))
    if any(s.get("kind") == "standby_failover"
           for s in storm.get("shapes") or []):
        # failover_check events need the replication publisher armed.
        cfg = dataclasses.replace(cfg, standby=True)
    # An explicit caller clock-mode override beats the scenario's pinned
    # key, so this comes last.
    if virtual_time is not None:
        cfg = dataclasses.replace(cfg, virtual_time=bool(virtual_time))
    return StormEngine(program, pool=pool, cfg=cfg, name=name,
                       device=device, noise_source=noise_source)


def run_scenario(name_or_path: str, *, seed: Optional[int] = None,
                 pool: Optional[PoolSpec] = None,
                 cfg: Optional[EngineConfig] = None,
                 dump_dir: Optional[str] = None,
                 virtual_time: Optional[bool] = None,
                 device=None,
                 noise_source: Optional[Callable] = None) -> StormResult:
    """Replay a recorded scenario whose ``drive`` carries a ``storm``
    section: arm the scenario's chaos rules (AFTER warmup), execute the
    storm program against the stack, and score it."""
    scn = scenarios_mod.load(name_or_path)
    storm = (scn.drive or {}).get("storm")
    if not isinstance(storm, dict):
        raise ValueError(
            f"scenario {scn.name!r} has no drive.storm section — not a "
            "storm scenario (see docs/STORM.md)")
    engine = engine_from_drive(
        storm, seed=scn.seed if seed is None else seed,
        pool=pool, cfg=cfg, name=scn.name, virtual_time=virtual_time,
        device=device, noise_source=noise_source)
    program = engine.program
    try:
        schedule = program.compile()
        engine.warmup(schedule)
        # Arm AFTER warmup: bounded fault schedules (after=/max_fires=)
        # must spend their draws on storm waves, not warm stalls.
        inj = scn.arm() if scn.rules else None
        try:
            result = engine.run(schedule=schedule, warmup=False)
        finally:
            if inj is not None:
                faults.uninstall()
        result.scorecard["fault_log_len"] = len(inj.log) if inj else 0
        result.scorecard["fault_fired"] = dict(inj.fired) if inj else {}
        if dump_dir:
            result.scorecard["artifact"] = scorecard_mod.dump(
                result.scorecard, dump_dir, name=scn.name)
        return result
    finally:
        engine.close()
