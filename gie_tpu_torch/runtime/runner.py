"""ExtProcServerRunner: wiring + lifecycle (port of gie_tpu/runtime/runner.py).

Mirror of reference pkg/lwepp/server/runserver.go:45-157 + cmd/lwepp/main.go:
build the full stack (datastore + reconcilers + scraper + scheduler +
batching picker + ext-proc gRPC + dual health + metrics), start the
dedicated health listener before cache sync, serve, and stop gracefully on
context/signal (internal/runnable/grpc.go:44-57 GracefulStop).

With no injected scheduler the runner builds `Scheduler(*tuned_profile())`
(or `--scheduler-config`) with no device argument, so it runs on the CUDA
card and raises where there is none. The resilience layer (breaker
board, degradation ladder, outlier ejection, --fault / --fault-scenario
injection) and the observability layer (flight recorder, tracer, OTLP
export, /debugz pages, dump rotation) are wired as the reference wires
them, both on by default. So are the KV-event listener
(--kv-events-port), the learned scorer (--scorer learned), leader election
on a file lease (--leader-elect; readiness then gates on leadership), HA
state replication (--replication-port: the leader publishes its digest,
followers install it and promote warm) and the recommend-only autoscale
loop (--autoscale-mode recommend), and so is multi-cluster federation
(--fed-cluster, --fed-peer, --fed-port, --fed-drain: the digest exchange
with every peer, imported peer endpoints in the slot space, the spill
policy in the picker, /debugz/federation), and so is the fleet picker
(--fleet-topk, --fleet-cell-cap: the hierarchical two-level pick of
gie_tpu_torch/fleet, /debugz/fleet), and so is the latency predictor
(--enable-predictor: an OnlineTrainer on the scheduler's device fed by
served and response-complete feedback, SLO admission in the picker, a
train thread that hands its params to the scheduler and phases the
column in, --predictor-checkpoint-dir, the autoscale loop's TTFT probe
and the replication digest's "predictor" section; the cycle binds the
column only when --scheduler-config gives weights.latency > 0), and so
are the kube deployment's pieces: over a kube cluster client (main's
--kube) --leader-elect elects on a coordination.k8s.io Lease
(KubeLeaseElector) and --autoscale-mode apply SSA-patches the target
Deployment's spec.replicas, and so is the multi-device mesh
(--mesh-devices N: make_mesh(N) over the first N cards, dp x tp, served
by Scheduler(mesh=) or a FleetPicker that keeps it as its deploy_mesh;
parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import grpc

from gie_tpu_torch import __version__, obs
from gie_tpu_torch.api.objectives import InferenceObjective, ObjectiveRegistry
from gie_tpu_torch.api.types import GROUP
from gie_tpu_torch.autoscale import (
    AutoscaleController,
    AutoscaleRecommender,
    CapacityModel,
    RecommenderConfig,
    ReplicaActuator,
    SignalCollector,
)
from gie_tpu_torch.controller.cluster import ClusterClient
from gie_tpu_torch.controller.reconcilers import (
    InferencePoolReconciler,
    PodReconciler,
    wire,
)
from gie_tpu_torch.datastore import Datastore
from gie_tpu_torch.extproc.server import StreamingServer
from gie_tpu_torch.extproc.workers import ExtProcWorkerPool
from gie_tpu_torch.fairness import FairnessConfig, FairnessState, parse_weights
from gie_tpu_torch.federation import FederationExchange, FederationState
from gie_tpu_torch.learn import artifact as artifact_mod
from gie_tpu_torch.learn.policy import weights_from_mapping
from gie_tpu_torch.metricsio import MetricsStore
from gie_tpu_torch.metricsio.engine import ScrapeEngine
from gie_tpu_torch.metricsio.mappings import BY_NAME
from gie_tpu_torch.obs.otlp import OtlpSpanExporter
from gie_tpu_torch.obs.recorder import DumpRotator, FlightRecorder
from gie_tpu_torch.obs.trace import Tracer
from gie_tpu_torch.resilience import (
    DegradationLadder,
    LadderConfig,
    OutlierConfig,
    OutlierEjector,
    ResilienceState,
    faults,
    scenarios,
)
from gie_tpu_torch.runtime import metrics as own_metrics
from gie_tpu_torch.replication import ReplicationManager, replication_identity
from gie_tpu_torch.runtime.health import HealthService, start_dedicated_health_server
from gie_tpu_torch.runtime.leader import KubeLeaseElector, LeaseFileElector
from gie_tpu_torch.runtime.logging import get_logger
from gie_tpu_torch.runtime.options import Options
from gie_tpu_torch.runtime.tls import server_credentials
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.batching import BatchingTPUPicker
from gie_tpu_torch.sched.config import load_scheduler_config_file, tuned_profile
from gie_tpu_torch.sched.kvevents import KVEventAggregator, KVEventHTTPServer
from gie_tpu_torch.sched.profile import Scheduler, feature_schema
from gie_tpu_torch.utils.kubemeta import GKNN
from gie_tpu_torch.utils.lora import LoraRegistry


class ExtProcServerRunner:
    def __init__(
        self,
        opts: Options,
        cluster: ClusterClient,
        scheduler: Optional[Scheduler] = None,
    ):
        self.opts = opts
        self.log = get_logger("runner")
        self.cluster = cluster
        self.lora_registry = LoraRegistry()
        # The latency predictor's online trainer (--enable-predictor);
        # None with an injected scheduler, as in the reference.
        self.trainer = None
        # gie-learn: the loaded policy artifact (--scorer learned), for
        # /debugz/policy and gie_policy_info.
        self.policy_artifact = None
        if scheduler is not None:
            self.scheduler = scheduler
        else:
            # Production default: the swept tuned profile; an explicit
            # --scheduler-config replaces it wholesale. No device argument:
            # the scheduler runs on the card, and raises without one.
            cfg, weights = tuned_profile()
            if opts.scheduler_config:
                cfg, weights = load_scheduler_config_file(opts.scheduler_config)
            if opts.scorer == "learned":
                # The trained multiplicative policy: checksum-verified and
                # its feature schema validated against THIS profile's live
                # columns, so a stale artifact fails startup. Its
                # exponents replace the weights wholesale (absent columns
                # at 0.0, the multiplicative no-op).
                art = artifact_mod.load_artifact(opts.policy_artifact)
                artifact_mod.validate_feature_schema(art, feature_schema(
                    cfg, has_predictor=opts.enable_predictor))
                cfg = dataclasses.replace(cfg, scorer="learned")
                weights = weights_from_mapping(
                    artifact_mod.artifact_weight_values(art))
                self.policy_artifact = art
                self.log.info(
                    "learned policy loaded", path=opts.policy_artifact,
                    checksum=art["checksum"],
                    columns=list(art["feature_schema"]),
                    promoted=bool(
                        (art.get("judgment") or {}).get("promote")))
            predictor_fn = predictor_params = None
            if opts.enable_predictor:
                # The learned TTFT/TPOT column with online training; it
                # composes with --scheduler-config. The trainer runs on
                # the card, as the scheduler does.
                from gie_tpu_torch.models.latency import (
                    LatencyPredictor,
                    OnlineTrainer,
                    predictor_score_fn,
                )

                predictor = LatencyPredictor()
                self.trainer = OnlineTrainer(predictor)
                if opts.predictor_checkpoint_dir:
                    if self.trainer.restore(opts.predictor_checkpoint_dir):
                        self.log.info("predictor checkpoint restored",
                                      dir=opts.predictor_checkpoint_dir)
                # Bind the column into the cycle ONLY when a weight
                # ceiling is configured: SLO admission runs its own
                # forward (OnlineTrainer.predict_ttft), and with ceiling 0
                # every wave would pay the [N, M] MLP for a column
                # multiplied by zero. The ceiling is not a live weight:
                # the Scheduler starts the column at 0 and _train_loop
                # phases it in as OnlineTrainer.confidence converges.
                if float(weights.latency) > 0.0:
                    predictor_fn = predictor_score_fn(predictor)
                    predictor_params = self.trainer.params
            mesh = None
            if opts.mesh_devices > 1:
                from gie_tpu_torch.parallel.mesh import make_mesh

                # The full dp x tp layout (docs/MESH.md): requests split
                # on dp, endpoints (metrics, cost-matrix columns, assumed
                # load, Sinkhorn duals, prefix words) on tp; picks are
                # bit-identical to one card's at every layout.
                mesh = make_mesh(opts.mesh_devices)
                self.log.info("multi-chip scheduling mesh",
                              shape=dict(mesh.shape))
            if opts.fleet_topk > 0:
                # Hierarchical two-level pick (gie_tpu_torch/fleet): coarse
                # cell stage, then the dense cycle over the gathered
                # candidate block. A drop-in Scheduler facade; with
                # --fleet-topk 0 the dense path is as if the flag did not
                # exist.
                from gie_tpu_torch.fleet import FleetPicker

                self.scheduler = FleetPicker(
                    cfg, weights=weights, topk=opts.fleet_topk,
                    cell_cap=opts.fleet_cell_cap, predictor_fn=predictor_fn,
                    predictor_params=predictor_params, mesh=mesh)
                self.log.info("fleet picker armed", topk=opts.fleet_topk,
                              cell_cap=opts.fleet_cell_cap)
            else:
                self.scheduler = Scheduler(cfg, weights=weights,
                                           predictor_fn=predictor_fn,
                                           predictor_params=predictor_params,
                                           mesh=mesh)
            if self.trainer is not None:
                # A restored checkpoint carries its confidence state:
                # apply it now, or a converged column would sit at weight
                # 0 until the first train tick.
                self.scheduler.gate_latency_column(self.trainer.confidence())
        self.metrics_store = MetricsStore()
        self.mapping = BY_NAME[opts.model_server_type]
        # gie-obs (obs/, docs/OBSERVABILITY.md): the pick flight recorder
        # (always, when obs is on — written at wave cadence) and the
        # request tracer (only at a sampling rate > 0; rate 0 leaves the
        # admission path at one module-attr load + branch).
        self._obs_installed = False
        self._otlp = None
        self._scenario_name = ""
        if opts.obs:
            tenant_rates = {
                spec.partition("=")[0]: float(spec.partition("=")[2])
                for spec in opts.obs_tenant_sample
            }
            tracer = None
            if opts.obs_sample_rate > 0 or tenant_rates:
                # A tenant-rate map alone (fleet rate 0) still installs
                # the tracer: one noisy tenant at 1.0 while the fleet
                # stays dark is exactly the per-tenant override's job.
                tracer = Tracer(
                    opts.obs_sample_rate, seed=opts.obs_sample_seed,
                    slow_s=opts.obs_slow_ms / 1000.0,
                    tenant_rates=tenant_rates)
            if tracer is not None and opts.obs_otlp_endpoint:
                # OTLP span export (obs/otlp.py): exported traces also
                # POST to the collector as OTLP/HTTP JSON, batched on a
                # background thread — finish() only enqueues.
                self._otlp = OtlpSpanExporter(opts.obs_otlp_endpoint)
                tracer.on_export = self._otlp.export
                self.log.info("otlp span export armed",
                              endpoint=opts.obs_otlp_endpoint)
            obs.install(tracer=tracer,
                        recorder=FlightRecorder(opts.obs_ring))
            self._obs_installed = True
        # Unified resilience layer (resilience/, docs/RESILIENCE.md): one
        # breaker board (scrape outcomes write, pick path reads), one
        # degradation ladder (batching collector drives), the scrape
        # engine's own staleness clock as the blackout signal.
        self.resilience = None
        if opts.resilience:
            ejector = None
            if opts.outlier_ejection:
                # p99 serve-latency outlier ejection: fed by the serve-
                # outcome path, evaluated at wave cadence, tripping the
                # breaker serve plane.
                ejector = OutlierEjector(OutlierConfig(
                    window_s=opts.outlier_window_s,
                    quantile=opts.outlier_quantile,
                    ratio=opts.outlier_ratio))
            self.resilience = ResilienceState(
                ladder=DegradationLadder(LadderConfig(
                    cached_kv_weight=opts.ladder_cached_kv_weight,
                    serve_window_s=opts.ladder_serve_window_s,
                    serve_error_rate=opts.ladder_serve_error_rate,
                    serve_min_samples=opts.ladder_serve_min_samples,
                    wrr_queue_alpha=opts.ladder_wrr_alpha)),
                static_subset=opts.resilience_static_subset,
                ejector=ejector)
        # Multi-tenant fairness (docs/FAIRNESS.md): weighted-DRR flow
        # ordering + per-tenant budgets; uniform weights unless
        # --fairness-weights names tenants.
        self.fairness = FairnessState(FairnessConfig(
            weights=parse_weights(opts.fairness_weights),
            over_share_factor=opts.fairness_over_factor,
            window_s=opts.fairness_window_s,
            top_k=opts.fairness_top_k))
        # Multiplexed keep-alive scrape engine (metricsio/engine.py): a
        # fixed shard pool polls every endpoint at the scrape cadence;
        # attach/detach below are O(1). The attribute keeps the reference's
        # `scraper` name.
        self.scraper = ScrapeEngine(
            self.metrics_store,
            lora=self.lora_registry,
            interval_s=opts.scrape_interval_ms / 1000.0,
            workers=opts.scrape_workers or None,
            breaker_board=(self.resilience.board
                           if self.resilience is not None else None),
        )
        if self.resilience is not None:
            # The engine's last-success clocks are the blackout signal:
            # they cover ingestion-side outages (every endpoint
            # unreachable and backing off, a wedged shard) that row ages
            # alone miss.
            self.resilience.staleness_fn = self.scraper.staleness_seconds
        self.datastore = Datastore(
            on_slot_reclaimed=self._slot_reclaimed,
            drain_deadline_s=opts.drain_deadline_s)
        self._overflow_logged = 0
        # Multi-cluster federation (federation/): imported peer pools
        # become schedulable endpoints with a staleness-inflated cost
        # penalty; the digest exchange long-polls every configured peer.
        self.federation = None
        self.fed_exchange = None
        if opts.fed_peers or opts.fed_port > 0 or opts.fed_drain:
            peers = {}
            for spec in opts.fed_peers:
                name, _, url = str(spec).partition("=")
                peers[name] = url
            self.federation = FederationState(
                self.datastore, self.metrics_store,
                scheduler=self.scheduler,
                cluster=opts.fed_cluster,
                penalty=opts.fed_penalty,
                stale_inflate_s=opts.fed_stale_inflate_s,
                local_only_after_s=opts.fed_local_only_after_s,
                spill_queue_limit=float(self.scheduler.cfg.queue_limit),
            )
            self.federation.draining = opts.fed_drain
            self.fed_exchange = FederationExchange(
                self.federation,
                cluster=opts.fed_cluster,
                peers=peers,
                port=opts.fed_port,
                bind=opts.fed_bind,
                serve=opts.fed_port > 0,
                interval_s=opts.fed_interval_s,
                wait_s=opts.fed_wait_s,
                max_endpoints=opts.fed_max_endpoints,
                prefix_keys_fn=self.scheduler.prefix_hot_keys,
            )
        self.picker = BatchingTPUPicker(
            self.scheduler,
            self.datastore,
            self.metrics_store,
            max_wait_s=opts.batch_window_ms / 1000.0,
            lora_registry=self.lora_registry,
            trainer=self.trainer,
            queue_bound=opts.queue_bound,
            queue_max_age_s=opts.queue_max_age_s,
            pd_budget_floor_s=opts.pd_budget_floor_ms / 1000.0,
            # As the reference (runner.py:346): a new wave-shape lattice
            # captures its cycles on a background thread.
            background_warm=True,
            resilience=self.resilience,
            fairness=self.fairness,
            federation=self.federation,
        )
        self._train_stop = threading.Event()
        self._train_thread: Optional[threading.Thread] = None
        self._dump_thread: Optional[threading.Thread] = None
        own_metrics.register_pool_aggregates(self._pool_snapshot)
        # Objective registry (proposal 1199): named objectives -> bands,
        # populated from --objective NAME=CRITICALITY declarations.
        self.objectives = ObjectiveRegistry()
        for spec in opts.objectives:
            name, _, crit = spec.partition("=")
            self.objectives.apply(
                InferenceObjective(
                    name=name,
                    pool_ref=opts.pool_name,
                    criticality=int(crit),
                    namespace=opts.pool_namespace,
                )
            )
        self.picker.objective_registry = self.objectives
        self._build_ha(opts)
        self.streaming = StreamingServer(
            self.datastore, self.picker,
            on_served=self.picker.observe_served,
            on_response_complete=self.picker.observe_response_complete,
            on_stream_aborted=self.picker.observe_stream_aborted,
            fast_lane=opts.extproc_fast_lane,
        )
        self.grpc_server: Optional[ExtProcWorkerPool] = None
        self.health_server: Optional[grpc.Server] = None
        self.debugz_server = None
        # --kv-events-port: built by start(), after the ext-proc pool.
        self.kv_events: Optional[KVEventAggregator] = None
        self.kv_events_server: Optional[KVEventHTTPServer] = None
        self._cert_reloader = None
        self._stopped = threading.Event()

    def _build_ha(self, opts: Options) -> None:
        """The elector, the autoscale loop and HA state replication, as
        the reference's runner builds them (gie_tpu/runtime/runner.py
        :355-496)."""
        self.elector = None
        # A kube cluster client (main's --kube): anything exposing the
        # stdlib adapter's _json HTTP core.
        kube = self.cluster if hasattr(self.cluster, "_json") else None
        # With replication enabled, the elector's holder identity carries
        # this replica's advertised digest address — the lease doubles as
        # the followers' leader-discovery channel.
        repl_advertise = repl_identity = None
        if opts.replication_port > 0:
            repl_advertise = (
                opts.replication_advertise
                or f"{opts.replication_bind}:{opts.replication_port}")
            repl_identity = replication_identity(repl_advertise)
        if opts.leader_elect:
            # Kube deployments elect on a coordination.k8s.io Lease; the
            # file lease covers single-host/demo runs.
            if kube is not None:
                self.elector = KubeLeaseElector(
                    kube, opts.pool_namespace,
                    f"{opts.pool_name}-epp-leader",
                    identity=repl_identity)
            else:
                self.elector = LeaseFileElector(
                    opts.leader_lease_path, identity=repl_identity)
        # Closed-loop replica control behind --autoscale-mode: the
        # collector differentiates the pick path's own counters, the
        # recommender sizes the pool, and the actuator SSA-patches the
        # target Deployment (apply mode; leader-gated) or just exports
        # gie_autoscale_* (recommend mode).
        self.autoscaler = None
        self.capacity_model = None
        if opts.autoscale_mode != "off":
            # Persisted per-pool capacity estimate: seed the EWMA from the
            # last leader's checkpoint instead of default_per_replica.
            self.capacity_model = CapacityModel()
            if opts.autoscale_state_dir:
                if self.capacity_model.restore(opts.autoscale_state_dir):
                    self.log.info(
                        "capacity estimate restored",
                        dir=opts.autoscale_state_dir,
                        per_replica=self.capacity_model.per_replica())
            collector = SignalCollector(
                self.metrics_store,
                # Local endpoints only: the autoscaler sizes THIS
                # cluster's Deployment.
                self.datastore.local_endpoints,
                queue_limit=self.scheduler.cfg.queue_limit,
                kv_limit=self.scheduler.cfg.kv_limit,
                # Stale = several scrape periods missed, floored well above
                # jitter so a slow scrape tick never freezes the loop.
                staleness_s=max(10 * opts.scrape_interval_ms / 1000.0, 1.0),
                scrape_engine=self.scraper,
            )
            recommender = AutoscaleRecommender(RecommenderConfig(
                min_replicas=opts.autoscale_min,
                max_replicas=opts.autoscale_max,
                shed_high_per_s=opts.autoscale_shed_high,
                down_cooldown_s=opts.autoscale_down_cooldown_s,
            ), model=self.capacity_model)
            is_leader = (self.elector.is_leader
                         if self.elector is not None else None)
            actuator = ReplicaActuator(
                kube, opts.pool_namespace, opts.autoscale_target,
                dry_run=opts.autoscale_mode != "apply", is_leader=is_leader)
            # The TTFT probe reads the latency predictor's trainer: the
            # capacity model's SLO cross-check.
            self.autoscaler = AutoscaleController(
                collector, recommender, actuator,
                interval_s=opts.autoscale_interval_s,
                ttft_probe=(self._autoscale_ttft_probe
                            if self.trainer is not None
                            and opts.autoscale_ttft_slo_ms > 0 else None),
                # Followers sample but never recommend: their pick
                # counters are zero by construction (NOT_SERVING).
                is_leader=is_leader,
            )
        # HA state replication: the leader publishes its soft state,
        # non-leaders sync it into their LIVE scheduler and capacity
        # model, and winning an election later promotes warm with no
        # restore step.
        self.replication = None
        if opts.replication_port > 0:
            self.replication = ReplicationManager(
                scheduler=self.scheduler,
                trainer=self.trainer,
                capacity_model=self.capacity_model,
                elector=self.elector,
                port=opts.replication_port,
                bind=opts.replication_bind,
                advertise=repl_advertise,
                interval_s=opts.replication_interval_s,
                stale_after_s=opts.replication_stale_after_s,
            )
            if self.elector is not None:
                self.elector.on_role_change = self.replication.on_role_change

    def ready(self) -> bool:
        """Readiness per 004 README:111-115: datastore synced AND (leader
        when electing)."""
        if not self.datastore.pool_has_synced():
            return False
        if self.elector is not None and not self.elector.is_leader():
            return False
        return True

    def _pool_snapshot(self) -> dict:
        """Aggregates for the HPA gauges (metrics.register_pool_aggregates)
        — evaluated lazily at metrics-scrape time, never on the pick path.
        Saturation comes from MetricsStore.pool_aggregates; the assumed
        load is read back from the card."""
        endpoints = self.datastore.local_endpoints()
        slots = [ep.slot for ep in endpoints if 0 <= ep.slot < C.M_MAX]
        n = len(slots)
        if n == 0:
            return {"ready_endpoints": 0.0}
        cfg = self.scheduler.cfg
        agg = self.metrics_store.pool_aggregates(
            slots, queue_limit=cfg.queue_limit, kv_limit=cfg.kv_limit)
        load = self.scheduler.snapshot_assumed_load()
        # The assumed-load vector is sized to the scheduler's CURRENT M
        # bucket; a slot beyond it carries zero assumed load by definition.
        in_bucket = [s for s in slots if s < load.shape[0]]
        return {
            "ready_endpoints": float(n),
            "queue_depth_total": agg["queue_depth_total"],
            "kv_cache_util_mean": agg["kv_cache_util_mean"],
            "assumed_load_total": float(load[in_bucket].sum()),
            "saturated_fraction": agg["saturated_fraction"],
        }

    def _debugz_providers(self) -> dict:
        """The /debugz zpage catalog (obs/debugz.py): closures over the
        live subsystems. Every provider reads a snapshot or report
        surface that takes at most a leaf lock briefly — never the pick
        lock — and all JSON serialization happens in the HTTP layer."""

        def traces(q: dict):
            t = obs.TRACER
            if t is None:
                return {"disabled":
                        "tracing off (--obs-sample-rate 0 or --no-obs)"}
            return {"tracer": t.report(),
                    "traces": t.traces(q.get("kind", "recent"),
                                       n=int(q.get("n", "50")))}

        def trace(q: dict):
            t = obs.TRACER
            if t is None:
                return {"disabled": "tracing off"}
            found = t.get(q.get("id", ""))
            return found if found is not None else {
                "error": "no such trace (feed wrapped, or it was never "
                         "exported — unsampled and uneventful)"}

        def picks(q: dict):
            r = obs.RECORDER
            if r is None:
                return {"disabled": "--no-obs"}
            return r.snapshot(n=int(q.get("n", "100")))

        def pick(q: dict):
            # The per-request pick EXPLANATION: the flight-recorder
            # decision record joined with its exported trace (when one
            # exists) — "why did request X land on pod Y".
            r = obs.RECORDER
            if r is None:
                return {"disabled": "--no-obs"}
            seq = q.get("seq")
            rec = r.find(trace_id=q.get("trace", ""),
                         seq=int(seq) if seq is not None else None)
            if rec is None:
                return {"error": "no record for that trace/seq (ring "
                                 "wrapped, or the pick predates obs)"}
            out = {"record": rec}
            t = obs.TRACER
            if t is not None and rec.get("trace_id"):
                tr = t.get(rec["trace_id"])
                if tr is not None:
                    out["trace"] = tr
            return out

        def drain(q: dict):
            report = self.datastore.debug_report()
            return {
                "draining": report["draining"],
                "drain_deadline_s": report["drain_deadline_s"],
                "endpoints": [e for e in report["endpoints"]
                              if e["draining"]],
            }

        providers = {
            "traces": traces,
            "trace": trace,
            "picks": picks,
            "pick": pick,
            "queue": lambda q: self.picker.queue_report(),
            "tenants": lambda q: self.picker.tenants_report(),
            "datastore": lambda q: self.datastore.debug_report(),
            "scheduler": lambda q: self.scheduler.debug_report(),
            "drain": drain,
            "policy": lambda q: self._policy_report(),
            "buildinfo": lambda q: {
                "version": __version__,
                "fast_lane": self.opts.extproc_fast_lane,
                "resilience": self.opts.resilience,
                "obs": self._obs_installed,
                "obs_sample_rate": self.opts.obs_sample_rate,
                "fault_scenario": self.opts.fault_scenario or None,
            },
        }
        if self.resilience is not None:
            providers["breakers"] = (
                lambda q: self.resilience.board.report())
            providers["ladder"] = (
                lambda q: self.resilience.report())
            if self.resilience.ejector is not None:
                providers["outlier"] = (
                    lambda q: self.resilience.ejector.report())
        if self.fed_exchange is not None:
            # The federation page: peer links (era, staleness, breaker),
            # the per-cluster capacity matrix, and this cluster's drain
            # flag — the full spill-policy explanation.
            providers["federation"] = (
                lambda q: self.fed_exchange.report())
        if hasattr(self.scheduler, "fleet_report"):
            # /debugz/fleet: fleet geometry, compression ratio, the top-K
            # hit histogram (K-bounded) and the hottest cells
            # (row-bounded), a bounded page whatever the fleet's size.
            providers["fleet"] = (
                lambda q: self.scheduler.fleet_report(
                    max_cells=int(q.get("cells", "32"))))
        return providers

    def _policy_weights(self) -> dict:
        w = self.scheduler.weights
        return {f.name: float(getattr(w, f.name))
                for f in dataclasses.fields(type(w))}

    def _policy_report(self) -> dict:
        """/debugz/policy: which scorer this replica runs, the LIVE blend
        or exponent weights the cycle reads, and with --scorer learned the
        loaded artifact's identity, provenance and promotion verdict
        (mirrors gie_policy_info)."""
        report = {
            "scorer": getattr(self.scheduler.cfg, "scorer", "blend"),
            "weights": self._policy_weights(),
        }
        art = self.policy_artifact
        if art is not None:
            judgment = art.get("judgment") or {}
            report["artifact"] = {
                "path": self.opts.policy_artifact,
                "schema": art.get("schema"),
                "checksum": art.get("checksum"),
                "feature_schema": list(art.get("feature_schema", ())),
                "provenance": art.get("provenance", {}),
                "judgment_promote": judgment.get("promote"),
                "judgment_scenarios": [
                    {"name": row.get("name"), "passed": row.get("passed")}
                    for row in judgment.get("scenarios", [])],
            }
        return report

    def _autoscale_ttft_probe(self):
        """-> (predicted_ttft_s, ttft_slo_s) for the autoscale capacity
        model's SLO cross-check, or None while unusable: the median
        predicted TTFT of a pool-typical request (nominal prompt and
        decode, no LoRA) on every ready local endpoint under the live
        metrics and assumed load."""
        import numpy as np

        from gie_tpu_torch.models.latency import host_features

        if getattr(self.trainer, "last_loss", None) is None:
            return None  # untrained predictor: forecasts are noise
        slots = [ep.slot for ep in self.datastore.local_endpoints()
                 if 0 <= ep.slot < C.M_MAX]
        if not slots:
            return None
        rows, ages = self.metrics_store.pool_rows(slots)
        rows[:, C.Metric.METRICS_AGE_S] = np.clip(
            np.nan_to_num(ages, posinf=1e6), 0.0, 1e6)
        load = self.scheduler.snapshot_assumed_load()
        nominal_prompt = 2048.0                       # chars
        nominal_decode = 128.0 * C.CHARS_PER_TOKEN
        feats = np.stack([
            host_features(
                rows[i],
                float(load[s]) if s < load.shape[0] else 0.0,
                nominal_prompt, nominal_decode, False)
            for i, s in enumerate(slots)
        ])
        pred = self.trainer.predict_ttft(feats, np.asarray(slots, np.int32))
        return (float(np.median(pred)),
                self.opts.autoscale_ttft_slo_ms / 1000.0)

    # -- scrape lifecycle follows endpoint lifecycle -----------------------

    def _slot_reclaimed(self, slot: int) -> None:
        self.scheduler.evict_endpoint(slot)
        self.scraper.detach(slot)
        if self.resilience is not None and self.resilience.ejector is not None:
            # Latency history must not outlive the endpoint: a reused
            # slot's new pod starts with a clean quantile window (the
            # breaker's own drop rides the scrape detach above).
            self.resilience.ejector.drop(slot)

    def _sync_scrapers(self) -> None:
        for ep in self.datastore.local_endpoints():
            self.scraper.attach(
                ep.slot, f"http://{ep.hostport}/metrics", self.mapping
            )
        overflow = self.datastore.overflow_count()
        own_metrics.SLOT_OVERFLOW.set(overflow)
        if overflow > self._overflow_logged:
            # Capacity exhaustion must be operator-visible: some pods are
            # receiving no traffic until churn frees slots or M_MAX grows.
            self.log.error(
                "endpoint capacity exhausted: admissions refused",
                refused=overflow, m_max=C.M_MAX,
            )
            self._overflow_logged = overflow

    # ---------------------------------------------------------------------

    def setup(self) -> None:
        """Wire reconcilers (reference SetupWithManager, runserver.go:78-93)."""
        gknn = GKNN(GROUP, "InferencePool", self.opts.pool_namespace,
                    self.opts.pool_name)
        pool_rec = InferencePoolReconciler(self.cluster, self.datastore, gknn)
        pod_rec = PodReconciler(self.cluster, self.datastore)
        wire(self.cluster, pool_rec, pod_rec)

        # Scrapers follow datastore content after every event.
        original_pod = pod_rec.reconcile
        original_pool = pool_rec.reconcile

        def pod_reconcile(ns, name, *args, **kw):
            res = original_pod(ns, name, *args, **kw)
            self._sync_scrapers()
            return res

        def pool_reconcile(ns, name, *args, **kw):
            res = original_pool(ns, name, *args, **kw)
            self._sync_scrapers()
            return res

        pod_rec.reconcile = pod_reconcile
        pool_rec.reconcile = pool_reconcile

        # Initial sync: reconcile pre-existing state (the cache-sync pass of
        # controller-runtime; watch events only cover changes from now on).
        pool_reconcile(self.opts.pool_namespace, self.opts.pool_name)
        for pod in self.cluster.list_pods(self.opts.pool_namespace):
            pod_reconcile(pod.namespace, pod.name)

    def start(self) -> int:
        """Start health, metrics, and the ext-proc listener; returns the
        bound ext-proc port."""
        if self.elector is not None:
            self.elector.start()
        if self.replication is not None:
            self.replication.start()
            self.log.info(
                "replication manager started",
                advertise=self.replication.advertise,
                interval_s=self.opts.replication_interval_s,
            )
        if self.fed_exchange is not None:
            self.fed_exchange.start()
            self.log.info(
                "federation exchange started",
                cluster=self.opts.fed_cluster,
                peers=sorted(self.fed_exchange.links),
                port=(self.fed_exchange.server.port
                      if self.fed_exchange.server is not None else None),
                draining=self.federation.draining,
            )
        if self.opts.fault_specs:
            # gie-chaos (resilience/faults.py): arm the seeded injector.
            # Operator-driven chaos experiments only — production runs
            # leave this off and pay one flag check per woven site.
            faults.install(faults.FaultInjector(
                self.opts.fault_seed,
                faults.parse_spec(self.opts.fault_specs)))
            self.log.info("fault injection armed",
                          seed=self.opts.fault_seed,
                          specs=self.opts.fault_specs)
        elif self.opts.fault_scenario:
            # Recorded chaos scenario (resilience/scenarios.py): the file
            # carries its own seed + rules — the replayable form of
            # --fault/--fault-seed, bit-for-bit across runs.
            scn = scenarios.load(self.opts.fault_scenario)
            scn.arm()
            self._scenario_name = scn.name
            self.log.info("chaos scenario armed", name=scn.name,
                          seed=scn.seed, path=scn.path)
        resilience_fn = (self.resilience.healthy
                         if self.resilience is not None else None)
        replication_fn = (self.replication.healthy
                          if self.replication is not None else None)
        # Dedicated health first — NOT_SERVING beats connection-refused
        # during startup (reference main.go:104-109).
        self.health_server, _ = start_dedicated_health_server(
            self.ready, self.opts.grpc_health_port, replication_fn,
            resilience_fn)
        # The wire lane rides on the fast lane's header scan:
        # --no-extproc-fast-lane quietly implies the legacy gRPC lane.
        wire_lane = self.opts.extproc_wire and self.opts.extproc_fast_lane
        own_metrics.set_build_info(
            fast_lane=self.opts.extproc_fast_lane,
            resilience=self.opts.resilience,
            obs=self._obs_installed,
            wire=wire_lane, workers=self.opts.extproc_workers)
        own_metrics.set_policy_info(
            scorer=getattr(self.scheduler.cfg, "scorer", "blend"),
            weights=self._policy_weights(), artifact=self.policy_artifact)
        try:
            self.debugz_server = own_metrics.start_metrics_server(
                self.opts.metrics_port,
                providers=self._debugz_providers(),
                debugz_bind=self.opts.debugz_bind,
                debugz_token=self.opts.debugz_token)
        except OSError as e:
            self.log.error("metrics server failed to start", err=e)

        # Colocated health on the ext-proc port (runserver.go:117-123) —
        # registered per acceptor so probes hit the same socket spread
        # real traffic does.
        def _add_health(srv):
            HealthService(self.ready, replication_fn,
                          resilience_fn).add_to_server(srv)

        pool = ExtProcWorkerPool(
            self.streaming, self.opts.extproc_workers, wire=wire_lane,
            health_factory=_add_health)
        addr = f"0.0.0.0:{self.opts.grpc_port}"
        creds = None
        if self.opts.secure_serving:
            creds, self._cert_reloader = server_credentials(self.opts.cert_path)
        port = pool.bind(addr, creds)
        pool.start()
        self.grpc_server = pool
        if self.opts.kv_events_port > 0:
            self._start_kv_events()
        if self.trainer is not None:
            self._train_thread = threading.Thread(
                target=self._train_loop, name="predictor-train", daemon=True)
            self._train_thread.start()
        if self.opts.obs_dump_interval_s > 0 and self._obs_installed:
            # Periodic flight-recorder harvesting (--obs-dump-interval-s):
            # the rotator bounds the file count itself; the thread holds
            # no lock across the dump.
            rotator = DumpRotator(self.opts.obs_dump_dir,
                                  keep=self.opts.obs_dump_keep)

            def _dump_loop():
                while not self._stopped.wait(self.opts.obs_dump_interval_s):
                    path = rotator.rotate_once()
                    if path:
                        self.log.v(3).info("flight recorder rotated",
                                           path=path)

            self._dump_thread = threading.Thread(
                target=_dump_loop, daemon=True)
            self._dump_thread.start()
            self.log.info("obs dump rotation started",
                          dir=self.opts.obs_dump_dir,
                          interval_s=self.opts.obs_dump_interval_s,
                          keep=self.opts.obs_dump_keep)
        if self.autoscaler is not None:
            self.autoscaler.start()
            self.log.info(
                "autoscale loop started",
                mode=self.opts.autoscale_mode,
                target=self.opts.autoscale_target,
                bounds=(self.opts.autoscale_min, self.opts.autoscale_max),
            )
        self.log.info(
            "ext-proc server started",
            port=port,
            secure=self.opts.secure_serving,
            workers=self.opts.extproc_workers,
            wire=wire_lane,
            health_port=self.opts.grpc_health_port,
            metrics_port=self.opts.metrics_port,
        )
        return port

    def _start_kv_events(self) -> None:
        """The KV-cache event listener (--kv-events-port): model servers
        push stored/removed chunk hashes, resolved to scheduler slots
        through the datastore's hostport index."""
        def _resolve(hostport: str):
            ep = self.datastore.endpoint_by_hostport(hostport)
            return None if ep is None else ep.slot

        self.kv_events = KVEventAggregator(self.scheduler, _resolve)
        self.kv_events_server = KVEventHTTPServer(
            self.kv_events, self.opts.kv_events_port,
            bind=self.opts.kv_events_bind, token=self.opts.kv_events_token)
        self.log.info("kv-events ingest listening",
                      port=self.kv_events_server.port,
                      bind=self.opts.kv_events_bind,
                      auth=self.opts.kv_events_token is not None)

    def _train_loop(self) -> None:
        """Periodic online training, the params handoff, the column's
        phase-in and the checkpoint."""
        while not self._train_stop.wait(self.opts.predictor_train_interval_s):
            try:
                loss = self.trainer.train(steps=10)
                if loss is None:
                    continue
                if self.scheduler.predictor_fn is not None:
                    # Only a cycle that binds the column takes params.
                    self.scheduler.set_predictor_params(self.trainer.params)
                    live_w = self.scheduler.gate_latency_column(
                        self.trainer.confidence())
                else:
                    live_w = 0.0
                self.log.v(3).info("predictor trained", loss=loss,
                                   latency_weight=live_w)
                if self.opts.predictor_checkpoint_dir:
                    self.trainer.save(self.opts.predictor_checkpoint_dir)
            except Exception as e:  # training must never take the EPP down
                self.log.error("predictor training failed", err=e)

    def wait(self) -> None:
        if self.grpc_server is not None:
            self.grpc_server.wait_for_termination()

    def stop(self, grace: float = 5.0) -> None:
        """Graceful stop (reference grpc.go:44-57)."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.replication is not None:
            self.replication.stop()
        if self.fed_exchange is not None:
            self.fed_exchange.stop()
        # Persist the capacity EWMA on LEADER shutdown: the next
        # single-replica start seeds from it instead of the default.
        # Followers skip the write — their copy lags the leader's, and
        # the last writer would win the directory.
        if (self.capacity_model is not None
                and self.opts.autoscale_state_dir
                and (self.elector is None or self.elector.is_leader())):
            try:
                self.capacity_model.save(self.opts.autoscale_state_dir)
            except Exception as e:  # shutdown must finish regardless
                self.log.error("capacity checkpoint failed", err=e)
        self._train_stop.set()
        if self._train_thread is not None:
            self._train_thread.join(timeout=5)
        if self._dump_thread is not None:
            # _stopped is already set; the wait()-gated loop exits on its
            # next wake.
            self._dump_thread.join(timeout=5)
        if self.grpc_server is not None:
            self.grpc_server.stop(grace).wait()
        if self.health_server is not None:
            self.health_server.stop(0)
        if self.kv_events_server is not None:
            self.kv_events.flush()
            self.kv_events_server.close()
        self.picker.close()
        self.scraper.close()
        if self.debugz_server is not None:
            try:
                self.debugz_server.close()
            except Exception:
                pass  # listener teardown must not block shutdown
        if self._obs_installed:
            if self.opts.fault_scenario:
                # Chaos-scenario artifact: the ring buffer IS the
                # explanation of what the scenario did to the pick path —
                # dump it so a failed run reads back its own decisions.
                path = obs.dump_artifact(
                    self.opts.obs_dump_dir,
                    name=self._scenario_name or "scenario")
                if path:
                    self.log.info("flight recorder dumped", path=path)
            obs.uninstall()
        if self._otlp is not None:
            self._otlp.close()
        if self.opts.fault_specs:
            faults.uninstall()
        if self.elector is not None:
            self.elector.stop()
        if self._cert_reloader is not None:
            self._cert_reloader.close()
        self.log.info("shutdown complete")
