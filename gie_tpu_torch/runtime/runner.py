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
them, both on by default. Subsystems that later slices of the port bring
are refused at construction with the port's not-ported error, never
skipped silently (`refuse_out_of_slice`): the kube, leader-election,
replication, autoscale, federation, KV-events, fleet, multi-device,
learned-scorer and latency-predictor flags.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import grpc

from gie_tpu_torch import __version__, obs
from gie_tpu_torch.api.objectives import InferenceObjective, ObjectiveRegistry
from gie_tpu_torch.api.types import GROUP
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
from gie_tpu_torch.runtime.health import HealthService, start_dedicated_health_server
from gie_tpu_torch.runtime.logging import get_logger
from gie_tpu_torch.runtime.options import Options
from gie_tpu_torch.runtime.tls import server_credentials
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.batching import BatchingTPUPicker
from gie_tpu_torch.sched.config import load_scheduler_config_file, tuned_profile
from gie_tpu_torch.sched.kvevents import KVEventAggregator, KVEventHTTPServer
from gie_tpu_torch.sched.profile import Scheduler, _not_ported, feature_schema
from gie_tpu_torch.utils.kubemeta import GKNN
from gie_tpu_torch.utils.lora import LoraRegistry


def refuse_out_of_slice(opts: Options) -> None:
    """Raise the port's not-ported error for the first option whose
    subsystem a later slice of the port brings (ROADMAP.md, Queue 1)."""
    defaults = Options()
    federation = [f.name for f in dataclasses.fields(Options)
                  if f.name.startswith("fed_")
                  and getattr(opts, f.name) != getattr(defaults, f.name)]
    refusals = (
        (opts.leader_elect, "--leader-elect", "kube"),
        (opts.replication_port > 0, "--replication-port", "replication"),
        (opts.autoscale_mode != "off", "--autoscale-mode", "autoscale"),
        (bool(federation), "--fed-* (federation: "
                           + ", ".join(federation) + ")", "federation"),
        (opts.fleet_topk > 0, "--fleet-topk", "fleet"),
        (opts.mesh_devices > 1, "--mesh-devices", "mesh"),
        (opts.enable_predictor, "--enable-predictor", "predictor_fn"),
    )
    for refused, what, key in refusals:
        if refused:
            raise _not_ported(what, key)


class ExtProcServerRunner:
    def __init__(
        self,
        opts: Options,
        cluster: ClusterClient,
        scheduler: Optional[Scheduler] = None,
    ):
        refuse_out_of_slice(opts)
        self.opts = opts
        self.log = get_logger("runner")
        self.cluster = cluster
        self.lora_registry = LoraRegistry()
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
                artifact_mod.validate_feature_schema(art, feature_schema(cfg))
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
            self.scheduler = Scheduler(cfg, weights=weights)
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
        self.picker = BatchingTPUPicker(
            self.scheduler,
            self.datastore,
            self.metrics_store,
            max_wait_s=opts.batch_window_ms / 1000.0,
            lora_registry=self.lora_registry,
            queue_bound=opts.queue_bound,
            queue_max_age_s=opts.queue_max_age_s,
            pd_budget_floor_s=opts.pd_budget_floor_ms / 1000.0,
            # As the reference (runner.py:346): a new wave-shape lattice
            # captures its cycles on a background thread.
            background_warm=True,
            resilience=self.resilience,
            fairness=self.fairness,
        )
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

    def ready(self) -> bool:
        """Readiness per 004 README:111-115: datastore synced."""
        return self.datastore.pool_has_synced()

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
        # Dedicated health first — NOT_SERVING beats connection-refused
        # during startup (reference main.go:104-109).
        self.health_server, _ = start_dedicated_health_server(
            self.ready, self.opts.grpc_health_port, None, resilience_fn)
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
            HealthService(self.ready, None, resilience_fn).add_to_server(srv)

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

    def wait(self) -> None:
        if self.grpc_server is not None:
            self.grpc_server.wait_for_termination()

    def stop(self, grace: float = 5.0) -> None:
        """Graceful stop (reference grpc.go:44-57)."""
        if self._stopped.is_set():
            return
        self._stopped.set()
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
        if self._cert_reloader is not None:
            self._cert_reloader.close()
        self.log.info("shutdown complete")
