"""ExtProcServerRunner: wiring + lifecycle (port of gie_tpu/runtime/runner.py).

Mirror of reference pkg/lwepp/server/runserver.go:45-157 + cmd/lwepp/main.go:
build the full stack (datastore + reconcilers + scraper + scheduler +
batching picker + ext-proc gRPC + dual health + metrics), start the
dedicated health listener before cache sync, serve, and stop gracefully on
context/signal (internal/runnable/grpc.go:44-57 GracefulStop).

With no injected scheduler the runner builds `Scheduler(*tuned_profile())`
(or `--scheduler-config`) with no device argument, so it runs on the CUDA
card and raises where there is none. Subsystems that later slices of the
port bring are refused at construction with the port's not-ported error,
never skipped silently (`refuse_out_of_slice`): the resilience layer and
the observability layer, both on by default in the reference (run with
`--no-resilience --no-obs`), and the kube, leader-election, replication,
autoscale, federation, KV-events, fleet, multi-device, learned-scorer,
latency-predictor and chaos flags.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import grpc

from gie_tpu_torch import __version__
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
from gie_tpu_torch.metricsio import MetricsStore
from gie_tpu_torch.metricsio.engine import ScrapeEngine
from gie_tpu_torch.metricsio.mappings import BY_NAME
from gie_tpu_torch.runtime import metrics as own_metrics
from gie_tpu_torch.runtime.health import HealthService, start_dedicated_health_server
from gie_tpu_torch.runtime.logging import get_logger
from gie_tpu_torch.runtime.options import Options
from gie_tpu_torch.runtime.tls import server_credentials
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.batching import BatchingTPUPicker
from gie_tpu_torch.sched.config import load_scheduler_config_file, tuned_profile
from gie_tpu_torch.sched.profile import Scheduler, _not_ported
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
        (opts.resilience, "the resilience layer (on by default; run with "
                          "--no-resilience)", "resilience"),
        (opts.obs, "the observability layer (on by default; run with "
                   "--no-obs)", "obs"),
        (opts.leader_elect, "--leader-elect", "kube"),
        (opts.replication_port > 0, "--replication-port", "replication"),
        (opts.autoscale_mode != "off", "--autoscale-mode", "autoscale"),
        (bool(federation), "--fed-* (federation: "
                           + ", ".join(federation) + ")", "federation"),
        (opts.kv_events_port > 0, "--kv-events-port", "kv_events"),
        (opts.fleet_topk > 0, "--fleet-topk", "fleet"),
        (opts.mesh_devices > 1, "--mesh-devices", "mesh"),
        (opts.scorer == "learned", "--scorer learned", "scorer"),
        (opts.enable_predictor, "--enable-predictor", "predictor_fn"),
        (bool(opts.fault_specs), "--fault", "resilience"),
        (bool(opts.fault_scenario), "--fault-scenario", "resilience"),
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
        if scheduler is not None:
            self.scheduler = scheduler
        else:
            # Production default: the swept tuned profile; an explicit
            # --scheduler-config replaces it wholesale. No device argument:
            # the scheduler runs on the card, and raises without one.
            cfg, weights = tuned_profile()
            if opts.scheduler_config:
                cfg, weights = load_scheduler_config_file(opts.scheduler_config)
            self.scheduler = Scheduler(cfg, weights=weights)
        self.metrics_store = MetricsStore()
        self.mapping = BY_NAME[opts.model_server_type]
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
        )
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
            # The reference passes background_warm=True (runner.py:346) so
            # a new wave-shape lattice background-compiles its jit buckets.
            # The port has no jit to warm and its picker refuses True until
            # the warm-lattice slice; False changes no pick.
            background_warm=False,
            fairness=self.fairness,
        )
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
        live subsystems, the reference's pages whose providers exist
        without the flight recorder. Every provider reads a snapshot or
        report surface that takes at most a leaf lock briefly."""

        def drain(q: dict):
            report = self.datastore.debug_report()
            return {
                "draining": report["draining"],
                "drain_deadline_s": report["drain_deadline_s"],
                "endpoints": [e for e in report["endpoints"]
                              if e["draining"]],
            }

        return {
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
                "obs": False,
                "obs_sample_rate": self.opts.obs_sample_rate,
                "fault_scenario": self.opts.fault_scenario or None,
            },
        }

    def _policy_weights(self) -> dict:
        w = self.scheduler.weights
        return {f.name: float(getattr(w, f.name))
                for f in dataclasses.fields(type(w))}

    def _policy_report(self) -> dict:
        """/debugz/policy: which scorer this replica runs and the LIVE
        blend weights the cycle reads (mirrors gie_policy_info)."""
        return {
            "scorer": getattr(self.scheduler.cfg, "scorer", "blend"),
            "weights": self._policy_weights(),
        }

    # -- scrape lifecycle follows endpoint lifecycle -----------------------

    def _slot_reclaimed(self, slot: int) -> None:
        self.scheduler.evict_endpoint(slot)
        self.scraper.detach(slot)

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
        # Dedicated health first — NOT_SERVING beats connection-refused
        # during startup (reference main.go:104-109).
        self.health_server, _ = start_dedicated_health_server(
            self.ready, self.opts.grpc_health_port)
        # The wire lane rides on the fast lane's header scan:
        # --no-extproc-fast-lane quietly implies the legacy gRPC lane.
        wire_lane = self.opts.extproc_wire and self.opts.extproc_fast_lane
        own_metrics.set_build_info(
            fast_lane=self.opts.extproc_fast_lane,
            resilience=self.opts.resilience,
            obs=False,
            wire=wire_lane, workers=self.opts.extproc_workers)
        own_metrics.set_policy_info(
            scorer=getattr(self.scheduler.cfg, "scorer", "blend"),
            weights=self._policy_weights())
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
            HealthService(self.ready).add_to_server(srv)

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

    def wait(self) -> None:
        if self.grpc_server is not None:
            self.grpc_server.wait_for_termination()

    def stop(self, grace: float = 5.0) -> None:
        """Graceful stop (reference grpc.go:44-57)."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        if self.grpc_server is not None:
            self.grpc_server.stop(grace).wait()
        if self.health_server is not None:
            self.health_server.stop(0)
        self.picker.close()
        self.scraper.close()
        if self.debugz_server is not None:
            try:
                self.debugz_server.close()
            except Exception:
                pass  # listener teardown must not block shutdown
        if self._cert_reloader is not None:
            self._cert_reloader.close()
        self.log.info("shutdown complete")
