"""CLI options with the AddFlags/Complete/Validate lifecycle (copy of
gie_tpu/runtime/options.py: the same flags, defaults and validation, so an
argv parses the same in both packages).

Mirror of reference pkg/lwepp/server/options.go:25-94 (defaults: ext-proc
gRPC 9002, dedicated health 9003, metrics 9090, pool group
inference.networking.k8s.io, TLS on) plus the scheduler's knobs. Flags
whose subsystem a later slice of the port brings parse here and are
refused by the runner (runtime/runner.py)."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from gie_tpu_torch.api.types import GROUP


@dataclasses.dataclass
class Options:
    grpc_port: int = 9002
    grpc_health_port: int = 9003
    metrics_port: int = 9090
    pool_name: str = ""
    pool_namespace: str = "default"
    pool_group: str = GROUP
    secure_serving: bool = True
    cert_path: Optional[str] = None     # mounted cert dir (hot-reload)
    verbosity: int = 2
    # TPU scheduler knobs
    batch_window_ms: float = 2.0
    scrape_interval_ms: float = 50.0
    # Scrape-engine worker shards (metricsio/engine.py): a FIXED pool of
    # threads multiplexing every endpoint over keep-alive connections.
    # 0 = auto (min(8, cpu)). This replaces the seed's thread-per-endpoint
    # polling; the shard count bounds scrape-path threads regardless of
    # pool size.
    scrape_workers: int = 0
    model_server_type: str = "vllm"
    # Learned latency predictor (BASELINE configs[3])
    enable_predictor: bool = False
    predictor_checkpoint_dir: Optional[str] = None
    predictor_train_interval_s: float = 5.0
    # Multi-replica leader election (readiness gates on leadership).
    leader_elect: bool = False
    leader_lease_path: str = "/tmp/gie-tpu-epp.lease"
    # InferenceObjective declarations: "name=criticality" pairs (the CLI
    # stand-in for the CRD until a kube watch adapter supplies them).
    objectives: list = dataclasses.field(default_factory=list)
    # Declarative scheduler profile (YAML: picker/thresholds/plugins/weights).
    scheduler_config: Optional[str] = None
    # Multi-chip serving: dp-shard the scheduling cycle over the first N
    # local devices (0 = single-device). Results are bit-identical to
    # single-device (tests/test_distributed_equivalence.py).
    mesh_devices: int = 0
    # Hierarchical two-level pick cycle (gie_tpu/fleet, docs/FLEET.md):
    # a coarse stage over per-cell rows selects the top K candidate
    # cells per wave, and the dense scorer chain runs only over their
    # gathered endpoints. 0 = off, the dense path stays byte-identical;
    # picks are bitwise-identical to dense whenever K covers every cell
    # (tests/test_fleet.py).
    fleet_topk: int = 0
    # Endpoint slots per fleet cell (multiple of 32; cells are contiguous
    # slot ranges — a federation peer's imported block or a pool shard).
    fleet_cell_cap: int = 64
    # KV-cache event ingestion (reference roadmap item 1, remote-cache
    # interface): HTTP port accepting JSON-lines BlockStored/BlockRemoved/
    # AllBlocksCleared pushes from model servers or cache sidecars
    # (0 = disabled).
    kv_events_port: int = 0
    # Bind address for the KV-events listener. Loopback by default: this is
    # a control-plane input (forged events steer routing); binding the pod
    # network is an explicit decision, ideally with --kv-events-token.
    kv_events_bind: str = "127.0.0.1"
    # Shared bearer token required on KV-event POSTs (None = no auth).
    kv_events_token: Optional[str] = None
    # Admission fast lane (extproc/server.py, docs/EXTPROC.md): zero-parse
    # native JSON field scan, needed-keys header copy, and pooled
    # ProcessingResponse templates on the per-request pick path. Outputs
    # are byte-identical to the legacy path (pinned by tests); the flag
    # exists for safe rollout and for custom pickers that read request
    # headers outside server.NEEDED_REQUEST_HEADERS.
    extproc_fast_lane: bool = True
    # Wire lane (extproc/wire.py, docs/EXTPROC.md): identity gRPC
    # deserializers plus a native serialized-frame walker — classified
    # admission frames never materialize as ProcessingRequest objects.
    # Requires the fast lane (the walker feeds the same native header
    # scan); any unclassified frame falls back to the legacy
    # choreography with byte-identical responses (pinned by tests).
    extproc_wire: bool = True
    # SO_REUSEPORT acceptor count (extproc/workers.py): N in-process
    # gRPC servers sharing one port, one datastore snapshot, and one
    # metrics registry. 1 keeps the single-server layout.
    extproc_workers: int = 1
    # Flow-control queue bounds (reference flow-controller overload policy,
    # proposal 0683): max picks waiting (0 = unbounded) and max seconds a
    # non-critical pick may queue before shedding 429 (0 = unbounded).
    queue_bound: int = 0
    queue_max_age_s: float = 0.0
    # Autoscaling recommender (gie_tpu/autoscale, docs/AUTOSCALE.md):
    # "off" disables the loop; "recommend" runs signals->recommendation
    # and exports gie_autoscale_* metrics without writing; "apply"
    # additionally SSA-patches spec.replicas on --autoscale-target
    # (leader-gated when --leader-elect).
    autoscale_mode: str = "off"
    autoscale_target: Optional[str] = None  # Deployment name to scale
    autoscale_min: int = 1
    autoscale_max: int = 16
    autoscale_interval_s: float = 2.0
    autoscale_shed_high: float = 0.5       # sustained 429/s -> scale up
    autoscale_down_cooldown_s: float = 60.0
    # TTFT SLO for the capacity model's predictor cross-check (0 = off):
    # with --enable-predictor, the controller probes the predicted TTFT of
    # a pool-typical request and derates capacity when it exceeds this
    # bound, so scale-up starts while answers are merely late.
    autoscale_ttft_slo_ms: float = 0.0
    # Persisted per-pool capacity estimate (ROADMAP): directory where the
    # leader checkpoints the capacity EWMA on shutdown, and from which a
    # restarting EPP seeds the model instead of default_per_replica.
    autoscale_state_dir: Optional[str] = None
    # HA state replication (gie_tpu/replication, docs/REPLICATION.md):
    # warm-standby followers sync the leader's soft state (prefix table,
    # assumed load + OT duals, predictor params, capacity EWMA) so a
    # failover promotes warm instead of prefix-/predictor-cold. Port 0 =
    # disabled. The digest listener is control-plane state (a forged
    # digest steers routing): loopback bind by default; set --replication-
    # bind/-advertise to the pod network explicitly for real deployments.
    replication_port: int = 0
    replication_bind: str = "127.0.0.1"
    replication_advertise: str = ""   # host:port peers dial; default bind:port
    replication_interval_s: float = 1.0
    # Follower staleness bound for the "replication" health sub-service:
    # a standby that has not confirmed the leader's state within this
    # window reports NOT_SERVING (it would promote cold-ish).
    replication_stale_after_s: float = 10.0
    # Unified resilience layer (gie_tpu/resilience, docs/RESILIENCE.md):
    # per-endpoint circuit breakers fed by scrape outcomes, the pick-path
    # degradation ladder (full TPU pick -> cached-snapshot -> weighted
    # round-robin -> static subset), and the "resilience" health
    # sub-service. On by default; --no-resilience restores seed behavior
    # (device/dispatch failures fail the affected wave's requests).
    resilience: bool = True
    # STATIC rung pool size: the fixed endpoint subset the bottom ladder
    # rung rotates over.
    resilience_static_subset: int = 4
    # Degradation-ladder calibration knobs (docs/RESILIENCE.md "ladder
    # calibration"): the CACHED rung's queue + w*kv weight (default from
    # the storm sweep) and the pool-wide serve-outcome floor thresholds.
    ladder_cached_kv_weight: float = 8.0
    ladder_serve_window_s: float = 10.0
    ladder_serve_error_rate: float = 0.5
    ladder_serve_min_samples: int = 20
    # ROUND_ROBIN-rung smooth-WRR queue-shape exponent (weight =
    # (1+queue)^-alpha; docs/RESILIENCE.md "ladder calibration").
    ladder_wrr_alpha: float = 1.0
    # Multi-tenant fairness (gie_tpu/fairness, docs/FAIRNESS.md):
    # "tenant=weight" pairs for the weighted-DRR flow queue (repeatable,
    # comma-joinable; unlisted tenants weigh 1.0 — uniform by default).
    fairness_weights: list = dataclasses.field(default_factory=list)
    # Over-fair-share factor: a tenant offering more than factor x its
    # weighted fair share of windowed cost becomes eligible for the
    # preemptive SHEDDABLE shed under saturation.
    fairness_over_factor: float = 2.0
    # Sliding window for every per-tenant budget ledger.
    fairness_window_s: float = 10.0
    # gie_tenant_* label cardinality: top-K tenants by traffic keep
    # their own label value, the long tail exports as "other".
    fairness_top_k: int = 8
    # p99 serve-latency outlier ejection (resilience/outlier.py): a
    # consistently-slow endpoint (windowed per-endpoint quantile above
    # --outlier-ratio x the pool median) is quarantined via the breaker
    # serve plane. Off by default until real-hardware latency
    # distributions confirm the defaults (ROADMAP item 10).
    outlier_ejection: bool = False
    outlier_window_s: float = 30.0
    outlier_ratio: float = 3.0
    outlier_quantile: float = 0.99
    # /debugz peer gate (docs/OBSERVABILITY.md "bind hardening"): the
    # zpages answer loopback peers only unless this names a non-loopback
    # address (e.g. the pod IP, or 0.0.0.0). /metrics is unaffected —
    # Prometheus keeps scraping from off-pod either way.
    debugz_bind: str = "127.0.0.1"
    # Bearer token required from NON-loopback peers on /debugz paths
    # (constant-time compare, 401 without it). Stronger than — and, when
    # set, overriding — the --debugz-bind opt-out for remote peers;
    # loopback access and /metrics are unaffected.
    debugz_token: Optional[str] = None
    # gie-chaos fault injection (resilience/faults.py): repeatable
    # "point=kind:prob[:arg],..." specs plus the schedule seed. Empty =
    # injection disabled (zero hot-path cost beyond one flag check).
    fault_specs: list = dataclasses.field(default_factory=list)
    fault_seed: int = 0
    # Recorded chaos scenario (resilience/scenarios.py): a JSON file (or
    # a shipped-library name like "mixed-soak") whose seed + rules arm
    # the injector at startup — the replayable form of --fault/--fault-
    # seed. Mutually exclusive with --fault (a scenario IS a recorded
    # spec; mixing the two would break its bit-for-bit replay claim).
    fault_scenario: str = ""
    # Graceful drain (docs/RESILIENCE.md): how long a DRAINING endpoint
    # (terminating / NotReady-while-serving pod) may finish its in-flight
    # streams before its scheduler slot is reclaimed anyway.
    drain_deadline_s: float = 30.0
    # Budget-aware pd split (docs/RESILIENCE.md): disaggregated picks
    # whose remaining deadline budget is under this floor collapse to
    # the decode worker only (no cross-worker prefill hop). 0 disables.
    pd_budget_floor_ms: float = 250.0
    # gie-obs (gie_tpu/obs, docs/OBSERVABILITY.md): the pick flight
    # recorder + /debugz introspection plane. On by default — records
    # are written at wave-completion cadence, off the admission hot
    # path; --no-obs removes even that.
    obs: bool = True
    # Head-sampling rate for end-to-end request traces, deterministic
    # per trace ID. 0 (default) installs no tracer at all — the
    # admission path pays one module-attribute load and a falsy branch
    # (bench_extproc's regression guard pins it). At any rate > 0,
    # errors/sheds/deadline breaches/latency tail outliers export
    # regardless of the head decision.
    obs_sample_rate: float = 0.0
    # Deterministic sampling seed: same seed + same trace ID = same
    # keep/drop on every replica.
    obs_sample_seed: int = 0
    # Flight-recorder ring capacity (records, fixed at startup).
    obs_ring: int = 512
    # Latency tail-outlier threshold: a request slower than this exports
    # its trace even when head sampling dropped it.
    obs_slow_ms: float = 250.0
    # Per-tenant trace-rate overrides ("tenant=rate", repeatable): one
    # noisy tenant traced at 1.0 while the fleet stays at
    # --obs-sample-rate. A tenant map alone (fleet rate 0) still
    # installs the tracer — only the mapped tenants head-sample.
    obs_tenant_sample: list = dataclasses.field(default_factory=list)
    # Where --fault-scenario runs (and failed chaos tests) dump the
    # flight-recorder JSON artifact.
    obs_dump_dir: str = "/tmp/gie-obs"
    # Periodic flight-recorder harvesting (gie-learn's training feed,
    # docs/LEARNED.md): every interval the recorder ring is dumped into
    # --obs-dump-dir as a rotation-numbered JSON file, keeping at most
    # --obs-dump-keep files (oldest deleted first). 0 = no rotation
    # thread at all (the default; chaos dumps are unaffected).
    obs_dump_interval_s: float = 0.0
    obs_dump_keep: int = 8
    # gie-learn (gie_tpu/learn, docs/LEARNED.md): which scorer the cycle
    # blends. "blend" is the heuristic weighted sum (the production
    # default, byte-identical to the pre-learn path); "learned" is the
    # offline-trained multiplicative policy and requires
    # --policy-artifact.
    scorer: str = "blend"
    # Trained policy artifact (gie-learn-policy/1 JSON): checksum-
    # verified and schema-validated against the live profile's feature
    # columns at startup — a stale artifact fails fast, never scores.
    policy_artifact: str = ""
    # OTLP span export (gie_tpu/obs/otlp.py, docs/OBSERVABILITY.md):
    # exported traces additionally POST as OTLP/HTTP JSON spans to
    # <endpoint>/v1/traces, batched on a background thread — never the
    # hot path. Empty = disabled. Needs a tracer (--obs-sample-rate > 0
    # or --obs-tenant-sample).
    obs_otlp_endpoint: str = ""
    # Multi-cluster federation (gie_tpu/federation, docs/FEDERATION.md):
    # this cluster's name in the ClusterSet, the digest-exchange
    # listener, and the peer set ("name=http://host:port", repeatable).
    # Federation is on when peers are configured or the listener port is
    # set; imported peer endpoints become schedulable with a cost
    # penalty, and the exchange runs push/long-poll digest sync.
    fed_cluster: str = ""
    fed_peers: list = dataclasses.field(default_factory=list)
    fed_port: int = 0
    fed_bind: str = "127.0.0.1"
    # Cross-cluster cost penalty in queue-depth units (staleness
    # inflates it; see docs/FEDERATION.md "penalty model").
    fed_penalty: float = 4.0
    # Staleness at which the penalty has doubled.
    fed_stale_inflate_s: float = 5.0
    # Staleness past which a peer is LOCAL-ONLY (excluded from
    # spillover; lifts hysteretically at half this bound).
    fed_local_only_after_s: float = 10.0
    # Long-poll window peers park on the digest listener (push
    # semantics: a state change answers a parked poll in one RTT).
    fed_wait_s: float = 10.0
    # Publisher refresh cadence (the epoch heartbeat).
    fed_interval_s: float = 1.0
    # Bound on exported/imported endpoints per fed.load summary.
    fed_max_endpoints: int = 64
    # Start with the whole-cluster drain flag raised: new picks bleed to
    # healthy peers, peers stop spilling in (rollout/decommission mode).
    fed_drain: bool = False

    @staticmethod
    def add_flags(parser: argparse.ArgumentParser) -> None:
        d = Options()
        parser.add_argument("--grpc-port", type=int, default=d.grpc_port,
                            help="ext-proc gRPC port")
        parser.add_argument("--grpc-health-port", type=int,
                            default=d.grpc_health_port,
                            help="dedicated health gRPC port")
        parser.add_argument("--metrics-port", type=int, default=d.metrics_port,
                            help="prometheus metrics port")
        parser.add_argument("--pool-name", default=d.pool_name,
                            help="InferencePool to serve (required)")
        parser.add_argument("--pool-namespace", default=d.pool_namespace)
        parser.add_argument("--pool-group", default=d.pool_group)
        parser.add_argument("--secure-serving", action="store_true",
                            default=d.secure_serving)
        parser.add_argument("--insecure-serving", dest="secure_serving",
                            action="store_false")
        parser.add_argument("--cert-path", default=d.cert_path,
                            help="mounted TLS cert dir (tls.crt/tls.key); "
                                 "self-signed when unset")
        parser.add_argument("-v", "--verbosity", type=int, default=d.verbosity)
        parser.add_argument("--batch-window-ms", type=float,
                            default=d.batch_window_ms,
                            help="micro-batch collection window")
        parser.add_argument("--scrape-interval-ms", type=float,
                            default=d.scrape_interval_ms)
        parser.add_argument("--scrape-workers", type=int,
                            default=d.scrape_workers,
                            help="scrape-engine worker shards multiplexing "
                                 "all endpoint polls (0 = min(8, cpu))")
        parser.add_argument("--model-server-type", default=d.model_server_type,
                            choices=["vllm", "triton-tensorrt-llm",
                                     "trtllm-serve", "sglang"])
        parser.add_argument("--enable-predictor", action="store_true",
                            default=d.enable_predictor,
                            help="learned TTFT predictor scorer column with "
                                 "online training")
        parser.add_argument("--predictor-checkpoint-dir",
                            default=d.predictor_checkpoint_dir)
        parser.add_argument("--predictor-train-interval-s", type=float,
                            default=d.predictor_train_interval_s)
        parser.add_argument("--leader-elect", action="store_true",
                            default=d.leader_elect)
        parser.add_argument("--leader-lease-path", default=d.leader_lease_path)
        parser.add_argument("--scheduler-config", default=d.scheduler_config,
                            help="YAML scheduler profile "
                                 "(picker/thresholds/plugins/weights)")
        parser.add_argument("--mesh-devices", type=int, default=d.mesh_devices,
                            help="dp-shard the scheduling cycle over the "
                                 "first N local devices (0 = single-device)")
        parser.add_argument("--fleet-topk", type=int, default=d.fleet_topk,
                            help="hierarchical pick: score only the top-K "
                                 "candidate cells per wave (0 = off, dense "
                                 "path byte-identical)")
        parser.add_argument("--fleet-cell-cap", type=int,
                            default=d.fleet_cell_cap,
                            help="endpoint slots per fleet cell (multiple "
                                 "of 32)")
        parser.add_argument("--kv-events-port", type=int,
                            default=d.kv_events_port,
                            help="HTTP port for KV-cache event pushes "
                                 "(JSON lines; 0 = disabled)")
        parser.add_argument("--kv-events-bind", default=d.kv_events_bind,
                            help="bind address for the KV-events listener "
                                 "(default loopback; set the pod-network "
                                 "address explicitly to accept pushes)")
        parser.add_argument("--kv-events-token", default=d.kv_events_token,
                            help="shared bearer token required on KV-event "
                                 "POSTs (default: no auth)")
        parser.add_argument("--extproc-fast-lane", dest="extproc_fast_lane",
                            action="store_true",
                            default=d.extproc_fast_lane,
                            help="zero-parse admission fast path (native "
                                 "JSON field scan + pooled response "
                                 "templates + needed-keys header copy)")
        parser.add_argument("--no-extproc-fast-lane",
                            dest="extproc_fast_lane", action="store_false",
                            help="disable the admission fast lane (full "
                                 "json.loads + per-request response "
                                 "build; use when a custom picker reads "
                                 "headers beyond the needed-keys set)")
        parser.add_argument("--extproc-wire", dest="extproc_wire",
                            action="store_true", default=d.extproc_wire,
                            help="zero-protobuf wire lane: walk serialized "
                                 "ProcessingRequest frames natively and "
                                 "reply with pre-built bytes (needs the "
                                 "fast lane; unclassified frames fall "
                                 "back to the legacy path)")
        parser.add_argument("--no-extproc-wire", dest="extproc_wire",
                            action="store_false",
                            help="disable the wire lane (materialize "
                                 "every ext-proc frame as a protobuf)")
        parser.add_argument("--extproc-workers", type=int,
                            default=d.extproc_workers,
                            help="SO_REUSEPORT gRPC acceptors sharing the "
                                 "ext-proc port, datastore snapshot, and "
                                 "metrics registry (default 1)")
        parser.add_argument("--queue-bound", type=int, default=d.queue_bound,
                            help="max picks waiting in the flow-control "
                                 "queue; a full queue sheds by criticality "
                                 "(0 = unbounded)")
        parser.add_argument("--queue-max-age-s", type=float,
                            default=d.queue_max_age_s,
                            help="shed non-critical picks queued longer "
                                 "than this many seconds (0 = unbounded)")
        parser.add_argument("--autoscale-mode", default=d.autoscale_mode,
                            choices=["off", "recommend", "apply"],
                            help="closed-loop replica control: recommend "
                                 "(export gie_autoscale_* only) or apply "
                                 "(SSA-patch the target Deployment)")
        parser.add_argument("--autoscale-target", default=d.autoscale_target,
                            help="Deployment to scale in apply mode")
        parser.add_argument("--autoscale-min", type=int,
                            default=d.autoscale_min)
        parser.add_argument("--autoscale-max", type=int,
                            default=d.autoscale_max)
        parser.add_argument("--autoscale-interval-s", type=float,
                            default=d.autoscale_interval_s,
                            help="seconds between control cycles")
        parser.add_argument("--autoscale-shed-high", type=float,
                            default=d.autoscale_shed_high,
                            help="sustained shed rate (429/s) that "
                                 "triggers fast scale-up")
        parser.add_argument("--autoscale-down-cooldown-s", type=float,
                            default=d.autoscale_down_cooldown_s,
                            help="min seconds between scaling actions "
                                 "before one downward step (flap damping)")
        parser.add_argument("--autoscale-ttft-slo-ms", type=float,
                            default=d.autoscale_ttft_slo_ms,
                            help="TTFT SLO for the capacity model's "
                                 "latency-predictor cross-check (needs "
                                 "--enable-predictor; 0 = off)")
        parser.add_argument("--autoscale-state-dir",
                            default=d.autoscale_state_dir,
                            help="directory persisting the per-pool "
                                 "capacity EWMA across restarts (leader "
                                 "writes on shutdown, startup seeds from "
                                 "it)")
        parser.add_argument("--replication-port", type=int,
                            default=d.replication_port,
                            help="HTTP port serving /replication/digest "
                                 "for warm-standby state sync (0 = "
                                 "disabled)")
        parser.add_argument("--replication-bind", default=d.replication_bind,
                            help="bind address for the replication "
                                 "listener (default loopback; set the "
                                 "pod-network address explicitly)")
        parser.add_argument("--replication-advertise",
                            default=d.replication_advertise,
                            help="host:port peers reach this replica's "
                                 "digest on (carried in the election "
                                 "Lease holder identity; default "
                                 "bind:port)")
        parser.add_argument("--replication-interval-s", type=float,
                            default=d.replication_interval_s,
                            help="leader digest refresh / follower poll "
                                 "interval")
        parser.add_argument("--replication-stale-after-s", type=float,
                            default=d.replication_stale_after_s,
                            help="follower staleness bound for the "
                                 "replication health sub-service")
        parser.add_argument("--objective", action="append", default=[],
                            dest="objectives", metavar="NAME=CRITICALITY",
                            help="register an InferenceObjective "
                                 "(repeatable), e.g. premium-chat=3")
        parser.add_argument("--resilience", dest="resilience",
                            action="store_true", default=d.resilience,
                            help="circuit breakers + pick-path "
                                 "degradation ladder (docs/RESILIENCE.md)")
        parser.add_argument("--no-resilience", dest="resilience",
                            action="store_false",
                            help="disable the resilience layer (seed "
                                 "behavior: device failures fail the "
                                 "affected wave)")
        parser.add_argument("--resilience-static-subset", type=int,
                            default=d.resilience_static_subset,
                            help="endpoint pool size of the STATIC "
                                 "ladder rung")
        parser.add_argument("--ladder-cached-kv-weight", type=float,
                            default=d.ladder_cached_kv_weight,
                            help="CACHED-rung score weight: queue + "
                                 "w*kv_util (default from the storm "
                                 "sweep, docs/RESILIENCE.md)")
        parser.add_argument("--ladder-serve-window-s", type=float,
                            default=d.ladder_serve_window_s,
                            help="sliding window for the ladder's pool-"
                                 "wide serve-outcome floor")
        parser.add_argument("--ladder-serve-error-rate", type=float,
                            default=d.ladder_serve_error_rate,
                            help="pool-wide serve error rate that pins "
                                 "the ladder at ROUND_ROBIN")
        parser.add_argument("--ladder-serve-min-samples", type=int,
                            default=d.ladder_serve_min_samples,
                            help="min serve outcomes in the window "
                                 "before the serve floor may engage")
        parser.add_argument("--ladder-wrr-alpha", type=float,
                            default=d.ladder_wrr_alpha,
                            help="ROUND_ROBIN-rung WRR queue-shape "
                                 "exponent: weight=(1+queue)^-alpha; 0 "
                                 "= uniform rotation (default from the "
                                 "storm sweep, docs/RESILIENCE.md)")
        parser.add_argument("--fairness-weights", action="append",
                            default=[], dest="fairness_weights",
                            metavar="TENANT=WEIGHT[,TENANT=WEIGHT...]",
                            help="weighted-DRR tenant weights for the "
                                 "flow queue (repeatable; unlisted "
                                 "tenants weigh 1.0 — docs/FAIRNESS.md)")
        parser.add_argument("--fairness-over-factor", type=float,
                            default=d.fairness_over_factor,
                            help="over-fair-share factor: offered-cost "
                                 "share beyond factor x fair share "
                                 "makes a tenant's SHEDDABLE traffic "
                                 "shed first under saturation")
        parser.add_argument("--fairness-window-s", type=float,
                            default=d.fairness_window_s,
                            help="sliding window for per-tenant budget "
                                 "ledgers (cost shares, shed/error "
                                 "rates)")
        parser.add_argument("--fairness-top-k", type=int,
                            default=d.fairness_top_k,
                            help="gie_tenant_* label cardinality: top-K "
                                 "tenants by traffic keep their own "
                                 "label, the long tail exports 'other'")
        parser.add_argument("--outlier-ejection", dest="outlier_ejection",
                            action="store_true",
                            default=d.outlier_ejection,
                            help="p99 serve-latency outlier ejection: "
                                 "quarantine endpoints whose windowed "
                                 "latency quantile exceeds --outlier-"
                                 "ratio x the pool median "
                                 "(docs/RESILIENCE.md)")
        parser.add_argument("--outlier-window-s", type=float,
                            default=d.outlier_window_s,
                            help="sliding serve-latency window per "
                                 "endpoint")
        parser.add_argument("--outlier-ratio", type=float,
                            default=d.outlier_ratio,
                            help="ejection threshold: endpoint quantile "
                                 "vs pool median")
        parser.add_argument("--outlier-quantile", type=float,
                            default=d.outlier_quantile,
                            help="per-endpoint latency quantile compared "
                                 "against the pool median")
        parser.add_argument("--fault", action="append", default=[],
                            dest="fault_specs",
                            metavar="POINT=KIND:PROB[:ARG],...",
                            help="gie-chaos fault injection spec "
                                 "(repeatable), e.g. "
                                 "scrape.fetch=error:0.2,latency:0.1:80ms")
        parser.add_argument("--fault-seed", type=int, default=d.fault_seed,
                            help="seed for the deterministic fault "
                                 "schedule")
        parser.add_argument("--fault-scenario", default=d.fault_scenario,
                            metavar="FILE|NAME",
                            help="recorded chaos scenario JSON to arm at "
                                 "startup (a path, or a shipped-library "
                                 "name like 'mixed-soak'); mutually "
                                 "exclusive with --fault")
        parser.add_argument("--drain-deadline-s", type=float,
                            default=d.drain_deadline_s,
                            help="bounded graceful-drain window: how long "
                                 "a terminating pod's endpoints may finish "
                                 "in-flight streams before slot reclaim")
        parser.add_argument("--pd-budget-floor-ms", type=float,
                            default=d.pd_budget_floor_ms,
                            help="disaggregated picks with less deadline "
                                 "budget than this collapse to the decode "
                                 "worker only (0 disables)")
        parser.add_argument("--obs", dest="obs", action="store_true",
                            default=d.obs,
                            help="pick flight recorder + /debugz "
                                 "introspection plane "
                                 "(docs/OBSERVABILITY.md)")
        parser.add_argument("--no-obs", dest="obs", action="store_false",
                            help="disable the observability layer "
                                 "entirely (no recorder, no tracer, "
                                 "bare /metrics only)")
        parser.add_argument("--obs-sample-rate", type=float,
                            default=d.obs_sample_rate,
                            help="head-sampling rate for request traces "
                                 "in [0, 1]; 0 installs no tracer (errors "
                                 "always export at any rate > 0)")
        parser.add_argument("--obs-sample-seed", type=int,
                            default=d.obs_sample_seed,
                            help="deterministic sampling seed (same seed "
                                 "+ trace ID = same keep/drop everywhere)")
        parser.add_argument("--obs-ring", type=int, default=d.obs_ring,
                            help="flight-recorder ring capacity (records)")
        parser.add_argument("--obs-slow-ms", type=float,
                            default=d.obs_slow_ms,
                            help="latency tail-outlier threshold: slower "
                                 "traces export even when unsampled")
        parser.add_argument("--obs-dump-dir", default=d.obs_dump_dir,
                            help="directory for chaos-scenario flight-"
                                 "recorder JSON artifacts")
        parser.add_argument("--obs-dump-interval-s", type=float,
                            default=d.obs_dump_interval_s,
                            help="periodic flight-recorder dump rotation "
                                 "into --obs-dump-dir (gie-learn's "
                                 "training feed); 0 = off")
        parser.add_argument("--obs-dump-keep", type=int,
                            default=d.obs_dump_keep,
                            help="rotation bound: at most this many "
                                 "periodic dump files kept (oldest "
                                 "deleted first)")
        parser.add_argument("--scorer", default=d.scorer,
                            choices=("blend", "learned"),
                            help="cycle scorer: the heuristic weighted-"
                                 "sum blend (default) or the gie-learn "
                                 "multiplicative policy (needs "
                                 "--policy-artifact)")
        parser.add_argument("--policy-artifact", default=d.policy_artifact,
                            metavar="PATH",
                            help="trained gie-learn-policy/1 artifact "
                                 "(checksum-verified, feature schema "
                                 "validated at startup)")
        parser.add_argument("--obs-tenant-sample", action="append",
                            default=[], dest="obs_tenant_sample",
                            metavar="TENANT=RATE",
                            help="per-tenant trace-rate override "
                                 "(repeatable): trace one noisy tenant "
                                 "at 1.0 while the fleet stays at "
                                 "--obs-sample-rate")
        parser.add_argument("--obs-otlp-endpoint",
                            default=d.obs_otlp_endpoint,
                            help="OTLP/HTTP collector base URL (spans "
                                 "POST to <endpoint>/v1/traces, batched "
                                 "off the hot path); empty = disabled")
        parser.add_argument("--fed-cluster", default=d.fed_cluster,
                            help="this cluster's name in the federation "
                                 "ClusterSet (required with --fed-peer "
                                 "or --fed-port)")
        parser.add_argument("--fed-peer", action="append", default=[],
                            dest="fed_peers", metavar="NAME=URL",
                            help="peer cluster digest endpoint "
                                 "(repeatable), e.g. "
                                 "west=http://epp.west:9010")
        parser.add_argument("--fed-port", type=int, default=d.fed_port,
                            help="HTTP port serving /federation/digest "
                                 "to peers (0 = do not serve)")
        parser.add_argument("--fed-bind", default=d.fed_bind,
                            help="bind address for the federation "
                                 "listener (default loopback; set the "
                                 "pod-network address explicitly)")
        parser.add_argument("--fed-penalty", type=float,
                            default=d.fed_penalty,
                            help="cross-cluster cost penalty in queue-"
                                 "depth units (staleness-inflated; "
                                 "docs/FEDERATION.md)")
        parser.add_argument("--fed-stale-inflate-s", type=float,
                            default=d.fed_stale_inflate_s,
                            help="link staleness at which the penalty "
                                 "has doubled")
        parser.add_argument("--fed-local-only-after-s", type=float,
                            default=d.fed_local_only_after_s,
                            help="link staleness past which the peer is "
                                 "excluded from spillover entirely "
                                 "(lifts hysteretically at half this)")
        parser.add_argument("--fed-wait-s", type=float,
                            default=d.fed_wait_s,
                            help="long-poll window peers park on the "
                                 "digest listener")
        parser.add_argument("--fed-interval-s", type=float,
                            default=d.fed_interval_s,
                            help="federation publisher refresh cadence")
        parser.add_argument("--fed-max-endpoints", type=int,
                            default=d.fed_max_endpoints,
                            help="bound on endpoints per exported load "
                                 "summary (lowest-queue rows kept)")
        parser.add_argument("--fed-drain", action="store_true",
                            default=d.fed_drain,
                            help="start with the whole-cluster drain "
                                 "flag raised: new picks bleed to "
                                 "healthy peers, peers stop spilling in")
        parser.add_argument("--debugz-bind", default=d.debugz_bind,
                            help="peer gate for the /debugz zpages: "
                                 "loopback-only by default; name a non-"
                                 "loopback address (pod IP, 0.0.0.0) to "
                                 "expose them (/metrics is unaffected)")
        parser.add_argument("--debugz-token", default=d.debugz_token,
                            help="bearer token required from non-"
                                 "loopback peers on /debugz paths "
                                 "(constant-time compare, 401 without "
                                 "it; /metrics unaffected)")

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "Options":
        return cls(
            grpc_port=args.grpc_port,
            grpc_health_port=args.grpc_health_port,
            metrics_port=args.metrics_port,
            pool_name=args.pool_name,
            pool_namespace=args.pool_namespace,
            pool_group=args.pool_group,
            secure_serving=args.secure_serving,
            cert_path=args.cert_path,
            verbosity=args.verbosity,
            batch_window_ms=args.batch_window_ms,
            scrape_interval_ms=args.scrape_interval_ms,
            scrape_workers=args.scrape_workers,
            model_server_type=args.model_server_type,
            enable_predictor=args.enable_predictor,
            predictor_checkpoint_dir=args.predictor_checkpoint_dir,
            predictor_train_interval_s=args.predictor_train_interval_s,
            leader_elect=args.leader_elect,
            leader_lease_path=args.leader_lease_path,
            objectives=list(args.objectives),
            scheduler_config=args.scheduler_config,
            mesh_devices=args.mesh_devices,
            fleet_topk=args.fleet_topk,
            fleet_cell_cap=args.fleet_cell_cap,
            kv_events_port=args.kv_events_port,
            kv_events_bind=args.kv_events_bind,
            kv_events_token=args.kv_events_token,
            extproc_fast_lane=args.extproc_fast_lane,
            extproc_wire=args.extproc_wire,
            extproc_workers=args.extproc_workers,
            queue_bound=args.queue_bound,
            queue_max_age_s=args.queue_max_age_s,
            autoscale_mode=args.autoscale_mode,
            autoscale_target=args.autoscale_target,
            autoscale_min=args.autoscale_min,
            autoscale_max=args.autoscale_max,
            autoscale_interval_s=args.autoscale_interval_s,
            autoscale_shed_high=args.autoscale_shed_high,
            autoscale_down_cooldown_s=args.autoscale_down_cooldown_s,
            autoscale_ttft_slo_ms=args.autoscale_ttft_slo_ms,
            autoscale_state_dir=args.autoscale_state_dir,
            replication_port=args.replication_port,
            replication_bind=args.replication_bind,
            replication_advertise=args.replication_advertise,
            replication_interval_s=args.replication_interval_s,
            replication_stale_after_s=args.replication_stale_after_s,
            resilience=args.resilience,
            resilience_static_subset=args.resilience_static_subset,
            ladder_cached_kv_weight=args.ladder_cached_kv_weight,
            ladder_serve_window_s=args.ladder_serve_window_s,
            ladder_serve_error_rate=args.ladder_serve_error_rate,
            ladder_serve_min_samples=args.ladder_serve_min_samples,
            ladder_wrr_alpha=args.ladder_wrr_alpha,
            fairness_weights=list(args.fairness_weights),
            fairness_over_factor=args.fairness_over_factor,
            fairness_window_s=args.fairness_window_s,
            fairness_top_k=args.fairness_top_k,
            outlier_ejection=args.outlier_ejection,
            outlier_window_s=args.outlier_window_s,
            outlier_ratio=args.outlier_ratio,
            outlier_quantile=args.outlier_quantile,
            debugz_bind=args.debugz_bind,
            debugz_token=args.debugz_token,
            fault_specs=list(args.fault_specs),
            fault_seed=args.fault_seed,
            fault_scenario=args.fault_scenario,
            drain_deadline_s=args.drain_deadline_s,
            pd_budget_floor_ms=args.pd_budget_floor_ms,
            obs=args.obs,
            obs_sample_rate=args.obs_sample_rate,
            obs_sample_seed=args.obs_sample_seed,
            obs_ring=args.obs_ring,
            obs_slow_ms=args.obs_slow_ms,
            obs_tenant_sample=list(args.obs_tenant_sample),
            obs_dump_dir=args.obs_dump_dir,
            obs_dump_interval_s=args.obs_dump_interval_s,
            obs_dump_keep=args.obs_dump_keep,
            scorer=args.scorer,
            policy_artifact=args.policy_artifact,
            obs_otlp_endpoint=args.obs_otlp_endpoint,
            fed_cluster=args.fed_cluster,
            fed_peers=list(args.fed_peers),
            fed_port=args.fed_port,
            fed_bind=args.fed_bind,
            fed_penalty=args.fed_penalty,
            fed_stale_inflate_s=args.fed_stale_inflate_s,
            fed_local_only_after_s=args.fed_local_only_after_s,
            fed_wait_s=args.fed_wait_s,
            fed_interval_s=args.fed_interval_s,
            fed_max_endpoints=args.fed_max_endpoints,
            fed_drain=args.fed_drain,
        )

    def validate(self) -> None:
        """reference options.go:84-94."""
        if not self.pool_name:
            raise ValueError("--pool-name is required")
        for name, port in (
            ("grpc-port", self.grpc_port),
            ("grpc-health-port", self.grpc_health_port),
            ("metrics-port", self.metrics_port),
        ):
            if not (0 < port < 65536):
                raise ValueError(f"--{name} {port} out of range")
        if self.verbosity < 0 or self.verbosity > 5:
            raise ValueError("-v must be 0..5")
        if self.mesh_devices < 0:
            raise ValueError("--mesh-devices must be >= 0")
        if self.scrape_workers < 0:
            raise ValueError("--scrape-workers must be >= 0 (0 = auto)")
        if self.scrape_interval_ms <= 0:
            raise ValueError("--scrape-interval-ms must be > 0")
        # One completion queue per worker plus a 64-thread pool each:
        # beyond ~64 acceptors the thread count, not the port spread, is
        # the binding constraint, and the value is surely a typo.
        if not (1 <= self.extproc_workers <= 64):
            raise ValueError("--extproc-workers must be 1..64")
        # With tp=1 the dp axis equals the device count, and dp must be a
        # power of two to divide the request buckets (sched/profile.py).
        if self.mesh_devices > 1 and self.mesh_devices & (self.mesh_devices - 1):
            raise ValueError("--mesh-devices must be a power of two")
        if self.fleet_topk < 0:
            raise ValueError("--fleet-topk must be >= 0 (0 = off)")
        if self.fleet_topk:
            if self.fleet_cell_cap < 32 or self.fleet_cell_cap % 32:
                raise ValueError(
                    "--fleet-cell-cap must be a positive multiple of 32")
            # The candidate block must fit one dense cycle (the largest
            # compressed M bucket) — reject at startup, not first wave.
            from gie_tpu_torch.sched import constants as _C
            if self.fleet_topk * self.fleet_cell_cap > _C.M_BUCKETS[-1]:
                raise ValueError(
                    f"--fleet-topk x --fleet-cell-cap = "
                    f"{self.fleet_topk * self.fleet_cell_cap} exceeds the "
                    f"largest compressed bucket {_C.M_BUCKETS[-1]}")
        if not (0 <= self.kv_events_port < 65536):
            raise ValueError("--kv-events-port out of range")
        if not (0 <= self.replication_port < 65536):
            raise ValueError("--replication-port out of range")
        if self.replication_port > 0:
            if self.replication_interval_s <= 0:
                raise ValueError("--replication-interval-s must be > 0")
            if self.replication_stale_after_s <= 0:
                raise ValueError("--replication-stale-after-s must be > 0")
            if self.replication_advertise and ":" not in self.replication_advertise:
                raise ValueError(
                    "--replication-advertise must be host:port")
            if (not self.replication_advertise
                    and self.replication_bind in ("0.0.0.0", "::", "")):
                # A wildcard bind cannot default the advertise address:
                # the Lease would carry "0.0.0.0:port" and every follower
                # would dial ITSELF (and get 503 "not leader") — a
                # standby that silently never syncs.
                raise ValueError(
                    "--replication-bind on a wildcard address requires "
                    "an explicit --replication-advertise host:port")
        if self.autoscale_mode not in ("off", "recommend", "apply"):
            raise ValueError(
                f"--autoscale-mode {self.autoscale_mode!r} must be "
                "off|recommend|apply")
        if self.autoscale_mode == "apply" and not self.autoscale_target:
            raise ValueError(
                "--autoscale-mode apply requires --autoscale-target")
        if self.autoscale_mode != "off":
            if not (0 <= self.autoscale_min <= self.autoscale_max):
                raise ValueError(
                    "need 0 <= --autoscale-min <= --autoscale-max")
            if self.autoscale_interval_s <= 0:
                raise ValueError("--autoscale-interval-s must be > 0")
            if self.autoscale_ttft_slo_ms < 0:
                raise ValueError("--autoscale-ttft-slo-ms must be >= 0")
        if self.resilience_static_subset < 1:
            raise ValueError("--resilience-static-subset must be >= 1")
        if self.ladder_cached_kv_weight < 0:
            raise ValueError("--ladder-cached-kv-weight must be >= 0")
        if self.ladder_serve_window_s <= 0:
            raise ValueError("--ladder-serve-window-s must be > 0")
        if not (0.0 < self.ladder_serve_error_rate <= 1.0):
            raise ValueError(
                "--ladder-serve-error-rate must be in (0, 1]")
        if self.ladder_serve_min_samples < 1:
            raise ValueError("--ladder-serve-min-samples must be >= 1")
        if self.ladder_wrr_alpha < 0:
            raise ValueError("--ladder-wrr-alpha must be >= 0")
        if self.fairness_weights:
            from gie_tpu_torch.fairness import parse_weights

            try:
                parse_weights(self.fairness_weights)
            except ValueError as e:
                raise ValueError(f"--fairness-weights: {e}") from None
        if self.fairness_over_factor <= 1.0:
            raise ValueError("--fairness-over-factor must be > 1")
        if self.fairness_window_s <= 0:
            raise ValueError("--fairness-window-s must be > 0")
        if self.fairness_top_k < 1:
            raise ValueError("--fairness-top-k must be >= 1")
        for spec in self.obs_tenant_sample:
            name, sep, raw = str(spec).partition("=")
            if not sep or not name:
                raise ValueError(
                    f"--obs-tenant-sample {spec!r} must be TENANT=RATE")
            try:
                rate = float(raw)
            except ValueError:
                raise ValueError(
                    f"--obs-tenant-sample {spec!r}: rate must be a "
                    "number") from None
            if not (0.0 <= rate <= 1.0):
                raise ValueError(
                    f"--obs-tenant-sample {spec!r}: rate must be in "
                    "[0, 1]")
        if self.outlier_ejection:
            if self.outlier_window_s <= 0:
                raise ValueError("--outlier-window-s must be > 0")
            if self.outlier_ratio <= 1.0:
                raise ValueError("--outlier-ratio must be > 1")
            if not (0.5 <= self.outlier_quantile < 1.0):
                raise ValueError(
                    "--outlier-quantile must be in [0.5, 1)")
        if self.fault_specs:
            from gie_tpu_torch.resilience import faults as _faults

            try:
                _faults.parse_spec(self.fault_specs)
            except ValueError as e:
                raise ValueError(f"--fault: {e}") from None
        if self.fault_scenario:
            if self.fault_specs:
                # A scenario IS a recorded spec; merging ad-hoc rules in
                # would break its bit-for-bit replay claim.
                raise ValueError(
                    "--fault-scenario and --fault are mutually exclusive")
            from gie_tpu_torch.resilience import scenarios as _scenarios

            try:
                _scenarios.load(self.fault_scenario)
            except ValueError as e:
                raise ValueError(f"--fault-scenario: {e}") from None
        if self.drain_deadline_s <= 0:
            raise ValueError("--drain-deadline-s must be > 0")
        if self.fed_peers or self.fed_port > 0 or self.fed_drain:
            if not self.fed_cluster:
                raise ValueError(
                    "--fed-cluster is required with --fed-peer/--fed-"
                    "port/--fed-drain (peers must know who we are)")
            if not (0 <= self.fed_port < 65536):
                raise ValueError("--fed-port out of range")
            for spec in self.fed_peers:
                name, sep, url = str(spec).partition("=")
                if not sep or not name or "://" not in url:
                    raise ValueError(
                        f"--fed-peer {spec!r} must be NAME=http://host:port")
                if name == self.fed_cluster:
                    raise ValueError(
                        f"--fed-peer {spec!r} names this cluster itself")
            if self.fed_penalty < 0:
                raise ValueError("--fed-penalty must be >= 0")
            if self.fed_stale_inflate_s <= 0:
                raise ValueError("--fed-stale-inflate-s must be > 0")
            if self.fed_local_only_after_s <= 0:
                raise ValueError("--fed-local-only-after-s must be > 0")
            if self.fed_wait_s < 0:
                raise ValueError("--fed-wait-s must be >= 0")
            if self.fed_interval_s <= 0:
                raise ValueError("--fed-interval-s must be > 0")
            if self.fed_max_endpoints < 1:
                raise ValueError("--fed-max-endpoints must be >= 1")
        if not (0.0 <= self.obs_sample_rate <= 1.0):
            raise ValueError("--obs-sample-rate must be in [0, 1]")
        if self.obs_ring < 1:
            raise ValueError("--obs-ring must be >= 1")
        if self.obs_slow_ms <= 0:
            raise ValueError("--obs-slow-ms must be > 0")
        if self.obs_dump_interval_s < 0:
            raise ValueError("--obs-dump-interval-s must be >= 0")
        if self.obs_dump_interval_s > 0:
            if not self.obs:
                raise ValueError(
                    "--obs-dump-interval-s needs the flight recorder "
                    "(drop --no-obs)")
            if self.obs_dump_keep < 1:
                raise ValueError("--obs-dump-keep must be >= 1")
        if self.scorer not in ("blend", "learned"):
            raise ValueError(
                f"--scorer {self.scorer!r} must be blend|learned")
        if self.scorer == "learned" and not self.policy_artifact:
            raise ValueError(
                "--scorer learned requires --policy-artifact (a "
                "gie-learn-policy/1 file; see docs/LEARNED.md)")
        if self.policy_artifact and self.scorer != "learned":
            raise ValueError(
                "--policy-artifact is only read with --scorer learned "
                "(refusing to silently ignore a trained policy)")
        if self.pd_budget_floor_ms < 0:
            raise ValueError("--pd-budget-floor-ms must be >= 0")
        for spec in self.objectives:
            name, sep, crit = spec.partition("=")
            if not sep or not name:
                raise ValueError(
                    f"--objective {spec!r} must be NAME=CRITICALITY"
                )
            try:
                int(crit)
            except ValueError:
                raise ValueError(
                    f"--objective {spec!r}: criticality must be an integer"
                ) from None
