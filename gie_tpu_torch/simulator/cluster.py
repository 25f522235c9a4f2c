"""SimCluster: closed-loop cluster simulation for scheduler benchmarking
(port of gie_tpu/simulator/cluster.py; the scheduler, the latency
predictor's trainer and the KV-event aggregator are the port's, on the
device the caller built them for).

The benchmarking harness the scheduler proposal calls for (reference
docs/proposals/006-scheduler/README.md:164-174): a fleet of VLLMStub model
servers, a session-structured traffic generator (shared system prompts ->
prefix reuse; LoRA adapter mix), the real metrics pipeline (stub prometheus
text -> parse_scrape -> MetricsStore), and pluggable scheduling policies:

  tpu       — the batched Scheduler (full scorer blend on device)
  least-kv  — per-request argmax of free KV cache (the reference EPP's
              default scorer; BASELINE configs[0] baseline)
  round-robin — lwepp's RoundRobinPicker equivalent

Goodput = output tokens/s from requests meeting the TTFT SLO (the
"cluster tokens/sec goodput" of the BASELINE north star).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import torch

from gie_tpu_torch.metricsio import MetricsStore
from gie_tpu_torch.metricsio.mappings import VLLM
from gie_tpu_torch.metricsio.scrape import parse_scrape
from gie_tpu_torch.models.latency import host_features
from gie_tpu_torch.sched import constants as C
from gie_tpu_torch.sched.hashing import batch_chunk_hashes
from gie_tpu_torch.sched.profile import Scheduler, request_cost_host
from gie_tpu_torch.sched.types import RequestBatch
from gie_tpu_torch.simulator.vllm_stub import StubConfig, VLLMStub
from gie_tpu_torch.utils.lora import LoraRegistry


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    arrival_qps: float = 40.0
    n_sessions: int = 24           # distinct shared system prompts
    system_prompt_bytes: int = 2048
    user_suffix_bytes: int = 256
    decode_tokens_mean: float = 96.0
    lora_adapters: int = 0         # 0 = base-model-only workload
    ttft_slo_s: float = 2.0


def client_cap_tokens(decode_tokens: float) -> float:
    """Client-style max_tokens cap for a request whose TRUE generated
    length is `decode_tokens`: rounded UP to the next power-of-two bucket
    (min 16) — what a real client that roughly knows its answer size would
    send. The scheduler sees ONLY this cap (sim-to-prod signal parity:
    production extracts max_tokens from the body, never the true length;
    VERDICT r3 #3); execution still generates the true length."""
    import math

    return float(max(16, 1 << math.ceil(math.log2(max(decode_tokens, 1.0)))))


def tuned_scheduler(device=None) -> Scheduler:
    """Scheduler built from sched.config.tuned_profile() — the round-1
    swept Sinkhorn profile (goodput 2.15x vs least-kv; see
    docs/BENCH_NOTES.md for the sweep history). On CUDA unless `device`
    names another."""
    from gie_tpu_torch.sched.config import tuned_profile

    cfg, weights = tuned_profile()
    return Scheduler(cfg, weights=weights, device=device)


@dataclasses.dataclass
class RunStats:
    goodput_tokens_per_s: float
    throughput_tokens_per_s: float
    ttft_p50_s: float
    ttft_p99_s: float
    slo_attainment: float
    prefix_hit_rate: float
    completed: int
    shed: int = 0


class SimCluster:
    def __init__(
        self,
        n_pods: int = 8,
        stub_cfg: StubConfig | list[StubConfig] = StubConfig(),
        seed: int = 0,
    ):
        # A list of StubConfigs (one per pod) models a HETEROGENEOUS fleet
        # (mixed accelerator generations / degraded pods) — the workload
        # where the latency predictor's per-endpoint embedding earns its
        # weight over metric-only heuristics.
        if isinstance(stub_cfg, list):
            if len(stub_cfg) != n_pods:
                raise ValueError("need one StubConfig per pod")
            cfgs = stub_cfg
        else:
            cfgs = [stub_cfg] * n_pods
        self.stubs = [
            VLLMStub(cfg, name=f"pod-{i}") for i, cfg in enumerate(cfgs)
        ]
        self.n = n_pods
        self.roles = [cfg.role for cfg in cfgs]
        self.rng = np.random.default_rng(seed)
        self.store = MetricsStore()
        self.lora_reg = LoraRegistry()

    def _scrape_all(self, now: float) -> None:
        for slot, stub in enumerate(self.stubs):
            metrics, active, waiting = parse_scrape(
                stub.metrics_text(), VLLM, self.lora_reg
            )
            self.store.update(
                slot, metrics, lora_active=active, lora_waiting=waiting, now=now
            )

    def _endpoint_batch(self, now: float):
        from gie_tpu_torch.api.types import ROLE_LABEL

        class _Ep:
            __slots__ = ("slot", "labels")

            def __init__(self, slot, role):
                self.slot = slot
                self.labels = {ROLE_LABEL: role}

        return self.store.endpoint_batch(
            [_Ep(i, self.roles[i]) for i in range(self.n)], now=now)

    def run(
        self,
        policy: str,
        workload: WorkloadConfig = WorkloadConfig(),
        duration_s: float = 30.0,
        dt: float = 0.02,
        scrape_interval_s: float = 0.05,
        scheduler: Optional[Scheduler] = None,
        trainer=None,
        train_every_s: float = 1.0,
        slo_admission: bool = False,
        kv_transfer_s_per_kb: float = 0.002,
        kv_events: bool = False,
    ) -> RunStats:
        wl = workload
        sessions = [
            (b"SYSTEM PROMPT session %03d | " % s) * 2
            + b"x" * max(wl.system_prompt_bytes - 60, 0)
            for s in range(wl.n_sessions)
        ]
        if policy == "tpu" and scheduler is None:
            scheduler = tuned_scheduler()
        pd = (policy == "tpu" and scheduler is not None
              and scheduler.cfg.pd_disaggregation)
        if pd and (trainer is not None or slo_admission):
            raise ValueError(
                "pd_disaggregation with trainer/slo_admission is not "
                "modeled in the sim yet")
        from gie_tpu_torch.sched.profile import pd_costs_host

        kv_agg = None
        if kv_events and policy == "tpu" and scheduler is not None:
            # Remote-cache interface (roadmap item 1): each stub publishes
            # stored/evicted chunk hashes from its REAL cache LRU; the
            # aggregator folds them into the device index, correcting the
            # pick-time optimistic guesses (which never observe evictions).
            from gie_tpu_torch.sched.kvevents import KVEventAggregator

            slot_by_hostport = {
                stub.hostport: i for i, stub in enumerate(self.stubs)
            }
            kv_agg = KVEventAggregator(
                scheduler, lambda hp: slot_by_hostport.get(hp))
            for stub in self.stubs:
                stub.event_sink = kv_agg.publish

        # Disaggregated bookkeeping: prefill jobs in flight on prefill
        # workers, decode jobs waiting on KV transfer, decode jobs running.
        prefill_jobs: dict = {}   # (pod, rid) -> (d_pod, prompt, D, lora, t0)
        pending_decode: list = []  # (ready_t, d_pod, prompt, D, lora, t0, hit)
        decode_jobs: dict = {}    # (pod, rid) -> (t0, t_submit, pbytes, hit)
        rr_counter = 0
        clock = 0.0
        next_scrape = 0.0
        next_train = train_every_s
        completions = []
        shed = 0
        # (pod_slot, stub_rid) -> pick-time feature row for online training
        # (BASELINE configs[3]: the predictor learns from served timings).
        feature_log: dict[tuple[int, int], np.ndarray] = {}
        # (pod_slot, stub_rid) -> assumed cost charged at pick time (from
        # the client-cap hint), released verbatim on completion.
        charge_log: dict[tuple[int, int], float] = {}
        # Adversarial baseline bookkeeping ("least-kv-assumed", VERDICT r3
        # #8): requests in flight per pod, maintained between scrapes the
        # way the reference EPP's assumed-load accounting would — the
        # baseline stops being blind to its own last-50ms placements.
        self._baseline_inflight = np.zeros((self.n,), np.float64)
        self._scrape_all(0.0)

        while clock < duration_s:
            # --- arrivals (Poisson) ---------------------------------------
            n_new = self.rng.poisson(wl.arrival_qps * dt)
            prompts, decodes, hints, loras = [], [], [], []
            for _ in range(n_new):
                sess = self.rng.integers(0, wl.n_sessions)
                suffix = bytes(
                    self.rng.integers(97, 122, wl.user_suffix_bytes, dtype=np.uint8)
                )
                prompts.append(sessions[sess] + suffix)
                decodes.append(
                    float(max(self.rng.exponential(wl.decode_tokens_mean), 8.0))
                )
                # What the scheduler/predictor may see: the client cap in
                # prompt-char-equivalents — never the true decode length.
                hints.append(
                    client_cap_tokens(decodes[-1]) * C.CHARS_PER_TOKEN)
                loras.append(
                    f"adapter-{self.rng.integers(0, wl.lora_adapters)}"
                    if wl.lora_adapters > 0
                    else None
                )

            # --- schedule -------------------------------------------------
            if n_new:
                picks, prefill_picks = self._schedule(
                    policy, scheduler, prompts, hints, loras, clock, rr_counter
                )
                rr_counter += n_new
                if trainer is not None:
                    # Pick-time truth for training features: the LIVE
                    # assumed-load vector (what serving-time features see)
                    # and scrape age — never constants, or the predictor
                    # trains on a different feature space than it scores.
                    loads = (scheduler.snapshot_assumed_load()
                             if scheduler is not None else None)

                    def feats_for(pod, prompt, decode_hint, lora):
                        row = self.store._metrics[pod].copy()
                        row[C.Metric.METRICS_AGE_S] = max(
                            clock - self.store._scraped_at[pod], 0.0)
                        return host_features(
                            row,
                            float(loads[pod]) if loads is not None else 0.0,
                            float(len(prompt)),
                            float(decode_hint),
                            lora is not None,
                        )

                admitted = [True] * n_new
                precomputed_rows = None
                if slo_admission and trainer is not None:
                    # Predictive SLO admission (006 README:27-36): shed
                    # arrivals whose predicted TTFT on their picked pod
                    # already misses the SLO — a late answer burns prefill
                    # capacity for zero goodput. Released charges mirror
                    # the EPP's _slo_admission path.
                    precomputed_rows = [
                        feats_for(pod, prompt, hint, lora)
                        for prompt, hint, lora, pod in zip(
                            prompts, hints, loras, picks)
                    ]
                    pred = trainer.predict_ttft(
                        np.stack(precomputed_rows),
                        np.asarray(picks, np.int32))
                    for i, pod in enumerate(picks):
                        if pred[i] > wl.ttft_slo_s:
                            admitted[i] = False
                            shed += 1
                            if scheduler is not None and policy == "tpu":
                                scheduler.complete(
                                    np.asarray([pod], np.int32),
                                    np.asarray([request_cost_host(
                                        float(len(prompts[i])),
                                        hints[i])], np.float32),
                                )
                for i, (prompt, decode, lora, pod) in enumerate(
                        zip(prompts, decodes, loras, picks)):
                    hint = hints[i]
                    if not admitted[i]:
                        continue
                    if pd:
                        p_pod = prefill_picks[i]
                        if pod < 0 or p_pod < 0:
                            # Rejected by the dual pick (no capacity on one
                            # role): the cycle charged nothing; count as
                            # shed rather than executing on a wrong-role
                            # pod.
                            shed += 1
                            continue
                        # Dual-phase execution: the prompt runs on the
                        # PREFILL worker (a decode_tokens=0 job models
                        # "compute KV, emit nothing"); its completion
                        # triggers the KV transfer and the decode job.
                        rid = self.stubs[p_pod].submit(
                            prompt, decode_tokens=0.0, lora=lora)
                        prefill_jobs[(p_pod, rid)] = (
                            pod, prompt, decode, hint, lora, clock)
                        continue
                    rid = self.stubs[pod].submit(
                        prompt, decode_tokens=decode, lora=lora)
                    self._baseline_inflight[pod] += 1.0
                    # Release-what-was-charged: the cycle charged from the
                    # HINT (the only signal it had); completion must
                    # release the same amount, not one recomputed from the
                    # true generated length. Only the tpu policy charges
                    # (and pops) — logging for baselines would just leak.
                    if policy == "tpu" and scheduler is not None:
                        charge_log[(pod, rid)] = request_cost_host(
                            float(len(prompt)), hint)
                    if trainer is not None:
                        feature_log[(pod, rid)] = (
                            precomputed_rows[i]
                            if precomputed_rows is not None
                            else feats_for(pod, prompt, hint, lora))

            # --- advance the fleet ----------------------------------------
            for slot, stub in enumerate(self.stubs):
                for comp in stub.step(dt):
                    if pd and (slot, comp.rid) in prefill_jobs:
                        # Prefill done: start the KV transfer; the decode
                        # job submits when it lands. Release the prefill
                        # worker's charge (pd split-charging twin).
                        (d_pod, prompt, decode, hint, lora,
                         t0) = prefill_jobs.pop((slot, comp.rid))
                        transfer_s = (
                            0.0 if d_pod == slot
                            else kv_transfer_s_per_kb * len(prompt) / 1024.0)
                        pending_decode.append(
                            (clock + transfer_s, d_pod, prompt, decode,
                             hint, lora, t0, comp.hit_fraction))
                        p_cost, _ = pd_costs_host(float(len(prompt)), hint)
                        scheduler.complete(
                            np.asarray([slot], np.int32),
                            np.asarray([p_cost], np.float32))
                        continue
                    if pd and (slot, comp.rid) in decode_jobs:
                        t0, t_d, pbytes, hint, hit = decode_jobs.pop(
                            (slot, comp.rid))
                        # User-visible TTFT spans the whole chain: prefill
                        # queue+compute, transfer, decode queue+first token
                        # = (decode submit time + decode-relative ttft)
                        #   - original arrival.
                        user_ttft = t_d + comp.ttft_s - t0
                        completions.append(dataclasses.replace(
                            comp, ttft_s=max(user_ttft, 0.0),
                            hit_fraction=hit, prompt_bytes=pbytes))
                        _, d_cost = pd_costs_host(pbytes, hint)
                        scheduler.complete(
                            np.asarray([slot], np.int32),
                            np.asarray([d_cost], np.float32))
                        continue
                    completions.append(comp)
                    self._baseline_inflight[slot] = max(
                        self._baseline_inflight[slot] - 1.0, 0.0)
                    if trainer is not None:
                        feats = feature_log.pop((slot, comp.rid), None)
                        if feats is not None:
                            trainer.observe(
                                feats, ttft_s=comp.ttft_s,
                                tpot_s=comp.tpot_s, slot=slot)
                    if scheduler is not None and policy == "tpu":
                        # Release exactly what pick time charged (logged at
                        # submit; the fallback recomputation only covers a
                        # rid the log never saw, which shouldn't happen).
                        cost = charge_log.pop(
                            (slot, comp.rid),
                            request_cost_host(
                                comp.prompt_bytes, comp.output_tokens))
                        scheduler.complete(
                            np.asarray([slot], np.int32),
                            np.asarray([cost], np.float32),
                        )
            if pd and pending_decode:
                due = [x for x in pending_decode if x[0] <= clock]
                if due:
                    pending_decode = [
                        x for x in pending_decode if x[0] > clock]
                    for (_t, d_pod, prompt, decode, hint, lora, t0,
                         hit) in due:
                        rid = self.stubs[d_pod].submit(
                            prompt, decode_tokens=decode, lora=lora,
                            prefill_done=True)
                        decode_jobs[(d_pod, rid)] = (
                            t0, clock, float(len(prompt)), hint, hit)
            clock += dt
            if clock >= next_scrape:
                self._scrape_all(clock)
                next_scrape = clock + scrape_interval_s
                if kv_agg is not None:
                    kv_agg.flush()  # event latency ~ one scrape interval
            if trainer is not None and clock >= next_train:
                if (trainer.train(steps=5) is not None
                        and scheduler is not None
                        and scheduler.predictor_fn is not None):
                    # Same guard as the runner's train loop: only a cycle
                    # that binds the column takes params.
                    scheduler.set_predictor_params(trainer.params)
                    scheduler.gate_latency_column(trainer.confidence())
                next_train = clock + train_every_s
        if kv_agg is not None:
            # Drain in-flight events before the run is scored: event
            # correctness is only defined modulo propagation delay (one
            # scrape interval), and the final window's stored/removed
            # batches are still sitting in the aggregator when the clock
            # stops. Without this drain the index "claims" exactly the
            # chunks whose eviction events were pending at cutoff — under
            # hard churn (64-chunk caches) that read as ~25% stale
            # affinity when the steady-state answer is 0%.
            kv_agg.flush()

        # --- stats ---------------------------------------------------------
        if not completions:
            return RunStats(0, 0, float("inf"), float("inf"), 0, 0, 0)
        ttfts = np.asarray([c.ttft_s for c in completions])
        tokens = np.asarray([c.output_tokens for c in completions])
        ok = ttfts <= wl.ttft_slo_s
        return RunStats(
            goodput_tokens_per_s=float(tokens[ok].sum() / duration_s),
            throughput_tokens_per_s=float(tokens.sum() / duration_s),
            ttft_p50_s=float(np.percentile(ttfts, 50)),
            ttft_p99_s=float(np.percentile(ttfts, 99)),
            slo_attainment=float(ok.mean()),
            prefix_hit_rate=float(
                np.mean([c.hit_fraction for c in completions])
            ),
            completed=len(completions),
            shed=shed,
        )

    # ------------------------------------------------------------------ #

    def _schedule(
        self, policy, scheduler, prompts, decode_hints, loras, now, rr_counter
    ) -> tuple[list[int], Optional[list[int]]]:
        """-> (destination picks, prefill picks or None). In pd mode a -1
        pick means the dual pick rejected the row (dropped by the caller);
        classic mode applies a least-kv fallback instead."""
        n = len(prompts)
        if policy == "round-robin":
            return [(rr_counter + i) % self.n for i in range(n)], None
        if policy in ("least-kv", "least-kv-assumed"):
            # The reference default scorer: per request, pick the endpoint
            # with the most free KV cache (queue-depth tie-break), reading
            # the latest scraped metrics — per-request greedy, no batch
            # awareness (BASELINE configs[0]). The "-assumed" variant is
            # the ADVERSARIAL floor (VERDICT r3 #8): it additionally sees
            # its own in-flight placements between scrapes (persistent
            # per-pod counter, decremented on completion) — the strongest
            # per-request greedy baseline the reference design supports.
            kv = self.store._metrics[: self.n, C.Metric.KV_CACHE_UTIL].copy()
            queue = self.store._metrics[: self.n, C.Metric.QUEUE_DEPTH].copy()
            if policy == "least-kv-assumed":
                queue = queue + self._baseline_inflight[: self.n]
            picks = []
            for _ in range(n):
                score = (1.0 - kv) - 0.01 * queue
                p = int(np.argmax(score))
                picks.append(p)
                # emulate the reference's assumed-load bump between scrapes
                queue[p] += 1.0
            return picks, None
        if policy == "tpu":
            from gie_tpu_torch.sched.types import chunk_bucket_for

            hashes, counts = batch_chunk_hashes(prompts)
            hashes = hashes[:, :chunk_bucket_for(int(max(counts.max(), 1)))]
            lora_ids = np.asarray(
                [self.lora_reg.id_for(x) if x else -1 for x in loras], np.int32
            )
            # Host tensors: the scheduler uploads the wave to its device.
            reqs = RequestBatch(
                valid=torch.ones((n,), dtype=torch.bool),
                lora_id=torch.from_numpy(lora_ids),
                criticality=torch.full((n,), int(C.Criticality.STANDARD),
                                       dtype=torch.int32),
                prompt_len=torch.tensor([float(len(p)) for p in prompts],
                                        dtype=torch.float32),
                decode_len=torch.from_numpy(
                    np.asarray(decode_hints, np.float32)),
                chunk_hashes=torch.from_numpy(
                    np.asarray(hashes, np.uint32).astype(np.int64)),
                n_chunks=torch.from_numpy(np.asarray(counts, np.int32)),
                subset_mask=torch.ones((n, C.M_MAX), dtype=torch.bool),
            )
            # Only the first self.n slots are valid endpoints.
            eps = self._endpoint_batch(now)
            result = scheduler.pick(reqs, eps)
            primary = np.asarray(result.indices[:, 0])
            if result.prefill is not None:
                # pd mode: NO fallback — a non-OK row was charged nothing
                # by the cycle and must not execute on a role it would
                # violate (a role-blind least-kv fallback would both break
                # the fleet model and desync charge/release accounting).
                # The run loop drops rows whose pick is -1 as rejected.
                return ([int(p) for p in primary],
                        [int(p) for p in np.asarray(result.prefill)])
            # Fallback for any non-OK rows: least-kv choice.
            bad = primary < 0
            if bad.any():
                kv = self.store._metrics[: self.n, C.Metric.KV_CACHE_UTIL]
                primary = primary.copy()
                primary[bad] = int(np.argmin(kv))
            return [int(p) for p in primary], None
        raise ValueError(f"unknown policy {policy!r}")
