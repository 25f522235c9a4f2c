#!/usr/bin/env python3
"""Drive gie_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero). On the
card every wave of phases 3-6, 8-10, 12, 13 and 20 is a replay of the scheduling
cycle captured as a CUDA graph for its shape (sched/graphs.py): the first
wave of a shape captures it inline, the runner's picker (phases 6-7)
captures its lattices on background threads, and each kernel's launch
count adds the launches a replay makes:
  1. device and build: the card, then the kernels built from ops/csrc/;
  2. kernels vs plain: each CUDA kernel against its plain PyTorch version
     at the main path's shapes (1024 requests x 256 and x 1024 endpoints,
     cold and warm duals) and at edge shapes (Sinkhorn N=1, 7, 8 and
     1024x64; blend-top-k M=40, 37, 2048 and [3, 9, 64]; and S = 7 at
     [7, 1024, 256] and [7, 1024, 1024], the blend with phase 18's latency
     column), with CUDA-event
     times at the main shapes (median of 5 runs of 20 back-to-back calls,
     after 5 warm-up calls; inputs warm in L2 as the cycle leaves them),
     and each kernel's device time (`device_ms`: the same calls queued
     behind a spin kernel, so the host's launch path is hidden);
     the Sinkhorn kernel must repeat bitwise, and the PyTorch dual-form
     solve the main path runs without use_pallas_sinkhorn is timed on its
     own line as `unflagged_ms`;
  3. the slice: Scheduler(tuned profile + use_pallas_sinkhorn) on the card
     over 5 carried waves of the north-star workload (1024 requests x 256
     endpoints, 16 shared system prompts, LoRA ids -1..11), with complete()
     feedback; each wave is replayed on a CPU Scheduler from the same state
     with the same Gumbel noise and the picks compared;
  4. the same for ProfileConfig(picker="topk", use_pallas_topk=True);
  5. the pick service, once per configuration of phases 3-4: a Datastore
     of 256 ready pods, a MetricsStore of north-star rows and
     BatchingTPUPicker(max_wait_s=0.002) over a Scheduler on the card.
     pick_async's handoff first (a 1024 x 256 wave queued behind a spin
     must return with its event pending); then 4 rounds of 1024
     concurrent pick() calls released by a barrier, served feedback for
     half of each round, every answer checked, the path's kernel counted
     against the waves dispatched; then 2 more rounds with a flight
     recorder installed, one record a pick, the completer's time per pick
     printed for both; then 32 sequential picks replayed through a CPU
     picker with the same noise, primaries equal;
  6. the ext-proc server, once per configuration of phases 3-4: the
     ExtProcServerRunner main() would build from its argv (the reference's
     defaults: resilience and obs on, --obs-sample-rate 0 so the flight
     recorder records and no tracer runs; --scheduler-config carrying the
     configuration, 4 acceptors) over a FakeCluster of 256 ready pods,
     each a VLLMStub on its own loopback address in a process of its own,
     scraped every 500 ms; 4 client processes (Envoy's part) send a
     warm-up round and 2 bursts of 1024 concurrent streams over 16
     channels (request headers,
     a JSON body of the mix, then response headers echoing the pick);
     every stream must get a ready primary, the path's kernel launches
     must equal the picker's waves, the ladder must hold FULL (no
     transition, no degraded or probe wave, gie_degraded_mode 0) with no
     open breaker, the recorder must take one record per stream,
     readiness and the "resilience" sub-service must be SERVING and
     /metrics must parse (a "server-resilience" line prints what the
     ladder and the board did); then 32 sequential streams replayed
     through a CPU runner, response bytes equal;
  7. `python -m gie_tpu_torch.runtime.main --demo` as a subprocess with
     the reference's defaults plus --obs-sample-rate 1.0 and
     --obs-otlp-endpoint at a loopback sink this script runs: readiness
     and the "resilience" sub-service SERVING, 64 golden streams answered,
     /debugz/picks holding their records and /debugz/trace one stream's
     trace, a trace_id exemplar on the OpenMetrics pick-latency histogram,
     OTLP spans at the sink, exit 0 within 10 s of SIGTERM;
  8. chaos on the card, once per configuration of phases 3-4: the phase-5
     picker stack with a ResilienceState at the default LadderConfig on a
     clock stepped 0.25 s per wave, 56 sequential one-request waves with
     device.dispatch=error:1.0 armed through the port's FaultInjector for
     waves 4-15: every pick answered with a ready primary, the ladder's
     descent and hysteretic climb back to FULL checked against
     LadderConfig, kernel launches equal to full plus probe waves, the
     degraded primaries equal to a CPU picker's under the same schedule,
     each degraded record naming its rung; prints the rung timeline and
     the pick time per rung;
  9. the warm lattice, once per configuration of phases 3-4: a Scheduler
     on the card warms every M bucket's N lattice with
     warm_lattice_async (1024 x 256's first) and joins it: capture time
     per key and per lattice, each graph's pool bytes, no inline capture
     after; then 20 waves of the north-star mix handed over as CPU
     tensors, each replay equal to the former eager path (the cycle
     launched op by op, as the port ran it before its cycle was
     captured) on a copy of the state it started from with the same
     noise (integer columns exact, floats within 1e-5); then 20 chained waves through each path: pick_async's
     host time, wall time per wave, and under torch.profiler the
     launching runtime calls (cudaGraphLaunch, kernels, copies) and device
     operations per wave and the device's idle share. Phases 6-7 also
     check the runner's lattice kick: its warm threads join with no
     failure (phase 6), the streams' lattice warms in full (phase 7),
     and debug_report()["warm_buckets"] is printed;
 10. the storm twin (gie_tpu_torch.storm) on the card, its waves replays
     of the tuned profile's cycle, which runs neither kernel (the
     reference's storm runs no hand-written kernel either):
     storm-noisy-neighbor and storm-search-smoke (its chaos rules armed
     after warm-up, as run_scenario arms them) under virtual time on the
     card, then on a CPU engine, both taking Gumbel noise from one seeded
     CPU generator: decision_fingerprint, schedule fingerprint, counts,
     breaker events, rung trace, per-tenant completions and sheds and the
     fault counts equal; storm-equivalence in real time on the card (no
     client 5xx, no shed, breaker order open, half_open, closed); and
     storm-equivalence at 250 pods (the M=256 bucket) under virtual time
     on the card and on the CPU, decisions equal. Each run prints its
     wall seconds, waves, graph captures at warm-up and after it, the
     kernels' launches (0), ok, shed and the rung trace's length;
 12. the pd dual pick on the card, once per configuration of phases 3-4
     with pd_disaggregation on: 5 carried waves of the north-star mix over
     256 endpoints whose roles come from a seed (3/8 prefill, 3/8 decode,
     1/4 both) through the captured cycle, each replayed on a CPU
     Scheduler from the same state with the same [2, N, M] noise
     (prefill, indices and status exact, scores within 1e-4 plus the
     lane tiebreak's slack), 2 Sinkhorn launches or 1 blend-top-k launch
     a wave; pick_async host time and wall time per wave beside the
     classic cycle's; then BatchingTPUPicker over 256 role-labelled pods:
     a burst of 1024 picks (x-gateway-prefill-endpoint on a
     prefill-capable pod, destination decode-capable, the load back to 0
     after served feedback) and 32 picks with deadlines inside the budget
     floor (no header, gie_pd_budget_singlehop_total counts each);
 13. KV-cache events on the card: the runner main() builds (topk +
     use_pallas_topk) with --kv-events-port over 256 stub pods whose
     event sinks POST JSON lines to its listener, one burst of 1024
     streams (all answered, no event dropped, events ingested); the
     listener's event rate; the fold's device time at 64, 512 and 4096
     hashes; the longest scheduler-lock hold that applied the queue; then
     a seeded event program (the 16 system prompts' chains, a
     10,000-hash batch, removals, an AllBlocksCleared, slot 300 growing
     the state to M=512) over HTTP to the card and into a CPU Scheduler's
     aggregator from the same state: exports bit-equal; then 5
     north-star waves on both, primaries equal (or within phase 3's
     gap), each event-only system prompt landing on an endpoint that
     reported it. Phases 12-13 print their wall seconds;
 14. the learned scorer, the random picker and checkpoints on the card:
     (a) Scheduler(tuned + use_pallas_sinkhorn, scorer="learned") with the
     committed policy artifact's exponents (config/policy/) and (b) the
     tuned profile with picker="random", each over phase 3's 5 carried
     waves with every wave replayed on a CPU Scheduler from the same state
     with the same noise (one Sinkhorn launch a learned wave, no kernel for
     the random picker), then a learned wave's pick_async host time and
     wall time beside the classic Sinkhorn wave's; (c) the runner main()
     builds from argv with --scorer learned --policy-artifact over 256
     stub pods, one burst of 1024 streams after a warm-up round, all
     answered, one Sinkhorn launch a wave, /debugz/policy naming the
     artifact's checksum and gie_policy_info carrying its weights; (d) the
     port's judge on storm-noisy-neighbor and the recorded trace fixture,
     on the card and on a CPU engine from one seeded CPU generator:
     verdict and both sides' decision fingerprints equal; (e) save_state
     on the card at M=256, restored into a fresh card Scheduler and a CPU
     one, both exports bit-equal to the state saved, and a checkpoint
     without the Sinkhorn duals restoring them at ones. Prints its wall
     seconds and its kernel launches;
 15. HA state replication, the file lease and the autoscale loop on the
     card: (a) a leader and a follower Scheduler (tuned +
     use_pallas_sinkhorn, M=256), each with a ReplicationManager on
     loopback over one LeaseFileElector lease: the leader runs phase 3's 5
     carried waves, the follower syncs (its export bit-equal to the
     leader's and to a CPU Scheduler restored from the decoded digest),
     the leader's lease is released, the follower promotes and runs 5 more
     waves, each replayed on that CPU Scheduler with the same noise; the
     digest's bytes, the export time on the card, the encode and decode
     times and the time from release to promotion; (b) two server
     processes built from the real flags (--leader-elect
     --leader-lease-path --replication-port, --autoscale-mode recommend,
     phase 6's scheduler config) over 256 stub pods: the leader answers a
     warm-up round and a burst of 1024 streams, its /metrics carries
     gie_autoscale_desired_replicas and _recommendations_total, the
     follower's "replication" sub-service reads SERVING with
     gie_replication_epoch_lag at most 1; the leader is SIGKILLed, the
     follower's readiness reads SERVING within the lease TTL plus 5 s,
     and it answers 1024 streams at FULL, one Sinkhorn launch a wave, each
     system prompt's streams landing mostly where the leader's picks put
     it (the share printed beside the share a cold table reaches by
     chance); (c) storm-capacity and storm-soak under virtual time on the
     card and on a CPU engine (phase 10's noise): decisions, the autoscale
     steps, the standby probes and the in-storm fault counts equal. Prints
     each part's wall seconds;
 16. multi-cluster federation on the card: (a) two server processes
     built from the real flags with phase 6's profile at queue_limit 16:
     west over 64 stub pods (--fed-cluster west --fed-port) and east over
     192 (--fed-peer west=...; its 192 slots and west's 64 imported ones
     fill M=256), east answering a warm-up round and one burst of 1024
     streams (1 in 16 CRITICAL, 1 in 16 SHEDDABLE) per state: local
     (every pick on east), spill (every east slot's scraped queue at the
     limit: non-CRITICAL picks on west, CRITICAL on east,
     gie_federation_spill_total equal to the spilled count, a
     gie.federation span at the OTLP sink), prefix (west's published hot
     keys folded against every west slot of east's device table; spilled
     sessions landing on the west pods their first spill put them on, the
     share printed beside chance), drain (every pick on west), partition
     (west SIGKILLed: east local-only within local_only_after_s plus the
     long-poll window, gie_federation_local_only 1, no pick on west, sheds
     only in the sheddable band) and heal (west restarted with a greater
     era: installed and readmitted); one spilled wave captured in east's
     process replayed on a CPU Scheduler with the same state and noise;
     no inline capture after the warm-up round, one Sinkhorn launch a
     wave; (b) storm-fed-spill, -drain and -partition under virtual time
     on the card and on a CPU engine (phase 10's noise): decisions and
     the federation blocks equal. Prints each state's streams/s and the
     spill, local-only and readmission times;
 17. the fleet picker on the card, in both kernel configurations of
     phases 3-4: (a) FleetPicker(topk 4, cell_cap 256) over phase 3's 5
     carried waves at 1024 endpoints (the top-K covers the 4 cells)
     against the dense Scheduler with the same seed: picks and status
     equal, scores and the float state within 1e-5 (bitwise waves
     counted), the prefix table exact, one kernel launch a wave; (b)
     sketch mode at 65,536 endpoints for 5 carried waves and 262,144 for
     2 (bench.py's fleet-sweep traffic, N=1024, 256 cells of 256 and
     1024 cells): the lattice warmed first and no inline capture after,
     each wave replayed on a CPU FleetPicker from the same state with the
     same noise (the coarse selection and candidate cells exact,
     primaries as phase 3 compares them, the cell-grain table equal where
     they agree), one kernel launch a wave; pick_async's host time, wall
     time per wave beside a dense 1024 x 1024 wave's, the bytes a wave
     copies up and the graphs' pool bytes; (c) the runner main() builds
     with --fleet-topk 2 --fleet-cell-cap 64 and phase 6's profile over
     256 stub pods, a warm-up round and a burst of 1024 streams, all
     answered, one Sinkhorn launch a wave, /debugz/fleet in exact mode
     over 4 cells with its top-K histogram summing to the streams, every
     flight record carrying fleet provenance; (d) storm-fleet under
     virtual time on the card and on a CPU engine (phase 10's noise):
     decisions, counts and the fleet and federation blocks equal, and
     the card's decisions equal to the same storm re-run with the dense
     Scheduler. Prints each part's wall seconds;
 18. the latency predictor on the card: (a) the MLP's forward,
     predictor_score_fn at 1024 x 256 and 1024 x 1024 and one AdamW step
     against the CPU port from the same params and batch (rtol 1e-2 for
     the column, the step's loss within 1e-3 and its params within
     2 * lr), the column's device time beside its bound; (b) in both kernel
     configurations of phases 3-4, at 1024 x 256 and 1024 x 1024, the
     lattice warmed, then 5 carried waves through the captured cycle with
     the latency column at weight 1.0 (S = 7 on the blend-top-k path),
     each replayed on a CPU Scheduler from the same state with the same
     noise and the card's column as a fixed column (statuses exact,
     primaries as phase 3 compares them, exact rows counted), one kernel
     launch a wave, no capture after the warm, set_predictor_params
     between waves 2 and 3 changing the next replay's column without a
     capture; pick_async's host time, wall time per wave and graph pool
     bytes beside the same waves without the column; (c) the trained TPOT
     head steering every pd decode pick to the fast slot; (d) the runner
     main() builds with --enable-predictor over 256 stub pods whose
     clients pace their answers per pod (a quarter 4x slower) and send SSE
     bodies, one stream in four with an SLO header: every stream answered
     or SLO-shed with 429, the train loop run, the column phased in, no
     capture after the warm-up, the load back to 0, the share of picks on
     slow pods per round, an autoscale probe reading, and a restart
     resuming the checkpoint's confidence; (e) the predictor section of a
     digest installed bit-equal between two ReplicationManagers with
     trainers on the card; (f) the simulator's online-training scenario
     with the predictor on the card (loss < 1.0, goodput above 1.2x
     least-kv's). Prints each part's wall seconds;
 19. the kube slice on the card: tests/fakeapi.py's apiserver in this
     process holding the pool (targetPorts: the stub fleet's port,
     endpointPickerRef: a Service that exists), its Gateway, a Deployment
     and M ready pods on the stub pods' addresses, each watch ended after
     2 s; (a) `main --kube --kubeconfig --publish-status-parents gw
     --leader-elect --scheduler-config <tuned + use_pallas_sinkhorn>`
     with --autoscale-mode apply as a process of its own (kube_main: a
     reporter beside main() reads its datastore): all M pods in its
     datastore from the watch alone, the Lease naming it, readiness
     SERVING, a status patch with Accepted and ResolvedRefs True for gw;
     (b) phase 6's client processes: a warm-up round and a burst of 1024
     streams all answered with pods of the pool and phase 6's
     server-round readings; 32 pods set not-Ready and 32 deleted, the
     time until the datastore drops them, a burst with no pick on them;
     the event log compacted around their return, so the watches get 410
     Gone and relist, the time until the datastore equals the
     apiserver's pods again, and a burst; (c) the Deployment's
     spec.replicas SSA-patched from 1 into [2, 8], the rest of its spec
     kept; SIGTERM, exit 0, the Lease released, one Sinkhorn launch a
     wave; then the same main with topk + use_pallas_topk: bring-up, a
     warm-up round and a burst, one blend-top-k launch a wave; (d) the
     port's conformance suite (gie_tpu_torch/conformance) in "rr" mode
     and in "tpu" mode with the Scheduler on the card under
     ProfileConfig(picker="sinkhorn", use_pallas_sinkhorn=True) and
     ProfileConfig(use_pallas_topk=True): every case passed, one kernel
     launch a wave; the routing case on the card and on a CPU Scheduler
     with the same Gumbel draws, every response equal; (e) both kernels'
     launches of the phase. Prints its wall seconds;
 20. the multi-device slice on the card: (a) 8 mesh positions on one card
     (`make_mesh(devices=[dev] * 8)`) at (dp, tp) = (4, 2), (8, 1) and
     (1, 8), at 1024 x 256 and 1024 x 1024, for the tuned Sinkhorn profile
     (its solve on the grouped path, as a mesh runs it), topk +
     use_pallas_topk and the random picker: 2 carried waves through
     Scheduler(mesh=), each a replay of its captured sharded cycle,
     against the unmeshed Scheduler with the same seed: indices,
     statuses, the Sinkhorn duals and the prefix keys, words and ages
     bit-equal, the load within 1e-6, the blend-top-k kernel launched
     once per dp shard a wave; the shard shapes and each wave's wall
     time beside the unmeshed one's; (b) Scheduler(mesh=make_mesh(1)),
     tuned profile, its lattice warmed: picks equal to the unmeshed
     Scheduler's, no inline capture, one cudaGraphLaunch a wave under the
     profiler, wall time and device operations a wave beside the
     unmeshed one's; (c) a FleetPicker given a mesh (kept as its
     deploy_mesh) launching the Sinkhorn kernel once a wave, picks equal
     to an unmeshed FleetPicker's; (d) the conformance suite in
     "tpu-mesh" (every card, tp 1) with the blend-top-k profile: every
     case passed, one launch per dp shard a wave; (e) sharded_train_step
     over 8 positions against make_train_step's single step (loss within
     rtol 1e-4, gradients within four bf16 steps of their largest
     element), then multihost_train_step in two processes on the card
     (gloo): both print one loss, within rtol 1e-4 of one process's step
     on the concatenated rows; (f) the server bursts of phase 6 through
     `--mesh-devices 2`, only where the machine shows two cards, else one
     line saying why it did not run. Prints its wall seconds;
 21. the cost model and the lint on the card: (a) utils/costmodel.py's
     count of one eager scheduling cycle (the north-star fixture) on the
     card for ProfileConfig(), picker="sinkhorn", the tuned profile, tuned
     + use_pallas_sinkhorn and topk + use_pallas_topk at 1024 x 256 and
     1024 x 1024, held to the CPU's count of the same cycle: bytes, flops
     and operations equal op by op, else the differing ops are named and
     the phase fails; each kernel configuration launches its kernel once a
     cycle; (b) for tuned + use_pallas_sinkhorn, topk + use_pallas_topk
     and the tuned profile at 1024 x 256, the counted bytes over 3.35
     TB/s beside the captured wave's device busy time and device
     operations under the profiler (phase 9's reading): a gauge, not a
     gate; (c) lint.dynamic's LockTracker on the CUDA Scheduler's _lock,
     _warm_lock and _queue_lock and the picker's _cond, _inflight_cv and
     _degraded_lock of a warmed pick service (tuned + use_pallas_sinkhorn):
     KV events queued from handler threads and evictions beside bursts of
     live waves, no rank inversion, the _lock -> _queue_lock nesting
     observed, the queue drained; (d) `python -m gie_tpu_torch.lint` exits
     0 on this machine. Prints its wall seconds;
 11. the `kernels` line: launches on the main path (phases 3-6, 8, 9, 12,
     13, 14, 15, 16, 17, 18, 19, 20 and 21, replays counted; phase 15's
     promoted server, phase 16's east and phase 19's servers report their
     own), error, times, bound.
Then the card's name and power limit (nvidia-smi), and as the last line
{"ok": true, "device": {...}}. Every listener the script starts takes its
port from free_port(), which draws below Linux's ephemeral range, so no
bind(0) or outgoing connection can take it before the listener binds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

# Device peaks for the bound (NVIDIA H100 SXM data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

N, M = 1024, 256
WAVES = 5
BASE = b"SYSTEM: You are a helpful assistant specialised in task %d. "
ROUNDS, PARITY_PICKS = 4, 32
RECORDER_ROUNDS = 2        # phase 5's extra bursts with a flight recorder
ADAPTERS = ["adapter-%d" % k for k in range(12)]
SPIN = 10_000_000          # torch.cuda._sleep cycles: ~5 ms on an H100
ROLE_NAMES = ("both", "prefill", "decode")   # by constants.Role value


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def same_export(got: dict, want: dict, what: str) -> None:
    """Two export_state dicts hold the same arrays, bit for bit."""
    differ = [k for k in want if k not in got or got[k].dtype != want[k].dtype
              or got[k].shape != want[k].shape
              or got[k].tobytes() != want[k].tobytes()]
    check(set(got) == set(want) and not differ,
          f"{what}: the export differs in {differ or sorted(set(got) ^ set(want))}")


def cuda_ms(fn, reps: int = 20, trials: int = 5, warmup: int = 5) -> float:
    """Time of one call of `fn` in milliseconds: CUDA events around `reps`
    back-to-back calls, divided by `reps`; the median of `trials` such
    runs, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def device_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Device time of one call of `fn`: cuda_ms's event pair, queued behind
    a spin kernel (~5 ms) that outlasts the host's launch path for all
    `reps` calls, so the events time the card's work back to back and not
    the host's; the median of `trials` such runs, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(trials):
        torch.cuda._sleep(10_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sinkhorn_inputs(n, m, seed, dev, zero_row=False):
    """A masked Gibbs kernel, caps from live-looking endpoints, warm duals;
    `zero_row` empties row min(3, n - 1) (a request with no candidates)."""
    from gie_tpu_torch.sched.sinkhorn import capacities
    from gie_tpu_torch.utils.testing import make_endpoints

    rng = np.random.default_rng(seed)
    live = min(m, 200)
    eps = make_endpoints(live, queue=rng.integers(0, 50, live).tolist(),
                         kv=rng.uniform(0, 0.95, live).tolist(), m_slots=m,
                         device=dev)
    cap = capacities(eps, torch.tensor(float(n), device=dev),
                     queue_limit=128.0).contiguous()
    k = np.where(rng.uniform(size=(n, m)) < 0.8,
                 np.exp((rng.uniform(size=(n, m)) - 1.0) / 0.02), 0.0)
    k[:, live:] = 0.0
    if zero_row:
        k[min(3, n - 1)] = 0.0
    k = torch.from_numpy(k.astype(np.float32)).to(dev)
    warm = torch.from_numpy(rng.uniform(0.05, 1.0, m).astype(np.float32)).to(dev)
    return k, cap, warm


def topk_inputs(s, n, m, seed, dev):
    """Uniform scorer columns with a row of exact ties (4), a fully masked
    row (5) and a row with fewer candidates than k (6)."""
    rng = np.random.default_rng(seed)
    stacked = rng.uniform(size=(s, n, m)).astype(np.float32)
    mask = rng.uniform(size=(n, m)) < 0.7
    if n > 6:
        stacked[:, 4, :] = 0.5
        mask[5] = False
        mask[6] = False
        mask[6, [3, m - 1]] = True
    wvec = torch.tensor([2.0, 1.0, 1.5, 4.0, 8.0, 1.0, 1.0][:s], device=dev)
    return (torch.from_numpy(stacked).to(dev), wvec,
            torch.from_numpy(mask).to(dev))


def check_sinkhorn(n, m, dev) -> float:
    """The Sinkhorn kernel against its plain version at [n, m], cold and
    warm (edge shapes of more than 4 rows with a zero row); two runs must
    be bitwise identical. -> max abs error."""
    from gie_tpu_torch.ops.fused_sinkhorn import (
        fused_sinkhorn_plan, fused_sinkhorn_plan_reference)

    edge = (n, m) not in ((N, M), (N, 1024))
    k, cap, warm = sinkhorn_inputs(n, m, seed=n + m, dev=dev,
                                   zero_row=edge and n > 4)
    errs = []
    for start, v_init in (("cold", torch.ones_like(warm)), ("warm", warm)):
        plan, v = fused_sinkhorn_plan(k, cap, v_init)
        again, v_again = fused_sinkhorn_plan(k, cap, v_init)
        plan_ref, v_ref = fused_sinkhorn_plan_reference(k, cap, v_init)
        torch.cuda.synchronize()
        check(torch.equal(plan, again) and torch.equal(v, v_again),
              f"fused_sinkhorn_plan {n}x{m} {start}: two runs differ")
        check(bool(torch.isfinite(plan).all()), "sinkhorn plan not finite")
        err = max(float((plan - plan_ref).abs().max()),
                  float((v - v_ref).abs().max()))
        check(err <= 1e-5, f"fused_sinkhorn_plan {n}x{m} {start}: "
                           f"max abs err {err} > 1e-5")
        errs.append(err)
    return max(errs)


def check_topk(s, n, m, dev) -> float:
    """The blend-top-k kernel against its plain version: indices equal,
    values within 1e-5. -> max abs error."""
    from gie_tpu_torch.ops.fused_topk import (
        fused_blend_topk, fused_blend_topk_reference)

    stacked, wvec, mask = topk_inputs(s, n, m, seed=m, dev=dev)
    vals, idx = fused_blend_topk(stacked, wvec, mask, k=4)
    v_ref, i_ref = fused_blend_topk_reference(stacked, wvec, mask, k=4)
    torch.cuda.synchronize()
    check(torch.equal(idx, i_ref), f"fused_blend_topk {[s, n, m]}: indices "
                                   "differ from the plain version")
    err = float((vals - v_ref).abs().max())
    check(err <= 1e-5, f"fused_blend_topk {[s, n, m]}: max abs err {err}")
    return err


def phase_kernels(dev) -> dict:
    """Each kernel vs its plain version; returns the main-shape records."""
    from gie_tpu_torch.ops.fused_sinkhorn import (
        fused_sinkhorn_cost, fused_sinkhorn_plan,
        fused_sinkhorn_plan_reference, layout)
    from gie_tpu_torch.ops.fused_topk import (
        fused_blend_topk, fused_blend_topk_cost, fused_blend_topk_reference)
    from gie_tpu_torch.sched.constants import NEG_SCORE
    from gie_tpu_torch.sched.sinkhorn import _solve_plan

    for n, m in ((1, 64), (7, 64), (8, 512), (N, 64)):
        emit({"phase": "kernel-edge", "name": "fused_sinkhorn_plan",
              "shape": [n, m], "max_abs_err": check_sinkhorn(n, m, dev)})
    for s, n, m in ((3, 9, 64), (6, N, 40), (4, 64, 37), (6, N, 2048)):
        emit({"phase": "kernel-edge", "name": "fused_blend_topk",
              "shape": [s, n, m], "max_abs_err": check_topk(s, n, m, dev)})

    records = {}
    for m in (M, 1024):
        err = check_sinkhorn(N, m, dev)
        k, cap, warm = sinkhorn_inputs(N, m, seed=N + m, dev=dev)
        emit({"phase": "unflagged", "name": "fused_sinkhorn_plan",
              "shape": [N, m],
              "unflagged_ms": cuda_ms(lambda: _solve_plan(k, cap, warm,
                                                          iters=8))})
        ms = cuda_ms(lambda: fused_sinkhorn_plan(k, cap, warm))
        dev_ms = device_ms(lambda: fused_sinkhorn_plan(k, cap, warm))
        plain_ms = cuda_ms(
            lambda: fused_sinkhorn_plan_reference(k, cap, warm))
        b_ms, b_by = bound(*fused_sinkhorn_cost(N, m))
        rec = {"name": "fused_sinkhorn_plan", "shape": [N, m],
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None,
               "layout": layout(dev, N, m)._asdict()}
        emit({"phase": "kernel", **rec})
        records.setdefault("fused_sinkhorn_plan", rec)

    # (6, N, M) and (6, N, 1024): the blend of phase 4's profile; (7, N, M)
    # and (7, N, 1024): the latency predictor's column joins it (phase 18).
    for s, m in ((6, M), (6, 1024), (7, M), (7, 1024)):
        err = check_topk(s, N, m, dev)
        stacked, wvec, mask = topk_inputs(s, N, m, seed=m, dev=dev)

        def library():
            total = torch.einsum("s,snm->nm", wvec, stacked) / wvec.sum()
            return torch.topk(torch.where(mask, total, NEG_SCORE), 4, dim=1)

        ms = cuda_ms(lambda: fused_blend_topk(stacked, wvec, mask))
        dev_ms = device_ms(lambda: fused_blend_topk(stacked, wvec, mask))
        plain_ms = cuda_ms(
            lambda: fused_blend_topk_reference(stacked, wvec, mask))
        library_ms = cuda_ms(library)
        b_ms, b_by = bound(*fused_blend_topk_cost(s, N, m))
        rec = {"name": "fused_blend_topk", "shape": [s, N, m],
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": library_ms}
        emit({"phase": "kernel", **rec})
        records.setdefault("fused_blend_topk", rec)
        if s == 7:
            records.setdefault("fused_blend_topk_s7", rec)
    return records


def workload(dev, m=M):
    """bench.py's north-star mix at `m` endpoints (its fleet sweep's
    traffic at a fleet width): the endpoints, and wave(w) -> wave w."""
    from gie_tpu_torch.sched.types import chunk_bucket_for
    from gie_tpu_torch.utils.testing import make_endpoints, make_requests

    rng = np.random.default_rng(0)
    eps = make_endpoints(m, queue=rng.integers(0, 50, m).tolist(),
                         kv=rng.uniform(0, 0.95, m).tolist(), max_lora=8,
                         m_slots=m, device=dev)

    def wave(w):
        prompts = [(BASE % ((i + w) % 16)) * 6 + b"user question %d" % (i + N * w)
                   for i in range(N)]
        reqs = make_requests(N, prompts=prompts,
                             lora_id=rng.integers(-1, 12, N).tolist(),
                             m_slots=m, device=dev)
        cb = chunk_bucket_for(int(reqs.n_chunks.max()))
        return reqs.replace(chunk_hashes=reqs.chunk_hashes[:, :cb].contiguous())

    return eps, wave


def compare_primaries(res, ref, valid, name, m=M) -> np.ndarray:
    """A card wave `res` against its CPU replay `ref`: statuses equal, OK
    primaries valid slots with finite scores, and primaries equal wherever
    the CPU's top-two gap is 1e-4 or more. -> the rows whose primaries
    differ."""
    check((res.status == ref.status).all(), f"{name}: statuses differ")
    ok = res.status == 0
    prim = res.indices[ok, 0]
    check(bool(((prim >= 0) & (prim < m)).all()) and bool(valid[prim].all()),
          f"{name}: an OK pick names an invalid slot")
    check(bool(np.isfinite(res.scores[ok, 0]).all()),
          f"{name}: non-finite score on an OK pick")
    differ = res.indices[:, 0] != ref.indices[:, 0]
    gap = ref.scores[:, 0] - ref.scores[:, 1]
    check(bool((gap[differ] < 1e-4).all()),
          f"{name}: a pick differs where the CPU top-two gap >= 1e-4")
    return differ


def complete_half(sched, res, reqs) -> None:
    """Completion feedback for the first half of a wave."""
    from gie_tpu_torch.sched.profile import request_cost_host

    costs = np.asarray([request_cost_host(float(p)) for p in
                        reqs.prompt_len[: N // 2].cpu().numpy()], np.float32)
    sched.complete(res.indices[: N // 2, 0], costs)


def phase_slice(dev, name, cfg, weights, kernels, own) -> dict:
    """Drive `cfg` on the card over carried waves; replay every wave on a
    CPU Scheduler from the same state with the same noise. Every kernel
    wrapper's launch count is set to 0 just before the drive and read just
    after; the path's own kernel (`own`) must launch once per wave, and
    with `own` None (phase 14's random picker) no kernel at all."""
    from gie_tpu_torch import convert
    from gie_tpu_torch.sched import Scheduler
    from gie_tpu_torch.sched.profile import gumbel_noise
    from gie_tpu_torch.sched.types import RequestBatch

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    drawn = []

    def noise(shape):
        drawn.append(gumbel_noise(shape, gen, dev))
        return drawn[-1]

    gpu = Scheduler(cfg, weights, device=dev, noise_source=noise)
    cpu = Scheduler(cfg, weights, device="cpu",
                    noise_source=lambda shape: drawn[-1].cpu())
    eps, wave = workload(dev)
    eps_cpu = convert.endpoints_from_numpy(convert.endpoints_to_numpy(eps),
                                           device="cpu")
    valid = eps.valid.cpu().numpy()
    waves = [wave(w) for w in range(WAVES)]
    cpu_waves = [RequestBatch(**{f.name: getattr(r, f.name).cpu()
                                 for f in dataclasses.fields(RequestBatch)})
                 for r in waves]

    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    wave_ms, agree, rows, allowed = [], 0, 0, 0
    for w, reqs in enumerate(waves):
        cpu.install_state(gpu.export_state())
        t0 = time.perf_counter()
        res = gpu.pick(reqs, eps)                  # materialize = synchronize
        wave_ms.append((time.perf_counter() - t0) * 1e3)
        if own is None:                # a path that runs neither kernel
            check(all(fn.launches == 0 for fn in kernels.values()),
                  f"{name}: a kernel launched on a path that has none")
        else:
            check(kernels[own].launches == w + 1,
                  f"{name}: {kernels[own].launches} kernel launches after "
                  f"{w + 1} waves")
        differ = compare_primaries(res, cpu.pick(cpu_waves[w], eps_cpu),
                                   valid, name)
        agree += int((~differ).sum())
        allowed += int(differ.sum())
        rows += len(differ)
        complete_half(gpu, res, reqs)
        ok = res.status == 0
        emit({"phase": "slice", "config": name, "wave": w,
              "ms": wave_ms[-1], "ok_rows": int(ok.sum()),
              "primary_agree": int((~differ).sum()), "rows": len(differ)})
    launches = {k: fn.launches for k, fn in kernels.items()}
    check(agree >= 0.999 * rows, f"{name}: primary picks agree on only "
                                 f"{agree}/{rows} rows")
    check(bool(np.isfinite(gpu.snapshot_assumed_load()).all()),
          f"{name}: assumed load not finite")
    summary = {"phase": "slice", "config": name, "waves": WAVES,
               "launches": launches, "primary_agree": agree, "rows": rows,
               "differ_within_gap": allowed,
               "wave_ms_median": statistics.median(wave_ms[1:])}
    emit(summary)
    return summary


def pick_stack(dev, cfg, weights, noise_source=None, resilience=None,
               roles=None, pd_budget_floor_s=0.0):
    """A Datastore of M ready pods in one pool, a MetricsStore of the
    north-star rows (queue 0-49, KV 0-0.95, three resident adapters of
    twelve, on a fixed clock) and a BatchingTPUPicker over a Scheduler on
    `dev`, with `resilience` (a ResilienceState) when given; `roles` (a
    Role per pod) labels pod i with ROLE_LABEL.
    -> (scheduler, datastore, picker)."""
    from gie_tpu_torch.api.types import ROLE_LABEL
    from gie_tpu_torch.datastore import Datastore
    from gie_tpu_torch.datastore.objects import EndpointPool, Pod
    from gie_tpu_torch.metricsio import MetricsStore
    from gie_tpu_torch.sched import Scheduler
    from gie_tpu_torch.sched.batching import BatchingTPUPicker
    from gie_tpu_torch.sched.constants import Metric
    from gie_tpu_torch.utils.lora import LoraRegistry

    sched = Scheduler(cfg, weights, device=dev, noise_source=noise_source)
    ms = MetricsStore(clock=lambda: 0.0)
    ds = Datastore(on_slot_reclaimed=lambda s: (sched.evict_endpoint(s),
                                                ms.remove(s)))
    ds.pool_set(EndpointPool({"app": "vllm"}, [8000], "default"))
    for i in range(M):
        labels = {"app": "vllm"}
        if roles is not None:
            labels[ROLE_LABEL] = ROLE_NAMES[int(roles[i])]
        ds.pod_update_or_add(Pod(name=f"vllm-{i}", labels=labels,
                                 ip=f"10.0.{i // 200}.{i % 200 + 1}"))
    registry = LoraRegistry()
    ids = [registry.id_for(a) for a in ADAPTERS]
    rng = np.random.default_rng(0)
    ms.update_rows([
        (ep.slot, {Metric.QUEUE_DEPTH: float(rng.integers(0, 50)),
                   Metric.KV_CACHE_UTIL: float(rng.uniform(0, 0.95)),
                   Metric.MAX_LORA: 8.0},
         [ids[j] for j in rng.choice(12, 3, replace=False)], ())
        for ep in ds.endpoints()], now=0.0)
    picker = BatchingTPUPicker(sched, ds, ms, lora_registry=registry,
                               max_wait_s=0.002, resilience=resilience,
                               pd_budget_floor_s=pd_budget_floor_s)
    return sched, ds, picker


def pick_requests(w, n):
    """Round w of the north-star mix as PickRequests."""
    from gie_tpu_torch.extproc.pick import PickRequest

    rng = np.random.default_rng(100 + w)
    lora = rng.integers(-1, 12, n)
    return [PickRequest(
        headers={},
        body=(BASE % ((i + w) % 16)) * 6 + b"user question %d" % (i + N * w),
        model="" if lora[i] < 0 else ADAPTERS[lora[i]]) for i in range(n)]


def burst(picker, cands, reqs):
    """len(reqs) concurrent pick() calls released together by a barrier.
    -> (results, per-pick latencies in s, wall time in s)."""
    n = len(reqs)
    barrier = threading.Barrier(n)
    out, errs = [None] * n, []
    t_in, t_out = [0.0] * n, [0.0] * n

    def one(i):
        barrier.wait(120)
        t_in[i] = time.perf_counter()
        try:
            out[i] = picker.pick(reqs[i], cands)
        except Exception as e:  # collected: a failed pick fails the phase
            errs.append(repr(e))
        t_out[i] = time.perf_counter()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    check(not any(t.is_alive() for t in threads), "picks still waiting")
    check(not errs, f"{len(errs)} picks failed, first: {errs[:1]}")
    lat = [b - a for a, b in zip(t_in, t_out)]
    return out, lat, max(t_out) - min(t_in)


def phase_picker(dev, name, cfg, weights, kernels, own) -> dict:
    """The pick service on the card for one configuration."""
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.sched.profile import gumbel_noise

    sched, ds, picker = pick_stack(dev, cfg, weights)
    try:
        # The handoff: a full wave from host tensors, queued behind ~100 ms
        # of device work, must come back with its event still pending.
        eps, wave = workload(torch.device("cpu"))
        reqs = wave(0)
        for _ in range(2):
            sched.pick(reqs, eps)
        torch.cuda.synchronize()
        torch.cuda._sleep(20 * SPIN)
        t0 = time.perf_counter()
        pending = sched.pick_async(reqs, eps)
        handoff_ms = (time.perf_counter() - t0) * 1e3
        queued = not pending.event.query()
        check(queued, f"{name}: pick_async returned after its wave ran "
                      f"({handoff_ms:.2f} ms of host time)")
        pending.materialize()

        cands = ds.pick_candidates()
        live = {ep.hostport for ep in ds.endpoints()}
        allowed = {ep.hostport for ep in cands}
        burst(picker, cands, pick_requests(-1, N))          # warm-up round
        fanout = time_completer(picker)
        torch.cuda.synchronize()
        own_metrics.reset()
        for fn in kernels.values():
            fn.launches = 0
        lat, wall, answered, released = [], 0.0, 0, []
        for w in range(ROUNDS):
            res, l, t = burst(picker, cands, pick_requests(w, N))
            lat += l
            wall += t
            for r in res:
                check(r is not None, f"{name}: a pick came back empty")
                check(r.endpoint in allowed and r.endpoint in live,
                      f"{name}: primary {r.endpoint} not a live candidate")
                ranked = [r.endpoint] + list(r.fallbacks)
                check(len(set(ranked)) == len(ranked),
                      f"{name}: repeated endpoint in {ranked}")
                answered += 1
            load = sched.snapshot_assumed_load()
            check(bool(np.isfinite(load).all()), f"{name}: load not finite")
            for r in res[::2]:
                picker.observe_served(r.endpoint, SimpleNamespace(
                    pick_result=r, resp_status=200,
                    picked_at=time.monotonic(), headers={}))
            after = sched.snapshot_assumed_load()
            check(bool(np.isfinite(after).all())
                  and float(after.sum()) < float(load.sum()),
                  f"{name}: served feedback did not release load")
            released.append([float(load.sum()), float(after.sum())])
        waves = int(own_metrics.PIPELINE_WAVES.value())
        launches = {k: fn.launches for k, fn in kernels.items()}
        check(answered == ROUNDS * N,
              f"{name}: {answered} of {ROUNDS * N} picks answered")
        check(launches[own] == waves,
              f"{name}: {launches[own]} kernel launches for {waves} waves")
        sizes = own_metrics.BATCH_SIZE.recent()
        hist = dict(zip([str(b) for b in own_metrics.BATCH_SIZE.buckets]
                        + ["+Inf"], own_metrics.BATCH_SIZE.bucket_counts()))
        summary = {
            "phase": "picker", "config": name, "endpoints": len(live),
            "pick_async_host_ms": handoff_ms, "queued_at_return": queued,
            "picks": answered, "answered": answered,
            "picks_per_s": answered / wall,
            "pick_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "pick_p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "waves": waves, "launches": launches,
            "wave_size_hist": {k: v for k, v in hist.items() if v},
            "wave_size_median": statistics.median(sizes),
            "host_assembly_ms_median": statistics.median(
                own_metrics.HOST_ASSEMBLY.recent()) * 1e3,
            "device_wait_ms_median": statistics.median(
                own_metrics.DEVICE_WAIT.recent()) * 1e3,
            **fanout_summary(fanout, answered),
            "load_sum_before_after_release": released,
        }
        # The completer's cost of the flight records: RECORDER_ROUNDS more
        # bursts with a recorder installed, against the rounds above.
        from gie_tpu_torch import obs
        from gie_tpu_torch.obs.recorder import FlightRecorder

        obs.install(recorder=FlightRecorder(512))
        recorded = time_completer(picker)
        try:
            for w in range(ROUNDS, ROUNDS + RECORDER_ROUNDS):
                res, _, _ = burst(picker, cands, pick_requests(w, N))
                check(all(r is not None for r in res),
                      f"{name}: a pick came back empty with the recorder on")
            records = newest_seq(obs.RECORDER) + 1
        finally:
            obs.uninstall()
        check(records == RECORDER_ROUNDS * N,
              f"{name}: {records} flight records for "
              f"{RECORDER_ROUNDS * N} picks")
        summary["recorder_on"] = fanout_summary(recorded,
                                                RECORDER_ROUNDS * N)
    finally:
        picker.close()

    # Parity: sequential picks through a card picker and a CPU picker,
    # each wave's noise drawn on the card and replayed to the CPU.
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    drawn = []

    def noise(shape):
        drawn.append(gumbel_noise(shape, gen, dev))
        return drawn[-1]

    stacks = [pick_stack(dev, cfg, weights, noise),
              pick_stack(torch.device("cpu"), cfg, weights,
                         lambda shape: drawn[-1].cpu())]
    try:
        equal = 0
        for i in range(PARITY_PICKS):
            got = [st[2].pick(pick_requests(50 + i, 1)[0],
                              st[1].pick_candidates()) for st in stacks]
            equal += got[0].endpoint == got[1].endpoint
    finally:
        for st in stacks:
            st[2].close()
    check(equal == PARITY_PICKS, f"{name}: {equal} of {PARITY_PICKS} "
                                 "sequential primaries equal the CPU replay")
    summary["parity_primary_equal"] = equal
    summary["parity_picks"] = PARITY_PICKS
    emit(summary)
    return summary

# -- phase 8: chaos on the card ----------------------------------------------

CHAOS_WAVES = 56
CHAOS_FAULT = (4, 16)      # waves dispatched under device.dispatch=error:1.0
CHAOS_STEP_S = 0.25        # the ladder's clock advances this much per wave
RUNG_LABELS = ("full", "cached", "round_robin", "static")


def time_completer(picker) -> list:
    """Wrap `picker`'s per-wave completer so that each call appends its
    wall time (s) to the returned list: the completer's time has no
    metric of its own."""
    inner = picker._complete_wave
    seconds = []

    def timed(wave):
        t0 = time.perf_counter()
        inner(wave)
        seconds.append(time.perf_counter() - t0)

    picker._complete_wave = timed
    return seconds


def degraded_picks() -> float:
    """gie_degraded_picks_total summed over its rungs."""
    from gie_tpu_torch.runtime import metrics as own_metrics

    return sum(own_metrics.DEGRADED_PICKS.value(r)
               for r in RUNG_LABELS[1:])


def chaos_run(dev, cfg, weights, noise_source) -> dict:
    """CHAOS_WAVES sequential one-request waves through the phase-5 picker
    stack on `dev` with a ResilienceState at the default LadderConfig,
    its breakers and ladder on a clock stepped CHAOS_STEP_S per wave, and
    the port's FaultInjector failing every device dispatch of the waves
    in CHAOS_FAULT; a flight recorder is installed. -> per-wave timeline
    (rung before the wave, the rung its record names, primary, charged
    slot, pick time), ladder transitions and tallies."""
    from gie_tpu_torch import obs
    from gie_tpu_torch.obs.recorder import FlightRecorder
    from gie_tpu_torch.resilience import (
        BreakerBoard,
        DegradationLadder,
        LadderConfig,
        ResilienceState,
        faults,
    )

    clock = SimpleNamespace(t=0.0)

    def now():
        return clock.t

    rs = ResilienceState(board=BreakerBoard(clock=now),
                         ladder=DegradationLadder(LadderConfig(), clock=now))
    recorder = FlightRecorder(4 * CHAOS_WAVES)
    obs.install(recorder=recorder)
    sched, ds, picker = pick_stack(dev, cfg, weights, noise_source,
                                   resilience=rs)
    degraded0 = degraded_picks()
    live = {ep.hostport for ep in ds.endpoints()}
    waves, fired = [], 0
    try:
        for w in range(CHAOS_WAVES):
            if w == CHAOS_FAULT[0]:
                faults.install(faults.FaultInjector(
                    5, faults.parse_spec(["device.dispatch=error:1.0"])))
            elif w == CHAOS_FAULT[1]:
                fired = faults.installed().fired.get("device.dispatch", 0)
                faults.uninstall()
            before = int(rs.ladder.rung())
            t0 = time.perf_counter()
            res = picker.pick(pick_requests(200 + w, 1)[0],
                              ds.pick_candidates())
            pick_ms = (time.perf_counter() - t0) * 1e3
            rec = recorder.snapshot(1)[0]
            check(res.endpoint in live and rec["chosen"] == res.endpoint,
                  f"chaos wave {w}: primary {res.endpoint} is not a ready "
                  f"pod or not its record's ({rec.get('chosen')})")
            waves.append({"wave": w, "t": clock.t, "before": before,
                          "by": rec["rung"], "primary": res.endpoint,
                          "charged": res.charged_slot, "ms": pick_ms})
            clock.t += CHAOS_STEP_S
    finally:
        faults.uninstall()
        obs.uninstall()
        picker.close()
    return {"waves": waves, "transitions": list(rs.ladder.transitions),
            "end_rung": int(rs.ladder.rung()), "healthy": rs.healthy(),
            "fired": fired, "degraded_picks": degraded_picks() - degraded0,
            "cfg": rs.ladder.cfg}


def phase_chaos(dev, name, cfg, weights, kernels, own) -> dict:
    """Chaos on the card for one configuration (chaos_run), then the same
    fault schedule, rows and wave order through a CPU picker with the
    card's Gumbel draws replayed: every pick answered with a ready
    primary; the first failing wave answered degraded and the ladder
    descending after dispatch_error_streak failures; every climb only
    after min_dwell_s on the rung and recover_streak good probes, back
    to FULL; kernel launches equal to full plus probe waves; the degraded
    primaries equal the CPU picker's; each degraded record names its
    rung."""
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.sched.profile import gumbel_noise

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    drawn = []

    def noise(shape):
        drawn.append(gumbel_noise(shape, gen, dev))
        return drawn[-1]

    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    waves0 = own_metrics.PIPELINE_WAVES.value()
    card = chaos_run(dev, cfg, weights, noise)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    dispatched = int(own_metrics.PIPELINE_WAVES.value() - waves0)
    replay = list(drawn)
    cpu = chaos_run(torch.device("cpu"), cfg, weights,
                    lambda shape: replay.pop(0).cpu())

    lcfg, waves = card["cfg"], card["waves"]
    full = [w for w in waves if w["by"] == "full" and w["before"] == 0]
    probe = [w for w in waves if w["by"] == "full" and w["before"] > 0]
    degraded = [w for w in waves if w["by"] != "full"]
    check(launches[own] == len(full) + len(probe) == dispatched,
          f"{name}: {launches[own]} launches, {dispatched} dispatched waves, "
          f"{len(full)} full + {len(probe)} probe waves")
    check(len(degraded) == card["degraded_picks"],
          f"{name}: {len(degraded)} degraded records for "
          f"{card['degraded_picks']} degraded picks")
    check(all(w["charged"] == -1 for w in degraded),
          f"{name}: a degraded pick was charged")
    first = waves[CHAOS_FAULT[0]]
    check(first["by"] == "cached",
          f"{name}: the first failing wave was answered by {first['by']}")
    trans = card["transitions"]
    down_at = CHAOS_FAULT[0] + lcfg.dispatch_error_streak - 1
    check(bool(trans) and trans[0] == (waves[down_at]["t"], 1),
          f"{name}: first transition {trans[:1]}, expected CACHED at "
          f"wave {down_at}")
    for (t_prev, prev_rung), (t_up, rung) in zip(trans, trans[1:]):
        if rung >= prev_rung:
            continue                                 # a descent
        good = [w for w in probe if t_prev < w["t"] <= t_up]
        check(t_up - t_prev >= lcfg.min_dwell_s
              and len(good) >= lcfg.recover_streak,
              f"{name}: climbed to {rung} at t={t_up} after "
              f"{t_up - t_prev} s and {len(good)} good probes")
    check(card["end_rung"] == 0 and trans[-1][1] == 0 and card["healthy"],
          f"{name}: ended on rung {card['end_rung']}, healthy "
          f"{card['healthy']}")
    check(card["fired"] >= lcfg.dispatch_error_streak,
          f"{name}: the fault fired {card['fired']} times")
    for w in degraded:
        check(w["by"] in RUNG_LABELS[1:],
              f"{name}: wave {w['wave']} record names rung {w['by']}")
        if not CHAOS_FAULT[0] <= w["wave"] < CHAOS_FAULT[1]:
            check(w["by"] == RUNG_LABELS[w["before"]],
                  f"{name}: wave {w['wave']} on rung {w['before']} "
                  f"recorded {w['by']}")
    same = [a["primary"] == b["primary"] and a["by"] == b["by"]
            for a, b in zip(waves, cpu["waves"])]
    check(all(s for s, w in zip(same, waves) if w["by"] != "full"),
          f"{name}: degraded primaries differ from the CPU picker's")
    by_rung = {}
    for w in waves:
        key = "probe" if w in probe else w["by"]
        by_rung.setdefault(key, []).append(w["ms"])
    summary = {
        "phase": "chaos", "config": name, "waves": CHAOS_WAVES,
        "fault_waves": list(CHAOS_FAULT), "clock_step_s": CHAOS_STEP_S,
        "fault_fired": card["fired"],
        "timeline": [{"wave": next(w["wave"] for w in waves
                                   if w["t"] == t_), "t": t_,
                      "rung": RUNG_LABELS[r]} for t_, r in trans],
        "full_waves": len(full), "probe_waves": len(probe),
        "degraded_waves": len(degraded),
        "degraded_picks": card["degraded_picks"],
        "launches": launches, "dispatched_waves": dispatched,
        "degraded_equal_cpu": sum(s for s, w in zip(same, waves)
                                  if w["by"] != "full"),
        "full_equal_cpu": sum(s for s, w in zip(same, waves)
                              if w["by"] == "full"),
        "pick_ms_median_by_rung": {k: statistics.median(v)
                                   for k, v in sorted(by_rung.items())},
    }
    emit(summary)
    return summary


# -- phase 9: the warm lattice ---------------------------------------------

WARM_WAVES = 20
WARM_SEED = 9


def eager_wave(state, reqs, eps, cfg, weights, gen, dev):
    """A wave as the port ran it before its cycle was captured (its former
    pick_async): every input field up from pinned memory, padded on the
    card, the noise drawn from `gen`, the cycle launched op by op on
    `state`, the result rows copied down to pinned memory, an event after
    them. -> (pinned PickResult, event)."""
    from gie_tpu_torch.sched.profile import (
        _batch_to_device, _to_host_async, gumbel_noise, scheduling_cycle)
    from gie_tpu_torch.sched.types import PickResult, bucket_for, pad_requests

    n, m = int(reqs.valid.shape[0]), int(eps.valid.shape[0])
    bucket = bucket_for(n)
    reqs = pad_requests(_batch_to_device(reqs, dev), bucket)
    eps = _batch_to_device(eps, dev)
    gumbel = (gumbel_noise((bucket, m), gen, dev) if cfg.picker == "sinkhorn"
              else None)
    result, _ = scheduling_cycle(state, reqs, eps, weights, gumbel, cfg=cfg)
    host = PickResult(**{
        f.name: (None if getattr(result, f.name) is None
                 else _to_host_async(getattr(result, f.name)[:n]))
        for f in dataclasses.fields(PickResult)})
    event = torch.cuda.Event()
    event.record()
    return host, event


def same_picks(res, ref, what) -> None:
    """`res` (numpy) against `ref` (host tensors): integer columns exact,
    float columns within 1e-5 (the card tests' tolerance: the state update
    sums with atomics)."""
    check(np.array_equal(res.indices, ref.indices.numpy())
          and np.array_equal(res.status, ref.status.numpy()),
          f"{what}: indices or status differ from the eager cycle")
    for k in ("scores", "affinity"):
        a, b = getattr(res, k), getattr(ref, k)
        check((a is None) == (b is None) and (a is None or np.allclose(
            a, b.numpy(), atol=1e-5, rtol=0)),
              f"{what}: {k} differ from the eager cycle by more than 1e-5")


def run_waves(dispatch, waves) -> tuple:
    """`dispatch(reqs) -> (result, event)` over `waves`, each materialized
    before the next (as pick() does). -> (host ms of each dispatch, wall
    ms per wave, results)."""
    host, out = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for reqs in waves:
        t1 = time.perf_counter()
        res, event = dispatch(reqs)
        host.append((time.perf_counter() - t1) * 1e3)
        event.synchronize()
        out.append(res)
    wall = (time.perf_counter() - t0) * 1e3 / len(waves)
    return host, wall, out


# Runtime calls that put work on the card's queue.
LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaMemcpyAsync")


def profiled(dispatch, waves) -> dict:
    """The waves under torch.profiler: the launching runtime calls a wave
    makes (by name), the device operations it runs, device busy time, wall
    time and the device's idle share (1 - busy / wall), per wave."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall, _ = run_waves(dispatch, waves)
    rows = prof.key_averages()
    calls = {e.key: e.count / len(waves) for e in rows
             if e.key in LAUNCH_CALLS}
    device = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy = sum(float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))
               for e in device) / 1e3 / len(waves)
    return {"launch_calls_per_wave": sum(calls.values()),
            "launch_calls_by_name": calls,
            "device_ops_per_wave": sum(e.count for e in device) / len(waves),
            "device_busy_ms_per_wave": busy,
            "wall_ms_per_wave_profiled": wall,
            "device_idle_share": 1.0 - busy / wall}


def pool_bytes() -> dict:
    """{memory pool id: bytes of device memory it holds}."""
    out = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg["segment_pool_id"])
        out[pool] = out.get(pool, 0) + seg["total_size"]
    return out


def phase_warm(dev, name, cfg, weights, kernels, own) -> dict:
    """The warm lattice for one configuration: every M bucket's N lattice
    captured by warm_lattice_async (1024 x 256's first), capture time per
    key and per lattice, each graph's pool bytes, no inline capture after
    the joins; then WARM_WAVES waves of the north-star mix handed over as
    CPU tensors, each a replay against the former eager path on a copy of
    the state it started from (same inputs, same noise); then WARM_WAVES
    chained waves through each path, timed (pick_async's host time, wall
    time per wave) and profiled (launching calls and device operations
    per wave, device idle share). The path's kernel launches once a
    replay."""
    from gie_tpu_torch.sched import Scheduler
    from gie_tpu_torch.sched import constants as C
    from gie_tpu_torch.sched.graphs import H2D_COPIES
    from gie_tpu_torch.sched.profile import _copy_state

    eps, wave = workload(torch.device("cpu"))
    waves = [wave(w) for w in range(WARM_WAVES)]
    lanes = {int(r.chunk_hashes.shape[1]) for r in waves}
    check(len(lanes) == 1, f"{name}: the waves span chunk buckets {lanes}")
    lanes = lanes.pop()
    sched = Scheduler(cfg, weights, device=dev, seed=WARM_SEED)
    lattices = []
    for m in (M,) + tuple(b for b in C.M_BUCKETS if b != M):
        t0 = time.perf_counter()
        thread = sched.warm_lattice_async(m, lanes)
        thread.join(600)
        lattice_s = time.perf_counter() - t0
        check(not thread.is_alive() and not sched._warm_failures,
              f"{name}: the lattice at M={m} did not warm: "
              f"{sched._warm_failures}")
        lattices.append((m, lattice_s))
    pools = pool_bytes()
    keys = {}
    for (n, m, c), graph in sorted(sched._graphs.items()):
        keys[f"{n}x{m}x{c}"] = {
            "capture_ms": graph.capture_s * 1e3,
            "pool_bytes": pools.get(tuple(graph.graph.pool()), 0)}
    check(len(keys) == len(C.N_BUCKETS) * len(C.M_BUCKETS),
          f"{name}: {len(keys)} graphs captured")
    inline = sched.warm_inline_compiles
    check(inline == 0, f"{name}: {inline} inline captures after the joins")
    emit({"phase": "warm-capture", "config": name, "chunk_lanes": lanes,
          "lattice_s": {str(m): s for m, s in lattices},
          "keys": keys, "pool_bytes_total": sum(
              k["pool_bytes"] for k in keys.values()),
          "warm_inline_compiles": inline})

    def replay(reqs):
        pending = sched.pick_async(reqs, eps)
        return pending, pending.event

    # Correctness: each replayed wave against the eager cycle on a copy of
    # the state it started from, with the same noise.
    gen = torch.Generator(device=dev)
    gen.manual_seed(WARM_SEED)
    for w, reqs in enumerate(waves):
        with sched._lock:
            start = _copy_state(sched._use_bucket(M))
        res = sched.pick(reqs, eps)
        ref, event = eager_wave(start, reqs, eps, cfg, sched.weights, gen, dev)
        event.synchronize()
        same_picks(res, ref, f"{name}: warm wave {w}")
    check(sched.warm_inline_compiles == 0,
          f"{name}: a warmed wave captured inline")

    # Timing: chained waves through the eager path (on a copy of the
    # state) and through pick_async, then the same under the profiler.
    state = _copy_state(sched.state)

    def eager(reqs):
        return eager_wave(state, reqs, eps, cfg, sched.weights, gen, dev)

    eager_host, eager_wall, _ = run_waves(eager, waves)
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    replay_host, replay_wall, _ = run_waves(replay, waves)
    launches = {k: fn.launches for k, fn in kernels.items()}
    check(launches[own] == WARM_WAVES,
          f"{name}: {launches[own]} kernel launches for {WARM_WAVES} replays")
    eager_prof = profiled(eager, waves)
    replay_prof = profiled(replay, waves)
    check(replay_prof["launch_calls_by_name"].get("cudaGraphLaunch") == 1,
          f"{name}: {replay_prof['launch_calls_by_name']} a replayed wave")
    summary = {
        "phase": "warm", "config": name, "waves": WARM_WAVES,
        "shape": [N, M, lanes], "h2d_copies_per_wave": H2D_COPIES,
        "replay_equal_eager": WARM_WAVES, "launches": launches,
        "eager": {"pick_async_host_ms_median": statistics.median(eager_host),
                  "wall_ms_per_wave": eager_wall, **eager_prof},
        "replay": {"pick_async_host_ms_median": statistics.median(
                       replay_host),
                   "pick_async_host_ms_max": max(replay_host),
                   "wall_ms_per_wave": replay_wall, **replay_prof},
    }
    emit(summary)
    return summary


# -- phase 10: the storm twin on the card ------------------------------------

STORM_SEED = 10            # the CPU generator both runs of a pair draw from
STORM_WIDE_PODS = 250      # the north star's width: M=256, stubs in one /24
# What a card run and its CPU run must share beside decision_fingerprint.
STORM_COUNTS = ("schedule_fingerprint", "ok", "shed", "shed_by_band",
                "client_5xx", "resets", "timeouts", "client_skipped",
                "breaker_events", "rung_trace")


def storm_noise(dev):
    """Gumbel noise drawn from a CPU generator seeded STORM_SEED, each draw
    moved to `dev`: a card run and its CPU run take the same draws."""
    from gie_tpu_torch.sched.profile import gumbel_noise

    gen = torch.Generator()
    gen.manual_seed(STORM_SEED)
    cpu = torch.device("cpu")
    return lambda shape: gumbel_noise(shape, gen, cpu).to(dev)


def storm_run(name, dev, kernels, *, virtual=True, pool=None) -> dict:
    """One shipped scenario through the port's twin on `dev`, as
    run_scenario runs it (engine_from_drive, warm-up, the scenario's chaos
    rules armed after it, run, uninstall, close), and what phase 10 prints
    of it: wall seconds, waves dispatched, inline captures after warm-up,
    the kernels' launches and the card."""
    from gie_tpu_torch.resilience import faults, scenarios
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.storm.engine import engine_from_drive

    scn = scenarios.load(name)
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.monotonic()
    engine = engine_from_drive(
        scn.drive["storm"], seed=scn.seed, pool=pool, name=name,
        virtual_time=virtual, device=dev, noise_source=storm_noise(dev))
    try:
        schedule = engine.program.compile()
        engine.warmup(schedule)
        warm = engine.scheduler.warm_inline_compiles
        waves0 = own_metrics.PIPELINE_WAVES.value()
        if scn.rules:
            scn.arm()
        try:
            result = engine.run(schedule=schedule, warmup=False)
        finally:
            faults.uninstall()
    finally:
        engine.close()
    score = result.scorecard
    rec = {
        "phase": "storm", "scenario": name, "device": str(dev),
        "virtual_time": score["virtual_time"],
        "pods": engine.pool.n_pods,
        "wall_s": time.monotonic() - t0,
        "waves": int(own_metrics.PIPELINE_WAVES.value() - waves0),
        "warm_captures": warm,
        "inline_captures_after_warmup":
            result.scheduler.warm_inline_compiles - warm,
        "launches": {k: fn.launches for k, fn in kernels.items()},
        "ok": score["ok"], "shed": score["shed"],
        "rung_trace_len": len(score["rung_trace"]),
        "max_rung": score["max_rung"],
        # Counted when the storm ended, before run() released the clock.
        "fault_fired": result.fault_fired_in_storm,
        "decision_fingerprint": score["decision_fingerprint"],
    }
    emit(rec)
    check(all(n == 0 for n in rec["launches"].values()),
          f"storm {name}: {rec['launches']} kernel launches from the tuned "
          "profile, which runs neither kernel")
    return {"rec": rec, "scorecard": score}


def same_storm(card_run, cpu_run, extra=()) -> None:
    """A card run and its CPU run reached the same decisions (and the
    same `extra` scorecard fields)."""
    a, b = card_run["scorecard"], cpu_run["scorecard"]
    name = a["name"]
    fields = ("decision_fingerprint",) + STORM_COUNTS + tuple(extra)
    diff = [f for f in fields if a[f] != b[f]]
    diff += [f"per_tenant.{t}" for t in sorted(set(a["per_tenant"])
                                               | set(b["per_tenant"]))
             if {k: a["per_tenant"].get(t, {}).get(k)
                 for k in ("completed", "shed")}
             != {k: b["per_tenant"].get(t, {}).get(k)
                 for k in ("completed", "shed")}]
    if card_run["rec"]["fault_fired"] != cpu_run["rec"]["fault_fired"]:
        diff.append("fault_fired")
    check(diff == [], f"storm {name}: the card and the CPU differ in {diff}: "
                      f"{[(f, a.get(f), b.get(f)) for f in diff[:3]]}")


def phase_storm(dev, kernels) -> dict:
    """Phase 10: storm-noisy-neighbor and storm-search-smoke under virtual
    time on the card and then on the CPU with the same noise, decisions
    equal; storm-equivalence in real time on the card (no client 5xx, no
    shed, breaker order open, half_open, closed); storm-equivalence at
    STORM_WIDE_PODS pods under virtual time on the card and on the CPU,
    decisions equal."""
    from gie_tpu_torch.storm import scorecard
    from gie_tpu_torch.storm.engine import PoolSpec

    cpu = torch.device("cpu")
    runs = {}
    for name in ("storm-noisy-neighbor", "storm-search-smoke"):
        on_card = storm_run(name, dev, kernels)
        same_storm(on_card, storm_run(name, cpu, kernels))
        runs[name] = on_card["rec"]
    real = storm_run("storm-equivalence", dev, kernels, virtual=False)
    score = real["scorecard"]
    scorecard.validate(score)
    check(score["client_5xx"] == 0 and score["shed"] == 0,
          f"storm real time: {score['client_5xx']} client 5xx, "
          f"{score['shed']} sheds; {score['client_5xx_detail']}")
    check([e[1] for e in score["breaker_events"]]
          == ["open", "half_open", "closed"],
          f"storm real time: breaker events {score['breaker_events']}")
    runs["storm-equivalence-real"] = real["rec"]
    wide = PoolSpec(n_pods=STORM_WIDE_PODS)
    on_card = storm_run("storm-equivalence", dev, kernels, pool=wide)
    same_storm(on_card, storm_run("storm-equivalence", cpu, kernels,
                                  pool=wide))
    runs[f"storm-equivalence-{STORM_WIDE_PODS}"] = on_card["rec"]
    summary = {"phase": "storm", "equal_to_cpu": [
        "storm-noisy-neighbor", "storm-search-smoke",
        f"storm-equivalence-{STORM_WIDE_PODS}"],
        "inline_captures_after_warmup": {
            k: r["inline_captures_after_warmup"] for k, r in runs.items()},
        "wall_s": {k: r["wall_s"] for k, r in runs.items()}}
    emit(summary)
    return summary


# -- phases 6-7: the ext-proc server -----------------------------------------

STREAM_ROUNDS, STREAMS_PER_ROUND, CHANNELS = 2, 1024, 16
CLIENTS = 4                    # client processes, CHANNELS // CLIENTS each
SCRAPE_INTERVAL_MS = 500       # one stub listener process serves 256 pods
EXTPROC_WORKERS = 4
REPLAY_STREAMS, MAIN_STREAMS = 32, 64
MAIN_EXIT_S = 10.0             # SIGTERM to exit of main --demo
STREAM_TIMEOUT_S = 300.0


def need_transport():
    """grpcio and protobuf, which the ext-proc transport needs."""
    try:
        import google.protobuf  # noqa: F401
        import grpc  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "the ext-proc server phases need the grpcio and protobuf "
            f"packages: {e}") from None


PORT_SEED = 0x9E11          # with the pid, seeds the generator free_port draws from
_port_rng = random.Random(PORT_SEED ^ os.getpid())
_ports_chosen: set = set()


def local_port_range() -> tuple:
    """Linux's ephemeral range (ip_local_port_range): every bind(0) and
    outgoing connect() on the host draws its port from it."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo, hi = (int(x) for x in f.read().split())
    except (OSError, ValueError):
        lo, hi = 32768, 60999                      # the kernel's default
    return lo, hi


def free_port() -> int:
    """A port for a listener this script starts: drawn from a seeded
    generator from above 1024 to below the ephemeral range, so no bind(0)
    or outgoing connection of another part of the run can take it between
    this choice and the listener's bind; checked to bind on the wildcard
    now; never the same port twice in one run."""
    import socket

    lo, _hi = local_port_range()
    for _ in range(10_000):
        port = _port_rng.randrange(1025, lo)
        if port in _ports_chosen:
            continue
        _ports_chosen.add(port)
        with socket.socket() as sock:
            try:
                sock.bind(("0.0.0.0", port))
            except OSError:
                continue                           # held by someone else
        return port
    raise RuntimeError(f"no free port in 1025..{lo - 1}")


def write_scheduler_config(cfg, weights, tmp) -> str:
    """`cfg` and `weights` as a --scheduler-config file (YAML; JSON is YAML)."""
    from gie_tpu_torch.sched.types import Weights

    weights = weights if weights is not None else Weights.default()
    path = f"{tmp}/scheduler-{cfg.picker}.yaml"
    with open(path, "w") as f:
        json.dump({**dataclasses.asdict(cfg),
                   "weights": dataclasses.asdict(weights)}, f)
    return path


def server_options(argv):
    """Options exactly as main() parses `argv`."""
    import argparse

    from gie_tpu_torch.runtime.options import Options

    parser = argparse.ArgumentParser()
    Options.add_flags(parser)
    opts = Options.from_args(parser.parse_args(argv))
    opts.validate()
    return opts


def fleet_ips(n: int, first: int = 0) -> list:
    """Pod i's own loopback address, for pods first .. first + n - 1."""
    return [f"127.1.{i // 200}.{i % 200 + 1}" for i in range(first, first + n)]


def stub_fleet_process(n: int, seed: int, ready, stop, events=None,
                       first: int = 0, floor=None) -> None:
    """The model-server fleet, in a process of its own: `n` VLLMStubs, pod
    i on fleet_ips(n)[i], all behind one port. One HTTP listener on the
    wildcard answers each pod's /metrics by the local address the scrape
    connected to. A ticker steps every stub's clock and submits a few
    arrivals each tick, so the queue and KV rows move. Puts the port on
    `ready`, serves until `stop` is set.

    `events` = (port queue, posting event, posted counter, publishers):
    once a KV-event listener's port arrives on the queue, the first
    `publishers` stubs get an event_sink (reporting as ip:fleet port), and
    while `posting` is set each tick POSTs the events they published as
    JSON lines to 127.0.0.1:<port>/events, adding their count to the
    counter; while it is clear they are discarded.

    `first` offsets the pods' addresses (fleet_ips(n, first)); `floor`, a
    shared double, keeps every stub's waiting queue at least that long
    while it is above 0 (arrivals topped up after each tick's step), so a
    server's scraped queue depth reads saturated on every slot."""
    import http.server
    import urllib.request

    from gie_tpu_torch.simulator import StubConfig, VLLMStub

    ips = fleet_ips(n, first)
    stubs = {ip: VLLMStub(StubConfig(), name=f"vllm-{i}")
             for i, ip in enumerate(ips)}
    lock = threading.Lock()
    rng = np.random.default_rng(seed)

    def arrive(stub, k):
        # Base-model work only: a stub whose max_lora slots are all taken
        # by other adapters is, by the LoRA filter, no candidate for a new
        # adapter, and every stream here must be routable.
        stub.submit((BASE % (k % 16)) * 6, 128.0)

    for stub in stubs.values():                      # standing load
        for k in range(int(rng.integers(0, 12))):
            arrive(stub, k)

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"                # keep-alive scrapes

        def do_GET(self):
            stub = stubs.get(self.connection.getsockname()[0])
            if stub is None:
                self.send_error(404)
                return
            with lock:
                body = stub.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    class Listener(http.server.ThreadingHTTPServer):
        # One listener stands in for n pods' own: its accept queue must
        # hold what theirs would (socketserver's default of 5 drops SYNs
        # under a burst of reconnects, and each drop costs a scrape the
        # 1 s SYN retransmit).
        request_queue_size = 4 * n

    httpd = Listener(("0.0.0.0", 0), Handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    ready.put(port)
    published, events_url = [], None
    tick = 0
    while not stop.wait(0.05):
        tick += 1
        if events is not None and events_url is None:
            try:
                events_url = (f"http://127.0.0.1:{events[0].get_nowait()}"
                              "/events")
            except Exception:       # queue.Empty: no listener yet
                pass
            else:
                for ip, stub in list(stubs.items())[:events[3]]:
                    stub.hostport = f"{ip}:{port}"
                    stub.event_sink = published.append
        with lock:
            for i, stub in enumerate(stubs.values()):
                if rng.uniform() < 0.05:
                    arrive(stub, tick + i)
                stub.step(0.05)
                k = 0
                while floor is not None and len(stub.queue) < floor.value:
                    arrive(stub, tick + i + k)
                    k += 1
        if published:
            batch, published[:] = list(published), []
            if events[1].is_set():
                body = "\n".join(json.dumps(e) for e in batch).encode()
                urllib.request.urlopen(urllib.request.Request(
                    events_url, data=body, method="POST"), timeout=30).read()
                with events[2].get_lock():
                    events[2].value += len(batch)
    httpd.shutdown()
    httpd.server_close()


def fleet_cluster(pool_name: str, ips, port: int):
    """A FakeCluster: one InferencePool on `port`, a ready pod per ip."""
    from gie_tpu_torch.api import types as api
    from gie_tpu_torch.controller import FakeCluster
    from gie_tpu_torch.datastore.objects import Pod

    cluster = FakeCluster()
    cluster.apply_pool(api.InferencePool(
        metadata=api.ObjectMeta(name=pool_name),
        spec=api.InferencePoolSpec(
            selector=api.LabelSelector(matchLabels={"app": "vllm"}),
            targetPorts=[api.Port(port)])))
    for i, ip in enumerate(ips):
        cluster.apply_pod(Pod(name=f"vllm-{i}", labels={"app": "vllm"},
                              ip=ip))
    return cluster


def stream_frames(w: int, i: int, band: str = "", extra=()):
    """Stream i of round w as Envoy sends it: request headers (the body
    follows; with `band`, the objective header names that criticality
    band; `extra` adds (name, bytes) headers), the JSON body of the
    north-star mix, and -> the response headers frame echoing the served
    endpoint. -> (headers, body, response_headers(hostport), prompt)."""
    from gie_tpu_torch.extproc import envoy, metadata as md, pb

    prompt = (BASE % ((i + w) % 16)) * 6 + b"user question %d" % (i + N * w)
    rng = np.random.default_rng(10_000 * (w + 2) + i)
    lora = int(rng.integers(-1, 12))
    body = json.dumps({
        "model": "base" if lora < 0 else ADAPTERS[lora],
        "prompt": prompt.decode(), "max_tokens": 128}).encode()
    hmap = pb.HeaderMap(headers=[
        pb.HeaderValue(key=":method", raw_value=b"POST"),
        pb.HeaderValue(key=":path", raw_value=b"/v1/completions"),
        pb.HeaderValue(key="content-type", raw_value=b"application/json"),
        pb.HeaderValue(key=md.FLOW_FAIRNESS_ID_KEY,
                       raw_value=b"tenant-%d" % (i % 4))]
        + ([pb.HeaderValue(key=md.OBJECTIVE_KEY, raw_value=band.encode())]
           if band else [])
        + [pb.HeaderValue(key=k, raw_value=v) for k, v in extra])
    headers = pb.ProcessingRequest(request_headers=pb.HttpHeaders(
        headers=hmap, end_of_stream=False)).SerializeToString()
    body_frame = pb.ProcessingRequest(request_body=pb.HttpBody(
        body=body, end_of_stream=True)).SerializeToString()

    def response_headers(hostport: str) -> bytes:
        req = pb.ProcessingRequest(response_headers=pb.HttpHeaders(
            headers=pb.HeaderMap(headers=[
                pb.HeaderValue(key=":status", raw_value=b"200")]),
            end_of_stream=False))
        req.metadata_context.filter_metadata[
            md.DESTINATION_ENDPOINT_NAMESPACE].CopyFrom(
                envoy.make_dynamic_metadata(
                    md.DESTINATION_ENDPOINT_NAMESPACE,
                    {md.DESTINATION_ENDPOINT_SERVED_KEY: hostport}
                ).fields[md.DESTINATION_ENDPOINT_NAMESPACE].struct_value)
        return req.SerializeToString()

    return headers, body_frame, response_headers, prompt


def destination(frame: bytes):
    """The x-gateway-destination-endpoint value of a request-headers
    response, or None."""
    from gie_tpu_torch.extproc import metadata as md, pb

    resp = pb.ProcessingResponse.FromString(frame)
    if resp.WhichOneof("response") != "request_headers":
        return None
    for opt in resp.request_headers.response.header_mutation.set_headers:
        if opt.header.key == md.DESTINATION_ENDPOINT_KEY:
            return opt.header.raw_value.decode()
    return None


def open_channels(port: int, n: int):
    import grpc

    from gie_tpu_torch.extproc.service import SERVICE_NAME

    chans = [grpc.insecure_channel(
        f"127.0.0.1:{port}", options=(("grpc.use_local_subchannel_pool", 1),))
        for _ in range(n)]
    methods = [c.stream_stream(f"/{SERVICE_NAME}/Process") for c in chans]
    return chans, methods


def one_stream(method, w, i, band: str = ""):
    """One Envoy-shaped exchange (stream_frames(w, i, band)). -> (the
    destination, or "<code>" for an immediate response such as a shed,
    seconds to the pick, seconds for the whole stream)."""
    import queue as _queue

    from gie_tpu_torch.extproc import pb

    headers, body, response_headers, _ = stream_frames(w, i, band)
    q = _queue.Queue()
    q.put(headers)
    q.put(body)
    t0 = time.perf_counter()
    # Generous: a burst queues behind 4 x 64 handler threads on a shared
    # host; the phase reports latency, and fails only on a lost stream.
    call = method(iter(q.get, None), timeout=STREAM_TIMEOUT_S)
    first = next(call)
    t_pick = time.perf_counter() - t0
    resp = pb.ProcessingResponse.FromString(first)
    if resp.WhichOneof("response") == "immediate_response":
        q.put(None)
        for _ in call:
            pass
        return (f"<{resp.immediate_response.status.code}>", t_pick,
                time.perf_counter() - t0)
    dest = destination(first)
    next(call)                                  # the request-body response
    if dest is not None:
        q.put(response_headers(dest.split(",")[0]))
        next(call)                              # the response-headers response
    q.put(None)
    for _ in call:
        pass
    return dest, t_pick, time.perf_counter() - t0


async def aio_stream(method, w, i, band: str = ""):
    """one_stream on grpc.aio (`method` a grpc.aio stream-stream
    callable): the same frames in the same order, the same result."""
    import grpc

    from gie_tpu_torch.extproc import pb

    headers, body, response_headers, _ = stream_frames(w, i, band)
    t0 = time.perf_counter()
    call = method(timeout=STREAM_TIMEOUT_S)
    await call.write(headers)
    await call.write(body)
    first = await call.read()
    t_pick = time.perf_counter() - t0
    if first is grpc.aio.EOF:
        raise RuntimeError(f"stream ended with no response: "
                           f"{await call.code()}")
    resp = pb.ProcessingResponse.FromString(first)
    dest = None
    if resp.WhichOneof("response") == "immediate_response":
        dest = f"<{resp.immediate_response.status.code}>"
    else:
        dest = destination(first)
        await call.read()                       # the request-body response
        if dest is not None:
            await call.write(response_headers(dest.split(",")[0]))
            await call.read()                   # the response-headers response
    await call.done_writing()
    while await call.read() is not grpc.aio.EOF:
        pass
    return dest, t_pick, time.perf_counter() - t0


def client_process(port: int, channels: int, rounds, share, total: int,
                   barrier, results, stream=None) -> None:
    """Envoy's side, in a process of its own: for each round w, wait on
    `barrier` with the other clients and the server's process, then open
    streams i = share, share + k, ... (< total) all at once over this
    process's channels. Puts (w, [(i, destination, pick s, stream s,
    error)], first start, last end, this process's CPU seconds in the
    round) on `results`. `stream` replaces aio_stream (same arguments and
    result).

    One asyncio loop drives every stream, as Envoy's event loop does: a
    thread per stream (and grpc's sync API adds one more to feed each
    stream's requests) put two thousand threads beside the server's on
    the host in each burst."""
    import asyncio

    import grpc

    from gie_tpu_torch.extproc.service import SERVICE_NAME

    stream = aio_stream if stream is None else stream
    mine = list(range(share, total, CLIENTS))

    async def one(method, w, i):
        t_in = time.monotonic()
        try:
            out = (i,) + await stream(method, w, i) + ("",)
        except Exception as e:
            out = (i, None, 0.0, 0.0, repr(e)[:300])
        return out, t_in, time.monotonic()

    async def drive():
        chans = [grpc.aio.insecure_channel(
            f"127.0.0.1:{port}",
            options=(("grpc.use_local_subchannel_pool", 1),))
            for _ in range(channels)]
        methods = [c.stream_stream(f"/{SERVICE_NAME}/Process") for c in chans]
        try:
            for w in rounds:
                await asyncio.to_thread(barrier.wait, 600)
                cpu0 = time.process_time()
                got = await asyncio.gather(*(
                    one(methods[j % len(methods)], w, i)
                    for j, i in enumerate(mine)))
                results.put((w, [g[0] for g in got], min(g[1] for g in got),
                             max(g[2] for g in got),
                             time.process_time() - cpu0))
        finally:
            for c in chans:
                await c.close()

    asyncio.run(drive())


def health_status(port: int, service: str) -> int:
    import grpc

    from gie_tpu_torch.extproc.pb import health_pb2

    with grpc.insecure_channel(f"127.0.0.1:{port}") as chan:
        check_rpc = chan.unary_unary(
            "/grpc.health.v1.Health/Check",
            request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb2.HealthCheckResponse.FromString)
        return check_rpc(health_pb2.HealthCheckRequest(service=service),
                         timeout=10).status


def check_exposition(port: int) -> dict:
    """GET /metrics; it must parse as Prometheus text (the port's own
    parser) and carry gie_build_info and the pick-latency histogram."""
    import urllib.request

    from gie_tpu_torch.metricsio.scrape import parse_sample_lines

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as resp:
        text = resp.read().decode()
    names = {s.name for s in parse_sample_lines(text)}
    for want in ("gie_build_info", "gie_pick_latency_seconds_bucket",
                 "gie_pick_latency_seconds_count"):
        check(want in names, f"/metrics lacks {want}")
    return {"samples": len(names), "bytes": len(text)}


class _MallInfo2(ctypes.Structure):
    _fields_ = [(name, ctypes.c_size_t) for name in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


def malloc_info() -> dict:
    """glibc's mallinfo2 over all arenas: heap bytes from sbrk/arena
    heaps, chunks and bytes mmapped on their own, bytes in use and free,
    and the top chunk a trim would release. {} where there is none."""
    try:
        fn = ctypes.CDLL(None).mallinfo2
    except (OSError, AttributeError):
        return {}
    fn.restype = _MallInfo2
    info = fn()
    return {f"malloc.{k}": getattr(info, k) for k in (
        "arena", "hblks", "hblkhd", "uordblks", "fordblks", "keepcost")}


_gc_clock = {"start": 0.0, "s": [0.0, 0.0, 0.0]}


def _gc_timer(phase: str, info: dict) -> None:
    """gc.callbacks hook: seconds the cyclic collector ran, by generation."""
    if phase == "start":
        _gc_clock["start"] = time.perf_counter()
    else:
        _gc_clock["s"][info["generation"]] += (
            time.perf_counter() - _gc_clock["start"])


def process_readings() -> dict:
    """What the server process holds at a round's edge: pinned host
    allocations (count, bytes, time), the device allocator's segments and
    allocations, the process's threads (Python's and the OS's), its
    memory mappings, glibc malloc's heap and mmapped chunks, its CPU
    seconds, and the cyclic collector's runs and seconds by generation
    (timed from the first reading on)."""
    import gc

    if _gc_timer not in gc.callbacks:
        gc.callbacks.append(_gc_timer)
    out = {"py_threads": threading.active_count(),
           "cpu_s": time.process_time()}
    for g, st in enumerate(gc.get_stats()):
        out[f"gc.gen{g}_collections"] = st["collections"]
        out[f"gc.gen{g}_s"] = _gc_clock["s"][g]
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Threads:"):
                    out["os_threads"] = int(line.split()[1])
    except OSError:
        out["os_threads"] = None
    host = getattr(torch.cuda, "host_memory_stats", None)
    if host is not None:
        for k, v in sorted(host().items()):
            if isinstance(v, (int, float)) and not k.endswith(".peak"):
                out[f"host.{k}"] = v
    try:
        with open("/proc/self/maps") as f:
            out["maps"] = sum(1 for _ in f)
    except OSError:
        out["maps"] = None
    out.update(malloc_info())
    dev_stats = torch.cuda.memory_stats()
    for k in ("segment.all.current", "allocation.all.current",
              "num_device_alloc", "num_device_free", "num_alloc_retries",
              "reserved_bytes.all.current"):
        out[f"device.{k}"] = dev_stats.get(k, 0)
    return out


def phase_server(dev, name, cfg, weights, kernels, own, tmp,
                 extra_argv=()) -> dict:
    """The ext-proc server on the card for one configuration: the runner
    main() would build (with `extra_argv` beside the phase's flags), over
    256 stub pods (a process of their own), under bursts of concurrent
    Envoy-shaped streams from CLIENTS client processes; then sequential
    streams replayed on a CPU runner."""
    need_transport()
    import gc
    import multiprocessing

    from gie_tpu_torch import obs
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.runtime.health import SERVING
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner

    # The server shares this process with the phases before it, whose heap
    # a server of its own would not hold: freeze that heap, so the
    # collector's full passes during the bursts walk only what the runner
    # and its streams allocate.
    gc.collect()
    gc.freeze()
    ctx = multiprocessing.get_context("spawn")
    stop, ready = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=stub_fleet_process, args=(M, 0, ready, stop),
                         daemon=True)]
    procs[0].start()
    runner = None
    try:
        fleet_port = ready.get(timeout=120)
        gport, hport, mport = free_port(), free_port(), free_port()
        argv = ["--insecure-serving",
                "--scheduler-config", write_scheduler_config(cfg, weights, tmp),
                "--pool-name", "smoke", "--grpc-port", str(gport),
                "--grpc-health-port", str(hport), "--metrics-port", str(mport),
                "--extproc-workers", str(EXTPROC_WORKERS),
                "--scrape-interval-ms", str(SCRAPE_INTERVAL_MS),
                *extra_argv]
        runner = ExtProcServerRunner(
            server_options(argv), fleet_cluster("smoke", fleet_ips(M),
                                                fleet_port))
        check(runner.scheduler.device.type == "cuda",
              f"{name}: the runner's scheduler is on {runner.scheduler.device}")
        rs = runner.resilience
        check(rs is not None and obs.RECORDER is not None
              and obs.TRACER is None,
              f"{name}: resilience {rs is not None}, recorder "
              f"{obs.RECORDER is not None}, tracer {obs.TRACER is not None}")
        runner.setup()
        runner.start()
        slots = [ep.slot for ep in runner.datastore.endpoints()]
        check(len(slots) == M, f"{name}: {len(slots)} of {M} pods ready")
        deadline = time.monotonic() + 60
        while True:                       # every pod scraped at least once
            _, ages = runner.metrics_store.pool_rows(slots)
            if bool(np.isfinite(ages).all()) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        check(bool(np.isfinite(ages).all()),
              f"{name}: {int((~np.isfinite(ages)).sum())} pods never scraped")
        check(health_status(hport, "readiness") == SERVING,
              f"{name}: readiness is not SERVING")

        rounds = [-1] + list(range(STREAM_ROUNDS))       # -1: warm-up
        barrier, results = ctx.Barrier(CLIENTS + 1), ctx.Queue()
        for k in range(CLIENTS):
            procs.append(ctx.Process(
                target=client_process,
                args=(runner.grpc_server.port, CHANNELS // CLIENTS, rounds, k,
                      STREAMS_PER_ROUND, barrier, results), daemon=True))
            procs[-1].start()
        live = {ep.hostport for ep in runner.datastore.endpoints()}
        picks, streams, walls, answered = [], [], [], 0
        for w in rounds:
            if w == 0:                    # the measured rounds start here
                # A device-wide synchronize while a capture runs fails
                # both: the warm-up round's lattice kick must be done.
                for t in runner.picker._warm_threads:
                    t.join(300)
                torch.cuda.synchronize()
                for fn in kernels.values():
                    fn.launches = 0
                waves0 = own_metrics.PIPELINE_WAVES.value()
                marks = {h: h.count() for h in (
                    own_metrics.BATCH_SIZE, own_metrics.HOST_ASSEMBLY,
                    own_metrics.DEVICE_WAIT, own_metrics.PICK_LATENCY)}
                accepts0 = [own_metrics.WORKER_ACCEPTS.value(k)
                            for k in range(EXTPROC_WORKERS)]
                transitions0 = len(rs.ladder.transitions)
                degraded0 = degraded_picks()
                fanout = time_completer(runner.picker)
                seq0 = newest_seq(obs.RECORDER)
            before = process_readings()
            transitions_before = len(rs.ladder.transitions)
            barrier.wait(600)
            got = [results.get(timeout=900) for _ in range(CLIENTS)]
            # Each round's edges, warm-up included: a stall is the round
            # whose ladder moved; the readings say what the process made.
            emit({"phase": "server-round", "config": name, "round": w,
                  "wall_s": max(g[3] for g in got) - min(g[2] for g in got),
                  "client_cpu_s": sum(g[4] for g in got),
                  "ladder_moves": len(rs.ladder.transitions)
                  - transitions_before,
                  "staleness_s": runner.scraper.staleness_seconds(),
                  "before": before, "after": process_readings()})
            check(all(g[0] == w for g in got), f"{name}: rounds out of step")
            outcomes = [o for g in got for o in g[1]]
            errs = [o[4] for o in outcomes if o[4]]
            check(not errs, f"{name}: {len(errs)} streams failed, first: "
                            f"{errs[:1]}")
            if w < 0:
                continue
            for _, dest, t_pick, t_stream, _ in outcomes:
                check(dest is not None,
                      f"{name}: a stream got no destination")
                ranked = dest.split(",")
                check(ranked[0] in live,
                      f"{name}: primary {ranked[0]} is not a ready pod")
                check(len(set(ranked)) == len(ranked),
                      f"{name}: repeated endpoint in {ranked}")
                picks.append(t_pick)
                streams.append(t_stream)
                answered += 1
            walls.append(max(g[3] for g in got) - min(g[2] for g in got))
        waves = int(own_metrics.PIPELINE_WAVES.value() - waves0)
        launches = {k: fn.launches for k, fn in kernels.items()}
        total = STREAM_ROUNDS * STREAMS_PER_ROUND
        transitions = rs.ladder.transitions[transitions0:]
        rungs = {}
        for rec in obs.RECORDER.snapshot():        # the ring's newest 512
            if rec["seq"] > seq0:
                rungs[rec["rung"]] = rungs.get(rec["rung"], 0) + 1
        ladder = {
            "transitions": [(t_, RUNG_LABELS[r]) for t_, r in transitions],
            "end_rung": RUNG_LABELS[int(rs.ladder.rung())],
            "gie_degraded_mode": own_metrics.DEGRADED_MODE.value(),
            "open_breakers": rs.board.open_count(),
            "breaker_states": rs.board.states(),
            "degraded_picks": degraded_picks() - degraded0,
            "dispatched_waves": waves,
            # A probe is a wave dispatched while the ladder is below FULL:
            # none when it never left FULL (else the check below fails).
            "probe_waves": 0 if not transitions else None,
            "records_appended": newest_seq(obs.RECORDER) - seq0,
            "ring_records_by_rung": rungs,
        }
        emit({"phase": "server-resilience", "config": name, **ladder})
        check(answered == total, f"{name}: {answered} of {total} answered")
        check(launches[own] == waves,
              f"{name}: {launches[own]} kernel launches for {waves} waves")
        check(not ladder["transitions"] and ladder["end_rung"] == "full"
              and ladder["degraded_picks"] == 0
              and set(rungs) == {"full"}
              and ladder["gie_degraded_mode"] == 0.0,
              f"{name}: the ladder left FULL with no fault injected: "
              f"{ladder}")
        check(ladder["open_breakers"] == 0,
              f"{name}: breakers open with no fault injected: "
              f"{ladder['breaker_states']}")
        check(ladder["records_appended"] == answered,
              f"{name}: {ladder['records_appended']} flight records for "
              f"{answered} streams")
        check(health_status(hport, "readiness") == SERVING,
              f"{name}: readiness is not SERVING after the bursts")
        check(health_status(hport, "resilience") == SERVING,
              f"{name}: the resilience sub-service is not SERVING after "
              "the bursts")
        exposition = check_exposition(mport)
        # The runner's lattice kick: its warm threads captured beside the
        # bursts; every one must end, with no failure.
        threads = list(runner.picker._warm_threads)
        for t in threads:
            t.join(300)
        report = runner.scheduler.debug_report()
        warm = {"warm_threads": len(threads),
                "warm_threads_joined": sum(not t.is_alive() for t in threads),
                "warm_buckets": report["warm_buckets"],
                "warm_inline_compiles": report["warm_inline_compiles"],
                "warm_failures": len(runner.scheduler._warm_failures)}
        emit({"phase": "server-warm", "config": name, **warm})
        check(len(threads) >= 1 and warm["warm_threads_joined"] == len(threads)
              and not warm["warm_failures"],
              f"{name}: the runner's warm threads: {warm}")
        recent = {h: observed_since(h, marks[h]) for h in marks}
        sizes = recent[own_metrics.BATCH_SIZE]
        queued = recent[own_metrics.PICK_LATENCY]
        hist = {}
        for b in sizes:
            hist[int(b)] = hist.get(int(b), 0) + 1
        summary = {
            "phase": "server", "config": name, "endpoints": len(live),
            "scrape_interval_ms": SCRAPE_INTERVAL_MS,
            "extproc_workers": EXTPROC_WORKERS, "channels": CHANNELS,
            "client_processes": CLIENTS,
            "streams": total, "answered": answered,
            "streams_per_s": answered / sum(walls),
            "round_wall_s": walls,
            "stream_p50_ms": float(np.percentile(streams, 50)) * 1e3,
            "stream_p99_ms": float(np.percentile(streams, 99)) * 1e3,
            "stream_max_ms": max(streams) * 1e3,
            "pick_p50_ms": float(np.percentile(picks, 50)) * 1e3,
            "pick_p99_ms": float(np.percentile(picks, 99)) * 1e3,
            # Enqueue to answer inside the picker (PICK_LATENCY): the rest
            # of a client's pick time is gRPC's queue for a handler thread.
            "picker_p50_ms": float(np.percentile(queued, 50)) * 1e3,
            "picker_p99_ms": float(np.percentile(queued, 99)) * 1e3,
            "picker_max_ms": max(queued) * 1e3,
            "worker_accepts": [
                int(own_metrics.WORKER_ACCEPTS.value(k) - accepts0[k])
                for k in range(EXTPROC_WORKERS)],
            "waves": waves, "launches": launches,
            "wave_size_hist": dict(sorted(hist.items())),
            "wave_size_max": int(max(sizes)),
            "wave_size_median": statistics.median(sizes),
            "host_assembly_ms_median": statistics.median(
                recent[own_metrics.HOST_ASSEMBLY]) * 1e3,
            "host_assembly_ms_max": max(
                recent[own_metrics.HOST_ASSEMBLY]) * 1e3,
            "device_wait_ms_median": statistics.median(
                recent[own_metrics.DEVICE_WAIT]) * 1e3,
            **fanout_summary(fanout, answered),
            "host_parsers": host_parsers(),
            "metrics": exposition,
            **ladder,
            **warm,
        }
        summary.update(replay_on_cpu(dev, runner, cfg, weights, fleet_port))
    finally:
        stop.set()
        if runner is not None:
            runner.stop()
        for proc in procs:
            proc.join(30)
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
        gc.unfreeze()
    emit(summary)
    return summary


def fanout_summary(s: list, picks: int) -> dict:
    """The completer's time per wave (materialize and fan-out, flight
    records included while a recorder is installed) from time_completer's
    list."""
    return {"fanout_waves": len(s),
            "fanout_ms_median": statistics.median(s) * 1e3 if s else None,
            "fanout_us_per_pick": sum(s) / picks * 1e6 if picks else None}


def newest_seq(recorder) -> int:
    """The sequence number of `recorder`'s newest record (-1 when empty):
    the count of records ever appended, less one, past the ring's size."""
    newest = recorder.snapshot(1)
    return newest[0]["seq"] if newest else -1


def observed_since(hist, mark: int) -> list:
    """The raw observations `hist` took since its count was `mark` (its
    recent() window holds the last RECENT only, so a slice by the window's
    old length goes empty once the window is full)."""
    n = hist.count() - mark
    window = hist.recent()
    check(n <= len(window), f"{hist.name}: {n} observations since the "
                            f"mark, {len(window)} kept")
    return window[len(window) - n:]


def host_parsers() -> dict:
    """Which host parsers the transport ran: native/ (when built) or the
    pure-Python fallbacks. chip_smoke.py does not build native/."""
    from gie_tpu_torch.extproc import fieldscan, wire

    return {"fieldscan": "native" if fieldscan.available() else "python",
            "wire_walk": "native" if wire.available() else "python"}


class EnvoyStream:
    """An in-memory ext-proc stream playing Envoy's side of one exchange:
    request headers, body, then the response headers echoing the pick."""

    def __init__(self, w: int, i: int):
        from gie_tpu_torch.extproc import pb

        self._pb = pb
        headers, body, self._response_headers, _ = stream_frames(w, i)
        self._frames = [headers, body]
        self.sent = []

    def recv(self):
        if not self._frames and self._response_headers is not None:
            dest = destination(self.sent[0].SerializeToString()) if self.sent else None
            if dest is not None:
                self._frames.append(self._response_headers(dest.split(",")[0]))
            self._response_headers = None
        if not self._frames:
            return None
        return self._pb.ProcessingRequest.FromString(self._frames.pop(0))

    def send(self, resp):
        self.sent.append(resp)

    def response_bytes(self) -> bytes:
        return b"".join(len(r.SerializeToString()).to_bytes(4, "big")
                        + r.SerializeToString() for r in self.sent)


def replay_on_cpu(dev, runner, cfg, weights, fleet_port) -> dict:
    """REPLAY_STREAMS sequential streams through the card runner's
    StreamingServer and the same frames through a CPU runner, with both
    scrape engines closed and the same scheduler state, scraped rows (on a
    fixed clock), LoRA ids and Gumbel noise: the response bytes must be
    equal."""
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner
    from gie_tpu_torch.sched import Scheduler
    from gie_tpu_torch.sched.constants import Metric
    from gie_tpu_torch.sched.profile import gumbel_noise

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    drawn = []

    def noise(shape):
        drawn.append(gumbel_noise(shape, gen, dev))
        return drawn[-1]

    cpu = ExtProcServerRunner(
        runner.opts, fleet_cluster("smoke", fleet_ips(M), fleet_port),
        scheduler=Scheduler(cfg, weights, device="cpu",
                            noise_source=lambda shape: drawn[-1].cpu()))
    try:
        for r in (runner, cpu):
            r.scraper.close()
        cpu.setup()
        runner.scheduler.noise_source = noise
        cpu.scheduler.install_state(runner.scheduler.export_state())
        # The card registry numbered adapters in the bursts' arrival order;
        # the CPU registry takes the same numbers.
        known = runner.lora_registry._ids
        for adapter in sorted(known, key=known.get):
            cpu.lora_registry.id_for(adapter)
        for r in (runner, cpu):
            rng = np.random.default_rng(3)
            rows = [(ep.slot,
                     {Metric.QUEUE_DEPTH: float(rng.integers(0, 50)),
                      Metric.KV_CACHE_UTIL: float(rng.uniform(0, 0.95)),
                      Metric.MAX_LORA: 8.0},
                     [r.lora_registry.id_for(ADAPTERS[j])
                      for j in rng.choice(12, 3, replace=False)], ())
                    for ep in r.datastore.endpoints()]
            r.metrics_store._clock = lambda: 0.0
            r.metrics_store.update_rows(rows, now=0.0)
        equal = 0
        for i in range(REPLAY_STREAMS):
            sent = []
            for r in (runner, cpu):
                stream = EnvoyStream(50, i)
                r.streaming.process(stream)
                check(len(stream.sent) == 3, f"replay stream {i}: "
                                             f"{len(stream.sent)} responses")
                sent.append(stream.response_bytes())
            equal += sent[0] == sent[1]
    finally:
        cpu.stop()
    check(equal == REPLAY_STREAMS, f"{equal} of {REPLAY_STREAMS} replayed "
                                   "streams byte-equal to the CPU runner")
    return {"replay_streams": REPLAY_STREAMS, "replay_equal": equal}


def otlp_sink():
    """A loopback OTLP/HTTP collector: counts the spans POSTed to
    /v1/traces. -> (server, port, spans list); close() with shutdown()."""
    import http.server

    spans = []

    class Sink(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0) or 0)
            payload = json.loads(self.rfile.read(n))
            for rs in payload.get("resourceSpans", []):
                for ss in rs.get("scopeSpans", []):
                    spans.extend(ss.get("spans", []))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1], spans


def http_get(port: int, path: str, accept: str = "") -> bytes:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    if accept:
        req.add_header("Accept", accept)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read()


def phase_main(cfg, weights, tmp) -> dict:
    """`python -m gie_tpu_torch.runtime.main --demo` as a subprocess with
    the reference's default flags (resilience and obs on) plus
    --obs-sample-rate 1.0 and --obs-otlp-endpoint at a loopback sink, on
    explicit ports: readiness and the "resilience" sub-service SERVING,
    MAIN_STREAMS golden streams (each with its own W3C traceparent)
    answered, /debugz/picks holding their records and /debugz/trace one
    stream's trace, the OpenMetrics /metrics carrying a trace_id exemplar
    on the pick-latency histogram, OTLP spans at the sink, then SIGTERM
    and exit 0 within MAIN_EXIT_S."""
    import re
    import signal

    need_transport()
    from gie_tpu_torch.extproc import pb
    from gie_tpu_torch.runtime.health import SERVING

    gport, hport, mport = free_port(), free_port(), free_port()
    sink, sink_port, spans = otlp_sink()
    cmd = [sys.executable, "-m", "gie_tpu_torch.runtime.main", "--demo",
           "--demo-pods", "8", "--insecure-serving", "--scheduler-config",
           write_scheduler_config(cfg, weights, tmp),
           "--pool-name", "smoke", "--grpc-port", str(gport),
           "--grpc-health-port", str(hport), "--metrics-port", str(mport),
           "--obs-sample-rate", "1.0",
           "--obs-otlp-endpoint", f"http://127.0.0.1:{sink_port}"]
    log_path = f"{tmp}/main.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        t0 = time.monotonic()
        status = None
        while time.monotonic() - t0 < 300 and proc.poll() is None:
            try:
                status = health_status(hport, "readiness")
            except Exception:
                status = None
            if status == SERVING:
                break
            time.sleep(0.5)
        ready_s = time.monotonic() - t0
        check(status == SERVING, f"main: readiness not SERVING after "
                                 f"{ready_s:.1f} s; log:\n{tail(log_path)}")
        check(health_status(hport, "resilience") == SERVING,
              "main: the resilience sub-service is not SERVING")
        trace_ids = [f"{0x5e00 + i:032x}" for i in range(MAIN_STREAMS)]

        def golden(i):
            return pb.ProcessingRequest(request_headers=pb.HttpHeaders(
                headers=pb.HeaderMap(headers=[
                    pb.HeaderValue(key=":path", raw_value=b"/v1/completions"),
                    pb.HeaderValue(key="x-model", value="llama"),
                    pb.HeaderValue(key="traceparent", raw_value=(
                        f"00-{trace_ids[i]}-{i + 1:016x}-01").encode())]),
                end_of_stream=True)).SerializeToString()

        chans, methods = open_channels(gport, 4)
        answered = 0
        try:
            for i in range(MAIN_STREAMS):
                out = list(methods[i % 4](iter([golden(i)]), timeout=60))
                answered += bool(out) and destination(out[0]) is not None
        finally:
            for c in chans:
                c.close()
        check(answered == MAIN_STREAMS,
              f"main: {answered} of {MAIN_STREAMS} streams answered")
        check(health_status(hport, "resilience") == SERVING,
              "main: the resilience sub-service is not SERVING after the "
              "streams")
        def get(path, accept=""):
            """GET from the metrics port; a refused or failed request
            raises with main.log's tail (a listener that could not bind
            logs "metrics server failed to start" there)."""
            try:
                return http_get(mport, path, accept=accept)
            except Exception as e:
                raise RuntimeError(
                    f"main: GET :{mport}{path} failed: {e!r}; log:\n"
                    f"{tail(log_path)}") from e

        def log_tail():
            return f"; log:\n{tail(log_path)}"

        picks = json.loads(get(f"/debugz/picks?n={MAIN_STREAMS}"))
        recorded = {r.get("trace_id") for r in picks}
        check(len(picks) == MAIN_STREAMS and recorded == set(trace_ids),
              f"main: /debugz/picks holds {len(picks)} records, "
              f"{len(recorded & set(trace_ids))} of the streams' traces"
              + log_tail())
        check({r.get("rung") for r in picks} == {"full"},
              f"main: picks answered by {sorted({r.get('rung') for r in picks})}"
              + log_tail())
        one = json.loads(get(f"/debugz/trace?id={trace_ids[7]}"))
        check(one.get("trace_id") == trace_ids[7] and one.get("events"),
              f"main: /debugz/trace returned {one}" + log_tail())
        om = get("/metrics",
                 accept="application/openmetrics-text; version=1.0.0")
        exemplar = re.search(
            rb'gie_pick_latency_seconds_bucket\{le="[^"]+"\} [0-9.e+]+ '
            rb'# \{trace_id="([0-9a-f]{32})"\}', om)
        check(exemplar is not None and om.rstrip().endswith(b"# EOF"),
              "main: the OpenMetrics exposition has no trace_id exemplar "
              "on gie_pick_latency_seconds" + log_tail())
        # The runner's lattice kick: the streams' lattice (M=64 for 8
        # pods, 8 chunk lanes for a bodyless request) warms in full.
        from gie_tpu_torch.sched.constants import N_BUCKETS

        lattice = {(n, 64, 8) for n in N_BUCKETS}
        deadline = time.monotonic() + 120
        while True:
            report = json.loads(get("/debugz/scheduler"))
            warm_buckets = {tuple(k) for k in report["warm_buckets"]}
            if lattice <= warm_buckets or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        emit({"phase": "main-warm", "warm_buckets": report["warm_buckets"],
              "warm_inline_compiles": report["warm_inline_compiles"]})
        check(lattice <= warm_buckets,
              f"main: the streams' lattice is not warm: {report}"
              + log_tail())
        deadline = time.monotonic() + 10
        while not spans and time.monotonic() < deadline:
            time.sleep(0.1)
        spans_before_stop = len(spans)
        check(spans_before_stop > 0, "main: the OTLP sink received no span")
        t1 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(MAIN_EXIT_S)
        exit_s = time.monotonic() - t1
        check(rc == 0, f"main: exit code {rc} after SIGTERM; log:\n"
                       f"{tail(log_path)}")
        exported = {s["traceId"] for s in spans}
        check(set(trace_ids) <= exported,
              f"main: {len(set(trace_ids) & exported)} of {MAIN_STREAMS} "
              "streams' traces reached the OTLP sink")
        summary = {"phase": "main", "ready_s": ready_s, "streams": MAIN_STREAMS,
                   "answered": answered, "records": len(picks),
                   "exemplar_trace_id": exemplar.group(1).decode(),
                   "otlp_spans_before_stop": spans_before_stop,
                   "otlp_spans": len(spans), "exit_code": rc,
                   "exit_s": exit_s, "warm_buckets": report["warm_buckets"]}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        sink.shutdown()
        sink.server_close()
    emit(summary)
    return summary


# -- phase 12: the pd dual pick on the card ----------------------------------

PD_TIMED_WAVES = 10
PD_SINGLEHOP = 32          # picks whose deadline is inside the budget floor
PD_FLOOR_S = 2.0           # the single-hop floor of phase 12's picker


def pd_roles(n: int, seed: int = 12) -> np.ndarray:
    """`n` endpoint roles from a seed: 3/8 prefill, 3/8 decode, 1/4 both."""
    from gie_tpu_torch.sched.constants import Role

    rng = np.random.default_rng(seed)
    return rng.choice([int(Role.PREFILL)] * 3 + [int(Role.DECODE)] * 3
                      + [int(Role.BOTH)] * 2, n).astype(np.int32)


def timed_waves(dev, cfg, weights, eps, waves, **sched_kw) -> dict:
    """pick_async's host time, the wall time per wave of `cfg` over
    `waves`, chained, on a fresh Scheduler (built with `sched_kw`) whose
    key is captured first, and the bytes its graphs' pools hold."""
    from gie_tpu_torch import ops
    from gie_tpu_torch.sched import Scheduler

    sched = Scheduler(cfg, weights, device=dev, seed=12, **sched_kw)
    with ops.tally({}):            # timing launches are not the main path's
        sched.pick(waves[0], eps)

        def dispatch(reqs):
            pending = sched.pick_async(reqs, eps)
            return pending, pending.event

        host, wall, _ = run_waves(dispatch, waves)
    pools = pool_bytes()
    return {"pick_async_host_ms_median": statistics.median(host),
            "wall_ms_per_wave": wall,
            "graph_pool_bytes": sum(pools.get(tuple(g.graph.pool()), 0)
                                    for g in sched._graphs.values())}


def score_tolerance(sinkhorn: bool):
    """(atol, rtol) for card-vs-CPU scores: phase 3's pick-gap bound as the
    absolute part and, on the sinkhorn path, the lane tiebreak's slack of
    2 * 2**ceil(log2 M) ulps."""
    return 1e-4, (2 * 2 ** int(np.ceil(np.log2(M))) * 2.0**-23
                  if sinkhorn else 0.0)


def phase_pd(dev, name, cfg, weights, kernels, own) -> dict:
    """Phase 12 for one configuration with pd_disaggregation on: WAVES
    carried dual-pick waves of the north-star mix over endpoints of mixed
    roles through the captured cycle, each replayed on a CPU Scheduler from
    the same state with the same [2, N, M] noise (prefill, indices and
    status exact); pick_async host and wall time per wave beside the
    classic cycle's; then the pick service over M pods labelled with
    their roles: a burst of N concurrent picks (prefill header on a
    prefill-capable pod, destination decode-capable, both charges released
    by served feedback) and PD_SINGLEHOP picks with deadlines inside the
    budget floor (no header, counted single hops)."""
    from gie_tpu_torch import convert
    from gie_tpu_torch.extproc import metadata as mdkeys
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.sched import Scheduler
    from gie_tpu_torch.sched.constants import Role
    from gie_tpu_torch.sched.profile import gumbel_noise, pd_costs_host
    from gie_tpu_torch.sched.types import RequestBatch

    t_phase = time.perf_counter()
    pd_cfg = dataclasses.replace(cfg, pd_disaggregation=True)
    sinkhorn = cfg.picker == "sinkhorn"
    per_wave = 2 if sinkhorn else 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    drawn = []

    def noise(shape):
        drawn.append(gumbel_noise(shape, gen, dev))
        return drawn[-1]

    gpu = Scheduler(pd_cfg, weights, device=dev, noise_source=noise)
    cpu = Scheduler(pd_cfg, weights, device="cpu",
                    noise_source=lambda shape: drawn[-1].cpu())
    roles = pd_roles(M)
    eps, wave = workload(dev)
    eps = eps.replace(role=torch.from_numpy(roles).to(dev))
    eps_cpu = convert.endpoints_from_numpy(convert.endpoints_to_numpy(eps),
                                           device="cpu")
    waves = [wave(w) for w in range(WAVES)]
    cpu_waves = [RequestBatch(**{f.name: getattr(r, f.name).cpu()
                                 for f in dataclasses.fields(RequestBatch)})
                 for r in waves]
    atol, rtol = score_tolerance(sinkhorn)

    torch.cuda.synchronize()
    counter = kernels[own]
    for fn in kernels.values():
        fn.launches = 0
    wave_ms = []
    for w, reqs in enumerate(waves):
        cpu.install_state(gpu.export_state())
        t0 = time.perf_counter()
        res = gpu.pick(reqs, eps)
        wave_ms.append((time.perf_counter() - t0) * 1e3)
        check(counter.launches == per_wave * (w + 1),
              f"pd {name}: {counter.launches} kernel launches after "
              f"{w + 1} waves")
        check(len(drawn) == (w + 1 if sinkhorn else 0) and (
            not sinkhorn or tuple(drawn[-1].shape) == (2, N, M)),
              f"pd {name}: {len(drawn)} noise draws after {w + 1} waves")
        ref = cpu.pick(cpu_waves[w], eps_cpu)
        for k in ("prefill", "indices", "status"):
            check(np.array_equal(getattr(res, k), getattr(ref, k)),
                  f"pd {name} wave {w}: {k} differ from the CPU replay in "
                  f"{int((getattr(res, k) != getattr(ref, k)).sum())} places")
        ok = res.status == 0
        check(bool(np.allclose(res.scores[ok], ref.scores[ok], atol=atol,
                               rtol=rtol)),
              f"pd {name} wave {w}: scores differ beyond ({atol}, {rtol})")
        check(ok.mean() > 0.9, f"pd {name} wave {w}: {ok.mean()} OK")
        check(bool((roles[res.prefill[ok]] != Role.DECODE).all()
                   and (roles[res.indices[ok, 0]] != Role.PREFILL).all()),
              f"pd {name} wave {w}: a pick on a pod of the wrong role")
        half = np.flatnonzero(ok)[: N // 2]
        plen = reqs.prompt_len.cpu().numpy()
        dlen = reqs.decode_len.cpu().numpy()
        costs = [pd_costs_host(float(plen[i]), float(dlen[i])) for i in half]
        gpu.complete(np.concatenate([res.prefill[half], res.indices[half, 0]]),
                     np.asarray([c[0] for c in costs] + [c[1] for c in costs],
                                np.float32))
        emit({"phase": "pd", "config": name, "wave": w, "ms": wave_ms[-1],
              "ok_rows": int(ok.sum()),
              "colocated": int((res.prefill[ok] == res.indices[ok, 0]).sum())})
    launches = {k: fn.launches for k, fn in kernels.items()}

    # pick_async's host time and the wall per wave, pd beside classic.
    timed = [wave(WAVES + w) for w in range(PD_TIMED_WAVES)]
    timing = {"pd": timed_waves(dev, pd_cfg, weights, eps, timed),
              "classic": timed_waves(dev, cfg, weights, eps, timed)}

    # The pick service over role-labelled pods.
    sched, ds, picker = pick_stack(dev, pd_cfg, weights, roles=roles,
                                   pd_budget_floor_s=PD_FLOOR_S)
    try:
        cands = ds.pick_candidates()
        role_of = {ep.hostport: int(roles[ep.slot]) for ep in ds.endpoints()}
        for n in (N, PD_SINGLEHOP):          # warm-up, both wave sizes
            for r in burst(picker, cands, pick_requests(-1, n))[0]:
                picker.observe_served(r.endpoint, SimpleNamespace(
                    pick_result=r, resp_status=200,
                    picked_at=time.monotonic(), headers={}))
        torch.cuda.synchronize()
        own_metrics.reset()
        for fn in kernels.values():
            fn.launches = 0
        res, lat, wall = burst(picker, cands, pick_requests(ROUNDS + 8, N))
        singles = pick_requests(ROUNDS + 9, PD_SINGLEHOP)
        for r in singles:
            r.deadline_at = time.monotonic() + PD_FLOOR_S / 2
        single_res, _, _ = burst(picker, cands, singles)
        waves_run = int(own_metrics.PIPELINE_WAVES.value())
        for k, fn in kernels.items():
            launches[k] += fn.launches
        check(kernels[own].launches == per_wave * waves_run,
              f"pd {name}: {kernels[own].launches} picker launches for "
              f"{waves_run} waves")
        for r in res:
            pf = r.extra_headers.get(mdkeys.PREFILL_ENDPOINT_KEY)
            check(pf is not None and role_of[pf] != Role.DECODE,
                  f"pd {name}: prefill header {pf!r}")
            check(role_of[r.endpoint] != Role.PREFILL,
                  f"pd {name}: destination {r.endpoint} is prefill-only")
            check(len(r.charged) == 2, f"pd {name}: charged {r.charged}")
        singlehop = int(own_metrics.PD_BUDGET_SINGLEHOP.value())
        for r in single_res:
            check(mdkeys.PREFILL_ENDPOINT_KEY not in r.extra_headers
                  and role_of[r.endpoint] != Role.PREFILL
                  and len(r.charged) == 1,
                  f"pd {name}: a single-hop pick {r.endpoint} "
                  f"{r.extra_headers} {r.charged}")
        check(singlehop == PD_SINGLEHOP,
              f"pd {name}: {singlehop} single hops counted of "
              f"{PD_SINGLEHOP}")
        for r in res + single_res:
            picker.observe_served(r.endpoint, SimpleNamespace(
                pick_result=r, resp_status=200, picked_at=time.monotonic(),
                headers={}))
        load = sched.snapshot_assumed_load()
        check(float(np.abs(load).max()) <= 1e-3,
              f"pd {name}: assumed load {float(np.abs(load).max())} after "
              "every charge was released")
    finally:
        picker.close()
    summary = {
        "phase": "pd", "config": name, "waves": WAVES,
        "roles": {ROLE_NAMES[r]: int((roles == r).sum()) for r in range(3)},
        "launches": launches,
        "kernel_launches_per_wave": per_wave,
        "replay_equal_cpu": WAVES,
        "wave_ms_median": statistics.median(wave_ms[1:]),
        "timing": timing,
        "picks": len(res), "picks_per_s": len(res) / wall,
        "pick_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "pick_p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "picker_waves": waves_run, "singlehop": singlehop,
        "load_max_after_release": float(np.abs(load).max()),
        "wall_s": time.perf_counter() - t_phase,
    }
    emit(summary)
    return summary


# -- phase 13: KV-cache events on the card ----------------------------------

KV_EXTRA_PODS = 45         # pods 256..300: the program's slot 300 grows M
KV_BULK_POSTS, KV_BULK_EVENTS = 16, 500   # the listener's throughput run
KV_FOLD_BUCKETS = (64, 512, 4096)


def chunk_chain(prompt: bytes) -> list:
    from gie_tpu_torch.sched.hashing import chunk_hashes

    h, n = chunk_hashes(prompt)
    return [int(x) for x in h[:n]]


def json_lines(events: list, per_body: int = 16) -> list:
    return ["\n".join(json.dumps(e) for e in events[i:i + per_body]).encode()
            for i in range(0, len(events), per_body)]


def kv_event_program(hostports: list, seed: int = 13) -> list:
    """The seeded event program as JSON-lines bodies: a 10,000-hash batch
    (parts of 4096), the 16 system prompts' chunk chains each stored on 4
    endpoints, removals, an AllBlocksCleared, and an event for the endpoint
    at slot 300."""
    from gie_tpu_torch.sched.kvevents import (
        ALL_CLEARED, BLOCK_REMOVED, BLOCK_STORED)

    rng = np.random.default_rng(seed)
    live = len(hostports) - KV_EXTRA_PODS
    bulk = rng.integers(1, 2**32, 10_000, dtype=np.uint32)
    events = [{"type": BLOCK_STORED, "endpoint": hostports[7],
               "hashes": bulk.tolist()}]
    for k in range(16):
        for slot in rng.choice(live, 4, replace=False):
            events.append({"type": BLOCK_STORED,
                           "endpoint": hostports[slot],
                           "hashes": chunk_chain((BASE % k) * 6)})
    events.append({"type": BLOCK_REMOVED, "endpoint": hostports[7],
                   "hashes": rng.choice(bulk, 2000).tolist()})
    events.append({"type": BLOCK_REMOVED, "endpoint": events[1]["endpoint"],
                   "hashes": events[1]["hashes"][:3]})
    events.append({"type": ALL_CLEARED, "endpoint": hostports[11]})
    events.append({"type": BLOCK_STORED, "endpoint": hostports[300],
                   "hashes": chunk_chain((BASE % 3) * 6)})
    return json_lines(events)


def event_only_prompt(w: int, hostports: list, seed: int = 13):
    """Wave w's event-only system prompt (7 chunks, never picked before
    its wave) and 4 reporters of it. -> (prompt, reporter slots, JSON-lines
    bodies storing its chain on each reporter)."""
    from gie_tpu_torch.sched.kvevents import BLOCK_STORED

    rng = np.random.default_rng(seed + 100 + w)
    prompt = b"EVENT-ONLY SYSTEM PROMPT %d. " % w * 16
    reporters = sorted(int(s) for s in rng.choice(
        len(hostports) - KV_EXTRA_PODS, 4, replace=False))
    return prompt, reporters, json_lines([
        {"type": BLOCK_STORED, "endpoint": hostports[s],
         "hashes": chunk_chain(prompt)} for s in reporters])


def post_events(port: int, body: bytes) -> int:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/events",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())["accepted"]


def phase_kvevents(dev, kernels, tmp) -> dict:
    """Phase 13: the runner main() builds (as phase 6, topk +
    use_pallas_topk, whose default weights let a full prefix match
    outweigh every other column) with --kv-events-port over M stub pods
    whose event sinks post to its listener, under a burst of N streams;
    the listener's event rate; the fold's device time per bucket; then the
    seeded event program over HTTP to the card and straight into a CPU
    Scheduler's aggregator from the same state: exports bit-equal, and
    WAVES north-star waves picked alike on both, each event-only prompt on
    an endpoint that reported it."""
    need_transport()
    import multiprocessing

    from gie_tpu_torch.datastore.objects import Pod
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner
    from gie_tpu_torch.sched import ProfileConfig, Scheduler
    from gie_tpu_torch.sched.graphs import FoldGraph
    from gie_tpu_torch.sched.kvevents import KVEventAggregator
    from gie_tpu_torch.sched.types import RequestBatch, SchedState
    from gie_tpu_torch.utils.testing import make_requests

    t_phase = time.perf_counter()
    cfg, own = ProfileConfig(picker="topk", use_pallas_topk=True), \
        "fused_blend_topk"
    ctx = multiprocessing.get_context("spawn")
    stop, ready, port_q = ctx.Event(), ctx.Queue(), ctx.Queue()
    posting, posted = ctx.Event(), ctx.Value("l", 0)
    posting.set()
    ips = fleet_ips(M + KV_EXTRA_PODS)
    procs = [ctx.Process(target=stub_fleet_process,
                         args=(len(ips), 0, ready, stop,
                               (port_q, posting, posted, M)), daemon=True)]
    procs[0].start()
    runner = None
    try:
        fleet_port = ready.get(timeout=120)
        kv_port = free_port()
        argv = ["--insecure-serving",
                "--scheduler-config", write_scheduler_config(cfg, None, tmp),
                "--pool-name", "smoke", "--grpc-port", str(free_port()),
                "--grpc-health-port", str(free_port()),
                "--metrics-port", str(free_port()),
                "--extproc-workers", str(EXTPROC_WORKERS),
                "--scrape-interval-ms", str(SCRAPE_INTERVAL_MS),
                "--kv-events-port", str(kv_port)]
        cluster = fleet_cluster("smoke", ips[:M], fleet_port)
        runner = ExtProcServerRunner(server_options(argv), cluster)
        sched = runner.scheduler
        check(sched.device.type == "cuda",
              f"kv-events: the runner's scheduler is on {sched.device}")
        holds = []
        apply = sched._apply_queued

        def timed_apply():
            t0 = time.perf_counter()
            apply()
            holds.append(time.perf_counter() - t0)

        sched._apply_queued = timed_apply
        runner.setup()
        runner.start()
        agg = runner.kv_events
        check(agg is not None and runner.kv_events_server.port == kv_port,
              "kv-events: the runner built no listener")
        port_q.put(kv_port)
        slots = [ep.slot for ep in runner.datastore.endpoints()]
        check(len(slots) == M, f"kv-events: {len(slots)} of {M} pods ready")
        deadline = time.monotonic() + 60
        while True:
            _, ages = runner.metrics_store.pool_rows(slots)
            if bool(np.isfinite(ages).all()) or time.monotonic() > deadline:
                break
            time.sleep(0.1)

        # One burst of N streams while the stubs publish.
        barrier, results = ctx.Barrier(CLIENTS + 1), ctx.Queue()
        for k in range(CLIENTS):
            procs.append(ctx.Process(
                target=client_process,
                args=(runner.grpc_server.port, CHANNELS // CLIENTS, [0], k,
                      STREAMS_PER_ROUND, barrier, results), daemon=True))
            procs[-1].start()
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        waves0 = own_metrics.PIPELINE_WAVES.value()
        barrier.wait(600)
        got = [results.get(timeout=900) for _ in range(CLIENTS)]
        outcomes = [o for g in got for o in g[1]]
        errs = [o[4] for o in outcomes if o[4]]
        check(not errs, f"kv-events: {len(errs)} streams failed, first: "
                        f"{errs[:1]}")
        live = {ep.hostport for ep in runner.datastore.endpoints()}
        check(all(o[1] is not None and o[1].split(",")[0] in live
                  for o in outcomes) and len(outcomes) == STREAMS_PER_ROUND,
              "kv-events: a stream got no ready destination")
        burst_waves = int(own_metrics.PIPELINE_WAVES.value() - waves0)
        time.sleep(1.0)                 # a few more ticks of publishing
        posting.clear()
        time.sleep(0.3)                 # the last tick's POST lands
        agg.flush()
        check(agg.dropped == 0 and agg.ingested > 0,
              f"kv-events: {agg.dropped} dropped, {agg.ingested} ingested")
        stub_events = int(posted.value)
        for t in runner.picker._warm_threads:
            t.join(300)

        # The listener's rate: KV_BULK_POSTS bodies of KV_BULK_EVENTS
        # stored events (32 hashes each) to live pods, 4 posting threads;
        # timed to the last answer, then to the queue applied.
        hostports = [ep.hostport for ep in sorted(
            runner.datastore.endpoints(), key=lambda e: e.slot)]
        rng = np.random.default_rng(14)
        bodies = ["\n".join(json.dumps({
            "type": "BlockStored", "endpoint": hostports[int(s)],
            "hashes": rng.integers(1, 2**32, 32).tolist()})
            for s in rng.integers(0, M, KV_BULK_EVENTS)).encode()
            for _ in range(KV_BULK_POSTS)]
        accepted = []
        t0 = time.perf_counter()
        threads = [threading.Thread(target=lambda part: accepted.extend(
            post_events(kv_port, b) for b in part), args=(bodies[i::4],))
            for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        post_s = time.perf_counter() - t0
        agg.flush()
        sched.snapshot_assumed_load()          # applies the queue
        applied_s = time.perf_counter() - t0
        check(sum(accepted) == KV_BULK_POSTS * KV_BULK_EVENTS,
              f"kv-events: {sum(accepted)} events accepted")
        rate = {"events": sum(accepted), "posts": KV_BULK_POSTS,
                "events_per_s_posted": sum(accepted) / post_s,
                "events_per_s_applied": sum(accepted) / applied_s}

        # One fold's time per lane bucket, as the queue applies it (a
        # FoldGraph replay) on a state of its own: device time, and CUDA
        # event time with the host's path.
        fold_ms = {}
        state = SchedState.init(m=M, device=dev)
        fold_stream = torch.cuda.Stream(dev)
        for b in KV_FOLD_BUCKETS:
            graph = FoldGraph(state, b, dev)
            graph.capture(fold_stream)
            fold_ms[str(b)] = {}
            for kind, remove in (("stored", 0), ("removed", 1)):
                lanes = torch.from_numpy(np.stack([
                    rng.integers(1, 2**32, b), np.full(b, 5),
                    np.full(b, remove)]).astype(np.int64)).to(dev)
                fold_ms[str(b)][f"{kind}_device_ms"] = device_ms(
                    lambda: graph.replay(lanes))
                fold_ms[str(b)][f"{kind}_event_ms"] = cuda_ms(
                    lambda: graph.replay(lanes))

        # The deterministic program: grow the pool to slot 300, copy the
        # card's state to a CPU Scheduler, then the same events to both.
        for i in range(M, len(ips)):
            cluster.apply_pod(Pod(name=f"vllm-{i}", labels={"app": "vllm"},
                                  ip=ips[i]))
        deadline = time.monotonic() + 60
        while (len(runner.datastore.endpoints()) < len(ips)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        by_slot = {ep.slot: ep.hostport for ep in runner.datastore.endpoints()}
        check(sorted(by_slot) == list(range(len(ips))),
              f"kv-events: slots {sorted(by_slot)[-3:]} after the pool grew")
        hostports = [by_slot[s] for s in range(len(ips))]
        cpu = Scheduler(cfg, device="cpu")
        check(cpu.install_state(sched.export_state()),
              "kv-events: the card's state does not install on the CPU")

        def resolve(hostport):
            ep = runner.datastore.endpoint_by_hostport(hostport)
            return None if ep is None else ep.slot

        cpu_agg = KVEventAggregator(cpu, resolve)

        def both(bodies, what):
            """`bodies` over HTTP to the card's listener and into the CPU's
            aggregator, both flushed; their exports must be bit-equal."""
            for body in bodies:
                check(post_events(kv_port, body)
                      == cpu_agg.publish_lines(body),
                      f"kv-events: {what}: the listener accepted another "
                      "count")
            agg.flush()
            cpu_agg.flush()
            same_export(sched.export_state(), cpu.export_state(),
                        f"kv-events: {what}: the card against the CPU")

        program = kv_event_program(hostports)
        both(program, "the program")
        check(sched.state.m == 512 and cpu.state.m == 512,
              f"kv-events: state width {sched.state.m} after slot 300")

        # WAVES north-star waves on both. Before each, the card's state
        # goes to the CPU (whose journal is emptied first: a replay would
        # restamp older events' ages) and a system prompt that no pick has
        # seen is reported by 4 endpoints to both; its requests must land
        # on one of them.
        eps, wave = workload(torch.device("cpu"))
        agree = rows = allowed = 0
        for w in range(WAVES):
            reqs = wave(w)
            prompt, reporters, bodies = event_only_prompt(w, hostports)
            extra = make_requests(8, prompts=[prompt] * 8, m_slots=M)
            lanes = int(reqs.chunk_hashes.shape[1])
            check(int(extra.n_chunks.max()) <= lanes,
                  "kv-events: the event-only prompt outgrows the wave's lanes")
            reqs = RequestBatch(**{
                f.name: torch.cat([getattr(reqs, f.name)[:N - 8],
                                   getattr(extra, f.name)[:, :lanes]
                                   if f.name == "chunk_hashes"
                                   else getattr(extra, f.name)])
                for f in dataclasses.fields(RequestBatch)})
            cpu._kv_journal.clear()
            cpu.install_state(sched.export_state())
            both(bodies, f"wave {w}'s event-only prompt")
            cpu._kv_journal.clear()
            res = sched.pick(reqs, eps)
            ref_res = cpu.pick(reqs, eps)
            check(bool(np.isin(res.indices[N - 8:, 0], reporters).all()),
                  f"kv-events wave {w}: event-only picks "
                  f"{res.indices[N - 8:, 0]} not among reporters {reporters}")
            check(np.array_equal(res.status, ref_res.status),
                  f"kv-events wave {w}: statuses differ from the CPU")
            d = res.indices[:, 0] != ref_res.indices[:, 0]
            gap = ref_res.scores[:, 0] - ref_res.scores[:, 1]
            check(bool((gap[d] < 1e-4).all()),
                  f"kv-events wave {w}: a pick differs where the CPU "
                  "top-two gap >= 1e-4")
            agree += int((~d).sum())
            allowed += int(d.sum())
            rows += len(d)
        launches = {k: fn.launches for k, fn in kernels.items()}
        check(launches[own] == burst_waves + WAVES,
              f"kv-events: {launches[own]} launches for {burst_waves} burst "
              f"waves and {WAVES} waves")
        summary = {
            "phase": "kv-events", "config": "topk+use_pallas_topk",
            "endpoints": M, "streams": len(outcomes),
            "burst_waves": burst_waves, "stub_events_posted": stub_events,
            "ingested": agg.ingested, "dropped": agg.dropped,
            "listener": rate, "fold": fold_ms,
            "lock_hold_ms_max": max(holds) * 1e3 if holds else 0.0,
            "queue_applies": len(holds),
            "program_events": sum(b.count(b"\n") + 1 for b in program),
            "export_equal_cpu": True, "state_m": sched.state.m,
            "waves": WAVES, "primary_agree": agree, "rows": rows,
            "differ_within_gap": allowed, "launches": launches,
            "wall_s": time.perf_counter() - t_phase,
        }
    finally:
        stop.set()
        if runner is not None:
            runner.stop()
        for proc in procs:
            proc.join(30)
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    emit(summary)
    return summary


# -- phase 14: the learned scorer, the random picker, checkpoints ------------

LEARN_ARTIFACT = "config/policy/storm-lora-v1.json"
LEARN_TRACE = "tests/fixtures/learn/storm-fixture-flightrec.json"
LEARN_TIMED_WAVES = 10


def learned_profile():
    """The committed artifact and phase 3's profile with its exponents:
    (artifact, cfg, weights)."""
    from gie_tpu_torch.learn import artifact
    from gie_tpu_torch.sched.config import tuned_profile

    art = artifact.load_artifact(LEARN_ARTIFACT)
    cfg, _ = tuned_profile()
    return art, dataclasses.replace(cfg, use_pallas_sinkhorn=True,
                                    scorer="learned"), \
        artifact.to_sched_weights(art)


def learn_runner(dev, kernels, art, tmp) -> dict:
    """(c): the runner main() builds from argv with --scorer learned
    --policy-artifact over M stub pods (phase 6's transport and profile
    file, tuned + use_pallas_sinkhorn), one burst of N streams after a
    warm-up round: every stream answered with a ready primary, one
    Sinkhorn launch a wave; /debugz/policy names the artifact's checksum
    and gie_policy_info carries its weights."""
    need_transport()
    import multiprocessing

    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner
    from gie_tpu_torch.sched.config import tuned_profile

    cfg, weights = tuned_profile()
    cfg = dataclasses.replace(cfg, use_pallas_sinkhorn=True)
    ctx = multiprocessing.get_context("spawn")
    stop, ready = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=stub_fleet_process, args=(M, 0, ready, stop),
                         daemon=True)]
    procs[0].start()
    runner = None
    try:
        fleet_port = ready.get(timeout=120)
        mport = free_port()
        argv = ["--insecure-serving",
                "--scheduler-config", write_scheduler_config(cfg, weights, tmp),
                "--scorer", "learned", "--policy-artifact", LEARN_ARTIFACT,
                "--pool-name", "smoke", "--grpc-port", str(free_port()),
                "--grpc-health-port", str(free_port()),
                "--metrics-port", str(mport),
                "--extproc-workers", str(EXTPROC_WORKERS),
                "--scrape-interval-ms", str(SCRAPE_INTERVAL_MS)]
        runner = ExtProcServerRunner(
            server_options(argv), fleet_cluster("smoke", fleet_ips(M),
                                                fleet_port))
        sched = runner.scheduler
        check(sched.device.type == "cuda" and sched.cfg.scorer == "learned"
              and sched.cfg.use_pallas_sinkhorn,
              f"learned runner: {sched.device}, {sched.cfg}")
        runner.setup()
        runner.start()
        slots = [ep.slot for ep in runner.datastore.endpoints()]
        check(len(slots) == M, f"learned runner: {len(slots)} of {M} ready")
        deadline = time.monotonic() + 60
        while True:
            _, ages = runner.metrics_store.pool_rows(slots)
            if bool(np.isfinite(ages).all()) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        rounds = [-1, 0]                                 # -1: warm-up
        barrier, results = ctx.Barrier(CLIENTS + 1), ctx.Queue()
        for k in range(CLIENTS):
            procs.append(ctx.Process(
                target=client_process,
                args=(runner.grpc_server.port, CHANNELS // CLIENTS, rounds, k,
                      STREAMS_PER_ROUND, barrier, results), daemon=True))
            procs[-1].start()
        live = {ep.hostport for ep in runner.datastore.endpoints()}
        for w in rounds:
            if w == 0:
                for t in runner.picker._warm_threads:
                    t.join(300)
                torch.cuda.synchronize()
                for fn in kernels.values():
                    fn.launches = 0
                waves0 = own_metrics.PIPELINE_WAVES.value()
                t0 = time.monotonic()
            barrier.wait(600)
            got = [results.get(timeout=900) for _ in range(CLIENTS)]
            outcomes = [o for g in got for o in g[1]]
            errs = [o[4] for o in outcomes if o[4]]
            check(not errs, f"learned runner: {len(errs)} streams failed, "
                            f"first: {errs[:1]}")
        burst_s = time.monotonic() - t0
        waves = int(own_metrics.PIPELINE_WAVES.value() - waves0)
        launches = {k: fn.launches for k, fn in kernels.items()}
        answered = sum(o[1] is not None and o[1].split(",")[0] in live
                       for o in outcomes)
        check(answered == STREAMS_PER_ROUND,
              f"learned runner: {answered} of {STREAMS_PER_ROUND} answered")
        check(launches["fused_sinkhorn_plan"] == waves >= 1,
              f"learned runner: {launches} launches for {waves} waves")
        policy = json.loads(http_get(mport, "/debugz/policy"))
        check(policy.get("scorer") == "learned"
              and policy.get("artifact", {}).get("checksum")
              == art["checksum"],
              f"learned runner: /debugz/policy {str(policy)[:300]}")
        metrics = http_get(mport, "/metrics").decode()
        info = [ln for ln in metrics.splitlines()
                if ln.startswith("gie_policy_info{")]
        want = ",".join(f"{k}={float(getattr(sched.weights, k)):g}"
                        for k in sorted(dataclasses.asdict(sched.weights)))
        # The registry is the process's: earlier phases' runners left
        # their own (blend) series beside this one.
        info = [ln for ln in info if 'scorer="learned"' in ln]
        check(len(info) == 1 and art["checksum"] in info[0]
              and f'weights="{want}"' in info[0],
              f"learned runner: gie_policy_info {info}")
        for t in runner.picker._warm_threads:
            t.join(300)
    finally:
        stop.set()
        if runner is not None:
            runner.stop()
        for proc in procs:
            proc.join(30)
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    rec = {"phase": "learn-runner", "streams": STREAMS_PER_ROUND,
           "answered": answered, "waves": waves, "launches": launches,
           "burst_s": burst_s, "streams_per_s": answered / burst_s,
           "policy_checksum": policy["artifact"]["checksum"],
           "gie_policy_info": info[0]}
    emit(rec)
    return rec


def learn_judge(dev, kernels, art) -> dict:
    """(d): the port's judge on storm-noisy-neighbor and the trace fixture,
    on the card and on a CPU engine, each engine run taking Gumbel noise
    from a CPU generator seeded STORM_SEED: the verdict and both sides'
    decision and schedule fingerprints equal."""
    from gie_tpu_torch.learn import judge
    from gie_tpu_torch.resilience import faults

    out, wall = [], []
    for where in (dev, torch.device("cpu")):
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.monotonic()
        out.append(judge.judge(
            art, scenarios=("storm-noisy-neighbor",),
            trace_dumps=(LEARN_TRACE,), device=where,
            noise_sources=lambda where=where: storm_noise(where)))
        faults.set_clock(None)
        wall.append(time.monotonic() - t0)
        check(all(fn.launches == 0 for fn in kernels.values()),
              "learn judge: the storm's tuned profile launched a kernel")
    card, host = out
    sides = ("heuristic", "learned")
    fps = [(r["name"], [r[s]["decision_fingerprint"] for s in sides],
            r["schedule_fingerprint"]) for r in card["scenarios"]]
    check(card["promote"] == host["promote"]
          and [r["passed"] for r in card["scenarios"]]
          == [r["passed"] for r in host["scenarios"]]
          and fps == [(r["name"], [r[s]["decision_fingerprint"]
                                   for s in sides], r["schedule_fingerprint"])
                      for r in host["scenarios"]],
          f"learn judge: the card and the CPU differ: {fps} vs "
          f"{[r[s]['decision_fingerprint'] for r in host['scenarios'] for s in sides]}")
    rec = {"phase": "learn-judge", "promote": card["promote"],
           "scenarios": {r["name"]: {"passed": r["passed"],
                                     "decision_fingerprints": f}
                         for (name, f, _), r in zip(fps, card["scenarios"])},
           "judgment_equal_in_full": card == host,
           "wall_s": {"card": wall[0], "cpu": wall[1]}}
    emit(rec)
    return rec


def learn_checkpoint(dev, kernels, tmp) -> dict:
    """(e): save_state on the card at M=256 after WAVES waves of phase 3's
    profile, restore into a fresh card Scheduler and into a CPU one (both
    exports bit-equal to the state saved), then a checkpoint without the
    Sinkhorn duals restores with them at ones."""
    from gie_tpu_torch.sched import Scheduler
    from gie_tpu_torch.sched.config import tuned_profile

    cfg, weights = tuned_profile()
    cfg = dataclasses.replace(cfg, use_pallas_sinkhorn=True)
    eps, wave = workload(dev)
    gpu = Scheduler(cfg, weights, device=dev, seed=14)
    for fn in kernels.values():
        fn.launches = 0
    for w in range(WAVES):
        res = gpu.pick(wave(w), eps)
        gpu.complete(res.indices[: N // 4, 0],
                     np.full((N // 4,), 0.25, np.float32))
    launches = {k: fn.launches for k, fn in kernels.items()}
    check(gpu.state.m == M, f"checkpoint: live bucket {gpu.state.m}")
    path = f"{tmp}/checkpoint"
    t0 = time.perf_counter()
    gpu.save_state(path)
    save_ms = (time.perf_counter() - t0) * 1e3
    saved = gpu.export_state()

    def same(got, what):
        same_export(got, saved, f"checkpoint: {what} against the saved state")

    restored = {}
    for where in (dev, torch.device("cpu")):
        fresh = Scheduler(cfg, weights, device=where)
        t0 = time.perf_counter()
        check(fresh.restore_state(path), f"checkpoint: restore on {where}")
        restored[where.type] = (time.perf_counter() - t0) * 1e3
        check(fresh.state.m == M, f"checkpoint: {where} bucket "
                                  f"{fresh.state.m}")
        same(fresh.export_state(), f"the restore on {where}")
    with np.load(f"{path}/{Scheduler._CHECKPOINT}") as z:
        legacy = {k: z[k] for k in z.files if k != "ot_v"}
    with open(f"{path}/{Scheduler._CHECKPOINT}", "wb") as f:
        np.savez(f, **legacy)
    fresh = Scheduler(cfg, weights, device=dev)
    check(fresh.restore_state(path), "checkpoint: the legacy restore")
    got = fresh.export_state()
    check(np.array_equal(got["ot_v"], np.ones((M,), np.float32)),
          "checkpoint: the legacy restore's duals are not ones")
    same({**got, "ot_v": saved["ot_v"]}, "the legacy restore")
    rec = {"phase": "learn-checkpoint", "m": M, "waves": WAVES,
           "launches": launches, "save_ms": save_ms,
           "restore_ms": restored, "bit_equal": ["cuda", "cpu"],
           "legacy_restore": True}
    emit(rec)
    return rec


def phase_learn(dev, kernels, tmp) -> dict:
    """Phase 14: (a) the learned scorer with the Sinkhorn kernel and (b)
    the random picker over phase 3's carried waves, each replayed on the
    CPU (phase_slice), with a learned wave's wall time beside the classic
    Sinkhorn wave's; (c) the runner under --scorer learned; (d) the judge,
    card against CPU; (e) checkpoints."""
    from gie_tpu_torch.sched.config import tuned_profile

    t_phase = time.perf_counter()
    art, cfg, weights = learned_profile()
    tuned, tuned_w = tuned_profile()
    classic = dataclasses.replace(tuned, use_pallas_sinkhorn=True)
    learned = phase_slice(dev, "learned+use_pallas_sinkhorn", cfg, weights,
                          kernels, "fused_sinkhorn_plan")
    random_ = phase_slice(dev, "tuned+random",
                          dataclasses.replace(tuned, picker="random"),
                          tuned_w, kernels, None)
    eps, wave = workload(dev)
    timed = [wave(WAVES + w) for w in range(LEARN_TIMED_WAVES)]
    timing = {"learned": timed_waves(dev, cfg, weights, eps, timed),
              "classic": timed_waves(dev, classic, tuned_w, eps, timed)}
    emit({"phase": "learn-timing", **timing})
    served = learn_runner(dev, kernels, art, tmp)
    judged = learn_judge(dev, kernels, art)
    ckpt = learn_checkpoint(dev, kernels, tmp)
    parts = (learned, random_, served, ckpt)
    launches = {k: sum(p["launches"][k] for p in parts) for k in kernels}
    summary = {"phase": "learn", "wall_s": time.perf_counter() - t_phase,
               "launches": launches,
               "learned_primary_agree": [learned["primary_agree"],
                                         learned["rows"]],
               "random_primary_agree": [random_["primary_agree"],
                                        random_["rows"]],
               "learned_wave_wall_ms": timing["learned"]["wall_ms_per_wave"],
               "classic_wave_wall_ms": timing["classic"]["wall_ms_per_wave"],
               "runner_answered": served["answered"],
               "judge_promote": judged["promote"]}
    emit(summary)
    return summary


# -- phase 15: HA replication, the file lease and the autoscale loop ---------

HA_TTL_S = 5.0             # LeaseFileElector's default lease TTL (the runner's)
HA_FAST_RENEW_S = 0.1      # (a)'s electors: renew interval
HA_REPLICATION_S = 0.5     # (b)'s --replication-interval-s
HA_STORMS = ("storm-capacity", "storm-soak")
# What a card storm and its CPU storm must also share in phase 15.
HA_STORM_FIELDS = ("autoscale_events", "failover_checks", "pool_size_trace")


def ha_waves(sched, cpu, reqs_list, eps, eps_cpu, cpu_waves, name, kernels,
             own, reinstall_first) -> dict:
    """`sched` picks each wave on the card, `cpu` replays it from the same
    state with the same noise (phase 3's rule: primaries equal wherever the
    CPU's top-two gap is 1e-4 or more); one launch of `own` a wave and
    complete() feedback for half of each. `reinstall_first` False keeps the
    CPU's own state for the first wave (a state restored from a digest)."""
    valid = eps.valid.cpu().numpy()
    base = kernels[own].launches
    agree = rows = allowed = 0
    for w, reqs in enumerate(reqs_list):
        if w or reinstall_first:
            cpu.install_state(sched.export_state())
        res = sched.pick(reqs, eps)
        check(kernels[own].launches == base + w + 1,
              f"{name}: {kernels[own].launches - base} launches after "
              f"{w + 1} waves")
        differ = compare_primaries(res, cpu.pick(cpu_waves[w], eps_cpu),
                                   valid, name)
        agree += int((~differ).sum())
        allowed += int(differ.sum())
        rows += len(differ)
        complete_half(sched, res, reqs)
    check(agree >= 0.999 * rows,
          f"{name}: primary picks agree on only {agree}/{rows} rows")
    return {"waves": len(reqs_list), "primary_agree": agree, "rows": rows,
            "differ_within_gap": allowed}


def ha_one_process(dev, cfg, weights, kernels, tmp) -> dict:
    """(a): a leader and a follower Scheduler on the card (tuned +
    use_pallas_sinkhorn, M=256), each with a ReplicationManager on loopback
    over one LeaseFileElector lease. The leader runs phase 3's 5 carried
    waves; the follower syncs, bit-equal to the leader and to a CPU
    Scheduler restored from the decoded digest; the leader's lease is
    released, the follower promotes and runs 5 more waves, each replayed on
    that CPU Scheduler with the same noise."""
    from gie_tpu_torch import convert
    from gie_tpu_torch.replication import (
        ReplicationManager,
        codec,
        follower as follower_mod,
        replication_identity,
    )
    from gie_tpu_torch.runtime.leader import LeaseFileElector
    from gie_tpu_torch.sched import Scheduler
    from gie_tpu_torch.sched.profile import gumbel_noise
    from gie_tpu_torch.sched.types import RequestBatch

    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    drawn = []

    def noise(shape):
        drawn.append(gumbel_noise(shape, gen, dev))
        return drawn[-1]

    leader = Scheduler(cfg, weights, device=dev, noise_source=noise)
    follower = Scheduler(cfg, weights, device=dev, noise_source=noise)
    cpu = Scheduler(cfg, weights, device="cpu",
                    noise_source=lambda shape: drawn[-1].cpu())
    eps, wave = workload(dev)
    eps_cpu = convert.endpoints_from_numpy(convert.endpoints_to_numpy(eps),
                                           device="cpu")
    waves = [wave(w) for w in range(2 * WAVES)]
    cpu_waves = [RequestBatch(**{f.name: getattr(r, f.name).cpu()
                                 for f in dataclasses.fields(RequestBatch)})
                 for r in waves]
    lease = f"{tmp}/ha-a.lease"
    managers, electors = {}, {}
    for role, sched in (("leader", leader), ("follower", follower)):
        mgr = managers[role] = ReplicationManager(scheduler=sched, era=role)
        el = electors[role] = LeaseFileElector(
            lease, identity=replication_identity(mgr.advertise, role),
            lease_ttl_s=HA_TTL_S, renew_interval_s=HA_FAST_RENEW_S)
        el.on_role_change = mgr.on_role_change
        mgr.attach_elector(el)
    try:
        electors["leader"].start()
        deadline = time.monotonic() + 10
        while (not electors["leader"].is_leader()
               and time.monotonic() < deadline):
            time.sleep(0.01)
        electors["follower"].start()
        time.sleep(3 * HA_FAST_RENEW_S)
        check(electors["leader"].is_leader()
              and not electors["follower"].is_leader(),
              "ha: the leader did not take the lease first")
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        led = ha_waves(leader, cpu, waves[:WAVES], eps, eps_cpu,
                       cpu_waves[:WAVES], "ha leader", kernels,
                       "fused_sinkhorn_plan", reinstall_first=True)
        t0 = time.perf_counter()
        exported = leader.export_state()
        export_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        section = codec.encode_section(exported)
        blob = codec.build_digest(1, {"sched": section})
        encode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        digest = codec.decode_digest(blob)
        decode_ms = (time.perf_counter() - t0) * 1e3
        check(digest is not None, "ha: the digest does not decode")
        now = time.monotonic()
        check(managers["leader"].step(now) == "published",
              "ha: the leader did not publish")
        outcome = managers["follower"].step(now)
        check(outcome == follower_mod.INSTALLED,
              f"ha: the follower's sync ended {outcome}")
        same_export(follower.export_state(), exported, "ha follower")
        check(cpu.install_state(digest.sections["sched"]),
              "ha: the CPU Scheduler refused the digest")
        same_export(cpu.export_state(), exported, "ha CPU from the digest")
        installed = managers["follower"].follower.installed_epoch
        t0 = time.monotonic()
        electors["leader"].stop()                  # releases the lease
        while (not electors["follower"].is_leader()
               and time.monotonic() - t0 < 2 * HA_TTL_S):
            time.sleep(0.001)
        promotion_s = time.monotonic() - t0
        check(electors["follower"].is_leader(),
              "ha: the follower did not promote after the release")
        check(managers["follower"].promoted_with_epoch == installed,
              "ha: the follower promoted without its installed epoch")
        promoted = ha_waves(follower, cpu, waves[WAVES:], eps, eps_cpu,
                            cpu_waves[WAVES:], "ha promoted follower",
                            kernels, "fused_sinkhorn_plan",
                            reinstall_first=False)
        launches = {k: fn.launches for k, fn in kernels.items()}
        check(launches["fused_sinkhorn_plan"] == 2 * WAVES,
              f"ha: {launches} launches for {2 * WAVES} waves")
        pub = managers["follower"]
        check(pub.step(time.monotonic()) == "published",
              "ha: the promoted follower did not publish")
    finally:
        for el in electors.values():
            el.stop()
        for mgr in managers.values():
            mgr.stop()
    rec = {"phase": "ha-replication", "digest_bytes": len(blob),
           "sched_section_bytes": len(section),
           "export_ms": export_ms, "encode_ms": encode_ms,
           "decode_ms": decode_ms,
           "install_ms": managers["follower"].follower.last_install_s * 1e3,
           "release_to_promotion_s": promotion_s,
           "leader": led, "promoted": promoted, "launches": launches}
    emit(rec)
    return rec


def ha_server_process(argv, fleet_port, n_pods, stop, stats) -> None:
    """A server in a process of its own: the runner main() builds from
    `argv`, over `n_pods` stub pods on fleet_port, until `stop` is set;
    then its kernel launches and dispatched waves go on `stats`. A SIGKILL
    ends it with nothing reported."""
    from gie_tpu_torch.ops.fused_sinkhorn import fused_sinkhorn_plan
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner

    runner = ExtProcServerRunner(
        server_options(argv), fleet_cluster("smoke", fleet_ips(n_pods),
                                            fleet_port))
    runner.setup()
    runner.start()
    stop.wait()
    stats.put({"launches": fused_sinkhorn_plan.launches,
               "waves": int(own_metrics.PIPELINE_WAVES.value())})
    runner.stop()


def metric_samples(port: int) -> dict:
    """/metrics of a server as {(name, labels): value}."""
    import urllib.request

    from gie_tpu_torch.metricsio.scrape import parse_sample_lines

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as resp:
        text = resp.read().decode()
    return {(s.name, tuple(sorted(s.labels.items()))): s.value
            for s in parse_sample_lines(text)}


def sample_sum(samples: dict, name: str) -> float:
    return sum(v for (n, _l), v in samples.items() if n == name)


def ha_burst(ctx, port, rounds, procs) -> list:
    """CLIENTS client processes over `port`, one round of
    STREAMS_PER_ROUND streams each in `rounds`: -> [(a round's outcomes,
    its wall seconds)] in round order."""
    barrier, results = ctx.Barrier(CLIENTS + 1), ctx.Queue()
    for k in range(CLIENTS):
        procs.append(ctx.Process(
            target=client_process,
            args=(port, CHANNELS // CLIENTS, rounds, k, STREAMS_PER_ROUND,
                  barrier, results), daemon=True))
        procs[-1].start()
    out = []
    for w in rounds:
        barrier.wait(600)
        got = [results.get(timeout=900) for _ in range(CLIENTS)]
        check(all(g[0] == w for g in got), "ha burst: rounds out of step")
        outcomes = [o for g in got for o in g[1]]
        errs = [o[4] for o in outcomes if o[4]]
        check(not errs, f"ha burst: {len(errs)} streams failed, first: "
                        f"{errs[:1]}")
        out.append((outcomes, max(g[3] for g in got) - min(g[2] for g in got)))
    return out


def prompt_endpoints(rounds) -> dict:
    """System prompt -> {primary endpoint: streams} of rounds' answers
    ([(round, outcomes)])."""
    out: dict = {}
    for w, outcomes in rounds:
        for i, dest, *_ in outcomes:
            if dest is not None:
                ep = dest.split(",")[0]
                k = (i + w) % 16
                out.setdefault(k, {})
                out[k][ep] = out[k].get(ep, 0) + 1
    return out


def ha_failover(cfg, weights, tmp) -> dict:
    """(b): two server processes built from the real flags (--leader-elect
    --leader-lease-path --replication-port, --autoscale-mode recommend,
    phase 6's scheduler config) over M stub pods. The leader answers a
    warm-up round and a burst; the follower's replication sub-service reads
    SERVING with an epoch lag of at most 1; the leader is SIGKILLed; the
    follower's readiness reads SERVING within the lease TTL plus 5 s and it
    answers a burst, none lost, the ladder at FULL, each system prompt's
    streams landing mostly where the leader's picks put it."""
    need_transport()
    import multiprocessing

    from gie_tpu_torch.runtime.health import NOT_SERVING, SERVING

    ctx = multiprocessing.get_context("spawn")
    stop_fleet, ready = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=stub_fleet_process,
                         args=(M, 0, ready, stop_fleet), daemon=True)]
    procs[0].start()
    servers = {}
    lease = f"{tmp}/ha-b.lease"
    try:
        fleet_port = ready.get(timeout=120)
        config = write_scheduler_config(cfg, weights, tmp)
        t_start = time.monotonic()
        for name in ("a", "b"):
            ports = {k: free_port() for k in
                     ("grpc", "health", "metrics", "replication")}
            argv = ["--insecure-serving", "--scheduler-config", config,
                    "--pool-name", "smoke",
                    "--grpc-port", str(ports["grpc"]),
                    "--grpc-health-port", str(ports["health"]),
                    "--metrics-port", str(ports["metrics"]),
                    "--extproc-workers", str(EXTPROC_WORKERS),
                    "--scrape-interval-ms", str(SCRAPE_INTERVAL_MS),
                    "--leader-elect", "--leader-lease-path", lease,
                    "--replication-port", str(ports["replication"]),
                    "--replication-interval-s", str(HA_REPLICATION_S),
                    "--autoscale-mode", "recommend",
                    "--autoscale-interval-s", "1.0",
                    "--autoscale-max", str(4 * M)]
            stop, stats = ctx.Event(), ctx.Queue()
            proc = ctx.Process(target=ha_server_process,
                               args=(argv, fleet_port, M, stop, stats),
                               daemon=True)
            proc.start()
            servers[name] = {"proc": proc, "stop": stop, "stats": stats,
                             **ports}
            if name == "a":             # a takes the lease before b starts
                deadline = time.monotonic() + 300
                status = None
                while time.monotonic() < deadline and proc.is_alive():
                    try:
                        status = health_status(ports["health"], "readiness")
                    except Exception:
                        status = None
                    if status == SERVING:
                        break
                    time.sleep(0.2)
                check(status == SERVING, "ha: server a never became ready")
        leader, standby = servers["a"], servers["b"]
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and standby["proc"].is_alive():
            try:
                if (health_status(standby["health"], "liveness") == SERVING):
                    break
            except Exception:
                pass
            time.sleep(0.2)
        check(health_status(standby["health"], "readiness") == NOT_SERVING,
              "ha: the standby's readiness is not NOT_SERVING")
        startup_s = time.monotonic() - t_start
        time.sleep(2.0)                 # every pod scraped by both
        (warm, _), (led, led_wall) = ha_burst(ctx, leader["grpc"], [-1, 0],
                                              procs)    # -1: warm-up
        live = {f"{ip}:{fleet_port}" for ip in fleet_ips(M)}
        check(all(o[1] is not None and o[1].split(",")[0] in live
                  for o in led), "ha: the leader left a stream unanswered")
        # The standby syncs the state the burst left (interval 0.5 s).
        deadline = time.monotonic() + 30
        while True:
            lag_samples = metric_samples(standby["metrics"])
            lag = sample_sum(lag_samples, "gie_replication_epoch_lag")
            repl = health_status(standby["health"], "replication")
            if (repl == SERVING and lag <= 1) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        check(repl == SERVING, "ha: the standby's replication sub-service "
                               "is not SERVING")
        check(lag <= 1, f"ha: the standby's epoch lag is {lag}")
        epoch = sample_sum(lag_samples, "gie_replication_epoch")
        leader_metrics = metric_samples(leader["metrics"])
        for name in ("gie_autoscale_desired_replicas",
                     "gie_autoscale_recommendations_total"):
            check(any(n == name for n, _ in leader_metrics),
                  f"ha: the leader's /metrics lacks {name}")
        desired = sample_sum(leader_metrics, "gie_autoscale_desired_replicas")
        recs = sample_sum(leader_metrics,
                          "gie_autoscale_recommendations_total")
        check(recs >= 1, "ha: the leader's autoscale loop recommended "
                         "nothing")
        time.sleep(2 * HA_REPLICATION_S)   # a last sync of the settled load
        t_kill = time.monotonic()
        leader["proc"].kill()
        leader["proc"].join(30)
        status = None
        while time.monotonic() - t_kill < HA_TTL_S + 5.0:
            try:
                status = health_status(standby["health"], "readiness")
            except Exception:
                status = None
            if status == SERVING:
                break
            time.sleep(0.05)
        failover_s = time.monotonic() - t_kill
        check(status == SERVING, f"ha: the standby not ready "
                                 f"{failover_s:.1f} s after the SIGKILL")
        deg0 = sample_sum(metric_samples(standby["metrics"]),
                          "gie_degraded_picks_total")
        ((took, took_wall),) = ha_burst(ctx, standby["grpc"], [1], procs)
        answered = sum(o[1] is not None and o[1].split(",")[0] in live
                       for o in took)
        check(answered == STREAMS_PER_ROUND,
              f"ha: the promoted standby answered {answered} of "
              f"{STREAMS_PER_ROUND}")
        after = metric_samples(standby["metrics"])
        degraded = sample_sum(after, "gie_degraded_picks_total") - deg0
        check(degraded == 0 and sample_sum(after, "gie_degraded_mode") == 0,
              f"ha: the promoted standby left FULL ({degraded} degraded "
              "picks)")
        check(health_status(standby["health"], "resilience") == SERVING,
              "ha: the promoted standby's resilience sub-service is not "
              "SERVING")
        # Prefix state came across: each system prompt's streams land
        # mostly on the endpoints the leader put it on (in either of its
        # rounds: every pick stored the prompt's chunks there). `spread`
        # is the share a standby with a cold prefix table would reach by
        # chance.
        before = prompt_endpoints([(-1, warm), (0, led)])
        now_ = prompt_endpoints([(1, took)])
        same = sum(n for k, eps_ in now_.items() for ep, n in eps_.items()
                   if ep in before.get(k, {}))
        share = same / max(sum(sum(e.values()) for e in now_.values()), 1)
        spread = statistics.mean(len(v) for v in before.values()) / M
        check(share > 0.5, f"ha: only {share:.3f} of the promoted standby's "
                           "streams landed where the leader put their "
                           "system prompt")
        standby["stop"].set()
        stats = standby["stats"].get(timeout=120)
        check(stats["launches"] == stats["waves"] >= 1,
              f"ha: the promoted standby's {stats['launches']} Sinkhorn "
              f"launches for {stats['waves']} waves")
        standby["proc"].join(60)
    finally:
        stop_fleet.set()
        for srv in servers.values():
            # Never set the event a SIGKILLed server waited on: notify()
            # waits for that sleeper to wake, which it never will.
            if srv["proc"].is_alive():
                srv["stop"].set()
                srv["proc"].join(30)
            if srv["proc"].is_alive():
                srv["proc"].kill()
                srv["proc"].join(10)
        for proc in procs:
            proc.join(30)
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    rec = {"phase": "ha-failover", "startup_s": startup_s,
           "leader_streams_per_s": STREAMS_PER_ROUND / led_wall,
           "standby_epoch": epoch, "standby_epoch_lag": lag,
           "autoscale_desired": desired, "autoscale_recommendations": recs,
           "failover_s": failover_s, "promoted_answered": answered,
           "promoted_streams_per_s": STREAMS_PER_ROUND / took_wall,
           "prefix_share": share, "leader_prompt_spread": spread,
           "promoted_waves": stats["waves"],
           "launches": {"fused_sinkhorn_plan": stats["launches"],
                        "fused_blend_topk": 0}}
    emit(rec)
    return rec


def ha_storms(dev, kernels) -> dict:
    """(c): storm-capacity and storm-soak under virtual time on the card
    and on a CPU engine with noise from one seeded CPU generator:
    decisions, the autoscale steps, the standby probes and the in-storm
    fault counts equal."""
    cpu = torch.device("cpu")
    out = {}
    for name in HA_STORMS:
        on_card = storm_run(name, dev, kernels)
        on_cpu = storm_run(name, cpu, kernels)
        same_storm(on_card, on_cpu, HA_STORM_FIELDS)
        card = on_card["scorecard"]
        if name == "storm-capacity":
            check(card["autoscale_events"] and card["client_5xx"] == 0,
                  f"ha {name}: no autoscale step or client 5xx: "
                  f"{card['autoscale_events']}")
        else:
            checks = card["failover_checks"]
            check(checks and all(c["ok"] for c in checks),
                  f"ha {name}: standby probes {checks}")
        out[name] = {"wall_s": on_card["rec"]["wall_s"],
                     "cpu_wall_s": on_cpu["rec"]["wall_s"],
                     "waves": on_card["rec"]["waves"],
                     "autoscale_events": len(card["autoscale_events"]),
                     "failover_checks": len(card["failover_checks"])}
    rec = {"phase": "ha-storms", **out}
    emit(rec)
    return rec


def phase_ha(dev, cfg, weights, kernels, tmp) -> dict:
    """Phase 15: (a) replication in one process, (b) failover through the
    real flags in two server processes, (c) the autoscale storms."""
    t0 = time.monotonic()
    one = ha_one_process(dev, cfg, weights, kernels, tmp)
    two = ha_failover(cfg, weights, tmp)
    storms = ha_storms(dev, kernels)
    launches = {k: one["launches"].get(k, 0) + two["launches"].get(k, 0)
                for k in kernels}
    summary = {"phase": "ha", "wall_s": time.monotonic() - t0,
               "launches": launches,
               "digest_bytes": one["digest_bytes"],
               "failover_s": two["failover_s"],
               "storm_wall_s": {k: v["wall_s"] for k, v in storms.items()
                                if k != "phase"}}
    emit(summary)
    return summary


# -- phase 16: multi-cluster federation --------------------------------------

FED_WEST_PODS, FED_EAST_PODS = 64, 192   # together the north star's M=256
FED_QUEUE_LIMIT = 16.0     # phase 16's profile: a stub queue this long saturates
FED_INTERVAL_S = 0.2       # --fed-interval-s of both servers
FED_WAIT_S = 1.0           # east's --fed-wait-s (the long poll's window)
FED_LOCAL_ONLY_S = 10.0    # the runner's default --fed-local-only-after-s
FED_STORMS = ("storm-fed-spill", "storm-fed-drain", "storm-fed-partition")
FED_ROUNDS = ("warm-up", "local", "spill", "prefix", "drain", "partition",
              "heal")


def fed_band(i: int) -> str:
    """Stream i's criticality band in phase 16: 1 in 16 CRITICAL, 1 in 16
    SHEDDABLE, the rest STANDARD (no objective header)."""
    return {0: "critical", 1: "sheddable"}.get(i % 16, "")


def fed_stream(method, w, i):
    """one_stream for phase 16: stream i carries fed_band(i)."""
    return one_stream(method, w, i, fed_band(i))


async def fed_aio_stream(method, w, i):
    """aio_stream for phase 16's client processes: stream i carries
    fed_band(i)."""
    return await aio_stream(method, w, i, fed_band(i))


def fed_server_process(argv, fleet_port, ips, era_seq, stop, ready) -> None:
    """A federation server in a process of its own: the runner main()
    builds from `argv` over the pods at `ips` on fleet_port. With
    `era_seq` its exchange mints that era before it serves (a restarted
    peer EPP's new lineage). Puts its exchange's era on `ready` once it
    serves; runs until `stop` is set or it is killed."""
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner

    runner = ExtProcServerRunner(
        server_options(argv), fleet_cluster("west", ips, fleet_port))
    if era_seq:
        runner.fed_exchange.publisher.bump_era(seq=era_seq)
        runner.fed_exchange.refresh()
    runner.setup()
    runner.start()
    ready.put(list(runner.fed_exchange.publisher.era))
    stop.wait()
    runner.stop()


def fed_digest(port: int) -> dict:
    """A federation exchange's full digest, decoded by the port's codec:
    {section: arrays}."""
    import urllib.request

    from gie_tpu_torch.replication import codec

    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/federation/digest", timeout=30) as r:
        digest = codec.decode_digest(r.read())
    check(digest is not None, "fed: west's digest does not decode")
    return digest.sections


def fed_fold_share(export: dict, keys: np.ndarray, slots) -> float:
    """The share of `keys` whose prefix-table row has every slot of
    `slots` present in an exported scheduler state."""
    table = export["prefix_keys"].reshape(-1)
    present = export["prefix_present"].reshape(table.shape[0], -1)
    rows = {int(k): r for r, k in enumerate(table) if k}
    hit = 0
    for k in keys.tolist():
        r = rows.get(int(k))
        if r is not None and all(
                (int(present[r, s // 32]) >> (s % 32)) & 1 for s in slots):
            hit += 1
    return hit / max(len(keys), 1)


def fed_capture(runner):
    """Arm a capture of east's next dispatched wave: its batches, the
    state it started from (exported just before it) and its Gumbel noise.
    -> (arm(), captured dict)."""
    from gie_tpu_torch.sched.profile import gumbel_noise

    sched = runner.scheduler
    orig = sched.pick_async
    cap, armed = {}, threading.Event()
    gen = torch.Generator(device=sched.device)
    gen.manual_seed(16)

    def noise(shape):
        cap["noise"] = gumbel_noise(shape, gen, sched.device)
        return cap["noise"]

    def pick_async(reqs, eps, **kw):
        if not armed.is_set():
            return orig(reqs, eps, **kw)
        armed.clear()
        cap["state"] = sched.export_state()
        cap["reqs"], cap["eps"] = reqs, eps
        sched.noise_source = noise
        try:
            cap["wave"] = orig(reqs, eps, **kw)
        finally:
            sched.noise_source = None
        return cap["wave"]

    sched.pick_async = pick_async
    return armed.set, cap


def fed_replay(cap, cfg, weights, name) -> dict:
    """The captured card wave replayed on a CPU Scheduler from the same
    state with the same noise: phase 3's primary rule."""
    from gie_tpu_torch.sched import Scheduler

    check("wave" in cap, f"{name}: no wave was captured")
    noise = cap["noise"].cpu()
    cpu = Scheduler(cfg, weights, device="cpu",
                    noise_source=lambda shape: noise)
    cpu.install_state(cap["state"])
    res = cap["wave"].materialize()
    ref = cpu.pick(cap["reqs"], cap["eps"])
    valid = cap["eps"].valid.cpu().numpy()
    differ = compare_primaries(res, ref, valid, name)
    remote = int(valid[FED_EAST_PODS:].sum())
    check(remote == FED_WEST_PODS,
          f"{name}: the captured wave holds {remote} imported slots")
    return {"replay_rows": int(len(differ)),
            "replay_primaries_equal": int((~differ).sum()),
            "replay_primary": int(res.indices[0, 0])}


def fed_east_process(argv, fleet_port, ips, cfg, weights, cmds,
                     replies) -> None:
    """East, in a process of its own: the runner main() builds from
    `argv` over the pods at `ips` on fleet_port, on the card. Answers the
    phase's commands from `cmds` on `replies` (a failure as ("error",
    text)) until "stop"."""
    import traceback

    from gie_tpu_torch.ops.fused_sinkhorn import fused_sinkhorn_plan
    from gie_tpu_torch.ops.fused_topk import fused_blend_topk
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner

    kernels = {"fused_sinkhorn_plan": fused_sinkhorn_plan,
               "fused_blend_topk": fused_blend_topk}
    try:
        runner = ExtProcServerRunner(
            server_options(argv), fleet_cluster("east", ips, fleet_port))
        sched, fed = runner.scheduler, runner.federation
        check(sched.device.type == "cuda" and sched.cfg.use_pallas_sinkhorn
              and runner.picker.federation is fed,
              f"fed: east's scheduler on {sched.device}, federation wired "
              f"{runner.picker.federation is fed}")
        arm, cap = fed_capture(runner)
        runner.setup()
        runner.start()
        link = runner.fed_exchange.links["west"]
        local = [e.slot for e in runner.datastore.local_endpoints()]
        base = {}
    except Exception:
        replies.put(("error", traceback.format_exc()))
        return
    replies.put(("ready", runner.grpc_server.port))

    def imported():
        eps = [e for e in runner.datastore.endpoints() if e.cluster == "west"]
        return {"hostports": sorted(e.hostport for e in eps),
                "slots": sorted(e.slot for e in eps), "local": len(local),
                "scraped": bool(np.isfinite(
                    runner.metrics_store.pool_rows(local)[1]).all())}

    def reset():
        for t in runner.picker._warm_threads:
            t.join(300)
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        base.update(waves=own_metrics.PIPELINE_WAVES.value(),
                    inline=sched.debug_report()["warm_inline_compiles"])
        return base["inline"]

    def peer():
        view = fed._peers["west"]
        return {"local_only": view.local_only,
                "local_only_spells": view.local_only_spells,
                "rung_moves": len(runner.resilience.ladder.transitions),
                "local_only_metric": own_metrics.FED_LOCAL_ONLY.value("west"),
                "installed_era": list(link.installed_era or ()),
                "era_flips": link.era_flips,
                "spills": sum(own_metrics.FED_SPILL.value("west", b)
                              for b in ("critical", "standard",
                                        "sheddable"))}

    def report():
        for t in runner.picker._warm_threads:
            t.join(300)
        return {"inline_captures_after_warmup":
                    sched.debug_report()["warm_inline_compiles"]
                    - base["inline"],
                "waves": int(own_metrics.PIPELINE_WAVES.value()
                             - base["waves"]),
                "launches": {k: fn.launches for k, fn in kernels.items()},
                "matrix": fed.capacity_matrix(), "link": link.report()}

    commands = {
        "imported": imported, "reset": reset, "peer": peer,
        "report": report, "arm": arm,
        "saturated": lambda limit: bool((
            runner.metrics_store.host_queue_depths()[local] >= limit).all()),
        "fold": lambda keys, slots: fed_fold_share(
            sched.export_state(), keys, slots),
        "replay": lambda: fed_replay(cap, cfg, weights, "fed replay"),
        "drain": runner.fed_exchange.set_draining,
    }
    try:
        while True:
            cmd, args = cmds.get()
            if cmd == "stop":
                break
            try:
                replies.put(("ok", commands[cmd](*args)))
            except Exception:
                replies.put(("error", traceback.format_exc()))
    finally:
        runner.stop()
        replies.put(("stopped", None))


def fed_until(pred, timeout: float, probe=None, every: float = 0.1) -> float:
    """Seconds until `pred()` holds (calling `probe` between reads), or
    fail after `timeout`."""
    t0 = time.monotonic()
    while not pred():
        check(time.monotonic() - t0 < timeout,
              f"fed: condition not met within {timeout} s")
        if probe is not None:
            probe()
        time.sleep(every)
    return time.monotonic() - t0


def fed_servers(dev, cfg, weights, kernels, tmp) -> dict:
    """(a): two server processes built from the real flags on the card,
    with phase 6's profile at queue_limit FED_QUEUE_LIMIT: west over
    FED_WEST_PODS stub pods (--fed-cluster west --fed-port) and east over
    FED_EAST_PODS (--fed-peer west=...; tenant-0 traced to an OTLP sink).
    East takes a warm-up round and then a burst per state: local
    (nothing spills), spill (every east slot saturated: non-CRITICAL
    picks land on west, CRITICAL stays home, gie_federation_spill_total
    counts them), prefix (west's hot keys folded against every west slot
    of east's table; spilled sessions stick to the west pods that served
    them), drain, partition (west SIGKILLed: east local-only, sheds only
    in the sheddable band) and heal (west restarted with a greater era and
    readmitted). One spilled wave is replayed on a CPU scheduler in east's
    process."""
    need_transport()
    import multiprocessing

    from gie_tpu_torch.federation import summary as fed_summary

    ctx = multiprocessing.get_context("spawn")
    stop_fleets, floor = ctx.Event(), ctx.Value("d", 0.0)
    ready_w, ready_e = ctx.Queue(), ctx.Queue()
    west_ips = fleet_ips(FED_WEST_PODS, first=FED_EAST_PODS)
    east_ips = fleet_ips(FED_EAST_PODS)
    procs = [ctx.Process(target=stub_fleet_process,
                         args=(FED_WEST_PODS, 1, ready_w, stop_fleets),
                         kwargs={"first": FED_EAST_PODS}, daemon=True),
             ctx.Process(target=stub_fleet_process,
                         args=(FED_EAST_PODS, 0, ready_e, stop_fleets),
                         kwargs={"floor": floor}, daemon=True)]
    for proc in procs:
        proc.start()
    east, west, sink, chans = None, None, None, []
    cmds, replies = ctx.Queue(), ctx.Queue()
    cfg16 = dataclasses.replace(cfg, queue_limit=FED_QUEUE_LIMIT)
    rec = {"phase": "fed-servers", "queue_limit": FED_QUEUE_LIMIT,
           "west_pods": FED_WEST_PODS, "east_pods": FED_EAST_PODS}

    def call(cmd, *args, timeout=300):
        cmds.put((cmd, args))
        kind, value = replies.get(timeout=timeout)
        check(kind == "ok", f"fed: east's {cmd} failed: {value}")
        return value

    try:
        west_fleet, east_fleet = (ready_w.get(timeout=120),
                                  ready_e.get(timeout=120))
        config = write_scheduler_config(cfg16, weights, tmp)
        fed_port = free_port()

        def common(pool):
            return ["--insecure-serving", "--scheduler-config", config,
                    "--pool-name", pool, "--grpc-port", str(free_port()),
                    "--grpc-health-port", str(free_port()),
                    "--metrics-port", str(free_port()),
                    "--extproc-workers", str(EXTPROC_WORKERS),
                    "--scrape-interval-ms", str(SCRAPE_INTERVAL_MS),
                    "--fed-interval-s", str(FED_INTERVAL_S)]

        def start_west(era_seq):
            argv = common("west") + ["--fed-cluster", "west",
                                     "--fed-port", str(fed_port)]
            stop, ready = ctx.Event(), ctx.Queue()
            proc = ctx.Process(target=fed_server_process,
                               args=(argv, west_fleet, west_ips, era_seq,
                                     stop, ready), daemon=True)
            proc.start()
            return {"proc": proc, "stop": stop, "ready": ready,
                    "grpc": int(argv[argv.index("--grpc-port") + 1])}

        t_start = time.monotonic()
        west = start_west(None)
        sink, sink_port, spans = otlp_sink()
        argv = common("east") + [
            "--fed-cluster", "east",
            "--fed-peer", f"west=http://127.0.0.1:{fed_port}",
            "--fed-wait-s", str(FED_WAIT_S),
            "--obs-sample-rate", "0", "--obs-tenant-sample", "tenant-0=1.0",
            "--obs-otlp-endpoint", f"http://127.0.0.1:{sink_port}"]
        west_era = west["ready"].get(timeout=300)
        east = ctx.Process(target=fed_east_process,
                           args=(argv, east_fleet, east_ips, cfg16, weights,
                                 cmds, replies), daemon=True)
        east.start()
        kind, east_port = replies.get(timeout=300)
        check(kind == "ready", f"fed: east did not start: {east_port}")
        east_hp = {f"{ip}:{east_fleet}" for ip in east_ips}
        west_hp = {f"{ip}:{west_fleet}" for ip in west_ips}
        fed_until(lambda: (lambda r: set(r["hostports"]) == west_hp
                           and r["scraped"])(call("imported")), 60,
                  every=0.2)
        got = call("imported")
        west_slots = got["slots"]
        check(got["local"] == FED_EAST_PODS and west_slots == list(
            range(FED_EAST_PODS, M)), f"fed: {got['local']} local slots, "
                                      f"west {west_slots[:3]}...")
        rec["startup_s"] = time.monotonic() - t_start
        # West serves a burst of its own: its prefix table then holds the
        # sixteen system prompts, which its exchange publishes.
        (west_out, _), = ha_burst(ctx, west["grpc"], [-1], procs)
        check(all(o[1] is not None and o[1].split(",")[0] in west_hp
                  for o in west_out), "fed: west left a stream unanswered")

        barrier, results = ctx.Barrier(CLIENTS + 1), ctx.Queue()
        for k in range(CLIENTS):
            procs.append(ctx.Process(
                target=client_process,
                args=(east_port, CHANNELS // CLIENTS,
                      list(range(-1, len(FED_ROUNDS) - 1)), k,
                      STREAMS_PER_ROUND, barrier, results, fed_aio_stream),
                daemon=True))
            procs[-1].start()
        chans, methods = open_channels(east_port, 1)
        probe_n = [0]

        def probe():
            """A stream of its own: a one-request wave, with which the
            picker's per-wave federation tick runs."""
            probe_n[0] += 1
            fed_stream(methods[0], 90, 16 * probe_n[0] + 2)

        rounds, timing = {}, {}
        for w, state in zip(range(-1, len(FED_ROUNDS) - 1), FED_ROUNDS):
            t_state = time.monotonic()
            if state == "local":
                call("reset")
            elif state == "spill":
                floor.value = FED_QUEUE_LIMIT + 4
                timing["saturate_s"] = fed_until(
                    lambda: call("saturated", FED_QUEUE_LIMIT), 60)
                spills0 = call("peer")["spills"]
            elif state == "prefix":
                # West's hot keys, as its exchange publishes them, folded
                # against every west slot of east's device prefix table.
                west_keys = fed_summary.decode_prefix(
                    fed_digest(fed_port).get(fed_summary.PREFIX_SECTION))
                check(west_keys is not None and len(west_keys) > 0,
                      "fed: west published no hot prefix key")
                timing["fold_s"] = fed_until(lambda: call(
                    "fold", west_keys, west_slots) >= 0.9, 20, every=0.2)
                rec["west_hot_keys"] = int(len(west_keys))
                rec["fold_share"] = call("fold", west_keys, west_slots)
            elif state == "drain":
                call("arm")
                probe()
                rec.update(call("replay"))
                call("drain", True)
            elif state == "partition":
                call("drain", False)
                west["proc"].kill()
                west["proc"].join(30)
                timing["local_only_s"] = fed_until(
                    lambda: call("peer")["local_only"], 30, probe)
                fed_until(lambda: call("peer")["local_only_metric"] == 1.0,
                          5)
                check(timing["local_only_s"] <= FED_LOCAL_ONLY_S
                      + FED_WAIT_S + FED_INTERVAL_S + 0.5,
                      f"fed: local-only {timing['local_only_s']:.2f} s after "
                      "the SIGKILL")
            elif state == "heal":
                t_restart = time.monotonic()
                west = start_west(2)
                healed_era = west["ready"].get(timeout=300)
                timing["west_restart_s"] = time.monotonic() - t_restart
                timing["readmit_s"] = fed_until(
                    lambda: (lambda p: not p["local_only"]
                             and p["installed_era"] == healed_era)(
                        call("peer")), 60, probe)
                check(healed_era > west_era and call("peer")["era_flips"]
                      >= 1, f"fed: era {west_era} -> {healed_era}")
                check(set(call("imported")["hostports"]) == west_hp,
                      "fed: west's endpoints were not admitted again")
            timing[f"{state}_setup_s"] = time.monotonic() - t_state
            before = call("peer")
            barrier.wait(600)
            got = [results.get(timeout=900) for _ in range(CLIENTS)]
            check(all(g[0] == w for g in got), "fed: rounds out of step")
            outcomes = [o for g in got for o in g[1]]
            errs = [o[4] for o in outcomes if o[4]]
            check(not errs, f"fed {state}: {len(errs)} streams failed, "
                            f"first: {errs[:1]}")
            wall = max(g[3] for g in got) - min(g[2] for g in got)
            rounds[state] = (outcomes, wall)
            after = call("peer")
            # What moved during the round: a local-only spell or a ladder
            # move explains picks on the wrong cluster.
            moved = {k: after[k] - before[k]
                     for k in ("local_only_spells", "rung_moves")}
            emit({"phase": "fed-round", "state": state, "wall_s": wall,
                  **moved})
            prim = [(i, o.split(",")[0]) for i, o, *_ in outcomes]
            sheds = [(i, p) for i, p in prim if p.startswith("<")]
            if state == "partition":
                off = [(i, p) for i, p in sheds
                       if fed_band(i) != "sheddable" or p != "<429>"]
                check(not off, f"fed partition: sheds outside the "
                               f"sheddable band: {off[:3]}")
            else:
                check(not sheds, f"fed {state}: {len(sheds)} streams shed: "
                                 f"{sheds[:3]}")
            picked = [(i, p) for i, p in prim if not p.startswith("<")]
            home = {"warm-up": east_hp, "local": east_hp, "drain": west_hp,
                    "partition": east_hp}.get(state)
            bad = [(i, p) for i, p in picked
                   if p not in (home if home is not None else
                                east_hp if fed_band(i) == "critical"
                                else west_hp)]
            check(not bad, f"fed {state}: {len(bad)} picks on the wrong "
                           f"cluster: {bad[:3]}; during the round {moved}")
            if state == "prefix":
                rec["spill_total_delta"] = call("peer")["spills"] - spills0
            rec[f"{state}_streams_per_s"] = len(outcomes) / wall
            rec[f"{state}_sheds"] = len(sheds)
        spilled = sum(p.split(",")[0] in west_hp
                      for st in ("spill", "prefix")
                      for _, p, *_ in rounds[st][0])
        check(rec["spill_total_delta"] == spilled,
              f"fed: gie_federation_spill_total moved "
              f"{rec['spill_total_delta']} for {spilled} spilled streams")
        # Each system prompt's spilled streams land where its first spill
        # round put it; `chance` is the share a cold prefix table would
        # reach (the prompt's distinct west pods over all of them).
        before = prompt_endpoints([(FED_ROUNDS.index("spill") - 1,
                                    rounds["spill"][0])])
        after = prompt_endpoints([(FED_ROUNDS.index("prefix") - 1,
                                   rounds["prefix"][0])])
        before = {k: {e: n for e, n in v.items() if e in west_hp}
                  for k, v in before.items()}
        after = {k: {e: n for e, n in v.items() if e in west_hp}
                 for k, v in after.items()}
        same = sum(n for k, eps_ in after.items() for ep, n in eps_.items()
                   if ep in before.get(k, {}))
        rec["prefix_share"] = same / max(
            sum(sum(e.values()) for e in after.values()), 1)
        rec["prefix_chance"] = statistics.mean(
            len(v) for v in before.values() if v) / FED_WEST_PODS
        check(rec["prefix_share"] > rec["prefix_chance"],
              f"fed: spilled sessions stick to their west pods at "
              f"{rec['prefix_share']:.3f}, chance {rec['prefix_chance']:.3f}")
        # The spilled tenant-0 streams' traces carry the federation hop.
        timing["otlp_s"] = fed_until(lambda: any(
            sp.get("name") == "gie.federation" for sp in list(spans)), 30)
        rec["otlp_federation_spans"] = sum(
            sp.get("name") == "gie.federation" for sp in list(spans))
        report = call("report")
        check(report["inline_captures_after_warmup"] == 0,
              f"fed: {report['inline_captures_after_warmup']} inline "
              "captures after the warm-up round")
        check(report["launches"]["fused_sinkhorn_plan"] == report["waves"]
              >= 1, f"fed: {report['launches']} kernel launches for "
                    f"{report['waves']} waves")
        rec.update(report)
        rec.update(timing)
        rec["round_wall_s"] = {k: v[1] for k, v in rounds.items()}
        rec["east_era"] = call("peer")["installed_era"]
        cmds.put(("stop", ()))
        check(replies.get(timeout=120)[0] == "stopped",
              "fed: east did not stop")
        east.join(60)
    finally:
        stop_fleets.set()
        for c in chans:
            c.close()
        for srv in (west,):
            if srv is not None and srv["proc"].is_alive():
                srv["stop"].set()
                srv["proc"].join(30)
        if east is not None and east.is_alive():
            cmds.put(("stop", ()))
            east.join(60)
        if sink is not None:
            sink.shutdown()
        for proc in procs + [p for p in (east, west and west["proc"]) if p]:
            proc.join(30)
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    emit(rec)
    return rec


# Link fields that move after run() releases the clock: the staleness,
# the counts of polls and installs (after a flipped-era heal the old
# lineage's answers are rejected ones; a late refresh of the peer moves
# its epoch), as tests/test_torch_storm_fed.py leaves them out.
FED_LATE_LINK = ("staleness_s", "rejects", "era_regressions", "installs",
                 "installed_epoch", "peer_epoch")


def fed_without_late_reads(card: dict) -> dict:
    """A storm's federation block without what the scorer reads on the
    clock after run() released it (FED_LATE_LINK; each row's queue total,
    from the last scrape or install; each peer row's staleness and the
    effective penalty derived from it) and with each era as its sequence
    number (a flipped era's token is a fresh random draw in every run)."""
    fed = dict(card["federation"])
    link = {k: v for k, v in fed["link"].items() if k not in FED_LATE_LINK}
    if link.get("installed_era"):
        link["installed_era"] = link["installed_era"][0]
    fed["link"] = link
    fed["peer_era"] = fed["peer_era"][0]
    fed["matrix"] = {
        name: {k: (v[0] if k == "era" and v else v) for k, v in row.items()
               if k != "queue_total"
               and (row["local"] or k not in ("staleness_s", "penalty"))}
        for name, row in fed["matrix"].items()}
    return fed


def fed_storms(dev, kernels) -> dict:
    """(b): storm-fed-spill, -drain and -partition under virtual time on
    the card and on a CPU engine with noise from one seeded CPU generator:
    decisions, the per-cluster picks and serves, the local-only timeline
    and the federation events equal."""
    cpu = torch.device("cpu")
    out = {}
    for name in FED_STORMS:
        on_card = storm_run(name, dev, kernels)
        on_cpu = storm_run(name, cpu, kernels)
        same_storm(on_card, on_cpu)
        a, b = (fed_without_late_reads(r["scorecard"])
                for r in (on_card, on_cpu))
        differ = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        check(not differ, f"fed storm {name}: the card and the CPU differ "
                          f"in federation {differ}")
        fed = on_card["scorecard"]["federation"]
        out[name] = {"wall_s": on_card["rec"]["wall_s"],
                     "cpu_wall_s": on_cpu["rec"]["wall_s"],
                     "waves": on_card["rec"]["waves"],
                     "inline_captures_after_warmup":
                         on_card["rec"]["inline_captures_after_warmup"],
                     "picks": {c: p["total"]
                               for c, p in fed["picks"].items()},
                     "events": [e["event"] for e in fed["events"]]}
    rec = {"phase": "fed-storms", **out}
    emit(rec)
    return rec


def phase_fed(dev, cfg, weights, kernels, tmp) -> dict:
    """Phase 16: (a) two federated server processes on the card, (b) the
    federation storms card against CPU."""
    t0 = time.monotonic()
    servers = fed_servers(dev, cfg, weights, kernels, tmp)
    storms = fed_storms(dev, kernels)
    summary = {"phase": "fed", "wall_s": time.monotonic() - t0,
               "launches": servers["launches"],
               "local_only_s": servers["local_only_s"],
               "readmit_s": servers["readmit_s"],
               "storm_wall_s": {k: v["wall_s"] for k, v in storms.items()
                                if k != "phase"}}
    emit(summary)
    return summary

# -- phase 17: the fleet picker on the card ----------------------------------

FLEET_TOPK, FLEET_CAP = 4, 256         # docs/FLEET.md's scale proof: K x cap
FLEET_WIDTHS = ((65536, 5), (262144, 2))   # (endpoints, carried waves)
FLEET_SEED = 17
FLEET_RUNNER_TOPK, FLEET_RUNNER_CAP = 2, 64   # (c): 4 cells of 256 pods


def fleet_exact(dev, name, cfg, weights, kernels, own) -> dict:
    """(a): FleetPicker(topk 4, cell_cap 256) against the dense Scheduler,
    both on the card with the same seed, over WAVES carried waves of the
    north-star mix at 1024 endpoints (the top-K covers all 4 cells): picks
    and status equal, scores and the carried state equal (bitwise where
    the card repeats itself; the float state within 1e-5, as the card
    tests hold a replay), one kernel launch a fleet wave."""
    from gie_tpu_torch.fleet import FleetPicker
    from gie_tpu_torch.sched import Scheduler

    m = FLEET_TOPK * FLEET_CAP
    eps, wave = workload(dev, m)
    fleet = FleetPicker(cfg, weights, device=dev, seed=FLEET_SEED,
                        topk=FLEET_TOPK, cell_cap=FLEET_CAP)
    dense = Scheduler(cfg, weights, device=dev, seed=FLEET_SEED)
    check(fleet.compressed_width(m) == m, f"{name}: not a covering K")
    launches = {k: 0 for k in kernels}
    bitwise = {"scores": 0, "state": 0}
    for w in range(WAVES):
        reqs = wave(w)
        before = {k: fn.launches for k, fn in kernels.items()}
        a = fleet.pick(reqs, eps)
        for k, fn in kernels.items():
            launches[k] += fn.launches - before[k]
        check(launches[own] == w + 1,
              f"{name}: {launches[own]} fleet kernel launches after "
              f"{w + 1} waves")
        b = dense.pick(reqs, eps)
        check(np.array_equal(a.indices, b.indices)
              and np.array_equal(a.status, b.status),
              f"{name}: fleet wave {w} picks differ from the dense cycle")
        check(np.allclose(a.scores, b.scores, atol=1e-5, rtol=0),
              f"{name}: fleet wave {w} scores differ from the dense cycle")
        bitwise["scores"] += int(np.array_equal(a.scores, b.scores))
        complete_half(fleet, a, reqs)
        complete_half(dense, a, reqs)
        sa, sb = fleet.export_state(), dense.export_state()
        for k in ("prefix_keys", "prefix_present", "prefix_ages", "rr",
                  "tick"):
            check(np.array_equal(sa[k], sb[k]),
                  f"{name}: fleet wave {w}: {k} differs from the dense state")
        for k in ("assumed_load", "ot_v"):
            check(np.allclose(sa[k], sb[k], atol=1e-5, rtol=0),
                  f"{name}: fleet wave {w}: {k} beyond 1e-5 of the dense")
        bitwise["state"] += int(all(np.array_equal(sa[k], sb[k])
                                    for k in ("assumed_load", "ot_v")))
    rec = {"phase": "fleet-exact", "config": name, "m": m,
           "topk": FLEET_TOPK, "cell_cap": FLEET_CAP, "waves": WAVES,
           "launches": launches, "bitwise_waves": bitwise,
           "ok_rows_last": int((a.status == 0).sum())}
    emit(rec)
    return rec


def fleet_sketch_width(dev, name, cfg, weights, kernels, own, m, waves_n,
                       dense_ms) -> dict:
    """(b) at one width: a FleetPicker on the card in sketch mode, its
    lattice warmed, over `waves_n` carried waves of the fleet sweep's
    traffic handed over as CPU tensors, with complete() feedback; each
    wave replayed on a CPU FleetPicker from the same state with the same
    noise: the coarse stage's selection and candidate cells exact (the
    selection recomputed on both from that state), primaries as phase 3
    compares them, the cell-grain table equal where they agree."""
    from gie_tpu_torch.fleet import FleetPicker
    from gie_tpu_torch.fleet.picker import _is_sketch, coarse_stage
    from gie_tpu_torch.sched.profile import (
        _batch_to_device, _copy_state, gumbel_noise)
    from gie_tpu_torch.sched.types import bucket_for, pad_requests

    t_width = time.perf_counter()
    eps, wave = workload(torch.device("cpu"), m)
    reqs_list = [wave(w) for w in range(waves_n)]
    lanes = {int(r.chunk_hashes.shape[1]) for r in reqs_list}
    check(len(lanes) == 1, f"{name}: the waves span chunk buckets {lanes}")
    lanes = lanes.pop()
    valid = eps.valid.numpy()
    gen = torch.Generator(device=dev)
    gen.manual_seed(FLEET_SEED)
    drawn = []

    def noise(shape):
        drawn.append(gumbel_noise(shape, gen, dev))
        return drawn[-1]

    kw = dict(topk=FLEET_TOPK, cell_cap=FLEET_CAP)
    gpu = FleetPicker(cfg, weights, device=dev, noise_source=noise, **kw)
    cpu = FleetPicker(cfg, weights, device="cpu",
                      noise_source=lambda shape: drawn[-1].cpu(), **kw)
    t0 = time.perf_counter()
    thread = gpu.warm_lattice_async(m, lanes)
    thread.join(900)
    warm_s = time.perf_counter() - t0
    check(not thread.is_alive() and not gpu._warm_failures,
          f"{name}: the fleet lattice at M={m} did not warm: "
          f"{gpu._warm_failures}")
    graph = gpu._graphs[(N, m, lanes)]
    pools = pool_bytes()
    pool = {f"{n}": pools.get(tuple(g.graph.pool()), 0)
            for (n, mm, _), g in sorted(gpu._graphs.items()) if mm == m}
    inline0 = gpu.warm_inline_compiles
    k_sel = min(FLEET_TOPK, m // FLEET_CAP)

    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    host_ms, wall_ms, agree, rows, table_equal = [], [], 0, 0, 0
    for w, reqs in enumerate(reqs_list):
        # The state both waves start from (the card's, at width m), and
        # the selection recomputed on both from it.
        with gpu._lock:
            gpu._apply_queued()
            start = _copy_state(gpu._use_bucket(m))
        cpu.install_state(gpu.export_state())
        check(_is_sketch(cpu.state) and cpu.state.m == m,
              f"{name}: the CPU twin's state is not a sketch at {m}")
        padded = pad_requests(reqs, bucket_for(N))
        sel = [coarse_stage(st, r, e, gpu.weights, cfg=cfg,
                            cell_cap=FLEET_CAP, k=k_sel)
               for st, r, e in ((start, _batch_to_device(padded, dev),
                                 _batch_to_device(eps, dev)),
                                (cpu.state, padded, eps))]
        check(all(torch.equal(x.cpu(), y) for x, y in zip(sel[0], sel[1][:2]))
              and torch.allclose(sel[0][2].cpu(), sel[1][2], atol=1e-6),
              f"{name}: M={m} wave {w}: the coarse selection differs")
        del start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = gpu.pick_async(reqs, eps)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        res = pending.materialize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        check(kernels[own].launches == w + 1,
              f"{name}: {kernels[own].launches} kernel launches after "
              f"{w + 1} fleet waves")
        ref = cpu.pick(reqs, eps)
        check(np.array_equal(res.fleet.cells, ref.fleet.cells),
              f"{name}: M={m} wave {w}: candidate cells differ")
        differ = compare_primaries(res, ref, valid, f"{name} M={m}", m=m)
        agree += int((~differ).sum())
        rows += len(differ)
        sa, sb = gpu.export_state(), cpu.export_state()
        same = all(np.array_equal(sa[k], sb[k]) for k in
                   ("prefix_keys", "prefix_present", "prefix_ages"))
        check(same or differ.any(),
              f"{name}: M={m} wave {w}: the cell-grain table differs where "
              "every primary agrees")
        table_equal += int(same)
        complete_half(gpu, res, reqs)
        emit({"phase": "fleet-wave", "config": name, "m": m, "wave": w,
              "host_ms": host_ms[-1], "wall_ms": wall_ms[-1],
              "ok_rows": int((res.status == 0).sum()),
              "primary_agree": int((~differ).sum())})
    launches = {k: fn.launches for k, fn in kernels.items()}
    inline = gpu.warm_inline_compiles - inline0
    check(inline == 0, f"{name}: {inline} inline captures after the warm")
    check(agree >= 0.999 * rows, f"{name}: M={m}: primaries agree on only "
                                 f"{agree}/{rows} rows")
    rec = {"phase": "fleet-sketch", "config": name, "m": m, "n": N,
           "topk": FLEET_TOPK, "cell_cap": FLEET_CAP,
           "cells": m // FLEET_CAP, "m_c": gpu.compressed_width(m),
           "waves": waves_n, "launches": launches,
           "lattice_warm_s": warm_s,
           "pick_async_host_ms_median": statistics.median(host_ms),
           "wall_ms_per_wave": wall_ms,
           "dense_1024x1024_wall_ms_per_wave": dense_ms["wall_ms_per_wave"],
           "dense_1024x1024_host_ms_median":
               dense_ms["pick_async_host_ms_median"],
           "h2d_bytes_per_wave": graph.nbytes,
           "subset_mask_bytes": N * m,
           "graph_pool_bytes_by_n": pool,
           "inline_captures_after_warm": inline,
           "primary_agree": [agree, rows], "table_equal_waves": table_equal,
           "wall_s": time.perf_counter() - t_width}
    emit(rec)
    del gpu, cpu, graph
    torch.cuda.empty_cache()
    return rec


def fleet_sketch(dev, name, cfg, weights, kernels, own) -> dict:
    """(b): sketch mode at 65,536 and 262,144 endpoints, beside a dense
    1024 x 1024 wave of the same configuration."""
    eps, wave = workload(torch.device("cpu"), FLEET_TOPK * FLEET_CAP)
    dense_ms = timed_waves(dev, cfg, weights, eps,
                           [wave(w) for w in range(WAVES)])
    widths = [fleet_sketch_width(dev, name, cfg, weights, kernels, own, m,
                                 waves_n, dense_ms)
              for m, waves_n in FLEET_WIDTHS]
    return {"launches": {k: sum(r["launches"][k] for r in widths)
                         for k in kernels},
            "widths": widths, "dense": dense_ms}


def fleet_runner(dev, kernels, tmp) -> dict:
    """(c): the runner main() builds from argv with --fleet-topk 2
    --fleet-cell-cap 64 and phase 6's profile (tuned + use_pallas_sinkhorn)
    over M stub pods (4 cells, 2 of them a wave: not covering; the block
    of 128 slots pads to the 256 bucket), one burst
    of N streams after a warm-up round: every stream answered with a
    ready primary, one Sinkhorn launch a wave, /debugz/fleet in exact
    mode over 4 cells with a top-K hit histogram whose picks sum to the
    streams, and the flight records carrying fleet provenance."""
    need_transport()
    import multiprocessing

    from gie_tpu_torch import obs
    from gie_tpu_torch.fleet import FleetPicker
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner
    from gie_tpu_torch.sched.config import tuned_profile

    cfg, weights = tuned_profile()
    cfg = dataclasses.replace(cfg, use_pallas_sinkhorn=True)
    ctx = multiprocessing.get_context("spawn")
    stop, ready = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=stub_fleet_process, args=(M, 0, ready, stop),
                         daemon=True)]
    procs[0].start()
    runner = None
    try:
        fleet_port = ready.get(timeout=120)
        mport = free_port()
        argv = ["--insecure-serving",
                "--scheduler-config", write_scheduler_config(cfg, weights, tmp),
                "--fleet-topk", str(FLEET_RUNNER_TOPK),
                "--fleet-cell-cap", str(FLEET_RUNNER_CAP),
                "--pool-name", "smoke", "--grpc-port", str(free_port()),
                "--grpc-health-port", str(free_port()),
                "--metrics-port", str(mport),
                "--extproc-workers", str(EXTPROC_WORKERS),
                "--scrape-interval-ms", str(SCRAPE_INTERVAL_MS)]
        runner = ExtProcServerRunner(
            server_options(argv), fleet_cluster("smoke", fleet_ips(M),
                                                fleet_port))
        sched = runner.scheduler
        check(isinstance(sched, FleetPicker) and sched.device.type == "cuda"
              and sched.fleet_topk == FLEET_RUNNER_TOPK
              and sched.fleet_cell_cap == FLEET_RUNNER_CAP,
              f"fleet runner: {type(sched).__name__} on {sched.device}")
        runner.setup()
        runner.start()
        slots = [ep.slot for ep in runner.datastore.endpoints()]
        check(len(slots) == M, f"fleet runner: {len(slots)} of {M} ready")
        deadline = time.monotonic() + 60
        while True:
            _, ages = runner.metrics_store.pool_rows(slots)
            if bool(np.isfinite(ages).all()) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        rounds = [-1, 0]                                 # -1: warm-up
        barrier, results = ctx.Barrier(CLIENTS + 1), ctx.Queue()
        for k in range(CLIENTS):
            procs.append(ctx.Process(
                target=client_process,
                args=(runner.grpc_server.port, CHANNELS // CLIENTS, rounds, k,
                      STREAMS_PER_ROUND, barrier, results), daemon=True))
            procs[-1].start()
        live = {ep.hostport for ep in runner.datastore.endpoints()}
        for w in rounds:
            if w == 0:
                for t in runner.picker._warm_threads:
                    t.join(300)
                torch.cuda.synchronize()
                for fn in kernels.values():
                    fn.launches = 0
                waves0 = own_metrics.PIPELINE_WAVES.value()
                t0 = time.monotonic()
            barrier.wait(600)
            got = [results.get(timeout=900) for _ in range(CLIENTS)]
            outcomes = [o for g in got for o in g[1]]
            errs = [o[4] for o in outcomes if o[4]]
            check(not errs, f"fleet runner: {len(errs)} streams failed, "
                            f"first: {errs[:1]}")
        burst_s = time.monotonic() - t0
        waves = int(own_metrics.PIPELINE_WAVES.value() - waves0)
        launches = {k: fn.launches for k, fn in kernels.items()}
        answered = sum(o[1] is not None and o[1].split(",")[0] in live
                       for o in outcomes)
        check(answered == STREAMS_PER_ROUND,
              f"fleet runner: {answered} of {STREAMS_PER_ROUND} answered")
        check(launches["fused_sinkhorn_plan"] == waves >= 1,
              f"fleet runner: {launches} launches for {waves} waves")
        report = json.loads(http_get(mport, "/debugz/fleet"))
        picks = sum(report.get("topk_hit_histogram", {}).values())
        check(report.get("mode") == "exact" and report.get("cells") == 4
              and report.get("fleet_m") == M
              and picks == len(rounds) * STREAMS_PER_ROUND,
              f"fleet runner: /debugz/fleet {str(report)[:400]}")
        records = [r for r in obs.RECORDER.snapshot() if "chosen" in r]
        with_fleet = [r for r in records if "fleet" in r]
        check(records and len(with_fleet) == len(records)
              and all(len(r["fleet"]["cells"]) == FLEET_RUNNER_TOPK
                      and r["fleet"]["compression"]
                      == round(sched.compression_ratio(M), 6)
                      for r in with_fleet),
              f"fleet runner: {len(with_fleet)} of {len(records)} flight "
              f"records carry fleet provenance: "
              f"{[r.get('fleet') for r in records[:2]]}")
        for t in runner.picker._warm_threads:
            t.join(300)
    finally:
        stop.set()
        if runner is not None:
            runner.stop()
        for proc in procs:
            proc.join(30)
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    rec = {"phase": "fleet-runner", "streams": STREAMS_PER_ROUND,
           "answered": answered, "waves": waves, "launches": launches,
           "burst_s": burst_s, "streams_per_s": answered / burst_s,
           "debugz_fleet": {k: report[k] for k in (
               "mode", "cells", "fleet_m", "compression_ratio", "waves",
               "topk_hit_histogram")},
           "records_with_fleet": len(with_fleet)}
    emit(rec)
    return rec


def fleet_storms(dev, kernels) -> dict:
    """(d): storm-fleet under virtual time on the card and on a CPU engine
    with phase 10's noise (decisions, counts, the fleet block and the
    federation block equal), and the same storm re-run on the card with
    the dense Scheduler (the same decision fingerprint)."""
    from gie_tpu_torch.resilience import scenarios
    from gie_tpu_torch.storm.engine import engine_from_drive

    name = "storm-fleet"
    on_card = storm_run(name, dev, kernels)
    on_cpu = storm_run(name, torch.device("cpu"), kernels)
    same_storm(on_card, on_cpu)
    a, b = on_card["scorecard"], on_cpu["scorecard"]
    check(a["fleet"] == b["fleet"],
          f"{name}: the fleet block differs: {a['fleet']} {b['fleet']}")
    fa, fb = fed_without_late_reads(a), fed_without_late_reads(b)
    differ = sorted(k for k in set(fa) | set(fb) if fa.get(k) != fb.get(k))
    check(not differ, f"{name}: the card and the CPU differ in federation "
                      f"{differ}")
    scn = scenarios.load(name)
    drive = dict(scn.drive["storm"])
    drive.pop("fleet_topk")
    drive.pop("fleet_cell_cap", None)
    t0 = time.monotonic()
    eng = engine_from_drive(drive, seed=scn.seed, name=name + "-dense",
                            virtual_time=True, device=dev,
                            noise_source=storm_noise(dev))
    try:
        dense = eng.run().scorecard
    finally:
        eng.close()
    dense_s = time.monotonic() - t0
    check(dense["decision_fingerprint"] == a["decision_fingerprint"]
          and dense["schedule_fingerprint"] == a["schedule_fingerprint"],
          f"{name}: the dense re-run on the card decided otherwise")
    rec = {"phase": "fleet-storm", "wall_s": on_card["rec"]["wall_s"],
           "cpu_wall_s": on_cpu["rec"]["wall_s"], "dense_wall_s": dense_s,
           "waves": on_card["rec"]["waves"],
           "inline_captures_after_warmup":
               on_card["rec"]["inline_captures_after_warmup"],
           "fleet": {k: a["fleet"][k] for k in (
               "mode", "cells", "compression_ratio", "waves",
               "topk_hit_histogram")},
           "ok": a["ok"], "shed": a["shed"], "client_5xx": a["client_5xx"],
           "equal_to_cpu": True, "equal_to_dense": True}
    emit(rec)
    return rec


def phase_fleet(dev, cfg, weights, kernels, tmp) -> dict:
    """Phase 17: (a) exact mode against the dense cycle, (b) sketch mode
    at 65,536 and 262,144 endpoints against CPU replays, each in both
    kernel configurations; (c) the runner under --fleet-topk; (d)
    storm-fleet, card against CPU and against the dense re-run."""
    from gie_tpu_torch.sched import ProfileConfig

    t_phase = time.perf_counter()
    topk_cfg = ProfileConfig(picker="topk", use_pallas_topk=True)
    parts, walls = [], {}
    for name, c, w, own in (
            ("tuned+use_pallas_sinkhorn", cfg, weights, "fused_sinkhorn_plan"),
            ("topk+use_pallas_topk", topk_cfg, None, "fused_blend_topk")):
        t0 = time.perf_counter()
        parts.append(fleet_exact(dev, name, c, w, kernels, own))
        walls[f"exact {name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        parts.append(fleet_sketch(dev, name, c, w, kernels, own))
        walls[f"sketch {name}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts.append(fleet_runner(dev, kernels, tmp))
    walls["runner"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    storm = fleet_storms(dev, kernels)
    walls["storm"] = time.perf_counter() - t0
    launches = {k: sum(p["launches"][k] for p in parts) for k in kernels}
    summary = {"phase": "fleet", "wall_s": time.perf_counter() - t_phase,
               "part_wall_s": walls, "launches": launches,
               "storm_equal_to_cpu_and_dense": storm["equal_to_dense"]}
    emit(summary)
    return summary


# -- phase 18: the latency predictor on the card ----------------------------

PRED_SEED = 18
# Card against CPU, the MLP and its column: rtol. Both round to bf16 after
# each op of the hidden layers, but cuBLAS sums the bf16 products in
# another order than the CPU's GEMM, so a hidden unit may land one bf16
# ulp (2**-8 relative) apart and carry that into the output.
PRED_RTOL = 1e-2
PRED_LR = 1e-3             # LatencyPredictorConfig's learning rate
PRED_SLO_MS = 200.0        # (d)'s x-gateway-inference-ttft-slo-ms
PRED_FRAMES = 6            # (d)'s SSE token frames a stream
PRED_ROUNDS = (-1, 0)      # (d): warm-up (the column at 0), then a round


def pred_delays(n: int = M, seed: int = PRED_SEED):
    """(d)'s per-pod latency table: (seconds to response headers, seconds
    between token frames) of pod i, a quarter of the pods 4x slower."""
    rng = np.random.default_rng(seed)
    slow = np.zeros(n, bool)
    slow[rng.choice(n, n // 4, replace=False)] = True
    scale = np.where(slow, 4.0, 1.0)
    return (rng.uniform(0.05, 0.1, n) * scale,
            rng.uniform(0.002, 0.004, n) * scale, slow)


def pod_index(hostport: str) -> int:
    """The pod of a fleet_ips address."""
    a, b = hostport.split(":")[0].split(".")[2:4]
    return int(a) * 200 + int(b) - 1


def pred_has_slo(i: int) -> bool:
    return i % 4 == 3


async def pred_aio_stream(method, w, i):
    """aio_stream's exchange as a model server paced by pred_delays answers
    it: one stream in four carries x-gateway-inference-ttft-slo-ms; the
    response headers follow the served pod's TTFT, then an SSE body of
    PRED_FRAMES token frames (and the [DONE] sentinel), a frame each TPOT.
    -> (destination or "<code>", pick s, stream s)."""
    import asyncio

    import grpc

    from gie_tpu_torch.extproc import metadata as md, pb

    ttft, tpot, _ = pred_delays()
    extra = ([(md.TTFT_SLO_MS_KEY, b"%d" % PRED_SLO_MS)]
             if pred_has_slo(i) else [])
    headers, body, response_headers, _ = stream_frames(w, i, extra=extra)
    t0 = time.perf_counter()
    call = method(timeout=STREAM_TIMEOUT_S)
    await call.write(headers)
    await call.write(body)
    first = await call.read()
    t_pick = time.perf_counter() - t0
    if first is grpc.aio.EOF:
        raise RuntimeError(f"stream ended with no response: "
                           f"{await call.code()}")
    resp = pb.ProcessingResponse.FromString(first)
    if resp.WhichOneof("response") == "immediate_response":
        dest = f"<{resp.immediate_response.status.code}>"
    else:
        dest = destination(first)
        await call.read()                       # the request-body response
        if dest is not None:
            pod = pod_index(dest.split(",")[0])
            await asyncio.sleep(float(ttft[pod]))
            await call.write(response_headers(dest.split(",")[0]))
            await call.read()                   # the response-headers response
            frames = [b'data: {"token": %d}\n\n' % k
                      for k in range(PRED_FRAMES)] + [b"data: [DONE]\n\n"]
            for k, data in enumerate(frames):
                if k:
                    await asyncio.sleep(float(tpot[pod]))
                await call.write(pb.ProcessingRequest(
                    response_body=pb.HttpBody(
                        body=data, end_of_stream=k == len(frames) - 1)
                ).SerializeToString())
                await call.read()
    await call.done_writing()
    while await call.read() is not grpc.aio.EOF:
        pass
    return dest, t_pick, time.perf_counter() - t0


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got.cpu().double() - want.cpu().double()).abs()
                  / want.cpu().double().abs().clamp(min=1e-30)).max())


def pred_column(dev) -> dict:
    """(a): the MLP forward, predictor_score_fn at N x M and N x 1024 and
    one train step on the card against the CPU port from the same params
    and batch; the column's device time beside its bound and the plain
    version's (the same torch ops on the CPU)."""
    from gie_tpu_torch import convert
    from gie_tpu_torch.models.latency import (
        LatencyPredictor, make_optimizer, make_train_step, predictor_score_fn)
    from gie_tpu_torch.sched import constants as C
    from gie_tpu_torch.sched.types import RequestBatch

    p = LatencyPredictor()
    params_cpu = p.init(seed=PRED_SEED)
    params = {k: v.to(dev) for k, v in params_cpu.items()}
    rng = np.random.default_rng(PRED_SEED)
    feats = rng.uniform(size=(N, M, 8)).astype(np.float32)
    slots = rng.integers(0, C.M_MAX + 1, (N, M))
    fwd = rel_err(p.predict(params, feats, slots),
                  p.predict(params_cpu, feats, slots))
    check(fwd <= PRED_RTOL, f"predictor forward: rel err {fwd} > {PRED_RTOL}")
    fn = predictor_score_fn(p)
    columns = {}
    for m in (M, 1024):
        eps, wave = workload(dev, m)
        reqs = wave(0)
        load = torch.from_numpy(rng.uniform(0, 40, m).astype(np.float32))
        eps_cpu = convert.endpoints_from_numpy(
            convert.endpoints_to_numpy(eps), device="cpu")
        reqs_cpu = RequestBatch(**{f.name: getattr(reqs, f.name).cpu()
                                   for f in dataclasses.fields(RequestBatch)})
        load_dev = load.to(dev)
        col = fn(params, reqs, eps, load_dev)
        t0 = time.perf_counter()
        col_cpu = fn(params_cpu, reqs_cpu, eps_cpu, load)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        err = rel_err(col, col_cpu)
        check(err <= PRED_RTOL and bool(torch.isfinite(col).all()),
              f"predictor column {N}x{m}: rel err {err} > {PRED_RTOL}")
        rows = N * m
        flops = 2 * rows * (16 * 128 + 128 * 128 + 128 * 2)
        # Operations at the bf16 tensor-core peak (the hidden layers run
        # in bf16); bytes: the inputs read once (the grid's features come
        # from [N] + [M] rows) and the column written once.
        t_ops = flops / 989e12 * 1e3
        t_bytes = (N * 16 + m * 32 + rows * 4) / HBM_BYTES_PER_S * 1e3
        columns[f"{N}x{m}"] = {
            "max_rel_err": err, "ms": cuda_ms(
                lambda: fn(params, reqs, eps, load_dev), reps=5, trials=3),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "cpu_plain_ms_one_run": cpu_ms}
    step = make_train_step(p)
    batch = [torch.from_numpy(a) for a in (
        rng.uniform(size=(256, 8)).astype(np.float32),
        rng.integers(0, C.M_MAX + 1, 256),
        rng.uniform(0, 2, (256, 2)).astype(np.float32),
        (rng.uniform(size=(256, 2)) < 0.7).astype(np.float32))]
    out = []
    for where in (dev, torch.device("cpu")):
        module = p.module(PRED_SEED).to(where)
        loss = step(module, make_optimizer(module, p.cfg),
                    *[t.to(where) for t in batch])
        out.append((float(loss), {k: v.cpu() for k, v in
                                  module.state_dict().items()}))
    (l_dev, p_dev), (l_cpu, p_cpu) = out
    loss_err = abs(l_dev - l_cpu) / abs(l_cpu)
    diffs = torch.cat([(p_dev[k] - p_cpu[k]).abs().reshape(-1)
                       for k in p_cpu])
    close = float((diffs <= 1e-5).double().mean())
    check(loss_err <= 1e-3 and float(diffs.max()) <= 2 * PRED_LR + 1e-5
          and close >= 0.99,
          f"predictor train step: loss err {loss_err}, max param diff "
          f"{float(diffs.max())}, {close} within 1e-5")
    rec = {"phase": "predictor-column", "rtol": PRED_RTOL,
           "forward_max_rel_err": fwd, "columns": columns,
           "train_step": {"loss_rel_err": loss_err,
                          "param_max_abs_diff": float(diffs.max()),
                          "param_share_within_1e-5": close}}
    emit(rec)
    return rec


def pred_cycle(dev, name, cfg, weights, kernels, own, m) -> dict:
    """(b) at N x m: the lattice warmed, then WAVES carried waves through
    the captured cycle with the latency column at weight 1.0, each replayed
    on a CPU Scheduler from the same state with the same noise and the
    card's column (read from the replay's static output) as a fixed
    column: statuses exact, primaries as phase 3 compares them, the exact
    rows counted; set_predictor_params between waves 2 and 3 changes the
    next replay's column and captures nothing; then pick_async's host
    time, the wall time per wave and the graphs' pool bytes beside the
    same waves without the column."""
    from gie_tpu_torch import convert
    from gie_tpu_torch.models.latency import LatencyPredictor, predictor_score_fn
    from gie_tpu_torch.sched import Scheduler
    from gie_tpu_torch.sched.profile import _batch_to_device, gumbel_noise
    from gie_tpu_torch.sched.types import RequestBatch, Weights, pad_requests

    p = LatencyPredictor()
    column = predictor_score_fn(p)
    probe = {}

    def fn(params, reqs, eps, load):
        col = column(params, reqs, eps, load)
        probe[tuple(col.shape)] = col     # in a capture: the static output
        return col

    fixed = {}
    w_lat = (weights or Weights.default()).replace(latency=1.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(PRED_SEED)
    drawn = []

    def noise(shape):
        drawn.append(gumbel_noise(shape, gen, dev))
        return drawn[-1]

    gpu = Scheduler(cfg, w_lat, device=dev, noise_source=noise,
                    predictor_fn=fn, predictor_params=p.init(PRED_SEED))
    cpu = Scheduler(cfg, w_lat, device="cpu",
                    noise_source=lambda shape: drawn[-1].cpu(),
                    predictor_fn=lambda *a: fixed["col"])
    for s in (gpu, cpu):
        check(s.gate_latency_column(1.0) == 1.0,
              f"predictor {name}: the gate did not open")
    eps, wave = workload(dev, m)
    eps_cpu = convert.endpoints_from_numpy(convert.endpoints_to_numpy(eps),
                                           device="cpu")
    valid = eps.valid.cpu().numpy()
    waves = [wave(w) for w in range(WAVES + PD_TIMED_WAVES)]
    lanes = int(waves[0].chunk_hashes.shape[1])
    t0 = time.perf_counter()
    thread = gpu.warm_lattice_async(m, lanes)
    thread.join(600)
    warm_s = time.perf_counter() - t0
    check(not thread.is_alive() and not gpu._warm_failures,
          f"predictor {name} m={m}: the lattice did not warm: "
          f"{gpu._warm_failures}")
    graphs, inline = len(gpu._graphs), gpu.warm_inline_compiles
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    exact = rows = allowed = 0
    handoff = None
    for w in range(WAVES):
        reqs = waves[w]
        if w == 3:
            new = p.init(PRED_SEED + 1)
            gpu.set_predictor_params(new)
            check(len(gpu._graphs) == graphs,
                  f"predictor {name}: the handoff captured a graph")
        start = gpu.export_state()
        cpu.install_state(start)
        res = gpu.pick(reqs, eps)
        col = probe[(N, m)].cpu()
        if w == 3:
            load = torch.from_numpy(start["assumed_load"]).to(dev)
            dreqs = pad_requests(_batch_to_device(reqs, dev), N)
            want = column({k: v.to(dev) for k, v in new.items()}, dreqs,
                          eps, load)
            old = column({k: v.to(dev) for k, v in
                          p.init(PRED_SEED).items()}, dreqs, eps, load)
            handoff = {"new_params_rel_err": rel_err(col, want),
                       "old_params_max_abs_diff": float(
                           (col - old.cpu()).abs().max())}
            check(handoff["new_params_rel_err"] <= 1e-3
                  and handoff["old_params_max_abs_diff"] > 1e-2,
                  f"predictor {name}: the replay after the handoff did not "
                  f"read the new params: {handoff}")
        fixed["col"] = col
        ref = cpu.pick(RequestBatch(**{
            f.name: getattr(reqs, f.name).cpu()
            for f in dataclasses.fields(RequestBatch)}), eps_cpu)
        check(kernels[own].launches == w + 1,
              f"predictor {name}: {kernels[own].launches} launches after "
              f"{w + 1} waves")
        differ = compare_primaries(res, ref, valid, f"predictor {name}", m=m)
        exact += int((res.indices == ref.indices).all(axis=1).sum())
        allowed += int(differ.sum())
        rows += len(differ)
        complete_half(gpu, res, reqs)
    launches = {k: fn_.launches for k, fn_ in kernels.items()}
    check(len(gpu._graphs) == graphs and gpu.warm_inline_compiles == inline,
          f"predictor {name}: a wave captured after the lattice warm")
    timed = waves[WAVES:]
    timing = {
        "column": timed_waves(dev, cfg, w_lat, eps, timed, predictor_fn=column,
                              predictor_params=p.init(PRED_SEED)),
        "no_column": timed_waves(dev, cfg, weights, eps, timed)}
    rec = {"phase": "predictor-cycle", "config": name, "shape": [N, m],
           "waves": WAVES, "lattice_warm_s": warm_s, "launches": launches,
           "launches_per_wave": launches[own] / WAVES,
           "rows_exact": exact, "rows": rows, "differ_within_gap": allowed,
           "inline_after_warm": gpu.warm_inline_compiles - inline,
           "handoff": handoff, "timing": timing}
    emit(rec)
    return rec


def pred_pd(dev, kernels) -> dict:
    """(c): tests/test_tpot_training.py's pd case on the card: a trainer on
    the card learns that slot 0 decodes fast and slot 1 slowly (equal
    metrics, only the slot embedding tells them apart), and every decode
    pick of the captured pd cycle (topk + use_pallas_topk, the prefill
    pick's blend-top-k with the column at S = 5) goes to slot 0."""
    from gie_tpu_torch.models.latency import (
        NUM_FEATURES, LatencyPredictor, OnlineTrainer, predictor_score_fn)
    from gie_tpu_torch.sched import ProfileConfig, Scheduler
    from gie_tpu_torch.sched import constants as C
    from gie_tpu_torch.sched.types import Weights
    from gie_tpu_torch.utils.testing import make_endpoints, make_requests

    predictor = LatencyPredictor()
    trainer = OnlineTrainer(predictor, batch_size=64, device=dev)
    feats = np.zeros((NUM_FEATURES,), np.float32)
    rng = np.random.default_rng(0)
    for _ in range(256):
        trainer.observe(feats, 0.1, 0.01 + rng.normal(0, 1e-4), slot=0)
        trainer.observe(feats, 0.1, 0.20 + rng.normal(0, 1e-4), slot=1)
    t0 = time.perf_counter()
    for _ in range(60):
        trainer.train(steps=5)
    train_s = time.perf_counter() - t0
    pred = predictor.predict(trainer.params, np.stack([feats, feats]),
                             np.asarray([0, 1])).cpu().numpy()
    check(pred[0, 1] < pred[1, 1], f"pd: TPOT head did not separate: {pred}")
    cfg = ProfileConfig(pd_disaggregation=True, enable_prefix=False,
                        enable_session=False, picker="topk",
                        use_pallas_topk=True)
    sched = Scheduler(cfg, Weights.default().replace(latency=2.0),
                      device=dev, predictor_fn=predictor_score_fn(predictor),
                      predictor_params=trainer.params)
    sched.gate_latency_column(1.0)
    eps = make_endpoints(4, queue=[0] * 4, kv=[0.1] * 4,
                         role=[int(C.Role.DECODE)] * 2
                         + [int(C.Role.PREFILL)] * 2, m_slots=64)
    reqs = make_requests(8, prompt_len=[2048.0] * 8, m_slots=64)
    reqs = reqs.replace(decode_len=torch.full((8,), 4096.0))
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    res = sched.pick(reqs, eps)
    launches = {k: fn.launches for k, fn in kernels.items()}
    check(bool((res.indices[:, 0] == 0).all()),
          f"pd: decode picks ignored the trained TPOT column: "
          f"{res.indices[:, 0]}")
    check(launches["fused_blend_topk"] == 1,
          f"pd: {launches} launches for one wave")
    rec = {"phase": "predictor-pd", "tpot_pred_s": pred[:, 1].tolist(),
           "train_300_steps_s": train_s, "decode_picks": res.indices[:, 0]
           .tolist(), "launches": launches}
    emit(rec)
    return rec


def pred_runner(dev, kernels, tmp) -> dict:
    """(d): the runner main() builds from argv with --enable-predictor
    --predictor-train-interval-s 1 --predictor-checkpoint-dir, phase 6's
    profile (tuned + use_pallas_sinkhorn) at weights.latency 1.0,
    --autoscale-mode recommend --autoscale-ttft-slo-ms 500, over M stub
    pods, whose clients answer as pred_delays paces them (a quarter of the
    pods 4x slower) with an SSE body, one stream in four carrying
    x-gateway-inference-ttft-slo-ms. A warm-up round (the column at 0),
    then rounds after the latency weight rose: every stream answered on a
    ready pod or SLO-shed with 429, observed_total grown by at least the
    streams served, the train loop run, no inline capture after the warm,
    one Sinkhorn launch a wave, the assumed load back to 0, the share of
    picks on slow pods per round, a probe reading, and a second start from
    the checkpoint resuming its confidence; and the trained heads'
    predictions for the fast and the slow pods."""
    need_transport()
    import multiprocessing

    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner
    from gie_tpu_torch.sched.config import tuned_profile

    cfg, weights = tuned_profile()
    cfg = dataclasses.replace(cfg, use_pallas_sinkhorn=True)
    weights = weights.replace(latency=1.0)
    _, _, slow = pred_delays()
    ckpt = f"{tmp}/predictor"
    ctx = multiprocessing.get_context("spawn")
    stop, ready = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=stub_fleet_process, args=(M, 0, ready, stop),
                         daemon=True)]
    procs[0].start()
    runner = again = None
    per_round = {}
    try:
        fleet_port = ready.get(timeout=120)
        argv = ["--insecure-serving",
                "--scheduler-config", write_scheduler_config(cfg, weights, tmp),
                "--enable-predictor", "--predictor-train-interval-s", "1",
                "--predictor-checkpoint-dir", ckpt,
                "--autoscale-mode", "recommend",
                "--autoscale-ttft-slo-ms", "500",
                "--pool-name", "smoke", "--grpc-port", str(free_port()),
                "--grpc-health-port", str(free_port()),
                "--metrics-port", str(free_port()),
                "--extproc-workers", str(EXTPROC_WORKERS),
                "--scrape-interval-ms", str(SCRAPE_INTERVAL_MS)]
        cluster = fleet_cluster("smoke", fleet_ips(M), fleet_port)
        runner = ExtProcServerRunner(server_options(argv), cluster)
        sched, trainer = runner.scheduler, runner.trainer
        check(trainer is not None and trainer.device.type == "cuda"
              and sched.device.type == "cuda"
              and sched.predictor_fn is not None
              and sched.base_latency_weight == 1.0
              and sched.weights.latency == 0.0,
              f"predictor runner: trainer {trainer}, column "
              f"{sched.predictor_fn}, weights {sched.weights}")
        runner.setup()
        runner.start()
        slots = [ep.slot for ep in runner.datastore.endpoints()]
        check(len(slots) == M, f"predictor runner: {len(slots)} of {M}")
        deadline = time.monotonic() + 60
        while True:
            _, ages = runner.metrics_store.pool_rows(slots)
            if bool(np.isfinite(ages).all()) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        barrier, results = ctx.Barrier(CLIENTS + 1), ctx.Queue()
        for k in range(CLIENTS):
            procs.append(ctx.Process(
                target=client_process,
                args=(runner.grpc_server.port, CHANNELS // CLIENTS,
                      list(PRED_ROUNDS), k, STREAMS_PER_ROUND, barrier,
                      results, pred_aio_stream), daemon=True))
            procs[-1].start()
        live = {ep.hostport for ep in runner.datastore.endpoints()}
        served = 0
        for w in PRED_ROUNDS:
            weight_at_start = sched.weights.latency
            if w == 0:
                for t in runner.picker._warm_threads:
                    t.join(300)
                # The column phases in once the trainer has trained.
                deadline = time.monotonic() + 60
                while (sched.weights.latency == 0.0
                       and time.monotonic() < deadline):
                    time.sleep(0.1)
                weight_before = sched.weights.latency
                check(trainer.last_loss is not None and weight_before > 0.0,
                      f"predictor runner: the latency weight stayed at 0 "
                      f"(last loss {trainer.last_loss})")
                inline = sched.warm_inline_compiles
                observed0 = trainer._observed_total
                torch.cuda.synchronize()
                for fn in kernels.values():
                    fn.launches = 0
                waves0 = own_metrics.PIPELINE_WAVES.value()
            t0 = time.monotonic()
            barrier.wait(600)
            got = [results.get(timeout=900) for _ in range(CLIENTS)]
            outcomes = [o for g in got for o in g[1]]
            errs = [o[4] for o in outcomes if o[4]]
            check(not errs, f"predictor runner round {w}: {len(errs)} "
                            f"streams failed, first: {errs[:1]}")
            dests = [o[1].split(",")[0] for o in outcomes
                     if o[1] is not None and not o[1].startswith("<")]
            shed = [o for o in outcomes if o[1] == "<429>"]
            check(len(dests) + len(shed) == STREAMS_PER_ROUND
                  and all(d in live for d in dests)
                  and all(pred_has_slo(o[0]) for o in shed),
                  f"predictor runner round {w}: {len(dests)} answered, "
                  f"{len(shed)} shed of {STREAMS_PER_ROUND}")
            if w >= 0:
                served += len(dests)
            per_round[str(w)] = {
                "answered": len(dests), "slo_shed": len(shed),
                "slow_pod_share": float(np.mean(
                    [slow[pod_index(d)] for d in dests])),
                "latency_weight_at_start": weight_at_start,
                "latency_weight_at_end": sched.weights.latency,
                "wall_s": time.monotonic() - t0}
        waves = int(own_metrics.PIPELINE_WAVES.value() - waves0)
        launches = {k: fn.launches for k, fn in kernels.items()}
        check(launches["fused_sinkhorn_plan"] == waves >= 1,
              f"predictor runner: {launches} launches for {waves} waves")
        check(sched.warm_inline_compiles == inline,
              f"predictor runner: {sched.warm_inline_compiles - inline} "
              "inline captures after the warm-up round")
        grown = trainer._observed_total - observed0
        check(grown >= served,
              f"predictor runner: observed_total grew by {grown} for "
              f"{served} served streams")
        deadline = time.monotonic() + 10
        while True:
            load = sched.snapshot_assumed_load()
            if float(np.abs(load).max()) <= 1e-5 or (
                    time.monotonic() > deadline):
                break
            time.sleep(0.1)
        check(float(np.abs(load).max()) <= 1e-5,
              f"predictor runner: assumed load {float(load.max())} left "
              "after the bursts")
        probe = runner._autoscale_ttft_probe()
        check(probe is not None and np.isfinite(probe[0]) and probe[1] == 0.5,
              f"predictor runner: the autoscale probe read {probe}")
        heads = pred_heads(runner, slow)
        for t in runner.picker._warm_threads:
            t.join(300)
        runner.stop()
        confidence = trainer.confidence()
        again = ExtProcServerRunner(server_options(argv), cluster)
        resumed = again.trainer.confidence()
        check(resumed > 0.0 and again.scheduler.weights.latency > 0.0,
              f"predictor runner: the restart resumed confidence {resumed}")
    finally:
        stop.set()
        for r in (runner, again):
            if r is not None:
                r.stop()
        for proc in procs:
            proc.join(30)
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    rec = {"phase": "predictor-runner", "rounds": per_round, "waves": waves,
           "launches": launches, "observed_growth": grown,
           "served": served, "last_loss": trainer.last_loss,
           "latency_weight_at_phase_in": weight_before,
           "confidence_at_stop": confidence,
           "confidence_after_restart": resumed,
           "autoscale_probe": list(probe), "predicted_heads": heads}
    emit(rec)
    return rec


def pred_heads(runner, slow) -> dict:
    """The trained heads on the runner's live rows: mean predicted TTFT,
    TPOT and request latency (at the streams' 128-token decode hint) of
    the fast and of the slow pods."""
    from gie_tpu_torch.models.latency import host_features
    from gie_tpu_torch.sched import constants as C

    eps = runner.datastore.local_endpoints()
    slots = np.asarray([ep.slot for ep in eps])
    is_slow = np.asarray([slow[pod_index(ep.hostport)] for ep in eps])
    rows, ages = runner.metrics_store.pool_rows(slots.tolist())
    rows[:, C.Metric.METRICS_AGE_S] = np.clip(
        np.nan_to_num(ages, posinf=1e6), 0.0, 1e6)
    load = runner.scheduler.snapshot_assumed_load()
    decode = 128.0 * C.CHARS_PER_TOKEN
    feats = np.stack([host_features(rows[i], float(load[s]), 1024.0,
                                    decode, False)
                      for i, s in enumerate(slots)])
    trainer = runner.trainer
    pred = trainer.predictor.predict(trainer.params, feats,
                                     slots).cpu().numpy()
    out = {}
    for label, sel in (("fast", ~is_slow), ("slow", is_slow)):
        ttft, tpot = pred[sel, 0], pred[sel, 1]
        out[label] = {"ttft_s": float(ttft.mean()),
                      "tpot_s": float(tpot.mean()),
                      "latency_s": float((ttft + tpot * decode).mean())}
    return out


def pred_ha(dev) -> dict:
    """(e): two ReplicationManagers with trainers on the card over loopback:
    the leader's trainer trained, the follower (its elector names the
    leader) syncs: its predictor params bit-equal to the leader's, the
    same confidence(), and its Scheduler's column handed the params."""
    from gie_tpu_torch.models.latency import (
        LatencyPredictor, OnlineTrainer, predictor_score_fn)
    from gie_tpu_torch.replication import (
        ReplicationManager, follower as follower_mod, replication_identity)
    from gie_tpu_torch.sched import Scheduler
    from gie_tpu_torch.sched.types import Weights

    p = LatencyPredictor()
    leader_t = OnlineTrainer(p, seed=1, batch_size=64, device=dev)
    follower_t = OnlineTrainer(p, seed=2, device=dev)
    rng = np.random.default_rng(PRED_SEED)
    for _ in range(600):
        f = rng.uniform(size=8).astype(np.float32)
        leader_t.observe(f, 0.1 + f[3], 0.01 + 0.05 * f[4],
                         slot=int(rng.integers(0, 256)))
    for _ in range(5):
        leader_t.train(steps=5)
    weights = Weights.default().replace(latency=1.0)
    leader = ReplicationManager(
        scheduler=Scheduler(device=dev), trainer=leader_t, era="leader")
    sched = Scheduler(weights=weights, device=dev,
                      predictor_fn=predictor_score_fn(p),
                      predictor_params=follower_t.params)
    follower = ReplicationManager(scheduler=sched, trainer=follower_t,
                                  era="follower")
    follower.attach_elector(SimpleNamespace(
        identity="follower", is_leader=lambda: False,
        holder_identity=lambda: replication_identity(leader.advertise,
                                                     "leader")))
    try:
        now = time.monotonic()
        check(leader.step(now) == "published", "predictor ha: no publish")
        outcome = follower.step(now)
        check(outcome == follower_mod.INSTALLED,
              f"predictor ha: the follower's sync ended {outcome}")
        same_export(follower_t.export_state(), leader_t.export_state(),
                    "predictor ha follower")
        # The digest carries the loss EMA as f32, as the reference's does.
        check(abs(follower_t.confidence() - leader_t.confidence())
              <= 1e-6 * leader_t.confidence() and leader_t.confidence() > 0,
              f"predictor ha: confidence {follower_t.confidence()} vs "
              f"{leader_t.confidence()}")
        check(all(torch.equal(sched.predictor_params[k], leader_t.params[k])
                  for k in leader_t.params),
              "predictor ha: the follower's column holds other params")
    finally:
        leader.stop()
        follower.stop()
    rec = {"phase": "predictor-ha", "confidence": leader_t.confidence(),
           "install_ms": follower.follower.last_install_s * 1e3,
           "digest_bytes": leader.publisher.digest_bytes}
    emit(rec)
    return rec


def pred_sim(dev) -> dict:
    """(f): tests/test_goodput.py's online-training scenario with the
    Scheduler and the trainer on the card: last_loss < 1.0 and goodput
    above 1.2x least-kv's."""
    from gie_tpu_torch.models.latency import (
        LatencyPredictor, OnlineTrainer, predictor_score_fn)
    from gie_tpu_torch.sched import ProfileConfig, Scheduler, Weights
    from gie_tpu_torch.simulator import StubConfig
    from gie_tpu_torch.simulator.cluster import SimCluster, WorkloadConfig

    wl = WorkloadConfig(arrival_qps=75.0, n_sessions=64,
                        system_prompt_bytes=8192, user_suffix_bytes=128,
                        decode_tokens_mean=32.0, ttft_slo_s=2.5)
    stub = StubConfig(max_running=8, prefill_tokens_per_s=4000.0,
                      decode_tokens_per_s=50.0, prefix_cache_chunks=2048)
    p = LatencyPredictor()
    trainer = OnlineTrainer(p, batch_size=64, device=dev)
    sched = Scheduler(
        ProfileConfig(load_decay=0.95, load_norm=8, queue_norm=16,
                      picker="sinkhorn"),
        weights=Weights(queue=2.0, kv_cache=1.0, prefix=4.0, lora=1.0,
                        assumed_load=1.5, latency=1.0),
        device=dev, predictor_fn=predictor_score_fn(p),
        predictor_params=trainer.params)
    base = SimCluster(n_pods=8, stub_cfg=stub, seed=0).run(
        "least-kv", wl, duration_s=12.0)
    t0 = time.perf_counter()
    stats = SimCluster(n_pods=8, stub_cfg=stub, seed=0).run(
        "tpu", wl, duration_s=12.0, scheduler=sched, trainer=trainer)
    wall = time.perf_counter() - t0
    check(trainer.last_loss is not None and trainer.last_loss < 1.0,
          f"predictor sim: last loss {trainer.last_loss}")
    check(stats.goodput_tokens_per_s > base.goodput_tokens_per_s * 1.2,
          f"predictor sim: goodput {stats.goodput_tokens_per_s} vs "
          f"least-kv {base.goodput_tokens_per_s}")
    rec = {"phase": "predictor-sim", "last_loss": trainer.last_loss,
           "goodput_tokens_per_s": stats.goodput_tokens_per_s,
           "least_kv_goodput_tokens_per_s": base.goodput_tokens_per_s,
           "latency_weight": sched.weights.latency, "wall_s": wall}
    emit(rec)
    return rec


def phase_predictor(dev, cfg, weights, kernels, tmp) -> dict:
    """Phase 18: (a) the column and a train step card against CPU, (b) the
    captured cycle with the column in both kernel configurations at 1024 x
    256 and 1024 x 1024, (c) the pd decode pick steered by the trained
    TPOT head, (d) the runner under --enable-predictor, (e) HA replication
    of the predictor, (f) the simulator's online training."""
    from gie_tpu_torch.sched import ProfileConfig

    t_phase = time.perf_counter()
    walls, parts = {}, []
    t0 = time.perf_counter()
    pred_column(dev)
    walls["column"] = time.perf_counter() - t0
    topk_cfg = ProfileConfig(picker="topk", use_pallas_topk=True)
    for name, c, w, own in (
            ("tuned+use_pallas_sinkhorn", cfg, weights, "fused_sinkhorn_plan"),
            ("topk+use_pallas_topk", topk_cfg, None, "fused_blend_topk")):
        for m in (M, 1024):
            t0 = time.perf_counter()
            parts.append(pred_cycle(dev, name, c, w, kernels, own, m))
            walls[f"cycle {name} {m}"] = time.perf_counter() - t0
    for label, part in (("pd", lambda: pred_pd(dev, kernels)),
                        ("runner", lambda: pred_runner(dev, kernels, tmp))):
        t0 = time.perf_counter()
        parts.append(part())
        walls[label] = time.perf_counter() - t0
    for label, part in (("ha", pred_ha), ("sim", pred_sim)):
        t0 = time.perf_counter()
        part(dev)
        walls[label] = time.perf_counter() - t0
    launches = {k: sum(p["launches"][k] for p in parts) for k in kernels}
    summary = {"phase": "predictor", "wall_s": time.perf_counter() - t_phase,
               "part_wall_s": walls, "launches": launches}
    emit(summary)
    return summary


# -- phase 19: the kube slice on the card ------------------------------------

KUBE_POOL = "kube-pool"
KUBE_CHURN = 32            # (b): pods set not-Ready, and as many deleted
KUBE_WATCH_TIMEOUT_S = 2   # the fake apiserver ends each watch this soon
KUBE_REPLICAS = 1          # the Deployment's spec.replicas before (c)
KUBE_AUTOSCALE = ("--autoscale-mode", "apply", "--autoscale-target", "vllm",
                  "--autoscale-min", "2", "--autoscale-max", "8",
                  "--autoscale-interval-s", "1.0")
KUBE_ROUNDS = (-1, 0, 1, 2)      # warm-up, burst, after churn, after relist


def kube_until(pred, timeout: float, what: str) -> float:
    """Seconds until `pred()` holds; fails naming `what` after `timeout`."""
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 >= timeout:
            raise RuntimeError(f"kube: {what} not within {timeout} s")
        time.sleep(0.1)
    return time.monotonic() - t0


def kube_report(obj: dict) -> None:
    """One line of kube_main's report on its standard output."""
    print(json.dumps({"kube_report": obj}), flush=True)


def kube_main(argv) -> int:
    """The port's main() in this process, as phase 19 runs it (`python -c
    "import chip_smoke; chip_smoke.kube_main(argv)"`), with a reporter
    beside it that only reads: every change of the runner's datastore (its
    endpoints and pick candidates, stamped with time.monotonic(), polled
    every 10 ms), process_readings() plus the ladder's moves and the
    scrape staleness on each "readings" line of standard input, and after
    main() returns the kernels' launches and the dispatched waves."""
    from gie_tpu_torch.ops.fused_sinkhorn import fused_sinkhorn_plan
    from gie_tpu_torch.ops.fused_topk import fused_blend_topk
    from gie_tpu_torch.runtime import main as main_mod
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.runtime import runner as runner_mod

    built = []

    class Runner(runner_mod.ExtProcServerRunner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    runner_mod.ExtProcServerRunner = Runner

    def watch_datastore():
        last = None
        while True:
            if built:
                ds = built[0].datastore
                state = (sorted(ep.hostport for ep in ds.endpoints()),
                         sorted(ep.hostport for ep in ds.pick_candidates()))
                if state != last:
                    kube_report({"t": time.monotonic(), "endpoints": state[0],
                                 "candidates": state[1]})
                    last = state
            time.sleep(0.01)

    def answer_stdin():
        for line in sys.stdin:
            if line.strip() == "readings" and built:
                rs = built[0].resilience
                kube_report({"readings": process_readings(),
                             "ladder_moves": len(rs.ladder.transitions),
                             "staleness_s":
                                 built[0].scraper.staleness_seconds()})

    for target in (watch_datastore, answer_stdin):
        threading.Thread(target=target, daemon=True).start()
    rc = main_mod.main(argv)
    kube_report({"launches": {"fused_sinkhorn_plan":
                              fused_sinkhorn_plan.launches,
                              "fused_blend_topk": fused_blend_topk.launches},
                 "waves": int(own_metrics.PIPELINE_WAVES.value()),
                 "rc": rc})
    return rc


class KubeServer:
    """A kube_main process and what its report said: `states` (datastore
    changes), `readings`, and `final` (launches, waves) once it exits."""

    def __init__(self, argv, log_path):
        import queue as _queue

        self.log_path = log_path
        self.log = open(log_path, "w")
        code = ("import sys, chip_smoke; "
                "sys.exit(chip_smoke.kube_main(sys.argv[1:]))")
        self.t_start = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code] + list(argv),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.log,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
        self.states, self.final = [], None
        self._readings = _queue.Queue()
        self._cond = threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                obj = json.loads(line)["kube_report"]
            except (ValueError, KeyError, TypeError):
                continue
            with self._cond:
                if "readings" in obj:
                    self._readings.put(obj)
                elif "launches" in obj:
                    self.final = obj
                else:
                    self.states.append(obj)
                self._cond.notify_all()

    def until(self, pred, timeout: float, what: str) -> dict:
        """The first datastore state (from now on, or the newest) for
        which pred(state) holds; fails with the log's tail after
        `timeout` seconds."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                for state in self.states[-1:]:
                    if pred(state):
                        return state
                left = deadline - time.monotonic()
                if left <= 0 or self.proc.poll() is not None:
                    raise RuntimeError(
                        f"kube: {what} not reached in {timeout} s (last "
                        f"state: {self.states[-1:]}); log:\n"
                        f"{tail(self.log_path)}")
                self._cond.wait(min(left, 0.5))

    def first_since(self, t0: float, pred):
        """The first state stamped after t0 for which pred holds."""
        with self._cond:
            return next((s for s in self.states
                         if s["t"] >= t0 and pred(s)), None)

    def readings(self) -> dict:
        self.proc.stdin.write("readings\n")
        self.proc.stdin.flush()
        return self._readings.get(timeout=60)

    def stop(self) -> float:
        """SIGTERM; -> seconds to exit (0 required within MAIN_EXIT_S)."""
        import signal

        t0 = time.monotonic()
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(MAIN_EXIT_S)
        self._reader.join(30)
        check(rc == 0 and self.final is not None,
              f"kube: main exited {rc}; log:\n{tail(self.log_path)}")
        return time.monotonic() - t0

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self.log.close()


def kube_pod(name: str, ip: str, ready: bool = True) -> dict:
    return {"kind": "Pod",
            "metadata": {"name": name, "namespace": "default",
                         "labels": {"app": "vllm"}},
            "status": {"podIP": ip, "conditions": [
                {"type": "Ready", "status": "True" if ready else "False"}]}}


def kube_apiserver(fleet_port: int):
    """tests/fakeapi.py's apiserver on a port of this run, holding the
    pool (targetPorts: the stub fleet's port; endpointPickerRef: a Service
    that exists), its Gateway, the model servers' Deployment and M ready
    pods on the stub pods' addresses. Each watch it serves ends after
    KUBE_WATCH_TIMEOUT_S (a real apiserver ends watches at its own
    timeout), and watches refused with 410 Gone are counted in `gone`."""
    import importlib.util

    # By its path: a `tests` package installed on the machine would shadow
    # the repo's tests/ directory (it has no __init__.py).
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "fakeapi.py")
    spec = importlib.util.spec_from_file_location("fakeapi", path)
    fakeapi = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fakeapi)
    srv = fakeapi.FakeKubeApiServer(port=free_port())
    serve_watch, srv.gone = srv._handle_watch, []

    def handle_watch(handler, resource, ns, q):
        if int(q.get("resourceVersion", "0") or 0) < srv._oldest_rv:
            srv.gone.append(resource)
        serve_watch(handler, resource, ns,
                    {**q, "timeoutSeconds": str(KUBE_WATCH_TIMEOUT_S)})

    srv._handle_watch = handle_watch
    srv.apply("pools", {
        "kind": "InferencePool",
        "metadata": {"name": KUBE_POOL, "namespace": "default"},
        "spec": {"selector": {"matchLabels": {"app": "vllm"}},
                 "targetPorts": [{"number": fleet_port}],
                 "endpointPickerRef": {"name": "epp",
                                       "port": {"number": 9002}}}})
    srv.apply("services", {"kind": "Service", "metadata": {
        "name": "epp", "namespace": "default"}})
    srv.apply("gateways", {"kind": "Gateway", "metadata": {
        "name": "gw", "namespace": "default"}})
    srv.deployment_spec = {
        "replicas": KUBE_REPLICAS,
        "selector": {"matchLabels": {"app": "vllm"}},
        "template": {"metadata": {"labels": {"app": "vllm"}},
                     "spec": {"containers": [{"name": "vllm",
                                              "image": "vllm:stub"}]}}}
    srv.apply("deployments", {
        "kind": "Deployment",
        "metadata": {"name": "vllm", "namespace": "default"},
        "spec": json.loads(json.dumps(srv.deployment_spec))})
    for i, ip in enumerate(fleet_ips(M)):
        srv.apply("pods", kube_pod(f"vllm-{i}", ip))
    return srv


def kube_status_accepted(srv) -> bool:
    """A status patch of the pool with Accepted and ResolvedRefs True for
    the Gateway "gw"."""
    for _ns, name, patch in list(srv.status_patches):
        for parent in patch.get("status", {}).get("parents", []):
            conds = {c["type"]: c["status"] for c in parent["conditions"]}
            if (name == KUBE_POOL and parent["parentRef"]["name"] == "gw"
                    and conds == {"Accepted": "True",
                                  "ResolvedRefs": "True"}):
                return True
    return False


def kube_round(server, name, w, barrier, results, readings=True) -> list:
    """Release round w of the client processes; -> their outcomes, every
    stream answered. Prints phase 6's server-round readings."""
    before = server.readings() if readings else None
    barrier.wait(600)
    got = [results.get(timeout=900) for _ in range(CLIENTS)]
    after = server.readings() if readings else None
    check(all(g[0] == w for g in got), "kube: rounds out of step")
    emit({"phase": "server-round", "config": name, "round": w,
          "wall_s": max(g[3] for g in got) - min(g[2] for g in got),
          "client_cpu_s": sum(g[4] for g in got),
          "ladder_moves": after and after["ladder_moves"]
          - before["ladder_moves"],
          "staleness_s": after and after["staleness_s"],
          "before": before and before["readings"],
          "after": after and after["readings"]})
    outcomes = [o for g in got for o in g[1]]
    errs = [o[4] for o in outcomes if o[4]]
    check(not errs and len(outcomes) == STREAMS_PER_ROUND,
          f"kube {name} round {w}: {len(errs)} streams failed, first: "
          f"{errs[:1]}")
    for _, dest, _, _, _ in outcomes:
        check(dest is not None and not dest.startswith("<"),
              f"kube {name} round {w}: a stream got {dest}")
    return outcomes


def kube_servers(cfg, weights, tmp) -> dict:
    """(a)-(c) and the main path of (e): the port's main --kube over the
    fake apiserver and M stub pods, from phase 6's client processes."""
    need_transport()
    import multiprocessing

    from gie_tpu_torch.runtime.health import SERVING
    from gie_tpu_torch.sched import ProfileConfig

    ctx = multiprocessing.get_context("spawn")
    stop_fleet, ready = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=stub_fleet_process,
                         args=(M, 19, ready, stop_fleet), daemon=True)]
    procs[0].start()
    srv, server, out = None, None, {}
    try:
        fleet_port = ready.get(timeout=120)
        srv = kube_apiserver(fleet_port)
        kubeconfig = f"{tmp}/kubeconfig.yaml"
        with open(kubeconfig, "w") as f:
            json.dump({"apiVersion": "v1", "kind": "Config",
                       "current-context": "smoke",
                       "contexts": [{"name": "smoke", "context": {
                           "cluster": "fake", "user": "epp"}}],
                       "clusters": [{"name": "fake",
                                     "cluster": {"server": srv.url}}],
                       "users": [{"name": "epp",
                                  "user": {"token": "smoke-token"}}]}, f)
        gport, hport, mport = free_port(), free_port(), free_port()

        def clients(rounds):
            """CLIENTS client processes for `rounds` against gport (a new
            set per server: a channel whose server went away backs off)."""
            barrier, results = ctx.Barrier(CLIENTS + 1), ctx.Queue()
            for k in range(CLIENTS):
                procs.append(ctx.Process(
                    target=client_process,
                    args=(gport, CHANNELS // CLIENTS, rounds, k,
                          STREAMS_PER_ROUND, barrier, results), daemon=True))
                procs[-1].start()
            return barrier, results

        barrier, results = clients(KUBE_ROUNDS)
        hostports = {ip: f"{ip}:{fleet_port}" for ip in fleet_ips(M)}
        everyone = sorted(hostports.values())
        lease = ("leases", "default", f"{KUBE_POOL}-epp-leader")

        def argv(config):
            return ["--kube", "--kubeconfig", kubeconfig,
                    "--pool-name", KUBE_POOL,
                    "--publish-status-parents", "gw", "--leader-elect",
                    "--scheduler-config", config, "--insecure-serving",
                    "--grpc-port", str(gport), "--grpc-health-port",
                    str(hport), "--metrics-port", str(mport),
                    "--extproc-workers", str(EXTPROC_WORKERS),
                    "--scrape-interval-ms", str(SCRAPE_INTERVAL_MS),
                    *KUBE_AUTOSCALE]

        def holder():
            obj = srv._objects.get(lease)
            return obj and obj["spec"].get("holderIdentity")

        def serving():
            try:
                return health_status(hport, "readiness") == SERVING
            except Exception:           # not listening yet
                return False

        def bring_up(name, config):
            """(a): the pods from the watch alone, the Lease, readiness.
            -> the server and its seconds from start to each."""
            server = KubeServer(argv(config), f"{tmp}/kube-{name}.log")
            filled = server.until(lambda s: s["candidates"] == everyone,
                                  300, f"{name}: {M} ready pods")
            kube_until(lambda: str(holder() or "").startswith(
                f"{server.proc.pid}-"), 60, f"{name}: the Lease")
            t_lease = time.monotonic() - server.t_start
            kube_until(serving, 60, f"{name}: readiness SERVING")
            return server, {"pods_in_s": filled["t"] - server.t_start,
                            "lease_s": t_lease,
                            "ready_s": time.monotonic() - server.t_start}

        # -- (a) bring-up, tuned + use_pallas_sinkhorn ------------------
        server, up = bring_up("sinkhorn", write_scheduler_config(
            cfg, weights, tmp))
        kube_until(lambda: kube_status_accepted(srv), 60,
                   "an Accepted/ResolvedRefs status patch for gw")
        up["status_s"] = time.monotonic() - server.t_start

        # -- (c) --autoscale-mode apply --------------------------------
        def deployment():
            return srv._objects[("deployments", "default", "vllm")]["spec"]

        kube_until(lambda: deployment()["replicas"] != KUBE_REPLICAS, 30,
                   "the Deployment's replicas patch")
        up["replicas_s"] = time.monotonic() - server.t_start
        emit({"phase": "kube-up", "config": "tuned+use_pallas_sinkhorn",
              **up, "status_patches": len(srv.status_patches),
              "replicas": deployment()["replicas"]})

        # -- (b) traffic, churn, relist --------------------------------
        kube_round(server, "sinkhorn", -1, barrier, results)
        burst = kube_round(server, "sinkhorn", 0, barrier, results)
        check(all(o[1].split(",")[0] in everyone for o in burst),
              "kube: a pick outside the pool's pods")
        rng = np.random.default_rng(19)
        churn = [int(i) for i in rng.permutation(M)[:2 * KUBE_CHURN]]
        unready, deleted = churn[:KUBE_CHURN], churn[KUBE_CHURN:]
        ips = fleet_ips(M)
        gone = {hostports[ips[i]] for i in churn}
        t0 = time.monotonic()
        for i in unready:
            srv.apply("pods", kube_pod(f"vllm-{i}", ips[i], ready=False))
        for i in deleted:
            srv.delete("pods", "default", f"vllm-{i}")
        t_written = time.monotonic()
        effect = server.until(lambda s: not gone & set(s["candidates"]), 60,
                              "the churn applied")
        first = server.first_since(t0, lambda s: gone & (
            set(everyone) - set(s["candidates"])))
        churned = kube_round(server, "sinkhorn", 1, barrier, results)
        landed = [o[1] for o in churned
                  if gone & set(o[1].split(","))]
        check(not landed, f"kube: {len(landed)} picks on churned pods, "
                          f"first {landed[:1]}")
        deleted_hp = {hostports[ips[i]] for i in deleted}
        check(not deleted_hp & set(effect["endpoints"]),
              "kube: a deleted pod is still an endpoint")
        # The relist: a window no watch streams (the lock keeps every
        # watcher asleep) brings every churned pod back, then each
        # watch's resume gets 410 Gone.
        gone_before = len(srv.gone)
        with srv._lock:
            srv.compact()
            for i in churn:
                srv.apply("pods", kube_pod(f"vllm-{i}", ips[i]))
            srv.compact()
            t_compact = time.monotonic()
        relisted = server.until(lambda s: s["candidates"] == everyone, 60,
                                "the relist")
        want = sorted(hostports[obj["status"]["podIP"]]
                      for (r, _ns, _n), obj in list(srv._objects.items())
                      if r == "pods")
        check(relisted["candidates"] == want == everyone,
              "kube: the relisted datastore differs from the apiserver's pods")
        check(len(srv.gone) > gone_before and "pods" in srv.gone[gone_before:],
              f"kube: no watch got 410 Gone: {srv.gone}")
        after = kube_round(server, "sinkhorn", 2, barrier, results)
        check(all(o[1].split(",")[0] in everyone for o in after),
              "kube: a pick outside the pool's pods after the relist")
        churn_rec = {
            "churned": len(churn),
            "first_effect_s": first and first["t"] - t0,
            "event_to_effect_s": effect["t"] - t0,
            "write_s": t_written - t0,
            "picks_on_churned_after": len(landed),
            "relist_s": relisted["t"] - t_compact,
            "watch_410s": srv.gone[gone_before:],
            "streams_per_round": STREAMS_PER_ROUND}
        emit({"phase": "kube-churn", **churn_rec})

        spec = deployment()
        check(2 <= spec["replicas"] <= 8,
              f"kube: the Deployment's replicas were not patched: {spec}")
        check({k: v for k, v in spec.items() if k != "replicas"}
              == {k: v for k, v in srv.deployment_spec.items()
                  if k != "replicas"},
              f"kube: the SSA patch changed more than replicas: {spec}")
        exit_s = server.stop()
        final = server.final
        check(holder() == "", f"kube: the Lease was not released: {holder()}")
        check(final["launches"]["fused_sinkhorn_plan"] == final["waves"] >= 1
              and final["launches"]["fused_blend_topk"] == 0,
              f"kube: launches {final['launches']} for {final['waves']} waves")
        out["sinkhorn"] = {"launches": final["launches"],
                           "waves": final["waves"], "exit_s": exit_s,
                           "replicas": spec["replicas"], **up, **churn_rec}
        server.close()

        # -- the second server: topk + use_pallas_topk ------------------
        barrier, results = clients((-1, 0))
        topk = ProfileConfig(picker="topk", use_pallas_topk=True)
        server, up = bring_up("topk", write_scheduler_config(topk, None,
                                                             tmp))
        kube_round(server, "topk", -1, barrier, results)
        kube_round(server, "topk", 0, barrier, results)
        exit_s = server.stop()
        final = server.final
        check(final["launches"]["fused_blend_topk"] == final["waves"] >= 1
              and final["launches"]["fused_sinkhorn_plan"] == 0,
              f"kube topk: launches {final['launches']} for "
              f"{final['waves']} waves")
        out["topk"] = {"launches": final["launches"], "waves": final["waves"],
                       "exit_s": exit_s, **up}
        server.close()
        server = None
    finally:
        if server is not None:
            server.close()
        stop_fleet.set()
        for proc in procs:
            proc.join(30)
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
        if srv is not None:
            srv.close()
    return out


def kube_conformance(dev) -> dict:
    """(d): the port's conformance suite in "rr" mode and in "tpu" mode
    with the Scheduler on the card in both kernel configurations, each
    case passing, the launches of each configuration's kernel counted;
    then the routing case on the card against the same case on a CPU
    Scheduler taking the same Gumbel draws: every response equal."""
    from gie_tpu_torch.conformance import ConformanceEnv, suite
    from gie_tpu_torch.ops.fused_sinkhorn import fused_sinkhorn_plan
    from gie_tpu_torch.ops.fused_topk import fused_blend_topk
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.sched import ProfileConfig

    configs = {
        "rr": (None, None),
        "sinkhorn": (ProfileConfig(picker="sinkhorn",
                                   use_pallas_sinkhorn=True),
                     fused_sinkhorn_plan),
        "topk": (ProfileConfig(use_pallas_topk=True), fused_blend_topk),
    }
    out = {}
    for name, (profile, kernel) in configs.items():
        kwargs = ({"picker_mode": "rr"} if profile is None else
                  {"picker_mode": "tpu", "device": dev, "profile": profile})
        for fn in (fused_sinkhorn_plan, fused_blend_topk):
            fn.launches = 0
        waves0 = own_metrics.PIPELINE_WAVES.value()
        t0 = time.monotonic()
        report, errors = suite.run(**kwargs)
        launches = {fn.__name__: fn.launches
                    for fn in (fused_sinkhorn_plan, fused_blend_topk)}
        waves = int(own_metrics.PIPELINE_WAVES.value() - waves0)
        passed = [r.short_name for r in report.results if r.passed]
        emit({"phase": "kube-conformance", "mode": kwargs["picker_mode"],
              "config": name, "passed": len(passed),
              "cases": len(report.results), "waves": waves,
              "launches": launches, "seconds": time.monotonic() - t0})
        check(not errors and len(passed) == len(suite.BASE_CASES)
              + len(suite.OWN_CASES),
              f"kube conformance {name}: failed {sorted(errors)}: "
              + "".join(list(errors.values())[:1]))
        if kernel is not None:
            check(launches[kernel.__name__] == waves >= 1
                  and sum(launches.values()) == waves,
                  f"kube conformance {name}: launches {launches} for "
                  f"{waves} waves")
        out[name] = {"launches": launches, "waves": waves}

    # The routing case on the card and on a CPU Scheduler, one seeded
    # generator's Gumbel draws each.
    replay = {}
    for where in (dev, torch.device("cpu")):
        env = ConformanceEnv(picker_mode="tpu", device=where,
                             profile=configs["sinkhorn"][0],
                             noise_source=storm_noise(where))
        try:
            for fn in (fused_sinkhorn_plan, fused_blend_topk):
                fn.launches = 0
            responses = suite.routing_conformance(env)
            sched = env.epps[("default", "pool-tpu")].server.picker.scheduler
            check(sched.device.type == where.type,
                  f"kube routing: the Scheduler ran on {sched.device}")
            replay[where.type] = [(r.status, r.backend_pod, r.headers)
                                  for r in responses]
            if where.type == "cuda":
                routing_launches = fused_sinkhorn_plan.launches
        finally:
            env.close()
    differ = sum(a != b for a, b in zip(replay["cuda"], replay["cpu"]))
    emit({"phase": "kube-routing-replay", "responses": len(replay["cuda"]),
          "differ": differ, "launches": routing_launches})
    check(differ == 0 and len(replay["cuda"]) == len(replay["cpu"]),
          f"kube routing: {differ} of {len(replay['cuda'])} responses "
          "differ between the card and the CPU")
    out["sinkhorn"]["launches"]["fused_sinkhorn_plan"] += routing_launches
    return out


def phase_kube(dev, cfg, weights, kernels, tmp) -> dict:
    """Phase 19: (a)-(c) through the port's main --kube, (d) the
    conformance suite, (e) the launches of both kernels."""
    t0 = time.monotonic()
    servers = kube_servers(cfg, weights, tmp)
    conformance = kube_conformance(dev)
    launches = {k: servers["sinkhorn"]["launches"][k]
                + servers["topk"]["launches"][k]
                + conformance["sinkhorn"]["launches"][k]
                + conformance["topk"]["launches"][k] for k in kernels}
    summary = {"phase": "kube", "seconds": time.monotonic() - t0,
               "launches": launches, "servers": servers,
               "conformance": conformance}
    emit(summary)
    for k in kernels:
        check(launches[k] >= 1, f"kube: {k} not launched in phase 19")
    return summary


# -- phase 20: the multi-device slice on the card ----------------------------

MESH_LAYOUTS = ((4, 2), (8, 1), (1, 8))
MESH_WIDTHS = (M, 1024)
MESH_WAVES = 2
MESH_SEED = 20
MESH_TRAIN_ROWS = 8 * 16          # sharded_train_step's batch, 16 a dp row
MESH_HOST_ROWS = 64               # multihost_train_step's rows a process


def mesh_profiles():
    """(a)'s three pickers: the tuned Sinkhorn profile with its solve on
    the grouped path (a mesh never runs the Sinkhorn kernel, so neither
    does the unmeshed Scheduler it is held to), the fused blend-top-k and
    the random picker."""
    from gie_tpu_torch.sched import ProfileConfig
    from gie_tpu_torch.sched.config import tuned_profile

    cfg, weights = tuned_profile()
    return {
        "sinkhorn": (dataclasses.replace(cfg, use_pallas_sinkhorn=False),
                     weights, None),
        "topk+use_pallas_topk": (ProfileConfig(picker="topk",
                                               use_pallas_topk=True), None,
                                 "fused_blend_topk"),
        "random": (ProfileConfig(picker="random"), None, None),
    }


def mesh_equivalence(dev, kernels) -> dict:
    """(a): 8 positions on one card, at each layout of MESH_LAYOUTS and
    each width of MESH_WIDTHS, for each of mesh_profiles(): MESH_WAVES
    carried waves of the north-star mix through Scheduler(mesh=), each a
    replay of its captured sharded cycle, against the unmeshed Scheduler
    on the card with the same seed: indices, statuses, the Sinkhorn duals
    and the prefix keys, words and ages bit-equal, the load within 1e-6.
    The blend-top-k kernel launches once per dp shard a wave."""
    from gie_tpu_torch.parallel import make_mesh
    from gie_tpu_torch.sched import Scheduler

    out = {"launches": {k: 0 for k in kernels}, "cases": 0}
    for m in MESH_WIDTHS:
        eps, wave = workload(torch.device("cpu"), m)
        waves = [wave(w) for w in range(MESH_WAVES)]
        for name, (cfg, weights, own) in mesh_profiles().items():
            plain = Scheduler(cfg, weights, device=dev, seed=MESH_SEED)
            ref, plain_ms = [], []
            for reqs in waves:
                t0 = time.perf_counter()
                res = plain.pick(reqs, eps)
                plain_ms.append((time.perf_counter() - t0) * 1e3)
                ref.append((res, plain.export_state()))
            for dp, tp in MESH_LAYOUTS:
                mesh = make_mesh(devices=[dev] * 8, tp=tp)
                meshed = Scheduler(cfg, weights, seed=MESH_SEED, mesh=mesh)
                check(meshed._captured and meshed.device == plain.device,
                      f"mesh {name}: the meshed Scheduler does not capture")
                torch.cuda.synchronize()
                for fn in kernels.values():
                    fn.launches = 0
                ms = []
                for w, reqs in enumerate(waves):
                    t0 = time.perf_counter()
                    res = meshed.pick(reqs, eps)
                    ms.append((time.perf_counter() - t0) * 1e3)
                    want, state = ref[w]
                    got = meshed.export_state()
                    what = f"mesh {name} {dp}x{tp} m={m} wave {w}"
                    check(np.array_equal(res.indices, want.indices)
                          and np.array_equal(res.status, want.status),
                          f"{what}: picks differ from the unmeshed cycle")
                    for k in ("ot_v", "prefix_keys", "prefix_present",
                              "prefix_ages", "rr", "tick"):
                        check(np.array_equal(got[k], state[k]),
                              f"{what}: {k} differs from the unmeshed cycle")
                    check(np.allclose(got["assumed_load"],
                                      state["assumed_load"], atol=1e-6,
                                      rtol=0),
                          f"{what}: the load is beyond 1e-6 of the unmeshed")
                launches = {k: fn.launches for k, fn in kernels.items()}
                want_launches = {k: 0 for k in kernels}
                if own is not None:
                    want_launches[own] = dp * MESH_WAVES
                check(launches == want_launches,
                      f"mesh {name} {dp}x{tp} m={m}: launches {launches}, "
                      f"want {want_launches}")
                for k in kernels:
                    out["launches"][k] += launches[k]
                out["cases"] += 1
                st = meshed.state
                emit({"phase": "mesh-equal", "config": name,
                      "layout": [dp, tp], "shape": [N, m],
                      "waves": MESH_WAVES, "launches": launches,
                      "block": [N // dp, m // tp],
                      "present_shards": [list(s.prefix.present.shape)
                                         for s in st.shards],
                      "present_axis": "words" if st.words_axis else "slots",
                      "load_shards": [list(s.assumed_load.shape)
                                      for s in st.shards],
                      "wave_ms": ms, "unmeshed_wave_ms": plain_ms,
                      "ok_rows_last": int((res.status == 0).sum())})
    return out


def mesh_one(dev, kernels) -> dict:
    """(b): Scheduler(mesh=make_mesh(1)) with the tuned profile through the
    captured cycle: the lattice warmed (no inline capture after), picks
    equal to the unmeshed Scheduler's, one graph launch a wave under the
    profiler, and the wall time per wave beside the unmeshed one's."""
    from gie_tpu_torch.parallel import make_mesh
    from gie_tpu_torch.sched import Scheduler
    from gie_tpu_torch.sched.config import tuned_profile

    cfg, weights = tuned_profile()
    eps, wave = workload(torch.device("cpu"))
    waves = [wave(w) for w in range(WAVES)]
    lanes = {int(r.chunk_hashes.shape[1]) for r in waves}
    check(len(lanes) == 1, f"mesh-1: the waves span chunk buckets {lanes}")
    lanes = lanes.pop()
    mesh = make_mesh(1)
    check(mesh.shape == {"dp": 1, "tp": 1}, f"mesh-1: {mesh.shape}")
    readings = {}
    results = {}
    for name, sched in (("meshed", Scheduler(cfg, weights, seed=MESH_SEED,
                                             mesh=mesh)),
                        ("unmeshed", Scheduler(cfg, weights, device=dev,
                                               seed=MESH_SEED))):
        t0 = time.perf_counter()
        thread = sched.warm_lattice_async(M, lanes)
        thread.join(600)
        check(not thread.is_alive() and not sched._warm_failures,
              f"mesh-1 {name}: the lattice did not warm")
        warm_s = time.perf_counter() - t0
        results[name] = [sched.pick(r, eps) for r in waves]

        def replay(reqs, sched=sched):
            pending = sched.pick_async(reqs, eps)
            return pending, pending.event

        host, wall, _ = run_waves(replay, waves)
        prof = profiled(replay, waves)
        check(sched.warm_inline_compiles == 0,
              f"mesh-1 {name}: {sched.warm_inline_compiles} inline captures")
        check(prof["launch_calls_by_name"].get("cudaGraphLaunch") == 1,
              f"mesh-1 {name}: {prof['launch_calls_by_name']} a wave")
        readings[name] = {
            "lattice_s": warm_s, "warm_inline_compiles":
                sched.warm_inline_compiles,
            "pick_async_host_ms_median": statistics.median(host),
            "wall_ms_per_wave": wall, **prof}
    for w, (a, b) in enumerate(zip(results["meshed"], results["unmeshed"])):
        check(np.array_equal(a.indices, b.indices)
              and np.array_equal(a.status, b.status),
              f"mesh-1: wave {w} picks differ from the unmeshed Scheduler")
    rec = {"phase": "mesh-one", "shape": [N, M, lanes], "waves": WAVES,
           "graph_launches_per_wave": readings["meshed"][
               "launch_calls_by_name"].get("cudaGraphLaunch"),
           **readings}
    emit(rec)
    return rec


def mesh_fleet(dev, kernels) -> dict:
    """(c): a FleetPicker given a mesh keeps it as its deploy_mesh and runs
    its inner cycle mesh-free, so the Sinkhorn kernel runs: picks equal to
    an unmeshed FleetPicker's with the same seed, one launch a wave."""
    from gie_tpu_torch.fleet import FleetPicker
    from gie_tpu_torch.parallel import make_mesh
    from gie_tpu_torch.sched.config import tuned_profile

    cfg, weights = tuned_profile()
    cfg = dataclasses.replace(cfg, use_pallas_sinkhorn=True)
    m = FLEET_TOPK * FLEET_CAP
    eps, wave = workload(dev, m)
    mesh = make_mesh(devices=[dev] * 8)
    meshed = FleetPicker(cfg, weights, seed=FLEET_SEED, topk=FLEET_TOPK,
                         cell_cap=FLEET_CAP, mesh=mesh)
    plain = FleetPicker(cfg, weights, device=dev, seed=FLEET_SEED,
                        topk=FLEET_TOPK, cell_cap=FLEET_CAP)
    check(meshed.deploy_mesh is mesh and meshed.mesh is None,
          "mesh fleet: the deploy mesh is not kept")
    launches = {k: 0 for k in kernels}
    for w in range(MESH_WAVES):
        reqs = wave(w)
        before = {k: fn.launches for k, fn in kernels.items()}
        a = meshed.pick(reqs, eps)
        for k, fn in kernels.items():
            launches[k] += fn.launches - before[k]
        b = plain.pick(reqs, eps)
        check(np.array_equal(a.indices, b.indices)
              and np.array_equal(a.status, b.status),
              f"mesh fleet: wave {w} picks differ from the unmeshed fleet")
    check(launches["fused_sinkhorn_plan"] == MESH_WAVES,
          f"mesh fleet: {launches} for {MESH_WAVES} waves")
    rec = {"phase": "mesh-fleet", "m": m, "deploy_mesh": mesh.shape,
           "waves": MESH_WAVES, "launches": launches}
    emit(rec)
    return rec


def mesh_conformance(dev, kernels) -> dict:
    """(d): the port's conformance suite in "tpu-mesh" mode on the card
    (make_mesh over every card, tp 1), with the blend-top-k profile: every
    case passed, one kernel launch per dp shard a wave."""
    from gie_tpu_torch.conformance import suite
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.sched import ProfileConfig

    for fn in kernels.values():
        fn.launches = 0
    waves0 = own_metrics.PIPELINE_WAVES.value()
    t0 = time.monotonic()
    report, errors = suite.run(picker_mode="tpu-mesh", device=dev,
                               profile=ProfileConfig(use_pallas_topk=True))
    launches = {k: fn.launches for k, fn in kernels.items()}
    waves = int(own_metrics.PIPELINE_WAVES.value() - waves0)
    passed = [r.short_name for r in report.results if r.passed]
    cards = torch.cuda.device_count()
    rec = {"phase": "mesh-conformance", "mode": "tpu-mesh",
           "mesh": {"dp": cards, "tp": 1}, "passed": len(passed),
           "cases": len(report.results), "waves": waves,
           "launches": launches, "seconds": time.monotonic() - t0}
    emit(rec)
    check(not errors and len(passed) == len(suite.BASE_CASES)
          + len(suite.OWN_CASES),
          f"mesh conformance: failed {sorted(errors)}: "
          + "".join(list(errors.values())[:1]))
    check(launches["fused_blend_topk"] == cards * waves >= 1
          and launches["fused_sinkhorn_plan"] == 0,
          f"mesh conformance: launches {launches} for {waves} waves")
    return rec


def mesh_train_batch(rows: int, seed: int):
    from gie_tpu_torch.models.latency import NUM_FEATURES

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a) for a in (
        rng.uniform(0, 1, (rows, NUM_FEATURES)).astype(np.float32),
        rng.integers(0, 64, rows).astype(np.int64),
        rng.uniform(0, 1, (rows, 2)).astype(np.float32),
        np.ones((rows, 2), np.float32))]


def mesh_worker(rank: int, world: int, port: int) -> None:
    """One process of (e)'s two-process step (`python3 -c "import
    chip_smoke; chip_smoke.mesh_worker(...)"`): joins the group on the
    card, steps its own rows, prints its loss as a JSON line."""
    from gie_tpu_torch.parallel import multihost

    dev = multihost.initialize(f"127.0.0.1:{port}", world, rank)
    try:
        mesh = multihost.global_mesh()
        step, module, optimizer = multihost.multihost_train_step(mesh)
        batch = mesh_train_batch(MESH_HOST_ROWS, 100 + rank)
        shards = [multihost.host_local_batch_to_global(mesh, a)
                  for a in batch]
        loss = float(step(module, optimizer, *shards))
        print(json.dumps({"rank": rank, "device": str(dev),
                          "backend": torch.distributed.get_backend(),
                          "offset": shards[0].offset,
                          "global_rows": shards[0].global_shape[0],
                          "loss": loss}), flush=True)
    finally:
        torch.distributed.destroy_process_group()


def mesh_training(dev) -> dict:
    """(e): sharded_train_step over 8 positions of the card against
    make_train_step's single step (the loss within rtol 1e-4, every
    gradient within four bf16 steps of its largest element: the hidden
    layers round to bf16, and a gradient sums up to 16 rows of rounded
    terms); then the
    two-process multihost_train_step, both processes on the card: both
    print the same loss, within rtol 1e-4 of one process's step on the
    concatenated rows."""
    from gie_tpu_torch.models.latency import (
        LatencyPredictor, make_optimizer, make_train_step)
    from gie_tpu_torch.parallel import make_mesh, sharded_train_step

    predictor = LatencyPredictor()
    mesh = make_mesh(devices=[dev] * 8)
    batch = [t.to(dev) for t in mesh_train_batch(MESH_TRAIN_ROWS, 7)]
    losses, grads, times = [], [], []
    for step in (make_train_step(predictor),
                 sharded_train_step(mesh, predictor)):
        module = predictor.module(0).to(dev)
        opt = make_optimizer(module, predictor.cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(module, opt, *batch)))
        times.append((time.perf_counter() - t0) * 1e3)
        grads.append({k: p.grad.clone() for k, p in module.named_parameters()})
    check(abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0]),
          f"mesh train: sharded loss {losses[1]} vs single {losses[0]}")
    worst = 0.0
    for k, g in grads[0].items():
        gap = float((grads[1][k] - g).abs().max())
        scale = float(g.abs().max()) * 2.0 ** -6
        check(gap <= scale, f"mesh train: {k} gradient gap {gap} > {scale}")
        worst = max(worst, gap / max(scale, 1e-30))

    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.mesh_worker({rank}, 2, {port})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            check(p.returncode == 0, f"mesh worker failed:\n{err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    whole = [torch.cat([a, b]).to(dev) for a, b in zip(
        mesh_train_batch(MESH_HOST_ROWS, 100),
        mesh_train_batch(MESH_HOST_ROWS, 101))]
    module = predictor.module(0).to(dev)
    single = float(make_train_step(predictor)(
        module, make_optimizer(module, predictor.cfg), *whole))
    check(len({o["loss"] for o in outs}) == 1,
          f"mesh multihost: the ranks' losses differ: {outs}")
    check(abs(outs[0]["loss"] - single) <= 1e-4 * abs(single),
          f"mesh multihost: loss {outs[0]['loss']} vs one process {single}")
    rec = {"phase": "mesh-train", "positions": 8, "rows": MESH_TRAIN_ROWS,
           "single_loss": losses[0], "sharded_loss": losses[1],
           "grad_gap_of_bound": worst, "single_ms": times[0],
           "sharded_ms": times[1], "multihost": outs,
           "multihost_single_loss": single}
    emit(rec)
    return rec


def mesh_main_bursts(dev, kernels, tmp) -> dict:
    """(f): phase 6's server bursts through the runner main() builds with
    --mesh-devices 2 (dp 1 x tp 2 over two cards) and the blend-top-k
    profile, one launch a wave; it needs two cards, and with fewer the
    part is not run and one line says so."""
    from gie_tpu_torch.sched import ProfileConfig

    cards = torch.cuda.device_count()
    if cards < 2:
        rec = {"phase": "mesh-main", "run": False,
               "reason": f"--mesh-devices 2 needs 2 CUDA cards; this "
                         f"machine shows {cards}"}
        emit(rec)
        return rec
    stats = phase_server(dev, "mesh-devices-2",
                         ProfileConfig(picker="topk", use_pallas_topk=True),
                         None, kernels, "fused_blend_topk", tmp,
                         extra_argv=("--mesh-devices", "2"))
    rec = {"phase": "mesh-main", "run": True, "launches": stats["launches"]}
    emit(rec)
    return rec


def phase_mesh(dev, kernels, tmp) -> dict:
    """Phase 20: (a) the meshed cycle on 8 positions of one card against
    the unmeshed cycle, (b) a 1-position mesh through the captured cycle,
    (c) a meshed FleetPicker's Sinkhorn launches, (d) the conformance
    suite in "tpu-mesh", (e) the sharded and two-process training steps,
    (f) `main --mesh-devices 2` where there are two cards."""
    t0 = time.monotonic()
    equal = mesh_equivalence(dev, kernels)
    one = mesh_one(dev, kernels)
    fleet = mesh_fleet(dev, kernels)
    conformance = mesh_conformance(dev, kernels)
    train = mesh_training(dev)
    bursts = mesh_main_bursts(dev, kernels, tmp)
    launches = {k: equal["launches"][k] + fleet["launches"][k]
                + conformance["launches"][k]
                + bursts.get("launches", {}).get(k, 0) for k in kernels}
    summary = {"phase": "mesh", "seconds": time.monotonic() - t0,
               "launches": launches, "equal_cases": equal["cases"],
               "one_graph_launches_per_wave": one["graph_launches_per_wave"],
               "multihost_loss": train["multihost"][0]["loss"],
               "main_mesh_devices_run": bursts["run"]}
    emit(summary)
    for k in kernels:
        check(launches[k] >= 1, f"mesh: {k} not launched in phase 20")
    return summary


# -- phase 21: the cost model and the lint on the card ----------------------

COST_WIDTHS = (M, 1024)    # (a): the counts' widths; (b) profiles M's
COST_WAVES = 5             # (b): profiled replays per configuration
LINT_ROUNDS = 3            # (c): bursts with KV events and evictions beside
LINT_EVENT_THREADS = 8     # (c): handler threads posting KV events a burst
LINT_EVENTS = 32           # (c): apply_prefix_events calls per handler thread


def cost_counts(dev, kernels) -> dict:
    """(a): the card's count of each configuration of the cost model's
    table and width against the CPU's, op by op. -> {(name, m): the card's
    CycleCount}."""
    from gie_tpu_torch.utils.costmodel import configs, count_cycle

    out = {}
    for name, c in configs().items():
        for m in COST_WIDTHS:
            before = {k: fn.launches for k, fn in kernels.items()}
            t0 = time.perf_counter()
            card = count_cycle(c, N, m, device=dev)
            card_s = time.perf_counter() - t0
            cpu = count_cycle(c, N, m, device="cpu")
            torch.cuda.synchronize()
            launched = {k: fn.launches - before[k]
                        for k, fn in kernels.items()}
            differ = sorted(
                op for op in set(card.by_op) | set(cpu.by_op)
                if (card.by_op[op], card.bytes_by_op[op],
                    card.flops_by_op[op])
                != (cpu.by_op[op], cpu.bytes_by_op[op], cpu.flops_by_op[op]))
            emit({"phase": "cost-count", "config": name, "shape": [N, m],
                  **card.totals(), "cpu": cpu.totals(), "card_s": card_s,
                  "bytes_bound_ms": card.bytes / HBM_BYTES_PER_S * 1e3,
                  "launches": launched, "differing_ops": differ})
            check(not differ and card.totals() == cpu.totals(),
                  f"cost {name} {N}x{m}: the card's count differs from the "
                  f"CPU's in {differ}")
            want = {k: int(card.by_op.get(k, 0)) for k in kernels}
            check(launched == want,
                  f"cost {name} {N}x{m}: launches {launched}, counted {want}")
            out[(name, m)] = card
    return out


def cost_against_waves(dev, weights, counts) -> list:
    """(b): counted bytes over the card's memory rate beside the captured
    wave's device busy time and device operations (phase 9's profiler
    reading), on the fixture's own 1024 x M wave; each Scheduler is let
    go, and its graphs' pools emptied, before the next is built."""
    import gc

    from gie_tpu_torch.sched import Scheduler
    from gie_tpu_torch.utils.costmodel import configs, fixture

    table = configs()
    reqs, eps = fixture(N, M, "cpu")
    rows = []
    for name in ("tuned+use_pallas_sinkhorn", "topk+use_pallas_topk",
                 "tuned"):
        w = weights if name != "topk+use_pallas_topk" else None
        sched = Scheduler(table[name], w, device=dev, seed=21)
        sched.pick(reqs, eps)                  # captures the key inline

        def replay(r):
            pending = sched.pick_async(r, eps)
            return pending, pending.event

        prof = profiled(replay, [reqs] * COST_WAVES)
        del sched, replay
        gc.collect()
        torch.cuda.empty_cache()
        count = counts[(name, M)]
        bound_ms = count.bytes / HBM_BYTES_PER_S * 1e3
        rec = {"phase": "cost-wave", "config": name, "shape": [N, M],
               "bytes": count.bytes, "bytes_bound_ms": bound_ms,
               "ops_counted": count.ops,
               "device_ops_per_wave": prof["device_ops_per_wave"],
               "device_busy_ms_per_wave": prof["device_busy_ms_per_wave"],
               "bytes_bound_over_busy": (
                   bound_ms / prof["device_busy_ms_per_wave"]
                   if prof["device_busy_ms_per_wave"] else None),
               "wall_ms_per_wave_profiled":
                   prof["wall_ms_per_wave_profiled"],
               "device_idle_share": prof["device_idle_share"]}
        emit(rec)
        check(prof["launch_calls_by_name"].get("cudaGraphLaunch") == 1,
              f"cost {name} {N}x{M}: a wave is not one graph replay")
        rows.append(rec)
    return rows


def lint_tracker(dev, cfg, weights) -> dict:
    """(c): the lock tracker on a warmed pick service's scheduler and
    picker while handler threads queue KV events and a thread evicts
    slots beside bursts of live waves."""
    from gie_tpu_torch.lint.dynamic import LockTracker

    p = "gie_tpu_torch.sched."
    sched, ds, picker = pick_stack(dev, cfg, weights)
    tracker = LockTracker()
    try:
        cands = ds.pick_candidates()
        burst(picker, cands, pick_requests(-1, N))          # warm-up round
        for t in list(picker._warm_threads):
            t.join(600)
        for obj, attr, cls in (
                (sched, "_lock", "profile.Scheduler"),
                (sched, "_warm_lock", "profile.Scheduler"),
                (sched, "_queue_lock", "profile.Scheduler"),
                (picker, "_cond", "batching.BatchingTPUPicker"),
                (picker, "_inflight_cv", "batching.BatchingTPUPicker"),
                (picker, "_degraded_lock", "batching.BatchingTPUPicker")):
            name = f"{p}{cls}.{attr}"
            check(name in tracker.ranks, f"lint: {name} has no rank")
            tracker.wrap(obj, attr, name)
        slots = [ep.slot for ep in ds.endpoints()]
        rng = np.random.default_rng(21)
        errors, posted = [], [0]

        def handler(k):
            try:
                r = np.random.default_rng(1000 + k)
                for _ in range(LINT_EVENTS):
                    sched.apply_prefix_events(
                        int(r.choice(slots)),
                        r.integers(1, 2**32, 16, dtype=np.uint64)
                        .astype(np.uint32), np.zeros(0, np.uint32))
                    posted[0] += 1
            except Exception as e:   # collected: fails the phase below
                errors.append(repr(e))

        def evictions(victims):
            try:
                for slot in victims:
                    sched.evict_endpoint(slot)
            except Exception as e:
                errors.append(repr(e))

        answered = 0
        for w in range(LINT_ROUNDS):
            side = [threading.Thread(target=handler, args=(w * 100 + k,))
                    for k in range(LINT_EVENT_THREADS)]
            side.append(threading.Thread(target=evictions, args=(
                [int(x) for x in rng.choice(slots, 4, replace=False)],)))
            for t in side:
                t.start()
            res, _lat, _wall = burst(picker, cands, pick_requests(w, N))
            for t in side:
                t.join(120)
            check(not any(t.is_alive() for t in side),
                  "lint: a handler or eviction thread is still running")
            answered += sum(r is not None for r in res)
        check(not errors, f"lint: {len(errors)} side calls failed: "
                          f"{errors[:1]}")
        sched.snapshot_assumed_load()          # applies what is still queued
        with sched._queue_lock:
            left = len(sched._queued)
        tracker.assert_consistent()
        observed = sorted(tracker.observed())
        rec = {"phase": "lint-tracker", "rounds": LINT_ROUNDS,
               "picks": answered, "kv_event_calls": posted[0],
               "queued_left": left,
               "observed": [list(pair) for pair in observed],
               "inversions": len(tracker.violations)}
        emit(rec)
        check(answered == LINT_ROUNDS * N,
              f"lint: {answered} of {LINT_ROUNDS * N} picks answered")
        check(left == 0, f"lint: {left} queued calls never applied")
        check((f"{p}profile.Scheduler._lock",
               f"{p}profile.Scheduler._queue_lock") in observed,
              f"lint: the queued path's _lock -> _queue_lock nesting was "
              f"never observed: {observed}")
        return rec
    finally:
        picker.close()


def lint_cli() -> dict:
    """(d): the port's lint CLI over the port's tree on this machine."""
    import importlib.util

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "gie_tpu_torch.lint"],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    rec = {"phase": "lint-cli", "rc": out.returncode,
           "seconds": time.perf_counter() - t0,
           "stdout_tail": out.stdout[-400:], "stderr_tail": out.stderr[-400:],
           "jax_installed": importlib.util.find_spec("jax") is not None}
    emit(rec)
    check(out.returncode == 0 and "gie-lint: clean" in out.stdout,
          f"lint: python -m gie_tpu_torch.lint exited {out.returncode}")
    return rec


def phase_cost(dev, cfg, weights, kernels) -> dict:
    """Phase 21: (a) the cost model's count on the card against the CPU's,
    (b) the counted bytes beside the captured wave's device time, (c) the
    lock tracker under live waves, (d) the lint CLI."""
    t0 = time.monotonic()
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    counts = cost_counts(dev, kernels)
    waves = cost_against_waves(dev, weights, counts)
    tracker = lint_tracker(dev, cfg, weights)
    cli = lint_cli()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    summary = {"phase": "cost", "seconds": time.monotonic() - t0,
               "launches": launches, "counts_equal_cpu": len(counts),
               "waves": [{k: r[k] for k in ("config", "shape",
                                            "bytes_bound_ms",
                                            "device_busy_ms_per_wave")}
                         for r in waves],
               "tracker_nestings": len(tracker["observed"]),
               "lint_rc": cli["rc"]}
    emit(summary)
    for k in kernels:
        check(launches[k] >= 1, f"cost: {k} not launched in phase 21")
    return summary


PHASE_SECONDS: dict = {}


def timed(name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), its wall seconds added to PHASE_SECONDS[name]
    for the "timing" line (the whole script must end within its time
    limit as it grows)."""
    t0 = time.monotonic()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_SECONDS[name] = (PHASE_SECONDS.get(name, 0.0)
                               + time.monotonic() - t0)


def tail(path: str, n: int = 4000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gie_tpu_torch.ops import build
    from gie_tpu_torch.ops.fused_sinkhorn import fused_sinkhorn_plan
    from gie_tpu_torch.ops.fused_topk import fused_blend_topk
    from gie_tpu_torch.sched import ProfileConfig
    from gie_tpu_torch.sched.config import tuned_profile

    t_start = time.monotonic()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})

    build.library()
    emit({"phase": "build", "seconds": build.last_build["seconds"],
          "cached": build.last_build["cached"]})
    print(build.last_build["log"], file=sys.stderr)

    records = timed("kernels", phase_kernels, dev)

    cfg, weights = tuned_profile()
    cfg = dataclasses.replace(cfg, use_pallas_sinkhorn=True)
    topk_cfg = ProfileConfig(picker="topk", use_pallas_topk=True)
    kernels = {"fused_sinkhorn_plan": fused_sinkhorn_plan,
               "fused_blend_topk": fused_blend_topk}
    # (name, cfg, weights, kernels, the kernel it runs) of the two kernel
    # configurations, which the phases that take them run in turn.
    both = (("tuned+use_pallas_sinkhorn", cfg, weights, kernels,
             "fused_sinkhorn_plan"),
            ("topk+use_pallas_topk", topk_cfg, None, kernels,
             "fused_blend_topk"))
    sink, topk = (timed("slice", phase_slice, dev, *c) for c in both)
    pick_sink, pick_topk = (timed("picker", phase_picker, dev, *c)
                            for c in both)
    with tempfile.TemporaryDirectory() as tmp:
        serve_sink, serve_topk = (timed("server", phase_server, dev, *c, tmp)
                                  for c in both)
        timed("main", phase_main, cfg, weights, tmp)
    chaos_sink, chaos_topk = (timed("chaos", phase_chaos, dev, *c)
                              for c in both)
    warm_sink, warm_topk = (timed("warm", phase_warm, dev, *c) for c in both)
    timed("storm", phase_storm, dev, kernels)
    pd_sink, pd_topk = (timed("pd", phase_pd, dev, *c) for c in both)
    with tempfile.TemporaryDirectory() as tmp:
        kv = timed("kvevents", phase_kvevents, dev, kernels, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        learn = timed("learn", phase_learn, dev, kernels, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        ha = timed("ha", phase_ha, dev, cfg, weights, kernels, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        fed = timed("fed", phase_fed, dev, cfg, weights, kernels, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        fleet = timed("fleet", phase_fleet, dev, cfg, weights, kernels, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        pred = timed("predictor", phase_predictor, dev, cfg, weights,
                     kernels, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        kube = timed("kube", phase_kube, dev, cfg, weights, kernels, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        mesh = timed("mesh", phase_mesh, dev, kernels, tmp)
    cost = timed("cost", phase_cost, dev, cfg, weights, kernels)

    line = []
    for rec, phases, source, replaces in (
        (records["fused_sinkhorn_plan"],
         (sink, pick_sink, serve_sink, chaos_sink, warm_sink, pd_sink,
          learn, ha, fed, fleet, pred, kube, mesh, cost),
         "gie_tpu_torch/ops/csrc/fused_sinkhorn.cu",
         "gie_tpu/ops/fused_sinkhorn.py:66"),
        (records["fused_blend_topk"],
         (topk, pick_topk, serve_topk, chaos_topk, warm_topk, pd_topk, kv,
          fleet, pred, kube, mesh, cost),
         "gie_tpu_torch/ops/csrc/fused_topk.cu",
         "gie_tpu/ops/fused_topk.py:80"),
    ):
        launches = sum(p["launches"][rec["name"]] for p in phases)
        check(launches >= 1, f"{rec['name']}: not launched on the main path")
        line.append({
            "name": rec["name"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    emit({"phase": "timing", "seconds": PHASE_SECONDS,
          "total_s": time.monotonic() - t_start})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
