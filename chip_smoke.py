#!/usr/bin/env python3
"""Drive gie_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero). On the
card every wave of phases 3-6, 8-10, 12 and 13 is a replay of the scheduling
cycle captured as a CUDA graph for its shape (sched/graphs.py): the first
wave of a shape captures it inline, the runner's picker (phases 6-7)
captures its lattices on background threads, and each kernel's launch
count adds the launches a replay makes:
  1. device and build: the card, then the kernels built from ops/csrc/;
  2. kernels vs plain: each CUDA kernel against its plain PyTorch version
     at the main path's shapes (1024 requests x 256 and x 1024 endpoints,
     cold and warm duals) and at edge shapes (Sinkhorn N=1, 7, 8 and
     1024x64; blend-top-k M=40, 37, 2048 and [3, 9, 64]), with CUDA-event
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
     scraped every 500 ms; 4 client processes (Envoy's part) send 4
     bursts of 1024 concurrent streams over 16 channels (request headers,
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
 11. the `kernels` line: launches on the main path (phases 3-6, 8, 9, 12,
     13 and 14, replays counted), error, times, bound.
Then the card's name and power limit (nvidia-smi), and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
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
    wvec = torch.tensor([2.0, 1.0, 1.5, 4.0, 8.0, 1.0][:s], device=dev)
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
        fused_sinkhorn_plan, fused_sinkhorn_plan_reference, layout)
    from gie_tpu_torch.ops.fused_topk import (
        fused_blend_topk, fused_blend_topk_reference)
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
        b_ms, b_by = bound(nbytes=2 * N * m * 4 + 3 * m * 4,
                           flops=(8 * 4 + 5) * N * m)
        rec = {"name": "fused_sinkhorn_plan", "shape": [N, m],
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None,
               "layout": layout(dev, N, m)._asdict()}
        emit({"phase": "kernel", **rec})
        records.setdefault("fused_sinkhorn_plan", rec)

    s = 6
    for m in (M, 1024):
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
        b_ms, b_by = bound(nbytes=s * N * m * 4 + N * m + s * 4 + N * 4 * 8,
                           flops=(2 * s + 1 + 2 * 4) * N * m)
        rec = {"name": "fused_blend_topk", "shape": [s, N, m],
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": library_ms}
        emit({"phase": "kernel", **rec})
        records.setdefault("fused_blend_topk", rec)
    return records


def workload(dev):
    """bench.py's north-star mix: the endpoints, and wave(w) -> wave w."""
    from gie_tpu_torch.sched.types import chunk_bucket_for
    from gie_tpu_torch.utils.testing import make_endpoints, make_requests

    rng = np.random.default_rng(0)
    eps = make_endpoints(M, queue=rng.integers(0, 50, M).tolist(),
                         kv=rng.uniform(0, 0.95, M).tolist(), max_lora=8,
                         m_slots=M, device=dev)

    def wave(w):
        prompts = [(BASE % ((i + w) % 16)) * 6 + b"user question %d" % (i + N * w)
                   for i in range(N)]
        reqs = make_requests(N, prompts=prompts,
                             lora_id=rng.integers(-1, 12, N).tolist(),
                             m_slots=M, device=dev)
        cb = chunk_bucket_for(int(reqs.n_chunks.max()))
        return reqs.replace(chunk_hashes=reqs.chunk_hashes[:, :cb].contiguous())

    return eps, wave


def phase_slice(dev, name, cfg, weights, kernels, own) -> dict:
    """Drive `cfg` on the card over carried waves; replay every wave on a
    CPU Scheduler from the same state with the same noise. Every kernel
    wrapper's launch count is set to 0 just before the drive and read just
    after; the path's own kernel (`own`) must launch once per wave, and
    with `own` None (phase 14's random picker) no kernel at all."""
    from gie_tpu_torch import convert
    from gie_tpu_torch.sched import Scheduler
    from gie_tpu_torch.sched.profile import gumbel_noise, request_cost_host
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
        ref = cpu.pick(cpu_waves[w], eps_cpu)
        check((res.status == ref.status).all(), f"{name}: statuses differ")
        ok = res.status == 0
        prim = res.indices[ok, 0]
        check(bool(((prim >= 0) & (prim < M)).all()) and bool(valid[prim].all()),
              f"{name}: an OK pick names an invalid slot")
        check(bool(np.isfinite(res.scores[ok, 0]).all()),
              f"{name}: non-finite score on an OK pick")
        differ = res.indices[:, 0] != ref.indices[:, 0]
        gap = ref.scores[:, 0] - ref.scores[:, 1]
        check(bool((gap[differ] < 1e-4).all()),
              f"{name}: a pick differs where the CPU top-two gap >= 1e-4")
        agree += int((~differ).sum())
        allowed += int(differ.sum())
        rows += len(differ)
        # Completion feedback for the first half of the wave.
        half = res.indices[: N // 2, 0]
        costs = np.asarray([request_cost_host(float(p)) for p in
                            reqs.prompt_len[: N // 2].cpu().numpy()],
                           np.float32)
        gpu.complete(half, costs)
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


def same_storm(card_run, cpu_run) -> None:
    """A card run and its CPU run reached the same decisions."""
    a, b = card_run["scorecard"], cpu_run["scorecard"]
    name = a["name"]
    fields = ("decision_fingerprint",) + STORM_COUNTS
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

STREAM_ROUNDS, STREAMS_PER_ROUND, CHANNELS = 4, 1024, 16
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


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


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


def fleet_ips(n: int) -> list:
    """Pod i's own loopback address."""
    return [f"127.1.{i // 200}.{i % 200 + 1}" for i in range(n)]


def stub_fleet_process(n: int, seed: int, ready, stop, events=None) -> None:
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
    counter; while it is clear they are discarded."""
    import http.server
    import urllib.request

    from gie_tpu_torch.simulator import StubConfig, VLLMStub

    ips = fleet_ips(n)
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


def stream_frames(w: int, i: int):
    """Stream i of round w as Envoy sends it: request headers (the body
    follows), the JSON body of the north-star mix, and -> the response
    headers frame echoing the served endpoint. -> (headers, body,
    response_headers(hostport), prompt)."""
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
                       raw_value=b"tenant-%d" % (i % 4))])
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


def one_stream(method, w, i):
    """One Envoy-shaped exchange. -> (destination, seconds to the pick,
    seconds for the whole stream)."""
    import queue as _queue

    headers, body, response_headers, _ = stream_frames(w, i)
    q = _queue.Queue()
    q.put(headers)
    q.put(body)
    t0 = time.perf_counter()
    # Generous: a burst queues behind 4 x 64 handler threads on a shared
    # host; the phase reports latency, and fails only on a lost stream.
    call = method(iter(q.get, None), timeout=STREAM_TIMEOUT_S)
    first = next(call)
    t_pick = time.perf_counter() - t0
    dest = destination(first)
    next(call)                                  # the request-body response
    if dest is not None:
        q.put(response_headers(dest.split(",")[0]))
        next(call)                              # the response-headers response
    q.put(None)
    for _ in call:
        pass
    return dest, t_pick, time.perf_counter() - t0


def client_process(port: int, channels: int, rounds, share, total: int,
                   barrier, results) -> None:
    """Envoy's side, in a process of its own: for each round w, wait on
    `barrier` with the other clients and the server's process, then open
    streams i = share, share + k, ... (< total) all at once, one thread
    each, over this process's channels. Puts (w, [(i, destination, pick s,
    stream s, error)], first start, last end) on `results`."""
    chans, methods = open_channels(port, channels)
    mine = list(range(share, total, CLIENTS))
    try:
        for w in rounds:
            out = [None] * len(mine)
            t_in = [0.0] * len(mine)
            t_out = [0.0] * len(mine)
            gate = threading.Barrier(len(mine) + 1)

            def run(j, w=w, out=out, t_in=t_in, t_out=t_out, gate=gate):
                gate.wait(300)
                t_in[j] = time.monotonic()
                try:
                    out[j] = (mine[j],) + one_stream(
                        methods[j % len(methods)], w, mine[j]) + ("",)
                except Exception as e:
                    out[j] = (mine[j], None, 0.0, 0.0, repr(e)[:300])
                t_out[j] = time.monotonic()

            threads = [threading.Thread(target=run, args=(j,))
                       for j in range(len(mine))]
            for t in threads:
                t.start()
            barrier.wait(600)
            gate.wait(300)
            for t in threads:
                t.join(600)
            results.put((w, out, min(t_in), max(t_out)))
    finally:
        for c in chans:
            c.close()


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


def phase_server(dev, name, cfg, weights, kernels, own, tmp) -> dict:
    """The ext-proc server on the card for one configuration: the runner
    main() would build, over 256 stub pods (a process of their own), under
    bursts of concurrent Envoy-shaped streams from CLIENTS client
    processes; then sequential streams replayed on a CPU runner."""
    need_transport()
    import multiprocessing

    from gie_tpu_torch import obs
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.runtime.health import SERVING
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner

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
                "--scrape-interval-ms", str(SCRAPE_INTERVAL_MS)]
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
            barrier.wait(600)
            got = [results.get(timeout=900) for _ in range(CLIENTS)]
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
    import os
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
        picks = json.loads(http_get(mport, f"/debugz/picks?n={MAIN_STREAMS}"))
        recorded = {r.get("trace_id") for r in picks}
        check(len(picks) == MAIN_STREAMS and recorded == set(trace_ids),
              f"main: /debugz/picks holds {len(picks)} records, "
              f"{len(recorded & set(trace_ids))} of the streams' traces")
        check({r.get("rung") for r in picks} == {"full"},
              f"main: picks answered by {sorted({r.get('rung') for r in picks})}")
        one = json.loads(http_get(mport, f"/debugz/trace?id={trace_ids[7]}"))
        check(one.get("trace_id") == trace_ids[7] and one.get("events"),
              f"main: /debugz/trace returned {one}")
        om = http_get(mport, "/metrics",
                      accept="application/openmetrics-text; version=1.0.0")
        exemplar = re.search(
            rb'gie_pick_latency_seconds_bucket\{le="[^"]+"\} [0-9.e+]+ '
            rb'# \{trace_id="([0-9a-f]{32})"\}', om)
        check(exemplar is not None and om.rstrip().endswith(b"# EOF"),
              "main: the OpenMetrics exposition has no trace_id exemplar "
              "on gie_pick_latency_seconds")
        # The runner's lattice kick: the streams' lattice (M=64 for 8
        # pods, 8 chunk lanes for a bodyless request) warms in full.
        from gie_tpu_torch.sched.constants import N_BUCKETS

        lattice = {(n, 64, 8) for n in N_BUCKETS}
        deadline = time.monotonic() + 120
        while True:
            report = json.loads(http_get(mport, "/debugz/scheduler"))
            warm_buckets = {tuple(k) for k in report["warm_buckets"]}
            if lattice <= warm_buckets or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        emit({"phase": "main-warm", "warm_buckets": report["warm_buckets"],
              "warm_inline_compiles": report["warm_inline_compiles"]})
        check(lattice <= warm_buckets,
              f"main: the streams' lattice is not warm: {report}")
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


def timed_waves(dev, cfg, weights, eps, waves) -> dict:
    """pick_async's host time and the wall time per wave of `cfg` over
    `waves`, chained, on a fresh Scheduler whose key is captured first."""
    from gie_tpu_torch import ops
    from gie_tpu_torch.sched import Scheduler

    sched = Scheduler(cfg, weights, device=dev, seed=12)
    with ops.tally({}):            # timing launches are not the main path's
        sched.pick(waves[0], eps)

        def dispatch(reqs):
            pending = sched.pick_async(reqs, eps)
            return pending, pending.event

        host, wall, _ = run_waves(dispatch, waves)
    return {"pick_async_host_ms_median": statistics.median(host),
            "wall_ms_per_wave": wall}


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
            card, ref = sched.export_state(), cpu.export_state()
            differ = [k for k in ref if card[k].tobytes() != ref[k].tobytes()]
            check(not differ, f"kv-events: {what}: the card's export differs "
                              f"from the CPU's in {differ}")

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
        diff = [k for k in saved if got[k].dtype != saved[k].dtype
                or not np.array_equal(got[k], saved[k])]
        check(set(got) == set(saved) and not diff,
              f"checkpoint: {what} differs from the saved state in {diff}")

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

    records = phase_kernels(dev)

    cfg, weights = tuned_profile()
    cfg = dataclasses.replace(cfg, use_pallas_sinkhorn=True)
    kernels = {"fused_sinkhorn_plan": fused_sinkhorn_plan,
               "fused_blend_topk": fused_blend_topk}
    sink = phase_slice(dev, "tuned+use_pallas_sinkhorn", cfg,
                       weights, kernels, "fused_sinkhorn_plan")
    topk = phase_slice(dev, "topk+use_pallas_topk",
                       ProfileConfig(picker="topk", use_pallas_topk=True),
                       None, kernels, "fused_blend_topk")

    pick_sink = phase_picker(dev, "tuned+use_pallas_sinkhorn", cfg, weights,
                             kernels, "fused_sinkhorn_plan")
    pick_topk = phase_picker(dev, "topk+use_pallas_topk",
                             ProfileConfig(picker="topk", use_pallas_topk=True),
                             None, kernels, "fused_blend_topk")

    with tempfile.TemporaryDirectory() as tmp:
        serve_sink = phase_server(dev, "tuned+use_pallas_sinkhorn", cfg,
                                  weights, kernels, "fused_sinkhorn_plan", tmp)
        serve_topk = phase_server(
            dev, "topk+use_pallas_topk",
            ProfileConfig(picker="topk", use_pallas_topk=True), None,
            kernels, "fused_blend_topk", tmp)
        phase_main(cfg, weights, tmp)

    chaos_sink = phase_chaos(dev, "tuned+use_pallas_sinkhorn", cfg, weights,
                             kernels, "fused_sinkhorn_plan")
    chaos_topk = phase_chaos(dev, "topk+use_pallas_topk",
                             ProfileConfig(picker="topk", use_pallas_topk=True),
                             None, kernels, "fused_blend_topk")

    warm_sink = phase_warm(dev, "tuned+use_pallas_sinkhorn", cfg, weights,
                           kernels, "fused_sinkhorn_plan")
    warm_topk = phase_warm(dev, "topk+use_pallas_topk",
                           ProfileConfig(picker="topk", use_pallas_topk=True),
                           None, kernels, "fused_blend_topk")

    phase_storm(dev, kernels)

    pd_sink = phase_pd(dev, "tuned+use_pallas_sinkhorn", cfg, weights,
                       kernels, "fused_sinkhorn_plan")
    pd_topk = phase_pd(dev, "topk+use_pallas_topk",
                       ProfileConfig(picker="topk", use_pallas_topk=True),
                       None, kernels, "fused_blend_topk")
    with tempfile.TemporaryDirectory() as tmp:
        kv = phase_kvevents(dev, kernels, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        learn = phase_learn(dev, kernels, tmp)

    line = []
    for rec, phases, source, replaces in (
        (records["fused_sinkhorn_plan"],
         (sink, pick_sink, serve_sink, chaos_sink, warm_sink, pd_sink,
          learn),
         "gie_tpu_torch/ops/csrc/fused_sinkhorn.cu",
         "gie_tpu/ops/fused_sinkhorn.py:66"),
        (records["fused_blend_topk"],
         (topk, pick_topk, serve_topk, chaos_topk, warm_topk, pd_topk, kv),
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
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
