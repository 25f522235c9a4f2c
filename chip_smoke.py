#!/usr/bin/env python3
"""Drive gie_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):
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
  5. the `kernels` line: launches on the main path, error, times, bound.
Then the card's name and power limit (nvidia-smi), and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Device peaks for the bound (NVIDIA H100 SXM data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

N, M = 1024, 256
WAVES = 5
BASE = b"SYSTEM: You are a helpful assistant specialised in task %d. "


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
    after; the path's own kernel (`own`) must launch once per wave."""
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
    counter = kernels[own]
    for fn in kernels.values():
        fn.launches = 0
    wave_ms, agree, rows, allowed = [], 0, 0, 0
    for w, reqs in enumerate(waves):
        cpu.install_state(gpu.export_state())
        t0 = time.perf_counter()
        res = gpu.pick(reqs, eps)                  # materialize = synchronize
        wave_ms.append((time.perf_counter() - t0) * 1e3)
        check(counter.launches == w + 1,
              f"{name}: {counter.launches} kernel launches after {w + 1} waves")
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

    line = []
    for rec, summary, source, replaces in (
        (records["fused_sinkhorn_plan"], sink,
         "gie_tpu_torch/ops/csrc/fused_sinkhorn.cu",
         "gie_tpu/ops/fused_sinkhorn.py:66"),
        (records["fused_blend_topk"], topk,
         "gie_tpu_torch/ops/csrc/fused_topk.cu",
         "gie_tpu/ops/fused_topk.py:80"),
    ):
        launches = summary["launches"][rec["name"]]
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
