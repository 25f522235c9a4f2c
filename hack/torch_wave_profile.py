#!/usr/bin/env python3
"""Where one scheduling wave's time goes in gie_tpu_torch.

    python3 hack/torch_wave_profile.py [--device cuda] [--waves 5]

Runs chip_smoke.py's north-star workload (1024 requests x 256 endpoints)
through the port's Scheduler in both kernel configurations (tuned +
use_pallas_sinkhorn, and topk + use_pallas_topk): three warm-up waves, then
`--waves` waves under torch.profiler. Prints one JSON line per
configuration: wall time per wave (host clock, ends in a synchronize),
device busy time per wave (sum of kernel times; one stream, so kernels do
not overlap), the device's idle share, kernels run on the device per wave
(on the card a wave replays the cycle's CUDA graph, so these run from one
graph launch: chip_smoke.py phase 9 counts the host's launching calls),
the kernels and host ops that take the most time, and the device time and
count of the port's own kernels. On the CPU (--device cpu, for a
rehearsal) only host times exist.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# Device functions of the port's own kernels (ops/csrc/*.cu).
_PORT_KERNELS = ("sinkhorn_persistent", "blend_topk")


def _device_us(event) -> float:
    return float(getattr(event, "self_device_time_total", None)
                 or getattr(event, "self_cuda_time_total", 0.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--waves", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import workload
    from gie_tpu_torch.sched import ProfileConfig, Scheduler
    from gie_tpu_torch.sched.config import tuned_profile

    dev = torch.device(args.device)
    on_cuda = dev.type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        print("torch_wave_profile: no CUDA device", file=sys.stderr)
        return 1
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    tuned, tuned_w = tuned_profile()
    configs = (
        ("tuned+use_pallas_sinkhorn",
         dataclasses.replace(tuned, use_pallas_sinkhorn=True), tuned_w),
        ("topk+use_pallas_topk",
         ProfileConfig(picker="topk", use_pallas_topk=True), None),
    )
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_cuda else [])
    for name, cfg, weights in configs:
        sched = Scheduler(cfg, weights, device=dev)
        eps, wave = workload(dev)
        waves = [wave(w) for w in range(3 + args.waves)]
        for reqs in waves[:3]:
            sched.pick(reqs, eps)
        sync()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for reqs in waves[3:]:
                sched.pick(reqs, eps)
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3 / args.waves
        rows = prof.key_averages()
        kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
        busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / args.waves
        launches = sum(e.count for e in kernels) / args.waves
        top_kernels = sorted(kernels, key=_device_us, reverse=True)[:8]
        own = [e for e in kernels if any(
            name in e.key for name in _PORT_KERNELS)]
        host = [e for e in rows if e.device_type == DeviceType.CPU]
        top_host = sorted(host, key=lambda e: e.self_cpu_time_total,
                          reverse=True)[:6]
        print(json.dumps({
            "config": name, "device": str(dev),
            "device_name": (torch.cuda.get_device_name(0) if on_cuda
                            else None),
            "waves": args.waves, "wall_ms_per_wave": wall_ms,
            "device_busy_ms_per_wave": busy_ms if on_cuda else None,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if on_cuda else None,
            "kernel_launches_per_wave": launches if on_cuda else None,
            "top_kernels_ms_per_wave": [
                [e.key[:80], _device_us(e) / 1e3 / args.waves]
                for e in top_kernels],
            "port_kernels_ms_per_wave": [
                [e.key[:80], _device_us(e) / 1e3 / args.waves,
                 e.count / args.waves] for e in own],
            "top_host_ops_ms_per_wave": [
                [e.key[:80], e.self_cpu_time_total / 1e3 / args.waves]
                for e in top_host],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
