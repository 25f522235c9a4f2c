#!/usr/bin/env python3
"""Where the pick service's host time goes for one 1024-request wave.

    python3 hack/torch_pick_breakdown.py [--device cuda] [--waves 10]

Builds chip_smoke.py's pick stack (256 ready pods, north-star metric rows,
BatchingTPUPicker over a Scheduler on the card) in both kernel
configurations and walks the dispatcher's stages by hand, one wave at a
time, with no concurrent callers: `_Pending` construction for 1024 picks
(done on the callers' threads in pick()), the drained-cost ledger, the
endpoint snapshot and M bucket, chunk hashing alone, the rest of
assemble_wave, MetricsStore.endpoint_batch, the host-to-device copies of
the two batches alone, pick_async (copies, launches and result copies
queued) and the wait for the wave's results. Prints one JSON line per
configuration with the median of each stage in ms over `--waves` waves
after three warm-up waves. The stages the picker's HOST_ASSEMBLY covers
are summed as `assembly_ms`. On the CPU (--device cpu, a rehearsal) the
cycle runs inside pick_async.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--waves", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    from chip_smoke import N, pick_requests, pick_stack
    from gie_tpu_torch.sched import ProfileConfig
    from gie_tpu_torch.sched.batching import _Pending, assemble_wave
    from gie_tpu_torch.sched.config import tuned_profile
    from gie_tpu_torch.sched.hashing import batch_chunk_hashes
    from gie_tpu_torch.sched.profile import _batch_to_device

    dev = torch.device(args.device)
    on_cuda = dev.type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        print("torch_pick_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    tuned, tuned_w = tuned_profile()
    configs = (
        ("tuned+use_pallas_sinkhorn",
         dataclasses.replace(tuned, use_pallas_sinkhorn=True), tuned_w),
        ("topk+use_pallas_topk",
         ProfileConfig(picker="topk", use_pallas_topk=True), None),
    )
    for name, cfg, weights in configs:
        sched, ds, picker = pick_stack(dev, cfg, weights)
        stages: dict[str, list[float]] = {}
        try:
            cands = ds.pick_candidates()
            for w in range(3 + args.waves):
                reqs = pick_requests(w, N)
                sync()
                marks = [("start", time.perf_counter())]

                def mark(stage):
                    marks.append((stage, time.perf_counter()))

                items = [_Pending(r, cands) for r in reqs]
                mark("enqueue_pending")
                picker.fairness.note_wave(items)
                mark("note_wave")
                endpoints = ds.endpoints()
                mb = picker._pick_m_bucket(endpoints)
                mark("endpoints_and_m_bucket")
                batch_chunk_hashes([it.req.body for it in items])
                mark("chunk_hashes")
                rb, _, _, _ = assemble_wave(items, mb, picker.lora_registry)
                mark("assemble_wave")
                eps = picker.metrics_store.endpoint_batch(endpoints,
                                                          m_slots=mb)
                mark("endpoint_batch")
                _batch_to_device(rb, dev)
                _batch_to_device(eps, dev)
                mark("h2d_copies_alone")
                pending = sched.pick_async(rb, eps)
                mark("pick_async")
                pending.materialize()
                mark("materialize_wait")
                if w < 3:
                    continue
                for (_, t0), (stage, t1) in zip(marks, marks[1:]):
                    stages.setdefault(stage, []).append((t1 - t0) * 1e3)
        finally:
            picker.close()
        med = {k: statistics.median(v) for k, v in stages.items()}
        # assemble_wave hashes the prompts itself: its median here excludes
        # the separate chunk_hashes stage, which it repeats.
        med["assemble_wave_without_hashing"] = med.pop("assemble_wave")
        assembly = (med["endpoints_and_m_bucket"] + med["chunk_hashes"]
                    + med["assemble_wave_without_hashing"]
                    + med["endpoint_batch"] + med["pick_async"])
        print(json.dumps({
            "config": name, "device": str(dev),
            "device_name": torch.cuda.get_device_name(0) if on_cuda else None,
            "requests_per_wave": N, "endpoints": len(cands),
            "waves": args.waves, "stage_ms_median": med,
            "assembly_ms": assembly,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
