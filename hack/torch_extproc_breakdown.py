#!/usr/bin/env python3
"""Where the ext-proc server's host time goes, on one CUDA card.

    python3 hack/torch_extproc_breakdown.py

Builds the server as chip_smoke.py phase 6 does (the runner main() would
build, tuned profile + use_pallas_sinkhorn, 256 stub pods in a process of
their own, scrape interval 500 ms, 4 acceptors) and prints one JSON line
per measurement:

  transport   the transport alone per stream, one at a time, against a
              stub picker (no scheduler): the wire lane's three frames
              (request headers, JSON body, response headers) fed to a
              WireSession, and the same frames through the fast lane's
              process(); which host parsers ran (native/ or pure Python)
  sequential  whole streams one at a time through the card runner: in
              memory (runner.streaming.process) and over gRPC from this
              process, milliseconds per stream; and the stream's two
              picker calls alone: pick() (a one-request wave) and the
              served feedback that releases its charge
  burst       bursts of C concurrent streams from 4 client processes for
              C in 64, 256, 1024: streams/s, stream p50/p99, the server
              process's CPU seconds per stream (all its threads) and that
              CPU rate in cores, waves, wave-size median and max,
              HOST_ASSEMBLY and DEVICE_WAIT medians

Then the card's name and power limit (nvidia-smi).
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SEQUENTIAL = 200
BURSTS = (64, 256, 1024)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _median_us(fn, n: int) -> float:
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def transport_alone() -> dict:
    """Per-stream host cost of the transport against a stub picker."""
    from gie_tpu_torch.datastore import Datastore
    from gie_tpu_torch.datastore.objects import EndpointPool, Pod
    from gie_tpu_torch.extproc.pick import PickResult
    from gie_tpu_torch.extproc.server import StreamingServer

    class StubPicker:
        def pick(self, req, candidates):
            return PickResult(endpoint=candidates[0].hostport,
                              fallbacks=[c.hostport for c in candidates[1:4]])

    ds = Datastore()
    ds.pool_set(EndpointPool({"app": "vllm"}, [8000], "default"))
    for i, ip in enumerate(cs.fleet_ips(cs.M)):
        ds.pod_update_or_add(Pod(name=f"vllm-{i}", labels={"app": "vllm"},
                                 ip=ip))
    srv = StreamingServer(ds, StubPicker())

    frames = [cs.stream_frames(7, i) for i in range(64)]
    streams = [cs.EnvoyStream(7, i) for i in range(2100)]

    def wire(i):
        headers, body, response_headers, _ = frames[i % 64]
        session = srv.wire_session()
        out = session.feed(headers) + session.feed(body)
        session.feed(response_headers(cs.destination(out[0]).split(",")[0]))
        session.close()

    def fast(i):
        srv.process(streams[i])

    for i in range(50):
        wire(i)
        fast(2050 + i)
    return {"phase": "transport", "stub_picker": True,
            "wire_lane_us_per_stream": _median_us(wire, 2000),
            "fast_lane_us_per_stream": _median_us(fast, 2000),
            "host_parsers": cs.host_parsers()}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_extproc_breakdown: no CUDA device", file=sys.stderr)
        return 1
    cs.need_transport()
    from gie_tpu_torch.extproc.pick import PickRequest
    from gie_tpu_torch.runtime import metrics as own_metrics
    from gie_tpu_torch.runtime.runner import ExtProcServerRunner
    from gie_tpu_torch.sched.config import tuned_profile

    emit(transport_alone())

    cfg, weights = tuned_profile()
    cfg = dataclasses.replace(cfg, use_pallas_sinkhorn=True)
    ctx = multiprocessing.get_context("spawn")
    stop, ready = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=cs.stub_fleet_process,
                         args=(cs.M, 0, ready, stop), daemon=True)]
    procs[0].start()
    runner = None
    tmp = tempfile.mkdtemp()
    try:
        fleet_port = ready.get(timeout=120)
        argv = ["--insecure-serving", "--no-resilience", "--no-obs",
                "--scheduler-config",
                cs.write_scheduler_config(cfg, weights, tmp),
                "--pool-name", "smoke", "--grpc-port", str(cs.free_port()),
                "--grpc-health-port", str(cs.free_port()),
                "--metrics-port", str(cs.free_port()),
                "--extproc-workers", str(cs.EXTPROC_WORKERS),
                "--scrape-interval-ms", str(cs.SCRAPE_INTERVAL_MS)]
        runner = ExtProcServerRunner(
            cs.server_options(argv),
            cs.fleet_cluster("smoke", cs.fleet_ips(cs.M), fleet_port))
        runner.setup()
        port = runner.start()
        time.sleep(2 * cs.SCRAPE_INTERVAL_MS / 1000.0)

        def in_memory(i):
            runner.streaming.process(cs.EnvoyStream(8, i))

        chans, methods = cs.open_channels(port, 1)

        def over_grpc(i):
            cs.one_stream(methods[0], 9, i)

        picked = []

        def pick_only(i):
            picked.append(runner.picker.pick(
                PickRequest(headers={}, body=b"%d " % i + cs.BASE * 6),
                runner.datastore.pick_candidates()))

        def served_only(i):
            res = picked[i]
            runner.picker.observe_served(res.endpoint, SimpleNamespace(
                pick_result=res, resp_status=200, headers={},
                picked_at=time.monotonic()))

        for fn in (in_memory, over_grpc):
            for i in range(20):
                fn(i)
        emit({"phase": "sequential", "config": "tuned+use_pallas_sinkhorn",
              "in_memory_ms_per_stream": _median_us(in_memory, SEQUENTIAL)
              / 1e3,
              "grpc_ms_per_stream": _median_us(over_grpc, SEQUENTIAL) / 1e3,
              "pick_ms": _median_us(pick_only, SEQUENTIAL) / 1e3,
              "served_feedback_ms": _median_us(served_only, SEQUENTIAL)
              / 1e3})
        for c in chans:
            c.close()

        for j, size in enumerate(BURSTS):     # a warm round, a measured one
            barrier, results = ctx.Barrier(cs.CLIENTS + 1), ctx.Queue()
            clients = [ctx.Process(
                target=cs.client_process,
                args=(port, cs.CHANNELS // cs.CLIENTS, [100 + j, 200 + j], k,
                      size, barrier, results), daemon=True)
                for k in range(cs.CLIENTS)]
            for p in clients:
                p.start()
            procs += clients
            for w in (100 + j, 200 + j):
                if w >= 200:
                    marks = {h: h.count() for h in (
                        own_metrics.BATCH_SIZE, own_metrics.HOST_ASSEMBLY,
                        own_metrics.DEVICE_WAIT)}
                    waves0 = own_metrics.PIPELINE_WAVES.value()
                    cpu0 = time.process_time()
                    t0 = time.monotonic()
                barrier.wait(600)
                got = [results.get(timeout=900) for _ in range(cs.CLIENTS)]
            wall = time.monotonic() - t0
            cpu = time.process_time() - cpu0
            outcomes = [o for g in got for o in g[1]]
            errs = [o[4] for o in outcomes if o[4]]
            span = max(g[3] for g in got) - min(g[2] for g in got)
            recent = {h: cs.observed_since(h, marks[h]) for h in marks}
            sizes = recent[own_metrics.BATCH_SIZE]
            streams = [o[3] for o in outcomes]
            emit({"phase": "burst", "config": "tuned+use_pallas_sinkhorn",
                  "concurrent": size, "errors": len(errs),
                  "streams_per_s": len(outcomes) / span,
                  "stream_p50_ms": float(np.percentile(streams, 50)) * 1e3,
                  "stream_p99_ms": float(np.percentile(streams, 99)) * 1e3,
                  "server_cpu_ms_per_stream": cpu / len(outcomes) * 1e3,
                  "server_cpu_cores": cpu / wall,
                  "waves": int(own_metrics.PIPELINE_WAVES.value() - waves0),
                  "wave_size_median": statistics.median(sizes),
                  "wave_size_max": int(max(sizes)),
                  "host_assembly_ms_median": statistics.median(
                      recent[own_metrics.HOST_ASSEMBLY]) * 1e3,
                  "device_wait_ms_median": statistics.median(
                      recent[own_metrics.DEVICE_WAIT]) * 1e3})
            for p in clients:
                p.join(60)
    finally:
        stop.set()
        if runner is not None:
            runner.stop()
        for proc in procs:
            proc.join(30)
            if proc.is_alive():
                proc.terminate()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
