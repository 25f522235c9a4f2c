#!/usr/bin/env python3
"""Time the port's two kernels from several trees in one run, on one card.

    python3 hack/torch_kernel_ab.py ROOT [ROOT ...]

Each ROOT is a directory holding a `gie_tpu_torch/` package (for example an
earlier commit unpacked with `git archive <commit> gie_tpu_torch | tar -x -C
ROOT`). For each ROOT in the order given (give the parent and the change as
parent, change, change, parent), a child process imports that package,
builds its kernels and, at the main path's shapes (Sinkhorn 1024 x 256 and
x 1024, warm duals; blend-top-k [6, 1024, 256] and [6, 1024, 1024]), prints
one JSON line per kernel and shape: the event time of back-to-back calls
(chip_smoke.cuda_ms), the device time (chip_smoke.device_ms) and, after
both, the device launches per call (torch.profiler over 5 calls). Inputs
come from this tree's chip_smoke.py. Ends with the card's name and power
limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str) -> int:
    sys.path[:0] = [os.path.abspath(root), REPO]
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import gie_tpu_torch
    from chip_smoke import (N, cuda_ms, device_ms, sinkhorn_inputs,
                            topk_inputs)
    from gie_tpu_torch.ops.fused_sinkhorn import fused_sinkhorn_plan
    from gie_tpu_torch.ops.fused_topk import fused_blend_topk

    dev = torch.device("cuda")
    where = os.path.dirname(os.path.dirname(gie_tpu_torch.__file__))
    for name, fn, shapes, make in (
        ("fused_sinkhorn_plan", fused_sinkhorn_plan, ((N, 256), (N, 1024)),
         lambda shape: sinkhorn_inputs(*shape, seed=sum(shape), dev=dev)),
        ("fused_blend_topk", fused_blend_topk, ((6, N, 256), (6, N, 1024)),
         lambda shape: topk_inputs(*shape, seed=shape[-1], dev=dev)),
    ):
        for shape in shapes:
            args = make(shape)
            rec = {"root": root, "package": where, "name": name,
                   "shape": list(shape), "ms": cuda_ms(lambda: fn(*args)),
                   "device_ms": device_ms(lambda: fn(*args))}
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn(*args)
                torch.cuda.synchronize()
            rec["device_launches_per_call"] = sum(
                e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA) / 5
            print(json.dumps(rec), flush=True)
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        return child(argv[1])
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--child", root], cwd=REPO).returncode
        if rc:
            return rc
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
