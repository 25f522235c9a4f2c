"""Run chip_smoke.py's phases 1-6 in fresh processes, taking trees in turns.

    python3 hack/torch_phase6_runs.py --runs 10 _trees/parent . [--timeout S]

Each run is one new process started in the tree's own directory (so it
imports that tree's chip_smoke and gie_tpu_torch): the device line, the
kernel build, phase 2 (kernels against their plain versions), phases 3-4
(the slice), phase 5 (the pick service) and phase 6 (the ext-proc server)
for both kernel configurations, as chip_smoke.main runs them. Trees are
taken in turns (A B A B ...). A run's whole output goes to
<--out>/<run>.<tree>.log; one JSON line per run says whether it
passed, how long it took, the first failed check and phase 6's per-round
lines (``server-round``, printed by trees that have them). The last line
gives each tree's pass count. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CHILD = r"""
import sys, tempfile, dataclasses
import torch
import chip_smoke as cs
from gie_tpu_torch.ops import build
from gie_tpu_torch.ops.fused_sinkhorn import fused_sinkhorn_plan
from gie_tpu_torch.ops.fused_topk import fused_blend_topk
from gie_tpu_torch.sched import ProfileConfig
from gie_tpu_torch.sched.config import tuned_profile

if not torch.cuda.is_available():
    sys.exit("no CUDA device")
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
build.library()
cs.phase_kernels(dev)
cfg, weights = tuned_profile()
cfg = dataclasses.replace(cfg, use_pallas_sinkhorn=True)
topk = ProfileConfig(picker="topk", use_pallas_topk=True)
kernels = {"fused_sinkhorn_plan": fused_sinkhorn_plan,
           "fused_blend_topk": fused_blend_topk}
configs = (("tuned+use_pallas_sinkhorn", cfg, weights, "fused_sinkhorn_plan"),
           ("topk+use_pallas_topk", topk, None, "fused_blend_topk"))
for name, c, w, own in configs:
    cs.phase_slice(dev, name, c, w, kernels, own)
for name, c, w, own in configs:
    cs.phase_picker(dev, name, c, w, kernels, own)
with tempfile.TemporaryDirectory() as tmp:
    for name, c, w, own in configs:
        cs.phase_server(dev, name, c, w, kernels, own, tmp)
print("PHASES_1_6_OK", flush=True)
"""


def one_run(tree: str, tag: str, index: int, out_dir: str,
            timeout: float) -> dict:
    log = os.path.join(out_dir, f"{index:02d}.{tag}.log")
    t0 = time.monotonic()
    with open(log, "w") as f:
        try:
            proc = subprocess.run(
                [sys.executable, "-c", CHILD], cwd=tree, stdout=f,
                stderr=subprocess.STDOUT, timeout=timeout)
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
    seconds = time.monotonic() - t0
    with open(log, errors="replace") as f:
        text = f.read()
    rounds, failure = [], None
    for line in text.splitlines():
        if line.startswith('{"phase": "server-round"'):
            rounds.append(json.loads(line))
        elif line.startswith(("RuntimeError:", "AssertionError")):
            failure = failure or line[:600]
    passed = rc == 0 and "PHASES_1_6_OK" in text
    return {"run": index, "tree": tag, "passed": passed, "rc": rc,
            "seconds": round(seconds, 1), "failure": failure,
            "rounds": rounds}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--runs", type=int, default=1,
                    help="runs per tree")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds one run may take")
    ap.add_argument("--out", default="_trees/phase6_runs",
                    help="directory for the runs' logs")
    args = ap.parse_args()
    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    tags = [os.path.basename(os.path.abspath(t)) or t for t in args.trees]
    passes = {t: 0 for t in tags}
    index = 0
    for _ in range(args.runs):
        for tree, tag in zip(args.trees, tags):
            rec = one_run(tree, tag, index, out_dir, args.timeout)
            passes[tag] += rec["passed"]
            print(json.dumps(rec), flush=True)
            index += 1
    print(json.dumps({"phase6_runs": args.runs, "passed": passes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
