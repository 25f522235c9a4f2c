"""Run chip_smoke.py's phase 20 (the multi-device slice) alone on the card.

    python3 hack/torch_mesh_phase.py [--parts p,a,b,c,d,e,f]

Prints the device line (torch, CUDA, the card's name and count, nvidia-smi's
name and power limit), builds the kernels as chip_smoke.main does, then runs
the parts of phase 20 asked for (p, a probe: the blend, the grouped
Sinkhorn solve and the grouped endpoint sum over each layout's blocks
against the whole tensor, bit for bit; (a) the meshed cycle on 8 positions of one
card against the unmeshed cycle, (b) a 1-position mesh through the captured
cycle, (c) a meshed FleetPicker, (d) the conformance suite in "tpu-mesh",
(e) the sharded and two-process training steps, (f) `main --mesh-devices
2` where there are two cards), each printing its JSON lines, and the
part's wall seconds. Exits non-zero on a failed check. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def probe(dev) -> None:
    """Part p: each cross-shard float step of the meshed cycle against the
    whole tensor on the card, at 1024 x 256 and 1024 x 1024 and each of
    phase 20's layouts, printing which are bit-equal: the blend, the
    grouped Sinkhorn solve (plan and duals) and the grouped endpoint sum."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gie_tpu_torch.sched.profile import blend
    from gie_tpu_torch.sched.sinkhorn import (
        _solve_plan, _sum_m_shards)

    for m in cs.MESH_WIDTHS:
        k, cap, warm = cs.sinkhorn_inputs(cs.N, m, seed=m, dev=dev)
        rng = np.random.default_rng(m)
        stacked = torch.from_numpy(rng.uniform(size=(6, cs.N, m)).astype(
            np.float32)).to(dev)
        wvec = torch.tensor([1.0, 2.0, 0.5, 3.0, 0.25, 1.5], device=dev)
        plan, v = _solve_plan(k, cap, warm, iters=8)
        whole = blend(wvec, stacked)
        total = _sum_m_shards([cap], dev)
        for dp, tp in cs.MESH_LAYOUTS:
            n_loc, m_loc = cs.N // dp, m // tp
            rows = [slice(i * n_loc, (i + 1) * n_loc) for i in range(dp)]
            cols = [slice(j * m_loc, (j + 1) * m_loc) for j in range(tp)]
            kb = [[k[r, c].contiguous() for c in cols] for r in rows]
            pb, vb = _solve_plan(kb, [cap[c].contiguous() for c in cols],
                                 [warm[c].contiguous() for c in cols],
                                 iters=8)
            gp = torch.cat([torch.cat(row, 1) for row in pb], 0)
            bb = torch.cat([torch.cat([blend(
                wvec, stacked[:, r, c].contiguous()) for c in cols], 1)
                for r in rows], 0)
            sm = _sum_m_shards([cap[c].contiguous() for c in cols], dev)
            torch.cuda.synchronize()
            print(json.dumps({
                "probe": [dp, tp], "shape": [cs.N, m],
                "blend_equal": bool(torch.equal(bb, whole)),
                "plan_equal": bool(torch.equal(gp, plan)),
                "plan_max_diff": float((gp - plan).abs().max()),
                "duals_equal": bool(torch.equal(torch.cat(vb), v)),
                "sum_m_equal": bool(torch.equal(sm, total))}), flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="a,b,c,d,e,f",
                    help="p (a probe of each cross-shard step) and a-f")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mesh_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gie_tpu_torch.ops import build
    from gie_tpu_torch.ops.fused_sinkhorn import fused_sinkhorn_plan
    from gie_tpu_torch.ops.fused_topk import fused_blend_topk

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    cs.emit({"phase": "device", "torch": torch.__version__,
             "cuda": torch.version.cuda,
             "name": torch.cuda.get_device_name(0),
             "count": torch.cuda.device_count(), "nvidia_smi": smi})
    build.library()
    dev = torch.device("cuda")
    kernels = {"fused_sinkhorn_plan": fused_sinkhorn_plan,
               "fused_blend_topk": fused_blend_topk}
    parts = {
        "p": lambda tmp: probe(dev),
        "a": lambda tmp: cs.mesh_equivalence(dev, kernels),
        "b": lambda tmp: cs.mesh_one(dev, kernels),
        "c": lambda tmp: cs.mesh_fleet(dev, kernels),
        "d": lambda tmp: cs.mesh_conformance(dev, kernels),
        "e": lambda tmp: cs.mesh_training(dev),
        "f": lambda tmp: cs.mesh_main_bursts(dev, kernels, tmp),
    }
    for name in args.parts.split(","):
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory() as tmp:
            parts[name](tmp)
        print(json.dumps({"part": name,
                          "seconds": time.monotonic() - t0}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
