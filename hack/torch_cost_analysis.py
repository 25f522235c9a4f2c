#!/usr/bin/env python3
"""Bytes, flops and device operations of gie_tpu_torch's scheduling cycle.

    python3 hack/torch_cost_analysis.py [--device cpu] [--m 256,1024]

The port's counterpart of hack/cost_analysis.py. Counts one cycle of each
configuration of gie_tpu_torch/utils/costmodel.py's `configs()` on the
north-star fixture (the op counter tests/test_torch_cost_budget.py gates
and chip_smoke.py phase 21 runs on the card) and prints, per
configuration and width, one JSON line: bytes, flops and operations, the
bytes' time at the H100's 3.35 TB/s, the ten ops with the most bytes and
the ten the cycle runs most often, each op with its count, bytes and
flops, and the ten package functions that call the most ops (where to
fuse first). With
no --device it counts on the card (and raises without one); the counts
are the same on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
TOP = 10                       # rows of each table


def report(name: str, cfg, m: int, device) -> dict:
    from gie_tpu_torch.utils.costmodel import count_cycle

    c = count_cycle(cfg, n=1024, m=m, device=device)

    def row(op):
        return {"op": op, "count": c.by_op[op], "bytes": c.bytes_by_op[op],
                "flops": c.flops_by_op[op]}

    return {
        "config": name, "n": 1024, "m": m, "ops": c.ops, "bytes": c.bytes,
        "flops": c.flops, "bytes_bound_ms": c.bytes / HBM_BYTES_PER_S * 1e3,
        "top_bytes": [row(op) for op, _ in c.bytes_by_op.most_common(TOP)],
        "top_count": [row(op) for op, _ in c.by_op.most_common(TOP)],
        "top_sites": [{"site": site, "count": n,
                       "bytes": c.bytes_by_site[site]}
                      for site, n in c.by_site.most_common(TOP)],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    ap.add_argument("--m", default="256",
                    help="comma-separated endpoint widths")
    args = ap.parse_args(argv)
    from gie_tpu_torch.utils.costmodel import configs

    for name, cfg in configs().items():
        for m in (int(x) for x in args.m.split(",")):
            print(json.dumps(report(name, cfg, m, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
