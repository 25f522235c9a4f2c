"""CLI: replay a storm scenario through the port and print its scorecard.

    python -m gie_tpu_torch.storm storm-equivalence --virtual
    python -m gie_tpu_torch.storm path/to/scenario.json --seed 7 --out DIR
    python -m gie_tpu_torch.storm storm-noisy-neighbor --device cpu

The scheduler runs on the CUDA card unless --device names another torch
device; with no card and no --device this exits non-zero with the port's
"no CUDA device" error (it never moves to the CPU on its own).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m gie_tpu_torch.storm")
    parser.add_argument("scenario",
                        help="scenario JSON path or shipped-library name "
                             "with a drive.storm section")
    parser.add_argument("--seed", type=int, default=None,
                        help="override the scenario's seed")
    parser.add_argument("--out", default=None,
                        help="directory for the scorecard artifact")
    parser.add_argument("--virtual", action="store_true",
                        help="force the virtual clock (docs/STORM.md) "
                             "regardless of the scenario's own "
                             "virtual_time setting")
    parser.add_argument("--device", default=None,
                        help="the scheduler's torch device (default: "
                             "CUDA; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    from gie_tpu_torch.storm.engine import run_scenario

    result = run_scenario(args.scenario, seed=args.seed,
                          dump_dir=args.out,
                          virtual_time=True if args.virtual else None,
                          device=args.device)
    json.dump(result.scorecard, sys.stdout, indent=1, default=float)
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
