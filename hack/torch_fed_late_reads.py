"""Show which readings of a federation storm's scorecard are taken after
the storm: run the port's storm twin on the CPU (or --device) with a wall
delay inserted between run() releasing the virtual clock and the
scorecard, and print the peer link's counters and the capacity matrix
for each delay.

    python3 hack/torch_fed_late_reads.py [--scenario storm-fed-partition]
        [--delays 0,1] [--device cpu]

A field that differs between delays is read at a time the virtual clock
does not own: the link, the scrapes and the publishers keep running
after the release (after a flipped-era heal, for one, the old lineage
answers every other poll with a rejected era regression). One JSON line
per delay.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--delays", default="0,1",
                    help="seconds of wall time before the scorecard")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--scenario", default="storm-fed-partition")
    args = ap.parse_args(argv)

    from gie_tpu_torch.resilience import faults
    from gie_tpu_torch.storm import engine

    score = engine.StormEngine._score
    for delay in (float(d) for d in args.delays.split(",") if d):
        def late_score(self, schedule, delay=delay):
            time.sleep(delay)
            return score(self, schedule)

        engine.StormEngine._score = late_score
        try:
            card = engine.run_scenario(args.scenario, virtual_time=True,
                                       device=args.device).scorecard
        finally:
            engine.StormEngine._score = score
            faults.uninstall()
            faults.set_clock(None)
        fed = card["federation"]
        link = {k: v for k, v in fed["link"].items()
                if k not in ("url", "staleness_s", "installed_era")}
        matrix = {name: {k: v for k, v in row.items()
                         if k not in ("staleness_s", "era")}
                  for name, row in fed["matrix"].items()}
        print(json.dumps({"scenario": args.scenario, "delay_s": delay,
                          "decision_fingerprint":
                              card["decision_fingerprint"][:16],
                          "link": link, "matrix": matrix}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
