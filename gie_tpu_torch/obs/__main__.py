"""(Copy of gie_tpu/obs/__main__.py, imports rewritten to gie_tpu_torch.)

``python -m gie_tpu_torch.obs`` — operator CLI for the observability plane.

Subcommands:

  dump --out DIR    Harvest the flight-recorder ring of a RUNNING
                    gateway into a dump file gie_tpu.learn can train
                    from. The ring lives in the serving process, so the
                    harvest goes through the /debugz/picks zpage on the
                    metrics port (loopback by default — same trust model
                    as every other zpage; --token forwards the
                    --debugz-token bearer for off-pod harvests).

The written file is the standard dump envelope ({"name", "written_at",
"records"}), byte-compatible with obs.dump_artifact artifacts and the
--obs-dump-interval-s rotation files, so every consumer
(gie_tpu.learn.dataset, replay tooling) loads all three identically.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request


def _fetch_picks(host: str, port: int, n: int, token: str,
                 timeout_s: float) -> list:
    url = f"http://{host}:{port}/debugz/picks?n={int(n)}"
    req = urllib.request.Request(url)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        body = resp.read()
    records = json.loads(body)
    if not isinstance(records, list):
        raise ValueError(
            f"/debugz/picks returned {type(records).__name__}, not a "
            "record list — is something else listening on that port?")
    return records


def _cmd_dump(args: argparse.Namespace) -> int:
    try:
        records = _fetch_picks(args.host, args.port, args.n, args.token,
                               args.timeout_s)
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"harvest failed: {e}", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    path = os.path.join(args.out, f"harvest-{stamp}-flightrec.json")
    payload = {
        "name": f"harvest-{stamp}",
        "written_at": time.time(),
        "records": records,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, default=str)
    print(f"wrote {path}: {len(records)} records")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gie_tpu_torch.obs",
        description="Observability-plane operator CLI (docs/"
                    "OBSERVABILITY.md, docs/LEARNED.md).")
    sub = parser.add_subparsers(dest="cmd", required=True)
    dump = sub.add_parser(
        "dump", help="harvest a running gateway's flight-recorder ring "
                     "into a training dump")
    dump.add_argument("--out", required=True, metavar="DIR",
                      help="output directory (file name is timestamped)")
    dump.add_argument("--host", default="127.0.0.1",
                      help="gateway metrics host (default loopback)")
    dump.add_argument("--port", type=int, default=9090,
                      help="gateway metrics port (--metrics-port)")
    dump.add_argument("-n", type=int, default=0,
                      help="newest N records only (0 = whole ring)")
    dump.add_argument("--token", default="",
                      help="bearer token for off-loopback /debugz "
                           "(--debugz-token)")
    dump.add_argument("--timeout-s", type=float, default=10.0)
    dump.set_defaults(fn=_cmd_dump)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
