"""CLI: ``python -m gie_tpu_torch.lint [tree] [--config F] [--baseline F]``.

Exit status: 0 clean, 1 violations (or stale baseline entries), 2 bad
invocation/config. With no tree it analyzes the ``gie_tpu_torch``
package with the package's own config; fixture tests point it at a
golden-violation tree with a fixture-local config.
"""

from __future__ import annotations

import argparse
import sys

from gie_tpu_torch.lint.baseline import BaselineError
from gie_tpu_torch.lint.runner import run_paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gie_tpu_torch.lint",
                                 description=__doc__)
    ap.add_argument("paths", nargs="*", help="tree to analyze "
                    "(default: the gie_tpu_torch package)")
    ap.add_argument("--config", help="lockorder.toml to use")
    ap.add_argument("--baseline", help="baseline.toml to use")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report raw findings, ignore any baseline")
    ap.add_argument("--rules", help="comma-separated rule-id prefixes "
                    "to keep (e.g. GL,GT001)")
    args = ap.parse_args(argv)

    kwargs = {}
    if args.no_baseline:
        kwargs["baseline_path"] = ""
    elif args.baseline:
        kwargs["baseline_path"] = args.baseline
    try:
        violations, stale = run_paths(
            paths=args.paths or None,
            config=args.config,
            rules=set(args.rules.split(",")) if args.rules else None,
            **kwargs,
        )
    except (BaselineError, ValueError, OSError) as e:
        print(f"gie-lint: {e}", file=sys.stderr)
        return 2

    for v in violations:
        print(v.render())
    for e in stale:
        print(f"baseline.toml: STALE entry {e.rule} at {e.where} "
              f"(match={e.match!r}) no longer matches any finding — "
              f"delete it")
    if violations or stale:
        print(f"gie-lint: {len(violations)} violation(s), "
              f"{len(stale)} stale baseline entr(y/ies)", file=sys.stderr)
        return 1
    print("gie-lint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
