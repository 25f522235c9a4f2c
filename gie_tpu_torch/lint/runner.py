"""gie-lint orchestration: index -> analyzers -> baseline -> report."""

from __future__ import annotations

import os
from typing import Optional

from gie_tpu_torch.lint import (
    asynclint, baseline, clockcalls, daemonloop, locks, tomlmini,
    tracesafe)
from gie_tpu_torch.lint.model import RepoIndex, Violation

_HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_CONFIG = os.path.join(_HERE, "lockorder.toml")
DEFAULT_BASELINE = os.path.join(_HERE, "baseline.toml")
PACKAGE = "gie_tpu_torch"
_PKG_ROOT = os.path.dirname(os.path.dirname(_HERE))  # repo root


def run_paths(
    paths: Optional[list[str]] = None,
    config: Optional[str] = None,
    baseline_path: Optional[str] = None,
    rules: Optional[set[str]] = None,
) -> tuple[list[Violation], list]:
    """Run every analyzer. Returns (violations, stale-baseline-entries);
    an empty/empty pair is a clean run.

    ``paths``: a single directory tree or file (default: the
    gie_tpu_torch package itself; the lint package obeys its own rules).
    ``rules``: restrict to a rule-id prefix set (fixture tests isolate
    one analyzer).
    """
    if not paths:
        root = os.path.join(_PKG_ROOT, PACKAGE)
        prefix = f"{PACKAGE}."
    else:
        if len(paths) != 1:
            raise ValueError("run_paths analyzes exactly one tree per call")
        root = paths[0]
        base = os.path.basename(os.path.normpath(root))
        prefix = f"{base}." if os.path.isdir(root) else ""
    config = config or DEFAULT_CONFIG
    cfg = tomlmini.load(config)
    config_file = os.path.basename(config)

    index = RepoIndex.build(root, package_prefix=prefix)
    violations = list(index.parse_errors)
    violations += locks.run(index, cfg, config_file=config_file)
    violations += tracesafe.run(index, cfg, config_file=config_file)
    violations += asynclint.run(index, cfg)
    violations += daemonloop.run(index, cfg)
    violations += clockcalls.run(index, cfg)
    if rules is not None:
        violations = [
            v for v in violations
            if any(v.rule.startswith(r) for r in rules)
        ]
    violations.sort(key=lambda v: (v.file, v.line, v.rule, v.message))

    entries = []
    if baseline_path is None:
        baseline_path = DEFAULT_BASELINE if os.path.exists(
            DEFAULT_BASELINE) else None
    if baseline_path:
        entries = baseline.load(baseline_path)
    if rules is not None:
        # A rules-restricted run only sees a slice of the findings, so
        # only the matching slice of the baseline may be judged stale —
        # otherwise e.g. `--rules GL` would report every GT/GA entry as
        # stale and fail a tree that is clean modulo its baseline.
        entries = [
            e for e in entries
            if any(e.rule.startswith(r) for r in rules)
        ]
    remaining, stale = baseline.apply(violations, entries)
    return remaining, stale
