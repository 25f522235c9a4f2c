"""(Copy of gie_tpu/storm/scorecard.py.)

Storm run scoring: cluster goodput + SLO attainment, one JSON
artifact per run (docs/STORM.md "scorecard").

The scoring DEFINITIONS are shared with the repo's benchmark evidence
(bench_goodput.py / bench_slo.py / simulator RunStats): goodput is
output tokens/s from requests meeting the TTFT SLO, attainment is the
fraction of completions inside it — so a storm scorecard, a goodput
bench line, and an SLO bench line are directly comparable numbers, and
the storm harness can gate the same regressions the benches report.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

# Bump when scorecard fields change meaning; loaders key tolerance off it.
SCHEMA = "gie-storm-scorecard/1"

# Every scorecard carries at least these (tests/test_storm.py pins).
REQUIRED_FIELDS = (
    "schema", "name", "seed", "duration_s", "schedule_fingerprint",
    "arrivals", "completed", "ok", "shed", "client_5xx", "resets",
    "goodput_tokens_per_s", "throughput_tokens_per_s", "slo_attainment",
    "ttft_p50_s", "ttft_p99_s", "serve_latency_p50_ms",
    "serve_latency_p99_ms", "max_rung", "final_rung", "rung_trace",
    "pool_size_trace", "breaker_opens", "ejections", "upgrades",
    "autoscale_events",
    # gie-fair: per-tenant goodput/p99/SLO/shed breakdowns +
    # which criticality bands absorbed the sheds — the noisy-neighbor
    # isolation property is asserted on these.
    "per_tenant", "shed_by_band",
)


def score_completions(ttfts_s, tokens, duration_s: float,
                      ttft_slo_s: float) -> dict:
    """The bench_goodput/bench_slo scoring core over raw completion
    columns: goodput counts ONLY tokens whose request met the TTFT SLO
    (a late answer burned capacity for zero goodput)."""
    ttfts = np.asarray(ttfts_s, np.float64)
    toks = np.asarray(tokens, np.float64)
    if ttfts.size == 0:
        # Percentiles of nothing are null, not inf: bare Infinity is
        # invalid JSON and would make a zero-completion run's artifact
        # unreadable by strict parsers (dump() enforces allow_nan=False).
        return {
            "goodput_tokens_per_s": 0.0,
            "throughput_tokens_per_s": 0.0,
            "slo_attainment": 0.0,
            "ttft_p50_s": None,
            "ttft_p99_s": None,
        }
    ok = ttfts <= ttft_slo_s
    return {
        "goodput_tokens_per_s": float(toks[ok].sum() / duration_s),
        "throughput_tokens_per_s": float(toks.sum() / duration_s),
        "slo_attainment": float(ok.mean()),
        "ttft_p50_s": float(np.percentile(ttfts, 50)),
        "ttft_p99_s": float(np.percentile(ttfts, 99)),
    }


def validate(card: dict) -> None:
    """Schema check for a scorecard artifact (loaders + tests)."""
    missing = [f for f in REQUIRED_FIELDS if f not in card]
    if missing:
        raise ValueError(f"scorecard missing fields: {missing}")
    if card["schema"] != SCHEMA:
        raise ValueError(
            f"unknown scorecard schema {card['schema']!r} (want {SCHEMA})")


def dump(card: dict, directory: str, name: Optional[str] = None) -> str:
    """Write the scorecard JSON artifact; returns the path."""
    validate(card)
    os.makedirs(directory, exist_ok=True)
    safe = "".join(
        c if c.isalnum() or c in "-_." else "-"
        for c in (name or card["name"]))
    path = os.path.join(directory, f"{safe}-scorecard.json")
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(card, fh, indent=1, default=float, allow_nan=False)
    return path
