"""(Port of gie_tpu/storm/search.py: imports rewritten to gie_tpu_torch, and
every search runs on a `device`, the card unless the caller names another.)

Automated resilience-policy parameter search (gie-twin, docs/STORM.md
"policy search").

``hack/storm_sweep.py`` hand-swept one ladder knob at a time against a
forced-rung storm. This module generalizes that into a seeded search
HARNESS over the resilience/autoscale policy surface:

  space      a dict of dotted knobs -> candidate values, expanded into
             a grid (or an explicit config list). Knob groups map onto
             the config objects the engine already takes:
               ladder.*     LadderConfig fields (cached_kv_weight,
                            wrr_queue_alpha, recover_streak, ...)
               breaker.*    BreakerConfig fields (open_after, open_s,
                            serve_rate_open, ...)
               outlier.*    OutlierConfig fields (ratio, breach_streak,
                            ...) — arms the ejector when present
               autoscale.*  EngineConfig autoscale_* fields
               engine.*     whitelisted EngineConfig scalars
                            (queue_limit, ttft_slo_s, force_rung, ...)
  storm      any ``drive.storm`` scenario (chaos rules included) — the
             same JSON files storm-ci replays, run under
             ``virtual_time`` so a candidate evaluation costs seconds
             of wall clock per simulated hour (Tesserae-style
             trace-driven evaluation; a TraceReplay drive makes it
             literally trace-driven).
  algorithm  grid + SUCCESSIVE HALVING: every config runs a short
             storm, the top half survives into a round with twice the
             duration, repeating for ``rounds`` — cheap storms kill
             bad configs, long storms separate good ones.
  verdict    a ranked JSON leaderboard scored on the scorecard's own
             goodput/SLO definitions (goodput first — it already counts
             only SLO-met tokens — then SLO attainment, then p99), with
             every per-round scorecard summary recorded.

CLI: ``python -m gie_tpu_torch.storm.search --scenario storm-search-smoke
[--device cpu]`` (see --help).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Optional

from gie_tpu_torch.resilience import scenarios as scenarios_mod
from gie_tpu_torch.resilience.breaker import BreakerConfig
from gie_tpu_torch.resilience.ladder import LadderConfig
from gie_tpu_torch.resilience.outlier import OutlierConfig

SCHEMA = "gie-storm-search/1"

# Leaderboard rows carry at least these (validate() checks).
REQUIRED_ROW_FIELDS = (
    "rank", "config", "goodput_tokens_per_s", "slo_attainment",
    "ttft_p99_s", "shed", "client_5xx", "rounds_survived",
)

_KNOB_GROUPS = ("ladder", "breaker", "outlier", "autoscale", "engine")

# engine.* knobs a search may vary (the run_scenario whitelist's spirit:
# policy knobs, not harness plumbing).
_ENGINE_KNOBS = frozenset({
    "queue_limit", "kv_limit", "ttft_slo_s", "static_subset",
    "force_rung", "autoscale_max_extra",
})


def expand_grid(space: dict) -> list[dict]:
    """Cartesian product of a knob space, knob order preserved."""
    if not space:
        raise ValueError("empty search space")
    keys = list(space)
    for k in keys:
        _split_knob(k)  # validate early
        if not isinstance(space[k], (list, tuple)) or not space[k]:
            raise ValueError(f"knob {k!r} needs a non-empty value list")
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(space[k] for k in keys))]


def _split_knob(knob: str) -> tuple[str, str]:
    group, _, field = knob.partition(".")
    if not field or group not in _KNOB_GROUPS:
        raise ValueError(
            f"knob {knob!r} must be <group>.<field> with group in "
            f"{_KNOB_GROUPS}")
    return group, field


def _replace_cfg(obj, fields: dict, what: str):
    try:
        return dataclasses.replace(obj, **fields)
    except TypeError as e:
        raise ValueError(f"unknown {what} knob: {e}") from None


def apply_assignment(cfg, assignment: dict):
    """One grid point -> an EngineConfig. ``cfg`` supplies the base
    ladder/breaker/outlier configs (engine defaults when absent)."""
    from gie_tpu_torch.storm.engine import DEFAULT_BREAKER, EngineConfig

    groups: dict[str, dict] = {}
    for knob, val in assignment.items():
        group, field = _split_knob(knob)
        groups.setdefault(group, {})[field] = val
    if cfg is None:
        cfg = EngineConfig()
    if "ladder" in groups:
        base = cfg.ladder if cfg.ladder is not None else cfg.fast_ladder()
        cfg = dataclasses.replace(
            cfg, ladder=_replace_cfg(base, groups["ladder"], "ladder"))
    if "breaker" in groups:
        base = cfg.breaker if cfg.breaker is not None else DEFAULT_BREAKER
        cfg = dataclasses.replace(
            cfg, breaker=_replace_cfg(base, groups["breaker"], "breaker"))
    if "outlier" in groups:
        base = cfg.outlier if cfg.outlier is not None else OutlierConfig()
        cfg = dataclasses.replace(
            cfg, outlier=_replace_cfg(base, groups["outlier"], "outlier"))
    if "autoscale" in groups:
        fields = {f"autoscale_{k}": v for k, v in groups["autoscale"].items()}
        cfg = _replace_cfg(cfg, fields, "autoscale")
    if "engine" in groups:
        bad = set(groups["engine"]) - _ENGINE_KNOBS
        if bad:
            raise ValueError(
                f"engine knobs {sorted(bad)} are not searchable; "
                f"allowed: {sorted(_ENGINE_KNOBS)}")
        cfg = _replace_cfg(cfg, groups["engine"], "engine")
    return cfg


def _score_key(card: dict) -> tuple:
    """Ranking key, best first: goodput (already SLO-gated tokens/s),
    then SLO attainment, then lower p99 (None = no completions, worst)."""
    p99 = card.get("ttft_p99_s")
    return (
        float(card.get("goodput_tokens_per_s") or 0.0),
        float(card.get("slo_attainment") or 0.0),
        -(float(p99) if p99 is not None else float("inf")),
    )


def _summarize(card: dict) -> dict:
    return {
        "goodput_tokens_per_s": round(
            float(card.get("goodput_tokens_per_s") or 0.0), 2),
        "slo_attainment": round(float(card.get("slo_attainment") or 0.0), 4),
        "ttft_p50_s": card.get("ttft_p50_s"),
        "ttft_p99_s": card.get("ttft_p99_s"),
        "completed": card.get("completed"),
        "shed": card.get("shed"),
        "client_5xx": card.get("client_5xx"),
        "schedule_fingerprint": card.get("schedule_fingerprint"),
    }


def _run_one(scn, assignment: dict, *, seed: int, duration_s: float,
             virtual: bool, base_cfg, name: str, device) -> dict:
    """One candidate evaluation: the scenario's storm drive at one
    config and duration, chaos rules armed, scored."""
    from gie_tpu_torch.resilience import faults
    from gie_tpu_torch.storm.engine import engine_from_drive

    storm = dict(scn.drive["storm"])
    storm["duration_s"] = float(duration_s)
    # Unconditional: the harness's clock-mode choice OVERRIDES a
    # scenario-pinned virtual_time (the drive key would otherwise win
    # the engine_from_drive whitelist loop and --real-time runs would
    # execute virtually while the artifact stamped them real).
    storm["virtual_time"] = bool(virtual)
    cfg = apply_assignment(base_cfg, assignment)
    engine = engine_from_drive(storm, seed=seed, cfg=cfg, name=name,
                               device=device)
    try:
        schedule = engine.program.compile()
        engine.warmup(schedule)
        inj = scn.arm() if scn.rules else None
        try:
            result = engine.run(schedule=schedule, warmup=False)
        finally:
            if inj is not None:
                faults.uninstall()
        return result.scorecard
    finally:
        engine.close()


def search(scenario: str, *, space: Optional[dict] = None,
           configs: Optional[list] = None, seed: Optional[int] = None,
           rounds: int = 2, base_duration_s: Optional[float] = None,
           survivor_fraction: float = 0.5, virtual: bool = True,
           cfg=None, progress=None, device=None) -> dict:
    """Grid + successive-halving search over one storm scenario.

    Returns the leaderboard artifact (schema ``gie-storm-search/1``):
    every config ranked best-first — configs eliminated in earlier
    rounds rank below every survivor of later ones, ordered within a
    round by score. Every storm runs its Scheduler on `device` (CUDA
    when None; raises with no card)."""
    if (space is None) == (configs is None):
        raise ValueError("search needs exactly one of space= / configs=")
    if rounds < 1:
        raise ValueError("rounds must be >= 1")
    if not (0.0 < survivor_fraction < 1.0):
        raise ValueError("survivor_fraction must be in (0, 1)")
    # A name/path, or a preconstructed Scenario (hack/storm_sweep.py
    # builds its rung-calibration drives in memory).
    scn = (scenario if hasattr(scenario, "drive")
           else scenarios_mod.load(scenario))
    storm = (scn.drive or {}).get("storm")
    if not isinstance(storm, dict):
        raise ValueError(f"scenario {scn.name!r} has no drive.storm section")
    seed = scn.seed if seed is None else seed
    base_d = float(base_duration_s if base_duration_s is not None
                   else (storm.get("duration_s")
                         or (storm.get("traffic") or {}).get(
                             "duration_s", 8.0)))
    all_configs = configs if configs is not None else expand_grid(space)
    if not all_configs:
        raise ValueError("no configs to search")

    # (config_index -> last observed (round, key, summary)).
    last: dict[int, tuple] = {}
    alive = list(range(len(all_configs)))
    rounds_out = []
    for r in range(rounds):
        duration = base_d * (2 ** r)
        results = []
        for idx in alive:
            if progress is not None:
                progress(r, idx, all_configs[idx], duration)
            card = _run_one(
                scn, all_configs[idx], seed=seed, duration_s=duration,
                virtual=virtual, base_cfg=cfg,
                name=f"{scn.name}-r{r}-c{idx}", device=device)
            key = _score_key(card)
            last[idx] = (r, key, _summarize(card))
            results.append((idx, key))
        results.sort(key=lambda x: x[1], reverse=True)
        rounds_out.append({
            "round": r,
            "duration_s": duration,
            "evaluated": len(results),
            "results": [
                {"config": all_configs[idx], **last[idx][2]}
                for idx, _ in results],
        })
        if r < rounds - 1 and len(results) > 1:
            keep = max(int(len(results) * survivor_fraction), 1)
            alive = [idx for idx, _ in results[:keep]]

    # Final ranking: later-round survivors first, by score within round.
    order = sorted(last, key=lambda i: (last[i][0], last[i][1]),
                   reverse=True)
    leaderboard = [
        {"rank": rank + 1, "config": all_configs[idx],
         "rounds_survived": last[idx][0] + 1, **last[idx][2]}
        for rank, idx in enumerate(order)]
    artifact = {
        "schema": SCHEMA,
        "name": scn.name,
        "seed": seed,
        "virtual_time": bool(virtual),
        "rounds_cfg": rounds,
        "base_duration_s": base_d,
        "space": space,
        "n_configs": len(all_configs),
        "rounds": rounds_out,
        "leaderboard": leaderboard,
    }
    validate(artifact)
    return artifact


def validate(artifact: dict) -> None:
    """Schema check for a search leaderboard (tests + the smoke gate)."""
    if artifact.get("schema") != SCHEMA:
        raise ValueError(
            f"unknown search schema {artifact.get('schema')!r} "
            f"(want {SCHEMA})")
    board = artifact.get("leaderboard")
    if not isinstance(board, list) or not board:
        raise ValueError("leaderboard missing or empty")
    for row in board:
        missing = [f for f in REQUIRED_ROW_FIELDS if f not in row]
        if missing:
            raise ValueError(f"leaderboard row missing fields: {missing}")
    ranks = [row["rank"] for row in board]
    if ranks != list(range(1, len(board) + 1)):
        raise ValueError(f"leaderboard ranks not 1..N: {ranks}")
    if not isinstance(artifact.get("rounds"), list) or not artifact["rounds"]:
        raise ValueError("rounds history missing")


def rank_of(artifact: dict, assignment: dict) -> Optional[int]:
    """1-based leaderboard rank of an exact config, or None."""
    for row in artifact["leaderboard"]:
        if row["config"] == assignment:
            return row["rank"]
    return None


# -- the smoke search -------------------------------------------------------

# The bounded 8-config grid the smoke gate runs: the two storm-swept
# ladder knobs (docs/RESILIENCE.md "ladder calibration") over the
# flash-crowd smoke scenario, whose chaos windows force both degraded
# rungs — the search must re-derive the hand-swept calibration
# (cached_kv_weight=8 / wrr_queue_alpha=1 in the top half).
SMOKE_SCENARIO = "storm-search-smoke"
SMOKE_SPACE = {
    "ladder.cached_kv_weight": [0.0, 8.0],
    "ladder.wrr_queue_alpha": [0.0, 1.0, 4.0, 8.0],
}
SMOKE_KNOWN_GOOD = {
    "ladder.cached_kv_weight": 8.0,
    "ladder.wrr_queue_alpha": 1.0,
}


def main(argv: Optional[list] = None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        description="seeded grid + successive-halving policy search "
                    "over a storm scenario (docs/STORM.md)")
    parser.add_argument("--scenario", default=SMOKE_SCENARIO,
                        help="scenario name or path with a drive.storm")
    parser.add_argument("--knob", action="append", default=[],
                        metavar="GROUP.FIELD=v1,v2,...",
                        help="add one knob axis (repeatable); default: "
                             "the smoke grid")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--duration-s", type=float, default=None,
                        help="round-0 storm duration (doubles per round)")
    parser.add_argument("--real-time", action="store_true",
                        help="run on the real clock instead of the "
                             "virtual clock")
    parser.add_argument("--out", default=None,
                        help="leaderboard JSON artifact path")
    parser.add_argument("--device", default=None,
                        help="the schedulers' torch device (default: "
                             "CUDA; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    space: dict = {}
    for spec in args.knob:
        knob, _, vals = spec.partition("=")
        if not vals:
            parser.error(f"--knob {spec!r}: expected GROUP.FIELD=v1,v2")
        space[knob.strip()] = [float(v) for v in vals.split(",")]
    if not space:
        space = dict(SMOKE_SPACE)

    def progress(r, idx, config, duration):
        print(f"[search] round {r} config {idx} ({duration:g}s): {config}",
              file=sys.stderr)

    artifact = search(args.scenario, space=space, seed=args.seed,
                      rounds=args.rounds, base_duration_s=args.duration_s,
                      virtual=not args.real_time, progress=progress,
                      device=args.device)
    for row in artifact["leaderboard"]:
        print(f"[search] #{row['rank']:<2} "
              f"goodput={row['goodput_tokens_per_s']:<9g} "
              f"slo={row['slo_attainment']:.3f} "
              f"p99={row['ttft_p99_s']} {row['config']}", file=sys.stderr)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(artifact, fh, indent=1)
    print(json.dumps(artifact))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
