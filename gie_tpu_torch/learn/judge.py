"""Head-to-head promotion: learned vs heuristic through the port's twin
(port of gie_tpu/learn/judge.py).

A trained policy is promoted the way a human would promote it — by
racing it against the incumbent on the SAME traffic. Each judged
scenario runs the virtual-clock storm engine twice at one seed: once
with the tuned heuristic blend (the production default, bit-for-bit the
pre-learn path) and once with ProfileConfig.scorer="learned" + the
artifact's exponents. The two runs share the schedule fingerprint by
construction (the Program is compiled from the same drive + seed; the
scorer cannot touch arrivals), and the judgment REFUSES to score a pair
whose fingerprints diverge — a comparison across different traffic is
not a comparison.

Verdict gates (per scenario, all must hold; "no-regression" semantics):

- goodput_tokens_per_s: learned >= heuristic (goodput already counts
  only SLO-met tokens, so this is the headline gate),
- slo_attainment:       learned >= heuristic,
- ttft_p99_s:           learned <= heuristic * p99_tolerance
                        (None = no completions = worst).

Scenario kinds: named storm scenarios (chaos rules armed identically on
both sides — the injector is seeded) and recorded flight-recorder dumps
replayed as literal arrival schedules via shapes.TraceReplay, so a
policy is judged on BOTH synthetic storms and the production traffic it
was trained from.

The port's judge runs its engines on `device` (CUDA unless the caller
names the CPU, as every entry point of the port), and `noise_sources`,
when given, makes each engine run's Gumbel noise source (the parity
tests replay the reference scheduler's draws through it; a card run and
a CPU run share one seeded generator's).

CLI: ``python -m gie_tpu_torch.learn.judge --policy ART --scenario NAME
--trace-dump DUMP --out JUDGE.json [--device cpu]`` (see --help).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from typing import Callable

from gie_tpu_torch.learn import artifact as artifact_mod

SCHEMA = "gie-learn-judge/1"

REQUIRED_SCENARIO_FIELDS = (
    "name", "kind", "seed", "schedule_fingerprint", "heuristic",
    "learned", "gates", "passed",
)

# TraceReplay harness defaults: the replay stretches the duration itself
# and replaces the Poisson draw, so traffic here is just the envelope.
_TRACE_TRAFFIC = {"base_qps": 1.0, "duration_s": 1.0, "n_sessions": 8}
_TRACE_POOL = {"n_pods": 3}
# Replay TTFT SLO: sits between the replayed traffic's median TTFT and
# the heuristic's tail, so goodput on a replayed trace measures tail
# scheduling quality — the thing a latency-trained policy is FOR — not
# raw cache-hit throughput (--trace-slo-s overrides).
_TRACE_SLO_S = 4.0


def policy_weights_spec(art: dict) -> tuple:
    """Artifact -> the hashable ((name, float32-hex), ...) tuple
    EngineConfig.policy_weights carries (feature-schema order)."""
    return tuple(
        (name, str(art["weights"][name]["hex"]))
        for name in art["feature_schema"])


def _summarize(card: dict) -> dict:
    return {
        "goodput_tokens_per_s": round(
            float(card.get("goodput_tokens_per_s") or 0.0), 2),
        "slo_attainment": round(float(card.get("slo_attainment") or 0.0), 4),
        "ttft_p50_s": card.get("ttft_p50_s"),
        "ttft_p99_s": card.get("ttft_p99_s"),
        "serve_latency_p99_ms": card.get("serve_latency_p99_ms"),
        "completed": card.get("completed"),
        "shed": card.get("shed"),
        "client_5xx": card.get("client_5xx"),
        "schedule_fingerprint": card.get("schedule_fingerprint"),
        "decision_fingerprint": card.get("decision_fingerprint"),
    }


def _run_card(storm: dict, scn, *, seed: int, cfg, name: str, device,
              noise_sources) -> dict:
    """One engine run -> scorecard (the search._run_one shape: compile,
    warm, arm chaos AFTER warmup, run, always close)."""
    from gie_tpu_torch.resilience import faults
    from gie_tpu_torch.storm.engine import engine_from_drive

    engine = engine_from_drive(
        storm, seed=seed, cfg=cfg, name=name, device=device,
        noise_source=None if noise_sources is None else noise_sources())
    try:
        schedule = engine.program.compile()
        engine.warmup(schedule)
        inj = scn.arm() if (scn is not None and scn.rules) else None
        try:
            result = engine.run(schedule=schedule, warmup=False)
        finally:
            if inj is not None:
                faults.uninstall()
        return result.scorecard
    finally:
        engine.close()


def _gate(heur: dict, learned: dict, p99_tolerance: float) -> dict:
    h_p99 = heur.get("ttft_p99_s")
    l_p99 = learned.get("ttft_p99_s")
    h_p99 = float(h_p99) if h_p99 is not None else float("inf")
    l_p99 = float(l_p99) if l_p99 is not None else float("inf")
    gates = {
        "goodput": learned["goodput_tokens_per_s"]
        >= heur["goodput_tokens_per_s"],
        "slo": learned["slo_attainment"] >= heur["slo_attainment"],
        "p99": l_p99 <= h_p99 * p99_tolerance or (
            l_p99 == float("inf") and h_p99 == float("inf")),
    }
    return gates


def _judge_one(storm: dict, scn, *, name: str, kind: str, seed: int,
               base_cfg, weights_spec: tuple, p99_tolerance: float,
               device, noise_sources) -> dict:
    from gie_tpu_torch.storm.engine import EngineConfig

    cfg = base_cfg if base_cfg is not None else EngineConfig()
    storm = dict(storm)
    storm["virtual_time"] = True  # the twin is the judge, always
    heur_card = _run_card(
        storm, scn, seed=seed,
        cfg=dataclasses.replace(cfg, scorer="blend", policy_weights=()),
        name=f"{name}-heuristic", device=device, noise_sources=noise_sources)
    learned_card = _run_card(
        storm, scn, seed=seed,
        cfg=dataclasses.replace(
            cfg, scorer="learned", policy_weights=weights_spec),
        name=f"{name}-learned", device=device, noise_sources=noise_sources)
    h_fp = heur_card.get("schedule_fingerprint")
    l_fp = learned_card.get("schedule_fingerprint")
    if not h_fp or h_fp != l_fp:
        raise ValueError(
            f"judge {name!r}: schedule fingerprints diverged "
            f"({h_fp!r} vs {l_fp!r}) — the two runs did not see the "
            "same traffic, so the comparison is void")
    heur, learned = _summarize(heur_card), _summarize(learned_card)
    gates = _gate(heur, learned, p99_tolerance)
    return {
        "name": name,
        "kind": kind,
        "seed": int(seed),
        "schedule_fingerprint": h_fp,
        "heuristic": heur,
        "learned": learned,
        "gates": gates,
        "passed": all(gates.values()),
    }


def judge(policy_art: dict, *, scenarios: tuple = (),
          trace_dumps: tuple = (), seed: Optional[int] = None,
          duration_s: Optional[float] = None,
          trace_slo_s: float = _TRACE_SLO_S,
          p99_tolerance: float = 1.10, base_cfg=None, device=None,
          noise_sources: Optional[Callable[[], Callable]] = None) -> dict:
    """Race the artifact against the heuristic on every given scenario
    and replayed dump; return the judgment (schema gie-learn-judge/1).
    ``promote`` is True only when EVERY scenario's gates all pass."""
    from gie_tpu_torch.resilience import scenarios as scenarios_mod

    artifact_mod.validate_artifact(policy_art)
    if not scenarios and not trace_dumps:
        raise ValueError("judge needs at least one scenario or trace dump")
    weights_spec = policy_weights_spec(policy_art)
    results = []
    for scenario in scenarios:
        scn = (scenario if hasattr(scenario, "drive")
               else scenarios_mod.load(scenario))
        storm = (scn.drive or {}).get("storm")
        if not isinstance(storm, dict):
            raise ValueError(
                f"scenario {scn.name!r} has no drive.storm section")
        storm = dict(storm)
        if duration_s is not None:
            storm["duration_s"] = float(duration_s)
        results.append(_judge_one(
            storm, scn, name=scn.name, kind="storm",
            seed=scn.seed if seed is None else seed, base_cfg=base_cfg,
            weights_spec=weights_spec, p99_tolerance=p99_tolerance,
            device=device, noise_sources=noise_sources))
    for path in trace_dumps:
        storm = {
            "traffic": dict(_TRACE_TRAFFIC),
            "shapes": [{"kind": "trace_replay", "path": str(path)}],
            "pool": dict(_TRACE_POOL),
            "ttft_slo_s": float(trace_slo_s),
        }
        results.append(_judge_one(
            storm, None, name=f"trace:{path}", kind="trace_replay",
            seed=0 if seed is None else seed, base_cfg=base_cfg,
            weights_spec=weights_spec, p99_tolerance=p99_tolerance,
            device=device, noise_sources=noise_sources))
    judgment = {
        "schema": SCHEMA,
        "policy_checksum": policy_art["checksum"],
        "policy_weights": {
            name: hexed for name, hexed in weights_spec},
        "p99_tolerance": float(p99_tolerance),
        "scenarios": results,
        "promote": all(r["passed"] for r in results),
    }
    validate(judgment)
    return judgment


def validate(judgment: dict) -> None:
    """Schema check for a judgment (tests + the learn-ci gate)."""
    if judgment.get("schema") != SCHEMA:
        raise ValueError(
            f"unknown judge schema {judgment.get('schema')!r} "
            f"(want {SCHEMA})")
    rows = judgment.get("scenarios")
    if not isinstance(rows, list) or not rows:
        raise ValueError("judgment has no scenarios")
    for row in rows:
        missing = [f for f in REQUIRED_SCENARIO_FIELDS if f not in row]
        if missing:
            raise ValueError(f"judgment scenario missing: {missing}")
        if (row["heuristic"].get("schedule_fingerprint")
                != row["learned"].get("schedule_fingerprint")):
            raise ValueError(
                f"judgment scenario {row['name']!r} compares different "
                "schedules")
    if judgment.get("promote") != all(r["passed"] for r in rows):
        raise ValueError("promote flag disagrees with per-scenario gates")


def main(argv: Optional[list] = None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m gie_tpu_torch.learn.judge",
        description="Race a trained policy artifact against the "
                    "heuristic blend through the virtual-clock twin.")
    parser.add_argument("--policy", required=True,
                        help="policy artifact path (gie-learn-policy/1)")
    parser.add_argument("--scenario", action="append", default=[],
                        help="storm scenario name/path (repeatable)")
    parser.add_argument("--trace-dump", action="append", default=[],
                        help="flight-recorder dump to replay (repeatable)")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--duration-s", type=float, default=None)
    parser.add_argument("--trace-slo-s", type=float, default=_TRACE_SLO_S)
    parser.add_argument("--p99-tolerance", type=float, default=1.10)
    parser.add_argument("--out", default=None,
                        help="judgment JSON path")
    parser.add_argument("--device", default=None,
                        help="the engines' device (default: CUDA)")
    parser.add_argument("--attach", default=None, metavar="PATH",
                        help="rewrite the artifact here with the "
                             "judgment attached (checksum re-stamped)")
    args = parser.parse_args(argv)

    art = artifact_mod.load_artifact(args.policy)
    judgment = judge(
        art, scenarios=tuple(args.scenario),
        trace_dumps=tuple(args.trace_dump), seed=args.seed,
        duration_s=args.duration_s, trace_slo_s=args.trace_slo_s,
        p99_tolerance=args.p99_tolerance, device=args.device)
    for row in judgment["scenarios"]:
        gates = ",".join(
            f"{k}={'ok' if v else 'FAIL'}"
            for k, v in row["gates"].items())
        print(f"[judge] {row['name']}: learned "
              f"goodput={row['learned']['goodput_tokens_per_s']} vs "
              f"heuristic {row['heuristic']['goodput_tokens_per_s']} "
              f"({gates})", file=sys.stderr)
    print(f"[judge] verdict: "
          f"{'PROMOTE' if judgment['promote'] else 'HOLD'}",
          file=sys.stderr)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(judgment, fh, indent=1)
    if args.attach:
        stamped = artifact_mod.attach_judgment(art, judgment)
        with open(args.attach, "w", encoding="utf-8") as fh:
            fh.write(artifact_mod.dumps_artifact(stamped))
    print(json.dumps(judgment))
    return 0 if judgment["promote"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
