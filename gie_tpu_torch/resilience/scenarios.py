"""(Copy of gie_tpu/resilience/scenarios.py, imports rewritten to gie_tpu_torch.)

Recorded chaos scenarios: ``--fault`` specs grown into replayable
JSON files (docs/RESILIENCE.md "scenario files").

A scenario file captures everything a chaos run needs to be replayed
bit-for-bit — the seed, the fault rules, and a free-form ``drive``
section the harness interprets (traffic shape, upgrade sequence,
assertion knobs) — so a schedule that surfaced a bug in CI can be
re-run locally from the file alone, and the library of shipped
scenarios under ``resilience/scenarios/`` doubles as the chaos-ci
suite's input (``make chaos-ci``).

Schema (JSON object):

    {
      "name":        "serve-5xx-storm",          // required
      "description": "...",                      // required
      "seed":        101,                        // required
      "faults":      ["endpoint.serve_5xx=error:1.0"],   // spec strings
      "rules": {                                 // full FaultRule form
        "endpoint.serve_5xx": {"p_error": 1.0, "keys": ["10.9.1.1"],
                                "after": 0, "max_fires": 40}
      },
      "drive": {...}                             // harness-interpreted
    }

``faults`` entries use the exact ``--fault`` CLI grammar
(:func:`faults.parse_spec`); ``rules`` entries map point ->
:class:`faults.FaultRule` keyword arguments and exist because the CLI
grammar cannot express ``keys=`` / ``after=`` / ``max_fires=``. When a
point appears in both, ``rules`` wins — it is the more explicit form.
Both may be empty (a pure-drive scenario like ``rolling-upgrade``
injects nothing; the harness drives pod churn instead).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from gie_tpu_torch.resilience import faults

# Shipped scenario library (the chaos-ci inputs).
SCENARIO_DIR = os.path.join(os.path.dirname(__file__), "scenarios")

_RULE_FIELDS = {f.name for f in dataclasses.fields(faults.FaultRule)}


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    seed: int
    rules: dict  # point -> faults.FaultRule
    drive: dict  # free-form, interpreted by the replaying harness
    path: str = ""

    def injector(self) -> faults.FaultInjector:
        """A fresh injector for this scenario — same file, same seed,
        same schedule, bit-for-bit (the determinism contract the chaos
        suite asserts)."""
        return faults.FaultInjector(self.seed, dict(self.rules))

    def arm(self) -> faults.FaultInjector:
        """Build and install the injector; returns it (its ``log`` is
        the reproducibility artifact)."""
        inj = self.injector()
        faults.install(inj)
        return inj


def _rule_from_dict(point: str, raw: dict) -> faults.FaultRule:
    if not isinstance(raw, dict):
        raise ValueError(f"scenario rule for {point!r} must be an object")
    unknown = set(raw) - _RULE_FIELDS
    if unknown:
        raise ValueError(
            f"scenario rule for {point!r} has unknown fields "
            f"{sorted(unknown)}; known: {sorted(_RULE_FIELDS)}")
    kw = dict(raw)
    if "keys" in kw and kw["keys"] is not None:
        # JSON has no tuples; FaultRule.matches expects one.
        kw["keys"] = tuple(str(k) for k in kw["keys"])
    return faults.FaultRule(**kw)


def load(path_or_name: str) -> Scenario:
    """Load a scenario from an explicit path, or by bare name from the
    shipped library (``rolling-upgrade`` ->
    ``resilience/scenarios/rolling-upgrade.json``)."""
    path = path_or_name
    if not os.path.exists(path) and os.sep not in path_or_name:
        cand = os.path.join(SCENARIO_DIR, f"{path_or_name}.json")
        if os.path.exists(cand):
            path = cand
    try:
        with open(path, "r", encoding="utf-8") as fh:
            raw = json.load(fh)
    except FileNotFoundError:
        raise ValueError(
            f"no such scenario {path_or_name!r} (not a file, not in "
            f"{SCENARIO_DIR}: {sorted(list_scenarios())})") from None
    except json.JSONDecodeError as e:
        raise ValueError(f"scenario {path!r} is not valid JSON: {e}") from None
    for field in ("name", "description", "seed"):
        if field not in raw:
            raise ValueError(f"scenario {path!r} missing {field!r}")
    rules: dict[str, faults.FaultRule] = {}
    spec_list = raw.get("faults", [])
    if not isinstance(spec_list, list):
        raise ValueError(f"scenario {path!r}: 'faults' must be a list")
    if spec_list:
        rules.update(faults.parse_spec([str(s) for s in spec_list]))
    for point, rule_raw in (raw.get("rules") or {}).items():
        if point not in faults.CATALOG:
            raise ValueError(
                f"scenario {path!r} names unknown fault point {point!r}; "
                f"known: {sorted(faults.CATALOG)}")
        rules[point] = _rule_from_dict(point, rule_raw)
    return Scenario(
        name=str(raw["name"]),
        description=str(raw["description"]),
        seed=int(raw["seed"]),
        rules=rules,
        drive=dict(raw.get("drive") or {}),
        path=path,
    )


def list_scenarios(directory: Optional[str] = None) -> list[str]:
    """Names of the shipped scenario library (sorted)."""
    directory = SCENARIO_DIR if directory is None else directory
    if not os.path.isdir(directory):
        return []
    return sorted(
        fn[: -len(".json")]
        for fn in os.listdir(directory)
        if fn.endswith(".json")
    )
