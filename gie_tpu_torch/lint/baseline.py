"""Justification-required violation baseline.

Findings that predate a rule are grandfathered in ``baseline.toml`` —
one ``[[finding]]`` entry per violation with a mandatory, human-written
``justification``. The contract that keeps the baseline honest:

  - an entry with no (or empty) justification is a config error;
  - an entry that matches NO current violation is stale and fails the
    run (code improved or moved — the entry must be deleted with it);
  - a violation not covered by any entry fails the run.

So the baseline can hold existing debt but never absorb new findings:
new code cannot grow it without a reviewed edit to this file.

Matching is structural, not line-based (line numbers churn with every
edit): ``rule`` + ``where`` (``file:qualname``) + ``match`` (substring
of the message).
"""

from __future__ import annotations

from dataclasses import dataclass

from gie_tpu_torch.lint import tomlmini
from gie_tpu_torch.lint.model import Violation


class BaselineError(Exception):
    pass


@dataclass
class BaselineEntry:
    rule: str
    where: str
    match: str
    justification: str

    def covers(self, v: Violation) -> bool:
        return (v.rule == self.rule
                and v.where == self.where
                and self.match in v.message)


def load(path: str) -> list[BaselineEntry]:
    data = tomlmini.load(path)
    out = []
    for i, raw in enumerate(data.get("finding", [])):
        entry = BaselineEntry(
            rule=str(raw.get("rule", "")),
            where=str(raw.get("where", "")),
            match=str(raw.get("match", "")),
            justification=str(raw.get("justification", "")).strip(),
        )
        if not entry.rule or not entry.where:
            raise BaselineError(
                f"{path}: finding #{i + 1} needs rule and where")
        if not entry.justification:
            raise BaselineError(
                f"{path}: finding #{i + 1} ({entry.rule} at {entry.where}) "
                f"has no justification — grandfathering requires one")
        out.append(entry)
    return out


def apply(violations: list[Violation], entries: list[BaselineEntry]
          ) -> tuple[list[Violation], list[BaselineEntry]]:
    """-> (unbaselined violations, stale entries)."""
    used = [False] * len(entries)
    remaining = []
    for v in violations:
        covered = False
        for i, e in enumerate(entries):
            if e.covers(v):
                used[i] = True
                covered = True
        if not covered:
            remaining.append(v)
    stale = [e for e, u in zip(entries, used) if not u]
    return remaining, stale
