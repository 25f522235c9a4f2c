"""GC001: direct wall/monotonic-clock calls in clock-governed modules.

The gie-twin digital twin (docs/STORM.md "virtual clock") runs the
storm/resilience stack on a deterministic VirtualClock. That only works
if every BEHAVIORAL read of time in those modules goes through the
Clock seam (gie_tpu_torch/runtime/clock.py) — one stray ``time.monotonic()``
in a breaker dwell or a shard heap silently splits the simulation into
two timelines: virtual decisions compared against real timestamps,
dwells that never elapse (or elapse instantly), and a "deterministic"
replay that drifts with the host's load.

GC001 therefore flags direct calls to the configured clock functions
(``time.monotonic`` / ``time.time`` / ``time.sleep`` by default) inside
the configured module prefixes (the storm, resilience, metricsio,
autoscale, and federation packages). The fix is always one of:

  * read through an injected clock (``self._clock.now()``, a
    ``clock: Callable[[], float]`` parameter, ``clock.MONOTONIC.now()``
    for a module-level default);
  * park through the seam (``clock.sleep`` / ``clock.wait`` /
    ``clock.wait_event``) instead of ``time.sleep``;
  * take ``now`` as a parameter and let the caller own the clock.

References (``clock=time.monotonic`` default args) are fine — only the
CALL pins a timeline. The watched call set and module prefixes are data
(``lockorder.toml [clockcalls]``).
"""

from __future__ import annotations

import ast

from gie_tpu_torch.lint.model import RepoIndex, Violation, body_nodes, dotted_name

RULE = "GC001"


class ClockCallsConfig:
    def __init__(self, cfg: dict):
        d = cfg.get("clockcalls", {})
        self.calls: set[str] = set(d.get("calls", []))
        self.modules: tuple[str, ...] = tuple(d.get("modules", []))


def _in_scope(modname: str, prefixes: tuple[str, ...]) -> bool:
    return any(modname == p or modname.startswith(p + ".")
               for p in prefixes)


def _violation(file: str, line: int, qualname: str, call: str) -> Violation:
    return Violation(
        RULE, file, line, qualname,
        f"direct {call}() in a clock-governed module — route it through "
        f"the Clock seam (gie_tpu_torch/runtime/clock.py): an injected clock "
        f"for reads, clock.sleep/wait for parks, or a now= parameter "
        f"(docs/STORM.md \"virtual clock\")")


def run(index: RepoIndex, cfg: dict) -> list[Violation]:
    ccfg = ClockCallsConfig(cfg)
    if not ccfg.calls or not ccfg.modules:
        return []
    out: list[Violation] = []
    seen: set[int] = set()
    # Function bodies: the index's resolved call sites.
    for fi in index.all_functions():
        if not _in_scope(fi.module.modname, ccfg.modules):
            continue
        for node_id, cs in fi.calls.items():
            if cs.ext is not None and cs.ext in ccfg.calls:
                seen.add(node_id)
                out.append(_violation(
                    fi.module.file, cs.node.lineno, fi.qualname, cs.ext))
    # Module level (import-time clock pins never enter a FunctionInfo):
    # resolve dotted call names through the module's own imports.
    for mi in index.modules.values():
        if not _in_scope(mi.modname, ccfg.modules):
            continue
        for stmt in mi.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            for node in body_nodes(stmt):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                dn = dotted_name(node.func)
                if dn is None or "." not in dn:
                    continue
                head, rest = dn.split(".", 1)
                resolved = f"{mi.imports.get(head, head)}.{rest}"
                if resolved in ccfg.calls:
                    out.append(_violation(
                        mi.file, node.lineno, "<module>", resolved))
    return out
