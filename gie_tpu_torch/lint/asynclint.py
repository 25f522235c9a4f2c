"""Blocking-in-async analyzer (rule GA001).

The extproc/runner loops are thread-based today; the ROADMAP's
multi-core ext-proc workers (item 1) bring the first event loops. A
single blocking call inside a coroutine stalls EVERY request on that
loop — the failure mode is silent (throughput collapses, nothing
errors), so the rule lands before the first ``async def`` does.

GA001  a call classified blocking by the shared ``[blocking]``/``[d2h]``
       denylists — or any wait on a threading Lock/Condition — executes
       inside an ``async def`` body, directly or through the resolved
       call graph. ``await``-ed expressions are exempt by construction
       (awaiting IS the non-blocking form); ``asyncio.sleep`` etc. never
       match the denylist, which names only the synchronous forms.
"""

from __future__ import annotations

import ast

from gie_tpu_torch.lint.blocking import (
    BlockingConfig, body_nodes, compute_blocking, wait_lock_name)
from gie_tpu_torch.lint.model import RepoIndex, Violation


def run(index: RepoIndex, cfg: dict) -> list[Violation]:
    bcfg = BlockingConfig(cfg)
    compute_blocking(index, bcfg)  # idempotent; cheap at repo scale
    out: list[Violation] = []
    for fi in index.all_functions():
        if not isinstance(fi.node, ast.AsyncFunctionDef):
            continue
        awaited = {
            id(n.value) for n in ast.walk(fi.node)
            if isinstance(n, ast.Await)
        }
        for node in body_nodes(fi.node):
            if not isinstance(node, ast.Call) or id(node) in awaited:
                continue
            cs = fi.calls.get(id(node))
            if cs is None:
                continue
            desc = bcfg.classify(cs, fi, index)
            if desc is not None:
                out.append(_violation(fi, desc, node.lineno, ""))
            if cs.target is not None and cs.target is not fi:
                for d, (line, chain) in cs.target.blocks.items():
                    via = cs.target.where + (f" -> {chain}" if chain else "")
                    out.append(_violation(fi, d, node.lineno, via))
    return out


def _violation(fi, desc: str, line: int, chain: str) -> Violation:
    waited = wait_lock_name(desc)
    if waited is not None:
        desc = f"wait on {waited}"
    via = f" via {chain}" if chain else ""
    return Violation(
        "GA001", fi.module.file, line, fi.qualname,
        f"blocking call {desc} inside async function{via} — it stalls "
        f"every request on this event loop; use the awaitable form or "
        f"run_in_executor")
