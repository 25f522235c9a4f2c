"""Lock-discipline analyzer (rules GL001-GL004).

GL001  out-of-order acquisition: while holding a lock of rank r, a lock
       with rank <= r is acquired (directly, in the same ``with``, or
       anywhere down the resolved call graph). Ranks come from
       ``lockorder.toml`` ``[ranks]`` — lower rank = outer lock. Equal
       ranks on distinct locks are also flagged: two locks that can be
       held together must be ordered, not tied. Re-acquiring the SAME
       non-reentrant ``threading.Lock`` is self-deadlock and reported
       under the same rule.

GL002  blocking-while-locked: a call classified blocking by the
       ``[blocking]``/``[d2h]`` denylists executes inside a ``with
       lock:`` body (directly or transitively). ``cond.wait()`` on the
       very lock being held is exempt — that's the one blocking call
       whose contract is to RELEASE the lock.

GL003  undeclared lock: a ``threading.Lock/RLock/Condition`` attribute
       exists in the analyzed tree but has no rank in lockorder.toml.
       Every new lock must take a place in the hierarchy.

GL004  stale hierarchy entry: a rank is declared for a lock that no
       longer exists — the declared hierarchy must describe the code.
"""

from __future__ import annotations

import ast

from gie_tpu_torch.lint.blocking import (
    BlockingConfig, body_nodes, compute_blocking, wait_lock_name)
from gie_tpu_torch.lint.model import FunctionInfo, LockDef, RepoIndex, Violation


def run(index: RepoIndex, cfg: dict, config_file: str = "lockorder.toml"
        ) -> list[Violation]:
    ranks: dict[str, int] = dict(cfg.get("ranks", {}))
    bcfg = BlockingConfig(cfg)
    compute_blocking(index, bcfg)
    out: list[Violation] = []

    # GL003 / GL004: the declared hierarchy and the code must agree.
    for name, d in sorted(index.locks.items()):
        if name not in ranks:
            out.append(Violation(
                "GL003", d.file, d.line, name,
                f"lock {name!r} ({d.kind}) has no rank in lockorder.toml "
                f"— every lock must take a place in the hierarchy"))
    for name in sorted(ranks):
        if name not in index.locks:
            out.append(Violation(
                "GL004", config_file, 0, name,
                f"lockorder.toml ranks {name!r} but no such lock exists "
                f"in the analyzed tree — remove or rename the entry"))

    for fi in index.all_functions():
        out.extend(_check_function(index, fi, ranks, bcfg))
    return out


def _held_sections(fi: FunctionInfo):
    """Yield (with-node, [LockDef...]) for every lock-acquiring with."""
    for wid, locks in fi.withs.items():
        node = fi._with_nodes.get(wid) if hasattr(fi, "_with_nodes") else None
        if node is None:
            for n in ast.walk(fi.node):
                if id(n) == wid:
                    node = n
                    break
        yield node, locks


def _check_function(index: RepoIndex, fi: FunctionInfo,
                    ranks: dict, bcfg: BlockingConfig) -> list[Violation]:
    out: list[Violation] = []
    for wnode, held_locks in _held_sections(fi):
        # `with a, b:` acquires left to right: each earlier item is held
        # while each later one is taken, so in-statement pairs get the
        # same order check as nested withs.
        for i, outer in enumerate(held_locks):
            for inner in held_locks[i + 1:]:
                out.extend(_order_check(
                    fi, outer, ranks.get(outer.name), inner, ranks,
                    wnode.lineno, chain=""))
        for held in held_locks:
            out.extend(_check_section(index, fi, wnode, held, ranks, bcfg))
    return out


def _check_section(index: RepoIndex, fi: FunctionInfo, wnode,
                   held: LockDef, ranks: dict,
                   bcfg: BlockingConfig) -> list[Violation]:
    out: list[Violation] = []
    held_rank = ranks.get(held.name)
    for node in body_nodes(wnode):
        if node is wnode:
            continue
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for inner in fi.withs.get(id(node), ()):
                out.extend(_order_check(
                    fi, held, held_rank, inner, ranks,
                    node.lineno, chain=""))
        elif isinstance(node, ast.Call):
            cs = fi.calls.get(id(node))
            if cs is None:
                continue
            # Blocking call directly inside the held section.
            desc = bcfg.classify(cs, fi, index)
            if desc is not None:
                out.extend(_blocking_violation(
                    fi, held, desc, node.lineno, chain=""))
            # Everything the callee may do, transitively.
            if cs.target is not None and cs.target is not fi:
                for lname, (line, chain) in cs.target.acquires.items():
                    inner = index.locks.get(lname)
                    if inner is None:
                        continue
                    via = cs.target.where + (
                        f" -> {chain}" if chain else "")
                    out.extend(_order_check(
                        fi, held, held_rank, inner, ranks,
                        node.lineno, chain=via))
                for desc, (line, chain) in cs.target.blocks.items():
                    via = cs.target.where + (
                        f" -> {chain}" if chain else "")
                    out.extend(_blocking_violation(
                        fi, held, desc, node.lineno, chain=via))
    return out


def _order_check(fi: FunctionInfo, held: LockDef, held_rank,
                 inner: LockDef, ranks: dict, line: int,
                 chain: str) -> list[Violation]:
    via = f" via {chain}" if chain else ""
    if inner.name == held.name:
        if held.kind == "lock" and not chain:
            # Direct re-acquisition of a non-reentrant Lock: deadlock.
            # Through a call chain the outer frame may intend handoff
            # patterns the resolver cannot see, but the direct nested
            # form has exactly one meaning.
            return [Violation(
                "GL001", fi.module.file, line, fi.qualname,
                f"re-acquires non-reentrant lock {held.name} it already "
                f"holds — self-deadlock")]
        return []
    inner_rank = ranks.get(inner.name)
    if held_rank is None or inner_rank is None:
        return []  # GL003 already demands a declared rank
    if inner_rank <= held_rank:
        return [Violation(
            "GL001", fi.module.file, line, fi.qualname,
            f"acquires {inner.name} (rank {inner_rank}) while holding "
            f"{held.name} (rank {held_rank}){via} — lock order is "
            f"outer-to-inner by ascending rank")]
    return []


def _blocking_violation(fi: FunctionInfo, held: LockDef, desc: str,
                        line: int, chain: str) -> list[Violation]:
    waited = wait_lock_name(desc)
    if waited is not None:
        if waited == held.name:
            return []  # waiting on the held condition releases it
        desc = f"wait on {waited}"
    via = f" via {chain}" if chain else ""
    return [Violation(
        "GL002", fi.module.file, line, fi.qualname,
        f"blocking call {desc} while holding {held.name}{via} — move the "
        f"slow work outside the critical section")]
