"""GR001: blocking receive/acquire calls in daemon loops need a bound.

A daemon loop — any ``while`` loop in ``gie_tpu_torch`` — that blocks on an
unbounded ``queue.get()`` / ``sock.recv()`` / ``lock.acquire()`` can
never observe shutdown, a dead peer, or a wedged producer: the thread
parks forever and takes its subsystem's drain/close path with it (the
scrape engine's hung-fetch detach and the picker's bounded ``pick()``
wait exist precisely because of this failure mode). GR001 requires every
such call inside a ``while`` loop to carry an explicit bound:

  ``Queue.get``      a ``timeout=`` (or ``block=False``)
  ``Lock.acquire``   a ``timeout=`` (or ``blocking=False``) — matched
                     only for locks declared in the hierarchy config,
                     so an unresolvable receiver never guesses
  ``Event.wait``     a timeout argument
  ``socket.recv``    no per-call bound exists: restructure (settimeout
                     on the object + baseline, or select-based readiness)

``Condition.wait`` is deliberately exempt: it RELEASES the lock it waits
on and is notify-driven — the paired ``notify`` under the same lock is
its liveness contract, which a timeout would only paper over.

The watched call set is data (``lockorder.toml [daemonloop] calls``),
matched against the index's type-resolved dotted names — an unresolved
receiver is never flagged (same posture as the blocking denylist).
"""

from __future__ import annotations

import ast

from gie_tpu_torch.lint.model import RepoIndex, Violation, body_nodes

RULE = "GR001"


class DaemonLoopConfig:
    def __init__(self, cfg: dict):
        d = cfg.get("daemonloop", {})
        self.calls: set[str] = set(d.get("calls", []))


def _kw(call: ast.Call, name: str):
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _is_false(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is False


def _bounded(call: ast.Call, kind: str) -> bool:
    """Does this call carry an explicit bound (or opt out of blocking)?"""
    if _kw(call, "timeout") is not None:
        return True
    args = call.args
    if kind == "get":
        # Queue.get(block=True, timeout=None): a second positional is the
        # timeout; block=False never blocks.
        if len(args) >= 2:
            return True
        blk = args[0] if args else _kw(call, "block")
        return blk is not None and _is_false(blk)
    if kind == "acquire":
        # Lock.acquire(blocking=True, timeout=-1).
        if len(args) >= 2:
            return True
        blk = args[0] if args else _kw(call, "blocking")
        return blk is not None and _is_false(blk)
    if kind == "wait":
        # Event.wait(timeout=None): one positional IS the timeout.
        return len(args) >= 1
    # recv/recv_into/accept/join: no per-call bound exists.
    return False


def _while_loops(fi):
    for node in body_nodes(fi.node):
        if isinstance(node, ast.While):
            yield node


def run(index: RepoIndex, cfg: dict) -> list[Violation]:
    dcfg = DaemonLoopConfig(cfg)
    out: list[Violation] = []
    for fi in index.all_functions():
        seen: set[int] = set()  # nested whiles walk shared bodies
        for loop in _while_loops(fi):
            for node in body_nodes(loop):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                cs = fi.calls.get(id(node))
                if cs is None:
                    continue
                desc = None
                kind = ""
                if cs.ext is not None and cs.ext in dcfg.calls:
                    desc = cs.ext
                    kind = cs.ext.rsplit(".", 1)[1]
                elif cs.method == "acquire" and cs.recv is not None:
                    lock = index.resolve_lock_expr(cs.recv, fi)
                    if lock is not None:
                        desc = f"{lock.name}.acquire"
                        kind = "acquire"
                if desc is None or _bounded(node, kind):
                    continue
                seen.add(id(node))
                out.append(Violation(
                    RULE, fi.module.file, node.lineno, fi.qualname,
                    f"unbounded blocking {desc}() inside a daemon loop — "
                    f"pass an explicit timeout (or a non-blocking form) "
                    f"so the loop can observe shutdown"))
    return out
