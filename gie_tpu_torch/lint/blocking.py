"""Blocking-call classification shared by the lock and async analyzers.

What counts as "blocking" is data, not code: ``lockorder.toml``'s
``[blocking]`` table lists dotted call names, receiver types, and bare
method names; ``[d2h]`` lists torch's device-to-host syncs: the calls
that wait for the card (``torch.cuda.synchronize``, ``synchronize()`` on
an Event or a Stream) and the pulls of a tensor to the host (``.cpu()``,
``.item()``, ``.tolist()``). Holding a lock across one stalls every thread
behind the lock for as long as the card's queue takes to drain. The
reference gates its numpy pulls on the module importing jax; almost every
module of this package imports torch, so that gate would mean nothing
here. The entries are type-qualified instead (``torch.Tensor.item``
matches only where the index infers the receiver to be a tensor), and
they count in every module: a ``.tolist()`` on a numpy array is not one.

``compute_blocking`` fills each function's transitive ``blocks`` summary
(desc -> (line, call-chain)) over the resolved call graph, so "holds the
engine lock and calls a helper that calls time.sleep" reports the chain,
not just the leaf.
"""

from __future__ import annotations

import ast
from typing import Optional

from gie_tpu_torch.lint.model import (
    CallSite, FunctionInfo, LockDef, RepoIndex, body_nodes)

__all__ = ["BlockingConfig", "WAIT_PREFIX", "body_nodes",
           "compute_blocking", "wait_lock_name"]

# Condition/lock wait descs get a structured prefix so the lock rule can
# exempt "waiting on the very lock you hold" (which releases it) while
# still flagging a wait that happens under a DIFFERENT held lock.
WAIT_PREFIX = "wait-on:"


class BlockingConfig:
    def __init__(self, cfg: dict):
        b = cfg.get("blocking", {})
        self.calls: list[str] = list(b.get("calls", []))
        self.types: list[str] = list(b.get("types", []))
        self.methods: set[str] = set(b.get("methods", []))
        d = cfg.get("d2h", {})
        self.d2h_calls: list[str] = list(d.get("calls", []))
        self.d2h_methods: set[str] = set(d.get("methods", []))

    def _match_dotted(self, dotted: str, patterns: list[str]
                      ) -> Optional[str]:
        for pat in patterns:
            if pat.endswith(".*"):
                if dotted.startswith(pat[:-1]):
                    return dotted
            elif dotted == pat:
                return pat
        return None

    def classify(self, cs: CallSite, fi: FunctionInfo,
                 index: RepoIndex) -> Optional[str]:
        """Blocking description for a call site, or None."""
        if cs.ext is not None:
            hit = self._match_dotted(cs.ext, self.calls)
            if hit:
                return hit
            for t in self.types:
                if cs.ext.startswith(t + "."):
                    return cs.ext
            hit = self._match_dotted(cs.ext, self.d2h_calls)
            if hit:
                return f"{hit} (device sync)"
        if cs.method is not None:
            # Waits on known locks/conditions are structured so the lock
            # rule can exempt self-waits.
            if cs.method in ("wait", "wait_for") and cs.recv is not None:
                lock = index.resolve_lock_expr(cs.recv, fi)
                if lock is not None:
                    return f"{WAIT_PREFIX}{lock.name}"
            if cs.method in self.methods:
                return f".{cs.method}()"
            if cs.method in self.d2h_methods:
                return f".{cs.method}() (device sync)"
        return None


def wait_lock_name(desc: str) -> Optional[str]:
    if desc.startswith(WAIT_PREFIX):
        return desc[len(WAIT_PREFIX):]
    return None


def compute_blocking(index: RepoIndex, cfg: BlockingConfig) -> None:
    """Fill FunctionInfo.blocks: desc -> (line, chain) transitively."""
    funcs = list(index.all_functions())
    for fi in funcs:
        fi.blocks = {}
        for cs in fi.calls.values():
            desc = cfg.classify(cs, fi, index)
            if desc is not None and desc not in fi.blocks:
                fi.blocks[desc] = (cs.node.lineno, "")
    changed = True
    while changed:
        changed = False
        for fi in funcs:
            for cs in fi.calls.values():
                if cs.target is None or cs.target is fi:
                    continue
                for desc, (line, chain) in cs.target.blocks.items():
                    if desc not in fi.blocks:
                        sub = f" -> {chain}" if chain else ""
                        fi.blocks[desc] = (
                            cs.node.lineno, f"{cs.target.where}{sub}")
                        changed = True


# body_nodes lives in model.py (indexing needs the same pruned
# walk) and is re-exported here for the analyzers.
