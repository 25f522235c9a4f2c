"""gie-lint for the port: static analyzers for the concurrency and
capture-safety rules gie_tpu_torch depends on.

``locks``      lock discipline: acquisition order against the declared
               hierarchy in ``lockorder.toml`` (GL001), blocking while
               locked (GL002: I/O, json, sleeps, subprocess, and torch's
               device-to-host syncs inside a ``with lock:`` body), every
               lock ranked (GL003) and no rank stale (GL004).
``tracesafe``  CUDA-graph capture safety: no device work at import
               (GT001), no host sync or Python side effect in code
               reachable from the declared capture roots (GT002), no
               explicit synchronize outside the listed functions (GT003),
               no host sync in the mesh layer (GT004).
``asynclint``  blocking calls inside ``async def`` event-loop code (GA001).
``daemonloop`` unbounded receives and acquires in ``while`` loops (GR001).
``clockcalls`` direct clock calls in clock-governed modules (GC001).
``dynamic``    instrumented lock wrapper: records the real acquisition
               orders under tests and on the card and asserts them
               against the same declared hierarchy.

The analyzers are stdlib ``ast`` code: they import neither torch nor any
module they analyze, and run on the CPU by nature. Run as ``python -m
gie_tpu_torch.lint``; pinned by tests/test_torch_lint.py. Findings that
predate a rule live in ``baseline.toml``, each with a justification, and
an entry that no longer matches a finding fails the run.
"""

from gie_tpu_torch.lint.model import RepoIndex, Violation  # noqa: F401
from gie_tpu_torch.lint.runner import run_paths  # noqa: F401
