"""Bytes, flops and operations of one scheduling cycle, counted op by op.

One workload recipe, two consumers: `hack/torch_cost_analysis.py` (the
developer-facing report) and `tests/test_torch_cost_budget.py` (the gate);
chip_smoke.py counts the same cycle on the card and holds it to the CPU's
count. The recipe is the reference's (gie_tpu/utils/costmodel.py): 1024
requests x 256 endpoints, rng seed 0, 16 shared system prompts, LoRA ids
-1..11, the chunk axis cut to its bucket, one cycle on a fresh state.

The reference reads XLA's cost analysis of the compiled program. A torch
cycle has no compiled program to ask, so a TorchDispatchMode counts what
the captured cycle replays: every aten op but views and metadata is one
device operation, moving the bytes of its distinct input and output
tensors (each read or written once) and doing 2*M*N*K flops for a
product, one per input element for a reduction, and one per output
element otherwise. The hand-written kernels launch through ctypes,
outside the dispatcher; each wrapper declares its own bytes and flops
(ops.costed, one formula per kernel) and the counter adds them once per
call, counting nothing inside it, so the CPU's count (where the wrapper
runs its plain version) equals the card's.

A wave's bytes over the card's memory rate is what the wave would take if
bytes bound it; against the captured wave's device time (chip_smoke.py
phase 21) it says whether bytes or the number of operations does.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import sys
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# Ops that move no data and launch nothing on the card: views (aliases of
# their input) and allocation or metadata queries.
_FREE = frozenset((
    "detach", "alias", "lift_fresh", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "set_", "resize_",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "is_nonzero", "_to_copy_meta", "_reshape_alias",
    "view", "as_strided", "expand", "unsqueeze", "squeeze", "t",
    "transpose", "permute", "select", "slice", "unbind", "split",
    "split_with_sizes", "chunk", "narrow", "unfold", "diagonal",
    "view_as_real", "view_as_complex", "_unsafe_view", "real", "imag",
))
# One flop per INPUT element: reductions, scans, selections over an axis.
_REDUCTIONS = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "prod", "any", "all", "logsumexp", "norm", "linalg_vector_norm", "std",
    "var", "topk", "sort", "count_nonzero", "nansum", "cumsum", "cumprod",
    "median", "mode", "kthvalue", "aminmax", "cummax", "cummin",
))


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Frames that are the counting itself: this module and ops.costed.
_SKIP = (os.path.abspath(__file__), os.path.join(_PKG, "ops", "__init__.py"))


def _site() -> str:
    """"file.py:function" of the innermost frame of the package (the
    counting's own excepted) on the stack: where an op was called from."""
    frame = sys._getframe(2)
    while frame is not None:
        path = frame.f_code.co_filename
        if path.startswith(_PKG) and path not in _SKIP:
            return (f"{os.path.relpath(path, _PKG)}:"
                    f"{frame.f_code.co_qualname}")
        frame = frame.f_back
    return "<outside>"


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements `t` addresses (a broadcast dim of stride 0
    reads its elements once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _product_flops(name: str, args) -> Optional[int]:
    """2*M*N*K of a matrix product, None for any other op."""
    if name in ("mm", "addmm"):
        a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "mv":
        return 2 * args[0].shape[0] * args[0].shape[1]
    if name in ("dot", "vdot"):
        return 2 * args[0].shape[0]
    return None


@dataclasses.dataclass
class CycleCount:
    """What one counted cycle did: totals and per-op tables keyed by the
    aten op's name (a kernel by its wrapper's name)."""

    ops: int = 0
    bytes: int = 0
    flops: int = 0
    by_op: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    bytes_by_op: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    flops_by_op: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    # The same by the function of the package that called the op.
    by_site: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    bytes_by_site: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def add(self, name: str, nbytes: int, flops: int, site: str) -> None:
        self.ops += 1
        self.bytes += nbytes
        self.flops += flops
        self.by_op[name] += 1
        self.bytes_by_op[name] += nbytes
        self.flops_by_op[name] += flops
        self.by_site[site] += 1
        self.bytes_by_site[site] += nbytes

    def totals(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "ops": float(self.ops)}


class OpCounter(TorchDispatchMode):
    """Counts every aten op dispatched on this thread while it is open
    (see the module docstring), and the kernels' declared costs."""

    def __init__(self):
        super().__init__()
        self.count = CycleCount()
        self.paused = 0          # raised by ops.costed around a kernel call

    def kernel(self, name: str, nbytes: int, flops: int) -> None:
        if not self.paused:
            self.count.add(name, int(nbytes), int(flops), _site())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.paused or func.is_view:
            return out
        name = func.overloadpacket.__name__
        if name in _FREE:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        seen, nbytes = set(), 0
        for t in ins + outs:
            key = (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
            if key not in seen:
                seen.add(key)
                nbytes += _distinct_bytes(t)
        flops = _product_flops(name, args)
        if flops is None:
            flops = (math.prod(ins[0].shape) if name in _REDUCTIONS and ins
                     else sum(math.prod(t.shape) for t in outs))
        self.count.add(name, nbytes, flops, _site())
        return out


def fixture(n: int, m: int, device):
    """The north-star wave of gie_tpu/utils/costmodel.py: (reqs, eps) on
    `device`, the chunk axis cut to its bucket."""
    from gie_tpu_torch.sched.types import chunk_bucket_for
    from gie_tpu_torch.utils.testing import make_endpoints, make_requests

    rng = np.random.default_rng(0)
    eps = make_endpoints(
        m, queue=rng.integers(0, 50, m).tolist(),
        kv=rng.uniform(0, 0.95, m).tolist(), max_lora=8, m_slots=m,
        device=device)
    base = b"SYSTEM: task %d. "
    prompts = [(base % (i % 16)) * 6 + b"u%d" % i for i in range(n)]
    reqs = make_requests(
        n, prompts=prompts, lora_id=rng.integers(-1, 12, n).tolist(),
        m_slots=m, device=device)
    cb = chunk_bucket_for(int(reqs.n_chunks.max()))
    return reqs.replace(chunk_hashes=reqs.chunk_hashes[:, :cb]), eps


def configs() -> dict:
    """The configurations counted by name: the cost gate's three
    (ProfileConfig(), picker="sinkhorn", the tuned profile) and the two
    that run a kernel. tests/test_torch_cost_budget.py gates them,
    hack/torch_cost_analysis.py reports them and chip_smoke.py phase 21
    holds the card's count of each to the CPU's."""
    from gie_tpu_torch.sched.config import ProfileConfig, tuned_profile

    tuned = tuned_profile()[0]
    return {
        "default-topk": ProfileConfig(),
        "sinkhorn": ProfileConfig(picker="sinkhorn"),
        "tuned": tuned,
        "tuned+use_pallas_sinkhorn": dataclasses.replace(
            tuned, use_pallas_sinkhorn=True),
        "topk+use_pallas_topk": ProfileConfig(picker="topk",
                                              use_pallas_topk=True),
    }


def count_cycle(cfg, n: int = 1024, m: int = 256,
                device=None) -> CycleCount:
    """Count one scheduling cycle of `cfg` on the fixture (see
    cycle_cost), with every op and kernel of it in the tables."""
    from gie_tpu_torch import ops
    from gie_tpu_torch.sched.profile import (
        feature_schema, gumbel_noise, resolve_device, scheduling_cycle)
    from gie_tpu_torch.sched.types import SchedState, Weights

    dev = resolve_device(device)
    weights = Weights.default()
    reqs, eps = fixture(n, m, dev)
    state = SchedState.init(m=m, device=dev)
    gumbel = None
    if cfg.picker != "topk":
        shape = (2, n, m) if cfg.pd_disaggregation else (n, m)
        gumbel = gumbel_noise(shape, torch.Generator().manual_seed(0),
                              "cpu").to(dev)
    # The captured cycle reads its weights from a static buffer (what a
    # replay runs): made here, outside the count.
    wvec = torch.tensor([getattr(weights, k) for k in feature_schema(cfg)],
                        dtype=torch.float32, device=dev)
    counter = OpCounter()
    with ops.cost_sink(counter), counter:
        scheduling_cycle(state, reqs, eps, weights, gumbel, cfg=cfg,
                         wvec=wvec)
    if counter.count.ops == 0 or counter.count.bytes == 0:
        raise RuntimeError(
            "the op counter saw no operation of the scheduling cycle — the "
            "cost gate would pass vacuously; update "
            "gie_tpu_torch/utils/costmodel.py for the dispatcher")
    return counter.count


def cycle_cost(cfg, n: int = 1024, m: int = 256,
               device=None) -> dict[str, float]:
    """-> {"flops", "bytes", "ops"} of one scheduling cycle of `cfg` on the
    north-star fixture (shared system prompts, mixed LoRA ids, the chunk
    axis bucketed: the shaping the batching layer produces live), on a
    fresh state with Weights.default(). `device=None` is the card, and
    raises without one (as Scheduler does); tests pass "cpu". Raises if
    it counted nothing."""
    return count_cycle(cfg, n, m, device).totals()
