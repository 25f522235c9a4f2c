"""The scheduling cycle captured as CUDA graphs, one per wave shape.

The CUDA counterpart of the reference's executable cache
(gie_tpu/sched/profile.py: Scheduler._jit, _warm, warm_lattice_async): where
the reference compiles one executable per (N bucket, M bucket, chunk
lanes) key and dispatches it once a wave, the port captures the whole
cycle once per key and replays it once a wave, so a wave costs one graph
launch instead of some 300-430 kernel launches from Python.

A CycleGraph owns static tensors at its key's shape: every RequestBatch
and EndpointBatch field and the blend weights, all views of one device
buffer, and the Gumbel noise ([N, M], or [2, N, M] under
pd_disaggregation, whose two solves draw a plane each). It is bound to
the live SchedState of its M bucket, which the Scheduler allocates once
and never reallocates (the graph holds the addresses of its tensors). A
wave

  1. packs its rows into one pinned host buffer, padding rows zeroed as
     pad_requests pads them, and copies it up in H2D_COPIES copy;
  2. draws its noise into the static noise buffer, outside the graph;
  3. replays the graph, which updates the state in place and leaves the
     pick in static outputs that the next replay overwrites, so the
     caller queues its copies of them before it releases the lock.

Capture runs on the scheduler's own stream in thread-local mode, so the
threads that run live waves and completions neither break it nor are
broken by it. A device-wide synchronize (torch.cuda.synchronize) is the
one call another thread must not make while a capture runs: CUDA refuses
it and invalidates the capture. The port makes none; a caller that does
joins the warm threads first. An eager pass of the cycle on a throwaway state runs first
on that stream (it loads the kernels and the libraries' workspaces there);
the capture itself executes nothing, so the live state is untouched, as
the reference's _warm leaves it. Each graph allocates from a memory pool
of its own. A capture that fails raises ops.GraphCaptureFailed: there is
no eager cycle on CUDA to fall back to.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from gie_tpu_torch import ops
from gie_tpu_torch.sched.types import (
    EndpointBatch,
    PickResult,
    RequestBatch,
    SchedState,
    Weights,
)

# Host-to-device copies a wave makes: every input field and the weights
# travel in one pinned buffer.
H2D_COPIES = 1
_ALIGN = 16

# cycle(state, reqs, eps, gumbel, wvec) -> PickResult, updating `state`
# in place.
Cycle = Callable[[SchedState, RequestBatch, EndpointBatch,
                  Optional[torch.Tensor], torch.Tensor], PickResult]


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


@dataclasses.dataclass(frozen=True)
class _Slot:
    """Where one input field lies in the staging buffer."""

    group: str          # "reqs" | "eps"
    name: str
    offset: int
    nbytes: int
    dtype: torch.dtype
    np_dtype: np.dtype
    shape: tuple


class CycleGraph:
    """The cycle for one (n_bucket, m, chunk_lanes) key, captured over
    static inputs and the live state of bucket m."""

    def __init__(self, key: tuple, state: SchedState,
                 schema: tuple[str, ...], noise_shape: Optional[tuple],
                 device: torch.device):
        n, m, lanes = key
        if state.m != m:
            raise ValueError(f"state of width {state.m} for a graph of {m}")
        self.key = key
        self.state = state
        self.device = device
        self._schema = schema
        self._template = (RequestBatch.empty(n, m, lanes=lanes),
                          EndpointBatch.empty(m))
        self._slots: list[_Slot] = []
        off = 0
        for group, batch in zip(("reqs", "eps"), self._template):
            for f in dataclasses.fields(batch):
                t = getattr(batch, f.name)
                nbytes = t.numel() * t.element_size()
                self._slots.append(_Slot(group, f.name, off, nbytes, t.dtype,
                                         t.numpy().dtype, tuple(t.shape)))
                off += _aligned(nbytes)
        self._wvec_offset = off
        self.nbytes = off + _aligned(4 * len(schema))
        self._buf = torch.empty((self.nbytes,), dtype=torch.uint8,
                                device=device)
        views = {(s.group, s.name): self._buf[s.offset:s.offset + s.nbytes]
                 .view(s.dtype).view(s.shape) for s in self._slots}
        self.reqs = RequestBatch(**{
            f.name: views["reqs", f.name]
            for f in dataclasses.fields(RequestBatch)})
        self.eps = EndpointBatch(**{
            f.name: views["eps", f.name]
            for f in dataclasses.fields(EndpointBatch)})
        self.wvec = self._buf[off:off + 4 * len(schema)].view(torch.float32)
        # The wave's Gumbel noise: [n, m], or [2, n, m] for a dual pick.
        self.gumbel = (None if noise_shape is None else torch.zeros(
            noise_shape, dtype=torch.float32, device=device))
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.result: Optional[PickResult] = None
        # {kernel wrapper: launches one replay makes}, from the capture.
        self.launches: dict = {}
        self.capture_s = 0.0
        self._ready: Optional[torch.cuda.Event] = None

    def pack(self, reqs: RequestBatch, eps: EndpointBatch,
             weights: Weights) -> tuple[torch.Tensor, list]:
        """The wave's inputs in a fresh pinned host buffer laid out as the
        static buffer, request rows past the wave's zeroed; touches no
        device state, so it runs outside the scheduler's lock. -> (buffer,
        [(static view, CUDA source)] for fields the caller passed on the
        card, which upload() copies on the device)."""
        host = torch.empty((self.nbytes,), dtype=torch.uint8, pin_memory=True)
        buf = host.numpy()
        on_card = []
        for s in self._slots:
            src = getattr(reqs if s.group == "reqs" else eps, s.name)
            if (src.dtype != s.dtype or tuple(src.shape[1:]) != s.shape[1:]
                    or src.shape[0] > s.shape[0]):
                raise TypeError(
                    f"{s.group}.{s.name}: {src.dtype}{tuple(src.shape)} does "
                    f"not fit the graph's {s.dtype}{s.shape}")
            if src.device.type != "cpu":
                view = getattr(self.reqs if s.group == "reqs" else self.eps,
                               s.name)
                on_card.append((view, src))
                continue
            dst = np.ndarray(s.shape, s.np_dtype, buffer=buf, offset=s.offset)
            rows = src.shape[0]
            dst[:rows] = src.numpy()
            dst[rows:] = 0
        np.ndarray((len(self._schema),), np.float32, buffer=buf,
                   offset=self._wvec_offset)[:] = [
            getattr(weights, k) for k in self._schema]
        return host, on_card

    def upload(self, host: torch.Tensor, on_card: list) -> None:
        """Queue the packed inputs into the static buffer on the current
        stream: one H2D copy, then a device copy of each field that came
        on the card (its padding rows zeroed)."""
        self._buf.copy_(host, non_blocking=True)
        for view, src in on_card:
            rows = src.shape[0]
            view[:rows].copy_(src)
            view[rows:].zero_()

    def capture(self, cycle: Cycle, stream: torch.cuda.Stream,
                weights: Weights) -> None:
        """Warm up on a throwaway state, then capture `cycle` over the
        static inputs and the live state, on `stream`. Raises
        ops.GraphCaptureFailed."""
        t0 = time.perf_counter()
        warm: dict = {}
        try:
            with torch.cuda.stream(stream):
                self.upload(*self.pack(*self._template, weights))
                throwaway = SchedState.init(m=self.state.m,
                                            device=self.device)
                with ops.tally(warm):
                    cycle(throwaway, self.reqs, self.eps, self.gumbel,
                          self.wvec)
                del throwaway
                graph = torch.cuda.CUDAGraph()
                pool = torch.cuda.graph_pool_handle()   # this graph's own
                with ops.tally(self.launches):
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                    try:
                        result = cycle(self.state, self.reqs, self.eps,
                                       self.gumbel, self.wvec)
                    except BaseException:
                        _end_broken(graph, self.device, pool)
                        raise
                    graph.capture_end()
                # The first replay, on the live stream, waits for this
                # stream's warm-up to be done with the static inputs.
                ready = torch.cuda.Event()
                ready.record(stream)
        except Exception as e:
            raise ops.GraphCaptureFailed(
                f"the scheduling cycle at (n, m, chunk lanes) = {self.key} "
                f"could not be captured: {e}") from e
        for wrapper, count in warm.items():
            wrapper.warmup_launches += count
        self.graph, self.result, self._ready = graph, result, ready
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> PickResult:
        """Queue one replay on the current stream and count the launches
        it makes; -> the static outputs it writes."""
        if self._ready is not None:
            torch.cuda.current_stream(self.device).wait_event(self._ready)
            self._ready = None
        self.graph.replay()
        for wrapper, count in self.launches.items():
            wrapper.launches += count
        return self.result


class FoldGraph:
    """prefix.ingest_lanes captured over a static lane buffer of `size`
    lanes (rows: hash, endpoint, removed) and the prefix table and tick of
    one M bucket's live state, which the Scheduler never reallocates. A
    KV-event fold then costs one copy into the buffer and one graph
    launch instead of some 30 kernel launches from Python. Folds run under
    the scheduler's lock on the stream of its waves; capture runs on a
    stream of its own, ordered after the work already queued."""

    def __init__(self, state: SchedState, size: int, device: torch.device):
        self.state = state
        self.size = size
        self.device = device
        self.lanes = torch.zeros((3, size), dtype=torch.int64, device=device)
        self._scratch = torch.full((2, int(state.prefix.keys.shape[0])), -1,
                                   dtype=torch.int64, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def _fold(self) -> None:
        from gie_tpu_torch.sched.prefix import ingest_lanes

        ingest_lanes(self.state.prefix, self.lanes[0], self.lanes[1],
                     self.lanes[2] != 0, self.state.tick, self._scratch)

    def capture(self, stream: torch.cuda.Stream) -> None:
        """Capture the fold on `stream` after what the current stream has
        queued: one eager pass over all-padding lanes first (it writes
        every target its own value) loads the kernels there. Raises
        ops.GraphCaptureFailed."""
        current = torch.cuda.current_stream(self.device)
        try:
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                self._fold()
                graph = torch.cuda.CUDAGraph()
                pool = torch.cuda.graph_pool_handle()
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    self._fold()
                except BaseException:
                    _end_broken(graph, self.device, pool)
                    raise
                graph.capture_end()
            current.wait_stream(stream)
        except Exception as e:
            raise ops.GraphCaptureFailed(
                f"the KV-event fold of {self.size} lanes at m="
                f"{self.state.m} could not be captured: {e}") from e
        self.graph = graph

    def replay(self, lanes: torch.Tensor) -> None:
        """Queue one fold of `lanes` (int64[3, size] on the device) on the
        current stream."""
        self.lanes.copy_(lanes)
        self.graph.replay()


def _end_broken(graph: torch.cuda.CUDAGraph, device: torch.device,
                pool: tuple) -> None:
    """End a capture the cycle raised in, so its stream runs again. The
    cycle's error is the one to report; ending an invalidated capture
    raises too, before torch tells its allocator that the capture is over,
    so that is done here, and the graph's pool is given up."""
    try:
        graph.capture_end()
    except RuntimeError:
        torch._C._cuda_endAllocateToPool(device.index, pool)
        torch._C._cuda_releasePool(device.index, pool)
