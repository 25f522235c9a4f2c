"""Hand-written Hopper kernels, each with its plain PyTorch version beside it.

The dispatch rule, one for every kernel of the port: a wrapper given CPU
tensors computes the plain version; given CUDA tensors it launches the
kernel (built on first use, ops/build.py) or raises. There is no fallback
from a CUDA tensor to the plain version.

A kernel that cannot run at all raises KernelUnavailable: its build or load
failed, it refuses the shape, or the driver refused its launch
configuration (a cycle that cannot be captured into a CUDA graph raises
its subclass GraphCaptureFailed). That is a fault of the deployment, not of
a sick device, so the picker re-raises it instead of answering the wave on
a degraded rung.

Launch counts: each wrapper carries `launches`, the kernel's launches on
live waves, and `warmup_launches`, its launches on a throwaway state
before a capture. A wrapper calls count_launch() where it launches; under
tally() on the same thread the launch goes to the tally instead, which is
how a CUDA graph learns what it launches per replay (sched/graphs.py adds
that to `launches` at every replay).
"""

from __future__ import annotations

import contextlib
import threading

import torch


class KernelUnavailable(RuntimeError):
    """A kernel that cannot run here (build, load, shape or launch
    configuration refused)."""


class ShapeRefused(KernelUnavailable, ValueError):
    """A kernel refuses its inputs' shape."""


class GraphCaptureFailed(KernelUnavailable):
    """The scheduling cycle could not be captured into a CUDA graph."""


_tallies = threading.local()


def count_launch(wrapper) -> None:
    """Count one launch of `wrapper`'s kernel: into this thread's tally
    when one is open, else into `wrapper.launches`."""
    sink = getattr(_tallies, "sink", None)
    if sink is None:
        wrapper.launches += 1
    else:
        sink[wrapper] = sink.get(wrapper, 0) + 1


@contextlib.contextmanager
def tally(sink: dict):
    """Count this thread's launches into `sink` ({wrapper: launches})
    instead of the wrappers' `launches` while the context is open."""
    prev = getattr(_tallies, "sink", None)
    _tallies.sink = sink
    try:
        yield sink
    finally:
        _tallies.sink = prev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every one lies on the CPU (plain version); raises on a mix
    or on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(
        f"kernel inputs must all lie on one CUDA device or all on the CPU; "
        f"got {sorted(str(t.device) for t in tensors)}")


def check_input(t: torch.Tensor, name: str, dtype: torch.dtype,
                shape: tuple) -> None:
    """Raise unless `t` has the dtype, shape and contiguity a kernel
    takes (the kernels index raw row-major pointers)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel inputs must be contiguous")


def current(device: torch.device):
    """A context with `device` current, for a launch on it: a no-op when it
    already is (switching costs more host time than the launch itself)."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raw_stream(device: torch.device) -> int:
    """The handle of `device`'s current stream, for a C entry point (the
    public torch.cuda.current_stream() builds a Stream object per call,
    several microseconds of host time on every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
