"""Build and load the port's CUDA kernels.

Every `.cu` file under ops/csrc/ is compiled by `nvcc` for `sm_90a` into an
object (one `nvcc` process per source, all started together), and the
objects are linked into one shared library with a plain C interface,
loaded with ctypes. The library lands in ops/_build/<hash>/, keyed on a
hash of the sources and flags, so an edit rebuilds and an unchanged tree
reuses the last build. Nothing here runs at import: `library()` builds on
the first launch of a kernel on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time

from gie_tpu_torch.ops import KernelUnavailable

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
LIB_NAME = "libgie_tpu_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> (argtypes, restype). The launchers return a
# cudaError_t as int (0 = launched).
SIGNATURES = {
    # k, cap, v_init, plan, v_out, scratch, n, m, iters, stream
    "gie_fused_sinkhorn_plan": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _P), _I),
    # n, m, out int[7]
    "gie_fused_sinkhorn_layout": ((_I, _I, _P), _I),
    # stacked, wvec, mask, vals, idx, s, n, m, k, stream
    "gie_fused_blend_topk": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "gie_cuda_error_string": ((_I,), ctypes.c_char_p),
}
# cudaError_t codes a launcher returns when the kernel itself cannot run on
# this device (invalid value or configuration, invalid device function,
# invalid kernel image, no image for the device, invalid or unsupported
# PTX, too many resources, cooperative launch too large, not supported).
# Any other code is the device's: a sticky fault of an earlier launch
# surfaces here too.
KERNEL_ERRORS = frozenset({1, 9, 98, 200, 209, 218, 222, 701, 720, 801})

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# What the last build did: {"seconds", "cached", "dir", "log"}.
last_build: dict = {}


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    # torch's lookup: $CUDA_HOME / $CUDA_PATH, then nvcc on PATH, then the
    # toolkit's default install directory.
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def _compile(out_dir: str) -> str:
    """Compile every source in parallel, link, and return the build log."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for src in (s for s in _sources() if s.endswith(".cu")):
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        log, failed = [], []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {os.path.basename(src)}\n{out.decode()}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(
                "nvcc failed for " + ", ".join(failed) + "\n" + "\n".join(log))
        lib_tmp = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-shared", "-o", lib_tmp, *(o for _s, o, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout.decode())
        os.makedirs(out_dir, exist_ok=True)
        text = "\n".join(log)
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(text)
        # Atomic publish: a concurrent loader sees the whole library or none.
        os.replace(lib_tmp, os.path.join(out_dir, LIB_NAME))
        return text


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use. Raises
    KernelUnavailable when it cannot be built or loaded."""
    with _lock:
        if _lib is None:
            try:
                _load()
            except KernelUnavailable:
                raise
            except Exception as e:
                raise KernelUnavailable(
                    f"the port's CUDA kernels cannot be built or loaded: {e}"
                ) from e
        return _lib


def _load() -> None:
    """Build (or reuse) and load the library; the caller holds _lock."""
    global _lib
    t0 = time.perf_counter()
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    path = os.path.join(out_dir, LIB_NAME)
    cached = os.path.exists(path)
    if cached:
        with open(os.path.join(out_dir, "build.log")) as f:
            log = f.read()
    else:
        os.makedirs(BUILD_ROOT, exist_ok=True)
        log = _compile(out_dir)
    lib = ctypes.CDLL(path)
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    last_build.update(seconds=time.perf_counter() - t0,
                      cached=cached, dir=out_dir, log=log)
    _lib = lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error: KernelUnavailable
    for a code in KERNEL_ERRORS, RuntimeError for the device's own."""
    if err != 0:
        text = library().gie_cuda_error_string(err).decode()
        cls = KernelUnavailable if err in KERNEL_ERRORS else RuntimeError
        raise cls(f"{name} failed to launch: CUDA error {err}: {text}")
