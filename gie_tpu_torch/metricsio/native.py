"""ctypes bridge to the C++ exposition parser (native/promparse.cc).

The scrape loop is the metrics-in hot path: one /metrics poll per endpoint
every 50 ms (reference 1023 README:59-60), and a real model-server
exposition is tens of KB of families the EPP does not care about. The C++
scanner pulls only the mapped gauges in one pass and returns the byte
spans of the LoRA-info family's sample lines (BOTH the ':' and '_'
spellings, so the freshest-series rule of proposal 003:43-57 resolves
across them exactly like the pure-Python path); the Python caller parses
just those few lines. Loading follows native/chunker's pattern: built on
demand (`make -C native`), pure-Python fallback when absent, and parity
is pinned by tests/test_promparse_native.py.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Union

import numpy as np

from gie_tpu_torch.metricsio.mappings import LabeledGauge, ServerMapping


def _load_native():
    from gie_tpu_torch.utils.nativelib import native_lib_path

    path = native_lib_path("giepromparse")
    try:
        lib = ctypes.CDLL(path)
        fn = lib.gie_prom_extract
    except (OSError, AttributeError):
        return None
    fn.argtypes = [
        ctypes.c_char_p, ctypes.c_long,           # text, n
        ctypes.c_char_p,                          # query spec
        ctypes.c_void_p,                          # out values (f64*)
        ctypes.c_void_p,                          # out found flags (u8*)
        ctypes.c_long,                            # n queries
        ctypes.c_char_p,                          # extra families (or None)
        ctypes.c_void_p,                          # out line offsets (i64*)
        ctypes.c_void_p,                          # out line lengths (i64*)
        ctypes.c_long,                            # cap
    ]
    fn.restype = ctypes.c_long
    return fn


_NATIVE = _load_native()

# More LoRA-info series than this in one exposition would be pathological
# (vLLM emits one, occasionally two during adapter churn).
_LORA_LINES_CAP = 64


def _query_line(gauge: LabeledGauge) -> str:
    labels = ";".join(f"{k}={v}" for k, v in sorted(gauge.labels.items()))
    return f"{gauge.name}|{labels}|{gauge.value_label or ''}"


@functools.lru_cache(maxsize=32)
def _compiled_spec(mapping: ServerMapping):
    """(encoded query spec, column order, encoded extra families) — built
    once per mapping, reused on every 50 ms scrape."""
    from gie_tpu_torch.metricsio.scrape import wanted_columns

    wanted = wanted_columns(mapping)
    spec = "\n".join(_query_line(g) for _, g in wanted).encode()
    extras = None
    if mapping.lora_info:
        fams = {mapping.lora_info, mapping.lora_info.replace(":", "_")}
        extras = "\n".join(sorted(fams)).encode()
    return spec, [col for col, _ in wanted], extras


def available() -> bool:
    return _NATIVE is not None


# Per-thread reusable output buffers: the scrape engine calls extract()
# thousands of times per second across its shards, and fresh np arrays
# plus per-call ndpointer argtype validation cost tens of microseconds —
# a measurable slice of the ~100 us scrape budget. The C side writes
# values[i]/found[i] for every query on every call (promparse.cc:156-157
# initializes them first), so reuse is safe; thread-local because shards
# parse concurrently. The raw data pointers are cached WITH the arrays
# (stable for a numpy array's lifetime) so a call passes plain ints.
_BUFFERS = threading.local()


def _thread_buffers(n_columns: int):
    buf = getattr(_BUFFERS, "buf", None)
    if buf is None or buf[0][0].shape[0] < n_columns:
        arrays = (
            np.full((max(n_columns, 8),), np.nan, np.float64),
            np.zeros((max(n_columns, 8),), np.uint8),
            np.zeros((_LORA_LINES_CAP,), np.int64),
            np.zeros((_LORA_LINES_CAP,), np.int64),
        )
        buf = (arrays, tuple(a.ctypes.data for a in arrays))
        _BUFFERS.buf = buf
    return buf


def extract(
    text: Union[str, bytes], mapping: ServerMapping
) -> Optional[tuple[dict[int, float], list[str]]]:
    """One native pass: (metric columns, LoRA-info sample LINES) — or None
    when the library is not built (caller falls back to pure Python).
    Accepts bytes directly so the fetch loop never round-trips the payload
    through a str."""
    if _NATIVE is None:
        return None
    spec, columns, extras = _compiled_spec(mapping)
    raw = text if isinstance(text, bytes) else text.encode("utf-8", "replace")
    (values, found, offs, lens), ptrs = _thread_buffers(len(columns))
    n_lines = _NATIVE(raw, len(raw), spec, ptrs[0], ptrs[1], len(columns),
                      extras, ptrs[2], ptrs[3], _LORA_LINES_CAP)
    if n_lines < 0:
        return None  # malformed query spec — should be impossible
    out: dict[int, float] = {
        col: float(v)
        for col, v, f in zip(columns, values, found)
        if f  # found flag, NOT isnan: a genuine NaN sample is reported
    }
    n_lines = min(int(n_lines), _LORA_LINES_CAP)
    lora_lines = [
        raw[offs[i]: offs[i] + lens[i]].decode("utf-8", "replace")
        for i in range(n_lines)
    ]
    return out, lora_lines
