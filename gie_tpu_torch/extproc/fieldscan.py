"""Zero-parse admission field scan (ctypes bridge to native/jsonscan.cc).

The ext-proc pick path needs four things from a request body — `model`,
the max_tokens-style output cap, `stream`, and the prompt/messages shape
— and the legacy path paid a full ``json.loads`` for them on every
request (bbr/chain.py parse + codec re-parse on the transcoding path).
The native scanner walks the body once, validates exactly the JSON
language ``json.loads`` accepts, and extracts only those fields without
materializing any Python objects.

Loading follows the promparse pattern (metricsio/native.py): built on
demand (``make -C native``), per-thread reusable output buffers, and a
pure-Python fallback (:func:`scan_py` — one honest ``json.loads``) when
the library is absent or declares an input inconclusive, so behavior is
bit-for-bit identical either way. Parity between the two is pinned by
tests/test_fieldscan.py's fuzz suite.

The scan is the request path's replacement for the parsed dict under the
1964 shared-parse rule: at most one body read per request, and on the
fast lane zero full parses.
"""

from __future__ import annotations

import ctypes
import json
import math
import threading
from typing import Optional

from gie_tpu_torch.resilience import faults

# Body fields carrying the client's output-token cap, by API generation —
# the single source of truth for the (field, order) contract between the
# native scanner, the fallback, and server._decode_tokens.
MAX_TOKENS_FIELDS = ("max_tokens", "max_completion_tokens",
                     "max_output_tokens")

_MODEL_CAP = 4096  # longer model names fall back to the full parse

_SCAN_INVALID = -1
_SCAN_FALLBACK = -2


class FieldScan:
    """Watched-field view of one request body.

    ``valid`` mirrors ``parse_body(body) is not None`` (top-level JSON
    object); every other attribute is meaningful only when ``valid``.
    ``caps`` aligns with :data:`MAX_TOKENS_FIELDS`: the entry is a float
    when the field's LAST occurrence is a JSON number (bools excluded,
    like the legacy ``isinstance(v, (int, float))`` check), else None.
    """

    __slots__ = ("valid", "model", "stream", "prompt_is_str",
                 "messages_is_list", "caps")

    def __init__(self, valid: bool, model: Optional[str] = None,
                 stream: bool = False, prompt_is_str: bool = False,
                 messages_is_list: bool = False,
                 caps: tuple = (None, None, None)):
        # Positional-friendly: the native path constructs one per request.
        self.valid = valid
        self.model = model
        self.stream = stream
        self.prompt_is_str = prompt_is_str
        self.messages_is_list = messages_is_list
        self.caps = caps

    def __eq__(self, other):  # parity tests compare scans directly
        if not isinstance(other, FieldScan):
            return NotImplemented

        def caps_eq(a, b):
            return len(a) == len(b) and all(
                (x is None) == (y is None)
                and (x is None or x == y or (math.isnan(x) and math.isnan(y)))
                for x, y in zip(a, b)
            )

        return (self.valid == other.valid
                and self.model == other.model
                and self.stream == other.stream
                and self.prompt_is_str == other.prompt_is_str
                and self.messages_is_list == other.messages_is_list
                and caps_eq(self.caps, other.caps))

    def __repr__(self):
        return (f"FieldScan(valid={self.valid}, model={self.model!r}, "
                f"stream={self.stream}, prompt_is_str={self.prompt_is_str}, "
                f"messages_is_list={self.messages_is_list}, "
                f"caps={self.caps})")


_INVALID = FieldScan(valid=False)


def _load_native():
    from gie_tpu_torch.utils.nativelib import native_lib_path

    path = native_lib_path("giejsonscan")
    try:
        lib = ctypes.CDLL(path)
        fn = lib.gie_json_scan
        hdr = lib.gie_headers_scan
    except (OSError, AttributeError):
        return None, None
    fn.argtypes = [
        ctypes.c_char_p, ctypes.c_long,   # text, n
        ctypes.c_void_p,                  # out caps (f64[3])
        ctypes.c_void_p, ctypes.c_long,   # model buf, cap
    ]
    fn.restype = ctypes.c_long
    hdr.argtypes = [
        ctypes.c_char_p, ctypes.c_long,   # serialized HeaderMap, n
        ctypes.c_char_p,                  # needed-keys spec ('\n'-joined)
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # idx/off/len
        ctypes.c_long,                    # cap
    ]
    hdr.restype = ctypes.c_long
    return fn, hdr


_NATIVE, _NATIVE_HEADERS = _load_native()


def available() -> bool:
    return _NATIVE is not None


def headers_available() -> bool:
    """True when the native needed-keys header walker is loadable —
    callers must check BEFORE serializing a HeaderMap for scan_headers
    (serializing just to discover the library is absent would make the
    no-library fast lane strictly slower than its own fallback loop)."""
    return _NATIVE_HEADERS is not None


# Per-thread reusable output buffers (promparse pattern, metricsio/
# native.py:93): the admission path calls scan() once per request across
# the gRPC service threads; fresh ctypes buffers per call would cost more
# than the scan itself for small bodies. The C side fully initializes
# every output on every call, so reuse is safe; thread-local because
# requests scan concurrently. Raw addresses are cached with the buffers
# (stable for a ctypes buffer's lifetime) so a call passes plain ints.
_BUFFERS = threading.local()


def _thread_buffers():
    buf = getattr(_BUFFERS, "buf", None)
    if buf is None:
        # The two array OBJECTS ride in the tuple alongside their raw
        # addresses: holding only addressof() would let the buffers be
        # collected while C still writes through the pointers.
        caps = (ctypes.c_double * 3)()
        model = ctypes.create_string_buffer(_MODEL_CAP)
        buf = (caps, model, ctypes.addressof(caps), ctypes.addressof(model))
        _BUFFERS.buf = buf
    return buf


_NO_CAPS = (None, None, None)


def scan_native(body: bytes) -> Optional[FieldScan]:
    """Native one-pass scan; None when the library is absent or the input
    is one the scanner cannot cheaply reproduce Python semantics for
    (non-UTF-8 encodings, escaped top-level keys, lone surrogates in the
    model string, >308-digit integers, >64-deep nesting).

    All scalar results ride in the packed return value (flag bits 0-8,
    model length in bits 16+), so the common case is one FFI call plus at
    most a model-string copy and the found caps reads."""
    if _NATIVE is None:
        return None
    caps, _model, caps_ptr, model_ptr = _thread_buffers()
    rc = _NATIVE(body, len(body), caps_ptr, model_ptr, _MODEL_CAP)
    if rc < 0:
        if rc == _SCAN_FALLBACK:
            return None
        # json.loads raises: parse_body would return None.
        return _INVALID
    if not rc & 0x01:  # valid JSON but the top level is not an object
        return _INVALID
    model = None
    if rc & 0x02:
        # string_at copies exactly model_len bytes (buf.raw would copy
        # the whole 4 KiB buffer per request).
        model = ctypes.string_at(model_ptr, rc >> 16).decode("utf-8")
    found = (rc >> 6) & 0x7
    if found:
        caps_t = (
            caps[0] if found & 1 else None,
            caps[1] if found & 2 else None,
            caps[2] if found & 4 else None,
        )
    else:
        caps_t = _NO_CAPS
    return FieldScan(
        True,
        model,
        bool(rc & 0x08 and rc & 0x04),
        bool(rc & 0x10),
        bool(rc & 0x20),
        caps_t,
    )


def scan_py(body: bytes) -> FieldScan:
    """Reference implementation: one honest ``json.loads``. This is both
    the no-library fallback and the parity oracle the fuzz suite holds
    the native scanner to."""
    try:
        obj = json.loads(body)
    except (ValueError, UnicodeDecodeError):
        return _INVALID
    if not isinstance(obj, dict):
        return _INVALID
    model = obj.get("model")
    caps = []
    for field in MAX_TOKENS_FIELDS:
        v = obj.get(field)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            caps.append(float(v))
        else:
            caps.append(None)
    return FieldScan(
        valid=True,
        model=model if isinstance(model, str) else None,
        stream=bool(obj.get("stream", False)),
        prompt_is_str=isinstance(obj.get("prompt"), str),
        messages_is_list=isinstance(obj.get("messages"), list),
        caps=tuple(caps),
    )


def scan(body: bytes) -> FieldScan:
    """The admission fast lane's body read: native when built, else (or on
    a native FALLBACK verdict) the single-parse Python reference. Always
    returns a FieldScan; behavior is identical either way."""
    if faults.ENABLED:
        # gie-chaos: an injected native-scanner failure exercises the
        # degradation already built in — the honest single-parse fallback
        # serves the request instead of failing admission. Disabled cost:
        # one module-attribute load + falsy branch (the bench-extproc
        # regression guard pins this).
        v = faults.fire("native.scan")
        if v.kind in (faults.ERROR, faults.CORRUPT):
            return scan_py(body)
    result = scan_native(body)
    if result is None:
        return scan_py(body)
    return result


# ---------------------------------------------------------------------------
# Needed-keys header scan
# ---------------------------------------------------------------------------


class HeaderSpec:
    """Compiled needed-keys set for :func:`scan_headers`: the '\\n'-joined
    spec bytes (kept alive and identity-stable — the native side caches
    its parsed form per spec pointer) plus the key list for index->key
    resolution."""

    __slots__ = ("keys", "spec")

    def __init__(self, keys):
        self.keys = sorted(keys)
        self.spec = "\n".join(self.keys).encode()


_HDR_CAP = 32  # more matched needed-header values than this is hostile


def _hdr_buffers():
    buf = getattr(_BUFFERS, "hdr", None)
    if buf is None:
        arrays = (
            (ctypes.c_long * _HDR_CAP)(),
            (ctypes.c_long * _HDR_CAP)(),
            (ctypes.c_long * _HDR_CAP)(),
        )
        buf = arrays + tuple(ctypes.addressof(a) for a in arrays)
        _BUFFERS.hdr = buf
    return buf


def scan_headers(
    header_map_bytes: bytes, spec: HeaderSpec
) -> Optional[list[tuple[str, str]]]:
    """Extract the needed headers from a serialized Envoy HeaderMap in one
    native pass: [(key, value)] in wire order, raw_value preferred over
    value when non-empty (envoy.get_header_value semantics). None when
    the library is absent or the bytes do not parse (caller falls back to
    iterating the message)."""
    if _NATIVE_HEADERS is None:
        return None
    idx, off, length, idx_p, off_p, len_p = _hdr_buffers()
    n = _NATIVE_HEADERS(header_map_bytes, len(header_map_bytes), spec.spec,
                        idx_p, off_p, len_p, _HDR_CAP)
    if n < 0 or n >= _HDR_CAP:
        # Malformed bytes, or the output cap was hit (the C walk stops at
        # cap and would silently drop later matches): let the caller's
        # Python loop see everything.
        return None
    keys = spec.keys
    return [
        (
            keys[idx[k]],
            header_map_bytes[off[k]: off[k] + length[k]].decode(
                "utf-8", "replace"
            ),
        )
        for k in range(n)
    ]
