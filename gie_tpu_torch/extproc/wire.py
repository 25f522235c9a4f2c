"""Wire-level ProcessingRequest classification (ctypes bridge to
native/pbwalk.cc).

The wire lane (docs/EXTPROC.md) receives RAW gRPC message bytes — the
Process handler installs an identity request_deserializer (service.py)
— and admission must learn three things without materializing a
protobuf: which oneof arm the frame carries, whether it ends the
stream, and where the payload bytes live (the serialized HeaderMap for
header frames, the body chunk for body frames). :func:`classify` is
that one call.

Loading follows the fieldscan pattern: native when built
(``make -C native``), per-thread output buffers, and a pure-Python
walker (:func:`walk_py`) with bit-identical verdicts when the library
is absent — parity between the two is pinned by the mutation fuzz in
tests/test_extproc_wirelane.py. Both return the pbwalk verdict
contract (pbwalk.cc header): INVALID (-1) for bytes FromString would
reject, FALLBACK (-2) for frames the wire lane must not slice
(duplicate oneof arms, metadata_context, trailers), else the packed
kind/eos/payload verdict.

Every wire-path protobuf materialization funnels through
:func:`materialize` — one counted site, so the zero-materialization
acceptance test pins "0 ProcessingRequest objects on the fast lane"
by reading :data:`MATERIALIZED` instead of trusting code review.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

from gie_tpu_torch.extproc import pb

INVALID = -1
FALLBACK = -2

# Packed-verdict layout (pbwalk.cc): oneof arm field number in bits 0-2.
KIND_NONE = 0
KIND_REQUEST_HEADERS = 2
KIND_REQUEST_BODY = 3
KIND_RESPONSE_HEADERS = 5
KIND_RESPONSE_BODY = 6
EOS_BIT = 0x08
PAYLOAD_BIT = 0x10

# Wire-path FromString count (the zero-materialization pin). A plain int
# bumped under the GIL: a test-visible tally, not a metric.
MATERIALIZED = 0


def materialize(data: bytes) -> pb.ProcessingRequest:
    """The wire lane's ONLY door back to protobuf objects: FALLBACK and
    INVALID verdicts come here, and nowhere else on the wire path calls
    FromString — tests/test_extproc_wirelane.py counts this."""
    global MATERIALIZED
    MATERIALIZED += 1
    return pb.ProcessingRequest.FromString(data)


def _load_native():
    from gie_tpu_torch.utils.nativelib import native_lib_path

    path = native_lib_path("giepbwalk")
    try:
        lib = ctypes.CDLL(path)
        fn = lib.gie_pbwalk
    except (OSError, AttributeError):
        return None
    fn.argtypes = [
        ctypes.c_char_p, ctypes.c_long,   # frame bytes, n
        ctypes.c_void_p, ctypes.c_void_p,  # out payload off / len
    ]
    fn.restype = ctypes.c_long
    return fn


_NATIVE = _load_native()


def available() -> bool:
    return _NATIVE is not None


# Per-thread reusable out-params (fieldscan pattern): one classify per
# frame across the gRPC worker threads; the raw addresses ride with the
# objects so the hot call passes plain ints.
_BUFFERS = threading.local()


def _out_buffers():
    buf = getattr(_BUFFERS, "out", None)
    if buf is None:
        off = ctypes.c_long()
        length = ctypes.c_long()
        buf = (off, length, ctypes.addressof(off), ctypes.addressof(length))
        _BUFFERS.out = buf
    return buf


def walk_native(data: bytes) -> Optional[tuple[int, int, int]]:
    """(verdict, payload_off, payload_len) from the native walker, or
    None when the library is absent."""
    if _NATIVE is None:
        return None
    off, length, off_p, len_p = _out_buffers()
    rc = _NATIVE(data, len(data), off_p, len_p)
    return rc, off.value, length.value


# --------------------------------------------------------------------------
# Pure-Python reference walker — the no-library fallback and the parity
# oracle the fuzz suite holds pbwalk.cc to. Mirrors the C walk branch for
# branch; see pbwalk.cc for the WHY of each verdict.
# --------------------------------------------------------------------------


def _rd_varint(data: bytes, i: int, n: int) -> Optional[tuple[int, int]]:
    v = 0
    shift = 0
    while i < n and shift < 64:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            # Mask to 64 bits: the native walker's unsigned long long
            # drops higher bits of a 10-byte varint, and verdict parity
            # is bit-for-bit.
            return v & 0xFFFFFFFFFFFFFFFF, i
        shift += 7
    return None


def _skip_field(data: bytes, i: int, n: int, wire: int) -> int:
    """New offset past one field of the given wire type, or a negative
    verdict: INVALID for truncation / nonexistent wire types (6/7),
    FALLBACK for the group wire types (3/4) — upb skips a well-formed
    unknown group even in proto3, so FromString judges those frames."""
    if wire == 0:
        r = _rd_varint(data, i, n)
        return INVALID if r is None else r[1]
    if wire == 1:
        return i + 8 if n - i >= 8 else INVALID
    if wire == 2:
        r = _rd_varint(data, i, n)
        if r is None:
            return INVALID
        length, i = r
        return i + length if length <= n - i else INVALID
    if wire == 5:
        return i + 4 if n - i >= 4 else INVALID
    if wire in (3, 4):
        return FALLBACK
    return INVALID  # wire types 6/7 do not exist


def _utf8_valid(data: bytes) -> bool:
    try:
        data.decode("utf-8", "strict")  # CPython is upb-strict: no
    except UnicodeDecodeError:          # overlongs, no surrogates
        return False
    return True


def _walk_header_map(data: bytes, i: int, end: int) -> int:
    while i < end:
        r = _rd_varint(data, i, end)
        if r is None:
            return INVALID
        tag, i = r
        field, wire = tag >> 3, tag & 7
        if not 0 < field <= 0x1FFFFFFF:
            return INVALID
        if field == 1 and wire == 2:
            r = _rd_varint(data, i, end)
            if r is None:
                return INVALID
            hv_len, i = r
            if hv_len > end - i:
                return INVALID
            hv_end = i + hv_len
            while i < hv_end:
                r = _rd_varint(data, i, hv_end)
                if r is None:
                    return INVALID
                t2, i = r
                f2, w2 = t2 >> 3, t2 & 7
                if not 0 < f2 <= 0x1FFFFFFF:
                    return INVALID
                if f2 in (1, 2) and w2 == 2:
                    r = _rd_varint(data, i, hv_end)
                    if r is None:
                        return INVALID
                    sl, i = r
                    if sl > hv_end - i:
                        return INVALID
                    if not _utf8_valid(data[i:i + sl]):
                        return INVALID
                    i += sl
                else:
                    i = _skip_field(data, i, hv_end, w2)
                    if i < 0:
                        return i
        else:
            i = _skip_field(data, i, end, wire)
            if i < 0:
                return i
    return 0 if i == end else INVALID


def walk_py(data: bytes) -> tuple[int, int, int]:
    """(verdict, payload_off, payload_len): the reference walk."""
    n = len(data)
    i = 0
    kind = 0
    arm_off = -1
    arm_len = 0
    while i < n:
        r = _rd_varint(data, i, n)
        if r is None:
            return INVALID, 0, 0
        tag, i = r
        field, wire = tag >> 3, tag & 7
        if not 0 < field <= 0x1FFFFFFF:
            return INVALID, 0, 0
        if 2 <= field <= 7 and wire == 2:
            if kind:
                return FALLBACK, 0, 0  # second arm: merge/last-wins
            r = _rd_varint(data, i, n)
            if r is None:
                return INVALID, 0, 0
            alen, i = r
            if alen > n - i:
                return INVALID, 0, 0
            kind, arm_off, arm_len = field, i, alen
            i += alen
        elif field == 8 and wire == 2:
            return FALLBACK, 0, 0  # metadata_context: Struct walk
        elif field == 1:
            return FALLBACK, 0, 0  # reserved field in use
        else:
            i = _skip_field(data, i, n, wire)
            if i < 0:
                return i, 0, 0
    if kind == 0:
        return 0, 0, 0
    if kind in (4, 7):
        return FALLBACK, 0, 0  # trailers: FromString stays the judge

    verdict = kind
    out_off = out_len = 0
    end = arm_off + arm_len
    i = arm_off
    if kind in (KIND_REQUEST_HEADERS, KIND_RESPONSE_HEADERS):
        have_map = False
        while i < end:
            r = _rd_varint(data, i, end)
            if r is None:
                return INVALID, 0, 0
            tag, i = r
            field, wire = tag >> 3, tag & 7
            if not 0 < field <= 0x1FFFFFFF:
                return INVALID, 0, 0
            if field == 1 and wire == 2:
                if have_map:
                    return FALLBACK, 0, 0  # submessage merge semantics
                r = _rd_varint(data, i, end)
                if r is None:
                    return INVALID, 0, 0
                mlen, i = r
                if mlen > end - i:
                    return INVALID, 0, 0
                rc = _walk_header_map(data, i, i + mlen)
                if rc < 0:
                    return rc, 0, 0
                have_map = True
                out_off, out_len = i, mlen
                verdict |= PAYLOAD_BIT
                i += mlen
            elif field == 3 and wire == 0:
                r = _rd_varint(data, i, end)
                if r is None:
                    return INVALID, 0, 0
                eos, i = r
                verdict = verdict | EOS_BIT if eos else verdict & ~EOS_BIT
            else:
                i = _skip_field(data, i, end, wire)
                if i < 0:
                    return i, 0, 0
    else:
        while i < end:
            r = _rd_varint(data, i, end)
            if r is None:
                return INVALID, 0, 0
            tag, i = r
            field, wire = tag >> 3, tag & 7
            if not 0 < field <= 0x1FFFFFFF:
                return INVALID, 0, 0
            if field == 1 and wire == 2:
                r = _rd_varint(data, i, end)
                if r is None:
                    return INVALID, 0, 0
                blen, i = r
                if blen > end - i:
                    return INVALID, 0, 0
                out_off, out_len = i, blen  # scalar bytes: last wins
                verdict |= PAYLOAD_BIT
                i += blen
            elif field == 2 and wire == 0:
                r = _rd_varint(data, i, end)
                if r is None:
                    return INVALID, 0, 0
                eos, i = r
                verdict = verdict | EOS_BIT if eos else verdict & ~EOS_BIT
            else:
                i = _skip_field(data, i, end, wire)
                if i < 0:
                    return i, 0, 0
    return verdict, out_off, out_len


def walk(data: bytes) -> tuple[int, int, int]:
    """(verdict, payload_off, payload_len): native when built, else the
    reference walk. Verdicts are bit-identical either way (pinned)."""
    r = walk_native(data)
    if r is None:
        return walk_py(data)
    return r


def scan_header_map_py(
    header_map_bytes: bytes, needed: frozenset
) -> list[tuple[str, str]]:
    """Needed-keys extraction from a CLASSIFIED HeaderMap slice, pure
    Python: [(key, value)] in wire order, raw_value winning over value
    when non-empty — the gie_headers_scan semantics, for the no-library
    wire lane. Caller guarantees the bytes already passed the walk, so
    this never raises on structure."""
    out: list[tuple[str, str]] = []
    n = len(header_map_bytes)
    data = header_map_bytes
    i = 0
    while i < n:
        r = _rd_varint(data, i, n)
        if r is None:
            return out
        tag, i = r
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            r = _rd_varint(data, i, n)
            if r is None:
                return out
            hv_len, i = r
            hv_end = i + hv_len
            key = value = ""
            raw = b""
            while i < hv_end:
                r = _rd_varint(data, i, hv_end)
                if r is None:
                    return out
                t2, i = r
                f2, w2 = t2 >> 3, t2 & 7
                if f2 in (1, 2, 3) and w2 == 2:
                    r = _rd_varint(data, i, hv_end)
                    if r is None:
                        return out
                    sl, i = r
                    chunk = data[i:i + sl]
                    i += sl
                    if f2 == 1:
                        key = chunk.decode("utf-8", "replace")
                    elif f2 == 2:
                        value = chunk.decode("utf-8", "replace")
                    else:
                        raw = chunk
                else:
                    i = _skip_field(data, i, hv_end, w2)
                    if i < 0:
                        return out
            if key in needed:
                out.append(
                    (key, raw.decode("utf-8", "replace") if raw else value)
                )
        else:
            i = _skip_field(data, i, n, wire)
            if i < 0:
                return out
    return out
