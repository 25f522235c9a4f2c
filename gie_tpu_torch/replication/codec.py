"""Digest wire format: numpy-native, length-prefixed, CRC-guarded frames
(copy of gie_tpu/replication/codec.py; its bytes equal the reference's).

The replication digest is a snapshot of the EPP's soft state as named
SECTIONS ("sched", "predictor", "autoscale", ...), each a flat dict of
named numpy arrays. The codec's failure contract is the load-bearing
property: a follower feeds it bytes from the network, and ANY corruption —
truncation, bit flips, absurd lengths, unknown versions — must come back
as ``None`` (keep prior state), never as an exception into the sync loop.

Layout (all integers little-endian):

  header   MAGIC "GIER" | version u16 | flags u16 | epoch u64 |
           base_epoch u64 | nsections u32 | header_crc32 u32
           (header_crc32 covers every preceding header byte, so a bit
           flip in the epoch/flags fields is caught, not installed)
  section  name_len u16 | payload_len u32 | crc32 u32 | name utf-8 |
           payload   (crc32 covers name + payload: a flipped NAME must
           reject, not silently become an unknown — skipped — section)
  payload  repeated arrays:
           key_len u16 | key utf-8 | dtype_len u8 | dtype-str | ndim u8 |
           dims u32 * ndim | raw bytes (C order)

Forward compatibility is skip-unknown at the SEMANTIC layer, not here:
sections and array keys a given build does not understand decode fine and
are simply ignored by the installers (manager.py), so a newer leader can
ship new state to an older follower without breaking the sync. The version
field guards the FRAMING only — a version bump means this very layout
changed and the digest is rejected whole.

``flags`` bit 0 marks a DELTA digest: it carries only the sections whose
state changed after ``base_epoch``, and is only installable on a follower
whose installed epoch equals ``base_epoch`` (otherwise it re-fetches a full
snapshot). Unknown flag bits reject — they would change semantics this
decoder cannot honor.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

MAGIC = b"GIER"
VERSION = 1
FLAG_DELTA = 0x1
_KNOWN_FLAGS = FLAG_DELTA

_HEADER = struct.Struct("<4sHHQQI")   # magic, version, flags, epoch, base, n
_HEADER_CRC = struct.Struct("<I")     # crc32 of the _HEADER bytes
_SECTION = struct.Struct("<HII")      # name_len, payload_len, crc32
_ARRAY = struct.Struct("<HBB")        # key_len, dtype_len, ndim

# Hard bounds: a corrupt length field must fail fast, not allocate.
MAX_SECTIONS = 64
MAX_ARRAYS_PER_SECTION = 4096
MAX_NAME_BYTES = 256
MAX_NDIM = 8
MAX_PAYLOAD_BYTES = 1 << 30

# Only plain numeric buffers ride the wire (bool/int/uint/float/complex);
# object/str dtypes could smuggle pickle-adjacent payloads.
_DTYPE_KINDS = frozenset("biufc")


@dataclasses.dataclass(frozen=True)
class Digest:
    """Decoded digest: epoch + named sections of named arrays."""

    epoch: int
    base_epoch: int
    delta: bool
    sections: dict  # name -> {key -> np.ndarray}


def _encode_array(key: str, arr: np.ndarray) -> bytes:
    a = np.asarray(arr)
    if not a.flags.c_contiguous:
        # NB: ascontiguousarray alone would promote 0-d scalars to 1-d
        # (shape round-trip breakage); 0-d is always contiguous, so the
        # reshape below only ever applies to ndim >= 1.
        a = np.ascontiguousarray(a).reshape(a.shape)
    if a.dtype.kind not in _DTYPE_KINDS:
        raise ValueError(f"array {key!r}: dtype {a.dtype} not replicable")
    kb = key.encode("utf-8")
    db = a.dtype.str.encode("ascii")
    if len(kb) > MAX_NAME_BYTES or a.ndim > MAX_NDIM:
        raise ValueError(f"array {key!r}: name/ndim out of bounds")
    return b"".join((
        _ARRAY.pack(len(kb), len(db), a.ndim),
        kb,
        db,
        struct.pack(f"<{a.ndim}I", *a.shape),
        a.tobytes(),
    ))


def encode_section(arrays: dict) -> bytes:
    """Serialize one section's arrays to its payload bytes (the unit the
    publisher fingerprints for change detection)."""
    if len(arrays) > MAX_ARRAYS_PER_SECTION:
        raise ValueError("too many arrays in section")
    return b"".join(
        _encode_array(k, np.asarray(v)) for k, v in arrays.items())


def build_digest(
    epoch: int,
    payloads: dict,
    *,
    delta: bool = False,
    base_epoch: int = 0,
) -> bytes:
    """Assemble a digest from pre-encoded section payloads (name -> bytes).
    The publisher caches payloads per section and reuses them across full
    and delta digests, so encoding cost is paid once per state change."""
    if len(payloads) > MAX_SECTIONS:
        raise ValueError("too many sections")
    header = _HEADER.pack(
        MAGIC, VERSION, FLAG_DELTA if delta else 0,
        int(epoch), int(base_epoch), len(payloads))
    parts = [header, _HEADER_CRC.pack(zlib.crc32(header) & 0xFFFFFFFF)]
    for name, payload in payloads.items():
        nb = name.encode("utf-8")
        if len(nb) > MAX_NAME_BYTES or len(payload) > MAX_PAYLOAD_BYTES:
            raise ValueError(f"section {name!r} out of bounds")
        parts.append(_SECTION.pack(
            len(nb), len(payload), zlib.crc32(nb + payload) & 0xFFFFFFFF))
        parts.append(nb)
        parts.append(payload)
    return b"".join(parts)


def encode_digest(
    epoch: int,
    sections: dict,
    *,
    delta: bool = False,
    base_epoch: int = 0,
) -> bytes:
    """Convenience: encode sections of arrays straight to a digest blob."""
    return build_digest(
        epoch,
        {name: encode_section(arrays) for name, arrays in sections.items()},
        delta=delta,
        base_epoch=base_epoch,
    )


def _decode_payload(payload: bytes) -> dict:
    """Payload bytes -> {key: array}. Raises on any inconsistency (the
    caller converts to a whole-digest rejection)."""
    out: dict = {}
    off = 0
    while off < len(payload):
        if len(out) >= MAX_ARRAYS_PER_SECTION:
            raise ValueError("too many arrays")
        klen, dlen, ndim = _ARRAY.unpack_from(payload, off)
        off += _ARRAY.size
        if klen > MAX_NAME_BYTES or ndim > MAX_NDIM:
            raise ValueError("array header out of bounds")
        key = payload[off:off + klen].decode("utf-8")
        if len(payload[off:off + klen]) != klen:
            raise ValueError("truncated key")
        off += klen
        dtype_str = payload[off:off + dlen].decode("ascii")
        if len(dtype_str) != dlen:
            raise ValueError("truncated dtype")
        off += dlen
        dtype = np.dtype(dtype_str)
        if dtype.kind not in _DTYPE_KINDS:
            raise ValueError(f"dtype {dtype} not replicable")
        shape = struct.unpack_from(f"<{ndim}I", payload, off)
        off += 4 * ndim
        count = 1
        for d in shape:
            count *= d
        nbytes = count * dtype.itemsize
        if nbytes > MAX_PAYLOAD_BYTES or off + nbytes > len(payload):
            raise ValueError("array data out of bounds")
        if key in out:
            raise ValueError(f"duplicate array key {key!r}")
        out[key] = np.frombuffer(
            payload[off:off + nbytes], dtype=dtype).reshape(shape).copy()
        off += nbytes
    if off != len(payload):
        raise ValueError("trailing bytes in section payload")
    return out


def decode_digest(blob: bytes):
    """bytes -> Digest, or None on ANY malformation. Never raises: the
    follower loop calls this on network bytes, and a corrupt digest must
    mean "keep prior state", not a crashed sync thread."""
    try:
        magic, version, flags, epoch, base_epoch, nsections = (
            _HEADER.unpack_from(blob, 0))
        if magic != MAGIC or version != VERSION:
            return None
        (header_crc,) = _HEADER_CRC.unpack_from(blob, _HEADER.size)
        if zlib.crc32(blob[:_HEADER.size]) & 0xFFFFFFFF != header_crc:
            return None  # flipped epoch/flags/count field
        if flags & ~_KNOWN_FLAGS:
            return None
        if nsections > MAX_SECTIONS:
            return None
        sections: dict = {}
        off = _HEADER.size + _HEADER_CRC.size
        for _ in range(nsections):
            nlen, plen, crc = _SECTION.unpack_from(blob, off)
            off += _SECTION.size
            if nlen > MAX_NAME_BYTES or plen > MAX_PAYLOAD_BYTES:
                return None
            name_bytes = blob[off:off + nlen]
            if len(name_bytes) != nlen:
                return None
            name = name_bytes.decode("utf-8")
            off += nlen
            payload = blob[off:off + plen]
            if len(payload) != plen:
                return None  # truncated frame
            off += plen
            if zlib.crc32(name_bytes + payload) & 0xFFFFFFFF != crc:
                return None  # bit flip / corruption (name or payload)
            if name in sections:
                return None
            sections[name] = _decode_payload(payload)
        if off != len(blob):
            return None  # trailing junk
        return Digest(
            epoch=int(epoch),
            base_epoch=int(base_epoch),
            delta=bool(flags & FLAG_DELTA),
            sections=sections,
        )
    except Exception:
        return None
