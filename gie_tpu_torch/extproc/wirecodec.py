"""Serialized-ProcessingResponse builder for the wire lane.

The fast lane's template pool (server._HeadersTemplatePool) already
reduced the headers response to one MergeFromString + value patches —
but the wire lane sends RAW bytes through an identity
response_serializer (service.py), so even that revived message is pure
overhead. This module assembles the response bottom-up from cached
per-keyset byte fragments: varint length prefixes computed over small
concatenations, zero protobuf objects.

Byte identity with the template pool (and through it with the legacy
built-from-scratch path) is the contract, pinned across the
parity matrix by tests/test_extproc_wirelane.py. That works because
upb serializes fields in field-number order and the mutation keys are
sorted on both sides; the presence rules differ per field and are
spelled out inline (HeaderValue.raw_value is a plain proto3 bytes
field — omitted when empty — while Value.string_value sits in the
`kind` oneof and serializes even empty).

Field numbers (pinned by tests/test_extproc_wire.py):
  ProcessingResponse: request_headers=1, dynamic_metadata=8
  HeadersResponse.response=1; CommonResponse: header_mutation=2,
  clear_route_cache=5; HeaderMutation.set_headers=1;
  HeaderValueOption.header=1; HeaderValue: key=1, raw_value=3
  Struct.fields=1 (map entry: key=1, value=2); Value: string_value=3,
  struct_value=5
"""

from __future__ import annotations

from gie_tpu_torch.extproc import metadata


def _varint(n: int) -> bytes:
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    """One length-delimited field: tag, length, payload."""
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


# CommonResponse.clear_route_cache=true — constant tail after the
# header mutation (field 5 > field 2 in upb's ordering).
_CLEAR_ROUTE_CACHE = bytes([5 << 3 | 0, 1])

_DEST_NS = metadata.DESTINATION_ENDPOINT_NAMESPACE.encode()
_DEST_KEY = metadata.DESTINATION_ENDPOINT_KEY.encode()

# Per-keyset fragment cache (same bound + GIL-atomic insert rationale as
# the template pool: keys come from pick-result extra_headers, and an
# adversarial plugin must not grow an unbounded dict).
_KEY_FRAGMENTS: dict[tuple[str, ...], list[bytes]] = {}
_LIMIT = 64

# Whole-response memo. Every input is drawn from a bounded set in steady
# state — destination endpoints from the pod roster, mutation values
# from model rewrites / steering verdicts — so the SAME serialized
# response recurs every few requests and the build below (21 varint
# concatenations) is repeated work. Bounded like the fragment cache: a
# plugin minting per-request-unique header values fills the dict once
# and then takes the build path, it cannot grow memory.
_RESPONSES: dict[tuple, bytes] = {}
_RESPONSES_LIMIT = 512


def headers_response_bytes(set_headers: dict[str, str], endpoint: str) -> bytes:
    """Serialized ProcessingResponse carrying the destination header
    mutation + the envoy.lb dynamic-metadata pyramid, byte-identical to
    server._headers_response's message on the same inputs."""
    items = tuple(sorted(set_headers.items()))
    memo_key = (endpoint, items)
    cached = _RESPONSES.get(memo_key)
    if cached is not None:
        return cached
    keys = tuple(k for k, _ in items)
    frags = _KEY_FRAGMENTS.get(keys)
    if frags is None:
        # HeaderValue.key fragment per key — the only per-keyset part.
        frags = [_ld(1, k.encode()) for k in keys]
        if len(_KEY_FRAGMENTS) < _LIMIT:
            _KEY_FRAGMENTS[keys] = frags
    opts = bytearray()
    for key_frag, (_, value) in zip(frags, items):
        raw = value.encode()
        # raw_value is plain proto3 bytes: empty means absent on the
        # wire (the template pool's skeleton patches the same field).
        hv = key_frag + _ld(3, raw) if raw else key_frag
        opts += _ld(1, _ld(1, hv))  # set_headers <- HeaderValueOption.header
    common = _ld(2, bytes(opts)) + _CLEAR_ROUTE_CACHE
    request_headers = _ld(1, _ld(1, common))

    ep = endpoint.encode()
    # Value.string_value lives in the `kind` oneof: presence is explicit,
    # so an empty endpoint still serializes as a zero-length field 3.
    inner_entry = _ld(1, _DEST_KEY) + _ld(2, _ld(3, ep))
    outer_value = _ld(5, _ld(1, inner_entry))  # struct_value wrapping
    outer_entry = _ld(1, _DEST_NS) + _ld(2, outer_value)
    dynamic_metadata = _ld(8, _ld(1, outer_entry))
    out = request_headers + dynamic_metadata
    if len(_RESPONSES) < _RESPONSES_LIMIT:
        _RESPONSES[memo_key] = out
    return out
