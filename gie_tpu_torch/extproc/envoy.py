"""ext-proc wire-format helpers (reference pkg/common/envoy/*.go).

Header get/extract/mutate (headers.go:27-60), filter-metadata extraction
(metadata.go:24-31), and 62 KB chunked body mutations (chunking.go:26-74 —
Envoy caps gRPC messages at 64 KB; 62 000 bytes leaves margin for framing).
"""

from __future__ import annotations

from typing import Optional

from google.protobuf import struct_pb2

from gie_tpu_torch.extproc import pb

# reference chunking.go:24-26
BODY_BYTE_LIMIT = 62_000


def get_header_value(header: pb.HeaderValue) -> str:
    """raw_value (bytes, field 3) wins over the string value (field 2);
    Envoy populates exactly one (reference headers.go:27-33)."""
    if header.raw_value:
        return header.raw_value.decode("utf-8", "replace")
    return header.value


def make_immediate_response(
    status_code: int, *, details: str = "", body: bytes = b""
) -> pb.ImmediateResponse:
    """ImmediateResponse with the wire-correct envoy.type.v3.HttpStatus
    message (NOT a bare integer) — the 429-shed / 503 contract of the
    endpoint-picker protocol (004 README:77-80)."""
    return pb.ImmediateResponse(
        status=pb.HttpStatus(code=status_code), details=details, body=body
    )


def extract_header_value(headers: pb.HttpHeaders, key: str) -> Optional[str]:
    """Case-insensitive single-header lookup (reference headers.go:36-46)."""
    want = key.lower()
    for h in headers.headers.headers:
        if h.key.lower() == want:
            return get_header_value(h)
    return None


def generate_headers_mutation(
    set_headers: dict[str, str], remove: Optional[list[str]] = None
) -> pb.HeaderMutation:
    """Build a deterministic HeaderMutation (reference headers.go:49-60)."""
    mut = pb.HeaderMutation()
    for k in sorted(set_headers):
        mut.set_headers.append(
            pb.HeaderValueOption(
                header=pb.HeaderValue(key=k, raw_value=set_headers[k].encode())
            )
        )
    for k in remove or []:
        mut.remove_headers.append(k)
    return mut


def _struct_to_py(value: struct_pb2.Value):
    kind = value.WhichOneof("kind")
    if kind == "struct_value":
        return {k: _struct_to_py(v) for k, v in value.struct_value.fields.items()}
    if kind == "list_value":
        return [_struct_to_py(v) for v in value.list_value.values]
    if kind == "string_value":
        return value.string_value
    if kind == "number_value":
        return value.number_value
    if kind == "bool_value":
        return value.bool_value
    return None


def extract_metadata_values(req: pb.ProcessingRequest) -> dict:
    """filter_metadata -> plain nested dict (reference metadata.go:24-31)."""
    out: dict = {}
    for name, st in req.metadata_context.filter_metadata.items():
        out[name] = {k: _struct_to_py(v) for k, v in st.fields.items()}
    return out


def make_dynamic_metadata(namespace: str, fields: dict[str, str]) -> struct_pb2.Struct:
    """envoy.lb-style nested dynamic-metadata struct (reference
    server.go:171-181)."""
    inner = struct_pb2.Struct()
    for k, v in fields.items():
        inner.fields[k].string_value = v
    outer = struct_pb2.Struct()
    outer.fields[namespace].struct_value.CopyFrom(inner)
    return outer


def build_chunked_body_responses(
    body: bytes, *, request_path: bool
) -> list[pb.ProcessingResponse]:
    """Split a mutated body into <= 62 KB CONTINUE_AND_REPLACE responses
    (reference chunking.go:31-74): first chunk carries the mutation status,
    every chunk carries its body slice, only the final response leaves
    streaming to continue."""
    chunks = [body[i : i + BODY_BYTE_LIMIT] for i in range(0, len(body), BODY_BYTE_LIMIT)]
    if not chunks:
        chunks = [b""]
    responses = []
    for chunk in chunks:
        common = pb.CommonResponse(
            status=pb.CommonResponse.CONTINUE_AND_REPLACE,
            body_mutation=pb.BodyMutation(body=chunk),
        )
        body_resp = pb.BodyResponse(response=common)
        if request_path:
            responses.append(pb.ProcessingResponse(request_body=body_resp))
        else:
            responses.append(pb.ProcessingResponse(response_body=body_resp))
    return responses
