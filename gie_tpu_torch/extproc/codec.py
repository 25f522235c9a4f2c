"""Codec layer: HTTP/JSON <-> gRPC transcoding + SSE conversion.

Implements the EPP-side transcoding of the gRPC-support proposal (reference
docs/proposals/2162-grpc-support/README.md:46-66): when a pool's appProtocol
is `kubernetes.io/h2c` (gRPC model servers) but the client speaks the OpenAI
HTTP/JSON API, the EPP

  request path:  OpenAI completion JSON -> gRPC-framed GenerateRequest
                 (5-byte frame: compressed flag + u32 big-endian length)
  response path: gRPC-framed GenerateResponse stream -> OpenAI JSON
                 (non-streaming) or Server-Sent Events (streaming)

Protocol detection (proposal's preferred method): the pool spec drives the
decision; gRPC-in clients are recognized by `content-type: application/grpc`
and passed through unframed.
"""

from __future__ import annotations

import json
import struct
from typing import Iterator, Optional

from gie_tpu_torch.extproc.pb import generate_pb2

GRPC_CONTENT_TYPE = "application/grpc"


# ---------------------------------------------------------------------------
# gRPC wire framing (length-prefixed messages)
# ---------------------------------------------------------------------------


def frame(message: bytes) -> bytes:
    """One uncompressed gRPC data frame."""
    return b"\x00" + struct.pack(">I", len(message)) + message


def iter_frames(data: bytes) -> Iterator[bytes]:
    """Yield complete message payloads from concatenated frames."""
    offset = 0
    while offset + 5 <= len(data):
        compressed = data[offset]
        (length,) = struct.unpack(">I", data[offset + 1 : offset + 5])
        if compressed not in (0, 1) or offset + 5 + length > len(data):
            return
        yield data[offset + 5 : offset + 5 + length]
        offset += 5 + length


class FrameFormatError(ValueError):
    """Response bytes are not the uncompressed gRPC framing we can decode."""


class FrameDecoder:
    """Incremental frame decoder for streamed response bodies.

    Raises FrameFormatError on a compressed frame (flag 1 — we negotiate no
    grpc-encoding, so this means a server we cannot decode) or a corrupt
    flag byte, so callers can fall back to passthrough instead of feeding
    garbage to the protobuf parser.
    """

    def __init__(self) -> None:
        self._buf = bytearray()

    def buffered_bytes(self) -> int:
        return len(self._buf)

    def has_partial(self) -> bool:
        """True when an incomplete frame remains (truncated stream)."""
        return len(self._buf) > 0

    def feed(self, chunk: bytes) -> list[bytes]:
        self._buf.extend(chunk)
        out = []
        while len(self._buf) >= 5:
            flag = self._buf[0]
            if flag not in (0, 1):
                raise FrameFormatError(f"bad gRPC frame flag {flag}")
            if flag == 1:
                raise FrameFormatError("compressed gRPC frame unsupported")
            (length,) = struct.unpack(">I", bytes(self._buf[1:5]))
            if len(self._buf) < 5 + length:
                break
            out.append(bytes(self._buf[5 : 5 + length]))
            del self._buf[: 5 + length]
        return out


# ---------------------------------------------------------------------------
# JSON <-> protobuf
# ---------------------------------------------------------------------------


def json_to_generate_request(
    body: bytes,
    parsed: Optional[dict] = None,
) -> tuple[Optional[bytes], bool, str]:
    """OpenAI completion JSON -> (gRPC-framed GenerateRequest, stream flag,
    model name).

    ``parsed`` is the at-most-once-parse handoff (1964 shared-parse rule
    extended to transcoding): when the caller already parsed these exact
    bytes — the BBR chain's shared parse, or server._pick_inner's hint
    parse — passing the dict here skips the second ``json.loads`` the
    transcoding path used to pay per request. Callers must only pass a
    dict that came from ``body`` itself; None means "parse here" (which
    on the zero-parse fast lane is the request's first and only parse).

    Returns (None, False, "") when the body is not a transcodable completion
    request — malformed JSON, missing prompt, or field values the proto
    cannot carry (e.g. negative max_tokens) — so callers pass the body
    through untouched instead of killing the stream.
    """
    if parsed is not None:
        obj = parsed
    else:
        try:
            obj = json.loads(body)
        except (ValueError, UnicodeDecodeError):
            return None, False, ""
    if not isinstance(obj, dict):
        return None, False, ""
    prompt = obj.get("prompt")
    if prompt is None and isinstance(obj.get("messages"), list):
        # Chat form: fold messages into a prompt transcript. Content may be
        # a plain string or OpenAI content-parts ([{type: text, text: ...}]).
        lines = []
        for m in obj["messages"]:
            if not isinstance(m, dict):
                continue
            content = m.get("content")
            if isinstance(content, list):
                content = "".join(
                    part["text"]
                    for part in content
                    if isinstance(part, dict)
                    and part.get("type") == "text"
                    and isinstance(part.get("text"), str)
                )
            elif not isinstance(content, str):
                content = ""
            lines.append(f"{m.get('role', 'user')}: {content}")
        prompt = "\n".join(lines)
    if not isinstance(prompt, str):
        return None, False, ""
    stream = bool(obj.get("stream", False))
    model = str(obj.get("model", ""))
    try:
        req = generate_pb2.GenerateRequest(
            model=model,
            prompt=prompt,
            max_tokens=int(obj.get("max_tokens", 16) or 16),
            temperature=float(obj.get("temperature", 1.0) or 1.0),
            stream=stream,
        )
    except (ValueError, TypeError):
        return None, False, ""
    return frame(req.SerializeToString()), stream, model


def _completion_json(resp, model: str = "") -> dict:
    return {
        "object": "text_completion",
        "model": model,
        "choices": [
            {
                "index": 0,
                "text": resp.text,
                "finish_reason": resp.finish_reason or None,
            }
        ],
        "usage": {
            "prompt_tokens": resp.prompt_tokens,
            "completion_tokens": resp.completion_tokens,
        },
    }


def generate_payloads_to_json(payloads: list[bytes], model: str = "") -> bytes:
    """Decoded GenerateResponse payloads -> one OpenAI completion JSON
    (non-streaming path: chunks concatenate)."""
    text = []
    last = generate_pb2.GenerateResponse()
    for payload in payloads:
        resp = generate_pb2.GenerateResponse.FromString(payload)
        text.append(resp.text)
        last = resp
    merged = generate_pb2.GenerateResponse(
        text="".join(text),
        finished=last.finished,
        finish_reason=last.finish_reason,
        prompt_tokens=last.prompt_tokens,
        completion_tokens=last.completion_tokens,
    )
    return json.dumps(_completion_json(merged, model)).encode()


def generate_responses_to_json(framed: bytes, model: str = "") -> bytes:
    """Concatenated frames variant of generate_payloads_to_json."""
    return generate_payloads_to_json(list(iter_frames(framed)), model)


def generate_response_to_sse(payload: bytes, model: str = "") -> bytes:
    """One GenerateResponse message -> one SSE event; the finished message
    additionally emits the OpenAI [DONE] terminator."""
    resp = generate_pb2.GenerateResponse.FromString(payload)
    event = b"data: " + json.dumps(_completion_json(resp, model)).encode() + b"\n\n"
    if resp.finished:
        event += b"data: [DONE]\n\n"
    return event


def error_json(message: str) -> bytes:
    """OpenAI-style error body for transcode failures."""
    return json.dumps(
        {"error": {"message": message, "type": "upstream_error"}}
    ).encode()


def error_sse(message: str) -> bytes:
    """SSE error event followed by the [DONE] terminator, so streaming
    clients close cleanly instead of receiving raw gRPC bytes."""
    return (
        b"data: " + error_json(message) + b"\n\ndata: [DONE]\n\n"
    )


def is_grpc_request(headers: dict[str, list[str]]) -> bool:
    """gRPC-in detection (content-type application/grpc)."""
    for value in headers.get("content-type", []):
        if value.startswith(GRPC_CONTENT_TYPE):
            return True
    return False
