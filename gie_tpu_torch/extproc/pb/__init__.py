"""Generated protobuf modules — wire-exact `envoy.service.ext_proc.v3`.

Regenerated by proto/regen.sh from the protos under ../proto. The flat
names re-exported here are the surface the framework uses; golden-bytes
wire tests (tests/test_extproc_wire.py) pin the field numbers against
Envoy's published protocol so a regeneration that drifts fails loudly.
"""

from gie_tpu_torch.extproc.pb.envoy.config.core.v3.base_pb2 import (  # noqa: E402
    HeaderMap,
    HeaderValue,
    HeaderValueOption,
    Metadata,
)
from gie_tpu_torch.extproc.pb.envoy.type.v3.http_status_pb2 import (  # noqa: E402
    HttpStatus,
    StatusCode,
)
from gie_tpu_torch.extproc.pb.envoy.service.ext_proc.v3.external_processor_pb2 import (  # noqa: E402
    BodyMutation,
    BodyResponse,
    CommonResponse,
    GrpcStatus,
    HeaderMutation,
    HeadersResponse,
    HttpBody,
    HttpHeaders,
    HttpTrailers,
    ImmediateResponse,
    ProcessingRequest,
    ProcessingResponse,
    TrailersResponse,
)

__all__ = [
    "BodyMutation",
    "BodyResponse",
    "CommonResponse",
    "GrpcStatus",
    "HeaderMap",
    "HeaderMutation",
    "HeaderValue",
    "HeaderValueOption",
    "HeadersResponse",
    "HttpBody",
    "HttpHeaders",
    "HttpStatus",
    "HttpTrailers",
    "ImmediateResponse",
    "Metadata",
    "ProcessingRequest",
    "ProcessingResponse",
    "StatusCode",
    "TrailersResponse",
]
