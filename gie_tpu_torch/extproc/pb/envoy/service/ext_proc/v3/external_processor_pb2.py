# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: envoy/service/ext_proc/v3/external_processor.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from gie_tpu_torch.extproc.pb.envoy.config.core.v3 import base_pb2 as envoy_dot_config_dot_core_dot_v3_dot_base__pb2
from gie_tpu_torch.extproc.pb.envoy.type.v3 import http_status_pb2 as envoy_dot_type_dot_v3_dot_http__status__pb2
from google.protobuf import struct_pb2 as google_dot_protobuf_dot_struct__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n2envoy/service/ext_proc/v3/external_processor.proto\x12\x19\x65nvoy.service.ext_proc.v3\x1a\x1f\x65nvoy/config/core/v3/base.proto\x1a\x1f\x65nvoy/type/v3/http_status.proto\x1a\x1cgoogle/protobuf/struct.proto\"\xf7\x03\n\x11ProcessingRequest\x12\x41\n\x0frequest_headers\x18\x02 \x01(\x0b\x32&.envoy.service.ext_proc.v3.HttpHeadersH\x00\x12;\n\x0crequest_body\x18\x03 \x01(\x0b\x32#.envoy.service.ext_proc.v3.HttpBodyH\x00\x12\x43\n\x10request_trailers\x18\x04 \x01(\x0b\x32\'.envoy.service.ext_proc.v3.HttpTrailersH\x00\x12\x42\n\x10response_headers\x18\x05 \x01(\x0b\x32&.envoy.service.ext_proc.v3.HttpHeadersH\x00\x12<\n\rresponse_body\x18\x06 \x01(\x0b\x32#.envoy.service.ext_proc.v3.HttpBodyH\x00\x12\x44\n\x11response_trailers\x18\x07 \x01(\x0b\x32\'.envoy.service.ext_proc.v3.HttpTrailersH\x00\x12\x38\n\x10metadata_context\x18\x08 \x01(\x0b\x32\x1e.envoy.config.core.v3.MetadataB\t\n\x07requestJ\x04\x08\x01\x10\x02J\x04\x08\t\x10\nJ\x04\x08\n\x10\x0b\"\xd0\x04\n\x12ProcessingResponse\x12\x45\n\x0frequest_headers\x18\x01 \x01(\x0b\x32*.envoy.service.ext_proc.v3.HeadersResponseH\x00\x12?\n\x0crequest_body\x18\x02 \x01(\x0b\x32\'.envoy.service.ext_proc.v3.BodyResponseH\x00\x12G\n\x10request_trailers\x18\x03 \x01(\x0b\x32+.envoy.service.ext_proc.v3.TrailersResponseH\x00\x12\x46\n\x10response_headers\x18\x04 \x01(\x0b\x32*.envoy.service.ext_proc.v3.HeadersResponseH\x00\x12@\n\rresponse_body\x18\x05 \x01(\x0b\x32\'.envoy.service.ext_proc.v3.BodyResponseH\x00\x12H\n\x11response_trailers\x18\x06 \x01(\x0b\x32+.envoy.service.ext_proc.v3.TrailersResponseH\x00\x12J\n\x12immediate_response\x18\x07 \x01(\x0b\x32,.envoy.service.ext_proc.v3.ImmediateResponseH\x00\x12\x31\n\x10\x64ynamic_metadata\x18\x08 \x01(\x0b\x32\x17.google.protobuf.StructB\n\n\x08responseJ\x04\x08\t\x10\nJ\x04\x08\n\x10\x0b\"\\\n\x0bHttpHeaders\x12\x30\n\x07headers\x18\x01 \x01(\x0b\x32\x1f.envoy.config.core.v3.HeaderMap\x12\x15\n\rend_of_stream\x18\x03 \x01(\x08J\x04\x08\x02\x10\x03\"/\n\x08HttpBody\x12\x0c\n\x04\x62ody\x18\x01 \x01(\x0c\x12\x15\n\rend_of_stream\x18\x02 \x01(\x08\"A\n\x0cHttpTrailers\x12\x31\n\x08trailers\x18\x01 \x01(\x0b\x32\x1f.envoy.config.core.v3.HeaderMap\"N\n\x0fHeadersResponse\x12;\n\x08response\x18\x01 \x01(\x0b\x32).envoy.service.ext_proc.v3.CommonResponse\"K\n\x0c\x42odyResponse\x12;\n\x08response\x18\x01 \x01(\x0b\x32).envoy.service.ext_proc.v3.CommonResponse\"V\n\x10TrailersResponse\x12\x42\n\x0fheader_mutation\x18\x01 \x01(\x0b\x32).envoy.service.ext_proc.v3.HeaderMutation\"\xe6\x02\n\x0e\x43ommonResponse\x12H\n\x06status\x18\x01 \x01(\x0e\x32\x38.envoy.service.ext_proc.v3.CommonResponse.ResponseStatus\x12\x42\n\x0fheader_mutation\x18\x02 \x01(\x0b\x32).envoy.service.ext_proc.v3.HeaderMutation\x12>\n\rbody_mutation\x18\x03 \x01(\x0b\x32\'.envoy.service.ext_proc.v3.BodyMutation\x12\x31\n\x08trailers\x18\x04 \x01(\x0b\x32\x1f.envoy.config.core.v3.HeaderMap\x12\x19\n\x11\x63lear_route_cache\x18\x05 \x01(\x08\"8\n\x0eResponseStatus\x12\x0c\n\x08\x43ONTINUE\x10\x00\x12\x18\n\x14\x43ONTINUE_AND_REPLACE\x10\x01\"f\n\x0eHeaderMutation\x12<\n\x0bset_headers\x18\x01 \x03(\x0b\x32\'.envoy.config.core.v3.HeaderValueOption\x12\x16\n\x0eremove_headers\x18\x02 \x03(\t\"F\n\x0c\x42odyMutation\x12\x0e\n\x04\x62ody\x18\x01 \x01(\x0cH\x00\x12\x14\n\nclear_body\x18\x02 \x01(\x08H\x00\x42\n\n\x08mutationJ\x04\x08\x03\x10\x04\"\xd5\x01\n\x11ImmediateResponse\x12)\n\x06status\x18\x01 \x01(\x0b\x32\x19.envoy.type.v3.HttpStatus\x12:\n\x07headers\x18\x02 \x01(\x0b\x32).envoy.service.ext_proc.v3.HeaderMutation\x12\x0c\n\x04\x62ody\x18\x03 \x01(\x0c\x12:\n\x0bgrpc_status\x18\x04 \x01(\x0b\x32%.envoy.service.ext_proc.v3.GrpcStatus\x12\x0f\n\x07\x64\x65tails\x18\x05 \x01(\t\"\x1c\n\nGrpcStatus\x12\x0e\n\x06status\x18\x01 \x01(\r2\x7f\n\x11\x45xternalProcessor\x12j\n\x07Process\x12,.envoy.service.ext_proc.v3.ProcessingRequest\x1a-.envoy.service.ext_proc.v3.ProcessingResponse(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'envoy.service.ext_proc.v3.external_processor_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PROCESSINGREQUEST._serialized_start=178
  _PROCESSINGREQUEST._serialized_end=681
  _PROCESSINGRESPONSE._serialized_start=684
  _PROCESSINGRESPONSE._serialized_end=1276
  _HTTPHEADERS._serialized_start=1278
  _HTTPHEADERS._serialized_end=1370
  _HTTPBODY._serialized_start=1372
  _HTTPBODY._serialized_end=1419
  _HTTPTRAILERS._serialized_start=1421
  _HTTPTRAILERS._serialized_end=1486
  _HEADERSRESPONSE._serialized_start=1488
  _HEADERSRESPONSE._serialized_end=1566
  _BODYRESPONSE._serialized_start=1568
  _BODYRESPONSE._serialized_end=1643
  _TRAILERSRESPONSE._serialized_start=1645
  _TRAILERSRESPONSE._serialized_end=1731
  _COMMONRESPONSE._serialized_start=1734
  _COMMONRESPONSE._serialized_end=2092
  _COMMONRESPONSE_RESPONSESTATUS._serialized_start=2036
  _COMMONRESPONSE_RESPONSESTATUS._serialized_end=2092
  _HEADERMUTATION._serialized_start=2094
  _HEADERMUTATION._serialized_end=2196
  _BODYMUTATION._serialized_start=2198
  _BODYMUTATION._serialized_end=2268
  _IMMEDIATERESPONSE._serialized_start=2271
  _IMMEDIATERESPONSE._serialized_end=2484
  _GRPCSTATUS._serialized_start=2486
  _GRPCSTATUS._serialized_end=2514
  _EXTERNALPROCESSOR._serialized_start=2516
  _EXTERNALPROCESSOR._serialized_end=2643
# @@protoc_insertion_point(module_scope)
