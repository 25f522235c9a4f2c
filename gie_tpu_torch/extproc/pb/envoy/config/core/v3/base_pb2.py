# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: envoy/config/core/v3/base.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import any_pb2 as google_dot_protobuf_dot_any__pb2
from google.protobuf import struct_pb2 as google_dot_protobuf_dot_struct__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1f\x65nvoy/config/core/v3/base.proto\x12\x14\x65nvoy.config.core.v3\x1a\x19google/protobuf/any.proto\x1a\x1cgoogle/protobuf/struct.proto\"<\n\x0bHeaderValue\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\x12\x11\n\traw_value\x18\x03 \x01(\x0c\"\xb8\x02\n\x11HeaderValueOption\x12\x31\n\x06header\x18\x01 \x01(\x0b\x32!.envoy.config.core.v3.HeaderValue\x12Q\n\rappend_action\x18\x03 \x01(\x0e\x32:.envoy.config.core.v3.HeaderValueOption.HeaderAppendAction\x12\x18\n\x10keep_empty_value\x18\x04 \x01(\x08\"}\n\x12HeaderAppendAction\x12\x1b\n\x17\x41PPEND_IF_EXISTS_OR_ADD\x10\x00\x12\x11\n\rADD_IF_ABSENT\x10\x01\x12\x1e\n\x1aOVERWRITE_IF_EXISTS_OR_ADD\x10\x02\x12\x17\n\x13OVERWRITE_IF_EXISTS\x10\x03J\x04\x08\x02\x10\x03\"?\n\tHeaderMap\x12\x32\n\x07headers\x18\x01 \x03(\x0b\x32!.envoy.config.core.v3.HeaderValue\"\xd1\x02\n\x08Metadata\x12K\n\x0f\x66ilter_metadata\x18\x01 \x03(\x0b\x32\x32.envoy.config.core.v3.Metadata.FilterMetadataEntry\x12V\n\x15typed_filter_metadata\x18\x02 \x03(\x0b\x32\x37.envoy.config.core.v3.Metadata.TypedFilterMetadataEntry\x1aN\n\x13\x46ilterMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12&\n\x05value\x18\x02 \x01(\x0b\x32\x17.google.protobuf.Struct:\x02\x38\x01\x1aP\n\x18TypedFilterMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12#\n\x05value\x18\x02 \x01(\x0b\x32\x14.google.protobuf.Any:\x02\x38\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'envoy.config.core.v3.base_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _METADATA_FILTERMETADATAENTRY._options = None
  _METADATA_FILTERMETADATAENTRY._serialized_options = b'8\001'
  _METADATA_TYPEDFILTERMETADATAENTRY._options = None
  _METADATA_TYPEDFILTERMETADATAENTRY._serialized_options = b'8\001'
  _HEADERVALUE._serialized_start=114
  _HEADERVALUE._serialized_end=174
  _HEADERVALUEOPTION._serialized_start=177
  _HEADERVALUEOPTION._serialized_end=489
  _HEADERVALUEOPTION_HEADERAPPENDACTION._serialized_start=358
  _HEADERVALUEOPTION_HEADERAPPENDACTION._serialized_end=483
  _HEADERMAP._serialized_start=491
  _HEADERMAP._serialized_end=554
  _METADATA._serialized_start=557
  _METADATA._serialized_end=894
  _METADATA_FILTERMETADATAENTRY._serialized_start=734
  _METADATA_FILTERMETADATAENTRY._serialized_end=812
  _METADATA_TYPEDFILTERMETADATAENTRY._serialized_start=814
  _METADATA_TYPEDFILTERMETADATAENTRY._serialized_end=894
# @@protoc_insertion_point(module_scope)
