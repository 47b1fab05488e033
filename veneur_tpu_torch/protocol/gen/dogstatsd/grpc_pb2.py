# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: dogstatsd/grpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x14\x64ogstatsd/grpc.proto\x12\tdogstatsd\"\x07\n\x05\x45mpty\"&\n\x0f\x44ogstatsdPacket\x12\x13\n\x0bpacketBytes\x18\x01 \x01(\x0c\x32K\n\rDogstatsdGRPC\x12:\n\nSendPacket\x12\x1a.dogstatsd.DogstatsdPacket\x1a\x10.dogstatsd.Emptyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'dogstatsd.grpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMPTY._serialized_start=35
  _EMPTY._serialized_end=42
  _DOGSTATSDPACKET._serialized_start=44
  _DOGSTATSDPACKET._serialized_end=82
  _DOGSTATSDGRPC._serialized_start=84
  _DOGSTATSDGRPC._serialized_end=159
# @@protoc_insertion_point(module_scope)
