# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: signalfxpb/signalfx.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x19signalfxpb/signalfx.proto\x12\nsignalfxpb\"@\n\x05\x44\x61tum\x12\x10\n\x08strValue\x18\x01 \x01(\t\x12\x13\n\x0b\x64oubleValue\x18\x02 \x01(\x01\x12\x10\n\x08intValue\x18\x03 \x01(\x03\"\'\n\tDimension\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\"\xb7\x01\n\tDataPoint\x12\x0e\n\x06source\x18\x01 \x01(\t\x12\x0e\n\x06metric\x18\x02 \x01(\t\x12\x11\n\ttimestamp\x18\x03 \x01(\x03\x12 \n\x05value\x18\x04 \x01(\x0b\x32\x11.signalfxpb.Datum\x12*\n\nmetricType\x18\x05 \x01(\x0e\x32\x16.signalfxpb.MetricType\x12)\n\ndimensions\x18\x06 \x03(\x0b\x32\x15.signalfxpb.Dimension\"C\n\x16\x44\x61taPointUploadMessage\x12)\n\ndatapoints\x18\x01 \x03(\x0b\x32\x15.signalfxpb.DataPoint\"A\n\x08Property\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0b\x32\x19.signalfxpb.PropertyValue\"[\n\rPropertyValue\x12\x10\n\x08strValue\x18\x01 \x01(\t\x12\x13\n\x0b\x64oubleValue\x18\x02 \x01(\x01\x12\x10\n\x08intValue\x18\x03 \x01(\x03\x12\x11\n\tboolValue\x18\x04 \x01(\x08\"\xaf\x01\n\x05\x45vent\x12\x11\n\teventType\x18\x01 \x02(\t\x12)\n\ndimensions\x18\x02 \x03(\x0b\x32\x15.signalfxpb.Dimension\x12(\n\nproperties\x18\x03 \x03(\x0b\x32\x14.signalfxpb.Property\x12+\n\x08\x63\x61tegory\x18\x04 \x01(\x0e\x32\x19.signalfxpb.EventCategory\x12\x11\n\ttimestamp\x18\x05 \x01(\x03\"7\n\x12\x45ventUploadMessage\x12!\n\x06\x65vents\x18\x01 \x03(\x0b\x32\x11.signalfxpb.Event*F\n\nMetricType\x12\t\n\x05GAUGE\x10\x00\x12\x0b\n\x07\x43OUNTER\x10\x01\x12\x08\n\x04\x45NUM\x10\x02\x12\x16\n\x12\x43UMULATIVE_COUNTER\x10\x03*0\n\rEventCategory\x12\x12\n\x0cUSER_DEFINED\x10\xc0\x84=\x12\x0b\n\x05\x41LERT\x10\xa0\x8d\x06')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'signalfxpb.signalfx_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _METRICTYPE._serialized_start=798
  _METRICTYPE._serialized_end=868
  _EVENTCATEGORY._serialized_start=870
  _EVENTCATEGORY._serialized_end=918
  _DATUM._serialized_start=41
  _DATUM._serialized_end=105
  _DIMENSION._serialized_start=107
  _DIMENSION._serialized_end=146
  _DATAPOINT._serialized_start=149
  _DATAPOINT._serialized_end=332
  _DATAPOINTUPLOADMESSAGE._serialized_start=334
  _DATAPOINTUPLOADMESSAGE._serialized_end=401
  _PROPERTY._serialized_start=403
  _PROPERTY._serialized_end=468
  _PROPERTYVALUE._serialized_start=470
  _PROPERTYVALUE._serialized_end=561
  _EVENT._serialized_start=564
  _EVENT._serialized_end=739
  _EVENTUPLOADMESSAGE._serialized_start=741
  _EVENTUPLOADMESSAGE._serialized_end=796
# @@protoc_insertion_point(module_scope)
