# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: prediction.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import struct_pb2 as google_dot_protobuf_dot_struct__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10prediction.proto\x12\tseldontpu\x1a\x1cgoogle/protobuf/struct.proto\"/\n\x06Tensor\x12\x11\n\x05shape\x18\x01 \x03(\x05\x42\x02\x10\x01\x12\x12\n\x06values\x18\x02 \x03(\x01\x42\x02\x10\x01\"M\n\tRawTensor\x12\r\n\x05\x64type\x18\x01 \x01(\t\x12\x11\n\x05shape\x18\x02 \x03(\x05\x42\x02\x10\x01\x12\x0c\n\x04\x64\x61ta\x18\x03 \x01(\x0c\x12\x10\n\x08\x65ncoding\x18\x04 \x01(\t\"\xa3\x01\n\x0b\x44\x65\x66\x61ultData\x12\r\n\x05names\x18\x01 \x03(\t\x12#\n\x06tensor\x18\x02 \x01(\x0b\x32\x11.seldontpu.TensorH\x00\x12-\n\x07ndarray\x18\x03 \x01(\x0b\x32\x1a.google.protobuf.ListValueH\x00\x12#\n\x03raw\x18\x04 \x01(\x0b\x32\x14.seldontpu.RawTensorH\x00\x42\x0c\n\ndata_oneof\"\xd9\x01\n\x06Metric\x12\x0b\n\x03key\x18\x01 \x01(\t\x12*\n\x04type\x18\x02 \x01(\x0e\x32\x1c.seldontpu.Metric.MetricType\x12\r\n\x05value\x18\x03 \x01(\x02\x12)\n\x04tags\x18\x04 \x03(\x0b\x32\x1b.seldontpu.Metric.TagsEntry\x1a+\n\tTagsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"/\n\nMetricType\x12\x0b\n\x07\x43OUNTER\x10\x00\x12\t\n\x05GAUGE\x10\x01\x12\t\n\x05TIMER\x10\x02\"\xf1\x02\n\x04Meta\x12\x0c\n\x04puid\x18\x01 \x01(\t\x12\'\n\x04tags\x18\x02 \x03(\x0b\x32\x19.seldontpu.Meta.TagsEntry\x12-\n\x07routing\x18\x03 \x03(\x0b\x32\x1c.seldontpu.Meta.RoutingEntry\x12\x36\n\x0crequest_path\x18\x04 \x03(\x0b\x32 .seldontpu.Meta.RequestPathEntry\x12\"\n\x07metrics\x18\x05 \x03(\x0b\x32\x11.seldontpu.Metric\x1a\x43\n\tTagsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12%\n\x05value\x18\x02 \x01(\x0b\x32\x16.google.protobuf.Value:\x02\x38\x01\x1a.\n\x0cRoutingEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x05:\x02\x38\x01\x1a\x32\n\x10RequestPathEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x8a\x01\n\x06Status\x12\x0c\n\x04\x63ode\x18\x01 \x01(\x05\x12\x0c\n\x04info\x18\x02 \x01(\t\x12\x0e\n\x06reason\x18\x03 \x01(\t\x12,\n\x06status\x18\x04 \x01(\x0e\x32\x1c.seldontpu.Status.StatusFlag\"&\n\nStatusFlag\x12\x0b\n\x07SUCCESS\x10\x00\x12\x0b\n\x07\x46\x41ILURE\x10\x01\"\xc4\x01\n\rSeldonMessage\x12!\n\x06status\x18\x01 \x01(\x0b\x32\x11.seldontpu.Status\x12\x1d\n\x04meta\x18\x02 \x01(\x0b\x32\x0f.seldontpu.Meta\x12&\n\x04\x64\x61ta\x18\x03 \x01(\x0b\x32\x16.seldontpu.DefaultDataH\x00\x12\x12\n\x08\x62in_data\x18\x04 \x01(\x0cH\x00\x12\x12\n\x08str_data\x18\x05 \x01(\tH\x00\x12\x13\n\tjson_data\x18\x06 \x01(\tH\x00\x42\x0c\n\ndata_oneof\"F\n\x11SeldonMessageList\x12\x31\n\x0fseldon_messages\x18\x01 \x03(\x0b\x32\x18.seldontpu.SeldonMessage\"\x9a\x01\n\x08\x46\x65\x65\x64\x62\x61\x63k\x12)\n\x07request\x18\x01 \x01(\x0b\x32\x18.seldontpu.SeldonMessage\x12*\n\x08response\x18\x02 \x01(\x0b\x32\x18.seldontpu.SeldonMessage\x12\x0e\n\x06reward\x18\x03 \x01(\x02\x12\'\n\x05truth\x18\x04 \x01(\x0b\x32\x18.seldontpu.SeldonMessage\"@\n\x12SeldonMessageBatch\x12*\n\x08requests\x18\x01 \x03(\x0b\x32\x18.seldontpu.SeldonMessage2\xd7\x02\n\x07Generic\x12\x44\n\x0eTransformInput\x12\x18.seldontpu.SeldonMessage\x1a\x18.seldontpu.SeldonMessage\x12\x45\n\x0fTransformOutput\x12\x18.seldontpu.SeldonMessage\x1a\x18.seldontpu.SeldonMessage\x12;\n\x05Route\x12\x18.seldontpu.SeldonMessage\x1a\x18.seldontpu.SeldonMessage\x12\x43\n\tAggregate\x12\x1c.seldontpu.SeldonMessageList\x1a\x18.seldontpu.SeldonMessage\x12=\n\x0cSendFeedback\x12\x13.seldontpu.Feedback\x1a\x18.seldontpu.SeldonMessage2\x85\x01\n\x05Model\x12=\n\x07Predict\x12\x18.seldontpu.SeldonMessage\x1a\x18.seldontpu.SeldonMessage\x12=\n\x0cSendFeedback\x12\x13.seldontpu.Feedback\x1a\x18.seldontpu.SeldonMessage2\x84\x01\n\x06Router\x12;\n\x05Route\x12\x18.seldontpu.SeldonMessage\x1a\x18.seldontpu.SeldonMessage\x12=\n\x0cSendFeedback\x12\x13.seldontpu.Feedback\x1a\x18.seldontpu.SeldonMessage2S\n\x0bTransformer\x12\x44\n\x0eTransformInput\x12\x18.seldontpu.SeldonMessage\x1a\x18.seldontpu.SeldonMessage2Z\n\x11OutputTransformer\x12\x45\n\x0fTransformOutput\x12\x18.seldontpu.SeldonMessage\x1a\x18.seldontpu.SeldonMessage2O\n\x08\x43ombiner\x12\x43\n\tAggregate\x12\x1c.seldontpu.SeldonMessageList\x1a\x18.seldontpu.SeldonMessage2\xce\x01\n\x06Seldon\x12=\n\x07Predict\x12\x18.seldontpu.SeldonMessage\x1a\x18.seldontpu.SeldonMessage\x12=\n\x0cSendFeedback\x12\x13.seldontpu.Feedback\x1a\x18.seldontpu.SeldonMessage\x12\x46\n\x0eGenerateStream\x12\x18.seldontpu.SeldonMessage\x1a\x18.seldontpu.SeldonMessage0\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'prediction_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TENSOR.fields_by_name['shape']._options = None
  _TENSOR.fields_by_name['shape']._serialized_options = b'\020\001'
  _TENSOR.fields_by_name['values']._options = None
  _TENSOR.fields_by_name['values']._serialized_options = b'\020\001'
  _RAWTENSOR.fields_by_name['shape']._options = None
  _RAWTENSOR.fields_by_name['shape']._serialized_options = b'\020\001'
  _METRIC_TAGSENTRY._options = None
  _METRIC_TAGSENTRY._serialized_options = b'8\001'
  _META_TAGSENTRY._options = None
  _META_TAGSENTRY._serialized_options = b'8\001'
  _META_ROUTINGENTRY._options = None
  _META_ROUTINGENTRY._serialized_options = b'8\001'
  _META_REQUESTPATHENTRY._options = None
  _META_REQUESTPATHENTRY._serialized_options = b'8\001'
  _TENSOR._serialized_start=61
  _TENSOR._serialized_end=108
  _RAWTENSOR._serialized_start=110
  _RAWTENSOR._serialized_end=187
  _DEFAULTDATA._serialized_start=190
  _DEFAULTDATA._serialized_end=353
  _METRIC._serialized_start=356
  _METRIC._serialized_end=573
  _METRIC_TAGSENTRY._serialized_start=481
  _METRIC_TAGSENTRY._serialized_end=524
  _METRIC_METRICTYPE._serialized_start=526
  _METRIC_METRICTYPE._serialized_end=573
  _META._serialized_start=576
  _META._serialized_end=945
  _META_TAGSENTRY._serialized_start=778
  _META_TAGSENTRY._serialized_end=845
  _META_ROUTINGENTRY._serialized_start=847
  _META_ROUTINGENTRY._serialized_end=893
  _META_REQUESTPATHENTRY._serialized_start=895
  _META_REQUESTPATHENTRY._serialized_end=945
  _STATUS._serialized_start=948
  _STATUS._serialized_end=1086
  _STATUS_STATUSFLAG._serialized_start=1048
  _STATUS_STATUSFLAG._serialized_end=1086
  _SELDONMESSAGE._serialized_start=1089
  _SELDONMESSAGE._serialized_end=1285
  _SELDONMESSAGELIST._serialized_start=1287
  _SELDONMESSAGELIST._serialized_end=1357
  _FEEDBACK._serialized_start=1360
  _FEEDBACK._serialized_end=1514
  _SELDONMESSAGEBATCH._serialized_start=1516
  _SELDONMESSAGEBATCH._serialized_end=1580
  _GENERIC._serialized_start=1583
  _GENERIC._serialized_end=1926
  _MODEL._serialized_start=1929
  _MODEL._serialized_end=2062
  _ROUTER._serialized_start=2065
  _ROUTER._serialized_end=2197
  _TRANSFORMER._serialized_start=2199
  _TRANSFORMER._serialized_end=2282
  _OUTPUTTRANSFORMER._serialized_start=2284
  _OUTPUTTRANSFORMER._serialized_end=2374
  _COMBINER._serialized_start=2376
  _COMBINER._serialized_end=2455
  _SELDON._serialized_start=2458
  _SELDON._serialized_end=2664
# @@protoc_insertion_point(module_scope)
