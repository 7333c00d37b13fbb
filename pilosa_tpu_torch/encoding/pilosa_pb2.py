# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: pilosa.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cpilosa.proto\x12\npilosa_tpu\"s\n\x04\x41ttr\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\r\x12\x14\n\x0cstring_value\x18\x03 \x01(\t\x12\x11\n\tint_value\x18\x04 \x01(\x03\x12\x12\n\nbool_value\x18\x05 \x01(\x08\x12\x13\n\x0b\x66loat_value\x18\x06 \x01(\x01\"I\n\rColumnAttrSet\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\x1f\n\x05\x61ttrs\x18\x03 \x03(\x0b\x32\x10.pilosa_tpu.Attr\"T\n\x03Row\x12\x0f\n\x07\x63olumns\x18\x01 \x03(\x04\x12\x0c\n\x04keys\x18\x02 \x03(\t\x12\x1f\n\x05\x61ttrs\x18\x03 \x03(\x0b\x32\x10.pilosa_tpu.Attr\x12\r\n\x05keyed\x18\x04 \x01(\x08\".\n\x04Pair\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\r\n\x05\x63ount\x18\x03 \x01(\x04\"&\n\x08ValCount\x12\x0b\n\x03val\x18\x01 \x01(\x03\x12\r\n\x05\x63ount\x18\x02 \x01(\x03\":\n\x08\x46ieldRow\x12\r\n\x05\x66ield\x18\x01 \x01(\t\x12\x0e\n\x06row_id\x18\x02 \x01(\x04\x12\x0f\n\x07row_key\x18\x03 \x01(\t\"^\n\nGroupCount\x12#\n\x05group\x18\x01 \x03(\x0b\x32\x14.pilosa_tpu.FieldRow\x12\r\n\x05\x63ount\x18\x02 \x01(\x04\x12\x0b\n\x03sum\x18\x03 \x01(\x03\x12\x0f\n\x07has_sum\x18\x04 \x01(\x08\";\n\x0eRowIdentifiers\x12\x0c\n\x04rows\x18\x01 \x03(\x04\x12\x0c\n\x04keys\x18\x02 \x03(\t\x12\r\n\x05keyed\x18\x03 \x01(\x08\"\x82\x02\n\x0bQueryResult\x12\x0c\n\x04type\x18\x01 \x01(\r\x12\x1c\n\x03row\x18\x02 \x01(\x0b\x32\x0f.pilosa_tpu.Row\x12\t\n\x01n\x18\x03 \x01(\x04\x12\x1f\n\x05pairs\x18\x04 \x03(\x0b\x32\x10.pilosa_tpu.Pair\x12\'\n\tval_count\x18\x05 \x01(\x0b\x32\x14.pilosa_tpu.ValCount\x12\x0f\n\x07\x63hanged\x18\x06 \x01(\x08\x12\x33\n\x0frow_identifiers\x18\x07 \x01(\x0b\x32\x1a.pilosa_tpu.RowIdentifiers\x12,\n\x0cgroup_counts\x18\x08 \x03(\x0b\x32\x16.pilosa_tpu.GroupCount\"\x87\x01\n\x0cQueryRequest\x12\r\n\x05query\x18\x01 \x01(\t\x12\x0e\n\x06shards\x18\x02 \x03(\x04\x12\x14\n\x0c\x63olumn_attrs\x18\x03 \x01(\x08\x12\x0e\n\x06remote\x18\x04 \x01(\x08\x12\x19\n\x11\x65xclude_row_attrs\x18\x05 \x01(\x08\x12\x17\n\x0f\x65xclude_columns\x18\x06 \x01(\x08\"{\n\rQueryResponse\x12\x0b\n\x03\x65rr\x18\x01 \x01(\t\x12(\n\x07results\x18\x02 \x03(\x0b\x32\x17.pilosa_tpu.QueryResult\x12\x33\n\x10\x63olumn_attr_sets\x18\x03 \x03(\x0b\x32\x19.pilosa_tpu.ColumnAttrSet\"\xab\x01\n\rImportRequest\x12\r\n\x05index\x18\x01 \x01(\t\x12\r\n\x05\x66ield\x18\x02 \x01(\t\x12\r\n\x05shard\x18\x03 \x01(\x04\x12\x0f\n\x07row_ids\x18\x04 \x03(\x04\x12\x10\n\x08row_keys\x18\x05 \x03(\t\x12\x12\n\ncolumn_ids\x18\x06 \x03(\x04\x12\x13\n\x0b\x63olumn_keys\x18\x07 \x03(\t\x12\x12\n\ntimestamps\x18\x08 \x03(\x03\x12\r\n\x05\x63lear\x18\t \x01(\x08\"\x89\x01\n\x12ImportValueRequest\x12\r\n\x05index\x18\x01 \x01(\t\x12\r\n\x05\x66ield\x18\x02 \x01(\t\x12\r\n\x05shard\x18\x03 \x01(\x04\x12\x12\n\ncolumn_ids\x18\x04 \x03(\x04\x12\x13\n\x0b\x63olumn_keys\x18\x05 \x03(\t\x12\x0e\n\x06values\x18\x06 \x03(\x03\x12\r\n\x05\x63lear\x18\x07 \x01(\x08\"2\n\x14ImportRoaringRequest\x12\x0c\n\x04view\x18\x01 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x02 \x01(\x0c\"\x1d\n\x0eImportResponse\x12\x0b\n\x03\x65rr\x18\x01 \x01(\t\"W\n\x14TranslateKeysRequest\x12\r\n\x05index\x18\x01 \x01(\t\x12\r\n\x05\x66ield\x18\x02 \x01(\t\x12\x0c\n\x04keys\x18\x03 \x03(\t\x12\x13\n\x0blookup_only\x18\x04 \x01(\x08\"$\n\x15TranslateKeysResponse\x12\x0b\n\x03ids\x18\x01 \x03(\x04\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'pilosa_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ATTR._serialized_start=28
  _ATTR._serialized_end=143
  _COLUMNATTRSET._serialized_start=145
  _COLUMNATTRSET._serialized_end=218
  _ROW._serialized_start=220
  _ROW._serialized_end=304
  _PAIR._serialized_start=306
  _PAIR._serialized_end=352
  _VALCOUNT._serialized_start=354
  _VALCOUNT._serialized_end=392
  _FIELDROW._serialized_start=394
  _FIELDROW._serialized_end=452
  _GROUPCOUNT._serialized_start=454
  _GROUPCOUNT._serialized_end=548
  _ROWIDENTIFIERS._serialized_start=550
  _ROWIDENTIFIERS._serialized_end=609
  _QUERYRESULT._serialized_start=612
  _QUERYRESULT._serialized_end=870
  _QUERYREQUEST._serialized_start=873
  _QUERYREQUEST._serialized_end=1008
  _QUERYRESPONSE._serialized_start=1010
  _QUERYRESPONSE._serialized_end=1133
  _IMPORTREQUEST._serialized_start=1136
  _IMPORTREQUEST._serialized_end=1307
  _IMPORTVALUEREQUEST._serialized_start=1310
  _IMPORTVALUEREQUEST._serialized_end=1447
  _IMPORTROARINGREQUEST._serialized_start=1449
  _IMPORTROARINGREQUEST._serialized_end=1499
  _IMPORTRESPONSE._serialized_start=1501
  _IMPORTRESPONSE._serialized_end=1530
  _TRANSLATEKEYSREQUEST._serialized_start=1532
  _TRANSLATEKEYSREQUEST._serialized_end=1619
  _TRANSLATEKEYSRESPONSE._serialized_start=1621
  _TRANSLATEKEYSRESPONSE._serialized_end=1657
# @@protoc_insertion_point(module_scope)
