# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: seaweedfs_tpu/pb/filer.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1cseaweedfs_tpu/pb/filer.proto\x12\rweedtpu.filer\"x\n\tFileChunk\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\x0e\n\x06offset\x18\x02 \x01(\x04\x12\x0c\n\x04size\x18\x03 \x01(\x04\x12\x16\n\x0emodified_ts_ns\x18\x04 \x01(\x03\x12\r\n\x05\x65_tag\x18\x05 \x01(\t\x12\x19\n\x11is_chunk_manifest\x18\x06 \x01(\x08\"=\n\x11\x46ileChunkManifest\x12(\n\x06\x63hunks\x18\x01 \x03(\x0b\x32\x18.weedtpu.filer.FileChunk\"\xbb\x01\n\x0e\x46useAttributes\x12\x11\n\tfile_size\x18\x01 \x01(\x04\x12\r\n\x05mtime\x18\x02 \x01(\x03\x12\x0e\n\x06\x63rtime\x18\x03 \x01(\x03\x12\x11\n\tfile_mode\x18\x04 \x01(\r\x12\x0b\n\x03uid\x18\x05 \x01(\r\x12\x0b\n\x03gid\x18\x06 \x01(\r\x12\x0c\n\x04mime\x18\x07 \x01(\t\x12\x13\n\x0bttl_seconds\x18\x08 \x01(\r\x12\x12\n\ncollection\x18\t \x01(\t\x12\x13\n\x0breplication\x18\n \x01(\t\"\x80\x02\n\x05\x45ntry\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x14\n\x0cis_directory\x18\x02 \x01(\x08\x12(\n\x06\x63hunks\x18\x03 \x03(\x0b\x32\x18.weedtpu.filer.FileChunk\x12\x31\n\nattributes\x18\x04 \x01(\x0b\x32\x1d.weedtpu.filer.FuseAttributes\x12\x34\n\x08\x65xtended\x18\x05 \x03(\x0b\x32\".weedtpu.filer.Entry.ExtendedEntry\x12\x0f\n\x07\x63ontent\x18\x06 \x01(\x0c\x1a/\n\rExtendedEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c:\x02\x38\x01\">\n\x1bLookupDirectoryEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\"R\n\x1cLookupDirectoryEntryResponse\x12#\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x14.weedtpu.filer.Entry\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\x82\x01\n\x12ListEntriesRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0e\n\x06prefix\x18\x02 \x01(\t\x12\x1c\n\x14start_from_file_name\x18\x03 \x01(\t\x12\x1c\n\x14inclusive_start_from\x18\x04 \x01(\x08\x12\r\n\x05limit\x18\x05 \x01(\r\":\n\x13ListEntriesResponse\x12#\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x14.weedtpu.filer.Entry\"L\n\x12\x43reateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12#\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x14.weedtpu.filer.Entry\"$\n\x13\x43reateEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"L\n\x12UpdateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12#\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x14.weedtpu.filer.Entry\"$\n\x13UpdateEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"c\n\x12\x44\x65leteEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x16\n\x0eis_delete_data\x18\x03 \x01(\x08\x12\x14\n\x0cis_recursive\x18\x04 \x01(\x08\"$\n\x13\x44\x65leteEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"l\n\x18\x41tomicRenameEntryRequest\x12\x15\n\rold_directory\x18\x01 \x01(\t\x12\x10\n\x08old_name\x18\x02 \x01(\t\x12\x15\n\rnew_directory\x18\x03 \x01(\t\x12\x10\n\x08new_name\x18\x04 \x01(\t\"*\n\x19\x41tomicRenameEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"w\n\x13\x41ssignVolumeRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\x05\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x13\n\x0bttl_seconds\x18\x04 \x01(\r\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\"p\n\x14\x41ssignVolumeResponse\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\r\n\x05\x63ount\x18\x04 \x01(\x05\x12\r\n\x05\x65rror\x18\x05 \x01(\t\x12\x0c\n\x04\x61uth\x18\x06 \x01(\t\"\x18\n\x16\x46ilerStatisticsRequest\"G\n\x17\x46ilerStatisticsResponse\x12\x13\n\x0b\x65ntry_count\x18\x01 \x01(\x04\x12\x17\n\x0f\x64irectory_count\x18\x02 \x01(\x04\"Y\n\x18SubscribeMetadataRequest\x12\x13\n\x0b\x63lient_name\x18\x01 \x01(\t\x12\x13\n\x0bpath_prefix\x18\x02 \x01(\t\x12\x13\n\x0bsince_ts_ns\x18\x03 \x01(\x03\"\x9c\x01\n\rMetadataEvent\x12\r\n\x05ts_ns\x18\x01 \x01(\x03\x12\x11\n\tdirectory\x18\x02 \x01(\t\x12\'\n\told_entry\x18\x03 \x01(\x0b\x32\x14.weedtpu.filer.Entry\x12\'\n\tnew_entry\x18\x04 \x01(\x0b\x32\x14.weedtpu.filer.Entry\x12\x17\n\x0fnew_parent_path\x18\x05 \x01(\t2\xe0\x06\n\x05\x46iler\x12q\n\x14LookupDirectoryEntry\x12*.weedtpu.filer.LookupDirectoryEntryRequest\x1a+.weedtpu.filer.LookupDirectoryEntryResponse\"\x00\x12X\n\x0bListEntries\x12!.weedtpu.filer.ListEntriesRequest\x1a\".weedtpu.filer.ListEntriesResponse\"\x00\x30\x01\x12V\n\x0b\x43reateEntry\x12!.weedtpu.filer.CreateEntryRequest\x1a\".weedtpu.filer.CreateEntryResponse\"\x00\x12V\n\x0bUpdateEntry\x12!.weedtpu.filer.UpdateEntryRequest\x1a\".weedtpu.filer.UpdateEntryResponse\"\x00\x12V\n\x0b\x44\x65leteEntry\x12!.weedtpu.filer.DeleteEntryRequest\x1a\".weedtpu.filer.DeleteEntryResponse\"\x00\x12h\n\x11\x41tomicRenameEntry\x12\'.weedtpu.filer.AtomicRenameEntryRequest\x1a(.weedtpu.filer.AtomicRenameEntryResponse\"\x00\x12Y\n\x0c\x41ssignVolume\x12\".weedtpu.filer.AssignVolumeRequest\x1a#.weedtpu.filer.AssignVolumeResponse\"\x00\x12]\n\nStatistics\x12%.weedtpu.filer.FilerStatisticsRequest\x1a&.weedtpu.filer.FilerStatisticsResponse\"\x00\x12^\n\x11SubscribeMetadata\x12\'.weedtpu.filer.SubscribeMetadataRequest\x1a\x1c.weedtpu.filer.MetadataEvent\"\x00\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'seaweedfs_tpu.pb.filer_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ENTRY_EXTENDEDENTRY._options = None
  _ENTRY_EXTENDEDENTRY._serialized_options = b'8\001'
  _FILECHUNK._serialized_start=47
  _FILECHUNK._serialized_end=167
  _FILECHUNKMANIFEST._serialized_start=169
  _FILECHUNKMANIFEST._serialized_end=230
  _FUSEATTRIBUTES._serialized_start=233
  _FUSEATTRIBUTES._serialized_end=420
  _ENTRY._serialized_start=423
  _ENTRY._serialized_end=679
  _ENTRY_EXTENDEDENTRY._serialized_start=632
  _ENTRY_EXTENDEDENTRY._serialized_end=679
  _LOOKUPDIRECTORYENTRYREQUEST._serialized_start=681
  _LOOKUPDIRECTORYENTRYREQUEST._serialized_end=743
  _LOOKUPDIRECTORYENTRYRESPONSE._serialized_start=745
  _LOOKUPDIRECTORYENTRYRESPONSE._serialized_end=827
  _LISTENTRIESREQUEST._serialized_start=830
  _LISTENTRIESREQUEST._serialized_end=960
  _LISTENTRIESRESPONSE._serialized_start=962
  _LISTENTRIESRESPONSE._serialized_end=1020
  _CREATEENTRYREQUEST._serialized_start=1022
  _CREATEENTRYREQUEST._serialized_end=1098
  _CREATEENTRYRESPONSE._serialized_start=1100
  _CREATEENTRYRESPONSE._serialized_end=1136
  _UPDATEENTRYREQUEST._serialized_start=1138
  _UPDATEENTRYREQUEST._serialized_end=1214
  _UPDATEENTRYRESPONSE._serialized_start=1216
  _UPDATEENTRYRESPONSE._serialized_end=1252
  _DELETEENTRYREQUEST._serialized_start=1254
  _DELETEENTRYREQUEST._serialized_end=1353
  _DELETEENTRYRESPONSE._serialized_start=1355
  _DELETEENTRYRESPONSE._serialized_end=1391
  _ATOMICRENAMEENTRYREQUEST._serialized_start=1393
  _ATOMICRENAMEENTRYREQUEST._serialized_end=1501
  _ATOMICRENAMEENTRYRESPONSE._serialized_start=1503
  _ATOMICRENAMEENTRYRESPONSE._serialized_end=1545
  _ASSIGNVOLUMEREQUEST._serialized_start=1547
  _ASSIGNVOLUMEREQUEST._serialized_end=1666
  _ASSIGNVOLUMERESPONSE._serialized_start=1668
  _ASSIGNVOLUMERESPONSE._serialized_end=1780
  _FILERSTATISTICSREQUEST._serialized_start=1782
  _FILERSTATISTICSREQUEST._serialized_end=1806
  _FILERSTATISTICSRESPONSE._serialized_start=1808
  _FILERSTATISTICSRESPONSE._serialized_end=1879
  _SUBSCRIBEMETADATAREQUEST._serialized_start=1881
  _SUBSCRIBEMETADATAREQUEST._serialized_end=1970
  _METADATAEVENT._serialized_start=1973
  _METADATAEVENT._serialized_end=2129
  _FILER._serialized_start=2132
  _FILER._serialized_end=2996
# @@protoc_insertion_point(module_scope)
