# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: seaweedfs_tpu/pb/volume_server.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n$seaweedfs_tpu/pb/volume_server.proto\x12\x0eweedtpu.volume\"{\n\x15\x41llocateVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x13\n\x0bttl_seconds\x18\x04 \x01(\r\x12\x11\n\tdisk_type\x18\x05 \x01(\t\"\x18\n\x16\x41llocateVolumeResponse\"<\n\x13VolumeDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\nonly_empty\x18\x02 \x01(\x08\"\x16\n\x14VolumeDeleteResponse\"g\n\x11VolumeCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x18\n\x10source_data_node\x18\x03 \x01(\t\x12\x11\n\tdisk_type\x18\x04 \x01(\t\"/\n\x12VolumeCopyResponse\x12\x19\n\x11last_append_at_ns\x18\x01 \x01(\x04\"&\n\x11VolumeMarkRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x14\n\x12VolumeMarkResponse\"(\n\x13VolumeStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"l\n\x14VolumeStatusResponse\x12\x13\n\x0bvolume_size\x18\x01 \x01(\x04\x12\x12\n\nfile_count\x18\x02 \x01(\x04\x12\x11\n\tread_only\x18\x03 \x01(\x08\x12\x18\n\x10last_modified_ns\x18\x04 \x01(\x04\"C\n\x13VolumeVacuumRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x19\n\x11garbage_threshold\x18\x02 \x01(\x02\"/\n\x14VolumeVacuumResponse\x12\x17\n\x0freclaimed_bytes\x18\x01 \x01(\x04\";\n\x12VolumeMountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\"\x15\n\x13VolumeMountResponse\"[\n\nEcGeometry\x12\x13\n\x0b\x64\x61ta_shards\x18\x01 \x01(\r\x12\x15\n\rparity_shards\x18\x02 \x01(\r\x12!\n\x0clocal_groups\x18\x03 \x01(\rR\x0blocalGroups\"\x92\x01\n\x17\x45\x63ShardsGenerateRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12,\n\x08geometry\x18\x03 \x01(\x0b\x32\x1a.weedtpu.volume.EcGeometry\x12\x0f\n\x07targets\x18\x04 \x03(\t\x12\x11\n\tdisk_type\x18\x05 \x01(\t\"\x1a\n\x18\x45\x63ShardsGenerateResponse\"\x8a\x01\n\x14\x45\x63ShardsReceiveChunk\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x10\n\x08shard_id\x18\x03 \x01(\r\x12\x0b\n\x03\x65xt\x18\x04 \x01(\t\x12\x11\n\tdisk_type\x18\x05 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x06 \x01(\x0c\x12\x0b\n\x03\x65of\x18\x07 \x01(\x08\"0\n\x17\x45\x63ShardsReceiveResponse\x12\x15\n\rbytes_written\x18\x01 \x01(\x04\"\x97\x01\n\x16\x45\x63ShardsRebuildRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12,\n\x08geometry\x18\x03 \x01(\x0b\x32\x1a.weedtpu.volume.EcGeometry\x12(\n\x10target_shard_ids\x18\x04 \x03(\rR\x0etargetShardIds\"4\n\x17\x45\x63ShardsRebuildResponse\x12\x19\n\x11rebuilt_shard_ids\x18\x01 \x03(\r\"\xc1\x01\n\x13\x45\x63ShardsCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\x12\x15\n\rcopy_ecx_file\x18\x04 \x01(\x08\x12\x15\n\rcopy_ecj_file\x18\x05 \x01(\x08\x12\x15\n\rcopy_vif_file\x18\x06 \x01(\x08\x12\x18\n\x10source_data_node\x18\x07 \x01(\t\x12\x11\n\tdisk_type\x18\x08 \x01(\t\"\x16\n\x14\x45\x63ShardsCopyResponse\"Q\n\x15\x45\x63ShardsDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x18\n\x16\x45\x63ShardsDeleteResponse\"P\n\x14\x45\x63ShardsMountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x17\n\x15\x45\x63ShardsMountResponse\">\n\x16\x45\x63ShardsUnmountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tshard_ids\x18\x02 \x03(\r\"\x19\n\x17\x45\x63ShardsUnmountResponse\"i\n\x12\x45\x63ShardReadRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08shard_id\x18\x02 \x01(\r\x12\x0e\n\x06offset\x18\x03 \x01(\x03\x12\x0c\n\x04size\x18\x04 \x01(\x03\x12\x10\n\x08\x66ile_key\x18\x05 \x01(\x04\"7\n\x13\x45\x63ShardReadResponse\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x12\n\nis_deleted\x18\x02 \x01(\x08\"_\n\x13\x45\x63\x42lobDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x10\n\x08\x66ile_key\x18\x03 \x01(\x04\x12\x0f\n\x07version\x18\x04 \x01(\r\"\x16\n\x14\x45\x63\x42lobDeleteResponse\"n\n\x17\x45\x63ShardsToVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12,\n\x08geometry\x18\x03 \x01(\x0b\x32\x1a.weedtpu.volume.EcGeometry\"\x1a\n\x18\x45\x63ShardsToVolumeResponse\"(\n\x13\x45\x63ShardsInfoRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"A\n\x0b\x45\x63ShardInfo\x12\x10\n\x08shard_id\x18\x01 \x01(\r\x12\x0c\n\x04size\x18\x02 \x01(\x04\x12\x12\n\ncollection\x18\x03 \x01(\t\"C\n\x14\x45\x63ShardsInfoResponse\x12+\n\x06shards\x18\x01 \x03(\x0b\x32\x1b.weedtpu.volume.EcShardInfo\"\x80\x01\n\x0f\x43opyFileRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0b\n\x03\x65xt\x18\x03 \x01(\t\x12\x13\n\x0bstop_offset\x18\x04 \x01(\x04\x12$\n\x1cignore_source_file_not_found\x18\x05 \x01(\x08\"@\n\x10\x43opyFileResponse\x12\x14\n\x0c\x66ile_content\x18\x01 \x01(\x0c\x12\x16\n\x0emodified_ts_ns\x18\x02 \x01(\x04\"[\n\x15ReadNeedleBlobRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tneedle_id\x18\x02 \x01(\x04\x12\x0e\n\x06offset\x18\x03 \x01(\x03\x12\x0c\n\x04size\x18\x04 \x01(\x05\"-\n\x16ReadNeedleBlobResponse\x12\x13\n\x0bneedle_blob\x18\x01 \x01(\x0c\"+\n\x16VolumeNeedleIdsRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"G\n\x17VolumeNeedleIdsResponse\x12\x0c\n\x04keys\x18\x01 \x03(\x04\x12\r\n\x05sizes\x18\x02 \x03(\r\x12\x0f\n\x07offsets\x18\x03 \x03(\x04\"\x1a\n\x18VolumeServerLeaveRequest\"\x1b\n\x19VolumeServerLeaveResponse\"r\n\x15VolumeTierMoveRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0c\n\x04\x64\x65st\x18\x03 \x01(\t\x12\x10\n\x08\x64ownload\x18\x04 \x01(\x08\x12\x12\n\nforce_seal\x18\x05 \x01(\x08\"%\n\x16VolumeTierMoveResponse\x12\x0b\n\x03key\x18\x01 \x01(\t\"K\n!VolumeConfigureReplicationRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x13\n\x0breplication\x18\x02 \x01(\t\"$\n\"VolumeConfigureReplicationResponse\"7\n\x12VolumeScrubRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x0e\n\x06repair\x18\x02 \x01(\x08\"v\n\x11VolumeScrubResult\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\n\n\x02\x65\x63\x18\x02 \x01(\x08\x12\x0f\n\x07scanned\x18\x03 \x01(\x04\x12\x0f\n\x07\x63orrupt\x18\x04 \x01(\x04\x12\x10\n\x08repaired\x18\x05 \x01(\x04\x12\x0e\n\x06\x66\x61iled\x18\x06 \x01(\x04\"I\n\x13VolumeScrubResponse\x12\x32\n\x07results\x18\x01 \x03(\x0b\x32!.weedtpu.volume.VolumeScrubResult2\xda\x14\n\x0cVolumeServer\x12\x61\n\x0e\x41llocateVolume\x12%.weedtpu.volume.AllocateVolumeRequest\x1a&.weedtpu.volume.AllocateVolumeResponse\"\x00\x12[\n\x0cVolumeDelete\x12#.weedtpu.volume.VolumeDeleteRequest\x1a$.weedtpu.volume.VolumeDeleteResponse\"\x00\x12]\n\x12VolumeMarkReadonly\x12!.weedtpu.volume.VolumeMarkRequest\x1a\".weedtpu.volume.VolumeMarkResponse\"\x00\x12]\n\x12VolumeMarkWritable\x12!.weedtpu.volume.VolumeMarkRequest\x1a\".weedtpu.volume.VolumeMarkResponse\"\x00\x12[\n\x0cVolumeStatus\x12#.weedtpu.volume.VolumeStatusRequest\x1a$.weedtpu.volume.VolumeStatusResponse\"\x00\x12[\n\x0cVolumeVacuum\x12#.weedtpu.volume.VolumeVacuumRequest\x1a$.weedtpu.volume.VolumeVacuumResponse\"\x00\x12X\n\x0bVolumeMount\x12\".weedtpu.volume.VolumeMountRequest\x1a#.weedtpu.volume.VolumeMountResponse\"\x00\x12Z\n\rVolumeUnmount\x12\".weedtpu.volume.VolumeMountRequest\x1a#.weedtpu.volume.VolumeMountResponse\"\x00\x12U\n\nVolumeCopy\x12!.weedtpu.volume.VolumeCopyRequest\x1a\".weedtpu.volume.VolumeCopyResponse\"\x00\x12g\n\x10\x45\x63ShardsGenerate\x12\'.weedtpu.volume.EcShardsGenerateRequest\x1a(.weedtpu.volume.EcShardsGenerateResponse\"\x00\x12\x64\n\x0f\x45\x63ShardsRebuild\x12&.weedtpu.volume.EcShardsRebuildRequest\x1a\'.weedtpu.volume.EcShardsRebuildResponse\"\x00\x12[\n\x0c\x45\x63ShardsCopy\x12#.weedtpu.volume.EcShardsCopyRequest\x1a$.weedtpu.volume.EcShardsCopyResponse\"\x00\x12\x61\n\x0e\x45\x63ShardsDelete\x12%.weedtpu.volume.EcShardsDeleteRequest\x1a&.weedtpu.volume.EcShardsDeleteResponse\"\x00\x12^\n\rEcShardsMount\x12$.weedtpu.volume.EcShardsMountRequest\x1a%.weedtpu.volume.EcShardsMountResponse\"\x00\x12\x64\n\x0f\x45\x63ShardsUnmount\x12&.weedtpu.volume.EcShardsUnmountRequest\x1a\'.weedtpu.volume.EcShardsUnmountResponse\"\x00\x12Z\n\x0b\x45\x63ShardRead\x12\".weedtpu.volume.EcShardReadRequest\x1a#.weedtpu.volume.EcShardReadResponse\"\x00\x30\x01\x12[\n\x0c\x45\x63\x42lobDelete\x12#.weedtpu.volume.EcBlobDeleteRequest\x1a$.weedtpu.volume.EcBlobDeleteResponse\"\x00\x12g\n\x10\x45\x63ShardsToVolume\x12\'.weedtpu.volume.EcShardsToVolumeRequest\x1a(.weedtpu.volume.EcShardsToVolumeResponse\"\x00\x12[\n\x0c\x45\x63ShardsInfo\x12#.weedtpu.volume.EcShardsInfoRequest\x1a$.weedtpu.volume.EcShardsInfoResponse\"\x00\x12\x64\n\x0f\x45\x63ShardsReceive\x12$.weedtpu.volume.EcShardsReceiveChunk\x1a\'.weedtpu.volume.EcShardsReceiveResponse\"\x00(\x01\x12Q\n\x08\x43opyFile\x12\x1f.weedtpu.volume.CopyFileRequest\x1a .weedtpu.volume.CopyFileResponse\"\x00\x30\x01\x12\x61\n\x0eReadNeedleBlob\x12%.weedtpu.volume.ReadNeedleBlobRequest\x1a&.weedtpu.volume.ReadNeedleBlobResponse\"\x00\x12\x64\n\x0fVolumeNeedleIds\x12&.weedtpu.volume.VolumeNeedleIdsRequest\x1a\'.weedtpu.volume.VolumeNeedleIdsResponse\"\x00\x12j\n\x11VolumeServerLeave\x12(.weedtpu.volume.VolumeServerLeaveRequest\x1a).weedtpu.volume.VolumeServerLeaveResponse\"\x00\x12\x61\n\x0eVolumeTierMove\x12%.weedtpu.volume.VolumeTierMoveRequest\x1a&.weedtpu.volume.VolumeTierMoveResponse\"\x00\x12\x85\x01\n\x1aVolumeConfigureReplication\x12\x31.weedtpu.volume.VolumeConfigureReplicationRequest\x1a\x32.weedtpu.volume.VolumeConfigureReplicationResponse\"\x00\x12X\n\x0bVolumeScrub\x12\".weedtpu.volume.VolumeScrubRequest\x1a#.weedtpu.volume.VolumeScrubResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'seaweedfs_tpu.pb.volume_server_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ALLOCATEVOLUMEREQUEST._serialized_start=56
  _ALLOCATEVOLUMEREQUEST._serialized_end=179
  _ALLOCATEVOLUMERESPONSE._serialized_start=181
  _ALLOCATEVOLUMERESPONSE._serialized_end=205
  _VOLUMEDELETEREQUEST._serialized_start=207
  _VOLUMEDELETEREQUEST._serialized_end=267
  _VOLUMEDELETERESPONSE._serialized_start=269
  _VOLUMEDELETERESPONSE._serialized_end=291
  _VOLUMECOPYREQUEST._serialized_start=293
  _VOLUMECOPYREQUEST._serialized_end=396
  _VOLUMECOPYRESPONSE._serialized_start=398
  _VOLUMECOPYRESPONSE._serialized_end=445
  _VOLUMEMARKREQUEST._serialized_start=447
  _VOLUMEMARKREQUEST._serialized_end=485
  _VOLUMEMARKRESPONSE._serialized_start=487
  _VOLUMEMARKRESPONSE._serialized_end=507
  _VOLUMESTATUSREQUEST._serialized_start=509
  _VOLUMESTATUSREQUEST._serialized_end=549
  _VOLUMESTATUSRESPONSE._serialized_start=551
  _VOLUMESTATUSRESPONSE._serialized_end=659
  _VOLUMEVACUUMREQUEST._serialized_start=661
  _VOLUMEVACUUMREQUEST._serialized_end=728
  _VOLUMEVACUUMRESPONSE._serialized_start=730
  _VOLUMEVACUUMRESPONSE._serialized_end=777
  _VOLUMEMOUNTREQUEST._serialized_start=779
  _VOLUMEMOUNTREQUEST._serialized_end=838
  _VOLUMEMOUNTRESPONSE._serialized_start=840
  _VOLUMEMOUNTRESPONSE._serialized_end=861
  _ECGEOMETRY._serialized_start=863
  _ECGEOMETRY._serialized_end=954
  _ECSHARDSGENERATEREQUEST._serialized_start=957
  _ECSHARDSGENERATEREQUEST._serialized_end=1103
  _ECSHARDSGENERATERESPONSE._serialized_start=1105
  _ECSHARDSGENERATERESPONSE._serialized_end=1131
  _ECSHARDSRECEIVECHUNK._serialized_start=1134
  _ECSHARDSRECEIVECHUNK._serialized_end=1272
  _ECSHARDSRECEIVERESPONSE._serialized_start=1274
  _ECSHARDSRECEIVERESPONSE._serialized_end=1322
  _ECSHARDSREBUILDREQUEST._serialized_start=1325
  _ECSHARDSREBUILDREQUEST._serialized_end=1476
  _ECSHARDSREBUILDRESPONSE._serialized_start=1478
  _ECSHARDSREBUILDRESPONSE._serialized_end=1530
  _ECSHARDSCOPYREQUEST._serialized_start=1533
  _ECSHARDSCOPYREQUEST._serialized_end=1726
  _ECSHARDSCOPYRESPONSE._serialized_start=1728
  _ECSHARDSCOPYRESPONSE._serialized_end=1750
  _ECSHARDSDELETEREQUEST._serialized_start=1752
  _ECSHARDSDELETEREQUEST._serialized_end=1833
  _ECSHARDSDELETERESPONSE._serialized_start=1835
  _ECSHARDSDELETERESPONSE._serialized_end=1859
  _ECSHARDSMOUNTREQUEST._serialized_start=1861
  _ECSHARDSMOUNTREQUEST._serialized_end=1941
  _ECSHARDSMOUNTRESPONSE._serialized_start=1943
  _ECSHARDSMOUNTRESPONSE._serialized_end=1966
  _ECSHARDSUNMOUNTREQUEST._serialized_start=1968
  _ECSHARDSUNMOUNTREQUEST._serialized_end=2030
  _ECSHARDSUNMOUNTRESPONSE._serialized_start=2032
  _ECSHARDSUNMOUNTRESPONSE._serialized_end=2057
  _ECSHARDREADREQUEST._serialized_start=2059
  _ECSHARDREADREQUEST._serialized_end=2164
  _ECSHARDREADRESPONSE._serialized_start=2166
  _ECSHARDREADRESPONSE._serialized_end=2221
  _ECBLOBDELETEREQUEST._serialized_start=2223
  _ECBLOBDELETEREQUEST._serialized_end=2318
  _ECBLOBDELETERESPONSE._serialized_start=2320
  _ECBLOBDELETERESPONSE._serialized_end=2342
  _ECSHARDSTOVOLUMEREQUEST._serialized_start=2344
  _ECSHARDSTOVOLUMEREQUEST._serialized_end=2454
  _ECSHARDSTOVOLUMERESPONSE._serialized_start=2456
  _ECSHARDSTOVOLUMERESPONSE._serialized_end=2482
  _ECSHARDSINFOREQUEST._serialized_start=2484
  _ECSHARDSINFOREQUEST._serialized_end=2524
  _ECSHARDINFO._serialized_start=2526
  _ECSHARDINFO._serialized_end=2591
  _ECSHARDSINFORESPONSE._serialized_start=2593
  _ECSHARDSINFORESPONSE._serialized_end=2660
  _COPYFILEREQUEST._serialized_start=2663
  _COPYFILEREQUEST._serialized_end=2791
  _COPYFILERESPONSE._serialized_start=2793
  _COPYFILERESPONSE._serialized_end=2857
  _READNEEDLEBLOBREQUEST._serialized_start=2859
  _READNEEDLEBLOBREQUEST._serialized_end=2950
  _READNEEDLEBLOBRESPONSE._serialized_start=2952
  _READNEEDLEBLOBRESPONSE._serialized_end=2997
  _VOLUMENEEDLEIDSREQUEST._serialized_start=2999
  _VOLUMENEEDLEIDSREQUEST._serialized_end=3042
  _VOLUMENEEDLEIDSRESPONSE._serialized_start=3044
  _VOLUMENEEDLEIDSRESPONSE._serialized_end=3115
  _VOLUMESERVERLEAVEREQUEST._serialized_start=3117
  _VOLUMESERVERLEAVEREQUEST._serialized_end=3143
  _VOLUMESERVERLEAVERESPONSE._serialized_start=3145
  _VOLUMESERVERLEAVERESPONSE._serialized_end=3172
  _VOLUMETIERMOVEREQUEST._serialized_start=3174
  _VOLUMETIERMOVEREQUEST._serialized_end=3288
  _VOLUMETIERMOVERESPONSE._serialized_start=3290
  _VOLUMETIERMOVERESPONSE._serialized_end=3327
  _VOLUMECONFIGUREREPLICATIONREQUEST._serialized_start=3329
  _VOLUMECONFIGUREREPLICATIONREQUEST._serialized_end=3404
  _VOLUMECONFIGUREREPLICATIONRESPONSE._serialized_start=3406
  _VOLUMECONFIGUREREPLICATIONRESPONSE._serialized_end=3442
  _VOLUMESCRUBREQUEST._serialized_start=3444
  _VOLUMESCRUBREQUEST._serialized_end=3499
  _VOLUMESCRUBRESULT._serialized_start=3501
  _VOLUMESCRUBRESULT._serialized_end=3619
  _VOLUMESCRUBRESPONSE._serialized_start=3621
  _VOLUMESCRUBRESPONSE._serialized_end=3694
  _VOLUMESERVER._serialized_start=3697
  _VOLUMESERVER._serialized_end=6347
# @@protoc_insertion_point(module_scope)
