# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: seaweedfs_tpu/pb/master.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1dseaweedfs_tpu/pb/master.proto\x12\x0eweedtpu.master\"\x90\x02\n\nVolumeStat\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0c\n\x04size\x18\x03 \x01(\x04\x12\x12\n\nfile_count\x18\x04 \x01(\x04\x12\x14\n\x0c\x64\x65lete_count\x18\x05 \x01(\x04\x12\x15\n\rdeleted_bytes\x18\x06 \x01(\x04\x12\x11\n\tread_only\x18\x07 \x01(\x08\x12\x19\n\x11replica_placement\x18\x08 \x01(\t\x12\x0f\n\x07version\x18\t \x01(\r\x12\x13\n\x0bttl_seconds\x18\n \x01(\r\x12\x11\n\tdisk_type\x18\x0b \x01(\t\x12\x15\n\rlast_scrub_ns\x18\x0c \x01(\x04\x12\x15\n\rscrub_corrupt\x18\r \x01(\x04\"\xbf\x01\n\x0b\x45\x63ShardStat\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x12\n\nshard_bits\x18\x03 \x01(\r\x12\x13\n\x0bshard_sizes\x18\x04 \x03(\x04\x12\x11\n\tdisk_type\x18\x05 \x01(\t\x12\x13\n\x0b\x64\x61ta_shards\x18\x06 \x01(\r\x12\x15\n\rparity_shards\x18\x07 \x01(\r\x12!\n\x0clocal_groups\x18\x08 \x01(\rR\x0blocalGroups\"\x83\x05\n\tHeartbeat\x12\n\n\x02ip\x18\x01 \x01(\t\x12\x0c\n\x04port\x18\x02 \x01(\r\x12\x11\n\tgrpc_port\x18\x03 \x01(\r\x12\x12\n\npublic_url\x18\x04 \x01(\t\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\x12\x0c\n\x04rack\x18\x06 \x01(\t\x12\x18\n\x10max_volume_count\x18\x07 \x01(\x04\x12\x14\n\x0cmax_file_key\x18\x08 \x01(\x04\x12+\n\x07volumes\x18\t \x03(\x0b\x32\x1a.weedtpu.master.VolumeStat\x12/\n\x0bnew_volumes\x18\n \x03(\x0b\x32\x1a.weedtpu.master.VolumeStat\x12\x33\n\x0f\x64\x65leted_volumes\x18\x0b \x03(\x0b\x32\x1a.weedtpu.master.VolumeStat\x12\x16\n\x0ehas_no_volumes\x18\x0c \x01(\x08\x12.\n\tec_shards\x18\r \x03(\x0b\x32\x1b.weedtpu.master.EcShardStat\x12\x32\n\rnew_ec_shards\x18\x0e \x03(\x0b\x32\x1b.weedtpu.master.EcShardStat\x12\x36\n\x11\x64\x65leted_ec_shards\x18\x0f \x03(\x0b\x32\x1b.weedtpu.master.EcShardStat\x12\x18\n\x10has_no_ec_shards\x18\x10 \x01(\x08\x12I\n\x11max_volume_counts\x18\x11 \x03(\x0b\x32..weedtpu.master.Heartbeat.MaxVolumeCountsEntry\x1a\x36\n\x14MaxVolumeCountsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x04:\x02\x38\x01\">\n\x11HeartbeatResponse\x12\x19\n\x11volume_size_limit\x18\x01 \x01(\x04\x12\x0e\n\x06leader\x18\x02 \x01(\t\"S\n\x08Location\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x11\n\tgrpc_port\x18\x03 \x01(\r\x12\x13\n\x0b\x64\x61ta_center\x18\x04 \x01(\t\"\xc4\x01\n\rAssignRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\x04\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x13\n\x0bttl_seconds\x18\x04 \x01(\r\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\x12\x0c\n\x04rack\x18\x06 \x01(\t\x12\x11\n\tdata_node\x18\x07 \x01(\t\x12\x11\n\tdisk_type\x18\x08 \x01(\t\x12\x1d\n\x15writable_volume_count\x18\t \x01(\r\"\xa1\x01\n\x0e\x41ssignResponse\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\r\n\x05\x63ount\x18\x02 \x01(\x04\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12*\n\x08location\x18\x04 \x01(\x0b\x32\x18.weedtpu.master.Location\x12*\n\x08replicas\x18\x05 \x03(\x0b\x32\x18.weedtpu.master.Location\x12\x0c\n\x04\x61uth\x18\x06 \x01(\t\"E\n\x13LookupVolumeRequest\x12\x1a\n\x12volume_or_file_ids\x18\x01 \x03(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\"i\n\x10VolumeIdLocation\x12\x19\n\x11volume_or_file_id\x18\x01 \x01(\t\x12+\n\tlocations\x18\x02 \x03(\x0b\x32\x18.weedtpu.master.Location\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"U\n\x14LookupVolumeResponse\x12=\n\x13volume_id_locations\x18\x01 \x03(\x0b\x32 .weedtpu.master.VolumeIdLocation\"*\n\x15LookupEcVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"R\n\x11\x45\x63ShardIdLocation\x12\x10\n\x08shard_id\x18\x01 \x01(\r\x12+\n\tlocations\x18\x02 \x03(\x0b\x32\x18.weedtpu.master.Location\"j\n\x16LookupEcVolumeResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12=\n\x12shard_id_locations\x18\x02 \x03(\x0b\x32!.weedtpu.master.EcShardIdLocation\"\x13\n\x11VolumeListRequest\"\xe7\x01\n\x08\x44iskInfo\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x14\n\x0cvolume_count\x18\x02 \x01(\x04\x12\x18\n\x10max_volume_count\x18\x03 \x01(\x04\x12\x19\n\x11\x66ree_volume_count\x18\x04 \x01(\x04\x12\x1b\n\x13\x61\x63tive_volume_count\x18\x05 \x01(\x04\x12\x30\n\x0cvolume_infos\x18\x06 \x03(\x0b\x32\x1a.weedtpu.master.VolumeStat\x12\x33\n\x0e\x65\x63_shard_infos\x18\x07 \x03(\x0b\x32\x1b.weedtpu.master.EcShardStat\"\xdb\x01\n\x0c\x44\x61taNodeInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\x11\n\tgrpc_port\x18\x04 \x01(\r\x12?\n\ndisk_infos\x18\x05 \x03(\x0b\x32+.weedtpu.master.DataNodeInfo.DiskInfosEntry\x1aJ\n\x0e\x44iskInfosEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\'\n\x05value\x18\x02 \x01(\x0b\x32\x18.weedtpu.master.DiskInfo:\x02\x38\x01\"M\n\x08RackInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x35\n\x0f\x64\x61ta_node_infos\x18\x02 \x03(\x0b\x32\x1c.weedtpu.master.DataNodeInfo\"J\n\x0e\x44\x61taCenterInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12,\n\nrack_infos\x18\x02 \x03(\x0b\x32\x18.weedtpu.master.RackInfo\"U\n\x0cTopologyInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x39\n\x11\x64\x61ta_center_infos\x18\x02 \x03(\x0b\x32\x1e.weedtpu.master.DataCenterInfo\"g\n\x12VolumeListResponse\x12\x33\n\rtopology_info\x18\x01 \x01(\x0b\x32\x1c.weedtpu.master.TopologyInfo\x12\x1c\n\x14volume_size_limit_mb\x18\x02 \x01(\x04\"d\n\x11StatisticsRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\x13\n\x0breplication\x18\x02 \x01(\t\x12\x13\n\x0bttl_seconds\x18\x03 \x01(\r\x12\x11\n\tdisk_type\x18\x04 \x01(\t\"O\n\x12StatisticsResponse\x12\x12\n\ntotal_size\x18\x01 \x01(\x04\x12\x11\n\tused_size\x18\x02 \x01(\x04\x12\x12\n\nfile_count\x18\x03 \x01(\x04\"S\n\x15\x43ollectionListRequest\x12\x1e\n\x16include_normal_volumes\x18\x01 \x01(\x08\x12\x1a\n\x12include_ec_volumes\x18\x02 \x01(\x08\"\x1a\n\nCollection\x12\x0c\n\x04name\x18\x01 \x01(\t\"I\n\x16\x43ollectionListResponse\x12/\n\x0b\x63ollections\x18\x01 \x03(\x0b\x32\x1a.weedtpu.master.Collection\"\'\n\x17\x43ollectionDeleteRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"\x1a\n\x18\x43ollectionDeleteResponse\"\x85\x01\n\x16LeaseAdminTokenRequest\x12\x16\n\x0eprevious_token\x18\x01 \x01(\x03\x12\x1a\n\x12previous_lock_time\x18\x02 \x01(\x03\x12\x11\n\tlock_name\x18\x03 \x01(\t\x12\x13\n\x0b\x63lient_name\x18\x04 \x01(\t\x12\x0f\n\x07message\x18\x05 \x01(\t\"<\n\x17LeaseAdminTokenResponse\x12\r\n\x05token\x18\x01 \x01(\x03\x12\x12\n\nlock_ts_ns\x18\x02 \x01(\x03\"a\n\x18ReleaseAdminTokenRequest\x12\x16\n\x0eprevious_token\x18\x01 \x01(\x03\x12\x1a\n\x12previous_lock_time\x18\x02 \x01(\x03\x12\x11\n\tlock_name\x18\x03 \x01(\t\"\x1b\n\x19ReleaseAdminTokenResponse\"D\n\x0eRaftServerInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x11\n\tis_leader\x18\x02 \x01(\x08\x12\x13\n\x0bmatch_index\x18\x03 \x01(\x04\"\x1f\n\x1dRaftListClusterServersRequest\"\x99\x01\n\x1eRaftListClusterServersResponse\x12\x0e\n\x06leader\x18\x01 \x01(\t\x12\x0c\n\x04term\x18\x02 \x01(\x04\x12\x14\n\x0c\x63ommit_index\x18\x03 \x01(\x04\x12\x12\n\nlast_index\x18\x04 \x01(\x04\x12/\n\x07servers\x18\x05 \x03(\x0b\x32\x1e.weedtpu.master.RaftServerInfo\"\"\n\x14RaftAddServerRequest\x12\n\n\x02id\x18\x01 \x01(\t\"4\n\x15RaftAddServerResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x0f\n\x07members\x18\x02 \x03(\t\"%\n\x17RaftRemoveServerRequest\x12\n\n\x02id\x18\x01 \x01(\t\"7\n\x18RaftRemoveServerResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x0f\n\x07members\x18\x02 \x03(\t\"s\n\x11VolumeGrowRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\x13\n\x0breplication\x18\x02 \x01(\t\x12\x13\n\x0bttl_seconds\x18\x03 \x01(\r\x12\r\n\x05\x63ount\x18\x04 \x01(\r\x12\x11\n\tdisk_type\x18\x05 \x01(\t\"(\n\x12VolumeGrowResponse\x12\x12\n\nvolume_ids\x18\x01 \x03(\r\",\n\x17ListClusterNodesRequest\x12\x11\n\tnode_type\x18\x01 \x01(\t\"i\n\x0f\x43lusterNodeInfo\x12\x0f\n\x07\x61\x64\x64ress\x18\x01 \x01(\t\x12\x11\n\tnode_type\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x61ta_center\x18\x03 \x01(\t\x12\x0c\n\x04rack\x18\x04 \x01(\t\x12\x0f\n\x07version\x18\x05 \x01(\t\"J\n\x18ListClusterNodesResponse\x12.\n\x05nodes\x18\x01 \x03(\x0b\x32\x1f.weedtpu.master.ClusterNodeInfo2\xb8\x0b\n\x06Master\x12S\n\rSendHeartbeat\x12\x19.weedtpu.master.Heartbeat\x1a!.weedtpu.master.HeartbeatResponse\"\x00(\x01\x30\x01\x12I\n\x06\x41ssign\x12\x1d.weedtpu.master.AssignRequest\x1a\x1e.weedtpu.master.AssignResponse\"\x00\x12[\n\x0cLookupVolume\x12#.weedtpu.master.LookupVolumeRequest\x1a$.weedtpu.master.LookupVolumeResponse\"\x00\x12\x61\n\x0eLookupEcVolume\x12%.weedtpu.master.LookupEcVolumeRequest\x1a&.weedtpu.master.LookupEcVolumeResponse\"\x00\x12U\n\nVolumeList\x12!.weedtpu.master.VolumeListRequest\x1a\".weedtpu.master.VolumeListResponse\"\x00\x12U\n\nStatistics\x12!.weedtpu.master.StatisticsRequest\x1a\".weedtpu.master.StatisticsResponse\"\x00\x12\x61\n\x0e\x43ollectionList\x12%.weedtpu.master.CollectionListRequest\x1a&.weedtpu.master.CollectionListResponse\"\x00\x12g\n\x10\x43ollectionDelete\x12\'.weedtpu.master.CollectionDeleteRequest\x1a(.weedtpu.master.CollectionDeleteResponse\"\x00\x12\x64\n\x0fLeaseAdminToken\x12&.weedtpu.master.LeaseAdminTokenRequest\x1a\'.weedtpu.master.LeaseAdminTokenResponse\"\x00\x12j\n\x11ReleaseAdminToken\x12(.weedtpu.master.ReleaseAdminTokenRequest\x1a).weedtpu.master.ReleaseAdminTokenResponse\"\x00\x12U\n\nVolumeGrow\x12!.weedtpu.master.VolumeGrowRequest\x1a\".weedtpu.master.VolumeGrowResponse\"\x00\x12g\n\x10ListClusterNodes\x12\'.weedtpu.master.ListClusterNodesRequest\x1a(.weedtpu.master.ListClusterNodesResponse\"\x00\x12y\n\x16RaftListClusterServers\x12-.weedtpu.master.RaftListClusterServersRequest\x1a..weedtpu.master.RaftListClusterServersResponse\"\x00\x12^\n\rRaftAddServer\x12$.weedtpu.master.RaftAddServerRequest\x1a%.weedtpu.master.RaftAddServerResponse\"\x00\x12g\n\x10RaftRemoveServer\x12\'.weedtpu.master.RaftRemoveServerRequest\x1a(.weedtpu.master.RaftRemoveServerResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'seaweedfs_tpu.pb.master_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _HEARTBEAT_MAXVOLUMECOUNTSENTRY._options = None
  _HEARTBEAT_MAXVOLUMECOUNTSENTRY._serialized_options = b'8\001'
  _DATANODEINFO_DISKINFOSENTRY._options = None
  _DATANODEINFO_DISKINFOSENTRY._serialized_options = b'8\001'
  _VOLUMESTAT._serialized_start=50
  _VOLUMESTAT._serialized_end=322
  _ECSHARDSTAT._serialized_start=325
  _ECSHARDSTAT._serialized_end=516
  _HEARTBEAT._serialized_start=519
  _HEARTBEAT._serialized_end=1162
  _HEARTBEAT_MAXVOLUMECOUNTSENTRY._serialized_start=1108
  _HEARTBEAT_MAXVOLUMECOUNTSENTRY._serialized_end=1162
  _HEARTBEATRESPONSE._serialized_start=1164
  _HEARTBEATRESPONSE._serialized_end=1226
  _LOCATION._serialized_start=1228
  _LOCATION._serialized_end=1311
  _ASSIGNREQUEST._serialized_start=1314
  _ASSIGNREQUEST._serialized_end=1510
  _ASSIGNRESPONSE._serialized_start=1513
  _ASSIGNRESPONSE._serialized_end=1674
  _LOOKUPVOLUMEREQUEST._serialized_start=1676
  _LOOKUPVOLUMEREQUEST._serialized_end=1745
  _VOLUMEIDLOCATION._serialized_start=1747
  _VOLUMEIDLOCATION._serialized_end=1852
  _LOOKUPVOLUMERESPONSE._serialized_start=1854
  _LOOKUPVOLUMERESPONSE._serialized_end=1939
  _LOOKUPECVOLUMEREQUEST._serialized_start=1941
  _LOOKUPECVOLUMEREQUEST._serialized_end=1983
  _ECSHARDIDLOCATION._serialized_start=1985
  _ECSHARDIDLOCATION._serialized_end=2067
  _LOOKUPECVOLUMERESPONSE._serialized_start=2069
  _LOOKUPECVOLUMERESPONSE._serialized_end=2175
  _VOLUMELISTREQUEST._serialized_start=2177
  _VOLUMELISTREQUEST._serialized_end=2196
  _DISKINFO._serialized_start=2199
  _DISKINFO._serialized_end=2430
  _DATANODEINFO._serialized_start=2433
  _DATANODEINFO._serialized_end=2652
  _DATANODEINFO_DISKINFOSENTRY._serialized_start=2578
  _DATANODEINFO_DISKINFOSENTRY._serialized_end=2652
  _RACKINFO._serialized_start=2654
  _RACKINFO._serialized_end=2731
  _DATACENTERINFO._serialized_start=2733
  _DATACENTERINFO._serialized_end=2807
  _TOPOLOGYINFO._serialized_start=2809
  _TOPOLOGYINFO._serialized_end=2894
  _VOLUMELISTRESPONSE._serialized_start=2896
  _VOLUMELISTRESPONSE._serialized_end=2999
  _STATISTICSREQUEST._serialized_start=3001
  _STATISTICSREQUEST._serialized_end=3101
  _STATISTICSRESPONSE._serialized_start=3103
  _STATISTICSRESPONSE._serialized_end=3182
  _COLLECTIONLISTREQUEST._serialized_start=3184
  _COLLECTIONLISTREQUEST._serialized_end=3267
  _COLLECTION._serialized_start=3269
  _COLLECTION._serialized_end=3295
  _COLLECTIONLISTRESPONSE._serialized_start=3297
  _COLLECTIONLISTRESPONSE._serialized_end=3370
  _COLLECTIONDELETEREQUEST._serialized_start=3372
  _COLLECTIONDELETEREQUEST._serialized_end=3411
  _COLLECTIONDELETERESPONSE._serialized_start=3413
  _COLLECTIONDELETERESPONSE._serialized_end=3439
  _LEASEADMINTOKENREQUEST._serialized_start=3442
  _LEASEADMINTOKENREQUEST._serialized_end=3575
  _LEASEADMINTOKENRESPONSE._serialized_start=3577
  _LEASEADMINTOKENRESPONSE._serialized_end=3637
  _RELEASEADMINTOKENREQUEST._serialized_start=3639
  _RELEASEADMINTOKENREQUEST._serialized_end=3736
  _RELEASEADMINTOKENRESPONSE._serialized_start=3738
  _RELEASEADMINTOKENRESPONSE._serialized_end=3765
  _RAFTSERVERINFO._serialized_start=3767
  _RAFTSERVERINFO._serialized_end=3835
  _RAFTLISTCLUSTERSERVERSREQUEST._serialized_start=3837
  _RAFTLISTCLUSTERSERVERSREQUEST._serialized_end=3868
  _RAFTLISTCLUSTERSERVERSRESPONSE._serialized_start=3871
  _RAFTLISTCLUSTERSERVERSRESPONSE._serialized_end=4024
  _RAFTADDSERVERREQUEST._serialized_start=4026
  _RAFTADDSERVERREQUEST._serialized_end=4060
  _RAFTADDSERVERRESPONSE._serialized_start=4062
  _RAFTADDSERVERRESPONSE._serialized_end=4114
  _RAFTREMOVESERVERREQUEST._serialized_start=4116
  _RAFTREMOVESERVERREQUEST._serialized_end=4153
  _RAFTREMOVESERVERRESPONSE._serialized_start=4155
  _RAFTREMOVESERVERRESPONSE._serialized_end=4210
  _VOLUMEGROWREQUEST._serialized_start=4212
  _VOLUMEGROWREQUEST._serialized_end=4327
  _VOLUMEGROWRESPONSE._serialized_start=4329
  _VOLUMEGROWRESPONSE._serialized_end=4369
  _LISTCLUSTERNODESREQUEST._serialized_start=4371
  _LISTCLUSTERNODESREQUEST._serialized_end=4415
  _CLUSTERNODEINFO._serialized_start=4417
  _CLUSTERNODEINFO._serialized_end=4522
  _LISTCLUSTERNODESRESPONSE._serialized_start=4524
  _LISTCLUSTERNODESRESPONSE._serialized_end=4598
  _MASTER._serialized_start=4601
  _MASTER._serialized_end=6065
# @@protoc_insertion_point(module_scope)
