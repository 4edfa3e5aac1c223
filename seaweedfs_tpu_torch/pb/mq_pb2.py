# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: seaweedfs_tpu/pb/mq.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x19seaweedfs_tpu/pb/mq.proto\x12\nweedtpu.mq\"F\n\tLogRecord\x12\x0e\n\x06offset\x18\x01 \x01(\x03\x12\r\n\x05ts_ns\x18\x02 \x01(\x03\x12\x0b\n\x03key\x18\x03 \x01(\x0c\x12\r\n\x05value\x18\x04 \x01(\x0c\"\xf9\x01\n\x17ReplicateRecordsRequest\x12 \n\x05topic\x18\x01 \x01(\x0b\x32\x11.weedtpu.mq.Topic\x12\x11\n\tpartition\x18\x02 \x01(\x05\x12&\n\x07records\x18\x03 \x03(\x0b\x32\x15.weedtpu.mq.LogRecord\x12L\n\rgroup_offsets\x18\x04 \x03(\x0b\x32\x35.weedtpu.mq.ReplicateRecordsRequest.GroupOffsetsEntry\x1a\x33\n\x11GroupOffsetsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x02\x38\x01\"<\n\x18ReplicateRecordsResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x11\n\thave_next\x18\x02 \x01(\x03\"(\n\x05Topic\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\"\x95\x01\n\x15\x43onfigureTopicRequest\x12 \n\x05topic\x18\x01 \x01(\x0b\x32\x11.weedtpu.mq.Topic\x12\x17\n\x0fpartition_count\x18\x02 \x01(\x05\x12\x12\n\nno_forward\x18\x03 \x01(\x08\x12\x18\n\x10record_type_json\x18\x04 \x01(\t\x12\x13\n\x0breplication\x18\x05 \x01(\x05\"\'\n\x16\x43onfigureTopicResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"\x13\n\x11ListTopicsRequest\";\n\x12ListTopicsResponse\x12%\n\x06topics\x18\x01 \x03(\x0b\x32\x15.weedtpu.mq.TopicInfo\"u\n\tTopicInfo\x12 \n\x05topic\x18\x01 \x01(\x0b\x32\x11.weedtpu.mq.Topic\x12\x17\n\x0fpartition_count\x18\x02 \x01(\x05\x12\x18\n\x10record_type_json\x18\x03 \x01(\t\x12\x13\n\x0breplication\x18\x04 \x01(\x05\"6\n\x12LookupTopicRequest\x12 \n\x05topic\x18\x01 \x01(\x0b\x32\x11.weedtpu.mq.Topic\"s\n\x13LookupTopicResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x17\n\x0fpartition_count\x18\x02 \x01(\x05\x12\x34\n\x0b\x61ssignments\x18\x03 \x03(\x0b\x32\x1f.weedtpu.mq.PartitionAssignment\"8\n\x13PartitionAssignment\x12\x11\n\tpartition\x18\x01 \x01(\x05\x12\x0e\n\x06\x62roker\x18\x02 \x01(\t\"u\n\x0ePublishRequest\x12 \n\x05topic\x18\x01 \x01(\x0b\x32\x11.weedtpu.mq.Topic\x12\x11\n\tpartition\x18\x02 \x01(\x05\x12\x0b\n\x03key\x18\x03 \x01(\x0c\x12\r\n\x05value\x18\x04 \x01(\x0c\x12\x12\n\nno_forward\x18\x05 \x01(\x08\"C\n\x0fPublishResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x11\n\tpartition\x18\x02 \x01(\x05\x12\x0e\n\x06offset\x18\x03 \x01(\x03\"\x80\x01\n\x10SubscribeRequest\x12 \n\x05topic\x18\x01 \x01(\x0b\x32\x11.weedtpu.mq.Topic\x12\x11\n\tpartition\x18\x02 \x01(\x05\x12\x14\n\x0cstart_offset\x18\x03 \x01(\x03\x12\x0e\n\x06\x66ollow\x18\x04 \x01(\x08\x12\x11\n\tclient_id\x18\x05 \x01(\t\"N\n\x11SubscribeResponse\x12\x0e\n\x06offset\x18\x01 \x01(\x03\x12\r\n\x05ts_ns\x18\x02 \x01(\x03\x12\x0b\n\x03key\x18\x03 \x01(\x0c\x12\r\n\x05value\x18\x04 \x01(\x0c\"N\n\x17PartitionOffsetsRequest\x12 \n\x05topic\x18\x01 \x01(\x0b\x32\x11.weedtpu.mq.Topic\x12\x11\n\tpartition\x18\x02 \x01(\x05\"\xbe\x01\n\x18PartitionOffsetsResponse\x12\x10\n\x08\x65\x61rliest\x18\x01 \x01(\x03\x12\x0c\n\x04next\x18\x02 \x01(\x03\x12M\n\rgroup_offsets\x18\x03 \x03(\x0b\x32\x36.weedtpu.mq.PartitionOffsetsResponse.GroupOffsetsEntry\x1a\x33\n\x11GroupOffsetsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x02\x38\x01\"$\n\x13SealSegmentsRequest\x12\r\n\x05\x65vict\x18\x01 \x01(\x08\",\n\x14SealSegmentsResponse\x12\x14\n\x0csealed_count\x18\x01 \x01(\x04\"l\n\x10JoinGroupRequest\x12 \n\x05topic\x18\x01 \x01(\x0b\x32\x11.weedtpu.mq.Topic\x12\r\n\x05group\x18\x02 \x01(\t\x12\x13\n\x0binstance_id\x18\x03 \x01(\t\x12\x12\n\nno_forward\x18\x04 \x01(\x08\"_\n\x11JoinGroupResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x12\n\ngeneration\x18\x02 \x01(\x03\x12\x12\n\npartitions\x18\x03 \x03(\x05\x12\x13\n\x0b\x63oordinator\x18\x04 \x01(\t\"\x85\x01\n\x15GroupHeartbeatRequest\x12 \n\x05topic\x18\x01 \x01(\x0b\x32\x11.weedtpu.mq.Topic\x12\r\n\x05group\x18\x02 \x01(\t\x12\x13\n\x0binstance_id\x18\x03 \x01(\t\x12\x12\n\ngeneration\x18\x04 \x01(\x03\x12\x12\n\nno_forward\x18\x05 \x01(\x08\"K\n\x16GroupHeartbeatResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x0e\n\x06rejoin\x18\x02 \x01(\x08\x12\x12\n\ngeneration\x18\x03 \x01(\x03\"m\n\x11LeaveGroupRequest\x12 \n\x05topic\x18\x01 \x01(\x0b\x32\x11.weedtpu.mq.Topic\x12\r\n\x05group\x18\x02 \x01(\t\x12\x13\n\x0binstance_id\x18\x03 \x01(\t\x12\x12\n\nno_forward\x18\x04 \x01(\x08\"#\n\x12LeaveGroupResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"[\n\x14\x44\x65scribeGroupRequest\x12 \n\x05topic\x18\x01 \x01(\x0b\x32\x11.weedtpu.mq.Topic\x12\r\n\x05group\x18\x02 \x01(\t\x12\x12\n\nno_forward\x18\x03 \x01(\x08\"d\n\x15\x44\x65scribeGroupResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x12\n\ngeneration\x18\x02 \x01(\x03\x12(\n\x07members\x18\x03 \x03(\x0b\x32\x17.weedtpu.mq.GroupMember\"6\n\x0bGroupMember\x12\x13\n\x0binstance_id\x18\x01 \x01(\t\x12\x12\n\npartitions\x18\x02 \x03(\x05\"}\n\x13\x43ommitOffsetRequest\x12 \n\x05topic\x18\x01 \x01(\x0b\x32\x11.weedtpu.mq.Topic\x12\r\n\x05group\x18\x02 \x01(\t\x12\x11\n\tpartition\x18\x03 \x01(\x05\x12\x0e\n\x06offset\x18\x04 \x01(\x03\x12\x12\n\nno_forward\x18\x05 \x01(\x08\"%\n\x14\x43ommitOffsetResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"l\n\x12\x46\x65tchOffsetRequest\x12 \n\x05topic\x18\x01 \x01(\x0b\x32\x11.weedtpu.mq.Topic\x12\r\n\x05group\x18\x02 \x01(\t\x12\x11\n\tpartition\x18\x03 \x01(\x05\x12\x12\n\nno_forward\x18\x04 \x01(\x08\"4\n\x13\x46\x65tchOffsetResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x0e\n\x06offset\x18\x02 \x01(\x03\x32\xa6\t\n\x08MqBroker\x12Y\n\x0e\x43onfigureTopic\x12!.weedtpu.mq.ConfigureTopicRequest\x1a\".weedtpu.mq.ConfigureTopicResponse\"\x00\x12M\n\nListTopics\x12\x1d.weedtpu.mq.ListTopicsRequest\x1a\x1e.weedtpu.mq.ListTopicsResponse\"\x00\x12P\n\x0bLookupTopic\x12\x1e.weedtpu.mq.LookupTopicRequest\x1a\x1f.weedtpu.mq.LookupTopicResponse\"\x00\x12\x44\n\x07Publish\x12\x1a.weedtpu.mq.PublishRequest\x1a\x1b.weedtpu.mq.PublishResponse\"\x00\x12L\n\tSubscribe\x12\x1c.weedtpu.mq.SubscribeRequest\x1a\x1d.weedtpu.mq.SubscribeResponse\"\x00\x30\x01\x12_\n\x10PartitionOffsets\x12#.weedtpu.mq.PartitionOffsetsRequest\x1a$.weedtpu.mq.PartitionOffsetsResponse\"\x00\x12S\n\x0cSealSegments\x12\x1f.weedtpu.mq.SealSegmentsRequest\x1a .weedtpu.mq.SealSegmentsResponse\"\x00\x12J\n\tJoinGroup\x12\x1c.weedtpu.mq.JoinGroupRequest\x1a\x1d.weedtpu.mq.JoinGroupResponse\"\x00\x12Y\n\x0eGroupHeartbeat\x12!.weedtpu.mq.GroupHeartbeatRequest\x1a\".weedtpu.mq.GroupHeartbeatResponse\"\x00\x12M\n\nLeaveGroup\x12\x1d.weedtpu.mq.LeaveGroupRequest\x1a\x1e.weedtpu.mq.LeaveGroupResponse\"\x00\x12V\n\rDescribeGroup\x12 .weedtpu.mq.DescribeGroupRequest\x1a!.weedtpu.mq.DescribeGroupResponse\"\x00\x12S\n\x0c\x43ommitOffset\x12\x1f.weedtpu.mq.CommitOffsetRequest\x1a .weedtpu.mq.CommitOffsetResponse\"\x00\x12P\n\x0b\x46\x65tchOffset\x12\x1e.weedtpu.mq.FetchOffsetRequest\x1a\x1f.weedtpu.mq.FetchOffsetResponse\"\x00\x12_\n\x10ReplicateRecords\x12#.weedtpu.mq.ReplicateRecordsRequest\x1a$.weedtpu.mq.ReplicateRecordsResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'seaweedfs_tpu.pb.mq_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _REPLICATERECORDSREQUEST_GROUPOFFSETSENTRY._options = None
  _REPLICATERECORDSREQUEST_GROUPOFFSETSENTRY._serialized_options = b'8\001'
  _PARTITIONOFFSETSRESPONSE_GROUPOFFSETSENTRY._options = None
  _PARTITIONOFFSETSRESPONSE_GROUPOFFSETSENTRY._serialized_options = b'8\001'
  _LOGRECORD._serialized_start=41
  _LOGRECORD._serialized_end=111
  _REPLICATERECORDSREQUEST._serialized_start=114
  _REPLICATERECORDSREQUEST._serialized_end=363
  _REPLICATERECORDSREQUEST_GROUPOFFSETSENTRY._serialized_start=312
  _REPLICATERECORDSREQUEST_GROUPOFFSETSENTRY._serialized_end=363
  _REPLICATERECORDSRESPONSE._serialized_start=365
  _REPLICATERECORDSRESPONSE._serialized_end=425
  _TOPIC._serialized_start=427
  _TOPIC._serialized_end=467
  _CONFIGURETOPICREQUEST._serialized_start=470
  _CONFIGURETOPICREQUEST._serialized_end=619
  _CONFIGURETOPICRESPONSE._serialized_start=621
  _CONFIGURETOPICRESPONSE._serialized_end=660
  _LISTTOPICSREQUEST._serialized_start=662
  _LISTTOPICSREQUEST._serialized_end=681
  _LISTTOPICSRESPONSE._serialized_start=683
  _LISTTOPICSRESPONSE._serialized_end=742
  _TOPICINFO._serialized_start=744
  _TOPICINFO._serialized_end=861
  _LOOKUPTOPICREQUEST._serialized_start=863
  _LOOKUPTOPICREQUEST._serialized_end=917
  _LOOKUPTOPICRESPONSE._serialized_start=919
  _LOOKUPTOPICRESPONSE._serialized_end=1034
  _PARTITIONASSIGNMENT._serialized_start=1036
  _PARTITIONASSIGNMENT._serialized_end=1092
  _PUBLISHREQUEST._serialized_start=1094
  _PUBLISHREQUEST._serialized_end=1211
  _PUBLISHRESPONSE._serialized_start=1213
  _PUBLISHRESPONSE._serialized_end=1280
  _SUBSCRIBEREQUEST._serialized_start=1283
  _SUBSCRIBEREQUEST._serialized_end=1411
  _SUBSCRIBERESPONSE._serialized_start=1413
  _SUBSCRIBERESPONSE._serialized_end=1491
  _PARTITIONOFFSETSREQUEST._serialized_start=1493
  _PARTITIONOFFSETSREQUEST._serialized_end=1571
  _PARTITIONOFFSETSRESPONSE._serialized_start=1574
  _PARTITIONOFFSETSRESPONSE._serialized_end=1764
  _PARTITIONOFFSETSRESPONSE_GROUPOFFSETSENTRY._serialized_start=1713
  _PARTITIONOFFSETSRESPONSE_GROUPOFFSETSENTRY._serialized_end=1764
  _SEALSEGMENTSREQUEST._serialized_start=1766
  _SEALSEGMENTSREQUEST._serialized_end=1802
  _SEALSEGMENTSRESPONSE._serialized_start=1804
  _SEALSEGMENTSRESPONSE._serialized_end=1848
  _JOINGROUPREQUEST._serialized_start=1850
  _JOINGROUPREQUEST._serialized_end=1958
  _JOINGROUPRESPONSE._serialized_start=1960
  _JOINGROUPRESPONSE._serialized_end=2055
  _GROUPHEARTBEATREQUEST._serialized_start=2058
  _GROUPHEARTBEATREQUEST._serialized_end=2191
  _GROUPHEARTBEATRESPONSE._serialized_start=2193
  _GROUPHEARTBEATRESPONSE._serialized_end=2268
  _LEAVEGROUPREQUEST._serialized_start=2270
  _LEAVEGROUPREQUEST._serialized_end=2379
  _LEAVEGROUPRESPONSE._serialized_start=2381
  _LEAVEGROUPRESPONSE._serialized_end=2416
  _DESCRIBEGROUPREQUEST._serialized_start=2418
  _DESCRIBEGROUPREQUEST._serialized_end=2509
  _DESCRIBEGROUPRESPONSE._serialized_start=2511
  _DESCRIBEGROUPRESPONSE._serialized_end=2611
  _GROUPMEMBER._serialized_start=2613
  _GROUPMEMBER._serialized_end=2667
  _COMMITOFFSETREQUEST._serialized_start=2669
  _COMMITOFFSETREQUEST._serialized_end=2794
  _COMMITOFFSETRESPONSE._serialized_start=2796
  _COMMITOFFSETRESPONSE._serialized_end=2833
  _FETCHOFFSETREQUEST._serialized_start=2835
  _FETCHOFFSETREQUEST._serialized_end=2943
  _FETCHOFFSETRESPONSE._serialized_start=2945
  _FETCHOFFSETRESPONSE._serialized_end=2997
  _MQBROKER._serialized_start=3000
  _MQBROKER._serialized_end=4190
# @@protoc_insertion_point(module_scope)
