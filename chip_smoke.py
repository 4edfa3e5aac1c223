#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (seaweedfs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--gib G]

Phases, each printing what it found; any failure exits non-zero:

1. Device and build: the card's name and power limit, and an nvcc build of
   every kernel in seaweedfs_tpu_torch/csrc (and a g++ build of its host
   CRC32C, GF(2^8) codec and native data plane, dp.cpp linked with
   crc32c.cpp; one process per source, all started together), with
   ptxas's
   registers and spills for every kernel instantiation; a spill in K1 or K2
   fails the run.
2. Kernels against their plain versions on the card, byte-exact:
   - K1, the CUDA GF(2^8) apply, against rs_torch.apply_matrix_reference,
     for the RS(10,4) encode matrix, a 1-loss and a 4-loss RS(10,4) rebuild
     matrix, RS(6,3), RS(12,4), Cauchy(10,4), a stack of three 4-loss
     RS(10,4) rebuild matrices (12 output rows: two grid.y groups), and the
     LRC(10,2,2) matrices: its encode rows (4 x 10), the local repair of
     shard 3 (1 x 5, all ones), the two-group local repair of {3, 7}
     (2 x 10) and the global rebuild of {0, 5, 12, 13} (4 x 10); at ragged
     widths, the main-path width, an all-byte-values input and an unaligned
     strided view; then timed with CUDA events at (10 x 6 MiB -> 4) and
     (10 x 64 MiB -> 4) with the encode matrix, at (10 x 64 MiB -> 4) with
     the 4-loss rebuild matrix, the rebuild's own launch, and at the LRC
     local repairs' shapes (5 x 64 MiB -> 1, 10 x 64 MiB -> 2): once
     through the wrapper call by call, and once as 20 calls captured in a
     CUDA graph and replayed, which leaves out the host's work between
     launches.
   - K3 pack, K2 plane apply and K4 unpack against their plain versions in
     rs_torch, for K1's matrices but RS(12,4), the stack of five RS(10,4)
     target sets and the stack of the LRC hop's four target sets, at 1, 2
     and 3 blocks and on an all-byte-values input, with unpack(pack(x)) ==
     x; then at the widths of phase 4's chunks (64 MiB and the 39 MiB
     tail): pack of 10 rows, K2 -> 4 rows and -> 8 rows (both stacks), and
     unpack of 10 rows and of each target set's slice of the 8; then each
     timed at 10 x 64 MiB (K2 -> 8 with both stacks), and pack + K2 +
     unpack against K1 at (10 x 64 MiB -> 4).
3. Main path at real size: a G GiB volume (a version-3 superblock, payload
   and a strict-valid .idx from --seed whose last live needle ends at the
   .dat's end) goes through the port's own CLI, ``ec.encode.local`` on the
   card; parity is checked on the CPU over the first, a middle and the tail
   row; 4 shards (2 data, 2 parity) are deleted and ``ec.rebuild.local``
   must regenerate them hash-identically.  The kernel's launch counter is
   zeroed just before and read just after each.
4. Plane-resident rebuild hop at real size, on the volume of phase 3: with
   shards 0, 3, 10 and 13 taken as absent, the plan's 10 survivors are read
   in the rebuild pipeline's chunks, uploaded, and
   ``ReedSolomonCuda.reconstruct_words_multi`` rebuilds the target sets
   (0), (3), (10), (13) and (0, 3, 10, 13) at once; every result must equal
   the shard files' bytes.  K3, K2 and K4 must launch in it, K1 must not.
   Then ``ec.decode.local`` reassembles the volume from its data shards:
   the .dat must have the original's sha256 and the .idx the .ecx's bytes.
5. The LRC main path: the same .dat and .idx are encoded as LRC(10,2,2)
   by ``ec.encode.local -code lrc`` on the card (parity checked on the CPU
   by LrcTorch, localGroups 2 in the .vif); three flag-less
   ``ec.rebuild.local`` runs (the storage class read from the .vif)
   regenerate {3} locally from 5 shards, {3, 7} locally from 10 and
   {0, 5, 12, 13} globally, hash-identically, each launching K1; the LRC
   plane hop rebuilds the sets (12), (13), (12, 13) and (0, 5, 12, 13) over
   the global plan's 10 survivors through K3, K2 and K4 (not K1);
   ``ec.decode.local`` restores the .dat; and the loss {0, 1, 10, 13} must
   fail as unrecoverable, with no launch and no shard file written.
6. The multi-device EC codec (parallel/): the mesh over the card's own
   devices (its size printed); a logical (2, 2) mesh over cuda:0 x 4 (one
   stream per position) at 10 x 64 MiB, where sharded_encode,
   sharded_reconstruct (4 losses), ReedSolomonMesh in width and rows mode
   (encode and rebuild) and ec_round_trip_step (residual 0) must equal the
   plain GF(2^8) apply on the card, launching K1-K4; K1-K4 at the
   positions' shapes against their plain versions, and timed, with the
   mesh encodes against one K1 and the upload of a pinned buffer in column
   slices two ways; phase 3's volume through ``ec.encode.local`` and
   ``ec.rebuild.local`` under SEAWEEDFS_TPU_EC_MESH=1 and through the
   pipeline with the logical mesh in both modes, hash-identical to phase
   3's shards; one RS rebuild under a WEED_REPAIR_RATE_MB whose 1 s burst
   covers half its reads, which must wait about a second
   (weedtpu_repair_wait_seconds_total) and ride the cuda schedule cache;
   and measure_scaling for the device counts present.
7. The volume server's EC service and the needle-read path: a G GiB .dat
   of real version-3 needles from --seed (1 KiB payloads, the size `weed
   benchmark` writes, 1064 bytes on disk each, plus 8 of 256 KiB-1 MiB;
   64 tombstoned in the .idx; a sample equal to Needle.to_bytes) is served
   by ``python -m seaweedfs_tpu_torch.cli volume -device cuda`` in a
   subprocess and driven over localhost gRPC: EcShardsGenerate (K1 in the
   server; .ecx == the sorted live .idx, parity sampled on the CPU),
   EcShardsMount and EcShardsInfo (14 shards), EcShardRead of seeded
   ranges (== the shard files), twice EcShardsUnmount and EcShardsDelete
   of {0, 3, 10, 13} and EcShardsRebuild (hash-identical; the first and
   second rebuild of one process side by side), EcBlobDelete (then
   EcShardRead with its file_key says is_deleted), the normal volume
   unmounted and 1,031 needles (1,024 seeded 1 KiB ones and the 7 big
   ones not deleted) GOT over HTTP from the 14 local shards, each equal to
   its payload and the deleted ones 404, every one served by the native
   plane (csrc/dp.cpp's EC GET: ``seaweedfs_volume_native_dp`` native_reads
   up by 1,031, nothing forwarded), EcShardsToVolume (the
   .dat's sha256 comes back), and the server's /metrics (EC operations,
   the cuda schedule cache and its K1 launches, which start at 0 in the
   new process).  The same .dat is
   encoded as LRC(10,2,2) by ``ec.encode.local -code lrc`` and with 64 MiB
   large blocks by write_ec_files (one 10 x 64 MiB large row: parity
   sampled in both areas, needles read back).  Then about 2,500 needles
   (every one that crosses a 1 MiB block, and the big ones) are read here
   through Store, EcVolume.read_needle and EcShardLocator's local
   reconstruction, in five states (RS healthy, RS without {0, 3, 10, 13},
   LRC without {3}, {0, 5, 12, 13} and {0, 1, 10, 11}): every payload equal
   to its seeded bytes, every tombstoned needle NotFoundError, needles/s,
   p50/p99 and the repair bytes read per reconstructed byte (5 for an LRC
   local plan, 10 for a global decode).
8. The cluster EC path: ``cli master`` and four ``cli volume -device cuda
   -mserver ...`` subprocesses (racks alternating, each one's start time
   printed) over phase 7's needle volume (hard links of its .dat/.idx, on
   server 0) and a 128 MiB LRC volume (vid 2, collection lrc, on server
   1; cut from 1 GiB for time), driven by ``cli shell -c``: the master
   sees volume 1 on server 0; ``lock; ec.encode -volumeId 1; unlock``
   leaves 14 shards at the master over both racks, at most 4 on a node,
   each sha256-identical to phase 7's generate, the original volume gone,
   and server 0's K1 launches (its /metrics) equal to the generate's
   batches (18 a GiB); about 390 needles are read here through Store
   (one server's shards), EcVolume.read_needle and EcShardLocator(master)
   with remote EcShardRead answers and no reconstruction, then again after
   the server (other than the reader and server 1) holding the most
   shards is SIGKILLed and pruned by the master (reconstructions > 0);
   ``ec.rebuild`` regenerates its shards on the rebuilder identically
   (temp copies gone, K1 launched there); ``ec.decode`` restores the .dat
   (sha256, and needles read back through Volume once the cluster has
   stopped); the LRC volume is encoded ``-code lrc`` (the master reports
   (10, 4, 2)), shard 3 deleted and rebuilt flag-less, identical, its
   staging copies moving at most 5 shard sizes (the local group, on the
   rebuilder's weedtpu_repair_bytes_total{mode="move"}); every process
   but the killed one exits 0 on SIGTERM.  The walls (encode, balance
   copies, prune wait, rebuild staging and pipeline, decode) and read
   figures go on a ``cluster:`` JSON line.
9. The write path: a fresh ``cli master`` and four ``cli volume -device
   cuda -max 8 -mserver ...`` subprocesses (racks alternating), each with
   its HTTP port bound and registered at the master as ``ip:httpport``;
   the native data plane fronts each (its counters read from each
   server's /metrics ``seaweedfs_volume_native_dp``).
   9a: ``cli benchmark -n 4096 -size 1024 -c 16`` (upstream `weed
   benchmark`'s shape, -n cut 256x for time), 0 errors in its write and
   read reports, native POSTs and GETs > 0; 9b: 1,250 writes at
   replication 001, then every needle read from both holders
   ``/dir/lookup`` names, sha256-equal, with native fan-outs by the
   primaries > 0; 9c: ``cli benchmark -n 4096 -size 65536`` fills one
   256 MiB volume, and 512 needles of seeded payloads go in through
   MasterClient and the pool, every one a native POST; 9d: ``cli shell
   -c "lock; ec.encode -volumeId V -collection ec64k -streaming;
   unlock"`` of that natively written volume: K1 launches on the source
   server equal its generate's batches, the first, a middle and the
   last row of its shards equal the CPU plain version's (ReedSolomonTorch
   over the .dat read before), every shard lands once on its holder (14
   at the master, at most 4 a node, both racks), no .dat, .idx or .tmp
   remains, and the
   targets' received bytes, the generate's stage split and the balance's
   moves are printed; 9e: the 512 seeded needles and 256 benchmark
   needles read over HTTP, each resolved through ``/dir/lookup``, equal to
   their payloads (p50, p99, and the intervals the serving holder had to
   read from others, counted from the .ecx and the census); 9f: 64
   seeded needles DELETEd on the EC volume, then 404.  Its figures go on
   a ``write path:`` JSON line.
10. Master failover: three ``cli master -ha raft -peers m0,m1,m2 -mdir
   ...`` and four ``cli volume -device cuda -max 8 -mserver m0,m1,m2``
   subprocesses (racks alternating), up once one leader is elected and the
   four nodes are at it.  16 writer threads assign through
   ``MasterClient("m0,m1,m2")`` and POST 1 KiB (derived from the fid) at
   replication 001 for 7 s; then whichever master leads is SIGKILLed (its
   place in the list printed) and the writes go on until 7 s after a new
   leader answers.  Printed: the seconds from the kill to the new leader,
   to the four servers at it and to the first acknowledged write assigned
   after the kill; write req/s, p50 and p99 before and after; every write
   error (reported, never dropped).  The killed master restarts on its
   -mdir and must catch up as a follower; ``cli shell -master m0,m1,m2 -c
   cluster.raft.ps`` must list three members and the one leader.  Checks:
   every acknowledged fid and file key unique, every acknowledged needle
   byte-identical from both holders, every volume id's .dat on its copies
   only and no needle id in two volumes (no id issued twice across the
   failover and the restart); ``cli benchmark -master m0,m1,m2 -n 2048
   -size 1024 -c 16`` with 0 errors; ``cli benchmark`` of 1,024 x 64 KiB
   fills one 64 MiB volume, and ``cli shell -master m0,m1,m2 -c "lock;
   ec.encode -volumeId V -collection haec; unlock"`` encodes it with K1 on
   its server's card (launches from its /metrics equal to the generate's
   batches), every shard sha256-identical to the CPU plain version's
   encoding of the same .dat.  Its figures go on a ``failover:`` JSON line.
11. Volume maintenance: a fresh ``cli master`` and four ``cli volume
   -device cuda -max 8 -scrubInterval 0 -scrubRateMB 0`` subprocesses
   (racks alternating; no background scrub pass races the phase's
   counts).  16 writers fill one volume with 1,024 x 64 KiB at
   replication 001 (64 MiB a holder; upstream volumes are 30 GB) and
   40% of it (410 needles) is deleted; ``volume.vacuum
   -garbageThreshold 0.3`` through ``cli shell`` must reclaim on both
   holders exactly the bytes of the records the .idx no longer names and
   raise the superblock's compaction revision to 1, while one writer to
   the volume measures the write-lock stall (p50, p99, max); every
   survivor then reads back equal from both holders and every deleted
   needle answers 404.  A second volume with garbage is compacted by a
   restart of its server with ``-vacuumInterval 2`` (same ports), with no
   shell command.  ``volume.delete`` on one holder and
   ``volume.fix.replication`` restore the copy through VolumeCopy (.dat
   and .idx sha256-identical); one byte in each of 8 records of that copy
   is flipped and ``volume.scrub -volumeId V`` must report 8 corrupt and 8
   repaired and leave its .dat equal to the other holder's; 5 needles
   deleted on one holder only are copied back by ``volume.check.disk``;
   ``volume.move``, ``volume.balance`` and ``volume.server.evacuate``
   follow, each placement checked once the master's census equals the
   .dat files on disk, with sampled needles read back.  ``ec.encode`` of
   the compacted volume must launch K1 on its source server exactly once
   per batch (its /metrics) and give 14 shards sha256-identical to the CPU
   plain version's encoding of the same .dat; a byte flipped in one shard
   interval is rebuilt by ``volume.scrub`` (the holder reports 1 corrupt,
   1 repaired, every other holder 0 corrupt and none FAILED; the shard's
   sha256 is restored; K1 does not launch: the
   repair decodes on the host), and 250 needles read over HTTP
   (``/dir/lookup``, then GET) equal their payloads.  Its figures go on a
   ``maintenance:`` JSON line.
12. Storage options and the tier: a fresh ``cli master`` and four ``cli
   volume -device cuda -scrubInterval 0 -scrubRateMB 0``: A and B
   ``-index leveldb -backend mmap`` (rack r0), C ``-disk ssd -index compact
   -offsetWidth 5`` and D ``-disk mem -backend memory -index compact`` (rack
   r1; the disk tags pin the fills of C and D).  V, 1,024 x 64 KiB at 001
   on A and B (64 MiB a holder; upstream volumes are 30 GB), reads back
   equal from both; A restarts on its ports with a new ``-publicUrl`` (its
   LSM map's mark equals the .idx, so nothing is replayed; the time to the
   first heartbeat is printed); ``cli backup`` lands its holder's .dat and
   .idx byte for byte; ``volume.mark`` and ``volume.tier.upload -node A``
   move A's .dat to a directory object store (the .vif names the object;
   512 reads through TieredFile equal, reads/s and p50/p99 printed; a
   write is refused); A restarts onto the .vif alone and the master lists
   V on it again; ``volume.tier.download`` restores A's .dat sha256-equal
   to what was uploaded; C and D take 512 x 64 KiB at 000 each (C's .idx
   of 17-byte entries whose offsets name their records; 40% of D deleted,
   ``volume.vacuum`` reclaims exactly those records' bytes in memory,
   survivors equal, the deleted 404); ``ec.encode`` of V launches K1 on its
   source exactly once per batch, 14 shards sha256-identical to the CPU
   plain version's.  Its figures go on a ``storage:`` JSON line.  Then the
   host codec (``ReedSolomonCPU`` on csrc/gf256.cpp, which phases 7 and 11
   decode on and name) is held byte-equal to the plain torch codec on a
   10 x 1 MiB encode and a 4-loss rebuild, each timed in µs.
13. The filer: a fresh ``cli master -volumeSizeLimitMB 256``, four ``cli
   volume -device cuda -scrubInterval 0 -scrubRateMB 0`` on two racks and
   ``cli filer -db <dir> -maxMB 4`` (the LSM store; logs under
   ``filer/``).  ``fs.configure`` puts /data/ in collection filerdata; 16
   writers fill it through the filer's HTTP API, bodies streamed from
   --seed: one 128 MiB file (32 chunks), 4 of 4-32 MiB and 256 of 1-64
   KiB over 64 directories (32 of them at most 2 KiB, inline), files/s,
   MB/s and p50/p99 per class; every file reads back sha256-equal, with
   32 Range reads across chunk boundaries of the big file, a 416, a
   HEAD and paged JSON listings equal to the names written, and the
   filer's RSS under FILER_RSS_LIMIT while it moves the big file.  ``cli
   shell -filer``: fs.du equals the bytes written, fs.verify finds 0
   broken, fs.ls and fs.tree run; 64 needles written by ``cli upload`` are
   exactly the orphans ``volume.fsck`` finds (their bytes too), purges
   with ``-reallyDeleteFromVolume -cutoffAgeSeconds 0`` and then finds 0
   of; ``fs.rm -r`` of one directory of 4 files 404s its paths and its
   chunks' fids.  An in-process filer splits one 4 MiB and one 16 KiB
   upload and one 16 KiB read into body read, assign (FidPool hit or
   miss), volume POST, store insert, find_entry, lookup and volume GET.
   The filer restarts on its -db: listings byte-identical, 64 sampled
   reads equal.  ``ec.encode -collection filerdata`` launches K1 in the
   servers exactly once per batch (their /metrics) and every file reads
   back from the shards; the server holding the most data shards is
   SIGKILLed and, once the master prunes it, every file reads back through
   degraded reads (intervals reconstructed); ``ec.rebuild -collection
   filerdata`` launches K1 and 128 files read back; ``cli server -filer
   -device cuda`` takes an upload and a read in one process and stops on
   SIGTERM with rc 0.  Its figures go on ``filer:`` lines.
14. S3 on the card: a fresh ``cli master -volumeSizeLimitMB 256``, four
   ``cli volume -device cuda -scrubInterval 0 -scrubRateMB 0`` on two
   racks, ``cli filer -db <dir>`` and in front ``cli s3 -filer <its gRPC>
   -accessKey K -secretKey S -cacheMB 64 -kmsKeyFile F`` (SigV4 required;
   logs under ``s3/``); every request is signed by ``client_sign``.  Fill:
   16 clients put 128 objects of 1-64 KiB (a quarter as signed
   aws-chunked bodies), and 4 of 8-64 MiB and one of 128 MiB go up as
   multipart in 8 MiB parts, 10 at a time (aws-cli's defaults); objects/s,
   MB/s and p50/p99 per class.  Mixed: MinIO warp mixed's 45% GET, 30%
   HEAD, 15% PUT, 10% DELETE over the small objects, 16 clients, 320
   ops, every answer held to a model of key -> sha256 (404 for a deleted
   key, the ETag on HEAD); a ListObjectsV2 walk (max-keys 1000) equals the
   model.  Features: CopyObject, 16 Range GETs across the 128 MiB object's
   part boundaries, a presigned GET, three versions read by versionId,
   tagging, an anonymous 403 that a bucket policy turns into 200, SSE-S3
   and SSE-C of a 16 MiB object (501 where the card's machine lacks the
   cryptography package), and a bucket frozen by ``s3.bucket.quota.check``.
   Coherence: an overwrite through the filer's HTTP API is seen through the
   gateway (its metadata subscriber; the time printed), and a hot set's
   second GET pass prints the chunk cache's hit ratio from /debug/cachez.
   Splice: the gateway's px counters from its /debug/threadz (spliced GET
   views > 0, the ladder's fallbacks and the px loop mode printed); an
   open-access ``cli s3`` over the same filer takes streaming PUTs of 1,
   8, 8 and 24 MiB objects, each 4 MiB chunk fanned out by the native plane
   (``fanout_ok`` = the chunk count) with ``x-weed-spliced`` and the md5
   ETag, and GETs them back spliced, sha256-equal.
   An in-process gateway splits a 16 KiB aws-chunked PUT, an 8 MiB part
   PUT and a 16 KiB GET into SigV4 verify, body read, aws-chunked decode,
   FidPool, volume POST/GET, filer insert/find and entry-cache hits.
   ``ec.encode -volumeId`` of every volume that holds the buckets launches
   K1 in the servers exactly once per batch; every object reads back
   through S3 from the shards (ETag and sha256); the server holding the
   most data shards is SIGKILLed and, once pruned, every object reads back
   degraded; ``ec.rebuild`` launches K1 and 128 objects read back; the
   gateway restarts before each of those passes, so that its chunk cache
   cannot answer for the shards.  ``cli server -filer -s3 -device cuda``
   takes a signed PUT and GET in one process and stops on SIGTERM with rc
   0.  Its figures go on ``s3:`` lines.
15. The RPC and observability layers: ``cli tls.gen`` mints a CA and a node
   certificate for 127.0.0.1; phase 14's cluster shape (``cli master
   -volumeSizeLimitMB 256``, four ``cli volume -device cuda`` on two racks,
   ``cli filer -db``, ``cli s3 -filer ... -tlsCert -tlsKey -kmsKeyFile``,
   SigV4) runs with ``WEEDTPU_TLS_*`` (every gRPC hop mutual TLS; logs under
   ``tls/``), a ``-metricsPort`` each, one ``WEED_FAULTS`` spec and seed
   (UNAVAILABLE on 2% of the volume servers' EcShardRead calls and of the
   gateway's LookupDirectoryEntry calls, a 2 ms delay on 5% of the filer's
   gRPC) and a ``WEED_SLO``; plaintext gRPC, plain HTTP and a client that
   does not trust the CA are refused.  Over HTTPS, 128 objects of 1-64
   KiB at 16 clients and one 128 MiB object as multipart; one PUT sent with
   a traceparent is one trace in the gateway (PutObject, its put_chunk),
   the filer (CreateEntry, the PutObject's child) and the volume server
   holding the chunk (the native plane's ``native_dp`` post span, replayed
   from its span records; a ``volume`` write span when the POST forwards),
   printed by ``trace.dump``; ``cluster.status``
   over the seven metrics listeners merges an s3.put count equal to the
   members' /debug/sketchz sum and to the PUTs sent; ``slo.status`` passes.
   ``ec.encode`` of every volume over mutual TLS (the shell traced by
   ``TRACEPARENT``) launches K1 once per batch (the servers' /metrics) and
   each source's EcShardsGenerate span, which ``trace.dump`` prints, covers
   its generate; every object
   reads back ETag- and sha256-equal from the shards and, after a SIGKILL
   of the holder of shard 0, degraded, with every fault rule fired and 0
   client-visible errors.
   ``fault.inject`` of UNAVAILABLE x6 on a live peer's VolumeStatus walks
   its breaker open -> half-open -> open -> half-open -> closed
   (``cluster.check``, ``resilience.status``, ``events.dump``).  A server
   restarted with ``disk@*.dat:append:torn:x1`` (its volumes stay off the
   native plane while the rule is armed) answers 500 to a write;
   restarted without it, its .dat is truncated back and every acknowledged
   write reads back.  Its figures go on ``tls:`` lines.  What TLS and
   tracing cost a request is ``chip_layer_costs.py``'s to measure.
16. The sharded filer and the worker-group gateway: ``cli master
   -volumeSizeLimitMB 256``, four ``cli volume -device cuda`` on two racks,
   three ``cli filer -db`` shards on fixed ports and ``cli s3 -filer
   f1,f2,f3 -workers 4 -port <fixed> -cacheMB 64 -metricsPort <base>``
   (SigV4; logs under ``shard/``; every wait for a line has a deadline).
   Routing: 128 objects of 1-64 KiB over 64 buckets and 4 of 8-64 MiB
   as multipart (S3_PART parts, 10 at a time) by 16 clients; objects and
   entries per shard from ``filer.shard.status`` and each shard's hash
   share; every bucket and its entries sit on the shard ``ShardRing``
   names and on no other.  The worker group's PUT and GET rates, p50/p99,
   and each worker's request count from its own ``-metricsPort``.
   Coherence: 32 overwrites, each read on fresh connections until 16
   answers in a row carry the new ETag (the worst delay after the PUT's
   200 printed and held under 250 ms, a datagram round trip and not the
   2 s TTL or subscriber pass; every worker answered; each worker's
   invalidation-bus datagrams, from its ``/metrics``, cover every
   overwrite).  IAM: ``s3.configure -apply`` over
   the shard list, ``cli iam`` (``filer_etc``) lists the user and mints a
   second key, and an in-process gateway with
   ``FilerEtcCredentialStore(ShardedFilerClient)`` takes a PUT signed with
   it and refuses an unknown key (403).  A signed browser form POST (204)
   and one that breaks a condition (403); SelectObjectContent over a CSV
   and a JSON-lines object equals a plain Python filter.  One filer shard
   SIGKILLed: ListObjectsV2 of its buckets answers 503 with Retry-After,
   of every other bucket 200; restarted on its -db, its buckets serve
   again.  ``shell -filer f1,f2,f3 -c "lock; ec.encode ..."`` of every
   volume launches K1 exactly once per batch (the servers' /metrics); the
   worker group restarts (SIGTERM forwarded, rc 0) and every object reads
   back from the shards, ETag- and sha256-equal.  Its figures go on
   ``shard:`` lines.
17. The maintenance plane, with no shell command: ``cli master
   -volumeSizeLimitMB 256``, four ``cli volume -device cuda`` on two racks,
   ``cli admin -adminPassword -configFile`` (upstream's -ecFullPercent 95
   and -garbageThreshold 0.3; -scanInterval 1 and -ecQuietSeconds 3, cut
   from 30 and 3600 for the run's time) and two ``cli worker
   -adminPassword`` (logs under ``admin/``); at the start and after every
   task, the volume servers have libcuda mapped and the admin and the
   workers never do, nor does nvidia-smi list them.  Two volumes grown by
   ``VolumeGrow`` (000) are filled past 95% with 64 KiB needles from 16
   clients (their .dat linked aside first) and a 001 volume of 64 MB loses
   40% of its needles.  The scanner's EC_ENCODE tasks, run by the workers,
   launch K1 in the generating servers once per stripe batch and spread
   the shards; every shard's sha256 equals the plain torch version's
   (``ReedSolomonTorch`` on the card) encoding of the linked .dat, and a
   sample reads back from the shards.  Its VACUUM runs on both holders of
   the 001 volume (bytes reclaimed; live needles 200, deleted 404).  One
   shard holder is SIGKILLed: the master drops it, two scans see the
   volumes degraded, EC_REBUILD restores 14 shards each (K1 in the
   rebuilder), sha256-equal, and the sample reads back.  The admin API
   answers 401 without credentials and 200 after a login; ``/status``
   counts every task completed and none failed; the dashboard renders; a
   policy edit survives an admin restart.  Its figures go on ``admin:``
   lines.
18. Replication, notification and remote storage: cluster A (``cli
   master -volumeSizeLimitMB 256``, two ``cli volume`` on the default
   device, ``cli filer -db redis://... -notify log:... -metaLogDir``) and
   cluster B (phase 13's shape, ``cli filer -db etcd://...``, ``cli s3``
   with one SigV4 identity); the Redis and etcd servers are
   tests/mini_redis.py and tests/mini_etcd.py hosted in this process (logs
   under ``sync/``).  /sync in collection syncdata is filled in phase 13's
   classes (256 files of 1-64 KiB over 64 directories, 32 inline; 4 of
   4-32 MiB; one of 128 MiB); ``cli filer.sync`` replays the history into
   B, follows 32 overwrites, 32 deletes, 8 renames and an ``fs.rm -r``
   (the source ack -> visible-at-B delay of 64 small writes, p50 and
   p99), is SIGKILLed in the middle of 64 writes and resumes on its
   checkpoint (the events applied again printed); B equals A in paths,
   sizes and sha256s after the history and the resume (after the
   mutations, paths and sizes, and the changed files' sha256s).  A's filer restarts on its store
   (listings byte-identical, a sample equal) and the syncer follows it;
   the ``-notify`` log holds exactly the timestamps ``cli
   filer.meta.tail`` prints, in order; ``cli filer.backup -sink s3://...
   -once`` fills bucket backup through B's gateway (every object equal by
   a signed GET), run beside the ``-notify`` check, the remote.* commands
   and the encode; ``remote.mount``, ``remote.meta.sync``, ``remote.cache``
   (MB/s), ``remote.uncache`` and ``remote.unmount`` of a local-dir
   remote (64 small objects and one of 64 MiB, then 8 more) print the JAX
   shell's lines and read back equal; and ``ec.encode -collection
   syncdata`` on B launches K1 once per stripe batch in B's servers, one
   volume's 14 shards equal ReedSolomonTorch's on the card, and every
   synced file reads back from the shards.  Its figures go on ``sync:``
   lines.
19. The file gateways and the message queue: phase 13's cluster shape,
   its ``cli filer -db <lsm dir>`` with ``-notify mq://<broker>/filer-events``,
   two ``cli mq.broker -master -filer`` (the JAX default ``-replication 2``)
   started before the filer, and ``cli webdav`` (logs under
   ``gateways/``).  WebDAV: MKCOL, PUT of phase 13's classes (128 files of
   1-64 KiB over 16 directories, 16 inline; 2 of 4-32 MiB; one of 128 MiB)
   by 16 writers, PROPFIND depth 1 sizes, every GET sha256-equal, a Range
   read, MOVE of a directory, COPY, DELETE then 404.  The mount
   (``WeedFS`` in the smoke's process, chunk 4 MiB; ``cli mount`` refuses
   without FUSE): random-offset overlapping writes, a truncate to 0 and a
   rename equal a numpy model; a file crosses mount -> WebDAV and WebDAV ->
   mount; the delay from a WebDAV overwrite until the mount reads it
   (p50, max) stays under the 5 s cache TTL.  The queue:
   ``mq.topic.configure`` of 4 partitions; ``cli mq.benchmark`` at its
   defaults (5,000 x 1 KiB, ``-c 8``) from the brokers' start until the
   encode has run; 768 records of 64 KiB over 64 keys (records/s, MB/s), every
   partition past one 8 MiB segment; ``mq.topic.compact`` beside the mount
   and ``SealSegments(evict)``: every partition's archive in the filer's
   /topics (collection mqtier), none left on its owner's disk.
   ``ec.encode`` of the default and mqtier collections launches K1 once
   per stripe batch in the servers.  The filer-events topic holds exactly
   the filer's events (SubscribeMetadata from 0, each partition in stamp
   order).  The owner broker of partition 0 is SIGKILLed after 64 of 256
   more acknowledged records, and with it the holder of most of one
   volume's shards: every acknowledged record reads back and the offsets
   continue; after the prune, mount and WebDAV reads of a sample stay
   sha256-equal and the volume's 14 shards equal ReedSolomonTorch's on the
   card; a two-member ``GroupConsumer`` reads every record once, in
   per-partition offset order, the evicted archives through the filer from
   degraded EC shards.  Its figures go on ``gateways:`` lines.

Bounds: the larger of the bytes a function must move over the memory rate
and its operations at 64 32-bit logic ops a clock per SM, from the card's SM
count and its clocks.max.sm.  The operations are those of the cheapest
formulation the port has.  K2's are the GF(2) matrix's word XORs: the
lesser of one per set bit and the table apply's count (csrc/gf_table.cuh:
11 per input row and half to build its table, then one per output plane,
input row and half; 860 against 1224 set bits per 32 bytes at 10 -> 4 with
the RS(10,4) encode matrix).  K3/K4's are the 72-op transpose, and K1's
(the same GF(2^8) apply) pack, those XORs and unpack.  Bytes set every
bound here.

The line before the last holds the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  It needs CUDA: without it, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import faulthandler
import hashlib
import http.client
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor

MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
LOGIC_OPS_PER_CLOCK_PER_SM = 64  # 32-bit integer logic ops, compute capability 9.0
TRANSPOSE_OPS_PER_32_BYTES = 72  # gf_planes.cu: 3 delta-swap stages of 4 x 6 ops
HOP_SETS = [(0,), (3,), (10,), (13,), (0, 3, 10, 13)]
LRC_HOP_SETS = [(12,), (13,), (12, 13), (0, 5, 12, 13)]
LRC_REBUILDS = [  # lost shards, plan mode, plan inputs
    ((3,), "local", (0, 1, 2, 4, 10)),
    ((3, 7), "local", (0, 1, 2, 4, 5, 6, 8, 9, 10, 11)),
    ((0, 5, 12, 13), "global", (1, 2, 3, 4, 6, 7, 8, 9, 10, 11)),
]
LRC_UNRECOVERABLE = (0, 1, 10, 13)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# the run's limit is 1200 s, builds included: past SMOKE_DEADLINE_S the smoke
# fails by itself, with its stacks and the servers' logs on stderr; a phase
# past PHASE_STALL_S (about twice the longest phase) dumps the stacks once
SMOKE_DEADLINE_S = 1170.0
PHASE_STALL_S = 300.0
RUN_T0 = time.perf_counter()


def progress(msg: str) -> None:
    """One line on stderr, with the wall-clock time and the run's seconds,
    so that the end of stderr says how far a run got."""
    print(f"chip_smoke {time.strftime('%H:%M:%S')} +{time.perf_counter() - RUN_T0:.1f}s: {msg}",
          file=sys.stderr, flush=True)


def use_bytecode_cache() -> None:
    """Keep compiled bytecode under build/pycache for this process and every
    one it starts.  Where the environment sets PYTHONDONTWRITEBYTECODE and
    the installed packages carry no __pycache__, as on the card's machine,
    every process compiles torch's sources anew at import (7 s alone, 9 s
    four at a time there); with the cache only the first one does."""
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix = cache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.dont_write_bytecode = False


def _descendants(pid: int) -> list[int]:
    """Every live descendant of ``pid``, from the parent links in /proc."""
    children: dict = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(name))
    out, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            out.append(child)
            todo.append(child)
    return out


def arm_deadline() -> None:
    """Fail the run at SMOKE_DEADLINE_S: every descendant gets SIGABRT (the
    Python ones dump their threads into their logs, PYTHONFAULTHANDLER),
    then the tails of the live servers' logs and this process's stacks go
    to stderr, every descendant is killed and the smoke exits 1."""
    os.environ["PYTHONFAULTHANDLER"] = "1"  # inherited by every subprocess

    def expire() -> None:
        print(f"FAIL: the smoke ran past its own deadline of {SMOKE_DEADLINE_S:.0f}s", flush=True)
        kids = _descendants(os.getpid())
        for pid in kids:
            with contextlib.suppress(OSError):
                os.kill(pid, signal.SIGABRT)
        time.sleep(2.0)
        for server in list(_Server.live):
            with contextlib.suppress(OSError, ValueError):
                print(f"--- {server.log} (pid {server.proc.pid}), its end:\n"
                      f"{server.log_text()[-1500:]}", file=sys.stderr)
        progress("deadline: this process's threads follow")
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        for pid in kids + _descendants(os.getpid()):
            with contextlib.suppress(OSError):
                os.kill(pid, signal.SIGKILL)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)

    timer = threading.Timer(SMOKE_DEADLINE_S - (time.perf_counter() - RUN_T0), expire)
    timer.daemon = True
    timer.start()


def nvidia_smi(query: str, *fmt: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader" + "".join(fmt)],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def gpu_identity() -> str:
    return nvidia_smi("name,power.limit")


def card_rates() -> dict:
    """Logic-op rate of card 0: the per-SM rate times SMs times the most the
    SM clock may run (clocks.max.sm)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm", ",nounits")) * 1e6
    return dict(sms=sms, clock_hz=clock_hz,
                logic_ops_per_s=sms * LOGIC_OPS_PER_CLOCK_PER_SM * clock_hz)


def demangle(mangled: str) -> str:
    """'_ZN12_GLOBAL__N_115gf_apply_kernelILi4EEEv...' -> 'gf_apply_kernel<4>'."""
    i, name = 0, mangled
    while m := re.compile(r"(\d+)").search(mangled, i):
        start, size = m.end(), int(m.group(1))
        part = mangled[start : start + size]
        if part.endswith("_kernel"):
            args = re.match(r"I((?:Li\d+E)+)E", mangled[start + size :])
            values = re.findall(r"Li(\d+)E", args.group(1)) if args else []
            name = part + (f"<{','.join(values)}>" if values else "")
            break
        i = start + max(size, 1)
    return name


def ptxas_report(log: str) -> list[dict]:
    """Registers and spill bytes of every kernel in an `nvcc -Xptxas -v` log."""
    kernels = []
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            kernels.append(dict(kernel=demangle(m.group(1)), registers=None, spill_bytes=0))
        elif kernels and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            kernels[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif kernels and (m := re.search(r"Used (\d+) registers", line)):
            kernels[-1]["registers"] = int(m.group(1))
    return kernels


def zero_launch_counts() -> None:
    from seaweedfs_tpu_torch.ops import rs_cuda

    rs_cuda.launches = rs_cuda.pack_launches = rs_cuda.unpack_launches = 0
    rs_cuda.plane_launches = 0


def launch_counts() -> dict:
    from seaweedfs_tpu_torch.ops import rs_cuda

    return {"gf_apply": rs_cuda.launches, "gf_pack": rs_cuda.pack_launches,
            "gf_planes_apply": rs_cuda.plane_launches, "gf_unpack": rs_cuda.unpack_launches}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of one call: iters calls captured in a CUDA graph (after
    one call outside it, which uploads and caches what the call needs) and
    replayed once warm and once between CUDA events."""
    import torch

    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """Least time for work that moves n_bytes (inputs read once, outputs
    written once) and does ops operations on a unit of ops_per_s."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def xors_per_32_bytes(matrix) -> int:
    """Word XORs of the matrix's cheapest GF(2) program per 32 bytes of row
    (a plane word holds 4 bytes of each of 8 planes): the lesser of one per
    set bit and the table apply's 11 per (input row, half) plus one per
    (output plane, input row, half)."""
    from seaweedfs_tpu_torch.ops import gf256

    r, s = matrix.shape
    return min(int(gf256.matrix_to_gf2(matrix).sum()), 2 * s * (11 + 8 * r))


def k1_bound(matrix, n: int, rates: dict) -> tuple[float, str]:
    """K1 over n-byte rows: (s + r) n bytes; as logic ops, the bit-slice
    form of the same apply: pack s rows, the XORs, unpack r rows."""
    r, s = matrix.shape
    ops = ((s + r) * TRANSPOSE_OPS_PER_32_BYTES + xors_per_32_bytes(matrix)) * n / 32
    return bound_ms((s + r) * n, ops, rates["logic_ops_per_s"])


def k2_bound(matrix, n: int, rates: dict) -> tuple[float, str]:
    """K2 over n-byte plane rows: (s + r) n bytes; the XORs as logic ops."""
    r, s = matrix.shape
    return bound_ms((s + r) * n, xors_per_32_bytes(matrix) * n / 32, rates["logic_ops_per_s"])


def transpose_bound(rows: int, n: int, rates: dict) -> tuple[float, str]:
    """K3 or K4 over n-byte rows: 2 rows n bytes; the transpose's logic ops."""
    return bound_ms(2 * rows * n, TRANSPOSE_OPS_PER_32_BYTES * rows * n / 32,
                    rates["logic_ops_per_s"])


# -- phase 2 ------------------------------------------------------------------


def loss4_matrix(lost: tuple[int, ...]):
    from seaweedfs_tpu_torch.ops import rs_matrix

    present = tuple(i not in lost for i in range(14))
    return rs_matrix.reconstruction_matrix(10, 4, present, lost)[0]


def lrc_plan(lost: tuple[int, ...], targets: tuple[int, ...] | None = None):
    """(matrix, inputs, mode) of LRC(10,2,2) rebuilding ``targets`` (default:
    all of ``lost``) with ``lost`` absent."""
    from seaweedfs_tpu_torch.ops import lrc_matrix

    present = tuple(i not in lost for i in range(14))
    return lrc_matrix.reconstruction_plan(10, 2, 2, present, targets or lost)


def kernel_cases():
    from seaweedfs_tpu_torch.ops import lrc_matrix, rs_matrix, xor_sched

    enc = rs_matrix.build_encode_matrix(10, 4)
    one = tuple(i != 3 for i in range(14))
    stack12, _rows = xor_sched.stack_matrices(
        [loss4_matrix(lost) for lost in [(0, 3, 10, 13), (1, 2, 11, 12), (4, 5, 6, 7)]])
    return [
        ("rs10_4_encode", enc[10:]),
        ("rs10_4_rebuild_1loss", rs_matrix.reconstruction_matrix(10, 4, one, (3,))[0]),
        ("rs10_4_rebuild_4loss", loss4_matrix((0, 3, 10, 13))),
        ("rs6_3_encode", rs_matrix.build_encode_matrix(6, 3)[6:]),
        ("rs12_4_encode", rs_matrix.build_encode_matrix(12, 4)[12:]),
        ("cauchy10_4_encode", rs_matrix.build_cauchy_matrix(10, 4)[10:]),
        ("rs10_4_3x4loss_stack", stack12),
        ("lrc10_2_2_encode", lrc_matrix.build_lrc_matrix(10, 2, 2)[10:]),
        ("lrc10_2_2_local_1loss", lrc_plan((3,))[0]),
        ("lrc10_2_2_local_2groups", lrc_plan((3, 7))[0]),
        ("lrc10_2_2_global_4loss", lrc_plan((0, 5, 12, 13))[0]),
    ]


def phase_kernel(rng, dev, rates) -> dict:
    import numpy as np
    import torch

    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.ops.rs_torch import apply_matrix_reference

    max_err = 0
    n_checked = 0
    for name, mat in kernel_cases():
        r, s = mat.shape
        inputs = []
        for width in (1, 3, 4097, 6 * MIB):
            inputs.append((f"random w={width}", torch.from_numpy(
                rng.integers(0, 256, (s, width), dtype=np.uint8)).to(dev)))
        ramp = (np.arange(4097)[None, :] + 37 * np.arange(s)[:, None]) % 256
        inputs.append(("all byte values w=4097",
                       torch.from_numpy(ramp.astype(np.uint8)).to(dev)))
        wide = torch.from_numpy(rng.integers(0, 256, (s, 4101), dtype=np.uint8)).to(dev)
        inputs.append(("unaligned strided view w=4097", wide[:, 1:4098]))
        words = torch.from_numpy(rng.integers(0, 256, (s, 4096), dtype=np.uint8)).to(dev)
        inputs.append(("uint32 words W=1024", words.view(torch.uint32)))
        for label, x in inputs:
            got = rs_cuda.apply_matrix_cuda(mat, x)
            raw = x.view(torch.uint8) if x.dtype == torch.uint32 else x
            want = apply_matrix_reference(mat, raw)
            got_b = got.view(torch.uint8) if got.dtype == torch.uint32 else got
            torch.cuda.synchronize()
            err = int((got_b.int() - want.int()).abs().max().item())
            max_err = max(max_err, err)
            n_checked += 1
            check(err == 0 and got.dtype == x.dtype,
                  f"kernel != plain: {name} {label} (max abs err {err})")
        print(f"  {name} ({r}x{s}): byte-exact on {len(inputs)} inputs")
    check(rs_cuda.launches >= n_checked, f"launches {rs_cuda.launches} < {n_checked}")
    print(f"kernel checks: {n_checked} byte-exact, launches={rs_cuda.launches}, "
          f"max_abs_err={max_err}")

    cases = dict(kernel_cases())
    timings = {}
    for key, name, width in [(6 * MIB, "rs10_4_encode", 6 * MIB),
                             (64 * MIB, "rs10_4_encode", 64 * MIB),
                             ("rebuild_4loss", "rs10_4_rebuild_4loss", 64 * MIB),
                             ("lrc_local_1loss", "lrc10_2_2_local_1loss", 64 * MIB),
                             ("lrc_local_2groups", "lrc10_2_2_local_2groups", 64 * MIB)]:
        mat = cases[name]
        r, s = mat.shape
        x = torch.from_numpy(rng.integers(0, 256, (s, width), dtype=np.uint8)).to(dev)
        ms = time_ms(lambda: rs_cuda.apply_matrix_cuda(mat, x), iters=20)
        g_ms = graph_ms(lambda: rs_cuda.apply_matrix_cuda(mat, x), iters=20)
        plain_ms = time_ms(lambda: apply_matrix_reference(mat, x), iters=3, warmup=1)
        b_ms, b_by = k1_bound(mat, width, rates)
        timings[key] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"timing {name} {s}x{width // MIB}MiB->{r}: kernel {ms:.6f} ms "
              f"({((s + r) * width) / ms / 1e6:.1f} GB/s), in a CUDA graph {g_ms:.6f} ms, "
              f"plain {plain_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}), kernel at "
              f"{100 * b_ms / ms:.1f}% of bound ({100 * b_ms / g_ms:.1f}% in the graph)")
    return dict(max_err=max_err, timings=timings)


def plane_cases() -> dict:
    """K2's matrices: K1's cases but RS(12,4) (with the 12-row stack), the
    stack of the five RS(10,4) target sets of phase 4 and the stack of the
    four LRC(10,2,2) target sets of phase 5 (8 output rows each)."""
    from seaweedfs_tpu_torch.ops import rs_matrix, xor_sched

    cases = {name: mat for name, mat in kernel_cases() if name != "rs12_4_encode"}
    present = tuple(i not in HOP_SETS[-1] for i in range(14))
    cases["rs10_4_5set_stack"], _rows = xor_sched.stack_matrices(
        [rs_matrix.reconstruction_matrix(10, 4, present, ts)[0] for ts in HOP_SETS])
    cases["lrc10_2_2_4set_stack"], _rows = xor_sched.stack_matrices(
        [lrc_plan(LRC_HOP_SETS[-1], ts)[0] for ts in LRC_HOP_SETS])
    return cases


def max_abs_err(got, want) -> int:
    import torch

    return int((got.view(torch.uint8).int() - want.view(torch.uint8).int()).abs().max().item())


def shard_chunks(dat_size: int) -> list[tuple[int, int]]:
    """(offset, bytes) of the rebuild pipeline's chunks over one shard of a
    volume of small rows only."""
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import DEFAULT_CHUNK
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME as sc

    blk = sc.small_block_size
    shard = -(-dat_size // (blk * sc.data_shards)) * blk
    return [(off, min(DEFAULT_CHUNK, shard - off)) for off in range(0, shard, DEFAULT_CHUNK)]


def phase_planes(rng, dev, rates, ident: str, widths: list[int]) -> dict:
    import numpy as np
    import torch

    from seaweedfs_tpu_torch.ops import rs_cuda, rs_torch

    bw = rs_torch.BLOCK_WORDS
    errs = {"pack": 0, "unpack": 0, "apply": 0}
    n_checked = 0

    def held(kind: str, got, want, label: str) -> None:
        nonlocal n_checked
        err = max_abs_err(got, want)
        errs[kind] = max(errs[kind], err)
        n_checked += 1
        check(err == 0 and got.shape == want.shape and got.dtype == torch.uint32,
              f"{kind} kernel != plain: {label} (max abs err {err})")

    cases = plane_cases()
    for name, mat in cases.items():
        r, s = mat.shape
        inputs = [(f"random {b} block(s)", torch.from_numpy(
            rng.integers(0, 2**32, (s, b * bw), dtype=np.uint32)).to(dev)) for b in (1, 2, 3)]
        ramp = (np.arange(2 * bw * 4)[None, :] + 37 * np.arange(s)[:, None]) % 256
        inputs.append(("all byte values, 2 blocks",
                       torch.from_numpy(ramp.astype(np.uint8)).to(dev).view(torch.uint32)))
        for label, x in inputs:
            planes = rs_cuda.pack_words(x)
            held("pack", planes, rs_torch.pack_words_reference(x), f"{name} {label}")
            held("unpack", rs_cuda.unpack_words(planes), x, f"{name} {label}: unpack(pack(x))")
            out = rs_cuda.apply_matrix_planes(mat, planes)
            held("apply", out, rs_torch.apply_matrix_planes_reference(mat, planes), f"{name} {label}")
            held("unpack", rs_cuda.unpack_words(out), rs_torch.unpack_words_reference(out),
                 f"{name} {label}")
        print(f"  {name} ({r}x{s}): pack, plane apply, unpack byte-exact on {len(inputs)} inputs")
    print(f"plane kernel checks: {n_checked} byte-exact, launches pack={rs_cuda.pack_launches} "
          f"apply={rs_cuda.plane_launches} unpack={rs_cuda.unpack_launches}, max_abs_err={errs}")

    # The hop's shapes: each chunk width, 10 survivor rows, the 8-row stack
    # and its per-set slices, as reconstruct_words_multi launches them.
    enc, stack = cases["rs10_4_encode"], cases["rs10_4_5set_stack"]
    lrc_stack = cases["lrc10_2_2_4set_stack"]
    widest = torch.from_numpy(
        rng.integers(0, 2**32, (10, max(64 * MIB, *widths) // 4), dtype=np.uint32)).to(dev)
    for width in widths:
        x = widest[:, : width // 4].contiguous()
        label = f"10x{width / MIB:g}MiB"
        planes = rs_cuda.pack_words(x)
        held("pack", planes, rs_torch.pack_words_reference(x), label)
        back = rs_cuda.unpack_words(planes)
        held("unpack", back, rs_torch.unpack_words_reference(planes), label)
        check(torch.equal(back, x), f"unpack(pack(x)) != x at {label}")
        held("apply", rs_cuda.apply_matrix_planes(enc, planes),
             rs_torch.apply_matrix_planes_reference(enc, planes), f"{label} -> 4")
        for stack_name, mat, sets in [("RS", stack, HOP_SETS), ("LRC", lrc_stack, LRC_HOP_SETS)]:
            out = rs_cuda.apply_matrix_planes(mat, planes)
            held("apply", out, rs_torch.apply_matrix_planes_reference(mat, planes),
                 f"{label} -> 8 ({stack_name} stack)")
            row = 0
            for ts in sets:
                part = out[row : row + len(ts)]
                held("unpack", rs_cuda.unpack_words(part), rs_torch.unpack_words_reference(part),
                     f"{label} {stack_name} set {ts}")
                row += len(ts)
        print(f"  {label}: pack, K2 -> 4 and -> 8 (RS and LRC stacks), unpack of 10 rows and "
              f"of the {len(HOP_SETS)} RS and {len(LRC_HOP_SETS)} LRC sets' slices byte-exact")
    print(f"plane kernel checks at the hop's widths: {n_checked} byte-exact in all, "
          f"max_abs_err={errs}")

    width = 64 * MIB
    x = widest[:, : width // 4].contiguous()
    planes = rs_cuda.pack_words(x)
    timings = {}
    for key, fn, plain, (b_ms, b_by) in [
        ("pack", lambda: rs_cuda.pack_words(x), lambda: rs_torch.pack_words_reference(x),
         transpose_bound(10, width, rates)),
        ("unpack", lambda: rs_cuda.unpack_words(planes),
         lambda: rs_torch.unpack_words_reference(planes), transpose_bound(10, width, rates)),
        ("apply_4", lambda: rs_cuda.apply_matrix_planes(enc, planes),
         lambda: rs_torch.apply_matrix_planes_reference(enc, planes), k2_bound(enc, width, rates)),
        ("apply_8", lambda: rs_cuda.apply_matrix_planes(stack, planes),
         lambda: rs_torch.apply_matrix_planes_reference(stack, planes),
         k2_bound(stack, width, rates)),
        ("apply_8_lrc", lambda: rs_cuda.apply_matrix_planes(lrc_stack, planes),
         lambda: rs_torch.apply_matrix_planes_reference(lrc_stack, planes),
         k2_bound(lrc_stack, width, rates)),
    ]:
        ms = time_ms(fn, iters=20)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        timings[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"timing {key} 10x64MiB on {ident}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"bound {b_ms:.6f} ms ({b_by}), kernel at {100 * b_ms / ms:.1f}% of bound")

    def hop():
        return rs_cuda.unpack_words(rs_cuda.apply_matrix_planes(enc, rs_cuda.pack_words(x)))

    def k1():
        return rs_cuda.apply_matrix_cuda(enc, x)

    check(torch.equal(hop(), k1()), "pack + K2 + unpack != K1 at 10x64MiB->4")
    runs = [time_ms(k1, 20), time_ms(hop, 20), time_ms(hop, 20), time_ms(k1, 20)]
    k1_ms, hop_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
    print(f"pack + K2 + unpack vs K1 at 10x64MiB->4 on {ident}: {hop_ms:.6f} ms vs "
          f"{k1_ms:.6f} ms (runs K1, hop, hop, K1: {', '.join(f'{t:.6f}' for t in runs)}), "
          f"ratio {hop_ms / k1_ms:.3f}")
    return dict(errs=errs, timings=timings, hop_ms=hop_ms, k1_ms=k1_ms)


# -- phase 3 ------------------------------------------------------------------


def make_volume(directory: str, size: int, seed: int) -> bytes:
    """A version-3 .dat of ``size`` bytes (superblock + seeded payload) and
    a strict-valid .idx of a few thousand entries (with some deletions)
    inside it, the last live needle ending at the .dat's last byte, so a
    decode restores the .dat whole.  Returns the .ecx bytes the encode must
    produce."""
    import numpy as np

    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
    from seaweedfs_tpu_torch.storage.types import Version, get_actual_size

    check(size % 8 == 0, f"a volume of {size} bytes does not end on a needle boundary")
    rng = np.random.default_rng(seed)
    with open(os.path.join(directory, "1.dat"), "wb") as f:
        f.write(SuperBlock().to_bytes())  # version 3
        left = size - SUPER_BLOCK_SIZE
        while left:
            piece = min(left, 64 * MIB)
            f.write(rng.bytes(piece))
            left -= piece
    n = 4096
    ids = rng.permutation(np.unique(rng.integers(1, 1 << 40, 2 * n, dtype=np.uint64))[:n])
    # every needle ends below size - 4096 (the largest is 4131 bytes long)
    offsets = np.sort(rng.integers(1, (size - 8192) // 8, n)).astype(np.uint32)
    sizes = rng.integers(1, 4096, n).astype(np.int32)
    entry = np.dtype([("id", ">u8"), ("off", ">u4"), ("size", ">i4")])
    puts = np.empty(n + 1, entry)
    puts["id"][:n], puts["off"][:n], puts["size"][:n] = ids, offsets, sizes
    last = 1000  # bytes of the needle that ends the volume
    puts[n] = (1 << 40, (size - get_actual_size(last, Version.V3)) // 8, last)
    dead = rng.choice(n, 64, replace=False)
    tombs = np.empty(64, entry)
    tombs["id"], tombs["off"], tombs["size"] = ids[dead], 0, -1
    with open(os.path.join(directory, "1.idx"), "wb") as f:
        f.write(puts.tobytes() + tombs.tobytes())
    live = np.delete(puts, dead)
    return live[np.argsort(live["id"].astype(np.uint64))].tobytes()


def run_cli(argv: list[str], stages: bool = True) -> dict:
    """Run the port's CLI in this process; echo its output and return the
    stage breakdown it printed (or {} when ``stages`` is false)."""
    from seaweedfs_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print("".join(f"  | {line}\n" for line in out.splitlines()), end="")
    check(rc == 0, f"{argv[0]} exited {rc}")
    found = [line[len("stages: "):] for line in out.splitlines() if line.startswith("stages: ")]
    if not stages:
        check(not found, f"{argv[0]} printed a stage breakdown")
        return {}
    check(len(found) == 1, f"{argv[0]} printed no stage breakdown")
    return json.loads(found[0])


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(16 * MIB):
            h.update(chunk)
    return h.hexdigest()


def check_parity(base: str, dat_size: int, codec) -> int:
    """Parity of the first, a middle and the tail small row, recomputed on
    the CPU by ``codec`` (the plain PyTorch codec of the volume's storage
    class, on the CPU) over whole 1 MiB blocks."""
    import numpy as np

    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME as sc

    k, m, blk = codec.data_shards, codec.parity_shards, sc.small_block_size
    check(codec.device.type == "cpu", f"parity reference on {codec.device}")
    check(dat_size <= sc.large_block_size * k, "volume has large rows; sampler assumes small rows")
    n_rows = -(-dat_size // (blk * k))
    with open(base + ".dat", "rb") as dat:
        for row in sorted({0, n_rows // 2, n_rows - 1}):
            data = np.zeros((k, blk), dtype=np.uint8)
            for i in range(k):
                got = os.preadv(dat.fileno(), [memoryview(data[i])], (row * k + i) * blk)
                check(got == blk or (row == n_rows - 1), f"short .dat read in row {row}")
            want = codec.encode(data)
            for sid in range(k + m):
                with open(base + f".ec{sid:02d}", "rb") as f:
                    f.seek(row * blk)
                    shard = np.frombuffer(f.read(blk), dtype=np.uint8)
                expect = data[sid] if sid < k else want[sid - k]
                check(np.array_equal(shard, expect), f"shard {sid} wrong in row {row}")
            print(f"  row {row}/{n_rows}: {k} data + {m} parity blocks of 1 MiB match the CPU "
                  f"plain version ({type(codec).__name__})")
    return n_rows


def sample_rows(dat: str, dat_size: int) -> dict:
    """{row: (10, 1 MiB) data} of the first, a middle and the tail small
    row of an RS(10,4) volume's .dat, read before the .dat goes away."""
    import numpy as np

    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME as sc

    k, blk = sc.data_shards, sc.small_block_size
    check(dat_size <= sc.large_block_size * k, "volume has large rows; sampler assumes small rows")
    n_rows = -(-dat_size // (blk * k))
    out = {}
    with open(dat, "rb") as f:
        for row in sorted({0, n_rows // 2, n_rows - 1}):
            data = np.zeros((k, blk), dtype=np.uint8)
            for i in range(k):
                os.preadv(f.fileno(), [memoryview(data[i])], (row * k + i) * blk)
            out[row] = data
    return out


def check_sampled_parity(rows: dict, shard_path: dict) -> None:
    """The shard files at ``shard_path`` against ``rows`` (sample_rows) and
    their parity from the CPU plain version, ReedSolomonTorch."""
    import numpy as np

    from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch

    codec = ReedSolomonTorch(10, 4, device="cpu")
    blk = next(iter(rows.values())).shape[1]
    for row, data in rows.items():
        want = codec.encode(data)
        for sid in range(14):
            with open(shard_path[sid], "rb") as f:
                shard = np.frombuffer(os.pread(f.fileno(), blk, row * blk), dtype=np.uint8)
            expect = data[sid] if sid < 10 else want[sid - 10]
            check(np.array_equal(shard, expect), f"shard {sid} wrong in row {row}")
    print(f"  rows {sorted(rows)}: 10 data + 4 parity blocks of 1 MiB each match the CPU plain "
          f"version (ReedSolomonTorch)")


def stage_line(st: dict) -> str:
    return (f"stages setup {st['setup_s']:.4f}s read {st['read_s']:.4f}s "
            f"dispatch {st['dispatch_s']:.4f}s fetch {st['fetch_s']:.4f}s "
            f"write {st['write_s']:.4f}s wall {st['wall_s']:.4f}s")


def phase_decode(directory: str, dat_sha: str, ecx: bytes, label: str) -> float:
    """``ec.decode.local`` of the volume in ``directory`` with its .dat and
    .idx removed: the .dat must come back with the original sha256, the
    .idx with the .ecx's bytes (no .ecj exists), no staged file behind."""
    base = os.path.join(directory, "1")
    for ext in (".dat", ".idx"):
        os.remove(base + ext)
    t = time.perf_counter()
    run_cli(["ec.decode.local", "-dir", directory, "-volumeId", "1", "-device", "cuda"],
            stages=False)
    dt = time.perf_counter() - t
    check(sha256(base + ".dat") == dat_sha, f"{label}: decoded .dat differs from the original")
    with open(base + ".idx", "rb") as f:
        check(f.read() == ecx, f"{label}: decoded .idx differs from the .ecx")
    check(not [f for f in os.listdir(directory) if f.endswith(".tmp")],
          f"{label}: staged files left behind")
    print(f"decode ({label}): .dat sha256-identical to the original, .idx == .ecx, in {dt:.3f}s")
    return dt


def phase_main_path(args, ident: str, dev, rates) -> dict:
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.ops.rs_cuda import ReedSolomonCuda
    from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch

    size = int(args.gib * (1 << 30))
    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    laps = [("start", time.perf_counter())]

    def lap(name: str) -> None:
        laps.append((name, time.perf_counter()))
        progress(f"phase {name} passed in {laps[-1][1] - laps[-2][1]:.3f}s")
        faulthandler.dump_traceback_later(PHASE_STALL_S, file=sys.stderr)

    faulthandler.dump_traceback_later(PHASE_STALL_S, file=sys.stderr)

    try:
        t = time.perf_counter()
        want_ecx = make_volume(tmp, size, args.seed)
        print(f"volume: {size} bytes + .idx in {time.perf_counter() - t:.3f}s under {tmp}")
        base = os.path.join(tmp, "1")
        dat_sha = sha256(base + ".dat")
        # phase 5's volume: the same .dat and .idx, as links
        lrc_dir = os.path.join(tmp, "lrc")
        os.mkdir(lrc_dir)
        for ext in (".dat", ".idx"):
            os.link(base + ext, os.path.join(lrc_dir, "1" + ext))
        argv = ["-dir", tmp, "-volumeId", "1", "-device", "cuda"]

        zero_launch_counts()
        enc = run_cli(["ec.encode.local", *argv])
        enc_launches = rs_cuda.launches
        check(enc_launches > 0, "ec.encode.local launched no kernel")
        with open(base + ".ecx", "rb") as f:
            check(f.read() == want_ecx, ".ecx differs from the sorted live .idx entries")
        n_rows = check_parity(base, size, ReedSolomonTorch(10, 4, device="cpu"))
        hashes = {sid: sha256(base + f".ec{sid:02d}") for sid in range(14)}
        lost = (0, 3, 10, 13)
        for sid in lost:
            os.remove(base + f".ec{sid:02d}")

        zero_launch_counts()
        reb = run_cli(["ec.rebuild.local", *argv])
        reb_launches = rs_cuda.launches
        check(reb_launches > 0, "ec.rebuild.local launched no kernel")
        for sid in lost:
            check(sha256(base + f".ec{sid:02d}") == hashes[sid], f"rebuilt shard {sid} differs")
        print(f"rebuild: shards {list(lost)} hash-identical to the encoded ones")
        hop = phase_hop(base, ident, dev, shard_chunks(size), ReedSolomonCuda(10, 4, device=dev),
                        HOP_SETS)
        decode_s = phase_decode(tmp, dat_sha, want_ecx, "RS(10,4)")
        shard_size = os.path.getsize(base + ".ec00")
        enc_gbs = size / enc["wall_s"] / 1e9
        reb_gbs = len(lost) * shard_size / reb["wall_s"] / 1e9
        print(f"encode on {ident}: {n_rows} rows, launches={enc_launches}, {enc_gbs:.3f} GB/s of "
              f".dat; {stage_line(enc)}")
        print(f"rebuild on {ident}: launches={reb_launches}, {reb_gbs:.3f} GB/s generated; "
              f"{stage_line(reb)}")
        for sid in range(14):  # room for phase 5's shards
            os.remove(base + f".ec{sid:02d}")
        lap("3-4")
        lrc = phase_lrc(lrc_dir, size, ident, dev, dat_sha, want_ecx)
        lap("5")
        shutil.rmtree(lrc_dir)  # room for phase 6's shards
        mesh = phase_mesh(args, tmp, hashes, ident, dev, rates)
        lap("6")
        for name in os.listdir(tmp):  # room for phase 7's volumes
            path = os.path.join(tmp, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        ec_service = phase_ec_service(args, tmp, ident, dev)
        lap("7")
        cluster = phase_cluster(args, tmp, ec_service, ident, dev)
        lap("8")
        for name in os.listdir(tmp):  # room for phase 9's volumes
            path = os.path.join(tmp, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        write = phase_write_path(args, tmp, ident, dev)
        lap("9")
        for name in os.listdir(tmp):  # room for phase 10's volumes
            path = os.path.join(tmp, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        failover = phase_failover(args, tmp, ident, dev)
        lap("10")
        for name in os.listdir(tmp):  # room for phase 11's volumes
            path = os.path.join(tmp, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        maintenance = phase_maintenance(args, tmp, ident, dev)
        lap("11")
        for name in os.listdir(tmp):  # room for phase 12's volumes
            path = os.path.join(tmp, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        storage = phase_storage(args, tmp, ident, dev)
        host_codec = phase_host_codec(ident)
        lap("12")
        for name in os.listdir(tmp):  # room for phase 13's volumes
            path = os.path.join(tmp, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        filer = phase_filer(args, tmp, ident, dev)
        lap("13")
        for name in os.listdir(tmp):  # room for phase 14's volumes
            path = os.path.join(tmp, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        s3 = phase_s3(args, tmp, ident, dev)
        lap("14")
        for name in os.listdir(tmp):  # room for phase 15's volumes
            path = os.path.join(tmp, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        tls = phase_tls(args, tmp, ident, dev)
        lap("15")
        for name in os.listdir(tmp):  # room for phase 16's volumes
            path = os.path.join(tmp, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        shard = phase_shard(args, tmp, ident, dev)
        lap("16")
        for name in os.listdir(tmp):  # room for phase 17's volumes
            path = os.path.join(tmp, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        admin = phase_admin(args, tmp, ident, dev)
        lap("17")
        for name in os.listdir(tmp):  # room for phase 18's clusters
            path = os.path.join(tmp, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        sync = phase_sync(args, tmp, ident, dev)
        lap("18")
        for name in os.listdir(tmp):  # room for phase 19's cluster
            path = os.path.join(tmp, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        gateways = phase_gateways(args, tmp, ident, dev)
        lap("19")
        print("phase walls (s, with the clean-up before each): " + ", ".join(
            f"{name} {t1 - t0:.3f}" for (_n, t0), (name, t1) in zip(laps, laps[1:])))
        degraded = {label: (r["p50_us"], r["p99_us"]) for label, r in ec_service["reads"].items()}
        print(f"host codec paths on {ident}: phase 7 reads p50/p99 us {degraded}; phase 11 EC "
              f"scrub {maintenance['walls']['ec_scrub']:.3f}s")
        return dict(launches=enc_launches + reb_launches, encode=enc, rebuild=reb,
                    encode_gbs=enc_gbs, rebuild_gbs=reb_gbs, hop=hop, decode_s=decode_s,
                    lrc=lrc, mesh=mesh, ec_service=ec_service, cluster=cluster, write=write,
                    failover=failover, maintenance=maintenance, storage=storage,
                    host_codec=host_codec, filer=filer, s3=s3, tls=tls, shard=shard, admin=admin,
                    sync=sync, gateways=gateways)
    finally:
        faulthandler.cancel_dump_traceback_later()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 4 ------------------------------------------------------------------


def phase_hop(base: str, ident: str, dev, chunks: list[tuple[int, int]], codec,
              sets: list[tuple[int, ...]]) -> dict:
    """The plane-resident rebuild hop over the volume's survivors, chunk by
    chunk as the rebuild pipeline reads them; each result held against the
    shard files on disk.  The target sets (all planned on the same inputs,
    the last one the union of the others) are a synthetic mix that drives
    the kernels at the stack's 8 rows; they rebuild the last set's distinct
    shards, so GB/s is given both ways."""
    import numpy as np
    import torch

    from seaweedfs_tpu_torch.ops.rs_torch import BLOCK_WORDS

    lost = sets[-1]
    present = tuple(i not in lost for i in range(codec.total_shards))
    _mat, inputs, _mode = codec.recon_plan(present, lost)
    shard_size = os.path.getsize(base + ".ec00")
    check(shard_size == sum(n for _off, n in chunks), f"shard of {shard_size} bytes, chunks {chunks}")
    generated_rows = sum(len(ts) for ts in sets)
    distinct = len(lost)
    name = type(codec).__name__
    results = []
    with contextlib.ExitStack() as stack:
        files = {sid: stack.enter_context(open(base + f".ec{sid:02d}", "rb"))
                 for sid in (*inputs, *lost)}
        zero_launch_counts()
        for off, n in chunks:
            check(n % (4 * BLOCK_WORDS) == 0, f"chunk of {n} bytes is not whole 128 KB blocks")
            host = torch.empty((len(inputs), n), dtype=torch.uint8,
                               pin_memory=dev.type == "cuda")
            rows = host.numpy()
            for i, sid in enumerate(inputs):
                got = os.preadv(files[sid].fileno(), [memoryview(rows[i])], off)
                check(got == n, f"short read of shard {sid} at {off}")
            words = host.to(dev, non_blocking=True).view(torch.uint32)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            outs = codec.reconstruct_words_multi(present, sets, words)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            want = {sid: np.frombuffer(os.pread(files[sid].fileno(), n, off), dtype=np.uint8)
                    for sid in lost}
            for ts, out in zip(sets, outs):
                got = out.view(torch.uint8).cpu().numpy()
                check(got.shape == (len(ts), n), f"hop result for {ts} has shape {got.shape}")
                for row, sid in enumerate(ts):
                    check(np.array_equal(got[row], want[sid]),
                          f"hop: shard {sid} of set {ts} differs in [{off}, {off + n})")
            gbs, gbs_distinct = generated_rows * n / ms / 1e6, distinct * n / ms / 1e6
            results.append(dict(bytes=n, ms=ms, gbs=gbs, gbs_distinct=gbs_distinct))
            print(f"hop ({name}) chunk [{off}, {off + n}) of {len(inputs)} survivors on {ident}: "
                  f"{ms:.6f} ms, {gbs_distinct:.3f} GB/s of {distinct} distinct shards rebuilt "
                  f"({gbs:.3f} GB/s over all {generated_rows} rows); {len(sets)} sets equal the "
                  f"shard files")
        launches = launch_counts()
    check(launches["gf_apply"] == 0, f"the hop launched K1 {launches['gf_apply']} times")
    for kernel in ("gf_pack", "gf_planes_apply", "gf_unpack"):
        check(launches[kernel] > 0, f"the hop launched no {kernel}")
    print(f"hop ({name}): {len(results)} chunks over {shard_size} bytes per shard, "
          f"launches {launches}")
    return dict(chunks=results, launches=launches)


# -- phase 5 ------------------------------------------------------------------


def phase_lrc(directory: str, size: int, ident: str, dev, dat_sha: str, want_ecx: bytes) -> dict:
    """The LRC(10,2,2) main path on the volume of phase 3 (see the module
    docstring): encode, three flag-less rebuilds, the LRC plane hop, the
    decode, and an unrecoverable loss that must touch nothing."""
    import numpy as np

    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.ops.lrc_codec import LrcCuda, LrcTorch
    from seaweedfs_tpu_torch.ops.rs_torch import BLOCK_WORDS
    from seaweedfs_tpu_torch.storage.volume_info import maybe_load_volume_info

    base = os.path.join(directory, "1")
    argv = ["-dir", directory, "-volumeId", "1", "-device", "cuda"]

    zero_launch_counts()
    enc = run_cli(["ec.encode.local", *argv, "-code", "lrc"])
    enc_launches = rs_cuda.launches
    check(enc_launches > 0, "ec.encode.local -code lrc launched no kernel")
    check(enc["engine"] == "LrcCuda", f"LRC encode ran {enc['engine']}")
    with open(base + ".ecx", "rb") as f:
        check(f.read() == want_ecx, "LRC .ecx differs from the sorted live .idx entries")
    n_rows = check_parity(base, size, LrcTorch(10, 2, 2, device="cpu"))
    info = maybe_load_volume_info(base + ".vif")
    check(info is not None and (info.data_shards, info.parity_shards, info.local_groups)
          == (10, 4, 2), f".vif records {info}")
    hashes = {sid: sha256(base + f".ec{sid:02d}") for sid in range(14)}
    shard_size = os.path.getsize(base + ".ec00")
    enc_gbs = size / enc["wall_s"] / 1e9
    print(f"LRC encode on {ident}: {n_rows} rows, launches={enc_launches}, {enc_gbs:.3f} GB/s of "
          f".dat, .vif localGroups 2; {stage_line(enc)}")

    rebuilds = []
    for lost, mode, inputs in LRC_REBUILDS:
        for sid in lost:
            os.remove(base + f".ec{sid:02d}")
        zero_launch_counts()
        reb = run_cli(["ec.rebuild.local", *argv])  # no -code: the class comes from the .vif
        launches = rs_cuda.launches
        check(launches > 0, f"LRC rebuild of {lost} launched no kernel")
        check((reb["mode"], tuple(reb["inputs"]), reb["read_bytes"])
              == (mode, inputs, len(inputs) * shard_size),
              f"LRC rebuild of {lost}: plan {reb['mode']} {reb['inputs']} read {reb['read_bytes']}")
        for sid in lost:
            check(sha256(base + f".ec{sid:02d}") == hashes[sid], f"LRC rebuilt shard {sid} differs")
        gbs = len(lost) * shard_size / reb["wall_s"] / 1e9
        rebuilds.append(dict(lost=lost, mode=mode, launches=launches, gbs=gbs, stages=reb))
        print(f"LRC rebuild {list(lost)} on {ident}: {mode} from {len(inputs)} shards "
              f"({reb['read_bytes']} bytes read), launches={launches}, hash-identical, "
              f"{gbs:.3f} GB/s generated; {stage_line(reb)}")

    # the hop: every set plans globally on the same 10 inputs; (0,) alone
    # would plan locally on others, which the hop refuses before launching
    codec = LrcCuda(10, 2, 2, device=dev)
    present = tuple(i not in LRC_HOP_SETS[-1] for i in range(14))
    zero_launch_counts()
    try:
        codec.reconstruct_words_multi(present, [(12,), (0,)],
                                      np.zeros((10, BLOCK_WORDS), np.uint32))
        check(False, "the LRC hop took target sets with different inputs")
    except ValueError as e:
        check("same inputs" in str(e), f"the LRC hop refused mixed sets with: {e}")
    check(not any(launch_counts().values()), "the refused LRC hop launched a kernel")
    hop = phase_hop(base, ident, dev, shard_chunks(size), codec, LRC_HOP_SETS)
    decode_s = phase_decode(directory, dat_sha, want_ecx, "LRC(10,2,2)")

    for sid in LRC_UNRECOVERABLE:
        os.remove(base + f".ec{sid:02d}")
    before = sorted(os.listdir(directory))
    zero_launch_counts()
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        rc = cli.main(["ec.rebuild.local", *argv])
    print(f"  | {err.getvalue().strip()}")
    check(rc == 1 and "rank 9 < 10" in err.getvalue(),
          f"rebuild of {LRC_UNRECOVERABLE} exited {rc}: {err.getvalue()}")
    check(not any(launch_counts().values()), f"the unrecoverable rebuild launched {launch_counts()}")
    check(sorted(os.listdir(directory)) == before, "the unrecoverable rebuild wrote a file")
    print(f"LRC rebuild {list(LRC_UNRECOVERABLE)}: unrecoverable, no launch, no file written")
    return dict(launches=enc_launches + sum(r["launches"] for r in rebuilds), encode=enc,
                encode_gbs=enc_gbs, rebuilds=rebuilds, hop=hop, decode_s=decode_s)


# -- phase 6 ------------------------------------------------------------------


def k2_bits_bound(bits, n: int, rates: dict) -> tuple[float, str]:
    """K2 with a GF(2) bit-matrix over n-byte plane rows: (s + r) n bytes;
    the lesser of its set bits and the table apply's XORs as logic ops."""
    r, s = bits.shape[0] // 8, bits.shape[1] // 8
    xors = min(int(bits.sum()), 2 * s * (11 + 8 * r))
    return bound_ms((s + r) * n, xors * n / 32, rates["logic_ops_per_s"])


def best_host_ms(fn, iters: int = 3) -> float:
    """Host-clock ms of fn() through a synchronize, best of iters."""
    import torch

    best = float("inf")
    for _ in range(iters + 1):  # the first call warms
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t) * 1e3)
    return best


def phase_mesh_ops(args, dev, rates, ident, lmesh) -> dict:
    """The logical (2, 2) mesh over cuda:0 x 4 at 10 x 64 MiB: every entry
    point of parallel/ held byte for byte against the plain GF(2^8) apply
    on the card (residual 0 for the round trip), with the launch counts of
    that run; then K1-K4 at the positions' shapes against their plain
    versions, and timed."""
    import torch

    from seaweedfs_tpu_torch.ops import rs_cuda, rs_matrix, rs_torch
    from seaweedfs_tpu_torch.parallel import distributed_ec as de
    from seaweedfs_tpu_torch.parallel import gf2

    width = 64 * MIB
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    data = torch.randint(0, 256, (10, width), dtype=torch.uint8, device=dev, generator=gen)
    words = data.view(torch.uint32)
    enc = rs_matrix.matrix_for(10, 4)[10:]
    parity_ref = rs_torch.apply_matrix_reference(enc, data)
    shards = torch.cat([data, parity_ref])
    present = tuple(i not in HOP_SETS[-1] for i in range(14))
    _recon, inputs = rs_matrix.reconstruction_matrix(10, 4, present, HOP_SETS[-1])
    survivors = shards[list(inputs)]
    lost_ref = shards[list(HOP_SETS[-1])]

    def exact(got, want, label: str) -> None:
        check(torch.equal(got.view(torch.uint8), want),
              f"mesh: {label} differs from the plain version ({tuple(got.shape)})")

    zero_launch_counts()
    exact(de.sharded_encode(words, lmesh, 10, 4), parity_ref, "sharded_encode")
    exact(de.sharded_reconstruct(survivors.view(torch.uint32), present, HOP_SETS[-1], lmesh,
                                 10, 4), lost_ref, "sharded_reconstruct of 4 losses")
    for mode in ("width", "rows"):
        codec = de.ReedSolomonMesh(10, 4, mesh=lmesh, mode=mode)
        exact(codec.encode_device(data)[:, : width // 4], parity_ref, f"{mode} encode")
        exact(codec.reconstruct_device(present, HOP_SETS[-1], survivors)[:, : width // 4],
              lost_ref, f"{mode} rebuild of 4 losses")
    parity, residual = de.ec_round_trip_step(lmesh, 10, 4)(words)
    residual = int(residual)
    check(residual == 0, f"round trip residual {residual}")
    exact(parity, parity_ref, "round-trip parity")
    torch.cuda.synchronize()
    launches = launch_counts()
    for kernel, n in launches.items():
        check(n > 0, f"the mesh's entry points launched no {kernel}")
    print(f"mesh (2, 2) over {lmesh.size} x {dev} at 10x64MiB: sharded_encode, sharded_reconstruct "
          f"{HOP_SETS[-1]}, ReedSolomonMesh width and rows (encode, 4-loss rebuild) and "
          f"ec_round_trip_step (residual {residual}) byte-exact against the plain apply; "
          f"launches {launches}")

    # K1-K4 at the positions' shapes, against their plain versions (not counted)
    bits = gf2.expand_bits(enc)
    k1_x = words[:, : width // 16]  # a width-mode position: 10 x 16 MiB
    stripe = words[:, : width // 8]  # a rows-mode stripe slice: 10 x 32 MiB
    errs = {"gf_apply": max_abs_err(rs_cuda.apply_matrix_cuda(enc, k1_x),
                                    rs_torch.apply_matrix_reference(enc, k1_x.view(torch.uint8)))}
    planes = rs_cuda.pack_words(stripe)
    errs["gf_pack"] = max_abs_err(planes, rs_torch.pack_words_reference(stripe))
    outs = [rs_cuda.apply_bits_planes(bits[16 * i : 16 * (i + 1)], planes) for i in range(2)]
    errs["gf_planes_apply"] = max(
        max_abs_err(o, rs_torch.apply_bits_planes_reference(bits[16 * i : 16 * (i + 1)], planes))
        for i, o in enumerate(outs))
    errs["gf_unpack"] = max(max_abs_err(rs_cuda.unpack_words(o), rs_torch.unpack_words_reference(o))
                            for o in outs)
    odd = words[:, 1 : 1 + 3 * rs_torch.BLOCK_WORDS // 2]  # misaligned, 1.5 blocks: padded
    errs["apply_bits_padded"] = max_abs_err(gf2.apply_bits(bits, odd),
                                            gf2.apply_bits_reference(bits, odd))
    for name, err in errs.items():
        check(err == 0, f"{name} at the mesh positions' shapes: max abs err {err}")
    print(f"K1-K4 at the mesh positions' shapes (K1 10x16MiB->4, K3 10x32MiB, K2 -> 2 rows of "
          f"each shard owner, K4 2x32MiB, gf2.apply_bits at a misaligned 1.5-block width) "
          f"byte-exact: {errs}")

    timings = {}
    for key, fn, plain, (b_ms, b_by) in [
        ("k1_10x16MiB_to_4", lambda: rs_cuda.apply_matrix_cuda(enc, k1_x),
         lambda: rs_torch.apply_matrix_reference(enc, k1_x.view(torch.uint8)),
         k1_bound(enc, width // 4, rates)),
        ("pack_10x32MiB", lambda: rs_cuda.pack_words(stripe),
         lambda: rs_torch.pack_words_reference(stripe), transpose_bound(10, width // 2, rates)),
        ("apply_bits_32MiB_to_2", lambda: rs_cuda.apply_bits_planes(bits[:16], planes),
         lambda: rs_torch.apply_bits_planes_reference(bits[:16], planes),
         k2_bits_bound(bits[:16], width // 2, rates)),
        ("unpack_2x32MiB", lambda: rs_cuda.unpack_words(outs[0]),
         lambda: rs_torch.unpack_words_reference(outs[0]), transpose_bound(2, width // 2, rates)),
    ]:
        ms = time_ms(fn, iters=20)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        timings[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"timing mesh position {key} on {ident}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"bound {b_ms:.6f} ms ({b_by}), kernel at {100 * b_ms / ms:.1f}% of bound")

    width_codec = de.ReedSolomonMesh(10, 4, mesh=lmesh, mode="width")
    rows_codec = de.ReedSolomonMesh(10, 4, mesh=lmesh, mode="rows")
    ops = {"single_k1": lambda: rs_cuda.apply_matrix_cuda(enc, words),
           "mesh_width": lambda: width_codec.encode_words(words),
           "mesh_rows": lambda: rows_codec.encode_words(words)}
    runs = {name: [] for name in ops}
    for name in ["single_k1", "mesh_width", "mesh_rows", "mesh_rows", "mesh_width", "single_k1"]:
        runs[name].append(time_ms(ops[name], iters=10))
    whole = {name: sum(t) / len(t) for name, t in runs.items()}
    print(f"encode 10x64MiB->4 on {ident}, CUDA-event ms (runs in the order single, width, rows, "
          f"rows, width, single): single-device K1 {runs['single_k1']}, mesh width "
          f"{runs['mesh_width']}, mesh rows {runs['mesh_rows']}")

    host = torch.empty((10, width), dtype=torch.uint8, pin_memory=True)
    host.copy_(data.cpu())
    cols = [slice(p * width // 4, (p + 1) * width // 4) for p in range(4)]
    upload = {
        "per_position_strided": best_host_ms(lambda: [host[:, c].to(dev) for c in cols]),
        "one_upload_then_d2d": best_host_ms(
            lambda: [x[:, c].contiguous() for x in [host.to(dev, non_blocking=True)] for c in cols]),
    }
    print(f"upload of a pinned 10x64MiB buffer in 4 column slices on {ident}, best host ms: "
          f"{upload}")
    return dict(launches=launches, errs=errs, timings=timings, whole_ms=whole, whole_runs=runs,
                upload_ms=upload)


def phase_mesh_pipeline(directory: str, hashes: dict, ident: str, dev, lmesh) -> dict:
    """The 1 GiB volume of phase 3 through the mesh codec: ``ec.encode.local``
    and ``ec.rebuild.local`` under SEAWEEDFS_TPU_EC_MESH=1 (the card's own
    devices), then write_ec_files / rebuild_ec_files with the logical (2, 2)
    mesh in both modes, and one RS rebuild under a WEED_REPAIR_RATE_MB that
    must wait about a second; every shard hash-identical to phase 3's."""
    from seaweedfs_tpu_torch import stats
    from seaweedfs_tpu_torch.ops import repair_budget, select
    from seaweedfs_tpu_torch.parallel.distributed_ec import ReedSolomonMesh
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder

    base = os.path.join(directory, "1")
    argv = ["-dir", directory, "-volumeId", "1", "-device", "cuda"]
    lost = HOP_SETS[-1]

    def same(sids, label: str) -> None:
        for sid in sids:
            check(sha256(base + f".ec{sid:02d}") == hashes[sid], f"{label}: shard {sid} differs")

    def drop() -> None:
        for sid in lost:
            os.remove(base + f".ec{sid:02d}")

    out = {}
    os.environ["SEAWEEDFS_TPU_EC_MESH"] = "1"
    select._mesh_codec.cache_clear()
    try:
        enc = run_cli(["ec.encode.local", *argv])
        check(enc["engine"] == "ReedSolomonMesh", f"SEAWEEDFS_TPU_EC_MESH=1 encode ran {enc['engine']}")
        same(range(14), "mesh encode")
        drop()
        reb = run_cli(["ec.rebuild.local", *argv])
        same(lost, "mesh rebuild")
    finally:
        del os.environ["SEAWEEDFS_TPU_EC_MESH"]
    print(f"SEAWEEDFS_TPU_EC_MESH=1 encode on {ident}: hash-identical to phase 3; {stage_line(enc)}")
    print(f"SEAWEEDFS_TPU_EC_MESH=1 rebuild {list(lost)} on {ident}: hash-identical; "
          f"{stage_line(reb)}")
    out["cli"] = dict(encode=enc, rebuild=reb)

    for mode in ("width", "rows"):
        codec = ReedSolomonMesh(10, 4, mesh=lmesh, mode=mode)
        enc_st, reb_st = {}, {}
        ec_encoder.write_ec_files(base, codec=codec, stats=enc_st)
        same(range(14), f"logical mesh {mode} encode")
        drop()
        ec_encoder.rebuild_ec_files(base, codec=codec, stats=reb_st)
        same(lost, f"logical mesh {mode} rebuild")
        print(f"logical (2, 2) mesh {mode} through the pipeline on {ident}: hash-identical; "
              f"encode {stage_line(enc_st)}; rebuild {stage_line(reb_st)}")
        out[mode] = dict(encode=enc_st, rebuild=reb_st)

    drop()
    shard_size = os.path.getsize(base + ".ec01")
    read_bytes = 10 * shard_size
    rate = read_bytes / 2  # bytes/s: the 1 s burst covers half the reads
    nominal = (read_bytes - rate) / rate
    waited0 = stats.REPAIR_WAIT_SECONDS.value()
    read0 = stats.REPAIR_BYTES.value(code="rs", mode="global", dir="read")
    os.environ["WEED_REPAIR_RATE_MB"] = repr(rate / (1 << 20))  # the budget's MB is 2^20 bytes
    repair_budget.reload()
    try:
        reb = run_cli(["ec.rebuild.local", *argv])
    finally:
        del os.environ["WEED_REPAIR_RATE_MB"]
        repair_budget.reload()
    waited = stats.REPAIR_WAIT_SECONDS.value() - waited0
    same(lost, "throttled rebuild")
    check(stats.REPAIR_BYTES.value(code="rs", mode="global", dir="read") - read0 == read_bytes,
          "the throttled rebuild's read bytes are not in weedtpu_repair_bytes_total")
    check(0.5 * nominal <= waited <= nominal + 0.05 and reb["wall_s"] >= nominal,
          f"throttled rebuild waited {waited} s (nominal {nominal} s), wall {reb['wall_s']} s")
    cuda_cache = reb.get("sched_cache", {}).get("cuda", {})
    check(cuda_cache.get("hit", 0) > 0 and cuda_cache.get("miss", 1) == 0,
          f"the repeated survivor pattern did not ride the cuda schedule cache: {reb}")
    print(f"throttled rebuild on {ident}: WEED_REPAIR_RATE_MB={rate / (1 << 20):.6f}, "
          f"{read_bytes} bytes read, weedtpu_repair_wait_seconds_total +{waited:.6f} s "
          f"(nominal {nominal:.6f} s), sched_cache {reb['sched_cache']}; {stage_line(reb)}")
    out["throttled"] = dict(rebuild=reb, waited_s=waited, nominal_s=nominal,
                            rate_mb_s=rate / (1 << 20))
    return out


def phase_mesh(args, directory: str, hashes: dict, ident: str, dev, rates) -> dict:
    """Phase 6: the multi-device EC codec (parallel/) on the card."""
    import torch

    from seaweedfs_tpu_torch.parallel import distributed_ec, make_mesh

    own = make_mesh()
    print(f"mesh over the card's own devices: {own.size} position(s) ({torch.cuda.device_count()} "
          f"CUDA device(s)), shape {own.shape}")
    lmesh = make_mesh(devices=[dev] * 4, shard_par=2)
    streams = {p.stream.cuda_stream for p in lmesh.positions}
    check(lmesh.shape == {"shard": 2, "stripe": 2} and len(streams) == 4,
          f"logical mesh {lmesh} has {len(streams)} streams")
    ops = phase_mesh_ops(args, dev, rates, ident, lmesh)
    zero_launch_counts()
    pipeline = phase_mesh_pipeline(directory, hashes, ident, dev, lmesh)
    pipe_launches = launch_counts()
    check(pipe_launches["gf_apply"] > 0, "the mesh pipeline launched no K1")
    t = time.perf_counter()
    scaling = distributed_ec.measure_scaling(shard_mb=64)
    print(f"measure_scaling on {ident} ({time.perf_counter() - t:.3f}s): {json.dumps(scaling)}")
    launches = {k: ops["launches"][k] + pipe_launches[k] for k in pipe_launches}
    return dict(ops=ops, pipeline=pipeline, scaling=scaling, launches=launches,
                devices=own.size)


# -- phase 7 ------------------------------------------------------------------

NEEDLE_PAYLOAD = 1024  # `weed benchmark`'s default -size
BIG_NEEDLES = 8  # 256 KiB - 1 MiB payloads: reads of several intervals
DEAD_NEEDLES = 64
READ_SAMPLE = 1_000  # cut from 20,000 to leave phases 9-19 room in the time limit (3,000 before phase 17, 1,500 before 19)
LARGE_ROW_BLOCK = 64 * MIB  # the large-row pipeline's large blocks
READ_STATES = [  # label, volume, shards removed
    ("RS healthy", "rs", ()),
    ("RS {0,3,10,13} removed", "rs", (0, 3, 10, 13)),
    ("LRC {3} removed", "lrc", (3,)),
    ("LRC {0,5,12,13} removed", "lrc", (0, 5, 12, 13)),
    ("LRC {0,1,10,11} removed", "lrc", (0, 1, 10, 11)),
]


def make_needle_volume(directory: str, size: int, seed: int) -> dict:
    """A version-3 .dat of real needles, about ``size`` bytes: 1 KiB
    payloads (1064 bytes on disk each, with a last-modified time) and
    BIG_NEEDLES larger ones at seeded places, and its .idx with
    DEAD_NEEDLES of the small ones tombstoned.  The records are built in
    bulk from --seed; a seeded sample must equal ``Needle.to_bytes``."""
    import numpy as np

    from seaweedfs_tpu_torch.storage.needle import FLAG_HAS_LAST_MODIFIED, Needle
    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
    from seaweedfs_tpu_torch.storage.types import Version, get_actual_size
    from seaweedfs_tpu_torch.util.crc32c import crc32c_rows

    rng = np.random.default_rng(seed)
    body = 4 + NEEDLE_PAYLOAD + 1 + 5  # data size, data, flags, last modified
    rec = get_actual_size(body, Version.V3)
    big_sizes = [int(s) for s in rng.integers(256 << 10, (1 << 20) + 1, BIG_NEEDLES)]
    big_recs = [get_actual_size(4 + s + 1 + 5, Version.V3) for s in big_sizes]
    n = (size - SUPER_BLOCK_SIZE - sum(big_recs)) // rec
    total = n + BIG_NEEDLES
    ids = rng.permutation(np.unique(rng.integers(1, 1 << 48, total + total // 8)))[:total]
    check(len(ids) == total, "needle ids collide")
    cookies = rng.integers(0, 1 << 32, total)
    modified = rng.integers(1_500_000_000, 1_800_000_000, total)
    stamps = rng.integers(1, 1 << 62, total)
    recs = np.zeros((n, rec), np.uint8)
    o_data = 20
    o_flags = o_data + NEEDLE_PAYLOAD
    o_crc = o_flags + 1 + 5
    payload = recs[:, o_data:o_flags]
    payload[:] = np.frombuffer(rng.bytes(n * NEEDLE_PAYLOAD), np.uint8).reshape(n, NEEDLE_PAYLOAD)

    def put(col: int, values, dtype: str, width: int | None = None) -> None:
        raw = np.asarray(values).astype(dtype).view(np.uint8).reshape(len(values), -1)
        raw = raw[:, raw.shape[1] - (width or raw.shape[1]):]
        recs[:, col : col + raw.shape[1]] = raw

    put(0, cookies[:n], ">u4")
    put(4, ids[:n], ">u8")
    put(12, np.full(n, body), ">u4")
    put(16, np.full(n, NEEDLE_PAYLOAD), ">u4")
    recs[:, o_flags] = FLAG_HAS_LAST_MODIFIED
    put(o_flags + 1, modified[:n], ">u8", 5)
    put(o_crc, crc32c_rows(payload), ">u4")
    put(o_crc + 4, stamps[:n], ">u8")

    def needle(i: int, data: bytes) -> Needle:
        return Needle(id=int(ids[i]), cookie=int(cookies[i]), data=data,
                      flags=FLAG_HAS_LAST_MODIFIED, last_modified=int(modified[i]),
                      append_at_ns=int(stamps[i]))

    for i in rng.choice(n, min(n, 512), replace=False):
        check(recs[i].tobytes() == needle(int(i), payload[i].tobytes()).to_bytes(Version.V3),
              f"bulk needle record {i} differs from Needle.to_bytes")
    offsets = np.empty(n, np.int64)
    cuts = [0, *sorted(int(c) for c in rng.choice(np.arange(1, n), BIG_NEEDLES, replace=False)), n]
    big = []
    with open(os.path.join(directory, "1.dat"), "wb") as f:
        f.write(SuperBlock().to_bytes())  # version 3
        pos = SUPER_BLOCK_SIZE
        for j in range(BIG_NEEDLES + 1):
            lo, hi = cuts[j], cuts[j + 1]
            offsets[lo:hi] = pos + rec * np.arange(hi - lo)
            f.write(recs[lo:hi])
            pos += rec * (hi - lo)
            if j < BIG_NEEDLES:
                data = rng.bytes(big_sizes[j])
                record = needle(n + j, data).to_bytes(Version.V3)
                big.append(dict(id=int(ids[n + j]), data=data, offset=pos, size=4 + len(data) + 6))
                f.write(record)
                pos += len(record)
    entry = np.dtype([("id", ">u8"), ("off", ">u4"), ("size", ">i4")])
    puts = np.empty(total, entry)
    puts["id"] = ids
    puts["off"][:n] = offsets // 8
    puts["off"][n:] = [b["offset"] // 8 for b in big]
    puts["size"][:n] = body
    puts["size"][n:] = [b["size"] for b in big]
    puts = puts[np.argsort(puts["off"].astype(np.int64), kind="stable")]  # write order
    dead = rng.choice(n, DEAD_NEEDLES, replace=False)
    tombs = np.empty(DEAD_NEEDLES, entry)
    tombs["id"], tombs["off"], tombs["size"] = ids[dead], 0, -1
    with open(os.path.join(directory, "1.idx"), "wb") as f:
        f.write(puts.tobytes() + tombs.tobytes())
    live = puts[~np.isin(puts["id"], ids[dead])]
    crossing = np.flatnonzero(offsets // MIB != (offsets + rec - 1) // MIB)
    return dict(recs=recs, payload=payload, ids=ids, n=n, rec=rec, offsets=offsets, big=big,
                dead=set(int(i) for i in dead), dat_size=pos, crossing=crossing,
                ecx=live[np.argsort(live["id"].astype(np.uint64))].tobytes())


def read_sample(vol: dict, seed: int, count: int = READ_SAMPLE,
                crossing: int | None = None) -> list[tuple[int, bytes]]:
    """(needle id, payload) of ``count`` seeded live 1 KiB needles, every
    live needle that crosses a 1 MiB block boundary (or ``crossing`` of
    them, seeded), and the big ones."""
    import numpy as np

    rng = np.random.default_rng(seed)
    live = np.setdiff1d(np.arange(vol["n"]), np.fromiter(vol["dead"], np.int64))
    picked = set(int(i) for i in rng.choice(live, min(count, len(live)), replace=False))
    cross = sorted(set(int(i) for i in vol["crossing"]) - vol["dead"])
    if crossing is not None and crossing < len(cross):
        cross = [int(i) for i in rng.choice(cross, crossing, replace=False)]
    picked |= set(cross)
    sample = [(int(vol["ids"][i]), vol["payload"][i].tobytes()) for i in sorted(picked)]
    sample += [(b["id"], b["data"]) for b in vol["big"]]
    return [sample[i] for i in rng.permutation(len(sample))]


class _Server:
    """``python -m seaweedfs_tpu_torch.cli <command>`` in a subprocess on
    localhost (by default ``volume -device <device>`` over ``directory``):
    verbosity 1 (its stage lines go to ``log``), ports bound at 0 and read
    from its first line (``ready()``), stopped with SIGTERM (killed if it
    does not exit)."""

    live: set = set()  # started and not yet stopped: the deadline's log tails

    def __init__(self, directory: str, device: str, log: str, extra: tuple = (),
                 argv: list | None = None, wait: bool = True, env: dict | None = None):
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, **(env or {}), WEEDTPU_V="1",
                   PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
        self.log = log
        self._log_file = open(log, "w")
        self._t = time.perf_counter()
        _Server.live.add(self)
        # port 0: the server binds free ports itself and names them on its
        # first line
        argv = argv or ["volume", "-dir", directory, "-ip", "127.0.0.1", "-port", "0",
                        "-grpcPort", "0", "-metricsPort", "0", "-device", device, *extra]
        self.proc = subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch.cli", *argv],
                                     cwd=root, env=env, stdout=subprocess.PIPE,
                                     stderr=self._log_file, text=True)
        self.metrics_port = None
        if wait:
            self.ready()

    def ready(self, timeout: float = 300.0) -> str:
        """Wait for the first line, at most ``timeout`` seconds; returns it
        (the ports it names are parsed into grpc_port, http_port and
        metrics_port)."""
        import select

        if not select.select([self.proc.stdout], [], [], timeout)[0]:
            self.stop()
            raise SmokeFailure(f"no first line from the server within {timeout}s; "
                               f"log: {self.log_text()[-2000:]}")
        line = self.proc.stdout.readline().strip()
        self.start_s = time.perf_counter() - self._t
        # a volume server's or master's "gRPC on", a filer's "(gRPC ...)"
        bound = re.search(r"gRPC (?:on )?127\.0\.0\.1:(\d+)(?: .*metrics on 127\.0\.0\.1:(\d+))?",
                          line)
        if bound is None:
            self.stop()
            raise SmokeFailure(f"the server did not start: {line!r}; "
                               f"log: {self.log_text()[-2000:]}")
        self.grpc_port = int(bound[1])
        self.metrics_port = int(bound[2]) if bound[2] else None
        http = re.search(r"(?:HTTP|filer) on 127\.0\.0\.1:(\d+)", line)
        self.http_port = int(http[1]) if http else None
        print(f"server subprocess pid {self.proc.pid} up in {self.start_s:.3f}s: {line}")
        return line

    def log_text(self) -> str:
        if not self._log_file.closed:
            self._log_file.flush()
        with open(self.log) as f:
            return f.read()

    def metrics(self) -> str:
        import urllib.request

        url = f"http://127.0.0.1:{self.metrics_port}/metrics"
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.read().decode()

    def stop(self) -> int:
        _Server.live.discard(self)
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.proc.stdout.close()
        self._log_file.close()
        return self.proc.returncode


def metric(text: str, name: str, **labels) -> float:
    """The value of one series of /metrics text (0 when absent)."""
    want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    series = f"{name}{{{want}}}" if labels else name
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def native_dp(url: str) -> dict:
    """A volume server's native data-plane counters, from the
    ``seaweedfs_volume_native_dp{kind=...}`` lines of its HTTP /metrics."""
    import urllib.request

    with urllib.request.urlopen(f"http://{url}/metrics", timeout=60) as r:
        text = r.read().decode()
    return {m[1]: int(m[2]) for m in
            re.finditer(r'seaweedfs_volume_native_dp\{kind="(\w+)"\} (\d+)', text)}


def native_dp_delta(after: dict, before: dict) -> dict:
    """Summed per-kind differences of native_dp() maps keyed by server."""
    out: dict = {}
    for url, a in after.items():
        for k, v in a.items():
            out[k] = out.get(k, 0) + v - before.get(url, {}).get(k, 0)
    return out


def px_stats_of(metrics_addr: str) -> tuple[str, dict]:
    """A gateway's splice counters and px loop mode, from the native px
    loop section of its /debug/threadz (util/debugz.py)."""
    import urllib.request

    with urllib.request.urlopen(f"http://{metrics_addr}/debug/threadz", timeout=60) as r:
        text = r.read().decode()
    mode = re.search(r"--- native px loop \(C thread, mode=([^)]*)\) ---", text)
    check(mode is not None, f"no native px loop section in {metrics_addr}'s /debug/threadz")
    return mode[1], {m[1]: int(m[2]) for m in re.finditer(r"sw_px_stats\.(\w+) = (\d+)", text)}


def server_stages(log: str, op: str) -> list[dict]:
    """The pipeline stage breakdowns the server logged for ``op``."""
    return [json.loads(line.split(" stages: ", 1)[1]) for line in log.splitlines()
            if f"] ec: {op} " in line and " stages: " in line]


def phase_server(vol: dict, directory: str, dev, ident: str, seed: int) -> dict:
    """The volume server's EC service, over gRPC from this process to a
    server subprocess on the card (see the module docstring)."""
    import grpc
    import numpy as np

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as pb
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.types import Version

    base = os.path.join(directory, "1")
    dat_sha = sha256(base + ".dat")
    server = _Server(directory, dev.type, os.path.join(os.path.dirname(directory), "server.log"))
    walls: dict = {}
    try:
        before = server.metrics()
        for kernel in ("gf_apply", "gf_planes_apply", "gf_pack", "gf_unpack"):
            check(metric(before, "weedtpu_cuda_kernel_launches", kernel=kernel) == 0,
                  f"the new server process has launched {kernel}")
        stub = rpc.volume_stub(f"127.0.0.1:{server.grpc_port}")

        def call(label: str, method: str, request, stream: bool = False):
            t = time.perf_counter()
            out = getattr(stub, method)(request, timeout=600)
            out = list(out) if stream else out
            walls.setdefault(label, []).append(time.perf_counter() - t)
            return out

        call("generate", "EcShardsGenerate", pb.EcShardsGenerateRequest(volume_id=1))
        with open(base + ".ecx", "rb") as f:
            check(f.read() == vol["ecx"], "server .ecx differs from the sorted live .idx entries")
        n_rows = check_parity(base, vol["dat_size"], ReedSolomonTorch(10, 4, device="cpu"))
        call("mount", "EcShardsMount", pb.EcShardsMountRequest(volume_id=1, shard_ids=range(14)))
        info = call("info", "EcShardsInfo", pb.EcShardsInfoRequest(volume_id=1))
        shard_size = os.path.getsize(base + ".ec00")
        check([(s.shard_id, s.size) for s in info.shards] == [(i, shard_size) for i in range(14)],
              f"EcShardsInfo: {info}")
        rng = np.random.default_rng(seed)
        for sid, size in [(int(s), int(z)) for s, z in zip(rng.integers(0, 14, 6),
                                                           rng.integers(1, 3 * MIB, 6))]:
            offset = int(rng.integers(0, shard_size - size))
            got = b"".join(r.data for r in call("shard read", "EcShardRead", pb.EcShardReadRequest(
                volume_id=1, shard_id=sid, offset=offset, size=size), stream=True))
            with open(base + f".ec{sid:02d}", "rb") as f:
                check(got == os.pread(f.fileno(), size, offset),
                      f"EcShardRead {sid} @{offset} +{size} differs from the shard file")
        # the reads of phase 7 run on links to the generated shards
        reads_dir = os.path.join(os.path.dirname(directory), "reads")
        os.mkdir(reads_dir)
        for sid in range(14):
            os.link(base + f".ec{sid:02d}", os.path.join(reads_dir, f"1.ec{sid:02d}"))
        for ext in (".ecx", ".vif"):
            shutil.copy(base + ext, os.path.join(reads_dir, "1" + ext))

        lost = HOP_SETS[-1]
        hashes = {sid: sha256(base + f".ec{sid:02d}") for sid in lost}
        for _ in range(2):  # the second rebuild in the same process: warm pinned slots
            call("unmount", "EcShardsUnmount", pb.EcShardsUnmountRequest(volume_id=1, shard_ids=lost))
            info = call("info", "EcShardsInfo", pb.EcShardsInfoRequest(volume_id=1))
            check([s.shard_id for s in info.shards] == [i for i in range(14) if i not in lost],
                  f"EcShardsInfo after unmounting {lost}: {info}")
            call("delete", "EcShardsDelete", pb.EcShardsDeleteRequest(volume_id=1, shard_ids=lost))
            check(not any(os.path.exists(base + f".ec{sid:02d}") for sid in lost),
                  "EcShardsDelete left shard files")
            resp = call("rebuild", "EcShardsRebuild", pb.EcShardsRebuildRequest(volume_id=1))
            check(list(resp.rebuilt_shard_ids) == list(lost), f"rebuilt {resp.rebuilt_shard_ids}")
            for sid in lost:
                check(sha256(base + f".ec{sid:02d}") == hashes[sid], f"server rebuilt {sid} differs")
            call("mount", "EcShardsMount", pb.EcShardsMountRequest(volume_id=1, shard_ids=lost))

        victim = vol["big"][0]["id"]
        call("blob delete", "EcBlobDelete", pb.EcBlobDeleteRequest(volume_id=1, file_key=victim))
        out = call("shard read", "EcShardRead", pb.EcShardReadRequest(
            volume_id=1, shard_id=0, size=16, file_key=victim), stream=True)
        check([r.is_deleted for r in out] == [True], "EcShardRead of a deleted blob: not is_deleted")
        # the normal volume still holds it: ReadNeedleBlob answers its record
        blob = stub.ReadNeedleBlob(pb.ReadNeedleBlobRequest(volume_id=1, needle_id=victim),
                                   timeout=60).needle_blob
        check(Needle.from_bytes(blob, Version.V3).data == vol["big"][0]["data"],
              "ReadNeedleBlob's record differs from the needle written")
        try:  # an unsealed volume is not tiered
            stub.VolumeTierMove(pb.VolumeTierMoveRequest(
                volume_id=1, dest=os.path.join(directory, "objects")), timeout=60)
            check(False, "VolumeTierMove tiered an unsealed volume")
        except grpc.RpcError as e:
            check(e.code() == grpc.StatusCode.FAILED_PRECONDITION,
                  f"VolumeTierMove: {e.code()} {e.details()}")

        # the native plane's EC GET: with the normal volume unmounted, HTTP
        # GETs of the EC volume's needles go out of its local shards in C++
        call("unmount volume", "VolumeUnmount", pb.VolumeMountRequest(volume_id=1))
        ec_http = native_ec_gets(vol, base, f"127.0.0.1:{server.http_port}", seed, victim)

        for ext in (".dat", ".idx"):
            os.remove(base + ext)
        call("to volume", "EcShardsToVolume", pb.EcShardsToVolumeRequest(volume_id=1))
        check(sha256(base + ".dat") == dat_sha, "EcShardsToVolume: .dat differs from the original")

        text = server.metrics()
        ops = {op: metric(text, "weedtpu_ec_operations_total", op=op) for op in ("encode", "rebuild")}
        check(ops == {"encode": 1, "rebuild": 2}, f"weedtpu_ec_operations_total {ops}")
        cache = {ev: metric(text, "weedtpu_ec_sched_cache_total", event=ev, plane="cuda")
                 for ev in ("hit", "miss")}
        check(sum(cache.values()) > 0, "no weedtpu_ec_sched_cache_total{plane=\"cuda\"} in the server")
        launches = {k: int(metric(text, "weedtpu_cuda_kernel_launches", kernel=k))
                    for k in ("gf_apply", "gf_planes_apply", "gf_pack", "gf_unpack")}
        check(launches["gf_apply"] > 0, f"the server launched no K1: {launches}")
    finally:
        rc = server.stop()
    log = server.log_text()
    check(rc == 0, f"the volume server exited {rc}: {log[-2000:]}")
    gen, rebuilds = server_stages(log, "generate"), server_stages(log, "rebuild")
    check(len(gen) == 1 and len(rebuilds) == 2, f"server stage lines: {len(gen)} / {len(rebuilds)}")
    print(f"server on {ident}: /metrics weedtpu_ec_operations_total {ops}, "
          f"weedtpu_ec_sched_cache_total{{plane=\"cuda\"}} {cache}, "
          f"weedtpu_cuda_kernel_launches {launches}")
    print(f"server generate on {ident}: {n_rows} rows, RPC wall {walls['generate'][0]:.4f}s, "
          f"{vol['dat_size'] / walls['generate'][0] / 1e9:.3f} GB/s of .dat; {stage_line(gen[0])}")
    print(f"server rebuild {list(lost)} on {ident}, first vs second in one process: RPC wall "
          f"{walls['rebuild'][0]:.4f}s vs {walls['rebuild'][1]:.4f}s; setup "
          f"{rebuilds[0]['setup_s']:.4f}s vs {rebuilds[1]['setup_s']:.4f}s; "
          f"{stage_line(rebuilds[0])} | {stage_line(rebuilds[1])}")
    print("server RPC client walls (s): " + ", ".join(
        f"{k} {' / '.join(f'{w:.4f}' for w in v)}" for k, v in walls.items()))
    print(f"server native EC GETs on {ident}: {ec_http['gets']} needles over HTTP, each equal to "
          f"its payload, served by the C++ plane from the local shards (native_reads "
          f"+{ec_http['native_reads']}, forwarded +{ec_http['forwarded']}, not_found "
          f"+{ec_http['not_found']}); {ec_http['gets_per_s']:.1f} GETs/s, p50 "
          f"{ec_http['p50_ms']:.3f} ms, p99 {ec_http['p99_ms']:.3f} ms on the host")
    return dict(walls=walls, generate=gen[0], rebuilds=rebuilds, launches=launches,
                sched_cache=cache, start_s=server.start_s, reads_dir=reads_dir, ec_http=ec_http)


EC_HTTP_GETS = 1024  # live 1 KiB needles read over HTTP from the EC volume in phase 7


def native_ec_gets(vol: dict, base: str, url: str, seed: int, deleted: int) -> dict:
    """GETs of EC_HTTP_GETS seeded live 1 KiB needles, the big ones (but
    the EcBlobDelete'd one), the deleted one and a tombstoned one through a volume server whose
    only copy of volume 1 is its 14 local shards: every live one 200 with
    its payload, the two others 404, all of them answered by the native
    plane (its counters: native_reads up by the 200s, nothing forwarded)."""
    import numpy as np

    from seaweedfs_tpu_torch.util.http_pool import HttpConnectionPool

    rng = np.random.default_rng([seed, 707])
    live = np.setdiff1d(np.arange(vol["n"]), np.fromiter(vol["dead"], np.int64))
    picks = [int(i) for i in rng.choice(live, min(EC_HTTP_GETS, len(live)), replace=False)]

    def cookie_at(i: int) -> int:
        return int.from_bytes(vol["recs"][i][:4].tobytes(), "big")

    reads = [(int(vol["ids"][i]), cookie_at(i), vol["payload"][i].tobytes()) for i in picks]
    with open(base + ".dat", "rb") as f:
        for b in vol["big"]:
            if b["id"] == deleted:
                continue
            reads.append((b["id"], int.from_bytes(os.pread(f.fileno(), 4, b["offset"]), "big"),
                          b["data"]))
        head = os.pread(f.fileno(), 4, 8)  # the first record's cookie: any will do for a 404
    gone = [(deleted, 0), (int(vol["ids"][min(vol["dead"])]), int.from_bytes(head, "big"))]
    pool = HttpConnectionPool(timeout=60.0)
    lat = np.empty(len(reads))
    before = native_dp(url)
    t0 = time.perf_counter()
    try:
        for j, (nid, cookie, payload) in enumerate(reads):
            t = time.perf_counter()
            status, body = pool.request(url, "GET", f"/1,{nid:x}{cookie:08x}")
            lat[j] = time.perf_counter() - t
            check(status == 200 and body == payload,
                  f"native EC GET of {nid:x}: {status}, {len(body)} bytes")
        wall = time.perf_counter() - t0
        for nid, cookie in gone:
            status, _body = pool.request(url, "GET", f"/1,{nid:x}{cookie:08x}")
            check(status == 404, f"EC GET of the deleted needle {nid:x}: {status}")
    finally:
        pool.close()
    d = native_dp_delta({url: native_dp(url)}, {url: before})
    d["forwarded"] -= 1  # the /metrics scrape that read these counters
    check(d["native_reads"] == len(reads) and d["forwarded"] == 0,
          f"the native plane served {d['native_reads']} of {len(reads)} EC GETs, forwarded "
          f"{d['forwarded']}")
    return dict(gets=len(reads), native_reads=d["native_reads"], forwarded=d["forwarded"],
                not_found=d["not_found"], gets_per_s=len(reads) / wall,
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3))


def phase_reads(vol: dict, dirs: dict, ident: str, seed: int) -> dict:
    """Needle reads through the port's Store, EcVolume.read_needle and the
    local half of EcShardLocator, in READ_STATES (host only)."""
    import numpy as np

    from seaweedfs_tpu_torch import stats
    from seaweedfs_tpu_torch.ops.select import small_read_codec_for
    from seaweedfs_tpu_torch.server.store_ec import EcShardLocator
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.volume import NotFoundError

    sample = read_sample(vol, seed)
    dead = [int(vol["ids"][i]) for i in sorted(vol["dead"])]
    out = {}
    for label, kind, lost in READ_STATES:
        store = Store([dirs[kind]])
        store.mount_ec_shards("", 1, [s for s in range(14) if s not in lost])
        ev = store.find_ec_volume(1)
        locator = EcShardLocator()
        fetch = locator.make_fetcher(ev)
        rebuilt = [0, 0]  # intervals, bytes

        def counted(vid, sid, offset, length):
            rebuilt[0] += 1
            rebuilt[1] += length
            return fetch(vid, sid, offset, length)

        bytes0 = stats.REPAIR_BYTES.series()
        lat = np.empty(len(sample))
        try:
            t0 = time.perf_counter()
            for j, (nid, payload) in enumerate(sample):
                t = time.perf_counter()
                got = ev.read_needle(nid, fetcher=counted).data
                lat[j] = time.perf_counter() - t
                check(got == payload, f"{label}: needle {nid:x} differs from its seeded bytes")
            wall = time.perf_counter() - t0
            for nid in dead:
                try:
                    ev.read_needle(nid, fetcher=counted)
                    check(False, f"{label}: tombstoned needle {nid:x} was read")
                except NotFoundError:
                    pass
        finally:
            locator.close()
            store.close()
        moved = {dict(k)["mode"]: v - bytes0.get(k, 0.0)
                 for k, v in stats.REPAIR_BYTES.series().items()
                 if dict(k)["dir"] == "read" and dict(k)["code"] == kind and v != bytes0.get(k, 0.0)}
        per_interval = {mode: v / rebuilt[1] for mode, v in moved.items()} if rebuilt[1] else {}
        if lost:
            check(rebuilt[0] > 0, f"{label}: no interval was reconstructed")
        want = {(): {}, (0, 3, 10, 13): {"global": 10.0}, (3,): {"local": 5.0},
                (0, 5, 12, 13): {"local": 5.0}}.get(lost)
        if want is not None:
            check(per_interval == want, f"{label}: repair reads per interval byte {per_interval}")
        else:  # a local plan abandoned (co-members missing), then the global decode
            check(per_interval.get("global") == 10.0 and per_interval.get("local", 0) < 5,
                  f"{label}: repair reads per interval byte {per_interval}")
        rec = dict(needles=len(sample), needles_per_s=len(sample) / wall,
                   p50_us=float(np.percentile(lat, 50) * 1e6),
                   p99_us=float(np.percentile(lat, 99) * 1e6),
                   reconstructed_intervals=rebuilt[0], reconstructed_bytes=rebuilt[1],
                   repair_read_bytes=moved)
        rec["codec"] = type(small_read_codec_for(ev.scheme)).__name__
        out[label] = rec
        print(f"reads ({label}) on the host ({ident} box), decoding on {rec['codec']}: "
              f"{len(sample)} needles byte-exact, "
              f"{len(dead)} tombstoned raise NotFoundError; {rec['needles_per_s']:.1f} needles/s, "
              f"p50 {rec['p50_us']:.1f} us, p99 {rec['p99_us']:.1f} us; {rebuilt[0]} intervals "
              f"({rebuilt[1]} bytes) reconstructed; weedtpu_repair_bytes_total{{dir=read}} "
              f"+{moved} ({per_interval} per byte)")
    return out


def phase_large_row(vol: dict, directory: str, dev, ident: str) -> dict:
    """The 1 GiB .dat through write_ec_files with 64 MiB large blocks: one
    large row of 10 x 64 MiB (strided preadv, one K1 batch) and small rows
    after it; parity sampled against the CPU plain version in both areas,
    and needles read back through EcVolume with that scheme."""
    import numpy as np

    from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
    from seaweedfs_tpu_torch.server.store_ec import EcShardLocator
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import EcScheme
    from seaweedfs_tpu_torch.storage.volume_info import VolumeInfo, save_volume_info

    scheme = EcScheme(10, 4, large_block_size=LARGE_ROW_BLOCK)
    k, big, small = 10, scheme.large_block_size, scheme.small_block_size
    base = os.path.join(directory, "1")
    st: dict = {}
    ec_encoder.write_ec_files(base, scheme, stats=st, device=dev)
    ec_encoder.write_sorted_ecx_file(base)
    save_volume_info(base + ".vif", VolumeInfo(dat_file_size=vol["dat_size"], data_shards=k,
                                               parity_shards=4))
    n_large, left = 0, vol["dat_size"]
    while left > big * k:
        n_large, left = n_large + 1, left - big * k
    check(n_large >= 1, "the volume has no large row")
    small_rows = -(-left // (small * k))
    windows = [(r * big + x, [r * big * k + i * big + x for i in range(k)])
               for r in range(n_large) for x in (0, big // 2, big - small)]
    windows += [(n_large * big + q * small,
                 [n_large * big * k + q * small * k + i * small for i in range(k)])
                for q in (0, small_rows - 1)]
    codec = ReedSolomonTorch(10, 4, device="cpu")
    with open(base + ".dat", "rb") as dat:
        for shard_off, dat_offs in windows:
            data = np.zeros((k, small), np.uint8)
            for i, off in enumerate(dat_offs):
                got = os.preadv(dat.fileno(), [memoryview(data[i])], off)
                data[i, got:] = 0
            want = np.concatenate([data, codec.encode(data)])
            for sid in range(14):
                with open(base + f".ec{sid:02d}", "rb") as f:
                    shard = np.frombuffer(os.pread(f.fileno(), small, shard_off), np.uint8)
                check(np.array_equal(shard, want[sid]),
                      f"large-row volume: shard {sid} wrong at {shard_off}")
    # needles across the large blocks' boundaries, the large -> small
    # boundary, and at random; healthy, then with shard 2 missing
    offsets, rec = vol["offsets"], vol["rec"]
    edges = [j * big for j in range(1, n_large * k + 1)]
    near = {int(np.searchsorted(offsets, e)) - 1 for e in edges}
    rng = np.random.default_rng(len(edges))
    picks = sorted((near | set(int(i) for i in rng.choice(vol["n"], 200, replace=False)))
                   - vol["dead"] - {-1})
    ev = EcVolume(directory, 1, scheme=scheme)
    locator = EcShardLocator()
    kinds, crossing = set(), 0
    try:
        for sid in range(14):
            ev.add_shard(sid)
        for missing in (None, 2):
            if missing is not None:
                ev.delete_shard(missing)
            fetch = locator.make_fetcher(ev)
            for i in picks:
                nid = int(vol["ids"][i])
                check(ev.read_needle(nid, fetcher=fetch).data == vol["payload"][i].tobytes(),
                      f"large-row volume: needle {nid:x} differs")
                intervals = ev.locate(nid)[2]
                kinds |= {iv.is_large_block for iv in intervals}
                crossing += len(intervals) > 1
    finally:
        locator.close()
        ev.close()
    check(kinds == {True, False} and crossing > 0,
          f"large-row reads covered large={True in kinds} small={False in kinds}, {crossing} crossing")
    gbs = vol["dat_size"] / st["wall_s"] / 1e9
    print(f"large-row encode on {ident}: EcScheme(10, 4, large_block_size={big // MIB} MiB), "
          f"{n_large} large row(s) of 10 x {big // MIB} MiB + {small_rows} small rows, "
          f"{gbs:.3f} GB/s; parity of "
          f"{len(windows)} 1 MiB windows == CPU plain version; {len(picks)} needles x 2 states "
          f"byte-exact ({crossing} reads spanned blocks); {stage_line(st)}")
    return dict(stages=st, gbs=gbs, large_rows=n_large, small_rows=small_rows)


def phase_ec_service(args, directory: str, ident: str, dev) -> dict:
    """Phase 7: a needle volume through the volume server's EC service,
    then needle reads from its shards and from an LRC encoding of it, and
    the large-row pipeline."""
    from seaweedfs_tpu_torch.ops.lrc_codec import LrcTorch

    size = int(args.gib * (1 << 30))
    server_dir = os.path.join(directory, "server")
    os.mkdir(server_dir)
    t = time.perf_counter()
    vol = make_needle_volume(server_dir, size, args.seed)
    print(f"needle volume: {vol['n']} needles of {NEEDLE_PAYLOAD} B ({vol['rec']} B on disk) + "
          f"{BIG_NEEDLES} of {min(len(b['data']) for b in vol['big'])}-"
          f"{max(len(b['data']) for b in vol['big'])} B, {vol['dat_size']} bytes, "
          f"{len(vol['dead'])} tombstoned, {len(vol['crossing'])} crossing 1 MiB blocks; "
          f"{time.perf_counter() - t:.3f}s")
    lrc_dir, large_dir = os.path.join(directory, "lrc"), os.path.join(directory, "large")
    for d in (lrc_dir, large_dir):
        os.mkdir(d)
        for ext in (".dat", ".idx"):
            os.link(os.path.join(server_dir, "1" + ext), os.path.join(d, "1" + ext))

    server = phase_server(vol, server_dir, dev, ident, args.seed)
    zero_launch_counts()
    enc = run_cli(["ec.encode.local", "-dir", lrc_dir, "-volumeId", "1", "-device", dev.type,
                   "-code", "lrc"])
    check_parity(os.path.join(lrc_dir, "1"), vol["dat_size"], LrcTorch(10, 2, 2, device="cpu"))
    print(f"LRC encode of the needle volume on {ident}: {stage_line(enc)}")
    large = phase_large_row(vol, large_dir, dev, ident)
    launches = launch_counts()
    check(launches["gf_apply"] > 0, f"phase 7's own encodes launched no K1: {launches}")
    shutil.rmtree(large_dir)
    reads = phase_reads(vol, {"rs": server["reads_dir"], "lrc": lrc_dir}, ident, args.seed)
    return dict(server=server, reads=reads, large=large, lrc_encode=enc, vol=vol, source_dir=lrc_dir,
                launches=launches["gf_apply"] + server["launches"]["gf_apply"],
                launches_server=server["launches"]["gf_apply"], launches_local=launches["gf_apply"])

CLUSTER_SERVERS = 4
CLUSTER_READ_SAMPLE = 64  # cut from 2,000 (500 before phase 16, 250 before 17, 125 before 19) for the time limit
CLUSTER_CROSSING_SAMPLE = 64  # of the ~1,000 block-crossing needles (all before phase 18, 256 before 19)
LRC_CLUSTER_GIB = 0.125  # the LRC volume of phase 8, cut to stay inside the time limit (0.25 before phase 17)
PRUNE_WAIT_S = 60.0  # the master prunes after 15 s without a heartbeat, checked every 5 s


def _poll(predicate, what: str, timeout: float) -> float:
    """Seconds until ``predicate()`` held; fails after ``timeout``."""
    t = time.perf_counter()
    while not predicate():
        check(time.perf_counter() - t < timeout, f"timed out after {timeout}s waiting for {what}")
        time.sleep(0.1)
    return time.perf_counter() - t


class _Beside:
    """``fn()`` on a thread of its own, for a step that needs nothing of
    the cluster the caller is waiting on (the master's prune of a killed
    server); ``result()`` joins it and raises what it raised."""

    def __init__(self, fn):
        self._out: dict = {}

        def run():
            try:
                self._out["value"] = fn()
            except BaseException as e:  # noqa: BLE001 — handed to result()
                self._out["error"] = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self, timeout: float = 300.0) -> None:
        """Joins, for a clean-up after the caller failed; raises nothing."""
        self._thread.join(timeout)

    def result(self, timeout: float = 300.0):
        self._thread.join(timeout)
        check(not self._thread.is_alive(), f"a step beside the wait ran past {timeout}s")
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def _ec_census(master_stub, vid: int) -> dict:
    """{node grpc address: [shard ids]} and the EC volume's (k, m, local
    groups), from the master's VolumeList."""
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb

    topo = master_stub.VolumeList(m_pb.VolumeListRequest(), timeout=60).topology_info
    out, scheme, racks, volumes = {}, None, {}, set()
    for dc in topo.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                addr = f"{dn.url.rsplit(':', 1)[0]}:{dn.grpc_port}"
                racks[addr] = rack.id
                for disk in dn.disk_infos.values():
                    volumes |= {v.id for v in disk.volume_infos}
                    for es in disk.ec_shard_infos:
                        if es.volume_id == vid:
                            out[addr] = [i for i in range(32) if es.shard_bits >> i & 1]
                            scheme = (es.data_shards, es.parity_shards, es.local_groups)
    return dict(holders=out, scheme=scheme, racks=racks, volumes=volumes)


def _disk_shards(dirs_by_addr: dict, name: str) -> dict:
    """{node grpc address: [shard ids]} of the ``name.ecNN`` files on each
    server's disk: what a finished shell command left, which the master
    reports once the servers' heartbeat deltas have landed."""
    out = {}
    for addr, d in dirs_by_addr.items():
        sids = sorted(int(n[-2:]) for n in os.listdir(d)
                      if re.fullmatch(re.escape(name) + r"\.ec\d\d", n))
        if sids:
            out[addr] = sids
    return out


def _shell(master: str, commands: str, log: str, filer: str = "",
           env: dict | None = None) -> tuple[float, str]:
    """``cli shell -master M [-filer F] -c commands`` in a subprocess (with
    ``env`` added to its environment): (wall, stdout); a non-zero exit
    fails the phase."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **(env or {}),
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    t = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch.cli", "shell", "-master",
                          master, *(("-filer", filer) if filer else ()), "-c", commands],
                         cwd=root, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t
    with open(log, "a") as f:
        f.write(f"$ shell -c {commands!r} ({wall:.3f}s, rc {run.returncode})\n{run.stdout}{run.stderr}")
    check(run.returncode == 0, f"shell -c {commands!r} exited {run.returncode}: {run.stderr[-2000:]}")
    print(f"cluster: shell -c {commands!r}: {wall:.3f}s; " + " | ".join(run.stdout.splitlines()))
    return wall, run.stdout


def _cluster_reads(ev, locator, sample, label: str) -> dict:
    """Read ``sample`` through ``ev`` and the locator's fetcher: every
    payload equal; remote EcShardRead answers and reconstructions counted."""
    import numpy as np

    from seaweedfs_tpu_torch import stats

    remote = [0]
    read_remote = locator.read_remote

    def counted(*a):
        out = read_remote(*a)
        remote[0] += 1
        return out

    locator.read_remote = counted
    rec0 = stats.EC_DEGRADED_READS.value(mode="reconstruct")
    fetch = locator.make_fetcher(ev)
    lat = np.empty(len(sample))
    t0 = time.perf_counter()
    for j, (nid, payload) in enumerate(sample):
        t = time.perf_counter()
        got = ev.read_needle(nid, fetcher=fetch).data
        lat[j] = time.perf_counter() - t
        check(got == payload, f"{label}: needle {nid:x} differs from its seeded bytes")
    wall = time.perf_counter() - t0
    rec = dict(needles=len(sample), needles_per_s=len(sample) / wall,
               p50_us=float(np.percentile(lat, 50) * 1e6), p99_us=float(np.percentile(lat, 99) * 1e6),
               remote_reads=remote[0],
               reconstructions=stats.EC_DEGRADED_READS.value(mode="reconstruct") - rec0)
    print(f"cluster reads ({label}) on the host: {len(sample)} needles byte-exact; "
          f"{rec['needles_per_s']:.1f} needles/s, p50 {rec['p50_us']:.1f} us, p99 "
          f"{rec['p99_us']:.1f} us; {remote[0]} remote EcShardRead answers, "
          f"{rec['reconstructions']:.0f} intervals reconstructed")
    return rec


def phase_cluster(args, directory: str, svc: dict, ident: str, dev) -> dict:
    """Phase 8: the cluster EC path.  One ``cli master`` and four ``cli
    volume -device cuda`` subprocesses (racks alternating) over phase 7's
    needle volume (on server 0) and a 128 MiB LRC volume (on server 1),
    driven by ``cli shell``: ec.encode, remote needle reads, the loss of a
    node, ec.rebuild, ec.decode, and an LRC single loss (module
    docstring)."""
    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as pb
    from seaweedfs_tpu_torch.server.store_ec import EcShardLocator
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.volume import Volume

    vol = svc["vol"]
    root = os.path.join(directory, "cluster")
    dirs = [os.path.join(root, f"v{i}") for i in range(CLUSTER_SERVERS)]
    for d in dirs:
        os.makedirs(d)
    # phase 7's volume, as links to its untouched .dat/.idx; the generate
    # of phase 7's server, hashed from the links phase 7's reads kept
    for ext in (".dat", ".idx"):
        os.link(os.path.join(svc["source_dir"], "1" + ext), os.path.join(dirs[0], "1" + ext))
    dat_sha = sha256(os.path.join(dirs[0], "1.dat"))
    want = {sid: sha256(os.path.join(svc["server"]["reads_dir"], f"1.ec{sid:02d}"))
            for sid in range(14)}
    t = time.perf_counter()
    lrc_src = os.path.join(root, "lrc_src")
    os.mkdir(lrc_src)
    lrc_vol = make_needle_volume(lrc_src, int(LRC_CLUSTER_GIB * (1 << 30)), args.seed + 1)
    for ext in (".dat", ".idx"):
        os.rename(os.path.join(lrc_src, "1" + ext), os.path.join(dirs[1], "lrc_2" + ext))
    print(f"cluster: LRC volume 2 (collection lrc): {lrc_vol['n']} needles, "
          f"{lrc_vol['dat_size']} bytes, {time.perf_counter() - t:.3f}s")
    shell_log = os.path.join(root, "shell.log")
    walls: dict = {}
    servers: list = []
    killed = None
    master = _Server("", "", os.path.join(root, "master.log"), argv=["master", "-port", "0"])
    try:
        maddr = f"127.0.0.1:{master.grpc_port}"
        mstub = rpc.master_stub(maddr)
        t = time.perf_counter()
        servers = [_Server(d, dev.type, os.path.join(root, f"v{i}.log"), wait=False,
                           extra=("-mserver", maddr, "-rack", f"rack{i % 2}"))
                   for i, d in enumerate(dirs)]
        for s_ in servers:
            s_.ready()
            s_.addr = f"127.0.0.1:{s_.grpc_port}"
        walls["servers_up"] = time.perf_counter() - t
        print(f"cluster: master {maddr}; {CLUSTER_SERVERS} volume servers up in "
              f"{walls['servers_up']:.3f}s (each: "
              + ", ".join(f"{s_.start_s:.3f}s" for s_ in servers) + ")")
        for s_ in servers:
            text = s_.metrics()
            check(metric(text, "weedtpu_cuda_kernel_launches", kernel="gf_apply") == 0,
                  f"the new server process {s_.addr} has launched K1")
        by_addr = {s_.addr: s_ for s_ in servers}

        def located(vid: int) -> list[str]:
            resp = mstub.LookupVolume(m_pb.LookupVolumeRequest(volume_or_file_ids=[str(vid)]),
                                      timeout=60)
            return [f"{l.url.rsplit(':', 1)[0]}:{l.grpc_port}"
                    for l in resp.volume_id_locations[0].locations]

        # step 1: the master sees volume 1 on server 0 (and 2 on server 1)
        walls["volume_registered"] = _poll(
            lambda: located(1) == [servers[0].addr] and located(2) == [servers[1].addr],
            "volumes 1 and 2 at the master", 120)

        # step 2: ec.encode, generate on server 0 (K1 on the card), balance
        walls["encode_shell"], _ = _shell(maddr, "lock; ec.encode -volumeId 1; unlock", shell_log)
        # the balance's last moves reach the master in heartbeat deltas: wait
        # until it reports what the servers' disks hold
        on_disk = {s_.addr: dirs[i] for i, s_ in enumerate(servers)}
        _poll(lambda: _ec_census(mstub, 1)["holders"] == _disk_shards(on_disk, "1"),
              "the master's census of volume 1 to match the servers' disks", 60)
        census = _ec_census(mstub, 1)
        holders = census["holders"]
        per_rack = {}
        for addr, sids in holders.items():
            per_rack[census["racks"][addr]] = per_rack.get(census["racks"][addr], 0) + len(sids)
        check(sorted(sid for v in holders.values() for sid in v) == list(range(14)),
              f"shards at the master: {holders}")
        check(max(len(v) for v in holders.values()) <= 4 and sorted(per_rack) == ["rack0", "rack1"],
              f"the balance left {holders} ({per_rack} by rack)")
        check(1 not in census["volumes"] and not any(
            os.path.exists(os.path.join(d, "1.dat")) for d in dirs),
              "the original volume 1 survived ec.encode")
        place = {}
        for addr, sids in holders.items():
            d = dirs[servers.index(by_addr[addr])]
            for sid in sids:
                place[sid] = addr
                check(sha256(os.path.join(d, f"1.ec{sid:02d}")) == want[sid],
                      f"shard {sid} on {addr} differs from phase 7's generate")
        tasks = len(ec_encoder._plan_tasks(DEFAULT_SCHEME, vol["dat_size"], ec_encoder.DEFAULT_CHUNK))
        k1_source = int(metric(servers[0].metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply"))
        check(k1_source == tasks, f"server 0 launched K1 {k1_source} times, the generate has {tasks} batches")
        gen = server_stages(servers[0].log_text(), "generate")
        check(len(gen) == 1, f"server 0 logged {len(gen)} generates")
        copies = [c for s_ in servers for c in server_stages(s_.log_text(), "copy")]
        walls["generate_pipeline"] = gen[0]["wall_s"]
        walls["balance_copies"] = sum(c["wall_s"] for c in copies)
        balance_bytes = sum(c["bytes"] for c in copies)
        print(f"cluster encode on {ident}: 14 shards == phase 7's generate, spread {holders} "
              f"({per_rack} by rack); server 0 K1 launches {k1_source}; generate {stage_line(gen[0])}; "
              f"{len(copies)} balance copies, {balance_bytes} bytes in {walls['balance_copies']:.3f}s")

        # step 3: remote reads from the shards of one server, over the master
        sample = read_sample(vol, args.seed, CLUSTER_READ_SAMPLE, CLUSTER_CROSSING_SAMPLE)
        victim_addr = max((a for a in holders if a != servers[1].addr), key=lambda a: len(holders[a]))
        reader_addr = max((a for a in holders if a != victim_addr), key=lambda a: len(holders[a]))
        reader = by_addr[reader_addr]
        store = Store([dirs[servers.index(reader)]])
        store.mount_ec_shards("", 1, holders[reader_addr])
        ev = store.find_ec_volume(1)
        locator = EcShardLocator(maddr, reader_addr)
        try:
            healthy = _cluster_reads(ev, locator, sample, f"healthy, shards {holders[reader_addr]} "
                                                          f"local on {reader_addr}")
        finally:
            locator.close()
        check(healthy["remote_reads"] > 0, "the healthy reads made no remote EcShardRead")
        check(healthy["reconstructions"] == 0, "the healthy reads reconstructed")

        # step 4: lose the node (other than the reader and the LRC volume's
        # server) that holds the most shards
        lost = holders[victim_addr]
        killed = by_addr[victim_addr]
        k1_by_server = {killed.addr: int(metric(killed.metrics(), "weedtpu_cuda_kernel_launches",
                                                kernel="gf_apply"))}
        killed.proc.send_signal(signal.SIGKILL)
        killed.proc.wait()
        walls["prune_wait"] = _poll(lambda: victim_addr not in _ec_census(mstub, 1)["holders"],
                                    f"the master to prune {victim_addr}", PRUNE_WAIT_S)
        print(f"cluster: SIGKILL {victim_addr} (shards {lost}); pruned by the master after "
              f"{walls['prune_wait']:.3f}s")
        locator = EcShardLocator(maddr, reader_addr)
        try:
            degraded = _cluster_reads(ev, locator, sample, f"{victim_addr} lost")
        finally:
            locator.close()
            store.close()
        check(degraded["reconstructions"] > 0, "the degraded reads reconstructed nothing")

        # step 5: ec.rebuild (no geometry flags)
        copies0 = {s_.addr: len(server_stages(s_.log_text(), "copy")) for s_ in servers if s_ is not killed}
        walls["rebuild_shell"], out = _shell(maddr, "lock; ec.rebuild -volumeId 1; unlock", shell_log)
        # the rebuilt shards' mount reaches the master in a heartbeat delta
        # (the killed server's files stay on its disk, outside the cluster)
        _poll(lambda: _ec_census(mstub, 1)["holders"] == _disk_shards(
            {a_: d for a_, d in on_disk.items() if a_ != killed.addr}, "1"),
              "the master's census of volume 1 after the rebuild to match the disks", 60)
        census = _ec_census(mstub, 1)
        check(sum(len(v) for v in census["holders"].values()) == 14,
              f"shards of volume 1 after the rebuild: {census['holders']}")
        rebuilder = next(by_addr[a] for a, sids in census["holders"].items() if lost[0] in sids)
        rdir = dirs[servers.index(rebuilder)]
        for sid in lost:
            check(census["holders"].get(rebuilder.addr, []).count(sid) == 1,
                  f"shard {sid} not on the rebuilder {rebuilder.addr}: {census['holders']}")
            check(sha256(os.path.join(rdir, f"1.ec{sid:02d}")) == want[sid],
                  f"rebuilt shard {sid} differs from phase 7's generate")
        files = sorted(n for n in os.listdir(rdir) if re.fullmatch(r"1\.ec\d\d", n))
        check(files == [f"1.ec{sid:02d}" for sid in sorted(census["holders"][rebuilder.addr])],
              f"the rebuilder's temp copies were left: {files}")
        staging = server_stages(rebuilder.log_text(), "copy")[copies0[rebuilder.addr]:]
        walls["rebuild_staging"] = sum(c["wall_s"] for c in staging)
        reb = server_stages(rebuilder.log_text(), "rebuild")
        check(len(reb) >= 1, "the rebuilder logged no rebuild")
        walls["rebuild_pipeline"] = reb[-1]["wall_s"]
        k1_rebuilder = int(metric(rebuilder.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply"))
        check(k1_rebuilder > (k1_source if rebuilder is servers[0] else 0),
              f"the rebuilder {rebuilder.addr} launched no K1 for the rebuild ({k1_rebuilder})")
        print(f"cluster rebuild on {ident}: {lost} on {rebuilder.addr} hash-identical, temps gone; "
              f"staging {len(staging)} copies, {sum(c['bytes'] for c in staging)} bytes in "
              f"{walls['rebuild_staging']:.3f}s; K1 launches {k1_rebuilder}; {stage_line(reb[-1])}")

        # step 6: ec.decode
        walls["decode_shell"], _ = _shell(maddr, "lock; ec.decode -volumeId 1; unlock", shell_log)
        _poll(lambda: len(located(1)) == 1 and not _ec_census(mstub, 1)["holders"],
              "the decoded volume 1 at the master, its shards gone", 60)
        decoded_dir = dirs[servers.index(by_addr[located(1)[0]])]

        # step 7: LRC, a single loss staged through its local group only
        walls["lrc_encode_shell"], _ = _shell(
            maddr, "lock; ec.encode -volumeId 2 -collection lrc -code lrc; unlock", shell_log)
        _poll(lambda: _ec_census(mstub, 2)["holders"] == _disk_shards(
            {a_: d for a_, d in on_disk.items() if a_ != killed.addr}, "lrc_2"),
              "the master's census of the LRC volume to match the servers' disks", 60)
        census = _ec_census(mstub, 2)
        check(sum(len(v) for v in census["holders"].values()) == 14,
              f"LRC shards at the master: {census['holders']}")
        check(census["scheme"] == (10, 4, 2), f"the master reports volume 2 as {census['scheme']}")
        h3 = next(a for a, sids in census["holders"].items() if 3 in sids)
        base3 = os.path.join(dirs[servers.index(by_addr[h3])], "lrc_2")
        lrc_sha3 = sha256(base3 + ".ec03")
        shard_size = os.path.getsize(base3 + ".ec03")
        vstub = rpc.volume_stub(h3)
        vstub.EcShardsUnmount(pb.EcShardsUnmountRequest(volume_id=2, shard_ids=[3]), timeout=60)
        vstub.EcShardsDelete(pb.EcShardsDeleteRequest(volume_id=2, collection="lrc", shard_ids=[3]),
                             timeout=60)
        _poll(lambda: sum(len(v) for v in _ec_census(mstub, 2)["holders"].values()) == 13,
              "the master to drop LRC shard 3", 60)
        live = [s_ for s_ in servers if s_ is not killed]

        def moved() -> dict:
            return {s_.addr: metric(s_.metrics(), "weedtpu_repair_bytes_total", code="lrc",
                                    dir="moved", mode="move") for s_ in live}

        before = moved()
        walls["lrc_rebuild_shell"], _ = _shell(maddr, "lock; ec.rebuild -volumeId 2; unlock", shell_log)
        _poll(lambda: sum(len(v) for v in _ec_census(mstub, 2)["holders"].values()) == 14,
              "14 LRC shards after the rebuild", 60)
        census = _ec_census(mstub, 2)
        h3 = next(a for a, sids in census["holders"].items() if 3 in sids)
        check(sha256(os.path.join(dirs[servers.index(by_addr[h3])], "lrc_2.ec03")) == lrc_sha3,
              "the rebuilt LRC shard 3 differs")
        delta = {a: v - before[a] for a, v in moved().items()}
        check(0 < delta[h3] <= 5 * shard_size and sum(delta.values()) == delta[h3],
              f"LRC staging moved {delta} bytes (shard {shard_size}): more than the local group")
        lrc_reb = server_stages(by_addr[h3].log_text(), "rebuild")[-1]
        check(lrc_reb.get("mode") == "local", f"the LRC rebuild was not local: {stage_line(lrc_reb)}")
        print(f"cluster LRC on {ident}: master class {census['scheme']}; shard 3 rebuilt on {h3} "
              f"identical; staging moved {delta[h3]:.0f} bytes = {delta[h3] / shard_size:.2f} shard "
              f"sizes; {stage_line(lrc_reb)}")

        for s_ in live:
            k1_by_server[s_.addr] = int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches",
                                               kernel="gf_apply"))
    finally:
        rcs = {s_.addr if hasattr(s_, "addr") else s_.proc.pid: s_.stop() for s_ in servers}
        rcs["master"] = master.stop()
    check(all(rc == 0 for a, rc in rcs.items() if killed is None or a != killed.addr),
          f"cluster processes exited {rcs}")
    check(rcs[killed.addr] == -signal.SIGKILL, f"the killed server exited {rcs[killed.addr]}")

    # the decoded volume, opened here now that its server has stopped
    v = Volume(decoded_dir, 1, create=False)
    try:
        check(sha256(v.base + ".dat") == dat_sha, "the decoded .dat differs from the original")
        for nid, payload in read_sample(vol, args.seed + 2, 500):
            check(v.read_needle(nid).data == payload, f"decoded volume: needle {nid:x} differs")
    finally:
        v.close()
    launches = sum(k1_by_server.values())
    rec = dict(walls=walls, healthy=healthy, degraded=degraded, k1_source=k1_source,
               k1_rebuilder=k1_rebuilder, k1_by_server=k1_by_server, launches=launches,
               lost=lost, balance_bytes=balance_bytes, lrc_staging_bytes=delta[h3],
               lrc_shard_size=shard_size, server_start_s=[s_.start_s for s_ in servers],
               rcs={str(k): v_ for k, v_ in rcs.items()})
    print(f"decode on {ident}: .dat sha256 == the original; 500 needles read back in process")
    print("cluster: " + json.dumps(rec, sort_keys=True))
    return rec


# -- phase 9 ------------------------------------------------------------------

BENCH_N = 4096  # `weed benchmark` -n 1048576, cut 256x for the time limit (8,192 before phase 17)
BENCH_SIZE = 1024  # `weed benchmark` -size
BENCH_C = 16  # `weed benchmark` -c
REP_N = 1250  # DATA_PLANE.md's replicated-write row (5,000), quartered for the time limit (2,500 before phase 17)
FILL_N, FILL_SIZE = 4096, 64 * 1024  # 256 MiB of DATA_PLANE.md's 64 KB payloads (1 GiB before phase 18, 512 MiB before 19)
SEEDED_NEEDLES = 512  # 1,024 before phase 17
EC_READ_SAMPLE = 256  # cut from 4,096 for the time limit (1,024 before phase 17, 512 before 19)
EC_DELETES = 64


def _benchmark(maddr: str, n: int, size: int, collection: str, replication: str,
               log: str) -> list[dict]:
    """``cli benchmark`` in a subprocess: its write and read reports, each
    with 0 errors and every request answered."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    argv = ["benchmark", "-master", maddr, "-n", str(n), "-size", str(size), "-c", str(BENCH_C),
            "-collection", collection, "-replication", replication]
    t = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch.cli", *argv], cwd=root,
                         env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    with open(log, "a") as f:
        f.write(f"$ {' '.join(argv)} ({wall:.3f}s, rc {run.returncode})\n{run.stdout}{run.stderr}")
    check(run.returncode == 0, f"benchmark {argv} exited {run.returncode}: {run.stderr[-2000:]}")
    reports = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    check([r["phase"] for r in reports] == ["write", "read"], f"benchmark printed {run.stdout!r}")
    for r in reports:
        check(r["errors"] == 0 and r["requests"] == n,
              f"benchmark {collection} {r['phase']}: {r['requests']} answered, {r['errors']} "
              f"errors: {r.get('error_samples')}")
        print(f"write path: benchmark -n {n} -size {size} -c {BENCH_C} -collection {collection} "
              f"-replication {replication} {r['phase']}: {r['req_per_sec']} req/s, "
              f"{r['mb_per_sec']} MB/s, p50 {r['p50_ms']} ms, p90 {r['p90_ms']} ms, p99 "
              f"{r['p99_ms']} ms, {r['errors']} errors")
    return reports


def _live_entries(base: str):
    """The live entries (id, off, size) of ``base``.idx, the last entry of a
    key winning."""
    import numpy as np

    entry = np.dtype([("id", ">u8"), ("off", ">u4"), ("size", ">i4")])
    raw = np.fromfile(base + ".idx", dtype=np.uint8)
    idx = raw[: raw.size - raw.size % entry.itemsize].view(entry)
    _, last = np.unique(idx["id"][::-1], return_index=True)
    live = idx[len(idx) - 1 - last]
    return live[(live["off"] > 0) & (live["size"] > 0)]


def _volume_fids(base: str, vid: int) -> list[str]:
    """The fid of every live needle of the volume at ``base`` (its .idx and
    each needle's cookie from its .dat record)."""
    live = _live_entries(base)
    fids = []
    with open(base + ".dat", "rb") as f:
        for key, off in zip(live["id"].tolist(), live["off"].tolist()):
            cookie = int.from_bytes(os.pread(f.fileno(), 4, off * 8), "big")
            fids.append(f"{vid},{key:x}{cookie:08x}")
    return fids


def phase_write_path(args, directory: str, ident: str, dev) -> dict:
    """Phase 9: the write path.  One ``cli master`` and four ``cli volume
    -device cuda -max 8`` subprocesses (racks alternating), each with its
    HTTP port bound; ``cli benchmark`` writes and reads (9a), replicated
    writes read back from both holders (9b), one 256 MiB volume filled by the
    benchmark and 512 seeded needles (9c), ``ec.encode -streaming`` of it
    through K1 on its server (9d), reads of the EC volume over HTTP (9e) and
    deletes (9f) (module docstring)."""
    import numpy as np

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.util.http_pool import HttpConnectionPool
    from seaweedfs_tpu_torch.wdclient import MasterClient

    root = os.path.join(directory, "write")
    dirs = [os.path.join(root, f"v{i}") for i in range(CLUSTER_SERVERS)]
    for d in dirs:
        os.makedirs(d)
    bench_log = os.path.join(root, "benchmark.log")
    shell_log = os.path.join(root, "shell.log")
    walls: dict = {}
    servers: list = []
    pool = HttpConnectionPool(timeout=60.0)
    master = _Server("", "", os.path.join(root, "master.log"), argv=["master", "-port", "0"])
    try:
        maddr = f"127.0.0.1:{master.grpc_port}"
        mhttp = f"127.0.0.1:{master.http_port}"
        mstub = rpc.master_stub(maddr)
        t = time.perf_counter()
        servers = [_Server(d, dev.type, os.path.join(root, f"v{i}.log"), wait=False,
                           extra=("-mserver", maddr, "-rack", f"rack{i % 2}", "-max", "8"))
                   for i, d in enumerate(dirs)]
        for s_ in servers:
            s_.ready()
            check(s_.http_port is not None, "a volume server bound no HTTP port")
            s_.url = f"127.0.0.1:{s_.http_port}"
        by_url = {s_.url: s_ for s_ in servers}

        def nodes() -> set:
            topo = mstub.VolumeList(m_pb.VolumeListRequest(), timeout=60).topology_info
            return {dn.id for dc in topo.data_center_infos for r in dc.rack_infos
                    for dn in r.data_node_infos}

        walls["servers_up"] = time.perf_counter() - t
        walls["registered"] = _poll(lambda: nodes() == set(by_url), "4 nodes named ip:httpport", 120)
        print(f"write path: master {maddr} (HTTP {mhttp}); {CLUSTER_SERVERS} volume servers "
              f"{sorted(by_url)} up in {walls['servers_up']:.3f}s, registered by their HTTP "
              f"ports after {walls['registered']:.3f}s")
        for s_ in servers:
            check(metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply") == 0,
                  f"the new server process {s_.url} has launched K1")

        def lookup(vid: int) -> list[str]:
            status, body = pool.request(mhttp, "GET", f"/dir/lookup?volumeId={vid}")
            check(status == 200, f"/dir/lookup?volumeId={vid}: {status} {body[:200]!r}")
            return [loc["url"] for loc in json.loads(body)["locations"]]

        def collection_vids(collection: str) -> list[int]:
            topo = mstub.VolumeList(m_pb.VolumeListRequest(), timeout=60).topology_info
            return sorted({v.id for dc in topo.data_center_infos for r in dc.rack_infos
                           for dn in r.data_node_infos for disk in dn.disk_infos.values()
                           for v in disk.volume_infos if v.collection == collection})

        def base_on(url: str, collection: str, vid: int) -> str:
            return os.path.join(dirs[servers.index(by_url[url])], f"{collection}_{vid}")

        # 9a: writes and reads, the upstream `weed benchmark` shape
        dp0 = {s_.url: native_dp(s_.url) for s_ in servers}
        bench = _benchmark(maddr, BENCH_N, BENCH_SIZE, "benchmark", "000", bench_log)
        dp_a = {s_.url: native_dp(s_.url) for s_ in servers}
        native = {"bench": native_dp_delta(dp_a, dp0)}
        check(native["bench"]["native_writes"] > 0 and native["bench"]["native_reads"] > 0,
              f"the benchmark's POSTs and GETs never reached the native plane: {native['bench']}")
        print(f"write path: the benchmark on the native plane: POSTs {native['bench']['native_writes']}, "
              f"GETs {native['bench']['native_reads']}, forwarded {native['bench']['forwarded']} "
              f"(seaweedfs_volume_native_dp of the four servers)")

        # 9b: replicated writes, each acknowledged one on both holders
        rep = _benchmark(maddr, REP_N, BENCH_SIZE, "rep", "001", bench_log)
        rep_vids = collection_vids("rep")
        rep_fids, rep_payloads, t = 0, set(), time.perf_counter()
        for vid in rep_vids:
            holders = lookup(vid)
            check(len(holders) == 2, f"rep volume {vid} has holders {holders}")
            fids = [_volume_fids(base_on(u, "rep", vid), vid) for u in holders]
            check(sorted(fids[0]) == sorted(fids[1]), f"rep volume {vid}: the holders' needles differ")

            def read_back(fid: str, holders=holders) -> list[str]:
                out = []
                for url in holders:
                    status, body = pool.request(url, "GET", f"/{fid}")
                    check(status == 200 and len(body) == BENCH_SIZE,
                          f"replica {url} of {fid}: {status}, {len(body)} bytes")
                    out.append(hashlib.sha256(body).hexdigest())
                return out

            with ThreadPoolExecutor(BENCH_C) as readers:
                for digests in readers.map(read_back, fids[0]):
                    rep_payloads.update(digests)
            rep_fids += len(fids[0])
        walls["rep_readback"] = time.perf_counter() - t
        check(rep_fids == REP_N and len(rep_payloads) == 1,
              f"{rep_fids} replicated needles ({len(rep_payloads)} payloads) for {REP_N} writes")
        dp_b = {s_.url: native_dp(s_.url) for s_ in servers}
        native["rep"] = native_dp_delta(dp_b, dp_a)
        # every replica-side write (?type=replicate) is native; a primary
        # that fanned out natively adds its own: the excess over REP_N
        native["rep_fanned_out"] = native["rep"]["native_writes"] - REP_N
        check(native["rep_fanned_out"] > 0,
              f"no replicated write fanned out on the native plane: {native['rep']}")
        print(f"write path: {REP_N} writes at 001: {native['rep_fanned_out']} fanned out by the "
              f"primary's native plane, {native['rep']['forwarded']} forwarded to Python; native "
              f"POSTs {native['rep']['native_writes']}, GETs {native['rep']['native_reads']}")
        print(f"write path: {rep_fids} replicated needles in {len(rep_vids)} volume(s) read back "
              f"from both holders each, byte-identical, in {walls['rep_readback']:.3f}s")

        # 9c: one real volume: the benchmark's 256 MiB and SEEDED_NEEDLES seeded ones
        fill = _benchmark(maddr, FILL_N, FILL_SIZE, "ec64k", "000", bench_log)
        (vid,) = collection_vids("ec64k")
        mc = MasterClient(maddr)
        rng = np.random.default_rng(args.seed + 9)
        seeded, t = {}, time.perf_counter()
        for i in range(SEEDED_NEEDLES):
            a = mc.assign(collection="ec64k")
            check(int(a.fid.split(",")[0]) == vid, f"seeded needle {i} went to volume {a.fid}")
            payload = rng.bytes(int(rng.integers(1, FILL_SIZE + 1)))
            status, body = pool.request(a.location.url, "POST", f"/{a.fid}", body=payload)
            check(status == 201, f"POST {a.fid}: {status} {body[:200]!r}")
            seeded[a.fid] = payload
        walls["seeded_writes"] = time.perf_counter() - t
        (source_url,) = lookup(vid)
        source = by_url[source_url]
        src_base = base_on(source_url, "ec64k", vid)
        dat_size = os.path.getsize(src_base + ".dat")
        native["fill"] = native_dp_delta({source_url: native_dp(source_url)},
                                         {source_url: dp_b[source_url]})
        check(native["fill"]["native_writes"] >= FILL_N,
              f"volume {vid}'s needles were not written natively: {native['fill']}")
        rows = sample_rows(src_base + ".dat", dat_size)
        bench_fids = sorted(set(_volume_fids(src_base, vid)) - set(seeded))
        check(len(bench_fids) == FILL_N and dat_size >= FILL_N * FILL_SIZE,
              f"volume {vid}: {len(bench_fids)} benchmark needles, {dat_size} bytes")
        sample = [bench_fids[i] for i in rng.choice(len(bench_fids), EC_READ_SAMPLE, replace=False)]
        bench_payload = {}
        for fid in sample[:16]:
            status, body = pool.request(source_url, "GET", f"/{fid}")
            check(status == 200 and len(body) == FILL_SIZE, f"GET {fid} before the encode: {status}")
            bench_payload[hashlib.sha256(body).hexdigest()] = body
        check(len(bench_payload) == 1, "the benchmark wrote more than one payload")
        (bench_body,) = bench_payload.values()
        print(f"write path: volume {vid} on {source_url}: {dat_size} bytes, {FILL_N} benchmark "
              f"needles + {SEEDED_NEEDLES} seeded ones written in {walls['seeded_writes']:.3f}s")

        # 9d: ec.encode -streaming: every shard straight to its holder, K1 on
        # the source server
        walls["encode_shell"], out = _shell(
            maddr, f"lock; ec.encode -volumeId {vid} -collection ec64k -streaming; unlock", shell_log)
        check(f"ec.encode volume {vid} -> RS(10,4) [streamed to holders]" in out,
              f"the shell did not stream: {out!r}")
        moved = re.search(r"ec\.balance moved (\d+) shards", out)
        check(moved is not None, f"no balance line in {out!r}")
        on_disk = {f"127.0.0.1:{s_.grpc_port}": dirs[i] for i, s_ in enumerate(servers)}
        _poll(lambda: _ec_census(mstub, vid)["holders"] == _disk_shards(on_disk, f"ec64k_{vid}"),
              f"the master's census of volume {vid} to match the servers' disks", 60)
        census = _ec_census(mstub, vid)
        holders = census["holders"]
        per_rack: dict = {}
        for addr, sids in holders.items():
            per_rack[census["racks"][addr]] = per_rack.get(census["racks"][addr], 0) + len(sids)
        check(sorted(sid for v in holders.values() for sid in v) == list(range(14)),
              f"shards at the master: {holders}")
        check(max(len(v) for v in holders.values()) <= DEFAULT_SCHEME.max_shards_per_disk
              and sorted(per_rack) == ["rack0", "rack1"],
              f"the streaming encode left {holders} ({per_rack} by rack)")
        files = {f"v{i}": sorted(n for n in os.listdir(d) if n.startswith(f"ec64k_{vid}."))
                 for i, d in enumerate(dirs)}
        on_disk = sorted(n for names in files.values() for n in names if re.search(r"\.ec\d\d$", n))
        check(on_disk == [f"ec64k_{vid}.ec{sid:02d}" for sid in range(14)],
              f"shard files after the encode (no copy may remain twice): {files}")
        check(not any(n.endswith((".dat", ".idx", ".tmp")) for names in files.values()
                      for n in names), f"a .dat, .idx or .tmp remained: {files}")
        shard_path = {int(n[-2:]): os.path.join(dirs[int(v[1:])], n) for v, names in files.items()
                      for n in names if re.search(r"\.ec\d\d$", n)}
        check_sampled_parity(rows, shard_path)
        tasks = len(ec_encoder._plan_tasks(DEFAULT_SCHEME, dat_size, ec_encoder.DEFAULT_CHUNK))
        k1_source = int(metric(source.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply"))
        check(k1_source == tasks, f"the source server launched K1 {k1_source} times, its generate "
                                  f"has {tasks} batches")
        gen = server_stages(source.log_text(), "generate")
        check(len(gen) == 1, f"the source server logged {len(gen)} generates")
        shard_size = DEFAULT_SCHEME.shard_file_size(dat_size)
        streams = {s_.url: server_stages(s_.log_text(), "receive") for s_ in servers}
        received = {url: sum(r["bytes"] for r in rs) for url, rs in streams.items()}
        shards_in = [r for rs in streams.values() for r in rs if re.fullmatch(r"\.ec\d\d", r["ext"])]
        check(all(r["bytes"] == shard_size for r in shards_in)
              and 14 - DEFAULT_SCHEME.max_shards_per_disk <= len(shards_in) <= 14,
              f"the targets received {[(r['ext'], r['bytes']) for r in shards_in]} (shards of "
              f"{shard_size} bytes)")
        copies = [c for s_ in servers for c in server_stages(s_.log_text(), "copy") if c["shards"]]
        walls["generate_pipeline"] = gen[0]["wall_s"]
        print(f"write path: ec.encode -streaming of volume {vid} on {ident}: shell "
              f"{walls['encode_shell']:.3f}s; source {source_url} K1 launches {k1_source} "
              f"(= {tasks} batches); generate {stage_line(gen[0])}; {len(shards_in)} shards streamed, "
              f"bytes received by target {received}; shards {holders} ({per_rack} by "
              f"rack); ec.balance moved {moved[1]} shards ({len(copies)} shard copies); no .dat "
              f"or .tmp left")

        # 9e: reads of the EC volume, each resolved through /dir/lookup
        ecx_dir = dirs[servers.index(by_url[lookup(vid)[0]])]
        ev = EcVolume(ecx_dir, vid, "ec64k", scheme=None)
        shard_of = {sid: addr for addr, sids in holders.items() for sid in sids}
        grpc_of = {s_.url: f"127.0.0.1:{s_.grpc_port}" for s_ in servers}
        reads = [(fid, payload) for fid, payload in seeded.items()]
        reads += [(fid, bench_body) for fid in sample]
        order = rng.permutation(len(reads))
        lat = np.empty(len(reads))
        remote_intervals = 0
        t0 = time.perf_counter()
        for j, i in enumerate(order):
            fid, payload = reads[i]
            t = time.perf_counter()
            urls = lookup(vid)
            status, body = pool.request(urls[0], "GET", f"/{fid}")
            lat[j] = time.perf_counter() - t
            check(status == 200 and body == payload, f"EC read of {fid} from {urls[0]}: {status}, "
                                                     f"{len(body)} bytes")
            nid = int(fid.split(",")[1][:-8], 16)
            remote_intervals += sum(shard_of[iv.to_shard_and_offset(ev.scheme)[0]] != grpc_of[urls[0]]
                                    for iv in ev.locate(nid)[2])
        walls["ec_reads"] = time.perf_counter() - t0
        ev.close()
        ec_reads = dict(reads=len(reads), reads_per_s=len(reads) / walls["ec_reads"],
                        p50_ms=float(np.percentile(lat, 50) * 1e3),
                        p99_ms=float(np.percentile(lat, 99) * 1e3),
                        remote_intervals=remote_intervals)
        reconstructed = sum(metric(s_.metrics(), "weedtpu_ec_degraded_reads_total",
                                   mode="reconstruct") for s_ in servers)
        check(reconstructed == 0, f"healthy EC reads reconstructed {reconstructed} intervals")
        print(f"write path: {len(reads)} EC reads ({SEEDED_NEEDLES} seeded, {len(sample)} benchmark) "
              f"through /dir/lookup + GET, each equal to its payload, on the host: "
              f"{ec_reads['reads_per_s']:.1f} reads/s, p50 {ec_reads['p50_ms']:.3f} ms, p99 "
              f"{ec_reads['p99_ms']:.3f} ms; {remote_intervals} intervals answered by remote holders "
              f"(from the .ecx and the census), 0 reconstructed")

        # 9f: deletes on the EC volume, then 404s
        doomed = [fid for fid in seeded][:EC_DELETES]
        for fid in doomed:
            url = lookup(vid)[0]
            status, body = pool.request(url, "DELETE", f"/{fid}")
            check(status == 202, f"DELETE {fid} on {url}: {status} {body!r}")
        for fid in doomed:
            url = lookup(vid)[0]
            status, body = pool.request(url, "GET", f"/{fid}")
            check(status == 404, f"GET of the deleted {fid} on {url}: {status}")
        print(f"write path: {len(doomed)} seeded needles deleted on the EC volume (202), each GET "
              f"then 404")
        k1_by_server = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches",
                                           kernel="gf_apply")) for s_ in servers}
    finally:
        pool.close()
        rcs = {getattr(s_, "url", s_.proc.pid): s_.stop() for s_ in servers}
        rcs["master"] = master.stop()
    check(all(rc == 0 for rc in rcs.values()), f"write path processes exited {rcs}")
    launches = sum(k1_by_server.values())
    check(launches == k1_source, f"K1 launched outside the source's generate: {k1_by_server}")
    rec = dict(walls=walls, benchmark=bench, replicated=rep, fill=fill, ec_reads=ec_reads,
               native=native,
               k1_source=k1_source, batches=tasks, launches=launches, received=received,
               balance_moved=int(moved[1]), shard_copies=len(copies), dat_size=dat_size,
               generate=gen[0], rcs={str(k): v for k, v in rcs.items()})
    print("write path: " + json.dumps(rec, sort_keys=True))
    return rec


HA_MASTERS = 3
HA_WRITERS = 16  # `weed benchmark`'s -c
HA_WINDOW_S = 7.0  # writes before the kill, and after a new leader answers (10 before phase 17)
HA_BENCH_N = 2048  # cut from 16,384 for the time limit (4,096 before phase 17)
HA_EC_N, HA_EC_SIZE = 1024, 64 * 1024  # one 64 MiB volume of 64 KiB needles (2,048 before phase 17)


def _free_ports(n: int) -> list[int]:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s_ in socks:
        s_.bind(("127.0.0.1", 0))
    ports = [s_.getsockname()[1] for s_ in socks]
    for s_ in socks:
        s_.close()
    return ports


def _http_json(addr: str, path: str, timeout: float = 2.0):
    """GET on a fresh connection: (status, JSON body), or None when the
    peer does not answer (a killed master)."""
    import http.client

    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    except (OSError, ValueError, http.client.HTTPException):
        return None
    finally:
        conn.close()


def _ha_payload(fid: str) -> bytes:
    """Each write's 1 KiB payload, derived from its fid."""
    return hashlib.shake_256(fid.encode()).digest(BENCH_SIZE)


def phase_failover(args, directory: str, ident: str, dev) -> dict:
    """Phase 10: master failover.  Three ``cli master -ha raft`` and four
    ``cli volume -device cuda -max 8 -mserver m0,m1,m2`` subprocesses; 16
    writers through MasterClient(m0,m1,m2) at replication 001 while the
    leading master is SIGKILLed; the killed master restarts on its -mdir
    and rejoins; every acknowledged write unique and on both holders;
    ``cli benchmark`` through the master list; ``ec.encode`` of a 128 MiB
    volume through the new leader, K1 on its server (module docstring)."""
    import numpy as np

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.util.http_pool import HttpConnectionPool
    from seaweedfs_tpu_torch.wdclient import MasterClient

    root = os.path.join(directory, "failover")
    dirs = [os.path.join(root, f"v{i}") for i in range(CLUSTER_SERVERS)]
    for d in dirs:
        os.makedirs(d)
    log = os.path.join(root, "shell.log")
    ports = _free_ports(2 * HA_MASTERS)
    http_addrs = [f"127.0.0.1:{p}" for p in ports[:HA_MASTERS]]
    grpc_addrs = [f"127.0.0.1:{p}" for p in ports[HA_MASTERS:]]
    mlist = ",".join(grpc_addrs)

    def master_argv(i: int) -> list:
        return ["master", "-port", str(ports[i]), "-grpcPort", str(ports[HA_MASTERS + i]),
                "-ha", "raft", "-peers", ",".join(http_addrs), "-mdir",
                os.path.join(root, f"m{i}")]

    def statuses() -> dict:
        """{master index: /cluster/status} of the masters that answer."""
        out = {}
        for i, addr in enumerate(http_addrs):
            got = _http_json(addr, "/cluster/status")
            if got is not None and got[0] == 200:
                out[i] = got[1]
        return out

    def leader(exclude=None) -> int | None:
        """The index of the one master that leads and that every other
        answering master names, else None."""
        st = {i: s_ for i, s_ in statuses().items() if i != exclude}
        leads = [i for i, s_ in st.items() if s_["IsLeader"]]
        if len(leads) != 1 or any(s_["Leader"] != http_addrs[leads[0]] for s_ in st.values()):
            return None
        return leads[0]

    def census(i: int) -> dict:
        """{node id: {vid: collection}} at master i, asked on a channel of
        its own: the observer must not wait out the breaker that the
        writers' failed calls opened in this process's stub, or the
        re-homing it times is the client's cooldown, not the servers'."""
        import grpc

        with grpc.insecure_channel(grpc_addrs[i]) as ch:
            topo = ch.unary_unary(
                "/weedtpu.master.Master/VolumeList",
                request_serializer=m_pb.VolumeListRequest.SerializeToString,
                response_deserializer=m_pb.VolumeListResponse.FromString)(
                    m_pb.VolumeListRequest(), timeout=30).topology_info
        return {dn.id: {v.id: v.collection for disk in dn.disk_infos.values()
                        for v in disk.volume_infos}
                for dc in topo.data_center_infos for r in dc.rack_infos for dn in r.data_node_infos}

    def census_now(i: int) -> dict:
        """census(i), or {} while master i refuses (still electing).  What a
        poll waits through."""
        import grpc

        try:
            return census(i)
        except grpc.RpcError:
            return {}

    walls: dict = {}
    masters: list = []
    servers: list = []
    t_phase = time.perf_counter()
    pool = HttpConnectionPool(timeout=60.0, max_per_host=64)
    try:
        t = time.perf_counter()
        masters = [_Server("", "", os.path.join(root, f"m{i}.log"), argv=master_argv(i), wait=False)
                   for i in range(HA_MASTERS)]
        for m in masters:
            m.ready()
        walls["masters_up"] = time.perf_counter() - t
        walls["first_leader"] = _poll(lambda: leader() is not None, "a raft leader", 60)
        t = time.perf_counter()
        servers = [_Server(d, dev.type, os.path.join(root, f"v{i}.log"), wait=False,
                           extra=("-mserver", mlist, "-rack", f"rack{i % 2}", "-max", "8"))
                   for i, d in enumerate(dirs)]
        for s_ in servers:
            s_.ready()
            s_.url = f"127.0.0.1:{s_.http_port}"
        by_url = {s_.url: s_ for s_ in servers}
        walls["servers_up"] = time.perf_counter() - t
        first = leader()
        walls["registered"] = _poll(lambda: set(census_now(first)) == set(by_url),
                                    "4 nodes at the raft leader", 120)
        print(f"failover: masters {grpc_addrs} (HTTP {http_addrs}) up in "
              f"{walls['masters_up']:.3f}s, m{first} leads after {walls['first_leader']:.3f}s; "
              f"{CLUSTER_SERVERS} volume servers up in {walls['servers_up']:.3f}s, all at the "
              f"leader after {walls['registered']:.3f}s")

        # the writes: assign + POST at 001 through the master list
        mc = MasterClient(mlist)
        acks: list = []  # (fid, url, acked at, latency)
        errors: list = []  # (at, what)
        stop = threading.Event()

        def writer() -> None:
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    a = mc.assign(collection="ha", replication="001")
                    status, body = pool.request(a.location.url, "POST", f"/{a.fid}",
                                                body=_ha_payload(a.fid))
                except Exception as e:  # noqa: BLE001 — every failed write is reported
                    errors.append((time.perf_counter(), f"{type(e).__name__}: {e}"[:200]))
                    time.sleep(0.05)
                    continue
                t1 = time.perf_counter()
                if status == 201:
                    acks.append((a.fid, a.location.url, t1, t1 - t0))
                else:
                    errors.append((t1, f"POST {a.fid}: {status} {body[:120]!r}"))
                    time.sleep(0.05)

        threads = [threading.Thread(target=writer, daemon=True) for _ in range(HA_WRITERS)]
        t_start = time.perf_counter()
        for th in threads:
            th.start()
        time.sleep(HA_WINDOW_S)
        victim = leader()
        check(victim is not None, f"no single leader before the kill: {statuses()}")
        masters[victim].proc.kill()
        t_kill = time.perf_counter()
        masters[victim].stop()
        print(f"failover: SIGKILLed the leader m{victim} ({http_addrs[victim]}, place {victim} of "
              f"{HA_MASTERS} in -mserver/-master) after {t_kill - t_start:.3f}s of writes, "
              f"{len(acks)} acknowledged")
        new = None
        while new is None:
            check(time.perf_counter() - t_kill < 60, "no new leader within 60 s of the kill")
            new = leader(exclude=victim)
            time.sleep(0.02)
        t_leader = time.perf_counter()
        _poll(lambda: set(census_now(new)) == set(by_url), "the four servers at the new leader",
              60)
        t_rehomed = time.perf_counter()
        while time.perf_counter() < t_leader + HA_WINDOW_S:
            time.sleep(0.1)
        stop.set()
        for th in threads:
            th.join(timeout=120)
        t_end = time.perf_counter()
        after = [a for a in acks if a[2] - a[3] > t_kill]  # assigned after the kill
        check(bool(after), "no write was acknowledged after the kill")

        def window(lo: float, hi: float) -> dict:
            lat = np.array([a[3] for a in acks if lo <= a[2] < hi])
            return dict(writes=int(lat.size), req_per_s=float(lat.size / (hi - lo)),
                        p50_ms=float(np.percentile(lat, 50) * 1e3),
                        p99_ms=float(np.percentile(lat, 99) * 1e3))

        rec = dict(killed=victim, new_leader=new,
                   leader_s=t_leader - t_kill, rehomed_s=t_rehomed - t_kill,
                   first_ack_s=min(a[2] for a in after) - t_kill,
                   before=window(t_start, t_kill), after=window(t_leader, t_end),
                   acked=len(acks), errors=len(errors),
                   errors_before_kill=sum(e[0] < t_kill for e in errors),
                   error_samples=sorted({e[1] for e in errors})[:8],
                   last_error_after_kill_s=max((e[0] - t_kill for e in errors), default=None))
        print(f"failover: kill -> new leader m{new} {rec['leader_s']:.3f}s, -> 4 servers re-homed "
              f"{rec['rehomed_s']:.3f}s, -> first acknowledged write {rec['first_ack_s']:.3f}s; "
              f"writes before {rec['before']['req_per_s']:.1f} req/s (p50 "
              f"{rec['before']['p50_ms']:.2f}, p99 {rec['before']['p99_ms']:.2f} ms), after "
              f"{rec['after']['req_per_s']:.1f} req/s (p50 {rec['after']['p50_ms']:.2f}, p99 "
              f"{rec['after']['p99_ms']:.2f} ms); {len(acks)} acknowledged, {len(errors)} write "
              f"errors (reported, retried): {rec['error_samples']}")

        # the killed master restarts on its -mdir and rejoins as a follower
        t = time.perf_counter()
        masters[victim] = _Server("", "", os.path.join(root, f"m{victim}.restart.log"),
                                  argv=master_argv(victim))

        def caught_up() -> bool:
            got = _http_json(http_addrs[victim], "/cluster/raft/ps")
            ldr = _http_json(http_addrs[new], "/cluster/raft/ps")
            return (got is not None and ldr is not None and got[1]["role"] == "follower"
                    and got[1]["leader"] == http_addrs[new]
                    and got[1]["commit_index"] >= ldr[1]["commit_index"] - 1)

        _poll(caught_up, f"m{victim} to rejoin as a follower", 60)
        walls["rejoined"] = time.perf_counter() - t
        check(leader() == new, f"the restart moved the leadership: {statuses()}")
        _, out = _shell(mlist, "cluster.raft.ps", log)
        rows = [line.split() for line in out.splitlines()[1:] if line.strip()]
        check(sorted(r[0] for r in rows) == sorted(http_addrs)
              and [r[1] for r in rows].count("leader") == 1
              and next(r[0] for r in rows if r[1] == "leader") == http_addrs[new],
              f"cluster.raft.ps after the restart: {out!r}")
        print(f"failover: m{victim} restarted on its -mdir and caught up as a follower in "
              f"{walls['rejoined']:.3f}s; cluster.raft.ps lists 3 members, leader m{new}")

        # every acknowledged write is unique and on both holders
        fids = [a[0] for a in acks]
        check(len(set(fids)) == len(fids), "a fid was acknowledged twice")
        keys = [int(f.split(",")[1][:-8], 16) for f in fids]
        check(len(set(keys)) == len(keys), "a file key was issued twice")
        holders = {}
        for fid in fids:
            vid = int(fid.split(",")[0])
            if vid not in holders:
                holders[vid] = sorted(u for u, vols in census(new).items() if vid in vols)
                check(len(holders[vid]) == 2, f"ha volume {vid} has holders {holders[vid]}")

        def read_back(fid: str) -> int:
            want = _ha_payload(fid)
            for url in holders[int(fid.split(",")[0])]:
                status, body = pool.request(url, "GET", f"/{fid}")
                check(status == 200 and body == want, f"{fid} on {url}: {status}, {len(body)} B")
            return 2

        t = time.perf_counter()
        with ThreadPoolExecutor(HA_WRITERS) as readers:
            reads = sum(readers.map(read_back, fids))
        walls["read_back"] = time.perf_counter() - t
        print(f"failover: {len(fids)} acknowledged writes ({len(set(keys))} distinct keys) in "
              f"{len(holders)} volume(s), each read back byte-identical from both holders "
              f"({reads} GETs in {walls['read_back']:.3f}s)")

        # the benchmark through the master list, then one 128 MiB volume
        bench = _benchmark(mlist, HA_BENCH_N, BENCH_SIZE, "habench", "000", log)
        fill = _benchmark(mlist, HA_EC_N, HA_EC_SIZE, "haec", "000", log)
        topo = census(new)
        (vid,) = sorted({v for vols in topo.values() for v, c in vols.items() if c == "haec"})
        (source_url,) = [u for u, vols in topo.items() if vid in vols]
        source = by_url[source_url]
        src_base = os.path.join(dirs[servers.index(source)], f"haec_{vid}")
        dat_size = os.path.getsize(src_base + ".dat")
        check(dat_size >= HA_EC_N * HA_EC_SIZE, f"volume {vid}: {dat_size} bytes")

        # no volume id and no file key twice: each volume's .dat on exactly
        # its copies, and no needle id in two volumes
        copies = {"ha": 2, "habench": 1, "haec": 1}
        where: dict = {}
        for i, d in enumerate(dirs):
            for name in os.listdir(d):
                m = re.fullmatch(r"(\w+)_(\d+)\.dat", name)
                if m:
                    where.setdefault(int(m[2]), []).append((m[1], i))
        for v, held in sorted(where.items()):
            check(len({c for c, _ in held}) == 1 and len(held) == copies[held[0][0]],
                  f"volume id {v} is held as {held}")
        owner: dict = {}
        for v, held in where.items():
            for key in _live_entries(os.path.join(dirs[held[0][1]], f"{held[0][0]}_{v}"))["id"].tolist():
                check(owner.setdefault(key, v) == v, f"needle id {key:x} in volumes "
                                                     f"{owner[key]} and {v}")
        print(f"failover: {len(where)} volume ids each on its own copies only; {len(owner)} "
              f"needle ids, none in two volumes (across the failover and the restart)")

        # ec.encode through the new leader: K1 on the source's card, shards
        # equal to the CPU plain version's encoding of the same .dat
        ref = os.path.join(root, "ref")
        os.mkdir(ref)
        for ext in (".dat", ".idx"):
            os.link(src_base + ext, os.path.join(ref, f"haec_{vid}{ext}"))
        t = time.perf_counter()
        ec_encoder.write_ec_files(os.path.join(ref, f"haec_{vid}"), device="cpu")
        walls["cpu_reference_encode"] = time.perf_counter() - t
        want = {sid: sha256(os.path.join(ref, f"haec_{vid}.ec{sid:02d}")) for sid in range(14)}
        walls["encode_shell"], out = _shell(
            mlist, f"lock; ec.encode -volumeId {vid} -collection haec; unlock", log)
        on_disk = {f"127.0.0.1:{s_.grpc_port}": dirs[i] for i, s_ in enumerate(servers)}
        new_stub = rpc.master_stub(grpc_addrs[new])
        _poll(lambda: _ec_census(new_stub, vid)["holders"] == _disk_shards(on_disk, f"haec_{vid}"),
              f"the new leader's census of volume {vid} to match the servers' disks", 60)
        shard_files = {sid: os.path.join(dirs[i], f"haec_{vid}.ec{sid:02d}")
                       for i, d in enumerate(dirs) for sid in range(14)
                       if os.path.exists(os.path.join(d, f"haec_{vid}.ec{sid:02d}"))}
        check(sorted(shard_files) == list(range(14)), f"shards on disk: {sorted(shard_files)}")
        for sid, path in shard_files.items():
            check(sha256(path) == want[sid], f"shard {sid} differs from the CPU plain encoding")
        tasks = len(ec_encoder._plan_tasks(DEFAULT_SCHEME, dat_size, ec_encoder.DEFAULT_CHUNK))
        k1 = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply"))
              for s_ in servers}
        check(k1[source_url] == tasks and sum(k1.values()) == tasks,
              f"K1 launches by server {k1}; the source's generate has {tasks} batches")
        print(f"failover: ec.encode of volume {vid} ({dat_size} bytes) through the master list on "
              f"{ident}: shell {walls['encode_shell']:.3f}s; source {source_url} K1 launches "
              f"{k1[source_url]} (= {tasks} batches); 14 shards sha256-identical to the CPU plain "
              f"version's ({walls['cpu_reference_encode']:.3f}s on the host)")
    finally:
        pool.close()
        rcs = {getattr(s_, "url", s_.proc.pid): s_.stop() for s_ in servers}
        rcs.update({f"m{i}": m.stop() for i, m in enumerate(masters)})
    check(all(rc == 0 for rc in rcs.values()), f"failover processes exited {rcs}")
    walls["phase"] = time.perf_counter() - t_phase
    rec.update(walls=walls, benchmark=bench, fill=fill, launches=k1[source_url], batches=tasks,
               reads=reads, needles=len(owner), volumes=len(where), rcs={str(k): v for k, v in rcs.items()})
    print("failover: " + json.dumps(rec, sort_keys=True))
    return rec


# -- phase 11 -----------------------------------------------------------------

MAINT_N, MAINT_SIZE = 1024, 64 * 1024  # one volume at 001: 64 MiB of payload a holder (2,048 before phase 17)
MAINT_DELETES = 410  # 40% of the needles: a garbage ratio above upstream's 0.3
MAINT_WRITERS = 16  # `weed benchmark`'s -c
AUTO_N = 512  # the second volume, compacted by -vacuumInterval with no shell command (1,024 before phase 17)
MAINT_CORRUPT = 8
MAINT_DIVERGE = 5
MAINT_SAMPLE = 128  # needles read back after each move (256 before phase 17)
MAINT_EC_READS = 250  # cut from 1,000 for the time limit (500 before phase 17)
STALL_SIZE = 1024  # the writer during the vacuum: small, so it barely dilutes the garbage


def _maint_payload(fid: str, small: set = frozenset()) -> bytes:
    """Each phase-11 write's payload, derived from its fid (STALL_SIZE
    bytes for the fids in ``small``)."""
    return hashlib.shake_256(b"maint" + fid.encode()).digest(
        STALL_SIZE if fid in small else MAINT_SIZE)


def _record_bytes(base: str) -> int:
    """The bytes of the live records of ``base``.dat, per its .idx."""
    from seaweedfs_tpu_torch.storage.types import Version, get_actual_size

    return sum(get_actual_size(int(s), Version.V3) for s in _live_entries(base)["size"].tolist())


def _revision(base: str) -> int:
    """The compaction revision in ``base``.dat's superblock."""
    with open(base + ".dat", "rb") as f:
        return int.from_bytes(f.read(8)[4:6], "big")


def _flip(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x5A]))


def _write_many(maddr: str, pool, payload, collection: str, replication: str, n: int,
                disk: str = "") -> dict:
    """n acknowledged writes through MasterClient and ``pool``,
    MAINT_WRITERS at a time, each POSTing ``payload(fid)``: {fid: primary
    url}; any failure fails the phase."""
    from seaweedfs_tpu_torch.wdclient import MasterClient

    mc = MasterClient(maddr)
    tickets = iter(range(n))
    lock = threading.Lock()
    acked: dict = {}
    failures: list = []

    def writer() -> None:
        while True:
            with lock:
                if next(tickets, None) is None or failures:
                    return
            try:
                a = mc.assign(collection=collection, replication=replication, disk_type=disk)
                status, body = pool.request(a.location.url, "POST", f"/{a.fid}",
                                            body=payload(a.fid))
            except Exception as e:  # noqa: BLE001 — reported, fails the phase
                failures.append(f"{type(e).__name__}: {e}")
                return
            if status != 201:
                failures.append(f"POST {a.fid}: {status} {body[:200]!r}")
                return
            with lock:
                acked[a.fid] = a.location.url

    threads = [threading.Thread(target=writer, daemon=True) for _ in range(MAINT_WRITERS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    check(not failures and len(acked) == n and not any(th.is_alive() for th in threads),
          f"{collection}: {len(acked)} of {n} writes acknowledged; {failures[:3]}")
    return acked


def _read_all(pool, url_of, fids, payload, want404: bool = False):
    """GET every fid from each url ``url_of(fid)`` names, MAINT_WRITERS at a
    time: ``payload(fid)``, or 404 with ``want404``; returns the latencies
    in ms."""
    import numpy as np

    def one(fid: str) -> list:
        out = []
        for url in url_of(fid):
            t0 = time.perf_counter()
            status, body = pool.request(url, "GET", f"/{fid}")
            out.append(time.perf_counter() - t0)
            if want404:
                check(status == 404, f"deleted {fid} on {url}: {status}")
            else:
                check(status == 200 and body == payload(fid),
                      f"{fid} on {url}: {status}, {len(body)} bytes")
        return out

    with ThreadPoolExecutor(MAINT_WRITERS) as ex:
        return np.array([x for xs in ex.map(one, fids) for x in xs]) * 1e3


def phase_maintenance(args, directory: str, ident: str, dev) -> dict:
    """Phase 11: volume maintenance.  One ``cli master`` and four ``cli
    volume -device cuda -max 8 -scrubInterval 0 -scrubRateMB 0``
    subprocesses (racks alternating); one volume of 1,024 x 64 KiB at 001,
    40% deleted and ``volume.vacuum``-ed under a writer; a second volume
    compacted by a restart with ``-vacuumInterval 2``; ``volume.delete`` +
    ``volume.fix.replication``; 8 corrupt records repaired by
    ``volume.scrub``; ``volume.check.disk``; ``volume.move``,
    ``volume.balance`` and ``volume.server.evacuate``; ``ec.encode`` through
    K1; a corrupt shard interval repaired by ``volume.scrub``; 250 EC
    reads over HTTP (module docstring)."""
    import numpy as np

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.ops.select import small_read_codec_for
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.util.http_pool import HttpConnectionPool
    from seaweedfs_tpu_torch.wdclient import MasterClient

    root = os.path.join(directory, "maint")
    dirs = [os.path.join(root, f"v{i}") for i in range(CLUSTER_SERVERS)]
    for d in dirs:
        os.makedirs(d)
    log = os.path.join(root, "shell.log")
    walls: dict = {}
    rec: dict = {}
    servers: list = []
    t_phase = time.perf_counter()
    pool = HttpConnectionPool(timeout=60.0, max_per_host=64)
    rng = np.random.default_rng(args.seed + 11)
    master = _Server("", "", os.path.join(root, "master.log"), argv=["master", "-port", "0"])
    try:
        maddr = f"127.0.0.1:{master.grpc_port}"
        mhttp = f"127.0.0.1:{master.http_port}"
        mstub = rpc.master_stub(maddr)

        def volume_argv(i: int, extra: tuple = (), ports: tuple = (0, 0)) -> list:
            # no background scrub pass races the phase's own counts
            return ["volume", "-dir", dirs[i], "-ip", "127.0.0.1", "-port", str(ports[0]),
                    "-grpcPort", str(ports[1]), "-metricsPort", "0", "-device", dev.type,
                    "-mserver", maddr, "-rack", f"rack{i % 2}", "-max", "8",
                    "-scrubInterval", "0", "-scrubRateMB", "0", *extra]

        t = time.perf_counter()
        servers = [_Server(d, dev.type, os.path.join(root, f"v{i}.log"), argv=volume_argv(i),
                           wait=False) for i, d in enumerate(dirs)]
        for s_ in servers:
            s_.ready()
            s_.url = f"127.0.0.1:{s_.http_port}"
        walls["servers_up"] = time.perf_counter() - t
        urls = [s_.url for s_ in servers]

        def census() -> dict:
            """{node id: {vid: collection}} of the normal volumes at the master."""
            topo = mstub.VolumeList(m_pb.VolumeListRequest(), timeout=60).topology_info
            return {dn.id: {v.id: v.collection for disk in dn.disk_infos.values()
                            for v in disk.volume_infos}
                    for dc in topo.data_center_infos for r in dc.rack_infos
                    for dn in r.data_node_infos}

        def on_disk() -> dict:
            """{server url: {vid: collection}} of the .dat files on its disk."""
            out = {}
            for url, d in zip(urls, dirs):
                out[url] = {}
                for name in os.listdir(d):
                    m = re.fullmatch(r"(\w+)_(\d+)\.dat", name)
                    if m:
                        out[url][int(m[2])] = m[1]
            return out

        def volume_size(vid_: int) -> int:
            """The .dat size the master's census holds for vid_ (one copy)."""
            topo = mstub.VolumeList(m_pb.VolumeListRequest(), timeout=60).topology_info
            return next((v.size for dc in topo.data_center_infos for r in dc.rack_infos
                         for dn in r.data_node_infos for disk in dn.disk_infos.values()
                         for v in disk.volume_infos if v.id == vid_), -1)

        def settle(what: str) -> float:
            # a placement is checked only once the master's
            # census equals the files on disk
            return _poll(lambda: census() == on_disk(), f"the master's census to equal the "
                         f"volumes on disk ({what})", 60)

        def holders(vid: int) -> list[str]:
            return sorted(u for u, vols in on_disk().items() if vid in vols)

        def base(url: str, collection: str, vid: int) -> str:
            return os.path.join(dirs[urls.index(url)], f"{collection}_{vid}")

        def grpc_of(url: str) -> str:
            return f"127.0.0.1:{servers[urls.index(url)].grpc_port}"

        walls["registered"] = settle("start")
        print(f"maintenance: master {maddr}; {CLUSTER_SERVERS} volume servers {urls} up in "
              f"{walls['servers_up']:.3f}s, registered after {walls['registered']:.3f}s on {ident}")

        def write_many(collection: str, replication: str, n: int) -> dict:
            return _write_many(maddr, pool, _maint_payload, collection, replication, n)

        def read_from(url_of, fids, want404: bool = False) -> float:
            """GET every fid from each url ``url_of(fid)`` names; returns
            the wall."""
            t0 = time.perf_counter()
            _read_all(pool, url_of, fids, lambda f: _maint_payload(f, small), want404)
            return time.perf_counter() - t0

        # 1. fill one volume at 001, then delete 40% of it
        t = time.perf_counter()
        acked = write_many("maint", "001", MAINT_N)
        walls["fill"] = time.perf_counter() - t
        (vid,) = {int(f.split(",")[0]) for f in acked}
        settle("after the fill")
        hs = holders(vid)
        check(len(hs) == 2, f"volume {vid} at 001 is held by {hs}")
        fids = sorted(acked)
        gone = sorted(fids[i] for i in rng.choice(len(fids), MAINT_DELETES, replace=False))
        t = time.perf_counter()
        with ThreadPoolExecutor(MAINT_WRITERS) as ex:
            for fid, (status, body) in zip(gone, ex.map(
                    lambda f: pool.request(acked[f], "DELETE", f"/{f}"), gone)):
                check(status == 202, f"DELETE {fid}: {status} {body[:200]!r}")
        walls["deletes"] = time.perf_counter() - t
        survivors = sorted(set(fids) - set(gone))
        print(f"maintenance: volume {vid} on {hs}: {MAINT_N} x {MAINT_SIZE} B written at 001 in "
              f"{walls['fill']:.3f}s ({MAINT_N / walls['fill']:.1f} writes/s), {len(gone)} "
              f"deleted in {walls['deletes']:.3f}s on {ident}")

        # 2. volume.vacuum through the shell, one writer to the volume meanwhile
        size0 = {u: os.path.getsize(base(u, "maint", vid) + ".dat") for u in hs}
        garbage = {u: size0[u] - 8 - _record_bytes(base(u, "maint", vid)) for u in hs}
        ratio = {u: garbage[u] / (size0[u] - 8) for u in hs}
        check(all(r > 0.3 for r in ratio.values()), f"garbage ratios {ratio} not above 0.3")
        stall, stall_errors, stop, small = [], [], threading.Event(), set()

        def stall_writer() -> None:
            mc = MasterClient(maddr)
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    a = mc.assign(collection="maint", replication="001")
                    small.add(a.fid)
                    status, body = pool.request(a.location.url, "POST", f"/{a.fid}",
                                                body=_maint_payload(a.fid, small))
                except Exception as e:  # noqa: BLE001 — reported, fails the phase
                    stall_errors.append(f"{type(e).__name__}: {e}")
                    return
                if status != 201:
                    stall_errors.append(f"POST {a.fid}: {status} {body[:200]!r}")
                    return
                stall.append((a.fid, time.perf_counter() - t0))

        th = threading.Thread(target=stall_writer, daemon=True)
        th.start()
        time.sleep(0.5)
        walls["vacuum_shell"], out = _shell(
            maddr, f"lock; volume.vacuum -garbageThreshold 0.3 -volumeId {vid}; unlock", log)
        time.sleep(0.5)
        stop.set()
        th.join(timeout=120)
        check(not th.is_alive() and not stall_errors,
              f"the writer during the vacuum: {stall_errors}")
        for u in hs:
            b = base(u, "maint", vid)
            check(f"volume {vid} on {u}: reclaimed {garbage[u]} bytes" in out,
                  f"vacuum on {u} did not reclaim exactly the deleted records' {garbage[u]} bytes")
            check(_revision(b) == 1, f"{u}: compaction revision {_revision(b)} after one vacuum")
        check(f"total reclaimed: {sum(garbage.values())} bytes" in out, "vacuum total")
        check(all(int(f.split(",")[0]) == vid for f, _ in stall), "a stall write left the volume")
        survivors = sorted(set(survivors) | {f for f, _ in stall})
        lat = np.array([s[1] for s in stall]) * 1e3
        rec["vacuum"] = dict(
            reclaimed=garbage, ratio=ratio, wall_s=walls["vacuum_shell"],
            mb_per_s=sum(size0.values()) / walls["vacuum_shell"] / 1e6,
            writer=dict(writes=int(lat.size), p50_ms=float(np.percentile(lat, 50)),
                        p99_ms=float(np.percentile(lat, 99)), max_ms=float(lat.max())))
        walls["survivors_read"] = read_from(lambda f: hs, survivors)
        walls["deleted_read"] = read_from(lambda f: hs, gone, want404=True)
        print(f"maintenance: volume.vacuum -garbageThreshold 0.3 on {ident}: "
              f"{walls['vacuum_shell']:.3f}s for {sum(size0.values())} B on 2 holders "
              f"({rec['vacuum']['mb_per_s']:.1f} MB/s), reclaimed {garbage} B (garbage "
              f"{ratio}), revision 0 -> 1; one writer meanwhile: {lat.size} writes, p50 "
              f"{rec['vacuum']['writer']['p50_ms']:.2f} ms, p99 "
              f"{rec['vacuum']['writer']['p99_ms']:.2f} ms, max "
              f"{rec['vacuum']['writer']['max_ms']:.2f} ms; {len(survivors)} survivors equal "
              f"from both holders ({walls['survivors_read']:.3f}s), {len(gone)} deleted answer "
              f"404 on both")

        # 3. a second volume compacted by auto-vacuum: a restart with
        # -vacuumInterval 2 and no shell command
        acked2 = write_many("auto", "000", AUTO_N)
        (vid2,) = {int(f.split(",")[0]) for f in acked2}
        (h2,) = holders(vid2)
        fids2 = sorted(acked2)
        for fid in fids2[::2]:
            status, body = pool.request(h2, "DELETE", f"/{fid}")
            check(status == 202, f"DELETE {fid}: {status}")
        b2 = base(h2, "auto", vid2)
        size2 = os.path.getsize(b2 + ".dat")
        garbage2 = size2 - 8 - _record_bytes(b2)
        i2 = urls.index(h2)
        check(servers[i2].stop() == 0, f"{h2} did not stop cleanly")
        t = time.perf_counter()
        servers[i2] = _Server(dirs[i2], dev.type, os.path.join(root, f"v{i2}.restart.log"),
                              argv=volume_argv(i2, ("-vacuumInterval", "2"),
                                               (int(h2.rsplit(":", 1)[1]), servers[i2].grpc_port)))
        servers[i2].url = h2
        pool.close()  # its kept-alive connections went with the stopped process
        pool = HttpConnectionPool(timeout=60.0, max_per_host=64)
        # the master hears the compacted size from the pass's heartbeat
        # delta, sent once the swap is done (the files alone can show the
        # renames while the server is still reopening them)
        _poll(lambda: volume_size(vid2) == size2 - garbage2,
              f"auto-vacuum of volume {vid2} on {h2} at the master", 60)
        walls["auto_vacuum"] = time.perf_counter() - t
        check(_revision(b2) == 1, f"volume {vid2}: compaction revision {_revision(b2)}")
        read_from(lambda f: [h2], fids2[1::2])
        read_from(lambda f: [h2], fids2[::2], want404=True)
        settle("after the restart")
        print(f"maintenance: {h2} restarted with -vacuumInterval 2: volume {vid2} compacted "
              f"({garbage2} B reclaimed, revision 1) {walls['auto_vacuum']:.3f}s after the "
              f"restart, with no shell command, on {ident}; {len(fids2[1::2])} survivors equal")

        # 4. volume.delete on one holder, volume.fix.replication restores it
        # through VolumeCopy: the two copies are then byte-identical
        keep, drop = hs
        _shell(maddr, f"lock; volume.delete -volumeId {vid} -node {grpc_of(drop)}; unlock", log)
        settle("after volume.delete")
        check(holders(vid) == [keep], f"volume {vid} after volume.delete: {holders(vid)}")
        walls["fix_replication"], out = _shell(
            maddr, "lock; volume.fix.replication -collection maint; unlock", log)
        check(f"replicate volume {vid}: {keep} -> " in out and "fixed 1 under-" in out,
              f"volume.fix.replication: {out!r}")
        settle("after volume.fix.replication")
        hs = holders(vid)
        check(len(hs) == 2 and keep in hs, f"volume {vid} after fix.replication: {hs}")
        (copy,) = [u for u in hs if u != keep]
        for ext in (".dat", ".idx"):
            check(sha256(base(copy, "maint", vid) + ext) == sha256(base(keep, "maint", vid) + ext),
                  f"the restored replica's {ext} differs")
        print(f"maintenance: volume.delete on {drop}, volume.fix.replication copied {keep} -> "
              f"{copy} in {walls['fix_replication']:.3f}s on {ident}: .dat and .idx "
              f"sha256-identical")

        # 5. eight corrupt records on one holder, repaired by volume.scrub
        live = dict(zip(*(_live_entries(base(copy, "maint", vid))[k].tolist()
                          for k in ("id", "off"))))
        bad = [survivors[i] for i in rng.choice(len(survivors), MAINT_CORRUPT, replace=False)]
        want_sha = sha256(base(keep, "maint", vid) + ".dat")
        for fid in bad:
            key = int(fid.split(",")[1][:-8], 16)
            _flip(base(copy, "maint", vid) + ".dat", live[key] * 8 + 1000)  # a data byte
        check(sha256(base(copy, "maint", vid) + ".dat") != want_sha, "the flips changed nothing")
        walls["scrub"], out = _shell(maddr, f"lock; volume.scrub -volumeId {vid}; unlock", log)
        n_live = len(survivors)
        check(f"{grpc_of(copy)}: volume {vid}: {n_live} scanned, {MAINT_CORRUPT} corrupt, "
              f"{MAINT_CORRUPT} repaired" in out,
              f"volume.scrub on {copy}: {out!r}")
        check(f"{2 * n_live} needles verified, {MAINT_CORRUPT} corrupt, {MAINT_CORRUPT} "
              f"repaired, 0 failed" in out, f"volume.scrub totals: {out!r}")
        check(sha256(base(copy, "maint", vid) + ".dat") == want_sha,
              f"{copy}'s .dat after the scrub differs from {keep}'s")
        read_from(lambda f: [copy], bad)
        print(f"maintenance: {MAINT_CORRUPT} records flipped on {copy}; volume.scrub "
              f"{walls['scrub']:.3f}s on {ident}: {MAINT_CORRUPT} corrupt, {MAINT_CORRUPT} "
              f"repaired from {keep}, .dat sha256 equal to {keep}'s")

        # 6. five needles deleted on one holder only; volume.check.disk
        diverged = [survivors[i] for i in rng.choice(len(survivors), MAINT_DIVERGE, replace=False)]
        for fid in diverged:
            status, _ = pool.request(keep, "DELETE", f"/{fid}?type=replicate")
            check(status == 202, f"DELETE {fid} on {keep} only: {status}")
        walls["check_disk"], out = _shell(maddr, f"lock; volume.check.disk -volumeId {vid}; unlock",
                                          log)
        check(f"volume {vid}: +{MAINT_DIVERGE} needles copied, -0 deletions synced" in out,
              f"volume.check.disk: {out!r}")
        ids = [set(_live_entries(base(u, "maint", vid))["id"].tolist()) for u in hs]
        check(ids[0] == ids[1] and len(ids[0]) == n_live, "the holders still disagree")
        read_from(lambda f: hs, diverged)
        print(f"maintenance: {MAINT_DIVERGE} needles deleted on {keep} only; volume.check.disk "
              f"copied them back in {walls['check_disk']:.3f}s on {ident}; both holders hold "
              f"the same {n_live} needles")

        # 7. volume.move, volume.server.evacuate, then volume.balance refills
        # the evacuated server (two empty volumes at 001 from volume.grow make
        # the spread worth a move)
        sample = [survivors[i] for i in rng.choice(len(survivors), MAINT_SAMPLE, replace=False)]
        target = next(u for u in urls if u not in hs)
        walls["move"], _ = _shell(maddr, f"lock; volume.move -volumeId {vid} -source {keep} "
                                         f"-target {target}; unlock", log)
        settle("after volume.move")
        check(holders(vid) == sorted([copy, target]), f"after volume.move: {holders(vid)}")
        read_from(lambda f: holders(vid), sample)
        _shell(maddr, "lock; volume.grow -collection spare -replication 001 -count 2; unlock", log)
        settle("after volume.grow")
        victim = max(urls, key=lambda u: (len(on_disk()[u]), u))
        walls["evacuate"], _ = _shell(maddr, f"lock; volume.server.evacuate -node {victim}; "
                                             "unlock", log)
        settle("after volume.server.evacuate")
        check(not on_disk()[victim], f"{victim} still holds {on_disk()[victim]}")
        check(len(holders(vid)) == 2 and len(holders(vid2)) == 1,
              f"after the evacuation: {holders(vid)}, {holders(vid2)}")
        read_from(lambda f: holders(vid), sample)
        read_from(lambda f: holders(vid2), fids2[1::2])
        _, plan = _shell(maddr, "lock; volume.balance -noApply; unlock", log)
        planned = re.findall(r"plan: move volume (\d+) (\S+) -> (\S+)", plan)
        walls["balance"], out = _shell(maddr, "lock; volume.balance; unlock", log)
        check(f"volume.balance moved {len(planned)} volumes" in out and planned,
              f"volume.balance against its plan {planned}: {out!r}")
        settle("after volume.balance")
        for v, src, dst in planned:
            check(int(v) in on_disk()[dst] and int(v) not in on_disk()[src],
                  f"volume {v} did not move {src} -> {dst}")
        check(on_disk()[victim], f"volume.balance left the evacuated {victim} empty")
        read_from(lambda f: holders(vid), sample)
        read_from(lambda f: holders(vid2), fids2[1::2])
        print(f"maintenance: volume.move {keep} -> {target} {walls['move']:.3f}s, "
              f"volume.server.evacuate {victim} {walls['evacuate']:.3f}s, volume.balance "
              f"{walls['balance']:.3f}s ({len(planned)} moves, as planned) on {ident}; every "
              f"placement checked against the disks; {MAINT_SAMPLE} sampled needles equal from "
              f"both holders after each")

        # 8. ec.encode of the compacted volume: K1 on the source's card, the
        # shards equal to the CPU plain version's encoding of its .dat
        hs = holders(vid)
        refs = {}
        for i, u in enumerate(hs):
            refs[u] = os.path.join(root, f"ref{i}", f"maint_{vid}")
            os.makedirs(os.path.dirname(refs[u]))
            for ext in (".dat", ".idx"):
                os.link(base(u, "maint", vid) + ext, refs[u] + ext)
        k1_before = {s_.url: metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply")
                     for s_ in servers}
        check(not any(k1_before.values()), f"K1 launched before the encode: {k1_before}")
        walls["ec_encode"], _ = _shell(maddr, f"lock; ec.encode -volumeId {vid} -collection maint; "
                                              "unlock", log)
        by_grpc = {grpc_of(u): d for u, d in zip(urls, dirs)}
        _poll(lambda: _ec_census(mstub, vid)["holders"] == _disk_shards(by_grpc, f"maint_{vid}"),
              f"the master's EC census of volume {vid} to match the disks", 60)
        check(not holders(vid), f"volume {vid}'s .dat survived the encode on {holders(vid)}")
        gen = [s_.url for s_ in servers if server_stages(s_.log_text(), "generate")]
        check(len(gen) == 1 and gen[0] in hs, f"the generate ran on {gen}, not one of {hs}")
        source = gen[0]
        dat_size = os.path.getsize(refs[source] + ".dat")
        tasks = len(ec_encoder._plan_tasks(DEFAULT_SCHEME, dat_size, ec_encoder.DEFAULT_CHUNK))
        k1 = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply"))
              for s_ in servers}
        check(k1[source] == tasks and sum(k1.values()) == tasks,
              f"K1 launches by server {k1}; the source {source}'s generate has {tasks} batches")
        t = time.perf_counter()
        ec_encoder.write_ec_files(refs[source], device="cpu")
        walls["cpu_reference_encode"] = time.perf_counter() - t
        shard_files = {sid: os.path.join(d, f"maint_{vid}.ec{sid:02d}") for d in dirs
                       for sid in range(14)
                       if os.path.exists(os.path.join(d, f"maint_{vid}.ec{sid:02d}"))}
        check(sorted(shard_files) == list(range(14)), f"shards on disk: {sorted(shard_files)}")
        for sid, path in shard_files.items():
            check(sha256(path) == sha256(refs[source] + f".ec{sid:02d}"),
                  f"shard {sid} differs from the CPU plain encoding")
        print(f"maintenance: ec.encode of the compacted volume {vid} ({dat_size} B) on {ident}: "
              f"shell {walls['ec_encode']:.3f}s; source {source} K1 launches {k1[source]} (= "
              f"{tasks} batches); 14 shards sha256-identical to the CPU plain version's "
              f"({walls['cpu_reference_encode']:.3f}s on the host)")

        # 9. a corrupt interval of one shard file, repaired by volume.scrub
        # through reconstruction on the host codec (K1 does not launch)
        ecx_dir = next(d for d in dirs if os.path.exists(os.path.join(d, f"maint_{vid}.ecx")))
        ev = EcVolume(ecx_dir, vid, "maint", scheme=None)
        try:
            victim_fid = sample[0]
            _off, _size, intervals = ev.locate(int(victim_fid.split(",")[1][:-8], 16))
            sid, shard_off = intervals[0].to_shard_and_offset(ev.scheme)
        finally:
            ev.close()
        shard_path = shard_files[sid]
        holder = next(u for u, d in zip(urls, dirs) if os.path.dirname(shard_path) == d)
        good = sha256(shard_path)
        _flip(shard_path, shard_off + 100)
        check(sha256(shard_path) != good, "the shard flip changed nothing")
        walls["ec_scrub"], out = _shell(maddr, f"lock; volume.scrub -volumeId {vid}; unlock", log)
        check(f"{grpc_of(holder)}: ec volume {vid}: {n_live} scanned, 1 corrupt, 1 repaired"
              in out, f"volume.scrub on the shard holder {holder}: {out!r}")
        for m in re.finditer(r"(\S+): ec volume \d+: \d+ scanned, (\d+) corrupt, (\d+) repaired"
                             r"(?:, (\d+) FAILED)?", out):
            # another holder that read the interval remotely before the
            # holder rewrote it re-reads it at the end of its pass, with
            # fresh locations, and counts nothing
            check(int(m[4] or 0) == 0 and (m[1] == grpc_of(holder) or int(m[2]) == 0),
                  f"volume.scrub line {m[0]!r}")
        check(re.search(r"\d+ needles verified, 1 corrupt, 1 repaired, 0 failed", out) is not None,
              f"volume.scrub totals: {out!r}")
        check(sha256(shard_path) == good, f"shard {sid} on {holder} after the scrub differs")
        k1_after = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches",
                                       kernel="gf_apply")) for s_ in servers}
        check(k1_after == k1, f"the EC scrub launched K1: {k1} -> {k1_after}")

        def lookup(vid_: int) -> list[str]:
            status, body = pool.request(mhttp, "GET", f"/dir/lookup?volumeId={vid_}")
            check(status == 200, f"/dir/lookup?volumeId={vid_}: {status}")
            return [loc["url"] for loc in json.loads(body)["locations"]]

        reads = [survivors[i] for i in rng.choice(len(survivors), MAINT_EC_READS, replace=False)]
        lat: list = []

        def ec_read(fid: str) -> None:
            t0 = time.perf_counter()
            urls_ = lookup(vid)
            status, body = pool.request(urls_[hash(fid) % len(urls_)], "GET", f"/{fid}")
            check(status == 200 and body == _maint_payload(fid, small), f"EC read {fid}: {status}")
            lat.append(time.perf_counter() - t0)

        t = time.perf_counter()
        with ThreadPoolExecutor(MAINT_WRITERS) as ex:
            list(ex.map(ec_read, reads))
        walls["ec_reads"] = time.perf_counter() - t
        lat_ms = np.array(lat) * 1e3
        rec["ec_reads"] = dict(reads=len(reads), per_s=len(reads) / walls["ec_reads"],
                               p50_ms=float(np.percentile(lat_ms, 50)),
                               p99_ms=float(np.percentile(lat_ms, 99)))
        print(f"maintenance: shard {sid} on {holder} corrupt at {shard_off + 100}: volume.scrub "
              f"{walls['ec_scrub']:.3f}s on {ident} rebuilt the interval on the host codec "
              f"{type(small_read_codec_for(DEFAULT_SCHEME)).__name__} (sha256 restored, K1 "
              f"unchanged); "
              f"{len(reads)} EC reads over HTTP on {ident}: {rec['ec_reads']['per_s']:.1f}/s, "
              f"p50 {rec['ec_reads']['p50_ms']:.2f} ms, p99 {rec['ec_reads']['p99_ms']:.2f} ms")
    finally:
        pool.close()
        rcs = {getattr(s_, "url", s_.proc.pid): s_.stop() for s_ in servers}
        rcs["master"] = master.stop()
    check(all(rc == 0 for rc in rcs.values()), f"maintenance processes exited {rcs}")
    walls["phase"] = time.perf_counter() - t_phase
    rec.update(walls=walls, launches=k1[source], batches=tasks, survivors=n_live,
               rcs={str(k): v for k, v in rcs.items()})
    print("maintenance: " + json.dumps(rec, sort_keys=True))
    return rec


# -- phase 12 -------------------------------------------------------------------

TIER_N = 1024  # needles of the tiered volume V: 64 MiB a holder at 001 (2,048 before phase 17)
TIER_SIZE = 64 * 1024
TIER_READS = 512  # reads through TieredFile while V is tiered
FILL_CD = 512  # 64 KiB needles on each of C (5-byte offsets) and D (memory backend)
D_DELETES = 205  # 40% of D's needles: a garbage ratio above upstream's 0.3
HOST_CODEC_ITERS = 20


def _tier_payload(fid: str) -> bytes:
    """Each phase-12 write's payload, derived from its fid."""
    return hashlib.shake_256(b"tier" + fid.encode()).digest(TIER_SIZE)


def phase_host_codec(ident: str) -> dict:
    """The host small-read codec (ops/rs_cpu.ReedSolomonCPU on csrc/gf256.cpp)
    against the plain torch codec on the CPU: a 10 -> 4 encode and a 4-loss
    reconstruct of a 1 MiB interval, byte-equal, each timed as the best of
    HOST_CODEC_ITERS calls (3 of the plain codec's) in µs."""
    import numpy as np

    from seaweedfs_tpu_torch.ops import select
    from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
    from seaweedfs_tpu_torch.storage.erasure_coding.lrc import DEFAULT_LRC_SCHEME
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME

    host = select.small_read_codec_for(DEFAULT_SCHEME)
    lrc_host = select.small_read_codec_for(DEFAULT_LRC_SCHEME)
    plain = ReedSolomonTorch(10, 4, device="cpu")
    data = np.random.default_rng(12).integers(0, 256, (10, MIB), dtype=np.uint8)
    lost = (0, 3, 10, 13)

    def best_us(fn, iters: int = HOST_CODEC_ITERS) -> float:
        fn()
        best = float("inf")
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t)
        return best * 1e6

    parity = host.encode(data)
    check(np.array_equal(parity, plain.encode(data)), "host codec encode != plain torch codec")
    shards = list(data) + list(parity)
    holey = [None if i in lost else s for i, s in enumerate(shards)]
    got = host.reconstruct(list(holey), targets=lost)
    want = plain.reconstruct(list(holey), targets=lost)
    check(all(np.array_equal(got[t], want[t]) and np.array_equal(got[t], shards[t]) for t in lost),
          "host codec 4-loss reconstruct != plain torch codec")
    rec = dict(codec=type(host).__name__, lrc_codec=type(lrc_host).__name__,
               encode_us=best_us(lambda: host.encode(data)),
               plain_encode_us=best_us(lambda: plain.encode(data), 3),
               reconstruct_us=best_us(lambda: host.reconstruct(list(holey), targets=lost)),
               plain_reconstruct_us=best_us(lambda: plain.reconstruct(list(holey), targets=lost),
                                            3))
    print(f"host codec ({ident} host): {rec['codec']} / {rec['lrc_codec']} on csrc/gf256.cpp, "
          f"byte-equal to the plain torch codec; 10 x 1 MiB -> 4 encode {rec['encode_us']:.1f} us "
          f"(plain {rec['plain_encode_us']:.1f} us), 4-loss reconstruct "
          f"{rec['reconstruct_us']:.1f} us (plain {rec['plain_reconstruct_us']:.1f} us)")
    return rec


def phase_storage(args, directory: str, ident: str, dev) -> dict:
    """Phase 12: the storage options and the tier.  One ``cli master`` and
    four ``cli volume -device cuda``: A and B ``-index leveldb -backend
    mmap`` (rack r0, where placement 001 keeps both copies), C ``-disk ssd
    -index compact -offsetWidth 5`` and D ``-disk mem -backend memory
    -index compact`` (rack r1; their disk tags pin the fills of step 8).
    V, 1,024 x 64 KiB at 001 on A and B, is read back from both; A restarts
    and its LSM map replays nothing; ``cli backup`` copies V; V is sealed
    and ``volume.tier.upload``-ed off A (reads go on through TieredFile,
    writes are refused); A restarts onto the .vif alone and serves V;
    ``volume.tier.download`` restores A's .dat byte for byte; C and D take
    512 x 64 KiB each (C's .idx of 17-byte entries, D's 40% deleted and
    vacuumed in memory); and ``ec.encode`` of V launches K1 on its source
    (module docstring)."""
    import numpy as np

    from seaweedfs_tpu_torch import cli, rpc
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
    from seaweedfs_tpu_torch.storage import needle_map
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
    from seaweedfs_tpu_torch.storage.volume_info import maybe_load_volume_info
    from seaweedfs_tpu_torch.util.http_pool import HttpConnectionPool

    root = os.path.join(directory, "storage")
    names = ["A", "B", "C", "D"]
    dirs = [os.path.join(root, n) for n in names]
    obj, bk = os.path.join(root, "objects"), os.path.join(root, "backup")
    for d in dirs:
        os.makedirs(d)
    log = os.path.join(root, "shell.log")
    options = [("-rack", "r0", "-index", "leveldb", "-backend", "mmap"),
               ("-rack", "r0", "-index", "leveldb", "-backend", "mmap"),
               ("-rack", "r1", "-disk", "ssd", "-index", "compact", "-offsetWidth", "5"),
               ("-rack", "r1", "-disk", "mem", "-backend", "memory", "-index", "compact")]
    walls: dict = {}
    rec: dict = {}
    servers: list = []
    t_phase = time.perf_counter()
    pool = HttpConnectionPool(timeout=60.0, max_per_host=64)
    master = _Server("", "", os.path.join(root, "master.log"), argv=["master", "-port", "0"])
    try:
        maddr = f"127.0.0.1:{master.grpc_port}"
        mstub = rpc.master_stub(maddr)

        def volume_argv(i: int, ports: tuple = (0, 0), public: tuple = ()) -> list:
            return ["volume", "-dir", dirs[i], "-ip", "127.0.0.1", "-port", str(ports[0]),
                    "-grpcPort", str(ports[1]), "-metricsPort", "0", "-device", dev.type,
                    "-mserver", maddr, "-scrubInterval", "0", "-scrubRateMB", "0",
                    *options[i], *public]

        t = time.perf_counter()
        servers = [_Server(d, dev.type, os.path.join(root, f"{n}.log"), argv=volume_argv(i),
                           wait=False) for i, (n, d) in enumerate(zip(names, dirs))]
        for s_ in servers:
            s_.ready()
            s_.url = f"127.0.0.1:{s_.http_port}"
        walls["servers_up"] = time.perf_counter() - t
        urls = [s_.url for s_ in servers]

        def nodes() -> dict:
            """{node id: (public url, {vid: VolumeStat})} at the master."""
            topo = mstub.VolumeList(m_pb.VolumeListRequest(), timeout=60).topology_info
            return {dn.id: (dn.public_url, {v.id: v for disk in dn.disk_infos.values()
                                            for v in disk.volume_infos})
                    for dc in topo.data_center_infos for r in dc.rack_infos
                    for dn in r.data_node_infos}

        walls["registered"] = _poll(lambda: set(nodes()) == set(urls), "all four nodes", 60)
        print(f"storage: master {maddr}; A, B (-index leveldb -backend mmap), C (-index compact "
              f"-offsetWidth 5), D (-backend memory -index compact) at {urls}, up in "
              f"{walls['servers_up']:.3f}s, registered after {walls['registered']:.3f}s on {ident}")

        def write_many(collection: str, replication: str, n: int, disk: str = "") -> dict:
            return _write_many(maddr, pool, _tier_payload, collection, replication, n, disk)

        def read_from(hosts, fids, want404: bool = False):
            """GET every fid from each of ``hosts``; returns the latencies
            in ms."""
            return _read_all(pool, lambda f: hosts, fids, _tier_payload, want404)

        def restart(i: int, public: str, stopped=lambda: None) -> float:
            """Stop server i, call ``stopped()``, and start it on its ports
            with ``-publicUrl public``; returns the seconds from the start
            until the master has the new process's first heartbeat (its
            public url)."""
            nonlocal pool
            ports = (servers[i].http_port, servers[i].grpc_port)
            check(servers[i].stop() == 0, f"{names[i]} did not stop cleanly")
            stopped()
            t0 = time.perf_counter()
            servers[i] = _Server(dirs[i], dev.type, os.path.join(root, f"{names[i]}.restart.log"),
                                 argv=volume_argv(i, ports, ("-publicUrl", public)))
            servers[i].url = urls[i]
            pool.close()  # its kept-alive connections went with the stopped process
            pool = HttpConnectionPool(timeout=60.0, max_per_host=64)
            # a start slower than the master's 15 s prune drops the node
            # until its first heartbeat: absent counts as not yet back
            _poll(lambda: nodes().get(urls[i], ("",))[0] == public,
                  f"the first heartbeat of the restarted {names[i]}", 60)
            return time.perf_counter() - t0

        # 1. fill V at 001 on A and B; every needle equal from both
        t = time.perf_counter()
        acked = write_many("tier", "001", TIER_N)
        walls["fill"] = time.perf_counter() - t
        (vid,) = {int(f.split(",")[0]) for f in acked}
        fids = sorted(acked)
        a_url, b_url = urls[0], urls[1]
        _poll(lambda: all(vid in nodes()[u][1] for u in (a_url, b_url)), f"V={vid} on A and B", 60)
        check(sorted(u for u, (_p, vols) in nodes().items() if vid in vols) == sorted([a_url, b_url]),
              f"volume {vid} at 001 is not held by A and B")
        t = time.perf_counter()
        lat = read_from([a_url, b_url], fids)
        walls["read_both"] = time.perf_counter() - t
        base_a = os.path.join(dirs[0], f"tier_{vid}")
        print(f"storage: V={vid}: {TIER_N} x {TIER_SIZE} B written at 001 in {walls['fill']:.3f}s "
              f"({TIER_N / walls['fill']:.1f} writes/s) on {ident}; every needle equal from A and B "
              f"in {walls['read_both']:.3f}s (p50 {np.percentile(lat, 50):.2f} ms, p99 "
              f"{np.percentile(lat, 99):.2f} ms)")

        # 2. restart A: its LSM map was marked at the .idx's length on the
        # clean close, so the reopen replays no .idx entry
        lsm: dict = {}

        def read_mark() -> None:
            ldb = needle_map.LevelDbNeedleMap(base_a + ".idx.ldb")
            lsm.update(marked=ldb.indexed_idx_bytes, idx=os.path.getsize(base_a + ".idx"),
                       needles=len(ldb))
            ldb.close()

        http_a = servers[0].http_port
        walls["restart_to_heartbeat"] = restart(0, f"localhost:{http_a}", read_mark)
        check(lsm["marked"] == lsm["idx"] and lsm["needles"] == TIER_N,
              f"A's LSM map at the restart: {lsm}")
        walls["restart_ready"] = servers[0].start_s
        read_from([a_url], fids)
        print(f"storage: A restarted: LSM map marked {lsm['marked']} B = the .idx (nothing to "
              f"replay), ready in {walls['restart_ready']:.3f}s, first heartbeat "
              f"{walls['restart_to_heartbeat']:.3f}s after the start (its -publicUrl at the "
              f"master) on {ident}; every needle equal from A")

        # 3. cli backup of V: the holder it names, byte for byte
        sha_a = {ext: sha256(base_a + ext) for ext in (".dat", ".idx")}
        t = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["backup", "-master", maddr, "-volumeId", str(vid), "-collection",
                           "tier", "-dir", bk])
        walls["backup"] = time.perf_counter() - t
        m = re.search(r"backed up volume \d+ from (\S+) to ", buf.getvalue())
        check(rc == 0 and m is not None and m[1] in (a_url, b_url),
              f"backup exited {rc}: {buf.getvalue()!r}")
        src = os.path.join(dirs[urls.index(m[1])], f"tier_{vid}")
        for ext in (".dat", ".idx"):
            check(sha256(os.path.join(bk, f"tier_{vid}{ext}")) == sha256(src + ext),
                  f"backup {ext} differs from {m[1]}'s")
        print(f"storage: cli backup of V from {m[1]} in {walls['backup']:.3f}s "
              f"({os.path.getsize(src + '.dat') / walls['backup'] / 1e6:.1f} MB/s) on {ident}: "
              f".dat and .idx sha256-identical to its holder's")

        # 4. seal V and tier A's copy to the object store
        _shell(maddr, f"lock; volume.mark -volumeId {vid}; unlock", log)
        t = time.perf_counter()
        walls["tier_upload"], out = _shell(
            maddr, f"lock; volume.tier.upload -node {a_url} -volumeId {vid} -collection tier "
                   f"-dest {obj}; unlock", log)
        check(f"volume {vid} tiered to {obj} as vol/tier/{vid}.dat" in out,
              f"volume.tier.upload printed {out!r}")
        check(not os.path.exists(base_a + ".dat"), "A's .dat survived the upload")
        remote = maybe_load_volume_info(base_a + ".vif").remote
        check(remote.get("key") == f"vol/tier/{vid}.dat" and remote.get("root") == obj,
              f"A's .vif remote {remote}")
        rng = np.random.default_rng(args.seed + 12)
        sample = [fids[i] for i in rng.choice(len(fids), TIER_READS, replace=False)]
        t = time.perf_counter()
        lat = read_from([a_url], sample)
        walls["tiered_reads"] = time.perf_counter() - t
        rec["tiered_reads"] = dict(reads=len(sample), per_s=len(sample) / walls["tiered_reads"],
                                   p50_ms=float(np.percentile(lat, 50)),
                                   p99_ms=float(np.percentile(lat, 99)))
        key = int(fids[0].split(",")[1][:-8], 16) + 10 * TIER_N
        status, body = pool.request(a_url, "POST", f"/{vid},{key:x}{1:08x}", body=b"late")
        check(status == 500 and b"read-only" in body,
              f"a write to the tiered V answered {status} {body[:200]!r}")
        print(f"storage: volume.tier.upload of V off A {walls['tier_upload']:.3f}s on {ident}: "
              f"A's .dat gone, its .vif names {remote['key']}; {len(sample)} reads through "
              f"TieredFile {rec['tiered_reads']['per_s']:.1f}/s, p50 "
              f"{rec['tiered_reads']['p50_ms']:.2f} ms, p99 {rec['tiered_reads']['p99_ms']:.2f} "
              f"ms, all equal; a write refused ({status})")

        # 5. restart A onto the .vif alone: V loads tiered and is served
        walls["restart_tiered"] = restart(0, f"127.0.0.1:{http_a}")
        time.sleep(0.5)  # one heartbeat's handling: the full beat also carries the volumes
        stat = nodes()[a_url][1].get(vid)
        check(stat is not None and stat.read_only and stat.size > 0,
              f"the master's census of V on the restarted A: {stat}")
        read_from([a_url], sample[:256])
        print(f"storage: A restarted on the .vif alone: V loaded tiered, at the master again "
              f"(read-only, {stat.size} B) {walls['restart_tiered']:.3f}s after the start on "
              f"{ident}; 256 reads equal")

        # 6. volume.tier.download: A's .dat comes back byte for byte
        walls["tier_download"], out = _shell(
            maddr, f"lock; volume.tier.download -node {a_url} -volumeId {vid} -collection tier "
                   f"-dest {obj}; unlock", log)
        check(f"volume {vid} downloaded from {obj}" in out, f"volume.tier.download printed {out!r}")
        check(sha256(base_a + ".dat") == sha_a[".dat"], "A's downloaded .dat differs from A's")
        # the backup is its holder's copy; B's records carry B's own append
        # times, so only a backup from A can equal A's .dat
        same_as_backup = ""
        if m[1] == a_url:
            check(sha256(base_a + ".dat") == sha256(os.path.join(bk, f"tier_{vid}.dat")),
                  "A's downloaded .dat differs from the backup's")
            same_as_backup = " and to the backup's"
        check(os.listdir(obj) == [], f"objects left after the download: {os.listdir(obj)}")
        read_from([a_url], sample[:256])
        print(f"storage: volume.tier.download {walls['tier_download']:.3f}s on {ident}: A's .dat "
              f"sha256-identical to A's before the upload{same_as_backup}")

        # 7. C and D: FILL_CD x 64 KiB each at 000 (disk tags pin them)
        t = time.perf_counter()
        acked_c = write_many("w5", "000", FILL_CD, disk="ssd")
        acked_d = write_many("mem", "000", FILL_CD, disk="mem")
        walls["fill_cd"] = time.perf_counter() - t
        (vid_c,), (vid_d,) = ({int(f.split(",")[0]) for f in acked_c},
                              {int(f.split(",")[0]) for f in acked_d})
        check(set(acked_c.values()) == {urls[2]} and set(acked_d.values()) == {urls[3]},
              "the ssd and mem fills did not land on C and D")
        base_c = os.path.join(dirs[2], f"w5_{vid_c}")
        with open(base_c + ".dat", "rb") as f:
            sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
        entries: list = []
        with open(base_c + ".idx", "rb") as f:
            needle_map.walk_index_file(f, lambda k, o, z: entries.append((k, o)), offset_width=5)
        check(sb.offset_width == 5 and os.path.getsize(base_c + ".idx") == FILL_CD * 17
              and len(entries) == FILL_CD, f"C's .idx: {os.path.getsize(base_c + '.idx')} B, "
              f"offset width {sb.offset_width}")
        with open(base_c + ".dat", "rb") as f:
            check(all(int.from_bytes(os.pread(f.fileno(), 8, o + 4), "big") == k
                      for k, o in entries), "a 5-byte .idx offset misses its record")
        read_from([urls[2]], sorted(acked_c))
        base_d = os.path.join(dirs[3], f"mem_{vid_d}")
        check(not os.path.exists(base_d + ".dat"), "D's memory volume has a .dat on disk")
        fids_d = sorted(acked_d)
        gone = sorted(fids_d[i] for i in rng.choice(FILL_CD, D_DELETES, replace=False))
        for fid in gone:
            status, body = pool.request(urls[3], "DELETE", f"/{fid}")
            check(status == 202, f"DELETE {fid} on D: {status} {body[:200]!r}")
        d_stub = rpc.volume_stub(f"127.0.0.1:{servers[3].grpc_port}")
        size_d = d_stub.VolumeStatus(vs_pb.VolumeStatusRequest(volume_id=vid_d)).volume_size
        garbage = size_d - SUPER_BLOCK_SIZE - _record_bytes(base_d)
        walls["vacuum_memory"], out = _shell(
            maddr, f"lock; volume.vacuum -garbageThreshold 0.3 -volumeId {vid_d}; unlock", log)
        check(f"volume {vid_d} on {urls[3]}: reclaimed {garbage} bytes" in out,
              f"the memory vacuum did not reclaim exactly the deleted records' {garbage} bytes: "
              f"{out!r}")
        after = d_stub.VolumeStatus(vs_pb.VolumeStatusRequest(volume_id=vid_d)).volume_size
        check(after == size_d - garbage and not os.path.exists(base_d + ".dat"),
              f"D's volume after the vacuum: {after} B")
        survivors = sorted(set(fids_d) - set(gone))
        read_from([urls[3]], survivors)
        read_from([urls[3]], gone, want404=True)
        print(f"storage: C (-offsetWidth 5) and D (-backend memory) took {FILL_CD} x {TIER_SIZE} B "
              f"each in {walls['fill_cd']:.3f}s on {ident}; C's .idx {FILL_CD} x 17 B entries; D: "
              f"{D_DELETES} deleted, volume.vacuum {walls['vacuum_memory']:.3f}s reclaimed "
              f"{garbage} B in memory (= the deleted records'), {len(survivors)} survivors equal, "
              f"the deleted answer 404")

        # 8. ec.encode of the downloaded V: K1 on its source's card, the
        # shards equal to the CPU plain version's encoding of its .dat
        holders = [a_url, b_url]
        refs = {}
        for i, u in enumerate(holders):
            refs[u] = os.path.join(root, f"ref{i}", f"tier_{vid}")
            os.makedirs(os.path.dirname(refs[u]))
            for ext in (".dat", ".idx"):
                os.link(os.path.join(dirs[urls.index(u)], f"tier_{vid}{ext}"), refs[u] + ext)
        k1_before = {s_.url: metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply")
                     for s_ in servers}
        check(not any(k1_before.values()), f"K1 launched before the encode: {k1_before}")
        walls["ec_encode"], _ = _shell(maddr, f"lock; ec.encode -volumeId {vid} -collection tier; "
                                              "unlock", log)
        by_grpc = {f"127.0.0.1:{s_.grpc_port}": d for s_, d in zip(servers, dirs)}
        _poll(lambda: _ec_census(mstub, vid)["holders"] == _disk_shards(by_grpc, f"tier_{vid}"),
              f"the master's EC census of V={vid} to match the disks", 60)
        gen = [s_.url for s_ in servers if server_stages(s_.log_text(), "generate")]
        check(len(gen) == 1 and gen[0] in holders, f"the generate ran on {gen}, not A or B")
        source = gen[0]
        dat_size = os.path.getsize(refs[source] + ".dat")
        tasks = len(ec_encoder._plan_tasks(DEFAULT_SCHEME, dat_size, ec_encoder.DEFAULT_CHUNK))
        k1 = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply"))
              for s_ in servers}
        check(k1[source] == tasks and sum(k1.values()) == tasks,
              f"K1 launches by server {k1}; the source {source}'s generate has {tasks} batches")
        t = time.perf_counter()
        ec_encoder.write_ec_files(refs[source], device="cpu")
        walls["cpu_reference_encode"] = time.perf_counter() - t
        shard_files = {sid: os.path.join(d, f"tier_{vid}.ec{sid:02d}") for d in dirs
                       for sid in range(14)
                       if os.path.exists(os.path.join(d, f"tier_{vid}.ec{sid:02d}"))}
        check(sorted(shard_files) == list(range(14)), f"shards on disk: {sorted(shard_files)}")
        for sid, path in shard_files.items():
            check(sha256(path) == sha256(refs[source] + f".ec{sid:02d}"),
                  f"shard {sid} differs from the CPU plain encoding")
        print(f"storage: ec.encode of the downloaded V={vid} ({dat_size} B) on {ident}: shell "
              f"{walls['ec_encode']:.3f}s; source {source} K1 launches {k1[source]} (= {tasks} "
              f"batches); 14 shards sha256-identical to the CPU plain version's "
              f"({walls['cpu_reference_encode']:.3f}s on the host)")
    finally:
        pool.close()
        rcs = {getattr(s_, "url", s_.proc.pid): s_.stop() for s_ in servers}
        rcs["master"] = master.stop()
    check(all(rc == 0 for rc in rcs.values()), f"storage processes exited {rcs}")
    walls["phase"] = time.perf_counter() - t_phase
    rec.update(walls=walls, launches=k1[source], batches=tasks, vid=vid, reclaimed_memory=garbage,
               rcs={str(k): v for k, v in rcs.items()})
    print("storage: " + json.dumps(rec, sort_keys=True))
    return rec


# -- phase 13 -------------------------------------------------------------------


FILER_DIRS = 64
FILER_SMALL_N = 256  # 1-64 KiB files over FILER_DIRS directories (cut from 8,192; 1,024 before phase 16, 512 before 17)
FILER_INLINE_N = 32  # of them at most 2 KiB: inlined in their entries (64 before phase 17)
FILER_LARGE_N = 4  # 4-32 MiB files (cut from 16 for phase 15, 8 for phase 17)
FILER_BIG_BYTES = 128 * MIB  # one file of 32 chunks at -maxMB 4 (cut from 1 GiB, 256 MiB before phase 19)
FILER_CHUNK_MB = 4  # -maxMB: the default of upstream's `weed filer` and of the JAX CLI
FILER_VOLUME_MB = 256  # -volumeSizeLimitMB: upstream's 30 GB cut 120x
FILER_WRITERS = 16
FILER_RANGE_READS = 32
FILER_ORPHANS = 64
FILER_RM_DIR = 5  # /data/d05: one directory of FILER_SMALL_N / FILER_DIRS files
FILER_RESTART_SAMPLE = 64  # halved for phase 16 and again for phase 17
FILER_REBUILD_SAMPLE = 128  # halved for phase 16 and again for phase 17
# the filer's peak RSS while it moves the big file: its windows hold 8 x 4
# MiB up and 4 x 4 MiB down; the rest is the interpreter, the allocator's
# retained arenas and the server threads (121 and 191 MiB measured on an H100
# machine's host with a 1 GiB file, 110-123 MiB with a 256 MiB one).  Below
# the file's size plus the interpreter, so a filer that held the whole body
# would fail (384 MiB with the 1 GiB file, 288 MiB with the 256 MiB one)
FILER_RSS_LIMIT = 200 * MIB
FILER_PROFILE = dict(big=16, small=256, reads=256)  # the in-process split of one request


def _filer_files(seed: int) -> list:
    """[(path, size, key)] of the phase's files: the big file, the large
    ones and the small ones (FILER_INLINE_N of them inline), sizes from
    ``seed``; ``key`` seeds the body."""
    import numpy as np

    rng = np.random.default_rng([seed, 13])
    files = [("/data/big/one.bin", FILER_BIG_BYTES, 0)]
    for i in range(FILER_LARGE_N):
        files.append((f"/data/large/l{i:02d}.bin", int(rng.integers(4 * MIB, 32 * MIB + 1)), 1 + i))
    sizes = np.concatenate([rng.integers(1024, 2049, FILER_INLINE_N),
                            rng.integers(2049, 64 * 1024 + 1, FILER_SMALL_N - FILER_INLINE_N)])
    rng.shuffle(sizes)
    for i, size in enumerate(sizes):
        files.append((f"/data/d{i % FILER_DIRS:02d}/f{i:05d}.bin", int(size), 100 + i))
    return files


def _filer_blocks(seed: int, key: int, size: int, lo: int = 0, hi: int | None = None):
    """The bytes [lo, hi) of file ``key``'s body, made 1 MiB block by block
    from ``seed`` (any range regenerates without the rest)."""
    import numpy as np

    hi = size if hi is None else hi
    for b in range(lo // MIB, (hi + MIB - 1) // MIB):
        start = b * MIB
        block = np.random.default_rng([seed, key, b]).bytes(min(MIB, size - start))
        yield block[max(lo, start) - start:min(hi, start + MIB) - start]


class _RssPeak:
    """The largest VmRSS of process ``pid`` sampled every 20 ms while the
    block runs (the filer's memory while it streams)."""

    def __init__(self, pid: int):
        self.pid, self.peak, self._stop = pid, 0, threading.Event()

    def _rss(self) -> int:
        with open(f"/proc/{self.pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _run(self) -> None:
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._rss())

    def __enter__(self):
        self.peak = self._rss()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


_TLS_CONTEXTS: dict = {}  # address -> the ssl.SSLContext its HTTPS listener is reached with


def _filer_conn(addr: str):
    import http.client

    host, port = addr.rsplit(":", 1)
    ctx = _TLS_CONTEXTS.get(addr)
    if ctx is not None:
        return http.client.HTTPSConnection(host, int(port), timeout=300, context=ctx)
    return http.client.HTTPConnection(host, int(port), timeout=300)


def _filer_put(conn, seed: int, path: str, size: int, key: int) -> tuple:
    """POST one file streamed from its blocks; (sha256, md5, seconds)."""
    sha, md5 = hashlib.sha256(), hashlib.md5()

    def body():
        for piece in _filer_blocks(seed, key, size):
            sha.update(piece)
            md5.update(piece)
            yield piece

    t0 = time.perf_counter()
    conn.request("POST", path, body=body(), headers={"Content-Length": str(size)})
    resp = conn.getresponse()
    reply = resp.read()
    dt = time.perf_counter() - t0
    check(resp.status == 201, f"POST {path}: {resp.status} {reply[:200]!r}")
    doc = json.loads(reply)
    check(doc["size"] == size and doc["eTag"] == md5.hexdigest(),
          f"POST {path}: {doc} for {size} bytes, md5 {md5.hexdigest()}")
    return sha.hexdigest(), dt


def _filer_get(conn, path: str, headers: dict | None = None) -> tuple:
    """GET one file streamed into sha256; (status, sha256, bytes, headers, seconds)."""
    sha = hashlib.sha256()
    t0 = time.perf_counter()
    conn.request("GET", path, headers=headers or {})
    resp = conn.getresponse()
    n = 0
    while True:
        piece = resp.read(MIB)
        if not piece:
            break
        sha.update(piece)
        n += len(piece)
    return resp.status, sha.hexdigest(), n, dict(resp.getheaders()), time.perf_counter() - t0


def _filer_pool(addr: str, items: list, fn, writers: int = FILER_WRITERS) -> list:
    """``fn(conn, item)`` over ``items`` by ``writers`` threads, each on
    its own keep-alive connection; results in item order.  Any failure
    fails the phase."""
    tickets = iter(range(len(items)))
    lock = threading.Lock()
    out: list = [None] * len(items)
    failures: list = []

    def worker() -> None:
        conn = _filer_conn(addr)
        try:
            while True:
                with lock:
                    i = next(tickets, None)
                    if i is None or failures:
                        return
                try:
                    out[i] = fn(conn, items[i])
                except Exception as e:  # noqa: BLE001 — reported, fails the phase
                    failures.append(f"{items[i][0] if isinstance(items[i], tuple) else items[i]}: "
                                    f"{type(e).__name__}: {e}")
                    return
        finally:
            conn.close()

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(writers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=1200)
    check(not failures and not any(th.is_alive() for th in threads) and None not in out,
          f"{sum(r is not None for r in out)} of {len(items)} done; {failures[:3]}")
    return out


def _class_figures(label: str, sizes: list, lat: list, wall: float) -> dict:
    import numpy as np

    lat_ms = np.array(lat) * 1e3
    return dict(files=len(sizes), bytes=int(sum(sizes)), wall_s=wall, files_per_s=len(sizes) / wall,
                mb_per_s=sum(sizes) / wall / 1e6, p50_ms=float(np.percentile(lat_ms, 50)),
                p99_ms=float(np.percentile(lat_ms, 99)))


def _filer_read_all(faddr: str, files: list, want: dict, label: str, tag: str = "filer") -> dict:
    """Every file GET through the filer, sha256-equal to what was
    written; figures per class, printed on a ``tag:`` line."""
    classes = {"big": [f for f in files if f[1] > 64 * 1024 and "/large/" not in f[0]],
               "large": [f for f in files if "/large/" in f[0]],
               "small": [f for f in files if f[1] <= 64 * 1024]}
    rec = {}
    for cls, items in classes.items():
        if not items:
            continue

        def one(conn, f):
            status, sha, n, _h, dt = _filer_get(conn, f[0])
            check(status == 200 and n == f[1] and sha == want[f[0]],
                  f"{label}: GET {f[0]}: {status}, {n} of {f[1]} bytes, sha256 "
                  f"{'equal' if sha == want[f[0]] else 'differs'}")
            return dt

        t = time.perf_counter()
        lat = _filer_pool(faddr, items, one)
        rec[cls] = _class_figures(cls, [f[1] for f in items], lat, time.perf_counter() - t)
    print(f"{tag}: read {label}: " + "; ".join(
        f"{cls} {r['files']} files {r['files_per_s']:.1f}/s {r['mb_per_s']:.1f} MB/s p50 "
        f"{r['p50_ms']:.2f} ms p99 {r['p99_ms']:.2f} ms" for cls, r in rec.items())
        + ", every one sha256-equal")
    return rec


def _filer_profile(maddr: str, seed: int, ident: str) -> dict:
    """What one filer upload and one filer read wait on: an in-process
    FilerServer (the same code as ``cli filer``) on the phase's master and
    volume servers, with its body read, assign (FidPool hit or miss),
    volume POST, store insert, find_entry, location lookup and volume GET
    timed; requests one at a time.  Its files go to the default collection
    and are deleted, chunks included, at the end."""
    import numpy as np

    from seaweedfs_tpu_torch.filer import reader, upload
    from seaweedfs_tpu_torch.server import filer_server

    parts: dict = {}
    tls = threading.local()

    def timed(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    class TimedBody(filer_server.StreamingBody):
        def read(self, n=-1):
            t0 = time.perf_counter()
            try:
                return super().read(n)
            finally:
                parts["body_read"] = parts.get("body_read", 0.0) + time.perf_counter() - t0

    fs = filer_server.FilerServer(maddr, port=0, grpc_port=0,
                                  chunk_size=FILER_CHUNK_MB * MIB)
    saved = (filer_server.StreamingBody, upload.http_put_chunk, reader._fetch_chunk_from)
    filer_server.StreamingBody = TimedBody
    upload.http_put_chunk = timed("volume_post", upload.http_put_chunk)
    reader._fetch_chunk_from = timed("volume_get", reader._fetch_chunk_from)
    batch = fs.master.assign_batch_located

    def assign(*a, **k):
        tls.missed = True
        return batch(*a, **k)

    fs.master.assign_batch_located = assign
    take = fs.fid_pool.take

    def take_timed(*a, **k):
        tls.missed = False
        t0 = time.perf_counter()
        out = take(*a, **k)
        key = "assign_miss" if tls.missed else "assign_hit"
        parts[key] = parts.get(key, 0.0) + time.perf_counter() - t0
        parts[key + "_n"] = parts.get(key + "_n", 0) + 1
        return out

    fs.fid_pool.take = take_timed
    fs.filer.store.insert_entry = timed("insert_entry", fs.filer.store.insert_entry)
    fs.filer.find_entry = timed("find_entry", fs.filer.find_entry)
    fs.master.lookup = timed("lookup", fs.master.lookup)
    fs.start()
    rec = {}
    try:
        conn = _filer_conn(fs.url)
        for label, n, size in (("upload_4MiB", FILER_PROFILE["big"], 4 * MIB),
                               ("upload_16KiB", FILER_PROFILE["small"], 16 * 1024)):
            # bodies made before the clock starts: the client only sends
            bodies = [b"".join(_filer_blocks(seed, 10_000 + i, size)) for i in range(n)]
            parts.clear()
            lat = []
            for i, body in enumerate(bodies):
                t0 = time.perf_counter()
                conn.request("POST", f"/profile/{label}/{i:04d}", body=body)
                resp = conn.getresponse()
                resp.read()
                lat.append(time.perf_counter() - t0)
                check(resp.status == 201, f"profile upload {label} {i}: {resp.status}")
            del bodies
            total = sum(lat)
            split = {k: v / n * 1e3 for k, v in parts.items() if not k.endswith("_n")}
            split.update({k: v for k, v in parts.items() if k.endswith("_n")})
            split["request_ms"] = total / n * 1e3
            split["p50_ms"] = float(np.percentile(np.array(lat) * 1e3, 50))
            split["other_ms"] = split["request_ms"] - sum(
                split.get(k, 0.0) for k in ("body_read", "assign_hit", "assign_miss",
                                            "volume_post", "insert_entry", "find_entry",
                                            "lookup"))
            rec[label] = split
        parts.clear()
        lat = []
        for i in range(FILER_PROFILE["reads"]):
            status, _sha, n, _h, dt = _filer_get(conn, f"/profile/upload_16KiB/{i:04d}")
            check(status == 200 and n == 16 * 1024, f"profile read {i}: {status}, {n} bytes")
            lat.append(dt)
        n = FILER_PROFILE["reads"]
        split = {k: v / n * 1e3 for k, v in parts.items()}
        split["request_ms"] = sum(lat) / n * 1e3
        split["p50_ms"] = float(np.percentile(np.array(lat) * 1e3, 50))
        split["other_ms"] = split["request_ms"] - sum(
            split.get(k, 0.0) for k in ("find_entry", "lookup", "volume_get"))
        rec["read_16KiB"] = split
        conn.close()
        fs.filer.delete_entry("/profile", recursive=True)
    finally:
        filer_server.StreamingBody, upload.http_put_chunk, reader._fetch_chunk_from = saved
        fs.stop()
    for label, split in rec.items():
        print(f"filer: profile {label} on {ident} (host time, ms a request): " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in split.items()))
    return rec


def phase_filer(args, directory: str, ident: str, dev) -> dict:
    """Phase 13: the filer.  One ``cli master -volumeSizeLimitMB 256``,
    four ``cli volume -device cuda -scrubInterval 0 -scrubRateMB 0`` on two
    racks and one ``cli filer -db <dir> -maxMB 4`` (the LSM store).
    ``fs.configure`` puts /data/ in collection filerdata; 16 writers fill
    it through the filer's HTTP API (256 files of 1-64 KiB over 64
    directories, 32 of them inline; 4 of 4-32 MiB; one of 128 MiB, 32
    chunks, streamed) and every file reads back sha256-equal, with Range
    reads, a 416, a HEAD and paged listings; the filer's RSS stays under
    FILER_RSS_LIMIT while it moves the big file.  ``cli shell -filer``:
    fs.du equals the bytes written, fs.verify finds 0 broken, fs.ls and
    fs.tree run; 64 needles from ``cli upload`` are the orphans
    ``volume.fsck`` finds, purges, and then finds 0 of; ``fs.rm -r`` of a
    directory 404s its paths and its chunks; the filer restarts on its
    -db and lists and reads the same; ``ec.encode`` of every filerdata
    volume launches K1 once per batch in the servers and every file reads
    back from the shards; a volume server is SIGKILLed and, once pruned,
    every file reads back through degraded reads; ``ec.rebuild`` launches
    K1 and a sample reads back; and ``cli server -filer -device cuda``
    takes an upload and a read in one process.  Its figures go on
    ``filer:`` lines."""
    import numpy as np

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.filer.entry import Entry
    from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.util.http_pool import HttpConnectionPool
    from seaweedfs_tpu_torch.wdclient import MasterClient

    seed = args.seed
    root = os.path.join(directory, "filer")
    dirs = [os.path.join(root, f"v{i}") for i in range(4)]
    for d in dirs:
        os.makedirs(d)
    db = os.path.join(root, "db")
    log = os.path.join(root, "shell.log")
    walls: dict = {}
    rec: dict = {}
    servers: list = []
    filer = side = None
    t_phase = time.perf_counter()
    pool = HttpConnectionPool(timeout=60.0, max_per_host=64)
    files = _filer_files(seed)
    sizes = {p: s for p, s, _k in files}
    master = _Server("", "", os.path.join(root, "master.log"),
                     argv=["master", "-port", "0", "-volumeSizeLimitMB", str(FILER_VOLUME_MB)])
    try:
        maddr = f"127.0.0.1:{master.grpc_port}"
        mstub = rpc.master_stub(maddr)
        t = time.perf_counter()
        servers = [_Server(d, dev.type, os.path.join(root, f"v{i}.log"), wait=False, argv=[
            "volume", "-dir", d, "-ip", "127.0.0.1", "-port", "0", "-grpcPort", "0",
            "-metricsPort", "0", "-device", dev.type, "-mserver", maddr, "-rack", f"r{i % 2}",
            "-scrubInterval", "0", "-scrubRateMB", "0"]) for i, d in enumerate(dirs)]
        for s_ in servers:
            s_.ready()
            s_.url = f"127.0.0.1:{s_.http_port}"
        urls = [s_.url for s_ in servers]

        def start_filer(logname: str):
            f = _Server("", "", os.path.join(root, logname), argv=[
                "filer", "-master", maddr, "-port", "0", "-db", db, "-maxMB", str(FILER_CHUNK_MB)])
            f.faddr = f"127.0.0.1:{f.http_port}"
            f.gaddr = f"127.0.0.1:{f.grpc_port}"
            return f

        filer = start_filer("filer.log")
        walls["servers_up"] = time.perf_counter() - t

        def nodes() -> set:
            topo = mstub.VolumeList(m_pb.VolumeListRequest(), timeout=60).topology_info
            return {dn.id for dc in topo.data_center_infos for r in dc.rack_infos
                    for dn in r.data_node_infos}

        walls["registered"] = _poll(lambda: nodes() == set(urls), "all four nodes", 60)
        print(f"filer: master {maddr}, four volume servers at {urls} on {ident}, filer "
              f"{filer.faddr} (gRPC {filer.gaddr}, -db {db}), up in {walls['servers_up']:.3f}s")

        def shell(commands: str) -> tuple[float, str]:
            return _shell(maddr, commands, log, filer=filer.gaddr)

        # 1. /data/ -> collection filerdata
        _w, out = shell("fs.configure -locationPrefix /data/ -collection filerdata "
                        "-replication 000 -apply")
        check("applied" in out and '"collection": "filerdata"' in out, f"fs.configure: {out!r}")
        time.sleep(1.1)  # the filer's conf cache lives one second

        # 2. the fill: the big file alone (its RSS sampled), then the
        # large files and the small ones, 16 writers each
        want: dict = {}
        big = files[0]
        with _RssPeak(filer.proc.pid) as rss_up:
            t = time.perf_counter()
            conn = _filer_conn(filer.faddr)
            want[big[0]], dt = _filer_put(conn, seed, *big)
            conn.close()
        fill = {"big": _class_figures("big", [big[1]], [dt], time.perf_counter() - t)}
        for cls, items in (("large", files[1:1 + FILER_LARGE_N]),
                           ("small", files[1 + FILER_LARGE_N:])):
            t = time.perf_counter()
            got = _filer_pool(filer.faddr, items, lambda conn, f: _filer_put(conn, seed, *f))
            fill[cls] = _class_figures(cls, [f[1] for f in items], [g[1] for g in got],
                                       time.perf_counter() - t)
            want.update({f[0]: g[0] for f, g in zip(items, got)})
        rec["fill"] = fill
        total_bytes = sum(sizes.values())
        print(f"filer: fill on {ident}: " + "; ".join(
            f"{cls} {r['files']} files {r['files_per_s']:.1f}/s {r['mb_per_s']:.1f} MB/s p50 "
            f"{r['p50_ms']:.2f} ms p99 {r['p99_ms']:.2f} ms" for cls, r in fill.items())
            + f"; {len(files)} files, {total_bytes} bytes; the filer's peak RSS while it took the "
            f"big file {rss_up.peak / MIB:.1f} MiB")
        fstub = rpc.filer_stub(filer.gaddr)
        big_entry = fstub.LookupDirectoryEntry(f_pb.LookupDirectoryEntryRequest(
            directory="/data/big", name="one.bin")).entry
        check(len(big_entry.chunks) == FILER_BIG_BYTES // (FILER_CHUNK_MB * MIB)
              and big_entry.attributes.collection == "filerdata",
              f"the big file's entry: {len(big_entry.chunks)} chunks, collection "
              f"{big_entry.attributes.collection!r}")
        inline = [f for f in files if f[1] <= 2048]
        sample = fstub.LookupDirectoryEntry(f_pb.LookupDirectoryEntryRequest(
            directory=inline[0][0].rsplit("/", 1)[0], name=inline[0][0].rsplit("/", 1)[1])).entry
        check(len(inline) == FILER_INLINE_N and not sample.chunks and len(sample.content) == inline[0][1],
              f"{inline[0][0]} is not inline: {len(sample.chunks)} chunks")

        # 3. read everything back; ranges, 416, HEAD, paged listings
        with _RssPeak(filer.proc.pid) as rss_down:
            rec["read"] = _filer_read_all(filer.faddr, files[:1], want, "the big file")
        rec["read"].update(_filer_read_all(filer.faddr, files[1:], want, "the rest"))
        check(rss_up.peak < FILER_RSS_LIMIT and rss_down.peak < FILER_RSS_LIMIT,
              f"the filer's peak RSS moving the big file: {rss_up.peak} B up, "
              f"{rss_down.peak} B down (limit {FILER_RSS_LIMIT})")
        rng = np.random.default_rng([seed, 1313])
        conn = _filer_conn(filer.faddr)
        chunk = FILER_CHUNK_MB * MIB
        for _ in range(FILER_RANGE_READS):
            edge = int(rng.integers(1, FILER_BIG_BYTES // chunk)) * chunk
            lo = edge - int(rng.integers(1, 2 * MIB))
            hi = edge + int(rng.integers(0, 2 * MIB))
            status, sha, n, hdrs, _dt = _filer_get(conn, big[0], {"Range": f"bytes={lo}-{hi}"})
            expect = hashlib.sha256(b"".join(_filer_blocks(seed, 0, big[1], lo, hi + 1))).hexdigest()
            check(status == 206 and n == hi - lo + 1 and sha == expect
                  and hdrs.get("Content-Range") == f"bytes {lo}-{hi}/{big[1]}",
                  f"Range {lo}-{hi} of the big file: {status}, {n} bytes, {hdrs}")
        status, _sha, n, hdrs, _dt = _filer_get(conn, big[0], {"Range": f"bytes={big[1]}-"})
        check(status == 416 and n == 0 and hdrs.get("Content-Range") == f"bytes */{big[1]}",
              f"an unsatisfiable Range answered {status} {hdrs}")
        conn.request("HEAD", big[0])
        resp = conn.getresponse()
        resp.read()
        check(resp.status == 200 and resp.getheader("Content-Length") == str(big[1]),
              f"HEAD of the big file: {resp.status} {resp.getheader('Content-Length')}")
        listed: dict = {}
        pages = 0
        for d in range(FILER_DIRS):
            last, names = "", []
            while True:
                status, body = pool.request(filer.faddr, "GET",
                                            f"/data/d{d:02d}?limit=50&lastFileName={last}")
                check(status == 200, f"listing /data/d{d:02d}: {status}")
                doc = json.loads(body)
                pages += 1
                names += [(e["FullPath"], e["FileSize"]) for e in doc["Entries"]]
                if not doc["ShouldDisplayLoadMore"]:
                    break
                last = doc["LastFileName"]
            listed.update(dict(names))
        written = {p: s for p, s, _k in files if p.startswith("/data/d")}
        check(listed == written, f"the paged listings hold {len(listed)} names, "
                                 f"{len(written)} were written")
        conn.close()
        print(f"filer: {FILER_RANGE_READS} Range reads across chunk boundaries of the big file "
              f"equal, a 416 and a HEAD answered; {pages} listing pages of {FILER_DIRS} "
              f"directories name exactly the {len(written)} files written; the filer's peak RSS "
              f"reading the big file {rss_down.peak / MIB:.1f} MiB")
        rec["rss_mib"] = dict(upload_big=rss_up.peak / MIB, read_big=rss_down.peak / MIB)

        # 4. shell checks
        walls["fs_du"], out = shell("fs.du /data")
        n_chunked = sum(1 for f in files if f[1] > 2048)
        check(f"file:{len(files)} size:{total_bytes} /data" in out, f"fs.du: {out!r}")
        walls["fs_verify"], out = shell("fs.verify /data")
        check(f"verified {n_chunked} files, 0 broken" in out, f"fs.verify: {out!r}")
        _w, out = shell("fs.ls -l /data/d00; fs.tree /data/d01")
        check(out.count("\n") >= 2 * FILER_SMALL_N // FILER_DIRS, f"fs.ls/fs.tree: {out[:400]!r}")

        # 5. orphans: 64 needles no entry references
        blobs = os.path.join(root, "orphans")
        os.makedirs(blobs)
        for i in range(FILER_ORPHANS):
            with open(os.path.join(blobs, f"o{i:02d}.bin"), "wb") as f:
                f.write(b"".join(_filer_blocks(seed, 20_000 + i, 1000 + 37 * i)))
        t = time.perf_counter()
        up = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch.cli", "upload", "-master",
                             maddr, "-collection", "filerdata",
                             *sorted(os.path.join(blobs, n) for n in os.listdir(blobs))],
                            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                            text=True, timeout=300, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                                filter(None, [os.path.dirname(os.path.abspath(__file__)),
                                              os.environ.get("PYTHONPATH")]))))
        walls["cli_upload"] = time.perf_counter() - t
        check(up.returncode == 0, f"cli upload exited {up.returncode}: {up.stderr[-2000:]}")
        orphans = [json.loads(line)["fid"] for line in up.stdout.splitlines()]
        check(len(orphans) == FILER_ORPHANS, f"cli upload printed {len(orphans)} fids")
        walls["fsck"], out = shell("lock; volume.fsck; unlock")
        m = re.search(r"checked (\d+) needles: found (\d+) orphans \((\d+)B\)", out)
        found = sorted(re.findall(r"orphan needle (\d+,[0-9a-f]+) \((\d+)B\)", out))
        want_ids = sorted(f"{f.split(',')[0]},{int(f.split(',')[1][:-8], 16):x}" for f in orphans)
        mc = MasterClient(maddr)
        orphan_bytes = 0
        for fid in orphans:  # the needle sizes the holders' needle maps give
            vid = int(fid.split(",")[0])
            key = int(fid.split(",")[1][:-8], 16)
            holder = next(s_ for s_ in servers if s_.url == mc.lookup_file_id(fid))
            ids = rpc.volume_stub(f"127.0.0.1:{holder.grpc_port}").VolumeNeedleIds(
                vs_pb.VolumeNeedleIdsRequest(volume_id=vid))
            orphan_bytes += dict(zip(ids.keys, ids.sizes))[key]
        check(m is not None and int(m[2]) == FILER_ORPHANS and int(m[3]) == orphan_bytes
              and [f for f, _b in found] == want_ids,
              f"volume.fsck: {m[0] if m else out[-400:]!r}; want {FILER_ORPHANS} orphans of "
              f"{orphan_bytes} B")
        rec["fsck"] = dict(needles=int(m[1]), orphans=int(m[2]), orphan_bytes=int(m[3]))
        walls["fsck_purge"], out = shell(
            "lock; volume.fsck -reallyDeleteFromVolume -cutoffAgeSeconds 0; unlock")
        check(f"purged {FILER_ORPHANS} orphans ({orphan_bytes}B)" in out, f"fsck purge: {out[-400:]!r}")
        _w, out = shell("lock; volume.fsck; unlock")
        check("found 0 orphans (0B)" in out, f"fsck after the purge: {out[-400:]!r}")
        for fid in orphans:
            status, _b = pool.request(mc.lookup_file_id(fid), "GET", f"/{fid}")
            check(status == 404, f"purged orphan {fid}: {status}")
        print(f"filer: cli upload of {FILER_ORPHANS} needles {walls['cli_upload']:.3f}s; "
              f"volume.fsck checked {rec['fsck']['needles']} needles and found exactly those "
              f"{FILER_ORPHANS} ({orphan_bytes} B) in {walls['fsck']:.3f}s; purged in "
              f"{walls['fsck_purge']:.3f}s, then 0, the purged fids 404")

        # 6. fs.rm -r of one directory: paths and chunks 404
        rm_dir = f"/data/d{FILER_RM_DIR:02d}"
        doomed = [Entry.from_pb(rm_dir, r.entry) for r in fstub.ListEntries(
            f_pb.ListEntriesRequest(directory=rm_dir, limit=10_000))]
        check(len(doomed) == FILER_SMALL_N // FILER_DIRS, f"{rm_dir} holds {len(doomed)} entries")
        fids = [c.fid for e in doomed for c in e.chunks]
        walls["fs_rm"], out = shell(f"fs.rm -r {rm_dir}")
        for e in doomed:
            status, _b = pool.request(filer.faddr, "GET", e.full_path)
            check(status == 404, f"{e.full_path} after fs.rm: {status}")
        for fid in fids:
            for url in mc.lookup_urls(fid):
                status, _b = pool.request(url, "GET", f"/{fid}")
                check(status == 404, f"chunk {fid} of {rm_dir} on {url}: {status}")
        files = [f for f in files if not f[0].startswith(rm_dir + "/")]
        total_bytes = sum(f[1] for f in files)
        print(f"filer: fs.rm -r {rm_dir} ({len(doomed)} files, {len(fids)} chunks) "
              f"{walls['fs_rm']:.3f}s; every path and chunk answers 404")

        # the split of one upload and one read (in process, then deleted)
        rec["profile"] = _filer_profile(maddr, seed, ident)

        # 7. the filer restarts on its -db
        before = {d: pool.request(filer.faddr, "GET", f"/data/d{d:02d}?limit=1000")[1]
                  for d in range(FILER_DIRS) if d != FILER_RM_DIR}
        check(filer.stop() == 0, "the filer did not stop cleanly")
        t = time.perf_counter()
        filer = start_filer("filer.restart.log")
        walls["filer_restart"] = time.perf_counter() - t
        after = {d: pool.request(filer.faddr, "GET", f"/data/d{d:02d}?limit=1000")[1]
                 for d in before}
        check(after == before, "the listings differ after the restart")
        rng = np.random.default_rng([seed, 1307])
        picks = [files[i] for i in rng.choice(len(files), FILER_RESTART_SAMPLE, replace=False)]
        _filer_read_all(filer.faddr, picks, want, "after the restart (a sample)")
        print(f"filer: restarted on its -db in {walls['filer_restart']:.3f}s: {len(before)} "
              f"listings byte-identical, {FILER_RESTART_SAMPLE} sampled files equal")

        # 8. ec.encode of every filerdata volume; K1 in the servers
        vols: dict = {}
        for d in dirs:
            for n in os.listdir(d):
                mm = re.fullmatch(r"filerdata_(\d+)\.dat", n)
                if mm:
                    vols[int(mm[1])] = os.path.getsize(os.path.join(d, n))
        tasks = sum(len(ec_encoder._plan_tasks(DEFAULT_SCHEME, s, ec_encoder.DEFAULT_CHUNK))
                    for s in vols.values())
        k1_before = {s_.url: metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply")
                     for s_ in servers}
        check(not any(k1_before.values()), f"K1 launched before the encode: {k1_before}")
        walls["ec_encode"], _out = shell(
            "lock; ec.encode -collection filerdata -fullPercent 0 -quietFor 0; unlock")
        by_grpc = {f"127.0.0.1:{s_.grpc_port}": d for s_, d in zip(servers, dirs)}
        for vid in vols:
            _poll(lambda: _ec_census(mstub, vid)["holders"] == _disk_shards(by_grpc, f"filerdata_{vid}"),
                  f"the master's EC census of {vid} to match the disks", 60)
        k1 = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply"))
              for s_ in servers}
        check(sum(k1.values()) == tasks and tasks > 0,
              f"K1 launches by server {k1}; the generates of {len(vols)} volumes have {tasks} batches")
        check(not any(re.fullmatch(r"filerdata_\d+\.dat", n) for d in dirs for n in os.listdir(d)),
              "a filerdata .dat survived the encode")
        print(f"filer: ec.encode of {len(vols)} filerdata volumes ({sum(vols.values())} B) "
              f"{walls['ec_encode']:.3f}s on {ident}; K1 launches by server {k1} (= {tasks} "
              f"batches)")
        rec["read_ec"] = _filer_read_all(filer.faddr, files, want, "from EC shards")

        # 9. a volume server SIGKILLed: degraded reads; ec.rebuild
        census = {vid: _ec_census(mstub, vid)["holders"] for vid in vols}

        def data_shards(s_) -> int:
            return sum(sid < 10 for h in census.values()
                       for sid in h.get(f"127.0.0.1:{s_.grpc_port}", []))

        victim = max(servers, key=data_shards)  # the most data shards: reads must reconstruct
        victim_addr = f"127.0.0.1:{victim.grpc_port}"
        lost = {vid: h.get(victim_addr, []) for vid, h in census.items()}

        def one_server() -> str:
            """Step 10, beside the prune wait of step 9: ``cli server -filer``
            on its own master, one upload and one read."""
            srv_dir = os.path.join(root, "server")
            os.makedirs(srv_dir)
            t = time.perf_counter()
            one = _Server("", "", os.path.join(root, "server.log"), wait=False, argv=[
                "server", "-filer", "-device", dev.type, "-dir", srv_dir, "-masterPort", "0",
                "-port", "0", "-filerPort", "0"])
            try:
                line = one.proc.stdout.readline().strip()
                walls["server_up"] = time.perf_counter() - t
                m = re.search(r"filer (127\.0\.0\.1:\d+) \(gRPC", line)
                if m is None:
                    raise SmokeFailure(f"cli server -filer did not start: {line!r}: "
                                       f"{one.log_text()[-2000:]}")
                body = b"".join(_filer_blocks(seed, 30_000, 3 * MIB + 5))
                deadline = time.perf_counter() + 60
                while True:
                    status, reply = pool.request(m[1], "POST", "/one/x.bin", body=body)
                    if status == 201 or time.perf_counter() > deadline:
                        break
                    time.sleep(0.2)  # until the volume server's first heartbeat
                status2, got = pool.request(m[1], "GET", "/one/x.bin")
                rc_one = one.stop()
                check(status == 201 and status2 == 200 and got == body and rc_one == 0,
                      f"cli server -filer: POST {status} {reply[:200]!r}, GET {status2} "
                      f"({'equal' if got == body else 'differs'}), rc {rc_one}")
            finally:
                one.stop()
            return (f"filer: cli server -filer -device {dev.type} up in "
                    f"{walls['server_up']:.3f}s ({line}); one upload and one read equal; "
                    f"SIGTERM rc 0")

        live = [s_ for s_ in servers if s_ is not victim]
        victim.proc.send_signal(signal.SIGKILL)
        victim.proc.wait()
        side = _Beside(one_server)
        walls["prune_wait"] = _poll(lambda: victim.url not in nodes(),
                                    f"the master to prune {victim.url}", PRUNE_WAIT_S)
        print(f"filer: SIGKILL {victim.url} (shards {lost}); pruned after {walls['prune_wait']:.3f}s")
        server_line = side.result()
        rec["read_degraded"] = _filer_read_all(filer.faddr, files, want, "degraded")
        rec["reconstructed_intervals"] = int(sum(
            metric(s_.metrics(), "weedtpu_ec_degraded_reads_total", mode="reconstruct")
            for s_ in live))
        check(rec["reconstructed_intervals"] > 0 and data_shards(victim) > 0,
              f"the degraded reads reconstructed {rec['reconstructed_intervals']} intervals; the "
              f"victim held {data_shards(victim)} data shards")
        k1_live = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches",
                                      kernel="gf_apply")) for s_ in live}
        walls["ec_rebuild"], _out = shell("lock; ec.rebuild -collection filerdata; unlock")
        k1_rebuild = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches",
                                         kernel="gf_apply")) - k1_live[s_.url] for s_ in live}
        check(sum(k1_rebuild.values()) > 0, f"ec.rebuild launched no K1: {k1_rebuild}")
        live_grpc = {a: d for a, d in by_grpc.items() if a != victim_addr}
        for vid in vols:
            _poll(lambda: sorted(s for sids in _disk_shards(live_grpc, f"filerdata_{vid}").values()
                                 for s in sids) == list(range(14)),
                  f"14 shards of {vid} on the live servers", 60)
        rng = np.random.default_rng([seed, 1309])
        picks = [files[0]] + [files[i] for i in rng.choice(
            np.arange(1, len(files)), FILER_REBUILD_SAMPLE - 1, replace=False)]
        rec["read_rebuilt"] = _filer_read_all(filer.faddr, picks, want, "after ec.rebuild")
        print(f"filer: ec.rebuild -collection filerdata {walls['ec_rebuild']:.3f}s on {ident}; K1 "
              f"launches {k1_rebuild}; every volume has 14 shards on the live servers")

        # 10. cli server -filer -device <dev>, run beside step 9's prune wait
        print(server_line)
    finally:
        if side is not None:
            side.wait()
        pool.close()
        rcs = {getattr(s_, "url", s_.proc.pid): s_.stop() for s_ in servers}
        if filer is not None:
            rcs["filer"] = filer.stop()
        rcs["master"] = master.stop()
    check(all(rc == 0 for k, rc in rcs.items() if k != victim.url) and rcs[victim.url] == -signal.SIGKILL,
          f"filer phase processes exited {rcs}")
    walls["phase"] = time.perf_counter() - t_phase
    rec.update(walls=walls, launches=tasks + sum(k1_rebuild.values()), launches_encode=tasks,
               launches_rebuild=sum(k1_rebuild.values()), volumes=len(vols), files=len(files),
               bytes=total_bytes, rcs={str(k): v for k, v in rcs.items()})
    print("filer: " + json.dumps(rec, sort_keys=True))
    return rec


# -- phase 14 -----------------------------------------------------------------

S3_AK, S3_SK = "AKIDSMOKE", "smoke-secret-key"
S3_BUCKET = "bench"
S3_SMALL_N = 128  # 1-64 KiB objects (cut from 8,192; 1,024 before phase 16, 512 before 17, 256 before 19)
S3_CHUNKED_EVERY = 4  # a quarter of them as signed aws-chunked bodies
S3_STREAM_CHUNK = 64 * 1024  # the aws-chunked chunk size of botocore's streaming signer
S3_LARGE_N = 4  # 8-64 MiB objects, multipart (cut from 16 for phase 15, 8 for phase 17)
S3_BIG_BYTES = 128 * MIB  # one object of 16 parts (cut from 1 GiB for the time limit, 256 MiB before phase 18)
S3_PART = 8 * MIB  # aws-cli's multipart_chunksize default
S3_PART_CONCURRENCY = 10  # aws-cli's max_concurrent_requests default
S3_CLIENTS = 16
S3_MIXED_OPS = 320  # MinIO warp mixed, cut for the time limit (20,000, then 2,500, 1,250, 625)
S3_MIX = (("GET", 45), ("HEAD", 30), ("PUT", 15), ("DELETE", 10))  # warp mixed's defaults
S3_LIST_PAGE = 1000
S3_RANGE_READS = 16
S3_SSE_BYTES = 16 * MIB
S3_HOT_SET = 128  # keys of the hot set whose second GET pass reads the chunk cache
S3_CACHE_MB = 64
S3_REBUILD_SAMPLE = 128  # halved for phase 16 and again for phase 17
S3_PROFILE = dict(small=256, part=16, reads=256)  # the in-process split of one request


def _s3_objects(seed: int) -> list:
    """[(key, size, kind, body key)] of the fill: the small objects (a
    quarter ``chunked``), the large ones and the 128 MiB one, sizes from
    ``seed``."""
    import numpy as np

    rng = np.random.default_rng([seed, 14])
    objs = [(f"small/{i % 64:02d}/o{i:05d}.bin", int(s),
             "chunked" if i % S3_CHUNKED_EVERY == 0 else "small", 200 + i)
            for i, s in enumerate(rng.integers(1024, 64 * 1024 + 1, S3_SMALL_N))]
    objs += [(f"large/l{i:02d}.bin", int(rng.integers(8 * MIB, 64 * MIB + 1)), "large", 100 + i)
             for i in range(S3_LARGE_N)]
    objs.append(("big/one.bin", S3_BIG_BYTES, "big", 99))
    return objs


def _s3_body(seed: int, key: int, size: int, lo: int = 0, hi: int | None = None) -> bytes:
    return b"".join(_filer_blocks(seed, key, size, lo, hi))


class _S3Client:
    """One keep-alive connection to the gateway whose requests are signed
    by ``client_sign`` at the current time (SigV4 headers, aws-chunked
    streaming, presigned URLs) or sent anonymously."""

    def __init__(self, addr: str):
        self.addr = addr
        self.conn = _filer_conn(addr)

    def close(self) -> None:
        self.conn.close()

    def request(self, method: str, path: str, query: str = "", body: bytes = b"",
                headers: dict | None = None, mode: str = "v4", sink: bool = False) -> tuple:
        """(status, body or (sha256, length) when ``sink``, headers, seconds)."""
        from seaweedfs_tpu_torch.s3 import client_sign

        headers = dict(headers or {})
        quoted = urllib.parse.quote(path)
        target = quoted + (f"?{query}" if query else "")
        t0 = time.perf_counter()
        if mode == "v4":
            headers.update(client_sign.sign_headers(method, quoted, query, self.addr, body,
                                                    S3_AK, S3_SK, extra_headers=headers))
        elif mode == "stream":
            signed, body = client_sign.sign_streaming(method, quoted, query, self.addr, body,
                                                      S3_AK, S3_SK, chunk_size=S3_STREAM_CHUNK)
            headers.update(signed)
        elif mode == "presign":
            target = quoted + "?" + client_sign.presign_url(method, quoted, self.addr, S3_AK,
                                                            S3_SK, expires=600)
        try:
            self.conn.request(method, target, body=body or None, headers=headers)
            resp = self.conn.getresponse()
            if sink:
                sha, n = hashlib.sha256(), 0
                while True:
                    piece = resp.read(MIB)
                    if not piece:
                        break
                    sha.update(piece)
                    n += len(piece)
                data = (sha.hexdigest(), n)
            else:
                data = resp.read()
        except (OSError, http.client.HTTPException):
            self.conn.close()
            self.conn = _filer_conn(self.addr)
            raise
        return resp.status, data, {k.lower(): v for k, v in resp.getheaders()}, \
            time.perf_counter() - t0


def _s3_pool(addr: str, items: list, fn, clients: int = S3_CLIENTS) -> list:
    """``fn(client, item)`` over ``items`` by ``clients`` threads, each with
    its own keep-alive ``_S3Client``; results in item order; any failure
    fails the phase."""
    tickets = iter(range(len(items)))
    lock = threading.Lock()
    out: list = [None] * len(items)
    failures: list = []

    def worker() -> None:
        client = _S3Client(addr)
        try:
            while True:
                with lock:
                    i = next(tickets, None)
                    if i is None or failures:
                        return
                try:
                    out[i] = fn(client, items[i])
                except Exception as e:  # noqa: BLE001 — reported, fails the phase
                    failures.append(f"{items[i]!r:.80}: {type(e).__name__}: {e}")
                    return
        finally:
            client.close()

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=1200)
    check(not failures and not any(th.is_alive() for th in threads) and None not in out,
          f"{sum(r is not None for r in out)} of {len(items)} done; {failures[:3]}")
    return out


def _s3_multipart(addr: str, seed: int, objs: list, path_of) -> list:
    """Multipart uploads of ``objs`` through one pool of
    S3_PART_CONCURRENCY part uploads (aws-cli's transfer manager): create,
    S3_PART parts, complete.  [(sha256, multipart ETag, seconds)] in order;
    every part's and the final ETag are checked."""
    import xml.etree.ElementTree as ET

    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    admin = _S3Client(addr)
    uploads = []
    for key, size, _kind, bkey in objs:
        status, data, _h, _dt = admin.request("POST", path_of(key), "uploads=")
        check(status == 200, f"CreateMultipartUpload {key}: {status} {data[:200]!r}")
        uploads.append(ET.fromstring(data).findtext(f"{ns}UploadId"))
    parts = [(i, n, lo, min(lo + S3_PART, size))
             for i, (key, size, _kind, _b) in enumerate(objs)
             for n, lo in enumerate(range(0, size, S3_PART), start=1)]

    def put_part(client, part):
        i, n, lo, hi = part
        key, size, _kind, bkey = objs[i]
        body = _s3_body(seed, bkey, size, lo, hi)
        md5 = hashlib.md5(body).hexdigest()
        t0 = time.perf_counter()
        status, data, hdrs, _dt = client.request(
            "PUT", path_of(key), f"partNumber={n}&uploadId={uploads[i]}", body)
        check(status == 200 and hdrs.get("etag") == f'"{md5}"',
              f"UploadPart {key} #{n}: {status} {hdrs.get('etag')} != {md5}: {data[:200]!r}")
        return md5, t0, time.perf_counter()

    got = _s3_pool(addr, parts, put_part, clients=S3_PART_CONCURRENCY)
    out = []
    for i, (key, size, _kind, _b) in enumerate(objs):
        mine = [(p[1], g) for p, g in zip(parts, got) if p[0] == i]
        doc = "".join(f"<Part><PartNumber>{n}</PartNumber><ETag>\"{g[0]}\"</ETag></Part>"
                      for n, g in mine)
        t_first = min(g[1] for _n, g in mine)
        status, data, _h, _dt = admin.request(
            "POST", path_of(key), f"uploadId={uploads[i]}",
            f"<CompleteMultipartUpload>{doc}</CompleteMultipartUpload>".encode())
        etag = hashlib.md5(b"".join(bytes.fromhex(g[0]) for _n, g in mine)).hexdigest()
        etag = f"{etag}-{len(mine)}"
        t_done = time.perf_counter()
        check(status == 200 and ET.fromstring(data).findtext(f"{ns}ETag") == f'"{etag}"',
              f"CompleteMultipartUpload {key}: {status} {data[:300]!r}, want {etag}")
        sha = hashlib.sha256()
        for piece in _filer_blocks(seed, objs[i][3], size):
            sha.update(piece)
        # an object's latency: its first part sent to its completion answered
        out.append((sha.hexdigest(), etag, t_done - t_first))
    admin.close()
    return out


S3_SPLICE_OBJECTS = (1 * MIB, 8 * MIB, 8 * MIB + 12345, 24 * MIB)  # open-gateway PUTs
S3_SPLICE_BUCKET = "splice"


def _s3_splice(maddr: str, filer_grpc: str, gw_metrics: str, root: str, seed: int,
               ident: str) -> dict:
    """The gateways' native splice (filer/splice.py over csrc/dp.cpp): the
    SigV4 gateway's px counters after the fill, mixed and feature passes
    (spliced GET views > 0, the ladder's fallbacks, the px loop mode); then
    an open-access ``cli s3`` over the same filer takes streaming PUTs of
    S3_SPLICE_OBJECTS, each chunk fanned out by the native plane with the
    ETag computed in-stream, and GETs them back spliced: every object's
    ETag equals its md5 and its body's sha256 its own."""
    import numpy as np

    mode, main = px_stats_of(gw_metrics)
    check(main["get_spliced"] > 0, f"the SigV4 gateway spliced no GET view: {main}")
    ladder = {k: v for k, v in main.items() if k.startswith("ladder_")}
    print(f"s3: native splice on {ident}: px loop mode {mode}; the SigV4 gateway spliced "
          f"{main['get_spliced']} GET views ({main['get_bytes']} B), {main['get_midstream']} "
          f"resumed mid-stream, cache sends {main['cache_send_ok']}; the ladder's Python-side "
          f"steps {ladder}")
    port = _free_ports(1)[0]
    g = _Server("", "", os.path.join(root, "s3.open.log"), wait=False, argv=[
        "s3", "-master", maddr, "-filer", filer_grpc, "-port", "0", "-metricsPort", str(port)])
    try:
        line = _readline_within(g.proc, 120)
        m = re.search(r"s3 gateway on (127\.0\.0\.1:\d+) \(auth=open\)", line)
        check(m is not None, f"the open cli s3 did not start: {line!r}: {g.log_text()[-2000:]}")
        addr = m[1]
        rng = np.random.default_rng([seed, 1414])
        status, _h, _b = _plain_http(addr, "PUT", f"/{S3_SPLICE_BUCKET}")
        check(status == 200, f"open gateway: PUT bucket {status}")
        objs = {f"o{i}": rng.bytes(n) for i, n in enumerate(S3_SPLICE_OBJECTS)}
        t = time.perf_counter()
        for key, body in objs.items():
            status, h, _b = _plain_http(addr, "PUT", f"/{S3_SPLICE_BUCKET}/{key}", body)
            check(status == 200 and h.get("etag") == f'"{hashlib.md5(body).hexdigest()}"'
                  and h.get("x-weed-spliced") == "1",
                  f"open gateway PUT {key}: {status} {h}")
        put_s = time.perf_counter() - t
        t = time.perf_counter()
        for key, body in objs.items():
            status, h, got = _plain_http(addr, "GET", f"/{S3_SPLICE_BUCKET}/{key}")
            check(status == 200 and hashlib.sha256(got).digest() == hashlib.sha256(body).digest()
                  and h.get("x-weed-spliced") == "1", f"open gateway GET {key}: {status} {h}")
        get_s = time.perf_counter() - t
        open_mode, st = px_stats_of(f"127.0.0.1:{port}")
    finally:
        rc = g.stop()
    check(rc == 0, f"the open gateway exited {rc}")
    chunks = sum(-(-n // (4 * MIB)) for n in S3_SPLICE_OBJECTS)
    check(st["fanout_ok"] == chunks and st["get_spliced"] >= len(objs),
          f"the open gateway fanned out {st['fanout_ok']} of {chunks} chunks natively, spliced "
          f"{st['get_spliced']} GET views")
    mb = sum(S3_SPLICE_OBJECTS) / 1e6
    print(f"s3: native splice on {ident}: an open gateway PUT {len(objs)} objects ({mb:.3f} MB, "
          f"{st['fanout_ok']} chunks fanned out natively, {st['fanout_bytes']} B, replica acks "
          f"{st['fanout_replica_acks']}) in {put_s:.3f}s and GOT them back spliced "
          f"({st['get_spliced']} views) in {get_s:.3f}s, every ETag its md5 and every body "
          f"sha256-equal; px loop mode {open_mode}; ladder "
          f"{ {k: v for k, v in st.items() if k.startswith('ladder_')} }")
    return dict(mode=mode, main=main, open=st, open_mode=open_mode, put_s=put_s, get_s=get_s)


def _plain_http(addr: str, method: str, path: str, body: bytes = b"",
                headers: dict | None = None):
    """One unsigned request on a fresh connection: (status, headers, body)."""
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        conn.request(method, path, body=body or None, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def _readline_within(proc, timeout: float) -> str:
    """The next stdout line of ``proc``, or "" after ``timeout`` seconds."""
    import select

    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    return proc.stdout.readline().strip() if ready else ""


def _s3_read_all(addr: str, bucket: str, model: dict, label: str) -> dict:
    """Every live object of ``model`` ({key: (size, sha256, etag)}) GET
    through the gateway, ETag- and sha256-equal; figures per class."""
    classes: dict = {}
    for key, (size, _sha, _etag) in model.items():
        cls = key.split("/", 1)[0]
        classes.setdefault(cls, []).append(key)
    rec = {}
    for cls in ("big", "large", "small"):
        keys = classes.get(cls)
        if not keys:
            continue

        def one(client, key):
            size, sha, etag = model[key]
            status, (got, n), hdrs, dt = client.request("GET", f"/{bucket}/{key}", sink=True)
            check(status == 200 and n == size and got == sha and hdrs.get("etag") == f'"{etag}"',
                  f"{label}: GET {key}: {status}, {n} of {size} bytes, sha256 "
                  f"{'equal' if got == sha else 'differs'}, ETag {hdrs.get('etag')} / {etag}")
            return dt

        t = time.perf_counter()
        lat = _s3_pool(addr, keys, one)
        rec[cls] = _class_figures(cls, [model[k][0] for k in keys], lat, time.perf_counter() - t)
    print(f"s3: read {label}: " + "; ".join(
        f"{cls} {r['files']} objects {r['files_per_s']:.1f}/s {r['mb_per_s']:.1f} MB/s p50 "
        f"{r['p50_ms']:.2f} ms p99 {r['p99_ms']:.2f} ms" for cls, r in rec.items())
        + ", every one ETag- and sha256-equal")
    return rec


def _s3_list(client, bucket: str) -> tuple[dict, int]:
    """A ListObjectsV2 walk (max-keys S3_LIST_PAGE, continuation tokens):
    ({key: (size, etag)}, pages)."""
    import xml.etree.ElementTree as ET

    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    listed, token, pages = {}, "", 0
    while True:
        query = f"list-type=2&max-keys={S3_LIST_PAGE}"
        if token:
            query = f"continuation-token={urllib.parse.quote(token, safe='')}&" + query
        status, data, _h, _dt = client.request("GET", f"/{bucket}", query)
        check(status == 200, f"ListObjectsV2 {bucket}: {status} {data[:200]!r}")
        root = ET.fromstring(data)
        pages += 1
        for c in root.iter(f"{ns}Contents"):
            listed[c.findtext(f"{ns}Key")] = (int(c.findtext(f"{ns}Size")),
                                              c.findtext(f"{ns}ETag").strip('"'))
        if root.findtext(f"{ns}IsTruncated") != "true":
            return listed, pages
        token = root.findtext(f"{ns}NextContinuationToken")


def _s3_mixed(addr: str, seed: int, model: dict) -> dict:
    """MinIO warp ``mixed`` over the small objects: S3_CLIENTS clients,
    each owning its share of the keys (so the model stays exact), draw
    S3_MIXED_OPS operations by S3_MIX.  Every answer is held to the model
    ({key: (size, sha256, md5)}): GET bytes, HEAD ETag and length, 404 for
    a deleted key; PUTs and DELETEs update it."""
    import numpy as np

    keys = sorted(k for k in model if k.startswith("small/"))
    ops = [op for op, _w in S3_MIX]
    weights = np.array([w for _op, w in S3_MIX], dtype=float)
    per_client = S3_MIXED_OPS // S3_CLIENTS
    lat: dict = {op: [] for op in ops}
    lock = threading.Lock()

    def run(client, c):
        rng = np.random.default_rng([seed, 1400, c])
        mine = keys[c::S3_CLIENTS]
        local = {op: [] for op in ops}
        for j in range(per_client):
            op = ops[rng.choice(len(ops), p=weights / weights.sum())]
            key = mine[int(rng.integers(len(mine)))]
            path = f"/{S3_BUCKET}/{key}"
            want = model[key]
            if op == "GET":
                status, (sha, n), _h, dt = client.request("GET", path, sink=True)
                check((status, n, sha) == ((200, want[0], want[1]) if want else (404, n, sha)),
                      f"mixed GET {key}: {status}, {n} bytes, model {want and want[0]}")
            elif op == "HEAD":
                status, _d, hdrs, dt = client.request("HEAD", path)
                check(status == 404 if want is None else
                      (status == 200 and hdrs.get("etag") == f'"{want[2]}"'
                       and hdrs.get("content-length") == str(want[0])),
                      f"mixed HEAD {key}: {status} {hdrs.get('etag')}, model {want}")
            elif op == "PUT":
                size = int(rng.integers(1024, 64 * 1024 + 1))
                body = _s3_body(seed, 1_000_000 + c * per_client + j, size)
                md5 = hashlib.md5(body).hexdigest()
                status, data, hdrs, dt = client.request("PUT", path, body=body)
                check(status == 200 and hdrs.get("etag") == f'"{md5}"',
                      f"mixed PUT {key}: {status} {data[:200]!r}")
                model[key] = (size, hashlib.sha256(body).hexdigest(), md5)
            else:
                status, data, _h, dt = client.request("DELETE", path)
                check(status == 204, f"mixed DELETE {key}: {status} {data[:200]!r}")
                model[key] = None
            local[op].append(dt)
        with lock:
            for op in ops:
                lat[op] += local[op]
        return True

    t = time.perf_counter()
    _s3_pool(addr, list(range(S3_CLIENTS)), run)
    wall = time.perf_counter() - t
    n = per_client * S3_CLIENTS
    rec = dict(ops=n, wall_s=wall, ops_per_s=n / wall)
    for op in ops:
        ms = np.array(lat[op]) * 1e3
        rec[op] = dict(n=len(ms), p50_ms=float(np.percentile(ms, 50)),
                       p99_ms=float(np.percentile(ms, 99)))
    return rec


def _s3_profile(maddr: str, gaddr: str, seed: int, ident: str) -> dict:
    """What one S3 request waits on: an in-process S3ApiServer (the code
    of ``cli s3 -filer``) over RemoteFiler to the phase's filer, with its
    SigV4 verify (the payload hash and the signature), body read,
    aws-chunked decode, FidPool take, volume POST/GET, filer insert/find
    and entry-cache hits and misses timed;
    requests one at a time (16 KiB PUTs as aws-chunked bodies, 8 MiB
    multipart parts, 16 KiB GETs).  Its bucket is deleted at the end."""
    import numpy as np

    from seaweedfs_tpu_torch.filer import reader, upload
    from seaweedfs_tpu_torch.filer.remote import RemoteFiler
    from seaweedfs_tpu_torch.s3 import s3_server
    from seaweedfs_tpu_torch.s3.auth import Identity
    from seaweedfs_tpu_torch.wdclient import MasterClient

    parts: dict = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    remote = RemoteFiler(gaddr, MasterClient(maddr))
    gw = s3_server.S3ApiServer(maddr, port=0, filer=remote,
                               identities={S3_AK: Identity(S3_AK, S3_SK, "admin")},
                               chunk_size=FILER_CHUNK_MB * MIB, chunk_cache_mb=0,
                               lifecycle_sweep_interval=0)
    handler = s3_server._S3HttpHandler
    saved = (handler._read_body, handler._auth_and_decode, s3_server.decode_aws_chunked,
             upload.http_put_chunk, reader._fetch_chunk_from)
    handler._read_body = timed("body_read", handler._read_body)
    # the payload hash, the signature and (aws-chunked) the decode: SigV4
    # verify is this less the decode
    handler._auth_and_decode = timed("auth", handler._auth_and_decode)
    s3_server.decode_aws_chunked = timed("chunked_decode", s3_server.decode_aws_chunked)
    upload.http_put_chunk = timed("volume_post", upload.http_put_chunk)
    reader._fetch_chunk_from = timed("volume_get", reader._fetch_chunk_from)
    gw.fid_pool.take = timed("fidpool", gw.fid_pool.take)
    remote.create_entry = timed("filer_insert", remote.create_entry)
    remote.update_entry = timed("filer_update", remote.update_entry)
    find = remote.find_entry

    def find_timed(path):
        parts["entry_cache_miss_n"] = parts.get("entry_cache_miss_n", 0) + 1
        t0 = time.perf_counter()
        try:
            return find(path)
        finally:
            parts["filer_find"] = parts.get("filer_find", 0.0) + time.perf_counter() - t0

    remote.find_entry = find_timed
    cache_get = gw.entry_cache.get

    def cache_get_counted(path, loader):
        parts["entry_cache_get_n"] = parts.get("entry_cache_get_n", 0) + 1
        return cache_get(path, loader)

    gw.entry_cache.get = cache_get_counted
    gw.start()
    rec = {}
    keys = ("sigv4_verify", "body_read", "chunked_decode", "fidpool", "volume_post",
            "volume_get", "filer_insert", "filer_update", "filer_find")

    def split_of(lat: list) -> dict:
        n = len(lat)
        split = {k: v / n * 1e3 for k, v in parts.items() if not k.endswith("_n")}
        split.update({k: v for k, v in parts.items() if k.endswith("_n")})
        split["sigv4_verify"] = split.pop("auth", 0.0) - split.get("chunked_decode", 0.0)
        if "entry_cache_get_n" in split:
            split["entry_cache_hit_n"] = split["entry_cache_get_n"] - min(
                split.get("entry_cache_miss_n", 0), split["entry_cache_get_n"])
        split["request_ms"] = sum(lat) / n * 1e3
        split["p50_ms"] = float(np.percentile(np.array(lat) * 1e3, 50))
        split["other_ms"] = split["request_ms"] - sum(split.get(k, 0.0) for k in keys)
        return split

    try:
        client = _S3Client(gw.url)
        status, _d, _h, _dt = client.request("PUT", "/profile")
        check(status == 200, f"profile bucket: {status}")
        bodies = [_s3_body(seed, 40_000 + i, 16 * 1024) for i in range(S3_PROFILE["small"])]
        parts.clear()
        lat = []
        for i, body in enumerate(bodies):
            status, data, _h, dt = client.request("PUT", f"/profile/s{i:04d}", body=body,
                                                  mode="stream")
            check(status == 200, f"profile PUT {i}: {status} {data[:200]!r}")
            lat.append(dt)
        rec["put_16KiB_chunked"] = split_of(lat)
        import xml.etree.ElementTree as ET

        status, data, _h, _dt = client.request("POST", "/profile/part.bin", "uploads=")
        upload_id = ET.fromstring(data).findtext(
            "{http://s3.amazonaws.com/doc/2006-03-01/}UploadId")
        bodies = [_s3_body(seed, 41_000 + i, S3_PART) for i in range(S3_PROFILE["part"])]
        parts.clear()
        lat = []
        for i, body in enumerate(bodies):
            status, data, _h, dt = client.request(
                "PUT", "/profile/part.bin", f"partNumber={i + 1}&uploadId={upload_id}", body)
            check(status == 200, f"profile part {i}: {status} {data[:200]!r}")
            lat.append(dt)
        rec["put_part_8MiB"] = split_of(lat)
        del bodies
        client.request("DELETE", "/profile/part.bin", f"uploadId={upload_id}")
        parts.clear()
        lat = []
        for i in range(S3_PROFILE["reads"]):
            status, (_sha, n), _h, dt = client.request("GET", f"/profile/s{i % S3_PROFILE['small']:04d}",
                                                       sink=True)
            check(status == 200 and n == 16 * 1024, f"profile GET {i}: {status}, {n} bytes")
            lat.append(dt)
        rec["get_16KiB"] = split_of(lat)
        for i in range(S3_PROFILE["small"]):
            client.request("DELETE", f"/profile/s{i:04d}")
        status, _d, _h, _dt = client.request("DELETE", "/profile")
        check(status == 204, f"profile bucket delete: {status}")
        client.close()
    finally:
        (handler._read_body, handler._auth_and_decode, s3_server.decode_aws_chunked,
         upload.http_put_chunk, reader._fetch_chunk_from) = saved
        gw.stop()
    for label, split in rec.items():
        print(f"s3: split {label} on {ident} (host time, ms a request): " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in split.items()))
    return rec


def phase_s3(args, directory: str, ident: str, dev) -> dict:
    """Phase 14: the S3 gateway.  One ``cli master -volumeSizeLimitMB 256``,
    four ``cli volume -device cuda -scrubInterval 0 -scrubRateMB 0`` on two
    racks, one ``cli filer -db <dir>`` and, in front, one ``cli s3 -filer
    <the filer's gRPC> -accessKey K -secretKey S -cacheMB 64 -kmsKeyFile
    F`` (SigV4 required; every request is signed by ``client_sign``).
    Fill (16 clients): 128 objects of 1-64 KiB (a quarter as signed
    aws-chunked bodies), 4 of 8-64 MiB and one of 128 MiB as multipart in
    8 MiB parts, 10 parts at a time.  Mixed: MinIO warp mixed's 45/30/15/10
    GET/HEAD/PUT/DELETE over the small objects, every answer held to a
    model of key -> sha256, then a ListObjectsV2 walk equal to the model.
    Features: CopyObject, Range GETs, a presigned GET, versions, tagging,
    an anonymous 403 turned 200 by a bucket policy, SSE-S3 and SSE-C of a
    16 MiB object, and a quota freeze by ``s3.bucket.quota.check``.
    Coherence: an overwrite through the filer's HTTP API is seen through
    the gateway (the metadata subscriber), and a hot set's second GET pass
    reads the chunk cache.  The split of one PUT, one part and one GET.
    EC: ``ec.encode -volumeId`` of every volume that holds the buckets
    launches K1 once per batch in the servers; every object reads back
    from the shards, again degraded after a SIGKILL, and a sample after
    ``ec.rebuild`` (K1 again); the gateway restarts before each of those
    passes so that its chunk cache cannot answer for the shards.  And
    ``cli server -filer -s3 -device cuda`` takes a signed PUT and GET in
    one process and stops on SIGTERM with rc 0.  Figures on ``s3:``
    lines."""
    import importlib.util
    import xml.etree.ElementTree as ET

    import numpy as np

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.util.http_pool import HttpConnectionPool

    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    seed = args.seed
    root = os.path.join(directory, "s3")
    dirs = [os.path.join(root, f"v{i}") for i in range(4)]
    for d in dirs:
        os.makedirs(d)
    db = os.path.join(root, "db")
    key_file = os.path.join(root, "kms.json")
    log = os.path.join(root, "shell.log")
    crypto = importlib.util.find_spec("cryptography") is not None
    walls: dict = {}
    rec: dict = dict(cryptography=crypto)
    servers: list = []
    filer = gw = side = None
    victim = None
    t_phase = time.perf_counter()
    pool = HttpConnectionPool(timeout=60.0, max_per_host=64)
    objs = _s3_objects(seed)
    master = _Server("", "", os.path.join(root, "master.log"),
                     argv=["master", "-port", "0", "-volumeSizeLimitMB", str(FILER_VOLUME_MB)])
    try:
        maddr = f"127.0.0.1:{master.grpc_port}"
        mstub = rpc.master_stub(maddr)
        t = time.perf_counter()
        servers = [_Server(d, dev.type, os.path.join(root, f"v{i}.log"), wait=False, argv=[
            "volume", "-dir", d, "-ip", "127.0.0.1", "-port", "0", "-grpcPort", "0",
            "-metricsPort", "0", "-device", dev.type, "-mserver", maddr, "-rack", f"r{i % 2}",
            "-scrubInterval", "0", "-scrubRateMB", "0"]) for i, d in enumerate(dirs)]
        for s_ in servers:
            s_.ready()
            s_.url = f"127.0.0.1:{s_.http_port}"
        urls = [s_.url for s_ in servers]
        filer = _Server("", "", os.path.join(root, "filer.log"), argv=[
            "filer", "-master", maddr, "-port", "0", "-db", db])
        filer.faddr = f"127.0.0.1:{filer.http_port}"
        filer.gaddr = f"127.0.0.1:{filer.grpc_port}"
        gw_metrics = _free_ports(1)[0]
        n_gw = [0]

        def start_gateway():
            n_gw[0] += 1
            g = _Server("", "", os.path.join(root, f"s3.{n_gw[0]}.log"), wait=False, argv=[
                "s3", "-master", maddr, "-filer", filer.gaddr, "-port", "0",
                "-accessKey", S3_AK, "-secretKey", S3_SK, "-cacheMB", str(S3_CACHE_MB),
                "-metricsPort", str(gw_metrics),
                *(("-kmsKeyFile", key_file) if crypto else ())])
            line = g.proc.stdout.readline().strip()
            m = re.search(r"s3 gateway on (127\.0\.0\.1:\d+) \(auth=sigv4\)", line)
            if m is None:
                g.stop()
                raise SmokeFailure(f"cli s3 did not start: {line!r}: {g.log_text()[-2000:]}")
            g.addr = m[1]
            return g

        gw = start_gateway()
        walls["servers_up"] = time.perf_counter() - t

        def nodes() -> set:
            topo = mstub.VolumeList(m_pb.VolumeListRequest(), timeout=60).topology_info
            return {dn.id for dc in topo.data_center_infos for r in dc.rack_infos
                    for dn in r.data_node_infos}

        walls["registered"] = _poll(lambda: nodes() == set(urls), "all four nodes", 60)
        print(f"s3: master {maddr}, four volume servers at {urls} on {ident}, filer "
              f"{filer.faddr} (gRPC {filer.gaddr}), gateway {gw.addr} (SigV4, chunk cache "
              f"{S3_CACHE_MB} MB, KMS {'on' if crypto else 'off: no cryptography package'}), "
              f"up in {walls['servers_up']:.3f}s")
        admin = _S3Client(gw.addr)
        status, data, _h, _dt = admin.request("PUT", f"/{S3_BUCKET}")
        check(status == 200, f"CreateBucket {S3_BUCKET}: {status} {data[:200]!r}")

        # 1. the fill: 16 clients of small objects, then the multipart classes
        model: dict = {}  # key -> (size, sha256, etag)

        def put_small(client, o):
            key, size, kind, bkey = o
            body = _s3_body(seed, bkey, size)
            md5 = hashlib.md5(body).hexdigest()
            status, data, hdrs, dt = client.request(
                "PUT", f"/{S3_BUCKET}/{key}", body=body,
                mode="stream" if kind == "chunked" else "v4")
            check(status == 200 and hdrs.get("etag") == f'"{md5}"',
                  f"PUT {key} ({kind}): {status} {hdrs.get('etag')} != {md5}: {data[:200]!r}")
            return hashlib.sha256(body).hexdigest(), md5, dt

        smalls = [o for o in objs if o[2] in ("small", "chunked")]
        t = time.perf_counter()
        got = _s3_pool(gw.addr, smalls, put_small)
        filled_md5 = {o[0]: g[1] for o, g in zip(smalls, got)}
        fill = {"small": _class_figures("small", [o[1] for o in smalls], [g[2] for g in got],
                                        time.perf_counter() - t)}
        model.update({o[0]: (o[1], g[0], g[1]) for o, g in zip(smalls, got)})
        for cls in ("large", "big"):
            items = [o for o in objs if o[2] == cls]
            t = time.perf_counter()
            got = _s3_multipart(gw.addr, seed, items, lambda k: f"/{S3_BUCKET}/{k}")
            fill[cls] = _class_figures(cls, [o[1] for o in items], [g[2] for g in got],
                                       time.perf_counter() - t)
            model.update({o[0]: (o[1], g[0], g[1]) for o, g in zip(items, got)})
        rec["fill"] = fill
        print(f"s3: fill on {ident}: " + "; ".join(
            f"{cls} {r['files']} objects {r['files_per_s']:.1f}/s {r['mb_per_s']:.1f} MB/s p50 "
            f"{r['p50_ms']:.2f} ms p99 {r['p99_ms']:.2f} ms" for cls, r in fill.items())
            + f"; {len(objs)} objects, {sum(o[1] for o in objs)} bytes; "
            f"{sum(o[2] == 'chunked' for o in objs)} small ones as aws-chunked bodies")

        # 2. mixed: warp's distribution over the small objects; the final listing
        mixed_model = {k: (v[0], v[1], v[2]) for k, v in model.items()}
        rec["mixed"] = mx = _s3_mixed(gw.addr, seed, mixed_model)
        model = {k: v for k, v in mixed_model.items() if v is not None}
        t = time.perf_counter()
        listed, pages = _s3_list(admin, S3_BUCKET)
        walls["list"] = time.perf_counter() - t
        want_list = {k: (v[0], v[2]) for k, v in model.items()}
        check(listed == want_list, f"the ListObjectsV2 walk holds {len(listed)} keys, the model "
              f"{len(want_list)}; {len(set(listed) ^ set(want_list))} differ in name")
        print(f"s3: mixed on {ident}: {mx['ops']} ops by {S3_CLIENTS} clients "
              f"{mx['ops_per_s']:.1f} ops/s; " + "; ".join(
                  f"{op} {mx[op]['n']} p50 {mx[op]['p50_ms']:.2f} ms p99 {mx[op]['p99_ms']:.2f} ms"
                  for op, _w in S3_MIX)
              + f"; every answer held to the model; ListObjectsV2 walk ({pages} pages of "
              f"{S3_LIST_PAGE}) equals the model's {len(want_list)} keys in {walls['list']:.3f}s")

        # 3. features
        big_key = next(o for o in objs if o[2] == "big")
        large = next(o for o in objs if o[2] == "large")
        status, data, _h, _dt = admin.request(
            "PUT", f"/{S3_BUCKET}/copies/{large[0]}",
            headers={"x-amz-copy-source": f"/{S3_BUCKET}/{large[0]}"})
        check(status == 200 and ET.fromstring(data).tag == f"{ns}CopyObjectResult",
              f"CopyObject: {status} {data[:200]!r}")
        status, (sha, n), _h, _dt = admin.request("GET", f"/{S3_BUCKET}/copies/{large[0]}",
                                                  sink=True)
        check(status == 200 and (n, sha) == model[large[0]][:2], f"the copy reads {status}, {n} B")
        rng = np.random.default_rng([seed, 1401])
        for _ in range(S3_RANGE_READS):
            edge = int(rng.integers(1, S3_BIG_BYTES // S3_PART)) * S3_PART
            lo = edge - int(rng.integers(1, 3 * MIB))
            hi = edge + int(rng.integers(0, 3 * MIB))
            status, data, hdrs, _dt = admin.request(
                "GET", f"/{S3_BUCKET}/{big_key[0]}", headers={"Range": f"bytes={lo}-{hi}"})
            check(status == 206 and data == _s3_body(seed, big_key[3], big_key[1], lo, hi + 1)
                  and hdrs.get("content-range") == f"bytes {lo}-{hi}/{big_key[1]}",
                  f"Range {lo}-{hi} of the 128 MiB object: {status}, {len(data)} B, {hdrs}")
        small_key = next(k for k in sorted(model) if k.startswith("small/"))
        status, (sha, n), _h, _dt = admin.request("GET", f"/{S3_BUCKET}/{small_key}",
                                                  mode="presign", sink=True)
        check(status == 200 and (n, sha) == model[small_key][:2], f"presigned GET: {status}")
        status, _d, _h, _dt = admin.request("GET", f"/{S3_BUCKET}/{small_key}", mode="anon")
        check(status == 403, f"an anonymous GET answered {status}")
        # versions
        admin.request("PUT", "/versioned")
        status, _d, _h, _dt = admin.request(
            "PUT", "/versioned", "versioning=",
            b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>")
        check(status == 200, f"PutBucketVersioning: {status}")
        vids = []
        for i in range(3):
            body = _s3_body(seed, 50_000 + i, 10_000 + i)
            status, _d, hdrs, _dt = admin.request("PUT", "/versioned/doc.txt", body=body)
            check(status == 200 and hdrs.get("x-amz-version-id"), f"versioned PUT {i}: {status}")
            vids.append((hdrs["x-amz-version-id"], body))
        check(len({v for v, _b in vids}) == 3, f"three PUTs gave version ids {vids}")
        for vid, body in vids:
            status, data, hdrs, _dt = admin.request("GET", "/versioned/doc.txt",
                                                    f"versionId={vid}")
            check(status == 200 and data == body and hdrs.get("x-amz-version-id") == vid,
                  f"GET versionId={vid}: {status}")
        status, data, _h, _dt = admin.request("GET", "/versioned", "versions=")
        check(status == 200 and sorted(v.findtext(f"{ns}VersionId") for v in
                                       ET.fromstring(data).iter(f"{ns}Version"))
              == sorted(v for v, _b in vids), f"ListObjectVersions: {data[:300]!r}")
        # tagging
        tags = (b"<Tagging><TagSet><Tag><Key>team</Key><Value>storage</Value></Tag></TagSet>"
                b"</Tagging>")
        status, _d, _h, _dt = admin.request("PUT", f"/{S3_BUCKET}/{small_key}", "tagging=", tags)
        status2, data, _h, _dt = admin.request("GET", f"/{S3_BUCKET}/{small_key}", "tagging=")
        check(status == 200 and status2 == 200 and b"<Key>team</Key><Value>storage</Value>" in data,
              f"tagging: {status} {status2} {data[:300]!r}")
        # an anonymous read turned 200 by a bucket policy
        admin.request("PUT", "/public")
        page = _s3_body(seed, 51_000, 20_000)
        admin.request("PUT", "/public/page.html", body=page)
        status, _d, _h, _dt = admin.request("GET", "/public/page.html", mode="anon")
        check(status == 403, f"anonymous GET before the policy: {status}")
        policy = json.dumps({"Version": "2012-10-17", "Statement": [{
            "Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
            "Resource": "arn:aws:s3:::public/*"}]}).encode()
        status, _d, _h, _dt = admin.request("PUT", "/public", "policy=", policy)
        check(status == 204, f"PutBucketPolicy: {status}")
        status, data, _h, _dt = admin.request("GET", "/public/page.html", mode="anon")
        check(status == 200 and data == page, f"anonymous GET after the policy: {status}")
        # SSE-S3 and SSE-C of a 16 MiB object
        secret = _s3_body(seed, 52_000, S3_SSE_BYTES)
        ckey = hashlib.sha256(b"customer key").digest()
        sse_c = {"x-amz-server-side-encryption-customer-algorithm": "AES256",
                 "x-amz-server-side-encryption-customer-key": base64.b64encode(ckey).decode(),
                 "x-amz-server-side-encryption-customer-key-md5":
                     base64.b64encode(hashlib.md5(ckey).digest()).decode()}
        sse = {}
        for label, hdrs in (("sse_s3", {"x-amz-server-side-encryption": "AES256"}),
                            ("sse_c", sse_c)):
            t = time.perf_counter()
            status, data, _h, _dt = admin.request("PUT", f"/{S3_BUCKET}/sealed/{label}.bin",
                                                  body=secret, headers=hdrs)
            if not crypto:
                check(status == 501 and b"NotImplemented" in data,
                      f"{label} without cryptography answered {status} {data[:200]!r}")
                sse[label] = "501"
                continue
            check(status == 200, f"{label} PUT: {status} {data[:200]!r}")
            get_hdrs = sse_c if label == "sse_c" else {}
            status, data, rh, _dt = admin.request("GET", f"/{S3_BUCKET}/sealed/{label}.bin",
                                                  headers=get_hdrs)
            check(status == 200 and data == secret, f"{label} GET: {status}, {len(data)} B")
            sse[label] = time.perf_counter() - t
            if label == "sse_c":
                status, _d, _h, _dt = admin.request("GET", f"/{S3_BUCKET}/sealed/{label}.bin")
                check(status == 400, f"an SSE-C GET without the key answered {status}")
        rec["sse"] = sse
        # a quota freezes a bucket through s3.bucket.quota.check
        admin.request("PUT", "/quota")
        for i in range(3):
            admin.request("PUT", f"/quota/q{i}.bin", body=_s3_body(seed, 53_000 + i, MIB))
        walls["quota_check"], out = _shell(
            maddr, "lock; s3.bucket.quota -name quota -sizeMB 2; s3.bucket.quota.check; unlock",
            log, filer=filer.gaddr)
        check("quota: used" in out and "FREEZING" in out, f"s3.bucket.quota.check: {out!r}")
        def refused() -> bool:
            status, data, _h, _dt = admin.request("PUT", "/quota/q9.bin", body=b"x" * 1000)
            return status == 403 and b"QuotaExceeded" in data

        walls["quota_visible"] = _poll(refused, "the frozen bucket to refuse a PUT", 10)
        status, _d, _h, _dt = admin.request("GET", "/quota/q0.bin")
        check(status == 200, f"a GET of the frozen bucket: {status}")
        print(f"s3: features on {ident}: CopyObject of a {large[1]} B object, {S3_RANGE_READS} "
              f"Range GETs across the 128 MiB object's part boundaries, a presigned GET, 3 versions "
              f"read by versionId, tagging, an anonymous 403 turned 200 by a bucket policy, "
              f"SSE {sse} (s, PUT + GET of {S3_SSE_BYTES} B), quota freeze by "
              f"s3.bucket.quota.check visible in {walls['quota_visible']:.3f}s")

        # 4. coherence: an overwrite through the filer's HTTP API
        # a small object the mixed run left as the fill wrote it
        k_over = next(o for o in smalls if o[0] != small_key and o[0] in model
                      and model[o[0]][2] == filled_md5[o[0]])
        status, data, _h, _dt = admin.request("GET", f"/{S3_BUCKET}/{k_over[0]}")
        check(status == 200, f"GET {k_over[0]} before the overwrite: {status}")
        fresh = _s3_body(seed, 54_000, 30_000)
        t = time.perf_counter()
        status, reply = pool.request(filer.faddr, "POST", f"/buckets/{S3_BUCKET}/{k_over[0]}",
                                     body=fresh)
        check(status == 201, f"the filer POST of {k_over[0]}: {status} {reply[:200]!r}")
        t_written = time.perf_counter()

        def fresh_visible() -> bool:
            status, data, _h, _dt = admin.request("GET", f"/{S3_BUCKET}/{k_over[0]}")
            return status == 200 and data == fresh

        _poll(fresh_visible, "the filer-side overwrite through the gateway", 10)
        walls["coherence_visible"] = time.perf_counter() - t_written
        walls["coherence_post"] = t_written - t
        # put the object back through the gateway so that its ETag is S3's again
        status, _d, _h, _dt = admin.request("PUT", f"/{S3_BUCKET}/{k_over[0]}",
                                            body=_s3_body(seed, k_over[3], k_over[1]))
        check(status == 200, f"re-PUT of {k_over[0]}: {status}")

        def cachez() -> dict:
            status, body = pool.request(f"127.0.0.1:{gw_metrics}", "GET", "/debug/cachez")
            check(status == 200, f"/debug/cachez: {status}")
            caches = json.loads(body)["caches"]
            check(len(caches) == 1, f"/debug/cachez lists {len(caches)} caches")
            return caches[0]

        hot = [k for k in sorted(model) if k.startswith("small/")][:S3_HOT_SET]

        def get_hot(client, key):
            status, (sha, n), _h, dt = client.request("GET", f"/{S3_BUCKET}/{key}", sink=True)
            check(status == 200 and (n, sha) == model[key][:2], f"hot GET {key}: {status}")
            return dt

        _s3_pool(gw.addr, hot, get_hot)
        c0 = cachez()
        lat = _s3_pool(gw.addr, hot, get_hot)
        c1 = cachez()
        hits, misses = c1["hits"] - c0["hits"], c1["misses"] - c0["misses"]
        rec["cache"] = dict(hits=hits, misses=misses, hit_ratio=hits / max(1, hits + misses),
                            p50_ms=float(np.percentile(np.array(lat) * 1e3, 50)),
                            snapshot=c1)
        check(hits > 0, f"the second pass over the hot set hit the chunk cache {hits} times")
        print(f"s3: coherence on {ident}: a filer-side overwrite of {k_over[0]} visible through the "
              f"gateway {walls['coherence_visible'] * 1e3:.3f} ms after the filer's 201; the hot "
              f"set's second pass ({len(hot)} GETs) hit ratio {rec['cache']['hit_ratio']:.4f} "
              f"({hits} hits, {misses} misses; p50 {rec['cache']['p50_ms']:.3f} ms), "
              f"/debug/cachez: {c1['entries']} entries, {c1['ram_bytes']} RAM bytes, "
              f"{c1['segment_files']} segment files")

        # 4b. the native splice: the signed gateway's spliced GET views,
        # then an open-access gateway whose streaming PUTs fan out natively
        rec["splice"] = _s3_splice(maddr, filer.gaddr, f"127.0.0.1:{gw_metrics}", root, seed,
                                   ident)

        # 5. the split of one request (in process, its bucket deleted at the end)
        rec["split"] = _s3_profile(maddr, filer.gaddr, seed, ident)
        admin.close()

        # 6. ec.encode of every volume that holds the buckets
        vols: dict = {}
        for d in dirs:
            for n_ in os.listdir(d):
                mm = re.fullmatch(r"(\d+)\.dat", n_)
                if mm and os.path.getsize(os.path.join(d, n_)) > 8:
                    vols[int(mm[1])] = max(vols.get(int(mm[1]), 0),
                                           os.path.getsize(os.path.join(d, n_)))
        tasks = sum(len(ec_encoder._plan_tasks(DEFAULT_SCHEME, s, ec_encoder.DEFAULT_CHUNK))
                    for s in vols.values())
        k1_before = {s_.url: metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply")
                     for s_ in servers}
        check(not any(k1_before.values()), f"K1 launched before the encode: {k1_before}")
        walls["ec_encode"], _out = _shell(maddr, "lock; " + "; ".join(
            f"ec.encode -volumeId {vid}" for vid in sorted(vols)) + "; unlock", log)
        by_grpc = {f"127.0.0.1:{s_.grpc_port}": d for s_, d in zip(servers, dirs)}
        for vid in vols:
            _poll(lambda: _ec_census(mstub, vid)["holders"] == _disk_shards(by_grpc, str(vid)),
                  f"the master's EC census of {vid} to match the disks", 60)
        k1 = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply"))
              for s_ in servers}
        check(sum(k1.values()) == tasks and tasks > 0,
              f"K1 launches by server {k1}; the generates of {len(vols)} volumes have {tasks} batches")
        check(not any(re.fullmatch(r"\d+\.dat", n_) for d in dirs for n_ in os.listdir(d)
                      if int(n_.split(".")[0]) in vols), "an encoded volume's .dat survived")
        print(f"s3: ec.encode -volumeId of {len(vols)} volumes ({sum(vols.values())} B) "
              f"{walls['ec_encode']:.3f}s on {ident}; K1 launches by server {k1} (= {tasks} "
              f"batches)")
        model_etag = model
        check(gw.stop() == 0, "the gateway did not stop cleanly")
        gw = start_gateway()  # an empty chunk cache: every read comes from the shards
        rec["read_ec"] = _s3_read_all(gw.addr, S3_BUCKET, model_etag, "from EC shards")

        # a volume server SIGKILLed: degraded reads; ec.rebuild
        census = {vid: _ec_census(mstub, vid)["holders"] for vid in vols}

        def data_shards(s_) -> int:
            return sum(sid < 10 for h in census.values()
                       for sid in h.get(f"127.0.0.1:{s_.grpc_port}", []))

        victim = max(servers, key=data_shards)
        victim_addr = f"127.0.0.1:{victim.grpc_port}"
        def one_server() -> str:
            """Step 7, beside the prune wait of step 6: ``cli server -filer -s3``
            on its own master, one signed PUT and GET."""
            srv_dir = os.path.join(root, "server")
            os.makedirs(srv_dir)
            t = time.perf_counter()
            one = _Server("", "", os.path.join(root, "server.log"), wait=False, argv=[
                "server", "-filer", "-s3", "-device", dev.type, "-dir", srv_dir, "-masterPort", "0",
                "-port", "0", "-filerPort", "0", "-s3Port", "0", "-s3AccessKey", S3_AK,
                "-s3SecretKey", S3_SK])
            try:
                line = one.proc.stdout.readline().strip()
                walls["server_up"] = time.perf_counter() - t
                m = re.search(r"s3 (127\.0\.0\.1:\d+) \(sigv4\)", line)
                if m is None:
                    raise SmokeFailure(f"cli server -filer -s3 did not start: {line!r}: "
                                       f"{one.log_text()[-2000:]}")
                c1_ = _S3Client(m[1])
                body = _s3_body(seed, 55_000, 3 * MIB + 5)
                status0, _d, _h, _dt = c1_.request("PUT", "/one")
                deadline = time.perf_counter() + 60
                while True:
                    status, reply, _h, _dt = c1_.request("PUT", "/one/x.bin", body=body)
                    if status == 200 or time.perf_counter() > deadline:
                        break
                    time.sleep(0.2)  # until the volume server's first heartbeat
                status2, got, _h, _dt = c1_.request("GET", "/one/x.bin")
                c1_.close()
                rc_one = one.stop()
                check(status0 == 200 and status == 200 and status2 == 200 and got == body
                      and rc_one == 0,
                      f"cli server -filer -s3: CreateBucket {status0}, PUT {status} "
                      f"{reply[:200]!r}, GET {status2} ({'equal' if got == body else 'differs'}), "
                      f"rc {rc_one}")
            finally:
                one.stop()
            return (f"s3: cli server -filer -s3 -device {dev.type} up in "
                    f"{walls['server_up']:.3f}s ({line}); one signed PUT and GET equal; "
                    f"SIGTERM rc 0")

        live = [s_ for s_ in servers if s_ is not victim]
        victim.proc.send_signal(signal.SIGKILL)
        victim.proc.wait()
        side = _Beside(one_server)
        walls["prune_wait"] = _poll(lambda: victim.url not in nodes(),
                                    f"the master to prune {victim.url}", PRUNE_WAIT_S)
        print(f"s3: SIGKILL {victim.url} ({data_shards(victim)} data shards); pruned after "
              f"{walls['prune_wait']:.3f}s")
        server_line = side.result()
        check(gw.stop() == 0, "the gateway did not stop cleanly")
        gw = start_gateway()
        rec["read_degraded"] = _s3_read_all(gw.addr, S3_BUCKET, model_etag, "degraded")
        rec["reconstructed_intervals"] = int(sum(
            metric(s_.metrics(), "weedtpu_ec_degraded_reads_total", mode="reconstruct")
            for s_ in live))
        check(rec["reconstructed_intervals"] > 0 and data_shards(victim) > 0,
              f"the degraded reads reconstructed {rec['reconstructed_intervals']} intervals")
        k1_live = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches",
                                      kernel="gf_apply")) for s_ in live}
        walls["ec_rebuild"], _out = _shell(maddr, "lock; " + "; ".join(
            f"ec.rebuild -volumeId {vid}" for vid in sorted(vols)) + "; unlock", log)
        k1_rebuild = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches",
                                         kernel="gf_apply")) - k1_live[s_.url] for s_ in live}
        check(sum(k1_rebuild.values()) > 0, f"ec.rebuild launched no K1: {k1_rebuild}")
        live_grpc = {a: d for a, d in by_grpc.items() if a != victim_addr}
        for vid in vols:
            _poll(lambda: sorted(s for sids in _disk_shards(live_grpc, str(vid)).values()
                                 for s in sids) == list(range(14)),
                  f"14 shards of {vid} on the live servers", 60)
        check(gw.stop() == 0, "the gateway did not stop cleanly")
        gw = start_gateway()
        rng = np.random.default_rng([seed, 1409])
        keys = sorted(model_etag)
        picks = {k: model_etag[k] for k in [big_key[0]] + [
            keys[i] for i in rng.choice(len(keys), min(S3_REBUILD_SAMPLE - 1, len(keys)),
                                        replace=False)]}
        rec["read_rebuilt"] = _s3_read_all(gw.addr, S3_BUCKET, picks, "after ec.rebuild")
        print(f"s3: ec.rebuild of {len(vols)} volumes {walls['ec_rebuild']:.3f}s on {ident}; K1 "
              f"launches {k1_rebuild}; every volume has 14 shards on the live servers")

        # 7. cli server -filer -s3 -device <dev>, run beside step 6's prune wait
        print(server_line)
    finally:
        if side is not None:
            side.wait()
        pool.close()
        rcs = {getattr(s_, "url", s_.proc.pid): s_.stop() for s_ in servers}
        if gw is not None:
            rcs["s3"] = gw.stop()
        if filer is not None:
            rcs["filer"] = filer.stop()
        rcs["master"] = master.stop()
    check(all(rc == 0 for k, rc in rcs.items() if victim is None or k != victim.url)
          and victim is not None and rcs[victim.url] == -signal.SIGKILL,
          f"s3 phase processes exited {rcs}")
    walls["phase"] = time.perf_counter() - t_phase
    rec.update(walls=walls, launches=tasks + sum(k1_rebuild.values()), launches_encode=tasks,
               launches_rebuild=sum(k1_rebuild.values()), volumes=len(vols), objects=len(objs),
               bytes=sum(o[1] for o in objs), rcs={str(k): v for k, v in rcs.items()})
    print("s3: " + json.dumps(rec, sort_keys=True))
    return rec


# -- phase 15 -----------------------------------------------------------------

TLS_SMALL_N = 128  # 1-64 KiB objects over HTTPS at S3_CLIENTS clients (2,048 before phase 16, 1,024 before 17, 512 before 18, 256 before 19)
TLS_BIG_BYTES = 128 * MIB  # one object as multipart in S3_PART parts, S3_PART_CONCURRENCY at a time (cut from 1 GiB, 256 MiB before phase 18)
# one spec for every process: each fires the rules of its own side and
# service; shares the retry budgets and the EC read chain absorb.  The
# stub never replays a stream, but the EC locator asks a live holder
# again after a refused EcShardRead and keeps it located; a read it
# still cannot make is reconstructed, and a chunk the server cannot read
# is asked of the next server holding the volume
TLS_FAULTS = ("client/volume:EcShardRead:unavailable:0.02,"
              "client/filer:LookupDirectoryEntry:unavailable:0.02,"
              "server/filer:*:delay:2ms:0.05")
TLS_FAULTS_SEED = 15
TLS_SLO = {"ops": {"s3.put": {"p99_ms": 10_000, "min_count": 100},
                   "s3.get.small": {"p99_ms": 10_000, "min_count": 100}},
           "error_rate_max": 0.0}
TLS_TORN_N = 64  # acknowledged 4 KiB writes before the torn one


@contextlib.contextmanager
def _cluster_env(extra: dict):
    """This process as a client of a cluster whose processes run with
    ``extra`` in their environment (``WEEDTPU_TLS_*``: mutual TLS on every
    gRPC hop): rpc.py reads its TLS settings anew on the way in and out."""
    from seaweedfs_tpu_torch import rpc

    saved = {k: os.environ.get(k) for k in extra}
    os.environ.update(extra)
    rpc._tls_config = None
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        rpc._tls_config = None


def _tracez(pool, addr: str, trace_id: str) -> list:
    status, body = pool.request(addr, "GET", f"/debug/tracez?json=1&trace_id={trace_id}")
    check(status == 200, f"{addr}/debug/tracez: {status}")
    return json.loads(body)


def phase_tls(args, directory: str, ident: str, dev) -> dict:
    """Phase 15: the RPC and observability layers.  ``cli tls.gen`` mints a
    CA and a node certificate for 127.0.0.1; one ``cli master
    -volumeSizeLimitMB 256``, four ``cli volume -device cuda`` on two
    racks, ``cli filer -db <dir>`` and ``cli s3 -filer ... -tlsCert
    -tlsKey -kmsKeyFile`` (SigV4 required) run with ``WEEDTPU_TLS_*`` (every
    gRPC hop mutual TLS), a ``-metricsPort`` each, one ``WEED_FAULTS`` spec
    and seed (UNAVAILABLE on a share of the volume servers' EcShardRead
    and the gateway's LookupDirectoryEntry calls, a delay on a share of
    the filer's gRPC) and a ``WEED_SLO`` spec.  Over HTTPS: TLS_SMALL_N
    objects of 1-64 KiB at 16 clients and one 128 MiB object as multipart;
    a traced PUT is one trace across the gateway, the filer and the
    volume server; ``cluster.status`` merges the members' sketches (the
    s3.put count equals the members' sum and the PUTs sent);
    ``slo.status``.  ``ec.encode`` of every volume over mutual TLS
    launches K1 once per batch (the servers' /metrics), traced: each
    source's EcShardsGenerate span covers its generate; every object reads
    back from the shards, and again degraded after a SIGKILL, ETag- and
    sha256-equal with 0 client-visible errors while the faults fire.
    ``fault.inject`` makes a live peer's breaker open, half-open and close
    (``resilience.status``, ``events.dump``).  A server restarted with
    ``disk@*.dat:append:torn:x1`` fails a write; restarted without it,
    recovery truncates the torn tail and every acknowledged write reads
    back.  Figures on ``tls:`` lines."""
    import ssl
    import xml.etree.ElementTree as ET

    import grpc
    import numpy as np

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.util.http_pool import HttpConnectionPool

    seed = args.seed
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(directory, "tls")
    dirs = [os.path.join(root, f"v{i}") for i in range(4)]
    for d in dirs:
        os.makedirs(d)
    log = os.path.join(root, "shell.log")
    walls: dict = {}
    rec: dict = {}
    t_phase = time.perf_counter()

    # 1. certificates, through the CLI
    certs_dir = os.path.join(root, "certs")
    t = time.perf_counter()
    gen = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch.cli", "tls.gen", "-dir",
                          certs_dir, "-host", "127.0.0.1,localhost"], cwd=here, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                             filter(None, [here, os.environ.get("PYTHONPATH")]))))
    walls["tls_gen"] = time.perf_counter() - t
    certs = {k: os.path.join(certs_dir, f) for k, f in (("ca", "ca.crt"), ("cert", "node.crt"),
                                                        ("key", "node.key"))}
    check(gen.returncode == 0 and all(os.path.exists(p) for p in certs.values()),
          f"tls.gen exited {gen.returncode}: {gen.stdout} {gen.stderr[-2000:]}")
    print(f"tls: tls.gen in {walls['tls_gen']:.3f}s: " + " | ".join(gen.stdout.splitlines()))
    tls_env = {"WEEDTPU_TLS_CA": certs["ca"], "WEEDTPU_TLS_CERT": certs["cert"],
               "WEEDTPU_TLS_KEY": certs["key"]}
    env = dict(tls_env, WEED_FAULTS=TLS_FAULTS, WEED_FAULTS_SEED=str(TLS_FAULTS_SEED),
               WEED_SLO=json.dumps(TLS_SLO), SEAWEEDFS_TPU_TRACE="1")
    ca_ctx = ssl.create_default_context(cafile=certs["ca"])
    pool = HttpConnectionPool(timeout=60.0, max_per_host=64)
    servers: list = []
    filer = gw = victim = None
    tasks = 0
    mports = _free_ports(3)  # the master's, the filer's and the gateway's metrics listeners
    with _cluster_env(tls_env):
        master = _Server("", "", os.path.join(root, "master.log"), env=env, argv=[
            "master", "-port", "0", "-volumeSizeLimitMB", str(FILER_VOLUME_MB),
            "-metricsPort", str(mports[0])])
        try:
            maddr = f"127.0.0.1:{master.grpc_port}"
            master.metrics_port = mports[0]
            mstub = rpc.master_stub(maddr)
            t = time.perf_counter()

            def volume_argv(d: str, i: int, ports: tuple = ("0", "0", "0")) -> list:
                return ["volume", "-dir", d, "-ip", "127.0.0.1", "-port", ports[0], "-grpcPort",
                        ports[1], "-metricsPort", ports[2], "-device", dev.type, "-mserver",
                        maddr, "-rack", f"r{i % 2}", "-scrubInterval", "0", "-scrubRateMB", "0"]

            servers = [_Server(d, dev.type, os.path.join(root, f"v{i}.log"), wait=False, env=env,
                               argv=volume_argv(d, i)) for i, d in enumerate(dirs)]
            for s_ in servers:
                s_.ready()
                s_.url = f"127.0.0.1:{s_.http_port}"
            urls = [s_.url for s_ in servers]
            filer = _Server("", "", os.path.join(root, "filer.log"), env=env, argv=[
                "filer", "-master", maddr, "-port", "0", "-db", os.path.join(root, "db"),
                "-metricsPort", str(mports[1])])
            filer.gaddr = f"127.0.0.1:{filer.grpc_port}"
            filer.metrics_port = mports[1]
            gw = _Server("", "", os.path.join(root, "s3.log"), wait=False, env=env, argv=[
                "s3", "-master", maddr, "-filer", filer.gaddr, "-port", "0", "-accessKey", S3_AK,
                "-secretKey", S3_SK, "-metricsPort", str(mports[2]), "-kmsKeyFile",
                os.path.join(root, "kms.json"), "-tlsCert", certs["cert"], "-tlsKey",
                certs["key"]])
            line = gw.proc.stdout.readline().strip()
            m = re.search(r"s3 gateway on (127\.0\.0\.1:\d+) \(auth=sigv4\)", line)
            if m is None:
                raise SmokeFailure(f"cli s3 -tlsCert did not start: {line!r}: "
                                   f"{gw.log_text()[-2000:]}")
            gw.addr, gw.metrics_port = m[1], mports[2]
            _TLS_CONTEXTS[gw.addr] = ca_ctx
            walls["servers_up"] = time.perf_counter() - t
            members = [f"127.0.0.1:{p.metrics_port}" for p in [master, *servers, filer, gw]]

            def nodes() -> set:
                topo = mstub.VolumeList(m_pb.VolumeListRequest(), timeout=60).topology_info
                return {dn.id for dc in topo.data_center_infos for r in dc.rack_infos
                        for dn in r.data_node_infos}

            # the smoke's own VolumeList rides mutual TLS with the node certificate
            walls["registered"] = _poll(lambda: nodes() == set(urls), "all four nodes", 60)
            # no fallback: plaintext gRPC, plain HTTP and an untrusted CA all fail
            plain = grpc.insecure_channel(maddr)
            try:
                plain.unary_unary("/weedtpu.master.Master/VolumeList",
                                  request_serializer=m_pb.VolumeListRequest.SerializeToString,
                                  response_deserializer=m_pb.VolumeListResponse.FromString)(
                    m_pb.VolumeListRequest(), timeout=10)
                raise SmokeFailure("a plaintext gRPC call to the mutual-TLS master answered")
            except grpc.RpcError as e:
                check(e.code() == grpc.StatusCode.UNAVAILABLE,
                      f"a plaintext gRPC call failed with {e.code()}")
            finally:
                plain.close()
            for bad_ctx in (None, ssl.create_default_context()):
                host, port = gw.addr.split(":")
                conn = (http.client.HTTPConnection(host, int(port), timeout=10) if bad_ctx is None
                        else http.client.HTTPSConnection(host, int(port), timeout=10,
                                                         context=bad_ctx))
                try:
                    conn.request("GET", "/")
                    conn.getresponse().read()
                    raise SmokeFailure(f"the HTTPS gateway answered a {'plain' if bad_ctx is None else 'untrusting'} client")
                except (OSError, http.client.HTTPException):
                    pass
                finally:
                    conn.close()
            print(f"tls: master {maddr}, four volume servers at {urls} on {ident}, filer "
                  f"{filer.gaddr}, HTTPS gateway {gw.addr}, all gRPC mutual TLS, faults "
                  f"{TLS_FAULTS!r} seed {TLS_FAULTS_SEED}; up in {walls['servers_up']:.3f}s; "
                  f"plaintext gRPC, plain HTTP and an untrusting client refused")

            # 2. the fill over HTTPS
            admin = _S3Client(gw.addr)
            status, data, _h, _dt = admin.request("PUT", f"/{S3_BUCKET}")
            check(status == 200, f"CreateBucket over HTTPS: {status} {data[:200]!r}")
            rng = np.random.default_rng([seed, 15])
            smalls = [(f"small/{i % 64:02d}/o{i:05d}.bin", int(sz), "small", 300 + i)
                      for i, sz in enumerate(rng.integers(1024, 64 * 1024 + 1, TLS_SMALL_N))]
            big = ("big/one.bin", TLS_BIG_BYTES, "big", 299)

            def put_small(client, o):
                key, size, _kind, bkey = o
                body = _s3_body(seed, bkey, size)
                md5 = hashlib.md5(body).hexdigest()
                status, data, hdrs, dt = client.request("PUT", f"/{S3_BUCKET}/{key}", body=body)
                check(status == 200 and hdrs.get("etag") == f'"{md5}"',
                      f"PUT {key}: {status} {data[:200]!r}")
                return hashlib.sha256(body).hexdigest(), md5, dt

            t = time.perf_counter()
            got = _s3_pool(gw.addr, smalls, put_small)
            fill = {"small": _class_figures("small", [o[1] for o in smalls], [g[2] for g in got],
                                            time.perf_counter() - t)}
            model = {o[0]: (o[1], g[0], g[1]) for o, g in zip(smalls, got)}
            t = time.perf_counter()
            (big_got,) = _s3_multipart(gw.addr, seed, [big], lambda k: f"/{S3_BUCKET}/{k}")
            fill["big"] = _class_figures("big", [big[1]], [big_got[2]], time.perf_counter() - t)
            model[big[0]] = (big[1], big_got[0], big_got[1])
            n_parts = -(-TLS_BIG_BYTES // S3_PART)
            puts_sent = len(smalls) + n_parts + 2  # create, parts, complete: class s3.put
            # one traced PUT, with the client's own span context
            trace_id = hashlib.sha256(f"phase 15 put {seed}".encode()).hexdigest()[:32]
            client_span = "c1" * 8
            traced_body = _s3_body(seed, 298, 64 * 1024)
            status, _d, _h, _dt = admin.request(
                "PUT", f"/{S3_BUCKET}/traced/one.bin", body=traced_body,
                headers={"traceparent": f"00-{trace_id}-{client_span}-01"})
            check(status == 200, f"the traced PUT: {status}")
            puts_sent += 1
            model["traced/one.bin"] = (len(traced_body), hashlib.sha256(traced_body).hexdigest(),
                                       hashlib.md5(traced_body).hexdigest())
            rec["fill"] = fill
            print(f"tls: fill over HTTPS on {ident}: " + "; ".join(
                f"{cls} {r['files']} objects {r['files_per_s']:.1f}/s {r['mb_per_s']:.1f} MB/s "
                f"p50 {r['p50_ms']:.2f} ms p99 {r['p99_ms']:.2f} ms" for cls, r in fill.items()))

            # the traced PUT: the gateway's request span, the filer's gRPC span
            # as its child and the volume POST under the gateway's upload span
            def trace_rows() -> dict:
                return {name: _tracez(pool, f"127.0.0.1:{p.metrics_port}", trace_id)
                        for name, p in (("s3", gw), ("filer", filer),
                                        *((s_.url, s_) for s_ in servers))}

            # the volume's span of the chunk POST: the native plane's
            # ("native_dp", "post", replayed from its span records), or the
            # Python handler's ("volume", "write") when the POST forwarded
            def volume_span(r: dict) -> bool:
                return (r["service"], r["name"]) in (("native_dp", "post"), ("volume", "write"))

            _poll(lambda: any(volume_span(r) for url in urls for r in trace_rows()[url]),
                  "the traced PUT's volume span", 10)
            rows = trace_rows()
            put_span = [r for r in rows["s3"] if r["name"] == "PutObject"]
            check(len(put_span) == 1 and put_span[0]["parent_id"] == client_span,
                  f"the gateway's spans of the traced PUT: {rows['s3']}")
            put_id = put_span[0]["span_id"]
            chunk = [r for r in rows["s3"] if r["name"] == "put_chunk"]
            check(len(chunk) == 1 and chunk[0]["parent_id"] == put_id,
                  f"the gateway's upload span: {rows['s3']}")
            created = [r for r in rows["filer"] if r["name"] == "CreateEntry"]
            check(len(created) == 1 and created[0]["parent_id"] == put_id
                  and created[0]["service"] == "filer", f"the filer's spans: {rows['filer']}")
            writes = {url: [r for r in rows[url] if volume_span(r)] for url in urls}
            holder = chunk[0]["attrs"]["url"]
            check(len(writes.get(holder, [])) == 1
                  and writes[holder][0]["parent_id"] == chunk[0]["span_id"]
                  and sum(len(w) for w in writes.values()) == 1,
                  f"the volume servers' write spans: {writes}")
            walls["trace_dump"], out = _shell(maddr, "; ".join(
                f"trace.dump -server 127.0.0.1:{p.metrics_port} -traceId {trace_id}"
                for p in (gw, filer, servers[urls.index(holder)])), log, env=env)
            check(out.count(f"trace {trace_id}") == 3 and "s3:PutObject" in out
                  and "filer:CreateEntry" in out
                  and f"{writes[holder][0]['service']}:{writes[holder][0]['name']}" in out,
                  f"trace.dump of the traced PUT: {out!r}")

            # cluster.status: the merged s3.put count against the members' own
            walls["cluster_status"], out = _shell(
                maddr, f"cluster.status -members {','.join(members)} -json", log, env=env)
            view = json.loads(out)
            own = []
            for addr in members:
                status, body = pool.request(addr, "GET", "/debug/sketchz")
                check(status == 200, f"{addr}/debug/sketchz: {status}")
                own.append(json.loads(body)["ops"].get("s3.put", {}).get("count", 0))
            merged_puts = view["op_latency"].get("s3.put", {}).get("count", 0)
            check(all(v["ok"] for v in view["members"].values())
                  and merged_puts == sum(own) == puts_sent,
                  f"cluster.status merged s3.put {merged_puts}, the members' own {own}, "
                  f"{puts_sent} PUTs sent; members {view['members']}")
            walls["slo_status"], slo_out = _shell(
                maddr, f"slo.status -server 127.0.0.1:{gw.metrics_port}", log, env=env)
            check(slo_out.startswith("SLO: PASS"), f"slo.status: {slo_out!r}")
            rec["cluster_status"] = dict(s3_put=merged_puts, members=own,
                                         op_latency=view["op_latency"],
                                         requests=view["requests_total"],
                                         errors=view["requests_errors"])
            print(f"tls: cluster.status over {len(members)} members: merged s3.put {merged_puts} "
                  f"= the members' {own} = {puts_sent} PUTs sent; " + "; ".join(
                      f"{op} n={r['count']} p99 {r['p99_ms']:.2f} ms"
                      for op, r in view["op_latency"].items() if r.get("count"))
                  + f"; slo.status: {slo_out.splitlines()[0]}")

            # 3. ec.encode over mutual TLS, traced
            vols: dict = {}
            for d in dirs:
                for n_ in os.listdir(d):
                    mm = re.fullmatch(r"(\d+)\.dat", n_)
                    if mm and os.path.getsize(os.path.join(d, n_)) > 8:
                        vols[int(mm[1])] = max(vols.get(int(mm[1]), 0),
                                               os.path.getsize(os.path.join(d, n_)))
            tasks = sum(len(ec_encoder._plan_tasks(DEFAULT_SCHEME, s_, ec_encoder.DEFAULT_CHUNK))
                        for s_ in vols.values())
            k1_before = {s_.url: metric(s_.metrics(), "weedtpu_cuda_kernel_launches",
                                        kernel="gf_apply") for s_ in servers}
            check(not any(k1_before.values()), f"K1 launched before the encode: {k1_before}")
            ec_trace = hashlib.sha256(f"phase 15 ec.encode {seed}".encode()).hexdigest()[:32]
            walls["ec_encode"], _out = _shell(maddr, "lock; " + "; ".join(
                f"ec.encode -volumeId {vid}" for vid in sorted(vols)) + "; unlock", log,
                env=dict(env, TRACEPARENT=f"00-{ec_trace}-{'e1' * 8}-01"))
            by_grpc = {f"127.0.0.1:{s_.grpc_port}": d for s_, d in zip(servers, dirs)}
            for vid in vols:
                _poll(lambda: _ec_census(mstub, vid)["holders"] == _disk_shards(by_grpc, str(vid)),
                      f"the master's EC census of {vid} to match the disks", 60)
            k1 = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches",
                                     kernel="gf_apply")) for s_ in servers}
            check(sum(k1.values()) == tasks and tasks > 0,
                  f"K1 launches by server {k1}; the generates of {len(vols)} volumes have "
                  f"{tasks} batches")
            spans = {}
            for s_ in servers:
                gens = [r for r in _tracez(pool, f"127.0.0.1:{s_.metrics_port}", ec_trace)
                        if r["name"] == "EcShardsGenerate"]
                walls_s = [st["wall_s"] for st in server_stages(s_.log_text(), "generate")]
                spans[s_.url] = dict(spans=len(gens), span_s=sum(r["duration_ms"] for r in gens)
                                     / 1e3, generate_s=sum(walls_s))
                check(bool(gens) == (k1[s_.url] > 0) and len(gens) == len(walls_s)
                      and all(r["service"] == "volume" and r["status"] == "ok" for r in gens)
                      and spans[s_.url]["span_s"] >= spans[s_.url]["generate_s"],
                      f"{s_.url}: EcShardsGenerate spans {gens}, generates {walls_s}, K1 "
                      f"{k1[s_.url]}")
            rec["ec_spans"] = spans
            sources = [s_ for s_ in servers if spans[s_.url]["spans"]]
            walls["trace_dump_ec"], out = _shell(maddr, "; ".join(
                f"trace.dump -server 127.0.0.1:{s_.metrics_port} -traceId {ec_trace}"
                for s_ in sources), log, env=env)
            check(bool(sources) and out.count(f"trace {ec_trace}") == len(sources)
                  and out.count("volume:EcShardsGenerate")
                  == sum(spans[s_.url]["spans"] for s_ in sources),
                  f"trace.dump of the traced ec.encode: {out!r}")
            print(f"tls: ec.encode -volumeId of {len(vols)} volumes ({sum(vols.values())} B) over "
                  f"mutual TLS {walls['ec_encode']:.3f}s on {ident}; K1 launches by server {k1} "
                  f"(= {tasks} batches); traced: EcShardsGenerate spans cover the generates "
                  f"{spans}")
            rec["read_ec"] = _s3_read_all(gw.addr, S3_BUCKET, model, "tls: from EC shards")

            # the holder of shard 0 SIGKILLed: degraded reads under the faults
            census = {vid: _ec_census(mstub, vid)["holders"] for vid in vols}

            def data_shards(s_) -> int:
                return sum(sid < 10 for h in census.values()
                           for sid in h.get(f"127.0.0.1:{s_.grpc_port}", []))

            victim = next(s_ for s_ in servers
                          if 0 in census[min(vols)].get(f"127.0.0.1:{s_.grpc_port}", []))
            live = [s_ for s_ in servers if s_ is not victim]
            victim.proc.send_signal(signal.SIGKILL)
            victim.proc.wait()
            walls["prune_wait"] = _poll(lambda: victim.url not in nodes(),
                                        f"the master to prune {victim.url}", PRUNE_WAIT_S)
            rec["read_degraded"] = _s3_read_all(gw.addr, S3_BUCKET, model, "tls: degraded")
            rec["reconstructed_intervals"] = int(sum(
                metric(s_.metrics(), "weedtpu_ec_degraded_reads_total", mode="reconstruct")
                for s_ in live))
            check(rec["reconstructed_intervals"] > 0 and data_shards(victim) > 0,
                  f"the degraded reads reconstructed {rec['reconstructed_intervals']} intervals")
            fired = {}
            for name, p in (("s3", gw), ("filer", filer), *((s_.url, s_) for s_ in live)):
                status, body = pool.request(f"127.0.0.1:{p.metrics_port}", "GET", "/debug/faults")
                check(status == 200, f"/debug/faults of {name}: {status}")
                snap = json.loads(body)
                check(snap["active"] and snap["seed"] == TLS_FAULTS_SEED, f"{name}: {snap}")
                for r in snap["rules"]:
                    fired[r["rule"]] = fired.get(r["rule"], 0) + r["fired"]
            check(all(fired.values()) and len(fired) == 3,
                  f"every rule of the plan fired somewhere: {fired}")
            rec["faults_fired"] = fired
            print(f"tls: SIGKILL {victim.url} ({data_shards(victim)} data shards), pruned after "
                  f"{walls['prune_wait']:.3f}s; {rec['reconstructed_intervals']} intervals "
                  f"reconstructed; faults fired {fired} with 0 client-visible errors")

            # 4. the operator's commands: a live peer's breaker under fault.inject
            peer = f"127.0.0.1:{live[0].grpc_port}"
            walls["breaker"], out = _shell(maddr, "; ".join([
                # quoted: the shell reads an unquoted "#" as a comment
                f"fault.inject -spec 'client/volume@{peer.replace(':', '#')}:VolumeStatus:"
                f"unavailable:x6'", "cluster.check", "cluster.check", "resilience.status",
                "cluster.check", "resilience.status", "events.dump -limit 0"]), log,
                env=dict(env, WEED_RPC_BREAKER_COOLDOWN="0", WEED_RPC_BACKOFF_MS="1"))
            states = re.findall(rf"^\s+{re.escape(peer)}\s+(\w+)\s+failures=(\d+)", out, re.M)
            kinds = re.findall(rf"(breaker\.\w+)\s.*peer={re.escape(peer)}\b", out)
            check(states == [("open", "6"), ("closed", "0")]
                  and kinds == ["breaker.open", "breaker.half_open", "breaker.open",
                                "breaker.half_open", "breaker.close"]
                  and out.count(f"UNREACHABLE: {live[0].url}") == 2,
                  f"the breaker walk: states {states}, events {kinds}: {out!r}")
            walls["events_dump"], out = _shell(
                maddr, f"events.dump -members {','.join(f'127.0.0.1:{p.metrics_port}' for p in [master, *live, filer, gw])} -limit 20",
                log, env=env)
            check("fault.injected" in out, f"events.dump -members: {out[-2000:]!r}")
            print(f"tls: fault.inject on {peer}: resilience.status {states}, events {kinds}; "
                  f"events.dump -members merged {len(out.splitlines())} lines")

            # 5. a torn append on one server, recovered by a restart
            s_ = live[-1]
            vid = max(vols) + 100
            rpc.volume_stub(f"127.0.0.1:{s_.grpc_port}").AllocateVolume(
                vs_pb.AllocateVolumeRequest(volume_id=vid, collection="torn"), timeout=60)
            payloads = {k: _s3_body(seed, 70_000 + k, 4096) for k in range(1, TLS_TORN_N + 3)}

            def write(k: int) -> int:
                status, _b = pool.request(s_.url, "POST", f"/{vid},{k:x}{k * 7919:08x}",
                                          body=payloads[k])
                return status

            check(all(write(k) == 201 for k in range(1, TLS_TORN_N + 1)),
                  "an acknowledged write before the torn one failed")
            dat = next(os.path.join(d, n_) for d in dirs for n_ in os.listdir(d)
                       if n_ == f"torn_{vid}.dat")
            intact = os.path.getsize(dat)
            ports = (str(s_.http_port), str(s_.grpc_port), str(s_.metrics_port))
            i_s = servers.index(s_)

            def restart(extra: dict, label: str):
                rc = s_.stop()
                check(rc == 0, f"{s_.url} did not stop cleanly: rc {rc}: {s_.log_text()[-3000:]}")
                new = _Server(dirs[i_s], dev.type, os.path.join(root, f"v{i_s}.{label}.log"),
                              env=dict(env, **extra), argv=volume_argv(dirs[i_s], i_s, ports))
                new.url = s_.url
                return new

            t = time.perf_counter()
            s_ = servers[i_s] = live[-1] = restart({"WEED_FAULTS": "disk@*.dat:append:torn:x1"},
                                                   "torn")
            torn_status = write(TLS_TORN_N + 1)
            torn_size = os.path.getsize(dat)
            status, body = pool.request(f"127.0.0.1:{s_.metrics_port}", "GET", "/debug/faults")
            torn_fired = json.loads(body)["rules"][0]["fired"]
            check(torn_status == 500 and intact < torn_size and torn_fired == 1,
                  f"the torn write answered {torn_status}, .dat {intact} -> {torn_size} B, "
                  f"fired {torn_fired}")
            s_ = servers[i_s] = live[-1] = restart({"WEED_FAULTS": ""}, "recovered")
            walls["torn_restarts"] = time.perf_counter() - t
            recovered = os.path.getsize(dat)
            reads = [pool.request(s_.url, "GET", f"/{vid},{k:x}{k * 7919:08x}")
                     for k in range(1, TLS_TORN_N + 2)]
            check(recovered == intact
                  and all(r == (200, payloads[k]) for k, r in zip(range(1, TLS_TORN_N + 1), reads))
                  and reads[-1][0] == 404 and write(TLS_TORN_N + 2) == 201,
                  f"after recovery .dat {recovered} B (intact {intact}); "
                  f"{sum(r[0] == 200 for r in reads[:-1])} of {TLS_TORN_N} acknowledged writes "
                  f"read back; the torn one answers {reads[-1][0]}")
            rec["torn"] = dict(intact=intact, torn=torn_size, recovered=recovered,
                               acknowledged=TLS_TORN_N)
            print(f"tls: disk@*.dat:append:torn:x1 on {s_.url}: the write answered 500, .dat "
                  f"{intact} -> {torn_size} B; restarted without faults: .dat {recovered} B, "
                  f"{TLS_TORN_N} acknowledged writes read back, the torn one 404, "
                  f"restarts {walls['torn_restarts']:.3f}s")
            admin.close()
        finally:
            pool.close()
            if gw is not None:
                _TLS_CONTEXTS.pop(getattr(gw, "addr", ""), None)
            rcs = {getattr(s_, "url", s_.proc.pid): s_.stop() for s_ in servers}
            if gw is not None:
                rcs["s3"] = gw.stop()
            if filer is not None:
                rcs["filer"] = filer.stop()
            rcs["master"] = master.stop()
    check(victim is not None and rcs[victim.url] == -signal.SIGKILL
          and all(rc == 0 for k, rc in rcs.items() if k != victim.url),
          f"tls phase processes exited {rcs}")
    walls["phase"] = time.perf_counter() - t_phase
    rec.update(walls=walls, launches=tasks, volumes=len(vols), objects=len(model),
               puts_sent=puts_sent, rcs={str(k): v for k, v in rcs.items()})
    print("tls: " + json.dumps(rec, sort_keys=True))
    return rec


# -- phase 16 -----------------------------------------------------------------

SHARD_FILERS = 3
SHARD_WORKERS = 4  # cli s3 -workers
SHARD_BUCKETS = 64
SHARD_SMALL_N = 128  # 1-64 KiB objects over SHARD_BUCKETS buckets (1,024 before phase 17, 512 before 18, 256 before 19)
SHARD_LARGE_N = 4  # 8-64 MiB objects as multipart, S3_PART parts, S3_PART_CONCURRENCY at a time (8 before phase 17)
SHARD_OVERWRITES = 32
SHARD_STREAK = 4 * SHARD_WORKERS  # fresh-connection answers in a row that must carry the new ETag
SHARD_STALE_S = 0.25  # the most an overwrite may stay stale on a worker: a bus datagram, not the TTL
SHARD_SELECT_ROWS = 2000
SHARD_WAIT_S = 120.0  # every wait for a subprocess's line


class _Lines:
    """A subprocess's stdout read by a thread into a queue, so that every
    wait for a line has a deadline."""

    def __init__(self, proc):
        import queue

        self.q = queue.Queue()
        self.seen: list = []

        def pump() -> None:
            for line in proc.stdout:
                self.q.put(line.rstrip("\n"))
            self.q.put(None)

        threading.Thread(target=pump, daemon=True).start()

    def wait_for(self, pattern: str, count: int = 1, timeout: float = SHARD_WAIT_S) -> list:
        """The first ``count`` matches of ``pattern`` (re.findall) in the lines."""
        import queue

        got = []
        deadline = time.perf_counter() + timeout
        while len(got) < count:
            left = deadline - time.perf_counter()
            check(left > 0, f"{len(got)} of {count} lines matching {pattern!r} within "
                  f"{timeout}s; stdout so far: {self.seen[-8:]}")
            try:
                line = self.q.get(timeout=left)
            except queue.Empty:
                continue
            check(line is not None, f"the process exited; stdout: {self.seen[-8:]}")
            self.seen.append(line)
            got += re.findall(pattern, line)
        return got[:count]


def _free_run(n: int) -> int:
    """A base port with ``n`` free ports from it (``-metricsPort`` + i of a
    worker group)."""
    import socket

    for _ in range(100):
        base = _free_ports(1)[0]
        if base + n >= 65535:
            continue
        socks = []
        try:
            for i in range(n):
                s_ = socket.socket()
                socks.append(s_)
                s_.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for s_ in socks:
                s_.close()
    raise SmokeFailure("no run of free ports")


def _fresh(addr: str, method: str, path: str, query: str = "", body: bytes = b"",
           headers: dict | None = None, key: tuple = (S3_AK, S3_SK), sign: bool = True) -> tuple:
    """One request on a new connection (the kernel picks a worker of an
    SO_REUSEPORT group), SigV4-signed with ``key``: (status, body, headers)."""
    from seaweedfs_tpu_torch.s3 import client_sign

    hdrs = dict(headers or {})
    quoted = urllib.parse.quote(path)
    if sign:
        hdrs.update(client_sign.sign_headers(method, quoted, query, addr, body, key[0], key[1],
                                             extra_headers=headers))
    conn = _filer_conn(addr)
    try:
        conn.request(method, quoted + (f"?{query}" if query else ""), body=body or None,
                     headers=hdrs)
        resp = conn.getresponse()
        return resp.status, resp.read(), {k.lower(): v for k, v in resp.getheaders()}
    finally:
        conn.close()


def _post_form(fields: dict, filename: str, data: bytes) -> tuple[str, bytes]:
    boundary = "----smoke16form"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
                 f'filename="{filename}"\r\nContent-Type: application/octet-stream\r\n\r\n'
                 .encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return f"multipart/form-data; boundary={boundary}", b"".join(parts)


def _signed_form(bucket: str, key: str, conditions: list) -> dict:
    """The fields of a browser form whose policy ``conditions`` are signed
    with the gateway's key (AWS4-HMAC-SHA256 over the base64 policy)."""
    from seaweedfs_tpu_torch.s3.auth import signing_key

    date = time.strftime("%Y%m%d", time.gmtime())
    policy = base64.b64encode(json.dumps({
        "expiration": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() + 600)),
        "conditions": conditions}).encode()).decode()
    import hmac

    return {"key": key, "x-amz-algorithm": "AWS4-HMAC-SHA256",
            "x-amz-credential": f"{S3_AK}/{date}/us-east-1/s3/aws4_request",
            "x-amz-date": f"{date}T000000Z", "policy": policy,
            "x-amz-signature": hmac.new(signing_key(S3_SK, date, "us-east-1", "s3"),
                                        policy.encode(), hashlib.sha256).hexdigest()}


def phase_shard(args, directory: str, ident: str, dev) -> dict:
    """Phase 16: the sharded filer and the worker-group gateway.  One ``cli
    master -volumeSizeLimitMB 256``, four ``cli volume -device cuda`` on
    two racks, three ``cli filer -db <own dir>`` on fixed ports (the shard
    ring's members) and ``cli s3 -filer f1,f2,f3 -workers 4 -port <fixed>
    -cacheMB 64 -metricsPort <base>`` (SigV4).  Steps, one line each:
    routing (128 small objects over 64 buckets and 4 multipart ones;
    objects and entries per shard from ``filer.shard.status``, every
    bucket on the shard ``ShardRing`` names); the worker group's PUT and
    GET rates and every worker's request count; coherence (32 overwrites,
    each read on fresh connections until 16 answers in a row carry the new
    ETag); IAM (``s3.configure -apply`` over the shard list, ``cli iam``
    over ``filer_etc``, an in-process gateway whose credential store is
    the sharded filer); a browser form POST and SelectObjectContent; one
    filer shard SIGKILLed (its buckets 503 with Retry-After, the others
    200) and restarted; ``ec.encode`` of every volume through K1 and every
    object read back from the shards through a restarted worker group.
    Figures on ``shard:`` lines."""
    import numpy as np

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.filer.shard_ring import ShardedFilerClient, ShardRing
    from seaweedfs_tpu_torch.iam.credentials import FilerEtcCredentialStore
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
    from seaweedfs_tpu_torch.s3 import S3ApiServer
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.wdclient import MasterClient

    seed = args.seed
    root = os.path.join(directory, "shard")
    dirs = [os.path.join(root, f"v{i}") for i in range(4)]
    for d in dirs:
        os.makedirs(d)
    log = os.path.join(root, "shell.log")
    walls: dict = {}
    rec: dict = {}
    servers: list = []
    filers: list = []
    gw = iam = inproc = router = None
    rcs: dict = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng([seed, 16])
    master = _Server("", "", os.path.join(root, "master.log"),
                     argv=["master", "-port", "0", "-volumeSizeLimitMB", str(FILER_VOLUME_MB)])
    try:
        maddr = f"127.0.0.1:{master.grpc_port}"
        mstub = rpc.master_stub(maddr)
        t = time.perf_counter()
        servers = [_Server(d, dev.type, os.path.join(root, f"v{i}.log"), wait=False, argv=[
            "volume", "-dir", d, "-ip", "127.0.0.1", "-port", "0", "-grpcPort", "0",
            "-metricsPort", "0", "-device", dev.type, "-mserver", maddr, "-rack", f"r{i % 2}",
            "-scrubInterval", "0", "-scrubRateMB", "0"]) for i, d in enumerate(dirs)]
        ports = _free_ports(2 * SHARD_FILERS)
        filer_argv = [["filer", "-master", maddr, "-port", str(ports[2 * i]), "-grpcPort",
                       str(ports[2 * i + 1]), "-db", os.path.join(root, f"db{i}")]
                      for i in range(SHARD_FILERS)]
        filers = [_Server("", "", os.path.join(root, f"filer{i}.log"), wait=False, argv=a)
                  for i, a in enumerate(filer_argv)]
        for s_ in servers + filers:
            s_.ready()
        for s_ in servers:
            s_.url = f"127.0.0.1:{s_.http_port}"
        urls = [s_.url for s_ in servers]
        shard_addrs = [f"127.0.0.1:{p}" for p in ports[1::2]]
        filer_list = ",".join(shard_addrs)
        ring = ShardRing(shard_addrs)
        gw_port = _free_ports(1)[0]
        gw_metrics = _free_run(SHARD_WORKERS)
        n_gw = [0]

        def start_group():
            n_gw[0] += 1
            g = _Server("", "", os.path.join(root, f"s3.{n_gw[0]}.log"), wait=False, argv=[
                "s3", "-master", maddr, "-filer", filer_list, "-workers", str(SHARD_WORKERS),
                "-port", str(gw_port), "-accessKey", S3_AK, "-secretKey", S3_SK,
                "-cacheMB", str(S3_CACHE_MB), "-metricsPort", str(gw_metrics)])
            g.lines = _Lines(g.proc)
            try:
                banners = g.lines.wait_for(r"s3 gateway on 127\.0\.0\.1:\d+ \(auth=sigv4\) "
                                           r"\[worker \d+/\d+\]", SHARD_WORKERS)
            except SmokeFailure:
                g.stop()
                raise
            g.addr = f"127.0.0.1:{gw_port}"
            return g, banners

        gw, banners = start_group()
        walls["servers_up"] = time.perf_counter() - t

        def nodes() -> set:
            topo = mstub.VolumeList(m_pb.VolumeListRequest(), timeout=60).topology_info
            return {dn.id for dc in topo.data_center_infos for r in dc.rack_infos
                    for dn in r.data_node_infos}

        walls["registered"] = _poll(lambda: nodes() == set(urls), "all four nodes", 60)

        def worker_metric(prefix: str) -> list:
            """Each worker's sum of the series starting with ``prefix`` (its
            own -metricsPort)."""
            out = []
            for i in range(SHARD_WORKERS):
                status, body, _h = _fresh(f"127.0.0.1:{gw_metrics + i}", "GET", "/metrics",
                                          sign=False)
                check(status == 200, f"worker {i}'s /metrics: {status}")
                out.append(int(sum(float(line.rsplit(" ", 1)[1]) for line in
                                   body.decode().splitlines() if line.startswith(prefix))))
            return out

        def served() -> list:
            """Requests each worker counted."""
            return worker_metric("weedtpu_s3_request_total{")

        def bus() -> list:
            """[(datagrams sent, datagrams received)] on each worker's bus."""
            name = "weedtpu_s3_inval_bus_datagrams_total"
            return list(zip(worker_metric(f'{name}{{direction="sent"}}'),
                            worker_metric(f'{name}{{direction="received"}}')))

        print(f"shard: master {maddr}, four volume servers on {ident}, {SHARD_FILERS} filer "
              f"shards {shard_addrs}, cli s3 -workers {SHARD_WORKERS} on {gw.addr} "
              f"(metrics {gw_metrics}..{gw_metrics + SHARD_WORKERS - 1}), up in "
              f"{walls['servers_up']:.3f}s: {banners}")

        # 1. routing: 64 buckets, SHARD_SMALL_N small objects, SHARD_LARGE_N multipart ones
        buckets = [f"sb{i:02d}" for i in range(SHARD_BUCKETS)]
        sizes = rng.integers(1024, 64 * 1024 + 1, SHARD_SMALL_N)
        smalls = [(f"{buckets[i % SHARD_BUCKETS]}/small/o{i:05d}.bin", int(s), "small", 300 + i)
                  for i, s in enumerate(sizes)]
        larges = [(f"{buckets[(7 * i) % SHARD_BUCKETS]}/large/l{i:02d}.bin",
                   int(rng.integers(8 * MIB, 64 * MIB + 1)), "large", 200 + i)
                  for i in range(SHARD_LARGE_N)]
        admin = _S3Client(gw.addr)
        t = time.perf_counter()
        for b in buckets:
            status, data, _h, _dt = admin.request("PUT", f"/{b}")
            check(status == 200, f"CreateBucket {b}: {status} {data[:200]!r}")
        walls["buckets"] = time.perf_counter() - t

        def put_small(client, o):
            key, size, _kind, bkey = o
            body = _s3_body(seed, bkey, size)
            md5 = hashlib.md5(body).hexdigest()
            status, data, hdrs, dt = client.request("PUT", f"/{key}", body=body)
            check(status == 200 and hdrs.get("etag") == f'"{md5}"',
                  f"PUT {key}: {status} {hdrs.get('etag')} != {md5}: {data[:200]!r}")
            return hashlib.sha256(body).hexdigest(), md5, dt

        model: dict = {}  # "bucket/key" -> (size, sha256, etag)
        t = time.perf_counter()
        got = _s3_pool(gw.addr, smalls, put_small)
        fill = {"small": _class_figures("small", [o[1] for o in smalls], [g[2] for g in got],
                                        time.perf_counter() - t)}
        model.update({o[0]: (o[1], g[0], g[1]) for o, g in zip(smalls, got)})
        t = time.perf_counter()
        got = _s3_multipart(gw.addr, seed, larges, lambda k: f"/{k}")
        fill["large"] = _class_figures("large", [o[1] for o in larges], [g[2] for g in got],
                                       time.perf_counter() - t)
        model.update({o[0]: (o[1], g[0], g[1]) for o, g in zip(larges, got)})
        walls["status"], out = _shell(maddr, f"filer.shard.status -route /buckets/{buckets[0]}",
                                      log, filer=filer_list)
        rows = {m[1]: (int(m[2]), int(m[3])) for m in re.finditer(
            r"(127\.0\.0\.1:\d+): alive\s+share=[\d.]+%\s+files=(\d+)\s+dirs=(\d+)", out)}
        check(sorted(rows) == sorted(shard_addrs), f"filer.shard.status: {out!r}")
        share = ring.ownership()
        per_shard = {a: 0 for a in shard_addrs}
        for k in model:
            per_shard[ring.shard_for("/buckets/" + k)] += 1
        check(all(rows[a][0] >= per_shard[a] for a in shard_addrs),
              f"files per shard {rows} below the objects the ring puts there {per_shard}")
        placed = ShardedFilerClient(shard_addrs, MasterClient(maddr))
        try:
            for b in buckets:
                owner = ring.shard_for(f"/buckets/{b}")
                for a, rf in placed._shards.items():
                    found = rf.find_entry(f"/buckets/{b}") is not None
                    check(found == (a == owner), f"bucket {b} on {a}: {found}, ring owner {owner}")
                n_b = sum(1 for k in model if k.startswith(b + "/"))
                listed = sum(len(placed._shards[owner].list_entries(f"/buckets/{b}/{sub}",
                                                                      limit=10_000))
                             for sub in ("small", "large"))
                check(listed == n_b, f"bucket {b}: {listed} entries on its shard, {n_b} objects")
        finally:
            placed.close()
        rec["routing"] = dict(objects=len(model), per_shard=per_shard, status=rows, share=share)
        print(f"shard: routing on {ident}: {len(model)} objects over {SHARD_BUCKETS} buckets; "
              f"objects per shard {per_shard}; filer.shard.status files/dirs {rows}; hash share "
              f"{ {a: round(s, 4) for a, s in share.items()} }; every bucket and its entries on "
              f"the shard ShardRing names and on no other")

        # 2. the worker group's rates
        def get_one(client, key):
            size, sha, etag = model[key]
            status, (got_sha, n), hdrs, dt = client.request("GET", f"/{key}", sink=True)
            check(status == 200 and n == size and got_sha == sha and hdrs.get("etag") == f'"{etag}"',
                  f"GET {key}: {status}, {n} of {size} B, ETag {hdrs.get('etag')} / {etag}")
            return dt

        t = time.perf_counter()
        lat = _s3_pool(gw.addr, [o[0] for o in smalls], get_one)
        reads = {"small": _class_figures("small", [o[1] for o in smalls], lat,
                                         time.perf_counter() - t)}
        t = time.perf_counter()
        lat = _s3_pool(gw.addr, [o[0] for o in larges], get_one, clients=len(larges))
        reads["large"] = _class_figures("large", [o[1] for o in larges], lat,
                                        time.perf_counter() - t)
        per_worker = served()
        check(all(n > 0 for n in per_worker), f"a worker served no request: {per_worker}")
        rec.update(fill=fill, reads=reads, per_worker=per_worker)
        print(f"shard: worker group on {ident}: PUT " + "; ".join(
            f"{c} {r['files']} {r['files_per_s']:.1f}/s {r['mb_per_s']:.1f} MB/s p50 "
            f"{r['p50_ms']:.2f} ms p99 {r['p99_ms']:.2f} ms" for c, r in fill.items())
            + "; GET " + "; ".join(
                f"{c} {r['files']} {r['files_per_s']:.1f}/s {r['mb_per_s']:.1f} MB/s p50 "
                f"{r['p50_ms']:.2f} ms p99 {r['p99_ms']:.2f} ms" for c, r in reads.items())
            + f"; requests per worker {per_worker}")

        # 3. coherence: overwrite, then fresh connections until every worker answers new
        over = smalls[::SHARD_SMALL_N // SHARD_OVERWRITES][:SHARD_OVERWRITES]
        for key, _size, _k, _b in over:
            for _ in range(2 * SHARD_WORKERS):  # warm the workers' caches
                status, _d, hdrs = _fresh(gw.addr, "GET", f"/{key}")
                check(status == 200 and hdrs.get("etag") == f'"{model[key][2]}"',
                      f"warm GET {key}: {status}")
        before, bus_before = served(), bus()
        worst, stale_answers = 0.0, 0
        for i, (key, size, _k, _b) in enumerate(over):
            body = _s3_body(seed, 60_000 + i, size)
            md5 = hashlib.md5(body).hexdigest()
            status, _d, hdrs = _fresh(gw.addr, "PUT", f"/{key}", body=body)
            t_acked = time.perf_counter()
            check(status == 200 and hdrs.get("etag") == f'"{md5}"', f"overwrite {key}: {status}")
            streak, last_stale = 0, None
            while streak < SHARD_STREAK:
                status, data, hdrs = _fresh(gw.addr, "GET", f"/{key}")
                check(status == 200, f"GET {key} after the overwrite: {status}")
                if hdrs.get("etag") == f'"{md5}"':
                    check(data == body, f"{key}: the new ETag with other bytes")
                    streak += 1
                    continue
                check(hdrs.get("etag") == f'"{model[key][2]}"', f"{key}: a third ETag")
                stale_answers += 1
                streak, last_stale = 0, time.perf_counter() - t_acked
                # a datagram round trip, well under the subscriber's 2 s
                # pass and the entry cache's 2 s TTL
                check(last_stale < SHARD_STALE_S,
                      f"{key} still old {last_stale:.3f}s after its PUT")
            worst = max(worst, last_stale or 0.0)
            model[key] = (size, hashlib.sha256(body).hexdigest(), md5)
        after, bus_after = served(), bus()
        check(all(a > b for a, b in zip(after, before)),
              f"a worker answered none of the coherence GETs: {before} -> {after}")
        # every overwrite was sent by the worker that took its PUT to each
        # sibling, or received from it: the bus carried all of them
        sent = [a[0] - b[0] for a, b in zip(bus_after, bus_before)]
        received = [a[1] - b[1] for a, b in zip(bus_after, bus_before)]
        check(all(r + s // (SHARD_WORKERS - 1) >= len(over) for s, r in zip(sent, received)),
              f"the bus missed overwrites: sent {sent}, received {received}")
        rec["coherence"] = dict(keys=len(over), worst_ms=worst * 1e3, stale_answers=stale_answers,
                                per_worker=[a - b for a, b in zip(after, before)],
                                bus_sent=sent, bus_received=received)
        print(f"shard: coherence on {ident}: {len(over)} overwrites, each read on fresh "
              f"connections until {SHARD_STREAK} answers in a row carried the new ETag; worst "
              f"delay {worst * 1e3:.3f} ms after the PUT's 200 (bound "
              f"{SHARD_STALE_S * 1e3:.0f} ms; {stale_answers} stale answers); bus datagrams per "
              f"worker sent {sent} received {received}; GETs per worker "
              f"{rec['coherence']['per_worker']}")

        # 4. IAM: s3.configure over the shard list, cli iam, a store-backed gateway
        iam_ak, iam_sk = "AKIDSHARD16", hashlib.sha256(b"iam16").hexdigest()[:40]
        walls["s3_configure"], out = _shell(
            maddr, f"s3.configure -user smoke16 -actions Read,Write -access_key {iam_ak} "
            f"-secret_key {iam_sk} -apply", log, filer=filer_list)
        check(f"smoke16  actions=Read,Write  keys={iam_ak}" in out, f"s3.configure: {out!r}")
        iam_port = _free_ports(1)[0]
        t = time.perf_counter()
        iam = _Server("", "", os.path.join(root, "iam.log"), wait=False, argv=[
            "iam", "-filer", filer_list, "-master", maddr, "-port", str(iam_port)])
        iam.lines = _Lines(iam.proc)
        iam.lines.wait_for(r"iam api on 127\.0\.0\.1:\d+ \(credential store: filer_etc\)")
        walls["iam_up"] = time.perf_counter() - t
        iam_addr = f"127.0.0.1:{iam_port}"

        def iam_post(form: str) -> tuple:
            status, data, _h = _fresh(iam_addr, "POST", "/", body=form.encode(),
                                      headers={"Content-Type":
                                               "application/x-www-form-urlencoded"},
                                      key=(iam_ak, iam_sk))
            return status, data

        status, data = iam_post("Action=ListUsers")
        check(status == 200 and b"<UserName>smoke16</UserName>" in data, f"ListUsers: {status}")
        status, data = iam_post("Action=CreateAccessKey&UserName=smoke16")
        check(status == 200, f"CreateAccessKey: {status} {data[:300]!r}")
        ak2 = re.search(rb"<AccessKeyId>([^<]+)<", data)[1].decode()
        sk2 = re.search(rb"<SecretAccessKey>([^<]+)<", data)[1].decode()
        rcs["iam"] = iam.stop()
        iam = None
        router = ShardedFilerClient(shard_addrs, MasterClient(maddr))
        inproc = S3ApiServer(maddr, port=0, filer=router,
                             credential_store=FilerEtcCredentialStore(router),
                             lifecycle_sweep_interval=0, credential_refresh=0, chunk_cache_mb=0)
        inproc.start()
        iam_body = _s3_body(seed, 61_000, 40_000)
        st_b, _d, _h = _fresh(inproc.url, "PUT", "/iam16", key=(ak2, sk2))
        st_p, _d, _h = _fresh(inproc.url, "PUT", "/iam16/o.bin", body=iam_body, key=(ak2, sk2))
        st_g, got_body, _h = _fresh(inproc.url, "GET", "/iam16/o.bin", key=(iam_ak, iam_sk))
        st_x, denied, _h = _fresh(inproc.url, "PUT", "/iam16/x.bin", body=b"x",
                                  key=("AKIDUNKNOWN16", "nope"))
        check((st_b, st_p, st_g, st_x) == (200, 200, 200, 403) and got_body == iam_body
              and b"AccessDenied" in denied,
              f"store-backed gateway: bucket {st_b}, PUT {st_p}, GET {st_g}, unknown key {st_x}")
        inproc.stop()
        inproc = None
        router.close()
        router = None
        print(f"shard: IAM on {ident}: s3.configure -apply over {SHARD_FILERS} shards "
              f"{walls['s3_configure']:.3f}s; cli iam (filer_etc) up in {walls['iam_up']:.3f}s, "
              f"ListUsers names smoke16, CreateAccessKey gave a second key; an in-process "
              f"gateway on FilerEtcCredentialStore(ShardedFilerClient) took a PUT signed with it "
              f"(200) and refused an unknown key (403)")

        # 5. a browser form POST and SelectObjectContent
        post_data = _s3_body(seed, 62_000, 20_000)
        ok = [{"bucket": buckets[0]}, ["starts-with", "$key", "post/"],
              ["content-length-range", 1, MIB]]
        ctype, form = _post_form(_signed_form(buckets[0], "post/${filename}", ok), "p.bin",
                                 post_data)
        st_ok, d_ok, _h = _fresh(gw.addr, "POST", f"/{buckets[0]}", body=form,
                                 headers={"Content-Type": ctype}, sign=False)
        st_get, got_post, _h = _fresh(gw.addr, "GET", f"/{buckets[0]}/post/p.bin")
        bad = [{"bucket": buckets[1]}] + ok[1:]
        ctype, form = _post_form(_signed_form(buckets[0], "post/q.bin", bad), "q.bin", post_data)
        st_bad, d_bad, _h = _fresh(gw.addr, "POST", f"/{buckets[0]}", body=form,
                                   headers={"Content-Type": ctype}, sign=False)
        check(st_ok == 204 and st_get == 200 and got_post == post_data and st_bad == 403
              and b"AccessDenied" in d_bad,
              f"form POST {st_ok} {d_ok[:200]!r}, GET {st_get}, broken condition {st_bad}")
        srows = [{"id": i, "name": f"n{int(rng.integers(0, 10_000)):04d}",
                  "age": int(rng.integers(18, 90)), "city": ["Oslo", "Lima", "Pune"][i % 3]}
                 for i in range(SHARD_SELECT_ROWS)]
        csv_body = ("id,name,age,city\n" + "".join(
            f"{r['id']},{r['name']},{r['age']},{r['city']}\n" for r in srows)).encode()
        json_body = "".join(json.dumps(r) + "\n" for r in srows).encode()
        sel_bucket = buckets[1]
        for key, body in (("sel/rows.csv", csv_body), ("sel/rows.json", json_body)):
            status, _d, _h = _fresh(gw.addr, "PUT", f"/{sel_bucket}/{key}", body=body)
            check(status == 200, f"PUT {key}: {status}")
        selects = {}
        for key, inp in (("sel/rows.csv", "<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>"),
                         ("sel/rows.json", "<JSON><Type>LINES</Type></JSON>")):
            req = (f"<SelectObjectContentRequest><Expression>SELECT s.id, s.name FROM S3Object s "
                   f"WHERE s.age &gt; 60</Expression><ExpressionType>SQL</ExpressionType>"
                   f"<InputSerialization>{inp}</InputSerialization><OutputSerialization><JSON/>"
                   f"</OutputSerialization></SelectObjectContentRequest>").encode()
            t = time.perf_counter()
            status, data, _h = _fresh(gw.addr, "POST", f"/{sel_bucket}/{key}",
                                      "select=&select-type=2", req)
            selects[key] = time.perf_counter() - t
            want = [{"id": r["id"], "name": r["name"]} for r in srows if r["age"] > 60]
            check(status == 200 and [json.loads(x) for x in data.decode().splitlines()] == want,
                  f"Select over {key}: {status}, {len(data.splitlines())} rows, want {len(want)}")
        rec["post_select"] = dict(select_s=selects, rows=sum(r["age"] > 60 for r in srows))
        print(f"shard: browser POST and Select on {ident}: a signed form POST 204 and read back "
              f"equal, a broken condition 403; Select over {SHARD_SELECT_ROWS} CSV and JSON-lines "
              f"rows returned the {rec['post_select']['rows']} a plain Python filter keeps "
              f"({ {k: round(v, 4) for k, v in selects.items()} } s)")

        # 6. one dead shard
        victim_i = 1
        victim_addr = shard_addrs[victim_i]
        dead_buckets = [b for b in buckets if ring.shard_for(f"/buckets/{b}") == victim_addr]
        check(dead_buckets and len(dead_buckets) < len(buckets),
              f"the ring gives shard {victim_addr} {len(dead_buckets)} buckets")
        filers[victim_i].proc.send_signal(signal.SIGKILL)
        filers[victim_i].proc.wait(timeout=60)
        rcs["filer_killed"] = filers[victim_i].stop()
        t = time.perf_counter()
        verdicts: dict = {}
        other_errors = []
        for b in buckets:
            status, data, hdrs = _fresh(gw.addr, "GET", f"/{b}", "list-type=2&max-keys=5")
            verdicts.setdefault(status, 0)
            verdicts[status] += 1
            if b in dead_buckets:
                if not (status == 503 and float(hdrs.get("retry-after", "0")) > 0
                        and b"SlowDown" in data):
                    other_errors.append((b, status, hdrs.get("retry-after")))
            elif status != 200:
                other_errors.append((b, status, data[:120]))
        walls["dead_pass"] = time.perf_counter() - t
        check(not other_errors, f"with shard {victim_addr} dead: {other_errors[:5]}")
        t = time.perf_counter()
        filers[victim_i] = _Server("", "", os.path.join(root, f"filer{victim_i}.restart.log"),
                                   wait=False, argv=filer_argv[victim_i])
        filers[victim_i].ready()
        walls["shard_restart"] = time.perf_counter() - t

        answers: dict = {}

        def dead_buckets_serve() -> bool:
            for b in dead_buckets:
                status, data, _h = _fresh(gw.addr, "GET", f"/{b}", "list-type=2&max-keys=5")
                answers[b] = (status, data[:160])
            return all(a[0] == 200 for a in answers.values())

        try:
            walls["shard_serves_again"] = _poll(dead_buckets_serve,
                                                "the restarted shard's buckets", 60)
        except SmokeFailure as e:
            raise SmokeFailure(f"{e}: {sorted(answers.items())[:3]}") from None
        back = [k for k in model if k.split("/", 1)[0] in dead_buckets][:64]
        _s3_pool(gw.addr, back, get_one)
        rec["dead_shard"] = dict(victim=victim_addr, buckets=len(dead_buckets), verdicts=verdicts)
        print(f"shard: dead shard on {ident}: SIGKILL {victim_addr} (owner of "
              f"{len(dead_buckets)} of {SHARD_BUCKETS} buckets): ListObjectsV2 of every bucket "
              f"{verdicts} in {walls['dead_pass']:.3f}s (503 with Retry-After exactly for its "
              f"buckets, 0 other errors); restarted on its -db in {walls['shard_restart']:.3f}s, "
              f"its buckets serve again after {walls['shard_serves_again']:.3f}s and "
              f"{len(back)} of their objects read back equal")
        admin.close()

        # 7. ec.encode of every volume through K1, then every object from the shards
        vols: dict = {}
        for d in dirs:
            for n_ in os.listdir(d):
                mm = re.fullmatch(r"(\d+)\.dat", n_)
                if mm and os.path.getsize(os.path.join(d, n_)) > 8:
                    vols[int(mm[1])] = max(vols.get(int(mm[1]), 0),
                                           os.path.getsize(os.path.join(d, n_)))
        tasks = sum(len(ec_encoder._plan_tasks(DEFAULT_SCHEME, s, ec_encoder.DEFAULT_CHUNK))
                    for s in vols.values())
        k1_before = {s_.url: metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply")
                     for s_ in servers}
        check(not any(k1_before.values()), f"K1 launched before the encode: {k1_before}")
        walls["ec_encode"], _out = _shell(maddr, "lock; " + "; ".join(
            f"ec.encode -volumeId {vid}" for vid in sorted(vols)) + "; unlock", log,
            filer=filer_list)
        by_grpc = {f"127.0.0.1:{s_.grpc_port}": d for s_, d in zip(servers, dirs)}
        for vid in vols:
            _poll(lambda: _ec_census(mstub, vid)["holders"] == _disk_shards(by_grpc, str(vid)),
                  f"the master's EC census of {vid} to match the disks", 60)
        k1 = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply"))
              for s_ in servers}
        check(sum(k1.values()) == tasks and tasks > 0,
              f"K1 launches by server {k1}; the generates of {len(vols)} volumes have {tasks} batches")
        check(not any(re.fullmatch(r"\d+\.dat", n_) for d in dirs for n_ in os.listdir(d)
                      if int(n_.split(".")[0]) in vols), "an encoded volume's .dat survived")
        rcs["s3_group_1"] = gw.stop()  # SIGTERM forwarded to every worker
        t = time.perf_counter()
        gw, _banners = start_group()  # empty chunk caches: every read comes from the shards
        walls["group_restart"] = time.perf_counter() - t
        t = time.perf_counter()
        lat = _s3_pool(gw.addr, sorted(model), get_one)
        rec["read_ec"] = _class_figures("all", [model[k][0] for k in sorted(model)], lat,
                                        time.perf_counter() - t)
        r = rec["read_ec"]
        print(f"shard: ec.encode -volumeId of {len(vols)} volumes ({sum(vols.values())} B) "
              f"{walls['ec_encode']:.3f}s on {ident} (shell -filer {SHARD_FILERS} shards); K1 "
              f"launches by server {k1} (= {tasks} batches); the worker group restarted in "
              f"{walls['group_restart']:.3f}s read every object from the shards: {r['files']} "
              f"{r['files_per_s']:.1f}/s {r['mb_per_s']:.1f} MB/s p50 {r['p50_ms']:.2f} ms p99 "
              f"{r['p99_ms']:.2f} ms, ETag- and sha256-equal")
    finally:
        if inproc is not None:
            inproc.stop()
        if router is not None:
            router.close()
        if iam is not None:
            rcs["iam"] = iam.stop()
        if gw is not None:
            rcs["s3_group"] = gw.stop()
        rcs.update({f"filer{i}": f_.stop() for i, f_ in enumerate(filers)})
        rcs.update({getattr(s_, "url", s_.proc.pid): s_.stop() for s_ in servers})
        rcs["master"] = master.stop()
    check(rcs.pop("filer_killed") == -signal.SIGKILL and all(rc == 0 for rc in rcs.values()),
          f"shard phase processes exited {rcs}")
    walls["phase"] = time.perf_counter() - t_phase
    rec.update(walls=walls, launches=tasks, volumes=len(vols), rcs={str(k): v for k, v in rcs.items()})
    print("shard: " + json.dumps(rec, sort_keys=True, default=str))
    return rec


# -- phase 17 -------------------------------------------------------------------


ADMIN_NEEDLE = 64 * 1024  # the needles of every phase-17 volume
ADMIN_WRITERS = 16  # `weed benchmark`'s -c
ADMIN_FULL = 0.955  # each EC volume filled past -ecFullPercent 95 of -volumeSizeLimitMB
ADMIN_VAC_BYTES = 64 * MIB  # the 001 volume the scanner vacuums
ADMIN_VAC_DELETED = 0.4  # of its needles deleted: a garbage ratio above -garbageThreshold 0.3
ADMIN_SCAN_S = 1.0  # -scanInterval, cut from upstream's 30 s for the run's time
ADMIN_QUIET_S = 3.0  # -ecQuietSeconds, cut from upstream's 3600 s for the run's time
ADMIN_SAMPLE = 64  # needles of each volume read back after each step
ADMIN_WAIT_S = 120.0  # every wait for the maintenance plane
ADMIN_PASSWORD = "smoke-admin-pw"
ADMIN_TELEMETRY_FILE_S = 300  # telemetryInterval in the master's TOML file (the JAX default)
ADMIN_TELEMETRY_S = 1  # WEEDTPU_MASTER_TELEMETRYINTERVAL, which beats the file
ADMIN_COOKIE = 0x5EED17AD


def _admin_payload(vid: int, key: int) -> bytes:
    return hashlib.shake_256(f"admin{vid},{key}".encode()).digest(ADMIN_NEEDLE)


def _admin_fid(vid: int, key: int) -> str:
    return f"{vid},{key:x}{ADMIN_COOKIE:08x}"


def phase_admin(args, directory: str, ident: str, dev) -> dict:
    """Phase 17: the maintenance plane, with no shell command, reported to
    a telemetry collector.  One ``cli -config FILE -v 1 master -port 0``
    whose FILE is ``cli scaffold``'s text with ``volumeSizeLimitMB = 256``,
    ``mdir``, ``telemetryUrl`` and ``telemetryInterval = 300`` (which
    ``WEEDTPU_MASTER_TELEMETRYINTERVAL=1`` beats), ``cli telemetry``
    started beside it, four ``cli volume -device cuda`` on
    two racks, ``cli admin -adminPassword -configFile -scanInterval 1
    -ecQuietSeconds 3`` (upstream's -ecFullPercent 95 and
    -garbageThreshold 0.3) and two ``cli worker -adminPassword``, none of
    which maps libcuda.  Two
    volumes grown by ``VolumeGrow`` (replication 000) are filled past 95%
    with 64 KiB needles from 16 clients and their .dat linked aside; a 001
    volume of 64 MB loses 40% of its needles.  The scanner submits
    EC_ENCODE for both and VACUUM for the third; the workers run them: K1
    launches in the generating servers equal the stripe batches, the
    shards' sha256 equal the plain torch version's (rs_torch on the card)
    encoding of the linked .dat, a sample reads back from the shards, the
    vacuum runs on both holders (bytes reclaimed; live needles 200, deleted
    404).  One shard holder is SIGKILLed: the master drops it, the scanner
    sees the volumes degraded on two scans and EC_REBUILD restores 14
    shards each, sha256-equal.  The collector's ``/api/instances`` then
    holds the master's server, volume and EC shard counts and the
    ``cluster.id`` of its ``mdir``, within three report intervals.  Then
    the admin API: 401 without
    credentials, a login, ``/status`` with every task completed and none
    failed, the dashboard, and a policy edit kept across an admin restart.
    Figures on ``admin:`` lines."""
    import numpy as np

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.util.http_pool import HttpConnectionPool

    root = os.path.join(directory, "admin")
    dirs = [os.path.join(root, f"v{i}") for i in range(CLUSTER_SERVERS)]
    for d in dirs:
        os.makedirs(d)
    walls: dict = {}
    rec: dict = {}
    servers: list = []
    workers: list = []
    admin = None
    rcs: dict = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng([args.seed, 17])
    pool = HttpConnectionPool(timeout=60.0, max_per_host=64)
    basic = {"Authorization": "Basic " + base64.b64encode(
        f"admin:{ADMIN_PASSWORD}".encode()).decode()}
    # the master's settings in a TOML file made from `cli scaffold`'s text,
    # whose telemetryInterval loses to the environment's.  The collector
    # starts beside the master on a port the file names first.
    tport = _free_ports(1)[0]
    config_path = os.path.join(root, "weed-tpu.toml")
    mdir = os.path.join(root, "mdir")
    t = time.perf_counter()
    scaffold = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch.cli", "scaffold"],
                              cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                              text=True, timeout=120)
    check(scaffold.returncode == 0 and "[master]\n" in scaffold.stdout,
          f"cli scaffold: rc {scaffold.returncode}, {scaffold.stderr[-500:]!r}")
    text = scaffold.stdout
    for old_line, new_line in (
            ("# volumeSizeLimitMB = 30720", f"volumeSizeLimitMB = {FILER_VOLUME_MB}"),
            ('# mdir = "/var/lib/weed-tpu/master"',
             f'mdir = "{mdir}"\ntelemetryUrl = "http://127.0.0.1:{tport}/api/collect"\n'
             f"telemetryInterval = {ADMIN_TELEMETRY_FILE_S}")):
        check(text.count(old_line + "\n") == 1, f"cli scaffold's text has no {old_line!r}")
        text = text.replace(old_line + "\n", new_line + "\n")
    with open(config_path, "w") as f:
        f.write(text)
    telemetry = _Server("", "", os.path.join(root, "telemetry.log"), wait=False,
                        argv=["telemetry", "-port", str(tport)])
    telemetry.lines = _Lines(telemetry.proc)
    try:
        master = _Server("", "", os.path.join(root, "master.log"),
                         argv=["-config", config_path, "-v", "1", "master", "-port", "0"],
                         env={"WEEDTPU_MASTER_TELEMETRYINTERVAL": str(ADMIN_TELEMETRY_S)})
    except BaseException:
        telemetry.stop()
        raise
    t_master = time.perf_counter()
    try:
        telemetry.lines.wait_for(re.escape(f"telemetry collector on http://127.0.0.1:{tport} "))
        walls["scaffold_to_up"] = time.perf_counter() - t  # the file, the collector, the master
        maddr = f"127.0.0.1:{master.grpc_port}"
        mhttp = f"127.0.0.1:{master.http_port}"
        mstub = rpc.master_stub(maddr)
        aport = _free_ports(1)[0]
        aaddr = f"127.0.0.1:{aport}"
        admin_argv = ["admin", "-port", str(aport), "-master", maddr,
                      "-scanInterval", str(ADMIN_SCAN_S), "-ecQuietSeconds", str(ADMIN_QUIET_S),
                      "-ecFullPercent", "95", "-garbageThreshold", "0.3",
                      "-adminPassword", ADMIN_PASSWORD, "-configFile",
                      os.path.join(root, "admin.json")]
        n_admin = [0]

        def start_admin():
            n_admin[0] += 1
            a = _Server("", "", os.path.join(root, f"admin.{n_admin[0]}.log"), wait=False,
                        argv=admin_argv)
            a.lines = _Lines(a.proc)
            a.lines.wait_for(re.escape(f"admin server on http://{aaddr} (master {maddr}, auth)"))
            return a

        t = time.perf_counter()
        servers = [_Server(d, dev.type, os.path.join(root, f"v{i}.log"), wait=False, argv=[
            "volume", "-dir", d, "-ip", "127.0.0.1", "-port", "0", "-grpcPort", "0",
            "-metricsPort", "0", "-device", dev.type, "-mserver", maddr, "-rack", f"r{i % 2}",
            "-scrubInterval", "0", "-scrubRateMB", "0"]) for i, d in enumerate(dirs)]
        admin = start_admin()
        for i in range(2):
            w = _Server("", "", os.path.join(root, f"worker{i}.log"), wait=False, argv=[
                "worker", "-admin", aaddr, "-master", maddr, "-pollInterval", "0.5",
                "-adminPassword", ADMIN_PASSWORD])
            w.lines = _Lines(w.proc)
            workers.append(w)
        worker_ids = [w.lines.wait_for(r"worker (worker-[0-9a-f]+) polling admin")[0]
                      for w in workers]
        for s_ in servers:
            s_.ready()
            s_.url = f"127.0.0.1:{s_.http_port}"
        walls["servers_up"] = time.perf_counter() - t
        urls = [s_.url for s_ in servers]
        grpc_of = {s_.url: f"127.0.0.1:{s_.grpc_port}" for s_ in servers}

        def topo():
            return mstub.VolumeList(m_pb.VolumeListRequest(), timeout=60).topology_info

        def nodes() -> set:
            return {dn.id for dc in topo().data_center_infos for r in dc.rack_infos
                    for dn in r.data_node_infos}

        walls["registered"] = _poll(lambda: nodes() == set(urls), "all four nodes", 60)

        def cuda_contexts() -> dict:
            """Which processes hold a CUDA context: nvidia-smi's compute apps
            (empty where a container hides the pids) and every process that
            mapped libcuda, which the CUDA runtime loads only when it
            initialises."""
            run = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60)

            def libcuda(pid: int) -> bool:
                with open(f"/proc/{pid}/maps") as f:
                    return "libcuda.so" in f.read()

            plane = [admin.proc.pid, *(w.proc.pid for w in workers), telemetry.proc.pid]
            out = dict(smi=sorted(int(p) for p in run.stdout.split() if p.isdigit()),
                       servers={s_.proc.pid: libcuda(s_.proc.pid) for s_ in servers
                                if s_.proc.poll() is None},
                       plane={pid: libcuda(pid) for pid in plane})
            check(not set(out["smi"]) & set(plane) and not any(out["plane"].values())
                  and all(out["servers"].values()) == (dev.type == "cuda"),
                  f"CUDA contexts: {out} (the volume servers hold one, the admin, the "
                  f"workers and the collector never)")
            return out

        rec["cuda_contexts"] = [cuda_contexts()]
        k1_start = {s_.url: metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply")
                    for s_ in servers}
        check(not any(k1_start.values()), f"K1 launched before the phase: {k1_start}")
        print(f"admin: master {maddr}, four volume servers on {ident}, cli admin on {aaddr} "
              f"(scan {ADMIN_SCAN_S}s, quiet {ADMIN_QUIET_S}s), workers {worker_ids}, up in "
              f"{walls['servers_up']:.3f}s; CUDA contexts (libcuda mapped) {rec['cuda_contexts'][0]}")

        # 1. two EC volumes past 95%, one 001 volume with 40% garbage
        ec_vids = list(mstub.VolumeGrow(m_pb.VolumeGrowRequest(
            collection="ecauto", replication="000", count=2), timeout=60).volume_ids)
        (vac_vid,) = mstub.VolumeGrow(m_pb.VolumeGrowRequest(
            collection="vacauto", replication="001", count=1), timeout=60).volume_ids
        holder_of: dict = {}

        def placed() -> bool:
            for dc in topo().data_center_infos:
                for r in dc.rack_infos:
                    for dn in r.data_node_infos:
                        for disk in dn.disk_infos.values():
                            for v in disk.volume_infos:
                                holder_of.setdefault(v.id, set()).add(dn.id)
            return all(v in holder_of for v in ec_vids) and len(holder_of.get(vac_vid, ())) == 2

        _poll(placed, "the grown volumes at the master", 60)
        primary = {v: sorted(holder_of[v])[0] for v in [*ec_vids, vac_vid]}
        probe = _admin_fid(ec_vids[0], 1)
        status, body = pool.request(primary[ec_vids[0]], "POST", f"/{probe}",
                                    body=_admin_payload(ec_vids[0], 1))
        check(status == 201, f"POST {probe}: {status} {body[:200]!r}")
        st = rpc.volume_stub(grpc_of[primary[ec_vids[0]]]).VolumeStatus(
            vs_pb.VolumeStatusRequest(volume_id=ec_vids[0]), timeout=60)
        record = st.volume_size - 8  # the superblock's 8 bytes
        limit = FILER_VOLUME_MB * MIB
        n_ec = -(-int(limit * ADMIN_FULL - 8) // record)
        n_vac = ADMIN_VAC_BYTES // record
        # the EC volumes' writes last: their quiet time starts at the fill's end
        writes = [(vac_vid, k) for k in range(1, n_vac + 1)]
        writes += [(v, k) for k in range(2, n_ec + 1) for v in ec_vids]
        lat: list = []

        def post(vk) -> None:
            v, k = vk
            t0 = time.perf_counter()
            status, body = pool.request(primary[v], "POST", f"/{_admin_fid(v, k)}",
                                        body=_admin_payload(v, k))
            check(status == 201, f"POST {_admin_fid(v, k)}: {status} {body[:200]!r}")
            lat.append(time.perf_counter() - t0)

        t = time.perf_counter()
        with ThreadPoolExecutor(ADMIN_WRITERS) as ex:
            list(ex.map(post, writes))
        walls["fill"] = time.perf_counter() - t
        t_quiet = time.perf_counter()
        # the .dat as the scanner finds it, linked aside before it acts
        refs = {}
        for v in ec_vids:
            src = os.path.join(dirs[urls.index(primary[v])], f"ecauto_{v}")
            refs[v] = os.path.join(root, f"ref{v}", f"ecauto_{v}")
            os.makedirs(os.path.dirname(refs[v]))
            os.link(src + ".dat", refs[v] + ".dat")
        linked_s = time.perf_counter() - t_quiet
        check(linked_s < ADMIN_QUIET_S, f"linking the .dat took {linked_s:.3f}s")
        dat_sizes = {v: os.path.getsize(refs[v] + ".dat") for v in ec_vids}
        check(all(limit * 0.95 <= s < limit for s in dat_sizes.values()),
              f"the EC volumes' sizes {dat_sizes} against 95% of {limit}")
        deleted = sorted(int(k) for k in rng.choice(np.arange(1, n_vac + 1),
                                                    int(n_vac * ADMIN_VAC_DELETED), replace=False))
        t = time.perf_counter()
        with ThreadPoolExecutor(ADMIN_WRITERS) as ex:
            got = list(ex.map(lambda k: pool.request(primary[vac_vid], "DELETE",
                                                     f"/{_admin_fid(vac_vid, k)}")[0], deleted))
        check(set(got) == {202}, f"deletes answered {sorted(set(got))}")
        walls["deletes"] = time.perf_counter() - t
        vac_dirs = [dirs[urls.index(u)] for u in sorted(holder_of[vac_vid])]
        vac_before = {d: os.path.getsize(os.path.join(d, f"vacauto_{vac_vid}.dat"))
                      for d in vac_dirs}
        lat_ms = np.array(lat) * 1e3
        rec["fill"] = dict(writes=len(writes), per_s=len(writes) / walls["fill"],
                           mb_per_s=len(writes) * ADMIN_NEEDLE / walls["fill"] / 1e6,
                           p50_ms=float(np.percentile(lat_ms, 50)),
                           p99_ms=float(np.percentile(lat_ms, 99)))
        print(f"admin: volumes {ec_vids} (ecauto, 000) filled to {dat_sizes} B "
              f"({n_ec} x {ADMIN_NEEDLE} B each) and {vac_vid} (vacauto, 001) to "
              f"{n_vac} needles, {len(deleted)} deleted: {len(writes)} writes from "
              f"{ADMIN_WRITERS} clients in {walls['fill']:.3f}s ({rec['fill']['per_s']:.1f}/s, "
              f"{rec['fill']['mb_per_s']:.1f} MB/s, p50 {rec['fill']['p50_ms']:.2f} ms, p99 "
              f"{rec['fill']['p99_ms']:.2f} ms) on {ident}; .dat linked aside in {linked_s:.3f}s")

        # 2. the scanner's EC_ENCODE and VACUUM, run by the workers
        seen: dict = {}  # (kind, vid) -> {state: first perf_counter seen}

        def tasks() -> list:
            status, body = pool.request(aaddr, "GET", "/tasks", headers=basic)
            check(status == 200, f"admin /tasks: {status} {body[:200]!r}")
            now = time.perf_counter()
            out = json.loads(body)["tasks"]
            for t_ in out:
                seen.setdefault((t_["kind"], t_["volume_id"]), {}).setdefault(t_["state"], now)
                check(t_["state"] != "failed", f"task failed: {t_}")
            return out

        def done(kind: str, vids) -> bool:
            tasks()
            return all("completed" in seen.get((kind, v), {}) for v in vids)

        def submitted(kind: str, vid: int) -> float:
            """When the task was first seen, in whatever state."""
            return min(seen[(kind, vid)].values())

        walls["encoded"] = _poll(lambda: done("ec_encode", ec_vids), "both EC_ENCODE tasks",
                                 ADMIN_WAIT_S)
        enc = {v: seen[("ec_encode", v)] for v in ec_vids}
        by_grpc = {grpc_of[u]: d for u, d in zip(urls, dirs)}
        for v in ec_vids:
            _poll(lambda: _ec_census(mstub, v)["holders"] == _disk_shards(by_grpc, f"ecauto_{v}"),
                  f"the master's EC census of {v} to match the disks", 60)
        census = {v: _ec_census(mstub, v)["holders"] for v in ec_vids}
        check(all(len(h) >= 3 for h in census.values()),
              f"the encoded shards were not spread: {census}")
        check(not any(os.path.exists(os.path.join(d, f"ecauto_{v}.dat")) for d in dirs
                      for v in ec_vids), "an encoded volume's .dat survived")
        batches = {v: len(ec_encoder._plan_tasks(DEFAULT_SCHEME, s, ec_encoder.DEFAULT_CHUNK))
                   for v, s in dat_sizes.items()}
        k1 = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply"))
              for s_ in servers}
        check(sum(k1.values()) == sum(batches.values()) > 0,
              f"K1 launches by server {k1}; the generates have {batches} batches")
        gens = [g for s_ in servers for g in server_stages(s_.log_text(), "generate")]
        check(len(gens) == 2, f"{len(gens)} generate stage lines, not 2")
        sample = {v: sorted(int(k) for k in rng.choice(np.arange(1, n_ec + 1), ADMIN_SAMPLE,
                                                       replace=False)) for v in ec_vids}

        def read_sample(label: str) -> float:
            def one(vk) -> None:
                v, k = vk
                status, body = pool.request(mhttp, "GET", f"/dir/lookup?volumeId={v}")
                check(status == 200, f"/dir/lookup?volumeId={v}: {status}")
                locs = [loc["url"] for loc in json.loads(body)["locations"]]
                status, body = pool.request(locs[k % len(locs)], "GET", f"/{_admin_fid(v, k)}")
                check(status == 200 and body == _admin_payload(v, k),
                      f"{label}: {_admin_fid(v, k)} answered {status}, {len(body)} B")

            t0 = time.perf_counter()
            with ThreadPoolExecutor(ADMIN_WRITERS) as ex:
                list(ex.map(one, [(v, k) for v in ec_vids for k in sample[v]]))
            return time.perf_counter() - t0

        walls["sample_encoded"] = read_sample("from the shards")
        rec["encode"] = {str(v): dict(
            dat_bytes=dat_sizes[v], batches=batches[v],
            quiet_to_submitted_s=submitted("ec_encode", v) - t_quiet,
            submitted_to_completed_s=enc[v]["completed"] - submitted("ec_encode", v))
            for v in ec_vids}
        rec["generate"] = [dict(wall_s=g["wall_s"], gbs=g["data_bytes"] / g["wall_s"] / 1e9)
                           for g in gens]
        print(f"admin: EC_ENCODE of {ec_vids} on {ident}: quiet -> submitted "
              f"{[round(rec['encode'][str(v)]['quiet_to_submitted_s'], 3) for v in ec_vids]} s, "
              f"-> completed {[round(rec['encode'][str(v)]['submitted_to_completed_s'], 3) for v in ec_vids]} s "
              f"(the worker's generate, spread and the master's census); generate walls "
              f"{[round(g['wall_s'], 3) for g in rec['generate']]} s, "
              f"{[round(g['gbs'], 3) for g in rec['generate']]} GB/s of .dat; K1 launches by server "
              f"{k1} (= {sum(batches.values())} batches); shards spread {census}; {ADMIN_SAMPLE} "
              f"needles of each read back from the shards in {walls['sample_encoded']:.3f}s")

        # 3. the scanner's VACUUM on both holders of the 001 volume (before
        # the kill, which spares its holders)
        _poll(lambda: done("vacuum", [vac_vid]), "the VACUUM task", ADMIN_WAIT_S)
        vac = seen[("vacuum", vac_vid)]
        vac_after = {d: os.path.getsize(os.path.join(d, f"vacauto_{vac_vid}.dat"))
                     for d in vac_dirs}
        reclaimed = {d: vac_before[d] - vac_after[d] for d in vac_dirs}
        check(all(r > 0 for r in reclaimed.values()), f"the vacuum reclaimed {reclaimed}")
        live = [k for k in range(1, n_vac + 1) if k not in set(deleted)]
        check_live = sorted(int(k) for k in rng.choice(live, min(ADMIN_SAMPLE, len(live)),
                                                       replace=False))
        check_dead = sorted(int(k) for k in rng.choice(deleted, min(ADMIN_SAMPLE, len(deleted)),
                                                       replace=False))
        for u in sorted(holder_of[vac_vid]):
            for k in check_live:
                status, body = pool.request(u, "GET", f"/{_admin_fid(vac_vid, k)}")
                check(status == 200 and body == _admin_payload(vac_vid, k),
                      f"live {_admin_fid(vac_vid, k)} on {u}: {status}")
            for k in check_dead:
                status, _body = pool.request(u, "GET", f"/{_admin_fid(vac_vid, k)}")
                check(status == 404, f"deleted {_admin_fid(vac_vid, k)} on {u}: {status}")
        rec["vacuum"] = dict(reclaimed=sum(reclaimed.values()),
                             quiet_to_submitted_s=submitted("vacuum", vac_vid) - t_quiet,
                             submitted_to_completed_s=vac["completed"] - submitted("vacuum", vac_vid))
        print(f"admin: VACUUM of volume {vac_vid} on both holders on {ident}: "
              f"{sorted(reclaimed.values())} B reclaimed ({vac_before} -> {vac_after}); submitted "
              f"{rec['vacuum']['quiet_to_submitted_s']:.3f}s after the fill's end, completed "
              f"{rec['vacuum']['submitted_to_completed_s']:.3f}s later; {len(check_live)} live "
              f"needles 200 and {len(check_dead)} deleted ones 404 on each holder")

        # 4. SIGKILL a shard holder; the scanner's EC_REBUILD restores 14 shards
        shard_sha: dict = {}

        def plain_reference() -> None:
            """Every shard of both volumes (the victim's files stay on its
            disk) against the plain torch version's encoding of the linked
            .dat on the card; run while the master waits out the victim."""
            t0 = time.perf_counter()
            plain = ReedSolomonTorch(10, 4, device=dev)
            for v in ec_vids:
                ec_encoder.write_ec_files(refs[v], codec=plain)
                files = {sid: os.path.join(d, f"ecauto_{v}.ec{sid:02d}") for d in dirs
                         for sid in range(14)
                         if os.path.exists(os.path.join(d, f"ecauto_{v}.ec{sid:02d}"))}
                check(sorted(files) == list(range(14)),
                      f"volume {v}'s shards on disk: {sorted(files)}")
                shard_sha[v] = {sid: sha256(p) for sid, p in files.items()}
                for sid, h in shard_sha[v].items():
                    check(h == sha256(refs[v] + f".ec{sid:02d}"),
                          f"volume {v} shard {sid} differs from the plain torch version's parity")
            walls["plain_reference"] = time.perf_counter() - t0

        victim = max((s_ for s_ in servers if s_.url not in holder_of[vac_vid]),
                     key=lambda s_: sum(len(census[v].get(grpc_of[s_.url], [])) for v in ec_vids))
        lost = {v: census[v].get(grpc_of[victim.url], []) for v in ec_vids}
        degraded = [v for v in ec_vids if lost[v]]
        k1_before = {s_.url: k1[s_.url] for s_ in servers if s_ is not victim}
        victim.proc.kill()
        t_kill = time.perf_counter()
        with ThreadPoolExecutor(1) as ex:
            reference = ex.submit(plain_reference)
            walls["pruned"] = _poll(lambda: victim.url not in nodes(),
                                    "the master to drop the victim", ADMIN_WAIT_S)
            walls["kill_to_rebuilt"] = _poll(lambda: done("ec_rebuild", degraded),
                                             "the EC_REBUILD tasks", ADMIN_WAIT_S) + walls["pruned"]
            reference.result()
        survivors = [s_ for s_ in servers if s_ is not victim]
        by_grpc = {grpc_of[s_.url]: dirs[servers.index(s_)] for s_ in survivors}
        for v in degraded:
            _poll(lambda: _ec_census(mstub, v)["holders"] == _disk_shards(by_grpc, f"ecauto_{v}"),
                  f"the master's EC census of {v} after the rebuild", 60)
            files = {sid: os.path.join(by_grpc[a], f"ecauto_{v}.ec{sid:02d}")
                     for a, sids in _disk_shards(by_grpc, f"ecauto_{v}").items() for sid in sids}
            check(sorted(files) == list(range(14)), f"volume {v} after the rebuild: {sorted(files)}")
            for sid, p in files.items():
                check(sha256(p) == shard_sha[v][sid], f"volume {v} shard {sid} rebuilt differently")
        t_census = time.perf_counter()  # the master's counts are final from here
        k1_after = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches",
                                       kernel="gf_apply")) for s_ in survivors}
        k1_rebuild = sum(k1_after.values()) - sum(k1_before.values())
        check(k1_rebuild > 0, f"the rebuilds launched no K1: {k1_before} -> {k1_after}")
        walls["sample_rebuilt"] = read_sample("after the rebuild")
        reb = {v: seen[("ec_rebuild", v)] for v in degraded}
        rec["rebuild"] = dict(victim=victim.url, lost={str(v): lost[v] for v in ec_vids},
                              launches=k1_rebuild, pruned_s=walls["pruned"],
                              submitted_s={str(v): submitted("ec_rebuild", v) - t_kill
                                           for v in degraded},
                              completed_s={str(v): reb[v]["completed"] - t_kill for v in degraded})
        print(f"admin: every shard of {ec_vids} sha256-equal to ReedSolomonTorch's (the plain "
              f"torch version on {ident}) encoding of the linked .dat, "
              f"{walls['plain_reference']:.3f}s for both, while the master waited out the victim")
        print(f"admin: SIGKILL {victim.url} (shards {lost}) on {ident}: dropped by the master "
              f"after {walls['pruned']:.3f}s; EC_REBUILD submitted after "
              f"{[round(x, 3) for x in rec['rebuild']['submitted_s'].values()]} s and completed "
              f"after {[round(x, 3) for x in rec['rebuild']['completed_s'].values()]} s (from the "
              f"kill); 14 shards of each present, the rebuilt ones sha256-equal to step 2's; K1 "
              f"launches in the rebuilds {k1_rebuild}; the sample reads back in "
              f"{walls['sample_rebuilt']:.3f}s")

        # 5. the collector: the leader's reports, at the environment's 1 s
        # interval, carry the master's counts after the encode and rebuild
        def master_counts() -> dict:
            dns = [dn for dc in topo().data_center_infos for r in dc.rack_infos
                   for dn in r.data_node_infos]
            disks = [d for dn in dns for d in dn.disk_infos.values()]
            return dict(volume_servers=len(dns),
                        volumes=sum(len(d.volume_infos) for d in disks),
                        ec_shards=sum(bin(e.shard_bits).count("1") for d in disks
                                      for e in d.ec_shard_infos))

        with open(os.path.join(mdir, "cluster.id")) as f:
            cluster_id = f.read().strip()
        seen_report: dict = {}

        def reported() -> bool:
            want = master_counts()
            status, body = pool.request(f"127.0.0.1:{tport}", "GET", "/api/instances")
            check(status == 200, f"collector /api/instances: {status} {body[:200]!r}")
            inst = json.loads(body)["instances"]
            check(len(inst) == 1 and inst[0]["cluster_id"] == cluster_id,
                  f"collector instances {inst}; cluster.id in -mdir {cluster_id!r}")
            seen_report.update(inst[0], want=want)
            return all(inst[0][k] == v for k, v in want.items())

        _poll(reported, "the collector to hold the master's counts", 3 * ADMIN_TELEMETRY_S)
        walls["census_to_collector"] = time.perf_counter() - t_census
        status, body = pool.request(f"127.0.0.1:{tport}", "GET", "/api/stats")
        tstats = json.loads(body)
        since_master = time.perf_counter() - t_master
        check(status == 200 and tstats["clusters"] == 1
              and tstats["reports_received"] >= since_master / (2 * ADMIN_TELEMETRY_S),
              f"collector /api/stats {tstats} after {since_master:.1f}s of the master: the "
              f"environment's {ADMIN_TELEMETRY_S}s interval is not in force")
        rec["telemetry"] = dict(counts=seen_report["want"], cluster_id=cluster_id,
                                census_to_collector_s=walls["census_to_collector"],
                                reports=tstats["reports_received"], master_s=since_master,
                                launches=sum(k1.values()) + k1_rebuild)
        print(f"admin: collector (cli telemetry on 127.0.0.1:{tport}) holds the master's counts "
              f"{seen_report['want']} after the EC_ENCODE and EC_REBUILD, "
              f"{walls['census_to_collector']:.3f}s after the master's census settled (interval "
              f"{ADMIN_TELEMETRY_S}s from WEEDTPU_MASTER_TELEMETRYINTERVAL over the file's "
              f"{ADMIN_TELEMETRY_FILE_S}s; {tstats['reports_received']} reports in "
              f"{since_master:.1f}s); cluster_id {cluster_id} = -mdir's cluster.id; the phase's "
              f"K1 launches {sum(k1.values()) + k1_rebuild} = encode "
              f"{sum(k1.values())} + rebuild {k1_rebuild}")

        # 6. the admin API
        status, _body = pool.request(aaddr, "GET", "/status")
        check(status == 401, f"/status without credentials: {status}")
        status, hdrs, body = pool.request_meta(aaddr, "POST", "/login", body=json.dumps(
            {"username": "admin", "password": ADMIN_PASSWORD}).encode())
        check(status == 200, f"login: {status} {body[:200]!r}")
        cookie = {"Cookie": {k.lower(): v for k, v in hdrs.items()}["set-cookie"].split(";")[0]}
        status, body = pool.request(aaddr, "GET", "/status", headers=cookie)
        check(status == 200, f"/status with the session: {status}")
        counts = json.loads(body)["tasks"]
        per_kind: dict = {}
        for t_ in tasks():
            per_kind.setdefault(t_["kind"], {}).setdefault(t_["state"], 0)
            per_kind[t_["kind"]][t_["state"]] += 1
        check(set(counts) == {"completed"} and counts["completed"] == sum(
            n for s in per_kind.values() for n in s.values()), f"/status tasks {counts}")
        check(per_kind.get("ec_encode") == {"completed": 2}
              and per_kind.get("ec_rebuild") == {"completed": len(degraded)}
              and set(per_kind.get("vacuum", {})) == {"completed"}
              and set(per_kind) == {"ec_encode", "ec_rebuild", "vacuum"},
              f"tasks per kind {per_kind}")
        status, body = pool.request(aaddr, "GET", "/", headers=cookie)
        check(status == 200 and b"Maintenance tasks" in body, f"the dashboard: {status}")
        status, body = pool.request(aaddr, "POST", "/config", headers=cookie,
                                    body=json.dumps({"vacuum_garbage_ratio": 0.35}).encode())
        check(status == 200, f"policy edit: {status} {body[:200]!r}")
        rcs["admin_1"] = admin.stop()
        t = time.perf_counter()
        admin = start_admin()
        walls["admin_restart"] = time.perf_counter() - t
        status, body = pool.request(aaddr, "GET", "/config", headers=basic)
        check(status == 200 and json.loads(body)["policy"]["vacuum_garbage_ratio"] == 0.35,
              f"the policy after the restart: {status} {body[:300]!r}")
        rec["tasks"] = per_kind
        rec["cuda_contexts"].append(cuda_contexts())
        print(f"admin: API on {ident}: /status 401 without credentials, 200 after a login; "
              f"tasks {per_kind}, 0 failed; dashboard 200; vacuum_garbage_ratio 0.35 kept across "
              f"a restart of cli admin ({walls['admin_restart']:.3f}s); after every task, no "
              f"CUDA context in the admin or the workers: {rec['cuda_contexts'][1]['plane']}; TTL "
              f"expiry is held on the CPU only (tests/test_torch_admin.py)")
    finally:
        pool.close()
        for i, w in enumerate(workers):
            rcs[f"worker{i}"] = w.stop()
        if admin is not None:
            rcs["admin"] = admin.stop()
        rcs.update({getattr(s_, "url", s_.proc.pid): s_.stop() for s_ in servers})
        rcs["master"] = master.stop()
        rcs["telemetry"] = telemetry.stop()
    killed = [u for u, rc in rcs.items() if rc == -signal.SIGKILL]
    check(len(killed) == 1 and all(rc == 0 for u, rc in rcs.items() if u not in killed),
          f"admin phase processes exited {rcs}")
    walls["phase"] = time.perf_counter() - t_phase
    rec.update(walls=walls, launches=sum(k1.values()) + k1_rebuild,
               launches_encode=sum(k1.values()), launches_rebuild=k1_rebuild,
               rcs={str(k): v for k, v in rcs.items()})
    print("admin: " + json.dumps(rec, sort_keys=True, default=str))
    return rec


# -- phase 18 -----------------------------------------------------------------

SYNC_DIRS = 64
SYNC_SMALL_N = 256  # 1-64 KiB files over SYNC_DIRS directories (phase 13's class; 512 before phase 19)
SYNC_INLINE_N = 32  # of them at most 2 KiB: one in 8, inlined in their entries
SYNC_LARGE_N = 4  # 4-32 MiB files
SYNC_BIG_BYTES = 128 * MIB  # one file of 32 chunks at -maxMB 4 (256 MiB, phase 13's, before phase 19)
SYNC_OVERWRITES = 32  # 64 before phase 19
SYNC_DELETES = 32
SYNC_RENAMES = 8
SYNC_RM_DIR = 7  # /sync/d07: removed by fs.rm -r while the syncer runs
SYNC_LATENCY_N = 64  # small writes whose source ack -> visible-at-B delay is sampled
SYNC_RESUME_N = 64  # writes across which the syncer is SIGKILLed and restarted (128 before phase 19)
SYNC_KILL_AT = 24  # acknowledged writes of SYNC_RESUME_N before the SIGKILL (48 before phase 19)
SYNC_REMOTE_N = 64  # 1-64 KiB objects of the remote, plus one of SYNC_REMOTE_BIG
SYNC_REMOTE_BIG = 64 * MIB
SYNC_REMOTE_ADDED = 8  # objects added to the remote before remote.meta.sync
SYNC_SAMPLE = 64  # files read back after the source filer's restart
SYNC_WAIT_S = 180.0  # every wait for the syncer, a process or the notifier


def _sync_files(seed: int) -> list:
    """[(path, size, key)] of the fill: the big file, the large ones and
    the small ones (SYNC_INLINE_N of them inline), sizes from ``seed``."""
    import numpy as np

    rng = np.random.default_rng([seed, 18])
    files = [("/sync/big/one.bin", SYNC_BIG_BYTES, 0)]
    for i in range(SYNC_LARGE_N):
        files.append((f"/sync/large/l{i:02d}.bin", int(rng.integers(4 * MIB, 32 * MIB + 1)), 1 + i))
    sizes = np.concatenate([rng.integers(1024, 2049, SYNC_INLINE_N),
                            rng.integers(2049, 64 * 1024 + 1, SYNC_SMALL_N - SYNC_INLINE_N)])
    rng.shuffle(sizes)
    for i, size in enumerate(sizes):
        files.append((f"/sync/d{i % SYNC_DIRS:02d}/f{i:05d}.bin", int(size), 100 + i))
    return files


def _sync_tree(pool, faddr: str, root: str) -> dict:
    """{path: size} of every file under ``root``, from a filer's paged JSON
    listings."""
    out: dict = {}
    stack = [root]
    while stack:
        d, last = stack.pop(), ""
        while True:
            status, body = pool.request(faddr, "GET", f"{urllib.parse.quote(d)}?limit=1000"
                                                      f"&lastFileName={urllib.parse.quote(last)}")
            if status == 404:
                break
            check(status == 200, f"listing {d} on {faddr}: {status}")
            doc = json.loads(body)
            for e in doc["Entries"]:
                if e["IsDirectory"]:
                    stack.append(e["FullPath"])
                else:
                    out[e["FullPath"]] = e["FileSize"]
            if not doc["ShouldDisplayLoadMore"]:
                break
            last = doc["LastFileName"]
    return out


class _Syncer:
    """``cli filer.sync`` in a subprocess (its lines and errors to ``log``)."""

    def __init__(self, argv: list, log: str):
        root = os.path.dirname(os.path.abspath(__file__))
        self.log = log
        self._log = open(log, "a")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get(
            "PYTHONPATH")])))
        self.proc = subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch.cli", *argv],
                                     cwd=root, env=env, stdout=self._log, stderr=self._log)
        _Server.live.add(self)

    def log_text(self) -> str:
        if not self._log.closed:
            self._log.flush()
        with open(self.log) as f:
            return f.read()

    def kill(self) -> int:
        self.proc.send_signal(signal.SIGKILL)
        return self.proc.wait()

    def stop(self) -> int:
        """SIGINT: the command's own stop (rc 0)."""
        _Server.live.discard(self)
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()
        return self.proc.returncode


def phase_sync(args, directory: str, ident: str, dev) -> dict:
    """Phase 18: replication, notification and remote storage.  Cluster A:
    ``cli master -volumeSizeLimitMB 256``, two ``cli volume`` (the default
    device, the card) and ``cli filer -db redis://... -notify log:...
    -metaLogDir`` on fixed ports; cluster B: phase 13's shape (a master and
    four ``cli volume -device cuda`` on two racks), ``cli filer -db
    etcd://...`` and ``cli s3 -filer B`` with one SigV4 identity.  The
    Redis and etcd servers are tests/mini_redis.py and tests/mini_etcd.py
    hosted in this process (neither machine has one); the stores' clients
    run for real.  ``fs.configure`` puts /sync/ in collection syncdata and
    16 writers fill it in phase 13's classes; ``cli filer.sync`` replays
    the history into B (every path size- and sha256-equal), follows 32
    overwrites, 32 deletes, 8 renames and an ``fs.rm -r`` (the ack ->
    visible-at-B delay of 64 writes printed), is SIGKILLed in the middle of
    64 writes and resumes on its checkpoint (B equals A again); A's
    filer restarts on its store and lists and reads the same, and the
    syncer follows it; the ``-notify`` log holds exactly the events
    ``cli filer.meta.tail`` prints, in order; ``cli filer.backup -sink
    s3://...`` copies /sync into bucket backup through B's gateway (it
    runs beside the notify check, the remote.* commands and the encode,
    and is checked last); the
    remote.* commands mount a local-dir remote on B, pick up new objects,
    cache them (MB/s), uncache one and unmount; and ``ec.encode -collection
    syncdata`` on B launches K1 once per stripe batch in B's servers, one
    volume's 14 shards equal the plain torch version's, and every synced
    file reads back from the shards.  Its figures go on ``sync:`` lines."""
    import numpy as np

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
    from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.util.http_pool import HttpConnectionPool

    tests_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    import mini_etcd
    from mini_redis import MiniRedisServer

    class _EtcdHttpd(mini_etcd.ThreadingHTTPServer):
        # a real etcd listens with the kernel's backlog; the double's stdlib
        # default of 5 drops connects (a 1 s SYN retry) under 16 readers, each
        # read a few etcd calls on fresh connections
        request_queue_size = 128

    mini_etcd.ThreadingHTTPServer = _EtcdHttpd
    MiniEtcdServer = mini_etcd.MiniEtcdServer

    seed = args.seed
    root = os.path.join(directory, "sync")
    a_dirs = [os.path.join(root, f"a{i}") for i in range(2)]
    b_dirs = [os.path.join(root, f"b{i}") for i in range(4)]
    remote_dir = os.path.join(root, "remote")
    for d in a_dirs + b_dirs + [remote_dir]:
        os.makedirs(d)
    log = os.path.join(root, "shell.log")
    events_log = os.path.join(root, "events.jsonl")
    ckpt = os.path.join(root, "sync.ckpt")
    walls: dict = {}
    rec: dict = {}
    procs: dict = {}
    t_phase = time.perf_counter()
    t_wall0 = time.time()
    pool = HttpConnectionPool(timeout=120.0, max_per_host=64)
    redis, etcd = MiniRedisServer().start(), MiniEtcdServer().start()
    files = _sync_files(seed)
    want: dict = {}  # path -> sha256 of what A holds
    sizes: dict = {}
    a_filer_ports = _free_ports(2)
    syncer = backup_proc = None
    try:
        t = time.perf_counter()
        procs["a_master"] = _Server("", "", os.path.join(root, "a_master.log"), argv=[
            "master", "-port", "0", "-volumeSizeLimitMB", str(FILER_VOLUME_MB)])
        procs["b_master"] = _Server("", "", os.path.join(root, "b_master.log"), argv=[
            "master", "-port", "0", "-volumeSizeLimitMB", str(FILER_VOLUME_MB)])
        a_m = f"127.0.0.1:{procs['a_master'].grpc_port}"
        b_m = f"127.0.0.1:{procs['b_master'].grpc_port}"
        a_dev = [] if dev.type == "cuda" else ["-device", dev.type]  # A: the default device
        a_servers = [_Server(d, dev.type, os.path.join(root, f"a_v{i}.log"), wait=False, argv=[
            "volume", "-dir", d, "-ip", "127.0.0.1", "-port", "0", "-grpcPort", "0",
            "-metricsPort", "0", *a_dev, "-mserver", a_m, "-scrubInterval", "0",
            "-scrubRateMB", "0"]) for i, d in enumerate(a_dirs)]
        b_servers = [_Server(d, dev.type, os.path.join(root, f"b_v{i}.log"), wait=False, argv=[
            "volume", "-dir", d, "-ip", "127.0.0.1", "-port", "0", "-grpcPort", "0",
            "-metricsPort", "0", "-device", dev.type, "-mserver", b_m, "-rack", f"r{i % 2}",
            "-scrubInterval", "0", "-scrubRateMB", "0"]) for i, d in enumerate(b_dirs)]
        for i, s_ in enumerate(a_servers + b_servers):
            procs[f"v{i}"] = s_

        def start_a_filer(logname: str, wait: bool = True):
            f = _Server("", "", os.path.join(root, logname), wait=wait, argv=[
                "filer", "-master", a_m, "-port", str(a_filer_ports[0]), "-grpcPort",
                str(a_filer_ports[1]), "-db", f"redis://127.0.0.1:{redis.port}/1", "-maxMB",
                str(FILER_CHUNK_MB), "-notify", f"log:{events_log}", "-metaLogDir",
                os.path.join(root, "a_metalog")])
            f.faddr = f"127.0.0.1:{a_filer_ports[0]}"
            f.gaddr = f"127.0.0.1:{a_filer_ports[1]}"
            return f

        # the filers need only their masters: they start beside the volume servers
        procs["a_filer"] = a_filer = start_a_filer("a_filer.log", wait=False)
        procs["b_filer"] = b_filer = _Server("", "", os.path.join(root, "b_filer.log"),
                                             wait=False, argv=[
            "filer", "-master", b_m, "-port", "0", "-db", f"etcd://127.0.0.1:{etcd.port}",
            "-maxMB", str(FILER_CHUNK_MB)])
        for s_ in a_servers + b_servers:
            s_.ready()
            s_.url = f"127.0.0.1:{s_.http_port}"
        a_filer.ready()
        b_filer.ready()
        b_filer.faddr, b_filer.gaddr = (f"127.0.0.1:{b_filer.http_port}",
                                        f"127.0.0.1:{b_filer.grpc_port}")
        gw = procs["s3"] = _Server("", "", os.path.join(root, "s3.log"), wait=False, argv=[
            "s3", "-master", b_m, "-filer", b_filer.gaddr, "-port", "0", "-accessKey", S3_AK,
            "-secretKey", S3_SK])
        line = gw.proc.stdout.readline().strip()
        m = re.search(r"s3 gateway on (127\.0\.0\.1:\d+) \(auth=sigv4\)", line)
        check(m is not None, f"cli s3 did not start: {line!r}: {gw.log_text()[-2000:]}")
        gw.addr = m[1]
        walls["servers_up"] = time.perf_counter() - t

        def nodes(maddr: str) -> set:
            topo = rpc.master_stub(maddr).VolumeList(m_pb.VolumeListRequest(),
                                                     timeout=60).topology_info
            return {dn.id for dc in topo.data_center_infos for r in dc.rack_infos
                    for dn in r.data_node_infos}

        _poll(lambda: nodes(a_m) == {s_.url for s_ in a_servers}, "A's two nodes", 60)
        _poll(lambda: nodes(b_m) == {s_.url for s_ in b_servers}, "B's four nodes", 60)
        print(f"sync: A = master {a_m}, volume servers {[s_.url for s_ in a_servers]}, filer "
              f"{a_filer.faddr} (gRPC {a_filer.gaddr}, redis://127.0.0.1:{redis.port}/1, -notify "
              f"log); B = master {b_m}, volume servers {[s_.url for s_ in b_servers]}, filer "
              f"{b_filer.faddr} (gRPC {b_filer.gaddr}, etcd://127.0.0.1:{etcd.port}), s3 "
              f"{gw.addr}; the stores' servers are tests/mini_redis.py and tests/mini_etcd.py in "
              f"this process; up in {walls['servers_up']:.3f}s on {ident}")

        def put(conn, f):
            sha, dt = _filer_put(conn, seed, *f)
            return sha, dt

        def write(items, writers: int = FILER_WRITERS) -> list:
            got = _filer_pool(a_filer.faddr, items, put, writers)
            for f, (sha, _dt) in zip(items, got):
                want[f[0]], sizes[f[0]] = sha, f[1]
            return got

        n_sentinel = [0]

        def sentinel(label: str) -> float:
            """A marker written to A last: the syncer applies events in
            order, so once B has it, B has everything A acknowledged
            before it.  Returns the seconds until B had it."""
            n_sentinel[0] += 1
            path = f"/sync/marker/{n_sentinel[0]:02d}.bin"
            conn = _filer_conn(a_filer.faddr)
            want[path], _dt = _filer_put(conn, seed, path, 100, 90_000 + n_sentinel[0])
            conn.close()
            sizes[path] = 100
            return _poll(lambda: pool.request(b_filer.faddr, "GET", path)[0] == 200,
                         f"the syncer to bring {path} ({label}) to B", SYNC_WAIT_S)

        def converged(label: str) -> dict:
            """B's /sync equals A's (paths and sizes) and equals what was
            written (every file's sha256)."""
            tree_a = _sync_tree(pool, a_filer.faddr, "/sync")
            tree_b = _sync_tree(pool, b_filer.faddr, "/sync")
            check(tree_a == tree_b == sizes,
                  f"{label}: A holds {len(tree_a)} files, B {len(tree_b)}, {len(sizes)} written; "
                  f"first differences {sorted(set(tree_a.items()) ^ set(tree_b.items()))[:4]}")
            items = [(p, s_, 0) for p, s_ in sorted(sizes.items())]
            return _filer_read_all(b_filer.faddr, items, want, f"B {label}", tag="sync")

        # 1. fill A
        _w, out = _shell(a_m, "fs.configure -locationPrefix /sync/ -collection syncdata "
                              "-replication 000 -apply", log, filer=a_filer.gaddr)
        check('"collection": "syncdata"' in out, f"fs.configure: {out!r}")
        time.sleep(1.1)  # the filer's conf cache lives one second
        t = time.perf_counter()
        conn = _filer_conn(a_filer.faddr)
        sha, dt = _filer_put(conn, seed, *files[0])
        conn.close()
        want[files[0][0]], sizes[files[0][0]] = sha, files[0][1]
        fill = {"big": _class_figures("big", [files[0][1]], [dt], time.perf_counter() - t)}
        for cls, items in (("large", files[1:1 + SYNC_LARGE_N]),
                           ("small", files[1 + SYNC_LARGE_N:])):
            t = time.perf_counter()
            got = write(items)
            fill[cls] = _class_figures(cls, [f[1] for f in items], [g[1] for g in got],
                                       time.perf_counter() - t)
        rec["fill"] = fill
        print(f"sync: fill of A on {ident}: " + "; ".join(
            f"{cls} {r['files']} files {r['files_per_s']:.1f}/s {r['mb_per_s']:.1f} MB/s p50 "
            f"{r['p50_ms']:.2f} ms p99 {r['p99_ms']:.2f} ms" for cls, r in fill.items())
            + f"; {len(files)} files, {sum(f[1] for f in files)} bytes")

        # 2. filer.sync replays the history into B
        sync_argv = ["filer.sync", "-fromFiler", a_filer.gaddr, "-fromMaster", a_m, "-toFiler",
                     b_filer.gaddr, "-fromPath", "/sync", "-toPath", "/sync", "-checkpoint", ckpt]
        t = time.perf_counter()
        syncer = _Syncer(sync_argv, os.path.join(root, "sync.1.log"))
        sentinel("the history")
        walls["history"] = time.perf_counter() - t
        rec["read_history"] = converged("after the history")
        print(f"sync: cli filer.sync replayed the history ({len(files)} files, "
              f"{sum(f[1] for f in files)} bytes) into B in {walls['history']:.3f}s (process start "
              f"included): every path size- and sha256-equal")

        # 3. mutations while the syncer runs; the ack -> visible delay
        rng = np.random.default_rng([seed, 1801])
        small = [f for f in files if f[0].startswith("/sync/d")
                 and not f[0].startswith(f"/sync/d{SYNC_RM_DIR:02d}/")]
        picks = rng.choice(len(small), SYNC_OVERWRITES + SYNC_DELETES + SYNC_RENAMES,
                           replace=False)
        over = [small[i] for i in picks[:SYNC_OVERWRITES]]
        dels = [small[i] for i in picks[SYNC_OVERWRITES:SYNC_OVERWRITES + SYNC_DELETES]]
        moves = [small[i] for i in picks[SYNC_OVERWRITES + SYNC_DELETES:]]
        t = time.perf_counter()
        write([(p, int(rng.integers(1024, 64 * 1024 + 1)), 50_000 + k) for p, _s, k in over])
        for p, _s, _k in dels:
            status, _b = pool.request(a_filer.faddr, "DELETE", p)
            check(status in (200, 202, 204), f"DELETE {p} on A: {status}")
            want.pop(p), sizes.pop(p)
        fstub = rpc.filer_stub(a_filer.gaddr)
        renamed = []
        for p, _s, _k in moves:
            d, name = p.rsplit("/", 1)
            resp = fstub.AtomicRenameEntry(f_pb.AtomicRenameEntryRequest(
                old_directory=d, old_name=name, new_directory="/sync/moved", new_name=name))
            check(not resp.error, f"rename {p}: {resp.error}")
            q = f"/sync/moved/{name}"
            want[q], sizes[q] = want.pop(p), sizes.pop(p)
            renamed.append((p, q))
        rm_dir = f"/sync/d{SYNC_RM_DIR:02d}"
        _w, _out = _shell(a_m, f"fs.rm -r {rm_dir}", log, filer=a_filer.gaddr)
        gone = [p for p in sizes if p.startswith(rm_dir + "/")]
        for p in gone:
            want.pop(p), sizes.pop(p)
        delays = []
        conn = _filer_conn(a_filer.faddr)
        for i in range(SYNC_LATENCY_N):
            path, size = f"/sync/latency/f{i:03d}.bin", int(rng.integers(1024, 64 * 1024 + 1))
            want[path], _dt = _filer_put(conn, seed, path, size, 60_000 + i)
            sizes[path] = size
            t_ack = time.perf_counter()
            while pool.request(b_filer.faddr, "HEAD", path)[0] != 200:
                check(time.perf_counter() - t_ack < SYNC_WAIT_S, f"{path} never reached B")
                time.sleep(0.002)
            delays.append(time.perf_counter() - t_ack)
        conn.close()
        sentinel("the mutations")
        walls["mutations"] = time.perf_counter() - t
        for p, _s, _k in dels:
            check(pool.request(b_filer.faddr, "GET", p)[0] == 404, f"deleted {p} is on B")
        for p, q in renamed:
            check(pool.request(b_filer.faddr, "GET", p)[0] == 404, f"renamed {p} is on B")
        for p in gone:
            check(pool.request(b_filer.faddr, "GET", p)[0] == 404, f"{p} of {rm_dir} is on B")
        d_ms = np.array(delays) * 1e3
        rec["delay_ms"] = dict(p50=float(np.percentile(d_ms, 50)),
                               p99=float(np.percentile(d_ms, 99)), max=float(d_ms.max()))
        changed = [(p, sizes[p], 0) for p in sorted(sizes)
                   if p.startswith(("/sync/moved/", "/sync/latency/"))
                   or p in {f[0] for f in over}]
        tree_b = _sync_tree(pool, b_filer.faddr, "/sync")
        check(tree_b == _sync_tree(pool, a_filer.faddr, "/sync") == sizes,
              f"after the mutations B holds {len(tree_b)} files, {len(sizes)} written")
        rec["read_mutations"] = _filer_read_all(b_filer.faddr, changed, want,
                                                "B's changed files after the mutations", tag="sync")
        print(f"sync: {SYNC_OVERWRITES} overwrites, {SYNC_DELETES} deletes, {SYNC_RENAMES} "
              f"renames and fs.rm -r {rm_dir} ({len(gone)} files) followed in "
              f"{walls['mutations']:.3f}s: deleted paths 404 on B; source ack -> visible at B of "
              f"{SYNC_LATENCY_N} small writes p50 {rec['delay_ms']['p50']:.2f} ms p99 "
              f"{rec['delay_ms']['p99']:.2f} ms (max {rec['delay_ms']['max']:.2f})")

        # 4. SIGKILL the syncer in the middle of 64 writes; resume on the checkpoint
        resume = [(f"/sync/resume/d{i % 8}/f{i:03d}.bin", int(rng.integers(1024, 64 * 1024 + 1)),
                   70_000 + i) for i in range(SYNC_RESUME_N)]
        acked = [0]
        killed = threading.Event()

        def put_counted(conn, f):
            out = _filer_put(conn, seed, *f)
            acked[0] += 1
            if acked[0] >= SYNC_KILL_AT:  # the rest wait for the kill: it lands mid-stream
                killed.wait(SYNC_WAIT_S)
            return out

        t = time.perf_counter()
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(_filer_pool, a_filer.faddr, resume, put_counted, 4)
            try:
                _poll(lambda: acked[0] >= SYNC_KILL_AT, f"{SYNC_KILL_AT} acked writes",
                      SYNC_WAIT_S)
                rc_kill = syncer.kill()
                _Server.live.discard(syncer)
                acked_at_kill = acked[0]
            finally:
                killed.set()
            got = fut.result()
        for f, (sha, _dt) in zip(resume, got):
            want[f[0]], sizes[f[0]] = sha, f[1]
        check(rc_kill == -signal.SIGKILL, f"the syncer exited {rc_kill} on SIGKILL")
        with open(ckpt) as fh:
            ckpt_ts = int(fh.read())
        # the events after the checkpoint, and how many of them B already has:
        # those the new process applies again
        pending = []
        stream = rpc.filer_stub(a_filer.gaddr).SubscribeMetadata(f_pb.SubscribeMetadataRequest(
            client_name="chip_smoke", path_prefix="/sync", since_ts_ns=ckpt_ts), timeout=3)
        try:
            for ev in stream:
                pending.append(ev)
        except Exception as e:  # noqa: BLE001 — the deadline ends the pass
            check("DEADLINE_EXCEEDED" in str(e), f"reading A's events: {e}")
        again = 0
        for ev in pending:
            path = f"{ev.directory}/{ev.new_entry.name}" if ev.new_entry.name else ""
            if not path or pool.request(b_filer.faddr, "GET", path)[0] != 200:
                break
            again += 1
        syncer = _Syncer(sync_argv, os.path.join(root, "sync.2.log"))
        sentinel("the resume")
        walls["resume"] = time.perf_counter() - t
        rec["resume"] = dict(acked_at_kill=acked_at_kill, pending=len(pending), applied_again=again)
        rec["read_resume"] = converged("after the resume")
        print(f"sync: SIGKILL of cli filer.sync after {acked_at_kill} of {SYNC_RESUME_N} writes; "
              f"restarted on its checkpoint: {len(pending)} events after it, {again} of them "
              f"already at B (applied again); B converged to A in {walls['resume']:.3f}s: "
              f"{len(sizes)} files, the same paths, sizes and sha256s")

        # 5. A's filer restarts on the same redis://
        before = {d: pool.request(a_filer.faddr, "GET", f"/sync/d{d:02d}?limit=1000")[1]
                  for d in range(SYNC_DIRS) if d != SYNC_RM_DIR}
        check(a_filer.stop() == 0, "A's filer did not stop cleanly")
        t = time.perf_counter()
        procs["a_filer"] = a_filer = start_a_filer("a_filer.restart.log")
        walls["a_restart"] = time.perf_counter() - t
        after = {d: pool.request(a_filer.faddr, "GET", f"/sync/d{d:02d}?limit=1000")[1]
                 for d in before}
        check(after == before, "A's listings differ after its filer's restart")
        paths = sorted(sizes)
        sample = [(paths[i], sizes[paths[i]], 0)
                  for i in np.random.default_rng([seed, 1805]).choice(len(paths), SYNC_SAMPLE,
                                                                      replace=False)]
        _filer_read_all(a_filer.faddr, sample, want, "A after its restart (a sample)", tag="sync")
        walls["follow_restart"] = sentinel("after A's restart")
        print(f"sync: A's filer restarted on redis:// in {walls['a_restart']:.3f}s: {len(before)} "
              f"listings byte-identical, {SYNC_SAMPLE} sampled files equal; the syncer followed "
              f"it ({walls['follow_restart']:.3f}s to the next write at B)")

        # 7 (started here, checked after 9). filer.backup to S3 through B's
        # gateway: it reads only A and writes only bucket backup, so it runs
        # beside steps 6, 8 and 9, which read A's log and work on B's /rmt and
        # syncdata
        root_dir = os.path.dirname(os.path.abspath(__file__))
        client = _S3Client(gw.addr)
        status, body, _h, _dt = client.request("PUT", "/backup")
        client.close()
        check(status == 200, f"creating bucket backup: {status} {body[:200]!r}")
        backup: dict = {}
        t_backup = time.perf_counter()
        backup_proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "filer.backup", "-filer",
             a_filer.gaddr, "-master", a_m, "-path", "/sync", "-sink",
             f"s3://{S3_AK}:{S3_SK}@{gw.addr}/backup", "-once"], cwd=root_dir,
            env=dict(os.environ, PYTHONPATH=root_dir), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

        def wait_backup() -> None:
            backup["out"], backup["err"] = backup_proc.communicate()
            backup["wall"] = time.perf_counter() - t_backup

        backup_thread = threading.Thread(target=wait_backup, daemon=True)
        backup_thread.start()

        # 6. the -notify log against cli filer.meta.tail
        def notified() -> list:
            with open(events_log) as fh:
                lines = [json.loads(x) for x in fh]
            return [d["ts_ns"] for d in lines if d["directory"] == "/sync"
                    or d["directory"].startswith("/sync/")]

        t = time.perf_counter()
        since = int(time.time() - t_wall0) + 5
        tail_out: list = []
        tail_proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "filer.meta.tail", "-filer",
             a_filer.gaddr, "-path", "/sync", "-sinceSeconds", str(since)], cwd=root_dir,
            env=dict(os.environ, PYTHONPATH=root_dir), stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL)
        import select

        # the pipe is read with os.read, never readline: a buffered reader
        # keeps lines that select() no longer sees, and the count came short
        tail_fd = tail_proc.stdout.fileno()
        pending = b""

        def take(chunk: bytes) -> None:
            nonlocal pending
            *lines, pending = (pending + chunk).split(b"\n")
            tail_out.extend(json.loads(x)["ts_ns"] for x in lines)

        expected = len(notified())  # A is idle: its pump has drained by now
        try:  # it follows the stream forever: read until every event and 1 s of quiet
            last_line = time.perf_counter()
            while time.perf_counter() - last_line < (1.0 if len(tail_out) >= expected else 3.0):
                check(time.perf_counter() - t < SYNC_WAIT_S, "filer.meta.tail never went quiet")
                if select.select([tail_fd], [], [], 0.5)[0]:
                    chunk = os.read(tail_fd, 1 << 16)
                    if not chunk:
                        break
                    take(chunk)
                    last_line = time.perf_counter()
        finally:
            tail_proc.send_signal(signal.SIGINT)
            try:
                tail_proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                tail_proc.kill()
                tail_proc.wait()
            while chunk := os.read(tail_fd, 1 << 16):  # what it printed before the SIGINT
                take(chunk)
            tail_proc.stdout.close()
        _poll(lambda: len(notified()) >= len(tail_out), "the notify log to catch up", 30)
        logged = notified()
        walls["meta_tail"] = time.perf_counter() - t
        check(logged == tail_out and logged == sorted(logged) and len(logged) > len(files),
              f"the notify log holds {len(logged)} /sync events, filer.meta.tail printed "
              f"{len(tail_out)}; equal {logged == tail_out}, ordered {logged == sorted(logged)}")
        rec["notify_events"] = len(logged)
        print(f"sync: the -notify log holds {len(logged)} /sync events, one ordered JSON line "
              f"each; cli filer.meta.tail -sinceSeconds {since} printed the same {len(tail_out)} "
              f"timestamps in {walls['meta_tail']:.3f}s")

        # 8. remote storage on B
        rrng = np.random.default_rng([seed, 1808])
        objs = {f"o/{i % 4}/r{i:03d}.bin": rrng.bytes(int(rrng.integers(1024, 64 * 1024 + 1)))
                for i in range(SYNC_REMOTE_N)}
        objs["big/r.bin"] = b"".join(_filer_blocks(seed, 80_000, SYNC_REMOTE_BIG))

        def put_objects(items: dict) -> None:
            for k, data in items.items():
                p = os.path.join(remote_dir, k)
                os.makedirs(os.path.dirname(p), exist_ok=True)
                with open(p, "wb") as fh:
                    fh.write(data)

        put_objects(objs)
        rshell = f"-filer {b_filer.gaddr} -dir /rmt"
        walls["remote_mount"], out = _shell(
            b_m, f"remote.mount {rshell} -remote local:{remote_dir}", log)
        check(out.strip() == f"mounted local:{remote_dir} at /rmt: {len(objs)} entries synced",
              f"remote.mount: {out!r}")
        check(set(_sync_tree(pool, b_filer.faddr, "/rmt")) == {"/rmt/" + k for k in objs},
              "the mounted listing differs from the remote's")
        added = {f"o/new/n{i}.bin": rrng.bytes(int(rrng.integers(1024, 64 * 1024 + 1)))
                 for i in range(SYNC_REMOTE_ADDED)}
        put_objects(added)
        objs.update(added)
        walls["remote_meta_sync"], out = _shell(b_m, f"remote.meta.sync {rshell}", log)
        check(out.strip() == f"synced {SYNC_REMOTE_ADDED} new entries into /rmt",
              f"remote.meta.sync: {out!r}")
        check(set(_sync_tree(pool, b_filer.faddr, "/rmt")) == {"/rmt/" + k for k in objs},
              "the listing after remote.meta.sync differs from the remote's")
        total = sum(len(v) for v in objs.values())
        walls["remote_cache"], out = _shell(b_m, f"remote.cache {rshell}", log)
        check(out.strip() == f"cached {len(objs)} files ({total} bytes) under /rmt",
              f"remote.cache: {out!r}")
        for k, data in objs.items():
            status, body = pool.request(b_filer.faddr, "GET", "/rmt/" + k)
            check(status == 200 and body == data, f"GET /rmt/{k} after remote.cache: {status}")
        one = "o/0/r000.bin"
        _w, out = _shell(b_m, f"remote.uncache {rshell} -path /rmt/{one}; "
                              f"remote.unmount {rshell}", log)
        check(out.splitlines() == [f"/rmt/{one}: chunks dropped",
                                   f"unmounted /rmt: 1 placeholders dropped, "
                                   f"{len(objs) - 1} local/cached entries kept"],
              f"remote.uncache, remote.unmount: {out!r}")
        bstub = rpc.filer_stub(b_filer.gaddr)
        mount_entry = bstub.LookupDirectoryEntry(f_pb.LookupDirectoryEntryRequest(
            directory="/", name="rmt")).entry
        gone_one = bstub.LookupDirectoryEntry(f_pb.LookupDirectoryEntryRequest(
            directory="/rmt/o/0", name="r000.bin"))
        check("remote.mount" not in mount_entry.extended and bool(gone_one.error),
              f"after remote.unmount: mount marker {dict(mount_entry.extended)}, the uncached "
              f"placeholder {gone_one.error or 'still there'}")
        rec["remote"] = dict(objects=len(objs), bytes=total,
                             cache_mb_per_s=total / walls["remote_cache"] / 1e6)
        print(f"sync: remote.mount of a local-dir remote ({SYNC_REMOTE_N} objects of 1-64 KiB and "
              f"one of {SYNC_REMOTE_BIG // MIB} MiB) on B {walls['remote_mount']:.3f}s, the "
              f"listing equal; remote.meta.sync picked up {SYNC_REMOTE_ADDED} new objects; "
              f"remote.cache pulled {len(objs)} objects ({total} bytes) into B's volumes in "
              f"{walls['remote_cache']:.3f}s ({rec['remote']['cache_mb_per_s']:.1f} MB/s, the "
              f"shell's process start included), every read equal; remote.uncache and "
              f"remote.unmount printed the JAX shell's lines")

        # 9. ec.encode -collection syncdata on B: K1 in B's servers
        vols: dict = {}
        for d in b_dirs:
            for n in os.listdir(d):
                mm = re.fullmatch(r"syncdata_(\d+)\.dat", n)
                if mm:
                    vols[int(mm[1])] = os.path.join(d, n)
        check(len(vols) > 0, "B holds no syncdata volume")
        sampled = max(vols, key=lambda v: os.path.getsize(vols[v]))
        ref_dir = os.path.join(root, "ref")
        os.makedirs(ref_dir)
        ref = os.path.join(ref_dir, f"syncdata_{sampled}")
        os.link(vols[sampled], ref + ".dat")
        tasks = sum(len(ec_encoder._plan_tasks(DEFAULT_SCHEME, os.path.getsize(p),
                                               ec_encoder.DEFAULT_CHUNK)) for p in vols.values())
        k1_before = {s_.url: metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply")
                     for s_ in b_servers}
        check(not any(k1_before.values()), f"K1 launched on B before the encode: {k1_before}")
        syncer_rc = syncer.stop()
        syncer = None
        check(syncer_rc == 0, f"cli filer.sync stopped with rc {syncer_rc}")
        walls["ec_encode"], _out = _shell(
            b_m, "lock; ec.encode -collection syncdata -fullPercent 0 -quietFor 0; unlock", log)
        bm_stub = rpc.master_stub(b_m)
        by_grpc = {f"127.0.0.1:{s_.grpc_port}": d for s_, d in zip(b_servers, b_dirs)}
        for vid in vols:
            _poll(lambda: _ec_census(bm_stub, vid)["holders"] == _disk_shards(by_grpc,
                                                                            f"syncdata_{vid}"),
                  f"B's EC census of {vid} to match the disks", 60)
        k1 = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply"))
              for s_ in b_servers}
        check(sum(k1.values()) == tasks and tasks > 0,
              f"K1 launches by B's servers {k1}; the generates of {len(vols)} volumes have {tasks} "
              f"batches")
        t = time.perf_counter()
        ec_encoder.write_ec_files(ref, codec=ReedSolomonTorch(10, 4, device=dev))
        shards = {sid: os.path.join(by_grpc[a], f"syncdata_{sampled}.ec{sid:02d}")
                  for a, sids in _disk_shards(by_grpc, f"syncdata_{sampled}").items()
                  for sid in sids}
        check(sorted(shards) == list(range(14)), f"volume {sampled}'s shards: {sorted(shards)}")
        for sid, p in shards.items():
            check(sha256(p) == sha256(ref + f".ec{sid:02d}"),
                  f"volume {sampled} shard {sid} differs from the plain torch version's")
        walls["plain_reference"] = time.perf_counter() - t
        rec["read_ec"] = converged("from EC shards")
        print(f"sync: ec.encode -collection syncdata on B {walls['ec_encode']:.3f}s on {ident}: "
              f"{len(vols)} volumes, K1 launches by server {k1} (= {tasks} batches); volume "
              f"{sampled}'s 14 shards sha256-equal to ReedSolomonTorch's on the card "
              f"({walls['plain_reference']:.3f}s); every synced file reads back from the shards")

        # 7. the backup, started before step 6
        backup_thread.join(timeout=max(1.0, SYNC_WAIT_S - (time.perf_counter() - t_backup)))
        check("wall" in backup, f"cli filer.backup passed {SYNC_WAIT_S}s")
        walls["backup"] = backup["wall"]
        with open(os.path.join(root, "backup.log"), "w") as fh:
            fh.write(backup["out"] + backup["err"])
        check(backup_proc.returncode == 0 and backup["out"].rstrip().endswith(", 0 errors"),
              f"cli filer.backup exited {backup_proc.returncode}: {backup['out'][-400:]} "
              f"{backup['err'][-2000:]}")
        client = _S3Client(gw.addr)
        listed, _pages = _s3_list(client, "backup")
        client.close()
        keys = {p[len("/sync/"):]: s_ for p, s_ in sizes.items()}
        check({k: v[0] for k, v in listed.items()} == keys,
              f"bucket backup holds {len(listed)} objects, /sync {len(keys)} files")

        def s3_get(client, key):
            status, (sha, n), _h, dt = client.request("GET", f"/backup/{key}", sink=True)
            check(status == 200 and n == keys[key] and sha == want["/sync/" + key],
                  f"GET backup/{key}: {status}, {n} bytes")
            return dt

        t2 = time.perf_counter()
        _s3_pool(gw.addr, sorted(keys), s3_get)
        walls["backup_read"] = time.perf_counter() - t2
        print(f"sync: cli filer.backup -sink s3://.../backup -once in {walls['backup']:.3f}s "
              f"beside steps 6, 8 and 9 ({backup['out'].strip()}); ListObjectsV2 names exactly "
              f"the {len(keys)} files of /sync; every object sha256-equal by a signed GET through "
              f"B's gateway ({walls['backup_read']:.3f}s)")
    finally:
        pool.close()
        if syncer is not None:
            syncer.stop()
        if backup_proc is not None and backup_proc.poll() is None:
            backup_proc.kill()
            backup_proc.wait()
        rcs = {name: p.stop() for name, p in procs.items()}
        redis.stop()
        etcd.stop()
    check(all(rc == 0 for rc in rcs.values()), f"sync phase processes exited {rcs}")
    walls["phase"] = time.perf_counter() - t_phase
    rec.update(walls=walls, launches=tasks, volumes=len(vols), files=len(sizes))
    print("sync: " + json.dumps(rec, sort_keys=True))
    return rec


GW_DIRS = 16
GW_SMALL_N = 128  # 1-64 KiB files over GW_DIRS directories, one in 8 inline (phase 13's class)
GW_LARGE_N = 2  # 4-32 MiB files
GW_BIG_BYTES = 128 * MIB  # one file, as phases 14-15's big object
GW_WRITERS = 16
GW_MOUNT_FILES = 4  # files written through WeedFS at random offsets
GW_MOUNT_WRITES = 24  # writes of 1 B-1 MiB into each, overlapping, over 12 MiB
GW_DELAY_N = 8  # WebDAV overwrites whose mount-visible delay is sampled
GW_CACHE_TTL_S = 5.0  # WeedFS's metadata cache TTL, the JAX default
GW_MQ_PARTITIONS = 4
GW_MQ_KEYS = 64
GW_MQ_N = 768  # records of GW_MQ_SIZE over GW_MQ_KEYS keys: every partition past one segment
GW_MQ_SIZE = 64 * 1024
GW_MQ_PUBLISHERS = 8
GW_OWNER_LOSS_N = 256  # records published across the owner broker's SIGKILL
GW_OWNER_LOSS_SIZE = 4096
GW_OWNER_KILL_AT = 64  # acknowledged records of GW_OWNER_LOSS_N before the SIGKILL
GW_SAMPLE = 16  # small files (and one large) read through the mount and WebDAV while degraded
GW_WAIT_S = 120.0  # every wait for a process, the notifier or the queue


def _timed(fn) -> tuple:
    """(fn(), its seconds)."""
    t0 = time.perf_counter()
    return fn(), time.perf_counter() - t0


def _gw_files(seed: int) -> list:
    """[(path, size, key)]: the big file, the large ones and the small ones
    (one in 8 at most 2 KiB, inlined in their entries)."""
    import numpy as np

    rng = np.random.default_rng([seed, 19])
    files = [("/gw/big/one.bin", GW_BIG_BYTES, 0)]
    for i in range(GW_LARGE_N):
        files.append((f"/gw/large/l{i:02d}.bin", int(rng.integers(4 * MIB, 32 * MIB + 1)), 1 + i))
    n_inline = GW_SMALL_N // 8
    sizes = np.concatenate([rng.integers(1024, 2049, n_inline),
                            rng.integers(2049, 64 * 1024 + 1, GW_SMALL_N - n_inline)])
    rng.shuffle(sizes)
    for i, size in enumerate(sizes):
        files.append((f"/gw/d{i % GW_DIRS:02d}/f{i:05d}.bin", int(size), 100 + i))
    return files


def _dav_put(conn, seed: int, path: str, size: int, key: int) -> tuple:
    """PUT one file streamed from its blocks; (sha256, seconds)."""
    sha = hashlib.sha256()

    def body():
        for piece in _filer_blocks(seed, key, size):
            sha.update(piece)
            yield piece

    t0 = time.perf_counter()
    conn.request("PUT", path, body=body(), headers={"Content-Length": str(size),
                                                    "Content-Type": "application/octet-stream"})
    resp = conn.getresponse()
    reply = resp.read()
    dt = time.perf_counter() - t0
    check(resp.status in (201, 204), f"WebDAV PUT {path}: {resp.status} {reply[:200]!r}")
    return sha.hexdigest(), dt


def _propfind_sizes(addr: str, path: str) -> dict:
    """{href: getcontentlength} of a PROPFIND at depth 1 (files only)."""
    import xml.etree.ElementTree as ET

    status, _h, body = _plain_http(addr, "PROPFIND", path, headers={"Depth": "1"})
    check(status == 207, f"PROPFIND {path}: {status}")
    out = {}
    for r in ET.fromstring(body).findall("{DAV:}response"):
        length = r.find(".//{DAV:}getcontentlength")
        if length is not None:
            out[r.find("{DAV:}href").text] = int(length.text)
    return out


def _mount_write_script(fs, seed: int) -> dict:
    """Writes at random offsets with overlaps, a flush between them, a
    truncate to 0 and a rename across directories through WeedFS; returns
    {path: the numpy model's bytes}."""
    import numpy as np

    rng = np.random.default_rng([seed, 1902])
    model: dict = {}
    fs.mkdir("/mnt")
    fs.mkdir("/mnt/sub")
    for i in range(GW_MOUNT_FILES):
        path = f"/mnt/m{i}.bin"
        buf = bytearray()
        fh = fs.create(path)
        for w in range(GW_MOUNT_WRITES):
            off = int(rng.integers(0, 12 * MIB))
            data = rng.bytes(int(rng.integers(1, MIB + 1)))
            check(fs.write(fh, off, data) == len(data), f"mount write {path}@{off}")
            if len(buf) < off + len(data):
                buf.extend(b"\0" * (off + len(data) - len(buf)))
            buf[off:off + len(data)] = data
            if w == GW_MOUNT_WRITES // 2:
                fs.flush(fh)  # half the writes committed, the rest buffered over them
        fs.release(fh)
        model[path] = buf
    fs.truncate("/mnt/m0.bin", 0)
    fh = fs.open("/mnt/m0.bin")
    data = rng.bytes(3 * MIB)
    fs.write(fh, 100, data)
    fs.release(fh)
    model["/mnt/m0.bin"] = bytearray(100) + data
    fs.rename("/mnt/m1.bin", "/mnt/sub/m1.bin")
    model["/mnt/sub/m1.bin"] = model.pop("/mnt/m1.bin")
    return {p: bytes(b) for p, b in model.items()}


def _mount_read(fs, path: str) -> bytes:
    fh = fs.open(path)
    try:
        return fs.read(fh, 0, fs.getattr(path)["size"])
    finally:
        fs.release(fh)


def phase_gateways(args, directory: str, ident: str, dev) -> dict:
    """Phase 19: the file gateways and the message queue.  Phase 13's
    cluster (``cli master -volumeSizeLimitMB 256``, four ``cli volume
    -device cuda`` on two racks, ``cli filer -db <lsm dir> -maxMB 4``) with
    ``-notify mq://<broker>/filer-events``, two ``cli mq.broker -master
    -filer`` at the JAX default ``-replication 2`` started before the
    filer, and ``cli webdav``.  WebDAV: MKCOL, PUT of phase 13's classes
    (128 files of 1-64 KiB over 16 directories, 16 inline; 2 of 4-32 MiB;
    one of 128 MiB) by 16 writers, PROPFIND depth 1 sizes, every GET
    sha256-equal, a Range read, MOVE of a directory, COPY, DELETE then 404.
    The mount (``WeedFS`` in this process: ``cli mount`` refuses without
    FUSE): random-offset overlapping writes, a truncate and a rename equal
    a numpy model; a file crosses mount -> WebDAV and WebDAV -> mount; the
    delay from a WebDAV overwrite until the mount reads it stays under the
    cache TTL.  The queue: ``mq.topic.configure`` of 4 partitions, ``cli
    mq.benchmark`` at its defaults, 768 records of 64 KiB over 64 keys
    (every partition past one 8 MiB segment), ``mq.topic.compact`` and
    ``SealSegments(evict)``: every partition's archive in the filer's
    /topics (collection mqtier), none left on its owner's disk.
    ``ec.encode`` of the default and mqtier collections launches K1 once
    per batch in the servers, one volume's 14 shards equal the plain torch
    version's; a shard holder is SIGKILLed and a two-member
    ``GroupConsumer`` reads every record once, in order, equal, the
    archives read back from degraded EC shards.  The filer-events topic
    holds exactly the filer's events (SubscribeMetadata from 0, stamp
    order).  The owner broker of a partition is SIGKILLed while 256 more
    records are published: every acknowledged record reads back and the
    offsets continue; meanwhile mount and WebDAV reads of a sample stay
    sha256-equal, degraded.  Its figures go on ``gateways:`` lines."""
    import numpy as np

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.mount import WeedFS
    from seaweedfs_tpu_torch.mq import GroupConsumer, MqClient
    from seaweedfs_tpu_torch.mq.agent import MqError
    from seaweedfs_tpu_torch.mq.balancer import hash_key_to_partition, partition_owner
    from seaweedfs_tpu_torch.mq.tier import FilerSegmentTier
    from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
    from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb
    from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
    from seaweedfs_tpu_torch.pb import mq_pb2
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME

    import grpc

    seed = args.seed
    root = os.path.join(directory, "gateways")
    dirs = [os.path.join(root, f"v{i}") for i in range(4)]
    bdirs = [os.path.join(root, f"broker{i}") for i in range(2)]
    for d in dirs + bdirs:
        os.makedirs(d)
    log = os.path.join(root, "shell.log")
    root_dir = os.path.dirname(os.path.abspath(__file__))
    walls: dict = {}
    rec: dict = {}
    procs: dict = {}
    brokers: dict = {}  # advertise -> _Server
    fs = side = bench = compact = ref_side = group = None
    killed: set = set()
    t_phase = time.perf_counter()
    files = _gw_files(seed)
    want: dict = {}  # path -> sha256 of what was written
    sizes: dict = {p: s for p, s, _k in files}
    fport, gport, *bports = _free_ports(4)
    faddr, gaddr = f"127.0.0.1:{fport}", f"127.0.0.1:{gport}"

    def first_line(p, pattern: str, what: str) -> re.Match:
        line = _readline_within(p.proc, GW_WAIT_S).strip()
        m = re.search(pattern, line)
        check(m is not None, f"{what} did not start: {line!r}: {p.log_text()[-2000:]}")
        print(f"server subprocess pid {p.proc.pid}: {line}")
        return m

    try:
        # the cluster: the master, then every other process at once (the brokers
        # first, on fixed ports the filer's -notify names); the benchmark starts
        # as soon as both brokers are registered and runs beside steps 1-4
        t = time.perf_counter()
        procs["master"] = master = _Server("", "", os.path.join(root, "master.log"), argv=[
            "master", "-port", "0", "-volumeSizeLimitMB", str(FILER_VOLUME_MB)])
        maddr = f"127.0.0.1:{master.grpc_port}"
        mhttp = f"127.0.0.1:{master.http_port}"
        for i, (d, port) in enumerate(zip(bdirs, bports)):
            b = procs[f"broker{i}"] = _Server("", "", os.path.join(root, f"broker{i}.log"),
                                              wait=False, argv=[
                "mq.broker", "-dir", d, "-master", mhttp, "-port", str(port), "-filer", faddr])
            b.dir, b.is_broker, b.addr = d, True, f"127.0.0.1:{port}"
            brokers[b.addr] = b
        b0 = procs["broker0"].addr
        servers = [_Server(d, dev.type, os.path.join(root, f"v{i}.log"), wait=False, argv=[
            "volume", "-dir", d, "-ip", "127.0.0.1", "-port", "0", "-grpcPort", "0",
            "-metricsPort", "0", "-device", dev.type, "-mserver", maddr, "-rack", f"r{i % 2}",
            "-scrubInterval", "0", "-scrubRateMB", "0"]) for i, d in enumerate(dirs)]
        for i, s_ in enumerate(servers):
            procs[f"v{i}"] = s_
        procs["filer"] = filer = _Server("", "", os.path.join(root, "filer.log"), wait=False, argv=[
            "filer", "-master", maddr, "-port", str(fport), "-grpcPort", str(gport), "-db",
            os.path.join(root, "db"), "-maxMB", str(FILER_CHUNK_MB), "-notify",
            f"mq://{b0}/filer-events"])
        procs["webdav"] = dav = _Server("", "", os.path.join(root, "webdav.log"), wait=False,
                                        argv=["webdav", "-filer", gaddr, "-master", maddr,
                                              "-port", "0"])
        for b in brokers.values():
            check(first_line(b, r"mq broker on (127\.0\.0\.1:\d+) \(data ", "cli mq.broker")[1]
                  == b.addr, f"cli mq.broker did not bind {b.addr}")

        def registered() -> set:
            got = _http_json(mhttp, "/cluster/nodes?type=broker")
            return {n["address"] for n in got[1]["nodes"]} if got and got[0] == 200 else set()

        _poll(lambda: registered() == set(brokers), "both brokers at the master", GW_WAIT_S)
        bench = _Beside(lambda: _timed(lambda: subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "mq.benchmark", "-broker", b0],
            cwd=root_dir, capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=root_dir),
            timeout=GW_WAIT_S)))  # at its defaults
        for s_ in servers:
            s_.ready()
            s_.url = f"127.0.0.1:{s_.http_port}"
        filer.ready()
        dav.addr = first_line(dav, r"webdav on (127\.0\.0\.1:\d+) \(root /\)", "cli webdav")[1]
        walls["servers_up"] = time.perf_counter() - t
        mstub = rpc.master_stub(maddr)

        def nodes() -> set:
            topo = mstub.VolumeList(m_pb.VolumeListRequest(), timeout=60).topology_info
            return {dn.id for dc in topo.data_center_infos for r in dc.rack_infos
                    for dn in r.data_node_infos}

        _poll(lambda: nodes() == {s_.url for s_ in servers}, "the four nodes", 60)
        print(f"gateways: master {maddr}, volume servers {[s_.url for s_ in servers]}, brokers "
              f"{sorted(brokers)} (-replication 2, -filer {faddr}), filer {faddr} (gRPC {gaddr}, "
              f"-notify mq://{b0}/filer-events), webdav {dav.addr}; up in "
              f"{walls['servers_up']:.3f}s on {ident}")
        # the tier's collection and the topic, beside the WebDAV step
        side = _Beside(lambda: _shell(
            maddr, "fs.configure -locationPrefix /topics/ -collection mqtier -replication 000 "
                   f"-apply; mq.topic.configure -topic events -partitionCount {GW_MQ_PARTITIONS}",
            log, filer=gaddr))

        # 1. WebDAV
        t = time.perf_counter()
        for d in ["/gw", "/gw/big", "/gw/large"] + [f"/gw/d{i:02d}" for i in range(GW_DIRS)]:
            status, _h, _b = _plain_http(dav.addr, "MKCOL", d)
            check(status == 201, f"MKCOL {d}: {status}")
        walls["mkcol"] = time.perf_counter() - t
        fill: dict = {}
        for cls, items in (("big", files[:1]), ("large", files[1:1 + GW_LARGE_N]),
                           ("small", files[1 + GW_LARGE_N:])):
            t = time.perf_counter()
            got = _filer_pool(dav.addr, items, lambda conn, f: _dav_put(conn, seed, *f),
                              GW_WRITERS)
            for f, (sha, _dt) in zip(items, got):
                want[f[0]] = sha
            fill[cls] = _class_figures(cls, [f[1] for f in items], [g[1] for g in got],
                                       time.perf_counter() - t)
        rec["fill"] = fill
        print("gateways: WebDAV PUT by 16 writers: " + "; ".join(
            f"{cls} {r['files']} files {r['files_per_s']:.1f}/s {r['mb_per_s']:.1f} MB/s p50 "
            f"{r['p50_ms']:.2f} ms p99 {r['p99_ms']:.2f} ms" for cls, r in fill.items()))
        side.result()  # /topics/ in mqtier, the topic configured
        side = None

        # 3. the queue (the benchmark runs beside steps 1-3)
        keys: list = []
        per: dict = {p: 0 for p in range(GW_MQ_PARTITIONS)}
        for i in range(100_000):
            k = b"key-%05d" % i
            p = hash_key_to_partition(k, GW_MQ_PARTITIONS)
            if per[p] < GW_MQ_KEYS // GW_MQ_PARTITIONS:
                per[p] += 1
                keys.append(k)
            if len(keys) == GW_MQ_KEYS:
                break
        values = [np.random.default_rng([seed, 1904, i]).bytes(GW_MQ_SIZE) for i in range(GW_MQ_N)]
        published: dict = {}  # (partition, offset) -> (key, value)
        plock = threading.Lock()

        def publisher(j: int) -> None:
            c = MqClient(b0)
            for i in range(j, GW_MQ_N, GW_MQ_PUBLISHERS):
                k = keys[i % GW_MQ_KEYS]
                p, off = c.publish("events", k, values[i])
                with plock:
                    published[(p, off)] = (k, values[i])

        t = time.perf_counter()
        pubs = [_Beside(lambda j=j: publisher(j)) for j in range(GW_MQ_PUBLISHERS)]
        for b in pubs:
            b.result(GW_WAIT_S)
        walls["mq_publish"] = time.perf_counter() - t
        check(len(published) == GW_MQ_N, f"{len(published)} of {GW_MQ_N} records acknowledged")
        nexts = {p: 1 + max(o for q, o in published if q == p) for p in range(GW_MQ_PARTITIONS)}
        check(all(nexts[p] == sum(1 for q, _o in published if q == p) for p in nexts),
              f"the acknowledged offsets have holes: {nexts}")
        rec["mq_publish"] = dict(records_per_s=GW_MQ_N / walls["mq_publish"],
                                 mb_per_s=GW_MQ_N * GW_MQ_SIZE / walls["mq_publish"] / 1e6)
        segs = {p: sum(1 for n in os.listdir(os.path.join(bdirs[0], "default", "events",
                                                          f"p{p:04d}")) if n.endswith(".log"))
                for p in range(GW_MQ_PARTITIONS)}
        check(all(n >= 2 for n in segs.values()), f"segments per partition on broker0: {segs}")
        print(f"gateways: {GW_MQ_N} x 64 KiB over {GW_MQ_KEYS} keys by {GW_MQ_PUBLISHERS} "
              f"publishers: {rec['mq_publish']['records_per_s']:.1f} records/s, "
              f"{rec['mq_publish']['mb_per_s']:.1f} MB/s acknowledged at -replication 2; "
              f"partitions' next offsets {nexts}, segments on broker0 {segs}")
        compact = _Beside(lambda: _shell(maddr, "lock; mq.topic.compact; unlock", log))

        # 1, continued beside the compaction: listings, reads, Range, MOVE, COPY, DELETE
        t = time.perf_counter()
        listed: dict = {}
        for d in ["/gw/big", "/gw/large"] + [f"/gw/d{i:02d}" for i in range(GW_DIRS)]:
            listed.update(_propfind_sizes(dav.addr, d))
        check(listed == sizes, f"PROPFIND depth 1 lists {len(listed)} files, {len(sizes)} written; "
                               f"first differences {sorted(set(listed.items()) ^ set(sizes.items()))[:4]}")
        walls["propfind"] = time.perf_counter() - t
        rec["read"] = _filer_read_all(dav.addr, files, want, "through WebDAV", tag="gateways")
        big = files[0]
        lo, hi = big[1] * 37 // 128 + 11, big[1] * 101 // 128 + 7
        status, _h, body = _plain_http(dav.addr, "GET", big[0],
                                       headers={"Range": f"bytes={lo}-{hi}"})
        check(status == 206 and body == b"".join(_filer_blocks(seed, big[2], big[1], lo, hi + 1)),
              f"WebDAV Range GET of {big[0]}: {status}, {len(body)} bytes")
        moved = [f for f in files if f[0].startswith("/gw/d15/")]
        status, _h, _b = _plain_http(dav.addr, "MOVE", "/gw/d15",
                          headers={"Destination": f"http://{dav.addr}/gw/moved15"})
        check(status == 201, f"MOVE /gw/d15: {status}")
        for f in moved:
            new = f[0].replace("/gw/d15/", "/gw/moved15/")
            want[new], sizes[new] = want.pop(f[0]), sizes.pop(f[0])
        one = moved[0][0].replace("/gw/d15/", "/gw/moved15/")
        status, _h, body = _plain_http(dav.addr, "GET", one)
        check(status == 200 and hashlib.sha256(body).hexdigest() == want[one],
              f"GET {one} after the MOVE: {status}")
        check(_plain_http(dav.addr, "GET", moved[0][0])[0] == 404,
              "the moved path still answers")
        large = files[1]
        status, _h, _b = _plain_http(dav.addr, "COPY", large[0],
                          headers={"Destination": f"http://{dav.addr}/gw/copy.bin"})
        check(status == 201, f"COPY {large[0]}: {status}")
        status, _h, body = _plain_http(dav.addr, "GET", "/gw/copy.bin")
        check(status == 200 and hashlib.sha256(body).hexdigest() == want[large[0]],
              f"GET of the COPY: {status}")
        check(_plain_http(dav.addr, "DELETE", "/gw/copy.bin")[0] == 204, "DELETE /gw/copy.bin")
        check(_plain_http(dav.addr, "GET", "/gw/copy.bin")[0] == 404, "GET after DELETE answers")
        print(f"gateways: PROPFIND depth 1 lists every file with its size ({walls['propfind']:.3f}s); "
              f"Range GET of {hi - lo + 1} bytes of the big file equal; MOVE of a directory of "
              f"{len(moved)} files, COPY of a {large[1]}-byte file, DELETE then 404")
        # 2. the mount, in this process, beside the compaction
        t = time.perf_counter()
        fs = WeedFS(gaddr, maddr, chunk_size=FILER_CHUNK_MB * MIB, cache_ttl=GW_CACHE_TTL_S)
        model = _mount_write_script(fs, seed)
        walls["mount_write"] = time.perf_counter() - t
        for path, data in model.items():
            check(_mount_read(fs, path) == data, f"mount read of {path} differs from the model")
            check(fs.getattr(path)["size"] == len(data), f"mount getattr of {path}")
            want[path], sizes[path] = hashlib.sha256(data).hexdigest(), len(data)
        status, _h, body = _plain_http(dav.addr, "GET", "/mnt/sub/m1.bin")
        check(status == 200 and body == model["/mnt/sub/m1.bin"],
              "a file written through the mount differs through WebDAV")
        drng = np.random.default_rng([seed, 1903])
        data = drng.bytes(6 * MIB)
        check(_plain_http(dav.addr, "PUT", "/mnt/from-dav.bin", data)[0] == 201,
              "WebDAV PUT into /mnt")
        check(_mount_read(fs, "/mnt/from-dav.bin") == data,
              "a file written through WebDAV differs through the mount")
        delays, stale = [], 0
        for i in range(GW_DELAY_N):
            data = drng.bytes(MIB)
            check(_plain_http(dav.addr, "PUT", "/mnt/from-dav.bin", data)[0] == 204,
                  "WebDAV overwrite")
            t0 = time.perf_counter()
            while True:
                try:
                    if _mount_read(fs, "/mnt/from-dav.bin") == data:
                        break
                except OSError:
                    stale += 1  # the cached entry named the overwritten chunks
                check(time.perf_counter() - t0 < GW_CACHE_TTL_S,
                      f"overwrite {i}: the mount still reads the old bytes after "
                      f"{GW_CACHE_TTL_S}s")
                time.sleep(0.005)
            delays.append((time.perf_counter() - t0) * 1e3)
        want["/mnt/from-dav.bin"], sizes["/mnt/from-dav.bin"] = hashlib.sha256(data).hexdigest(), MIB
        walls["mount"] = time.perf_counter() - t
        rec["mount_delay_ms"] = dict(p50=float(np.percentile(delays, 50)), max=max(delays),
                                     stale_reads=stale)
        print(f"gateways: mount: {GW_MOUNT_FILES} files of {GW_MOUNT_WRITES} random overlapping "
              f"writes, a truncate and a rename equal the numpy model "
              f"({walls['mount_write']:.3f}s); mount -> WebDAV and WebDAV -> mount equal; "
              f"WebDAV overwrite -> mount reads it: p50 {rec['mount_delay_ms']['p50']:.2f} ms, "
              f"max {rec['mount_delay_ms']['max']:.2f} ms over {GW_DELAY_N} (TTL "
              f"{GW_CACHE_TTL_S:.0f} s; {stale} reads of the old entry failed on its chunks)")
        fs.close()
        fs = None

        walls["compact"], out = compact.result(GW_WAIT_S)
        compact = None
        check(re.search(r"^(\d+) messages moved", out, re.M) is not None
              and int(re.search(r"^(\d+) messages moved", out, re.M)[1]) > 0,
              f"mq.topic.compact: {out!r}")
        evicted = {a: rpc.make_stub(a, mq_pb2, "MqBroker").SealSegments(
            mq_pb2.SealSegmentsRequest(evict=True), timeout=GW_WAIT_S).sealed_count
            for a in sorted(brokers)}
        tier = FilerSegmentTier(faddr)
        owners = {p: partition_owner(sorted(brokers), "default", "events", p)
                  for p in range(GW_MQ_PARTITIONS)}
        archives = {}
        for p in range(GW_MQ_PARTITIONS):
            listed_p = tier.list(f"default/events/p{p:04d}")
            archives[p] = sorted(n for n in listed_p if n.endswith(".npz"))
            check(archives[p], f"partition {p} has no archive in the filer's /topics")
            local = os.listdir(os.path.join(brokers[owners[p]].dir, "default", "events",
                                            f"p{p:04d}"))
            check(not [n for n in local if n.endswith(".npz")],
                  f"partition {p}'s owner {owners[p]} kept its archive after the eviction")
        print(f"gateways: mq.topic.compact {walls['compact']:.3f}s beside the mount "
              f"({out.strip().splitlines()[-1]}); "
              f"SealSegments(evict) {evicted}: every partition's archive in the filer "
              f"{ {p: a for p, a in archives.items()} }, none on its owner's disk")

        # 4. ec.encode of the gateways' and the tier's collections: K1
        vols: dict = {}
        for d in dirs:
            for n in os.listdir(d):
                mm = re.fullmatch(r"(?:(mqtier)_)?(\d+)\.dat", n)
                if mm:
                    vols[(mm[1] or "", int(mm[2]))] = os.path.join(d, n)
        check({c for c, _v in vols} == {"", "mqtier"}, f"collections on disk: {sorted(vols)}")
        sampled = max((k for k in vols if k[0] == ""), key=lambda k: os.path.getsize(vols[k]))
        ref = os.path.join(root, "ref", str(sampled[1]))
        os.makedirs(os.path.dirname(ref))
        os.link(vols[sampled], ref + ".dat")
        tasks = sum(len(ec_encoder._plan_tasks(DEFAULT_SCHEME, os.path.getsize(p),
                                               ec_encoder.DEFAULT_CHUNK)) for p in vols.values())
        k1_before = {s_.url: metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply")
                     for s_ in servers}
        check(not any(k1_before.values()), f"K1 launched before the encode: {k1_before}")
        walls["ec_encode"], _out = _shell(
            maddr, "lock; ec.encode -fullPercent 0 -quietFor 0; ec.encode -collection mqtier "
                   "-fullPercent 0 -quietFor 0; unlock", log)
        by_grpc = {f"127.0.0.1:{s_.grpc_port}": d for s_, d in zip(servers, dirs)}
        for (coll, vid) in vols:
            name = f"{coll}_{vid}" if coll else str(vid)
            _poll(lambda: _ec_census(mstub, vid)["holders"] == _disk_shards(by_grpc, name),
                  f"the EC census of {name} to match the disks", 60)
        k1 = {s_.url: int(metric(s_.metrics(), "weedtpu_cuda_kernel_launches", kernel="gf_apply"))
              for s_ in servers}
        check(sum(k1.values()) == tasks and tasks > 0,
              f"K1 launches by server {k1}; the generates of {len(vols)} volumes have {tasks} "
              f"batches")
        shards = {sid: os.path.join(by_grpc[a], f"{sampled[1]}.ec{sid:02d}")
                  for a, sids in _disk_shards(by_grpc, str(sampled[1])).items() for sid in sids}
        check(sorted(shards) == list(range(14)), f"volume {sampled[1]}'s shards: {sorted(shards)}")
        print(f"gateways: ec.encode of the default and mqtier collections {walls['ec_encode']:.3f}s "
              f"on {ident}: {len(vols)} volumes, K1 launches by server {k1} (= {tasks} batches)")

        def plain_reference() -> float:
            t0 = time.perf_counter()
            ec_encoder.write_ec_files(ref, codec=ReedSolomonTorch(10, 4, device=dev))
            for sid, p in shards.items():
                check(sha256(p) == sha256(ref + f".ec{sid:02d}"),
                      f"volume {sampled[1]} shard {sid} differs from the plain torch version's")
            return time.perf_counter() - t0

        # 6. the filer-events topic against SubscribeMetadata from 0
        t = time.perf_counter()
        meta: list = []
        stream = rpc.filer_stub(gaddr).SubscribeMetadata(
            f_pb.SubscribeMetadataRequest(client_name="smoke", path_prefix="/", since_ts_ns=0),
            timeout=1.0)
        try:
            for ev in stream:
                old = f"{ev.directory.rstrip('/')}/{ev.old_entry.name}" if ev.old_entry.name else None
                new_dir = ev.new_parent_path or ev.directory
                new = f"{new_dir.rstrip('/')}/{ev.new_entry.name}" if ev.new_entry.name else None
                meta.append((ev.ts_ns, ev.directory, old, new))
        except grpc.RpcError as e:
            check(e.code() == grpc.StatusCode.DEADLINE_EXCEEDED, f"SubscribeMetadata: {e.code()}")
        check(meta == sorted(meta), "SubscribeMetadata from 0 is out of stamp order")
        reader = MqClient(b0)

        def topic_events() -> list:
            return [json.loads(m.value) for m in reader.consume_all("filer-events")]

        _poll(lambda: len(topic_events()) >= len(meta), "the notifier to publish every event",
              GW_WAIT_S)
        evs = topic_events()
        look = reader.lookup("filer-events", refresh=True)
        for a in look.assignments:
            stamps = [json.loads(m.value)["ts_ns"]
                      for m in reader.subscribe_partition("filer-events", a.partition, 0)]
            check(stamps == sorted(stamps), f"filer-events partition {a.partition} out of order")
        from_topic = sorted((d["ts_ns"], d["directory"], d["old_path"], d["new_path"]) for d in evs)
        check(from_topic == meta and len(meta) > len(files),
              f"the filer-events topic holds {len(from_topic)} events, SubscribeMetadata from 0 "
              f"{len(meta)}; first differences {sorted(set(from_topic) ^ set(meta))[:3]}")
        walls["filer_events"] = time.perf_counter() - t
        rec["filer_events"] = len(meta)
        print(f"gateways: the filer-events topic ({look.partition_count} partitions keyed by "
              f"directory, each in stamp order) holds exactly the {len(meta)} events "
              f"SubscribeMetadata gives from 0 ({walls['filer_events']:.3f}s)")

        # the benchmark, beside steps 1-4 and 6, ends before a broker dies
        bench_run, walls["mq_benchmark"] = bench.result(GW_WAIT_S)
        bench = None
        with open(os.path.join(root, "mq_benchmark.log"), "w") as fh:
            fh.write(bench_run.stdout + bench_run.stderr)
        check(bench_run.returncode == 0, f"cli mq.benchmark exited {bench_run.returncode}: "
                                         f"{bench_run.stderr[-2000:]}")
        reports = [json.loads(x) for x in bench_run.stdout.splitlines() if x.startswith("{")]
        check([(r["phase"], r["requests"], r["errors"]) for r in reports]
              == [("publish", 5000, 0), ("consume", 5000, 0)], f"cli mq.benchmark: {reports}")
        rec["mq_benchmark"] = {r["phase"]: {k: r[k] for k in ("req_per_sec", "p50_ms", "p99_ms")}
                               for r in reports}
        print(f"gateways: cli mq.benchmark (5,000 x 1 KiB, -c 8, 4 partitions) beside steps 1-4 and 6: "
              f"publish {rec['mq_benchmark']['publish']['req_per_sec']:.1f}/s p99 "
              f"{rec['mq_benchmark']['publish']['p99_ms']:.2f} ms, consume "
              f"{rec['mq_benchmark']['consume']['req_per_sec']:.1f}/s ({walls['mq_benchmark']:.3f}s "
              f"with its start)")

        # 5. the owner broker of partition 0 dies while 256 more records go in;
        # with it, the holder of most of the sampled volume's shards
        target = owners[0]
        survivor = next(a for a in brokers if a != target)
        victim = max(servers, key=lambda s_: len(
            _disk_shards({s_.url: dirs[servers.index(s_)]}, str(sampled[1])).get(s_.url, [])))
        acked: dict = {}
        failures = [0]
        reached = threading.Event()
        orng = np.random.default_rng([seed, 1905])
        more = [(keys[i % GW_MQ_KEYS], orng.bytes(GW_OWNER_LOSS_SIZE))
                for i in range(GW_OWNER_LOSS_N)]

        def publish_across() -> float:
            c = MqClient(survivor)
            t0 = time.perf_counter()
            for i, (k, v) in enumerate(more):
                while True:
                    check(time.perf_counter() - t0 < GW_WAIT_S, f"record {i} never acknowledged")
                    try:
                        acked[c.publish("events", k, v)] = (k, v)
                        break
                    except (MqError, grpc.RpcError):
                        failures[0] += 1
                        time.sleep(0.2)
                if len(acked) == GW_OWNER_KILL_AT:
                    reached.set()
            return time.perf_counter() - t0

        t = time.perf_counter()
        pub = _Beside(publish_across)
        check(reached.wait(GW_WAIT_S), "the publisher never reached the kill point")
        for p_ in (brokers[target], victim):
            p_.proc.send_signal(signal.SIGKILL)
            p_.proc.wait()
            killed.add(p_)
        ref_side = _Beside(plain_reference)  # this process, the card: beside the prune wait
        walls["prune_wait"] = _poll(lambda: victim.url not in nodes(),
                                    f"the master to prune {victim.url}", PRUNE_WAIT_S)
        print(f"gateways: SIGKILL of broker {target} (owner of partition 0) after "
              f"{GW_OWNER_KILL_AT} of {GW_OWNER_LOSS_N} acknowledged records, and of volume "
              f"server {victim.url} (most of volume {sampled[1]}'s shards), pruned after "
              f"{walls['prune_wait']:.3f}s")

        def degraded_reads() -> dict:
            """A sample through the mount and WebDAV, from degraded shards."""
            t0 = time.perf_counter()
            sample = [f[0] for f in files if f[1] <= 64 * 1024][:GW_SAMPLE] + [files[1][0]]
            sample = [p_ if p_ in want else p_.replace("/gw/d15/", "/gw/moved15/")
                      for p_ in sample]
            mfs = WeedFS(gaddr, maddr, chunk_size=FILER_CHUNK_MB * MIB, subscribe=False)
            try:
                for path in sample:
                    check(hashlib.sha256(_mount_read(mfs, path)).hexdigest() == want[path],
                          f"degraded mount read of {path}")
                    status, _h, body = _plain_http(dav.addr, "GET", path)
                    check(status == 200 and hashlib.sha256(body).hexdigest() == want[path],
                          f"degraded WebDAV read of {path}: {status}")
                for path, data in model.items():
                    check(_mount_read(mfs, path) == data, f"degraded mount read of {path}")
            finally:
                mfs.close()
            return dict(files=len(sample) + len(model), s=time.perf_counter() - t0)

        def group_read() -> tuple:
            """A two-member group reads every record from offset 0: (records
            per partition, the members' partitions, seconds).  It joins once
            the publisher is done: the dead broker has left every view."""
            pub.result(GW_WAIT_S)
            t0 = time.perf_counter()
            go = threading.Event()
            got: dict = {p: [] for p in range(GW_MQ_PARTITIONS)}
            glock = threading.Lock()

            def on_message(p: int, msg) -> None:
                if not go.is_set():
                    # until both members hold their share: not delivered, so the
                    # cursor stays and no generation sees a record twice
                    raise RuntimeError("the group is still forming")
                with glock:
                    got[p].append((msg.offset, msg.key, msg.value))

            members = [GroupConsumer(MqClient(survivor), "events", "smoke-readers", on_message,
                                     heartbeat_interval=0.5) for _ in range(2)]
            for c in members:
                c.start()
            try:
                _poll(lambda: members[0].generation == members[1].generation
                      and sorted(members[0].partitions + members[1].partitions)
                      == list(range(GW_MQ_PARTITIONS)) and all(c.partitions for c in members),
                      "the group's two members", GW_WAIT_S)
                go.set()
                want_n = GW_MQ_N + len(acked)
                _poll(lambda: sum(len(v) for v in got.values()) >= want_n,
                      "the group to read every record", GW_WAIT_S)
                time.sleep(0.5)  # a record read twice would land by now
            finally:
                for c in members:
                    c.stop()
            return got, [c.partitions for c in members], time.perf_counter() - t0

        group = _Beside(group_read)  # after the prune, beside the degraded reads
        rec["degraded"] = degraded_reads()
        walls["plain_reference"] = ref_side.result(GW_WAIT_S)
        ref_side = None
        print(f"gateways: mount and WebDAV reads of {rec['degraded']['files']} files sha256-equal "
              f"from degraded shards ({rec['degraded']['s']:.3f}s); volume {sampled[1]}'s 14 "
              f"shards sha256-equal to ReedSolomonTorch's on the card "
              f"({walls['plain_reference']:.3f}s, beside the prune wait); both beside the publisher")
        walls["owner_loss_publish"] = pub.result(GW_WAIT_S)
        walls["owner_loss"] = time.perf_counter() - t
        got, split, walls["group_read"] = group.result(GW_WAIT_S)
        group = None

        acks = {**published, **acked}
        extra = 0
        for p in range(GW_MQ_PARTITIONS):
            offs = [o for o, _k, _v in got[p]]
            check(offs == list(range(len(offs))),
                  f"partition {p}: the group read offsets {offs[:8]}... ({len(offs)}): a record "
                  f"twice, out of order, or a hole")
            for o, k, v in got[p]:
                if (p, o) in acks:
                    check(acks[(p, o)] == (k, v), f"partition {p} offset {o} differs")
                else:  # a publish retried after its append had landed
                    check((k, v) in more, f"partition {p} offset {o}: nobody published it")
                    extra += 1
        check(all(o < len(got[p]) for p, o in acks), "an acknowledged record was not read back")
        c = MqClient(survivor)
        p_after, o_after = c.publish("events", keys[0], b"after the owner loss")
        check(o_after == len(got[p_after]), f"the offsets did not resume: {o_after} after "
                                            f"{len(got[p_after])} records of partition {p_after}")
        rec["group_read"] = dict(records=sum(len(v) for v in got.values()), s=walls["group_read"],
                                 split=split)
        rec["owner_loss"] = dict(acked=len(acked), publish_failures=failures[0], duplicates=extra,
                                 wall_s=walls["owner_loss_publish"])
        print(f"gateways: {len(acked)} records acknowledged across the broker's SIGKILL in "
              f"{walls['owner_loss_publish']:.3f}s ({failures[0]} publish attempts failed and were "
              f"retried, {extra} stored twice); a two-member GroupConsumer on {survivor} "
              f"(partitions {rec['group_read']['split']}) read all "
              f"{rec['group_read']['records']} records once, in per-partition offset order, "
              f"every acknowledged one equal, in {walls['group_read']:.3f}s, the evicted archives "
              f"through the filer from degraded EC shards; the next offset {o_after} continues "
              f"partition {p_after}")
    finally:
        for b in (side, bench, compact, ref_side, group):
            if b is not None:
                b.wait()
        if fs is not None:
            fs.close()
        for p in procs.values():
            if getattr(p, "is_broker", False) and p.proc.poll() is None:
                p.proc.send_signal(signal.SIGINT)  # the broker's clean stop
                try:
                    p.proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    pass
        rcs = {name: p.stop() for name, p in procs.items()}
    bad = {name: rc for name, rc in rcs.items()
           if rc != 0 and not (procs[name] in killed and rc == -signal.SIGKILL)}
    check(not bad, f"gateway phase processes exited {rcs}")
    walls["phase"] = time.perf_counter() - t_phase
    rec.update(walls=walls, launches=tasks, volumes=len(vols), files=len(sizes))
    print("gateways: " + json.dumps(rec, sort_keys=True))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gib", type=float, default=1.0, help="volume size in GiB")
    args = ap.parse_args()

    use_bytecode_cache()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from seaweedfs_tpu_torch.ops import _build

    t_start = time.perf_counter()
    arm_deadline()
    progress("started; building the kernels and the host libraries")
    dev = torch.device("cuda", 0)
    ident = gpu_identity()
    print(f"device: {torch.cuda.get_device_name(0)} ({ident}), torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    built = _build.build_all()
    ptxas = {}
    for name, info in built.items():
        print(f"build: {name} in {info['seconds']:.3f}s -> {info['path']}")
        for k in ptxas_report(info["log"]):
            ptxas[k["kernel"]] = k
            print(f"  ptxas: {k['kernel']}: {k['registers']} registers, "
                  f"{k['spill_bytes']} bytes of spill stores and loads")
    table_kernels = [k for name, k in ptxas.items()
                     if name.startswith(("gf_apply_kernel", "planes_apply_kernel"))]
    if len(table_kernels) != 8 or any(k["spill_bytes"] for k in table_kernels):
        print(f"FAIL: ptxas should report 4 K1 and 4 K2 instantiations, none spilling: "
              f"{table_kernels}")
        return 1

    progress(f"built {len(built)} libraries")
    rates = card_rates()
    print(f"rates: {rates['sms']} SMs at clocks.max.sm {rates['clock_hz'] / 1e6:.0f} MHz: "
          f"{rates['logic_ops_per_s']:.6g} logic ops/s, {HBM_BYTES_PER_S:.6g} B/s of device memory")
    rng = np.random.default_rng(args.seed)
    try:
        kern = phase_kernel(rng, dev, rates)
        planes = phase_planes(rng, dev, rates, ident,
                              sorted({n for _off, n in shard_chunks(int(args.gib * (1 << 30)))}))
        progress("phases 1-2 passed: every kernel held against its plain version")
        main_path = phase_main_path(args, ident, dev, rates)
    except SmokeFailure as e:
        progress(f"FAIL: {e}"[:2000])
        print(f"FAIL: {e}")
        return 1
    t6, t64 = kern["timings"][6 * MIB], kern["timings"][64 * MIB]
    t_reb = kern["timings"]["rebuild_4loss"]
    pt, hop, lrc = planes["timings"], main_path["hop"], main_path["lrc"]
    lrc_hop = lrc["hop"]

    def timing_keys(t: dict, suffix: str) -> dict:
        return {f"ms_{suffix}": t["ms"], f"ms_graph_{suffix}": t["graph_ms"],
                f"plain_ms_{suffix}": t["plain_ms"], f"bound_ms_{suffix}": t["bound_ms"],
                f"bound_by_{suffix}": t["bound_by"]}

    def lrc_rebuild_gbs(mode: str, n_lost: int) -> float:
        return next(r["gbs"] for r in lrc["rebuilds"] if (r["mode"], len(r["lost"])) == (mode, n_lost))

    def registers(kernel: str) -> dict:
        return {name: k["registers"] for name, k in ptxas.items() if name.startswith(kernel)}

    def plane_entry(name: str, line: int, key: str, err: str, shape: str) -> dict:
        return {
            "name": name, "route": "cuda", "source": "seaweedfs_tpu_torch/csrc/gf_planes.cu",
            "replaces": f"seaweedfs_tpu/ops/rs_pallas.py:{line}",
            "launches": hop["launches"][name] + lrc_hop["launches"][name],
            "launches_rs_hop": hop["launches"][name], "launches_lrc_hop": lrc_hop["launches"][name],
            "max_abs_err": planes["errs"][err],
            "ms": pt[key]["ms"], "plain_ms": pt[key]["plain_ms"],
            "bound_ms": pt[key]["bound_ms"], "bound_by": pt[key]["bound_by"],
            "library_ms": None, "shape": shape,
        }

    record = {"kernels": [
        {
            "name": "gf_apply",
            "route": "cuda",
            "source": "seaweedfs_tpu_torch/csrc/gf_apply.cu",
            "replaces": "seaweedfs_tpu/ops/rs_pallas.py:52",
            "launches": main_path["launches"] + lrc["launches"],
            "launches_rs": main_path["launches"],
            "launches_lrc": lrc["launches"],
            "max_abs_err": kern["max_err"],
            "ms": t6["ms"],
            "plain_ms": t6["plain_ms"],
            "bound_ms": t6["bound_ms"],
            "bound_by": t6["bound_by"],
            "library_ms": None,
            "shape": "10x6MiB->4",
            "ms_graph": t6["graph_ms"],
            "ms_10x64MiB": t64["ms"],
            "ms_graph_10x64MiB": t64["graph_ms"],
            "plain_ms_10x64MiB": t64["plain_ms"],
            "bound_ms_10x64MiB": t64["bound_ms"],
            "bound_by_10x64MiB": t64["bound_by"],
            "ms_10x64MiB_rebuild_4loss": t_reb["ms"],
            "ms_graph_10x64MiB_rebuild_4loss": t_reb["graph_ms"],
            "plain_ms_10x64MiB_rebuild_4loss": t_reb["plain_ms"],
            "bound_ms_10x64MiB_rebuild_4loss": t_reb["bound_ms"],
            "bound_by_10x64MiB_rebuild_4loss": t_reb["bound_by"],
            "registers": registers("gf_apply_kernel"),
            "encode_gbs": main_path["encode_gbs"],
            "rebuild_gbs": main_path["rebuild_gbs"],
            **timing_keys(kern["timings"]["lrc_local_1loss"], "5x64MiB_to_1_lrc_local"),
            **timing_keys(kern["timings"]["lrc_local_2groups"], "10x64MiB_to_2_lrc_local"),
            "lrc_encode_gbs": lrc["encode_gbs"],
            "lrc_rebuild_local_gbs": lrc_rebuild_gbs("local", 1),
            "lrc_rebuild_local_2groups_gbs": lrc_rebuild_gbs("local", 2),
            "lrc_rebuild_global_gbs": lrc_rebuild_gbs("global", 4),
            "decode_s": main_path["decode_s"],
            "lrc_decode_s": lrc["decode_s"],
        },
        {
            **plane_entry("gf_planes_apply", 184, "apply_4", "apply",
                          "10x64MiB->4 (RS(10,4) encode)"),
            "ms_10x64MiB_to_8": pt["apply_8"]["ms"],
            "plain_ms_10x64MiB_to_8": pt["apply_8"]["plain_ms"],
            "bound_ms_10x64MiB_to_8": pt["apply_8"]["bound_ms"],
            "bound_by_10x64MiB_to_8": pt["apply_8"]["bound_by"],
            "registers": registers("planes_apply_kernel"),
            "pack_apply_unpack_ms_10x64MiB_to_4": planes["hop_ms"],
            "k1_ms_10x64MiB_to_4": planes["k1_ms"],
            "hop_chunk_ms": [c["ms"] for c in hop["chunks"]],
            "hop_chunk_gbs_all_rows": [c["gbs"] for c in hop["chunks"]],
            "hop_chunk_gbs_distinct_shards": [c["gbs_distinct"] for c in hop["chunks"]],
            "ms_10x64MiB_to_8_lrc": pt["apply_8_lrc"]["ms"],
            "plain_ms_10x64MiB_to_8_lrc": pt["apply_8_lrc"]["plain_ms"],
            "bound_ms_10x64MiB_to_8_lrc": pt["apply_8_lrc"]["bound_ms"],
            "bound_by_10x64MiB_to_8_lrc": pt["apply_8_lrc"]["bound_by"],
            "lrc_hop_chunk_ms": [c["ms"] for c in lrc_hop["chunks"]],
            "lrc_hop_chunk_gbs_distinct_shards": [c["gbs_distinct"] for c in lrc_hop["chunks"]],
        },
        plane_entry("gf_pack", 240, "pack", "pack", "10x64MiB"),
        plane_entry("gf_unpack", 260, "unpack", "unpack", "10x64MiB"),
    ]}
    mesh = main_path["mesh"]
    mesh_shapes = {"gf_apply": "k1_10x16MiB_to_4", "gf_planes_apply": "apply_bits_32MiB_to_2",
                   "gf_pack": "pack_10x32MiB", "gf_unpack": "unpack_2x32MiB"}
    for entry in record["kernels"]:
        name, shape = entry["name"], mesh_shapes[entry["name"]]
        entry["launches"] += mesh["launches"][name]
        entry["launches_mesh"] = mesh["launches"][name]
        entry["max_abs_err"] = max(entry["max_abs_err"], mesh["ops"]["errs"][name])
        entry.update({f"{key}_mesh_position_{shape}": mesh["ops"]["timings"][shape][key]
                      for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
    record["kernels"][0].update(
        mesh_encode_ms_10x64MiB=mesh["ops"]["whole_ms"],
        mesh_upload_ms_10x64MiB=mesh["ops"]["upload_ms"],
        mesh_cli_encode_wall_s=mesh["pipeline"]["cli"]["encode"]["wall_s"],
        mesh_cli_rebuild_wall_s=mesh["pipeline"]["cli"]["rebuild"]["wall_s"],
        throttled_rebuild_wait_s=mesh["pipeline"]["throttled"]["waited_s"],
        scaling=mesh["scaling"]["devices"],
    )
    svc = main_path["ec_service"]
    server = svc["server"]
    record["kernels"][0]["launches"] += svc["launches"]
    record["kernels"][0].update(
        launches_ec_service=svc["launches"],
        launches_ec_service_server=svc["launches_server"],
        server_rpc_walls_s=server["walls"],
        server_rebuild_setup_s=[r["setup_s"] for r in server["rebuilds"]],
        server_generate_stages=server["generate"],
        needle_reads={label: {key: r[key] for key in ("needles", "needles_per_s", "p50_us",
                                                      "p99_us", "reconstructed_intervals")}
                      for label, r in svc["reads"].items()},
        large_row_encode_gbs=svc["large"]["gbs"],
    )
    cluster = main_path["cluster"]
    record["kernels"][0]["launches"] += cluster["launches"]
    record["kernels"][0].update(
        launches_cluster=cluster["launches"],
        launches_cluster_source_generate=cluster["k1_source"],
        launches_cluster_rebuilder=cluster["k1_rebuilder"],
        cluster_walls_s=cluster["walls"],
        cluster_reads={k: cluster[k] for k in ("healthy", "degraded")},
    )
    write = main_path["write"]
    record["kernels"][0]["launches"] += write["launches"]
    record["kernels"][0].update(
        launches_write_path=write["launches"],
        write_path_walls_s=write["walls"],
        write_path_benchmark={f"{r['phase']}_req_per_s": r["req_per_sec"] for r in write["benchmark"]},
        write_path_ec_reads=write["ec_reads"],
    )
    failover = main_path["failover"]
    record["kernels"][0]["launches"] += failover["launches"]
    record["kernels"][0].update(
        launches_failover=failover["launches"],
        failover_s={k: failover[k] for k in ("leader_s", "rehomed_s", "first_ack_s")},
        failover_writes={k: failover[k] for k in ("before", "after", "acked", "errors")},
    )
    maintenance = main_path["maintenance"]
    record["kernels"][0]["launches"] += maintenance["launches"]
    record["kernels"][0].update(
        launches_maintenance=maintenance["launches"],
        maintenance_walls_s=maintenance["walls"],
        maintenance_vacuum=maintenance["vacuum"],
        maintenance_ec_reads=maintenance["ec_reads"],
    )
    storage = main_path["storage"]
    record["kernels"][0]["launches"] += storage["launches"]
    record["kernels"][0].update(
        launches_storage=storage["launches"],
        storage_walls_s=storage["walls"],
        storage_tiered_reads=storage["tiered_reads"],
        host_codec=main_path["host_codec"],
    )
    filer = main_path["filer"]
    record["kernels"][0]["launches"] += filer["launches"]
    record["kernels"][0].update(
        launches_filer=filer["launches"],
        launches_filer_encode=filer["launches_encode"],
        launches_filer_rebuild=filer["launches_rebuild"],
        filer_walls_s=filer["walls"],
        filer_fill={cls: {k: r[k] for k in ("files", "files_per_s", "mb_per_s", "p50_ms", "p99_ms")}
                    for cls, r in filer["fill"].items()},
        filer_rss_mib=filer["rss_mib"],
    )
    s3 = main_path["s3"]
    record["kernels"][0]["launches"] += s3["launches"]
    record["kernels"][0].update(
        launches_s3=s3["launches"],
        launches_s3_encode=s3["launches_encode"],
        launches_s3_rebuild=s3["launches_rebuild"],
        s3_walls_s=s3["walls"],
        s3_fill={cls: {k: r[k] for k in ("files", "files_per_s", "mb_per_s", "p50_ms", "p99_ms")}
                 for cls, r in s3["fill"].items()},
        s3_mixed_ops_per_s=s3["mixed"]["ops_per_s"],
    )
    tls = main_path["tls"]
    record["kernels"][0]["launches"] += tls["launches"]
    record["kernels"][0].update(
        launches_tls=tls["launches"],
        tls_walls_s=tls["walls"],
        tls_fill={cls: {k: r[k] for k in ("files", "files_per_s", "mb_per_s", "p50_ms", "p99_ms")}
                  for cls, r in tls["fill"].items()},
        tls_faults_fired=tls["faults_fired"],
    )
    shard = main_path["shard"]
    record["kernels"][0]["launches"] += shard["launches"]
    record["kernels"][0].update(
        launches_shard=shard["launches"],
        shard_walls_s=shard["walls"],
        shard_fill={cls: {k: r[k] for k in ("files", "files_per_s", "mb_per_s", "p50_ms", "p99_ms")}
                    for cls, r in shard["fill"].items()},
        shard_coherence_worst_ms=shard["coherence"]["worst_ms"],
        shard_requests_per_worker=shard["per_worker"],
    )
    admin = main_path["admin"]
    record["kernels"][0]["launches"] += admin["launches"]
    record["kernels"][0].update(
        launches_admin=admin["launches"],
        launches_admin_encode=admin["launches_encode"],
        launches_admin_rebuild=admin["launches_rebuild"],
        admin_walls_s=admin["walls"],
        admin_encode=admin["encode"],
        admin_vacuum_reclaimed=admin["vacuum"]["reclaimed"],
    )
    sync = main_path["sync"]
    record["kernels"][0]["launches"] += sync["launches"]
    record["kernels"][0].update(
        launches_sync=sync["launches"],
        sync_walls_s=sync["walls"],
        sync_delay_ms=sync["delay_ms"],
        sync_fill={cls: {k: r[k] for k in ("files", "files_per_s", "mb_per_s", "p50_ms", "p99_ms")}
                   for cls, r in sync["fill"].items()},
        sync_remote_cache_mb_per_s=sync["remote"]["cache_mb_per_s"],
        sync_resume=sync["resume"],
    )
    gateways = main_path["gateways"]
    record["kernels"][0]["launches"] += gateways["launches"]
    record["kernels"][0].update(
        launches_gateways=gateways["launches"],
        gateways_walls_s=gateways["walls"],
        gateways_webdav_fill={cls: {k: r[k] for k in ("files", "files_per_s", "mb_per_s", "p50_ms",
                                                      "p99_ms")}
                              for cls, r in gateways["fill"].items()},
        gateways_mount_delay_ms=gateways["mount_delay_ms"],
        gateways_mq_benchmark=gateways["mq_benchmark"],
        gateways_mq_publish=gateways["mq_publish"],
        gateways_owner_loss=gateways["owner_loss"],
    )
    print(f"total {time.perf_counter() - t_start:.3f}s")
    print(ident)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
