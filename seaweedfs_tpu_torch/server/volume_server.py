"""Volume server: the needle data plane over HTTP, the EC shard gRPC
service on the port's pipeline, the admin of normal volumes, shard copies
between servers and the heartbeat stream to the master.

The port of seaweedfs_tpu/server/volume_server.py (reference weed/server/volume_server_handlers_read.go:132,
volume_server_handlers_write.go:18, volume_grpc_erasure_coding.go:39-507,
volume_grpc_admin.go, volume_grpc_copy.go,
volume_grpc_client_to_master.go:51-113):

- HTTP on ``port``: GET/HEAD of ``/vid,fid`` from a normal or an EC volume
  (a 302 to a holder the master names when the volume is not here),
  ranged replies, gzip on write and read, ``?width``/``?height`` image
  resizing; POST with the per-fid JWT check and write-all replication to
  the other holders (``?type=replicate``); DELETE on normal and EC
  volumes; ``/status`` and ``/metrics``; upload and download in-flight
  byte limits.  With ``port`` 0 a free port is bound, and ``ip:port`` is
  the node's identity at the master.
- gRPC: generate (with ``targets``, each shard streams to its holder as
  the pipeline produces it, through ``RemoteShardSink`` into the holder's
  ``EcShardsReceive``), rebuild, copy, mount, unmount, delete, read, blob
  delete, info and to-volume of EC shards; allocate, delete, mark
  read-only / writable, status, mount and unmount of normal volumes;
  ``CopyFile`` (1 MiB chunks) and ``ReadNeedleBlob``; volume maintenance:
  ``VolumeVacuum``, ``VolumeCopy`` (the destination pulls .dat/.idx over
  the source's ``CopyFile`` and mounts them; ``disk_type`` pins the
  landing disk), ``VolumeScrub``, ``VolumeConfigureReplication``,
  ``VolumeNeedleIds`` and ``VolumeServerLeave`` (the heartbeat stops, the
  data plane stays up); ``VolumeTierMove`` (a sealed volume's .dat to a
  directory object store and back; ``force_seal`` seals a writable one,
  else FAILED_PRECONDITION); and, with master addresses, the heartbeat stream
  (full state, then the store's deltas, a full resync every
  ``FULL_SYNC_EVERY`` beats).  ``master_address`` is a comma-separated
  list (HA): the stream follows the ``leader`` a master answers with and
  rotates through the list when a master is gone.
- Background maintenance: the scrubber (storage/scrub.py: CRC walk at a
  bounded rate, repair from a replica's ``ReadNeedleBlob`` or by EC
  reconstruction, read-path CRC mismatches flagged to it) and auto-vacuum
  (storage/vacuum.py), each feeding heartbeat deltas.
- Observability: every ``/debug/`` page of util/debugz.py (scrub, vacuum,
  repair, tracez, breakers, faults, sketchz, sloz, eventz, ...) on the HTTP
  port as on the metrics listener; reads and writes run in a server span
  joined to the caller's ``traceparent`` and record into the
  ``volume.read``/``volume.write`` latency sketches.

Generate and rebuild stream the volume through
``select.pipeline_codec_for(scheme, device)``: K1 (csrc/gf_apply.cu) on the
card.  Status codes, bodies and messages are the JAX package's.

The Store's options (``needle_map_kind``, ``backend_kind``,
``offset_width``) pass through; ``public_url`` (default ``ip:port``) is
what the heartbeat advertises for reads.

The native front door (native/dataplane.py, csrc/dp.cpp), on unless
``SEAWEEDFS_TPU_NATIVE_DP=0``: the C++ loop binds the public port and
serves the needle GET, POST and DELETE of the plain disk volumes it holds
(with the 001 fan-out to replica holders the drainer resolves through the
master, 2 s deadline) and the EC GET of fully local intervals; everything
else is forwarded byte for byte to this module's handler, which moves to
``127.0.0.1:0``.  Writes are forwarded too when a JWT key is set or the
fsync policy is ``always``/``interval``.  A library that cannot be built or
loaded fails ``start``.  ``/metrics`` adds
``seaweedfs_volume_native_dp{kind=...}`` and the per-verb
``weedtpu_volume_server_native_request`` families, ``/status``
``NativeDataPlane``.
"""

from __future__ import annotations

import http.client
import json
import os
import queue
import re
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from urllib.parse import parse_qs, urlparse

import grpc

from seaweedfs_tpu_torch import rpc, stats
from seaweedfs_tpu_torch.ops import repair_budget
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.security import JwtError, sign_fid, verify_fid
from seaweedfs_tpu_torch.server.store_ec import EcShardLocator, ShardsUnreachableError
from seaweedfs_tpu_torch.stats import sketch
from seaweedfs_tpu_torch.storage import compression
from seaweedfs_tpu_torch.storage import scrub as scrub_mod
from seaweedfs_tpu_torch.storage import vacuum as vacuum_mod
from seaweedfs_tpu_torch.storage.backend import LocalObjectStoreClient
from seaweedfs_tpu_torch.storage.erasure_coding import ec_decoder, ec_encoder
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import ec_offset_width, rebuild_ecx_file
from seaweedfs_tpu_torch.storage.erasure_coding.lrc import make_scheme, scheme_local_groups
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME, EcScheme
from seaweedfs_tpu_torch.storage.needle import (
    FLAG_IS_COMPRESSED,
    CookieMismatch,
    CrcMismatch,
    new_needle,
)
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock, ttl_to_seconds
from seaweedfs_tpu_torch.storage.types import get_actual_size, size_is_deleted, size_is_valid
from seaweedfs_tpu_torch.storage.volume import NotFoundError, parse_fsync_policy, volume_file_name
from seaweedfs_tpu_torch.storage.volume_info import (
    VolumeInfo,
    maybe_load_volume_info,
    save_volume_info,
)
from seaweedfs_tpu_torch.util import resilience, wlog
from seaweedfs_tpu_torch.util.http_pool import HttpConnectionPool
from seaweedfs_tpu_torch.util.httpd import PooledHTTPServer, QuietHandler
from seaweedfs_tpu_torch.util.limiter import InFlightLimiter

_STREAM_CHUNK = 1024 * 1024
_IN_FLIGHT_LIMIT = 256 * 1024 * 1024  # bytes buffered for uploads, and for downloads


def parse_fid(fid: str) -> tuple[int, int, int]:
    """'vid,keyhex+8-hex-cookie[_N]' -> (vid, needle_id, cookie).

    The ``_N`` suffix is the batch-assign convention: an assign with
    count=K reserves K consecutive keys and clients address them as fid,
    fid_1 ... fid_{K-1} (same cookie)."""
    fid = fid.split(".")[0]  # drop any extension
    vid_str, _, rest = fid.partition(",")
    rest, _, index = rest.partition("_")
    if not vid_str.isdigit() or len(rest) <= 8:
        raise ValueError(f"bad fid {fid!r}")
    offset = int(index) if index.isdigit() else 0
    return int(vid_str), int(rest[:-8], 16) + offset, int(rest[-8:], 16)


def _geometry(geo: vs_pb.EcGeometry | None) -> EcScheme:
    if geo is None or (geo.data_shards == 0 and geo.parity_shards == 0 and geo.local_groups == 0):
        return DEFAULT_SCHEME
    return make_scheme(geo.data_shards, geo.parity_shards, geo.local_groups)


def _scheme_for(base: str, geo: vs_pb.EcGeometry | None) -> EcScheme:
    """Request geometry if given, else the geometry recorded in .vif."""
    if geo is not None and (geo.data_shards or geo.parity_shards or geo.local_groups):
        return _geometry(geo)
    info = maybe_load_volume_info(base + ".vif")
    if info and info.data_shards and info.parity_shards:
        return make_scheme(info.data_shards, info.parity_shards, info.local_groups)
    return DEFAULT_SCHEME


def _stage_log(op: str, base: str, st: dict) -> None:
    """A pipeline's stage breakdown, or a shard copy's bytes and wall, at
    verbosity 1 (WEEDTPU_V=1)."""
    if wlog.V(1):
        wlog.info("ec: %s %s stages: %s", op, base,
                  json.dumps({k: v for k, v in st.items() if k != "inputs"}, sort_keys=True))


class RemoteShardSink:
    """write_at/close/abort sink that streams a shard to its destination
    holder over the EcShardsReceive client stream as the encoder produces
    it (reference worker sendShardFileToDestination, ec_task.go:534): the
    generate path never materializes remote shards locally."""

    _CHUNK = 1024 * 1024

    def __init__(self, address: str, vid: int, collection: str, shard_id: int, ext: str,
                 disk_type: str = ""):
        self.address = address
        self.ext = ext
        self._meta = dict(volume_id=vid, collection=collection, shard_id=shard_id, ext=ext,
                          disk_type=disk_type)
        self._q: "queue.Queue" = queue.Queue(maxsize=8)
        self._written = 0
        self._result: list = [None, None]  # (response, exception)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"shard-sink-{shard_id}")
        self._thread.start()

    def _gen(self):
        first = True
        while True:
            item = self._q.get()
            if isinstance(item, _SinkAbort):
                return  # end the stream WITHOUT eof: the receiver drops its .tmp
            eof = isinstance(item, _SinkEof)
            chunk = vs_pb.EcShardsReceiveChunk(data=b"" if eof else item, eof=eof)
            if first:
                for k, v in self._meta.items():
                    setattr(chunk, k, v)
                first = False
            yield chunk
            if eof:
                return

    def _run(self) -> None:
        try:
            self._result[0] = rpc.volume_stub(self.address).EcShardsReceive(self._gen())
        except Exception as e:  # noqa: BLE001 — surfaced in write_at/close
            self._result[1] = e
            # drain so a blocked writer cannot deadlock against a dead call
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break

    def write_at(self, offset: int, data) -> None:
        if offset != self._written:
            raise ValueError(f"remote shard sink requires sequential writes: "
                             f"offset {offset} != written {self._written}")
        if self._result[1] is not None:
            raise IOError(f"shard stream to {self.address} failed: {self._result[1]}")
        buf = bytes(data)  # the pipeline reuses its host buffer two batches on
        for i in range(0, len(buf), self._CHUNK):
            self._put(buf[i : i + self._CHUNK])
        self._written += len(buf)

    def _put(self, item) -> None:
        """Bounded put that cannot hang on a dead stream (the consumer
        thread drains once on failure; a racing put must still return)."""
        while True:
            if self._result[1] is not None:
                raise IOError(f"shard stream to {self.address} failed: {self._result[1]}")
            try:
                self._q.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    def close(self) -> None:
        # the eof chunk ends the stream: the receiver finalizes .tmp -> final
        self._put(_SinkEof())
        self._thread.join(timeout=120)
        if self._thread.is_alive():
            # a stream still in flight is NOT success: reporting it done
            # would let the caller delete the source volume while the
            # receiver still holds a .tmp
            raise IOError(f"shard stream to {self.address} did not finish in time")
        if self._result[1] is not None:
            raise IOError(f"shard stream to {self.address} failed: {self._result[1]}")

    def abort(self) -> None:
        try:
            self._q.put(_SinkAbort(), timeout=1.0)
        except queue.Full:
            pass  # the stream is already dead; the receiver drops the .tmp
        self._thread.join(timeout=10)


class _SinkAbort:
    pass


class _SinkEof:
    pass


class VolumeServerGrpcServicer:
    def __init__(self, vs: "VolumeServer"):
        self.vs = vs

    # -- volume lifecycle --------------------------------------------------

    def allocate_volume(self, request, context):
        self.vs.store.add_volume(request.volume_id, request.collection,
                                 request.replication or "000", request.ttl_seconds,
                                 disk_type=request.disk_type)
        return vs_pb.AllocateVolumeResponse()

    def volume_delete(self, request, context):
        self.vs.store.delete_volume(request.volume_id, request.only_empty)
        return vs_pb.VolumeDeleteResponse()

    def volume_mark_readonly(self, request, context):
        vol = self._volume(request.volume_id, context)
        vol.set_read_only(True)  # durable: the seal survives restarts
        return vs_pb.VolumeMarkResponse()

    def volume_mark_writable(self, request, context):
        vol = self._volume(request.volume_id, context)
        vol.set_read_only(False)
        return vs_pb.VolumeMarkResponse()

    def volume_status(self, request, context):
        vol = self._volume(request.volume_id, context)
        if self.vs._dp is not None:  # fold pending native-write events in
            self.vs._dp.flush_events()
        return vs_pb.VolumeStatusResponse(volume_size=vol.dat_size(), file_count=vol.file_count(),
                                          read_only=vol.read_only,
                                          last_modified_ns=vol.last_append_at_ns)

    def volume_mount(self, request, context):
        try:
            self.vs.store.mount_volume(request.volume_id, request.collection)
        except NotFoundError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except ValueError as e:  # already mounted: idempotent retry, not loss
            context.abort(grpc.StatusCode.ALREADY_EXISTS, str(e))
        return vs_pb.VolumeMountResponse()

    def volume_unmount(self, request, context):
        try:
            self.vs.store.unmount_volume(request.volume_id)
        except NotFoundError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return vs_pb.VolumeMountResponse()

    # -- volume maintenance ------------------------------------------------

    def volume_vacuum(self, request, context):
        vol = self._volume(request.volume_id, context)
        if self.vs._dp is not None:
            self.vs._dp.flush_events()
        if vol.garbage_ratio() < request.garbage_threshold:
            return vs_pb.VolumeVacuumResponse(reclaimed_bytes=0)
        reclaimed = vol.vacuum()
        # the next heartbeat carries the compacted size, as after an
        # auto-vacuum pass: a master left with the old garbage ratio until
        # the next full beat has the scanner vacuum it again and again
        self.vs._volume_done(vol)
        return vs_pb.VolumeVacuumResponse(reclaimed_bytes=reclaimed)

    def volume_copy(self, request, context):
        """Pull a peer's whole volume (.dat + .idx) and mount it: the
        destination half of volume.balance / volume.move (reference
        volume_grpc_copy.go VolumeCopy, riding the CopyFile stream)."""
        if self.vs.store.find_volume(request.volume_id) is not None:
            context.abort(grpc.StatusCode.ALREADY_EXISTS, f"volume {request.volume_id} already here")
        loc = self.vs.store.locations[0]
        if request.disk_type:
            # volume.tier.move pins the landing disk
            loc = next((l for l in self.vs.store.locations if l.disk_type == request.disk_type),
                       None)
            if loc is None:
                context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                              f"no {request.disk_type} disk location on this server")
        base = volume_file_name(loc.directory, request.collection, request.volume_id)
        stub = rpc.volume_stub(request.source_data_node)
        src_modified_ns = 0
        for ext in (".dat", ".idx"):
            try:
                with open(base + ext + ".tmp", "wb") as out:
                    for resp in stub.CopyFile(vs_pb.CopyFileRequest(
                            volume_id=request.volume_id, collection=request.collection, ext=ext)):
                        out.write(resp.file_content)
                        if ext == ".dat":
                            src_modified_ns = resp.modified_ts_ns
            except (grpc.RpcError, OSError) as e:
                # OSError covers a full or unwritable disk mid-copy: the
                # .tmp pair must not leak either way
                for cleanup in (".dat", ".idx"):
                    try:
                        os.unlink(base + cleanup + ".tmp")
                    except FileNotFoundError:
                        pass
                context.abort(grpc.StatusCode.INTERNAL,
                              f"copy {ext} from {request.source_data_node}: {e}")
        # publish .idx before .dat: mount discovery keys on .dat presence, so
        # a crash between the renames leaves an undiscoverable .idx rather
        # than a discoverable volume with an empty needle map
        for ext in (".idx", ".dat"):
            os.replace(base + ext + ".tmp", base + ext)
        self.vs.store.mount_volume(request.volume_id, request.collection)
        return vs_pb.VolumeCopyResponse(last_append_at_ns=src_modified_ns)

    def volume_scrub(self, request, context):
        """Foreground scrub pass (the `volume.scrub` shell command):
        CRC-verify needles, repair from replicas / EC reconstruction."""
        scrubber = self.vs.scrubber
        if scrubber is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, "scrubber not available")
        results = []
        if request.volume_id:
            vol = self.vs.store.find_volume(request.volume_id)
            ev = self.vs.store.find_ec_volume(request.volume_id)
            if vol is None and ev is None:
                context.abort(grpc.StatusCode.NOT_FOUND, f"volume {request.volume_id} not found")
            if vol is not None:
                results.append(scrubber.scrub_volume(vol, repair=request.repair))
            if ev is not None:
                results.append(scrubber.scrub_ec_volume(ev, repair=request.repair))
        else:
            results = scrubber.scrub_all(repair=request.repair)
        return vs_pb.VolumeScrubResponse(results=[vs_pb.VolumeScrubResult(**r) for r in results])

    def volume_configure_replication(self, request, context):
        """Rewrite a mounted volume's replica-placement code in its
        superblock (reference command_volume_configure_replication.go);
        the delta heartbeat re-announces the new placement."""
        vol = self._volume(request.volume_id, context)
        try:
            vol.set_replica_placement(request.replication)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        self.vs._volume_done(vol)
        return vs_pb.VolumeConfigureReplicationResponse()

    def volume_needle_ids(self, request, context):
        """Live needle keys, sizes and offsets of one volume (the
        volume.fsck census, reference volume_grpc_query.go)."""
        vol = self._volume(request.volume_id, context)
        if self.vs._dp is not None:
            self.vs._dp.flush_events()
        with vol._write_lock:  # MemDb iterates the live dict: snapshot
            needles = list(vol.nm.db.values())
        return vs_pb.VolumeNeedleIdsResponse(keys=[nv.key for nv in needles],
                                             sizes=[nv.size for nv in needles],
                                             offsets=[nv.offset for nv in needles])

    def volume_server_leave(self, request, context):
        """Stop heartbeating so the master forgets this node (reference
        volume_grpc_admin.go VolumeServerLeave); the data plane stays up
        for in-flight reads until the process exits."""
        self.vs._leaving.set()
        return vs_pb.VolumeServerLeaveResponse()

    def volume_tier_move(self, request, context):
        """Move a sealed volume's .dat to or from an object-store tier
        (reference volume_grpc_tier.go VolumeTierMoveDatToRemote /
        FromRemote over storage/backend/s3_backend)."""
        vol = self._volume(request.volume_id, context)
        client = LocalObjectStoreClient(request.dest)
        try:
            if request.download:
                vol.tier_download(client)
                return vs_pb.VolumeTierMoveResponse()
            if not vol.read_only:
                if not request.force_seal:
                    context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                                  f"volume {request.volume_id} is not sealed readonly")
                vol.set_read_only(True)
            return vs_pb.VolumeTierMoveResponse(key=vol.tier_upload(client))
        except OSError as e:
            context.abort(grpc.StatusCode.INTERNAL, f"tier move: {e}")

    def _volume(self, vid: int, context):
        vol = self.vs.store.find_volume(vid)
        if vol is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"volume {vid} not found")
        return vol

    # -- EC lifecycle (reference volume_grpc_erasure_coding.go) ------------

    def _ec_base(self, collection: str, vid: int, need: str) -> str:
        """Find the disk holding `need` (an extension) for this volume."""
        for loc in self.vs.store.locations:
            base = volume_file_name(loc.directory, collection, vid)
            if os.path.exists(base + need):
                return base
        raise FileNotFoundError(f"vid {vid}: no {need} on any disk")

    def ec_shards_generate(self, request, context):
        """Stripe .dat -> .ec*, write sorted .ecx + .vif (reference
        VolumeEcShardsGenerate :39-94; the stripes through K1 on the card).

        With ``targets`` set, shard i streams straight to targets[i] as it
        is produced instead of landing locally and being balanced
        afterwards (reference worker ec_task.go:534)."""
        try:
            base = self._ec_base(request.collection, request.volume_id, ".dat")
        except FileNotFoundError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        scheme = _geometry(request.geometry)
        dat_size = os.path.getsize(base + ".dat")
        with open(base + ".dat", "rb") as f:
            sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
        sinks = None
        targets = list(request.targets)
        if targets:
            if len(targets) != scheme.total_shards:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              f"targets must have {scheme.total_shards} entries, got {len(targets)}")
            own = f"{self.vs.ip}:{self.vs.grpc_port}"
            sinks = [
                ec_encoder.FileShardSink(base + scheme.shard_ext(i))
                if not addr or addr == own
                else RemoteShardSink(addr, request.volume_id, request.collection, i,
                                     scheme.shard_ext(i), disk_type=request.disk_type)
                for i, addr in enumerate(targets)
            ]
        st: dict = {}
        try:
            ec_encoder.write_ec_files(base, scheme, stats=st, sinks=sinks, device=self.vs.device)
        except (IOError, ValueError) as e:
            context.abort(grpc.StatusCode.INTERNAL, f"streaming generate: {e}")
        _stage_log("generate", base, st)
        ec_encoder.write_sorted_ecx_file(base, offset_width=sb.offset_width)
        stats.EC_OPS.inc(op="encode")
        save_volume_info(
            base + ".vif",
            VolumeInfo(
                version=int(sb.version),
                dat_file_size=dat_size,
                data_shards=scheme.data_shards,
                parity_shards=scheme.parity_shards,
                local_groups=scheme_local_groups(scheme),
                offset_width=sb.offset_width,
            ),
        )
        return vs_pb.EcShardsGenerateResponse()

    def ec_shards_rebuild(self, request, context):
        """Regenerate missing .ec files from local survivors (reference
        VolumeEcShardsRebuild :97-136), then replay the .ecj into the .ecx."""
        try:
            base = self._ec_base(request.collection, request.volume_id, ".ecx")
        except FileNotFoundError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        scheme = _scheme_for(base, request.geometry)
        st: dict = {}
        rebuilt = ec_encoder.rebuild_ec_files(
            base, scheme, stats=st, targets=list(request.target_shard_ids) or None,
            device=self.vs.device)
        _stage_log("rebuild", base, st)
        stats.EC_OPS.inc(op="rebuild")
        rebuild_ecx_file(base)
        return vs_pb.EcShardsRebuildResponse(rebuilt_shard_ids=rebuilt)

    def ec_shards_copy(self, request, context):
        """Pull shard/index files from a peer (reference VolumeEcShardsCopy
        :139-211; data rides the CopyFile stream).  ``disk_type`` pins the
        landing disk.  Shard bytes are repair/rebalance traffic: throttled
        by and billed to the shared repair budget (mode "move")."""
        loc = self.vs.store.locations[0]
        if request.disk_type:
            loc = next((l for l in self.vs.store.locations if l.disk_type == request.disk_type),
                       None)
            if loc is None:
                context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                              f"no {request.disk_type} disk location on this server")
            # the store mounts ONE EcVolume per vid: refuse before any
            # bytes move if this vid already lives on another disk here
            have = self.vs.store.find_ec_volume(request.volume_id)
            if have is not None and os.path.dirname(str(have.base)) != os.path.normpath(
                    loc.directory):
                context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                              f"EC volume {request.volume_id} already mounted on a different "
                              "disk of this server")
        base = volume_file_name(loc.directory, request.collection, request.volume_id)
        exts = [f".ec{s:02d}" for s in request.shard_ids]
        if request.copy_ecx_file:
            exts.append(".ecx")
        if request.copy_ecj_file:
            exts.append(".ecj")
        if request.copy_vif_file:
            exts.append(".vif")
        stub = rpc.volume_stub(request.source_data_node)
        budget = repair_budget.shared()
        moved = 0
        t0 = time.perf_counter()
        for ext in exts:
            try:
                with open(base + ext + ".tmp", "wb") as out:
                    for resp in stub.CopyFile(vs_pb.CopyFileRequest(
                            volume_id=request.volume_id, collection=request.collection, ext=ext,
                            ignore_source_file_not_found=ext == ".ecj")):
                        if ext not in (".ecx", ".ecj", ".vif"):
                            budget.throttle(len(resp.file_content))
                            moved += len(resp.file_content)
                        out.write(resp.file_content)
                os.replace(base + ext + ".tmp", base + ext)
            except grpc.RpcError as e:
                try:
                    os.unlink(base + ext + ".tmp")
                except FileNotFoundError:
                    pass
                if ext == ".ecj":
                    continue
                context.abort(grpc.StatusCode.INTERNAL,
                              f"copy {ext} from {request.source_data_node}: {e}")
        if moved:
            # classify after the pull: the .vif (when copied) now says
            # which storage class these shards belong to
            budget.account(_scheme_for(base, None).code_name, "move", moved=moved)
        _stage_log("copy", base, {"shards": list(request.shard_ids), "bytes": moved,
                                  "source": request.source_data_node,
                                  "wall_s": time.perf_counter() - t0})
        return vs_pb.EcShardsCopyResponse()

    def ec_shards_receive(self, request_iterator, context):
        """Destination half of the streaming generate: land one shard (or
        .ecx/.vif) pushed by a generating peer.  Bytes stream into a .tmp;
        only an explicit eof finalizes it, so a generator that dies
        mid-stream leaves nothing half-visible."""
        first = next(request_iterator, None)
        if first is None:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "empty stream")
        loc = self.vs.store.locations[0]
        if first.disk_type:
            loc = next((l for l in self.vs.store.locations if l.disk_type == first.disk_type),
                       None)
            if loc is None:
                context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                              f"no {first.disk_type} disk location on this server")
        # strict allowlist: this stream must not be able to finalize over a
        # live .dat/.idx
        if not re.fullmatch(r"\.(ec\d\d|ecx|ecj|vif)", first.ext):
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"bad ext {first.ext!r}")
        base = volume_file_name(loc.directory, first.collection, first.volume_id)
        tmp = base + first.ext + ".tmp"
        done = False
        written = 0
        try:
            with open(tmp, "wb") as out:
                chunk = first
                while True:
                    if chunk.data:
                        out.write(chunk.data)
                        written += len(chunk.data)
                    if chunk.eof:
                        done = True
                        break
                    chunk = next(request_iterator, None)
                    if chunk is None:
                        break  # the stream ended without eof: the generator died
            if done:
                os.replace(tmp, base + first.ext)
        finally:
            if not done:
                try:
                    os.unlink(tmp)
                except FileNotFoundError:
                    pass
        if not done:
            context.abort(grpc.StatusCode.ABORTED, "shard stream ended without eof")
        _stage_log("receive", base, {"ext": first.ext, "bytes": written})
        return vs_pb.EcShardsReceiveResponse(bytes_written=written)

    def ec_shards_delete(self, request, context):
        self.vs.store.destroy_ec_shards(request.collection, request.volume_id,
                                        list(request.shard_ids))
        return vs_pb.EcShardsDeleteResponse()

    def ec_shards_mount(self, request, context):
        try:
            self.vs.store.mount_ec_shards(request.collection, request.volume_id,
                                          list(request.shard_ids))
        except (NotFoundError, FileNotFoundError) as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return vs_pb.EcShardsMountResponse()

    def ec_shards_unmount(self, request, context):
        self.vs.store.unmount_ec_shards(request.volume_id, list(request.shard_ids))
        return vs_pb.EcShardsUnmountResponse()

    def ec_shard_read(self, request, context):
        """Stream a shard byte range (reference VolumeEcShardRead :343-409)."""
        ev = self.vs.store.find_ec_volume(request.volume_id)
        if ev is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"ec volume {request.volume_id}")
        shard = ev.shards.get(request.shard_id)
        if shard is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"ec volume {request.volume_id} shard {request.shard_id}")
        if request.file_key:
            try:
                _, size = ev.find_needle_from_ecx(request.file_key)
                if size_is_deleted(size):
                    yield vs_pb.EcShardReadResponse(is_deleted=True)
                    return
            except NotFoundError:
                pass
        remaining = request.size
        offset = request.offset
        while remaining > 0:
            data = shard.read_at(offset, min(_STREAM_CHUNK, remaining))
            if not data:
                break
            yield vs_pb.EcShardReadResponse(data=data)
            offset += len(data)
            remaining -= len(data)

    def ec_blob_delete(self, request, context):
        ev = self.vs.store.find_ec_volume(request.volume_id)
        if ev is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"ec volume {request.volume_id}")
        ev.delete_needle(request.file_key)
        return vs_pb.EcBlobDeleteResponse()

    def ec_shards_to_volume(self, request, context):
        """Decode collected shards back into a normal volume (reference
        VolumeEcShardsToVolume :441-480); missing data shards are rebuilt
        first, through K1."""
        try:
            base = self._ec_base(request.collection, request.volume_id, ".ecx")
        except FileNotFoundError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        scheme = _scheme_for(base, request.geometry)
        info = maybe_load_volume_info(base + ".vif")
        dat_size = (info.dat_file_size if info and info.dat_file_size
                    else ec_decoder.find_dat_file_size(base, scheme))
        missing = [s for s in range(scheme.data_shards)
                   if not os.path.exists(base + scheme.shard_ext(s))]
        if missing:
            ec_encoder.rebuild_ec_files(base, scheme, device=self.vs.device)
        ec_decoder.write_dat_file(base, dat_size, scheme=scheme)
        ec_decoder.write_idx_file_from_ec_index(base, offset_width=ec_offset_width(base, info))
        return vs_pb.EcShardsToVolumeResponse()

    def ec_shards_info(self, request, context):
        ev = self.vs.store.find_ec_volume(request.volume_id)
        shards = []
        if ev is not None:
            for sid in ev.shard_ids():
                shards.append(vs_pb.EcShardInfo(shard_id=sid, size=ev.shards[sid].size(),
                                                collection=ev.collection))
        return vs_pb.EcShardsInfoResponse(shards=shards)

    # -- file transfer -----------------------------------------------------

    def copy_file(self, request, context):
        try:
            base = self._ec_base(request.collection, request.volume_id, request.ext)
        except FileNotFoundError as e:
            if request.ignore_source_file_not_found:
                return
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        path = base + request.ext
        stop = request.stop_offset or os.path.getsize(path)
        mtime = int(os.path.getmtime(path) * 1e9)
        with open(path, "rb") as f:
            sent = 0
            while sent < stop:
                chunk = f.read(min(_STREAM_CHUNK, stop - sent))
                if not chunk:
                    break
                yield vs_pb.CopyFileResponse(file_content=chunk, modified_ts_ns=mtime)
                sent += len(chunk)

    def read_needle_blob(self, request, context):
        """The raw on-disk record of one needle: at (offset, size) when
        given, else resolved by needle id (a peer cannot know this
        server's offset for a key)."""
        vol = self._volume(request.volume_id, context)
        offset, size = request.offset, request.size
        if offset < 0 or size <= 0:
            nv = vol.nm.get(request.needle_id)
            if nv is None or not size_is_valid(nv.size):
                context.abort(grpc.StatusCode.NOT_FOUND,
                              f"needle {request.needle_id:x} not in volume {request.volume_id}")
            offset = nv.offset
            size = get_actual_size(nv.size, vol.version)
        return vs_pb.ReadNeedleBlobResponse(needle_blob=vol._pread(offset, size))


class _VolumeHttpHandler(QuietHandler):
    vs: "VolumeServer" = None  # class attribute injected per server

    def _parse(self):
        url = urlparse(self.path)
        return url, parse_qs(url.query), url.path.lstrip("/")

    def _write_auth_ok(self, q, fid: str) -> bool:
        """Verify the per-fid write JWT when the cluster signs writes."""
        key = self.vs.jwt_key
        if not key:
            return True
        token = q.get("jwt", [""])[0]
        if not token:
            auth = self.headers.get("Authorization", "")
            if auth.lower().startswith("bearer "):
                token = auth[7:].strip()
        try:
            verify_fid(key, token, fid)
            return True
        except JwtError as e:
            self._drain()
            self._reply(401, str(e).encode(), "text/plain")
            return False

    def do_GET(self):
        url, q, fid = self._parse()
        if url.path == "/metrics":
            # stats.NATIVE_DP_REQUESTS (per-verb counters and latency
            # histograms polled from the C++ loop) renders inside
            # render_text(); the aggregate family follows
            text = stats.render_text()
            if self.vs._dp is not None:
                text += "".join(f'seaweedfs_volume_native_dp{{kind="{k}"}} {v}\n'
                                for k, v in self.vs._dp.stats().items())
            self._reply(200, text.encode(), "text/plain; version=0.0.4")
            return
        if url.path.startswith("/debug/"):
            from seaweedfs_tpu_torch.util import debugz

            code, body = debugz.handle(self.path)
            self._reply(code, body, "text/plain")
            return
        if url.path == "/status":
            store = self.vs.store
            info = {"Version": "weed-tpu",
                    "Volumes": sum(l.volume_count() for l in store.locations),
                    "EcShards": sum(l.ec_shard_count() for l in store.locations)}
            if self.vs._dp is not None:
                info["NativeDataPlane"] = self.vs._dp.stats()
            self._reply(200, json.dumps(info).encode(), "application/json")
            return
        t0 = time.perf_counter()
        stats.VOLUME_REQUESTS.inc(type="read")
        try:
            with self.server_span("read", "volume", fid=fid):
                self._read_inner(q, fid)
        finally:
            dur = time.perf_counter() - t0
            stats.VOLUME_REQUEST_SECONDS.observe(dur, type="read")
            sketch.record(sketch.OP_VOLUME_READ, dur)

    def _read_inner(self, q, fid: str) -> None:
        try:
            vid, nid, cookie = parse_fid(fid)
        except ValueError as e:
            self._reply(400, str(e).encode(), "text/plain")
            return
        store = self.vs.store
        vol = store.find_volume(vid)
        try:
            # size the reservation from the index BEFORE buffering the
            # needle, or the limiter cannot bound read-path memory
            if vol is not None:
                nv = vol.nm.get(nid)
                est = nv.size if nv is not None else 0
            else:
                ev = store.find_ec_volume(vid)
                if ev is None:
                    # not local: redirect the client to a holder found via
                    # the master (reference GetOrHeadHandler lookup and
                    # redirect, volume_server_handlers_read.go:56-77)
                    target = self.vs.lookup_volume_url(vid)
                    if target and target != self.vs.url:
                        self._reply(302, headers={"Location": f"http://{target}/{fid}"})
                        return
                    self._reply(404, b"volume not found", "text/plain")
                    return
                _, est, _ = ev.locate(nid)
            with self.vs.download_limiter.reserve(max(0, est)) as ok:
                if not ok:
                    self._reply(429, b"download capacity exceeded", "text/plain")
                    return
                if vol is not None:
                    n = vol.read_needle(nid, cookie)
                else:
                    n = ev.read_needle(nid, self.vs.locator.make_fetcher(ev))
                    if n.cookie != cookie:
                        raise CookieMismatch(fid)
                data = bytes(n.data)
                wants_resize = bool(q.get("width", [""])[0] or q.get("height", [""])[0])
                enc_headers = {}
                extra_bytes = 0
                if n.has(FLAG_IS_COMPRESSED):
                    accepts = ("gzip" in self.headers.get("Accept-Encoding", "")
                               and not wants_resize)  # resizing needs raw pixels
                    if accepts and self.headers.get("Range") is None:
                        enc_headers["Content-Encoding"] = "gzip"  # ship stored bytes as-is
                    else:
                        # the gzip trailer carries the raw length (mod 2^32):
                        # grow the reservation BEFORE materializing it, or
                        # compression defeats the read-memory bound
                        raw_len = int.from_bytes(data[-4:], "little")
                        extra_bytes = max(0, raw_len - len(data))
                # short timeout: this grows a reservation already held;
                # waiting long here while peers do the same starves
                # everyone, a fast 429 sheds load instead
                with self.vs.download_limiter.reserve(extra_bytes, timeout=0.5) as ok2:
                    if not ok2:
                        self._reply(429, b"download capacity exceeded", "text/plain")
                        return
                    if not enc_headers and n.has(FLAG_IS_COMPRESSED):
                        data = compression.decompress(data)
                    ctype = "application/octet-stream"
                    if wants_resize:
                        # on-the-fly image resizing (reference
                        # images/resizing.go); unparseable dimensions
                        # serve the original
                        from seaweedfs_tpu_torch.images import resize_image

                        def _dim(name: str) -> int:
                            try:
                                return int(q.get(name, ["0"])[0] or 0)
                            except ValueError:
                                return 0

                        data, ctype = resize_image(data, _dim("width"), _dim("height"),
                                                   q.get("mode", ["fit"])[0])
                    self.reply_ranged(len(data), ctype, lambda lo, hi: data[lo : hi + 1],
                                      extra_headers=enc_headers or None)
        except CrcMismatch:
            # a 500 is an answer from a live peer: the client fails over to
            # the sibling replicas / EC shards, while the needle is flagged
            # for the scrubber to repair (self-healing read path)
            stats.DISK_CORRUPTION.inc(path="read")
            if self.vs.scrubber is not None:
                self.vs.scrubber.flag(vid, nid)
            self._reply(500, b"crc mismatch", "text/plain")
        except ShardsUnreachableError as e:
            # not an answer about the needle: another holder of the
            # volume may reach k shards, so the client asks it next
            self._reply(503, str(e).encode(), "text/plain")
        except (NotFoundError, KeyError):
            self._reply(404, b"not found", "text/plain")
        except CookieMismatch:
            self._reply(404, b"cookie mismatch", "text/plain")

    do_HEAD = do_GET

    def do_POST(self):
        t0 = time.perf_counter()
        stats.VOLUME_REQUESTS.inc(type="write")
        try:
            with self.server_span("write", "volume"):
                self._post_inner()
        finally:
            # error paths (400/401/404/429/500) count too, like do_GET
            dur = time.perf_counter() - t0
            stats.VOLUME_REQUEST_SECONDS.observe(dur, type="write")
            sketch.record(sketch.OP_VOLUME_WRITE, dur)

    def _post_inner(self) -> None:
        _url, q, fid = self._parse()
        try:
            vid, nid, cookie = parse_fid(fid)
        except ValueError as e:
            self._drain()
            self._reply(400, str(e).encode(), "text/plain")
            return
        if not self._write_auth_ok(q, fid):
            return
        length = int(self.headers.get("Content-Length", "0"))
        # backpressure before buffering: bound the in-flight upload bytes
        # (reference inFlightUploadDataLimitCond)
        with self.vs.upload_limiter.reserve(length) as ok:
            if not ok:
                self._drain(length)  # keep the keep-alive stream in sync
                self._reply(429, b"upload capacity exceeded", "text/plain")
                return
            data = self.rfile.read(length)
            vol = self.vs.store.find_volume(vid)
            if vol is None:
                self._reply(404, b"volume not found", "text/plain")
                return
            is_replicate = q.get("type", [""])[0] == "replicate"
            try:
                n = new_needle(nid, cookie, data)
                if is_replicate:
                    # replicas store the primary's bytes verbatim; the
                    # marker says those bytes are already gzip
                    if q.get("compressed", [""])[0] == "true":
                        n.set(FLAG_IS_COMPRESSED)
                elif q.get("compress", [""])[0] != "false":
                    # compress-on-write when the payload is worth it
                    # (reference needle_parse_upload.go:76-81);
                    # Content-Type / ?name= feed the gzippable check
                    packed = compression.maybe_compress(
                        data, mime=self.headers.get("Content-Type", ""), name=q.get("name", [""])[0])
                    if packed is not None:
                        n.data = packed
                        n.set(FLAG_IS_COMPRESSED)
                _, size = vol.write_needle(n)
            except Exception as e:  # noqa: BLE001 — the client gets the reason
                self._reply(500, str(e).encode(), "text/plain")
                return
            if not is_replicate:
                extra = "&compressed=true" if n.has(FLAG_IS_COMPRESSED) else ""
                err = self.vs.replicate(fid, "POST", bytes(n.data), extra_query=extra)
                if err:
                    self._reply(500, err.encode(), "text/plain")
                    return
            self._reply(201, b'{"size": %d}' % size, "application/json")

    def do_DELETE(self):
        _url, q, fid = self._parse()
        stats.VOLUME_REQUESTS.inc(type="delete")
        try:
            vid, nid, _cookie = parse_fid(fid)
        except ValueError as e:
            self._reply(400, str(e).encode(), "text/plain")
            return
        if not self._write_auth_ok(q, fid):
            return
        store = self.vs.store
        vol = store.find_volume(vid)
        if vol is None:
            ev = store.find_ec_volume(vid)
            if ev is None:
                self._reply(404, b"volume not found", "text/plain")
                return
            ev.delete_needle(nid)
            err = self.vs.delete_ec_needle_at_holders(vid, nid)
            if err:
                self._reply(500, err.encode(), "text/plain")
                return
            self._reply(202, b"{}", "application/json")
            return
        try:
            vol.delete_needle(nid)
        except NotFoundError:
            self._reply(404, b"not found", "text/plain")
            return
        if q.get("type", [""])[0] != "replicate":
            self.vs.replicate(fid, "DELETE", b"")
        self._reply(202, b"{}", "application/json")


class _LookupDeadline(Exception):
    """A bounded master lookup ran out of time before the next master."""


class VolumeServer:
    """One volume server: the Store over its disks (its volumes loaded),
    the EC shard locator, the HTTP and gRPC servers, the optional
    ``/metrics`` listener and, when ``master_address`` is given (one
    master's gRPC address, or a comma-separated list of them), the
    heartbeat stream to the leader.

    ``device`` is the codec's device, resolved at ``start()``: CUDA unless
    the caller asks for the CPU; without CUDA, start raises.  ``fsync`` is
    the volumes' fsync policy (default ``$WEED_FSYNC`` or ``close``);
    ``jwt_key`` (default ``$WEED_JWT_KEY``) makes writes and deletes
    require a per-fid token.  ``needle_map_kind``, ``backend_kind`` and
    ``offset_width`` are the Store's; ``public_url`` (default ``ip:port``)
    is the read address the heartbeat advertises."""

    FULL_SYNC_EVERY = 5  # beats between full-state resyncs

    def __init__(
        self,
        directories: list[str],
        master_address: str = "",
        ip: str = "127.0.0.1",
        port: int = 8080,
        grpc_port: int = 0,
        public_url: str = "",
        metrics_port: int | None = None,
        device: str | None = None,
        data_center: str = "",
        rack: str = "",
        max_volume_counts: list[int] | None = None,
        heartbeat_interval: float = 3.0,
        jwt_key: str = "",
        fsync: str = "",
        disk_types: list[str] | None = None,
        scrub_interval_s: float | None = None,
        scrub_rate_mb_s: float | None = None,
        vacuum_interval_s: float | None = None,
        vacuum_garbage: float | None = None,
        needle_map_kind: str = "memory",
        backend_kind: str = "disk",
        offset_width: int = 4,
    ):
        self.store = Store(directories, max_volume_counts, disk_types=disk_types,
                           fsync=fsync or os.environ.get("WEED_FSYNC", "close"),
                           needle_map_kind=needle_map_kind, backend_kind=backend_kind,
                           offset_width=offset_width)
        self.store.load_existing_volumes()
        # comma-separated master gRPC addresses (HA); the active one follows
        # the leader field of the heartbeat responses
        self.master_addresses = [a.strip() for a in master_address.split(",") if a.strip()]
        self.master_address = self.master_addresses[0] if self.master_addresses else ""
        self.ip = ip
        self.port = port
        self.grpc_port = grpc_port if (grpc_port or port == 0) else port + 10000
        self._public_url = public_url
        self.metrics_port = metrics_port
        self.data_center = data_center
        self.rack = rack
        self.heartbeat_interval = heartbeat_interval
        self._device_spec = device
        self.device = None  # resolved in start()
        self.locator: EcShardLocator | None = None
        self._grpc_server = None
        self._http_server = None
        self._metrics_server = None
        self._stop = threading.Event()
        self._leaving = threading.Event()  # VolumeServerLeave: heartbeat off
        self._heartbeat_thread: threading.Thread | None = None
        self.scrubber: scrub_mod.VolumeScrubber | None = None  # built in start()
        self._scrub_interval_s = scrub_interval_s
        self._scrub_rate_mb_s = scrub_rate_mb_s
        self.auto_vacuum: vacuum_mod.AutoVacuum | None = None  # built in start()
        self._vacuum_interval_s = vacuum_interval_s
        self._vacuum_garbage = vacuum_garbage
        # vid -> (urls, fetched_at) holder-location cache
        self._lookup_cache: dict[int, tuple[list[str], float]] = {}
        # data-plane hardening: pooled replica connections, parallel
        # fan-out, and in-flight byte backpressure (reference
        # volume_server_handlers_read.go:188-194)
        self._replica_pool = HttpConnectionPool(timeout=10.0)
        self._fanout_pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="replicate")
        self.upload_limiter = InFlightLimiter(_IN_FLIGHT_LIMIT)
        self.download_limiter = InFlightLimiter(_IN_FLIGHT_LIMIT)
        self.jwt_key = jwt_key or os.environ.get("WEED_JWT_KEY", "")
        self._dp = None  # the native data plane, set in start()

    @property
    def public_url(self) -> str:
        return self._public_url or self.url

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    # -- replication fan-out (reference topology/store_replicate.go) -------

    def delete_ec_needle_at_holders(self, vid: int, nid: int) -> str | None:
        """An EC needle deleted here is deleted at every other holder of
        the volume's shards too (EcBlobDelete), so that a read on any of
        them answers 404.  Upstream's DeleteEcShardNeedle deletes at the
        holders of the needle's shard and of the parity shards; the JAX
        package deletes only here, so a read on another holder still finds
        the needle in that holder's .ecx.

        The master's shard map lags a balance by up to a heartbeat, so a
        server that has just mounted shards of ``vid`` may be missing from
        it: every volume server the master knows is asked too, and one
        that holds no shard of ``vid`` answers NOT_FOUND.  Returns an error
        string when the holders cannot be listed or a holder in the map
        fails, so the DELETE is not acknowledged; a failure at a server
        outside the map is only logged."""
        if self.locator is None or not self.locator.master_address:
            return None
        try:
            locs = self.locator.shard_locations(vid, fresh=True)
            topo = self.master_call("VolumeList", m_pb.VolumeListRequest(),
                                    timeout=resilience.policy().deadline_s).topology_info
        except grpc.RpcError as e:
            return f"ec delete of {vid},{nid:x}: no holders from the master: {e.code()}"
        holders = {a for addrs in locs.values() for a in addrs}
        nodes = {f"{dn.url.split(':')[0]}:{dn.grpc_port}" for dc in topo.data_center_infos
                 for rack in dc.rack_infos for dn in rack.data_node_infos}
        failed = []
        for addr in sorted((holders | nodes) - {self.locator.local_grpc_address}):
            try:  # a server outside the map gets one attempt
                rpc.volume_stub(addr).EcBlobDelete(
                    vs_pb.EcBlobDeleteRequest(volume_id=vid, file_key=nid),
                    **({} if addr in holders else {"wd_max_attempts": 1}))
            except grpc.RpcError as e:
                if resilience.error_code(e) is grpc.StatusCode.NOT_FOUND:
                    continue
                wlog.warning("ec: delete of %d,%x at %s failed: %s", vid, nid, addr, e.code())
                if addr in holders:
                    failed.append(f"{addr}: {e.code()}")
        if failed:
            return f"ec delete of {vid},{nid:x} failed at holders: {', '.join(failed)}"
        return None

    def replicate(self, fid: str, method: str, data: bytes, extra_query: str = "") -> str | None:
        """Fan out to the other replica holders in parallel over pooled
        keep-alive connections, with TTL-cached locations; returns an error
        string if any replica write fails (write-all semantics, reference
        ReplicatedWrite, topology/store_replicate.go:27)."""
        vid = int(fid.split(",")[0])
        vol = self.store.find_volume(vid)
        if vol is None or vol.super_block.replica_placement.copy_count <= 1:
            return None
        need = vol.super_block.replica_placement.copy_count - 1
        targets = self.replica_holders(vid, need)
        if len(targets) < need:
            # failing loudly beats a 201 with missing copies (write-all)
            return f"replication short: {len(targets)} replica holders known, {need} required"
        headers = {}
        if self.jwt_key:
            # symmetric key: volume servers sign their own fan-out
            # (reference GenJwtForVolumeServer on replication)
            headers["Authorization"] = f"Bearer {sign_fid(self.jwt_key, fid)}"

        def send(url: str) -> str | None:
            try:
                status, _body = self._replica_pool.request(
                    url, method, f"/{fid}?type=replicate{extra_query}",
                    body=data if method == "POST" else None, headers=headers)
                return f"{url}: HTTP {status}" if status >= 300 else None
            except (OSError, http.client.HTTPException) as e:
                self._lookup_cache.pop(vid, None)  # the holder may have moved
                return f"{url}: {e}"

        if len(targets) == 1:
            errors = [e for e in [send(targets[0])] if e]
        else:
            errors = [e for e in self._fanout_pool.map(send, targets) if e]
        return "; ".join(errors) if errors else None

    def replica_holders(self, vid: int, need: int, timeout: float | None = None) -> list[str]:
        """The other holders of vid.  A cached answer that names fewer than
        ``need`` (the master may have heard of only some holders of a
        volume just grown) is dropped and the master asked again, so one
        early lookup does not refuse the volume's replicated writes for the
        cache's whole TTL."""
        urls = [u for u in self.lookup_volume_urls(vid, timeout) if u != self.url]
        if len(urls) < need:
            self._lookup_cache.pop(vid, None)
            urls = [u for u in self.lookup_volume_urls(vid, timeout) if u != self.url]
        return urls

    def _native_replicas(self, vid: int) -> list[str]:
        """The native plane's replica resolver (its event drainer calls it;
        2 s bound, so a blackholed master cannot stall the drainer)."""
        vol = self.store.find_volume(vid)
        need = vol.super_block.replica_placement.copy_count - 1 if vol is not None else 0
        return self.replica_holders(vid, need, timeout=2.0)

    def masters_now(self) -> list[str]:
        """The master the heartbeat loop reaches now, then the rest of the
        ``-mserver`` list: the order every lookup tries them in."""
        cur = self.master_address
        return [cur] + [a for a in self.master_addresses if a != cur] if cur else []

    def master_call(self, method: str, request, timeout: float):
        """One unary master RPC, failing over along ``masters_now()`` on
        a connection-class error (an application error is the answer)."""
        return resilience.failover_call(
            self.masters_now(),
            lambda addr: getattr(rpc.master_stub(addr), method)(request, timeout=timeout))

    _LOOKUP_TTL = 10.0  # seconds; the reference caches vid locations client-side

    def lookup_volume_urls(self, vid: int, timeout: float | None = None) -> list[str]:
        """All holder URLs for vid per the master (self included if a
        holder).  TTL-cached, including negative results, so a burst of
        misses does not turn 1:1 into master RPCs (reference wdclient
        vidMap).  ``timeout`` bounds the whole lookup, every master tried
        included, with one attempt per master: the native plane's event
        drainer resolves replica holders with it and must not hang on a
        blackholed master."""
        now = time.monotonic()
        cached = self._lookup_cache.get(vid)
        if cached is not None and now - cached[1] < self._LOOKUP_TTL:
            return list(cached[0])
        if not self.master_address:
            return []
        req = m_pb.LookupVolumeRequest(volume_or_file_ids=[str(vid)])
        try:
            if timeout is None:
                # the stub retries a transient UNAVAILABLE (and evicts the
                # dead channel): an empty answer here fails a replicated
                # write ("replication short")
                resp = self.master_call("LookupVolume", req, timeout=10)
            else:
                deadline = now + timeout

                def call_at(addr):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise _LookupDeadline()
                    return rpc.master_stub(addr).LookupVolume(req, timeout=left,
                                                              wd_max_attempts=1)

                resp = resilience.failover_call(self.masters_now(), call_at, rotations=1)
        except (grpc.RpcError, _LookupDeadline):
            return []  # master unreachable: do not cache
        urls = [loc.url for vl in resp.volume_id_locations for loc in vl.locations]
        if urls:
            self._lookup_cache[vid] = (urls, now)
        else:
            # brief negative TTL: a 10 s empty cache would turn replicated
            # writes into refused ones long after the holders registered
            self._lookup_cache[vid] = (urls, now - self._LOOKUP_TTL + 1.0)
        return list(urls)

    def _peer_grpc_addresses(self, vid: int) -> list[str]:
        """gRPC addresses of the OTHER holders of vid per the master."""
        if not self.master_address:
            return []
        try:
            resp = self.master_call(
                "LookupVolume", m_pb.LookupVolumeRequest(volume_or_file_ids=[str(vid)]), timeout=10.0)
        except grpc.RpcError:
            return []
        return [f"{loc.url.split(':')[0]}:{loc.grpc_port}"
                for vl in resp.volume_id_locations for loc in vl.locations
                if loc.url != self.url and loc.grpc_port]

    def fetch_replica_record(self, vid: int, collection: str, needle_id: int,
                             size: int) -> bytes | None:
        """Scrubber repair source: the raw on-disk record of one needle
        from any other replica holder (the peer resolves its own offset)."""
        for addr in self._peer_grpc_addresses(vid):
            try:
                resp = rpc.volume_stub(addr).ReadNeedleBlob(vs_pb.ReadNeedleBlobRequest(
                    volume_id=vid, needle_id=needle_id, offset=-1, size=0))
                if resp.needle_blob:
                    return bytes(resp.needle_blob)
            except grpc.RpcError as e:
                if wlog.V(1):
                    wlog.info("scrub: replica record %x of vid %d from %s: %s", needle_id, vid,
                              addr, e)
        return None

    def _volume_done(self, vol) -> None:
        """A volume's superblock or scrub state changed (a scrub or vacuum
        pass, a new placement): announce it in the next heartbeat."""
        self.store.volume_deltas.put(("new", vol, self.store.disk_type_of(vol.id)))

    def lookup_volume_url(self, vid: int) -> str | None:
        """First holder URL for vid, excluding self (read redirects)."""
        for url in self.lookup_volume_urls(vid):
            if url != self.url:
                return url
        return None

    # -- heartbeat (reference volume_grpc_client_to_master.go:51-113) ------

    def _full_heartbeat(self) -> m_pb.Heartbeat:
        """Complete state: also refreshes size/read_only/file_count at the
        master (deltas alone would freeze them at registration values)."""
        store = self.store
        vols = store.volume_stats()
        ecs = store.ec_shard_stats()
        return m_pb.Heartbeat(
            ip=self.ip,
            port=self.port,
            grpc_port=self.grpc_port,
            public_url=self.public_url,
            data_center=self.data_center,
            rack=self.rack,
            max_volume_count=store.max_volume_count(),
            max_volume_counts=store.max_volume_counts_by_type(),
            volumes=[m_pb.VolumeStat(**s) for s in vols],
            ec_shards=[m_pb.EcShardStat(**s) for s in ecs],
            has_no_volumes=not vols,
            has_no_ec_shards=not ecs,
        )

    def _volume_delta(self, kind: str, vol, disk_type: str) -> m_pb.VolumeStat:
        try:
            size = vol.dat_size() if kind == "new" else 0
            file_count = vol.file_count() if kind == "new" else 0
        except (OSError, ValueError):
            # the volume was closed (deleted/moved) between the delta
            # enqueue and this beat: report 0 rather than kill the stream
            size = file_count = 0
        # the delta REPLACES the master's row: it carries every durable field
        return m_pb.VolumeStat(
            id=vol.id,
            collection=vol.collection,
            size=size,
            file_count=file_count,
            read_only=vol.read_only,
            replica_placement=str(vol.super_block.replica_placement),
            version=int(vol.version),
            ttl_seconds=ttl_to_seconds(vol.super_block.ttl),
            disk_type=disk_type,
            last_scrub_ns=vol.last_scrub_at_ns,
            scrub_corrupt=vol.scrub_corrupt,
        )

    def _hb_stopped(self) -> bool:
        return self._stop.is_set() or self._leaving.is_set()

    def _heartbeat_messages(self):
        store = self.store
        yield self._full_heartbeat()
        beats = 0
        while not self._hb_stopped():
            new_vols, del_vols, new_ec, del_ec = [], [], [], []
            deadline = time.time() + self.heartbeat_interval
            while time.time() < deadline and not self._hb_stopped():
                drained = False
                while True:
                    try:
                        kind, vol, disk_type = store.volume_deltas.get_nowait()
                    except queue.Empty:
                        break
                    drained = True
                    stat = self._volume_delta(kind, vol, disk_type)
                    (new_vols if kind == "new" else del_vols).append(stat)
                while True:
                    try:
                        kind, vid, coll, bits, sizes, scheme, ec_dt = store.ec_shard_deltas.get_nowait()
                    except queue.Empty:
                        break
                    drained = True
                    stat = m_pb.EcShardStat(
                        volume_id=vid,
                        collection=coll,
                        shard_bits=int(bits),
                        shard_sizes=sizes,
                        data_shards=scheme.data_shards,
                        parity_shards=scheme.parity_shards,
                        local_groups=scheme_local_groups(scheme),
                        disk_type=ec_dt,
                    )
                    (new_ec if kind == "new" else del_ec).append(stat)
                if drained:
                    break  # ship deltas promptly
                self._stop.wait(0.1)
            if self._hb_stopped():
                return
            beats += 1
            if beats % self.FULL_SYNC_EVERY == 0 and not (new_vols or del_vols or new_ec or del_ec):
                yield self._full_heartbeat()
                continue
            yield m_pb.Heartbeat(
                ip=self.ip,
                port=self.port,
                grpc_port=self.grpc_port,
                public_url=self.public_url,
                data_center=self.data_center,
                rack=self.rack,
                max_volume_count=store.max_volume_count(),
                max_volume_counts=store.max_volume_counts_by_type(),
                new_volumes=new_vols,
                deleted_volumes=del_vols,
                new_ec_shards=new_ec,
                deleted_ec_shards=del_ec,
            )

    def _heartbeat_loop(self) -> None:
        ring = 0
        failures = 0
        while not self._hb_stopped():
            try:
                stub = rpc.master_stub(self.master_address)
                for resp in stub.SendHeartbeat(self._heartbeat_messages()):
                    failures = 0
                    if self._hb_stopped():
                        return
                    if resp.leader and resp.leader != self.master_address:
                        # re-home to the leader (reference leader redirect,
                        # volume_grpc_client_to_master.go)
                        if wlog.V(1):
                            wlog.info("volume %s: heartbeat re-homes from %s to leader %s",
                                      self.url, self.master_address, resp.leader)
                        self.master_address = resp.leader
                        if resp.leader in self.master_addresses:
                            # keep the failover ring aligned so a dead
                            # leader's slot is not the first retry
                            ring = self.master_addresses.index(resp.leader)
                        break
            except grpc.RpcError as e:
                failures += 1
                if wlog.V(1):
                    wlog.info("volume %s: heartbeat to %s broke: %s", self.url,
                              self.master_address, e.code())
                # this master is gone (the stub evicted its channel on
                # UNAVAILABLE): try the next configured one
                if len(self.master_addresses) > 1:
                    ring = (ring + 1) % len(self.master_addresses)
                    self.master_address = self.master_addresses[ring]
            # stream broke: reconnect after a beat, with full jitter growing
            # on repeated failures so a restarted master is not greeted by
            # every volume server at the same instant
            self._stop.wait(1.0 + resilience.backoff_s(min(failures, 5)))

    def start(self) -> None:
        from seaweedfs_tpu_torch.native import dataplane
        from seaweedfs_tpu_torch.ops import rs_cuda, sched_cache  # noqa: F401 — sched_cache's family
        from seaweedfs_tpu_torch.ops.rs_torch import resolve_device

        self.device = resolve_device(self._device_spec)
        if dataplane.enabled():
            dataplane.load()  # a plane that cannot build fails before anything starts
        for kernel, counter in (("gf_apply", "launches"), ("gf_planes_apply", "plane_launches"),
                                ("gf_pack", "pack_launches"), ("gf_unpack", "unpack_launches")):
            stats.CUDA_KERNEL_LAUNCHES.set_function(
                lambda counter=counter: getattr(rs_cuda, counter), kernel=kernel)
        self._grpc_server = rpc.make_server()
        rpc.add_service(self._grpc_server, vs_pb, "VolumeServer", VolumeServerGrpcServicer(self))
        self.grpc_port = rpc.add_port(self._grpc_server, f"{self.ip}:{self.grpc_port}")
        self._grpc_server.start()
        handler = type("Handler", (_VolumeHttpHandler,), {"vs": self})
        self._dp = None
        if dataplane.enabled():
            self._start_native(dataplane, handler)
        else:
            self._http_server = PooledHTTPServer((self.ip, self.port), handler)
            self.port = self._http_server.server_address[1]  # ip:port names the node
        # the EC locator asks the master the heartbeat reaches now, then the
        # rest of the list (the JAX locator asks only the first configured
        # one, so a dead first -mserver leaves it no remote shard)
        self.locator = EcShardLocator(self.master_address, f"{self.ip}:{self.grpc_port}",
                                      masters=self.masters_now)
        # the self-healing scrubber and auto-vacuum; both feed the
        # heartbeat so the master's view follows their findings
        self.scrubber = scrub_mod.VolumeScrubber(
            self.store, rate_mb_s=self._scrub_rate_mb_s, interval_s=self._scrub_interval_s,
            replica_fetcher=self.fetch_replica_record, ec_locator=self.locator,
            on_volume_done=self._volume_done)
        self.scrubber.start()
        self.auto_vacuum = vacuum_mod.AutoVacuum(
            self.store, interval_s=self._vacuum_interval_s,
            garbage_threshold=self._vacuum_garbage, on_volume_done=self._volume_done)
        self.auto_vacuum.start()
        threading.Thread(target=self._http_server.serve_forever, daemon=True).start()
        if self.metrics_port is not None:
            self._metrics_server = stats.start_metrics_server(self.metrics_port, self.ip)
            self.metrics_port = self._metrics_server.server_address[1]
        if self.master_address:
            self._heartbeat_thread = threading.Thread(target=self._heartbeat_loop, daemon=True)
            self._heartbeat_thread.start()

    def _start_native(self, dataplane, handler) -> None:
        """The native front door: the C++ loop binds the public port and
        owns the needle hot path; this module's handler moves to an
        internal loopback port and serves what the loop forwards.  Raises
        when the library cannot be built or loaded, or the port bound."""
        # the native appender never fsyncs and knows no JWT: with a key or
        # a per-write fsync policy every write forwards to Python (reads
        # stay native), where the token check and the barrier apply
        forward_writes = bool(self.jwt_key) or parse_fsync_policy(
            self.store.fsync)[0] in ("always", "interval")
        dp = dataplane.NativeDataPlane.create(self.ip, self.port, self.store,
                                              jwt_required=forward_writes)
        self._dp = dp
        # the C++ loop's per-verb counters and latency histograms in
        # /metrics, through the polled-snapshot seam; weakref'd so a
        # stopped server's plane is not pinned (the last one started wins)
        dp_ref = weakref.ref(dp)
        stats.NATIVE_DP_REQUESTS.set_provider(
            lambda: (lambda d: d.metrics_snapshot() if d else None)(dp_ref()))
        # the forward target is always dialled over loopback: binding
        # self.ip would fail every forward when -ip names a NIC address
        self._http_server = PooledHTTPServer(("127.0.0.1", 0), handler)
        self.port = dp.port
        self.store.dp = dp
        # replicated primaries fan out inside the plane (reference
        # topology/store_replicate.go:27); Python only resolves the holder
        # addresses, which the event drainer refreshes.  The 2 s deadline
        # keeps a blackholed master from stalling the drainer (native
        # writes would go invisible to Python reads meanwhile)
        dp.replica_resolver = self._native_replicas
        for loc in self.store.locations:
            for vol in list(loc.volumes.values()):
                dp.register_volume(vol)
            for ev in list(loc.ec_volumes.values()):
                dp.register_ec_volume(ev)
        dp.start(self._http_server.server_address[1])

    def stop(self, drain_s: float = 0.0) -> None:
        self._stop.set()
        if self.scrubber is not None:
            self.scrubber.stop()
        if self.auto_vacuum is not None:
            self.auto_vacuum.stop()
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join(timeout=5)
        if self._dp is not None:
            # the native loop owns the client-facing listener and the
            # Python server is only its forward target: the loop stops
            # accepting before the Python server drains
            self.store.dp = None
            self._dp.stop()
        if self._http_server is not None:
            self._http_server.shutdown()
            self._http_server.server_close()
            if drain_s > 0:
                left = self._http_server.drain(drain_s)
                if left:
                    wlog.warning("volume %s: drain timed out with %d request(s) in flight",
                                 self.url, left)
        if self._grpc_server is not None:
            # wait for termination: a mid-grace return leaves the port
            # half-dead (client RPCs get CANCELLED, not UNAVAILABLE)
            self._grpc_server.stop(grace=0.5).wait()
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server.server_close()
        if self.locator is not None:
            self.locator.close()
        self._fanout_pool.shutdown(wait=False)
        self._replica_pool.close()
        self.store.close()

