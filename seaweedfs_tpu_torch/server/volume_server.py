"""Volume server: the EC shard gRPC service on the port's pipeline, the
admin of normal volumes, shard copies between servers and the heartbeat
stream to the master.

The port of seaweedfs_tpu/server/volume_server.py's gRPC side (reference
weed/server/volume_grpc_erasure_coding.go:39-507, volume_grpc_admin.go,
volume_grpc_copy.go, volume_grpc_client_to_master.go:51-113): generate,
rebuild, copy, mount, unmount, delete, read, blob delete, info and
to-volume of EC shards; allocate, delete, mark read-only / writable,
status, mount and unmount of normal volumes; ``CopyFile`` (1 MiB chunks);
and, with a master address, the heartbeat stream (full state, then the
store's deltas, a full resync every ``FULL_SYNC_EVERY`` beats).  Generate
and rebuild stream the volume through ``select.pipeline_codec_for(scheme,
device)``: K1 (csrc/gf_apply.cu) on the card.  Status codes and messages
are the JAX package's.

Not ported: the HTTP needle data path (``-port`` binds nothing; with
``-port 0`` the heartbeat names the bound gRPC port as the node's port,
which is its identity at the master), ``ReadNeedleBlob``,
``VolumeCopy``, vacuum, the scrubber, ``EcShardsReceive`` and the
streaming ``targets`` fan-out of generate (a request with targets is
refused UNIMPLEMENTED rather than encoded locally), master failover
across several addresses, and JWT.  Those RPCs answer UNIMPLEMENTED.
"""

from __future__ import annotations

import json
import os
import queue
import random
import threading
import time

import grpc

from seaweedfs_tpu_torch import rpc, stats
from seaweedfs_tpu_torch.ops import repair_budget
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.server.store_ec import EcShardLocator
from seaweedfs_tpu_torch.storage.erasure_coding import ec_decoder, ec_encoder
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import ec_offset_width, rebuild_ecx_file
from seaweedfs_tpu_torch.storage.erasure_coding.lrc import make_scheme, scheme_local_groups
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME, EcScheme
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock, ttl_to_seconds
from seaweedfs_tpu_torch.storage.types import size_is_deleted
from seaweedfs_tpu_torch.storage.volume import NotFoundError, volume_file_name
from seaweedfs_tpu_torch.storage.volume_info import (
    VolumeInfo,
    maybe_load_volume_info,
    save_volume_info,
)
from seaweedfs_tpu_torch.util import wlog

_STREAM_CHUNK = 1024 * 1024


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
        VolumeEcShardsGenerate :39-94; the stripes through K1 on the card)."""
        try:
            base = self._ec_base(request.collection, request.volume_id, ".dat")
        except FileNotFoundError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        if request.targets:
            context.abort(grpc.StatusCode.UNIMPLEMENTED,
                          "streaming generate (targets) is not ported: shards land locally only")
        scheme = _geometry(request.geometry)
        dat_size = os.path.getsize(base + ".dat")
        with open(base + ".dat", "rb") as f:
            sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
        st: dict = {}
        try:
            ec_encoder.write_ec_files(base, scheme, stats=st, device=self.vs.device)
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


class VolumeServer:
    """One volume server: the Store over its disks (its volumes loaded),
    the EC shard locator, the gRPC server, the ``/metrics`` listener and,
    when ``master_address`` is given, the heartbeat stream to it.

    ``device`` is the codec's device, resolved at ``start()``: CUDA unless
    the caller asks for the CPU; without CUDA, start raises."""

    FULL_SYNC_EVERY = 5  # beats between full-state resyncs

    def __init__(
        self,
        directories: list[str],
        master_address: str = "",
        ip: str = "127.0.0.1",
        port: int = 8080,
        grpc_port: int = 0,
        metrics_port: int | None = None,
        device: str | None = None,
        data_center: str = "",
        rack: str = "",
        max_volume_counts: list[int] | None = None,
        heartbeat_interval: float = 3.0,
    ):
        self.store = Store(directories, max_volume_counts)
        self.store.load_existing_volumes()
        self.master_address = master_address
        self.ip = ip
        self.port = port
        self.grpc_port = grpc_port if (grpc_port or port == 0) else port + 10000
        self.metrics_port = metrics_port
        self.data_center = data_center
        self.rack = rack
        self.heartbeat_interval = heartbeat_interval
        self._device_spec = device
        self.device = None  # resolved in start()
        self.locator: EcShardLocator | None = None
        self._grpc_server = None
        self._metrics_server = None
        self._stop = threading.Event()
        self._heartbeat_thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

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
            public_url=self.url,
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

    def _heartbeat_messages(self):
        store = self.store
        yield self._full_heartbeat()
        beats = 0
        while not self._stop.is_set():
            new_vols, del_vols, new_ec, del_ec = [], [], [], []
            deadline = time.time() + self.heartbeat_interval
            while time.time() < deadline and not self._stop.is_set():
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
            if self._stop.is_set():
                return
            beats += 1
            if beats % self.FULL_SYNC_EVERY == 0 and not (new_vols or del_vols or new_ec or del_ec):
                yield self._full_heartbeat()
                continue
            yield m_pb.Heartbeat(
                ip=self.ip,
                port=self.port,
                grpc_port=self.grpc_port,
                public_url=self.url,
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
        failures = 0
        while not self._stop.is_set():
            try:
                stub = rpc.master_stub(self.master_address)
                for _resp in stub.SendHeartbeat(self._heartbeat_messages()):
                    failures = 0
                    if self._stop.is_set():
                        return
            except grpc.RpcError as e:
                failures += 1
                if wlog.V(1):
                    wlog.info("volume %s: heartbeat to %s broke: %s", self.url,
                              self.master_address, e.code())
            # stream broke: reconnect after a beat, with full jitter growing
            # on repeated failures (the JAX package's backoff: 50 ms doubling,
            # capped at 2 s) so a restarted master is not greeted by every
            # volume server at the same instant
            self._stop.wait(1.0 + random.uniform(0.0, min(2.0, 0.05 * 2 ** (min(failures, 5) - 1))))

    def start(self) -> None:
        from seaweedfs_tpu_torch.ops import rs_cuda, sched_cache  # noqa: F401 — sched_cache's family
        from seaweedfs_tpu_torch.ops.rs_torch import resolve_device

        self.device = resolve_device(self._device_spec)
        for kernel, counter in (("gf_apply", "launches"), ("gf_planes_apply", "plane_launches"),
                                ("gf_pack", "pack_launches"), ("gf_unpack", "unpack_launches")):
            stats.CUDA_KERNEL_LAUNCHES.set_function(
                lambda counter=counter: getattr(rs_cuda, counter), kernel=kernel)
        self._grpc_server = rpc.make_server()
        rpc.add_service(self._grpc_server, vs_pb, "VolumeServer", VolumeServerGrpcServicer(self))
        self.grpc_port = rpc.add_port(self._grpc_server, f"{self.ip}:{self.grpc_port}")
        if self.port == 0:
            # no HTTP listener to bind: the bound gRPC port names the node
            self.port = self.grpc_port
        self._grpc_server.start()
        self.locator = EcShardLocator(self.master_address, f"{self.ip}:{self.grpc_port}")
        if self.metrics_port is not None:
            self._metrics_server = stats.start_metrics_server(self.metrics_port, self.ip)
            self.metrics_port = self._metrics_server.server_address[1]
        if self.master_address:
            self._heartbeat_thread = threading.Thread(target=self._heartbeat_loop, daemon=True)
            self._heartbeat_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join(timeout=5)
        if self._grpc_server is not None:
            # wait for termination: a mid-grace return leaves the port
            # half-dead (client RPCs get CANCELLED, not UNAVAILABLE)
            self._grpc_server.stop(grace=0.5).wait()
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server.server_close()
        if self.locator is not None:
            self.locator.close()
        self.store.close()

