"""Volume server: the EC shard gRPC service on the port's pipeline.

The EC half of seaweedfs_tpu/server/volume_server.py (reference
weed/server/volume_grpc_erasure_coding.go:39-507): generate, rebuild,
mount, unmount, delete, read, blob delete, info and to-volume of EC
shards.  Generate and rebuild stream the volume through
``select.pipeline_codec_for(scheme, device)``: K1 (csrc/gf_apply.cu) on the
card.  Status codes and messages are the JAX package's.

Not ported: the HTTP needle data path, the master and its heartbeats,
normal volumes, ``CopyFile``/``EcShardsCopy``, ``EcShardsReceive`` and
the streaming ``targets`` fan-out of generate (a request with targets is
refused UNIMPLEMENTED rather than encoded locally).  Those RPCs answer
UNIMPLEMENTED.
"""

from __future__ import annotations

import json
import os

import grpc

from seaweedfs_tpu_torch import rpc, stats
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.server.store_ec import EcShardLocator
from seaweedfs_tpu_torch.storage.erasure_coding import ec_decoder, ec_encoder
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import ec_offset_width, rebuild_ecx_file
from seaweedfs_tpu_torch.storage.erasure_coding.lrc import make_scheme, scheme_local_groups
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME, EcScheme
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
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
    """The pipeline's stage breakdown, at verbosity 1 (WEEDTPU_V=1)."""
    if wlog.V(1):
        wlog.info("ec: %s %s stages: %s", op, base,
                  json.dumps({k: v for k, v in st.items() if k != "inputs"}, sort_keys=True))


class VolumeServerGrpcServicer:
    def __init__(self, vs: "VolumeServer"):
        self.vs = vs

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


class VolumeServer:
    """One volume server: the Store over its disks, the EC shard locator,
    the gRPC server and the ``/metrics`` listener.

    ``device`` is the codec's device, resolved at ``start()``: CUDA unless
    the caller asks for the CPU; without CUDA, start raises."""

    def __init__(
        self,
        directories: list[str],
        ip: str = "127.0.0.1",
        port: int = 8080,
        grpc_port: int = 0,
        metrics_port: int | None = None,
        device: str | None = None,
    ):
        self.store = Store(directories)
        self.ip = ip
        self.port = port
        self.grpc_port = grpc_port if (grpc_port or port == 0) else port + 10000
        self.metrics_port = metrics_port
        self._device_spec = device
        self.device = None  # resolved in start()
        self.locator: EcShardLocator | None = None
        self._grpc_server = None
        self._metrics_server = None

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
        self._grpc_server.start()
        self.locator = EcShardLocator()
        if self.metrics_port is not None:
            self._metrics_server = stats.start_metrics_server(self.metrics_port, self.ip)
            self.metrics_port = self._metrics_server.server_address[1]

    def stop(self) -> None:
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

