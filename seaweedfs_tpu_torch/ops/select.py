"""Codec selection: the port of seaweedfs_tpu/ops/select.py.

Bulk encode and rebuild run the CUDA kernels (ReedSolomonCuda, or LrcCuda
for the LRC storage class); with ``device="cpu"`` they run the plain
PyTorch codec (ReedSolomonTorch / LrcTorch) on the host.  Unlike the JAX
package there is no link probe and no fallback to a host engine: a missing
CUDA device raises (rs_torch.resolve_device), it is never hidden.

The file pipelines route an RS volume through the mesh codec
(parallel/distributed_ec.ReedSolomonMesh: the work split over every card
of the process, one stream per mesh position) when
``SEAWEEDFS_TPU_EC_PIPELINE_ENGINE`` (or ``SEAWEEDFS_TPU_EC_ENGINE``) is
``mesh``; when it is unset or ``auto``, ``SEAWEEDFS_TPU_EC_MESH=1`` forces
the mesh, ``=0`` disables it, and unset picks it when the process sees
more than one CUDA device.  That choice has no link probe either, by
design.  With ``device="cpu"`` the mesh is the one CPU device.

Small degraded reads and the EC scrub's repairs decode on the host
(``small_read_codec``, ``small_read_codec_for``): ReedSolomonCPU / LrcCPU
on the native apply of csrc/gf256.cpp, as the JAX package's ReedSolomonCPU.

The scheme carries the storage class (EcScheme = RS, LrcScheme = LRC via
its ``local_groups``); ``pipeline_codec_for`` and ``small_read_codec_for``
are the one dispatch point, so call sites never branch on the class.
"""

from __future__ import annotations

import os
from functools import lru_cache

import torch

from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch, resolve_device


def bulk_codec(
    data_shards: int,
    parity_shards: int,
    cauchy: bool = False,
    device: str | torch.device | None = None,
):
    """Codec for bulk encode/rebuild: the CUDA kernel on the card, the
    plain PyTorch codec when the caller asks for the CPU."""
    return _bulk_codec(data_shards, parity_shards, cauchy, resolve_device(device))


@lru_cache(maxsize=64)
def _bulk_codec(data_shards: int, parity_shards: int, cauchy: bool, device: torch.device):
    if device.type == "cuda":
        from seaweedfs_tpu_torch.ops.rs_cuda import ReedSolomonCuda

        return ReedSolomonCuda(data_shards, parity_shards, cauchy, device)
    return ReedSolomonTorch(data_shards, parity_shards, cauchy, device)


@lru_cache(maxsize=16)
def _mesh_codec(data_shards: int, parity_shards: int, cauchy: bool, device: torch.device):
    """The mesh codec: over every CUDA device of the process, or over the
    one CPU device when the caller asks for the CPU."""
    from seaweedfs_tpu_torch.parallel.distributed_ec import ReedSolomonMesh
    from seaweedfs_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=None if device.type == "cuda" else [device])
    return ReedSolomonMesh(data_shards, parity_shards, cauchy, mesh=mesh)


def pipeline_codec(
    data_shards: int,
    parity_shards: int,
    cauchy: bool = False,
    device: str | torch.device | None = None,
):
    """Codec for the file pipelines (write_ec_files / rebuild_ec_files):
    the bulk codec, or the mesh codec (see the module docstring) —
    the pipeline itself stages the bytes through pinned host buffers."""
    device = resolve_device(device)
    engine = os.environ.get(
        "SEAWEEDFS_TPU_EC_PIPELINE_ENGINE", os.environ.get("SEAWEEDFS_TPU_EC_ENGINE", "")
    )
    if engine == "mesh":
        return _mesh_codec(data_shards, parity_shards, cauchy, device)
    if engine in ("", "auto"):
        mesh_env = os.environ.get("SEAWEEDFS_TPU_EC_MESH", "")
        if mesh_env == "1" or (
            mesh_env != "0" and device.type == "cuda" and torch.cuda.device_count() > 1
        ):
            return _mesh_codec(data_shards, parity_shards, cauchy, device)
    return _bulk_codec(data_shards, parity_shards, cauchy, device)


@lru_cache(maxsize=64)
def small_read_codec(data_shards: int, parity_shards: int, cauchy: bool = False):
    """Codec for small degraded reads: on the host by design, as in the JAX
    package (a 1 MB interval read is latency-bound, not worth a device
    round trip): ReedSolomonCPU on the native apply of csrc/gf256.cpp,
    whose build raises if it fails."""
    from seaweedfs_tpu_torch.ops.rs_cpu import ReedSolomonCPU

    return ReedSolomonCPU(data_shards, parity_shards, cauchy)


def _lrc_params(scheme) -> tuple[int, int, int] | None:
    l = getattr(scheme, "local_groups", 0)  # noqa: E741 — LRC term of art
    if not l:
        return None
    return scheme.data_shards, l, scheme.parity_shards - l


@lru_cache(maxsize=16)
def _lrc_codec(k: int, l: int, r: int, device: torch.device):  # noqa: E741
    from seaweedfs_tpu_torch.ops import lrc_codec

    if device.type == "cuda":
        return lrc_codec.LrcCuda(k, l, r, device)
    return lrc_codec.LrcTorch(k, l, r, device)


def pipeline_codec_for(scheme, device: str | torch.device | None = None):
    """pipeline_codec for the scheme's geometry and storage class.  LRC
    stays on one device, as in the JAX package: the mesh codec is RS-only."""
    params = _lrc_params(scheme)
    if params is None:
        return pipeline_codec(scheme.data_shards, scheme.parity_shards, device=device)
    return _lrc_codec(*params, resolve_device(device))


def small_read_codec_for(scheme):
    """small_read_codec for the scheme's geometry and storage class: the
    native host codec, LRC- or RS-planned per the scheme."""
    params = _lrc_params(scheme)
    if params is None:
        return small_read_codec(scheme.data_shards, scheme.parity_shards)
    return _lrc_host_codec(*params)


@lru_cache(maxsize=16)
def _lrc_host_codec(k: int, l: int, r: int):  # noqa: E741
    from seaweedfs_tpu_torch.ops.lrc_codec import LrcCPU

    return LrcCPU(k, l, r)
