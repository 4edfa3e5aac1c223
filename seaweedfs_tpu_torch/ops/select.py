"""Codec selection: the port of seaweedfs_tpu/ops/select.py.

Bulk encode and rebuild run the CUDA kernel (ReedSolomonCuda); with
``device="cpu"`` they run the plain PyTorch codec (ReedSolomonTorch) on the
host.  Unlike the JAX package there is no link probe and no fallback to a
host engine: a missing CUDA device raises (rs_torch.resolve_device), it is
never hidden.
"""

from __future__ import annotations

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


def pipeline_codec(
    data_shards: int,
    parity_shards: int,
    cauchy: bool = False,
    device: str | torch.device | None = None,
):
    """Codec for the file pipelines (write_ec_files / rebuild_ec_files):
    the bulk codec — the pipeline itself stages the bytes through pinned
    host buffers."""
    return bulk_codec(data_shards, parity_shards, cauchy, device)


def small_read_codec(data_shards: int, parity_shards: int, cauchy: bool = False):
    """Codec for small degraded reads: on the host by design, as in the JAX
    package (a 1 MB interval read is latency-bound, not worth a device
    round trip)."""
    return _bulk_codec(data_shards, parity_shards, cauchy, torch.device("cpu"))


def _check_rs(scheme) -> None:
    if getattr(scheme, "local_groups", 0):
        raise NotImplementedError(
            "LRC schemes are not ported yet (ROADMAP.md, 'Still to port': LRC)"
        )


def pipeline_codec_for(scheme, device: str | torch.device | None = None):
    """pipeline_codec for the scheme's geometry (RS only in this port)."""
    _check_rs(scheme)
    return pipeline_codec(scheme.data_shards, scheme.parity_shards, device=device)


def small_read_codec_for(scheme):
    """small_read_codec for the scheme's geometry (RS only in this port)."""
    _check_rs(scheme)
    return small_read_codec(scheme.data_shards, scheme.parity_shards)
