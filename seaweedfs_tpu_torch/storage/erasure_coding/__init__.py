"""Erasure coding: RS(k,m) striping of volumes into .ecNN shard files, with
the matrix apply on the CUDA device (seaweedfs_tpu_torch.ops)."""

from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME, EcScheme

__all__ = ["DEFAULT_SCHEME", "EcScheme"]
