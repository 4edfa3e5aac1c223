"""LRC codecs on the port's matrix-generic RS codecs.

The port of seaweedfs_tpu/ops/lrc_codec.py.  The RS codecs take an
arbitrary GF(2^8) matrix (the plain apply in ops/rs_torch, the CUDA kernels
in ops/rs_cuda), so the LRC codecs subclass them and swap exactly two
things: the encode matrix (ops/lrc_matrix.build_lrc_matrix) and the
reconstruction planner (local-group repair first, rank-selected global
decode as fallback).  Encode and rebuild byte paths, padding and device
dispatch are the RS codecs'.

- ``LrcTorch`` (``lrc_torch``): the plain PyTorch codec, the counterpart of
  the JAX package's ``LrcCPU`` and ``lrc_jax``.
- ``LrcCuda`` (``lrc_cuda``): the CUDA kernels, the counterpart of
  ``lrc_pallas``.  It inherits ``reconstruct_words_multi``, the
  plane-resident rebuild hop (K3 pack, K2 plane apply, K4 unpack), as
  ``LrcPallas`` does; every target set there must plan to the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import lrc_matrix
from seaweedfs_tpu_torch.ops.rs_cuda import ReedSolomonCuda
from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch


class _LrcAlgebra:
    """Matrix + plan override shared by the port's LRC codecs."""

    def __init__(
        self,
        data_shards: int,
        local_groups: int,
        global_parities: int,
        device: str | torch.device | None = None,
    ):
        super().__init__(data_shards, local_groups + global_parities, device=device)
        self.local_groups = local_groups
        self.global_parities = global_parities
        self.matrix = lrc_matrix.build_lrc_matrix(
            data_shards, local_groups, global_parities
        )

    def recon_plan(
        self, present: tuple[bool, ...], targets: tuple[int, ...]
    ) -> tuple[np.ndarray, tuple[int, ...], str]:
        return lrc_matrix.reconstruction_plan(
            self.data_shards,
            self.local_groups,
            self.global_parities,
            tuple(present),
            tuple(targets),
        )


class LrcTorch(_LrcAlgebra, ReedSolomonTorch):
    """LRC(k, l, r) on the plain PyTorch codec (device defaults to CUDA,
    as every codec of the port; pass device="cpu" for the host)."""


class LrcCuda(_LrcAlgebra, ReedSolomonCuda):
    """LRC(k, l, r) on the CUDA kernels: K1 for encode and rebuild, K2-K4
    for the plane-resident hop."""


def lrc_torch(data_shards: int, local_groups: int, global_parities: int,
              device: str | torch.device | None = None) -> LrcTorch:
    return LrcTorch(data_shards, local_groups, global_parities, device)


def lrc_cuda(data_shards: int, local_groups: int, global_parities: int,
             device: str | torch.device | None = None) -> LrcCuda:
    return LrcCuda(data_shards, local_groups, global_parities, device)
