"""The port's native host library for the data plane: ``csrc/dp.cpp`` (the
volume server's C++ front door and the gateways' splice verbs) linked with
``csrc/crc32c.cpp``, built by g++ through ops/_build.py into
``build/kernels/`` at first use.  ``dataplane`` binds it with ctypes.

The port never loads the JAX package's prebuilt library: it builds its own
copy from its own sources, and a build or load that fails raises (there is
no Python stand-in behind an enabled plane).
"""

from __future__ import annotations

import ctypes


def load() -> ctypes.CDLL:
    """The data-plane library, built first if needed; raises when it
    cannot be built or loaded."""
    from seaweedfs_tpu_torch.ops import _build

    return _build.load("dp")
