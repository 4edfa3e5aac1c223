"""seaweedfs_tpu_torch — the PyTorch/CUDA port of seaweedfs_tpu.

The port keeps the JAX package's module paths (``ops/``, ``storage/``,
``commands/``, ``cli``) so each module's counterpart is found by name.  It
imports torch and numpy and nothing of seaweedfs_tpu; the GF(2^8) matrix
apply runs in hand-written CUDA kernels (``csrc/gf_apply.cu``, and
``csrc/gf_planes.cu`` for the plane-resident rebuild hop) built at first
use.  Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``-device cpu`` on the CLI).
"""

__version__ = "0.1.0"
