"""``version``: print the port's version, torch, CUDA and the device (the
port's twin of seaweedfs_tpu/commands/version.py, which prints the JAX
backend)."""

from __future__ import annotations

from seaweedfs_tpu_torch.commands import command


@command("version", "print version, torch, CUDA and device info")
def run(args) -> int:
    import torch

    import seaweedfs_tpu_torch

    print(f"weed-tpu-torch {seaweedfs_tpu_torch.__version__}")
    cuda = torch.version.cuda or "none"
    if torch.cuda.is_available():
        device = f"cuda:0 {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})"
    else:
        device = "cpu (no CUDA device)"
    print(f"torch {torch.__version__} cuda {cuda} device={device}")
    return 0
