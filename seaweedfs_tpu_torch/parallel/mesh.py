"""Device mesh for the distributed EC pipelines: the port of
seaweedfs_tpu/parallel/mesh.py.

Mesh axes, as in the JAX package:
  * ``stripe``: data parallelism over stripe columns.  RS column math is
    position-independent, so column ranges of a volume encode on different
    devices with no communication.
  * ``shard``: shard-row parallelism.  Shard rows (and the matrix rows that
    produce them) live on different devices; a rebuild gathers the
    surviving rows with device-to-device copies.

The JAX package runs one process whose single controller drives every chip
of a ``jax.sharding.Mesh``.  The counterpart here is one process with one
CUDA stream per mesh position: no launcher and no process group.  A mesh
may name the same device more than once (``devices=[torch.device("cuda",
0)] * 4``, or ``[torch.device("cpu")] * 8``): the counterpart of the JAX
tests' 8 virtual CPU devices, since torch has one CPU device and a
one-card machine one GPU.  Positions on one card still get distinct
streams, so the cross-stream waits are exercised there too.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Position:
    """One mesh position: its (shard, stripe) coordinates, its device and
    its stream (None on the CPU)."""

    shard: int
    stripe: int
    device: torch.device
    stream: torch.cuda.Stream | None


class Mesh:
    """A (shard, stripe) grid of devices with one stream per position."""

    def __init__(self, grid: list[list[torch.device]]):
        self.shape = {"shard": len(grid), "stripe": len(grid[0])}
        self.positions = tuple(
            Position(i, j, dev, torch.cuda.Stream(dev) if dev.type == "cuda" else None)
            for i, row in enumerate(grid)
            for j, dev in enumerate(row)
        )

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """Every position's device, row-major over (shard, stripe)."""
        return tuple(p.device for p in self.positions)

    @property
    def size(self) -> int:
        return len(self.positions)

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None, shard_par: int | None = None, devices=None) -> Mesh:
    """Build a (shard, stripe) mesh over the first ``n_devices`` devices
    (default: every CUDA device, cuda:0 .. device_count() - 1).

    ``shard_par`` fixes the shard-axis size (it must divide ``n_devices``);
    by default it is the largest of 1, 2 and 4 that divides ``n_devices``,
    so 8 devices become (shard=4, stripe=2) and one device (1, 1)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    if n_devices < 1:
        raise ValueError("a mesh needs at least one device")
    devices = devices[:n_devices]
    if shard_par is None:
        shard_par = 1
        for cand in (2, 4):
            if n_devices % cand == 0:
                shard_par = cand
    if n_devices % shard_par:
        raise ValueError(f"shard_par {shard_par} !| n_devices {n_devices}")
    stripe = n_devices // shard_par
    return Mesh([devices[i * stripe : (i + 1) * stripe] for i in range(shard_par)])
