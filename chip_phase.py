#!/usr/bin/env python3
"""One cluster phase of chip_smoke.py alone on one GPU.

    python3 chip_phase.py PHASE [--seed N]

PHASE is one of 9-19 (the write path, failover, maintenance, storage, the
filer, S3, the RPC layers under TLS, the sharded filer, the maintenance
plane, replication, the file gateways and the message queue).  The kernels are
built as chip_smoke.py builds them, then the phase runs on cuda:0 in a
temporary directory and prints its own lines; a failed check exits 1.
Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time

import chip_smoke as cs

PHASES = {9: cs.phase_write_path, 10: cs.phase_failover, 11: cs.phase_maintenance,
          12: cs.phase_storage, 13: cs.phase_filer, 14: cs.phase_s3, 15: cs.phase_tls,
          16: cs.phase_shard, 17: cs.phase_admin, 18: cs.phase_sync, 19: cs.phase_gateways}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("phase", type=int, choices=sorted(PHASES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_phase: no CUDA device", file=sys.stderr)
        return 1
    from seaweedfs_tpu_torch.ops import _build

    ident = cs.gpu_identity()
    print(ident)
    _build.build_all()
    tmp = tempfile.mkdtemp(prefix=f"chip_phase{args.phase}-")
    t = time.perf_counter()
    try:
        PHASES[args.phase](argparse.Namespace(seed=args.seed, gib=1.0), tmp, ident,
                           torch.device("cuda", 0))
    except cs.SmokeFailure as e:
        print(f"FAIL: {e}")
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase {args.phase} wall {time.perf_counter() - t:.3f}s on {ident}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
