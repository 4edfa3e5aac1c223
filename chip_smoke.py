#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (seaweedfs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--gib G]

Phases, each printing what it found; any failure exits non-zero:

1. Device and build: the card's name and power limit, and an nvcc build of
   every kernel in seaweedfs_tpu_torch/csrc (one process per source, all
   started together), with ptxas's register report.
2. Kernel against its plain version on the card: the CUDA GF(2^8) apply
   against rs_torch.apply_matrix_reference, byte-exact, for the RS(10,4)
   encode matrix, a 1-loss and a 4-loss RS(10,4) rebuild matrix, RS(6,3),
   RS(12,4) and Cauchy(10,4), at ragged widths, the main-path width, an
   all-byte-values input and an unaligned strided view; then both timed with
   CUDA events at (10 x 6 MiB -> 4) and (10 x 64 MiB -> 4).
3. Main path at real size: a G GiB volume (a version-3 superblock, payload
   and a strict-valid .idx from --seed) goes through the port's own CLI,
   ``ec.encode.local`` on the card; parity is checked on the CPU over the
   first, a middle and the tail row; 4 shards (2 data, 2 parity) are deleted
   and ``ec.rebuild.local`` must regenerate them hash-identically.  The
   kernel's launch counter is zeroed just before and read just after each.

The line before the last holds the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  It needs CUDA: without it, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
NON_TENSOR_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(r: int, s: int, n: int) -> tuple[float, str]:
    """Least time for one (r, s) apply over n-byte rows: the bytes moved
    (inputs read once, outputs written once) over the memory rate, against
    r*s*n multiply-accumulates (a lookup and an XOR each) over the peak."""
    t_bytes = (s + r) * n / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * r * s * n / NON_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2 ------------------------------------------------------------------


def kernel_cases():
    from seaweedfs_tpu_torch.ops import rs_matrix

    enc = rs_matrix.build_encode_matrix(10, 4)
    one = tuple(i != 3 for i in range(14))
    four = tuple(i not in (0, 3, 10, 13) for i in range(14))
    return [
        ("rs10_4_encode", enc[10:]),
        ("rs10_4_rebuild_1loss", rs_matrix.reconstruction_matrix(10, 4, one, (3,))[0]),
        ("rs10_4_rebuild_4loss",
         rs_matrix.reconstruction_matrix(10, 4, four, (0, 3, 10, 13))[0]),
        ("rs6_3_encode", rs_matrix.build_encode_matrix(6, 3)[6:]),
        ("rs12_4_encode", rs_matrix.build_encode_matrix(12, 4)[12:]),
        ("cauchy10_4_encode", rs_matrix.build_cauchy_matrix(10, 4)[10:]),
    ]


def phase_kernel(rng, dev) -> dict:
    import numpy as np
    import torch

    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.ops.rs_torch import apply_matrix_reference

    max_err = 0
    n_checked = 0
    for name, mat in kernel_cases():
        r, s = mat.shape
        inputs = []
        for width in (1, 3, 4097, 6 * MIB):
            inputs.append((f"random w={width}", torch.from_numpy(
                rng.integers(0, 256, (s, width), dtype=np.uint8)).to(dev)))
        ramp = (np.arange(4097)[None, :] + 37 * np.arange(s)[:, None]) % 256
        inputs.append(("all byte values w=4097",
                       torch.from_numpy(ramp.astype(np.uint8)).to(dev)))
        wide = torch.from_numpy(rng.integers(0, 256, (s, 4101), dtype=np.uint8)).to(dev)
        inputs.append(("unaligned strided view w=4097", wide[:, 1:4098]))
        words = torch.from_numpy(rng.integers(0, 256, (s, 4096), dtype=np.uint8)).to(dev)
        inputs.append(("uint32 words W=1024", words.view(torch.uint32)))
        for label, x in inputs:
            got = rs_cuda.apply_matrix_cuda(mat, x)
            raw = x.view(torch.uint8) if x.dtype == torch.uint32 else x
            want = apply_matrix_reference(mat, raw)
            got_b = got.view(torch.uint8) if got.dtype == torch.uint32 else got
            torch.cuda.synchronize()
            err = int((got_b.int() - want.int()).abs().max().item())
            max_err = max(max_err, err)
            n_checked += 1
            check(err == 0 and got.dtype == x.dtype,
                  f"kernel != plain: {name} {label} (max abs err {err})")
        print(f"  {name} ({r}x{s}): byte-exact on {len(inputs)} inputs")
    check(rs_cuda.launches >= n_checked, f"launches {rs_cuda.launches} < {n_checked}")
    print(f"kernel checks: {n_checked} byte-exact, launches={rs_cuda.launches}, "
          f"max_abs_err={max_err}")

    enc = kernel_cases()[0][1]
    timings = {}
    for width in (6 * MIB, 64 * MIB):
        x = torch.from_numpy(rng.integers(0, 256, (10, width), dtype=np.uint8)).to(dev)
        ms = time_ms(lambda: rs_cuda.apply_matrix_cuda(enc, x), iters=20)
        plain_ms = time_ms(lambda: apply_matrix_reference(enc, x), iters=3, warmup=1)
        b_ms, b_by = bound_ms(4, 10, width)
        timings[width] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"timing 10x{width // MIB}MiB->4: kernel {ms:.6f} ms "
              f"({(14 * width) / ms / 1e6:.1f} GB/s), plain {plain_ms:.6f} ms, "
              f"bound {b_ms:.6f} ms ({b_by}), kernel at {100 * b_ms / ms:.1f}% of bound")
    return dict(max_err=max_err, timings=timings)


# -- phase 3 ------------------------------------------------------------------


def make_volume(directory: str, size: int, seed: int) -> bytes:
    """A version-3 .dat of ``size`` bytes (superblock + seeded payload) and
    a strict-valid .idx of a few thousand entries (with some deletions)
    inside it.  Returns the .ecx bytes the encode must produce."""
    import numpy as np

    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock

    rng = np.random.default_rng(seed)
    with open(os.path.join(directory, "1.dat"), "wb") as f:
        f.write(SuperBlock().to_bytes())  # version 3
        left = size - SUPER_BLOCK_SIZE
        while left:
            piece = min(left, 64 * MIB)
            f.write(rng.bytes(piece))
            left -= piece
    n = 4096
    ids = rng.permutation(np.unique(rng.integers(1, 1 << 40, 2 * n, dtype=np.uint64))[:n])
    offsets = np.sort(rng.integers(1, (size - 4096) // 8, n)).astype(np.uint32)
    sizes = rng.integers(1, 4096, n).astype(np.int32)
    entry = np.dtype([("id", ">u8"), ("off", ">u4"), ("size", ">i4")])
    puts = np.empty(n, entry)
    puts["id"], puts["off"], puts["size"] = ids, offsets, sizes
    dead = rng.choice(n, 64, replace=False)
    tombs = np.empty(64, entry)
    tombs["id"], tombs["off"], tombs["size"] = ids[dead], 0, -1
    with open(os.path.join(directory, "1.idx"), "wb") as f:
        f.write(puts.tobytes() + tombs.tobytes())
    live = np.delete(puts, dead)
    return live[np.argsort(live["id"].astype(np.uint64))].tobytes()


def run_cli(argv: list[str]) -> dict:
    """Run the port's CLI in this process; echo its output and return the
    stage breakdown it printed."""
    from seaweedfs_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print("".join(f"  | {line}\n" for line in out.splitlines()), end="")
    check(rc == 0, f"{argv[0]} exited {rc}")
    stages = [line[len("stages: "):] for line in out.splitlines() if line.startswith("stages: ")]
    check(len(stages) == 1, f"{argv[0]} printed no stage breakdown")
    return json.loads(stages[0])


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(16 * MIB):
            h.update(chunk)
    return h.hexdigest()


def check_parity(base: str, dat_size: int) -> int:
    """Parity of the first, a middle and the tail small row, recomputed on
    the CPU by the plain version over whole 1 MiB blocks."""
    import numpy as np
    import torch

    from seaweedfs_tpu_torch.ops import rs_matrix
    from seaweedfs_tpu_torch.ops.rs_torch import apply_matrix_reference
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME as sc

    k, m, blk = sc.data_shards, sc.parity_shards, sc.small_block_size
    check(dat_size <= sc.large_block_size * k, "volume has large rows; sampler assumes small rows")
    n_rows = -(-dat_size // (blk * k))
    enc = rs_matrix.build_encode_matrix(k, m)[k:]
    with open(base + ".dat", "rb") as dat:
        for row in sorted({0, n_rows // 2, n_rows - 1}):
            data = np.zeros((k, blk), dtype=np.uint8)
            for i in range(k):
                got = os.preadv(dat.fileno(), [memoryview(data[i])], (row * k + i) * blk)
                check(got == blk or (row == n_rows - 1), f"short .dat read in row {row}")
            want = apply_matrix_reference(enc, torch.from_numpy(data)).numpy()
            for sid in range(k + m):
                with open(base + f".ec{sid:02d}", "rb") as f:
                    f.seek(row * blk)
                    shard = np.frombuffer(f.read(blk), dtype=np.uint8)
                expect = data[sid] if sid < k else want[sid - k]
                check(np.array_equal(shard, expect), f"shard {sid} wrong in row {row}")
            print(f"  row {row}/{n_rows}: 10 data + 4 parity blocks of 1 MiB match the CPU plain version")
    return n_rows


def phase_main_path(args, ident: str) -> dict:
    from seaweedfs_tpu_torch.ops import rs_cuda

    size = int(args.gib * (1 << 30))
    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        t = time.perf_counter()
        want_ecx = make_volume(tmp, size, args.seed)
        print(f"volume: {size} bytes + .idx in {time.perf_counter() - t:.3f}s under {tmp}")
        base = os.path.join(tmp, "1")
        argv = ["-dir", tmp, "-volumeId", "1", "-device", "cuda"]

        rs_cuda.launches = 0
        enc = run_cli(["ec.encode.local", *argv])
        enc_launches = rs_cuda.launches
        check(enc_launches > 0, "ec.encode.local launched no kernel")
        with open(base + ".ecx", "rb") as f:
            check(f.read() == want_ecx, ".ecx differs from the sorted live .idx entries")
        n_rows = check_parity(base, size)
        hashes = {sid: sha256(base + f".ec{sid:02d}") for sid in range(14)}
        lost = (0, 3, 10, 13)
        for sid in lost:
            os.remove(base + f".ec{sid:02d}")

        rs_cuda.launches = 0
        reb = run_cli(["ec.rebuild.local", *argv])
        reb_launches = rs_cuda.launches
        check(reb_launches > 0, "ec.rebuild.local launched no kernel")
        for sid in lost:
            check(sha256(base + f".ec{sid:02d}") == hashes[sid], f"rebuilt shard {sid} differs")
        print(f"rebuild: shards {list(lost)} hash-identical to the encoded ones")
        shard_size = os.path.getsize(base + ".ec00")
        enc_gbs = size / enc["wall_s"] / 1e9
        reb_gbs = len(lost) * shard_size / reb["wall_s"] / 1e9
        print(f"encode on {ident}: {n_rows} rows, launches={enc_launches}, {enc_gbs:.3f} GB/s of .dat; "
              f"stages setup {enc['setup_s']:.4f}s read {enc['read_s']:.4f}s dispatch {enc['dispatch_s']:.4f}s "
              f"fetch {enc['fetch_s']:.4f}s write {enc['write_s']:.4f}s wall {enc['wall_s']:.4f}s")
        print(f"rebuild on {ident}: launches={reb_launches}, {reb_gbs:.3f} GB/s generated; "
              f"stages setup {reb['setup_s']:.4f}s read {reb['read_s']:.4f}s dispatch {reb['dispatch_s']:.4f}s "
              f"fetch {reb['fetch_s']:.4f}s write {reb['write_s']:.4f}s wall {reb['wall_s']:.4f}s")
        return dict(launches=enc_launches + reb_launches, encode=enc, rebuild=reb,
                    encode_gbs=enc_gbs, rebuild_gbs=reb_gbs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gib", type=float, default=1.0, help="volume size in GiB")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from seaweedfs_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    ident = gpu_identity()
    print(f"device: {torch.cuda.get_device_name(0)} ({ident}), torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    built = _build.build_all()
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
        print(f"build: {name} in {info['seconds']:.3f}s -> {info['path']}")
        for ln in ptxas:
            print(f"  ptxas: {ln}")

    try:
        kern = phase_kernel(np.random.default_rng(args.seed), dev)
        main_path = phase_main_path(args, ident)
    except SmokeFailure as e:
        print(f"FAIL: {e}")
        return 1
    t6 = kern["timings"][6 * MIB]
    record = {"kernels": [{
        "name": "gf_apply",
        "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/gf_apply.cu",
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:52",
        "launches": main_path["launches"],
        "max_abs_err": kern["max_err"],
        "ms": t6["ms"],
        "plain_ms": t6["plain_ms"],
        "bound_ms": t6["bound_ms"],
        "bound_by": t6["bound_by"],
        "library_ms": None,
        "shape": "10x6MiB->4",
        "ms_10x64MiB": kern["timings"][64 * MIB]["ms"],
        "plain_ms_10x64MiB": kern["timings"][64 * MIB]["plain_ms"],
        "bound_ms_10x64MiB": kern["timings"][64 * MIB]["bound_ms"],
        "encode_gbs": main_path["encode_gbs"],
        "rebuild_gbs": main_path["rebuild_gbs"],
    }]}
    print(f"total {time.perf_counter() - t_start:.3f}s")
    print(ident)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
