#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (seaweedfs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--gib G]

Phases, each printing what it found; any failure exits non-zero:

1. Device and build: the card's name and power limit, and an nvcc build of
   every kernel in seaweedfs_tpu_torch/csrc (and a g++ build of its host
   CRC32C; one process per source, all started together), with ptxas's
   registers and spills for every kernel instantiation; a spill in K1 or K2
   fails the run.
2. Kernels against their plain versions on the card, byte-exact:
   - K1, the CUDA GF(2^8) apply, against rs_torch.apply_matrix_reference,
     for the RS(10,4) encode matrix, a 1-loss and a 4-loss RS(10,4) rebuild
     matrix, RS(6,3), RS(12,4), Cauchy(10,4), a stack of three 4-loss
     RS(10,4) rebuild matrices (12 output rows: two grid.y groups), and the
     LRC(10,2,2) matrices: its encode rows (4 x 10), the local repair of
     shard 3 (1 x 5, all ones), the two-group local repair of {3, 7}
     (2 x 10) and the global rebuild of {0, 5, 12, 13} (4 x 10); at ragged
     widths, the main-path width, an all-byte-values input and an unaligned
     strided view; then timed with CUDA events at (10 x 6 MiB -> 4) and
     (10 x 64 MiB -> 4) with the encode matrix, at (10 x 64 MiB -> 4) with
     the 4-loss rebuild matrix, the rebuild's own launch, and at the LRC
     local repairs' shapes (5 x 64 MiB -> 1, 10 x 64 MiB -> 2): once
     through the wrapper call by call, and once as 20 calls captured in a
     CUDA graph and replayed, which leaves out the host's work between
     launches.
   - K3 pack, K2 plane apply and K4 unpack against their plain versions in
     rs_torch, for K1's matrices but RS(12,4), the stack of five RS(10,4)
     target sets and the stack of the LRC hop's four target sets, at 1, 2
     and 3 blocks and on an all-byte-values input, with unpack(pack(x)) ==
     x; then at the widths of phase 4's chunks (64 MiB and the 39 MiB
     tail): pack of 10 rows, K2 -> 4 rows and -> 8 rows (both stacks), and
     unpack of 10 rows and of each target set's slice of the 8; then each
     timed at 10 x 64 MiB (K2 -> 8 with both stacks), and pack + K2 +
     unpack against K1 at (10 x 64 MiB -> 4).
3. Main path at real size: a G GiB volume (a version-3 superblock, payload
   and a strict-valid .idx from --seed whose last live needle ends at the
   .dat's end) goes through the port's own CLI, ``ec.encode.local`` on the
   card; parity is checked on the CPU over the first, a middle and the tail
   row; 4 shards (2 data, 2 parity) are deleted and ``ec.rebuild.local``
   must regenerate them hash-identically.  The kernel's launch counter is
   zeroed just before and read just after each.
4. Plane-resident rebuild hop at real size, on the volume of phase 3: with
   shards 0, 3, 10 and 13 taken as absent, the plan's 10 survivors are read
   in the rebuild pipeline's chunks, uploaded, and
   ``ReedSolomonCuda.reconstruct_words_multi`` rebuilds the target sets
   (0), (3), (10), (13) and (0, 3, 10, 13) at once; every result must equal
   the shard files' bytes.  K3, K2 and K4 must launch in it, K1 must not.
   Then ``ec.decode.local`` reassembles the volume from its data shards:
   the .dat must have the original's sha256 and the .idx the .ecx's bytes.
5. The LRC main path: the same .dat and .idx are encoded as LRC(10,2,2)
   by ``ec.encode.local -code lrc`` on the card (parity checked on the CPU
   by LrcTorch, localGroups 2 in the .vif); three flag-less
   ``ec.rebuild.local`` runs (the storage class read from the .vif)
   regenerate {3} locally from 5 shards, {3, 7} locally from 10 and
   {0, 5, 12, 13} globally, hash-identically, each launching K1; the LRC
   plane hop rebuilds the sets (12), (13), (12, 13) and (0, 5, 12, 13) over
   the global plan's 10 survivors through K3, K2 and K4 (not K1);
   ``ec.decode.local`` restores the .dat; and the loss {0, 1, 10, 13} must
   fail as unrecoverable, with no launch and no shard file written.
6. The multi-device EC codec (parallel/): the mesh over the card's own
   devices (its size printed); a logical (2, 2) mesh over cuda:0 x 4 (one
   stream per position) at 10 x 64 MiB, where sharded_encode,
   sharded_reconstruct (4 losses), ReedSolomonMesh in width and rows mode
   (encode and rebuild) and ec_round_trip_step (residual 0) must equal the
   plain GF(2^8) apply on the card, launching K1-K4; K1-K4 at the
   positions' shapes against their plain versions, and timed, with the
   mesh encodes against one K1 and the upload of a pinned buffer in column
   slices two ways; phase 3's volume through ``ec.encode.local`` and
   ``ec.rebuild.local`` under SEAWEEDFS_TPU_EC_MESH=1 and through the
   pipeline with the logical mesh in both modes, hash-identical to phase
   3's shards; one RS rebuild under a WEED_REPAIR_RATE_MB whose 1 s burst
   covers half its reads, which must wait about a second
   (weedtpu_repair_wait_seconds_total) and ride the cuda schedule cache;
   and measure_scaling for the device counts present.
7. The volume server's EC service and the needle-read path: a G GiB .dat
   of real version-3 needles from --seed (1 KiB payloads, the size `weed
   benchmark` writes, 1064 bytes on disk each, plus 8 of 256 KiB-1 MiB;
   64 tombstoned in the .idx; a sample equal to Needle.to_bytes) is served
   by ``python -m seaweedfs_tpu_torch.cli volume -device cuda`` in a
   subprocess and driven over localhost gRPC: EcShardsGenerate (K1 in the
   server; .ecx == the sorted live .idx, parity sampled on the CPU),
   EcShardsMount and EcShardsInfo (14 shards), EcShardRead of seeded
   ranges (== the shard files), twice EcShardsUnmount and EcShardsDelete
   of {0, 3, 10, 13} and EcShardsRebuild (hash-identical; the first and
   second rebuild of one process side by side), EcBlobDelete (then
   EcShardRead with its file_key says is_deleted), EcShardsToVolume (the
   .dat's sha256 comes back), and the server's /metrics (EC operations,
   the cuda schedule cache and its K1 launches, which start at 0 in the
   new process).  The same .dat is
   encoded as LRC(10,2,2) by ``ec.encode.local -code lrc`` and with 64 MiB
   large blocks by write_ec_files (one 10 x 64 MiB large row: parity
   sampled in both areas, needles read back).  Then about 20,000 needles
   (every one that crosses a 1 MiB block, and the big ones) are read here
   through Store, EcVolume.read_needle and EcShardLocator's local
   reconstruction, in five states (RS healthy, RS without {0, 3, 10, 13},
   LRC without {3}, {0, 5, 12, 13} and {0, 1, 10, 11}): every payload equal
   to its seeded bytes, every tombstoned needle NotFoundError, needles/s,
   p50/p99 and the repair bytes read per reconstructed byte (5 for an LRC
   local plan, 10 for a global decode).

Bounds: the larger of the bytes a function must move over the memory rate
and its operations at 64 32-bit logic ops a clock per SM, from the card's SM
count and its clocks.max.sm.  The operations are those of the cheapest
formulation the port has.  K2's are the GF(2) matrix's word XORs: the
lesser of one per set bit and the table apply's count (csrc/gf_table.cuh:
11 per input row and half to build its table, then one per output plane,
input row and half; 860 against 1224 set bits per 32 bytes at 10 -> 4 with
the RS(10,4) encode matrix).  K3/K4's are the 72-op transpose, and K1's
(the same GF(2^8) apply) pack, those XORs and unpack.  Bytes set every
bound here.

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
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
LOGIC_OPS_PER_CLOCK_PER_SM = 64  # 32-bit integer logic ops, compute capability 9.0
TRANSPOSE_OPS_PER_32_BYTES = 72  # gf_planes.cu: 3 delta-swap stages of 4 x 6 ops
HOP_SETS = [(0,), (3,), (10,), (13,), (0, 3, 10, 13)]
LRC_HOP_SETS = [(12,), (13,), (12, 13), (0, 5, 12, 13)]
LRC_REBUILDS = [  # lost shards, plan mode, plan inputs
    ((3,), "local", (0, 1, 2, 4, 10)),
    ((3, 7), "local", (0, 1, 2, 4, 5, 6, 8, 9, 10, 11)),
    ((0, 5, 12, 13), "global", (1, 2, 3, 4, 6, 7, 8, 9, 10, 11)),
]
LRC_UNRECOVERABLE = (0, 1, 10, 13)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str, *fmt: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader" + "".join(fmt)],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def gpu_identity() -> str:
    return nvidia_smi("name,power.limit")


def card_rates() -> dict:
    """Logic-op rate of card 0: the per-SM rate times SMs times the most the
    SM clock may run (clocks.max.sm)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm", ",nounits")) * 1e6
    return dict(sms=sms, clock_hz=clock_hz,
                logic_ops_per_s=sms * LOGIC_OPS_PER_CLOCK_PER_SM * clock_hz)


def demangle(mangled: str) -> str:
    """'_ZN12_GLOBAL__N_115gf_apply_kernelILi4EEEv...' -> 'gf_apply_kernel<4>'."""
    i, name = 0, mangled
    while m := re.compile(r"(\d+)").search(mangled, i):
        start, size = m.end(), int(m.group(1))
        part = mangled[start : start + size]
        if part.endswith("_kernel"):
            args = re.match(r"I((?:Li\d+E)+)E", mangled[start + size :])
            values = re.findall(r"Li(\d+)E", args.group(1)) if args else []
            name = part + (f"<{','.join(values)}>" if values else "")
            break
        i = start + max(size, 1)
    return name


def ptxas_report(log: str) -> list[dict]:
    """Registers and spill bytes of every kernel in an `nvcc -Xptxas -v` log."""
    kernels = []
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            kernels.append(dict(kernel=demangle(m.group(1)), registers=None, spill_bytes=0))
        elif kernels and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            kernels[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif kernels and (m := re.search(r"Used (\d+) registers", line)):
            kernels[-1]["registers"] = int(m.group(1))
    return kernels


def zero_launch_counts() -> None:
    from seaweedfs_tpu_torch.ops import rs_cuda

    rs_cuda.launches = rs_cuda.pack_launches = rs_cuda.unpack_launches = 0
    rs_cuda.plane_launches = 0


def launch_counts() -> dict:
    from seaweedfs_tpu_torch.ops import rs_cuda

    return {"gf_apply": rs_cuda.launches, "gf_pack": rs_cuda.pack_launches,
            "gf_planes_apply": rs_cuda.plane_launches, "gf_unpack": rs_cuda.unpack_launches}


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


def graph_ms(fn, iters: int) -> float:
    """Device time of one call: iters calls captured in a CUDA graph (after
    one call outside it, which uploads and caches what the call needs) and
    replayed once warm and once between CUDA events."""
    import torch

    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """Least time for work that moves n_bytes (inputs read once, outputs
    written once) and does ops operations on a unit of ops_per_s."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def xors_per_32_bytes(matrix) -> int:
    """Word XORs of the matrix's cheapest GF(2) program per 32 bytes of row
    (a plane word holds 4 bytes of each of 8 planes): the lesser of one per
    set bit and the table apply's 11 per (input row, half) plus one per
    (output plane, input row, half)."""
    from seaweedfs_tpu_torch.ops import gf256

    r, s = matrix.shape
    return min(int(gf256.matrix_to_gf2(matrix).sum()), 2 * s * (11 + 8 * r))


def k1_bound(matrix, n: int, rates: dict) -> tuple[float, str]:
    """K1 over n-byte rows: (s + r) n bytes; as logic ops, the bit-slice
    form of the same apply: pack s rows, the XORs, unpack r rows."""
    r, s = matrix.shape
    ops = ((s + r) * TRANSPOSE_OPS_PER_32_BYTES + xors_per_32_bytes(matrix)) * n / 32
    return bound_ms((s + r) * n, ops, rates["logic_ops_per_s"])


def k2_bound(matrix, n: int, rates: dict) -> tuple[float, str]:
    """K2 over n-byte plane rows: (s + r) n bytes; the XORs as logic ops."""
    r, s = matrix.shape
    return bound_ms((s + r) * n, xors_per_32_bytes(matrix) * n / 32, rates["logic_ops_per_s"])


def transpose_bound(rows: int, n: int, rates: dict) -> tuple[float, str]:
    """K3 or K4 over n-byte rows: 2 rows n bytes; the transpose's logic ops."""
    return bound_ms(2 * rows * n, TRANSPOSE_OPS_PER_32_BYTES * rows * n / 32,
                    rates["logic_ops_per_s"])


# -- phase 2 ------------------------------------------------------------------


def loss4_matrix(lost: tuple[int, ...]):
    from seaweedfs_tpu_torch.ops import rs_matrix

    present = tuple(i not in lost for i in range(14))
    return rs_matrix.reconstruction_matrix(10, 4, present, lost)[0]


def lrc_plan(lost: tuple[int, ...], targets: tuple[int, ...] | None = None):
    """(matrix, inputs, mode) of LRC(10,2,2) rebuilding ``targets`` (default:
    all of ``lost``) with ``lost`` absent."""
    from seaweedfs_tpu_torch.ops import lrc_matrix

    present = tuple(i not in lost for i in range(14))
    return lrc_matrix.reconstruction_plan(10, 2, 2, present, targets or lost)


def kernel_cases():
    from seaweedfs_tpu_torch.ops import lrc_matrix, rs_matrix, xor_sched

    enc = rs_matrix.build_encode_matrix(10, 4)
    one = tuple(i != 3 for i in range(14))
    stack12, _rows = xor_sched.stack_matrices(
        [loss4_matrix(lost) for lost in [(0, 3, 10, 13), (1, 2, 11, 12), (4, 5, 6, 7)]])
    return [
        ("rs10_4_encode", enc[10:]),
        ("rs10_4_rebuild_1loss", rs_matrix.reconstruction_matrix(10, 4, one, (3,))[0]),
        ("rs10_4_rebuild_4loss", loss4_matrix((0, 3, 10, 13))),
        ("rs6_3_encode", rs_matrix.build_encode_matrix(6, 3)[6:]),
        ("rs12_4_encode", rs_matrix.build_encode_matrix(12, 4)[12:]),
        ("cauchy10_4_encode", rs_matrix.build_cauchy_matrix(10, 4)[10:]),
        ("rs10_4_3x4loss_stack", stack12),
        ("lrc10_2_2_encode", lrc_matrix.build_lrc_matrix(10, 2, 2)[10:]),
        ("lrc10_2_2_local_1loss", lrc_plan((3,))[0]),
        ("lrc10_2_2_local_2groups", lrc_plan((3, 7))[0]),
        ("lrc10_2_2_global_4loss", lrc_plan((0, 5, 12, 13))[0]),
    ]


def phase_kernel(rng, dev, rates) -> dict:
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

    cases = dict(kernel_cases())
    timings = {}
    for key, name, width in [(6 * MIB, "rs10_4_encode", 6 * MIB),
                             (64 * MIB, "rs10_4_encode", 64 * MIB),
                             ("rebuild_4loss", "rs10_4_rebuild_4loss", 64 * MIB),
                             ("lrc_local_1loss", "lrc10_2_2_local_1loss", 64 * MIB),
                             ("lrc_local_2groups", "lrc10_2_2_local_2groups", 64 * MIB)]:
        mat = cases[name]
        r, s = mat.shape
        x = torch.from_numpy(rng.integers(0, 256, (s, width), dtype=np.uint8)).to(dev)
        ms = time_ms(lambda: rs_cuda.apply_matrix_cuda(mat, x), iters=20)
        g_ms = graph_ms(lambda: rs_cuda.apply_matrix_cuda(mat, x), iters=20)
        plain_ms = time_ms(lambda: apply_matrix_reference(mat, x), iters=3, warmup=1)
        b_ms, b_by = k1_bound(mat, width, rates)
        timings[key] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"timing {name} {s}x{width // MIB}MiB->{r}: kernel {ms:.6f} ms "
              f"({((s + r) * width) / ms / 1e6:.1f} GB/s), in a CUDA graph {g_ms:.6f} ms, "
              f"plain {plain_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}), kernel at "
              f"{100 * b_ms / ms:.1f}% of bound ({100 * b_ms / g_ms:.1f}% in the graph)")
    return dict(max_err=max_err, timings=timings)


def plane_cases() -> dict:
    """K2's matrices: K1's cases but RS(12,4) (with the 12-row stack), the
    stack of the five RS(10,4) target sets of phase 4 and the stack of the
    four LRC(10,2,2) target sets of phase 5 (8 output rows each)."""
    from seaweedfs_tpu_torch.ops import rs_matrix, xor_sched

    cases = {name: mat for name, mat in kernel_cases() if name != "rs12_4_encode"}
    present = tuple(i not in HOP_SETS[-1] for i in range(14))
    cases["rs10_4_5set_stack"], _rows = xor_sched.stack_matrices(
        [rs_matrix.reconstruction_matrix(10, 4, present, ts)[0] for ts in HOP_SETS])
    cases["lrc10_2_2_4set_stack"], _rows = xor_sched.stack_matrices(
        [lrc_plan(LRC_HOP_SETS[-1], ts)[0] for ts in LRC_HOP_SETS])
    return cases


def max_abs_err(got, want) -> int:
    import torch

    return int((got.view(torch.uint8).int() - want.view(torch.uint8).int()).abs().max().item())


def shard_chunks(dat_size: int) -> list[tuple[int, int]]:
    """(offset, bytes) of the rebuild pipeline's chunks over one shard of a
    volume of small rows only."""
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_encoder import DEFAULT_CHUNK
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME as sc

    blk = sc.small_block_size
    shard = -(-dat_size // (blk * sc.data_shards)) * blk
    return [(off, min(DEFAULT_CHUNK, shard - off)) for off in range(0, shard, DEFAULT_CHUNK)]


def phase_planes(rng, dev, rates, ident: str, widths: list[int]) -> dict:
    import numpy as np
    import torch

    from seaweedfs_tpu_torch.ops import rs_cuda, rs_torch

    bw = rs_torch.BLOCK_WORDS
    errs = {"pack": 0, "unpack": 0, "apply": 0}
    n_checked = 0

    def held(kind: str, got, want, label: str) -> None:
        nonlocal n_checked
        err = max_abs_err(got, want)
        errs[kind] = max(errs[kind], err)
        n_checked += 1
        check(err == 0 and got.shape == want.shape and got.dtype == torch.uint32,
              f"{kind} kernel != plain: {label} (max abs err {err})")

    cases = plane_cases()
    for name, mat in cases.items():
        r, s = mat.shape
        inputs = [(f"random {b} block(s)", torch.from_numpy(
            rng.integers(0, 2**32, (s, b * bw), dtype=np.uint32)).to(dev)) for b in (1, 2, 3)]
        ramp = (np.arange(2 * bw * 4)[None, :] + 37 * np.arange(s)[:, None]) % 256
        inputs.append(("all byte values, 2 blocks",
                       torch.from_numpy(ramp.astype(np.uint8)).to(dev).view(torch.uint32)))
        for label, x in inputs:
            planes = rs_cuda.pack_words(x)
            held("pack", planes, rs_torch.pack_words_reference(x), f"{name} {label}")
            held("unpack", rs_cuda.unpack_words(planes), x, f"{name} {label}: unpack(pack(x))")
            out = rs_cuda.apply_matrix_planes(mat, planes)
            held("apply", out, rs_torch.apply_matrix_planes_reference(mat, planes), f"{name} {label}")
            held("unpack", rs_cuda.unpack_words(out), rs_torch.unpack_words_reference(out),
                 f"{name} {label}")
        print(f"  {name} ({r}x{s}): pack, plane apply, unpack byte-exact on {len(inputs)} inputs")
    print(f"plane kernel checks: {n_checked} byte-exact, launches pack={rs_cuda.pack_launches} "
          f"apply={rs_cuda.plane_launches} unpack={rs_cuda.unpack_launches}, max_abs_err={errs}")

    # The hop's shapes: each chunk width, 10 survivor rows, the 8-row stack
    # and its per-set slices, as reconstruct_words_multi launches them.
    enc, stack = cases["rs10_4_encode"], cases["rs10_4_5set_stack"]
    lrc_stack = cases["lrc10_2_2_4set_stack"]
    widest = torch.from_numpy(
        rng.integers(0, 2**32, (10, max(64 * MIB, *widths) // 4), dtype=np.uint32)).to(dev)
    for width in widths:
        x = widest[:, : width // 4].contiguous()
        label = f"10x{width / MIB:g}MiB"
        planes = rs_cuda.pack_words(x)
        held("pack", planes, rs_torch.pack_words_reference(x), label)
        back = rs_cuda.unpack_words(planes)
        held("unpack", back, rs_torch.unpack_words_reference(planes), label)
        check(torch.equal(back, x), f"unpack(pack(x)) != x at {label}")
        held("apply", rs_cuda.apply_matrix_planes(enc, planes),
             rs_torch.apply_matrix_planes_reference(enc, planes), f"{label} -> 4")
        for stack_name, mat, sets in [("RS", stack, HOP_SETS), ("LRC", lrc_stack, LRC_HOP_SETS)]:
            out = rs_cuda.apply_matrix_planes(mat, planes)
            held("apply", out, rs_torch.apply_matrix_planes_reference(mat, planes),
                 f"{label} -> 8 ({stack_name} stack)")
            row = 0
            for ts in sets:
                part = out[row : row + len(ts)]
                held("unpack", rs_cuda.unpack_words(part), rs_torch.unpack_words_reference(part),
                     f"{label} {stack_name} set {ts}")
                row += len(ts)
        print(f"  {label}: pack, K2 -> 4 and -> 8 (RS and LRC stacks), unpack of 10 rows and "
              f"of the {len(HOP_SETS)} RS and {len(LRC_HOP_SETS)} LRC sets' slices byte-exact")
    print(f"plane kernel checks at the hop's widths: {n_checked} byte-exact in all, "
          f"max_abs_err={errs}")

    width = 64 * MIB
    x = widest[:, : width // 4].contiguous()
    planes = rs_cuda.pack_words(x)
    timings = {}
    for key, fn, plain, (b_ms, b_by) in [
        ("pack", lambda: rs_cuda.pack_words(x), lambda: rs_torch.pack_words_reference(x),
         transpose_bound(10, width, rates)),
        ("unpack", lambda: rs_cuda.unpack_words(planes),
         lambda: rs_torch.unpack_words_reference(planes), transpose_bound(10, width, rates)),
        ("apply_4", lambda: rs_cuda.apply_matrix_planes(enc, planes),
         lambda: rs_torch.apply_matrix_planes_reference(enc, planes), k2_bound(enc, width, rates)),
        ("apply_8", lambda: rs_cuda.apply_matrix_planes(stack, planes),
         lambda: rs_torch.apply_matrix_planes_reference(stack, planes),
         k2_bound(stack, width, rates)),
        ("apply_8_lrc", lambda: rs_cuda.apply_matrix_planes(lrc_stack, planes),
         lambda: rs_torch.apply_matrix_planes_reference(lrc_stack, planes),
         k2_bound(lrc_stack, width, rates)),
    ]:
        ms = time_ms(fn, iters=20)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        timings[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"timing {key} 10x64MiB on {ident}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"bound {b_ms:.6f} ms ({b_by}), kernel at {100 * b_ms / ms:.1f}% of bound")

    def hop():
        return rs_cuda.unpack_words(rs_cuda.apply_matrix_planes(enc, rs_cuda.pack_words(x)))

    def k1():
        return rs_cuda.apply_matrix_cuda(enc, x)

    check(torch.equal(hop(), k1()), "pack + K2 + unpack != K1 at 10x64MiB->4")
    runs = [time_ms(k1, 20), time_ms(hop, 20), time_ms(hop, 20), time_ms(k1, 20)]
    k1_ms, hop_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
    print(f"pack + K2 + unpack vs K1 at 10x64MiB->4 on {ident}: {hop_ms:.6f} ms vs "
          f"{k1_ms:.6f} ms (runs K1, hop, hop, K1: {', '.join(f'{t:.6f}' for t in runs)}), "
          f"ratio {hop_ms / k1_ms:.3f}")
    return dict(errs=errs, timings=timings, hop_ms=hop_ms, k1_ms=k1_ms)


# -- phase 3 ------------------------------------------------------------------


def make_volume(directory: str, size: int, seed: int) -> bytes:
    """A version-3 .dat of ``size`` bytes (superblock + seeded payload) and
    a strict-valid .idx of a few thousand entries (with some deletions)
    inside it, the last live needle ending at the .dat's last byte, so a
    decode restores the .dat whole.  Returns the .ecx bytes the encode must
    produce."""
    import numpy as np

    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
    from seaweedfs_tpu_torch.storage.types import Version, get_actual_size

    check(size % 8 == 0, f"a volume of {size} bytes does not end on a needle boundary")
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
    # every needle ends below size - 4096 (the largest is 4131 bytes long)
    offsets = np.sort(rng.integers(1, (size - 8192) // 8, n)).astype(np.uint32)
    sizes = rng.integers(1, 4096, n).astype(np.int32)
    entry = np.dtype([("id", ">u8"), ("off", ">u4"), ("size", ">i4")])
    puts = np.empty(n + 1, entry)
    puts["id"][:n], puts["off"][:n], puts["size"][:n] = ids, offsets, sizes
    last = 1000  # bytes of the needle that ends the volume
    puts[n] = (1 << 40, (size - get_actual_size(last, Version.V3)) // 8, last)
    dead = rng.choice(n, 64, replace=False)
    tombs = np.empty(64, entry)
    tombs["id"], tombs["off"], tombs["size"] = ids[dead], 0, -1
    with open(os.path.join(directory, "1.idx"), "wb") as f:
        f.write(puts.tobytes() + tombs.tobytes())
    live = np.delete(puts, dead)
    return live[np.argsort(live["id"].astype(np.uint64))].tobytes()


def run_cli(argv: list[str], stages: bool = True) -> dict:
    """Run the port's CLI in this process; echo its output and return the
    stage breakdown it printed (or {} when ``stages`` is false)."""
    from seaweedfs_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print("".join(f"  | {line}\n" for line in out.splitlines()), end="")
    check(rc == 0, f"{argv[0]} exited {rc}")
    found = [line[len("stages: "):] for line in out.splitlines() if line.startswith("stages: ")]
    if not stages:
        check(not found, f"{argv[0]} printed a stage breakdown")
        return {}
    check(len(found) == 1, f"{argv[0]} printed no stage breakdown")
    return json.loads(found[0])


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(16 * MIB):
            h.update(chunk)
    return h.hexdigest()


def check_parity(base: str, dat_size: int, codec) -> int:
    """Parity of the first, a middle and the tail small row, recomputed on
    the CPU by ``codec`` (the plain PyTorch codec of the volume's storage
    class, on the CPU) over whole 1 MiB blocks."""
    import numpy as np

    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME as sc

    k, m, blk = codec.data_shards, codec.parity_shards, sc.small_block_size
    check(codec.device.type == "cpu", f"parity reference on {codec.device}")
    check(dat_size <= sc.large_block_size * k, "volume has large rows; sampler assumes small rows")
    n_rows = -(-dat_size // (blk * k))
    with open(base + ".dat", "rb") as dat:
        for row in sorted({0, n_rows // 2, n_rows - 1}):
            data = np.zeros((k, blk), dtype=np.uint8)
            for i in range(k):
                got = os.preadv(dat.fileno(), [memoryview(data[i])], (row * k + i) * blk)
                check(got == blk or (row == n_rows - 1), f"short .dat read in row {row}")
            want = codec.encode(data)
            for sid in range(k + m):
                with open(base + f".ec{sid:02d}", "rb") as f:
                    f.seek(row * blk)
                    shard = np.frombuffer(f.read(blk), dtype=np.uint8)
                expect = data[sid] if sid < k else want[sid - k]
                check(np.array_equal(shard, expect), f"shard {sid} wrong in row {row}")
            print(f"  row {row}/{n_rows}: {k} data + {m} parity blocks of 1 MiB match the CPU "
                  f"plain version ({type(codec).__name__})")
    return n_rows


def stage_line(st: dict) -> str:
    return (f"stages setup {st['setup_s']:.4f}s read {st['read_s']:.4f}s "
            f"dispatch {st['dispatch_s']:.4f}s fetch {st['fetch_s']:.4f}s "
            f"write {st['write_s']:.4f}s wall {st['wall_s']:.4f}s")


def phase_decode(directory: str, dat_sha: str, ecx: bytes, label: str) -> float:
    """``ec.decode.local`` of the volume in ``directory`` with its .dat and
    .idx removed: the .dat must come back with the original sha256, the
    .idx with the .ecx's bytes (no .ecj exists), no staged file behind."""
    base = os.path.join(directory, "1")
    for ext in (".dat", ".idx"):
        os.remove(base + ext)
    t = time.perf_counter()
    run_cli(["ec.decode.local", "-dir", directory, "-volumeId", "1", "-device", "cuda"],
            stages=False)
    dt = time.perf_counter() - t
    check(sha256(base + ".dat") == dat_sha, f"{label}: decoded .dat differs from the original")
    with open(base + ".idx", "rb") as f:
        check(f.read() == ecx, f"{label}: decoded .idx differs from the .ecx")
    check(not [f for f in os.listdir(directory) if f.endswith(".tmp")],
          f"{label}: staged files left behind")
    print(f"decode ({label}): .dat sha256-identical to the original, .idx == .ecx, in {dt:.3f}s")
    return dt


def phase_main_path(args, ident: str, dev, rates) -> dict:
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.ops.rs_cuda import ReedSolomonCuda
    from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch

    size = int(args.gib * (1 << 30))
    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        t = time.perf_counter()
        want_ecx = make_volume(tmp, size, args.seed)
        print(f"volume: {size} bytes + .idx in {time.perf_counter() - t:.3f}s under {tmp}")
        base = os.path.join(tmp, "1")
        dat_sha = sha256(base + ".dat")
        # phase 5's volume: the same .dat and .idx, as links
        lrc_dir = os.path.join(tmp, "lrc")
        os.mkdir(lrc_dir)
        for ext in (".dat", ".idx"):
            os.link(base + ext, os.path.join(lrc_dir, "1" + ext))
        argv = ["-dir", tmp, "-volumeId", "1", "-device", "cuda"]

        zero_launch_counts()
        enc = run_cli(["ec.encode.local", *argv])
        enc_launches = rs_cuda.launches
        check(enc_launches > 0, "ec.encode.local launched no kernel")
        with open(base + ".ecx", "rb") as f:
            check(f.read() == want_ecx, ".ecx differs from the sorted live .idx entries")
        n_rows = check_parity(base, size, ReedSolomonTorch(10, 4, device="cpu"))
        hashes = {sid: sha256(base + f".ec{sid:02d}") for sid in range(14)}
        lost = (0, 3, 10, 13)
        for sid in lost:
            os.remove(base + f".ec{sid:02d}")

        zero_launch_counts()
        reb = run_cli(["ec.rebuild.local", *argv])
        reb_launches = rs_cuda.launches
        check(reb_launches > 0, "ec.rebuild.local launched no kernel")
        for sid in lost:
            check(sha256(base + f".ec{sid:02d}") == hashes[sid], f"rebuilt shard {sid} differs")
        print(f"rebuild: shards {list(lost)} hash-identical to the encoded ones")
        hop = phase_hop(base, ident, dev, shard_chunks(size), ReedSolomonCuda(10, 4, device=dev),
                        HOP_SETS)
        decode_s = phase_decode(tmp, dat_sha, want_ecx, "RS(10,4)")
        shard_size = os.path.getsize(base + ".ec00")
        enc_gbs = size / enc["wall_s"] / 1e9
        reb_gbs = len(lost) * shard_size / reb["wall_s"] / 1e9
        print(f"encode on {ident}: {n_rows} rows, launches={enc_launches}, {enc_gbs:.3f} GB/s of "
              f".dat; {stage_line(enc)}")
        print(f"rebuild on {ident}: launches={reb_launches}, {reb_gbs:.3f} GB/s generated; "
              f"{stage_line(reb)}")
        for sid in range(14):  # room for phase 5's shards
            os.remove(base + f".ec{sid:02d}")
        lrc = phase_lrc(lrc_dir, size, ident, dev, dat_sha, want_ecx)
        shutil.rmtree(lrc_dir)  # room for phase 6's shards
        mesh = phase_mesh(args, tmp, hashes, ident, dev, rates)
        for name in os.listdir(tmp):  # room for phase 7's volumes
            path = os.path.join(tmp, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        ec_service = phase_ec_service(args, tmp, ident, dev)
        return dict(launches=enc_launches + reb_launches, encode=enc, rebuild=reb,
                    encode_gbs=enc_gbs, rebuild_gbs=reb_gbs, hop=hop, decode_s=decode_s,
                    lrc=lrc, mesh=mesh, ec_service=ec_service)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 4 ------------------------------------------------------------------


def phase_hop(base: str, ident: str, dev, chunks: list[tuple[int, int]], codec,
              sets: list[tuple[int, ...]]) -> dict:
    """The plane-resident rebuild hop over the volume's survivors, chunk by
    chunk as the rebuild pipeline reads them; each result held against the
    shard files on disk.  The target sets (all planned on the same inputs,
    the last one the union of the others) are a synthetic mix that drives
    the kernels at the stack's 8 rows; they rebuild the last set's distinct
    shards, so GB/s is given both ways."""
    import numpy as np
    import torch

    from seaweedfs_tpu_torch.ops.rs_torch import BLOCK_WORDS

    lost = sets[-1]
    present = tuple(i not in lost for i in range(codec.total_shards))
    _mat, inputs, _mode = codec.recon_plan(present, lost)
    shard_size = os.path.getsize(base + ".ec00")
    check(shard_size == sum(n for _off, n in chunks), f"shard of {shard_size} bytes, chunks {chunks}")
    generated_rows = sum(len(ts) for ts in sets)
    distinct = len(lost)
    name = type(codec).__name__
    results = []
    with contextlib.ExitStack() as stack:
        files = {sid: stack.enter_context(open(base + f".ec{sid:02d}", "rb"))
                 for sid in (*inputs, *lost)}
        zero_launch_counts()
        for off, n in chunks:
            check(n % (4 * BLOCK_WORDS) == 0, f"chunk of {n} bytes is not whole 128 KB blocks")
            host = torch.empty((len(inputs), n), dtype=torch.uint8,
                               pin_memory=dev.type == "cuda")
            rows = host.numpy()
            for i, sid in enumerate(inputs):
                got = os.preadv(files[sid].fileno(), [memoryview(rows[i])], off)
                check(got == n, f"short read of shard {sid} at {off}")
            words = host.to(dev, non_blocking=True).view(torch.uint32)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            outs = codec.reconstruct_words_multi(present, sets, words)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            want = {sid: np.frombuffer(os.pread(files[sid].fileno(), n, off), dtype=np.uint8)
                    for sid in lost}
            for ts, out in zip(sets, outs):
                got = out.view(torch.uint8).cpu().numpy()
                check(got.shape == (len(ts), n), f"hop result for {ts} has shape {got.shape}")
                for row, sid in enumerate(ts):
                    check(np.array_equal(got[row], want[sid]),
                          f"hop: shard {sid} of set {ts} differs in [{off}, {off + n})")
            gbs, gbs_distinct = generated_rows * n / ms / 1e6, distinct * n / ms / 1e6
            results.append(dict(bytes=n, ms=ms, gbs=gbs, gbs_distinct=gbs_distinct))
            print(f"hop ({name}) chunk [{off}, {off + n}) of {len(inputs)} survivors on {ident}: "
                  f"{ms:.6f} ms, {gbs_distinct:.3f} GB/s of {distinct} distinct shards rebuilt "
                  f"({gbs:.3f} GB/s over all {generated_rows} rows); {len(sets)} sets equal the "
                  f"shard files")
        launches = launch_counts()
    check(launches["gf_apply"] == 0, f"the hop launched K1 {launches['gf_apply']} times")
    for kernel in ("gf_pack", "gf_planes_apply", "gf_unpack"):
        check(launches[kernel] > 0, f"the hop launched no {kernel}")
    print(f"hop ({name}): {len(results)} chunks over {shard_size} bytes per shard, "
          f"launches {launches}")
    return dict(chunks=results, launches=launches)


# -- phase 5 ------------------------------------------------------------------


def phase_lrc(directory: str, size: int, ident: str, dev, dat_sha: str, want_ecx: bytes) -> dict:
    """The LRC(10,2,2) main path on the volume of phase 3 (see the module
    docstring): encode, three flag-less rebuilds, the LRC plane hop, the
    decode, and an unrecoverable loss that must touch nothing."""
    import numpy as np

    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.ops.lrc_codec import LrcCuda, LrcTorch
    from seaweedfs_tpu_torch.ops.rs_torch import BLOCK_WORDS
    from seaweedfs_tpu_torch.storage.volume_info import maybe_load_volume_info

    base = os.path.join(directory, "1")
    argv = ["-dir", directory, "-volumeId", "1", "-device", "cuda"]

    zero_launch_counts()
    enc = run_cli(["ec.encode.local", *argv, "-code", "lrc"])
    enc_launches = rs_cuda.launches
    check(enc_launches > 0, "ec.encode.local -code lrc launched no kernel")
    check(enc["engine"] == "LrcCuda", f"LRC encode ran {enc['engine']}")
    with open(base + ".ecx", "rb") as f:
        check(f.read() == want_ecx, "LRC .ecx differs from the sorted live .idx entries")
    n_rows = check_parity(base, size, LrcTorch(10, 2, 2, device="cpu"))
    info = maybe_load_volume_info(base + ".vif")
    check(info is not None and (info.data_shards, info.parity_shards, info.local_groups)
          == (10, 4, 2), f".vif records {info}")
    hashes = {sid: sha256(base + f".ec{sid:02d}") for sid in range(14)}
    shard_size = os.path.getsize(base + ".ec00")
    enc_gbs = size / enc["wall_s"] / 1e9
    print(f"LRC encode on {ident}: {n_rows} rows, launches={enc_launches}, {enc_gbs:.3f} GB/s of "
          f".dat, .vif localGroups 2; {stage_line(enc)}")

    rebuilds = []
    for lost, mode, inputs in LRC_REBUILDS:
        for sid in lost:
            os.remove(base + f".ec{sid:02d}")
        zero_launch_counts()
        reb = run_cli(["ec.rebuild.local", *argv])  # no -code: the class comes from the .vif
        launches = rs_cuda.launches
        check(launches > 0, f"LRC rebuild of {lost} launched no kernel")
        check((reb["mode"], tuple(reb["inputs"]), reb["read_bytes"])
              == (mode, inputs, len(inputs) * shard_size),
              f"LRC rebuild of {lost}: plan {reb['mode']} {reb['inputs']} read {reb['read_bytes']}")
        for sid in lost:
            check(sha256(base + f".ec{sid:02d}") == hashes[sid], f"LRC rebuilt shard {sid} differs")
        gbs = len(lost) * shard_size / reb["wall_s"] / 1e9
        rebuilds.append(dict(lost=lost, mode=mode, launches=launches, gbs=gbs, stages=reb))
        print(f"LRC rebuild {list(lost)} on {ident}: {mode} from {len(inputs)} shards "
              f"({reb['read_bytes']} bytes read), launches={launches}, hash-identical, "
              f"{gbs:.3f} GB/s generated; {stage_line(reb)}")

    # the hop: every set plans globally on the same 10 inputs; (0,) alone
    # would plan locally on others, which the hop refuses before launching
    codec = LrcCuda(10, 2, 2, device=dev)
    present = tuple(i not in LRC_HOP_SETS[-1] for i in range(14))
    zero_launch_counts()
    try:
        codec.reconstruct_words_multi(present, [(12,), (0,)],
                                      np.zeros((10, BLOCK_WORDS), np.uint32))
        check(False, "the LRC hop took target sets with different inputs")
    except ValueError as e:
        check("same inputs" in str(e), f"the LRC hop refused mixed sets with: {e}")
    check(not any(launch_counts().values()), "the refused LRC hop launched a kernel")
    hop = phase_hop(base, ident, dev, shard_chunks(size), codec, LRC_HOP_SETS)
    decode_s = phase_decode(directory, dat_sha, want_ecx, "LRC(10,2,2)")

    for sid in LRC_UNRECOVERABLE:
        os.remove(base + f".ec{sid:02d}")
    before = sorted(os.listdir(directory))
    zero_launch_counts()
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        rc = cli.main(["ec.rebuild.local", *argv])
    print(f"  | {err.getvalue().strip()}")
    check(rc == 1 and "rank 9 < 10" in err.getvalue(),
          f"rebuild of {LRC_UNRECOVERABLE} exited {rc}: {err.getvalue()}")
    check(not any(launch_counts().values()), f"the unrecoverable rebuild launched {launch_counts()}")
    check(sorted(os.listdir(directory)) == before, "the unrecoverable rebuild wrote a file")
    print(f"LRC rebuild {list(LRC_UNRECOVERABLE)}: unrecoverable, no launch, no file written")
    return dict(launches=enc_launches + sum(r["launches"] for r in rebuilds), encode=enc,
                encode_gbs=enc_gbs, rebuilds=rebuilds, hop=hop, decode_s=decode_s)


# -- phase 6 ------------------------------------------------------------------


def k2_bits_bound(bits, n: int, rates: dict) -> tuple[float, str]:
    """K2 with a GF(2) bit-matrix over n-byte plane rows: (s + r) n bytes;
    the lesser of its set bits and the table apply's XORs as logic ops."""
    r, s = bits.shape[0] // 8, bits.shape[1] // 8
    xors = min(int(bits.sum()), 2 * s * (11 + 8 * r))
    return bound_ms((s + r) * n, xors * n / 32, rates["logic_ops_per_s"])


def best_host_ms(fn, iters: int = 3) -> float:
    """Host-clock ms of fn() through a synchronize, best of iters."""
    import torch

    best = float("inf")
    for _ in range(iters + 1):  # the first call warms
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t) * 1e3)
    return best


def phase_mesh_ops(args, dev, rates, ident, lmesh) -> dict:
    """The logical (2, 2) mesh over cuda:0 x 4 at 10 x 64 MiB: every entry
    point of parallel/ held byte for byte against the plain GF(2^8) apply
    on the card (residual 0 for the round trip), with the launch counts of
    that run; then K1-K4 at the positions' shapes against their plain
    versions, and timed."""
    import torch

    from seaweedfs_tpu_torch.ops import rs_cuda, rs_matrix, rs_torch
    from seaweedfs_tpu_torch.parallel import distributed_ec as de
    from seaweedfs_tpu_torch.parallel import gf2

    width = 64 * MIB
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    data = torch.randint(0, 256, (10, width), dtype=torch.uint8, device=dev, generator=gen)
    words = data.view(torch.uint32)
    enc = rs_matrix.matrix_for(10, 4)[10:]
    parity_ref = rs_torch.apply_matrix_reference(enc, data)
    shards = torch.cat([data, parity_ref])
    present = tuple(i not in HOP_SETS[-1] for i in range(14))
    _recon, inputs = rs_matrix.reconstruction_matrix(10, 4, present, HOP_SETS[-1])
    survivors = shards[list(inputs)]
    lost_ref = shards[list(HOP_SETS[-1])]

    def exact(got, want, label: str) -> None:
        check(torch.equal(got.view(torch.uint8), want),
              f"mesh: {label} differs from the plain version ({tuple(got.shape)})")

    zero_launch_counts()
    exact(de.sharded_encode(words, lmesh, 10, 4), parity_ref, "sharded_encode")
    exact(de.sharded_reconstruct(survivors.view(torch.uint32), present, HOP_SETS[-1], lmesh,
                                 10, 4), lost_ref, "sharded_reconstruct of 4 losses")
    for mode in ("width", "rows"):
        codec = de.ReedSolomonMesh(10, 4, mesh=lmesh, mode=mode)
        exact(codec.encode_device(data)[:, : width // 4], parity_ref, f"{mode} encode")
        exact(codec.reconstruct_device(present, HOP_SETS[-1], survivors)[:, : width // 4],
              lost_ref, f"{mode} rebuild of 4 losses")
    parity, residual = de.ec_round_trip_step(lmesh, 10, 4)(words)
    residual = int(residual)
    check(residual == 0, f"round trip residual {residual}")
    exact(parity, parity_ref, "round-trip parity")
    torch.cuda.synchronize()
    launches = launch_counts()
    for kernel, n in launches.items():
        check(n > 0, f"the mesh's entry points launched no {kernel}")
    print(f"mesh (2, 2) over {lmesh.size} x {dev} at 10x64MiB: sharded_encode, sharded_reconstruct "
          f"{HOP_SETS[-1]}, ReedSolomonMesh width and rows (encode, 4-loss rebuild) and "
          f"ec_round_trip_step (residual {residual}) byte-exact against the plain apply; "
          f"launches {launches}")

    # K1-K4 at the positions' shapes, against their plain versions (not counted)
    bits = gf2.expand_bits(enc)
    k1_x = words[:, : width // 16]  # a width-mode position: 10 x 16 MiB
    stripe = words[:, : width // 8]  # a rows-mode stripe slice: 10 x 32 MiB
    errs = {"gf_apply": max_abs_err(rs_cuda.apply_matrix_cuda(enc, k1_x),
                                    rs_torch.apply_matrix_reference(enc, k1_x.view(torch.uint8)))}
    planes = rs_cuda.pack_words(stripe)
    errs["gf_pack"] = max_abs_err(planes, rs_torch.pack_words_reference(stripe))
    outs = [rs_cuda.apply_bits_planes(bits[16 * i : 16 * (i + 1)], planes) for i in range(2)]
    errs["gf_planes_apply"] = max(
        max_abs_err(o, rs_torch.apply_bits_planes_reference(bits[16 * i : 16 * (i + 1)], planes))
        for i, o in enumerate(outs))
    errs["gf_unpack"] = max(max_abs_err(rs_cuda.unpack_words(o), rs_torch.unpack_words_reference(o))
                            for o in outs)
    odd = words[:, 1 : 1 + 3 * rs_torch.BLOCK_WORDS // 2]  # misaligned, 1.5 blocks: padded
    errs["apply_bits_padded"] = max_abs_err(gf2.apply_bits(bits, odd),
                                            gf2.apply_bits_reference(bits, odd))
    for name, err in errs.items():
        check(err == 0, f"{name} at the mesh positions' shapes: max abs err {err}")
    print(f"K1-K4 at the mesh positions' shapes (K1 10x16MiB->4, K3 10x32MiB, K2 -> 2 rows of "
          f"each shard owner, K4 2x32MiB, gf2.apply_bits at a misaligned 1.5-block width) "
          f"byte-exact: {errs}")

    timings = {}
    for key, fn, plain, (b_ms, b_by) in [
        ("k1_10x16MiB_to_4", lambda: rs_cuda.apply_matrix_cuda(enc, k1_x),
         lambda: rs_torch.apply_matrix_reference(enc, k1_x.view(torch.uint8)),
         k1_bound(enc, width // 4, rates)),
        ("pack_10x32MiB", lambda: rs_cuda.pack_words(stripe),
         lambda: rs_torch.pack_words_reference(stripe), transpose_bound(10, width // 2, rates)),
        ("apply_bits_32MiB_to_2", lambda: rs_cuda.apply_bits_planes(bits[:16], planes),
         lambda: rs_torch.apply_bits_planes_reference(bits[:16], planes),
         k2_bits_bound(bits[:16], width // 2, rates)),
        ("unpack_2x32MiB", lambda: rs_cuda.unpack_words(outs[0]),
         lambda: rs_torch.unpack_words_reference(outs[0]), transpose_bound(2, width // 2, rates)),
    ]:
        ms = time_ms(fn, iters=20)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        timings[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"timing mesh position {key} on {ident}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"bound {b_ms:.6f} ms ({b_by}), kernel at {100 * b_ms / ms:.1f}% of bound")

    width_codec = de.ReedSolomonMesh(10, 4, mesh=lmesh, mode="width")
    rows_codec = de.ReedSolomonMesh(10, 4, mesh=lmesh, mode="rows")
    ops = {"single_k1": lambda: rs_cuda.apply_matrix_cuda(enc, words),
           "mesh_width": lambda: width_codec.encode_words(words),
           "mesh_rows": lambda: rows_codec.encode_words(words)}
    runs = {name: [] for name in ops}
    for name in ["single_k1", "mesh_width", "mesh_rows", "mesh_rows", "mesh_width", "single_k1"]:
        runs[name].append(time_ms(ops[name], iters=10))
    whole = {name: sum(t) / len(t) for name, t in runs.items()}
    print(f"encode 10x64MiB->4 on {ident}, CUDA-event ms (runs in the order single, width, rows, "
          f"rows, width, single): single-device K1 {runs['single_k1']}, mesh width "
          f"{runs['mesh_width']}, mesh rows {runs['mesh_rows']}")

    host = torch.empty((10, width), dtype=torch.uint8, pin_memory=True)
    host.copy_(data.cpu())
    cols = [slice(p * width // 4, (p + 1) * width // 4) for p in range(4)]
    upload = {
        "per_position_strided": best_host_ms(lambda: [host[:, c].to(dev) for c in cols]),
        "one_upload_then_d2d": best_host_ms(
            lambda: [x[:, c].contiguous() for x in [host.to(dev, non_blocking=True)] for c in cols]),
    }
    print(f"upload of a pinned 10x64MiB buffer in 4 column slices on {ident}, best host ms: "
          f"{upload}")
    return dict(launches=launches, errs=errs, timings=timings, whole_ms=whole, whole_runs=runs,
                upload_ms=upload)


def phase_mesh_pipeline(directory: str, hashes: dict, ident: str, dev, lmesh) -> dict:
    """The 1 GiB volume of phase 3 through the mesh codec: ``ec.encode.local``
    and ``ec.rebuild.local`` under SEAWEEDFS_TPU_EC_MESH=1 (the card's own
    devices), then write_ec_files / rebuild_ec_files with the logical (2, 2)
    mesh in both modes, and one RS rebuild under a WEED_REPAIR_RATE_MB that
    must wait about a second; every shard hash-identical to phase 3's."""
    from seaweedfs_tpu_torch import stats
    from seaweedfs_tpu_torch.ops import repair_budget, select
    from seaweedfs_tpu_torch.parallel.distributed_ec import ReedSolomonMesh
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder

    base = os.path.join(directory, "1")
    argv = ["-dir", directory, "-volumeId", "1", "-device", "cuda"]
    lost = HOP_SETS[-1]

    def same(sids, label: str) -> None:
        for sid in sids:
            check(sha256(base + f".ec{sid:02d}") == hashes[sid], f"{label}: shard {sid} differs")

    def drop() -> None:
        for sid in lost:
            os.remove(base + f".ec{sid:02d}")

    out = {}
    os.environ["SEAWEEDFS_TPU_EC_MESH"] = "1"
    select._mesh_codec.cache_clear()
    try:
        enc = run_cli(["ec.encode.local", *argv])
        check(enc["engine"] == "ReedSolomonMesh", f"SEAWEEDFS_TPU_EC_MESH=1 encode ran {enc['engine']}")
        same(range(14), "mesh encode")
        drop()
        reb = run_cli(["ec.rebuild.local", *argv])
        same(lost, "mesh rebuild")
    finally:
        del os.environ["SEAWEEDFS_TPU_EC_MESH"]
    print(f"SEAWEEDFS_TPU_EC_MESH=1 encode on {ident}: hash-identical to phase 3; {stage_line(enc)}")
    print(f"SEAWEEDFS_TPU_EC_MESH=1 rebuild {list(lost)} on {ident}: hash-identical; "
          f"{stage_line(reb)}")
    out["cli"] = dict(encode=enc, rebuild=reb)

    for mode in ("width", "rows"):
        codec = ReedSolomonMesh(10, 4, mesh=lmesh, mode=mode)
        enc_st, reb_st = {}, {}
        ec_encoder.write_ec_files(base, codec=codec, stats=enc_st)
        same(range(14), f"logical mesh {mode} encode")
        drop()
        ec_encoder.rebuild_ec_files(base, codec=codec, stats=reb_st)
        same(lost, f"logical mesh {mode} rebuild")
        print(f"logical (2, 2) mesh {mode} through the pipeline on {ident}: hash-identical; "
              f"encode {stage_line(enc_st)}; rebuild {stage_line(reb_st)}")
        out[mode] = dict(encode=enc_st, rebuild=reb_st)

    drop()
    shard_size = os.path.getsize(base + ".ec01")
    read_bytes = 10 * shard_size
    rate = read_bytes / 2  # bytes/s: the 1 s burst covers half the reads
    nominal = (read_bytes - rate) / rate
    waited0 = stats.REPAIR_WAIT_SECONDS.value()
    read0 = stats.REPAIR_BYTES.value(code="rs", mode="global", dir="read")
    os.environ["WEED_REPAIR_RATE_MB"] = repr(rate / (1 << 20))  # the budget's MB is 2^20 bytes
    repair_budget.reload()
    try:
        reb = run_cli(["ec.rebuild.local", *argv])
    finally:
        del os.environ["WEED_REPAIR_RATE_MB"]
        repair_budget.reload()
    waited = stats.REPAIR_WAIT_SECONDS.value() - waited0
    same(lost, "throttled rebuild")
    check(stats.REPAIR_BYTES.value(code="rs", mode="global", dir="read") - read0 == read_bytes,
          "the throttled rebuild's read bytes are not in weedtpu_repair_bytes_total")
    check(0.5 * nominal <= waited <= nominal + 0.05 and reb["wall_s"] >= nominal,
          f"throttled rebuild waited {waited} s (nominal {nominal} s), wall {reb['wall_s']} s")
    cuda_cache = reb.get("sched_cache", {}).get("cuda", {})
    check(cuda_cache.get("hit", 0) > 0 and cuda_cache.get("miss", 1) == 0,
          f"the repeated survivor pattern did not ride the cuda schedule cache: {reb}")
    print(f"throttled rebuild on {ident}: WEED_REPAIR_RATE_MB={rate / (1 << 20):.6f}, "
          f"{read_bytes} bytes read, weedtpu_repair_wait_seconds_total +{waited:.6f} s "
          f"(nominal {nominal:.6f} s), sched_cache {reb['sched_cache']}; {stage_line(reb)}")
    out["throttled"] = dict(rebuild=reb, waited_s=waited, nominal_s=nominal,
                            rate_mb_s=rate / (1 << 20))
    return out


def phase_mesh(args, directory: str, hashes: dict, ident: str, dev, rates) -> dict:
    """Phase 6: the multi-device EC codec (parallel/) on the card."""
    import torch

    from seaweedfs_tpu_torch.parallel import distributed_ec, make_mesh

    own = make_mesh()
    print(f"mesh over the card's own devices: {own.size} position(s) ({torch.cuda.device_count()} "
          f"CUDA device(s)), shape {own.shape}")
    lmesh = make_mesh(devices=[dev] * 4, shard_par=2)
    streams = {p.stream.cuda_stream for p in lmesh.positions}
    check(lmesh.shape == {"shard": 2, "stripe": 2} and len(streams) == 4,
          f"logical mesh {lmesh} has {len(streams)} streams")
    ops = phase_mesh_ops(args, dev, rates, ident, lmesh)
    zero_launch_counts()
    pipeline = phase_mesh_pipeline(directory, hashes, ident, dev, lmesh)
    pipe_launches = launch_counts()
    check(pipe_launches["gf_apply"] > 0, "the mesh pipeline launched no K1")
    t = time.perf_counter()
    scaling = distributed_ec.measure_scaling(shard_mb=64)
    print(f"measure_scaling on {ident} ({time.perf_counter() - t:.3f}s): {json.dumps(scaling)}")
    launches = {k: ops["launches"][k] + pipe_launches[k] for k in pipe_launches}
    return dict(ops=ops, pipeline=pipeline, scaling=scaling, launches=launches,
                devices=own.size)


# -- phase 7 ------------------------------------------------------------------

NEEDLE_PAYLOAD = 1024  # `weed benchmark`'s default -size
BIG_NEEDLES = 8  # 256 KiB - 1 MiB payloads: reads of several intervals
DEAD_NEEDLES = 64
READ_SAMPLE = 20_000
LARGE_ROW_BLOCK = 64 * MIB  # the large-row pipeline's large blocks
READ_STATES = [  # label, volume, shards removed
    ("RS healthy", "rs", ()),
    ("RS {0,3,10,13} removed", "rs", (0, 3, 10, 13)),
    ("LRC {3} removed", "lrc", (3,)),
    ("LRC {0,5,12,13} removed", "lrc", (0, 5, 12, 13)),
    ("LRC {0,1,10,11} removed", "lrc", (0, 1, 10, 11)),
]


def make_needle_volume(directory: str, size: int, seed: int) -> dict:
    """A version-3 .dat of real needles, about ``size`` bytes: 1 KiB
    payloads (1064 bytes on disk each, with a last-modified time) and
    BIG_NEEDLES larger ones at seeded places, and its .idx with
    DEAD_NEEDLES of the small ones tombstoned.  The records are built in
    bulk from --seed; a seeded sample must equal ``Needle.to_bytes``."""
    import numpy as np

    from seaweedfs_tpu_torch.storage.needle import FLAG_HAS_LAST_MODIFIED, Needle
    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
    from seaweedfs_tpu_torch.storage.types import Version, get_actual_size
    from seaweedfs_tpu_torch.util.crc32c import crc32c_rows

    rng = np.random.default_rng(seed)
    body = 4 + NEEDLE_PAYLOAD + 1 + 5  # data size, data, flags, last modified
    rec = get_actual_size(body, Version.V3)
    big_sizes = [int(s) for s in rng.integers(256 << 10, (1 << 20) + 1, BIG_NEEDLES)]
    big_recs = [get_actual_size(4 + s + 1 + 5, Version.V3) for s in big_sizes]
    n = (size - SUPER_BLOCK_SIZE - sum(big_recs)) // rec
    total = n + BIG_NEEDLES
    ids = rng.permutation(np.unique(rng.integers(1, 1 << 48, total + total // 8)))[:total]
    check(len(ids) == total, "needle ids collide")
    cookies = rng.integers(0, 1 << 32, total)
    modified = rng.integers(1_500_000_000, 1_800_000_000, total)
    stamps = rng.integers(1, 1 << 62, total)
    recs = np.zeros((n, rec), np.uint8)
    o_data = 20
    o_flags = o_data + NEEDLE_PAYLOAD
    o_crc = o_flags + 1 + 5
    payload = recs[:, o_data:o_flags]
    payload[:] = np.frombuffer(rng.bytes(n * NEEDLE_PAYLOAD), np.uint8).reshape(n, NEEDLE_PAYLOAD)

    def put(col: int, values, dtype: str, width: int | None = None) -> None:
        raw = np.asarray(values).astype(dtype).view(np.uint8).reshape(len(values), -1)
        raw = raw[:, raw.shape[1] - (width or raw.shape[1]):]
        recs[:, col : col + raw.shape[1]] = raw

    put(0, cookies[:n], ">u4")
    put(4, ids[:n], ">u8")
    put(12, np.full(n, body), ">u4")
    put(16, np.full(n, NEEDLE_PAYLOAD), ">u4")
    recs[:, o_flags] = FLAG_HAS_LAST_MODIFIED
    put(o_flags + 1, modified[:n], ">u8", 5)
    put(o_crc, crc32c_rows(payload), ">u4")
    put(o_crc + 4, stamps[:n], ">u8")

    def needle(i: int, data: bytes) -> Needle:
        return Needle(id=int(ids[i]), cookie=int(cookies[i]), data=data,
                      flags=FLAG_HAS_LAST_MODIFIED, last_modified=int(modified[i]),
                      append_at_ns=int(stamps[i]))

    for i in rng.choice(n, min(n, 512), replace=False):
        check(recs[i].tobytes() == needle(int(i), payload[i].tobytes()).to_bytes(Version.V3),
              f"bulk needle record {i} differs from Needle.to_bytes")
    offsets = np.empty(n, np.int64)
    cuts = [0, *sorted(int(c) for c in rng.choice(np.arange(1, n), BIG_NEEDLES, replace=False)), n]
    big = []
    with open(os.path.join(directory, "1.dat"), "wb") as f:
        f.write(SuperBlock().to_bytes())  # version 3
        pos = SUPER_BLOCK_SIZE
        for j in range(BIG_NEEDLES + 1):
            lo, hi = cuts[j], cuts[j + 1]
            offsets[lo:hi] = pos + rec * np.arange(hi - lo)
            f.write(recs[lo:hi])
            pos += rec * (hi - lo)
            if j < BIG_NEEDLES:
                data = rng.bytes(big_sizes[j])
                record = needle(n + j, data).to_bytes(Version.V3)
                big.append(dict(id=int(ids[n + j]), data=data, offset=pos, size=4 + len(data) + 6))
                f.write(record)
                pos += len(record)
    entry = np.dtype([("id", ">u8"), ("off", ">u4"), ("size", ">i4")])
    puts = np.empty(total, entry)
    puts["id"] = ids
    puts["off"][:n] = offsets // 8
    puts["off"][n:] = [b["offset"] // 8 for b in big]
    puts["size"][:n] = body
    puts["size"][n:] = [b["size"] for b in big]
    puts = puts[np.argsort(puts["off"].astype(np.int64), kind="stable")]  # write order
    dead = rng.choice(n, DEAD_NEEDLES, replace=False)
    tombs = np.empty(DEAD_NEEDLES, entry)
    tombs["id"], tombs["off"], tombs["size"] = ids[dead], 0, -1
    with open(os.path.join(directory, "1.idx"), "wb") as f:
        f.write(puts.tobytes() + tombs.tobytes())
    live = puts[~np.isin(puts["id"], ids[dead])]
    crossing = np.flatnonzero(offsets // MIB != (offsets + rec - 1) // MIB)
    return dict(recs=recs, payload=payload, ids=ids, n=n, rec=rec, offsets=offsets, big=big,
                dead=set(int(i) for i in dead), dat_size=pos, crossing=crossing,
                ecx=live[np.argsort(live["id"].astype(np.uint64))].tobytes())


def read_sample(vol: dict, seed: int) -> list[tuple[int, bytes]]:
    """(needle id, payload) of READ_SAMPLE seeded live 1 KiB needles, every
    live needle that crosses a 1 MiB block boundary, and the big ones."""
    import numpy as np

    rng = np.random.default_rng(seed)
    live = np.setdiff1d(np.arange(vol["n"]), np.fromiter(vol["dead"], np.int64))
    picked = set(int(i) for i in rng.choice(live, min(READ_SAMPLE, len(live)), replace=False))
    picked |= set(int(i) for i in vol["crossing"]) - vol["dead"]
    sample = [(int(vol["ids"][i]), vol["payload"][i].tobytes()) for i in sorted(picked)]
    sample += [(b["id"], b["data"]) for b in vol["big"]]
    return [sample[i] for i in rng.permutation(len(sample))]


class _Server:
    """``python -m seaweedfs_tpu_torch.cli volume`` in a subprocess on
    localhost: started with ``-device``, verbosity 1 (its stage lines go to
    ``log``), stopped with SIGTERM (killed if it does not exit)."""

    def __init__(self, directory: str, device: str, log: str):
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, WEEDTPU_V="1",
                   PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
        self.log = log
        self._log_file = open(log, "w")
        t = time.perf_counter()
        # port 0: the server binds free ports itself and names them on its
        # first line
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "volume", "-dir", directory,
             "-ip", "127.0.0.1", "-port", "0", "-grpcPort", "0", "-metricsPort", "0",
             "-device", device],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=self._log_file, text=True)
        line = self.proc.stdout.readline().strip()
        self.start_s = time.perf_counter() - t
        bound = re.search(r"gRPC on 127\.0\.0\.1:(\d+) .*metrics on 127\.0\.0\.1:(\d+)", line)
        if bound is None:
            self.stop()
            raise SmokeFailure(f"the volume server did not start: {line!r}; "
                               f"log: {self.log_text()[-2000:]}")
        self.grpc_port, self.metrics_port = int(bound[1]), int(bound[2])
        print(f"volume server subprocess pid {self.proc.pid} up in {self.start_s:.3f}s: {line}")

    def log_text(self) -> str:
        if not self._log_file.closed:
            self._log_file.flush()
        with open(self.log) as f:
            return f.read()

    def metrics(self) -> str:
        import urllib.request

        url = f"http://127.0.0.1:{self.metrics_port}/metrics"
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.read().decode()

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.proc.stdout.close()
        self._log_file.close()
        return self.proc.returncode


def metric(text: str, name: str, **labels) -> float:
    """The value of one series of /metrics text (0 when absent)."""
    want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    series = f"{name}{{{want}}}" if labels else name
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def server_stages(log: str, op: str) -> list[dict]:
    """The pipeline stage breakdowns the server logged for ``op``."""
    return [json.loads(line.split(" stages: ", 1)[1]) for line in log.splitlines()
            if f"] ec: {op} " in line and " stages: " in line]


def phase_server(vol: dict, directory: str, dev, ident: str, seed: int) -> dict:
    """The volume server's EC service, over gRPC from this process to a
    server subprocess on the card (see the module docstring)."""
    import grpc
    import numpy as np

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as pb

    base = os.path.join(directory, "1")
    dat_sha = sha256(base + ".dat")
    server = _Server(directory, dev.type, os.path.join(os.path.dirname(directory), "server.log"))
    walls: dict = {}
    try:
        before = server.metrics()
        for kernel in ("gf_apply", "gf_planes_apply", "gf_pack", "gf_unpack"):
            check(metric(before, "weedtpu_cuda_kernel_launches", kernel=kernel) == 0,
                  f"the new server process has launched {kernel}")
        stub = rpc.volume_stub(f"127.0.0.1:{server.grpc_port}")

        def call(label: str, method: str, request, stream: bool = False):
            t = time.perf_counter()
            out = getattr(stub, method)(request, timeout=600)
            out = list(out) if stream else out
            walls.setdefault(label, []).append(time.perf_counter() - t)
            return out

        call("generate", "EcShardsGenerate", pb.EcShardsGenerateRequest(volume_id=1))
        with open(base + ".ecx", "rb") as f:
            check(f.read() == vol["ecx"], "server .ecx differs from the sorted live .idx entries")
        n_rows = check_parity(base, vol["dat_size"], ReedSolomonTorch(10, 4, device="cpu"))
        call("mount", "EcShardsMount", pb.EcShardsMountRequest(volume_id=1, shard_ids=range(14)))
        info = call("info", "EcShardsInfo", pb.EcShardsInfoRequest(volume_id=1))
        shard_size = os.path.getsize(base + ".ec00")
        check([(s.shard_id, s.size) for s in info.shards] == [(i, shard_size) for i in range(14)],
              f"EcShardsInfo: {info}")
        rng = np.random.default_rng(seed)
        for sid, size in [(int(s), int(z)) for s, z in zip(rng.integers(0, 14, 6),
                                                           rng.integers(1, 3 * MIB, 6))]:
            offset = int(rng.integers(0, shard_size - size))
            got = b"".join(r.data for r in call("shard read", "EcShardRead", pb.EcShardReadRequest(
                volume_id=1, shard_id=sid, offset=offset, size=size), stream=True))
            with open(base + f".ec{sid:02d}", "rb") as f:
                check(got == os.pread(f.fileno(), size, offset),
                      f"EcShardRead {sid} @{offset} +{size} differs from the shard file")
        # the reads of phase 7 run on links to the generated shards
        reads_dir = os.path.join(os.path.dirname(directory), "reads")
        os.mkdir(reads_dir)
        for sid in range(14):
            os.link(base + f".ec{sid:02d}", os.path.join(reads_dir, f"1.ec{sid:02d}"))
        for ext in (".ecx", ".vif"):
            shutil.copy(base + ext, os.path.join(reads_dir, "1" + ext))

        lost = HOP_SETS[-1]
        hashes = {sid: sha256(base + f".ec{sid:02d}") for sid in lost}
        for _ in range(2):  # the second rebuild in the same process: warm pinned slots
            call("unmount", "EcShardsUnmount", pb.EcShardsUnmountRequest(volume_id=1, shard_ids=lost))
            info = call("info", "EcShardsInfo", pb.EcShardsInfoRequest(volume_id=1))
            check([s.shard_id for s in info.shards] == [i for i in range(14) if i not in lost],
                  f"EcShardsInfo after unmounting {lost}: {info}")
            call("delete", "EcShardsDelete", pb.EcShardsDeleteRequest(volume_id=1, shard_ids=lost))
            check(not any(os.path.exists(base + f".ec{sid:02d}") for sid in lost),
                  "EcShardsDelete left shard files")
            resp = call("rebuild", "EcShardsRebuild", pb.EcShardsRebuildRequest(volume_id=1))
            check(list(resp.rebuilt_shard_ids) == list(lost), f"rebuilt {resp.rebuilt_shard_ids}")
            for sid in lost:
                check(sha256(base + f".ec{sid:02d}") == hashes[sid], f"server rebuilt {sid} differs")
            call("mount", "EcShardsMount", pb.EcShardsMountRequest(volume_id=1, shard_ids=lost))

        victim = vol["big"][0]["id"]
        call("blob delete", "EcBlobDelete", pb.EcBlobDeleteRequest(volume_id=1, file_key=victim))
        out = call("shard read", "EcShardRead", pb.EcShardReadRequest(
            volume_id=1, shard_id=0, size=16, file_key=victim), stream=True)
        check([r.is_deleted for r in out] == [True], "EcShardRead of a deleted blob: not is_deleted")
        try:
            stub.EcShardsCopy(pb.EcShardsCopyRequest(volume_id=1), timeout=60)
            check(False, "EcShardsCopy answered")
        except grpc.RpcError as e:
            check(e.code() == grpc.StatusCode.UNIMPLEMENTED, f"EcShardsCopy: {e.code()}")

        for ext in (".dat", ".idx"):
            os.remove(base + ext)
        call("to volume", "EcShardsToVolume", pb.EcShardsToVolumeRequest(volume_id=1))
        check(sha256(base + ".dat") == dat_sha, "EcShardsToVolume: .dat differs from the original")

        text = server.metrics()
        ops = {op: metric(text, "weedtpu_ec_operations_total", op=op) for op in ("encode", "rebuild")}
        check(ops == {"encode": 1, "rebuild": 2}, f"weedtpu_ec_operations_total {ops}")
        cache = {ev: metric(text, "weedtpu_ec_sched_cache_total", event=ev, plane="cuda")
                 for ev in ("hit", "miss")}
        check(sum(cache.values()) > 0, "no weedtpu_ec_sched_cache_total{plane=\"cuda\"} in the server")
        launches = {k: int(metric(text, "weedtpu_cuda_kernel_launches", kernel=k))
                    for k in ("gf_apply", "gf_planes_apply", "gf_pack", "gf_unpack")}
        check(launches["gf_apply"] > 0, f"the server launched no K1: {launches}")
    finally:
        rc = server.stop()
    log = server.log_text()
    check(rc == 0, f"the volume server exited {rc}: {log[-2000:]}")
    gen, rebuilds = server_stages(log, "generate"), server_stages(log, "rebuild")
    check(len(gen) == 1 and len(rebuilds) == 2, f"server stage lines: {len(gen)} / {len(rebuilds)}")
    print(f"server on {ident}: /metrics weedtpu_ec_operations_total {ops}, "
          f"weedtpu_ec_sched_cache_total{{plane=\"cuda\"}} {cache}, "
          f"weedtpu_cuda_kernel_launches {launches}")
    print(f"server generate on {ident}: {n_rows} rows, RPC wall {walls['generate'][0]:.4f}s, "
          f"{vol['dat_size'] / walls['generate'][0] / 1e9:.3f} GB/s of .dat; {stage_line(gen[0])}")
    print(f"server rebuild {list(lost)} on {ident}, first vs second in one process: RPC wall "
          f"{walls['rebuild'][0]:.4f}s vs {walls['rebuild'][1]:.4f}s; setup "
          f"{rebuilds[0]['setup_s']:.4f}s vs {rebuilds[1]['setup_s']:.4f}s; "
          f"{stage_line(rebuilds[0])} | {stage_line(rebuilds[1])}")
    print("server RPC client walls (s): " + ", ".join(
        f"{k} {' / '.join(f'{w:.4f}' for w in v)}" for k, v in walls.items()))
    return dict(walls=walls, generate=gen[0], rebuilds=rebuilds, launches=launches,
                sched_cache=cache, start_s=server.start_s, reads_dir=reads_dir)


def phase_reads(vol: dict, dirs: dict, ident: str, seed: int) -> dict:
    """Needle reads through the port's Store, EcVolume.read_needle and the
    local half of EcShardLocator, in READ_STATES (host only)."""
    import numpy as np

    from seaweedfs_tpu_torch import stats
    from seaweedfs_tpu_torch.server.store_ec import EcShardLocator
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.volume import NotFoundError

    sample = read_sample(vol, seed)
    dead = [int(vol["ids"][i]) for i in sorted(vol["dead"])]
    out = {}
    for label, kind, lost in READ_STATES:
        store = Store([dirs[kind]])
        store.mount_ec_shards("", 1, [s for s in range(14) if s not in lost])
        ev = store.find_ec_volume(1)
        locator = EcShardLocator()
        fetch = locator.make_fetcher(ev)
        rebuilt = [0, 0]  # intervals, bytes

        def counted(vid, sid, offset, length):
            rebuilt[0] += 1
            rebuilt[1] += length
            return fetch(vid, sid, offset, length)

        bytes0 = stats.REPAIR_BYTES.series()
        lat = np.empty(len(sample))
        try:
            t0 = time.perf_counter()
            for j, (nid, payload) in enumerate(sample):
                t = time.perf_counter()
                got = ev.read_needle(nid, fetcher=counted).data
                lat[j] = time.perf_counter() - t
                check(got == payload, f"{label}: needle {nid:x} differs from its seeded bytes")
            wall = time.perf_counter() - t0
            for nid in dead:
                try:
                    ev.read_needle(nid, fetcher=counted)
                    check(False, f"{label}: tombstoned needle {nid:x} was read")
                except NotFoundError:
                    pass
        finally:
            locator.close()
            store.close()
        moved = {dict(k)["mode"]: v - bytes0.get(k, 0.0)
                 for k, v in stats.REPAIR_BYTES.series().items()
                 if dict(k)["dir"] == "read" and dict(k)["code"] == kind and v != bytes0.get(k, 0.0)}
        per_interval = {mode: v / rebuilt[1] for mode, v in moved.items()} if rebuilt[1] else {}
        if lost:
            check(rebuilt[0] > 0, f"{label}: no interval was reconstructed")
        want = {(): {}, (0, 3, 10, 13): {"global": 10.0}, (3,): {"local": 5.0},
                (0, 5, 12, 13): {"local": 5.0}}.get(lost)
        if want is not None:
            check(per_interval == want, f"{label}: repair reads per interval byte {per_interval}")
        else:  # a local plan abandoned (co-members missing), then the global decode
            check(per_interval.get("global") == 10.0 and per_interval.get("local", 0) < 5,
                  f"{label}: repair reads per interval byte {per_interval}")
        rec = dict(needles=len(sample), needles_per_s=len(sample) / wall,
                   p50_us=float(np.percentile(lat, 50) * 1e6),
                   p99_us=float(np.percentile(lat, 99) * 1e6),
                   reconstructed_intervals=rebuilt[0], reconstructed_bytes=rebuilt[1],
                   repair_read_bytes=moved)
        out[label] = rec
        print(f"reads ({label}) on the host ({ident} box): {len(sample)} needles byte-exact, "
              f"{len(dead)} tombstoned raise NotFoundError; {rec['needles_per_s']:.1f} needles/s, "
              f"p50 {rec['p50_us']:.1f} us, p99 {rec['p99_us']:.1f} us; {rebuilt[0]} intervals "
              f"({rebuilt[1]} bytes) reconstructed; weedtpu_repair_bytes_total{{dir=read}} "
              f"+{moved} ({per_interval} per byte)")
    return out


def phase_large_row(vol: dict, directory: str, dev, ident: str) -> dict:
    """The 1 GiB .dat through write_ec_files with 64 MiB large blocks: one
    large row of 10 x 64 MiB (strided preadv, one K1 batch) and small rows
    after it; parity sampled against the CPU plain version in both areas,
    and needles read back through EcVolume with that scheme."""
    import numpy as np

    from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
    from seaweedfs_tpu_torch.server.store_ec import EcShardLocator
    from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
    from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
    from seaweedfs_tpu_torch.storage.erasure_coding.scheme import EcScheme
    from seaweedfs_tpu_torch.storage.volume_info import VolumeInfo, save_volume_info

    scheme = EcScheme(10, 4, large_block_size=LARGE_ROW_BLOCK)
    k, big, small = 10, scheme.large_block_size, scheme.small_block_size
    base = os.path.join(directory, "1")
    st: dict = {}
    ec_encoder.write_ec_files(base, scheme, stats=st, device=dev)
    ec_encoder.write_sorted_ecx_file(base)
    save_volume_info(base + ".vif", VolumeInfo(dat_file_size=vol["dat_size"], data_shards=k,
                                               parity_shards=4))
    n_large, left = 0, vol["dat_size"]
    while left > big * k:
        n_large, left = n_large + 1, left - big * k
    check(n_large >= 1, "the volume has no large row")
    small_rows = -(-left // (small * k))
    windows = [(r * big + x, [r * big * k + i * big + x for i in range(k)])
               for r in range(n_large) for x in (0, big // 2, big - small)]
    windows += [(n_large * big + q * small,
                 [n_large * big * k + q * small * k + i * small for i in range(k)])
                for q in (0, small_rows - 1)]
    codec = ReedSolomonTorch(10, 4, device="cpu")
    with open(base + ".dat", "rb") as dat:
        for shard_off, dat_offs in windows:
            data = np.zeros((k, small), np.uint8)
            for i, off in enumerate(dat_offs):
                got = os.preadv(dat.fileno(), [memoryview(data[i])], off)
                data[i, got:] = 0
            want = np.concatenate([data, codec.encode(data)])
            for sid in range(14):
                with open(base + f".ec{sid:02d}", "rb") as f:
                    shard = np.frombuffer(os.pread(f.fileno(), small, shard_off), np.uint8)
                check(np.array_equal(shard, want[sid]),
                      f"large-row volume: shard {sid} wrong at {shard_off}")
    # needles across the large blocks' boundaries, the large -> small
    # boundary, and at random; healthy, then with shard 2 missing
    offsets, rec = vol["offsets"], vol["rec"]
    edges = [j * big for j in range(1, n_large * k + 1)]
    near = {int(np.searchsorted(offsets, e)) - 1 for e in edges}
    rng = np.random.default_rng(len(edges))
    picks = sorted((near | set(int(i) for i in rng.choice(vol["n"], 200, replace=False)))
                   - vol["dead"] - {-1})
    ev = EcVolume(directory, 1, scheme=scheme)
    locator = EcShardLocator()
    kinds, crossing = set(), 0
    try:
        for sid in range(14):
            ev.add_shard(sid)
        for missing in (None, 2):
            if missing is not None:
                ev.delete_shard(missing)
            fetch = locator.make_fetcher(ev)
            for i in picks:
                nid = int(vol["ids"][i])
                check(ev.read_needle(nid, fetcher=fetch).data == vol["payload"][i].tobytes(),
                      f"large-row volume: needle {nid:x} differs")
                intervals = ev.locate(nid)[2]
                kinds |= {iv.is_large_block for iv in intervals}
                crossing += len(intervals) > 1
    finally:
        locator.close()
        ev.close()
    check(kinds == {True, False} and crossing > 0,
          f"large-row reads covered large={True in kinds} small={False in kinds}, {crossing} crossing")
    gbs = vol["dat_size"] / st["wall_s"] / 1e9
    print(f"large-row encode on {ident}: EcScheme(10, 4, large_block_size={big // MIB} MiB), "
          f"{n_large} large row(s) of 10 x {big // MIB} MiB + {small_rows} small rows, "
          f"{gbs:.3f} GB/s; parity of "
          f"{len(windows)} 1 MiB windows == CPU plain version; {len(picks)} needles x 2 states "
          f"byte-exact ({crossing} reads spanned blocks); {stage_line(st)}")
    return dict(stages=st, gbs=gbs, large_rows=n_large, small_rows=small_rows)


def phase_ec_service(args, directory: str, ident: str, dev) -> dict:
    """Phase 7: a needle volume through the volume server's EC service,
    then needle reads from its shards and from an LRC encoding of it, and
    the large-row pipeline."""
    from seaweedfs_tpu_torch.ops.lrc_codec import LrcTorch

    size = int(args.gib * (1 << 30))
    server_dir = os.path.join(directory, "server")
    os.mkdir(server_dir)
    t = time.perf_counter()
    vol = make_needle_volume(server_dir, size, args.seed)
    print(f"needle volume: {vol['n']} needles of {NEEDLE_PAYLOAD} B ({vol['rec']} B on disk) + "
          f"{BIG_NEEDLES} of {min(len(b['data']) for b in vol['big'])}-"
          f"{max(len(b['data']) for b in vol['big'])} B, {vol['dat_size']} bytes, "
          f"{len(vol['dead'])} tombstoned, {len(vol['crossing'])} crossing 1 MiB blocks; "
          f"{time.perf_counter() - t:.3f}s")
    lrc_dir, large_dir = os.path.join(directory, "lrc"), os.path.join(directory, "large")
    for d in (lrc_dir, large_dir):
        os.mkdir(d)
        for ext in (".dat", ".idx"):
            os.link(os.path.join(server_dir, "1" + ext), os.path.join(d, "1" + ext))

    server = phase_server(vol, server_dir, dev, ident, args.seed)
    zero_launch_counts()
    enc = run_cli(["ec.encode.local", "-dir", lrc_dir, "-volumeId", "1", "-device", dev.type,
                   "-code", "lrc"])
    check_parity(os.path.join(lrc_dir, "1"), vol["dat_size"], LrcTorch(10, 2, 2, device="cpu"))
    print(f"LRC encode of the needle volume on {ident}: {stage_line(enc)}")
    large = phase_large_row(vol, large_dir, dev, ident)
    launches = launch_counts()
    check(launches["gf_apply"] > 0, f"phase 7's own encodes launched no K1: {launches}")
    shutil.rmtree(large_dir)
    reads = phase_reads(vol, {"rs": server["reads_dir"], "lrc": lrc_dir}, ident, args.seed)
    return dict(server=server, reads=reads, large=large, lrc_encode=enc,
                launches=launches["gf_apply"] + server["launches"]["gf_apply"],
                launches_server=server["launches"]["gf_apply"], launches_local=launches["gf_apply"])


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
    ptxas = {}
    for name, info in built.items():
        print(f"build: {name} in {info['seconds']:.3f}s -> {info['path']}")
        for k in ptxas_report(info["log"]):
            ptxas[k["kernel"]] = k
            print(f"  ptxas: {k['kernel']}: {k['registers']} registers, "
                  f"{k['spill_bytes']} bytes of spill stores and loads")
    table_kernels = [k for name, k in ptxas.items()
                     if name.startswith(("gf_apply_kernel", "planes_apply_kernel"))]
    if len(table_kernels) != 8 or any(k["spill_bytes"] for k in table_kernels):
        print(f"FAIL: ptxas should report 4 K1 and 4 K2 instantiations, none spilling: "
              f"{table_kernels}")
        return 1

    rates = card_rates()
    print(f"rates: {rates['sms']} SMs at clocks.max.sm {rates['clock_hz'] / 1e6:.0f} MHz: "
          f"{rates['logic_ops_per_s']:.6g} logic ops/s, {HBM_BYTES_PER_S:.6g} B/s of device memory")
    rng = np.random.default_rng(args.seed)
    try:
        kern = phase_kernel(rng, dev, rates)
        planes = phase_planes(rng, dev, rates, ident,
                              sorted({n for _off, n in shard_chunks(int(args.gib * (1 << 30)))}))
        main_path = phase_main_path(args, ident, dev, rates)
    except SmokeFailure as e:
        print(f"FAIL: {e}")
        return 1
    t6, t64 = kern["timings"][6 * MIB], kern["timings"][64 * MIB]
    t_reb = kern["timings"]["rebuild_4loss"]
    pt, hop, lrc = planes["timings"], main_path["hop"], main_path["lrc"]
    lrc_hop = lrc["hop"]

    def timing_keys(t: dict, suffix: str) -> dict:
        return {f"ms_{suffix}": t["ms"], f"ms_graph_{suffix}": t["graph_ms"],
                f"plain_ms_{suffix}": t["plain_ms"], f"bound_ms_{suffix}": t["bound_ms"],
                f"bound_by_{suffix}": t["bound_by"]}

    def lrc_rebuild_gbs(mode: str, n_lost: int) -> float:
        return next(r["gbs"] for r in lrc["rebuilds"] if (r["mode"], len(r["lost"])) == (mode, n_lost))

    def registers(kernel: str) -> dict:
        return {name: k["registers"] for name, k in ptxas.items() if name.startswith(kernel)}

    def plane_entry(name: str, line: int, key: str, err: str, shape: str) -> dict:
        return {
            "name": name, "route": "cuda", "source": "seaweedfs_tpu_torch/csrc/gf_planes.cu",
            "replaces": f"seaweedfs_tpu/ops/rs_pallas.py:{line}",
            "launches": hop["launches"][name] + lrc_hop["launches"][name],
            "launches_rs_hop": hop["launches"][name], "launches_lrc_hop": lrc_hop["launches"][name],
            "max_abs_err": planes["errs"][err],
            "ms": pt[key]["ms"], "plain_ms": pt[key]["plain_ms"],
            "bound_ms": pt[key]["bound_ms"], "bound_by": pt[key]["bound_by"],
            "library_ms": None, "shape": shape,
        }

    record = {"kernels": [
        {
            "name": "gf_apply",
            "route": "cuda",
            "source": "seaweedfs_tpu_torch/csrc/gf_apply.cu",
            "replaces": "seaweedfs_tpu/ops/rs_pallas.py:52",
            "launches": main_path["launches"] + lrc["launches"],
            "launches_rs": main_path["launches"],
            "launches_lrc": lrc["launches"],
            "max_abs_err": kern["max_err"],
            "ms": t6["ms"],
            "plain_ms": t6["plain_ms"],
            "bound_ms": t6["bound_ms"],
            "bound_by": t6["bound_by"],
            "library_ms": None,
            "shape": "10x6MiB->4",
            "ms_graph": t6["graph_ms"],
            "ms_10x64MiB": t64["ms"],
            "ms_graph_10x64MiB": t64["graph_ms"],
            "plain_ms_10x64MiB": t64["plain_ms"],
            "bound_ms_10x64MiB": t64["bound_ms"],
            "bound_by_10x64MiB": t64["bound_by"],
            "ms_10x64MiB_rebuild_4loss": t_reb["ms"],
            "ms_graph_10x64MiB_rebuild_4loss": t_reb["graph_ms"],
            "plain_ms_10x64MiB_rebuild_4loss": t_reb["plain_ms"],
            "bound_ms_10x64MiB_rebuild_4loss": t_reb["bound_ms"],
            "bound_by_10x64MiB_rebuild_4loss": t_reb["bound_by"],
            "registers": registers("gf_apply_kernel"),
            "encode_gbs": main_path["encode_gbs"],
            "rebuild_gbs": main_path["rebuild_gbs"],
            **timing_keys(kern["timings"]["lrc_local_1loss"], "5x64MiB_to_1_lrc_local"),
            **timing_keys(kern["timings"]["lrc_local_2groups"], "10x64MiB_to_2_lrc_local"),
            "lrc_encode_gbs": lrc["encode_gbs"],
            "lrc_rebuild_local_gbs": lrc_rebuild_gbs("local", 1),
            "lrc_rebuild_local_2groups_gbs": lrc_rebuild_gbs("local", 2),
            "lrc_rebuild_global_gbs": lrc_rebuild_gbs("global", 4),
            "decode_s": main_path["decode_s"],
            "lrc_decode_s": lrc["decode_s"],
        },
        {
            **plane_entry("gf_planes_apply", 184, "apply_4", "apply",
                          "10x64MiB->4 (RS(10,4) encode)"),
            "ms_10x64MiB_to_8": pt["apply_8"]["ms"],
            "plain_ms_10x64MiB_to_8": pt["apply_8"]["plain_ms"],
            "bound_ms_10x64MiB_to_8": pt["apply_8"]["bound_ms"],
            "bound_by_10x64MiB_to_8": pt["apply_8"]["bound_by"],
            "registers": registers("planes_apply_kernel"),
            "pack_apply_unpack_ms_10x64MiB_to_4": planes["hop_ms"],
            "k1_ms_10x64MiB_to_4": planes["k1_ms"],
            "hop_chunk_ms": [c["ms"] for c in hop["chunks"]],
            "hop_chunk_gbs_all_rows": [c["gbs"] for c in hop["chunks"]],
            "hop_chunk_gbs_distinct_shards": [c["gbs_distinct"] for c in hop["chunks"]],
            "ms_10x64MiB_to_8_lrc": pt["apply_8_lrc"]["ms"],
            "plain_ms_10x64MiB_to_8_lrc": pt["apply_8_lrc"]["plain_ms"],
            "bound_ms_10x64MiB_to_8_lrc": pt["apply_8_lrc"]["bound_ms"],
            "bound_by_10x64MiB_to_8_lrc": pt["apply_8_lrc"]["bound_by"],
            "lrc_hop_chunk_ms": [c["ms"] for c in lrc_hop["chunks"]],
            "lrc_hop_chunk_gbs_distinct_shards": [c["gbs_distinct"] for c in lrc_hop["chunks"]],
        },
        plane_entry("gf_pack", 240, "pack", "pack", "10x64MiB"),
        plane_entry("gf_unpack", 260, "unpack", "unpack", "10x64MiB"),
    ]}
    mesh = main_path["mesh"]
    mesh_shapes = {"gf_apply": "k1_10x16MiB_to_4", "gf_planes_apply": "apply_bits_32MiB_to_2",
                   "gf_pack": "pack_10x32MiB", "gf_unpack": "unpack_2x32MiB"}
    for entry in record["kernels"]:
        name, shape = entry["name"], mesh_shapes[entry["name"]]
        entry["launches"] += mesh["launches"][name]
        entry["launches_mesh"] = mesh["launches"][name]
        entry["max_abs_err"] = max(entry["max_abs_err"], mesh["ops"]["errs"][name])
        entry.update({f"{key}_mesh_position_{shape}": mesh["ops"]["timings"][shape][key]
                      for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
    record["kernels"][0].update(
        mesh_encode_ms_10x64MiB=mesh["ops"]["whole_ms"],
        mesh_upload_ms_10x64MiB=mesh["ops"]["upload_ms"],
        mesh_cli_encode_wall_s=mesh["pipeline"]["cli"]["encode"]["wall_s"],
        mesh_cli_rebuild_wall_s=mesh["pipeline"]["cli"]["rebuild"]["wall_s"],
        throttled_rebuild_wait_s=mesh["pipeline"]["throttled"]["waited_s"],
        scaling=mesh["scaling"]["devices"],
    )
    svc = main_path["ec_service"]
    server = svc["server"]
    record["kernels"][0]["launches"] += svc["launches"]
    record["kernels"][0].update(
        launches_ec_service=svc["launches"],
        launches_ec_service_server=svc["launches_server"],
        server_rpc_walls_s=server["walls"],
        server_rebuild_setup_s=[r["setup_s"] for r in server["rebuilds"]],
        server_generate_stages=server["generate"],
        needle_reads={label: {key: r[key] for key in ("needles", "needles_per_s", "p50_us",
                                                      "p99_us", "reconstructed_intervals")}
                      for label, r in svc["reads"].items()},
        large_row_encode_gbs=svc["large"]["gbs"],
    )
    print(f"total {time.perf_counter() - t_start:.3f}s")
    print(ident)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
