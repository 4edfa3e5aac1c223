#!/usr/bin/env python3
"""Launch shapes of the table apply (K1, K2) on one GPU, against the committed ones.

    python3 chip_table_variants.py [--seed N]

Copies seaweedfs_tpu_torch/csrc into build/variants/<variant>/ with the
table apply's block size (gf::kThreads, csrc/gf_table.cuh) and K2's words
per thread V at 4 and 8 output rows (launch_apply<R, V>, csrc/gf_planes.cu)
replaced, and builds each copy with ops/_build.py's nvcc flags (one nvcc
per source, all started together), printing ptxas's registers and spills.
Then, on random input, each variant's K2 -> 4 (RS(10,4) encode) and K2 -> 8
(the 5-set stack of chip_smoke.py) at 10 x 64 MiB, and K1 -> 4 (encode) at
10 x 64 MiB and 10 x 6 MiB, must equal the committed kernels' output byte
for byte; each is then timed with CUDA events (20 launches into buffers
allocated once), in the order of VARIANTS and again in reverse.  The line
before the last is a JSON record of all of it; the last is {"ok": true}.
Needs CUDA; any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

VARIANTS = {  # name: (block threads, K2's V at R = 4, K2's V at R = 8)
    "t128_r4v2_r8v2": (128, 2, 2),  # committed
    "t128_r4v2_r8v1": (128, 2, 1),
    "t128_r4v4_r8v2": (128, 4, 2),
    "t256_r4v2_r8v1": (256, 2, 1),  # the table apply's first design
    "t256_r4v2_r8v2": (256, 2, 2),
}
EDITS = {  # source file: [(committed text, the variant's)]
    "gf_table.cuh": [("constexpr int kThreads = 128;", "constexpr int kThreads = {t};")],
    "gf_planes.cu": [("launch_apply<4, 2>(", "launch_apply<4, {v4}>("),
                     ("launch_apply<8, 2>(", "launch_apply<8, {v8}>(")],
}


def build(root: Path) -> dict[tuple[str, str], tuple[ctypes.CDLL, list[dict]]]:
    """{(variant, source): (library, ptxas report)} for gf_apply and gf_planes."""
    from seaweedfs_tpu_torch.ops import _build

    procs = {}
    try:
        for name, (t, v4, v8) in VARIANTS.items():
            d = root / name
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
            for src in _build.CSRC_DIR.glob("*.cu*"):
                text = src.read_text()
                for old, new in EDITS.get(src.name, []):
                    cs.check(text.count(old) == 1, f"{src.name}: {old!r} is not there once")
                    text = text.replace(old, new.format(t=t, v4=v4, v8=v8))
                (d / src.name).write_text(text)
            for source in ("gf_apply", "gf_planes"):
                out = d / f"lib{source}.so"
                cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(d / f"{source}.cu")]
                procs[name, source] = out, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    finally:
        logs = {}
        for key, (out, proc) in procs.items():  # every process started is waited for
            log, _ = proc.communicate()
            logs[key] = out, log, proc.returncode
    built = {}
    for key, (out, log, rc) in logs.items():
        cs.check(rc == 0, f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(out))
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn = lib.sw_gf_apply if key[1] == "gf_apply" else lib.sw_gf_planes_apply
        fn.argtypes = [ptr, i64, i64, ptr, i64, ptr, i64, i64, ptr]
        fn.restype = ctypes.c_int
        built[key] = lib, cs.ptxas_report(log)
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_table_variants: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from seaweedfs_tpu_torch.ops import gf256, rs_cuda

    ident = cs.gpu_identity()
    print(f"device: {torch.cuda.get_device_name(0)} ({ident}), torch {torch.__version__}")
    dev = torch.device("cuda", 0)
    mib = cs.MIB
    try:
        built = build(Path(__file__).resolve().parent / "build" / "variants")
        registers = {}
        for (name, source), (_lib, report) in built.items():
            for k in report:
                registers.setdefault(name, {})[k["kernel"]] = k["registers"]
                print(f"  ptxas {name}: {k['kernel']}: {k['registers']} registers, "
                      f"{k['spill_bytes']} bytes of spill stores and loads")

        cases = cs.plane_cases()
        enc, stack = cases["rs10_4_encode"], cases["rs10_4_5set_stack"]
        rng = np.random.default_rng(args.seed)
        x64 = torch.from_numpy(rng.integers(0, 256, (10, 64 * mib), dtype=np.uint8)).to(dev)
        x6 = x64[:, : 6 * mib].contiguous()
        planes = rs_cuda.pack_words(x64.view(torch.uint32))
        stream = torch.cuda.current_stream(dev).cuda_stream

        def k1_call(lib, mat, x):
            r, s = mat.shape
            m = torch.from_numpy(np.ascontiguousarray(mat)).to(dev)
            out = torch.empty((r, x.shape[1]), dtype=torch.uint8, device=dev)

            def call():
                err = lib.sw_gf_apply(m.data_ptr(), r, s, x.data_ptr(), x.stride(0),
                                      out.data_ptr(), out.stride(0), x.shape[1], stream)
                cs.check(err == 0, f"sw_gf_apply returned {err}")
                return out
            return call, rs_cuda.apply_matrix_cuda(mat, x)

        def k2_call(lib, mat, p):
            r, s = mat.shape
            m = torch.from_numpy(rs_cuda.pack_masks(gf256.matrix_to_gf2(mat))).to(dev)
            out = torch.empty((r, p.shape[1]), dtype=torch.uint32, device=dev)

            def call():
                err = lib.sw_gf_planes_apply(m.data_ptr(), r, s, p.data_ptr(), p.stride(0),
                                             out.data_ptr(), out.stride(0), p.shape[1], stream)
                cs.check(err == 0, f"sw_gf_planes_apply returned {err}")
                return out
            return call, rs_cuda.apply_matrix_planes(mat, p)

        shapes = {  # shape: (source, how to call a variant's library)
            "K2 10x64MiB->4": ("gf_planes", lambda lib: k2_call(lib, enc, planes)),
            "K2 10x64MiB->8": ("gf_planes", lambda lib: k2_call(lib, stack, planes)),
            "K1 10x64MiB->4": ("gf_apply", lambda lib: k1_call(lib, enc, x64)),
            "K1 10x6MiB->4": ("gf_apply", lambda lib: k1_call(lib, enc, x6)),
        }
        calls = {}
        for name in VARIANTS:
            for shape, (source, make) in shapes.items():
                call, want = make(built[name, source][0])
                got = call()
                torch.cuda.synchronize()
                cs.check(torch.equal(got, want), f"{name} {shape} != the committed kernel")
                calls[name, shape] = call
        print(f"every variant byte-exact against the committed kernels on "
              f"{len(shapes)} shapes")
        times = {name: {shape: [] for shape in shapes} for name in VARIANTS}
        for order in (list(VARIANTS), list(reversed(VARIANTS))):
            for name in order:
                for shape in shapes:
                    times[name][shape].append(cs.time_ms(calls[name, shape], iters=20))
        for name, (t, v4, v8) in VARIANTS.items():
            print(f"{name} ({t} threads, V {v4} at 4 rows, {v8} at 8) on {ident}: " + "; ".join(
                f"{shape} {', '.join(f'{ms:.6f}' for ms in ts)} ms"
                for shape, ts in times[name].items()))
    except cs.SmokeFailure as e:
        print(f"FAIL: {e}")
        return 1
    print(ident)
    print(json.dumps({"variants": {name: {"threads": t, "v_r4": v4, "v_r8": v8,
                                          "registers": registers.get(name, {}),
                                          "ms": times[name]}
                                   for name, (t, v4, v8) in VARIANTS.items()}}))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
