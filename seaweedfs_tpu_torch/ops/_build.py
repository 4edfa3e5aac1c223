"""Build the port's native sources at first use and load them.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C interface,
compiled by nvcc for Hopper (``sm_90a``); each host source
``csrc/<name>.cpp`` (the CRC32C of util/crc32c.py, the GF(2^8) host apply,
the data plane) one compiled by g++.  A host library may link further
sources and take further flags (``HOST_LINKS``, ``HOST_FLAGS``): ``dp``,
the native data plane, is dp.cpp with crc32c.cpp's ``sw_crc32c``, built
with ``-pthread``.
Both go into ``build/kernels/`` at the repo root
(listed in .gitignore) under a name keyed by a hash of the sources and
flags, so an edited source rebuilds and concurrent builders never share a
half-written file.  Only the sources in the checkout are built; nothing is
fetched.  ``nvcc`` is taken from ``$CUDA_HOME/bin``, else the standard
``/usr/local/cuda/bin``, else ``$PATH``; ``g++`` from ``$PATH``.  A failed
build raises: there is no slower fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
# host libraries built from more than one source, and their own flags
HOST_LINKS = {"dp": ("crc32c.cpp",)}
HOST_FLAGS = {"dp": ("-pthread",)}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the sources in csrc/: the kernels (one .cu each) and the
    host sources (one .cpp each)."""
    return sorted(p.stem for p in [*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cpp")])


def nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            "csrc/ at first use"
        )
    return found


def gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host sources in csrc/ are built at first use")
    return found


def _source(name: str) -> Path:
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


def library_path(name: str) -> Path:
    src = _source(name)
    if src.suffix == ".cu":
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        deps = sorted(CSRC_DIR.glob("*.cu*"))  # .cu and shared .cuh headers
    else:
        h = hashlib.sha256(" ".join(_gxx_flags(name)).encode())
        deps = [src, *_links(name)]
    for dep in deps:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _gxx_flags(name: str) -> tuple[str, ...]:
    return (*GXX_FLAGS, *HOST_FLAGS.get(name, ()))


def _links(name: str) -> list[Path]:
    return [CSRC_DIR / f for f in HOST_LINKS.get(name, ())]


def _log_path(library: Path) -> Path:
    return library.with_name(library.name + ".log")


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start the compiler for one source; None if its library is already
    built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    src = _source(name)
    if src.suffix == ".cu":
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    else:
        cmd = [gxx(), *_gxx_flags(name), "-o", str(tmp), str(src), *map(str, _links(name))]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for a started build and move its library into place; returns
    the compiler's output (ptxas -v: registers, shared memory, spills),
    kept beside the library for a later call that finds it built."""
    if started is None:
        log_path = _log_path(library_path(name))
        return log_path.read_text() if log_path.exists() else ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"build failed for csrc/{_source(name).name}:\n{log}")
    _log_path(tmp).write_text(log)
    os.replace(_log_path(tmp), _log_path(out))
    os.replace(tmp, out)
    return log


def build_all(names: list[str] | None = None) -> dict[str, dict]:
    """Build every source at once, one compiler process per source, all
    started together.  Returns {name: {"path", "seconds", "log"}}."""
    names = sources() if names is None else names
    t0 = time.perf_counter()
    started, logs, errors = {}, {}, []
    try:
        for name in names:
            started[name] = _start(name)
    finally:
        # every process started is waited for, even when one fails
        for name, s in started.items():
            try:
                logs[name] = _finish(name, s)
            except RuntimeError as e:
                errors.append(e)
    if errors:
        raise errors[0]
    dt = time.perf_counter() - t0
    return {
        name: {"path": str(library_path(name)), "seconds": dt, "log": logs[name]}
        for name in names
    }


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu or .cpp, built first if
    needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
