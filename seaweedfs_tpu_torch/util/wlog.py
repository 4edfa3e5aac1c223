"""Leveled logging — the glog analogue (reference weed/glog/); the port's
copy of seaweedfs_tpu/util/wlog.py.

`V(level)` gates verbose logs on the process verbosity (``WEEDTPU_V``);
``info`` prints with the glog-style single-letter prefix, timestamp, and
source location.  Only the calls the port makes so far are ported.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_verbosity = int(os.environ.get("WEEDTPU_V", "0") or 0)
_lock = threading.Lock()


def V(level: int) -> bool:
    """`if wlog.V(2): wlog.info(...)` — the glog verbosity gate."""
    return _verbosity >= level


def _emit(severity: str, msg: str, args: tuple) -> None:
    if args:
        msg = msg % args
    frame = sys._getframe(2)  # noqa: SLF001 — caller's caller
    where = f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
    ts = time.strftime("%m%d %H:%M:%S")
    with _lock:
        print(f"{severity}{ts} {where}] {msg}", file=sys.stderr, flush=True)


def info(msg: str, *args) -> None:
    _emit("I", msg, args)


def warning(msg: str, *args) -> None:
    _emit("W", msg, args)


def error(msg: str, *args) -> None:
    _emit("E", msg, args)
