"""EC encode/rebuild pipelines: stream a volume through the device codec.

The port of seaweedfs_tpu/storage/erasure_coding/ec_encoder.py, with the
same file layout (the reference's WriteEcFiles / RebuildEcFiles /
WriteSortedFileFromIdx, weed/storage/erasure_coding/ec_encoder.go) and the
same ``stats`` stage keys.

Layout invariant shared with the reference: the .dat is consumed in rows of
k consecutive blocks (1GB rows while more than one full large row remains,
then 1MB rows), block i of each row goes to shard i verbatim (systematic),
parity shards are the RS (or LRC) combination; every shard file is written to full
block multiples, zero-padded past EOF.  Because the column math is
position-independent, many small rows batch into one (k, R*S) dispatch.

Device pipeline (both directions): ``preadv`` scatters the file bytes
straight into shard-row order in a reused pinned host buffer (for a small
batch the scatter does the (rows, k, S) -> (k, rows*S) transpose for free),
the rows go up with ``non_blocking``, the kernel runs, and the result comes
down into a pinned output buffer, with an event recorded per batch.  Two
such slots alternate: batch i-1 is drained (event waited, shards written)
while batch i runs on the device, and a slot is refilled only after its
previous batch was drained — a pread into a buffer whose upload has not
completed would give wrong parity, not a crash.  The download and its
event go on the current stream of ``codec.device`` (not of the current
device); a mesh codec (parallel/
distributed_ec.ReedSolomonMesh, whose ``device`` is the mesh's first
device) makes that stream wait on every mesh position's stream before it
returns a result, so the download and the event come after all of them.

The rebuild runs under the ``ec_repair`` plane tag (stats/plane), charges
each chunk's reads against the WEED_REPAIR_RATE_MB budget
(ops/repair_budget) before reading it, and records its read bytes in
weedtpu_repair_bytes_total{code,mode,dir}.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME, EcScheme
from seaweedfs_tpu_torch.storage.types import index_entry_size

# per-dispatch column width for bulk encode and per-chunk width of rebuild
DEFAULT_CHUNK = 64 * 1024 * 1024
_IOV_MAX = os.sysconf("SC_IOV_MAX")  # iovecs one preadv takes


@dataclass
class _LargeSeg:
    """Chunk of one large row: k strided slices of `width` bytes."""

    dat_offsets: list[int]  # per data shard, absolute .dat offset
    shard_offset: int
    width: int


@dataclass
class _SmallBatch:
    """R consecutive small rows, read as one contiguous .dat span."""

    dat_start: int
    rows: int
    shard_offset: int


def _plan_tasks(scheme: EcScheme, dat_size: int, chunk: int) -> list:
    k = scheme.data_shards
    tasks: list = []
    large_row = scheme.large_block_size * k
    small_row = scheme.small_block_size * k

    processed = 0
    shard_off = 0
    remaining = dat_size
    while remaining > large_row:
        step = min(chunk, scheme.large_block_size)
        for seg in range(0, scheme.large_block_size, step):
            tasks.append(
                _LargeSeg(
                    [processed + i * scheme.large_block_size + seg for i in range(k)],
                    shard_off + seg,
                    step,
                )
            )
        processed += large_row
        shard_off += scheme.large_block_size
        remaining -= large_row
    while remaining > 0:
        rows_left = (remaining + small_row - 1) // small_row
        batch = max(1, min(rows_left, chunk // small_row)) if chunk >= small_row else 1
        tasks.append(_SmallBatch(processed, batch, shard_off))
        processed += batch * small_row
        shard_off += batch * scheme.small_block_size
        remaining -= batch * small_row
    return tasks


class FileShardSink:
    """Default sink: one local shard file, random-access pwrite."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")

    def write_at(self, offset: int, data) -> None:
        os.pwrite(self._f.fileno(), data, offset)

    def close(self) -> None:
        self._f.close()

    def abort(self) -> None:
        self._f.close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


def _make_sinks(base_file_name: str, scheme: EcScheme, sinks):
    if sinks is not None:
        if len(sinks) != scheme.total_shards:
            raise ValueError(
                f"need {scheme.total_shards} sinks, got {len(sinks)}"
            )
        return list(sinks)
    return [
        FileShardSink(base_file_name + scheme.shard_ext(i))
        for i in range(scheme.total_shards)
    ]


def _finish_sinks(outs, ok: bool) -> None:
    """Close (or abort) EVERY sink before surfacing any error."""
    first_err: Exception | None = None
    for s in outs:
        try:
            if ok and first_err is None:
                s.close()
            else:  # failure mode (or a sibling already failed): tear down
                s.abort()
        except Exception as e:  # noqa: BLE001
            if ok and first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err


def _preadv_padded(fd: int, bufs: list[np.ndarray], offset: int) -> None:
    """Scatter the file span at ``offset`` into ``bufs`` in order,
    zero-filling whatever lies past EOF."""
    for g in range(0, len(bufs), _IOV_MAX):
        group = bufs[g : g + _IOV_MAX]
        got = os.preadv(fd, [memoryview(b) for b in group], offset)
        pos = 0
        for b in group:
            if pos + len(b) > got:
                b[max(0, got - pos) :] = 0
            pos += len(b)
        offset += pos


class _Slot:
    """One stage of the two-deep device pipeline: flat host buffers for a
    batch's input and output rows (pinned when the codec runs on CUDA) and
    the event that marks the batch's device work done."""

    def __init__(self, n_in: int, n_out: int, width: int, device: torch.device):
        pin = device.type == "cuda"
        self.host_in = torch.empty(n_in * width, dtype=torch.uint8, pin_memory=pin)
        self.host_out = torch.empty(n_out * width, dtype=torch.uint8, pin_memory=pin)
        self.event = torch.cuda.Event() if pin else None
        self.n_in, self.n_out = n_in, n_out
        self.task = None
        self.width = 0

    def rows_in(self, width: int) -> torch.Tensor:
        return self.host_in[: self.n_in * width].view(self.n_in, width)

    def rows_out(self, width: int) -> torch.Tensor:
        return self.host_out[: self.n_out * width].view(self.n_out, width)


def _stream(codec, tasks, n_in: int, n_out: int, read, compute, write, st: dict) -> None:
    """Run ``tasks`` — (task, width) pairs — through the device, two deep.

    read(task, rows) fills the (n_in, width) numpy view of a slot's input;
    compute(rows_tensor) dispatches the device work and returns
    (n_out, >= width/4) uint32 words without waiting; write(task, in_rows,
    out_rows) consumes the host views once the batch is done."""
    if not tasks:
        return
    t = time.perf_counter()
    width = max(w for _t, w in tasks)
    slots = [_Slot(n_in, n_out, width, codec.device) for _ in range(2)]
    st["setup_s"] += time.perf_counter() - t
    pending: _Slot | None = None

    def drain(slot: _Slot) -> None:
        t = time.perf_counter()
        if slot.event is not None:
            slot.event.synchronize()
        t2 = time.perf_counter()
        st["fetch_s"] += t2 - t
        write(
            slot.task,
            slot.rows_in(slot.width).numpy(),
            slot.rows_out(slot.width).numpy(),
        )
        st["write_s"] += time.perf_counter() - t2

    for n, (task, width) in enumerate(tasks):
        # this slot last carried batch n-2, drained in the previous
        # iteration: its upload and download are complete, so it is free
        slot = slots[n % 2]
        t = time.perf_counter()
        rows = slot.rows_in(width)
        read(task, rows.numpy())
        t2 = time.perf_counter()
        st["read_s"] += t2 - t
        out = compute(rows).view(torch.uint8)[:, :width]
        if slot.event is None:
            slot.rows_out(width).copy_(out)
        else:
            # the download and its fence go on the codec device's stream,
            # where the upload and the kernel went: a bare record() lands
            # on the current device's stream, which is another device's
            # when the codec runs off cuda:0
            stream = torch.cuda.current_stream(codec.device)
            with torch.cuda.stream(stream):
                slot.rows_out(width).copy_(out, non_blocking=True)
            slot.event.record(stream)
        slot.task, slot.width = task, width
        st["dispatch_s"] += time.perf_counter() - t2
        if pending is not None:
            drain(pending)  # batch n-1 drains while batch n runs
        pending = slot
    drain(pending)


def _new_stats(stats: dict | None) -> dict:
    st = stats if stats is not None else {}
    for key in ("setup_s", "read_s", "dispatch_s", "fetch_s", "write_s"):
        st.setdefault(key, 0.0)
    return st


def write_ec_files(
    base_file_name: str,
    scheme: EcScheme = DEFAULT_SCHEME,
    codec=None,
    chunk: int = DEFAULT_CHUNK,
    stats: dict | None = None,
    sinks=None,
    device: str | torch.device | None = None,
) -> None:
    """Generate .ec00...ec{k+m-1} from base_file_name + '.dat'.

    ``stats`` (optional) collects a per-stage wall breakdown in seconds —
    setup (allocating the pinned buffers), read (preadv into pinned rows), dispatch (upload + kernel + download
    enqueue), fetch (wait for the batch's event), write (shard pwrite) —
    plus ``data_bytes``, ``wall_s`` and ``engine``.  ``sinks`` (optional)
    replaces the local shard files: one write_at/close/abort sink per
    shard.  ``codec`` defaults to ``select.pipeline_codec_for(scheme,
    device)``."""
    from seaweedfs_tpu_torch.ops.select import pipeline_codec_for

    codec = codec or pipeline_codec_for(scheme, device)
    k, m = scheme.data_shards, scheme.parity_shards
    s = scheme.small_block_size
    dat_path = base_file_name + ".dat"
    dat_size = os.path.getsize(dat_path)
    st = _new_stats(stats)
    st["data_bytes"] = dat_size
    st["engine"] = type(codec).__name__
    t0 = time.perf_counter()
    tasks = [
        (task, task.width if isinstance(task, _LargeSeg) else task.rows * s)
        for task in _plan_tasks(scheme, dat_size, chunk)
    ]
    outs = _make_sinks(base_file_name, scheme, sinks)
    ok = False
    try:
        with open(dat_path, "rb") as dat:
            fd = dat.fileno()

            def read(task, rows: np.ndarray) -> None:
                if isinstance(task, _LargeSeg):
                    for i, off in enumerate(task.dat_offsets):
                        _preadv_padded(fd, [rows[i]], off)
                else:  # block i of small row r is bytes [r*s, (r+1)*s) of shard i
                    _preadv_padded(
                        fd,
                        [rows[i, r * s : (r + 1) * s] for r in range(task.rows) for i in range(k)],
                        task.dat_start,
                    )

            def write(task, data: np.ndarray, parity: np.ndarray) -> None:
                for i in range(k):
                    outs[i].write_at(task.shard_offset, data[i])
                for j in range(m):
                    outs[k + j].write_at(task.shard_offset, parity[j])

            _stream(codec, tasks, k, m, read, codec.encode_device, write, st)
        ok = True
    finally:
        _finish_sinks(outs, ok)
    st["wall_s"] = time.perf_counter() - t0


def write_sorted_ecx_file(
    base_file_name: str, ext: str = ".ecx", offset_width: int = 4
) -> None:
    """Generate the sorted .ecx index from the volume's .idx log
    (reference behavior: WriteSortedFileFromIdx, ec_encoder.go:28-55):
    the last entry of each needle id, dropped when it is a deletion (zero
    offset or tombstone size), in ascending id order.  The log is replayed
    in bulk with numpy, the same entries as the JAX package's MemDb replay
    gives.  ``offset_width`` must match the source volume's."""
    entry_size = index_entry_size(offset_width)
    raw = np.fromfile(base_file_name + ".idx", dtype=np.uint8)
    # strict: the .ecx outlives the source volume — a torn .idx tail must
    # abort the encode, not silently drop a needle
    if raw.size % entry_size:
        raise ValueError(
            f"truncated index file: {raw.size % entry_size}-byte partial tail entry"
        )
    rows = raw.reshape(-1, entry_size)
    keys = rows[:, :8].copy().view(">u8").ravel().astype(np.uint64)
    # a stored offset is zero iff all its bytes are (any width)
    live = rows[:, 8 : 8 + offset_width].any(axis=1)
    live &= rows[:, -4:].copy().view(">i4").ravel() >= 0  # not a tombstone size
    # np.unique's first index in the reversed log is each id's last entry
    _ids, first = np.unique(keys[::-1], return_index=True)
    last = len(keys) - 1 - first  # ascending id order
    rows[last[live[last]]].tofile(base_file_name + ext)


def rebuild_ec_files(
    base_file_name: str,
    scheme: EcScheme = DEFAULT_SCHEME,
    codec=None,
    chunk: int = DEFAULT_CHUNK,
    stats: dict | None = None,
    targets: list[int] | None = None,
    device: str | torch.device | None = None,
) -> list[int]:
    """Regenerate every missing .ecNN from the surviving ones.

    Returns the list of generated shard ids.  Reads are PLAN-driven:
    ``scheme.repair_plan`` decides which survivors feed the math and only
    those are opened — for RS the first k present (the reference's
    Reconstruct convention), for an LRC single loss the lost shard's local
    group (group_size files instead of k), for other LRC patterns k
    rank-selected survivors.  The plan is made before any file is opened
    and any kernel runs, so an unrecoverable pattern
    (lrc_matrix.UnrecoverableError, a ValueError) raises here and leaves
    no file behind.  The survivors stream through the device pipeline
    ``chunk`` bytes per shard at a time.  ``stats`` (optional) collects
    {read_bytes = len(inputs) x shard size, written_bytes, mode, inputs}
    and the same stage timings as write_ec_files (``read_s`` includes the
    repair budget's waits), and ``sched_cache``: the per-plane hits and
    misses of ops/sched_cache during the rebuild, only the planes that
    moved (none on the CPU, whose plain path caches nothing).  The whole
    rebuild runs under ``plane.tagged(plane.EC_REPAIR)``; each chunk is
    charged ``len(inputs) * width`` bytes against
    ``repair_budget.shared()`` just before it is read, so a throttled
    rebuild sleeps while the previous chunk computes, and the read bytes
    are accounted once at the end."""
    from seaweedfs_tpu_torch.stats import plane

    with plane.tagged(plane.EC_REPAIR):
        return _rebuild_ec_files(base_file_name, scheme, codec, chunk, stats, targets, device)


def _rebuild_ec_files(
    base_file_name: str,
    scheme: EcScheme,
    codec,
    chunk: int,
    stats: dict | None,
    targets: list[int] | None,
    device: str | torch.device | None,
) -> list[int]:
    from seaweedfs_tpu_torch.ops import repair_budget, sched_cache
    from seaweedfs_tpu_torch.ops.select import pipeline_codec_for

    codec = codec or pipeline_codec_for(scheme, device)
    st = _new_stats(stats)
    t0 = time.perf_counter()
    sched_before = sched_cache.snapshot()
    present: list[int] = []
    missing: list[int] = []
    for sid in range(scheme.total_shards):
        path = base_file_name + scheme.shard_ext(sid)
        (present if os.path.exists(path) else missing).append(sid)
    if targets is not None:
        missing = sorted(set(targets) - set(present))
    if not missing:
        return []
    present_mask = tuple(sid in present for sid in range(scheme.total_shards))
    try:
        _plan_mat, inputs, mode = scheme.repair_plan(present_mask, tuple(missing))
    except ValueError as e:
        raise ValueError(
            f"unrepairable: {len(present)}/{scheme.total_shards} shards "
            f"present cannot rebuild {missing}: {e}"
        ) from e
    sizes = {
        sid: os.path.getsize(base_file_name + scheme.shard_ext(sid))
        for sid in present
    }
    if len(set(sizes.values())) != 1:
        raise ValueError(f"surviving shard sizes differ: {sizes}")
    shard_size = next(iter(sizes.values()))
    budget = repair_budget.shared()

    # ExitStack: a failed open mid-dict must close the ones already open
    with contextlib.ExitStack() as stack:
        ins = {
            sid: stack.enter_context(
                open(base_file_name + scheme.shard_ext(sid), "rb")
            )
            for sid in inputs
        }
        outs = {
            sid: stack.enter_context(
                open(base_file_name + scheme.shard_ext(sid), "wb")
            )
            for sid in missing
        }

        def read(off: int, rows: np.ndarray) -> None:
            budget.throttle(len(inputs) * rows.shape[1])
            for i, sid in enumerate(inputs):
                got = os.preadv(ins[sid].fileno(), [memoryview(rows[i])], off)
                if got < rows.shape[1]:
                    # sizes were validated equal up front, so a short read
                    # is an fs fault: zero-filling would rebuild WRONG
                    # shards silently
                    raise IOError(
                        f"short read on {base_file_name}"
                        f"{scheme.shard_ext(sid)} @{off}: {got}/{rows.shape[1]}"
                    )

        def compute(rows: torch.Tensor) -> torch.Tensor:
            return codec.reconstruct_device(present_mask, tuple(missing), rows)

        def write(off: int, _inputs: np.ndarray, rebuilt: np.ndarray) -> None:
            for j, sid in enumerate(missing):
                os.pwrite(outs[sid].fileno(), rebuilt[j], off)

        tasks = [
            (off, min(chunk, shard_size - off)) for off in range(0, shard_size, chunk)
        ]
        _stream(codec, tasks, len(inputs), len(missing), read, compute, write, st)
    read_bytes = len(inputs) * shard_size
    budget.account(scheme.code_name, mode, read=read_bytes)
    sched_after = sched_cache.snapshot()
    sched_delta = {
        p: {ev: sched_after[p].get(ev, 0.0) - sched_before.get(p, {}).get(ev, 0.0)
            for ev in ("hit", "miss")}
        for p in sched_after
    }
    st.update(
        read_bytes=read_bytes,
        written_bytes=len(missing) * shard_size,
        mode=mode,
        inputs=tuple(inputs),
        sched_cache={p: d for p, d in sched_delta.items() if any(d.values())},
        wall_s=time.perf_counter() - t0,
    )
    return missing
