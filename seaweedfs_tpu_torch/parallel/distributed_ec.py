"""Distributed erasure coding over a (shard, stripe) device mesh: the port
of seaweedfs_tpu/parallel/distributed_ec.py.

The JAX package maps the reference's cross-node EC data movement onto
XLA collectives inside ``shard_map``.  Here one process drives every mesh
position on its own CUDA stream (parallel/mesh.py): each position's work
is queued on its stream, the collectives become device-to-device copies,
and the caller's stream on the mesh's first device waits on every
position before a result is handed back.  A (k, W) input and every
result live on that first device, like a global ``jax.Array``; in the
width mode an input placed on the positions (``Sharded``, as
``measure_scaling`` places it) gives a result left there too.

Two sharding modes, as in the JAX package:

  * **width** (default): matrix rows replicated, the stripe-width axis
    split over every position (``WIDTH_PARTITION_RULES``).  RS column
    math is position-independent, so encode and rebuild are
    embarrassingly parallel along the width: each position sends its
    column slice through K1 (ops/rs_cuda.apply_matrix_cuda), which takes
    the GF(2^8) matrix as runtime data.
  * **rows**: stripe columns split over ``stripe`` and output rows (with
    their GF(2) matrix rows) over ``shard`` (``ROW_PARTITION_RULES``), so
    each position computes only its own rows, through parallel/gf2's
    runtime bit-matrix apply (K3 -> K2 -> K4).  Kept for the
    parity-ownership layout and the round-trip step.
"""

from __future__ import annotations

import os
import re
import time

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import rs_cuda, rs_matrix
from seaweedfs_tpu_torch.ops.rs_torch import BLOCK_WORDS, WORD_BYTES, ReedSolomonTorch
from seaweedfs_tpu_torch.parallel import gf2
from seaweedfs_tpu_torch.parallel.mesh import Mesh, Position, make_mesh

# ---------------------------------------------------------------------------
# partition rules: logical array name -> a spec, the tuple of the JAX
# package's PartitionSpec (one entry per dimension: None = not split, an
# axis name or a tuple of axis names = split over those mesh axes, the
# first one major; () = replicated).  The width mode replicates the matrix
# and splits shard words along the width over both axes; the rows mode
# splits matrix rows over ``shard`` instead.
# ---------------------------------------------------------------------------

WIDTH_PARTITION_RULES: tuple[tuple[str, tuple], ...] = (
    (r"_bits$", ()),  # matrix rows: replicated
    (r"_words$", (None, ("shard", "stripe"))),  # width: every position
)

ROW_PARTITION_RULES: tuple[tuple[str, tuple], ...] = (
    (r"_bits$", ("shard", None)),  # matrix rows: split over the shard owners
    (r"_words$", (None, "stripe")),  # width: stripe axis only
)


def match_partition_rules(rules, named: dict) -> dict:
    """Return {name: spec} for a dict of named arrays by first regex match.
    Scalars fall back to full replication; an unmatched non-scalar name is
    an error (a silently replicated stripe buffer would "work" and quietly
    stop scaling)."""
    out = {}
    for name, leaf in named.items():
        if np.ndim(leaf) == 0 or int(np.prod(np.shape(leaf))) == 1:
            out[name] = ()
            continue
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                out[name] = spec
                break
        else:
            raise ValueError(f"partition rule not found for array: {name}")
    return out


def _split(n: int, axes, mesh: Mesh, pos: Position) -> slice:
    """The part of an n-long dimension that ``pos`` holds when the
    dimension is split over ``axes`` (None: not split)."""
    if axes is None:
        return slice(0, n)
    index, count = 0, 1
    for axis in (axes,) if isinstance(axes, str) else axes:
        index = index * mesh.shape[axis] + (pos.shard if axis == "shard" else pos.stripe)
        count *= mesh.shape[axis]
    if n % count:
        raise ValueError(f"a dimension of {n} does not split over {axes} ({count} parts)")
    step = n // count
    return slice(index * step, (index + 1) * step)


def _block(x, spec: tuple, mesh: Mesh, pos: Position):
    """The block of a 2-D array that ``pos`` holds under ``spec``."""
    spec = tuple(spec) + (None,) * (2 - len(spec))
    return x[_split(x.shape[0], spec[0], mesh, pos), _split(x.shape[1], spec[1], mesh, pos)]


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: the same tensor when it is there already (no
    copy: the kernels take row-strided views), else a device-to-device
    copy queued on the current streams of both devices."""
    return x if x.device == device else x.to(device)


def _fan_out(mesh: Mesh, first: torch.device, fn) -> list:
    """Run fn(pos) for every position, each on its own stream, after the
    work already queued on the caller's current stream of ``first``; then
    make that stream wait on every position (an event each).  So a result
    written by the positions is ready for whatever the caller queues next,
    a D2H copy included, and a tensor that one position made may be read
    by another in a later fan-out of the same call."""
    if first.type != "cuda":
        return [fn(p) for p in mesh.positions]
    main = torch.cuda.current_stream(first)
    ready = main.record_event()
    outs, done = [], []
    for p in mesh.positions:
        with torch.cuda.stream(p.stream):
            p.stream.wait_event(ready)
            outs.append(fn(p))
            done.append(p.stream.record_event())
    for event in done:
        main.wait_event(event)
    return outs


def _on_first(mesh: Mesh, words) -> torch.Tensor:
    return torch.as_tensor(words, device=mesh.devices[0])


class Sharded:
    """A 2-D array kept as every position's block on the position's own
    device, keyed by (shard, stripe): the port of a ``jax.Array`` placed
    with a NamedSharding.  ``spec`` is how ``shape`` is split."""

    ndim = 2

    def __init__(self, blocks: dict[tuple[int, int], torch.Tensor], spec: tuple,
                 shape: tuple[int, int]):
        self.blocks, self.spec, self.shape = blocks, spec, shape


def _apply_sharded(mesh: Mesh, rules, operand: np.ndarray, out_rows: int, words,
                   apply, in_place: bool = False):
    """Run ``apply(local_operand, local_words)`` on every position's blocks
    under ``rules``: output rows are split as the operand's rows, columns
    as the words' columns.  ``words`` on the first device give the
    (out_rows, W) result assembled there; ``Sharded`` words, placed under
    the same rules, give a ``Sharded`` result left on the positions.  With
    ``in_place``, a position whose output block is on its own device
    passes it as ``apply``'s ``out`` (K1 writes it there) instead of
    copying a result of its own into it."""
    placed = isinstance(words, Sharded)
    if not placed:
        words = _on_first(mesh, words)
    specs = match_partition_rules(rules, {"matrix_bits": operand, "stripe_words": words})
    op_spec, w_spec = specs["matrix_bits"], specs["stripe_words"]
    if placed and words.spec != w_spec:
        raise ValueError(f"words placed as {words.spec}, the rules split them as {w_spec}")
    width = words.shape[1]
    row_axes = op_spec[0] if op_spec else None
    col_axes = w_spec[1] if len(w_spec) > 1 else None
    first = mesh.devices[0]
    out = None if placed else torch.empty((out_rows, width), dtype=words.dtype, device=first)
    blocks: dict[tuple[int, int], torch.Tensor] = {}

    def run(p: Position) -> None:
        rows, cols = _split(out_rows, row_axes, mesh, p), _split(width, col_axes, mesh, p)
        local_op = _block(operand, op_spec, mesh, p)
        if placed:
            local_words = words.blocks[p.shard, p.stripe]
            dst = blocks[p.shard, p.stripe] = torch.empty(
                (rows.stop - rows.start, cols.stop - cols.start), dtype=local_words.dtype,
                device=p.device)
        else:
            local_words = _to(_block(words, w_spec, mesh, p), p.device)
            dst = out[rows, cols]
        if in_place and dst.device == p.device:
            apply(local_op, local_words, out=dst)
        else:
            dst.copy_(apply(local_op, local_words))

    _fan_out(mesh, first, run)
    return Sharded(blocks, (row_axes, col_axes), (out_rows, width)) if placed else out


def _pad_rows(bits: np.ndarray, row_groups: int, shard_par: int) -> np.ndarray:
    """Zero-pad a (8r, 8s) bit-matrix so r is a multiple of shard_par."""
    padded = -(-row_groups // shard_par) * shard_par
    if padded == row_groups:
        return bits
    out = np.zeros((padded * 8, bits.shape[1]), dtype=bits.dtype)
    out[: bits.shape[0]] = bits
    return out


def _apply_rowsharded(mesh: Mesh, bits: np.ndarray, words, out_rows: int) -> torch.Tensor:
    """Apply a GF(2) bit-matrix with its rows split over ``shard`` and the
    input columns over ``stripe``; returns the (out_rows, W) result."""
    bits = _pad_rows(bits, out_rows, mesh.shape["shard"])
    out = _apply_sharded(mesh, ROW_PARTITION_RULES, bits, bits.shape[0] // 8, words,
                         gf2.apply_bits)
    return out[:out_rows]


def _apply_widthsharded(mesh: Mesh, matrix: np.ndarray, words) -> torch.Tensor:
    """Apply a GF(2^8) matrix with its rows replicated and the width split
    over every position, each position's slice through K1."""
    return _apply_sharded(mesh, WIDTH_PARTITION_RULES, matrix, matrix.shape[0], words,
                          rs_cuda.apply_matrix_cuda, in_place=True)


def sharded_encode(words, mesh: Mesh, data_shards: int, parity_shards: int,
                   cauchy: bool = False) -> torch.Tensor:
    """(k, W) uint32 data words -> (m, W) parity words over the mesh (rows
    mode).  W must split evenly over the stripe axis."""
    matrix = rs_matrix.matrix_for(data_shards, parity_shards, cauchy)
    return _apply_rowsharded(mesh, gf2.expand_bits(matrix[data_shards:]), words, parity_shards)


def sharded_reconstruct(survivor_words, present: tuple[bool, ...], targets: tuple[int, ...],
                        mesh: Mesh, data_shards: int, parity_shards: int,
                        cauchy: bool = False) -> torch.Tensor:
    """Rebuild ``targets`` shard rows from the first-k-present survivors
    (rows mode).  survivor_words: (k, W) uint32, the first k present shards
    in shard order (the reference's Reconstruct input convention)."""
    matrix, _inputs = rs_matrix.reconstruction_matrix(
        data_shards, parity_shards, present, targets, cauchy
    )
    return _apply_rowsharded(mesh, gf2.expand_bits(matrix), survivor_words, len(targets))


class ReedSolomonMesh(ReedSolomonTorch):
    """The pipeline codec over a device MESH: the byte-level interface the
    EC file pipeline consumes (encode / encode_device / reconstruct_device
    via ReedSolomonTorch), with every matrix apply split over the mesh.
    ``device`` is the mesh's first device: inputs go there, results come
    back there, ordered on its current stream (selection seam
    ops/select.pipeline_codec, env SEAWEEDFS_TPU_EC_MESH)."""

    def __init__(self, data_shards: int, parity_shards: int, cauchy: bool = False,
                 mesh: Mesh | None = None, mode: str | None = None):
        mesh = mesh if mesh is not None else make_mesh()
        if len({d.type for d in mesh.devices}) != 1:
            raise ValueError(f"a mesh codec needs one device type, got {mesh}")
        super().__init__(data_shards, parity_shards, cauchy, device=mesh.devices[0])
        self.mesh = mesh
        # "width" (default): matrix rows replicated, width split over every
        # position.  "rows": parity-row ownership.  SEAWEEDFS_TPU_EC_MESH_MODE
        # overrides, as in the JAX package.
        mode = mode or os.environ.get("SEAWEEDFS_TPU_EC_MESH_MODE", "width")
        if mode not in ("width", "rows"):
            raise ValueError(f"unknown mesh mode {mode!r} (width | rows)")
        self.mode = mode

    def _apply(self, matrix: np.ndarray, words: torch.Tensor) -> torch.Tensor:
        matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        if self.mode == "width":
            return _apply_widthsharded(self.mesh, matrix, words)
        return _apply_rowsharded(self.mesh, gf2.expand_bits(matrix), words, matrix.shape[0])

    def _padded_width(self, n: int) -> int:
        # bytes -> words that split evenly over the positions the width is
        # split over; in rows mode on a CUDA mesh, each stripe slice whole
        # BLOCK_WORDS blocks, so the plane kernels take the slices as they
        # are (the plain version on the CPU takes any width).  The pipeline
        # writes only the first n bytes: the pad never reaches a shard file.
        if self.mode == "width":
            quantum = WORD_BYTES * self.mesh.size
        elif self.device.type == "cuda":
            quantum = WORD_BYTES * BLOCK_WORDS * self.mesh.shape["stripe"]
        else:
            quantum = WORD_BYTES * self.mesh.shape["stripe"]
        return -(-n // quantum) * quantum


def _synchronize(mesh: Mesh) -> None:
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _place(mesh: Mesh, rules, name: str, x: np.ndarray) -> Sharded:
    """``x`` placed on the positions under ``rules``, each block on its own
    device: the port of ``jax.device_put`` with a NamedSharding, a
    placement made once and kept."""
    spec = match_partition_rules(rules, {name: x})[name]
    return Sharded({(p.shard, p.stripe): torch.from_numpy(
                        np.ascontiguousarray(_block(x, spec, mesh, p))).to(p.device)
                    for p in mesh.positions}, spec, x.shape)


def measure_scaling(data_shards: int = 10, parity_shards: int = 4,
                    device_counts: tuple[int, ...] | None = None, shard_mb: int = 4,
                    trials: int = 3, devices=None) -> dict:
    """Encode and rebuild throughput per device count on the width-split
    mesh: the JAX package's ec_multichip_scaling record (GB/s of data
    processed, rounded to 3 places; best of ``trials`` after a warm-up
    call).  As there, the data words are placed on the positions once,
    before timing, the codec's ``encode_words`` and ``_apply`` are timed
    on them, and each result stays on the positions: a timed call is one
    K1 a position over its own block, writing its own output.  Rebuild
    applies the worst-case ``parity_shards``-data-loss reconstruction
    matrix.  ``backend`` is the platform's name (``gpu`` or ``cpu``, as
    ``jax.default_backend()`` names them); ``devices`` defaults to every
    CUDA device, as make_mesh's."""
    k, m = data_shards, parity_shards
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if device_counts is None:
        device_counts = tuple(sorted({1, len(devices)}))
    present = tuple([False] * m + [True] * k)  # first m data rows lost
    recon, _inputs = rs_matrix.reconstruction_matrix(k, m, present, tuple(range(m)))
    rng = np.random.default_rng(0)
    record: dict = {
        "metric": "ec_multichip_scaling",
        "unit": "GB/s",
        "mode": "width",
        "backend": "gpu" if devices[0].type == "cuda" else devices[0].type,
        "k": k,
        "m": m,
        "shard_mb": shard_mb,
        "devices": {},
    }

    def best_seconds(fn, mesh: Mesh) -> float:
        fn()  # warm: builds, uploads the matrix
        _synchronize(mesh)
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            fn()
            _synchronize(mesh)
            best = min(best, time.perf_counter() - t0)
        return best

    for n in device_counts:
        mesh = make_mesh(n, devices=devices)
        codec = ReedSolomonMesh(k, m, mesh=mesh, mode="width")
        width = codec._padded_width(shard_mb << 20) // WORD_BYTES
        words = rng.integers(0, 2**32, size=(k, width), dtype=np.uint32)
        placed = _place(mesh, WIDTH_PARTITION_RULES, "data_words", words)
        data_bytes = k * width * WORD_BYTES
        enc_s = best_seconds(lambda: codec.encode_words(placed), mesh)
        reb_s = best_seconds(lambda: codec._apply(recon, placed), mesh)
        record["devices"][str(n)] = {"encode": round(data_bytes / enc_s / 1e9, 3),
                                     "rebuild": round(data_bytes / reb_s / 1e9, 3)}
    counts = sorted(int(c) for c in record["devices"])
    lo, hi = str(counts[0]), str(counts[-1])
    if lo != hi:
        for op in ("encode", "rebuild"):
            base = record["devices"][lo][op]
            record[f"{op}_scaling_{hi}x_vs_{lo}x"] = round(
                record["devices"][hi][op] / base, 3
            ) if base else 0.0
    return record


def _popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of a tensor, as a 0-dim int64 tensor, counted on a uint8
    view (torch on the CPU has no uint32 shifts or reductions)."""
    x = words.contiguous().view(torch.uint8)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    x = (x + (x >> 4)) & 0x0F
    return x.sum(dtype=torch.int64)


def ec_round_trip_step(mesh: Mesh, data_shards: int, parity_shards: int, cauchy: bool = False):
    """Build the distributed step: encode, erase, rebuild, verify.

    Returns a function (k, W) words -> ((m, W) parity, residual) that runs
    on the mesh: parity rows computed on their ``shard`` owners (rows
    mode), gathered over ``shard`` by device-to-device copies, the first m
    data rows erased and rebuilt from (k-m data + m parity) survivors, and
    the xor-popcount residual against the original data summed over every
    position (0 = bit-exact round trip).  The parity and the 0-dim int64
    residual live on the mesh's first device."""
    k, m = data_shards, parity_shards
    shard_par = mesh.shape["shard"]
    if m % shard_par:
        raise ValueError(f"parity rows {m} must divide over shard axis {shard_par}")
    if m > k:
        # the step erases the first m *data* rows; with m > k the survivor
        # layout below would silently be wrong
        raise ValueError(f"round-trip step needs parity {m} <= data {k}")
    enc_bits = gf2.expand_bits(rs_matrix.matrix_for(k, m, cauchy)[k:])
    present = tuple([False] * m + [True] * k)  # first m data rows lost
    dec, inputs = rs_matrix.reconstruction_matrix(k, m, present, tuple(range(m)), cauchy)
    assert list(inputs) == list(range(m, k + m))
    dec_bits = gf2.expand_bits(dec)
    rows_per_dev = m // shard_par
    row_spec = dict(ROW_PARTITION_RULES)[r"_bits$"]
    col_axes = dict(ROW_PARTITION_RULES)[r"_words$"][1]

    def run(words):
        words = _on_first(mesh, words)
        first, width = words.device, words.shape[1]
        local: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}

        def encode(p: Position) -> None:
            x = _to(words[:, _split(width, col_axes, mesh, p)], p.device)
            local[p.shard, p.stripe] = x, gf2.apply_bits(_block(enc_bits, row_spec, mesh, p), x)

        _fan_out(mesh, first, encode)
        parity = torch.empty((m, width), dtype=torch.uint32, device=first)

        def rebuild(p: Position) -> torch.Tensor:
            x, parity_local = local[p.shard, p.stripe]
            # the all-gather over shard: every owner's rows of this stripe
            parity_full = torch.cat(
                [_to(local[i, p.stripe][1], p.device) for i in range(shard_par)])
            survivors = torch.cat([x[m:], parity_full])  # (k, W / stripe)
            rebuilt = gf2.apply_bits(_block(dec_bits, row_spec, mesh, p), survivors)
            expected = x[p.shard * rows_per_dev : (p.shard + 1) * rows_per_dev]
            rows = slice(p.shard * rows_per_dev, (p.shard + 1) * rows_per_dev)
            parity[rows, _split(width, col_axes, mesh, p)].copy_(parity_local)
            return _popcount(rebuilt.view(torch.uint8) ^ expected.view(torch.uint8))

        diffs = _fan_out(mesh, first, rebuild)
        residual = sum(_to(d, first) for d in diffs)
        return parity, residual

    return run
