"""Two faults of the port against the JAX package, each held here:

* the file pipeline's download and its fence (the slot event) must go on
  the codec device's stream, not on the current device's;
* ``measure_scaling`` must time what the JAX record times (the input placed
  on the positions once, the result left there) and give the JAX record's
  keys and 3-place rounding, with the platform's name as ``backend``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from seaweedfs_tpu.parallel import distributed_ec as jax_dec
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.parallel import distributed_ec, make_mesh
from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
from test_torch_parallel import one_torch_thread  # noqa: F401  (a fixture)

CPU4 = [torch.device("cpu")] * 4


class _Stream:
    def __init__(self, device: torch.device):
        self.device = device


class _Event:
    recorded: list = []

    def record(self, stream=None):
        _Event.recorded.append(stream)

    def synchronize(self):
        pass


class _Codec:
    """A codec that says it runs on cuda:1 and computes on the host."""

    device = torch.device("cuda", 1)


@pytest.fixture
def stub_cuda(monkeypatch):
    """torch.cuda.Event, streams and pinned buffers stubbed so the CUDA
    branch of the pipeline runs on the host; cuda:0 is the current device."""
    real_empty = torch.empty
    entered = []

    def empty(*shape, pin_memory=False, **kw):
        return real_empty(*shape, **kw)

    @contextlib.contextmanager
    def stream_ctx(s):
        entered.append(s)
        yield

    _Event.recorded = []
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream(torch.device("cuda", 0) if device is None
                                                    else torch.device(device)))
    monkeypatch.setattr(torch.cuda, "stream", stream_ctx)
    return entered


def test_pipeline_fence_is_recorded_on_the_codec_device(stub_cuda):
    tasks = [(i, 64) for i in range(3)]
    written = []

    def read(task, rows):
        rows[:] = task

    def compute(rows):
        return (rows[:2] ^ 0x5A).clone()

    def write(task, data, out):
        written.append((task, out.copy()))

    st = {k: 0.0 for k in ("setup_s", "read_s", "dispatch_s", "fetch_s", "write_s")}
    ec_encoder._stream(_Codec(), tasks, 3, 2, read, compute, write, st)
    assert [t for t, _ in written] == [0, 1, 2]
    for task, out in written:
        assert (out == (task ^ 0x5A)).all()
    # one fence a batch, each on the codec device's stream, and each download
    # queued on that stream too
    assert len(_Event.recorded) == 3
    assert all(s is not None and s.device == torch.device("cuda", 1) for s in _Event.recorded)
    assert len(stub_cuda) == 3
    assert all(s.device == torch.device("cuda", 1) for s in stub_cuda)


def test_measure_scaling_record_matches_jax_format(one_torch_thread):
    got = distributed_ec.measure_scaling(device_counts=(1, 4), shard_mb=1, trials=1,
                                         devices=CPU4)
    want = jax_dec.measure_scaling(device_counts=(1, 4), shard_mb=1, trials=1)
    assert sorted(got) == sorted(want)
    assert sorted(got["devices"]) == sorted(want["devices"]) == ["1", "4"]
    for key in ("metric", "unit", "mode", "backend", "k", "m", "shard_mb"):
        assert got[key] == want[key], key
    assert got["backend"] == "cpu"
    for rec in (got, want):
        numbers = [v for d in rec["devices"].values() for v in d.values()]
        numbers += [rec[f"{op}_scaling_4x_vs_1x"] for op in ("encode", "rebuild")]
        assert all(isinstance(v, float) and v == round(v, 3) for v in numbers)
    assert all(v > 0 for d in got["devices"].values() for v in d.values())


def test_measure_scaling_backend_names_the_platform(monkeypatch):
    """On CUDA the record says "gpu", as jax.default_backend() does there;
    the timed work is the codec's, one K1 a position over blocks placed
    beforehand, and the result stays on the positions."""
    placed, applied = [], []
    real_place = distributed_ec._place

    def place(mesh, rules, name, x):
        placed.append(name)
        return real_place(mesh, rules, name, x)

    def apply(matrix, data, out=None):
        applied.append((matrix.shape, tuple(data.shape), out is not None))
        return out

    results = []
    real_encode = distributed_ec.ReedSolomonMesh.encode_words

    def encode_words(self, words):
        results.append(real_encode(self, words))
        return results[-1]

    monkeypatch.setattr(distributed_ec.ReedSolomonMesh, "encode_words", encode_words)
    monkeypatch.setattr(distributed_ec, "_place", place)
    monkeypatch.setattr(rs_cuda, "apply_matrix_cuda", apply)
    monkeypatch.setattr(distributed_ec, "make_mesh",
                        lambda n, devices: make_mesh(n, devices=CPU4[:n]))
    rec = distributed_ec.measure_scaling(device_counts=(2,), shard_mb=1, trials=1,
                                         devices=[torch.device("cuda", 0)] * 2)
    assert rec["backend"] == "gpu"
    assert placed == ["data_words"]  # once per device count, outside the timed calls
    width = (1 << 20) // 4
    assert set(applied) == {((4, 10), (10, width // 2), True)}
    assert len(applied) == 2 * 2 * 2  # (warm + 1 trial) x encode/rebuild x 2 positions
    assert len(results) == 2
    for got in results:
        assert isinstance(got, distributed_ec.Sharded) and got.shape == (4, width)
        assert len(got.blocks) == 2


def test_width_mesh_keeps_a_placed_result_on_the_positions():
    """Placed words through the codec's width path give the encode result
    as per-position blocks, equal to the plain apply's columns."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, size=(10, 64), dtype=np.uint32)
    mesh = make_mesh(devices=CPU4, shard_par=2)
    codec = distributed_ec.ReedSolomonMesh(10, 4, mesh=mesh, mode="width")
    placed = distributed_ec._place(mesh, distributed_ec.WIDTH_PARTITION_RULES, "data_words",
                                   words)
    got = codec.encode_words(placed)
    want = rs_cuda.apply_matrix_reference(codec.matrix[10:],
                                          torch.from_numpy(words).view(torch.uint8))
    want = want.view(torch.uint32)
    assert got.shape == (4, 64) and got.spec == (None, ("shard", "stripe"))
    for p in mesh.positions:
        cols = slice((p.shard * 2 + p.stripe) * 16, (p.shard * 2 + p.stripe + 1) * 16)
        assert torch.equal(got.blocks[p.shard, p.stripe], want[:, cols])
    rows = distributed_ec.ReedSolomonMesh(10, 4, mesh=mesh, mode="rows")
    with pytest.raises(ValueError, match="placed as"):
        rows.encode_words(placed)


def test_width_mesh_writes_first_device_slices_in_place(monkeypatch):
    """The width mode hands K1 its slice of the result (``out=``) on the
    first device instead of copying a result of its own into it."""
    rng = np.random.default_rng(3)
    words = torch.from_numpy(rng.integers(0, 2**32, size=(10, 64), dtype=np.uint32))
    mesh = make_mesh(devices=CPU4, shard_par=2)
    codec = distributed_ec.ReedSolomonMesh(10, 4, mesh=mesh, mode="width")
    real = rs_cuda.apply_matrix_cuda
    outs = []

    def apply(matrix, data, out=None):
        outs.append(out is not None)
        return real(matrix, data, out=out)

    monkeypatch.setattr(rs_cuda, "apply_matrix_cuda", apply)
    got = codec.encode_words(words)
    want = rs_cuda.apply_matrix_reference(codec.matrix[10:], words.view(torch.uint8))
    assert torch.equal(got.view(torch.uint8), want)
    assert outs == [True] * 4


def test_apply_matrix_out_checks_its_shape():
    m = np.ones((2, 3), dtype=np.uint8)
    x = torch.zeros((3, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="out must be"):
        rs_cuda.apply_matrix_cuda(m, x, out=torch.empty((3, 8), dtype=torch.uint8))
    big = torch.zeros((2, 16), dtype=torch.uint8)
    x[:] = 7
    assert rs_cuda.apply_matrix_cuda(m, x, out=big[:, 4:12]) is not None
    assert (big[:, 4:12] == 7).all() and (big[:, :4] == 0).all() and (big[:, 12:] == 0).all()
