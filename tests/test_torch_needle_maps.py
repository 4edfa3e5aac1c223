"""The port's needle-map kinds (storage/needle_map.py: MemDb, CompactMap,
LevelDbNeedleMap behind AppendIndex) and its LSM store (util/lsm.py), held
against the JAX package's on the same seeded .idx logs: the same entries,
order and counts for every kind; the same ``.ldb`` bytes; each package
reopening the other's ``.ldb`` (tail replay, and the rebuild after a vacuum
or an index rebuild rewrote the .idx); and CompactMap's folds under a
concurrent reader."""

from __future__ import annotations

import os
import shutil
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.storage import needle_map as jax_nm
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.util import lsm as jax_lsm
from seaweedfs_tpu_torch.storage import needle_map as nm
from seaweedfs_tpu_torch.storage import volume
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.types import TOMBSTONE_FILE_SIZE, pack_index_entry
from seaweedfs_tpu_torch.util import lsm

KINDS = ["memory", "compact", "leveldb"]
PKG = {"port": (nm, volume, Needle), "jax": (jax_nm, jax_volume, JaxNeedle)}


def _write_idx(path, seed: int, n: int, offset_width: int = 4) -> None:
    """A seeded .idx log: n puts over n // 2 distinct keys (so about half
    are overwrites), every 5th entry a tombstone of an earlier key."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 1 << 48, n // 2)
    with open(path, "wb") as f:
        for i in range(n):
            key = int(keys[rng.integers(0, len(keys))])
            if i % 5 == 4:
                f.write(pack_index_entry(key, 0, TOMBSTONE_FILE_SIZE, offset_width))
            else:
                f.write(pack_index_entry(key, 8 * (i + 1), int(rng.integers(1, 1 << 20)),
                                         offset_width))


def _view(db) -> tuple:
    entries = [(v.key, v.offset, v.size) for v in db.ascending()]
    return len(db), entries


def _files(directory) -> dict[str, bytes]:
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("kind", KINDS)
def test_map_kinds_agree_with_jax(tmp_path, kind):
    """One .idx (puts, overwrites, tombstones): every kind of both packages
    gives MemDb's entries, in key order, and the same gets and length."""
    for name in PKG:
        (tmp_path / name).mkdir()
        _write_idx(tmp_path / name / "1.idx", seed=11, n=3000)
    ref = jax_nm.MemDb.load_from_idx(tmp_path / "jax" / "1.idx")
    views = {}
    for name, (mod, _vol, _needle) in PKG.items():
        idx = mod.AppendIndex(tmp_path / name / "1.idx", kind=kind)
        views[name] = _view(idx.db)
        probe = [int(k) for k in np.random.default_rng(1).integers(1, 1 << 48, 50)]
        for k in [v.key for v in ref.ascending()][:200] + probe:
            got, want = idx.get(k), ref.get(k)
            assert (got and (got.offset, got.size)) == (want and (want.offset, want.size))
        idx.close()
    assert views["port"] == views["jax"] == _view(ref)
    if kind == "leveldb":
        assert _files(tmp_path / "port" / "1.idx.ldb") == _files(tmp_path / "jax" / "1.idx.ldb")


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_each_package_reopens_the_others_ldb(tmp_path, writer, reader):
    """The writer indexes an .idx into its LSM map and closes; the reader
    opens the same files, finds the high-water mark at the .idx size (so
    nothing is replayed), takes more entries, and the writer reopens
    those: the tail replay of each package over the other's map."""
    path = tmp_path / "3.idx"
    _write_idx(path, seed=5, n=1200)
    w = PKG[writer][0].AppendIndex(path, kind="leveldb")
    w.put(7, 4096, 100)
    w.delete(7)
    w.put(8, 8192, 200)
    w.close()
    size = os.path.getsize(path)
    r = PKG[reader][0].AppendIndex(path, kind="leveldb")
    assert r.db.indexed_idx_bytes == size
    ref = jax_nm.MemDb.load_from_idx(path)
    assert _view(r.db) == _view(ref)
    assert r.get(7) is None and (r.get(8).offset, r.get(8).size) == (8192, 200)
    r.put(9, 16384, 300)
    r.flush()
    # a crash before the clean close: the mark covers only what flush saw,
    # the reopen replays the rest of the tail
    r.put(10, 24576, 400)
    r._f.flush()
    r.db.close()
    again = PKG[writer][0].AppendIndex(path, kind="leveldb")
    assert again.db.indexed_idx_bytes == os.path.getsize(path)
    assert _view(again.db) == _view(jax_nm.MemDb.load_from_idx(path))
    assert again.get(10).size == 400
    again.close()


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("rewrite", ["vacuum", "rebuild_index", "shrunk_idx"])
def test_ldb_is_rebuilt_after_the_idx_was_rewritten(tmp_path, pinned_clock, writer, reader,
                                                    rewrite):
    """A vacuum or an index rebuild of the writer's leveldb volume drops
    the stale map; an .idx replaced behind the map's back (shorter than its
    mark) makes the reader rebuild it.  Either way the reader's reopened
    volume reads every survivor."""
    _mod, vol_mod, needle_cls = PKG[writer]
    vol = vol_mod.Volume(tmp_path, 4, needle_map_kind="leveldb")
    rng = np.random.default_rng(2)
    needles = [needle_cls(id=int(rng.integers(1, 1 << 40)), cookie=i, data=rng.bytes(300 + i))
               for i in range(120)]
    for n in needles:
        pinned_clock[0] += 1000
        vol.write_needle(n)
    for n in needles[::3]:
        vol.delete_needle(n.id)
    live = {n.id: n.data for n in needles[1::3] + needles[2::3]}
    if rewrite == "vacuum":
        assert vol.vacuum() > 0
    elif rewrite == "rebuild_index":
        vol.rebuild_index()
    vol.close()
    if rewrite == "shrunk_idx":
        # compact the .idx by hand while the map still marks the old length
        db = jax_nm.MemDb.load_from_idx(tmp_path / "4.idx")
        db.save_to_idx(tmp_path / "4.idx")
    mark = PKG[reader][0].LevelDbNeedleMap(str(tmp_path / "4.idx.ldb"))
    stale = mark.indexed_idx_bytes > os.path.getsize(tmp_path / "4.idx")
    mark.close()
    assert stale == (rewrite == "shrunk_idx")
    other = PKG[reader][1].Volume(tmp_path, 4, create=False, needle_map_kind="leveldb")
    assert other.nm.db.indexed_idx_bytes == os.path.getsize(tmp_path / "4.idx")
    assert other.file_count() == len(live)
    assert all(other.read_needle(k).data == d for k, d in live.items())
    assert all(other.nm.get(n.id) is None for n in needles[::3])
    other.close()


@pytest.fixture
def pinned_clock(monkeypatch):
    now = [1_700_000_000_000_000_000]
    monkeypatch.setattr(time, "time_ns", lambda: now[0])
    return now


def _lsm_ops(s, model: dict) -> None:
    """Seeded puts and deletes over 150 keys, into an LsmStore and a dict."""
    rng = np.random.default_rng(4)
    for i in range(400):
        key = b"k%05d" % int(rng.integers(0, 150))
        if i % 7 == 6:
            s.delete(key)
            model.pop(key, None)
        else:
            model[key] = rng.bytes(int(rng.integers(0, 40)))
            s.put(key, model[key])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lsm_store_bytes_and_reopen(tmp_path, writer):
    """The same puts and deletes through both LsmStores (memtable flushes
    and compactions included) leave byte-identical directories; the port's
    store, on its own directory or the JAX one's, scans exactly the live
    keys, and each package gets every key from the other's directory."""
    stores, model = {}, {}
    for name, mod in (("port", lsm), ("jax", jax_lsm)):
        s = mod.LsmStore(str(tmp_path / name), memtable_bytes=2048, compact_threshold=3)
        model = {}
        _lsm_ops(s, model)
        stores[name] = s
    expect = sorted(model.items())
    assert list(stores["port"].scan()) == expect
    assert list(stores["port"].scan(b"k00050", b"k00100")) == [
        (k, v) for k, v in expect if b"k00050" <= k < b"k00100"]
    for s in stores.values():
        s.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    other = "jax" if writer == "port" else "port"
    for mod, directory in ((lsm, writer), (jax_lsm, other)):
        reader = mod.LsmStore(str(tmp_path / directory))
        assert all(reader.get(b"k%05d" % i) == model.get(b"k%05d" % i) for i in range(150))
        if mod is lsm:
            assert list(reader.scan()) == expect
        reader.close()


def test_lsm_scan_takes_the_newest_table():
    """A key overwritten (or deleted) in a newer table scans to the newer
    value in the port.  The JAX module's merge gives every table the same
    priority, so its scan of the same directory misorders them."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        s = lsm.LsmStore(d)
        s.put(b"a", b"\xff old")
        s.put(b"b", b"kept")
        s.flush()
        s.put(b"a", b"\x00 new")
        s.delete(b"b")
        s.flush()
        s.put(b"c", b"mem")
        assert list(s.scan()) == [(b"a", b"\x00 new"), (b"c", b"mem")]
        s.close()
        jax = jax_lsm.LsmStore(d)
        try:
            got = list(jax.scan())
        except TypeError:  # a tombstone compared with a value
            got = None
        assert got != [(b"a", b"\x00 new")]
        jax.close()


def test_lsm_wal_torn_tail_is_dropped(tmp_path):
    s = lsm.LsmStore(str(tmp_path / "kv"))
    s.put(b"a", b"1")
    s.put(b"b", b"2")
    s._wal.close()  # a crash: the memtable lives only in the WAL
    with open(tmp_path / "kv" / "wal.log", "ab") as f:
        f.write(b"\x01\x02\x03")  # a torn record
    for mod in (lsm, jax_lsm):
        again = mod.LsmStore(str(tmp_path / "kv"))
        assert list(again.scan()) == [(b"a", b"1"), (b"b", b"2")]
        again._wal.close()


def test_compact_map_folds_under_a_concurrent_reader():
    """Writers fold the overlay while readers call len(), ascending() and
    get(): no reader ever sees an error, and the end state equals MemDb's
    (and the JAX CompactMap's) for the same operations."""
    cm, ref, jax_cm = nm.CompactMap(fold_at=64), nm.MemDb(), jax_nm.CompactMap(fold_at=64)
    rng = np.random.default_rng(8)
    ops = [(int(k), int(o), bool(d)) for k, o, d in
           zip(rng.integers(1, 1500, 6000), rng.integers(1, 1 << 30, 6000),
               rng.random(6000) < 0.2)]
    errors, stop = [], threading.Event()

    def reader(seed: int):
        probe = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                n = len(cm)
                keys = [v.key for v in cm.ascending()]
                assert keys == sorted(keys) and n >= 0
                cm.get(int(probe.integers(1, 1500)))
                time.sleep(0.001)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    try:
        for key, off, dead in ops:
            for m in (cm, ref, jax_cm):
                if dead:
                    m.delete(key)
                else:
                    m.set(key, off, 100)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not errors, errors
    assert _view(cm) == _view(ref) == _view(jax_cm)
    assert all(cm.get(k) == ref.get(k) for k in range(1, 1500))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("offset_width", [4, 5])
def test_volume_with_each_kind_matches_jax(tmp_path, pinned_clock, kind, offset_width):
    """A port volume and a JAX volume of the same kind and offset width,
    given the same writes, deletes and vacuum, leave the same .dat and .idx
    bytes (17-byte entries at width 5) and reopen to the same view."""
    out = {}
    for name, (_mod, vol_mod, needle_cls) in PKG.items():
        d = tmp_path / name
        d.mkdir()
        pinned_clock[0] = 1_700_000_000_000_000_000
        vol = vol_mod.Volume(d, 6, needle_map_kind=kind, offset_width=offset_width)
        rng = np.random.default_rng(9)
        for i in range(80):
            pinned_clock[0] += 1000
            vol.write_needle(needle_cls(id=i + 1, cookie=i, data=rng.bytes(200 + 7 * i)))
        for i in range(1, 80, 4):
            vol.delete_needle(i)
        reclaimed = vol.vacuum()
        vol.close()
        again = vol_mod.Volume(d, 6, create=False, needle_map_kind=kind)
        out[name] = (reclaimed, again.file_count(), [v.key for v in again.nm.db.ascending()],
                     again.read_needle(2).data)
        again.close()
        shutil.rmtree(d / "6.idx.ldb", ignore_errors=True)
    assert out["port"] == out["jax"]
    idx = _files(tmp_path / "port")["6.idx"]
    assert len(idx) == out["port"][1] * (12 + offset_width)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
