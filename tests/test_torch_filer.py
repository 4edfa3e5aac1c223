"""The port's filer core on the CPU, held against the JAX package.

- Entries and chunk views: ``visible_intervals``, ``read_chunk_views`` and
  ``total_size`` on random overlapping chunk sets, and ``Entry`` protobuf
  bytes, equal to the JAX package's on the same seeded inputs.
- Stores: every store kind given the same seeded operation sequence lists,
  finds and counts what the JAX store of that kind does, and each package
  opens the other's LSM directory, leveldb2 and leveldb3 directories,
  sqlite ``.db``, ``.btree`` file and metadata log.  The LSM scan
  divergence (the JAX merge ranks every table alike) is shown for both.
- ``Filer`` operations and their events, ``filer_conf`` matching, chunk
  manifests with a small batch, and the ``-db`` factory, each as the JAX
  package's.

Everything here is in process and device-free."""

from __future__ import annotations

import os

import numpy as np
import pytest

from seaweedfs_tpu import filer as jax_filer
from seaweedfs_tpu.filer import entry as jax_entry
from seaweedfs_tpu.filer import filechunks as jax_filechunks
from seaweedfs_tpu.filer import filer_conf as jax_filer_conf
from seaweedfs_tpu.filer import leveldb_store as jax_leveldb_store
from seaweedfs_tpu.filer import manifest as jax_manifest
from seaweedfs_tpu.filer import meta_log as jax_meta_log
from seaweedfs_tpu.filer.filer import Filer as JaxFiler
from seaweedfs_tpu.filer.filer import FilerError as JaxFilerError
from seaweedfs_tpu.util import btree as jax_btree
from seaweedfs_tpu_torch import filer
from seaweedfs_tpu_torch.filer import entry, filechunks, filer_conf, leveldb_store, manifest
from seaweedfs_tpu_torch.filer import meta_log
from seaweedfs_tpu_torch.filer.filer import Filer, FilerError, _to_pb_event
from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb
from seaweedfs_tpu_torch.util import btree


# -- entries and chunk views ---------------------------------------------------


def _chunk_set(seed: int, mod) -> list:
    """A seeded set of overlapping chunks, some sharing a timestamp (the
    fid breaks the tie)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 24))
    out = []
    for i in range(n):
        off = int(rng.integers(0, 4096))
        out.append(mod.FileChunk(fid=f"{rng.integers(1, 9)},{i:x}{int(rng.integers(0, 1 << 31)):08x}",
                                 offset=off, size=int(rng.integers(1, 2048)),
                                 modified_ts_ns=int(rng.integers(0, 6)), e_tag=f"e{i}"))
    return out


def _views(views) -> list:
    return [(v.fid, v.offset_in_chunk, v.size, v.logical_offset) for v in views]


@pytest.mark.parametrize("seed", range(8))
def test_visible_intervals_and_views_match_jax(seed):
    got = filechunks.visible_intervals(_chunk_set(seed, entry))
    want = jax_filechunks.visible_intervals(_chunk_set(seed, jax_entry))
    assert [(v.start, v.stop, v.fid, v.chunk_offset, v.modified_ts_ns) for v in got] == \
        [(v.start, v.stop, v.fid, v.chunk_offset, v.modified_ts_ns) for v in want]
    rng = np.random.default_rng(seed + 100)
    for _ in range(16):
        off, size = int(rng.integers(0, 6000)), int(rng.integers(0, 3000))
        assert _views(filechunks.read_chunk_views(got, off, size)) == \
            _views(jax_filechunks.read_chunk_views(want, off, size))
    assert filechunks.total_size(_chunk_set(seed, entry)) == \
        jax_filechunks.total_size(_chunk_set(seed, jax_entry))


def test_newest_chunk_wins_where_chunks_overlap():
    chunks = [entry.FileChunk("1,a01", 0, 100, 1), entry.FileChunk("1,b02", 50, 100, 2),
              entry.FileChunk("1,c03", 20, 10, 3)]
    got = [(v.start, v.stop, v.fid, v.chunk_offset)
           for v in filechunks.visible_intervals(chunks)]
    assert got == [(0, 20, "1,a01", 0), (20, 30, "1,c03", 0), (30, 50, "1,a01", 30),
                   (50, 150, "1,b02", 0)]


def _entries(mod) -> list:
    attr = mod.Attr(mtime=1700000000.0, crtime=1690000000.0, mode=0o640, uid=7, gid=8,
                    mime="text/plain", ttl_seconds=60, collection="c", replication="001")
    chunks = _chunk_set(3, mod)
    return [
        mod.Entry("/a/b/file.bin", attr=attr, chunks=chunks),
        mod.Entry("/a/dir", is_directory=True, attr=mod.Attr(mtime=5.0, crtime=4.0, mode=0o755)),
        mod.Entry("/inline.txt", attr=attr, content=b"hello world"),
        mod.Entry("/x/y", attr=attr, extended={"k1": b"v1", "hardlink-id": b"abc", "z": b""}),
        mod.Entry("/m", chunks=[mod.FileChunk("3,1f00000001", 0, 10, 9, "tag", True)]),
    ]


def _same_pb(a: bytes, b: bytes, has_map: bool) -> bool:
    """Equal bytes; for an entry with ``extended`` (a protobuf map, whose
    serialized order after a parse is not fixed) equal parsed messages,
    as the JAX package's own comparisons hold them."""
    if has_map:
        return f_pb.Entry.FromString(a) == f_pb.Entry.FromString(b)
    return a == b


@pytest.mark.parametrize("i", range(5))
def test_entry_pb_bytes_match_jax(i):
    got, want = _entries(entry)[i], _entries(jax_entry)[i]
    has_map = bool(got.extended)
    assert _same_pb(got.encode(), want.encode(), has_map)
    assert got.size == want.size and (got.name, got.parent) == (want.name, want.parent)
    back = jax_entry.Entry.decode(got.full_path, got.encode())
    assert _same_pb(back.encode(), got.encode(), has_map)
    again = entry.Entry.decode(want.full_path, want.encode())
    assert again == got


# -- stores --------------------------------------------------------------------


STORE_KINDS = ["memory", "sqlite", "sqlite2", "leveldb", "leveldb2", "leveldb3", "btree"]


def _store_spec(kind: str, root: str) -> str:
    return {"memory": "", "sqlite": os.path.join(root, "f.db"),
            "sqlite2": "sqlite2:" + os.path.join(root, "f2.db"),
            "leveldb": os.path.join(root, "lsm"), "leveldb2": "leveldb2:" + os.path.join(root, "l2"),
            "leveldb3": "leveldb3:" + os.path.join(root, "l3"),
            "btree": os.path.join(root, "f.btree")}[kind]


def _ops(seed: int) -> list:
    """A seeded sequence of store operations over a few directories,
    /buckets/<b> subtrees included (the bucket-table modes)."""
    rng = np.random.default_rng(seed)
    dirs = ["/", "/a", "/a/b", "/buckets/bk1", "/buckets/bk1/p", "/buckets/bk2", "/z_%dir"]
    ops = []
    for i in range(300):
        d = dirs[int(rng.integers(0, len(dirs)))]
        name = f"n{int(rng.integers(0, 40)):02d}{'_' if i % 7 == 0 else ''}"
        roll = rng.random()
        if roll < 0.7:
            ops.append(("put", d, name, bool(rng.random() < 0.2), int(rng.integers(0, 1 << 30))))
        elif roll < 0.9:
            ops.append(("del", d, name))
        else:
            ops.append(("rmchildren", "/a/b"))
    return ops


def _apply(store, mod, ops) -> None:
    for op in ops:
        path_of = lambda d, n: ("" if d == "/" else d) + "/" + n  # noqa: E731
        if op[0] == "put":
            _k, d, n, is_dir, stamp = op
            store.insert_entry(mod.Entry(path_of(d, n), is_directory=is_dir,
                                         attr=mod.Attr(mtime=float(stamp), mode=0o600),
                                         content=b"" if is_dir else str(stamp).encode()))
        elif op[0] == "del":
            store.delete_entry(path_of(op[1], op[2]))
        else:
            store.delete_folder_children(op[1])


def _listing(store, dirs=("/", "/a", "/a/b", "/buckets/bk1", "/buckets/bk1/p", "/buckets/bk2",
                          "/z_%dir", "/nothing")) -> dict:
    out = {}
    for d in dirs:
        out[d] = [e.encode() for e in store.list_entries(d, limit=1000)]
        out[d + "?page"] = [e.name for e in store.list_entries(d, "n10", False, 5)]
        out[d + "?incl"] = [e.name for e in store.list_entries(d, "n10", True, 5)]
        out[d + "?prefix"] = [e.name for e in store.list_entries(d, prefix="n1", limit=1000)]
        out[d + "?find"] = [(e.encode() if e else None)
                            for e in (store.find_entry(("" if d == "/" else d) + f"/n{i:02d}")
                                      for i in range(0, 40, 3))]
    return out


@pytest.mark.parametrize("kind", STORE_KINDS)
def test_stores_list_as_jax(kind, tmp_path):
    ops = _ops(STORE_KINDS.index(kind))
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got_store = filer.make_store(_store_spec(kind, str(tmp_path / "port")))
    want_store = jax_filer.make_store(_store_spec(kind, str(tmp_path / "jax")))
    try:
        assert got_store.name == want_store.name == {"sqlite2": "sqlite"}.get(kind, kind)
        _apply(got_store, entry, ops)
        _apply(want_store, jax_entry, ops)
        assert _listing(got_store) == _listing(want_store)
        assert got_store.count() == want_store.count()
    finally:
        got_store.close()
        want_store.close()


CROSS_KINDS = ["sqlite", "sqlite2", "leveldb", "leveldb2", "leveldb3", "btree"]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind", CROSS_KINDS)
def test_each_package_opens_the_others_store(kind, writer, tmp_path):
    """One package writes a store; the other reopens the same files and
    lists, finds and counts exactly what the writer does."""
    (tmp_path / "s").mkdir()
    spec = _store_spec(kind, str(tmp_path / "s"))
    write_mod, write_make = (entry, filer.make_store) if writer == "port" else \
        (jax_entry, jax_filer.make_store)
    read_make = jax_filer.make_store if writer == "port" else filer.make_store
    store = write_make(spec)
    _apply(store, write_mod, _ops(11 + CROSS_KINDS.index(kind)))
    want, want_count = _listing(store), store.count()
    store.close()
    other = read_make(spec)
    try:
        assert _listing(other) == want
        assert other.count() == want_count
    finally:
        other.close()


def test_btree_files_are_byte_identical(tmp_path):
    ops = _ops(42)
    a, b = btree.BTreeStore(str(tmp_path / "a.btree")), jax_btree.BTreeStore(str(tmp_path / "b.btree"))
    for store in (a, b):
        for op in ops:
            if op[0] == "rmchildren":
                continue
            key = f"{op[1]}\x00{op[2]}".encode()
            if op[0] == "put":
                store.put(key, str(op[4]).encode() * 3)
            elif op[0] == "del":
                store.delete(key)
        store.close()
    assert (tmp_path / "a.btree").read_bytes() == (tmp_path / "b.btree").read_bytes()


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_lsm_listing_across_two_flushed_tables(mod, tmp_path):
    """Queue C item 1 at the filer: an entry updated after its first
    version was flushed, then flushed again, lies in two tables.  The
    port's listing shows the newest version; the JAX package's merge ranks
    every table alike and takes the value that sorts first, here the
    stale one."""
    store_cls = leveldb_store.LevelDbStore if mod == "port" else jax_leveldb_store.LevelDbStore
    emod = entry if mod == "port" else jax_entry
    store = store_cls(str(tmp_path / "lsm"))
    try:
        store.insert_entry(emod.Entry("/d/f", content=b"aaa"))
        store.db.flush()
        store.insert_entry(emod.Entry("/d/f", content=b"bbb"))
        store.db.flush()
        assert store.find_entry("/d/f").content == b"bbb"  # get() is right in both
        listed = [e.content for e in store.list_entries("/d")]
        assert listed == ([b"bbb"] if mod == "port" else [b"aaa"])
    finally:
        store.close()


def test_rocksdb_store_is_refused_as_in_jax(tmp_path):
    for make in (filer.make_store, jax_filer.make_store):
        with pytest.raises(RuntimeError, match="rocksdb store needs the rocksdb package"):
            make("rocksdb:" + str(tmp_path / "r"))


@pytest.mark.parametrize("spec", ["redis://127.0.0.1:6379/0", "etcd://127.0.0.1:2379",
                                  "elastic://127.0.0.1:9200", "mysql://u:p@127.0.0.1/db",
                                  "postgres2://u:p@127.0.0.1/db", "mongodb://127.0.0.1/db"])
def test_network_stores_say_not_ported(spec):
    """The network stores are ported: each URL gets the JAX factory's store
    class or its refusal (an absent driver, an unreachable server), and
    none of them says "not ported" any more."""
    outcomes = []
    for make in (filer.make_store, jax_filer.make_store):
        try:
            store = make(spec)
        except RuntimeError as e:
            outcomes.append(str(e).replace("seaweedfs_tpu_torch", "seaweedfs_tpu"))
        else:
            outcomes.append(type(store).__name__)
            store.close()
    assert outcomes[0] == outcomes[1]
    assert "not ported" not in outcomes[0]


# -- the metadata log ----------------------------------------------------------


def _events(emod, pb_event):
    events = []
    for i in range(40):
        e = emod.Entry(f"/logs/f{i}", attr=emod.Attr(mtime=float(i)), content=bytes([i]) * i)
        events.append(pb_event(i + 1, "/logs", None if i % 3 == 0 else e, e if i % 5 else None))
    return events


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_meta_log_segments_cross_read(writer, tmp_path, monkeypatch):
    from seaweedfs_tpu.filer.filer import MetaEvent as JaxMetaEvent
    from seaweedfs_tpu.filer.filer import _to_pb_event as jax_to_pb_event
    from seaweedfs_tpu_torch.filer.filer import MetaEvent

    def port_event(ts, d, old, new):
        return _to_pb_event(MetaEvent(ts, d, old, new, "/moved" if ts % 4 == 0 else ""))

    def jax_event(ts, d, old, new):
        return jax_to_pb_event(JaxMetaEvent(ts, d, old, new, "/moved" if ts % 4 == 0 else ""))

    for m in (meta_log, jax_meta_log):
        monkeypatch.setattr(m, "SEGMENT_BYTES", 512)  # several segments
    if writer == "port":
        log, events, reader = meta_log.PersistentMetaLog(str(tmp_path)), \
            _events(entry, port_event), jax_meta_log.PersistentMetaLog(str(tmp_path))
    else:
        log, events, reader = jax_meta_log.PersistentMetaLog(str(tmp_path)), \
            _events(jax_entry, jax_event), meta_log.PersistentMetaLog(str(tmp_path))
    for ev in events:
        log.append(ev)
    log.close()
    assert len(os.listdir(tmp_path)) > 2
    want = [ev.SerializeToString() for ev in events]
    assert [ev.SerializeToString() for ev in reader.read_since(0)] == want
    assert [ev.SerializeToString() for ev in reader.read_since(25)] == want[25:]


# -- Filer operations and events -----------------------------------------------


def _filer_script(fmod, emod, err_cls, f) -> list:
    """The same operations on a Filer; returns a transcript of results,
    listings and the event log (timestamps dropped)."""
    out = []

    def step(fn):
        try:
            out.append(("ok", fn()))
        except (FileNotFoundError, err_cls) as e:
            out.append((type(e).__name__, str(e)))

    step(lambda: f.create_entry(emod.Entry("/a/b/c.txt", content=b"abc")))
    step(lambda: f.create_entry(emod.Entry("/a/b", content=b"x")))  # exists as a directory
    step(lambda: f.create_entry(emod.Entry("/a/b/c.txt/d", content=b"x")))  # parent is a file
    step(lambda: f.create_entry(emod.Entry("relative", content=b"x")))
    step(lambda: f.mkdirs("/m/n/o"))
    for i in range(6):
        step(lambda i=i: f.create_entry(emod.Entry(f"/a/b/f{i}", content=bytes([i]) * 5)))
    step(lambda: f.update_entry(emod.Entry("/a/b/f1", content=b"updated")))
    step(lambda: [e.name for e in f.list_entries("/a/b", limit=3)])
    step(lambda: [e.name for e in f.list_entries("/a/b", start_file_name="f2", limit=10)])
    step(lambda: [e.name for e in f.list_entries("/a/b", prefix="f", limit=10)])
    step(lambda: f.rename("/a/b", "/r/s").full_path)
    step(lambda: [e.full_path for e in f.list_entries("/r/s", limit=100)])
    step(lambda: f.delete_entry("/r").full_path)  # non-empty without recursive
    step(lambda: f.delete_entry("/r", recursive=True).full_path)
    step(lambda: f.delete_entry("/r/s/f1"))
    step(lambda: f.create_entry(emod.Entry("/h/src", content=b"shared")))
    step(lambda: f.hard_link("/h/src", "/h/link"))
    step(lambda: f.find_entry("/h/link").content)
    step(lambda: f.delete_entry("/h/src").name)
    step(lambda: f.find_entry("/h/link").content)
    step(lambda: f.create_entry(emod.Entry("/ttl/x", attr=emod.Attr(crtime=1.0, ttl_seconds=5),
                                           content=b"gone")))
    step(lambda: f.find_entry("/ttl/x"))
    step(lambda: f.statistics())
    out.append([(ev.directory, ev.old_entry.full_path if ev.old_entry else None,
                 ev.new_entry.full_path if ev.new_entry else None, ev.new_parent_path)
                for ev in f.meta_log.read_since(0)])
    out.append([(ev.directory, ev.new_entry.name if ev.new_entry else None)
                for ev in f.read_meta_events(0, "/h")])
    return out


@pytest.mark.parametrize("store_kind", ["memory", "leveldb", "sqlite"])
def test_filer_operations_and_events_match_jax(store_kind, tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got_f = Filer(filer.make_store(_store_spec(store_kind, str(tmp_path / "p"))),
                  meta_log_dir=str(tmp_path / "p" / "log"))
    want_f = JaxFiler(jax_filer.make_store(_store_spec(store_kind, str(tmp_path / "j"))),
                      meta_log_dir=str(tmp_path / "j" / "log"))
    got = _filer_script(filer, entry, FilerError, got_f)
    want = _filer_script(jax_filer, jax_entry, JaxFilerError, want_f)
    assert got == want
    # the persisted logs hold the same events, apart from their clocks
    strip = [(ev.directory, ev.new_parent_path,
              ev.old_entry.name, ev.new_entry.name) for ev in got_f.persist_log.read_since(0)]
    assert strip == [(ev.directory, ev.new_parent_path, ev.old_entry.name, ev.new_entry.name)
                     for ev in want_f.persist_log.read_since(0)]
    for f in (got_f, want_f):
        f.persist_log.close()
        f.store.close()


# -- filer_conf ----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_filer_conf_matching_matches_jax(seed):
    rng = np.random.default_rng(seed)
    prefixes = ["/", "/data/", "/data/hot/", "/buckets/", "/buckets/b1", "/tmp", "/data/hot/x/"]
    rules = []
    for p in prefixes:
        if rng.random() < 0.8:
            rules.append(dict(location_prefix=p, collection=f"c{int(rng.integers(0, 5))}",
                              replication=["", "000", "001"][int(rng.integers(0, 3))],
                              ttl_seconds=int(rng.integers(0, 2)) * 60,
                              read_only=bool(rng.random() < 0.2),
                              volume_growth_count=int(rng.integers(0, 3))))
    got, want = filer_conf.FilerConf(), jax_filer_conf.FilerConf()
    for r in rules:
        got.upsert(filer_conf.PathConf(**r))
        want.upsert(jax_filer_conf.PathConf(**r))
    assert got.to_bytes() == want.to_bytes()
    assert filer_conf.FilerConf.from_bytes(want.to_bytes()).to_bytes() == want.to_bytes()
    for _ in range(50):
        path = "/" + "/".join(["data", "hot", "x", "buckets", "b1", "tmp"][int(i)]
                              for i in rng.integers(0, 6, int(rng.integers(0, 4))))
        g, w = got.match(path), want.match(path)
        assert (g.to_dict() if g else None) == (w.to_dict() if w else None), path
    assert got.delete("/data/") == want.delete("/data/")
    assert got.to_bytes() == want.to_bytes()
    assert filer_conf.FilerConf.from_bytes(b"{not json").rules == []


# -- manifests -----------------------------------------------------------------


@pytest.mark.parametrize("batch", [3, 7])
def test_manifests_with_a_small_batch_match_jax(batch):
    store: dict = {}

    def save(blob: bytes) -> str:
        fid = f"9,{len(store) + 1:x}0000abcd"
        store[fid] = blob
        return fid

    chunks = [entry.FileChunk(f"1,{i:x}00000001", i * 10, 10, i) for i in range(25)]
    jchunks = [jax_entry.FileChunk(f"1,{i:x}00000001", i * 10, 10, i) for i in range(25)]
    got = manifest.maybe_manifestize(save, chunks, batch)
    got_blobs = dict(store)
    store.clear()
    want = jax_manifest.maybe_manifestize(save, jchunks, batch)
    assert got_blobs == store  # the same manifest blobs, byte for byte
    assert [(c.fid, c.offset, c.size, c.is_chunk_manifest) for c in got] == \
        [(c.fid, c.offset, c.size, c.is_chunk_manifest) for c in want]
    assert len(got) == 25 // batch + 25 % batch
    data, manifests = manifest.resolve_chunk_manifest(store.__getitem__, got)
    assert [c.fid for c in data] == [c.fid for c in chunks]
    assert len(manifests) == 25 // batch
    # a manifest of manifests resolves to the same data chunks
    top = manifest.merge_into_manifest(save, [c for c in got if c.is_chunk_manifest])
    nested = [top] + [c for c in got if not c.is_chunk_manifest]
    data2, manifests2 = manifest.resolve_chunk_manifest(store.__getitem__, nested)
    assert sorted(c.fid for c in data2) == sorted(c.fid for c in chunks)
    assert len(manifests2) == len(manifests) + 1
