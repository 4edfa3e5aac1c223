"""The port's mount layer (seaweedfs_tpu_torch/mount/: PageWriter,
MetaCache, WeedFS, the FUSE gate, and ``cli mount``) held against the JAX
package's.

- ``PageWriter``: the same seeded write scripts leave equal dirty
  intervals and overlays, and ``flush_to_chunks`` with one fake upload
  function (and one fake clock) gives equal ``FileChunk`` lists.
- ``MetaCache`` over one fake filer client: the same lookups, hits,
  invalidations and event-driven drops.
- ``WeedFS`` driven by one op script against a JAX stack and a port
  stack (each a master, a volume server and a filer of its own package):
  seeded random-offset and overlapping writes, a file of many chunks that
  the flush folds into manifests, truncation to 0 and mid-file, a rename
  across directories and the errnos ENOENT, ENOTEMPTY, EEXIST, EISDIR,
  ENOTDIR and ENOSYS.  Reads must be byte-equal to a numpy model and to
  each other; getattr sizes, readdir listings and errnos must be equal.
- A file created by another writer shows up through the event stream, and
  a failed flush keeps the file dirty for a retry (tests/test_mount.py's
  regressions, on both packages).
- Without FUSE, ``mount()`` refuses with the JAX package's text and ``cli
  mount`` answers rc 1 with its three-line explanation.

The tolerance is exact equality; fids and mtimes are not compared."""

from __future__ import annotations

import dataclasses
import errno
import io
import types
from contextlib import redirect_stdout

import grpc
import numpy as np
import pytest

from gateway_stacks import pkg, stacks_fixture, wait

from seaweedfs_tpu.mount import page_writer as jax_pw
from seaweedfs_tpu_torch.mount import page_writer as port_pw

CHUNK = 64 * 1024
BATCH = 4


@pytest.fixture(scope="module")
def stacks():
    yield from stacks_fixture("torch-mount-")


# ---- PageWriter ---------------------------------------------------------

def _write_script(seed: int, n: int = 60, span: int = 1 << 16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        off = int(rng.integers(0, span))
        size = int(rng.integers(0, 4096))
        out.append((off, rng.bytes(size)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_page_writer_intervals_and_overlays_match_jax(seed):
    writers = [port_pw.PageWriter(chunk_size=5000), jax_pw.PageWriter(chunk_size=5000)]
    model = bytearray(1 << 17)
    top = 0
    for off, data in _write_script(seed):
        for w in writers:
            w.write(off, data)
        model[off:off + len(data)] = data
        top = max(top, off + len(data)) if data else top
        assert [(s, bytes(b)) for s, b in writers[0]._dirty] == [
            (s, bytes(b)) for s, b in writers[1]._dirty]
    rng = np.random.default_rng(seed + 100)
    base = rng.bytes(len(model))
    for _ in range(20):
        lo = int(rng.integers(0, len(model) - 1))
        hi = int(rng.integers(lo, len(model)))
        got = [w.overlay(base[lo:hi], lo) for w in writers]
        assert got[0] == got[1]
    assert writers[0].dirty_size_ceiling() == writers[1].dirty_size_ceiling() == top
    assert writers[0].dirty_bytes() == writers[1].dirty_bytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_flush_to_chunks_matches_jax(seed, monkeypatch):
    results = []
    for mod in (port_pw, jax_pw):
        clock = iter(range(10**6))
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time_ns=lambda: next(clock)))
        blobs = []

        def upload(data, blobs=blobs):
            blobs.append(data)
            return f"3,{len(blobs):x}"

        w = mod.PageWriter(chunk_size=3000)
        for off, data in _write_script(seed, n=25, span=20000):
            w.write(off, data)
        chunks = w.flush_to_chunks(upload)
        assert w.dirty
        w.mark_clean()
        assert not w.dirty
        results.append(([dataclasses.asdict(c) for c in chunks], blobs))
    assert results[0] == results[1]
    assert len(results[0][0]) > 3


# ---- MetaCache ----------------------------------------------------------

class _FakeClient:
    """Counts lookups; subscribe yields the scripted events once."""

    def __init__(self, entries: dict, events: list, entry_cls):
        self.entries, self.events, self.lookups = entries, events, []
        self.entry_cls = entry_cls
        self.served = False

    def lookup(self, path):
        self.lookups.append(path)
        return self.entries.get(path)

    def subscribe(self, root, since, timeout=2.0):
        if self.served:
            raise grpc.RpcError()
        self.served = True
        yield from self.events


def _event(entry_cls, directory, old="", new="", new_parent=""):
    return types.SimpleNamespace(
        ts_ns=1, directory=directory, new_parent_path=new_parent,
        old_entry=types.SimpleNamespace(name=old), new_entry=types.SimpleNamespace(name=new))


def test_meta_cache_matches_jax():
    outs = []
    for name in ("port", "jax"):
        mc_mod = pkg(name, "mount.meta_cache")
        entry_cls = pkg(name, "filer.entry").Entry
        entries = {"/a/x": entry_cls("/a/x", content=b"x"), "/a": entry_cls("/a", is_directory=True)}
        events = [_event(entry_cls, "/a", new="y"), _event(entry_cls, "/a", old="x", new="z",
                                                           new_parent="/b")]
        client = _FakeClient(entries, events, entry_cls)
        mc = mc_mod.MetaCache(client, "/", ttl=60.0)
        seen = [mc.lookup(p) is not None for p in ("/a/x", "/a/x", "/a/y", "/a/y", "/a")]
        entries["/a/y"] = entry_cls("/a/y", content=b"y")
        seen.append(mc.lookup("/a/y") is not None)  # cached miss: still None
        mc.invalidate("/a/y")
        seen.append(mc.lookup("/a/y") is not None)
        mc.start_subscriber()
        wait(lambda: mc.invalidations >= 4, "the scripted events")
        mc.stop()
        keys = sorted(mc._cache)
        mc.clear()
        outs.append((seen, list(client.lookups), mc.invalidations, keys, sorted(mc._cache)))
    assert outs[0] == outs[1]
    assert outs[0][0] == [True, True, False, False, True, False, True]


# ---- WeedFS -------------------------------------------------------------

def _errno(fn, *a):
    try:
        fn(*a)
    except OSError as e:
        return e.errno
    return 0


def _script(fs, name: str) -> list:
    """One op script; returns every observable result."""
    rng = np.random.default_rng(7)
    out = []
    model = {}

    def write(fh, path, off, data):
        assert fs.write(fh, off, data) == len(data)
        buf = model.setdefault(path, bytearray())
        if len(buf) < off + len(data):
            buf.extend(b"\0" * (off + len(data) - len(buf)))
        buf[off:off + len(data)] = data

    def check(path):
        fh = fs.open(path)
        got = fs.read(fh, 0, 1 << 30)
        fs.release(fh)
        assert got == bytes(model[path]), (name, path)
        a = fs.getattr(path)
        out.append((path, a["size"], a["is_dir"], len(got), got[:64], got[-64:]))

    fs.mkdir("/w")
    fs.mkdir("/w/d1")
    fs.mkdir("/w/d2")
    out.append(("EEXIST", _errno(fs.mkdir, "/w/d1")))
    # random-offset and overlapping writes, read back before and after flush
    fh = fs.create("/w/d1/rand.bin")
    for _ in range(24):
        off = int(rng.integers(0, 3 * CHUNK))
        write(fh, "/w/d1/rand.bin", off, rng.bytes(int(rng.integers(1, 9000))))
    write(fh, "/w/d1/rand.bin", 100, rng.bytes(CHUNK + 300))  # overlaps several
    out.append(("dirty-size", fs.getattr("/w/d1/rand.bin")["size"]))
    assert fs.read(fh, 0, 1 << 30) == bytes(model["/w/d1/rand.bin"])
    fs.flush(fh)
    write(fh, "/w/d1/rand.bin", 5, b"after-flush")
    fs.release(fh)
    check("/w/d1/rand.bin")
    # a file of many chunks: the flush folds them into manifest chunks
    fh = fs.create("/w/d1/big.bin")
    big = rng.bytes(11 * CHUNK + 123)
    write(fh, "/w/d1/big.bin", 0, big)
    fs.release(fh)
    e = fs.client.lookup("/w/d1/big.bin")
    out.append(("manifest", sum(1 for c in e.chunks if c.is_chunk_manifest), len(e.chunks)))
    check("/w/d1/big.bin")
    fh = fs.open("/w/d1/big.bin")
    write(fh, "/w/d1/big.bin", 5 * CHUNK - 7, b"patched across a chunk edge")
    fs.release(fh)
    check("/w/d1/big.bin")
    # truncation: mid-file is refused, to 0 clears, then a rewrite
    out.append(("truncate-mid", _errno(fs.truncate, "/w/d1/big.bin", 1000)))
    fs.truncate("/w/d1/big.bin", 0)
    model["/w/d1/big.bin"] = bytearray()
    check("/w/d1/big.bin")
    fh = fs.open("/w/d1/big.bin")
    write(fh, "/w/d1/big.bin", 10, b"regrown")
    fs.release(fh)
    check("/w/d1/big.bin")
    # rename across directories, over an existing file
    fh = fs.create("/w/d2/victim.bin")
    write(fh, "/w/d2/victim.bin", 0, rng.bytes(3000))
    fs.release(fh)
    fs.rename("/w/d1/rand.bin", "/w/d2/victim.bin")
    model["/w/d2/victim.bin"] = model.pop("/w/d1/rand.bin")
    check("/w/d2/victim.bin")
    out.append(("readdir", fs.readdir("/w/d1"), fs.readdir("/w/d2"), fs.readdir("/w")))
    out.append(("ENOENT", _errno(fs.open, "/w/d1/rand.bin"),
                _errno(fs.getattr, "/w/none"), _errno(fs.unlink, "/w/none")))
    out.append(("ENOTEMPTY", _errno(fs.rmdir, "/w/d2")))
    out.append(("EISDIR", _errno(fs.open, "/w/d2"), _errno(fs.unlink, "/w/d2"),
                _errno(fs.create, "/w/d1")))
    out.append(("ENOTDIR", _errno(fs.readdir, "/w/d2/victim.bin"),
                _errno(fs.rmdir, "/w/d2/victim.bin")))
    out.append(("EBADF", _errno(fs.read, 10**6, 0, 1)))
    fs.unlink("/w/d2/victim.bin")
    fs.unlink("/w/d1/big.bin")
    fs.rmdir("/w/d1")
    out.append(("after", fs.readdir("/w"), fs.statfs()))
    return out


def _weedfs(stack, **kw):
    mod = pkg(stack.name, "mount")
    return mod.WeedFS(stack.filer.grpc_address, stack.master.grpc_address,
                      chunk_size=CHUNK, manifest_batch=BATCH, **kw)


def test_weedfs_op_script_matches_jax(stacks):
    outs = {}
    for name, s in stacks.items():
        fs = _weedfs(s, cache_ttl=0.5)
        try:
            outs[name] = _script(fs, name)
        finally:
            fs.close()
    assert outs["port"] == outs["jax"]
    got = dict((o[0], o[1:]) for o in outs["port"] if isinstance(o[0], str))
    assert got["EEXIST"] == (errno.EEXIST,)
    assert got["ENOTEMPTY"] == (errno.ENOTEMPTY,)
    assert got["truncate-mid"] == (errno.ENOSYS,)
    assert got["ENOENT"] == (errno.ENOENT,) * 3
    assert got["manifest"][0] > 0


def test_invalidation_from_another_writer_matches_jax(stacks):
    outs = {}
    for name, s in stacks.items():
        entry_mod = pkg(name, "filer.entry")
        fs = _weedfs(s, cache_ttl=30.0)
        try:
            path = f"/inval-{name}/new.txt"
            first = fs.meta.lookup(path)  # a cached miss
            s.filer.filer.create_entry(entry_mod.Entry(
                path, attr=entry_mod.Attr.now(), content=b"from elsewhere"))
            wait(lambda: fs.meta.lookup(path) is not None, "the invalidation event", 10)
            fh = fs.open(f"/inval-{name}/new.txt")
            outs[name] = (first, fs.read(fh, 0, 50), fs.meta.invalidations > 0)
            fs.release(fh)
        finally:
            fs.close()
    assert outs["port"] == outs["jax"] == (None, b"from elsewhere", True)


def test_failed_flush_keeps_the_file_dirty_as_jax(stacks, monkeypatch):
    outs = {}
    for name, s in stacks.items():
        fe = pkg(name, "mount.filer_client").FilerError
        fs = _weedfs(s)
        try:
            fh = fs.create(f"/retry-{name}/f.txt")
            fs.write(fh, 0, b"precious")
            real = fs.client.update

            def boom(e, fe=fe):
                raise fe("filer down")

            monkeypatch.setattr(fs.client, "update", boom)
            code = _errno(fs.flush, fh)
            dirty = fs._of(fh).pages.dirty
            monkeypatch.setattr(fs.client, "update", real)
            fs.flush(fh)
            fs.release(fh)
            fh2 = fs.open(f"/retry-{name}/f.txt")
            outs[name] = (code, dirty, fs.read(fh2, 0, 20))
            fs.release(fh2)
        finally:
            fs.close()
    assert outs["port"] == outs["jax"] == (errno.EIO, True, b"precious")


# ---- the FUSE gate and cli mount ----------------------------------------

def test_fuse_refusal_matches_jax(stacks):
    outs = []
    for name in ("port", "jax"):
        fa = pkg(name, "mount.fuse_adapter")
        assert fa.fuse_available() is False
        fs = _weedfs(stacks[name], subscribe=False)
        try:
            with pytest.raises(RuntimeError) as ei:
                fa.mount(fs, "/nonexistent-mountpoint")
        finally:
            fs.close()
        outs.append(str(ei.value))
    assert outs[0] == outs[1]
    assert "kernel FUSE unavailable" in outs[0]


def test_cli_mount_refuses_without_fuse_as_jax(tmp_path):
    outs = []
    for name in ("port", "jax"):
        cli = pkg(name, "cli")
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = cli.main(["mount", "-dir", str(tmp_path / "m"), "-filer", "127.0.0.1:1",
                           "-master", "127.0.0.1:1"])
        outs.append((rc, buf.getvalue().replace("seaweedfs_tpu_torch", "seaweedfs_tpu")))
    assert outs[0] == outs[1]
    assert outs[0][0] == 1
    lines = outs[0][1].splitlines()
    assert len(lines) == 3 and lines[0].startswith("mount: no FUSE userspace found")
