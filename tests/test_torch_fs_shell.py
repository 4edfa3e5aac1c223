"""The port's fs.* shell commands, ``RemoteFiler`` and ``volume.fsck`` on
the CPU, held against the JAX package's, across the two packages.

- The port's shell and the JAX shell each drive the port's filer and the
  JAX filer through the same fs.* script; all four transcripts are equal.
- ``RemoteFiler`` of each package over the other's filer server.
- ``fs.meta.save`` of one package loaded by the other's ``fs.meta.load``.
- ``fs.configure`` rules steer uploads on both filers.
- ``volume.fsck`` counts the same orphans in both packages (single-chunk
  files and needles no entry references), purges them with
  ``-reallyDeleteFromVolume -cutoffAgeSeconds 0``, and finds 0 after; and
  the port's two repairs: batch-assigned ``fid_N`` chunks and manifest
  chunks are referenced, where the JAX command counts them as orphans.

Every server binds port 0 and every wait polls."""

from __future__ import annotations

import io
import re
import shutil
import tempfile

import pytest

from seaweedfs_tpu.filer.remote import RemoteFiler as JaxRemoteFiler
from seaweedfs_tpu.filer.upload import save_blob as jax_save_blob
from seaweedfs_tpu.server import filer_server as jax_fs
from seaweedfs_tpu.server import master_server as jax_ms
from seaweedfs_tpu.server import volume_server as jax_vs
from seaweedfs_tpu.shell import run_command as jax_run_command
from seaweedfs_tpu.shell.command_env import CommandEnv as JaxCommandEnv
from seaweedfs_tpu.wdclient import MasterClient as JaxMasterClient
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.remote import RemoteFiler
from seaweedfs_tpu_torch.filer.upload import save_blob
from seaweedfs_tpu_torch.server import filer_server, master_server, volume_server
from seaweedfs_tpu_torch.shell import run_command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.wdclient import MasterClient

from test_torch_filer_server import CHUNK, _body, _Cluster, _env, _http


@pytest.fixture(scope="module")
def clusters():
    mp = _env()
    root = tempfile.mkdtemp(prefix="torch-fs-shell-")
    made = {}
    try:
        made["port"] = _Cluster(master_server, volume_server, filer_server, root, "port",
                                device="cpu")
        made["jax"] = _Cluster(jax_ms, jax_vs, jax_fs, root, "jax")
        yield made
    finally:
        for c in made.values():
            c.stop()
        mp.undo()
        shutil.rmtree(root, ignore_errors=True)


def _shell(pkg: str, c, filer_addr: str | None = None):
    """(env, run) of one package's shell against cluster ``c``'s master and
    ``filer_addr`` (default: its own filer)."""
    addr = c.filer.grpc_address if filer_addr is None else filer_addr
    if pkg == "port":
        env, runner = CommandEnv(c.master.grpc_address, filer_grpc_address=addr), run_command
    else:
        env, runner = JaxCommandEnv(c.master.grpc_address, filer_grpc_address=addr), \
            jax_run_command

    def run(line: str) -> str:
        out = io.StringIO()
        try:
            runner(env, line, out)
        except Exception as e:  # noqa: BLE001 — the error text is part of the transcript
            out.write(f"error {type(e).__name__}: {e}\n")
        return out.getvalue()

    return env, run


def _fs_script(run, root: str) -> list[str]:
    return [
        run(f"fs.mkdir {root}"),
        run(f"fs.cd {root}"),
        run("fs.pwd"),
        run("fs.mkdir sub"),
        run("fs.ls"),
        run(f"fs.tree {root}"),
        run(f"fs.du {root}"),
        run(f"fs.cat {root}/a.txt"),
        run(f"fs.cat {root}/big.bin").__len__().__str__(),
        run(f"fs.meta.cat {root}/a.txt").replace("\n", " ").split("attributes")[0],
        run(f"fs.mv {root}/a.txt {root}/sub"),
        run(f"fs.ls {root}/sub"),
        run(f"fs.mv {root}/sub/a.txt {root}/renamed.txt"),
        run(f"fs.verify -verifyData {root}"),
        run(f"fs.rm {root}/sub"),
        run(f"fs.rm -r {root}/sub {root}/renamed.txt"),
        run(f"fs.rm {root}/missing"),
        run(f"fs.rm -f {root}/missing"),
        run(f"fs.ls {root}"),
        run("fs.cd /nope"),
        run("fs.configure -locationPrefix /cfg/ -collection cc -replication 000"),
        run("fs.configure -locationPrefix relative"),
        run(f"fs.du {root}"),
    ]


@pytest.mark.parametrize("shell_pkg", ["port", "jax"])
def test_fs_commands_drive_both_filers_alike(clusters, shell_pkg):
    transcripts = {}
    for name, c in clusters.items():
        root = f"/fs-{shell_pkg}"
        _http(c.filer.url, "POST", f"{root}/a.txt", b"hello from the filer\n")
        _http(c.filer.url, "POST", f"{root}/big.bin", _body(5, 5 * CHUNK + 9))
        _env_, run = _shell(shell_pkg, c)
        transcripts[name] = _fs_script(run, root)
    assert transcripts["port"] == transcripts["jax"]
    t = transcripts["port"]
    assert "verified 1 files, 0 broken" in t[13] and "is a directory (use -r)" in t[14]


@pytest.mark.parametrize("filer_pkg", ["port", "jax"])
def test_each_shell_drives_the_other_packages_filer(clusters, filer_pkg):
    """The JAX shell against the port's filer and the port's shell against
    the JAX filer answer as each does against its own."""
    c = clusters[filer_pkg]
    other = "jax" if filer_pkg == "port" else "port"
    root = f"/x-{other}"
    _http(c.filer.url, "POST", f"{root}/a.txt", b"hello from the filer\n")
    _http(c.filer.url, "POST", f"{root}/big.bin", _body(5, 5 * CHUNK + 9))
    got = _fs_script(_shell(other, c)[1], root)
    root2 = f"/x-{other}-own"
    _http(c.filer.url, "POST", f"{root2}/a.txt", b"hello from the filer\n")
    _http(c.filer.url, "POST", f"{root2}/big.bin", _body(5, 5 * CHUNK + 9))
    want = _fs_script(_shell(filer_pkg, c)[1], root2)
    assert [s.replace(root2, root) for s in want] == got


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_remote_filer_over_the_other_package(clusters, direction):
    if direction == "port->jax":
        c, rf, emod = clusters["jax"], RemoteFiler, Entry
        mc = MasterClient(clusters["jax"].master.grpc_address)
    else:
        from seaweedfs_tpu.filer.entry import Entry as emod  # noqa: N813

        c, rf = clusters["port"], JaxRemoteFiler
        mc = JaxMasterClient(clusters["port"].master.grpc_address)
    r = rf(c.filer.grpc_address, mc)
    root = "/rf-" + direction.split("->")[0]
    r.mkdirs(root + "/d")
    r.create_entry(emod(root + "/d/f", content=b"inline"))
    assert r.find_entry(root + "/d/f").content == b"inline"
    assert [e.name for e in r.list_entries(root + "/d")] == ["f"]
    r.rename(root + "/d/f", root + "/g")
    assert r.find_entry(root + "/d/f") is None and r.find_entry(root + "/g").content == b"inline"
    with pytest.raises(RuntimeError, match="non-empty"):
        r.delete_entry(root)
    r.delete_entry(root, recursive=True)
    assert r.find_entry(root + "/g") is None


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_meta_save_of_one_package_loads_in_the_other(clusters, saver, tmp_path):
    src, dst = clusters[saver], clusters["jax" if saver == "port" else "port"]
    root = f"/meta-{saver}"
    for i in range(5):
        _http(src.filer.url, "POST", f"{root}/d{i % 2}/f{i}", _body(i, 700 * i))
    saved = tmp_path / "meta.jsonl"
    out = _shell(saver, src)[1](f"fs.meta.save -o {saved} {root}")
    assert re.search(rf"saved 7 entries from {root} to ", out)
    loader = "jax" if saver == "port" else "port"
    assert "loaded 7 entries" in _shell(loader, dst)[1](f"fs.meta.load {saved}")
    for i in range(5):
        path = f"{root}/d{i % 2}/f{i}"
        assert dst.filer.filer.find_entry(path).encode() == src.filer.filer.find_entry(path).encode()
    assert _http(dst.filer.url, "GET", f"{root}/d0/f2")[0] == 200  # the chunks live on src's volumes


def test_fs_configure_steers_uploads_on_both_filers(clusters):
    for name, c in clusters.items():
        out = _shell("port", c)[1](
            "fs.configure -locationPrefix /data/ -collection filerdata -replication 000 -apply")
        assert "applied" in out and '"collection": "filerdata"' in out
        c.filer.conf.invalidate()
        _http(c.filer.url, "POST", "/data/x.bin", _body(1, 3 * CHUNK))
        e = c.filer.filer.find_entry("/data/x.bin")
        assert e.attr.collection == "filerdata", name
        vid = int(e.chunks[0].fid.split(",")[0])
        held = [vs.store.find_volume(vid) for vs in c.servers]
        assert {v.collection for v in held if v is not None} == {"filerdata"}
        out = _shell("jax", c)[1]("fs.configure -locationPrefix /data/ -isDelete -apply")
        assert "applied" in out
        c.filer.conf.invalidate()


def _fsck_world(c, pkg: str, n_files: int, n_orphans: int, tag: str) -> list[str]:
    """Single-chunk files (the filer's FidPool off: one base fid each) and
    ``n_orphans`` needles written straight to the volumes."""
    c.filer.fid_pool = None
    mc = (MasterClient if pkg == "port" else JaxMasterClient)(c.master.grpc_address)
    for i in range(n_files):
        assert _http(c.filer.url, "POST", f"/fsck-{tag}/f{i}?collection=fsck{tag}",
                     _body(i, 2100 + 10 * i))[0] == 201
    return [(save_blob if pkg == "port" else jax_save_blob)(mc, _body(900 + i, 500 + i),
                                                          collection="fsck" + tag)
            for i in range(n_orphans)]


def _fsck_counts(text: str) -> tuple:
    m = re.search(r"checked (\d+) needles: (found|purged) (\d+) orphans \((\d+)B\)", text)
    assert m, text
    return int(m[1]), m[2], int(m[3]), int(m[4])


def test_volume_fsck_counts_the_same_orphans(tmp_path):
    """On fresh clusters, where no chunk was batch-assigned (the JAX
    command's fid_N fault cannot show)."""
    got = {}
    mp = _env()
    fresh = {"port": _Cluster(master_server, volume_server, filer_server, str(tmp_path), "port",
                              device="cpu"),
             "jax": _Cluster(jax_ms, jax_vs, jax_fs, str(tmp_path), "jax")}
    try:
        for name, c in fresh.items():
            got[name] = _fsck_round(name, c)
    finally:
        for c in fresh.values():
            c.stop()
        mp.undo()
    assert got["port"] == got["jax"] == (("found", 5), ("purged", 0), ("purged", 5),
                                         ("found", 0))


def _fsck_round(name: str, c) -> tuple:
    """One package's fsck round on its own cluster: find, refuse to purge
    fresh volumes, purge, find none."""
    fids = _fsck_world(c, name, 12, 5, "a")
    env, run = _shell(name, c)
    run("lock")
    try:
        first = _fsck_counts(run("volume.fsck"))
        listed = sorted(re.findall(r"orphan needle (\d+,[0-9a-f]+)", run("volume.fsck")))
        refused = _fsck_counts(run("volume.fsck -reallyDeleteFromVolume"))
        purged = _fsck_counts(run("volume.fsck -reallyDeleteFromVolume -cutoffAgeSeconds 0"))
        after = _fsck_counts(run("volume.fsck"))
    finally:
        env.release_lock()
    want = sorted(f"{f.split(',')[0]},{int(f.split(',')[1][:-8], 16):x}" for f in fids)
    assert listed == want
    for fid in fids:
        vid = int(fid.split(",")[0])
        holders = [vs for vs in c.servers if vs.store.find_volume(vid) is not None]
        assert {_http(vs.url, "GET", f"/{fid}")[0] for vs in holders} == {404}
    for i in range(12):
        assert _http(c.filer.url, "GET", f"/fsck-a/f{i}")[1] == _body(i, 2100 + 10 * i)
    return first[1:3], refused[1:3], purged[1:3], after[1:3]


def test_volume_fsck_references_fid_n_and_manifest_chunks(clusters):
    """Batch-assigned (``fid_N``) and manifest chunks are referenced: the
    port's fsck finds no orphan where the JAX command finds some."""
    counts = {}
    for name, c in clusters.items():
        c.filer.stop()
        c.start_filer()  # a fresh FidPool: fid_N chunks
        for i in range(3):  # 3 x 10 chunks over MANIFEST_BATCH 4: manifests
            assert _http(c.filer.url, "POST", f"/fsckb/f{i}?collection=fsckb",
                         _body(40 + i, 10 * CHUNK))[0] == 201
        entry = c.filer.filer.find_entry("/fsckb/f0")
        assert any(ch.is_chunk_manifest for ch in entry.chunks)
        for pkg in ("port", "jax"):
            env, run = _shell(pkg, c)
            run("lock")
            try:
                counts[(name, pkg)] = _fsck_counts(run("volume.fsck"))[2]
            finally:
                env.release_lock()
        run("fs.rm -r /fsckb")
    assert counts[("port", "port")] == counts[("jax", "port")] == 0
    assert counts[("port", "jax")] > 0 and counts[("jax", "jax")] > 0


def test_fs_log_lists_recent_events(clusters):
    c = clusters["port"]
    _http(c.filer.url, "POST", "/logged/one.txt", b"1")
    _http(c.filer.url, "DELETE", "/logged/one.txt")
    out = _shell("port", c)[1]("fs.log -sinceSeconds 60 /logged")
    assert re.search(r"create  /logged/one.txt", out) and re.search(r"delete  /logged/one.txt", out)
    assert out.rstrip().endswith("events")


def test_shell_without_a_filer_says_so(clusters):
    c = clusters["port"]
    run = _shell("port", c, filer_addr="")[1]
    assert "no filer configured" in run("fs.ls /")
    # a comma list is the shard router, as in the JAX shell: a path whose
    # shard is down says so, in the same words from both packages
    got = {pkg: _shell(pkg, c, filer_addr="127.0.0.1:1,127.0.0.1:2")[1]("fs.ls /buckets/b")
           for pkg in ("port", "jax")}
    assert "error ShardUnavailable: filer shard 127.0.0.1:" in got["port"], got
    assert got["port"] == got["jax"]
