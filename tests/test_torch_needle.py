"""The port's CRC32C and needle record format against the JAX package's, on
the same seeded inputs: bytes and checksums must match exactly."""

from __future__ import annotations

import numpy as np
import pytest

from seaweedfs_tpu.native import crc32c as jax_crc32c
from seaweedfs_tpu.storage import needle as jax_needle
from seaweedfs_tpu.storage.types import Version as JaxVersion
from seaweedfs_tpu_torch.storage import needle
from seaweedfs_tpu_torch.storage.types import Version
from seaweedfs_tpu_torch.util import crc32c as port_crc

RNG_SEED = 20261017


def _buffers():
    rng = np.random.default_rng(RNG_SEED)
    return {
        "empty": b"",
        "one": b"\x9c",
        "seven": rng.bytes(7),
        "unaligned": rng.bytes(1031)[3:],
        "one_mib": rng.bytes(1 << 20),
    }


@pytest.mark.parametrize("name", list(_buffers()))
def test_crc32c_matches_jax(name):
    buf = _buffers()[name]
    want = jax_crc32c(buf)
    assert port_crc.crc32c(buf) == want
    assert port_crc.crc32c(memoryview(buf)) == want
    assert port_crc.crc32c(bytearray(buf)) == want


@pytest.mark.parametrize("name", ["seven", "unaligned", "one_mib"])
def test_crc32c_incremental_matches_jax(name):
    buf = _buffers()[name]
    for cut in (0, 1, len(buf) // 3, len(buf) - 1, len(buf)):
        head = port_crc.crc32c(buf[:cut])
        assert head == jax_crc32c(buf[:cut])
        assert port_crc.crc32c(buf[cut:], head) == jax_crc32c(buf[cut:], jax_crc32c(buf[:cut]))
        assert port_crc.crc32c(buf[cut:], head) == port_crc.crc32c(buf)


def test_crc32c_known_value():
    # the standard CRC-32C check value
    assert port_crc.crc32c(b"123456789") == 0xE3069283


def test_crc32c_rows_match_jax():
    rng = np.random.default_rng(RNG_SEED + 1)
    big = rng.integers(0, 256, (64, 1100), dtype=np.uint8)
    rows = big[:, 5:1029]  # strided, unaligned rows
    got = port_crc.crc32c_rows(rows)
    assert got.dtype == np.uint32
    assert [int(c) for c in got] == [jax_crc32c(r.tobytes()) for r in rows]
    assert port_crc.crc32c_rows(rows[:0]).shape == (0,)
    with pytest.raises(ValueError):
        port_crc.crc32c_rows(big[:, ::2])


def _fields(rng, with_name, with_mime, with_ttl, with_pairs):
    data = rng.bytes(int(rng.integers(1, 3000)))
    kw = dict(id=int(rng.integers(1, 1 << 62)), cookie=int(rng.integers(0, 1 << 32)), data=data,
              append_at_ns=int(rng.integers(0, 1 << 62)))
    flags = 0
    if with_name:
        kw["name"] = rng.bytes(int(rng.integers(1, 255)))
        flags |= needle.FLAG_HAS_NAME
    if with_mime:
        kw["mime"] = b"application/octet-stream"
        flags |= needle.FLAG_HAS_MIME
    kw["last_modified"] = int(rng.integers(0, 1 << 39))
    flags |= needle.FLAG_HAS_LAST_MODIFIED
    if with_ttl:
        kw["ttl"] = b"\x05\x03"
        flags |= needle.FLAG_HAS_TTL
    if with_pairs:
        kw["pairs"] = b'{"k":"' + rng.bytes(40).hex().encode() + b'"}'
        flags |= needle.FLAG_HAS_PAIRS
    kw["flags"] = flags
    return kw


CASES = [(v, n, m, t, p) for v in (1, 2, 3) for n in (False, True) for m in (False, True)
         for t, p in ((False, False), (True, True))]


@pytest.mark.parametrize("version,with_name,with_mime,with_ttl,with_pairs", CASES)
def test_needle_round_trip_matches_jax(version, with_name, with_mime, with_ttl, with_pairs):
    rng = np.random.default_rng([RNG_SEED, version, with_name, with_mime, with_ttl])
    kw = _fields(rng, with_name, with_mime, with_ttl, with_pairs)
    port = needle.Needle(**kw)
    ref = jax_needle.Needle(**kw)
    buf = port.to_bytes(Version(version))
    assert buf == ref.to_bytes(JaxVersion(version))
    assert port.size == ref.size and port.checksum == ref.checksum
    assert port.disk_size(Version(version)) == ref.disk_size(JaxVersion(version))
    if version > 1:  # disk_size counts the v2+ body, as the JAX package's does
        assert len(buf) == port.disk_size(Version(version))
    got = needle.Needle.from_bytes(buf, Version(version))
    want = jax_needle.Needle.from_bytes(buf, JaxVersion(version))
    for f in ("id", "cookie", "data", "flags", "name", "mime", "pairs", "last_modified", "ttl",
              "checksum", "append_at_ns", "size"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.data == kw["data"]


def test_empty_needle_matches_jax():
    port, ref = needle.Needle(id=7, cookie=9), jax_needle.Needle(id=7, cookie=9)
    assert port.to_bytes() == ref.to_bytes()
    assert needle.Needle.from_bytes(port.to_bytes()).data == b""


@pytest.mark.parametrize("version", [2, 3])
def test_flipped_payload_byte_raises_crc_mismatch_in_both(version):
    rng = np.random.default_rng(RNG_SEED + version)
    kw = _fields(rng, True, True, False, False)
    buf = bytearray(needle.Needle(**kw).to_bytes(Version(version)))
    buf[16 + 4 + 10] ^= 0x40  # a payload byte
    with pytest.raises(needle.CrcMismatch):
        needle.Needle.from_bytes(bytes(buf), Version(version))
    with pytest.raises(jax_needle.CrcMismatch):
        jax_needle.Needle.from_bytes(bytes(buf), JaxVersion(version))
    assert issubclass(needle.CrcMismatch, needle.NeedleError)
    assert issubclass(needle.CookieMismatch, needle.NeedleError)
    # verify_crc=False parses it anyway, as the JAX package does
    assert needle.Needle.from_bytes(bytes(buf), Version(version), verify_crc=False).data == \
        jax_needle.Needle.from_bytes(bytes(buf), JaxVersion(version), verify_crc=False).data


def test_new_needle_and_body_length_match_jax():
    port = needle.new_needle(0x1234, 0xBEEF, b"hello world", name=b"a.txt", mime=b"text/plain",
                             last_modified=1_700_000_000)
    ref = jax_needle.new_needle(0x1234, 0xBEEF, b"hello world", name=b"a.txt",
                                mime=b"text/plain", last_modified=1_700_000_000)
    assert port.to_bytes() == ref.to_bytes()
    for v in (1, 2, 3):
        for size in (0, 1, 7, 1024, 1 << 20):
            assert needle.body_length(size, Version(v)) == jax_needle.body_length(size, JaxVersion(v))
