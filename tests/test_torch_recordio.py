"""The port's RecordIO against the JAX package's: records written by either
read back in the other, byte for byte (plain, indexed, continuation
records whose payload holds the magic word, multi-label headers), the same
file bytes from the same writes, ``pack``/``unpack`` and
``pack_img``/``unpack_img``, and the tolerant reader's skips of corrupt
records."""
import os
import struct
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mxnet_tpu import recordio as jrec  # noqa: E402

from mxnet_tpu_torch import recordio as prec  # noqa: E402

MAGIC = struct.pack("<I", 0xced7230a)
PACKAGES = {"port": prec, "jax": jrec}


def _payloads(seed=0):
    """Payloads of every length mod 4, empty ones, and payloads holding the
    magic word at 4-aligned offsets (split into continuation parts) and at
    unaligned ones (not split)."""
    rng = np.random.RandomState(seed)
    out = [b"", b"a", b"ab", b"abc", b"abcd"]
    out += [rng.bytes(int(n)) for n in rng.randint(1, 200, 12)]
    out.append(b"xxxx" + MAGIC + b"yy")              # one split
    out.append(MAGIC + b"abcd" + MAGIC + MAGIC)      # start, middle, end
    out.append(b"x" + MAGIC + b"zzz")                # unaligned: whole
    out.append(rng.bytes(64) + MAGIC + rng.bytes(7) + MAGIC + rng.bytes(3))
    return out


def _write(pkg, path, payloads):
    w = pkg.MXRecordIO(str(path), "w")
    for p in payloads:
        w.write(p)
    w.close()


def _read_all(pkg, path, **kw):
    r = pkg.MXRecordIO(str(path), "r", **kw)
    out = []
    while True:
        rec = r.read()
        if rec is None:
            break
        out.append(rec)
    r.close()
    return out


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_sequential_records_cross_read(tmp_path, writer):
    payloads = _payloads()
    path = tmp_path / "a.rec"
    _write(PACKAGES[writer], path, payloads)
    for reader in PACKAGES.values():
        assert _read_all(reader, path) == payloads


def test_same_writes_give_the_same_bytes(tmp_path):
    payloads = _payloads(seed=1)
    for name, pkg in PACKAGES.items():
        _write(pkg, tmp_path / (name + ".rec"), payloads)
    assert (tmp_path / "port.rec").read_bytes() == \
        (tmp_path / "jax.rec").read_bytes()


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_indexed_records_cross_read(tmp_path, writer):
    payloads = _payloads(seed=2)
    keys = list(range(100, 100 + len(payloads)))
    pkg = PACKAGES[writer]
    w = pkg.MXIndexedRecordIO(str(tmp_path / "a.idx"),
                              str(tmp_path / "a.rec"), "w")
    for k, p in zip(keys, payloads):
        w.write_idx(k, p)
    w.close()
    for reader in PACKAGES.values():
        r = reader.MXIndexedRecordIO(str(tmp_path / "a.idx"),
                                     str(tmp_path / "a.rec"), "r")
        assert r.keys == keys
        for k, p in reversed(list(zip(keys, payloads))):
            assert r.read_idx(k) == p
        r.close()
    other = "jax" if writer == "port" else "port"
    w = PACKAGES[other].MXIndexedRecordIO(str(tmp_path / "b.idx"),
                                          str(tmp_path / "b.rec"), "w")
    for k, p in zip(keys, payloads):
        w.write_idx(k, p)
    w.close()
    for ext in ("rec", "idx"):
        assert (tmp_path / ("a." + ext)).read_bytes() == \
            (tmp_path / ("b." + ext)).read_bytes()


@pytest.mark.parametrize("label", [3.0, 7, [1.0, 2.5, -3.0],
                                   np.arange(5, dtype=np.float32)])
def test_pack_and_unpack_match(label):
    header = (0, label, 11, 12)
    packed = prec.pack(header, b"payload")
    assert packed == jrec.pack(header, b"payload")
    for pkg in PACKAGES.values():
        h, s = pkg.unpack(packed)
        assert s == b"payload" and (h.id, h.id2) == (11, 12)
        np.testing.assert_array_equal(np.asarray(h.label, np.float32),
                                      np.asarray(label, np.float32))
        assert h.flag == (0 if np.isscalar(label) else len(label))


def test_multilabel_records_cross_read(tmp_path):
    rng = np.random.RandomState(3)
    recs = [prec.pack(prec.IRHeader(0, rng.rand(int(k)).astype(np.float32),
                                    i, 0), rng.bytes(int(n)))
            for i, (k, n) in enumerate(zip(rng.randint(1, 6, 8),
                                           rng.randint(0, 40, 8)))]
    _write(jrec, tmp_path / "m.rec", recs)
    for got, want in zip(_read_all(prec, tmp_path / "m.rec"), recs):
        hp, sp = prec.unpack(got)
        hj, sj = jrec.unpack(want)
        np.testing.assert_array_equal(hp.label, hj.label)
        assert sp == sj and hp.flag == hj.flag


def test_unpack_rejects_a_truncated_header():
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError):
            pkg.unpack(b"short")


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_and_unpack_img_match(fmt):
    img = np.random.RandomState(4).randint(0, 255, (20, 24, 3),
                                           dtype=np.uint8)
    header = prec.IRHeader(0, 2.0, 5, 0)
    packed = prec.pack_img(header, img, quality=90, img_fmt=fmt)
    assert packed == jrec.pack_img(header, img, quality=90, img_fmt=fmt)
    for iscolor in (-1, 0, 1):
        hp, ip = prec.unpack_img(packed, iscolor)
        hj, ij = jrec.unpack_img(packed, iscolor)
        np.testing.assert_array_equal(ip, ij)
        assert hp == hj
    if fmt == ".png":
        np.testing.assert_array_equal(prec.unpack_img(packed, 1)[1], img)


def _corrupt_file(tmp_path, which):
    """Ten records of 12 bytes with record 4 damaged: its magic overwritten
    (``magic``) or its length field pointing past the end (``length``)."""
    path = tmp_path / ("c_%s.rec" % which)
    payloads = [bytes([i]) * 12 for i in range(10)]
    _write(prec, path, payloads)
    data = bytearray(path.read_bytes())
    off = 4 * 20                 # 8 header + 12 payload bytes a record
    if which == "magic":
        data[off:off + 4] = b"\x00\x01\x02\x03"
    else:
        data[off + 4:off + 8] = struct.pack("<I", 1 << 20)
    path.write_bytes(bytes(data))
    return path, payloads


@pytest.mark.parametrize("which", ["magic", "length"])
def test_corrupt_record_strict_and_skipped(tmp_path, which):
    path, payloads = _corrupt_file(tmp_path, which)
    for pkg in PACKAGES.values():
        with pytest.raises(IOError):
            _read_all(pkg, path, skip_bad_records=0)
    got = {}
    for name, pkg in PACKAGES.items():
        r = pkg.MXRecordIO(str(path), "r", skip_bad_records=2)
        recs = []
        while True:
            rec = r.read()
            if rec is None:
                break
            recs.append(rec)
        got[name] = (recs, r.bad_records, r.resyncs, r.skipped_bytes)
        r.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == payloads[:4] + payloads[5:]
    assert got["port"][1] == 1


def test_bad_record_quota_is_exhausted(tmp_path):
    path, _ = _corrupt_file(tmp_path, "magic")
    data = bytearray(path.read_bytes())
    data[6 * 20:6 * 20 + 4] = b"\x00\x00\x00\x00"
    path.write_bytes(bytes(data))
    for pkg in PACKAGES.values():
        with pytest.raises(IOError, match="quota"):
            _read_all(pkg, path, skip_bad_records=1)


def test_quota_default_comes_from_the_environment(tmp_path, monkeypatch):
    path, payloads = _corrupt_file(tmp_path, "magic")
    monkeypatch.setenv("MXNET_TPU_BAD_RECORD_QUOTA", "3")
    assert _read_all(prec, path) == payloads[:4] + payloads[5:]
    monkeypatch.delenv("MXNET_TPU_BAD_RECORD_QUOTA")
    with pytest.raises(IOError):
        _read_all(prec, path)
