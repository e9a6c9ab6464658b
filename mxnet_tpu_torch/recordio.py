"""RecordIO: the reference's binary record container.

The counterpart of ``mxnet_tpu/recordio.py``, writing and reading the same
bytes on disk, so a ``.rec``/``.idx`` pair written by either package (or by
the reference's im2rec) reads in the other.

Format per record: ``[uint32 magic][uint32 lrecord][data][padding to 4B]``,
where lrecord holds the continuation flag (upper 3 bits) and the length
(lower 29 bits).  A payload holding the magic word at a 4-aligned offset is
split there into continuation parts (flags 1, 2, 3), as dmlc-core's writer
does.  The JAX package's fault-injection seam and telemetry counters are
not ported; the reader's durable ``state``/``restore`` belong with
resilience (ROADMAP Queue A item 7).
"""
from __future__ import annotations

import logging
import os
import struct
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_MAGIC_BYTES = struct.pack("<I", _MAGIC)
_LENGTH_MASK = (1 << 29) - 1


class MXRecordIO:
    """Sequential record reader/writer (reference MXRecordIO).

    ``skip_bad_records`` (default ``MXNET_TPU_BAD_RECORD_QUOTA``, 0) arms
    tolerant reads: a corrupt or truncated record is skipped by scanning
    forward to the next 4-aligned magic word instead of raising ``IOError``,
    up to that many records per reader, counted on ``bad_records``,
    ``skipped_bytes`` and ``resyncs``; one more raises ``IOError`` naming
    the file.  0 is strict (the reference's behaviour)."""

    def __init__(self, uri, flag, skip_bad_records=None):
        self.uri = uri
        self.flag = flag
        self.fid = None
        self.is_open = False
        if skip_bad_records is None:
            from . import config
            skip_bad_records = config.get_int("MXNET_TPU_BAD_RECORD_QUOTA")
        self._bad_quota = int(skip_bad_records)
        self.bad_records = 0
        self.skipped_bytes = 0
        self.resyncs = 0
        self.records_read = 0
        self.open()

    def open(self):
        if self.flag == "w":
            self.fid = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fid = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if self.is_open:
            self.fid.close()
            self.is_open = False

    def __del__(self):
        # only the errors a half-constructed or closed reader can raise
        try:
            self.close()
        except (OSError, ValueError, AttributeError):
            pass

    def reset(self):
        self.close()
        self.open()
        self.records_read = 0

    def tell(self):
        return self.fid.tell()

    def seek(self, pos):
        if self.writable:
            raise ValueError("seek on a writable MXRecordIO")
        self.fid.seek(pos)

    def _write_part(self, part, cflag):
        lrec = (len(part) & _LENGTH_MASK) | (cflag << 29)
        self.fid.write(struct.pack("<II", _MAGIC, lrec))
        self.fid.write(part)
        pad = (4 - (len(part) % 4)) % 4
        if pad:
            self.fid.write(b"\x00" * pad)

    def write(self, buf):
        """Write one framed record, split at 4-aligned occurrences of the
        magic word (dropped here, put back by the reader) into parts with
        continuation flags 1, 2, 3: dmlc recordio's framing, which keeps a
        payload holding the magic (JPEG bytes can) seekable."""
        if not self.writable:
            raise ValueError("write on a read-only MXRecordIO")
        parts = []
        start = 0
        pos = buf.find(_MAGIC_BYTES)
        while pos != -1:
            if pos % 4 == 0:
                parts.append(buf[start:pos])
                start = pos + 4
                pos = buf.find(_MAGIC_BYTES, start)
            else:
                pos = buf.find(_MAGIC_BYTES, pos + 1)
        parts.append(buf[start:])
        if len(parts) == 1:
            self._write_part(buf, 0)
            return
        for i, part in enumerate(parts):
            cflag = 1 if i == 0 else (3 if i == len(parts) - 1 else 2)
            self._write_part(part, cflag)

    def _read_part(self):
        header = self.fid.read(8)
        if len(header) < 8:
            return None, None
        magic, lrec = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise IOError("Invalid magic number in %s" % self.uri)
        length = lrec & _LENGTH_MASK
        buf = self.fid.read(length)
        if len(buf) < length:
            raise IOError("truncated record in %s: header claims %d "
                          "bytes, file has %d"
                          % (self.uri, length, len(buf)))
        pad = (4 - (length % 4)) % 4
        if pad:
            self.fid.read(pad)
        return lrec >> 29, buf

    def _read_record(self):
        """One framed record, or None at EOF, its continuation parts joined
        with the magic word put back.  Corruption raises IOError."""
        cflag, buf = self._read_part()
        if buf is None:
            return None
        if cflag == 0:
            return buf
        if cflag != 1:
            raise IOError("continuation part without start in %s" % self.uri)
        parts = [buf]
        while True:
            cflag, part = self._read_part()
            if part is None or cflag not in (2, 3):
                raise IOError("truncated continuation record in %s"
                              % self.uri)
            parts.append(_MAGIC_BYTES)
            parts.append(part)
            if cflag == 3:
                return b"".join(parts)

    def _note_bad_record(self, exc):
        """Count one corrupt record against the quota: re-raises without a
        quota, raises IOError once the quota is spent."""
        if self._bad_quota <= 0:
            raise exc
        self.bad_records += 1
        if self.bad_records > self._bad_quota:
            raise IOError(
                "%s: bad-record quota exhausted (%d corrupt/truncated "
                "records > quota %d); last error: %s"
                % (self.uri, self.bad_records, self._bad_quota,
                   exc)) from exc
        logging.warning("%s: skipping corrupt record (%d/%d under quota): "
                        "%s", self.uri, self.bad_records, self._bad_quota,
                        exc)

    def _resync(self):
        """Scan forward to the next 4-aligned magic word (every record
        boundary is one); False at EOF.  Skipped bytes are counted on
        ``skipped_bytes``."""
        start = self.fid.tell()
        start += (-start) % 4
        self.fid.seek(start)
        base, tail = start, b""
        while True:
            chunk = self.fid.read(1 << 16)
            if not chunk:
                self.skipped_bytes += base + len(tail) - start
                return False
            buf = tail + chunk
            i = buf.find(_MAGIC_BYTES)
            while i != -1:
                off = base + i
                if off % 4 == 0 and off >= start:
                    self.fid.seek(off)
                    self.resyncs += 1
                    self.skipped_bytes += off - start
                    return True
                i = buf.find(_MAGIC_BYTES, i + 1)
            keep = min(3, len(buf))
            base += len(buf) - keep
            tail = buf[len(buf) - keep:]

    def read(self):
        """The next record, or None at EOF.  Under a bad-record quota a
        corrupt record is skipped and counted instead of raising."""
        if self.writable:
            raise ValueError("read on a writable MXRecordIO")
        while True:
            # a corrupt length can drag the position to EOF, so a resync
            # restarts just past this record's magic
            start = self.fid.tell()
            try:
                rec = self._read_record()
                if rec is not None:
                    self.records_read += 1
                return rec
            except (IOError, OSError, struct.error, ValueError) as e:
                self._note_bad_record(e)
                self.fid.seek(start + 4)
                if not self._resync():
                    return None


class MXIndexedRecordIO(MXRecordIO):
    """Random-access reader/writer with a ``.idx`` sidecar of ``key\\toffset``
    lines (reference MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for lineno, raw in enumerate(fin, 1):
                    try:
                        line = raw.strip().split("\t")
                        key = self.key_type(line[0])
                        self.idx[key] = int(line[1])
                    except (ValueError, IndexError) as e:
                        raise IOError(
                            "corrupt index %s:%d (%r): %s"
                            % (self.idx_path, lineno, raw.strip(), e)) \
                            from e
                    self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


# header of an image record (reference recordio.py IRHeader)
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """An IRHeader and a payload as one record string (reference
    recordio.pack); a label array goes after the header, its length in
    ``flag``."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        header = header._replace(label=float(header.label))
        packed = struct.pack(_IR_FORMAT, 0, header.label, header.id,
                             header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        packed = struct.pack(_IR_FORMAT, header.flag, header.label,
                             header.id, header.id2) + label.tobytes()
    return packed + s


def unpack(s):
    """A record as ``(IRHeader, payload)``; a truncated or malformed header
    raises ``ValueError``."""
    try:
        header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
        s = s[_IR_SIZE:]
        if header.flag > 0:
            label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
            header = header._replace(label=label)
            s = s[header.flag * 4:]
    except (struct.error, ValueError) as e:
        raise ValueError("invalid IRHeader in %d-byte record: %s"
                         % (len(s), e)) from e
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """An image array encoded (PIL, JPEG or PNG) and packed with its header
    (reference recordio.pack_img, which encodes with OpenCV)."""
    import io as _pyio
    from PIL import Image
    im = Image.fromarray(img.astype(np.uint8))
    buf = _pyio.BytesIO()
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    kwargs = {"quality": quality} if fmt == "JPEG" else {}
    im.save(buf, format=fmt, **kwargs)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1):
    """A record as ``(IRHeader, image array)``, decoded by PIL: ``iscolor``
    1 gives RGB, 0 grayscale, -1 the image as stored."""
    import io as _pyio
    from PIL import Image
    header, img_bytes = unpack(s)
    im = Image.open(_pyio.BytesIO(img_bytes))
    if iscolor == 0:
        im = im.convert("L")
    elif iscolor == 1:
        im = im.convert("RGB")
    return header, np.asarray(im)
