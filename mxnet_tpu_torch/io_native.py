"""The port's native input library: a threaded RecordIO reader and the JPEG
image record pipeline, over ctypes.

The counterpart of ``mxnet_tpu/io_native.py``.  The C++ sources are the
port's own, under ``csrc/host/`` (``recordio.cc``, ``image_pipeline.cc``,
``recordio_format.h``).  Nothing is built at import: the first call that
needs the library builds it with ``g++ -O2 -std=c++17 -fPIC -pthread`` into
``build/native/`` at the root of the checkout (git-ignored), named by a
hash of the sources and of the build line, written under a temporary name
and renamed into place, so processes that build at once never load a
partial file.

The JPEG decoder is chosen at the build:

* ``libjpeg`` where ``<jpeglib.h>`` compiles (``-DHAVE_JPEG -ljpeg``, the
  JAX package's ``src/Makefile`` gate): the reference's decoder, and the
  one whose batches equal the JAX package's to the bit;
* else ``nvjpeg`` where the CUDA toolkit has ``nvjpeg.h`` and
  ``libnvjpeg`` (``-DHAVE_NVJPEG``): each decode thread decodes on the
  card and copies the RGB image back; its pixels differ from libjpeg's by a
  few levels (nvJPEG's IDCT and chroma upsampling);
* else none: :func:`jpeg_available` is False, and ``ImageRecordIter``
  raises.

:func:`build_info` reports the compiler line, its time and the decoder.

Telemetry, at the JAX sites: ``mxtpu_io_records_total{source="native"}``
and the bad-record counter; the ioview ``read`` stage per record of the
reader; for the image pipeline the ``decode`` stage (the read and decode
behind one native call, ``n`` images) and the ``batch`` stage (the
batch's assembly on the host: the round-batch wrap and, for f32 batches,
the normalization and NCHW transpose; raw uint8 batches are accounted
too).  The build counts as a compile (``telemetry.compile``).
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from . import io_resume
from . import resilience
from . import telemetry
from .telemetry import ioview as _ioview

# per-record counters (the source label separates the native reader)
_NAT_READS = telemetry.counter(
    "mxtpu_io_records_total").labels(source="native")
_NAT_BAD = telemetry.counter(
    "mxtpu_io_bad_records_total").labels(source="native")

__all__ = ["available", "jpeg_available", "decoder", "build_info",
           "probe", "build_command", "NativeRecordIOReader", "ImageRecordIter"]

_PKG = Path(__file__).resolve().parent
SOURCE_DIR = _PKG / "csrc" / "host"
SOURCES = ("recordio.cc", "image_pipeline.cc")
HEADERS = ("recordio_format.h",)

_lock = threading.Lock()
_state = {"lib": None, "tried": False, "info": None}


def build_dir():
    """``build/native`` at the root of the checkout (git-ignored)."""
    return _PKG.parent / "build" / "native"


def _cuda_home():
    return Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")


def _has_jpeglib(cxx):
    """Whether ``<jpeglib.h>`` preprocesses (the JAX Makefile's gate)."""
    try:
        res = subprocess.run([cxx, "-E", "-x", "c++", "-"],
                             input="#include <jpeglib.h>\n", text=True,
                             capture_output=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return res.returncode == 0


def _has_nvjpeg():
    cuda = _cuda_home()
    return (cuda / "include" / "nvjpeg.h").exists() and any(
        (cuda / "lib64").glob("libnvjpeg.so*"))


def probe():
    """The JPEG decoders this host could build in: ``{"jpeglib": whether
    <jpeglib.h> compiles, "nvjpeg": whether the CUDA toolkit has nvjpeg.h
    and libnvjpeg}``."""
    cxx = shutil.which("g++") or "g++"
    return {"jpeglib": _has_jpeglib(cxx), "nvjpeg": _has_nvjpeg()}


def build_command(out, cxx=None):
    """``(decoder, argv)``: the compiler line that builds the library into
    ``out``, with the JPEG decoder this host offers."""
    cxx = cxx or shutil.which("g++") or "g++"
    argv = [cxx, "-O2", "-std=c++17", "-fPIC", "-pthread", "-shared"]
    srcs = [str(SOURCE_DIR / s) for s in SOURCES]
    if _has_jpeglib(cxx):
        return "libjpeg", argv + ["-DHAVE_JPEG", "-o", str(out)] + srcs \
            + ["-ljpeg"]
    if _has_nvjpeg():
        cuda = _cuda_home()
        lib = str(cuda / "lib64")
        return "nvjpeg", argv + [
            "-DHAVE_NVJPEG", "-I" + str(cuda / "include"), "-o", str(out)] \
            + srcs + ["-L" + lib, "-Wl,-rpath," + lib, "-lnvjpeg",
                      "-lcudart_static", "-ldl", "-lrt"]
    return "none", argv + ["-o", str(out)] + srcs


def _target(cxx):
    """``(decoder, argv, library path)``: the library named by a hash of
    the sources, the headers and the compiler line."""
    decoder_kind, argv = build_command("OUT", cxx)
    h = hashlib.sha256(" ".join(argv).encode())
    for name in SOURCES + HEADERS:
        h.update((SOURCE_DIR / name).read_bytes())
    out = build_dir() / ("libmxtt_io-%s.so" % h.hexdigest()[:12])
    return decoder_kind, [str(out) if a == "OUT" else a for a in argv], out


def _declare(lib):
    lib.MXTTRecordIOReaderCreate.restype = ctypes.c_void_p
    lib.MXTTRecordIOReaderCreate.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.MXTTRecordIOReaderFree.restype = None
    lib.MXTTRecordIOReaderFree.argtypes = [ctypes.c_void_p]
    lib.MXTTRecordIOReaderNext.restype = ctypes.c_int64
    lib.MXTTRecordIOReaderNext.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.MXTTRecordIOReadFloatBatch.restype = ctypes.c_int64
    lib.MXTTRecordIOReadFloatBatch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64]
    lib.MXTTImagePipelineHasJpeg.restype = ctypes.c_int
    lib.MXTTImagePipelineHasJpeg.argtypes = []
    lib.MXTTImagePipelineDecoder.restype = ctypes.c_char_p
    lib.MXTTImagePipelineDecoder.argtypes = []
    lib.MXTTImagePipelineCreate.restype = ctypes.c_void_p
    lib.MXTTImagePipelineCreate.argtypes = [ctypes.c_char_p] + \
        [ctypes.c_int64] * 10
    lib.MXTTImagePipelineFree.restype = None
    lib.MXTTImagePipelineFree.argtypes = [ctypes.c_void_p]
    lib.MXTTImagePipelineNextBatch.restype = ctypes.c_int64
    lib.MXTTImagePipelineNextBatch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    return lib


def _build_and_load():
    cxx = shutil.which("g++")
    if cxx is None:
        logging.warning("io_native: no g++, the native input library is "
                        "unavailable")
        return None, None
    decoder_kind, argv, out = _target(cxx)
    info = {"cmd": " ".join(argv), "decoder": decoder_kind,
            "path": str(out), "seconds": 0.0, "cached": out.exists()}
    if not out.exists():
        build_dir().mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
        argv = [str(tmp) if a == str(out) else a for a in argv]
        t0 = time.perf_counter()
        res = subprocess.run(argv, capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        if res.returncode != 0:
            logging.warning("io_native: the build failed (exit %d):\n%s\n%s",
                            res.returncode, " ".join(argv), res.stderr)
            info["error"] = res.stderr
            return None, info
        os.replace(tmp, out)     # atomic: a concurrent loader never sees
        telemetry.compile_events.record_build(info["seconds"], out.name)
    return _declare(ctypes.CDLL(str(out))), info   # a partial file


def _load():
    with _lock:
        if not _state["tried"]:
            _state["tried"] = True
            _state["lib"], _state["info"] = _build_and_load()
        return _state["lib"]


def available():
    """Whether the native library built and loaded."""
    return _load() is not None


def jpeg_available():
    """Whether the native library can decode JPEG (a decoder was built in,
    and for nvJPEG the card answered)."""
    lib = _load()
    return bool(lib and lib.MXTTImagePipelineHasJpeg())


def decoder():
    """``"libjpeg"``, ``"nvjpeg"`` or ``"none"``: the decoder built in
    (None when the library is unavailable)."""
    lib = _load()
    return lib.MXTTImagePipelineDecoder().decode() if lib else None


def build_info():
    """The build's compiler line (``cmd``), its ``seconds`` (0 when the
    library was ``cached``), ``decoder`` and ``path``, building the library
    first if no call has; None without ``g++``."""
    _load()
    return dict(_state["info"]) if _state["info"] else None


def _float_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeRecordIOReader:
    """Sequential reader over the reference ``.rec`` format with a native
    read-ahead thread.

    ``skip_bad_records`` (default ``MXNET_TPU_BAD_RECORD_QUOTA``) mirrors
    :class:`~mxnet_tpu_torch.recordio.MXRecordIO`'s tolerant mode: a record
    the native reader rejects (larger than ``max_record``, or an error) is
    counted on ``bad_records`` and skipped under the quota, and raises
    without one."""

    def __init__(self, path, queue_cap=64, max_record=1 << 24,
                 skip_bad_records=None):
        lib = _load()
        if lib is None:
            raise RuntimeError("the port's native IO library is unavailable")
        self._lib = lib
        self._path = path
        if skip_bad_records is None:
            from . import config
            skip_bad_records = config.get_int("MXNET_TPU_BAD_RECORD_QUOTA")
        self._bad_quota = int(skip_bad_records)
        self.bad_records = 0
        self._queue_cap = queue_cap
        self._handle = lib.MXTTRecordIOReaderCreate(path.encode(), queue_cap)
        if not self._handle:
            raise IOError("cannot open %s" % path)
        self._buf = (ctypes.c_uint8 * max_record)()
        self._max_record = max_record
        self.records_read = 0

    def _note_bad_record(self, exc):
        if self._bad_quota <= 0:
            raise exc
        self.bad_records += 1
        _NAT_BAD.inc()
        if self.bad_records > self._bad_quota:
            raise IOError(
                "%s: bad-record quota exhausted (%d > %d); last error: %s"
                % (self._path, self.bad_records, self._bad_quota,
                   exc)) from exc
        logging.warning("%s: skipping bad record (%d/%d under quota): %s",
                        self._path, self.bad_records, self._bad_quota, exc)

    def read(self):
        """The next record's bytes, or None at EOF.  The ``recordio.read``
        seam stands for a corrupt record: the one it fires on is read,
        counted as bad and dropped."""
        t0 = time.perf_counter()
        while True:
            dropped = False
            try:
                resilience.fault_point("recordio.read")
            except resilience.FaultInjected as e:
                self._note_bad_record(e)
                dropped = True
            n = self._lib.MXTTRecordIOReaderNext(self._handle, self._buf,
                                                 self._max_record)
            if n == 0:
                return None
            if n < 0 or n > self._max_record:
                # the native side returns the record's full size but copies
                # at most the buffer's: never hand back a truncated record
                # (one the seam dropped is counted once)
                if not dropped:
                    self._note_bad_record(IOError(
                        "%s: record of %d bytes exceeds the %d-byte "
                        "staging buffer (or native error)"
                        % (self._path, n, self._max_record)))
                continue
            if dropped:
                continue
            self.records_read += 1
            _NAT_READS.inc()
            _ioview.account("read", time.perf_counter() - t0, items=1,
                            nbytes=int(n))
            return ctypes.string_at(self._buf, n)

    def position(self):
        """Records the caller has read (the native read-ahead is not
        counted) and the bad records skipped."""
        return {"offset": self.records_read,
                "bad_records": self.bad_records}

    def state(self):
        return {"v": io_resume.STATE_VERSION, "kind": "native_recordio",
                "offset": self.records_read}

    def restore(self, state):
        """A new native reader moved ``offset`` records on (the reader is
        sequential); the old one is replaced only when it got there."""
        from .base import MXNetError
        io_resume.check_state(state, "native_recordio")
        offset = int(state["offset"])
        if offset < 0:
            raise MXNetError("native recordio offset %d < 0" % offset)
        handle = self._lib.MXTTRecordIOReaderCreate(self._path.encode(),
                                                    self._queue_cap)
        if not handle:
            raise MXNetError("cannot reopen %s for restore" % self._path)
        try:
            for i in range(offset):
                n = self._lib.MXTTRecordIOReaderNext(handle, self._buf,
                                                     self._max_record)
                if n == 0:
                    raise MXNetError(
                        "%s has only %d records; state expects >= %d: "
                        "the file shrank since the checkpoint"
                        % (self._path, i, offset))
        except BaseException:   # free the new reader, keep the open one
            self._lib.MXTTRecordIOReaderFree(handle)
            raise
        self.close()
        self._handle = handle
        self.records_read = offset

    def read_float_batch(self, batch, record_floats):
        """``(n, labels, data)``: up to ``batch`` records of IRHeader +
        float32 payload parsed in one native call into numpy arrays of
        ``(batch,)`` and ``(batch, record_floats)``; ``n`` records read."""
        t0 = time.perf_counter()
        labels = np.zeros(batch, np.float32)
        data = np.zeros((batch, record_floats), np.float32)
        n = self._lib.MXTTRecordIOReadFloatBatch(
            self._handle, _float_ptr(labels), _float_ptr(data),
            record_floats, batch)
        if n > 0:
            self.records_read += int(n)
            _NAT_READS.inc(int(n))
            _ioview.account("read", time.perf_counter() - t0, items=int(n),
                            nbytes=int(n) * (record_floats * 4 + 4))
        return int(n), labels, data

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.MXTTRecordIOReaderFree(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class ImageRecordIter:
    """JPEG ``.rec`` iterator over the native pipeline: a reader thread,
    ``preprocess_threads`` decoders, bilinear resize, random crop and
    mirror, whole uint8 batches across the C ABI (the reference's
    ``ImageRecordIter``, ``src/io/iter_image_recordio_2.cc``).

    Batches are ``(data, softmax_label)`` ``DataBatch``es of host
    NDArrays: data f32 NCHW ``(batch_size,) + data_shape`` after
    ``(x - mean) / std * scale`` per channel, or with ``raw_uint8`` the
    decoded bytes as ``(batch_size, H, W, 3)`` uint8, left for the device to
    normalize (``ShardedTrainer(input_mean=, input_std=)``).  ``shuffle``
    draws from a reservoir of ``shuffle_buffer`` decoded images;
    ``rand_crop``, ``rand_mirror`` and the shuffle are seeded by ``seed +
    epoch * 9973``, the epoch counting ``reset`` calls.  ``num_parts`` and
    ``part_index`` keep every ``num_parts``-th record from ``part_index``.
    A last partial batch is filled with wrapped images (``round_batch``)
    and its ``pad`` set.  With more than one decode thread the order of
    records is not deterministic.  An unknown option raises ``TypeError``.

    ``state()`` names the epoch, the shard and the records consumed;
    ``restore`` reopens the pipeline at the state's epoch (so its seed,
    and with one decode thread its order and augmentation, are the
    epoch's) and reads past ``offset`` records.  With more decode threads
    the offset names how many records were consumed, not which.
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 preprocess_threads=4, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0, queue_cap=512,
                 raw_uint8=False, shuffle=False, shuffle_buffer=1024,
                 rand_crop=False, rand_mirror=False, seed=0,
                 num_parts=1, part_index=0, round_batch=True, **kwargs):
        if kwargs:
            raise TypeError("ImageRecordIter: unsupported options %s"
                            % sorted(kwargs))
        lib = _load()
        if lib is None or not lib.MXTTImagePipelineHasJpeg():
            raise RuntimeError(
                "the port's native JPEG pipeline is unavailable (decoder: "
                "%s); build needs libjpeg's headers or the CUDA toolkit's "
                "nvJPEG and a card" % (decoder(),))
        if len(data_shape) != 3 or data_shape[0] != 3:
            raise ValueError("data_shape must be (3, H, W)")
        self._lib = lib
        self._path = path_imgrec
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self._threads = preprocess_threads
        self._queue_cap = queue_cap
        self._mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self._std = np.array([std_r, std_g, std_b], np.float32)
        self._scale = float(scale)
        self._raw = bool(raw_uint8)
        self._shuffle_buffer = int(shuffle_buffer) if shuffle else 0
        self._rand_crop = bool(rand_crop)
        self._rand_mirror = bool(rand_mirror)
        self._seed = int(seed)
        self._num_parts = int(num_parts)
        self._part_index = int(part_index)
        self._round = bool(round_batch)
        self._epoch = 0
        self._consumed = 0
        self._handle = None
        self._open()
        from .io import DataDesc
        h, w = self.data_shape[1], self.data_shape[2]
        if self._raw:
            self.provide_data = [DataDesc("data", (batch_size, h, w, 3),
                                          np.uint8, "NHWC")]
        else:
            self.provide_data = [DataDesc("data",
                                          (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc("softmax_label", (batch_size,))]

    def device_normalization(self):
        """``(input_mean, input_std)`` per channel: what
        ``ShardedTrainer(input_mean=, input_std=)`` takes so that a
        ``raw_uint8`` batch, normalized on the device, equals this
        iterator's f32 batch, ``(x - mean) / std * scale``."""
        return (tuple(float(m) for m in self._mean),
                tuple(float(s) / self._scale for s in self._std))

    def _open(self):
        self.close()
        h, w = self.data_shape[1], self.data_shape[2]
        self._handle = self._lib.MXTTImagePipelineCreate(
            self._path.encode(), h, w, self._threads, self._queue_cap,
            self._num_parts, self._part_index,
            int(self._rand_crop), int(self._rand_mirror),
            self._seed + self._epoch * 9973, self._shuffle_buffer)
        if not self._handle:
            raise IOError("cannot open %s" % self._path)

    def __iter__(self):
        return self

    def reset(self):
        self._epoch += 1
        self._consumed = 0
        self._open()

    def position(self):
        """``{"epoch", "shard", "num_shards", "offset"}``: records the
        caller has consumed this epoch (the decode threads' read-ahead is
        not counted)."""
        return {"epoch": self._epoch, "shard": self._part_index,
                "num_shards": self._num_parts, "offset": self._consumed}

    def state(self):
        return {"v": io_resume.STATE_VERSION, "kind": "image_record",
                "epoch": self._epoch, "shard": self._part_index,
                "num_shards": self._num_parts,
                "offset": int(self._consumed)}

    def restore(self, state):
        """Reopen at the state's epoch and read past its ``offset``
        records, asking for exactly the records missing, so an offset off
        a batch boundary restores too.  A state of another shard layout
        raises."""
        from .base import MXNetError
        io_resume.check_state(state, "image_record")
        if int(state["shard"]) != self._part_index or \
                int(state["num_shards"]) != self._num_parts:
            raise MXNetError(
                "image_record state is for shard %s/%s, iterator is "
                "%d/%d; elastic resharding of the native pipeline is "
                "not supported (use ShardedLedgerIter for elastic "
                "resume)" % (state["shard"], state["num_shards"],
                             self._part_index, self._num_parts))
        offset = int(state["offset"])
        if offset < 0:
            raise MXNetError("image_record offset %d < 0" % offset)
        self._epoch = int(state["epoch"])
        self._consumed = 0
        self._open()
        h, w = self.data_shape[1], self.data_shape[2]
        labels = np.zeros(self.batch_size, np.float32)
        raw = np.empty((self.batch_size, h, w, 3), np.uint8)
        while self._consumed < offset:
            want = min(self.batch_size, offset - self._consumed)
            n = self._lib.MXTTImagePipelineNextBatch(
                self._handle, _float_ptr(labels), _u8_ptr(raw), want)
            if n <= 0:
                raise MXNetError(
                    "%s: epoch has only %d records in this shard; state "
                    "expects >= %d: the file shrank since the checkpoint"
                    % (self._path, self._consumed, offset))
            self._consumed += int(n)

    def next(self):
        from .io import DataBatch
        from .ndarray import NDArray
        h, w = self.data_shape[1], self.data_shape[2]
        labels = np.zeros(self.batch_size, np.float32)
        raw = np.empty((self.batch_size, h, w, 3), np.uint8)
        t0 = time.perf_counter()
        n = self._lib.MXTTImagePipelineNextBatch(
            self._handle, _float_ptr(labels), _u8_ptr(raw), self.batch_size)
        if n < 0:
            raise RuntimeError("%s: a decode thread could not start its "
                               "JPEG decoder (%s)"
                               % (self._path, decoder()))
        if n == 0:
            raise StopIteration
        n = int(n)
        self._consumed += n
        _NAT_READS.inc(n)
        # the native pipeline reads and decodes behind one call
        t1 = time.perf_counter()
        _ioview.account("decode", t1 - t0, items=n, nbytes=int(raw.nbytes))
        if n < self.batch_size and self._round:
            # the reference's round_batch wraps real images, never zeros
            for i in range(n, self.batch_size):
                raw[i] = raw[i % n]
                labels[i] = labels[i % n]
        elif n < self.batch_size:
            raw[n:] = 0
        pad = self.batch_size - n
        if self._raw:
            data = raw
        else:
            data = (raw.astype(np.float32) - self._mean) / self._std \
                * self._scale
            data = np.ascontiguousarray(data.transpose(0, 3, 1, 2))
        out = DataBatch(data=[NDArray(torch.from_numpy(data))],
                        label=[NDArray(torch.from_numpy(labels))], pad=pad)
        _ioview.account("batch", time.perf_counter() - t1, items=n,
                        nbytes=int(data.nbytes))
        return out

    def __next__(self):
        return self.next()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.MXTTImagePipelineFree(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
