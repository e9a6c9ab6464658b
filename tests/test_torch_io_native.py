"""The port's native input library, built here from its own sources, against
the JAX package's on the same ``.rec`` files: ``ImageRecordIter`` batches
and labels at one decode thread, exactly, at ``raw_uint8`` and in f32 with
mean, std and scale, with sharding, shuffle, crop and mirror over two
epochs, the tail padding, a corrupt record skipped; ``NativeRecordIOReader``
and ``read_float_batch``; unknown options raising; several decode threads
giving the same images as one; and concurrent builds."""
import hashlib
import io as _pyio
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import io_native as jnative  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import io_native  # noqa: E402
from mxnet_tpu_torch.tools import train_imagenet  # noqa: E402


def _jpeg(img, quality=90):
    from PIL import Image
    buf = _pyio.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _make_rec(path, n=37, seed=0, corrupt=()):
    """``n`` JPEG records of a few sizes (40 to 42 x 48), labels ``i % 5``;
    the records in ``corrupt`` carry bytes that are no JPEG."""
    rng = np.random.RandomState(seed)
    w = tmx.recordio.MXRecordIO(str(path), "w")
    for i in range(n):
        img = rng.randint(0, 255, (40 + i % 3, 48, 3), dtype=np.uint8)
        payload = b"\xff\xd8 not a jpeg" if i in corrupt else _jpeg(img)
        w.write(tmx.recordio.pack(tmx.recordio.IRHeader(0, float(i % 5), i,
                                                        0), payload))
    w.close()
    return str(path)


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    return _make_rec(tmp_path_factory.mktemp("rec") / "a.rec")


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
        it.reset()
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for eg, ew in zip(got, want):
        assert len(eg) == len(ew)
        for (x, y, p), (u, v, q) in zip(eg, ew):
            assert p == q and x.dtype == u.dtype
            np.testing.assert_array_equal(x, u)
            np.testing.assert_array_equal(y, v)


def test_library_builds_from_the_port_sources():
    info = io_native.build_info()
    assert io_native.available() and io_native.jpeg_available()
    assert io_native.decoder() == "libjpeg" == info["decoder"]
    srcs = [a for a in info["cmd"].split() if a.endswith(".cc")]
    host = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "host")
    assert sorted(srcs) == sorted(os.path.join(host, s)
                                  for s in io_native.SOURCES)
    assert "-DHAVE_JPEG" in info["cmd"] and "-ljpeg" in info["cmd"]
    assert info["path"].startswith(os.path.join(ROOT, "build", "native"))
    assert "libmxtpu" not in info["cmd"]


OPTIONS = {
    "raw": dict(raw_uint8=True),
    "float": dict(mean_r=123.0, mean_g=117.0, mean_b=104.0, std_r=58.0,
                  std_g=57.0, std_b=57.5, scale=0.5),
    "augment": dict(raw_uint8=True, shuffle=True, shuffle_buffer=8,
                    rand_crop=True, rand_mirror=True, seed=3),
    "augment_float": dict(shuffle=True, shuffle_buffer=16, rand_crop=True,
                          rand_mirror=True, seed=7),
    "shard": dict(num_parts=3, part_index=1, raw_uint8=True),
    "no_round": dict(round_batch=False, raw_uint8=True),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_batches_equal_jax_at_one_thread(rec, name):
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=8,
              preprocess_threads=1, **OPTIONS[name])
    got = _epochs(tmx.io.ImageRecordIter(**kw))
    want = _epochs(jmx.io.ImageRecordIter(**kw))
    _assert_same(got, want)
    assert got[0][-1][2] in (3, 4)        # the tail batch is padded
    if name == "no_round":
        assert not got[0][-1][0][8 - got[0][-1][2]:].any()


def test_raw_batches_normalized_equal_the_float_batches(rec):
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=8,
              preprocess_threads=1, **OPTIONS["float"])
    it = tmx.io.ImageRecordIter(**kw)
    mean, std = it.device_normalization()
    raw = tmx.io.ImageRecordIter(**dict(kw, raw_uint8=True))
    assert raw.provide_data[0].shape == (8, 32, 32, 3)
    assert raw.provide_data[0].dtype == np.uint8
    assert raw.provide_data[0].layout == "NHWC"
    for fb, rb in zip(it, raw):
        x = (rb.data[0].asnumpy().astype(np.float32) - np.float32(mean)) \
            / np.float32(std)
        np.testing.assert_allclose(x.transpose(0, 3, 1, 2),
                                   fb.data[0].asnumpy(), rtol=1e-6,
                                   atol=1e-5)


def test_corrupt_records_are_skipped_as_in_jax(tmp_path):
    path = _make_rec(tmp_path / "c.rec", n=20, corrupt=(3, 11))
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=6,
              preprocess_threads=1, raw_uint8=True)
    got = _epochs(tmx.io.ImageRecordIter(**kw), 1)
    _assert_same(got, _epochs(jmx.io.ImageRecordIter(**kw), 1))
    labels = np.concatenate([y[:6 - p] for _x, y, p in got[0]])
    assert len(labels) == 18


def test_threads_give_the_same_images(rec):
    def images(threads):
        it = tmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                                    batch_size=8, raw_uint8=True,
                                    preprocess_threads=threads)
        out = []
        for b in it:
            x, y = b.data[0].asnumpy(), b.label[0].asnumpy()
            out += [(float(y[i]), hashlib.sha1(x[i]).hexdigest())
                    for i in range(8 - b.pad)]
        return sorted(out)
    one = images(1)
    assert len(one) == 37
    assert images(4) == one


def test_unknown_options_raise(rec):
    with pytest.raises(TypeError, match="mean_img"):
        tmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                               batch_size=8, mean_img="m.bin")
    with pytest.raises(ValueError):
        tmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(1, 32, 32),
                               batch_size=8)


def test_without_a_decoder_the_pipeline_raises(rec, monkeypatch):
    lib = io_native._load()
    monkeypatch.setattr(lib, "MXTTImagePipelineHasJpeg", lambda: 0)
    assert not io_native.jpeg_available()
    with pytest.raises(RuntimeError, match="JPEG"):
        tmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                               batch_size=8)
    args = train_imagenet.parser().parse_args(
        ["--data-train", rec, "--cpu", "1", "--image-shape", "3,32,32"])
    monkeypatch.setenv("MXNET_USE_NATIVE_REC", "1")
    kv = tmx.kv.create("local")
    with pytest.raises(RuntimeError, match="MXNET_USE_NATIVE_REC=1"):
        train_imagenet.get_rec_iter(args, kv)
    monkeypatch.delenv("MXNET_USE_NATIVE_REC")
    # JAX's choice: PIL's ImageIter, which shuffles through a .idx
    with pytest.raises(tmx.MXNetError, match="ImageIter"):
        train_imagenet.get_rec_iter(args, kv)


def _float_rec(path, n=11, floats=6, seed=0):
    rng = np.random.RandomState(seed)
    w = tmx.recordio.MXRecordIO(str(path), "w")
    for i in range(n):
        label = float(i) if i % 3 else rng.rand(2).astype(np.float32)
        w.write(tmx.recordio.pack(
            tmx.recordio.IRHeader(0, label, i, 0),
            rng.randn(floats + i % 2).astype(np.float32).tobytes()))
    w.close()
    return str(path)


def test_native_reader_matches_jax(tmp_path):
    path = _float_rec(tmp_path / "f.rec")
    for read in ("read", "batch"):
        pr = io_native.NativeRecordIOReader(path)
        jr = jnative.NativeRecordIOReader(path)
        if read == "read":
            while True:
                a, b = pr.read(), jr.read()
                assert a == b
                if a is None:
                    break
            assert pr.records_read == 11
        else:
            for _ in range(3):
                got, want = pr.read_float_batch(4, 6), \
                    jr.read_float_batch(4, 6)
                assert got[0] == want[0]
                np.testing.assert_array_equal(got[1], want[1])
                np.testing.assert_array_equal(got[2], want[2])
            assert got[0] == 3
        pr.close()
        jr.close()


def test_native_reader_oversized_record(tmp_path):
    path = tmp_path / "big.rec"
    w = tmx.recordio.MXRecordIO(str(path), "w")
    for n in (10, 100, 12):
        w.write(b"x" * n)
    w.close()
    strict = io_native.NativeRecordIOReader(str(path), max_record=50,
                                            skip_bad_records=0)
    assert strict.read() == b"x" * 10
    with pytest.raises(IOError, match="exceeds"):
        strict.read()
    tolerant = io_native.NativeRecordIOReader(str(path), max_record=50,
                                              skip_bad_records=1)
    assert [tolerant.read(), tolerant.read(), tolerant.read()] == \
        [b"x" * 10, b"x" * 12, None]
    assert tolerant.bad_records == 1


def test_concurrent_builds_land_one_library(tmp_path):
    """Processes building at once each write a temporary file and rename
    it into place: every one loads a whole library."""
    code = (
        "import sys, pathlib\n"
        "sys.path.insert(0, %r)\n"
        "from mxnet_tpu_torch import io_native\n"
        "io_native.build_dir = lambda: pathlib.Path(%r)\n"
        "assert io_native.jpeg_available()\n"
        "print(io_native.build_info()['path'])\n" % (ROOT, str(tmp_path)))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({o.strip() for o, _e in outs}) == 1
    assert sorted(os.listdir(tmp_path)) == [
        os.path.basename(outs[0][0].strip())]


def test_read_float_batch_skips_short_records(tmp_path):
    path = tmp_path / "s.rec"
    w = tmx.recordio.MXRecordIO(str(path), "w")
    w.write(b"short")
    w.write(tmx.recordio.pack((0, 4.0, 0, 0),
                              struct.pack("<3f", 1.0, 2.0, 3.0)))
    w.close()
    n, labels, data = io_native.NativeRecordIOReader(
        str(path)).read_float_batch(2, 3)
    assert n == 1 and labels[0] == 4.0
    np.testing.assert_array_equal(data[0], [1.0, 2.0, 3.0])


@pytest.mark.cuda
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
def test_nvjpeg_decode_is_held_against_pil(tmp_path, subsampling):
    """Where the library decodes through nvJPEG (a card host without
    libjpeg's headers), its pixels against PIL's decode of the same
    records, within chip_smoke's bounds, which a channel-reversed decode
    must exceed.  Skips on a host that builds libjpeg or has no card."""
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if io_native.decoder() != "nvjpeg":
        pytest.skip("the library decodes with %s here" % io_native.decoder())
    from mxnet_tpu_torch.tools.io_train_bench import make_class_rec
    rec = str(tmp_path / "a.rec")
    make_class_rec(rec, 16, size=64, seed=3,
                   subsampling=None if subsampling == "4:2:0" else 0)
    tol = chip_smoke.TOL_DECODE_MEAN if subsampling == "4:2:0" \
        else chip_smoke.TOL_DECODE_MEAN_444
    got = chip_smoke._decode_against_pil(rec, 64)
    assert got["mean_abs"] <= tol < \
        got["control_channels_reversed_mean_abs"], got
