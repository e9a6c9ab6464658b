"""The port's ``image`` module against the JAX package's under the same
``random`` and ``np.random`` seeds: ``imdecode``, every augmenter,
``CreateAugmenter``'s lists, and ``ImageIter`` over a ``.rec``, a ``.rec``
with its ``.idx`` (shuffled and sharded), a ``.lst`` image list and an
in-memory list, exactly; and ``tools.im2rec`` writing the JAX tool's
``.lst``, ``.rec`` and ``.idx`` byte for byte."""
import importlib.util
import io as _pyio
import os
import random
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mxnet_tpu import image as jimage  # noqa: E402
from mxnet_tpu import recordio as jrec  # noqa: E402

from mxnet_tpu_torch import image as pimage  # noqa: E402
from mxnet_tpu_torch.tools import im2rec as pim2rec  # noqa: E402


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _jpeg(img, fmt="JPEG"):
    from PIL import Image
    buf = _pyio.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **(
        {"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _image(seed=0, h=30, w=40):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3),
                                               dtype=np.uint8)


@pytest.mark.parametrize("flag,to_rgb", [(1, True), (0, True), (1, False)])
def test_imdecode_matches(flag, to_rgb):
    buf = _jpeg(_image())
    got = pimage.imdecode(buf, flag, to_rgb)
    want = jimage.imdecode(buf, flag, to_rgb)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _augmenters(mod):
    eigval = np.array([55.46, 4.794, 1.148])
    eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]])
    return {
        "resize": mod.ResizeAug(24),
        "resize_bilinear": mod.ResizeAug(20, interp=1),
        "force_resize": mod.ForceResizeAug((17, 23)),
        "random_crop": mod.RandomCropAug((16, 12)),
        "random_sized_crop": mod.RandomSizedCropAug((16, 16), 0.3,
                                                    (0.75, 4 / 3)),
        "center_crop": mod.CenterCropAug((20, 20)),
        "flip": mod.HorizontalFlipAug(0.5),
        "cast": mod.CastAug(),
        "jitter": mod.ColorJitterAug(0.3, 0.3, 0.3),
        "lighting": mod.LightingAug(0.1, eigval, eigvec),
        "normalize": mod.ColorNormalizeAug(np.array([120., 110., 100.]),
                                           np.array([50., 55., 60.])),
    }


@pytest.mark.parametrize("name", sorted(_augmenters(pimage)))
def test_each_augmenter_matches(name):
    src = _image(1)
    if name in ("jitter", "lighting", "normalize"):
        src = src.astype(np.float32)
    for seed in range(4):
        _seed(seed)
        got = _augmenters(pimage)[name](src)
        _seed(seed)
        want = _augmenters(jimage)[name](src)
        assert len(got) == len(want) == 1
        assert got[0].dtype == want[0].dtype
        np.testing.assert_array_equal(got[0], want[0])


def test_helpers_match():
    src = _image(2, 33, 47)
    assert pimage.scale_down((47, 33), (60, 40)) == \
        jimage.scale_down((47, 33), (60, 40))
    np.testing.assert_array_equal(pimage.resize_short(src, 20),
                                  jimage.resize_short(src, 20))
    np.testing.assert_array_equal(
        pimage.fixed_crop(src, 3, 4, 20, 10, (8, 8)),
        jimage.fixed_crop(src, 3, 4, 20, 10, (8, 8)))
    np.testing.assert_array_equal(pimage.color_normalize(src, 100.0, 50.0),
                                  jimage.color_normalize(src, 100.0, 50.0))
    _seed(5)
    got = pimage.random_size_crop(src, (16, 16), 0.9, (3.0, 4.0))
    _seed(5)
    want = jimage.random_size_crop(src, (16, 16), 0.9, (3.0, 4.0))
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])


CREATE = {
    "default": dict(),
    "train": dict(resize=36, rand_crop=True, rand_mirror=True),
    "resize_crop": dict(rand_crop=True, rand_resize=True, mean=True,
                        std=True),
    "colour": dict(brightness=0.2, contrast=0.2, saturation=0.2,
                   pca_noise=0.1, rand_mirror=True),
}


@pytest.mark.parametrize("name", sorted(CREATE))
def test_create_augmenter_lists_match(name):
    src = _image(3, 40, 52)
    for seed in range(3):
        out = []
        for mod in (pimage, jimage):
            _seed(seed)
            data = [src]
            for aug in mod.CreateAugmenter((3, 24, 24), **CREATE[name]):
                data = [r for s in data for r in aug(s)]
            out.append(data)
        np.testing.assert_array_equal(out[0][0], out[1][0])
        assert out[0][0].shape == (24, 24, 3)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """An image folder of 14 JPEGs and PNGs in two class folders, its .lst
    and the .rec/.idx written from it."""
    d = tmp_path_factory.mktemp("imgs")
    root = d / "root"
    for c in range(2):
        (root / ("class%d" % c)).mkdir(parents=True)
        for i in range(7):
            img = _image(10 * c + i, 30 + i, 36 + 2 * c)
            fmt = "PNG" if i % 3 == 0 else "JPEG"
            ext = ".png" if fmt == "PNG" else ".jpg"
            (root / ("class%d" % c) / ("img%d%s" % (i, ext))).write_bytes(
                _jpeg(img, fmt))
    prefix = str(d / "data")
    pim2rec.main([prefix, str(root), "--list", "--recursive"])
    pim2rec.main([prefix, str(root), "--quality", "90"])
    return {"root": str(root), "prefix": prefix}


def _load_jax_im2rec():
    spec = importlib.util.spec_from_file_location(
        "jax_im2rec", os.path.join(ROOT, "tools", "im2rec.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--resize", "20"],
                                   ["--pass-through"],
                                   ["--encoding", ".png"]])
def test_im2rec_writes_the_jax_tools_bytes(dataset, tmp_path, monkeypatch,
                                           extra):
    jtool = _load_jax_im2rec()
    prefix = str(tmp_path / "jax")
    for argv in (["--list", "--recursive"], extra):
        monkeypatch.setattr(sys, "argv", ["im2rec.py", prefix,
                                          dataset["root"]] + argv)
        jtool.main()
    mine = str(tmp_path / "port")
    pim2rec.main([mine, dataset["root"], "--list", "--recursive"])
    pim2rec.main([mine, dataset["root"]] + extra)
    for ext in (".lst", ".rec", ".idx"):
        with open(mine + ext, "rb") as a, open(prefix + ext, "rb") as b:
            assert a.read() == b.read(), ext


def _batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
        it.reset()
    return out


def _both(seed, **kw):
    """The batches of the port's and the JAX ImageIter built and read under
    the same seeds (the constructor's reset draws too)."""
    out = []
    for mod in (pimage, jimage):
        _seed(seed)
        out.append(_batches(mod.ImageIter(**kw)))
    return out


ITERS = {
    "rec": lambda d: dict(path_imgrec=d["prefix"] + ".rec"),
    "rec_idx_shuffle": lambda d: dict(path_imgrec=d["prefix"] + ".rec",
                                      path_imgidx=d["prefix"] + ".idx",
                                      shuffle=True, rand_crop=True,
                                      rand_mirror=True),
    "rec_idx_shard": lambda d: dict(path_imgrec=d["prefix"] + ".rec",
                                    path_imgidx=d["prefix"] + ".idx",
                                    num_parts=2, part_index=1),
    "lst": lambda d: dict(path_imglist=d["prefix"] + ".lst",
                          path_root=d["root"], shuffle=True, resize=28,
                          brightness=0.1),
}


@pytest.mark.parametrize("name", sorted(ITERS))
def test_image_iter_matches(dataset, name):
    got, want = _both(7, batch_size=4, data_shape=(3, 24, 24),
                      **ITERS[name](dataset))
    assert len(got[0]) == len(want[0]) > 0
    for eg, ew in zip(got, want):
        for (x, y, p), (u, v, q) in zip(eg, ew):
            assert p == q
            np.testing.assert_array_equal(x, u)
            np.testing.assert_array_equal(y, v)


def test_image_iter_in_memory_list_and_label_width(dataset):
    names = sorted(os.listdir(os.path.join(dataset["root"], "class0")))
    imglist = [[float(i % 2), 2.0 * i, os.path.join("class0", n)]
               for i, n in enumerate(names)]
    got, want = _both(3, batch_size=3, data_shape=(3, 16, 16),
                      imglist=imglist, path_root=dataset["root"],
                      label_width=2)
    for (x, y, p), (u, v, q) in zip(got[0], want[0]):
        assert p == q and y.shape == (3, 2)
        np.testing.assert_array_equal(x, u)
        np.testing.assert_array_equal(y, v)


def test_image_iter_needs_an_index_to_shuffle(dataset):
    with pytest.raises(Exception, match="index"):
        pimage.ImageIter(batch_size=2, data_shape=(3, 8, 8), shuffle=True,
                         path_imgrec=dataset["prefix"] + ".rec")


def test_image_iter_reads_records_the_port_and_jax_wrote(tmp_path):
    """A .rec written by the JAX package's pack_img reads the same through
    both iterators."""
    w = jrec.MXRecordIO(str(tmp_path / "j.rec"), "w")
    for i in range(6):
        w.write(jrec.pack_img(jrec.IRHeader(0, float(i), i, 0),
                              _image(i, 20, 20), quality=90))
    w.close()
    got, want = _both(0, batch_size=4, data_shape=(3, 16, 16),
                      path_imgrec=str(tmp_path / "j.rec"))
    for (x, y, p), (u, v, q) in zip(got[0], want[0]):
        assert p == q
        np.testing.assert_array_equal(x, u)
        np.testing.assert_array_equal(y, v)
