"""Image decode, augmenters and ``ImageIter``.

The counterpart of ``mxnet_tpu/image.py`` (the reference's
``python/mxnet/image.py``): decode with PIL, the resize and crop helpers,
the augmenter list protocol (``CreateAugmenter``) and ``ImageIter`` over a
``.rec``, a ``.rec`` with its ``.idx``, or a ``.lst`` image list.  Every
random draw goes to Python's ``random`` or numpy's global generator in the
JAX code's order, so under the same seeds both packages give the same
batches.  Batches are f32 NCHW NDArrays on the host.  ``ImageIter`` has
the JAX package's ``state``/``restore`` (:mod:`~mxnet_tpu_torch.io_resume`).
Stage accounting, as the JAX package's: ``imdecode`` is the ioview
``decode`` stage, the augmenters ``augment``, the batch's assembly
``batch``.  The JAX decode seam (``io.decode``) is not ported.
"""
from __future__ import annotations

import logging
import os
import random
import time

import numpy as np

from .base import MXNetError
from .context import cpu
from . import io as io_mod
from . import io_resume
from .ndarray import array
from . import recordio
from .telemetry import ioview as _ioview

__all__ = ["imdecode", "scale_down", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "RandomSizedCropAug", "CenterCropAug",
           "RandomOrderAug", "ColorJitterAug", "LightingAug",
           "ColorNormalizeAug", "HorizontalFlipAug", "CastAug",
           "CreateAugmenter", "ImageIter"]


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode an image byte buffer to HWC uint8 with PIL: RGB for ``flag``
    1, one channel for 0; ``to_rgb=False`` gives BGR (OpenCV's order).
    Accounted as the ioview ``decode`` stage (wall per image, input
    bytes)."""
    import io as _pyio
    from PIL import Image
    t0 = time.perf_counter()
    im = Image.open(_pyio.BytesIO(buf if isinstance(buf, (bytes, bytearray))
                                  else bytes(buf)))
    im = im.convert("RGB" if flag else "L")
    arr = np.asarray(im)
    if not to_rgb and arr.ndim == 3:
        arr = arr[:, :, ::-1]
    if arr.ndim == 2:
        arr = arr[:, :, None]
    _ioview.account("decode", time.perf_counter() - t0, items=1,
                    nbytes=len(buf))
    return arr


def _resize(src, w, h, interp=2):
    from PIL import Image
    resample = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
                3: Image.NEAREST, 4: Image.LANCZOS}.get(interp,
                                                        Image.BILINEAR)
    im = Image.fromarray(src.squeeze().astype(np.uint8))
    im = im.resize((w, h), resample)
    arr = np.asarray(im)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def scale_down(src_size, size):
    """``size`` scaled down to fit in ``src_size`` (both (w, h))."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize the shorter edge to ``size``."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return _resize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = _resize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = src.astype(np.float32) - np.asarray(mean, np.float32)
    if std is not None:
        src /= np.asarray(std, np.float32)
    return src


def random_size_crop(src, size, min_area, ratio, interp=2):
    """A crop of random area and aspect, resized to ``size``; a center crop
    when ten draws find none that fits."""
    h, w = src.shape[:2]
    area = w * h
    for _ in range(10):
        new_area = random.uniform(min_area, 1.0) * area
        new_ratio = random.uniform(*ratio)
        new_w = int(np.sqrt(new_area * new_ratio))
        new_h = int(np.sqrt(new_area / new_ratio))
        if random.random() < 0.5:
            new_w, new_h = new_h, new_w
        if new_w <= w and new_h <= h:
            x0 = random.randint(0, w - new_w)
            y0 = random.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


# ----------------------------------------------------------- augmenters
def ResizeAug(size, interp=2):
    def aug(src):
        return [resize_short(src, size, interp)]
    return aug


def ForceResizeAug(size, interp=2):
    def aug(src):
        return [_resize(src, size[0], size[1], interp)]
    return aug


def RandomCropAug(size, interp=2):
    def aug(src):
        return [random_crop(src, size, interp)[0]]
    return aug


def RandomSizedCropAug(size, min_area, ratio, interp=2):
    def aug(src):
        return [random_size_crop(src, size, min_area, ratio, interp)[0]]
    return aug


def CenterCropAug(size, interp=2):
    def aug(src):
        return [center_crop(src, size, interp)[0]]
    return aug


def RandomOrderAug(ts):
    def aug(src):
        srcs = [src]
        random.shuffle(ts)
        for t in ts:
            srcs = [j for i in srcs for j in t(i)]
        return srcs
    return aug


def ColorJitterAug(brightness, contrast, saturation):
    ts = []
    coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)
    if brightness > 0:
        def baug(src):
            alpha = 1.0 + random.uniform(-brightness, brightness)
            return [np.clip(src * alpha, 0, 255)]
        ts.append(baug)
    if contrast > 0:
        def caug(src):
            alpha = 1.0 + random.uniform(-contrast, contrast)
            gray = (src * coef).sum(axis=2, keepdims=True)
            return [np.clip(src * alpha + gray.mean() * (1 - alpha), 0, 255)]
        ts.append(caug)
    if saturation > 0:
        def saug(src):
            alpha = 1.0 + random.uniform(-saturation, saturation)
            gray = (src * coef).sum(axis=2, keepdims=True)
            return [np.clip(src * alpha + gray * (1 - alpha), 0, 255)]
        ts.append(saug)
    return RandomOrderAug(ts)


def LightingAug(alphastd, eigval, eigvec):
    """PCA noise, drawn from numpy's global generator."""
    def aug(src):
        alpha = np.random.normal(0, alphastd, size=(3,))
        rgb = np.dot(eigvec * alpha, eigval)
        return [src + rgb]
    return aug


def ColorNormalizeAug(mean, std):
    def aug(src):
        return [color_normalize(src, mean, std)]
    return aug


def HorizontalFlipAug(p):
    def aug(src):
        if random.random() < p:
            return [src[:, ::-1]]
        return [src]
    return aug


def CastAug():
    def aug(src):
        return [src.astype(np.float32)]
    return aug


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2):
    """The standard augmenter list (reference image.CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        if not rand_crop:
            raise ValueError("rand_resize needs rand_crop")
        auglist.append(RandomSizedCropAug(crop_size, 0.3, (3.0 / 4.0,
                                                           4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None:
        if std is None:
            raise ValueError("mean needs std")
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(io_mod.DataIter):
    """Batches of decoded, augmented images from a ``.rec`` file (read in
    order, or by key through its ``.idx``), a ``.lst`` image list under
    ``path_root``, or an in-memory ``imglist`` (reference image.ImageIter).
    ``shuffle`` reorders the keys with ``random.shuffle`` at every
    ``reset``; ``num_parts``/``part_index`` keep one contiguous share of
    them.  Shuffling or sharding a ``.rec`` needs its ``.idx``.

    ``state()`` names the epoch, the shard and the cursor, with the
    epoch's key order when it shuffles (no seed in the state could replay
    ``random.shuffle``); a ``.rec`` read in order keeps its reader's
    byte-exact state.  Augmentation draws are not part of the state."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        if not (path_imgrec or path_imglist or isinstance(imglist, list)):
            raise ValueError("ImageIter needs path_imgrec, path_imglist or "
                             "imglist")
        if path_imgrec:
            logging.info("loading recordio %s...", path_imgrec)
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(
                    path_imgidx, path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                self.imgidx = None
        else:
            self.imgrec = None

        if path_imglist:
            logging.info("loading image list %s...", path_imglist)
            with open(path_imglist) as fin:
                imglist = {}
                imgkeys = []
                for line in iter(fin.readline, ""):
                    line = line.strip().split("\t")
                    label = np.array([float(i) for i in line[1:-1]],
                                     dtype=np.float32)
                    key = int(line[0])
                    imglist[key] = (label, line[-1])
                    imgkeys.append(key)
                self.imglist = imglist
        elif isinstance(imglist, list):
            logging.info("loading image list...")
            result = {}
            imgkeys = []
            index = 1
            for img in imglist:
                key = str(index)
                index += 1
                if len(img) > 2:
                    label = np.array(img[:-1], dtype=np.float32)
                else:
                    label = np.array([img[0]], dtype=np.float32)
                result[key] = (label, img[-1])
                imgkeys.append(str(key))
            self.imglist = result
        else:
            self.imglist = None
        self.path_root = path_root

        self.check_data_shape(data_shape)
        self.provide_data = [io_mod.DataDesc(data_name,
                                             (batch_size,) + data_shape)]
        if label_width > 1:
            self.provide_label = [io_mod.DataDesc(
                label_name, (batch_size, label_width))]
        else:
            self.provide_label = [io_mod.DataDesc(label_name, (batch_size,))]
        self.batch_size = batch_size
        self.data_shape = data_shape
        self.label_width = label_width

        self.shuffle = shuffle
        if self.imgrec is None:
            self.seq = imgkeys
        elif shuffle or num_parts > 1:
            if not self.imgidx:
                # an absent or empty .idx would give empty epochs
                raise MXNetError(
                    "ImageIter(shuffle/num_parts) needs a non-empty "
                    "index: pass path_imgidx to a .idx built alongside "
                    "the .rec (tools/im2rec)")
            self.seq = self.imgidx
        else:
            self.seq = None

        if num_parts > 1:
            if not part_index < num_parts:
                raise ValueError("part_index %d >= num_parts %d"
                                 % (part_index, num_parts))
            n = len(self.seq)
            c = n // num_parts
            self.seq = self.seq[part_index * c:(part_index + 1) * c]
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        self.part_index = int(part_index)
        self.num_parts = int(num_parts)
        self.cur = 0
        self._epochs = -1           # the reset below makes it 0
        self.reset()

    def reset(self):
        if self.shuffle:
            random.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0
        self._epochs += 1

    def position(self):
        """``{"epoch", "shard", "num_shards", "offset", "resyncs"}``: the
        records consumed this epoch and the reader's resyncs."""
        if self.seq is not None:
            offset = self.cur
        elif self.imgrec is not None:
            offset = self.imgrec.records_read
        else:
            offset = 0
        return {"epoch": self._epochs, "shard": self.part_index,
                "num_shards": self.num_parts, "offset": int(offset),
                "resyncs": int(getattr(self.imgrec, "resyncs", 0) or 0)}

    def state(self):
        st = {"v": io_resume.STATE_VERSION, "kind": "image",
              "epoch": self._epochs, "shard": self.part_index,
              "num_shards": self.num_parts, "cur": int(self.cur)}
        if self.seq is not None:
            if self.shuffle:
                st["seq"] = list(self.seq)
        else:
            st["rec"] = self.imgrec.state()
        return st

    def restore(self, state):
        io_resume.check_state(state, "image")
        if int(state["shard"]) != self.part_index or \
                int(state["num_shards"]) != self.num_parts:
            raise MXNetError(
                "image state is for shard %s/%s, iterator is %d/%d"
                % (state["shard"], state["num_shards"],
                   self.part_index, self.num_parts))
        if self.seq is not None:
            seq = state.get("seq")
            if seq is not None and len(seq) != len(self.seq):
                raise MXNetError(
                    "image state key list has %d entries, iterator has "
                    "%d; different dataset?" % (len(seq), len(self.seq)))
            cur = int(state["cur"])
            limit = len(seq if seq is not None else self.seq)
            if not 0 <= cur <= limit:
                raise MXNetError("image cursor %d out of range [0, %d]"
                                 % (cur, limit))
            if seq is not None:
                self.seq = list(seq)
            self.cur = cur
        else:
            self.imgrec.restore(state["rec"])
            self.cur = int(state["cur"])
        self._epochs = int(state["epoch"])

    def next_sample(self):
        """``(label, image bytes or array)`` of the next sample."""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                return header.label, img
            label, fname = self.imglist[idx]
            return label, self.read_image(fname)
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = np.zeros((batch_size, c, h, w), dtype=np.float32)
        batch_label = np.zeros((batch_size, self.label_width),
                               dtype=np.float32) \
            if self.label_width > 1 else np.zeros(batch_size,
                                                  dtype=np.float32)
        i = 0
        t_batch = 0.0
        try:
            while i < batch_size:
                label, s = self.next_sample()
                data = [imdecode(s) if isinstance(s, (bytes, bytearray))
                        else s]
                try:
                    self.check_valid_image(data)
                except RuntimeError as e:
                    logging.debug("Invalid image, skipping:  %s", str(e))
                    continue
                data = self.augmentation_transform(data)
                t0 = time.perf_counter()
                for datum in data:
                    if i >= batch_size:
                        raise MXNetError("the batch size must be a multiple "
                                         "of the augmenters' output count")
                    batch_data[i] = np.transpose(
                        datum.astype(np.float32), (2, 0, 1))
                    if self.label_width > 1:
                        batch_label[i] = label
                    else:
                        batch_label[i] = label if np.isscalar(label) \
                            else np.asarray(label).reshape(-1)[0]
                    i += 1
                t_batch += time.perf_counter() - t0
        except StopIteration:
            if not i:
                raise
        # the batch stage: the cast, transpose and copy into the batch
        # (decode and augment account themselves)
        _ioview.account("batch", t_batch, items=i, nbytes=batch_data.nbytes)
        return io_mod.DataBatch([array(batch_data, ctx=cpu())],
                                [array(batch_label, ctx=cpu())],
                                pad=batch_size - i)

    def check_data_shape(self, data_shape):
        if not len(data_shape) == 3:
            raise ValueError("data_shape should have length 3, with "
                             "dimensions CxHxW")
        if not data_shape[0] == 3 and not data_shape[0] == 1:
            raise ValueError("This iterator expects inputs to have 3 or 1 "
                             "channels.")

    def check_valid_image(self, data):
        if len(data[0].shape) == 0:
            raise RuntimeError("Data shape is wrong")

    def read_image(self, fname):
        with open(os.path.join(self.path_root or "", fname), "rb") as fin:
            return fin.read()

    def augmentation_transform(self, data):
        t0 = time.perf_counter()
        for aug in self.auglist:
            data = [ret for src in data for ret in aug(src)]
        _ioview.account("augment", time.perf_counter() - t0,
                        items=len(data))
        return data
