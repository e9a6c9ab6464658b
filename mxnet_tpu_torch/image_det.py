"""The detection data pipeline: the counterpart of
``mxnet_tpu/image_det.py`` (the reference's ``ImageDetRecordIter`` as
``example/ssd/dataset/iterator.py``'s ``DetRecordIter`` wraps it).

A record's label is the flat float array ``[header_width=2,
object_width, obj0..., obj1..., ...]`` with objects ``[cls_id, xmin,
ymin, xmax, ymax, (difficult)]`` in [0, 1] coordinates (written by
:func:`pack_det_label`); the JPEG payload follows.  The iterator decodes
with PIL, augments the boxes with the image (a random crop that keeps the
boxes whose centre stays inside, a horizontal mirror), resizes to
``data_shape`` and subtracts the mean, drawing from one
``np.random.RandomState(seed)`` in the JAX iterator's order, so both
packages give the same batches.  Batches are host arrays.
"""
from __future__ import annotations

import io as _pyio

import numpy as np

from . import recordio
from .context import cpu
from .io import DataBatch, DataDesc, DataIter

__all__ = ["pack_det_label", "DetRecordIter"]


def pack_det_label(objects, object_width=6):
    """Flat label array of a detection record:
    [2, object_width, cls, xmin, ymin, xmax, ymax, (difficult), ...]."""
    objs = np.asarray(objects, np.float32).reshape(-1, object_width)
    return np.concatenate([[2.0, float(object_width)],
                           objs.ravel()]).astype(np.float32)


def _decode(payload):
    from PIL import Image
    return np.asarray(Image.open(_pyio.BytesIO(payload)).convert("RGB"))


class DetRecordIter(DataIter):
    """Detection ``.rec`` iterator with box-aware augmentation.

    Gives ``data`` (batch, 3, H, W) float32 (RGB, mean subtracted) and
    ``label`` (batch, max_objects, object_width) padded with -1 rows; the
    last batch is filled by repeating its images (``pad`` counts them).
    """

    def __init__(self, path_imgrec, batch_size, data_shape,
                 mean_pixels=(123.68, 116.779, 103.939), shuffle=False,
                 rand_mirror=False, rand_crop=0.0, label_pad_width=-1,
                 seed=0):
        super().__init__(batch_size)
        if len(data_shape) != 3 or data_shape[0] != 3:
            raise ValueError("data_shape must be (3, H, W)")
        self.data_shape = tuple(data_shape)
        self._mean = np.asarray(mean_pixels, np.float32).reshape(3, 1, 1)
        self._shuffle = shuffle
        self._mirror = rand_mirror
        self._crop_prob = float(rand_crop)
        self._rng = np.random.RandomState(seed)
        self._records = self._load(path_imgrec)
        if not self._records:
            raise RuntimeError("no detection records in %s" % path_imgrec)
        self._obj_width = self._records[0][1].shape[1]
        if label_pad_width > 0:
            self._max_objects = label_pad_width
        else:
            self._max_objects = max(r[1].shape[0] for r in self._records)
        self._order = np.arange(len(self._records))
        self._cursor = 0
        h, w = self.data_shape[1:]
        self.provide_data = [DataDesc("data", (batch_size, 3, h, w))]
        self.provide_label = [DataDesc(
            "label", (batch_size, self._max_objects, self._obj_width))]
        self.reset()

    @staticmethod
    def _load(path):
        """The whole ``.rec`` as (JPEG bytes, objects) pairs."""
        out = []
        rec = recordio.MXRecordIO(path, "r")
        try:
            while True:
                s = rec.read()
                if s is None:
                    break
                header, payload = recordio.unpack(s)
                label = np.asarray(header.label, np.float32)
                if label.ndim == 0 or label.size < 2:
                    continue
                header_width = int(label[0])
                object_width = int(label[1])
                objs = label[2 + max(header_width - 2, 0):]
                objs = objs[:objs.size // object_width * object_width]
                out.append((payload, objs.reshape(-1, object_width).copy()))
        finally:
            rec.close()
        return out

    def _augment(self, img, objs, payload):
        """Random crop (probability ``rand_crop``; a window of 0.5 to 1 of
        each side, boxes kept whose centre stays inside, renormalized and
        clipped; a crop that keeps none falls back to the whole image),
        then a mirror with probability 0.5 (``rand_mirror``), then a
        bilinear resize to ``data_shape``."""
        from PIL import Image
        h0, w0 = img.shape[:2]
        objs = objs.copy()
        if self._crop_prob > 0 and self._rng.rand() < self._crop_prob:
            sw = 0.5 + 0.5 * self._rng.rand()
            sh = 0.5 + 0.5 * self._rng.rand()
            x0 = self._rng.rand() * (1 - sw)
            y0 = self._rng.rand() * (1 - sh)
            crop = img[int(y0 * h0):int((y0 + sh) * h0),
                       int(x0 * w0):int((x0 + sw) * w0)]
            kept = []
            for o in objs:
                cx = (o[1] + o[3]) / 2
                cy = (o[2] + o[4]) / 2
                if not (x0 <= cx <= x0 + sw and y0 <= cy <= y0 + sh):
                    continue
                o = o.copy()
                o[1] = np.clip((o[1] - x0) / sw, 0, 1)
                o[3] = np.clip((o[3] - x0) / sw, 0, 1)
                o[2] = np.clip((o[2] - y0) / sh, 0, 1)
                o[4] = np.clip((o[4] - y0) / sh, 0, 1)
                kept.append(o)
            if kept:
                img, objs = crop, np.stack(kept)
            else:
                img = _decode(payload)
        if self._mirror and self._rng.rand() < 0.5:
            img = img[:, ::-1]
            x1 = 1.0 - objs[:, 3]
            x2 = 1.0 - objs[:, 1]
            objs[:, 1], objs[:, 3] = x1, x2
        h, w = self.data_shape[1:]
        img = np.asarray(Image.fromarray(np.ascontiguousarray(img))
                         .resize((w, h), Image.BILINEAR))
        return img, objs

    def reset(self):
        self._cursor = 0
        if self._shuffle:
            self._rng.shuffle(self._order)

    def next(self):
        from .ndarray import array
        if self._cursor >= len(self._records):
            raise StopIteration
        h, w = self.data_shape[1:]
        n = self.batch_size
        data = np.zeros((n, 3, h, w), np.float32)
        label = np.full((n, self._max_objects, self._obj_width), -1.0,
                        np.float32)
        filled = 0
        while filled < n and self._cursor < len(self._records):
            payload, objs = self._records[self._order[self._cursor]]
            self._cursor += 1
            img, aug_objs = self._augment(_decode(payload), objs, payload)
            data[filled] = img.astype(np.float32).transpose(2, 0, 1) \
                - self._mean
            k = min(aug_objs.shape[0], self._max_objects)
            label[filled, :k] = aug_objs[:k]
            filled += 1
        pad = n - filled
        for i in range(filled, n):
            data[i] = data[i % filled]
            label[i] = label[i % filled]
        return DataBatch(data=[array(data, ctx=cpu())],
                         label=[array(label, ctx=cpu())], pad=pad)
