"""Train ImageNet-scale networks from JPEG RecordIO files.

    python -m mxnet_tpu_torch.tools.train_imagenet --network resnet \\
        --num-layers 50 --data-train train.rec --data-val val.rec \\
        --batch-size 128 --dtype bfloat16 --fused 1

The counterpart of ``examples/image_classification/train_imagenet.py``
(the reference's ``example/image-classification/train_imagenet.py``), with
its arguments and those of :mod:`mxnet_tpu_torch.tools.fit`.  The data
(``get_rec_iter``): with ``--benchmark 1`` synthetic images from
``RandomState(0)`` (staged once on the fused route); else the port's
native pipeline (``mx.io.ImageRecordIter``: a reader thread and
``--data-nthreads`` decode threads) when its library decodes JPEG and the
host has two cores, ``MXNET_USE_NATIVE_REC`` forcing 1 or 0 (1 raises
where there is no decoder), else PIL's ``mx.image.ImageIter``.  Training
shuffles, crops and mirrors at random; validation reads in order.  On the
fused route the native iterators hand over raw uint8 NHWC batches, which
the trainer normalizes on the card (mean 0, std 1: the same values as the
JAX route's f32 batches, a quarter of the bytes).

It trains on ``gpu(0)`` unless ``--cpu 1`` and prints one JSON line at the
end: the route, each step's loss, each epoch's wall, images/s and
validation, the per-stage walls and the ioview block (fused route), the
telemetry report (``telemetry.report()``: step-time percentiles, spans,
compiles, memory), and on the card its name and ``nvidia-smi``'s name and
power limit.  ``MXNET_TPU_TELEMETRY_JSONL``, ``MXNET_TPU_FLIGHT_DIR`` and
the profiler's variables turn the rest of the telemetry on.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from .. import config, image, io, io_native, telemetry
from ..models import get_model
from . import fit

__all__ = ["get_rec_iter", "parser", "main"]


def get_rec_iter(args, kv):
    """``(train, val)`` iterators for ``args`` (reference
    train_imagenet.get_rec_iter)."""
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    if args.benchmark:
        rng = np.random.RandomState(0)
        n = args.batch_size * 32
        x = rng.rand(n, *image_shape).astype(np.float32)
        y = rng.randint(0, args.num_classes, n).astype(np.float32)
        return io.NDArrayIter(x, y, args.batch_size), None
    forced = os.environ.get("MXNET_USE_NATIVE_REC")
    use_native = config.get_bool(
        "MXNET_USE_NATIVE_REC",
        io_native.jpeg_available() and (os.cpu_count() or 1) >= 2)
    if forced == "1" and not io_native.jpeg_available():
        raise RuntimeError("MXNET_USE_NATIVE_REC=1 but the port's native "
                           "JPEG pipeline is unavailable on this host "
                           "(decoder: %s)" % io_native.decoder())
    if use_native and io_native.jpeg_available():
        raw = fit.use_fused(args)
        train = io.ImageRecordIter(
            path_imgrec=args.data_train, data_shape=image_shape,
            batch_size=args.batch_size, shuffle=True,
            rand_crop=True, rand_mirror=True,
            num_parts=kv.num_workers, part_index=kv.rank,
            preprocess_threads=args.data_nthreads, raw_uint8=raw)
        val = None
        if args.data_val:
            val = io.ImageRecordIter(
                path_imgrec=args.data_val, data_shape=image_shape,
                batch_size=args.batch_size,
                preprocess_threads=args.data_nthreads, raw_uint8=raw)
        return train, val
    train = image.ImageIter(
        batch_size=args.batch_size, data_shape=image_shape,
        path_imgrec=args.data_train, path_imgidx=args.data_train_idx or None,
        shuffle=True, rand_crop=True, rand_mirror=True,
        num_parts=kv.num_workers, part_index=kv.rank)
    val = None
    if args.data_val:
        val = image.ImageIter(
            batch_size=args.batch_size, data_shape=image_shape,
            path_imgrec=args.data_val, shuffle=False)
    return train, val


def parser():
    p = argparse.ArgumentParser(
        description="train imagenet-1k",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--data-train", type=str)
    p.add_argument("--data-train-idx", type=str, default="")
    p.add_argument("--data-val", type=str)
    p.add_argument("--image-shape", type=str, default="3,224,224")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--num-examples", type=int, default=1281167)
    p.add_argument("--benchmark", type=int, default=0,
                   help="if 1, run throughput benchmark on synthetic data")
    fit.add_fit_args(p)
    p.set_defaults(network="resnet", num_layers=50, num_epochs=80,
                   lr_step_epochs="30,60", batch_size=128)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-15s %(message)s")
    net = get_model(args.network, num_classes=args.num_classes,
                    num_layers=args.num_layers, image_shape=args.image_shape)
    history = {}
    fit.fit(args, net, get_rec_iter, history=history)
    out = {"network": args.network, "num_layers": args.num_layers,
           "batch_size": args.batch_size, "dtype": args.dtype,
           "decoder": io_native.decoder(), **history,
           "telemetry": telemetry.report()}
    if fit.get_context(args).device_type == "gpu":
        import torch
        from . import nvidia_smi
        out.update(device=torch.cuda.get_device_name(0),
                   nvidia_smi=nvidia_smi())
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
