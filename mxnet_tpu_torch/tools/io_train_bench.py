"""Training from JPEG records with the decode in the loop, and the decoders'
scaling with threads.

    python -m mxnet_tpu_torch.tools.io_train_bench [--rec FILE] \\
        [--batch 128] [--image 224] [--layers 50] [--train-batches 30]

The counterpart of ``tools/io_train_bench.py``:

1. ``decoder_scaling``: the native pipeline's images/s (``raw_uint8``, no
   training, the page cache warmed first) at 1, 2 and 4 decode threads and
   at the host's core count;
2. ``train_loop``: ResNet fused bf16 NHWC steps on ``gpu(0)`` fed from the
   native pipeline, raw uint8 batches normalized on the card with the
   ImageNet mean and std (``ShardedTrainer(input_mean=, input_std=)``),
   sequential (fetch, ``put_batch``, ``step`` in turn) and through a
   ``DevicePrefetchIter``; end-to-end images/s and per-stage walls (decode
   wait, staging, step dispatch), in place of the JAX tool's ioview
   accounting (ROADMAP Queue A item 8).

Without ``--rec`` it makes one in a temporary directory with ``make_rec``
(2000 random 256-px JPEGs, as the JAX tool's).  One JSON line per part,
with the card's name and power limit.  It needs a CUDA device for the
training part (``--cpu`` runs it on the CPU, at a small ``--image``).
"""
from __future__ import annotations

import argparse
import colorsys
import io as _io
import json
import os
import tempfile
import time

import numpy as np

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "make_rec", "make_class_rec",
           "warm_page_cache", "decoder_scaling", "train_loop", "main"]

#: the RGB mean and std the JAX tool normalizes with on the device
IMAGENET_MEAN = (123.68, 116.779, 103.939)
IMAGENET_STD = (58.393, 57.12, 57.375)


def _jpeg(img, quality, **extra):
    from PIL import Image
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality, **extra)
    return buf.getvalue()


def make_rec(path, n=2000, size=256, seed=0):
    """The JAX tool's records: ``n`` JPEGs (quality 90) of uniform random
    pixels, ``size`` square, label ``i % 1000``, from ``RandomState(seed)``:
    the decode load of ImageNet-sized images, nothing to learn."""
    from .. import recordio
    rng = np.random.RandomState(seed)
    w = recordio.MXRecordIO(path, "w")
    for i in range(n):
        img = rng.randint(0, 255, (size, size, 3), dtype=np.uint8)
        w.write(recordio.pack(recordio.IRHeader(0, float(i % 1000), i, 0),
                              _jpeg(img, 90)))
    w.close()


def make_class_rec(path, n, size=256, classes=4, seed=0, noise=48,
                   quality=90, subsampling=None):
    """Records a network can learn: image ``i`` of class ``i % classes`` is
    the class's colour (hues spread evenly, saturation and value 0.75)
    scaled by a brightness drawn from [0.7, 1.3], plus integer noise drawn
    uniformly from [-``noise``, ``noise``] per pixel and channel, clipped
    to bytes and JPEG-encoded (``subsampling`` as PIL takes it, None for
    PIL's default, 4:2:0); all from ``RandomState(seed)``.  A one-class
    guess scores ``1 / classes``."""
    from .. import recordio
    rng = np.random.RandomState(seed)
    palette = [np.array(colorsys.hsv_to_rgb(c / classes, 0.75, 0.75)) * 255
               for c in range(classes)]
    extra = {} if subsampling is None else {"subsampling": subsampling}
    w = recordio.MXRecordIO(path, "w")
    for i in range(n):
        c = i % classes
        base = (palette[c] * rng.uniform(0.7, 1.3)).astype(np.int16)
        img = base + rng.randint(-noise, noise + 1, (size, size, 3),
                                 dtype=np.int16)
        img = np.clip(img, 0, 255).astype(np.uint8)
        w.write(recordio.pack(recordio.IRHeader(0, float(c), i, 0),
                              _jpeg(img, quality, **extra)))
    w.close()


def warm_page_cache(path):
    """Read the file once, so the first configuration timed does not pay
    the cold read."""
    with open(path, "rb") as f:
        while f.read(1 << 22):
            pass


def decoder_scaling(rec, image, batch, threads=None, repeats=1):
    """``{threads: [images/s, ...]}`` and ``{threads: [cpu/wall, ...]}``:
    whole epochs of ``rec`` through the native pipeline (``raw_uint8``, no
    training) at each thread count (default 1, 2, 4 and the host's
    cores), ``repeats`` times in turn."""
    from .. import io
    cores = os.cpu_count() or 1
    threads = threads or sorted({1, 2, 4, cores})
    warm_page_cache(rec)
    rates, loads = {}, {}
    for _ in range(repeats):
        for t in threads:
            it = io.ImageRecordIter(
                path_imgrec=rec, data_shape=(3, image, image),
                batch_size=batch, preprocess_threads=t, raw_uint8=True)
            n = 0
            t0 = time.perf_counter()
            c0 = time.process_time()
            for b in it:
                n += b.data[0].shape[0] - b.pad
            wall = time.perf_counter() - t0
            cpu = time.process_time() - c0
            it.close()
            rates.setdefault(t, []).append(n / wall)
            loads.setdefault(t, []).append(cpu / wall)
    return rates, loads


def build_trainer(batch, image, layers=50, ctx=None):
    """The JAX tool's trainer: ResNet-``layers`` (1000 classes), SGD lr
    0.1, momentum 0.9, weight decay 1e-4, bf16, NHWC, block fusion, the
    ImageNet mean and std applied to uint8 batches on the device."""
    from ..context import gpu
    from ..models import get_model
    from ..parallel import ShardedTrainer, build_mesh
    net = get_model("resnet%d" % layers, num_classes=1000,
                    image_shape="3,%d,%d" % (image, image))
    return ShardedTrainer(
        net, build_mesh(devices=[ctx or gpu(0)]),
        data_shapes={"data": (batch, 3, image, image)},
        label_shapes={"softmax_label": (batch,)},
        optimizer="sgd", learning_rate=0.1, momentum=0.9,
        weight_decay=1e-4, dtype="bfloat16", layout="NHWC",
        fuse_blocks=True,
        input_mean=IMAGENET_MEAN, input_std=IMAGENET_STD)


def train_loop(rec, image, batch, train_batches, trainer, threads=None,
               prefetch_depth=0, warm=2):
    """``train_batches`` steps of ``trainer`` after ``warm`` untimed ones,
    fed from ``rec`` (raw uint8, shuffled; ``threads`` decoders, default
    the host's cores, at least 2), sequentially or through a
    ``DevicePrefetchIter`` of ``prefetch_depth``; the epoch restarts when
    it ends.  Returns end-to-end images/s, the last loss and the per-stage
    walls of the timed window in ms a batch: ``decode_wait`` (the host
    waiting on the pipeline), ``staging`` (``put_batch``), ``step``
    (``step``'s dispatch; the device's work overlaps the host), and for the
    queue its worker's decode and staging and the consumer's wait."""
    import torch

    from .. import io
    threads = threads or max(2, os.cpu_count() or 1)
    on_card = trainer.mesh.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    it = io.ImageRecordIter(
        path_imgrec=rec, data_shape=(3, image, image), batch_size=batch,
        preprocess_threads=threads, raw_uint8=True, shuffle=True)
    if prefetch_depth > 0:
        source = io.DevicePrefetchIter(it, trainer.put_batch,
                                       depth=prefetch_depth)
    else:
        source = it
    walls = {"decode_wait": 0.0, "staging": 0.0, "step": 0.0}
    n, loss, t_wall, q0 = 0, None, None, None
    while n < train_batches + warm:
        t0 = time.perf_counter()
        try:
            b = next(source)
        except StopIteration:
            source.reset()
            b = next(source)
        t1 = time.perf_counter()
        dev = b if prefetch_depth > 0 else trainer.put_batch(
            {"data": b.data[0].data, "softmax_label": b.label[0].data})
        t2 = time.perf_counter()
        loss = trainer.step(dev)
        t3 = time.perf_counter()
        n += 1
        if n == warm:
            float(loss)          # the warm-up's chain ends before timing
            t_wall = time.perf_counter()
            if prefetch_depth > 0:
                q0 = dict(source.timings)
            continue
        if n > warm:
            walls["decode_wait"] += t1 - t0
            walls["staging"] += t2 - t1
            walls["step"] += t3 - t2
    lval = float(loss)
    sync()
    wall = time.perf_counter() - t_wall
    out = {"mode": "prefetch" if prefetch_depth > 0 else "sequential",
           "prefetch_depth": prefetch_depth, "threads": threads,
           "batch": batch, "image": image, "train_batches": train_batches,
           "images_per_s": train_batches * batch / wall, "wall_s": wall,
           "loss": lval,
           "ms_per_batch": {k: 1e3 * v / train_batches
                            for k, v in walls.items()}}
    if prefetch_depth > 0:
        out["queue_ms_per_batch"] = {
            k: 1e3 * (source.timings[k] - q0[k]) / train_batches
            for k in ("fetch_s", "stage_s", "wait_s")}
        source.close()
    it.close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rec", default=None)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--layers", type=int, default=50)
    ap.add_argument("--train-batches", type=int, default=30)
    ap.add_argument("--skip-scaling", action="store_true")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="also run the DevicePrefetchIter mode at this "
                         "depth (0 = sequential only)")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (use a small --image)")
    args = ap.parse_args(argv)
    from .. import io_native
    from ..context import cpu, gpu
    with tempfile.TemporaryDirectory() as tmp:
        rec = args.rec
        if rec is None:
            rec = os.path.join(tmp, "synth_imagenet.rec")
            make_rec(rec)
        head = {"decoder": io_native.decoder(),
                "cores": os.cpu_count() or 1}
        if not args.cpu:
            import torch
            from . import nvidia_smi
            head.update(device=torch.cuda.get_device_name(0),
                        nvidia_smi=nvidia_smi())
        if not args.skip_scaling:
            rates, loads = decoder_scaling(rec, args.image, args.batch,
                                           repeats=2)
            print(json.dumps(dict(head, part="decoder_scaling",
                                  images_per_s=rates,
                                  cpu_per_wall=loads)), flush=True)
        trainer = build_trainer(args.batch, args.image, args.layers,
                                ctx=cpu() if args.cpu else gpu(0))
        runs = [train_loop(rec, args.image, args.batch, args.train_batches,
                           trainer)]
        if args.prefetch_depth > 0:
            runs.append(train_loop(rec, args.image, args.batch,
                                   args.train_batches, trainer,
                                   prefetch_depth=args.prefetch_depth))
        for r in runs:
            print(json.dumps(dict(head, part="train_loop", **r)), flush=True)


if __name__ == "__main__":
    main()
