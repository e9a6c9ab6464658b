"""ResNet training throughput (images/s/chip) on one NVIDIA GPU.

    python -m mxnet_tpu_torch.tools.bench             # one JSON line

The port's counterpart of the training leg of the repo's ``bench.py``, with
its environment variables and defaults: ``BENCH_BATCH`` (128),
``BENCH_IMAGE`` (224), ``BENCH_LAYERS`` (50), ``BENCH_STEPS`` (50),
``BENCH_DTYPE`` (bfloat16), ``BENCH_SCAN`` (10), ``BENCH_OPTIMIZER``
(sgd), ``BENCH_LAYOUT`` (NHWC) and ``BENCH_FUSE_BLOCKS`` (1).  It builds
``models.get_model("resnet<layers>")`` under ``ShardedTrainer`` on
``gpu(0)`` (SGD lr 0.1, momentum 0.9, weight decay 1e-4), stages one batch
from ``RandomState(0)``, warms up with two ``step`` calls and one
``run_steps`` chain, and times chains of ``BENCH_SCAN`` steps on the host
clock between ``torch.cuda.synchronize()`` calls.

It prints ``bench.py``'s fields (``metric``, ``value``, ``unit``,
``vs_baseline`` against the reference's 45.52 img/s on one K80, and the
fusion plan's summary) plus the card's name and ``nvidia-smi``'s name and
power limit, since a card set below its 700 W maximum runs slower under
load.  The JAX options ``stem_space_to_depth`` and ``auto_layouts`` are
TPU-era rewrites the port does not have: it passes both as False.  The
``--dry-run``, ``--serve`` and overlap legs are not ported.  It needs a
CUDA device and fails without one.
"""
from __future__ import annotations

import json
import os
import time

from . import nvidia_smi

#: the reference's published ResNet-50 training rate on one K80 (img/s)
BASELINE_IMG_S = 45.52


def build_trainer(batch, image, num_layers=50, dtype="bfloat16",
                  layout="NHWC", fuse_blocks=True, optimizer="sgd",
                  learning_rate=0.1, ctx=None):
    """``(trainer, staged batch)``: ``bench.py``'s ResNet trainer on a
    one-device mesh on ``ctx`` (default ``gpu(0)``) and one batch of
    uniform(-1, 1) images and random labels from ``RandomState(0)``,
    staged once."""
    import numpy as np

    from ..context import gpu
    from ..models import get_model
    from ..parallel import ShardedTrainer, build_mesh

    net = get_model("resnet%d" % num_layers, num_classes=1000,
                    image_shape="3,%d,%d" % (image, image))
    trainer = ShardedTrainer(
        net, build_mesh(devices=[ctx or gpu(0)]),
        data_shapes={"data": (batch, 3, image, image)},
        label_shapes={"softmax_label": (batch,)}, optimizer=optimizer,
        learning_rate=learning_rate, momentum=0.9, weight_decay=1e-4,
        dtype=dtype,
        layout=layout, auto_layouts=False, stem_space_to_depth=False,
        fuse_blocks=fuse_blocks)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (batch, 3, image, image)).astype(np.float32)
    y = rng.randint(0, 1000, batch).astype(np.float32)
    return trainer, trainer.put_batch({"data": x, "softmax_label": y})


def time_chains(trainer, staged, steps, scan):
    """Run ``steps // scan`` chains of ``run_steps(staged, scan)`` (at
    least one) between two ``torch.cuda.synchronize()`` calls when the
    trainer lives on the card; returns ``(steps run, seconds, last
    losses)``."""
    import torch

    def sync():
        if trainer.mesh.device.type == "cuda":
            torch.cuda.synchronize()

    chains = max(1, steps // scan)
    sync()
    t0 = time.perf_counter()
    for _ in range(chains):
        losses = trainer.run_steps(staged, scan)
    sync()
    return chains * scan, time.perf_counter() - t0, losses


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; this tool measures the GPU")
    env = os.environ.get
    batch = int(env("BENCH_BATCH", "128"))
    image = int(env("BENCH_IMAGE", "224"))
    num_layers = int(env("BENCH_LAYERS", "50"))
    steps = int(env("BENCH_STEPS", "50"))
    scan = max(1, int(env("BENCH_SCAN", "10")))
    fuse_blocks = env("BENCH_FUSE_BLOCKS", "1") == "1"
    trainer, staged = build_trainer(
        batch, image, num_layers, dtype=env("BENCH_DTYPE", "bfloat16"),
        layout=env("BENCH_LAYOUT", "NHWC"), fuse_blocks=fuse_blocks,
        optimizer=env("BENCH_OPTIMIZER", "sgd"))
    float(trainer.step(staged))
    float(trainer.step(staged))
    float(trainer.run_steps(staged, scan)[-1])
    done, seconds, losses = time_chains(trainer, staged, steps, scan)
    if not np.isfinite(float(losses[-1])):
        raise SystemExit("bench: non-finite loss %r" % losses)
    img_per_sec = done * batch / seconds
    print(json.dumps({
        "metric": "resnet%d_train_images_per_sec_per_chip" % num_layers,
        "value": round(img_per_sec, 2), "unit": "img/s/chip",
        "vs_baseline": round(img_per_sec / BASELINE_IMG_S, 3),
        "step_ms": seconds / done * 1e3, "steps": done, "batch": batch,
        "image": image, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi(),
        "fusion": {"enabled": fuse_blocks,
                   "summary": trainer.fusion_summary()},
    }))


if __name__ == "__main__":
    main()
