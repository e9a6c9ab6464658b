"""Inference throughput over the model zoo::

    python -m mxnet_tpu_torch.tools.benchmark_score \\
        --networks alexnet,vgg16,inception_bn,resnet50 --batch-sizes 1,32

The counterpart of ``examples/image_classification/benchmark_score.py``
(the reference's ``example/image-classification/benchmark_score.py``):
images/s of each network at each batch size, 1000 classes, 224x224
(299x299 for Inception-v3).  Two routes: :func:`score`, the Executor
(``simple_bind`` with ``grad_req="null"``, Xavier weights, moving
variances at 1, f32 NCHW), and with ``--fused 1`` :func:`score_fused`, the
``ShardedTrainer``'s inference forward (``--dtype``, bfloat16 by default,
NHWC).  Each times ``num_batches`` forwards of one batch staged on the
device after a warm-up forward; reading the last output closes the chain.

It scores on ``gpu(0)`` unless ``--cpu 1`` and prints one JSON line: each
network's images/s at each batch size, and on the card its name and
``nvidia-smi``'s name and power limit.
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np

__all__ = ["image_shape_of", "score", "score_fused", "parser", "main"]


def image_shape_of(network):
    """The input image of ``network``: 299x299 for Inception-v3, else
    224x224 (the reference script's rule)."""
    return (3, 299, 299) if network.replace("-", "_") == "inception_v3" \
        else (3, 224, 224)


def _sync(ctx):
    if ctx.device_type == "gpu":
        import torch
        torch.cuda.synchronize(ctx.device_id)


def score(network, batch_size, image_shape=(3, 224, 224), num_batches=20,
          ctx=None):
    """Images/s of ``network`` through the Executor on ``ctx`` (default
    ``gpu(0)``)."""
    from .. import context, initializer, models
    ctx = ctx or context.gpu(0)
    net = models.get_model(network, num_classes=1000,
                           image_shape=",".join(map(str, image_shape)))
    data_shape = (batch_size,) + tuple(image_shape)
    ex = net.simple_bind(ctx, grad_req="null", data=data_shape,
                         softmax_label=(batch_size,))
    init = initializer.Xavier(rng=0)
    for k, v in ex.arg_dict.items():
        if k not in ("data", "softmax_label"):
            init(k, v)
    for k, v in ex.aux_dict.items():
        if k.endswith("moving_var"):
            v[:] = 1.0
    x = np.random.RandomState(0).rand(*data_shape).astype(np.float32)
    ex.forward(is_train=False, data=x)
    float(ex.outputs[0].asnumpy().sum())     # warm-up, read back
    _sync(ctx)
    tic = time.perf_counter()
    for _ in range(num_batches):
        out = ex.forward(is_train=False)
    float(out[0].asnumpy().sum())            # reading the value closes it
    return num_batches * batch_size / (time.perf_counter() - tic)


def score_fused(network, batch_size, image_shape=(3, 224, 224),
                num_batches=20, dtype="bfloat16", ctx=None):
    """Images/s of ``network`` through the ``ShardedTrainer``'s inference
    forward in ``dtype``, NHWC, on ``ctx`` (default ``gpu(0)``)."""
    from .. import context, models
    from ..parallel import ShardedTrainer, build_mesh
    ctx = ctx or context.gpu(0)
    net = models.get_model(network, num_classes=1000,
                           image_shape=",".join(map(str, image_shape)))
    data_shape = (batch_size,) + tuple(image_shape)
    trainer = ShardedTrainer(
        net, build_mesh(devices=[ctx]), data_shapes={"data": data_shape},
        label_shapes={"softmax_label": (batch_size,)}, dtype=dtype,
        layout="NHWC")
    x = np.random.RandomState(0).rand(*data_shape).astype(np.float32)
    dev = trainer.put_batch({"data": x})
    float(trainer.forward(dev)[0].float().sum())     # warm-up, read back
    _sync(ctx)
    tic = time.perf_counter()
    for _ in range(num_batches):
        out = trainer.forward(dev)
    float(out[0].float().sum())
    return num_batches * batch_size / (time.perf_counter() - tic)


def parser():
    p = argparse.ArgumentParser(description="score inference speed")
    p.add_argument("--networks", type=str,
                   default="alexnet,vgg16,inception_bn,resnet50")
    p.add_argument("--batch-sizes", type=str, default="1,2,4,8,16,32")
    p.add_argument("--fused", type=int, default=0,
                   help="1: score the fused bf16 NHWC route")
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--cpu", type=int, default=0,
                   help="1: score on the CPU instead of gpu(0)")
    return p


def main(argv=None):
    import torch
    from .. import context
    from . import nvidia_smi
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.cpu:
        ctx = context.cpu()
    elif not torch.cuda.is_available():
        raise SystemExit("benchmark_score: no CUDA device; pass --cpu 1 to "
                         "score on the CPU")
    else:
        ctx = context.gpu(0)
    results = {}
    for net in args.networks.split(","):
        shape = image_shape_of(net)
        logging.info("network: %s", net)
        results[net] = {}
        for b in (int(x) for x in args.batch_sizes.split(",")):
            if args.fused:
                speed = score_fused(net, b, image_shape=shape,
                                    dtype=args.dtype, ctx=ctx)
            else:
                speed = score(net, b, image_shape=shape, ctx=ctx)
            logging.info("batch size %2d, image/sec: %f", b, speed)
            results[net][b] = speed
    out = {"route": "fused" if args.fused else "executor",
           "dtype": args.dtype if args.fused else "float32",
           "context": str(ctx),
           "images_per_s": results}
    if ctx.device_type == "gpu":
        out.update(device=torch.cuda.get_device_name(0),
                   nvidia_smi=nvidia_smi())
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
