"""DCGAN trained through the Module API, on one NVIDIA GPU.

    python -m mxnet_tpu_torch.tools.dcgan
    python -m mxnet_tpu_torch.tools.dcgan --cpu 1 --size 16 --ngf 8 \\
        --ndf 8 --z 16 --batch-size 8 --images 64

The counterpart of ``examples/gan/dcgan.py``: the same
:func:`make_dcgan_sym`, :func:`synthetic_images`, :func:`facc` and
:func:`train`, with the same draws from ``np.random.RandomState(1)``.  The
generator (``Deconvolution``, BatchNorm, ReLU, tanh) and the discriminator
(``Convolution``, ``LeakyReLU``, BatchNorm, ``LogisticRegressionOutput``)
are Modules; each iteration the discriminator's gradients on a fake batch
(label 0) are kept, its gradients on a real batch (label 1) are added to
them (``NDArray +=``) before its Adam update, and the generator is updated
through the discriminator's input gradients on the fake batch labelled 1
(``inputs_need_grad=True``, ``get_input_grads``, ``backward(out_grads)``).

Its defaults are the reference MXNet ``example/gan/dcgan.py``'s widths:
64x64x3 images, ``z`` 100, batch 64, Adam at 2e-4 with beta1 0.5, a
512-256-128-64-3 generator and a 64-128-256-512-1 discriminator;
:func:`make_dcgan_sym`'s top generator layer is ``ngf * 2**(n_up-1)``, 16
ngf at size 64, so that generator is ``--ngf 32``.  The images are the example's blobs on
a background (``--images`` of them), as no dataset is in the repository.
It runs on ``gpu(0)`` unless ``--cpu 1`` is given and prints one JSON
line: the parameter counts, each iteration's time (synchronized), the
median past the first epoch and images/s, the discriminator's accuracy
history, whether every parameter is finite, the peak memory on the card
and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import time

import numpy as np

__all__ = ["make_dcgan_sym", "synthetic_images", "facc", "train",
           "param_counts", "parse_args", "main"]


def make_dcgan_sym(ngf, ndf, nc, n_up=4, no_bias=True, fix_gamma=True,
                   eps=1e-5 + 1e-12):
    """Generator (rand -> tanh image) and discriminator (image -> logistic)
    symbols; ``n_up`` upsampling stages give image size 4 * 2**(n_up-1)."""
    import mxnet_tpu_torch as mx
    BatchNorm = mx.sym.BatchNorm
    rand = mx.sym.Variable("rand")

    g = mx.sym.Deconvolution(rand, name="g1", kernel=(4, 4),
                             num_filter=ngf * 2 ** (n_up - 1),
                             no_bias=no_bias)
    g = BatchNorm(g, name="gbn1", fix_gamma=fix_gamma, eps=eps)
    g = mx.sym.Activation(g, name="gact1", act_type="relu")
    for i in range(n_up - 1):
        filters = nc if i == n_up - 2 else ngf * 2 ** (n_up - 2 - i)
        g = mx.sym.Deconvolution(g, name="g%d" % (i + 2), kernel=(4, 4),
                                 stride=(2, 2), pad=(1, 1),
                                 num_filter=filters, no_bias=no_bias)
        if i == n_up - 2:
            gout = mx.sym.Activation(g, name="gact_out", act_type="tanh")
        else:
            g = BatchNorm(g, name="gbn%d" % (i + 2), fix_gamma=fix_gamma,
                          eps=eps)
            g = mx.sym.Activation(g, name="gact%d" % (i + 2),
                                  act_type="relu")

    data = mx.sym.Variable("data")
    label = mx.sym.Variable("label")
    d = mx.sym.Convolution(data, name="d1", kernel=(4, 4), stride=(2, 2),
                           pad=(1, 1), num_filter=ndf, no_bias=no_bias)
    d = mx.sym.LeakyReLU(d, name="dact1", act_type="leaky", slope=0.2)
    for i in range(n_up - 2):
        d = mx.sym.Convolution(d, name="d%d" % (i + 2), kernel=(4, 4),
                               stride=(2, 2), pad=(1, 1),
                               num_filter=ndf * 2 ** (i + 1),
                               no_bias=no_bias)
        d = BatchNorm(d, name="dbn%d" % (i + 2), fix_gamma=fix_gamma,
                      eps=eps)
        d = mx.sym.LeakyReLU(d, name="dact%d" % (i + 2), act_type="leaky",
                             slope=0.2)
    d = mx.sym.Convolution(d, name="d_out", kernel=(4, 4), num_filter=1,
                           no_bias=no_bias)
    d = mx.sym.Flatten(d)
    dloss = mx.sym.LogisticRegressionOutput(data=d, label=label,
                                            name="dloss")
    return gout, dloss


def synthetic_images(n, nc, size, seed=0):
    """Blob-on-background images in [-1, 1] (MNIST stand-in)."""
    rng = np.random.RandomState(seed)
    x = np.full((n, nc, size, size), -1.0, np.float32)
    for i in range(n):
        cx, cy = rng.randint(size // 4, 3 * size // 4, 2)
        r = rng.randint(size // 8, size // 4)
        yy, xx = np.mgrid[:size, :size]
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        x[i, :, mask] = 1.0
    return x


def facc(label, pred):
    return ((pred.ravel() > 0.5) == label.ravel()).mean()


def param_counts(modG, modD):
    """(generator, discriminator) trainable parameter counts."""
    return tuple(int(sum(v.size for v in m.get_params()[0].values()))
                 for m in (modG, modD))


def _sync(ctx):
    if ctx.device_type == "gpu":
        import torch
        torch.cuda.synchronize(ctx.device_id)


def train(epochs=2, batch_size=32, size=32, ngf=32, ndf=32, nc=1, z=64,
          lr=2e-4, beta1=0.5, n_images=256, ctx=None, log_every=4,
          init=None, iter_ms=None):
    """The example's loop.  ``init``: ``(arg_g, aux_g, arg_d, aux_d)``
    dicts of arrays set after the initializers ran (another package's
    draws carried in); ``iter_ms``: a list each iteration's time is
    appended to (the iteration synchronized).  Returns ``(modG, modD,
    history)``."""
    import mxnet_tpu_torch as mx
    n_up = int(math.log2(size // 4)) + 1
    assert n_up >= 2 and 4 * 2 ** (n_up - 1) == size, \
        "size must be 4*2^k with k >= 1 (>= 8)"
    symG, symD = make_dcgan_sym(ngf, ndf, nc, n_up=n_up)
    ctx = ctx or mx.current_context()

    x = synthetic_images(n_images, nc, size)
    train_iter = mx.io.NDArrayIter(x, batch_size=batch_size)
    rng = np.random.RandomState(1)

    modG = mx.mod.Module(symG, data_names=("rand",), label_names=None,
                         context=ctx)
    modG.bind(data_shapes=[("rand", (batch_size, z, 1, 1))])
    modG.init_params(initializer=mx.init.Normal(0.02))
    modG.init_optimizer(optimizer="adam",
                        optimizer_params={"learning_rate": lr, "wd": 0.0,
                                          "beta1": beta1})

    modD = mx.mod.Module(symD, data_names=("data",), label_names=("label",),
                         context=ctx)
    modD.bind(data_shapes=[("data", (batch_size, nc, size, size))],
              label_shapes=[("label", (batch_size,))],
              inputs_need_grad=True)
    modD.init_params(initializer=mx.init.Normal(0.02))
    modD.init_optimizer(optimizer="adam",
                        optimizer_params={"learning_rate": lr, "wd": 0.0,
                                          "beta1": beta1})
    if init is not None:
        arg_g, aux_g, arg_d, aux_d = (
            {k: mx.nd.array(np.asarray(v), ctx=ctx) for k, v in d.items()}
            for d in init)
        modG.set_params(arg_g, aux_g)
        modD.set_params(arg_d, aux_d)

    mACC = mx.metric.CustomMetric(facc)
    history = []
    for epoch in range(epochs):
        train_iter.reset()
        for t, batch in enumerate(train_iter):
            t0 = time.perf_counter()
            rbatch = mx.io.DataBatch(
                [mx.nd.array(rng.normal(0, 1,
                                        (batch_size, z, 1, 1)).astype("f"),
                             ctx=ctx)], [])
            modG.forward(rbatch, is_train=True)
            outG = modG.get_outputs()

            # discriminator on fake (label 0); stash the gradients
            label = mx.nd.zeros((batch_size,), ctx=ctx)
            modD.forward(mx.io.DataBatch(outG, [label]), is_train=True)
            modD.backward()
            gradD = [[g.copy() for g in grads]
                     for grads in modD._exec_group.grad_arrays]
            modD.update_metric(mACC, [label])

            # discriminator on real (label 1); accumulate fake grads
            label = mx.nd.ones((batch_size,), ctx=ctx)
            modD.forward(mx.io.DataBatch(batch.data, [label]),
                         is_train=True)
            modD.backward()
            for gr, gf in zip(modD._exec_group.grad_arrays, gradD):
                for a, b in zip(gr, gf):
                    a += b
            modD.update()
            modD.update_metric(mACC, [label])

            # generator: push D toward calling fakes real, backprop the
            # input gradient into G
            label = mx.nd.ones((batch_size,), ctx=ctx)
            modD.forward(mx.io.DataBatch(outG, [label]), is_train=True)
            modD.backward()
            diffD = modD.get_input_grads()
            modG.backward(diffD)
            modG.update()
            if iter_ms is not None:
                _sync(ctx)
                iter_ms.append((time.perf_counter() - t0) * 1e3)

            if (t + 1) % log_every == 0:
                name, acc = mACC.get()
                history.append(acc)
                logging.info("epoch %d iter %d d-acc %.3f", epoch, t + 1,
                             acc)
                mACC.reset()
    return modG, modD, history


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="train DCGAN")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--ngf", type=int, default=32)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--nc", type=int, default=3)
    p.add_argument("--z", type=int, default=100)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--images", type=int, default=2048)
    p.add_argument("--log-every", type=int, default=8)
    p.add_argument("--cpu", type=int, default=0,
                   help="1 to train on the CPU (default: gpu(0))")
    return p.parse_args(argv)


def run(a, ctx):
    """:func:`train` with the arguments ``a`` on ``ctx``; the JSON line's
    fields."""
    import torch
    on_card = ctx.device_type == "gpu"
    if on_card:
        dev = ctx.torch_device()
        torch.zeros(1, device=dev)       # the allocator, before its stats
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    iter_ms = []
    modG, modD, history = train(
        epochs=a.epochs, batch_size=a.batch_size, size=a.size, ngf=a.ngf,
        ndf=a.ndf, nc=a.nc, z=a.z, lr=a.lr, beta1=a.beta1,
        n_images=a.images, ctx=ctx, log_every=a.log_every, iter_ms=iter_ms)
    per_epoch = a.images // a.batch_size
    later = iter_ms[per_epoch:] or iter_ms
    median = float(np.median(later))
    params = [v for m in (modG, modD) for d in m.get_params() for v in
              d.values()]
    g, d = param_counts(modG, modD)
    out = {"size": a.size, "ngf": a.ngf, "ndf": a.ndf, "nc": a.nc,
           "z": a.z, "batch_size": a.batch_size, "epochs": a.epochs,
           "images": a.images, "generator_params": g,
           "discriminator_params": d, "params": g + d,
           "iterations": len(iter_ms), "iter_ms": iter_ms,
           "median_iter_ms": median,
           "images_per_s": a.batch_size / median * 1e3,
           "d_accuracy": [float(h) for h in history],
           "finite": bool(all(np.isfinite(v.asnumpy()).all()
                              for v in params)),
           "context": str(ctx)}
    if on_card:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    return out, modG, modD


def main(argv=None):
    import torch
    import mxnet_tpu_torch as mx
    from . import nvidia_smi
    a = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if a.cpu:
        ctx = mx.cpu()
    elif not torch.cuda.is_available():
        raise SystemExit("dcgan: no CUDA device; pass --cpu 1 to train on "
                         "the CPU")
    else:
        ctx = mx.gpu(0)
    out, _g, _d = run(a, ctx)
    if ctx.device_type == "gpu":
        out["device"] = torch.cuda.get_device_name(ctx.device_id)
        out["nvidia_smi"] = nvidia_smi()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
