"""Serving replica CLI::

    python -m mxnet_tpu_torch.serving --model inception-bn \
        --data-shape 3,224,224 --classes 1000 --ladder 1,4
    python -m mxnet_tpu_torch.serving --checkpoint PREFIX --data-shape 1024

The counterpart of ``python -m mxnet_tpu.serving``: builds a zoo model
(``models.get_model``) with fresh Xavier weights from seed 0, so every
restart serves the same net, or loads ``PREFIX-symbol.json`` and
``PREFIX-NNNN.params``; binds a Predictor on ``gpu(0)`` (``--cpu 1`` for
the CPU), warms the batch ladder and serves until SIGTERM or Ctrl-C.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys


def _build_predictor(opts):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import models

    ctx = mx.cpu() if opts.cpu else mx.gpu(0)
    dims = tuple(int(d) for d in str(opts.data_shape).split(",")
                 if d.strip())
    data_shapes = {"data": (1,) + dims}
    if opts.checkpoint:
        return mx.Predictor(opts.checkpoint + "-symbol.json",
                            "%s-%04d.params" % (opts.checkpoint, opts.epoch),
                            data_shapes, ctx=ctx)
    ctx.torch_device()       # no card and no --cpu 1: raise before building
    with mx.name.NameManager():          # the same node names each call
        net = models.get_model(opts.model, num_classes=opts.classes)
    mod = mx.module.Module(net, context=mx.cpu())
    label_names = [n for n in net.list_arguments() if n.endswith("label")]
    mod.bind(data_shapes=[("data", (1,) + dims)],
             label_shapes=[(n, (1,)) for n in label_names])
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2.0, rng=0))
    arg_params, aux_params = mod.get_params()
    return mx.Predictor(net.tojson(), dict(arg_params, **aux_params),
                        data_shapes, ctx=ctx)


def parser():
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.serving",
        description="serve a model behind the batch ladder on gpu(0)")
    p.add_argument("--model", default="mlp",
                   help="zoo model name (models.get_model)")
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint prefix to serve instead of a fresh zoo "
                        "model (expects <prefix>-symbol.json + "
                        "<prefix>-NNNN.params)")
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--cpu", type=int, default=0,
                   help="1: serve on the CPU instead of gpu(0)")
    p.add_argument("--data-shape", default="64",
                   help="comma-separated non-batch dims of the 'data' input "
                        "(e.g. '1024' for a GPT, '3,224,224' for an image)")
    p.add_argument("--ladder", default=None,
                   help="rung spec, e.g. '1,4,16' (default "
                        "MXNET_TPU_SERVE_LADDER)")
    p.add_argument("--port", type=int, default=None,
                   help="base port (default MXNET_TPU_SERVE_PORT; a "
                        "replica adds its rank, MXNET_TPU_PROCESS_ID)")
    p.add_argument("--window-ms", type=float, default=None)
    p.add_argument("--queue-depth", type=int, default=None)
    p.add_argument("--deadline-ms", type=float, default=None)
    return p


def main(argv=None):
    opts = parser().parse_args(argv)

    from mxnet_tpu_torch.serving import BatchLadder, Batcher, Server
    pred = _build_predictor(opts)
    ladder = BatchLadder(pred, rungs=opts.ladder)
    batcher = Batcher(ladder, window_ms=opts.window_ms,
                      queue_depth=opts.queue_depth,
                      default_deadline_ms=opts.deadline_ms)
    server = Server(ladder, batcher=batcher, port=opts.port)

    def _term(signum, frame):
        batcher.close(timeout=1.0)
        os._exit(0)

    signal.signal(signal.SIGTERM, _term)
    print("serving: %s rungs=%s port=%d pid=%d rank=%s"
          % ("checkpoint=%s" % opts.checkpoint if opts.checkpoint
             else "model=%s" % opts.model, ladder.rungs, server.port,
             os.getpid(), os.environ.get("MXNET_TPU_PROCESS_ID", "0")),
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    batcher.close(timeout=1.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
