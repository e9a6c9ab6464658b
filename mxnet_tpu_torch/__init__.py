"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

Import convention mirrors the JAX package's::

    import mxnet_tpu_torch as mx
    pred = mx.Predictor("gpt-symbol.json", "gpt-0000.params",
                        {"data": (1, 1024)})          # binds on gpu(0)

The port keeps the JAX package's Symbol JSON and ``.params`` formats, so a
checkpoint written by either package loads in the other.
``mx.mod.Module`` trains a Symbol through ``Executor.backward`` and the
imperative optimizer, fed by ``mx.io`` iterators and scored by
``mx.metric``::

    it = mx.io.NDArrayIter(x, y, batch_size=16)
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.fit(it, num_epoch=1, optimizer="adam",
            eval_metric=mx.metric.Perplexity(None))

``mx.mod.BucketingModule`` trains sequences of several lengths, one
executor a bucket sharing one parameter set, on graphs written by the
cells of ``mx.rnn`` (``python -m mxnet_tpu_torch.tools.lstm_bucketing``);
``mx.Monitor`` reads statistics of intermediate outputs.  ``mx.nd`` arrays
take the reference's operators and every registered op, and
``mx.autograd`` differentiates imperative code through torch's autograd::

    w = mx.nd.array(np.ones((4, 3)))
    w.attach_grad()
    with mx.autograd.record():
        loss = (mx.nd.dot(x, w) ** 2).sum()
    loss.backward()          # w.grad holds d loss / d w  ``mx.recordio``
reads and writes the reference's ``.rec`` files, ``mx.io.ImageRecordIter``
decodes JPEG records on the port's native pipeline and ``mx.image.ImageIter``
with PIL; ``mx.io.DevicePrefetchIter`` stages batches on the card ahead of
the step (``python -m mxnet_tpu_torch.tools.train_imagenet``).

``parallel.ShardedTrainer`` trains a Symbol on one device in a fused step
(the GPT of ``models.gpt``; ``python -m
mxnet_tpu_torch.tools.transformer_mfu`` times it).  ``mx.rtc`` compiles CUDA C kernels at run time.  Its entry points
run on the card unless the caller passes ``ctx=mx.cpu()``; without a CUDA
device a GPU context raises.  It imports neither ``jax`` nor ``mxnet_tpu``.
"""
from __future__ import annotations

__version__ = "0.1.0"

from .base import MXNetError
from .context import Context, cpu, gpu, current_context, num_gpus
from . import base
from . import profiler
from . import telemetry
from . import random
from . import autograd
from . import ndarray
from . import ndarray as nd
from . import ops
from . import operator
from . import name
from .attribute import AttrScope
from . import symbol
from . import symbol as sym
from .executor import Executor
from . import predictor
from .predictor import Predictor
from . import convert
from . import serving
from . import initializer
from . import initializer as init
from . import lr_scheduler
from . import optimizer
from . import parallel
from . import rtc
from . import metric
from . import config
from . import resilience
from . import io_resume
from . import io
from . import recordio
from . import io_native
from . import image
from . import image_det
from . import callback
from . import kvstore
from . import kvstore as kv
from . import model
from . import module
from . import module as mod
from .module import Module
from . import monitor
from . import monitor as mon
from .monitor import Monitor
from . import rnn
from . import contrib
from . import test_utils
from . import registry
from . import visualization
from . import visualization as viz
from . import torch as th
sym.TorchModule = th.torch_module_symbol
sym.TorchCriterion = th.torch_criterion_symbol
