"""The image-classification training harness of the port: the fit CLI's
arguments and its two routes.

The counterpart of ``examples/image_classification/common/fit.py`` (the
reference's ``example/image-classification/common/fit.py``), with the same
arguments plus ``--cpu``.  ``fit(args, network, data_loader)`` trains
``network`` on the iterators ``data_loader(args, kv)`` returns:

* the fused route (``--fused 1``; ``-1`` takes it on a GPU context):
  ``ShardedTrainer`` on one device in NHWC with block fusion
  (``--fuse-blocks``, on unless 0), each batch staged by ``put_batch``
  (raw uint8 batches normalized on the device with the iterator's mean and
  std), through a ``DevicePrefetchIter`` of depth 2 unless
  ``--device-queue 0`` or ``--benchmark 1`` (whose synthetic batches are
  staged once and reused); a Speedometer-style line every
  ``--disp-batches``, the fusion plan after the first batch, and each
  epoch's validation through ``trainer.forward`` with ``accuracy`` (and
  ``top_k_accuracy`` with ``--top-k``); with ``--model-prefix`` each
  epoch ``e`` saves ``trainer.save_checkpoint(prefix, e + 1)`` with its
  optimizer states, and ``--load-epoch`` loads that checkpoint's
  parameters and moving statistics (not its optimizer states, as the JAX
  harness) and trains from that epoch on;
* the Module route (``--fused 0``; ``-1`` takes it on the CPU):
  ``Module.fit`` with Speedometer, epoch-end checkpoints under
  ``--model-prefix`` and validation.  Block fusion follows
  ``MXNET_FUSE_BLOCKS`` as the executors read it at bind.

Telemetry on the fused route, as the trainer's and the JAX loop's: each
fetch is a ``data.fetch`` span, each step a ``trainer.step`` record
(``MXNET_TPU_TELEMETRY_JSONL`` writes them), the training iterator is
tracked by ``telemetry.ioview`` (its position rides each record), an
inline ``put_batch`` is charged to the ioview ``device_stage`` stage, and
``history["io"]`` is ``ioview.summary()`` at the end: the stage totals and
the bottleneck verdict beside the loop's plain ``timings``.

The Module route binds ``gpu(i)`` for each of ``--gpus`` (default 0),
the batch split across them; the CPU only with ``--cpu 1``.  The fused
route runs one device a process: ``--gpus`` with one id, or inside a
job of ``tools/launch.py`` the rank's card, on a mesh whose data axis
spans the job's processes (several ids in one process raise).  With
``--kv-store dist_*`` each rank reads its part of the records (the data
loader's ``num_parts``/``part_index``), ``--batch-size`` is a rank's
batch (the fused trainer's global batch is it times the workers), the lr
schedule's epoch is ``num_examples // batch_size // workers``, and every
rank calls the checkpoint save, which rank 0 writes.  The fused route
passes no ``auto_layouts``: XLA's chosen state layouts have no
counterpart in the port's trainer, which raises on it.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .. import callback, initializer, io, kvstore, lr_scheduler, metric
from .. import telemetry
from ..base import MXNetError
from ..context import cpu, gpu
from ..module import Module
from ..ndarray import NDArray

__all__ = ["add_fit_args", "get_context", "get_contexts", "use_fused",
           "fit"]


def add_fit_args(parser):
    """The reference's fit arguments (fit.py:45-89), the JAX harness's
    additions and ``--cpu``."""
    train = parser.add_argument_group("Training", "model training")
    train.add_argument("--network", type=str, default="mlp",
                       help="the neural network to use")
    train.add_argument("--num-layers", type=int,
                       help="number of layers in the neural network, "
                            "required by some networks such as resnet")
    train.add_argument("--gpus", type=str,
                       help="the card to run on, e.g. 0 (the default); one "
                            "device only")
    train.add_argument("--tpus", type=str,
                       help="the JAX package's spelling of --gpus")
    train.add_argument("--cpu", type=int, default=0,
                       help="1: run on the CPU instead of the card")
    train.add_argument("--kv-store", type=str, default="device",
                       help="key-value store type")
    train.add_argument("--num-epochs", type=int, default=100,
                       help="max num of epochs")
    train.add_argument("--lr", type=float, default=0.1,
                       help="initial learning rate")
    train.add_argument("--lr-factor", type=float, default=0.1,
                       help="the ratio to reduce lr on each step")
    train.add_argument("--lr-step-epochs", type=str,
                       help="the epochs to reduce the lr, e.g. 30,60")
    train.add_argument("--optimizer", type=str, default="sgd",
                       help="the optimizer type")
    train.add_argument("--mom", type=float, default=0.9,
                       help="momentum for sgd")
    train.add_argument("--wd", type=float, default=0.0001,
                       help="weight decay for sgd")
    train.add_argument("--batch-size", type=int, default=128,
                       help="the batch size")
    train.add_argument("--disp-batches", type=int, default=20,
                       help="show progress for every n batches")
    train.add_argument("--model-prefix", type=str,
                       help="model prefix for checkpointing")
    train.add_argument("--load-epoch", type=int,
                       help="load the model on an epoch using the "
                            "model-prefix")
    train.add_argument("--top-k", type=int, default=0,
                       help="report the top-k accuracy. 0 means no report.")
    train.add_argument("--data-nthreads", type=int, default=4,
                       help="number of native decode threads")
    train.add_argument("--test-io", type=int, default=0,
                       help="1 means test reading speed without training")
    train.add_argument("--monitor", dest="monitor", type=int, default=0,
                       help="log network parameters every N iters if larger "
                            "than 0")
    train.add_argument("--fused", type=int, default=-1,
                       help="1: the fused ShardedTrainer step; 0: the "
                            "Module route; -1: fused on a GPU, Module on "
                            "the CPU")
    train.add_argument("--dtype", type=str, default="float32",
                       help="compute dtype of the fused route (masters "
                            "stay f32)")
    train.add_argument("--fuse-blocks", type=int, default=-1,
                       help="block fusion on the fused route: 0 off, "
                            "else on")
    train.add_argument("--device-queue", type=int, default=-1,
                       help="1: stage batches ahead on a side stream with "
                            "DevicePrefetchIter; 0: stage inline; -1: on")
    return train


def get_contexts(args):
    """``[gpu(i) for i in --gpus/--tpus]`` (default 0), or ``[cpu()]`` with
    ``--cpu 1``; no CUDA device without ``--cpu 1`` raises."""
    if getattr(args, "cpu", 0):
        return [cpu()]
    spec = getattr(args, "gpus", None) or getattr(args, "tpus", None) or "0"
    ids = [int(i) for i in str(spec).split(",") if i.strip() != ""]
    if not torch.cuda.is_available():
        raise MXNetError("no CUDA device: this tool trains on the card; pass "
                         "--cpu 1 to train on the CPU")
    return [gpu(i) for i in ids]


def get_context(args):
    """The fused route's one device: the rank's card inside a launched job
    (``MXNET_TPU_NUM_PROCESSES`` > 1), else the one id of ``--gpus``;
    several ids in one process raise (one process a card: launch the
    job with ``tools/launch.py``)."""
    ctxs = get_contexts(args)
    from .. import config
    if ctxs[0].device_type == "gpu" and \
            (config.get_int("MXNET_TPU_NUM_PROCESSES") or 1) > 1:
        from ..parallel import multihost
        return gpu(multihost.device().index)
    if len(ctxs) != 1:
        raise MXNetError(
            "--gpus %r: the fused route runs one device a process; launch "
            "one process a card with tools/launch.py (several devices in "
            "one process are the next slice of ROADMAP Queue A item 4)"
            % getattr(args, "gpus", None))
    return ctxs[0]


def _get_lr_scheduler(args, kv):
    if not args.lr_step_epochs:
        return (args.lr, None)
    epoch_size = args.num_examples // args.batch_size
    if "dist" in args.kv_store:
        epoch_size //= kv.num_workers
    begin_epoch = args.load_epoch if args.load_epoch else 0
    step_epochs = [int(s) for s in args.lr_step_epochs.split(",")]
    lr = args.lr
    for s in step_epochs:
        if begin_epoch >= s:
            lr *= args.lr_factor
    if lr != args.lr:
        logging.info("Adjust learning rate to %e for epoch %d", lr,
                     begin_epoch)
    steps = [epoch_size * (x - begin_epoch) for x in step_epochs
             if x - begin_epoch > 0]
    return (lr, lr_scheduler.MultiFactorScheduler(step=steps,
                                                  factor=args.lr_factor))


def use_fused(args):
    """``--fused``, and for -1 whether the context is a GPU."""
    if getattr(args, "fused", -1) != -1:
        return bool(args.fused)
    return get_contexts(args)[0].device_type == "gpu"


def _host_nchw(desc):
    """The NCHW host shape of an iterator's data: a raw batch's
    ``(N, H, W, C)`` (layout NHWC) read as ``(N, C, H, W)``."""
    shape = tuple(desc.shape)
    if getattr(desc, "layout", "NCHW") == "NHWC" and len(shape) == 4:
        return (shape[0], shape[3], shape[1], shape[2])
    return shape


def _metric_get(m):
    name, value = m.get()
    if not isinstance(name, list):
        name, value = [name], [value]
    return name, value


def _eval_metrics(args):
    out = [metric.create("accuracy")]
    if args.top_k > 0:
        out.append(metric.create("top_k_accuracy", top_k=args.top_k))
    return out


def _sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize(ctx.torch_device())


def _fit_fused(args, sym, train, val, kv, history):
    """Train through the fused ``ShardedTrainer`` step; fills ``history``
    (each step's loss, each epoch's wall, images/s, validation and the
    per-stage walls) when it is a dict."""
    from ..parallel import ShardedTrainer, build_mesh

    ctx = get_context(args)
    data_desc, label_desc = train.provide_data[0], train.provide_label[0]
    data_name, label_name = data_desc[0], label_desc[0]
    lr, lr_sched = _get_lr_scheduler(args, kv)
    mesh = build_mesh(devices=[ctx])
    # the iterators give this rank's rows; the trainer takes global shapes
    world = mesh.world
    host = _host_nchw(data_desc)
    common = dict(
        data_shapes={data_name: (host[0] * world,) + tuple(host[1:])},
        label_shapes={label_name: (label_desc[1][0] * world,)
                      + tuple(label_desc[1][1:])},
        optimizer=args.optimizer,
        optimizer_params={"lr_scheduler": lr_sched},
        learning_rate=lr, momentum=args.mom, weight_decay=args.wd,
        dtype=args.dtype, fuse_blocks=getattr(args, "fuse_blocks", -1) != 0,
        initializer=initializer.Xavier(rnd_type="gaussian", factor_type="in",
                                       magnitude=2))
    if np.dtype(getattr(data_desc, "dtype", np.float32)) == np.uint8:
        # raw decoded bytes: the iterator's normalization runs on the card
        mean, std = train.device_normalization()
        common.update(input_mean=mean, input_std=std)
    try:
        trainer = ShardedTrainer(sym, mesh, layout="NHWC", **common)
    except MXNetError:
        # graphs whose ops pin NCHW axes train in NCHW; put_batch permutes
        # raw NHWC uint8 batches to NCHW on the device
        trainer = ShardedTrainer(sym, mesh, **common)
    begin_epoch = args.load_epoch or 0
    if args.load_epoch and args.model_prefix:
        trainer.load_checkpoint(args.model_prefix, args.load_epoch)
    eval_metrics = _eval_metrics(args)

    # --benchmark cycles a small synthetic set: each distinct batch is
    # staged once and reused, so the run times the step, not the copies
    staged = {} if getattr(args, "benchmark", 0) else None
    dq = getattr(args, "device_queue", -1)
    use_queue = staged is None and dq != 0
    if staged is not None and dq == 1:
        logging.info("--device-queue 1 is overridden by --benchmark: its "
                     "batches are staged once and reused on the device")

    def host_dict(batch):
        return {data_name: batch.data[0].data,
                label_name: batch.label[0].data}

    hist = history if isinstance(history, dict) else {}
    hist.update(losses=[], epochs=[], route="fused", queue=use_queue,
                context=str(ctx))
    fetch_span = telemetry.span("data.fetch", category="io")
    timings = {"fetch_s": 0.0, "stage_s": 0.0, "step_dispatch_s": 0.0,
               "queue_wait_s": 0.0, "batches": 0}
    for epoch in range(begin_epoch, args.num_epochs):
        train.reset()
        _sync(ctx)
        t_epoch = time.perf_counter()
        tic = time.time()
        nbatch = 0
        losses = []
        source = io.DevicePrefetchIter(train, trainer.put_batch, depth=2) \
            if use_queue else train
        # its position rides each step record and checkpoint
        telemetry.ioview.track(source)
        while True:
            t0 = time.perf_counter()
            try:
                with fetch_span:
                    batch = next(source)
            except StopIteration:
                break
            t1 = time.perf_counter()
            if use_queue:
                dev = batch          # staged by the queue's worker
            elif staged is not None and nbatch in staged:
                dev = staged[nbatch]
            else:
                host = host_dict(batch)
                dev = trainer.put_batch(host)
                telemetry.ioview.account(
                    "device_stage", time.perf_counter() - t1, items=1,
                    nbytes=sum(v.nbytes for v in host.values()))
                if staged is not None:
                    staged[nbatch] = dev
            t2 = time.perf_counter()
            loss = trainer.step(dev)
            timings["queue_wait_s" if use_queue else "fetch_s"] += t1 - t0
            timings["stage_s"] += t2 - t1
            timings["step_dispatch_s"] += time.perf_counter() - t2
            losses.append(loss)
            nbatch += 1
            if nbatch == 1 and epoch == begin_epoch:
                fs = trainer.fusion_summary()
                hist["fusion"] = fs
                if fs:
                    logging.info(
                        "fusion plan: %d block(s) %s, %d on K5, "
                        "fallbacks=%s", fs["blocks"], fs["kinds"],
                        fs["pallas_blocks"], fs["fallbacks"] or "none")
            if args.disp_batches and nbatch % args.disp_batches == 0:
                lval = float(loss)   # the window's one host sync
                speed = args.disp_batches * args.batch_size / \
                    (time.time() - tic)
                logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                             "\tcross-entropy=%f", epoch, nbatch, speed,
                             lval)
                tic = time.time()
        _sync(ctx)
        wall = time.perf_counter() - t_epoch
        if use_queue:
            for k in ("fetch_s", "stage_s"):
                timings[k] += source.timings[k]
        timings["batches"] += nbatch
        epoch_losses = torch.stack(losses).tolist() if losses else []
        hist["losses"].extend(epoch_losses)
        if epoch_losses:
            logging.info("Epoch[%d] Train-cross-entropy=%f", epoch,
                         epoch_losses[-1])
        logging.info("Epoch[%d] Time cost=%.3f", epoch, wall)
        record = {"epoch": epoch, "batches": nbatch, "wall_s": wall,
                  "images_per_s": nbatch * args.batch_size / wall
                  if wall > 0 else None}
        if args.model_prefix:
            # every rank: rank 0 writes, behind the trainer's barrier
            t0 = time.perf_counter()
            trainer.save_checkpoint(args.model_prefix, epoch + 1,
                                    save_optimizer_states=True)
            record["checkpoint"] = {"epoch": epoch + 1,
                                    "save_s": time.perf_counter() - t0}
        if val is not None:
            record["val"] = _validate(trainer, val, data_name, eval_metrics,
                                      epoch)
        hist["epochs"].append(record)
    hist["timings"] = timings
    hist["io"] = telemetry.ioview.summary()
    return trainer


def _validate(trainer, val, data_name, eval_metrics, epoch):
    """Each metric over ``val`` through ``trainer.forward`` (the padding
    of a last batch left out); logs and returns ``{name: value}``."""
    val.reset()
    for m in eval_metrics:
        m.reset()
    for batch in val:
        probs = trainer.forward({data_name: batch.data[0].data})[0]
        n_valid = probs.shape[0] - (batch.pad or 0)
        lab = NDArray(batch.label[0].data[:n_valid])
        for m in eval_metrics:
            m.update([lab], [NDArray(probs[:n_valid])])
    out = {}
    for m in eval_metrics:
        for name, value in zip(*_metric_get(m)):
            logging.info("Epoch[%d] Validation-%s=%f", epoch, name, value)
            out[name] = value
    return out


def fit(args, network, data_loader, **kwargs):
    """Train ``network`` (reference fit.py fit()).  Returns the trainer
    (fused route) or the Module.  Keyword arguments: ``history``, a dict
    the fused route fills; ``batch_end_callback``, added to the Module
    route's Speedometer."""
    kv = kvstore.create(args.kv_store)
    logging.info("start with arguments %s", args)

    train, val = data_loader(args, kv)
    if args.test_io:
        tic = time.time()
        for i, batch in enumerate(train):
            for j in batch.data:
                j.data.cpu()
            if (i + 1) % args.disp_batches == 0:
                logging.info("Batch [%d]\tSpeed: %.2f samples/sec", i,
                             args.disp_batches * args.batch_size /
                             (time.time() - tic))
                tic = time.time()
        return None

    if use_fused(args):
        return _fit_fused(args, network, train, val, kv,
                          kwargs.get("history"))

    if args.load_epoch and args.model_prefix:
        from ..model import load_checkpoint
        sym, arg_params, aux_params = load_checkpoint(args.model_prefix,
                                                      args.load_epoch)
    else:
        sym, arg_params, aux_params = network, None, None

    lr, lr_sched = _get_lr_scheduler(args, kv)
    ctxs = get_contexts(args)
    if isinstance(kwargs.get("history"), dict):
        kwargs["history"].update(route="module",
                                 context=",".join(str(c) for c in ctxs))
    model = Module(context=ctxs, symbol=sym)
    optimizer_params = {"learning_rate": lr, "wd": args.wd,
                        "lr_scheduler": lr_sched}
    if args.optimizer in ("sgd", "nag", "dcasgd"):
        optimizer_params["momentum"] = args.mom

    eval_metrics = ["accuracy"]
    if args.top_k > 0:
        eval_metrics.append(metric.create("top_k_accuracy",
                                          top_k=args.top_k))
    batch_end_callbacks = [callback.Speedometer(args.batch_size,
                                                args.disp_batches)]
    extra = kwargs.get("batch_end_callback")
    if extra is not None:
        batch_end_callbacks += extra if isinstance(extra, list) else [extra]
    checkpoint = None
    if args.model_prefix:
        checkpoint = callback.do_checkpoint(
            args.model_prefix if kv.rank == 0 else
            "%s-%d" % (args.model_prefix, kv.rank))
    monitor = None
    if args.monitor > 0:
        from ..monitor import Monitor
        monitor = Monitor(args.monitor, pattern=".*")

    model.fit(train, begin_epoch=args.load_epoch or 0,
              num_epoch=args.num_epochs, eval_data=val,
              eval_metric=eval_metrics, kvstore=kv,
              optimizer=args.optimizer, optimizer_params=optimizer_params,
              initializer=initializer.Xavier(
                  rnd_type="gaussian", factor_type="in", magnitude=2),
              arg_params=arg_params, aux_params=aux_params,
              batch_end_callback=batch_end_callbacks,
              epoch_end_callback=checkpoint, allow_missing=True,
              monitor=monitor)
    return model
