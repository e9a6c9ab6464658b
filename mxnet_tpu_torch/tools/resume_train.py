"""The preemption drill: ResNet-50 trained from JPEG records, preempted by
SIGTERM mid-epoch, and resumed from its checkpoint and iterator state.

    python -m mxnet_tpu_torch.tools.resume_train --data-train T.rec \\
        --prefix /tmp/ck/resnet --steps 10 --mode preempted --signal-after 4
    python -m mxnet_tpu_torch.tools.resume_train --data-train T.rec \\
        --prefix /tmp/ck/resnet --steps 10 --mode resumed

The training is ``tools.train_imagenet``'s fused route at full width:
ResNet-``--num-layers`` (1000 classes) in bf16, NHWC, block fusion (the 1x1
blocks on K5), batch ``--batch-size`` of ``--image`` pixels, SGD at lr
0.01 (a few classes of made records would drive the loss to 0 within the
drill at 0.1) halved every 4 updates (so a resumed run must continue the
update count), momentum 0.9, weight decay 1e-4, initial weights from seed
0; the records through the native pipeline (``ImageRecordIter(raw_uint8=
True, shuffle=True, rand_crop=True, rand_mirror=True)``, one decode
thread, so the record order is fixed) and a ``DevicePrefetchIter`` of
depth 2.  cuDNN runs its deterministic
algorithms.  Each step prints one JSON line: its loss, its labels, the
CRC32 of its uint8 pixels, its wall (fetch and step, synchronized by
reading the loss) and the drill's seconds at its end.  The modes:

* ``uninterrupted``: ``--steps`` steps;
* ``preempted``: ``install_preemption_handler(--prefix)``, then after step
  ``--signal-after`` the run waits for SIGTERM (from the caller), which,
  landing between steps, is served at once: the checkpoint at epoch
  ``--signal-after`` (the state after that step, its optimizer slots and
  the iterator's state at its end), and exit 0;
* ``resumed``: ``load_latest_checkpoint(--prefix,
  load_optimizer_states=True)`` and ``restore_data_iter``, then the steps
  after the checkpoint's up to ``--steps``; its last line holds the load's
  wall, the CRC32 of every loaded array against the manifest's, and the
  kernels' launches.

:func:`drill` runs a mode in this process (the caller's counts then count
its launches).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np
import torch

#: SGD's lr, and the updates after which the schedule halves it
LR = 0.01
LR_STEP = 4

__all__ = ["build_trainer", "records_iter", "batch_record", "drill",
           "state_crcs", "parser", "main"]


def build_trainer(args, ctx):
    from .. import lr_scheduler
    from ..models import get_model
    from ..parallel import ShardedTrainer, build_mesh
    from .io_train_bench import IMAGENET_MEAN, IMAGENET_STD
    net = get_model("resnet%d" % args.num_layers, num_classes=1000,
                    image_shape="3,%d,%d" % (args.image, args.image))
    return ShardedTrainer(
        net, build_mesh(devices=[ctx]),
        data_shapes={"data": (args.batch_size, 3, args.image, args.image)},
        label_shapes={"softmax_label": (args.batch_size,)},
        optimizer="sgd", learning_rate=LR, momentum=0.9,
        weight_decay=1e-4, seed=0,
        optimizer_params={"lr_scheduler": lr_scheduler.FactorScheduler(
            step=LR_STEP, factor=0.5)},
        dtype=args.dtype, layout="NHWC", fuse_blocks=True,
        input_mean=IMAGENET_MEAN, input_std=IMAGENET_STD)


def records_iter(args):
    """The drill's native iterator over ``--data-train``, at one decode
    thread: with more, the records' order is not fixed."""
    from .. import io
    return io.ImageRecordIter(
        path_imgrec=args.data_train,
        data_shape=(3, args.image, args.image),
        batch_size=args.batch_size, preprocess_threads=1,
        raw_uint8=True, shuffle=True, rand_crop=True, rand_mirror=True)


def batch_record(host):
    """The labels and the CRC32 of the uint8 pixels of a host batch."""
    pixels = host["data"]
    pixels = pixels.numpy() if hasattr(pixels, "numpy") else pixels
    labels = host["softmax_label"]
    labels = labels.numpy() if hasattr(labels, "numpy") else labels
    return {"labels": [int(v) for v in np.asarray(labels)],
            "pixels_crc32": zlib.crc32(np.ascontiguousarray(pixels)
                                       .tobytes()) & 0xFFFFFFFF}


def state_crcs(trainer):
    """CRC32 of every master, moving statistic and slot as the checkpoint
    files name them (f32 on the host), and ``meta:num_update``."""
    from ..resilience import array_crc32
    out = {"arg:%s" % k: array_crc32(v.detach().float().cpu().numpy())
           for k, v in trainer.params.items()}
    out.update({"aux:%s" % k: array_crc32(v.detach().float().cpu().numpy())
                for k, v in trainer.aux.items()})
    for k, slots in trainer.opt_state.items():
        for i, s in enumerate(slots):
            out["slot%d:%s" % (i, k)] = array_crc32(
                s.detach().float().cpu().numpy())
    out["meta:num_update"] = array_crc32(np.array(
        [trainer.optimizer.begin_num_update + trainer._step_count],
        np.int64))
    return out


def _emit(out, **fields):
    if out is not None:
        print(json.dumps(fields), file=out, flush=True)


def drill(args, ctx, out=sys.stdout, keep_trainer=False):
    """Run ``args.mode`` on ``ctx``; returns the steps' records, the
    kernels' launches over the steps and, by mode, the state's CRCs after
    step ``--state-after`` (uninterrupted) or the load's readings
    (resumed), and the walls of the trainer's build and of the whole
    drill; with ``keep_trainer`` the trainer too.  A preempted run
    exits at its checkpoint."""
    from .. import io, resilience
    from . import kernel_counts, zero_kernel_counts
    torch.backends.cudnn.deterministic = True
    t_start = time.perf_counter()
    trainer = build_trainer(args, ctx)
    result = {"mode": args.mode, "steps": [],
              "build_s": time.perf_counter() - t_start}
    first = 1
    if args.mode == "resumed":
        t0 = time.perf_counter()
        epoch = trainer.load_latest_checkpoint(args.prefix,
                                               load_optimizer_states=True)
        if ctx.device_type == "gpu":
            torch.cuda.synchronize()
        result["load_s"] = time.perf_counter() - t0
        if epoch is None:
            raise SystemExit("resume_train: no checkpoint under %r"
                             % args.prefix)
        manifest = resilience.verify_manifest(args.prefix, epoch)
        crcs = state_crcs(trainer)
        saved = {k: v["crc32"] for k, v in manifest["arrays"].items()}
        result.update(epoch=epoch, loaded_equal_saved=crcs == saved,
                      arrays=len(saved),
                      data_state=manifest["meta"]["data_state"]["state"])
        first = epoch + 1
    it = records_iter(args)

    def stage(host):
        rec = batch_record(host)
        return trainer.put_batch(host), rec

    source = io.DevicePrefetchIter(it, stage, depth=2)
    handler = None
    if args.mode == "preempted":
        handler = trainer.install_preemption_handler(args.prefix)
    # nothing stashed in the first two modes: this tracks the queue, whose
    # state the checkpoint records
    applied = trainer.restore_data_iter(source)
    if args.mode == "resumed":
        if applied is None:
            raise SystemExit("resume_train: the checkpoint carries no data "
                             "state")
        result["applied_state"] = applied["state"]
    zero_kernel_counts()
    try:
        for step in range(first, args.steps + 1):
            t0 = time.perf_counter()
            dev, rec = next(source)
            loss = float(trainer.step(dev))     # waits for the step
            now = time.perf_counter()
            rec.update(step=step, loss=loss, step_s=now - t0,
                       t_s=now - t_start)
            result["steps"].append(rec)
            _emit(out, **rec)
            if args.mode == "uninterrupted" and step == args.state_after:
                result["state_crcs"] = state_crcs(trainer)
            if handler is not None and step == args.signal_after:
                _emit(out, waiting_for_signal=True, step=step,
                      build_s=result["build_s"],
                      drill_s=time.perf_counter() - t_start)
                while not handler.pending:
                    time.sleep(0.005)
    finally:
        source.close()
        it.close()
    result["launches"] = kernel_counts()
    result["drill_s"] = time.perf_counter() - t_start
    if keep_trainer:
        result["trainer"] = trainer
    if args.mode == "preempted":
        raise SystemExit("resume_train: the run ended without a preemption")
    return result


def parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-train", required=True)
    p.add_argument("--prefix", required=True,
                   help="the checkpoint prefix (preempted, resumed)")
    p.add_argument("--mode", default="uninterrupted",
                   choices=("uninterrupted", "preempted", "resumed"))
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--signal-after", type=int, default=4,
                   help="preempted: wait for SIGTERM after this step")
    p.add_argument("--state-after", type=int, default=5,
                   help="uninterrupted: the state's CRCs after this step")
    p.add_argument("--num-layers", type=int, default=50)
    p.add_argument("--image", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--cpu", type=int, default=0)
    return p


def main(argv=None):
    from ..context import cpu, gpu
    args = parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("resume_train: no CUDA device; pass --cpu 1")
    os.makedirs(os.path.dirname(os.path.abspath(args.prefix)),
                exist_ok=True)
    result = drill(args, cpu() if args.cpu else gpu(0))
    print(json.dumps({k: v for k, v in result.items() if k != "steps"}),
          flush=True)
    return result


if __name__ == "__main__":
    main()
