"""Repeat the fused ImageNet fit and look into its validation accuracy.

    python -m mxnet_tpu_torch.tools.imagenet_val_probe --runs 6 \\
        [--reestimate-batches 32] [-- extra train_imagenet arguments]

Writes the record sets of chip_smoke's ``imagenet_train`` phase (4
learnable classes, 4096 train and 512 validation JPEGs of 256 px, from
``io_train_bench.make_class_rec``), then fits the full-width ResNet-50 v2
``--runs`` times with that phase's arguments (bf16, NHWC, block fusion,
batch 128, SGD lr 0.1 momentum 0.9, wd 1e-4, 2 epochs, the device queue),
numpy and torch seeded with the run's index before each.  The arguments
after ``--`` are appended to the phase's.  After each fit it prints one
JSON line: each epoch's validation (moving statistics, as the fit reports
it); the last epoch's validation again with each batch's own statistics;
the moving statistics re-estimated at the final weights from
``--reestimate-batches`` training batches
(``reestimate_moving_stats``: the graph's own momentum update, no weight
update) and the validation with them; how far the re-estimate moved
each moving statistic; and the last training losses.  Runs on the card
(``--cpu 1`` for the CPU, at ``--image`` and ``--batch-size`` small
enough for it).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from mxnet_tpu_torch import kvstore
from mxnet_tpu_torch.models import get_model
from mxnet_tpu_torch.tools import fit, train_imagenet
from mxnet_tpu_torch.tools.io_train_bench import make_class_rec

RECORDS = {"train": (4096, 0), "val": (512, 1)}


def _stage_inputs(trainer, b, labels):
    """One batch of a data iterator staged for the trainer's graph, with
    its labels or, where ``labels`` is False, zeros for them."""
    (label, shape), = trainer._label_shapes.items()
    lab = b.label[0].data if labels else \
        torch.zeros((b.data[0].shape[0],) + tuple(shape[1:]))
    return dict(trainer._stage({trainer._data_names[0]: b.data[0].data,
                                label: lab}))


def accuracy(trainer, it, batch_stats=False):
    """Top-1 accuracy over ``it`` (the padding of a last batch left out):
    through ``trainer.forward`` (the moving statistics), or with each
    batch's own statistics where ``batch_stats``."""
    it.reset()
    hit = n = 0
    with torch.no_grad():
        view = trainer._compute_view(trainer.params)
        for b in it:
            if batch_stats:
                probs = trainer._run_graph(
                    view, _stage_inputs(trainer, b, False), True)[0][0]
            else:
                probs = trainer.forward({trainer._data_names[0]:
                                         b.data[0].data})[0]
            k = probs.shape[0] - (b.pad or 0)
            lab = b.label[0].data[:k].to(probs.device).long()
            hit += int((probs[:k].argmax(1) == lab).sum())
            n += k
    return hit / n


def reestimate_moving_stats(trainer, it, batches):
    """The moving statistics re-estimated at the trainer's current weights:
    ``batches`` batches of ``it`` through the training graph, each folding
    its batch statistics in with the graph's own momentum update, with no
    weight update.  Returns the largest and the median relative change
    (mean absolute change over mean absolute value, per statistic) of the
    moving means and of the moving variances."""
    before = {k: v.clone() for k, v in trainer.aux.items()}
    it.reset()
    with torch.no_grad():
        view = trainer._compute_view(trainer.params)
        for i, b in enumerate(it):
            if i == batches:
                break
            _heads, upd = trainer._run_graph(
                view, _stage_inputs(trainer, b, True), True)
            for node in trainer._aux_nodes:
                if id(node) in upd:
                    trainer.aux[node.name].copy_(upd[id(node)])
    out = {}
    for kind in ("moving_mean", "moving_var"):
        rel = [float((trainer.aux[k] - v).abs().mean()
                     / (trainer.aux[k].abs().mean() + 1e-6))
               for k, v in before.items() if k.endswith(kind)]
        out[kind] = {"max_rel_change": max(rel),
                     "median_rel_change": float(np.median(rel))}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--runs", type=int, default=4)
    p.add_argument("--reestimate-batches", type=int, default=32)
    p.add_argument("--image", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--cpu", type=int, default=0)
    p.add_argument("extra", nargs="*")
    a = p.parse_args(argv)
    if not a.cpu and not torch.cuda.is_available():
        raise SystemExit("imagenet_val_probe: no CUDA device (--cpu 1 runs "
                         "on the CPU)")
    with tempfile.TemporaryDirectory() as workdir:
        recs = {}
        for name, (n, seed) in RECORDS.items():
            recs[name] = os.path.join(workdir, name + ".rec")
            make_class_rec(recs[name], n, seed=seed)
        argv = ["--network", "resnet", "--num-layers", "50",
                "--data-train", recs["train"], "--data-val", recs["val"],
                "--image-shape", "3,%d,%d" % (a.image, a.image),
                "--num-classes", "1000",
                "--data-nthreads", str(os.cpu_count() or 1),
                "--batch-size", str(a.batch_size), "--dtype", "bfloat16",
                "--fused", "1", "--num-epochs", "2", "--lr", "0.1",
                "--mom", "0.9", "--wd", "1e-4", "--top-k", "2",
                "--device-queue", "1", "--disp-batches", "0"] \
            + (["--cpu", "1"] if a.cpu else []) + list(a.extra)
        args = train_imagenet.parser().parse_args(argv)
        for run in range(a.runs):
            np.random.seed(run)
            torch.manual_seed(run)
            net = get_model("resnet", num_classes=1000, num_layers=50,
                            image_shape="3,%d,%d" % (a.image, a.image))
            history = {}
            trainer = fit.fit(args, net, train_imagenet.get_rec_iter,
                              history=history)
            train_it, val_it = train_imagenet.get_rec_iter(
                args, kvstore.create(args.kv_store))
            out = {"run": run, "extra": a.extra,
                   "val": [e["val"] for e in history["epochs"]],
                   "val_moving": accuracy(trainer, val_it),
                   "val_batch_stats": accuracy(trainer, val_it, True)}
            out["reestimation"] = reestimate_moving_stats(
                trainer, train_it, a.reestimate_batches)
            out["val_reestimated"] = accuracy(trainer, val_it)
            out["last_losses"] = history["losses"][-8:]
            print(json.dumps(out), flush=True)
            for it in (train_it, val_it):
                if hasattr(it, "close"):
                    it.close()
            del trainer


if __name__ == "__main__":
    main()
