"""LSTM + CTC sequence recognition on synthetic digit strips::

    python -m mxnet_tpu_torch.tools.lstm_ocr --epochs 10

The counterpart of ``examples/ctc/lstm_ocr.py`` (the reference's
``example/warpctc/lstm_ocr.py``): an LSTM reads a strip column by column
and ``CTCLoss`` aligns the unsegmented label sequence, through the Module
API.  Each digit paints a stripe at a position of its own in a band of
columns, so the task is learnable in seconds.  The example's sizes: 20
columns of 16 rows, 4 digits a strip (labels 1..10, 0 the CTC blank),
hidden 64; Adam.

It trains on ``gpu(0)`` unless ``--cpu 1`` and prints one JSON line: each
epoch's mean CTC loss and exact-match accuracy (greedy decode over the
training strips), each batch's wall, and on the card its name and
``nvidia-smi``'s name and power limit.
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np

__all__ = ["NUM_CLASSES", "SEQ_LEN", "NUM_LABEL", "FEAT", "gen_strip",
           "make_net", "greedy_decode", "train", "main"]

NUM_CLASSES = 10          # digits; CTC blank is class 0 => labels 1..10
SEQ_LEN = 20              # image columns / LSTM steps
NUM_LABEL = 4             # digits per strip
FEAT = 16                 # rows per column


def gen_strip(rng):
    """(SEQ_LEN, FEAT) image + NUM_LABEL digit labels in 1..10."""
    digits = rng.randint(0, NUM_CLASSES, NUM_LABEL)
    img = rng.rand(SEQ_LEN, FEAT).astype("f") * 0.1
    cols = SEQ_LEN // NUM_LABEL
    for i, d in enumerate(digits):
        band = img[i * cols:(i + 1) * cols]
        band[:, d:d + 6] += 1.0   # digit-dependent stripe position
    return img, digits + 1        # shift: 0 is the CTC blank


def make_net(num_hidden=64):
    """LSTMCell unrolled over the columns, FullyConnected to the classes,
    ``CTCLoss`` under ``MakeLoss``, the predictions (T, B, V) beside it
    under ``BlockGrad``."""
    from .. import rnn, symbol as sym
    from ..contrib import symbol as csym
    data = sym.Variable("data")          # (B, SEQ_LEN, FEAT)
    label = sym.Variable("label")        # (B, NUM_LABEL)
    cell = rnn.LSTMCell(num_hidden, prefix="lstm_")
    outputs, _ = cell.unroll(SEQ_LEN, inputs=data, merge_outputs=True,
                             layout="NTC")
    pred = sym.Reshape(outputs, shape=(-1, num_hidden))
    pred = sym.FullyConnected(pred, num_hidden=NUM_CLASSES + 1,
                              name="pred")
    pred = sym.Reshape(pred, shape=(-4, -1, SEQ_LEN, 0))
    pred = sym.transpose(pred, axes=(1, 0, 2))   # (T, B, V)
    loss = csym.CTCLoss(pred, label, name="ctc")
    return sym.Group([sym.MakeLoss(loss),
                      sym.BlockGrad(pred, name="pred_out")])


def greedy_decode(pred):
    """Collapse repeated argmaxes and drop blanks (class 0)."""
    seq = pred.argmax(-1)
    out = []
    for b in range(seq.shape[1]):
        prev, dec = -1, []
        for t in range(seq.shape[0]):
            c = int(seq[t, b])
            if c != prev and c != 0:
                dec.append(c)
            prev = c
        out.append(dec)
    return out


def train(epochs=5, batch_size=32, n_train=512, lr=0.01, ctx=None,
          arg_params=None, history=None):
    """The example's loop: strips from ``RandomState(0)``, an
    ``NDArrayIter`` shuffled once by numpy's global generator, Adam at
    ``lr``; after each epoch the exact-match accuracy over the training
    strips.  ``arg_params`` (name -> numpy) replaces the Xavier draw;
    ``history``, a dict, gets each epoch's loss and accuracy and each
    batch's wall.  Returns ``(module, last accuracy)``."""
    from .. import context, initializer, io, ndarray as nd
    from ..module import Module
    ctx = ctx or context.gpu(0)
    rng = np.random.RandomState(0)
    xs, ys = zip(*[gen_strip(rng) for _ in range(n_train)])
    x = np.stack(xs)
    y = np.stack(ys).astype("f")
    it = io.NDArrayIter({"data": x}, {"label": y}, batch_size=batch_size,
                        shuffle=True)
    mod = Module(make_net(), data_names=("data",),
                 label_names=("label",), context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer.Xavier(), arg_params=None if arg_params
                    is None else {k: nd.array(v, ctx=ctx)
                                  for k, v in arg_params.items()})
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": lr})
    hist = history if history is not None else {}
    hist.update(losses=[], accuracy=[], batch_ms=[])
    acc = 0.0
    for epoch in range(epochs):
        it.reset()
        losses = []
        for batch in it:
            t0 = time.perf_counter()
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            losses.append(float(mod.get_outputs()[0].asnumpy().mean()))
            hist["batch_ms"].append((time.perf_counter() - t0) * 1e3)
        it.reset()
        hit = tot = 0
        for batch in it:
            mod.forward(batch, is_train=False)
            dec = greedy_decode(mod.get_outputs()[1].asnumpy())
            labs = batch.label[0].asnumpy().astype(int)
            for d, lab in zip(dec, labs):
                tot += 1
                hit += int(d == [c for c in lab.tolist() if c > 0])
        acc = hit / max(tot, 1)
        hist["losses"].append(float(np.mean(losses)))
        hist["accuracy"].append(acc)
        logging.info("epoch %d ctc-loss %.3f exact-match %.3f", epoch,
                     np.mean(losses), acc)
    return mod, acc


def main(argv=None):
    import torch
    from .. import context
    from . import nvidia_smi
    p = argparse.ArgumentParser(description="LSTM+CTC OCR on digit strips")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--cpu", type=int, default=0,
                   help="1: train on the CPU instead of gpu(0)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.cpu:
        ctx = context.cpu()
    elif not torch.cuda.is_available():
        raise SystemExit("lstm_ocr: no CUDA device; pass --cpu 1 to train "
                         "on the CPU")
    else:
        ctx = context.gpu(0)
    np.random.seed(0)                 # the shuffle
    history = {}
    _mod, acc = train(epochs=args.epochs, batch_size=args.batch_size,
                      ctx=ctx, history=history)
    out = {"epochs": args.epochs, "batch_size": args.batch_size,
           "context": str(ctx), "exact_match": acc, **history}
    if ctx.device_type == "gpu":
        out.update(device=torch.cuda.get_device_name(0),
                   nvidia_smi=nvidia_smi())
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
