"""``Module.fit`` of the GPT LM on a permutation chain, on one NVIDIA GPU.

    python -m mxnet_tpu_torch.tools.module_fit            # one JSON line
    python -m mxnet_tpu_torch.tools.module_fit --lr 3e-3,1e-4 --support 64,256
    python -m mxnet_tpu_torch.tools.module_fit --batches 32 --trainer

``examples/transformer/train_lm.py``'s ``train()`` route at the repo's
benchmark width (vocab 16384, seq 1024, d_model 1024, 16 heads, 12 layers,
dropout 0.1, f32): ``Module(net, context=gpu(0)).fit`` for one epoch of
``--batches`` batches of 16 sequences, with Xavier, Adam at ``--lr``,
Perplexity and Speedometer.  ``--trainer`` also runs the f32
``ShardedTrainer`` (the fused step) from the same weights on the same
batches.  The data is a chain, next token = ``perm[token]``, where
``perm`` cycles ``--support`` tokens of the vocabulary among themselves
(the markov corpus of ``train_lm`` draws a (vocab, vocab) table, 2 GB at
this vocabulary).  One JSON line per (route, lr, support): each batch's
perplexity and time (the host clock after a synchronize), peak memory,
and the card's name and power limit.  It needs a CUDA device and fails
without one.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np

from . import nvidia_smi

__all__ = ["FULL", "BATCH", "BATCHES", "SUPPORT", "permutation_chain", "fit",
           "trainer_fit", "main"]

#: the benchmark configuration of the GPT LM (train_lm.py,
#: build_bench_trainer)
FULL = {"vocab": 16384, "seq": 1024, "d_model": 1024, "heads": 16,
        "layers": 12}
#: sequences a batch (build_bench_trainer's), batches in the epoch, and
#: the tokens the chain walks (on 64 the bigram is learned in 20 batches
#: at lr 3e-3; on 256 and 16384 it is not in 32)
BATCH = 16
BATCHES = 20
SUPPORT = 64
#: train_lm's gpt_symbol dropout; the seed of the chain, the weights and
#: the Dropout draws
DROPOUT = 0.1
SEED = 0


def permutation_chain(n_seq, seq, vocab, seed=0, support=256):
    """``(x, y)``: ``n_seq`` sequences of a fixed chain, next token =
    ``perm[token]``, from random start tokens (``RandomState(seed)``); y is
    x shifted by one.  ``perm`` is a permutation of the vocabulary that
    cycles ``support`` random tokens among themselves and fixes the rest,
    and the start tokens are among the ``support`` (at most the whole
    vocabulary), so the chain never leaves them."""
    rng = np.random.RandomState(seed)
    support = min(support, vocab)
    tokens = rng.choice(vocab, support, replace=False)
    perm = np.arange(vocab)
    perm[tokens] = tokens[rng.permutation(support)]
    toks = np.empty((n_seq, seq + 1), np.int64)
    toks[:, 0] = tokens[rng.randint(0, support, n_seq)]
    for t in range(seq):
        toks[:, t + 1] = perm[toks[:, t]]
    return toks[:, :-1].astype(np.float32), toks[:, 1:].astype(np.float32)


def _net_and_data(cfg, batch, batches, support):
    from ..models.gpt import gpt_symbol
    net = gpt_symbol(cfg["vocab"], cfg["seq"], cfg["d_model"], cfg["heads"],
                     cfg["layers"], dropout=DROPOUT)
    x, y = permutation_chain(batch * batches, cfg["seq"], cfg["vocab"],
                             seed=SEED, support=support)
    return net, x, y


def _clock(ctx):
    """A function that waits for ``ctx``'s device and returns the host
    clock."""
    import torch
    on_card = ctx.device_type == "gpu"

    def now():
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter()
    return now


def fit(ctx, cfg, batch=BATCH, batches=BATCHES, lr=3e-3, support=SUPPORT):
    """One epoch of ``Module.fit`` of the GPT at ``cfg`` on ``ctx`` over
    ``batches`` batches of the chain.  Returns the module, the iterator,
    each batch's perplexity (from its outputs, before its update), the time
    up to the end of the first batch (bind, the host's Xavier draws, the
    optimizer and one step) and each later batch's time in ms, and the
    whole fit's seconds."""
    from .. import Module, callback, init, io, metric, random
    net, x, y = _net_and_data(cfg, batch, batches, support)
    it = io.NDArrayIter(x, y, batch)
    now = _clock(ctx)
    per_batch, stamps = [], []

    def record(param):
        m = metric.Perplexity(None)
        m.update(param.locals["batch"].label,
                 param.locals["self"].get_outputs())
        per_batch.append(m.get()[1])
        stamps.append(now())

    random.seed(SEED)
    mod = Module(net, context=ctx)
    stamps.append(now())
    mod.fit(it, num_epoch=1, initializer=init.Xavier(rng=SEED),
            optimizer="adam", optimizer_params={"learning_rate": lr},
            eval_metric=metric.Perplexity(None),
            batch_end_callback=[record, callback.Speedometer(batch, 2)])
    now()
    return {"module": mod, "iter": it, "batch_perplexity": per_batch,
            "setup_and_first_batch_ms": (stamps[1] - stamps[0]) * 1e3,
            "batch_ms": [(b - a) * 1e3
                         for a, b in zip(stamps[1:], stamps[2:])],
            "fit_s": stamps[-1] - stamps[0]}


def trainer_fit(ctx, cfg, batch=BATCH, batches=BATCHES, lr=3e-3,
                support=SUPPORT):
    """``fit``'s epoch through the f32 ``ShardedTrainer`` instead: the same
    net, chain and Adam, the weights drawn as ``Module.init_params`` draws
    them (``Xavier(rng=SEED)`` in sorted name order), Dropout from the
    trainer's generator seeded with ``SEED``.  Returns each step's
    perplexity (exp of its loss, before its update) and the same times."""
    from .. import init
    from ..parallel import ShardedTrainer, build_mesh
    net, x, y = _net_and_data(cfg, batch, batches, support)
    shapes = {"data": (batch, cfg["seq"]),
              "softmax_label": (batch, cfg["seq"])}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    xavier = init.Xavier(rng=SEED)
    drawn = {}
    for name, shape in sorted(zip(net.list_arguments(), arg_shapes)):
        if name not in shapes:
            drawn[name] = np.zeros(shape, np.float32)
            xavier(init.InitDesc(name), drawn[name])

    def copy_drawn(desc, arr):
        arr[...] = drawn.pop(desc)

    now = _clock(ctx)
    stamps = [now()]
    trainer = ShardedTrainer(
        net, build_mesh(n_devices=1, devices=[ctx]), data_shapes=
        {"data": shapes["data"]}, label_shapes=
        {"softmax_label": shapes["softmax_label"]}, optimizer="adam",
        optimizer_params={"learning_rate": lr}, initializer=copy_drawn,
        dtype="float32", seed=SEED)
    per_batch = []
    for i in range(batches):
        rows = slice(i * batch, (i + 1) * batch)
        loss = trainer.step({"data": x[rows], "softmax_label": y[rows]})
        per_batch.append(math.exp(float(loss)))
        stamps.append(now())
    return {"trainer": trainer, "batch_perplexity": per_batch,
            "setup_and_first_batch_ms": (stamps[1] - stamps[0]) * 1e3,
            "batch_ms": [(b - a) * 1e3
                         for a, b in zip(stamps[1:], stamps[2:])],
            "fit_s": stamps[-1] - stamps[0]}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lr", default="3e-3",
                   help="Adam learning rates, comma-separated")
    p.add_argument("--support", default=str(SUPPORT),
                   help="tokens the chain walks, comma-separated")
    p.add_argument("--batches", type=int, default=BATCHES)
    p.add_argument("--trainer", action="store_true",
                   help="also run the f32 ShardedTrainer on each")
    return p.parse_args(argv)


def main(argv=None):
    import torch
    from .. import gpu
    a = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("module_fit: no CUDA device; this tool measures "
                         "the GPU")
    routes = [("module", fit)] + ([("trainer", trainer_fit)]
                                  if a.trainer else [])
    for lr in (float(v) for v in a.lr.split(",")):
        for support in (int(v) for v in a.support.split(",")):
            for route, run in routes:
                torch.cuda.reset_peak_memory_stats()
                out = run(gpu(0), FULL, BATCH, a.batches, lr, support)
                ppl = out["batch_perplexity"]
                print(json.dumps({
                    "metric": "module_fit", "route": route, "config": FULL,
                    "batch": BATCH, "lr": lr, "support": support,
                    "batch_perplexity": ppl, "fell": bool(ppl[-1] < ppl[0]),
                    "setup_and_first_batch_ms":
                        out["setup_and_first_batch_ms"],
                    "batch_ms": out["batch_ms"],
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                    "device": torch.cuda.get_device_name(0),
                    "nvidia_smi": nvidia_smi()}), flush=True)
                del out
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
