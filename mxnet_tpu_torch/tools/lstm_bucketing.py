"""``BucketingModule.fit`` of the lstm_bucketing LSTM LM, on one NVIDIA GPU.

    python -m mxnet_tpu_torch.tools.lstm_bucketing --num-epochs 2
    python -m mxnet_tpu_torch.tools.lstm_bucketing --cpu --num-hidden 32 \\
        --num-embed 32 --vocab 200 --sentences 320 --num-epochs 2

The counterpart of ``examples/rnn/lstm_bucketing.py``, with its arguments
and defaults: 2 layers of ``LSTMCell`` (200 hidden, embedding 200) unrolled
per bucket (10, 20, 30, 40, 50, 60), batch 32, SGD at lr 0.01 with momentum
0 and wd 1e-5, ``Xavier(factor_type="in", magnitude=2.34)`` and
``Perplexity(invalid_label=0)``.  Each bucket binds its own executor with
``shared_module=`` the default bucket's, so all train one parameter set.
PTB is not in the repository, so the corpus is made from ``--seed`` at
``--vocab`` tokens (10000, PTB's vocabulary, by default): ``--sentences``
sentences of 2 to 60 tokens following a fixed successor chain that cycles
``SUPPORT`` (100) tokens of the vocabulary, so the embedding and the
200 x vocab head have the published widths and the text can be learned
(a model of the unigram alone reads a perplexity of 100); ``--data-dir``
is parsed as the example parses it and not read.
It runs on ``gpu(0)`` unless ``--cpu`` is given.  It prints one JSON
line: each epoch's train perplexity (over all its batches, each before
its update) and validation perplexity, each batch's bucket, time and
perplexity (the first batch's time holds the bind and the set-up), the
binds, the per-bucket time of
``forward_backward`` + ``update``, whether every bucket holds the same
parameter, gradient and optimizer objects, the peak of the memory the
fit allocated and, on the card, its name and power limit.
"""
from __future__ import annotations

import argparse
import json
import random
import time

import numpy as np

__all__ = ["BUCKETS", "START_LABEL", "INVALID_LABEL", "SENTENCES",
           "SUPPORT", "successor_corpus", "lstm_sym_gen",
           "sharing", "bucket_step_ms", "fit", "parse_args", "main"]

BUCKETS = [10, 20, 30, 40, 50, 60]
START_LABEL = 1
INVALID_LABEL = 0
#: the made corpus's sentences and the tokens its chain cycles
SENTENCES = 4000
SUPPORT = 100


def successor_corpus(n, vocab, support=SUPPORT, seed=0, min_len=2,
                     max_len=60):
    """``n`` sentences (lists of ids in ``[START_LABEL, vocab)``) of
    lengths drawn uniformly in ``[min_len, max_len]``; each starts at a
    random token of the chain and follows it: next = ``perm[token]``, where
    ``perm`` cycles ``support`` tokens of the vocabulary (all from
    ``RandomState(seed)``)."""
    rng = np.random.RandomState(seed)
    tokens = rng.choice(np.arange(START_LABEL, vocab), min(support, vocab -
                        START_LABEL), replace=False)
    succ = dict(zip(tokens.tolist(), np.roll(tokens, -1).tolist()))
    out = []
    for _ in range(n):
        t = int(tokens[rng.randint(len(tokens))])
        sent = [t]
        for _ in range(int(rng.randint(min_len, max_len + 1)) - 1):
            t = succ[t]
            sent.append(t)
        out.append(sent)
    return out


def lstm_sym_gen(vocab, num_hidden=200, num_embed=200, num_layers=2,
                 mx=None):
    """The example's ``sym_gen``: embedding, ``num_layers`` LSTMCells
    unrolled over the bucket's length, the vocab-wide head and
    SoftmaxOutput.  ``mx`` is the package that writes the graph (the port
    by default)."""
    if mx is None:
        import mxnet_tpu_torch as mx
    stack = mx.rnn.SequentialRNNCell()
    for i in range(num_layers):
        stack.add(mx.rnn.LSTMCell(num_hidden=num_hidden,
                                  prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=vocab,
                                 output_dim=num_embed, name="embed")
        stack.reset()
        outputs, _states = stack.unroll(seq_len, inputs=embed,
                                        merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=vocab,
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def sharing(mod):
    """Whether every bound bucket of ``mod`` holds the default bucket's
    parameter, gradient and auxiliary tensors (the same storage), its host
    parameter dicts and its optimizer and Updater objects."""
    default = mod._buckets[mod.default_bucket_key]
    ref = default._exec_group

    def ptrs(blocks):
        return [None if b[0] is None else b[0].data.data_ptr()
                for b in blocks]
    out = {"params": True, "grads": True, "aux": True, "host_params": True,
           "optimizer": True, "updater": True}
    for m in mod._buckets.values():
        g = m._exec_group
        out["params"] &= ptrs(g.param_arrays) == ptrs(ref.param_arrays)
        out["grads"] &= g.grad_arrays is not None and \
            ptrs(g.grad_arrays) == ptrs(ref.grad_arrays)
        out["aux"] &= ptrs(g.aux_arrays) == ptrs(ref.aux_arrays)
        out["host_params"] &= m.get_params()[0] is default.get_params()[0]
        out["optimizer"] &= m._optimizer is default._optimizer
        out["updater"] &= m._updater is default._updater
    return out


def bucket_step_ms(mod, batches, ctx, repeats=10):
    """Per bucket, the median ms of ``repeats`` ``forward_backward`` +
    ``update`` on a batch of that bucket (``batches``: bucket -> batch),
    timed by the host clock around a synchronize."""
    import torch
    on_card = ctx.device_type == "gpu"
    out = {}
    for key, batch in sorted(batches.items()):
        times = []
        for _ in range(repeats):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.forward_backward(batch)
            mod.update()
            if on_card:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[str(key)] = float(np.median(times))
    return out


def fit(ctx, vocab=10000, num_hidden=200, num_embed=200, num_layers=2,
        batch_size=32, num_epochs=2, lr=0.01, mom=0.0, wd=1e-5,
        optimizer="sgd", sentences=SENTENCES, seed=0,
        val_sentences=0, disp_batches=50):
    """``BucketingModule.fit`` as the example runs it, on ``ctx``, over
    ``sentences`` of :func:`successor_corpus` (``val_sentences`` more for
    validation); the global ``random`` and numpy generators, which the
    iterator shuffles with, and ``mx.random`` are seeded with
    ``seed``, the Xavier draws come from ``RandomState(seed)``.  Returns
    the module, the iterator and the run's record."""
    import torch
    import mxnet_tpu_torch as mx
    on_card = ctx.device_type == "gpu"

    def now():
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter()

    corpus = successor_corpus(sentences + val_sentences, vocab, SUPPORT,
                              seed)
    train_sent, val_sent = corpus[:sentences], corpus[sentences:]
    random.seed(seed)
    np.random.seed(seed)
    mx.random.seed(seed)
    data_train = mx.rnn.BucketSentenceIter(
        train_sent, batch_size, buckets=list(BUCKETS),
        invalid_label=INVALID_LABEL)
    data_val = mx.rnn.BucketSentenceIter(
        val_sent, batch_size, buckets=list(BUCKETS),
        invalid_label=INVALID_LABEL) if val_sent else None
    model = mx.mod.BucketingModule(
        sym_gen=lstm_sym_gen(vocab, num_hidden, num_embed, num_layers),
        default_bucket_key=data_train.default_bucket_key, context=ctx)

    batches, epochs, firsts, sums = [], [], {}, [0.0, 0]
    binds0 = mx.Executor.binds
    stamps = [now()]

    def record(param):
        # each batch's own perplexity, from its outputs before its update,
        # and the epoch's over all of its batches (Speedometer resets the
        # fit's metric at every report)
        batch = param.locals["batch"]
        m = mx.metric.Perplexity(INVALID_LABEL)
        m.update(batch.label, param.locals["self"].get_outputs())
        sums[0] += m.sum_metric
        sums[1] += m.num_inst
        stamps.append(now())
        firsts.setdefault(batch.bucket_key, batch)
        batches.append({"epoch": param.epoch, "nbatch": param.nbatch,
                        "bucket": batch.bucket_key,
                        "ms": (stamps[-1] - stamps[-2]) * 1e3,
                        "perplexity": m.get()[1]})

    def end_epoch(epoch, _sym, _args, _aux):
        epochs.append({"epoch": epoch,
                       "train_perplexity": float(np.exp(sums[0] / sums[1])),
                       "binds_so_far": mx.Executor.binds - binds0,
                       "s": time.perf_counter() - stamps[0]})
        sums[:] = [0.0, 0]

    def end_score(param):
        # the validation that follows each epoch's end
        epochs[-1]["validation_perplexity"] = param.eval_metric.get()[1]

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated() if on_card else None
    model.fit(
        train_data=data_train, eval_data=data_val,
        eval_metric=mx.metric.Perplexity(INVALID_LABEL),
        kvstore="device", optimizer=optimizer,
        optimizer_params={"learning_rate": lr, "momentum": mom, "wd": wd},
        initializer=mx.init.Xavier(factor_type="in", magnitude=2.34,
                                   rng=seed),
        num_epoch=num_epochs, epoch_end_callback=end_epoch,
        eval_end_callback=end_score,
        batch_end_callback=[record, mx.callback.Speedometer(batch_size,
                                                             disp_batches)])
    fit_s = now() - stamps[0]
    # the peak of what this fit allocated, apart from what was allocated
    # before it (a caller's earlier tensors)
    peak = torch.cuda.max_memory_allocated() - start_mem if on_card \
        else None
    binds = mx.Executor.binds - binds0
    n_params = sum(int(v.size) for v in model.get_params()[0].values())
    record_out = {
        "config": {"vocab": vocab, "num_hidden": num_hidden,
                   "num_embed": num_embed, "num_layers": num_layers,
                   "batch_size": batch_size, "buckets": BUCKETS},
        "context": str(ctx), "optimizer": optimizer, "lr": lr,
        "momentum": mom, "wd": wd, "seed": seed, "params": n_params,
        "sentences": len(train_sent), "support": SUPPORT,
        "batches_per_epoch": len(data_train.idx),
        "epochs": epochs, "batches": batches, "fit_s": fit_s,
        "setup_and_first_batch_ms": batches[0]["ms"],
        "binds": binds, "buckets_bound": sorted(model._buckets),
        "sharing": sharing(model), "peak_mem_bytes_fit": peak,
        "mem_bytes_before_fit": start_mem}
    binds_before = mx.Executor.binds
    record_out["bucket_step_ms"] = bucket_step_ms(model, firsts, ctx)
    record_out["binds_while_timing"] = mx.Executor.binds - binds_before
    return model, data_train, record_out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train an LSTM LM with BucketingModule (lstm_bucketing)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--data-dir", type=str, default="data/ptb/",
                   help="parsed as the example parses it; not read (PTB "
                   "is not in the repository)")
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--num-hidden", type=int, default=200)
    p.add_argument("--num-embed", type=int, default=200)
    p.add_argument("--gpus", type=str,
                   help="the card to train on (one; default 0)")
    p.add_argument("--kv-store", type=str, default="device")
    p.add_argument("--num-epochs", type=int, default=25)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--optimizer", type=str, default="sgd")
    p.add_argument("--mom", type=float, default=0.0)
    p.add_argument("--wd", type=float, default=0.00001)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--disp-batches", type=int, default=50)
    p.add_argument("--stack-rnn", default=False, action="store_true",
                   help="parsed as the example parses it; not used there")
    p.add_argument("--bidirectional", default=False, action="store_true",
                   help="parsed as the example parses it; not used there")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vocab", type=int, default=10000,
                   help="the made corpus's vocabulary")
    p.add_argument("--sentences", type=int, default=SENTENCES,
                   help="the made corpus's training sentences")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU instead of gpu(0)")
    return p.parse_args(argv)


def main(argv=None):
    import logging
    import torch
    import mxnet_tpu_torch as mx
    from . import nvidia_smi
    a = parse_args(argv)
    if a.stack_rnn or a.bidirectional:
        raise SystemExit("lstm_bucketing: --stack-rnn and --bidirectional "
                         "are parsed by the example and used by neither")
    if a.kv_store not in ("device", "local"):
        raise SystemExit("lstm_bucketing: one device takes no kvstore; "
                         "got --kv-store %s" % a.kv_store)
    logging.basicConfig(level=logging.INFO)
    if a.cpu:
        ctx = mx.cpu()
    else:
        if not torch.cuda.is_available():
            raise SystemExit("lstm_bucketing: no CUDA device; pass --cpu "
                             "to train on the CPU")
        gpus = [int(i) for i in (a.gpus or "0").split(",")]
        if len(gpus) != 1:
            raise SystemExit("lstm_bucketing: one card; several are ROADMAP "
                             "Queue A item 4")
        ctx = mx.gpu(gpus[0])
    _model, _it, out = fit(
        ctx, a.vocab, a.num_hidden, a.num_embed, a.num_layers, a.batch_size,
        a.num_epochs, a.lr, a.mom, a.wd, a.optimizer, a.sentences, a.seed,
        val_sentences=a.sentences // 10, disp_batches=a.disp_batches)
    out["corpus"] = "successor chain"
    if ctx.device_type == "gpu":
        out["device"] = torch.cuda.get_device_name(ctx.device_id)
        out["nvidia_smi"] = nvidia_smi()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
