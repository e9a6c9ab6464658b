"""One rank of the port's distributed-kvstore jobs on the CPU (gloo), run
under ``mxnet_tpu_torch/tools/launch.py`` by ``test_torch_dist_kvstore.py``
and ``test_torch_async_kvstore.py``.

    python tests/torch_dist_kvstore.py sync OUT
    python tests/torch_dist_kvstore.py async OUT

``sync``: a ``dist_sync`` store's pushes (two local values a key, a key
of 1.2M entries among them) summed across the ranks, with the store's
collective count around each push; the updater's step; ``save_state`` and
``load_state``; then ``Module.fit`` of :func:`mlp` from :func:`init` on
this rank's rows of :func:`data`, with ``MXNET_TPU_OVERLAP`` off and
on; then ``tools.fit`` with ``--kv-store dist_sync`` (:func:`fit_args`),
the Module route and the fused route (``ShardedTrainer`` on the job's
data axis).  ``async``: ``Module.fit`` with ``dist_async`` and DCASGD; each
rank records what it sends (the optimizer's pickle, the initial values,
every gradient by its CRC32) and rank 0, which hosts the server, records
the order the server applied the pushes in (by the same CRC32, from a
recording subclass of the server) and its final weights.  Results: ``OUT/*.rank<r>``.
"""
import json
import os
import pickle
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.parallel import multihost  # noqa: E402

LOCAL = 8          # rows a rank a batch
KEYS = {3: (4, 5), "w": (1200000,), 7: (2, 3)}


def mlp(sym):
    x = sym.Variable("data")
    x = sym.FullyConnected(x, num_hidden=16, name="fc1")
    x = sym.Activation(x, act_type="relu", name="relu1")
    x = sym.FullyConnected(x, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(x, name="softmax")


def data(n=2 * LOCAL * 4):
    """Four global batches of a separable four-class problem."""
    rng = np.random.RandomState(0)
    y = rng.randint(0, 4, n).astype(np.float32)
    x = rng.randn(n, 12).astype(np.float32)
    x[:, :4] += 2 * np.eye(4, dtype=np.float32)[y.astype(int)]
    return x, y


def init():
    """The MLP's initial parameters."""
    rng = np.random.RandomState(1)
    return {"fc1_weight": rng.randn(16, 12).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": rng.randn(4, 16).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(4, np.float32)}


def rank_values(r):
    """The values rank ``r`` pushes: two a key."""
    rng = np.random.RandomState(100 + r)
    return {k: [rng.randn(*s).astype(np.float32) for _ in range(2)]
            for k, s in KEYS.items()}


def local_rows(x, r, world):
    """Rank ``r``'s rows of each global batch of ``world * LOCAL``."""
    g = LOCAL * world
    return np.concatenate([x[i + r * LOCAL:i + (r + 1) * LOCAL]
                           for i in range(0, len(x), g)])


def fit(kv, optimizer, opt_params):
    r, world = kv.rank, kv.num_workers
    x, y = data()
    it = mx.io.NDArrayIter(local_rows(x, r, world),
                           local_rows(y, r, world), LOCAL)
    mod = mx.mod.Module(mlp(mx.sym), context=mx.cpu())
    mod.fit(it, num_epoch=1, kvstore=kv, optimizer=optimizer,
            optimizer_params=opt_params,
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in init().items()})
    args, _aux = mod.get_params()
    return {k: v.asnumpy().copy() for k, v in args.items()}


def fit_args(add_fit_args, fused, batch, *extra):
    """The fit CLI's arguments for the MLP (either package's parser)."""
    import argparse
    parser = argparse.ArgumentParser()
    add_fit_args(parser)
    return parser.parse_args([
        "--kv-store", "dist_sync", "--num-epochs", "1", "--lr", "0.1",
        "--batch-size", str(batch), "--disp-batches", "100",
        "--lr-step-epochs", "", "--fused", str(fused), *extra])


def fit_loader(args, kv):
    """``tools.fit``'s data loader: this worker's part of every global
    batch (the ``num_parts``/``part_index`` split of the record readers)."""
    x, y = data()
    return mx.io.NDArrayIter(local_rows(x, kv.rank, kv.num_workers),
                             local_rows(y, kv.rank, kv.num_workers),
                             args.batch_size), None


def fit_tool(out, r):
    from mxnet_tpu_torch.tools import fit as pfit
    for fused in (0, 1):
        history = {}
        res = pfit.fit(fit_args(pfit.add_fit_args, fused, LOCAL, "--cpu",
                                "1"),
                       mlp(mx.sym), fit_loader, history=history)
        if fused:
            params = {k: v.numpy() for k, v in res.params.items()}
            params["losses"] = np.array([float(v)
                                         for v in history["losses"]])
        else:
            args, _aux = res.get_params()
            params = {k: v.asnumpy().copy() for k, v in args.items()}
        np.savez(os.path.join(out, "tool-fused%d.rank%d.npz" % (fused, r)),
                 **params)


def sync(out):
    r = multihost.rank()
    kv = mx.kv.create("dist_sync")
    mine = rank_values(r)
    doc = {"rank": kv.rank, "num_workers": kv.num_workers,
           "type": kv.type}
    for k, s in KEYS.items():
        kv.init(k, mx.nd.zeros(s, ctx=mx.cpu()))
    keys = list(KEYS)
    before = kv.collectives
    kv.push(keys, [[mx.nd.array(v, ctx=mx.cpu()) for v in mine[k]]
                   for k in keys])
    doc["collectives_a_push"] = kv.collectives - before
    outs = [mx.nd.zeros(KEYS[k], ctx=mx.cpu()) for k in keys]
    kv.pull(keys, outs)
    np.savez(os.path.join(out, "sums.rank%d.npz" % r),
             **{str(k): o.asnumpy() for k, o in zip(keys, outs)})
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5,
                                         rescale_grad=0.25))
    before = kv.collectives
    kv.push(keys, [[mx.nd.array(v, ctx=mx.cpu()) for v in mine[k]]
                   for k in keys])
    doc["collectives_an_update"] = kv.collectives - before
    kv.pull(keys, outs)
    np.savez(os.path.join(out, "updated.rank%d.npz" % r),
             **{str(k): o.asnumpy() for k, o in zip(keys, outs)})
    prefix = os.path.join(out, "kvstate")
    kv.save_state(prefix, 1)
    fresh = mx.kv.create("dist_sync")
    doc["loaded_world"] = fresh.load_state(prefix, 1)
    doc["loaded_equal"] = all(
        np.array_equal(fresh._store[k].asnumpy(), o.asnumpy())
        for k, o in zip(keys, outs))
    for overlap in (0, 1):
        os.environ["MXNET_TPU_OVERLAP"] = str(overlap)
        os.environ["MXNET_TPU_BUCKET_BYTES"] = "256"
        store = mx.kv.create("dist_sync")
        doc["overlap_active%d" % overlap] = store.overlap_active
        params = fit(store, "sgd",
                     {"learning_rate": 0.1, "momentum": 0.9})
        np.savez(os.path.join(out, "fit-overlap%d.rank%d.npz"
                              % (overlap, r)), **params)
    fit_tool(out, r)
    with open(os.path.join(out, "sync.rank%d.json" % r), "w") as f:
        json.dump(doc, f)


def sharded_servers(out, r):
    """Two parameter servers (one in each rank) with a bigarray bound of
    100 entries: the 1000-entry key is sliced across both, the small one
    hashed to one; SGD at lr 1 on the servers, integer-valued gradients
    (so the sums are exact in any order)."""
    env = {"MXNET_TPU_NUM_SERVERS": "2",
           "MXNET_KVSTORE_BIGARRAY_BOUND": "100",
           "MXNET_TPU_ASYNC_PORT": os.environ["DIST_TEST_SHARDED_PORT"]}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        kv = mx.kv.create("dist_async")
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=1.0,
                                             rescale_grad=1.0))
        kv.init(["big", "small"], [mx.nd.zeros((10, 100), ctx=mx.cpu()),
                                   mx.nd.zeros((3,), ctx=mx.cpu())])
        kv.push(["big", "small"],
                [mx.nd.array(np.full((10, 100), r + 1.0), ctx=mx.cpu()),
                 mx.nd.array(np.arange(3.0) * (r + 1), ctx=mx.cpu())])
        kv.barrier()
        outs = [mx.nd.zeros((10, 100), ctx=mx.cpu()),
                mx.nd.zeros((3,), ctx=mx.cpu())]
        kv.pull(["big", "small"], outs)
        np.savez(os.path.join(out, "sharded.rank%d.npz" % r),
                 big=outs[0].asnumpy(), small=outs[1].asnumpy())
        stats = kv.server_stats()
        kv.barrier()
        kv.close()
        return stats
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def recording_server(async_kvstore):
    """A ``ParameterServer`` that records ``(key, CRC32 of the
    gradient)`` as it applies each push (its updater runs under the
    server's lock, so ``applied`` is the order of the updates)."""

    class RecordingServer(async_kvstore.ParameterServer):
        def __init__(self, *args, **kw):
            self.applied = []
            super().__init__(*args, **kw)

        @property
        def _updater(self):
            return self.__dict__.get("_recorded_updater")

        @_updater.setter
        def _updater(self, fn):
            if fn is not None:
                inner = fn

                def fn(key, grad, weight):
                    self.applied.append((key, zlib.crc32(
                        np.ascontiguousarray(grad.asnumpy()).tobytes())))
                    return inner(key, grad, weight)
            self.__dict__["_recorded_updater"] = fn

    return RecordingServer


def async_(out):
    from mxnet_tpu_torch.parallel import async_kvstore
    r = multihost.rank()
    sharded = sharded_servers(out, r)
    sent = {"init": {}, "grads": {}}
    store_cls = async_kvstore.AsyncKVStore
    orig_init, orig_send = store_cls.init, store_cls._send_push
    orig_set_opt = store_cls.set_optimizer

    def init(self, key, value):
        keys = key if isinstance(key, (list, tuple)) else [key]
        vals = value if isinstance(key, (list, tuple)) else [value]
        for k, v in zip(keys, vals):
            sent["init"][str(k)] = v.asnumpy().copy()
        return orig_init(self, key, value)

    def send(self, k, merged):
        sent["grads"][str(zlib.crc32(
            np.ascontiguousarray(merged).tobytes()))] = merged.copy()
        return orig_send(self, k, merged)

    def set_optimizer(self, optimizer):
        import copy
        o = copy.copy(optimizer)
        o.sym = None
        sent["optimizer"] = pickle.dumps(o, protocol=4)
        return orig_set_opt(self, optimizer)

    store_cls.init, store_cls._send_push = init, send
    store_cls.set_optimizer = set_optimizer
    async_kvstore.ParameterServer = recording_server(async_kvstore)
    kv = mx.kv.create("dist_async")
    assert isinstance(kv, store_cls), type(kv)
    fit(kv, "dcasgd", {"learning_rate": 0.1, "momentum": 0.9,
                            "lamda": 0.04})
    kv.barrier()
    doc = {"type": kv.type, "stats": kv.server_stats(),
           "sharded_stats": sharded}
    if kv._server is not None:
        srv = kv._server
        with srv._lock:
            doc["push_log"] = [[str(k), c] for k, c in srv.applied]
            final = {str(k): v.asnumpy() for k, v in srv._store.items()}
        np.savez(os.path.join(out, "server.npz"), **final)
    kv.barrier()
    with open(os.path.join(out, "sent.rank%d.pkl" % r), "wb") as f:
        pickle.dump(sent, f, protocol=4)
    with open(os.path.join(out, "async.rank%d.json" % r), "w") as f:
        json.dump(doc, f)
    kv.close()


if __name__ == "__main__":
    multihost.ensure_initialized()
    {"sync": sync, "async": async_}[sys.argv[1]](sys.argv[2])
