"""The port's ``DevicePrefetchIter`` on the semantics of the JAX package's
``tests/test_device_prefetch.py`` (order and epochs, reset mid-epoch,
errors, sticky exhaustion, payload kinds), its batches against the JAX
iterator's, a reset storm; and ``ShardedTrainer.put_batch`` of uint8 images
with ``input_mean``/``input_std`` against the JAX trainer's staging in f32
and bf16, exactly, with the fused fit's queue against inline staging."""
import argparse
import os
import sys
import threading

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer  # noqa: E402
from mxnet_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.parallel import ShardedTrainer, build_mesh  # noqa: E402
from mxnet_tpu_torch.tools import fit as pfit  # noqa: E402


def _iter(mod=tmx, n=24, batch=4):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    y = np.arange(n, dtype=np.float32)
    return mod.io.NDArrayIter(x, y, batch_size=batch,
                              label_name="softmax_label")


def _stage(host):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in host.items()}


def test_order_and_epochs():
    pre = tmx.io.DevicePrefetchIter(_iter(), _stage, depth=2)
    for epoch in range(3):
        got = [float(b["data"][0, 0]) for b in pre]
        assert got == [0.0, 12.0, 24.0, 36.0, 48.0, 60.0], (epoch, got)
        pre.reset()
    assert pre.timings["batches"] == 18


def test_batches_equal_the_jax_iterators():
    import jax.numpy as jnp
    got = [{k: np.asarray(v) for k, v in b.items()} for b in
           tmx.io.DevicePrefetchIter(_iter(n=22), _stage, depth=3)]
    want = [{k: np.asarray(v) for k, v in b.items()} for b in
            jmx.io.DevicePrefetchIter(
                _iter(jmx, n=22), lambda d: {k: jnp.asarray(v)
                                             for k, v in d.items()},
                depth=3)]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_reset_mid_epoch():
    pre = tmx.io.DevicePrefetchIter(_iter(), _stage, depth=2)
    next(pre)
    next(pre)
    pre.reset()          # the worker may be blocked on a full queue here
    got = [float(b["data"][0, 0]) for b in pre]
    assert got[0] == 0.0 and len(got) == 6, got


def test_worker_errors_reach_the_consumer():
    def bad_stage(host):
        raise RuntimeError("staging exploded")
    pre = tmx.io.DevicePrefetchIter(_iter(), bad_stage, depth=2)
    with pytest.raises(RuntimeError, match="staging exploded"):
        next(pre)
    with pytest.raises(StopIteration):
        next(pre)


def test_exhaustion_is_sticky():
    pre = tmx.io.DevicePrefetchIter(_iter(), _stage, depth=2)
    list(pre)
    with pytest.raises(StopIteration):
        next(pre)


def test_none_and_tuple_payloads():
    pre = tmx.io.DevicePrefetchIter(_iter(), lambda d: None, depth=2)
    assert list(pre) == [None] * 6
    pre2 = tmx.io.DevicePrefetchIter(_iter(), lambda d: ("x", d["data"]),
                                     depth=2)
    got = list(pre2)
    assert len(got) == 6 and all(g[0] == "x" for g in got)


def test_reset_reraises_an_unseen_worker_error():
    hits = []

    def flaky(d):
        hits.append(1)
        if len(hits) == 2:
            raise RuntimeError("corrupt record")
        return d
    pre = tmx.io.DevicePrefetchIter(_iter(), flaky, depth=1)
    next(pre)
    pre._thread.join(timeout=5)
    assert not pre._thread.is_alive(), "the worker never hit the failure"
    with pytest.raises(RuntimeError, match="corrupt record"):
        pre.reset()


def test_close_stops_the_worker():
    pre = tmx.io.DevicePrefetchIter(_iter(n=400), _stage, depth=2)
    next(pre)
    pre.close()
    assert not pre._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pre)


def test_tunnel_limited_backend_is_false():
    assert tmx.io.tunnel_limited_backend() is False


def test_reset_storm_keeps_order():
    """Resets at random points with a short switch interval: every epoch
    read to its end after a reset still starts at the first batch and
    keeps the order, and no worker is left running."""
    rng = np.random.RandomState(0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pre = tmx.io.DevicePrefetchIter(_iter(n=40, batch=2), _stage,
                                        depth=1)
        for _ in range(30):
            for _k in range(rng.randint(0, 5)):
                next(pre)
            pre.reset()
        got = [float(b["data"][0, 0]) for b in pre]
        assert got == [6.0 * i for i in range(20)]
        pre.close()
        assert threading.active_count() < 50
    finally:
        sys.setswitchinterval(old)


# ------------------------------------------------- uint8 staging
def _conv_net(mod):
    data = mod.sym.Variable("data")
    net = mod.sym.Convolution(data, num_filter=4, kernel=(3, 3), pad=(1, 1),
                              no_bias=True, name="conv")
    net = mod.sym.BatchNorm(net, name="bn")
    net = mod.sym.Activation(net, act_type="relu")
    net = mod.sym.Pooling(net, global_pool=True, kernel=(1, 1),
                          pool_type="avg")
    net = mod.sym.FullyConnected(mod.sym.Flatten(net), num_hidden=3,
                                 name="fc")
    return mod.sym.SoftmaxOutput(net, name="softmax")


MEAN = (123.68, 116.779, 103.939)
STD = (58.393, 57.12, 57.375)
SHAPES = dict(data_shapes={"data": (4, 3, 8, 8)},
              label_shapes={"softmax_label": (4,)})


def _trainers(dtype, layout, **kw):
    np.random.seed(0)
    jt = JaxTrainer(_conv_net(jmx), jax_build_mesh(n_devices=1), dtype=dtype,
                    layout=layout, **SHAPES, **kw)
    pt = ShardedTrainer(_conv_net(tmx), build_mesh(devices=[tmx.cpu()]),
                        dtype=dtype, layout=layout, **SHAPES, **kw)
    return jt, pt


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    return np.asarray(x.astype(np.float32) if x.dtype.name == "bfloat16"
                      else x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["nhwc_raw", "nchw_nhwc_trainer",
                                  "nchw_trainer", "nhwc_raw_nchw_trainer",
                                  "scalar_stats", "mean_only"])
def test_uint8_staging_equals_jax(dtype, case):
    """The staged batch equals the JAX trainer's.  A raw NHWC batch given
    to an NCHW trainer (the fit's fallback for graphs refused NHWC) is
    permuted on the device: it equals the JAX trainer's staging of the
    same bytes in NCHW, the layout the JAX route feeds it."""
    rng = np.random.RandomState(1)
    layout, kw = "NHWC", dict(input_mean=MEAN, input_std=STD)
    if case in ("nchw_trainer", "nhwc_raw_nchw_trainer"):
        layout = None
    elif case == "scalar_stats":
        kw = dict(input_mean=127.5, input_std=64.0)
    elif case == "mean_only":
        kw = dict(input_mean=MEAN)
    jt, pt = _trainers(dtype, layout, **kw)
    shape = (4, 8, 8, 3) if case.startswith("nhwc_raw") else (4, 3, 8, 8)
    batch = {"data": rng.randint(0, 256, shape).astype(np.uint8),
             "softmax_label": rng.randint(0, 3, 4).astype(np.float32)}
    jbatch = batch
    if case == "nhwc_raw_nchw_trainer":
        jbatch = dict(batch, data=batch["data"].transpose(0, 3, 1, 2))
    got = pt.put_batch(batch)
    want = jt.put_batch(jbatch)
    assert got["data"].dtype == getattr(torch, dtype)
    for k in batch:
        g, w = _as_numpy(got[k]), _as_numpy(want[k])
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w)
    # the staged uint8 batch trains as the JAX trainer's does
    np.testing.assert_allclose(float(pt.step(got)), float(jt.step(jbatch)),
                               rtol=1e-4 if dtype == "float32" else 2e-2)


def test_uint8_without_stats_and_other_uint8_inputs_pass_unchanged():
    rng = np.random.RandomState(2)
    x = rng.randint(0, 256, (4, 8, 8, 3)).astype(np.uint8)
    lab = rng.randint(0, 3, 4).astype(np.uint8)
    _jt, pt = _trainers("float32", "NHWC")
    staged = pt.put_batch({"data": x, "softmax_label": lab})
    assert staged["data"].dtype == torch.uint8
    np.testing.assert_array_equal(staged["data"].numpy(), x)
    _jt, pt = _trainers("float32", "NHWC", input_mean=MEAN, input_std=STD)
    staged = pt.put_batch({"data": x, "softmax_label": lab})
    assert staged["softmax_label"].dtype == torch.uint8
    np.testing.assert_array_equal(staged["softmax_label"].numpy(), lab)
    # a staged batch is not normalized twice; a raw one reaching the step
    # or the forward is
    again = pt._stage(staged)
    assert again is staged
    raw = {"data": torch.from_numpy(x),
           "softmax_label": torch.from_numpy(lab.astype(np.float32))}
    assert pt._stage(raw)["data"].dtype == torch.float32


def _mlp(mod):
    data = mod.sym.Variable("data")
    net = mod.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = mod.sym.Activation(net, act_type="relu")
    net = mod.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return mod.sym.SoftmaxOutput(net, name="softmax")


def test_fused_fit_queue_parity():
    """The port's fused fit trains the same with the queue on and off
    (JAX test_fused_fit_device_queue_parity, here to the bit)."""
    protos = np.random.RandomState(42).rand(10, 16).astype("f")

    def loader(args, kv):
        r = np.random.RandomState(0)
        y = r.randint(0, 10, 320)
        x = (protos[y] + r.randn(320, 16).astype("f") * 0.2).astype("f")
        return tmx.io.NDArrayIter(x, y.astype("f"), args.batch_size,
                                  label_name="softmax_label"), None

    weights, losses = {}, {}
    for queue in (0, 1):
        args = argparse.Namespace(
            network="mlp", num_layers=None, gpus=None, tpus=None, cpu=1,
            kv_store="local", num_epochs=2, lr=0.3, lr_factor=0.1,
            lr_step_epochs="", optimizer="sgd", mom=0.9, wd=1e-4,
            batch_size=32, disp_batches=0, model_prefix=None,
            load_epoch=None, top_k=0, data_nthreads=1, test_io=0,
            monitor=0, fused=1, dtype="float32", num_examples=320,
            device_queue=queue)
        history = {}
        trainer = pfit.fit(args, _mlp(tmx), loader, history=history)
        weights[queue] = trainer.params["fc1_weight"].numpy()
        losses[queue] = history["losses"]
        assert history["queue"] == bool(queue)
    assert len(losses[0]) == 20
    assert losses[0] == losses[1]
    np.testing.assert_array_equal(weights[0], weights[1])
