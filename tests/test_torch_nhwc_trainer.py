"""The port's ShardedTrainer in NHWC on graphs of every op of the JAX
trainer's NHWC set (``Concat(dim=1)``, ``LRN``, ``SliceChannel``, ``Pad``,
``UpSampling``, ``Crop``, ``InstanceNorm``, ``LeakyReLU``,
``SoftmaxActivation``, ``Deconvolution``) against the JAX trainer's, on the
CPU.

Both trainers start from one state (the JAX trainer's carried into the
port's with ``convert.from_jax_trainer_state``), then take five f32 SGD
steps on one batch.  Tolerances are ``test_torch_resnet_trainer.py``'s:
the losses step by step to 1e-4 relative, the parameters and the moving
statistics each by the norm of their difference against the norm of the
JAX state to 1e-4.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import build_mesh as jax_build_mesh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import from_jax_trainer_state
from mxnet_tpu_torch.parallel import ShardedTrainer, build_mesh

BATCH = 4
STEPS = 5
CLASSES = 5
SHAPES = dict(data_shapes={"data": (BATCH, 3, 12, 12)},
              label_shapes={"softmax_label": (BATCH,)})
SGD = dict(optimizer="sgd", learning_rate=0.05, momentum=0.9,
           weight_decay=1e-4)


def _conv_bn(sym, x, nf, name, kernel=(3, 3), pad=(1, 1)):
    x = sym.Convolution(x, num_filter=nf, kernel=kernel, pad=pad,
                        no_bias=True, name=name + "_conv")
    x = sym.BatchNorm(x, fix_gamma=False, name=name + "_bn")
    return sym.Activation(x, act_type="relu", name=name + "_relu")


def towers(sym):
    """Inception-style towers: two branches joined by ``Concat(dim=1)``,
    ``LRN``, ``SliceChannel`` over the channels, an edge ``Pad``."""
    data = sym.Variable("data")
    a = _conv_bn(sym, data, 8, "a", kernel=(1, 1), pad=(0, 0))
    b = _conv_bn(sym, data, 6, "b")
    x = sym.Concat(a, b, dim=1, name="cat")
    x = sym.LRN(x, nsize=3, alpha=1e-3, beta=0.75, knorm=2.0, name="lrn")
    p = sym.SliceChannel(x, num_outputs=2, axis=1, name="split")
    x = p[0] * p[1] + p[0]
    x = sym.Pad(x, mode="edge", pad_width=(0, 0, 0, 0, 1, 2, 2, 1),
                name="pad")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    name="pool")
    x = sym.FullyConnected(sym.Flatten(x), num_hidden=CLASSES, name="fc")
    return sym.SoftmaxOutput(x, name="softmax")


def decoder(sym):
    """``Deconvolution``, ``InstanceNorm``, ``LeakyReLU`` (prelu),
    ``UpSampling``, ``Crop`` against another activation, a constant
    ``Pad`` and ``SoftmaxActivation`` over the channels."""
    data = sym.Variable("data")
    x = _conv_bn(sym, data, 8, "enc")
    x = sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="avg",
                    name="down")
    x = sym.Deconvolution(x, num_filter=6, kernel=(4, 4), stride=(2, 2),
                          pad=(1, 1), no_bias=False, name="deconv")
    x = sym.InstanceNorm(x, name="inorm")
    x = sym.LeakyReLU(x, act_type="prelu", name="prelu")
    up = sym.UpSampling(x, scale=2, sample_type="nearest", num_args=1,
                        name="up")
    x = sym.Crop(up, x, num_args=2, center_crop=True, name="crop")
    x = sym.Pad(x, mode="constant", pad_width=(0, 0, 0, 0, 1, 1, 1, 1),
                constant_value=0.5, name="cpad")
    x = sym.SoftmaxActivation(x, mode="channel", name="chsoftmax")
    x = sym.FullyConnected(sym.Flatten(x), num_hidden=CLASSES, name="fc")
    return sym.SoftmaxOutput(x, name="softmax")


NETS = {"towers": towers, "decoder": decoder}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"data": rng.uniform(-1, 1, (BATCH, 3, 12, 12))
            .astype(np.float32),
            "softmax_label": rng.randint(0, CLASSES, BATCH)
            .astype(np.float32)}


def _jax_state(jt):
    return ({k: np.asarray(v) for k, v in jt.params.items()},
            {k: [np.asarray(s) for s in v] for k, v in jt.opt_state.items()},
            {k: np.asarray(v) for k, v in jt.aux.items()})


def _rel(got, want):
    a = np.concatenate([got[k].ravel() for k in sorted(want)])
    b = np.concatenate([want[k].ravel() for k in sorted(want)])
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("net", sorted(NETS))
def test_nhwc_trainer_builds_and_matches_jax(net):
    np.random.seed(0)
    jt = JaxTrainer(NETS[net](jmx.sym), jax_build_mesh(n_devices=1),
                    layout="NHWC", **SHAPES, **SGD)
    pt = ShardedTrainer(NETS[net](tmx.sym), build_mesh(devices=[tmx.cpu()]),
                        layout="NHWC", seed=1, **SHAPES, **SGD)
    params, slots, aux = _jax_state(jt)
    from_jax_trainer_state(pt, params, slots, aux=aux)
    batch = _batch()
    jl = [float(jt.step(batch)) for _ in range(STEPS)]
    pl = [float(pt.step(batch)) for _ in range(STEPS)]
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pl[-1] < pl[0]
    params, _slots, aux = _jax_state(jt)
    assert _rel({k: v.numpy() for k, v in pt.params.items()}, params) \
        <= 1e-4
    assert _rel({k: v.numpy() for k, v in pt.aux.items()}, aux) <= 1e-4


def test_nhwc_set_is_the_jax_trainers():
    from mxnet_tpu_torch.parallel import trainer
    assert trainer._NHWC_ADAPTED == JaxTrainer._NHWC_ADAPTED


@pytest.mark.parametrize("mode", ["edge", "reflect", "constant"])
def test_pad_nhwc_pads_the_spatial_axes(mode):
    """``Pad``'s NCHW pad_width on an NHWC activation pads H and W."""
    from mxnet_tpu_torch.ops.nn import image_layout
    from mxnet_tpu_torch.ops.registry import OpContext, get_op
    import torch
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 5, 4)
                         .astype(np.float32))
    op = get_op("Pad")
    attrs = op.parse_attrs({"mode": mode,
                            "pad_width": "(0, 0, 0, 0, 1, 2, 2, 1)"})
    want = op.fcompute(attrs, OpContext(), x)
    with image_layout("NHWC"):
        got = op.fcompute(attrs, OpContext(), x.permute(0, 2, 3, 1))
    assert torch.equal(got.permute(0, 3, 1, 2), want)
