"""The port's ShardedTrainer on a small bottleneck ResNet (13 fused blocks, 4
on K5) against the JAX package's, NHWC, on the CPU; and chip_smoke's
ResNet phases at a small size.

Both trainers start from one state: the JAX trainer's params, momentum
slots and moving statistics are carried into the port's with
``convert.from_jax_trainer_state``.  Then one batch goes through five f32
SGD steps (momentum 0.9, weight decay 1e-4) of each.

Tolerances, relative 1e-4: the losses step by step, and the parameters and
the moving statistics each by the norm of their difference over all
tensors against the norm of the JAX state.  The momentum slots hold the
last updates alone, where another ReLU mask on a pre-activation within
rounding of 0 shows undiluted: the JAX package's own fused and unfused
trajectories differ there by 7e-4 to 1.2e-3 at this size, so the slots are
held to 1e-2.
"""
import os
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401  (xdist workers share the cores)
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from mxnet_tpu.models import resnet as jax_resnet  # noqa: E402
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer  # noqa: E402
from mxnet_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.convert import from_jax_trainer_state  # noqa: E402
from mxnet_tpu_torch.models import get_model, resnet  # noqa: E402
from mxnet_tpu_torch.ops.fused import matmul_stats  # noqa: E402
from mxnet_tpu_torch.parallel import ShardedTrainer, build_mesh  # noqa: E402

SMALL = dict(units=[1, 1, 1, 1], num_stages=4,
             filter_list=[16, 64, 128, 256, 512], num_classes=10,
             image_shape=[3, 32, 32])
BATCH = 4
STEPS = 5
SHAPES = dict(data_shapes={"data": (BATCH, 3, 32, 32)},
              label_shapes={"softmax_label": (BATCH,)})
SGD = dict(optimizer="sgd", learning_rate=0.1, momentum=0.9,
           weight_decay=1e-4)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"data": rng.uniform(-1, 1, (BATCH, 3, 32, 32))
            .astype(np.float32),
            "softmax_label": rng.randint(0, 10, BATCH).astype(np.float32)}


def _port(**kw):
    return ShardedTrainer(resnet.resnet(**SMALL),
                          build_mesh(devices=[tmx.cpu()]),
                          **SHAPES, **{**SGD, "layout": "NHWC", **kw})


def _jax_state(jt):
    return ({k: np.asarray(v) for k, v in jt.params.items()},
            {k: [np.asarray(s) for s in v] for k, v in jt.opt_state.items()},
            {k: np.asarray(v) for k, v in jt.aux.items()})


def _pair(fuse_blocks):
    """A JAX trainer and a port trainer carrying its state.  The JAX
    initializer draws from numpy's global generator, seeded here."""
    np.random.seed(0)
    jt = JaxTrainer(jax_resnet.resnet(**SMALL), jax_build_mesh(n_devices=1),
                    layout="NHWC", fuse_blocks=fuse_blocks, **SHAPES, **SGD)
    pt = _port(fuse_blocks=fuse_blocks, seed=1)   # another seed: carried
    params, slots, aux = _jax_state(jt)
    from_jax_trainer_state(pt, params, slots, aux=aux)
    return jt, pt


def _rel(got, want):
    a = np.concatenate([got[k].ravel() for k in sorted(want)])
    b = np.concatenate([want[k].ravel() for k in sorted(want)])
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("fuse_blocks", [True, False])
def test_five_sgd_steps_match_jax(fuse_blocks):
    jt, pt = _pair(fuse_blocks)
    batch = _batch()
    jl = [float(jt.step(batch)) for _ in range(STEPS)]
    pl = [float(pt.step(batch)) for _ in range(STEPS)]
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pl[-1] < pl[0]
    params, slots, aux = _jax_state(jt)
    assert _rel({k: v.numpy() for k, v in pt.params.items()}, params) \
        <= 1e-4
    assert _rel({k: v.numpy() for k, v in pt.aux.items()}, aux) <= 1e-4
    assert _rel({k: v[0].numpy() for k, v in pt.opt_state.items()},
                {k: v[0] for k, v in slots.items()}) <= 1e-2
    summary = pt.fusion_summary()
    if fuse_blocks:
        assert summary["blocks"] == 13 and summary["pallas_blocks"] == 4
    else:
        assert summary is None


def test_forward_matches_jax_in_inference():
    jt, pt = _pair(True)
    data = _batch(seed=1)["data"]
    want = np.asarray(jt.forward({"data": data})[0])
    got = pt.forward({"data": data})[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_moving_statistics_update_every_step():
    pt = _port(fuse_blocks=True)
    staged = pt.put_batch(_batch())
    for _ in range(2):
        before = {k: v.clone() for k, v in pt.aux.items()}
        pt.step(staged)
        assert all(not torch.equal(before[k], v)
                   for k, v in pt.aux.items())
        assert all(v.dtype == torch.float32 for v in pt.aux.values())


def test_put_batch_transposes_nchw_images():
    pt = _port()
    batch = _batch()
    staged = pt.put_batch(batch)
    assert staged["data"].shape == (BATCH, 32, 32, 3)
    np.testing.assert_array_equal(staged["data"].numpy(),
                                  batch["data"].transpose(0, 2, 3, 1))
    # a staged batch passes through unchanged
    again = pt.put_batch(staged)
    assert torch.equal(again["data"], staged["data"])


def test_compute_view_keeps_conv_weights_channels_last():
    pt = _port()
    view = pt._compute_view(pt.params)
    conv = view["stage1_unit1_conv2_weight"]
    assert conv.shape == pt.params["stage1_unit1_conv2_weight"].shape
    assert conv.is_contiguous(memory_format=torch.channels_last)


def test_carry_over_checks_aux_names_and_shapes():
    pt = _port()
    params = {k: v.numpy() for k, v in pt.params.items()}
    aux = {k: v.numpy() for k, v in pt.aux.items()}
    with pytest.raises(MXNetError, match="aux: names differ"):
        from_jax_trainer_state(pt, params, aux=dict(aux, extra=np.zeros(1)))
    name = "bn1_moving_mean"
    with pytest.raises(MXNetError, match="aux " + name):
        from_jax_trainer_state(pt, params, aux=dict(aux, **{
            name: np.zeros(3, np.float32)}))
    aux[name] = np.full(aux[name].shape, 0.25, np.float32)
    from_jax_trainer_state(pt, params, aux=aux)
    assert (pt.aux[name] == 0.25).all()


def test_nhwc_refuses_graphs_with_unadapted_axes():
    net = tmx.sym.slice_axis(resnet.resnet(**SMALL), axis=1, begin=0,
                             end=5)
    with pytest.raises(MXNetError, match="slice_axis"):
        ShardedTrainer(net, build_mesh(devices=[tmx.cpu()]), layout="NHWC",
                       data_shapes={"data": (BATCH, 3, 32, 32)})


def test_unsupported_layout_raises():
    with pytest.raises(MXNetError, match="unsupported layout"):
        _port(layout="NCWH")


def test_get_model_builds_the_resnet_and_refuses_others():
    net = get_model("resnet-18", num_classes=10, image_shape="3,32,32")
    assert "stage4_unit2_conv2_weight" in net.list_arguments()
    with pytest.raises(ValueError, match="unknown model"):
        get_model("squeezenet")


def test_chip_smoke_resnet_phases_on_cpu():
    """chip_smoke.py's resnet_train and resnet_train_check phases, as the
    card runs them, at batch 2 and 64x64 on the CPU (full depth)."""
    out = chip_smoke.resnet_train_phase(
        tmx.cpu(), batch=2, image=64, dtype="float32", steps=3,
        timed_steps=1, repeats=1, learning_rate=0.01)
    assert out["launches"] == {"matmul_stats": 0}
    assert out["fusion"]["blocks"] == 50
    assert len(out["losses"]) == 3 and "profile" not in out
    check = chip_smoke.resnet_train_check_phase(tmx.cpu(), batch=2,
                                                image=64)
    assert check["max_rel_update_diff"] == 0.0
    assert check["max_rel_aux_diff"] == 0.0
    assert check["compared"] == 157 + 102   # parameters, moving stats
    assert matmul_stats.launches == 0
