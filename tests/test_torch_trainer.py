"""The port's ShardedTrainer against the JAX package's, on a small GPT
(vocab 64, seq 128, d_model 32, 2 heads, 2 layers) on the CPU.

Both trainers start from one state: the JAX trainer's params and optimizer
slots are carried into the port's with ``convert.from_jax_trainer_state``.
Then the same batch goes through five steps of each.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples", "transformer"))

import train_lm  # noqa: E402
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer  # noqa: E402
from mxnet_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.convert import from_jax_trainer_state  # noqa: E402
from mxnet_tpu_torch.models import gpt  # noqa: E402
from mxnet_tpu_torch.parallel import ShardedTrainer, build_mesh  # noqa: E402

SMALL = dict(vocab_size=64, seq_len=128, d_model=32, n_heads=2, n_layers=2)
BATCH = 2
STEPS = 5


def _batch(vocab=64, seq=128, batch=BATCH, seed=0):
    x = np.random.RandomState(seed).randint(0, vocab, (batch, seq)) \
        .astype(np.float32)
    return {"data": x, "softmax_label": np.roll(x, -1, 1).copy()}


def _shapes(seq=128, batch=BATCH):
    return dict(data_shapes={"data": (batch, seq)},
                label_shapes={"softmax_label": (batch, seq)})


def _port(optimizer="sgd", dtype="float32", seed=0, dropout=0.0,
          small=SMALL, **kw):
    return ShardedTrainer(gpt.gpt_symbol(dropout=dropout, **small),
                          build_mesh(devices=[tmx.cpu()]),
                          optimizer=optimizer, dtype=dtype, seed=seed,
                          **_shapes(small["seq_len"]), **kw)


def _pair(optimizer, **kw):
    """A JAX trainer and a port trainer carrying its state.  The JAX
    initializer draws from numpy's global generator, seeded here so that
    every run starts from the same weights."""
    np.random.seed(0)
    jt = JaxTrainer(train_lm.gpt_symbol(dropout=0.0, **SMALL),
                    jax_build_mesh(n_devices=1), optimizer=optimizer,
                    **_shapes(), **kw)
    pt = _port(optimizer, seed=1, **kw)      # another seed: carried over
    from_jax_trainer_state(
        pt, {k: np.asarray(v) for k, v in jt.params.items()},
        {k: [np.asarray(s) for s in v] for k, v in jt.opt_state.items()})
    return jt, pt


def _run(jt, pt, batch):
    return ([float(jt.step(batch)) for _ in range(STEPS)],
            [float(pt.step(batch)) for _ in range(STEPS)])


def test_five_sgd_momentum_steps_match_jax():
    """f32 SGD with momentum: the same arithmetic, summed in another order
    by another library, so losses and params agree to float rounding."""
    jt, pt = _pair("sgd", learning_rate=0.01, momentum=0.9)
    batch = _batch()
    want = [np.asarray(h) for h in jt.forward({"data": batch["data"]})]
    got = pt.forward({"data": batch["data"]})
    np.testing.assert_allclose(got[0].numpy(), want[0], 1e-4, 1e-6)
    jl, pl = _run(jt, pt, batch)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]
    for k, v in jt.params.items():
        np.testing.assert_allclose(pt.params[k].numpy(), np.asarray(v),
                                   1e-4, 1e-5, err_msg=k)
        np.testing.assert_allclose(pt.opt_state[k][0].numpy(),
                                   np.asarray(jt.opt_state[k][0]),
                                   1e-4, 1e-5, err_msg=k)


def test_five_adam_steps_match_jax():
    """Adam: losses to float rounding.  Params likewise, except the key
    third of each qkv bias.  Its true gradient is 0 (a key bias shifts a
    query's scores by one constant, which softmax removes), so both
    packages see rounding noise there, and Adam scales noise of any size to
    steps of about lr: those entries are held only to lr per step."""
    lr = 1e-3
    jt, pt = _pair("adam", learning_rate=lr)
    jl, pl = _run(jt, pt, _batch())
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    d = SMALL["d_model"]
    for k, v in jt.params.items():
        got, want = pt.params[k].numpy(), np.asarray(v)
        if k.endswith("_qkv_bias"):
            assert np.abs(got[d:2 * d] - want[d:2 * d]).max() \
                <= 2 * lr * STEPS
            got, want = np.delete(got, np.s_[d:2 * d]), \
                np.delete(want, np.s_[d:2 * d])
        np.testing.assert_allclose(got, want, 1e-4, 1e-5, err_msg=k)


def test_run_steps_equals_k_steps():
    batch = _batch(seed=3)
    a, b = _port("adam", learning_rate=1e-3), _port("adam",
                                                    learning_rate=1e-3)
    staged = a.put_batch(batch)
    losses = a.run_steps(staged, 3)
    assert losses.shape == (3,)
    one_by_one = torch.stack([b.step(batch) for _ in range(3)])
    assert torch.equal(losses, one_by_one)
    assert a.optimizer.num_update == b.optimizer.num_update == 3
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def test_bf16_trainer_keeps_token_ids_exact():
    """bf16 holds integers exactly only up to 256; token ids stay f32, so
    the rows of the embedding that move are exactly the batch's ids."""
    small = dict(SMALL, vocab_size=1000)
    pt = _port("sgd", dtype="bfloat16", small=small, learning_rate=0.1,
               momentum=0.0)
    assert pt._int_inputs == {"data"}
    batch = _batch(vocab=1000, seed=4)
    staged = pt.put_batch(batch)
    assert staged["data"].dtype == torch.float32
    np.testing.assert_array_equal(staged["data"].numpy(), batch["data"])
    before = pt.params["tok_embed_weight"].clone()
    loss = pt.step(staged)
    assert np.isfinite(float(loss))
    moved = (pt.params["tok_embed_weight"] != before).any(1).nonzero()
    np.testing.assert_array_equal(moved[:, 0].numpy(),
                                  np.unique(batch["data"]).astype(int))
    assert pt.params["lm_head_weight"].dtype == torch.float32


def test_dropout_trains_from_the_trainer_generator():
    losses = []
    for _ in range(2):
        pt = _port("sgd", dropout=0.1, learning_rate=0.01, seed=5)
        losses.append(pt.run_steps(_batch(), 2))
    assert torch.isfinite(losses[0]).all()
    assert torch.equal(losses[0], losses[1])   # one seed, one mask stream


@pytest.mark.parametrize("option", [
    {"stem_space_to_depth": True}, {"conv1x1_as_dot": True},
    {"pipeline_stages": 2},
    {"sequence_parallel": True}, {"tp_rules": {}}, {"strict": True},
    {"fuse_conv_bn": True}, {"native_weight_layout": True}])
def test_unported_trainer_options_raise(option):
    with pytest.raises(MXNetError, match="not yet ported"):
        _port("sgd", **option)


@pytest.mark.parametrize("option", [{"auto_layouts": True},
                                    {"elide_input_bn_grad": False}])
def test_trainer_options_without_counterpart_raise(option):
    with pytest.raises(MXNetError, match="no counterpart"):
        _port("sgd", **option)


@pytest.mark.parametrize("kw", [{"n_devices": 2}, {"tp": 2}, {"pp": 2},
                                {"devices": [tmx.cpu(), tmx.cpu()]}])
def test_multi_device_meshes_raise(kw):
    with pytest.raises(MXNetError, match="not yet ported"):
        build_mesh(**kw)


def test_bench_trainer_builds_on_the_given_context():
    trainer, staged = gpt.build_bench_trainer(
        vocab=64, seq=128, d_model=32, heads=2, layers=1, batch=2,
        dtype="float32", ctx=tmx.cpu())
    assert type(trainer.optimizer).__name__ == "Adam"
    assert trainer.optimizer.lr == 1e-4
    assert trainer.optimizer.rescale_grad == 0.5
    np.testing.assert_array_equal(
        staged["softmax_label"].numpy(),
        np.roll(staged["data"].numpy(), -1, 1))
    assert np.isfinite(trainer.run_steps(staged, 2).numpy()).all()


def test_chip_smoke_train_phases_on_cpu():
    """chip_smoke.py's train and train_check phases, as the card runs them,
    at the tiny size on the CPU."""
    cfg = {"vocab": 64, "seq": 128, "d_model": 32, "heads": 2, "layers": 2}
    out = chip_smoke.train_phase(tmx.cpu(), cfg, batch=2, dtype="float32",
                                 steps=4, timed_steps=2, repeats=1)
    assert out["launches"] == {"flash_attention_fwd": 0,
                               "flash_attention_bwd": 0}
    assert len(out["losses"]) == 4 and out["losses"][-1] < out["losses"][0]
    assert out["step_tflop"] > 0 and "profile" not in out
    check = chip_smoke.train_check_phase(tmx.cpu(), cfg)
    assert check["max_rel_update_diff"] == 0.0 and check["params"] == 30
