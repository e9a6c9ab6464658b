"""The port's zoo tools on the CPU: ``tools.lstm_ocr`` in lockstep with
``examples/ctc/lstm_ocr.py``'s ``train`` (the same strips, shuffle and
initial parameters; each Adam step's loss and parameters against the JAX
Module's), ``tools.benchmark_score --cpu 1``, the serving CLI's
``--model`` route against the JAX ``Predictor`` on the same weights, and
chip_smoke's zoo phases at a tiny size."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples", "ctc"))

import chip_smoke  # noqa: E402
import lstm_ocr as jax_ocr  # noqa: E402
import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.serving.__main__ import (  # noqa: E402
    _build_predictor, main as serve, parser as serve_parser)
from mxnet_tpu_torch.tools import benchmark_score, lstm_ocr  # noqa: E402

OCR = dict(epochs=1, batch_size=8, n_train=32, lr=0.01)
#: each step's loss to rtol 1e-4; parameters by the norm of their
#: difference over all tensors against the norm of the JAX state to 1e-4,
#: and each entry within a share TOL_LR of lr a step (Adam moves an entry
#: whose gradient is within rounding of 0 by up to lr in either package)
TOL, TOL_LR = 1e-4, 0.05


def _steps(pkg, monkeypatch, run):
    """Run ``run()`` with ``pkg``'s Module recording the parameters after
    ``init_params`` and after each ``update``, with each step's loss."""
    Module = pkg.mod.Module
    init, update = Module.init_params, Module.update
    snaps, losses = [], []

    def params(m):
        return {k: v.asnumpy().copy() for k, v in m.get_params()[0].items()}

    def rec_init(self, *a, **kw):
        init(self, *a, **kw)
        snaps.append(params(self))

    def rec_update(self, *a, **kw):
        update(self, *a, **kw)
        snaps.append(params(self))
        losses.append(float(self.get_outputs()[0].asnumpy().mean()))

    monkeypatch.setattr(Module, "init_params", rec_init)
    monkeypatch.setattr(Module, "update", rec_update)
    out = run()
    monkeypatch.undo()
    return snaps, losses, out


def test_lstm_ocr_steps_in_lockstep_with_the_example(monkeypatch):
    np.random.seed(3)
    jsnaps, jlosses, _ = _steps(jmx, monkeypatch, lambda: jax_ocr.train(
        ctx=jmx.cpu(), **OCR))
    np.random.seed(3)
    psnaps, plosses, _ = _steps(tmx, monkeypatch, lambda: lstm_ocr.train(
        ctx=tmx.cpu(), arg_params=jsnaps[0], **OCR))
    assert len(psnaps) == len(jsnaps) == 5
    np.testing.assert_allclose(plosses, jlosses, rtol=TOL)
    assert plosses[-1] < plosses[0]
    for step, (p, j) in enumerate(zip(psnaps, jsnaps)):
        a = np.concatenate([p[k].ravel() for k in sorted(j)])
        b = np.concatenate([j[k].ravel() for k in sorted(j)])
        assert np.linalg.norm(a - b) <= TOL * np.linalg.norm(b), step
        assert np.abs(a - b).max() <= TOL_LR * OCR["lr"] * max(step, 1)


def test_lstm_ocr_net_is_the_examples():
    with jmx.name.NameManager():
        want = jax_ocr.make_net().tojson()
    with tmx.name.NameManager():
        got = lstm_ocr.make_net().tojson()
    assert got == want


def test_greedy_decode_collapses_repeats_and_blanks():
    pred = np.zeros((6, 1, 4))
    for t, c in enumerate([1, 1, 0, 1, 3, 3]):
        pred[t, 0, c] = 1.0
    assert lstm_ocr.greedy_decode(pred) == [[1, 1, 3]]


def test_benchmark_score_on_the_cpu():
    for fused in ("0", "1"):
        out = benchmark_score.main(
            ["--cpu", "1", "--networks", "mlp", "--batch-sizes", "1,2",
             "--fused", fused, "--dtype", "float32"])
        assert out["route"] == ("fused" if fused == "1" else "executor")
        assert all(v > 0 for v in out["images_per_s"]["mlp"].values())
    assert benchmark_score.image_shape_of("inception-v3") == (3, 299, 299)


def test_tools_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--cpu 1"):
        benchmark_score.main(["--networks", "mlp"])
    with pytest.raises(SystemExit, match="--cpu 1"):
        lstm_ocr.main(["--epochs", "1"])


def _weights(pred):
    exe = pred._executor
    out = {k: v.asnumpy() for k, v in exe.arg_dict.items()
           if k not in ("data", "softmax_label")}
    out.update({k: v.asnumpy() for k, v in exe.aux_dict.items()})
    return out


def test_serving_model_route_matches_the_jax_predictor():
    """``--model lenet --cpu 1``: the zoo graph with Xavier weights from
    the seed, whose outputs equal a JAX Predictor's on the same weights."""
    opts = serve_parser().parse_args(["--model", "lenet", "--cpu", "1",
                                      "--data-shape", "1,28,28"])
    pred = _build_predictor(opts)
    params = _weights(pred)
    again = _weights(_build_predictor(opts))
    assert sorted(params) == sorted(again)
    assert all(np.array_equal(v, again[k]) for k, v in params.items())
    from mxnet_tpu import models as jmodels
    with jmx.name.NameManager():
        jnet = jmodels.get_model("lenet", num_classes=10)
    jpred = jmx.predictor.Predictor(
        jnet.tojson(), {k: jmx.nd.array(v) for k, v in params.items()},
        {"data": (1, 1, 28, 28)})
    x = np.random.RandomState(0).rand(1, 1, 28, 28).astype(np.float32)
    got = pred.forward(data=x).get_output(0)
    want = jpred.forward(data=x).get_output(0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_serving_model_route_binds_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        serve(["--model", "inception-bn"])


def test_chip_smoke_zoo_phases_on_cpu():
    """chip_smoke's zoo_score, zoo_serve, contrib_ops and ctc_ocr on the
    CPU against the CPU at a tiny size."""
    cpu = tmx.cpu()
    score = chip_smoke.zoo_score_phase(cpu, networks=("mlp", "lenet"),
                                       batches=(1, 2), num_batches=1)
    assert set(score["images_per_s"]) == {"mlp", "lenet"}
    served = chip_smoke.zoo_serve_phase(cpu, model="lenet",
                                        data_shape=(1, 28, 28), classes=10,
                                        requests=4, rungs="1,2",
                                        check_ctx=cpu)
    assert served["answered"] == 5 and served["max_abs_dlogp"] <= 1e-5
    ops = chip_smoke.contrib_ops_phase("cpu", "cpu")
    assert not ops["over"] and ops["kernel_launches_total"] == 0
    ocr = chip_smoke.ctc_ocr_phase(cpu, min_accuracy=None, epochs=2,
                                   n_train=64)
    assert len(ocr["accuracy"]) == 2 and np.isfinite(ocr["losses"]).all()
    check = chip_smoke.inception_check_phase(cpu, batch=2, image=9)
    assert check["max_rel_update_diff"] <= 1e-4
    assert check["max_rel_aux_diff"] <= 1e-4


def test_chip_smoke_ring_gpt_on_cpu():
    """ring_gpt at a small width on the CPU: the ring step is the flash
    step to the bit."""
    cfg = {"vocab": 64, "seq": 128, "d_model": 32, "heads": 2, "layers": 2}
    out = chip_smoke.ring_gpt_phase(tmx.cpu(), cfg=cfg, batch=2,
                                    dtype="float32")
    assert out["bit_identical"] and out["compared"] > 0


def test_inception_k5_shapes_are_the_plans():
    """chip_smoke's K5 shapes of Inception-v3 at batch 128: 40 blocks of
    19 shapes, each K and N a multiple of 8 (no padding for TMA)."""
    shapes = chip_smoke.inception_k5_shapes()
    assert sum(shapes.values()) == chip_smoke.INCEPTION_K5_BLOCKS == 40
    assert len(shapes) == 19
    assert shapes[(128 * 35 * 35, 192, 64)] == 2
    assert shapes[(128 * 17 * 17, 768, 192)] == 12
    assert all(k % 8 == 0 and n % 8 == 0 for _m, k, n in shapes)
