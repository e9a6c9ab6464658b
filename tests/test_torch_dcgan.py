"""The DCGAN slice on the CPU: three iterations of
``mxnet_tpu_torch.tools.dcgan`` in lockstep with ``examples/gan/dcgan.py``
(the JAX package) at size 16, ngf = ndf = 8, nc 1, z 8, batch 4, from the
JAX package's initial parameters: after each iteration every leaf of the
generator and the discriminator and every BatchNorm moving statistic;
chip_smoke's four new phases at a tiny size; the registry against the JAX
package's, aliases included."""
import importlib.util
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.tools import dcgan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(batch_size=4, size=16, ngf=8, ndf=8, nc=1, z=8, n_images=12,
             epochs=1, log_every=4)
ITERATIONS = 3
LR = 2e-4
#: per leaf after each iteration, ||port's change - JAX's|| / ||JAX's
#: change|| and, in units of lr a step, the largest entry of that
#: difference.  The gradients agree within 3.7e-7, but Adam's step is
#: lr g / (|g| + eps): an entry whose gradient is within rounding of 0
#: moves by a share of lr that the rounding decides.  The port reads
#: 9.7e-4 and 0.016 lr (one entry of the generator's last weight, 256
#: entries), the moving statistics 9.8e-7; the bounds 2e-3, 0.05 lr and
#: 1e-5.  The generator's update left out of the loop reads 1.0 on all
#: three.
TOL = 2e-3
TOL_LR = 0.05
TOL_AUX = 1e-5


def _example():
    spec = importlib.util.spec_from_file_location(
        "jax_dcgan_example", os.path.join(ROOT, "examples", "gan",
                                          "dcgan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _snapshots(pkg, monkeypatch, run):
    """Run ``run()`` with ``pkg``'s Module patched to record its modules
    and, at each generator forward (the start of an iteration), every
    parameter and moving statistic; the state after the last iteration is
    appended from the modules ``run`` returns."""
    Module = pkg.mod.Module
    mods, snaps = [], []
    bind, forward = Module.bind, Module.forward

    def snap():
        state = {}
        for m in mods:
            arg, aux = m.get_params()
            state.update({k: v.asnumpy().copy() for k, v in arg.items()})
            state.update({"aux:" + k: v.asnumpy().copy()
                          for k, v in aux.items()})
        snaps.append(state)

    def rec_bind(self, *a, **kw):
        mods.append(self)
        return bind(self, *a, **kw)

    def rec_forward(self, batch, *a, **kw):
        if list(self._data_names) == ["rand"]:
            snap()
        return forward(self, batch, *a, **kw)

    monkeypatch.setattr(Module, "bind", rec_bind)
    monkeypatch.setattr(Module, "forward", rec_forward)
    out = run()
    snap()
    monkeypatch.undo()
    return snaps, out


@pytest.fixture(scope="module")
def lockstep():
    mp = pytest.MonkeyPatch()
    example = _example()
    np.random.seed(0)
    jsnaps, _ = _snapshots(jmx, mp, lambda: example.train(
        ctx=jmx.cpu(), **SMALL))
    init = jsnaps[0]
    arg_g, aux_g, arg_d, aux_d = ({}, {}, {}, {})
    for k, v in init.items():
        aux = k.startswith("aux:")
        name = k[4:] if aux else k
        gen = name.startswith("g")
        (aux_g if aux and gen else aux_d if aux else
         arg_g if gen else arg_d)[name] = v
    psnaps, (modG, modD, hist) = _snapshots(mx, mp, lambda: dcgan.train(
        ctx=mx.cpu(), init=(arg_g, aux_g, arg_d, aux_d), **SMALL))
    return jsnaps, psnaps, hist


def test_the_tool_starts_from_the_jax_parameters(lockstep):
    jsnaps, psnaps, _ = lockstep
    assert len(jsnaps) == len(psnaps) == ITERATIONS + 1
    assert sorted(jsnaps[0]) == sorted(psnaps[0])
    for k, v in jsnaps[0].items():
        np.testing.assert_array_equal(psnaps[0][k], v, err_msg=k)


@pytest.mark.parametrize("it", range(1, ITERATIONS + 1))
def test_iteration_matches_the_example(lockstep, it):
    jsnaps, psnaps, _ = lockstep
    init = jsnaps[0]
    worst, in_lr = {}, {}
    for k, want in jsnaps[it].items():
        d_want = want - init[k]
        d_got = psnaps[it][k] - init[k]
        worst[k] = np.linalg.norm(d_got - d_want) / max(
            np.linalg.norm(d_want), 1e-30)
        in_lr[k] = np.abs(d_got - d_want).max() / (LR * it)
    par = {k: v for k, v in worst.items() if not k.startswith("aux:")}
    aux = {k: v for k, v in worst.items() if k.startswith("aux:")}
    assert max(par.values()) <= TOL, sorted(par.items(), key=lambda x: -x[1])
    assert max(in_lr[k] for k in par) <= TOL_LR, in_lr
    assert max(aux.values()) <= TOL_AUX, aux
    moved = [k for k in par if np.any(jsnaps[it][k] != init[k])]
    assert any(k.startswith("g") for k in moved)
    assert any(k.startswith("d") for k in moved)


def test_chip_smoke_new_phases_at_a_tiny_size():
    """op_corpus, autograd_check, dcgan_train and dcgan_check on the CPU
    against the CPU: every case within its bound (here: equal), the
    imperative loop's loss falling, no kernel launched, the recorded
    attention's gradients equal to the Executor's, the DCGAN finite."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    cpu = mx.cpu()
    corpus = chip_smoke.op_corpus_phase("cpu", "cpu")
    assert corpus["ops"] == 137 and not corpus["over"]
    auto = chip_smoke.autograd_check_phase(
        cpu, widths=(20, 16, 8, 4), batch=10, steps=4, flash=(1, 128, 2, 16))
    assert auto["mlp"]["max_rel_update_diff"] == 0.0
    assert all(auto["flash"]["grads_equal_executor"].values())
    cfg = dict(size=16, ngf=4, ndf=4, nc=3, z=8, batch_size=4, images=16,
               epochs=2)
    run = chip_smoke.dcgan_train_phase(cpu, cfg=cfg, params=None)
    assert run["iterations"] == 8 and run["finite"]
    assert set(run["kernel_launches"].values()) == {0}
    chk = chip_smoke.dcgan_check_phase(cpu, cfg=dict(
        size=16, ngf=4, ndf=4, nc=1, z=8, batch_size=4, iterations=2))
    assert chk["params"]["max_rel_update_diff"] == 0.0


def test_full_width_parameter_counts():
    """The reference widths give the counts chip_smoke holds the card to."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    cfg = chip_smoke.DCGAN_FULL
    g, d = dcgan.make_dcgan_sym(cfg["ngf"], cfg["ndf"], cfg["nc"], n_up=5)
    counts = []
    for sym, shapes in ((g, {"rand": (cfg["batch_size"], cfg["z"], 1, 1)}),
                        (d, {"data": (cfg["batch_size"], cfg["nc"], 64, 64),
                             "label": (cfg["batch_size"],)})):
        args, _, _ = sym.infer_shape(**shapes)
        counts.append(sum(int(np.prod(s)) for n, s in
                          zip(sym.list_arguments(), args)
                          if n not in shapes))
    assert tuple(counts) == chip_smoke.DCGAN_PARAMS
    assert [s[1] for s in g.infer_shape(rand=(1, 100, 1, 1))[0][1::3]] \
        == [512, 256, 128, 64, 3]


#: the JAX package's ops the port leaves to later slices: none
NOT_PORTED = set()


def _jax_package_ops(jreg):
    """The JAX package's own ops: not the probes a JAX test registers
    in the same process (``tests/test_analysis.py``'s ``_test_*``)."""
    return {n for n in jreg.list_ops()
            if jreg.get_op(n).fcompute.__module__.startswith("mxnet_tpu.")}


def test_registry_is_the_jax_registry_less_the_detection_path():
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as reg
    assert set(reg.list_ops()) == _jax_package_ops(jreg) - NOT_PORTED
    assert len(reg.list_ops()) == 201
    want = {a: t for a, t in jreg._ALIASES.items() if t not in NOT_PORTED}
    assert reg.aliases() == want
    for alias, target in want.items():
        assert reg.get_op(alias).name == target
        assert getattr(mx.nd, alias) is getattr(mx.nd, target)
