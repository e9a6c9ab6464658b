"""The last optimizers (DCASGD, SGLD, Ftrl, Test) and initializers (Load,
Mixed, Orthogonal, MSRAPrelu, Bilinear, FusedRNN) of the port against the
JAX package's, on the CPU.

The optimizers take five ``Updater`` steps of two parameters from the same
numpy-made weights and gradients, with ``rescale_grad``, ``wd``,
``clip_gradient`` and lr/wd mults; weights and states agree within
``test_torch_optimizer_imperative.py``'s rtol 1e-6 (atol 1e-7).  SGLD's
noise comes from each package's own generator: its noise-free part is held
to JAX's with the noise set to zero in both, and its noise, the update
less that part, to N(0, lr) by mean and standard deviation (five standard
errors).  The initializers draw from an explicit ``RandomState`` in the
port and numpy's global one in JAX: seeded alike, the arrays are equal."""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import initializer as jinit

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-6, 1e-7
SHAPE = (5, 7)


def _arrays(n, seed=0, shape=SHAPE):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _j(x):
    return jmx.nd.array(x)


def _t(x):
    return tmx.nd.array(x, ctx=tmx.cpu())


OPTIMIZERS = [
    ("dcasgd", dict(learning_rate=0.1)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9, lamda=0.1)),
    ("ftrl", dict()),
    ("ftrl", dict(lamda1=0.2, learning_rate=0.05, beta=2)),
    ("test", dict()),
]


def _steps(mx, name, kw, wrap, steps=5, shape=SHAPE):
    opt = mx.optimizer.create(
        name, rescale_grad=0.5, wd=0.01, clip_gradient=1.5,
        param_idx2name={0: "fc_weight", 1: "fc_bias"}, **kw)
    opt.set_lr_mult({"fc_weight": 0.5})
    opt.set_wd_mult({"fc_bias": 2.0})
    upd = mx.optimizer.get_updater(opt)
    weights = [wrap(w) for w in _arrays(2, seed=1, shape=shape)]
    for step in range(steps):
        grads = _arrays(2, seed=10 + step, shape=shape)
        for i, w in enumerate(weights):
            upd(i, wrap(grads[i]), w)
    return weights, upd, opt


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=lambda v: v if isinstance(v, str) else
                         "-".join("%s=%s" % i for i in sorted(v.items())))
def test_five_updater_steps_match_jax(name, kw):
    jw, jupd, jopt = _steps(jmx, name, kw, _j)
    tw, tupd, topt = _steps(tmx, name, kw, _t)
    for i in range(2):
        np.testing.assert_allclose(tw[i].asnumpy(), np.asarray(
            jw[i].asnumpy()), RTOL, ATOL, err_msg="weight %d" % i)
    jstates = pickle.loads(jupd.get_states())
    tstates = pickle.loads(tupd.get_states())
    assert sorted(tstates) == sorted(jstates)
    for k in jstates:
        want = jstates[k] if isinstance(jstates[k], tuple) \
            else (jstates[k],)
        got = tstates[k] if isinstance(tstates[k], tuple) \
            else (tstates[k],)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_allclose(g, w, RTOL, ATOL)
    if name != "test":                 # Test counts no updates, as in JAX
        assert topt.num_update == jopt.num_update == 5
    # the states round-trip through either package's .states format
    again = tmx.optimizer.get_updater(topt)
    again.set_states(jupd.get_states())
    assert sorted(pickle.loads(again.get_states())) == sorted(jstates)


def test_registry_has_the_jax_optimizers():
    for name in ("dcasgd", "sgld", "ftrl", "test"):
        po, jo = tmx.optimizer.create(name), jmx.optimizer.create(name)
        assert type(po).__name__ == type(jo).__name__
        assert po.lr == jo.lr


SGLD = dict(learning_rate=0.01)


def test_sgld_noise_free_part_matches_jax(monkeypatch):
    def zeros_torch(mean, std, size, generator=None, device=None,
                    dtype=None):
        return torch.zeros(size, device=device, dtype=dtype)
    monkeypatch.setattr(torch, "normal", zeros_torch)
    monkeypatch.setattr(jmx.random, "normal",
                        lambda loc, scale, shape, dtype=None, **kw:
                        jmx.nd.zeros(shape))
    jw, _, _ = _steps(jmx, "sgld", SGLD, _j)
    tw, _, topt = _steps(tmx, "sgld", SGLD, _t)
    for i in range(2):
        np.testing.assert_allclose(tw[i].asnumpy(), np.asarray(
            jw[i].asnumpy()), RTOL, ATOL)
    assert topt.num_update == 5


@pytest.mark.parametrize("mx", ["port", "jax"])
def test_sgld_noise_moments(mx):
    mod, wrap = (tmx, _t) if mx == "port" else (jmx, _j)
    shape = (200, 300)
    w, g = _arrays(2, seed=3, shape=shape)
    lr = 0.01
    opt = mod.optimizer.create("sgld", learning_rate=lr, rescale_grad=0.5,
                               wd=0.0)
    weight = wrap(w)
    opt.update(0, weight, wrap(g), opt.create_state(0, weight))
    noise = np.asarray(weight.asnumpy(), np.float64) - (
        w.astype(np.float64) - lr / 2 * (0.5 * g.astype(np.float64)))
    n, sigma = noise.size, np.sqrt(lr)
    assert abs(noise.mean()) < 5 * sigma / np.sqrt(n)
    assert abs(noise.std() / sigma - 1) < 5 / np.sqrt(2 * n)


def test_sgld_noise_follows_the_port_seed():
    def run(seed):
        tmx.random.seed(seed)
        w, _, _ = _steps(tmx, "sgld", SGLD, _t, steps=1)
        return w[0].asnumpy()
    a, b, c = run(4), run(4), run(5)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


# ------------------------------------------------------------ initializers
def _init_both(make, names, seed=7):
    np.random.seed(seed)
    ji = make(jinit, {})
    want = {}
    for n, s in names:
        arr = jmx.nd.zeros(s)
        ji(jinit.InitDesc(n), arr)
        want[n] = arr.asnumpy()
    pi = make(tinit, {"rng": np.random.RandomState(seed)})
    got = {}
    for n, s in names:
        arr = np.zeros(s, np.float32)
        pi(tinit.InitDesc(n), arr)
        got[n] = arr
    return got, want


NAMES = [("fc_weight", (6, 4)), ("fc_bias", (6,)),
         ("conv_weight", (3, 2, 3, 3)), ("bn_gamma", (4,)),
         ("wide_weight", (4, 9))]


@pytest.mark.parametrize("make", [
    lambda m, kw: m.Orthogonal(**kw),
    lambda m, kw: m.Orthogonal(scale=0.5, rand_type="normal", **kw),
    lambda m, kw: m.MSRAPrelu(**kw),
    lambda m, kw: m.MSRAPrelu(factor_type="in", slope=0.1, **kw),
    lambda m, kw: m.Bilinear(**kw),
    lambda m, kw: m.Mixed([".*bias", "conv.*", ".*"],
                          [m.Constant(0.3, **kw), m.Uniform(0.2, **kw),
                           m.Orthogonal(**kw)]),
], ids=["orthogonal", "orthogonal-normal", "msraprelu", "msraprelu-in",
        "bilinear", "mixed"])
def test_initializers_equal_jax_for_one_seed(make):
    names = NAMES if "Bilinear" not in repr(make(tinit, {})) else \
        [("up_weight", (4, 1, 4, 4)), ("deconv_weight", (2, 3, 3, 5))]
    got, want = _init_both(make, names)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_orthogonal_rows_are_orthonormal():
    arr = np.zeros((4, 9), np.float32)
    tinit.Orthogonal(scale=1.0, rng=0)("q_weight", arr)
    np.testing.assert_allclose(arr @ arr.T, np.eye(4), atol=1e-5)


def test_upsampling_names_take_bilinear():
    names = [("up_upsampling", (2, 1, 4, 4))]
    got, want = _init_both(lambda m, kw: m.Xavier(**kw), names)
    np.testing.assert_array_equal(got["up_upsampling"],
                                  want["up_upsampling"])
    assert got["up_upsampling"].max() > 0


def test_mixed_without_a_match_raises():
    mixed = tinit.Mixed(["fc.*"], [tinit.Zero()])
    with pytest.raises(MXNetError, match="did not match any pattern"):
        mixed("conv_weight", np.zeros((2, 2), np.float32))
    with pytest.raises(MXNetError, match="same length"):
        tinit.Mixed(["a", "b"], [tinit.Zero()])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_load_reads_params_of_either_package(writer, tmp_path):
    rng = np.random.RandomState(2)
    values = {"arg:fc_weight": rng.randn(3, 4).astype(np.float32),
              "aux:bn_moving_mean": rng.randn(4).astype(np.float32)}
    path = str(tmp_path / "p.params")
    if writer == "port":
        tmx.nd.save(path, {k: _t(v) for k, v in values.items()})
    else:
        jmx.nd.save(path, {k: _j(v) for k, v in values.items()})
    pload = tinit.Load(tmx.nd.load(path, ctx=tmx.cpu()),
                       default_init=tinit.Constant(0.5))
    jload = jinit.Load(jmx.nd.load(path), default_init=jinit.Constant(0.5))
    for name, shape, want in (
            ("fc_weight", (3, 4), values["arg:fc_weight"]),
            ("bn_moving_mean", (4,), values["aux:bn_moving_mean"]),
            ("fc_bias", (3,), np.zeros(3, np.float32)),      # the default
            ("fc2_weight", (2, 2), np.full((2, 2), 0.5, np.float32))):
        a = np.zeros(shape, np.float32)
        pload(name, a)
        b = jmx.nd.zeros(shape)
        jload(name, b)
        np.testing.assert_array_equal(a, b.asnumpy())
        np.testing.assert_array_equal(a, want)
    with pytest.raises(MXNetError, match="shape mismatch"):
        pload("fc_weight", np.zeros((4, 3), np.float32))
    with pytest.raises(MXNetError, match="no default"):
        tinit.Load({})("fc_weight", np.zeros(2, np.float32))


def test_create_spellings():
    for name, kw in (("orthogonal", {}), ("msraprelu", {"slope": 0.2}),
                     ("bilinear", {}), ("zeros", {}), ("ones", {}),
                     ("mixed", {"patterns": [".*"],
                                "initializers": [tinit.Zero()]}),
                     ("load", {"param": {}})):
        got = tinit.create(name, **kw)
        want = jinit.create(name, **kw)
        assert type(got).__name__ == type(want).__name__
    o = tinit.Orthogonal(scale=2.0, rand_type="normal")
    assert tinit.create(o.dumps()).scale == 2.0
    assert json_kwargs(tinit.MSRAPrelu(slope=0.3)) == \
        json_kwargs(jinit.MSRAPrelu(slope=0.3))


def json_kwargs(init):
    import json
    return json.loads(init.dumps())


def _fused_size(mode, num_hidden, num_layers, bidirectional, input_size):
    gates = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}[mode]
    dirs = 2 if bidirectional else 1
    h = num_hidden
    first = dirs * (gates * h * input_size + gates * h * h)
    rest = (num_layers - 1) * dirs * (gates * h * dirs * h + gates * h * h)
    return first + rest + num_layers * dirs * 2 * gates * h


@pytest.mark.parametrize("mode,layers,bidir", [("lstm", 2, False),
                                               ("gru", 1, True),
                                               ("rnn_tanh", 2, True)])
def test_fused_rnn_equals_jax(mode, layers, bidir):
    size = _fused_size(mode, 6, layers, bidir, 5)
    name = "%s_parameters" % mode

    def make(m, kw):
        return m.FusedRNN(m.Xavier(factor_type="in", magnitude=2, **kw),
                          num_hidden=6, num_layers=layers, mode=mode,
                          bidirectional=bidir, **kw)
    np.random.seed(7)
    ja = jmx.nd.zeros((size,))
    make(jinit, {})._init_weight(jinit.InitDesc(name), ja)
    pa = np.zeros((size,), np.float32)
    make(tinit, {"rng": 7})._init_weight(tinit.InitDesc(name), pa)
    np.testing.assert_array_equal(pa, ja.asnumpy())
    assert np.count_nonzero(pa) > size // 2
    # the dumps() string form, as a variable's __init__ attribute carries
    # it: the JAX FusedRNN passes the attribute on to the pieces and
    # recurses into them, the port's gives the pieces the inner initializer
    dumps = make(jinit, {}).dumps()
    desc = tinit.InitDesc(name, {"__init__": dumps})
    via_attr = np.zeros((size,), np.float32)
    tinit.Uniform(0.1, rng=7)(desc, via_attr)
    np.testing.assert_array_equal(via_attr, pa)
    with pytest.raises(ValueError):
        jinit.Uniform(0.1)(jinit.InitDesc(name, {"__init__": dumps}),
                           jmx.nd.zeros((size,)))


def test_fused_rnn_cell_parameters_have_no_default_in_either_package():
    """As in the JAX package, a FusedRNNCell's flat vector takes no default
    initializer: it names FusedRNN through its variable's ``init``."""
    for init, err in ((tinit.Xavier(), MXNetError),
                      (jinit.Xavier(), jmx.base.MXNetError)):
        arr = np.zeros(10, np.float32) if init.__module__.startswith(
            "mxnet_tpu_torch") else jmx.nd.zeros((10,))
        with pytest.raises(err, match="Unknown initialization pattern"):
            init("lstm_parameters", arr)


def test_fused_rnn_initializes_a_cell_in_a_module():
    """A FusedRNNCell whose parameters variable names FusedRNN binds and
    initializes in a port Module (the global initializer's generator
    drawing for the pieces), equal to the JAX FusedRNN's vector from the
    same seed."""
    fused = tinit.FusedRNN(tinit.Xavier(), num_hidden=4, num_layers=1,
                           mode="lstm")
    params = tmx.rnn.RNNParams("lstm_")
    params.get("parameters", init=fused)       # the cell takes this one
    cell = tmx.rnn.FusedRNNCell(4, num_layers=1, mode="lstm",
                                prefix="lstm_", params=params)
    out, _ = cell.unroll(3, tmx.sym.Variable("data"), layout="NTC",
                         merge_outputs=True)
    mod = tmx.mod.Module(tmx.sym.MakeLoss(tmx.sym.sum(out)),
                         data_names=["data"], label_names=[],
                         context=tmx.cpu())
    mod.bind(data_shapes=[("data", (2, 3, 5))])
    mod.init_params(initializer=tinit.Uniform(0.1, rng=0))
    got = mod.get_params()[0]["lstm_parameters"].asnumpy()
    np.random.seed(0)
    want = jmx.nd.zeros(got.shape)
    jinit.FusedRNN(jinit.Xavier(), num_hidden=4, num_layers=1,
                   mode="lstm")._init_weight(jinit.InitDesc(
                       "lstm_parameters"), want)
    np.testing.assert_array_equal(got, want.asnumpy())
