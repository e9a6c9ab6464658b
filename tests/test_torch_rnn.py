"""The port's RNN family against the JAX package's, on the CPU.

* The fused ``RNN`` op in every mode (lstm, gru, rnn_tanh, rnn_relu), one
  and two layers, one and two directions, with and without
  ``state_outputs``: outputs, final states and the gradients of data,
  flat parameters and begin states against ``jax.vjp`` of
  ``mxnet_tpu/ops/rnn.py``, within rtol 1e-5, atol 1e-5 (the same f32
  recurrence; the port adds the input product of the whole sequence
  before the steps, the JAX scan each step, so sums group differently).
  Its inter-layer dropout draws from another generator than JAX's, so it
  is held by behaviour: identity at inference, and in training a layer
  with identity weights shows the dropped share within 0.05 of ``p`` and
  the kept values scaled by 1 / (1 - p).
* Every cell unrolled by both packages writes the same graph JSON and, on
  the same weights, the same outputs and gradients within 1e-5.
  ``DropoutCell`` and ``ZoneoutCell`` by behaviour, as above.
* ``FusedRNNCell`` against its ``unfuse()`` (chip_smoke's
  ``fused_vs_unfused``) within 1e-5 of the largest entry.
* ``pack_weights``/``unpack_weights``: the port's per-gate arrays equal
  the JAX package's for the same flat vector, and both round trips give
  the vector back exactly.
* ``BucketSentenceIter``: the same batches in the same order as the JAX
  iterator under the same ``random``/``np.random`` seeds, exactly.
* RNN checkpoints saved by either package load in the other, exactly.
"""
import os
import random
import sys

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops.registry import OpContext as JaxOpContext, \
    get_op as jax_get_op

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops.registry import OpContext, get_op
from mxnet_tpu_torch.ops.rnn import rnn_param_size

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _no_pending_data_state():
    """Each package's ``load_checkpoint`` stashes data state for its next
    fit in the process, and a fit tracks its iterator for the next
    checkpoint; clear both after each test."""
    yield
    jmx.io_resume.clear_pending()
    tmx.io_resume.clear_pending()
    tmx.io_resume.track(None)


def _rnn_inputs(mode, layers, bi, seq=5, batch=3, in_size=4, hidden=6,
                seed=0):
    rng = np.random.RandomState(seed)
    dirs = 2 if bi else 1
    n = rnn_param_size(mode, in_size, hidden, layers, bi)
    ins = [rng.normal(0, 1, (seq, batch, in_size)).astype(np.float32),
           (rng.uniform(-1, 1, n) / np.sqrt(hidden)).astype(np.float32),
           rng.normal(0, 0.5, (layers * dirs, batch, hidden))
           .astype(np.float32)]
    if mode == "lstm":
        ins.append(rng.normal(0, 0.5, (layers * dirs, batch, hidden))
                   .astype(np.float32))
    return ins


@pytest.mark.parametrize("state_outputs", [True, False])
@pytest.mark.parametrize("bi", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_op_matches_jax(mode, layers, bi, state_outputs):
    attrs = {"state_size": 6, "num_layers": layers, "bidirectional": bi,
             "mode": mode, "state_outputs": state_outputs}
    inputs = _rnn_inputs(mode, layers, bi)
    diff = tuple(range(len(inputs)))
    jop = jax_get_op("RNN")
    jattrs = jop.parse_attrs(attrs)

    def jfn(*xs):
        out = jop.fcompute(jattrs, JaxOpContext(), *xs)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)
    jout, vjp = jax.vjp(jfn, *inputs)
    rng = np.random.RandomState(7)
    gs = [rng.normal(0, 1, np.shape(o)).astype(np.float32) for o in jout]
    jgrads = vjp(tuple(gs))

    op = get_op("RNN")
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = op.fcompute(op.parse_attrs({k: str(v) for k, v in attrs.items()}),
                      OpContext(is_train=True), *ts)
    out = list(out) if isinstance(out, (tuple, list)) else [out]
    assert len(out) == len(jout) == op.get_num_outputs(
        op.parse_attrs({k: str(v) for k, v in attrs.items()}))
    grads = torch.autograd.grad(out, ts, [torch.from_numpy(g) for g in gs])
    for o, j in zip(out, jout):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(j),
                                   RTOL, ATOL)
    for g, j in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), RTOL, ATOL)


def test_rnn_op_dropout_by_behaviour():
    """Two rnn_relu layers whose second is the identity (W = I, R = 0, no
    bias) and whose first has no recurrence: the op's output is the first
    layer's (non-negative) output after the dropout between them."""
    seq, batch, in_size, hidden, p = 6, 64, 8, 32, 0.3
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.normal(0, 1, (seq, batch, in_size)),
                     dtype=torch.float32)
    w1 = torch.tensor(rng.normal(0, 1, (hidden, in_size)),
                      dtype=torch.float32)
    vec = torch.cat([w1.reshape(-1), torch.zeros(hidden * hidden),
                     torch.eye(hidden).reshape(-1),
                     torch.zeros(hidden * hidden), torch.zeros(4 * hidden)])
    assert vec.numel() == rnn_param_size("rnn_relu", in_size, hidden, 2,
                                         False)
    state = torch.zeros(2, batch, hidden)
    op = get_op("RNN")
    attrs = op.parse_attrs({"state_size": str(hidden), "num_layers": "2",
                            "mode": "rnn_relu", "p": str(p)})
    layer1 = torch.relu(x @ w1.t())
    infer = op.fcompute(attrs, OpContext(is_train=False), x, vec, state)
    torch.testing.assert_close(infer, layer1, rtol=1e-6, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    train = op.fcompute(attrs, OpContext(is_train=True, generator=gen), x,
                        vec, state)
    live = layer1 > 0
    dropped = (train[live] == 0).float().mean().item()
    assert abs(dropped - p) < 0.05, dropped
    kept = live & (train != 0)
    torch.testing.assert_close(train[kept], layer1[kept] / (1 - p))
    again = op.fcompute(attrs, OpContext(
        is_train=True, generator=torch.Generator().manual_seed(0)), x, vec,
        state)
    assert torch.equal(train, again)


# ------------------------------------------------------------------ cells
def _cell_nets(mx, kind):
    """(cell, symbol) of one cell configuration, unrolled over 4 steps."""
    r = mx.rnn
    cell = {
        "rnn_tanh": lambda: r.RNNCell(5, prefix="rnn_"),
        "rnn_relu": lambda: r.RNNCell(5, activation="relu", prefix="rr_"),
        "lstm": lambda: r.LSTMCell(5, prefix="lstm_", forget_bias=0.5),
        "gru": lambda: r.GRUCell(5, prefix="gru_"),
        "stack": lambda: r.SequentialRNNCell().add(
            r.LSTMCell(5, prefix="l0_")).add(r.GRUCell(4, prefix="l1_")),
        "bi": lambda: r.BidirectionalCell(r.LSTMCell(5, prefix="fw_"),
                                          r.GRUCell(5, prefix="bw_")),
        "residual": lambda: r.ResidualCell(r.GRUCell(3, prefix="res_")),
        "dropout_stack": lambda: r.SequentialRNNCell().add(
            r.LSTMCell(5, prefix="d0_")).add(r.DropoutCell(0.5)).add(
            r.LSTMCell(5, prefix="d1_")),
        "zoneout": lambda: r.ZoneoutCell(r.LSTMCell(5, prefix="zo_"),
                                         zoneout_outputs=0.3,
                                         zoneout_states=0.4),
    }[kind]()
    out, states = cell.unroll(4, mx.sym.Variable("data"),
                              merge_outputs=True)
    return cell, mx.sym.Group([out] + list(states))


CELLS = ["rnn_tanh", "rnn_relu", "lstm", "gru", "stack", "bi", "residual",
         "dropout_stack", "zoneout"]


def _weights(net, data_shape, seed=0):
    arg_shapes, _, _ = net.infer_shape(data=data_shape)
    rng = np.random.RandomState(seed)
    return {n: rng.normal(0, 0.5, s).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)}


@pytest.mark.parametrize("kind", CELLS)
def test_cells_match_jax(kind):
    jcell, jnet = _cell_nets(jmx, kind)
    tcell, tnet = _cell_nets(tmx, kind)
    assert tnet.tojson() == jnet.tojson()
    assert tcell.state_info == jcell.state_info
    data_shape = (3, 4, 3)
    vals = _weights(tnet, data_shape)
    heads = [np.random.RandomState(9).normal(0, 1, s).astype(np.float32)
             for s in tnet.infer_shape(data=data_shape)[1]]
    texe = tnet.bind(tmx.cpu(), {k: tmx.nd.array(v, ctx=tmx.cpu())
                                 for k, v in vals.items()})
    jexe = jnet.bind(jmx.cpu(), {k: jmx.nd.array(v) for k, v in
                                 vals.items()},
                     args_grad={k: jmx.nd.zeros(v.shape) for k, v in
                                vals.items()})
    # inference: dropout and zoneout are identities
    for t, j in zip(texe.forward(), jexe.forward()):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), RTOL, ATOL)
    if kind in ("dropout_stack", "zoneout"):
        return
    texe.forward(is_train=True)
    texe.backward([tmx.nd.array(h, ctx=tmx.cpu()) for h in heads])
    jexe.forward(is_train=True)
    jexe.backward([jmx.nd.array(h) for h in heads])
    for name in vals:
        np.testing.assert_allclose(texe.grad_dict[name].asnumpy(),
                                   jexe.grad_dict[name].asnumpy(), RTOL,
                                   ATOL, err_msg=name)


def test_dropout_and_zoneout_cells_by_behaviour():
    """In training a DropoutCell drops a share near p of its inputs and
    scales the rest; a ZoneoutCell's every output is either the step's
    new output or the previous one."""
    x = tmx.sym.Variable("data")
    out, _ = tmx.rnn.DropoutCell(0.4).unroll(3, x, merge_outputs=True)
    data = np.abs(np.random.RandomState(0).normal(0, 1, (64, 3, 50))) + 0.1
    exe = out.bind(tmx.cpu(), {"data": tmx.nd.array(data, ctx=tmx.cpu())})
    tmx.random.seed(3)
    got = exe.forward(is_train=True)[0].asnumpy()
    share = (got == 0).mean()
    assert abs(share - 0.4) < 0.02, share
    np.testing.assert_allclose(got[got != 0], (data / 0.6)[got != 0],
                               rtol=1e-6)
    np.testing.assert_array_equal(exe.forward()[0].asnumpy(),
                                  data.astype(np.float32))

    # zoneout: at the first step the state is the begin state, so each
    # output is the plain cell's or the zero "previous" output
    zcell = tmx.rnn.ZoneoutCell(tmx.rnn.RNNCell(6, prefix="z_"),
                                zoneout_outputs=0.5)
    outs, _ = zcell.unroll(5, x, merge_outputs=False)
    net = tmx.sym.Group(outs)
    vals = _weights(net, (64, 5, 3), seed=2)
    data = np.random.RandomState(3).normal(0, 1, (64, 5, 3))
    arrays = {k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in vals.items()}
    arrays["data"] = tmx.nd.array(data, ctx=tmx.cpu())
    plain, _ = tmx.rnn.RNNCell(6, prefix="z_").unroll(5, x,
                                                      merge_outputs=False)
    new = [o.asnumpy() for o in
           tmx.sym.Group(plain).bind(tmx.cpu(), arrays).forward()]
    zexe = net.bind(tmx.cpu(), arrays)
    first = zexe.forward(is_train=True)[0].asnumpy()
    is_new = first == new[0]
    assert np.all(is_new | (first == 0))
    assert abs(is_new.mean() - 0.5) < 0.1, is_new.mean()
    for z, n in zip(zexe.forward(), new):          # inference: the cell
        np.testing.assert_allclose(z.asnumpy(), n, 1e-6, 1e-6)


FUSED = [("lstm", 2, False), ("lstm", 2, True), ("gru", 2, False),
         ("gru", 1, True), ("rnn_tanh", 2, True), ("rnn_relu", 1, False)]


@pytest.mark.parametrize("mode,layers,bi", FUSED)
def test_fused_cell_matches_its_unfused_cells(mode, layers, bi):
    sys.path.insert(0, ROOT)
    import chip_smoke
    out = chip_smoke.fused_vs_unfused(tmx.cpu(), mode, 6, layers, bi, 3, 5,
                                      4)
    assert max(out["err_out"], out["err_grad_data"],
               out["err_grad_weights"]) <= chip_smoke.TOL_RNN_OPS, out


@pytest.mark.parametrize("mode,layers,bi", FUSED)
def test_fused_cell_graph_and_weights_match_jax(mode, layers, bi):
    """The fused cell's graph and its unfused stack's are the JAX
    package's; a flat vector unpacks into the same per-gate arrays in
    both, and pack(unpack(v)) == v in both."""
    def nets(mx):
        cell = mx.rnn.FusedRNNCell(5, num_layers=layers, mode=mode,
                                   bidirectional=bi, get_next_state=True)
        data = mx.sym.Variable("data")
        with mx.name.NameManager():     # the same counters in both
            return cell, [
                cell.unroll(3, data, merge_outputs=True)[0],
                cell.unfuse().unroll(3, data, merge_outputs=True)[0]]
    jcell, jnets = nets(jmx)
    tcell, tnets = nets(tmx)
    for t, j in zip(tnets, jnets):
        assert t.tojson() == j.tojson()
    name = "%s_parameters" % mode
    vec = np.random.RandomState(4).normal(
        0, 1, rnn_param_size(mode, 7, 5, layers, bi)).astype(np.float32)
    tun = tcell.unpack_weights({name: tmx.nd.array(vec, ctx=tmx.cpu())})
    jun = jcell.unpack_weights({name: jmx.nd.array(vec)})
    assert sorted(tun) == sorted(jun)
    for k in jun:
        np.testing.assert_array_equal(tun[k].asnumpy(), jun[k].asnumpy(),
                                      err_msg=k)
        assert tun[k].context == tmx.cpu()
    np.testing.assert_array_equal(tcell.pack_weights(tun)[name].asnumpy(),
                                  vec)
    np.testing.assert_array_equal(jcell.pack_weights(jun)[name].asnumpy(),
                                  vec)
    # the unfused cells fold the per-gate arrays into their i2h/h2h arrays
    stack = tcell.unfuse()
    folded = stack.pack_weights(tun)
    np.testing.assert_array_equal(
        tcell.pack_weights(stack.unpack_weights(folded))[name].asnumpy(),
        vec)


def test_lstm_cell_weights_round_trip_and_forget_bias():
    cell = tmx.rnn.LSTMCell(3, prefix="c_", forget_bias=2.0)
    jcell = jmx.rnn.LSTMCell(3, prefix="c_", forget_bias=2.0)
    args = {"c_i2h_weight": np.arange(24.0).reshape(12, 2),
            "c_h2h_weight": np.arange(36.0).reshape(12, 3),
            "c_i2h_bias": np.arange(12.0), "c_h2h_bias": -np.arange(12.0)}
    tun, jun = cell.unpack_weights(args), jcell.unpack_weights(args)
    assert sorted(tun) == sorted(jun)
    for k in jun:
        np.testing.assert_array_equal(tun[k].asnumpy(), jun[k].asnumpy())
    back = cell.pack_weights(tun)
    for k, v in args.items():
        np.testing.assert_array_equal(back[k].asnumpy(), v)
    # the forget quarter of i2h_bias starts at forget_bias under any
    # initializer: the variable's __init__ is the JAX package's string
    out, _ = cell.unroll(2, tmx.sym.Variable("data"))
    attrs = tmx.sym.Group(out).attr_dict()["c_i2h_bias"]
    jout, _ = jcell.unroll(2, jmx.sym.Variable("data"))
    assert attrs["__init__"] == \
        jmx.sym.Group(jout).attr_dict()["c_i2h_bias"]["__init__"]
    bias = np.zeros(12, np.float32)
    tmx.init.Xavier(rng=0)(tmx.init.InitDesc("c_i2h_bias", attrs), bias)
    np.testing.assert_array_equal(bias, [0] * 3 + [2.0] * 3 + [0] * 6)


# --------------------------------------------------------------- iterator
def _sentences(n=300, seed=0):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 30, rng.randint(2, 17))) for _ in range(n)]


def _batches(mx, layout, buckets, epochs=2):
    random.seed(11)
    np.random.seed(11)
    it = mx.rnn.BucketSentenceIter(_sentences(), 8, buckets=buckets,
                                   invalid_label=0, layout=layout)
    out = []
    for _ in range(epochs):
        for b in it:
            out.append((b.bucket_key, b.data[0].asnumpy(),
                        b.label[0].asnumpy(), b.provide_data[0].shape,
                        b.provide_label[0].shape))
        it.reset()
    return it, out


@pytest.mark.parametrize("layout,buckets", [("NT", [4, 8, 12, 16]),
                                            ("TN", [4, 8, 12, 16]),
                                            ("NT", None)])
def test_bucket_sentence_iter_matches_jax(layout, buckets):
    jit, jb = _batches(jmx, layout, None if buckets is None
                       else list(buckets))
    tit, tb = _batches(tmx, layout, None if buckets is None
                       else list(buckets))
    assert tit.default_bucket_key == jit.default_bucket_key
    assert tit.buckets == jit.buckets
    assert tit.provide_data[0].shape == jit.provide_data[0].shape
    assert len(tb) == len(jb) > 10
    for (tk, td, tl, tds, tls), (jk, jd, jl, jds, jls) in zip(tb, jb):
        assert tk == jk and tds == jds and tls == jls
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
    assert str(tb[0][1].dtype) == "float32"


def test_encode_sentences_matches_jax():
    text = [["a", "b", "c"], ["b", "d"], ["e", "a"]]
    for kw in ({}, {"invalid_label": 0, "start_label": 1}):
        assert tmx.rnn.encode_sentences(text, **kw) == \
            jmx.rnn.encode_sentences(text, **kw)
    _, vocab = tmx.rnn.encode_sentences(text)
    with pytest.raises(ValueError, match="Unknown token"):
        tmx.rnn.encode_sentences([["zz"]], vocab=vocab)


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_rnn_checkpoints_load_in_the_other_package(tmp_path, writer):
    def fused(mx):
        return mx.rnn.FusedRNNCell(4, num_layers=2, mode="lstm",
                                   prefix="f_")
    vec = np.random.RandomState(5).normal(
        0, 1, rnn_param_size("lstm", 3, 4, 2, False)).astype(np.float32)
    head = np.ones((2, 2), np.float32)
    wmx, rmx = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    wcell = fused(wmx)
    net, _ = wcell.unroll(3, wmx.sym.Variable("data"), merge_outputs=True)
    kw = {} if wmx is jmx else {"ctx": tmx.cpu()}
    prefix = str(tmp_path / "rnn")
    wmx.rnn.save_rnn_checkpoint(
        wcell, prefix, 3, net,
        {"f_parameters": wmx.nd.array(vec, **kw),
         "head": wmx.nd.array(head, **kw)}, {})
    sym, args, aux = rmx.rnn.load_rnn_checkpoint(fused(rmx), prefix, 3)
    assert sym.tojson() == net.tojson()
    assert sorted(args) == ["f_parameters", "head"] and aux == {}
    np.testing.assert_array_equal(args["f_parameters"].asnumpy(), vec)
    np.testing.assert_array_equal(args["head"].asnumpy(), head)
    # the file holds the per-gate arrays: the unfused cells read it
    _sym, plain, _aux = rmx.model.load_checkpoint(prefix, 3)
    assert "f_l_1_h2h_o_weight" in plain and "f_parameters" not in plain


def test_do_rnn_checkpoint_saves_every_period(tmp_path):
    cell = tmx.rnn.LSTMCell(2, prefix="p_")
    net, _ = cell.unroll(2, tmx.sym.Variable("data"), merge_outputs=True)
    args = {k: tmx.nd.array(v, ctx=tmx.cpu())
            for k, v in _weights(net, (1, 2, 3)).items()}
    cb = tmx.rnn.do_rnn_checkpoint(cell, str(tmp_path / "p"), period=2)
    for epoch in range(4):
        cb(epoch, net, args, {})
    # each epoch's .params committed by its CRC manifest
    assert sorted(os.listdir(tmp_path)) == [
        "p-0002.manifest.json", "p-0002.params", "p-0004.manifest.json",
        "p-0004.params", "p-symbol.json"]
    _sym, back, _aux = tmx.rnn.load_rnn_checkpoint(cell, str(tmp_path / "p"),
                                                   4)
    for k, v in args.items():
        np.testing.assert_array_equal(back[k].asnumpy(), v.asnumpy())
