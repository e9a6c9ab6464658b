"""``mx.autograd`` over torch's autograd against the JAX package's tape on
the CPU, value for value (f32: rtol 1e-5 and atol 1e-5 of the array's largest
magnitude, since the two sum in different orders): ``grad_req``
write/add/null, head gradients, ``retain_graph``, ``pause``, the train
mode, Dropout under ``record``, ``grad_and_loss`` and ``contrib.autograd``,
the flows of ``tests/test_operator.py`` (SoftmaxOutput's p - onehot,
BatchNorm in inference and training), an imperative SGD loop whose
weights ``nd.sgd_update`` rewrites in place between records, and the
writes ``record()`` turns into rebinds (``+=`` and auxiliary states), which
must leave the recorded graph whole."""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

TOL = 1e-5
CPU = mx.cpu()


def close(got, want):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    want = want.asnumpy() if hasattr(want, "asnumpy") else np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, TOL, TOL * max(scale, 1e-30))


def _array(pkg, x):
    """``x`` as an NDArray of ``pkg`` on the CPU."""
    return mx.nd.array(x, ctx=CPU) if pkg is mx else jmx.nd.array(x)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (4, 3)).astype(np.float32),
            rng.normal(0, 1, (2, 3)).astype(np.float32))


def _loss(pkg, x, w):
    h = pkg.nd.FullyConnected(x, w, num_hidden=2, no_bias=True)
    return (pkg.nd.tanh(h) * h).sum()


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req(req):
    x0, w0 = _inputs()
    outs = []
    for pkg in (mx, jmx):
        x, w = (_array(pkg, v) for v in (x0, w0))
        gx, gw = pkg.nd.ones_like(x), pkg.nd.zeros_like(w)
        pkg.autograd.mark_variables([x, w], [gx, gw], [req, "write"])
        for _ in range(2):
            with pkg.autograd.record():
                loss = _loss(pkg, x, w)
            pkg.autograd.backward([loss])
        outs.append((gx.asnumpy(), gw.asnumpy()))
    close(outs[0][0], outs[1][0])
    close(outs[0][1], outs[1][1])
    if req == "null":
        np.testing.assert_array_equal(outs[0][0], 1.0)


def _run(pkg, fn, *arrays, **kw):
    xs = [_array(pkg, a) for a in arrays]
    grads = [pkg.nd.zeros_like(x) for x in xs]
    pkg.autograd.mark_variables(xs, grads)
    return fn(pkg, xs, grads, **kw)


def test_head_gradients():
    x0, w0 = _inputs(1)
    g0 = np.random.RandomState(2).normal(0, 1, (4, 2)).astype(np.float32)

    def fn(pkg, xs, grads):
        with pkg.autograd.record():
            h = pkg.nd.FullyConnected(xs[0], xs[1], num_hidden=2,
                                      no_bias=True)
            y = pkg.nd.sigmoid(h)
        og = _array(pkg, g0)
        pkg.autograd.backward([y], [og])
        return [g.asnumpy() for g in grads]

    for got, want in zip(_run(mx, fn, x0, w0), _run(jmx, fn, x0, w0)):
        close(got, want)


def test_retain_graph():
    x0, w0 = _inputs(3)

    def fn(pkg, xs, grads):
        with pkg.autograd.record():
            loss = _loss(pkg, xs[0], xs[1])
        pkg.autograd.backward([loss], retain_graph=True)
        first = [g.asnumpy() for g in grads]
        pkg.autograd.backward([loss])
        return first + [g.asnumpy() for g in grads]

    got, want = _run(mx, fn, x0, w0), _run(jmx, fn, x0, w0)
    for a, b in zip(got, want):
        close(a, b)
    close(got[0], got[2])


def test_pause_leaves_ops_unrecorded():
    x0, _ = _inputs(4)

    def fn(pkg, xs, grads):
        with pkg.autograd.record():
            y = xs[0] * 2
            with pkg.autograd.pause():
                assert not pkg.autograd.is_recording()
                z = y * 3
            w = (y * z).sum()
        pkg.autograd.backward([w])
        return grads[0].asnumpy()

    got = _run(mx, fn, x0)
    close(got, _run(jmx, fn, x0))
    close(got, 12 * x0)


def test_train_mode_flags():
    for pkg in (mx, jmx):
        assert not pkg.autograd.is_training()
        with pkg.autograd.record():
            assert pkg.autograd.is_training() and pkg.autograd.is_recording()
        with pkg.autograd.test_section():
            assert not pkg.autograd.is_training()
            assert pkg.autograd.is_recording()
        with pkg.autograd.train_section():
            assert pkg.autograd.is_training()
        assert pkg.autograd.set_is_training(True) is False
        assert pkg.autograd.set_is_training(False) is True


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_under_record_in_either_mode(train):
    """BatchNorm recorded in either mode; the JAX package replays its tape
    in ``backward``'s train mode, so it is given the recording's (the
    port differentiates the forward as it ran)."""
    rng = np.random.RandomState(5)
    x0 = rng.normal(2, 1, (4, 3, 2, 2)).astype(np.float32)
    g0 = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    b0 = rng.normal(0, 1, 3).astype(np.float32)
    mm0 = rng.normal(0, 1, 3).astype(np.float32)
    mv0 = rng.uniform(0.5, 1.5, 3).astype(np.float32)

    def fn(pkg, xs, grads):
        mm, mv = (_array(pkg, v) for v in (mm0, mv0))
        with pkg.autograd.record(train_mode=train):
            out = pkg.nd.BatchNorm(xs[0], xs[1], xs[2], mm, mv,
                                   fix_gamma=False)
            loss = (out * out * xs[0]).sum()
        pkg.autograd.backward([loss], train_mode=train)
        return [out.asnumpy(), mm.asnumpy(), mv.asnumpy()] + \
            [g.asnumpy() for g in grads]

    got = _run(mx, fn, x0, g0, b0)
    for a, b in zip(got, _run(jmx, fn, x0, g0, b0)):
        close(a, b)
    assert np.allclose(got[1], mm0) != train


@pytest.mark.parametrize("recorded", [True, False])
def test_backward_holds_train_mode_to_the_recording(recorded):
    """The port runs the forward once and does not replay it: a BatchNorm
    recorded in one mode and differentiated with ``train_mode`` set to the
    other raises, where the JAX package would give the other mode's
    gradients.  ``train_mode=None`` (the default) and the recording's own
    mode give the JAX package's gradients in the recording's mode, and a
    graph that reaches no op of the other mode does not raise."""
    rng = np.random.RandomState(9)
    x0 = rng.normal(1, 2, (4, 3, 2, 2)).astype(np.float32)
    mm0 = rng.normal(0, 1, 3).astype(np.float32)
    mv0 = rng.uniform(0.5, 1.5, 3).astype(np.float32)

    def forward(pkg, x, train):
        mm, mv = (_array(pkg, v) for v in (mm0, mv0))
        gamma, beta = _array(pkg, np.ones(3, np.float32)), \
            _array(pkg, np.zeros(3, np.float32))
        with pkg.autograd.record(train_mode=train):
            out = pkg.nd.BatchNorm(x, gamma, beta, mm, mv, fix_gamma=False)
            return (out * out * x).sum()

    grads = {}
    for pkg, mode in ((mx, None), (mx, recorded), (jmx, recorded)):
        x = _array(pkg, x0)
        x.attach_grad()
        loss = forward(pkg, x, recorded)
        pkg.autograd.backward([loss], train_mode=mode)
        grads[pkg, mode] = x.grad.asnumpy()
    close(grads[mx, None], grads[jmx, recorded])
    close(grads[mx, recorded], grads[jmx, recorded])

    x = _array(mx, x0)
    x.attach_grad()
    loss = forward(mx, x, recorded)
    with pytest.raises(mx.MXNetError, match="train_mode=%s" % (
            not recorded)):
        mx.autograd.backward([loss], train_mode=not recorded)
    # an op of the other mode that the outputs do not reach
    forward(mx, x, not recorded)
    loss = forward(mx, x, recorded)
    mx.autograd.backward([loss], train_mode=recorded)
    close(x.grad, grads[jmx, recorded])


def test_dropout_under_record():
    """Dropout draws its mask from the device's generator (bits differ
    from the JAX package's); kept elements are scaled by 1 / (1 - p) and
    the gradient follows the same mask; the same seed gives the same
    mask; outside training it is the identity."""
    x = mx.nd.array(np.ones((200, 50), np.float32), ctx=CPU)
    x.attach_grad()
    masks = []
    for _ in range(2):
        mx.random.seed(11)
        with mx.autograd.record():
            y = mx.nd.Dropout(x, p=0.25)
        y.backward()
        masks.append(y.asnumpy())
        np.testing.assert_allclose(x.grad.asnumpy(), y.asnumpy())
    np.testing.assert_array_equal(masks[0], masks[1])
    assert set(np.unique(masks[0])) == {0.0, np.float32(1 / 0.75)}
    assert abs((masks[0] == 0).mean() - 0.25) < 0.02
    with mx.autograd.record(train_mode=False):
        z = mx.nd.Dropout(x, p=0.25)
    np.testing.assert_array_equal(z.asnumpy(), 1.0)


def test_grad_and_loss_and_contrib():
    x0, w0 = _inputs(6)
    results = []
    for pkg in (mx, jmx):
        x, w = (_array(pkg, v) for v in (x0, w0))
        grads, loss = pkg.autograd.grad_and_loss(
            lambda a, b: _loss(pkg, a, b))(x, w)
        only = pkg.contrib.autograd.grad(lambda a, b: _loss(pkg, a, b),
                                         argnum=1)(x, w)
        xs = [_array(pkg, x0)]
        gs = [pkg.nd.zeros_like(xs[0])]
        pkg.contrib.autograd.mark_variables(xs, gs)
        with pkg.contrib.autograd.train_section():
            out = (xs[0] * xs[0]).sum()
        pkg.contrib.autograd.compute_gradient([out])
        results.append([g.asnumpy() for g in grads] + [loss.asnumpy(),
                                                       only[0].asnumpy(),
                                                       gs[0].asnumpy()])
    for a, b in zip(*results):
        close(a, b)


def test_softmax_output_backward_is_p_minus_onehot():
    x0 = np.random.RandomState(7).normal(0, 1, (4, 5)).astype(np.float32)
    label = np.array([0, 2, 4, 1], np.float32)

    def fn(pkg, xs, grads):
        lab = _array(pkg, label)
        with pkg.autograd.record():
            out = pkg.nd.SoftmaxOutput(xs[0], lab)
        pkg.autograd.backward([out])
        return grads[0].asnumpy()

    got = _run(mx, fn, x0)
    close(got, _run(jmx, fn, x0))
    p = np.exp(x0) / np.exp(x0).sum(1, keepdims=True)
    np.testing.assert_allclose(got, p - np.eye(5)[label.astype(int)],
                               1e-5, 1e-6)


def test_batchnorm_inference_and_train_flow():
    x = np.random.RandomState(8).normal(0, 1, (4, 3, 2, 2)) \
        .astype(np.float32)
    res = []
    for pkg in (mx, jmx):
        def arr(v):
            return _array(pkg, v)
        ones, zeros = np.ones(3, np.float32), np.zeros(3, np.float32)
        inf = pkg.nd.BatchNorm(arr(x), arr(ones), arr(zeros), arr(zeros),
                               arr(ones), fix_gamma=False)
        mm, mv = arr(zeros), arr(ones)
        with pkg.autograd.record():
            out = pkg.nd.BatchNorm(arr(x), arr(ones), arr(zeros), mm, mv,
                                   fix_gamma=False, momentum=0.9)
        res.append([inf.asnumpy(), mm.asnumpy(), mv.asnumpy(),
                    out.asnumpy()])
    for a, b in zip(*res):
        close(a, b)
    close(res[0][0], x / np.sqrt(1 + 1e-3))
    close(res[0][1], 0.1 * x.mean(axis=(0, 2, 3)))


def _mlp_loop(pkg, steps=4):
    """The verify skill's imperative loop at a small width:
    mark_variables, record, FullyConnected/Activation/SoftmaxOutput,
    backward, sgd_update(out=w) in place."""
    rng = np.random.RandomState(9)
    x0 = rng.normal(0, 1, (16, 12)).astype(np.float32)
    y0 = rng.randint(0, 4, 16).astype(np.float32)
    shapes = [(8, 12), (8,), (4, 8), (4,)]
    init = [rng.normal(0, 0.3, s).astype(np.float32) for s in shapes]
    params = [_array(pkg, v) for v in init]
    grads = [pkg.nd.zeros_like(p) for p in params]
    pkg.autograd.mark_variables(params, grads)
    x, y = _array(pkg, x0), _array(pkg, y0)
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            h = pkg.nd.FullyConnected(x, params[0], params[1], num_hidden=8)
            h = pkg.nd.Activation(h, act_type="relu")
            h = pkg.nd.FullyConnected(h, params[2], params[3], num_hidden=4)
            out = pkg.nd.SoftmaxOutput(h, y)
        pkg.autograd.backward([out])
        p = out.asnumpy()
        losses.append(-np.log(p[np.arange(16), y0.astype(int)]).mean())
        for w, g in zip(params, grads):
            pkg.nd.sgd_update(w, g, out=w, lr=0.2)
    return losses, [w.asnumpy() for w in params]


def test_imperative_sgd_loop_matches_jax():
    losses, params = _mlp_loop(mx)
    jlosses, jparams = _mlp_loop(jmx)
    close(np.array(losses), np.array(jlosses))
    for a, b in zip(params, jparams):
        close(a, b)
    assert losses[-1] < losses[0]


def test_inplace_add_under_record_keeps_the_graph():
    x = mx.nd.array(np.array([1.0, -2.0, 3.0], np.float32), ctx=CPU)
    x.attach_grad()
    with mx.autograd.record():
        y = x * 2
        y += x                       # y = 3x: rebound, not written
        z = (y * y).sum()
    z.backward()
    close(x.grad, 18 * x.asnumpy())
    with mx.autograd.record():
        with pytest.raises(mx.MXNetError, match="marked variable"):
            x += 1


def test_setitem_under_record_rebinds():
    x = mx.nd.array(np.arange(4, dtype=np.float32), ctx=CPU)
    x.attach_grad()
    with mx.autograd.record():
        y = x * x
        y[0] = 10.0
        loss = y.sum()
    loss.backward()
    close(x.grad, np.array([0, 2, 4, 6], np.float32))
