"""Inception-ResNet-v2 symbol factory.

Reference: ``example/image-classification/symbols/inception-resnet-v2.py``
(Szegedy et al., "Inception-v4, Inception-ResNet and the Impact of
Residual Connections on Learning").  The residual scale factors (0.17 /
0.1 / 0.2) follow the reference.
"""
from __future__ import annotations

from .. import symbol as sym


def _conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
          with_act=True):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad)
    bn = sym.BatchNorm(data=conv)
    if with_act:
        return sym.Activation(data=bn, act_type="relu")
    return bn


def _residual_block(net, channels, towers, scale, with_act=True):
    """Concat the towers, 1x1 back to ``channels``, scaled residual add."""
    mixed = sym.Concat(*towers)
    up = _conv(mixed, channels, (1, 1), with_act=False)
    net = net + scale * up
    if with_act:
        return sym.Activation(data=net, act_type="relu")
    return net


def block35(net, channels, scale=1.0, with_act=True):
    t0 = _conv(net, 32, (1, 1))
    t1 = _conv(_conv(net, 32, (1, 1)), 32, (3, 3), pad=(1, 1))
    t2 = _conv(_conv(_conv(net, 32, (1, 1)), 48, (3, 3), pad=(1, 1)),
               64, (3, 3), pad=(1, 1))
    return _residual_block(net, channels, [t0, t1, t2], scale, with_act)


def block17(net, channels, scale=1.0, with_act=True):
    t0 = _conv(net, 192, (1, 1))
    t1 = _conv(_conv(_conv(net, 129, (1, 1)), 160, (1, 7), pad=(1, 2)),
               192, (7, 1), pad=(2, 1))
    return _residual_block(net, channels, [t0, t1], scale, with_act)


def block8(net, channels, scale=1.0, with_act=True):
    t0 = _conv(net, 192, (1, 1))
    t1 = _conv(_conv(_conv(net, 192, (1, 1)), 224, (1, 3), pad=(0, 1)),
               256, (3, 1), pad=(1, 0))
    return _residual_block(net, channels, [t0, t1], scale, with_act)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable(name="data")
    net = _conv(data, 32, (3, 3), stride=(2, 2))
    net = _conv(net, 32, (3, 3))
    net = _conv(net, 64, (3, 3), pad=(1, 1))
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    net = _conv(net, 80, (1, 1))
    net = _conv(net, 192, (3, 3))
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")

    # mixed 5b
    t0 = _conv(net, 96, (1, 1))
    t1 = _conv(_conv(net, 48, (1, 1)), 64, (5, 5), pad=(2, 2))
    t2 = _conv(_conv(_conv(net, 64, (1, 1)), 96, (3, 3), pad=(1, 1)),
               96, (3, 3), pad=(1, 1))
    t3 = _conv(sym.Pooling(data=net, kernel=(3, 3), stride=(1, 1),
                           pad=(1, 1), pool_type="avg"), 64, (1, 1))
    net = sym.Concat(*[t0, t1, t2, t3])

    for _ in range(10):
        net = block35(net, 320, scale=0.17)

    # reduction A
    t0 = _conv(net, 384, (3, 3), stride=(2, 2))
    t1 = _conv(_conv(_conv(net, 256, (1, 1)), 256, (3, 3), pad=(1, 1)),
               384, (3, 3), stride=(2, 2))
    tp = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                     pool_type="max")
    net = sym.Concat(*[t0, t1, tp])

    for _ in range(20):
        net = block17(net, 1088, scale=0.1)

    # reduction B
    t0 = _conv(_conv(net, 256, (1, 1)), 384, (3, 3), stride=(2, 2))
    t1 = _conv(_conv(net, 256, (1, 1)), 288, (3, 3), stride=(2, 2))
    t2 = _conv(_conv(_conv(net, 256, (1, 1)), 288, (3, 3), pad=(1, 1)),
               320, (3, 3), stride=(2, 2))
    tp = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                     pool_type="max")
    net = sym.Concat(*[t0, t1, t2, tp])

    for _ in range(9):
        net = block8(net, 2080, scale=0.2)
    net = block8(net, 2080, with_act=False)

    net = _conv(net, 1536, (1, 1))
    net = sym.Pooling(data=net, kernel=(1, 1), global_pool=True,
                      stride=(2, 2), pool_type="avg")
    net = sym.Flatten(net)
    net = sym.Dropout(data=net, p=0.2)
    net = sym.FullyConnected(data=net, num_hidden=num_classes)
    return sym.SoftmaxOutput(data=net, name="softmax")
