"""VGG symbol: the counterpart of ``mxnet_tpu/models/vgg.py`` (the
reference's ``example/image-classification/symbols/vgg.py``)."""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["VGG_CONFIG", "FILTERS", "get_symbol"]

#: depth -> convolutions a stage
VGG_CONFIG = {
    11: [1, 1, 2, 2, 2],
    13: [2, 2, 2, 2, 2],
    16: [2, 2, 3, 3, 3],
    19: [2, 2, 4, 4, 4],
}
FILTERS = [64, 128, 256, 512, 512]


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False, **kwargs):
    if num_layers not in VGG_CONFIG:
        raise ValueError("invalid vgg depth %d" % num_layers)
    body = sym.Variable(name="data")
    for i, num in enumerate(VGG_CONFIG[num_layers]):
        for j in range(num):
            body = sym.Convolution(data=body, kernel=(3, 3), pad=(1, 1),
                                   num_filter=FILTERS[i],
                                   name="conv%d_%d" % (i + 1, j + 1))
            if batch_norm:
                body = sym.BatchNorm(data=body,
                                     name="bn%d_%d" % (i + 1, j + 1))
            body = sym.Activation(data=body, act_type="relu",
                                  name="relu%d_%d" % (i + 1, j + 1))
        body = sym.Pooling(data=body, pool_type="max", kernel=(2, 2),
                           stride=(2, 2), name="pool%d" % (i + 1))
    flatten = sym.Flatten(data=body, name="flatten")
    fc6 = sym.FullyConnected(data=flatten, num_hidden=4096, name="fc6")
    relu6 = sym.Activation(data=fc6, act_type="relu", name="relu6")
    drop6 = sym.Dropout(data=relu6, p=0.5, name="drop6")
    fc7 = sym.FullyConnected(data=drop6, num_hidden=4096, name="fc7")
    relu7 = sym.Activation(data=fc7, act_type="relu", name="relu7")
    drop7 = sym.Dropout(data=relu7, p=0.5, name="drop7")
    fc8 = sym.FullyConnected(data=drop7, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(data=fc8, name="softmax")
