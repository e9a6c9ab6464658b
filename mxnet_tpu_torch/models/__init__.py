"""The model zoo, built with the port's ``mx.sym``: the counterpart of
``mxnet_tpu/models/`` (the reference's
``example/image-classification/symbols/``) with the GPT of
``examples/transformer/train_lm.py`` beside it.

Each zoo module exposes ``get_symbol(num_classes, ...)``, and the same
arguments build the same Symbol JSON in both packages.  ``get_model`` is
the name-keyed dispatch the tools use."""
from __future__ import annotations

import importlib

_MODELS = ("mlp", "lenet", "alexnet", "vgg", "resnet", "inception_bn",
           "inception_v3", "inception_resnet_v2", "googlenet", "resnext")


def get_model(name, **kwargs):
    """Build a symbol by model name; ``-`` reads as ``_``, and the depth
    (and a ResNeXt's cardinality and width) may be spelled in the name:
    ``inception-bn``, ``resnet-50``/``resnet50``, ``vgg16``,
    ``resnext-101-64x4d``.  An unknown name raises ``ValueError``."""
    name = name.replace("-", "_")
    if name.startswith("resnext") and name != "resnext":
        # resnext_101_64x4d: depth, then cardinality x width
        parts = name.split("_")[1:]
        if parts:
            kwargs.setdefault("num_layers", int(parts[0]))
        if len(parts) > 1 and "x" in parts[1]:
            g, w = parts[1].split("x")
            kwargs.setdefault("num_group", int(g))
            kwargs.setdefault("bottleneck_width", int(w.rstrip("d")))
        name = "resnext"
    if name.startswith("resnet") and name != "resnet":
        kwargs.setdefault("num_layers",
                          int(name[len("resnet"):].lstrip("_")))
        name = "resnet"
    if name.startswith("vgg") and name != "vgg":
        kwargs.setdefault("num_layers", int(name[len("vgg"):]))
        name = "vgg"
    if name not in _MODELS:
        raise ValueError("unknown model %r (have %s)" % (name, _MODELS))
    mod = importlib.import_module("." + name, __package__)
    return mod.get_symbol(**kwargs)
