"""Model definitions of the port: Symbols built with ``mx.sym``.

``get_model`` is the JAX package's name-keyed dispatch
(``mxnet_tpu/models/__init__.py``) over the models ported so far."""
from __future__ import annotations

import importlib

from ..base import MXNetError

_MODELS = ("resnet", "vgg")


def get_model(name, **kwargs):
    """Build a symbol by model name: ``resnet`` or ``vgg`` with
    ``num_layers``, or ``resnet50`` / ``resnet-50`` / ``vgg16`` spelling
    the depth in the name."""
    name = name.replace("-", "_")
    if name.startswith("vgg") and name != "vgg":
        kwargs.setdefault("num_layers", int(name[len("vgg"):].lstrip("_")))
        name = "vgg"
    if name.startswith("resnet") and name != "resnet":
        kwargs.setdefault("num_layers",
                          int(name[len("resnet"):].lstrip("_")))
        name = "resnet"
    if name not in _MODELS:
        raise MXNetError("model %r is not yet ported to mxnet_tpu_torch "
                         "(have %s)" % (name, ", ".join(_MODELS)))
    mod = importlib.import_module("." + name, __package__)
    return mod.get_symbol(**kwargs)
