"""Object-registry helpers (reference ``python/mxnet/registry.py``).

The counterpart of ``mxnet_tpu/registry.py``, the same code: register,
alias and create factories keyed by a base class.  ``create`` takes a
name, a ``json.dumps([name, kwargs])`` string (the reference's
cross-process form, used to ship an optimizer to a kvstore server) or an
instance, which it returns unchanged.
"""
from __future__ import annotations

import json
import logging

from .base import MXNetError

_REGISTRIES = {}


def _registry(base_class):
    return _REGISTRIES.setdefault(id(base_class), {})


def get_register_func(base_class, nickname):
    registry = _registry(base_class)

    def register(klass, name=None):
        name = (name or klass.__name__).lower()
        if name in registry:
            logging.warning("New %s %s registered with name %s is overriding "
                            "existing %s", nickname, klass, name, nickname)
        registry[name] = klass
        return klass

    register.__doc__ = "Register %s to the %s factory" % (nickname, nickname)
    return register


def get_alias_func(base_class, nickname):
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for a in aliases:
                register(klass, a)
            return klass
        return reg
    return alias


def get_create_func(base_class, nickname):
    registry = _registry(base_class)

    def create(*args, **kwargs):
        if len(args):
            name = args[0]
            args = args[1:]
        else:
            name = kwargs.pop(nickname)
        if not isinstance(name, str):
            return name  # already an instance
        if name.startswith("["):
            assert not args and not kwargs
            name, kwargs = json.loads(name)
            return create(name, **kwargs)
        if name.lower() not in registry:
            raise MXNetError("%s is not registered as a %s factory"
                             % (name, nickname))
        return registry[name.lower()](*args, **kwargs)

    create.__doc__ = "Create a %s instance from config" % nickname
    return create
