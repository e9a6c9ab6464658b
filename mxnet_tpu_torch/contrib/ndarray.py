"""Prefix-free access to the contrib ops: ``mx.contrib.nd.X`` is
``mx.nd._contrib_X``."""
from .. import ndarray as _mod

_PREFIX = "_contrib_"


def _populate():
    g = globals()
    for name in dir(_mod):
        if name.startswith(_PREFIX):
            g[name[len(_PREFIX):]] = getattr(_mod, name)


_populate()
