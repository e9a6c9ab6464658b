"""Prefix-free access to the contrib ops: ``mx.contrib.sym.X`` is
``mx.sym._contrib_X``."""
from .. import symbol as _mod

_PREFIX = "_contrib_"


def _populate():
    g = globals()
    for name in dir(_mod):
        if name.startswith(_PREFIX):
            g[name[len(_PREFIX):]] = getattr(_mod, name)


_populate()
