"""Model definitions of the port: Symbols built with ``mx.sym``."""
