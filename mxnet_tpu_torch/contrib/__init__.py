"""The contrib namespace, as ``mxnet_tpu.contrib``: ``mx.contrib.autograd``
is the reference's imperative autograd surface; ``nd``/``sym`` reach the
``_contrib_*`` ops without their prefix (``mx.contrib.nd.FlashAttention``
is ``mx.nd._contrib_FlashAttention``)."""
from . import autograd
from . import ndarray
from . import ndarray as nd
from . import symbol
from . import symbol as sym
