"""Torch interop: PyTorch modules and criterions as graph operators, and
torch tensor functions on NDArrays.

The counterpart of ``mxnet_tpu/torch.py`` (reference ``plugin/torch`` and
``python/mxnet/torch.py``)::

    import torch.nn as tnn
    net = mx.sym.TorchModule(data, module=tnn.Linear(64, 10), name="fc")
    loss = mx.sym.TorchCriterion(net, label,
                                 criterion=tnn.CrossEntropyLoss())
    y = mx.th.mm(a, b)

The JAX bridge runs the module on the host through ``Custom``'s callback
(a round trip a call).  Here the graph's tensors are torch tensors
already, so the module runs on the tensors' own device, under autograd:

* ``TorchModule``: the module's parameters are graph arguments named
  ``<name>_torch_param_<i>_weight`` (the JAX names, so ``.params`` files
  carry over), and the forward is ``torch.func.functional_call`` of the
  module with them, so their gradients flow to the graph's gradient
  arrays; the module's buffers are moved to the data's device;
* ``TorchCriterion``: a loss head whose forward is the criterion's scalar
  loss broadcast per sample (a ``reduction='none'`` vector is averaged)
  and whose backward is d loss / d input whatever the head gradient, the
  label's gradient zero, as in the JAX bridge;
* ``mx.th.<fn>``: ``torch.<fn>`` on the NDArrays' tensors, returning
  NDArrays on the same device.

Bridge symbols are not serializable: the module object is kept in this
process, keyed by its ``id``, as in the JAX package.
"""
from __future__ import annotations

import torch as _torch

from . import operator as _op
from . import ndarray as _nd
from .base import MXNetError

__all__ = ["torch_module_symbol", "torch_criterion_symbol"]

_MODULES = {}
_CRITERIA = {}


def _lookup(table, key, what, builder):
    try:
        return table[str(key)]
    except KeyError:
        raise MXNetError(
            "%s symbol refers to a live torch object (key %r) that is not "
            "registered in this process.  Torch bridge symbols are NOT "
            "serializable: rebuild the symbol with mx.sym.%s(...) so the "
            "object is registered again." % (what, str(key), builder))


@_op.register("_torch_module")
class _TorchModuleProp(_op.CustomOpProp):
    """The module as an operator; :meth:`device_forward` runs it on the
    inputs' device under autograd."""

    def __init__(self, module_key):
        super().__init__(need_top_grad=True)
        self.module = _lookup(_MODULES, module_key, "TorchModule",
                              "TorchModule")
        self._names = [n for n, _p in self.module.named_parameters()]

    def list_arguments(self):
        return ["data"] + ["torch_param_%d_weight" % i
                           for i in range(len(self._names))]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        mod = self.module
        meta = {n: _torch.empty_like(t, device="meta") for n, t in
                list(mod.named_parameters()) + list(mod.named_buffers())}
        with _torch.no_grad():
            out = _torch.func.functional_call(
                mod, meta, (_torch.zeros(*in_shape[0], device="meta"),))
        return ([tuple(in_shape[0])]
                + [tuple(p.shape) for p in self.module.parameters()],
                [tuple(out.shape)], [])

    def device_forward(self, is_train, args):
        x, params = args[0], args[1:]
        mod = self.module
        if any(b.device != x.device for b in mod.buffers()):
            mod.to(x.device)
        return [_torch.func.functional_call(
            mod, dict(zip(self._names, params)), (x,))]


class _CriterionFn(_torch.autograd.Function):
    """The criterion's loss broadcast per sample; backward d loss / d
    input, whatever the head gradient (a loss head), label gradient 0."""

    @staticmethod
    def forward(fctx, criterion, label_dtype, x, label):
        with _torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            loss = criterion(xg, _label(label, label_dtype))
            if loss.dim() > 0:
                loss = loss.mean()
            (gx,) = _torch.autograd.grad(loss, [xg])
        fctx.save_for_backward(gx, label)
        return loss.detach().float().expand(x.shape[0]).contiguous()

    @staticmethod
    def backward(fctx, _grad):
        gx, label = fctx.saved_tensors
        return None, None, gx, _torch.zeros_like(label)


def _label(label, label_dtype):
    return label.long() if label_dtype == "long" else label


@_op.register("_torch_criterion")
class _TorchCriterionProp(_op.CustomOpProp):
    def __init__(self, criterion_key, label_shape="", label_dtype="long"):
        super().__init__(need_top_grad=False)
        self.criterion = _lookup(_CRITERIA, criterion_key,
                                 "TorchCriterion", "TorchCriterion")
        self.label_dtype = str(label_dtype)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return ([tuple(in_shape[0]), tuple(in_shape[1])],
                [(in_shape[0][0],)], [])

    def device_forward(self, is_train, args):
        x, label = args
        return [_CriterionFn.apply(self.criterion, self.label_dtype, x,
                                   label)]


def torch_module_symbol(data, module, name="torch"):
    """Symbol wrapping a ``torch.nn.Module`` (``mx.sym.TorchModule``)."""
    from . import symbol as _sym
    key = str(id(module))
    _MODULES[key] = module
    return _sym.Custom(data=data, op_type="_torch_module", module_key=key,
                       name=name)


def torch_criterion_symbol(data, label, criterion, label_dtype="long",
                           name="torch_loss"):
    """Symbol wrapping a torch loss (``mx.sym.TorchCriterion``)."""
    from . import symbol as _sym
    key = str(id(criterion))
    _CRITERIA[key] = criterion
    return _sym.Custom(data=data, label=label, op_type="_torch_criterion",
                       criterion_key=key, label_dtype=label_dtype,
                       name=name)


# ------------------------------------------------------ mx.th.<fn>
def _make_th_function(fname):
    def fn(*args, **kwargs):
        tfn = getattr(_torch, fname)
        targs = [a.data if isinstance(a, _nd.NDArray) else a for a in args]
        out = tfn(*targs, **kwargs)
        if isinstance(out, tuple):
            return tuple(_nd.NDArray(o) for o in out)
        return _nd.NDArray(out)
    fn.__name__ = fname
    fn.__doc__ = ("torch.%s on NDArrays, on their device (reference "
                  "mx.th.* generated functions)" % fname)
    return fn


_TH_FUNCS = ["add", "mul", "div", "sub", "mm", "bmm", "exp", "log",
             "sqrt", "abs", "sigmoid", "tanh", "clamp", "sort", "topk",
             "cumsum", "cumprod", "softmax", "log_softmax", "norm",
             "var", "std", "median", "conv1d", "conv2d"]

for _f in _TH_FUNCS:
    if callable(getattr(_torch, _f, None)):
        globals()[_f] = _make_th_function(_f)
        __all__.append(_f)
