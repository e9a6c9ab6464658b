"""NDArray: the imperative tensor, a handle over a ``torch.Tensor``.

The counterpart of ``mxnet_tpu/ndarray.py``, reduced to what the serving
path and the Module path need: creation, copies, slices along axis 0,
``save``/``load``, and one function per registered op (``nd.<op>(...,
out=)``, run without autograd) plus the optimizer update ops
(``nd.sgd_mom_update(w, g, m, out=w, ...)``).  Unlike the JAX package,
whose arrays are immutable, an NDArray here is a mutable tensor: ``arr[:] =
v`` copies into the existing storage, and ``arr[a:b]`` is a view of it.

``save``/``load`` keep the reference's name-prefixed container layout
(``u64 magic, u64 reserved, u64 n, arrays..., u64 n_names, names...``; each
array ``u32 ndim, u32*ndim shape, i32 dev_type, i32 dev_id, i32 type_flag,
raw data``), byte for byte the JAX package's format, so a ``.params`` file
written by either package loads in the other.
"""
from __future__ import annotations

import io
import struct

import numpy as _np
import torch

from .base import (MXNetError, DTYPE_ID_TO_TORCH, dtype_id, dtype_np,
                   torch_dtype)
from .context import context_of, current_context

__all__ = ["NDArray", "array", "zeros", "ones", "empty", "waitall", "save",
           "load", "load_buffer", "sgd_update", "sgd_mom_update",
           "adam_update", "rmsprop_update", "rmspropalex_update"]


def _device(ctx):
    return (ctx or current_context()).torch_device()


class NDArray:
    """Multi-dimensional array on a device context."""

    __slots__ = ("_data",)

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray wraps a torch.Tensor, got %r"
                            % type(data).__name__)
        self._data = data

    @property
    def data(self):
        """The underlying ``torch.Tensor``."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return dtype_np(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()


    @property
    def context(self):
        return context_of(self._data.device)

    def __repr__(self):
        return "<NDArray %s @%s %s>" % ("x".join(map(str, self.shape)),
                                        self.context, self._data.dtype)

    def asnumpy(self):
        """Copy to a host numpy array (waits for the device)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(
                dtype_np("bfloat16"))
        return t.cpu().numpy()

    def as_in_context(self, ctx):
        if self.context == ctx:
            return self
        return NDArray(self._data.to(ctx.torch_device()))

    def copy(self):
        """A copy on the same context."""
        return NDArray(self._data.detach().clone())

    def copyto(self, other):
        """Copy into the NDArray ``other`` (returned), or into a new array
        on the Context ``other``."""
        if isinstance(other, NDArray):
            if other is self:
                return other
            other[:] = self
            return other
        return NDArray(self._data.detach().to(other.torch_device(),
                                              copy=True))

    def __getitem__(self, key):
        """An int or a slice along axis 0 (a view, as in the reference);
        other keys index like the tensor and give a copy."""
        if isinstance(key, int):
            return NDArray(self._data[key])
        if isinstance(key, slice):
            if key.step not in (None, 1):
                raise ValueError("NDArray slices take step 1")
            return NDArray(self._data[key])
        if isinstance(key, NDArray):
            key = key._data
        return NDArray(self._data[key].clone())

    def reshape(self, shape):
        if isinstance(shape, int):
            shape = (shape,)
        return NDArray(self._data.reshape(tuple(shape)))

    def __setitem__(self, key, value):
        value = value._data if isinstance(value, NDArray) else \
            torch.as_tensor(_np.asarray(value))
        self._data[key] = value.to(device=self._data.device,
                                   dtype=self._data.dtype)


# ---------------------------------------------------------------- creation
def array(source, ctx=None, dtype=None):
    """Create an NDArray from any array-like.  Python lists become float32
    and numpy float64 becomes float32, as in the reference."""
    keep_dtype = isinstance(source, _np.ndarray)
    arr = _np.asarray(source, dtype=dtype_np(dtype) if dtype is not None
                      else None)
    if dtype is None and (arr.dtype == _np.float64 or not keep_dtype):
        arr = arr.astype(_np.float32)
    return NDArray(_from_numpy(arr).to(_device(ctx)))


def _from_numpy(arr):
    arr = _np.array(arr, order="C")          # a copy torch may own
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(_np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None):
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def empty(shape, ctx=None, dtype=None):
    return NDArray(torch.empty(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def waitall():
    """Wait for all work queued on every CUDA device."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ------------------------------------------------------------ op functions
def _tensor_of(v):
    return v._data if isinstance(v, NDArray) else v


def _write_out(out, results):
    outs = out if isinstance(out, (list, tuple)) else [out]
    for o, r in zip(outs, results):
        o[:] = NDArray(r)
    return out


def _make_op_function(op):
    """``nd.<op>(*inputs, out=None, **attrs)``: the op run once without
    autograd on its inputs' device (the current context's when it has no
    inputs); NDArray keyword arguments fill named inputs."""
    def fn(*args, out=None, name=None, **kwargs):
        from .ops.registry import OpContext, apply_op
        from . import random as _random
        attrs_in = {k: v for k, v in kwargs.items()
                    if not isinstance(v, NDArray)}
        attrs = op.parse_attrs(attrs_in)
        names = op.get_arg_names(attrs) + op.get_aux_names(attrs)
        slots = dict(zip(names, args))
        slots.update({k: v for k, v in kwargs.items()
                      if isinstance(v, NDArray)})
        ins = [_tensor_of(slots[n]) for n in names if n in slots]
        device = ins[0].device if ins else _device(None)
        octx = OpContext(is_train=False, device=device,
                         generator=_random.generator(device)
                         if op.stochastic else None)
        with torch.no_grad():
            res = apply_op(op, attrs, octx, *ins)[:op.get_num_outputs(attrs)]
        if out is not None:
            return _write_out(out, res)
        res = [NDArray(r) for r in res]
        return res[0] if len(res) == 1 else res
    fn.__name__ = op.name
    fn.__doc__ = op.doc
    return fn


def _make_update_function(impl, n_states):
    """``nd.<update>(weight, grad, *states, out=weight, **hyper)`` over
    NDArrays: the tensor function of :mod:`.ops.optimizer_ops` in place."""
    def fn(weight, grad, *states, out=None, **kwargs):
        if len(states) != n_states:
            raise MXNetError("%s takes %d state arrays, got %d"
                             % (impl.__name__, n_states, len(states)))
        impl(weight._data, _tensor_of(grad),
             *[s._data for s in states],
             out=None if out is None else out._data, **kwargs)
        return weight if out is None else out
    fn.__name__ = impl.__name__
    fn.__doc__ = impl.__doc__
    return fn


def _register_functions():
    from .ops import registry as _registry, optimizer_ops as _oo
    g = globals()
    for opname in _registry.list_ops():
        g.setdefault(opname, _make_op_function(_registry.get_op(opname)))
    for alias, target in _registry.aliases().items():
        g.setdefault(alias, g[target])
    for impl, n_states in ((_oo.sgd_update, 0), (_oo.sgd_mom_update, 1),
                           (_oo.adam_update, 2), (_oo.rmsprop_update, 1),
                           (_oo.rmspropalex_update, 3)):
        g[impl.__name__] = _make_update_function(impl, n_states)


# ------------------------------------------------------------------ save/load
_LIST_MAGIC = 0x112


def _write_str(f, s):
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _read_str(f):
    n, = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _save_one(f, arr):
    t = arr.data.detach().contiguous()
    if t.dim() == 0:
        t = t.reshape(1)        # the JAX package saves a scalar as shape (1,)
    f.write(struct.pack("<I", t.dim()))
    f.write(struct.pack(f"<{t.dim()}I", *t.shape))
    ctx = arr.context
    f.write(struct.pack("<ii", ctx.device_typeid, ctx.device_id))
    f.write(struct.pack("<i", dtype_id(t.dtype)))
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    f.write(t.cpu().numpy().tobytes())


def _load_one(f, device):
    ndim, = struct.unpack("<I", f.read(4))
    shape = struct.unpack(f"<{ndim}I", f.read(4 * ndim)) if ndim else ()
    struct.unpack("<ii", f.read(8))          # saved context: not restored
    tid, = struct.unpack("<i", f.read(4))
    tdt = DTYPE_ID_TO_TORCH[tid]
    count = 1
    for s in shape:
        count *= s
    # bfloat16 travels as its raw 16-bit words; numpy needs no bf16 type
    np_dt = _np.int16 if tdt == torch.bfloat16 else dtype_np(tid)
    raw = bytearray(f.read(count * _np.dtype(np_dt).itemsize))
    t = torch.from_numpy(_np.frombuffer(raw, dtype=np_dt).reshape(shape))
    if tdt == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return NDArray(t.to(device))


def save(fname, data):
    """Save a list of NDArrays or a dict of str -> NDArray."""
    if isinstance(data, NDArray):
        data = [data]
    names, arrays = [], []
    if isinstance(data, dict):
        for k in sorted(data):
            names.append(k)
            arrays.append(data[k])
    else:
        arrays = list(data)
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for a in arrays:
            _save_one(f, a)
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            _write_str(f, n)


def _load_stream(f, what, ctx):
    magic, _ = struct.unpack("<QQ", f.read(16))
    if magic != _LIST_MAGIC:
        raise MXNetError(f"invalid NDArray {what}")
    device = _device(ctx)
    n, = struct.unpack("<Q", f.read(8))
    arrays = [_load_one(f, device) for _ in range(n)]
    m, = struct.unpack("<Q", f.read(8))
    names = [_read_str(f) for _ in range(m)]
    if names:
        return dict(zip(names, arrays))
    return arrays


def load(fname, ctx=None):
    """Load :func:`save`'s format onto ``ctx`` (default: the current
    context); returns a list or a dict, as saved."""
    with open(fname, "rb") as f:
        return _load_stream(f, f"file {fname}", ctx)


def load_buffer(buf, ctx=None):
    """Load NDArrays from in-memory ``.params`` bytes."""
    return _load_stream(io.BytesIO(buf), "buffer", ctx)


_register_functions()
