"""NDArray: the imperative tensor, a handle over a ``torch.Tensor``.

The counterpart of ``mxnet_tpu/ndarray.py``: creation, copies, indexing,
the arithmetic and comparison operators, reductions, ``save``/``load``,
``attach_grad``/``backward`` (:mod:`.autograd`) and one function per
registered op (``nd.<op>(..., out=)``), plus the optimizer update ops
(``nd.sgd_mom_update(w, g, m, out=w, ...)``, in place).

The arrays are mutable, unlike the JAX package's: ``arr[:] = v`` copies
into the existing storage, ``arr[a:b]`` and ``arr[i]`` are views of it,
and the in-place operators (``+=``, ``-=``, ``*=``, ``/=``) and ``out=``
write into it, as in the reference.  Under ``autograd.record()`` those
writes rebind the array to a new tensor instead, so that no tensor the
recorded graph saved is changed (see :mod:`.autograd`).  An op's output
never shares storage with its inputs (a view op's result is copied), so
writing into one cannot change the other.  Comparisons return 0/1 arrays
in the left operand's dtype, as the reference's do.

``nd.<op>`` runs the op as ``mxnet_tpu.ops.imperative_invoke`` does
(:func:`invoke`): NDArray keyword arguments fill named inputs and the
others are attributes; a variadic op's ``num_args`` is counted; the op
runs on its inputs' device (for ops without inputs, ``ctx=`` or the
current context's), with the device's generator for stochastic ops, in
``autograd``'s train mode; auxiliary states (BatchNorm's moving
statistics) and ``mutate`` inputs are written back through the arrays
passed; ``out=`` takes the result in its own dtype.

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
from .context import Context, context_of, current_context
from . import autograd
from . import profiler as _profiler

__all__ = ["NDArray", "array", "zeros", "ones", "empty", "full", "arange",
           "zeros_like", "ones_like", "concatenate", "onehot_encode",
           "imdecode", "waitall", "save", "load", "load_buffer", "invoke",
           "sgd_update", "sgd_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update"]

# the op functions (nd.slice, nd.sum, nd.max, ...) join this module's
# namespace and shadow these builtins below
_py_slice = slice

_NUMBERS = (int, float, bool, _np.generic)


def _device(ctx):
    return (ctx or current_context()).torch_device()


class NDArray:
    """Multi-dimensional array on a device context."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")
    # numpy defers binary operators to these
    __array_priority__ = 100.0

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray wraps a torch.Tensor, got %r"
                            % type(data).__name__)
        self._data = data
        self._grad = None
        self._grad_req = "null"

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
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return context_of(self._data.device)

    ctx = context

    @property
    def T(self):
        return invoke("transpose", self)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous.")
        return bool(self.asscalar())

    def __repr__(self):
        return "<NDArray %s @%s %s>" % ("x".join(map(str, self.shape)),
                                        self.context, self._data.dtype)

    # -------------------------------------------------------------- host sync
    def asnumpy(self):
        """Copy to a host numpy array (waits for the device)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(
                dtype_np("bfloat16"))
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def wait_to_read(self):
        """Wait for the work queued on the array's device."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    # ------------------------------------------------------------- conversion
    def astype(self, dtype):
        return invoke("Cast", self, dtype=dtype_np(dtype).name)

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
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True))
        raise TypeError("copyto does not support type %s"
                        % type(other).__name__)

    def reshape(self, shape, **kwargs):
        """A view of the same storage in ``shape`` (ints, or the
        reference's specials 0 and -1)."""
        if isinstance(shape, int):
            shape = (shape,)
        from .ops.tensor import reshape_target
        return NDArray(self._data.reshape(reshape_target(
            list(shape), list(self.shape))))

    def broadcast_to(self, shape):
        return invoke("broadcast_to", self, shape=tuple(shape))

    def flatten(self):
        return self.reshape((self.shape[0], -1)) if self.ndim > 1 \
            else self.reshape((self.size,))

    # --------------------------------------------------------------- indexing
    def __getitem__(self, key):
        """An int or a step-1 slice along axis 0 (a view, as in the
        reference); other keys index like the tensor and give a copy."""
        if isinstance(key, int):
            return NDArray(self._data[key])
        if isinstance(key, _py_slice):
            if key.step not in (None, 1):
                raise ValueError("NDArray slices take step 1")
            return NDArray(self._data[key])
        if isinstance(key, NDArray):
            key = key._data
        return NDArray(self._data[key].clone())

    def __setitem__(self, key, value):
        value = value._data if isinstance(value, NDArray) else \
            torch.as_tensor(_np.asarray(value))
        value = value.to(device=self._data.device, dtype=self._data.dtype)
        if autograd.is_recording():
            _check_writable(self)
            new = self._data.clone()
            new[key] = value
            self._data = new
            return
        with torch.no_grad():
            self._data[key] = value

    def slice(self, start, stop):
        return self[int(start):int(stop)]

    def at(self, idx):
        return self[int(idx)]

    # ------------------------------------------------------------- arithmetic
    def _binary_op(self, other, op, scalar_op, rscalar_op=None,
                   reverse=False):
        if isinstance(other, _NUMBERS):
            name = (rscalar_op or scalar_op) if reverse else scalar_op
            return invoke(name, self, scalar=float(other))
        if not isinstance(other, NDArray):
            other = array(other, ctx=self.context)
        a, b = (other, self) if reverse else (self, other)
        return invoke(op, a, b)

    def __add__(self, o):
        return self._binary_op(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary_op(o, "broadcast_sub", "_minus_scalar",
                               "_rminus_scalar")

    def __rsub__(self, o):
        return self._binary_op(o, "broadcast_sub", "_minus_scalar",
                               "_rminus_scalar", True)

    def __mul__(self, o):
        return self._binary_op(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary_op(o, "broadcast_div", "_div_scalar",
                               "_rdiv_scalar")

    def __rtruediv__(self, o):
        return self._binary_op(o, "broadcast_div", "_div_scalar",
                               "_rdiv_scalar", True)

    def __mod__(self, o):
        return self._binary_op(o, "broadcast_mod", "_mod_scalar")

    def __pow__(self, o):
        return self._binary_op(o, "broadcast_power", "_power_scalar",
                               "_rpower_scalar")

    def __rpow__(self, o):
        return self._binary_op(o, "broadcast_power", "_power_scalar",
                               "_rpower_scalar", True)

    def __neg__(self):
        return invoke("_mul_scalar", self, scalar=-1.0)

    def __abs__(self):
        return invoke("abs", self)

    def _inplace(self, result):
        _assign(self, result._data)
        return self

    def __iadd__(self, o):
        return self._inplace(self + o)

    def __isub__(self, o):
        return self._inplace(self - o)

    def __imul__(self, o):
        return self._inplace(self * o)

    def __itruediv__(self, o):
        return self._inplace(self / o)

    def _compare(self, o, op, scalar_op):
        if isinstance(o, (NDArray, _np.ndarray) + _NUMBERS):
            return self._binary_op(o, op, scalar_op)
        return NotImplemented

    def __eq__(self, o):
        return self._compare(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        return self._compare(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._compare(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._compare(o, "broadcast_greater_equal",
                             "_greater_equal_scalar")

    def __lt__(self, o):
        return self._compare(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._compare(o, "broadcast_lesser_equal",
                             "_lesser_equal_scalar")

    __hash__ = object.__hash__

    # ---------------------------------------------------------- reduce sugar
    def sum(self, axis=None, keepdims=False):
        return invoke("sum", self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return invoke("mean", self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return invoke("max", self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return invoke("min", self, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None):
        """The first maximum's index as int32 (the ``argmax`` op's is
        float32), as the JAX NDArray's method gives it."""
        return NDArray(torch.argmax(self._data.detach(), axis)
                       .to(torch.int32))

    def argmin(self, axis=None):
        return NDArray(torch.argmin(self._data.detach(), axis)
                       .to(torch.int32))

    # ------------------------------------------------------------- autograd
    def attach_grad(self, grad_req="write"):
        """Mark this array as a variable with a zero gradient array."""
        autograd.mark_variables([self], [zeros_like(self)], grad_req)

    @property
    def grad(self):
        """The gradient array attached by ``attach_grad`` or
        ``autograd.mark_variables`` (None without one)."""
        return self._grad

    def backward(self, out_grad=None, retain_graph=False, train_mode=None):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)


def _check_writable(arr):
    if autograd.is_marked(arr) and arr._data.requires_grad:
        raise MXNetError("a marked variable cannot be written while "
                         "autograd records")


def _assign(dst, value):
    """Write ``value`` into the NDArray ``dst`` in ``dst``'s dtype: into
    its storage, or, while autograd records, by rebinding it to a new
    tensor (the recorded graph may hold the old one)."""
    value = value.to(dst._data.dtype)
    if autograd.is_recording():
        _check_writable(dst)
        dst._data = value
        return
    with torch.no_grad():
        dst._data.copy_(value)


# ---------------------------------------------------------------- creation
def array(source, ctx=None, dtype=None):
    """Create an NDArray from any array-like.  Python lists become float32
    and numpy float64 becomes float32, as in the reference."""
    if isinstance(source, NDArray):
        source = source.asnumpy()
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


def full(shape, val, ctx=None, dtype=None):
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def zeros_like(arr):
    return NDArray(torch.zeros_like(arr.data))


def ones_like(arr):
    return NDArray(torch.ones_like(arr.data))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """``start`` to ``stop`` by ``step`` (``arange(n)`` counts from 0), each
    value ``repeat`` times."""
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                       device=_device(ctx))
    if repeat > 1:
        out = out.repeat_interleave(int(repeat))
    return NDArray(out)


def concatenate(arrays, axis=0, always_copy=True):
    return NDArray(torch.cat([a.data for a in arrays], dim=axis))


def onehot_encode(indices, out):
    """One-hot rows of ``out``'s width at ``indices``, written into
    ``out``."""
    depth = out.shape[1]
    cls = torch.arange(depth, device=indices.data.device)
    _assign(out, (indices.data.long().unsqueeze(-1) == cls)
            .to(out.data.dtype))
    return out


def imdecode(buf, **kwargs):
    """Decode an image (``mx.image.imdecode``)."""
    from . import image
    return image.imdecode(buf, **kwargs)


def waitall():
    """Wait for all work queued on every CUDA device."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ------------------------------------------------------------ op functions
def _shares_storage(t, inputs):
    if t.device.type == "meta":
        return False
    p = t.untyped_storage().data_ptr()
    return any(isinstance(x, torch.Tensor) and x.device == t.device
               and x.untyped_storage().data_ptr() == p for x in inputs)


def _host_input(value):
    """A number or array-like passed as an op input, as :func:`array`
    takes it (float64 becomes float32)."""
    arr = _np.asarray(value)
    return arr.astype(_np.float32) if arr.dtype == _np.float64 else arr


def invoke(op_name, *args, out=None, name=None, ctx=None, **kwargs):
    """Run the op ``op_name`` once on NDArrays: the counterpart of
    ``mxnet_tpu.ops.imperative_invoke``.  Returns an NDArray, a list of
    them for several outputs, or ``out``."""
    from .ops.registry import OpContext, apply_op, get_op
    from . import random as _random
    op = get_op(op_name)
    tensor_kwargs, attr_kwargs = {}, {}
    for k, v in kwargs.items():
        (tensor_kwargs if isinstance(v, NDArray) else attr_kwargs)[k] = v
    if op.key_var_num_args and op.key_var_num_args not in attr_kwargs:
        attr_kwargs[op.key_var_num_args] = len(args) + len(tensor_kwargs)
    attrs = op.parse_attrs(attr_kwargs)
    arg_names = op.get_arg_names(attrs)
    all_names = arg_names + op.get_aux_names(attrs)
    if len(args) > len(all_names):
        raise MXNetError("%s: too many positional inputs" % op_name)
    slots = dict(zip(all_names, args))
    slots.update(tensor_kwargs)
    missing = [n for n in all_names if n not in slots]
    if missing:
        raise MXNetError("%s: missing inputs %s" % (op_name, missing))
    handles = [slots[n] for n in all_names]
    first = next((h for h in handles if isinstance(h, NDArray)), None)
    device = first.data.device if first is not None else _device(ctx)
    ins = [h.data if isinstance(h, NDArray) else
           _from_numpy(_host_input(h)).to(device) for h in handles]
    octx = OpContext(is_train=autograd.is_training(), device=device,
                     generator=_random.generator(device)
                     if op.is_stochastic(attrs) else None)
    with torch.enable_grad() if autograd.is_recording() \
            else torch.no_grad(), \
            _profiler.record_scope(op_name, imperative=True):
        outs = apply_op(op, attrs, octx, *ins)
    n_vis, n_aux = op.get_num_outputs(attrs), len(all_names) - len(arg_names)
    for h, upd in zip(handles[len(arg_names):], outs[n_vis:n_vis + n_aux]):
        if isinstance(h, NDArray):
            _assign(h, upd.detach())
    for mname, upd in zip(op.mutate, outs[n_vis + n_aux:]):
        h = slots.get(mname)
        if isinstance(h, NDArray):
            _assign(h, upd.detach())
    vis = [o.clone() if _shares_storage(o, ins) else o
           for o in outs[:n_vis]]
    if autograd.is_recording():
        autograd.note_train_mode(vis, octx.is_train)
    if out is not None:
        targets = out if isinstance(out, (list, tuple)) else [out]
        for t, o in zip(targets, vis):
            _assign(t, o)
        return out
    res = [NDArray(o) for o in vis]
    return res[0] if len(res) == 1 else res


def _make_op_function(op):
    """``nd.<op>(*inputs, out=None, ctx=None, **attrs)``: :func:`invoke`
    of ``op``."""
    def fn(*args, **kwargs):
        return invoke(op.name, *args, **kwargs)
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
        impl(weight._data, grad.data if isinstance(grad, NDArray) else grad,
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
