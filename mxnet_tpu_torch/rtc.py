"""Runtime kernel compilation (``mx.rtc``): CUDA C compiled at run time (K6).

The counterpart of ``mxnet_tpu/rtc.py``.  As in the reference MXNet
(``python/mxnet/rtc.py``, ``src/common/mxrtc.cc``), a string kernel is the
body of a CUDA C function whose parameters are the named inputs and
outputs, in that order, as pointers to their element type::

    x = mx.nd.array(np.random.randn(1000).astype("f"), ctx=mx.gpu(0))
    y = mx.nd.zeros((1000,), ctx=mx.gpu(0))
    rtc = mx.rtc.Rtc("absval", [("x", x)], [("y", y)], '''
        int i = blockIdx.x * blockDim.x + threadIdx.x;
        if (i < 1000) y[i] = fabsf(x[i]);
    ''')
    rtc.push([x], [y], (4, 1, 1), (256, 1, 1))

becomes ``extern "C" __global__ void absval(const float* x, float* y)``.
The JAX package takes a Pallas kernel body there instead; this port takes
CUDA C, as the reference does.  The element type follows each NDArray's
dtype (``float``, ``__half``, ``__nv_bfloat16``, ``int``, ...).  The name is
an ``extern "C"`` symbol, so it must not be one the CUDA headers declare
(``abs``, ``exp``, ...).

The source is compiled with ``nvcc`` into a shared library by
:func:`mxnet_tpu_torch.cuda_build.build_source`, with the flags of every
other kernel of the port, and launched through ``cudaLaunchKernel`` on
PyTorch's current stream.  ``nvcc`` rather than NVRTC with
``cuModuleLoadData`` and ``cuLaunchKernel``: the port keeps one build
mechanism, and the kernel runs in PyTorch's own context and stream with no
module handles to manage.  Compiled kernels are cached by (name, source,
argument names, dtypes).  Outputs are written in place and must be
contiguous CUDA tensors.  ``Rtc.launches`` counts launches.

A Python callable in place of the string is the plain form, and the only
one that runs on CPU NDArrays: it is called with the tensors (inputs, then
outputs) as its refs, so ``y_ref[:] = torch.abs(x_ref)`` writes the output.
With ``grid_dims[0] > 1`` it runs once per grid index, which
:func:`program_id` returns, as ``pl.program_id(0)`` does in the JAX
package.
"""
from __future__ import annotations

import ctypes
import re
import threading

import torch

from .base import MXNetError
from .cuda_build import on_device

__all__ = ["Rtc", "program_id", "C_TYPES"]

#: the C element type of each dtype a string kernel takes
C_TYPES = {
    torch.float32: "float", torch.float64: "double",
    torch.float16: "__half", torch.bfloat16: "__nv_bfloat16",
    torch.int8: "signed char", torch.uint8: "unsigned char",
    torch.int16: "short", torch.int32: "int", torch.int64: "long long",
    torch.bool: "bool",
}

_CACHE = {}
_GRID = threading.local()

_TEMPLATE = """\
// mx.rtc kernel %(name)s, generated by mxnet_tpu_torch/rtc.py
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

extern "C" __global__ void %(name)s(%(params)s) {
%(body)s
}

extern "C" int mxtt_rtc_launch(void** ptrs, unsigned gx, unsigned gy,
                               unsigned gz, unsigned bx, unsigned by,
                               unsigned bz, void* stream) {
  void* args[%(count)d];
  for (int i = 0; i < %(count)d; ++i) args[i] = &ptrs[i];
  cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(&%(name)s), dim3(gx, gy, gz),
      dim3(bx, by, bz), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* mxtt_rtc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def program_id(axis=0):
    """The grid index a callable kernel runs at (0 outside a gridded
    push); the counterpart of ``pl.program_id``.  The grid is 1-d."""
    if axis != 0:
        raise MXNetError("rtc: the grid is 1-d; program_id(%r)" % (axis,))
    return getattr(_GRID, "index", 0)


def _dims(dims, what):
    dims = tuple(int(d) for d in dims) + (1,) * (3 - len(dims))
    if len(dims) != 3 or min(dims) < 1:
        raise MXNetError("rtc push: %s must be 1 to 3 positive ints, got %r"
                         % (what, dims))
    return dims


class Rtc:
    """Runtime-compiled kernel over NDArrays (reference ``rtc.py`` Rtc).

    ``inputs`` and ``outputs`` are lists of ``(name, NDArray)``; the arrays
    give the element types.  ``kernel`` is a CUDA C body or a Python
    callable."""

    launches = 0

    def __init__(self, name, inputs, outputs, kernel):
        self.name = name
        self._in_names = [n for n, _ in inputs]
        self._out_names = [n for n, _ in outputs]
        self._dtypes = tuple(a.data.dtype for _, a in inputs) + \
            tuple(a.data.dtype for _, a in outputs)
        if callable(kernel):
            self._kernel, self.source, self.key = kernel, None, None
            return
        if not re.fullmatch(r"[A-Za-z_]\w*", name) or \
                name.startswith("mxtt_"):
            raise MXNetError("rtc kernel name %r is not a C identifier free "
                             "for a kernel" % (name,))
        for n in self._in_names + self._out_names:
            if not re.fullmatch(r"[A-Za-z_]\w*", n):
                raise MXNetError("rtc %s: argument name %r is not a C "
                                 "identifier" % (name, n))
        bad = [d for d in self._dtypes if d not in C_TYPES]
        if bad:
            raise MXNetError("rtc %s: no C type for %s" % (name, bad))
        self._kernel = kernel
        self.key = (name, kernel, tuple(self._in_names),
                    tuple(self._out_names), self._dtypes)
        params = ["const %s* %s" % (C_TYPES[d], n) for n, d in
                  zip(self._in_names, self._dtypes)]
        params += ["%s* %s" % (C_TYPES[d], n) for n, d in
                   zip(self._out_names, self._dtypes[len(self._in_names):])]
        self.source = _TEMPLATE % {
            "name": name, "params": ", ".join(params),
            "body": kernel.strip("\n"), "count": len(params)}
        # per kernel: the library once loaded, and the ctypes type of its
        # pointer array
        self._lib = None
        self._ptr_array = ctypes.c_void_p * len(params)

    def push(self, ins, outs, grid_dims=(1, 1, 1), block_dims=(1, 1, 1)):
        """Launch on the given NDArrays; results are written into ``outs``
        in place.  A CUDA C kernel runs on ``grid_dims`` blocks of
        ``block_dims`` threads; a callable runs once, or once per index of
        ``grid_dims[0]`` when that is above 1 (``block_dims`` is then not
        used)."""
        if len(ins) != len(self._in_names) or \
                len(outs) != len(self._out_names):
            raise MXNetError("rtc push: argument count mismatch")
        if self.source is None:
            tensors = [a.data for a in list(ins) + list(outs)]
            grid = int(grid_dims[0]) if grid_dims and grid_dims[0] > 1 \
                else None
            if grid is None:
                self._kernel(*tensors)
                return outs
            try:
                for i in range(grid):
                    _GRID.index = i
                    self._kernel(*tensors)
            finally:
                _GRID.index = 0
            return outs
        return self._launch(ins, outs, _dims(grid_dims, "grid_dims"),
                            _dims(block_dims, "block_dims"))

    def _library(self):
        """The built library, from this kernel, the process-wide cache, or
        nvcc."""
        if self._lib is not None:
            return self._lib
        lib = _CACHE.get(self.key)
        if lib is None:
            from . import cuda_build
            lib = cuda_build.build_source("rtc_" + self.name, self.source)
            lib.mxtt_rtc_launch.argtypes = [ctypes.c_void_p] + \
                [ctypes.c_uint] * 6 + [ctypes.c_void_p]
            lib.mxtt_rtc_launch.restype = ctypes.c_int
            lib.mxtt_rtc_error_string.argtypes = [ctypes.c_int]
            lib.mxtt_rtc_error_string.restype = ctypes.c_char_p
            _CACHE[self.key] = lib
        self._lib = lib
        return lib

    def _launch(self, ins, outs, grid, block):
        arrays = [a.data for a in ins] + [a.data for a in outs]
        devices = {t.device for t in arrays}
        if any(d.type != "cuda" for d in devices):
            raise MXNetError(
                "rtc %s: a CUDA C kernel runs on CUDA NDArrays only, got %s; "
                "pass a Python callable as the kernel to run on the CPU"
                % (self.name, sorted(map(str, devices))))
        if len(devices) != 1:
            raise MXNetError("rtc %s: arrays on different devices %s"
                             % (self.name, sorted(map(str, devices))))
        for n, t, d in zip(self._in_names + self._out_names, arrays,
                           self._dtypes):
            if t.dtype != d:
                raise MXNetError("rtc %s: %s is %s, the kernel was built "
                                 "for %s" % (self.name, n, t.dtype, d))
        n_in = len(ins)
        for n, t in zip(self._out_names, arrays[n_in:]):
            if not t.is_contiguous():
                raise MXNetError("rtc %s: output %s is not contiguous"
                                 % (self.name, n))
        tensors = [t.contiguous() for t in arrays[:n_in]] + arrays[n_in:]
        lib = self._library()
        ptrs = self._ptr_array(*[t.data_ptr() for t in tensors])
        rc = on_device(devices.pop(), lambda stream: lib.mxtt_rtc_launch(
            ptrs, *grid, *block, stream))
        if rc != 0:
            raise MXNetError("rtc %s: CUDA launch failed: %s (%d)" % (
                self.name, lib.mxtt_rtc_error_string(rc).decode(), rc))
        Rtc.launches += 1
        return outs
