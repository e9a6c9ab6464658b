"""Experiment: where ``mx.rtc``'s time goes (K6), against ``torch.abs``.

    python -m mxnet_tpu_torch.tools.rtc_experiment
    PYTHONPATH=OTHER python mxnet_tpu_torch/tools/rtc_experiment.py \\
        --host-only

The flows and the abs bodies are ``chip_smoke.py``'s (``rtc_flows``), so
the first form runs from the root of a checkout.  K6
compiles a user's CUDA C body and launches it.  What the port owns is the
declaration it wraps the body in, the build, and the Python path of each
push.  The tool splits the time of abs over an (8192, 8192) f32 array into
five forms:

* (a) ``push``: ``Rtc.push`` of the scalar body (one 4-byte load and store
  a thread, 262,144 blocks of 256), as a user calls it, by CUDA events
  over ``--iters`` pushes;
* (b) ``c_loop``: the same source (``Rtc.source``), its launches issued
  from C one after another with no Python in between: the kernel's device
  time alone;
* (c) ``restrict``: (b) with every pointer parameter declared
  ``__restrict__``, from C;
* (d) ``launch_bounds``: (c) with ``__launch_bounds__(256)``, the push's
  block, from C;
* (e) ``float4``: the body a CUDA programmer writes for this card, a
  grid-stride loop of 16-byte ``float4`` loads and stores, four in flight
  a thread (eight blocks of 256 an SM), from C, and through ``Rtc.push``
  as ``float4_push``; ``float4_single`` is the same loop one ``float4`` at
  a time;

beside ``torch.abs(x, out=y)`` and the byte bound (x read and y written
once at 3.35 TB/s).  Each form's output must equal ``torch.abs``'s.  Then
the host's cost of one push of each of the three small flows of
``tests/test_rtc.py`` (``--host-only`` runs only this): the wall of
``--calls`` pushes a push (the least of five runs), where the card's
work is a few microseconds.  Run by its path with ``PYTHONPATH`` naming
another checkout, the tool times that checkout's ``mxnet_tpu_torch`` and
flows (the host part uses only the public API and ``rtc_flows``, which
both have).  One
JSON line each, after the card's name and power limit.  Needs a CUDA
device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import time

import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.tools import nvidia_smi

__all__ = ["forms", "host_costs", "main"]

HBM_BYTES_PER_S = 3.35e12

#: the same loop one float4 at a time (the experiment's ``float4_single``)
ABS_VEC1_BODY = """
const int n = %d;
const int stride = gridDim.x * blockDim.x;
const int first = blockIdx.x * blockDim.x + threadIdx.x;
const float4* x4 = reinterpret_cast<const float4*>(x);
float4* y4 = reinterpret_cast<float4*>(y);
for (int i = first; i < n / 4; i += stride) {
  const float4 v = x4[i];
  y4[i] = make_float4(fabsf(v.x), fabsf(v.y), fabsf(v.z), fabsf(v.w));
}
for (int i = n / 4 * 4 + first; i < n; i += stride) y[i] = fabsf(x[i]);
"""

#: a C entry appended to a generated source: ``n`` launches in a row
_LOOP_ENTRY = """
extern "C" int mxtt_rtc_launch_n(void** ptrs, int n, unsigned gx,
                                 unsigned gy, unsigned gz, unsigned bx,
                                 unsigned by, unsigned bz, void* stream) {
  for (int i = 0; i < n; ++i) {
    const int rc = mxtt_rtc_launch(ptrs, gx, gy, gz, bx, by, bz, stream);
    if (rc != 0) return rc;
  }
  return 0;
}
"""


def _restrict(source):
    """``source`` with every pointer parameter of its kernel (the first
    declaration that opens a body) declared ``__restrict__``."""
    end = source.index(") {\n")
    start = source.rindex("(", 0, end)
    return source[:start] + source[start:end].replace(
        "* ", "* __restrict__ ") + source[end:]


def _ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _c_loop_ms(name, source, tensors, grid, block, iters):
    """Build ``source`` with :data:`_LOOP_ENTRY` and time ``iters``
    launches issued from C, by CUDA events."""
    from mxnet_tpu_torch import cuda_build
    lib = cuda_build.build_source("rtcx_" + name, source + _LOOP_ENTRY)
    fn = lib.mxtt_rtc_launch_n
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_uint] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    stream = torch.cuda.current_stream().cuda_stream

    def run(n):
        rc = fn(ptrs, n, *grid, *block, stream)
        if rc != 0:
            raise RuntimeError("rtc_experiment: launch of %s failed (%d)"
                               % (name, rc))

    run(3)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(iters)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def forms(iters=50):
    """The five forms of abs over (8192, 8192) f32, ``torch.abs`` and the
    byte bound, in ms; ``exact`` for each form whose output equals
    ``torch.abs``'s."""
    import chip_smoke
    by_name = {f[0]: f for f in chip_smoke.rtc_flows()}
    ctx = mx.gpu(0)
    _n, body, [(xname, xv)], (yname, shape), grid, block, _p = \
        by_name["rtc_abs_full"]
    vec = by_name["rtc_abs_vec_full"]
    x = mx.nd.array(xv, ctx=ctx)
    y = mx.nd.zeros(shape, ctx=ctx)
    want = torch.abs(x.data)
    scalar = mx.rtc.Rtc("rtc_abs_full", [(xname, x)], [(yname, y)], body)
    vector = mx.rtc.Rtc("rtc_abs_vec_full", [(xname, x)], [(yname, y)],
                        vec[1])
    restrict_src = _restrict(scalar.source)
    out, exact = {}, {}

    def check(form):
        torch.cuda.synchronize()
        exact[form] = bool(torch.equal(y.data, want))
        y.data.zero_()

    tensors = [x.data, y.data]
    out["push"] = _ms(lambda: scalar.push([x], [y], grid, block), iters)
    check("push")
    out["c_loop"] = _c_loop_ms("c_loop", scalar.source, tensors, grid,
                               block, iters)
    check("c_loop")
    out["restrict"] = _c_loop_ms("restrict", restrict_src, tensors, grid,
                                 block, iters)
    check("restrict")
    decl = 'extern "C" __global__ void rtc_abs_full('
    out["launch_bounds"] = _c_loop_ms(
        "launch_bounds", restrict_src.replace(
            decl, 'extern "C" __global__ void __launch_bounds__(%d) '
            'rtc_abs_full(' % block[0]), tensors, grid, block, iters)
    check("launch_bounds")
    out["float4"] = _c_loop_ms("float4", vector.source, tensors,
                               vec[4], vec[5], iters)
    check("float4")
    out["float4_push"] = _ms(lambda: vector.push([x], [y], vec[4], vec[5]),
                             iters)
    check("float4_push")
    single = mx.rtc.Rtc("rtc_abs_vec1_full", [(xname, x)], [(yname, y)],
                        ABS_VEC1_BODY % x.data.numel())
    out["float4_single"] = _c_loop_ms(
        "float4_single", single.source, tensors, vec[4], vec[5],
        iters)
    check("float4_single")
    out["torch_abs"] = _ms(lambda: torch.abs(x.data, out=y.data), iters)
    nbytes = 2.0 * x.data.numel() * x.data.element_size()
    out.update(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               exact=exact, grid=list(grid), vec_grid=list(vec[4]))
    return out


def host_costs(calls=2000, repeats=5):
    """Microseconds of host time a push of each small flow of
    ``tests/test_rtc.py``: the wall of ``calls`` pushes (after some that
    build and warm), over ``calls``, the least of ``repeats`` such runs
    (the host is shared, and its noise only adds)."""
    import chip_smoke
    ctx = mx.gpu(0)
    out = {}
    for name, body, ins, (oname, oshape), grid, block, _p in \
            chip_smoke.rtc_flows(full=False)[:3]:
        arrays = [(n, mx.nd.array(v, ctx=ctx)) for n, v in ins]
        y = mx.nd.zeros(oshape, ctx=ctx)
        kernel = mx.rtc.Rtc(name, arrays, [(oname, y)], body)
        xs = [v for _n, v in arrays]
        for _ in range(20):
            kernel.push(xs, [y], grid, block)
        walls = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                kernel.push(xs, [y], grid, block)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / calls * 1e6)
        out[name] = min(walls)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--calls", type=int, default=2000)
    parser.add_argument("--host-only", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rtc_experiment: needs a CUDA device")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": nvidia_smi(),
                      "package": mx.__file__}), flush=True)
    if not args.host_only:
        print(json.dumps({"abs_8192x8192_f32": forms(args.iters)}),
              flush=True)
    print(json.dumps({"host_us_a_push": host_costs(args.calls)}),
          flush=True)


if __name__ == "__main__":
    main()
