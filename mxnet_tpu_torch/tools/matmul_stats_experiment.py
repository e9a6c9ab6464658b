"""Experiment: the GEMM with a BatchNorm-statistics epilogue, with and without
the previous BatchNorm folded into its prologue, against cuBLAS and separate
statistics passes, at the ResNet-50 1x1-convolution shapes.

    python -m mxnet_tpu_torch.tools.matmul_stats_experiment
    python -m mxnet_tpu_torch.tools.matmul_stats_experiment \\
        --baseline OLD/mxnet_tpu_torch/csrc --variants bn128

The counterpart of ``tools/pallas_matmul_stats_experiment.py``.  K7,
:func:`matmul_stats`, is ``y = x @ w``, ``s = sum(y)``, ``ss = sum(y * y)``
over the rows from the f32 accumulator: the K5 kernel
(``csrc/matmul_stats.cu``) with ``c = 0``.  K8, :func:`matmul_stats_prologue`,
is the same of ``bf16(relu(x * scale + shift))``, the kernel's prologue
variant.  The yardsticks are cuBLAS ``x @ w`` in bf16, alone
(:func:`library_dot_only`), followed by two f32 ``torch.sum`` passes over
the rounded ``y`` (:func:`library_ref`), and after an eager prologue
(:func:`library_prologue`).  Any M.

The weight lies as the kernel reads it, (N, K) rows, and is passed as its
(K, N) transpose, so the K5 wrapper's ``w.t().contiguous()`` makes no copy
and none is timed; K7's ``c = 0`` vector is made once per width and device
(:func:`_zeros`), and K8 passes none.  The table's times are
:func:`mxnet_tpu_torch.autotune.measure`'s: min over ``repeats`` samples of
``chain`` calls each, closed by ``torch.cuda.synchronize()``, so they hold
the host's time a call where it exceeds the card's.

Then, one JSON line each: at the tool's 8 shapes and at the 8 shapes one
ResNet-50 training step gives K5 (:func:`k5_shapes`), the device time a
launch of K7, K8 and cuBLAS's product (:func:`device_ms`: CUDA events
around the replay of a CUDA graph of 20 launches, so the wrapper's host
time does not set it) and the wrapper's host time a call
(:func:`host_us`); the same of each variant (``--variants``: text edits of
the committed source: ``bn128`` 128-column tiles above N = 256,
``widest`` K5 in the widest tile N needs, ``pro_registers`` K8's prologue
on A fragments in registers through the register-A form of wgmma) and of an
older checkout's kernel (``--baseline DIR``, its ``csrc`` directory, launched
through its own C entries); and the host's costs a call at a tiny shape
(:func:`host_costs`).  It prints the card's name and power limit first, and
needs a CUDA device (and nvcc for the variants and the baseline).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from .. import cuda_build
from ..base import MXNetError
from ..ops import fused

__all__ = ["shapes", "k5_shapes", "matmul_stats", "matmul_stats_prologue",
           "library_ref", "library_dot_only", "library_prologue",
           "experiment", "device_ms", "host_us", "host_costs",
           "build_variants", "VARIANTS", "main"]

_KERNEL = "matmul_stats"
_SOURCE = "matmul_stats.cu"
_CSRC = Path(cuda_build.__file__).resolve().parent / "csrc"

_NAMESPACE = "namespace {\n\nusing namespace sm90;"


def _wgmma_rs(n):
    """The source of ``wgmma_rs`` for an m64n``n``k16 product with A from
    registers (``n`` / 2 accumulator registers a thread), as
    ``sm90_common.cuh`` writes those it has."""
    regs = n // 2
    outs = ", ".join('"+f"(d[%d])' % i for i in range(regs))
    return (
        "template <int TB>\n"
        "__device__ __forceinline__ void wgmma_rs(float (&d)[%d], "
        "const uint32_t (&a)[4], uint64_t db, int scale_d) {\n"
        '  asm volatile("{\\n.reg .pred p;\\nsetp.ne.b32 p, %%%d, 0;\\n"\n'
        '      "wgmma.mma_async.sync.aligned.m64n%dk16.f32.bf16.bf16 {%s}, '
        '{%%%d, %%%d, %%%d, %%%d}, %%%d, p, 1, 1, %%%d;\\n}\\n"\n'
        "      : %s\n"
        '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), '
        '"r"(scale_d), "n"(TB));\n'
        "}\n\n" % (
            regs, regs + 5, n, ", ".join("%%%d" % i for i in range(regs)),
            regs, regs + 1, regs + 2, regs + 3, regs + 4, regs + 6, outs))


#: K8's route (b): the x tile is not rewritten in shared memory; each
#: consumer loads its A fragments of a k-block into registers, transforms
#: them there and runs the register-A form of wgmma.  The fragments are
#: read by the products while they run, so a k-block's are made only once
#: the previous k-block's products have ended (one k-block in flight).
_A_FRAGMENT = """// K8, route (b): consumer wg's A fragment of k-step kk of a landed x
// tile, bf16(relu(f32(x) * scale + shift)) in registers
template <typename XT>
__device__ __forceinline__ void a_fragment(const uint8_t* xs,
                                           uint32_t (&af)[4], int wg,
                                           int warp, int lane, int k0, int kk,
                                           const Args& a) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * (h & 1);
    const int col = kk * 16 + 2 * (lane & 3) + 8 * (h >> 1);
    const int k = k0 + col;
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(
            xs + XT::offset(r, col, XT::swizzle_key(r))));
    const float v0 = k < a.K ? fmaxf(__fadd_rn(__fmul_rn(
        f.x, __ldg(a.scale + k)), __ldg(a.shift + k)), 0.f) : 0.f;
    const float v1 = k + 1 < a.K ? fmaxf(__fadd_rn(__fmul_rn(
        f.y, __ldg(a.scale + k + 1)), __ldg(a.shift + k + 1)), 0.f) : 0.f;
    af[h] = pack_bf16(v0, v1);
  }
}

// The statistics of one item"""

_PRO_REGISTERS = [
    (_NAMESPACE, "namespace sm90 {\n" + _wgmma_rs(256) + "}\n\n" + _NAMESPACE),
    ("// The statistics of one item", _A_FRAGMENT),
    ("""    float acc[BN / 2];
""", """    float acc[BN / 2];
    uint32_t af[BK / 16][4];
"""),
    ("""        if (PRO) {
          prologue_rows<XT>(st, wg, ctid, kb * BK, a);
          fence_proxy_async();
          bar_sync(BAR_PRO + wg, WG);
        }
        const uint32_t xs = smem_u32(st);
        const uint32_t ws = xs + XT::BYTES;
        wgmma_fence();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<0, 0>(acc, XT::kmajor(xs, wg * 64, kk),
                         WT::kmajor(ws, 0, kk), kb > 0 || kk > 0);
""", """        const uint32_t xs = smem_u32(st);
        const uint32_t ws = xs + XT::BYTES;
        if (PRO) {
          wgmma_wait<0>();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int h = 0; h < 4; ++h) asm volatile("" : "+r"(af[kk][h]));
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            a_fragment<XT>(st, af[kk], wg, warp, lane, kb * BK, kk, a);
        }
        wgmma_fence();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          if (PRO)
            wgmma_rs<0>(acc, af[kk], WT::kmajor(ws, 0, kk),
                        kb > 0 || kk > 0);
          else
            wgmma_ss<0, 0>(acc, XT::kmajor(xs, wg * 64, kk),
                           WT::kmajor(ws, 0, kk), kb > 0 || kk > 0);
        }
"""),
    ("""      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % STAGES]);
""", """      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h) asm volatile("" : "+r"(af[kk][h]));
      mbar_arrive(&empty[(it - 1) % STAGES]);
""")]

#: variant name -> [(text in the committed source, its replacement)]
VARIANTS = {
    # N above 256 in 128-column tiles, not 256
    "bn128": [("inline int widest_tile(int N) { return N <= 64 ? 64 : N <= "
               "128 ? 128 : 256; }",
               "inline int widest_tile(int N) { return N <= 64 ? 64 : N <= "
               "256 ? (N <= 128 ? 128 : 256) : 128; }")],
    # K5 too in the widest tile N needs, whatever the rounds
    "widest": [("  if (pro) return widest;\n", "  return widest;\n")],
    "pro_registers": _PRO_REGISTERS,
}


def shapes(batch=128):
    """``(M, K, N)`` of the ResNet-50 1x1 convolutions the JAX tool times,
    M = batch * H * W."""
    return [(batch * 56 * 56, 64, 256), (batch * 56 * 56, 256, 64),
            (batch * 28 * 28, 512, 128), (batch * 28 * 28, 128, 512),
            (batch * 14 * 14, 1024, 256), (batch * 14 * 14, 256, 1024),
            (batch * 7 * 7, 2048, 512), (batch * 7 * 7, 512, 2048)]


def k5_shapes(batch=128):
    """``(M, K, N)`` of K5's launches in one ResNet-50 v2 training step
    under block fusion (the 16 pointwise conv->BN blocks, 8 shapes)."""
    return [(batch * 56 * 56, 64, 64), (batch * 56 * 56, 256, 64),
            (batch * 56 * 56, 256, 128), (batch * 28 * 28, 512, 128),
            (batch * 28 * 28, 512, 256), (batch * 14 * 14, 1024, 256),
            (batch * 14 * 14, 1024, 512), (batch * 7 * 7, 2048, 512)]


_ZEROS = {}


def _zeros(n, device):
    """A cached f32 zero vector of ``n`` values on ``device``: K7's c."""
    key = (n, str(device))
    z = _ZEROS.get(key)
    if z is None:
        z = _ZEROS[key] = torch.zeros(n, dtype=torch.float32, device=device)
    return z


def _rows(out):
    y, s, ss = out
    return y, s.reshape(1, -1), ss.reshape(1, -1)


def matmul_stats(x, w):
    """K7: ``(y, s, ss)``, ``y = x @ w`` in x's dtype and the f32 (1, N)
    sums of y and y^2 from the accumulator (``ops.fused.matmul_stats`` with
    ``c = 0``)."""
    return _rows(fused.matmul_stats(x, w, _zeros(w.shape[1], x.device)))


def matmul_stats_prologue(x, w, scale, shift):
    """K8: :func:`matmul_stats` of ``relu(x * scale + shift)`` rounded to
    x's dtype; ``scale``, ``shift`` (1, K) f32."""
    return _rows(fused.matmul_stats_prologue(x, w, scale, shift))


def library_ref(x, w):
    """cuBLAS ``x @ w`` in x's dtype, then the f32 sums of the rounded y
    and its square over the rows (the JAX tool's ``xla_ref``)."""
    y = x @ w
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def library_dot_only(x, w):
    """cuBLAS ``x @ w`` alone (the JAX tool's ``xla_dot_only``)."""
    return x @ w


def library_prologue(x, w, scale, shift):
    """:func:`library_ref` after the prologue in eager PyTorch."""
    return library_ref(torch.relu(x.float() * scale + shift).to(x.dtype), w)


def _inputs(m, k, n, rng, device):
    x, w, scale, shift = (
        torch.from_numpy(a.astype(np.float32)).to(device)
        for a in (rng.randn(m, k), rng.randn(k, n) * 0.05,
                  rng.rand(1, k), rng.randn(1, k)))
    # (N, K) rows as the kernel reads them, passed as the (K, N) view
    return (x.to(torch.bfloat16), w.to(torch.bfloat16).t().contiguous().t(),
            scale, shift)


def experiment(batch=128, repeats=2, chain=24, device="cuda"):
    """For each shape: inputs from ``RandomState(0)``, K7 held against
    :func:`library_ref` as the JAX tool holds its kernel against XLA, then
    the five timings.  Returns one dict a shape, times in ms."""
    from ..autotune import measure

    rng = np.random.RandomState(0)
    out = []
    for m, k, n in shapes(batch):
        x, w, scale, shift = _inputs(m, k, n, rng, device)
        # y within bf16 rounding; the statistics within the slack of
        # summing the rounded y (the kernel sums the f32 accumulator)
        y0, s0, ss0 = library_ref(x, w)
        y1, s1, _ss1 = matmul_stats(x, w)
        torch.testing.assert_close(y1.float(), y0.float(), rtol=2e-2,
                                   atol=2e-1)
        stat_scale = ss0.mean().sqrt().item()
        err = ((s1[0] - s0).abs() / stat_scale).max().item()
        if not err < 0.05:
            raise AssertionError("stats diverge: %g" % err)
        del y0, y1

        def ms(fn, *args):
            return measure(fn, args, repeats=repeats, chain=chain) * 1e3

        out.append({
            "M": m, "K": k, "N": n,
            "dot_ms": ms(library_dot_only, x, w),
            "library_ms": ms(library_ref, x, w),
            "kernel_ms": ms(matmul_stats, x, w),
            "prologue_ms": ms(matmul_stats_prologue, x, w, scale, shift),
            "library_prologue_ms": ms(library_prologue, x, w, scale, shift)})
    return out


# ------------------------------------------------------- device and host
def device_ms(fn, launches=20, replays=3):
    """Milliseconds of device time a call of ``fn()``: ``launches`` calls
    captured in one CUDA graph, whose replay is timed by CUDA events (the
    least of ``replays``), divided by ``launches``.  The host's work a
    call (checks, allocation, ctypes) is not replayed, so it does not set
    the time; the gaps between the graph's kernels are in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                      # warm: builds, loads, opts in
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = None
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        best = ms if best is None else min(best, ms)
    del graph
    return best / launches


def host_us(fn, calls=20):
    """Microseconds of the host's time a call of ``fn()``: ``calls`` calls
    enqueued back to back, the clock read before the closing
    synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def host_costs(calls=2000, shape=(256, 64, 64)):
    """Microseconds a call at a tiny bf16 shape, where the card's work is a
    few microseconds: the wrapper's wall a call (argument checks,
    allocation, ctypes, the C entry), the C entry's alone (three
    tensor-map encodes and the two launches) on preallocated outputs, and
    the three encodes alone."""
    m, k, n = shape
    x, w, _scale, _shift = _inputs(m, k, n, np.random.RandomState(1),
                                   "cuda")
    w_nk = w.t()
    c = _zeros(n, x.device)
    rows = fused._partial_rows(x.device, m, True)
    y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    buf = torch.empty(2 * (rows + 1) * n, dtype=torch.float32,
                      device="cuda")
    lib, fn = fused._kernel("mxtt_matmul_stats")
    lib.mxtt_matmul_stats_encode.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 3
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), w_nk.data_ptr(), c.data_ptr(), y.data_ptr(),
            buf.data_ptr(), buf[2 * rows * n:].data_ptr(), m, n, k, rows, 1,
            stream)

    def wall(f):
        for _ in range(50):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            f()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    return {"shape": list(shape),
            "wrapper_us": wall(lambda: fused.matmul_stats(x, w, c)),
            "c_entry_us": wall(lambda: fn(*args)),
            "encode_us": wall(lambda: lib.mxtt_matmul_stats_encode(
                x.data_ptr(), w_nk.data_ptr(), y.data_ptr(), m, n, k))}


# ------------------------------------------------ variants and a baseline
def _sources(name, baseline):
    """{file name: text} of variant ``name``'s csrc directory."""
    if name == "baseline":
        return {f.name: f.read_text() for f in Path(baseline).iterdir()
                if f.suffix in (".cu", ".cuh")}
    texts = {f.name: f.read_text() for f in _CSRC.iterdir()
             if f.suffix in (".cu", ".cuh")}
    for old, new in VARIANTS[name]:
        if old not in texts[_SOURCE]:
            raise MXNetError("matmul_stats_experiment: %r is not in %s"
                             % (old, _SOURCE))
        texts[_SOURCE] = texts[_SOURCE].replace(old, new)
    return texts


def build_variants(names, baseline=None):
    """Build the kernel of each variant in ``names`` ("baseline": the
    ``matmul_stats.cu`` of the csrc directory ``baseline``), one nvcc each,
    all started together.  Returns {variant: (library path, ptxas
    report)}."""
    procs = {}
    for name in names:
        out = cuda_build.build_dir() / "experiment_k5" / name
        out.mkdir(parents=True, exist_ok=True)
        for fname, text in _sources(name, baseline).items():
            (out / fname).write_text(text)
        lib = out / ("lib%s.so" % _KERNEL)
        procs[name] = (lib, subprocess.Popen(
            cuda_build.nvcc_command(out / _SOURCE, lib),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise MXNetError("nvcc failed for %s:\n%s" % (name, log))
        built[name] = (str(lib), "\n".join(
            ln for ln in log.splitlines() if "ptxas" in ln or "spill" in ln))
    return built


@contextmanager
def _standing_in(path):
    """The K5 wrapper launches the library at ``path`` in place of the
    committed one until the block ends."""
    saved = cuda_build.library(_KERNEL)
    try:
        cuda_build._libs[_KERNEL] = ctypes.CDLL(path)
        yield
    finally:
        cuda_build._libs[_KERNEL] = saved


class _OldEntry:
    """An older ``matmul_stats.cu``'s C entries, whose partial buffers
    take ``ceil(M / mxtt_matmul_stats_block_rows())`` rows and whose K8
    takes a c vector: K5 ``(x, w_nk, c)`` and K8 ``(x, w_nk, scale,
    shift)``, both bf16, returning y."""

    def __init__(self, path):
        self.lib = ctypes.CDLL(path)
        self.rows = self.lib.mxtt_matmul_stats_block_rows()
        for entry, pointers in (("mxtt_matmul_stats", 8),
                                ("mxtt_matmul_stats_prologue", 10)):
            fn = getattr(self.lib, entry)
            fn.argtypes = [ctypes.c_void_p] * pointers \
                + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

    def _call(self, fn, x, w_nk, vectors, c):
        m, k = x.shape
        n = w_nk.shape[0]
        y = torch.empty((m, n), dtype=x.dtype, device=x.device)
        part = torch.empty((2, -(-m // self.rows), n), dtype=torch.float32,
                           device=x.device)
        s = torch.empty((2, n), dtype=torch.float32, device=x.device)
        rc = fn(x.data_ptr(), w_nk.data_ptr(),
                *[v.data_ptr() for v in vectors], c.data_ptr(),
                y.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                s[0].data_ptr(), s[1].data_ptr(), m, n, k, 1,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise MXNetError("baseline matmul_stats failed: %d" % rc)
        return y, s[0], s[1]

    def k5(self, x, w_nk, c):
        return self._call(self.lib.mxtt_matmul_stats, x, w_nk, [], c)

    def k8(self, x, w_nk, scale, shift, zero):
        return self._call(self.lib.mxtt_matmul_stats_prologue, x, w_nk,
                          [scale, shift], zero)


def compare(batch=128, names=(), built=None):
    """One dict a shape: at :func:`k5_shapes` K5 (c drawn from a seed), at
    :func:`shapes` K7 and K8; each with the committed kernel's, every
    variant's and the baseline's :func:`device_ms` (``built`` as
    :func:`build_variants` returns it), cuBLAS's product's, and the
    wrapper's :func:`host_us`."""
    built = built or {}
    old = _OldEntry(built["baseline"][0]) if "baseline" in built else None
    rng = np.random.RandomState(2)
    rows = []
    cases = [("k5", s) for s in k5_shapes(batch)] \
        + [("k7", s) for s in shapes(batch)] \
        + [("k8", s) for s in shapes(batch)]
    for kind, (m, k, n) in cases:
        x, w, scale, shift = _inputs(m, k, n, rng, "cuda")
        w_nk = w.t()
        zero = _zeros(n, x.device)
        c = zero if kind != "k5" else \
            0.1 * torch.from_numpy(rng.randn(n).astype(np.float32)).cuda()
        if kind == "k8":
            def run():
                return fused.matmul_stats_prologue(x, w, scale, shift)
        else:
            def run():
                return fused.matmul_stats(x, w, c)
        row = {"kernel": kind, "shape": [m, k, n],
               "device_ms": device_ms(run), "host_us": host_us(run),
               "dot_ms": device_ms(lambda: x @ w)}
        for name in names:
            with _standing_in(built[name][0]):
                row[name + "_device_ms"] = device_ms(run)
        if old is not None:
            row["baseline_device_ms"] = device_ms(
                (lambda: old.k8(x, w_nk, scale, shift, zero))
                if kind == "k8" else (lambda: old.k5(x, w_nk, c)))
        rows.append(row)
        del x, w, w_nk, scale, shift
    return rows


def main(argv=None):
    from . import nvidia_smi

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--chain", type=int, default=24)
    ap.add_argument("--variants", default="",
                    help="comma-separated subset of %s" % ", ".join(VARIANTS))
    ap.add_argument("--baseline", default=None,
                    help="an older checkout's csrc directory, whose "
                    "matmul_stats.cu is timed too")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("matmul_stats_experiment: no CUDA device; this "
                         "tool measures the GPU")
    print(nvidia_smi(), flush=True)
    rows = experiment(a.batch, a.repeats, a.chain)
    print(f"{'M':>9} {'K':>5} {'N':>5} | {'lib dot':>8} {'lib+st':>8} "
          f"{'kernel':>8} {'ker+pro':>8} {'lib+pro':>8}  (ms)")
    for r in rows:
        print(f"{r['M']:>9} {r['K']:>5} {r['N']:>5} | {r['dot_ms']:8.3f} "
              f"{r['library_ms']:8.3f} {r['kernel_ms']:8.3f} "
              f"{r['prologue_ms']:8.3f} {r['library_prologue_ms']:8.3f}",
              flush=True)
    names = [n for n in a.variants.split(",") if n]
    build = names + (["baseline"] if a.baseline else [])
    built = build_variants(build, a.baseline) if build else {}
    for name in build:
        print(json.dumps({"variant": name, "ptxas": built[name][1]}),
              flush=True)
    for row in compare(a.batch, names, built):
        print(json.dumps(row), flush=True)
    print(json.dumps({"host": host_costs()}), flush=True)
    return rows


if __name__ == "__main__":
    main()
